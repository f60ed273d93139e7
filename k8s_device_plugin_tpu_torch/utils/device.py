"""Device resolution for the port's entry points.

The counterpart of utils/jaxenv.py: where the reference picks its
backend through ``JAX_PLATFORMS``, the port takes an explicit device.
Entry points run on CUDA unless the caller asks for the CPU
(``device="cpu"``, ``--device cpu``); asking for nothing on a machine
without a card is an error, never a quiet run on the CPU. A rank that a
launcher started (``LOCAL_RANK`` set) takes the card
``LOCAL_RANK % device_count``: one card each while there are enough,
shared round-robin when there are not (parallel/mesh.py then picks
gloo).
"""

from __future__ import annotations

import os

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The torch.device an entry point runs on.

    ``None`` means the card (``cuda``): this rank's local card under a
    launcher, else the current one. A CUDA device is checked for
    availability here, so a missing card fails at startup with a clear
    message instead of deep in the first kernel launch."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: the port runs on the card "
                "unless the caller asks for the CPU (device='cpu', "
                "--device cpu)"
            )
        if dev.index is None:
            local = os.environ.get("LOCAL_RANK")
            dev = torch.device("cuda", torch.cuda.current_device()
                               if local is None
                               else int(local) % torch.cuda.device_count())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda | cpu)")
    return dev
