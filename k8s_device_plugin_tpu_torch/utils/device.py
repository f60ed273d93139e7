"""Device resolution for the port's entry points.

The counterpart of utils/jaxenv.py: where the reference picks its
backend through ``JAX_PLATFORMS``, the port takes an explicit device.
Entry points run on CUDA unless the caller asks for the CPU
(``device="cpu"``, ``--device cpu``); asking for nothing on a machine
without a card is an error, never a quiet run on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The torch.device an entry point runs on.

    ``None`` means the card (``cuda``). A CUDA device is checked for
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
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda | cpu)")
    return dev
