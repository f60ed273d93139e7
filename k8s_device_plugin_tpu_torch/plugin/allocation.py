"""What Allocate hands a container, without gRPC.

The device specs and the environment of one container's allotment, as
``GPUDevicePlugin._allocate`` puts them into its response. This module,
discovery and the allocator import neither ``grpc`` nor
``google.protobuf``: a host without them can still compute a placement
and the container edits it implies.

The two visibility variables carry the allotted GPUs' UUIDs, comma-joined
in device-minor order: ``NVIDIA_VISIBLE_DEVICES`` is what the NVIDIA
container runtime reads to expose GPUs, ``CUDA_VISIBLE_DEVICES`` what
CUDA reads to number them. UUIDs survive the runtime's renumbering
(inside the container the first allotted GPU is CUDA device 0, whatever
its minor); indices would not.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Tuple

log = logging.getLogger(__name__)

VISIBLE_ENVS = ("NVIDIA_VISIBLE_DEVICES", "CUDA_VISIBLE_DEVICES")


def device_spec_paths(chips: Iterable) -> List[str]:
    """Host device nodes to map into the container: each GPU's node and
    the control nodes, deduplicated in order (every GPU lists the shared
    control nodes, and a container spec must not carry a path twice)."""
    seen: Dict[str, None] = {}
    for chip in chips:
        for path in chip.device_spec_paths:
            seen.setdefault(path, None)
    return list(seen)


def allocate_envs(chips: Iterable) -> Dict[str, str]:
    """The visibility environment for the allotted GPUs ({} for none, or
    when a GPU's UUID is unknown: CUDA must not be pointed at indices)."""
    ordered = sorted({c.index: c for c in chips}.values(), key=lambda c: c.index)
    if not ordered:
        return {}
    if not all(c.uuid for c in ordered):
        log.warning("GPU UUID unknown for %s; no visibility env",
                    ", ".join(c.dev_path for c in ordered if not c.uuid))
        return {}
    visible = ",".join(c.uuid for c in ordered)
    return {name: visible for name in VISIBLE_ENVS}


def container_allocation(chips: Iterable) -> Tuple[List[str], Dict[str, str]]:
    """(device spec paths, envs) of one container's allotment."""
    chips = list(chips)
    return device_spec_paths(chips), allocate_envs(chips)
