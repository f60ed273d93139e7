"""Resource-naming strategies.

Mirrors the reference's ParseStrategy/getResourceList
(cmd/k8s-device-plugin/main.go:42-91). Only the ``single`` strategy is
ported: a homogeneous host advertises ``["gpu"]`` (nvidia.com/gpu), a
heterogeneous one is an error (the reference's heterogeneous-with-single
error path, main.go:78-81). ``mixed``, whose GPU counterpart of TPU
partitions is MIG, raises StrategyError until MIG is ported (ROADMAP
A10).
"""

from __future__ import annotations

import enum
from typing import Dict, List

from k8s_device_plugin_tpu_torch.api import constants
from k8s_device_plugin_tpu_torch.discovery import chips as chips_mod


class Strategy(str, enum.Enum):
    SINGLE = "single"


class StrategyError(ValueError):
    pass


def parse_strategy(s: str) -> Strategy:
    if s == "mixed":
        raise StrategyError(
            "resource naming strategy mixed needs MIG partitions, which the "
            "GPU device plugin does not serve yet (ROADMAP A10); use single"
        )
    try:
        return Strategy(s)
    except ValueError:
        raise StrategyError(f"invalid resource naming strategy: {s}") from None


def get_resource_list(
    chips: Dict[str, chips_mod.GPUChip],
    strategy: Strategy,
) -> List[str]:
    """The resource last-names this host advertises: ``["gpu"]``, or
    nothing without GPUs; StrategyError on a heterogeneous host."""
    if not chips:
        return []
    if not chips_mod.is_homogeneous(chips):
        raise StrategyError(
            "heterogeneous GPU configuration (mixed GPU models) is not "
            "supported with the single strategy"
        )
    return [constants.RESOURCE_GPU]
