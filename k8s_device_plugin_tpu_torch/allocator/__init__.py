"""L2 placement policy: topology-aware preferred allocation for GPUs.

Counterpart of the reference's allocator (and of the Go reference's
``internal/pkg/allocator``). Pair weights come from the link class of
each pair of GPUs (NVLink, PCIe switch, neither) plus NUMA affinity, on
the Go reference's scale; subsets whose GPUs are NVLink-linked pair by
pair (full-bandwidth collectives) are preferred, leaving the largest
free NVLink clique behind (anti-fragmentation). Gang allocation across
hosts is not ported yet (ROADMAP A10).
"""

from k8s_device_plugin_tpu_torch.allocator.allocator import AllocationError, Policy
from k8s_device_plugin_tpu_torch.allocator.device import (
    Device,
    build_pair_weights,
    devices_from_chips,
    pair_weight,
)
from k8s_device_plugin_tpu_torch.allocator.besteffort_policy import BestEffortPolicy

__all__ = [
    "AllocationError",
    "BestEffortPolicy",
    "Device",
    "Policy",
    "build_pair_weights",
    "devices_from_chips",
    "pair_weight",
]
