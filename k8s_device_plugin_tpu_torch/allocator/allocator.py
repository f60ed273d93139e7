"""Policy interface for preferred-allocation strategies.

Mirrors the reference's two-method Policy abstraction
(internal/pkg/allocator/allocator.go:27-30) so alternative placement
policies (packed, spread, ...) can slot in behind the plugin's
GetPreferredAllocation without touching the gRPC layer.
"""

from __future__ import annotations

from typing import List, Optional, Protocol, Sequence

from k8s_device_plugin_tpu_torch.allocator.device import Device
from k8s_device_plugin_tpu_torch.discovery.topology import GPUTopology


class AllocationError(RuntimeError):
    """A preferred allocation could not be computed."""


class Policy(Protocol):
    def init(self, devices: Sequence[Device],
             topology: Optional[GPUTopology]) -> None:
        """Precompute whatever the policy needs (pair weights, groupings).

        Raises AllocationError when the policy cannot initialise; the plugin
        then advertises GetPreferredAllocationAvailable=false and lets the
        kubelet fall back to its own packing, exactly as the reference does
        when allocator init fails (plugin.go:86-89,211-217).
        """

    def allocate(
        self, available: Sequence[str], required: Sequence[str], size: int
    ) -> List[str]:
        """Pick ``size`` device ids from ``available`` including ``required``."""
