"""Device model and pair-weight computation for the allocator.

Counterpart of the reference's allocator/device.py (itself the Go
reference's internal/pkg/allocator/device.go). The Go reference derives
pairwise "closeness" from KFD io_links/p2p_links types (XGMI=11 weight
10, PCIe=2 weight 40, other 50; device.go:38-55,136-158); the port reads
the same three classes off an NVIDIA host (discovery/topology.py):

    NVLink, d hops (1 = linked)  -> min(10*d, 40)  (the XGMI weight 10)
    same PCIe switch             -> 40              (PCIe)
    anything else                -> 50              (other link)

plus the reference's NUMA term (same node +10, different +20,
device.go:152-157). Lower weight = better, as in the reference. The
per-hop NVLink term is the reference's ICI hop rule: pairs of a chain of
bridged GPUs are farther apart than linked ones, never farther than PCIe.

Subset construction favours NVLink cliques — GPUs linked pair by pair
get full-bandwidth collectives — and breaks weight ties by leaving the
largest free clique behind (anti-fragmentation).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from k8s_device_plugin_tpu_torch.discovery.chips import GPUChip
from k8s_device_plugin_tpu_torch.discovery.topology import PCIE_SWITCH, GPUTopology

# Weight constants, same scale as the reference (device.go:38-55).
NVLINK_WEIGHT = 10           # per NVLink hop: the XGMI weight
NVLINK_MAX_WEIGHT = 40       # cap: a long NVLink chain == PCIe
PCIE_WEIGHT = 40
OTHER_WEIGHT = 50            # no closer link == reference "other link"
SAME_NUMA_WEIGHT = 10
DIFF_NUMA_WEIGHT = 20


@dataclass(frozen=True)
class Device:
    """A schedulable unit: one whole GPU."""

    id: str                                # kubelet device ID
    index: int                             # ordinal within the host
    numa_node: int = -1
    chip_indices: Tuple[int, ...] = ()     # backing GPUs (topology indices)


def devices_from_chips(chips: Iterable[GPUChip]) -> List[Device]:
    """Whole-GPU devices (``single`` naming strategy).

    Topology positions come from ``mesh_index`` (dense rank assigned by
    discovery) so gaps in the device minors don't shift GPUs off the
    topology; fabricated chips without a mesh_index fall back to their
    raw index. The id is the PCI address (the reference's rule), or the
    UUID where the host hides the PCI address (``GPUChip.key``).
    """
    out = []
    for rank, c in enumerate(sorted(chips, key=lambda c: c.index)):
        mesh_pos = c.mesh_index if c.mesh_index >= 0 else c.index
        out.append(
            Device(
                id=c.key,
                index=rank,
                numa_node=c.numa_node,
                chip_indices=(mesh_pos,),
            )
        )
    return out


def _link_weight(a: Device, b: Device, topo: Optional[GPUTopology]) -> int:
    """Closest link between the GPU sets of two devices, as a weight."""
    if topo is None or not a.chip_indices or not b.chip_indices:
        return OTHER_WEIGHT
    best = OTHER_WEIGHT
    for ca in a.chip_indices:
        for cb in b.chip_indices:
            try:
                hops = topo.nvlink_hops(ca, cb)
                if hops is not None:
                    w = min(NVLINK_WEIGHT * max(hops, 1), NVLINK_MAX_WEIGHT)
                elif topo.link(ca, cb) == PCIE_SWITCH:
                    w = PCIE_WEIGHT
                else:
                    w = OTHER_WEIGHT
            except IndexError:
                w = OTHER_WEIGHT
            best = min(best, w)
    return best


def pair_weight(a: Device, b: Device, topo: Optional[GPUTopology]) -> int:
    """Closeness score for one device pair; lower is better."""
    if a.numa_node >= 0 and a.numa_node == b.numa_node:
        numa = SAME_NUMA_WEIGHT
    else:
        numa = DIFF_NUMA_WEIGHT
    return _link_weight(a, b, topo) + numa


def build_pair_weights(
    devices: Sequence[Device], topo: Optional[GPUTopology]
) -> Dict[Tuple[int, int], int]:
    """All pairwise weights, keyed by (min(index), max(index)).

    The analogue of fetchAllPairWeights' O(n^2) init-time precompute
    (device.go:221-253).
    """
    weights: Dict[Tuple[int, int], int] = {}
    for a, b in itertools.combinations(devices, 2):
        lo, hi = sorted((a.index, b.index))
        weights[(lo, hi)] = pair_weight(a, b, topo)
    return weights


def subset_weight(
    indices: Sequence[int], weights: Dict[Tuple[int, int], int]
) -> int:
    total = 0
    for a, b in itertools.combinations(sorted(indices), 2):
        total += weights.get((a, b), OTHER_WEIGHT + DIFF_NUMA_WEIGHT)
    return total


def covered_chips(devices: Sequence[Device]) -> List[int]:
    out: List[int] = []
    for d in devices:
        out.extend(d.chip_indices)
    return sorted(set(out))


def is_contiguous_selection(
    devices: Sequence[Device], topo: Optional[GPUTopology]
) -> bool:
    """Are the selected devices' GPUs NVLink-linked pair by pair?"""
    if topo is None:
        return False
    try:
        return topo.is_clique(covered_chips(devices))
    except IndexError:
        return False


def largest_free_clique(
    free_devices: Sequence[Device], topo: Optional[GPUTopology]
) -> int:
    """Size of the largest NVLink clique buildable from free GPUs: the
    anti-fragmentation tie-break (between equal-weight candidates, prefer
    the one whose *remaining* free GPUs still hold the biggest clique)."""
    if topo is None:
        return len(covered_chips(free_devices))
    return topo.largest_free_clique(covered_chips(free_devices))


def candidate_clique_selections(
    devices_by_index: Dict[int, Device],
    available: Sequence[Device],
    required: Sequence[Device],
    size: int,
    topo: Optional[GPUTopology],
) -> List[List[Device]]:
    """Fast path: selections of whole-GPU devices that form NVLink cliques
    (a subset of a clique is one)."""
    if topo is None:
        return []
    if any(len(d.chip_indices) != 1 for d in devices_by_index.values()):
        return []
    chip_to_dev = {d.chip_indices[0]: d for d in devices_by_index.values()}
    avail_chips = {d.chip_indices[0] for d in available}
    req_chips = {d.chip_indices[0] for d in required}
    seen = set()
    out: List[List[Device]] = []
    for clique in topo.cliques:
        pool = sorted(avail_chips.intersection(clique) - req_chips)
        if not req_chips <= set(clique):
            continue
        need = size - len(req_chips)
        if need < 0 or need > len(pool):
            continue
        for extra in itertools.combinations(pool, need):
            s = frozenset(req_chips.union(extra))
            if s not in seen:
                seen.add(s)
                out.append([chip_to_dev[i] for i in sorted(s)])
    return out
