"""GPU interconnect topology: the link class of every pair of GPUs.

The reference's TPU chips sit on a regular ICI mesh described by a
topology string; the Go reference reads XGMI-vs-PCIe links from KFD
(internal/pkg/allocator/device.go:136-158). An NVIDIA host is of the
second kind: each pair of GPUs is joined by

  - NVLink: a bridge between the two, or NVSwitch, through which every
    pair of an HGX board is linked (NVML's far end of an active link is
    then a switch, not a GPU). Where GPUs are bridged in a chain, a pair
    without a link of its own is some NVLink hops apart;
  - the same PCIe switch: a common upstream bridge in the two functions'
    sysfs paths (nvidia-smi's PIX/PXB);
  - the same NUMA node (nvidia-smi's NODE/PHB);
  - or nothing closer (SYS).

``GPUTopology`` holds those classes by topology index (the GPUs' dense
rank, ``GPUChip.mesh_index``) and the NVLink cliques, the sets of GPUs
linked pair by pair: what the allocator calls contiguous.
"""

from __future__ import annotations

import itertools
import os
import re
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

NVLINK = "nvlink"
PCIE_SWITCH = "pcie-switch"
SAME_NUMA = "numa"
OTHER = "other"

_PCI_ADDR_RE = re.compile(r"^[0-9a-f]{4}:[0-9a-f]{2}:[0-9a-f]{2}\.[0-7]$")


def _pair(a: int, b: int) -> Tuple[int, int]:
    return (a, b) if a < b else (b, a)


@dataclass(frozen=True)
class GPUTopology:
    """Links among ``num_gpus`` GPUs, by topology index 0..num_gpus-1.

    ``nvlink``       pairs joined by a direct NVLink or through NVSwitch.
    ``pcie_switch``  pairs under a common PCIe switch.
    ``numa``         each GPU's NUMA node (-1 unknown).
    """

    num_gpus: int
    nvlink: FrozenSet[Tuple[int, int]] = frozenset()
    pcie_switch: FrozenSet[Tuple[int, int]] = frozenset()
    numa: Tuple[int, ...] = ()
    _hops: Dict[Tuple[int, int], int] = field(
        default=None, init=False, repr=False, compare=False)  # type: ignore[assignment]
    _cliques: Tuple[Tuple[int, ...], ...] = field(
        default=(), init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "nvlink",
                           frozenset(_pair(*p) for p in self.nvlink))
        object.__setattr__(self, "pcie_switch",
                           frozenset(_pair(*p) for p in self.pcie_switch))
        if not self.numa:
            object.__setattr__(self, "numa", (-1,) * self.num_gpus)
        if len(self.numa) != self.num_gpus:
            raise ValueError("numa/num_gpus length mismatch")
        for a, b in self.nvlink | self.pcie_switch:
            if not (0 <= a < b < self.num_gpus):
                raise ValueError(f"link ({a}, {b}) outside {self.num_gpus} GPUs")
        object.__setattr__(self, "_hops", self._all_hops())
        object.__setattr__(self, "_cliques", self._maximal_cliques())

    def _neighbours(self) -> List[List[int]]:
        out: List[List[int]] = [[] for _ in range(self.num_gpus)]
        for a, b in sorted(self.nvlink):
            out[a].append(b)
            out[b].append(a)
        return out

    def _all_hops(self) -> Dict[Tuple[int, int], int]:
        """Shortest NVLink path length of every pair that has one (BFS)."""
        nbrs = self._neighbours()
        hops: Dict[Tuple[int, int], int] = {}
        for src in range(self.num_gpus):
            dist = {src: 0}
            todo = deque([src])
            while todo:
                u = todo.popleft()
                for v in nbrs[u]:
                    if v not in dist:
                        dist[v] = dist[u] + 1
                        todo.append(v)
            for dst, d in dist.items():
                if dst > src:
                    hops[(src, dst)] = d
        return hops

    def _maximal_cliques(self) -> Tuple[Tuple[int, ...], ...]:
        """Maximal NVLink cliques (Bron-Kerbosch with pivot); a GPU with
        no link is a clique of one."""
        nbrs = [set(n) for n in self._neighbours()]
        out: List[Tuple[int, ...]] = []

        def grow(r, p, x):
            if not p and not x:
                out.append(tuple(sorted(r)))
                return
            pivot = max(p | x, key=lambda u: len(nbrs[u] & p))
            for v in sorted(p - nbrs[pivot]):
                grow(r | {v}, p & nbrs[v], x & nbrs[v])
                p = p - {v}
                x = x | {v}

        grow(set(), set(range(self.num_gpus)), set())
        return tuple(sorted(out))

    # -- queries -------------------------------------------------------------

    def _check(self, i: int) -> None:
        if not 0 <= i < self.num_gpus:
            raise IndexError(f"GPU index {i} outside {self.num_gpus} GPUs")

    def nvlink_hops(self, a: int, b: int) -> Optional[int]:
        """NVLink hops between two GPUs (1 = linked); None = no NVLink path."""
        self._check(a)
        self._check(b)
        if a == b:
            return 0
        return self._hops.get(_pair(a, b))

    def link(self, a: int, b: int) -> str:
        """The pair's closest link class."""
        self._check(a)
        self._check(b)
        p = _pair(a, b)
        if p in self._hops:
            return NVLINK
        if p in self.pcie_switch:
            return PCIE_SWITCH
        if self.numa[a] >= 0 and self.numa[a] == self.numa[b]:
            return SAME_NUMA
        return OTHER

    @property
    def cliques(self) -> Tuple[Tuple[int, ...], ...]:
        """The maximal NVLink cliques, sorted."""
        return self._cliques

    def is_clique(self, indices: Iterable[int]) -> bool:
        """True when every pair of ``indices`` is NVLink-linked (one GPU
        is a clique; no GPU is not)."""
        s = sorted(set(indices))
        if not s:
            return False
        for i in s:
            self._check(i)
        return all(p in self.nvlink for p in itertools.combinations(s, 2))

    def largest_free_clique(self, free: Iterable[int]) -> int:
        """Size of the largest NVLink clique inside ``free`` (indices
        outside the host are placeable in none)."""
        f = {i for i in free if 0 <= i < self.num_gpus}
        return max((len(f.intersection(c)) for c in self._cliques), default=0)


def _pci_ancestors(sysfs_root: str, addr: str) -> Tuple[str, ...]:
    """PCI functions above ``addr`` in its sysfs device path (its root
    port and any switch ports), nearest last."""
    path = os.path.realpath(os.path.join(sysfs_root, "bus", "pci", "devices", addr))
    parts = path.split(os.sep)
    if not parts or parts[-1] != addr:
        return ()
    return tuple(p for p in parts[:-1] if _PCI_ADDR_RE.match(p))


def gpu_topology(chips: Sequence, sysfs_root: str = "/sys") -> Optional[GPUTopology]:
    """The topology of ``chips`` (``GPUChip``s; their ``mesh_index`` is
    the topology index, or their rank where unset).

    NVLink comes from the chips' NVML link ends: an end that is another
    of these GPUs is a bridge; an end that is none of them is an
    NVSwitch, and every GPU on a switch is linked to every other. The
    PCIe switch comes from sysfs; a GPU whose PCI address is unknown
    shares none.
    """
    if not chips:
        return None
    ordered = sorted(chips, key=lambda c: c.index)
    pos = {id(c): (c.mesh_index if c.mesh_index >= 0 else r)
           for r, c in enumerate(ordered)}
    n = max(pos.values()) + 1
    by_addr = {c.pci_address: pos[id(c)] for c in ordered if c.pci_address}
    nvlink = set()
    switched = set()
    for c in ordered:
        for end in c.nvlinks:
            if end in by_addr:
                if by_addr[end] != pos[id(c)]:
                    nvlink.add(_pair(pos[id(c)], by_addr[end]))
            else:
                switched.add(pos[id(c)])
    nvlink.update(itertools.combinations(sorted(switched), 2))
    ancestors = {pos[id(c)]: set(_pci_ancestors(sysfs_root, c.pci_address))
                 for c in ordered if c.pci_address}
    pcie = {
        _pair(a, b)
        for a, b in itertools.combinations(sorted(ancestors), 2)
        if ancestors[a] & ancestors[b]
    }
    numa = [-1] * n
    for c in ordered:
        numa[pos[id(c)]] = c.numa_node
    return GPUTopology(num_gpus=n, nvlink=frozenset(nvlink),
                       pcie_switch=frozenset(pcie), numa=tuple(numa))
