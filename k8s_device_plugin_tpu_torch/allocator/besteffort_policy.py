"""Best-effort placement policy.

Counterpart of the reference's BestEffortPolicy
(internal/pkg/allocator/besteffort_policy.go): same two-phase shape —
``init`` precomputes all pair weights in memory (besteffort_policy.go:70-86),
``allocate`` validates, early-returns trivial cases, then picks the
minimum-score candidate subset (besteffort_policy.go:88-151).

Candidate generation follows the reference's TPU policy with the GPU
notion of contiguity: instead of growing subsets across GPU-partition
groups (getCandidateDeviceSubsets, device.go:354-443), we

  1. try every subset of an NVLink clique of the requested size (GPUs
     linked pair by pair: full-bandwidth placements), and
  2. fall back to a bounded exhaustive / greedy min-weight search when no
     clique fits the availability pattern.

Scoring is lexicographic: (not-contiguous, pair-weight sum, fragmentation),
where contiguous = an NVLink clique and fragmentation = loss of the
largest free NVLink clique — the anti-fragmentation role the reference
fills with fewest-partitions-first ordering (device.go:415-417). The
reference's native subset search has no counterpart here: the Python
search below is what the reference runs without its library.
"""

from __future__ import annotations

import itertools
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

from k8s_device_plugin_tpu_torch.allocator.allocator import AllocationError
from k8s_device_plugin_tpu_torch.allocator.device import (
    Device,
    build_pair_weights,
    candidate_clique_selections,
    is_contiguous_selection,
    largest_free_clique,
    subset_weight,
)
from k8s_device_plugin_tpu_torch.discovery.topology import GPUTopology
from k8s_device_plugin_tpu_torch.obs import metrics as obs_metrics

log = logging.getLogger(__name__)

# Validation messages, 1:1 with the reference's (besteffort_policy.go:36-43).
INVALID_SIZE = "allocation size can not be negative or zero"
INVALID_AVAILABLE = "available devices count less than allocation size"
INVALID_REQUIRED = "must_include devices size is more than allocation size"
INVALID_REQ_AVAILABLE = (
    "must_include length should be less than or equal to available device size"
)
INVALID_INIT = "init method must be called before allocate"
NO_CANDIDATE_FOUND = "no candidate subset found with matching criteria"

# Above this many free devices the exhaustive fallback switches to greedy
# growth; C(16,8)=12870 subsets is the worst exhaustive case we accept.
_EXHAUSTIVE_LIMIT = 16


class BestEffortPolicy:
    def __init__(self):
        self._devices: List[Device] = []
        self._by_id: Dict[str, Device] = {}
        self._weights: Dict[Tuple[int, int], int] = {}
        self._topo: Optional[GPUTopology] = None

    def init(self, devices: Sequence[Device], topology: Optional[GPUTopology]) -> None:
        if not devices:
            raise AllocationError(
                "devices list is empty; unable to calculate pair-wise weights"
            )
        self._devices = list(devices)
        self._by_id = {d.id: d for d in devices}
        if len(self._by_id) != len(self._devices):
            raise AllocationError("duplicate device ids")
        self._topo = topology
        self._weights = build_pair_weights(self._devices, topology)
        if self._devices and len(self._devices) > 1 and not self._weights:
            raise AllocationError("failed to initialise pair weights")

    def allocate(
        self, available: Sequence[str], required: Sequence[str], size: int
    ) -> List[str]:
        start = time.perf_counter()
        outcome = "ok"
        try:
            return self._allocate(available, required, size)
        except AllocationError:
            outcome = "error"
            raise
        finally:
            obs_metrics.histogram(
                "tpu_allocator_decision_seconds",
                "preferred-allocation policy decision time",
            ).observe(time.perf_counter() - start)
            obs_metrics.counter(
                "tpu_allocator_decisions_total",
                "preferred-allocation decisions by outcome",
                labels=("outcome",),
            ).inc(outcome=outcome)

    def _allocate(
        self, available: Sequence[str], required: Sequence[str], size: int
    ) -> List[str]:
        # Validation order mirrors the reference (besteffort_policy.go:90-124).
        if size <= 0:
            raise AllocationError(INVALID_SIZE)
        if len(available) < size:
            raise AllocationError(INVALID_AVAILABLE)
        if len(required) > size:
            raise AllocationError(INVALID_REQUIRED)
        if len(required) > len(available):
            raise AllocationError(INVALID_REQ_AVAILABLE)
        if not self._devices:
            raise AllocationError(INVALID_INIT)
        if len(available) == size:
            return list(available)
        if len(required) == size:
            return list(required)
        if not set(required) <= set(available):
            raise AllocationError(NO_CANDIDATE_FOUND)

        unknown = [i for i in available if i not in self._by_id]
        if unknown:
            raise AllocationError(f"{NO_CANDIDATE_FOUND}: unknown ids {unknown}")

        avail_devs = [self._by_id[i] for i in available]
        req_devs = [self._by_id[i] for i in required]

        best = self._best_selection(avail_devs, req_devs, size)
        if best is None:
            raise AllocationError(NO_CANDIDATE_FOUND)
        # Topology-score distribution: low weights = tight placements;
        # drift upward over time is the fragmentation signal operators
        # tune the policy (or their pod sizes) against.
        obs_metrics.histogram(
            "tpu_allocator_selection_score",
            "pair-weight sum of the chosen device subset "
            "(0 = perfectly contiguous placement)",
            buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128, 256),
        ).observe(subset_weight([d.index for d in best], self._weights))
        ids = [d.id for d in sorted(best, key=lambda d: d.index)]
        log.info("best device subset: %s", ids)
        return ids

    # -- candidate generation ------------------------------------------------

    def _score(
        self, selection: Sequence[Device], avail_devs: Sequence[Device]
    ) -> Tuple[int, int, int, Tuple[int, ...]]:
        contiguous = is_contiguous_selection(selection, self._topo)
        weight = subset_weight([d.index for d in selection], self._weights)
        chosen = {d.id for d in selection}
        remaining = [d for d in avail_devs if d.id not in chosen]
        frag = -largest_free_clique(remaining, self._topo)
        # Tie-break on sorted device indices, as the reference does.
        indices = tuple(sorted(d.index for d in selection))
        return (0 if contiguous else 1, weight, frag, indices)

    def _best_selection(
        self,
        avail_devs: List[Device],
        req_devs: List[Device],
        size: int,
    ) -> Optional[List[Device]]:
        candidates = candidate_clique_selections(
            {d.index: d for d in self._devices}, avail_devs, req_devs, size, self._topo
        )
        if not candidates:
            candidates = self._search_candidates(avail_devs, req_devs, size)
        if not candidates:
            return None
        return min(candidates, key=lambda s: self._score(s, avail_devs))

    def _search_candidates(
        self,
        avail_devs: List[Device],
        req_devs: List[Device],
        size: int,
    ) -> List[List[Device]]:
        """General fallback: min-weight subsets when no clique placement fits."""
        req_ids = {d.id for d in req_devs}
        free = [d for d in avail_devs if d.id not in req_ids]
        need = size - len(req_devs)
        if need < 0 or need > len(free):
            return []
        if len(free) <= _EXHAUSTIVE_LIMIT:
            return [
                list(req_devs) + list(combo)
                for combo in itertools.combinations(free, need)
            ]
        # Greedy growth for large device counts:
        # seed with each free device, repeatedly add the device minimising
        # the incremental weight — the same spirit as the reference's
        # sorted-growth loop (device.go:406-441) without full enumeration.
        candidates = []
        for seed in free:
            sel = list(req_devs) + [seed]
            pool = [d for d in free if d is not seed]
            while len(sel) < size and pool:
                nxt = min(
                    pool,
                    key=lambda d: sum(
                        self._weights.get(tuple(sorted((d.index, s.index))), 0)
                        for s in sel
                    ),
                )
                sel.append(nxt)
                pool.remove(nxt)
            if len(sel) == size:
                candidates.append(sel)
        return candidates
