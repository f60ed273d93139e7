"""Engine-loop flight recorder: a black box for serving postmortems
(ISSUE 16).

The engine thread appends one small record per iteration — iteration
kind (prefill-chunk / decode-segment / spec / static-batch), rows
active per SLO class, pages in use/free, queue depth, dispatch wall
time — into a bounded ring (knob ``TPU_FLIGHT_RECORDER_RING``). Nobody
reads it in the happy path; when something goes wrong the last N
iterations are dumped to the chiplog journal (utils/chiplog.py)
automatically:

- **watchdog stall** — a registered engine heartbeat goes silent
  (utils/watchdog.py fires the stall-transition listener this module
  registers);
- **SLO alert raise** — the burn-rate monitor transitions OK→SLOW/FAST
  (obs/slo.py calls :func:`dump_installed` on raise transitions, so a
  fast burn produces exactly one dump);
- **armed chaos fault** — a ``serve.*`` fault point fires
  (utils/faults.py notifies lazily, the same seam its injection
  counter uses).

Records split deterministic fields (seq, kind, rows, queue depth,
pages) from timing fields (``wall_ms``), so two runs under the same
fault plan produce identical dumps modulo wall-clock — the chaos
suite's two-run determinism discipline.

Thread model: ``record()`` is engine-thread-only and takes one
uncontended lock per *iteration* (not per token); ``dump()`` may run
from any thread (SLO monitor, watchdog caller, HTTP handler) — it
snapshots the ring under the lock and writes the journal outside it
(TPU021: no blocking I/O under a lock).
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Deque, List, Optional

from k8s_device_plugin_tpu_torch.obs import metrics as obs_metrics
from k8s_device_plugin_tpu_torch.utils import chiplog

__all__ = [
    "RING_ENV",
    "DEFAULT_RING",
    "DUMP_ENV",
    "DEFAULT_DUMP",
    "FlightRecorder",
    "install",
    "uninstall",
    "uninstall_all",
    "installed",
    "dump_installed",
]

RING_ENV = "TPU_FLIGHT_RECORDER_RING"
DEFAULT_RING = 256

# Max records per dump — a dump must stay one readable journal line,
# not a megabyte (the /debug limit discipline, applied to the journal).
DUMP_ENV = "TPU_FLIGHT_RECORDER_DUMP"
DEFAULT_DUMP = 64


def _c_dumps():
    return obs_metrics.counter(
        "tpu_obs_flight_dumps_total",
        "flight-recorder ring dumps written to the chiplog journal, "
        "by trigger",
        labels=("trigger",),
    )


def _int_env(name: str, default: int) -> int:
    raw = os.environ.get(name)
    try:
        value = int(raw) if raw else default
    except ValueError:
        return default
    return max(0, value)


class FlightRecorder:
    """Bounded ring of per-iteration engine records."""

    def __init__(self, name: str = "serve",
                 capacity: Optional[int] = None,
                 dump_max: Optional[int] = None):
        self.name = name
        self.capacity = (_int_env(RING_ENV, DEFAULT_RING)
                         if capacity is None else max(0, int(capacity)))
        self.dump_max = (_int_env(DUMP_ENV, DEFAULT_DUMP)
                         if dump_max is None else max(1, int(dump_max)))
        self._lock = threading.Lock()
        self._ring: Deque[dict] = deque(maxlen=max(1, self.capacity))
        self._seq = 0
        self.dumps = 0

    def record(self, kind: str, **fields) -> None:
        """One iteration record (engine thread). ``capacity=0``
        disables recording but keeps the call sites branch-free."""
        if self.capacity == 0:
            return
        with self._lock:
            self._seq += 1
            rec = {"seq": self._seq, "kind": kind}
            rec.update(fields)
            self._ring.append(rec)

    def snapshot(self, limit: Optional[int] = None) -> List[dict]:
        """Newest ``limit`` records, oldest first (copies)."""
        n = self.dump_max if limit is None else max(1, int(limit))
        with self._lock:
            rows = list(self._ring)
        return [dict(r) for r in rows[-n:]]

    def dump(self, trigger: str, note: Optional[str] = None) -> int:
        """Write the tail of the ring to the chiplog journal; returns
        the number of records dumped. Journal write happens outside
        the ring lock."""
        records = self.snapshot()
        with self._lock:
            self.dumps += 1
            seq = self._seq
        chiplog.log_event(
            "flight-recorder", "dump", note=note,
            extra={
                "recorder": self.name,
                "trigger": trigger,
                "records": records,
                "seq": seq,
                "ring": self.capacity,
            },
        )
        _c_dumps().inc(trigger=trigger.split(":", 1)[0] or "manual")
        return len(records)


# ---------------------------------------------------------------------------
# installed recorders: the dump triggers fan out to whatever the
# process's engines registered (one per batcher)
# ---------------------------------------------------------------------------

_installed: List[FlightRecorder] = []
_installed_lock = threading.Lock()
_watchdog_hooked = False


def install(recorder: FlightRecorder) -> FlightRecorder:
    """Register a recorder with the process-wide dump triggers
    (watchdog stall / SLO raise / armed fault). Idempotent."""
    global _watchdog_hooked
    with _installed_lock:
        if recorder not in _installed:
            _installed.append(recorder)
        if not _watchdog_hooked:
            from k8s_device_plugin_tpu_torch.utils import watchdog as watchdog_mod

            watchdog_mod.add_stall_listener(_on_watchdog_stall)
            _watchdog_hooked = True
    return recorder


def uninstall(recorder: FlightRecorder) -> None:
    with _installed_lock:
        try:
            _installed.remove(recorder)
        except ValueError:
            pass


def uninstall_all() -> None:
    """Test isolation: drop every registered recorder."""
    with _installed_lock:
        del _installed[:]


def installed() -> List[FlightRecorder]:
    with _installed_lock:
        return list(_installed)


def dump_installed(trigger: str, note: Optional[str] = None) -> int:
    """Dump every installed recorder; returns total records written.
    Never raises — a postmortem hook must not take down the path that
    tripped it."""
    total = 0
    for rec in installed():
        try:
            total += rec.dump(trigger, note=note)
        # tpulint: disable=TPU001 — best-effort postmortem fan-out
        except Exception:
            pass
    return total


def _on_watchdog_stall(name: str, age_s: float) -> None:
    dump_installed(f"watchdog:{name}",
                   note=f"loop silent {age_s:.1f}s")
