"""Daemon watchdog: heartbeat registry behind /healthz (ISSUE 5).

Every daemon in this repo is a bundle of long-lived loops (the dpm
heartbeat, the exporter's chip poll, the labeller's watch loop, the
remediation loop) and until now a wedged loop looked identical to a
healthy one from outside the process — ``/healthz`` answered 200
unconditionally, so the kubelet's probes could never restart a daemon
whose ListAndWatch heartbeat had silently died. This module is the
liveness seam: each loop registers a named :class:`Heartbeat` with a
stall budget and calls :meth:`Heartbeat.beat` once per iteration; the
shared HTTP endpoint (obs/http.py) consults :func:`stalled` and flips
``/healthz`` to 503 — with a JSON detail naming the stalled loop — while
``/metrics`` stays up so the stall itself is observable.

Semantics:

- a heartbeat is *stalled* when more than ``stall_after_s`` elapsed
  since its last beat (registration counts as the first beat, so a loop
  gets its full budget to reach the first iteration);
- re-registering a name replaces the old heartbeat (a restarted loop
  must not inherit its predecessor's stall);
- :meth:`Heartbeat.close` unregisters (an orderly loop exit is not a
  stall);
- loops that legitimately block for long stretches (the labeller's
  watch holds a stream open for its server-side timeout) size
  ``stall_after_s`` past their worst-case healthy iteration.

Thread-safe; the clock is injectable for tests. The module-level
default registry is what daemons and obs/http.py share; tests build
their own :class:`WatchdogRegistry` instances.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from k8s_device_plugin_tpu_torch.obs import metrics as obs_metrics

__all__ = [
    "Heartbeat",
    "WatchdogRegistry",
    "default_registry",
    "register",
    "stalled",
    "healthz_doc",
    "add_stall_listener",
    "remove_stall_listener",
]


# Stall-TRANSITION listeners (ISSUE 16): called once per loop when it
# newly crosses its budget (not on every poll while it stays stalled).
# The flight recorder registers here so a wedged engine loop dumps its
# last iterations to the journal exactly once per wedge. Process-wide —
# a listener fires for stalls observed on ANY registry (tests build
# their own registries with fake clocks).
_stall_listeners: list = []
_listener_lock = threading.Lock()


def add_stall_listener(fn: Callable[[str, float], None]) -> None:
    """Register ``fn(loop_name, age_s)``; idempotent per function."""
    with _listener_lock:
        if fn not in _stall_listeners:
            _stall_listeners.append(fn)


def remove_stall_listener(fn: Callable[[str, float], None]) -> None:
    with _listener_lock:
        try:
            _stall_listeners.remove(fn)
        except ValueError:
            pass


def _notify_stall(name: str, age_s: float) -> None:
    with _listener_lock:
        listeners = list(_stall_listeners)
    for fn in listeners:
        try:
            fn(name, age_s)
        # tpulint: disable=TPU001 — a postmortem hook must not break /healthz
        except Exception:
            pass


def _g_stalled():
    return obs_metrics.gauge(
        "tpu_watchdog_stalled_count",
        "1 when the named daemon loop has missed its heartbeat budget",
        labels=("loop",),
    )


class Heartbeat:
    """One loop's liveness handle. ``beat()`` is a timestamp store under
    the registry lock — cheap enough for every loop iteration."""

    def __init__(self, registry: "WatchdogRegistry", name: str,
                 stall_after_s: float):
        if stall_after_s <= 0:
            raise ValueError("stall_after_s must be positive")
        self.name = name
        self.stall_after_s = float(stall_after_s)
        self._registry = registry
        self._last = registry._clock()

    def beat(self) -> None:
        with self._registry._lock:
            self._last = self._registry._clock()

    def age_s(self, now: Optional[float] = None) -> float:
        with self._registry._lock:
            now = self._registry._clock() if now is None else now
            return max(0.0, now - self._last)

    def is_stalled(self, now: Optional[float] = None) -> bool:
        return self.age_s(now) > self.stall_after_s

    def close(self) -> None:
        """Orderly loop exit: stop watching this heartbeat."""
        self._registry.unregister(self.name)


class WatchdogRegistry:
    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._beats: Dict[str, Heartbeat] = {}
        # Loops observed stalled on the previous poll — the edge
        # detector behind the stall-transition listeners.
        self._was_stalled: set = set()

    def register(self, name: str, stall_after_s: float) -> Heartbeat:
        """Register (or replace — a restarted loop must start with a
        fresh budget) the heartbeat for ``name``."""
        hb = Heartbeat(self, name, stall_after_s)
        with self._lock:
            self._beats[name] = hb
        return hb

    def unregister(self, name: str) -> None:
        with self._lock:
            self._beats.pop(name, None)
        # The per-loop series must not freeze at its last value once the
        # loop is gone (the gauge-pruning discipline from PR 4).
        _g_stalled().remove(loop=name)

    def names(self) -> list:
        with self._lock:
            return sorted(self._beats)

    def stalled(self, now: Optional[float] = None) -> Dict[str, float]:
        """{loop name: seconds since last beat} for every stalled loop;
        also publishes the per-loop stall gauge."""
        with self._lock:
            now = self._clock() if now is None else now
            beats = list(self._beats.values())
        out: Dict[str, float] = {}
        gauge = _g_stalled()
        for hb in beats:
            age = hb.age_s(now)
            is_stalled = age > hb.stall_after_s
            gauge.set(1 if is_stalled else 0, loop=hb.name)
            if is_stalled:
                out[hb.name] = age
        # Edge-detect outside the lock: notify listeners once per new
        # stall; a loop that beats again re-arms its edge.
        with self._lock:
            fresh = set(out) - self._was_stalled
            self._was_stalled = set(out)
        for name in sorted(fresh):
            _notify_stall(name, out[name])
        return out

    def healthz_doc(self) -> dict:
        """The readiness fragment /healthz serves: ``status`` is ``ok``
        only when no registered loop is stalled."""
        stalled_now = self.stalled()
        doc = {
            "status": "stalled" if stalled_now else "ok",
            "watchdog": {"loops": self.names()},
        }
        if stalled_now:
            doc["watchdog"]["stalled"] = {
                name: round(age, 1) for name, age in stalled_now.items()
            }
        return doc


_default = WatchdogRegistry()


def default_registry() -> WatchdogRegistry:
    return _default


def register(name: str, stall_after_s: float) -> Heartbeat:
    """Register a loop on the process-wide registry (what daemons use)."""
    return _default.register(name, stall_after_s)


def stalled() -> Dict[str, float]:
    return _default.stalled()


def healthz_doc() -> dict:
    return _default.healthz_doc()
