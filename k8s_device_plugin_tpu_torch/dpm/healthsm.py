"""Per-device health lifecycle state machine (ISSUE 4 tentpole).

The reference plugin (health.go) and our pre-ISSUE-4 port treat health
as an instantaneous binary: one bad exporter poll marks a chip
Unhealthy and evicts it from the schedulable pool, one good poll puts
it straight back. Production partial-failure windows are dominated by
exactly this flapping, and on TPU one flapping chip poisons its whole
multi-chip topology group. This module replaces the flip with a
lifecycle::

            bad poll                 K bad of last N
    HEALTHY ---------> SUSPECT ----------------------> UNHEALTHY
       ^                  |                                |
       | M good           | M consecutive good             | M consecutive
       | + soak_s         v                                v    good
       +------------- (HEALTHY) <------ soak_s ------- RECOVERING
                                                           |  bad poll
                                                           v
                                                       UNHEALTHY

    any state --[ > flap_max transitions in flap_window_s ]--> QUARANTINED
    QUARANTINED --[ operator reset() or quarantine_reset_s ]--> RECOVERING

Kubelet-facing health is a projection: HEALTHY and SUSPECT advertise
``Healthy`` (a single bad poll no longer evicts a device); everything
else advertises ``Unhealthy``. Partition devices inherit the **worst**
member state via :func:`worst`.

The machine is deliberately pure (no metrics, no logging policy beyond
debug): callers wire transitions to counters/spans through
``on_transition``. State is serializable (:meth:`snapshot` /
:meth:`restore`) so quarantine decisions survive plugin restarts
through dpm/checkpoint.py; timestamps are wall-clock for that reason.

Thread-safe: the plugin observes from its ListAndWatch heartbeat thread
while Allocate/stop() snapshot from gRPC threads, so every public
method holds one internal RLock. ``on_transition`` fires with that lock
held — callbacks must not call back into the machine's mutators or take
locks that are ever held while observing.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, Iterable, List, Optional

from k8s_device_plugin_tpu_torch.api import constants

log = logging.getLogger(__name__)

__all__ = [
    "HEALTHY",
    "SUSPECT",
    "UNHEALTHY",
    "QUARANTINED",
    "RECOVERING",
    "SEVERITY",
    "HealthConfig",
    "HealthStateMachine",
    "kubelet_health",
    "worst",
]

HEALTHY = "HEALTHY"
SUSPECT = "SUSPECT"
UNHEALTHY = "UNHEALTHY"
QUARANTINED = "QUARANTINED"
RECOVERING = "RECOVERING"

# Projection severity for worst-member merges: a quarantined member
# outranks everything; SUSPECT still schedules but outranks HEALTHY so
# a suspect member is visible on the group's state gauge.
SEVERITY = {
    HEALTHY: 0,
    SUSPECT: 1,
    RECOVERING: 2,
    UNHEALTHY: 3,
    QUARANTINED: 4,
}

ALL_STATES = tuple(sorted(SEVERITY, key=SEVERITY.get))


def worst(states: Iterable[str]) -> str:
    """Worst state of a member set (partition devices inherit this).
    An empty member set has nothing vouching for it: UNHEALTHY."""
    out: Optional[str] = None
    for s in states:
        if out is None or SEVERITY[s] > SEVERITY[out]:
            out = s
    return UNHEALTHY if out is None else out


def kubelet_health(state: str) -> str:
    """Project a lifecycle state onto the kubelet's binary vocabulary."""
    if state in (HEALTHY, SUSPECT):
        return constants.HEALTHY
    return constants.UNHEALTHY


def _env_int(env: Dict[str, str], key: str, default: int) -> int:
    try:
        return int(env.get(key, default))
    except (TypeError, ValueError):
        log.warning("ignoring non-integer %s=%r", key, env.get(key))
        return default


def _env_float(env: Dict[str, str], key: str, default: float) -> float:
    try:
        return float(env.get(key, default))
    except (TypeError, ValueError):
        log.warning("ignoring non-numeric %s=%r", key, env.get(key))
        return default


@dataclass
class HealthConfig:
    """Lifecycle knobs (docs/robustness.md "Health lifecycle")."""

    # SUSPECT -> UNHEALTHY when >= demote_k of the last demote_n raw
    # polls were bad.
    demote_k: int = 3
    demote_n: int = 5
    # promote after promote_m consecutive good polls (SUSPECT -> HEALTHY
    # directly; UNHEALTHY -> RECOVERING, which must then hold good for
    # soak_s before HEALTHY).
    promote_m: int = 3
    soak_s: float = 60.0
    # More than flap_max transitions inside flap_window_s parks the
    # device in QUARANTINED.
    flap_max: int = 6
    flap_window_s: float = 600.0
    # Automatic quarantine release after this long (0 = operator reset
    # only, via HealthStateMachine.reset()).
    quarantine_reset_s: float = 3600.0

    @classmethod
    def from_env(cls, environ: Optional[Dict[str, str]] = None) -> "HealthConfig":
        env = os.environ if environ is None else environ
        return cls(
            demote_k=_env_int(env, "TPU_HEALTH_DEMOTE_K", cls.demote_k),
            demote_n=_env_int(env, "TPU_HEALTH_DEMOTE_N", cls.demote_n),
            promote_m=_env_int(env, "TPU_HEALTH_PROMOTE_M", cls.promote_m),
            soak_s=_env_float(env, "TPU_HEALTH_SOAK_S", cls.soak_s),
            flap_max=_env_int(env, "TPU_QUARANTINE_FLAP_MAX", cls.flap_max),
            flap_window_s=_env_float(
                env, "TPU_QUARANTINE_FLAP_WINDOW_S", cls.flap_window_s
            ),
            quarantine_reset_s=_env_float(
                env, "TPU_QUARANTINE_RESET_S", cls.quarantine_reset_s
            ),
        )


class _Track:
    """Per-key lifecycle state + the evidence that justifies it."""

    __slots__ = (
        "state", "window", "good_streak", "recovering_since",
        "quarantined_since", "transitions",
    )

    def __init__(self, demote_n: int):
        self.state = HEALTHY
        self.window: Deque[bool] = deque(maxlen=max(1, demote_n))
        self.good_streak = 0
        self.recovering_since: Optional[float] = None
        self.quarantined_since: Optional[float] = None
        self.transitions: Deque[float] = deque()


class HealthStateMachine:
    """Lifecycle tracker for a set of health keys (chips or devices).

    Thread-safe: observations arrive on the ListAndWatch heartbeat
    thread while checkpoint flushes snapshot from Allocate/stop() gRPC
    threads, so every public method holds ``_lock`` (an RLock — internal
    transitions re-enter it). ``on_transition(key, frm, to, now)`` fires
    once per state change (including quarantine entries/exits), with the
    lock held.
    """

    def __init__(
        self,
        config: Optional[HealthConfig] = None,
        clock: Callable[[], float] = time.time,
        on_transition: Optional[Callable[[str, str, str, float], None]] = None,
    ):
        self.config = config or HealthConfig()
        self._clock = clock
        self.on_transition = on_transition
        self._lock = threading.RLock()
        self._tracks: Dict[str, _Track] = {}

    # -- observation ---------------------------------------------------------

    def observe(self, key: str, healthy: bool,
                now: Optional[float] = None) -> str:
        """Feed one raw poll result for ``key``; returns the (possibly
        updated) lifecycle state."""
        cfg = self.config
        now = self._clock() if now is None else now
        with self._lock:
            tr = self._tracks.get(key)
            if tr is None:
                tr = self._tracks[key] = _Track(cfg.demote_n)
            tr.window.append(healthy)
            tr.good_streak = tr.good_streak + 1 if healthy else 0

            state = tr.state
            if state == QUARANTINED:
                if (
                    cfg.quarantine_reset_s > 0
                    and tr.quarantined_since is not None
                    and now - tr.quarantined_since >= cfg.quarantine_reset_s
                ):
                    # Timed release, same discipline as operator reset():
                    # clear the flap history so the release transition cannot
                    # itself trip the quarantine again.
                    tr.transitions.clear()
                    self._transition(tr, key, RECOVERING, now)
                    tr.recovering_since = now
                    tr.good_streak = 0
                return tr.state
            if state == HEALTHY:
                if not healthy:
                    self._transition(tr, key, SUSPECT, now)
            elif state == SUSPECT:
                bad = sum(1 for ok in tr.window if not ok)
                if bad >= cfg.demote_k:
                    self._transition(tr, key, UNHEALTHY, now)
                elif tr.good_streak >= cfg.promote_m:
                    self._transition(tr, key, HEALTHY, now)
            elif state == UNHEALTHY:
                if tr.good_streak >= cfg.promote_m:
                    self._transition(tr, key, RECOVERING, now)
                    tr.recovering_since = now
            elif state == RECOVERING:
                if not healthy:
                    self._transition(tr, key, UNHEALTHY, now)
                    tr.recovering_since = None
                elif (
                    tr.recovering_since is not None
                    and now - tr.recovering_since >= cfg.soak_s
                ):
                    self._transition(tr, key, HEALTHY, now)
                    tr.recovering_since = None
            return tr.state

    def _transition(self, tr: _Track, key: str, to: str, now: float) -> None:
        frm = tr.state
        tr.state = to
        if to == QUARANTINED:
            tr.quarantined_since = now
        elif frm == QUARANTINED:
            tr.quarantined_since = None
        self._note_flap(tr, key, now)
        log.debug("health %s: %s -> %s", key, frm, to)
        if self.on_transition is not None:
            self.on_transition(key, frm, to, now)
        # Flap-rate quarantine: too many transitions inside the sliding
        # window parks the key regardless of which state it just reached.
        if (
            tr.state != QUARANTINED
            and self.config.flap_max > 0
            and len(tr.transitions) > self.config.flap_max
        ):
            log.warning(
                "health key %s flapped %d times in %.0fs; quarantined",
                key, len(tr.transitions), self.config.flap_window_s,
            )
            self._transition(tr, key, QUARANTINED, now)

    def _note_flap(self, tr: _Track, key: str, now: float) -> None:
        tr.transitions.append(now)
        cutoff = now - self.config.flap_window_s
        while tr.transitions and tr.transitions[0] < cutoff:
            tr.transitions.popleft()

    # -- queries -------------------------------------------------------------

    def state(self, key: str) -> str:
        """Current state (unseen keys are optimistically HEALTHY)."""
        with self._lock:
            tr = self._tracks.get(key)
            return HEALTHY if tr is None else tr.state

    def states(self) -> Dict[str, str]:
        with self._lock:
            return {k: tr.state for k, tr in self._tracks.items()}

    def device_state(self, member_keys: Iterable[str]) -> str:
        """Worst member state — the partition-device projection."""
        return worst(self.state(k) for k in member_keys)

    def quarantined(self) -> List[str]:
        with self._lock:
            return sorted(
                k for k, tr in self._tracks.items()
                if tr.state == QUARANTINED
            )

    # -- operator control ----------------------------------------------------

    def reset(self, key: str, now: Optional[float] = None) -> bool:
        """Operator quarantine release: QUARANTINED -> RECOVERING (the
        device must still re-earn HEALTHY through the soak). Returns
        False when the key is not quarantined."""
        now = self._clock() if now is None else now
        with self._lock:
            tr = self._tracks.get(key)
            if tr is None or tr.state != QUARANTINED:
                return False
            # A reset is an operator decision, not a flap: clear the
            # transition history so the release itself cannot re-quarantine.
            tr.transitions.clear()
            self._transition(tr, key, RECOVERING, now)
            tr.recovering_since = now
            tr.good_streak = 0
            return True

    # -- persistence (dpm/checkpoint.py payload) -----------------------------

    def snapshot(self) -> Dict[str, dict]:
        """JSON-serializable state, sufficient to survive a restart."""
        out: Dict[str, dict] = {}
        with self._lock:
            for key, tr in self._tracks.items():
                out[key] = {
                    "state": tr.state,
                    "window": [bool(b) for b in tr.window],
                    "good_streak": tr.good_streak,
                    "recovering_since": tr.recovering_since,
                    "quarantined_since": tr.quarantined_since,
                    "transitions": list(tr.transitions),
                }
        return out

    def restore(self, snapshot: Dict[str, dict]) -> None:
        """Rebuild tracks from :meth:`snapshot` output. Unknown states or
        malformed entries are skipped (a stale checkpoint must degrade,
        never crash the plugin)."""
        with self._lock:
            for key, rec in (snapshot or {}).items():
                try:
                    state = rec["state"]
                    if state not in SEVERITY:
                        raise ValueError(f"unknown state {state!r}")
                    tr = _Track(self.config.demote_n)
                    tr.state = state
                    tr.window.extend(bool(b) for b in rec.get("window", []))
                    tr.good_streak = int(rec.get("good_streak", 0))
                    rs = rec.get("recovering_since")
                    qs = rec.get("quarantined_since")
                    tr.recovering_since = None if rs is None else float(rs)
                    tr.quarantined_since = None if qs is None else float(qs)
                    tr.transitions.extend(
                        float(t) for t in rec.get("transitions", [])
                    )
                    self._tracks[key] = tr
                except (KeyError, TypeError, ValueError) as e:
                    log.warning(
                        "dropping malformed health snapshot entry %r: %s",
                        key, e,
                    )
