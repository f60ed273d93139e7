"""One retry/backoff engine for every daemon (ISSUE 3 tentpole).

Before this module each component hand-rolled its own failure handling:
``dpm/manager.py`` marched three fixed 3-second ``time.sleep`` waits in
lockstep (blocking its event loop mid-shutdown), the labeller's watch
loop slept a flat 2 s per reconnect, and ``kube/client.py`` had no retry
at all. Hand-rolled loops also defeat chaos testing — there is nothing
to seed. This module centralizes the policy:

- :class:`Backoff` — exponential delays with **full jitter** (AWS
  architecture-blog shape: ``uniform(0, min(cap, base * mult**n))``),
  seedable for deterministic tests;
- :func:`retry_call` — the loop itself: attempt caps, wall-clock
  deadlines, retryable-exception filtering, **interruptible** sleeps
  (a shutdown event aborts the wait instead of blocking it), per-call
  metrics through the PR 1 registry;
- :class:`RetryBudget` — a token bucket shared per component, so a hard
  outage degrades to the refill rate instead of a retry storm;
- :class:`CircuitBreaker` — closed/open/half-open with a monotonic
  clock, for callers that poll (the exporter's runtime-metrics loop)
  rather than retry inline.

Metrics (all under the ``tpu_retry_*`` namespace):

- ``tpu_retry_attempts_total{component, outcome}`` — outcome is ``ok``
  | ``retry`` | ``exhausted`` | ``deadline`` | ``budget`` | ``aborted``
  | ``giveup``;
- ``tpu_retry_backoff_seconds{component}`` — histogram of slept delays.

tpulint rule TPU008 flags hand-rolled retry loops outside this module.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable, Optional, Sequence, Tuple, Type, TypeVar

from k8s_device_plugin_tpu_torch.obs import metrics as obs_metrics

log = logging.getLogger(__name__)

T = TypeVar("T")

__all__ = [
    "Backoff",
    "CircuitBreaker",
    "Pacer",
    "RetryAborted",
    "RetryBudget",
    "retry_call",
]


def _c_attempts():
    return obs_metrics.counter(
        "tpu_retry_attempts_total",
        "retry-engine attempts by component and outcome",
        labels=("component", "outcome"),
    )


def _h_backoff():
    return obs_metrics.histogram(
        "tpu_retry_backoff_seconds",
        "backoff delays actually slept between attempts",
        labels=("component",),
        buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0),
    )


class RetryAborted(RuntimeError):
    """The stop event fired mid-backoff; carries the last real error."""

    def __init__(self, component: str, cause: Optional[BaseException]):
        super().__init__(
            f"{component}: retry aborted by shutdown"
            + (f" (last error: {cause})" if cause else "")
        )
        self.cause = cause


class Backoff:
    """Exponential backoff with full jitter.

    ``delay(attempt)`` for 1-based attempt numbers draws uniformly from
    ``[0, min(cap, base * multiplier**(attempt-1))]``. Seed the rng for
    deterministic chaos tests; production callers leave it None.
    """

    def __init__(self, base_s: float = 0.25, cap_s: float = 30.0,
                 multiplier: float = 2.0, jitter: bool = True,
                 seed: Optional[int] = None):
        if base_s < 0 or cap_s < 0:
            raise ValueError("backoff delays cannot be negative")
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.multiplier = float(multiplier)
        self.jitter = bool(jitter)
        self._rng = random.Random(seed) if seed is not None else random
        self._draw_lock = threading.Lock()

    def ceiling(self, attempt: int) -> float:
        """The un-jittered delay ceiling for a 1-based attempt."""
        return min(
            self.cap_s, self.base_s * self.multiplier ** max(0, attempt - 1)
        )

    def delay(self, attempt: int) -> float:
        ceiling = self.ceiling(attempt)
        if not self.jitter:
            return ceiling
        # Serialize draws: a seeded Backoff shared across threads must
        # hand out a deterministic delay *sequence*, not interleaved
        # partial rng state.
        with self._draw_lock:
            return self._rng.uniform(0.0, ceiling)


class Pacer:
    """Jitter-desynchronized pacing for fixed-interval pollers.

    N daemons restarting together (a DaemonSet rollout, a kubelet
    restart burst, the multi-node harness) would otherwise tick their
    pod-resources reconciles, maintenance polls, and remediation steps
    in lockstep against the API server forever — fixed intervals never
    drift apart on their own. Two draws break the herd:

    - :meth:`first_delay` — a **full-jitter** phase offset,
      ``uniform(0, interval)`` (the AWS shape :class:`Backoff` uses),
      so co-started replicas spread over one whole period immediately;
    - :meth:`next_delay` — ``interval * uniform(1 - spread, 1 + spread)``
      per tick (mean = the configured interval, so cadence-derived
      budgets like watchdog stall windows stay honest), so phases keep
      diffusing instead of re-synchronizing after a shared stall.

    Seedable for the determinism asserts; production callers leave
    ``seed`` None.
    """

    def __init__(self, interval_s: float, spread: float = 0.5,
                 seed: Optional[int] = None):
        if interval_s < 0:
            raise ValueError("pacing interval cannot be negative")
        if not 0 <= spread < 1:
            raise ValueError("spread must be in [0, 1)")
        self.interval_s = float(interval_s)
        self.spread = float(spread)
        self._rng = random.Random(seed) if seed is not None else random
        self._draw_lock = threading.Lock()

    def first_delay(self) -> float:
        with self._draw_lock:
            return self._rng.uniform(0.0, self.interval_s)

    def next_delay(self) -> float:
        with self._draw_lock:
            return self.interval_s * self._rng.uniform(
                1.0 - self.spread, 1.0 + self.spread
            )


class RetryBudget:
    """Token bucket capping retries per component.

    Every retry spends one token; tokens refill continuously at
    ``refill_per_s`` up to ``capacity``. When empty, :func:`retry_call`
    stops retrying immediately (outcome ``budget``) — under a hard
    outage the component degrades to the refill rate instead of
    multiplying load on whatever it is hammering.
    """

    def __init__(self, capacity: float = 10.0, refill_per_s: float = 0.5,
                 clock: Callable[[], float] = time.monotonic):
        self.capacity = float(capacity)
        self.refill_per_s = float(refill_per_s)
        self._clock = clock
        self._tokens = self.capacity
        self._last = clock()
        self._lock = threading.Lock()

    def _refill_locked(self) -> None:
        now = self._clock()
        self._tokens = min(
            self.capacity,
            self._tokens + (now - self._last) * self.refill_per_s,
        )
        self._last = now

    def try_spend(self, tokens: float = 1.0) -> bool:
        with self._lock:
            self._refill_locked()
            if self._tokens < tokens:
                return False
            self._tokens -= tokens
            return True

    def available(self) -> float:
        with self._lock:
            self._refill_locked()
            return self._tokens


def retry_call(
    fn: Callable[[], T],
    *,
    component: str,
    backoff: Optional[Backoff] = None,
    max_attempts: int = 3,
    deadline_s: Optional[float] = None,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    giveup: Optional[Callable[[BaseException], bool]] = None,
    budget: Optional[RetryBudget] = None,
    stop_event: Optional[threading.Event] = None,
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    sleep: Optional[Callable[[float], None]] = None,
) -> T:
    """Call ``fn`` with the shared retry policy; return its result.

    - ``retry_on``: exception types worth another attempt; anything else
      re-raises immediately.
    - ``giveup(exc) -> bool``: per-error veto inside ``retry_on`` (e.g.
      a kube 404 is a clean answer, not an outage).
    - ``deadline_s``: wall-clock cap across ALL attempts and sleeps; a
      delay is clipped to the remaining budget and an expired deadline
      re-raises the last error.
    - ``stop_event``: backoff sleeps wait on this event — a shutdown
      aborts the wait instantly and raises :class:`RetryAborted` instead
      of stalling the caller's event loop (the fixed-sleep bug this
      module replaces).
    - ``budget``: a shared :class:`RetryBudget`; an empty bucket stops
      retrying with the last error.

    On final failure the LAST exception re-raises, so call sites keep
    their existing except clauses.
    """
    policy = backoff or Backoff()
    start = time.monotonic()
    last_exc: Optional[BaseException] = None
    attempt = 0
    while True:
        attempt += 1
        if stop_event is not None and stop_event.is_set():
            _c_attempts().inc(component=component, outcome="aborted")
            raise RetryAborted(component, last_exc)
        try:
            result = fn()
        except retry_on as e:
            last_exc = e
            if giveup is not None and giveup(e):
                _c_attempts().inc(component=component, outcome="giveup")
                raise
            if attempt >= max_attempts:
                _c_attempts().inc(component=component, outcome="exhausted")
                raise
            if budget is not None and not budget.try_spend():
                log.warning("%s: retry budget empty; giving up after "
                            "attempt %d (%s)", component, attempt, e)
                _c_attempts().inc(component=component, outcome="budget")
                raise
            delay = policy.delay(attempt)
            if deadline_s is not None:
                remaining = deadline_s - (time.monotonic() - start)
                if remaining <= 0:
                    _c_attempts().inc(component=component,
                                      outcome="deadline")
                    raise
                delay = min(delay, remaining)
            _c_attempts().inc(component=component, outcome="retry")
            _h_backoff().observe(delay, component=component)
            if on_retry is not None:
                on_retry(attempt, e, delay)
            log.debug("%s: attempt %d/%d failed (%s); backing off %.3fs",
                      component, attempt, max_attempts, e, delay)
            if sleep is not None:
                sleep(delay)
            elif stop_event is not None:
                if stop_event.wait(delay):
                    _c_attempts().inc(component=component,
                                      outcome="aborted")
                    raise RetryAborted(component, e) from e
            else:
                time.sleep(delay)
        else:
            _c_attempts().inc(component=component, outcome="ok")
            return result


class CircuitBreaker:
    """Closed -> open -> half-open breaker for polled dependencies.

    For callers that cannot usefully retry inline (the exporter polls
    the runtime-metrics service once per scrape): after
    ``failure_threshold`` consecutive failures the breaker opens and
    :meth:`allow` answers False (callers skip the poll and serve their
    degraded path) until ``reset_timeout_s`` passes — then exactly
    ``half_open_max`` probe calls are allowed through. A probe success
    closes the breaker; a probe failure re-opens it for another full
    timeout.

    ``on_state_change(state_str)`` fires on every transition (the
    exporter wires its breaker-state gauge there). All methods are
    thread-safe; the clock is injectable for tests.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
    # Gauge encoding, shared by every breaker-state metric: docs and
    # dashboards rely on one mapping repo-wide.
    STATE_VALUES = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}

    def __init__(self, failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0, half_open_max: int = 1,
                 on_state_change: Optional[Callable[[str], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self.half_open_max = int(half_open_max)
        self._on_state_change = on_state_change
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._half_open_inflight = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._peek_state_locked()

    def _peek_state_locked(self) -> str:
        if (self._state == self.OPEN
                and self._clock() - self._opened_at >= self.reset_timeout_s):
            return self.HALF_OPEN
        return self._state

    def _transition_locked(self, new_state: str) -> None:
        if new_state == self._state:
            return
        old, self._state = self._state, new_state
        log.info("circuit breaker %s -> %s", old, new_state)
        if self._on_state_change is not None:
            # Called under the lock on purpose: transitions are rare and
            # the callback (a gauge set) takes only the metric's own
            # sample lock — never this breaker's.
            self._on_state_change(new_state)

    def allow(self) -> bool:
        """May the caller attempt the protected operation now?"""
        with self._lock:
            state = self._peek_state_locked()
            if state == self.CLOSED:
                return True
            if state == self.HALF_OPEN:
                self._transition_locked(self.HALF_OPEN)
                if self._half_open_inflight < self.half_open_max:
                    self._half_open_inflight += 1
                    return True
                return False
            return False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._half_open_inflight = 0
            self._transition_locked(self.CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            state = self._peek_state_locked()
            if state == self.HALF_OPEN:
                # the probe failed: full timeout again
                self._half_open_inflight = 0
                self._opened_at = self._clock()
                self._state = self.HALF_OPEN  # so transition logs/fires
                self._transition_locked(self.OPEN)
                return
            self._consecutive_failures += 1
            if (self._state == self.CLOSED
                    and self._consecutive_failures >= self.failure_threshold):
                self._opened_at = self._clock()
                self._transition_locked(self.OPEN)
