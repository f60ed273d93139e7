"""Per-request lifecycle ledger + bottleneck attribution (ISSUE 16).

The SLO monitor (obs/slo.py) can say *that* TTFT p99 is burning error
budget; nothing in the stack can say *why* — queue wait, prefill
compute, decode compute, and page-pool starvation are indistinguishable
in the serving histograms. This module is the decomposition layer the
ROADMAP fleet arc's autoscaler needs (PAPERS.md 2602.04900's per-stage
latency framing): a ``RequestLedger`` stamps every lifecycle edge of a
request against the engine's injectable clock, and at finish derives

    queue_wait + prefill_service + decode_service + stall == end-to-end

*by construction* — ``stall`` is the residual of wall time not covered
by an attributed interval, split into a page-pressure portion (measured
around the page allocator's eviction/preemption slow path) and a
scheduler portion (time a resident row spent waiting on other rows'
chunks/segments).

Ownership model: a ledger is written ONLY by whoever owns the request
at that moment — the submitting handler thread stamps ``admit`` before
the queue hand-off, then the single engine thread owns every later
edge through ``finish`` (the serve_batch discipline; no locks on the
stamp path). The terminal edge is the exception: fail paths can race
(a shedding handler thread vs the engine's deadline sweep), so
``LedgerStore.finalize`` — once per request, off the per-token path —
resolves the terminal state with a compare-and-set under the store
lock, then publishes into the debug ring and feeds the bottleneck
classifier (which takes its own lock once per finished request or
/metrics scrape, never per token).

Derived surfaces:

- histograms ``tpu_serve_queue_wait_seconds{slo}``,
  ``tpu_serve_service_seconds{phase}``,
  ``tpu_serve_stall_seconds{cause}`` — observed once per request at
  finish, inside the request's trace context so exemplars link each
  bucket to a concrete trace (ISSUE 10 machinery);
- a bounded ring of recent ledgers served at ``/debug/requests`` (and
  ``/debug/requests/<trace_id>``) next to ``/debug/traces``;
- ``tpu_serve_bottleneck_state{cause}`` — a one-hot gauge from the
  windowed :class:`BottleneckMonitor` classifier
  (queue-bound / prefill-bound / decode-bound / page-bound / idle),
  with a one-shot trace event on every transition. This gauge rides
  the ISSUE 13 federation, so the fleet rollup shows per-replica
  causes under the ``replica`` label.

Knobs: ``TPU_LEDGER_RING`` (finished-ledger ring size; 0 disables the
ledger entirely — every stamp becomes a no-op method on the shared
NOOP ledger) and ``TPU_BOTTLENECK_WINDOW_S`` (classifier window).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from k8s_device_plugin_tpu_torch.obs import metrics as obs_metrics
from k8s_device_plugin_tpu_torch.obs import trace as obs_trace

__all__ = [
    "LEDGER_RING_ENV",
    "DEFAULT_LEDGER_RING",
    "BOTTLENECK_WINDOW_ENV",
    "DEFAULT_BOTTLENECK_WINDOW_S",
    "BOTTLENECK_CAUSES",
    "NOOP",
    "RequestLedger",
    "LedgerStore",
    "BottleneckMonitor",
    "get_store",
    "install_store",
    "uninstall_store",
]

LEDGER_RING_ENV = "TPU_LEDGER_RING"
DEFAULT_LEDGER_RING = 256

BOTTLENECK_WINDOW_ENV = "TPU_BOTTLENECK_WINDOW_S"
DEFAULT_BOTTLENECK_WINDOW_S = 30.0

# Closed enums: every label below is one of these (TPU018 discipline).
TERMINAL_STATES = ("ok", "error", "deadline", "shed")
STALL_CAUSES = ("page", "sched")
SERVICE_PHASES = ("prefill", "decode")
BOTTLENECK_CAUSES = (
    "queue-bound", "prefill-bound", "decode-bound", "page-bound", "idle",
)


def _h_queue_wait():
    return obs_metrics.histogram(
        "tpu_serve_queue_wait_seconds",
        "admit -> first engine service per request, by SLO class",
        labels=("slo",),
        buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                 0.5, 1.0, 2.5, 5.0),
    )


def _h_service():
    return obs_metrics.histogram(
        "tpu_serve_service_seconds",
        "attributed engine service time per request, by phase",
        labels=("phase",),
        buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                 0.5, 1.0, 2.5, 5.0),
    )


def _h_stall():
    return obs_metrics.histogram(
        "tpu_serve_stall_seconds",
        "per-request wall time not covered by queue wait or service, "
        "by cause (page = page-pool eviction/preemption slow path)",
        labels=("cause",),
        buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                 0.25, 0.5, 1.0),
    )


def _g_bottleneck():
    return obs_metrics.gauge(
        "tpu_serve_bottleneck_state",
        "one-hot windowed bottleneck classification of the serving "
        "engine (the ROADMAP item-3 autoscaler sensor)",
        labels=("cause",),
    )


def _ring_size_from_env() -> int:
    raw = os.environ.get(LEDGER_RING_ENV)
    try:
        value = int(raw) if raw else DEFAULT_LEDGER_RING
    except ValueError:
        return DEFAULT_LEDGER_RING
    return max(0, value)


def _window_from_env() -> float:
    raw = os.environ.get(BOTTLENECK_WINDOW_ENV)
    try:
        value = float(raw) if raw else DEFAULT_BOTTLENECK_WINDOW_S
    except ValueError:
        return DEFAULT_BOTTLENECK_WINDOW_S
    return value if value > 0 else DEFAULT_BOTTLENECK_WINDOW_S


class RequestLedger:
    """Lifecycle stamps of ONE request. Engine-thread-owned after the
    admit hand-off; every mutator is a plain attribute update (no
    locks, no instrument calls — those happen once, at finalize)."""

    __slots__ = (
        "trace_id", "slo", "ctx",
        "t_admit", "t_dequeue", "t_first_token", "t_finish",
        "prefill_s", "prefill_chunks",
        "decode_s", "decode_segments", "tokens",
        "spec_segments", "spec_tokens",
        "page_copies", "page_pressure", "page_stall_s", "preemptions",
        "state", "_store",
    )

    def __init__(self, store: "LedgerStore", slo: str = "batch",
                 trace_id: str = "", ctx=None):
        self._store = store
        self.slo = slo
        self.trace_id = trace_id
        self.ctx = ctx
        self.t_admit = store.now()
        self.t_dequeue: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_finish: Optional[float] = None
        self.prefill_s = 0.0
        self.prefill_chunks = 0
        self.decode_s = 0.0
        self.decode_segments = 0
        self.tokens = 0
        self.spec_segments = 0
        self.spec_tokens = 0
        self.page_copies = 0
        self.page_pressure = 0
        self.page_stall_s = 0.0
        self.preemptions = 0
        self.state: Optional[str] = None

    # -- lifecycle edges (engine thread) ------------------------------------

    def dequeue(self, t: float) -> None:
        """SLO-lane dequeue: first wins (collect may precede admit)."""
        if self.t_dequeue is None:
            self.t_dequeue = t

    def prefill_chunk(self, t0: float, t1: float) -> None:
        self.dequeue(t0)
        self.prefill_chunks += 1
        self.prefill_s += max(0.0, t1 - t0)

    def first_token(self, t: float) -> None:
        if self.t_first_token is None:
            self.t_first_token = t

    def decode_segment(self, t0: float, t1: float, tokens: int = 0,
                       kind: str = "plain") -> None:
        self.dequeue(t0)
        self.decode_segments += 1
        self.decode_s += max(0.0, t1 - t0)
        self.tokens += tokens
        if kind == "spec":
            self.spec_segments += 1
            self.spec_tokens += tokens

    def page_copy(self) -> None:
        self.page_copies += 1

    def page_wait(self, dt: float) -> None:
        """Time this row spent in the page allocator's eviction/
        preemption slow path (outside any service interval)."""
        self.page_pressure += 1
        self.page_stall_s += max(0.0, dt)

    def preempted(self) -> None:
        self.preemptions += 1

    def finish(self, state: str = "ok") -> None:
        """Terminal edge — idempotent (fail paths may race a deadline
        sweep from another thread); first state wins, the store
        publishes exactly once. The check here is only a fast path —
        the authoritative transition is a compare-and-set under the
        store lock inside :meth:`LedgerStore.finalize`."""
        if self.state is not None:
            return
        self._store.finalize(self, state)

    # -- derived ------------------------------------------------------------

    def decomposition(self) -> Dict[str, float]:
        """The per-request latency split. Components sum to ``e2e``
        exactly (stall is the residual, clamped at zero)."""
        end = self.t_finish if self.t_finish is not None else self._store.now()
        e2e = max(0.0, end - self.t_admit)
        dq = self.t_dequeue if self.t_dequeue is not None else end
        queue_wait = min(e2e, max(0.0, dq - self.t_admit))
        prefill = self.prefill_s
        decode = self.decode_s
        stall = max(0.0, e2e - queue_wait - prefill - decode)
        stall_page = min(stall, self.page_stall_s)
        return {
            "e2e": e2e,
            "queue_wait": queue_wait,
            "prefill_service": prefill,
            "decode_service": decode,
            "stall": stall,
            "stall_page": stall_page,
            "stall_sched": stall - stall_page,
        }

    def summary(self) -> dict:
        """The ``/debug/requests`` document row."""
        d = self.decomposition()
        return {
            "trace_id": self.trace_id,
            "slo": self.slo,
            "state": self.state,
            "e2e_s": round(d["e2e"], 6),
            "queue_wait_s": round(d["queue_wait"], 6),
            "prefill_service_s": round(d["prefill_service"], 6),
            "decode_service_s": round(d["decode_service"], 6),
            "stall_s": round(d["stall"], 6),
            "stall_page_s": round(d["stall_page"], 6),
            "prefill_chunks": self.prefill_chunks,
            "decode_segments": self.decode_segments,
            "tokens": self.tokens,
            "spec_segments": self.spec_segments,
            "spec_tokens": self.spec_tokens,
            "page_copies": self.page_copies,
            "page_pressure": self.page_pressure,
            "preemptions": self.preemptions,
            "ttft_s": (None if self.t_first_token is None
                       else round(self.t_first_token - self.t_admit, 6)),
        }


class _NoopLedger:
    """Shared do-nothing ledger: with ``TPU_LEDGER_RING=0`` (or before
    admission) every stamp is a no-op method call — the engine code
    never branches on whether accounting is enabled."""

    __slots__ = ()
    trace_id = ""
    slo = "batch"
    state = None

    def dequeue(self, t):
        pass

    def prefill_chunk(self, t0, t1):
        pass

    def first_token(self, t):
        pass

    def decode_segment(self, t0, t1, tokens=0, kind="plain"):
        pass

    def page_copy(self):
        pass

    def page_wait(self, dt):
        pass

    def preempted(self):
        pass

    def finish(self, state="ok"):
        pass


NOOP = _NoopLedger()


class LedgerStore:
    """Clock + finished-ledger ring + classifier hand-off.

    ``clock`` is injectable (default ``time.perf_counter``), the same
    discipline as the watchdog/SLO monitor — deterministic tests drive
    a fake clock and get bit-stable decompositions. ``capacity=0``
    disables the ledger: :meth:`open` returns the shared NOOP ledger.
    """

    def __init__(self, capacity: Optional[int] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 monitor: Optional["BottleneckMonitor"] = None):
        self.capacity = (_ring_size_from_env() if capacity is None
                         else max(0, int(capacity)))
        self._clock = clock
        self.monitor = monitor
        self._lock = threading.Lock()
        self._ring: Deque[dict] = deque(maxlen=max(1, self.capacity))
        self.finished_total = 0

    def now(self) -> float:
        return self._clock()

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def open(self, slo: str = "batch", trace_id: str = "", ctx=None):
        """New ledger stamped with ``admit`` at the store clock's now.
        Called by the submitting thread before the queue hand-off."""
        if not self.enabled:
            return NOOP
        return RequestLedger(self, slo=slo, trace_id=trace_id, ctx=ctx)

    def finalize(self, led: RequestLedger, state: str = "error") -> None:
        """Publish one finished ledger: observe the decomposition
        histograms (inside the request's trace context so exemplars
        link back), append to the debug ring, feed the classifier.
        Exactly once per request — the terminal-state transition is a
        compare-and-set under the store lock, so racing finish paths
        (e.g. a shed on a handler thread vs a deadline sweep on the
        engine thread) publish one winner. Off the per-token path."""
        with self._lock:
            if led.state is not None:
                return
            led.state = state if state in TERMINAL_STATES else "error"
            led.t_finish = self.now()
        d = led.decomposition()
        self._observe(led, d)
        row = led.summary()
        with self._lock:
            self.finished_total += 1
            self._ring.append(row)
        mon = self.monitor
        if mon is not None:
            mon.note(row)

    def _observe(self, led: RequestLedger, d: Dict[str, float]) -> None:
        if led.ctx is not None:
            # A real span (parented to the request's root) rather than
            # a bare context push: the decomposition lands in the trace
            # as attributes AND the histogram buckets pick up the trace
            # id as an exemplar.
            with obs_trace.span(
                "serve.request.ledger", parent=led.ctx, journal=False,
                state=led.state, slo=led.slo,
                queue_wait_ms=round(d["queue_wait"] * 1e3, 3),
                prefill_ms=round(d["prefill_service"] * 1e3, 3),
                decode_ms=round(d["decode_service"] * 1e3, 3),
                stall_ms=round(d["stall"] * 1e3, 3),
            ):
                self._observe_plain(led, d)
        else:
            self._observe_plain(led, d)

    @staticmethod
    def _observe_plain(led: RequestLedger, d: Dict[str, float]) -> None:
        _h_queue_wait().observe(d["queue_wait"], slo=led.slo)
        _h_service().observe(d["prefill_service"], phase="prefill")
        _h_service().observe(d["decode_service"], phase="decode")
        _h_stall().observe(d["stall_page"], cause="page")
        _h_stall().observe(d["stall_sched"], cause="sched")

    # -- debug surface ------------------------------------------------------

    def recent(self, limit: Optional[int] = None) -> List[dict]:
        """Finished-ledger rows, newest first."""
        with self._lock:
            rows = list(self._ring)
        rows.reverse()
        return rows if limit is None else rows[:max(0, int(limit))]

    def get(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            rows = list(self._ring)
        for row in reversed(rows):
            if row.get("trace_id") == trace_id:
                return row
        return None

    def debug_doc(self, limit: Optional[int] = None) -> dict:
        rows = self.recent(limit)
        with self._lock:
            stored = len(self._ring)
        return {
            "requests": rows,
            "ring": self.capacity,
            "stored": stored,
            "finished_total": self.finished_total,
            "bottleneck": (self.monitor.cause
                           if self.monitor is not None else None),
        }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.finished_total = 0


class BottleneckMonitor:
    """Windowed classifier over the finished-ledger stream.

    Accumulates per-request decomposition totals over the trailing
    ``TPU_BOTTLENECK_WINDOW_S`` seconds and names the dominant cost:

    - ``page-bound``  — page-pressure stalls/preemptions/page sheds are
      a material share of windowed time (they gate everything else:
      adding compute replicas will not help a starved pool);
    - ``queue-bound`` / ``prefill-bound`` / ``decode-bound`` — the
      largest of the three windowed totals;
    - ``idle`` — nothing finished in the window and the queue is empty.

    ``step()`` re-publishes the one-hot gauge and fires a one-shot
    trace event on transitions; :meth:`note` auto-steps at most once
    per ``min_interval_s`` so production gets transitions for free
    while deterministic tests drive ``step(now=...)`` explicitly.

    Thread model: the event window is fed from wherever a request
    finishes — the engine thread (via finalize), a shedding handler
    thread (victim.fail), and every /metrics scrape calls ``step()``
    to decay the classification — so ``note()``/``step()`` take one
    internal lock per *finished request / scrape* (never per token;
    the per-token stamp path stays lock-free). The one-shot transition
    journal write happens outside the lock (TPU021: no blocking I/O
    under a lock).

    Clock discipline: events are always stamped with THIS monitor's
    clock (``note(now=...)`` is the deterministic-test override), so
    the pruning horizon and the event stamps share one clock domain.
    The process-wide store (:func:`get_store` / :func:`install_store`)
    constructs monitor and store over the same clock.
    """

    # Windowed share of (stall_page + sheds) above which the pool, not
    # compute, is the binding constraint.
    PAGE_FRACTION = 0.25

    def __init__(self, window_s: Optional[float] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 queue_depth_fn: Optional[Callable[[], int]] = None,
                 min_interval_s: float = 1.0):
        self.window_s = (_window_from_env() if window_s is None
                         else float(window_s))
        self._clock = clock
        self.queue_depth_fn = queue_depth_fn
        self.min_interval_s = min_interval_s
        self._lock = threading.Lock()
        self._events: Deque[tuple] = deque()
        self._last_step: Optional[float] = None
        self.cause: Optional[str] = None
        self.transitions: List[dict] = []

    def note(self, row: dict, now: Optional[float] = None) -> None:
        """Feed one finished-ledger summary row (store.finalize)."""
        t = self._clock() if now is None else now
        page_shed = 1 if (row.get("state") == "shed"
                          and (row.get("page_pressure", 0)
                               or row.get("preemptions", 0))) else 0
        with self._lock:
            self._events.append((
                t,
                row.get("queue_wait_s", 0.0),
                row.get("prefill_service_s", 0.0),
                row.get("decode_service_s", 0.0),
                row.get("stall_page_s", 0.0),
                page_shed + row.get("preemptions", 0),
            ))
            if (self._last_step is not None
                    and t - self._last_step < self.min_interval_s):
                return
            transition = self._step_locked(t)
        self._journal_transition(transition)

    def step(self, now: Optional[float] = None) -> str:
        """Re-classify; publish the gauge; event on transition."""
        t = self._clock() if now is None else now
        with self._lock:
            transition = self._step_locked(t)
            cause = self.cause
        self._journal_transition(transition)
        return cause

    def _step_locked(self, t: float) -> Optional[dict]:
        """Prune + classify + publish the gauge under the lock; returns
        the transition record to journal (outside the lock), if any."""
        self._last_step = t
        horizon = t - self.window_s
        ev = self._events
        while ev and ev[0][0] < horizon:
            ev.popleft()
        cause = self._classify()
        transition = None
        if cause != self.cause:
            prev = self.cause
            self.cause = cause
            transition = {"t": t, "frm": prev, "to": cause,
                          "samples": len(ev)}
            self.transitions.append(
                {"t": t, "frm": prev, "to": cause}
            )
        g = _g_bottleneck()
        for c in BOTTLENECK_CAUSES:
            g.set(1.0 if c == cause else 0.0, cause=c)
        return transition

    def _journal_transition(self, transition: Optional[dict]) -> None:
        """Journal the one-shot transition event — outside the lock."""
        if transition is None:
            return
        obs_trace.event(
            "serve.bottleneck", "transition",
            frm=transition["frm"] or "", to=transition["to"],
            window_s=self.window_s, samples=transition["samples"],
        )

    def _classify(self) -> str:
        qd = 0
        fn = self.queue_depth_fn
        if fn is not None:
            try:
                qd = int(fn())
            # tpulint: disable=TPU001 — advisory depth probe only
            except Exception:
                qd = 0
        if not self._events:
            return "queue-bound" if qd > 0 else "idle"
        q = p = d = page = 0.0
        page_events = 0
        for _, qw, pre, dec, pstall, pev in self._events:
            q += qw
            p += pre
            d += dec
            page += pstall
            page_events += pev
        total = q + p + d + page
        if total <= 0.0:
            return "queue-bound" if qd > 0 else "idle"
        if page_events > 0 or page / total >= self.PAGE_FRACTION:
            return "page-bound"
        best = max((q, "queue-bound"), (p, "prefill-bound"),
                   (d, "decode-bound"))
        return best[1]


# ---------------------------------------------------------------------------
# process-wide store (the trace-store install pattern)
# ---------------------------------------------------------------------------

_store: Optional[LedgerStore] = None
_store_lock = threading.Lock()


def get_store() -> LedgerStore:
    """The process-wide ledger store (auto-created with an attached
    bottleneck monitor, so ``/debug/requests`` and the bottleneck
    gauge work in every serving daemon without setup)."""
    global _store
    store = _store
    if store is None:
        with _store_lock:
            if _store is None:
                _store = _default_store()
            store = _store
    return store


def _default_store() -> LedgerStore:
    """Store + monitor over ONE shared clock, so the monitor's pruning
    horizon lives in the same clock domain as the store's stamps."""
    clock = time.perf_counter
    return LedgerStore(clock=clock,
                       monitor=BottleneckMonitor(clock=clock))


def install_store(store: Optional[LedgerStore] = None) -> LedgerStore:
    """Install (and return) an explicit store — tests isolate with a
    fresh one the way metrics tests install a fresh registry."""
    global _store
    with _store_lock:
        _store = store if store is not None else _default_store()
        return _store


def uninstall_store() -> None:
    global _store
    with _store_lock:
        _store = None


def step_installed() -> Optional[str]:
    """Step the installed store's bottleneck monitor, if any — WITHOUT
    auto-creating one (only daemons that actually serve requests should
    publish the bottleneck gauge). The serving daemon calls this per
    /metrics render so the classification decays to ``idle`` when no
    requests are finishing to drive :meth:`BottleneckMonitor.note`."""
    store = _store
    if store is None or store.monitor is None:
        return None
    return store.monitor.step()
