"""Distributed request tracing: hierarchical spans, cross-process
propagation, and a bounded in-memory trace store.

Until ISSUE 10 this module was a flat begin/end journal shim; it is now
a real tracing subsystem, still dependency-free:

- **Hierarchical spans.** ``with span("serve.request"): ...`` records a
  span into the installed :class:`TraceStore` and publishes its context
  through a ``contextvars.ContextVar``, so any span opened inside the
  block — same thread, nested arbitrarily deep — attaches as a child
  automatically. Explicit ``parent=`` overrides the ambient context
  (how engine threads attach their device-call spans to the request
  that is being decoded, across the thread boundary the contextvar
  cannot cross).
- **Propagation.** Inbound HTTP requests carry W3C ``traceparent``
  (``00-<32 hex trace>-<16 hex span>-<flags>``, parsed by
  :func:`parse_traceparent`); the device plugin's ``Allocate`` joins a
  ``traceparent`` it finds in gRPC metadata and injects
  ``TPU_TRACEPARENT`` (:data:`TRACEPARENT_ENV`) into the container env
  alongside ``TPU_ALLOCATION_ID``, so a serving replica's startup span
  continues the allocation trace (:func:`context_from_env`). Gang
  coordinator → member calls share the coordinator's ambient context
  in-process, so a multi-host reserve/commit is one trace.
- **TraceStore.** Finished spans land in a ring buffer bounded by
  ``TPU_TRACE_RING`` traces (default 256) with an OTLP-shaped export
  (:meth:`TraceStore.get`), served at ``/debug/traces`` by obs/http.py
  and the llm-serve daemon (``--trace-debug``).
- **Journaling continues.** Span begin/end and ``event()`` records
  still append to the chiplog journal (utils/chiplog.py) in the exact
  record shape wedge forensics has always used; hot-path spans pass
  ``journal=False`` to stay out of the suspect list while still
  reaching the store.

Metric exemplars: importing this module registers
:func:`current_trace_id` as the metrics registry's exemplar provider,
so every histogram observation made inside a span remembers the trace
id in its bucket (obs/metrics.py, exposed behind
``TPU_METRICS_EXEMPLARS``) — a p99 outlier links straight to its trace.

A :class:`Span` that is created but never entered silently recorded
nothing before ISSUE 10; now it warns once per span name and records a
degenerate span at garbage collection (tpulint rule TPU016 flags the
pattern statically and autofixes to ``with``). One-shot annotations —
the old ``span(...).event(...)`` idiom — use :func:`event` instead.
"""

from __future__ import annotations

import contextvars
import hashlib
import logging
import os
import re
import threading
import time
import uuid
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional

from k8s_device_plugin_tpu_torch.obs import metrics as obs_metrics
from k8s_device_plugin_tpu_torch.utils import chiplog

log = logging.getLogger(__name__)

__all__ = [
    "ALLOCATION_ID_ENV",
    "TRACEPARENT_ENV",
    "TRACE_RING_ENV",
    "DEFAULT_TRACE_RING",
    "SpanContext",
    "Span",
    "TraceStore",
    "span",
    "event",
    "new_correlation_id",
    "new_trace_id",
    "new_span_id",
    "current_allocation_id",
    "current_context",
    "current_trace_id",
    "parse_traceparent",
    "format_traceparent",
    "context_from_env",
    "canonical_trace_id",
    "get_store",
    "install_store",
    "uninstall_store",
]

# The env var Allocate injects and the serve engine reads. One id per
# ContainerAllocateResponse: the pod-side process inherits exactly the
# id of the allocation that granted its device set.
ALLOCATION_ID_ENV = "TPU_ALLOCATION_ID"

# W3C traceparent carried through container env (the Allocate → pod
# hop, where there are no headers to put it in).
TRACEPARENT_ENV = "TPU_TRACEPARENT"

# Ring bound of the in-memory trace store, in traces (not spans).
TRACE_RING_ENV = "TPU_TRACE_RING"
DEFAULT_TRACE_RING = 256

# Spans per trace are bounded too: a runaway loop opening spans under
# one request must not grow the store without limit.
MAX_SPANS_PER_TRACE = 512

_HEX32 = re.compile(r"^[0-9a-f]{32}$")
_HEX16 = re.compile(r"^[0-9a-f]{16}$")


def new_correlation_id(prefix: str = "tpu") -> str:
    """Short, unique, log-greppable: ``<prefix>-<12 hex>``."""
    return f"{prefix}-{uuid.uuid4().hex[:12]}"


def new_trace_id() -> str:
    """A fresh W3C-shaped trace id (32 lowercase hex)."""
    return uuid.uuid4().hex


def new_span_id() -> str:
    """A fresh W3C-shaped span id (16 lowercase hex)."""
    return uuid.uuid4().hex[:16]


def current_allocation_id() -> Optional[str]:
    """The allocation id injected into this container's environment by
    the device plugin's Allocate, or None outside an allocated pod."""
    return os.environ.get(ALLOCATION_ID_ENV) or None


class SpanContext(NamedTuple):
    """The propagatable identity of a span: (trace_id, span_id)."""

    trace_id: str
    span_id: str


# Ambient span context for the current thread/task. Spans set it on
# enter and restore the previous value on exit, so nesting works with
# zero bookkeeping at the call sites.
_current: contextvars.ContextVar[Optional[SpanContext]] = \
    contextvars.ContextVar("tpu_trace_span", default=None)


def current_context() -> Optional[SpanContext]:
    """The innermost active span's context on this thread, or None."""
    return _current.get()


def current_trace_id() -> Optional[str]:
    """The active trace id (the metrics exemplar provider)."""
    ctx = _current.get()
    return None if ctx is None else ctx.trace_id


def canonical_trace_id(trace_id: str) -> str:
    """``trace_id`` as 32 lowercase hex: passed through when already
    W3C-shaped, else derived deterministically (md5) — so a human-keyed
    id like a gang id maps to the same header value on every host."""
    low = str(trace_id).lower()
    if _HEX32.match(low):
        return low
    return hashlib.md5(str(trace_id).encode("utf-8")).hexdigest()


def _canonical_span_id(span_id: str) -> str:
    low = str(span_id).lower()
    if _HEX16.match(low):
        return low
    return hashlib.md5(str(span_id).encode("utf-8")).hexdigest()[:16]


def parse_traceparent(header: Optional[str]) -> Optional[SpanContext]:
    """Parse a W3C ``traceparent`` header into a :class:`SpanContext`.

    Returns None for anything malformed (unknown version length, wrong
    field widths, all-zero ids) — a bad header must never fail a
    request, it just starts a fresh trace.
    """
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id = parts[0], parts[1], parts[2]
    if len(version) != 2 or not re.match(r"^[0-9a-f]{2}$", version) \
            or version == "ff":
        return None
    if not _HEX32.match(trace_id) or trace_id == "0" * 32:
        return None
    if not _HEX16.match(span_id) or span_id == "0" * 16:
        return None
    return SpanContext(trace_id, span_id)


def format_traceparent(ctx: SpanContext) -> str:
    """Render a context as an outbound ``traceparent`` value (sampled
    flag set — everything this subsystem records is kept)."""
    return (
        f"00-{canonical_trace_id(ctx.trace_id)}-"
        f"{_canonical_span_id(ctx.span_id)}-01"
    )


def context_from_env(
    environ: Optional[Dict[str, str]] = None,
) -> Optional[SpanContext]:
    """The trace context a parent process injected via
    :data:`TRACEPARENT_ENV` (the Allocate → container hop), or None."""
    env = os.environ if environ is None else environ
    return parse_traceparent(env.get(TRACEPARENT_ENV))


# ---------------------------------------------------------------------------
# the trace store (ring buffer + OTLP-shaped export)
# ---------------------------------------------------------------------------


def _ring_size_from_env() -> int:
    raw = os.environ.get(TRACE_RING_ENV)
    try:
        value = int(raw) if raw else DEFAULT_TRACE_RING
    except (TypeError, ValueError):
        log.warning("ignoring non-numeric %s=%r", TRACE_RING_ENV, raw)
        return DEFAULT_TRACE_RING
    return value if value > 0 else DEFAULT_TRACE_RING


def _c_trace_evictions():
    return obs_metrics.counter(
        "tpu_obs_trace_evictions_total",
        "whole traces evicted from the in-memory ring — a nonzero "
        "rate means TPU_TRACE_RING is undersized and postmortem "
        "traces are being dropped",
    )


def _g_trace_ring():
    return obs_metrics.gauge(
        "tpu_obs_trace_ring_occupancy_ratio",
        "stored traces / TPU_TRACE_RING capacity (1.0 = every new "
        "trace now evicts an old one)",
    )


class TraceStore:
    """Bounded in-memory ring of finished spans, grouped by trace.

    Insertion-ordered by first-seen trace: when the ``max_traces`` bound
    (knob ``TPU_TRACE_RING``) is exceeded the oldest whole trace is
    evicted — a trace is useful only complete, so eviction never splits
    one. Thread-safe; adds are O(1).
    """

    def __init__(self, max_traces: Optional[int] = None):
        self.max_traces = max(1, int(max_traces if max_traces is not None
                                     else _ring_size_from_env()))
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, List[dict]]" = OrderedDict()
        self.dropped_traces = 0

    def add(self, record: dict) -> None:
        """Append one finished-span record (Span builds these)."""
        trace_id = str(record.get("trace_id") or "")
        if not trace_id:
            return
        evicted = 0
        with self._lock:
            spans = self._traces.get(trace_id)
            if spans is None:
                self._traces[trace_id] = spans = []
                while len(self._traces) > self.max_traces:
                    self._traces.popitem(last=False)
                    self.dropped_traces += 1
                    evicted += 1
            if len(spans) < MAX_SPANS_PER_TRACE:
                spans.append(record)
            stored = len(self._traces)
        # Instrument outside the lock (TPU021 discipline). Eviction was
        # previously invisible — an undersized ring silently dropped
        # whole postmortem traces (ISSUE 16 satellite).
        if evicted:
            _c_trace_evictions().inc(evicted)
        _g_trace_ring().set(stored / self.max_traces)

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()
            self.dropped_traces = 0

    def trace_ids(self) -> List[str]:
        with self._lock:
            return list(self._traces)

    def spans(self, trace_id: str) -> List[dict]:
        """Raw span records of one trace (copies), oldest first."""
        with self._lock:
            return [dict(r) for r in self._traces.get(trace_id, ())]

    def summaries(self) -> List[dict]:
        """One line per stored trace, oldest first — the
        ``/debug/traces`` listing."""
        with self._lock:
            items = [(t, list(spans)) for t, spans in self._traces.items()]
        out = []
        for trace_id, spans in items:
            roots = [s for s in spans if not s.get("parent_id")]
            starts = [s["start"] for s in spans if s.get("start")]
            durs = [s["dur_ms"] for s in spans if s.get("dur_ms")]
            out.append({
                "trace_id": trace_id,
                "root": (roots[0]["name"] if roots
                         else (spans[0]["name"] if spans else "")),
                "spans": len(spans),
                "start": min(starts) if starts else None,
                "dur_ms": max(durs) if durs else None,
                "ok": all(s.get("ok", True) for s in spans),
            })
        return out

    def get(self, trace_id: str,
            service: str = "k8s-device-plugin-tpu") -> Optional[dict]:
        """One trace as an OTLP-shaped document (the
        ``resourceSpans``/``scopeSpans`` nesting an OTLP collector
        ingests), or None for an unknown id."""
        spans = self.spans(trace_id)
        if not spans:
            return None
        return {
            "traceId": canonical_trace_id(trace_id),
            "resourceSpans": [{
                "resource": {"attributes": [{
                    "key": "service.name",
                    "value": {"stringValue": service},
                }]},
                "scopeSpans": [{
                    "scope": {"name": "k8s_device_plugin_tpu_torch.obs.trace"},
                    "spans": [self._otlp_span(s) for s in spans],
                }],
            }],
        }

    @staticmethod
    def _otlp_span(rec: dict) -> dict:
        start = float(rec.get("start") or 0.0)
        dur_s = float(rec.get("dur_ms") or 0.0) / 1000.0
        attrs = dict(rec.get("attrs") or {})
        out = {
            "traceId": canonical_trace_id(rec["trace_id"]),
            "spanId": _canonical_span_id(rec["span_id"]),
            "parentSpanId": (
                _canonical_span_id(rec["parent_id"])
                if rec.get("parent_id") else ""
            ),
            "name": rec["name"],
            "kind": "SPAN_KIND_INTERNAL",
            "startTimeUnixNano": int(start * 1e9),
            "endTimeUnixNano": int((start + dur_s) * 1e9),
            "attributes": [
                {"key": str(k), "value": {"stringValue": str(v)}}
                for k, v in sorted(attrs.items())
            ],
            "status": (
                {"code": "STATUS_CODE_OK"} if rec.get("ok", True)
                else {"code": "STATUS_CODE_ERROR",
                      "message": str(rec.get("error") or "")}
            ),
        }
        events = rec.get("events") or []
        if events:
            out["events"] = [
                {"name": str(e.get("name", "")),
                 "timeUnixNano": int(float(e.get("ts") or 0.0) * 1e9),
                 "attributes": [
                     {"key": str(k), "value": {"stringValue": str(v)}}
                     for k, v in sorted((e.get("attrs") or {}).items())
                 ]}
                for e in events
            ]
        return out


_store: Optional[TraceStore] = None
_store_lock = threading.Lock()


def get_store() -> TraceStore:
    """The process-wide trace store (auto-created, ring-bounded, so
    ``/debug/traces`` works in every daemon without setup)."""
    global _store
    store = _store
    if store is None:
        with _store_lock:
            if _store is None:
                _store = TraceStore()
            store = _store
    return store


def install_store(store: Optional[TraceStore] = None) -> TraceStore:
    """Install (and return) an explicit store — tests isolate with a
    fresh one the way metrics tests install a fresh registry."""
    global _store
    with _store_lock:
        _store = store if store is not None else TraceStore()
        return _store


def uninstall_store() -> None:
    global _store
    with _store_lock:
        _store = None


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def _c_span_leaks():
    return obs_metrics.counter(
        "tpu_obs_span_leaks_total",
        "Span objects garbage-collected without ever being entered "
        "(missing `with`; tpulint TPU016 flags the pattern statically)",
        labels=("name",),
    )


_warned_leaks: set = set()
_warned_lock = threading.Lock()


def _warn_leak_once(name: str) -> bool:
    with _warned_lock:
        if name in _warned_leaks:
            return False
        _warned_leaks.add(name)
    return True


class Span:
    """One node of a trace: name + context + attributes + outcome.

    Use as a context manager: ``__enter__`` publishes the span's
    context (children attach automatically) and journals ``begin``;
    ``__exit__`` journals ``end`` (duration, outcome) and records the
    finished span into the trace store. ``event()`` adds intermediate
    annotations that land both in the journal and on the stored span.

    Parent resolution, in order: an explicit ``trace_id`` starts/joins
    that trace (parenting to the ambient span only when it is already
    on the same trace); an explicit ``parent`` (a SpanContext or Span —
    how engine threads attach to a request across threads) adopts its
    trace; otherwise the ambient context; otherwise a fresh root trace.

    ``journal=False`` keeps begin/end out of the chiplog journal (for
    per-dispatch hot-path spans) while still recording to the store;
    explicit ``event()`` calls always journal.

    A span that is never entered warns once per name and records a
    degenerate error span at GC instead of disappearing silently.
    """

    # __weakref__ keeps spans weakref-able: the sanitizer's witness
    # recorder uses weak references to tell a recycled id() from a
    # genuine same-object cross-thread sighting.
    __slots__ = ("name", "trace_id", "span_id", "parent_id", "fields",
                 "journal", "events", "error", "_t0", "_wall0",
                 "_entered", "_recorded", "_token", "_mu", "__weakref__")

    def __init__(self, name: str, trace_id: Optional[str] = None,
                 parent=None, journal: bool = True, **fields):
        self.name = name
        self.fields = {k: v for k, v in fields.items() if v is not None}
        self.journal = journal
        self.span_id = new_span_id()
        # A span is usually driven by one thread, but event() is part
        # of the cross-thread contract (engine threads annotate spans
        # the handler owns), so the mutable tail — events, error — is
        # lock-guarded (tpulint TPU019; witnessed by the sanitizer).
        self._mu = threading.Lock()
        self.events: List[dict] = []
        self.error: Optional[str] = None
        self._t0 = None
        self._wall0 = None
        self._entered = False
        self._recorded = False
        self._token = None
        if parent is not None and not isinstance(parent, SpanContext):
            parent = SpanContext(parent.trace_id, parent.span_id)
        if parent is None:
            parent = _current.get()
        if trace_id is not None:
            self.trace_id = str(trace_id)
            self.parent_id = (
                parent.span_id
                if parent is not None and parent.trace_id == self.trace_id
                else None
            )
        elif parent is not None:
            self.trace_id = parent.trace_id
            self.parent_id = parent.span_id
        else:
            self.trace_id = new_trace_id()
            self.parent_id = None

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def _journal(self, event_name: str, **fields) -> dict:
        extra = {"trace_id": self.trace_id, "span": self.name}
        extra.update(self.fields)
        extra.update({k: v for k, v in fields.items() if v is not None})
        return chiplog.log_event(f"span.{self.name}", event_name,
                                 extra=extra)

    def event(self, event: str, **fields) -> dict:
        """Journal an intermediate event carrying the span's trace id;
        the event also rides the stored span record."""
        with self._mu:
            self.events.append({
                "name": event,
                "ts": time.time(),
                "attrs": {k: v for k, v in fields.items()
                          if v is not None},
            })
        return self._journal(event, **fields)

    def __enter__(self) -> "Span":
        self._entered = True
        self._t0 = time.perf_counter()
        self._wall0 = time.time()
        self._token = _current.set(self.context)
        if self.journal:
            self._journal("begin")
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur_ms = (
            round((time.perf_counter() - self._t0) * 1000.0, 3)
            if self._t0 is not None else None
        )
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        error = (
            None if exc_type is None else f"{exc_type.__name__}: {exc}"
        )
        with self._mu:
            self.error = error
        if self.journal:
            self._journal("end", dur_ms=dur_ms, ok=exc_type is None,
                          error=error)
        self._record(dur_ms)
        return False  # never swallow

    def _record(self, dur_ms: Optional[float]) -> None:
        if self._recorded:
            return
        self._recorded = True
        try:
            with self._mu:
                error = self.error
                events = list(self.events)
            get_store().add({
                "name": self.name,
                "trace_id": self.trace_id,
                "span_id": self.span_id,
                "parent_id": self.parent_id,
                "start": self._wall0,
                "dur_ms": dur_ms,
                "ok": error is None,
                "error": error,
                "attrs": dict(self.fields),
                "events": events,
            })
        except Exception:  # recording must never break the workload
            log.debug("trace store add failed", exc_info=True)

    def __del__(self):
        # Record-on-GC fallback: a span constructed but never entered
        # used to vanish silently; now it surfaces as a warn-once +
        # a degenerate error span, so the missing `with` is findable
        # at runtime as well as by tpulint TPU016.
        try:
            if self._entered or self._recorded:
                return
            self.error = "span never entered (missing 'with'?)"
            self._wall0 = time.time()
            _c_span_leaks().inc(name=self.name)
            if _warn_leak_once(self.name):
                log.warning(
                    "trace span %r was created but never entered; use "
                    "`with span(...)` (recording a degenerate span)",
                    self.name,
                )
            self._record(None)
        # GC runs during interpreter teardown, where module globals
        # (even logging) may already be torn down; __del__ must never
        # raise.
        # tpulint: disable=TPU001 — teardown-safe __del__, nothing to log with
        except Exception:
            pass


def span(name: str, trace_id: Optional[str] = None, parent=None,
         journal: bool = True, **fields) -> Span:
    """``with span("plugin.allocate", allocation_id=aid): ...``"""
    return Span(name, trace_id=trace_id, parent=parent, journal=journal,
                **fields)


def event(name: str, event_name: str, trace_id: Optional[str] = None,
          **fields) -> dict:
    """One-shot journal annotation (no span lifecycle): the replacement
    for the old ``span(...).event(...)`` idiom, producing the exact
    same journal record shape. Uses the ambient trace id when none is
    given; mints a correlation id as a last resort so the record stays
    greppable."""
    tid = trace_id or current_trace_id() or new_correlation_id("evt")
    extra = {"trace_id": tid, "span": name}
    extra.update({k: v for k, v in fields.items() if v is not None})
    return chiplog.log_event(f"span.{name}", event_name, extra=extra)


# Histograms observed inside a span remember its trace id per bucket
# (obs/metrics.py renders them as OpenMetrics exemplars behind
# TPU_METRICS_EXEMPLARS).
obs_metrics.set_exemplar_provider(current_trace_id)
