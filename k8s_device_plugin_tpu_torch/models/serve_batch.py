"""Request batching engines for the llm-serve daemon, in PyTorch.

The counterpart of ``k8s_device_plugin_tpu/models/serve_batch.py``, with
its two scheduling designs over the serve_engine.LMServer core:

- ``Batcher`` (static): requests coalescing in a short window share one
  prefill + one full decode loop (``complete_batch``, prefilled through
  the flash kernel B1), groups keyed by decode-loop bucket.
- ``ContinuousBatcher``: a fixed pool of rows decodes in fixed-length
  segments; prompts join and retire at segment boundaries, so a request
  waits at most one segment, not a neighbour's whole decode.

The continuous batcher's two KV layouts, as in the reference:

- ``kv_mode="rows"``: contiguous per-row caches; every admission
  prefills through the flash kernel (serve_engine.prefill_rows).
- ``kv_mode="paged"`` (``_loop_paged`` / ``_PagedEngine``): a page pool
  with per-row block tables (models/kv_cache.py), prefix reuse, chunked
  prefill, copy-on-extend and SLO-class eviction; every attention read
  runs through the paged kernel B2.

With a draft enabled (``LMServer.enable_draft``), all-greedy iterations
of either layout decode through the speculative verify loop
(models/speculative.py); any sampled or logprob-wanting row switches the
iteration to the plain segment.

The paged engine also serves the disaggregated roles (``role=``): a
prefill replica exports each finished prompt's KV pages as a page-block
bundle under a lease, a decode replica fetches bundles from its peer
through a ``HandoffClient`` and imports the pages (models/handoff.py).

The HTTP protocol surface lives in serve_http.py.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import queue
import threading
import time

import numpy as np

from k8s_device_plugin_tpu_torch.models import handoff as kv_handoff
from k8s_device_plugin_tpu_torch.models.kv_cache import (
    SLO_CLASSES,
    SLO_RANK,
    PagePool,
    PrefixIndex,
    page_config_from_env,
)
from k8s_device_plugin_tpu_torch.models.serve_engine import (
    DeadlineError,
    ServerClosingError,
    ShedError,
    _h_decode_step,
    _h_occupancy,
    _h_ttft,
)
from k8s_device_plugin_tpu_torch.obs import flightrec as obs_flightrec
from k8s_device_plugin_tpu_torch.obs import ledger as obs_ledger
from k8s_device_plugin_tpu_torch.obs import metrics as obs_metrics
from k8s_device_plugin_tpu_torch.obs import trace as obs_trace
from k8s_device_plugin_tpu_torch.utils import faults

log = logging.getLogger("llm-serve")


def _c_requests():
    return obs_metrics.counter(
        "tpu_serve_requests_total",
        "serving requests finished, by outcome",
        labels=("outcome",),
    )


def _c_shed():
    return obs_metrics.counter(
        "tpu_serve_shed_total",
        "requests refused at admission, by reason",
        labels=("reason",),
    )


def _g_queue_depth():
    return obs_metrics.gauge(
        "tpu_serve_queue_depth_count",
        "requests admitted but not yet finished (queued + decoding)",
    )


def _h_slo_occupancy():
    return obs_metrics.histogram(
        "tpu_serve_slo_occupancy_ratio",
        "live rows of each SLO class / pool width at each decode "
        "dispatch (how the pool splits across latency tiers)",
        labels=("slo",),
        buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0),
    )


def _c_preempted():
    return obs_metrics.counter(
        "tpu_serve_slo_preemptions_total",
        "lower-class requests shed to make room for a higher class, "
        "by resource (queue slot or KV pages)",
        labels=("resource",),
    )


class SLOQueue:
    """Class-aware admission queue.

    The ``queue.Queue`` surface the batcher uses (put/get/get_nowait/
    task_done/unfinished_tasks), dequeuing strictly by SLO class —
    ``interactive`` before ``standard`` before ``batch``, FIFO within a
    class — and able to shed the newest lowest-class queued request to
    admit a better one. Control items (the warmup tuple) ride a front
    lane. The unfinished count keeps ``queue.Queue`` semantics: +1 at
    put, -1 at task_done.
    """

    _CONTROL = 0  # lane 0: non-request control items

    def __init__(self):
        self._cv = threading.Condition()
        self._lanes = [collections.deque()
                       for _ in range(len(SLO_CLASSES) + 1)]
        self._unfinished = 0

    @property
    def unfinished_tasks(self) -> int:
        with self._cv:
            return self._unfinished

    def put(self, item) -> None:
        lane = self._CONTROL if not isinstance(item, _Request) \
            else item.slo_rank + 1
        with self._cv:
            self._lanes[lane].append(item)
            self._unfinished += 1
            self._cv.notify()

    def _pop_locked(self):
        for lane in self._lanes:
            if lane:
                return lane.popleft()
        raise queue.Empty

    def get(self, timeout: float | None = None):
        with self._cv:
            if timeout is None:
                while not any(self._lanes):
                    self._cv.wait()
            else:
                deadline = time.monotonic() + timeout
                while not any(self._lanes):
                    remain = deadline - time.monotonic()
                    if remain <= 0 or not self._cv.wait(remain):
                        raise queue.Empty
            return self._pop_locked()

    def get_nowait(self):
        with self._cv:
            return self._pop_locked()

    @contextlib.contextmanager
    def held(self):
        """Keep every consumer off the queue while the block runs: what
        the block puts is there all at once when it ends."""
        with self._cv:
            yield

    def task_done(self) -> None:
        with self._cv:
            self._unfinished -= 1

    def shed_lower(self, rank: int):
        """Remove and return the newest queued request of a class
        strictly worse than ``rank`` (worst class first), or None.
        The caller fails the victim and calls task_done for it."""
        with self._cv:
            for lane_idx in range(len(self._lanes) - 1, rank + 1, -1):
                if self._lanes[lane_idx]:
                    return self._lanes[lane_idx].pop()
        return None


def _rep_ctx(reqs):
    """Representative trace context for a batched device call: the
    first request carrying one (a span has one parent)."""
    for r in reqs:
        if r.ctx is not None:
            return r.ctx
    return None


class _Request:
    __slots__ = ("prompt", "budget", "temp", "topk", "done", "slot",
                 "arrival", "asm", "stream_q", "last", "lps", "want_lp",
                 "deadline", "slo", "slo_rank", "ctx", "ledger",
                 "export", "__weakref__")

    def __init__(self, prompt, budget, temp, topk, asm, stream=False,
                 want_lp=False, deadline_s=None, slo="standard"):
        self.want_lp = bool(want_lp)
        if slo not in SLO_RANK:
            raise ValueError(
                f"unknown SLO class {slo!r} (one of {SLO_CLASSES})"
            )
        self.slo = slo
        self.slo_rank = SLO_RANK[slo]
        self.prompt = list(prompt)
        self.budget = int(budget)
        self.temp = float(temp)
        self.topk = int(topk)
        self.done = threading.Event()
        self.slot: dict = {}
        self.arrival = time.perf_counter()
        # Absolute monotonic deadline (None = unbounded), checked at
        # admission and at every segment boundary.
        self.deadline = (
            time.monotonic() + deadline_s if deadline_s else None
        )
        # logprob of each accepted continuation token, parallel to the
        # assembler's token list (truncated together at finish).
        self.lps: list[float] = []
        # TextAssembler: owns the continuation tokens/bytes, truncates
        # at stop sequences, and meters out streamable deltas.
        self.asm = asm
        # Streaming consumers read text chunks here; None terminates.
        self.stream_q: queue.Queue | None = queue.Queue() if stream else None
        self.last = 0
        # Trace context captured at submit: the engine thread parents
        # its device-call spans to it across the thread boundary.
        self.ctx = None
        # Lifecycle ledger (obs/ledger.py): NOOP until submit_async
        # opens a real one.
        self.ledger = obs_ledger.NOOP
        # Handoff prefill request (models/handoff.py): the row finishes
        # at its first token with a serialized page-block bundle in
        # slot["bundle"] instead of entering decode.
        self.export = False

    def expired(self, now=None) -> bool:
        return (self.deadline is not None
                and (now or time.monotonic()) >= self.deadline)

    def fail(self, msg: str, kind: str = "error"):
        self.slot["error"] = msg
        # wait() re-raises by kind: "deadline" -> DeadlineError (504),
        # "shed" -> ShedError (429), everything else -> RuntimeError.
        self.slot["error_kind"] = kind
        self.ledger.finish(state=kind)
        _c_requests().inc(outcome=kind)
        if self.stream_q is not None:
            self.stream_q.put(None)
        self.done.set()

    def finish_ok(self):
        """Successful terminal edge, where the per-request instruments
        land."""
        self.ledger.finish(state="ok")
        _c_requests().inc(outcome="ok")
        self.done.set()


class _BatcherBase:
    """Submit/drain/shutdown machinery of the batching engines."""

    def __init__(self, server, seed: int = 0, max_pending: int = 0):
        self.server = server
        self.q = SLOQueue()
        # Shutdown flag: set by close() on the signal/HTTP thread, read
        # by submitters on every thread.
        self._closed = threading.Event()
        # Submits under way (see _submitting / _closed_and_idle).
        self._submits_mu = threading.Lock()
        self._submits = 0
        self._seed = seed
        self._key = None
        # Admission bound: requests admitted but unfinished (queued +
        # decoding). 0 = unbounded; past the bound submits shed (429).
        self.max_pending = max(0, int(max_pending))
        # The allocation id the device plugin injected into this
        # container's env (None outside an allocated pod).
        self.allocation_id = obs_trace.current_allocation_id()
        # Request-lifecycle ledger store; the bottleneck classifier reads
        # this batcher's queue depth (first batcher wins).
        self.ledgers = obs_ledger.get_store()
        self._queue_depth = lambda: self.q.unfinished_tasks
        mon = self.ledgers.monitor
        if mon is not None and mon.queue_depth_fn is None:
            mon.queue_depth_fn = self._queue_depth
        # Engine-loop flight recorder: one record per iteration, dumped
        # to the journal on watchdog stall / SLO raise / armed fault.
        self.flight = obs_flightrec.install(
            obs_flightrec.FlightRecorder(name=type(self).__name__)
        )

    def _next_key(self):
        """The engine's sampling generator (seeded once, advanced by
        every draw — the counterpart of splitting a PRNG key)."""
        if self._key is None:
            self._key = self.server.generator(self._seed)
        return self._key

    def submit_async(self, tokens, max_new_tokens: int,
                     temperature: float = 0.0, top_k: int = 0,
                     stop=None, stream: bool = False,
                     logprobs: bool = False,
                     deadline_s: float = 0.0,
                     slo: str = "standard",
                     export: bool = False) -> _Request:
        """Enqueue a request and return it immediately.

        Streaming callers read ``req.stream_q`` until the ``None``
        sentinel, then inspect ``req.slot``; blocking callers use
        :meth:`wait`. Raises :class:`ServerClosingError` once shutdown
        has started and :class:`ShedError` when ``max_pending``
        admitted-but-unfinished requests are already in flight.
        ``export`` marks a handoff prefill request (internal: the paged
        engine finishes it at its first token with a page-block bundle
        in ``slot["bundle"]`` instead of decoding — models/handoff.py)."""
        # Counted from before the closed check until the request is
        # queued, so the engine thread's exit test never sees an idle
        # batcher that a submit is about to feed.
        with self._submitting():
            if self._closed.is_set():
                raise ServerClosingError("server is shutting down")
            if (self.max_pending
                    and self.q.unfinished_tasks >= self.max_pending):
                # A full queue sheds its newest lowest-class queued request
                # to admit a better-class arrival; only when nothing queued
                # is strictly worse does the arrival itself shed.
                victim = self.q.shed_lower(SLO_RANK.get(slo, 99))
                if victim is None:
                    _c_shed().inc(reason="queue_full")
                    raise ShedError(
                        f"pending queue full ({self.max_pending} in flight)"
                    )
                _c_shed().inc(reason="preempted_class")
                _c_preempted().inc(resource="queue")
                victim.fail(
                    f"shed: queue full, preempted by {slo}-class arrival",
                    kind="shed",
                )
                self.q.task_done()
                _g_queue_depth().set(self.q.unfinished_tasks)
            from k8s_device_plugin_tpu_torch.models.serve_text import (
                TextAssembler,
            )

            asm = TextAssembler(self.server.tokenizer.token_bytes, stop or ())
            req = _Request(tokens, max_new_tokens, temperature, top_k, asm,
                           stream=stream, want_lp=logprobs,
                           deadline_s=deadline_s, slo=slo)
            req.export = bool(export)
            req.ctx = obs_trace.current_context()
            req.slot["trace_id"] = (
                req.ctx.trace_id if req.ctx is not None
                else obs_trace.new_correlation_id("req")
            )
            if self.allocation_id:
                req.slot["allocation_id"] = self.allocation_id
            # Admit edge: stamped before the queue hand-off — after put()
            # the engine thread owns the ledger.
            req.ledger = self.ledgers.open(
                slo=slo, trace_id=req.slot["trace_id"], ctx=req.ctx
            )
            with obs_trace.span("serve.batcher.submit", journal=False,
                                slo=slo):
                self._route(req)
            _g_queue_depth().set(self.q.unfinished_tasks)
            return req

    @contextlib.contextmanager
    def _submitting(self):
        with self._submits_mu:
            self._submits += 1
        try:
            yield
        finally:
            with self._submits_mu:
                self._submits -= 1

    def _route(self, req: _Request) -> None:
        """Queue hand-off seam. The decode role overrides this to run
        the prefill hop on the submitting thread before enqueueing."""
        self.q.put(req)

    def _handoff_pending(self) -> int:
        """In-flight handoff work :meth:`drain` must additionally wait
        for — 0 everywhere except the disaggregated roles."""
        return 0

    def _closed_and_idle(self) -> bool:
        """The engine thread's exit test: closed, with no submit under
        way and nothing queued, in flight or pending a handoff. A
        submit that starts after the closed flag is read raises
        ServerClosingError, so the thread never strands a request."""
        if not self._closed.is_set():
            return False
        with self._submits_mu:
            if self._submits:
                return False
        return (self.q.unfinished_tasks == 0
                and self._handoff_pending() == 0)

    def wait(self, req: _Request, timeout: float = 600.0):
        """Block until ``req`` decodes; returns (tokens, ttft)."""
        if req.deadline is not None:
            timeout = min(timeout, max(0.0, req.deadline - time.monotonic()))
        if not req.done.wait(timeout):
            if req.expired():
                raise DeadlineError("deadline exceeded while decoding")
            raise RuntimeError(f"decode timed out after {timeout:.0f}s")
        if "error" in req.slot:
            if req.slot.get("error_kind") == "deadline":
                raise DeadlineError(req.slot["error"])
            if req.slot.get("error_kind") == "shed":
                raise ShedError(req.slot["error"])
            raise RuntimeError(req.slot["error"])
        return req.slot["tokens"], req.slot["ttft"]

    def submit(self, tokens, max_new_tokens: int, temperature: float = 0.0,
               top_k: int = 0, timeout: float = 600.0, stop=None):
        """Blocking submit: (full token list, seconds from this call to
        the request's first token, queue wait included)."""
        return self.wait(
            self.submit_async(tokens, max_new_tokens, temperature, top_k,
                              stop=stop),
            timeout,
        )

    def _fail_request(self, req: _Request, msg: str,
                      kind: str = "error") -> None:
        """Terminal seam for in-loop failures: fail + queue bookkeeping."""
        req.fail(msg, kind=kind)
        self.q.task_done()
        _g_queue_depth().set(self.q.unfinished_tasks)

    def _fail_queued(self, msg: str) -> None:
        """Fail every request still queued (the engine is gone)."""
        while True:
            try:
                item = self.q.get_nowait()
            except queue.Empty:
                return
            if isinstance(item, tuple) and item[0] == "warmup":
                item[1].set()
                self.q.task_done()
            else:
                self._fail_request(
                    item[1] if isinstance(item, tuple) else item, msg)

    def quiesce(self):
        """Stop accepting new requests, nothing else (drain() releases
        the observability claims once its window ends)."""
        self._closed.set()

    def close(self):
        """Stop accepting requests and release this batcher's
        process-global observability claims. Idempotent."""
        self._closed.set()
        mon = self.ledgers.monitor
        if mon is not None and mon.queue_depth_fn is self._queue_depth:
            mon.queue_depth_fn = None
        obs_flightrec.uninstall(self.flight)

    def drain(self, timeout: float = 60.0) -> bool:
        """Block until queued + in-flight work finishes (graceful
        shutdown). Tracks unfinished_tasks, which drops only after a
        request's decode completes, and :meth:`_handoff_pending` work:
        handoff RPCs still in flight on submitting threads and exported
        page leases awaiting their decode ack."""
        self.quiesce()
        drained = False
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if (self.q.unfinished_tasks == 0
                    and self._handoff_pending() == 0):
                drained = True
                break
            time.sleep(0.05)
        self.close()
        return drained


class Batcher(_BatcherBase):
    """Static batching: coalesce concurrent requests into complete_batch.

    The first queued request opens a window (``window_ms``); whatever
    else arrives before it closes — up to ``max_batch`` — shares one
    prefill + one decode loop. Under load this multiplies aggregate
    tokens/s by the batch size for one request's latency; an idle server
    pays at most the window. ``max_batch=1`` degenerates to pass-through
    (no window wait: the lone request IS the batch). The thread ends
    once the batcher is closed and idle (the reference's waits on its
    queue forever)."""

    def __init__(self, server, max_batch: int = 4,
                 window_ms: float = 8.0, seed: int = 0,
                 max_pending: int = 0):
        super().__init__(server, seed, max_pending=max_pending)
        self.max_batch = max(1, max_batch)
        self.window = max(0.0, window_ms) / 1000.0
        threading.Thread(target=self._loop, daemon=True,
                         name="llm-serve-batcher").start()

    def _loop(self):
        while True:
            try:
                batch = [self.q.get(timeout=0.2)]
            except queue.Empty:
                if self._closed_and_idle():
                    return
                continue
            try:
                if self.max_batch > 1:
                    deadline = time.monotonic() + self.window
                    while len(batch) < self.max_batch:
                        timeout = deadline - time.monotonic()
                        if timeout <= 0:
                            break
                        try:
                            batch.append(self.q.get(timeout=timeout))
                        except queue.Empty:
                            break
                # Deadline check at admission-to-decode: a request that
                # expired while queued must not spend a whole decode
                # loop's worth of device time finishing for nobody.
                now = time.monotonic()
                expired = [r for r in batch if r.expired(now)]
                for req in expired:
                    req.fail("deadline exceeded while queued",
                             kind="deadline")
                # Group by decode-loop bucket: co-batching a 16-token
                # request with a 1024-token one would make the short
                # request wait the long loop (every row decodes
                # max(budgets) steps). Shortest bucket decodes first, so
                # short requests don't queue behind a long group
                # collected in the same window.
                groups: dict = {}
                for req in batch:
                    if req.done.is_set():
                        continue
                    key = self.server._scan_bucket(max(1, req.budget - 1))
                    groups.setdefault(key, []).append(req)
                for _, group in sorted(groups.items()):
                    call_start = time.perf_counter()
                    lt0 = self.ledgers.now()
                    for req in group:
                        req.ledger.dequeue(lt0)
                    try:
                        # Chaos hook: a device call failing mid-batch.
                        faults.inject("serve.decode_step", mode="static",
                                      rows=len(group))
                        sampled = any(r.temp > 0 or r.topk > 0
                                      for r in group)
                        # Greedy groups that don't need logprobs take
                        # the speculative verify loop when a draft is
                        # enabled (token-exact with the plain loop);
                        # everything else keeps the plain path.
                        spec = (self.server.spec_k is not None
                                and not sampled
                                and not any(r.want_lp for r in group))
                        want_lp = any(r.want_lp for r in group)
                        # One span per device dispatch (a whole batch
                        # group), never per token.
                        with obs_trace.span(  # tpulint: disable=TPU024
                            "serve.engine.static_batch",
                            parent=_rep_ctx(group), journal=False,
                            rows=len(group),
                        ):
                            if spec:
                                outs, ttft = \
                                    self.server.complete_batch_spec(
                                        [r.prompt for r in group],
                                        [r.budget for r in group],
                                    )
                                out_lps = [[] for _ in group]
                            elif want_lp:
                                outs, out_lps, ttft = \
                                    self.server.complete_batch(
                                        [r.prompt for r in group],
                                        [r.budget for r in group],
                                        temps=[r.temp for r in group],
                                        topks=[r.topk for r in group],
                                        key=self._next_key() if sampled
                                        else None,
                                        return_logprobs=True,
                                    )
                            else:
                                # no logprob consumer: skip the
                                # per-token logprob transfer
                                outs, ttft = self.server.complete_batch(
                                    [r.prompt for r in group],
                                    [r.budget for r in group],
                                    temps=[r.temp for r in group],
                                    topks=[r.topk for r in group],
                                    key=self._next_key() if sampled
                                    else None,
                                )
                                out_lps = [[] for _ in group]
                        lt1 = self.ledgers.now()
                        # The call's own ttft splits the interval into
                        # prefill/decode service; clamped so a fake test
                        # clock can't push prefill past the measured span.
                        span_s = max(0.0, lt1 - lt0)
                        pre_s = min(max(0.0, ttft), span_s)
                        self.flight.record(
                            "static_batch", rows=len(group),
                            queue_depth=self.q.unfinished_tasks,
                            wall_ms=round(span_s * 1e3, 3),
                        )
                        for req, out, lp in zip(group, outs, out_lps):
                            req.ledger.prefill_chunk(lt0, lt0 + pre_s)
                            req.ledger.first_token(lt0 + pre_s)
                            req.ledger.decode_segment(
                                lt0 + pre_s, lt1,
                                tokens=len(out) - len(req.prompt),
                            )
                            # Stop-sequence truncation happens on the
                            # host on the finished continuation (static
                            # mode decodes to completion).
                            cont = out[len(req.prompt):]
                            req.asm.push(cont)
                            req.slot["tokens"] = req.prompt + req.asm.tokens
                            req.slot["text"] = req.asm.text()
                            # stop truncation applies to logprobs too
                            req.slot["logprobs"] = lp[:len(req.asm.tokens)]
                            # "stop" = stop string or EOS. EOS shows as a
                            # continuation shorter than the effective
                            # budget, clamped by the same _batch_setup
                            # windowing the decode used.
                            b1, p1, _, _ = self.server._batch_setup(
                                [req.prompt], [req.budget]
                            )
                            eff_budget = min(
                                b1[0],
                                self.server.config.max_seq_len - p1[0],
                            )
                            req.slot["finish_reason"] = (
                                "stop" if req.asm.finished
                                or len(cont) < eff_budget else "length"
                            )
                            # prefill-relative ttft + this request's
                            # window/queue wait before the call started
                            req.slot["ttft"] = (
                                ttft + call_start - req.arrival
                            )
                            if req.stream_q is not None:
                                # static mode has no segment boundaries:
                                # the whole completion is one chunk.
                                text = req.slot["text"]
                                if text:
                                    req.stream_q.put(text)
                                req.stream_q.put(None)
                            req.finish_ok()
                    except Exception as e:  # surface to waiting requests
                        log.exception("batch decode failed")
                        for req in group:
                            req.fail(str(e))
            except Exception as e:
                # Nothing in the loop may kill the lone decode thread:
                # fail whatever was collected and keep serving.
                log.exception("batcher loop error")
                for req in batch:
                    if not req.done.is_set():
                        req.fail(str(e))
            finally:
                for _ in batch:
                    self.q.task_done()
                _g_queue_depth().set(self.q.unfinished_tasks)


class ContinuousBatcher(_BatcherBase):
    """Continuous batching: a fixed row pool decoding in segments.

    The engine thread owns all device calls. Each iteration: admit
    waiting prompts into free rows (one prefill, scattered into the
    pool cache), decode ONE ``segment_tokens``-long loop for every row,
    retire rows whose budget or EOS hit. ``kv_mode="paged"`` runs the
    paged engine instead (``_loop_paged``). The thread ends once the
    batcher is closed and idle.
    """

    # Disaggregation attributes default at class level so engine-level
    # test drivers that build via ``__new__`` + ``_BatcherBase.__init__``
    # (bypassing this class's __init__) get single-process behavior.
    role = "both"
    handoff_client = None
    leases = None
    _handoff_lock = None
    _handoff_inflight = 0

    def __init__(self, server, max_batch: int = 4,
                 segment_tokens: int = 16, seed: int = 0,
                 max_pending: int = 0, kv_mode: str = "rows",
                 page_tokens: int = 0, pool_pages: int = 0,
                 prefill_chunk: int = 0, role: str = "both",
                 handoff_client=None, lease_s: float | None = None):
        super().__init__(server, seed, max_pending=max_pending)
        self.rows = server._bucket(max(1, max_batch), 1, None)
        # segment_tokens <= 0 = auto-tune during warmup from this
        # device's measured dispatch overhead vs per-token cost.
        self._auto = segment_tokens <= 0
        self.segment = max(1, segment_tokens) if not self._auto else 16
        if kv_mode not in ("rows", "paged"):
            raise ValueError(f"unknown kv_mode {kv_mode!r} (rows | paged)")
        self.kv_mode = kv_mode
        if kv_mode == "paged":
            # Paged KV cache (models/kv_cache.py): block-table pool with
            # prefix reuse, chunked prefill, and class-aware eviction.
            self.kv_config = page_config_from_env(
                server.config.max_seq_len, self.rows,
                page_tokens=page_tokens, pool_pages=pool_pages,
            )
            # Prefill chunk is a power of two so chunk-length buckets
            # stay a small set; floor 8. 0 = the 64-token default.
            self.chunk = server._bucket(
                max(8, prefill_chunk or 64), 8,
                cap=server.config.max_seq_len,
            )
            if server.spec_k is not None:
                # All-greedy iterations ride the paged spec loop: the
                # self-draft reads prompt pages through the same tables,
                # the verify block runs through B2, rewinds are the
                # host-side row_len rollback.
                log.info("paged KV mode: speculative verify loop wired "
                         "into the paged scan (k=%d)", server.spec_k)
        elif prefill_chunk and server.spec_k is not None:
            # Genuinely unsupported, so say so — the rows-mode engine
            # prefills whole prompts in one forward and the rows spec
            # loop assumes a fully resident cache.
            raise ValueError(
                "chunked prefill is a paged-KV feature: speculative "
                "decoding with kv_mode='rows' prefills whole prompts — "
                "drop --prefill-chunk or use --kv-cache paged"
            )
        # Disaggregated serving role (models/handoff.py): "prefill"
        # replicas export finished prompts as page-block bundles,
        # "decode" replicas fetch bundles from a prefill peer
        # (handoff_client) and import the pages; "both" is the
        # single-process default.
        if role not in ("prefill", "decode", "both"):
            raise ValueError(
                f"unknown role {role!r} (prefill | decode | both)"
            )
        if role != "both" and kv_mode != "paged":
            raise ValueError(
                "disaggregated roles are a paged-KV feature: the "
                "handoff moves KV page blocks — use kv_mode='paged'"
            )
        if role == "decode" and handoff_client is None:
            raise ValueError(
                "role 'decode' requires a handoff_client pointing at a "
                "prefill peer"
            )
        self.role = role
        self.handoff_client = handoff_client
        # Prefill-side lease accounting for exported page blocks. Any
        # paged engine gets one ("both" serves as the in-proc prefill
        # peer in tests).
        self.leases = (
            kv_handoff.LeaseTable(lease_s=lease_s)
            if kv_mode == "paged" else None
        )
        # Handoff RPCs in flight on submitting threads: drain() waits
        # for these alongside the queue (the bundle is enqueued only
        # after the RPC returns, so neither count alone covers the gap).
        self._handoff_lock = threading.Lock()
        self._handoff_inflight = 0
        target = self._loop_paged if kv_mode == "paged" else self._loop
        threading.Thread(target=target, daemon=True,
                         name="llm-serve-engine").start()

    def warmup(self):
        """Run every (row-bucket, prompt-length-bucket) prefill, the
        per-row-bucket inserts, the segment loop and the pool itself
        once, so no request pays a first call."""
        srv = self.server
        srv.max_rows = self.rows
        t0 = time.perf_counter()
        done = threading.Event()
        self.q.put(("warmup", done))
        done.wait()
        log.info("continuous warmup in %.1fs (rows=%d, segment=%d)",
                 time.perf_counter() - t0, self.rows, self.segment)

    # ------------------------------------------------------------------
    # disaggregated serving: prefill/decode roles over the
    # models/handoff.py page-block hop
    # ------------------------------------------------------------------

    def _route(self, req: _Request) -> None:
        """Decode role: run the prefill hop on the submitting thread —
        the RPC blocks the caller exactly like the local prefill it
        replaces — then enqueue the bundle for the engine to import
        (control lane: imports beat queued prompts to the pool). Any
        hop failure degrades to a plain local prefill; the request
        never observes the disaggregation except in TTFT."""
        if self.role != "decode" or req.export:
            self.q.put(req)
            return
        bundle = self._handoff_fetch(req)
        if bundle is None:
            kv_handoff._c_handoffs().inc(role="decode",
                                         outcome="fallback")
            self.q.put(req)
        else:
            self.q.put(("handoff", req, bundle))

    def _handoff_fetch(self, req: _Request):
        """The decode->prefill RPC for one request; None on failure
        (the caller falls back to local prefill)."""
        remaining = None
        if req.deadline is not None:
            remaining = max(0.05, req.deadline - time.monotonic())
        payload = {
            "tokens": list(req.prompt),
            "max_new_tokens": req.budget,
            "temperature": req.temp,
            "top_k": req.topk,
            "logprobs": req.want_lp,
            "slo": req.slo,
            "deadline_s": remaining or 0.0,
            "traceparent": (obs_trace.format_traceparent(req.ctx)
                            if req.ctx is not None else None),
        }
        with self._handoff_lock:
            self._handoff_inflight += 1
        try:
            return self.handoff_client.fetch(payload,
                                             deadline_s=remaining)
        except Exception as e:  # tpulint: disable=TPU001 — the fallback seam: ANY hop failure (fault, timeout, open breaker, peer shed) degrades to local prefill rather than failing the request
            log.warning("handoff to prefill peer failed (%s); "
                        "re-prefilling locally", e)
            return None
        finally:
            with self._handoff_lock:
                self._handoff_inflight -= 1

    def handle_prefill(self, payload: dict,
                       timeout_s: float | None = None) -> bytes:
        """Prefill-side ingest: run the chunked prefill for a decode
        peer's prompt and return the serialized page-block bundle.

        Called by the ``/v1/handoff/prefill`` HTTP route and by
        ``InProcTransport``. Malformed/incompatible payloads raise
        :class:`~..models.handoff.HandoffRejected` (permanent);
        admission errors (shed/closing/deadline) propagate as-is and
        the transports map them onto the retryable ``HandoffError`` —
        the decode side then retries or falls back."""
        faults.inject("handoff.recv", tokens=len(payload.get(
            "tokens") or ()))
        if self.kv_mode != "paged":
            raise kv_handoff.HandoffRejected(
                "not a paged prefill replica"
            )
        tokens = payload.get("tokens")
        budget = payload.get("max_new_tokens")
        slo = payload.get("slo") or "standard"
        if (not isinstance(tokens, list) or not tokens
                or not all(isinstance(t, int) for t in tokens)
                or not isinstance(budget, int) or budget < 1
                or slo not in SLO_RANK):
            raise kv_handoff.HandoffRejected(
                "bad handoff payload (tokens/max_new_tokens/slo)"
            )
        parent = obs_trace.parse_traceparent(payload.get("traceparent"))
        # The span parents this replica's whole prefill to the decode
        # side's request trace.
        with obs_trace.span("serve.handoff.prefill", parent=parent,
                            journal=False, tokens=len(tokens)):
            req = self.submit_async(
                tokens, budget,
                temperature=float(payload.get("temperature") or 0.0),
                top_k=int(payload.get("top_k") or 0),
                logprobs=bool(payload.get("logprobs")),
                deadline_s=float(payload.get("deadline_s") or 0.0),
                slo=slo,
                export=True,
            )
            self.wait(req, timeout=timeout_s or 30.0)
        bundle = req.slot.get("bundle")
        if bundle is None:
            raise kv_handoff.HandoffRejected(
                "prefill finished without a bundle"
            )
        return bundle.to_bytes()

    def handle_ack(self, lease_id: str) -> bool:
        """Decode-side ack for an exported lease: mark it released —
        the engine thread frees the pages on its next reap tick."""
        if self.leases is None:
            return False
        return self.leases.ack(str(lease_id))

    def _handoff_pending(self) -> int:
        n = 0
        if self._handoff_lock is not None:
            with self._handoff_lock:
                n = self._handoff_inflight
        if self.leases is not None:
            n += self.leases.pending()
        return n

    def drain(self, timeout: float = 60.0) -> bool:
        """Graceful shutdown at the disaggregation seam: the base wait
        covers in-flight handoff RPCs (decode side) and unacked
        exported leases (prefill side), so a SIGTERM'd prefill replica
        finishes or releases every exported lease before exit. Leases
        still pending when the window closes are force-released and
        counted as orphans — the page refs die with the process either
        way; the accounting must not."""
        drained = super().drain(timeout)
        if self.leases is not None and self.leases.pending():
            n = self.leases.release_all()
            log.warning(
                "drain window closed with %d handoff lease(s) pending; "
                "force-released (counted as orphans)", n,
            )
        return drained

    @staticmethod
    def _pow2_floor(n: int) -> int:
        p = 1
        while p * 2 <= n:
            p *= 2
        return p

    def _loop(self):
        srv = self.server
        pool = None
        # Speculative companions (spec_k set): the draft model's cache
        # pool, and each row's true cache length (the spec loop rewinds
        # indices, so the engine must know where every row really is).
        d_pool = None
        rowlen = np.ones((self.rows,), np.int64)
        free = list(range(self.rows))
        live: dict[int, _Request] = {}  # row id -> request
        while True:
            got = []
            try:
                # ---- collect -------------------------------------------
                if free:
                    cap = self._pow2_floor(len(free))
                    block = not live  # idle engine: sleep on the queue
                    while len(got) < cap:
                        try:
                            item = self.q.get(timeout=0.2) if block \
                                else self.q.get_nowait()
                        except queue.Empty:
                            break
                        block = False
                        if isinstance(item, tuple) and item[0] == "warmup":
                            try:
                                self._do_warmup()
                            finally:
                                item[1].set()
                                self.q.task_done()
                            continue
                        got.append(item)
                if not got and not live:
                    if self._closed_and_idle():
                        return
                    continue
                # Requests that expired while queued: fail them now.
                if got:
                    now = time.monotonic()
                    still = []
                    for req in got:
                        if req.expired(now):
                            req.fail("deadline exceeded while queued",
                                     kind="deadline")
                            self.q.task_done()
                        else:
                            still.append(req)
                    got = still
                # ---- admit ---------------------------------------------
                if got:
                    if pool is None:
                        pool = srv.make_pool_cache(self.rows)
                        if srv.spec_k is not None:
                            d_pool = srv.draft_cache(pool)
                    la0 = self.ledgers.now()
                    with obs_trace.span("serve.engine.admit",
                                        parent=_rep_ctx(got),
                                        journal=False, rows=len(got)):
                        pool, d_pool = self._admit(
                            pool, d_pool, got, free, live, rowlen
                        )
                    self.flight.record(
                        "prefill", rows=len(got),
                        queue_depth=self.q.unfinished_tasks,
                        wall_ms=round(
                            (self.ledgers.now() - la0) * 1e3, 3
                        ),
                    )
                # ---- decode one segment --------------------------------
                if live:
                    # Chaos hook: device failure between segments.
                    faults.inject("serve.decode_step", mode="continuous",
                                  rows=len(live))
                    pool, d_pool = self._decode(pool, d_pool, rowlen, live,
                                                free)
            except Exception as e:  # tpulint: disable=TPU001 — engine-thread boundary: the lone decode thread must survive any iteration failure
                # Device state is suspect: fail everything in flight and
                # start from a fresh pool.
                log.exception("engine iteration failed")
                pending = {
                    id(r): r for r in list(live.values()) + got
                    if not r.done.is_set()
                }
                for req in pending.values():
                    req.fail(str(e))
                    self.q.task_done()
                _g_queue_depth().set(self.q.unfinished_tasks)
                live.clear()
                free = list(range(self.rows))
                pool = None
                d_pool = None
                rowlen[:] = 1

    def _loop_paged(self):
        """Paged-engine thread: admit -> one prefill chunk -> one decode
        segment, forever.

        Interleaving chunks between segments is the chunked-prefill
        guarantee: a long prompt costs each in-flight decoder at most one
        chunk's forward per segment instead of freezing every row for the
        whole prompt. All page accounting (free list, refcounts, prefix
        index, block tables) is engine-thread-only, so it needs no locks
        and stays two-run deterministic."""
        eng = None
        while True:
            got = []
            try:
                if eng is None:
                    eng = _PagedEngine(self)
                # Resolved handoff leases (acked or expired) release
                # their page refs here, every tick — engine-thread-only,
                # so PagePool never crosses a thread.
                eng.reap_handoff()
                # ---- collect ---------------------------------------
                if eng.free:
                    cap = len(eng.free)
                    block = not eng.live and not eng.filling
                    while len(got) < cap:
                        try:
                            item = self.q.get(timeout=0.2) if block \
                                else self.q.get_nowait()
                        except queue.Empty:
                            break
                        block = False
                        if isinstance(item, tuple) and item[0] == "warmup":
                            try:
                                eng.warmup()
                            finally:
                                item[1].set()
                                self.q.task_done()
                            continue
                        got.append(item)
                if not got and not eng.live and not eng.filling:
                    if self._closed_and_idle():
                        return
                    continue
                now = time.monotonic()
                still = []
                for item in got:
                    # ("handoff", req, bundle) tuples are decode-role
                    # imports riding the control lane.
                    req = item[1] if isinstance(item, tuple) else item
                    if req.expired(now):
                        req.fail("deadline exceeded while queued",
                                 kind="deadline")
                        self.q.task_done()
                    else:
                        still.append(item)
                got = still
                # ---- admit (prefix match -> filling state) ---------
                for item in got:
                    if isinstance(item, tuple):
                        eng.admit_handoff(item[1], item[2])
                    else:
                        eng.admit(item)
                got = []
                # ---- one prefill chunk, then one decode segment ----
                if eng.filling:
                    # Chaos hook: device failure mid-chunk (the except
                    # arm below fails in-flight work and rebuilds the
                    # pool + page bookkeeping from scratch).
                    faults.inject("serve.decode_step",
                                  mode="paged_prefill",
                                  rows=len(eng.filling))
                    nfill = len(eng.filling)
                    lp0 = self.ledgers.now()
                    with obs_trace.span(
                        "serve.engine.prefill_chunk",
                        parent=_rep_ctx(
                            [st["req"] for st in eng.filling.values()]
                        ),
                        journal=False, rows=len(eng.filling),
                    ):
                        eng.prefill_chunk_step(self._next_key())
                    self.flight.record(
                        "prefill_chunk", rows=nfill,
                        pages_free=eng.pagepool.free_pages,
                        queue_depth=self.q.unfinished_tasks,
                        wall_ms=round(
                            (self.ledgers.now() - lp0) * 1e3, 3
                        ),
                    )
                if eng.live:
                    faults.inject("serve.decode_step", mode="paged",
                                  rows=len(eng.live))
                    # All-greedy iterations ride the paged spec loop
                    # when a draft is enabled; any sampled or
                    # logprob-wanting row (or a row whose verify block
                    # could clamp past capacity) switches the iteration
                    # to the plain paged segment.
                    spec_now = eng.spec_ready()
                    span_attrs = {"rows": len(eng.live)}
                    if spec_now:
                        span_attrs["kind"] = "spec"
                    nlive = len(eng.live)
                    slo_rows: dict = {}
                    for rq in eng.live.values():
                        slo_rows[rq.slo] = slo_rows.get(rq.slo, 0) + 1
                    ld0 = self.ledgers.now()
                    with obs_trace.span(
                        "serve.engine.decode_segment",
                        parent=_rep_ctx(list(eng.live.values())),
                        journal=False, **span_attrs,
                    ):
                        if spec_now:
                            eng.spec_segment_step()
                        else:
                            eng.decode_segment_step(self._next_key())
                    self.flight.record(
                        "spec" if spec_now else "decode_segment",
                        rows=nlive, slo_rows=slo_rows,
                        pages_used=(eng.cfg.pool_pages
                                    - eng.pagepool.free_pages),
                        pages_free=eng.pagepool.free_pages,
                        queue_depth=self.q.unfinished_tasks,
                        wall_ms=round(
                            (self.ledgers.now() - ld0) * 1e3, 3
                        ),
                    )
            except Exception as e:  # tpulint: disable=TPU001 — engine-thread boundary: the lone decode thread must survive any iteration failure
                # Device state is suspect: fail everything in flight,
                # drop every page, restart from a fresh pool and an
                # empty prefix index.
                log.exception("paged engine iteration failed")
                pending = [it[1] if isinstance(it, tuple) else it
                           for it in got]
                if eng is not None:
                    pending += list(eng.live.values())
                    pending += [st["req"] for st in eng.filling.values()]
                for req in {id(r): r for r in pending
                            if not r.done.is_set()}.values():
                    req.fail(str(e))
                    self.q.task_done()
                _g_queue_depth().set(self.q.unfinished_tasks)
                eng = None
                if self.server.closed:
                    # The serving ranks fell out of step or stopped
                    # (parallel/serve_ranks.py): no pool can be rebuilt.
                    self._fail_queued(str(e))
                    return

    def _decode(self, pool, d_pool, rowlen, live, free):
        """One decode segment over the pool (speculative when every live
        row is greedy and a draft is enabled); retire finished rows.
        Returns (pool, d_pool); advances ``rowlen`` in place."""
        srv = self.server
        seg_start = time.perf_counter()
        lt0 = self.ledgers.now()
        n_live = len(live)
        slo_rows: dict = {}
        for rq in live.values():
            slo_rows[rq.slo] = slo_rows.get(rq.slo, 0) + 1
        _h_occupancy().observe(len(live) / self.rows, mode="continuous")
        self._observe_slo_occupancy(live)
        tok = np.zeros((self.rows, 1), np.int64)
        temp = np.zeros((self.rows,), np.float32)
        topk = np.zeros((self.rows,), np.int64)
        for r, req in live.items():
            tok[r, 0] = req.last
            temp[r] = req.temp
            topk[r] = req.topk
        # All-greedy pools ride the speculative verify loop when a draft
        # is enabled; any sampled or logprob-wanting row switches the
        # iteration to the plain segment. A plain iteration leaves the
        # draft pool stale — harmless: the verify loop only ever emits
        # the target's own argmax, so staleness costs acceptance, never
        # tokens.
        seq_cap = srv.config.max_seq_len
        spec_now = (
            srv.spec_k is not None and d_pool is not None
            and all(rq.temp <= 0 and rq.topk <= 0 and not rq.want_lp
                    for rq in live.values())
            # capacity edge (the static path's rule): the k-wide verify
            # block must never clamp-write past the cache, so rows
            # nearing the end take plain segments for their last stretch
            and all(int(rowlen[r]) + min(rq.budget, self.segment)
                    <= seq_cap - srv.spec_k for r, rq in live.items())
        )
        span_attrs = {"rows": len(live)}
        if spec_now:
            span_attrs["kind"] = "spec"
        with obs_trace.span(
            "serve.engine.decode_segment",
            parent=_rep_ctx(live.values()), journal=False, **span_attrs,
        ):
            if spec_now:
                budgets = np.zeros((self.rows,), np.int64)
                for r, req in live.items():
                    budgets[r] = min(req.budget, self.segment)
                pool, d_pool, out = srv.spec_segment(
                    pool, d_pool, tok, rowlen, budgets, self.segment,
                )
                # [rows, segment] -> [segment, rows]: rows with shorter
                # budgets leave zeros beyond them, which the per-row
                # budget cut below never reads.
                toks_host = out.cpu().numpy().T
                np.minimum(rowlen + budgets, seq_cap, out=rowlen)
                lps_host = None  # spec pools never want logprobs
            else:
                pool, toks, seg_lps = srv.decode_segment(
                    pool, tok, self._next_key(), temp, topk, self.segment,
                )
                toks_host = toks.cpu().numpy()  # [segment, rows]
                # the plain segment advances every row by `segment`
                np.minimum(rowlen + self.segment, seq_cap, out=rowlen)
                # logprob transfer only when someone will read it
                lps_host = (
                    seg_lps.cpu().numpy()
                    if any(rq.want_lp for rq in live.values()) else None
                )
        # Segment wall time over its step count: the per-token decode
        # latency --segment-tokens is tuned against.
        _h_decode_step().observe(
            (time.perf_counter() - seg_start) / self.segment,
            path="continuous",
        )
        lt1 = self.ledgers.now()
        kind = "spec" if spec_now else "plain"
        self.flight.record(
            "spec" if spec_now else "decode_segment", rows=n_live,
            slo_rows=slo_rows, queue_depth=self.q.unfinished_tasks,
            wall_ms=round(max(0.0, lt1 - lt0) * 1e3, 3),
        )
        for r in list(live):
            req = live[r]
            seg, seg_lp = [], []
            for i, t in enumerate(toks_host[:, r]):
                t = int(t)
                if srv.eos_id is not None and t == srv.eos_id:
                    req.budget = 0
                    req.slot["finish_reason"] = "stop"
                    break
                seg.append(t)
                if lps_host is not None:
                    seg_lp.append(float(lps_host[i, r]))
                req.budget -= 1
                if req.budget <= 0:
                    break
            req.ledger.decode_segment(lt0, lt1, tokens=len(seg),
                                      kind=kind)
            if seg:
                accepted = req.asm.push(seg)
                req.lps.extend(seg_lp[:accepted])
                req.last = seg[-1]
            if req.asm.finished:  # stop sequence completed
                req.budget = 0
            if req.budget <= 0:
                self._finish(req)
                del live[r]
                free.append(r)
            elif req.expired():
                # The row frees now instead of decoding the remaining
                # budget for a gone client.
                self._fail_request(
                    req, "deadline exceeded while decoding",
                    kind="deadline",
                )
                del live[r]
                free.append(r)
            else:
                self._emit(req)
        return pool, d_pool

    def _do_warmup(self):
        srv = self.server
        spec = srv.spec_k is not None
        pool = srv.make_pool_cache(self.rows)
        d_pool = srv.draft_cache(pool) if spec else None
        rows = 1
        while rows <= self.rows:
            lb = srv._prefill_bucket(1)
            seen = set()
            while lb not in seen:
                seen.add(lb)
                # lb-long prompts so this length bucket's prefill runs
                cache, _, _ = srv.prefill_rows(
                    [[0] * lb] * rows, [lb] * rows, [0.0] * rows,
                    [0] * rows, self._next_key(),
                )
                lb = srv._bucket(lb + 1, 128, srv.config.max_seq_len)
            if spec:  # the draft rows' insert runs per row bucket too
                d_pool = srv.insert_rows(
                    d_pool, srv.draft_cache(cache),
                    list(range(rows)),
                )
            pool = srv.insert_rows(pool, cache, list(range(rows)))
            rows *= 2
        if self._auto:
            pool = self._tune_segment(pool)
        pool, _, _ = srv.decode_segment(
            pool, np.zeros((self.rows, 1), np.int64), self._next_key(),
            np.zeros((self.rows,), np.float32),
            np.zeros((self.rows,), np.int64), self.segment,
        )
        if spec:
            srv.spec_segment(
                pool, d_pool, np.zeros((self.rows, 1), np.int64),
                np.ones((self.rows,), np.int64),
                np.ones((self.rows,), np.int64), self.segment,
            )
            # warmup decodes must not pollute acceptance telemetry
            srv.reset_spec_stats()

    def _tune_segment(self, pool):
        """Measure dispatch overhead vs per-token cost; pick the
        shortest power-of-two segment keeping dispatch under ~10%.

        A segment costs D + s*tau (D = per-dispatch overhead, tau =
        per-token time); D/(D + s*tau) <= 0.1 gives s >= 9*D/tau, clamped
        to [4, 64]."""
        srv = self.server

        def timed(segment, reps=3):
            nonlocal pool
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                pool, toks, _ = srv.decode_segment(
                    pool, np.zeros((self.rows, 1), np.int64),
                    self._next_key(),
                    np.zeros((self.rows,), np.float32),
                    np.zeros((self.rows,), np.int64), segment,
                )
                toks.cpu()  # waits for the device
                best = min(best, time.perf_counter() - t0)
            return best

        timed(1, reps=1)   # first calls outside the clock
        timed(16, reps=1)
        t1, t16 = timed(1), timed(16)
        tau = max((t16 - t1) / 15.0, 1e-6)
        dispatch = max(t1 - tau, 0.0)
        want = 9.0 * dispatch / tau
        seg = 4
        while seg < 64 and seg < want:
            seg *= 2
        self.segment = seg
        log.info(
            "segment auto-tune: dispatch=%.1fms token=%.2fms -> "
            "segment=%d", dispatch * 1e3, tau * 1e3, seg,
        )
        return pool

    def _admit(self, pool, d_pool, got, free, live, rowlen):
        """Prefill ``got`` into free pool rows; returns (pool, d_pool)
        and sets the rows' ``rowlen``."""
        srv = self.server
        seq = srv.config.max_seq_len
        bucket_rows = srv._bucket(len(got), 1, None)
        windows, lens, temps, topks = [], [], [], []
        for req in got:
            keep = max(1, seq - req.budget)
            w = req.prompt[-keep:] or [0]
            windows.append(w)
            lens.append(len(w))
            req.budget = min(req.budget, seq - len(w))
            temps.append(req.temp)
            topks.append(req.topk)
        while len(windows) < bucket_rows:
            windows.append([0])
            lens.append(1)
            temps.append(0.0)
            topks.append(0)
        lt0 = self.ledgers.now()
        cache, first, first_lp = srv.prefill_rows(
            windows, lens, temps, topks, self._next_key()
        )
        # Padding slots scatter into real free rows too (they must not
        # collide with live rows); those rows stay un-live and their
        # garbage is overwritten by the next admission that claims them.
        row_ids = [free.pop(0) for _ in range(bucket_rows)]
        if d_pool is not None:
            # the self-draft's prefill rows ARE the target's first layers
            # (the same K/V, no second forward)
            d_pool = srv.insert_rows(d_pool, srv.draft_cache(cache),
                                     row_ids)
        for i, r in enumerate(row_ids):
            rowlen[r] = lens[i]
        pool = srv.insert_rows(pool, cache, row_ids)
        now = time.perf_counter()
        lt1 = self.ledgers.now()
        for i, req in enumerate(got):
            t = int(first[i])
            req.ledger.prefill_chunk(lt0, lt1)
            req.ledger.first_token(lt1)
            req.slot["ttft"] = now - req.arrival
            # TTFT lands when the first token exists — once per request.
            _h_ttft().observe(req.slot["ttft"], path="continuous")
            hit_eos = srv.eos_id is not None and t == srv.eos_id
            if hit_eos:
                req.slot["finish_reason"] = "stop"
            else:
                req.asm.push([t])
                if req.want_lp:
                    req.lps.append(float(first_lp[i]))
                req.last = t
                req.budget -= 1
                if req.asm.finished:  # single-token stop sequence
                    req.budget = 0
            if hit_eos or req.budget <= 0:
                self._finish(req)
                free.append(row_ids[i])
            else:
                self._emit(req)
                live[row_ids[i]] = req
        for i in range(len(got), bucket_rows):  # padding rows: free again
            free.append(row_ids[i])
        return pool, d_pool

    def _observe_slo_occupancy(self, live) -> None:
        """Per-class pool occupancy at each decode dispatch."""
        counts = dict.fromkeys(SLO_CLASSES, 0)
        for req in live.values():
            counts[req.slo] += 1
        h = _h_slo_occupancy()
        for cls, n in counts.items():
            h.observe(n / self.rows, slo=cls)

    def _emit(self, req: _Request):
        """Stream the newly-safe delta at a segment boundary."""
        if req.stream_q is not None:
            delta = req.asm.take_delta()
            if delta:
                req.stream_q.put(delta)

    def _finish(self, req: _Request):
        req.slot["tokens"] = req.prompt + req.asm.tokens
        req.slot["text"] = req.asm.text()
        # stop truncation may retract tokens; logprobs track the kept set
        req.slot["logprobs"] = req.lps[:len(req.asm.tokens)]
        req.slot.setdefault(
            "finish_reason", "stop" if req.asm.finished else "length"
        )
        req.slot.setdefault("ttft", time.perf_counter() - req.arrival)
        if req.stream_q is not None:
            req.asm.finished = True  # no more tokens: release holdback
            delta = req.asm.take_delta()
            if delta:
                req.stream_q.put(delta)
            req.stream_q.put(None)
        req.finish_ok()
        self.q.task_done()
        _g_queue_depth().set(self.q.unfinished_tasks)


class _PoolExhausted(RuntimeError):
    """No free pages, nothing evictable, no lower-class victim."""


def _c_page_copies():
    return obs_metrics.counter(
        "tpu_serve_kv_page_copies_total",
        "copy-on-extend page copies (a shared or index-published page "
        "duplicated before a row writes into it)",
    )


class _PagedEngine:
    """Engine-thread state for the paged ContinuousBatcher mode.

    Owns the device page pool plus all host bookkeeping: the physical
    free list/refcounts (``PagePool``), the prefix trie
    (``PrefixIndex``), per-row block tables and ownership sets, and the
    request states (``filling`` = mid-chunked-prefill, ``live`` =
    decoding). Everything is touched only by the engine thread —
    deterministic and lock-free by construction.

    Invariants the correctness tests pin:

    - a row only ever *writes* pages in its ``owned`` set; shared
      (refcount > 1) and index-published pages are read-only and get
      copied before the first write (copy-on-extend);
    - shared prefix pages hold positions strictly below the sharer's
      ``row_len``, so decode/prefill writes (always at ``>= row_len``)
      can never land in them;
    - pages are provisioned for every position a device call will
      touch *before* the call, so the write clamp never fires for
      resident rows.
    """

    def __init__(self, batcher: "ContinuousBatcher"):
        self.b = batcher
        self.srv = batcher.server
        self.cfg = batcher.kv_config
        self.pagepool = PagePool(self.cfg)
        self.index = PrefixIndex(self.pagepool)
        self.pool = self.srv.make_paged_pool(
            self.cfg.pool_pages, self.cfg.page_tokens
        )
        rows = batcher.rows
        self.tables: list[list[int]] = [[] for _ in range(rows)]
        self.owned: list[set] = [set() for _ in range(rows)]
        self.row_len = np.zeros((rows,), np.int64)
        self.live: dict[int, _Request] = {}
        self.filling: dict[int, dict] = {}
        self.free = list(range(rows))
        self.pending_copies: list[tuple] = []

    # ---- row lifecycle ------------------------------------------------

    def _drop_row(self, r: int) -> None:
        """Release a row's page references and return it to the free
        list (the request already finished or failed)."""
        self.pagepool.release(self.tables[r])
        self.tables[r] = []
        self.owned[r] = set()
        self.row_len[r] = 0
        self.live.pop(r, None)
        self.filling.pop(r, None)
        self.free.append(r)

    def _fail_row(self, r: int, req: _Request, msg: str,
                  kind: str = "error") -> None:
        req.fail(msg, kind=kind)
        self.b.q.task_done()
        _g_queue_depth().set(self.b.q.unfinished_tasks)
        self._drop_row(r)

    def _shed_row(self, r: int, req: _Request, msg: str) -> None:
        """Page-pressure shed: the one seam every scheduling step routes
        _PoolExhausted through (one instrumentation site, one terminal
        ledger state)."""
        _c_shed().inc(reason="pages")
        self._fail_row(r, req, msg, kind="shed")

    # ---- page accounting ---------------------------------------------

    def _alloc(self, n: int, rank: int,
               led=obs_ledger.NOOP) -> list:
        """Allocate ``n`` pages, reclaiming under pressure: cached
        prefixes evict LRU-first, then live strictly-lower-class
        requests are preempted (batch-class victims first). Raises
        :class:`_PoolExhausted` when neither can free enough.

        The fast path (free list has room) stays ledger-silent; only
        the reclaim path charges page-wait time to ``led``."""
        ids = self.pagepool.alloc(n)
        if ids is not None:
            return ids
        t0 = self.b.ledgers.now()
        try:
            while True:
                ids = self.pagepool.alloc(n)
                if ids is not None:
                    return ids
                if self.index.evict(n - self.pagepool.free_pages) > 0:
                    continue
                victim = self._pick_victim(rank)
                if victim is None:
                    raise _PoolExhausted(f"{n} pages unavailable")
                self._preempt(*victim)
        finally:
            led.page_wait(max(0.0, self.b.ledgers.now() - t0))

    def _pick_victim(self, rank: int):
        """Worst-class (then newest) resident request strictly below
        ``rank``'s class, or None."""
        best = None
        residents = list(self.live.items()) + [
            (r, st["req"]) for r, st in self.filling.items()
        ]
        for r, req in residents:
            if req.slo_rank > rank and (
                best is None
                or (req.slo_rank, req.arrival)
                > (best[1].slo_rank, best[1].arrival)
            ):
                best = (r, req)
        return best

    def _preempt(self, r: int, req: _Request) -> None:
        from k8s_device_plugin_tpu_torch.models import kv_cache

        kv_cache._c_evictions().inc(kind="preempt")
        _c_preempted().inc(resource="pages")
        req.ledger.preempted()
        self._fail_row(
            r, req,
            f"preempted: KV pages reclaimed for a higher SLO class "
            f"(request class {req.slo})", kind="shed",
        )

    def _ensure(self, r: int, upto: int, rank: int,
                led=obs_ledger.NOOP) -> None:
        """Provision row ``r``'s block table through token position
        ``upto`` and make its next write page privately owned."""
        cfg = self.cfg
        tbl = self.tables[r]
        want = min(cfg.pages_for(upto), cfg.max_pages_per_row)
        need = want - len(tbl)
        if need > 0:
            ids = self._alloc(need, rank, led=led)
            tbl.extend(ids)
            self.owned[r].update(ids)
        # Copy-on-extend: the page holding the next write position may
        # be a shared prefix tail or an index-published page — copy it
        # to a fresh page before any write can corrupt a sibling's (or
        # the index's) K/V.
        pi = int(self.row_len[r]) // cfg.page_tokens
        if (pi < len(tbl) and tbl[pi] != PagePool.SCRATCH
                and tbl[pi] not in self.owned[r]):
            fresh = self._alloc(1, rank, led=led)[0]
            self.pending_copies.append((tbl[pi], fresh))
            _c_page_copies().inc()
            led.page_copy()
            self.pagepool.release([tbl[pi]])
            tbl[pi] = fresh
            self.owned[r].add(fresh)

    def _flush_copies(self) -> None:
        if not self.pending_copies:
            return
        src = [s for s, _ in self.pending_copies]
        dst = [d for _, d in self.pending_copies]
        self.pending_copies = []
        self.pool = self.srv.copy_pages(self.pool, src, dst)

    # ---- scheduling steps --------------------------------------------

    def admit(self, req: _Request) -> None:
        """Prefix-match the prompt and enter the filling state (the
        chunk step does the actual prefill work)."""
        seq = self.srv.config.max_seq_len
        keep = max(1, seq - req.budget)
        w = req.prompt[-keep:] or [0]
        req.budget = min(req.budget, seq - len(w))
        # Reuse every indexed page of the prompt except the very last
        # position — its logits are what the first token samples from.
        pages, matched = self.index.match(w, max_tokens=len(w) - 1)
        self.pagepool.ref(pages)
        r = self.free.pop(0)
        self.tables[r] = list(pages)
        self.owned[r] = set()
        self.row_len[r] = matched
        self.filling[r] = {"req": req, "window": w, "done": matched}

    def prefill_chunk_step(self, key) -> None:
        """One chunked-prefill device call over every filling row.

        Long prompts advance one chunk per engine iteration, so
        co-resident decoders stall at most one chunk's forward per
        segment — never a whole prompt's."""
        b, srv = self.b, self.srv
        P = self.cfg.page_tokens
        for r in sorted(self.filling):
            st = self.filling.get(r)
            if st is None:  # preempted by an earlier row's allocation
                continue
            req = st["req"]
            if req.expired():
                self._fail_row(r, req,
                               "deadline exceeded while prefilling",
                               kind="deadline")
                continue
            chunk = min(b.chunk, len(st["window"]) - st["done"])
            try:
                self._ensure(r, st["done"] + chunk, req.slo_rank,
                             led=req.ledger)
            except _PoolExhausted:
                self._shed_row(r, req, "KV page pool exhausted")
        if not self.filling:
            return
        self._flush_copies()
        lt0 = b.ledgers.now()
        rows = b.rows
        parts = sorted(self.filling)
        maxchunk = max(
            min(b.chunk, len(self.filling[r]["window"])
                - self.filling[r]["done"])
            for r in parts
        )
        C = srv._bucket(maxchunk, 8, cap=b.chunk)
        W = srv.page_bucket(
            max(len(self.tables[r]) for r in parts),
            self.cfg.max_pages_per_row,
        )
        toks = np.zeros((rows, C), np.int64)
        lens = np.zeros((rows,), np.int64)
        last_idx = np.zeros((rows,), np.int64)
        temps = np.zeros((rows,), np.float32)
        topks = np.zeros((rows,), np.int64)
        bt = np.zeros((rows, W), np.int64)  # scratch-page fill
        finishing = []
        for r in parts:
            st = self.filling[r]
            req, done = st["req"], st["done"]
            chunk = min(b.chunk, len(st["window"]) - done)
            toks[r, :chunk] = st["window"][done:done + chunk]
            lens[r] = done
            tbl = self.tables[r]
            bt[r, :len(tbl)] = tbl
            if done + chunk == len(st["window"]):
                finishing.append(r)
                last_idx[r] = chunk - 1
                temps[r] = req.temp
                topks[r] = req.topk
            st["next_done"] = done + chunk
        self.pool, first, first_lp = srv.paged_prefill_chunk(
            self.pool, toks, bt, lens, last_idx, key, temps, topks
        )
        lt1 = b.ledgers.now()
        for r in parts:
            st = self.filling.get(r)
            if st is not None:
                st["done"] = st.pop("next_done")
                self.row_len[r] = st["done"]
                st["req"].ledger.prefill_chunk(lt0, lt1)
        now = time.perf_counter()
        for r in finishing:
            st = self.filling.pop(r, None)
            if st is None:
                continue
            req, w = st["req"], st["window"]
            # Publish the prompt's pages for future prefix hits. The
            # partial tail page becomes index-owned (read-only): this
            # row's first decode write into it copy-on-extends.
            n_pages = self.cfg.pages_for(len(w))
            self.index.insert(w, self.tables[r][:n_pages])
            if len(w) % P:
                self.owned[r].discard(self.tables[r][n_pages - 1])
            t = int(first[r])
            if req.export:
                # Handoff prefill: this row's product is the page-block
                # bundle, not a decode — export and finish.
                self._export_row(r, req, w, t, float(first_lp[r]),
                                 now, lt1)
                continue
            req.slot["ttft"] = now - req.arrival
            req.ledger.first_token(lt1)
            # TTFT lands when the first token exists — once per request.
            _h_ttft().observe(req.slot["ttft"], path="paged")
            hit_eos = srv.eos_id is not None and t == srv.eos_id
            if hit_eos:
                req.slot["finish_reason"] = "stop"
            else:
                req.asm.push([t])
                if req.want_lp:
                    req.lps.append(float(first_lp[r]))
                req.last = t
                req.budget -= 1
                if req.asm.finished:  # single-token stop sequence
                    req.budget = 0
            if hit_eos or req.budget <= 0:
                b._finish(req)
                self._drop_row(r)
            else:
                b._emit(req)
                self.live[r] = req

    def decode_segment_step(self, key) -> None:
        """One fixed-length paged decode segment over the live rows."""
        self._segment_step(key, spec=False)

    def spec_ready(self) -> bool:
        """Whether this iteration's decode can ride the paged spec loop:
        a draft is enabled, every live row is greedy and wants no
        logprobs, and no row's verify block could clamp-write past its
        capacity — rows nearing max_seq_len take plain segments for the
        final stretch (the rows engine's capacity-edge rule)."""
        srv = self.srv
        if srv.spec_k is None or not self.live:
            return False
        seq, seg = srv.config.max_seq_len, self.b.segment
        for r, req in self.live.items():
            if req.temp > 0 or req.topk > 0 or req.want_lp:
                return False
            if self.cfg.verify_span(
                int(self.row_len[r]) + min(req.budget, seg), srv.spec_k
            ) > seq:
                return False
        return True

    def spec_segment_step(self) -> None:
        """One speculative segment over the live rows (all greedy;
        :meth:`spec_ready` holds).

        Pages are provisioned through ``KVPageConfig.verify_span``: the
        k-wide verify block is written before acceptance is known, so a
        row needs pages through ``row_len + budget + k`` — the overshoot
        may straddle a page boundary the accepted tokens never reach.
        Row lengths then advance by each row's emitted count only (the
        loop's exit lengths match by contract), which IS the speculative
        rewind in this layout."""
        self._segment_step(None, spec=True)

    def _segment_step(self, key, spec: bool) -> None:
        """The plain or speculative segment step: provision each live
        row's pages, run the segment, advance the row lengths, consume
        the tokens."""
        b, srv = self.b, self.srv
        seg = b.segment
        for r in sorted(self.live):
            req = self.live.get(r)
            if req is None:  # preempted by an earlier row's allocation
                continue
            upto = int(self.row_len[r]) + seg
            if spec:
                upto = self.cfg.verify_span(
                    int(self.row_len[r]) + min(req.budget, seg), srv.spec_k)
            try:
                self._ensure(r, upto, req.slo_rank, led=req.ledger)
            except _PoolExhausted:
                self._shed_row(r, req,
                               "KV page pool exhausted mid-decode")
        if not self.live:
            return
        self._flush_copies()
        seg_start = time.perf_counter()
        lt0 = b.ledgers.now()
        _h_occupancy().observe(len(self.live) / b.rows, mode="continuous")
        b._observe_slo_occupancy(self.live)
        rows = b.rows
        W = srv.page_bucket(
            max(len(self.tables[r]) for r in self.live),
            self.cfg.max_pages_per_row,
        )
        tok = np.zeros((rows, 1), np.int64)
        temp = np.zeros((rows,), np.float32)
        topk = np.zeros((rows,), np.int64)
        lens = np.zeros((rows,), np.int64)
        budgets = np.zeros((rows,), np.int64)
        bt = np.zeros((rows, W), np.int64)  # non-live rows: all scratch
        for r, req in self.live.items():
            tok[r, 0] = req.last
            temp[r] = req.temp
            topk[r] = req.topk
            lens[r] = self.row_len[r]
            budgets[r] = min(req.budget, seg) if spec else seg
            tbl = self.tables[r]
            bt[r, :len(tbl)] = tbl
        if spec:
            self.pool, out = srv.paged_spec_segment(
                self.pool, bt, tok, lens, budgets, seg
            )
            # [rows, segment] -> [segment, rows]: rows with shorter
            # budgets leave zeros beyond them, never read by the
            # budget-bounded consumption below.
            toks_host, lps_host = out.cpu().numpy().T, None
        else:
            self.pool, toks, lps = srv.paged_decode_segment(
                self.pool, bt, tok, lens, key, temp, topk, seg
            )
            toks_host = toks.cpu().numpy()  # [segment, rows]
            lps_host = (
                lps.cpu().numpy()
                if any(rq.want_lp for rq in self.live.values()) else None
            )
        _h_decode_step().observe(
            (time.perf_counter() - seg_start) / seg, path="continuous"
        )
        lt1 = b.ledgers.now()
        # the plain segment advances every row by `segment`, the spec
        # loop by each row's budget
        for r in self.live:
            self.row_len[r] = min(
                int(self.row_len[r]) + int(budgets[r]),
                srv.config.max_seq_len,
            )
        self._consume_segment(toks_host, lps_host, lt0, lt1,
                              "spec" if spec else "plain")

    def _consume_segment(self, toks_host, lps_host,
                         lt0: float = 0.0, lt1: float = 0.0,
                         kind: str = "plain") -> None:
        """Host-side per-row consumption of one segment's tokens, shared
        by the plain and speculative steps: EOS stop, budget countdown,
        stop-sequence assembly, finish / expire / emit. ``lt0``/``lt1``
        bound the segment's service interval on the ledger clock; each
        row's ledger is stamped once per segment."""
        b, srv = self.b, self.srv
        for r in list(self.live):
            req = self.live[r]
            seg_toks, seg_lp = [], []
            for i, t in enumerate(toks_host[:, r]):
                t = int(t)
                if srv.eos_id is not None and t == srv.eos_id:
                    req.budget = 0
                    req.slot["finish_reason"] = "stop"
                    break
                seg_toks.append(t)
                if lps_host is not None:
                    seg_lp.append(float(lps_host[i, r]))
                req.budget -= 1
                if req.budget <= 0:
                    break
            req.ledger.decode_segment(lt0, lt1, tokens=len(seg_toks),
                                      kind=kind)
            if seg_toks:
                accepted = req.asm.push(seg_toks)
                req.lps.extend(seg_lp[:accepted])
                req.last = seg_toks[-1]
            if req.asm.finished:  # stop sequence completed
                req.budget = 0
            if req.budget <= 0:
                b._finish(req)
                self._drop_row(r)
            elif req.expired():
                self._fail_row(r, req,
                               "deadline exceeded while decoding",
                               kind="deadline")
            else:
                b._emit(req)

    # ---- disaggregated handoff ---------------------------------------

    def _export_row(self, r: int, req: _Request, w, t: int, lp: float,
                    now: float, lt1: float) -> None:
        """Prefill role: gather the finished row's pages to host, lease
        them, and finish the request with the bundle.

        The lease takes its OWN page references before the row drops
        its table — the block stays resident until the decode ack (or
        lease expiry) releases it on a later reap tick, so a decode
        crash mid-import never leaves this side holding freed pages."""
        b, srv = self.b, self.srv
        tbl = list(self.tables[r])
        payload = srv.export_pages(self.pool, tbl)
        self.pagepool.ref(tbl)
        lease_id = b.leases.export(tbl)
        bundle = kv_handoff.PageBlockBundle.from_pool_payload(
            payload,
            lease_id=lease_id, lease_s=b.leases.lease_s, window=w,
            first_token=t, first_lp=lp, budget=req.budget,
            temp=req.temp, topk=req.topk, want_lp=req.want_lp,
            slo=req.slo, page_tokens=self.cfg.page_tokens,
            traceparent=(obs_trace.format_traceparent(req.ctx)
                         if req.ctx is not None else None),
        )
        req.slot["bundle"] = bundle
        req.slot["lease_id"] = lease_id
        req.slot["tokens"] = list(w) + [t]
        req.slot["ttft"] = now - req.arrival
        req.ledger.first_token(lt1)
        kv_handoff._c_handoffs().inc(role="prefill", outcome="export")
        req.finish_ok()
        b.q.task_done()
        _g_queue_depth().set(b.q.unfinished_tasks)
        self._drop_row(r)

    def admit_handoff(self, req: _Request, bundle) -> None:
        """Decode role: import a handed-off page block and enter the
        live (decoding) state directly — no local prefill.

        The first-token consumption below mirrors the prefill finish
        arm statement for statement, and the bundle carries the
        post-clamp pre-first-token budget, so the pair's tokens and
        logprobs equal the single-process engine's. Any failure BEFORE
        host-state mutation (stale lease, incompatible geometry,
        allocation pressure, import fault) falls back to a local
        re-prefill or a clean shed — the request still holds its
        original prompt, so nothing is lost."""
        b, srv, cfg = self.b, self.srv, self.cfg
        w = list(bundle.window)
        n_pages = cfg.pages_for(len(w))
        compatible = (
            bundle.page_tokens == cfg.page_tokens
            and bundle.num_layers == srv.config.num_layers
            and bundle.num_pages == n_pages
        )
        if not compatible or bundle.expired():
            outcome = "stale" if compatible else "incompatible"
            if compatible:
                # The lease lapsed before import: the prefill copy is
                # already reclaimed over there, and the bundle here is
                # dead weight — orphaned on this side too.
                kv_handoff._c_orphans().inc(side="decode")
            kv_handoff._c_handoffs().inc(role="decode", outcome=outcome)
            log.warning("handoff bundle %s %s; re-prefilling locally",
                        bundle.lease_id, outcome)
            self.admit(req)
            return
        t = bundle.first_token
        now = time.perf_counter()
        lt1 = b.ledgers.now()
        hit_eos = srv.eos_id is not None and t == srv.eos_id
        if hit_eos or bundle.budget <= 1:
            # The first token already ends the request — finish without
            # touching the pool, ack so the peer releases promptly.
            req.budget = bundle.budget
            req.slot["ttft"] = now - req.arrival
            req.ledger.first_token(lt1)
            _h_ttft().observe(req.slot["ttft"], path="paged")
            if hit_eos:
                req.slot["finish_reason"] = "stop"
            else:
                req.asm.push([t])
                if req.want_lp:
                    req.lps.append(bundle.first_lp)
                req.last = t
                req.budget -= 1
            b._finish(req)
            self._ack(bundle.lease_id)
            kv_handoff._c_handoffs().inc(role="decode",
                                         outcome="imported")
            return
        r = self.free.pop(0)
        try:
            ids = self._alloc(n_pages, req.slo_rank, led=req.ledger)
        except _PoolExhausted:
            self._shed_row(r, req,
                           "KV page pool exhausted at handoff import")
            # The request is dead either way — release the peer's copy
            # now instead of making it wait out the lease.
            self._ack(bundle.lease_id)
            return
        try:
            faults.inject("handoff.import", lease=bundle.lease_id,
                          pages=n_pages)
            with obs_trace.span(
                "serve.handoff.import",
                parent=obs_trace.parse_traceparent(bundle.traceparent),
                journal=False, pages=n_pages,
            ):
                self.pool = srv.import_pages(
                    self.pool, ids, bundle.to_pool_payload()
                )
        except (ValueError, TypeError, RuntimeError) as e:
            # Import failed mid-flight (armed fault, payload/device
            # mismatch): release what was allocated and re-prefill
            # locally. NO ack — this side cannot prove the pages
            # landed, so the peer reclaims via lease expiry.
            self.pagepool.release(ids)
            self.free.append(r)
            kv_handoff._c_handoffs().inc(role="decode",
                                         outcome="import_error")
            log.warning("handoff import for %s failed (%s); "
                        "re-prefilling locally", bundle.lease_id, e)
            self.admit(req)
            return
        self.tables[r] = list(ids)
        self.owned[r] = set(ids)
        self.row_len[r] = len(w)
        # Same publication the local finish arm does: the imported
        # prompt's pages serve future prefix hits on THIS replica, and
        # the partial tail page becomes index-owned (read-only) so the
        # row's first decode write copy-on-extends it.
        self.index.insert(w, self.tables[r][:n_pages])
        if len(w) % cfg.page_tokens:
            self.owned[r].discard(self.tables[r][n_pages - 1])
        req.budget = bundle.budget
        req.slot["ttft"] = now - req.arrival
        req.ledger.first_token(lt1)
        # TTFT lands when the first token exists — here it arrived with
        # the bundle; once per request.
        _h_ttft().observe(req.slot["ttft"], path="paged")
        req.asm.push([t])
        if req.want_lp:
            req.lps.append(bundle.first_lp)
        req.last = t
        req.budget -= 1
        if req.asm.finished:  # single-token stop sequence
            req.budget = 0
        if req.budget <= 0:
            b._finish(req)
            self._drop_row(r)
        else:
            b._emit(req)
            self.live[r] = req
        self._ack(bundle.lease_id)
        kv_handoff._c_handoffs().inc(role="decode", outcome="imported")

    def _ack(self, lease_id: str) -> None:
        """Release the peer's lease (best-effort; a lost ack costs the
        peer one lease expiry, never correctness)."""
        if self.b.handoff_client is not None:
            self.b.handoff_client.ack(lease_id)

    def reap_handoff(self) -> None:
        """Release page refs of resolved (acked or expired) leases —
        called once per engine iteration, so the ``PagePool`` itself
        never crosses a thread."""
        leases = self.b.leases
        if leases is None or not leases.pending():
            return
        for pages in leases.take_resolved():
            self.pagepool.release(pages)

    # ---- warmup -------------------------------------------------------

    def warmup(self) -> None:
        """Run every (chunk-bucket x page-bucket) prefill, each page
        bucket's decode segment, each copy bucket and, in a
        disaggregated role, each hop bucket once, so
        steady-state serving never pays a first call in-band (the
        tpu_serve_jit_compiles_total counter must stay flat after
        this). Every warmup write lands on the scratch page."""
        b, srv = self.b, self.srv
        maxp = self.cfg.max_pages_per_row
        ws, w = [], srv.page_bucket(1, maxp)
        while w not in ws:
            ws.append(w)
            w = srv.page_bucket(w + 1, maxp)
        cs, c = [], srv._bucket(1, 8, cap=b.chunk)
        while c not in cs:
            cs.append(c)
            c = srv._bucket(c + 1, 8, cap=b.chunk)
        rows = b.rows
        zeros_i = np.zeros((rows,), np.int64)
        ones_i = np.ones((rows,), np.int64)
        zeros_f = np.zeros((rows,), np.float32)
        for w in ws:
            bt = np.zeros((rows, w), np.int64)
            for c in cs:
                self.pool, _, _ = srv.paged_prefill_chunk(
                    self.pool, np.zeros((rows, c), np.int64), bt,
                    zeros_i, zeros_i, b._next_key(), zeros_f, zeros_i,
                )
            self.pool, _, _ = srv.paged_decode_segment(
                self.pool, bt, np.zeros((rows, 1), np.int64), zeros_i,
                b._next_key(), zeros_f, zeros_i, b.segment,
            )
            if srv.spec_k is not None:
                # the paged spec loop runs per page bucket too; a 1-token
                # budget runs exactly one draft/verify round through the
                # real program (writes land on scratch)
                self.pool, _ = srv.paged_spec_segment(
                    self.pool, bt, np.zeros((rows, 1), np.int64),
                    ones_i, ones_i, b.segment,
                )
        n = 1
        while n <= rows:
            self.pool = srv.copy_pages(self.pool, [0] * n, [0] * n)
            n *= 2
        if b.role != "both":
            # Handoff hop programs: the export gather and import scatter
            # run once per power-of-two page-count bucket. Scratch-page
            # ids make every warmup transfer a no-op on real state.
            n = 1
            cap = srv._bucket(self.cfg.max_pages_per_row, 1, None)
            while n <= cap:
                ids = [0] * n
                zeros = srv.export_pages(self.pool, ids)
                if b.role == "decode":
                    self.pool = srv.import_pages(self.pool, ids, zeros)
                n *= 2
        srv.max_rows = rows
        if srv.spec_k is not None:
            # warmup decodes must not pollute acceptance telemetry
            srv.reset_spec_stats()
