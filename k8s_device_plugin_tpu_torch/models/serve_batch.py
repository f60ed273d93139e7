"""Continuous batching for the llm-serve daemon, in PyTorch.

The counterpart of ``k8s_device_plugin_tpu/models/serve_batch.py`` for
the rows KV layout: a fixed pool of cache rows decodes in fixed-length
segments; prompts join and retire at segment boundaries, so a request
waits at most one segment, not a neighbour's whole decode. Every
admission prefills through the flash kernel (serve_engine.prefill_rows).

Not ported yet (ROADMAP.md): the static ``Batcher``, the paged engine
(``_PagedEngine`` / ``_loop_paged``), speculative segments and the
disaggregated prefill/decode roles.

The HTTP protocol surface lives in serve_http.py.
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time

import numpy as np

from k8s_device_plugin_tpu_torch.models.kv_cache import SLO_CLASSES, SLO_RANK
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
                 "__weakref__")

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
                     slo: str = "standard") -> _Request:
        """Enqueue a request and return it immediately.

        Streaming callers read ``req.stream_q`` until the ``None``
        sentinel, then inspect ``req.slot``; blocking callers use
        :meth:`wait`. Raises :class:`ServerClosingError` once shutdown
        has started and :class:`ShedError` when ``max_pending``
        admitted-but-unfinished requests are already in flight."""
        if self._closed.is_set():
            raise ServerClosingError("server is shutting down")
        if self.max_pending and self.q.unfinished_tasks >= self.max_pending:
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
            self.q.put(req)
        _g_queue_depth().set(self.q.unfinished_tasks)
        return req

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
        request's decode completes."""
        self.quiesce()
        drained = False
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.q.unfinished_tasks == 0:
                drained = True
                break
            time.sleep(0.05)
        self.close()
        return drained


class ContinuousBatcher(_BatcherBase):
    """Continuous batching: a fixed row pool decoding in segments.

    The engine thread owns all device calls. Each iteration: admit
    waiting prompts into free rows (one prefill, scattered into the
    pool cache), decode ONE ``segment_tokens``-long loop for every row,
    retire rows whose budget or EOS hit.
    """

    def __init__(self, server, max_batch: int = 4,
                 segment_tokens: int = 16, seed: int = 0,
                 max_pending: int = 0):
        super().__init__(server, seed, max_pending=max_pending)
        self.rows = server._bucket(max(1, max_batch), 1, None)
        # segment_tokens <= 0 = auto-tune during warmup from this
        # device's measured dispatch overhead vs per-token cost.
        self._auto = segment_tokens <= 0
        self.segment = max(1, segment_tokens) if not self._auto else 16
        threading.Thread(target=self._loop, daemon=True,
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

    @staticmethod
    def _pow2_floor(n: int) -> int:
        p = 1
        while p * 2 <= n:
            p *= 2
        return p

    def _loop(self):
        srv = self.server
        pool = None
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
                    la0 = self.ledgers.now()
                    with obs_trace.span("serve.engine.admit",
                                        parent=_rep_ctx(got),
                                        journal=False, rows=len(got)):
                        pool = self._admit(pool, got, free, live)
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
                    pool = self._decode(pool, live, free)
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

    def _decode(self, pool, live, free):
        """One decode segment over the pool; retire finished rows."""
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
        with obs_trace.span(
            "serve.engine.decode_segment",
            parent=_rep_ctx(live.values()),
            journal=False, rows=len(live),
        ):
            pool, toks, seg_lps = srv.decode_segment(
                pool, tok, self._next_key(), temp, topk, self.segment,
            )
        toks_host = toks.cpu().numpy()  # [segment, rows]
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
        self.flight.record(
            "decode_segment", rows=n_live, slo_rows=slo_rows,
            queue_depth=self.q.unfinished_tasks,
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
                                      kind="plain")
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
        return pool

    def _do_warmup(self):
        srv = self.server
        pool = srv.make_pool_cache(self.rows)
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
            pool = srv.insert_rows(pool, cache, list(range(rows)))
            rows *= 2
        if self._auto:
            pool = self._tune_segment(pool)
        srv.decode_segment(
            pool, np.zeros((self.rows, 1), np.int64), self._next_key(),
            np.zeros((self.rows,), np.float32),
            np.zeros((self.rows,), np.int64), self.segment,
        )

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

    def _admit(self, pool, got, free, live):
        """Prefill ``got`` into free pool rows; returns the pool."""
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
        return pool

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
