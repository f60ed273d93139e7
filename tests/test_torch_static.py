"""The port's static batcher and startup warmup, against the reference's.

The reference's static-batcher cases (tests/test_decode_cache.py,
tests/test_serve_continuous.py, tests/test_speculative.py and the static
cases of tests/test_chaos.py) run against the port's ``Batcher`` and
``LMServer.warmup`` on the CPU, at the tiny float32 config of those
files. Coalescing and grouping are made deterministic by a window no
test waits out: a batch closes when ``max_batch`` requests have arrived.
The chaos cases run on a host-only fake engine whose decode waits on an
``Event``. Then the cross-package checks: at the same weights
(models/params.py) the port's ``Batcher`` gives the reference
``Batcher``'s tokens, identical, with logprobs within 1e-4, plain and
with a self-draft. Then the CLI flags and one ``--batching static``
daemon over HTTP. Every batcher and HTTP server a test starts is closed
in it, and the port's batcher thread ends once closed and idle.
"""

import json
import math
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.models import serve as jserve
from k8s_device_plugin_tpu.models import serve_http as jhttp
from k8s_device_plugin_tpu.models import transformer as jt
from k8s_device_plugin_tpu_torch.models import serve_http
from k8s_device_plugin_tpu_torch.models import transformer as tt
from k8s_device_plugin_tpu_torch.models.params import params_from_jax
from k8s_device_plugin_tpu_torch.models.serve import (
    Batcher,
    ContinuousBatcher,
    DeadlineError,
    LMServer,
    ShedError,
)
from k8s_device_plugin_tpu_torch.models.serve_text import TextAssembler
from k8s_device_plugin_tpu_torch.obs import flightrec as obs_flightrec
from k8s_device_plugin_tpu_torch.obs import ledger as obs_ledger
from k8s_device_plugin_tpu_torch.obs import metrics as obs_metrics
from k8s_device_plugin_tpu_torch.utils import faults

TINY = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=32,
            mlp_dim=64, max_seq_len=64)
# A window no test waits out: batches close at max_batch arrivals.
WIDE_MS = 60_000.0
JOBS = [([5, 17, 99], 7), ([7, 3, 42, 11], 23), ([1], 4), ([88, 2], 12)]
LP_TOL = 1e-4


def tiny_server(**kw):
    return LMServer(config=tt.LMConfig(**TINY, dtype=torch.float32, **kw),
                    device="cpu")


@pytest.fixture(scope="module")
def server():
    return tiny_server()


@pytest.fixture(scope="module")
def pair():
    """A reference LMServer and the port's with its parameters."""
    jsrv = jserve.LMServer(config=jt.LMConfig(**TINY, dtype=jnp.float32))
    ct = tt.LMConfig(**TINY, dtype=torch.float32)
    tsrv = LMServer(config=ct, device="cpu", params=params_from_jax(
        jax.tree_util.tree_map(np.asarray, jsrv.params), ct))
    return jsrv, tsrv


def _batcher_threads():
    return {t for t in threading.enumerate()
            if t.name in ("llm-serve-batcher", "llm-serve-engine")}


class _Closing:
    """Builds a test's batchers; at its end closes them and joins their
    engine threads, which must end (closed + idle)."""

    def __init__(self):
        self.made = []

    def __call__(self, make, *args, **kw):
        before = _batcher_threads()
        b = make(*args, **kw)
        self.made.append((b, _batcher_threads() - before))
        return b

    def close(self):
        for b, _ in self.made:
            b.close()
        for _, threads in self.made:
            for t in threads:
                t.join(timeout=10)
                assert not t.is_alive(), "batcher thread outlived close"


@pytest.fixture
def closing():
    c = _Closing()
    yield c
    c.close()


def _counting(monkeypatch, srv, record):
    """Wrap ``srv.complete_batch`` to record each call's budgets."""
    real = srv.complete_batch
    calls = []

    def counting(ps, ns, **kw):
        calls.append(record(ps, ns))
        return real(ps, ns, **kw)

    monkeypatch.setattr(srv, "complete_batch", counting)
    return calls


# ---------------------------------------------------------------------------
# tests/test_decode_cache.py: coalescing and grouping
# ---------------------------------------------------------------------------

def test_batcher_coalesces_concurrent_requests(server, closing,
                                               monkeypatch):
    prompts = [[5, 17, 99], [7, 3, 42, 11], [1], [88, 2]]
    want = [server.complete(p, 5)[0] for p in prompts]
    calls = _counting(monkeypatch, server, lambda ps, ns: len(ps))
    b = closing(Batcher, server, max_batch=4, window_ms=WIDE_MS)
    results = [None] * len(prompts)

    def run(i):
        results[i], _ = b.submit(prompts[i], 5)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert results == want
    # all four inside one window: one batch call
    assert calls == [4]


def test_batcher_groups_by_decode_bucket(server, closing, monkeypatch):
    jobs = [([5, 17, 99], 4), ([7, 3, 42], 40), ([1], 4), ([9, 9], 40)]
    want = [server.complete(p, n)[0] for p, n in jobs]
    calls = _counting(monkeypatch, server, lambda ps, ns: sorted(ns))
    b = closing(Batcher, server, max_batch=4, window_ms=WIDE_MS)
    reqs = [b.submit_async(p, n) for p, n in jobs]
    assert [b.wait(r, timeout=120)[0] for r in reqs] == want
    # one call a decode bucket, the shortest first
    assert calls == [[4, 4], [40, 40]]
    for ns in calls:
        assert len({server._scan_bucket(n - 1) for n in ns}) == 1


# ---------------------------------------------------------------------------
# tests/test_serve_continuous.py: the static cases
# ---------------------------------------------------------------------------

def test_static_batcher_supports_sampling(server, closing):
    b = closing(Batcher, server, max_batch=2, window_ms=5.0)
    toks, ttft = b.submit([5, 6], 6, temperature=1.2, top_k=1)
    assert toks == server.complete([5, 6], 6)[0]
    assert ttft >= 0


def test_complete_batch_caps_rows_after_warmup():
    srv = tiny_server()
    srv.warmup(decode_tokens=4, max_batch=2)
    assert srv.max_rows == 2
    with pytest.raises(ValueError, match="exceeds warmed max batch"):
        srv.complete_batch([[1]] * 3, [2] * 3)
    outs, _ = srv.complete_batch([[1], [2]], [2, 2])
    assert len(outs) == 2


def test_warmup_runs_every_bucket_once(monkeypatch):
    """The reference's warmup: every (rows, length) prefill bucket, then
    a greedy and a sampled complete_batch a row bucket; a draft adds
    complete_batch_spec; spec stats reset. A rows bucket of 3 rounds to
    the power of two above."""
    srv = tiny_server()
    srv.config = tt.LMConfig(**dict(TINY, max_seq_len=512),
                             dtype=torch.float32)
    seen = {"prefill": [], "batch": [], "spec": []}
    monkeypatch.setattr(srv, "_prefill", lambda toks: (
        seen["prefill"].append(tuple(toks.shape))))
    monkeypatch.setattr(srv, "complete_batch", lambda ps, ns, **kw: (
        seen["batch"].append((len(ps), ns[0], kw.get("temps")))))
    monkeypatch.setattr(srv, "complete_batch_spec", lambda ps, ns: (
        seen["spec"].append((len(ps), ns[0]))))
    srv.spec_k = 3
    srv.spec_stats = {"tokens": 9, "verify_rounds": 9}
    srv.warmup(decode_tokens=48, max_batch=3)
    assert srv.max_rows == 4
    assert seen["prefill"] == [(r, n) for r in (1, 2, 4)
                               for n in (128, 256, 512)]
    assert seen["batch"] == [(r, 48, t) for r in (1, 2, 4)
                             for t in (None, [1.0] * r)]
    assert seen["spec"] == [(1, 48), (2, 48), (4, 48)]
    assert srv.spec_stats_snapshot() == {"tokens": 0, "verify_rounds": 0}


def _expected_with_stop(srv, prompt, budget, stop_bytes):
    full = srv.complete(prompt, budget)[0]
    asm = TextAssembler(srv.tokenizer.token_bytes, [stop_bytes])
    asm.push(full[len(prompt):])
    return list(prompt) + asm.tokens, asm.text(), asm.finished


def test_stop_string_truncates_static(server, closing):
    prompt, budget = [7, 3, 42], 12
    full = server.complete(prompt, budget)[0]
    stop = bytes(full[len(prompt) + 3: len(prompt) + 5])
    want_toks, want_text, want_hit = _expected_with_stop(
        server, prompt, budget, stop)
    assert want_hit
    b = closing(Batcher, server, max_batch=2, window_ms=5.0)
    req = b.submit_async(prompt, budget, stop=[stop], logprobs=True)
    toks, _ = b.wait(req)
    assert toks == want_toks
    assert req.slot["text"] == want_text
    assert req.slot["finish_reason"] == "stop"
    assert len(req.slot["logprobs"]) == len(toks) - len(prompt)


def test_logprobs_align_across_modes(server, closing):
    prompt, budget = [5, 17], 9
    eng = closing(ContinuousBatcher, server, max_batch=2, segment_tokens=4)
    req = eng.submit_async(prompt, budget, logprobs=True)
    toks, _ = eng.wait(req)
    lps = req.slot["logprobs"]
    assert len(lps) == len(toks) - len(prompt) >= 1
    assert all(v <= 0 for v in lps)
    b = closing(Batcher, server, max_batch=1, window_ms=0.0)
    req2 = b.submit_async(prompt, budget, logprobs=True)
    toks2, _ = b.wait(req2)
    assert toks2 == toks
    assert len(req2.slot["logprobs"]) == len(lps)
    for a, c in zip(lps, req2.slot["logprobs"]):
        assert math.isclose(a, c, rel_tol=1e-4, abs_tol=1e-5), (a, c)
    # without logprobs the slot carries an empty list
    req3 = b.submit_async(prompt, budget)
    b.wait(req3)
    assert req3.slot["logprobs"] == []


def test_static_full_context_budget_reports_length(server, closing):
    b = closing(Batcher, server, max_batch=1, window_ms=0.0)
    req = b.submit_async([5, 6], server.config.max_seq_len)
    b.wait(req)
    assert req.slot["finish_reason"] == "length"


def test_eos_reports_stop(closing):
    srv = tiny_server()
    greedy = srv.complete([5, 17], 12)[0]
    srv.eos_id = greedy[4]  # a token the model emits mid-stream
    b = closing(Batcher, srv, max_batch=1, window_ms=0.0)
    req = b.submit_async([5, 17], 12)
    toks, _ = b.wait(req)
    assert toks == greedy[:4]
    assert req.slot["finish_reason"] == "stop"


def test_streaming_static_single_final_chunk(server, closing):
    b = closing(Batcher, server, max_batch=2, window_ms=5.0)
    req = b.submit_async([4, 9], 6, stream=True)
    chunks = []
    while True:
        c = req.stream_q.get(timeout=300)
        if c is None:
            break
        chunks.append(c)
    assert req.done.wait(10)
    assert len(chunks) == 1  # static mode: whole completion, one frame
    assert chunks[0] == req.slot["text"]
    assert req.slot["tokens"] == server.complete([4, 9], 6)[0]


# ---------------------------------------------------------------------------
# tests/test_speculative.py: the static batcher with a draft
# ---------------------------------------------------------------------------

def _drafted(**kw):
    srv = tiny_server(**kw)
    srv.enable_draft(1, k=3)
    return srv


def test_batcher_routes_greedy_to_spec_and_sampled_away(closing):
    srv = _drafted()
    b = closing(Batcher, srv, max_batch=2, window_ms=0.0)
    want, _ = srv.complete_batch([[5, 6]], [6])
    srv.reset_spec_stats()
    req = b.submit_async([5, 6], 6)
    toks, _ = b.wait(req)
    assert toks == want[0]
    rounds = srv.spec_stats_snapshot()["verify_rounds"]
    assert rounds >= 1  # greedy went through the verify loop
    # sampled falls back to the plain loop (top_k=1 == greedy, pinned)
    req2 = b.submit_async([5, 6], 6, temperature=1.5, top_k=1)
    assert b.wait(req2)[0] == want[0]
    # logprob-requesting greedy also falls back (spec has no logprobs)
    req3 = b.submit_async([5, 6], 6, logprobs=True)
    toks3, _ = b.wait(req3)
    assert toks3 == want[0]
    assert len(req3.slot["logprobs"]) == len(toks3) - 2
    assert srv.spec_stats_snapshot()["verify_rounds"] == rounds


@pytest.mark.parametrize("budget", [5, 7, 11])
def test_static_spec_exact_with_full_acceptance_budget_overshoot(
        budget, closing):
    srv = tiny_server()
    srv.enable_draft(1, k=3)
    # the perfect draft: draft = target, every proposal accepted
    srv.draft_model, srv.draft_config = srv.model, srv.config
    srv._spec_cache.clear()
    want, _ = srv.complete_batch([[9, 4, 7]], [budget])
    assert srv.complete_batch_spec([[9, 4, 7]], [budget])[0] == want
    srv.reset_spec_stats()
    b = closing(Batcher, srv, max_batch=1, window_ms=0.0)
    assert b.submit([9, 4, 7], budget)[0] == want[0]
    st = srv.spec_stats_snapshot()
    assert st["tokens"] == budget - 1
    assert st["verify_rounds"] < budget - 1  # more than a token a round


# ---------------------------------------------------------------------------
# tests/test_chaos.py: the static cases, on a host-only fake engine
# ---------------------------------------------------------------------------

class FakeLMServer:
    """Host-only stand-in for LMServer: everything the static Batcher
    and the HTTP handler touch, none of the device work. Its decode
    waits on ``decode_gate`` when given."""

    spec_k = None

    def __init__(self, decode_gate=None):
        from k8s_device_plugin_tpu_torch.models.tokenizer import (
            ByteTokenizer,
        )

        self.tokenizer = ByteTokenizer()
        self.config = SimpleNamespace(max_seq_len=128)
        self.decode_gate = decode_gate

    def encode_prompt(self, prompt):
        return list(prompt.encode("utf-8")) or [0]

    def _scan_bucket(self, n):
        return 16

    def _batch_setup(self, prompts, budgets):
        return list(budgets), [len(p) for p in prompts], None, None

    def complete_batch(self, prompts, budgets, temps=None, topks=None,
                       key=None, return_logprobs=False):
        if self.decode_gate is not None and not self.decode_gate.wait(10):
            raise RuntimeError("test decode gate never opened")
        outs = [list(p) + [0x42] * b for p, b in zip(prompts, budgets)]
        ttft = 0.001
        if return_logprobs:
            return outs, [[0.0] * b for b in budgets], ttft
        return outs, ttft


@pytest.fixture
def registry():
    reg = obs_metrics.MetricsRegistry()
    obs_metrics.install(reg)
    yield reg
    obs_metrics.uninstall()


class _CountingClock:
    def __init__(self, tick=0.001):
        self.t = 0.0
        self.tick = tick
        self._lock = threading.Lock()

    def __call__(self):
        with self._lock:
            self.t += self.tick
            return self.t


@pytest.fixture
def ledger_store():
    obs_flightrec.uninstall_all()
    store = obs_ledger.install_store(
        obs_ledger.LedgerStore(capacity=64, clock=_CountingClock()))
    yield store
    obs_ledger.uninstall_store()
    obs_flightrec.uninstall_all()


def _mk_batcher(closing, server, **kw):
    return closing(Batcher, server, max_batch=1, window_ms=0.0, **kw)


def _wait_admitted(batcher, n):
    deadline = time.monotonic() + 10
    while batcher.q.unfinished_tasks < n:
        assert time.monotonic() < deadline, f"{n} never admitted"
        time.sleep(0.01)


def test_decode_fault_fails_batch_not_engine(registry, closing):
    batcher = _mk_batcher(closing, FakeLMServer())
    with faults.plan("serve.decode_step=error:count=1") as p:
        r1 = batcher.submit_async([1, 2], 4)
        with pytest.raises(RuntimeError, match="injected fault"):
            batcher.wait(r1, timeout=10)
        assert p.fires("serve.decode_step") == 1
    # the engine thread survived the fault and serves the next request
    r2 = batcher.submit_async([1, 2], 4)
    out, _ = batcher.wait(r2, timeout=10)
    assert out == [1, 2, 0x42, 0x42, 0x42, 0x42]
    c = registry.counter("tpu_serve_requests_total", labels=("outcome",))
    assert c.value(outcome="error") == 1
    assert c.value(outcome="ok") == 1


def _post(port, payload, timeout=15):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


class _Http:
    """The port's handler over ``server``/``batcher`` on a free port."""

    def __init__(self, server, batcher):
        self.httpd = ThreadingHTTPServer(
            ("127.0.0.1", 0), serve_http.make_handler(server, batcher))
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


def test_serving_overload_sheds_with_bounded_queue(registry, closing):
    gate = threading.Event()
    server = FakeLMServer(decode_gate=gate)
    batcher = _mk_batcher(closing, server, max_pending=2)
    http = _Http(server, batcher)
    try:
        results = {}

        def client(name, payload):
            results[name] = _post(http.port, payload)

        ta = threading.Thread(target=client, args=(
            "a", {"prompt": "aa", "max_tokens": 2}))
        ta.start()
        _wait_admitted(batcher, 1)
        tb = threading.Thread(target=client, args=(
            "b", {"prompt": "bb", "max_tokens": 2}))
        tb.start()
        _wait_admitted(batcher, 2)
        # C: queue full -> shed 429 with Retry-After, class=shed
        status, body, headers = _post(http.port,
                                      {"prompt": "cc", "max_tokens": 2})
        assert status == 429 and body["class"] == "shed"
        assert headers.get("Retry-After") == "1"
        gate.set()
        ta.join(timeout=10)
        tb.join(timeout=10)
        assert results["a"][0] == 200 and results["b"][0] == 200
        shed = registry.counter("tpu_serve_shed_total",
                                labels=("reason",))
        assert shed.value(reason="queue_full") == 1
        errors = registry.counter("tpu_serve_http_errors_total",
                                  labels=("cls",))
        assert errors.value(cls="shed") == 1
    finally:
        gate.set()
        http.close()


def test_serving_deadline_propagates_into_decode(registry, closing):
    gate = threading.Event()
    server = FakeLMServer(decode_gate=gate)
    batcher = _mk_batcher(closing, server, max_pending=8)
    http = _Http(server, batcher)
    try:
        # A blocks the lone decode thread; B's deadline expires queued.
        ra = batcher.submit_async([1], 2)
        status, body, _ = _post(
            http.port, {"prompt": "bb", "max_tokens": 2, "timeout": 0.2})
        assert status == 504 and body["class"] == "deadline"
        gate.set()
        out, _ = batcher.wait(ra, timeout=10)
        assert out[-1] == 0x42
        # the expired request was reaped by the engine without decoding
        _wait_admitted_to(batcher, 0)
        assert registry.counter("tpu_serve_requests_total",
                                labels=("outcome",)).value(
                                    outcome="deadline") == 1
        assert registry.counter("tpu_serve_http_errors_total",
                                labels=("cls",)).value(cls="deadline") == 1
    finally:
        gate.set()
        http.close()


def _wait_admitted_to(batcher, n):
    deadline = time.monotonic() + 10
    while batcher.q.unfinished_tasks != n:
        assert time.monotonic() < deadline, "queue never drained"
        time.sleep(0.01)


def test_overload_shed_counts_are_deterministic(closing):
    def run():
        reg = obs_metrics.MetricsRegistry()
        obs_metrics.install(reg)
        gate = threading.Event()
        try:
            batcher = _mk_batcher(closing, FakeLMServer(decode_gate=gate),
                                  max_pending=3)
            outcomes, reqs = [], []
            for _ in range(8):
                try:
                    reqs.append(batcher.submit_async([1], 1))
                    outcomes.append("ok")
                except ShedError:
                    outcomes.append("shed")
            shed = reg.counter("tpu_serve_shed_total",
                               labels=("reason",)).value(
                                   reason="queue_full")
            gate.set()
            for r in reqs:
                batcher.wait(r, timeout=10)
            return outcomes, shed
        finally:
            gate.set()
            obs_metrics.uninstall()

    first = run()
    assert first == run()
    assert first == (["ok"] * 3 + ["shed"] * 5, 5)


def test_armed_fault_dumps_flight_recorder(registry, ledger_store,
                                           tmp_path, monkeypatch,
                                           closing):
    log = tmp_path / "chip.jsonl"
    monkeypatch.setenv("TPU_CHIP_LOG", str(log))
    batcher = _mk_batcher(closing, FakeLMServer())
    with faults.plan("serve.decode_step=error:count=1") as p:
        r1 = batcher.submit_async([1, 2], 4)
        with pytest.raises(RuntimeError, match="injected fault"):
            batcher.wait(r1, timeout=10)
        assert p.fires("serve.decode_step") == 1
    dumps = [json.loads(x) for x in log.read_text().strip().splitlines()
             if json.loads(x).get("entrypoint") == "flight-recorder"]
    assert len(dumps) == 1, "one armed fault -> exactly one dump"
    assert dumps[0]["trigger"] == "fault:serve.decode_step"
    assert dumps[0]["recorder"] == "Batcher"
    row = ledger_store.get(r1.slot["trace_id"])
    assert row is not None and row["state"] == "error"


def test_ledger_decomposition_bit_stable_two_runs(registry, closing):
    def run():
        obs_flightrec.uninstall_all()
        store = obs_ledger.install_store(
            obs_ledger.LedgerStore(capacity=64, clock=_CountingClock()))
        try:
            batcher = _mk_batcher(closing, FakeLMServer())
            for _ in range(4):
                batcher.wait(batcher.submit_async([1, 2, 3], 4), timeout=10)
            rows = store.recent()
            rows.reverse()
            return [{k: v for k, v in r.items() if k != "trace_id"}
                    for r in rows]
        finally:
            obs_ledger.uninstall_store()
            obs_flightrec.uninstall_all()

    a, b = run(), run()
    assert a == b and len(a) == 4
    for row in a:
        assert row["state"] == "ok"
        parts = (row["queue_wait_s"] + row["prefill_service_s"]
                 + row["decode_service_s"] + row["stall_s"])
        assert parts == pytest.approx(row["e2e_s"], abs=1e-9)
        assert row["tokens"] == 4


def test_shed_victim_lands_terminal_ledger_state(registry, ledger_store,
                                                 closing):
    gate = threading.Event()
    batcher = _mk_batcher(closing, FakeLMServer(decode_gate=gate),
                          max_pending=2)
    try:
        ra = batcher.submit_async([1], 2)  # decoding, blocked on gate
        _wait_admitted(batcher, 1)
        rb = batcher.submit_async([2], 2, slo="batch")  # queued
        # an interactive arrival preempts the queued batch-class victim
        rc = batcher.submit_async([3], 2, slo="interactive")
        with pytest.raises(ShedError):
            batcher.wait(rb, timeout=10)
        gate.set()
        batcher.wait(ra, timeout=10)
        batcher.wait(rc, timeout=10)
        assert ledger_store.get(rb.slot["trace_id"])["state"] == "shed"
        assert ledger_store.get(rc.slot["trace_id"])["state"] == "ok"
    finally:
        gate.set()


def test_deadline_expiry_lands_terminal_ledger_state(registry,
                                                     ledger_store,
                                                     closing):
    gate = threading.Event()
    batcher = _mk_batcher(closing, FakeLMServer(decode_gate=gate),
                          max_pending=8)
    try:
        ra = batcher.submit_async([1], 2)  # blocks the decode thread
        rb = batcher.submit_async([2], 2, deadline_s=0.2)
        with pytest.raises(DeadlineError):
            batcher.wait(rb, timeout=10)
        gate.set()
        batcher.wait(ra, timeout=10)
        # the engine reaps the expired request at its next admission
        _wait_admitted_to(batcher, 0)
        row = ledger_store.get(rb.slot["trace_id"])
        assert row is not None and row["state"] == "deadline"
    finally:
        gate.set()


def test_loop_thread_ends_once_closed_and_idle():
    """The one difference from the reference's loop, which waits on its
    queue forever: closed with a request in flight, the thread finishes
    it, then returns; a submit after close raises."""
    gate = threading.Event()
    before = _batcher_threads()
    b = Batcher(FakeLMServer(decode_gate=gate), max_batch=1,
                window_ms=0.0)
    (thread,) = _batcher_threads() - before
    try:
        req = b.submit_async([1], 3)
        _wait_admitted(b, 1)
        b.close()
        with pytest.raises(RuntimeError, match="shutting down"):
            b.submit_async([2], 2)
        thread.join(timeout=0.5)
        assert thread.is_alive()  # the request is still in flight
        gate.set()
        assert b.wait(req, timeout=10)[0] == [1, 0x42, 0x42, 0x42]
        thread.join(timeout=10)
        assert not thread.is_alive()
    finally:
        gate.set()
        b.close()


# ---------------------------------------------------------------------------
# the reference's Batcher at the same weights
# ---------------------------------------------------------------------------

def _batcher_run(batcher, jobs, logprobs):
    """``jobs`` at once through ``batcher`` (max_batch = len(jobs), a
    wide window: one batch); [(tokens, logprobs)] in job order."""
    reqs = [batcher.submit_async(p, n, logprobs=logprobs) for p, n in jobs]
    out = []
    for r in reqs:
        toks, _ = batcher.wait(r, timeout=300)
        out.append((toks, r.slot["logprobs"]))
    return out


def _reference_run(jsrv, logprobs):
    """JOBS through the reference's Batcher, closed afterwards (its
    thread waits on the queue for good; closing releases its flight
    recorder and queue-depth claims)."""
    b = jserve.Batcher(jsrv, max_batch=4, window_ms=WIDE_MS)
    try:
        return _batcher_run(b, JOBS, logprobs)
    finally:
        b.close()


@pytest.mark.parametrize("logprobs", [True, False])
def test_static_batcher_matches_reference(pair, closing, logprobs):
    jsrv, tsrv = pair
    want = _reference_run(jsrv, logprobs)
    b = closing(Batcher, tsrv, max_batch=4, window_ms=WIDE_MS)
    got = _batcher_run(b, JOBS, logprobs)
    assert [g[0] for g in got] == [w[0] for w in want]
    for (toks, g), (_, w), (prompt, _) in zip(got, want, JOBS):
        assert len(g) == len(w) == (len(toks) - len(prompt)
                                    if logprobs else 0)
        np.testing.assert_allclose(g, w, atol=LP_TOL)
    # ... and the port's batcher equals its own oracle
    assert [g[0] for g in got] == [tsrv.complete(p, n)[0] for p, n in JOBS]


def test_static_batcher_with_draft_matches_reference(pair, closing):
    jsrv, tsrv = pair
    for srv in pair:
        srv.enable_draft(1, k=3)
    try:
        rounds = {}
        jsrv.reset_spec_stats()
        want = _reference_run(jsrv, False)
        rounds["jax"] = jsrv.spec_stats["verify_rounds"]
        tsrv.reset_spec_stats()
        b = closing(Batcher, tsrv, max_batch=4, window_ms=WIDE_MS)
        got = _batcher_run(b, JOBS, False)
        rounds["torch"] = tsrv.spec_stats_snapshot()["verify_rounds"]
        assert [g[0] for g in got] == [w[0] for w in want]
        assert rounds["torch"] == rounds["jax"] >= 1
        plain, _ = tsrv.complete_batch([p for p, _ in JOBS],
                                       [n for _, n in JOBS])
        assert [g[0] for g in got] == plain
    finally:
        for srv in pair:
            srv.spec_k = None
            srv.draft_model = srv.draft_config = None


def test_warmup_matches_reference_counts(pair, monkeypatch):
    """The port's warmup runs the reference's prefill and batch calls:
    the same shapes, in the same order."""
    jsrv, tsrv = pair
    seen = {}
    for name, srv in (("jax", jsrv), ("torch", tsrv)):
        calls = seen[name] = []
        monkeypatch.setattr(srv, "_prefill", lambda *a, _c=calls: _c.append(
            ("prefill", tuple(a[-1].shape))))
        monkeypatch.setattr(srv, "complete_batch",
                            lambda ps, ns, _c=calls, **kw: _c.append(
                                ("batch", len(ps), ns[0],
                                 "temps" in kw)))
        monkeypatch.setattr(srv, "max_rows", srv.max_rows)
        srv.warmup(decode_tokens=4, max_batch=2)
    assert seen["torch"] == seen["jax"]
    assert len(seen["torch"]) == 2 * 1 + 2 * 2


# ---------------------------------------------------------------------------
# the CLI: flags, the --role parser error, one static daemon over HTTP
# ---------------------------------------------------------------------------

def _options(parser):
    return {s for a in parser._actions for s in a.option_strings}


def test_static_flags_and_role_parser_error(capsys):
    parser = serve_http.build_arg_parser()
    args = parser.parse_args([])
    assert (args.batching, args.batch_window_ms, args.warmup_tokens) == (
        "continuous", 8.0, 16)
    args = parser.parse_args(["--batching", "static", "--batch-window-ms",
                              "2.5", "--warmup-tokens", "48"])
    assert (args.batching, args.batch_window_ms, args.warmup_tokens) == (
        "static", 2.5, 48)
    # the reference's flags plus --device
    ref = _options(jhttp.build_arg_parser())
    assert _options(parser) == ref | {"--device"}
    with pytest.raises(SystemExit) as ei:
        serve_http.main(["--batching", "static", "--role", "prefill"])
    assert ei.value.code == 2
    assert ("--role prefill/decode requires --batching continuous"
            in capsys.readouterr().err)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return resp.status, resp.read().decode()


def test_static_daemon_over_http():
    ready = threading.Event()
    handle, rc = {}, {}

    def on_ready(httpd, batcher):
        handle["httpd"], handle["batcher"] = httpd, batcher
        ready.set()

    daemon = threading.Thread(target=lambda: rc.setdefault(
        "rc", serve_http.main(
            ["--tiny", "--device", "cpu", "--port", "0", "--batching",
             "static", "--max-batch", "2", "--warmup-tokens", "5"],
            on_ready=on_ready)), daemon=True)
    before = _batcher_threads()
    daemon.start()
    assert ready.wait(120), "daemon did not come up"
    threads = _batcher_threads() - before
    batcher = handle["batcher"]
    port = handle["httpd"].server_address[1]
    try:
        assert isinstance(batcher, Batcher)
        srv = batcher.server
        assert srv.max_rows == 2  # warmed
        code, body, _ = _post(port, {"prompt": "hello", "max_tokens": 5,
                                     "logprobs": 1}, timeout=60)
        assert code == 200
        want = srv.complete(srv.encode_prompt("hello"), 5)[0]
        lps = body["choices"][0]["logprobs"]["token_logprobs"]
        assert body["usage"]["completion_tokens"] == len(lps) \
            == len(want) - len(srv.encode_prompt("hello"))
        assert body["choices"][0]["text"] == srv.tokenizer.decode(
            want[len(srv.encode_prompt("hello")):])
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/completions",
            data=json.dumps({"prompt": "hello", "max_tokens": 4,
                             "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            frames = [ln[6:] for ln in resp.read().decode().splitlines()
                      if ln.startswith("data: ")]
        assert frames[-1] == "[DONE]"
        assert json.loads(frames[-2])["usage"]["completion_tokens"] == 4
        code, health = _get(port, "/healthz")
        assert code == 200 and json.loads(health)["status"] == "ok"
        code, text = _get(port, "/metrics")
        assert "tpu_serve_ttft_seconds" in text
        assert 'tpu_serve_jit_compiles_total{fn="decode_scan"}' in text
    finally:
        handle["httpd"].shutdown()
        daemon.join(timeout=60)
    assert not daemon.is_alive() and rc["rc"] == 0
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
