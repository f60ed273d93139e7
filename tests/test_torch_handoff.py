"""The port's disaggregated prefill/decode roles against the reference's.

Every case of tests/test_handoff.py, run on the port's pair over the
in-process transport at the same tiny float32 config (vocab 128, 2
layers, 4 heads, embed 32, mlp 64, seq 64; pages of 8, chunks of 16):
the wire round trip and its rejections, the lease table, the env knobs,
the pair against the single paged engine (tokens and logprobs
bit-identical, with a prefix hit, with a self-draft, at budget 1), every
fault point, the breaker, malformed payloads and the HTTP wire. Then the
two packages across one hop, in both directions, with the JAX server's
parameters in the port's (models/params.py): tokens identical, logprobs
within 1e-4 (the two packages sum in other orders), no leaked lease.
Then the drain cases of tests/test_chaos.py, the bfloat16 wire without
``ml_dtypes`` (byte-equal to the reference's), and the CLI flags.

Servers are module-scoped (one per package and draft), ports are
ephemeral, and every batcher and HTTP server a test starts is closed in
it. Tokens are asserted, never timings.
"""

import json
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.models import handoff as jhandoff
from k8s_device_plugin_tpu.models import serve as jserve
from k8s_device_plugin_tpu.models import transformer as jt
from k8s_device_plugin_tpu.obs import metrics as jmetrics
from k8s_device_plugin_tpu_torch.models import handoff as kv_handoff
from k8s_device_plugin_tpu_torch.models import serve as tserve
from k8s_device_plugin_tpu_torch.models import serve_http
from k8s_device_plugin_tpu_torch.models import transformer as tt
from k8s_device_plugin_tpu_torch.models.params import params_from_jax
from k8s_device_plugin_tpu_torch.obs import metrics as obs_metrics
from k8s_device_plugin_tpu_torch.utils import faults
from k8s_device_plugin_tpu_torch.utils.retry import CircuitBreaker

PROMPT = [(i * 7 + 3) % 128 for i in range(20)]  # 3 pages of 8 + tail
TINY = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=32,
            mlp_dim=64, max_seq_len=64)
# logprobs across the two packages (tests/test_torch_paged_engine.py)
LP_TOL = 1e-4
PACKAGES = {"jax": (jserve, jhandoff), "torch": (tserve, kv_handoff)}


def _servers(draft: bool) -> dict:
    """A JAX server and the port's with the JAX one's parameters, each
    with a 1-layer self-draft at k = 3 when ``draft``."""
    jsrv = jserve.LMServer(config=jt.LMConfig(**TINY, dtype=jnp.float32))
    ct = tt.LMConfig(**TINY, dtype=torch.float32)
    tsrv = tserve.LMServer(config=ct, device="cpu", params=params_from_jax(
        jax.tree_util.tree_map(np.asarray, jsrv.params), ct))
    if draft:
        for srv in (jsrv, tsrv):
            srv.enable_draft(1, k=3)
    return {"jax": jsrv, "torch": tsrv}


@pytest.fixture(scope="module")
def servers():
    return _servers(draft=False)


@pytest.fixture(scope="module")
def spec_servers():
    return _servers(draft=True)


@pytest.fixture
def registry():
    reg = obs_metrics.MetricsRegistry()
    obs_metrics.install(reg)
    yield reg
    obs_metrics.uninstall()


@pytest.fixture
def registries(registry):
    """Both packages' registries: {"torch": port's, "jax": reference's}."""
    jreg = jmetrics.MetricsRegistry()
    jmetrics.install(jreg)
    yield {"torch": registry, "jax": jreg}
    jmetrics.uninstall()


def _pkg(server):
    return "jax" if isinstance(server, jserve.LMServer) else "torch"


def paged(server, max_batch=2, segment=4, **kw):
    kw.setdefault("page_tokens", 8)
    kw.setdefault("prefill_chunk", 16)
    serve = PACKAGES[_pkg(server)][0]
    return serve.ContinuousBatcher(server, max_batch=max_batch,
                                   segment_tokens=segment, kv_mode="paged",
                                   **kw)


def pair(server, decode_server=None, client_kw=None, **prefill_kw):
    """A warmed (prefill, decode, client) triple over the in-process
    transport; the decode replica (and its client) on ``decode_server``,
    which may be the other package's."""
    decode_server = decode_server or server
    handoff = PACKAGES[_pkg(decode_server)][1]
    prefill = paged(server, role="prefill", **prefill_kw)
    client = handoff.HandoffClient(
        handoff.InProcTransport(prefill), peer="inproc",
        **(client_kw or {}),
    )
    decode = paged(decode_server, role="decode", handoff_client=client)
    prefill.warmup()
    decode.warmup()
    return prefill, decode, client


def run_one(batcher, prompt=PROMPT, budget=6, logprobs=True):
    req = batcher.submit_async(list(prompt), budget, logprobs=logprobs)
    batcher.wait(req, timeout=120)
    return list(req.slot["tokens"]), list(req.slot.get("logprobs") or [])


def counter(reg, name, key):
    return reg.snapshot().get(name, {}).get("samples", {}).get(key, 0.0)


def wait_leases_drained(prefill, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if prefill.leases.pending() == 0:
            return True
        time.sleep(0.05)
    return False


def single_runs(server, budget=6, logprobs=True, n=2):
    """``n`` runs of PROMPT on a fresh single paged engine (the second
    rides the prefix index)."""
    single = paged(server)
    single.warmup()
    try:
        return [run_one(single, budget=budget, logprobs=logprobs)
                for _ in range(n)]
    finally:
        single.close()


@pytest.fixture(scope="module")
def singles(servers):
    """Each package's single engine on PROMPT: cold, then a prefix hit."""
    return {pkg: single_runs(srv) for pkg, srv in servers.items()}


@pytest.fixture(scope="module")
def spec_singles(spec_servers):
    """Each package's speculative single engine on PROMPT (greedy, no
    logprobs: the spec loop's own gate)."""
    return {pkg: single_runs(srv, logprobs=False, n=1)[0]
            for pkg, srv in spec_servers.items()}


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------

def _fake_bundle(handoff=kv_handoff, arrays=None, **over):
    if arrays is None:
        rng = np.random.RandomState(7)
        arrays = {
            f"layer{i}": {
                "k": rng.randn(3, 8, 4, 8).astype(np.float32),
                "v": rng.randn(3, 8, 4, 8).astype(np.float32),
            }
            for i in range(2)
        }
    kw = dict(lease_id="lease-1", lease_s=30.0, window=list(range(20)),
              first_token=42, first_lp=-1.25, budget=6, temp=0.0,
              topk=0, want_lp=True, slo="standard", page_tokens=8,
              arrays=arrays, traceparent=None)
    kw.update(over)
    return handoff.PageBlockBundle(**kw)


def test_bundle_wire_roundtrip_bitexact():
    b = _fake_bundle(traceparent="00-" + "ab" * 16 + "-" + "cd" * 8 + "-01")
    got = kv_handoff.PageBlockBundle.from_bytes(b.to_bytes(),
                                               clock=lambda: 5.0)
    assert got.lease_id == b.lease_id
    assert got.window == b.window
    assert (got.first_token, got.budget, got.page_tokens) == (42, 6, 8)
    assert got.first_lp == b.first_lp  # float64 through JSON: exact
    assert got.traceparent == b.traceparent
    assert got.num_pages == 3 and got.num_layers == 2
    assert got.born == 5.0 and not got.expired(clock=lambda: 34.9)
    assert got.expired(clock=lambda: 35.0)
    for name, kv in b.arrays.items():
        assert kv["k"].dtype == got.arrays[name]["k"].dtype
        assert np.array_equal(kv["k"], got.arrays[name]["k"])
        assert np.array_equal(kv["v"], got.arrays[name]["v"])


def test_bundle_rejects_garbage():
    wire = _fake_bundle().to_bytes()
    with pytest.raises(kv_handoff.HandoffRejected):
        kv_handoff.PageBlockBundle.from_bytes(b"nope" + wire[4:])
    with pytest.raises(kv_handoff.HandoffRejected):
        kv_handoff.PageBlockBundle.from_bytes(wire[:40])  # cut header
    with pytest.raises(kv_handoff.HandoffRejected):
        kv_handoff.PageBlockBundle.from_bytes(wire[:-8])  # cut body


def _bf16_words(seed=3, shape=(3, 8, 4, 8)):
    """Random bf16 bit patterns (finite: the exponent never all ones)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 16, size=shape, dtype=np.uint16)
    return np.where((words & 0x7F80) == 0x7F80, words ^ 0x4000, words)


def _bf16_payload(handoff_leaf):
    return {
        f"layer{i}": {"attn": {
            "k_pages": handoff_leaf(_bf16_words(seed=2 * i)),
            "v_pages": handoff_leaf(_bf16_words(seed=2 * i + 1)),
        }}
        for i in range(2)
    }


def _bundle_kw():
    return dict(lease_id="lease-bf16", lease_s=30.0, window=list(range(20)),
                first_token=42, first_lp=-1.25, budget=6, temp=0.0, topk=0,
                want_lp=True, slo="standard", page_tokens=8)


def _as_torch_bf16(words):
    return torch.from_numpy(words.view(np.int16).copy()).view(torch.bfloat16)


def test_bf16_bundle_bytes_equal_the_references():
    """The same bf16 words through each package's bundle: the same
    bytes (the header says "bfloat16", the body holds the raw words),
    and each package reads the other's."""
    import ml_dtypes

    ref = jhandoff.PageBlockBundle.from_pool_payload(
        _bf16_payload(lambda w: w.view(ml_dtypes.bfloat16)), **_bundle_kw())
    port = kv_handoff.PageBlockBundle.from_pool_payload(
        _bf16_payload(lambda w: kv_handoff.host_array(_as_torch_bf16(w))),
        **_bundle_kw())
    wire = port.to_bytes()
    assert wire == ref.to_bytes()
    assert b'"dtype": "bfloat16"' in wire
    back = jhandoff.PageBlockBundle.from_bytes(wire)
    mine = kv_handoff.PageBlockBundle.from_bytes(ref.to_bytes())
    for i in range(2):
        want = _bf16_words(seed=2 * i)
        assert np.array_equal(back.arrays[f"layer{i}"]["k"].view(np.uint16),
                              want)
        assert torch.equal(
            kv_handoff.to_tensor(mine.arrays[f"layer{i}"]["k"]),
            _as_torch_bf16(want))


def test_bf16_bundle_parses_without_ml_dtypes(monkeypatch):
    """``from_bytes`` reads bf16 with ``ml_dtypes`` unimportable (the
    port does not depend on it); the pages come back bit-equal as
    torch.bfloat16."""
    wire = kv_handoff.PageBlockBundle.from_pool_payload(
        _bf16_payload(lambda w: kv_handoff.host_array(_as_torch_bf16(w))),
        **_bundle_kw()).to_bytes()
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    got = kv_handoff.PageBlockBundle.from_bytes(wire)
    assert got.num_layers == 2 and got.num_pages == 3
    for i in range(2):
        for leaf, seed in (("k", 2 * i), ("v", 2 * i + 1)):
            t = kv_handoff.to_tensor(got.arrays[f"layer{i}"][leaf])
            assert t.dtype == torch.bfloat16
            assert torch.equal(t, _as_torch_bf16(_bf16_words(seed=seed)))


def test_fp32_bundle_bytes_unchanged():
    """float32 bundles keep the reference's bytes exactly."""
    rng = np.random.RandomState(7)
    arrays = {f"layer{i}": {"k": rng.randn(3, 8, 4, 8).astype(np.float32),
                            "v": rng.randn(3, 8, 4, 8).astype(np.float32)}
              for i in range(2)}
    port = _fake_bundle(arrays=arrays).to_bytes()
    assert port == _fake_bundle(jhandoff, arrays=arrays).to_bytes()
    assert b'"dtype": "float32"' in port


def test_export_import_round_trip_bf16_on_the_cpu(monkeypatch):
    """``export_pages`` -> bundle bytes -> ``import_pages`` into another
    pool at other ids: the bf16 pages bit-equal, with ``ml_dtypes``
    unimportable."""
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    srv = tserve.LMServer(config=tt.LMConfig(**TINY), device="cpu")
    src = srv.make_paged_pool(8, 8)
    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():  # the pool's tensors are inference ones
        for p in src.k_pages + src.v_pages:
            p.copy_(torch.randn(p.shape, generator=gen).to(p.dtype))
    ids, dst_ids = [3, 1, 6], [2, 5, 7]
    wire = kv_handoff.PageBlockBundle.from_pool_payload(
        srv.export_pages(src, ids), **_bundle_kw()).to_bytes()
    dst = srv.import_pages(srv.make_paged_pool(8, 8), dst_ids,
                           kv_handoff.PageBlockBundle.from_bytes(
                               wire).to_pool_payload())
    for a, b in zip(src.k_pages + src.v_pages, dst.k_pages + dst.v_pages):
        assert b.dtype == torch.bfloat16
        assert torch.equal(a[ids].view(torch.int16),
                           b[dst_ids].view(torch.int16))
        assert not b[0].any()  # padding wrote zeros to scratch only


# ---------------------------------------------------------------------------
# lease table
# ---------------------------------------------------------------------------

def test_lease_ack_then_reap(registry):
    clk = [0.0]
    t = kv_handoff.LeaseTable(lease_s=10.0, clock=lambda: clk[0])
    lid = t.export([3, 4, 5])
    assert t.pending() == 1
    assert t.take_resolved() == []  # live and unacked: stays
    assert t.ack(lid) and t.ack(lid)  # idempotent
    assert t.take_resolved() == [[3, 4, 5]]
    assert t.pending() == 0
    assert not t.ack(lid)  # gone
    assert counter(registry, "tpu_serve_handoff_orphans_total",
                   ("prefill",)) == 0.0


def test_lease_expiry_counts_orphans(registry):
    clk = [0.0]
    t = kv_handoff.LeaseTable(lease_s=10.0, clock=lambda: clk[0])
    t.export([1, 2])
    t.export([7])
    clk[0] = 10.0
    got = t.take_resolved()
    assert sorted(got) == [[1, 2], [7]]
    assert counter(registry, "tpu_serve_handoff_orphans_total",
                   ("prefill",)) == 2.0


def test_release_all_counts_orphans(registry):
    t = kv_handoff.LeaseTable(lease_s=60.0)
    t.export([1])
    t.export([2])
    assert t.release_all() == 2
    assert t.pending() == 0
    assert counter(registry, "tpu_serve_handoff_orphans_total",
                   ("prefill",)) == 2.0


def test_env_knobs_fall_back_on_garbage(monkeypatch):
    monkeypatch.setenv(kv_handoff.ENV_LEASE_S, "not-a-number")
    monkeypatch.setenv(kv_handoff.ENV_DEADLINE_S, "-3")
    assert kv_handoff.lease_s_from_env() == kv_handoff.DEFAULT_LEASE_S
    assert kv_handoff.deadline_s_from_env() == kv_handoff.DEFAULT_DEADLINE_S
    monkeypatch.setenv(kv_handoff.ENV_LEASE_S, "2.5")
    assert kv_handoff.lease_s_from_env() == 2.5


# ---------------------------------------------------------------------------
# token identity: the port's prefill -> the port's decode == single
# ---------------------------------------------------------------------------

def test_disagg_token_identity_with_prefix_hit(registry, servers, singles):
    cold, warm = singles["torch"]
    prefill, decode, client = pair(servers["torch"])
    try:
        got_cold = run_one(decode)
        got_warm = run_one(decode)  # prefix hit on the PREFILL side
        assert got_cold == cold  # tokens AND logprobs, bit-identical
        assert got_warm == warm
        assert counter(registry, "tpu_serve_handoff_total",
                       ("prefill", "export")) == 2.0
        assert counter(registry, "tpu_serve_handoff_total",
                       ("decode", "imported")) == 2.0
        # decode acked both leases; the prefill engine reaps them on
        # its idle tick — zero pages left leased
        assert wait_leases_drained(prefill)
        assert counter(registry, "tpu_serve_handoff_orphans_total",
                       ("prefill",)) == 0.0
        assert client.latencies_s  # the client recorded the hop
    finally:
        decode.close()
        prefill.close()


def test_disagg_token_identity_speculative(registry, spec_servers,
                                           spec_singles):
    srv = spec_servers["torch"]
    prefill, decode, _ = pair(srv)
    try:
        srv.reset_spec_stats()
        # greedy, no logprobs: the spec loop's own gate (spec_ready)
        assert run_one(decode, logprobs=False) == spec_singles["torch"]
        assert srv.spec_stats_snapshot()["verify_rounds"] > 0, (
            "disagg decode never entered the speculative verify loop"
        )
        assert wait_leases_drained(prefill)
    finally:
        decode.close()
        prefill.close()


def test_disagg_single_token_budget_skips_pool(registry, servers):
    """budget=1: the bundle's first token IS the whole completion —
    the decode side finishes without allocating a single page."""
    want = single_runs(servers["torch"], budget=1, n=1)[0]
    prefill, decode, _ = pair(servers["torch"])
    try:
        assert run_one(decode, budget=1) == want
        assert wait_leases_drained(prefill)
    finally:
        decode.close()
        prefill.close()


# ---------------------------------------------------------------------------
# across the packages: a reference replica on one side of the hop
# ---------------------------------------------------------------------------

def _assert_hops(registries, prefill_pkg, decode_pkg, n):
    """``n`` exports on the prefill side and ``n`` imports on the
    decode side: the requests crossed the hop, none fell back."""
    hops = "tpu_serve_handoff_total"
    assert counter(registries[prefill_pkg], hops, ("prefill", "export")) == n
    assert counter(registries[decode_pkg], hops, ("decode", "imported")) == n
    assert counter(registries[decode_pkg], hops, ("decode", "fallback")) == 0


def _assert_close(got, want):
    """Tokens identical, logprobs within LP_TOL."""
    assert [t for t, _ in got] == [t for t, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert len(g) == len(w)
        assert np.max(np.abs(np.subtract(g, w)), initial=0.0) <= LP_TOL


CROSS = [("jax", "torch"), ("torch", "jax")]
CROSS_IDS = ["jax_prefill_torch_decode", "torch_prefill_jax_decode"]


@pytest.mark.parametrize("prefill_pkg,decode_pkg", CROSS, ids=CROSS_IDS)
def test_cross_package_identity_with_prefix_hit(registries, servers,
                                                singles, prefill_pkg,
                                                decode_pkg):
    prefill, decode, _ = pair(servers[prefill_pkg], servers[decode_pkg])
    try:
        got = [run_one(decode), run_one(decode)]  # cold, then a hit
        for want in singles.values():
            _assert_close(got, want)
        _assert_hops(registries, prefill_pkg, decode_pkg, 2)
        assert wait_leases_drained(prefill)
    finally:
        decode.close()
        prefill.close()


@pytest.mark.parametrize("prefill_pkg,decode_pkg", CROSS, ids=CROSS_IDS)
def test_cross_package_identity_speculative(registries, servers,
                                            spec_servers, spec_singles,
                                            prefill_pkg, decode_pkg):
    srv = spec_servers[decode_pkg]
    prefill, decode, _ = pair(servers[prefill_pkg], srv)
    try:
        srv.reset_spec_stats()
        got = run_one(decode, logprobs=False)
        assert got == spec_singles["jax"] == spec_singles["torch"]
        assert srv.spec_stats_snapshot()["verify_rounds"] > 0
        _assert_hops(registries, prefill_pkg, decode_pkg, 1)
        assert wait_leases_drained(prefill)
    finally:
        decode.close()
        prefill.close()


# ---------------------------------------------------------------------------
# chaos: every fault point, two-run deterministic, nothing leaks
# ---------------------------------------------------------------------------

def _fault_scenario(server, plan_spec, client_kw=None, prefill_kw=None):
    """One run under an armed fault plan: a request through the disagg
    pair, then a second (clean-path) request. Returns the comparable
    outcome tuple; the pair is fully drained before it is torn down."""
    prefill, decode, client = pair(server, client_kw=client_kw,
                                   **(prefill_kw or {}))
    try:
        point = plan_spec.split("=", 1)[0]
        with faults.plan(plan_spec) as p:
            first = run_one(decode)
            fires = p.fires(point)
        second = run_one(decode)  # pool healthy after the fault
        leases_ok = wait_leases_drained(prefill, timeout=10.0)
    finally:
        decode.close()
        prefill.close()
    return first, second, fires, leases_ok


def test_handoff_send_fault_retries_then_succeeds(registry, servers,
                                                  singles):
    want1, want2 = singles["torch"]
    a = _fault_scenario(servers["torch"], "handoff.send=error:count=1")
    b = _fault_scenario(servers["torch"], "handoff.send=error:count=1")
    first, second, fires, leases_ok = a
    assert fires == 1
    assert first == want1 and second == want2  # retry inside fetch won
    assert leases_ok
    assert a == b  # two-run deterministic
    assert counter(registry, "tpu_serve_handoff_total",
                   ("decode", "ok")) == 4.0  # no fallback ever taken


def test_handoff_send_fault_exhausts_to_local_fallback(registry, servers,
                                                       singles):
    want1, want2 = singles["torch"]
    a = _fault_scenario(servers["torch"], "handoff.send=error:count=99")
    b = _fault_scenario(servers["torch"], "handoff.send=error:count=99")
    first, second, fires, leases_ok = a
    assert fires >= 3  # retries exhausted
    assert first == want1 and second == want2  # local re-prefill exact
    assert leases_ok  # prefill never exported: nothing to lease
    assert a == b
    assert counter(registry, "tpu_serve_handoff_total",
                   ("decode", "fallback")) == 2.0
    assert counter(registry, "tpu_serve_handoff_total",
                   ("decode", "error")) == 2.0


def test_handoff_recv_fault_falls_back(registry, servers, singles):
    want1, want2 = singles["torch"]
    a = _fault_scenario(servers["torch"], "handoff.recv=error:count=99")
    b = _fault_scenario(servers["torch"], "handoff.recv=error:count=99")
    first, second, fires, leases_ok = a
    assert fires >= 3
    assert first == want1 and second == want2
    assert leases_ok
    assert a == b
    assert counter(registry, "tpu_serve_handoff_total",
                   ("decode", "fallback")) == 2.0


def test_handoff_import_fault_orphans_lease_then_recovers(
        registry, servers, singles):
    """Pages exported and leased, import dies on the decode side. No
    ack may be sent (decode cannot prove the pages landed) — the
    prefill side reclaims via lease expiry, counted as an orphan, and
    the request completes via local re-prefill, bit-identical."""
    want1, want2 = singles["torch"]
    a = _fault_scenario(servers["torch"], "handoff.import=error:count=1",
                        prefill_kw={"lease_s": 0.3})
    b = _fault_scenario(servers["torch"], "handoff.import=error:count=1",
                        prefill_kw={"lease_s": 0.3})
    first, second, fires, leases_ok = a
    assert fires == 1
    assert first == want1 and second == want2
    assert leases_ok  # expiry reap cleared the orphaned lease
    assert a == b
    assert counter(registry, "tpu_serve_handoff_total",
                   ("decode", "import_error")) == 2.0
    assert counter(registry, "tpu_serve_handoff_orphans_total",
                   ("prefill",)) == 2.0  # one orphan per run


def test_breaker_opens_after_repeated_failures(registry, servers, singles):
    """With a 1-failure breaker, the first failed fetch opens the
    circuit: the next request short-circuits (outcome=breaker) without
    touching the wire, and still completes via local fallback."""
    breaker = CircuitBreaker(failure_threshold=1, reset_timeout_s=60.0)
    prefill, decode, _ = pair(
        servers["torch"], client_kw={"breaker": breaker, "deadline_s": 2.0})
    try:
        with faults.plan("handoff.send=error:count=99") as p:
            out1 = run_one(decode)
            sends_after_first = p.fires("handoff.send")
            out2 = run_one(decode)
            assert p.fires("handoff.send") == sends_after_first, (
                "open breaker must not touch the wire"
            )
        assert [out1, out2] == singles["torch"]
        assert counter(registry, "tpu_serve_handoff_total",
                       ("decode", "breaker")) == 1.0
        assert counter(registry, "tpu_serve_handoff_breaker_state",
                       ("inproc",)) == 1.0  # open
    finally:
        decode.close()
        prefill.close()


def test_handle_prefill_rejects_malformed_payloads(servers):
    prefill = paged(servers["torch"], role="prefill")
    prefill.warmup()
    try:
        for bad in (
            {},                                      # no tokens
            {"tokens": [], "max_new_tokens": 4},     # empty prompt
            {"tokens": ["x"], "max_new_tokens": 4},  # non-int tokens
            {"tokens": [1, 2], "max_new_tokens": 0},  # no budget
            {"tokens": [1, 2], "max_new_tokens": 4, "slo": "warp"},
        ):
            with pytest.raises(kv_handoff.HandoffRejected):
                prefill.handle_prefill(bad)
        assert prefill.leases.pending() == 0
    finally:
        prefill.close()


# ---------------------------------------------------------------------------
# the real wire: serve_http routes + HTTPTransport
# ---------------------------------------------------------------------------

def _post_status(url, body: bytes) -> int:
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10)
    ei.value.close()
    return ei.value.code


def test_http_wire_end_to_end_identity(registry, servers, singles):
    srv = servers["torch"]
    prefill = paged(srv, role="prefill")
    prefill.warmup()
    Handler = serve_http.make_handler(srv, prefill, role="prefill")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    port = httpd.server_address[1]
    serving = threading.Thread(target=httpd.serve_forever, daemon=True)
    serving.start()
    client = kv_handoff.HandoffClient(
        kv_handoff.HTTPTransport(f"http://127.0.0.1:{port}"),
        peer=f"127.0.0.1:{port}",
    )
    decode = paged(srv, role="decode", handoff_client=client)
    decode.warmup()
    try:
        assert run_one(decode) == singles["torch"][0]
        assert wait_leases_drained(prefill)
        # a completions request on the prefill replica is a routing
        # bug: clean retryable 503, not a hang
        assert _post_status(
            f"http://127.0.0.1:{port}/v1/completions",
            json.dumps({"prompt": "hi", "max_tokens": 2}).encode()) == 503
        # malformed handoff payload -> 400, the do-not-retry contract
        assert _post_status(f"http://127.0.0.1:{port}/v1/handoff/prefill",
                            b'{"tokens": []}') == 400
    finally:
        decode.close()
        prefill.close()
        httpd.shutdown()
        httpd.server_close()
        serving.join(timeout=10)
    assert not serving.is_alive()


# ---------------------------------------------------------------------------
# drain with a PENDING handoff (tests/test_chaos.py): a prefill replica
# that exported pages but never saw the decode ack still shuts down with
# zero leaked leases
# ---------------------------------------------------------------------------

def _drain_pending_handoff_scenario(srv, lease_s, drain_timeout):
    reg = obs_metrics.MetricsRegistry()
    obs_metrics.install(reg)
    try:
        batcher = tserve.ContinuousBatcher(
            srv, max_batch=2, segment_tokens=4, kv_mode="paged",
            page_tokens=8, prefill_chunk=16, seed=7, role="prefill",
            lease_s=lease_s)
        raw = batcher.handle_prefill(
            {"tokens": [(i * 7 + 3) % 128 for i in range(20)],
             "max_new_tokens": 4},
            timeout_s=120,
        )
        exported = batcher.leases.pending()  # never acked by anyone
        drained = batcher.drain(timeout=drain_timeout)
        orphans = reg.counter(
            "tpu_serve_handoff_orphans_total", labels=("side",),
        ).value(side="prefill")
        return (exported, drained, batcher.leases.pending(),
                len(raw) > 8, orphans)
    finally:
        obs_metrics.uninstall()


def test_drain_with_pending_handoff_reclaims_lease(servers):
    # Lease shorter than the drain window: the engine's reap tick
    # expires it mid-drain, so drain itself succeeds.
    first = _drain_pending_handoff_scenario(
        servers["torch"], lease_s=0.3, drain_timeout=30.0)
    second = _drain_pending_handoff_scenario(
        servers["torch"], lease_s=0.3, drain_timeout=30.0)
    exported, drained, pending, got_bundle, orphans = first
    assert exported == 1 and got_bundle
    assert drained, "expired lease should unblock the drain window"
    assert pending == 0
    assert orphans == 1.0  # the reclaim is visible, not silent
    assert first == second  # two-run deterministic


def test_drain_window_closing_force_releases_pending_lease(servers):
    # Lease far longer than the window: drain reports failure, but the
    # batcher still force-releases the lease on the way out.
    first = _drain_pending_handoff_scenario(
        servers["torch"], lease_s=60.0, drain_timeout=0.5)
    second = _drain_pending_handoff_scenario(
        servers["torch"], lease_s=60.0, drain_timeout=0.5)
    exported, drained, pending, got_bundle, orphans = first
    assert exported == 1 and got_bundle
    assert not drained, "an unacked 60s lease cannot drain in 0.5s"
    assert pending == 0  # force-released, not leaked
    assert orphans == 1.0
    assert first == second


def _engine_threads():
    return {t for t in threading.enumerate() if t.name == "llm-serve-engine"}


def test_engine_thread_ends_once_closed_and_idle(servers):
    """A closed prefill batcher keeps its engine thread while a lease is
    pending (the thread reaps it), refuses new submits, and the thread
    ends once the ack is reaped."""
    before = _engine_threads()
    prefill = paged(servers["torch"], role="prefill", lease_s=60.0)
    (thread,) = _engine_threads() - before
    wire = prefill.handle_prefill({"tokens": PROMPT, "max_new_tokens": 4},
                                  timeout_s=120)
    prefill.close()
    with pytest.raises(tserve.ServerClosingError):
        prefill.submit_async(PROMPT, 2)
    thread.join(timeout=0.5)
    assert thread.is_alive() and prefill.leases.pending() == 1
    assert prefill.handle_ack(
        kv_handoff.PageBlockBundle.from_bytes(wire).lease_id)
    thread.join(timeout=10)
    assert not thread.is_alive()
    assert prefill.leases.pending() == 0


# ---------------------------------------------------------------------------
# the CLI: the reference's flags and parser errors, two daemons
# ---------------------------------------------------------------------------

def test_role_flags_and_parser_errors(capsys):
    parse = serve_http.build_arg_parser().parse_args
    args = parse(["--role", "decode", "--handoff-peer", "http://p:1"])
    assert (args.role, args.handoff_peer) == ("decode", "http://p:1")
    assert parse([]).role == "both"
    for argv, msg in (
        (["--role", "decode"], "--role decode requires --handoff-peer"),
        (["--role", "prefill", "--kv-cache", "rows"],
         "--role prefill/decode requires --batching continuous and "
         "--kv-cache paged"),
    ):
        with pytest.raises(SystemExit) as ei:
            serve_http.main(argv)
        assert ei.value.code == 2
        assert msg in capsys.readouterr().err
    _assert_batcher_refuses("prefill", "rows", "paged-KV feature")
    _assert_batcher_refuses("decode", "paged", "requires a handoff_client")
    _assert_batcher_refuses("relay", "paged", "unknown role")


def _assert_batcher_refuses(role, kv_mode, match):
    """The batcher refuses ``role`` before starting its engine thread (a
    stub server: only the fields __init__ reads); the half-built batcher
    is closed."""
    class _Srv:
        config = tt.LMConfig(**TINY)
        spec_k = None
        _bucket = staticmethod(tserve.LMServer._bucket)

    b = tserve.ContinuousBatcher.__new__(tserve.ContinuousBatcher)
    try:
        with pytest.raises(ValueError, match=match):
            b.__init__(_Srv(), kv_mode=kv_mode, role=role)
    finally:
        b.close()


class _Daemon:
    """serve_http.main in a thread on an ephemeral port."""

    def __init__(self, argv):
        ready = threading.Event()
        self.rc = {}

        def on_ready(httpd, batcher):
            self.httpd, self.batcher = httpd, batcher
            ready.set()

        self.thread = threading.Thread(target=lambda: self.rc.setdefault(
            "rc", serve_http.main(["--tiny", "--device", "cpu", "--port",
                                   "0", "--max-batch", "2",
                                   "--segment-tokens", "4",
                                   "--kv-page-tokens", "8",
                                   "--prefill-chunk", "16", *argv],
                                  on_ready=on_ready)), daemon=True)
        self.thread.start()
        assert ready.wait(120), "daemon did not come up"
        self.port = self.httpd.server_address[1]

    def stop(self):
        self.httpd.shutdown()
        self.thread.join(timeout=60)
        assert not self.thread.is_alive() and self.rc["rc"] == 0


def test_cli_prefill_and_decode_daemons(registry):
    """``--role prefill`` and ``--role decode --handoff-peer`` in bf16
    (the tiny config's dtype) over HTTP: the decode daemon's completion
    equals a single daemon's, through one export and one import."""
    body = json.dumps({"prompt": "the quick brown fox jumps over it",
                       "max_tokens": 5, "logprobs": 1}).encode()

    def complete(port):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/completions", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            doc = json.loads(resp.read())
        return doc["choices"][0]["text"], \
            doc["choices"][0]["logprobs"]["token_logprobs"]

    single = _Daemon([])
    try:
        want = complete(single.port)
    finally:
        single.stop()
    prefill = _Daemon(["--role", "prefill"])
    try:
        decode = _Daemon(["--role", "decode", "--handoff-peer",
                          f"http://127.0.0.1:{prefill.port}"])
        try:
            assert decode.batcher.role == "decode"
            assert complete(decode.port) == want
            assert wait_leases_drained(prefill.batcher)
        finally:
            decode.stop()
    finally:
        prefill.stop()
    assert counter(registry, "tpu_serve_handoff_total",
                   ("prefill", "export")) == 1.0
    assert counter(registry, "tpu_serve_handoff_total",
                   ("decode", "imported")) == 1.0
