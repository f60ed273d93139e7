"""The port's speculative decoding against the JAX reference's.

A JAX ``LMServer`` and the port's on the CPU, at the tiny float32 config
of tests/test_speculative.py (vocab 128, 3 layers, 4 heads, embed 32,
mlp 64, seq 64) with the same parameters (models/params.py), decode the
cases of that file through ``complete_batch_spec``, the rows
``ContinuousBatcher`` and the paged engine. Required: tokens identical
to the reference's speculative output and to the port's plain path;
``verify_rounds`` equal to the reference's on sequential calls; and, for
the paged engines stepped by hand (the harness of
tests/test_torch_paged_engine.py), equal ``tpu_serve_kv_*`` and
``tpu_serve_speculative_*`` counters. Then the self-draft's storage
sharing, the ``ValueError``s, the two CLI flags and the ``/healthz``
block. Tokens are asserted, never timings.
"""

import json
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.models import kv_cache as jkv
from k8s_device_plugin_tpu.models import serve as jserve
from k8s_device_plugin_tpu.models import serve_batch as jbatch
from k8s_device_plugin_tpu.models import serve_http as jhttp
from k8s_device_plugin_tpu.models import speculative as jspec
from k8s_device_plugin_tpu.models import transformer as jt
from k8s_device_plugin_tpu.obs import metrics as jmetrics
from k8s_device_plugin_tpu_torch.models import kv_cache as tkv
from k8s_device_plugin_tpu_torch.models import serve as tserve
from k8s_device_plugin_tpu_torch.models import serve_batch as tbatch
from k8s_device_plugin_tpu_torch.models import serve_http as thttp
from k8s_device_plugin_tpu_torch.models import speculative as tspec
from k8s_device_plugin_tpu_torch.models import transformer as tt
from k8s_device_plugin_tpu_torch.models.params import params_from_jax
from k8s_device_plugin_tpu_torch.obs import metrics as tmetrics

TINY = dict(vocab_size=128, num_layers=3, num_heads=4, embed_dim=32,
            mlp_dim=64, max_seq_len=64)
LLAMA = dict(TINY, num_layers=4, num_kv_heads=2, position="rope",
             mlp_act="swiglu")
JOBS = [([5, 17, 99], 7), ([7, 3, 42, 11], 23), ([1], 4), ([88, 2], 12)]
EDGE_PROMPT = list(range(1, 53))      # 52 tokens + budget 12 fill seq 64
PACKAGES = {
    "jax": (jserve, jbatch, jkv, jmetrics),
    "torch": (tserve, tbatch, tkv, tmetrics),
}
COUNTERS = (
    ("tpu_serve_kv_prefix_lookups_total", ("outcome",), ("hit", "miss")),
    ("tpu_serve_kv_prefix_tokens_reused_total", (), ()),
    ("tpu_serve_kv_page_copies_total", (), ()),
    ("tpu_serve_speculative_tokens_total", (), ()),
    ("tpu_serve_speculative_verify_rounds_total", (), ()),
)


def make_pair(kw, layers, k):
    """A JAX server and the port's with the JAX one's parameters, each
    with a ``layers``-layer self-draft at ``k``."""
    jsrv = jserve.LMServer(config=jt.LMConfig(**kw, dtype=jnp.float32))
    ct = tt.LMConfig(**kw, dtype=torch.float32)
    tsrv = tserve.LMServer(config=ct, device="cpu", params=params_from_jax(
        jax.tree_util.tree_map(np.asarray, jsrv.params), ct))
    pair = {"jax": jsrv, "torch": tsrv}
    return drafted(pair, layers, k)


def drafted(pair, layers, k):
    """A ``layers``-layer self-draft at ``k`` on both servers, stats
    reset. Enabled anew only when it changes: a new draft drops the
    reference's compiled spec loops."""
    for srv in pair.values():
        draft = getattr(srv, "draft_config", None)
        if (srv.spec_k, getattr(draft, "num_layers", None)) != (k, layers) \
                or draft == srv.config:
            srv.enable_draft(layers, k=k)
        srv.reset_spec_stats()
    return pair


def perfect(pair):
    """Draft == target on both (the reference's perfect_draft_server):
    every proposal matches, so rounds accept k tokens and overshoot the
    budget."""
    jsrv, tsrv = pair["jax"], pair["torch"]
    jsrv.draft_params = jspec.draft_params_from_target(
        jsrv.params, jsrv.config.num_layers)
    jsrv.draft_config, jsrv.draft_model = jsrv.config, jsrv.model
    tsrv.draft_config, tsrv.draft_model = tsrv.config, tsrv.model
    for srv in pair.values():
        srv._spec_cache.clear()
        srv.reset_spec_stats()
    return pair


@pytest.fixture(scope="module")
def pair():
    return make_pair(TINY, 1, 3)


@pytest.fixture(scope="module")
def perfect_pair():
    return perfect(make_pair(dict(TINY, num_layers=2), 1, 3))


def static(pair, prompts, budgets):
    """complete_batch_spec on both: {pkg: (tokens, verify_rounds)}."""
    out = {}
    for pkg, srv in pair.items():
        srv.reset_spec_stats()
        got, _ = srv.complete_batch_spec(prompts, budgets)
        out[pkg] = (got, srv.spec_stats_snapshot()["verify_rounds"])
    return out


def assert_static(pair, prompts, budgets):
    out = static(pair, prompts, budgets)
    plain, _ = pair["torch"].complete_batch(prompts, budgets)
    assert out["torch"][0] == out["jax"][0] == plain
    assert out["torch"][1] == out["jax"][1]
    return out["torch"]


# ---------------------------------------------------------------------------
# complete_batch_spec
# ---------------------------------------------------------------------------

# (draft layers, k, prompts, budgets): the reference's static cases, in
# an order that changes the draft least (each change recompiles the
# reference's spec loops).
STATIC_CASES = {
    "mixed_budgets": (1, 3, [p for p, _ in JOBS], [n for _, n in JOBS]),
    "budget1": (1, 3, [[3, 1]], [1]),
    "k2": (2, 2, [[9, 4, 7]], [15]),
    "k3": (2, 3, [[9, 4, 7]], [15]),
    "k5": (2, 5, [[9, 4, 7]], [15]),
    "capacity_edge": (1, 4, [list(range(1, 59))], [6]),
    "capacity_edge_mixed": (1, 4, [list(range(1, 59)), [5, 3]], [6, 6]),
}


@pytest.mark.parametrize("case", list(STATIC_CASES))
def test_complete_batch_spec_matches_reference_and_plain(pair, case):
    layers, k, prompts, budgets = STATIC_CASES[case]
    _, rounds = assert_static(drafted(pair, layers, k), prompts, budgets)
    if case.startswith("capacity_edge"):
        assert rounds == 0      # routed to the plain loop, exactly
    elif case != "budget1":
        assert rounds > 0


def test_spec_eos_truncates_identically(pair):
    drafted(pair, 1, 3)
    greedy = pair["torch"].complete([5, 17], 12)[0]
    saved = {pkg: srv.eos_id for pkg, srv in pair.items()}
    try:
        for srv in pair.values():
            srv.eos_id = greedy[4]  # a token the model emits mid-stream
        got, _ = assert_static(pair, [[5, 17]], [12])
        assert len(got[0]) < len(greedy)
    finally:
        for pkg, srv in pair.items():
            srv.eos_id = saved[pkg]


@pytest.mark.parametrize("budget", [5, 7, 11])
def test_perfect_draft_overshoots_the_budget_exactly(perfect_pair, budget):
    got, rounds = assert_static(perfect_pair, [[9, 4, 7]], [budget])
    assert 0 < rounds < budget - 1


def test_acceptance_telemetry(perfect_pair, pair):
    """A perfect draft approaches k tokens a verify round; a random
    1-layer draft stays near 1."""
    assert_static(perfect_pair, [[9, 4, 7]], [13])
    s = perfect_pair["torch"].spec_stats_snapshot()
    assert s["tokens"] == 12 and s["tokens"] / s["verify_rounds"] > 2.0
    drafted(pair, 1, 3)
    assert_static(pair, [[9, 4, 7]], [13])
    s = pair["torch"].spec_stats_snapshot()
    assert s["tokens"] / s["verify_rounds"] < 2.0


def test_spec_matches_reference_on_llama_class_config():
    """rope positions (no pos_embed in the draft), GQA 4/2, swiglu."""
    p = make_pair(LLAMA, 2, 3)
    assert_static(p, [list(range(1, 9)), [7, 5, 3]], [10, 10])


# ---------------------------------------------------------------------------
# the rows ContinuousBatcher
# ---------------------------------------------------------------------------

def _submit_all(eng, jobs, **kw):
    results = [None] * len(jobs)

    def run(i):
        results[i] = eng.submit(jobs[i][0], jobs[i][1], **kw)[0]

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return results


def _rows(pair, pkg):
    return PACKAGES[pkg][0].ContinuousBatcher(pair[pkg], max_batch=2,
                                              segment_tokens=4)


def test_rows_engine_spec_matches_reference_and_plain(pair):
    drafted(pair, 1, 3)
    want = [pair["torch"].complete(p, n)[0] for p, n in JOBS]
    got = {}
    for pkg in PACKAGES:
        eng = _rows(pair, pkg)
        got[pkg] = _submit_all(eng, JOBS)
        eng.close()
    assert got["torch"] == got["jax"] == want
    assert pair["torch"].spec_stats_snapshot()["verify_rounds"] > 0


def _mixed_pool(eng):
    """A greedy row, a top_k=1 row joining mid-decode (plain segments
    for that stretch), then a fresh all-greedy request."""
    out = {}

    def run_sampled():
        time.sleep(0.2)
        out["s"] = eng.submit([5, 17], 8, temperature=1.5, top_k=1)[0]

    t = threading.Thread(target=run_sampled)
    t.start()
    out["g"] = eng.submit([7, 3, 42], 30)[0]
    t.join(timeout=120)
    assert not t.is_alive()
    out["late"] = eng.submit([9, 4], 6)[0]
    return out


@pytest.mark.parametrize("perfect_draft", [False, True],
                         ids=["random_draft", "perfect_draft"])
def test_rows_engine_mixed_pool_switches_to_plain(pair, perfect_pair,
                                                  perfect_draft):
    p = perfect_pair if perfect_draft else drafted(pair, 1, 3)
    got = {}
    for pkg in PACKAGES:
        eng = _rows(p, pkg)
        got[pkg] = _mixed_pool(eng)
        eng.close()
    srv = p["torch"]
    assert got["torch"] == got["jax"] == {
        "g": srv.complete([7, 3, 42], 30)[0],
        "s": srv.complete([5, 17], 8)[0],
        "late": srv.complete([9, 4], 6)[0]}


# ---------------------------------------------------------------------------
# the paged engine, stepped by hand
# ---------------------------------------------------------------------------

def manual_paged(pkg, server, rows=2, segment=4, chunk=16):
    """A paged batcher with no engine thread; the test steps its
    ``_PagedEngine`` itself (tests/test_torch_paged_engine.py)."""
    serve, batch, kv, _ = PACKAGES[pkg]
    b = serve.ContinuousBatcher.__new__(serve.ContinuousBatcher)
    batch._BatcherBase.__init__(b, server, seed=0, max_pending=0)
    b.rows, b.segment, b.chunk = rows, segment, chunk
    b.kv_mode, b._auto = "paged", False
    seq = server.config.max_seq_len
    b.kv_config = kv.KVPageConfig(
        8, kv.page_config_from_env(seq, rows, 8).pool_pages, seq)
    return b, batch._PagedEngine(b)


def step(b, eng):
    """One ``_loop_paged`` iteration after admission: a prefill chunk,
    then a speculative segment when ``spec_ready`` holds, else a plain
    one. Returns the kind of segment run."""
    if eng.filling:
        eng.prefill_chunk_step(b._next_key())
    if not eng.live:
        return None
    if eng.spec_ready():
        eng.spec_segment_step()
        return "spec"
    eng.decode_segment_step(b._next_key())
    return "plain"


def run_paged(b, eng, groups):
    """Each group admitted after ``after`` steps of the previous ones;
    stepped until all finish. Returns (tokens in job order, kinds)."""
    reqs, kinds = [], []
    for after, jobs, kw in groups:
        for _ in range(after):
            kinds.append(step(b, eng))
        for p, n in jobs:
            reqs.append(b.submit_async(p, n, **kw))
            eng.admit(b.q.get_nowait())
    for _ in range(300):
        if all(r.done.is_set() for r in reqs):
            break
        kinds.append(step(b, eng))
    return ([b.wait(r, timeout=1)[0] for r in reqs],
            [k for k in kinds if k is not None])


PREFIX = [(i * 5 + 1) % 128 for i in range(24)]   # 3 full pages of 8
# (fixture, (draft layers, k) or None to keep it, rows, groups): the
# reference's paged spec tests; a group is (steps before, jobs, submit
# keywords).
PAGED_CASES = {
    "matches_plain": ("pair", (1, 3), 4, [(0, JOBS, {})]),
    "topk1": ("pair", (1, 3), 2, [
        (0, [([9, 4, 7], 11)], {}),
        (6, [([9, 4, 7], 11)], dict(temperature=2.0, top_k=1))]),
    "mixed_pool": ("pair", (1, 3), 2, [
        (0, [([7, 3, 42], 30)], {}),
        (2, [([5, 17], 8)], dict(temperature=1.5, top_k=1)),
        (12, [([9, 4], 6)], {})]),
    "shared_prefix": ("pair", (1, 3), 2, [
        (0, [(PREFIX + [7, 9], 8)], {}),
        (8, [(PREFIX + [11, 13], 8)], {})]),
    "full_acceptance_overshoot": ("perfect_pair", None, 2,
                                  [(0, [([88, 2], 12)], {})]),
    "capacity_edge": ("pair", (1, 4), 2, [(0, [(EDGE_PROMPT, 12)], {})]),
}


def _counters(reg):
    out = {}
    for name, labels, values in COUNTERS:
        c = reg.counter(name, labels=labels)
        for v in values or (None,):
            got = c.value(**{labels[0]: v}) if labels else c.value()
            out[f"{name}{{{v}}}" if v else name] = got
    return out


@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_engine_spec_matches_reference(request, case):
    fixture, draft, rows, groups = PAGED_CASES[case]
    p = request.getfixturevalue(fixture)
    if draft is not None:
        drafted(p, *draft)
    results = {}
    for pkg in PACKAGES:
        metrics = PACKAGES[pkg][3]
        reg = metrics.MetricsRegistry()
        metrics.install(reg)
        try:
            b, eng = manual_paged(pkg, p[pkg], rows=rows)
            toks, kinds = run_paged(b, eng, groups)
            results[pkg] = (toks, kinds, _counters(reg))
            b.close()
        finally:
            metrics.uninstall()
    got, want = results["torch"], results["jax"]
    assert got[0] == want[0]
    assert got[1] == want[1]            # the same spec / plain schedule
    assert got[2] == want[2]            # kv and speculative counters
    plain = [p["torch"].complete(pr, n)[0]
             for _, jobs, _ in groups for pr, n in jobs]
    assert got[0] == plain
    rounds = got[2]["tpu_serve_speculative_verify_rounds_total"]
    assert "spec" in got[1] and rounds > 0
    if case in ("topk1", "mixed_pool", "capacity_edge"):
        assert "plain" in got[1]
    if case == "shared_prefix":
        assert got[2]["tpu_serve_kv_prefix_lookups_total{hit}"] == 1
    if case == "full_acceptance_overshoot":
        assert got[2]["tpu_serve_speculative_tokens_total"] / rounds > 2


@pytest.mark.parametrize("case", ["capacity_edge", "full_acceptance",
                                  "full_acceptance_to_plain"])
def test_rows_engine_single_jobs_match_reference(pair, perfect_pair, case):
    """One job at a time: tokens and verify rounds equal the
    reference's. The capacity edge and a perfect draft ending on it run
    plain segments for the last stretch."""
    if case == "capacity_edge":
        p, job = drafted(pair, 1, 4), (EDGE_PROMPT, 12)
    elif case == "full_acceptance":
        p, job = perfect_pair, ([88, 2], 12)
    else:
        p, job = perfect_pair, (EDGE_PROMPT, 12)
    got = {}
    for pkg, srv in p.items():
        srv.reset_spec_stats()
        eng = _rows(p, pkg)
        got[pkg] = (eng.submit(*job)[0],
                    srv.spec_stats_snapshot()["verify_rounds"])
        eng.close()
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == p["torch"].complete(*job)[0]
    assert got["torch"][1] > 0


def test_paged_engine_spec_identical_to_plain_paged_engine(pair):
    """The reference's acceptance wording: greedy and top_k=1 requests
    through a paged engine with a draft equal a plain paged engine (no
    draft) on the same weights."""
    ct = pair["torch"].config
    plain_srv = tserve.LMServer(
        config=ct, device="cpu",
        params={k: v.clone() for k, v in
                pair["torch"].model.state_dict().items()})
    jobs = [(0, [([9, 4, 7], 11)], {}),
            (6, [([9, 4, 7], 11)], dict(temperature=2.0, top_k=1))]
    b, eng = manual_paged("torch", plain_srv)
    want, kinds = run_paged(b, eng, jobs)
    b.close()
    assert set(kinds) == {"plain"}
    b, eng = manual_paged("torch", drafted(pair, 1, 3)["torch"])
    got, kinds = run_paged(b, eng, jobs)
    b.close()
    assert got == want and "spec" in kinds


# ---------------------------------------------------------------------------
# the self-draft shares storage
# ---------------------------------------------------------------------------

def test_draft_pages_alias_the_pool():
    srv = tserve.LMServer(config=tt.LMConfig(**TINY, dtype=torch.float32),
                          device="cpu")
    pool = srv.make_paged_pool(pool_pages=8, page_tokens=4)
    draft = tspec.draft_pages_from_target(pool, 2)
    assert len(draft.k_pages) == len(draft.v_pages) == 2
    for mine, theirs in ((draft.k_pages, pool.k_pages),
                         (draft.v_pages, pool.v_pages)):
        for a, b in zip(mine, theirs):
            assert a is b and a.data_ptr() == b.data_ptr()


def test_draft_rows_cache_is_a_copy():
    cfg = tt.LMConfig(**TINY, dtype=torch.float32)
    cache = tt.set_cache_index(tt.new_cache(cfg, 2, "cpu"),
                               torch.tensor([3, 5]))
    for t in cache.k + cache.v:
        t.normal_()
    draft = tspec.draft_cache_from_target(cache, 2)
    assert len(draft.k) == len(draft.v) == 2
    for a, b in zip(draft.k + draft.v, cache.k[:2] + cache.v[:2]):
        assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)
    assert draft.idx.data_ptr() != cache.idx.data_ptr()
    assert torch.equal(draft.idx, cache.idx)


def test_draft_shares_the_targets_parameters_and_matches_reference(pair):
    drafted(pair, 2, 3)
    jsrv, tsrv = pair["jax"], pair["torch"]
    draft = tsrv.draft_model
    assert draft.cfg.num_layers == len(draft.layers) == 2
    target = {p.data_ptr() for p in tsrv.model.parameters()}
    params = list(draft.parameters())
    assert params and all(p.device.type == "cpu" for p in params)
    assert {p.data_ptr() for p in params} <= target
    assert draft.embed is tsrv.model.embed
    assert draft.layers[1] is tsrv.model.layers[1]
    assert draft.lm_head is tsrv.model.lm_head
    assert set(jsrv.draft_params) == {"embed", "pos_embed", "layer0",
                                      "layer1", "ln_f", "lm_head"}
    toks = np.array([[5, 17, 99, 3], [1, 2, 3, 4]], np.int32)
    want = jax.jit(jt.DecoderLM(jsrv.draft_config).apply)(
        {"params": jsrv.draft_params}, jnp.asarray(toks))
    with torch.inference_mode():
        got = draft(torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# ---------------------------------------------------------------------------
# errors, flags, /healthz
# ---------------------------------------------------------------------------

def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("what", ["draft_layers", "k", "spec_loop",
                                  "paged_spec_loop", "rows_chunk"])
def test_value_errors_match_reference(pair, what):
    calls = {
        "draft_layers": lambda pkg: lambda: pair[pkg].enable_draft(99),
        "k": lambda pkg: lambda: pair[pkg].enable_draft(1, k=1),
        "spec_loop": lambda pkg: lambda: (
            jspec if pkg == "jax" else tspec).make_spec_loop(None, None,
                                                             1, 8),
        "paged_spec_loop": lambda pkg: lambda: (
            jspec if pkg == "jax" else tspec).make_paged_spec_loop(
                None, None, 1, 8, 1),
        "rows_chunk": lambda pkg: lambda: PACKAGES[pkg][0].ContinuousBatcher(
            pair[pkg], max_batch=2, segment_tokens=4, kv_mode="rows",
            prefill_chunk=32),
    }
    drafted(pair, 1, 3)
    want = _message(calls[what]("jax"))
    assert _message(calls[what]("torch")) == want
    assert {"draft_layers": "draft layers", "k": ">= 2",
            "spec_loop": ">= 2", "paged_spec_loop": ">= 2",
            "rows_chunk": "paged-KV feature"}[what] in want


def test_flags_match_reference():
    mine = {a.dest: a for a in thttp.build_arg_parser()._actions}
    ref = {a.dest: a for a in jhttp.build_arg_parser()._actions}
    for dest, default in (("draft_layers", 0), ("speculative_k", 4)):
        assert mine[dest].default == ref[dest].default == default
        assert mine[dest].help == ref[dest].help
        assert mine[dest].option_strings == ref[dest].option_strings


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return resp.status, resp.read().decode()


def test_daemon_serves_speculative_healthz_and_metrics():
    ready = threading.Event()
    handle = {}

    def on_ready(httpd, batcher):
        handle["httpd"] = httpd
        ready.set()

    rc = {}
    daemon = threading.Thread(target=lambda: rc.setdefault(
        "rc", thttp.main(
            ["--tiny", "--device", "cpu", "--port", "0", "--max-batch",
             "2", "--segment-tokens", "4", "--kv-page-tokens", "8",
             "--prefill-chunk", "16", "--draft-layers", "1",
             "--speculative-k", "3"], on_ready=on_ready)),
        daemon=True)
    daemon.start()
    assert ready.wait(120), "daemon did not come up"
    port = handle["httpd"].server_address[1]
    try:
        _, body = _get(port, "/healthz")
        assert json.loads(body)["speculative"] == {
            "tokens": 0, "verify_rounds": 0,
            "tokens_per_verify_round": None}   # warmup reset them
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/completions",
            data=json.dumps({"prompt": "hello", "max_tokens": 9}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200
            doc = json.loads(resp.read())
        assert doc["usage"]["completion_tokens"] == 9
        code, body = _get(port, "/healthz")
        spec = json.loads(body)["speculative"]
        assert code == 200
        assert set(spec) == {"tokens", "verify_rounds",
                             "tokens_per_verify_round"}
        assert spec["tokens"] == 8 and spec["verify_rounds"] > 0
        assert spec["tokens_per_verify_round"] == round(
            8 / spec["verify_rounds"], 2)
        _, text = _get(port, "/metrics")
        for fam in ("tpu_serve_speculative_tokens_total",
                    "tpu_serve_speculative_verify_rounds_total",
                    "tpu_serve_speculative_accept_ratio"):
            assert f"# TYPE {fam} " in text
        assert 'fn="paged_spec_loop"' in text
    finally:
        handle["httpd"].shutdown()
        daemon.join(timeout=60)
    assert not daemon.is_alive() and rc["rc"] == 0


def test_perfect_draft_accepts_k_tokens_a_round(perfect_pair):
    p = perfect(drafted(perfect_pair, 1, 4))
    _, rounds = assert_static(p, [[2, 7, 1]], [13])
    assert rounds == 3          # 12 tokens at 4 a round
