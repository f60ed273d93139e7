"""The port's paged KV layer against the JAX reference's, on the CPU.

- The plain paged read (``ops/paged_attention.paged_attention_reference``,
  what the CPU runs and what kernel B2 is held to on the card) against
  the reference's ``_paged_attention_fused`` and
  ``_paged_attention_gather`` on the same numpy-seeded q, pools and
  tables: MHA, GQA and MQA, float32 within 1e-5, bfloat16 within 2e-2
  (both sides round the scores and probabilities to bf16, in different
  summation orders).
- The paged forward of the whole model (writes through the table, then
  the read) with learned and rope positions over the geometries of
  tests/test_paged_attention.py: logits and every layer's pool within
  1e-5 in float32.
- One chunked-prefill program of the engines: the same sampled tokens,
  and pool pages equal within 1e-5, so KV pages mean the same thing in
  both packages.
- The port's first-call counter stays flat under steady mixed-length
  traffic after warmup (the port's form of the reference's
  ``test_decode_compile_counter_flat_steady_state``).
- The CLI defaults to ``--kv-cache paged`` with the reference's paged
  flags, and the paged daemon answers the completions API with the
  reference's JSON keys and the ``tpu_serve_kv_*`` metric families.
"""

import json
import threading
import urllib.request

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
    ContinuousBatcher,
    LMServer,
)
from k8s_device_plugin_tpu_torch.obs import metrics as tmetrics
from k8s_device_plugin_tpu_torch.ops.paged_attention import paged_attention

_KW = dict(vocab_size=64, num_layers=2, num_heads=4, embed_dim=32,
           mlp_dim=64, max_seq_len=64)


def _scenario():
    """tests/test_paged_attention.py's geometry: row 0's 4-token block
    straddles a page boundary (lens 6, P 8), row 1 is a long resident
    row, row 2 a padding row whose table is all scratch page 0."""
    bt = np.zeros((3, 4), np.int32)
    bt[0, :2] = (1, 2)
    bt[1, :3] = (3, 4, 5)
    lens = np.array([6, 17, 1], np.int32)
    toks = (np.arange(12).reshape(3, 4) % 64).astype(np.int32)
    return bt, lens, toks


def _jax_attention(num_kv_heads, dtype):
    return jt.Attention(jt.LMConfig(**_KW, dtype=dtype,
                                    num_kv_heads=num_kv_heads))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("num_kv_heads", [4, 2, 1])  # MHA, GQA, MQA
def test_paged_read_matches_reference_fused_and_gather(num_kv_heads, dtype,
                                                       tol):
    rng = np.random.default_rng(num_kv_heads)
    bt, lens, _ = _scenario()
    L, d = 4, 8
    q = rng.standard_normal((3, L, 4, d), dtype=np.float32)
    pools = [rng.standard_normal((16, 8, num_kv_heads, d), dtype=np.float32)
             for _ in range(2)]
    q_pos = (lens[:, None] + np.arange(L)).astype(np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    got = paged_attention(
        torch.from_numpy(q).to(tdt),
        *(torch.from_numpy(p).to(tdt) for p in pools),
        torch.from_numpy(bt), torch.from_numpy(q_pos)).float().numpy()
    att = _jax_attention(num_kv_heads, jdt)
    args = [jnp.asarray(q, jdt), *(jnp.asarray(p, jdt) for p in pools),
            jnp.asarray(bt), jnp.asarray(q_pos)]
    for read in (att._paged_attention_fused, att._paged_attention_gather):
        want = np.asarray(read(*args).astype(jnp.float32))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def _pool_arrays(cfg, pool_pages=16, page_tokens=8, seed=1):
    """[layer] -> (k_pages, v_pages) numpy arrays from a seed."""
    rng = np.random.default_rng(seed)
    shape = (pool_pages, page_tokens, cfg.kv_heads,
             cfg.embed_dim // cfg.num_heads)
    return [(rng.standard_normal(shape, dtype=np.float32),
             rng.standard_normal(shape, dtype=np.float32))
            for _ in range(cfg.num_layers)]


@pytest.mark.parametrize("position", ["learned", "rope"])
@pytest.mark.parametrize("num_kv_heads", [0, 2, 1])  # MHA, GQA, MQA
def test_paged_forward_matches_reference(position, num_kv_heads):
    jcfg = jt.LMConfig(**_KW, dtype=jnp.float32, position=position,
                       num_kv_heads=num_kv_heads)
    tcfg = tt.LMConfig(**_KW, dtype=torch.float32, position=position,
                       num_kv_heads=num_kv_heads)
    params = jax.jit(jt.DecoderLM(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    arrays = _pool_arrays(jcfg)
    bt, lens, toks = _scenario()
    logits, variables = jt.DecoderLM(jcfg).apply(
        {"params": params, "cache": {
            f"layer{i}": {"attn": {"k_pages": jnp.asarray(k),
                                   "v_pages": jnp.asarray(v)}}
            for i, (k, v) in enumerate(arrays)}},
        jnp.asarray(toks), decode=True,
        pages=(jnp.asarray(bt), jnp.asarray(lens)), mutable=["cache"])
    model = tt.DecoderLM(tcfg)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg))
    pool = tt.PagedKV(
        k_pages=[torch.from_numpy(k.copy()) for k, _ in arrays],
        v_pages=[torch.from_numpy(v.copy()) for _, v in arrays])
    with torch.inference_mode():
        got = model(torch.from_numpy(toks).long(), pool, pages=(
            torch.from_numpy(bt).long(), torch.from_numpy(lens).long()))
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), atol=1e-5,
                               rtol=1e-5)
    for i in range(jcfg.num_layers):
        want = variables["cache"][f"layer{i}"]["attn"]
        for name, have in (("k_pages", pool.k_pages[i]),
                           ("v_pages", pool.v_pages[i])):
            np.testing.assert_allclose(have.numpy(), np.asarray(want[name]),
                                       atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def servers():
    kw = dict(_KW, vocab_size=128)
    jsrv = jserve.LMServer(config=jt.LMConfig(**kw, dtype=jnp.float32))
    ct = tt.LMConfig(**kw, dtype=torch.float32)
    tsrv = LMServer(config=ct, device="cpu", params=params_from_jax(
        jax.tree_util.tree_map(np.asarray, jsrv.params), ct))
    return jsrv, tsrv


def test_prefill_chunk_pool_pages_equal_reference(servers):
    """One chunked-prefill program of each engine on fresh pools: two
    rows at positions 0 and 5 through their tables (row 1 starts inside
    its second page), a padding row on the scratch page."""
    jsrv, tsrv = servers
    rows, chunk, page_tokens = 3, 16, 8
    rng = np.random.default_rng(4)
    toks = rng.integers(1, 128, (rows, chunk)).astype(np.int32)
    bt = np.zeros((rows, 4), np.int32)
    bt[0, :2] = (3, 1)
    bt[1, :3] = (2, 5, 4)
    lens = np.array([0, 5, 0], np.int32)
    last = np.array([chunk - 1, 10, 0], np.int32)
    zf, zi = np.zeros(rows, np.float32), np.zeros(rows, np.int32)
    jpool, jtok, jlp = jsrv.paged_prefill_chunk(
        jsrv.make_paged_pool(8, page_tokens), toks, bt, lens, last,
        jax.random.PRNGKey(0), zf, zi)
    tpool, ttok, tlp = tsrv.paged_prefill_chunk(
        tsrv.make_paged_pool(8, page_tokens), toks, bt, lens, last,
        tsrv.generator(0), zf, zi)
    assert list(ttok) == list(np.asarray(jtok))
    np.testing.assert_allclose(tlp, np.asarray(jlp), atol=1e-4)
    for i in range(jsrv.config.num_layers):
        want = jpool[f"layer{i}"]["attn"]
        np.testing.assert_allclose(tpool.k_pages[i].numpy(),
                                   np.asarray(want["k_pages"]), atol=1e-5)
        np.testing.assert_allclose(tpool.v_pages[i].numpy(),
                                   np.asarray(want["v_pages"]), atol=1e-5)


def submit_all(batcher, jobs):
    reqs = [batcher.submit_async(p, n) for p, n in jobs]
    return [batcher.wait(r, timeout=120)[0] for r in reqs]


def test_first_call_counter_flat_under_steady_traffic(servers):
    """After warmup, mixed prompt lengths and budgets run no program
    shape for the first time: every shape is bucketed (chunk length,
    page-table width, segment)."""
    ct = servers[1].config
    reg = tmetrics.MetricsRegistry()
    tmetrics.install(reg)
    try:
        srv = LMServer(config=ct, device="cpu",
                       params=servers[1].model.state_dict())
        eng = ContinuousBatcher(srv, max_batch=2, segment_tokens=4,
                                kv_mode="paged", page_tokens=8,
                                prefill_chunk=16)
        eng.warmup()
        c = reg.counter("tpu_serve_jit_compiles_total", labels=("fn",))

        def total():
            return sum(c.value(fn=fn) for fn in
                       ("paged_prefill", "paged_segment", "page_copy"))

        for ln, budget in ((3, 4), (17, 6), (30, 8), (45, 5)):
            submit_all(eng, [([(i * 13 + ln) % 128 for i in range(ln)],
                              budget)])
        before = total()
        assert before > 0
        for ln, budget in ((5, 7), (21, 3), (38, 9), (47, 4), (12, 11)):
            submit_all(eng, [([(i * 29 + ln) % 128 for i in range(ln)],
                              budget)])
        assert total() == before
        assert eng.drain(timeout=30)
    finally:
        tmetrics.uninstall()


def test_cli_defaults_to_paged_like_the_reference():
    ours = serve_http.build_arg_parser()
    ref = jhttp.build_arg_parser()
    args = ours.parse_args([])
    assert args.kv_cache == "paged"
    for dest in ("kv_cache", "kv_page_tokens", "kv_pool_pages",
                 "prefill_chunk"):
        mine = next(a for a in ours._actions if a.dest == dest)
        theirs = next(a for a in ref._actions if a.dest == dest)
        assert (mine.default, mine.choices) == \
            (theirs.default, theirs.choices)
        # --prefill-chunk's help also names the speculative flags, which
        # come with ROADMAP A2.
        assert theirs.help.startswith(mine.help.rstrip(")"))
    assert ours.parse_args(["--kv-cache", "rows"]).kv_cache == "rows"


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return resp.status, resp.read().decode()


def _hits(metrics_text):
    for ln in metrics_text.splitlines():
        if ln.startswith('tpu_serve_kv_prefix_lookups_total{outcome="hit"}'):
            return float(ln.rsplit(" ", 1)[1])
    return 0.0


def test_paged_daemon_serves_the_reference_surface():
    """The daemon at its default KV layout: a completion with the
    reference's keys, a prefix hit for a repeated prompt, the paged
    metric families, /healthz, and a clean drain."""
    ready = threading.Event()
    handle = {}

    def on_ready(httpd, batcher):
        handle["httpd"], handle["batcher"] = httpd, batcher
        ready.set()

    rc = {}
    daemon = threading.Thread(target=lambda: rc.setdefault(
        "rc", serve_http.main(
            ["--tiny", "--device", "cpu", "--port", "0", "--max-batch",
             "2", "--segment-tokens", "4", "--kv-page-tokens", "8",
             "--prefill-chunk", "16"], on_ready=on_ready)),
        daemon=True)
    daemon.start()
    assert ready.wait(120), "daemon did not come up"
    port = handle["httpd"].server_address[1]
    try:
        assert handle["batcher"].kv_mode == "paged"
        prompt = "the quick brown fox jumps over it"  # 33 bytes, 4 full pages
        hits = []
        for _ in range(2):
            code, doc = _post(port, {"prompt": prompt, "max_tokens": 5,
                                     "logprobs": 1})
            assert code == 200
            hits.append(_hits(_get(port, "/metrics")[1]))
        assert hits[1] == hits[0] + 1, "the repeat must hit the index"
        assert set(doc) == {"object", "id", "choices", "usage",
                            "ttft_seconds"}
        assert set(doc["choices"][0]) == {"text", "index", "finish_reason",
                                          "logprobs"}
        assert doc["usage"] == {"prompt_tokens": len(prompt),
                                "completion_tokens": 5}
        code, body = _get(port, "/healthz")
        assert code == 200 and json.loads(body)["status"] == "ok"
        code, text = _get(port, "/metrics")
        assert code == 200
        for fam in ("tpu_serve_kv_pages_in_use_count",
                    "tpu_serve_kv_page_allocs_total",
                    "tpu_serve_kv_page_copies_total",
                    "tpu_serve_kv_prefix_tokens_reused_total"):
            assert f"# TYPE {fam} " in text, fam
    finally:
        handle["httpd"].shutdown()
        daemon.join(timeout=60)
    assert not daemon.is_alive() and rc["rc"] == 0
