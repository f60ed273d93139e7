"""The port's paged serving engine against the JAX reference's.

A JAX ``LMServer`` and the port's on the CPU, at the tiny float32 config
of tests/test_kv_cache.py with the same parameters (models/params.py),
each drive a paged ``ContinuousBatcher`` through the jobs of the
reference's paged-engine tests: ``test_paged_matches_complete_exactly``,
``test_paged_long_prompt_chunked_prefill_exact``,
``test_shared_prefix_bit_identical``,
``test_copy_on_extend_divergent_suffixes_isolated`` and
``test_pool_exhaustion_preempts_batch_class_first``. Both engines are
stepped by hand, in the same order (admit, one prefill chunk, one decode
segment), so their page bookkeeping sees the same sequence of events.
Required: identical greedy tokens, logprobs within 1e-4 (the two
packages sum in other orders), and equal prefix-hit, page-copy,
eviction, preemption and shed counters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.models import kv_cache as jkv
from k8s_device_plugin_tpu.models import serve as jserve
from k8s_device_plugin_tpu.models import serve_batch as jbatch
from k8s_device_plugin_tpu.models import transformer as jt
from k8s_device_plugin_tpu.obs import metrics as jmetrics
from k8s_device_plugin_tpu_torch.models import kv_cache as tkv
from k8s_device_plugin_tpu_torch.models import serve as tserve
from k8s_device_plugin_tpu_torch.models import serve_batch as tbatch
from k8s_device_plugin_tpu_torch.models import transformer as tt
from k8s_device_plugin_tpu_torch.models.params import params_from_jax
from k8s_device_plugin_tpu_torch.obs import metrics as tmetrics

_KW = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=32,
           mlp_dim=64, max_seq_len=64)
PACKAGES = {
    "jax": (jserve, jbatch, jkv, jmetrics),
    "torch": (tserve, tbatch, tkv, tmetrics),
}
COUNTERS = (
    ("tpu_serve_kv_prefix_lookups_total", ("outcome",), ("hit", "miss")),
    ("tpu_serve_kv_prefix_tokens_reused_total", (), ()),
    ("tpu_serve_kv_page_copies_total", (), ()),
    ("tpu_serve_kv_evictions_total", ("kind",), ("index", "preempt")),
    ("tpu_serve_slo_preemptions_total", ("resource",), ("pages",)),
    ("tpu_serve_shed_total", ("reason",), ("pages",)),
)


@pytest.fixture(scope="module")
def servers():
    jsrv = jserve.LMServer(config=jt.LMConfig(**_KW, dtype=jnp.float32))
    ct = tt.LMConfig(**_KW, dtype=torch.float32)
    tsrv = tserve.LMServer(config=ct, device="cpu", params=params_from_jax(
        jax.tree_util.tree_map(np.asarray, jsrv.params), ct))
    return {"jax": jsrv, "torch": tsrv}


def manual_paged(pkg, server, pool_pages=0, rows=2, segment=4, chunk=16):
    """A paged batcher with no engine thread (the reference's
    ``_manual_paged``): the test steps its ``_PagedEngine`` itself."""
    serve, batch, kv, _ = PACKAGES[pkg]
    b = serve.ContinuousBatcher.__new__(serve.ContinuousBatcher)
    batch._BatcherBase.__init__(b, server, seed=0, max_pending=0)
    b.rows, b.segment, b.chunk = rows, segment, chunk
    b.kv_mode, b._auto = "paged", False
    seq = server.config.max_seq_len
    b.kv_config = kv.KVPageConfig(
        8, pool_pages or kv.page_config_from_env(seq, rows, 8).pool_pages,
        seq)
    return b, batch._PagedEngine(b)


def step(b, eng):
    """One engine iteration after admission: a prefill chunk, then a
    decode segment (the order of ``_loop_paged``)."""
    if eng.filling:
        eng.prefill_chunk_step(b._next_key())
    if eng.live:
        eng.decode_segment_step(b._next_key())


def run_groups(b, eng, groups):
    """Each group's jobs submitted and admitted together, then stepped
    until they finish; [(tokens, logprobs)] in job order."""
    out = []
    for group in groups:
        reqs = [b.submit_async(p, n, logprobs=True) for p, n in group]
        for _ in reqs:
            eng.admit(b.q.get_nowait())
        for _ in range(200):
            if all(r.done.is_set() for r in reqs):
                break
            step(b, eng)
        for r in reqs:
            toks, _ = b.wait(r, timeout=1)
            out.append((toks, r.slot["logprobs"]))
    return out


def exhaustion(b, eng):
    """The reference's pool-exhaustion scenario: a long batch-class
    request fills the pool, then an interactive arrival must reclaim
    pages by preempting it."""
    prompt_b = [(i * 7 + 1) % 128 for i in range(20)]
    prompt_i = [(i * 3 + 2) % 128 for i in range(20)]
    rb = b.submit_async(prompt_b, 40, slo="batch", logprobs=True)
    eng.admit(b.q.get_nowait())
    while eng.filling:
        eng.prefill_chunk_step(b._next_key())
    for _ in range(12):
        eng.decode_segment_step(b._next_key())
        if eng.pagepool.free_pages == 0:
            break
    assert eng.pagepool.free_pages == 0 and not rb.done.is_set()
    ri = b.submit_async(prompt_i, 4, slo="interactive", logprobs=True)
    eng.admit(b.q.get_nowait())
    for _ in range(20):
        step(b, eng)
        if ri.done.is_set():
            break
    assert rb.done.is_set() and rb.slot["error_kind"] == "shed"
    toks, _ = b.wait(ri, timeout=1)
    return [(toks, ri.slot["logprobs"])]


PREFIX = [(i * 5 + 1) % 128 for i in range(40)]
P21 = [(i * 3 + 2) % 128 for i in range(21)]
SCENARIOS = {
    # test_paged_matches_complete_exactly
    "complete_exactly": dict(rows=4, groups=[[
        ([5, 17, 99], 7), ([7, 3, 42, 11], 23), ([1], 4), ([88, 2], 12)]]),
    # test_paged_long_prompt_chunked_prefill_exact: 3 chunks of 16
    "long_prompt_chunked": dict(rows=2, groups=[[
        ([(i * 7 + 3) % 128 for i in range(40)], 10)]]),
    # test_shared_prefix_bit_identical: 5 full pages reused
    "shared_prefix": dict(rows=2, groups=[
        [(PREFIX + [7, 9], 8)], [(PREFIX + [11, 13], 8)]]),
    # test_copy_on_extend_divergent_suffixes_isolated
    "copy_on_extend": dict(rows=2, groups=[[(P21, 10)]] * 3 + [
        [(P21 + [5, 28], 8), (P21 + [66, 41], 8)]]),
    # test_pool_exhaustion_preempts_batch_class_first
    "pool_exhaustion": dict(rows=2, pool_pages=9, run=exhaustion),
}


def _counters(reg):
    out = {}
    for name, labels, values in COUNTERS:
        c = reg.counter(name, labels=labels)
        for v in values or (None,):
            got = c.value(**{labels[0]: v}) if labels else c.value()
            out[f"{name}{{{v}}}" if v else name] = got
    return out


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_paged_engine_matches_reference(servers, scenario):
    spec = SCENARIOS[scenario]
    results, counters = {}, {}
    for pkg in ("jax", "torch"):
        metrics = PACKAGES[pkg][3]
        reg = metrics.MetricsRegistry()
        metrics.install(reg)
        try:
            b, eng = manual_paged(pkg, servers[pkg], rows=spec["rows"],
                                  pool_pages=spec.get("pool_pages", 0))
            run = spec.get("run")
            results[pkg] = (run(b, eng) if run
                            else run_groups(b, eng, spec["groups"]))
            counters[pkg] = _counters(reg)
            b.close()
        finally:
            metrics.uninstall()
    want, got = results["jax"], results["torch"]
    assert [t for t, _ in got] == [t for t, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert len(g) == len(w)
        np.testing.assert_allclose(g, w, atol=1e-4)
    assert counters["torch"] == counters["jax"]
    if scenario == "shared_prefix":
        assert counters["torch"]["tpu_serve_kv_prefix_lookups_total{hit}"] \
            == 1
    if scenario == "copy_on_extend":
        assert counters["torch"]["tpu_serve_kv_page_copies_total"] >= 3
    if scenario == "pool_exhaustion":
        assert counters["torch"]["tpu_serve_kv_evictions_total{preempt}"] \
            >= 1
