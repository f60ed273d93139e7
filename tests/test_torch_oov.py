"""Out-of-vocab token ids: the port's answer is the reference's, and it
stays inside its request.

The reference's flax ``Embed`` gathers with ``jnp.take``'s fill mode: an
id outside ``[-vocab, vocab)`` reads a NaN row (a negative id in range
wraps), the request's logits are NaN from there on, and greedy argmax
picks id 0. The port gives the same answer for that request, on the
CPU, at a small float32 config with the reference's own parameters.

That request leaves NaN in its K/V. A later request that reuses its
pages (paged KV) or its row (rows KV) must decode exactly the tokens it
decodes on a fresh pool. The reference's paged engine does not: on the
same scenario its later request decodes id 0 once it reaches the stale
entries (ROADMAP C6), which shows the scenario does reuse those pages.
The card's case through kernel B2 is in tests/test_torch_kernels_gpu.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.models import serve as jserve
from k8s_device_plugin_tpu.models import transformer as jt
from k8s_device_plugin_tpu_torch.models import transformer as tt
from k8s_device_plugin_tpu_torch.models.params import params_from_jax
from k8s_device_plugin_tpu_torch.models.serve import (
    ContinuousBatcher,
    LMServer,
)
from k8s_device_plugin_tpu_torch.ops import paged_attention as pa

_KW = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=32,
           mlp_dim=64, max_seq_len=64)
# 38 ids, one past the vocab; the later request and its budget.
OOV = [5, 17, 200, 99, 3] + list(range(8, 41))
NEXT = [(i * 7 + 3) % 128 for i in range(11)]
PAGED = dict(kv_mode="paged", page_tokens=8, prefill_chunk=16, pool_pages=9)


@pytest.fixture(scope="module")
def servers():
    jsrv = jserve.LMServer(config=jt.LMConfig(**_KW, dtype=jnp.float32))
    ct = tt.LMConfig(**_KW, dtype=torch.float32)
    tsrv = LMServer(config=ct, device="cpu", params=params_from_jax(
        jax.tree_util.tree_map(np.asarray, jsrv.params), ct))
    return jsrv, tsrv


def _one_by_one(srv, batcher_cls, jobs, **kw):
    """Each job alone, in order, on one batcher of one row."""
    b = batcher_cls(srv, max_batch=1, segment_tokens=4, **kw)
    out = []
    for prompt, budget in jobs:
        req = b.submit_async(prompt, budget)
        out.append(b.wait(req, timeout=120)[0])
    assert b.drain(timeout=30)
    return out


@functools.lru_cache(maxsize=None)
def _jax_forward():
    cj = jt.LMConfig(**_KW, dtype=jnp.float32)
    return jax.jit(lambda p, t: jt.DecoderLM(cj).apply({"params": p}, t))


def test_embedding_gathers_in_fill_mode_like_the_reference(servers):
    """ids in [-vocab, 0) wrap; ids past either end give a NaN row, and
    the row's logits are NaN, as the reference's."""
    jsrv, tsrv = servers
    v = _KW["vocab_size"]
    toks = np.array([[3, 7, -1, -v, 9, 4],      # wraps: finite
                     [3, 7, v, 2, 9, 4],        # past the end
                     [3, 7, -v - 1, 2, 9, 4],   # past the start
                     [3, 7, 11, 2, 9, 4]])
    want = np.asarray(_jax_forward()(jsrv.params, jnp.asarray(toks)))
    with torch.no_grad():
        got = tsrv.model(torch.from_numpy(toks)).numpy()
    assert (np.isnan(got) == np.isnan(want)).all()
    assert np.isnan(want[1:3]).all() and not np.isnan(want[[0, 3]]).any()
    np.testing.assert_allclose(got[[0, 3]], want[[0, 3]], atol=1e-4, rtol=0)


def test_oov_prompt_gives_the_reference_answer(servers):
    jsrv, tsrv = servers
    want = jsrv.complete_batch([OOV, NEXT], [6, 6])[0]
    got = tsrv.complete_batch([OOV, NEXT], [6, 6])[0]
    assert got == want
    assert got[0][len(OOV):] == [0] * 6      # greedy argmax over NaN
    for name, kw in (("paged", PAGED), ("rows", {})):
        assert _one_by_one(tsrv, ContinuousBatcher, [(OOV, 6)], **kw) == \
            _one_by_one(jsrv, jserve.ContinuousBatcher, [(OOV, 6)],
                        **kw), name


def test_reused_pages_carry_no_nan_into_a_later_request(servers):
    jsrv, tsrv = servers
    fresh = _one_by_one(tsrv, ContinuousBatcher, [(NEXT, 12)], **PAGED)[0]
    after = _one_by_one(tsrv, ContinuousBatcher, [(OOV, 6), (NEXT, 12)],
                        **PAGED)[1]
    assert after == fresh
    assert fresh == _one_by_one(jsrv, jserve.ContinuousBatcher,
                                [(NEXT, 12)], **PAGED)[0]
    # The reference's paged engine carries the NaN over on this very
    # scenario (ROADMAP C6): the pages are reused.
    ref_after = _one_by_one(jsrv, jserve.ContinuousBatcher,
                            [(OOV, 6), (NEXT, 12)], **PAGED)[1]
    assert ref_after != fresh


def test_reused_rows_carry_no_nan_into_a_later_request(servers):
    jsrv, tsrv = servers
    fresh = _one_by_one(tsrv, ContinuousBatcher, [(NEXT, 12)])[0]
    after = _one_by_one(tsrv, ContinuousBatcher, [(OOV, 6), (NEXT, 12)])[1]
    assert after == fresh
    assert fresh == _one_by_one(jsrv, jserve.ContinuousBatcher,
                                [(NEXT, 12)])[0]


@pytest.mark.parametrize("read", ["reference", "fp32"])
def test_plain_paged_read_selects_stale_values_away(read):
    """NaN K/V past each row's last query position (a freed page's stale
    entries, the scratch page) change nothing in the read."""
    rng = np.random.default_rng(0)
    b, L, heads, kv, d, pt, pool = 2, 3, 4, 2, 16, 4, 7
    q = torch.from_numpy(rng.standard_normal((b, L, heads, d),
                                             dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((pool, pt, kv, d),
                                             dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((pool, pt, kv, d),
                                             dtype=np.float32))
    bt = torch.tensor([[1, 2, 3, 0], [4, 5, 0, 0]])
    q_pos = torch.tensor([[5, 6, 7], [2, 3, 4]])
    fn = pa.paged_attention_reference if read == "reference" \
        else pa.paged_attention_fp32
    want = fn(q, k, v, bt, q_pos)
    kn, vn = k.clone(), v.clone()
    for page, first in ((3, 0), (0, 0), (5, 1)):
        kn[page, first:] = torch.nan
        vn[page, first:] = torch.nan
    got = fn(q, kn, vn, bt, q_pos)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
