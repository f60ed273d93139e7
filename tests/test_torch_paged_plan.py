"""Launch plan of the port's paged-attention kernel B2 and a plain-torch
tile model of its arithmetic, on the CPU.

The plan (``paged_attn_plan`` in
k8s_device_plugin_tpu_torch/ops/paged_attention.py) is what the wrapper
hands the C entry point: it must fit the card's shared memory, state the
bytes csrc/paged_attn.cu's ``Decode`` / ``Chunk`` compute, cut each row's
table slots into splits that cover them exactly once and in order, and
depend on shapes only, never on the row lengths (so a launch can be
replayed from a CUDA graph with new tables and positions).

The tile model repeats B2's arithmetic block by block from that same
plan: query tiles of the plan's rows (query row i = l·n_rep + r), each
split's keys cut at the tile's largest position and walked in K/V tiles
with an fp32 online softmax (masked keys take probability 0), per-split
partials (m, l, acc) with empty splits written as (-1e30, 0) and weighed
0, the combine in split order, and on the chunk route P rounded to bf16
for P·V. It is held against the JAX package's ``_paged_attention_fused``
and ``_paged_attention_gather`` on numpy-seeded inputs: MHA, GQA and MQA,
decode and chunk, split counts 1, 2 and many, a row whose keys end on a
split boundary, a row at position 0 and a row on scratch page 0 only.
Tolerances: with float32 operands (P kept in fp32) the model is the same
algorithm in another summation order, 1e-5; with operands rounded to
bf16 and P rounded as the chunk route does, 2e-2, the card tests' bar
(tests/test_torch_kernel_plan.py states its bars the same way).
"""

import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.models import transformer as jt
from k8s_device_plugin_tpu_torch.ops import attention as tattn
from k8s_device_plugin_tpu_torch.ops import paged_attention as pa

NEG = -1e30


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

# Shared-memory bytes of each build instance (csrc/paged_attn.cu's Decode
# and Chunk): (route, dtype, column instance) -> bytes.
BUILT_SMEM = {
    ("decode", torch.bfloat16, 64): 45_312,
    ("decode", torch.bfloat16, 128): 82_176,
    ("decode", torch.bfloat16, 256): 86_272,
    ("decode", torch.float32, 64): 78_080,
    ("decode", torch.float32, 128): 78_080,
    ("decode", torch.float32, 256): 84_224,
    ("chunk", torch.bfloat16, 64): 46_336,
    ("chunk", torch.bfloat16, 128): 87_296,
    ("chunk", torch.bfloat16, 256): 169_216,
}


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype,L", [(torch.bfloat16, 1),
                                     (torch.bfloat16, 64),
                                     (torch.float32, 1),
                                     (torch.float32, 64)])
def test_plan_fits_the_card(dtype, L, d):
    """Shared memory within the 232,448 bytes a block may use and equal
    to the build's; the route by type and query rows; a chunk thread's
    O accumulator (16 rows x d over a warp) within 128 registers."""
    plan = pa.paged_attn_plan(4, L, 16, 16, d, 16, 65, dtype)
    want = "chunk" if dtype == torch.bfloat16 and L >= 16 else "decode"
    assert plan.route == want
    assert plan.dmax == d
    assert plan.smem_bytes == BUILT_SMEM[(want, dtype, d)]
    assert plan.smem_bytes <= tattn.SMEM_LIMIT == 232_448
    assert plan.tile_rows == (64 if want == "chunk" else 16)
    if want == "chunk":
        assert plan.tile_keys == 64 and d // 2 <= 128
    assert plan.keys_per_split % plan.tile_keys == 0
    assert plan.keys_per_split % plan.page_tokens == 0


@pytest.mark.parametrize("page_tokens", [8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_splits_cover_each_rows_slots_once_in_order(dtype, page_tokens):
    """At every table width, head count and chunk length: the splits are
    contiguous whole pages in order, from slot 0 to the table's end, and
    what the C entry point checks holds (n·keys >= span > (n - 1)·keys)."""
    for W in (1, 2, 3, 8, 64, 65, 200):
        for L, heads, kv in ((1, 16, 16), (64, 16, 16), (1, 8, 2),
                             (16, 8, 1), (3, 4, 4)):
            plan = pa.paged_attn_plan(3, L, heads, kv, 64, page_tokens, W,
                                      dtype)
            span = W * page_tokens
            splits = plan.splits()
            assert len(splits) == plan.n_splits >= 1
            assert splits[0][0] == 0 and splits[-1][1] == span
            for (a0, a1), (b0, _) in zip(splits, splits[1:]):
                assert a1 == b0
            for first, end in splits:
                assert first < end
                assert first % page_tokens == 0 and end % page_tokens == 0
            n, keys = plan.n_splits, plan.keys_per_split
            assert n * keys >= span > (n - 1) * keys


def test_grid_and_workspace_depend_on_shapes_only():
    """The plan takes no row length: its arguments are shapes, and the
    grid fills the card where the table allows (about four blocks an SM
    at the serving default), so the same launch serves any lengths."""
    params = list(inspect.signature(pa.paged_attn_plan).parameters)
    assert params == ["b", "L", "heads", "kv_heads", "d", "page_tokens",
                      "W", "dtype"]
    decode = pa.paged_attn_plan(4, 1, 16, 16, 64, 16, 65, torch.bfloat16)
    assert decode.route == "decode" and decode.grid == (4, 16, 9)
    assert decode.keys_per_split == 128 and decode.blocks == 576
    profile = pa.paged_attn_plan(4, 1, 16, 16, 64, 16, 64, torch.bfloat16)
    assert profile.blocks == 512
    chunk = pa.paged_attn_plan(4, 64, 16, 16, 64, 16, 65, torch.bfloat16)
    assert chunk.route == "chunk" and chunk.blocks == 576
    assert chunk.workspace_floats == 4 * 64 * 16 * 9 * (2 + 64)
    short = pa.paged_attn_plan(4, 1, 16, 16, 64, 16, 4, torch.bfloat16)
    assert short.n_splits == 1 and short.workspace_floats == 0


def test_wrapper_reads_int64_indices_without_a_cast():
    """The engine's int64 tables and positions reach the kernel as they
    are: the same storage, no cast launched per layer. The kernel reads
    int64 only, so another integer type is cast to it."""
    bt = torch.arange(12, dtype=torch.int64).reshape(3, 4)
    got = pa._index(bt, bt.device)
    assert got.dtype == torch.int64 and got.data_ptr() == bt.data_ptr()
    for other in (torch.int16, torch.int32):
        cast = pa._index(bt.to(other), bt.device)
        assert cast.dtype == torch.int64 and torch.equal(cast, bt)


def test_wrapper_refuses_cpu_tensors():
    """``paged_attention_cuda`` launches or raises; the CPU path is
    ``paged_attention``'s plain read."""
    q = torch.zeros(1, 1, 2, 8)
    pool = torch.zeros(2, 8, 2, 8)
    with pytest.raises(ValueError, match="not q's CUDA device"):
        pa.paged_attention_cuda(q, pool, pool, torch.zeros(1, 1),
                                torch.zeros(1, 1))


# ---------------------------------------------------------------------------
# the tile model
# ---------------------------------------------------------------------------

def tile_model(q, k_pages, v_pages, bt, q_pos, plan, round_p,
               split_scale=None):
    """B2's arithmetic from ``plan`` in plain float32 torch: the output
    ``[b, L, heads, d]`` (float32). Every (row, kv head) at once, query
    tile by query tile, split by split, K/V tile by K/V tile. ``round_p``
    rounds P to bf16 for P·V (the chunk route's tensor-core operand).
    ``split_scale`` ({split: factor}) weighs a split's acc wrong: a fault
    the checks must see."""
    b, L, heads, d = q.shape
    kv, n_rep, nq = plan.kv_heads, heads // plan.kv_heads, plan.rows
    pages = bt.long()
    pages = torch.where((pages < 0) | (pages >= k_pages.shape[0]), 0, pages)
    kc = k_pages.float()[pages].reshape(b, -1, kv, d).transpose(1, 2)
    vc = v_pages.float()[pages].reshape(b, -1, kv, d).transpose(1, 2)
    # query row i = l·n_rep + r of (row, g) is q head g·n_rep + r at l
    qr = q.float().reshape(b, L, kv, n_rep, d).transpose(1, 2).reshape(
        b, kv, nq, d)
    pos = q_pos.long().repeat_interleave(n_rep, dim=1)       # [b, nq]
    out = torch.zeros(b, kv, nq, d)
    scale = d ** -0.5
    for t in range(plan.q_tiles):
        rows = slice(t * plan.tile_rows, min((t + 1) * plan.tile_rows, nq))
        qt, pt = qr[:, :, rows], pos[:, rows]
        n = pt.shape[1]
        # each tile's keys stop at its largest position
        n_keys = torch.clamp(pt.max(-1).values + 1, max=kc.shape[2])
        parts = []
        for split, (first, end) in enumerate(plan.splits()):
            m = torch.full((b, kv, n), NEG)
            l = torch.zeros(b, kv, n)
            acc = torch.zeros(b, kv, n, d)
            for k0 in range(first, end, plan.tile_keys):
                keys = torch.arange(k0, min(k0 + plan.tile_keys, end))
                s = (qt @ kc[:, :, keys].transpose(-1, -2)) * scale
                vis = (keys[None, :] <= pt[:, :, None])[:, None]
                s = torch.where(vis, s, -torch.inf)
                m_new = torch.maximum(m, s.max(-1).values)
                p = torch.where(vis, torch.exp(s - m_new[..., None]), 0.0)
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1)
                if round_p:
                    p = p.to(torch.bfloat16).float()
                acc = acc * alpha[..., None] + p @ vc[:, :, keys]
                m = m_new
            acc = acc * (split_scale or {}).get(split, 1.0)
            # a split wholly past the tile's last key: (-1e30, 0), no acc
            empty = (first >= n_keys)[:, None, None]
            parts.append((torch.where(empty, NEG, m),
                          torch.where(empty, 0.0, l), acc))
        # the combine, in split order; empty splits weigh 0
        mt = torch.stack([m for m, _, _ in parts]).max(0).values
        lt = torch.zeros(b, kv, n)
        at = torch.zeros(b, kv, n, d)
        for m, l, acc in parts:
            f = torch.where(l > 0, torch.exp(m - mt), 0.0)
            lt = lt + l * f
            at = at + acc * f[..., None]
        out[:, :, rows] = at / torch.where(lt > 0, lt, 1.0)[..., None]
    return out.reshape(b, kv, L, n_rep, d).transpose(1, 2).reshape(
        b, L, heads, d)


def _case(b, L, heads, kv, d, P, W, lens, seed):
    """numpy inputs: each row's pages in a scrambled order; a row with
    lens < 0 has every slot on scratch page 0 (positions 0 .. L - 1)."""
    rng = np.random.default_rng(seed)
    pool_pages = 1 + b * W
    perm = rng.permutation(np.arange(1, pool_pages)).reshape(b, W)
    bt = np.where(np.asarray(lens)[:, None] < 0, 0, perm).astype(np.int32)
    q_pos = (np.maximum(np.asarray(lens), 0)[:, None]
             + np.arange(L)).astype(np.int32)
    q = rng.standard_normal((b, L, heads, d), dtype=np.float32)
    kp = rng.standard_normal((pool_pages, P, kv, d), dtype=np.float32)
    vp = rng.standard_normal((pool_pages, P, kv, d), dtype=np.float32)
    return q, kp, vp, bt, q_pos


# (name, L, heads, kv_heads, page_tokens, W, lens, route, splits): the
# table width picks the split count (1, 2 or many); lens put one row's
# keys on a split boundary, one at position 0, one on scratch page 0.
MODEL_CASES = [
    ("mha_decode_1split", 1, 4, 4, 8, 8, [40, 0, -1], "decode", 1),
    ("mha_decode_2splits", 1, 4, 4, 8, 16, [63, 100, -1], "decode", 2),
    ("gqa_decode_many", 1, 8, 2, 16, 40, [511, 0, 300], "decode", 10),
    ("mqa_decode_many", 1, 8, 1, 8, 64, [127, 400, -1], "decode", 8),
    ("mha_chunk_1split", 16, 4, 4, 8, 8, [40, 0, -1], "chunk", 1),
    ("gqa_chunk_2splits", 8, 8, 2, 16, 8, [48, 0, -1], "chunk", 2),
    ("mqa_chunk_many", 2, 8, 1, 8, 64, [126, 400, -1], "chunk", 8),
    ("gqa_chunk_2tiles", 20, 8, 2, 16, 24, [300, 0, 255], "chunk", 6),
]
MODEL_D = 16


@functools.lru_cache(maxsize=None)
def _jax_reads(case: int, jdt):
    """The JAX package's fused scan and gather on MODEL_CASES[case]'s
    inputs (jitted: a compile is cheaper than the eager scan)."""
    q, kp, vp, bt, q_pos = _model_inputs(case)
    _, L, heads, kv = MODEL_CASES[case][:4]
    att = jt.Attention(jt.LMConfig(vocab_size=64, num_layers=1,
                                   num_heads=heads, num_kv_heads=kv,
                                   embed_dim=heads * q.shape[-1],
                                   mlp_dim=64, max_seq_len=64, dtype=jdt))
    args = [jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
            jnp.asarray(bt), jnp.asarray(q_pos)]
    return [np.asarray(jax.jit(read)(*args).astype(jnp.float32))
            for read in (att._paged_attention_fused,
                         att._paged_attention_gather)]


def _model_inputs(case: int):
    _, L, heads, kv, P, W, lens = MODEL_CASES[case][:7]
    return _case(3, L, heads, kv, MODEL_D, P, W, lens, seed=W + L)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name,L,heads,kv,P,W,lens,route,splits",
                         MODEL_CASES, ids=[c[0] for c in MODEL_CASES])
def test_tile_model_matches_reference(name, L, heads, kv, P, W, lens, route,
                                      splits, bf16):
    """The model from the bf16 plan of each shape (its route, tiles and
    splits) against the JAX package's fused scan and gather: float32
    operands within 1e-5, bf16-rounded operands (P rounded on the chunk
    route) within 2e-2."""
    case = [c[0] for c in MODEL_CASES].index(name)
    q, kp, vp, bt, q_pos = _model_inputs(case)
    plan = pa.paged_attn_plan(3, L, heads, kv, MODEL_D, P, W,
                              torch.bfloat16)
    assert (plan.route, plan.n_splits) == (route, splits)
    if name == "mha_decode_2splits":  # row 0's keys end on the boundary
        assert lens[0] + L == plan.keys_per_split
    tdt = torch.bfloat16 if bf16 else torch.float32
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, kp, vp))
    got = tile_model(tq, tk, tv, torch.from_numpy(bt),
                     torch.from_numpy(q_pos), plan,
                     round_p=bf16 and route == "chunk")
    if bf16:
        got = got.to(torch.bfloat16).float()
    tol = 2e-2 if bf16 else 1e-5
    for want in _jax_reads(case, jdt):
        np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("name,L,heads,kv,P,W,lens,route,splits",
                         MODEL_CASES[:4], ids=[c[0] for c in MODEL_CASES[:4]])
def test_tile_model_float32_plan_matches_reference(name, L, heads, kv, P, W,
                                                   lens, route, splits):
    """float32 calls take the decode route at every shape; the model from
    the float32 plan (its own K/V tile) within 1e-5 of the fused scan."""
    case = [c[0] for c in MODEL_CASES].index(name)
    q, kp, vp, bt, q_pos = _model_inputs(case)
    plan = pa.paged_attn_plan(3, L, heads, kv, MODEL_D, P, W, torch.float32)
    assert plan.route == "decode"
    got = tile_model(*(torch.from_numpy(x) for x in (q, kp, vp, bt, q_pos)),
                     plan, round_p=False)
    want = _jax_reads(case, jnp.float32)[0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_tile_model_one_split_equals_many():
    """The split-order combine is exact algebra: the model with one split
    and with one split per K/V tile agree within fp32 rounding."""
    q, kp, vp, bt, q_pos = _case(2, 1, 4, 2, 16, 8, 32, [200, 31], seed=3)
    args = [torch.from_numpy(x) for x in (q, kp, vp, bt, q_pos)]
    plan = pa.paged_attn_plan(2, 1, 4, 2, 16, 8, 32, torch.float32)
    one = dataclasses.replace(plan, keys_per_split=256, n_splits=1)
    many = dataclasses.replace(plan, keys_per_split=plan.tile_keys,
                               n_splits=256 // plan.tile_keys)
    a = tile_model(*args, one, round_p=False)
    b = tile_model(*args, many, round_p=False)
    torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", [c[0] for c in MODEL_CASES])
def test_fp32_read_matches_reference(name):
    """``paged_attention_fp32`` (the close yardstick of B2's bf16 outputs)
    on float32 operands is the fused scan within 1e-5."""
    case = [c[0] for c in MODEL_CASES].index(name)
    args = [torch.from_numpy(x) for x in _model_inputs(case)]
    got = pa.paged_attention_fp32(*args)
    want = _jax_reads(case, jnp.float32)[0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", [c[0] for c in MODEL_CASES if c[8] > 1])
def test_row_check_holds_the_model_and_sees_a_misweighted_split(name):
    """With bf16 operands the model (P rounded on the chunk route, the
    output rounded to bf16) is within ``PAGED_BF16_ROW_TOL`` of
    ``paged_attention_fp32`` row by row; the same model with its first
    split's acc weighed 10% wrong is not."""
    case = [c[0] for c in MODEL_CASES].index(name)
    _, L, heads, kv, P, W = MODEL_CASES[case][:6]
    q, kp, vp, bt, q_pos = _model_inputs(case)
    plan = pa.paged_attn_plan(3, L, heads, kv, MODEL_D, P, W,
                              torch.bfloat16)
    args = [torch.from_numpy(x) for x in (q, kp, vp)]
    args = [x.to(torch.bfloat16) for x in args] + [
        torch.from_numpy(bt), torch.from_numpy(q_pos)]
    round_p = plan.route == "chunk"
    want = pa.paged_attention_fp32(*args, round_p=round_p)
    good = tile_model(*args, plan, round_p).to(torch.bfloat16)
    bad = tile_model(*args, plan, round_p, split_scale={0: 1.1}).to(
        torch.bfloat16)
    assert pa.row_rel_err(good, want) <= pa.PAGED_BF16_ROW_TOL
    assert pa.row_rel_err(bad, want) > pa.PAGED_BF16_ROW_TOL
