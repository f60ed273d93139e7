"""Launch plans of the port's bfloat16 Hopper kernels (B1 flash forward,
B3 flash dQ, B4 flash dK/dV) and a plain-torch tile model of their
arithmetic.

The plans (``flash_fwd_plan`` / ``flash_bwd_dq_plan`` /
``flash_bwd_dkv_plan`` in
k8s_device_plugin_tpu_torch/ops/attention.py) are what the wrappers hand
the C entry points: they must fit the card (shared memory, TMA box rows),
and their schedule — the table each block reads its tile and its steps
from — must cover every (group, tile) exactly once with the steps it
needs, heaviest first under a causal mask, at every sequence length.

The tile model repeats the kernels' arithmetic block by block from that
same schedule: zero-filled ragged tiles (what TMA reads past the end), base-2
online softmax with scale·log2(e) folded into the scores, masks only on
the diagonal and ragged tiles, P (and dS) rounded to bf16 as the
tensor-core operands, LSE back in natural log, B3's probabilities from
LSE·log2(e) over the K/V stages of a resident q tile, and B4's transposed
score tile summed over each GQA group in fp32. It is held against the JAX
package's Pallas kernels in interpret mode (``_flash_forward``, and
``jax.vjp`` of ``flash_attention_with_lse``). Inputs are float32 from a
seed. Tolerances: with the operands kept in float32 the model is the
same algorithm in another summation order (atol/rtol 1e-5 forward, 5e-4
backward — the reference's own kernel bar); with them rounded to bf16
as the kernels do, O within 2e-2 and gradients within 2e-2 of their
largest value (bf16 keeps 8 bits; the card tests' bars are 3e-2 / 5e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.ops import attention as jattn
from k8s_device_plugin_tpu_torch.ops import attention as tattn

SEQS = [1, 63, 64, 65, 127, 128, 129, 200, 1024, 2048]
PLANS = {"b1": tattn.flash_fwd_plan, "b3": tattn.flash_bwd_dq_plan,
         "b4": tattn.flash_bwd_dkv_plan}
LOG2E = 1.4426950408889634


# ---------------------------------------------------------------------------
# launch plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [64, 128, 256])
@pytest.mark.parametrize("kernel", sorted(PLANS))
def test_plan_fits_the_card(kernel, dim):
    """Shared memory within the 232,448 bytes a block may use, every TMA
    box row within the 128-byte swizzle, at least two stages, a producer
    warpgroup beside two consumer warpgroups, and the fp32 accumulators
    of a consumer thread (64 rows over 128 threads: O or dQ, or B4's dK
    and dV over the columns a block owns) within 128 registers."""
    plan = PLANS[kernel](8, 8, 8, 2048, 2048, dim, True)
    assert plan.smem_bytes <= tattn.SMEM_LIMIT == 232_448
    for _, row_bytes, rows in plan.boxes:
        assert row_bytes <= tattn.TMA_BOX_ROW_LIMIT == 128
        assert 1 <= rows <= 256
    assert plan.stages >= 2 and plan.threads == 384
    assert plan.block_rows == 128 and plan.step_rows % 16 == 0
    assert dim % plan.splits == 0
    accumulators = 2 if kernel == "b4" else 1
    assert accumulators * (dim // plan.splits) // 2 <= 128


@pytest.mark.parametrize("seq", SEQS)
@pytest.mark.parametrize("kernel", sorted(PLANS))
def test_schedule_covers_each_tile_once_heaviest_first(kernel, seq):
    """The schedule the kernels read (one row per block: group, tile,
    first step, end step) covers every (group, tile) exactly once, gives
    each block the steps its tile needs and no more, and puts the blocks
    with the most steps first under a causal mask."""
    for dim in (64, 128, 256):
        for causal in (True, False):
            plan = PLANS[kernel](2, 8, 2, seq, seq, dim, causal)
            rows = plan.schedule()
            assert rows.dtype == torch.int32 and rows.is_contiguous()
            assert rows.shape == (plan.grid, 4) == (plan.args[4], 4)
            order = [(g, t) for g, t, _, _ in rows.tolist()]
            assert len(set(order)) == plan.grid
            assert set(order) == {(g, t) for g in range(plan.groups)
                                  for t in range(plan.tiles)}
            assert (plan.tiles - 1) * plan.block_rows < seq \
                <= plan.tiles * plan.block_rows
            step = plan.step_rows
            for _, t, first, end in rows.tolist():
                r0 = t * plan.block_rows
                if kernel in ("b1", "b3"):
                    # keys the tile's real q rows may see: all of them, or
                    # (causal) those up to its last real row
                    last = seq - 1
                    if causal:
                        last = min(seq, r0 + plan.block_rows) - 1
                    assert first == 0
                else:
                    # q rows that may see the tile's keys: all, or (causal)
                    # those from its first key on
                    last = seq - 1
                    assert first * step <= (r0 if causal else 0) \
                        < (first + 1) * step
                assert (end - 1) * step <= last < end * step
            work = [end - first for _, _, first, end in rows.tolist()]
            assert min(work) >= 1
            if causal:
                assert work == sorted(work, reverse=True)
            else:
                assert len(set(work)) == 1


# ---------------------------------------------------------------------------
# tile model
# ---------------------------------------------------------------------------

def _pad_rows(x, rows, value=0.0):
    """Rows of dim -2 (or the last dim of a 2-D row statistic) padded to
    ``rows``: what TMA reads past the end is zeros."""
    if x.dim() == 2:
        return torch.nn.functional.pad(x, (0, rows - x.shape[-1]),
                                       value=value)
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[-2]),
                                   value=value)


def _bf16(x, on):
    return x.bfloat16().float() if on else x


def tile_forward(q, k, v, causal, round_p):
    """B1's arithmetic, block by block as flash_fwd_plan's schedule runs
    it; (out, lse). A tile no block computes stays NaN."""
    b, h, s, d = q.shape
    plan = tattn.flash_fwd_plan(b, h, k.shape[1], s, k.shape[2], d, causal)
    bq, bk = plan.block_rows, plan.step_rows
    scale = d ** -0.5
    sl2 = scale * LOG2E
    kx = _pad_rows(tattn.expand_kv(k, h), -(-s // bk) * bk).flatten(0, 1)
    vx = _pad_rows(tattn.expand_kv(v, h), -(-s // bk) * bk).flatten(0, 1)
    qx = _pad_rows(q, plan.tiles * bq).flatten(0, 1)
    out = torch.full_like(qx, torch.nan)
    lse = torch.full(qx.shape[:2], torch.nan)
    for bh, t, first, end in plan.schedule().tolist():
        q0 = t * bq
        rows = torch.arange(q0, q0 + bq)
        m = torch.full((bq,), -torch.inf)
        l = torch.zeros(bq)
        acc = torch.zeros(bq, d)
        for kt in range(first, end):
            k0 = kt * bk
            keys = torch.arange(k0, k0 + bk)
            sc = qx[bh, q0:q0 + bq] @ kx[bh, k0:k0 + bk].T
            if (causal and k0 + bk - 1 > q0) or k0 + bk > s:
                bad = keys[None, :] >= s
                if causal:
                    bad = bad | (keys[None, :] > rows[:, None])
                sc = sc.masked_fill(bad, -torch.inf)
            mx = torch.maximum(m, sc.amax(-1))
            ms = torch.where(mx == -torch.inf, 0.0, mx * sl2)
            alpha = torch.exp2(m * sl2 - ms)
            p = torch.exp2(sc * sl2 - ms[:, None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[:, None] + _bf16(p, round_p) @ vx[bh, k0:k0 + bk]
            m = mx
        den = l.clamp_min(1e-30)
        out[bh, q0:q0 + bq] = acc / den[:, None]
        lse[bh, q0:q0 + bq] = m * scale + torch.log(den)
    return (out.view(b, h, -1, d)[:, :, :s],
            lse.view(b, h, -1)[:, :, :s])


def tile_dq(q, k, v, g, lse, delta, causal, round_ops):
    """B3's arithmetic, block by block as flash_bwd_dq_plan's schedule
    runs it: per q tile, the K/V stages up to its diagonal, base-2
    probabilities from LSE·log2(e), masks on the diagonal and ragged
    stages only, dS rounded to bf16 as the A operand of dS·K; dq. A tile
    no block computes stays NaN."""
    b, h, s, d = q.shape
    s_k = k.shape[2]
    plan = tattn.flash_bwd_dq_plan(b, h, k.shape[1], s, s_k, d, causal)
    bq, bk = plan.block_rows, plan.step_rows
    scale = d ** -0.5
    sl2 = scale * LOG2E
    rows_q = plan.tiles * bq
    kx = _pad_rows(tattn.expand_kv(k, h), -(-s_k // bk) * bk).flatten(0, 1)
    vx = _pad_rows(tattn.expand_kv(v, h), -(-s_k // bk) * bk).flatten(0, 1)
    qx = _pad_rows(q, rows_q).flatten(0, 1)
    gx = _pad_rows(g, rows_q).flatten(0, 1)
    # a row past the end reads LSE = +inf: its probabilities are 0
    lse2 = _pad_rows((lse * LOG2E).flatten(0, 1), rows_q, torch.inf)
    dl = _pad_rows(delta.flatten(0, 1), rows_q)
    dq = torch.full_like(qx, torch.nan)
    for bh, t, first, end in plan.schedule().tolist():
        q0 = t * bq
        rows = torch.arange(q0, q0 + bq)
        qs, dos = qx[bh, q0:q0 + bq], gx[bh, q0:q0 + bq]
        acc = torch.zeros(bq, d)
        for kt in range(first, end):
            k0 = kt * bk
            keys = torch.arange(k0, k0 + bk)
            kb = kx[bh, k0:k0 + bk]
            p = torch.exp2((qs @ kb.T) * sl2 - lse2[bh, q0:q0 + bq, None])
            if (causal and k0 + bk - 1 > q0) or k0 + bk > s_k:
                bad = keys[None, :] >= s_k
                if causal:
                    bad = bad | (keys[None, :] > rows[:, None])
                p = p.masked_fill(bad, 0.0)
            ds = p * (dos @ vx[bh, k0:k0 + bk].T - dl[bh, q0:q0 + bq, None])
            acc += _bf16(ds, round_ops) @ kb
        dq[bh, q0:q0 + bq] = acc * scale
    return dq.view(b, h, -1, d)[:, :, :s]


def tile_dkv(q, k, v, g, lse, delta, causal, round_ops):
    """B4's arithmetic, block by block as flash_bwd_dkv_plan's schedule
    runs it: per key tile, the transposed score tile over the block's q
    steps of each of the group's n_rep q heads, summed in fp32; (dk, dv)
    unexpanded. A tile no block computes stays NaN."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    plan = tattn.flash_bwd_dkv_plan(b, h, kvh, s, k.shape[2], d, causal)
    bk, bq, n_rep = plan.block_rows, plan.step_rows, plan.n_rep
    scale = d ** -0.5
    sl2 = scale * LOG2E
    rows_q = -(-s // bq) * bq
    qx = _pad_rows(q, rows_q).flatten(0, 1)
    gx = _pad_rows(g, rows_q).flatten(0, 1)
    # a row past the end reads LSE = +inf: its probabilities are 0
    lse2 = _pad_rows((lse * LOG2E).flatten(0, 1), rows_q, torch.inf)
    dl = _pad_rows(delta.flatten(0, 1), rows_q)
    kx = _pad_rows(k, plan.tiles * bk).flatten(0, 1)
    vx = _pad_rows(v, plan.tiles * bk).flatten(0, 1)
    dk = torch.full_like(kx, torch.nan)
    dv = torch.full_like(vx, torch.nan)
    for bkv, t, first, end in plan.schedule().tolist():
        k0 = t * bk
        keys = torch.arange(k0, k0 + bk)
        kb, vb = kx[bkv, k0:k0 + bk], vx[bkv, k0:k0 + bk]
        dka = torch.zeros(bk, d)
        dva = torch.zeros(bk, d)
        for bh in range(bkv * n_rep, (bkv + 1) * n_rep):
            for i in range(first, end):
                q0 = i * bq
                qs, dos = qx[bh, q0:q0 + bq], gx[bh, q0:q0 + bq]
                st = kb @ qs.T                                 # [bk, bq]
                dpt = vb @ dos.T
                pt = torch.exp2(st * sl2 - lse2[bh, None, q0:q0 + bq])
                if causal and k0 + bk - 1 > q0:
                    qrows = torch.arange(q0, q0 + bq)
                    pt = pt.masked_fill(keys[:, None] > qrows[None, :], 0.0)
                dst = pt * (dpt - dl[bh, None, q0:q0 + bq])
                dva += _bf16(pt, round_ops) @ dos
                dka += _bf16(dst, round_ops) @ qs
        dk[bkv, k0:k0 + bk] = dka * scale
        dv[bkv, k0:k0 + bk] = dva
    return (dk.view(b, kvh, -1, d)[:, :, :s],
            dv.view(b, kvh, -1, d)[:, :, :s])


def _inputs(seq, dim, n_rep, seed):
    rng = np.random.default_rng(seed)
    heads = 4
    q = rng.standard_normal((1, heads, seq, dim), dtype=np.float32)
    k, v = (rng.standard_normal((1, heads // n_rep, seq, dim),
                                dtype=np.float32) for _ in range(2))
    return q, k, v


def _blocks(seq):
    """Pallas blocks that divide seq (interpret mode needs no more)."""
    return (128, 128) if seq % 128 == 0 else (seq, seq)


@pytest.mark.parametrize("seq,dim,n_rep,causal", [
    (63, 64, 1, True), (129, 128, 4, True), (200, 64, 4, False),
    (200, 128, 1, True), (65, 64, 4, True), (256, 128, 1, False),
    (129, 256, 2, True),
])
def test_tile_model_forward_matches_pallas_interpret(seq, dim, n_rep, causal):
    """The model's O and natural-log LSE against the reference's Pallas
    forward (``_flash_forward``, interpret mode) over repeat_kv-expanded
    K/V: exact up to summation order with P in fp32, within bf16's
    rounding with P rounded as the kernel rounds it."""
    q, k, v = _inputs(seq, dim, n_rep, seed=seq + dim + n_rep)
    bq, bk = _blocks(seq)
    want_o, want_l = jattn._flash_forward(
        jnp.asarray(q), jnp.asarray(np.repeat(k, n_rep, 1)),
        jnp.asarray(np.repeat(v, n_rep, 1)), causal, bq, bk, True,
        dim ** -0.5)
    want_o, want_l = np.asarray(want_o), np.asarray(want_l)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = tile_forward(tq, tk, tv, causal, round_p=False)
    np.testing.assert_allclose(out.numpy(), want_o, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), want_l, atol=1e-5, rtol=1e-5)
    out, lse = tile_forward(tq, tk, tv, causal, round_p=True)
    assert np.abs(out.numpy() - want_o).max() <= 2e-2
    np.testing.assert_allclose(lse.numpy(), want_l, atol=1e-5, rtol=1e-5)


def _jax_backward(seq, dim, n_rep, causal, seed):
    """Inputs from ``seed``, random cotangents on both outputs, and
    jax.vjp of the reference's flash_attention_with_lse (Pallas backward
    in interpret mode) over repeat_kv: ((q, k, v, g, lse, delta) as torch
    tensors, (dq, dk, dv) as numpy arrays)."""
    q, k, v = _inputs(seq, dim, n_rep, seed=seed)
    rng = np.random.default_rng(seq)
    g = rng.standard_normal(q.shape, dtype=np.float32)
    g_lse = rng.standard_normal(q.shape[:3], dtype=np.float32)
    bq, bk = _blocks(seq)

    def fn(q_, k_, v_):
        return jattn.flash_attention_with_lse(
            q_, jnp.repeat(k_, n_rep, axis=1), jnp.repeat(v_, n_rep, axis=1),
            causal=causal, block_q=bq, block_k=bk, interpret=True)

    (out, lse), vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    want = tuple(np.asarray(x)
                 for x in vjp((jnp.asarray(g), jnp.asarray(g_lse))))
    out, lse, tg, tgl = (torch.from_numpy(np.array(x))
                         for x in (out, lse, g, g_lse))
    delta = tattn.attention_delta(out, tg, tgl)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    return (tq, tk, tv, tg, lse, delta), want


def _assert_close(got, want, tol):
    """fp32 operands: atol/rtol 5e-4; bf16-rounded: ``tol`` of the
    largest value."""
    assert got.shape == want.shape
    if tol is None:
        np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=5e-4)
    else:
        assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("seq,dim,n_rep,causal", [
    (129, 64, 4, True), (200, 128, 1, True), (63, 64, 4, False),
    (200, 64, 4, True), (129, 256, 2, True),
])
def test_tile_model_dkv_matches_jax_vjp(seq, dim, n_rep, causal):
    """The model's dK/dV, summed over each GQA group, against jax.vjp of
    the reference's flash_attention_with_lse (Pallas backward in interpret
    mode) over repeat_kv, with random cotangents on both outputs."""
    args, (_, want_dk, want_dv) = _jax_backward(
        seq, dim, n_rep, causal, seed=2 * seq + dim + n_rep)
    for round_ops, tol in ((False, None), (True, 2e-2)):
        dk, dv = tile_dkv(*args, causal, round_ops)
        _assert_close(dk, want_dk, tol)
        _assert_close(dv, want_dv, tol)


@pytest.mark.parametrize("seq,dim,n_rep,causal", [
    (129, 64, 4, True), (200, 128, 1, True), (63, 128, 4, False),
    (256, 64, 1, False), (200, 256, 1, True),
])
def test_tile_model_dq_matches_jax_vjp(seq, dim, n_rep, causal):
    """The model's dQ against jax.vjp of the reference's
    flash_attention_with_lse (Pallas backward in interpret mode) over
    repeat_kv, with random cotangents on both outputs: ragged lengths,
    GQA read in place, d = 64 (128-key stages), d = 128 (64-key stages)
    and d = 256 (32-key stages), causal and not."""
    args, (want_dq, _, _) = _jax_backward(
        seq, dim, n_rep, causal, seed=3 * seq + dim + n_rep)
    for round_ops, tol in ((False, None), (True, 2e-2)):
        _assert_close(tile_dq(*args, causal, round_ops), want_dq, tol)
