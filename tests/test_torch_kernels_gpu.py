"""The port's CUDA kernels on the card (``gpu`` marker; skipped without
a CUDA device, since a CUDA kernel has no CPU mode).

Run on the machine with the card, which has no JAX — so this file
imports only the port:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q

Each kernel against its plain PyTorch version on the same inputs (made
with numpy from a seed), then the model and the continuous engine with
the kernel against the plain path, and two training steps through the
backward kernels. Tolerances: forward float32 1e-4 (summation order
only), bfloat16 3e-2 (the plain version rounds QK^T to bf16, the kernel
keeps fp32); backward relative to the largest gradient, float32 1e-4,
bfloat16 5e-2 (the kernels round P and dS to bf16 for the tensor-core
products; the reference's own bf16 backward bar is 0.25,
tests/test_workloads.py:147-150).
"""

import sys

import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu_torch.models import handoff as kv_handoff
from k8s_device_plugin_tpu_torch.models import transformer
from k8s_device_plugin_tpu_torch.models.serve import (
    ContinuousBatcher,
    LMServer,
)
from k8s_device_plugin_tpu_torch.ops import attention, paged_attention

pytestmark = pytest.mark.gpu

# head_dim 64: a shape the kernel takes (d in {64, 128})
SMALL = transformer.LMConfig(vocab_size=256, num_layers=2, num_heads=2,
                             embed_dim=128, mlp_dim=256, max_seq_len=128,
                             dtype=torch.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(shape, kv_heads, dtype, seed=0):
    rng = np.random.default_rng(seed)
    b, h, s, d = shape
    out = []
    for heads in (h, kv_heads, kv_heads):
        a = rng.standard_normal((b, heads, s, d), dtype=np.float32)
        out.append(torch.from_numpy(a).cuda().to(dtype))
    return out


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("shape,kv_heads", [((2, 8, 200, 64), 2),
                                            ((1, 4, 256, 128), 4)])
def test_flash_kernel_matches_plain(cuda, shape, kv_heads, dtype, tol,
                                    causal):
    q, k, v = _qkv(shape, kv_heads, dtype)
    before = attention.FLASH_FWD.launches
    got_o, got_l = attention.flash_attention_with_lse(q, k, v, causal)
    torch.cuda.synchronize()
    assert attention.FLASH_FWD.launches == before + 1
    want_o, want_l = attention.reference_attention_with_lse(q, k, v, causal)
    assert got_o.dtype == dtype and got_l.dtype == torch.float32
    assert (got_o.float() - want_o.float()).abs().max().item() <= tol
    assert (got_l - want_l).abs().max().item() <= tol


# Tile edges of the Hopper bf16 kernels (128-row q tiles and 128-key stages
# in B1, 64 at d = 256; 128-row q tiles and 128-, 64- or 32-key stages in
# B3; 128-key blocks and 64-row q steps in B4, 32 at d = 256): one row, one
# short of and one past a tile, ragged, and the flagship length.
EDGE_SEQS = [1, 127, 129, 200, 2048]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dim", [64, 128, 256])
@pytest.mark.parametrize("seq", EDGE_SEQS)
def test_hopper_forward_tile_edges(cuda, seq, dim, causal):
    """B1's bf16 kernel (TMA + wgmma) against the plain version at the
    tile edges, GQA with 2 q heads per kv head."""
    q, k, v = _qkv((1 if seq > 1000 else 2, 4, seq, dim), 2, torch.bfloat16,
                   seed=seq + dim)
    out, lse = attention.flash_forward_cuda(q, k, v, causal)
    torch.cuda.synchronize()
    want_o, want_l = attention.reference_attention_with_lse(q, k, v, causal)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert (out.float() - want_o.float()).abs().max().item() <= 3e-2
    assert (lse - want_l).abs().max().item() <= 3e-2


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dim", [64, 128, 256])
@pytest.mark.parametrize("seq", EDGE_SEQS)
def test_hopper_backward_tile_edges(cuda, seq, dim, causal):
    """B3's and B4's bf16 kernels against the plain backward at the tile
    edges, GQA with 4 q heads per kv head (read in place by B3, summed
    inside the block by B4)."""
    shape = (1, 8, seq, dim)
    q, k, v = _qkv(shape, 2, torch.bfloat16, seed=seq + dim + 1)
    rng = np.random.default_rng(seq)
    g = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    g = g.cuda().to(torch.bfloat16)
    g_lse = torch.from_numpy(
        rng.standard_normal(shape[:3], dtype=np.float32)).cuda()
    out, lse = attention.flash_forward_cuda(q, k, v, causal)
    got = attention.flash_backward_cuda(q, k, v, out, lse, g, g_lse,
                                        causal=causal)
    torch.cuda.synchronize()
    want = attention.reference_attention_backward(q, k, v, out, lse, g,
                                                  g_lse, causal=causal)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert _rel_err(a, b) <= 5e-2


def test_hopper_dkv_is_deterministic(cuda):
    """B4 sums the GQA group in registers, without atomics: two launches on
    the same inputs give bitwise-equal dK and dV."""
    shape = (2, 8, 640, 128)
    q, k, v = _qkv(shape, 2, torch.bfloat16, seed=21)
    g = _qkv(shape, 8, torch.bfloat16, seed=22)[0]
    out, lse = attention.flash_forward_cuda(q, k, v, True)
    delta = attention.attention_delta(out, g)
    first = attention.flash_bwd_dkv_cuda(q, k, v, g, lse, delta, True)
    second = attention.flash_bwd_dkv_cuda(q, k, v, g, lse, delta, True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_hopper_dq_is_deterministic(cuda):
    """One B3 block owns each dQ row, and no atomics are used: two
    launches on the same inputs give bitwise-equal dQ."""
    shape = (2, 8, 640, 128)
    q, k, v = _qkv(shape, 2, torch.bfloat16, seed=23)
    g = _qkv(shape, 8, torch.bfloat16, seed=24)[0]
    out, lse = attention.flash_forward_cuda(q, k, v, True)
    delta = attention.attention_delta(out, g)
    first = attention.flash_bwd_dq_cuda(q, k, v, g, lse, delta, True)
    second = attention.flash_bwd_dq_cuda(q, k, v, g, lse, delta, True)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and first.abs().max() > 0


PLANS = {"b1": attention.flash_fwd_plan, "b3": attention.flash_bwd_dq_plan,
         "b4": attention.flash_bwd_dkv_plan}


@pytest.mark.parametrize("kernel", sorted(PLANS))
def test_hopper_kernels_follow_the_plan_schedule(cuda, monkeypatch, kernel):
    """Each block computes what its row of the launch plan's schedule
    says: the rows in reverse launch order give bitwise-equal results,
    and emptying one row's step range leaves that tile zero."""
    shape = (2, 8, 300, 128)
    q, k, v = _qkv(shape, 2, torch.bfloat16, seed=31)
    g = _qkv(shape, 8, torch.bfloat16, seed=32)[0]
    out, lse = attention.flash_forward_cuda(q, k, v, True)
    delta = attention.attention_delta(out, g)

    def run():
        if kernel == "b1":
            res = attention.flash_forward_cuda(q, k, v, True)[0]
        elif kernel == "b3":
            res = attention.flash_bwd_dq_cuda(q, k, v, g, lse, delta, True)
        else:
            res = attention.flash_bwd_dkv_cuda(q, k, v, g, lse, delta, True)[0]
        return res.flatten(0, 1)

    def emptied(plan, device):
        rows = plan.schedule()
        rows[0, 3] = rows[0, 2]
        return rows.to(device)

    want = run()
    monkeypatch.setattr(attention, "_schedule_on", lambda plan, device:
                        plan.schedule().flip(0).contiguous().to(device))
    flipped = run()
    monkeypatch.setattr(attention, "_schedule_on", emptied)
    cut = run()
    torch.cuda.synchronize()
    assert torch.equal(flipped, want)
    plan = PLANS[kernel](2, 8, 2, 300, 300, 128, True)
    group, tile = plan.schedule()[0, :2].tolist()
    rows = slice(tile * plan.block_rows, (tile + 1) * plan.block_rows)
    assert (cut[group, rows] == 0).all() and want[group, rows].abs().max() > 0
    cut[group, rows] = want[group, rows]
    assert torch.equal(cut, want)


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def _grads(q, k, v, causal, fn):
    """(out, lse, dq, dk, dv) of ``fn`` and of the plain forward under
    autograd, with a random output cotangent and a nonzero lse one."""
    rng = np.random.default_rng(7)
    g = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32))
    g_lse = torch.from_numpy(
        rng.standard_normal(q.shape[:3], dtype=np.float32))
    g, g_lse = g.to(q.device, q.dtype), g_lse.to(q.device)
    res = []
    for f in (fn, attention.reference_attention_with_lse):
        qq, kk, vv = (x.detach().clone().requires_grad_() for x in (q, k, v))
        out, lse = f(qq, kk, vv, causal)
        torch.autograd.backward((out, lse), (g, g_lse))
        res.append((out.detach(), lse.detach(), qq.grad, kk.grad, vv.grad))
    return res


@pytest.mark.parametrize("dim", [32, 192, 256, 384])
def test_flash_kernel_raises_on_unsupported_head_dim(cuda, dim):
    """d = 32 and d = 192 are zero-padded to the kernels' 64 and 256,
    d = 256 runs its own instance: each matches the plain version,
    forward and backward. d = 384 (above 256) raises, naming ROADMAP's
    queue C."""
    q, k, v = _qkv((1, 2, 128, dim), 2, torch.float32)
    if dim > 256:
        with pytest.raises(ValueError, match="head dim.*ROADMAP"):
            attention.flash_attention(q, k, v, causal=True)
        return
    got, want = _grads(q, k, v, True, attention.flash_attention_with_lse)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert _rel_err(a, b) <= 1e-4


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("shape,kv_heads", [((2, 8, 200, 64), 2),
                                            ((1, 4, 256, 128), 4)])
def test_flash_backward_kernels_match_plain(cuda, shape, kv_heads, dtype,
                                            tol, causal):
    """B3 and B4, one launch each, against the plain backward on the same
    saved tensors, with a random g and a nonzero g_lse."""
    q, k, v = _qkv(shape, kv_heads, dtype)
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    g = g.cuda().to(dtype)
    g_lse = torch.from_numpy(
        rng.standard_normal(shape[:3], dtype=np.float32)).cuda()
    out, lse = attention.flash_forward_cuda(q, k, v, causal)
    dq0 = attention.FLASH_BWD_DQ.launches
    dkv0 = attention.FLASH_BWD_DKV.launches
    got = attention.flash_backward_cuda(q, k, v, out, lse, g, g_lse,
                                        causal=causal)
    torch.cuda.synchronize()
    assert attention.FLASH_BWD_DQ.launches == dq0 + 1
    assert attention.FLASH_BWD_DKV.launches == dkv0 + 1
    want = attention.reference_attention_backward(q, k, v, out, lse, g,
                                                  g_lse, causal=causal)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert torch.isfinite(a).all()
        assert _rel_err(a, b) <= tol


def test_autograd_through_kernels_matches_plain(cuda):
    """A loss on both outputs through FlashAttention on the card (B1, B3,
    B4) against autograd of the plain forward."""
    q, k, v = _qkv((2, 8, 200, 64), 2, torch.float32, seed=4)
    (o, lse, *got), (wo, wlse, *want) = _grads(
        q, k, v, True, attention.flash_attention_with_lse)
    assert _rel_err(o, wo) <= 1e-4 and _rel_err(lse, wlse) <= 1e-4
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= 1e-4


def test_two_train_steps_on_card(cuda, monkeypatch):
    """Two AdamW steps of a small float32 model: each kernel launches
    once per layer per step, and losses and gradients equal those of
    plain attention."""
    cfg = transformer.LMConfig(vocab_size=256, num_layers=2, num_heads=2,
                               embed_dim=128, mlp_dim=256, max_seq_len=128,
                               dtype=torch.float32)
    toks = torch.from_numpy(
        np.random.default_rng(5).integers(0, 256, (2, 128))).cuda()

    def run():
        step, init = transformer.make_train_step(cfg, cuda)
        model, opt = init(0)
        losses = [step(model, opt, toks).item() for _ in range(2)]
        return losses, [p.grad.clone() for p in model.parameters()]

    counters = (attention.FLASH_FWD, attention.FLASH_BWD_DQ,
                attention.FLASH_BWD_DKV)
    before = [c.launches for c in counters]
    losses, grads = run()
    assert [c.launches - b for c, b in zip(counters, before)] == [4, 4, 4]
    monkeypatch.setattr(transformer, "flash_attention",
                        attention.reference_attention)
    want_losses, want_grads = run()
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    for a, b in zip(grads, want_grads):
        assert _rel_err(a, b) <= 1e-3


def test_model_prefill_kernel_matches_plain(cuda, monkeypatch):
    srv = LMServer(config=SMALL, device=cuda)
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, (2, 128))).cuda()
    got, _ = srv._prefill(toks)
    monkeypatch.setattr(transformer, "flash_attention",
                        attention.reference_attention)
    want, _ = srv._prefill(toks)
    assert (got - want).abs().max().item() <= 1e-4


def test_continuous_engine_on_card_matches_oracle(cuda):
    srv = LMServer(config=SMALL, device=cuda)
    jobs = [([5, 17, 99], 7), ([7, 3, 42, 11], 23), ([1], 4), ([88, 2], 12)]
    want = [srv.complete(p, n)[0] for p, n in jobs]
    eng = ContinuousBatcher(srv, max_batch=4, segment_tokens=4)
    before = attention.FLASH_FWD.launches
    reqs = [eng.submit_async(p, n) for p, n in jobs]
    got = [eng.wait(r, timeout=120)[0] for r in reqs]
    assert got == want
    assert attention.FLASH_FWD.launches > before
    assert eng.drain(timeout=30)


def paged_inputs(batch, L, heads, kv_heads, d, page_tokens, lens, dtype,
                 seed=0):
    """Pools of random pages, each row's pages in a scrambled order, and
    q at positions lens + arange(L); a row with lens[r] < 0 has every
    table slot on scratch page 0 (at positions 0 .. L - 1). Returns (q,
    k_pages, v_pages, bt, q_pos) on the card, the table and positions
    int64 as the serving engine holds them."""
    rng = np.random.default_rng(seed)
    span = max(max(lens) + L, L)
    W = -(-span // page_tokens)
    pool_pages = 1 + batch * W
    perm = rng.permutation(np.arange(1, pool_pages)).reshape(batch, W)
    bt = np.where(np.asarray(lens)[:, None] < 0, 0, perm).astype(np.int64)
    q_pos = np.maximum(np.asarray(lens), 0)[:, None] + np.arange(L)

    def rand(*shape):
        a = rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(a).cuda().to(dtype)

    return (rand(batch, L, heads, d),
            rand(pool_pages, page_tokens, kv_heads, d),
            rand(pool_pages, page_tokens, kv_heads, d),
            torch.from_numpy(bt).cuda(),
            torch.from_numpy(q_pos.astype(np.int64)).cuda())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("L,heads,kv_heads,d,page_tokens", [
    (1, 16, 16, 64, 16),     # decode at the serving default
    (64, 16, 16, 64, 16),    # a prefill chunk at the serving default
    (1, 8, 2, 128, 8),       # GQA decode
    (5, 8, 1, 64, 8),        # MQA, a short chunk
    (3, 4, 2, 256, 16),      # d = 256
    (2, 4, 4, 16, 8),        # the tiny config's head dim
    (8, 16, 2, 128, 16),     # GQA chunk: n_rep * L = 64 query rows
    (32, 16, 4, 64, 16),     # GQA chunk over two 64-row query tiles
    (1, 32, 2, 64, 16),      # GQA decode with 16 q heads a kv head
    (16, 8, 8, 256, 16),     # d = 256 on the chunk route (bf16)
    (64, 8, 8, 24, 16),      # d = 24: a 16-column step half zero-filled
])
def test_paged_attention_kernel_matches_plain(cuda, L, heads, kv_heads, d,
                                              page_tokens, dtype, tol):
    """B2 against the plain paged read on the same pools and tables:
    ragged row lengths up to 1000, one row all on scratch page 0. bf16
    with n_rep * L >= 16 takes the chunk route (tensor-core tiles), the
    rest the decode route (paged_attn_plan). bf16 is also held row by row
    against the read in float32 from the same operands (P rounded on the
    chunk route), where a mis-weighted split shows on a long row. The
    combine is counted when the plan splits the keys."""
    lens = [1000, 37, 0, -1]
    args = paged_inputs(4, L, heads, kv_heads, d, page_tokens, lens, dtype,
                        seed=d + L)
    plan = paged_attention.paged_attn_plan(4, L, heads, kv_heads, d,
                                           page_tokens, args[3].shape[1],
                                           dtype)
    before = paged_attention.PAGED_ATTN.launches
    combined = paged_attention.PAGED_ATTN_COMBINE.launches
    got = paged_attention.paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_attention.PAGED_ATTN.launches == before + 1
    assert paged_attention.PAGED_ATTN_COMBINE.launches == combined + int(
        plan.n_splits > 1)
    want = paged_attention.paged_attention_reference(*args)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= tol
    if dtype == torch.bfloat16:
        close = paged_attention.paged_attention_fp32(
            *args, round_p=plan.route == "chunk")
        assert paged_attention.row_rel_err(got, close) <= \
            paged_attention.PAGED_BF16_ROW_TOL


@pytest.mark.parametrize("L,dtype", [(64, torch.bfloat16),
                                     (1, torch.bfloat16),
                                     (1, torch.float32)])
def test_paged_attention_kernel_is_deterministic(cuda, L, dtype):
    """A fixed accumulation order (tiles, reduction trees, the combine in
    split order, no atomics): two launches are bit-equal on both
    routes."""
    args = paged_inputs(4, L, 16, 4, 64, 16, [900, 300, 5, 0], dtype,
                        seed=9)
    plan = paged_attention.paged_attn_plan(4, L, 16, 4, 64, 16,
                                           args[3].shape[1], dtype)
    assert plan.n_splits > 1
    first = paged_attention.paged_attention(*args)
    second = paged_attention.paged_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("L,dtype,tol", [(1, torch.bfloat16, 2e-2),
                                         (64, torch.bfloat16, 2e-2),
                                         (1, torch.float32, 1e-5)])
def test_paged_attention_kernel_split_edges(cuda, L, dtype, tol):
    """Rows whose keys end on the last key of a split, start a split,
    sit at position 0, and one on scratch page 0: the splits past each
    row's last key are empty and weigh nothing (bf16 also row by row
    against the float32 read)."""
    args = list(paged_inputs(4, L, 16, 16, 64, 16, [1000, 0, 0, -1],
                             dtype, seed=L))
    plan = paged_attention.paged_attn_plan(4, L, 16, 16, 64, 16,
                                           args[3].shape[1], dtype)
    kps = plan.keys_per_split
    assert plan.n_splits >= 3
    ar = torch.arange(L, device="cuda", dtype=torch.int64)
    args[4][0] = kps - L + ar           # ends on split 0's last key
    args[4][1] = kps + ar               # starts split 1
    args[4][2] = 2 * kps - 1 + ar       # from split 1's last key on
    got = paged_attention.paged_attention(*args)
    torch.cuda.synchronize()
    want = paged_attention.paged_attention_reference(*args)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= tol
    if dtype == torch.bfloat16:
        close = paged_attention.paged_attention_fp32(
            *args, round_p=plan.route == "chunk")
        assert paged_attention.row_rel_err(got, close) <= \
            paged_attention.PAGED_BF16_ROW_TOL


@pytest.mark.parametrize("kv_heads", [16, 4])
@pytest.mark.parametrize("L", [2, 4, 5])
def test_paged_attention_kernel_at_the_verify_width(cuda, L, kv_heads):
    """The speculative verify block: L = k query rows a sequence at
    positions lens .. lens + L - 1 (rows at 1019/700/301/37, bf16, the
    serving default's 16 heads, d = 64). MHA gives n_rep·L < 16 rows, so
    the decode route in bf16 with a causal mask per query row inside a
    tile; GQA with 4 q heads a kv head reaches 16 rows at L = 4, the
    chunk route. Against the plain read, row by row against the float32
    read, and two launches bit-equal."""
    args = paged_inputs(4, L, 16, kv_heads, 64, 16, [1019, 700, 301, 37],
                        torch.bfloat16, seed=L * kv_heads)
    plan = paged_attention.paged_attn_plan(4, L, 16, kv_heads, 64, 16,
                                           args[3].shape[1], torch.bfloat16)
    assert plan.route == ("chunk" if 16 // kv_heads * L >= 16
                          else "decode")
    got = paged_attention.paged_attention(*args)
    again = paged_attention.paged_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = paged_attention.paged_attention_reference(*args)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    close = paged_attention.paged_attention_fp32(
        *args, round_p=plan.route == "chunk")
    assert paged_attention.row_rel_err(got, close) <= \
        paged_attention.PAGED_BF16_ROW_TOL


def test_paged_spec_engine_on_card_matches_plain(cuda):
    """The paged engine with a self-draft on the card (B2 at L = 1 for
    the draft steps, L = k for the verify block) decodes the plain
    path's tokens in float32."""
    srv = LMServer(config=SMALL, device=cuda)
    srv.enable_draft(1, k=3)
    jobs = [([5, 17, 99], 7), ([7, 3, 42, 11], 23), ([1], 4), ([88, 2], 12)]
    want = [srv.complete(p, n)[0] for p, n in jobs]
    eng = ContinuousBatcher(srv, max_batch=4, segment_tokens=4,
                            kv_mode="paged", page_tokens=16)
    before = paged_attention.PAGED_ATTN.launches
    reqs = [eng.submit_async(p, n) for p, n in jobs]
    got = [eng.wait(r, timeout=120)[0] for r in reqs]
    assert got == want
    assert srv.spec_stats_snapshot()["verify_rounds"] > 0
    assert paged_attention.PAGED_ATTN.launches > before
    assert eng.drain(timeout=30)


def test_handoff_page_block_round_trip_bf16_on_card(cuda, monkeypatch):
    """``export_pages`` -> bundle bytes -> ``import_pages`` on the card
    in bfloat16, with ``ml_dtypes`` unimportable: the pages land
    bit-equal at other page ids of another pool."""
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    srv = LMServer(config=transformer.LMConfig(
        vocab_size=256, num_layers=2, num_heads=2, embed_dim=128,
        mlp_dim=256, max_seq_len=128), device=cuda)
    src = srv.make_paged_pool(12, 16)
    gen = torch.Generator(device=cuda).manual_seed(5)
    with torch.inference_mode():
        for p in src.k_pages + src.v_pages:
            p.copy_(torch.randn(p.shape, generator=gen, device=cuda))
    ids, dst_ids = [4, 9, 1, 7, 2], [11, 3, 8, 5, 6]
    wire = kv_handoff.PageBlockBundle.from_pool_payload(
        srv.export_pages(src, ids), lease_id="gpu", lease_s=30.0,
        window=list(range(70)), first_token=0, first_lp=0.0, budget=1,
        temp=0.0, topk=0, want_lp=False, slo="standard",
        page_tokens=16).to_bytes()
    assert b'"dtype": "bfloat16"' in wire
    dst = srv.import_pages(srv.make_paged_pool(12, 16), dst_ids,
                           kv_handoff.PageBlockBundle.from_bytes(
                               wire).to_pool_payload())
    for a, b in zip(src.k_pages + src.v_pages, dst.k_pages + dst.v_pages):
        assert b.dtype == torch.bfloat16 and b.device == a.device
        assert torch.equal(a[ids].view(torch.int16),
                           b[dst_ids].view(torch.int16))


def test_handoff_pair_matches_single_paged_engine_on_card(cuda):
    """A prefill/decode pair of paged engines over the in-process
    transport on the card (B2's chunk route on the prefill side, its
    decode route on the decode side) decodes the single paged engine's
    tokens in float32, logprobs within 1e-4, every request handed
    off."""
    srv = LMServer(config=SMALL, device=cuda)
    prompts = [list(range(3, 40)), [5, 17, 99], list(range(3, 19)) + [7]]

    def serve(eng):
        out = []
        for p in prompts:
            req = eng.submit_async(p, 12, logprobs=True)
            eng.wait(req, timeout=120)
            out.append((req.slot["tokens"], req.slot["logprobs"]))
        return out

    def engine(**kw):
        return ContinuousBatcher(srv, max_batch=4, segment_tokens=4,
                                 kv_mode="paged", page_tokens=16, **kw)

    single = engine()
    want = serve(single)
    assert single.drain(timeout=30)
    prefill = engine(role="prefill")
    client = kv_handoff.HandoffClient(kv_handoff.InProcTransport(prefill),
                                      peer="inproc")
    decode = engine(role="decode", handoff_client=client)
    before = paged_attention.PAGED_ATTN.launches
    got = serve(decode)
    assert paged_attention.PAGED_ATTN.launches > before
    assert [t for t, _ in got] == [t for t, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert max(abs(a - b) for a, b in zip(g, w)) <= 1e-4
    assert len(client.latencies_s) == len(prompts)
    assert decode.drain(timeout=30)
    assert prefill.drain(timeout=30)


@pytest.mark.parametrize("L", [1, 64])
def test_paged_attention_kernel_replays_in_a_cuda_graph(cuda, L):
    """B2's grid and workspace depend on shapes only: a launch captured
    in a CUDA graph, replayed after bt and q_pos change in place (new
    pages, new lengths), equals an eager launch on the new tables."""
    args = paged_inputs(4, L, 16, 16, 64, 16, [1000, 300, 17, 0],
                        torch.bfloat16, seed=L + 1)
    q, kp, vp, bt, q_pos = args
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        paged_attention.paged_attention(q, kp, vp, bt, q_pos)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = paged_attention.paged_attention(q, kp, vp, bt, q_pos)
    rng = np.random.default_rng(L)
    bt.copy_(torch.from_numpy(
        rng.permutation(bt.cpu().numpy().ravel()).reshape(bt.shape)))
    new_lens = torch.tensor([40, 990, 0, 511], device="cuda")
    q_pos.copy_(new_lens[:, None] + torch.arange(L, device="cuda"))
    graph.replay()
    torch.cuda.synchronize()
    want = paged_attention.paged_attention(q, kp, vp, bt, q_pos)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    plain = paged_attention.paged_attention_reference(q, kp, vp, bt, q_pos)
    assert (out.float() - plain.float()).abs().max().item() <= 2e-2


# ---------------------------------------------------------------------------
# the static batcher and checkpoint serving on the card
# ---------------------------------------------------------------------------

def test_static_batcher_on_card_matches_complete_batch(cuda):
    """The static Batcher (one coalesced batch, prefilled through B1)
    decodes complete_batch's tokens in float32."""
    from k8s_device_plugin_tpu_torch.models.serve import Batcher

    srv = LMServer(config=SMALL, device=cuda)
    jobs = [([5, 17, 99], 7), ([7, 3, 42, 11], 6), ([1], 4), ([88, 2], 5)]
    want, _ = srv.complete_batch([p for p, _ in jobs],
                                 [n for _, n in jobs])
    srv.warmup(decode_tokens=7, max_batch=4)
    b = Batcher(srv, max_batch=4, window_ms=60_000.0)
    before = attention.FLASH_FWD.launches
    reqs = [b.submit_async(p, n) for p, n in jobs]
    got = [b.wait(r, timeout=120)[0] for r in reqs]
    assert got == want
    # one group (all budgets share the 8-step bucket): one prefill
    assert attention.FLASH_FWD.launches - before == SMALL.num_layers
    assert b.drain(timeout=30)


def test_checkpoint_on_card_equals_in_memory_model(cuda, tmp_path):
    """A checkpoint saved from the card and served from the directory
    decodes the in-memory model's tokens, logprobs bit-equal (float32,
    GQA with 8 q heads a kv head, as TinyLlama's)."""
    import dataclasses

    from k8s_device_plugin_tpu_torch.models import params as tparams

    cfg = transformer.LMConfig(
        vocab_size=512, num_layers=2, num_heads=16, num_kv_heads=2,
        embed_dim=1024, mlp_dim=512, max_seq_len=256, position="rope",
        mlp_act="swiglu", norm_eps=1e-5, eos_token_id=-1,
        dtype=torch.float32)
    model = transformer.DecoderLM(cfg, param_dtype=torch.float32).to(cuda)
    state = transformer.init_params(model, seed=7).state_dict()
    tparams.save_checkpoint(str(tmp_path), cfg, state)
    loaded = LMServer(checkpoint=str(tmp_path), device=cuda)
    memory = LMServer(config=cfg, params=state, device=cuda)
    assert loaded.config == cfg
    prompts = [list(range(1, 200)), [5, 17, 99], [42] * 40]
    budgets = [12, 20, 7]
    a = loaded.complete_batch(prompts, budgets, return_logprobs=True)
    b = memory.complete_batch(prompts, budgets, return_logprobs=True)
    assert a[0] == b[0] and a[1] == b[1]
    # bf16 serving of the same file: the cast is the serving map's
    bf16 = LMServer(config=dataclasses.replace(cfg, dtype=torch.bfloat16),
                    checkpoint=str(tmp_path), device=cuda)
    want = tparams.params_from_jax(tparams.params_to_jax(state, cfg),
                                   dataclasses.replace(
                                       cfg, dtype=torch.bfloat16))
    for k, v in bf16.model.state_dict().items():
        assert torch.equal(v.cpu(), want[k]), k


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_flash_kernel_at_n_rep_8(cuda, dtype, tol):
    """B1 with 32 q heads over 4 kv heads (TinyLlama's attention)."""
    q, k, v = _qkv((2, 32, 300, 64), 4, dtype, seed=8)
    got_o, got_l = attention.flash_attention_with_lse(q, k, v, True)
    want_o, want_l = attention.reference_attention_with_lse(q, k, v, True)
    assert (got_o.float() - want_o.float()).abs().max().item() <= tol
    assert (got_l - want_l).abs().max().item() <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("L", [1, 64])
def test_paged_attention_kernel_at_n_rep_8(cuda, L, dtype, tol):
    """B2 with 32 q heads over 4 kv heads: at L = 1 (n_rep·L = 8) the
    decode route, at a 64-token chunk the chunk route in bf16."""
    args = paged_inputs(4, L, 32, 4, 64, 16, [2000, 700, 37, -1], dtype,
                        seed=L)
    plan = paged_attention.paged_attn_plan(4, L, 32, 4, 64, 16,
                                           args[3].shape[1], dtype)
    if dtype == torch.bfloat16:
        assert plan.route == ("decode" if L == 1 else "chunk")
    got = paged_attention.paged_attention(*args)
    want = paged_attention.paged_attention_reference(*args)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= tol
    if dtype == torch.bfloat16:
        close = paged_attention.paged_attention_fp32(
            *args, round_p=plan.route == "chunk")
        assert paged_attention.row_rel_err(got, close) <= \
            paged_attention.PAGED_BF16_ROW_TOL


# ---------------------------------------------------------------------------
# out-of-vocab ids: NaN K/V stay inside their request (ROADMAP C6)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,dtype", [(1, torch.bfloat16), (64, torch.bfloat16),
                                     (1, torch.float32)])
def test_paged_attention_kernel_never_reads_stale_nan(cuda, L, dtype):
    """NaN in every pool slot past each row's last query position (a
    freed page's stale entries, the scratch page): B2's output is finite
    and bit-equal to the launch over the same pools with those slots
    finite, on both routes."""
    lens = [1000, 37, 0, -1]
    q, k, v, bt, q_pos = paged_inputs(4, L, 16, 4, 64, 16, lens, dtype,
                                      seed=21)
    want = paged_attention.paged_attention(q, k, v, bt, q_pos)
    page_tokens = k.shape[1]
    kn, vn = k.clone(), v.clone()
    kn[0], vn[0] = torch.nan, torch.nan                  # the scratch page
    for r in range(4):
        last = int(q_pos[r].max())
        for slot in range(bt.shape[1]):
            page, first = int(bt[r, slot]), slot * page_tokens
            if page and first + page_tokens > last + 1:
                off = max(0, last + 1 - first)
                kn[page, off:], vn[page, off:] = torch.nan, torch.nan
    got = paged_attention.paged_attention(q, kn, vn, bt, q_pos)
    torch.cuda.synchronize()
    assert torch.isfinite(got[:3]).all()                 # row 3: scratch
    assert torch.equal(got[:3], want[:3])


def test_paged_engine_on_card_reuses_pages_of_an_oov_request(cuda):
    """A request with an out-of-vocab id (NaN K/V, greedy id 0), then a
    request that reuses its pages: the second decodes the tokens it
    decodes on a fresh pool, through B2."""
    oov = [5, 17, 300, 99, 3] + list(range(8, 41))
    nxt = [(i * 7 + 3) % 256 for i in range(11)]
    srv = LMServer(config=SMALL, device=cuda)

    def one_by_one(jobs):
        eng = ContinuousBatcher(srv, max_batch=1, segment_tokens=4,
                                kv_mode="paged", page_tokens=8,
                                prefill_chunk=16, pool_pages=9)
        out = []
        for p, n in jobs:
            out.append(eng.wait(eng.submit_async(p, n), timeout=120)[0])
        assert eng.drain(timeout=30)
        return out

    before = paged_attention.PAGED_ATTN.launches
    first, after = one_by_one([(oov, 6), (nxt, 12)])
    assert first[len(oov):] == [0] * 6
    assert after == one_by_one([(nxt, 12)])[0]
    assert paged_attention.PAGED_ATTN.launches > before


# ---------------------------------------------------------------------------
# the persistent kernel cache with the real nvcc
# ---------------------------------------------------------------------------

def test_persistent_cache_builds_then_reopens_every_library(cuda, tmp_path,
                                                            monkeypatch):
    """Every csrc/ source through a persistent cache: a cold process
    runs nvcc once a library and writes it back; a warm one (nothing
    loaded, a fresh store on the same directory) runs no nvcc and opens
    every library from the cache; the kernels then run from those
    libraries and agree with their plain versions."""
    import os

    from k8s_device_plugin_tpu_torch.models.compile_cache import CompileCache
    from k8s_device_plugin_tpu_torch.ops import _build

    names = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                   if f.endswith(".cu"))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_persistent", None)
    _build.set_persistent_cache(CompileCache(str(tmp_path)))
    before = _build.stats()
    for name in names:
        _build.load(name)
    after = _build.stats()
    assert after["builds"] - before["builds"] == len(names)
    assert len([p for p in tmp_path.iterdir()
                if p.name.endswith(".culib")]) == len(names)
    monkeypatch.setattr(_build, "_libs", {})
    _build.set_persistent_cache(CompileCache(str(tmp_path)))
    for name in names:
        _build.load(name)
    warm = _build.stats()
    assert warm["builds"] == after["builds"]
    assert warm["cache_loads"] - after["cache_loads"] == len(names)
    q, k, v = _qkv((2, 4, 256, 64), 4, torch.bfloat16, seed=3)
    got = attention.flash_attention(q, k, v, causal=True)
    want = attention.reference_attention(q, k, v, causal=True)
    assert (got.float() - want.float()).abs().max().item() <= 3e-2
    args = paged_inputs(2, 1, 8, 8, 64, 16, [300, 40], torch.float32)
    got = paged_attention.paged_attention(*args)
    want = paged_attention.paged_attention_reference(*args)
    assert (got - want).abs().max().item() <= 1e-5
