"""Paged attention — the read of the paged serving engine: the plain
PyTorch version and the hand-written CUDA kernel B2.

The counterpart of the reference's ``Attention._paged_attention_gather``
and ``_paged_attention_fused`` (k8s_device_plugin_tpu/models/
transformer.py:448-536). The layout at the public functions is the
reference's: q ``[b, L, heads, d]`` after RoPE, page pools
``[pool_pages, P, kv_heads, d]`` shared by every row, the block table
``bt [b, W]`` (row r's key position p lives at page ``bt[r, p // P]``,
offset ``p % P``) and ``q_pos [b, L]``, each query's absolute position;
a key is visible iff its position is <= the query's. The output is
``[b, L, heads, d]`` in q's dtype.

``paged_attention`` dispatches by device and nothing else: a CPU tensor
takes ``paged_attention_reference``, a CUDA tensor launches
``csrc/paged_attn.cu`` or raises. There is no fallback from the card to
the plain version.
"""

from __future__ import annotations

import torch

from k8s_device_plugin_tpu_torch.ops.attention import (
    _KERNEL_DTYPES,
    KernelStats,
    _kernel_fn,
    _pad,
    _run,
    kernel_head_dim,
)

_NEG_INF = -1e30

PAGED_ATTN = KernelStats(
    "paged_attn",
    source="k8s_device_plugin_tpu_torch/csrc/paged_attn.cu",
    replaces="k8s_device_plugin_tpu/models/transformer.py:476 "
             "(Attention._paged_attention_fused, an XLA lax.scan)",
)


def paged_attention_reference(q, k_pages, v_pages, bt, q_pos):
    """Plain paged attention; the numerical reference for B2.

    Mirrors the reference's ``_paged_attention_gather``: gather each
    row's logical cache view ``[b, W·P, kv, d]`` through the table, then
    the unexpanded-GQA scores (q head h = kv · n_rep + r) in the input
    dtype, cast to float32 and scaled, masked with -1e30 past each
    query's position, softmax in float32, probabilities cast back to the
    input dtype for the PV product."""
    b, L, heads, d = q.shape
    kv_heads, page_tokens = k_pages.shape[2], k_pages.shape[1]
    n_rep = heads // kv_heads
    span = bt.shape[1] * page_tokens
    idx = bt.long()
    kc = k_pages[idx].reshape(b, span, kv_heads, d)
    vc = v_pages[idx].reshape(b, span, kv_heads, d)
    qg = q.reshape(b, L, kv_heads, n_rep, d)
    scores = torch.einsum("blkrd,bmkd->bkrlm", qg, kc).float() * d ** -0.5
    k_pos = torch.arange(span, device=q.device)
    mask = k_pos[None, None, :] <= q_pos[:, :, None]       # [b, L, span]
    scores = scores.masked_fill(~mask[:, None, None], _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkrlm,bmkd->blkrd", probs, vc).reshape(
        b, L, heads, d)


def _int32(x, device):
    return torch.as_tensor(x, device=device).to(torch.int32).contiguous()


def paged_attention_cuda(q, k_pages, v_pages, bt, q_pos):
    """Launch kernel B2 on CUDA tensors; out ``[b, L, heads, d]``.

    ``bt`` and ``q_pos`` are read on the device (cast to contiguous
    int32 there, never copied to the host). A head dim that is not a
    multiple of 8 is zero-padded to one (scale of the true dim); the
    kernel takes any other d up to 256 as it is."""
    for what, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"paged_attn: {what} is on {t.device}, not "
                             f"q's CUDA device")
        if t.dtype != q.dtype:
            raise ValueError(f"paged_attn: {what} is {t.dtype}, q {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"paged_attn: {what} must be 4-d")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"paged_attn: dtype {q.dtype} not supported "
                         f"(float32, bfloat16)")
    b, L, heads, d = q.shape
    pool_pages, page_tokens, kv_heads, _ = k_pages.shape
    if k_pages.shape != v_pages.shape or k_pages.shape[3] != d:
        raise ValueError(f"paged_attn: pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if heads % kv_heads:
        raise ValueError(f"paged_attn: {heads} heads not divisible by "
                         f"{kv_heads} kv heads")
    if bt.dim() != 2 or bt.shape[0] != b or tuple(q_pos.shape) != (b, L):
        raise ValueError(f"paged_attn: bt {tuple(bt.shape)} / q_pos "
                         f"{tuple(q_pos.shape)} do not match q "
                         f"{tuple(q.shape)}")
    dim = d + (-d) % 8
    dmax = kernel_head_dim(dim)
    q_, k_, v_ = (_pad(x, dim) for x in (q, k_pages, v_pages))
    out = torch.empty_like(q_)
    if out.numel() == 0:
        return out[..., :d]
    bt_, pos_ = _int32(bt, q.device), _int32(q_pos, q.device)
    fn = _kernel_fn("paged_attn", "paged_attn", 6, 10)
    _run(fn, "paged_attn", q, q_.data_ptr(), k_.data_ptr(), v_.data_ptr(),
         bt_.data_ptr(), pos_.data_ptr(), out.data_ptr(), b, L, heads,
         kv_heads, dim, dmax, page_tokens, bt.shape[1], pool_pages,
         _KERNEL_DTYPES[q.dtype], d ** -0.5)
    PAGED_ATTN.launches += 1
    return out if dim == d else out[..., :d]


def paged_attention(q, k_pages, v_pages, bt, q_pos):
    """Paged attention by device: ``paged_attention_reference`` for CPU
    tensors, kernel B2 for CUDA ones."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, bt, q_pos)
    return paged_attention_cuda(q, k_pages, v_pages, bt, q_pos)
