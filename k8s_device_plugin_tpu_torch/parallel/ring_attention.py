"""Ring attention: exact attention over a sequence split on ``sp``.

The counterpart of ``k8s_device_plugin_tpu/parallel/ring_attention.py``.
Rank r of the ring holds Q, K and V of sequence block r (``[b, s/P, h,
d]``). K/V visit every rank over P steps through ``comm.ring_shift``,
and at each step the rank does one of three things (the reference's
``lax.switch``, :64-81): on a block before its own it runs the flash
forward non-causal, on its own block causal, and on a block after its
own (under a causal mask) nothing. The partial outputs merge by their
log-sum-exps in float32 (:86-89). The flash forward is kernel B1 with
its LSE on the card, its plain version on the CPU
(``ops.attention.attention_forward``).

The backward is one ``torch.autograd.Function``, not autograd through
the forward's loop (which would keep every visiting K/V block alive):
a second ring in which dK/dV accumulators travel with K and V, and each
visible block runs the flash backward (B3 and B4 on the card,
``attention_backward``) against the **final** merged O and LSE: then
``exp(s - lse)`` is the block's slice of the global softmax and
``attention_delta`` comes from the final O and dO, so the blocks'
gradients sum to the exact ones. After the last step each accumulator
takes one more hop home.

Launches on rank r of a causal ring: r + 1 of B1 forward, r + 1 each of
B3 and B4 backward (P(P+1)/2 of each over the ring, per layer); a
non-causal ring launches P of each on every rank. K/V may carry fewer
heads than Q (GQA); they travel unexpanded. Heads may be split over
``tp`` at the same time, as the reference's ``head_axis`` (:115-118)
does: a rank runs the ring on its own heads.
"""

from __future__ import annotations

import torch

from k8s_device_plugin_tpu_torch.ops.attention import (
    _NEG_INF,
    attention_backward,
    attention_forward,
)
from k8s_device_plugin_tpu_torch.parallel import comm


def _bhsd(x):
    return x.transpose(1, 2).contiguous()


def _visible(src: int, me: int, causal: bool) -> bool:
    return not (causal and src > me)


class RingAttention(torch.autograd.Function):
    """``apply(q, k, v, group, causal)`` -> (out ``[b, s/P, h, d]`` in q's
    dtype, lse ``[b, h, s/P]`` float32), both differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        n, me = comm.group_size(group), comm.group_rank(group)
        qh, kvh = _bhsd(q), torch.stack((_bhsd(k), _bhsd(v)))
        acc = torch.zeros(qh.shape, dtype=torch.float32, device=q.device)
        lse = torch.full(qh.shape[:3], _NEG_INF, dtype=torch.float32,
                         device=q.device)
        kv = kvh
        for i in range(n):
            src = (me - i) % n
            if _visible(src, me, causal):
                out, blk = attention_forward(qh, kv[0], kv[1],
                                             causal and src == me)
                new = torch.logaddexp(lse, blk)
                acc = (acc * torch.exp(lse - new)[..., None]
                       + out.float() * torch.exp(blk - new)[..., None])
                lse = new
            if i + 1 < n:
                kv = comm.ring_shift(kv, group)
        out = acc.to(q.dtype)
        ctx.save_for_backward(qh, kvh, out, lse)
        ctx.group, ctx.causal = group, causal
        ctx.set_materialize_grads(False)
        return out.transpose(1, 2), lse

    @staticmethod
    def backward(ctx, g, g_lse):
        qh, kvh, out, lse = ctx.saved_tensors
        group, causal = ctx.group, ctx.causal
        n, me = comm.group_size(group), comm.group_rank(group)
        gh = torch.zeros_like(out) if g is None else _bhsd(g.to(out.dtype))
        dq = torch.zeros(qh.shape, dtype=torch.float32, device=qh.device)
        dkv = torch.zeros(kvh.shape, dtype=torch.float32, device=qh.device)
        kv = kvh
        for i in range(n):
            src = (me - i) % n
            if _visible(src, me, causal):
                a, b, c = attention_backward(qh, kv[0], kv[1], out, lse, gh,
                                             g_lse, causal and src == me)
                dq += a.float()
                dkv[0] += b.float()
                dkv[1] += c.float()
            if i + 1 < n:
                kv = comm.ring_shift(kv, group)
            dkv = comm.ring_shift(dkv, group)
        dk, dv = dkv.to(kvh.dtype).transpose(2, 3)
        return dq.to(qh.dtype).transpose(1, 2), dk, dv, None, None


def ring_attention_with_lse(q, k, v, group=None, causal: bool = False):
    """(out ``[b, s/P, h, d]``, lse ``[b, h, s/P]``) of exact attention
    over the sequence split on ``group`` (this rank's block: ``q``, ``k``,
    ``v`` as ``[b, s/P, heads, d]``)."""
    return RingAttention.apply(q, k, v, group, causal)


def ring_attention(q, k, v, group=None, causal: bool = False):
    """Exact attention over a sequence split on ``group``: q, k, v are
    this rank's ``[batch, seq_shard, heads, head_dim]`` block; returns
    its ``[batch, seq_shard, heads, head_dim]`` output."""
    return RingAttention.apply(q, k, v, group, causal)[0]


def local_block(x, mesh, axis_name: str = "sp"):
    """This rank's block of a global ``[batch, seq, heads, ...]`` tensor:
    batch over ``dp``, seq over ``axis_name``, heads over ``tp`` (the
    reference's ``P(batch_axis, axis_name, head_axis, None)``)."""
    from k8s_device_plugin_tpu_torch.parallel.sharding import local_slice

    return local_slice(x, ("dp", axis_name, "tp"), mesh).contiguous()


def ring_attention_sharded(q, k, v, mesh, axis_name: str = "sp",
                           causal: bool = False):
    """The reference's convenience wrapper on the port's mesh: q, k, v
    are the global ``[batch, seq, heads, head_dim]`` tensors (the same on
    every rank); returns this rank's block of the output."""
    local = [local_block(x, mesh, axis_name) for x in (q, k, v)]
    return ring_attention(*local, group=mesh.group(axis_name),
                          causal=causal)
