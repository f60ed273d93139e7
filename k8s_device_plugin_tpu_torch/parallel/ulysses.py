"""Ulysses: all-to-all sequence parallelism over the ``sp`` axis.

The counterpart of ``k8s_device_plugin_tpu/parallel/ulysses.py``: two
all-to-alls (``comm.all_to_all``) re-shard the activations around the
attention: the rank's ``[b, s/P, h, d]`` becomes ``[b, s, h/P, d]``,
full-sequence causal flash attention runs on that head group (kernel B1
forward, B3 and B4 backward, through ``FlashAttention``; the plain
versions on the CPU), and the inverse all-to-all turns the output back.
The head count must divide over the axis (times ``tp`` when heads are
split over it too). K/V with fewer heads than Q (GQA) travel unexpanded
when their heads divide over the axis, expanded to Q's heads when not.
"""

from __future__ import annotations

from k8s_device_plugin_tpu_torch.ops.attention import (
    flash_attention,
    flash_attention_with_lse,
)
from k8s_device_plugin_tpu_torch.parallel import comm
from k8s_device_plugin_tpu_torch.parallel.ring_attention import (
    _bhsd,
    local_block,
)


def _ulysses(q, k, v, group, causal: bool, with_lse: bool):
    n = comm.group_size(group)
    if q.shape[2] % n:
        raise ValueError(f"Ulysses needs heads ({q.shape[2]}) divisible by "
                         f"the sp degree ({n})")
    if k.shape[2] % n:
        rep = q.shape[2] // k.shape[2]
        k, v = (x.repeat_interleave(rep, dim=2) for x in (k, v))

    def seq_to_heads(x):
        # [b, s/P, h, d] -> [b, s, h/P, d]
        return comm.all_to_all(x, group, split_dim=2, concat_dim=1)

    qh, kh, vh = (_bhsd(seq_to_heads(x)) for x in (q, k, v))
    if with_lse:
        out, lse = flash_attention_with_lse(qh, kh, vh, causal=causal)
        # [b, h/P, s] -> [b, h, s/P]
        lse = comm.all_to_all(lse, group, split_dim=2, concat_dim=1)
    else:
        out, lse = flash_attention(qh, kh, vh, causal=causal), None
    out = comm.all_to_all(out.transpose(1, 2), group, split_dim=1,
                          concat_dim=2)
    return out, lse


def ulysses_attention(q, k, v, group=None, causal: bool = False):
    """Exact attention over a sequence split on ``group``: q, k, v are
    this rank's ``[batch, seq_shard, heads, head_dim]`` block (heads
    divisible by the group's size); returns its output block."""
    return _ulysses(q, k, v, group, causal, with_lse=False)[0]


def ulysses_attention_with_lse(q, k, v, group=None, causal: bool = False):
    """(out ``[b, s/P, h, d]``, lse ``[b, h, s/P]`` float32) of
    ``ulysses_attention``."""
    return _ulysses(q, k, v, group, causal, with_lse=True)


def ulysses_attention_sharded(q, k, v, mesh, axis_name: str = "sp",
                              causal: bool = False):
    """The reference's convenience wrapper on the port's mesh: q, k, v
    are the global ``[batch, seq, heads, head_dim]`` tensors; seq splits
    over ``axis_name``, batch over dp and heads over tp when those axes
    exist. The sp degree, times the tp degree when present, must divide
    the head count. Returns this rank's block of the output."""
    head_axis = "tp" if "tp" in mesh.axis_names else None
    head_ways = mesh.size(axis_name) * (mesh.size(head_axis)
                                        if head_axis else 1)
    if q.shape[2] % head_ways:
        raise ValueError(
            f"Ulysses needs heads ({q.shape[2]}) divisible by the "
            f"{axis_name} degree x tp degree ({head_ways})"
        )
    local = [local_block(x, mesh, axis_name) for x in (q, k, v)]
    return ulysses_attention(*local, group=mesh.group(axis_name),
                             causal=causal)
