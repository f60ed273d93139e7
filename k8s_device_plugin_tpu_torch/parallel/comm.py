"""Collectives over a process group, each an autograd Function.

The counterpart of the reference's collectives: there they are ``lax``
primitives under ``shard_map`` (``ppermute``, ``all_to_all``, ``psum``;
parallel/compat.py holds its shard_map shim), differentiated by JAX.
Here each is one ``torch.autograd.Function`` over a ``torch.distributed``
group, with its backward:

- ``ring_shift``: send to the next rank of the group, receive from the
  previous one (``batch_isend_irecv``, so a ring cannot deadlock on
  blocking sends); its backward shifts the other way.
- ``all_to_all``: ``lax.all_to_all(tiled=True)``: split one dim into as
  many blocks as ranks, send block j to rank j, concatenate what arrives
  along another dim in rank order; its backward is the inverse.
- the Megatron pair: ``copy_to_group`` (f: identity forward, all-reduce
  backward) enters a split region from a replicated tensor, and
  ``reduce_from_group`` (g: all-reduce forward, identity backward)
  leaves it.
- ``all_reduce``: in place, no autograd (gradients, scalars, flags).

A group of one rank (or None) makes each of them the identity. bfloat16
and float16 tensors are reduced in float32 and rounded once.

**Staging.** gloo takes CUDA tensors for ``all_reduce`` and
``broadcast`` only, so with gloo the point-to-point and all-to-all
tensors of CUDA ranks are copied to host memory and back here, and
nowhere else; ``STAGED`` counts those bytes (device to host plus host
to device). NCCL takes them where they are; that route is the same
calls without the copies. ``REDUCED`` counts the bytes each rank
all-reduces (what gloo moves through host memory for CUDA tensors
inside its own all-reduce, and NCCL over the links).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class CommStats:
    """What the collectives staged through host memory under gloo:
    ``bytes`` copied device to host plus host to device, ``calls``."""

    def __init__(self):
        self.bytes = 0
        self.calls = 0


STAGED = CommStats()
REDUCED = CommStats()


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _staged(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    STAGED.bytes += t.numel() * t.element_size()
    STAGED.calls += 1
    return t.to("cpu", memory_format=torch.contiguous_format)


def _to_device(t: torch.Tensor, device) -> torch.Tensor:
    STAGED.bytes += t.numel() * t.element_size()
    return t.to(device)


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """x of the rank ``step`` places before this one in the group."""
    n = group_size(group)
    if n == 1:
        return x
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + step) % n)
    src = dist.get_global_rank(group, (me - step) % n)
    staged = _staged(group, x)
    send = _to_host(x) if staged else x.contiguous()
    recv = torch.empty_like(send)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, dst, group),
            dist.P2POp(dist.irecv, recv, src, group)]):
        req.wait()
    return _to_device(recv, x.device) if staged else recv


def _all_to_all(x: torch.Tensor, group, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    blocks = torch.stack(x.chunk(n, dim=split_dim))  # [n, ...], contiguous
    staged = _staged(group, x)
    send = _to_host(blocks) if staged else blocks
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if staged:
        recv = _to_device(recv, x.device)
    return torch.cat(recv.unbind(0), dim=concat_dim)


def _reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce of a copy of ``t`` (low-precision floats in float32)."""
    dtype = torch.float32 if t.dtype in (torch.bfloat16, torch.float16) \
        else t.dtype
    wide = t.to(dtype, memory_format=torch.contiguous_format, copy=True)
    _count_reduce(wide)
    dist.all_reduce(wide, op=op, group=group)
    return wide.to(t.dtype)


def _count_reduce(t: torch.Tensor) -> None:
    REDUCED.bytes += t.numel() * t.element_size()
    REDUCED.calls += 1


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, step):
        ctx.group, ctx.step = group, step
        return _shift(x, group, step)

    @staticmethod
    def backward(ctx, g):
        return _shift(g.contiguous(), ctx.group, -ctx.step), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, concat_dim, split_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def ring_shift(x: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """``x`` of the rank ``step`` places before this one in ``group``
    (this rank's goes ``step`` places on); differentiable."""
    if group_size(group) == 1:
        return x
    return _RingShift.apply(x, group, step)


def all_to_all(x: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """The tiled all-to-all: ``x.chunk(n, split_dim)[j]`` goes to rank j;
    the blocks from ranks 0..n-1 are concatenated along ``concat_dim``.
    Differentiable (the backward is the inverse all-to-all)."""
    if group_size(group) == 1:
        return x
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: identity forward, gradient all-reduced over
    ``group`` backward."""
    if group_size(group) == 1:
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: sum over ``group`` forward, identity backward."""
    if group_size(group) == 1:
        return x
    return _ReduceFromGroup.apply(x, group)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce (``op`` sum or max), no autograd; returns
    ``x``."""
    if group_size(group) > 1:
        reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        if x.dtype in (torch.bfloat16, torch.float16):
            x.copy_(_reduce(x, group, reduce_op))
        else:
            _count_reduce(x)
            dist.all_reduce(x, op=reduce_op, group=group)
    return x
