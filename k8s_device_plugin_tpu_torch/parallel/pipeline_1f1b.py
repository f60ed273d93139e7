"""1F1B (PipeDream-flush) pipeline-parallel training over the pp axis.

The counterpart of ``k8s_device_plugin_tpu/parallel/pipeline_1f1b.py``
on the port's ``Mesh``: each rank is a process holding its own stage's
parameters, and every rank walks the same synchronous tick schedule.

Schedule (one op per rank per tick, S stages, M microbatches):

    F(rank, m) at tick  rank + 2m
    B(rank, m) at tick  2S - 1 - rank + 2m        (total 2(S + M - 1) ticks)

The two families have opposite tick parity at every rank, so they never
collide; once warm, every rank alternates one forward with one backward,
so at most ``min(S, M)`` microbatch inputs are ever stashed on a rank.

**The executor's rule** is the reference's: ONE activation register and
ONE gradient register move around the ring every tick, on every rank
(``comm.ring_shift`` over the pp group: activations down the ring,
gradients up), whether or not the rank computed anything; a rank with
nothing new re-sends what its register holds. The interleaved tables
(pipeline_interleaved.py) are valid only under exactly that rule, so
both executors share ``run_schedule``, which walks a table of ops per
(tick, rank) and files the arriving registers into per-chunk inboxes.
This schedule is that table with one chunk (``PlainSchedule``).

**The backward recomputes** each stage forward from its stashed input,
as the reference's ``jax.vjp`` does: an F tick runs the stage without
autograd and stashes its input, detached; the B tick reruns the stage
under ``torch.enable_grad()`` and takes ``torch.autograd.grad`` with
respect to the stage parameters and the input, seeded with the received
cotangent. The last rank folds the microbatch's loss into its backward,
seeding with d(loss/M) (``seeded_backward``). So a layer that launches a
kernel once a forward launches it 2M times a step on its rank (M
forwards, M recomputes) and its backward kernels M times, whatever the
schedule.

Beyond the stage parameters the pipeline differentiates the loss head
(``head_params``, computed on the last rank) and the pipeline input
(``return_dx``, produced by rank 0's backward ops), which is what makes
a whole LM trainable through it (models/transformer_pp.py).

**Tensor parallelism inside stages** (``shard_axis``) keeps the
reference's unreduced-cotangent calculus: the stage function sums its
row-parallel partial products with ``comm.psum`` (all-reduce forward,
all-reduce backward, as JAX transposes ``psum``), so the cotangents
that cross the ring stay per-rank partials; the loss seed is 1/tp on
every tp rank, and only the edges reduce (``tp_edge_reduce``: the
tp-replicated leaves' gradients are summed over tp; the loss and the
head's gradients, computed identically on every tp rank, are rescaled
by tp; the input cotangent is summed).

A stage's parameters are a dict of tensors (``shard_stage_params`` gives
a rank its rows of a stacked tree); its gradients come back in the same
layout, accumulated in float32.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from k8s_device_plugin_tpu_torch.parallel import comm
from k8s_device_plugin_tpu_torch.parallel.pipeline_interleaved import (
    BWD,
    FWD,
)


def schedule_ticks(num_stages: int, num_microbatches: int) -> int:
    """Total synchronous ticks of the 1F1B schedule (fill + steady + drain)."""
    return 2 * (num_stages + num_microbatches - 1)


def peak_stash(num_stages: int, num_microbatches: int) -> int:
    """Max live stashed activations on any rank (rank 0 holds the most).

    The 1F1B property: bounded by the stage count, NOT the microbatch
    count (GPipe-with-autodiff stashes all M).
    """
    return min(num_stages, num_microbatches)


class PlainSchedule:
    """The 1F1B schedule as the table ``run_schedule`` walks: the fields
    of pipeline_interleaved.InterleavedSchedule with one chunk. Both
    registers are filed into chunk 0's inbox every tick (the reference
    reads the last arrival directly), and a rank's one stage updates at
    its last backward (``m == M - 1``)."""

    def __init__(self, num_stages: int, num_microbatches: int):
        S, M = num_stages, num_microbatches
        self.num_stages, self.num_chunks, self.num_microbatches = S, 1, M
        self.ticks = schedule_ticks(S, M)
        self.stash_slots = peak_stash(S, M)
        t = np.arange(self.ticks)[:, None]
        r = np.arange(S)[None, :]
        t_f, t_b = t - r, t - (2 * S - 1 - r)
        is_f = (t_f >= 0) & (t_f % 2 == 0) & (t_f // 2 < M)
        is_b = (t_b >= 0) & (t_b % 2 == 0) & (t_b // 2 < M)
        self.op = (is_f * FWD + is_b * BWD).astype(np.int32)
        self.chunk = np.zeros((self.ticks, S), np.int32)
        self.mb = np.where(is_f, t_f // 2,
                           np.where(is_b, t_b // 2, 0)).astype(np.int32)
        self.act_src_chunk = np.zeros((self.ticks, S), np.int32)
        self.grad_src_chunk = np.zeros((self.ticks, S), np.int32)
        self.update_chunk = np.where(is_b & (t_b // 2 == M - 1), 0,
                                     -1).astype(np.int32)


def pipeline_value_and_grad(
    stage_fn: Callable,
    loss_fn: Callable,
    stage_params,
    x,
    mesh,
    num_microbatches: int,
    axis_name: str = "pp",
    head_params=None,
    return_dx: bool = False,
    data_axis: str | None = None,
    loss_data=None,
    shard_axis: str | None = None,
    stage_param_specs=None,
    update_fn=None,
    opt_state=None,
    opt_state_specs=None,
):
    """Loss + gradients via the 1F1B schedule, on this rank.

    stage_fn(params, microbatch) -> microbatch  (homogeneous shapes)
    loss_fn: ``loss_fn(final_stage_microbatch) -> scalar`` — or, when
        ``head_params`` is given,
        ``loss_fn(final_stage_microbatch, head_params, aux) -> scalar``
        where ``aux`` is this microbatch's slice of ``loss_data`` (when
        given) or the microbatch index. Under a data axis, loss_fn must
        reduce by MEAN over its microbatch so replica means average to
        the global mean.
    stage_params: this rank's stage, a dict of tensors
        (``shard_stage_params``).
    x: the global ``[batch, ...]`` input, the same on every rank.
    head_params: optional loss-side dict of tensors (the same on every
        rank); its gradients come from the last rank's backward ops.
    return_dx: also return d loss/d x (the global ``[batch, ...]``
        cotangent of the pipeline input, from rank 0's backward ops).
    data_axis: dp x pp: each replica runs the whole schedule on its
        slice of every microbatch; the loss and gradients are averaged
        over replicas (dx is each replica's slice scaled by
        1/replicas, gathered whole). Its size must divide the
        microbatch.
    loss_data: optional ``[batch, ...]`` tensor (e.g. LM targets)
        microbatched and sliced exactly like ``x``.
    shard_axis + stage_param_specs: tensor parallelism inside the
        stages (module docstring); ``stage_param_specs`` maps each leaf
        name to its spec, a tuple of mesh axes (or None) per dim.
    update_fn + opt_state: fused update: the rank applies
        ``update_fn(stage_grads, opt_state, stage_params) ->
        (new_params, new_state)`` the tick of its LAST backward, after
        the tp edge reduction and the dp mean; the return becomes
        ``(loss, new_stage_params, new_opt_state[, head_grads][, dx])``.

    Returns ``(loss, stage_grads[, head_grads][, dx])``; the loss is a
    float32 scalar tensor, the same on every rank.
    """
    return _value_and_grad(
        PlainSchedule, stage_fn, loss_fn,
        [stage_params], x, mesh, num_microbatches, axis_name, head_params,
        return_dx, data_axis, loss_data, shard_axis, stage_param_specs,
        update_fn, None if opt_state is None else [opt_state],
        opt_state_specs, chunked=False)


def _value_and_grad(schedule, stage_fn, loss_fn, chunks, x, mesh,
                    num_microbatches, axis_name, head_params, return_dx,
                    data_axis, loss_data, shard_axis, stage_param_specs,
                    update_fn, opt_state, opt_state_specs, chunked: bool):
    """Both executors' argument checks, then ``run_schedule``."""
    xs, loss_data, mb = microbatch_inputs(x, loss_data, num_microbatches)
    validate_data_axis(mb, mesh, data_axis)
    if (shard_axis is None) != (stage_param_specs is None):
        raise ValueError(
            "shard_axis and stage_param_specs must be given together"
        )
    if (update_fn is None) != (opt_state is None):
        raise ValueError("update_fn and opt_state must be given together")
    fused = update_fn is not None
    if opt_state_specs is not None and not fused:
        raise ValueError("opt_state_specs requires update_fn/opt_state")
    sch = schedule(mesh.size(axis_name), num_microbatches)
    loss, grads, opt_out, head_grads, dx = run_schedule(
        sch, stage_fn, loss_fn, chunks, xs, mesh, axis_name, head_params,
        return_dx, data_axis, loss_data, shard_axis, stage_param_specs,
        update_fn, opt_state)
    if not chunked:
        grads = grads[0]
        opt_out = None if opt_out is None else opt_out[0]
    return assemble_result(loss, grads, head_grads, dx,
                           head_params is not None, return_dx, x.shape,
                           opt_state=opt_out if fused else None)


def _zeros_like(tree: dict) -> dict:
    return {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
            for k, v in tree.items()}


def _add_into(acc: dict, grads) -> None:
    for a, g in zip(acc.values(), grads):
        if g is not None:
            a.add_(g.float())


def _vjp(stage_fn, params: dict, x_in, cotangent):
    """(d params, d x_in) of ``stage_fn(params, x_in)`` seeded with
    ``cotangent``: the stage rerun under autograd from its input."""
    with torch.enable_grad():
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        xi = x_in.detach().requires_grad_()
        out = stage_fn(p, xi)
        grads = torch.autograd.grad(out, [*p.values(), xi], cotangent,
                                    allow_unused=True)
    return grads[:-1], grads[-1]


def seeded_backward(stage_fn, loss_fn, M, has_head):
    """The last stage's loss-seeded backward, shared by both executors.

    Returns run(params_chunk, head_params, x_in, aux) ->
    (dparams, dhead_or_None, dx, scaled_loss), the gradients as tuples
    in the dicts' order (None where a leaf got none)."""
    def run(p_c, head_p, x_in, aux):
        with torch.enable_grad():
            p = {k: v.detach().requires_grad_() for k, v in p_c.items()}
            xi = x_in.detach().requires_grad_()
            if has_head:
                hp = {k: v.detach().requires_grad_()
                      for k, v in head_p.items()}
                lval = loss_fn(stage_fn(p, xi), hp, aux) / M
                leaves = [*p.values(), *hp.values(), xi]
            else:
                hp = {}
                lval = loss_fn(stage_fn(p, xi)) / M
                leaves = [*p.values(), xi]
            grads = torch.autograd.grad(lval, leaves, allow_unused=True)
        n = len(p)
        dh = grads[n:n + len(hp)] if has_head else None
        return grads[:n], dh, grads[-1], lval.detach().float()
    return run


def run_schedule(sch, stage_fn, loss_fn, chunks: list, xs, mesh,
                 axis_name, head_params, return_dx, data_axis, loss_data,
                 shard_axis, stage_param_specs, update_fn, opt_state):
    """Walk ``sch`` (a ``PlainSchedule`` or an ``InterleavedSchedule``)
    on this rank: each tick (1) files the registers that arrived into
    the per-chunk inboxes the table names, (2) runs the table's op, (3)
    shifts both registers one rank around the ring. ``chunks`` holds the
    rank's V chunks' parameter dicts in chunk order, ``opt_state`` their
    states (fused update) or None; ``xs`` is ``[M, mb, ...]``.

    Returns ``(loss, chunk results, opt states, head grads, dx)``: the
    chunk results are the gradients (the parameters after the update
    when fused), each a dict of float32 tensors."""
    S, V, M = sch.num_stages, sch.num_chunks, sch.num_microbatches
    if len(chunks) != V:
        raise ValueError(f"{len(chunks)} parameter chunks on this rank, "
                         f"the schedule runs {V}")
    fused = update_fn is not None
    has_head = head_params is not None
    tp_size = mesh.size(shard_axis) if shard_axis is not None else 1
    seeded = seeded_backward(stage_fn, loss_fn, M * tp_size, has_head)
    rank = mesh.coord(axis_name)
    ring = mesh.group(axis_name)
    tp_group = mesh.group(shard_axis) if shard_axis is not None else None
    dp_group = mesh.group(data_axis) if data_axis is not None else None
    if data_axis is not None:
        xs = _local_batch(xs, mesh, data_axis)
        if loss_data is not None:
            loss_data = _local_batch(loss_data, mesh, data_axis)
    chunks = list(chunks)
    opt_state = list(opt_state) if fused else None
    slots = sch.stash_slots
    zero = torch.zeros_like(xs[0])
    act_reg = grad_reg = act_reg_in = grad_reg_in = zero
    act_in, grad_in = [zero] * V, [zero] * V
    stash = [[None] * slots for _ in range(V)]
    grad_acc = [_zeros_like(c) for c in chunks]
    head_acc = _zeros_like(head_params) if has_head else {}
    dx_acc = torch.zeros_like(xs) if return_dx else None
    loss_acc = torch.zeros((), dtype=torch.float32, device=xs.device)

    def update(c):
        g = grad_acc[c]
        if shard_axis is not None:
            g = tp_edge_reduce(g, stage_param_specs, tp_group,
                               shard_axis)
        if data_axis is not None:
            g = _mean_tree(g, dp_group)
        chunks[c], opt_state[c] = update_fn(g, opt_state[c], chunks[c])

    for t in range(sch.ticks):
        ac, gc = int(sch.act_src_chunk[t, rank]), \
            int(sch.grad_src_chunk[t, rank])
        if ac >= 0:
            act_in[ac] = act_reg_in
        if gc >= 0:
            grad_in[gc] = grad_reg_in
        op = int(sch.op[t, rank])
        c, m = int(sch.chunk[t, rank]), int(sch.mb[t, rank])
        if op == FWD:
            x_in = xs[m] if rank == 0 and c == 0 else act_in[c]
            with torch.no_grad():
                act_reg = stage_fn(chunks[c], x_in)
            stash[c][m % slots] = x_in
        elif op == BWD:
            x_in = stash[c][m % slots]
            stash[c][m % slots] = None
            if rank == S - 1 and c == V - 1:
                aux = loss_data[m] if loss_data is not None else m
                dp, dh, dx, lval = seeded(chunks[c], head_params, x_in, aux)
                if has_head:
                    _add_into(head_acc, dh)
                loss_acc = loss_acc + lval
            else:
                dp, dx = _vjp(stage_fn, chunks[c], x_in, grad_in[c])
            _add_into(grad_acc[c], dp)
            grad_reg = dx.detach()
            if return_dx and c == 0:
                dx_acc[m] = grad_reg.to(dx_acc.dtype)
            if fused and int(sch.update_chunk[t, rank]) == c:
                update(c)
        # the tick boundary: activations go down the ring, gradients up
        with torch.no_grad():
            act_reg_in = comm.ring_shift(act_reg, ring, 1)
            grad_reg_in = comm.ring_shift(grad_reg, ring, -1)

    is_last, is_first = rank == S - 1, rank == 0
    loss = comm.all_reduce(loss_acc if is_last else torch.zeros_like(
        loss_acc), ring)
    head_grads = _sum_tree(head_acc if is_last else
                           {k: torch.zeros_like(v) for k, v in
                            head_acc.items()}, ring) if has_head else None
    dx = None
    if return_dx:
        dx = comm.all_reduce(dx_acc if is_first else
                             torch.zeros_like(dx_acc), ring)
    results = chunks if fused else grad_acc
    if shard_axis is not None:
        # loss and head gradients were computed identically on every tp
        # rank at 1/tp scale: rescale; the input cotangent's per-rank
        # partials sum. Fused updates reduced inside the drain.
        loss = loss * tp_size
        if has_head:
            head_grads = {k: g * tp_size for k, g in head_grads.items()}
        if return_dx:
            dx = comm.all_reduce(dx, tp_group)
        if not fused:
            results = [tp_edge_reduce(g, stage_param_specs, tp_group,
                                      shard_axis) for g in results]
    if data_axis is not None:
        loss, reduced, head_grads, dx = dp_reduce(
            loss, [] if fused else results, head_grads, dx, dp_group,
            return_dx)
        if not fused:
            results = reduced
        if return_dx:
            dx = _gather_batch(dx, mesh, data_axis)
    return loss, results, opt_state, head_grads, dx


def _local_batch(t, mesh, data_axis):
    """This replica's slice of dim 1 (the microbatch) of ``[M, mb, ...]``."""
    from k8s_device_plugin_tpu_torch.parallel.sharding import local_slice

    return local_slice(t, (None, data_axis), mesh)


def _gather_batch(t, mesh, data_axis):
    from k8s_device_plugin_tpu_torch.parallel.sharding import gather_tensor

    return gather_tensor(t, (None, data_axis), mesh)


def _sum_tree(tree: dict, group) -> dict:
    """Every leaf summed over ``group``, in one flattened all-reduce."""
    if comm.group_size(group) == 1 or not tree:
        return tree
    leaves = list(tree.values())
    flat = comm.all_reduce(torch.cat([g.reshape(-1) for g in leaves]),
                           group)
    return {k: part.view_as(g) for (k, g), part in zip(
        tree.items(), flat.split([g.numel() for g in leaves]))}


def _mean_tree(tree: dict, group) -> dict:
    n = comm.group_size(group)
    return {k: g / n for k, g in _sum_tree(tree, group).items()}


def spec_mentions(spec, axis: str) -> bool:
    """Does a spec (a tuple of mesh axes, None or tuples of axes per dim)
    name ``axis`` in any dimension entry?"""
    for part in spec:
        if part is None:
            continue
        if isinstance(part, (tuple, list)):
            if axis in part:
                return True
        elif part == axis:
            return True
    return False


def tp_edge_reduce(grads: dict, specs: dict, group,
                   shard_axis: str = "tp") -> dict:
    """The tp edge reduction both pipeline executors share.

    Under the unreduced-cotangent calculus, tp-SHARDED leaves (the spec
    mentions ``shard_axis``) already hold exact per-shard gradients; the
    tp-REPLICATED leaves hold per-rank partials that are summed over the
    tp ``group``."""
    replicated = {k: g for k, g in grads.items()
                  if not spec_mentions(specs[k], shard_axis)}
    summed = _sum_tree(replicated, group)
    return {k: summed.get(k, g) for k, g in grads.items()}


def opt_specs_like(opt_state: dict, stage_params: dict,
                   stage_param_specs: dict, axis_name: str = "pp") -> dict:
    """Specs for a per-leaf optimizer state tree (name -> tensor).

    Moment-like leaves (same shape as a parameter leaf) inherit that
    leaf's spec, which keeps each rank's moments congruent with its
    parameter shards; anything else (a step count) takes
    ``(axis_name,)``. Shapes are the join key, so if two parameter
    leaves share a shape but disagree on spec the caller must give the
    specs explicitly — we refuse rather than guess."""
    shape_to_spec: dict = {}
    for name, p in stage_params.items():
        s = tuple(stage_param_specs[name])
        prev = shape_to_spec.get(tuple(p.shape))
        if prev is not None and prev != s:
            raise ValueError(
                f"param leaves of shape {tuple(p.shape)} carry both "
                f"{prev} and {s}; derive opt_state_specs explicitly"
            )
        shape_to_spec[tuple(p.shape)] = s
    return {k: shape_to_spec.get(tuple(leaf.shape), (axis_name,))
            for k, leaf in opt_state.items()}


def validate_data_axis(mb, mesh, data_axis):
    """Shared dp-composition input guard for both pipeline executors."""
    if data_axis is not None and mb % mesh.size(data_axis):
        raise ValueError(
            f"microbatch size {mb} not divisible over data axis "
            f"{data_axis!r} ({mesh.size(data_axis)} replicas)"
        )


def dp_reduce(loss, grads: list, head_grads, dx, group, return_dx):
    """dp-composition epilogue shared by both pipeline executors.

    The global loss is the mean over replicas' per-slice losses, so
    replica gradients average too — and dx (each replica's
    d(replica_loss)/d(its slice)) scales by 1/replicas to become
    d(global_loss)/d(slice).
    """
    n = comm.group_size(group)
    loss = comm.all_reduce(loss.clone(), group) / n
    grads = [_mean_tree(g, group) for g in grads]
    if head_grads is not None:
        head_grads = _mean_tree(head_grads, group)
    if return_dx:
        dx = dx / n
    return loss, grads, head_grads, dx


def microbatch_inputs(x, loss_data, num_microbatches):
    """Validate and reshape pipeline inputs to [M, mb, ...] streams.

    Shared by the plain and interleaved executors so the input contract
    cannot drift."""
    batch = x.shape[0]
    if batch % num_microbatches:
        raise ValueError(
            f"batch {batch} not divisible into {num_microbatches} "
            f"microbatches"
        )
    mb = batch // num_microbatches
    xs = x.reshape((num_microbatches, mb) + tuple(x.shape[1:]))
    if loss_data is not None:
        if loss_data.shape[0] != batch:
            raise ValueError(
                f"loss_data batch {loss_data.shape[0]} != x batch {batch}"
            )
        loss_data = loss_data.reshape(
            (num_microbatches, mb) + tuple(loss_data.shape[1:])
        )
    return xs, loss_data, mb


def assemble_result(loss, grads, head_grads, dx, has_head, return_dx,
                    x_shape, opt_state=None):
    """The (loss, grads[, opt_state][, head_grads][, dx]) return contract.

    ``opt_state`` appears only for the fused-update executor, where the
    grads slot carries the updated stage params instead."""
    result = [loss, grads]
    if opt_state is not None:
        result.append(opt_state)
    if has_head:
        result.append(head_grads)
    if return_dx:
        result.append(dx.reshape(x_shape))
    return tuple(result)
