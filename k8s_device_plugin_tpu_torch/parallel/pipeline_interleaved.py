"""Interleaved (virtual-stage) 1F1B pipeline schedule (Megatron-style).

The counterpart of ``k8s_device_plugin_tpu/parallel/pipeline_interleaved.py``.
Each of the S pipeline ranks hosts V model *chunks*; virtual stage
``c*S + r`` is chunk ``c`` of rank ``r``, so a microbatch crosses the
rank ring V times, and the fill/drain bubble shrinks ~V-fold against
plain 1F1B over V-times-deeper stages.

The schedule half (``IDLE/FWD/BWD``, ``InterleavedSchedule``,
``_rank_op_order``, ``build_schedule``) is numpy only and is the
reference's, definition for definition (tests/test_torch_isolation.py
pins it): each rank's Megatron op order, assigned to synchronous ticks
by a greedy list scheduler that models the executor's exact
communication rule — single act/grad registers shifted around the ring
every tick, per-(rank, chunk) inboxes — and refuses to schedule an op
whose input has not arrived or whose send would clobber an unconsumed
message. The reference's module imports jax inside its executor, so the
port keeps this copy rather than importing it.

The executor half (``interleave_stack``,
``interleaved_pipeline_value_and_grad``) walks those tables on this
rank with parallel/pipeline_1f1b.py's ``run_schedule``: the same
register rule, the same recompute-from-stash backward, so it contains
no scheduling logic at all.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

IDLE, FWD, BWD = 0, 1, 2


@dataclass(frozen=True)
class InterleavedSchedule:
    num_stages: int
    num_chunks: int
    num_microbatches: int
    ticks: int
    # [ticks, S] int32 tables
    op: np.ndarray           # IDLE / FWD / BWD
    chunk: np.ndarray        # chunk index of the op (0 when idle)
    mb: np.ndarray           # microbatch index of the op (0 when idle)
    act_src_chunk: np.ndarray   # dest-chunk of the act arriving this tick (-1 none)
    grad_src_chunk: np.ndarray  # dest-chunk of the grad arriving this tick (-1 none)
    update_chunk: np.ndarray    # chunk whose LAST bwd ran this tick (-1 none)
    stash_slots: int         # per-chunk activation stash depth


def _rank_op_order(S: int, V: int, M: int, r: int) -> List[Tuple[int, int, int]]:
    """Megatron interleaved 1F1B op order for one rank.

    Returns [(op, chunk, microbatch), ...]. Virtual microbatch id vmb
    walks chunks in groups of S microbatches: chunk = (vmb % (S*V)) // S,
    microbatch = (vmb // (S*V)) * S + vmb % S. Backward walks chunks in
    reverse.
    """
    total = M * V

    def f_of(vmb):
        g = vmb % (S * V)
        return (FWD, g // S, (vmb // (S * V)) * S + vmb % S)

    def b_of(vmb):
        g = vmb % (S * V)
        return (BWD, V - 1 - g // S, (vmb // (S * V)) * S + vmb % S)

    warmup = min((S - r - 1) * 2 + (V - 1) * S, total)
    seq = [f_of(i) for i in range(warmup)]
    steady = total - warmup
    for i in range(steady):
        seq.append(f_of(warmup + i))
        seq.append(b_of(i))
    seq.extend(b_of(i) for i in range(steady, total))
    return seq


def build_schedule(S: int, V: int, M: int) -> InterleavedSchedule:
    """Greedy tick assignment under the executor's exact comms model."""
    if M % S:
        raise ValueError(
            f"interleaved 1F1B needs microbatches ({M}) divisible by the "
            f"stage count ({S})"
        )
    orders = [_rank_op_order(S, V, M, r) for r in range(S)]
    pos = [0] * S                      # next op index per rank
    # completion tick of each (kind, rank, chunk, mb) op
    done: Dict[Tuple[int, int, int, int], int] = {}
    # per-rank registers: what the act/grad register holds after tick t
    # (chunk, mb) or None — mirrors the executor's ppermuted registers.
    act_reg: List[Tuple[int, int] | None] = [None] * S
    grad_reg: List[Tuple[int, int] | None] = [None] * S
    # per-(rank, chunk) inbox: (mb, arrival_tick, consumed). The SPMD
    # registers re-deliver their content every tick, so a consumed entry
    # may be harmlessly re-stored; only overwriting an UNconsumed entry
    # with a different microbatch is a clobber.
    act_inbox: Dict[Tuple[int, int], List] = {}
    grad_inbox: Dict[Tuple[int, int], List] = {}

    rows_op, rows_chunk, rows_mb = [], [], []
    rows_act_src, rows_grad_src = [], []

    t = 0
    max_ticks = 8 * (M * V + S) + 64   # generous deadlock guard
    stash_live: Dict[Tuple[int, int], int] = {}
    stash_peak = 1

    def act_ready(r, c, m, t):
        """Input activation for F(r, c, m) available at tick t?"""
        if r == 0 and c == 0:
            return True
        entry = act_inbox.get((r, c))
        return (entry is not None and entry[0] == m and entry[1] <= t
                and not entry[2])

    def grad_ready(r, c, m, t):
        if r == S - 1 and c == V - 1:
            return True  # loss-seeded locally
        entry = grad_inbox.get((r, c))
        return (entry is not None and entry[0] == m and entry[1] <= t
                and not entry[2])

    while any(p < len(o) for p, o in zip(pos, orders)) and t < max_ticks:
        # Phase 1: deliveries — what each register held at the END of the
        # previous tick arrives now (the executor stores before compute).
        arrive_act = [None] * S
        arrive_grad = [None] * S
        for r in range(S):
            up = (r - 1) % S
            if act_reg[up] is not None:
                c_sent, m_sent = act_reg[up]
                # chunk at the DEST: same chunk mid-ring; +1 on wraparound
                dest_c = c_sent if up != S - 1 else c_sent + 1
                if dest_c < V:
                    arrive_act[r] = (dest_c, m_sent)
            downn = (r + 1) % S
            if grad_reg[downn] is not None:
                c_sent, m_sent = grad_reg[downn]
                dest_c = c_sent if downn != 0 else c_sent - 1
                if dest_c >= 0:
                    arrive_grad[r] = (dest_c, m_sent)
        for r in range(S):
            if arrive_act[r] is not None:
                dest_c, m_sent = arrive_act[r]
                prev = act_inbox.get((r, dest_c))
                if prev is not None and prev[0] != m_sent and not prev[2]:
                    raise AssertionError(
                        f"act inbox clobber at rank {r} chunk {dest_c}: "
                        f"{prev} vs mb {m_sent} (t={t})"
                    )
                if prev is None or prev[0] != m_sent:
                    act_inbox[(r, dest_c)] = [m_sent, t, False]
            if arrive_grad[r] is not None:
                dest_c, m_sent = arrive_grad[r]
                prev = grad_inbox.get((r, dest_c))
                if prev is not None and prev[0] != m_sent and not prev[2]:
                    raise AssertionError(
                        f"grad inbox clobber at rank {r} chunk {dest_c}: "
                        f"{prev} vs mb {m_sent} (t={t})"
                    )
                if prev is None or prev[0] != m_sent:
                    grad_inbox[(r, dest_c)] = [m_sent, t, False]

        # Phase 2: each rank runs its next op if (a) its input is ready
        # and (b) sending its output next tick will not clobber an
        # unconsumed message at the receiver (single-slot inboxes demand
        # sender back-pressure). Iterated to a fixpoint so a receiver
        # consuming THIS tick unblocks its sender this tick.
        def send_safe(kind, r, c, m):
            if kind == FWD:
                dest = (r + 1) % S
                dest_c = c if r != S - 1 else c + 1
                if dest_c >= V:
                    return True
                slot = act_inbox.get((dest, dest_c))
            else:
                dest = (r - 1) % S
                dest_c = c if r != 0 else c - 1
                if dest_c < 0:
                    return True
                slot = grad_inbox.get((dest, dest_c))
            return slot is None or slot[2] or slot[0] == m

        row_op = [IDLE] * S
        row_chunk = [0] * S
        row_mb = [0] * S
        progressed = True
        while progressed:
            progressed = False
            for r in range(S):
                if row_op[r] != IDLE or pos[r] >= len(orders[r]):
                    continue
                kind, c, m = orders[r][pos[r]]
                ready = (
                    act_ready(r, c, m, t) if kind == FWD
                    else grad_ready(r, c, m, t)
                )
                if kind == BWD and (FWD, r, c, m) not in done:
                    ready = False
                if not ready or not send_safe(kind, r, c, m):
                    continue
                row_op[r], row_chunk[r], row_mb[r] = kind, c, m
                done[(kind, r, c, m)] = t
                pos[r] += 1
                progressed = True
                if kind == FWD:
                    if not (r == 0 and c == 0):
                        act_inbox[(r, c)][2] = True  # consumed
                    act_reg[r] = (c, m)
                    stash_live[(r, c)] = stash_live.get((r, c), 0) + 1
                    stash_peak = max(stash_peak, stash_live[(r, c)])
                else:
                    if not (r == S - 1 and c == V - 1):
                        grad_inbox[(r, c)][2] = True  # consumed
                    grad_reg[r] = (c, m)
                    stash_live[(r, c)] = stash_live.get((r, c), 0) - 1

        rows_op.append(row_op)
        rows_chunk.append(row_chunk)
        rows_mb.append(row_mb)
        rows_act_src.append(
            [a[0] if a is not None else -1 for a in arrive_act]
        )
        rows_grad_src.append(
            [g[0] if g is not None else -1 for g in arrive_grad]
        )
        t += 1

    if any(p < len(o) for p, o in zip(pos, orders)):
        raise AssertionError(
            f"schedule deadlock: S={S} V={V} M={M}, stuck at {pos}"
        )

    # A chunk's gradient accumulator is complete the tick its LAST
    # backward runs; the fused-update executor applies the optimizer to
    # that chunk right there, overlapping update math with the remaining
    # drain ticks. At most one op per (tick, rank), so no conflicts.
    update = np.full((t, S), -1, np.int32)
    last_bwd: Dict[Tuple[int, int], int] = {}
    for (kind, r, c, m), tick in done.items():
        if kind == BWD:
            last_bwd[(r, c)] = max(last_bwd.get((r, c), -1), tick)
    for (r, c), tick in last_bwd.items():
        update[tick, r] = c

    return InterleavedSchedule(
        num_stages=S, num_chunks=V, num_microbatches=M, ticks=t,
        op=np.asarray(rows_op, np.int32),
        chunk=np.asarray(rows_chunk, np.int32),
        mb=np.asarray(rows_mb, np.int32),
        act_src_chunk=np.asarray(rows_act_src, np.int32),
        grad_src_chunk=np.asarray(rows_grad_src, np.int32),
        update_chunk=update,
        stash_slots=stash_peak,
    )


def interleave_stack(per_virtual_stage, S: int, V: int) -> dict:
    """Stack per-virtual-stage parameter dicts (length S*V, virtual-stage
    order) into the rank-major layout the executors take their rows
    from: row ``r*V + c`` holds virtual stage ``c*S + r``, so rank r's
    rows ``[r*V, (r+1)*V)`` are its V chunks in chunk order
    (``pipeline.shard_stage_params``). Leaves are tensors or numpy
    arrays; the result stacks each leaf."""
    import torch

    assert len(per_virtual_stage) == S * V
    ordered = [per_virtual_stage[c * S + r] for r in range(S)
               for c in range(V)]
    stack = (np.stack if isinstance(next(iter(ordered[0].values())),
                                    np.ndarray) else torch.stack)
    return {k: stack([t[k] for t in ordered]) for k in ordered[0]}


def interleaved_pipeline_value_and_grad(
    stage_fn,
    loss_fn,
    stage_params,
    x,
    mesh,
    num_microbatches: int,
    num_chunks: int,
    axis_name: str = "pp",
    head_params=None,
    return_dx: bool = False,
    loss_data=None,
    data_axis: str | None = None,
    shard_axis: str | None = None,
    stage_param_specs=None,
    update_fn=None,
    opt_state=None,
    opt_state_specs=None,
):
    """Loss + gradients via the interleaved schedule, on this rank.

    stage_params: this rank's V chunks, a list of parameter dicts in
    chunk order (``pipeline.shard_stage_params(..., num_chunks=V)``);
    stage_fn(chunk_params, microbatch) -> microbatch applies ONE chunk.
    Returns the chunks' gradients in the same layout.

    head_params / return_dx / loss_data / data_axis / shard_axis +
    stage_param_specs follow pipeline_1f1b.pipeline_value_and_grad:
    head grads come from the LAST VIRTUAL stage's backward ops (rank
    S-1, chunk V-1), dx from rank 0 chunk 0's.

    Fused weight update: with ``update_fn`` + ``opt_state`` (a list of V
    per-chunk states), a chunk's parameters update the tick its last
    backward completes (the schedule's update_chunk table), after its tp
    edge reduction and dp mean, so early chunks' updates overlap the
    remaining drain ticks. ``update_fn(chunk_grads, chunk_state,
    chunk_params) -> (new_params, new_state)`` must be per-chunk pure
    (per-leaf optimizers like adam/sgd qualify; global-norm clipping
    does not). The return becomes ``(loss, new_stage_params,
    new_opt_state[, head_grads][, dx])``.
    """
    from k8s_device_plugin_tpu_torch.parallel.pipeline_1f1b import (
        _value_and_grad,
    )

    if len(stage_params) != num_chunks:
        raise ValueError(f"{len(stage_params)} chunks on this rank, "
                         f"num_chunks {num_chunks}")
    return _value_and_grad(
        lambda S, M: build_schedule(S, num_chunks, M), stage_fn, loss_fn,
        stage_params, x, mesh, num_microbatches, axis_name, head_params,
        return_dx, data_axis, loss_data, shard_axis, stage_param_specs,
        update_fn, opt_state, opt_state_specs, chunked=True)
