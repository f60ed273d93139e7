"""Pipeline parallelism (pp axis) over the port's mesh: the GPipe forward
and the placement of stacked stage parameters.

The counterpart of ``k8s_device_plugin_tpu/parallel/pipeline.py``. There
each pp device holds its stage's slice of a stacked parameter tree under
``shard_map`` and microbatches stream through the ring with
``lax.ppermute``; here each pp rank is a process that keeps only its
stage's rows (``shard_stage_params``), and the stream moves with
``comm.ring_shift``. ``pipeline_apply`` is the textbook forward schedule
(S + M - 1 ticks, bubbles included); training runs the 1F1B and
interleaved schedules (pipeline_1f1b.py, pipeline_interleaved.py).
"""

from __future__ import annotations

from typing import Callable

import torch

from k8s_device_plugin_tpu_torch.parallel import comm


def pipeline_apply(
    stage_fn: Callable,
    stage_params,
    x,
    mesh,
    num_microbatches: int,
    axis_name: str = "pp",
):
    """Run ``x`` through all pipeline stages (a forward, no autograd).

    stage_fn(params, microbatch) -> microbatch   (one stage's compute)
    stage_params: this rank's stage, a dict of tensors
                  (``shard_stage_params``).
    x: [batch, ...] global input, the same on every rank; batch must
       divide into num_microbatches.
    Returns the final-stage output with the same global shape as x, on
    every rank.

    A rank computes only at the ticks where it holds a microbatch
    (``0 <= t - rank < M``), where the reference computes every tick and
    discards the rest; the outputs are the same.
    """
    num_stages = mesh.size(axis_name)
    batch = x.shape[0]
    if batch % num_microbatches:
        raise ValueError(
            f"batch {batch} not divisible into {num_microbatches} "
            f"microbatches"
        )
    mb = batch // num_microbatches
    xs = x.reshape((num_microbatches, mb) + tuple(x.shape[1:]))
    rank = mesh.coord(axis_name)
    ring = mesh.group(axis_name)
    last = rank == num_stages - 1
    state = torch.zeros_like(xs[0])
    outputs = torch.zeros_like(xs)
    with torch.no_grad():
        for t in range(num_stages + num_microbatches - 1):
            m = t - rank
            out = state
            if 0 <= m < num_microbatches:
                out = stage_fn(stage_params, xs[m] if rank == 0 else state)
                if last:
                    outputs[m] = out
            # shift activations one stage down the ring
            state = comm.ring_shift(out, ring, 1)
        # the outputs live on the last rank: replicate them over pp
        outputs = comm.all_reduce(outputs if last
                                  else torch.zeros_like(outputs), ring)
    return outputs.reshape(x.shape)


def shard_stage_params(mesh, stage_params: dict, axis_name: str = "pp",
                       num_chunks: int = 1, device=None):
    """This rank's rows of a ``[num_stages * num_chunks, ...]``-stacked
    parameter dict (rank-major, pipeline_interleaved.interleave_stack's
    layout; leaves are tensors or numpy arrays): rank r keeps rows
    ``[r*V, (r+1)*V)`` as tensors of their own (on ``device``, or where
    the leaves are). Returns the stage's dict
    when ``num_chunks == 1``, else the list of its V chunks' dicts in
    chunk order."""
    rank, S = mesh.coord(axis_name), mesh.size(axis_name)
    rows = S * num_chunks
    chunks = []
    for c in range(num_chunks):
        row = rank * num_chunks + c
        chunk = {}
        for name, leaf in stage_params.items():
            if leaf.shape[0] != rows:
                raise ValueError(
                    f"{name}: {leaf.shape[0]} stacked rows, the mesh's "
                    f"{axis_name} axis x {num_chunks} chunks needs {rows}")
            part = torch.as_tensor(leaf[row], device=device)
            chunk[name] = part.clone().contiguous()
        chunks.append(chunk)
    return chunks[0] if num_chunks == 1 else chunks
