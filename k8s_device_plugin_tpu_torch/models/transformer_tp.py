"""Tensor-parallel transformer block inside pipeline stages (Megatron-style
pp x tp x dp; the lm-train-pp-tp pod).

The counterpart of ``k8s_device_plugin_tpu/models/transformer_tp.py``: a
block written with explicit collectives, for the pipeline executors,
whose stages run per rank.

  - attention: heads column-split across tp (each rank runs the flash
    kernel on its head group: B1, and B3/B4 under autograd), output
    projection row-split with one ``comm.psum``;
  - MLP: wi column-split, down row-split, one ``comm.psum``;
  - RMSNorms and residuals replicated (activations enter and leave each
    block replicated across tp).

``comm.psum`` is JAX's psum: an all-reduce forward whose backward
all-reduces the cotangent too. That keeps the reference's
unreduced-cotangent calculus, which the pipelines' tp edge reduction
expects (parallel/pipeline_1f1b.py): one all-reduce per attention and
one per MLP in each direction.

The block keeps the reference's parameter layout (``wq/wk/wv [e, h,
d]``, ``wo [h, d, e]``, ``wi [e, mlp]``, ``down [mlp, e]``, the two
norm scales); a rank's slice takes its heads and MLP columns
(``tp_block_specs``), and its stage's rows of the stacked layers.
"""

from __future__ import annotations

import logging

import torch
import torch.nn.functional as F

from k8s_device_plugin_tpu_torch.models.transformer import (
    LMConfig,
    _trunc_normal_,
    default_optimizer,
)
from k8s_device_plugin_tpu_torch.models.transformer_pp import (
    _opt_states,
    _say,
    _train_step_fns,
    init_embed_head_params,
    pipeline_mesh,
    run_cli,
    run_pipeline,
    validate_cli_batch_flags,
)
from k8s_device_plugin_tpu_torch.ops.attention import flash_attention
from k8s_device_plugin_tpu_torch.parallel import comm
from k8s_device_plugin_tpu_torch.parallel.mesh import leave_process_group
from k8s_device_plugin_tpu_torch.parallel.pipeline import shard_stage_params
from k8s_device_plugin_tpu_torch.parallel.pipeline_interleaved import (
    interleave_stack,
)
from k8s_device_plugin_tpu_torch.parallel.sharding import local_slice
from k8s_device_plugin_tpu_torch.utils.device import resolve_device

log = logging.getLogger("lm-train-pp-tp")


def _rms(x, scale, dtype):
    # models/transformer.RMSNorm's numerics (cast ordering included)
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6)).to(dtype) * scale


def _attention(h, params, dtype):
    """Causal attention of this rank's heads: [b, s, h_local, d] out."""
    q, k, v = (torch.einsum("bse,ehd->bhsd", h.to(dtype),
                            params[w].to(dtype)).contiguous()
               for w in ("wq", "wk", "wv"))
    return flash_attention(q, k, v, causal=True).transpose(1, 2)


def tp_block_apply(params: dict, x, *, dtype, group=None):
    """One transformer block on one rank's tp shard.

    params (this rank's slice):
      ln1_scale [e], ln2_scale [e]                  (replicated)
      wq, wk, wv [e, h_local, d]                    (heads column-split)
      wo         [h_local, d, e]                    (row-split)
      wi         [e, mlp_local]                     (column-split)
      down       [mlp_local, e]                     (row-split)
    x: [batch, seq, e], the same on every rank of ``group`` (the tp
    group; None: one rank). Returns the same.
    """
    h = _rms(x, params["ln1_scale"], dtype)
    attn = _attention(h, params, dtype)
    # row-parallel output projection: partial sums reduced across tp;
    # psum's backward sums the cotangents, which stay per-rank partials
    # in between (the pipeline must not reduce them mid-chain)
    attn_out = torch.einsum("bshd,hde->bse", attn.to(dtype),
                            params["wo"].to(dtype))
    x = x + comm.psum(attn_out, group)
    h2 = _rms(x, params["ln2_scale"], dtype)
    up = F.gelu(h2.to(dtype) @ params["wi"].to(dtype), approximate="tanh")
    down = up @ params["down"].to(dtype)
    return x + comm.psum(down, group)


def init_tp_block_params(gen: torch.Generator, config: LMConfig,
                         device=None) -> dict:
    """Whole (unsharded) block params in the manual layout, lecun-normal
    kernels (fan-in: the contracted dims) from ``gen``; shard with
    ``tp_block_specs``."""
    e, h, m = config.embed_dim, config.num_heads, config.mlp_dim
    d = e // h
    shapes = {"wq": ((e, h, d), e), "wk": ((e, h, d), e),
              "wv": ((e, h, d), e), "wo": ((h, d, e), h * d),
              "wi": ((e, m), e), "down": ((m, e), m)}
    out = {"ln1_scale": torch.ones(e), "ln2_scale": torch.ones(e)}
    for name, (shape, fan_in) in shapes.items():
        t = torch.empty(shape)
        _trunc_normal_(t, fan_in ** -0.5, gen)
        out[name] = t
    return {k: v.to(resolve_device(device)) for k, v in out.items()}


def tp_block_specs(tp_axis: str = "tp", leading=()) -> dict:
    """Each leaf's spec (a mesh axis or None per dim) in the manual layout,
    optionally after leading stacked dims (``("pp", None)`` for
    pipeline-stacked layers)."""
    lead = tuple(leading)
    return {
        "ln1_scale": (*lead, None),
        "ln2_scale": (*lead, None),
        "wq": (*lead, None, tp_axis, None),
        "wk": (*lead, None, tp_axis, None),
        "wv": (*lead, None, tp_axis, None),
        "wo": (*lead, tp_axis, None, None),
        "wi": (*lead, None, tp_axis),
        "down": (*lead, tp_axis, None),
    }


def reference_block_apply(params: dict, x, *, dtype):
    """The same math on FULL (unsharded) params, no collectives — the
    single-device baseline the tp version must match."""
    h = _rms(x, params["ln1_scale"], dtype)
    attn = _attention(h, params, dtype)
    x = x + torch.einsum("bshd,hde->bse", attn.to(dtype),
                         params["wo"].to(dtype))
    h2 = _rms(x, params["ln2_scale"], dtype)
    return x + F.gelu(h2.to(dtype) @ params["wi"].to(dtype),
                      approximate="tanh") @ params["down"].to(dtype)


# the manual layout's leaves under the port's Block names
_BLOCK_NAMES = {"ln1_scale": "ln1.scale", "ln2_scale": "ln2.scale",
                "wq": "attn.wq.kernel", "wk": "attn.wk.kernel",
                "wv": "attn.wv.kernel", "wo": "attn.wo.kernel",
                "wi": "mlp.wi.kernel", "down": "mlp.down_proj.kernel"}


def as_block_params(blocks: dict) -> dict:
    """Manual-layout leaves (any leading dims) under the port's ``Block``
    names (q/k/v ``[.., e, h*d]``, o ``[.., h*d, e]``): the same block,
    for transformer_pp.reference_forward, the one-device baseline."""
    out = {}
    for k, v in blocks.items():
        if k in ("wq", "wk", "wv"):
            v = v.reshape(*v.shape[:-2], -1)
        elif k == "wo":
            v = v.reshape(*v.shape[:-3], -1, v.shape[-1])
        out[_BLOCK_NAMES[k]] = v
    return out


def check_config(config: LMConfig) -> None:
    """The refusals of the hand-written block."""
    if config.norm != "rms" or config.use_bias:
        # the block re-implements the default recipe (RMSNorm, bias-free
        # projections); the GPT-2 knobs exist on the DecoderLM path only
        raise ValueError(
            "pp x tp blocks implement norm='rms'/use_bias=False only"
        )
    if (config.position != "learned" or config.mlp_act != "gelu"
            or config.kv_heads != config.num_heads):
        # the same for the Llama-family knobs: building the wrong
        # architecture for a rope/GQA/swiglu config would be worse than
        # refusing (the sharded step and the pp executor run those)
        raise ValueError(
            "pp x tp blocks implement position='learned', "
            "mlp_act='gelu', full-head attention only; use the sharded "
            "train step or the pp executor for Llama-class configs"
        )


def init_pp_tp_params(seed: int, config: LMConfig, num_stages: int,
                      num_chunks: int = 1, device=None) -> dict:
    """The whole tree for ``make_pp_tp_train_step``: ``{"embed",
    "blocks": the manual layout stacked [S*V, layers per virtual stage,
    ...] rank-major, "head"}``, float32, seeded."""
    S, V = num_stages, num_chunks
    lps = config.num_layers // (S * V)
    gen = torch.Generator().manual_seed(seed)
    per_layer = [init_tp_block_params(gen, config, device)
                 for _ in range(config.num_layers)]
    vstages = [{k: torch.stack([p[k] for p in
                                per_layer[i * lps:(i + 1) * lps]])
                for k in per_layer[0]} for i in range(S * V)]
    embed, head = init_embed_head_params(seed + 1, config, device)
    return {"embed": embed, "blocks": interleave_stack(vstages, S, V),
            "head": head}


def make_pp_tp_train_step(mesh, config: LMConfig, num_microbatches: int,
                          optimizer=None, axis_name: str = "pp",
                          tp_axis: str = "tp", data_axis_name: str = "dp",
                          num_chunks: int = 1, fuse_update: bool = False):
    """Megatron-style pp x tp (x dp) LM training on this rank of ``mesh``.

    Blocks staged over ``axis_name`` by the 1F1B schedule (interleaved
    with ``num_chunks > 1``) AND tensor-split over ``tp_axis`` inside
    each stage; embedding and loss head the same on every rank. With
    ``data_axis_name`` on the mesh, each microbatch's batch dim splits
    over it: the full dp x pp x tp layout. Returns ``(train_step,
    init_fn, value_and_grad)`` like transformer_pp.make_pp_train_step;
    ``init_fn(seed=0, batch=None, params=None)`` takes a whole tree in
    ``init_pp_tp_params``' layout (models/params.py
    ``tp_params_from_jax``) and keeps the rank's rows, heads and MLP
    columns.

    ``fuse_update`` applies each chunk's optimizer inside the pipeline
    drain, after the chunk's tp edge reduction and dp mean, so the
    trained parameters match the unfused path's.
    """
    optimizer = optimizer or default_optimizer
    check_config(config)
    S = mesh.size(axis_name)
    tp = mesh.size(tp_axis)
    V = num_chunks
    data_axis = data_axis_name if data_axis_name in mesh.axis_names \
        else None
    if config.num_layers % (S * V):
        raise ValueError(
            f"num_layers {config.num_layers} not divisible into {S} stages"
            f" x {V} chunks"
        )
    if config.num_heads % tp or config.mlp_dim % tp:
        raise ValueError(
            f"heads ({config.num_heads}) and mlp_dim ({config.mlp_dim}) "
            f"must divide by tp ({tp})"
        )
    device = resolve_device(mesh.device)
    tp_group = mesh.group(tp_axis)
    # a rank's leaf is [layers per stage, ...]; the stacked row dim the
    # reference's spec names is gone, the tp split dims remain
    stacked_specs = {k: (axis_name, None, *spec)
                     for k, spec in tp_block_specs(tp_axis).items()}
    local_specs = {k: (None, *spec)
                   for k, spec in tp_block_specs(tp_axis).items()}

    def stage_fn(stage_params, x):
        lps = next(iter(stage_params.values())).shape[0]
        for i in range(lps):
            x = tp_block_apply({k: v[i] for k, v in stage_params.items()},
                               x, dtype=config.dtype, group=tp_group)
        return x

    def init_fn(seed: int = 0, batch=None, params=None):
        del batch
        whole = params if params is not None else init_pp_tp_params(
            seed, config, S, V, device)
        chunks = shard_stage_params(mesh, whole["blocks"], axis_name, V,
                                    device)
        chunks = chunks if V > 1 else [chunks]
        chunks = [{k: local_slice(v, local_specs[k], mesh).contiguous()
                   for k, v in c.items()} for c in chunks]
        rank_tree = {
            "embed": {k: torch.as_tensor(v, device=device).clone()
                      for k, v in whole["embed"].items()},
            "blocks": chunks,
            "head": {k: torch.as_tensor(v, device=device).clone()
                     for k, v in whole["head"].items()}}
        return rank_tree, _opt_states(rank_tree, optimizer, fuse_update)

    def pipeline_fn(params, tokens, update_fn=None, opt_states=None):
        loss, blocks, head, embed = run_pipeline(
            mesh, config, stage_fn, params, tokens.to(device),
            num_microbatches, V, axis_name, data_axis, update_fn,
            opt_states, shard_axis=tp_axis, stage_param_specs=stacked_specs)
        return (loss, head, embed) if update_fn is not None else \
            (loss, blocks, head, embed)

    def value_and_grad(params, tokens):
        loss, blocks, head, embed = pipeline_fn(params, tokens)
        return loss, {"embed": embed, "blocks": blocks, "head": head}

    return (_train_step_fns(value_and_grad, pipeline_fn, fuse_update),
            init_fn, value_and_grad)


def main(argv=None) -> int:
    """Runnable pp x tp (x dp) training example (the lm-train-pp-tp pod).

    Under ``torch.distributed.run`` each rank is a chip: the production
    3-D mesh over the ranks — tensor parallelism inside pipeline stages,
    optionally interleaved chunks and drain-fused updates — with rank 0
    printing a self-measured tokens/s + final-loss line, the same
    self-reporting pod mechanism as the AlexNet benchmark. Runs on the
    card unless ``--device cpu``.
    """
    import argparse

    p = argparse.ArgumentParser(prog="lm-train-pp-tp")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--microbatches", type=int, default=4)
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel replicas")
    p.add_argument("--tp", type=int, default=2,
                   help="tensor-parallel degree inside each stage")
    p.add_argument("--chunks", type=int, default=1,
                   help="virtual-stage chunks per rank (>1 = interleaved)")
    p.add_argument("--fuse-update", action="store_true",
                   help="apply optimizer updates inside the pipeline "
                        "drain")
    p.add_argument("--smoke", action="store_true",
                   help="tiny config for CPU/CI smoke runs")
    p.add_argument("--device", default=None,
                   help="torch device (default: this rank's card; 'cpu' "
                        "to ask for the CPU)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.smoke:
        config = LMConfig(
            vocab_size=256, num_layers=4, num_heads=4, embed_dim=64,
            mlp_dim=128, max_seq_len=64, dtype=torch.float32,
        )
    else:
        config = LMConfig(num_layers=8, embed_dim=1024, mlp_dim=4096,
                          num_heads=16)

    if min(args.dp, args.tp, args.steps, args.batch, args.microbatches,
           args.chunks) < 1:
        raise SystemExit("all size flags must be >= 1")
    validate_cli_batch_flags(args.batch, args.microbatches, args.dp)
    if config.num_heads % args.tp or config.mlp_dim % args.tp:
        raise SystemExit(
            f"--tp {args.tp} must divide heads ({config.num_heads}) and "
            f"mlp_dim ({config.mlp_dim})"
        )
    device = resolve_device(args.device)
    axes = ("dp", "pp", "tp") if args.dp > 1 else ("pp", "tp")
    mesh = pipeline_mesh(axes, {"dp": args.dp, "tp": args.tp},
                         config.num_layers, args.chunks, args.microbatches,
                         device)
    if mesh is None:
        log.info("idle rank: the pipeline's stages do not use it")
        leave_process_group()
        return 0
    if mesh.rank == 0:
        _say(f"lm-train-pp-tp: mesh {mesh.shape} config "
             f"layers={config.num_layers} embed={config.embed_dim} "
             f"chunks={args.chunks} fused={args.fuse_update}")
    try:
        return run_cli("lm-train-pp-tp", mesh, config,
                       lambda: make_pp_tp_train_step(
                           mesh, config, num_microbatches=args.microbatches,
                           num_chunks=args.chunks,
                           fuse_update=args.fuse_update),
                       args, device)
    finally:
        leave_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
