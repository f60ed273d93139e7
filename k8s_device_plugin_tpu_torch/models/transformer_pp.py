"""Pipeline-parallel LM training: the DecoderLM through the 1F1B schedule
(the lm-train-pp pod).

The counterpart of ``k8s_device_plugin_tpu/models/transformer_pp.py``.
The model splits at its natural seams: the embedding (the same on every
rank, computed before the pipeline), a stack of identical transformer
``Block``s (the port's own module, applied to each layer's tensors with
``torch.func.functional_call``; a rank keeps only its stage's rows,
parallel/pipeline.py ``shard_stage_params``), driven by
parallel/pipeline_1f1b.py or, with ``num_chunks > 1``,
parallel/pipeline_interleaved.py, and the loss head (final norm +
unembedding, its gradients from the last rank's backward ops). The
embedding's gradient comes from the pipeline's input cotangent
(``return_dx``). Per-microbatch targets ride the pipeline's
``loss_data``, sliced like the input under dp.

A parameter tree is ``{"embed": {"embedding"[, "pos_embedding"]},
"blocks": ..., "head": {"ln_scale", "lm_head"[, "ln_bias"]}}``, float32
(the training layout; the blocks compute in ``config.dtype``). The
whole tree (``init_pp_params``) stacks the blocks ``[S*V, layers per
virtual stage, ...]`` rank-major under the port's Block names; a rank's
tree (``make_pp_train_step``'s ``init_fn``) holds its V chunks as a
list of such dicts without the leading dim. Every rank holds the whole
embedding and head, and after each step the same values: their
gradients are the pipeline's, replicated over pp and averaged over dp.

Each stage's attention is the flash kernel (B1 forward, B3/B4 backward
on the card): on a rank, 2·M·L/S launches of B1 and M·L/S each of B3
and B4 a step (L layers, S stages, M microbatches; the backward reruns
each stage's forward), interleaved or not.
"""

from __future__ import annotations

import functools
import hashlib
import logging
import time

import torch
import torch.nn.functional as F
from torch.func import functional_call

from k8s_device_plugin_tpu_torch.models.transformer import (
    Block,
    DecoderLM,
    LMConfig,
    default_optimizer,
    init_params,
    make_norm,
)
from k8s_device_plugin_tpu_torch.parallel.mesh import leave_process_group
from k8s_device_plugin_tpu_torch.parallel.pipeline import shard_stage_params
from k8s_device_plugin_tpu_torch.parallel.pipeline_1f1b import (
    pipeline_value_and_grad,
)
from k8s_device_plugin_tpu_torch.parallel.pipeline_interleaved import (
    interleave_stack,
    interleaved_pipeline_value_and_grad,
)
from k8s_device_plugin_tpu_torch.utils.device import resolve_device

log = logging.getLogger("lm-train-pp")


def init_pp_params(seed: int, config: LMConfig, num_stages: int,
                   num_chunks: int = 1, device=None) -> dict:
    """The whole parameter tree split for pipelining (module docstring),
    random weights from a generator seeded with ``seed`` (the port's
    ``init_params`` families); requires num_layers % (num_stages *
    num_chunks) == 0."""
    num_virtual = num_stages * num_chunks
    if config.num_layers % num_virtual:
        raise ValueError(
            f"num_layers {config.num_layers} not divisible into "
            f"{num_virtual} stages"
        )
    if config.num_experts:
        raise ValueError("pipelined training does not support MoE blocks "
                         "(their aux losses cannot cross stages)")
    embed, head = init_embed_head_params(seed, config, device)
    model = init_params(DecoderLM(config, param_dtype=torch.float32).to(
        resolve_device(device)), seed)
    lps = config.num_layers // num_virtual
    layers = [{k: v.detach() for k, v in layer.state_dict().items()}
              for layer in model.layers]
    # consecutive layers make a virtual stage; the stages lie rank-major
    per_vstage = [
        {k: torch.stack([layers[i][k] for i in
                         range(vs * lps, (vs + 1) * lps)])
         for k in layers[0]}
        for vs in range(num_virtual)
    ]
    blocks = interleave_stack(per_vstage, num_stages, num_chunks)
    return {"embed": embed, "blocks": blocks, "head": head}


def init_embed_head_params(seed: int, config: LMConfig, device=None):
    """Embedding + loss-head parameter dicts (no blocks), shared with the
    pp x tp trainer: normal tables and head scaled by embed_dim^-0.5,
    unit norm scale, from a generator seeded with ``seed``."""
    if config.tie_embeddings:
        # Tying head to embedding across a pipeline couples the first and
        # last ranks' parameters; not implemented — fail loudly rather
        # than train untied.
        raise ValueError(
            "tie_embeddings is not supported by the pipelined trainers; "
            "use the monolithic DecoderLM path"
        )
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    scale = config.embed_dim ** -0.5

    def normal(*shape):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    embed = {"embedding": normal(config.vocab_size, config.embed_dim)}
    if config.position == "learned":
        # rope configs carry no position table
        embed["pos_embedding"] = normal(config.max_seq_len,
                                        config.embed_dim)
    head = {"ln_scale": torch.ones(config.embed_dim, device=dev),
            "lm_head": normal(config.embed_dim, config.vocab_size)}
    if config.norm == "layernorm":
        head["ln_bias"] = torch.zeros(config.embed_dim, device=dev)
    return embed, head


def embed_apply(embed_params: dict, tokens, config: LMConfig):
    """The table rows of ``tokens`` (+ the learned positions) in float32,
    cast to ``config.dtype``."""
    x = embed_params["embedding"][tokens]
    if config.position == "learned":
        x = x + embed_params["pos_embedding"][: tokens.shape[1]][None]
    return x.to(config.dtype)


@functools.lru_cache(maxsize=None)
def _norm(config: LMConfig):
    with torch.device("meta"):
        return make_norm(config, trainable=True)


def head_loss(head_params: dict, h, targets, config: LMConfig, norm=None):
    """Final norm + unembed + next-token cross entropy on one microbatch:
    the DecoderLM's own norm module applied to ``head_params`` (so the
    numerics are the ln_f path's, the norm choice and its casts
    included), logits in float32, the mean over positions ``[:, :-1]``."""
    norm = norm or _norm(config)
    norm_params = {"scale": head_params["ln_scale"]}
    if config.norm == "layernorm":
        norm_params["bias"] = head_params["ln_bias"]
    normed = functional_call(norm, norm_params, (h,))
    logits = (normed.to(config.dtype)
              @ head_params["lm_head"].to(config.dtype)).float()
    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                           targets[:, :-1].reshape(-1))


def make_stage_fn(config: LMConfig):
    """stage_fn(chunk params, x): the chunk's layers in order, each the
    port's ``Block`` (training layout) on that layer's tensors."""
    with torch.device("meta"):
        block = Block(config, param_dtype=torch.float32)

    def stage_fn(stage_params: dict, x):
        lps = next(iter(stage_params.values())).shape[0]
        for i in range(lps):
            x = functional_call(
                block, {k: v[i] for k, v in stage_params.items()}, (x,))
        return x

    return stage_fn


def _flat(params: dict) -> list:
    """Every tensor of a rank's tree, in one fixed order."""
    return [*params["embed"].values(),
            *(t for c in params["blocks"] for t in c.values()),
            *params["head"].values()]


def _set_grads(leaves, grads) -> None:
    for p, g in zip(leaves, grads):
        p.grad = g.to(p.dtype)


def _train_step_fns(value_and_grad_fn, pipeline_fn, fuse_update):
    """The unfused and fused train steps both trainers share.

    Unfused: the optimizer over the rank's whole tree after the
    pipeline. Fused: each chunk's optimizer inside the drain, the tick
    its last backward runs (``update_fn``), then the embedding and head's
    with their gradients (complete only at the end)."""
    def chunk_update(g, opt, p):
        _set_grads(p.values(), g.values())
        opt.step()
        return p, opt

    def train_step(params, opt_state, tokens):
        loss, grads = value_and_grad_fn(params, tokens)
        _set_grads(_flat(params), _flat(grads))
        opt_state.step()
        return params, opt_state, loss

    def train_step_fused(params, opt_state, tokens):
        loss, head_grads, embed_grads = pipeline_fn(
            params, tokens, chunk_update, opt_state["blocks"])
        eh = [*params["embed"].values(), *params["head"].values()]
        _set_grads(eh, [*embed_grads.values(), *head_grads.values()])
        opt_state["embed_head"].step()
        return params, opt_state, loss

    return train_step_fused if fuse_update else train_step


def _opt_states(params, optimizer, fuse_update):
    if fuse_update:
        return {"blocks": [optimizer(list(c.values()))
                           for c in params["blocks"]],
                "embed_head": optimizer([*params["embed"].values(),
                                         *params["head"].values()])}
    return optimizer(_flat(params))


def _rank_tree(whole: dict, mesh, axis_name, num_chunks, device) -> dict:
    chunks = shard_stage_params(mesh, whole["blocks"], axis_name,
                                num_chunks, device)
    return {"embed": {k: torch.as_tensor(v, device=device).clone()
                      for k, v in whole["embed"].items()},
            "blocks": chunks if num_chunks > 1 else [chunks],
            "head": {k: torch.as_tensor(v, device=device).clone()
                     for k, v in whole["head"].items()}}


def _embed_grads(embed: dict, tokens, config, dx) -> dict:
    with torch.enable_grad():
        ep = {k: v.detach().requires_grad_() for k, v in embed.items()}
        x = embed_apply(ep, tokens, config)
        grads = torch.autograd.grad(x, list(ep.values()), dx.to(x.dtype))
    return dict(zip(ep, grads))


def run_pipeline(mesh, config, stage_fn, params, tokens, num_microbatches,
                 num_chunks, axis_name, data_axis, update_fn=None,
                 opt_states=None, **tp):
    """The embedding prologue, the schedule and the embedding's gradient,
    shared by both trainers and their fused and unfused steps, so their
    numerics cannot drift. Returns ``(loss, block results, head grads,
    embed grads)``; the block results are the chunks' gradients, or
    their parameters after the fused update."""
    targets = torch.roll(tokens, -1, dims=1)
    with torch.no_grad():
        x = embed_apply(params["embed"], tokens, config)

    def loss_fn(out, head_p, tgt):
        return head_loss(head_p, out, tgt, config)

    kw = dict(axis_name=axis_name, head_params=params["head"],
              return_dx=True, loss_data=targets, data_axis=data_axis, **tp)
    if update_fn is not None:
        kw.update(update_fn=update_fn,
                  opt_state=opt_states if num_chunks > 1 else opt_states[0])
    if num_chunks > 1:
        out = interleaved_pipeline_value_and_grad(
            stage_fn, loss_fn, params["blocks"], x, mesh,
            num_microbatches=num_microbatches, num_chunks=num_chunks, **kw)
    else:
        out = pipeline_value_and_grad(
            stage_fn, loss_fn, params["blocks"][0], x, mesh,
            num_microbatches=num_microbatches, **kw)
    out = list(out)
    loss, blocks = out[0], out[1]
    head_grads, dx = out[-2], out[-1]
    return (loss, blocks if num_chunks > 1 else [blocks], head_grads,
            _embed_grads(params["embed"], tokens, config, dx))


def make_pp_train_step(mesh, config: LMConfig, num_microbatches: int,
                       optimizer=None, axis_name: str = "pp",
                       data_axis_name: str = "dp", num_chunks: int = 1,
                       fuse_update: bool = False):
    """``(train_step, init_fn, value_and_grad)`` on this rank of ``mesh``.

    Blocks stage over ``axis_name``; embed/head are the same on every
    rank. When the mesh also carries ``data_axis_name``, every
    microbatch's batch dim splits over it (dp x pp) and gradients are
    averaged over replicas. ``num_chunks > 1`` runs the interleaved
    schedule.

    ``init_fn(seed=0, batch=None, params=None)`` -> ``(params,
    opt_state)``: this rank's tree (module docstring) from ``params``, a
    whole tree (``init_pp_params``' layout, e.g. models/params.py
    ``pp_params_from_jax``), or the seeded init; ``opt_state`` is
    ``optimizer(tensors)`` over the rank's tree (default
    ``default_optimizer``, optax adamw(3e-4)'s settings), or with
    ``fuse_update`` ``{"blocks": one per chunk, "embed_head": ...}``.
    ``value_and_grad(params, tokens)`` -> ``(loss, grads)`` in the rank
    tree's layout; ``train_step(params, opt_state, tokens)`` ->
    ``(params, opt_state, loss)``, updating in place. ``tokens`` is the
    global batch, the same on every rank.

    ``fuse_update`` applies each chunk's optimizer inside the pipeline,
    the tick its last backward completes; embed/head still update after
    the schedule. The optimizer must be per-leaf (AdamW, SGD); the
    trained parameters match the unfused path's.
    """
    optimizer = optimizer or default_optimizer
    num_stages = mesh.size(axis_name)
    data_axis = data_axis_name if data_axis_name in mesh.axis_names \
        else None
    stage_fn = make_stage_fn(config)
    device = resolve_device(mesh.device)

    def init_fn(seed: int = 0, batch=None, params=None):
        del batch  # shapes are static; kept for API symmetry
        whole = params if params is not None else init_pp_params(
            seed, config, num_stages, num_chunks, device)
        rank_tree = _rank_tree(whole, mesh, axis_name, num_chunks, device)
        return rank_tree, _opt_states(rank_tree, optimizer, fuse_update)

    def pipeline_fn(params, tokens, update_fn=None, opt_states=None):
        loss, blocks, head, embed = run_pipeline(
            mesh, config, stage_fn, params, tokens.to(device),
            num_microbatches, num_chunks, axis_name, data_axis, update_fn,
            opt_states)
        return (loss, head, embed) if update_fn is not None else \
            (loss, blocks, head, embed)

    def value_and_grad(params, tokens):
        loss, blocks, head, embed = pipeline_fn(params, tokens)
        return loss, {"embed": embed, "blocks": blocks, "head": head}

    return (_train_step_fns(value_and_grad, pipeline_fn, fuse_update),
            init_fn, value_and_grad)


def validate_cli_batch_flags(batch: int, microbatches: int, dp: int):
    """One-line SystemExit guards shared by the pipeline CLIs (this
    module's main and transformer_tp's): the same constraints
    microbatch_inputs/validate_data_axis enforce mid-run, surfaced as
    usage errors before any device work."""
    if batch % microbatches:
        raise SystemExit(
            f"--batch {batch} must divide into --microbatches "
            f"{microbatches}"
        )
    if (batch // microbatches) % dp:
        raise SystemExit(
            f"microbatch size {batch // microbatches} not divisible "
            f"over --dp {dp}"
        )


def reference_forward(params: dict, tokens, config: LMConfig,
                      num_stages: int, num_chunks: int = 1):
    """Unpipelined forward with the SAME whole tree (``init_pp_params``'
    layout), on one device: the numerical baseline for pipelined
    training. Undoes the rank-major layout: row ``r*V + c`` holds
    virtual stage ``c*S + r``. Returns the last block's output."""
    x = embed_apply(params["embed"], tokens, config)
    stage_fn = make_stage_fn(config)
    S, V = num_stages, num_chunks
    for vs in range(S * V):
        row = (vs % S) * V + (vs // S)
        x = stage_fn({k: v[row] for k, v in params["blocks"].items()}, x)
    return x


def reference_loss(params: dict, tokens, config: LMConfig, num_stages: int,
                   num_microbatches: int, num_chunks: int = 1):
    """The mean of the per-microbatch head losses over
    ``reference_forward``: exactly what the pipeline accumulates."""
    targets = torch.roll(tokens, -1, dims=1)
    h = reference_forward(params, tokens, config, num_stages, num_chunks)
    mb = tokens.shape[0] // num_microbatches
    losses = [head_loss(params["head"], h[i * mb:(i + 1) * mb],
                        targets[i * mb:(i + 1) * mb], config)
              for i in range(num_microbatches)]
    return sum(losses) / num_microbatches


def pipeline_mesh(axes: tuple, sizes: dict, layers: int, chunks: int,
                  microbatches: int, device):
    """The CLIs' mesh: ``pp`` is what the world leaves after the other
    axes, lowered until it divides the layers (per virtual stage when
    interleaving, which also needs microbatches % pp == 0); the ranks
    left over stay idle (``None`` on them). Joins the launcher's
    process group when there is one."""
    import os

    import torch.distributed as dist

    from k8s_device_plugin_tpu_torch.parallel.mesh import (
        build_submesh,
        init_process_group,
    )

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not dist.is_initialized():
        init_process_group(device)
    rest = 1
    for a in axes:
        if a != "pp":
            rest *= sizes[a]
    if world % rest:
        raise SystemExit(
            " x ".join(f"--{a} {sizes[a]}" for a in axes if a != "pp")
            + f" does not divide {world} ranks")
    pp = world // rest
    while pp > 1 and (layers % (pp * chunks)
                      or (chunks > 1 and microbatches % pp)):
        pp -= 1
    if layers % (pp * chunks):
        raise SystemExit(
            f"--chunks {chunks} cannot divide {layers} layers on any rank "
            f"count"
        )
    shape = tuple(pp if a == "pp" else sizes[a] for a in axes)
    return build_submesh(axes, shape, device=device)


def replicated_digest(params: dict) -> str:
    """sha256 of the rank's embedding and head bytes: the ranks of one
    job must print the same."""
    h = hashlib.sha256()
    for part in ("embed", "head"):
        for k in sorted(params[part]):
            h.update(params[part][k].detach().cpu().contiguous().numpy()
                     .tobytes())
    return h.hexdigest()


def _say(line: str) -> None:
    print(line + "\n", end="", flush=True)


def run_cli(prog: str, mesh, config, make_step, args, device) -> int:
    """Train ``args.steps`` timed steps (after one untimed) on fixed
    random tokens and print the reference's self-measured line on rank
    0: ``<prog>: N steps wall=...s tokens/s=... loss=...``; every rank
    prints its replicated parameters' digest, rank 0 the first step's
    loss too."""
    train_step, init_fn, _ = make_step()
    params, opt_state = init_fn(0, batch=args.batch)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, config.vocab_size,
                           (args.batch, config.max_seq_len),
                           generator=gen).to(device)
    params, opt_state, loss = train_step(params, opt_state, tokens)
    first = float(loss)  # the first step, untimed
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    start = time.perf_counter()
    for _ in range(args.steps):
        params, opt_state, loss = train_step(params, opt_state, tokens)
    final = float(loss)
    elapsed = time.perf_counter() - start
    toks = args.batch * config.max_seq_len * args.steps
    # one write a line: the ranks share the launcher's stdout
    if mesh.rank == 0:
        _say(f"{prog}: first step loss={first:.4f}")
        _say(f"{prog}: {args.steps} steps wall={elapsed:.2f}s "
             f"tokens/s={toks / elapsed:.0f} loss={final:.4f}")
    _say(f"{prog}: rank {mesh.rank} embed+head sha256="
         f"{replicated_digest(params)}")
    return 0


def main(argv=None) -> int:
    """Runnable pipelined-training example (the lm-train-pp pod).

    Under ``torch.distributed.run`` each rank is a chip: a pp (x dp) mesh
    over the ranks, the LM trained with the 1F1B schedule, rank 0
    printing a self-measured tokens/s + final-loss line — the same
    self-reporting pod mechanism as the AlexNet benchmark. Without a
    launcher the world is one rank. Runs on the card unless ``--device
    cpu``.
    """
    import argparse

    p = argparse.ArgumentParser(prog="lm-train-pp")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--microbatches", type=int, default=4)
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel replicas (rest of the chips go to pp)")
    p.add_argument("--chunks", type=int, default=1,
                   help="virtual-stage chunks per rank (>1 = interleaved "
                        "1F1B schedule)")
    p.add_argument("--fuse-update", action="store_true",
                   help="apply optimizer updates inside the pipeline "
                        "drain (plain and interleaved schedules)")
    p.add_argument("--smoke", action="store_true",
                   help="tiny config for CPU/CI smoke runs")
    p.add_argument("--device", default=None,
                   help="torch device (default: this rank's card; 'cpu' "
                        "to ask for the CPU)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.smoke:
        config = LMConfig(
            vocab_size=256, num_layers=4, num_heads=2, embed_dim=64,
            mlp_dim=128, max_seq_len=64, dtype=torch.float32,
        )
    else:
        config = LMConfig(num_layers=8, embed_dim=1024, mlp_dim=4096,
                          num_heads=8)

    if args.dp < 1 or args.steps < 1 or args.batch < 1 \
            or args.microbatches < 1 or args.chunks < 1:
        raise SystemExit(
            "--dp/--steps/--batch/--microbatches/--chunks must be >= 1"
        )
    validate_cli_batch_flags(args.batch, args.microbatches, args.dp)
    device = resolve_device(args.device)
    axes = ("dp", "pp") if args.dp > 1 else ("pp",)
    mesh = pipeline_mesh(axes, {"dp": args.dp}, config.num_layers,
                         args.chunks, args.microbatches, device)
    if mesh is None:
        log.info("idle rank: the pipeline's stages do not use it")
        leave_process_group()
        return 0
    if mesh.rank == 0:
        _say(f"lm-train-pp: mesh {mesh.shape} config "
             f"layers={config.num_layers} embed={config.embed_dim} "
             f"chunks={args.chunks} fused={args.fuse_update}")
    try:
        return run_cli("lm-train-pp", mesh, config, lambda: make_pp_train_step(
            mesh, config, num_microbatches=args.microbatches,
            num_chunks=args.chunks, fuse_update=args.fuse_update),
            args, device)
    finally:
        leave_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
