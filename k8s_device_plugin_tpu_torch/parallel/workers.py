"""What the ranks of ``launch.spawn`` run: the multi-rank checks of the
tests (on the CPU, against the JAX reference in the test process) and of
chip_smoke.py (on the card, against the one-device path in rank 0):
ring attention and Ulysses, the sharded training step, serving on the
``dp x tp`` mesh (``serve``, with rank 0 leading), the prefill/decode
roles over such meshes (``handoff``), the pipeline executors
(``pipeline``), the pipelined trainers (``pp_train``) and the tp block
(``tp_block``). A case on fewer ranks than the spawn runs on the first
ones (parallel/mesh.py ``build_submesh``) while the rest skip it.

They live in the port package because a spawned rank imports the module
of its target function (launch.py says why a test module must not be
that module). Each takes a list of cases and returns, on every rank,
``{case name: {"launches": this rank's B1/B3/B4 launches, ...}}``; rank
0 adds either the whole results as float32 numpy arrays (``compare`` off,
for the tests) or their errors against the one-device path
(``compare`` on, for the card, where the arrays are too big to send
back).

A case's inputs are numpy arrays in the case, or drawn on every rank
from ``torch.Generator().manual_seed(case["seed"])`` (the same global
tensors on every rank).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from k8s_device_plugin_tpu_torch.ops import attention as attn_ops
from k8s_device_plugin_tpu_torch.parallel import comm
from k8s_device_plugin_tpu_torch.parallel.mesh import build_mesh
from k8s_device_plugin_tpu_torch.parallel.ring_attention import (
    _bhsd,
    local_block,
    ring_attention_with_lse,
)
from k8s_device_plugin_tpu_torch.parallel.sharding import (
    gather_state_dict,
    gather_tensor,
    shard_state_dict,
)
from k8s_device_plugin_tpu_torch.parallel.ulysses import (
    ulysses_attention_with_lse,
)
from k8s_device_plugin_tpu_torch.utils.device import resolve_device

KERNELS = (attn_ops.FLASH_FWD, attn_ops.FLASH_BWD_DQ, attn_ops.FLASH_BWD_DKV)
# How [b, s, h, d] activations and [b, h, s] LSEs lie on the mesh.
BSHD = ("dp", "sp", "tp")
BHS = ("dp", "tp", "sp")


def _zero_launches() -> None:
    for c in KERNELS:
        c.launches = 0


def _launches() -> dict:
    return {c.name: c.launches for c in KERNELS}


def _rank_info(mesh, staged_before: int) -> dict:
    """Where this rank ran: backend, device, its coordinates, and the
    bytes parallel/comm.py staged through host memory for the case."""
    return {"backend": mesh.backend, "device": str(mesh.device),
            "coords": mesh.coords,
            "staged_bytes": comm.STAGED.bytes - staged_before}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _err(got: torch.Tensor, want: torch.Tensor) -> dict:
    """max |got - want| and that over max |want|, in float32."""
    diff = (got.float() - want.float()).abs().max().item()
    return {"max_abs_err": diff,
            "rel_err": diff / max(want.float().abs().max().item(), 1e-30)}


def _attention_inputs(case, dtype, device):
    if "q" in case:
        return [torch.from_numpy(np.asarray(case[n], np.float32)).to(
            device, dtype) for n in ("q", "k", "v", "g")]
    gen = torch.Generator().manual_seed(case["seed"])
    return [torch.randn(case["size"], generator=gen).to(device, dtype)
            for _ in range(4)]


def _one_device_attention(q, k, v, g, causal: bool) -> dict:
    """The whole-sequence FlashAttention (the kernels on the card) and
    the plain version in float32, outputs and gradients, [b, s, h, d] /
    [b, h, s]."""
    out = {}
    leaves = [_bhsd(x).requires_grad_() for x in (q, k, v)]
    o, lse = attn_ops.FlashAttention.apply(*leaves, causal)
    torch.autograd.backward(o, _bhsd(g))
    out["flash"] = {"out": o.transpose(1, 2), "lse": lse,
                    **{n: x.grad.transpose(1, 2)
                       for n, x in zip(("dq", "dk", "dv"), leaves)}}
    qf, kf, vf, gf = (_bhsd(x).float() for x in (q, k, v, g))
    po, plse = attn_ops.reference_attention_with_lse(qf, kf, vf, causal)
    grads = attn_ops.reference_attention_backward(qf, kf, vf, po, plse, gf,
                                                  causal=causal)
    out["plain"] = {"out": po.transpose(1, 2), "lse": plse,
                    **{n: x.transpose(1, 2)
                       for n, x in zip(("dq", "dk", "dv"), grads)}}
    return out


def attention(cases: list, device: str = "cpu", compare: bool = False):
    """Ring attention or Ulysses (``case["impl"]``) over the ``sp`` axis
    of ``build_mesh(case["axes"], case["shape"])`` on the global q, k, v
    ``[b, s, h, d]`` (heads over tp when the mesh has it), with the
    output cotangent g: out, lse, dq, dk, dv gathered whole."""
    dev = resolve_device(device)
    results = {}
    for case in cases:
        mesh = build_mesh(case["axes"], case["shape"], device=dev)
        q, k, v, g = _attention_inputs(case, getattr(torch, case["dtype"]),
                                       dev)
        fn = ring_attention_with_lse if case["impl"] == "ring" \
            else ulysses_attention_with_lse
        local = [local_block(x, mesh).requires_grad_() for x in (q, k, v)]
        staged = comm.STAGED.bytes
        _zero_launches()
        o, lse = fn(*local, mesh.group("sp"), case["causal"])
        torch.autograd.backward(o, local_block(g, mesh))
        res = {"launches": _launches(), "sp_rank": mesh.coord("sp"),
               **_rank_info(mesh, staged)}
        whole = {"out": gather_tensor(o.detach(), BSHD, mesh),
                 "lse": gather_tensor(lse.detach(), BHS, mesh),
                 **{n: gather_tensor(x.grad, BSHD, mesh)
                    for n, x in zip(("dq", "dk", "dv"), local)}}
        if mesh.rank == 0:
            if compare:
                ref = _one_device_attention(q, k, v, g, case["causal"])
                res["errors"] = {
                    against: {n: _err(whole[n], want[n]) for n in whole}
                    for against, want in ref.items()}
            else:
                res.update({n: _numpy(t) for n, t in whole.items()})
        results[case["name"]] = res
    return results


def _step_inputs(case, cfg, device):
    if "tokens" in case:
        return torch.as_tensor(np.asarray(case["tokens"]), dtype=torch.long,
                               device=device)
    gen = torch.Generator().manual_seed(case["seed"])
    return torch.randint(0, cfg.vocab_size, (case["batch"], cfg.max_seq_len),
                         generator=gen).to(device)


def train_step(cases: list, device: str = "cpu", compare: bool = False):
    """One ``make_sharded_train_step`` step per case on
    ``build_mesh(case["axes"], case["shape"])`` at ``LMConfig(**
    case["config"])``: weights from ``case["params"]`` (a whole state
    dict as numpy arrays) or the seeded init, the global batch from
    ``case["tokens"]`` or the seed; the loss, and the gradients and
    updated parameters gathered whole. ``compare`` holds them to
    ``make_train_step``'s one-device step from the same weights and
    batch in rank 0."""
    from k8s_device_plugin_tpu_torch.models import transformer

    dev = resolve_device(device)
    results = {}
    for case in cases:
        cfg = transformer.LMConfig(**case["config"])
        mesh = build_mesh(case["axes"], case["shape"], device=dev)
        step, init = transformer.make_sharded_train_step(
            mesh, cfg, sp_impl=case.get("sp_impl", "ring"))
        model, opt, _ = init(case.get("init_seed", 0))
        specs = model.plan.specs
        if "params" in case:
            whole = {n: torch.from_numpy(np.asarray(a, np.float32))
                     for n, a in case["params"].items()}
            model.load_state_dict(shard_state_dict(mesh, specs, whole))
            start = whole
        tokens = _step_inputs(case, cfg, dev)
        staged = comm.STAGED.bytes
        _zero_launches()
        loss = step(model, opt, tokens)
        res = {"launches": _launches(), "loss": float(loss),
               "sp_rank": mesh.coord("sp"), **_rank_info(mesh, staged)}
        grads = gather_state_dict(mesh, specs, {
            n: p.grad for n, p in model.named_parameters()})
        params = gather_state_dict(mesh, specs, model.state_dict())
        if compare:
            # a second step, timed (host clock between synchronisations)
            _sync(dev)
            t0 = time.perf_counter()
            step(model, opt, tokens)
            _sync(dev)
            res["step_s"] = time.perf_counter() - t0
        if mesh.rank == 0:
            if compare:
                res["one_device"] = _one_device_step(
                    cfg, dev, case, tokens, float(loss), grads,
                    start if "params" in case else None)
            else:
                res["grads"] = {n: _numpy(t) for n, t in grads.items()}
                res["params"] = {n: _numpy(t) for n, t in params.items()}
        results[case["name"]] = res
        del model, opt, grads, params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return results


def _one_device_step(cfg, dev, case, tokens, loss, grads, start) -> dict:
    """``make_train_step`` from the same weights on ``tokens``: its loss
    and each gradient's error relative to its largest magnitude."""
    from k8s_device_plugin_tpu_torch.models import transformer

    step, init = transformer.make_train_step(cfg, dev)
    model, opt = init(case.get("init_seed", 0))
    if start is not None:
        model.load_state_dict(start)
    want = float(step(model, opt, tokens))
    rel = {n: _err(grads[n], p.grad)["rel_err"]
           for n, p in model.named_parameters()}
    worst = max(rel, key=rel.get)
    _sync(dev)
    t0 = time.perf_counter()
    step(model, opt, tokens)
    _sync(dev)
    return {"loss": want, "loss_abs_err": abs(loss - want),
            "grad_max_rel_err": rel[worst], "grad_worst": worst,
            "step_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# tensor-parallel serving (parallel/serve_ranks.py)
# ---------------------------------------------------------------------------

def serve_counters() -> tuple:
    """The serving path's kernel counters: B1, B2 and B2's combine."""
    from k8s_device_plugin_tpu_torch.ops import paged_attention as paged_ops

    return (attn_ops.FLASH_FWD, paged_ops.PAGED_ATTN,
            paged_ops.PAGED_ATTN_COMBINE)


def drive(server, d: dict):
    """Run one serving drive on ``server`` (an ``LMServer`` or rank 0's
    ``serve_ranks.Leader``) and return its tokens:

    - ``complete``: ``prompt``, ``max_new_tokens``, and ``temperature``,
      ``top_k``, ``seed`` to sample (a generator seeded with ``seed``);
    - ``complete_batch``: ``prompts``, ``budgets``;
    - ``batcher``: a ``ContinuousBatcher`` (``kv_mode``, ``max_batch``,
      ``segment_tokens``, ``page_tokens``, ``prefill_chunk``; a
      self-draft with ``draft`` = (layers, k)), warmed up with
      ``warmup``, then ``jobs`` (prompt, budget) submitted one after
      another, each once the one before it has finished; or, with
      ``together``, all queued at once, the engine kept off the queue
      until the last is in, so that several rows decode together. Either
      way one request order, so one sequence of programs, on every run.

    Returns ``(tokens, launches)``: the kernels' launches over the
    requests (after any warmup)."""
    counters = serve_counters()
    kind = d["kind"]
    if kind == "complete":
        key = server.generator(d["seed"]) if "seed" in d else None
        before = _counts(counters)
        out, _ = server.complete(d["prompt"], d["max_new_tokens"],
                                 temperature=d.get("temperature", 0.0),
                                 top_k=d.get("top_k", 0), key=key)
        return out, _since(counters, before)
    if kind == "complete_batch":
        before = _counts(counters)
        out, _ = server.complete_batch(d["prompts"], d["budgets"])
        return out, _since(counters, before)
    from k8s_device_plugin_tpu_torch.models.serve_batch import (
        ContinuousBatcher,
    )

    if d.get("draft"):
        server.enable_draft(*d["draft"])
    b = ContinuousBatcher(
        server, max_batch=d.get("max_batch", 2),
        segment_tokens=d.get("segment_tokens", 4), kv_mode=d["kv_mode"],
        page_tokens=d.get("page_tokens", 0),
        prefill_chunk=d.get("prefill_chunk", 0))
    try:
        if d.get("warmup"):
            b.warmup()
        before = _counts(counters)
        if d.get("together"):
            with b.q.held():
                reqs = [b.submit_async(p, n) for p, n in d["jobs"]]
            out = [b.wait(r)[0] for r in reqs]
        else:
            out = [b.submit(p, n)[0] for p, n in d["jobs"]]
        launches = _since(counters, before)
    finally:
        b.drain()
        b.close()
    return out, launches


def rows_at_once(log, results) -> int:
    """The most rows that one call of a recorded batcher drive decoded
    together: the held rows of a paged decode segment, or the rows that
    one insert placed in the rows pool."""
    widths = [0]
    for msg, res in zip(log, results):
        if msg["name"] == "paged_decode_segment" and res:
            widths.append(len(res[0]))
        elif msg["name"] == "insert_rows":
            widths.append(len(msg["args"][2]))
    return max(widths)


def _zero(counters) -> None:
    for c in counters:
        c.launches = 0


def _counts(counters) -> dict:
    return {c.name: c.launches for c in counters}


def _since(counters, before: dict) -> dict:
    return {c.name: c.launches - before[c.name] for c in counters}


def serve(cases: list, device: str = "cpu", compare: bool = False):
    """Each case serves on the ``dp x tp`` mesh of every rank (or, with
    ``case["shape"]``, of the first ranks, ``build_submesh``: the others
    idle the case):
    ``LMServer(LMConfig(**case["config"]))`` with ``case["params"]`` (a
    whole state dict as numpy arrays) or the seed-0 weights; rank 0
    leads (``serve_ranks.Leader``, recording) and runs
    ``drive(leader, case["drive"])``, the others follow. Returns, on
    every rank, ``{case name: {"calls", "results" (each call's integer
    results), "launches" (over the whole case), "mesh", "coords",
    "staged_bytes", "reduced_bytes"}}``; rank 0 adds ``"tokens"``,
    ``"drive_launches"`` (over the requests), ``"agreed"`` (the stop
    found every rank in step), ``"rows_at_once"`` (``rows_at_once``),
    ``"seconds"`` and, without ``compare``,
    ``"log"`` (its messages, for ``serve_ranks.replay``). With
    ``compare`` rank 0 drives a one-device engine of the same weights
    too, and adds ``"one_device"``: its tokens, launches and seconds.

    ``case["fail"]``: the followers' ``complete_batch`` raises; rank 0
    reports the error it met (``"error"``) and its ``"seconds"``, the
    followers theirs (``"raised"``). It leaves the process group broken,
    so it goes last."""
    from k8s_device_plugin_tpu_torch.models import transformer
    from k8s_device_plugin_tpu_torch.models.serve_engine import LMServer
    from k8s_device_plugin_tpu_torch.parallel import serve_ranks
    from k8s_device_plugin_tpu_torch.parallel.mesh import build_submesh

    dev = resolve_device(device)
    results = {}
    for case in cases:
        cfg = transformer.LMConfig(**case["config"])
        params = None
        if "params" in case:
            params = {n: torch.from_numpy(np.asarray(a))
                      for n, a in case["params"].items()}
        mesh = None
        if "shape" in case:
            mesh = build_submesh(("dp", "tp"), case["shape"], device=dev)
            if mesh is None:    # a case on fewer ranks: this one idles
                serve_ranks.idle(int(np.prod(case["shape"])))
                results[case["name"]] = {"idle": True}
                continue
        server = LMServer(cfg, device=dev, params=params, mesh=mesh)
        ranks = serve_ranks.Ranks(server.mesh, case.get(
            "ack_timeout_s", serve_ranks.ACK_TIMEOUT_S))
        staged, reduced = comm.STAGED.bytes, comm.REDUCED.bytes
        res = {"mesh": server.mesh.shape, "coords": server.mesh.coords}
        t0 = time.perf_counter()
        _zero(serve_counters())
        if server.mesh.rank == 0:
            leader = serve_ranks.Leader(server, ranks, record=True)
            try:
                res["tokens"], res["drive_launches"] = drive(
                    leader, case["drive"])
            except Exception as e:
                if not case.get("fail"):
                    raise
                res["error"] = f"{type(e).__name__}: {e}"
            res["seconds"] = time.perf_counter() - t0
            res["agreed"] = leader.stop()
            res.update(calls=leader.calls, results=leader.results,
                       launches=_counts(serve_counters()),
                       rows_at_once=rows_at_once(leader.log,
                                                 leader.results))
            if compare and not case.get("fail"):
                del leader, server   # the card's memory for one device
                gc.collect()
                res["one_device"] = _one_device(case, params, dev)
            elif not case.get("fail"):
                res["log"] = leader.log
        else:
            if case.get("fail"):
                def refuse(*args, **kwargs):
                    raise RuntimeError("a follower's call raised")

                server.complete_batch = refuse
            try:
                res.update(serve_ranks.follow(server, ranks, record=True))
            except Exception as e:
                if not case.get("fail"):
                    raise
                res["raised"] = f"{type(e).__name__}: {e}"
            res["launches"] = _counts(serve_counters())
            res["seconds"] = time.perf_counter() - t0
        res["staged_bytes"] = comm.STAGED.bytes - staged
        res["reduced_bytes"] = comm.REDUCED.bytes - reduced
        results[case["name"]] = res
        server = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return results


def _one_device(case, params, dev) -> dict:
    """The case's drive on a one-device engine of the case's weights:
    its tokens, launches and seconds."""
    from k8s_device_plugin_tpu_torch.models import transformer
    from k8s_device_plugin_tpu_torch.models.serve_engine import LMServer

    one = LMServer(transformer.LMConfig(**case["config"]), device=dev,
                   params=params, mesh=build_mesh(("dp", "tp"), world=1,
                                                  device=dev))
    counters = serve_counters()
    _zero(counters)
    t0 = time.perf_counter()
    tokens, _ = drive(one, case["drive"])
    out = {"tokens": tokens, "launches": _counts(counters),
           "seconds": time.perf_counter() - t0}
    del one
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# pipelines (parallel/pipeline.py, pipeline_1f1b.py, pipeline_interleaved.py)
# ---------------------------------------------------------------------------

def gelu_stage(params: dict, x):
    """The generic stage the pipeline tests run: ``gelu(x @ w + b)``
    (jax.nn.gelu's tanh form)."""
    import torch.nn.functional as F

    return F.gelu(x @ params["w"] + params["b"], approximate="tanh")


def square_loss(out, head=None, aux=None):
    """The generic loss: ``mean(out ** 2)``; with a head,
    ``mean((out @ u - aux) ** 2)`` (aux: the microbatch's loss data)."""
    if head is None:
        return out.float().square().mean()
    return (out @ head["u"] - aux).float().square().mean()


def adam_update(lr: float = 1e-2, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8):
    """``optax.adam(lr)``'s per-leaf update as a pipeline ``update_fn``;
    its state is ``{"count", "mu", "nu"}`` (``adam_init``)."""
    def update(g, s, p):
        count = s["count"] + 1
        mu = {k: b1 * s["mu"][k] + (1 - b1) * g[k] for k in g}
        nu = {k: b2 * s["nu"][k] + (1 - b2) * g[k].square() for k in g}
        new = {k: p[k] - lr * (mu[k] / (1 - b1 ** count)) / (
            (nu[k] / (1 - b2 ** count)).sqrt() + eps) for k in p}
        return new, {"count": count, "mu": mu, "nu": nu}
    return update


def adam_init(params: dict) -> dict:
    return {"count": 0,
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


def pipeline(cases: list, device: str = "cpu"):
    """Each case runs one executor of the pipeline modules on
    ``build_mesh(case["axes"], case["shape"])`` with ``gelu_stage`` and
    ``square_loss``, from the stacked numpy ``case["params"]`` (``w``,
    ``b``; rank-major rows) and input ``case["x"]``:

    - ``apply``: ``pipeline_apply``; ``out`` on every rank;
    - ``1f1b`` / ``interleaved`` (``case["chunks"]``): the
      value_and_grad, with ``head`` (``u``) and ``loss_data`` when the
      case has them, ``return_dx``, ``data_axis`` and ``fused`` (Adam
      at 1e-2 inside the schedule); ``loss``, this rank's ``rows``
      (stacked row index -> its gradients, or its parameters after the
      fused update), ``head`` grads and ``dx``.
    - ``refuse``: the call raises; ``error`` holds its message.

    Returns ``{case name: {...}}`` on every rank, numpy arrays."""
    from k8s_device_plugin_tpu_torch.parallel import pipeline as pl
    from k8s_device_plugin_tpu_torch.parallel.pipeline_1f1b import (
        pipeline_value_and_grad,
    )
    from k8s_device_plugin_tpu_torch.parallel.pipeline_interleaved import (
        interleaved_pipeline_value_and_grad,
    )

    dev = resolve_device(device)
    results = {}
    for case in cases:
        mesh = build_mesh(case["axes"], case["shape"], device=dev)
        V = case.get("chunks", 1)
        stage = pl.shard_stage_params(mesh, case["params"], num_chunks=V,
                                      device=dev)
        x = torch.as_tensor(case["x"], device=dev)
        res = {}
        if case["kind"] == "apply":
            res["out"] = _numpy(pl.pipeline_apply(
                gelu_stage, stage, x, mesh, case["microbatches"]))
            results[case["name"]] = res
            continue
        kw = dict(return_dx=case.get("return_dx", False),
                  data_axis=case.get("data_axis"))
        if "u" in case:
            kw["head_params"] = {"u": torch.as_tensor(case["u"],
                                                      device=dev)}
            kw["loss_data"] = torch.as_tensor(case["targets"], device=dev)
        chunks = stage if V > 1 else [stage]
        if case.get("fused"):
            kw["update_fn"] = adam_update()
            states = [adam_init(c) for c in chunks]
            kw["opt_state"] = states if V > 1 else states[0]
        if case.get("opt_state_specs"):
            kw["opt_state_specs"] = {"w": ("pp",), "b": ("pp",)}
        loss_fn = (square_loss if "u" in case
                   else (lambda out: square_loss(out)))
        try:
            if V > 1:
                out = interleaved_pipeline_value_and_grad(
                    gelu_stage, loss_fn, stage, x, mesh,
                    case["microbatches"], V, **kw)
            else:
                out = pipeline_value_and_grad(
                    gelu_stage, loss_fn, stage, x, mesh,
                    case["microbatches"], **kw)
        except ValueError as e:
            res["error"] = str(e)
            results[case["name"]] = res
            continue
        out = list(out)
        res["loss"] = float(out.pop(0))
        got = out.pop(0)
        if case.get("fused"):
            out.pop(0)
        got = got if V > 1 else [got]
        rank = mesh.coord("pp")
        res["rows"] = {rank * V + c: {k: _numpy(t) for k, t in g.items()}
                       for c, g in enumerate(got)}
        if "u" in case:
            res["head"] = {k: _numpy(t) for k, t in out.pop(0).items()}
        if kw["return_dx"]:
            res["dx"] = _numpy(out.pop(0))
        results[case["name"]] = res
    return results


# ---------------------------------------------------------------------------
# pipelined LM training (models/transformer_pp.py, transformer_tp.py)
# ---------------------------------------------------------------------------

# the reference's tolerances for a pipelined step against autodiff
# (tests/test_transformer_pp.py): loss atol = rtol = 1e-5, every gradient
# atol = rtol = 2e-4
PP_LOSS_TOL = 1e-5
PP_GRAD_TOL = 2e-4


def _tensors(tree, device) -> dict:
    return {part: {k: torch.as_tensor(np.asarray(v, np.float32)
                                      if isinstance(v, np.ndarray) else v,
                                      device=device)
                   for k, v in tree[part].items()}
            for part in ("embed", "blocks", "head")}


def _allclose_ratio(got, want, tol: float) -> float:
    """max |got - want| / (tol + tol * |want|): at most 1 passes
    ``allclose(atol=tol, rtol=tol)``."""
    got, want = got.float(), want.float()
    return ((got - want).abs() / (tol + tol * want.abs())).max().item()


def _pp_trainer(case, cfg, mesh, **kw):
    from k8s_device_plugin_tpu_torch.models import transformer_pp
    from k8s_device_plugin_tpu_torch.models import transformer_tp

    if case["trainer"] == "tp":
        return transformer_tp.make_pp_tp_train_step(
            mesh, cfg, case["microbatches"],
            num_chunks=case.get("chunks", 1), **kw)
    return transformer_pp.make_pp_train_step(
        mesh, cfg, case["microbatches"], num_chunks=case.get("chunks", 1),
        **kw)


def _pp_whole(case, cfg, dev) -> dict:
    from k8s_device_plugin_tpu_torch.models import transformer_pp
    from k8s_device_plugin_tpu_torch.models import transformer_tp

    if "params" in case:
        return _tensors(case["params"], dev)
    S = case["shape"][case["axes"].index("pp")]
    init = (transformer_tp.init_pp_tp_params if case["trainer"] == "tp"
            else transformer_pp.init_pp_params)
    return init(case.get("init_seed", 0), cfg, S, case.get("chunks", 1), dev)


def _flat_tree(params: dict) -> list:
    return [*params["embed"].values(),
            *(t for c in params["blocks"] for t in c.values()),
            *params["head"].values()]


def _rank_rows(mesh, V, blocks: list) -> dict:
    rank = mesh.coord("pp")
    return {rank * V + c: {k: _numpy(t) for k, t in g.items()}
            for c, g in enumerate(blocks)}


def pp_train(cases: list, device: str = "cpu", compare: bool = False):
    """Each case runs a pipelined trainer (``case["trainer"]``: ``pp``,
    models/transformer_pp.py; ``tp``, transformer_tp.py) on
    ``build_submesh(case["axes"], case["shape"])`` (the first ranks of
    the spawn; the others skip the case) at ``LMConfig(**
    case["config"])`` with ``case["microbatches"]`` and ``chunks``, from
    the whole tree ``case["params"]`` (numpy, the trainer's layout) or
    the seeded init, on the global batch ``case["tokens"]`` or the
    seed's. Every rank returns ``{"loss", "launches"`` (its B1/B3/B4
    launches over the value_and_grad), ``"coords"``, ``"seconds"``}; and
    without ``compare`` its ``"rows"`` (stacked row -> gradients) and
    the ``"embed"`` / ``"head"`` gradients. With ``case["fused"]`` it
    also takes one unfused and one fused ``train_step`` from the same
    weights and returns the parameters after each (``"unfused"``,
    ``"fused"``: rows, embed, head).

    With ``compare`` (the card) every rank holds its results to one
    device's autograd of the trainer's whole model (transformer_pp
    ``reference_loss``; the tp block as the port's ``Block``) and
    returns ``"errors"``: the loss's absolute error, and each part's
    largest allclose ratio at PP_GRAD_TOL (at most 1 passes); fused
    cases add the largest |fused - unfused| over the parameters."""
    from k8s_device_plugin_tpu_torch.models import transformer
    from k8s_device_plugin_tpu_torch.models import transformer_pp
    from k8s_device_plugin_tpu_torch.models import transformer_tp

    from k8s_device_plugin_tpu_torch.parallel.mesh import build_submesh

    dev = resolve_device(device)
    results = {}
    for case in cases:
        cfg = transformer.LMConfig(**case["config"])
        mesh = build_submesh(case["axes"], case["shape"], device=dev)
        if mesh is None:    # a case on fewer ranks: this one idles
            continue
        V = case.get("chunks", 1)
        whole = _pp_whole(case, cfg, dev)
        tokens = _step_inputs(case, cfg, dev)
        _, init, vg = _pp_trainer(case, cfg, mesh)
        params, _ = init(params=whole)
        _sync(dev)
        _zero_launches()
        t0 = time.perf_counter()
        loss, grads = vg(params, tokens)
        _sync(dev)
        res = {"loss": float(loss), "launches": _launches(),
               "coords": mesh.coords,
               "seconds": time.perf_counter() - t0}
        if case.get("fused"):
            after = {}
            for fuse in (False, True):
                step, init2, _ = _pp_trainer(case, cfg, mesh,
                                             fuse_update=fuse)
                p2, opt = init2(params=whole)
                p2, opt, _ = step(p2, opt, tokens)
                after["fused" if fuse else "unfused"] = p2
            if compare:
                res["fused_minus_unfused"] = max(
                    (a - b).abs().max().item()
                    for a, b in zip(_flat_tree(after["fused"]),
                                    _flat_tree(after["unfused"])))
            else:
                for k, p2 in after.items():
                    res[k] = {"rows": _rank_rows(mesh, V, p2["blocks"]),
                              **{part: {n: _numpy(t) for n, t in
                                        p2[part].items()}
                                 for part in ("embed", "head")}}
        if compare:
            res["errors"] = _pp_errors(case, cfg, mesh, whole, tokens,
                                       loss, grads, transformer_pp,
                                       transformer_tp)
        else:
            res["rows"] = _rank_rows(mesh, V, grads["blocks"])
            res["embed"] = {k: _numpy(t) for k, t in grads["embed"].items()}
            res["head"] = {k: _numpy(t) for k, t in grads["head"].items()}
        results[case["name"]] = res
        del params, grads, whole
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return results


def _pp_errors(case, cfg, mesh, whole, tokens, loss, grads, tpp, ttp):
    """This rank's results against one device's autograd of the whole
    model (``pp_train``'s ``compare``)."""
    from k8s_device_plugin_tpu_torch.parallel.sharding import local_slice

    S, V = mesh.size("pp"), case.get("chunks", 1)
    tp_case = case["trainer"] == "tp"
    blocks = whole["blocks"]
    leaves = {"embed": {k: v.detach().clone().requires_grad_()
                        for k, v in whole["embed"].items()},
              "blocks": {k: v.detach().clone().requires_grad_()
                         for k, v in blocks.items()},
              "head": {k: v.detach().clone().requires_grad_()
                       for k, v in whole["head"].items()}}
    tree = dict(leaves, blocks=ttp.as_block_params(leaves["blocks"])
                if tp_case else leaves["blocks"])
    want = tpp.reference_loss(tree, tokens, cfg, S, case["microbatches"], V)
    flat = [t for part in leaves.values() for t in part.values()]
    gw = dict(zip([(p, k) for p, part in leaves.items() for k in part],
                  torch.autograd.grad(want, flat)))
    out = {"loss": float(want), "loss_abs_err": abs(float(loss)
                                                    - float(want)),
           "loss_ratio": abs(float(loss) - float(want))
           / (PP_LOSS_TOL + PP_LOSS_TOL * abs(float(want)))}
    for part in ("embed", "head"):
        out[part] = max(_allclose_ratio(g, gw[(part, k)], PP_GRAD_TOL)
                        for k, g in grads[part].items())
    specs = {k: (None, *s) for k, s in ttp.tp_block_specs().items()} \
        if tp_case else {}
    rank = mesh.coord("pp")
    worst = 0.0
    for c, g in enumerate(grads["blocks"]):
        for k, t in g.items():
            w = gw[("blocks", k)][rank * V + c]
            if tp_case:
                w = local_slice(w, specs[k], mesh)
            worst = max(worst, _allclose_ratio(t, w, PP_GRAD_TOL))
    out["blocks"] = worst
    return out


# ---------------------------------------------------------------------------
# the prefill/decode roles over serving meshes (models/serve_engine.py
# export_pages / import_pages on dp x tp ranks)
# ---------------------------------------------------------------------------

def _handoff_pair(prefill_srv, decode_srv, d: dict):
    """A prefill-role and a decode-role paged ContinuousBatcher over the
    in-process transport (recording every bundle's bytes), warmed up
    unless ``d["warmup"]`` is false, then ``d["jobs"]`` (prompt,
    budget) through the decode side one after another, greedy with
    logprobs. Returns ``(tokens, logprobs,
    bundles, hops, leases left)``."""
    from k8s_device_plugin_tpu_torch.models import handoff as kv_handoff
    from k8s_device_plugin_tpu_torch.models.serve_batch import (
        ContinuousBatcher,
    )

    class Recording(kv_handoff.InProcTransport):
        def __init__(self, ingest):
            super().__init__(ingest)
            self.bundles = []

        def prefill(self, payload, timeout_s):
            out = super().prefill(payload, timeout_s)
            self.bundles.append(out)
            return out

    kw = dict(max_batch=d.get("max_batch", 2),
              segment_tokens=d.get("segment_tokens", 4), kv_mode="paged",
              page_tokens=d.get("page_tokens", 8),
              prefill_chunk=d.get("prefill_chunk", 16))
    prefill = ContinuousBatcher(prefill_srv, role="prefill", **kw)
    transport = Recording(prefill)
    client = kv_handoff.HandoffClient(transport, peer="inproc")
    decode = ContinuousBatcher(decode_srv, role="decode",
                               handoff_client=client, **kw)
    try:
        if d.get("warmup", True):
            prefill.warmup()
            decode.warmup()
        tokens, lps = [], []
        for prompt, budget in d["jobs"]:
            req = decode.submit_async(list(prompt), budget, logprobs=True)
            decode.wait(req, timeout=600)
            tokens.append(list(req.slot["tokens"]))
            lps.append(list(req.slot.get("logprobs") or []))
        deadline = time.monotonic() + 10
        while prefill.leases.pending() and time.monotonic() < deadline:
            time.sleep(0.02)
        leased = prefill.leases.pending()
    finally:
        for b in (decode, prefill):
            b.drain()
            b.close()
    return tokens, lps, transport.bundles, len(client.latencies_s), leased


def _charge(servers: dict) -> dict:
    """``{replica: B2's launches made inside its dispatches}`` (each
    server's ``_dispatch`` wrapped), filled as they run. A rank's
    replicas take turns: one job at a time, whose prefill ends before
    its decode starts, and the warmups run one after the other."""
    from k8s_device_plugin_tpu_torch.ops import paged_attention

    counter = paged_attention.PAGED_ATTN
    counts = {name: 0 for name in servers}
    for name, srv in servers.items():
        def dispatch(fn, cache, key, build, *args, _inner=srv._dispatch,
                     _name=name):
            before = counter.launches
            out = _inner(fn, cache, key, build, *args)
            counts[_name] += counter.launches - before
            return out

        srv._dispatch = dispatch
    return counts


# a tp pair's bundle pages against a one-device pair's (allclose, float32):
# past the first layer K/V read all-reduced sums, whose order differs
# from one device's (up to ~2e-6 apart at the test sizes); the same pages
# cross export and import bit for bit (``_round_trip``)
BUNDLE_TOL = 1e-5


def _page_bytes(wire: bytes) -> int:
    """The bytes of a bundle's K/V pages (its header aside)."""
    return sum(t.numel() * t.element_size() for t in _bundle_pages(
        wire, keep_dtype=True))


def _bundle_pages(wire: bytes, keep_dtype: bool = False) -> list:
    """A bundle's K/V page arrays (float32 copies), layer by layer."""
    from k8s_device_plugin_tpu_torch.models import handoff as kv_handoff

    payload = kv_handoff.PageBlockBundle.from_bytes(wire).to_pool_payload()
    pages = [kv_handoff.to_tensor(payload[f"layer{i}"]["attn"][leaf])
             for i in range(len(payload)) for leaf in ("k_pages", "v_pages")]
    return pages if keep_dtype else [t.float() for t in pages]


def _round_trip(engine, cfg, pages: int = 6, page_tokens: int = 8) -> bool:
    """A seeded whole page block through ``import_pages`` into a fresh
    pool at ids 1..pages-1 and back out through ``export_pages``: bit
    for bit the block (float32 or bf16 words) on any mesh."""
    gen = np.random.default_rng(5)
    shape = (pages - 1, page_tokens, cfg.kv_heads, cfg.head_dim)
    block = {f"layer{i}": {"attn": {
        leaf: _host_block(gen.standard_normal(shape, np.float32), cfg)
        for leaf in ("k_pages", "v_pages")}} for i in range(cfg.num_layers)}
    ids = list(range(1, pages))
    pool = engine.import_pages(engine.make_paged_pool(pages, page_tokens),
                               ids, block)
    back = engine.export_pages(pool, ids)
    return all(np.array_equal(back[k]["attn"][leaf], v["attn"][leaf])
               for k, v in block.items() for leaf in ("k_pages", "v_pages"))


def _host_block(a: np.ndarray, cfg) -> np.ndarray:
    from k8s_device_plugin_tpu_torch.models.handoff import host_array

    return host_array(torch.from_numpy(a).to(cfg.dtype))


def handoff(cases: list, device: str = "cpu", compare: bool = False):
    """Each case pairs a prefill replica on the ``dp x tp`` mesh
    ``case["prefill"]`` with a decode replica on ``case["decode"]``,
    each over the first ranks of the spawn (``build_submesh``; ``(1,
    1)`` is rank 0 alone; a rank in neither idles the case), each an
    ``LMServer`` of ``LMConfig(**case["config"])`` with
    ``case["params"]`` (whole, numpy) or the seed-0 weights. Rank 0
    leads each replica it is in (``serve_ranks.Leader``) and drives the
    pair (``_handoff_pair``) with ``case["drive"]``; every other rank
    follows the replicas it is in (a thread each). Then rank 0 drives a
    one-device single paged engine and a one-device pair of the same
    weights with the same jobs.

    Returns on every rank ``{case: {"launches"`` (B2 on this rank over
    the jobs), ``"calls"``, ``"agreed"``...}}``; rank 0 adds
    ``"tokens"``, ``"hops"``, ``"leases_left"``, ``"bundle_bytes"``,
    ``"launches_by_replica"``, ``"meshes"``, ``"seconds"`` and
    ``"one_device"`` (the single engine's ``"tokens"``, the pair's
    ``"pair_tokens"``, ``"bundle_bytes"``, ``"launches_by_replica"``),
    and ``"bundle_max_err"``: the largest |tp page - one-device page|
    over every bundle. Without ``compare`` also the logprobs of both."""
    import threading as _threading

    import torch.distributed as dist

    from k8s_device_plugin_tpu_torch.models import transformer
    from k8s_device_plugin_tpu_torch.models.serve_engine import LMServer
    from k8s_device_plugin_tpu_torch.ops import paged_attention
    from k8s_device_plugin_tpu_torch.parallel import serve_ranks
    from k8s_device_plugin_tpu_torch.parallel.mesh import build_submesh

    dev = resolve_device(device)
    counter = paged_attention.PAGED_ATTN
    results = {}
    for case in cases:
        cfg = transformer.LMConfig(**case["config"])
        params = None
        if "params" in case:
            params = {n: torch.from_numpy(np.asarray(a))
                      for n, a in case["params"].items()}
        meshes = {role: build_submesh(("dp", "tp"), case[role], device=dev)
                  for role in ("prefill", "decode")}
        servers = {role: LMServer(cfg, device=dev, params=params, mesh=m)
                   for role, m in meshes.items() if m is not None}
        ranks = {}
        for role, m in meshes.items():
            world = int(np.prod(case[role]))
            if world > 1 and m is None:
                serve_ranks.idle(world)
            elif world > 1:
                ranks[role] = serve_ranks.Ranks(m)
        if not servers:
            results[case["name"]] = {"idle": True, "launches": 0}
            continue
        res = {"coords": {r: m.coords for r, m in meshes.items() if m},
               "kv_layout": {r: transformer.cache_kv_layout(cfg, srv.plan)
                             for r, srv in servers.items()}}
        t0 = time.perf_counter()
        n0 = counter.launches
        if dist.get_rank() == 0:
            leaders = {role: serve_ranks.Leader(servers[role], ranks[role])
                       for role in ranks}
            engines = {role: leaders.get(role, servers[role])
                       for role in servers}
            by_replica = _charge(servers)
            tokens, lps, bundles, hops, leased = _handoff_pair(
                engines["prefill"], engines["decode"], case["drive"])
            res["launches"] = counter.launches - n0
            res["round_trip"] = {role: _round_trip(eng, cfg)
                                 for role, eng in engines.items()}
            res["seconds"] = time.perf_counter() - t0
            res["agreed"] = all(ld.stop() for ld in leaders.values())
            res["calls"] = {r: ld.calls for r, ld in leaders.items()}
            res.update(tokens=tokens, hops=hops, leases_left=leased,
                       bundle_bytes=[len(b) for b in bundles],
                       page_bytes=[_page_bytes(b) for b in bundles],
                       launches_by_replica=by_replica,
                       meshes={r: (m.shape if m else None)
                               for r, m in meshes.items()})
            del leaders, engines, servers
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            one = _one_device_pair(cfg, params, dev, case["drive"])
            pairs = [(a, b) for got, want in zip(bundles, one.pop("bundles"))
                     for a, b in zip(_bundle_pages(got), _bundle_pages(want))]
            res["bundle_max_err"] = max((a - b).abs().max().item()
                                        for a, b in pairs)
            res["bundle_ratio"] = max(_allclose_ratio(a, b, BUNDLE_TOL)
                                      for a, b in pairs)
            res["one_device"] = one
            if not compare:
                res["logprobs"] = lps
            else:
                one.pop("logprobs")
        else:
            followed = {}

            def follow(role):
                followed[role] = serve_ranks.follow(servers[role],
                                                    ranks[role])

            threads = [_threading.Thread(target=follow, args=(r,))
                       for r in ranks]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            res["launches"] = counter.launches - n0
            res["calls"] = {r: f["calls"] for r, f in followed.items()}
            res["agreed"] = len(followed) == len(ranks)
            res["seconds"] = time.perf_counter() - t0
        results[case["name"]] = res
        servers = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return results


def _one_device_pair(cfg, params, dev, d: dict) -> dict:
    """The drive on one device: a single paged engine's tokens, then a
    pair's tokens, logprobs, bundles and B2 launches by replica (each
    replica its own engine)."""
    from k8s_device_plugin_tpu_torch.models.serve_engine import LMServer

    def server():
        return LMServer(cfg, device=dev, params=params,
                        mesh=build_mesh(("dp", "tp"), world=1, device=dev))

    single = drive(server(), dict(kind="batcher", kv_mode="paged",
                                  max_batch=d.get("max_batch", 2),
                                  segment_tokens=d.get("segment_tokens", 4),
                                  page_tokens=d.get("page_tokens", 8),
                                  prefill_chunk=d.get("prefill_chunk", 16),
                                  jobs=d["jobs"]))[0]
    servers = {"prefill": server(), "decode": server()}
    by_replica = _charge(servers)
    tokens, lps, bundles, _, _ = _handoff_pair(
        servers["prefill"], servers["decode"], d)
    out = {"tokens": single, "pair_tokens": tokens, "logprobs": lps,
           "bundles": bundles, "bundle_bytes": [len(b) for b in bundles],
           "page_bytes": [_page_bytes(b) for b in bundles],
           "launches_by_replica": by_replica}
    del servers
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def tp_block(cases: list, device: str = "cpu"):
    """Each case runs models/transformer_tp.py ``tp_block_apply`` on this
    rank's slice (``tp_block_specs``) of the whole numpy block
    ``case["params"]`` over ``build_mesh(("tp",), (world,))``, on the
    input ``case["x"]``, and differentiates ``mean(out^2)`` under the
    pipelines' tp calculus: each rank seeds 1/tp, the sharded leaves'
    gradients are then exact per shard, the replicated ones (and the
    input's) are summed over tp. Returns ``{"out", "grads"`` (this
    rank's slices), ``"dx"``, ``"coords"}`` per case, numpy."""
    import torch.distributed as dist

    from k8s_device_plugin_tpu_torch.models import transformer
    from k8s_device_plugin_tpu_torch.models import transformer_tp
    from k8s_device_plugin_tpu_torch.parallel.pipeline_1f1b import (
        tp_edge_reduce,
    )
    from k8s_device_plugin_tpu_torch.parallel.sharding import local_slice

    dev = resolve_device(device)
    results = {}
    for case in cases:
        cfg = transformer.LMConfig(**case["config"])
        mesh = build_mesh(("tp",), (dist.get_world_size(),), device=dev)
        specs = transformer_tp.tp_block_specs()
        params = {k: local_slice(torch.as_tensor(v, device=dev), specs[k],
                                 mesh).clone().requires_grad_()
                  for k, v in case["params"].items()}
        x = torch.as_tensor(case["x"], device=dev).requires_grad_()
        out = transformer_tp.tp_block_apply(params, x, dtype=cfg.dtype,
                                            group=mesh.group("tp"))
        (out.float().square().mean() / mesh.size("tp")).backward()
        grads = tp_edge_reduce({k: p.grad for k, p in params.items()},
                               specs, mesh.group("tp"))
        dx = comm.all_reduce(x.grad.clone(), mesh.group("tp"))
        results[case["name"]] = {
            "out": _numpy(out), "grads": {k: _numpy(g)
                                          for k, g in grads.items()},
            "dx": _numpy(dx), "coords": mesh.coords}
    return results
