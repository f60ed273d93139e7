"""What the ranks of ``launch.spawn`` run: the multi-rank checks of the
tests (on the CPU, against the JAX reference in the test process) and of
chip_smoke.py (on the card, against the one-device path in rank 0):
ring attention and Ulysses, the sharded training step, and serving on
the ``dp x tp`` mesh (``serve``, with rank 0 leading).

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
    """Each case serves on the ``dp x tp`` mesh of every rank:
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

    dev = resolve_device(device)
    results = {}
    for case in cases:
        cfg = transformer.LMConfig(**case["config"])
        params = None
        if "params" in case:
            params = {n: torch.from_numpy(np.asarray(a))
                      for n, a in case["params"].items()}
        server = LMServer(cfg, device=dev, params=params)
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
