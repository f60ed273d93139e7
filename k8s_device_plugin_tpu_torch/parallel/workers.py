"""What the ranks of ``launch.spawn`` run: the multi-rank checks of the
tests (on the CPU, against the JAX reference in the test process) and of
chip_smoke.py (on the card, against the one-device path in rank 0).

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
