#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without a result:

- ``build``: compiles every kernel source under
  k8s_device_plugin_tpu_torch/csrc/ with nvcc, all at once; ptxas's
  registers and spills of every kernel instance.
- ``kernel``: each kernel's wrapper against its plain PyTorch version on
  the card, at the serving path's shapes and edge cases, with the
  tolerances stated in KERNEL_CASES; CUDA-event times of the kernel, the
  plain version and one PyTorch library call, beside the kernel's bound,
  with the achieved TFLOP/s and the bound's share of the kernel's time,
  and the wrapper's host time per call (host clock).
- ``model``: DecoderLM at the serving default's full width, the kernel
  against plain attention: greedy tokens identical in float32, logits
  within atol 0.1 / rtol 0.05 in bfloat16.
- ``profile``: torch.profiler over one admission prefill and one decode
  segment at the serving default (rows KV), and over one 64-token paged
  prefill chunk and one paged decode segment (4 rows at ~1000 tokens,
  pages of 16): device busy time, idle share, the largest kernels.
- ``kernel_paged``: the paged-attention kernel B2 against the plain
  paged read on the card (PAGED_CASES: decode steps and prefill chunks
  at the serving default with ragged row lengths up to 1024, the
  profile's 4 rows at 1000 tokens, rows on split boundaries, GQA, MQA,
  pages of 8 and 16, rows on the scratch page, d = 128 and 256 on both
  routes; the tolerances in PAGED_TOL), two launches bit-equal; each
  case's route and splits (paged_attn_plan); CUDA-event times of B2, the
  plain version and SDPA over already-gathered K/V (a yardstick that
  skips the page indirection), beside B2's bound by bytes.
- ``serve``: the llm-serve daemon (models/serve_http.main) in-process
  on a free port at the full-width default config, bf16, rows KV,
  --max-batch 4, warmed up: concurrent completions of mixed prompt
  lengths (one streamed), /healthz, /metrics, the kernels' launch counts
  over exactly this traffic, and a clean drain.
- ``serve_paged``: the same daemon at its default, paged KV: five
  completions of mixed prompt lengths (one streamed), the last sharing
  the first's page-aligned prefix; a prefix hit, copy-on-extend page
  copies, B2 launched exactly layers x (prefill chunks + decode steps)
  and B1 never over this traffic, /healthz, /metrics, a clean drain.
- ``kernel_bwd``: the backward kernels B3 (dQ) and B4 (dK/dV) through
  ``FlashAttention.backward`` against the plain backward on the same
  inputs, random output and lse cotangents, at the training shapes and
  edge cases of BWD_CASES (tolerances there); CUDA-event times of each
  kernel, the plain backward and SDPA's backward, beside the bounds, with
  TFLOP/s and bound shares; B3 and B4 each launched twice on the same
  inputs must give bitwise-equal dQ and dK/dV (one block owns each output
  row, and B4 sums GQA groups without atomics).
- ``train``: the trainer (models/train.main) at the ``LMConfig()``
  default, batch 8: 6 steps with checkpoints, then a resume to step 8;
  ``benchmark_train()`` at the flagship config (3 warm-up + 10 steps):
  step time, tokens/s, MFU, a falling loss; each of B1, B3, B4 launched
  exactly once per layer per step; float32 gradients of one
  flagship-width step (2 layers) with the kernels against plain
  attention.
- ``train_profile``: torch.profiler over one flagship training step:
  device busy time, idle share, the largest kernels, B1/B3/B4's share.

Then the card's name and power limit (nvidia-smi), the ``{"kernels":
[...]}`` line and, last, ``{"ok": true, "device": {...}}``. Without a
CUDA device, or outside a checkout of the repository, it exits non-zero
before any phase.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import logging
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))

# Peak rates of one H100 SXM (NVIDIA data sheet, dense): memory bytes/s
# and operations/s by input type. bound_ms = max(bytes / HBM, ops / peak).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"torch.bfloat16": 989e12, "torch.float32": 67e12}

# (name, batch, heads, kv_heads, seq, head_dim, dtype, causal). The first
# case is the serving path's widest prefill at the default config
# ([rows=4, 16 heads, 1024 tokens, d=64], bf16, causal): its times are
# the ones reported for the kernel.
KERNEL_CASES = [
    ("serve_b4_s1024_bf16", 4, 16, 16, 1024, 64, "bfloat16", True),
    ("b1_s1_bf16", 1, 16, 16, 1, 64, "bfloat16", True),
    ("b1_s128_bf16", 1, 16, 16, 128, 64, "bfloat16", True),
    ("b1_s1024_bf16", 1, 16, 16, 1024, 64, "bfloat16", True),
    ("b4_s128_bf16", 4, 16, 16, 128, 64, "bfloat16", True),
    ("b1_s128_f32", 1, 16, 16, 128, 64, "float32", True),
    ("b1_s1024_f32", 1, 16, 16, 1024, 64, "float32", True),
    ("b4_s128_f32", 4, 16, 16, 128, 64, "float32", True),
    ("b4_s1024_f32", 4, 16, 16, 1024, 64, "float32", True),
    ("gqa_d128_bf16", 2, 16, 4, 512, 128, "bfloat16", True),
    ("gqa_d128_f32", 2, 16, 4, 512, 128, "float32", True),
    ("noncausal_bf16", 2, 8, 8, 256, 64, "bfloat16", False),
    ("noncausal_d128_f32", 2, 8, 8, 256, 128, "float32", False),
    ("s200_bf16", 2, 8, 8, 200, 64, "bfloat16", True),
    ("s200_f32", 2, 8, 8, 200, 64, "float32", True),
    ("s129_d128_bf16", 2, 8, 2, 129, 128, "bfloat16", True),
    # the trainer default's shape (LMConfig(): d = 64)
    ("train_b8_s2048_d64_bf16", 8, 8, 8, 2048, 64, "bfloat16", True),
    # the flagship training shape (reported as B1's training time)
    ("train_b8_s2048_d128_bf16", 8, 8, 8, 2048, 128, "bfloat16", True),
    # d = 256 runs its own instance; d = 192 is zero-padded to it
    ("d256_b2_s2048_bf16", 2, 8, 8, 2048, 256, "bfloat16", True),
    ("d256_gqa_s512_f32", 2, 8, 2, 512, 256, "float32", True),
    ("d256_s129_bf16", 2, 4, 4, 129, 256, "bfloat16", False),
    ("pad_d192_s512_bf16", 2, 8, 8, 512, 192, "bfloat16", True),
    ("pad_d192_s200_f32", 2, 4, 2, 200, 192, "float32", True),
]
TRAIN_FWD_CASE = "train_b8_s2048_d128_bf16"
# Tolerances against the plain version on the same inputs. float32: the
# two differ only in summation order. bfloat16: the plain version rounds
# QK^T to bf16 before the softmax (as the reference's jnp code does) and
# the kernel keeps it in fp32; at unit-normal inputs that moves scaled
# scores by up to ~1e-2, and O is rounded to bf16 on output.
TOL = {"float32": 1e-4, "bfloat16": 3e-2}

# Backward cases, same fields. The first is the flagship training shape
# (benchmark_train's config: batch 8, 8 heads, 2048 tokens, d = 128) and
# gives the times reported for B3 and B4; the second is the trainer's
# LMConfig() default (d = 64). "pad_d32" runs d = 32 through the
# zero-padding to the kernels' 64.
BWD_CASES = [
    ("train_b8_s2048_d128_bf16", 8, 8, 8, 2048, 128, "bfloat16", True),
    ("train_b8_s2048_d64_bf16", 8, 8, 8, 2048, 64, "bfloat16", True),
    ("gqa_d128_bf16", 2, 16, 4, 512, 128, "bfloat16", True),
    ("gqa_d128_f32", 2, 16, 4, 512, 128, "float32", True),
    ("noncausal_d128_bf16", 2, 8, 8, 256, 128, "bfloat16", False),
    ("noncausal_d64_f32", 2, 8, 8, 256, 64, "float32", False),
    ("s200_bf16", 2, 8, 8, 200, 64, "bfloat16", True),
    ("s200_f32", 2, 8, 8, 200, 64, "float32", True),
    ("pad_d32_bf16", 2, 8, 8, 256, 32, "bfloat16", True),
    # d = 256 (B4 as two column halves per key tile); d = 192 padded to it
    ("d256_b2_s2048_bf16", 2, 8, 8, 2048, 256, "bfloat16", True),
    ("d256_gqa_s512_bf16", 2, 8, 2, 512, 256, "bfloat16", True),
    ("d256_gqa_s256_f32", 1, 8, 2, 256, 256, "float32", True),
    ("d256_s129_bf16", 2, 4, 4, 129, 256, "bfloat16", False),
    ("pad_d192_s512_bf16", 2, 8, 8, 512, 192, "bfloat16", True),
    ("pad_d192_s200_f32", 1, 4, 2, 200, 192, "float32", True),
]
# Backward tolerances, on max |kernel - plain| / max |plain| of each of
# dQ, dK, dV. float32: summation order only. bfloat16: the kernels round
# P and dS to bf16 as the A operands of their tensor-core products (the
# plain version keeps fp32); the reference's own bf16 backward bar is
# 0.25 (tests/test_workloads.py:147-150).
BWD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# float32 gradients of a whole flagship-width step, kernels vs plain
# attention, relative to each parameter's largest gradient.
TRAIN_GRAD_TOL = 1e-3


def _jline(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3,
            queued: bool = True) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` launches (CUDA
    events around the whole run, after ``warmup`` calls). The launches
    queue behind a sleep kernel that outlasts their enqueueing, so a
    kernel shorter than its wrapper's host time is timed on the device,
    not at the host's pace. ``queued=False`` leaves the sleep out (the
    host-paced timer of earlier revisions of this script, kept to compare
    revisions with it)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    if queued:
        # ~2 GHz: twice the calls' host time, at least 1 ms
        torch.cuda._sleep(int(4e9 * max(1e-3, iters * host_s)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean host time of one ``fn`` call in ms (host clock over ``iters``
    calls, no synchronisation between them): what the wrapper costs the
    host per launch, however short the kernel."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def attention_ops(b, h, s, d, causal, products: int = 2) -> float:
    """FLOP of ``products`` attention-shaped products (2 per multiply-add)
    over the query/key pairs the mask leaves visible."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return products * 2.0 * b * h * d * pairs


def attention_bound_ms(b, h, kvh, s, d, dtype, causal) -> tuple[float, str]:
    """(least ms, what bounds it) for one flash forward: Q, K, V read
    once, O and LSE written once, over HBM; the QK^T and PV products over
    the card's peak for the input type."""
    import torch

    esize = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    nbytes = esize * (2 * b * h * s * d + 2 * b * kvh * s * d) + 4 * b * h * s
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = attention_ops(b, h, s, d, causal) / PEAK_OPS_PER_S[f"torch.{dtype}"]
    return 1e3 * max(t_bytes, t_ops), \
        ("operations" if t_ops >= t_bytes else "bytes")


def rates(row: dict, ms_key: str, bound_key: str, ops: float,
          prefix: str = "") -> None:
    """Achieved TFLOP/s and the bound's share of the measured time."""
    row[f"{prefix}tflops"] = ops / (row[ms_key] * 1e-3) / 1e12
    row[f"{prefix}bound_share"] = row[bound_key] / row[ms_key]


def phase_build() -> dict:
    from k8s_device_plugin_tpu_torch.ops import _build

    names = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                   if f.endswith(".cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(_build.compile_source, names)))
    report = {}
    for name, (_, text) in built.items():
        report.update(ptxas_report(text))
    spills = sorted(k for k, v in report.items()
                    if re.search(r"[1-9]\d* bytes spill", v))
    return {"phase": "build", "ok": True, "kernels": names,
            "seconds": time.perf_counter() - t0, "ptxas": report,
            "kernels_with_spills": spills}


_TYPE_ARGS = {"f": "float", "13__nv_bfloat16": "bf16"}


def _demangle_kernel(mangled: str) -> str:
    """``..21flash_fwd_bf16_kernelILi128ELb1EE..`` -> ``flash_fwd_bf16_kernel
    <128,1>``, ``..24paged_attn_decode_kernelI13__nv_bfloat16Li64EE..`` ->
    ``paged_attn_decode_kernel<bf16,64>`` (Itanium names carry their length
    before them)."""
    for m in re.finditer(r"\d+", mangled):
        for i in range(len(m.group())):  # the length may follow other digits
            ident = mangled[m.end():m.end() + int(m.group()[i:])]
            if ident.endswith("_kernel"):
                args = re.match(r"I((?:L[ib]\d+E|f|13__nv_bfloat16)+)E",
                                mangled[m.end() + len(ident):])
                vals = re.findall(r"L[ib](\d+)E|(f|13__nv_bfloat16)",
                                  args.group(1)) if args else []
                names = [n or _TYPE_ARGS[t] for n, t in vals]
                return f"{ident}<{','.join(names)}>"
    return mangled


def ptxas_report(text: str) -> dict:
    """``-Xptxas -v`` output as {"kernel<template args>": "Used N
    registers; spill stores, spill loads"}, plus any C75xx advice."""
    report, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = _demangle_kernel(m.group(1))
            report[name] = ""
        elif name and ("spill" in ln or "Used" in ln):
            report[name] = (report[name] + "; " + ln.split(":")[-1].strip()
                            if "Used" in ln else ln.strip())
        elif "C75" in ln:
            report.setdefault("advice", []).append(ln.strip()[:200])
    return report


def phase_kernel() -> tuple[dict, dict]:
    import torch
    import torch.nn.functional as F

    from k8s_device_plugin_tpu_torch.ops import attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases, worst = [], 0.0
    for name, b, h, kvh, s, d, dt, causal in KERNEL_CASES:
        dtype = getattr(torch, dt)
        q = torch.randn(b, h, s, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, kvh, s, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, kvh, s, d, device="cuda", generator=gen).to(dtype)
        # a head dim without its own instance goes through the padding
        fwd = attention.flash_forward_cuda
        if attention.kernel_head_dim(d) != d:
            fwd = attention.flash_attention_with_lse
        out, lse = fwd(q, k, v, causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = attention.reference_attention_with_lse(
            q, k, v, causal)
        err_o = (out.float() - ref_out.float()).abs().max().item()
        err_l = (lse - ref_lse).abs().max().item()
        if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
            raise AssertionError(f"kernel {name}: non-finite output")
        if max(err_o, err_l) > TOL[dt]:
            raise AssertionError(
                f"kernel {name}: |O - plain| {err_o:.3g}, |LSE - plain| "
                f"{err_l:.3g} over tolerance {TOL[dt]}")
        worst = max(worst, err_o, err_l)
        ke, ve = attention.expand_kv(k, h), attention.expand_kv(v, h)
        row = {
            "case": name, "shape": [b, h, kvh, s, d], "dtype": dt,
            "causal": causal, "max_abs_err_out": err_o,
            "max_abs_err_lse": err_l, "tol": TOL[dt],
            "ms": cuda_ms(lambda: fwd(q, k, v, causal)),
            "host_ms": host_ms(lambda: fwd(q, k, v, causal)),
            "plain_ms": cuda_ms(
                lambda: attention.reference_attention_with_lse(
                    q, k, v, causal), iters=5),
            "library_ms": cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    q, ke, ve, is_causal=causal)),
        }
        row["bound_ms"], row["bound_by"] = attention_bound_ms(
            b, h, kvh, s, d, dt, causal)
        rates(row, "ms", "bound_ms", attention_ops(b, h, s, d, causal))
        cases.append(row)
    main = cases[0]
    train = next(c for c in cases if c["case"] == TRAIN_FWD_CASE)
    summary = {
        "name": attention.FLASH_FWD.name, "route": "cuda",
        "source": attention.FLASH_FWD.source,
        "replaces": attention.FLASH_FWD.replaces,
        "max_abs_err": worst, "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "timed_case": main["case"], "host_ms": main["host_ms"],
        "train_case": {k: train[k] for k in (
            "case", "ms", "host_ms", "plain_ms", "library_ms", "bound_ms",
            "tflops", "bound_share")},
    }
    return {"phase": "kernel", "ok": True, "cases": cases}, summary


def bwd_bound(b, h, kvh, s, d, dtype, causal, kernel) -> tuple[float, str]:
    """(least ms, what bounds it) of one backward kernel: B3 ("dq") reads
    q, k, v, dO, LSE, delta and writes dQ, three products (S, dP, dQ);
    B4 ("dkv") reads the same and writes dK, dV, four products (S, dP,
    dV, dK); 2 FLOP per multiply-add over the visible pairs."""
    import torch

    esize = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    rows_h, rows_kv, products = (3, 2, 3) if kernel == "dq" else (2, 4, 4)
    nbytes = esize * (rows_h * b * h + rows_kv * b * kvh) * s * d \
        + 8 * b * h * s
    pairs = s * (s + 1) // 2 if causal else s * s
    ops = products * 2.0 * b * h * d * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[f"torch.{dtype}"]
    return 1e3 * max(t_bytes, t_ops), \
        ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernel_bwd() -> tuple[dict, list]:
    """B3 and B4 through FlashAttention.backward, against the plain
    backward on the same saved tensors and cotangents."""
    import torch
    import torch.nn.functional as F

    from k8s_device_plugin_tpu_torch.ops import attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = []
    worst = {"dq": 0.0, "dkv": 0.0}
    for name, b, h, kvh, s, d, dt, causal in BWD_CASES:
        dtype = getattr(torch, dt)

        def rand(*shape):
            return torch.randn(*shape, device="cuda", generator=gen)

        q, k, v = (rand(b, n, s, d).to(dtype) for n in (h, kvh, kvh))
        g, g_lse = rand(b, h, s, d).to(dtype), rand(b, h, s)
        qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
        out, lse = attention.FlashAttention.apply(qq, kk, vv, causal)
        torch.autograd.backward((out, lse), (g, g_lse))
        torch.cuda.synchronize()
        out, lse = out.detach(), lse.detach()
        want = attention.reference_attention_backward(q, k, v, out, lse, g,
                                                      g_lse, causal=causal)
        row = {"case": name, "shape": [b, h, kvh, s, d], "dtype": dt,
               "causal": causal, "tol": BWD_TOL[dt]}
        for gname, got, ref in zip(("dq", "dk", "dv"),
                                   (qq.grad, kk.grad, vv.grad), want):
            if got.shape != ref.shape or not torch.isfinite(got).all():
                raise AssertionError(f"kernel_bwd {name}: {gname} shape "
                                     f"{tuple(got.shape)} or non-finite")
            diff = (got.float() - ref.float()).abs().max().item()
            rel = diff / max(ref.float().abs().max().item(), 1e-30)
            row[f"rel_err_{gname}"] = rel
            row[f"max_abs_err_{gname}"] = diff
            kernel = "dq" if gname == "dq" else "dkv"
            worst[kernel] = max(worst[kernel], diff)
            if rel > BWD_TOL[dt]:
                raise AssertionError(
                    f"kernel_bwd {name}: {gname} off the plain backward by "
                    f"{rel:.3g} of its largest value (tolerance "
                    f"{BWD_TOL[dt]})")
        if d in (64, 128, 256):
            delta = attention.attention_delta(out, g, g_lse)
            row["dq_ms"] = cuda_ms(lambda: attention.flash_bwd_dq_cuda(
                q, k, v, g, lse, delta, causal))
            row["dkv_ms"] = cuda_ms(lambda: attention.flash_bwd_dkv_cuda(
                q, k, v, g, lse, delta, causal))
            row["plain_ms"] = cuda_ms(
                lambda: attention.reference_attention_backward(
                    q, k, v, out, lse, g, g_lse, causal=causal),
                iters=3, warmup=1)
            # SDPA's backward alone (the whole dQ, dK, dV), over K/V
            # expanded to q's heads.
            qs, ke, ve = (x.clone().requires_grad_() for x in (
                q, attention.expand_kv(k, h), attention.expand_kv(v, h)))
            o = F.scaled_dot_product_attention(qs, ke, ve, is_causal=causal)
            row["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
                o, (qs, ke, ve), g, retain_graph=True))
            del o, qs, ke, ve
            for kernel, products in (("dq", 3), ("dkv", 4)):
                row[f"{kernel}_bound_ms"], row[f"{kernel}_bound_by"] = \
                    bwd_bound(b, h, kvh, s, d, dt, causal, kernel)
                rates(row, f"{kernel}_ms", f"{kernel}_bound_ms",
                      attention_ops(b, h, s, d, causal, products),
                      prefix=f"{kernel}_")
            if dt == "bfloat16":
                # One block owns each dQ row (B3), and B4 sums each GQA
                # group in registers: two launches on the same inputs must
                # agree bit for bit.
                first = attention.flash_bwd_dq_cuda(q, k, v, g, lse, delta,
                                                    causal)
                second = attention.flash_bwd_dq_cuda(q, k, v, g, lse, delta,
                                                     causal)
                if not torch.equal(first, second):
                    raise AssertionError(f"kernel_bwd {name}: B3 is not "
                                         f"deterministic")
                row["dq_deterministic"] = True
                first = attention.flash_bwd_dkv_cuda(q, k, v, g, lse, delta,
                                                     causal)
                second = attention.flash_bwd_dkv_cuda(q, k, v, g, lse,
                                                      delta, causal)
                if not all(torch.equal(x, y) for x, y in zip(first, second)):
                    raise AssertionError(f"kernel_bwd {name}: B4 is not "
                                         f"deterministic")
                row["dkv_deterministic"] = True
                del first, second
        cases.append(row)
        del q, k, v, g, qq, kk, vv, out, lse, want
        torch.cuda.empty_cache()
    main = cases[0]
    summaries = []
    for kernel, stats in (("dq", attention.FLASH_BWD_DQ),
                          ("dkv", attention.FLASH_BWD_DKV)):
        summaries.append({
            "name": stats.name, "route": "cuda", "source": stats.source,
            "replaces": stats.replaces, "max_abs_err": worst[kernel],
            "ms": main[f"{kernel}_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main[f"{kernel}_bound_ms"],
            "bound_by": main[f"{kernel}_bound_by"],
            "library_ms": main["library_ms"], "timed_case": main["case"],
        })
    return {"phase": "kernel_bwd", "ok": True, "cases": cases}, summaries


# Paged-attention cases of B2: (name, batch, L, heads, kv_heads, head_dim,
# page_tokens, row lengths, dtype). Row r's queries sit at positions
# lens[r] .. lens[r] + L - 1; a length of -1 is a row whose table points
# at scratch page 0 only (a padding row of the engine). The first case is
# a decode step of the serving default (4 rows, 16 heads, d = 64, pages
# of 16) with ragged lengths up to 1024 and gives the times reported for
# B2; the second a 64-token prefill chunk at the same shape.
PAGED_CASES = [
    ("decode_b4_p16_bf16", 4, 1, 16, 16, 64, 16, (1023, 700, 301, 37),
     "bfloat16"),
    ("chunk_b4_L64_p16_bf16", 4, 64, 16, 16, 64, 16, (960, 512, 100, 0),
     "bfloat16"),
    ("decode_b4_p16_f32", 4, 1, 16, 16, 64, 16, (1023, 700, 301, 37),
     "float32"),
    ("chunk_b4_L64_p16_f32", 4, 64, 16, 16, 64, 16, (960, 512, 100, 0),
     "float32"),
    ("gqa_decode_p8_bf16", 4, 1, 16, 4, 64, 8, (1000, 17, 5, -1),
     "bfloat16"),
    ("mqa_chunk_L16_p8_f32", 2, 16, 8, 1, 128, 8, (333, -1), "float32"),
    ("gqa_chunk_L64_p8_bf16", 3, 64, 8, 2, 128, 8, (900, 64, -1),
     "bfloat16"),
    ("d256_chunk_L8_p16_bf16", 2, 8, 8, 4, 256, 16, (700, 3), "bfloat16"),
    ("d256_decode_p16_f32", 2, 1, 8, 8, 256, 16, (511, -1), "float32"),
    # the profile's decode step: 4 rows at 1000 tokens
    ("decode_b4_1000_p16_bf16", 4, 1, 16, 16, 64, 16, (1000,) * 4,
     "bfloat16"),
    # rows whose keys end on a split's last key (128 keys a split here),
    # start the next split, or sit at position 0
    ("edge_decode_b4_p16_bf16", 4, 1, 16, 16, 64, 16, (127, 255, 0, 1023),
     "bfloat16"),
    ("edge_chunk_b4_L64_p16_bf16", 4, 64, 16, 16, 64, 16, (64, 128, 0, 960),
     "bfloat16"),
    ("edge_decode_b4_p16_f32", 4, 1, 16, 16, 64, 16, (127, 128, 0, 1023),
     "float32"),
    # d = 256 on the chunk route; GQA with 64 query rows a kv head
    ("d256_chunk_L16_p16_bf16", 2, 16, 8, 8, 256, 16, (700, 3), "bfloat16"),
    ("gqa_chunk_L8_n8_p16_bf16", 4, 8, 16, 2, 128, 16, (1000, 500, 60, 0),
     "bfloat16"),
]
# B2 against the plain paged read. float32: summation order only (fp32
# products on both sides). bfloat16: the plain version rounds the scores
# and the probabilities to bf16 (as the reference's gather does), B2 keeps
# them in fp32; outputs are rounded to bf16. bfloat16 outputs are also
# held row by row against the read in float32 from the same operands
# (paged_attention_fp32, P rounded on the chunk route), within
# PAGED_BF16_ROW_TOL of each row's largest value (ops/paged_attention.py).
PAGED_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def paged_case_inputs(b, L, h, kvh, d, page_tokens, lens, dtype, gen):
    """(q, k_pages, v_pages, bt, q_pos, live pages) on the card for one
    case: each row's pages drawn from the pool in a scrambled order, the
    table one slot wider than the longest row needs, scratch page 0 in
    every slot a row does not use."""
    import torch

    span = max(max(lens) + L, L)
    W = -(-span // page_tokens) + 1
    pool_pages = 1 + b * W
    perm = torch.randperm(pool_pages - 1, generator=gen) + 1
    # int64, as the serving engine hands them to B2
    bt = torch.zeros((b, W), dtype=torch.int64)
    q_pos = torch.zeros((b, L), dtype=torch.int64)
    live = 0
    for r, n in enumerate(lens):
        q_pos[r] = max(n, 0) + torch.arange(L)
        used = -(-(max(n, 0) + L) // page_tokens)
        live += used
        if n >= 0:
            bt[r, :used] = perm[r * W:r * W + used]

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dtype).cuda()

    return (rand(b, L, h, d), rand(pool_pages, page_tokens, kvh, d),
            rand(pool_pages, page_tokens, kvh, d), bt.cuda(), q_pos.cuda(),
            live)


def paged_bound_ms(b, L, h, kvh, d, page_tokens, live_pages, dtype,
                   q_pos) -> tuple[float, str]:
    """(least ms, what bounds it) of one paged read: each live K/V page
    read once, q read and out written once, over HBM; 4·d FLOP (QK^T and
    PV) per query and visible key over the card's peak for the type."""
    import torch

    esize = torch.empty((), dtype=dtype).element_size()
    nbytes = (esize * (2 * live_pages * page_tokens * kvh * d
                       + 2 * b * L * h * d)
              + q_pos.element_size() * q_pos.numel())
    visible = float((q_pos.double() + 1).sum().item()) * h
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 4.0 * d * visible / PEAK_OPS_PER_S[str(dtype)]
    return 1e3 * max(t_bytes, t_ops), \
        ("operations" if t_ops >= t_bytes else "bytes")


def phase_paged_kernel() -> tuple[dict, dict]:
    """B2 against the plain paged read on the card (PAGED_CASES), two
    launches bit-equal, CUDA-event times of B2, the plain version and
    SDPA over K/V already gathered into contiguous rows (a yardstick
    that skips the page indirection), beside B2's bound."""
    import torch
    import torch.nn.functional as F

    from k8s_device_plugin_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(5)
    cases, worst, worst_row = [], 0.0, 0.0
    for name, b, L, h, kvh, d, page_tokens, lens, dt in PAGED_CASES:
        dtype = getattr(torch, dt)
        q, kp, vp, bt, q_pos, live = paged_case_inputs(
            b, L, h, kvh, d, page_tokens, lens, dtype, gen)
        args = (q, kp, vp, bt, q_pos)
        plan = pa.paged_attn_plan(b, L, h, kvh, d, page_tokens,
                                  bt.shape[1], dtype)
        out = pa.paged_attention_cuda(*args)
        again = pa.paged_attention_cuda(*args)
        torch.cuda.synchronize()
        want = pa.paged_attention_reference(*args)
        err = (out.float() - want.float()).abs().max().item()
        if not torch.isfinite(out).all() or err > PAGED_TOL[dt]:
            raise AssertionError(f"paged {name}: |B2 - plain| {err:.3g} "
                                 f"over tolerance {PAGED_TOL[dt]}")
        if not torch.equal(out, again):
            raise AssertionError(f"paged {name}: two launches differ")
        row_err = row_tol = None
        if dtype == torch.bfloat16:
            row_tol = pa.PAGED_BF16_ROW_TOL
            row_err = pa.row_rel_err(out, pa.paged_attention_fp32(
                *args, round_p=plan.route == "chunk"))
            if row_err > row_tol:
                raise AssertionError(
                    f"paged {name}: row |B2 - fp32 read| / row max "
                    f"{row_err:.3g} over {row_tol}")
            worst_row = max(worst_row, row_err)
        worst = max(worst, err)
        # The yardstick: SDPA over each row's gathered [W·P] keys with the
        # position mask, q heads over expanded kv heads.
        span = bt.shape[1] * page_tokens
        kc = kp[bt.long()].reshape(b, span, kvh, d).transpose(1, 2)
        vc = vp[bt.long()].reshape(b, span, kvh, d).transpose(1, 2)
        kc = kc.repeat_interleave(h // kvh, 1).contiguous()
        vc = vc.repeat_interleave(h // kvh, 1).contiguous()
        qs = q.transpose(1, 2).contiguous()
        mask = (torch.arange(span, device="cuda")[None, None, :]
                <= q_pos[:, :, None])[:, None]
        row = {
            "case": name, "shape": [b, L, h, kvh, d], "page_tokens":
            page_tokens, "lens": list(lens), "dtype": dt,
            "route": plan.route, "n_splits": plan.n_splits,
            "keys_per_split": plan.keys_per_split, "blocks": plan.blocks,
            "max_abs_err": err, "tol": PAGED_TOL[dt],
            "row_rel_err": row_err, "row_tol": row_tol,
            "bit_equal_launches": True, "live_pages": live,
            "ms": cuda_ms(lambda: pa.paged_attention_cuda(*args)),
            "host_ms": host_ms(lambda: pa.paged_attention_cuda(*args)),
            "plain_ms": cuda_ms(
                lambda: pa.paged_attention_reference(*args), iters=5),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                qs, kc, vc, attn_mask=mask)),
        }
        row["bound_ms"], row["bound_by"] = paged_bound_ms(
            b, L, h, kvh, d, page_tokens, live, dtype, q_pos)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        cases.append(row)
        del args, q, kp, vp, kc, vc, qs, out, again, want
    torch.cuda.empty_cache()
    main, chunk = cases[0], cases[1]
    summary = {
        "name": pa.PAGED_ATTN.name, "route": "cuda",
        "source": pa.PAGED_ATTN.source, "replaces": pa.PAGED_ATTN.replaces,
        "max_abs_err": worst, "max_row_rel_err_bf16": worst_row,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "library": "scaled_dot_product_attention over pre-gathered K/V "
                   "(a yardstick: it skips the page indirection)",
        "timed_case": main["case"], "host_ms": main["host_ms"],
        "timed_route": main["route"], "n_splits": main["n_splits"],
        "chunk_case": {k: chunk[k] for k in (
            "case", "route", "n_splits", "ms", "host_ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "bound_share")},
    }
    return {"phase": "kernel_paged", "ok": True, "cases": cases}, summary


@contextlib.contextmanager
def plain_attention():
    """Route the model's attention through the plain PyTorch version
    (the comparison side of the model phase)."""
    from k8s_device_plugin_tpu_torch.models import transformer
    from k8s_device_plugin_tpu_torch.ops import attention

    kernel = transformer.flash_attention
    transformer.flash_attention = attention.reference_attention
    try:
        yield
    finally:
        transformer.flash_attention = kernel


MODEL_PROMPT_LENS = (100, 300, 700, 900)


def phase_model() -> dict:
    """Full-width DecoderLM (the serving default), kernel vs plain."""
    import dataclasses

    import torch

    from k8s_device_plugin_tpu_torch.models.serve_engine import (
        LMServer,
        default_config,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, 32000, (n,), generator=rng).tolist()
               for n in MODEL_PROMPT_LENS]
    res = {"phase": "model", "prompt_lens": list(MODEL_PROMPT_LENS)}

    # float32: greedy tokens identical over 16 steps for 4 prompts.
    srv = LMServer(config=dataclasses.replace(default_config(),
                                              dtype=torch.float32),
                   device="cuda")
    budgets = [16] * len(prompts)
    got, _ = srv.complete_batch(prompts, budgets)
    with plain_attention():
        want, _ = srv.complete_batch(prompts, budgets)
    if got != want:
        raise AssertionError("model fp32: kernel and plain attention "
                             "decode different greedy tokens")
    res["fp32_greedy_identical"] = True
    res["fp32_tokens"] = [g[len(p):] for g, p in zip(got, prompts)]
    del srv
    torch.cuda.empty_cache()

    # bfloat16: prefill logits within atol 0.1 / rtol 0.05.
    srv = LMServer(device="cuda")
    bucket = srv._prefill_bucket(max(MODEL_PROMPT_LENS))
    toks = torch.tensor([p + [0] * (bucket - len(p)) for p in prompts],
                        device="cuda")
    got_logits, _ = srv._prefill(toks)
    with plain_attention():
        want_logits, _ = srv._prefill(toks)
    if not torch.isfinite(got_logits).all():
        raise AssertionError("model bf16: non-finite logits")
    diff = (got_logits - want_logits).abs()
    excess = (diff - (0.1 + 0.05 * want_logits.abs())).max().item()
    if excess > 0:
        raise AssertionError(f"model bf16: logits outside atol 0.1 / "
                             f"rtol 0.05 (by {excess:.3g})")
    res["bf16_max_abs_logit_diff"] = diff.max().item()
    res["bf16_logit_absmax"] = want_logits.abs().max().item()
    res["ok"] = True
    del srv
    torch.cuda.empty_cache()
    return res


def _device_events(prof):
    """(kernel name, device ms, calls) of every CUDA-side event. User
    annotations (``record_function`` ranges such as the optimizer's
    ``Optimizer.step#AdamW.step``) are skipped: they span kernels that
    are counted on their own."""
    import torch

    out = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out.append((e.key, us / 1e3, e.count))
    return sorted(out, key=lambda x: -x[1])


def phase_profile() -> dict:
    """Device time of one admission prefill ([4 rows, 1024 tokens]) and
    one 16-token decode segment over 4 rows at the serving default
    (bf16, rows KV), and of one paged prefill chunk and one paged decode
    segment at the same width, under torch.profiler: busy time, idle
    share of the wall time, the largest kernels and the flash (B1) and
    paged (B2) kernels' shares."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from k8s_device_plugin_tpu_torch.models.serve_engine import LMServer

    srv = LMServer(device="cuda")
    rows, lb, seg = 4, srv.config.max_seq_len, 16
    gen = srv.generator(0)
    zeros = dict(temps=[0.0] * rows, topks=[0] * rows)

    def prefill():
        return srv.prefill_rows([[1] * lb] * rows, [lb] * rows,
                                zeros["temps"], zeros["topks"], gen)

    pool = srv.insert_rows(srv.make_pool_cache(rows), prefill()[0],
                           list(range(rows)))
    tok = np.ones((rows, 1), np.int64)
    temp, topk = np.zeros(rows, np.float32), np.zeros(rows, np.int64)

    def decode():
        return srv.decode_segment(pool, tok, gen, temp, topk, seg)

    # The paged programs at the same width: each row owns 64 pages of 16
    # (its whole 1024-token table); a 64-token chunk at positions
    # 960..1023, and a 16-step segment from position 1000.
    page_tokens, width = 16, lb // 16
    ppool = srv.make_paged_pool(rows * width + 1, page_tokens)
    bt = np.arange(1, rows * width + 1, dtype=np.int64).reshape(rows, width)
    ones, zeros_i = np.ones(rows, np.int64), np.zeros(rows, np.int64)

    def paged_chunk():
        return srv.paged_prefill_chunk(
            ppool, np.ones((rows, 64), np.int64), bt, 960 * ones,
            63 * ones, gen, temp, zeros_i)

    def paged_decode():
        return srv.paged_decode_segment(ppool, bt, tok, 1000 * ones, gen,
                                        temp, topk, seg)

    decode()
    paged_chunk()
    paged_decode()
    torch.cuda.synchronize()
    res = {"phase": "profile", "rows": rows, "prompt_tokens": lb,
           "segment": seg, "paged": {"page_tokens": page_tokens,
                                     "table_width": width,
                                     "chunk_positions": [960, 1023],
                                     "decode_from": 1000}}
    for name, fn in (("prefill", prefill), ("decode_segment", decode),
                     ("paged_prefill_chunk", paged_chunk),
                     ("paged_decode_segment", paged_decode)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = _device_events(prof)
        busy = sum(ms for _, ms, _ in events)
        flash = sum(ms for k, ms, _ in events if "flash_fwd" in k)
        paged = sum(ms for k, ms, _ in events if "paged_attn" in k)
        res[name] = {
            "wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms if busy else None,
            "flash_fwd_ms": flash, "paged_attn_ms": paged,
            "kernels": len(events),
            "launches": sum(n for _, _, n in events),
            "top": [[k[:80], ms, n] for k, ms, n in events[:6]],
        }
    res["ok"] = True
    del srv, pool, ppool
    torch.cuda.empty_cache()
    return res


def _post(port: int, body: dict, timeout: float = 300.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        raw = resp.read()
        status = resp.status
    return status, raw, time.perf_counter() - t0


def _get(port: int, path: str) -> tuple[int, str]:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return resp.status, resp.read().decode()


def _metric_sum(text: str, family: str) -> float:
    total = 0.0
    for ln in text.splitlines():
        if ln.startswith(family + "{") or ln.startswith(family + " "):
            total += float(ln.rsplit(" ", 1)[1])
    return total


SERVE_PROMPT_LENS = (40, 300, 620, 900, 150)
SERVE_MAX_TOKENS = 48


def phase_serve(counters) -> dict:
    """The daemon in-process: concurrent completions through the
    entry point a user runs, with the kernels' counts over the traffic."""
    from k8s_device_plugin_tpu_torch.models import serve_http

    ready = threading.Event()
    handle = {}

    def on_ready(httpd, batcher):
        handle["httpd"], handle["batcher"] = httpd, batcher
        ready.set()

    rc = {}
    daemon = threading.Thread(
        target=lambda: rc.setdefault("rc", serve_http.main(
            ["--port", "0", "--kv-cache", "rows", "--max-batch", "4"],
            on_ready=on_ready)),
        name="llm-serve-main", daemon=True,
    )
    t_start = time.perf_counter()
    daemon.start()
    if not ready.wait(600):
        raise AssertionError("serve: daemon not ready in 600 s")
    startup_s = time.perf_counter() - t_start
    httpd = handle["httpd"]
    port = httpd.server_address[1]
    try:
        _, before = _get(port, "/metrics")
        prefills0 = _metric_sum(before, "tpu_serve_prefill_bucket_total")
        for c in counters:
            c.launches = 0
        letters = "the quick brown fox jumps over the lazy dog "
        prompts = [(letters * 30)[:n] for n in SERVE_PROMPT_LENS]
        results = [None] * len(prompts)

        def one(i):
            body = {"prompt": prompts[i], "max_tokens": SERVE_MAX_TOKENS,
                    "logprobs": 1}
            if i == 0:
                body = {"prompt": prompts[i],
                        "max_tokens": SERVE_MAX_TOKENS, "stream": True}
            if i == len(prompts) - 1:
                time.sleep(0.3)  # a late join while the others decode
            results[i] = _post(port, body)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = {c.name: c.launches for c in counters}
        _, after = _get(port, "/metrics")
        prefills = _metric_sum(after, "tpu_serve_prefill_bucket_total") \
            - prefills0
        code, health = _get(port, "/healthz")
        if code != 200 or json.loads(health).get("status") != "ok":
            raise AssertionError(f"serve: /healthz {code} {health}")
        for fam in ("tpu_serve_ttft_seconds", "tpu_serve_requests_total",
                    "tpu_serve_decode_step_seconds",
                    "tpu_serve_prefill_bucket_total",
                    "tpu_serve_jit_compiles_total",
                    "tpu_serve_phase_seconds"):
            if fam not in after:
                raise AssertionError(f"serve: /metrics lacks {fam}")
        ttfts, rates, completions = [], [], []
        for i, res in enumerate(results):
            if res is None or res[0] != 200:
                raise AssertionError(f"serve: request {i} failed: {res}")
            status, raw, e2e = res
            if i == 0:
                frames = [ln[6:] for ln in raw.decode().splitlines()
                          if ln.startswith("data: ")]
                if not frames or frames[-1] != "[DONE]":
                    raise AssertionError("serve: stream lacks [DONE]")
                doc = json.loads(frames[-2])
            else:
                doc = json.loads(raw)
                lps = doc["choices"][0]["logprobs"]["token_logprobs"]
                if not lps or not all(v <= 0.0 and v == v for v in lps):
                    raise AssertionError(f"serve: bad logprobs {lps[:4]}")
            n_out = doc["usage"]["completion_tokens"]
            if n_out < 1:
                raise AssertionError(f"serve: request {i} decoded nothing")
            completions.append(n_out)
            ttfts.append(doc["ttft_seconds"])
            rates.append((n_out - 1) / max(e2e - doc["ttft_seconds"], 1e-9))
        n_layers = handle["batcher"].server.config.num_layers
        flash = launches["flash_fwd"]
        if prefills < 1 or flash < n_layers * prefills:
            raise AssertionError(
                f"serve: flash_fwd launched {flash} times for "
                f"{prefills} admission prefills of {n_layers} layers")
    finally:
        httpd.shutdown()
        daemon.join(timeout=120)
    if daemon.is_alive() or rc.get("rc") != 0:
        raise AssertionError(f"serve: drain not clean (rc {rc})")
    return {
        "phase": "serve", "ok": True, "startup_s": startup_s,
        "prompt_lens": list(SERVE_PROMPT_LENS),
        "max_tokens": SERVE_MAX_TOKENS, "completion_tokens": completions,
        "wall_s": wall, "ttft_s": ttfts, "decode_tokens_per_s": rates,
        "aggregate_tokens_per_s": sum(completions) / wall,
        "admission_prefills": prefills, "launches": launches,
        "drained": True,
    }


def _metric_labeled(text: str, family: str, label: str) -> float:
    """Sum of ``family``'s samples whose labels carry ``label`` (such as
    ``fn="paged_prefill"``)."""
    total = 0.0
    for ln in text.splitlines():
        if ln.startswith(family + "{") and label in ln.split("}")[0]:
            total += float(ln.rsplit(" ", 1)[1])
    return total


# The paged daemon's traffic: five prompts of mixed lengths; the last
# shares the first's page-aligned 320-byte prefix (20 pages of 16) and is
# sent once the first has its first token, so its prefix is published.
PAGED_PREFIX = ("the quick brown fox jumps over the lazy dog " * 8)[:320]
PAGED_PROMPTS = (
    PAGED_PREFIX + "and then it sat down in the sun",
    ("pack my box with five dozen liquor jugs " * 30)[:700],
    "hello there",
    ("sphinx of black quartz judge my vow " * 30)[:1000],
    PAGED_PREFIX + "but the dog did not wake up at all",
)


def phase_serve_paged(counters) -> dict:
    """The daemon in-process at its default (paged KV, full-width config,
    bf16, --max-batch 4), warmed up: concurrent completions, a prefix
    hit, copy-on-extend of shared tail pages, and B2 launched exactly
    layers x (prefill chunks + decode steps) over this traffic, B1
    never."""
    from k8s_device_plugin_tpu_torch.models import serve_http

    ready = threading.Event()
    handle = {}

    def on_ready(httpd, batcher):
        handle["httpd"], handle["batcher"] = httpd, batcher
        ready.set()

    rc = {}
    daemon = threading.Thread(
        target=lambda: rc.setdefault("rc", serve_http.main(
            ["--port", "0", "--max-batch", "4"], on_ready=on_ready)),
        name="llm-serve-paged-main", daemon=True,
    )
    t_start = time.perf_counter()
    daemon.start()
    if not ready.wait(600):
        raise AssertionError("serve_paged: daemon not ready in 600 s")
    startup_s = time.perf_counter() - t_start
    httpd, batcher = handle["httpd"], handle["batcher"]
    port = httpd.server_address[1]
    try:
        if batcher.kv_mode != "paged":
            raise AssertionError(f"serve_paged: default KV layout is "
                                 f"{batcher.kv_mode}")
        _, before = _get(port, "/metrics")
        for c in counters:
            c.launches = 0
        results = [None] * len(PAGED_PROMPTS)
        published = threading.Event()

        def one(i):
            body = {"prompt": PAGED_PROMPTS[i],
                    "max_tokens": SERVE_MAX_TOKENS, "logprobs": 1}
            if i == 0:
                body = {"prompt": PAGED_PROMPTS[i],
                        "max_tokens": SERVE_MAX_TOKENS, "stream": True}
            if i == len(PAGED_PROMPTS) - 1:
                published.wait(300)
            try:
                if i == 0:
                    results[i] = _stream_until_first(port, body, published)
                else:
                    results[i] = _post(port, body)
            finally:
                if i == 0:
                    published.set()

        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(PAGED_PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = {c.name: c.launches for c in counters}
        _, after = _get(port, "/metrics")

        def delta(family, label=None):
            if label is not None:
                return (_metric_labeled(after, family, label)
                        - _metric_labeled(before, family, label))
            return _metric_sum(after, family) - _metric_sum(before, family)

        hits = delta("tpu_serve_kv_prefix_lookups_total", 'outcome="hit"')
        copies = delta("tpu_serve_kv_page_copies_total")
        reused = delta("tpu_serve_kv_prefix_tokens_reused_total")
        chunks = delta("tpu_serve_phase_seconds_count", 'fn="paged_prefill"')
        segments = delta("tpu_serve_phase_seconds_count",
                         'fn="paged_segment"')
        code, health = _get(port, "/healthz")
        if code != 200 or json.loads(health).get("status") != "ok":
            raise AssertionError(f"serve_paged: /healthz {code} {health}")
        for fam in ("tpu_serve_kv_pages_in_use_count",
                    "tpu_serve_kv_prefix_lookups_total",
                    "tpu_serve_kv_page_copies_total",
                    "tpu_serve_jit_compiles_total",
                    "tpu_serve_ttft_seconds", "tpu_serve_requests_total"):
            if fam not in after:
                raise AssertionError(f"serve_paged: /metrics lacks {fam}")
        completions, ttfts = [], []
        for i, res in enumerate(results):
            if res is None or res[0] != 200:
                raise AssertionError(f"serve_paged: request {i} failed: "
                                     f"{res}")
            doc = res[1] if i == 0 else json.loads(res[1])
            if i:
                lps = doc["choices"][0]["logprobs"]["token_logprobs"]
                if not lps or not all(v <= 0.0 and v == v for v in lps):
                    raise AssertionError(f"serve_paged: bad logprobs "
                                         f"{lps[:4]}")
            if doc["usage"]["completion_tokens"] < 1:
                raise AssertionError(f"serve_paged: request {i} decoded "
                                     f"nothing")
            completions.append(doc["usage"]["completion_tokens"])
            ttfts.append(doc["ttft_seconds"])
        layers = batcher.server.config.num_layers
        want = layers * (chunks + segments * batcher.segment)
        if hits < 1 or reused < len(PAGED_PREFIX) or copies < 1:
            raise AssertionError(f"serve_paged: prefix hits {hits}, tokens "
                                 f"reused {reused}, page copies {copies}")
        if launches["paged_attn"] != want or launches["flash_fwd"] != 0:
            raise AssertionError(
                f"serve_paged: launches {launches}; want paged_attn = "
                f"{layers} layers x ({chunks} chunks + {segments} segments "
                f"x {batcher.segment} steps) = {want}, flash_fwd = 0")
        # B2's combine runs after each launch whose plan splits the keys:
        # at least the long rows' decode steps, never more than B2 itself.
        if not 0 < launches["paged_attn_combine"] <= want:
            raise AssertionError(f"serve_paged: combine launches "
                                 f"{launches['paged_attn_combine']}, want "
                                 f"1 .. {want}")
    finally:
        httpd.shutdown()
        daemon.join(timeout=120)
    if daemon.is_alive() or rc.get("rc") != 0:
        raise AssertionError(f"serve_paged: drain not clean (rc {rc})")
    return {
        "phase": "serve_paged", "ok": True, "startup_s": startup_s,
        "prompt_lens": [len(p) for p in PAGED_PROMPTS],
        "max_tokens": SERVE_MAX_TOKENS, "completion_tokens": completions,
        "wall_s": wall, "ttft_s": ttfts,
        "aggregate_tokens_per_s": sum(completions) / wall,
        "prefix_hits": hits, "prefix_tokens_reused": reused,
        "page_copies": copies, "prefill_chunks": chunks,
        "decode_segments": segments, "segment_tokens": batcher.segment,
        "page_tokens": batcher.kv_config.page_tokens,
        "pool_pages": batcher.kv_config.pool_pages,
        "launches": launches, "drained": True,
    }


def _stream_until_first(port: int, body: dict, first: threading.Event):
    """POST a streamed completion; sets ``first`` at its first data frame
    (its prompt's pages are then in the prefix index) and returns
    (status, the final JSON frame)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    frames = []
    with urllib.request.urlopen(req, timeout=300) as resp:
        for raw in resp:
            ln = raw.decode().strip()
            if ln.startswith("data: "):
                frames.append(ln[6:])
                first.set()
        status = resp.status
    if len(frames) < 2 or frames[-1] != "[DONE]":
        raise AssertionError("serve_paged: stream lacks [DONE]")
    return status, json.loads(frames[-2])


class _Records(logging.Handler):
    """Collects the messages of the log records it is handed."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _train_counters():
    from k8s_device_plugin_tpu_torch.ops import attention

    return (attention.FLASH_FWD, attention.FLASH_BWD_DQ,
            attention.FLASH_BWD_DKV)


def _launches_per_step(counters, steps, layers, what):
    """Each kernel's launches since its count was zeroed; fails unless
    each ran exactly once per layer per step."""
    launches = {c.name: c.launches for c in counters}
    if any(n != steps * layers for n in launches.values()):
        raise AssertionError(f"train: {what}: launches {launches}, want "
                             f"{layers} per step for {steps} steps")
    return launches


def phase_train() -> dict:
    """The trainer with a resume, the flagship benchmark, and float32
    gradients of a flagship-width step, kernels vs plain attention."""
    import dataclasses
    import math
    import re
    import shutil

    import torch

    from k8s_device_plugin_tpu_torch.models import train as trainer
    from k8s_device_plugin_tpu_torch.models import transformer

    counters = _train_counters()
    res = {"phase": "train"}

    # 1. models/train.main at the LMConfig() default: 6 steps with a
    #    checkpoint every 3, then a rerun to 8 that resumes after step 5.
    ckpt = os.path.join(HERE, "build", "train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    handler = _Records()
    records = handler.lines
    logger = logging.getLogger("tpu-train")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    layers = transformer.LMConfig().num_layers
    runs = []
    try:
        for steps, ran in ((6, 6), (8, 2)):
            for c in counters:
                c.launches = 0
            t0 = time.perf_counter()
            rc = trainer.main(["--steps", str(steps), "--batch-size", "8",
                               "--checkpoint-dir", ckpt,
                               "--checkpoint-every", "3"])
            if rc != 0:
                raise AssertionError(f"train: trainer exited {rc}")
            runs.append({"steps": steps, "ran": ran,
                         "wall_s": time.perf_counter() - t0,
                         "launches": _launches_per_step(
                             counters, ran, layers, f"trainer to {steps}")})
    finally:
        logger.removeHandler(handler)
    if "resumed from checkpoint step 5" not in records:
        raise AssertionError(f"train: no resume line in {records}")
    losses = [float(m) for line in records
              for m in re.findall(r"(?:^step \d+ loss|final loss) (\S+)",
                                  line)]
    if len(losses) < 3 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: losses {losses}")
    res["trainer"] = {"config": "LMConfig()", "batch": 8, "runs": runs,
                      "resumed_from": 5, "losses": losses,
                      "log": [m for m in records if "step" in m]}

    # 2. benchmark_train() at the flagship config.
    for c in counters:
        c.launches = 0
    bench = transformer.benchmark_train(steps=10, warmup=3)
    flagship = transformer.flagship_config()
    bench["launches"] = _launches_per_step(
        counters, 13, flagship.num_layers, "benchmark_train")
    bench["step_ms"] = 1e3 * bench["seconds"] / bench["steps"]
    bench["flops_per_step"] = transformer.train_flops_per_step(flagship, 8)
    if not bench["final_loss"] < bench["first_loss"]:
        raise AssertionError(f"train: loss did not fall: {bench}")
    res["benchmark"] = bench
    torch.cuda.empty_cache()

    # 3. float32 gradients of one flagship-width step (2 layers, batch 2),
    #    the kernels against plain attention.
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(flagship, num_layers=2, dtype=torch.float32)
    model = transformer.DecoderLM(cfg, param_dtype=torch.float32).cuda()
    transformer.init_params(model, seed=0)
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, cfg.max_seq_len),
                         generator=gen).cuda()

    def grads():
        model.zero_grad(set_to_none=True)
        loss = transformer.loss_fn(model, toks)
        loss.backward()
        return loss.item(), [p.grad.clone() for p in model.parameters()]

    loss_k, got = grads()
    with plain_attention():
        loss_p, want = grads()
    rel = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
              for a, b in zip(got, want))
    if rel > TRAIN_GRAD_TOL or abs(loss_k - loss_p) > 1e-4:
        raise AssertionError(f"train: fp32 grads kernel vs plain {rel:.3g} "
                             f"(tol {TRAIN_GRAD_TOL}), loss {loss_k} vs "
                             f"{loss_p}")
    res["fp32_grads"] = {"layers": 2, "batch": 2, "loss_kernel": loss_k,
                         "loss_plain": loss_p, "max_rel_err": rel,
                         "tol": TRAIN_GRAD_TOL}
    del model, got, want
    torch.cuda.empty_cache()
    res["ok"] = True
    return res


def phase_train_profile() -> dict:
    """torch.profiler over one flagship training step (bf16, batch 8):
    device busy time, idle share, the largest kernels, B1/B3/B4's
    share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from k8s_device_plugin_tpu_torch.models import transformer

    cfg = transformer.flagship_config()
    step, init = transformer.make_train_step(cfg, "cuda")
    model, opt = init(0)
    gen = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (8, cfg.max_seq_len),
                         generator=gen).cuda()
    step(model, opt, toks)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(model, opt, toks)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = _device_events(prof)
    busy = sum(ms for _, ms, _ in events)
    share = {}
    for key, label in (("flash_fwd", "B1"), ("bwd_dq", "B3"),
                       ("bwd_dkv", "B4")):
        ms = sum(t for k, t, _ in events if key in k)
        share[label] = {"ms": ms, "calls": sum(n for k, _, n in events
                                               if key in k),
                        "share_of_busy": ms / busy if busy else None}
    del model, opt
    torch.cuda.empty_cache()
    return {
        "phase": "train_profile", "ok": True, "config": "flagship",
        "batch": 8, "wall_ms": wall_ms, "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / wall_ms if busy else None,
        "kernels": len(events), "launches": sum(n for _, _, n in events),
        "attention": share,
        "top": [[k[:80], ms, n] for k, ms, n in events[:10]],
    }


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on "
              "the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    # Daemon forensics records go to the build directory, not the
    # committed journal.
    os.environ.setdefault("TPU_CHIP_LOG",
                          os.path.join(HERE, "build", "chip_log.jsonl"))
    from k8s_device_plugin_tpu_torch.ops import attention, paged_attention

    _jline({"phase": "env", "python": sys.version.split()[0],
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "device": torch.cuda.get_device_name(0)})
    _jline(phase_build())
    line, summary = phase_kernel()
    _jline(line)
    line, bwd_summaries = phase_kernel_bwd()
    _jline(line)
    line, paged_summary = phase_paged_kernel()
    _jline(line)
    _jline(phase_model())
    _jline(phase_profile())
    serve = phase_serve([attention.FLASH_FWD])
    _jline(serve)
    summary["launches"] = serve["launches"]["flash_fwd"]
    serve_paged = phase_serve_paged([attention.FLASH_FWD,
                                     paged_attention.PAGED_ATTN,
                                     paged_attention.PAGED_ATTN_COMBINE])
    _jline(serve_paged)
    paged_summary["launches"] = serve_paged["launches"]["paged_attn"]
    paged_summary["combine_launches"] = \
        serve_paged["launches"]["paged_attn_combine"]
    train = phase_train()
    _jline(train)
    launches = train["benchmark"]["launches"]
    summary["launches_train"] = launches["flash_fwd"]
    for s in bwd_summaries:
        s["launches"] = launches[s["name"]]
    _jline(phase_train_profile())
    print(smi_line(), flush=True)
    _jline({"kernels": [summary, *bwd_summaries, paged_summary]})
    _jline({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
