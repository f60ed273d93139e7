#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without a result:

- ``build``: compiles every kernel source under
  k8s_device_plugin_tpu_torch/csrc/ with nvcc, all at once.
- ``kernel``: each kernel's wrapper against its plain PyTorch version on
  the card, at the serving path's shapes and edge cases, with the
  tolerances stated in KERNEL_CASES; CUDA-event times of the kernel, the
  plain version and one PyTorch library call, beside the kernel's bound.
- ``model``: DecoderLM at the serving default's full width, the kernel
  against plain attention: greedy tokens identical in float32, logits
  within atol 0.1 / rtol 0.05 in bfloat16.
- ``profile``: torch.profiler over one admission prefill and one decode
  segment at the serving default: device busy time, idle share, the
  largest kernels.
- ``serve``: the llm-serve daemon (models/serve_http.main) in-process
  on a free port at the full-width default config, bf16, rows KV,
  --max-batch 4, warmed up: concurrent completions of mixed prompt
  lengths (one streamed), /healthz, /metrics, the kernels' launch counts
  over exactly this traffic, and a clean drain.

Then the card's name and power limit (nvidia-smi), the ``{"kernels":
[...]}`` line and, last, ``{"ok": true, "device": {...}}``. Without a
CUDA device, or outside a checkout of the repository, it exits non-zero
before any phase.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
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
]
# Tolerances against the plain version on the same inputs. float32: the
# two differ only in summation order. bfloat16: the plain version rounds
# QK^T to bf16 before the softmax (as the reference's jnp code does) and
# the kernel keeps it in fp32; at unit-normal inputs that moves scaled
# scores by up to ~1e-2, and O is rounded to bf16 on output.
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _jline(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` launches (CUDA
    events around the whole run, after ``warmup`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(b, h, kvh, s, d, dtype, causal) -> float:
    """Least time for one flash forward: Q, K, V read once, O and LSE
    written once, over HBM; QK^T and PV products (2 FLOP per
    multiply-add) over the pairs this mask leaves visible, over the
    card's peak for the input type."""
    import torch

    esize = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    nbytes = esize * (2 * b * h * s * d + 2 * b * kvh * s * d) + 4 * b * h * s
    pairs = s * (s + 1) // 2 if causal else s * s
    ops = 4.0 * b * h * d * pairs
    return 1e3 * max(nbytes / HBM_BYTES_PER_S,
                     ops / PEAK_OPS_PER_S[f"torch.{dtype}"])


def phase_build() -> dict:
    from k8s_device_plugin_tpu_torch.ops import _build

    names = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                   if f.endswith(".cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(_build.compile_source, names)))
    report = {}
    for name, (_, text) in built.items():
        report[name] = [ln.strip() for ln in text.splitlines()
                        if "registers" in ln or "spill" in ln]
    return {"phase": "build", "ok": True, "kernels": names,
            "seconds": time.perf_counter() - t0, "ptxas": report}


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
        out, lse = attention.flash_forward_cuda(q, k, v, causal)
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
            "ms": cuda_ms(lambda: attention.flash_forward_cuda(
                q, k, v, causal)),
            "plain_ms": cuda_ms(
                lambda: attention.reference_attention_with_lse(
                    q, k, v, causal), iters=5),
            "library_ms": cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    q, ke, ve, is_causal=causal)),
            "bound_ms": attention_bound_ms(b, h, kvh, s, d, dt, causal),
        }
        cases.append(row)
    main = cases[0]
    summary = {
        "name": attention.FLASH_FWD.name, "route": "cuda",
        "source": attention.FLASH_FWD.source,
        "replaces": attention.FLASH_FWD.replaces,
        "max_abs_err": worst, "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": "bytes", "library_ms": main["library_ms"],
        "timed_case": main["case"],
    }
    return {"phase": "kernel", "ok": True, "cases": cases}, summary


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
    """(kernel name, device ms, calls) of every CUDA-side event."""
    import torch

    out = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out.append((e.key, us / 1e3, e.count))
    return sorted(out, key=lambda x: -x[1])


def phase_profile() -> dict:
    """Device time of one admission prefill ([4 rows, 1024 tokens]) and
    one 16-token decode segment over 4 rows at the serving default
    (bf16), under torch.profiler: busy time, idle share of the wall
    time, the largest kernels and the flash kernel's share."""
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

    decode()
    torch.cuda.synchronize()
    res = {"phase": "profile", "rows": rows, "prompt_tokens": lb,
           "segment": seg}
    for name, fn in (("prefill", prefill), ("decode_segment", decode)):
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
        res[name] = {
            "wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms if busy else None,
            "flash_fwd_ms": flash, "kernels": len(events),
            "launches": sum(n for _, _, n in events),
            "top": [[k[:80], ms, n] for k, ms, n in events[:6]],
        }
    res["ok"] = True
    del srv, pool
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
    from k8s_device_plugin_tpu_torch.ops import attention

    _jline({"phase": "env", "python": sys.version.split()[0],
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "device": torch.cuda.get_device_name(0)})
    _jline(phase_build())
    line, summary = phase_kernel()
    _jline(line)
    _jline(phase_model())
    _jline(phase_profile())
    serve = phase_serve([attention.FLASH_FWD])
    _jline(serve)
    summary["launches"] = serve["launches"]["flash_fwd"]
    print(smi_line(), flush=True)
    _jline({"kernels": [summary]})
    _jline({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
