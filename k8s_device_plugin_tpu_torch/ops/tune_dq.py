"""Time B3's bfloat16 kernel (csrc/flash_bwd.cu, ``dq::``) at other key
stages and stage counts than the build's, on the card.

    python -m k8s_device_plugin_tpu_torch.ops.tune_dq

The shipped source has one plan per head dim (``dq::Build``). This
script compiles a second library from a generated file that includes
that source and instantiates ``dq::launch`` at each (head dim, keys per
stage, stages) of VARIANTS, so the variants run the shipped kernel's code
and nothing else differs. Each variant's dQ at the flagship shape
``[8, 8, 2048, d]`` bf16 causal is held against the shipped kernel's
(max |diff| / max |dQ| within 1e-2: the two sum the keys in other
groupings), then all variants and the shipped kernel are timed with CUDA
events in turns, twice. One JSON line per variant and round, after the
ptxas register / spill lines of the variant instances.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import subprocess
import sys

import torch

from k8s_device_plugin_tpu_torch.ops import _build
from k8s_device_plugin_tpu_torch.ops import attention

# (head dim, keys per K/V stage, stages)
VARIANTS = [(128, 64, 3), (128, 64, 4), (128, 64, 5),
            (64, 64, 4), (64, 128, 3), (64, 128, 4), (64, 128, 6)]
SHAPE = (8, 8, 2048)  # batch, heads (= kv heads), sequence


def _source() -> str:
    lines = [f'#include "{os.path.join(_build.CSRC, "flash_bwd.cu")}"']
    for i, (d, bk, st) in enumerate(VARIANTS):
        lines.append(
            f'extern "C" int dq_variant_{i}(const void* q, const void* k, '
            f'const void* v, const void* o, const float* lse, '
            f'const float* delta, void* dq, const int* schedule, int b, '
            f'int h, int kvh, int sq, int sk, const int* plan, float scale, '
            f'void* stream) {{ return dq::launch<{d}, {bk}, {st}, true>('
            f'q, k, v, o, lse, delta, dq, b, h, kvh, sq, sk, plan, schedule, '
            f'scale, static_cast<cudaStream_t>(stream)); }}')
    return "\n".join(lines) + "\n"


def build() -> tuple[ctypes.CDLL, str]:
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "tune_dq.cu")
    lib = os.path.join(_build.BUILD_DIR, "libtune_dq.so")
    with open(src, "w") as f:
        f.write(_source())
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib,
                           src], capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    return ctypes.CDLL(lib), proc.stdout + proc.stderr


def _plan(d, bk, stages):
    b, h, s = SHAPE
    plan = attention.flash_bwd_dq_plan(b, h, h, s, s, d, True)
    smem = (1024 + 2 * plan.block_rows * d * 2 + stages * 2 * bk * d * 2
            + (2 * stages + 1) * 8)
    return dataclasses.replace(plan, step_rows=bk, stages=stages,
                               smem_bytes=smem)


def _events_ms(fn, iters=20, warmup=3) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_dq: needs a CUDA device", file=sys.stderr)
        return 2
    lib, report = build()
    for ln in report.splitlines():
        if "bwd_dq_bf16" in ln or "registers" in ln or "spill" in ln:
            print(ln.strip())
    b, h, s = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(5)
    runs = {}
    for d in sorted({v[0] for v in VARIANTS}):
        q, k, v, g = (torch.randn(b, h, s, d, device="cuda", generator=gen)
                      .bfloat16() for _ in range(4))
        out, lse = attention.flash_forward_cuda(q, k, v, True)
        delta = attention.attention_delta(out, g)
        want = attention.flash_bwd_dq_cuda(q, k, v, g, lse, delta, True)
        shipped = attention.flash_bwd_dq_plan(b, h, h, s, s, d, True)
        runs[("shipped", d, shipped.step_rows, shipped.stages)] = (
            lambda q=q, k=k, v=v, g=g, lse=lse, delta=delta:
            attention.flash_bwd_dq_cuda(q, k, v, g, lse, delta, True))
        for i, (vd, bk, st) in enumerate(VARIANTS):
            if vd != d:
                continue
            plan = _plan(d, bk, st)
            sched = plan.schedule().cuda()
            ints = (ctypes.c_int * 5)(*plan.args)
            fn = getattr(lib, f"dq_variant_{i}")
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
                ctypes.POINTER(ctypes.c_int), ctypes.c_float,
                ctypes.c_void_p]
            dq = torch.empty_like(q)

            def run(fn=fn, dq=dq, q=q, k=k, v=v, g=g, lse=lse, delta=delta,
                    sched=sched, ints=ints, d=d, i=i):
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        dq.data_ptr(), sched.data_ptr(), b, h, h, s, s, ints,
                        d ** -0.5, torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"variant {i} launch failed ({rc})")
                return dq

            got = run()
            torch.cuda.synchronize()
            rel = ((got.float() - want.float()).abs().max()
                   / want.float().abs().max()).item()
            if not rel <= 1e-2:
                raise AssertionError(f"variant {VARIANTS[i]}: dQ off the "
                                     f"shipped kernel's by {rel:.3g}")
            runs[("variant", d, bk, st)] = run
    for rnd in range(2):
        for (kind, d, bk, st), fn in runs.items():
            print(json.dumps({"round": rnd, "kind": kind, "d": d,
                              "keys_per_stage": bk, "stages": st,
                              "shape": [b, h, s, d],
                              "ms": _events_ms(fn)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
