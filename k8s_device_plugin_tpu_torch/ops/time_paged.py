"""Time kernel B2 (csrc/paged_attn.cu) of one checkout of the port with
fixed instruments, so that two revisions are compared with the same
ones (card only).

    python k8s_device_plugin_tpu_torch/ops/time_paged.py [--root DIR]

DIR is the root of a checkout (default: this one): its package is
imported and its B2 built from its sources. The cases, their inputs and
the timers come from THIS checkout's chip_smoke.py, whatever DIR holds:
chip_smoke's PAGED_CASES are drawn in order from its seed (so each case
has the inputs chip_smoke gives it) and TIMED of them are timed through
``paged_attention_cuda`` three ways:

- ``events_ms``: CUDA events around 20 calls, the launches paced by the
  host (chip_smoke's ``cuda_ms(queued=False)``, the timer of its
  earlier revisions);
- ``queued_ms``: the same with the launches queued behind a sleep
  kernel (``cuda_ms``, chip_smoke's timer now);
- ``device_ms``: torch.profiler's device time of every kernel the calls
  launch, over 20 calls, per call (``kernels`` splits it by kernel).

Each revision gets the table and positions in the integer type its
kernel reads, so no cast is timed: int32 where the wrapper casts to it
(``_int32``, the first B2), else int64. To compare revisions, run this
once per checkout in one chip call, in the order old, new, new, old.
One JSON line per case.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

TIMED = ("decode_b4_p16_bf16", "chunk_b4_L64_p16_bf16",
         "decode_b4_1000_p16_bf16")
HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_of_this_checkout", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def profiled_ms(cs, fn, iters: int = 20) -> tuple[float, dict]:
    """Device time per call of every kernel ``fn`` launches (ms), and
    that time by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = {name: ms / iters for name, ms, _ in cs._device_events(prof)}
    return sum(kernels.values()), kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="root of the checkout whose B2 is timed")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)

    import torch

    if not torch.cuda.is_available():
        print("time_paged: no CUDA device", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    sys.path.insert(0, root)
    from k8s_device_plugin_tpu_torch.ops import paged_attention as pa

    if not os.path.abspath(pa.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {pa.__file__}, not the package "
                           f"under {root}")
    index = torch.int32 if hasattr(pa, "_int32") else torch.int64
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(5)  # chip_smoke's paged seed
    card = cs.smi_line()
    for name, b, L, h, kvh, d, page_tokens, lens, dt in cs.PAGED_CASES:
        q, kp, vp, bt, q_pos, live = cs.paged_case_inputs(
            b, L, h, kvh, d, page_tokens, lens, getattr(torch, dt), gen)
        if name not in TIMED:
            continue
        call = (q, kp, vp, bt.to(index), q_pos.to(index))

        def fn():
            return pa.paged_attention_cuda(*call)

        err = (fn().float() - pa.paged_attention_reference(*call).float()
               ).abs().max().item()
        device_ms, kernels = profiled_ms(cs, fn)
        print(json.dumps({
            "root": root, "card": card, "case": name,
            "index_dtype": str(index), "max_abs_err": err,
            "events_ms": cs.cuda_ms(fn, queued=False),
            "queued_ms": cs.cuda_ms(fn),
            "device_ms": device_ms, "kernels": kernels,
            "host_ms": cs.host_ms(fn),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
