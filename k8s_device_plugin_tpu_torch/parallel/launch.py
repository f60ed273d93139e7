"""Start N ranks in one process group and collect what each returns.

For the tests and chip_smoke.py, which need several ranks on one
machine without a launcher: ``spawn(fn, world, *args)`` starts ``world``
processes with the ``spawn`` start method, joins them through a
``file://`` store in a temporary directory (no port, no network), runs
``fn(*args)`` in each and returns the results in rank order. Each rank
sees ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``
as under torchrun, runs one intra-op thread, and takes its backend from
``mesh.backend_for(device)``: ranks that share a card run gloo.

``fn`` must live in the port package (parallel/workers.py): a spawned
child imports the module of its target, and a test module would import
JAX, with the test harness's XLA flags, into every rank. A rank that
raises fails the call with its traceback, and the others are stopped.
``fn`` and its arguments go to the ranks through a file in the
temporary directory, not through the process arguments: a start blocks
until its child has read those, and the child reads them only after
importing torch, so large arguments would start the ranks one by one.
Each rank's result comes back pickled to bytes, tensors' data included:
through the queue's own pickler a tensor would come as shared storage
that the parent opens from the rank's process, which a rank that has
returned may already have left.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback


def _rank_main(call: str, rank: int, world: int, store: str, device: str,
               results) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    import torch
    import torch.distributed as dist

    from k8s_device_plugin_tpu_torch.parallel.mesh import init_process_group
    from k8s_device_plugin_tpu_torch.utils.device import resolve_device

    torch.set_num_threads(1)
    try:
        with open(call, "rb") as f:
            fn, args = pickle.load(f)
        init_process_group(resolve_device(device), f"file://{store}", rank,
                           world)
        results.put((rank, True, pickle.dumps(fn(*args))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, *args, device: str = "cpu",
          timeout: float = 600.0) -> list:
    """``[fn(*args) on rank r for r in range(world)]``, each rank in its
    own process on ``device`` (``cuda`` ranks take ``cuda:(rank %
    cards)``). Raises RuntimeError when a rank fails, dies or outlasts
    ``timeout`` seconds."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    out, errors = {}, []
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        store = os.path.join(tmp, "store")
        call = os.path.join(tmp, "call.pkl")
        with open(call, "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(call, r, world, store, device, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(out) + len(errors) < world:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)
                            and r not in out]
                    if dead and not errors:
                        errors.append(f"rank(s) {dead} died (exit codes "
                                      f"{[procs[r].exitcode for r in dead]})")
                    if errors or time.monotonic() > deadline:
                        break
                    continue
                if ok:
                    out[rank] = pickle.loads(value)
                else:
                    errors.append(f"rank {rank}:\n{value}")
                    break
        finally:
            for p in procs:
                p.join(timeout=30 if not errors else 1)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    if errors or len(out) < world:
        raise RuntimeError("spawned ranks failed: " + ("\n".join(errors) or
                           f"timed out after {timeout} s"))
    return [out[r] for r in range(world)]
