"""Distributed LM training with checkpoint/resume.

The counterpart of ``k8s_device_plugin_tpu/models/train.py``: the same
flags plus ``--device``, the same loop, log lines and preemption
contract, over ``transformer.make_sharded_train_step`` on the mesh of
the ranks a launcher started (parallel/mesh.py ``mesh_from_env``).

- ``--mesh-axes`` takes any axis names, factored over the world size
  as the reference factors its devices (largest innermost). ``dp``,
  ``sp``, ``tp`` and ``ep`` split the batch, the sequence, the heads
  and features, and the experts; the step replicates over any other
  axis, as the reference's does (the same batch slice on each of its
  ranks, no gradient reduction over it). ``--sp-impl`` picks ring
  attention or Ulysses for ``sp``. ``--experts N`` trains switch-MoE
  layers (models/moe.py), split over ``ep``; N must divide over it
  (logged, exit 1). Run under
  ``python -m torch.distributed.run --nproc-per-node N -m
  k8s_device_plugin_tpu_torch.models.train ...``; with no launcher it
  trains on one device. Rank 0 logs; the others log warnings only.
- Every rank draws the same global batch from ``step_tokens`` and takes
  its slice, so a sharded run sees the one-device run's data stream.
  Per-step tokens come from a ``torch.Generator`` seeded from ``(1,
  step)``, so a resumed run continues it where it stopped, as
  ``jax.random.fold_in`` does in the reference. The draws differ from
  ``jax.random``'s.
- Checkpoints are the port's own, not orbax's: under ``--checkpoint-dir``
  one directory per step holding ``state.pt`` (``{"params", "opt",
  "step"}`` via ``torch.save``, parameters and AdamW moments gathered
  whole: the one-device layout), written by rank 0 under a temporary
  name and renamed, the two newest kept. A rerun at any world size
  resumes at latest + 1, each rank restoring its slice, as orbax
  restores onto a new sharding.
- SIGTERM (armed only with a checkpoint dir) finishes the current step,
  checkpoints it and exits 0, as the reference does. The flag is reduced
  with MAX over the world every step, so a signal to any rank stops
  every rank at the same step.

Run: ``python -m k8s_device_plugin_tpu_torch.models.train --steps 100
--checkpoint-dir /ckpt`` (``--tiny --device cpu`` for a CPU smoke run).
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import signal
import sys
import threading
import time

import torch
import torch.distributed as dist

log = logging.getLogger("tpu-train")

_STATE = "state.pt"


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpu-train")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--experts", type=int, default=0,
                   help="use switch-MoE MLPs with this many experts "
                   "(shard over an 'ep' mesh axis)")
    p.add_argument("--mesh-axes", default="dp,tp",
                   help="comma list of axis names: dp, sp, tp and ep "
                   "split (sp enables sequence parallelism, ep shards "
                   "experts); the step replicates over any other")
    p.add_argument("--sp-impl", default="ring", choices=("ring", "ulysses"),
                   help="sequence-parallel attention: ring (K/V ring "
                   "stream) or ulysses (all-to-all head/seq re-shard)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' to ask "
                   "for the CPU)")
    return p


def mesh_axes(arg: str) -> tuple:
    """The axes of ``--mesh-axes``: any names, as the reference's mesh
    takes (an axis outside dp, sp, tp and ep replicates)."""
    return tuple(a.strip() for a in arg.split(",") if a.strip())


class Checkpoints:
    """The port's checkpoint directory: ``<root>/<step>/state.pt``."""

    def __init__(self, root: str, max_to_keep: int = 2):
        self.root = root
        self.max_to_keep = max_to_keep
        os.makedirs(root, exist_ok=True)

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.root):
            if name.isdigit() and os.path.exists(
                    os.path.join(self.root, name, _STATE)):
                out.append(int(name))
        return sorted(out)

    def latest_step(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict) -> None:
        """Write under a temporary name, then rename into place, so a
        crash mid-write never leaves a step that looks complete."""
        final = os.path.join(self.root, str(step))
        tmp = os.path.join(self.root, f".{step}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, _STATE))
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.root, str(old)),
                          ignore_errors=True)

    def restore(self, step: int, device) -> dict:
        return torch.load(os.path.join(self.root, str(step), _STATE),
                          map_location=device, weights_only=True)


def step_tokens(step: int, batch: int, seq: int, vocab: int) -> torch.Tensor:
    """The batch of ``step``: a generator seeded from (1, step)."""
    gen = torch.Generator().manual_seed((1 << 32) + step)
    return torch.randint(0, vocab, (batch, seq), generator=gen)


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname).1s %(name)s %(message)s")
    axes = mesh_axes(args.mesh_axes)

    from k8s_device_plugin_tpu_torch.parallel.mesh import mesh_from_env

    mesh = mesh_from_env(axes, args.device)
    try:
        return _train(args, mesh)
    finally:
        if mesh.world > 1 and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, mesh) -> int:
    from k8s_device_plugin_tpu_torch.models import transformer
    from k8s_device_plugin_tpu_torch.parallel import comm

    if mesh.rank != 0:
        log.setLevel(logging.WARNING)
    device = mesh.device
    config = transformer.LMConfig.tiny(num_experts=args.experts) \
        if args.tiny else transformer.LMConfig(num_experts=args.experts)
    log.info("training on mesh %s (%s)", mesh.shape, device)
    if args.experts and "ep" in mesh.shape:
        ep = mesh.shape["ep"]
        if args.experts % ep:
            log.error(
                "--experts %d is not divisible by the ep mesh axis (%d); "
                "expert weights cannot shard evenly", args.experts, ep,
            )
            return 1

    step_fn, init_fn = transformer.make_sharded_train_step(
        mesh, config, sp_impl=args.sp_impl)
    model, opt, _ = init_fn(0, batch=args.batch_size)

    start_step = 0
    ckptr = Checkpoints(args.checkpoint_dir) if args.checkpoint_dir else None
    if ckptr:
        latest = ckptr.latest_step()
        if latest is not None:
            transformer.load_whole_state(model, opt,
                                         ckptr.restore(latest, device))
            start_step = latest + 1
            log.info("resumed from checkpoint step %d", latest)

    # Preemption safety: finish the current step, checkpoint, and exit
    # cleanly so the restarted pod resumes at the exact step. Armed only
    # with a checkpoint dir: without one there is nothing to save.
    preempted = threading.Event()
    if ckptr:
        def _on_term(signum, frame):
            log.warning(
                "SIGTERM received: checkpointing and exiting for resume"
            )
            preempted.set()

        signal.signal(signal.SIGTERM, _on_term)

    def save(step):
        # a collective: every rank gathers, rank 0 writes
        state = transformer.whole_state(model, opt)
        if mesh.rank == 0:
            ckptr.save(step, {**state, "step": step})
        if mesh.world > 1:
            dist.barrier()
        log.info("checkpointed step %d", step)

    def stop_now() -> bool:
        """The SIGTERM flag of any rank (a MAX over the world; one rank
        reads its own, with no device round trip)."""
        if mesh.world == 1:
            return preempted.is_set()
        flag = torch.tensor([float(preempted.is_set())], device=device)
        return bool(comm.all_reduce(flag, dist.group.WORLD, op="max").item())

    t0 = time.perf_counter()
    loss = None
    for step in range(start_step, args.steps):
        tokens = step_tokens(step, args.batch_size, config.max_seq_len,
                             config.vocab_size).to(device)
        loss = step_fn(model, opt, tokens)
        if step % 10 == 0:
            log.info("step %d loss %.4f", step, float(loss))
        if ckptr and stop_now():
            save(step)
            log.info("preempted at step %d; exiting for restart", step)
            break
        if ckptr and args.checkpoint_every and \
                (step + 1) % args.checkpoint_every == 0:
            save(step)
    if loss is not None:
        wall = time.perf_counter() - t0
        steps_run = args.steps - start_step
        log.info(
            "done: %d steps in %.1fs (%.1f steps/s), final loss %.4f",
            steps_run, wall, steps_run / max(wall, 1e-9), float(loss),
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
