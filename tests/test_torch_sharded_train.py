"""The port's sharded training step and trainer against the reference's.

- One ``make_sharded_train_step`` step at world 8 on ``dp2 x tp4``,
  ``dp2 x sp2 x tp2`` (ring), ``dp2 x sp4`` (Ulysses), and at a
  Llama-class config (RoPE, GQA with 2 kv heads, SwiGLU, q/k/v biases)
  on ``sp4 x tp2`` (ring: RoPE at each block's global positions, kv
  heads split) and ``dp2 x tp4`` (kv heads fewer than tp: K/V whole on
  every rank); at world 4 on ``dp2 x ep2`` with 4 experts. The port's
  ranks are gloo processes on the CPU (parallel/launch.py, one spawn per
  world size for the whole file). The loss and the gathered updated
  parameters equal the reference's ``make_sharded_train_step`` on the
  same mesh of virtual devices, weights (the reference's init, through
  ``params_from_jax``) and tokens (numpy, seeded); the gathered
  gradients equal ``jax.grad`` of the reference's loss; and all three
  equal the port's one-device ``make_train_step``.
- The trainer (``models/train.py``) at world 4 under ``python -m
  torch.distributed.run`` with ``--mesh-axes dp,sp,tp --tiny --device
  cpu`` logs the one-device run's losses; its checkpoint resumes at
  world 1 at latest + 1 with the one-device run's loss, and that one
  resumes at world 4; a SIGTERM to one rank of four stops every rank at
  one common step, checkpointed, all exiting 0.

Tolerances. float32 steps: loss 1e-5; gradients atol/rtol 1e-4 (the
two frameworks sum in other orders, tests/test_torch_train.py); the
updated parameters atol 1e-3, about 3 * lr (Adam's first step moves a
weight by ~lr * sign(g), and a gradient at noise level may flip sign
between frameworks); against the port's own one-device step, 1e-5 and
1e-4. The trainer runs bfloat16 (the tiny config's dtype): losses
within 2e-3 of the one-device run's (the ranks round partial sums at
other places: 6e-4 apart at world 4), well inside what a 4-rank run that
never stepped its optimizer (1.8e-2 off) or a resume that restored
nothing (3.3e-2 off) would log; a test holds those two controls outside
the tolerance.
"""

import concurrent.futures
import functools
import logging
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_device_plugin_tpu.models import transformer as jt
from k8s_device_plugin_tpu.parallel import mesh as jmesh
from k8s_device_plugin_tpu.parallel.sharding import (
    batch_sharding as j_batch_sharding,
)
from k8s_device_plugin_tpu.parallel.sharding import (
    shard_params_for_tp as j_shard_params,
)
from k8s_device_plugin_tpu_torch.models import train as ttrain
from k8s_device_plugin_tpu_torch.models import transformer as tt
from k8s_device_plugin_tpu_torch.models.params import (
    params_from_jax,
    params_to_jax,
)
from k8s_device_plugin_tpu_torch.parallel import launch, workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-5
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
PARAM_TOL = dict(atol=1e-3, rtol=0)
SELF_GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
TRAINER_LOSS_TOL = 2e-3

BATCH = 4
CONFIGS = {
    "tiny": dict(vocab_size=256, num_layers=2, num_heads=4, embed_dim=64,
                 mlp_dim=128, max_seq_len=128),
    "llama": dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=32,
                  mlp_dim=64, max_seq_len=64, position="rope",
                  num_kv_heads=2, mlp_act="swiglu", qkv_bias=True),
    "moe": dict(vocab_size=256, num_layers=2, num_heads=4, embed_dim=64,
                mlp_dim=128, max_seq_len=128, num_experts=4),
}
# name: (config, axes, shape, sp_impl)
STEPS_8 = {
    "dp2_tp4": ("tiny", ("dp", "tp"), (2, 4), "ring"),
    "dp2_sp2_tp2_ring": ("tiny", ("dp", "sp", "tp"), (2, 2, 2), "ring"),
    "dp2_sp4_ulysses": ("tiny", ("dp", "sp"), (2, 4), "ulysses"),
    "llama_sp4_tp2_ring": ("llama", ("dp", "sp", "tp"), (1, 4, 2), "ring"),
    "llama_dp2_tp4": ("llama", ("dp", "tp"), (2, 4), "ring"),
}
STEPS_4 = {"moe_dp2_ep2": ("moe", ("dp", "ep"), (2, 2), "ring")}
STEPS = {**STEPS_8, **STEPS_4}


@functools.lru_cache(maxsize=None)
def _weights(name):
    """(jax config, port config, the reference's init as numpy, tokens)."""
    kw = dict(CONFIGS[name], dtype=jnp.float32)
    cj = jt.LMConfig(**kw)
    ct = tt.LMConfig(**dict(kw, dtype=torch.float32))
    params = jax.jit(lambda rng: jt.DecoderLM(cj).init(
        rng, jnp.zeros((1, 8), jnp.int32))["params"])(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    tokens = np.random.default_rng(11).integers(
        0, cj.vocab_size, (BATCH, cj.max_seq_len)).astype(np.int32)
    return cj, ct, tree, tokens


def _case(name):
    cfg, axes, shape, sp_impl = STEPS[name]
    _, ct, tree, tokens = _weights(cfg)
    state = params_from_jax(tree, ct, torch.float32)
    return dict(name=name, axes=axes, shape=shape, sp_impl=sp_impl,
                config=dict(CONFIGS[cfg], dtype="float32"), tokens=tokens,
                params={n: t.numpy() for n, t in state.items()})


@pytest.fixture(scope="module")
def ranks():
    """The port's ranks: one spawn of 8 for STEPS_8, then one of 4 for
    STEPS_4, in the background while the reference computes."""
    cases8 = [_case(n) for n in STEPS_8]
    cases4 = [_case(n) for n in STEPS_4]

    def run():
        out = launch.spawn(workers.train_step, 8, cases8, timeout=600)[0]
        out.update(launch.spawn(workers.train_step, 4, cases4,
                                timeout=600)[0])
        return out

    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(run)
    yield future
    pool.shutdown(wait=True)


def _reference_step(name):
    """The reference's sharded step on the same mesh of virtual devices
    (loss and updated parameters) and jax.grad of its loss."""
    cfg, axes, shape, sp_impl = STEPS[name]
    cj, _, tree, tokens = _weights(cfg)
    world = int(np.prod(shape))
    mesh = jmesh.build_mesh(axes, shape, devices=jax.devices()[:world])
    step, _ = jt.make_sharded_train_step(mesh, cj, sp_impl=sp_impl)
    params = jax.device_put(tree, j_shard_params(mesh, tree))
    opt_state = optax.adamw(3e-4).init(params)
    toks = jax.device_put(jnp.asarray(tokens),
                          j_batch_sharding(mesh, seq_axis="sp" in axes))
    new_params, _, loss = step(params, opt_state, toks)
    grads = jax.jit(jax.grad(functools.partial(jt.loss_fn, config=cj)))(
        tree, jnp.asarray(tokens))
    return (float(loss), jax.tree_util.tree_map(np.asarray, new_params),
            jax.tree_util.tree_map(np.asarray, grads))


def _one_device_step(name):
    """The port's make_train_step from the same weights and tokens."""
    cfg = STEPS[name][0]
    _, ct, tree, tokens = _weights(cfg)
    step, init = tt.make_train_step(ct, "cpu")
    model, opt = init(0)
    model.load_state_dict(params_from_jax(tree, ct, torch.float32))
    loss = float(step(model, opt, torch.as_tensor(tokens).long()))
    return loss, {n: p.grad.clone() for n, p in model.named_parameters()}


def _tensors(arrays):
    return {n: torch.from_numpy(a) for n, a in arrays.items()}


def _assert_trees_close(got, want, what, **tol):
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        np.testing.assert_allclose(flat_got[path], w, err_msg=f"{what} "
                                   f"{jax.tree_util.keystr(path)}", **tol)


@pytest.mark.parametrize("name", list(STEPS))
def test_sharded_step_equals_the_references(name, ranks):
    cfg = STEPS[name][0]
    _, ct, _, _ = _weights(cfg)
    want_loss, want_params, want_grads = _reference_step(name)
    got = ranks.result()[name]
    assert abs(got["loss"] - want_loss) < LOSS_TOL
    _assert_trees_close(params_to_jax(_tensors(got["grads"]), ct),
                        want_grads, "grad", **GRAD_TOL)
    _assert_trees_close(params_to_jax(_tensors(got["params"]), ct),
                        want_params, "param", **PARAM_TOL)


@pytest.mark.parametrize("name", list(STEPS))
def test_sharded_step_equals_the_one_device_step(name, ranks):
    loss, grads = _one_device_step(name)
    got = ranks.result()[name]
    assert abs(got["loss"] - loss) < LOSS_TOL
    assert set(got["grads"]) == set(grads)
    for n, g in grads.items():
        np.testing.assert_allclose(got["grads"][n], g.numpy(), err_msg=n,
                                   **SELF_GRAD_TOL)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

TRAINER = ["-m", "k8s_device_plugin_tpu_torch.models.train", "--tiny",
           "--device", "cpu", "--batch-size", "4", "--mesh-axes", "dp,sp,tp"]


def _env():
    return {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}


def _losses(text):
    """{step: loss} from the trainer's log, "final" for the last."""
    out = {int(s): float(v) for s, v in
           re.findall(r"step (\d+) loss (\S+)", text)}
    final = re.findall(r"final loss (\S+)", text)
    if final:
        out["final"] = float(final[-1])
    return out


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _in_process(argv):
    """(log lines, exit code) of the trainer run in this process."""
    handler = _Lines()
    logger = logging.getLogger("tpu-train")
    logger.addHandler(handler)
    level = logger.level
    logger.setLevel(logging.INFO)
    try:
        rc = ttrain.main(argv)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    return handler.lines, rc


def _one_device_losses(steps):
    lines, rc = _in_process(TRAINER[2:] + ["--steps", str(steps)])
    assert rc == 0
    return _losses("\n".join(lines))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_ranks(world, argv):
    """``world`` trainer processes joined over 127.0.0.1 (the env://
    rendezvous torchrun would set up)."""
    port = str(_free_port())
    procs = []
    for rank in range(world):
        env = dict(_env(), RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, *argv], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """The chain on one checkpoint directory: 3 steps at world 4 under
    torchrun (checkpoint at step 2), 5 at world 1 (resumes at 3,
    checkpoint at step 4), then world 4 again until a SIGTERM to rank 2.
    """
    ckpt = str(tmp_path_factory.mktemp("sharded") / "ckpt")
    runs = {}
    four = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", *TRAINER, "--steps", "3",
         "--checkpoint-dir", ckpt, "--checkpoint-every", "3"],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=REPO)
    runs["world4"] = (four.returncode, four.stdout + four.stderr,
                      sorted(os.listdir(ckpt), key=int))
    lines, rc = _in_process(TRAINER[2:] + ["--steps", "5", "--checkpoint-dir",
                                           ckpt, "--checkpoint-every", "5"])
    runs["world1"] = (rc, "\n".join(lines),
                      sorted(os.listdir(ckpt), key=int))

    procs = _start_ranks(4, TRAINER + ["--steps", "100000",
                                       "--checkpoint-dir", ckpt,
                                       "--checkpoint-every", "0"])
    outs = [[] for _ in procs]
    going = threading.Event()

    def read(i, proc):
        for line in proc.stdout:
            outs[i].append(line)
            if i == 0 and re.search(r"step \d+ loss", line) and \
                    "step 5 " not in line:
                going.set()

    readers = [threading.Thread(target=read, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    for t in readers:
        t.start()
    try:
        if not going.wait(timeout=180):
            raise AssertionError("world 4 never logged a step:\n" +
                                 "".join(outs[0]))
        time.sleep(0.5)
        procs[2].send_signal(signal.SIGTERM)
        codes = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for t in readers:
        t.join(timeout=30)
    runs["sigterm"] = (codes, ["".join(o) for o in outs],
                       sorted(os.listdir(ckpt), key=int))
    runs["dir"] = ckpt
    return runs


def test_trainer_at_world_4_logs_the_one_device_losses(trainer_runs):
    rc, out, steps = trainer_runs["world4"]
    assert rc == 0, out
    assert "training on mesh {'dp': 1, 'sp': 2, 'tp': 2}" in out
    assert "backend gloo (ranks on the CPU)" in out
    assert steps == ["2"]
    want = _one_device_losses(3)
    got = _losses(out)
    assert set(got) == set(want) == {0, "final"}
    for k in want:
        assert abs(got[k] - want[k]) < TRAINER_LOSS_TOL, (k, got, want)


def test_world_4_checkpoint_resumes_at_world_1(trainer_runs):
    rc, out, steps = trainer_runs["world1"]
    assert rc == 0, out
    assert "resumed from checkpoint step 2" in out
    assert "done: 2 steps" in out
    assert steps == ["2", "4"]
    want = _one_device_losses(5)["final"]
    assert abs(_losses(out)["final"] - want) < TRAINER_LOSS_TOL


def test_sigterm_to_one_rank_checkpoints_one_common_step(trainer_runs):
    codes, outs, steps = trainer_runs["sigterm"]
    assert codes == [0, 0, 0, 0], outs
    assert "resumed from checkpoint step 4" in outs[0]
    assert "SIGTERM received" in outs[2]
    m = re.search(r"preempted at step (\d+)", outs[0])
    assert m, outs[0]
    step = int(m.group(1))
    assert re.search(rf"checkpointed step {step}\b", outs[0])
    assert steps[-1] == str(step) and step > 4


def test_the_world_4_checkpoint_is_the_one_device_layout(trainer_runs):
    """What rank 0 wrote at world 4 loads as it is into a one-device
    model and its optimizer."""
    _, _, steps = trainer_runs["sigterm"]
    state = ttrain.Checkpoints(trainer_runs["dir"]).restore(int(steps[-1]),
                                                            "cpu")
    model = tt.DecoderLM(tt.LMConfig.tiny(), param_dtype=torch.float32)
    opt = tt.default_optimizer(model.parameters())
    model.load_state_dict(state["params"])
    opt.load_state_dict(state["opt"])
    assert len(opt.state_dict()["state"]) == len(list(model.parameters()))


def test_the_trainer_tolerance_sees_a_missed_step_or_restore():
    """The losses the trainer checks would read at two faults lie outside
    TRAINER_LOSS_TOL: the step-2 loss at the initial weights (a 4-rank
    run whose optimizer never stepped) and the step-4 loss after steps 3
    and 4 from the initial weights (a resume that restored nothing)."""
    cfg = tt.LMConfig.tiny()
    step, init = tt.make_train_step(cfg, "cpu")
    model, opt = init(0)

    def tokens(s):
        return ttrain.step_tokens(s, 4, cfg.max_seq_len, cfg.vocab_size)

    with torch.no_grad():
        no_step = float(tt.loss_fn(model, tokens(2)))
    for s in (3, 4):
        fresh = float(step(model, opt, tokens(s)))
    assert abs(no_step - _one_device_losses(3)["final"]) > TRAINER_LOSS_TOL
    assert abs(fresh - _one_device_losses(5)["final"]) > TRAINER_LOSS_TOL
