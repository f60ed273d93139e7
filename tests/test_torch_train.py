"""The port's training path against the JAX reference's.

``loss_fn`` and every gradient (mapped into the flax layout with
``params_to_jax``) against ``jax.value_and_grad(loss_fn)`` at three
configs (the reference's tiny one, a Llama-class and a GPT-2-class one),
fused and chunked; one AdamW update against ``optax.adamw``; three whole
train steps against the reference's step; the FLOP formula; the
benchmark's keys; and the trainer CLI's checkpoint, resume and SIGTERM
contract (mirroring tests/test_train.py). Parameters come from the
reference's jitted init, tokens from numpy with a seed; JAX runs on the
CPU, where its flash_attention is the plain jnp version.

Tolerances: float32 loss 1e-5 and gradients atol/rtol 1e-4 (the two
frameworks sum in other orders); bfloat16 loss 2e-2 (they round at other
places, e.g. flax sums repeated tokens' embedding gradients in bf16).
AdamW alone 1e-6. Parameters after three steps atol 1e-3, about 3 * lr:
at step 1 Adam moves each weight by ~lr * sign(g), and a gradient at
noise level may flip sign between the frameworks.
"""

import dataclasses
import functools
import logging
import os
import re
import signal
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_device_plugin_tpu.models import transformer as jt
from k8s_device_plugin_tpu_torch.models import train as ttrain
from k8s_device_plugin_tpu_torch.models import transformer as tt
from k8s_device_plugin_tpu_torch.models.params import (
    params_from_jax,
    params_to_jax,
)

_SMALL = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=32,
              mlp_dim=64, max_seq_len=64)
CONFIGS = {
    "tiny": {},
    "llama": dict(_SMALL, position="rope", num_kv_heads=2,
                  mlp_act="swiglu", qkv_bias=True),
    "gpt2": dict(_SMALL, norm="layernorm", use_bias=True,
                 tie_embeddings=True, norm_eps=1e-5),
}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _pair(name, dtype):
    """(jax config, port config, flax params as numpy), built once."""
    jd, td = DTYPES[dtype]
    kw = CONFIGS[name]
    if kw:
        cj, ct = jt.LMConfig(**kw, dtype=jd), tt.LMConfig(**kw, dtype=td)
    else:
        cj = dataclasses.replace(jt.LMConfig.tiny(), dtype=jd)
        ct = dataclasses.replace(tt.LMConfig.tiny(), dtype=td)
    params = jax.jit(lambda rng: jt.DecoderLM(cj).init(
        rng, jnp.zeros((1, 8), jnp.int32))["params"])(jax.random.PRNGKey(0))
    return cj, ct, jax.tree_util.tree_map(np.asarray, params)


def _model(ct, tree):
    """A fresh port model in the training layout holding ``tree``."""
    model = tt.DecoderLM(ct, param_dtype=torch.float32)
    model.load_state_dict(params_from_jax(tree, ct, torch.float32))
    return model


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(cj, loss_chunks):
    return jax.jit(jax.value_and_grad(functools.partial(
        jt.loss_fn, config=cj, loss_chunks=loss_chunks)))


def _tokens(ct, seed=0, shape=(2, 16)):
    return np.random.default_rng(seed).integers(0, ct.vocab_size, shape)


def _assert_trees_close(got, want, **tol):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), **tol,
                                   err_msg=jax.tree_util.keystr(path))


def test_training_layout_has_float32_params_with_grads():
    """flax's layout: every parameter float32 and trainable; the serving
    layout keeps weights in cfg.dtype without gradients."""
    _, ct, tree = _pair("tiny", "bfloat16")
    train = _model(ct, tree)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in train.parameters())
    serve = tt.DecoderLM(ct)
    assert serve.embed.dtype == torch.bfloat16
    assert not any(p.requires_grad for p in serve.parameters())


@pytest.mark.parametrize("loss_chunks", [0, 1, 4])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_grads_match_jax(name, loss_chunks):
    cj, ct, tree = _pair(name, "float32")
    toks = _tokens(ct)
    want_loss, want_grads = _jax_value_and_grad(cj, loss_chunks)(
        tree, jnp.asarray(toks))
    model = _model(ct, tree)
    loss = tt.loss_fn(model, torch.from_numpy(toks), loss_chunks)
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    grads = params_to_jax({n: p.grad for n, p in model.named_parameters()},
                          ct)
    _assert_trees_close(grads, want_grads, **GRAD_TOL)


@pytest.mark.parametrize("loss_chunks", [0, 4])
def test_bf16_loss_matches_jax(loss_chunks):
    """bf16 compute with float32 parameters: RMSNorm returns float32, the
    fused head casts to bf16 inside Dense, the chunked head computes
    float32 features @ a bf16-rounded kernel in float32 (jnp
    promotion)."""
    cj, ct, tree = _pair("tiny", "bfloat16")
    toks = _tokens(ct, seed=1)
    want = _jax_value_and_grad(cj, loss_chunks)(tree, jnp.asarray(toks))[0]
    with torch.no_grad():
        got = tt.loss_fn(_model(ct, tree), torch.from_numpy(toks),
                         loss_chunks)
    assert abs(got.item() - float(want)) <= 2e-2


def test_chunked_loss_rejects_bad_chunking():
    _, ct, tree = _pair("tiny", "float32")
    toks = torch.zeros((2, 24), dtype=torch.long)
    with pytest.raises(ValueError, match="not divisible"):
        tt.loss_fn(_model(ct, tree), toks, loss_chunks=7)
    with pytest.raises(ValueError, match="not divisible"):
        tt.chunked_lm_loss(torch.zeros(2, 24, 8), torch.zeros(8, 16),
                           toks, torch.ones(2, 24), 5)


def test_adamw_update_matches_optax():
    """Three updates of the port's default optimizer against
    optax.adamw(3e-4) on the same params and gradients, one of them at
    noise level."""
    rng = np.random.default_rng(2)
    params = {"a": rng.standard_normal((8, 16), dtype=np.float32),
              "b": rng.standard_normal((16,), dtype=np.float32)}
    grads = [{n: rng.standard_normal(p.shape, dtype=np.float32)
              * (1e-9 if n == "b" and i == 0 else 1.0)
              for n, p in params.items()} for i in range(3)]
    opt = optax.adamw(3e-4)
    jp = {n: jnp.asarray(p) for n, p in params.items()}
    state = opt.init(jp)
    tp = {n: torch.nn.Parameter(torch.from_numpy(p.copy()))
          for n, p in params.items()}
    topt = tt.default_optimizer(list(tp.values()))
    for g in grads:
        upd, state = opt.update({n: jnp.asarray(x) for n, x in g.items()},
                                state, jp)
        jp = optax.apply_updates(jp, upd)
        for n, p in tp.items():
            p.grad = torch.from_numpy(g[n])
        topt.step()
        for n in params:
            np.testing.assert_allclose(tp[n].detach().numpy(),
                                       np.asarray(jp[n]), atol=1e-6,
                                       rtol=1e-6)


@pytest.mark.parametrize("name", ["tiny", "llama"])
def test_three_train_steps_match_jax(name):
    cj, ct, tree = _pair(name, "float32")
    opt = optax.adamw(3e-4)
    loss = functools.partial(jt.loss_fn, config=cj)

    @jax.jit
    def jstep(params, opt_state, tokens):
        l, grads = jax.value_and_grad(loss)(params, tokens)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, l

    step, _ = tt.make_train_step(ct, "cpu")
    model = _model(ct, tree)
    topt = tt.default_optimizer(model.parameters())
    jp, state = tree, opt.init(tree)
    for i in range(3):
        toks = _tokens(ct, seed=10 + i)
        jp, state, want = jstep(jp, state, jnp.asarray(toks))
        got = step(model, topt, torch.from_numpy(toks))
        assert abs(got.item() - float(want)) <= 1e-4
    _assert_trees_close(params_to_jax(model.state_dict(), ct), jp,
                        atol=1e-3, rtol=0)


def test_params_round_trip_through_both_layouts():
    _, ct, tree = _pair("llama", "float32")
    back = params_to_jax(params_from_jax(tree, ct), ct)
    _assert_trees_close(back, tree, atol=0, rtol=0)


@pytest.mark.parametrize("kw", [
    dict(vocab_size=256, num_layers=2, num_heads=4, embed_dim=64,
         mlp_dim=128, max_seq_len=128),
    dict(vocab_size=32000, num_layers=8, num_heads=8, embed_dim=1024,
         mlp_dim=4096, max_seq_len=2048),
    dict(vocab_size=1000, num_layers=2, num_heads=2, embed_dim=256,
         mlp_dim=512, max_seq_len=256),
    dict(_SMALL, num_kv_heads=2, mlp_act="swiglu", position="rope"),
])
def test_train_flops_per_step_equals_reference(kw):
    assert tt.train_flops_per_step(tt.LMConfig(**kw), 8) == \
        jt.train_flops_per_step(jt.LMConfig(**kw), 8)


def test_flagship_and_smoke_configs_are_the_references():
    assert tt.flagship_config() == tt.LMConfig(
        vocab_size=32000, num_layers=8, num_heads=8, embed_dim=1024,
        mlp_dim=4096, max_seq_len=2048)
    assert tt.flagship_config().head_dim == 128
    assert tt.smoke_config().head_dim == 128


REFERENCE_KEYS = {"backend", "batch", "seq", "steps", "seconds",
                  "tokens_per_second", "tflops_per_second", "mfu",
                  "final_loss"}


def test_benchmark_train_returns_the_reference_keys():
    res = tt.benchmark_train(tt.smoke_config(), batch=2, steps=2, warmup=1,
                             device="cpu")
    assert REFERENCE_KEYS <= set(res)
    assert res["backend"] == "cpu" and res["device_name"] == "cpu"
    assert res["seq"] == 256 and res["steps"] == 2
    assert np.isfinite(res["final_loss"]) and res["mfu"] > 0


def test_benchmark_cli_prints_json(capsys):
    import json

    assert tt.main(["--smoke", "--batch", "1", "--steps", "1", "--json",
                    "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert REFERENCE_KEYS <= set(res)


def test_trainer_without_device_raises_here():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--tiny", "--steps", "1"])


@pytest.mark.parametrize("argv", [["--mesh-axes", "dp,sp"],
                                  ["--mesh-axes", "ep"],
                                  ["--experts", "2", "--mesh-axes", "dp,ep"]])
def test_trainer_refuses_what_waits_for_a8(argv, caplog):
    """What waited for A8 now trains: without a launcher the world is one
    rank, so sp and ep are axes of size 1 (several ranks:
    tests/test_torch_sharded_train.py). An axis outside dp, sp, tp and
    ep is refused no more: the mesh takes any names, as the reference's
    does, and the step replicates over such an axis."""
    caplog.set_level(logging.INFO, logger="tpu-train")
    assert ttrain.main(["--tiny", "--device", "cpu", "--steps", "1",
                        *argv]) == 0
    shape = {a: 1 for a in argv[argv.index("--mesh-axes") + 1].split(",")}
    assert f"training on mesh {shape} (cpu)" in caplog.text
    caplog.clear()
    assert ttrain.main(["--tiny", "--device", "cpu", "--steps", "1",
                        "--mesh-axes", "dp,xp"]) == 0
    assert "training on mesh {'dp': 1, 'xp': 1} (cpu)" in caplog.text


def test_step_replicates_over_an_axis_it_does_not_use():
    """Two gloo ranks on ``("dp", "xp")`` (1 x 2): each takes the whole
    batch and reduces no gradient over xp, so the loss and gradients on
    every rank are the one-device step's (a double-counted xp would
    double them)."""
    from k8s_device_plugin_tpu_torch.parallel import launch, workers

    cfg = dict(_SMALL, dtype="float32")
    tokens = np.random.default_rng(5).integers(
        0, cfg["vocab_size"], (4, cfg["max_seq_len"]))
    case = dict(name="dp_xp", axes=("dp", "xp"), shape=(1, 2), config=cfg,
                tokens=tokens)
    ranks = launch.spawn(workers.train_step, 2, [case], timeout=300)
    ct = tt.LMConfig(**dict(_SMALL, dtype=torch.float32))
    step, init = tt.make_train_step(ct, "cpu")
    model, opt = init(0)
    want = float(step(model, opt, torch.as_tensor(tokens)))
    for r in ranks:
        assert r["dp_xp"]["coords"]["xp"] in (0, 1)
        assert abs(r["dp_xp"]["loss"] - want) < 1e-5
    got = ranks[0]["dp_xp"]["grads"]
    for n, p in model.named_parameters():
        np.testing.assert_allclose(got[n], p.grad.numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=n)


def test_train_checkpoint_and_resume(tmp_path, caplog):
    ckpt = str(tmp_path / "ckpt")
    args = ["--tiny", "--device", "cpu", "--steps", "6", "--batch-size", "4",
            "--checkpoint-dir", ckpt, "--checkpoint-every", "3",
            "--mesh-axes", "dp,tp"]
    caplog.set_level(logging.INFO, logger="tpu-train")
    assert ttrain.main(args) == 0
    assert any("checkpointed step" in r.getMessage() for r in caplog.records)
    assert sorted(os.listdir(ckpt)) == ["2", "5"]
    caplog.clear()

    # second invocation resumes from the saved step instead of restarting
    assert ttrain.main(args + ["--steps", "8"]) == 0
    resumed = [r for r in caplog.records
               if "resumed from checkpoint" in r.getMessage()]
    assert resumed, "expected resume log line"
    assert re.search(r"resumed from checkpoint step 5",
                     resumed[0].getMessage())
    assert any(r.getMessage().startswith("done: 2 steps")
               for r in caplog.records)


def test_checkpoints_keep_the_two_newest(tmp_path):
    ck = ttrain.Checkpoints(str(tmp_path))
    for step in (1, 4, 9):
        ck.save(step, {"step": step})
    assert ck.steps() == [4, 9] and ck.latest_step() == 9
    assert ck.restore(9, "cpu")["step"] == 9
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".")]


def test_resumed_data_stream_continues():
    """Step n's batch depends only on n, so a resumed run sees what an
    uninterrupted one would."""
    a = ttrain.step_tokens(7, 2, 16, 256)
    assert torch.equal(a, ttrain.step_tokens(7, 2, 16, 256))
    assert not torch.equal(a, ttrain.step_tokens(8, 2, 16, 256))


def test_preemption_checkpoints_and_resumes(tmp_path):
    """SIGTERM mid-run must checkpoint the in-flight step and a rerun must
    resume from it (the GKE node-drain / spot-reclaim contract)."""
    ckpt = str(tmp_path / "ckpt")
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))}
    code = (
        "from k8s_device_plugin_tpu_torch.models import train\n"
        f"raise SystemExit(train.main(['--tiny', '--device', 'cpu', "
        f"'--steps', '10000', '--checkpoint-dir', {ckpt!r}, "
        f"'--checkpoint-every', '0']))\n"
    )
    proc = subprocess.Popen(
        [sys.executable, "-c", code], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    lines = []
    saw_step = threading.Event()

    def _reader():
        for line in proc.stdout:
            lines.append(line)
            if "step 10 " in line or "step 20 " in line:
                saw_step.set()

    t = threading.Thread(target=_reader, daemon=True)
    t.start()
    if not saw_step.wait(timeout=120):
        proc.kill()
        raise AssertionError("never reached step 10:\n" + "".join(lines))
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=120)
    t.join(timeout=30)
    out = "".join(lines)
    assert rc == 0, out
    m = re.search(r"preempted at step (\d+)", out)
    assert m, out
    step = int(m.group(1))
    assert re.search(rf"checkpointed step {step}\b", out), out

    code2 = code.replace("'--steps', '10000'", f"'--steps', '{step + 3}'")
    out2 = subprocess.run(
        [sys.executable, "-c", code2], env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert out2.returncode == 0, out2.stdout + out2.stderr
    assert f"resumed from checkpoint step {step}" in (
        out2.stdout + out2.stderr
    ), out2.stdout + out2.stderr
