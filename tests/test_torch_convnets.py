"""The port's MobileNetV2 and InceptionV3 against the JAX reference, on
the CPU (ResNet: tests/test_torch_resnet.py).

Weights and running statistics are drawn with numpy from a seed in the
reference's tree layout (its ``init`` shapes, through ``jax.eval_shape``)
and carried over by ``params_from_flax``. Tolerances are relative to
each tensor's largest magnitude.

- MobileNetV2 ``tiny_model()`` (width 0.25, two block groups, 10
  classes) at 32x32, batch 4, float32: train-mode logits and the
  ``batch_stats`` that come back, eval-mode logits, within 1e-4; two
  Nesterov SGD steps through the reference's ``make_train_step`` in
  float64 on both sides (each loss, every parameter and statistic within
  1e-5); ``_round_channels`` equal to the reference's over a range.
- InceptionV3 at 75x75, batch 2, 10 classes: eval-mode logits in float32
  within 1e-4; train-mode logits and statistics in float64 within 1e-5;
  2048 channels into ``Dense_0``. At this size the D and E blocks see
  1x1 maps, so each train-mode BatchNorm normalises two numbers and
  multiplies the rounding of what comes in by up to 1/sqrt(eps) ~ 32:
  the reference's own eager and jitted float32 forwards differ by 1.3e-2
  there, so float32 could not tell a fault from rounding. The full train
  step's parity is compile-heavy (as the reference's own test says) and
  marked ``slow``.
- A fresh port init has the reference tree's shapes leaf for leaf;
  MobileNetV2's ``main(... --json)`` prints the reference's keys, and
  InceptionV3's passes its flags to ``benchmark``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_device_plugin_tpu.models import inception as jinc
from k8s_device_plugin_tpu.models import mobilenet as jmob
from k8s_device_plugin_tpu_torch.models import inception as tinc
from k8s_device_plugin_tpu_torch.models import mobilenet as tmob

TOL = 1e-4
TOL64 = 1e-5
REFERENCE_KEYS = ["backend", "model", "batch_size", "steps", "seconds",
                  "images_per_second", "final_loss"]
TINY_BLOCKS = ((1, 16, 1, 1), (6, 24, 2, 2))


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _max_rel(got, want) -> float:
    errors = jax.tree_util.tree_map(_rel, got, jax.tree_util.tree_map(
        np.asarray, dict(want)))
    return max(jax.tree_util.tree_leaves(errors))


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), dict(tree))


def _random_variables(model, size, seed):
    """Numpy ``{"params", "batch_stats"}`` in the reference's layout:
    kernels scaled by 1/sqrt(fan_in), BatchNorm scales near 1, biases
    and running means near 0, running variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path[-1:])
        if "var" in name:
            a = rng.uniform(0.5, 1.5, s.shape)
        elif "scale" in name:
            a = 1 + 0.1 * rng.standard_normal(s.shape)
        elif "mean" in name or "bias" in name:
            a = 0.1 * rng.standard_normal(s.shape)
        else:
            a = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, dict(shapes))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _load(port, variables, dtype):
    """``port`` (built in ``dtype``) holding ``variables``."""
    port.load_state_dict(tmob.params_from_flax(variables), strict=True)
    return port.to(dtype)


def _batch(size, batch, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
    return x, rng.integers(0, 10, batch)


def _train_mode(jmodel, port, variables, x, tol):
    """Train-mode logits and the statistics that come back."""
    want, mutated = jmodel.apply(variables, x, mutable=["batch_stats"])
    got = port(_nchw(x).to(port.dtype), train=True).detach()
    assert _rel(got, want) < tol
    stats = tmob.params_to_flax(port.state_dict())["batch_stats"]
    assert _max_rel(stats, mutated["batch_stats"]) < tol
    # the statistics moved: the comparison is not of the inputs
    assert _max_rel(stats, variables["batch_stats"]) > 1e-3


def _eval_mode(jmodel, port, variables, x):
    want = jmodel.apply(variables, x, train=False)
    assert _rel(port(_nchw(x), train=False).detach(), want) < TOL


def _steps(ref, jmodel, port, variables, x, labels, steps):
    """``steps`` Nesterov steps of the reference module's
    ``make_train_step`` and the port's, float64 on both sides (call
    under ``jax.enable_x64``): each loss, then every parameter and
    statistic."""
    optimizer = optax.sgd(learning_rate=0.1, momentum=0.9, nesterov=True)
    train_step = ref.make_train_step(jmodel, optimizer)
    params, stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64),
        (variables["params"], variables["batch_stats"]))
    state = optimizer.init(params)
    port_step = tmob.make_train_step(port, tmob.nesterov_sgd(
        port.parameters()))
    x64 = _nchw(x).double()
    for _ in range(steps):
        params, stats, state, want_loss = train_step(
            params, stats, state, x.astype(np.float64), labels)
        got_loss = port_step(x64, torch.from_numpy(labels))
        assert abs(float(got_loss) - float(want_loss)) < TOL64 * abs(
            float(want_loss))
    got = tmob.params_to_flax(port.state_dict())
    assert _max_rel(got["params"], params) < TOL64
    assert _max_rel(got["batch_stats"], stats) < TOL64


def _main_keys(main, argv, capsys):
    assert main([*argv, "--steps", "1", "--device", "cpu", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert list(out) == REFERENCE_KEYS
    assert out["backend"] == "cpu" and np.isfinite(out["final_loss"])
    return out


# ---------------------------------------------------------------------------
# MobileNetV2
# ---------------------------------------------------------------------------

def _mob(dtype):
    return jmob.MobileNetV2(width=0.25, blocks=TINY_BLOCKS, num_classes=10,
                            dtype=dtype)


@pytest.fixture(scope="module")
def mob():
    return (_random_variables(_mob(jnp.float32), 32, seed=1),
            *_batch(32, 4, seed=0))


def test_mobilenet_train_mode_logits_and_batch_stats(mob):
    variables, x, _ = mob
    port = _load(tmob.tiny_model(torch.float32), variables, torch.float32)
    _train_mode(_mob(jnp.float32), port, variables, x, TOL)


def test_mobilenet_eval_mode_logits(mob):
    variables, x, _ = mob
    port = _load(tmob.tiny_model(torch.float32), variables, torch.float32)
    _eval_mode(_mob(jnp.float32), port, variables, x)


def test_mobilenet_nesterov_steps(mob):
    variables, x, labels = mob
    with jax.enable_x64(True):
        port = _load(tmob.tiny_model(torch.float64), variables,
                     torch.float64)
        _steps(jmob, _mob(jnp.float64), port, variables, x, labels, 2)


def test_round_channels_equals_the_reference():
    for c in np.arange(0.25, 1400, 0.25):
        for divisor in (4, 8):
            assert tmob._round_channels(c, divisor) == \
                jmob._round_channels(c, divisor), (c, divisor)


@pytest.mark.parametrize("full", [False, True], ids=["tiny", "v2_1.0"])
def test_mobilenet_fresh_init_has_the_reference_tree(full):
    jmodel, port = ((jmob.MobileNetV2(), tmob.MobileNetV2()) if full
                    else (jmob.tiny_model(), tmob.tiny_model()))
    want = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 32, 32, 3)))
    got = tmob.params_to_flax(tmob.init_variables(port).state_dict())
    assert _shapes(got) == _shapes(want)
    # the depthwise kernels are grouped: [3, 3, 1, hidden]
    assert got["params"]["block1_1"]["depthwise"]["kernel"].shape[2] == 1


def test_mobilenet_main_json_prints_the_reference_keys(capsys):
    out = _main_keys(tmob.main, ["--batch-size", "2", "--image-size", "64",
                                 "--width", "0.25"], capsys)
    assert out["model"] == "mobilenetv2-0.25"


# ---------------------------------------------------------------------------
# InceptionV3
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inc():
    return (_random_variables(jinc.InceptionV3(num_classes=10), 75, seed=3),
            *_batch(75, 2, seed=2))


def test_inception_eval_mode_logits(inc):
    variables, x, _ = inc
    port = _load(tinc.InceptionV3(10, torch.float32), variables,
                 torch.float32)
    _eval_mode(jinc.InceptionV3(10, jnp.float32), port, variables, x)


def test_inception_train_mode_logits_and_batch_stats_in_float64(inc):
    variables, x, _ = inc
    with jax.enable_x64(True):
        port = _load(tinc.InceptionV3(10, torch.float64), variables,
                     torch.float64)
        wide = jax.tree_util.tree_map(lambda a: a.astype(np.float64),
                                      variables)
        _train_mode(jinc.InceptionV3(10, jnp.float64), port, wide,
                    x.astype(np.float64), TOL64)


def test_inception_ends_at_2048_channels_and_keeps_the_tree(inc):
    variables, _, _ = inc
    assert variables["params"]["Dense_0"]["kernel"].shape == (2048, 10)
    port = tinc.init_variables(tinc.InceptionV3(num_classes=10))
    assert tuple(port.Dense_0.weight.shape) == (10, 2048)
    got = tinc.params_to_flax(port.state_dict())
    assert _shapes(got) == _shapes(variables)


@pytest.mark.slow
def test_inception_nesterov_step_in_float64(inc):
    """Compile-heavy, as the reference's own train-step test says
    (tests/test_convnets.py): the slow tier."""
    variables, x, labels = inc
    with jax.enable_x64(True):
        port = _load(tinc.InceptionV3(10, torch.float64), variables,
                     torch.float64)
        _steps(jinc, jinc.InceptionV3(10, jnp.float64), port, variables, x,
               labels, 1)


def test_inception_main_passes_its_flags_and_prints_the_json(
        monkeypatch, capsys):
    """The CLI alone (bf16 convolutions are slow on a CPU: a bf16
    InceptionV3 step takes seconds; the shared timed loop's keys are held
    by the other models' runs, and the card runs ``benchmark()`` itself
    in chip_smoke.py's convnets phase)."""
    calls = []

    def benchmark(*args, **kw):
        calls.append((args, kw))
        return {"backend": "cpu", "model": "inceptionv3"}

    monkeypatch.setattr(tinc, "benchmark", benchmark)
    assert tinc.main(["--batch-size", "4", "--steps", "7", "--image-size",
                      "75", "--device", "cpu", "--json"]) == 0
    assert calls == [((4, 7, 75), {"device": "cpu"})]
    assert json.loads(capsys.readouterr().out) == {
        "backend": "cpu", "model": "inceptionv3"}
