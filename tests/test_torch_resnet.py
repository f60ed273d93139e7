"""The port's ResNet against the JAX reference, on the CPU.

``tiny_model()``'s architecture (one bottleneck a stage, width 8, 10
classes) in float32 at 32x32 (the space-to-depth stem) and 33x33 (the
direct one), batch 4. Weights and running statistics are drawn with
numpy from a seed in the reference's tree layout (its ``init`` shapes,
through ``jax.eval_shape``) and carried over by ``params_from_flax``;
the last BatchNorm scales are random, not the init's zeros, so every
bottleneck's branch counts. Within 1e-4 of each tensor's largest
magnitude (float32):

- train-mode logits and the ``batch_stats`` that come back;
- eval-mode logits (the running statistics);
- two Nesterov SGD steps (lr 0.1, momentum 0.9) through the reference's
  own ``make_train_step``, both sides in float64 (``test_nesterov_steps``
  says why): each loss, every parameter and statistic within 1e-5.

A fresh port init zeroes each bottleneck's last BatchNorm scale, and
``params_to_flax`` of it has the reference tree's shapes leaf for leaf
(tiny and ResNet-50). ``main(... --json)`` prints the reference's keys.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_device_plugin_tpu.models import resnet as jres
from k8s_device_plugin_tpu_torch.models import resnet as tres

TOL = 1e-4
TOL64 = 1e-5
BATCH = 4
REFERENCE_KEYS = ["backend", "model", "batch_size", "steps", "seconds",
                  "images_per_second", "final_loss"]


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


def _port(variables, dtype=torch.float32):
    model = tres.tiny_model(dtype=dtype)
    model.load_state_dict(tres.params_from_flax(variables), strict=True)
    return model.to(dtype)


@pytest.fixture(scope="module", params=[32, 33], ids=["s2d32", "direct33"])
def case(request):
    size = request.param
    model = jres.ResNet(stage_sizes=(1, 1, 1, 1), width=8, num_classes=10,
                        dtype=jnp.float32)
    rng = np.random.default_rng(size)
    x = rng.standard_normal((BATCH, size, size, 3)).astype(np.float32)
    labels = rng.integers(0, 10, BATCH)
    return model, _random_variables(model, size, seed=size), x, labels


def test_train_mode_logits_and_batch_stats(case):
    model, variables, x, _ = case
    want, mutated = model.apply(variables, x, mutable=["batch_stats"])
    port = _port(variables)
    assert _rel(port(_nchw(x), train=True).detach(), want) < TOL
    got = tres.params_to_flax(port.state_dict())["batch_stats"]
    assert _max_rel(got, mutated["batch_stats"]) < TOL
    # the statistics moved: the comparison is not of the inputs
    assert _max_rel(got, variables["batch_stats"]) > 1e-3


def test_eval_mode_logits(case):
    model, variables, x, _ = case
    want = model.apply(variables, x, train=False)
    port = _port(variables)
    assert _rel(port(_nchw(x), train=False).detach(), want) < TOL
    got = tres.params_to_flax(port.state_dict())["batch_stats"]
    assert _max_rel(got, variables["batch_stats"]) == 0.0


def test_nesterov_steps(case):
    """In float64 on both sides: at lr 0.1 two float32 steps of either
    library land ~2e-3 from the float64 result (BatchNorm over the four
    values of stage 3's 1x1 map amplifies the rounding), so float32
    could not tell a fault from rounding. The logits are float32 in both
    (the models' last cast), which bounds the agreement at TOL64."""
    _, variables, x, labels = case
    with jax.enable_x64(True):
        model = jres.ResNet(stage_sizes=(1, 1, 1, 1), width=8,
                            num_classes=10, dtype=jnp.float64)
        optimizer = optax.sgd(learning_rate=0.1, momentum=0.9,
                              nesterov=True)
        step = jres.make_train_step(model, optimizer)
        params, stats = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64),
            (variables["params"], variables["batch_stats"]))
        state = optimizer.init(params)
        port = _port(variables, torch.float64)
        port_step = tres.make_train_step(port, tres.nesterov_sgd(
            port.parameters()))
        x64 = _nchw(x).double()
        for _ in range(2):
            params, stats, state, want_loss = step(
                params, stats, state, x.astype(np.float64), labels)
            got_loss = port_step(x64, torch.from_numpy(labels))
            assert abs(float(got_loss) - float(want_loss)) < TOL64 * abs(
                float(want_loss))
    got = tres.params_to_flax(port.state_dict())
    assert _max_rel(got["params"], params) < TOL64
    assert _max_rel(got["batch_stats"], stats) < TOL64


@pytest.mark.parametrize("depth", [None, 50])
def test_fresh_init_has_the_reference_tree_and_zero_last_scales(depth):
    if depth is None:
        jmodel, port, size = jres.tiny_model(), tres.tiny_model(), 32
    else:
        jmodel, port = jres.ResNet(), tres.ResNet()
        size = 64
    port = tres.init_variables(port, seed=0)
    want = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, size, size, 3)))
    got = tres.params_to_flax(port.state_dict())
    assert _shapes(got) == _shapes(want)
    blocks = [m for m in port.modules() if isinstance(m, tres.Bottleneck)]
    assert blocks
    for block in blocks:
        assert float(block.BatchNorm_2.scale.detach().abs().max()) == 0.0
        assert float(block.BatchNorm_0.scale.detach().min()) == 1.0
    # every leaf maps back: state dict -> tree -> state dict
    again = tres.params_from_flax(got)
    assert sorted(again) == sorted(port.state_dict())


def test_main_json_prints_the_reference_keys(capsys):
    assert tres.main(["--batch-size", "2", "--steps", "1", "--image-size",
                      "64", "--device", "cpu", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert list(out) == REFERENCE_KEYS
    assert out["backend"] == "cpu" and out["model"] == "resnet50"
    assert np.isfinite(out["final_loss"])
