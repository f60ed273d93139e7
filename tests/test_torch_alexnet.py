"""The port's space-to-depth stems and AlexNet against the JAX reference,
on the CPU.

Weights are drawn with numpy from a seed in the reference's tree layout
(its ``init`` shapes, through ``jax.eval_shape``) and carried to the
port by ``params_from_flax``; inputs come from numpy too. Tolerances are
relative to each tensor's largest magnitude:

- ``space_to_depth_conv`` against ``direct_conv`` and against the
  reference's re-blocking, for both stems (AlexNet 11x11/s4, ResNet
  7x7/s2) at several sizes, odd and non-square ones included: values
  and the gradients of input and kernel within 1e-5 (float32);
- AlexNet at 99x99 (the last pool leaves 2x2, so ``Dense_0`` reads 1024
  rows and a wrong flatten order shows), batch 2, 10 classes, float32:
  logits within 1e-4, then two SGD steps (lr 0.01, momentum 0.9, the
  reference's optimizer): each loss and every parameter within 1e-4;
- the bf16 default (1000 classes, the reference's own ``forward`` and
  ``make_train_step``): logits and the step's loss within BF16_TOL;
- ``main(... --device cpu --json)`` prints exactly the reference's keys,
  and an entry point given no device on a machine without a card raises.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_device_plugin_tpu.models import alexnet as jalex
from k8s_device_plugin_tpu.ops import s2d as js2d
from k8s_device_plugin_tpu_torch.models import alexnet as talex
from k8s_device_plugin_tpu_torch.ops import s2d as ts2d

# (taps, stride, padding) of each stem
STEMS = {"alexnet": (11, 4, 2), "resnet": (7, 2, 3)}
STEM_SIZES = [(11, 11), (13, 13), (32, 32), (33, 35), (56, 72), (99, 99)]
TOL = 1e-4
S2D_TOL = 1e-5
# bf16 against bf16: two libraries round each layer's bf16 output
# differently (9e-3 on the logits and 7e-5 on the loss in this test's
# case on the CPU).
BF16_TOL = 3e-2
SIZE, BATCH, CLASSES = 99, 2, 10
REFERENCE_KEYS = ["backend", "batch_size", "steps", "seconds",
                  "images_per_second", "final_loss"]


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _random_params(model, size, seed):
    """Numpy weights in the reference's tree layout: kernels scaled by
    1/sqrt(fan_in), small random biases."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if jax.tree_util.keystr(path).endswith("bias']"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(leaf, dict(shapes))


def _batch(seed, size=SIZE, classes=CLASSES):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, size, size, 3)).astype(np.float32)
    return x, rng.integers(0, classes, BATCH)


def _port(params, **kw):
    model = talex.AlexNet(image_size=SIZE, **kw)
    model.load_state_dict(talex.params_from_flax({"params": params}),
                          strict=True)
    return model


# ---------------------------------------------------------------------------
# the space-to-depth stems
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", STEM_SIZES,
                         ids=lambda hw: "x".join(map(str, hw)))
@pytest.mark.parametrize("stem", sorted(STEMS))
def test_space_to_depth_equals_direct_and_the_reference(stem, hw):
    taps, stride, pad = STEMS[stem]
    rng = np.random.default_rng(taps * 1000 + hw[0] * 10 + hw[1])
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    k = rng.standard_normal((taps, taps, 3, 8)).astype(np.float32)

    def port(fn):
        xt = _nchw(x).requires_grad_()
        kt = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).requires_grad_()
        y = fn(xt, kt, stride, pad)
        return y, xt, kt

    direct, xd, kd = port(ts2d.direct_conv)
    s2d, xs, ks = port(ts2d.space_to_depth_conv)
    ref = np.asarray(js2d.space_to_depth_conv(x, k, stride, pad))
    assert _rel(s2d.detach(), direct.detach()) < S2D_TOL
    assert _rel(s2d.detach(), ref.transpose(0, 3, 1, 2)) < S2D_TOL

    cot = rng.standard_normal(direct.shape).astype(np.float32)
    (direct * torch.from_numpy(cot)).sum().backward()
    (s2d * torch.from_numpy(cot)).sum().backward()
    gx, gk = jax.grad(
        lambda x, k: (js2d.space_to_depth_conv(x, k, stride, pad)
                      * cot.transpose(0, 2, 3, 1)).sum(), (0, 1))(x, k)
    assert _rel(xs.grad, xd.grad) < S2D_TOL
    assert _rel(ks.grad, kd.grad) < S2D_TOL
    assert _rel(xs.grad, np.asarray(gx).transpose(0, 3, 1, 2)) < S2D_TOL
    assert _rel(ks.grad, np.asarray(gk).transpose(3, 2, 0, 1)) < S2D_TOL


def test_space_to_depth_keeps_channels_last():
    """The re-block of channels_last input is channels_last itself (the
    NHWC cuDNN wants), with the same values as from contiguous input."""
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    k = torch.randn(16, 3, 7, 7, generator=torch.Generator().manual_seed(1))
    y = ts2d.space_to_depth_conv(x.contiguous(
        memory_format=torch.channels_last), k, 2, 3)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert _rel(y, ts2d.space_to_depth_conv(x, k, 2, 3)) < S2D_TOL


# ---------------------------------------------------------------------------
# AlexNet, float32
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fp32():
    jmod = jalex.AlexNet(num_classes=CLASSES, dtype=jnp.float32)
    return jmod, _random_params(jmod, SIZE, seed=0), *_batch(seed=1)


def test_dense_0_reads_the_nhwc_flatten_of_a_2x2_map(fp32):
    jmod, params, x, _ = fp32
    assert params["Dense_0"]["kernel"].shape == (256 * 2 * 2, 4096)
    model = _port(params, num_classes=CLASSES, dtype=torch.float32)
    assert tuple(model.Dense_0.weight.shape) == (4096, 1024)
    # the same weights read in NCHW order would not match (the test
    # below would fail with such a flatten)
    want = np.asarray(jmod.apply({"params": params}, x))
    assert _rel(model(_nchw(x)).detach(), want) < TOL


def test_fp32_sgd_steps_match_the_reference(fp32):
    jmod, params, x, labels = fp32
    model = _port(params, num_classes=CLASSES, dtype=torch.float32)
    step = talex.make_train_step(
        model, talex.momentum_sgd(model.parameters()))

    def loss(p):
        logits = jmod.apply({"params": p}, x)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()

    grad_fn = jax.jit(jax.value_and_grad(loss))
    opt = optax.sgd(learning_rate=0.01, momentum=0.9)
    state = opt.init(params)
    for _ in range(2):
        want_loss, grads = grad_fn(params)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        got_loss = step(_nchw(x), torch.from_numpy(labels))
        assert abs(float(got_loss) - float(want_loss)) < TOL * abs(
            float(want_loss))
    got = talex.params_to_flax(model.state_dict())["params"]
    errors = jax.tree_util.tree_map(_rel, got, jax.tree_util.tree_map(
        np.asarray, dict(params)))
    assert max(jax.tree_util.tree_leaves(errors)) < TOL


# ---------------------------------------------------------------------------
# AlexNet, the bf16 default
# ---------------------------------------------------------------------------

def test_bf16_default_forward_and_step_match_the_reference():
    jmod = jalex.AlexNet()
    params = _random_params(jmod, SIZE, seed=2)
    x, labels = _batch(seed=3, classes=jalex.NUM_CLASSES)
    model = _port(params)
    assert model.dtype == torch.bfloat16
    want = np.asarray(jalex.forward(params, x))
    got = talex.forward(model, _nchw(x))
    assert got.dtype == torch.float32
    assert _rel(got, want) < BF16_TOL

    opt = optax.sgd(learning_rate=0.01, momentum=0.9)
    ref_step = jalex.make_train_step(opt)
    copy = jax.tree_util.tree_map(jnp.array, params)
    _, _, want_loss = ref_step(copy, opt.init(copy), x, labels)
    step = talex.make_train_step(
        model, talex.momentum_sgd(model.parameters()))
    got_loss = step(_nchw(x), torch.from_numpy(labels))
    assert abs(float(got_loss) - float(want_loss)) < BF16_TOL * abs(
        float(want_loss))


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def test_main_json_prints_the_reference_keys(capsys):
    assert talex.main(["--batch-size", "2", "--steps", "2", "--image-size",
                       "67", "--device", "cpu", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert list(out) == REFERENCE_KEYS
    assert out["backend"] == "cpu" and out["steps"] == 2
    assert np.isfinite(out["final_loss"]) and out["images_per_second"] > 0


def test_fresh_init_is_flax_shaped_and_seeded():
    a, b = talex.init_params(0, 67), talex.init_params(0, 67)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    w = a.Dense_1.weight.detach()
    assert abs(float(w.std()) - 4096 ** -0.5) < 0.05 * 4096 ** -0.5
    assert float(w.abs().max()) <= 2 * 4096 ** -0.5 / 0.8796 + 1e-6
    assert float(a.stem_bias.detach().abs().max()) == 0.0


def test_without_a_device_flag_the_entry_point_wants_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        talex.main(["--batch-size", "2", "--steps", "1", "--image-size",
                    "67"])
