"""The AlexNet pod's trajectory: the port's float32 steps against the
reference's over the pod's 103 steps (ROADMAP C7).

The pod (example/pod/alexnet-tpu.yaml:16-17, models/alexnet.py
``benchmark``) trains one fixed batch of random labels, 224x224, batch
128, with ``sgd(0.01, momentum=0.9)``: 3 warm-up steps and 100 timed
ones. Here both packages take those 103 steps in float32 on the CPU
from the reference's own init (PRNGKey(0)) and batch
(``synthetic_batch(PRNGKey(0))``), the weights carried to the port by
``params_from_flax``. A third run is the reference again from weights
moved by one float32 ulp (x (1 + 2^-23)): what float32 noise alone does
to this trajectory.

The trajectory is chaotic: a difference in the last bit grows ~10x
every two steps. So the port is held to the reference's own noise, not
to a fixed tolerance after the first steps:

- the first two losses agree within float32 rounding;
- the port parts from the reference (relative difference above
  PART_AT) no earlier than the one-ulp run parts from it, less
  PART_SLACK steps;
- both packages' losses fall for the first 40 steps and then spike
  (each rises to at least SPIKE x its minimum of the first 50 steps):
  the instability the card's bf16 pod showed is the workload's own.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_device_plugin_tpu.models import alexnet as jalex
from k8s_device_plugin_tpu_torch.models import alexnet as talex

STEPS = 103          # the pod's 3 warm-up + 100 timed steps
BATCH, SIZE = 128, 224
PART_AT = 1e-2       # relative loss difference that counts as parted
PART_SLACK = 3
SPIKE = 1.3
FIRST_TOL = 1e-5


def _reference_losses(params, images, labels):
    model = jalex.AlexNet(dtype=jnp.float32)
    opt = optax.sgd(0.01, momentum=0.9)

    def loss(p):
        return optax.softmax_cross_entropy_with_integer_labels(
            model.apply({"params": p}, images), labels).mean()

    @jax.jit
    def step(p, s):
        value, grads = jax.value_and_grad(loss)(p)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, value

    state, out = opt.init(params), []
    for _ in range(STEPS):
        params, state, value = step(params, state)
        out.append(float(value))
    return np.array(out)


def _port_losses(params, images, labels):
    model = talex.AlexNet(dtype=torch.float32)
    model.load_state_dict(talex.params_from_flax(
        {"params": jax.tree_util.tree_map(np.asarray, params)}), strict=True)
    step = talex.make_train_step(model,
                                 talex.momentum_sgd(model.parameters()))
    x = torch.from_numpy(np.ascontiguousarray(
        np.asarray(images).transpose(0, 3, 1, 2)))
    y = torch.from_numpy(np.asarray(labels).astype(np.int64))
    return np.array([float(step(x, y)) for _ in range(STEPS)])


def _parts(losses, ref) -> int:
    """The first step whose loss differs from ``ref``'s by more than
    PART_AT (relative), or STEPS."""
    rel = np.abs(losses - ref) / np.abs(ref)
    over = np.flatnonzero(~(rel <= PART_AT))
    return int(over[0]) if over.size else STEPS


@pytest.mark.slow
def test_pod_trajectory_parts_from_the_reference_as_float32_noise_does():
    model = jalex.AlexNet(dtype=jnp.float32)
    params = jax.jit(lambda r: model.init(
        r, jnp.zeros((1, SIZE, SIZE, 3)))["params"])(jax.random.PRNGKey(0))
    images, labels = jalex.synthetic_batch(jax.random.PRNGKey(0), BATCH,
                                           SIZE)
    ref = _reference_losses(params, images, labels)
    ulp = _reference_losses(
        jax.tree_util.tree_map(lambda a: a * (1 + 2.0 ** -23), params),
        images, labels)
    port = _port_losses(params, images, labels)

    # where the trajectories part, their lowest loss of the first 50
    # steps and their highest ([step, loss]; ``-s`` shows it)
    print(json.dumps({
        "parts_at_step": {"port": _parts(port, ref),
                          "one_ulp": _parts(ulp, ref)},
        "losses": {name: {"first": float(t[0]),
                          "min_first_50": [int(np.argmin(t[:50])),
                                           float(np.min(t[:50]))],
                          "max": [int(np.nanargmax(t)),
                                  float(np.nanmax(t))]}
                   for name, t in (("reference", ref), ("one_ulp", ulp),
                                   ("port", port))}}))
    np.testing.assert_allclose(port[:2], ref[:2], rtol=FIRST_TOL)
    assert _parts(port, ref) >= _parts(ulp, ref) - PART_SLACK, (
        _parts(port, ref), _parts(ulp, ref))
    for losses in (ref, port):
        assert np.isfinite(losses[:40]).all()
        assert losses[39] < losses[0]
        low = losses[:50].min()
        assert np.nanmax(losses[int(np.argmin(losses[:50])):]) >= SPIKE * low
