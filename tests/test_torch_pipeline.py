"""The port's pipeline executors against the reference's.

parallel/pipeline.py, pipeline_1f1b.py and pipeline_interleaved.py of
the port run on gloo ranks (parallel/workers.py ``pipeline``: one spawn
of 2 ranks and one of 4 for the whole file, in the background while the
reference computes); the reference's run on conftest's virtual CPU
devices. The same numpy weights and inputs go through both with the
same stage (``gelu(x @ w + b)``) and loss (``mean(out^2)``; with a head
``u`` and per-microbatch targets, ``mean((out @ u - t)^2)``):

- the schedule tables: ``schedule_ticks``, ``peak_stash`` and
  ``build_schedule`` (every table, for several S, V, M) equal the
  reference's, and the port's 1F1B table places each op where the
  reference's tick formulas do;
- ``pipeline_apply`` (GPipe forward) at 2 and 4 ranks;
- the 1F1B ``pipeline_value_and_grad`` at 2 and 4 ranks, with a head,
  targets and the input cotangent, and with a data axis (dp2 x pp2);
  the interleaved one at 2 and 4 ranks and with a data axis: loss
  within 1e-5 and every gradient within 1e-4 of the reference's;
- the fused update (Adam inside the drain) equal to the unfused
  gradients followed by the same update, with and without a data axis;
- the reference's refusals.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_device_plugin_tpu.parallel import build_mesh as jbuild_mesh
from k8s_device_plugin_tpu.parallel import pipeline as jpipeline
from k8s_device_plugin_tpu.parallel import pipeline_1f1b as j1f1b
from k8s_device_plugin_tpu.parallel import pipeline_interleaved as jinter
from k8s_device_plugin_tpu_torch.parallel import launch, workers
from k8s_device_plugin_tpu_torch.parallel import pipeline_1f1b as t1f1b
from k8s_device_plugin_tpu_torch.parallel import pipeline_interleaved as tinter

DIM, BATCH, OUT = 16, 16, 3
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


def _inputs(rows: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "w": (rng.standard_normal((rows, DIM, DIM))
                  / np.sqrt(DIM)).astype(np.float32),
            "b": (rng.standard_normal((rows, DIM)) * 0.1).astype(np.float32),
        },
        "x": rng.standard_normal((BATCH, DIM)).astype(np.float32),
        "u": rng.standard_normal((DIM, OUT)).astype(np.float32),
        "targets": rng.standard_normal((BATCH, OUT)).astype(np.float32),
    }


# name: (world, axes, shape, kind, microbatches, chunks, extras)
CASES = {
    "apply_s2": (2, ("pp",), (2,), "apply", 4, 1, {}),
    "1f1b_s2": (2, ("pp",), (2,), "1f1b", 8, 1, {}),
    "1f1b_s2_head": (2, ("pp",), (2,), "1f1b", 4, 1,
                     {"head": True, "return_dx": True}),
    "inter_s2": (2, ("pp",), (2,), "1f1b", 4, 2,
                 {"head": True, "return_dx": True}),
    "fused_s2": (2, ("pp",), (2,), "1f1b", 4, 1, {"fused": True}),
    "fused_inter_s2": (2, ("pp",), (2,), "1f1b", 4, 2, {"fused": True}),
    "refuse_batch": (2, ("pp",), (2,), "1f1b", 3, 1, {}),
    "refuse_inter_mb": (2, ("pp",), (2,), "1f1b", 3, 2, {"batch": 12}),
    "refuse_specs": (2, ("pp",), (2,), "1f1b", 4, 1,
                     {"opt_state_specs": True}),
    "apply_s4": (4, ("pp",), (4,), "apply", 4, 1, {}),
    "1f1b_s4": (4, ("pp",), (4,), "1f1b", 4, 1,
                {"head": True, "return_dx": True}),
    "inter_s4": (4, ("pp",), (4,), "1f1b", 4, 2, {}),
    "dp_1f1b": (4, ("dp", "pp"), (2, 2), "1f1b", 4, 1,
                {"head": True, "return_dx": True, "data_axis": "dp"}),
    "dp_inter": (4, ("dp", "pp"), (2, 2), "1f1b", 4, 2,
                 {"head": True, "return_dx": True, "data_axis": "dp"}),
    "dp_fused": (4, ("dp", "pp"), (2, 2), "1f1b", 4, 1,
                 {"fused": True, "data_axis": "dp"}),
}
REFUSALS = {"refuse_batch": "not divisible into 3 microbatches",
            "refuse_inter_mb": "divisible by the stage count",
            "refuse_specs": "opt_state_specs requires"}


def _stages(name) -> int:
    _, axes, shape, *_ = CASES[name]
    return dict(zip(axes, shape))["pp"]


def _case(name) -> dict:
    _, axes, shape, kind, m, v, extras = CASES[name]
    data = _inputs(_stages(name) * v)
    if "batch" in extras:
        data["x"] = data["x"][:extras["batch"]]
    case = dict(name=name, kind=kind, axes=axes, shape=shape,
                params=data["params"], x=data["x"], microbatches=m,
                chunks=v, return_dx=extras.get("return_dx", False),
                data_axis=extras.get("data_axis"),
                fused=extras.get("fused", False),
                opt_state_specs=extras.get("opt_state_specs", False))
    if extras.get("head"):
        case.update(u=data["u"], targets=data["targets"])
    return case


@pytest.fixture(scope="module")
def ranks():
    """{world: [each rank's results]}, spawned in the background."""
    def run():
        out = {}
        for world in (2, 4):
            cases = [_case(n) for n, c in CASES.items() if c[0] == world]
            out[world] = launch.spawn(workers.pipeline, world, cases,
                                      timeout=300)
        return out

    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(run)
    yield future
    pool.shutdown(wait=True)


def _got(ranks, name) -> list:
    return [r[name] for r in ranks.result()[CASES[name][0]]]


def _rows(ranks, name) -> dict:
    rows = {}
    for r in _got(ranks, name):
        rows.update(r["rows"])
    return rows


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

def _stage_fn(params, x):
    return jax.nn.gelu(x @ params["w"] + params["b"])


def _loss_fn(out):
    return (out.astype(jnp.float32) ** 2).mean()


def _head_loss(out, head, aux):
    return ((out @ head["u"] - aux).astype(jnp.float32) ** 2).mean()


def _mesh(name):
    _, axes, shape, *_ = CASES[name]
    return jbuild_mesh(axes, shape, devices=jax.devices()[:int(
        np.prod(shape))])


def _reference(name):
    """The reference's executor on the case: (out,) for ``apply``, else
    (loss, stacked grads, head grads or None, dx or None)."""
    case = _case(name)
    mesh = _mesh(name)
    params = jax.tree_util.tree_map(jnp.asarray, case["params"])
    x = jnp.asarray(case["x"])
    if case["kind"] == "apply":
        return np.asarray(jpipeline.pipeline_apply(
            _stage_fn, jpipeline.shard_stage_params(mesh, params), x, mesh,
            case["microbatches"]))
    kw = dict(return_dx=case["return_dx"], data_axis=case["data_axis"])
    loss_fn = _loss_fn
    if "u" in case:
        kw.update(head_params={"u": jnp.asarray(case["u"])},
                  loss_data=jnp.asarray(case["targets"]))
        loss_fn = _head_loss
    if case["chunks"] > 1:
        out = jinter.interleaved_pipeline_value_and_grad(
            _stage_fn, loss_fn, params, x, mesh, case["microbatches"],
            case["chunks"], **kw)
    else:
        out = j1f1b.pipeline_value_and_grad(
            _stage_fn, loss_fn, params, x, mesh, case["microbatches"], **kw)
    out = list(out)
    loss, grads = out.pop(0), out.pop(0)
    head = out.pop(0) if "u" in case else None
    dx = out.pop(0) if case["return_dx"] else None
    return float(loss), jax.tree_util.tree_map(np.asarray, grads), head, dx


# ---------------------------------------------------------------------------
# the schedule tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,M", [(2, 4), (4, 16), (8, 4), (3, 5)])
def test_schedule_ticks_and_stash_are_the_references(S, M):
    assert t1f1b.schedule_ticks(S, M) == j1f1b.schedule_ticks(S, M)
    assert t1f1b.peak_stash(S, M) == j1f1b.peak_stash(S, M)


@pytest.mark.parametrize("S,V,M", [(2, 2, 2), (2, 2, 4), (4, 2, 4),
                                   (2, 3, 4), (4, 2, 8), (3, 2, 3),
                                   (2, 4, 4), (3, 3, 6)])
def test_build_schedule_tables_are_the_references(S, V, M):
    got, want = tinter.build_schedule(S, V, M), jinter.build_schedule(S, V, M)
    for field in ("num_stages", "num_chunks", "num_microbatches", "ticks",
                  "stash_slots"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("op", "chunk", "mb", "act_src_chunk", "grad_src_chunk",
                  "update_chunk"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert int((got.op > 0).sum()) == 2 * M * V * S


@pytest.mark.parametrize("S,M", [(2, 4), (3, 4), (4, 8)])
def test_plain_schedule_places_ops_by_the_references_formulas(S, M):
    """The reference's 1F1B tick rule: F(r, m) at r + 2m, B(r, m) at
    2S - 1 - r + 2m; a rank's last backward is its update tick."""
    sch = t1f1b.PlainSchedule(S, M)
    assert sch.ticks == j1f1b.schedule_ticks(S, M)
    want_op = np.zeros((sch.ticks, S), np.int32)
    want_mb = np.zeros((sch.ticks, S), np.int32)
    for r in range(S):
        for m in range(M):
            want_op[r + 2 * m, r], want_mb[r + 2 * m, r] = tinter.FWD, m
            t = 2 * S - 1 - r + 2 * m
            want_op[t, r], want_mb[t, r] = tinter.BWD, m
    np.testing.assert_array_equal(sch.op, want_op)
    np.testing.assert_array_equal(sch.mb, want_mb)
    last = [2 * S - 1 - r + 2 * (M - 1) for r in range(S)]
    assert [int(np.flatnonzero(sch.update_chunk[:, r] == 0)[0])
            for r in range(S)] == last


def test_interleaved_microbatches_must_divide_by_stages():
    with pytest.raises(ValueError, match="divisible by the stage count"):
        tinter.build_schedule(2, 2, 3)


def test_opt_specs_like_follows_parameter_shapes():
    params = {"w": torch.zeros(4, 8), "b": torch.zeros(8)}
    specs = {"w": (None, "tp"), "b": (None,)}
    state = {"mu_w": torch.zeros(4, 8), "count": torch.zeros(())}
    assert t1f1b.opt_specs_like(state, params, specs) == {
        "mu_w": (None, "tp"), "count": ("pp",)}
    clash = {"w": torch.zeros(8), "b": torch.zeros(8)}
    with pytest.raises(ValueError, match="carry both"):
        t1f1b.opt_specs_like(state, clash, specs)


def test_spec_mentions_reads_nested_entries():
    assert t1f1b.spec_mentions(("pp", None, ("dp", "tp")), "tp")
    assert not t1f1b.spec_mentions(("pp", None), "tp")


# ---------------------------------------------------------------------------
# the executors on ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["apply_s2", "apply_s4"])
def test_pipeline_apply_equals_the_references(name, ranks):
    want = _reference(name)
    for got in _got(ranks, name):
        np.testing.assert_allclose(got["out"], want, atol=1e-5, rtol=1e-5)


GRAD_CASES = ["1f1b_s2", "1f1b_s2_head", "inter_s2", "1f1b_s4", "inter_s4",
              "dp_1f1b", "dp_inter"]


@pytest.mark.parametrize("name", GRAD_CASES)
def test_value_and_grad_equals_the_references(name, ranks):
    loss, grads, head, dx = _reference(name)
    got = _got(ranks, name)
    for r in got:
        np.testing.assert_allclose(r["loss"], loss, atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
    rows = _rows(ranks, name)
    assert sorted(rows) == list(range(len(grads["w"])))
    for row, g in rows.items():
        for key in ("w", "b"):
            np.testing.assert_allclose(
                g[key], grads[key][row], atol=GRAD_TOL, rtol=GRAD_TOL,
                err_msg=f"{name} row {row} {key}")
    for r in got:
        if head is not None:
            np.testing.assert_allclose(r["head"]["u"], head["u"],
                                       atol=GRAD_TOL, rtol=GRAD_TOL)
        if dx is not None:
            np.testing.assert_allclose(r["dx"], dx, atol=GRAD_TOL,
                                       rtol=GRAD_TOL)


@pytest.mark.parametrize("fused", ["fused_s2", "fused_inter_s2",
                                   "dp_fused"])
def test_fused_update_equals_grads_then_update(fused, ranks):
    """Adam inside the drain (each chunk the tick its last backward
    runs) gives the parameters of the reference's gradients followed by
    optax.adam(1e-2), the update the port's ``adam_update`` mirrors."""
    case = _case(fused)
    _, grads, _, _ = _reference(fused)  # the unfused gradients
    tx = optax.adam(1e-2)
    params = jax.tree_util.tree_map(jnp.asarray, case["params"])
    updates, _ = jax.vmap(tx.update)(
        grads, jax.vmap(tx.init)(params), params)
    want = jax.tree_util.tree_map(np.asarray,
                                  optax.apply_updates(params, updates))
    rows = _rows(ranks, fused)
    for row, p in rows.items():
        for key in ("w", "b"):
            np.testing.assert_allclose(p[key], want[key][row], atol=1e-5,
                                       rtol=1e-5, err_msg=f"{fused} {key}")


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_the_references_refusals(name, ranks):
    for r in _got(ranks, name):
        assert REFUSALS[name] in r["error"]
    case = _case(name)
    with pytest.raises(ValueError):
        if case["chunks"] > 1:
            jinter.build_schedule(_stages(name), case["chunks"],
                                  case["microbatches"])
        elif case["opt_state_specs"]:
            from jax.sharding import PartitionSpec as P

            j1f1b.pipeline_value_and_grad(
                _stage_fn, _loss_fn, case["params"], jnp.asarray(case["x"]),
                _mesh(name), case["microbatches"],
                opt_state_specs={"w": P("pp"), "b": P("pp")})
        else:
            j1f1b.microbatch_inputs(jnp.asarray(case["x"]), None,
                                    case["microbatches"])


def test_update_fn_needs_opt_state():
    from k8s_device_plugin_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="given together"):
        t1f1b.pipeline_value_and_grad(
            workers.gelu_stage, workers.square_loss,
            {"w": torch.zeros(DIM, DIM), "b": torch.zeros(DIM)},
            torch.zeros(4, DIM), Mesh(("pp",), (1,)), 2,
            update_fn=workers.adam_update())
