"""The port's parallel layer against the reference's.

- parallel/mesh.py: ``_factor`` and ``build_mesh`` give the reference's
  shapes and ValueError, ranks lie in the reference's device order (C
  order), ``visible_chip_indices`` follows its parse rules (over
  ``CUDA_VISIBLE_DEVICES``).
- parallel/sharding.py: each parameter's rule, or its fallback to
  replication, equals the reference's PartitionSpec (MHA and biases
  over tp, GQA with tp > kv_heads, MoE experts over ep).
- ring attention and Ulysses at world 4 (``sp4``, and ``sp2 x tp2``
  with heads over tp), causal and not, float32: output, LSE and
  dQ/dK/dV of the port's ranks (four gloo processes on the CPU, started
  once for the whole file by parallel/launch.py) against the reference's
  ``ring_attention_sharded`` / ``ulysses_attention_sharded`` on the
  conftest's virtual devices and ``jax.vjp`` of it; Ulysses' head
  divisibility and ``sp_impl`` checks (tests/test_ulysses.py:73-130).

Inputs are numpy draws with a seed. Tolerance: float32, atol and rtol
2e-5 (the two packages sum in other orders; the ring merges its blocks'
outputs by their LSEs).
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.models import transformer as jt
from k8s_device_plugin_tpu.ops.attention import (
    flash_attention_with_lse as j_flash_with_lse,
)
from k8s_device_plugin_tpu.parallel import mesh as jmesh
from k8s_device_plugin_tpu.parallel.ring_attention import (
    ring_attention_sharded as j_ring,
)
from k8s_device_plugin_tpu.parallel.sharding import (
    shard_params_for_tp as j_shard_params,
)
from k8s_device_plugin_tpu.parallel.ulysses import (
    ulysses_attention_sharded as j_ulysses,
)
from k8s_device_plugin_tpu_torch.models import transformer as tt
from k8s_device_plugin_tpu_torch.parallel import launch, workers
from k8s_device_plugin_tpu_torch.parallel import mesh as tmesh
from k8s_device_plugin_tpu_torch.parallel import sharding as tshard
from k8s_device_plugin_tpu_torch.parallel.ulysses import (
    ulysses_attention_sharded,
)

TOL = dict(atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,parts", [(1, 2), (2, 2), (4, 2), (6, 2), (8, 2),
                                     (8, 3), (12, 3), (16, 4), (7, 2),
                                     (6, 3), (4, 4)])
def test_factor_equals_the_references(n, parts):
    assert tmesh._factor(n, parts) == jmesh._factor(n, parts)


@pytest.mark.parametrize("axes,shape", [
    (("dp", "tp"), None), (("dp", "sp", "tp"), None), (("dp", "ep"), None),
    (("sp",), None), (("dp", "sp", "tp", "ep"), None),
    (("dp", "tp"), (2, 4)), (("tp", "sp"), (2, 4)), (("dp", "sp"), (8, 1)),
])
def test_build_mesh_shapes_and_rank_order_equal_the_references(axes, shape):
    """The same shape over 8 ranks as over the 8 virtual devices, and
    every axis's groups hold the ranks the reference's mesh holds along
    that axis (ranks in C order, as its device ids)."""
    want = jmesh.build_mesh(axes, shape)
    got = tmesh.build_mesh(axes, shape, world=8)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    for i, axis in enumerate(axes):
        rows = np.moveaxis(ids, i, -1).reshape(-1, ids.shape[i])
        assert sorted(map(list, rows)) == sorted(got.group_ranks((axis,)))


def test_build_mesh_refuses_a_shape_that_does_not_cover_the_world():
    with pytest.raises(ValueError, match="does not cover 8 devices"):
        jmesh.build_mesh(("dp", "tp"), (2, 3))
    with pytest.raises(ValueError, match="does not cover 8 devices"):
        tmesh.build_mesh(("dp", "tp"), (2, 3), world=8)


def test_a_mesh_without_a_process_group_is_one_rank():
    mesh = tmesh.build_mesh(("dp", "sp", "tp"))
    assert mesh.shape == {"dp": 1, "sp": 1, "tp": 1} and mesh.rank == 0
    assert mesh.group("dp", "sp") is None and mesh.group("tp") is None
    assert tmesh.mesh_from_env(("dp", "tp"), "cpu").world == 1


@pytest.mark.parametrize("raw", [None, "", "0,1,3", "2", "0,,1", "a,b",
                                 "0, 1", "1,x"])
def test_visible_chip_indices_follows_the_references_rules(raw, monkeypatch):
    for var in ("TPU_VISIBLE_CHIPS", "TPU_VISIBLE_DEVICES",
                "CUDA_VISIBLE_DEVICES"):
        monkeypatch.delenv(var, raising=False)
    if raw is not None:
        monkeypatch.setenv("TPU_VISIBLE_CHIPS", raw)
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", raw)
    assert tmesh.visible_chip_indices() == jmesh.visible_chip_indices()


def test_backend_rule_is_gloo_on_the_cpu():
    assert tmesh.backend_for("cpu")[0] == "gloo"


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

_SMALL = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=32,
              mlp_dim=64, max_seq_len=64)
SPEC_CONFIGS = {
    "mha": {},
    "gqa": dict(_SMALL, num_kv_heads=2, position="rope", mlp_act="swiglu",
                qkv_bias=True),
    "gpt2": dict(_SMALL, norm="layernorm", use_bias=True,
                 tie_embeddings=True),
    "moe": dict(_SMALL, num_experts=4),
}
SPEC_MESHES = [(("dp", "tp"), (2, 4)), (("dp", "tp"), (4, 2)),
               (("dp", "sp", "tp"), (2, 2, 2)), (("dp", "ep"), (4, 2)),
               (("tp", "ep"), (2, 4)), (("dp",), (8,))]


def _ref_path(port_name: str) -> str:
    """The reference's tree path of a port parameter."""
    parts = port_name.split(".")
    if parts[0] == "layers":
        parts = [f"layer{parts[1]}"] + parts[2:]
    if parts[0] in ("embed", "pos_embed"):
        parts.append("embedding")
    return "/".join(parts)


@pytest.mark.parametrize("axes,shape", SPEC_MESHES)
@pytest.mark.parametrize("name", sorted(SPEC_CONFIGS))
def test_parameter_rules_equal_the_references_specs(name, axes, shape):
    kw = SPEC_CONFIGS[name]
    cj = jt.LMConfig(**kw) if kw else jt.LMConfig.tiny()
    ct = tt.LMConfig(**kw) if kw else tt.LMConfig.tiny()
    shapes = jax.eval_shape(lambda: jt.DecoderLM(cj).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    want = {}
    for path, sharding in jax.tree_util.tree_flatten_with_path(
            j_shard_params(jmesh.build_mesh(axes, shape), shapes))[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        want[key] = tuple(sharding.spec)
    with torch.device("meta"):
        model = tt.DecoderLM(ct, param_dtype=torch.float32)
    got = {_ref_path(n): s for n, s in tshard.shard_params_for_tp(
        tmesh.build_mesh(axes, shape, world=8), model).items()}
    assert got == want
    # the model's split flags agree with the rules
    splits = tshard.splits(tmesh.build_mesh(axes, shape, world=8), ct)
    assert splits["attn"] == bool(got["layer0/attn/wq/kernel"])
    assert splits["kv"] == bool(got["layer0/attn/wk/kernel"])
    if ct.num_experts:
        assert splits["experts"] == bool(got["layer0/moe/wi"])
    else:
        assert splits["mlp"] == bool(got["layer0/mlp/wi/kernel"])


def test_gqa_kv_projections_replicate_when_tp_exceeds_kv_heads():
    """The example the rule's fallback exists for: 2 kv heads over tp 4."""
    ct = tt.LMConfig(**SPEC_CONFIGS["gqa"])
    with torch.device("meta"):
        model = tt.DecoderLM(ct, param_dtype=torch.float32)
    specs = tshard.shard_params_for_tp(
        tmesh.build_mesh(("dp", "tp"), (2, 4), world=8), model)
    assert specs["layers.0.attn.wk.kernel"] == ()
    assert specs["layers.0.attn.wq.kernel"] == (None, "tp")
    assert specs["layers.0.attn.wq.bias"] == ("tp",)


def test_shard_and_gather_round_trip_on_one_rank():
    mesh = tmesh.build_mesh(("dp", "tp"), world=1)
    t = torch.arange(24.0).view(4, 6)
    assert torch.equal(tshard.local_slice(t, (None, "tp"), mesh), t)
    assert torch.equal(tshard.gather_tensor(t, (None, "tp"), mesh), t)
    slicer = tshard.batch_sharding(mesh, seq_axis=True)
    assert torch.equal(slicer(t), t) and slicer.offset(6) == 0


# ---------------------------------------------------------------------------
# ring attention and Ulysses at world 4
# ---------------------------------------------------------------------------

B, S, H, D = 2, 64, 4, 16
LAYOUTS = {"sp4": (("sp",), (4,)), "sp2_tp2": (("sp", "tp"), (2, 2))}


def _case(name, impl, layout, causal, kv_heads=H, seed=0):
    rng = np.random.default_rng(seed)
    axes, shape = LAYOUTS[layout]
    draw = [rng.standard_normal((B, S, h, D)).astype(np.float32)
            for h in (H, kv_heads, kv_heads, H)]
    return dict(name=name, impl=impl, causal=causal, axes=axes, shape=shape,
                dtype="float32", **dict(zip("qkvg", draw)))


CASES = [
    _case("ring_sp4_causal", "ring", "sp4", True, seed=1),
    _case("ring_sp4_full", "ring", "sp4", False, seed=2),
    _case("ring_sp2_tp2_causal", "ring", "sp2_tp2", True, seed=3),
    _case("ring_sp4_gqa_causal", "ring", "sp4", True, kv_heads=2, seed=4),
    _case("ulysses_sp4_causal", "ulysses", "sp4", True, seed=5),
    _case("ulysses_sp4_full", "ulysses", "sp4", False, seed=6),
    _case("ulysses_sp2_tp2_causal", "ulysses", "sp2_tp2", True, seed=7),
]


@pytest.fixture(scope="module")
def ranks4():
    """One spawn of 4 gloo ranks for every case of the file, started in
    the background so the reference computes beside it."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(launch.spawn, workers.attention, 4, CASES,
                         timeout=300)
    yield future
    pool.shutdown(wait=True)


def _reference(case):
    """The reference's sharded attention on 4 virtual devices: out, the
    whole-sequence LSE, and dQ/dK/dV by jax.vjp with the cotangent g."""
    axes, shape = case["axes"], case["shape"]
    mesh = jmesh.build_mesh(axes, shape, devices=jax.devices()[:4])
    fn = j_ring if case["impl"] == "ring" else j_ulysses
    rep = H // case["k"].shape[2]

    def attend(q, k, v):
        k, v = jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2)
        return fn(q, k, v, mesh, causal=case["causal"])

    @jax.jit
    def forward_backward(q, k, v, g):
        out, vjp = jax.vjp(attend, q, k, v)
        return (out, *vjp(g))

    q, k, v, g = (jnp.asarray(case[n]) for n in "qkvg")
    out, dq, dk, dv = forward_backward(q, k, v, g)
    _, lse = j_flash_with_lse(
        q.transpose(0, 2, 1, 3),
        jnp.repeat(k, rep, axis=2).transpose(0, 2, 1, 3),
        jnp.repeat(v, rep, axis=2).transpose(0, 2, 1, 3),
        causal=case["causal"])
    return {n: np.asarray(x) for n, x in
            dict(out=out, lse=lse, dq=dq, dk=dk, dv=dv).items()}


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_sharded_attention_equals_the_references(case, ranks4):
    want = _reference(case)
    got = ranks4.result()[0][case["name"]]
    for name in ("out", "lse", "dq", "dk", "dv"):
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **TOL)


def test_every_rank_ran_every_case(ranks4):
    """Each rank returned every case; on the CPU the plain versions run,
    so no kernel launches (the card's counts are chip_smoke.py's)."""
    results = ranks4.result()
    assert len(results) == 4
    for rank in results:
        assert set(rank) == {c["name"] for c in CASES}
        assert all(not any(r["launches"].values()) for r in rank.values())


def test_ulysses_head_divisibility_enforced():
    q = np.zeros((1, 64, 6, 16), np.float32)
    with pytest.raises(ValueError, match="divisible"):
        j_ulysses(q, q, q, jmesh.build_mesh(("sp",), (4,),
                                            devices=jax.devices()[:4]))
    tq = torch.from_numpy(q)
    with pytest.raises(ValueError, match="divisible"):
        ulysses_attention_sharded(tq, tq, tq,
                                  tmesh.build_mesh(("sp",), (4,), world=4))
    # 8 heads over tp=2 x sp=4 divides; 4 heads does not
    tq4 = torch.zeros((1, 64, 4, 16))
    with pytest.raises(ValueError, match="divisible"):
        ulysses_attention_sharded(
            tq4, tq4, tq4, tmesh.build_mesh(("tp", "sp"), (2, 4), world=8))


def test_sp_impl_validated():
    cfg = tt.LMConfig.tiny()
    mesh = tmesh.build_mesh(("dp", "sp"), (2, 4), world=8)
    with pytest.raises(ValueError, match="unknown sp_impl"):
        tt.make_sharded_train_step(mesh, cfg, sp_impl="Ulysses")
    dp_mesh = tmesh.build_mesh(("dp",), (8,), world=8)
    with pytest.raises(ValueError, match="requires an 'sp' mesh axis"):
        tt.make_sharded_train_step(dp_mesh, cfg, sp_impl="ulysses")
    with pytest.raises(ValueError, match="requires an 'sp' mesh axis"):
        tt.make_sharded_train_step(dp_mesh, cfg, use_ring=True,
                                   sp_impl="ulysses")
