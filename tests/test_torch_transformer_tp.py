"""The port's manual tensor-parallel block and pp x tp (x dp) trainer
(models/transformer_tp.py) against the reference's.

At tests/test_transformer_tp.py's config (vocab 128, 4 layers, 4 heads,
embed 32, mlp 64, seq 32, float32):

- ``tp_block_apply`` on 2 and 4 tp ranks (parallel/workers.py
  ``tp_block``) gives the reference's ``tp_block_apply`` output under
  shard_map, and, seeded 1/tp a rank as the pipelines seed it, every
  rank's gradient slice and the input's gradient (replicated leaves and
  the input summed over tp, ``tp_edge_reduce``) equal the reference's
  autodiff of ``reference_block_apply``;
- ``make_pp_tp_train_step``'s value_and_grad from the reference's
  ``init_fn`` tree (PRNGKey(0), carried by models/params.py
  ``tp_params_from_jax``) on pp2 x tp2 (4 ranks), dp2 x pp2 x tp2 (8
  ranks), interleaved (V = 2) on pp2 x tp2 and on dp2 x pp2 x tp2:
  loss within 1e-5 and each rank's gradient slices within 2e-4 of the
  reference's value_and_grad on the same layout;
- the fused update inside the drain equal to the unfused step, plain at
  pp2 x tp2 and interleaved at dp2 x pp2 x tp2;
- the reference's refusals (Llama-class and LayerNorm configs, heads
  that do not divide over tp), and ``main --smoke --device cpu`` at the
  production layout (``--dp 2 --tp 2 --chunks 2 --fuse-update``) under
  ``torch.distributed.run`` at 8 ranks.

The spawns (world 2, 4 and 8, once each) run in the background while the
reference computes.
"""

import concurrent.futures
import functools
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from k8s_device_plugin_tpu.models import transformer as jt
from k8s_device_plugin_tpu.models import transformer_tp as jtp
from k8s_device_plugin_tpu.parallel import build_mesh
from k8s_device_plugin_tpu.parallel.compat import shard_map_norep
from k8s_device_plugin_tpu_torch.models import params as tparams
from k8s_device_plugin_tpu_torch.models import transformer as tt
from k8s_device_plugin_tpu_torch.models import transformer_tp as ttp
from k8s_device_plugin_tpu_torch.parallel import launch, workers
from k8s_device_plugin_tpu_torch.parallel.mesh import Mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=128, num_layers=4, num_heads=4, embed_dim=32,
           mlp_dim=64, max_seq_len=32)
JCFG = jt.LMConfig(**CFG, dtype=jnp.float32)
TCFG = tt.LMConfig(**CFG, dtype="float32")
# name: (axes, shape, microbatches, chunks, fused)
CASES = {
    "pp_tp": (("pp", "tp"), (2, 2), 4, 1, False),
    "interleaved_pp_tp": (("pp", "tp"), (2, 2), 4, 2, False),
    "fused_pp_tp": (("pp", "tp"), (2, 2), 4, 1, True),
    "dp_pp_tp": (("dp", "pp", "tp"), (2, 2, 2), 4, 1, False),
    "interleaved_dp_pp_tp": (("dp", "pp", "tp"), (2, 2, 2), 4, 2, False),
    "fused_interleaved_dp_pp_tp": (("dp", "pp", "tp"), (2, 2, 2), 4, 2,
                                   True),
}
BLOCK_WORLDS = (2, 4)


def _world(name) -> int:
    return int(np.prod(CASES[name][1]))


def _jmesh(axes, shape):
    return build_mesh(axes, shape,
                      devices=jax.devices()[:int(np.prod(shape))])


@functools.lru_cache(maxsize=None)
def _reference_tree(name):
    axes, shape, m, chunks, _ = CASES[name]
    _, init_fn, _ = jtp.make_pp_tp_train_step(
        _jmesh(axes, shape), JCFG, m, num_chunks=chunks)
    params, _ = init_fn(jax.random.PRNGKey(0), batch=8)
    tokens = jax.random.randint(jax.random.PRNGKey(1),
                                (8, CFG["max_seq_len"]), 0,
                                CFG["vocab_size"])
    return (jax.tree_util.tree_map(np.asarray, jax.device_get(params)),
            np.asarray(tokens))


def _case(name) -> dict:
    axes, shape, m, chunks, fused = CASES[name]
    params, tokens = _reference_tree(name)
    whole = tparams.tp_params_from_jax(params)
    return dict(name=name, trainer="tp", axes=axes, shape=shape,
                config=TCFG.to_json_dict(), microbatches=m, chunks=chunks,
                fused=fused, tokens=tokens,
                params={part: {k: v.numpy() for k, v in d.items()}
                        for part, d in whole.items()})


@functools.lru_cache(maxsize=None)
def _block_inputs():
    params = jtp.init_tp_block_params(jax.random.PRNGKey(0), JCFG)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 16, CFG["embed_dim"]))
    return (jax.tree_util.tree_map(np.asarray, params), np.asarray(x))


@pytest.fixture(scope="module")
def ranks():
    """{world: [each rank's results]}: the block at 2 and 4 ranks, the
    trainer at 4 and 8, spawned in the background."""
    def run():
        params, x = _block_inputs()
        block = dict(name="block", config=TCFG.to_json_dict(),
                     params=params, x=x)
        out = {("block", w): launch.spawn(workers.tp_block, w, [block],
                                          timeout=300)
               for w in BLOCK_WORLDS}
        for world in (4, 8):
            out[("train", world)] = launch.spawn(
                workers.pp_train, world,
                [_case(n) for n in CASES if _world(n) == world],
                timeout=300)
        return out

    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(run)
    yield future
    pool.shutdown(wait=True)


def _slice(a, spec, coords):
    """A rank's block of a whole array under ``spec`` (tp dims)."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = a.shape[dim] // coords["size"]
            a = np.take(a, range(coords[axis] * n, (coords[axis] + 1) * n),
                        axis=dim)
    return a


@pytest.mark.parametrize("world", BLOCK_WORLDS)
def test_tp_block_forward_and_grads_equal_the_references(world, ranks):
    params, x = _block_inputs()
    specs = jtp.tp_block_specs()
    mesh = _jmesh(("tp",), (world,))
    sharded = {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
               for k, v in params.items()}
    fn = shard_map_norep(functools.partial(jtp.tp_block_apply,
                                           dtype=JCFG.dtype),
                         mesh, in_specs=(specs, P()), out_specs=P())
    want = np.asarray(fn(sharded, x))
    g_params, g_x = jax.grad(
        lambda p, xx: (jtp.reference_block_apply(p, xx, dtype=JCFG.dtype)
                       ** 2).mean(), argnums=(0, 1))(params, x)
    port_specs = ttp.tp_block_specs()
    for r in ranks.result()[("block", world)]:
        got = r["block"]
        np.testing.assert_allclose(got["out"], want, atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(got["dx"], g_x, atol=2e-4, rtol=2e-4)
        coords = dict(got["coords"], size=world)
        for k, g in got["grads"].items():
            np.testing.assert_allclose(
                g, _slice(np.asarray(g_params[k]), port_specs[k], coords),
                atol=2e-4, rtol=2e-4, err_msg=k)


def _got(ranks, name) -> list:
    return [r[name] for r in ranks.result()[("train", _world(name))]]


GRAD_CASES = [n for n in CASES if not CASES[n][4]]


@pytest.mark.parametrize("name", GRAD_CASES)
def test_loss_and_grads_equal_the_references(name, ranks):
    axes, shape, m, chunks, _ = CASES[name]
    params, tokens = _reference_tree(name)
    _, _, vg = jtp.make_pp_tp_train_step(_jmesh(axes, shape), JCFG, m,
                                         num_chunks=chunks)
    loss, grads = vg(params, tokens)
    grads = jax.tree_util.tree_map(np.asarray, jax.device_get(grads))
    specs = {k: (None, *s) for k, s in ttp.tp_block_specs().items()}
    rows_seen = set()
    for r in _got(ranks, name):
        np.testing.assert_allclose(r["loss"], float(loss), atol=1e-5,
                                   rtol=1e-5)
        coords = dict(r["coords"], size=dict(zip(axes, shape))["tp"])
        for row, g in r["rows"].items():
            rows_seen.add(row)
            for k, t in g.items():
                np.testing.assert_allclose(
                    t, _slice(grads["blocks"][k][row], specs[k], coords),
                    atol=2e-4, rtol=2e-4, err_msg=f"{name} row {row} {k}")
        for part in ("embed", "head"):
            for k, t in r[part].items():
                np.testing.assert_allclose(t, grads[part][k], atol=2e-4,
                                           rtol=2e-4,
                                           err_msg=f"{name} {part}.{k}")
    assert sorted(rows_seen) == list(range(dict(zip(axes, shape))["pp"]
                                           * chunks))


@pytest.mark.parametrize("name", ["fused_pp_tp",
                                  "fused_interleaved_dp_pp_tp"])
def test_fused_update_equals_the_unfused_step(name, ranks):
    for r in _got(ranks, name):
        fused, unfused = r["fused"], r["unfused"]
        for part in ("embed", "head"):
            for k in unfused[part]:
                np.testing.assert_allclose(fused[part][k], unfused[part][k],
                                           atol=1e-6, rtol=1e-6)
        for row, p in unfused["rows"].items():
            for k in p:
                np.testing.assert_allclose(fused["rows"][row][k], p[k],
                                           atol=1e-6, rtol=1e-6,
                                           err_msg=f"{name} row {row} {k}")


def test_llama_class_and_layernorm_configs_rejected():
    mesh = Mesh(("pp", "tp"), (2, 2))
    llama = tt.LMConfig(**dict(CFG, num_kv_heads=2, position="rope",
                               mlp_act="swiglu"))
    with pytest.raises(ValueError, match="Llama-class"):
        ttp.make_pp_tp_train_step(mesh, llama, num_microbatches=2)
    gpt2 = tt.LMConfig(**CFG, norm="layernorm", use_bias=True)
    with pytest.raises(ValueError, match="norm='rms'"):
        ttp.make_pp_tp_train_step(mesh, gpt2, num_microbatches=2)


def test_divisibility_validated():
    bad = tt.LMConfig(**dict(CFG, num_heads=2))
    with pytest.raises(ValueError, match="divide"):
        ttp.make_pp_tp_train_step(Mesh(("pp", "tp"), (2, 4)), bad, 4)
    with pytest.raises(ValueError, match="not divisible"):
        ttp.make_pp_tp_train_step(Mesh(("pp", "tp"), (3, 2)), TCFG, 4)


def test_cli_smoke_production_layout(tmp_path):
    """The lm-train-pp-tp pod's entry point at its production layout
    under a launcher: dp x pp x tp with interleaved chunks and fused
    updates over 8 ranks; the reference's lines on rank 0, a falling
    loss, one embedding and head on every rank."""
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "8", "-m",
         "k8s_device_plugin_tpu_torch.models.transformer_tp", "--smoke",
         "--device", "cpu", "--steps", "2", "--batch", "8",
         "--microbatches", "2", "--dp", "2", "--tp", "2", "--chunks", "2",
         "--fuse-update"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    text = out.stdout
    assert ("lm-train-pp-tp: mesh {'dp': 2, 'pp': 2, 'tp': 2} config "
            "layers=4 embed=64 chunks=2 fused=True") in text
    first = float(re.search(r"first step loss=([\d.]+)", text).group(1))
    final = float(re.search(r"lm-train-pp-tp: 2 steps wall=\S+ "
                            r"tokens/s=\d+ loss=([\d.]+)", text).group(1))
    assert np.isfinite(final) and final < first
    digests = re.findall(r"rank \d+ embed\+head sha256=([0-9a-f]{64})", text)
    assert len(digests) == 8 and len(set(digests)) == 1
