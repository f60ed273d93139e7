"""The port's pipelined LM trainer (models/transformer_pp.py) against the
reference's.

The reference's ``init_pp_params`` tree (PRNGKey(0)) and tokens
(PRNGKey(1)) at tests/test_transformer_pp.py's config go through the
reference's ``make_pp_train_step`` value_and_grad on conftest's virtual
CPU devices and, carried over by models/params.py ``pp_params_from_jax``,
through the port's on gloo ranks (parallel/workers.py ``pp_train``: one
spawn of 2 ranks and one of 4 for the whole file, in the background
while the reference computes). The loss must agree within atol = rtol =
1e-5 and every gradient (each rank's stage rows, the embedding's and
the head's) within 2e-4, the reference's own tolerances, at S = 2 and
4, dp x pp, a LayerNorm + bias config, interleaved (V = 2) with and
without dp, and the Llama-class config (RoPE, GQA, SwiGLU). A dp layout
is held to the reference's value_and_grad of the same tree without dp
(the reference's own tests hold the two equal). The fused update
(AdamW inside the drain) gives the unfused step's parameters, plain and
interleaved with dp. The refusals are the reference's, and ``main
--smoke --device cpu`` runs under ``torch.distributed.run`` in both
layouts: pp lowered to 2 over 3 ranks (the third idle, exiting 0) and
dp2 x pp2.
"""

import concurrent.futures
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.models import transformer as jt
from k8s_device_plugin_tpu.models import transformer_pp as jpp
from k8s_device_plugin_tpu.parallel import build_mesh
from k8s_device_plugin_tpu_torch.models import params as tparams
from k8s_device_plugin_tpu_torch.models import transformer as tt
from k8s_device_plugin_tpu_torch.models import transformer_pp as tpp
from k8s_device_plugin_tpu_torch.parallel import launch, workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(vocab_size=128, num_layers=4, num_heads=2, embed_dim=32,
            mlp_dim=64, max_seq_len=32)
CONFIGS = {
    "base": BASE,
    "layernorm": dict(BASE, norm="layernorm", use_bias=True),
    "llama": dict(BASE, num_heads=4, num_kv_heads=2, position="rope",
                  mlp_act="swiglu"),
}
# name: (config, axes, shape, microbatches, chunks, fused)
CASES = {
    "s2": ("base", ("pp",), (2,), 4, 1, False),
    "layernorm": ("layernorm", ("pp",), (2,), 2, 1, False),
    "interleaved": ("base", ("pp",), (2,), 4, 2, False),
    "llama": ("llama", ("pp",), (2,), 4, 1, False),
    "fused": ("base", ("pp",), (2,), 4, 1, True),
    "s4": ("base", ("pp",), (4,), 4, 1, False),
    "dp_pp": ("base", ("dp", "pp"), (2, 2), 2, 1, False),
    "interleaved_dp": ("base", ("dp", "pp"), (2, 2), 2, 2, False),
    "fused_interleaved_dp": ("base", ("dp", "pp"), (2, 2), 2, 2, True),
}


def _world(name) -> int:
    return int(np.prod(CASES[name][2]))


def _stages(name) -> int:
    _, axes, shape, *_ = CASES[name]
    return dict(zip(axes, shape))["pp"]


def _jconfig(cfg):
    return jt.LMConfig(**CONFIGS[cfg], dtype=jnp.float32)


def _tconfig(cfg):
    return tt.LMConfig(**CONFIGS[cfg], dtype="float32")


def _reference_tree(name):
    cfg, _, _, _, chunks, _ = CASES[name]
    params = jpp.init_pp_params(jax.random.PRNGKey(0), _jconfig(cfg),
                                _stages(name), chunks)
    tokens = jax.random.randint(jax.random.PRNGKey(1),
                                (8, CONFIGS[cfg]["max_seq_len"]), 0,
                                CONFIGS[cfg]["vocab_size"])
    return (jax.tree_util.tree_map(np.asarray, params), np.asarray(tokens))


def _case(name) -> dict:
    cfg, axes, shape, m, chunks, fused = CASES[name]
    params, tokens = _reference_tree(name)
    whole = tparams.pp_params_from_jax(params, _tconfig(cfg))
    return dict(name=name, trainer="pp", axes=axes, shape=shape,
                config=_tconfig(cfg).to_json_dict(), microbatches=m,
                chunks=chunks, fused=fused, tokens=tokens,
                params={part: {k: v.numpy() for k, v in d.items()}
                        for part, d in whole.items()})


@pytest.fixture(scope="module")
def ranks():
    """{world: [each rank's results]}, spawned in the background."""
    def run():
        return {world: launch.spawn(
            workers.pp_train, world,
            [_case(n) for n in CASES if _world(n) == world], timeout=300)
            for world in (2, 4)}

    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(run)
    yield future
    pool.shutdown(wait=True)


def _got(ranks, name) -> list:
    return [r[name] for r in ranks.result()[_world(name)]]


def _reference(name):
    """The reference's value_and_grad on the case's tree and tokens, on
    the case's pp layout without dp."""
    cfg, _, _, m, chunks, _ = CASES[name]
    S = _stages(name)
    params, tokens = _reference_tree(name)
    mesh = build_mesh(("pp",), (S,), devices=jax.devices()[:S])
    _, _, vg = jpp.make_pp_train_step(mesh, _jconfig(cfg), m,
                                      num_chunks=chunks)
    loss, grads = vg(params, tokens)
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def _assert_rank_grads(name, got, want, cfg):
    rows = {}
    for r in got:
        rows.update(r["rows"])
    assert sorted(rows) == list(range(_stages(name) * CASES[name][4]))
    for row, g in rows.items():
        tree = tparams.block_to_jax(
            {k: torch.from_numpy(v) for k, v in g.items()}, _tconfig(cfg))
        ref = jax.tree_util.tree_map(lambda a: a[row], want["blocks"])
        flat_got = jax.tree_util.tree_leaves_with_path(tree)
        flat_want = jax.tree_util.tree_leaves_with_path(ref)
        assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
        for (path, a), (_, b) in zip(flat_got, flat_want):
            np.testing.assert_allclose(
                a, b, atol=2e-4, rtol=2e-4,
                err_msg=f"{name} row {row} {jax.tree_util.keystr(path)}")
    for r in got:
        for part in ("embed", "head"):
            assert sorted(r[part]) == sorted(want[part])
            for k, g in r[part].items():
                np.testing.assert_allclose(g, want[part][k], atol=2e-4,
                                           rtol=2e-4,
                                           err_msg=f"{name} {part}.{k}")


GRAD_CASES = [n for n in CASES if not CASES[n][5]]


@pytest.mark.parametrize("name", GRAD_CASES)
def test_loss_and_grads_equal_the_references(name, ranks):
    loss, grads = _reference(name)
    got = _got(ranks, name)
    for r in got:
        np.testing.assert_allclose(r["loss"], loss, atol=1e-5, rtol=1e-5)
    _assert_rank_grads(name, got, grads, CASES[name][0])


@pytest.mark.parametrize("name", ["fused", "fused_interleaved_dp"])
def test_fused_update_equals_the_unfused_step(name, ranks):
    got = _got(ranks, name)
    for r in got:
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
    # the step moved the parameters, and every rank holds one embedding
    r0 = got[0]["fused"]
    assert not np.allclose(r0["embed"]["embedding"], _case(name)[
        "params"]["embed"]["embedding"])
    for r in got[1:]:
        np.testing.assert_array_equal(r["fused"]["embed"]["embedding"],
                                      r0["embed"]["embedding"])


def test_tied_embeddings_rejected():
    cfg = tt.LMConfig(vocab_size=64, num_layers=2, num_heads=2,
                      embed_dim=16, mlp_dim=32, max_seq_len=16,
                      tie_embeddings=True)
    with pytest.raises(ValueError, match="tie_embeddings"):
        tpp.init_pp_params(0, cfg, 2, device="cpu")


def test_moe_blocks_rejected():
    cfg = tt.LMConfig(**BASE, num_experts=2)
    with pytest.raises(ValueError, match="MoE"):
        tpp.init_pp_params(0, cfg, 2, device="cpu")


def test_layer_count_must_divide():
    bad = tt.LMConfig(**dict(BASE, num_layers=6))
    with pytest.raises(ValueError, match="not divisible"):
        tpp.init_pp_params(0, bad, 4, device="cpu")


def test_cli_batch_flags_validated():
    with pytest.raises(SystemExit, match="must divide"):
        tpp.validate_cli_batch_flags(8, 3, 1)
    with pytest.raises(SystemExit, match="not divisible over --dp"):
        tpp.validate_cli_batch_flags(8, 4, 4)


def _torchrun(module, nproc, argv, tmp_path):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m", module, "--smoke",
         "--device", "cpu", "--steps", "2", *argv],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout, out.stderr


def _losses(prog, text):
    first = float(re.search(rf"{prog}: first step loss=([\d.]+)",
                            text).group(1))
    final = float(re.search(rf"{prog}: 2 steps wall=\S+ tokens/s=\d+ "
                            rf"loss=([\d.]+)", text).group(1))
    return first, final


@pytest.mark.parametrize("nproc,argv,mesh", [
    (3, ["--batch", "8", "--microbatches", "2"], "{'pp': 2}"),
    (4, ["--batch", "8", "--microbatches", "2", "--dp", "2"],
     "{'dp': 2, 'pp': 2}"),
])
def test_cli_smoke_both_layouts(nproc, argv, mesh, tmp_path):
    """The lm-train-pp pod's entry point under a launcher: the
    reference's lines on rank 0, a falling loss, the same embedding and
    head on every working rank; over 3 ranks pp lowers to 2 (4 layers)
    and the third rank idles and exits 0."""
    out, err = _torchrun("k8s_device_plugin_tpu_torch.models.transformer_pp",
                         nproc, argv, tmp_path)
    assert f"lm-train-pp: mesh {mesh} config layers=4 embed=64" in out
    first, final = _losses("lm-train-pp", out)
    assert np.isfinite(final) and final < first
    digests = re.findall(
        r"lm-train-pp: rank \d+ embed\+head sha256=([0-9a-f]{64})", out)
    assert len(digests) == min(nproc, 4) - (nproc == 3) \
        and len(set(digests)) == 1
    if nproc == 3:
        assert "idle rank" in err
