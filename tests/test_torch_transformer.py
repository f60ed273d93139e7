"""The port's DecoderLM against the JAX reference's, parameters carried
over by models/params.py.

Full-sequence logits and the cached path (a padded prefill, the index
rewound to per-row lengths, then single-token steps) at three configs:
the reference's tiny one, a Llama-class one (rope, GQA, swiglu,
qkv_bias) and a GPT-2-class one (layernorm, biases, tied embeddings).
Tokens come from numpy with a seed. Tolerances: float32 atol 1e-4 (the
frameworks sum in other orders); bfloat16 atol 0.1 / rtol 0.05, the
reference's own bf16 bar (tests/test_paged_attention.py), since the two
round at other places.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.models import transformer as jt
from k8s_device_plugin_tpu_torch.models import transformer as tt
from k8s_device_plugin_tpu_torch.models.params import params_from_jax

_SMALL = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=32,
              mlp_dim=64, max_seq_len=64)
CONFIGS = {
    "tiny": {},
    "llama": dict(_SMALL, position="rope", num_kv_heads=2,
                  mlp_act="swiglu", qkv_bias=True),
    "gpt2": dict(_SMALL, norm="layernorm", use_bias=True,
                 tie_embeddings=True, norm_eps=1e-5),
}
DTYPES = {"float32": (jnp.float32, torch.float32, dict(atol=1e-4, rtol=0)),
          "bfloat16": (jnp.bfloat16, torch.bfloat16,
                       dict(atol=0.1, rtol=0.05))}


@functools.lru_cache(maxsize=None)
def _pair(name, dtype):
    """(jax config, port config, flax params, port model, tolerance),
    built once per module (jitted init: the params do not depend on the
    token shape it traces with)."""
    jd, td, tol = DTYPES[dtype]
    kw = CONFIGS[name]
    if kw:
        cj, ct = jt.LMConfig(**kw, dtype=jd), tt.LMConfig(**kw, dtype=td)
    else:
        cj = dataclasses.replace(jt.LMConfig.tiny(), dtype=jd)
        ct = dataclasses.replace(tt.LMConfig.tiny(), dtype=td)
    params = jax.jit(lambda rng: jt.DecoderLM(cj).init(
        rng, jnp.zeros((1, 8), jnp.int32))["params"])(jax.random.PRNGKey(0))
    model = tt.DecoderLM(ct)
    model.load_state_dict(
        params_from_jax(jax.tree_util.tree_map(np.asarray, params), ct))
    return cj, ct, params, model, tol


@functools.lru_cache(maxsize=None)
def _jax_decode(cj):
    """Jitted reference prefill and step for config ``cj``."""
    jm = jt.DecoderLM(cj)
    prefill = jax.jit(lambda p, t: jm.apply(
        {"params": p}, t, decode=True, prefill=True, mutable=["cache"]))
    step = jax.jit(lambda p, c, t: jm.apply(
        {"params": p, "cache": c}, t, decode=True, mutable=["cache"]))
    return prefill, step


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_full_sequence_logits_match(name, dtype):
    cj, ct, params, model, tol = _pair(name, dtype)
    toks = np.random.default_rng(0).integers(0, ct.vocab_size, (2, 16))
    want = jax.jit(jt.DecoderLM(cj).apply)({"params": params},
                                           jnp.asarray(toks))
    with torch.no_grad():
        got = model(torch.from_numpy(toks))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_cached_prefill_then_steps_match(name, dtype):
    """Right-padded prefill of unequal prompts, index rewound to the true
    lengths (the padding K/V stays in the cache until overwritten, as in
    serving), then steps at per-row positions."""
    cj, ct, params, model, tol = _pair(name, dtype)
    rng = np.random.default_rng(1)
    lens = np.array([5, 9])
    block = rng.integers(0, ct.vocab_size, (2, 12))
    steps = rng.integers(0, ct.vocab_size, (3, 2, 1))
    prefill, step = _jax_decode(cj)
    logits, var = prefill(params, jnp.asarray(block))
    cache = jt.set_cache_index(var["cache"], jnp.asarray(lens, jnp.int32))
    want = [np.asarray(logits)]
    for s in steps:
        lg, var = step(params, cache, jnp.asarray(s))
        cache = var["cache"]
        want.append(np.asarray(lg))
    pool = tt.new_cache(ct, 2, "cpu")
    with torch.no_grad():
        got = [model(torch.from_numpy(block), pool, prefill=True)]
        pool = tt.set_cache_index(pool, torch.from_numpy(lens))
        for s in steps:
            got.append(model(torch.from_numpy(s), pool))
    assert pool.idx.tolist() == (lens + len(steps)).tolist()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **tol)


def test_learned_positions_clamp_at_table_end():
    """Rows past max_seq_len - 1 reuse the last position row and
    overwrite the cache's last slot, as the reference does."""
    cj, ct, params, model, tol = _pair("tiny", "float32")
    cap = ct.max_seq_len
    lens = np.array([cap - 2, 3])
    prefill, step = _jax_decode(cj)
    _, var = prefill(params, jnp.zeros((2, 4), jnp.int32))
    cache = jt.set_cache_index(var["cache"], jnp.asarray(lens, jnp.int32))
    pool = tt.new_cache(ct, 2, "cpu")
    with torch.no_grad():
        model(torch.zeros((2, 4), dtype=torch.long), pool, prefill=True)
    pool = tt.set_cache_index(pool, torch.from_numpy(lens))
    for t in range(4):
        tok = np.full((2, 1), 7 + t)
        lg, var = step(params, cache, jnp.asarray(tok))
        cache = var["cache"]
        with torch.no_grad():
            got = model(torch.from_numpy(tok), pool)
        np.testing.assert_allclose(got.numpy(), np.asarray(lg), **tol)


def test_gelu_is_the_tanh_approximation():
    """flax's nn.gelu defaults to approximate=True; the port's MLP must
    match it, not the erf form."""
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    assert np.abs(exact.numpy() - want).max() > 1e-5


def test_rms_norm_output_is_float32_under_bf16():
    """RMSNorm multiplies by its fp32 scale after the cast, so its output
    is float32 (the next projection casts back), as in flax."""
    cj, ct, params, model, _ = _pair("tiny", "bfloat16")
    x = torch.ones(1, 2, ct.embed_dim, dtype=torch.bfloat16)
    assert model.layers[0].ln1(x).dtype == torch.float32
    jx = jnp.ones((1, 2, cj.embed_dim), jnp.bfloat16)
    out = jt.RMSNorm(cj.dtype).apply(
        {"params": {"scale": jnp.ones((cj.embed_dim,))}}, jx)
    assert out.dtype == jnp.float32


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_json_round_trips_across_packages(name):
    kw = CONFIGS[name]
    cj = jt.LMConfig(**kw) if kw else jt.LMConfig.tiny()
    ct = tt.LMConfig.from_json_dict(cj.to_json_dict())
    assert ct.to_json_dict() == cj.to_json_dict()
    assert jt.LMConfig.from_json_dict(ct.to_json_dict()) == cj
    assert ct.dtype == torch.bfloat16


def test_moe_config_is_refused(caplog):
    """MoE configs build (switch layers in place of the MLPs;
    tests/test_torch_moe.py holds them to the reference) and shard their
    experts over ``ep`` (tests/test_torch_sharded_train.py); what stays
    refused, as in the reference's trainer, is an expert count that does
    not divide over the ep axis: the log line and exit code 1, before
    anything is built."""
    from k8s_device_plugin_tpu_torch.models import train as ttrain
    from k8s_device_plugin_tpu_torch.parallel.mesh import build_mesh

    model = tt.DecoderLM(tt.LMConfig.tiny(num_experts=2))
    assert all(hasattr(b, "moe") and not hasattr(b, "mlp")
               for b in model.layers)
    assert ttrain.mesh_axes("dp,ep") == ("dp", "ep")
    args = ttrain.build_arg_parser().parse_args(
        ["--tiny", "--device", "cpu", "--experts", "3", "--mesh-axes",
         "dp,ep"])
    mesh = build_mesh(("dp", "ep"), (2, 2), world=4, device="cpu")
    assert ttrain._train(args, mesh) == 1
    assert "--experts 3 is not divisible by the ep mesh axis (2)" \
        in caplog.text
