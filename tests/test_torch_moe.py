"""The port's switch-MoE layers against the JAX reference's, on the CPU.

Parameters come from the reference's init and are carried over by
models/params.py; inputs and tokens come from numpy with a seed. In
float32:

- ``MoELayer``: output and aux loss within atol 1e-5, gradients of the
  weights and the input within 1e-4;
- ``DecoderLM`` at a small MoE config (4 experts): logits within atol
  1e-4, identical greedy tokens;
- ``loss_fn`` with the aux loss, fused and chunked, within rtol 1e-5,
  and its gradients within 1e-4;
- ``LMServer.complete_batch`` and the paged ``ContinuousBatcher`` with
  experts: tokens identical to the reference server's;
- ``params_from_jax`` / ``params_to_jax``, the port's checkpoint
  directory and tools/orbax_to_torch.py carry ``layer{i}/moe``;
- the self-draft shares the target's MoE blocks; the trainer and the
  daemon take ``--experts``.

In bfloat16 the router stays float32 (weights, input cast and logits): a
near-tie between two experts routes as the reference's does.
"""

import dataclasses
import functools
import json
import os
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.models import moe as jmoe
from k8s_device_plugin_tpu.models import serve as jserve
from k8s_device_plugin_tpu.models import transformer as jt
from k8s_device_plugin_tpu_torch.models import moe as tmoe
from k8s_device_plugin_tpu_torch.models import params as tparams
from k8s_device_plugin_tpu_torch.models import serve_http
from k8s_device_plugin_tpu_torch.models import train as ttrain
from k8s_device_plugin_tpu_torch.models import transformer as tt
from k8s_device_plugin_tpu_torch.models.serve import (
    ContinuousBatcher,
    LMServer,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_KW = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=32,
           mlp_dim=64, max_seq_len=64, num_experts=4)
JOBS = [([5, 17, 99], 7), ([7, 3, 42, 11], 12), ([1], 4), ([88, 2], 9)]
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _moe_pair(dtype=jnp.float32, tdtype=torch.float32, experts=4):
    """(reference module, its params as numpy, port layer in the
    training layout holding them)."""
    jcfg = jmoe.MoEConfig(num_experts=experts, embed_dim=32, mlp_dim=48,
                          dtype=dtype)
    jm = jmoe.MoELayer(jcfg)
    params = jax.tree_util.tree_map(np.array, jm.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 4, 32), jnp.float32))["params"])
    layer = tmoe.MoELayer(
        tmoe.MoEConfig(num_experts=experts, embed_dim=32, mlp_dim=48,
                       dtype=tdtype), param_dtype=torch.float32)
    with torch.no_grad():
        layer.router.kernel.copy_(torch.from_numpy(
            params["router"]["kernel"]))
        layer.wi.copy_(torch.from_numpy(params["wi"]))
        layer.wo.copy_(torch.from_numpy(params["wo"]))
    return jm, params, layer


def _x(shape=(2, 8, 32), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_moe_layer_output_and_aux_match_reference():
    jm, params, layer = _moe_pair()
    x = _x()
    want, want_aux = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got, aux = layer(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert abs(aux.item() - float(want_aux)) <= 1e-5
    with torch.no_grad():
        _, none = layer(torch.from_numpy(x), with_aux=False)
    assert none is None


def test_moe_layer_gradients_match_reference():
    jm, params, layer = _moe_pair()
    x = _x(seed=1)
    cot = _x(seed=2)

    def objective(p, xx):
        out, aux = jm.apply({"params": p}, xx)
        return (out * cot).sum() + 0.5 * aux

    (gp, gx) = jax.grad(objective, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = layer(xt)
    ((out * torch.from_numpy(cot)).sum() + 0.5 * aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **GRAD_TOL)
    np.testing.assert_allclose(layer.router.kernel.grad.numpy(),
                               np.asarray(gp["router"]["kernel"]),
                               **GRAD_TOL)
    np.testing.assert_allclose(layer.wi.grad.numpy(), np.asarray(gp["wi"]),
                               **GRAD_TOL)
    np.testing.assert_allclose(layer.wo.grad.numpy(), np.asarray(gp["wo"]),
                               **GRAD_TOL)


def test_bf16_router_stays_float32_and_routes_a_near_tie_alike():
    """Two experts whose router columns differ by 1e-3 of a unit score:
    bfloat16 scores tie on some tokens, float32 ones do not. The port's
    bf16 serving layer keeps the router in float32 (weights, input cast,
    logits), so it routes every token to the expert the reference's bf16
    layer picks and its outputs agree within bf16 rounding; a router
    rounded to bf16 would send the tied tokens to expert 0."""
    jm, params, layer = _moe_pair(jnp.bfloat16, torch.bfloat16, experts=2)
    col = np.random.default_rng(4).standard_normal(32).astype(np.float32)
    kernel = np.stack([col, col * (1 + 1e-3)], axis=1)
    params["router"]["kernel"] = kernel
    with torch.no_grad():
        layer.router.kernel.copy_(torch.from_numpy(kernel))
    x = np.abs(_x(seed=5)) * np.sign(col)      # positive scores
    serve = tmoe.MoELayer(layer.config)        # the serving layout
    assert serve.router.kernel.dtype == torch.float32
    assert serve.wi.dtype == torch.bfloat16
    serve.load_state_dict(layer.state_dict())
    bf_scores = (torch.from_numpy(x).bfloat16()
                 @ torch.from_numpy(kernel).bfloat16()).float()
    fp_scores = torch.from_numpy(x) @ torch.from_numpy(kernel)
    assert (bf_scores[..., 0] == bf_scores[..., 1]).any()
    assert (fp_scores.argmax(-1) == 1).all()
    want, _ = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got, _ = serve(torch.from_numpy(x))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)


def test_is_expert_weight_is_the_reference_rule():
    for path, shape in (("layer0/moe/wi", (4, 8, 16)),
                        ("layer0/moe/wo", (4, 16, 8)),
                        ("layer0/attn/wo/kernel", (4, 8, 32)),
                        ("wi", (2, 3)), ("layer1/moe/router/kernel", (8, 4))):
        leaf = np.zeros(shape)
        assert tmoe.is_expert_weight(path, torch.zeros(shape)) == \
            jmoe.is_expert_weight(path, leaf)


@functools.lru_cache(maxsize=None)
def _lm_pair():
    """(reference config, port config, reference params as numpy)."""
    cj = jt.LMConfig(**_KW, dtype=jnp.float32)
    ct = tt.LMConfig(**_KW, dtype=torch.float32)
    params = jax.jit(lambda rng: jt.DecoderLM(cj).init(
        rng, jnp.zeros((1, 8), jnp.int32))["params"])(jax.random.PRNGKey(0))
    return cj, ct, jax.tree_util.tree_map(np.asarray, params)


def _tokens(seed=0, shape=(2, 16)):
    return np.random.default_rng(seed).integers(0, _KW["vocab_size"], shape)


def test_decoder_logits_and_greedy_tokens_match_reference():
    cj, ct, tree = _lm_pair()
    model = tt.DecoderLM(ct)
    model.load_state_dict(tparams.params_from_jax(tree, ct))
    assert all(hasattr(b, "moe") and not hasattr(b, "mlp")
               for b in model.layers)
    toks = _tokens()
    want = np.asarray(jt.DecoderLM(cj).apply({"params": tree},
                                             jnp.asarray(toks)))
    with torch.no_grad():
        got = model(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("loss_chunks", [0, 4])
def test_loss_with_aux_and_grads_match_reference(loss_chunks):
    cj, ct, tree = _lm_pair()
    toks = _tokens(seed=1)
    want_loss, want_grads = jax.jit(jax.value_and_grad(functools.partial(
        jt.loss_fn, config=cj, loss_chunks=loss_chunks)))(
            tree, jnp.asarray(toks))
    model = tt.DecoderLM(ct, param_dtype=torch.float32)
    model.load_state_dict(tparams.params_from_jax(tree, ct, torch.float32))
    loss = tt.loss_fn(model, torch.from_numpy(toks), loss_chunks)
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    # The aux term is in: the loss without it is lower by weight x aux.
    with torch.no_grad():
        aux = []
        model(torch.from_numpy(toks), aux=aux)
    assert len(aux) == ct.num_layers
    assert ct.aux_loss_weight * float(sum(aux)) > 1e-3
    loss.backward()
    grads = tparams.params_to_jax(
        {n: p.grad for n, p in model.named_parameters()}, ct)
    flat_w = jax.tree_util.tree_flatten_with_path(want_grads)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(grads)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_params_round_trip_and_checkpoint_directory(tmp_path):
    cj, ct, tree = _lm_pair()
    sd = tparams.params_from_jax(tree, ct, torch.float32)
    assert {"layers.0.moe.router.kernel", "layers.0.moe.wi",
            "layers.0.moe.wo"} <= set(sd)
    assert not any(".mlp." in k for k in sd)
    back = tparams.params_to_jax(sd, ct)
    flat_w = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (_, w), (_, g) in zip(flat_w, flat_g):
        np.testing.assert_array_equal(g, w)
    # bf16 serving layout: experts cast, the router kept float32
    bf = dataclasses.replace(ct, dtype=torch.bfloat16)
    served = tparams.params_from_jax(tree, bf)
    assert served["layers.1.moe.router.kernel"].dtype == torch.float32
    assert served["layers.1.moe.wi"].dtype == torch.bfloat16
    d = str(tmp_path / "ckpt")
    tparams.save_checkpoint(d, ct, sd)
    cfg, state = tparams.load_checkpoint(d)
    assert cfg == ct and cfg.num_experts == 4
    for k, v in sd.items():
        assert torch.equal(state[k], v)


def test_orbax_checkpoint_with_experts_converts(tmp_path):
    import orbax.checkpoint as ocp

    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import orbax_to_torch
    finally:
        sys.path.pop(0)
    cj, ct, tree = _lm_pair()
    d = tmp_path / "ref"
    d.mkdir()
    (d / "lm_config.json").write_text(json.dumps(cj.to_json_dict()))
    ocp.StandardCheckpointer().save(str(d / "params"), tree)
    ocp.StandardCheckpointer().wait_until_finished()
    orbax_to_torch.convert(str(d))
    cfg, state = tparams.load_checkpoint(str(d))
    assert cfg.num_experts == 4
    want = tparams.params_from_jax(tree, ct, torch.float32)
    assert set(state) == set(want)
    for k, v in want.items():
        assert torch.equal(state[k], v), k


@pytest.fixture(scope="module")
def servers():
    cj, ct, _ = _lm_pair()
    jsrv = jserve.LMServer(config=cj)
    tsrv = LMServer(config=ct, device="cpu", params=tparams.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jsrv.params), ct))
    return jsrv, tsrv


def test_complete_batch_with_experts_matches_reference(servers):
    jsrv, tsrv = servers
    prompts, budgets = [p for p, _ in JOBS], [n for _, n in JOBS]
    jo, jl, _ = jsrv.complete_batch(prompts, budgets, return_logprobs=True)
    to, tl, _ = tsrv.complete_batch(prompts, budgets, return_logprobs=True)
    assert to == jo
    for g, w in zip(tl, jl):
        np.testing.assert_allclose(g, w, atol=1e-4)


def _paged_tokens(batcher):
    reqs = [batcher.submit_async(p, n) for p, n in JOBS]
    out = [batcher.wait(r, timeout=120)[0] for r in reqs]
    assert batcher.drain(timeout=30)
    return out


def test_paged_batcher_with_experts_matches_reference(servers):
    jsrv, tsrv = servers
    kw = dict(max_batch=2, segment_tokens=4, kv_mode="paged",
              page_tokens=8, prefill_chunk=16)
    want = _paged_tokens(jserve.ContinuousBatcher(jsrv, **kw))
    got = _paged_tokens(ContinuousBatcher(tsrv, **kw))
    assert got == want
    assert got == [tsrv.complete(p, n)[0] for p, n in JOBS]


def test_self_draft_shares_the_moe_blocks(servers):
    _, tsrv = servers
    tsrv.enable_draft(1, k=3)
    try:
        assert tsrv.draft_model.layers[0] is tsrv.model.layers[0]
        assert tsrv.draft_model.layers[0].moe.wi is \
            tsrv.model.layers[0].moe.wi
        prompts, budgets = [p for p, _ in JOBS], [n for _, n in JOBS]
        got, _ = tsrv.complete_batch_spec(prompts, budgets)
        assert got == tsrv.complete_batch(prompts, budgets)[0]
    finally:
        tsrv.spec_k = tsrv.draft_model = tsrv.draft_config = None


def test_trainer_takes_experts(caplog):
    caplog.set_level("INFO", logger="tpu-train")
    assert ttrain.main(["--tiny", "--device", "cpu", "--steps", "2",
                        "--batch-size", "2", "--experts", "2"]) == 0
    assert any("done: 2 steps" in r.message for r in caplog.records)


def test_daemon_serves_with_experts():
    ready = threading.Event()
    handle = {}

    def on_ready(httpd, batcher):
        handle["httpd"] = httpd
        handle["cfg"] = batcher.server.config
        ready.set()

    daemon = threading.Thread(target=lambda: serve_http.main(
        ["--tiny", "--experts", "2", "--device", "cpu", "--port", "0",
         "--max-batch", "2", "--segment-tokens", "4", "--no-warmup"],
        on_ready=on_ready), daemon=True)
    daemon.start()
    assert ready.wait(120), "daemon did not come up"
    try:
        assert handle["cfg"] == tt.LMConfig.tiny(num_experts=2)
        port = handle["httpd"].server_address[1]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/completions",
            data=json.dumps({"prompt": "hello", "max_tokens": 4}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            doc = json.loads(resp.read())
        assert doc["usage"]["completion_tokens"] == 4
    finally:
        handle["httpd"].shutdown()
        daemon.join(timeout=60)
