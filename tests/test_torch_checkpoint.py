"""Serving from a checkpoint directory: the port against the reference.

Tiny GPT-2, Llama (GQA) and Qwen2 (q/k/v biases) models are built by
``transformers`` from config objects (no download), as
tests/test_hf_convert.py builds them, mapped by tools/convert_hf.py's
``gpt2_to_lm`` / ``llama_to_lm``, saved by its ``save`` (orbax), and
converted by tools/orbax_to_torch.py into the same directory. Then the
port's ``LMServer(checkpoint=, device="cpu")`` and the reference's
``LMServer(checkpoint=)`` read that one directory: greedy tokens
identical, logits within the reference test's tolerance of the
``transformers`` forward. Also: a BPE tokenizer directory carried across,
the orbax-only and vocab ``ValueError``s, the float32 round trip of
``save_checkpoint`` / ``load_checkpoint``, the bfloat16 cast against
params.py's serving map, and ``--checkpoint`` through the CLI.
"""

import ast
import json
import os
import shutil
import threading
import urllib.request
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from k8s_device_plugin_tpu.models import serve as jserve  # noqa: E402
from k8s_device_plugin_tpu.models import transformer as jt  # noqa: E402
from k8s_device_plugin_tpu_torch.models import params as tparams  # noqa: E402
from k8s_device_plugin_tpu_torch.models import serve_http  # noqa: E402
from k8s_device_plugin_tpu_torch.models import transformer as tt  # noqa: E402
from k8s_device_plugin_tpu_torch.models.serve import LMServer  # noqa: E402
from k8s_device_plugin_tpu_torch.models.tokenizer import (  # noqa: E402
    BPETokenizer,
)
from tools import orbax_to_torch  # noqa: E402
from tools.convert_hf import gpt2_to_lm, llama_to_lm, save  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("gpt2", "llama", "qwen2")
PROMPTS = [list(range(1, 9)), [5, 17, 60, 3], [7]]
BUDGETS = [6, 10, 4]
SMALL = dict(vocab_size=512, num_layers=2, num_heads=4, embed_dim=32,
             mlp_dim=64, max_seq_len=64)


def _hf_model(family):
    torch.manual_seed(0)
    if family == "gpt2":
        cfg = transformers.GPT2Config(
            vocab_size=96, n_positions=32, n_embd=32, n_layer=2, n_head=4)
        return transformers.GPT2LMHeadModel(cfg).eval(), gpt2_to_lm
    kw = dict(vocab_size=96, hidden_size=32, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=32)
    if family == "llama":
        model = transformers.LlamaForCausalLM(
            transformers.LlamaConfig(**kw, rope_theta=10000.0))
    else:
        model = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(**kw))
    return model.eval(), llama_to_lm


@pytest.fixture(scope="module", params=FAMILIES)
def family(request, tmp_path_factory):
    """One converted directory and one server of each package per
    family."""
    hf, to_lm = _hf_model(request.param)
    config, params = to_lm(hf.state_dict(), hf.config)
    ckpt = str(tmp_path_factory.mktemp(request.param) / "ckpt")
    save(config, params, ckpt)
    assert orbax_to_torch.main(["--checkpoint", ckpt]) == 0
    return SimpleNamespace(
        name=request.param, hf=hf, dir=ckpt,
        jsrv=jserve.LMServer(checkpoint=ckpt),
        tsrv=LMServer(checkpoint=ckpt, device="cpu"))


def test_one_directory_holds_both_formats(family):
    names = set(os.listdir(family.dir))
    assert {"params", "lm_config.json", "torch_params.pt"} <= names
    assert not any(n.endswith(".tmp") for n in names)
    with open(os.path.join(family.dir, "lm_config.json")) as f:
        want = json.load(f)
    assert family.tsrv.config.to_json_dict() == want
    assert family.tsrv.config.dtype == torch.float32


def test_greedy_tokens_equal_the_reference(family):
    want, _ = family.jsrv.complete_batch(PROMPTS, BUDGETS)
    got, _ = family.tsrv.complete_batch(PROMPTS, BUDGETS)
    assert got == want
    # ... and the transformers model's own greedy continuation
    prompt = PROMPTS[0]
    cur = list(prompt)
    for _ in range(BUDGETS[0]):
        with torch.no_grad():
            logits = family.hf(torch.tensor([cur])).logits
        cur.append(int(logits[0, -1].argmax()))
    assert got[0] == cur


def test_logits_match_transformers(family):
    cfg = family.tsrv.config
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, cfg.max_seq_len))
    with torch.no_grad():
        want = family.hf(torch.from_numpy(tokens)).logits.numpy()
        got = family.tsrv.model(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


def test_special_tokens_carried(family):
    assert family.tsrv.eos_id == family.jsrv.eos_id
    assert family.tsrv.config.bos_token_id == \
        family.jsrv.config.bos_token_id
    for text in ("hi", "hello there"):
        assert family.tsrv.encode_prompt(text) == \
            family.jsrv.encode_prompt(text)


def _bpe_files(d):
    """vocab.json + merges.txt of tests/test_tokenizer.py's bpe_dir."""
    from test_tokenizer import TRAIN_TEXT, train_tiny_bpe

    vocab, merges = train_tiny_bpe(TRAIN_TEXT, 120)
    vocab.setdefault("<|endoftext|>", len(vocab))
    with open(os.path.join(d, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(d, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")
    return len(vocab)


def _reference_checkpoint(d, **kw):
    """A reference checkpoint of random weights (convert_hf's save)."""
    config = jt.LMConfig(**dict(SMALL, **kw), dtype=jnp.float32)
    save(config, jt.init_params(jax.random.PRNGKey(3), config), d)
    return config


def test_bpe_tokenizer_carried_across(tmp_path):
    src, out = str(tmp_path / "ref"), str(tmp_path / "port")
    _reference_checkpoint(src)
    assert _bpe_files(src) <= SMALL["vocab_size"]
    assert orbax_to_torch.main(["--checkpoint", src, "--out", out]) == 0
    assert {"vocab.json", "merges.txt", "lm_config.json",
            "torch_params.pt"} == set(os.listdir(out))
    jsrv = jserve.LMServer(checkpoint=src)
    tsrv = LMServer(checkpoint=out, device="cpu")
    assert isinstance(tsrv.tokenizer, BPETokenizer)
    for text in ("the quick brown fox", "hello world", "x"):
        assert tsrv.encode_prompt(text) == jsrv.encode_prompt(text)
    prompt = tsrv.encode_prompt("the quick brown fox")
    assert tsrv.complete(prompt, 6)[0] == jsrv.complete(prompt, 6)[0]


def test_orbax_only_directory_raises_naming_the_converter(tmp_path):
    d = str(tmp_path / "ref")
    _reference_checkpoint(d)
    with pytest.raises(ValueError, match="orbax params/ tree.*"
                       "tools/orbax_to_torch.py"):
        LMServer(checkpoint=d, device="cpu")
    # nothing at all: the same refusal, never random weights
    with pytest.raises(ValueError, match="no weights.*orbax_to_torch"):
        LMServer(checkpoint=str(tmp_path), device="cpu")


def test_tokenizer_vocab_error_matches_reference(tmp_path):
    d = str(tmp_path / "small")
    config = tt.LMConfig(**dict(SMALL, vocab_size=128),
                         dtype=torch.float32)
    tparams.save_checkpoint(
        d, config, tt.DecoderLM(config, param_dtype=torch.float32)
        .state_dict())
    assert _bpe_files(d) > 128
    with pytest.raises(ValueError) as port:
        LMServer(checkpoint=d, device="cpu")
    with pytest.raises(ValueError) as ref:
        jserve.LMServer(checkpoint=d)
    assert str(port.value) == str(ref.value)
    assert "exceeds model vocab 128" in str(port.value)


def _random_state(config, seed=0):
    model = tt.DecoderLM(config, param_dtype=torch.float32)
    return tt.init_params(model, seed=seed).state_dict()


def test_save_load_round_trip_is_bit_equal(tmp_path):
    config = tt.LMConfig(**SMALL, num_kv_heads=2, position="rope",
                         mlp_act="swiglu", eos_token_id=2, bos_token_id=1)
    state = _random_state(config)
    state["layers.0.ln1.scale"] = torch.rand_like(
        state["layers.0.ln1.scale"])
    d = str(tmp_path / "ckpt")
    path = tparams.save_checkpoint(d, config, state)
    assert sorted(os.listdir(d)) == ["lm_config.json", "torch_params.pt"]
    got_config, got = tparams.load_checkpoint(d)
    assert got_config == config
    assert got.keys() == state.keys()
    for k, v in state.items():
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], v), k
    assert os.path.getsize(path) >= 4 * sum(v.numel()
                                            for v in state.values())


def test_bf16_cast_equals_the_serving_map(tmp_path):
    """fp32 weights on disk, cast by the serving model's load_state_dict,
    equal params.py's serving layout (config.dtype) bit for bit."""
    jconfig = jt.LMConfig(**SMALL, num_kv_heads=2, position="rope",
                          mlp_act="swiglu", qkv_bias=True)
    tree = jax.tree_util.tree_map(
        np.asarray, jt.init_params(jax.random.PRNGKey(5), jconfig))
    config = tt.LMConfig.from_json_dict(jconfig.to_json_dict())
    assert config.dtype == torch.bfloat16
    d = str(tmp_path / "ckpt")
    tparams.save_checkpoint(d, config, tparams.params_from_jax(
        tree, config, param_dtype=torch.float32))
    loaded = LMServer(checkpoint=d, device="cpu").model.state_dict()
    serving = tparams.params_from_jax(tree, config)
    assert loaded.keys() == serving.keys()
    cast = 0
    for k, v in serving.items():
        assert loaded[k].dtype == v.dtype, k
        assert torch.equal(loaded[k], v), k
        cast += v.dtype == torch.bfloat16
    assert cast > 0


def test_explicit_config_wins_and_must_fit(tmp_path):
    """An explicit config wins over lm_config.json (as the reference's);
    the weights must then fit it exactly (strict load)."""
    config = tt.LMConfig(**SMALL, dtype=torch.float32)
    d = str(tmp_path / "ckpt")
    tparams.save_checkpoint(d, config, _random_state(config))
    srv = LMServer(config=tt.LMConfig(**SMALL, dtype=torch.bfloat16),
                   checkpoint=d, device="cpu")
    assert srv.config.dtype == torch.bfloat16
    with pytest.raises(RuntimeError, match="size mismatch"):
        LMServer(config=tt.LMConfig(**dict(SMALL, mlp_dim=32)),
                 checkpoint=d, device="cpu")


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


@pytest.mark.parametrize("batching", ["continuous", "static"])
def test_checkpoint_flag_through_the_cli(tmp_path, batching):
    """``llm-serve --checkpoint`` of a converted Llama directory: the
    daemon's config, tokenizer, eos and weights are the checkpoint's, and
    its completion is the reference server's from the same directory."""
    hf, _ = _hf_model("llama")
    config, params = llama_to_lm(hf.state_dict(), hf.config)
    d = str(tmp_path / "ckpt")
    save(config, params, d)
    orbax_to_torch.convert(d)
    jsrv = jserve.LMServer(checkpoint=d)
    ready, handle, rc = threading.Event(), {}, {}

    def on_ready(httpd, batcher):
        handle["httpd"], handle["batcher"] = httpd, batcher
        ready.set()

    daemon = threading.Thread(target=lambda: rc.setdefault(
        "rc", serve_http.main(
            ["--checkpoint", d, "--device", "cpu", "--port", "0",
             "--max-batch", "2", "--segment-tokens", "4", "--batching",
             batching, "--warmup-tokens", "6"], on_ready=on_ready)),
        daemon=True)
    daemon.start()
    assert ready.wait(120), "daemon did not come up"
    try:
        srv = handle["batcher"].server
        assert srv.config == tt.LMConfig.from_json_dict(
            jsrv.config.to_json_dict())
        assert srv.eos_id == jsrv.eos_id
        # bytes below the model's 96 ids
        code, body = _post(handle["httpd"].server_address[1],
                           {"prompt": "ABC", "max_tokens": 6})
        assert code == 200
        ids = jsrv.encode_prompt("ABC")
        want = jsrv.complete(ids, 6)[0][len(ids):]
        assert body["usage"]["completion_tokens"] == len(want)
        assert body["choices"][0]["text"] == srv.tokenizer.decode(want)
    finally:
        handle["httpd"].shutdown()
        daemon.join(timeout=60)
    assert not daemon.is_alive() and rc["rc"] == 0


def test_only_the_converter_imports_both_packages():
    """tools/orbax_to_torch.py is the one module of tools/ that imports
    the reference and the port (the port imports neither JAX nor the
    reference: tests/test_torch_isolation.py)."""
    both = []
    for name in sorted(os.listdir(os.path.join(REPO, "tools"))):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(REPO, "tools", name)) as f:
            tree = ast.parse(f.read())
        roots = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                roots.add(node.module.split(".")[0])
        if {"k8s_device_plugin_tpu", "k8s_device_plugin_tpu_torch"} <= roots:
            both.append(name)
    assert both == ["orbax_to_torch.py"]


def test_converter_writes_nothing_but_the_port_files(tmp_path):
    """The converter adds torch_params.pt and leaves the reference's
    files as they were (one directory, both daemons)."""
    d = str(tmp_path / "ref")
    _reference_checkpoint(d)
    before = {n: os.path.getmtime(os.path.join(d, n))
              for n in os.listdir(d) if n != "lm_config.json"}
    shutil.copy(os.path.join(d, "lm_config.json"), tmp_path / "cfg.json")
    orbax_to_torch.convert(d)
    assert set(os.listdir(d)) == set(before) | {"lm_config.json",
                                                "torch_params.pt"}
    for n, t in before.items():
        assert os.path.getmtime(os.path.join(d, n)) == t
    with open(tmp_path / "cfg.json") as a, \
            open(os.path.join(d, "lm_config.json")) as b:
        assert json.load(a) == json.load(b)
