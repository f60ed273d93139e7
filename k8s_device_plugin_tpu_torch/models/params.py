"""Carry parameters between the reference's flax tree and the port's
DecoderLM, both ways.

``params_from_jax(tree, config, param_dtype=None)`` takes the tree that
``k8s_device_plugin_tpu.models.transformer.init_params`` returns (or a
restored checkpoint's), with numpy arrays as leaves, and returns a
``state_dict`` for ``k8s_device_plugin_tpu_torch.models.transformer.
DecoderLM``; ``params_to_jax(state_dict, config)`` is the inverse (the
tests compare gradients in the reference's layout with it). The mapping
is reshapes only:

- DenseGeneral q/k/v kernels ``[E, H, D]`` -> ``[E, H*D]``, biases
  ``[H, D]`` -> ``[H*D]``; the o kernel ``[H, D, E]`` -> ``[H*D, E]``.
- Dense kernels stay ``[in, out]``.
- ``embed.embedding`` / ``pos_embed.embedding`` stay ``[rows, E]``.
- Norm ``scale`` / ``bias`` stay float32; ``lm_head.kernel`` is absent
  when ``tie_embeddings`` is set.
- With experts, ``layer{i}/moe/{router/kernel, wi, wo}`` replaces
  ``layer{i}/mlp``: the router kernel stays float32 in both layouts (the
  reference routes in float32), the stacked ``[E, in, out]`` expert
  weights keep their shape.

Projection and embedding weights are cast to ``config.dtype`` for the
serving layout (flax casts them on every call, to the same values) and
kept in ``param_dtype`` (float32) for the training layout
(``DecoderLM(config, param_dtype=torch.float32)``).

The port's checkpoint directory (``save_checkpoint`` /
``load_checkpoint``; ``LMServer(checkpoint=)`` and ``llm-serve
--checkpoint`` read it):

- ``lm_config.json``: ``LMConfig.to_json_dict``, the file the
  reference's tools/convert_hf.py writes;
- ``torch_params.pt``: a DecoderLM state_dict in the training layout
  (float32, nothing rounded), loaded with ``weights_only=True``; a
  serving model's ``load_state_dict`` casts the projections to
  ``config.dtype``, to the values ``params_from_jax`` gives;
- the tokenizer files when there are any (``vocab.json`` +
  ``merges.txt``, or ``tokenizer.json``).

Its own file name lets one directory hold the reference's orbax
``params/`` beside it; tools/orbax_to_torch.py writes it from one.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from k8s_device_plugin_tpu_torch.models.transformer import LMConfig


def _t(a, dtype) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy()).to(dtype)


def params_from_jax(tree: dict, config: LMConfig, param_dtype=None) -> dict:
    """flax param tree (numpy leaves) -> DecoderLM state_dict, weights in
    ``param_dtype`` (None: ``config.dtype``, the serving layout)."""
    dt = param_dtype or config.dtype
    sd: dict[str, torch.Tensor] = {}

    def dense(prefix, node, flatten_in=False):
        k = np.asarray(node["kernel"])
        if flatten_in:                       # wo: [H, D, E] -> [H*D, E]
            k = k.reshape(-1, k.shape[-1])
        else:                                # [E, ...] -> [E, prod(...)]
            k = k.reshape(k.shape[0], -1)
        sd[f"{prefix}.kernel"] = _t(k, dt)
        if "bias" in node:
            sd[f"{prefix}.bias"] = _t(np.asarray(node["bias"]).reshape(-1), dt)

    def norm(prefix, node):
        sd[f"{prefix}.scale"] = _t(node["scale"], torch.float32)
        if "bias" in node:
            sd[f"{prefix}.bias"] = _t(node["bias"], torch.float32)

    sd["embed"] = _t(tree["embed"]["embedding"], dt)
    if config.position == "learned":
        sd["pos_embed"] = _t(tree["pos_embed"]["embedding"], dt)
    for i in range(config.num_layers):
        layer = tree[f"layer{i}"]
        p = f"layers.{i}"
        for name in ("wq", "wk", "wv"):
            dense(f"{p}.attn.{name}", layer["attn"][name])
        dense(f"{p}.attn.wo", layer["attn"]["wo"], flatten_in=True)
        if config.num_experts > 0:
            moe = layer["moe"]
            sd[f"{p}.moe.router.kernel"] = _t(moe["router"]["kernel"],
                                              torch.float32)
            sd[f"{p}.moe.wi"] = _t(moe["wi"], dt)
            sd[f"{p}.moe.wo"] = _t(moe["wo"], dt)
        else:
            for name in _dense_names(config):
                dense(f"{p}.mlp.{name}", layer["mlp"][name])
        norm(f"{p}.ln1", layer["ln1"])
        norm(f"{p}.ln2", layer["ln2"])
    norm("ln_f", tree["ln_f"])
    if not config.tie_embeddings:
        dense("lm_head", tree["lm_head"])
    return sd


def _dense_names(config: LMConfig) -> tuple[str, ...]:
    return ("wi", "wg", "down_proj") if config.mlp_act == "swiglu" \
        else ("wi", "down_proj")


def params_to_jax(state_dict: dict, config: LMConfig) -> dict:
    """DecoderLM state_dict (either layout, or any tensors of the same
    names and shapes, such as gradients) -> flax param tree with float32
    numpy leaves, the inverse of ``params_from_jax``."""
    hd = config.head_dim

    def arr(name):
        return state_dict[name].detach().float().cpu().numpy()

    def dense(prefix, heads=None, out_heads=False):
        node = {}
        k = arr(f"{prefix}.kernel")
        if out_heads:                        # wo: [H*D, E] -> [H, D, E]
            k = k.reshape(-1, hd, k.shape[-1])
        elif heads is not None:              # q/k/v: [E, H*D] -> [E, H, D]
            k = k.reshape(k.shape[0], heads, hd)
        node["kernel"] = k
        if f"{prefix}.bias" in state_dict:
            b = arr(f"{prefix}.bias")
            node["bias"] = b.reshape(heads, hd) if heads is not None else b
        return node

    def norm(prefix):
        node = {"scale": arr(f"{prefix}.scale")}
        if f"{prefix}.bias" in state_dict:
            node["bias"] = arr(f"{prefix}.bias")
        return node

    tree = {"embed": {"embedding": arr("embed")}}
    if config.position == "learned":
        tree["pos_embed"] = {"embedding": arr("pos_embed")}
    for i in range(config.num_layers):
        p = f"layers.{i}"
        attn = {
            "wq": dense(f"{p}.attn.wq", config.num_heads),
            "wk": dense(f"{p}.attn.wk", config.kv_heads),
            "wv": dense(f"{p}.attn.wv", config.kv_heads),
            "wo": dense(f"{p}.attn.wo", out_heads=True),
        }
        tree[f"layer{i}"] = {"attn": attn,
                             "ln1": norm(f"{p}.ln1"), "ln2": norm(f"{p}.ln2")}
        if config.num_experts > 0:
            tree[f"layer{i}"]["moe"] = {
                "router": {"kernel": arr(f"{p}.moe.router.kernel")},
                "wi": arr(f"{p}.moe.wi"), "wo": arr(f"{p}.moe.wo")}
        else:
            tree[f"layer{i}"]["mlp"] = {
                name: dense(f"{p}.mlp.{name}") for name in _dense_names(config)}
    tree["ln_f"] = norm("ln_f")
    if not config.tie_embeddings:
        tree["lm_head"] = dense("lm_head")
    return tree


CONFIG_FILE = "lm_config.json"
PARAMS_FILE = "torch_params.pt"
TOKENIZER_FILES = ("vocab.json", "merges.txt", "tokenizer.json")


def save_checkpoint(out_dir: str, config: LMConfig, state_dict: dict) -> str:
    """Write ``config`` and ``state_dict`` (float32 on the CPU, whatever
    their dtype and device) as the port's checkpoint directory; the
    weights go under a temporary name first and are renamed, so a
    reader never sees half a file. Returns the weights' path."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, CONFIG_FILE), "w") as f:
        json.dump(config.to_json_dict(), f, indent=2)
    path = os.path.join(out_dir, PARAMS_FILE)
    tmp = path + ".tmp"
    torch.save({k: v.detach().to("cpu", torch.float32).contiguous()
                for k, v in state_dict.items()}, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(ckpt_dir: str):
    """(LMConfig from ``lm_config.json`` or None without one, the
    float32 state_dict of ``torch_params.pt``). A directory without
    the weights file raises ``ValueError``: an orbax ``params/`` is
    converted by tools/orbax_to_torch.py, never replaced by random
    weights."""
    path = os.path.join(ckpt_dir, PARAMS_FILE)
    if not os.path.exists(path):
        found = ("an orbax params/ tree"
                 if os.path.isdir(os.path.join(ckpt_dir, "params"))
                 else "no weights")
        raise ValueError(
            f"checkpoint {ckpt_dir!r} holds {found}, not {PARAMS_FILE}: "
            f"convert it with `python tools/orbax_to_torch.py "
            f"--checkpoint {ckpt_dir}`"
        )
    config = None
    cfg_path = os.path.join(ckpt_dir, CONFIG_FILE)
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            config = LMConfig.from_json_dict(json.load(f))
    state = torch.load(path, map_location="cpu", weights_only=True,
                       mmap=True)
    return config, state
