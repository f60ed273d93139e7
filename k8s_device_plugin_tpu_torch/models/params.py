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


def _dense_from_jax(sd, prefix, node, dt, kind="dense"):
    """One flax Dense / DenseGeneral node (any leading dims) into ``sd``:
    ``kind`` "qkv" ([..., E, H, D] -> [..., E, H*D], bias [..., H, D]
    -> [..., H*D]), "out" ([..., H, D, E] -> [..., H*D, E]) or "dense"
    (kept)."""
    k = np.asarray(node["kernel"])
    if kind == "qkv":
        k = k.reshape(k.shape[:-2] + (-1,))
    elif kind == "out":
        k = k.reshape(k.shape[:-3] + (-1, k.shape[-1]))
    sd[f"{prefix}.kernel"] = _t(k, dt)
    if "bias" in node:
        b = np.asarray(node["bias"])
        if kind == "qkv":
            b = b.reshape(b.shape[:-2] + (-1,))
        sd[f"{prefix}.bias"] = _t(b, dt)


def _norm_from_jax(sd, prefix, node):
    sd[f"{prefix}.scale"] = _t(node["scale"], torch.float32)
    if "bias" in node:
        sd[f"{prefix}.bias"] = _t(node["bias"], torch.float32)


def block_from_jax(node: dict, config: LMConfig, param_dtype=None,
                   prefix: str = "") -> dict:
    """One flax ``Block`` tree (numpy leaves, any stacked leading dims:
    the pipelines' ``[stages, layers per stage, ...]``) -> the port's
    ``Block`` state names (``attn.wq.kernel``, ``ln1.scale``, ...), each
    leaf keeping its leading dims. Weights in ``param_dtype`` (None:
    ``config.dtype``); norms float32."""
    dt = param_dtype or config.dtype
    sd: dict[str, torch.Tensor] = {}
    for name in ("wq", "wk", "wv"):
        _dense_from_jax(sd, f"{prefix}attn.{name}", node["attn"][name], dt,
                        "qkv")
    _dense_from_jax(sd, f"{prefix}attn.wo", node["attn"]["wo"], dt, "out")
    if config.num_experts > 0:
        moe = node["moe"]
        sd[f"{prefix}moe.router.kernel"] = _t(moe["router"]["kernel"],
                                              torch.float32)
        sd[f"{prefix}moe.wi"] = _t(moe["wi"], dt)
        sd[f"{prefix}moe.wo"] = _t(moe["wo"], dt)
    else:
        for name in _dense_names(config):
            _dense_from_jax(sd, f"{prefix}mlp.{name}", node["mlp"][name], dt)
    _norm_from_jax(sd, f"{prefix}ln1", node["ln1"])
    _norm_from_jax(sd, f"{prefix}ln2", node["ln2"])
    return sd


def params_from_jax(tree: dict, config: LMConfig, param_dtype=None) -> dict:
    """flax param tree (numpy leaves) -> DecoderLM state_dict, weights in
    ``param_dtype`` (None: ``config.dtype``, the serving layout)."""
    dt = param_dtype or config.dtype
    sd: dict[str, torch.Tensor] = {}
    sd["embed"] = _t(tree["embed"]["embedding"], dt)
    if config.position == "learned":
        sd["pos_embed"] = _t(tree["pos_embed"]["embedding"], dt)
    for i in range(config.num_layers):
        sd.update(block_from_jax(tree[f"layer{i}"], config, param_dtype,
                                 prefix=f"layers.{i}."))
    _norm_from_jax(sd, "ln_f", tree["ln_f"])
    if not config.tie_embeddings:
        _dense_from_jax(sd, "lm_head", tree["lm_head"], dt)
    return sd


def _dense_names(config: LMConfig) -> tuple[str, ...]:
    return ("wi", "wg", "down_proj") if config.mlp_act == "swiglu" \
        else ("wi", "down_proj")


def block_to_jax(state: dict, config: LMConfig, prefix: str = "") -> dict:
    """The inverse of ``block_from_jax``: the port's ``Block`` names
    (tensors of any leading dims, such as gradients) -> a flax ``Block``
    tree of float32 numpy leaves."""
    hd = config.head_dim

    def arr(name):
        return state[prefix + name].detach().float().cpu().numpy()

    def dense(name, heads=None, out_heads=False):
        node = {}
        k = arr(f"{name}.kernel")
        if out_heads:                      # [..., H*D, E] -> [..., H, D, E]
            k = k.reshape(k.shape[:-2] + (-1, hd, k.shape[-1]))
        elif heads is not None:            # [..., E, H*D] -> [..., E, H, D]
            k = k.reshape(k.shape[:-1] + (heads, hd))
        node["kernel"] = k
        if prefix + f"{name}.bias" in state:
            b = arr(f"{name}.bias")
            node["bias"] = (b.reshape(b.shape[:-1] + (heads, hd))
                            if heads is not None else b)
        return node

    def norm(name):
        node = {"scale": arr(f"{name}.scale")}
        if prefix + f"{name}.bias" in state:
            node["bias"] = arr(f"{name}.bias")
        return node

    out = {"attn": {"wq": dense("attn.wq", config.num_heads),
                    "wk": dense("attn.wk", config.kv_heads),
                    "wv": dense("attn.wv", config.kv_heads),
                    "wo": dense("attn.wo", out_heads=True)},
           "ln1": norm("ln1"), "ln2": norm("ln2")}
    if config.num_experts > 0:
        out["moe"] = {"router": {"kernel": arr("moe.router.kernel")},
                      "wi": arr("moe.wi"), "wo": arr("moe.wo")}
    else:
        out["mlp"] = {name: dense(f"mlp.{name}")
                      for name in _dense_names(config)}
    return out


def params_to_jax(state_dict: dict, config: LMConfig) -> dict:
    """DecoderLM state_dict (either layout, or any tensors of the same
    names and shapes, such as gradients) -> flax param tree with float32
    numpy leaves, the inverse of ``params_from_jax``."""
    def arr(name):
        return state_dict[name].detach().float().cpu().numpy()

    tree = {"embed": {"embedding": arr("embed")}}
    if config.position == "learned":
        tree["pos_embed"] = {"embedding": arr("pos_embed")}
    for i in range(config.num_layers):
        tree[f"layer{i}"] = block_to_jax(state_dict, config,
                                         prefix=f"layers.{i}.")
    tree["ln_f"] = {"scale": arr("ln_f.scale")}
    if "ln_f.bias" in state_dict:
        tree["ln_f"]["bias"] = arr("ln_f.bias")
    if not config.tie_embeddings:
        tree["lm_head"] = {"kernel": arr("lm_head.kernel")}
        if "lm_head.bias" in state_dict:
            tree["lm_head"]["bias"] = arr("lm_head.bias")
    return tree


# ---------------------------------------------------------------------------
# the pipelined trainers' trees (models/transformer_pp.py, transformer_tp.py)
# ---------------------------------------------------------------------------

def _leaves(node: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v, dtype=np.float32).copy())
            for k, v in node.items()}


def pp_params_from_jax(tree: dict, config: LMConfig) -> dict:
    """The reference's pipelined tree (transformer_pp.init_pp_params:
    ``{"embed", "blocks": a flax Block tree stacked [S*V, layers per
    virtual stage, ...] rank-major, "head"}``, numpy leaves) -> the
    port's whole tree of float32 tensors: ``blocks`` by the port's Block
    names, still stacked [S*V, ...]; ``embed`` and ``head`` under the
    reference's leaf names. ``pipeline.shard_stage_params`` (the
    trainer's ``init_fn(params=...)``) gives each rank its rows."""
    return {"embed": _leaves(tree["embed"]),
            "blocks": block_from_jax(tree["blocks"], config,
                                     torch.float32),
            "head": _leaves(tree["head"])}


def tp_params_from_jax(tree: dict) -> dict:
    """The reference's pp x tp tree (``{"embed", "blocks": {ln1_scale,
    ln2_scale, wq/wk/wv [.., e, h, d], wo [.., h, d, e], wi, down}
    stacked [S*V, layers per virtual stage, ...], "head"}``, numpy
    leaves) -> the port's whole tree of float32 tensors, the same names
    and shapes (transformer_tp's block keeps the reference's layout).
    The trainer's ``init_fn(params=...)`` gives each rank its rows and,
    over tp, its heads and MLP columns."""
    return {part: _leaves(tree[part]) for part in ("embed", "blocks",
                                                   "head")}


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
