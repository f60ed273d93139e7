"""Carry the reference's flax parameter tree into the port's DecoderLM.

``params_from_jax(tree, config)`` takes the tree that
``k8s_device_plugin_tpu.models.transformer.init_params`` returns (or a
restored checkpoint's), with numpy arrays as leaves, and returns a
``state_dict`` for ``k8s_device_plugin_tpu_torch.models.transformer.
DecoderLM``. The mapping is reshapes only:

- DenseGeneral q/k/v kernels ``[E, H, D]`` -> ``[E, H*D]``, biases
  ``[H, D]`` -> ``[H*D]``; the o kernel ``[H, D, E]`` -> ``[H*D, E]``.
- Dense kernels stay ``[in, out]``.
- ``embed.embedding`` / ``pos_embed.embedding`` stay ``[rows, E]``.
- Norm ``scale`` / ``bias`` stay float32; ``lm_head.kernel`` is absent
  when ``tie_embeddings`` is set.

Projection and embedding weights are cast to ``config.dtype`` (flax
casts them on every call, to the same values).
"""

from __future__ import annotations

import numpy as np
import torch

from k8s_device_plugin_tpu_torch.models.transformer import LMConfig


def _t(a, dtype) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy()).to(dtype)


def params_from_jax(tree: dict, config: LMConfig) -> dict:
    """flax param tree (numpy leaves) -> DecoderLM state_dict."""
    dt = config.dtype
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
        names = ("wi", "wg", "down_proj") if config.mlp_act == "swiglu" \
            else ("wi", "down_proj")
        for name in names:
            dense(f"{p}.mlp.{name}", layer["mlp"][name])
        norm(f"{p}.ln1", layer["ln1"])
        norm(f"{p}.ln2", layer["ln2"])
    norm("ln_f", tree["ln_f"])
    if not config.tie_embeddings:
        dense("lm_head", tree["lm_head"])
    return sd
