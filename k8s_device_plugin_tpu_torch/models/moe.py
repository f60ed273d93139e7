"""Switch-MoE layer on one device: the counterpart of
``k8s_device_plugin_tpu/models/moe.py``.

Top-1 (switch) routing with the Switch Transformer's load-balancing
auxiliary loss, and the reference's masked dense dispatch: every expert
runs on every token and the combine keeps the routed expert's output
times its gate, so shapes stay static and no token is dropped. The
products are plain ``torch.einsum`` calls, as the reference leaves them
to XLA; no kernel of the port runs here. Sharding the stacked expert
weights over an ``ep`` mesh axis (the reference's ``shard_moe_params``)
waits for the port's mesh (ROADMAP A8).

Numerics follow the reference's flax module, which the tests hold this
one to:

- the router is a bias-free Dense computed in float32 on a float32 copy
  of the input, whatever the layer's ``dtype`` (its weight is float32 in
  both parameter layouts), so a near-tie between experts routes the
  same in a bfloat16 model;
- ``argmax`` takes the first maximum;
- the experts use gelu's tanh approximation and no bias, whatever the
  model's ``mlp_act`` and ``use_bias`` say;
- ``mask * gate`` is cast to ``dtype`` before the combine, and the
  output takes the input's dtype (float32 after an RMSNorm);
- the aux loss averages over every position of the batch.

Weights: ``router.kernel`` ``[embed, experts]``, ``wi`` ``[experts,
embed, mlp]``, ``wo`` ``[experts, mlp, embed]``, the reference's
``moe/{router/kernel, wi, wo}``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    embed_dim: int = 64
    mlp_dim: int = 128
    dtype: torch.dtype = torch.bfloat16


class MoELayer(nn.Module):
    """``param_dtype=None`` is the serving layout (expert weights stored
    in ``dtype``, no gradients); ``torch.float32`` the training one
    (float32 with gradients, cast to ``dtype`` on each call). The router
    is float32 in both (the training layout's ``param_dtype`` is float32
    too)."""

    def __init__(self, config: MoEConfig, param_dtype=None):
        super().__init__()
        from k8s_device_plugin_tpu_torch.models.transformer import (
            Dense,
            _param,
        )

        cfg = self.config = config
        self.router = Dense(cfg.embed_dim, cfg.num_experts, False,
                            torch.float32, param_dtype)
        self.wi = _param((cfg.num_experts, cfg.embed_dim, cfg.mlp_dim),
                         cfg.dtype, param_dtype)
        self.wo = _param((cfg.num_experts, cfg.mlp_dim, cfg.embed_dim),
                         cfg.dtype, param_dtype)

    def forward(self, x, with_aux: bool = True):
        """x ``[batch, seq, embed]`` -> (``[batch, seq, embed]`` in x's
        dtype, the aux loss or None when ``with_aux`` is false)."""
        cfg = self.config
        logits = self.router(x.float())                    # [b, s, E]
        probs = torch.softmax(logits, dim=-1)
        top1 = probs.argmax(-1)                            # [b, s]
        mask = F.one_hot(top1, cfg.num_experts).to(probs.dtype)
        gate = (probs * mask).sum(-1, keepdim=True)        # [b, s, 1]
        aux = None
        if with_aux:
            # Fraction of tokens routed to each expert x mean router
            # probability per expert.
            density = mask.mean(dim=(0, 1))
            density_proxy = probs.mean(dim=(0, 1))
            aux = cfg.num_experts * torch.sum(density * density_proxy)
        dt = cfg.dtype
        h = torch.einsum("bsd,edf->bsef", x.to(dt), self.wi.to(dt))
        h = F.gelu(h, approximate="tanh")
        out = torch.einsum("bsef,efd->bsed", h, self.wo.to(dt))
        combined = torch.einsum("bsed,bse->bsd", out, (mask * gate).to(dt))
        return combined.to(x.dtype), aux


def is_expert_weight(joined_path: str, leaf) -> bool:
    """Single source of truth for "this leaf is an expert-stacked weight".

    Expert weights are leaves whose own name is wi/wo, so the path's last
    segment is exactly "wi"/"wo". Dense/DenseGeneral modules that happen
    to be named wi/wo (e.g. the attention output projection) produce
    leaves ending in ".../wo/kernel" and must not match."""
    last = joined_path.rsplit("/", 1)[-1]
    return leaf.ndim == 3 and last in ("wi", "wo")
