"""Switch-MoE layer on one device: the counterpart of
``k8s_device_plugin_tpu/models/moe.py``.

Top-1 (switch) routing with the Switch Transformer's load-balancing
auxiliary loss, and the reference's masked dense dispatch: every expert
runs on every token and the combine keeps the routed expert's output
times its gate, so shapes stay static and no token is dropped. The
products are plain ``torch.einsum`` calls, as the reference leaves them
to XLA; no kernel of the port runs here.

Under a sharded model's plan (models/transformer.py ``ShardPlan``) the
stacked expert weights split over ``ep``, the rule the reference's
``shard_moe_params`` and ``shard_params_for_tp`` share
(``is_expert_weight``; parallel/sharding.py): each ep rank holds ``E /
ep`` experts and runs the dense dispatch for those only. ``x`` and the
routing weights enter through ``comm.copy_to_group(ep)``, the combined
output leaves through ``comm.reduce_from_group(ep)``. ``density`` and
``density_proxy`` are means over the **global** batch, as under GSPMD:
with the batch or sequence split (dp, sp) each is averaged over the
data group before their product (the mean of per-rank products would be
another number); the proxy's average passes its gradient through
unchanged, so the gradients summed over the group are the whole one.
A serving mesh (``dp x tp``) has no ``ep`` axis: every rank holds every
expert, as the reference's serving engine does (its
``shard_params_for_tp`` replicates expert weights without ``ep``).

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

from k8s_device_plugin_tpu_torch.parallel import comm


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

    def __init__(self, config: MoEConfig, param_dtype=None, plan=None):
        super().__init__()
        from k8s_device_plugin_tpu_torch.models.transformer import (
            Dense,
            _param,
        )

        cfg = self.config = config
        split = plan is not None and plan.split["experts"]
        # the ep group the experts are split over and the data group
        # the batch statistics are averaged over (None: not split)
        self.ep = plan.ep if split else None
        self.data = plan.data if plan is not None else None
        local = plan.width(cfg.num_experts, "experts", "ep") if split \
            else cfg.num_experts
        self.first = plan.mesh.coord("ep") * local if split else 0
        self.router = Dense(cfg.embed_dim, cfg.num_experts, False,
                            torch.float32, param_dtype)
        self.wi = _param((local, cfg.embed_dim, cfg.mlp_dim),
                         cfg.dtype, param_dtype)
        self.wo = _param((local, cfg.mlp_dim, cfg.embed_dim),
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
            n = comm.group_size(self.data)
            if n > 1:
                density = comm.all_reduce(density, self.data) / n
                density_proxy = comm.reduce_from_group(density_proxy,
                                                       self.data) / n
            aux = cfg.num_experts * torch.sum(density * density_proxy)
        dt = cfg.dtype
        local = self.wi.shape[0]
        routed = comm.copy_to_group(mask * gate, self.ep)
        routed = routed[..., self.first:self.first + local]
        x_in = comm.copy_to_group(x, self.ep)
        h = torch.einsum("bsd,edf->bsef", x_in.to(dt), self.wi.to(dt))
        h = F.gelu(h, approximate="tanh")
        out = torch.einsum("bsef,efd->bsed", h, self.wo.to(dt))
        combined = torch.einsum("bsed,bse->bsd", out, routed.to(dt))
        combined = comm.reduce_from_group(combined, self.ep)
        return combined.to(x.dtype), aux


def is_expert_weight(joined_path: str, leaf) -> bool:
    """Single source of truth for "this leaf is an expert-stacked weight".

    Expert weights are leaves whose own name is wi/wo, so the path's last
    segment is exactly "wi"/"wo". Dense/DenseGeneral modules that happen
    to be named wi/wo (e.g. the attention output projection) produce
    leaves ending in ".../wo/kernel" and must not match."""
    last = joined_path.rsplit("/", 1)[-1]
    return leaf.ndim == 3 and last in ("wi", "wo")
