"""Which slice of each parameter a rank holds, and the batch it takes.

The counterpart of ``k8s_device_plugin_tpu/parallel/sharding.py`` and of
``moe.shard_moe_params`` (reference models/moe.py:97-112). The port's
parameters are its own ``nn.Module`` tensors, not a flax tree, so a rule
is a tuple with one mesh axis (or None) per leading dim, the reference's
``PartitionSpec`` in the port's layout (``()`` replicates). The rules
key on the same names:

- ``wq``, ``wk``, ``wv``, ``wi``, ``wg`` and ``up_proj`` split their
  output heads or features over ``tp`` (``(None, "tp")``), and so do
  their biases (``("tp",)``);
- ``wo`` and ``down_proj`` split their input over ``tp``
  (``("tp", None)``); their biases add after the all-reduce and
  replicate;
- expert-stacked weights (``moe.is_expert_weight``) split their experts
  over ``ep`` (``("ep",)``), and replicate without an ``ep`` axis;
- everything else replicates.

A split that does not divide falls back to replication, as the
reference's ``fits`` does (sharding.py:73-86). The port's q/k/v kernels
are ``[E, H*D]`` where the reference's are ``[E, H, D]``: the rule
checks the heads, not H*D, so GQA ``wk``/``wv`` with ``tp > kv_heads``
replicate exactly as they do there.

The rules key on names and shapes, not on the layout: the serving
layout (``DecoderLM(cfg)``, weights in the config's dtype) gets the
training layout's specs, and ``ShardPlan`` builds them once from a
meta model for both. A serving mesh (``dp x tp``) has no ``ep`` axis,
so MoE experts replicate on it, as the reference's do.

``shard_state_dict`` gives a rank its part of a whole state dict (what
``params.params_from_jax`` or a checkpoint holds) and ``gather_tensor``
/ ``gather_state_dict`` put the parts back together;
``batch_sharding`` slices a global ``[batch, seq]`` batch.
"""

from __future__ import annotations

from typing import Mapping

import torch

from k8s_device_plugin_tpu_torch.models import moe
from k8s_device_plugin_tpu_torch.parallel import comm

OUT_KEYS = ("wq", "wk", "wv", "wi", "wg", "up_proj")
IN_KEYS = ("wo", "down_proj")
# Attention projections split whole heads: the config field counting
# the heads of each.
HEAD_FIELDS = {"wq": "num_heads", "wk": "kv_heads", "wv": "kv_heads",
               "wo": "num_heads"}


def _parts(name: str) -> list[str]:
    return name.split(".")


def _spec_for(name: str, ndim: int, has_tp: bool, has_ep: bool) -> tuple:
    """The rule before the divisibility check (reference spec_for)."""
    joined = "/".join(_parts(name))
    if moe.is_expert_weight(joined, torch.empty((0,) * ndim)):
        return ("ep",) if has_ep else ()
    if not has_tp:
        return ()
    if _parts(name)[-1] == "bias":
        if any(k in joined for k in OUT_KEYS):
            return ("tp",)
        return ()
    if ndim < 2:
        return ()
    if any(k in joined for k in OUT_KEYS):
        return (None, "tp")
    if any(k in joined for k in IN_KEYS):
        return ("tp", None)
    return ()


def _units(name: str, dim: int, shape, config) -> int:
    """How many whole units the split dim ``dim`` of parameter ``name``
    holds: an attention projection splits only its heads dim, so its
    heads; any other parameter its size."""
    parts = _parts(name)
    if "attn" in parts:
        for key, field in HEAD_FIELDS.items():
            if key in parts:
                return getattr(config, field)
    return shape[dim]


def param_spec(name: str, shape, mesh, config) -> tuple:
    """The rule of one parameter: its spec, or ``()`` when a split dim
    does not divide over its axis (the reference's ``fits``)."""
    spec = _spec_for(name, len(shape), "tp" in mesh.axis_names,
                     "ep" in mesh.axis_names)
    fits = all(ax is None or _units(name, i, shape, config)
               % mesh.size(ax) == 0 for i, ax in enumerate(spec))
    return spec if fits else ()


def shard_params_for_tp(mesh, model) -> dict:
    """``{parameter name: spec}`` for a whole-size ``DecoderLM`` (any
    device, ``meta`` included): the reference's tree of NamedShardings
    in the port's layout."""
    return {name: param_spec(name, tuple(p.shape), mesh, model.cfg)
            for name, p in model.named_parameters()}


def splits(mesh, config) -> dict:
    """Which blocks of the model a mesh splits, by the same rule:
    ``attn`` (q heads and ``wo`` over tp), ``kv`` (k/v heads over tp),
    ``mlp`` (the MLP's features over tp), ``experts`` (over ep)."""
    hd = config.head_dim

    def split(name, shape):
        return bool(param_spec(name, shape, mesh, config))

    e = config.embed_dim
    return {
        "attn": split("layers.0.attn.wq.kernel", (e, config.num_heads * hd)),
        "kv": split("layers.0.attn.wk.kernel", (e, config.kv_heads * hd)),
        "mlp": split("layers.0.mlp.wi.kernel", (e, config.mlp_dim)),
        "experts": split("layers.0.moe.wi",
                         (config.num_experts, e, config.mlp_dim)),
    }


def local_slice(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of a whole tensor under ``spec``."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = t.shape[dim] // mesh.size(axis)
            t = t.narrow(dim, mesh.coord(axis) * n, n)
    return t


def shard_state_dict(mesh, specs: Mapping[str, tuple],
                     state_dict: Mapping[str, torch.Tensor]) -> dict:
    """This rank's parts of a whole state dict."""
    return {name: local_slice(t, specs.get(name, ()), mesh).contiguous()
            for name, t in state_dict.items()}


def gather_tensor(local: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole tensor from every rank's block: each split dim's blocks
    are placed in zeros and summed over that axis's group (an all-reduce,
    which every backend takes on the card; adding zeros is exact)."""
    for dim, axis in enumerate(spec):
        if axis is None or mesh.size(axis) == 1:
            continue
        n = local.shape[dim]
        shape = list(local.shape)
        shape[dim] = n * mesh.size(axis)
        whole = local.new_zeros(shape)
        whole.narrow(dim, mesh.coord(axis) * n, n).copy_(local)
        local = comm.all_reduce(whole, mesh.group(axis))
    return local


def gather_state_dict(mesh, specs: Mapping[str, tuple],
                      state_dict: Mapping[str, torch.Tensor]) -> dict:
    """Whole tensors from every rank's parts (a collective: every rank
    calls it, in the same order)."""
    return {name: gather_tensor(t, specs.get(name, ()), mesh)
            for name, t in state_dict.items()}


def shard_optimizer_state(mesh, param_specs: list, state: dict) -> dict:
    """This rank's part of a whole optimizer ``state_dict`` (AdamW's
    moments take their parameter's spec; scalars replicate).
    ``param_specs`` lists the parameters' specs in ``parameters()``
    order, the optimizer's indices."""
    out = {"param_groups": state["param_groups"], "state": {}}
    for i, entry in state["state"].items():
        spec = param_specs[int(i)]
        out["state"][i] = {
            k: (local_slice(v, spec, mesh).contiguous() if v.dim() else v)
            for k, v in entry.items()}
    return out


def gather_optimizer_state(mesh, param_specs: list, state: dict) -> dict:
    """The whole optimizer ``state_dict`` from every rank's part (a
    collective)."""
    out = {"param_groups": state["param_groups"], "state": {}}
    for i in sorted(state["state"]):
        spec = param_specs[int(i)]
        out["state"][i] = {
            k: (gather_tensor(v, spec, mesh) if v.dim() else v)
            for k, v in state["state"][i].items()}
    return out


class BatchSlicer:
    """This rank's part of a global ``[batch, seq, ...]`` tensor: batch
    rows over ``dp``, and the sequence over ``sp`` when ``seq_axis``."""

    def __init__(self, mesh, seq_axis: bool):
        self.mesh = mesh
        self.seq_axis = seq_axis and "sp" in mesh.axis_names

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = self._split(x, 0, "dp")
        return self._split(x, 1, "sp") if self.seq_axis else x

    def _split(self, x, dim, axis):
        n = self.mesh.size(axis)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over the {axis} axis ({n})")
        return local_slice(x, (None,) * dim + (axis,), self.mesh)

    def offset(self, seq: int) -> int:
        """The global position of this rank's first token, for a local
        sequence of ``seq`` tokens."""
        return self.mesh.coord("sp") * seq if self.seq_axis else 0


def batch_sharding(mesh, seq_axis: bool = False) -> BatchSlicer:
    """[batch, seq, ...] arrays: batch over dp, optionally seq over sp."""
    return BatchSlicer(mesh, seq_axis)
