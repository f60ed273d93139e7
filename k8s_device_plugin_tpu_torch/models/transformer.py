"""Decoder-only transformer LM (the llm-serve workload) in PyTorch.

The counterpart of ``k8s_device_plugin_tpu/models/transformer.py`` on
one device: the same config and knobs (rms / layernorm, learned / rope
positions, GQA, gelu / swiglu, biases, tied embeddings), the
full-sequence forward, the rows-layout kv-cache forward (prefill and
incremental steps), the paged-layout forward (a page pool read through
per-row block tables: prefill chunks and decode steps), and training:
``loss_fn``, ``chunked_lm_loss``, ``make_train_step``,
``train_flops_per_step``, ``benchmark_train`` and the
``lm-train-benchmark`` CLI (``main``). ``num_experts > 0`` swaps every
block's MLP for a switch-MoE layer (models/moe.py) whose aux loss joins
``loss_fn``.

The sharded model and step (the reference's :210-270 and :755-822):
``DecoderLM(cfg, param_dtype, plan=ShardPlan(...))`` is one rank's part
of the model on a parallel/mesh.py mesh, and ``make_sharded_train_step``
trains it over ``dp x sp x tp x ep``:

- tp (Megatron-style): a rank holds its q heads and its slice of the
  MLP's features; activations enter the split through
  ``comm.copy_to_group`` and leave ``wo`` / ``down_proj`` through
  ``comm.reduce_from_group`` (the biases of those two add after it).
  Where the k/v heads do not divide over tp (GQA with tp > kv_heads),
  K/V stay whole on every rank and each takes its heads' kv groups.
- sp: a rank holds a block of the sequence, at global positions
  ``coord_sp * s/P`` on (the learned table and RoPE alike); attention
  runs as ring attention or Ulysses (parallel/) on B1, B3 and B4.
- ep: a rank holds ``E / ep`` experts (models/moe.py).
- serving (models/serve_engine.py on a ``dp x tp`` mesh): the rows
  cache and the page pool of a rank hold only the kv heads its q heads
  read (``cache_kv_layout``), and the cached and paged forwards run
  the rank's heads through the same f/g pair as the full one.
- the loss takes its targets from the global batch before slicing, so
  the last token of block r predicts the first of block r + 1, and
  divides each rank's sum by the global count; gradients are summed over
  ``dp x sp`` in one flattened all-reduce (the f/g pair leaves every
  replicated parameter's gradient whole on every tp and ep rank).

Numerics follow flax's, since the tests hold this module to the
reference's logits and gradients:

- Two parameter layouts (``DecoderLM(cfg, param_dtype=...)``). Serving
  (``param_dtype=None``) stores projection and embedding weights in
  ``config.dtype`` without gradients: flax keeps them in float32 and
  casts them to ``config.dtype`` on every call, which rounds
  identically, and storing them cast saves that traffic. Training
  (``param_dtype=torch.float32``) is flax's own layout: float32
  parameters with gradients, cast to ``config.dtype`` inside each
  ``Dense``, the embedding lookup, ``pos_embed`` and the tied head, so
  the optimizer updates float32 weights as ``optax.adamw`` does.
- ``RMSNorm`` returns ``(x * rsqrt(var + eps)).astype(dtype) * scale``
  with a float32 scale, so its output is float32; the next projection
  casts back. ``LayerNorm`` takes its statistics in float32
  (E[x^2] - E[x]^2, clipped at 0) and returns ``config.dtype``.
- flax's ``nn.gelu`` is the tanh approximation.
- flax's ``nn.Embed`` gathers in fill mode: an id outside ``[-vocab,
  vocab)`` reads a NaN row (a negative id in range wraps), and the
  request's logits are NaN from that position on; greedy argmax then
  picks id 0, as jnp's does.

Weights live in the layout of the reference's param tree (Dense kernels
``[in, out]``, DenseGeneral q/k/v ``[E, H*D]`` and o ``[H*D, E]``, the
embedding ``[vocab, E]``), so models/params.py carries a flax tree over
with reshapes only.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from k8s_device_plugin_tpu_torch.models.moe import MoEConfig, MoELayer
from k8s_device_plugin_tpu_torch.ops.attention import flash_attention
from k8s_device_plugin_tpu_torch.ops.paged_attention import paged_attention
from k8s_device_plugin_tpu_torch.parallel import comm
from k8s_device_plugin_tpu_torch.parallel.ring_attention import ring_attention
from k8s_device_plugin_tpu_torch.parallel.ulysses import ulysses_attention
from k8s_device_plugin_tpu_torch.utils.device import resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_name(dtype) -> str:
    for name, dt in _DTYPES.items():
        if dt == dtype:
            return name
    raise ValueError(f"unsupported dtype {dtype!r} ({'/'.join(_DTYPES)})")


@dataclasses.dataclass(frozen=True)
class LMConfig:
    vocab_size: int = 32000
    num_layers: int = 4
    num_heads: int = 8
    embed_dim: int = 512
    mlp_dim: int = 2048
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    # > 0 turns every layer's MLP into a switch-routed MoE with this many
    # experts (models/moe.py); the router aux loss joins loss_fn.
    num_experts: int = 0
    aux_loss_weight: float = 0.01
    # GPT-2-family knobs
    norm: str = "rms"            # "rms" | "layernorm"
    use_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # Llama/Mistral-family knobs
    num_kv_heads: int = 0        # 0 = num_heads (plain MHA)
    position: str = "learned"    # "learned" (abs table) | "rope"
    rope_theta: float = 10000.0
    mlp_act: str = "gelu"        # "gelu" | "swiglu" (gated silu)
    # Qwen2-family: biases on q/k/v only (use_bias=True wins)
    qkv_bias: bool = False
    eos_token_id: int = -1
    bos_token_id: int = -1

    def __post_init__(self):
        if isinstance(self.dtype, str):
            object.__setattr__(self, "dtype", _DTYPES[self.dtype])
        dtype_name(self.dtype)
        if self.position not in ("learned", "rope"):
            raise ValueError(
                f"unknown position {self.position!r} (learned | rope)"
            )
        if self.mlp_act not in ("gelu", "swiglu"):
            raise ValueError(
                f"unknown mlp_act {self.mlp_act!r} (gelu | swiglu)"
            )
        kvh = self.kv_heads
        if self.num_heads % kvh:
            raise ValueError(
                f"num_heads {self.num_heads} not divisible by "
                f"num_kv_heads {kvh}"
            )

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    def to_json_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["dtype"] = dtype_name(self.dtype)
        return d

    @staticmethod
    def from_json_dict(d: dict) -> "LMConfig":
        return LMConfig(**d)

    @staticmethod
    def tiny(num_experts: int = 0) -> "LMConfig":
        """Test sizing (the reference's tiny config)."""
        return LMConfig(
            vocab_size=256, num_layers=2, num_heads=4, embed_dim=64,
            mlp_dim=128, max_seq_len=128, num_experts=num_experts,
        )


# ---------------------------------------------------------------------------
# kv-cache (rows layout)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    """Contiguous per-row kv-cache: the reference's ``cache`` collection.

    ``k[l]`` / ``v[l]`` are layer l's ``[rows, max_len, kv_heads,
    head_dim]`` buffers (a sharded model's rank: its own kv heads,
    ``cache_kv_layout``), updated in place where the reference returns an
    updated copy. ``idx`` is the next write position: a scalar (every row
    at the same position, the prefill shape) or a ``[rows]`` vector. The
    reference keeps one index per layer plus ``pos_idx``, always equal;
    one shared index stands for all of them.
    """

    k: list
    v: list
    idx: torch.Tensor


def cache_kv_layout(config: LMConfig, plan=None) -> tuple:
    """``(first, heads, expand)``: the kv heads one rank's KV cache holds,
    ``[first, first + heads)`` of the model's, for the q heads it runs.

    Without a plan, or where tp does not split the q heads, that is
    every kv head. Where the kv heads divide over tp, the rank's own.
    Where they do not (GQA with ``tp > kv_heads``: K/V are computed
    whole on every rank), the kv heads that the rank's q heads ``[h0,
    h0 + heads)`` read: one, shared by all of them, when its q heads
    lie in one kv head's group (``n_rep % heads == 0``); else, when
    its q heads straddle groups unevenly, one copy per q head
    (``expand``: ``repeat_kv``'s expansion, ``first`` = h0), since B1
    and B2 read kv heads in place only at one ``n_rep``."""
    if plan is None or not plan.split["attn"]:
        return 0, config.kv_heads, False
    tp = plan.mesh.coord("tp")
    if plan.split["kv"]:
        heads = plan.width(config.kv_heads, "kv")
        return tp * heads, heads, False
    heads = plan.width(config.num_heads, "attn")
    n_rep = config.num_heads // config.kv_heads
    if n_rep % heads == 0:
        return tp * heads // n_rep, 1, False
    return tp * heads, heads, True


def new_cache(config: LMConfig, rows: int, device, plan=None) -> KVCache:
    """A zeroed rows-wide cache at index 0 (what the reference's prefill
    creates inside ``apply``); under a ``plan``, the rank's kv heads."""
    shape = (rows, config.max_seq_len, cache_kv_layout(config, plan)[1],
             config.head_dim)
    return KVCache(
        k=[torch.zeros(shape, dtype=config.dtype, device=device)
           for _ in range(config.num_layers)],
        v=[torch.zeros(shape, dtype=config.dtype, device=device)
           for _ in range(config.num_layers)],
        idx=torch.zeros((), dtype=torch.long, device=device),
    )


def set_cache_index(cache: KVCache, value) -> KVCache:
    """Force the cache index to ``value`` (scalar or per-row vector).

    Used after a padded prefill: the cache holds padding K/V beyond each
    row's true length; rewinding makes later steps overwrite it position
    by position (the causal mask hides it meanwhile). Returns a cache
    sharing the K/V buffers with a fresh index tensor."""
    idx = torch.as_tensor(value, dtype=torch.long,
                          device=cache.idx.device).clone()
    return KVCache(k=cache.k, v=cache.v, idx=idx)


@dataclasses.dataclass
class PagedKV:
    """The paged engine's physical K/V pool: the reference's ``cache``
    collection of ``k_pages`` / ``v_pages`` per layer.

    ``k_pages[l]`` / ``v_pages[l]`` are layer l's ``[pool_pages,
    page_tokens, kv_heads, head_dim]`` buffers (post-RoPE keys; a
    sharded model's rank: its own kv heads, ``cache_kv_layout``), shared
    by every row and updated in place where the reference returns an
    updated copy. The logical view — block tables and row lengths — is
    the caller's and comes in as ``pages=(bt, lens)``; page 0 is the
    engine's scratch page."""

    k_pages: list
    v_pages: list


def new_paged_pool(config: LMConfig, pool_pages: int, page_tokens: int,
                   device, plan=None) -> PagedKV:
    """A zeroed page pool (the reference's ``make_paged_pool``); under a
    ``plan``, the rank's kv heads."""
    shape = (pool_pages, page_tokens, cache_kv_layout(config, plan)[1],
             config.head_dim)
    return PagedKV(
        k_pages=[torch.zeros(shape, dtype=config.dtype, device=device)
                 for _ in range(config.num_layers)],
        v_pages=[torch.zeros(shape, dtype=config.dtype, device=device)
                 for _ in range(config.num_layers)],
    )


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class ShardPlan:
    """What one rank of a mesh holds and runs in the sharded model and
    step: the mesh, whether the sequence is split over ``sp``
    (``seq_split``: ring attention or Ulysses, ``sp_impl``), which blocks
    tp and ep split (``split``, parallel/sharding.py's rule), each
    parameter's spec (``specs``, of the whole model), the batch slicer,
    and the groups: ``tp``, ``ep``, ``sp``, and ``data`` (``dp x sp``
    when the sequence is split, else ``dp``), over which gradients,
    the loss and MoE's batch statistics are summed. On a mesh of one
    rank it splits nothing and every group is None: the one-device
    model."""

    def __init__(self, mesh, config: LMConfig, use_ring: bool,
                 sp_impl: str):
        from k8s_device_plugin_tpu_torch.parallel import sharding

        self.mesh = mesh
        self.sp_impl = sp_impl
        self.seq_split = bool(use_ring) and mesh.size("sp") > 1
        self.split = sharding.splits(mesh, config)
        with torch.device("meta"):
            whole = DecoderLM(config, param_dtype=torch.float32)
        self.specs = sharding.shard_params_for_tp(mesh, whole)
        self.slicer = sharding.batch_sharding(mesh, seq_axis=self.seq_split)
        self.tp = mesh.group("tp")
        self.ep = mesh.group("ep")
        self.sp = mesh.group("sp")
        self.data = mesh.group("dp", "sp") if self.seq_split \
            else mesh.group("dp")

    def width(self, n: int, block: str, axis: str = "tp") -> int:
        """A width of ``n`` on this rank: ``n / size`` where ``block`` is
        split over ``axis``."""
        return n // self.mesh.size(axis) if self.split[block] else n

    def reduce_grads(self, model: nn.Module) -> None:
        """Sum every gradient over the data group, in one flattened
        buffer (the training layout's parameters are all float32)."""
        if comm.group_size(self.data) == 1:
            return
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        flat = comm.all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                               self.data)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


def _param(shape, dtype, param_dtype, fill=torch.empty) -> nn.Parameter:
    """A parameter in the serving layout (``param_dtype`` None: stored in
    the compute ``dtype``, no gradient) or the training one (stored in
    ``param_dtype``, with gradient)."""
    return nn.Parameter(fill(shape, dtype=param_dtype or dtype),
                        requires_grad=param_dtype is not None)


class Dense(nn.Module):
    """flax ``nn.Dense`` / ``DenseGeneral``: ``x @ kernel (+ bias)``
    computed in ``dtype``, kernel stored ``[in, out]`` (cast to ``dtype``
    on each call when stored wider; a no-op in the serving layout)."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 dtype: torch.dtype, param_dtype=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = _param((in_features, out_features), dtype, param_dtype)
        self.bias = (_param((out_features,), dtype, param_dtype, torch.zeros)
                     if bias else None)

    def forward(self, x, reduce_group=None):
        """``reduce_group``: a split input dim's partial products are
        summed over it (``comm.reduce_from_group``) before the bias."""
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        y = comm.reduce_from_group(y, reduce_group)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype, eps: float = 1e-6,
                 trainable: bool = False):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim), requires_grad=trainable)

    def forward(self, x):
        var = x.float().square().mean(-1, keepdim=True)
        # x (any dtype) * rsqrt(fp32) promotes to fp32, as jnp does; the
        # fp32 scale keeps the output fp32.
        return (x * torch.rsqrt(var + self.eps)).to(self.dtype) * self.scale


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: fp32 statistics with the fast variance,
    output in ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype, eps: float,
                 trainable: bool = False):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim), requires_grad=trainable)
        self.bias = nn.Parameter(torch.zeros(dim), requires_grad=trainable)

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf.square().mean(-1, keepdim=True) - mean.square()).clamp_min(0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.dtype)


def make_norm(cfg: LMConfig, trainable: bool = False) -> nn.Module:
    """Norm scales (and LayerNorm's bias) are float32 in both layouts;
    ``trainable`` gives them gradients."""
    if cfg.norm == "layernorm":
        return LayerNorm(cfg.embed_dim, cfg.dtype, cfg.norm_eps, trainable)
    if cfg.norm == "rms":
        return RMSNorm(cfg.embed_dim, cfg.dtype, cfg.norm_eps, trainable)
    raise ValueError(f"unknown norm {cfg.norm!r} (rms | layernorm)")


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """RoPE tables for integer ``positions`` (any shape): float32 (cos,
    sin) shaped positions.shape + (head_dim,), HF-Llama rotate-half
    convention."""
    half = head_dim // 2
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, half, dtype=torch.float32,
                               device=positions.device) * 2.0 / head_dim)
    )
    ang = positions.float()[..., None] * inv_freq
    emb = torch.cat([ang, ang], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x, cos, sin):
    """Rotate [..., seq, heads, head_dim] by tables [..., seq, head_dim]."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    cos, sin = cos[..., None, :], sin[..., None, :]
    return (x.float() * cos + rot.float() * sin).to(x.dtype)


def repeat_kv(k, n_rep: int):
    """GQA: [b, s, kv_heads, d] -> n_rep consecutive copies per kv head
    (q head h attends kv head h // n_rep)."""
    return k if n_rep == 1 else k.repeat_interleave(n_rep, dim=2)


def _bhsd(x):
    """[b, s, h, d] -> contiguous [b, h, s, d], the kernel's layout."""
    return x.transpose(1, 2).contiguous()


def _seq_offset(plan: ShardPlan | None, s: int) -> int:
    """The global position of the first of a rank's ``s`` tokens (its
    sp block's start; 0 without a plan)."""
    return 0 if plan is None else plan.slicer.offset(s)


class Attention(nn.Module):
    def __init__(self, cfg: LMConfig, param_dtype=None,
                 plan: ShardPlan | None = None):
        super().__init__()
        self.cfg = cfg
        self.plan = plan
        qkv_bias = cfg.use_bias or cfg.qkv_bias
        hd = cfg.head_dim
        self.heads = plan.width(cfg.num_heads, "attn") if plan \
            else cfg.num_heads
        self.kv_heads = plan.width(cfg.kv_heads, "kv") if plan \
            else cfg.kv_heads
        # the tp group over which the q heads are split, or None; and
        # whether K/V stay whole there (their heads do not divide)
        self.tp = plan.tp if plan and plan.split["attn"] else None
        self.kv_whole = self.tp is not None and not plan.split["kv"]
        # the kv heads a KV cache of this rank holds (cache_kv_layout)
        self.cache_kv = cache_kv_layout(cfg, plan)
        dense = functools.partial(Dense, dtype=cfg.dtype,
                                  param_dtype=param_dtype)
        self.wq = dense(cfg.embed_dim, self.heads * hd, qkv_bias)
        self.wk = dense(cfg.embed_dim, self.kv_heads * hd, qkv_bias)
        self.wv = dense(cfg.embed_dim, self.kv_heads * hd, qkv_bias)
        self.wo = dense(self.heads * hd, cfg.embed_dim, cfg.use_bias)

    def forward(self, x, cache=None, layer: int = 0, prefill: bool = False,
                pages=None):
        if cache is None:
            return self._full(x)
        b, s, _ = x.shape
        q, k, v = self._qkv(x)
        if pages is not None:
            out = self._paged_attention(q, k, v, cache, layer, pages)
        else:
            out = self._cached_attention(q, k, v, cache, layer, prefill)
        return self.wo(out.reshape(b, s, self.heads * self.cfg.head_dim),
                       reduce_group=self.tp)

    def _qkv(self, x):
        """This rank's q ``[b, s, heads, d]`` and K/V ``[b, s, kv, d]``
        (before RoPE), x entering the tp split through f: its own q heads,
        and K/V in the layout its KV cache holds (``cache_kv_layout``).
        Where the kv heads do not divide over tp (``kv_whole``), K/V are
        computed whole on every rank and enter the split through f after
        the projection (so their weights' gradients are whole), and the
        rank keeps the kv heads its q heads read. The kernels read shared
        kv heads in place (GQA); Ulysses expands what its all-to-all
        cannot split."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim
        xf = comm.copy_to_group(x, self.tp)
        q = self.wq(xf).view(b, s, self.heads, hd)
        if not self.kv_whole:
            k, v = (w(xf).view(b, s, self.kv_heads, hd)
                    for w in (self.wk, self.wv))
            return q, k, v
        first, n, expand = self.cache_kv
        k, v = (comm.copy_to_group(w(x), self.tp).view(
            b, s, cfg.kv_heads, hd) for w in (self.wk, self.wv))
        if expand:
            k, v = (repeat_kv(t, cfg.num_heads // cfg.kv_heads)
                    for t in (k, v))
        return q, k[:, :, first:first + n], v[:, :, first:first + n]

    def _full(self, x):
        """The full-sequence causal forward of this rank's part: its heads
        (tp) over its block of the sequence (sp: ring attention or
        Ulysses). Without a plan, or on a mesh of one rank, that is every
        head over the whole sequence, on B1 (B3 and B4 under autograd)."""
        cfg, plan = self.cfg, self.plan
        b, s, _ = x.shape
        hd = cfg.head_dim
        q, k, v = self._qkv(x)
        if cfg.position == "rope":
            pos = _seq_offset(plan, s) + torch.arange(s, device=x.device)
            cos, sin = rope_cos_sin(pos, hd, cfg.rope_theta)
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        if plan is not None and plan.seq_split:
            attn = ring_attention if plan.sp_impl == "ring" \
                else ulysses_attention
            out = attn(q, k, v, plan.sp, causal=True)
        else:
            # K/V go in unexpanded; under autograd FlashAttention's
            # backward (B3, B4) returns their gradients unexpanded too.
            out = flash_attention(_bhsd(q), _bhsd(k), _bhsd(v),
                                  causal=True).transpose(1, 2)
        return self.wo(out.reshape(b, s, self.heads * hd),
                       reduce_group=self.tp)

    def _cached_attention(self, q, k, v, cache: KVCache, layer: int,
                          prefill: bool):
        """Incremental decoding against the rows cache.

        Writes this call's K/V block at the cache index (the caller
        advances the index once all layers ran). Two attention paths:

        - prefill (fresh cache, index 0): causal attention within the
          block, through the flash kernel; padded positions never attend
          past themselves, and the caller rewinds the index to the true
          prompt lengths so later steps overwrite the padding.
        - step: dense grouped attention over the whole ``max_len`` cache
          with an absolute-position causal mask, in plain torch (the
          reference leaves it to XLA too).
        """
        cfg = self.cfg
        batch, block_len, heads, head_dim = q.shape
        kv_heads = k.shape[2]
        n_rep = heads // kv_heads
        max_len = cfg.max_seq_len
        idx = cache.idx
        ar = torch.arange(block_len, device=q.device)
        if idx.dim() == 0:
            q_pos = (idx + ar)[None, :]                      # [1, L]
        else:
            q_pos = idx[:, None] + ar[None]                  # [b, L]
        if cfg.position == "rope":
            # Rotate at the absolute positions; the cache stores rotated
            # keys so cached entries never need rotating again.
            cos, sin = rope_cos_sin(q_pos, head_dim, cfg.rope_theta)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        ck, cv = cache.k[layer], cache.v[layer]
        if idx.dim() == 0:
            start = int(idx)
            # In-place write (the reference's dynamic_update_slice).
            ck[:, start:start + block_len] = k.to(cfg.dtype)
            cv[:, start:start + block_len] = v.to(cfg.dtype)
        else:
            # Per-row positions idx[b] + l, clamped to capacity (rows
            # running past the cache overwrite its last slot; serving
            # slices their tokens away). In-place scatter.
            rows = torch.arange(batch, device=q.device)[:, None]
            cols = torch.clamp(q_pos, max=max_len - 1)
            ck[rows, cols] = k.to(cfg.dtype)
            cv[rows, cols] = v.to(cfg.dtype)
        if prefill:
            # Cache beyond this block is empty and idx is 0: block-causal
            # attention over the fresh block == cache attention.
            return flash_attention(_bhsd(q), _bhsd(k), _bhsd(v),
                                   causal=True).transpose(1, 2)
        scale = head_dim ** -0.5
        # Grouped attention against the unexpanded cache: q head
        # h = kv * n_rep + r, the repeat_kv order.
        qg = q.reshape(batch, block_len, kv_heads, n_rep, head_dim)
        scores = torch.einsum("blkrd,bmkd->bkrlm", qg, ck).float() * scale
        k_pos = torch.arange(max_len, device=q.device)
        mask = k_pos[None, None, :] <= q_pos[:, :, None]    # [b|1, L, M]
        scores = scores.masked_fill(~mask[:, None, None], -1e30)
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        return torch.einsum("bkrlm,bmkd->blkrd", probs, cv).reshape(
            batch, block_len, heads, head_dim
        )

    def _paged_attention(self, q, k, v, pool: PagedKV, layer: int, pages):
        """Incremental decoding against the paged pool (the reference's
        ``_paged_attention``).

        ``pages = (bt [rows, W], lens [rows])``: row r's K/V for absolute
        position p lives at page ``bt[r, p // P]``, offset ``p % P``, and
        this call's block starts at position ``lens[r]``. Rotates q and k
        at those absolute positions (so a page one row wrote reads back
        right for every row sharing it), scatters the block's K/V through
        the table in place (positions clamped to the table's span, as
        the reference clamps), then reads through ``paged_attention``:
        kernel B2 on the card, the plain gather on the CPU. Unassigned
        slots point at the scratch page; their positions lie past
        ``lens``, so the mask hides them. Advancing ``lens`` is the
        caller's job."""
        cfg = self.cfg
        bt, lens = pages
        block_len, head_dim = q.shape[1], q.shape[3]
        k_pages, v_pages = pool.k_pages[layer], pool.v_pages[layer]
        page_tokens = k_pages.shape[1]
        span = bt.shape[1] * page_tokens
        q_pos = lens[:, None] + torch.arange(block_len, device=q.device)
        if cfg.position == "rope":
            cos, sin = rope_cos_sin(q_pos, head_dim, cfg.rope_theta)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        pos = torch.clamp(q_pos, max=span - 1)
        where = (torch.gather(bt, 1, pos // page_tokens), pos % page_tokens)
        k_pages.index_put_(where, k.to(cfg.dtype))
        v_pages.index_put_(where, v.to(cfg.dtype))
        return paged_attention(q, k_pages, v_pages, bt, q_pos)


class MLP(nn.Module):
    def __init__(self, cfg: LMConfig, param_dtype=None,
                 plan: ShardPlan | None = None):
        super().__init__()
        self.cfg = cfg
        # the tp group over which the features are split, or None
        self.tp = plan.tp if plan and plan.split["mlp"] else None
        width = plan.width(cfg.mlp_dim, "mlp") if plan else cfg.mlp_dim
        dense = functools.partial(Dense, bias=cfg.use_bias, dtype=cfg.dtype,
                                  param_dtype=param_dtype)
        self.wi = dense(cfg.embed_dim, width)
        if cfg.mlp_act == "swiglu":
            self.wg = dense(cfg.embed_dim, width)
        self.down_proj = dense(width, cfg.embed_dim)

    def forward(self, x):
        x = comm.copy_to_group(x, self.tp)
        h = self.wi(x)
        if self.cfg.mlp_act == "swiglu":
            h = F.silu(self.wg(x)) * h
        else:
            # flax nn.gelu is the tanh approximation
            h = F.gelu(h, approximate="tanh")
        return self.down_proj(h, reduce_group=self.tp)


class Block(nn.Module):
    def __init__(self, cfg: LMConfig, param_dtype=None,
                 plan: ShardPlan | None = None):
        super().__init__()
        trainable = param_dtype is not None
        self.ln1 = make_norm(cfg, trainable)
        self.attn = Attention(cfg, param_dtype, plan)
        self.ln2 = make_norm(cfg, trainable)
        if cfg.num_experts > 0:
            self.moe = MoELayer(
                MoEConfig(num_experts=cfg.num_experts,
                          embed_dim=cfg.embed_dim, mlp_dim=cfg.mlp_dim,
                          dtype=cfg.dtype),
                param_dtype, plan)
        else:
            self.mlp = MLP(cfg, param_dtype, plan)

    def forward(self, x, cache=None, layer: int = 0, prefill: bool = False,
                pages=None, aux=None):
        """``aux``: a list that collects the MoE layer's aux loss (the
        reference's ``losses`` collection); None skips computing it."""
        # The residual stream keeps its dtype: x + (cfg.dtype output),
        # as jnp promotion does for x in cfg.dtype. An MoE layer returns
        # its input's dtype (float32 after RMSNorm), which promotes it.
        x = x + self.attn(self.ln1(x), cache, layer, prefill, pages)
        h = self.ln2(x)
        if not hasattr(self, "moe"):
            return x + self.mlp(h)
        out, a = self.moe(h, with_aux=aux is not None)
        if aux is not None:
            aux.append(a)
        return x + out


class DecoderLM(nn.Module):
    """The decoder LM. ``param_dtype=None`` is the serving layout
    (weights in ``cfg.dtype``, no gradients); ``torch.float32`` is
    flax's training layout (module docstring). With a ``plan`` it is one
    rank's part of the sharded model, in every forward: the full one
    (training), the rows cache's and the page pool's (serving, with
    caches from ``new_cache`` / ``new_paged_pool`` on the same plan)."""

    def __init__(self, cfg: LMConfig, param_dtype=None,
                 plan: ShardPlan | None = None):
        super().__init__()
        self.cfg = cfg
        self.plan = plan
        self.embed = _param((cfg.vocab_size, cfg.embed_dim), cfg.dtype,
                            param_dtype)
        if cfg.position == "learned":
            self.pos_embed = _param((cfg.max_seq_len, cfg.embed_dim),
                                    cfg.dtype, param_dtype)
        self.layers = nn.ModuleList(Block(cfg, param_dtype, plan)
                                    for _ in range(cfg.num_layers))
        self.ln_f = make_norm(cfg, param_dtype is not None)
        if not cfg.tie_embeddings:
            self.lm_head = Dense(cfg.embed_dim, cfg.vocab_size, False,
                                 cfg.dtype, param_dtype)

    def forward(self, tokens, cache=None, prefill: bool = False,
                return_features: bool = False, pages=None, aux=None):
        """Logits (float32 ``[b, s, vocab]``) for ``tokens [b, s]``.

        Without a cache: the full-sequence causal forward. With a
        ``KVCache``: the decode forward at ``cache.idx`` (``prefill`` for
        the first block of a fresh cache), which writes every layer's K/V
        and then advances the index by ``s`` in place. With a ``PagedKV``
        pool and ``pages=(bt, lens)``: the paged forward at positions
        ``lens + arange(s)``, which writes every layer's K/V into the pool
        and advances nothing (the engine owns the lengths).
        ``return_features`` returns the final norm's output instead of
        logits (the chunked loss applies the head itself). ``aux``, a
        list, collects each MoE layer's aux loss."""
        cfg = self.cfg
        s = tokens.shape[1]
        # flax casts the table to cfg.dtype before the gather, so
        # repeated tokens' gradients sum in cfg.dtype too. Its gather is
        # jnp.take's fill mode: ids in [-vocab, 0) wrap, ids outside
        # [-vocab, vocab) read a NaN row (the module docstring).
        vocab = cfg.vocab_size
        valid = (tokens >= -vocab) & (tokens < vocab)
        ids = torch.where(tokens < 0, tokens + vocab, tokens)
        x = self.embed.to(cfg.dtype)[ids.clamp(0, vocab - 1)]
        x = torch.where(valid[..., None], x, torch.nan)
        if cfg.position == "learned":
            ar = torch.arange(s, device=tokens.device)
            if pages is not None:
                positions = torch.clamp(pages[1][:, None] + ar,
                                        max=cfg.max_seq_len - 1)
            elif cache is None:
                positions = ar + _seq_offset(self.plan, s)
            else:
                idx = cache.idx
                base = idx if idx.dim() == 0 else idx[:, None]
                # clamped to the table, like the cache writes
                positions = torch.clamp(base + ar, max=cfg.max_seq_len - 1)
            pos = self.pos_embed.to(cfg.dtype)[positions]
            x = x + (pos if pos.dim() == 3 else pos[None])
        for i, layer in enumerate(self.layers):
            x = layer(x, cache, i, prefill, pages, aux)
        if cache is not None and pages is None:
            cache.idx = cache.idx + s
        x = self.ln_f(x)
        if return_features:
            return x
        if cfg.tie_embeddings:
            logits = x.to(cfg.dtype) @ self.embed.to(cfg.dtype).T
        else:
            logits = self.lm_head(x)
        return logits.float()


# ---------------------------------------------------------------------------
# initialisation (flax's default initializer families)
# ---------------------------------------------------------------------------

def _trunc_normal_(t: torch.Tensor, std: float, gen: torch.Generator):
    """flax lecun_normal: a normal truncated to +-2 sigma, rescaled so the
    truncated distribution has std ``std``; drawn by inverse CDF as
    jax.random.truncated_normal does."""
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    u = torch.rand(t.shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    z = torch.erfinv(lo + (hi - lo) * u) * math.sqrt(2)
    t.copy_(z * (std / 0.87962566103423978))


def init_params(model: DecoderLM, seed: int = 0) -> DecoderLM:
    """Random weights from a seeded generator, with flax's defaults:
    lecun_normal Dense kernels (fan_in = input width; an MoE layer's
    stacked expert weights: experts x input width), zero biases,
    unit-variance-scaled embeddings (std 1/sqrt(E)), unit norm scales."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Dense):
                _trunc_normal_(m.kernel, m.kernel.shape[0] ** -0.5, gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (RMSNorm, LayerNorm)):
                m.scale.fill_(1.0)
                if isinstance(m, LayerNorm):
                    m.bias.zero_()
            elif isinstance(m, MoELayer):
                # lecun_normal of a stacked [E, in, out] weight: flax's
                # fan_in counts the expert axis as receptive field.
                for w in (m.wi, m.wo):
                    _trunc_normal_(w, (w.shape[0] * w.shape[1]) ** -0.5,
                                   gen)
        std = model.cfg.embed_dim ** -0.5
        for name in ("embed", "pos_embed"):
            p = getattr(model, name, None)
            if p is not None:
                p.copy_(torch.randn(p.shape, generator=gen, device=dev) * std)
    return model


# ---------------------------------------------------------------------------
# training (the counterpart of the reference's transformer.py:677-954)
# ---------------------------------------------------------------------------

def _chunk_loss(f, kernel, t, m, dtype):
    logits = (f.to(dtype) @ kernel.to(dtype)).float()
    losses = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             t.reshape(-1), reduction="none")
    return (losses * m.reshape(-1)).sum()


def chunked_lm_loss(feats, head_kernel, targets, mask, num_chunks: int,
                    compute_dtype=None):
    """Masked-mean next-token cross-entropy without [B, S, vocab] logits.

    The head matmul + cross-entropy run per sequence chunk under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``), so
    the backward recomputes each chunk's logits from the O(S*E) features.
    feats [B, S, E]; mask [B, S] float (0 drops a position).

    The head kernel is cast to ``compute_dtype``, and the product then
    follows jnp's promotion: RMSNorm's float32 features times a bf16
    kernel compute in float32; LayerNorm's bf16 features stay bf16."""
    return _chunked_loss_sum(feats, head_kernel, targets, mask, num_chunks,
                             compute_dtype) / mask.sum().clamp_min(1.0)


def _chunked_loss_sum(feats, head_kernel, targets, mask, num_chunks: int,
                      compute_dtype=None):
    """The masked sum of ``chunked_lm_loss`` (before the mean)."""
    _, s, _ = feats.shape
    if s % num_chunks:
        raise ValueError(f"seq {s} not divisible into {num_chunks} chunks")
    if compute_dtype is not None:
        head_kernel = head_kernel.to(compute_dtype)
    dtype = torch.promote_types(feats.dtype, head_kernel.dtype)
    c = s // num_chunks
    total = feats.new_zeros((), dtype=torch.float32)
    for i in range(num_chunks):
        part = slice(i * c, (i + 1) * c)
        total = total + checkpoint(
            _chunk_loss, feats[:, part], head_kernel, targets[:, part],
            mask[:, part], dtype, use_reentrant=False)
    return total


def loss_fn(model: DecoderLM, tokens, loss_chunks: int = 0):
    """Next-token LM loss: targets ``roll(tokens, -1)``, mean
    cross-entropy of the float32 logits ``[:, :-1]``. ``loss_chunks > 0``
    switches to ``chunked_lm_loss`` (same numbers, O(S/chunks * vocab)
    peak logits memory). With experts, ``aux_loss_weight`` times the sum
    of the layers' router aux losses is added, as the reference does.
    ``sharded_loss_fn`` on the whole batch."""
    return sharded_loss_fn(model, tokens, loss_chunks)[0]


def default_optimizer(params) -> torch.optim.Optimizer:
    """``optax.adamw(3e-4)`` with its defaults (b1 0.9, b2 0.999, eps
    1e-8, weight decay 1e-4 on every parameter). torch's own AdamW
    default decay, 0.01, would differ."""
    return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def make_train_step(config: LMConfig, device=None, optimizer=None,
                    loss_chunks: int = 0):
    """Single-device training step: ``make_sharded_train_step`` over a
    mesh of one rank.

    Returns ``(train_step, init_fn)``. ``init_fn(seed=0)`` builds the
    model in flax's training layout (float32 parameters) with seeded
    random weights on ``device`` and its optimizer (``optimizer(params)``,
    default ``default_optimizer``); ``train_step(model, opt, tokens)``
    runs loss, backward and one optimizer update in place and returns the
    detached loss. ``device`` is the card unless the caller asks for the
    CPU."""
    from k8s_device_plugin_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(("dp",), world=1, device=resolve_device(device))
    train_step, init = make_sharded_train_step(mesh, config, optimizer,
                                               loss_chunks=loss_chunks)

    def init_fn(seed: int = 0):
        return init(seed)[:2]

    return train_step, init_fn


def sharded_loss_fn(model: DecoderLM, tokens, loss_chunks: int = 0):
    """(loss, base) of one rank for the **global** batch ``tokens [B,
    S]`` (the same on every rank): the targets are ``roll(tokens, -1)``
    of the global batch and only its last position is masked, so a
    sequence split over sp keeps the pairs across its block edges; the
    rank takes its slice (``model.plan.slicer``; the whole batch without
    a plan), sums its masked cross-entropy (per sequence chunk with
    ``loss_chunks``) and divides by the global count ``B * (S - 1)``.
    ``base`` is that share, ``loss`` adds ``aux_loss_weight`` times the
    MoE layers' aux losses (whole on every rank). Summed over the data
    group, the bases give the reference's mean."""
    cfg = model.cfg
    b, s = tokens.shape
    targets = torch.roll(tokens, -1, dims=1)
    mask = (torch.arange(s, device=tokens.device) < s - 1).float()
    mask = mask.expand(b, s)
    if model.plan is not None:
        tokens, targets, mask = (model.plan.slicer(t)
                                 for t in (tokens, targets, mask))
    aux = [] if cfg.num_experts > 0 else None
    if loss_chunks:
        feats = model(tokens, return_features=True, aux=aux)
        kernel = model.embed.T if cfg.tie_embeddings \
            else model.lm_head.kernel
        total = _chunked_loss_sum(feats, kernel, targets, mask, loss_chunks,
                                  compute_dtype=cfg.dtype)
    else:
        logits = model(tokens, aux=aux)
        losses = F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                                 targets.reshape(-1), reduction="none")
        total = (losses * mask.reshape(-1)).sum()
    base = total / (b * (s - 1))
    if aux is None:
        return base, base
    return base + cfg.aux_loss_weight * sum(aux), base


def make_sharded_train_step(mesh, config: LMConfig, optimizer=None,
                            use_ring: bool | None = None,
                            sp_impl: str = "ring", loss_chunks: int = 0):
    """The training step over a parallel/mesh.py ``mesh``
    (``dp x sp x tp x ep``; the reference's signature and checks).

    Returns ``(train_step, init_fn)``. ``init_fn(seed=0, batch=None)``
    builds the one-device model (the same seeded weights on this rank's
    device as on one), keeps this rank's part of it, and
    returns ``(model, optimizer, batch slicer)`` (``default_optimizer``
    unless ``optimizer(params)`` is given). ``train_step(model, opt,
    tokens)`` takes the **global** batch (every rank draws the same),
    runs this rank's share (``sharded_loss_fn``), sums the gradients over
    ``dp x sp``, steps the optimizer on the rank's parameters and returns
    the global loss, the same number on every rank. A mesh of one rank is
    the one-device step: its plan splits nothing and every collective is
    the identity."""
    from k8s_device_plugin_tpu_torch.parallel import sharding

    if sp_impl not in ("ring", "ulysses"):
        raise ValueError(f"unknown sp_impl {sp_impl!r} (ring | ulysses)")
    if use_ring is None:
        use_ring = "sp" in mesh.axis_names
    if sp_impl == "ulysses" and "sp" not in mesh.axis_names:
        raise ValueError(
            "sp_impl='ulysses' requires an 'sp' mesh axis (the all-to-all "
            "re-shards activations over it)"
        )
    device = resolve_device(mesh.device)
    plan = ShardPlan(mesh, config, use_ring, sp_impl)
    make_opt = optimizer or default_optimizer

    def init_fn(seed: int = 0, batch=None):
        whole = init_params(
            DecoderLM(config, param_dtype=torch.float32).to(device), seed)
        model = DecoderLM(config, torch.float32, plan).to(device)
        model.load_state_dict(sharding.shard_state_dict(
            mesh, plan.specs, whole.state_dict()))
        return model, make_opt(model.parameters()), plan.slicer

    def train_step(model, opt, tokens):
        opt.zero_grad(set_to_none=True)
        loss, base = sharded_loss_fn(model, tokens.to(device), loss_chunks)
        loss.backward()
        plan.reduce_grads(model)
        opt.step()
        total = comm.all_reduce(base.detach().clone(), plan.data)
        return total + (loss - base).detach()

    return train_step, init_fn


def whole_state(model: DecoderLM, opt) -> dict:
    """``{"params", "opt"}`` of the whole model from every rank's part
    of a ``make_sharded_train_step`` model (the one-device layout; a
    collective when the mesh has several ranks)."""
    from k8s_device_plugin_tpu_torch.parallel import sharding

    plan = model.plan
    specs = [plan.specs[n] for n, _ in model.named_parameters()]
    return {"params": sharding.gather_state_dict(
                plan.mesh, plan.specs, model.state_dict()),
            "opt": sharding.gather_optimizer_state(
                plan.mesh, specs, opt.state_dict())}


def load_whole_state(model: DecoderLM, opt, state: dict) -> None:
    """Load this rank's part of a whole ``{"params", "opt"}`` state (any
    world size wrote it) into a ``make_sharded_train_step`` model."""
    from k8s_device_plugin_tpu_torch.parallel import sharding

    plan = model.plan
    specs = [plan.specs[n] for n, _ in model.named_parameters()]
    model.load_state_dict(
        sharding.shard_state_dict(plan.mesh, plan.specs, state["params"]))
    opt.load_state_dict(
        sharding.shard_optimizer_state(plan.mesh, specs, state["opt"]))


def train_flops_per_step(config: LMConfig, batch: int) -> float:
    """Analytic training FLOPs per step (scaling-book accounting), the
    reference's formula: 6*N*T for the parameter matmuls over the
    non-embedding parameter count N (lm_head counted) and T = batch*seq
    tokens, plus 12*L*b*s^2*e for the attention score/value products."""
    e, L, s = config.embed_dim, config.num_layers, config.max_seq_len
    attn_params = 2 * e * e + 2 * e * e * config.kv_heads // config.num_heads
    mats = 3 if config.mlp_act == "swiglu" else 2
    mlp_params = mats * e * config.mlp_dim * max(1, config.num_experts)
    n_params = L * (attn_params + mlp_params) + config.vocab_size * e
    tokens = batch * s
    return 6.0 * n_params * tokens + 12.0 * L * batch * s * s * e


# bf16 dense tensor-core peak of one H100 SXM (NVIDIA data sheet); MFU is
# reported against it.
H100_BF16_PEAK_FLOPS = 989e12


def flagship_config() -> LMConfig:
    """The reference benchmark's flagship config (head dim 128)."""
    return LMConfig(vocab_size=32000, num_layers=8, num_heads=8,
                    embed_dim=1024, mlp_dim=4096, max_seq_len=2048)


def smoke_config() -> LMConfig:
    """The reference CLI's ``--smoke`` config (still head dim 128)."""
    return LMConfig(vocab_size=1000, num_layers=2, num_heads=2,
                    embed_dim=256, mlp_dim=512, max_seq_len=256)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark_train(config: LMConfig | None = None, batch: int = 8,
                    steps: int = 20, warmup: int = 3,
                    peak_flops: float = H100_BF16_PEAK_FLOPS,
                    loss_chunks: int = 0, device=None) -> dict:
    """Single-device training throughput + MFU on the flagship config.

    Random tokens from a seeded generator, ``warmup`` untimed steps, then
    ``steps`` timed ones between two ``torch.cuda.synchronize()`` calls.
    Returns the reference's keys (``backend`` is the torch device type)
    plus ``device_name`` and ``first_loss`` (the first step's loss)."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    device = resolve_device(device)
    config = config or flagship_config()
    train_step, init_fn = make_train_step(config, device,
                                          loss_chunks=loss_chunks)
    model, opt = init_fn(0)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, config.vocab_size, (batch, config.max_seq_len),
                           generator=gen).to(device)
    losses = [train_step(model, opt, tokens) for _ in range(warmup)]
    _sync(device)
    start = time.perf_counter()
    for _ in range(steps):
        loss = train_step(model, opt, tokens)
        losses.append(loss)
    _sync(device)
    elapsed = time.perf_counter() - start
    flops = train_flops_per_step(config, batch)
    tflops_per_s = flops * steps / elapsed / 1e12
    return {
        "backend": device.type,
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "batch": batch,
        "seq": config.max_seq_len,
        "steps": steps,
        "seconds": elapsed,
        "tokens_per_second": batch * config.max_seq_len * steps / elapsed,
        "tflops_per_second": tflops_per_s,
        "mfu": tflops_per_s * 1e12 / peak_flops,
        "first_loss": float(losses[0]),
        "final_loss": float(loss),
    }


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(prog="lm-train-benchmark")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument(
        "--smoke", action="store_true",
        help="small config (still head_dim 128) for smoke runs",
    )
    p.add_argument(
        "--loss-chunks", type=int, default=0,
        help="chunked cross-entropy over N sequence chunks (0 = fused)",
    )
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' to ask "
                   "for the CPU)")
    args = p.parse_args(argv)
    result = benchmark_train(
        config=smoke_config() if args.smoke else None, batch=args.batch,
        steps=args.steps, loss_chunks=args.loss_chunks, device=args.device)
    if args.json:
        print(json.dumps(result))
    else:
        print(
            f"LM train: backend={result['backend']} "
            f"device={result['device_name']} batch={result['batch']} "
            f"seq={result['seq']} steps={result['steps']} "
            f"wall={result['seconds']:.2f}s "
            f"{result['tflops_per_second']:.1f} TFLOP/s "
            f"(MFU {result['mfu'] * 100:.1f}%) loss={result['final_loss']:.3f}"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
