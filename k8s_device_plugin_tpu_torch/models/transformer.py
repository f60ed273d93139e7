"""Decoder-only transformer LM (the llm-serve workload) in PyTorch.

The counterpart of ``k8s_device_plugin_tpu/models/transformer.py`` for
inference on one device: the same config and knobs (rms / layernorm,
learned / rope positions, GQA, gelu / swiglu, biases, tied embeddings),
the full-sequence forward, and the rows-layout kv-cache forward (prefill
and incremental steps). Paged attention, MoE, sequence parallelism and
the training functions are not ported yet (ROADMAP.md).

Numerics follow flax's, since the tests hold this module to the
reference's logits:

- Projection and embedding weights are stored in ``config.dtype``. flax
  keeps them in float32 and casts them to ``config.dtype`` on every call,
  which rounds identically; storing them cast saves that traffic.
- ``RMSNorm`` returns ``(x * rsqrt(var + eps)).astype(dtype) * scale``
  with a float32 scale, so its output is float32; the next projection
  casts back. ``LayerNorm`` takes its statistics in float32
  (E[x^2] - E[x]^2, clipped at 0) and returns ``config.dtype``.
- flax's ``nn.gelu`` is the tanh approximation.

Weights live in the layout of the reference's param tree (Dense kernels
``[in, out]``, DenseGeneral q/k/v ``[E, H*D]`` and o ``[H*D, E]``, the
embedding ``[vocab, E]``), so models/params.py carries a flax tree over
with reshapes only.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from k8s_device_plugin_tpu_torch.ops.attention import flash_attention

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
    # > 0 = switch-routed MoE MLPs in the reference; not ported yet, so
    # the field is kept for config round-trips and refused at model build.
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
    head_dim]`` buffers, updated in place where the reference returns an
    updated copy. ``idx`` is the next write position: a scalar (every row
    at the same position, the prefill shape) or a ``[rows]`` vector. The
    reference keeps one index per layer plus ``pos_idx``, always equal;
    one shared index stands for all of them.
    """

    k: list
    v: list
    idx: torch.Tensor


def new_cache(config: LMConfig, rows: int, device) -> KVCache:
    """A zeroed rows-wide cache at index 0 (what the reference's prefill
    creates inside ``apply``)."""
    shape = (rows, config.max_seq_len, config.kv_heads, config.head_dim)
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


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class Dense(nn.Module):
    """flax ``nn.Dense`` / ``DenseGeneral`` at inference: ``x @ kernel
    (+ bias)`` computed in ``dtype``, kernel stored ``[in, out]``."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty(in_features, out_features, dtype=dtype),
            requires_grad=False,
        )
        self.bias = (
            nn.Parameter(torch.zeros(out_features, dtype=dtype),
                         requires_grad=False) if bias else None
        )

    def forward(self, x):
        y = x.to(self.kernel.dtype) @ self.kernel
        return y if self.bias is None else y + self.bias


class RMSNorm(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype, eps: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim), requires_grad=False)

    def forward(self, x):
        var = x.float().square().mean(-1, keepdim=True)
        # x (any dtype) * rsqrt(fp32) promotes to fp32, as jnp does; the
        # fp32 scale keeps the output fp32.
        return (x * torch.rsqrt(var + self.eps)).to(self.dtype) * self.scale


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: fp32 statistics with the fast variance,
    output in ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype, eps: float):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(dim), requires_grad=False)

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf.square().mean(-1, keepdim=True) - mean.square()).clamp_min(0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.dtype)


def make_norm(cfg: LMConfig) -> nn.Module:
    if cfg.norm == "layernorm":
        return LayerNorm(cfg.embed_dim, cfg.dtype, cfg.norm_eps)
    if cfg.norm == "rms":
        return RMSNorm(cfg.embed_dim, cfg.dtype, eps=cfg.norm_eps)
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


class Attention(nn.Module):
    def __init__(self, cfg: LMConfig):
        super().__init__()
        self.cfg = cfg
        qkv_bias = cfg.use_bias or cfg.qkv_bias
        hd = cfg.head_dim
        self.wq = Dense(cfg.embed_dim, cfg.num_heads * hd, qkv_bias, cfg.dtype)
        self.wk = Dense(cfg.embed_dim, cfg.kv_heads * hd, qkv_bias, cfg.dtype)
        self.wv = Dense(cfg.embed_dim, cfg.kv_heads * hd, qkv_bias, cfg.dtype)
        self.wo = Dense(cfg.num_heads * hd, cfg.embed_dim, cfg.use_bias,
                        cfg.dtype)

    def forward(self, x, cache: KVCache | None = None, layer: int = 0,
                prefill: bool = False):
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim
        q = self.wq(x).view(b, s, cfg.num_heads, hd)
        k = self.wk(x).view(b, s, cfg.kv_heads, hd)
        v = self.wv(x).view(b, s, cfg.kv_heads, hd)
        if cache is not None:
            out = self._cached_attention(q, k, v, cache, layer, prefill)
        else:
            if cfg.position == "rope":
                cos, sin = rope_cos_sin(
                    torch.arange(s, device=x.device), hd, cfg.rope_theta
                )
                q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            # The kernel reads shared kv heads in place (GQA), so K/V go
            # in unexpanded.
            out = flash_attention(_bhsd(q), _bhsd(k), _bhsd(v),
                                  causal=True).transpose(1, 2)
        return self.wo(out.reshape(b, s, cfg.num_heads * hd))

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


class MLP(nn.Module):
    def __init__(self, cfg: LMConfig):
        super().__init__()
        self.cfg = cfg
        self.wi = Dense(cfg.embed_dim, cfg.mlp_dim, cfg.use_bias, cfg.dtype)
        if cfg.mlp_act == "swiglu":
            self.wg = Dense(cfg.embed_dim, cfg.mlp_dim, cfg.use_bias,
                            cfg.dtype)
        self.down_proj = Dense(cfg.mlp_dim, cfg.embed_dim, cfg.use_bias,
                               cfg.dtype)

    def forward(self, x):
        h = self.wi(x)
        if self.cfg.mlp_act == "swiglu":
            h = F.silu(self.wg(x)) * h
        else:
            # flax nn.gelu is the tanh approximation
            h = F.gelu(h, approximate="tanh")
        return self.down_proj(h)


class Block(nn.Module):
    def __init__(self, cfg: LMConfig):
        super().__init__()
        self.ln1 = make_norm(cfg)
        self.attn = Attention(cfg)
        self.ln2 = make_norm(cfg)
        self.mlp = MLP(cfg)

    def forward(self, x, cache=None, layer: int = 0, prefill: bool = False):
        # The residual stream keeps its dtype: x + (cfg.dtype output),
        # as jnp promotion does for x in cfg.dtype.
        x = x + self.attn(self.ln1(x), cache, layer, prefill)
        return x + self.mlp(self.ln2(x))


class DecoderLM(nn.Module):
    def __init__(self, cfg: LMConfig):
        super().__init__()
        if cfg.num_experts:
            raise NotImplementedError(
                "MoE layers are not ported to the PyTorch package yet "
                "(ROADMAP.md, queue A)"
            )
        self.cfg = cfg
        self.embed = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.embed_dim, dtype=cfg.dtype),
            requires_grad=False,
        )
        if cfg.position == "learned":
            self.pos_embed = nn.Parameter(
                torch.empty(cfg.max_seq_len, cfg.embed_dim, dtype=cfg.dtype),
                requires_grad=False,
            )
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        self.ln_f = make_norm(cfg)
        if not cfg.tie_embeddings:
            self.lm_head = Dense(cfg.embed_dim, cfg.vocab_size, False,
                                 cfg.dtype)

    def forward(self, tokens, cache: KVCache | None = None,
                prefill: bool = False):
        """Logits (float32 ``[b, s, vocab]``) for ``tokens [b, s]``.

        Without a cache: the full-sequence causal forward. With one: the
        decode forward at ``cache.idx`` (``prefill`` for the first block
        of a fresh cache), which writes every layer's K/V and then
        advances the index by ``s`` in place."""
        cfg = self.cfg
        s = tokens.shape[1]
        # Out-of-range ids clamp, as the reference's gather does.
        x = self.embed[tokens.clamp(0, cfg.vocab_size - 1)]
        if cfg.position == "learned":
            ar = torch.arange(s, device=tokens.device)
            if cache is None:
                positions = ar
            else:
                idx = cache.idx
                base = idx if idx.dim() == 0 else idx[:, None]
                # clamped to the table, like the cache writes
                positions = torch.clamp(base + ar, max=cfg.max_seq_len - 1)
            pos = self.pos_embed[positions]
            x = x + (pos if pos.dim() == 3 else pos[None])
        for i, layer in enumerate(self.layers):
            x = layer(x, cache, i, prefill)
        if cache is not None:
            cache.idx = cache.idx + s
        x = self.ln_f(x)
        if cfg.tie_embeddings:
            logits = x.to(cfg.dtype) @ self.embed.T
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
    lecun_normal Dense kernels (fan_in = input width), zero biases,
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
        std = model.cfg.embed_dim ** -0.5
        for name in ("embed", "pos_embed"):
            p = getattr(model, name, None)
            if p is not None:
                p.copy_(torch.randn(p.shape, generator=gen, device=dev) * std)
    return model
