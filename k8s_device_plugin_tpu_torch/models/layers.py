"""flax.linen's layer semantics, as the reference's conv models use them.

The reference's AlexNet, ResNet, MobileNetV2 and InceptionV3 are built
from ``flax.linen`` layers; these are their PyTorch counterparts in the
port's one layout (NCHW tensors, ``torch.channels_last`` memory where
the caller keeps it, OIHW weights), with the reference's numerics:

- parameters are float32; ``Conv`` and ``Dense`` cast their input and
  weight to the layer's ``dtype`` (bf16 by default) and return ``dtype``;
- ``BatchNorm`` is flax's, not torch's: batch statistics in float32
  whatever the input's dtype (``force_float32_reductions``), the output
  in the input's dtype, and running averages ``m * avg + (1 - m) *
  stat`` with flax's ``momentum`` (0.9, torch's 0.1) over the **biased**
  batch variance (torch's ``BatchNorm2d`` keeps the unbiased one);
- ``max_pool`` pads with -inf; ``avg_pool`` counts the padding, as
  flax's ``count_include_pad=True`` does.

Modules hold flax's names (``Conv_0``, ``BatchNorm_2``, ``proj_conv``,
``stem_kernel`` ...), so a state dict's keys are the reference tree's
paths joined by dots. ``params_from_flax`` / ``params_to_flax`` carry the
``{"params", "batch_stats"}`` tree across (numpy leaves): a ``kernel``
becomes ``weight``, 4-D kernels go HWIO <-> OIHW (a depthwise ``(3, 3,
1, C)`` is ``(C, 1, 3, 3)``), 2-D Dense kernels ``(in, out)`` <-> ``(out,
in)``; BatchNorm's ``scale`` / ``bias`` are parameters and its ``mean``
/ ``var`` buffers.

Every conv here is a library convolution (``torch.nn.functional.conv2d``,
cuDNN on the card), as the reference's are XLA's; no kernel of the port
runs on this path.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["BatchNorm", "Conv", "Dense", "avg_pool", "init_flax_",
           "lecun_normal_", "max_pool", "params_from_flax",
           "params_to_flax"]

BATCH_STATS = ("mean", "var")


def _pairs(padding, kernel, strides, hw):
    """flax's padding forms as ``((lo, hi), (lo, hi))``: 'SAME', 'VALID',
    or one int or (lo, hi) pair a spatial axis."""
    if padding == "VALID":
        return ((0, 0), (0, 0))
    if padding == "SAME":                           # lax.padtype_to_pads
        out = []
        for size, k, s in zip(hw, kernel, strides):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            out.append((total // 2, total - total // 2))
        return tuple(out)
    return tuple((p, p) if isinstance(p, int) else tuple(p)
                 for p in padding)


class Conv(nn.Module):
    """flax ``nn.Conv``: ``weight`` ``[features, in / groups, kh, kw]``
    (the reference's ``kernel`` ``[kh, kw, in / groups, features]``),
    ``groups`` for ``feature_group_count``."""

    def __init__(self, in_features: int, features: int, kernel_size,
                 strides=(1, 1), padding="SAME", groups: int = 1,
                 use_bias: bool = True, dtype=torch.bfloat16):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides)
        self.padding = padding
        self.groups = groups
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            features, in_features // groups, *self.kernel_size))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def forward(self, x):
        (lh, hh), (lw, hw) = _pairs(self.padding, self.kernel_size,
                                    self.strides, x.shape[2:])
        if (lh, lw) != (hh, hw):
            raise ValueError(f"asymmetric conv padding {self.padding} "
                             f"at input {tuple(x.shape[2:])}")
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), bias,
                        self.strides, (lh, lw), groups=self.groups)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``weight`` ``[features, in]`` (the reference's
    ``kernel`` ``[in, features]``)."""

    def __init__(self, in_features: int, features: int,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel axis of NCHW input.

    ``forward(x, train)``: in training, normalises by the batch's own
    statistics (float32) and moves the running ones; otherwise by the
    running ones. ``zero_scale`` marks a layer the reference initialises
    with ``scale_init=zeros`` (init_flax_ reads it)."""

    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, zero_scale: bool = False):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.zero_scale = zero_scale
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x, train: bool):
        if not train:
            return F.batch_norm(x, self.mean, self.var, self.scale,
                                self.bias, False, 0.0, self.epsilon)
        with torch.no_grad():
            # flax's fast variance, E[x^2] - E[x]^2 clipped at 0, in at
            # least float32: where the batch is small and its mean large,
            # it differs from torch's exact one, and the reference uses it.
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            mean = xf.mean((0, 2, 3))
            var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp_(min=0.0)
            del xf
            m = self.momentum
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        return _BatchNormTrain.apply(x, self.scale, self.bias, mean, var,
                                     self.epsilon)


class _BatchNormTrain(torch.autograd.Function):
    """Normalisation by given batch statistics, differentiated as the
    batch's own: one fused normalise forward and torch's fused batch-norm
    backward (the gradient of flax's formula, since d var / dx is the
    same for both variance formulas). It keeps only the input and three
    per-channel vectors for the backward, where autograd through the
    float32 arithmetic would keep two float32 copies of each activation."""

    @staticmethod
    def forward(ctx, x, scale, bias, mean, var, epsilon):
        ctx.epsilon = epsilon
        ctx.save_for_backward(x, scale, mean, torch.rsqrt(var + epsilon))
        return F.batch_norm(x, mean, var, scale, bias, False, 0.0, epsilon)

    @staticmethod
    def backward(ctx, dy):
        x, scale, mean, rstd = ctx.saved_tensors
        dx, dscale, dbias = torch.ops.aten.native_batch_norm_backward(
            dy, x, scale, None, None, mean, rstd, True, ctx.epsilon,
            [True, True, True])
        return dx, dscale, dbias, None, None, None


def max_pool(x, window, strides, padding=((0, 0), (0, 0))):
    """flax ``nn.max_pool`` (VALID, or symmetric padding with -inf)."""
    (lh, hh), (lw, hw) = padding
    if (lh, lw) != (hh, hw):
        raise ValueError(f"asymmetric pool padding {padding}")
    return F.max_pool2d(x, window, strides, (lh, lw))


def avg_pool(x, window, strides, padding=((0, 0), (0, 0))):
    """flax ``nn.avg_pool``, padding counted (``count_include_pad``)."""
    (lh, hh), (lw, hw) = padding
    if (lh, lw) != (hh, hw):
        raise ValueError(f"asymmetric pool padding {padding}")
    return F.avg_pool2d(x, window, strides, (lh, lw),
                        count_include_pad=True)


# ---------------------------------------------------------------------------
# initialisation (flax's defaults)
# ---------------------------------------------------------------------------

def lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator):
    """flax ``lecun_normal``: a normal truncated to +-2 sigma, rescaled
    so the truncated distribution has std ``1/sqrt(fan_in)``; drawn by
    inverse CDF as ``jax.random.truncated_normal`` does (the draws differ
    from jax.random's)."""
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    u = torch.rand(t.shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    z = torch.erfinv(lo + (hi - lo) * u) * math.sqrt(2)
    t.copy_(z * (fan_in ** -0.5 / 0.87962566103423978))


def init_flax_(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Every Conv, Dense and BatchNorm of ``model`` to flax's defaults:
    lecun_normal kernels (fan_in = in / groups x kh x kw for a conv),
    zero biases, unit BatchNorm scales (zero where ``zero_scale``) and
    running averages 0 / 1. Parameters a model declares itself (a stem
    kernel) are its own init's."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (Conv, Dense)):
                w = m.weight
                lecun_normal_(w, w[0].numel(), gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.scale.fill_(0.0 if m.zero_scale else 1.0)
                m.bias.zero_()
                m.mean.zero_()
                m.var.fill_(1.0)
    return model


# ---------------------------------------------------------------------------
# the reference's variable tree <-> a state dict
# ---------------------------------------------------------------------------

def _flat(tree, prefix=()):
    for name, sub in tree.items():
        if isinstance(sub, dict) or hasattr(sub, "items"):
            yield from _flat(sub, prefix + (name,))
        else:
            yield prefix + (name,), sub


def params_from_flax(variables) -> dict:
    """The reference's ``{"params", "batch_stats"}`` tree (numpy leaves)
    as a state dict of float32 tensors for the port's model."""
    out = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flat(variables.get(collection, {})):
            a = np.asarray(leaf, dtype=np.float32)
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2:
                a = a.T
            name = "weight" if path[-1] == "kernel" else path[-1]
            out[".".join(path[:-1] + (name,))] = torch.from_numpy(
                np.array(a, np.float32))
    return out


def params_to_flax(state_dict) -> dict:
    """The inverse of ``params_from_flax``: numpy float32 leaves under
    ``params`` (and ``batch_stats`` for BatchNorm's averages)."""
    out = {}
    for key, t in state_dict.items():
        a = t.detach().to("cpu", torch.float32).numpy()
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        elif a.ndim == 2:
            a = a.T
        *mods, name = key.split(".")
        collection = "batch_stats" if name in BATCH_STATS else "params"
        node = out.setdefault(collection, {})
        for m in mods:
            node = node.setdefault(m, {})
        node["kernel" if name == "weight" else name] = \
            np.ascontiguousarray(a)
    return out
