"""Space-to-depth re-blocking for strided stem convolutions.

The counterpart of ``k8s_device_plugin_tpu/ops/s2d.py`` in the port's one
layout: NCHW tensors (``torch.channels_last`` memory where the caller
keeps it, the NHWC that cuDNN wants for bf16) and OIHW weights. A
few-channel strided conv re-blocks into a stride-1 conv over
space-to-depth input with ``stride^2 * C`` channels: mathematically the
same conv, re-derived at call time from the SAME ``[f, cin, taps, taps]``
parameter, so parameters, gradients and outputs are the direct conv's
(tests/test_torch_alexnet.py holds both stems to the direct conv and to
the reference's re-blocking).

Derivation (one spatial axis; both axes are symmetric): the direct conv
computes ``y[i] = sum_t k[t] * x[stride*i - p + t]`` for taps ``t <
taps``. Zero-pad the taps to ``blocks * stride`` (``blocks =
ceil(taps / stride)``) and split ``t = stride*a + q``; then
``x[stride*(i + a) - p + q]`` is offset ``q`` of s2d block ``i + a``: a
VALID ``blocks x blocks`` conv over the s2d grid. The s2d channels are
ordered ``(q_h, q_w, c)`` in both the input and the kernel re-block, as
the reference orders them.

Both functions are library convolutions (``torch.nn.functional.conv2d``,
cuDNN on the card), as the reference's are XLA's; no kernel of the port
runs here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["direct_conv", "space_to_depth_conv"]


def direct_conv(x: torch.Tensor, kernel: torch.Tensor, stride: int,
                padding: int) -> torch.Tensor:
    """The reference formulation: a plain strided NCHW conv."""
    return F.conv2d(x, kernel.to(x.dtype), stride=stride, padding=padding)


def space_to_depth_conv(x: torch.Tensor, kernel: torch.Tensor, stride: int,
                        padding: int) -> torch.Tensor:
    """``direct_conv`` re-blocked over ``stride x stride`` s2d input.

    Any spatial size the direct conv takes: the input is padded (or, past
    the last tap a window reaches, cropped) to exactly ``out + blocks -
    1`` blocks a side."""
    f, cin, taps, _ = kernel.shape
    blocks = -(-taps // stride)                     # ceil
    pad_taps = blocks * stride - taps
    # OIHW -> HWIO, then the reference's re-block, then back to OIHW.
    k = F.pad(kernel, (0, pad_taps, 0, pad_taps)).permute(2, 3, 1, 0)
    k = (
        k.reshape(blocks, stride, blocks, stride, cin, f)
        .permute(0, 2, 1, 3, 4, 5)
        .reshape(blocks, blocks, stride * stride * cin, f)
        .permute(3, 2, 0, 1)
    )
    n, c, h, w = x.shape
    out_h = (h + 2 * padding - taps) // stride + 1
    out_w = (w + 2 * padding - taps) // stride + 1
    # Left pad = the conv's own padding; the right side extends (or
    # crops) to exactly out + blocks - 1 blocks, so the VALID conv over
    # blocks lands on the same taps as the direct conv (indices beyond
    # h + padding only meet the zero-padded taps).
    pad_h = stride * (out_h + blocks - 1) - h - padding
    pad_w = stride * (out_w + blocks - 1) - w - padding
    hb, wb = out_h + blocks - 1, out_w + blocks - 1
    xp = F.pad(x, (padding, pad_w, padding, pad_h)).permute(0, 2, 3, 1)
    xs = (
        xp.reshape(n, hb, stride, wb, stride, c)
        .permute(0, 1, 3, 2, 4, 5)
        .reshape(n, hb, wb, stride * stride * c)
        .permute(0, 3, 1, 2)                        # NCHW, channels_last
    )
    return F.conv2d(xs, k.to(x.dtype))
