"""MobileNetV2 in PyTorch: second model of the conv-benchmark family.

The counterpart of ``k8s_device_plugin_tpu/models/mobilenet.py``:
inverted-residual bottlenecks with depthwise 3x3s (``groups = hidden``),
ReLU6, a linear projection and a residual join only at stride 1 with
equal channels; bf16 compute over float32 parameters and statistics
(BatchNorm eps 1e-3), the Nesterov SGD loop and the self-measured img/s
of the convnet benchmark pod, sharing the AlexNet harness.

Convolutions, the depthwise ones included, are library convolutions
(cuDNN on the card), as the reference's are XLA's; no kernel of the port
runs on this path.

Run: ``python -m k8s_device_plugin_tpu_torch.models.mobilenet`` (``--device
cpu`` to ask for the CPU).
"""

from __future__ import annotations

import argparse
import functools
import json
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from k8s_device_plugin_tpu_torch.models.alexnet import (
    add_device_arg,
    run_benchmark,
)
from k8s_device_plugin_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    Dense,
    init_flax_,
    params_from_flax,
    params_to_flax,
)
from k8s_device_plugin_tpu_torch.models.resnet import (
    loss_fn,
    make_train_step,
    nesterov_sgd,
)
from k8s_device_plugin_tpu_torch.utils.device import resolve_device

__all__ = ["IMAGE_SIZE", "NUM_CLASSES", "V2_BLOCKS", "InvertedResidual",
           "MobileNetV2", "benchmark", "init_variables", "loss_fn", "main",
           "make_train_step", "params_from_flax", "params_to_flax",
           "tiny_model"]

NUM_CLASSES = 1000
IMAGE_SIZE = 224

# (expansion t, out channels c, repeats n, first stride s): the
# MobileNetV2 paper's Table 2.
V2_BLOCKS: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def _round_channels(c: float, divisor: int = 8) -> int:
    """Width-multiplied channel counts round to multiples of 8 (the
    paper's rule)."""
    new = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new < 0.9 * c:          # never round down by more than 10%
        new += divisor
    return new


_norm = functools.partial(BatchNorm, momentum=0.9, epsilon=1e-3)


class InvertedResidual(nn.Module):
    """expand 1x1 -> depthwise 3x3 (stride) -> project 1x1, residual when
    shapes allow; ReLU6 activations, linear projection (the V2 design).
    BatchNorms are numbered in call order, as flax names them."""

    def __init__(self, in_features: int, expansion: int, filters: int,
                 strides: int, dtype=torch.bfloat16):
        super().__init__()
        conv = functools.partial(Conv, use_bias=False, dtype=dtype)
        hidden = in_features * expansion
        self.residual = strides == 1 and in_features == filters
        norms = 0
        if expansion != 1:
            self.expand = conv(in_features, hidden, (1, 1))
            self.BatchNorm_0 = _norm(hidden)
            norms = 1
        self.depthwise = conv(hidden, hidden, (3, 3), (strides, strides),
                              padding=((1, 1), (1, 1)), groups=hidden)
        self.project = conv(hidden, filters, (1, 1))
        self.norms = [f"BatchNorm_{norms + i}" for i in range(2)]
        self.add_module(self.norms[0], _norm(hidden))
        self.add_module(self.norms[1], _norm(filters))

    def forward(self, x, train: bool):
        y = x
        if hasattr(self, "expand"):
            y = F.relu6(self.BatchNorm_0(self.expand(y), train))
        dw_bn, project_bn = (getattr(self, n) for n in self.norms)
        y = F.relu6(dw_bn(self.depthwise(y), train))
        y = project_bn(self.project(y), train)
        return x + y if self.residual else y


class MobileNetV2(nn.Module):
    """MobileNetV2, bf16 compute / float32 params and stats."""

    def __init__(self, width: float = 1.0, blocks=V2_BLOCKS,
                 num_classes: int = NUM_CLASSES, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        conv = functools.partial(Conv, use_bias=False, dtype=dtype)
        stem = _round_channels(32 * width)
        self.stem = conv(3, stem, (3, 3), (2, 2), padding=((1, 1), (1, 1)))
        self.BatchNorm_0 = _norm(stem)
        self.blocks = []
        features = stem
        for i, (t, c, n, s) in enumerate(blocks):
            filters = _round_channels(c * width)
            for j in range(n):
                name = f"block{i}_{j}"
                self.add_module(name, InvertedResidual(
                    features, t, filters, s if j == 0 else 1, dtype))
                self.blocks.append(name)
                features = filters
        head = _round_channels(1280 * max(1.0, width))
        self.head = conv(features, head, (1, 1))
        self.head_bn = _norm(head)
        self.Dense_0 = Dense(head, num_classes, dtype=dtype)

    def forward(self, x, train: bool = True):
        x = x.to(self.dtype)
        x = F.relu6(self.BatchNorm_0(self.stem(x), train))
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        x = F.relu6(self.head_bn(self.head(x), train))
        x = x.mean(dim=(2, 3))
        return self.Dense_0(x).float()


def tiny_model(dtype=torch.bfloat16) -> MobileNetV2:
    """Test/CI sizing: narrow width, two block groups, every code path
    (expansion-1 first block, residual joins, strided depthwise)."""
    return MobileNetV2(width=0.25, blocks=((1, 16, 1, 1), (6, 24, 2, 2)),
                       num_classes=10, dtype=dtype)


def init_variables(model: MobileNetV2, seed: int = 0) -> MobileNetV2:
    """flax's default init of ``model`` in place, drawn from a
    ``torch.Generator`` seeded ``seed``."""
    return init_flax_(model, torch.Generator().manual_seed(seed))


def benchmark(batch_size: int = 32, steps: int = 30,
              image_size: int = IMAGE_SIZE, width: float = 1.0,
              warmup: int = 3, device=None) -> dict:
    """Self-measured training throughput, the reference TF-benchmark pod
    shape (batch 32, fixed run count, printed to the pod log)."""
    device = resolve_device(device)
    model = init_variables(MobileNetV2(width=width))
    result = run_benchmark(model, nesterov_sgd, batch_size, steps,
                           image_size, warmup, device)
    return {"backend": result.pop("backend"),
            "model": f"mobilenetv2-{width}", **result}


def main(argv=None):
    p = argparse.ArgumentParser(prog="mobilenet-benchmark")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--image-size", type=int, default=IMAGE_SIZE)
    p.add_argument("--width", type=float, default=1.0)
    p.add_argument("--json", action="store_true")
    add_device_arg(p)
    args = p.parse_args(argv)
    result = benchmark(args.batch_size, args.steps, args.image_size,
                       args.width, device=args.device)
    if args.json:
        print(json.dumps(result))
        return 0
    print(
        f"MobileNetV2 train: backend={result['backend']} "
        f"width={args.width} batch={result['batch_size']} "
        f"steps={result['steps']} wall={result['seconds']:.2f}s "
        f"throughput={result['images_per_second']:.1f} img/s "
        f"loss={result['final_loss']:.3f}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
