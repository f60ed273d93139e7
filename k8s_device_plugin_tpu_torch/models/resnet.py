"""ResNet (50/101/152) in PyTorch: the conv-benchmark model family.

The counterpart of ``k8s_device_plugin_tpu/models/resnet.py``: batch-norm
v1.5 bottlenecks, synthetic ImageNet-shaped data, bf16 compute over
float32 parameters and statistics, a Nesterov momentum-SGD loop and the
self-measured img/s of example/pod/resnet-tpu.yaml, sharing the AlexNet
harness (models/alexnet.py: ``make_train_step``, ``synthetic_batch``,
the timed loop).

- The 7x7 stride-2 stem runs as a 4x4 stride-1 conv over 2x2
  space-to-depth input (ops/s2d.py) when h and w are >= 7 and even, the
  direct conv otherwise, as the reference chooses; both from the same
  ``[width, 3, 7, 7]`` parameter.
- ``batch_stats`` are BatchNorm buffers (models/layers.py, flax's
  semantics); ``forward(x, train=True)`` normalises by the batch and
  moves them, so a train step returns them updated in the model.
- A fresh init zero-initialises the last BatchNorm scale of each
  bottleneck (each block starts as identity).

Convolutions are library convolutions (cuDNN on the card), as the
reference's are XLA's; no kernel of the port runs on this path.

Run: ``python -m k8s_device_plugin_tpu_torch.models.resnet --batch-size
256 --steps 50`` (``--device cpu`` to ask for the CPU).
"""

from __future__ import annotations

import argparse
import functools
import json

import torch
import torch.nn.functional as F
from torch import nn

from k8s_device_plugin_tpu_torch.models.alexnet import (
    add_device_arg,
    loss_fn,
    make_train_step,
    run_benchmark,
    synthetic_batch,
)
from k8s_device_plugin_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    Dense,
    init_flax_,
    lecun_normal_,
    max_pool,
    params_from_flax,
    params_to_flax,
)
from k8s_device_plugin_tpu_torch.utils.device import resolve_device

__all__ = ["IMAGE_SIZE", "NUM_CLASSES", "STAGE_SIZES", "Bottleneck",
           "ResNet", "benchmark", "init_variables", "loss_fn", "main",
           "make_train_step", "params_from_flax", "params_to_flax",
           "synthetic_batch", "tiny_model"]

NUM_CLASSES = 1000
IMAGE_SIZE = 224

STAGE_SIZES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def _stem_direct(x, kernel):
    """The 7x7 stride-2 stem conv as cuDNN's direct convolution."""
    from k8s_device_plugin_tpu_torch.ops.s2d import direct_conv

    return direct_conv(x, kernel, stride=2, padding=3)


def _stem_space_to_depth(x, kernel):
    """The stem conv re-blocked as a 4x4 stride-1 conv over 2x2
    space-to-depth input (12 in-channels); ops/s2d.py."""
    from k8s_device_plugin_tpu_torch.ops.s2d import space_to_depth_conv

    return space_to_depth_conv(x, kernel, stride=2, padding=3)


def _norm(features: int, **kw) -> BatchNorm:
    return BatchNorm(features, momentum=0.9, epsilon=1e-5, **kw)


class Bottleneck(nn.Module):
    """ResNet v1.5 bottleneck: 1x1 / 3x3(stride) / 1x1 with a projection
    shortcut on shape change (``proj_conv`` / ``proj_bn``)."""

    def __init__(self, in_features: int, filters: int, strides,
                 dtype=torch.bfloat16):
        super().__init__()
        conv = functools.partial(Conv, use_bias=False, dtype=dtype)
        self.Conv_0 = conv(in_features, filters, (1, 1))
        self.BatchNorm_0 = _norm(filters)
        self.Conv_1 = conv(filters, filters, (3, 3), strides,
                           padding=((1, 1), (1, 1)))
        self.BatchNorm_1 = _norm(filters)
        self.Conv_2 = conv(filters, 4 * filters, (1, 1))
        self.BatchNorm_2 = _norm(4 * filters, zero_scale=True)
        # The reference projects when the residual's shape differs from
        # the branch's: a channel change or a stride.
        if in_features != 4 * filters or tuple(strides) != (1, 1):
            self.proj_conv = conv(in_features, 4 * filters, (1, 1), strides)
            self.proj_bn = _norm(4 * filters)

    def forward(self, x, train: bool):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        residual = x
        if hasattr(self, "proj_conv"):
            residual = self.proj_bn(self.proj_conv(x), train)
        return F.relu(residual + y)


class ResNet(nn.Module):
    """Bottleneck ResNet, bf16 compute / float32 params and stats."""

    def __init__(self, stage_sizes=STAGE_SIZES[50], width: int = 64,
                 num_classes: int = NUM_CLASSES, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stem_kernel = nn.Parameter(torch.empty(width, 3, 7, 7))
        self.stem_bn = _norm(width)
        self.blocks = []
        features = width
        for stage, num_blocks in enumerate(stage_sizes):
            for block in range(num_blocks):
                strides = (2, 2) if stage > 0 and block == 0 else (1, 1)
                name = f"stage{stage}_block{block}"
                filters = width * 2 ** stage
                self.add_module(name, Bottleneck(features, filters, strides,
                                                 dtype))
                self.blocks.append(name)
                features = 4 * filters
        self.Dense_0 = Dense(features, num_classes, dtype=dtype)

    def forward(self, x, train: bool = True):
        x = x.to(self.dtype)
        h, w = x.shape[2], x.shape[3]
        if h >= 7 and w >= 7 and h % 2 == 0 and w % 2 == 0:
            x = _stem_space_to_depth(x, self.stem_kernel)
        else:
            x = _stem_direct(x, self.stem_kernel)
        x = F.relu(self.stem_bn(x, train))
        x = max_pool(x, (3, 3), (2, 2), ((1, 1), (1, 1)))
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        x = x.mean(dim=(2, 3))                      # global average pool
        return self.Dense_0(x).float()


def tiny_model(dtype=torch.bfloat16) -> ResNet:
    """Test/CI sizing: one block per stage, narrow, still every code path
    (s2d stem on even inputs, projection shortcuts, BN stats)."""
    return ResNet(stage_sizes=(1, 1, 1, 1), width=8, num_classes=10,
                  dtype=dtype)


def init_variables(model: ResNet, seed: int = 0) -> ResNet:
    """flax's default init of ``model`` in place, drawn from a
    ``torch.Generator`` seeded ``seed``: lecun_normal kernels (the stem
    too), unit BatchNorm scales but the zeroed last one of each
    bottleneck, running averages 0 / 1."""
    gen = torch.Generator().manual_seed(seed)
    init_flax_(model, gen)
    with torch.no_grad():
        lecun_normal_(model.stem_kernel, 7 * 7 * 3, gen)
    return model


def nesterov_sgd(params):
    """The reference's ``optax.sgd(0.1, momentum=0.9, nesterov=True)``."""
    return torch.optim.SGD(params, lr=0.1, momentum=0.9, nesterov=True)


def benchmark(batch_size: int = 32, steps: int = 30,
              image_size: int = IMAGE_SIZE, depth: int = 50,
              warmup: int = 3, device=None) -> dict:
    """Self-measured training throughput, the reference TF-benchmark pod
    shape (batch 32, fixed run count, printed to the pod log)."""
    device = resolve_device(device)
    model = init_variables(ResNet(stage_sizes=STAGE_SIZES[depth]))
    result = run_benchmark(model, nesterov_sgd, batch_size, steps,
                           image_size, warmup, device)
    return {"backend": result.pop("backend"), "model": f"resnet{depth}",
            **result}


def main(argv=None):
    p = argparse.ArgumentParser(prog="resnet-benchmark")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--image-size", type=int, default=IMAGE_SIZE)
    p.add_argument("--depth", type=int, default=50,
                   choices=sorted(STAGE_SIZES))
    p.add_argument("--json", action="store_true")
    add_device_arg(p)
    args = p.parse_args(argv)
    result = benchmark(args.batch_size, args.steps, args.image_size,
                       args.depth, device=args.device)
    if args.json:
        print(json.dumps(result))
        return 0
    print(
        f"ResNet{args.depth} train: backend={result['backend']} "
        f"batch={result['batch_size']} steps={result['steps']} "
        f"wall={result['seconds']:.2f}s "
        f"throughput={result['images_per_second']:.1f} img/s "
        f"loss={result['final_loss']:.3f}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
