"""InceptionV3 in PyTorch: third model of the conv-benchmark family.

The counterpart of ``k8s_device_plugin_tpu/models/inception.py``: the
mixed-branch blocks (parallel 1x1 / factorized 5x5 -> two 3x3 /
factorized 7x7 / pooled branches, concatenated on the channel axis in
the reference's order), BN (eps 1e-3) + ReLU on every conv, bf16 compute
over float32 parameters and statistics, the Nesterov SGD loop and the
self-measured img/s of the convnet benchmark pod, sharing the AlexNet
harness. No aux classifier, as in the reference. 299x299 input (any
size >= 75: the stem's convs are VALID); the E blocks end at 2048
channels.

Submodules carry flax's call-order names (``ConvBN_4``, ``InceptionC_1``
...), so ``params_from_flax`` maps the reference's tree key for key.
Convolutions are library convolutions (cuDNN on the card), as the
reference's are XLA's; no kernel of the port runs on this path.

Run: ``python -m k8s_device_plugin_tpu_torch.models.inception``
(``--device cpu`` to ask for the CPU).
"""

from __future__ import annotations

import argparse
import json

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
    avg_pool,
    init_flax_,
    max_pool,
    params_from_flax,
    params_to_flax,
)
from k8s_device_plugin_tpu_torch.models.resnet import (
    loss_fn,
    make_train_step,
    nesterov_sgd,
)
from k8s_device_plugin_tpu_torch.utils.device import resolve_device

__all__ = ["IMAGE_SIZE", "NUM_CLASSES", "ConvBN", "InceptionA",
           "InceptionB", "InceptionC", "InceptionD", "InceptionE",
           "InceptionV3", "benchmark", "init_variables", "loss_fn", "main",
           "make_train_step", "params_from_flax", "params_to_flax"]

NUM_CLASSES = 1000
IMAGE_SIZE = 299


class ConvBN(nn.Module):
    """conv -> BN -> relu, the InceptionV3 'BasicConv2d'."""

    def __init__(self, in_features: int, features: int, kernel,
                 strides=(1, 1), padding="VALID", dtype=torch.bfloat16):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, kernel, strides,
                           padding=padding, use_bias=False, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(features, momentum=0.9, epsilon=1e-3)

    def forward(self, x, train: bool):
        return F.relu(self.BatchNorm_0(self.Conv_0(x), train))


def _avg_pool_same(x):
    return avg_pool(x, (3, 3), (1, 1), ((1, 1), (1, 1)))


class _Mixed(nn.Module):
    """A block of ConvBNs named ``ConvBN_<i>`` in the reference's call
    order; ``self.c(i, x, train)`` runs the i-th."""

    def __init__(self, dtype, specs):
        super().__init__()
        for i, (cin, features, kernel, kw) in enumerate(specs):
            self.add_module(f"ConvBN_{i}",
                            ConvBN(cin, features, kernel, dtype=dtype, **kw))

    def c(self, i, x, train):
        return getattr(self, f"ConvBN_{i}")(x, train)


_P1 = {"padding": ((1, 1), (1, 1))}
_S2 = {"strides": (2, 2)}


class InceptionA(_Mixed):
    def __init__(self, in_features: int, pool_features: int,
                 dtype=torch.bfloat16):
        super().__init__(dtype, [
            (in_features, 64, (1, 1), {}),
            (in_features, 48, (1, 1), {}),
            (48, 64, (5, 5), {"padding": ((2, 2), (2, 2))}),
            (in_features, 64, (1, 1), {}),
            (64, 96, (3, 3), _P1),
            (96, 96, (3, 3), _P1),
            (in_features, pool_features, (1, 1), {}),
        ])
        self.features = 64 + 64 + 96 + pool_features

    def forward(self, x, train: bool):
        b1 = self.c(0, x, train)
        b2 = self.c(2, self.c(1, x, train), train)
        b3 = self.c(5, self.c(4, self.c(3, x, train), train), train)
        b4 = self.c(6, _avg_pool_same(x), train)
        return torch.cat([b1, b2, b3, b4], dim=1)


class InceptionB(_Mixed):
    """35x35 -> 17x17 grid reduction."""

    def __init__(self, in_features: int, dtype=torch.bfloat16):
        super().__init__(dtype, [
            (in_features, 384, (3, 3), _S2),
            (in_features, 64, (1, 1), {}),
            (64, 96, (3, 3), _P1),
            (96, 96, (3, 3), _S2),
        ])
        self.features = 384 + 96 + in_features

    def forward(self, x, train: bool):
        b1 = self.c(0, x, train)
        b2 = self.c(3, self.c(2, self.c(1, x, train), train), train)
        b3 = max_pool(x, (3, 3), (2, 2))
        return torch.cat([b1, b2, b3], dim=1)


_P17 = {"padding": ((0, 0), (3, 3))}
_P71 = {"padding": ((3, 3), (0, 0))}


class InceptionC(_Mixed):
    """17x17 blocks with 1x7/7x1 factorized convolutions."""

    def __init__(self, in_features: int, channels_7x7: int,
                 dtype=torch.bfloat16):
        c7 = channels_7x7
        super().__init__(dtype, [
            (in_features, 192, (1, 1), {}),
            (in_features, c7, (1, 1), {}),
            (c7, c7, (1, 7), _P17),
            (c7, 192, (7, 1), _P71),
            (in_features, c7, (1, 1), {}),
            (c7, c7, (7, 1), _P71),
            (c7, c7, (1, 7), _P17),
            (c7, c7, (7, 1), _P71),
            (c7, 192, (1, 7), _P17),
            (in_features, 192, (1, 1), {}),
        ])
        self.features = 4 * 192

    def forward(self, x, train: bool):
        b1 = self.c(0, x, train)
        b2 = x
        for i in (1, 2, 3):
            b2 = self.c(i, b2, train)
        b3 = x
        for i in (4, 5, 6, 7, 8):
            b3 = self.c(i, b3, train)
        b4 = self.c(9, _avg_pool_same(x), train)
        return torch.cat([b1, b2, b3, b4], dim=1)


class InceptionD(_Mixed):
    """17x17 -> 8x8 grid reduction."""

    def __init__(self, in_features: int, dtype=torch.bfloat16):
        super().__init__(dtype, [
            (in_features, 192, (1, 1), {}),
            (192, 320, (3, 3), _S2),
            (in_features, 192, (1, 1), {}),
            (192, 192, (1, 7), _P17),
            (192, 192, (7, 1), _P71),
            (192, 192, (3, 3), _S2),
        ])
        self.features = 320 + 192 + in_features

    def forward(self, x, train: bool):
        b1 = self.c(1, self.c(0, x, train), train)
        b2 = x
        for i in (2, 3, 4, 5):
            b2 = self.c(i, b2, train)
        b3 = max_pool(x, (3, 3), (2, 2))
        return torch.cat([b1, b2, b3], dim=1)


_P13 = {"padding": ((0, 0), (1, 1))}
_P31 = {"padding": ((1, 1), (0, 0))}


class InceptionE(_Mixed):
    """8x8 blocks with split 1x3/3x1 branch tails."""

    def __init__(self, in_features: int, dtype=torch.bfloat16):
        super().__init__(dtype, [
            (in_features, 320, (1, 1), {}),
            (in_features, 384, (1, 1), {}),
            (384, 384, (1, 3), _P13),
            (384, 384, (3, 1), _P31),
            (in_features, 448, (1, 1), {}),
            (448, 384, (3, 3), _P1),
            (384, 384, (1, 3), _P13),
            (384, 384, (3, 1), _P31),
            (in_features, 192, (1, 1), {}),
        ])
        self.features = 320 + 2 * 384 + 2 * 384 + 192

    def forward(self, x, train: bool):
        b1 = self.c(0, x, train)
        b2 = self.c(1, x, train)
        b2 = torch.cat([self.c(2, b2, train), self.c(3, b2, train)], dim=1)
        b3 = self.c(5, self.c(4, x, train), train)
        b3 = torch.cat([self.c(6, b3, train), self.c(7, b3, train)], dim=1)
        b4 = self.c(8, _avg_pool_same(x), train)
        return torch.cat([b1, b2, b3, b4], dim=1)


class InceptionV3(nn.Module):
    """InceptionV3 main tower, bf16 compute / float32 params and stats."""

    def __init__(self, num_classes: int = NUM_CLASSES, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.ConvBN_0 = ConvBN(3, 32, (3, 3), dtype=dtype, **_S2)
        self.ConvBN_1 = ConvBN(32, 32, (3, 3), dtype=dtype)
        self.ConvBN_2 = ConvBN(32, 64, (3, 3), dtype=dtype, **_P1)
        self.ConvBN_3 = ConvBN(64, 80, (1, 1), dtype=dtype)
        self.ConvBN_4 = ConvBN(80, 192, (3, 3), dtype=dtype)
        self.blocks = []
        features = 192
        for name, cls, args in [
                ("InceptionA_0", InceptionA, (32,)),
                ("InceptionA_1", InceptionA, (64,)),
                ("InceptionA_2", InceptionA, (64,)),
                ("InceptionB_0", InceptionB, ()),
                ("InceptionC_0", InceptionC, (128,)),
                ("InceptionC_1", InceptionC, (160,)),
                ("InceptionC_2", InceptionC, (160,)),
                ("InceptionC_3", InceptionC, (192,)),
                ("InceptionD_0", InceptionD, ()),
                ("InceptionE_0", InceptionE, ()),
                ("InceptionE_1", InceptionE, ())]:
            block = cls(features, *args, dtype=dtype)
            self.add_module(name, block)
            self.blocks.append(name)
            features = block.features
        self.Dense_0 = Dense(features, num_classes, dtype=dtype)

    def forward(self, x, train: bool = True):
        x = x.to(self.dtype)
        x = self.ConvBN_0(x, train)
        x = self.ConvBN_1(x, train)
        x = self.ConvBN_2(x, train)
        x = max_pool(x, (3, 3), (2, 2))
        x = self.ConvBN_3(x, train)
        x = self.ConvBN_4(x, train)
        x = max_pool(x, (3, 3), (2, 2))
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        x = x.mean(dim=(2, 3))
        return self.Dense_0(x).float()


def init_variables(model: InceptionV3, seed: int = 0) -> InceptionV3:
    """flax's default init of ``model`` in place, drawn from a
    ``torch.Generator`` seeded ``seed``."""
    return init_flax_(model, torch.Generator().manual_seed(seed))


def benchmark(batch_size: int = 32, steps: int = 30,
              image_size: int = IMAGE_SIZE, warmup: int = 3,
              device=None) -> dict:
    """Self-measured training throughput, the reference TF-benchmark pod
    shape (batch 32, fixed run count, printed to the pod log)."""
    device = resolve_device(device)
    model = init_variables(InceptionV3())
    result = run_benchmark(model, nesterov_sgd, batch_size, steps,
                           image_size, warmup, device)
    return {"backend": result.pop("backend"), "model": "inceptionv3",
            **result}


def main(argv=None):
    p = argparse.ArgumentParser(prog="inception-benchmark")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--image-size", type=int, default=IMAGE_SIZE)
    p.add_argument("--json", action="store_true")
    add_device_arg(p)
    args = p.parse_args(argv)
    result = benchmark(args.batch_size, args.steps, args.image_size,
                       device=args.device)
    if args.json:
        print(json.dumps(result))
        return 0
    print(
        f"InceptionV3 train: backend={result['backend']} "
        f"batch={result['batch_size']} steps={result['steps']} "
        f"wall={result['seconds']:.2f}s "
        f"throughput={result['images_per_second']:.1f} img/s "
        f"loss={result['final_loss']:.3f}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
