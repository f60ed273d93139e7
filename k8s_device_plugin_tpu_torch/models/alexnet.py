"""AlexNet in PyTorch: the example timing benchmark workload.

The counterpart of ``k8s_device_plugin_tpu/models/alexnet.py``: the
same network, synthetic ImageNet-shaped data, bf16 compute over float32
parameters, the SGD train loop and the self-measured img/s, run by the
example pod's command (example/pod/alexnet-tpu.yaml) on the card.

The port's layout is NCHW tensors with ``torch.channels_last`` memory
(the NHWC that cuDNN wants for bf16) and OIHW weights; models/layers.py
holds flax's layer semantics. Two places differ from a plain NCHW
network because the reference is NHWC:

- the stem's ``stem_kernel`` / ``stem_bias`` are declared by the model,
  and the forward takes the space-to-depth form (ops/s2d.py) whenever
  ``h >= 11 and w >= 11``, exactly as the reference chooses;
- the flatten before ``Dense_0`` is NHWC-ordered (a permute first), so
  ``Dense_0``'s 9216 rows are the reference's.

Convolutions are library convolutions (cuDNN on the card), as the
reference's are XLA's; no kernel of the port runs on this path.

Run: ``python -m k8s_device_plugin_tpu_torch.models.alexnet --steps 100
--batch-size 128`` (``--device cpu`` to ask for the CPU).
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.nn.functional as F
from torch import nn

from k8s_device_plugin_tpu_torch.models.layers import (
    Conv,
    Dense,
    init_flax_,
    lecun_normal_,
    max_pool,
    params_from_flax,
    params_to_flax,
)
from k8s_device_plugin_tpu_torch.utils.device import resolve_device

__all__ = ["IMAGE_SIZE", "NUM_CLASSES", "AlexNet", "benchmark", "forward",
           "init_params", "loss_fn", "main", "make_train_step",
           "momentum_sgd", "params_from_flax", "params_to_flax",
           "run_benchmark", "synthetic_batch"]

NUM_CLASSES = 1000
IMAGE_SIZE = 224


def _stem_direct(x, kernel, bias):
    """The 11x11 stride-4 stem conv as cuDNN's direct convolution."""
    from k8s_device_plugin_tpu_torch.ops.s2d import direct_conv

    return direct_conv(x, kernel, stride=4, padding=2) \
        + bias.to(x.dtype)[:, None, None]


def _stem_space_to_depth(x, kernel, bias):
    """The stem conv re-blocked as a 3x3 stride-1 conv over 4x4
    space-to-depth input (48 in-channels), from the same ``[64, 3, 11,
    11]`` parameter; the derivation lives in ops/s2d.py."""
    from k8s_device_plugin_tpu_torch.ops.s2d import space_to_depth_conv

    return space_to_depth_conv(x, kernel, stride=4, padding=2) \
        + bias.to(x.dtype)[:, None, None]


def _pooled(size: int) -> int:
    """Spatial size after the stem and the three 3x3/2 max pools."""
    size = (size + 4 - 11) // 4 + 1
    for _ in range(3):
        size = (size - 3) // 2 + 1
    return size


class AlexNet(nn.Module):
    """Classic 5-conv/3-fc AlexNet, bf16 compute / float32 params.

    ``image_size`` fixes ``Dense_0``'s input width (256 x the last pool's
    area), which flax infers from its dummy batch."""

    def __init__(self, num_classes: int = NUM_CLASSES,
                 dtype=torch.bfloat16, image_size: int = IMAGE_SIZE):
        super().__init__()
        self.dtype = dtype
        self.stem_kernel = nn.Parameter(torch.empty(64, 3, 11, 11))
        self.stem_bias = nn.Parameter(torch.zeros(64))
        self.Conv_0 = Conv(64, 192, (5, 5), padding=(2, 2), dtype=dtype)
        self.Conv_1 = Conv(192, 384, (3, 3), padding=(1, 1), dtype=dtype)
        self.Conv_2 = Conv(384, 256, (3, 3), padding=(1, 1), dtype=dtype)
        self.Conv_3 = Conv(256, 256, (3, 3), padding=(1, 1), dtype=dtype)
        side = _pooled(image_size)
        self.Dense_0 = Dense(256 * side * side, 4096, dtype=dtype)
        self.Dense_1 = Dense(4096, 4096, dtype=dtype)
        self.Dense_2 = Dense(4096, num_classes, dtype=dtype)

    def forward(self, x, train: bool = True):
        x = x.to(self.dtype)
        h, w = x.shape[2], x.shape[3]
        if h >= 11 and w >= 11:
            x = F.relu(_stem_space_to_depth(x, self.stem_kernel,
                                            self.stem_bias))
        else:
            x = F.relu(_stem_direct(x, self.stem_kernel, self.stem_bias))
        x = max_pool(x, (3, 3), (2, 2))
        x = F.relu(self.Conv_0(x))
        x = max_pool(x, (3, 3), (2, 2))
        x = F.relu(self.Conv_1(x))
        x = F.relu(self.Conv_2(x))
        x = F.relu(self.Conv_3(x))
        x = max_pool(x, (3, 3), (2, 2))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC order
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        x = self.Dense_2(x)
        return x.float()


def init_params(seed: int = 0, image_size: int = IMAGE_SIZE,
                **model_kw) -> AlexNet:
    """A fresh AlexNet on the CPU with flax's default init drawn from a
    ``torch.Generator`` seeded ``seed`` (the draws differ from
    jax.random's; ``params_from_flax`` carries the reference's own)."""
    model = AlexNet(image_size=image_size, **model_kw)
    gen = torch.Generator().manual_seed(seed)
    init_flax_(model, gen)
    with torch.no_grad():
        lecun_normal_(model.stem_kernel, 11 * 11 * 3, gen)
        model.stem_bias.zero_()
    return model


@torch.no_grad()
def forward(model: AlexNet, images):
    """The inference step (the flagship forward of __graft_entry__)."""
    return model(images, train=False)


def loss_fn(model: AlexNet, images, labels):
    return F.cross_entropy(model(images), labels)


def make_train_step(model: nn.Module, optimizer):
    """``train_step(images, labels) -> loss``: one optimizer step on
    ``model`` in place (parameters, and BatchNorm's running averages
    where the model has them), the detached loss back. The conv models
    share it (models/resnet.py re-exports it)."""
    def train_step(images, labels):
        optimizer.zero_grad(set_to_none=True)
        value = loss_fn(model, images, labels)
        value.backward()
        optimizer.step()
        return value.detach()

    return train_step


def synthetic_batch(gen: torch.Generator, batch_size: int,
                    image_size: int = IMAGE_SIZE,
                    num_classes: int = NUM_CLASSES):
    """Normal images ``[b, 3, s, s]`` (channels_last) and uniform labels,
    drawn on the generator's device."""
    images = torch.randn((batch_size, 3, image_size, image_size),
                         generator=gen, device=gen.device)
    labels = torch.randint(0, num_classes, (batch_size,), generator=gen,
                           device=gen.device)
    return images.contiguous(memory_format=torch.channels_last), labels


def run_benchmark(model: nn.Module, optimizer, batch_size: int, steps: int,
                  image_size: int, warmup: int, device) -> dict:
    """The timed loop every conv model shares: the model moves to
    ``device`` in channels_last, one synthetic batch from a generator
    seeded 0, ``warmup`` untimed steps, then ``steps`` between two
    synchronisations (the loss's read is the second). cuDNN's autotuner
    (``cudnn.benchmark``) plays the part of XLA's; the warm-up absorbs
    its cost. Returns the reference's keys; ``backend`` is what
    ``jax.default_backend()`` reports on the same hardware."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    model.to(device, memory_format=torch.channels_last)
    train_step = make_train_step(model, optimizer(model.parameters()))
    gen = torch.Generator(device=device).manual_seed(0)
    images, labels = synthetic_batch(gen, batch_size, image_size)
    for _ in range(warmup):
        train_step(images, labels)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    start = time.perf_counter()
    for _ in range(steps):
        value = train_step(images, labels)
    final_loss = float(value)
    elapsed = time.perf_counter() - start
    return {
        "backend": "gpu" if device.type == "cuda" else device.type,
        "batch_size": batch_size,
        "steps": steps,
        "seconds": elapsed,
        "images_per_second": batch_size * steps / elapsed,
        "final_loss": final_loss,
    }


def momentum_sgd(params):
    """The reference's ``optax.sgd(0.01, momentum=0.9)``: torch's SGD
    keeps the same trace (``g + 0.9 * trace``, the first one ``g``)."""
    return torch.optim.SGD(params, lr=0.01, momentum=0.9)


def benchmark(batch_size: int = 32, steps: int = 50,
              image_size: int = IMAGE_SIZE, warmup: int = 3,
              device=None) -> dict:
    """Self-measured training throughput, the reference benchmark-pod
    shape (the pod prints its own timing)."""
    device = resolve_device(device)
    return run_benchmark(init_params(0, image_size), momentum_sgd,
                         batch_size, steps, image_size, warmup, device)


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' to ask "
                   "for the CPU)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="alexnet-benchmark")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--steps", type=int, default=50)
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
        f"AlexNet train: backend={result['backend']} "
        f"batch={result['batch_size']} steps={result['steps']} "
        f"wall={result['seconds']:.2f}s "
        f"throughput={result['images_per_second']:.1f} img/s "
        f"loss={result['final_loss']:.3f}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
