"""The mesh over the ranks of a ``torch.distributed`` process group.

The counterpart of ``k8s_device_plugin_tpu/parallel/mesh.py``. Where the
reference lays its devices on a ``jax.sharding.Mesh``, the port lays the
ranks of its process group on the same axes:

  dp  - data parallel (outermost; gradient all-reduce)
  sp  - sequence parallel (ring attention / Ulysses)
  tp  - tensor parallel (innermost; activation all-reduces)
  ep  - expert parallel (switch-MoE expert weights)

Ranks lie on the mesh in C order, as ``np.array(devices).reshape(shape)``
lays out the reference's devices, so the last axis is innermost and its
ranks are consecutive. A ``Mesh`` holds one process group per axis (the
ranks that differ only on that axis) and one for ``dp x sp``, the
gradient reduction; every rank creates every group, in one order, as
``torch.distributed.new_group`` requires.

The backend is a stated rule, logged when the process group starts
(``backend_for``): ``nccl`` when every rank of the node has a card of
its own (``LOCAL_WORLD_SIZE <= torch.cuda.device_count()``), else
``gloo``, which lets several ranks share one card (parallel/comm.py
stages what gloo does not take from the card through host memory).
A rank's device is ``cuda:(LOCAL_RANK % device_count)``
(utils/device.py), or the CPU when asked for; it never quietly becomes
the CPU.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from k8s_device_plugin_tpu_torch.utils.device import resolve_device

log = logging.getLogger("tpu-parallel")

# The groups a mesh creates besides one per axis.
_COMBINED = (("dp", "sp"),)


def visible_chip_indices() -> Optional[List[int]]:
    """Card indices granted by the plugin (``CUDA_VISIBLE_DEVICES``), or
    None when unrestricted or unparsable (the reference's rules over
    TPU_VISIBLE_CHIPS)."""
    raw = os.environ.get("CUDA_VISIBLE_DEVICES")
    if not raw:
        return None
    try:
        return [int(p) for p in raw.split(",") if p.strip() != ""]
    except ValueError:
        return None


def _factor(n: int, parts: int) -> Tuple[int, ...]:
    """Split n devices into `parts` axes, largest extent innermost-last."""
    dims = [1] * parts
    i = parts - 1
    f = 2
    while n > 1:
        while n % f == 0:
            dims[i] *= f
            n //= f
            i = (i - 1) % parts
        f += 1
    # Round-robin can leave a larger extent on an outer axis (6 -> [3, 2]);
    # sort so the last (innermost, ICI-closest) axis is always the largest.
    return tuple(sorted(dims))


class Mesh:
    """The ranks of a process group laid out on named axes.

    ``shape`` is ``{axis: size}`` in axis order (the reference's
    ``dict(mesh.shape)``); ``coords`` this rank's coordinate on each
    axis; ``group(*axes)`` the process group of the ranks that differ
    only on those axes (None when they number one, or when there is no
    process group: a mesh of one rank, or one built for its shape
    alone); ``device`` the rank's device (None: the card)."""

    def __init__(self, axis_names: Sequence[str], axis_shape: Sequence[int],
                 rank: int = 0, device=None, backend: Optional[str] = None):
        self.axis_names = tuple(axis_names)
        self.axis_shape = tuple(int(d) for d in axis_shape)
        self.world = int(np.prod(self.axis_shape, dtype=np.int64))
        self.rank = rank
        self.coords = dict(zip(self.axis_names, (
            int(c) for c in np.unravel_index(rank, self.axis_shape))))
        self.device = None if device is None else torch.device(device)
        self.backend = backend
        self._groups: dict = {}

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_shape))

    def size(self, *axes: str) -> int:
        """The number of ranks spanned by ``axes`` (1 for an axis the
        mesh lacks)."""
        return int(np.prod([self.shape.get(a, 1) for a in axes],
                           dtype=np.int64))

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def _key(self, axes) -> tuple:
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, *axes: str):
        key = self._key(axes)
        if self.size(*key) == 1:
            return None
        if key not in self._groups:
            raise KeyError(f"mesh {self.shape} has no process group over "
                           f"{key} (rank {self.rank} of {self.world})")
        return self._groups[key]

    def group_ranks(self, axes) -> List[List[int]]:
        """Every group over ``axes``: the global ranks that differ only on
        those axes, ascending, for each setting of the other axes (in C
        order of the other axes)."""
        key = self._key(axes)
        grid = np.arange(self.world).reshape(self.axis_shape)
        on = [self.axis_names.index(a) for a in key]
        off = [i for i in range(len(self.axis_names)) if i not in on]
        moved = np.transpose(grid, off + on).reshape(
            -1, self.size(*key) if key else 1)
        return [sorted(int(r) for r in row) for row in moved]


def _new_groups(mesh: Mesh) -> dict:
    """One process group per axis and per combined key in _COMBINED,
    each of more than one rank. Every rank calls ``new_group`` for every
    group in the same order (the ones it is not in too), or the ranks
    deadlock."""
    keys = [(a,) for a in mesh.axis_names]
    keys += [mesh._key(c) for c in _COMBINED if len(mesh._key(c)) > 1]
    out = {}
    for key in keys:
        if mesh.size(*key) == 1:
            continue
        for ranks in mesh.group_ranks(key):
            group = dist.new_group(ranks)
            if mesh.rank in ranks:
                out[key] = group
    return out


def build_mesh(axis_names: Sequence[str] = ("dp", "tp"),
               axis_shape: Optional[Sequence[int]] = None,
               world: Optional[int] = None, device=None) -> Mesh:
    """A Mesh over the ranks of the process group (or ``world`` ranks).

    Without an explicit ``axis_shape`` the world size is factored across
    the axes with the largest factor on the *last* (innermost) axis, as
    the reference factors its devices. When a process group of that size
    is running, the mesh holds this rank's coordinates and the groups;
    otherwise it is a mesh of shape alone, at rank 0."""
    running = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if running else 1
    if axis_shape is None:
        axis_shape = _factor(world, len(axis_names))
    size = 1
    for d in axis_shape:
        size *= d
    if size != world:
        raise ValueError(f"axis shape {tuple(axis_shape)} does not cover "
                         f"{world} devices")
    live = running and dist.get_world_size() == world
    mesh = Mesh(axis_names, axis_shape,
                rank=dist.get_rank() if live else 0, device=device,
                backend=dist.get_backend() if live else None)
    if live and world > 1:
        mesh._groups = _new_groups(mesh)
    return mesh


def backend_for(device) -> Tuple[str, str]:
    """(backend, why): ``nccl`` when every rank of the node has a card of
    its own, ``gloo`` when ranks share a card or run on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return "gloo", "ranks on the CPU"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    cards = torch.cuda.device_count()
    if local <= cards:
        return "nccl", f"{local} rank(s) on the node, {cards} card(s)"
    return "gloo", (f"{local} ranks share {cards} card(s); point-to-point "
                    f"and all-to-all tensors are staged through host memory")


# How long a collective waits for the other ranks before it raises: long
# enough for a rank that builds a kernel library first; a rank that died
# or hung stops the others within it.
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)


def init_process_group(device, init_method: str = "env://",
                       rank: Optional[int] = None,
                       world: Optional[int] = None) -> str:
    """Join the process group with the backend ``backend_for(device)``
    picks, logged with its reason, its collectives bounded by
    ``COLLECTIVE_TIMEOUT``; returns the backend. ``rank`` and
    ``world`` default to ``RANK`` and ``WORLD_SIZE``."""
    device = torch.device(device)
    rank = int(os.environ["RANK"]) if rank is None else rank
    world = int(os.environ["WORLD_SIZE"]) if world is None else world
    backend, why = backend_for(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=COLLECTIVE_TIMEOUT)
    log.info("process group: backend %s (%s); rank %d of %d on %s",
             backend, why, rank, world, device)
    return backend


def mesh_from_env(axis_names: Sequence[str] = ("dp", "tp"),
                  device=None) -> Mesh:
    """A Mesh over the ranks a launcher started (torchrun's ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``),
    joining the process group if it is not joined yet. Without that
    environment the world is one rank: one device. ``device`` is
    resolved by utils/device.py (None: this rank's card)."""
    device = resolve_device(device)
    wanted = visible_chip_indices()
    if wanted is not None:
        log.info("visible cards (CUDA_VISIBLE_DEVICES): %s", wanted)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not (
            dist.is_available() and dist.is_initialized()):
        init_process_group(device)
    return build_mesh(axis_names, device=device)
