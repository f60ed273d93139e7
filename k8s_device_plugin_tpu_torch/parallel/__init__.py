"""Parallelism on ``torch.distributed``: the counterpart of
``k8s_device_plugin_tpu/parallel/``. The mesh over ranks (mesh.py), the
collectives as autograd Functions (comm.py), the tp / ep parameter rules
and the batch slicer (sharding.py), ring attention and Ulysses over
``sp`` on the flash kernels (ring_attention.py, ulysses.py), the ranks
of one serving daemon (serve_ranks.py: rank 0 serves, the others run
its engine calls), and a spawn helper for tests and chip_smoke.py
(launch.py, with the ranks' worker functions in workers.py)."""

from k8s_device_plugin_tpu_torch.parallel.mesh import (
    build_mesh,
    mesh_from_env,
    visible_chip_indices,
)
from k8s_device_plugin_tpu_torch.parallel.sharding import (
    batch_sharding,
    shard_params_for_tp,
)

__all__ = ["batch_sharding", "build_mesh", "mesh_from_env",
           "shard_params_for_tp", "visible_chip_indices"]
