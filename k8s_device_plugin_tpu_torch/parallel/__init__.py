"""Parallelism on ``torch.distributed``: the counterpart of
``k8s_device_plugin_tpu/parallel/``. The mesh over ranks (mesh.py), the
collectives as autograd Functions (comm.py), the tp / ep parameter rules
and the batch slicer (sharding.py), ring attention and Ulysses over
``sp`` on the flash kernels (ring_attention.py, ulysses.py), the ranks
of one serving daemon (serve_ranks.py: rank 0 serves, the others run
its engine calls), the pipelines over ``pp`` (pipeline.py: the GPipe
forward and each rank's stage rows; pipeline_1f1b.py and
pipeline_interleaved.py: the 1F1B and interleaved training schedules),
and a spawn helper for tests and chip_smoke.py (launch.py, with the
ranks' worker functions in workers.py)."""

from k8s_device_plugin_tpu_torch.parallel.mesh import (
    build_mesh,
    mesh_from_env,
    visible_chip_indices,
)
from k8s_device_plugin_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    shard_stage_params,
)
from k8s_device_plugin_tpu_torch.parallel.pipeline_1f1b import (
    pipeline_value_and_grad,
)
from k8s_device_plugin_tpu_torch.parallel.pipeline_interleaved import (
    build_schedule,
    interleave_stack,
    interleaved_pipeline_value_and_grad,
)
from k8s_device_plugin_tpu_torch.parallel.sharding import (
    batch_sharding,
    shard_params_for_tp,
)

__all__ = ["batch_sharding", "build_mesh", "build_schedule",
           "interleave_stack", "interleaved_pipeline_value_and_grad",
           "mesh_from_env", "pipeline_apply", "pipeline_value_and_grad",
           "shard_params_for_tp", "shard_stage_params",
           "visible_chip_indices"]
