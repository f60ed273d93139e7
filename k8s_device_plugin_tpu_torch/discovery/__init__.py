"""L1 hardware discovery for NVIDIA GPUs.

GPU counterpart of the reference's TPU discovery (itself the counterpart
of the Go reference's ``internal/pkg/amdgpu``). Public surface:

  get_gpu_chips()            <- get_tpu_chips()   / GetAMDGPUs()
  gpu_topology()             <- host_topology()   (TPUTopology)
  is_homogeneous()           <- IsHomogeneous()         (amdgpu.go:298)
  dev_functional()           <- DevFunctional()         (amdgpu.go:390)
  generation_name()          <- GetCardFamilyName()     (amdgpu.go:86)
  product_name()             <- GetCardProductName()    (amdgpu.go:551)

Where the reference walks the accel class tree and the VFIO bindings,
optionally through its C++ libtpuinfo, the port asks NVML, the driver's
own library (k8s_device_plugin_tpu_torch/native/binding.py), and walks
``/proc/driver/nvidia`` and ``/sys/bus/pci`` without it.
"""

from k8s_device_plugin_tpu_torch.discovery.chips import (
    DiscoveryError,
    GPUChip,
    dev_functional,
    fatal_on_driver_unavailable,
    generation_name,
    get_gpu_chips,
    is_homogeneous,
    product_name,
)
from k8s_device_plugin_tpu_torch.discovery.topology import (
    GPUTopology,
    gpu_topology,
)

__all__ = [
    "DiscoveryError",
    "GPUChip",
    "GPUTopology",
    "dev_functional",
    "fatal_on_driver_unavailable",
    "generation_name",
    "get_gpu_chips",
    "gpu_topology",
    "is_homogeneous",
    "product_name",
]
