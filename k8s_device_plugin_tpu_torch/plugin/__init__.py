"""L3 plugin core: the kubelet DevicePlugin implementation for nvidia.com/gpu.

Counterpart of the reference's plugin package (itself the Go reference's
internal/pkg/plugin): the 5 DevicePlugin RPCs, the Lister the dpm Manager
drives, and the resource-naming strategy. ``GPUDevicePlugin`` and
``GPULister`` import gRPC and load on first use, so the grpc-free part
(``config``, ``allocation``, ``resource_naming``) imports without it.
"""

from k8s_device_plugin_tpu_torch.plugin.config import PluginConfig
from k8s_device_plugin_tpu_torch.plugin.resource_naming import (
    Strategy,
    get_resource_list,
    parse_strategy,
)

__all__ = [
    "GPUDevicePlugin",
    "GPULister",
    "PluginConfig",
    "Strategy",
    "get_resource_list",
    "parse_strategy",
]


def __getattr__(name):
    if name in ("GPUDevicePlugin", "GPULister"):
        from k8s_device_plugin_tpu_torch.plugin import plugin

        return getattr(plugin, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
