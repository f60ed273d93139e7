"""L3 device-plugin-manager machinery, first-party.

The reference vendors kubevirt's device-plugin-manager for this
(vendor/github.com/kubevirt/device-plugin-manager/pkg/dpm/, SURVEY.md
section 2 row 11 calls it "vendored but load-bearing"); our rebuild
implements it first-party: a Manager that watches the kubelet socket
directory, starts/stops per-resource plugin gRPC servers, registers them
with the kubelet (with retries), and handles SIGTERM. The node
remediation controller is not ported yet (ROADMAP A10).
"""

from k8s_device_plugin_tpu_torch.dpm.checkpoint import CheckpointStore
from k8s_device_plugin_tpu_torch.dpm.healthsm import HealthConfig, HealthStateMachine
from k8s_device_plugin_tpu_torch.dpm.lister import Lister
from k8s_device_plugin_tpu_torch.dpm.manager import Manager
from k8s_device_plugin_tpu_torch.dpm.plugin_server import DevicePluginServer

__all__ = [
    "CheckpointStore",
    "DevicePluginServer",
    "HealthConfig",
    "HealthStateMachine",
    "Lister",
    "Manager",
]
