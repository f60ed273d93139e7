"""Device-plugin API constants (upstream constants.go equivalents).

The kubelet side is the reference's; the resource is the one every GPU
pod spec asks for, ``nvidia.com/gpu``.
"""

HEALTHY = "Healthy"
UNHEALTHY = "Unhealthy"

VERSION = "v1beta1"
DEVICE_PLUGIN_PATH = "/var/lib/kubelet/device-plugins/"
KUBELET_SOCKET_NAME = "kubelet.sock"
KUBELET_SOCKET = DEVICE_PLUGIN_PATH + KUBELET_SOCKET_NAME

# The resource namespace and the whole-GPU resource: nvidia.com/gpu.
RESOURCE_NAMESPACE = "nvidia.com"
RESOURCE_GPU = "gpu"
