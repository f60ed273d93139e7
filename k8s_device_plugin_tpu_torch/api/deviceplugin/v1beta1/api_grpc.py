"""Hand-written gRPC stubs for the kubelet device-plugin API.

The build environment has protoc (messages are generated into api_pb2.py by
tools/regen_protos.sh) but not the grpc_python_plugin, so the service
stubs/servicers that grpc_tools would emit are written by hand here. Method
paths must match the kubelet: /v1beta1.Registration/Register and
/v1beta1.DevicePlugin/<Method>.
"""

import grpc

from k8s_device_plugin_tpu_torch.api.deviceplugin.v1beta1 import api_pb2

_REGISTRATION = "v1beta1.Registration"
_DEVICE_PLUGIN = "v1beta1.DevicePlugin"


class RegistrationStub:
    """Client of the kubelet's Registration service (dial kubelet.sock)."""

    def __init__(self, channel: grpc.Channel):
        self.Register = channel.unary_unary(
            f"/{_REGISTRATION}/Register",
            request_serializer=api_pb2.RegisterRequest.SerializeToString,
            response_deserializer=api_pb2.Empty.FromString,
        )


class RegistrationServicer:
    """Server side of Registration — implemented by the kubelet; we ship it
    for the fake kubelet used in tests (the reference's biggest test gap,
    SURVEY.md section 4)."""

    def Register(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()


def add_RegistrationServicer_to_server(servicer, server):
    handlers = {
        "Register": grpc.unary_unary_rpc_method_handler(
            servicer.Register,
            request_deserializer=api_pb2.RegisterRequest.FromString,
            response_serializer=api_pb2.Empty.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(_REGISTRATION, handlers),)
    )


class DevicePluginStub:
    """Client of a device plugin — used by the kubelet (and our tests)."""

    def __init__(self, channel: grpc.Channel):
        self.GetDevicePluginOptions = channel.unary_unary(
            f"/{_DEVICE_PLUGIN}/GetDevicePluginOptions",
            request_serializer=api_pb2.Empty.SerializeToString,
            response_deserializer=api_pb2.DevicePluginOptions.FromString,
        )
        self.ListAndWatch = channel.unary_stream(
            f"/{_DEVICE_PLUGIN}/ListAndWatch",
            request_serializer=api_pb2.Empty.SerializeToString,
            response_deserializer=api_pb2.ListAndWatchResponse.FromString,
        )
        self.GetPreferredAllocation = channel.unary_unary(
            f"/{_DEVICE_PLUGIN}/GetPreferredAllocation",
            request_serializer=api_pb2.PreferredAllocationRequest.SerializeToString,
            response_deserializer=api_pb2.PreferredAllocationResponse.FromString,
        )
        self.Allocate = channel.unary_unary(
            f"/{_DEVICE_PLUGIN}/Allocate",
            request_serializer=api_pb2.AllocateRequest.SerializeToString,
            response_deserializer=api_pb2.AllocateResponse.FromString,
        )
        self.PreStartContainer = channel.unary_unary(
            f"/{_DEVICE_PLUGIN}/PreStartContainer",
            request_serializer=api_pb2.PreStartContainerRequest.SerializeToString,
            response_deserializer=api_pb2.PreStartContainerResponse.FromString,
        )


class DevicePluginServicer:
    """Base class for device-plugin implementations (the DevicePluginServer
    interface of the reference, plugin.go:210-397)."""

    def GetDevicePluginOptions(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()

    def ListAndWatch(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()

    def GetPreferredAllocation(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()

    def Allocate(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()

    def PreStartContainer(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()


def add_DevicePluginServicer_to_server(servicer, server):
    handlers = {
        "GetDevicePluginOptions": grpc.unary_unary_rpc_method_handler(
            servicer.GetDevicePluginOptions,
            request_deserializer=api_pb2.Empty.FromString,
            response_serializer=api_pb2.DevicePluginOptions.SerializeToString,
        ),
        "ListAndWatch": grpc.unary_stream_rpc_method_handler(
            servicer.ListAndWatch,
            request_deserializer=api_pb2.Empty.FromString,
            response_serializer=api_pb2.ListAndWatchResponse.SerializeToString,
        ),
        "GetPreferredAllocation": grpc.unary_unary_rpc_method_handler(
            servicer.GetPreferredAllocation,
            request_deserializer=api_pb2.PreferredAllocationRequest.FromString,
            response_serializer=api_pb2.PreferredAllocationResponse.SerializeToString,
        ),
        "Allocate": grpc.unary_unary_rpc_method_handler(
            servicer.Allocate,
            request_deserializer=api_pb2.AllocateRequest.FromString,
            response_serializer=api_pb2.AllocateResponse.SerializeToString,
        ),
        "PreStartContainer": grpc.unary_unary_rpc_method_handler(
            servicer.PreStartContainer,
            request_deserializer=api_pb2.PreStartContainerRequest.FromString,
            response_serializer=api_pb2.PreStartContainerResponse.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(_DEVICE_PLUGIN, handlers),)
    )
