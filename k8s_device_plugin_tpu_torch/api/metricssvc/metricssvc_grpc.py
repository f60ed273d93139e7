"""Hand-written gRPC stubs for metricssvc (see api_grpc.py for why)."""

import grpc

from k8s_device_plugin_tpu_torch.api.metricssvc import metricssvc_pb2

_SERVICE = "metricssvc.MetricsService"


class MetricsServiceStub:
    def __init__(self, channel: grpc.Channel):
        self.GetTPUState = channel.unary_unary(
            f"/{_SERVICE}/GetTPUState",
            request_serializer=metricssvc_pb2.TPUGetRequest.SerializeToString,
            response_deserializer=metricssvc_pb2.TPUStateResponse.FromString,
        )
        self.List = channel.unary_unary(
            f"/{_SERVICE}/List",
            request_serializer=metricssvc_pb2.Empty.SerializeToString,
            response_deserializer=metricssvc_pb2.TPUStateResponse.FromString,
        )


class MetricsServiceServicer:
    def GetTPUState(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()

    def List(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()


def add_MetricsServiceServicer_to_server(servicer, server):
    handlers = {
        "GetTPUState": grpc.unary_unary_rpc_method_handler(
            servicer.GetTPUState,
            request_deserializer=metricssvc_pb2.TPUGetRequest.FromString,
            response_serializer=metricssvc_pb2.TPUStateResponse.SerializeToString,
        ),
        "List": grpc.unary_unary_rpc_method_handler(
            servicer.List,
            request_deserializer=metricssvc_pb2.Empty.FromString,
            response_serializer=metricssvc_pb2.TPUStateResponse.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(_SERVICE, handlers),)
    )
