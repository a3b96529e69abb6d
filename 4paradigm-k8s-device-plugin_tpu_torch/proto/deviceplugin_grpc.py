"""gRPC service glue for the device-plugin v1beta1 API.

Hand-written (the image has grpcio but not grpcio-tools), equivalent to what
``protoc --grpc_python_out`` would emit for deviceplugin.proto: stubs +
servicers + registration helpers for the two services the kubelet speaks —
``Registration`` (kubelet side, reference server.go:221-243 dials it) and
``DevicePlugin`` (plugin side, reference server.go:246-538 serves it).
"""

from __future__ import annotations

import grpc

from . import deviceplugin_pb2 as pb

_PKG = "v1beta1"


# ---------------------------------------------------------------------------
# Registration service (served by kubelet; we also serve it in the test
# kubelet simulator).
# ---------------------------------------------------------------------------

class RegistrationStub:
    def __init__(self, channel: grpc.Channel):
        self.Register = channel.unary_unary(
            f"/{_PKG}.Registration/Register",
            request_serializer=pb.RegisterRequest.SerializeToString,
            response_deserializer=pb.Empty.FromString,
        )


class RegistrationServicer:
    def Register(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()


def add_RegistrationServicer_to_server(servicer, server):
    handlers = {
        "Register": grpc.unary_unary_rpc_method_handler(
            servicer.Register,
            request_deserializer=pb.RegisterRequest.FromString,
            response_serializer=pb.Empty.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler(f"{_PKG}.Registration",
                                             handlers),))


# ---------------------------------------------------------------------------
# DevicePlugin service (served by each plugin on its own unix socket).
# ---------------------------------------------------------------------------

class DevicePluginStub:
    def __init__(self, channel: grpc.Channel):
        self.GetDevicePluginOptions = channel.unary_unary(
            f"/{_PKG}.DevicePlugin/GetDevicePluginOptions",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.DevicePluginOptions.FromString,
        )
        self.ListAndWatch = channel.unary_stream(
            f"/{_PKG}.DevicePlugin/ListAndWatch",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.ListAndWatchResponse.FromString,
        )
        self.GetPreferredAllocation = channel.unary_unary(
            f"/{_PKG}.DevicePlugin/GetPreferredAllocation",
            request_serializer=pb.PreferredAllocationRequest.SerializeToString,
            response_deserializer=pb.PreferredAllocationResponse.FromString,
        )
        self.Allocate = channel.unary_unary(
            f"/{_PKG}.DevicePlugin/Allocate",
            request_serializer=pb.AllocateRequest.SerializeToString,
            response_deserializer=pb.AllocateResponse.FromString,
        )
        self.PreStartContainer = channel.unary_unary(
            f"/{_PKG}.DevicePlugin/PreStartContainer",
            request_serializer=pb.PreStartContainerRequest.SerializeToString,
            response_deserializer=pb.PreStartContainerResponse.FromString,
        )


class DevicePluginServicer:
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
            request_deserializer=pb.Empty.FromString,
            response_serializer=pb.DevicePluginOptions.SerializeToString,
        ),
        "ListAndWatch": grpc.unary_stream_rpc_method_handler(
            servicer.ListAndWatch,
            request_deserializer=pb.Empty.FromString,
            response_serializer=pb.ListAndWatchResponse.SerializeToString,
        ),
        "GetPreferredAllocation": grpc.unary_unary_rpc_method_handler(
            servicer.GetPreferredAllocation,
            request_deserializer=pb.PreferredAllocationRequest.FromString,
            response_serializer=pb.PreferredAllocationResponse.SerializeToString,
        ),
        "Allocate": grpc.unary_unary_rpc_method_handler(
            servicer.Allocate,
            request_deserializer=pb.AllocateRequest.FromString,
            response_serializer=pb.AllocateResponse.SerializeToString,
        ),
        "PreStartContainer": grpc.unary_unary_rpc_method_handler(
            servicer.PreStartContainer,
            request_deserializer=pb.PreStartContainerRequest.FromString,
            response_serializer=pb.PreStartContainerResponse.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler(f"{_PKG}.DevicePlugin",
                                             handlers),))
