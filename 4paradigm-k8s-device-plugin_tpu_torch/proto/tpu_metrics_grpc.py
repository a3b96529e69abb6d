"""gRPC service glue for the MetricService protocol (tpu_metrics.proto).

Hand-written, as ``deviceplugin_grpc.py`` is: the stub, servicer and
registration helper for
``tpu.monitoring.runtime.v2alpha1.RuntimeMetricService``, the service
vtpu-metricsd serves (``metricsd/server.py``), and the stub through which
the tools (``tools/vtpu_smi.py metricsd``, ``tools/metrics_server.py
--metricsd``) read it.
"""

from __future__ import annotations

import grpc

from . import tpu_metrics_pb2 as mpb

_SVC = "tpu.monitoring.runtime.v2alpha1.RuntimeMetricService"


class RuntimeMetricServiceStub:
    def __init__(self, channel: grpc.Channel):
        self.GetRuntimeMetric = channel.unary_unary(
            f"/{_SVC}/GetRuntimeMetric",
            request_serializer=mpb.MetricRequest.SerializeToString,
            response_deserializer=mpb.MetricResponse.FromString,
        )
        self.ListSupportedMetrics = channel.unary_unary(
            f"/{_SVC}/ListSupportedMetrics",
            request_serializer=(
                mpb.ListSupportedMetricsRequest.SerializeToString),
            response_deserializer=mpb.ListSupportedMetricsResponse.FromString,
        )


class RuntimeMetricServiceServicer:
    def GetRuntimeMetric(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()

    def ListSupportedMetrics(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()


def add_RuntimeMetricServiceServicer_to_server(servicer, server):
    handlers = {
        "GetRuntimeMetric": grpc.unary_unary_rpc_method_handler(
            servicer.GetRuntimeMetric,
            request_deserializer=mpb.MetricRequest.FromString,
            response_serializer=mpb.MetricResponse.SerializeToString,
        ),
        "ListSupportedMetrics": grpc.unary_unary_rpc_method_handler(
            servicer.ListSupportedMetrics,
            request_deserializer=mpb.ListSupportedMetricsRequest.FromString,
            response_serializer=(
                mpb.ListSupportedMetricsResponse.SerializeToString),
        ),
    }
    server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler(_SVC, handlers),))
