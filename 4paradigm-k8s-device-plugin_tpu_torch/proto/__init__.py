"""gRPC bindings for the kubelet device-plugin v1beta1 API: the port's own
copies of ``vtpu``'s.  ``deviceplugin_pb2.py`` is protoc's output for the
API's ``deviceplugin.proto`` (the descriptor and wire names are the
kubelet's, so it sees no difference); ``deviceplugin_grpc.py`` is the
hand-written service glue.

Also here: the MetricService protocol vtpu-metricsd speaks
(``tpu_metrics.proto``, ``tpu_metrics_pb2.py``, ``tpu_metrics_grpc.py``),
imported directly, not re-exported.  Only this package,
``plugin/server.py``, ``metricsd/server.py`` and ``tools/vtpu_smi.py``
import ``grpc`` and ``google.protobuf``."""

from . import deviceplugin_pb2 as pb  # noqa: F401
from . import deviceplugin_grpc as rpc  # noqa: F401

DEVICE_PLUGIN_VERSION = "v1beta1"
