"""vtpu-metricsd: a pod's grant, served on the MetricService wire.

``vtpu``'s metricsd (``metricsd/``) over the port's region.  It serves
the MetricService protocol (``proto/tpu_metrics.proto``, the wire and
metric names of ``vtpu``'s, kept so that every client of ``vtpu``'s
metricsd reads the port's unchanged) with the pod's view of its cards:

  - HBM total   = the pod's HBM cap (never the card's 80 GB);
  - HBM usage   = the pod's ledger in its region, the number ``vtpu-smi``
    shows;
  - duty cycle  = the pod's own device time, from the region's
    ``busy_us``, rescaled so that 100 means all of its compute share;
  - devices     = the granted ordinals only (``VTPU_DEVICE_MAP``).

On the H100 the stock tool is ``nvidia-smi``, which reads NVML, and the
interposer's NVML hooks give it the same view
(``native/interposer.cc``: memory, and utilisation by the same duty
rule).  metricsd is what the node's Prometheus exporter
(``tools/metrics_server.py --metricsd``) and ``vtpu-smi metricsd``
scrape.  A CUDA node runs no runtime metrics service of its own, so
there is nothing to pass other metrics on to: they answer NOT_FOUND.  A
brokered pod's ledger and SLO come from the broker's bind-free STATS and
SLO verbs (``backend.RegionBackend``); without a broker the SLO metrics
answer with no values, as ``vtpu``'s do.
"""

from __future__ import annotations

# RPC registry (vtpu's metricsd/__init__.py): every RPC named here has a
# stub binding and a servicer method in proto/tpu_metrics_grpc.py and an
# implementation in metricsd/server.py.
METRICSD_RPCS = ("GetRuntimeMetric", "ListSupportedMetrics")

# The port metricsd binds in the container (Allocate's VTPU_METRICSD_PORT).
DEFAULT_PORT = 8431
