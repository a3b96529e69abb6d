"""The node's and the pod's tools over the port's regions: ``vtpu_smi``
(every region on the node), ``tpu_info`` (the pod's cards, as its grant
gives them) and ``metrics_server`` (the node's Prometheus exporter)."""
