"""``python -m vtpu_torch.metricsd``: serve a pod's grant on the
MetricService wire (``--fake`` for a synthetic tenant, ``--selftest`` for
the smoke test)."""

from .server import main

if __name__ == "__main__":
    raise SystemExit(main())
