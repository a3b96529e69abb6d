"""In-container bootstrap: the Python half of what Allocate injects.

Allocate mounts the staged shim directory (``plugin.grant.stage_shim``)
at /usr/local/vtpu/shim in every granted container and points
``PYTHONPATH`` at it, so the interpreter imports this module before any
user code: the Python counterpart of the ``/etc/ld.so.preload`` mount
(reference server.go:511-515).  ``vtpu``'s shim/sitecustomize.py, for a
PyTorch tenant:

- ``VTPU_EXTRA_PYTHONPATH`` entries go onto ``sys.path``;
- under ``VTPU_PYTHONPATH_MERGED=1`` one line says that Allocate kept the
  pod's own PYTHONPATH behind the shim's entry;
- ``pyshim.bootstrap()`` says which layer enforces the quota, and
  ``pyshim.install_py_enforcement()`` installs the Python enforcement
  where no interposer is in the process (it stands down under one, so
  nothing is charged twice);
- with ``VTPU_METRICSD_PORT`` (``--enable-metricsd``), the first Python
  process of the container to bind that port serves the pod's metricsd
  (``metricsd.server.maybe_start_in_container``); without it nothing of
  metricsd, and no ``grpc``, is imported.

Allocate's ``PYTHONPATH`` replaces one that the image set in its
Dockerfile's ENV (the kubelet puts the plugin's env over the image's);
a pod that needs such entries names them in ``VTPU_EXTRA_PYTHONPATH``.
A PYTHONPATH declared on the pod spec is merged by Allocate itself.

Without a grant in the environment this is a no-op: it leaves
``sys.path`` as it was and imports neither torch nor the enforcement.
It never raises: a broken shim must not stop the container's program.
"""

import os
import sys

_SHIM_DIR = os.path.dirname(os.path.abspath(__file__))


def _insert_extra_paths():
    """VTPU_EXTRA_PYTHONPATH entries go to the front of sys.path, after
    the first entry, so they keep PYTHONPATH's precedence over
    site-packages."""
    at = 1
    for p in os.environ.get("VTPU_EXTRA_PYTHONPATH", "").split(os.pathsep):
        if p and p not in sys.path:
            sys.path.insert(at, p)
            at += 1


def _warn_pythonpath_merge():
    """One line on stderr when Allocate merged a pod-declared PYTHONPATH
    behind the shim's entry, which the flag it sets beside the merge
    says."""
    if os.environ.get("VTPU_PYTHONPATH_MERGED") != "1":
        return
    shim_pp = os.environ.get("VTPU_SHIM_PYTHONPATH", _SHIM_DIR)
    merged = [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
              if p and os.path.abspath(p) != os.path.abspath(shim_pp)]
    if merged:
        print("[vtpu shim] PYTHONPATH merged: kept "
              f"{os.pathsep.join(merged)} after the vtpu shim entry",
              file=sys.stderr)


def _start_metricsd():
    """The pod's grant on the MetricService wire, served by the
    container's first process to bind the port; a failure is said and
    never stops the program."""
    try:
        from vtpu_torch.metricsd import server as metricsd

        metricsd.maybe_start_in_container()
    except Exception as e:  # noqa: BLE001 - the program starts regardless
        print(f"[vtpu shim] metricsd start failed: {e}", file=sys.stderr)


def _main():
    # The staged copy keeps the package beside this file; in the source
    # tree the package is found the usual way.
    if os.path.isdir(os.path.join(_SHIM_DIR, "vtpu_torch")) \
            and _SHIM_DIR not in sys.path:
        sys.path.insert(0, _SHIM_DIR)
    _insert_extra_paths()
    _warn_pythonpath_merge()
    try:
        from vtpu_torch.utils import envspec
    except ImportError:
        return
    if os.environ.get("VTPU_METRICSD_PORT"):
        _start_metricsd()
    spec = envspec.quota_from_env()
    if not (spec.hbm_limit_bytes or spec.core_limit_pct):
        return
    from vtpu_torch.shim import pyshim

    layer = pyshim.bootstrap()
    if layer == "interposer" \
            and os.environ.get("VTPU_FORCE_PY_ENFORCEMENT") == "1":
        print("[vtpu shim] VTPU_FORCE_PY_ENFORCEMENT ignored: the "
              "interposer enforces this quota, and the python enforcement "
              "beside it would charge every byte twice", file=sys.stderr)
    # vtpu's broker bridge (VTPU_RUNTIME_SOCKET) waits for ROADMAP Queue 1
    # item 6(e).
    try:
        pyshim.install_py_enforcement()
    except Exception as e:  # noqa: BLE001 - the program starts regardless
        print(f"[vtpu shim] enforcement install failed: {e}",
              file=sys.stderr)


try:
    _main()
except Exception as _e:  # noqa: BLE001 - never break the program's start
    print(f"[vtpu shim] bootstrap failed: {_e}", file=sys.stderr)
