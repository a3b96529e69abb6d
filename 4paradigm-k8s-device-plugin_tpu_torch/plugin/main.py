"""Daemon entrypoint: flag parsing, card inventory, plugin restart loop.

The reference's main.go: validate flags, write the PCI inventory file,
discover the cards with fail-or-block semantics, then a ``goto restart``
loop that rebuilds every plugin when the kubelet socket is recreated or on
SIGHUP, and exits on other signals (reference main.go:48-293); ``vtpu``'s
plugin/main.py without the broker (not ported).  In monitor mode and
under the legacy controller the plugins share one pod lister, built from
the service account in the cluster (an informer in monitor mode).

Run: ``python -m vtpu_torch.plugin.main --discovery fake --device-split-count 4``
"""

from __future__ import annotations

import os
import queue
import signal
import sys
import threading
import time
from typing import List, Optional

from ..discovery.base import ChipBackend
from ..discovery.factory import make_backend
from ..discovery.types import GpuChip, Health
from ..k8s.client import CachedPodLister, K8sClient, PodInformer
from ..k8s.client import pod_lister as make_lister
from ..utils import logging as log
from .config import Config, parse_args
from .controller import VDeviceController
from .grant import stage_busy_files
from .server import VtpuDevicePlugin
from .split import build_plugin_specs
from .watchers import FsWatcher, SignalWatcher


def write_chip_inventory(cfg: Config, chips: List[GpuChip]) -> None:
    """Write the node's card inventory for in-container tools — the
    reference's lspci → $PCIBUSFILE scan (reference main.go:164-185,
    consumed as pciinfo.vgpu).  One line a card: index, UUID, PCI bus,
    memory bytes, SM count, then the model name (which has spaces)."""
    if not cfg.pcibus_file:
        return
    os.makedirs(os.path.dirname(cfg.pcibus_file) or ".", exist_ok=True)
    with open(cfg.pcibus_file, "w") as f:
        for c in chips:
            f.write(f"{c.index} {c.uuid} {c.pci_bus_id or '-'} "
                    f"{c.hbm_bytes} {c.sm_count} {c.model}\n")
    log.info("wrote card inventory (%d cards) to %s", len(chips),
             cfg.pcibus_file)


class Daemon:
    """Owns the plugin set and the health loop across restarts."""

    def __init__(self, cfg: Config, backend: Optional[ChipBackend] = None,
                 pod_lister=None):
        self.cfg = cfg
        self.backend = backend
        self.plugins: List[VtpuDevicePlugin] = []
        # Given in tests; otherwise built from the service account when
        # monitor mode or the controller needs one (reference
        # server.go:365-406, vdevice-controller.go:162-223).
        self.pod_lister = pod_lister
        # Fresh per generation: a slow probe can outlive stop_plugins()'s
        # bounded join, and reusing one Event would un-stop that stale
        # loop on the next start.
        self._health_stop: Optional[threading.Event] = None
        self._health_thread: Optional[threading.Thread] = None

    def _make_pod_lister(self):
        """The one TTL-cached pod lister every plugin and the controller
        share, or None when neither mode needs one or the daemon has no
        credentials in the cluster.  In monitor mode plain reads come from
        a watch-based informer (``VTPU_POD_INFORMER=0``: the TTL cache
        alone); the controller reads fresh lists only, since it frees the
        vdevices of pods it does not see."""
        if self.pod_lister is not None:
            if not isinstance(self.pod_lister, CachedPodLister):
                self.pod_lister = CachedPodLister(self.pod_lister)
            return self.pod_lister
        if not (self.cfg.monitor_mode or self.cfg.enable_legacy_preferred):
            return None
        client = K8sClient()
        if not client.available:
            log.warn("monitor/legacy mode requested but no in-cluster "
                     "credentials; pod matching disabled")
            return None
        if not self.cfg.node_name:
            log.warn("no --node-name (NODE_NAME): the pod lister lists every "
                     "pod of the cluster")
        informer = None
        if self.cfg.monitor_mode and \
                os.environ.get("VTPU_POD_INFORMER", "1") != "0":
            informer = PodInformer(client, self.cfg.node_name).start()
            if not informer.wait_synced(5.0):
                log.warn("pod informer slow to sync; reads take the LIST "
                         "path meanwhile")
        self.pod_lister = CachedPodLister(make_lister(client),
                                          informer=informer)
        return self.pod_lister

    def start_plugins(self) -> bool:
        """Discover, split, serve, register.  False on an init error the
        caller handles per --fail-on-init-error (reference
        main.go:186-199, 225-252)."""
        if self.backend is None:
            self.backend = make_backend(self.cfg.discovery)
        chips = self.backend.chips()
        if not chips:
            log.error("no NVIDIA cards discovered (discovery=%s)",
                      self.cfg.discovery)
            return False
        write_chip_inventory(self.cfg, chips)
        try:
            stage_busy_files(self.cfg.host_lib_dir, [c.uuid for c in chips])
        except (OSError, ValueError) as e:
            log.error("cannot stage the cards' busy files under %s (%s): "
                      "Allocate will refuse to mount them",
                      self.cfg.host_lib_dir, e)
        lister = self._make_pod_lister()
        controller = (VDeviceController(self.cfg, pod_lister=lister)
                      if self.cfg.enable_legacy_preferred else None)
        topo = self.backend.topology()
        plugins = [VtpuDevicePlugin(s, self.cfg, topology=topo,
                                    controller=controller, pod_lister=lister)
                   for s in build_plugin_specs(self.cfg, self.backend)]
        started: List[VtpuDevicePlugin] = []
        for p in plugins:
            try:
                p.start(register=True)
                started.append(p)
            except Exception as e:  # noqa: BLE001 - kubelet may be down
                log.error("plugin %s failed to start: %s",
                          p.spec.resource_name, e)
                for q in started:
                    q.stop()
                return False
        self.plugins = started
        self._start_health_loop(chips)
        return True

    def stop_plugins(self) -> None:
        if self._health_stop is not None:
            self._health_stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=2)
            self._health_thread = None
        for p in self.plugins:
            p.stop()
        self.plugins = []

    def _start_health_loop(self, chips: List[GpuChip]) -> None:
        """Backend health loop -> vdevice health -> ListAndWatch refresh
        (reference nvidia.go:139-141, 166-237).  Off with
        VTPU_DISABLE_HEALTHCHECKS=all (reference DP_DISABLE_HEALTHCHECKS)."""
        if os.environ.get("VTPU_DISABLE_HEALTHCHECKS", "") == "all":
            return
        stop = threading.Event()
        self._health_stop = stop
        plugins = list(self.plugins)

        def on_unhealthy(chip: GpuChip, reason: str):
            for p in plugins:
                p.set_chip_health(chip.uuid, Health.UNHEALTHY, reason)

        def on_healthy(chip: GpuChip):
            # The reference never un-flips a device (server.go:262 FIXME);
            # a card that probes clean again is advertised again.
            log.info("card %s recovered; re-advertising", chip.uuid)
            for p in plugins:
                p.set_chip_health(chip.uuid, Health.HEALTHY, "recovered")

        def run():
            try:
                self.backend.check_health(stop, chips, on_unhealthy,
                                          on_healthy)
            except Exception as e:  # noqa: BLE001
                # A dead health loop must not take the daemon down; mark
                # everything unhealthy instead (reference nvidia.go:183-192).
                log.error("health loop failed: %s", e)
                for p in plugins:
                    p.set_all_unhealthy(f"health loop failed: {e}")

        self._health_thread = threading.Thread(target=run, daemon=True,
                                               name="vtpu-health")
        self._health_thread.start()


def run(cfg: Config, backend: Optional[ChipBackend] = None,
        max_restarts: Optional[int] = None) -> int:
    """The restart loop (reference main.go:212-292).  ``max_restarts``
    bounds it for tests; None runs forever."""
    log.info("vtpu-device-plugin starting (split=%d, strategy=%s, "
             "memory-scaling=%.2f)", cfg.device_split_count,
             cfg.split_strategy, cfg.device_memory_scaling)
    daemon = Daemon(cfg, backend)
    kubelet_sock = os.path.join(cfg.device_plugin_path, "kubelet.sock")
    fs = FsWatcher(kubelet_sock).start()
    sigs = SignalWatcher().install()
    restarts = 0
    try:
        while True:
            if not daemon.start_plugins():
                if cfg.fail_on_init_error:
                    log.error("init failed; exiting (--fail-on-init-error)")
                    return 1
                log.warn("init failed; idling until kubelet restart/signal "
                         "(--fail-on-init-error=false)")
            restart = False
            while not restart:
                try:
                    ev = fs.events.get(timeout=0.5)
                    if ev.op == "create":
                        log.info("kubelet socket recreated; restarting "
                                 "plugins")
                        restart = True
                except queue.Empty:
                    pass
                while not sigs.events.empty():
                    signum = sigs.events.get_nowait()
                    if signum == signal.SIGHUP:
                        log.info("SIGHUP; restarting plugins")
                        restart = True
                    else:
                        log.info("signal %d; shutting down", signum)
                        return 0
            daemon.stop_plugins()
            restarts += 1
            if max_restarts is not None and restarts >= max_restarts:
                return 0
            time.sleep(0.2)
    finally:
        daemon.stop_plugins()
        fs.stop()


def main(argv: Optional[List[str]] = None) -> int:
    cfg = parse_args(argv)
    if cfg.verbose:
        os.environ.setdefault("VTPU_LOG_LEVEL", "4")
        log.refresh_level()
    return run(cfg)


if __name__ == "__main__":
    sys.exit(main())
