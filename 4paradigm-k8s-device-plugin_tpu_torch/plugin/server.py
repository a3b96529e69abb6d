"""The device-plugin gRPC server: one ``VtpuDevicePlugin`` per resource
name, serving the kubelet v1beta1 API on its own unix socket.

``vtpu``'s servicer and lifecycle (its plugin/server.py:68-279), after the
reference's ``NvidiaDevicePlugin`` (reference server.go:62-655):
``serve()`` with a blocking self-dial, ``register()`` against
kubelet.sock, ``ListAndWatch`` streaming vdevice health, link-scored
``GetPreferredAllocation``, and ``Allocate``, which converts
``grant.grant()`` to protobuf.

In monitor mode Allocate finds the pending pod it serves through the pod
lister (``_match_pending_pod``) and gives it a region in its own shared
directory; under the legacy controller it re-picks the vdevices from the
kubelet's checkpoint (``controller.reallocate``) and stops advertising
preferred allocation, which the kubelet then does not ask for (vtpu
server.py:266-378, reference server.go:233-235, 365-457).
"""

from __future__ import annotations

import os
import threading
import time
from concurrent import futures
from typing import Dict, List, Optional, Tuple

import grpc

from ..discovery.types import GpuTopology, Health
from ..k8s.client import CachedPodLister
from ..proto import DEVICE_PLUGIN_VERSION, pb, rpc
from ..utils import logging as log
from .allocator import preferred_allocation
from .config import Config
from .grant import SHARED_DIR, PodMatch, grant
from .split import PluginSpec
from .vdevice import VDevice, vdevices_by_ids


class VtpuDevicePlugin(rpc.DevicePluginServicer):
    """One device-plugin service instance (resource name + unix socket)."""

    def __init__(self, spec: PluginSpec, cfg: Config,
                 topology: Optional[GpuTopology] = None, controller=None,
                 pod_lister=None):
        self.spec = spec
        self.cfg = cfg
        self.topology = topology
        # plugin.controller.VDeviceController, under
        # --enable-legacy-preferred.
        self.controller = controller
        # callable(node, fresh=False) -> [pod dict], in monitor mode; one
        # TTL cache shared by every Allocate, so an admission burst costs
        # about one API-server LIST.
        if pod_lister is not None \
                and not isinstance(pod_lister, CachedPodLister):
            pod_lister = CachedPodLister(pod_lister)
        self.pod_lister = pod_lister
        # Monitor mode: (pod uid, container) -> claim time of containers
        # matched to an Allocate already, so that two pending pods of one
        # size get distinct regions (the reference's matcher gives both
        # the first).  Allocate runs on a thread pool.
        self._matched_pods: Dict[Tuple[str, str], float] = {}
        self._matched_mu = threading.Lock()
        self.vdevices: List[VDevice] = list(spec.vdevices)
        self.socket_path = os.path.join(cfg.device_plugin_path,
                                        spec.socket_name)
        self._server: Optional[grpc.Server] = None
        self._stop = threading.Event()
        self._health_version = 0
        self._health_cond = threading.Condition()

    # -- lifecycle (reference server.go:132-243) ------------------------------

    def start(self, register: bool = True) -> None:
        """Serve and register; raises on failure so the daemon's restart
        loop can decide (reference Start, server.go:132-154)."""
        self._stop.clear()
        self.serve()
        if register:
            self.register()
        log.info("plugin %s serving on %s with %d vdevices",
                 self.spec.resource_name, self.socket_path,
                 len(self.vdevices))

    def serve(self) -> None:
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=8),
            options=[("grpc.max_receive_message_length", 16 << 20)])
        rpc.add_DevicePluginServicer_to_server(self, server)
        server.add_insecure_port(f"unix://{self.socket_path}")
        server.start()
        self._server = server
        # Blocking self-dial: the socket answers before we register
        # (reference server.go:210-215).
        ch = grpc.insecure_channel(f"unix://{self.socket_path}")
        try:
            grpc.channel_ready_future(ch).result(timeout=5)
        finally:
            ch.close()

    def register(self) -> None:
        """Register with the kubelet over its own socket (reference
        server.go:221-243)."""
        kubelet_sock = os.path.join(self.cfg.device_plugin_path,
                                    "kubelet.sock")
        ch = grpc.insecure_channel(f"unix://{kubelet_sock}")
        try:
            grpc.channel_ready_future(ch).result(timeout=5)
            rpc.RegistrationStub(ch).Register(pb.RegisterRequest(
                version=DEVICE_PLUGIN_VERSION,
                endpoint=self.spec.socket_name,
                resource_name=self.spec.resource_name,
                options=pb.DevicePluginOptions(
                    get_preferred_allocation_available=(
                        self.controller is None))))
        finally:
            ch.close()

    def stop(self) -> None:
        self._stop.set()
        with self._health_cond:
            self._health_cond.notify_all()
        if self._server is not None:
            self._server.stop(grace=1).wait()
            self._server = None
        if os.path.exists(self.socket_path):
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass

    # -- health (reference nvidia.go:166-237 -> server.go:254-268) ------------

    def _bump(self) -> None:
        with self._health_cond:
            self._health_version += 1
            self._health_cond.notify_all()

    def set_chip_health(self, chip_uuid: str, health: Health,
                        reason: str = "") -> None:
        changed = False
        for v in self.vdevices:
            if v.chip_uuid == chip_uuid and v.health != health:
                v.health = health
                changed = True
        if changed:
            if health is Health.UNHEALTHY:
                log.warn("card %s unhealthy: %s", chip_uuid, reason)
            self._bump()

    def set_all_unhealthy(self, reason: str = "") -> None:
        for v in self.vdevices:
            v.health = Health.UNHEALTHY
        log.warn("all vdevices unhealthy: %s", reason)
        self._bump()

    # -- the gRPC surface ----------------------------------------------------

    def GetDevicePluginOptions(self, request, context):
        return pb.DevicePluginOptions(
            get_preferred_allocation_available=self.controller is None)

    def _api_devices(self) -> List[pb.Device]:
        """vdevices as kubelet Devices, with NUMA topology hints
        (reference apiDevices/buildDevice, server.go:583-596 and
        nvidia.go:148-164)."""
        out = []
        for v in self.vdevices:
            d = pb.Device(ID=v.id, health=v.health.value)
            if v.chip.numa_node is not None:
                d.topology.nodes.add(ID=v.chip.numa_node)
            out.append(d)
        return out

    def ListAndWatch(self, request, context):
        """The device list, then again at every health change (reference
        server.go:254-268)."""
        last_sent = -1
        while not self._stop.is_set() and context.is_active():
            with self._health_cond:
                version = self._health_version
                if version == last_sent:
                    self._health_cond.wait(timeout=5.0)
                    version = self._health_version
            if version != last_sent:
                last_sent = version
                yield pb.ListAndWatchResponse(devices=self._api_devices())

    def GetPreferredAllocation(self, request, context):
        resp = pb.PreferredAllocationResponse()
        for creq in request.container_requests:
            available = vdevices_by_ids(self.vdevices,
                                        creq.available_deviceIDs)
            must = vdevices_by_ids(self.vdevices,
                                   creq.must_include_deviceIDs)
            chosen = preferred_allocation(available, must,
                                          creq.allocation_size,
                                          self.topology,
                                          policy=self.cfg.allocation_policy)
            resp.container_responses.add(deviceIDs=[v.id for v in chosen])
        return resp

    def PreStartContainer(self, request, context):
        return pb.PreStartContainerResponse()

    def Allocate(self, request, context):
        """One ``grant()`` per container request (reference
        server.go:361-533)."""
        resp = pb.AllocateResponse()
        for creq in request.container_requests:
            ids = list(creq.devicesIDs)
            # Under the legacy controller the kubelet's IDs may be stale
            # substitutes: reconcile from its checkpoint and re-pick
            # (reference server.go:408-457).
            using = (self.controller.reallocate(self, ids)
                     if self.controller is not None else ids)
            vdevs = vdevices_by_ids(self.vdevices, using)
            pod_env, shared = self._pod_of(len(vdevs))
            g = grant(self.cfg, self.spec, vdevs, ids, pod_env=pod_env,
                      shared_name=shared,
                      annotate=self.controller is not None)
            car = resp.container_responses.add()
            for k, v in g.envs.items():
                car.envs[k] = v
            for m in g.mounts:
                car.mounts.add(container_path=m.container_path,
                               host_path=m.host_path, read_only=m.read_only)
            for d in g.devices:
                car.devices.add(container_path=d.container_path,
                                host_path=d.host_path,
                                permissions=d.permissions)
            for k, v in g.annotations.items():
                car.annotations[k] = v
        return resp

    # -- monitor mode (vtpu server.py:280-378) --------------------------------

    def _pod_of(self, n_vdevices: int) -> Tuple[Dict[str, str],
                                                Optional[str]]:
        """(the env the served pod declares, the name of its directory
        under the host's shared/, made here) in monitor mode; ({}, None)
        otherwise or when no pod matches.  A pod whose directory cannot
        be made keeps its env, gets a private region instead, and its
        claim is released: it was not served."""
        if not (self.cfg.monitor_mode and self.pod_lister is not None):
            return {}, None
        match = self._match_pending_pod(n_vdevices)
        if match is None:
            return {}, None
        try:
            # The region's open (O_CREAT) cannot make its directory.
            os.makedirs(os.path.join(self.cfg.host_lib_dir, SHARED_DIR,
                                     match.shared_name), exist_ok=True)
        except OSError as e:
            log.warn("cannot create the shared dir of %s: %s",
                     match.shared_name, e)
            with self._matched_mu:
                self._matched_pods.pop((match.uid, match.container), None)
            return match.env, None
        return match.env, match.shared_name

    def _match_pending_pod(self, n_vdevices: int) -> Optional[PodMatch]:
        """The pending pod container this Allocate serves, found by its
        limit of this resource against the request's size: Allocate
        carries no pod identity (reference server.go:365-406).  Containers
        matched before in this plugin generation are skipped, so two
        same-sized pending pods resolve to distinct directories; when all
        are claimed (a kubelet retry), the oldest claim is reused.  The
        match is a heuristic, as the reference's: a double Allocate that
        races a second same-sized pod can swap two pods' directories,
        which misattributes monitoring only, since enforcement keys off
        the region the container is given."""
        def scan(pods):
            cand, live_ = [], set()
            for pod in pods:
                meta = pod.get("metadata", {})
                uid = meta.get("uid", "nouid")
                for ctr in pod.get("spec", {}).get("containers", []):
                    live_.add((uid, ctr.get("name", "ctr")))
                if pod.get("status", {}).get("phase") != "Pending":
                    continue
                for ctr in pod.get("spec", {}).get("containers", []):
                    limits = ctr.get("resources", {}).get("limits", {})
                    want = limits.get(self.spec.resource_name)
                    if want is None or int(want) != n_vdevices:
                        continue
                    env = {ev.get("name"): ev.get("value", "")
                           for ev in ctr.get("env", []) or []
                           if ev.get("name") and "valueFrom" not in ev}
                    cand.append(PodMatch(meta.get("namespace", "default"),
                                         meta.get("name", "pod"),
                                         ctr.get("name", "ctr"), uid, env))
            return cand, live_

        try:
            candidates, live = scan(self.pod_lister(self.cfg.node_name))
            with self._matched_mu:
                has_unclaimed = any((c.uid, c.container)
                                    not in self._matched_pods
                                    for c in candidates)
            if not has_unclaimed:
                # The pod may have been created inside the cache's TTL:
                # one fresh list before reusing a claim.
                candidates, live = scan(
                    self.pod_lister(self.cfg.node_name, fresh=True))
        except Exception as e:  # noqa: BLE001 - monitor mode is best-effort
            log.warn("monitor mode pod list failed: %s", e)
            return None
        with self._matched_mu:
            # Drop the claims of pods no longer on the node.
            for key in [k for k in self._matched_pods if k not in live]:
                del self._matched_pods[key]
            if not candidates:
                return None
            unclaimed = [c for c in candidates
                         if (c.uid, c.container) not in self._matched_pods]
            chosen = unclaimed[0] if unclaimed else min(
                candidates,
                key=lambda c: self._matched_pods[(c.uid, c.container)])
            self._matched_pods[(chosen.uid, chosen.container)] = \
                time.monotonic()
            return chosen
