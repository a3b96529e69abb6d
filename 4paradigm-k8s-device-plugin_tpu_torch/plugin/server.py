"""The device-plugin gRPC server: one ``VtpuDevicePlugin`` per resource
name, serving the kubelet v1beta1 API on its own unix socket.

``vtpu``'s servicer and lifecycle (its plugin/server.py:68-279), after the
reference's ``NvidiaDevicePlugin`` (reference server.go:62-655):
``serve()`` with a blocking self-dial, ``register()`` against
kubelet.sock, ``ListAndWatch`` streaming vdevice health, link-scored
``GetPreferredAllocation``, and ``Allocate``, which converts
``grant.grant()`` to protobuf.  Without the legacy controller (not ported)
the plugin always scores preferred allocations itself.
"""

from __future__ import annotations

import os
import threading
from concurrent import futures
from typing import List, Optional

import grpc

from ..discovery.types import GpuTopology, Health
from ..proto import DEVICE_PLUGIN_VERSION, pb, rpc
from ..utils import logging as log
from .allocator import preferred_allocation
from .config import Config
from .grant import grant
from .split import PluginSpec
from .vdevice import VDevice, vdevices_by_ids

class VtpuDevicePlugin(rpc.DevicePluginServicer):
    """One device-plugin service instance (resource name + unix socket)."""

    def __init__(self, spec: PluginSpec, cfg: Config,
                 topology: Optional[GpuTopology] = None):
        self.spec = spec
        self.cfg = cfg
        self.topology = topology
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
                    get_preferred_allocation_available=True)))
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
        return pb.DevicePluginOptions(get_preferred_allocation_available=True)

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
            g = grant(self.cfg, self.spec, vdevices_by_ids(self.vdevices, ids),
                      ids)
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
