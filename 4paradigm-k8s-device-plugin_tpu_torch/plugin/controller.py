"""Legacy-preferred vdevice controller: ``vtpu``'s plugin/controller.py,
the port's own copy.

On kubelets without GetPreferredAllocation (<1.19), the kubelet's device
accounting can't know which vdevice IDs the plugin actually handed out
when Allocate substitutes devices — so the plugin must track ownership
itself (reference vdevice-controller.go:33-41).  Sources of truth:

1. the kubelet's own checkpoint file (``kubelet_internal_checkpoint``),
   whose per-pod ContainerAllocateResponses carry our
   ``4paradigm.com/vtpu-request`` / ``-using`` annotations (reference
   vdevice-controller.go:60-111 reads it via checkpointmanager; the file
   is JSON, read directly here);
2. a node-filtered pod list to drop mappings of pods that finished
   (reference's informer lister, vdevice-controller.go:162-223).

State: ``id_map[vdevice_id] = request_key or None`` under a lock
(reference vdevice-controller.go:244-286).
"""

from __future__ import annotations

import base64
import json
import os
import threading
from typing import Dict, List, Optional, Sequence

from ..k8s.client import CachedPodLister
from ..proto import pb
from ..utils import logging as log
from .allocator import preferred_allocation
from .config import Config
from .grant import ANNOTATION_REQUEST, ANNOTATION_USING

_TERMINAL_PHASES = ("Succeeded", "Failed")


class VDeviceController:
    def __init__(self, cfg: Config, pod_lister=None):
        self.cfg = cfg
        self.node_name = cfg.node_name or os.environ.get("NODE_NAME")
        self.checkpoint_path = os.path.join(cfg.device_plugin_path,
                                            "kubelet_internal_checkpoint")
        self.pod_lister = pod_lister
        self.mu = threading.Lock()
        # vdevice id -> request key ("" = free)
        self.id_map: Dict[str, str] = {}

    # ------------------------------------------------------------------
    # state transitions (reference vdevice-controller.go:244-286)
    # ------------------------------------------------------------------

    def initialize(self, vdevice_ids: Sequence[str]) -> None:
        with self.mu:
            for vid in vdevice_ids:
                self.id_map.setdefault(vid, "")

    def acquire(self, request_ids: Sequence[str],
                using_ids: Sequence[str]) -> None:
        key = ",".join(sorted(request_ids))
        with self.mu:
            for vid in using_ids:
                self.id_map[vid] = key

    def release_by_request(self, request_ids: Sequence[str]) -> None:
        key = ",".join(sorted(request_ids))
        with self.mu:
            for vid, owner in self.id_map.items():
                if owner == key:
                    self.id_map[vid] = ""

    def release(self, using_ids: Sequence[str]) -> None:
        with self.mu:
            for vid in using_ids:
                if vid in self.id_map:
                    self.id_map[vid] = ""

    def available(self) -> List[str]:
        with self.mu:
            return [vid for vid, owner in self.id_map.items() if not owner]

    # ------------------------------------------------------------------
    # checkpoint reconciliation (reference vdevice-controller.go:60-111)
    # ------------------------------------------------------------------

    def update_from_checkpoint(self) -> None:
        entries = self._read_checkpoint_entries()
        if entries is None:
            return
        live_uids = self._live_pod_uids()
        with self.mu:
            for vid in self.id_map:
                self.id_map[vid] = ""
        for entry in entries:
            resp_b64 = entry.get("AllocResp")
            if not resp_b64:
                continue
            try:
                resp = pb.ContainerAllocateResponse.FromString(
                    base64.b64decode(resp_b64))
            except Exception as e:  # noqa: BLE001 - foreign file format
                log.warn("bad checkpoint AllocResp: %s", e)
                continue
            request = resp.annotations.get(ANNOTATION_REQUEST, "")
            using = resp.annotations.get(ANNOTATION_USING, "")
            if not using:
                continue
            pod_uid = entry.get("PodUID", "")
            if live_uids is not None and pod_uid not in live_uids:
                continue  # pod gone -> stays free
            self.acquire(request.split(","), using.split(","))

    def _read_checkpoint_entries(self) -> Optional[List[Dict]]:
        try:
            with open(self.checkpoint_path) as f:
                data = json.load(f)
        except OSError:
            return None
        except ValueError as e:
            log.warn("unparseable kubelet checkpoint: %s", e)
            return None
        entries = (data.get("Data", {}) or {}).get("PodDeviceEntries", [])
        ours = [e for e in entries
                if e.get("ResourceName") == self.cfg.resource_name]
        return ours

    def _live_pod_uids(self) -> Optional[set]:
        """UIDs of pods on this node not in a terminal phase; None when no
        pod lister is available (then checkpoint entries are trusted)."""
        if self.pod_lister is None:
            return None
        try:
            # Absence from this list FREES checkpoint-held vdevices, so
            # staleness is destructive: a TTL-cached list predating a
            # just-Allocated pod would release its grants to the next
            # Allocate (double allocation).  Always list fresh here —
            # reconciles are per-Allocate in legacy mode, exactly the
            # pre-cache QPS.
            if isinstance(self.pod_lister, CachedPodLister):
                pods = self.pod_lister(self.node_name, fresh=True)
            else:
                pods = self.pod_lister(self.node_name)
        except Exception as e:  # noqa: BLE001 - API server hiccups
            log.warn("pod list failed; trusting checkpoint: %s", e)
            return None
        return {
            p.get("metadata", {}).get("uid", "")
            for p in pods
            if p.get("status", {}).get("phase") not in _TERMINAL_PHASES
        }

    # ------------------------------------------------------------------
    # Allocate-path re-pick (reference server.go:408-457)
    # ------------------------------------------------------------------

    def reallocate(self, plugin, request_ids: List[str]) -> List[str]:
        """Reconcile, free this request's previous grant, then choose real
        vdevices for it (the kubelet's IDs may be stale substitutes)."""
        self.initialize([v.id for v in plugin.vdevices])
        self.update_from_checkpoint()
        self.release_by_request(request_ids)
        avail_ids = set(self.available())
        available = [v for v in plugin.vdevices if v.id in avail_ids]
        chosen = preferred_allocation(available, [], len(request_ids),
                                      plugin.topology)
        if len(chosen) < len(request_ids):
            raise RuntimeError(
                f"legacy allocate: need {len(request_ids)} vdevices, "
                f"only {len(chosen)} available")
        using = [v.id for v in chosen]
        self.acquire(request_ids, using)
        log.info("legacy allocate: %s -> %s", request_ids, using)
        return using
