"""Minimal in-cluster Kubernetes REST client (pods only): ``vtpu``'s
k8s/client.py, the port's own copy.

The reference vendors all of client-go for two calls: a node-filtered pod
LIST for monitor mode's pod match (reference server.go:369-379) and the
legacy controller's pod lister (reference vdevice-controller.go:162-223).
This is the stdlib equivalent: the service account's token and CA, GET
/api/v1/pods with a spec.nodeName fieldSelector, and a WATCH from the
list's resourceVersion for the informer.

- ``K8sClient``: LIST and WATCH over HTTPS.
- ``pod_lister(client)``: ``lister(node) -> [pod]``.
- ``PodInformer``: LIST once, then WATCH, relisting after any error.
- ``CachedPodLister``: a TTL cache over a lister, served from an informer
  when one is attached and synced; ``fresh=True`` always LISTs.
"""

from __future__ import annotations

import json
import os
import ssl
import threading
import time
import urllib.parse
import urllib.request
from typing import Any, Dict, List, Optional

from ..utils import logging as log

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class K8sClient:
    def __init__(self, host: Optional[str] = None,
                 port: Optional[str] = None,
                 token: Optional[str] = None,
                 ca_file: Optional[str] = None):
        self.host = host or os.environ.get("KUBERNETES_SERVICE_HOST")
        self.port = port or os.environ.get("KUBERNETES_SERVICE_PORT",
                                           "443")
        self.token = token
        if self.token is None and os.path.exists(f"{SA_DIR}/token"):
            with open(f"{SA_DIR}/token") as f:
                self.token = f.read().strip()
        self.ca_file = ca_file or (f"{SA_DIR}/ca.crt"
                                   if os.path.exists(f"{SA_DIR}/ca.crt")
                                   else None)

    @property
    def available(self) -> bool:
        return bool(self.host and self.token)

    def _request(self, path: str, params: Dict[str, str]):
        """(urllib Request, ssl context) with the bearer token — the
        ONE place auth/TLS is assembled for both GET and WATCH."""
        qs = urllib.parse.urlencode(params)
        url = f"https://{self.host}:{self.port}{path}?{qs}"
        req = urllib.request.Request(url, headers={
            "Authorization": f"Bearer {self.token}",
            "Accept": "application/json",
        })
        if self.ca_file:
            ctx = ssl.create_default_context(cafile=self.ca_file)
        else:
            ctx = ssl.create_default_context()
        return req, ctx

    def _get(self, path: str, params: Dict[str, str]) -> Dict[str, Any]:
        req, ctx = self._request(path, params)
        with urllib.request.urlopen(req, context=ctx, timeout=10) as resp:
            return json.load(resp)

    def list_pods(self, node_name: Optional[str] = None) -> List[Dict]:
        return self.list_pods_rv(node_name)[0]

    def list_pods_rv(self, node_name: Optional[str] = None):
        """(items, resourceVersion) — the watch-resume token the
        informer needs."""
        params: Dict[str, str] = {}
        if node_name:
            params["fieldSelector"] = f"spec.nodeName={node_name}"
        body = self._get("/api/v1/pods", params)
        return (body.get("items", []),
                body.get("metadata", {}).get("resourceVersion", ""))

    def watch_pods(self, resource_version: str,
                   node_name: Optional[str] = None,
                   timeout_s: int = 300):
        """Yield (event_type, pod) from a WATCH stream starting at
        `resource_version` (newline-delimited JSON, the K8s watch wire
        format).  Returns when the server closes the stream; raises
        urllib errors on transport failure — the informer loop handles
        both by relisting."""
        params: Dict[str, str] = {
            "watch": "1",
            "resourceVersion": resource_version,
            "allowWatchBookmarks": "true",
            "timeoutSeconds": str(timeout_s),
        }
        if node_name:
            params["fieldSelector"] = f"spec.nodeName={node_name}"
        req, ctx = self._request("/api/v1/pods", params)
        with urllib.request.urlopen(req, context=ctx,
                                    timeout=timeout_s + 30) as resp:
            buf = b""
            while True:
                chunk = resp.read1(1 << 16)
                if not chunk:
                    return
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not line.strip():
                        continue
                    ev = json.loads(line)
                    yield ev.get("type", ""), ev.get("object", {})


def pod_lister(client: Optional[K8sClient] = None):
    """callable(node_name) -> [pod dict], for plugin server monitor mode."""
    c = client or K8sClient()

    def lister(node_name: Optional[str]) -> List[Dict]:
        if not c.available:
            return []
        return c.list_pods(node_name)

    return lister


class PodInformer:
    """Node-scoped pod informer: LIST once, then WATCH with
    resourceVersion resume — the reference keeps a client-go informer
    for exactly this (reference vdevice-controller.go:162-223); the
    poll-per-Allocate path costs an API-server LIST per admission.
    Consumers read the in-memory cache;
    every watch error (disconnect, 410 Gone, bad frame) degrades to a
    fresh relist after a backoff, so the cache is eventually consistent
    and the informer never takes the daemon down.

    The `client` only needs `list_pods_rv(node)` and
    `watch_pods(rv, node)` — tests drive it with a fake."""

    def __init__(self, client, node_name: Optional[str],
                 backoff_s: float = 2.0):
        self.client = client
        self.node_name = node_name
        self.backoff_s = backoff_s
        self.relists = 0   # observability + tests
        self.events = 0
        self._mu = threading.Lock()
        self._pods: Dict[str, Dict] = {}   # uid -> pod object
        self._synced = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle --
    def start(self) -> "PodInformer":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="vtpu-pod-informer")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def wait_synced(self, timeout: float = 10.0) -> bool:
        return self._synced.wait(timeout)

    # -- consumer surface --
    def pods(self) -> List[Dict]:
        with self._mu:
            return list(self._pods.values())

    @property
    def synced(self) -> bool:
        return self._synced.is_set()

    @staticmethod
    def _uid(pod: Dict) -> str:
        return pod.get("metadata", {}).get("uid", "")

    # -- loop --
    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                items, rv = self.client.list_pods_rv(self.node_name)
            except Exception as e:  # noqa: BLE001 - API hiccup
                log.warn("informer list failed: %s", e)
                self._stop.wait(self.backoff_s)
                continue
            with self._mu:
                self._pods = {self._uid(p): p for p in items
                              if self._uid(p)}
            self.relists += 1
            self._synced.set()
            watch_t0 = time.monotonic()
            try:
                for ev_type, obj in self.client.watch_pods(
                        rv, self.node_name):
                    if self._stop.is_set():
                        return
                    self.events += 1
                    if ev_type in ("ADDED", "MODIFIED"):
                        uid = self._uid(obj)
                        if uid:
                            with self._mu:
                                self._pods[uid] = obj
                    elif ev_type == "DELETED":
                        with self._mu:
                            self._pods.pop(self._uid(obj), None)
                    elif ev_type == "BOOKMARK":
                        pass  # rv progress only; next relist resyncs
                    elif ev_type == "ERROR":
                        # Expired resourceVersion (410 Gone): relist.
                        break
            except Exception as e:  # noqa: BLE001 - transport failure
                log.warn("informer watch failed (relisting): %s", e)
                self._stop.wait(self.backoff_s)
                continue
            # Stream ended (normal watch timeout, ERROR event, or a
            # proxy that cannot hold streams open).  A long-lived watch
            # relists immediately — that IS the refresh cycle; a watch
            # that died young gets the backoff, or a watch-hostile
            # intermediary would turn this loop into an unthrottled
            # LIST storm (the load the informer exists to remove).
            if time.monotonic() - watch_t0 < max(self.backoff_s, 1.0):
                self._stop.wait(self.backoff_s)


class CachedPodLister:
    """TTL cache around a pod lister, shared across Allocates: an
    admission burst on a big node must not turn into one API-server LIST
    per container.  ``fresh=True`` bypasses the
    cache — the matcher uses it once when the cached list has no
    candidate (the pod may have been created inside the TTL window), so
    correctness is a refresh away while steady-state QPS stays ~1/ttl.

    With an attached (and synced) ``PodInformer``, plain reads come
    from the watch-maintained cache — steady-state API-server QPS
    drops to the watch stream alone.  ``fresh=True`` STILL performs a
    direct LIST: the legacy controller frees vdevices on absence and
    the monitor matcher retries for a pod the watch may not have
    delivered yet, and both must see list-linearized state."""

    def __init__(self, lister, ttl: float = 3.0, informer=None):
        self.lister = lister
        self.ttl = ttl
        self.informer = informer
        self.calls = 0  # upstream LIST count (observability + tests)
        self._mu = threading.Lock()
        self._cond = threading.Condition(self._mu)
        # node -> fetch-start time of an upstream LIST in flight:
        # concurrent misses (N Allocates racing a cold/expired entry)
        # must coalesce into ONE upstream call, not recreate the burst
        # the cache exists to prevent.
        self._inflight: Dict[Optional[str], float] = {}
        # Cache entries are stamped with the fetch START time: a fresh=
        # True caller can then piggyback on a result only when the
        # fetch began after its own request (a list started earlier may
        # predate the pod it is looking for).
        self._cache: Dict[Optional[str], tuple] = {}

    def __call__(self, node_name: Optional[str],
                 fresh: bool = False) -> List[Dict]:
        if not fresh and self.informer is not None \
                and self.informer.synced \
                and getattr(self.informer, "node_name", None) == node_name:
            # Informer fast path only for ITS node: a caller asking for
            # a different node must fall through to the LIST path, not
            # silently receive the informer's node's pods.
            return self.informer.pods()
        t_req = time.monotonic()
        with self._mu:
            while True:
                ent = self._cache.get(node_name)
                if ent is not None and (
                        fresh and ent[0] >= t_req
                        or not fresh
                        and time.monotonic() - ent[0] < self.ttl):
                    return ent[1]
                if node_name not in self._inflight:
                    self._inflight[node_name] = time.monotonic()
                    break
                # Single-flight: wait for the running fetch, then
                # re-evaluate (it satisfies plain callers always, fresh
                # callers only when it started after their request).
                self._cond.wait(timeout=1.0)
        start = self._inflight[node_name]
        try:
            pods = self.lister(node_name)
        except BaseException:
            with self._mu:
                self._inflight.pop(node_name, None)
                self._cond.notify_all()
            raise
        with self._mu:
            self._inflight.pop(node_name, None)
            self.calls += 1
            self._cache[node_name] = (start, pods)
            self._cond.notify_all()
        return pods
