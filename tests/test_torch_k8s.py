"""The port's pod lister (vtpu_torch.k8s.client) and legacy controller
(vtpu_torch.plugin.controller) against vtpu's.

The informer cases of vtpu's tests/test_pod_informer.py run over a real
HTTPS server on localhost (a self-signed certificate made by openssl, the
bearer token checked): vtpu's informer and the port's watch the same
server at once, and after every event both caches must hold the same
pods.  The checkpoint cases of vtpu's tests/test_controller.py feed one
kubelet checkpoint, one pod list and one request to both controllers,
whose vdevice ownership must then agree exactly (the port's vdevice IDs
are vtpu's with the card's name in place of the chip's)."""

import base64
import http.server
import json
import os
import queue
import ssl
import subprocess
import threading
import time
import types
import urllib.parse

import pytest

from test_torch_allocator import as_port_id, twin_inventory
from vtpu.k8s import client as jclient
from vtpu.plugin import controller as jctl
from vtpu.plugin.config import Config as JConfig
from vtpu.proto import pb as jpb
from vtpu_torch.k8s import client as tclient
from vtpu_torch.plugin import controller as tctl
from vtpu_torch.plugin.config import Config as TConfig
from vtpu_torch.proto import pb as tpb

TOKEN = "test-token"
NODE = "node1"


def _pod(uid, name, phase="Running"):
    return {"metadata": {"uid": uid, "name": name},
            "status": {"phase": phase}}


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never met"
        time.sleep(0.02)


# -- a pods API over HTTPS ----------------------------------------------------

class PodsApi(http.server.ThreadingHTTPServer):
    """GET /api/v1/pods (LIST) and ?watch=1 (newline-delimited events,
    until the stream is closed), for the node's fieldSelector and the
    bearer token only.  ``push`` sends one event to every open watch;
    None closes them, and a bytes value is written as it is (a garbled
    frame) before they close."""

    daemon_threads = True

    def __init__(self, cert, key):
        super().__init__(("127.0.0.1", 0), _Handler)
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(cert, key)
        self.socket = ctx.wrap_socket(self.socket, server_side=True)
        self.items = []
        self.rv = "100"
        self.lists = 0
        self.watches = []
        self.mu = threading.Lock()

    def push(self, ev):
        with self.mu:
            for q in self.watches:
                q.put(ev)


class _Handler(http.server.BaseHTTPRequestHandler):
    def log_message(self, *args):
        pass

    def do_GET(self):
        url = urllib.parse.urlparse(self.path)
        qs = urllib.parse.parse_qs(url.query)
        if (self.headers.get("Authorization") != f"Bearer {TOKEN}"
                or url.path != "/api/v1/pods"
                or qs.get("fieldSelector") != [f"spec.nodeName={NODE}"]):
            self.send_error(401)
            return
        api = self.server
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.end_headers()
        if "watch" not in qs:
            with api.mu:
                api.lists += 1
                body = {"items": list(api.items),
                        "metadata": {"resourceVersion": api.rv}}
            self.wfile.write(json.dumps(body).encode())
            return
        q = queue.Queue()
        with api.mu:
            api.watches.append(q)
        try:
            while True:
                ev = q.get()
                if ev is None:
                    return
                if isinstance(ev, bytes):   # a garbled frame ends the stream
                    self.wfile.write(ev)
                    return
                self.wfile.write(json.dumps({"type": ev[0], "object": ev[1]})
                                 .encode() + b"\n")
                self.wfile.flush()
        finally:
            with api.mu:
                api.watches.remove(q)


@pytest.fixture(scope="module")
def tls(tmp_path_factory):
    d = tmp_path_factory.mktemp("tls")
    cert, key = str(d / "cert.pem"), str(d / "key.pem")
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048",
                    "-nodes", "-keyout", key, "-out", cert, "-days", "1",
                    "-subj", "/CN=127.0.0.1",
                    "-addext", "subjectAltName=IP:127.0.0.1"],
                   check=True, capture_output=True, timeout=60)
    return cert, key


@pytest.fixture()
def api(tls):
    srv = PodsApi(*tls)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.push(None)
    srv.shutdown()
    srv.server_close()


def informers(api, tls):
    """vtpu's informer and the port's on the same server, both synced."""
    port = str(api.server_address[1])
    out = []
    for mod in (jclient, tclient):
        c = mod.K8sClient("127.0.0.1", port, TOKEN, tls[0])
        assert c.available
        out.append(mod.PodInformer(c, NODE, backoff_s=0.05).start())
    for inf in out:
        assert inf.wait_synced(10.0)
    _wait(lambda: len(api.watches) == 2)
    return out


def uids(inf):
    return sorted(p["metadata"]["uid"] for p in inf.pods())


def both_see(infs, want):
    _wait(lambda: all(uids(i) == sorted(want) for i in infs))


def test_client_lists_over_tls(api, tls):
    """One LIST through each client gives the same pods; a wrong token or
    no CA is refused."""
    api.items = [_pod("u1", "a"), _pod("u2", "b", "Pending")]
    port = str(api.server_address[1])
    got = [mod.K8sClient("127.0.0.1", port, TOKEN, tls[0]).list_pods_rv(NODE)
           for mod in (jclient, tclient)]
    assert got[0] == got[1] == (api.items, "100")
    lister = tclient.pod_lister(tclient.K8sClient("127.0.0.1", port, TOKEN,
                                                  tls[0]))
    assert lister(NODE) == api.items
    with pytest.raises(Exception, match="401"):
        tclient.K8sClient("127.0.0.1", port, "wrong", tls[0]).list_pods(NODE)
    with pytest.raises(Exception, match="CERTIFICATE"):
        tclient.K8sClient("127.0.0.1", port, TOKEN).list_pods(NODE)


def test_informer_sync_and_events(api, tls):
    api.items = [_pod("u1", "a")]
    infs = informers(api, tls)
    try:
        both_see(infs, ["u1"])
        api.push(("ADDED", _pod("u2", "b", "Pending")))
        both_see(infs, ["u1", "u2"])
        api.push(("MODIFIED", _pod("u2", "b", "Running")))
        _wait(lambda: all(
            {p["metadata"]["uid"]: p["status"]["phase"]
             for p in i.pods()} == {"u1": "Running", "u2": "Running"}
            for i in infs))
        api.push(("DELETED", _pod("u1", "a")))
        both_see(infs, ["u2"])
        assert [i.relists for i in infs] == [1, 1], \
            "no relist during a healthy watch"
        assert api.lists == 2
    finally:
        for i in infs:
            i.stop()


def test_informer_relists_on_stream_close_and_error(api, tls):
    api.items = [_pod("u1", "a")]
    infs = informers(api, tls)
    try:
        # The watch's normal end: a relist.
        api.items.append(_pod("u9", "late"))
        api.push(None)
        _wait(lambda: all(i.relists >= 2 for i in infs))
        both_see(infs, ["u1", "u9"])
        _wait(lambda: len(api.watches) == 2)
        # A garbled frame (a transport fault): a relist after the backoff.
        api.items.append(_pod("u10", "later"))
        api.push(b"{not json\n")
        _wait(lambda: all(i.relists >= 3 for i in infs))
        both_see(infs, ["u1", "u10", "u9"])
        _wait(lambda: len(api.watches) == 2)
        # An ERROR event (410 Gone): a relist too.
        api.items.append(_pod("u11", "latest"))
        api.push(("ERROR", {"code": 410}))
        _wait(lambda: all(i.relists >= 4 for i in infs))
        both_see(infs, ["u1", "u10", "u11", "u9"])
    finally:
        for i in infs:
            i.stop()


def test_cached_lister_serves_from_informer(api, tls):
    """Plain reads come from the informer (no LIST); fresh=True LISTs;
    another node's reads do not come from this node's informer."""
    api.items = [_pod("u1", "a")]
    infs = informers(api, tls)
    try:
        seen = []
        for mod, inf in zip((jclient, tclient), infs):
            direct = []

            def lister(node, direct=direct):
                direct.append(node)
                return list(api.items)

            cached = mod.CachedPodLister(lister, ttl=60.0, informer=inf)
            reads = [len(cached(NODE)) for _ in range(10)]
            assert direct == []
            api.items.append(_pod("u2", "b"))
            reads.append(len(cached(NODE, fresh=True)))
            reads.append(len(cached("node2")))
            api.items.pop()
            seen.append((reads, direct))
        assert seen[0] == seen[1] == ([1] * 10 + [2, 2], [NODE, "node2"])
    finally:
        for i in infs:
            i.stop()


# -- the legacy controller's checkpoint ---------------------------------------

def make_checkpoint(path, entries):
    with open(path, "w") as f:
        json.dump({"Data": {"PodDeviceEntries": entries,
                            "RegisteredDevices": {}}, "Checksum": 0}, f)


def alloc_resp_b64(pb, request_ids, using_ids):
    car = pb.ContainerAllocateResponse()
    car.annotations["4paradigm.com/vtpu-request"] = ",".join(request_ids)
    car.annotations["4paradigm.com/vtpu-using"] = ",".join(using_ids)
    return base64.b64encode(car.SerializeToString()).decode()


@pytest.fixture()
def twins(tmp_path):
    """Both controllers over twin inventories (vtpu's v5e chips on their
    torus, cards whose links are that torus's hops), each with its own
    kubelet dir, and a writer of one checkpoint to both."""
    topo, links, jv, tv = twin_inventory(8)
    made = []
    for side, Cfg, mod, vdevs, topology in (
            ("vtpu", JConfig, jctl, jv, topo),
            ("port", TConfig, tctl, tv, links)):
        d = tmp_path / side
        d.mkdir()
        cfg = Cfg(device_plugin_path=f"{d}/", enable_legacy_preferred=True,
                  node_name=NODE)
        plugin = types.SimpleNamespace(vdevices=vdevs, topology=topology)
        made.append((cfg, mod, plugin))

    def checkpoint(entries):
        """``entries`` name vtpu's IDs; the port's file names its own."""
        for (cfg, _, _), pb, ids in zip(made, (jpb, tpb), (str, as_port_id)):
            rows = [{"PodUID": e["PodUID"],
                     "ResourceName": e["ResourceName"],
                     "DeviceIDs": [ids(i) for i in e["request"]],
                     "AllocResp": alloc_resp_b64(
                         pb, [ids(i) for i in e["request"]],
                         [ids(i) for i in e["using"]])} for e in entries]
            make_checkpoint(os.path.join(cfg.device_plugin_path,
                                         "kubelet_internal_checkpoint"), rows)

    return made, checkpoint, [v.id for v in jv]


def controllers(made, pod_lister=None):
    return [mod.VDeviceController(cfg, pod_lister=pod_lister)
            for cfg, mod, _ in made]


def available(ctls):
    """Each controller's free vdevices, in vtpu's IDs."""
    j, t = (sorted(c.available()) for c in ctls)
    return j, sorted(v.replace("GPU-", "TPU-") for v in t)


def test_checkpoint_reconciliation(twins):
    made, checkpoint, vids = twins
    ctls = controllers(made)
    for c, (_, _, p) in zip(ctls, made):
        c.initialize([v.id for v in p.vdevices])
    checkpoint([{"PodUID": "pod-1", "ResourceName": "4paradigm.com/vtpu",
                 "request": [vids[0]], "using": [vids[1]]}])
    for c in ctls:
        c.update_from_checkpoint()
    j, t = available(ctls)
    assert j == t and vids[1] not in j and vids[0] in j


def test_dead_pod_releases(twins):
    made, checkpoint, vids = twins
    pods = [{"metadata": {"uid": "pod-1"}, "status": {"phase": "Succeeded"}},
            {"metadata": {"uid": "pod-2"}, "status": {"phase": "Running"}}]
    ctls = controllers(made, pod_lister=lambda node: pods)
    for c, (_, _, p) in zip(ctls, made):
        c.initialize([v.id for v in p.vdevices])
    checkpoint([{"PodUID": uid, "ResourceName": "4paradigm.com/vtpu",
                 "request": [vids[0]], "using": [vids[k]]}
                for uid, k in (("pod-1", 1), ("pod-2", 2))])
    for c in ctls:
        c.update_from_checkpoint()
    j, t = available(ctls)
    assert j == t and vids[1] in j and vids[2] not in j


def test_foreign_resource_ignored(twins):
    made, checkpoint, vids = twins
    ctls = controllers(made)
    for c, (_, _, p) in zip(ctls, made):
        c.initialize([v.id for v in p.vdevices])
    checkpoint([{"PodUID": "x", "ResourceName": "nvidia.com/gpu",
                 "request": [vids[3]], "using": [vids[3]]}])
    for c in ctls:
        c.update_from_checkpoint()
    j, t = available(ctls)
    assert j == t and len(j) == len(vids)


def test_reallocate_repicks_stale_ids(twins):
    """A request whose IDs the checkpoint shows in use by a live pod is
    given other vdevices, the same ones by both controllers; a second
    Allocate of the same request frees the first grant."""
    made, checkpoint, vids = twins
    pods = [{"metadata": {"uid": "pod-1"}, "status": {"phase": "Running"}}]
    ctls = controllers(made, pod_lister=lambda node: pods)
    checkpoint([{"PodUID": "pod-1", "ResourceName": "4paradigm.com/vtpu",
                 "request": [vids[0], vids[4]], "using": [vids[0], vids[4]]}])
    request = [vids[0], vids[8]]
    got = []
    for c, (_, _, p), ids in zip(ctls, made, (str, as_port_id)):
        got.append([c.reallocate(p, [ids(i) for i in request])
                    for _ in range(2)])
    assert [[as_port_id(i) for i in g] for g in got[0]] == got[1]
    first, again = got[1]
    assert not {as_port_id(vids[0]), as_port_id(vids[4])} & set(first)
    assert len({i.rsplit("-vtpu-", 1)[0] for i in first}) == 2
    assert again == first, "a retried request gets its own grant back"
