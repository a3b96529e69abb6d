"""The tenant's side of the broker: tensors and ``torch.export`` programs
over ``vtpu``'s wire.

The port of ``vtpu.runtime.client``'s core.  A tenant never opens the
card: it traces its function on ``meta`` tensors (so a 16 GB model is
never built in the tenant to trace it), ships the graph, and moves
tensors as raw bytes.  The ergonomic entry point is ``remote_jit``:

    rt = RuntimeClient.from_env()           # VTPU_RUNTIME_SOCKET
    f = rt.remote_jit(lambda a, b: a @ b)
    y = f(x, w)                             # runs on the broker's card

``compile`` exports with ``torch.export`` and sends the graph part of the
serialized program only (``SerializedArtifact.exported_program``, JSON):
the broker unpickles nothing (``runtime/server.py``).  So a program takes
every tensor as an argument: a function that closes over a tensor (or a
module's parameters) is refused here, with the names of what it closed
over.

Tensors: ``put`` takes a CPU tensor or a numpy array and ``get`` returns
a CPU tensor; a dtype crosses as its name (``utils.dtypes``), bf16 as
torch's bytes under ``"bfloat16"``.  Every quota refusal raises
``VtpuQuotaError`` with the broker's RESOURCE_EXHAUSTED message.

Not here yet: reconnect, resume and the degraded mode (ROADMAP Queue 1
item 6(b)): a lost connection raises ``VtpuConnectionLost`` and the
client is done; leases and the fastlane (6(c)).
"""

from __future__ import annotations

import itertools
import os
import socket
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..utils import envspec
from ..utils.dtypes import (dtype_name, tensor_bytes, tensor_from_bytes,
                            torch_dtype)
from . import protocol as P

Tensorish = Union[torch.Tensor, np.ndarray]


class VtpuQuotaError(MemoryError):
    pass


class RuntimeError_(RuntimeError):
    pass


class VtpuConnectionLost(RuntimeError_):
    """The connection to the broker died mid-request.  This client does
    not rebind (ROADMAP Queue 1 item 6(b)): the tenant's state is gone
    with its last connection, and in-flight replies are lost."""

    resumed = False


class VtpuOverload(RuntimeError_):
    """The broker shed this request under overload (typed ``OVERLOAD``):
    it was never enqueued, so a retry cannot run it twice."""

    def __init__(self, msg: str, retry_ms: Optional[int] = None):
        super().__init__(msg)
        self.retry_ms = retry_ms


def as_tensor(x: Tensorish) -> torch.Tensor:
    """A contiguous CPU tensor with ``x``'s bits (numpy arrays of the
    types numpy has)."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    if t.device.type != "cpu":
        raise ValueError(f"a tenant sends CPU tensors, got {t.device}")
    return t.detach().contiguous()


class RemoteArray:
    """Handle to a tenant-owned tensor living in the broker."""

    def __init__(self, client: "RuntimeClient", aid: str, shape, dtype):
        self.client = client
        self.id = aid
        self.shape = tuple(shape)
        self.dtype = torch_dtype(dtype) if isinstance(dtype, str) else dtype

    def fetch(self) -> torch.Tensor:
        return self.client.get(self.id)

    def delete(self) -> None:
        self.client.delete(self.id)

    def __repr__(self):
        return f"RemoteArray({self.id}, {self.shape}, {self.dtype})"


class RemoteExecutable:
    def __init__(self, client: "RuntimeClient", eid: str):
        self.client = client
        self.id = eid

    def __call__(self, *args: RemoteArray) -> List[RemoteArray]:
        return self.client.execute(self.id, args)


class _Program(torch.nn.Module):
    """A function as the module ``torch.export`` traces; it holds no
    parameter, so the graph's signature names user inputs only."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_graph(fn, example_args: Sequence[Tensorish]) -> bytes:
    """``fn`` traced by ``torch.export`` on meta tensors of the examples'
    shapes and dtypes, serialized: the graph's JSON alone.  Raises
    ValueError when ``fn`` closes over a tensor or a parameter."""
    from torch._export.serde.serialize import serialize

    meta = tuple(torch.empty(tuple(a.shape), dtype=as_dtype(a),
                             device="meta") for a in example_args)
    try:
        with torch.no_grad():
            ep = torch.export.export(_Program(fn), meta, strict=False)
    except RuntimeError as e:
        # A tensor on a real device met the meta arguments.
        if "device" not in str(e):
            raise
        raise ValueError(f"the program mixes its arguments with a tensor it "
                         f"closes over ({e}): pass every tensor as an "
                         "argument") from None
    lifted = [s.target for s in ep.graph_signature.input_specs
              if s.kind != torch.export.graph_signature.InputKind.USER_INPUT]
    if lifted:
        raise ValueError(f"the program closes over tensors {lifted}: pass "
                         "every tensor as an argument")
    return serialize(ep).exported_program


def as_dtype(a: Tensorish) -> torch.dtype:
    if isinstance(a, torch.Tensor):
        return a.dtype
    return torch_dtype(np.dtype(a.dtype).name)


class RuntimeClient:
    def __init__(self, socket_path: str, tenant: Optional[str] = None,
                 priority: Optional[int] = None,
                 device: Optional[int] = None,
                 hbm_limit: Optional[int] = None,
                 core_limit: Optional[int] = None,
                 oversubscribe: Optional[bool] = None,
                 timeout: Optional[float] = None):
        self._socket_path = socket_path
        self._ids = itertools.count()
        # Executes buffered by execute_send_ids ship as one EXEC_BATCH
        # of up to this many items; <= 1 sends each as an EXECUTE.
        self._batch_max = int(os.environ.get("VTPU_EXEC_BATCH", "64") or 0)
        self._pending_batch: List[Dict[str, Any]] = []
        # Logical replies read off the wire ahead of their consumer (an
        # EXEC_BATCH reply splits into its items), and how many are
        # still expected from the wire.
        self._ready: List[Dict[str, Any]] = []
        self._wire_out = 0
        spec = envspec.quota_from_env()
        self.tenant = tenant or os.environ.get(
            "VTPU_TENANT", f"{socket.gethostname()}-pid{os.getpid()}")
        self.priority = spec.task_priority if priority is None else priority
        hello = {"kind": P.HELLO, "tenant": self.tenant,
                 "priority": self.priority,
                 "oversubscribe": spec.oversubscribe
                 if oversubscribe is None else bool(oversubscribe),
                 "device": 0 if device is None else int(device),
                 "pid": os.getpid()}
        hbm = hbm_limit
        if hbm is None and spec.hbm_limit_bytes:
            hbm = spec.limit_for(0)
        core = core_limit
        if core is None and envspec.ENV_CORE_LIMIT in os.environ:
            core = spec.core_limit_pct
        if hbm is not None:
            hello["hbm_limit"] = int(hbm)
        if core is not None:
            hello["core_limit"] = int(core)
        if timeout is None:
            timeout = float(os.environ.get("VTPU_RPC_TIMEOUT_S", "120"))
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.settimeout(timeout if timeout > 0 else None)
        self.sock.connect(socket_path)
        resp = self._rpc(hello)
        self.tenant_index = resp["tenant_index"]
        self.chip = resp.get("chip", 0)
        self.epoch = resp.get("epoch")

    @classmethod
    def from_env(cls, **kw) -> "RuntimeClient":
        spec = envspec.quota_from_env()
        return cls(spec.runtime_socket or "/usr/local/vtpu/vtpu-runtime.sock",
                   **kw)

    # -- plumbing --

    def _lost(self, e: BaseException) -> VtpuConnectionLost:
        return VtpuConnectionLost(f"connection to the broker lost: "
                                  f"{type(e).__name__}: {e}")

    def _recv(self) -> Dict[str, Any]:
        try:
            return P.recv_msg(self.sock)
        except (ConnectionError, P.ProtocolError, OSError) as e:
            raise self._lost(e) from e

    def _send_frames(self, bufs) -> None:
        try:
            P.send_frames(self.sock, bufs)
        except (ConnectionError, OSError) as e:
            raise self._lost(e) from e

    def _explode(self, resp: Dict[str, Any]) -> List[Dict[str, Any]]:
        """One wire frame as its logical replies: an EXEC_BATCH reply's
        positional results, anything else itself."""
        if resp.get("ok") and isinstance(resp.get("results"), list):
            return list(resp["results"])
        return [resp]

    def _flush_batch(self) -> None:
        items, self._pending_batch = self._pending_batch, []
        if not items:
            return
        if len(items) == 1:
            msg: Dict[str, Any] = dict(items[0], kind=P.EXECUTE)
        else:
            msg = {"kind": P.EXEC_BATCH, "items": items}
        self._send_frames([P.frame_header(msg)])
        self._wire_out += len(items)

    def _sync_prelude(self) -> None:
        """Ship buffered executes and read every reply still on the wire,
        so the next frame read answers the synchronous request."""
        self._flush_batch()
        while self._wire_out > 0:
            out = self._explode(self._recv())
            self._wire_out -= len(out)
            self._ready.extend(out)

    @staticmethod
    def _raise_reply_error(resp: Dict[str, Any]) -> None:
        code = resp.get("code", "")
        if code == "RESOURCE_EXHAUSTED":
            raise VtpuQuotaError(resp.get("error", code))
        if code == "OVERLOAD":
            raise VtpuOverload(resp.get("error", code),
                               retry_ms=resp.get("retry_ms"))
        raise RuntimeError_(f"{code}: {resp.get('error', '')}")

    def _rpc(self, msg: Dict[str, Any], payloads=()) -> Dict[str, Any]:
        """One synchronous request, its payloads as raw frames in the
        same gather write."""
        self._sync_prelude()
        bufs = [P.frame_header(msg)]
        for p in payloads:
            bufs.extend(P.raw_frames(p))
        self._send_frames(bufs)
        resp = self._recv()
        if not resp.get("ok"):
            self._raise_reply_error(resp)
        return resp

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- data --

    @staticmethod
    def _put_raw_parts(t: torch.Tensor, aid: str):
        """(header, flat byte view) of a zero-copy PUT."""
        flat = tensor_bytes(t)
        hdr = {"kind": P.PUT, "id": aid, "shape": list(t.shape),
               "dtype": dtype_name(t.dtype), "nbytes": len(flat),
               "raw_parts": P.raw_part_count(len(flat))}
        return hdr, flat

    def put(self, x: Tensorish, aid: Optional[str] = None) -> RemoteArray:
        t = as_tensor(x)
        aid = aid or f"a{next(self._ids)}"
        hdr, flat = self._put_raw_parts(t, aid)
        self._rpc(hdr, [flat])
        return RemoteArray(self, aid, t.shape, t.dtype)

    def put_parts(self, x: Tensorish) -> int:
        """Reply frames a ``put_send`` costs: one on the raw framing."""
        return 1

    def put_send(self, x: Tensorish, aid: str) -> int:
        """Pipelined PUT: sent without reading its ack, which the caller
        consumes with ``recv_reply`` in send order; returns 1."""
        t = as_tensor(x)
        self._flush_batch()
        hdr, flat = self._put_raw_parts(t, aid)
        self._send_frames([P.frame_header(hdr)] + P.raw_frames(flat))
        self._wire_out += 1
        return 1

    def get(self, aid: str) -> torch.Tensor:
        """The tensor ``aid`` as a CPU tensor (raw framing: the payload is
        received into one buffer of its exact size)."""
        resp = self._rpc({"kind": P.GET, "id": aid, "raw": True})
        buf = bytearray(int(resp["nbytes"]))
        mv = memoryview(buf)
        got = 0
        try:
            for _ in range(int(resp["raw_parts"])):
                got += P.recv_raw_into(self.sock, mv[got:])
        except (ConnectionError, P.ProtocolError, OSError) as e:
            raise self._lost(e) from e
        return tensor_from_bytes(buf, resp["dtype"], resp["shape"])

    def delete(self, aid: str) -> None:
        self._rpc({"kind": P.DELETE, "id": aid})

    def delete_many(self, aids: Sequence[str]) -> None:
        """One round trip for any number of ids."""
        if aids:
            self._rpc({"kind": P.DELETE, "ids": list(aids)})

    # -- compute --

    def compile(self, fn, example_args: Sequence[Tensorish]
                ) -> RemoteExecutable:
        """Trace ``fn`` here (``export_graph``: on meta tensors, no data)
        and register the graph with the broker."""
        return self.compile_blob(export_graph(fn, example_args))

    def compile_blob(self, blob: bytes) -> RemoteExecutable:
        """Register an already-serialized graph."""
        eid = f"e{next(self._ids)}"
        self._rpc({"kind": P.COMPILE, "id": eid, "exported": bytes(blob)})
        return RemoteExecutable(self, eid)

    def execute(self, eid: str,
                args: Sequence[RemoteArray]) -> List[RemoteArray]:
        out_ids = [f"o{next(self._ids)}" for _ in range(8)]
        r = self._rpc({"kind": P.EXECUTE, "exe": eid,
                       "args": [a.id for a in args], "outs": out_ids})
        return [RemoteArray(self, m["id"], m["shape"], m["dtype"])
                for m in r["outs"]]

    def stats(self) -> Dict[str, Any]:
        return self._rpc({"kind": P.STATS})["tenants"]

    # -- pipelined execution --
    # Replies are FIFO per connection: a caller may keep executes in
    # flight as long as it pairs sends with receives.

    def execute_send_ids(self, eid: str, arg_ids: Sequence[str],
                         out_ids: Sequence[str], repeats: int = 1,
                         carry: Sequence[Sequence[int]] = ((0, 0),),
                         free: Sequence[str] = ()) -> None:
        """Queue one execute by ids: an argument may name an earlier
        in-flight step's output (ids resolve at dispatch).  ``repeats`` >
        1 runs a K-step chain in the broker, ``carry`` mapping each step's
        output indices into the next step's argument indices; ``free``
        ids drop at this item's dispatch.  Items are coalesced into one
        EXEC_BATCH frame, flushed when full and before any other send or
        any receive."""
        item: Dict[str, Any] = {"exe": eid, "args": list(arg_ids),
                                "outs": list(out_ids)}
        if repeats > 1:
            item["repeats"] = int(repeats)
            item["carry"] = [list(p) for p in carry]
        if free:
            item["free"] = list(free)
        self._pending_batch.append(item)
        if len(self._pending_batch) >= max(self._batch_max, 1):
            self._flush_batch()

    def recv_reply(self) -> Dict[str, Any]:
        """The next pipelined reply (FIFO); raises the typed error of a
        refused one."""
        if self._ready:
            resp = self._ready.pop(0)
        else:
            self._flush_batch()
            out = self._explode(self._recv())
            self._wire_out -= len(out)
            resp, self._ready = out[0], self._ready + out[1:]
        if not resp.get("ok"):
            self._raise_reply_error(resp)
        return resp

    def execute_recv(self) -> List[RemoteArray]:
        resp = self.recv_reply()
        return [RemoteArray(self, m["id"], m["shape"], m["dtype"])
                for m in resp["outs"]]

    # -- ergonomics --

    def remote_jit(self, fn):
        """A callable taking and returning CPU tensors (or numpy arrays)
        that runs ``fn`` on the broker's card under this tenant's quotas;
        compiled once per signature of argument shapes and dtypes."""
        cache: Dict[tuple, RemoteExecutable] = {}

        def call(*args: Tensorish):
            ts = [as_tensor(a) for a in args]
            sig = tuple((tuple(t.shape), t.dtype) for t in ts)
            exe = cache.get(sig)
            if exe is None:
                exe = cache[sig] = self.compile(fn, ts)
            handles = [self.put(t) for t in ts]
            outs = exe(*handles)
            res = [o.fetch() for o in outs]
            self.delete_many([h.id for h in handles + outs])
            return res[0] if len(res) == 1 else res

        return call
