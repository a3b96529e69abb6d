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

A lost connection is ``vtpu``'s (``_on_disconnect``): the client dials
the socket again (the daemon restarts a broker) with full-jitter
backoff, offering its epoch in HELLO (``resume_epoch``), and classifies
what it finds:

- **resumed**: a journaled successor recovered this tenant, state
  intact.  A request in ``protocol.IDEMPOTENT_VERBS`` is retried and
  the caller never sees the restart; a pipelined execute in flight
  surfaces as ``VtpuConnectionLost`` with ``resumed`` true (it never
  runs twice), and the caller sends it again;
- **fresh epoch, or a fresh slot**: the tenant's state is gone:
  ``VtpuStateLost`` (put and compile again on this client);
- **same epoch, same tenant**: only the requests in flight are lost:
  ``VtpuConnectionLost``.

With ``VTPU_BROKER_GRACE_S`` above 0, a broker gone past the grace puts
the client in degraded mode (``runtime/degraded.py``): operations fail
fast with ``VtpuBrokerUnavailable``, the last-granted quotas still bite
(a PUT past the cap raises ``VtpuQuotaError``), compiles queue, and the
next operation that finds the broker back reattaches.  With
``VTPU_TRACE=1`` every request carries a trace stamp; off, the wire
carries no extra field.

The fastlane (``runtime/fastlane.py``): with ``VTPU_FASTLANE=1`` (or
``fastlane=True``) HELLO asks for a lane, and the broker answers with a
ring and two shared-memory arenas, whose fds follow the reply.  Then an
unchained execute rides the ring (no socket frame; its outputs' metadata
is its route's), a PUT and a GET of a tensor that fits move their bytes
through the arenas, and ``execute_send_feed`` sends a step's host batch
as an offset into the tx arena.  A chained execute, one that frees ids,
and every execute while the ring's gate is parked or closed go over the
socket; replies keep the order of the sends whichever path carried them,
and a ring execute the gate cancelled before it ran is sent again over
the socket, unseen by the caller.  A reconnect drops the lane with the
old connection (a resumed tenant gets a fresh one).  The client burns the
lane's rate leases from the shared bucket itself; an execute reply's
``lease`` is mirrored (``lease_remaining_us``, ``burn_lease``) to pace a
pipelining caller.
"""

from __future__ import annotations

import collections
import itertools
import os
import random
import select
import socket
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils import envspec
from ..utils.dtypes import (dtype_name, tensor_bytes, tensor_from_bytes,
                            torch_dtype)
from . import fastlane as fastlane_mod
from . import faults
from . import protocol as P
from . import trace as tracing

Tensorish = Union[torch.Tensor, np.ndarray]


def _env(name: str, default: float) -> float:
    """A float knob; junk reads as the default."""
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def full_jitter_delay(rng: random.Random, base_s: float, cap_s: float,
                      attempt: int) -> float:
    """Bounded exponential backoff with full jitter: uniform over
    [0, min(cap, base * 2^attempt)], which desynchronises the tenants
    that reconnect after one broker restart."""
    cap = min(cap_s, base_s * (2 ** min(max(attempt, 0), 16)))
    return rng.uniform(0.0, cap)


class VtpuQuotaError(MemoryError):
    pass


class RuntimeError_(RuntimeError):
    pass


class VtpuConnectionLost(RuntimeError_):
    """The connection died and was rebound with the tenant's state
    intact: only the requests in flight (and their replies) are lost.

    ``resumed`` is True when the state survived a broker RESTART through
    the journal (HELLO resume) rather than the broker staying alive:
    quotas, arrays, programs and cost EMAs are intact on the new
    instance, idempotent requests are retried transparently, and
    pipelined executes in flight at the crash died unreplied."""

    resumed = False


class VtpuBrokerUnavailable(RuntimeError_):
    """The broker has been unreachable past ``VTPU_BROKER_GRACE_S`` and
    the client is in degraded mode: operations fail fast with this error
    instead of blocking, the last-granted quotas keep biting locally,
    and compiles queue for replay.  The next operation that finds the
    broker back reattaches."""


class VtpuStateLost(RuntimeError_):
    """The broker restarted under this client without its state (a fresh
    HELLO epoch), or tore the tenant down before the rebind: every
    RemoteArray and RemoteExecutable handle is gone.  The client has
    already rebound; put and compile again on the SAME client, and start
    the send/receive pairing afresh."""

    def __init__(self, msg: str, epoch_old: Optional[str] = None,
                 epoch_new: Optional[str] = None):
        super().__init__(msg)
        self.epoch_old = epoch_old
        self.epoch_new = epoch_new


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
                 timeout: Optional[float] = None,
                 reconnect_timeout: Optional[float] = None,
                 trace: Optional[bool] = None,
                 fastlane: Optional[bool] = None):
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
        # The fastlane: the lane (None on the socket path); the routes,
        # (exe, args, outs) -> {"id", "cost", "metas", "key"}, or "prime"
        # while the program has not run once over the socket; the last
        # route (a steady loop compares lists, not keys); a countdown to
        # the next look at the gate (the drainer is the gate; the client
        # only needs to notice within 64 steps).
        self._fl_want = (fastlane_mod.client_wants() if fastlane is None
                         else bool(fastlane))
        self._lane: Optional[fastlane_mod.ClientLane] = None
        self._routes: Dict[tuple, Any] = {}
        self._fl_last: Optional[tuple] = None
        self._fl_gate_in = 0
        # Ring executes the gate cancelled and this client sent again.
        self.fl_resubmits = 0
        # Feed regions: owned by ring seqs until their completion is read,
        # and by socket replies until the pipeline drains; the routes whose
        # fed id a socket feed has bound (only then may the ring replace
        # its bytes).
        self._fl_feed_seqs: set = set()
        self._fl_feed_wire = 0
        self._fed_routes: set = set()
        # While a lane exists, the order of the pipelined replies: ("w",)
        # one from the socket, ("r", seq, route[, result]) one from the
        # ring; with counts of each, and socket replies read ahead.
        self._pending: "collections.deque[tuple]" = collections.deque()
        self._wire_buf: "collections.deque[dict]" = collections.deque()
        self._tok_wire = 0
        self._tok_ring = 0
        # The rate lease an execute reply carries: µs, expiry, revokes.
        self.lease_us = 0.0
        self.lease_exp = 0.0
        self.lease_revocations = 0
        # With tracing on every request carries a stamp; off, none.
        self._trace_on = tracing.trace_enabled() if trace is None \
            else bool(trace)
        self.last_trace_id: Optional[str] = None
        self._closed = False
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
        try:
            # The broker judges the pid's liveness at recovery only in
            # its own pid namespace.
            hello["pidns"] = os.stat("/proc/self/ns/pid").st_ino
        except OSError:
            pass
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
        # The SLO objective the grant declares, if any: the broker's plane
        # judges attainment against it instead of the share's default.
        for field, raw in (
                ("slo_target_us", os.environ.get("VTPU_SLO_TARGET_US")),
                ("slo_floor_steps", os.environ.get("VTPU_SLO_FLOOR_STEPS"))):
            if raw:
                try:
                    hello[field] = float(raw)
                except ValueError:
                    pass
        if self._fl_want:
            hello["fastlane"] = True
        self._hello = hello
        if timeout is None:
            timeout = _env("VTPU_RPC_TIMEOUT_S", 120.0)
        self._rpc_timeout = timeout
        self._connect_timeout = _env("VTPU_CONNECT_TIMEOUT_S", 5.0)
        # How long a disconnected client dials again before giving up
        # (or going degraded), and its full-jitter backoff, seeded per
        # tenant and pid.
        self._reconnect_timeout = (
            _env("VTPU_RECONNECT_TIMEOUT_S", 15.0)
            if reconnect_timeout is None else float(reconnect_timeout))
        self._backoff_base = max(
            _env("VTPU_RECONNECT_BACKOFF_MS", 50.0) / 1e3, 1e-3)
        self._backoff_cap = max(
            _env("VTPU_RECONNECT_BACKOFF_CAP_MS", 2000.0) / 1e3,
            self._backoff_base)
        self._backoff_rng = random.Random(f"{self.tenant}\x00{os.getpid()}")
        # The backoff stays flat this long after a loss, so a restart's
        # blackout is the restart and not jitter.
        self._fast_reconnect_s = _env("VTPU_RECONNECT_FAST_S", 2.0)
        # Degraded mode past this many seconds without a broker (0: a
        # hard error after the reconnect budget).
        self._grace_s = _env("VTPU_BROKER_GRACE_S", 0.0)
        self._degraded = False
        self._deg_since = 0.0
        self._deg_attempt = 0
        self._deg_next_dial = 0.0
        self._deg_enforcer: Optional[Any] = None
        self._deg_q: List[Tuple[str, bytes]] = []
        self._deg_qmax = int(_env("VTPU_DEGRADED_QUEUE", 32.0))
        # This tenant's PUT footprint (id -> bytes): what degraded mode
        # charges against the last-granted cap.
        self._used_mirror: Dict[str, int] = {}
        self._granted_hbm = int(hello.get("hbm_limit") or 0)
        self._granted_core = int(hello.get("core_limit") or 0)
        self.epoch: Optional[str] = None
        self.epoch = self._connect()[0]

    @classmethod
    def from_env(cls, **kw) -> "RuntimeClient":
        spec = envspec.quota_from_env()
        return cls(spec.runtime_socket or "/usr/local/vtpu/vtpu-runtime.sock",
                   **kw)

    # Kinds an interrupted synchronous request retries after a resumed
    # reconnect: the protocol's idempotent tenant verbs.
    _RESUME_RETRY_KINDS = frozenset(P.IDEMPOTENT_VERBS) \
        & frozenset(P.TENANT_VERBS)

    # -- connection --

    def _connect(self) -> Tuple[Optional[str], bool, bool]:
        """Dial and HELLO; (epoch, created, resumed): ``created`` when the
        broker bound a FRESH tenant slot, ``resumed`` when it adopted a
        tenant recovered from its journal.  For the first connection and
        every rebind."""
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        if self._connect_timeout > 0:
            self.sock.settimeout(self._connect_timeout)
        faults.fire("connect")
        self.sock.connect(self._socket_path)
        self.sock.settimeout(self._rpc_timeout
                             if self._rpc_timeout > 0 else None)
        msg = dict(self._hello)
        if self.epoch:
            msg["resume_epoch"] = self.epoch
        P.send_msg(self.sock, msg)
        resp = P.recv_msg(self.sock)
        if not resp.get("ok"):
            try:
                self.sock.close()
            except OSError:
                pass
            if resp.get("code") == "OVERLOAD":
                raise VtpuOverload(resp.get("error", "overloaded"),
                                   retry_ms=resp.get("retry_ms"))
            raise RuntimeError_(
                f"{resp.get('code', '')}: {resp.get('error', '')}")
        self.tenant_index = resp["tenant_index"]
        self.chip = resp.get("chip", 0)
        # What was buffered or read ahead belonged to the old socket; so
        # did the lane, its routes and its completions not yet read, and
        # the lease.
        self._pending_batch.clear()
        self._ready.clear()
        self._wire_out = 0
        self._drop_lane()
        fl = resp.get("fastlane")
        if fl and self._fl_want:
            fds = None
            if fl.get("fds") and hasattr(socket, "recv_fds"):
                try:
                    _m, fds, _f, _a = socket.recv_fds(self.sock, 1, 2)
                except OSError:
                    fds = None
            try:
                self._lane = fastlane_mod.ClientLane(fl, fds)
            except (OSError, KeyError, ValueError):
                # Never fatal: the socket serves everything.
                self._lane = None
                for fd in fds or ():
                    try:
                        os.close(fd)
                    except OSError:
                        pass
        return (resp.get("epoch"), bool(resp.get("created", False)),
                bool(resp.get("resumed", False)))

    def _drop_lane(self) -> None:
        """Forget the lane and everything scoped to it (a new connection,
        degraded mode, close)."""
        self.lease_us = 0.0
        self.lease_exp = 0.0
        self._pending.clear()
        self._wire_buf.clear()
        self._tok_wire = 0
        self._tok_ring = 0
        self._routes.clear()
        self._fl_last = None
        self._fl_gate_in = 0
        self._fl_feed_seqs.clear()
        self._fl_feed_wire = 0
        self._fed_routes.clear()
        if self._lane is not None:
            self._lane.close()
            self._lane = None

    def _on_disconnect(self) -> None:
        """The connection died mid-request: dial again and classify
        (module docstring).  Always raises."""
        if self._closed:
            raise RuntimeError_("client is closed")
        if self._degraded:
            raise VtpuBrokerUnavailable(
                f"broker still unreachable on {self._socket_path} "
                f"(degraded mode since "
                f"{time.monotonic() - self._deg_since:.0f}s)")
        old = self.epoch
        budget = self._reconnect_timeout
        if self._grace_s > 0:
            budget = max(budget, self._grace_s)
        t_lost = time.monotonic()
        deadline = t_lost + budget
        attempt = 0
        last: Optional[BaseException] = None
        while time.monotonic() < deadline:
            try:
                self.sock.close()
            except OSError:
                pass
            fast = time.monotonic() - t_lost < self._fast_reconnect_s
            try:
                new_epoch, created, resumed = self._connect()
            except (ConnectionError, FileNotFoundError, OSError,
                    P.ProtocolError, RuntimeError_) as e:
                # Nobody listening yet, or HELLO refused (DRAINING during
                # a handover, slots still held by a dying session).
                last = e
                attempt += 1
                self._backoff_sleep(attempt, deadline, fast=fast)
                continue
            if resumed:
                self.epoch = new_epoch
                err = VtpuConnectionLost(
                    f"CONNECTION_LOST: broker restarted and this tenant was "
                    f"recovered from its journal (epoch {old} -> "
                    f"{new_epoch}); state is intact, only in-flight "
                    f"requests were lost")
                err.resumed = True
                raise err
            if new_epoch != old or created:
                self.epoch = new_epoch
                self._used_mirror.clear()
                self._deg_q.clear()
                why = ("broker restarted" if new_epoch != old else
                       "broker alive but tenant state was torn down before "
                       "the rebind")
                raise VtpuStateLost(
                    f"{why} (epoch {old} -> {new_epoch}); arrays and "
                    f"executables are lost — re-put/re-compile on this "
                    f"client", epoch_old=old, epoch_new=new_epoch)
            raise VtpuConnectionLost(
                "CONNECTION_LOST: broker connection dropped and was rebound "
                "(same epoch, state intact); in-flight requests were lost")
        if self._grace_s > 0:
            self._enter_degraded()
            raise VtpuBrokerUnavailable(
                f"broker unreachable for {budget:.0f}s on "
                f"{self._socket_path}; degraded mode: local enforcement at "
                f"last-granted limits, reattach pending ({last})")
        raise RuntimeError_(f"broker unreachable for {budget:.0f}s on "
                            f"{self._socket_path}: {last}")

    def _backoff_sleep(self, attempt: int, deadline: float,
                       fast: bool = False) -> None:
        """One jittered pause, clipped to the deadline; ``fast`` holds
        the exponent down during the fast-reconnect window."""
        if fast:
            attempt = min(attempt, 2)
        delay = full_jitter_delay(self._backoff_rng, self._backoff_base,
                                  self._backoff_cap, attempt)
        time.sleep(max(min(delay, deadline - time.monotonic()), 0.0))

    # -- degraded mode (runtime/degraded.py) --

    def _enter_degraded(self) -> None:
        # The lane died with the broker; quotas keep biting through the
        # degraded enforcer.
        self._drop_lane()
        self._degraded = True
        self._deg_since = time.monotonic()
        self._deg_attempt = 0
        self._deg_next_dial = 0.0
        if self._deg_enforcer is None:
            from . import degraded
            self._deg_enforcer = degraded.LocalEnforcer.from_env(
                hbm_limit=self._granted_hbm, core_pct=self._granted_core,
                used_bytes=sum(self._used_mirror.values()))

    def _try_reattach(self) -> bool:
        """One paced dial; True when the client is back with its state
        (a journal resume, or the broker never died).  A fresh epoch
        raises VtpuStateLost."""
        now = time.monotonic()
        if now < self._deg_next_dial:
            return False
        self._deg_attempt += 1
        self._deg_next_dial = now + full_jitter_delay(
            self._backoff_rng, self._backoff_base, self._backoff_cap,
            self._deg_attempt)
        old = self.epoch
        try:
            new_epoch, created, resumed = self._connect()
        except (ConnectionError, FileNotFoundError, OSError,
                P.ProtocolError, RuntimeError_):
            return False
        self._degraded = False
        if self._deg_enforcer is not None:
            self._deg_enforcer.close()
            self._deg_enforcer = None
        self.epoch = new_epoch
        if resumed or (new_epoch == old and not created):
            self._replay_degraded_queue()
            return True
        self._deg_q.clear()
        self._used_mirror.clear()
        raise VtpuStateLost(
            f"broker restarted while degraded (epoch {old} -> {new_epoch}); "
            f"arrays and executables are lost — re-put/re-compile on this "
            f"client", epoch_old=old, epoch_new=new_epoch)

    def _replay_degraded_queue(self) -> None:
        """Register the compiles queued while degraded under their
        reserved ids."""
        q, self._deg_q = self._deg_q, []
        for eid, blob in q:
            self._rpc({"kind": P.COMPILE, "id": eid, "exported": blob})

    def _degraded_gate(self, nbytes: int = 0, est_us: float = 0.0) -> None:
        """Every operation in degraded mode comes here: a reattach is
        tried; while the broker stays gone the last-granted quotas still
        bite, and everything else fails fast."""
        if not self._degraded:
            return
        if self._try_reattach():
            return
        enf = self._deg_enforcer
        if enf is not None and nbytes and not enf.admit_bytes(nbytes):
            raise VtpuQuotaError(
                f"RESOURCE_EXHAUSTED: degraded mode: {nbytes} bytes would "
                f"exceed the last-granted HBM quota "
                f"({self._granted_hbm or 'contract'} limit) — enforcement "
                f"holds while the broker is down")
        if enf is not None and est_us and not enf.admit_us(est_us):
            raise VtpuQuotaError(
                "RESOURCE_EXHAUSTED: degraded mode: device-time quota "
                "exhausted at the last-granted rate — enforcement holds "
                "while the broker is down")
        raise VtpuBrokerUnavailable(
            f"broker unreachable on {self._socket_path} (degraded since "
            f"{time.monotonic() - self._deg_since:.0f}s); operation failed "
            f"cleanly, will reattach when the broker returns")

    # -- plumbing --

    def _maybe_stamp(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """The trace stamp when tracing is on; the message unchanged
        otherwise."""
        if self._trace_on:
            self.last_trace_id = tracing.new_trace_id()
            msg["trace"] = {"id": self.last_trace_id, "ts": time.time()}
        return msg

    def _recv(self) -> Dict[str, Any]:
        faults.fire("recv")
        return P.recv_msg(self.sock)

    def _recv_or_rebind(self) -> Dict[str, Any]:
        try:
            return self._recv()
        except (ConnectionError, P.ProtocolError, OSError):
            self._on_disconnect()
            raise AssertionError("unreachable")  # it always raises

    def _send_or_rebind(self, bufs) -> None:
        try:
            P.send_frames(self.sock, bufs)
        except (ConnectionError, P.ProtocolError, OSError):
            self._on_disconnect()

    def _explode(self, resp: Dict[str, Any]) -> List[Dict[str, Any]]:
        """One wire frame as its logical replies: an EXEC_BATCH reply's
        positional results, anything else itself."""
        if resp.get("ok") and isinstance(resp.get("results"), list):
            self._absorb_lease(resp)
            return list(resp["results"])
        return [resp]

    def _note_wire(self, n: int) -> None:
        """``n`` more pipelined replies to come from the socket, in order
        with the ring's while a lane exists."""
        self._wire_out += n
        if self._lane is not None:
            self._tok_wire += n
            self._pending.extend([("w",)] * n)

    def _flush_batch(self) -> None:
        items, self._pending_batch = self._pending_batch, []
        if not items:
            return
        if len(items) == 1:
            msg: Dict[str, Any] = dict(items[0], kind=P.EXECUTE)
        else:
            msg = {"kind": P.EXEC_BATCH, "items": items}
        self._send_or_rebind([P.frame_header(self._maybe_stamp(msg))])
        self._note_wire(len(items))

    def _sync_prelude(self) -> None:
        """Ship buffered executes and read every reply still on the wire,
        so the next frame read answers the synchronous request.  With a
        lane, every ring execute sent so far completes first (a GET of
        its output must find it bound)."""
        if self._degraded:
            self._degraded_gate()
        self._flush_batch()
        while self._pending:
            self._ready.append(self._next_pending_reply())
        while self._wire_out > 0:
            out = self._explode(self._recv_or_rebind())
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

    def _rpc(self, msg: Dict[str, Any], payloads=(),
             _retry: bool = True) -> Dict[str, Any]:
        """One synchronous request, its payloads as raw frames in the
        same gather write.  After a resumed reconnect an idempotent
        request runs again on the new instance, once."""
        self._sync_prelude()
        try:
            bufs = [P.frame_header(self._maybe_stamp(msg))]
            for p in payloads:
                bufs.extend(P.raw_frames(p))
            P.send_frames(self.sock, bufs)
            resp = self._recv()
        except (ConnectionError, P.ProtocolError, OSError):
            try:
                self._on_disconnect()
                raise AssertionError("unreachable")
            except VtpuConnectionLost as e:
                if e.resumed and _retry and not msg.get("staged") \
                        and msg.get("kind") in self._RESUME_RETRY_KINDS:
                    return self._rpc(msg, payloads, _retry=False)
                raise
        self._absorb_lease(resp)
        if not resp.get("ok"):
            self._raise_reply_error(resp)
        return resp

    def close(self) -> None:
        self._closed = True
        if self._lane is not None:
            self._lane.release_lease()
        self._drop_lane()
        if self._deg_enforcer is not None:
            self._deg_enforcer.close()
            self._deg_enforcer = None
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
        if self._degraded:
            # The last-granted cap decides before any transport attempt.
            self._degraded_gate(nbytes=len(flat))
        if self._lane is not None:
            # Nothing the broker may still read sits in the arena after
            # the prelude (feeds are copied out at dispatch).
            self._sync_prelude()
        lane = self._lane
        if lane is not None and lane.tx is not None and lane.usable() \
                and len(flat) <= lane.arena_nbytes:
            # One copy into the tx arena and a header on the socket; the
            # arena is free again once the ack is back.
            if len(flat):
                lane.tx[:len(flat)] = flat
            hdr.pop("raw_parts")
            hdr["arena_off"] = 0
            self._rpc(hdr)
        else:
            self._rpc(hdr, [flat])
        self._used_mirror[aid] = len(flat)
        return RemoteArray(self, aid, t.shape, t.dtype)

    def put_parts(self, x: Tensorish) -> int:
        """Reply frames a ``put_send`` costs: one on the raw framing."""
        return 1

    def put_send(self, x: Tensorish, aid: str) -> int:
        """Pipelined PUT: sent without reading its ack, which the caller
        consumes with ``recv_reply`` in send order; returns 1."""
        t = as_tensor(x)
        hdr, flat = self._put_raw_parts(t, aid)
        if self._degraded:
            self._degraded_gate(nbytes=len(flat))
        self._ring_pending_resolve()
        self._flush_batch()
        self._send_or_rebind([P.frame_header(self._maybe_stamp(hdr))]
                             + P.raw_frames(flat))
        self._note_wire(1)
        self._used_mirror[aid] = len(flat)
        return 1

    def get(self, aid: str, _retry: bool = True) -> torch.Tensor:
        """The tensor ``aid`` as a CPU tensor (raw framing: the payload is
        received into one buffer of its exact size).  Retried once after
        a resumed reconnect, like every idempotent request."""
        lane = self._lane
        arena = lane is not None and lane.rx is not None and lane.usable()
        msg = {"kind": P.GET, "id": aid, "raw": True}
        if arena:
            # The broker answers from the rx arena when the tensor fits.
            msg["arena"] = True
        resp = self._rpc(msg)
        buf = bytearray(int(resp["nbytes"]))
        lane = self._lane   # a resumed request answers from the new lane
        if resp.get("arena_off") is not None and lane is not None \
                and lane.rx is not None:
            off = int(resp["arena_off"])
            buf[:] = memoryview(lane.rx)[off:off + len(buf)]
            return tensor_from_bytes(buf, resp["dtype"], resp["shape"])
        mv = memoryview(buf)
        got = 0
        try:
            try:
                for _ in range(int(resp["raw_parts"])):
                    got += P.recv_raw_into(self.sock, mv[got:])
            except (ConnectionError, P.ProtocolError, OSError):
                self._on_disconnect()
        except VtpuConnectionLost as e:
            if e.resumed and _retry:
                return self.get(aid, _retry=False)
            raise
        return tensor_from_bytes(buf, resp["dtype"], resp["shape"])

    def delete(self, aid: str) -> None:
        self._rpc({"kind": P.DELETE, "id": aid})
        self._used_mirror.pop(aid, None)

    def delete_many(self, aids: Sequence[str]) -> None:
        """One round trip for any number of ids."""
        if aids:
            self._rpc({"kind": P.DELETE, "ids": list(aids)})
            for aid in aids:
                self._used_mirror.pop(aid, None)

    # -- compute --

    def compile(self, fn, example_args: Sequence[Tensorish]
                ) -> RemoteExecutable:
        """Trace ``fn`` here (``export_graph``: on meta tensors, no data)
        and register the graph with the broker."""
        return self.compile_blob(export_graph(fn, example_args))

    def compile_blob(self, blob: bytes) -> RemoteExecutable:
        """Register an already-serialized graph.  In degraded mode it
        queues (bounded) under a reserved id and registers at the
        reattach, so the handle becomes live then."""
        if self._degraded:
            if not self._try_reattach():
                if len(self._deg_q) >= max(self._deg_qmax, 0):
                    raise VtpuBrokerUnavailable(
                        f"degraded compile queue full ({self._deg_qmax} "
                        f"blobs); broker still unreachable")
                eid = f"e{next(self._ids)}"
                self._deg_q.append((eid, bytes(blob)))
                return RemoteExecutable(self, eid)
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

    def slo(self) -> Dict[str, Any]:
        """This tenant's own row of the broker's SLO plane
        (``runtime/slo.py``): phase quantiles, burn rates, its blame row,
        its fairness.  The broker scopes the reply to the bound tenant;
        co-tenants' rows and the blame matrix are the admin socket's."""
        r = self._rpc({"kind": P.SLO})
        return {"enabled": r.get("enabled", False),
                "tenants": r.get("tenants", {}),
                "fairness": r.get("fairness")}

    def trace(self, tenant: Optional[str] = None,
              limit: int = 0) -> Dict[str, Any]:
        """The flight recorder's spans and slow-op captures
        (``runtime/trace.py``): {"enabled", "tenants": {name: {spans,
        captures}}}."""
        msg: Dict[str, Any] = {"kind": P.TRACE}
        if tenant is not None:
            msg["tenant"] = tenant
        if limit:
            msg["limit"] = int(limit)
        r = self._rpc(msg)
        return {"enabled": r.get("enabled", False),
                "tenants": r.get("tenants", {})}

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
        any receive.  In degraded mode the last-granted share paces the
        attempt before it fails."""
        if self._degraded:
            self._degraded_gate(est_us=5000.0)
        if self._lane is not None:
            # The ring takes it, unless it is chained or frees ids, or the
            # gate is not open; going over the socket, the ring's executes
            # in flight complete first, so the dispatcher never sees an
            # output half bound.
            if repeats <= 1 and not free \
                    and self._fastlane_send(eid, list(arg_ids),
                                            list(out_ids)):
                return
            self._ring_pending_resolve()
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
        """The next pipelined reply (FIFO, whichever path carried it);
        raises the typed error of a refused one."""
        if self._ready:
            resp = self._ready.pop(0)
        else:
            if self._degraded:
                self._degraded_gate()
            self._flush_batch()
            if self._pending:
                resp = self._next_pending_reply()
            else:
                out = self._explode(self._recv_or_rebind())
                self._wire_out -= len(out)
                resp, self._ready = out[0], self._ready + out[1:]
        self._absorb_lease(resp)
        if not resp.get("ok"):
            self._raise_reply_error(resp)
        return resp

    # -- rate leases --

    def _absorb_lease(self, resp: Dict[str, Any]) -> None:
        """Mirror a reply's lease (µs and time to live, or a revoke).  The
        broker enforces; this copy paces a pipelining caller."""
        self._release_wire_feeds()
        lease = resp.get("lease")
        if not isinstance(lease, dict):
            return
        if lease.get("revoke"):
            self.lease_us = 0.0
            self.lease_exp = 0.0
            self.lease_revocations += 1
            return
        self.lease_us = float(lease.get("us", 0) or 0)
        self.lease_exp = time.monotonic() + float(lease.get("ttl_s", 0) or 0)

    def lease_remaining_us(self) -> float:
        """The mirrored lease's unexpired µs (0 when none)."""
        if time.monotonic() >= self.lease_exp:
            return 0.0
        return self.lease_us

    def burn_lease(self, us: float) -> bool:
        """Burn ``us`` of the mirrored lease; True while some is left."""
        if time.monotonic() >= self.lease_exp:
            self.lease_us = 0.0
            return False
        self.lease_us = max(self.lease_us - us, 0.0)
        return self.lease_us > 0.0

    # -- the fastlane --

    def _feed_done(self, seq: int) -> None:
        """A ring completion that owned a feed region was read: the
        drainer copied the bytes out before it completed."""
        if seq in self._fl_feed_seqs:
            self._fl_feed_seqs.discard(seq)
            if self._lane is not None:
                self._lane.feed_release()

    def _release_wire_feeds(self) -> None:
        """Socket feeds' regions come back together once no socket reply
        is outstanding (the dispatcher copies them out before replying)."""
        if self._fl_feed_wire and self._wire_out == 0 \
                and self._tok_wire == 0 and not self._pending_batch:
            n, self._fl_feed_wire = self._fl_feed_wire, 0
            if self._lane is not None:
                self._lane.feed_release(n)

    def _broker_alive(self) -> bool:
        """Whether the broker's end of the socket is still open, for the
        ring's waits.  POLLRDHUP sees a dead peer even behind reply bytes
        not yet read, which a peek reads as alive."""
        rdhup = getattr(select, "POLLRDHUP", 0)
        try:
            p = select.poll()
            p.register(self.sock.fileno(), select.POLLIN | rdhup)
            ev = p.poll(0)
        except (OSError, ValueError):
            return False
        if not ev:
            return True
        bad = select.POLLHUP | select.POLLERR | select.POLLNVAL | rdhup
        if ev[0][1] & bad:
            return False
        if rdhup:
            return True
        try:
            return bool(self.sock.recv(1, socket.MSG_PEEK | socket.MSG_DONTWAIT))
        except (BlockingIOError, InterruptedError):
            return True
        except OSError:
            return False

    def _ring_resp(self, route, res) -> Dict[str, Any]:
        """The reply of one ring completion: the route's output metadata
        (static), or the error its status names."""
        status, actual, _t_done = res
        if status == fastlane_mod.EXEC_OK:
            if actual > 0:
                route["cost"] = 0.8 * route["cost"] + 0.2 * float(actual)
            return {"ok": True, "outs": route["metas"],
                    "device_time_us": float(actual)}
        code = {fastlane_mod.EXEC_ENOTFOUND: "NOT_FOUND",
                fastlane_mod.EXEC_ECANCELED: "CONNECTION_LOST"}.get(
                    status, "INTERNAL")
        return {"ok": False, "code": code,
                "error": f"fastlane execute failed (status {status})"}

    def _resubmit_msg(self, route) -> Dict[str, Any]:
        eid, arg_ids, out_ids = route["key"]
        return {"kind": P.EXECUTE, "exe": eid, "args": list(arg_ids),
                "outs": list(out_ids)}

    def _resubmit_canceled(self, route) -> Dict[str, Any]:
        """A cancelled ring execute (it never ran) sent again over the
        socket, its reply taking the cancelled one's place.  Only for the
        oldest token, with nothing sent over the socket after it."""
        self.fl_resubmits += 1
        self._fl_gate_in = 0
        try:
            P.send_msg(self.sock, self._maybe_stamp(self._resubmit_msg(route)))
            resp = self._recv()
        except (ConnectionError, P.ProtocolError, OSError):
            self._on_disconnect()
            raise AssertionError("unreachable")
        return resp

    def _next_pending_reply(self) -> Dict[str, Any]:
        """The oldest pipelined reply, whichever path carries it."""
        tok = self._pending.popleft()
        if tok[0] == "w":
            self._tok_wire -= 1
            if self._wire_buf:
                return self._wire_buf.popleft()
            out = self._explode(self._recv_or_rebind())
            self._wire_out -= len(out)
            self._wire_buf.extend(out)
            return self._wire_buf.popleft()
        _kind, seq, route = tok[:3]
        self._tok_ring -= 1
        if len(tok) > 3:
            return self._ring_resp(route, tok[3])
        res = self._ring_wait(seq)
        if res[0] == fastlane_mod.EXEC_ECANCELED:
            return self._resubmit_canceled(route)
        return self._ring_resp(route, res)

    def _ring_wait(self, seq: int):
        lane = self._lane
        if lane is None:
            raise VtpuConnectionLost(
                "CONNECTION_LOST: the fastlane lane died with the broker "
                "connection; ring executes in flight were lost")
        try:
            res = lane.wait_result(seq, self._rpc_timeout
                                   if self._rpc_timeout > 0 else 120.0,
                                   alive_check=self._broker_alive)
        except ConnectionError:
            self._on_disconnect()
            raise AssertionError("unreachable")
        self._feed_done(seq)
        return res

    def _ring_pending_resolve(self) -> None:
        """Complete every ring token in place, in order, before a socket
        send that could read their outputs.  A cancelled one is sent
        again over the socket right here, before anything later, and its
        token becomes a socket token."""
        if self._lane is None or not self._tok_ring:
            return
        for i, tok in enumerate(self._pending):
            if tok[0] != "r" or len(tok) > 3:
                continue
            res = self._ring_wait(tok[1])
            if res[0] == fastlane_mod.EXEC_ECANCELED:
                self.fl_resubmits += 1
                self._fl_gate_in = 0
                try:
                    P.send_msg(self.sock, self._maybe_stamp(
                        self._resubmit_msg(tok[2])))
                except (ConnectionError, P.ProtocolError, OSError):
                    self._on_disconnect()
                self._pending[i] = ("w",)
                self._tok_ring -= 1
                self._tok_wire += 1
                self._wire_out += 1
            else:
                self._pending[i] = tok + (res,)

    def _route(self, lane, eid: str, arg_ids: List[str],
               out_ids: List[str]):
        """The route of (eid, args, outs), bound with FASTBIND on first
        use; None while the program is unprimed or the lane changed."""
        last = self._fl_last
        if last is not None and last[0] == eid and last[1] == arg_ids \
                and last[2] == out_ids:
            return last[3]
        key = (eid, tuple(arg_ids), tuple(out_ids))
        route = self._routes.get(key)
        if route is None or route == "prime":
            if not lane.usable():
                return None
            try:
                rep = self._rpc({"kind": P.FASTBIND, "exe": eid,
                                 "args": arg_ids, "outs": out_ids})
            except RuntimeError_ as e:
                if not str(e).startswith(("FASTLANE_OFF", "NOT_FOUND")):
                    raise
                return None     # the socket answers for it
            rid = int(rep.get("route", -1))
            if rid < 0:
                # Never run over the socket: this step goes there.
                self._routes[key] = "prime"
                return None
            route = {"id": rid, "cost": float(rep.get("cost_us") or 5000.0),
                     "metas": rep.get("outs") or [], "key": key}
            self._routes[key] = route
            if self._lane is not lane:
                # The round trip rode a reconnect: the route belongs to the
                # new lane; this step goes over the socket.
                return None
        self._fl_last = (eid, arg_ids, out_ids, route)
        return route

    def _fastlane_send(self, eid: str, arg_ids: List[str],
                       out_ids: List[str], feed=None,
                       feed_arg: int = 0) -> bool:
        """One unchained execute onto the ring; False sends it over the
        socket (unprimed program, gate not open, feed window full).
        ``feed`` rides the tx arena as the descriptor's blob."""
        lane = self._lane
        route = self._route(lane, eid, arg_ids, out_ids)
        if route is None:
            return False
        self._fl_gate_in -= 1
        if self._fl_gate_in < 0:
            self._fl_gate_in = 63
            if not lane.usable():
                # Parked or closed: give back the lease held at the
                # broker's last word and go over the socket.
                lane.release_lease()
                self._fl_gate_in = 0
                return False
        # Socket work in flight is not overtaken by a ring execute.
        if self._pending_batch:
            self._flush_batch()
        if self._tok_wire:
            while self._pending and self._pending[0][0] == "w":
                self._ready.append(self._next_pending_reply())
            if self._tok_wire:
                return False
        f_off = f_len = 0
        if feed is not None:
            flat = tensor_bytes(feed)
            f_len = len(flat)
            f_off = lane.feed_alloc(f_len)
            if f_off is None:
                return False
            lane.tx[f_off:f_off + f_len] = flat
        seq = lane.buffer(route["id"], route["cost"], f_off, f_len,
                          feed_arg if feed is not None else 0)
        if feed is not None:
            self._fl_feed_seqs.add(seq)
        if lane.buffered >= 32:
            try:
                lane.flush(self._broker_alive)
            except ConnectionError:
                self._on_disconnect()
                raise AssertionError("unreachable")
        self._pending.append(("r", seq, route))
        self._tok_ring += 1
        return True

    def feed_capable(self) -> bool:
        """Whether per-step host batches can ride the tx arena (a lane
        with an arena, ``VTPU_ARENA_FEED`` on)."""
        lane = self._lane
        return (lane is not None and lane.tx is not None
                and fastlane_mod.arena_feed_enabled())

    def _feed_write(self, flats) -> Optional[List[int]]:
        """Host batches copied into the tx arena's feed window; their
        offsets, or None when even a drained window cannot hold them."""
        lane = self._lane
        offs: List[int] = []
        for flat in flats:
            nb = len(flat)
            off = lane.feed_alloc(nb)
            if off is None:
                # Full: the pipeline drains (reading the replies frees
                # every region) and the window starts over.
                self._sync_prelude()
                if self._lane is not lane:
                    return None
                lane.feed_reset()
                off = lane.feed_alloc(nb)
                if off is None:
                    lane.feed_release(len(offs))
                    return None
            lane.tx[off:off + nb] = flat
            offs.append(off)
        return offs

    def execute_send_feed(self, eid: str, arg_ids: Sequence[str],
                          out_ids: Sequence[str], feeds, feed_arg: int = 0,
                          repeats: int = 1,
                          carry: Sequence[Sequence[int]] = ((0, 0),),
                          free: Sequence[str] = ()) -> bool:
        """A pipelined execute whose host batch rides the tx arena, not a
        socket PUT: ``feeds`` is one tensor (or numpy array), or one per
        step of a chain.  Unchained, the batch binds in the broker under
        ``arg_ids[feed_arg]``, replacing it and charged like the PUT it
        stands for.  Once a socket feed has bound that id, later
        unchained steps put the batch in a ring descriptor.  False when
        the arena cannot carry it (no lane, ``VTPU_ARENA_FEED=0``, larger
        than the feed window): send a PUT instead.  Consumes one reply,
        like ``execute_send_ids``."""
        lane = self._lane
        if not self.feed_capable() or not lane.usable():
            return False
        ts = [as_tensor(a) for a in (feeds if isinstance(feeds, (list, tuple))
                                     else [feeds])]
        if not ts or (repeats > 1 and len(ts) not in (1, repeats)):
            return False
        fid = str(arg_ids[feed_arg])
        key = (eid, fid, int(feed_arg))
        if repeats <= 1 and len(ts) == 1 and not free \
                and key in self._fed_routes:
            if self._fastlane_send(eid, list(arg_ids), list(out_ids),
                                   feed=ts[0], feed_arg=feed_arg):
                return True
            self._ring_pending_resolve()
        offs = self._feed_write([tensor_bytes(t) for t in ts])
        if offs is None:
            return False
        item: Dict[str, Any] = {
            "exe": eid, "args": list(arg_ids), "outs": list(out_ids),
            "feeds": [[fid, int(feed_arg), int(off), t.numel()
                       * t.element_size(), list(t.shape),
                       dtype_name(t.dtype)] for t, off in zip(ts, offs)]}
        if repeats > 1:
            item["repeats"] = int(repeats)
            item["carry"] = [list(p) for p in carry]
        if free:
            item["free"] = list(free)
        self._fl_feed_wire += len(offs)
        self._fed_routes.add(key)
        self._pending_batch.append(item)
        if len(self._pending_batch) >= max(self._batch_max, 1):
            self._flush_batch()
        return True

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
