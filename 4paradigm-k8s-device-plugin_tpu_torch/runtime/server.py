"""The broker: one process owns the node's cards and runs tenant programs
under each tenant's HBM cap and compute share.

The port of ``vtpu.runtime.server``'s core.  ``vtpu`` needs a broker
because libtpu admits one process per chip; the CUDA driver admits many,
so on the H100 the broker is the time-shared path beside the interposed
one (``shim/interposer.py``), for tenants that never open the card:

  tenant process                        broker (this file)
  --------------                        ------------------
  vtpu_torch.runtime.client --socket--> TenantSession (thread)
    put tensor                            quota check -> copy to the card
    compile torch.export graph            vet the graph JSON -> load
    execute(exe, args)                    scheduler queue -> dispatch
    get/delete                            copy back / free

The wire is ``vtpu``'s (``protocol.py``): a ``vtpu`` client can HELLO,
PUT, GET, DELETE and read STATS here.  What differs is the program:

- **COMPILE unpickles nothing.**  A program is the JSON graph of a
  ``torch.export`` ExportedProgram (``SerializedArtifact.exported_program``)
  and nothing else.  ``torch.export.load`` would ``torch.load`` the state
  dict, constants and example inputs, falling back to a full unpickle;
  the broker holds every tenant's tensors and runs no tenant's pickle.
  ``_vet_graph`` reads the JSON with ``json`` and refuses, with
  INVALID_ARGUMENT, a blob that is not such a graph, a signature with any
  parameter, buffer or lifted constant, symbolic shapes, and any op off
  the broker's list (``_ALLOWED_OPS``: no op that returns unwritten
  memory, resizes, skips bounds checks or reads files) or whose schema
  writes to an argument; it strips the nodes' source metadata; the graph
  is then deserialized with the three other parts empty, which never
  reaches ``torch.load``.  The program is moved to the card
  (``move_to_device_pass``: a tenant traces on ``meta`` tensors, so
  tensors made inside the graph name ``meta``), and a graph that still
  names another device is refused.  An output that is a view of an
  argument or of a larger storage is copied, so the ledger charges all
  that an output holds.
- **K1 runs here.**  ``ops.flash_attention`` registers the attention as
  ``torch.ops.vtpu_torch.flash_attention``; a tenant's graph carries the
  op, and on the card the op's CUDA implementation launches the kernel.
- **Completion is a CUDA event.**  Replies go out at dispatch (output
  shapes are static in the graph); every copy and launch of a card runs
  on that card's one stream, so a PUT's copy is ordered before the
  execute that reads it; the metering thread waits on the event of a
  batch's last item, on its own thread only.
- **Chained execute** (``repeats``/``carry``) is a loop in the
  dispatcher: K-1 carried calls and one plain call whose outputs all
  return, queued with no host synchronisation.
- **An execute's outputs are admitted before it runs** (their sizes are
  in the graph), so a program whose outputs do not fit the cap is
  refused with RESOURCE_EXHAUSTED and nothing moves; ``vtpu`` admits
  outputs after dispatch whatever the cap.
- **A device fault ends the broker.**  Under XLA a failed program poisons
  its outputs and the tenant's next request raises; on CUDA a fault
  during a kernel leaves the context unusable, so the metering thread
  exits the process (the daemon restarts brokers).

Scheduling is ``vtpu``'s: per-tenant queues, a dispatcher that
round-robins over tenants and gates each item on its tenant's token
bucket in the card's region (priority 0 borrows), at most
``MAX_INFLIGHT`` items in flight per tenant, and the metering rule
``busy = min(t_obs - prev_obs, t_obs - t0 - L)``.  The tenant's slot in
the card's region carries its HELLO grant (HBM cap, core share).

Not here yet, each refused with the ROADMAP item that holds it: the
journal and handover (DRAIN, HANDOVER, RESIZE, ``VTPU_JOURNAL_DIR``),
tracing (``VTPU_TRACE=1``; TRACE answers ``enabled: false``), the
fastlane (FASTBIND), the SLO plane (SLO answers ``enabled: false``),
migration and replication (MIGRATE*, REPL_SYNC, ``--cluster``).  Also
left out of this core: rate leases, burst credits, preemption, overload
shedding, host spill of an oversubscribed tenant, PUT dedup and grants
over several cards.

Run: python -m vtpu_torch.runtime.server --socket /tmp/rt.sock \\
        --hbm-limit 8Gi --core-limit 50 [--device cpu]
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import glob
import hashlib
import json
import operator
import os
import queue
import re
import socket
import socketserver
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..ops import flash_attention as _fa  # noqa: F401 - registers K1's op
from ..shim.core import SharedRegion
from ..utils import envspec
from ..utils import logging as log
from ..utils.dtypes import dtype_name, tensor_bytes, tensor_from_bytes
from . import protocol as P

MAX_TENANTS = 16
# Dispatched-but-not-yet-metered items per tenant.
MAX_INFLIGHT = 32
# Loaded programs shared across tenants, by (blob sha256, card); LRU.
BLOB_CACHE_CAP = 64
# Un-replied executes per connection: the session reader blocks past
# this, so a client that pipelines without reading cannot stall the
# dispatcher's reply sends for every tenant.
MAX_PENDING_REPLIES = 128
# Estimated device time queued per card before dispatch pauses (µs).
MAX_QUEUED_US = int(os.environ.get("VTPU_MAX_QUEUE_US", "4000000"))
# Items the dispatcher takes per wake.
WAKE_BATCH = max(int(os.environ.get("VTPU_WAKE_BATCH", "32")), 1)
# A device fault ends the broker with this code (the daemon restarts it).
DEVICE_FAULT_EXIT = 3

# The sub-items of ROADMAP.md Queue 1 item 6 that hold what this core
# refuses.
_DEFERRED = {
    P.FASTBIND: "6(c), the fastlane",
    P.DRAIN: "6(b), the journal and handover",
    P.HANDOVER: "6(b), the journal and handover",
    P.RESIZE: "6(b), the journal (a resize is journaled)",
    P.MIGRATE: "6(d), migration and replication",
    P.MIGRATE_OUT: "6(d), migration and replication",
    P.MIGRATE_IN: "6(d), migration and replication",
    P.REPL_SYNC: "6(d), migration and replication",
}


def deferred(what: str, item: str) -> str:
    return (f"{what} is not ported to the H100 yet (ROADMAP.md, Queue 1 "
            f"item {item})")


class InvalidProgram(ValueError):
    """A COMPILE blob that is not a graph the broker runs."""


# -- program loading -----------------------------------------------------------

_TARGET = re.compile(
    r"torch\.ops\.(aten|vtpu_torch)\.([A-Za-z0-9_]+)\.[A-Za-z0-9_]+")
# The ops a program may call, by (namespace, name), any overload whose
# schema writes to none of its arguments.  Every tenant's tensors share
# one caching allocator per card, so ops that hand out memory nobody has
# written (the empty family), resize or re-point a tensor (resize_, set_),
# skip bounds checks (_unsafe_index), build unchecked sparse tensors or
# read files (from_file) are left out: a namespace check would pass them.
_ALLOWED_OPS = frozenset({("vtpu_torch", "flash_attention")} | {
    ("aten", n) for n in """
    abs neg exp exp2 expm1 log log1p log2 log10 sqrt rsqrt reciprocal sin
    cos tan tanh sinh cosh asin acos atan sigmoid silu gelu relu erf erfc
    sign sgn floor ceil round trunc frac square clamp clamp_min clamp_max
    logical_not bitwise_not isnan isinf isfinite nan_to_num softplus
    leaky_relu elu hardtanh positive
    add sub rsub mul div true_divide floor_divide remainder fmod pow
    maximum minimum eq ne lt le gt ge logical_and logical_or logical_xor
    bitwise_and bitwise_or bitwise_xor __and__ __or__ __xor__ __lshift__
    __rshift__ bitwise_left_shift bitwise_right_shift atan2 where lerp
    addcmul addcdiv copysign hypot xlogy masked_fill
    sum mean prod amax amin max min argmax argmin var std var_mean
    logsumexp softmax _softmax log_softmax _log_softmax cumsum cumprod all
    any linalg_vector_norm topk sort argsort
    matmul mm bmm addmm baddbmm linear dot outer einsum
    scaled_dot_product_attention layer_norm native_layer_norm rms_norm
    view reshape _unsafe_view transpose permute t unsqueeze squeeze expand
    expand_as flatten unflatten contiguous clone slice select narrow chunk
    split split_with_sizes unbind cat stack repeat repeat_interleave tile
    flip roll movedim alias detach lift_fresh_copy tril triu diagonal
    constant_pad_nd pad gather index_select index embedding take_along_dim
    one_hot copy fill scatter scatter_add index_put convolution conv1d
    conv2d max_pool2d avg_pool2d adaptive_avg_pool2d dropout native_dropout
    rand randn randint rand_like randn_like bernoulli
    arange ones zeros full ones_like zeros_like full_like scalar_tensor
    linspace eye to _to_copy type_as _assert_tensor_metadata
    """.split()})


def _op_name(target: str) -> Optional[Tuple[str, str]]:
    m = _TARGET.fullmatch(target)
    return (m.group(1), m.group(2)) if m else None


# Argument kinds that carry symbolic expressions (parsed with sympy),
# sub-graphs, script objects or callables: none of them is accepted.
_BANNED_ARG = ("as_sym", "as_graph", "as_custom_obj", "as_operator")


def _walk_keys(node, found: set) -> None:
    if isinstance(node, dict):
        for k, v in node.items():
            if isinstance(k, str) and k.startswith(_BANNED_ARG):
                found.add(k)
            _walk_keys(v, found)
    elif isinstance(node, list):
        for v in node:
            _walk_keys(v, found)


def _vet_graph(blob: bytes) -> bytes:
    """The graph JSON, vetted and stripped of source metadata; raises
    InvalidProgram for anything else (module docstring)."""
    try:
        doc = json.loads(bytes(blob).decode("utf-8"))
        gm = doc["graph_module"]
        graph, sig = gm["graph"], gm["signature"]
        nodes = graph["nodes"]
    except (UnicodeDecodeError, ValueError, KeyError, TypeError):
        raise InvalidProgram(
            "not a torch.export graph (send "
            "SerializedArtifact.exported_program: the JSON graph alone, "
            "never a torch.export.save archive or a pickle)") from None
    bad = [next(iter(s)) for s in sig.get("input_specs", ())
           if set(s) != {"user_input"}]
    bad += [next(iter(s)) for s in sig.get("output_specs", ())
            if set(s) != {"user_output"}]
    if bad:
        raise InvalidProgram(
            f"the graph's signature names {sorted(set(bad))}"
            ": a program takes every tensor as an argument (no parameter, "
            "buffer or lifted constant)")
    if doc.get("range_constraints") or doc.get("guards_code") or any(
            graph.get(k) for k in ("sym_int_values", "sym_bool_values",
                                   "sym_float_values", "custom_obj_values")):
        raise InvalidProgram("symbolic shapes and script "
                             "objects are not accepted")
    found: set = set()
    _walk_keys(gm, found)
    if found:
        raise InvalidProgram(f"argument kinds "
                             f"{sorted(found)} are not accepted")
    ops = sorted({str(n.get("target")) for n in nodes
                  if _op_name(str(n.get("target"))) not in _ALLOWED_OPS})
    if ops:
        raise InvalidProgram(f"ops a program may not call: {ops[:8]}")
    for n in nodes:
        n["metadata"] = {}
    gm["metadata"] = {}
    return json.dumps(doc).encode()


def load_program(blob: bytes, device: torch.device) -> "Program":
    """A program from a vetted graph, moved to ``device``."""
    from torch._export.serde.serialize import SerializedArtifact, deserialize
    from torch.export.passes import move_to_device_pass

    graph = _vet_graph(blob)
    try:
        ep = deserialize(SerializedArtifact(graph, b"", b"", b""))
    except Exception as e:  # noqa: BLE001 - any malformed graph
        raise InvalidProgram(f"graph does not load: "
                             f"{type(e).__name__}: {e}") from None
    for n in ep.graph.nodes:
        # The loader itself unpacks multi-output ops with getitem.
        if n.op != "call_function" or n.target is operator.getitem:
            continue
        if not isinstance(n.target, torch._ops.OpOverload) or (
                n.target.namespace, n.target._schema.name.split("::")[-1]
        ) not in _ALLOWED_OPS or n.target._schema.is_mutable:
            raise InvalidProgram(f"op {n.target} is not one a program may "
                                 "call (it writes to an argument or is not "
                                 "on the broker's list)")
    dev = torch.device(device)
    try:
        ep = move_to_device_pass(ep, {"meta": str(dev), "cpu": str(dev)})
    except Exception as e:  # noqa: BLE001 - a device this broker lacks
        raise InvalidProgram(f"graph does not move to {dev}: "
                             f"{type(e).__name__}: {e}") from None
    for n in ep.graph.nodes:
        # A device left in the graph (another card, pinned host memory)
        # would put the program's tensors outside the tenant's ledger.
        if n.op != "call_function" or n.target is operator.getitem:
            continue
        for i, a in enumerate(n.target._schema.arguments):
            v = n.args[i] if i < len(n.args) and not a.kwarg_only \
                else n.kwargs.get(a.name)
            if v is not None and (
                    (a.name == "pin_memory" and v) or
                    ("Device" in str(a.type) and torch.device(v) != dev)):
                raise InvalidProgram(f"node {n.name} places a tensor off "
                                     f"the tenant's card {dev}")
    placeholders = [n for n in ep.graph.nodes if n.op == "placeholder"]
    out_node = next(n for n in ep.graph.nodes if n.op == "output")
    outs = out_node.args[0]
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    in_meta = [(tuple(n.meta["val"].shape), n.meta["val"].dtype)
               for n in placeholders]
    out_meta = []
    for o in outs:
        v = o.meta["val"]
        out_meta.append({"shape": list(v.shape), "dtype": dtype_name(v.dtype),
                         "nbytes": v.numel() * v.element_size()})
    return Program(ep.module(), in_meta, out_meta,
                   hashlib.sha256(blob).hexdigest())


class Program:
    """A loaded tenant program: the graph's module on one card, its
    inputs' (shape, dtype) and its outputs' static metadata."""

    __slots__ = ("fn", "in_meta", "out_meta", "n_outs", "warmed", "sha")

    def __init__(self, fn, in_meta, out_meta, sha):
        self.fn = fn
        self.in_meta = in_meta
        self.out_meta = out_meta
        self.n_outs = len(out_meta)
        # (steps, carry) variants that ran once: a first run's window
        # holds one-time costs and is billed at its estimate.
        self.warmed = set()
        self.sha = sha

    def run(self, args: List[torch.Tensor], steps: int,
            carry) -> List[torch.Tensor]:
        """``steps`` calls, each step's mapped outputs fed back into the
        next step's arguments (K-1 carried calls and one plain call whose
        outputs all return); nothing synchronises with the device.  Every
        output owns a storage of its own size: one that is a view of an
        argument, of another output or of a larger tensor is copied, or
        it would hold memory its ledger entry does not charge."""
        cur = list(args)
        for _ in range(steps - 1):
            outs = self._call(cur)
            for oi, ai in carry:
                cur[ai] = outs[oi]
        outs = self._call(cur)
        seen = {a.untyped_storage().data_ptr() for a in args}
        for i, o in enumerate(outs):
            st = o.untyped_storage()
            if o.numel() and (st.data_ptr() in seen or
                              st.nbytes() != o.numel() * o.element_size()):
                outs[i] = o = o.clone(memory_format=torch.contiguous_format)
            seen.add(o.untyped_storage().data_ptr())
        return outs

    def _call(self, args) -> List[torch.Tensor]:
        outs = self.fn(*args)
        return list(outs) if isinstance(outs, (list, tuple)) else [outs]


# -- tenants and the scheduler -------------------------------------------------

class Tenant:
    """One tenant, bound to one card (``chip``) and one slot of that
    card's region (``index``), which carries its grant."""

    def __init__(self, name: str, index: int, priority: int,
                 oversubscribe: bool, chip: "ChipState"):
        self.name = name
        self.index = index
        self.chip = chip
        self.priority = priority
        self.oversubscribe = oversubscribe
        # Guards arrays/nbytes: the dispatcher registers outputs while
        # session threads serve PUT/GET/DELETE.  Each array is charged its
        # nbytes on the tenant's one card.
        self.mu = threading.Lock()
        self.arrays: Dict[str, torch.Tensor] = {}
        self.nbytes: Dict[str, int] = {}
        self.executables: Dict[str, Program] = {}
        self.cost_ema: Dict[str, float] = {}
        self.executions = 0
        self.connections = 0
        # Server-assigned output ids when the client sent fewer out ids
        # than the program has outputs.
        self.anon_seq = 0
        self._metered_cache: Optional[Tuple[bool, float]] = None

    def charge_array(self, nbytes: int) -> bool:
        """Admit ``nbytes`` against the slot's cap; False (nothing
        charged) when it refuses."""
        return self.chip.region.mem_acquire(self.index, nbytes,
                                            self.oversubscribe)

    def release_array(self, nbytes: int) -> None:
        self.chip.region.mem_release(self.index, nbytes)

    def drop_array(self, aid: str) -> int:
        """Free one array and its charge; returns its bytes.  Caller
        holds self.mu."""
        if self.arrays.pop(aid, None) is None:
            return 0
        nbytes = self.nbytes.pop(aid, 0)
        self.release_array(nbytes)
        return nbytes

    def metered_on(self, now: float) -> bool:
        """Whether the slot has a compute share, cached for 0.5 s."""
        v = self._metered_cache
        if v is None or now >= v[1]:
            pct = self.chip.region.device_stats(self.index).core_limit_pct
            v = (pct > 0, now + 0.5)
            self._metered_cache = v
        return v[0]


class WorkItem:
    """One queued EXECUTE: argument ids resolve at dispatch, so a
    pipelined step may name an earlier step's output."""

    __slots__ = ("tenant", "session", "exe", "key", "arg_ids", "out_ids",
                 "steps", "carry", "metered", "est_us", "first_run",
                 "free_ids", "batch", "batch_idx")

    def __init__(self, tenant, session, exe, key, arg_ids, out_ids,
                 steps=1, carry=(), free_ids=()):
        self.tenant = tenant
        self.session = session
        self.exe = exe
        self.key = key
        self.arg_ids = arg_ids
        self.out_ids = out_ids
        self.steps = max(int(steps), 1)
        self.carry = carry
        self.metered = False
        self.est_us = 0.0
        self.first_run = False
        # Dropped at this item's dispatch: every earlier item of the
        # tenant's FIFO queue has resolved its arguments by then.
        self.free_ids = tuple(free_ids)
        self.batch: "Optional[_BatchReply]" = None
        self.batch_idx = 0


class _ItemError(Exception):
    """Typed validation failure of one execute body."""

    def __init__(self, code: str, msg: str):
        super().__init__(msg)
        self.code = code
        self.msg = msg


class _BatchReply:
    """One EXEC_BATCH's positional results; ``fill`` returns True to the
    one caller that filled the last slot, which sends the frame."""

    __slots__ = ("mu", "results", "left")

    def __init__(self, n: int):
        self.mu = threading.Lock()
        self.results: List[Optional[dict]] = [None] * n
        self.left = n

    def fill(self, idx: int, result: dict) -> bool:
        with self.mu:
            if self.results[idx] is None:
                self.results[idx] = result
                self.left -= 1
            return self.left == 0


class SlotsExhausted(RuntimeError):
    """Every tenant slot of the card is bound (answered OVERLOAD)."""


def sparse_batch_learn_scale(batch_est_us: float, disp_us: float,
                             n_items: int) -> Optional[float]:
    """A sparse multi-item batch whose tail window exceeds the whole
    batch's estimate 3x teaches each item its share of the window
    (``vtpu``'s rule); None when the estimates are plausible."""
    if n_items <= 1 or batch_est_us <= 0.0 \
            or disp_us <= 3.0 * batch_est_us:
        return None
    return disp_us / batch_est_us


class DeviceScheduler:
    """Per-tenant queues and round-robin dispatch gated on the token
    buckets, one dispatcher and one metering thread per card."""

    def __init__(self, state: "RuntimeState", chip: "ChipState"):
        self.state = state
        self.chip = chip
        self.mu = threading.Condition()
        self.queues: Dict[str, collections.deque] = {}
        self.inflight: Dict[str, int] = {}
        self.not_ready_until: Dict[str, float] = {}
        self.rr: List[str] = []
        self._rr_pos = 0
        self._completion_q: "queue.Queue" = queue.Queue()
        self._pool_us = 0.0   # unbilled device time (metering loop only)
        self._prev_obs = 0.0  # last completion observation (metering)
        self.queued_est_us = 0.0
        self._stop = False
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name=f"vtpu-rt-dispatch-{chip.index}")
        self._completer = threading.Thread(
            target=self._completion_loop, daemon=True,
            name=f"vtpu-rt-complete-{chip.index}")
        self._dispatcher.start()
        self._completer.start()

    def submit(self, item: WorkItem) -> None:
        self.submit_many((item,))

    def submit_many(self, items) -> None:
        """Enqueue items under one lock acquisition and one wake."""
        with self.mu:
            for item in items:
                name = item.tenant.name
                if name not in self.queues:
                    self.queues[name] = collections.deque()
                    self.rr.append(name)
                self.queues[name].append(item)
            self.mu.notify_all()

    def kick(self) -> None:
        with self.mu:
            self.mu.notify_all()

    def quiesce(self, name: str, timeout: float = 30.0) -> None:
        """Wait until every dispatched item of ``name`` is metered (not
        the queued ones: a throttled queue drains at bucket speed)."""
        deadline = time.monotonic() + timeout
        with self.mu:
            while self.inflight.get(name, 0) > 0 \
                    and time.monotonic() < deadline:
                self.mu.wait(timeout=0.1)

    def forget_tenant(self, name: str) -> None:
        with self.mu:
            self.queues.pop(name, None)
            self.inflight.pop(name, None)
            self.not_ready_until.pop(name, None)
            if name in self.rr:
                self.rr.remove(name)

    def purge_session(self, session) -> int:
        """Drop the still-queued items of a dead connection (dispatched
        ones complete), so its teardown cannot wait on a suspended or
        throttled queue; their dispatch-time frees are applied."""
        purged = []
        with self.mu:
            for q in self.queues.values():
                kept = [it for it in q if it.session is not session]
                if len(kept) != len(q):
                    purged.extend(it for it in q if it.session is session)
                    q.clear()
                    q.extend(kept)
            if purged:
                self.mu.notify_all()
        for it in purged:
            session.abandon(it)
            if it.free_ids:
                with it.tenant.mu:
                    for fid in it.free_ids:
                        it.tenant.drop_array(fid)
        return len(purged)

    # -- dispatch --

    def _pick_locked(self):
        """Next dispatchable item by round robin over eligible tenants,
        and the soonest time a throttled one becomes ready."""
        now = time.monotonic()
        soonest = None
        if self.queued_est_us >= MAX_QUEUED_US:
            return None, now + 0.01
        n = len(self.rr)
        for i in range(n):
            idx = (self._rr_pos + i) % n
            name = self.rr[idx]
            q = self.queues.get(name)
            if not q or name in self.state.suspended:
                continue
            if self.inflight.get(name, 0) >= MAX_INFLIGHT:
                continue
            nr = self.not_ready_until.get(name, 0.0)
            if nr > now:
                soonest = nr if soonest is None else min(soonest, nr)
                continue
            item = q[0]
            t = item.tenant
            est = max(t.cost_ema.get(item.key, 5000.0),
                      float(self.state.min_exec_cost_us)) * item.steps
            metered = t.metered_on(now)
            if metered:
                # The region's bucket: priority 0 borrows instead of
                # waiting (vtpu_core.h).
                wait_ns = self.chip.region.rate_acquire(t.index, int(est),
                                                        t.priority)
                if wait_ns:
                    nr = now + wait_ns / 1e9
                    self.not_ready_until[name] = nr
                    soonest = nr if soonest is None else min(soonest, nr)
                    continue
            q.popleft()
            item.metered = metered
            item.est_us = est
            item.first_run = (item.steps, item.carry) not in item.exe.warmed
            self.inflight[name] = self.inflight.get(name, 0) + 1
            self.queued_est_us += est
            self._rr_pos = (idx + 1) % n
            return item, soonest
        return None, soonest

    def _dispatch_loop(self):
        while not self._stop:
            with self.mu:
                items = []
                soonest = None
                while len(items) < WAKE_BATCH:
                    item, soonest = self._pick_locked()
                    if item is None:
                        break
                    items.append(item)
                if not items:
                    timeout = 0.5 if soonest is None else max(
                        min(soonest - time.monotonic(), 0.5), 0.001)
                    self.mu.wait(timeout=timeout)
                    continue
            done = []
            with self.chip.context():
                for item in items:
                    r = self._dispatch_item(item)
                    if r is not None:
                        done.append(r)
            if done:
                self._completion_q.put(done)

    def _dispatch_item(self, item: WorkItem):
        """Resolve the arguments, admit the outputs, queue the program on
        the card's stream, register the outputs and reply; returns
        (item, t0, outputs, event) for the metering thread, or None when
        the item failed before reaching the device."""
        t = item.tenant
        t0 = time.monotonic()
        metas = []
        need = sum(m["nbytes"] for m in item.exe.out_meta)
        admitted = False
        try:
            with t.mu:
                for fid in item.free_ids:
                    t.drop_array(fid)
                args = []
                for aid in item.arg_ids:
                    a = t.arrays.get(aid)
                    if a is None:
                        raise KeyError(f"NOT_FOUND: {aid}")
                    args.append(a)
            if not t.charge_array(need):
                free, total = self.chip.region.mem_info(t.index)
                raise MemoryError(
                    f"RESOURCE_EXHAUSTED: tenant {t.name} over HBM quota: "
                    f"outputs of {need} bytes, quota {total} (free {free})")
            admitted = True
            with torch.inference_mode():
                outs = item.exe.run(args, item.steps, item.carry)
            event = self.chip.record()
            with t.mu:
                for i, o in enumerate(outs):
                    if i < len(item.out_ids):
                        oid = item.out_ids[i]
                    else:
                        t.anon_seq += 1
                        oid = f"_anon{t.anon_seq}"
                    m = item.exe.out_meta[i]
                    t.drop_array(oid)
                    t.arrays[oid] = o
                    t.nbytes[oid] = m["nbytes"]
                    metas.append({"id": oid, "shape": m["shape"],
                                  "dtype": m["dtype"]})
        except Exception as e:  # noqa: BLE001 - reply with the error
            if admitted:
                t.release_array(need)
            if item.metered:
                self.chip.region.rate_adjust(t.index, -int(item.est_us))
            item.session.complete_execute(item, metas, e, 0.0)
            self._retire_many((item,))
            return None
        item.exe.warmed.add((item.steps, item.carry))
        item.session.complete_execute(item, metas, None, item.est_us)
        return (item, t0, outs, event)

    def _retire_many(self, items) -> None:
        with self.mu:
            for item in items:
                name = item.tenant.name
                if name in self.inflight:  # forgotten stay forgotten
                    self.inflight[name] = max(self.inflight[name] - 1, 0)
                self.queued_est_us = max(
                    self.queued_est_us - item.est_us, 0.0)
            self.mu.notify_all()

    # -- metering --

    def _completion_loop(self):
        """Retires dispatched items in device order: one wait on the
        last item's event retires a batch (the card runs one stream in
        order), capped by estimated device time so the oldest item of a
        long batch is not held back by the newest."""
        while not self._stop:
            try:
                first = self._completion_q.get(timeout=0.5)
            except queue.Empty:
                # Idle: what is left in the pool is stale.
                self._pool_us = 0.0
                continue
            drain_cap_us = max(3.0 * self.chip.latency_us, 50_000.0)
            batch = list(first)
            batch_est = sum(it.est_us for it, _, _, _ in batch)
            while batch_est < drain_cap_us:
                try:
                    nxt = self._completion_q.get_nowait()
                except queue.Empty:
                    break
                batch.extend(nxt)
                batch_est += sum(it.est_us for it, _, _, _ in nxt)
            self._meter_batch(batch)

    def _meter_batch(self, batch) -> None:
        """Observe, bill and retire one drained batch of (item, t0,
        outputs, event) tuples.  With t_obs the time the batch's last
        event was seen complete, prev_obs the previous observation, t0 an
        item's dispatch and L the calibrated empty round trip:
        busy = min(t_obs - prev_obs, t_obs - t0 - L)."""
        event = batch[-1][3]
        if event is not None:
            try:
                event.synchronize()
            except RuntimeError as e:
                log.error("device fault on card %d (%s): the CUDA context "
                          "is unusable; the broker exits", self.chip.index,
                          e)
                os._exit(DEVICE_FAULT_EXIT)
        batch_est = sum(it.est_us for it, _, _, _ in batch)
        t_obs = time.monotonic()
        lat_s = self.chip.latency_us / 1e6
        min_cost = float(self.state.min_exec_cost_us)
        obs_us = max(t_obs - self._prev_obs, 0.0) * 1e6
        cont_us = max(t_obs - batch[0][1] - lat_s, 0.0) * 1e6
        disp_us = max(t_obs - batch[-1][1] - lat_s, 0.0) * 1e6
        self._prev_obs = t_obs
        continuous = obs_us <= cont_us
        if continuous:
            # The card ran without a gap: the completion-to-completion
            # window is device time for the whole batch.
            self._pool_us = min(self._pool_us + min(obs_us, batch_est * 4.0),
                                2_000_000.0)
        else:
            self._pool_us = 0.0
        learn_scale = None if continuous else sparse_batch_learn_scale(
            batch_est, disp_us, len(batch))
        region = self.chip.region
        for item, t0, _outs, _ev in batch:
            t = item.tenant
            prev_ema = t.cost_ema.get(item.key, 5000.0)
            per_step = None
            if item.first_run:
                busy_us = item.est_us
            elif continuous:
                cap_us = max(item.est_us * 4.0, min_cost * item.steps)
                busy_us = min(self._pool_us, cap_us)
                self._pool_us -= busy_us
                per_step = busy_us / item.steps
            elif len(batch) == 1:
                busy_us = min(disp_us, max(item.est_us,
                                           min_cost * item.steps))
                if disp_us > 3.0 * item.est_us:
                    per_step = disp_us / item.steps
                else:
                    per_step = min(disp_us / item.steps, prev_ema)
            else:
                busy_us = max(item.est_us, min_cost * item.steps)
                if learn_scale is not None:
                    per_step = item.est_us * learn_scale / item.steps
            region.busy_add(t.index, int(busy_us))
            if item.metered:
                charged = max(busy_us, min_cost * item.steps)
                region.rate_adjust(
                    t.index, int(min(charged, item.est_us * 4.0)
                                 - item.est_us))
            if per_step is not None:
                t.cost_ema[item.key] = (prev_ema * 0.7
                                        + min(per_step, prev_ema * 4.0) * 0.3)
            t.executions += item.steps
        self._retire_many([item for item, _, _, _ in batch])

    def stop(self):
        self._stop = True
        self.kick()


class ChipState:
    """One card: its accounting region (the device axis is the card's
    tenant slots), its stream, its dispatcher and metering threads, and
    its empty-event round trip."""

    def __init__(self, state: "RuntimeState", index: int,
                 device: torch.device, region_path: str):
        self.index = index
        self.device = device
        self.region = SharedRegion(
            region_path, limits=[state.default_hbm] * MAX_TENANTS,
            core_pcts=[state.default_core] * MAX_TENANTS)
        self.region.set_work_conserving(state.work_conserving)
        self.region.register()
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self.latency_us = self.calibrate_latency_us()
        log.info("card %d (%s): empty event round trip %.0f us", index,
                 device, self.latency_us)
        self.scheduler = DeviceScheduler(state, self)

    @contextlib.contextmanager
    def context(self):
        """This card's device and stream, for the calling thread."""
        if self.stream is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            yield

    def record(self) -> Optional[torch.cuda.Event]:
        """An event after everything queued on the card so far (None on
        the CPU, whose calls complete before they return)."""
        if self.stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev

    def calibrate_latency_us(self) -> float:
        """The least completion latency of an empty event: the constant
        the metering subtracts from a cold item's dispatch-to-complete
        window."""
        if self.stream is None:
            return 0.0
        samples = []
        with self.context():
            for _ in range(4):
                t0 = time.monotonic()
                self.record().synchronize()
                samples.append((time.monotonic() - t0) * 1e6)
        return min(samples[1:])


class RuntimeState:
    """Shared across sessions: the cards, the tenants, the program
    cache."""

    def __init__(self, region_path: str, hbm_limit: int, core_limit: int,
                 min_exec_cost_us: int = 0,
                 work_conserving: Optional[bool] = None,
                 device: str = "cuda"):
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"device {device!r} requested but no CUDA "
                                   "card is available (pass device='cpu' to "
                                   "run on the CPU)")
            self.devices = ([dev] if dev.index is not None else
                            [torch.device("cuda", i)
                             for i in range(torch.cuda.device_count())])
        elif dev.type == "cpu":
            self.devices = [dev]
        else:
            raise ValueError(f"unsupported device {device!r}")
        if work_conserving is None:
            work_conserving = os.environ.get(
                "VTPU_WORK_CONSERVING", "1") != "0"
        self.work_conserving = work_conserving
        self.epoch = f"{os.getpid():x}-{time.time_ns():x}"
        self.region_path = region_path
        # Spawn-time limits are defaults: each HELLO carries its grant.
        self.default_hbm = hbm_limit
        self.default_core = core_limit
        self.min_exec_cost_us = min_exec_cost_us
        self.tenants: Dict[str, Tenant] = {}
        # Admin-suspended tenant names: their queues stop dispatching.
        self.suspended: set = set()
        self.blob_cache: "collections.OrderedDict[tuple, Program]" = \
            collections.OrderedDict()
        self.pool_stats: Dict[str, int] = {}
        self.mu = threading.Lock()
        self.chips: Dict[int, ChipState] = {}
        self.chips_mu = threading.Lock()
        self.chip(0)  # fail fast if the card is gone

    def chip_region_path(self, index: int) -> str:
        return self.region_path if index == 0 \
            else f"{self.region_path}.chip{index}"

    def chip(self, index: int) -> ChipState:
        """The ChipState of a card index, made on first use."""
        if not 0 <= index < len(self.devices):
            raise ValueError(f"INVALID_DEVICE: card {index} not on this node "
                             f"({len(self.devices)} devices)")
        c = self.chips.get(index)
        if c is not None:
            return c
        with self.chips_mu:
            c = self.chips.get(index)
            if c is None:
                c = ChipState(self, index, self.devices[index],
                              self.chip_region_path(index))
                self.chips[index] = c
            return c

    def tenant(self, name: str, priority: int, oversubscribe: bool = False,
               device: int = 0, hbm_limit: Optional[int] = None,
               core_limit: Optional[int] = None) -> Tuple[Tenant, bool]:
        """Bind a connection to a tenant; (tenant, created).  A new
        tenant's slot is reset and seeded with its grant (the first
        HELLO's wins for the tenant's life)."""
        chip = self.chip(device)
        created = False
        with self.mu:
            t = self.tenants.get(name)
            if t is not None and t.chip is not chip:
                raise ValueError(f"INVALID_DEVICE: tenant {name!r} is bound "
                                 f"to card {t.chip.index}")
            if t is None:
                used = {x.index for x in self.tenants.values()
                        if x.chip is chip}
                index = next((i for i in range(MAX_TENANTS)
                              if i not in used), None)
                if index is None:
                    raise SlotsExhausted(
                        f"tenant slots exhausted on card {chip.index}")
                t = Tenant(name, index, priority, oversubscribe, chip)
                chip.region.reset_slot(index)
                chip.region.set_mem_limit(
                    index, hbm_limit if hbm_limit is not None
                    else self.default_hbm)
                chip.region.set_core_limit(
                    index, core_limit if core_limit is not None
                    else self.default_core)
                self.tenants[name] = t
                created = True
            t.connections += 1
        return t, created

    def release_tenant(self, t: Tenant) -> bool:
        """Drop one connection; True when the last one is gone and the
        tenant's state is to be torn down (its slot recycles)."""
        with self.mu:
            t.connections -= 1
            if t.connections > 0:
                return False
        # Meter everything dispatched before the slot can recycle: a
        # late retirement would bill the slot's next tenant.
        t.chip.scheduler.quiesce(t.name)
        with self.mu:
            if t.connections > 0 or self.tenants.get(t.name) is not t:
                return False  # a reconnect took it over meanwhile
            self.tenants.pop(t.name, None)
            t.chip.scheduler.forget_tenant(t.name)
            self.suspended.discard(t.name)
        return True

    def cached_blob(self, blob: bytes, chip: ChipState) -> Program:
        """The program of a blob on a card, loaded once for every tenant
        that sends the same bytes."""
        key = (hashlib.sha256(blob).hexdigest(), chip.index)
        with self.mu:
            prog = self.blob_cache.get(key)
            if prog is not None:
                self.blob_cache.move_to_end(key)
                return prog
        prog = load_program(blob, chip.device)
        with self.mu:
            self.blob_cache[key] = prog
            while len(self.blob_cache) > BLOB_CACHE_CAP:
                self.blob_cache.popitem(last=False)
        return prog

    def stop(self) -> None:
        for chip in list(self.chips.values()):
            chip.scheduler.stop()


# -- sessions ------------------------------------------------------------------

def _stats_reply(state: RuntimeState) -> Dict[str, Any]:
    return {"ok": True, "tenants": collect_stats(state),
            "pool": dict(state.pool_stats)}


def _disabled_reply() -> Dict[str, Any]:
    """TRACE and SLO: ``vtpu``'s answer with tracing and the SLO plane
    off."""
    return {"ok": True, "enabled": False, "tenants": {}}


class TenantSession(socketserver.BaseRequestHandler):
    state: RuntimeState  # set by make_server

    def setup(self):
        self.send_mu = threading.Lock()
        self.pending = 0
        self.pending_cond = threading.Condition()
        self._staging: Dict[str, List[bytes]] = {}
        self._staging_bytes = 0
        self._pool = P.RecvPool(stats=self.state.pool_stats)

    def _send(self, msg) -> None:
        with self.send_mu:
            P.send_msg(self.request, msg)

    def _send_err(self, code: str, msg: str) -> None:
        self._send({"ok": False, "code": code, "error": msg})

    def _drain(self) -> None:
        """Wait until every queued execute of this connection is
        answered, so a synchronous reply keeps FIFO order."""
        with self.pending_cond:
            while self.pending > 0:
                self.pending_cond.wait(timeout=0.5)

    def abandon(self, item: WorkItem) -> None:
        """A purged item of this dead connection: release its reply
        slot."""
        if item.batch is not None:
            item.batch.fill(item.batch_idx, {"ok": False, "code": "PURGED",
                                             "error": "connection closed"})
        with self.pending_cond:
            self.pending -= 1
            self.pending_cond.notify_all()

    def handle(self):
        tenant_box: List[Optional[Tenant]] = [None]
        try:
            self._serve(self.request, tenant_box)
        finally:
            # Teardown runs however the session died.
            t = tenant_box[0]
            if t is not None:
                t.chip.scheduler.purge_session(self)
            self._drain()
            if t is not None and self.state.release_tenant(t):
                self._cleanup(t)

    def _hello(self, msg, tenant_box) -> None:
        devs = msg.get("devices")
        if devs and len(devs) > 1:
            self._send_err("INVALID_DEVICE", "a tenant holds one card here; "
                           "grants over several cards are not ported yet")
            return
        hbm = msg.get("hbm_limit")
        core = msg.get("core_limit")
        try:
            tenant, created = self.state.tenant(
                str(msg["tenant"]), int(msg.get("priority", 1)),
                bool(msg.get("oversubscribe", False)),
                device=int(devs[0] if devs else msg.get("device", 0)),
                hbm_limit=int(hbm) if hbm is not None else None,
                core_limit=int(core) if core is not None else None)
        except SlotsExhausted as e:
            self._send({"ok": False, "code": "OVERLOAD", "error": str(e),
                        "retry_ms": 200})
            return
        tenant_box[0] = tenant
        self._send({"ok": True, "tenant_index": tenant.index,
                    "chip": tenant.chip.index, "chips": [tenant.chip.index],
                    "epoch": self.state.epoch, "created": created,
                    "resumed": False})

    def _serve(self, sock, tenant_box):  # noqa: C901 - protocol dispatch
        while True:
            try:
                msg = P.recv_msg(sock)
            except (ConnectionError, P.ProtocolError):
                break
            kind = msg.get("kind")
            tenant = tenant_box[0]
            try:
                if kind == P.HELLO:
                    if tenant is not None:
                        self._drain()
                        self._send_err(
                            "ALREADY_BOUND",
                            f"connection already bound to tenant "
                            f"{tenant.name!r}; open a new connection")
                    else:
                        self._hello(msg, tenant_box)
                    continue
                if kind == P.STATS and tenant is None:
                    self._send(_stats_reply(self.state))
                    continue
                if kind in (P.TRACE, P.SLO):
                    if tenant is not None:
                        self._drain()
                    self._send(_disabled_reply())
                    continue
                if tenant is None:
                    self._send_err("NO_HELLO", "hello required")
                    continue
                if kind == P.EXECUTE:
                    self._enqueue_execute(tenant, msg)
                    continue
                if kind == P.EXEC_BATCH:
                    self._enqueue_batch(tenant, msg)
                    continue
                self._drain()
                if kind == P.PUT_PART:
                    self._put_part(tenant, msg)
                elif kind == P.PUT:
                    self._put(sock, tenant, msg)
                elif kind == P.GET:
                    self._get(sock, tenant, msg)
                elif kind == P.DELETE:
                    ids = msg.get("ids")
                    if ids is None:
                        ids = [msg["id"]]
                    with tenant.mu:
                        freed = sum(tenant.drop_array(str(a)) for a in ids)
                    self._send({"ok": True, "freed": freed})
                elif kind == P.COMPILE:
                    prog = self.state.cached_blob(bytes(msg["exported"]),
                                                  tenant.chip)
                    tenant.executables[str(msg["id"])] = prog
                    self._send({"ok": True})
                elif kind == P.STATS:
                    tenant.chip.scheduler.quiesce(tenant.name)
                    self._send(_stats_reply(self.state))
                elif kind in _DEFERRED:
                    self._send_err("UNIMPLEMENTED",
                                   deferred(f"{kind}", _DEFERRED[kind]))
                else:
                    self._send_err("BAD_KIND", str(kind))
            except MemoryError as e:
                self._send_err("RESOURCE_EXHAUSTED", str(e))
            except InvalidProgram as e:
                self._send_err("INVALID_ARGUMENT", str(e))
            except Exception as e:  # noqa: BLE001 - the session survives
                log.warn("tenant %s request failed: %s",
                         tenant.name if tenant else "?", e)
                self._send_err("INTERNAL", f"{type(e).__name__}: {e}")

    # -- data --

    def _put_part(self, tenant: Tenant, msg) -> None:
        aid = str(msg["id"])
        part = msg["data"]
        st = tenant.chip.region.device_stats(tenant.index)
        cap = max(4 << 30, 2 * int(st.limit_bytes))
        if self._staging_bytes + len(part) > cap:
            parts = self._staging.pop(aid, [])
            self._staging_bytes -= sum(len(p) for p in parts)
            raise MemoryError(f"RESOURCE_EXHAUSTED: staged upload exceeds "
                              f"{cap} bytes")
        self._staging.setdefault(aid, []).append(part)
        self._staging_bytes += len(part)
        self._send({"ok": True, "staged_bytes": self._staging_bytes})

    def _put(self, sock, tenant: Tenant, msg) -> None:
        raw_parts = int(msg.get("raw_parts", 0) or 0)
        pool_buf = None
        if raw_parts:
            want = int(msg["nbytes"])
            if want > raw_parts * P.CHUNK_BYTES:
                raise P.ProtocolError(f"raw PUT {want} bytes in {raw_parts} "
                                      f"part(s) exceeds CHUNK_BYTES framing")
            pool_buf = self._pool.take(want)
            mv = memoryview(pool_buf)
            got = 0
            for _ in range(raw_parts):
                got += P.recv_raw_into(sock, mv[got:want])
            if got != want:
                raise P.ProtocolError(f"raw PUT: announced {want} bytes, "
                                      f"received {got}")
            buf = mv[:want]
        elif msg.get("staged"):
            parts = self._staging.pop(str(msg["id"]), [])
            self._staging_bytes -= sum(len(p) for p in parts)
            buf = b"".join(parts)
        else:
            buf = msg["data"]
        host = tensor_from_bytes(buf, msg["dtype"], msg["shape"])
        if pool_buf is not None:
            self._pool.give(pool_buf)   # host owns a copy
        nbytes = host.numel() * host.element_size()
        aid = str(msg["id"])
        chip = tenant.chip
        with tenant.mu:
            # Replacement semantics: the old copy goes before the quota
            # check, so an exact-fit re-PUT succeeds.
            tenant.drop_array(aid)
            if not tenant.charge_array(nbytes):
                free, total = chip.region.mem_info(tenant.index)
                raise MemoryError(
                    f"RESOURCE_EXHAUSTED: tenant {tenant.name} over HBM "
                    f"quota: requested {nbytes}, quota {total} (free {free})")
        try:
            with chip.context():
                dev = host.to(chip.device)
        except BaseException:
            tenant.release_array(nbytes)
            raise
        with tenant.mu:
            tenant.arrays[aid] = dev
            tenant.nbytes[aid] = nbytes
        self._send({"ok": True, "nbytes": nbytes, "spilled": False})

    def _get(self, sock, tenant: Tenant, msg) -> None:
        aid = str(msg["id"])
        with tenant.mu:
            dev = tenant.arrays.get(aid)
        if dev is None:
            self._send_err("NOT_FOUND", aid)
            return
        # Copied on the card's stream: ordered after every item queued
        # before it.
        with tenant.chip.context():
            host = dev.to("cpu")
        flat = tensor_bytes(host)
        nbytes = len(flat)
        hdr = {"ok": True, "shape": list(host.shape),
               "dtype": dtype_name(host.dtype), "nbytes": nbytes}
        if msg.get("raw"):
            hdr["raw_parts"] = P.raw_part_count(nbytes)
            with self.send_mu:
                P.send_frames(sock, [P.frame_header(hdr)]
                              + P.raw_frames(flat))
        elif nbytes > P.CHUNK_BYTES:
            n = -(-nbytes // P.CHUNK_BYTES)
            self._send({"ok": True, "shape": hdr["shape"],
                        "dtype": hdr["dtype"], "parts": n})
            for off in range(0, nbytes, P.CHUNK_BYTES):
                self._send({"data": bytes(flat[off:off + P.CHUNK_BYTES])})
        else:
            self._send({"ok": True, "shape": hdr["shape"],
                        "dtype": hdr["dtype"], "data": bytes(flat)})

    # -- the execute path --

    def _build_item(self, t: Tenant, spec) -> WorkItem:
        """One execute body ({exe, args, outs, repeats?, carry?, free?})
        as a WorkItem; raises _ItemError with the typed code."""
        prog = t.executables.get(str(spec["exe"]))
        if prog is None:
            raise _ItemError("NOT_FOUND", str(spec["exe"]))
        if spec.get("feeds"):
            raise _ItemError("FEED_UNAVAILABLE", deferred(
                "arena feeds", _DEFERRED[P.FASTBIND]))
        steps = int(spec.get("repeats", 1))
        carry = tuple(tuple(int(x) for x in pair)
                      for pair in spec.get("carry", ((0, 0),)))
        n_args = len(spec["args"])
        if steps > 1:
            bad = [p for p in carry
                   if len(p) != 2 or not 0 <= p[0] < prog.n_outs
                   or not 0 <= p[1] < n_args]
            if bad:
                raise _ItemError("BAD_CARRY", f"invalid carry map {bad}")
        return WorkItem(t, self, prog, str(spec["exe"]),
                        [str(a) for a in spec["args"]],
                        [str(x) for x in spec.get("outs", [])],
                        steps=steps, carry=carry,
                        free_ids=[str(f) for f in spec.get("free", ())])

    def _reserve_pending(self, n: int) -> None:
        with self.pending_cond:
            while self.pending and self.pending + n > MAX_PENDING_REPLIES:
                self.pending_cond.wait(timeout=0.5)
            self.pending += n

    def _enqueue_execute(self, t: Tenant, msg) -> None:
        try:
            item = self._build_item(t, msg)
        except _ItemError as e:
            self._drain()
            self._send_err(e.code, e.msg)
            return
        self._reserve_pending(1)
        t.chip.scheduler.submit(item)

    def _enqueue_batch(self, t: Tenant, msg) -> None:
        specs = msg.get("items")
        if not isinstance(specs, list) or not specs:
            self._drain()
            self._send_err("BAD_BATCH", "items must be a non-empty list")
            return
        batch = _BatchReply(len(specs))
        items: List[WorkItem] = []
        prefail: List[Tuple[int, dict]] = []
        for i, spec in enumerate(specs):
            try:
                item = self._build_item(t, spec)
            except _ItemError as e:
                prefail.append((i, {"ok": False, "code": e.code,
                                    "error": e.msg}))
                continue
            except (KeyError, TypeError, ValueError) as e:
                prefail.append((i, {"ok": False, "code": "BAD_ITEM",
                                    "error": f"{type(e).__name__}: {e}"}))
                continue
            item.batch = batch
            item.batch_idx = i
            items.append(item)
        self._reserve_pending(len(specs))
        done = False
        for i, res in prefail:
            done = batch.fill(i, res)
            with self.pending_cond:
                self.pending -= 1
                self.pending_cond.notify_all()
        if items:
            t.chip.scheduler.submit_many(items)
        elif done:
            self._drain()
            try:
                self._send({"ok": True, "results": batch.results})
            except OSError:
                pass

    @staticmethod
    def _exec_result(metas, exc, actual_us: float) -> dict:
        if exc is None:
            return {"ok": True, "outs": metas, "device_time_us": actual_us}
        msg = str(exc)
        if isinstance(exc, MemoryError) or "RESOURCE_EXHAUSTED" in msg:
            return {"ok": False, "code": "RESOURCE_EXHAUSTED", "error": msg}
        if isinstance(exc, KeyError) and "NOT_FOUND" in msg:
            return {"ok": False, "code": "NOT_FOUND",
                    "error": msg.strip("'")}
        return {"ok": False, "code": "INTERNAL",
                "error": f"{type(exc).__name__}: {exc}"}

    def complete_execute(self, item: WorkItem, metas, exc,
                         actual_us: float) -> None:
        """Called by the dispatcher in dispatch order: the reply, or the
        item's EXEC_BATCH slot (the filler of the last one sends)."""
        res = self._exec_result(metas, exc, actual_us)
        try:
            if item.batch is not None:
                if item.batch.fill(item.batch_idx, res):
                    self._send({"ok": True, "results": item.batch.results})
            else:
                self._send(res)
        except OSError:
            pass  # the client went away; teardown follows
        finally:
            with self.pending_cond:
                self.pending -= 1
                self.pending_cond.notify_all()

    def _cleanup(self, t: Tenant):
        with t.mu:
            for aid in list(t.arrays):
                t.drop_array(aid)
        t.executables.clear()


def collect_stats(state: RuntimeState) -> Dict[str, Dict[str, Any]]:
    """Each tenant's row: ``vtpu``'s keys for what this core has, and
    ``busy_us``, the device time metered to the tenant's slot."""
    out = {}
    with state.mu:
        tenants = list(state.tenants.items())
    for name, t in tenants:
        st = t.chip.region.device_stats(t.index)
        out[name] = {
            "index": t.index,
            "chip": t.chip.index,
            "chips": [t.chip.index],
            "used_bytes": int(st.used_bytes),
            "limit_bytes": int(st.limit_bytes),
            "peak_bytes": int(st.peak_bytes),
            "per_chip": [{"chip": t.chip.index,
                          "used_bytes": int(st.used_bytes),
                          "limit_bytes": int(st.limit_bytes),
                          "peak_bytes": int(st.peak_bytes)}],
            "core_limit_pct": int(st.core_limit_pct),
            "arrays": len(t.arrays),
            # No host spill in this core: an oversubscribed tenant's
            # arrays stay on the card.
            "host_spill_bytes": 0,
            "staged_resident_bytes": 0,
            "suspended": name in state.suspended,
            "executions": t.executions,
            "cost_ema_us": {k: round(float(v), 1)
                            for k, v in t.cost_ema.items()},
            "busy_us": int(st.busy_us),
        }
    return out


class AdminSession(socketserver.BaseRequestHandler):
    """The host-side admin socket (``<socket>.admin``, never mounted into
    a container): STATS, SUSPEND, RESUME, SHUTDOWN, with TRACE and SLO
    disabled; the broker's uid and root only."""

    state: RuntimeState  # set by make_server

    @staticmethod
    def _allowed_uids() -> set:
        return {0, os.getuid()}

    def _peer_authorized(self) -> bool:
        try:
            creds = self.request.getsockopt(socket.SOL_SOCKET,
                                            socket.SO_PEERCRED,
                                            struct.calcsize("3i"))
            _pid, uid, _gid = struct.unpack("3i", creds)
        except OSError:
            return False
        return uid in self._allowed_uids()

    def handle(self):
        if not self._peer_authorized():
            log.warn("admin: refusing unauthorized peer")
            try:
                P.reply_err(self.request, "PERMISSION_DENIED",
                            "admin socket is owner/root only")
            except OSError:
                pass
            return
        while True:
            try:
                msg = P.recv_msg(self.request)
            except (ConnectionError, P.ProtocolError):
                return
            kind = msg.get("kind")
            try:
                if kind in (P.SUSPEND, P.RESUME):
                    name = str(msg["tenant"])
                    with self.state.mu:
                        known = name in self.state.tenants
                        if kind == P.SUSPEND:
                            self.state.suspended.add(name)
                        else:
                            self.state.suspended.discard(name)
                    with self.state.chips_mu:
                        chips = list(self.state.chips.values())
                    for chip in chips:
                        chip.scheduler.kick()
                    log.info("admin: %s tenant %r (known=%s)", kind, name,
                             known)
                    P.send_msg(self.request, {"ok": True, "known": known})
                elif kind == P.STATS:
                    with self.state.mu:
                        suspended = sorted(self.state.suspended)
                    rep = _stats_reply(self.state)
                    rep["suspended"] = suspended
                    P.send_msg(self.request, rep)
                elif kind in (P.TRACE, P.SLO):
                    P.send_msg(self.request, _disabled_reply())
                elif kind == P.SHUTDOWN:
                    P.send_msg(self.request, {"ok": True})
                    cb = getattr(self.state, "shutdown_cb", None)
                    if cb is not None:
                        threading.Thread(target=cb, daemon=True).start()
                    return
                elif kind in _DEFERRED:
                    P.reply_err(self.request, "UNIMPLEMENTED",
                                deferred(f"{kind}", _DEFERRED[kind]))
                else:
                    P.reply_err(self.request, "BAD_KIND", str(kind))
            except Exception as e:  # noqa: BLE001 - the admin survives
                P.reply_err(self.request, "INTERNAL",
                            f"{type(e).__name__}: {e}")


class _Server(socketserver.ThreadingUnixStreamServer):
    daemon_threads = True
    allow_reuse_address = True
    admin_server: "Optional[_Server]" = None

    def shutdown(self):
        if self.admin_server is not None:
            self.admin_server.shutdown()
        super().shutdown()

    def server_close(self):
        if self.admin_server is not None:
            self.admin_server.server_close()
        st = getattr(self, "state", None)
        if st is not None:
            st.stop()
        super().server_close()


def refuse_deferred_env(env=os.environ) -> None:
    """Raise for an environment that asks for a module not ported yet."""
    if env.get("VTPU_JOURNAL_DIR"):
        raise RuntimeError(deferred("VTPU_JOURNAL_DIR (crash recovery)",
                                    "6(b), the journal and handover"))
    if env.get("VTPU_TRACE", "0") not in ("", "0"):
        raise RuntimeError(deferred("VTPU_TRACE (the flight recorder)",
                                    "6(b), tracing"))


def make_server(socket_path: str, hbm_limit: int, core_limit: int,
                region_path: Optional[str] = None,
                min_exec_cost_us: int = 0,
                work_conserving: Optional[bool] = None,
                device: str = "cuda") -> _Server:
    """The tenant socket at ``socket_path`` and the admin socket beside
    it, not yet serving (call ``serve_forever``).  ``device`` is "cuda"
    (every card; raises when there is none), "cuda:<i>" or "cpu"."""
    refuse_deferred_env()
    if os.path.exists(socket_path):
        os.unlink(socket_path)
    os.makedirs(os.path.dirname(socket_path) or ".", exist_ok=True)
    # The regions are the broker's own state: a stale file would keep the
    # old limits (a region seeds them on creation only).
    rpath = region_path or socket_path + ".shr"
    for stale in [rpath] + glob.glob(rpath + ".chip*"):
        if os.path.exists(stale):
            os.unlink(stale)
    state = RuntimeState(rpath, hbm_limit, core_limit, min_exec_cost_us,
                         work_conserving, device=device)
    handler = type("BoundSession", (TenantSession,), {"state": state})
    srv = _Server(socket_path, handler)
    srv.state = state  # type: ignore[attr-defined]
    admin_path = socket_path + ".admin"
    if os.path.exists(admin_path):
        os.unlink(admin_path)
    admin_handler = type("BoundAdmin", (AdminSession,), {"state": state})
    admin = _Server(admin_path, admin_handler)
    os.chmod(admin_path, 0o700)
    srv.admin_server = admin
    state.shutdown_cb = srv.shutdown  # type: ignore[attr-defined]
    threading.Thread(target=admin.serve_forever, daemon=True,
                     kwargs={"poll_interval": 0.1},
                     name="vtpu-rt-admin").start()
    return srv


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="vtpu-runtime")
    p.add_argument("--socket", default=os.environ.get(
        envspec.ENV_RUNTIME_SOCKET, "/usr/local/vtpu/vtpu-runtime.sock"))
    p.add_argument("--hbm-limit", default=os.environ.get(
        envspec.ENV_HBM_LIMIT, "0"),
        help="per-tenant HBM quota (K8s quantity; 0 = unlimited)")
    p.add_argument("--core-limit", type=int, default=int(os.environ.get(
        envspec.ENV_CORE_LIMIT, "0")),
        help="per-tenant device-time %% (0 = unlimited)")
    p.add_argument("--min-exec-cost-us", type=int, default=int(
        os.environ.get(envspec.ENV_MIN_EXEC_COST, "0")))
    p.add_argument("--work-conserving", type=int, choices=(0, 1),
                   default=None,
                   help="redistribute idle tenants' core share to active "
                        "ones (default on; also VTPU_WORK_CONSERVING)")
    p.add_argument("--region", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (every card), cuda:<i>, or cpu")
    p.add_argument("--cluster", default=None,
                   help="refused: " + deferred("the federation",
                                               "6(d), the cluster"))
    ns = p.parse_args(argv)
    if ns.cluster:
        p.error("--cluster " + deferred("the federation", "6(d), the cluster"))
    hbm = envspec.parse_quantity(ns.hbm_limit) if ns.hbm_limit != "0" else 0
    srv = make_server(ns.socket, hbm, ns.core_limit, ns.region,
                      ns.min_exec_cost_us,
                      work_conserving=(None if ns.work_conserving is None
                                       else bool(ns.work_conserving)),
                      device=ns.device)
    log.info("vtpu-runtime serving on %s (hbm=%d core=%d%%, %s)", ns.socket,
             hbm, ns.core_limit, ns.device)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
