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
  execute that reads it; the dispatcher records one event after each
  batch it dispatches (one per item while ``VTPU_TRACE=1``, for the
  spans' device phase), and the metering thread waits on the last one,
  on its own thread only.
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
  exits the process with ``DEVICE_FAULT_EXIT`` (the daemon restarts
  brokers).  With a journal the successor recovers every tenant.
- **A GET waits for its array's own dispatch batch** (``_Ready``), not
  for everything queued on the card after it, so a tenant that fetches
  each chain's output keeps the next chain queued behind it.

Scheduling is ``vtpu``'s: per-tenant queues, a dispatcher that
round-robins over tenants and gates each item on its tenant's token
bucket in the card's region (priority 0 borrows), at most
``MAX_INFLIGHT`` items in flight per tenant, and the metering rule
``busy = min(t_obs - prev_obs, t_obs - t0 - L)``.  The tenant's slot in
the card's region carries its HELLO grant (HBM cap, core share).

Durability (``vtpu``'s, ported whole): with ``VTPU_JOURNAL_DIR`` (or
``journal_dir``) every state change is journaled before its ack
(``runtime/journal.py``): HELLO's binding, a PUT's payload and record,
a COMPILE's graph, drops (deferred under ``Tenant.mu`` and flushed
before the reply, an output that replaces a PUT id among them), a
tenant's close, the metering thread's cost-EMA samples, the card's
calibration and each boot's epoch.  An execute's outputs are not
journaled, in ``vtpu`` either: after a restart a tenant gets back its
PUT arrays, programs, ledger and cost model, and re-sends what its
executes carried.  A successor replays the journal before its socket
binds, re-seeds each tenant's slot with its grant and ledger (forced
admits, so quotas hold from the first instant), and parks it for
``VTPU_RESUME_GRACE_S``; the client's HELLO with ``resume_epoch``
adopts it, and its arrays are copied back to the card on the card's
stream and its graphs vetted and loaded again.  A graph read back from
the broker's own directory is vetted like one off the wire.  DRAIN
refuses new HELLOs and snapshots; HANDOVER then exits for the successor;
RESIZE changes a live tenant's grant and is journaled before its ack.
TRACE answers from the flight recorder (``VTPU_TRACE=1``,
``runtime/trace.py``); ``VTPU_FAULTS`` plants faults at the verbs as they
are read, at ``dispatch`` and at ``reply`` (``runtime/faults.py``); a
claim of the cards that hangs past ``VTPU_CLAIM_WATCHDOG_S`` exits 3
with a ``wedge`` record naming the lease holder.

**A tenant's indices are bounded** (``bound_indices``): on CUDA an index
op checks its indices with a device-side assert, which would end the
broker for every tenant, so ``load_program`` rewrites each index op to
XLA's rules, which ``vtpu`` serves (a gather clamps, a scatter drops).
The socket's dispatcher and the fastlane's drainer run the same bounded
program.

**Rate leases** (``VTPU_RATE_LEASE_US``): one bucket acquire pre-debits a
quantum that the dispatcher's later admissions burn; an execute reply
carries it, SUSPEND, RESIZE, DRAIN and teardown give it back.

**The fastlane** (``runtime/fastlane.py``): a client that asks in HELLO
gets a ring and two shared-memory arenas; its unchained executes ride the
ring to the card's drainer, PUT and GET of a tensor that fits move through
the arenas, and an execute's host batches ride as arena feeds.  The
drainer queues on the card's stream beside the dispatcher
(``ChipState.launch_mu`` keeps each batch's launches together) and each
batch is billed its device time from CUDA events.  SUSPEND parks the
ring's gate, DRAIN and HANDOVER park every gate while dispatch pauses,
RESIZE parks it for a pass, teardown and a second connection close it.

**The SLO plane** (``runtime/slo.py``, on unless ``VTPU_SLO=0``): the
metering threads feed each retired item's queue, bucket and device phases
and the co-tenants' device time during its wait (the blame substrate,
``DeviceScheduler.slo_busy``); HELLO seeds the tenant's objective
(``slo_target_us``/``slo_floor_steps``), RESIZE re-derives a default one,
teardown forgets the row, and the journal carries periodic ``slo`` records
and the snapshot's rows, so a successor resumes attainment history.  With
tracing off a batch's device window is split among its items by what
billing charged each (``slo.split_batch_window``).  The bind-free ``SLO``
verb answers a tenant connection with its own row and the admin socket
with every row, the blame matrix and the fairness report.

**Hot standby** (``runtime/replication.py``): a journaled broker streams
its journal to standbys over the admin socket (REPL_SYNC); a standby that
takes over fences this broker's epoch and starts through ``make_server``
seeded with the state it already applied (``preloaded_state``): no
journal re-read, no replay.

Not here yet, each refused with the ROADMAP item that holds it: migration
and the federation (MIGRATE, MIGRATE_OUT, MIGRATE_IN, ``--cluster``;
6(d)(ii)).  Also left out of this core: burst credits, preemption,
overload shedding, host spill of an oversubscribed tenant, PUT dedup and
grants over several cards.

Lock order: ``slo.mu`` (the plane's) is a strict leaf, taken with no
broker lock held, and the plane never calls out.

Run: python -m vtpu_torch.runtime.server --socket /tmp/rt.sock \\
        --hbm-limit 8Gi --core-limit 50 [--journal-dir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import glob
import hashlib
import json
import math
import operator
import os
import queue
import re
import socket
import socketserver
import struct
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..ops import flash_attention as _fa  # noqa: F401 - registers K1's op
from ..shim.core import SharedRegion
from ..utils import envspec
from ..utils import logging as log
from ..utils.dtypes import (dtype_name, tensor_bytes, tensor_from_bytes,
                            torch_dtype)
from . import fastlane as fastlane_mod
from . import faults
from . import protocol as P
from . import replication as repl_mod
from . import slo as slo_mod
from . import timers as timers_mod
from . import trace as tracing
from .journal import Journal, JournalCorrupt

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
# One scheduler quantum (µs): the ceiling on a rate lease, so a tenant never
# holds more pre-debited device time than this.
SCHED_QUANTUM_US = 100_000
# Rate leases: one token-bucket acquire funds a quantum of this many µs,
# which later dispatches burn with plain arithmetic (0: one acquire per
# item).  The fastlane's client burns leases of the same size.
RATE_LEASE_US = min(int(os.environ.get("VTPU_RATE_LEASE_US", "20000") or 0),
                    SCHED_QUANTUM_US)

# The sub-items of ROADMAP.md Queue 1 item 6 that hold what this broker
# refuses.
_DEFERRED = {
    P.MIGRATE: "6(d)(ii), migration and the federation",
    P.MIGRATE_OUT: "6(d)(ii), migration and the federation",
    P.MIGRATE_IN: "6(d)(ii), migration and the federation",
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


# -- bounding a tenant's indices -----------------------------------------------
# On CUDA the index ops on the list check their indices (bernoulli its
# probabilities) with a device-side assert, which leaves the card's context
# unusable and so ends the broker for every tenant.  The indices are the
# tenant's data, which COMPILE cannot see, so ``bound_indices`` rewrites
# each such op before the graph runs, with ops on the list only, to XLA's
# rules, which ``vtpu`` serves: a gather clamps its indices (``index``
# first wraps [-n, 0), as ``x[i]`` does), a scatter drops its
# out-of-range updates (``x.at[i].set/add``), ``one_hot`` gives a row of
# zeros (``jax.nn.one_hot``), and bernoulli's probabilities clamp into
# [0, 1] with NaN as 0 (``uniform < p``).  In-range indices give the same
# bits as before.  A non-empty gather from a dim of size 0 has nothing to
# clamp to, and a scatter into a 0-d tensor no dim to pad: both are
# refused at COMPILE.

_A = torch.ops.aten
# Overloads whose operands cannot be bounded: repeat_interleave with a
# tensor of repeats asserts on the card when the repeats do not sum to
# the output size the graph fixed.
_REFUSED_OVERLOADS = frozenset({("repeat_interleave", "Tensor"),
                                ("repeat_interleave", "self_Tensor")})


def _args(node) -> Dict[str, Any]:
    """A call's arguments by schema name, defaults filled in."""
    out = {}
    for i, a in enumerate(node.target._schema.arguments):
        if i < len(node.args) and not a.kwarg_only:
            out[a.name] = node.args[i]
        elif a.name in node.kwargs:
            out[a.name] = node.kwargs[a.name]
        elif a.has_default_value():
            out[a.name] = a.default_value
    return out


def _set_arg(node, name: str, value) -> None:
    for i, a in enumerate(node.target._schema.arguments):
        if a.name != name:
            continue
        if i < len(node.args) and not a.kwarg_only:
            args = list(node.args)
            args[i] = value
            node.args = tuple(args)
        else:
            node.kwargs = {**node.kwargs, name: value}
        return


def _shape(v) -> Tuple[int, ...]:
    return tuple(int(x) for x in v.meta["val"].shape)


class _Bounder:
    """Inserts the bounding nodes of one call before it.  Each new node
    carries its fake value (``meta["val"]``), so a bounded op may read the
    output of another."""

    def __init__(self, graph):
        self.g = graph

    def op(self, target, *args):
        node = self.g.call_function(target, tuple(args))
        node.meta["val"] = target(*torch.fx.node.map_arg(
            args, lambda a: a.meta["val"]))
        return node

    @staticmethod
    def size(n: int, idx, what: str) -> int:
        """``n``, the size of the dim ``idx`` indexes: a non-empty index
        into an empty dim has nothing to clamp to, and is refused."""
        if n == 0 and math.prod(_shape(idx)):
            raise InvalidProgram(f"{what} indexes a dim of size 0 with a "
                                 "non-empty index")
        return n

    def in_range(self, idx, n: int):
        return self.op(_A.logical_and.default,
                       self.op(_A.ge.Scalar, idx, 0),
                       self.op(_A.lt.Scalar, idx, n))

    def wrap(self, idx, n: int):
        """[-n, 0) -> [0, n), as Python indexing reads a negative."""
        return self.op(_A.where.self, self.op(_A.lt.Scalar, idx, 0),
                       self.op(_A.add.Tensor, idx, n), idx)

    def clamp(self, idx, n: int):
        return self.op(_A.clamp.default, idx, 0, n - 1) if n else idx

    def pad(self, x, ndim: int, dims):
        """``x`` with one zero slot appended on each of ``dims``."""
        pad = []
        for d in reversed(range(ndim)):
            pad += [0, 1 if d in dims else 0]
        return self.op(_A.constant_pad_nd.default, x, pad)

    def cut(self, x, sizes: Dict[int, int]):
        for d, n in sizes.items():
            x = self.op(_A.slice.Tensor, x, d, 0, n)
        return x


def _replace_output(graph, node, build) -> None:
    """Route ``node``'s users to ``build(node)``, built right after it."""
    with graph.inserting_before(node.next):
        new = build(node)
    node.replace_all_uses_with(new, delete_user_cb=lambda u: u is not new
                               and not _feeds(u, new))


def _feeds(user, new) -> bool:
    """Whether ``user`` is one of the nodes between ``node`` and ``new``
    that ``build`` made (they must keep reading ``node``)."""
    seen, stack = set(), [new]
    while stack:
        n = stack.pop()
        if n is user:
            return True
        if n in seen:
            continue
        seen.add(n)
        stack.extend(a for a in n.all_input_nodes)
    return False


def _scatter_into_pad(graph, node, b: _Bounder, target, dims: Dict[int, int],
                      set_indices) -> None:
    """Drop a scatter's out-of-range updates: ``target`` gets one slot
    padded on each of ``dims`` (dim -> size), ``set_indices()`` (run
    before ``node``) sends those updates there, and the slot is cut off
    ``node``'s output.  A 0-d target has no dim to pad: refused (its
    one element is what ``where`` would write)."""
    if not _shape(target):
        raise InvalidProgram(f"{node.target} into a 0-d tensor")
    with graph.inserting_before(node):
        set_indices()
        padded = b.pad(target, len(_shape(target)), set(dims))
        _set_arg(node, "self", padded)
    node.meta["val"] = padded.meta["val"]
    _replace_output(graph, node, lambda x: b.cut(x, dims))


def _bound_call(graph, node) -> bool:
    """Bound one call's index operands; False when it needs none."""
    name = node.target._schema.name.split("::")[-1]
    overload = node.target._overloadname
    a = _args(node)
    b = _Bounder(graph)
    if name in ("gather", "index_select"):
        src, idx = a["self"], a["index"]
        shape = _shape(src)
        n = b.size(shape[a["dim"] % len(shape)] if shape else 1, idx, name)
        with graph.inserting_before(node):
            _set_arg(node, "index", b.clamp(idx, n))
        return bool(n)
    if name == "embedding":
        n = b.size(_shape(a["weight"])[0], a["indices"], name)
        with graph.inserting_before(node):
            _set_arg(node, "indices", b.clamp(a["indices"], n))
        return bool(n)
    if name == "take_along_dim":
        shape = _shape(a["self"])
        dim = a.get("dim")
        n = b.size(math.prod(shape) if dim is None
                   else shape[dim % len(shape)] if shape else 1,
                   a["indices"], name)
        with graph.inserting_before(node):
            _set_arg(node, "indices", b.clamp(a["indices"], n))
        return bool(n)
    if name == "index":
        shape = _shape(a["self"])
        new = []
        with graph.inserting_before(node):
            for d, idx in _index_dims(a["indices"]):
                if d is None:
                    new.append(idx)
                    continue
                n = b.size(shape[d], idx, name)
                new.append(b.clamp(b.wrap(idx, n), n) if n else idx)
            _set_arg(node, "indices", new)
        return True
    if name == "index_put":
        _bound_index_put(graph, node, a, b)
        return True
    if name in ("scatter", "scatter_add"):
        shape = _shape(a["self"])
        dim = a["dim"] % max(len(shape), 1)
        n = shape[dim] if shape else 1
        idx = a["index"]

        def send():
            ok = b.in_range(idx, n)
            _set_arg(node, "index", b.op(_A.where.ScalarOther, ok, idx, n))
        _scatter_into_pad(graph, node, b, a["self"], {dim: n}, send)
        return True
    if name == "one_hot":
        x, n = a["self"], int(a["num_classes"])
        if n <= 0:
            return False
        with graph.inserting_before(node):
            ok = b.in_range(x, n)
            _set_arg(node, "self", b.op(_A.where.ScalarOther, ok, x, 0))
        _replace_output(graph, node, lambda y: b.op(
            _A.mul.Tensor, y, b.op(_A.unsqueeze.default, ok, -1)))
        return True
    if name == "bernoulli":
        key = "p" if overload == "Tensor" else (
            "self" if overload in ("", "default") else None)
        if key is None:
            return False    # a float p is checked on the host
        with graph.inserting_before(node):
            p = b.op(_A.nan_to_num.default, a[key], 0.0)
            _set_arg(node, key, b.op(_A.clamp.default, p, 0.0, 1.0))
        return True
    return False


def _index_dims(indices):
    """(the dim an integer index reads, or None for a mask or a None
    entry; the entry) for each entry of an ``index`` or ``index_put``
    list: a bool or uint8 mask of k dims covers k dims."""
    d = 0
    for idx in indices:
        if idx is None:
            yield None, idx
            d += 1
        elif idx.meta["val"].dtype in (torch.bool, torch.uint8):
            yield None, idx
            d += idx.meta["val"].dim()
        else:
            yield d, idx
            d += 1


def _bound_index_put(graph, node, a, b: _Bounder) -> None:
    """Out-of-range updates, with or without accumulate, go to a slot
    padded onto each integer-indexed dim and cut off."""
    shape = _shape(a["self"])
    found = [(k, d, idx) for k, (d, idx) in enumerate(_index_dims(
        a["indices"])) if d is not None]
    if not found:
        return

    def send():
        ws = [b.wrap(idx, shape[d]) for _k, d, idx in found]
        ok = None
        for (_k, d, _i), w in zip(found, ws):
            o = b.in_range(w, shape[d])
            ok = o if ok is None else b.op(_A.logical_and.default, ok, o)
        new = list(a["indices"])
        for (k, d, _i), w in zip(found, ws):
            new[k] = b.op(_A.where.ScalarOther, ok, w, shape[d])
        _set_arg(node, "indices", new)
    _scatter_into_pad(graph, node, b, a["self"],
                      {d: shape[d] for _k, d, _i in found}, send)


def bound_indices(gm) -> int:
    """Rewrite the index ops of a loaded program's graph so that no
    operand a tenant sends can trip a device-side assert (the comment
    above); returns how many calls were bounded.  Raises InvalidProgram
    for an overload that cannot be bounded."""
    graph = gm.graph
    n = 0
    for node in list(graph.nodes):
        if node.op != "call_function" \
                or not isinstance(node.target, torch._ops.OpOverload):
            continue
        name = node.target._schema.name.split("::")[-1]
        if (name, node.target._overloadname) in _REFUSED_OVERLOADS:
            raise InvalidProgram(f"op {node.target} is not one a program "
                                 "may call (its bounds check is a "
                                 "device-side assert on the tenant's data)")
        if name in _BOUNDED_OPS and _bound_call(graph, node):
            n += 1
    if n:
        graph.lint()
        gm.recompile()
    return n


_BOUNDED_OPS = frozenset({"gather", "index_select", "embedding",
                          "take_along_dim", "index", "index_put",
                          "scatter", "scatter_add", "one_hot", "bernoulli"})


_LOAD_MU = threading.Lock()


def load_program(blob: bytes, device: torch.device) -> "Program":
    """A program from a vetted graph, moved to ``device``."""
    from torch._export.serde.serialize import SerializedArtifact, deserialize
    from torch.export.passes import move_to_device_pass

    graph = _vet_graph(blob)
    try:
        # torch's deserializer keeps its state in a module global: two
        # sessions loading at once would trip over each other.
        with _LOAD_MU:
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
    fn = ep.module()
    # The same bounded module serves the socket's dispatcher and the
    # fastlane's drainer.
    bound_indices(fn)
    return Program(fn, in_meta, out_meta, hashlib.sha256(blob).hexdigest())


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

    def run(self, args: List[torch.Tensor], steps: int, carry,
            step_args=None) -> List[torch.Tensor]:
        """``steps`` calls, each step's mapped outputs fed back into the
        next step's arguments (K-1 carried calls and one plain call whose
        outputs all return); nothing synchronises with the device.
        ``step_args`` (arena feeds) maps argument positions to each step's
        tensor, the last entry serving the steps past the list.  Every
        output owns a storage of its own size: one that is a view of an
        argument, of another output or of a larger tensor is copied, or
        it would hold memory its ledger entry does not charge."""
        cur = list(args)
        for s in range(steps):
            # Checked whenever an argument is new: the first step, the
            # first carried one and each step an arena feed replaces.
            fresh = s <= 1
            if step_args:
                for pos, v in step_args[min(s, len(step_args) - 1)].items():
                    cur[pos] = v
                fresh = fresh or s < len(step_args)
            if fresh:
                self._check(cur, "arguments")
            outs = self._call(cur)
            if s < steps - 1:
                for oi, ai in carry:
                    cur[ai] = outs[oi]
        seen = {a.untyped_storage().data_ptr() for a in args}
        for i, o in enumerate(outs):
            st = o.untyped_storage()
            if o.numel() and (st.data_ptr() in seen or
                              st.nbytes() != o.numel() * o.element_size()):
                outs[i] = o = o.clone(memory_format=torch.contiguous_format)
            seen.add(o.untyped_storage().data_ptr())
        return outs

    def _check(self, args, what: str) -> None:
        """The graph's inputs, exactly: count, shapes, dtypes."""
        if len(args) != len(self.in_meta) or any(
                tuple(a.shape) != shape or a.dtype != dtype
                for a, (shape, dtype) in zip(args, self.in_meta)):
            raise ValueError(
                f"{what} {[(list(a.shape), dtype_name(a.dtype)) for a in args]}"
                f" do not match the program's inputs "
                f"{[(list(s), dtype_name(d)) for s, d in self.in_meta]}")

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
        # Output id -> the _Ready of the dispatch batch that made it.
        self.ready: Dict[str, "_Ready"] = {}
        # The journal's view (runtime/journal.py): each PUT array's blob
        # record, each program's blob sha, the drop records deferred
        # under self.mu (flush_tenant_journal sends them before the
        # reply), the grant and the client's identity for recovery, and
        # whether the tenant is parked after a restart for its client.
        self.blob_meta: Dict[str, dict] = {}
        self.exe_shas: Dict[str, str] = {}
        self.pending_journal: List[dict] = []
        self.grant: Optional[dict] = None
        self.client_pid: Optional[int] = None
        self.client_pidns: Optional[int] = None
        self.recovered = False
        # Bumped by every drop: a fastlane route swaps its outputs' tensors
        # only while the table is as it left it.
        self.arrays_ver = 0
        # The fastlane (runtime/fastlane.py): the lane, None on the socket
        # path, and the ring's depth at the last drain.
        self.fastlane = None
        self.fastlane_depth = 0
        # The rate lease: device time pre-debited from the bucket and burnt
        # by the dispatcher, guarded by the card's scheduler.mu (a reply
        # reads it unlocked: the client's copy is a hint).
        self.lease_us = 0.0
        self.lease_exp = 0.0
        self.lease_revoked = False
        self.lease_grants = 0

    def lease_release(self) -> None:
        """Refund the unburnt lease (expiry, suspend, resize, drain,
        teardown).  Caller holds the card's scheduler.mu or owns the
        tenant."""
        left = int(self.lease_us)
        self.lease_us = 0.0
        self.lease_exp = 0.0
        if left > 0:
            self.chip.region.rate_adjust(self.index, -left)

    def charge_array(self, nbytes: int) -> bool:
        """Admit ``nbytes`` against the slot's cap; False (nothing
        charged) when it refuses."""
        return self.chip.region.mem_acquire(self.index, nbytes,
                                            self.oversubscribe)

    def release_array(self, nbytes: int) -> None:
        self.chip.region.mem_release(self.index, nbytes)

    def drop_array(self, aid: str) -> int:
        """Free one array and its charge; returns its bytes.  Caller
        holds self.mu.  A journaled array's ``del`` record waits in
        pending_journal (no file I/O under self.mu) for the caller's
        flush_tenant_journal."""
        self.ready.pop(aid, None)
        if self.arrays.pop(aid, None) is None:
            return 0
        self.arrays_ver += 1
        nbytes = self.nbytes.pop(aid, 0)
        self.release_array(nbytes)
        if self.blob_meta.pop(aid, None) is not None:
            self.pending_journal.append({"op": "del", "name": self.name,
                                         "id": aid})
        return nbytes

    def metered_on(self, now: float) -> bool:
        """Whether the slot has a compute share, cached for 0.5 s."""
        v = self._metered_cache
        if v is None or now >= v[1]:
            pct = self.chip.region.device_stats(self.index).core_limit_pct
            v = (pct > 0, now + 0.5)
            self._metered_cache = v
        return v[0]


def flush_tenant_journal(state: "RuntimeState", t: Tenant) -> None:
    """Append the records a ``t.mu``-guarded section deferred.  Callers
    run it after releasing ``t.mu`` and BEFORE the reply that
    acknowledges the change, so once the client sees ok the journal has
    it.  A failing append is logged, not raised: these are drops, and
    their callers sit on the dispatcher and teardown paths, where an
    escaped OSError would stall every tenant; the journal has already
    truncated back to a clean boundary."""
    jr = state.journal
    with t.mu:
        recs, t.pending_journal = t.pending_journal, []
    if jr is not None:
        for rec in recs:
            try:
                jr.append(rec)
            except OSError as e:
                log.error("journal: dropping deferred %r record for %s "
                          "(%s)", rec.get("op"), t.name, e)


class _Ready:
    """The completion of one dispatch batch on its card: filled with the
    event recorded after the batch.  A GET of an output waits for its
    own batch, not for work queued on the card after it."""

    __slots__ = ("filled", "event")

    def __init__(self):
        self.filled = threading.Event()
        self.event: Optional[torch.cuda.Event] = None

    def fill(self, event) -> None:
        self.event = event
        self.filled.set()

    def wait(self) -> None:
        self.filled.wait()
        if self.event is not None:
            self.event.synchronize()


class WorkItem:
    """One queued EXECUTE: argument ids resolve at dispatch, so a
    pipelined step may name an earlier step's output.  ``t_enq`` (its
    submit), ``t_bucket0`` (its first wait on the token bucket at the
    queue's head), ``bucket_wait_us`` and the client's trace stamp
    (``trace_id``, ``trace_ts``) feed its span and its SLO row;
    ``slo_busy0`` is the card's per-slot device time at its enqueue (the
    blame window's start)."""

    __slots__ = ("tenant", "session", "exe", "key", "arg_ids", "out_ids",
                 "steps", "carry", "metered", "est_us", "first_run",
                 "free_ids", "feeds", "batch", "batch_idx", "t_enq",
                 "t_enq_wall", "t_bucket0", "bucket_wait_us", "trace_id",
                 "trace_ts", "slo_busy0")

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
        # Arena feeds: (id, argpos, offset, nbytes, shape, dtype) of host
        # batches in the tenant's tx arena, copied out at dispatch.
        self.feeds: tuple = ()
        self.batch: "Optional[_BatchReply]" = None
        self.batch_idx = 0
        self.t_enq = 0.0
        self.t_enq_wall = 0.0
        self.t_bucket0: Optional[float] = None
        self.bucket_wait_us = 0.0
        self.trace_id: Optional[str] = None
        self.trace_ts: Optional[float] = None
        self.slo_busy0: Optional[tuple] = None


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
        # The SLO plane's blame substrate: device time metered to each
        # tenant slot of this card, and the slot's tenant.  Written by the
        # metering thread only; read unlocked at enqueue (a torn read
        # skews one request's blame split, never enforcement).
        self.slo_busy = [0.0] * MAX_TENANTS
        self.slo_names: List[Optional[str]] = [None] * MAX_TENANTS
        # Items that failed before the card, for the plane: the dispatcher
        # appends, the metering thread folds them in.
        self._slo_errors: collections.deque = collections.deque()
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
        now_m, now_w = time.monotonic(), time.time()
        # One snapshot per submit: the blame window opens at the enqueue.
        snap = tuple(self.slo_busy) if self.state.slo.enabled else None
        with self.mu:
            for item in items:
                item.t_enq = now_m
                item.t_enq_wall = now_w
                item.slo_busy0 = snap
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

    def quiesce_all(self, timeout: float = 30.0) -> bool:
        """Drain for a handover: wait until every dispatched item has
        retired (the drain has paused dispatch, so a tenant that keeps
        sending cannot hold it off).  True when idle."""
        deadline = time.monotonic() + max(timeout, 0.0)
        with self.mu:
            while any(self.inflight.values()):
                if time.monotonic() >= deadline:
                    return False
                self.mu.wait(timeout=0.1)
        return True

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
                flush_tenant_journal(self.state, it.tenant)
        return len(purged)

    # -- dispatch --

    def _pick_locked(self):
        """Next dispatchable item by round robin over eligible tenants,
        and the soonest time a throttled one becomes ready."""
        now = time.monotonic()
        soonest = None
        if self.state.dispatch_paused:
            return None, None
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
                wait_ns = self._lease_admit_locked(t, est, now)
                if wait_ns:
                    # The item now waits on the bucket, not the queue:
                    # its bucket phase starts (the first throttle wins).
                    if item.t_bucket0 is None:
                        item.t_bucket0 = now
                    nr = now + wait_ns / 1e9
                    self.not_ready_until[name] = nr
                    soonest = nr if soonest is None else min(soonest, nr)
                    continue
            q.popleft()
            if item.t_bucket0 is not None:
                item.bucket_wait_us = max(now - item.t_bucket0, 0.0) * 1e6
            item.metered = metered
            item.est_us = est
            item.first_run = (item.steps, item.carry) not in item.exe.warmed
            self.inflight[name] = self.inflight.get(name, 0) + 1
            self.queued_est_us += est
            self._rr_pos = (idx + 1) % n
            return item, soonest
        return None, soonest

    def _lease_admit_locked(self, t: Tenant, est: float, now: float) -> int:
        """Admit ``est`` µs for one item; the nanoseconds to wait (0:
        admitted).  With leases on, most admissions burn the lease: one
        acquire pre-debits a quantum from the same bucket the co-tenants
        read.  Priority 0 borrows instead of waiting (vtpu_core.h).  Caller
        holds self.mu."""
        region = self.chip.region
        q = float(self.state.rate_lease_us)
        if q <= 0:
            return region.rate_acquire(t.index, int(est), t.priority)
        if t.lease_us > 0.0 and now >= t.lease_exp:
            # Expired: an idle tenant's pre-debit flows back.
            t.lease_release()
        if t.lease_us >= est:
            t.lease_us -= est
            return 0
        if region.rate_acquire(t.index, int(est + q), t.priority) == 0:
            t.lease_us += q
            t.lease_exp = now + self.state.rate_lease_ttl_s
            t.lease_grants += 1
            return 0
        # The bucket cannot fund a quantum: the exact ask, less what the
        # lease holds, so a throttled tenant pays nothing for the lease.
        need = max(est - t.lease_us, 1.0)
        wait_ns = region.rate_acquire(t.index, int(need), t.priority)
        if wait_ns == 0:
            t.lease_us = 0.0
        return wait_ns

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
            ready = _Ready()
            with self.chip.launch_mu, self.chip.context():
                try:
                    for item in items:
                        r = self._dispatch_item(item, ready)
                        if r is not None:
                            done.append(r)
                finally:
                    # One event after the batch (None on the CPU): what
                    # the metering waits on and a GET of its outputs.
                    event = self.chip.record()
                    ready.fill(event)
            if done:
                if done[-1][3] is None:
                    done[-1] = done[-1][:3] + (event,)
                self._completion_q.put(done)

    def _dispatch_item(self, item: WorkItem, ready: _Ready):
        """Resolve the arguments, admit the outputs, queue the program on
        the card's stream, register the outputs and reply; returns
        (item, t0, outputs, event) for the metering thread, the event
        the item's own while tracing (None otherwise: the dispatch loop
        records one after the batch), or None when the item failed
        before reaching the device."""
        faults.fire("dispatch")
        t = item.tenant
        t0 = time.monotonic()
        metas = []
        need = sum(m["nbytes"] for m in item.exe.out_meta)
        admitted = False
        try:
            fed = self._feeds(item) if item.feeds else []
            with t.mu:
                for fid in item.free_ids:
                    t.drop_array(fid)
                step_args = None
                if fed and item.steps == 1:
                    # An unchained feed binds under its id, replacing it,
                    # and is charged like the PUT it stands for.
                    for (fid, ap, _o, nb, _s, _d), a in zip(item.feeds, fed):
                        t.drop_array(fid)
                        if not t.charge_array(nb):
                            raise MemoryError(
                                f"RESOURCE_EXHAUSTED: feed of {nb} bytes "
                                f"over tenant {t.name}'s HBM quota")
                        t.arrays[fid] = a
                        t.nbytes[fid] = nb
                elif fed:
                    step_args = [{f[1]: a} for f, a in zip(item.feeds, fed)]
                args = []
                for aid in item.arg_ids:
                    a = t.arrays.get(aid)
                    if a is None:
                        raise KeyError(f"NOT_FOUND: {aid}")
                    args.append(a)
                if step_args:
                    for pos, a in step_args[0].items():
                        args[pos] = a
            if not t.charge_array(need):
                free, total = self.chip.region.mem_info(t.index)
                raise MemoryError(
                    f"RESOURCE_EXHAUSTED: tenant {t.name} over HBM quota: "
                    f"outputs of {need} bytes, quota {total} (free {free})")
            admitted = True
            with torch.inference_mode():
                outs = item.exe.run(args, item.steps, item.carry, step_args)
            event = (self.chip.record(timing=True)
                     if self.state.flight.enabled else None)
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
                    t.ready[oid] = ready
                    metas.append({"id": oid, "shape": m["shape"],
                                  "dtype": m["dtype"]})
        except Exception as e:  # noqa: BLE001 - reply with the error
            if admitted:
                t.release_array(need)
            if item.metered:
                self.chip.region.rate_adjust(t.index, -int(item.est_us))
            flush_tenant_journal(self.state, t)
            item.session.complete_execute(item, metas, e, 0.0)
            now = time.monotonic()
            err = f"{type(e).__name__}: {e}"
            self._record_span(item, t0, now, 0.0, error=err)
            if self.state.slo.enabled:
                self._slo_errors.append((item, t0, now))
            self._retire_many((item,))
            return None
        # The drops above (freed ids, an output replacing a PUT id) are
        # journaled before the reply.
        flush_tenant_journal(self.state, t)
        item.exe.warmed.add((item.steps, item.carry))
        item.session.complete_execute(item, metas, None, item.est_us)
        return (item, t0, outs, event)

    def _feeds(self, item: WorkItem) -> List[torch.Tensor]:
        """An item's arena feeds on its card: copied out of the tx arena
        now (the client reuses the region once the reply lands), then to
        the card on its stream without waiting for the stream."""
        lane = item.tenant.fastlane
        tx = lane.tx_view() if lane is not None else None
        if tx is None:
            raise KeyError("NOT_FOUND: feed arena (the fastlane lane is "
                           "gone)")
        return [to_card(tensor_from_bytes(bytearray(tx[off:off + nb]), dt,
                                          shape), self.chip)
                for _fid, _ap, off, nb, shape, dt in item.feeds]

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
            if self._slo_errors:
                self._slo_record_errors()
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
        journal = self.state.journal
        traced = self.state.flight.enabled
        ema_recs = []
        busys = []
        for item, t0, _outs, ev in batch:
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
            busys.append(busy_us)
            if item.metered:
                region.rate_adjust(t.index, int(fastlane_mod.bill_us(
                    busy_us, item.est_us, item.steps, min_cost)
                    - item.est_us))
            if per_step is not None:
                t.cost_ema[item.key] = (prev_ema * 0.7
                                        + min(per_step, prev_ema * 4.0) * 0.3)
            t.executions += item.steps
            if per_step is not None and journal is not None:
                # Learned samples are journaled (one write per batch) so
                # a successor recovers the cost model.
                ema_recs.append({"op": "ema", "name": t.name,
                                 "key": item.key,
                                 "ema": t.cost_ema[item.key],
                                 "execs": t.executions})
        if traced or self.state.slo.enabled:
            self._retire_phases(batch, busys, event, t_obs, traced)
        if ema_recs:
            try:
                journal.append_many(ema_recs)
            except OSError as e:
                # A cache of learned state: losing a batch costs the
                # successor one sample; raising would stop the metering.
                log.warn("journal: dropping %d EMA sample(s) (%s)",
                         len(ema_recs), e)
        self._retire_many([item for item, _, _, _ in batch])

    # -- the SLO plane (runtime/slo.py) and tracing (runtime/trace.py) --

    def _retire_phases(self, batch, busys, event, t_obs: float,
                       traced: bool) -> None:
        """Each retired item's ready time and phases, into the SLO plane
        and, while tracing, a span.  Tracing gives each item its own
        event, read against the batch's last; otherwise the batch's window
        from its first dispatch to ``t_obs`` is split among its items by
        what billing charged each (``slo.split_batch_window``)."""
        plane = self.state.slo
        if traced:
            readies = []
            for _item, _t0, _outs, ev in batch:
                t_ready = t_obs
                if ev is not None and ev is not event:
                    t_ready -= max(ev.elapsed_time(event), 0.0) / 1e3
                readies.append(t_ready)
        else:
            readies = slo_mod.split_batch_window(batch[0][1], t_obs, busys)
        stage: Dict[str, list] = {}
        if plane.enabled:
            # This thread is the only writer of the blame substrate.
            for (item, _t0, _outs, _ev), busy_us in zip(batch, busys):
                t = item.tenant
                self.slo_busy[t.index] += busy_us
                self.slo_names[t.index] = t.name
        solo = len(batch) == 1
        for (item, t0, _outs, _ev), busy_us, t_ready in zip(batch, busys,
                                                            readies):
            if plane.enabled:
                ph = slo_mod.item_phases(item.t_enq, t0, t_ready,
                                         item.bucket_wait_us)
                if item.trace_id is None:
                    rows = stage.get(item.tenant.name)
                    if rows is None:
                        rows = stage[item.tenant.name] = []
                    rows.extend(slo_mod.stage_row(*ph, item.steps))
                else:
                    # A traced request's id becomes an exemplar: the
                    # exact path.
                    self._slo_record(item, ph, ok=True)
            if traced:
                self._record_span(item, t0, t_ready, busy_us, solo=solo)
        if stage:
            # The batch's blame denominators, once: co-tenants' device
            # time since the batch head's enqueue (each victim's own entry
            # is left out at ingest).
            plane.stage_batch(stage,
                              self._slo_weights(batch[0][0].slo_busy0),
                              sum(len(r) for r in stage.values()) // 4)

    def _slo_weights(self, base: Optional[tuple],
                     exclude: Optional[str] = None
                     ) -> Optional[Dict[str, float]]:
        """Device time each co-tenant slot gained since ``base``."""
        if base is None:
            return None
        weights: Optional[Dict[str, float]] = None
        for i, name in enumerate(self.slo_names):
            if name is None or name == exclude:
                continue
            d = self.slo_busy[i] - (base[i] if i < len(base) else 0.0)
            if d > 0.0:
                if weights is None:
                    weights = {}
                weights[name] = d
        return weights

    def _slo_record(self, item: WorkItem, ph, ok: bool) -> None:
        queue_us, bucket_us, device_us, total_us = ph
        self.state.slo.record(
            item.tenant.name, queue_us=queue_us, bucket_us=bucket_us,
            device_us=device_us, total_us=total_us, steps=item.steps,
            ok=ok, wait_weights=self._slo_weights(item.slo_busy0,
                                                  item.tenant.name),
            trace_id=item.trace_id, wall_ts=item.t_enq_wall)

    def _slo_record_errors(self) -> None:
        """Items that failed before the card, each a violation, folded in
        on the metering thread like every other feed of the plane."""
        while self._slo_errors:
            item, t_disp, t_err = self._slo_errors.popleft()
            self._slo_record(item, slo_mod.item_phases(
                item.t_enq, t_disp, t_err, item.bucket_wait_us), ok=False)

    def _record_span(self, item: WorkItem, t_disp: float, t_ready: float,
                     busy_us: float, error: Optional[str] = None,
                     solo: bool = True) -> None:
        """A flight-recorder span of one retired item, with tracing on.
        Its phases are wall-clock deltas that partition the item's time
        in the broker (queue + bucket + device == total by
        construction, ``slo.item_phases``); the metered ``busy_us`` rides
        along as the billing view."""
        fl = self.state.flight
        if not fl.enabled:
            return
        t = item.tenant
        queue_us, bucket_us, device_us, total_us = slo_mod.item_phases(
            item.t_enq, t_disp, t_ready, item.bucket_wait_us)
        span: Dict[str, Any] = {
            "ts": item.t_enq_wall,
            "tenant": t.name, "chip": self.chip.index,
            "key": item.key, "steps": item.steps,
            "queue_us": round(queue_us, 1),
            "bucket_us": round(bucket_us, 1),
            "device_us": round(device_us, 1),
            "total_us": round(total_us, 1),
            "busy_us": round(busy_us, 1),
            "est_us": round(item.est_us, 1),
        }
        if item.trace_id:
            span["trace"] = item.trace_id
        if item.trace_ts:
            # The client's send time: transport and session lag before
            # the enqueue (the broker's phases start at the enqueue).
            span["client_lag_us"] = round(
                max(item.t_enq_wall - float(item.trace_ts), 0.0) * 1e6, 1)
        if item.first_run:
            span["first_run"] = True
        if error is not None:
            span["error"] = error[:200]
        # Slow-op eligibility (vtpu's rule): a first run holds program
        # load, an error never reached the card, and an item of a
        # multi-item batch shares the batch's observation.
        est = 0.0 if (item.first_run or error is not None or not solo) \
            else item.est_us
        fl.record(t.name, span, est_us=est,
                  context_fn=lambda: self._slow_context(item))

    def _slow_context(self, item: WorkItem) -> Dict[str, Any]:
        """A slow-op capture's context: queue depth, bucket level, HBM
        headroom, co-tenants.  Locks one at a time (scheduler.mu, then
        the region, then state.mu)."""
        t = item.tenant
        with self.mu:
            qdepth = len(self.queues.get(t.name, ()))
            inflight = dict(self.inflight)
            queued_est = self.queued_est_us
        st = self.chip.region.device_stats(t.index)
        with self.state.mu:
            co = sorted(n for n, x in self.state.tenants.items()
                        if x.chip is self.chip and n != t.name)
            suspended = t.name in self.state.suspended
        return {
            "queue_depth": qdepth,
            "inflight": inflight,
            "chip_queued_est_us": round(queued_est, 1),
            "bucket_level_us": int(self.chip.region.rate_level(t.index)),
            "hbm_used_bytes": int(st.used_bytes),
            "hbm_limit_bytes": int(st.limit_bytes),
            "hbm_headroom_bytes": max(
                int(st.limit_bytes) - int(st.used_bytes), 0)
            if st.limit_bytes else -1,
            "core_limit_pct": int(st.core_limit_pct),
            "co_tenants": co,
            "suspended": suspended,
            "cost_ema_us": round(float(t.cost_ema.get(item.key, 0.0)), 1),
        }

    def stop(self):
        self._stop = True
        self.kick()


def to_card(host: torch.Tensor, chip: "ChipState") -> torch.Tensor:
    """A host tensor copied to ``chip`` on the caller's stream (the card's,
    in ``chip.context()``) from pinned memory, so the copy does not wait
    for the work queued before it; the caching host allocator keeps the
    pinned buffer until the copy has run."""
    if chip.stream is None:
        return host.to(chip.device)
    return host.pin_memory().to(chip.device, non_blocking=True)


def _my_pidns() -> int:
    try:
        return os.stat("/proc/self/ns/pid").st_ino
    except OSError:
        return 0


def wedge_report(stage: str, journal: Optional[Journal] = None) -> str:
    """The claim watchdog's dying words: which claim stage hung and who
    holds the node's cards, from the lease sidecar; journaled as a
    ``wedge`` record, which the successor reports at recovery."""
    diag = tracing.diagnose_lease(exclude_pid=os.getpid())
    msg = tracing.format_lease_diagnosis(diag)
    if journal is not None:
        try:
            journal.append({"op": "wedge", "stage": stage,
                            "ts": time.time(), "diagnosis": msg})
        except Exception as e:  # noqa: BLE001 - dying words, best effort
            log.warn("cannot journal wedge record: %s", e)
    return msg


def claim_watchdog(stage: str, journal: Optional[Journal] = None):
    """Arm a deadline around a claim of the cards; returns cancel().

    ``torch.cuda.init()`` and a card's first context can block with no
    error (a wedged driver, an MPS server that does not answer).  A
    broker stuck there never binds its socket, or serves HELLOs whose
    dispatch never runs; exiting 3 lets the daemon restart it.  The log
    names the lease holder and a ``wedge`` record makes the restart
    attributable.  ``VTPU_CLAIM_WATCHDOG_S`` bounds the step (default
    180 s; 0 disables)."""
    deadline = float(os.environ.get("VTPU_CLAIM_WATCHDOG_S", "180"))
    done = threading.Event()
    if deadline <= 0:
        return done.set

    def _fire():
        if not done.wait(deadline):
            log.error("%s wedged for %.0fs; %s; exiting for the daemon to "
                      "restart the broker", stage, deadline,
                      wedge_report(stage, journal))
            os._exit(DEVICE_FAULT_EXIT)

    threading.Thread(target=_fire, daemon=True,
                     name="vtpu-claim-watchdog").start()
    return done.set


class ChipState:
    """One card: its accounting region (the device axis is the card's
    tenant slots), its stream, its dispatcher and metering threads, and
    its empty-event round trip (the journal's, after a restart)."""

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
        # Held while a dispatch batch or a fastlane batch queues its
        # launches, so each batch's events bracket its own work.
        self.launch_mu = threading.Lock()
        # GETs of execute outputs copy here, beside the card's stream.
        self.side = (torch.cuda.Stream(device) if device.type == "cuda"
                     else None)
        hint = state.chip_latency_hints.get(index)
        if hint is not None:
            self.latency_us = float(hint)
            log.info("card %d (%s): empty event round trip %.0f us, "
                     "from the journal", index, device, self.latency_us)
        else:
            self.latency_us = self.calibrate_latency_us()
            log.info("card %d (%s): empty event round trip %.0f us", index,
                     device, self.latency_us)
        if state.journal is not None and self.latency_us:
            state.journal.append({"op": "chip", "index": index,
                                  "lat_us": self.latency_us})
        self.scheduler = DeviceScheduler(state, self)

    @contextlib.contextmanager
    def context(self):
        """This card's device and stream, for the calling thread."""
        if self.stream is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            yield

    def record(self, timing: bool = False) -> Optional[torch.cuda.Event]:
        """An event after everything queued on the card so far (None on
        the CPU, whose calls complete before they return); ``timing``
        for one whose distance to another is read."""
        if self.stream is None:
            return None
        ev = torch.cuda.Event(enable_timing=timing)
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
    cache, the journal and what it recovered, the flight recorder, the
    SLO plane and the replication hub.  ``preloaded_state`` is a
    standby's already-applied journal state: recovery starts from it
    instead of reading the journal."""

    def __init__(self, region_path: str, hbm_limit: int, core_limit: int,
                 min_exec_cost_us: int = 0,
                 work_conserving: Optional[bool] = None,
                 device: str = "cuda", journal: Optional[Journal] = None,
                 preloaded_state: Optional[dict] = None):
        self.journal = journal
        self.prev_epoch: Optional[str] = None
        # name -> (Tenant, resume deadline): tenants recovered from the
        # journal and parked until their client's resume HELLO.
        self.recovered: Dict[str, Tuple[Tenant, float]] = {}
        self.resume_grace = float(os.environ.get("VTPU_RESUME_GRACE_S",
                                                 "120"))
        self.recovery = {
            "recoveries_total": 0,
            "tenants_recovered": 0,
            "tenants_readopted": 0,
            "tenants_dropped_dead": 0,
            "tenants_dropped_expired": 0,
            "tenants_dropped_replaced": 0,
            "arrays_dropped": 0,
            "corrupt_recoveries": 0,
            "resume_s_last": 0.0,
            # The last resume's split: arrays back on the card, programs
            # vetted and loaded.
            "restore_s_last": 0.0,
            "load_s_last": 0.0,
        }
        self.chip_latency_hints: Dict[int, float] = {}
        self.draining = False
        # Set by a drain while it waits for dispatched work and
        # snapshots: the dispatchers take nothing from the queues.
        self.dispatch_paused = False
        self._keeper_stop = threading.Event()
        # The one timer thread of the keepers (make_server installs it).
        self.timers: Optional[timers_mod.TimerWheel] = None
        self.flight = tracing.FlightRecorder()
        # The SLO plane, on unless VTPU_SLO=0 (runtime/slo.py).
        self.slo = slo_mod.SloPlane()
        # The standbys following this broker's journal (REPL_SYNC); one
        # None check per append until one subscribes.
        self.replication = repl_mod.ReplicationHub(self)
        # The previous instance's claim-watchdog record, if any.
        self.last_wedge: Optional[dict] = None
        self._journal_state = None
        if journal is not None and preloaded_state is not None:
            # A standby's takeover: it applied the stream already.
            self._journal_state = preloaded_state
        elif journal is not None:
            try:
                self._journal_state = journal.load_state()
            except JournalCorrupt as e:
                # Fail closed: no guessed quota state; clients get the
                # typed VtpuStateLost of a fresh epoch.
                log.error("journal corrupt (%s); quarantining and booting "
                          "a fresh epoch", e)
                journal.quarantine()
                self.recovery["corrupt_recoveries"] += 1
        if self._journal_state is not None:
            st = self._journal_state
            self.prev_epoch = st.get("epoch")
            self.recovery["recoveries_total"] = int(
                st.get("recoveries_total", 0))
            for k, v in (st.get("chips") or {}).items():
                try:
                    if v:
                        self.chip_latency_hints[int(k)] = float(v)
                except (TypeError, ValueError):
                    pass
            self.last_wedge = st.get("last_wedge")
            if self.last_wedge:
                log.warn("the previous broker wedged at %r and exited: %s",
                         self.last_wedge.get("stage"),
                         self.last_wedge.get("diagnosis"))
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"device {device!r} requested but no CUDA "
                                   "card is available (pass device='cpu' to "
                                   "run on the CPU)")
        # The claim: announce this process as the cards' holder before
        # touching the driver, so a co-claimer's watchdog (and ours) can
        # name the other.
        tracing.write_lease_sidecar("cuda init (torch.cuda.init)")
        if dev.type == "cuda":
            cancel = claim_watchdog("cuda init (torch.cuda.init)", journal)
            try:
                torch.cuda.init()
                self.devices = ([dev] if dev.index is not None else
                                [torch.device("cuda", i)
                                 for i in range(torch.cuda.device_count())])
            finally:
                cancel()
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
        # The rate lease's quantum (µs; 0: one bucket acquire per item) and
        # the wall time after which an unburnt lease refunds.
        self.rate_lease_us = RATE_LEASE_US
        self.rate_lease_ttl_s = max(4.0 * RATE_LEASE_US / 1e6, 0.05)
        # The fastlane's lanes, drainers and meters (runtime/fastlane.py).
        self.fastlane = fastlane_mod.FastlaneHub(self)
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
        tracing.write_lease_sidecar("held (broker serving)",
                                    extra={"epoch": self.epoch})
        if journal is not None:
            self._recover_from_journal()
            # The epoch record goes out before the boot snapshot, so a
            # crash during the compaction still replays the new epoch.
            journal.append({"op": "epoch", "epoch": self.epoch})
            journal.write_snapshot(self._snapshot_dict)

    def chip_region_path(self, index: int) -> str:
        return self.region_path if index == 0 \
            else f"{self.region_path}.chip{index}"

    def chip(self, index: int) -> ChipState:
        """The ChipState of a card index, made on first use (the card's
        first context, under the claim watchdog)."""
        if not 0 <= index < len(self.devices):
            raise ValueError(f"INVALID_DEVICE: card {index} not on this node "
                             f"({len(self.devices)} devices)")
        c = self.chips.get(index)
        if c is not None:
            return c
        with self.chips_mu:
            c = self.chips.get(index)
            if c is None:
                cancel = claim_watchdog(f"card {index} first context",
                                        self.journal)
                try:
                    c = ChipState(self, index, self.devices[index],
                                  self.chip_region_path(index))
                finally:
                    cancel()
                self.chips[index] = c
            return c

    # -- the journal: recovery, resume, upkeep, handover --

    def _recover_from_journal(self) -> None:
        """Rebuild tenants from the replayed journal before the socket
        binds: drop those whose client pid is provably dead in this pid
        namespace, re-seed each other's slot with its grant and its HBM
        ledger (forced admits: the previous instance admitted these
        bytes), and park it for the resume grace.  Array data and
        programs come back at the owner's resume HELLO."""
        st = self._journal_state
        if not st or not st.get("tenants"):
            return
        self.recovery["recoveries_total"] += 1
        my_ns = _my_pidns()
        now = time.monotonic()
        for name, rec in st["tenants"].items():
            pid, pidns = rec.get("pid"), rec.get("pidns")
            if pid and (not pidns or int(pidns) == my_ns) \
                    and not tracing.pid_alive(int(pid)):
                self.recovery["tenants_dropped_dead"] += 1
                log.info("journal: dropping tenant %r (client pid %s is "
                         "dead)", name, pid)
                continue
            # Ledger bytes re-applied so far: a failure below hands them
            # back before the tenant is dropped, or the slot leaks quota.
            applied: List[Tuple[ChipState, int, int]] = []
            try:
                devices = [int(d) for d in rec.get("devices") or [0]]
                slots = [int(x) for x in rec.get("slots") or []]
                if len(devices) != 1 or len(slots) != 1:
                    raise ValueError(f"a grant over cards {devices} (slots "
                                     f"{slots}); one card per tenant here")
                chip, slot = self.chip(devices[0]), slots[0]
                if any(x.index == slot for x in self._parked_on(chip)):
                    raise ValueError(f"slot {slot} recovered twice")
                hbm = rec.get("hbm") or []
                core = rec.get("core")
                chip.region.reset_slot(slot)
                chip.region.set_mem_limit(
                    slot, int(hbm[0]) if hbm and hbm[0] is not None
                    else self.default_hbm)
                chip.region.set_core_limit(
                    slot, int(core) if core is not None
                    else self.default_core)
                t = Tenant(name, slot, int(rec.get("priority", 1)),
                           bool(rec.get("over", False)), chip)
                if isinstance(rec.get("suspended"), dict) and \
                        not rec["suspended"].get("auto"):
                    self.suspended.add(name)
                t.cost_ema = {str(k): float(v)
                              for k, v in (rec.get("ema") or {}).items()}
                t.executions = int(rec.get("execs", 0))
                t.client_pid = int(pid) if pid else None
                t.client_pidns = int(pidns) if pidns else None
                t.grant = {"hbm": list(hbm), "core": core}
                t.exe_shas = {str(k): str(v) for k, v
                              in (rec.get("exes") or {}).items()}
                t.recovered = True
                for aid, am in (rec.get("arrays") or {}).items():
                    nb = int(am.get("nbytes", 0))
                    if am.get("spilled"):
                        raise ValueError(f"array {aid} was spilled to the "
                                         "host; no host spill here")
                    chip.region.mem_acquire(slot, nb, True)
                    applied.append((chip, slot, nb))
                    t.nbytes[aid] = nb
                    t.blob_meta[aid] = dict(am)
            except Exception as e:  # noqa: BLE001 - skip, don't refuse boot
                log.warn("journal: cannot recover tenant %r (%s); dropping "
                         "it", name, e)
                for c, slot, nb in applied:
                    c.region.mem_release(slot, nb)
                self.recovery["tenants_dropped_dead"] += 1
                continue
            # Attainment history resumes with the tenant (the periodic
            # ``slo`` records and the snapshot's rows).
            if rec.get("slo"):
                self.slo.restore(name, rec["slo"])
            self.recovered[name] = (t, now + self.resume_grace)
            self.recovery["tenants_recovered"] += 1
        log.info("journal: recovered %d tenant(s) from epoch %s (%d dropped "
                 "as dead); resume grace %.0fs", len(self.recovered),
                 self.prev_epoch, self.recovery["tenants_dropped_dead"],
                 self.resume_grace)

    def _parked_on(self, chip: ChipState) -> List[Tenant]:
        return [e[0] for e in self.recovered.values() if e[0].chip is chip]

    def try_resume(self, name: str, resume_epoch: str) -> Optional[Tenant]:
        """Adopt a recovered tenant for its client's HELLO, which offers
        the PREVIOUS broker's epoch; its arrays and programs are back
        before this returns, so the client's next request sees them."""
        if self.journal is None or resume_epoch != self.prev_epoch:
            return None
        with self.mu:
            ent = self.recovered.pop(name, None)
            if ent is None:
                return None
            t = ent[0]
            t.connections += 1
            self.tenants[name] = t
        t0 = time.monotonic()
        self._restore_tenant(t)
        t.recovered = False
        self.recovery["tenants_readopted"] += 1
        self.recovery["resume_s_last"] = round(time.monotonic() - t0, 3)
        log.info("journal: tenant %r resumed in %.2f s (%d arrays, %d "
                 "programs, %d EMA keys)", name,
                 self.recovery["resume_s_last"], len(t.arrays),
                 len(t.executables), len(t.cost_ema))
        return t

    def _restore_tenant(self, t: Tenant) -> None:
        """The journaled arrays back on the tenant's card (copied on the
        card's stream, like a PUT) and its programs loaded again through
        the vetting (a graph from the broker's own directory is vetted
        like one off the wire).  An array whose blob is gone or short
        releases its ledger."""
        chip = t.chip
        t0 = time.monotonic()
        for aid, am in list(t.blob_meta.items()):
            blob = self.journal.get_blob(am.get("sha", ""))
            expect = int(am.get("nbytes", 0))
            try:
                if blob is None or len(blob) != expect:
                    raise ValueError(f"blob {am.get('sha')} missing or not "
                                     f"{expect} bytes")
                host = tensor_from_bytes(blob, am["dtype"], am["shape"])
                del blob
                with chip.context():
                    dev = host.to(chip.device)
            except Exception as e:  # noqa: BLE001 - drop, keep books true
                log.warn("journal: cannot restore array %s of %r (%s); "
                         "releasing its ledger", aid, t.name, e)
                with t.mu:
                    nb = t.nbytes.pop(aid, 0)
                    t.blob_meta.pop(aid, None)
                t.release_array(nb)
                self.recovery["arrays_dropped"] += 1
                continue
            with t.mu:
                t.arrays[aid] = dev
        if chip.stream is not None:
            chip.stream.synchronize()
        t1 = time.monotonic()
        self.recovery["restore_s_last"] = round(t1 - t0, 3)
        for eid, sha in list(t.exe_shas.items()):
            blob = self.journal.get_blob(sha)
            if blob is None:
                continue  # the client compiles again
            try:
                t.executables[eid] = self.cached_blob(bytes(blob), chip)
            except Exception as e:  # noqa: BLE001 - best effort
                log.warn("journal: cannot restore program %s of %r: %s",
                         eid, t.name, e)
        self.recovery["load_s_last"] = round(time.monotonic() - t1, 3)

    def _release_recovered(self, t: Tenant, counter: str) -> Optional[dict]:
        """Drop a parked recovered tenant: its re-applied ledger comes
        back (the slot recycles).  Returns the close record for the
        caller to journal once it holds no lock."""
        for aid in list(t.nbytes):
            t.release_array(t.nbytes.pop(aid))
        t.blob_meta.clear()
        self.recovery[counter] += 1
        return {"op": "close", "name": t.name} if self.journal else None

    def journal_tick(self) -> None:
        """The journal's keeper (1 s on the timer wheel): drop parked
        tenants past the grace and compact the log when due."""
        now = time.monotonic()
        expired = []
        with self.mu:
            for name, (t, deadline) in list(self.recovered.items()):
                if now >= deadline:
                    del self.recovered[name]
                    expired.append(t)
        for t in expired:
            log.info("journal: recovered tenant %r never reconnected within "
                     "%.0fs; dropping", t.name, self.resume_grace)
            rec = self._release_recovered(t, "tenants_dropped_expired")
            if rec is not None:
                self.journal.append(rec)
        if self.journal is not None and self.slo.journal_due():
            # Periodic SLO records: a successor resumes each tenant's
            # attainment history within a period.  An item in flight at a
            # crash is in neither the journaled sketch nor the successor's
            # (it records only once retired), so nothing counts twice.
            with self.mu:
                names = set(self.tenants) | set(self.recovered)
            recs = []
            for name in sorted(names):
                st = self.slo.export_state(name)
                if st is not None:
                    recs.append({"op": "slo", "name": name, "state": st})
            if recs:
                try:
                    self.journal.append_many(recs)
                except OSError as e:
                    # History, not enforcement: a lost period costs the
                    # successor a few seconds of it.
                    log.warn("journal: dropping %d slo record(s) (%s)",
                             len(recs), e)
        if self.journal is not None and self.journal.snapshot_due():
            self.journal.write_snapshot(self._snapshot_dict)

    def _snapshot_dict(self) -> dict:
        with self.mu:
            items = list(self.tenants.items()) \
                + [(n, e[0]) for n, e in self.recovered.items()]
        tenants = {}
        for name, t in items:
            with t.mu:
                arrays = {aid: dict(am) for aid, am in t.blob_meta.items()}
            grant = t.grant or {}
            tenants[name] = {
                "devices": [t.chip.index],
                "slots": [t.index],
                "priority": t.priority,
                "over": t.oversubscribe,
                "hbm": grant.get("hbm"),
                "core": grant.get("core"),
                "spill": None,
                "pid": t.client_pid,
                "pidns": t.client_pidns,
                "arrays": arrays,
                "exes": dict(t.exe_shas),
                "ema": {k: float(v) for k, v in t.cost_ema.items()},
                "execs": t.executions,
            }
            if name in self.suspended:
                tenants[name]["suspended"] = {"auto": False}
            # The SLO rows ride the snapshot, so compaction never ages
            # attainment history out of the journal.
            slo_state = self.slo.export_state(name)
            if slo_state is not None:
                tenants[name]["slo"] = slo_state
        with self.chips_mu:
            chips = {str(i): c.latency_us for i, c in self.chips.items()
                     if c.latency_us}
        out = {"version": 1, "epoch": self.epoch,
               "recoveries_total": self.recovery["recoveries_total"],
               "tenants": tenants, "chips": chips}
        if self.last_wedge:
            out["last_wedge"] = dict(self.last_wedge)
        return out

    def journal_stats(self) -> dict:
        out: Dict[str, Any] = {"enabled": self.journal is not None,
                               "draining": self.draining,
                               "epoch": self.epoch}
        if self.last_wedge:
            out["last_wedge"] = dict(self.last_wedge)
        out.update(self.recovery)
        with self.mu:
            out["tenants_awaiting_resume"] = len(self.recovered)
        if self.journal is not None:
            out.update(self.journal.stats())
        return out

    def slo_report(self, tenant: Optional[str] = None,
                   admin: bool = False) -> Dict[str, Any]:
        """The SLO verb's reply: the plane's report with the live quota
        shares the fairness report holds attainment against."""
        with self.mu:
            tenants = list(self.tenants.items())
        quota = {name: int(t.chip.region.device_stats(t.index).core_limit_pct)
                 for name, t in tenants}
        rep = self.slo.report(tenant=tenant, admin=admin, quota_pcts=quota)
        rep["ok"] = True
        return rep

    def timer_stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"enabled": self.timers is not None}
        if self.timers is not None:
            out["wheel"] = self.timers.stats()
        return out

    def drain(self, timeout: float = 30.0, resume: bool = True) -> int:
        """Prepare a handover: refuse new HELLOs (DRAINING: clients retry
        against the successor), pause dispatch, wait for the dispatched
        work to retire, commit a final snapshot.  Dispatch then goes on
        (``resume``, DRAIN) or stays paused for the exit (HANDOVER): the
        queued executes die unreplied with the process and their clients
        send them to the successor.  ``vtpu`` dispatches on during its
        drain and waits for the queues to empty, which a tenant that
        keeps sending holds off until the timeout.  Returns the number
        of tenants the snapshot carries."""
        self.draining = True
        self.dispatch_paused = True
        deadline = time.monotonic() + max(timeout, 0.0)
        with self.chips_mu:
            chips = list(self.chips.values())
        with self.mu:
            tenants = list(self.tenants.values())
        for t in tenants:
            # The successor seeds fresh buckets: a lease left with a
            # client would be granted twice.
            with t.chip.scheduler.mu:
                t.lease_release()
                t.lease_revoked = True
        try:
            for chip in chips:
                chip.scheduler.quiesce_all(
                    max(deadline - time.monotonic(), 0.0))
            # The drainers park every lane's gate while dispatch is paused
            # and the meters bill what the lanes queued.
            self.fastlane.quiesce_all(max(deadline - time.monotonic(), 0.0))
            if self.journal is not None:
                self.journal.write_snapshot(self._snapshot_dict)
        finally:
            if resume:
                self.dispatch_paused = False
                for chip in chips:
                    chip.scheduler.kick()
                # The drainers reopen the parked gates on their next pass.
        with self.mu:
            return len(self.tenants) + len(self.recovered)

    def tenant(self, name: str, priority: int, oversubscribe: bool = False,
               device: int = 0, hbm_limit: Optional[int] = None,
               core_limit: Optional[int] = None) -> Tuple[Tenant, bool]:
        """Bind a connection to a tenant; (tenant, created).  A new
        tenant's slot is reset and seeded with its grant (the first
        HELLO's wins for the tenant's life).  A plain HELLO under the
        name of a parked recovered tenant starts fresh: the parked
        ledger is released first."""
        chip = self.chip(device)
        created = False
        deferred_close = None
        with self.mu:
            ent = self.recovered.pop(name, None)
            if ent is not None:
                deferred_close = self._release_recovered(
                    ent[0], "tenants_dropped_replaced")
            t = self.tenants.get(name)
            if t is not None and t.chip is not chip:
                raise ValueError(f"INVALID_DEVICE: tenant {name!r} is bound "
                                 f"to card {t.chip.index}")
            if t is None:
                # Parked tenants keep their slots (and live ledgers).
                used = {x.index for x in list(self.tenants.values())
                        + self._parked_on(chip) if x.chip is chip}
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
        if deferred_close is not None:
            try:
                self.journal.append(deferred_close)
            except OSError as e:
                # The superseding bind record follows; replay re-creates
                # then re-binds the name.
                log.error("journal: close record of the parked %s lost "
                          "(%s)", name, e)
        return t, created

    def release_tenant(self, t: Tenant) -> bool:
        """Drop one connection; True when the last one is gone and the
        tenant's state is to be torn down (its slot recycles).  The
        close record is journaled before the arrays drop."""
        with self.mu:
            t.connections -= 1
            if t.connections > 0:
                return False
        # Meter everything dispatched before the slot can recycle: a
        # late retirement would bill the slot's next tenant.
        t.chip.scheduler.quiesce(t.name)
        # The same for the lane: its gate closes, what is in its ring
        # cancels and refunds, and its batches on the card are billed;
        # then the unburnt lease refunds.  If a reconnect wins the race
        # below, that session goes over the socket until its next HELLO.
        self.fastlane.quiesce_lane(t.name)
        with t.chip.scheduler.mu:
            t.lease_release()
        with self.mu:
            if t.connections > 0 or self.tenants.get(t.name) is not t:
                return False  # a reconnect took it over meanwhile
            self.tenants.pop(t.name, None)
            t.chip.scheduler.forget_tenant(t.name)
            self.flight.forget(t.name)
            self.suspended.discard(t.name)
        # A reused name is a new tenant: its attainment history starts at
        # zero (slo.mu is a leaf, taken with no broker lock held).
        self.slo.forget(t.name)
        # The lane's files go with the tenant (file I/O, outside state.mu).
        self.fastlane.close_lane(t.name)
        if self.journal is not None:
            try:
                self.journal.append({"op": "close", "name": t.name})
            except OSError as e:
                log.error("journal: close record for %s lost (%s)", t.name,
                          e)
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
        self.fastlane.stop()
        for chip in list(self.chips.values()):
            chip.scheduler.stop()


def resize_tenant(t: Tenant, hbm_limit: Optional[int] = None,
                  core_limit: Optional[int] = None) -> dict:
    """Live resize of a tenant's grant (admin RESIZE): re-seed its slot's
    limits.  An HBM shrink applies to new admissions at once; bytes
    already past the new cap stay until freed (nothing is evicted from
    under a running program).  The dispatcher's cached metering verdict
    is cleared so a share change bites now.  Returns the journal record,
    which the caller appends before its ack, holding no lock."""
    region, slot = t.chip.region, t.index
    if hbm_limit is not None:
        region.set_mem_limit(slot, int(hbm_limit))
    if core_limit is not None:
        region.set_core_limit(slot, int(core_limit))
    st = region.device_stats(slot)
    new_hbm, new_core = [int(st.limit_bytes)], int(st.core_limit_pct)
    t.grant = {"hbm": new_hbm, "core": new_core}
    with t.chip.scheduler.mu:
        t._metered_cache = None
        # A lease pre-debited at the old share does not outlive it.
        t.lease_release()
        t.lease_revoked = True
    # The default objective follows the share (an explicit one stays).
    t.chip.scheduler.state.slo.set_quota_pct(t.name, new_core)
    return {"op": "resize", "name": t.name, "hbm": new_hbm,
            "core": new_core}


# -- sessions ------------------------------------------------------------------

def _stats_reply(state: RuntimeState) -> Dict[str, Any]:
    return {"ok": True, "tenants": collect_stats(state),
            "fastlane": state.fastlane.stats(),
            "journal": state.journal_stats(),
            "pool": dict(state.pool_stats),
            "timers": state.timer_stats(),
            "replication": state.replication.status()}


def _trace_reply(state: RuntimeState, msg) -> Dict[str, Any]:
    """TRACE, bind-free on both sockets: the flight recorder's spans and
    slow-op captures (``enabled: false`` and no tenant with tracing
    off)."""
    t_arg = msg.get("tenant")
    return {"ok": True, "enabled": state.flight.enabled,
            "tenants": state.flight.snapshot(
                tenant=str(t_arg) if t_arg else None,
                limit=int(msg.get("limit", 0) or 0))}


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
        faults.fire("reply")
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
        if self.state.draining:
            # A handover is under way: the successor takes new bindings;
            # clients retry.
            self._send_err("DRAINING", "broker is draining for handover; "
                           "retry")
            return
        devs = msg.get("devices")
        if devs and len(devs) > 1:
            self._send_err("INVALID_DEVICE", "a tenant holds one card here; "
                           "grants over several cards are not ported yet")
            return
        hbm = msg.get("hbm_limit")
        core = msg.get("core_limit")
        created = False
        tenant = None
        r_epoch = msg.get("resume_epoch")
        if r_epoch is not None:
            # A reconnect after a restart or handover: adopt the tenant
            # recovered from the journal, state intact.
            tenant = self.state.try_resume(str(msg["tenant"]), str(r_epoch))
        resumed = tenant is not None
        if tenant is None:
            try:
                tenant, created = self.state.tenant(
                    str(msg["tenant"]), int(msg.get("priority", 1)),
                    bool(msg.get("oversubscribe", False)),
                    device=int(devs[0] if devs else msg.get("device", 0)),
                    hbm_limit=int(hbm) if hbm is not None else None,
                    core_limit=int(core) if core is not None else None)
            except SlotsExhausted as e:
                self._send({"ok": False, "code": "OVERLOAD",
                            "error": str(e), "retry_ms": 200})
                return
        # tenant_box first: if the bind record's append fails, teardown
        # still releases the connection this HELLO took.
        tenant_box[0] = tenant
        self._journal_bind(tenant, msg)
        # The SLO objective: the grant's target and floor when HELLO
        # carries them (the first HELLO's win), else from the share.
        self.state.slo.ensure_tenant(
            tenant.name,
            quota_pct=int(tenant.chip.region.device_stats(
                tenant.index).core_limit_pct),
            target_us=msg.get("slo_target_us"),
            floor_steps_s=msg.get("slo_floor_steps"))
        # The fastlane: a lane when the client asks and the tenant has one
        # connection (the ring is single-producer); a second connection of
        # a laned tenant sends the first back to the socket.  A resumed
        # tenant gets a fresh lane.
        hub = self.state.fastlane
        lane = None
        if tenant.connections > 1:
            hub.gate_close(tenant.name)
        elif msg.get("fastlane"):
            lane = hub.create_lane(tenant)
        rep = {"ok": True, "tenant_index": tenant.index,
               "chip": tenant.chip.index, "chips": [tenant.chip.index],
               "epoch": self.state.epoch, "created": created,
               "resumed": resumed}
        if lane is not None:
            # The arena fds follow the reply once, as SCM_RIGHTS on a
            # one-byte message; the paths stay in the reply.
            lane[0]["fds"] = hasattr(socket, "send_fds")
            rep["fastlane"] = lane[0]
        self._send(rep)
        if lane is not None and lane[0]["fds"]:
            try:
                with self.send_mu:
                    socket.send_fds(self.request, [b"F"], lane[1])
            except OSError:
                pass

    def _journal_bind(self, t: Tenant, msg) -> None:
        """Journal a binding (creation, reconnect or resume): the grant's
        shape and the client's identity, for recovery."""
        jr = self.state.journal
        if jr is None:
            return
        pid, pidns = msg.get("pid"), msg.get("pidns")
        if pid:
            t.client_pid = int(pid)
        if pidns:
            t.client_pidns = int(pidns)
        if t.grant is None:
            st = t.chip.region.device_stats(t.index)
            t.grant = {"hbm": [int(st.limit_bytes)],
                       "core": int(st.core_limit_pct)}
        jr.append({"op": "bind", "name": t.name,
                   "devices": [t.chip.index], "slots": [t.index],
                   "priority": t.priority, "over": t.oversubscribe,
                   "hbm": t.grant.get("hbm"), "core": t.grant.get("core"),
                   "spill": None, "pid": t.client_pid,
                   "pidns": t.client_pidns})

    def _serve(self, sock, tenant_box):  # noqa: C901 - protocol dispatch
        while True:
            try:
                msg = P.recv_msg(sock)
            except (ConnectionError, P.ProtocolError):
                break
            kind = msg.get("kind")
            tenant = tenant_box[0]
            # Fired outside the dispatch try: an injected ConnectionError
            # takes the real peer-died path (the loop ends, teardown
            # runs).
            faults.fire(str(kind))
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
                if kind == P.TRACE:
                    if tenant is not None:
                        self._drain()
                    self._send(_trace_reply(self.state, msg))
                    continue
                if kind == P.SLO:
                    # Bind-free and scoped: a bound connection gets its own
                    # row whatever it names; an unbound probe the row it
                    # names (metricsd's scrape) or the enabled flag alone.
                    # The matrix is the admin socket's.
                    if tenant is not None:
                        self._drain()
                        scope = tenant.name
                    else:
                        t_arg = msg.get("tenant")
                        scope = str(t_arg) if t_arg else None
                    self._send(self.state.slo_report(tenant=scope))
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
                    flush_tenant_journal(self.state, tenant)
                    self._send({"ok": True, "freed": freed})
                elif kind == P.COMPILE:
                    blob = bytes(msg["exported"])
                    prog = self.state.cached_blob(blob, tenant.chip)
                    eid = str(msg["id"])
                    tenant.executables[eid] = prog
                    jr = self.state.journal
                    if jr is not None:
                        # The graph as the tenant sent it: a resumed
                        # tenant's programs load again under their ids.
                        jr.put_blob(blob, sha=prog.sha)
                        tenant.exe_shas[eid] = prog.sha
                        jr.append({"op": "compile", "name": tenant.name,
                                   "id": eid, "sha": prog.sha})
                    self._send({"ok": True})
                elif kind == P.STATS:
                    tenant.chip.scheduler.quiesce(tenant.name)
                    self.state.fastlane.wait_metered(tenant.name)
                    self._send(_stats_reply(self.state))
                elif kind == P.FASTBIND:
                    # A route: (program, argument ids, output ids) bound to
                    # the integer a ring descriptor carries.
                    self._send(self.state.fastlane.bind_route(
                        tenant, str(msg["exe"]),
                        [str(a) for a in msg["args"]],
                        [str(o) for o in (msg.get("outs") or ())]))
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
        arena_off = msg.get("arena_off")
        if arena_off is not None:
            # The payload is in the lane's tx arena, never on the socket;
            # copied out now, as the client reuses the arena after the ack.
            lane = tenant.fastlane
            tx = lane.tx_view() if lane is not None else None
            want, off = int(msg["nbytes"]), int(arena_off)
            if tx is None or off < 0 or off + want > len(tx):
                raise P.ProtocolError(f"arena PUT [{off}, +{want}) has no "
                                      "arena to come from")
            buf = bytearray(tx[off:off + want])
        elif raw_parts:
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
        flush_tenant_journal(self.state, tenant)
        with tenant.mu:
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
        jr = self.state.journal
        if jr is not None:
            # The payload and the ledger entry, before the ack: once the
            # client sees ok, the array survives a broker crash.
            flat = tensor_bytes(host)
            sha = jr.put_blob(flat, sha=hashlib.sha256(flat).hexdigest())
            rec = {"op": "put", "name": tenant.name, "id": aid, "sha": sha,
                   "shape": list(host.shape),
                   "dtype": dtype_name(host.dtype),
                   "nbytes": nbytes, "charges": [[0, nbytes]],
                   "spilled": False}
            with tenant.mu:
                tenant.blob_meta[aid] = {k: rec[k] for k in (
                    "sha", "shape", "dtype", "nbytes", "charges",
                    "spilled")}
            jr.append(rec)
        self._send({"ok": True, "nbytes": nbytes, "spilled": False})

    def _get(self, sock, tenant: Tenant, msg) -> None:
        aid = str(msg["id"])
        with tenant.mu:
            dev = tenant.arrays.get(aid)
            ready = tenant.ready.get(aid)
        if dev is None:
            self._send_err("NOT_FOUND", aid)
            return
        chip = tenant.chip
        if ready is not None and chip.stream is not None:
            # An execute's output: wait for its own dispatch batch, then
            # copy beside the card's stream, so the work queued after it
            # runs on meanwhile.
            ready.wait()
            dev.record_stream(chip.side)
            with torch.cuda.device(chip.device), \
                    torch.cuda.stream(chip.side):
                host = dev.to("cpu")
        else:
            # A PUT array: copied on the card's stream, ordered after
            # every item queued before it.
            with chip.context():
                host = dev.to("cpu")
        flat = tensor_bytes(host)
        nbytes = len(flat)
        hdr = {"ok": True, "shape": list(host.shape),
               "dtype": dtype_name(host.dtype), "nbytes": nbytes}
        lane = tenant.fastlane if msg.get("arena") else None
        rx = lane.rx_view() if lane is not None else None
        if rx is not None and nbytes <= len(rx):
            # Into the lane's rx arena (the copy to the host is done), a
            # header on the socket; a tensor larger than the arena goes
            # by the framing below.
            rx[:nbytes] = flat
            hdr["arena_off"] = 0
            self._send(hdr)
        elif msg.get("raw"):
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

    def _build_item(self, t: Tenant, spec, trace=None) -> WorkItem:
        """One execute body ({exe, args, outs, repeats?, carry?, free?})
        as a WorkItem; raises _ItemError with the typed code."""
        prog = t.executables.get(str(spec["exe"]))
        if prog is None:
            raise _ItemError("NOT_FOUND", str(spec["exe"]))
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
        item = WorkItem(t, self, prog, str(spec["exe"]),
                        [str(a) for a in spec["args"]],
                        [str(x) for x in spec.get("outs", [])],
                        steps=steps, carry=carry,
                        free_ids=[str(f) for f in spec.get("free", ())])
        if spec.get("feeds"):
            item.feeds = self._parse_feeds(t, prog, spec["feeds"], n_args,
                                          steps)
        if isinstance(trace, dict):
            # The client's stamp (VTPU_TRACE): its id threads through to
            # the span.
            tid = trace.get("id")
            item.trace_id = str(tid) if tid else None
            try:
                item.trace_ts = (float(trace["ts"]) if "ts" in trace
                                 else None)
            except (TypeError, ValueError):
                pass
        return item

    @staticmethod
    def _parse_feeds(t: Tenant, prog: Program, feeds, n_args: int,
                     steps: int) -> tuple:
        """Arena feeds ([id, argpos, offset, nbytes, shape, dtype] each),
        checked now against the tenant's tx arena and the program's input
        at ``argpos``: a bad feed fails this request, not the dispatcher,
        and a chain's later steps run on what the first was held to."""
        lane = t.fastlane
        tx = lane.tx_view() if lane is not None else None
        if tx is None:
            raise _ItemError("FEED_UNAVAILABLE", "feeds need a negotiated "
                             "fastlane lane (tx arena)")
        parsed = []
        for f in feeds:
            fid, ap, off, nb, shape, dt = f
            ap, off, nb = int(ap), int(off), int(nb)
            shape = tuple(int(x) for x in shape)
            if not 0 <= ap < n_args:
                raise _ItemError("BAD_FEED", f"feed argpos {ap} out of range")
            if off < 0 or nb <= 0 or off + nb > len(tx):
                raise _ItemError("BAD_FEED", f"feed [{off}, +{nb}) outside "
                                 f"the {len(tx)}-byte tx arena")
            try:
                dtype = torch_dtype(str(dt))
            except TypeError:
                raise _ItemError("BAD_FEED", f"feed dtype {dt!r}") from None
            if ap < len(prog.in_meta) and (shape, dtype) != prog.in_meta[ap]:
                want = prog.in_meta[ap]
                raise _ItemError("BAD_FEED", f"feed {dt}{list(shape)} at "
                                 f"argument {ap}; the program takes "
                                 f"{dtype_name(want[1])}{list(want[0])}")
            if nb != math.prod(shape) * dtype.itemsize:
                raise _ItemError("BAD_FEED", f"feed of {nb} bytes is not a "
                                 f"{dt}{list(shape)}")
            parsed.append((str(fid) if fid else None, ap, off, nb, shape,
                           str(dt)))
        if steps > 1 and len(parsed) not in (1, steps):
            raise _ItemError("BAD_FEED", f"chained feeds want 1 or {steps} "
                             f"entries, got {len(parsed)}")
        return tuple(parsed)

    def _reserve_pending(self, n: int) -> None:
        with self.pending_cond:
            while self.pending and self.pending + n > MAX_PENDING_REPLIES:
                self.pending_cond.wait(timeout=0.5)
            self.pending += n

    def _enqueue_execute(self, t: Tenant, msg) -> None:
        try:
            item = self._build_item(t, msg, trace=msg.get("trace"))
        except _ItemError as e:
            self._drain()
            self._send_err(e.code, e.msg)
            return
        self._reserve_pending(1)
        t.chip.scheduler.submit(item)
        # A socket execute while a lane exists: which path a tenant is on.
        self.state.fastlane.note_fallback(t, 1)

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
                item = self._build_item(t, spec, trace=msg.get("trace"))
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
            self.state.fastlane.note_fallback(t, len(items))
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

    def _attach_lease(self, t: Tenant, msg: Dict[str, Any]) -> None:
        """The tenant's lease on an execute reply: its µs and time to live,
        or once a revoke after a suspend, resize or drain (a new grant
        does not clear it, so the next reply carries it).  An unlocked
        read: the client's copy paces its sends and enforces nothing."""
        if self.state.rate_lease_us <= 0:
            return
        if t.lease_revoked:
            t.lease_revoked = False
            msg["lease"] = {"us": 0, "ttl_s": 0.0, "revoke": True}
        elif t.lease_us > 0:
            msg["lease"] = {"us": int(t.lease_us), "ttl_s": round(
                max(t.lease_exp - time.monotonic(), 0.0), 3)}

    def complete_execute(self, item: WorkItem, metas, exc,
                         actual_us: float) -> None:
        """Called by the dispatcher in dispatch order: the reply, or the
        item's EXEC_BATCH slot (the filler of the last one sends)."""
        res = self._exec_result(metas, exc, actual_us)
        try:
            if item.batch is not None:
                if item.batch.fill(item.batch_idx, res):
                    msg = {"ok": True, "results": item.batch.results}
                    self._attach_lease(item.tenant, msg)
                    self._send(msg)
            else:
                if res.get("ok"):
                    self._attach_lease(item.tenant, res)
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
            # The close record, journaled before, covers these drops; a
            # late one could land after a new tenant's bind of the name.
            t.pending_journal.clear()
        t.executables.clear()


def collect_stats(state: RuntimeState) -> Dict[str, Dict[str, Any]]:
    """Each tenant's row: ``vtpu``'s keys for what this broker has,
    ``busy_us``, the device time metered to the tenant's slot, and
    ``recovered``.  A tenant recovered from the journal and parked for
    its client has a row too (``recovered`` true, its ledger already
    re-applied); ``vtpu`` lists bound tenants only."""
    out = {}
    with state.mu:
        tenants = list(state.tenants.items()) + [
            (n, e[0]) for n, e in state.recovered.items()]
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
            "arrays": len(t.blob_meta) if t.recovered else len(t.arrays),
            "recovered": bool(t.recovered),
            # No host spill in this core: an oversubscribed tenant's
            # arrays stay on the card.
            "host_spill_bytes": 0,
            "staged_resident_bytes": 0,
            "suspended": name in state.suspended,
            "executions": t.executions,
            "cost_ema_us": {k: round(float(v), 1)
                            for k, v in t.cost_ema.items()},
            "busy_us": int(st.busy_us),
            "lease_us": int(t.lease_us),
            "lease_grants": t.lease_grants,
        }
        fl = state.fastlane.tenant_stats(name)
        if fl is not None:
            out[name]["fastlane"] = fl
    return out


class AdminSession(socketserver.BaseRequestHandler):
    """The host-side admin socket (``<socket>.admin``, never mounted into
    a container): STATS, TRACE, SLO (every row, the blame matrix, the
    fairness report), SUSPEND, RESUME, RESIZE, DRAIN, HANDOVER, SHUTDOWN
    and REPL_SYNC (a standby's stream, or its status); the broker's uid
    and root only."""

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
                        t_obj = self.state.tenants.get(name)
                        if kind == P.SUSPEND:
                            self.state.suspended.add(name)
                        else:
                            self.state.suspended.discard(name)
                    if kind == P.SUSPEND and t_obj is not None:
                        # A frozen tenant parks no pre-debited time; its
                        # lane's drainer parks the gate.
                        with t_obj.chip.scheduler.mu:
                            t_obj.lease_release()
                            t_obj.lease_revoked = True
                    with self.state.chips_mu:
                        chips = list(self.state.chips.values())
                    for chip in chips:
                        chip.scheduler.kick()
                    jr = self.state.journal
                    if jr is not None:
                        # A crash must not unfreeze a suspended tenant.
                        jr.append({"op": "suspend" if kind == P.SUSPEND
                                   else "resume", "name": name,
                                   "auto": False})
                    log.info("admin: %s tenant %r (known=%s)", kind, name,
                             known)
                    P.send_msg(self.request, {"ok": True, "known": known})
                elif kind == P.RESIZE:
                    name = str(msg["tenant"])
                    hbm = msg.get("hbm_limit")
                    hbms = msg.get("hbm_limits")
                    core = msg.get("core_limit")
                    with self.state.mu:
                        t_obj = self.state.tenants.get(name)
                        if t_obj is None and name in self.state.recovered:
                            # A parked tenant resizes too: its resume
                            # adopts the new grant.
                            t_obj = self.state.recovered[name][0]
                    if t_obj is None:
                        P.reply_err(self.request, "NOT_FOUND",
                                    f"tenant {name!r} is not bound")
                        continue
                    if hbms is not None and hbm is None:
                        hbm = hbms[0]
                    rec = resize_tenant(
                        t_obj, int(hbm) if hbm is not None else None,
                        int(core) if core is not None else None)
                    # The lane's gate parks for a pass, so its client gives
                    # back the lease it holds at the old share.
                    self.state.fastlane.repark(name)
                    # Journaled before the ack: once the operator sees ok
                    # the new grant survives a crash.
                    if self.state.journal is not None:
                        self.state.journal.append(rec)
                    for chip in self.state.chips.values():
                        chip.scheduler.kick()
                    log.info("admin: RESIZE tenant %r hbm=%s core=%s", name,
                             rec["hbm"], rec["core"])
                    P.send_msg(self.request, {"ok": True, "tenant": name,
                                              "hbm": rec["hbm"],
                                              "core": rec["core"]})
                elif kind == P.STATS:
                    with self.state.mu:
                        suspended = sorted(self.state.suspended)
                    rep = _stats_reply(self.state)
                    rep["suspended"] = suspended
                    P.send_msg(self.request, rep)
                elif kind == P.TRACE:
                    P.send_msg(self.request, _trace_reply(self.state, msg))
                elif kind == P.SLO:
                    P.send_msg(self.request,
                               self.state.slo_report(admin=True))
                elif kind == P.REPL_SYNC:
                    if msg.get("status"):
                        P.send_msg(self.request, {
                            "ok": True,
                            "replication": self.state.replication.status()})
                    else:
                        # The connection becomes the standby's stream until
                        # either side dies.
                        self.state.replication.serve_follower(self.request,
                                                              msg)
                        return
                elif kind in (P.DRAIN, P.HANDOVER):
                    # Quiesce and a final snapshot; HANDOVER then exits,
                    # and the successor recovers the journal.
                    n = self.state.drain(float(msg.get("timeout", 30.0)),
                                         resume=kind == P.DRAIN)
                    P.send_msg(self.request, {
                        "ok": True, "tenants": n,
                        "snapshotted": self.state.journal is not None})
                    if kind == P.HANDOVER:
                        cb = getattr(self.state, "shutdown_cb", None)
                        if cb is not None:
                            threading.Thread(target=cb, daemon=True).start()
                        return
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
        st = getattr(self, "state", None)
        if st is not None:
            st._keeper_stop.set()  # noqa: SLF001 - the lifecycle's owner
            if st.timers is not None:
                st.timers.stop()
            # Removes the sidecar only if this process wrote it.
            tracing.clear_lease_sidecar()
        if self.admin_server is not None:
            self.admin_server.shutdown()
        super().shutdown()

    def server_close(self):
        if self.admin_server is not None:
            self.admin_server.server_close()
        st = getattr(self, "state", None)
        if st is not None:
            if st.timers is not None:
                st.timers.stop()
            st.stop()
        super().server_close()


def _journal_tick(state: RuntimeState) -> None:
    if not state._keeper_stop.is_set():  # noqa: SLF001 - its owner
        state.journal_tick()


def _lease_tick(state: RuntimeState) -> None:
    """The lease sidecar's heartbeat (5 s): its mtime is the liveness a
    co-claimer's watchdog and ``vtpu-smi leases`` read; a killed broker
    stops beating and its sidecar goes stale."""
    if not state._keeper_stop.is_set():  # noqa: SLF001 - its owner
        tracing.heartbeat_lease_sidecar()


def make_server(socket_path: str, hbm_limit: int, core_limit: int,
                region_path: Optional[str] = None,
                min_exec_cost_us: int = 0,
                work_conserving: Optional[bool] = None,
                device: str = "cuda",
                journal_dir: Optional[str] = None,
                preloaded_state: Optional[dict] = None,
                fence: Optional[repl_mod.Fence] = None) -> _Server:
    """The tenant socket at ``socket_path`` and the admin socket beside
    it, not yet serving (call ``serve_forever``).  ``device`` is "cuda"
    (every card; raises when there is none), "cuda:<i>" or "cpu".
    ``journal_dir`` (else ``VTPU_JOURNAL_DIR``) turns on the journal and
    recovers what it holds before the socket binds; an unusable
    directory is logged and the broker runs without one.  A standby's
    takeover passes the state it applied (``preloaded_state``) and the
    fence it already claimed; the cards are claimed here, as at any
    boot."""
    if os.path.exists(socket_path):
        os.unlink(socket_path)
    os.makedirs(os.path.dirname(socket_path) or ".", exist_ok=True)
    # The regions are the broker's own state: a stale file would keep the
    # old limits (a region seeds them on creation only).
    rpath = region_path or socket_path + ".shr"
    for stale in [rpath] + glob.glob(rpath + ".chip*"):
        if os.path.exists(stale):
            os.unlink(stale)
    jdir = journal_dir if journal_dir is not None \
        else (os.environ.get("VTPU_JOURNAL_DIR") or None)
    jr = None
    if jdir:
        try:
            jr = Journal(jdir)
        except OSError as e:
            log.error("journal dir %s unusable (%s); running WITHOUT crash "
                      "recovery", jdir, e)
    if jr is not None:
        # The epoch fence: a generation claimed at boot and checked before
        # every append, so a superseded instance can never journal (and
        # so never ack).
        if fence is None:
            fence = repl_mod.Fence(socket_path + ".fence")
            fence.claim()
        jr.fence = fence.check
    state = RuntimeState(rpath, hbm_limit, core_limit, min_exec_cost_us,
                         work_conserving, device=device, journal=jr,
                         preloaded_state=preloaded_state)
    if fence is not None:
        state.replication.fence = fence
    # One timer thread for the keepers, on harmonic grids.
    state.timers = timers_mod.TimerWheel()
    if jr is not None:
        state.timers.add_periodic("journal", 1.0,
                                  lambda: _journal_tick(state))
    state.timers.add_periodic("lease-heartbeat",
                              tracing.LEASE_HEARTBEAT_S,
                              lambda: _lease_tick(state))
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
    p.add_argument("--journal-dir", default=None,
                   help="the crash-safe journal's directory (default "
                        "VTPU_JOURNAL_DIR; unset: no recovery)")
    p.add_argument("--cluster", default=None,
                   help="refused: " + deferred("the federation",
                                               "6(d)(ii), the federation"))
    ns = p.parse_args(argv)
    if ns.cluster:
        p.error("--cluster " + deferred("the federation",
                                        "6(d)(ii), the federation"))
    hbm = envspec.parse_quantity(ns.hbm_limit) if ns.hbm_limit != "0" else 0
    srv = make_server(ns.socket, hbm, ns.core_limit, ns.region,
                      ns.min_exec_cost_us,
                      work_conserving=(None if ns.work_conserving is None
                                       else bool(ns.work_conserving)),
                      device=ns.device, journal_dir=ns.journal_dir)
    log.info("vtpu-runtime serving on %s (hbm=%d core=%d%%, %s)", ns.socket,
             hbm, ns.core_limit, ns.device)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        # K1's launches in this process, by route: the record of what
        # this instance ran (a killed instance writes none).
        print("vtpu-runtime: K1 launches " + json.dumps(
            _fa.flash_attention.route_launches), file=sys.stderr,
            flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
