"""In-process quota enforcement for PyTorch tenants.

The torch twin of ``vtpu.shim.pyshim``'s ``_PyEnforcer``: the same HBM
ledger and device-time token bucket over the shared region, with the
same semantics, but called explicitly by the tenant instead of patched
into the framework:

- ``to_device(module_or_tensor, device)`` admits every tensor's bytes
  before anything is allocated on the card, rolls back every charge if
  one is refused, and ties each charge to the new tensor's lifetime.
- ``charge``/``track`` admit one tensor at a time, for a tenant that
  initialises its weights on the card (``models.convert.init_module``).
- ``gated(fn)`` wraps a call: gate on the token bucket, run, synchronise
  the card, observe the measured time, charge the outputs.

A tenant started under the native interposer (``shim/interposer.py``,
``libvtpu_cuda.so`` in LD_PRELOAD) is held to the same quota inside the
CUDA driver API without any of these calls, as ``vtpu`` leaves
enforcement to its PJRT interposer.  ``install_torch_enforcement`` then
stands down, and ``region_ledger`` reads the region the interposer
charges.  Only the interposer's own symbol, found in the process, makes
it stand down, so a quota is never dropped.

The in-container bootstrap (``shim/sitecustomize.py``) calls
``bootstrap()`` and then ``install_py_enforcement()`` in every Python
process of a granted container, as ``vtpu``'s does:

- ``bootstrap()`` says which layer enforces the quota.
- ``install_py_enforcement(device)`` gives the process one enforcer
  (``enforcer()``) and routes torch's own calls through it, the torch
  form of ``vtpu``'s patched ``jax.device_put`` and ``jax.jit``: a
  ``Tensor.to``/``.cuda`` or ``Module.to``/``.cuda`` that names the
  guarded device is admitted before it allocates and charged while the
  storage it made lives, and the callable ``torch.compile`` returns is
  ``gated``.  It stands down whenever the interposer is in the process.

torch is imported where it is used, not with this module:
``sitecustomize`` imports this module in every Python process of a
granted container, and a process that the interposer enforces does not
pay for importing torch.
"""

from __future__ import annotations

import contextlib
import functools
import importlib.abc
import importlib.util
import itertools
import os
import sys
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from ..utils import envspec
from ..utils import logging as log
from . import interposer
from .core import RateLease, SharedRegion

DEFAULT_REGION = "/tmp/vtpushr.cache"
# Seed of the per-function device-time estimate (µs) before any
# measurement, and the weight of the newest sample in its EMA.
_COST_SEED_US = 5000.0
_EMA_NEW = 0.3
# How long the DEFAULT policy trusts one contention probe (s).
_PROBE_S = 0.1


def _tensors(obj) -> List["torch.Tensor"]:
    """The tensors in a (nested) call result."""
    import torch

    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in _tensors(o)]
    return []


def open_region(spec: envspec.QuotaSpec) -> SharedRegion:
    """The region ``spec`` names, created with its limits if absent (the
    interposer seeds a new region with the same values)."""
    n = max([o for o in spec.hbm_limit_bytes if o >= 0], default=0) + 1
    limits = [spec.limit_for(i) for i in range(n)]
    return SharedRegion(spec.shared_cache or DEFAULT_REGION, limits=limits,
                        core_pcts=[spec.core_limit_pct] * n)


def _has_quota(spec: envspec.QuotaSpec) -> bool:
    return bool(spec.hbm_limit_bytes or spec.core_limit_pct)


def _ledger(region: SharedRegion, dev: int) -> Dict[str, Any]:
    """The region's view of ``dev``: cap, bytes charged by all processes
    and by this one, device time, live processes."""
    ds = region.device_stats(dev)
    mine = [p for p in region.proc_stats() if p.pid == os.getpid()]
    return {
        "limit_bytes": int(ds.limit_bytes),
        "used_bytes": int(ds.used_bytes),
        "proc_used_bytes": int(mine[0].used_bytes[dev]) if mine else 0,
        "busy_us": int(ds.busy_us),
        "proc_busy_us": int(mine[0].busy_us[dev]) if mine else 0,
        "active_procs": region.active_procs(),
    }


def region_ledger(dev: Optional[int] = None) -> Optional[Dict[str, Any]]:
    """The ledger of the region that the environment names, as
    ``TorchEnforcer.ledger`` gives it, read without taking a slot; None
    when the environment sets no quota."""
    spec = envspec.quota_from_env()
    if not _has_quota(spec):
        return None
    with open_region(spec) as region:
        n = region.ndevices
        return _ledger(region, dev if dev is not None and 0 <= dev < n
                       else 0)


class TorchEnforcer:
    """Shared-region accounting for one tenant process."""

    def __init__(self, spec: envspec.QuotaSpec,
                 env: Optional[Mapping[str, str]] = None):
        env = os.environ if env is None else env
        self.spec = spec
        self.region = open_region(spec)
        self.region.register()
        # Floor on the charged cost per call: keeps throttling meaningful
        # when measured times are tiny.
        self.min_cost_us = float(env.get(envspec.ENV_MIN_EXEC_COST, "0")
                                 or 0)
        self._cost_ema: Dict[int, float] = {}
        self._contention_at = 0.0
        self._contended = True
        self._leases: Dict[int, RateLease] = {}

    # -- lifecycle --
    def close(self) -> None:
        """Return unburned leases, leave the region and close it.  Charges
        still held are dropped by the native deregister."""
        if self.region.handle is None:
            return
        for lease in self._leases.values():
            lease.revoke()
        self.region.deregister()
        self.region.close()

    # -- devices --
    def clamp_dev(self, dev: Optional[int]) -> int:
        """Map an ordinal onto the region's device axis (out-of-range or
        None → 0, so a stray id can never fault the accounting)."""
        n = self.region.ndevices
        return dev if dev is not None and 0 <= dev < n else 0

    def dev_of(self, device) -> int:
        import torch

        return self.clamp_dev(torch.device(device).index)

    # -- memory --
    def charge(self, nbytes: int, dev: int = 0) -> None:
        """Admit ``nbytes`` on ``dev`` or raise ``MemoryError`` (or kill
        the process under ACTIVE_OOM_KILLER)."""
        ok = self.region.mem_acquire(dev, nbytes, self.spec.oversubscribe)
        if not ok:
            free, total = self.region.mem_info(dev)
            if self.spec.active_oom_killer:
                log.error("active OOM killer: quota exceeded on device %d",
                          dev)
                os.kill(os.getpid(), 9)
            raise MemoryError(
                f"RESOURCE_EXHAUSTED: vTPU device {dev} OOM: requested "
                f"{nbytes} bytes, quota {total} (free {free})")

    def release(self, nbytes: int, dev: int = 0) -> None:
        if self.region.handle is not None:
            self.region.mem_release(dev, nbytes)

    def track(self, tensor: "torch.Tensor", nbytes: int, dev: int) -> None:
        """Tie an admitted charge to ``tensor``'s lifetime."""
        weakref.finalize(tensor, self.release, nbytes, dev)

    def track_storage(self, tensor: "torch.Tensor", dev: int) -> int:
        """Charge the storage under ``tensor`` (admitted past the cap: it
        is allocated already) until the storage itself is freed, however
        many tensors view it and whichever of them outlives the others
        (``Module.to`` swaps a parameter's storage in place).  Returns
        the bytes charged."""
        storage = tensor.untyped_storage()
        nbytes = storage.nbytes()
        self.region.mem_acquire(dev, nbytes, True)
        weakref.finalize(storage, self.release, nbytes, dev)
        return nbytes

    def _admit_all(self, sizes: List[int], dev: int) -> None:
        """Admit every size or none: a refusal rolls back the earlier
        charges, or the quota would leak."""
        charged = 0
        try:
            for nbytes in sizes:
                self.charge(nbytes, dev)
                charged += nbytes
        except BaseException:
            self.release(charged, dev)
            raise

    def to_device(self, obj, device):
        """Copy a module's parameters and buffers (in place) or a tensor
        (returned) to ``device`` under admission: every byte is charged
        before any is allocated, and each charge is released when the
        tensor that holds it is collected."""
        import torch

        dev = self.dev_of(device)
        if isinstance(obj, torch.Tensor):
            self.charge(obj.nbytes, dev)
            try:
                with explicit():
                    out = obj.detach().to(device, copy=True)
            except BaseException:
                self.release(obj.nbytes, dev)
                raise
            self.track(out, obj.nbytes, dev)
            return out
        slots: List[Tuple[Any, str, Any, bool]] = []
        for mod in obj.modules():
            for name, t in mod._parameters.items():
                if t is not None:
                    slots.append((mod, name, t, True))
            for name, t in mod._buffers.items():
                if t is not None:
                    slots.append((mod, name, t, False))
        sizes = [t.nbytes for _, _, t, _ in slots]
        self._admit_all(sizes, dev)
        moved = []
        try:
            with explicit():
                for _, _, t, _ in slots:
                    moved.append(t.detach().to(device, copy=True))
        except BaseException:
            self.release(sum(sizes), dev)
            raise
        for (mod, name, t, is_param), new in zip(slots, moved):
            if is_param:
                new = torch.nn.Parameter(new, requires_grad=t.requires_grad)
                mod._parameters[name] = new
            else:
                mod._buffers[name] = new
            self.track(new, new.nbytes, dev)
        return obj

    # -- compute --
    def _gating_active(self) -> bool:
        """Policy switch: DISABLE never gates, FORCE always, DEFAULT only
        while another process shares the region."""
        policy = self.spec.utilization_policy
        if policy == "DISABLE":
            return False
        if policy == "FORCE":
            return True
        now = time.monotonic()
        if now - self._contention_at > _PROBE_S:
            self._contention_at = now
            self._contended = self.region.active_procs() > 1
        return self._contended

    def _lease(self, dev: int) -> RateLease:
        lease = self._leases.get(dev)
        if lease is None:
            lease = self._leases[dev] = RateLease(self.region, dev)
        return lease

    def gate(self, key: int, dev: int = 0) -> float:
        """Block per the token bucket; returns the cost estimate used
        (negative: ungated, skip the completion-time correction)."""
        est = max(self._cost_ema.get(key, _COST_SEED_US), self.min_cost_us)
        if not self._gating_active():
            return -est
        self._lease(dev).acquire(est, self.spec.task_priority)
        return est

    def observe(self, key: int, est: float, actual_us: float,
                dev: int = 0) -> None:
        self.region.busy_add(dev, int(actual_us))
        if est >= 0:
            # Only correct the bucket when the estimate was charged; an
            # ungated run must not bank debt against future co-tenants.
            charged = max(actual_us, self.min_cost_us)
            self.region.rate_adjust(dev, int(charged - est))
        prev = self._cost_ema.get(key)
        self._cost_ema[key] = (actual_us if prev is None else
                               prev * (1 - _EMA_NEW) + actual_us * _EMA_NEW)

    def gate_waits(self) -> int:
        """How many times a gated call has blocked in the token bucket."""
        return sum(lease.blocks for lease in self._leases.values())

    def gated(self, fn: Callable, compiled: bool = False) -> Callable:
        """``fn`` run under the device-time quota.  The device is that of
        the first tensor argument; the call is timed to completion on the
        card, and its outputs are charged (admitted past the cap: a
        finished call can neither be refused nor justify a kill) until
        they are collected.  A ``compiled`` callable (``torch.compile``'s,
        which compiles at its first call) runs its first call ungated and
        unbooked, so that compile time is not billed as device time.  A
        callable gated already is returned as it is."""
        import torch

        if getattr(fn, "_vtpu_gated", False):
            return fn
        key = id(fn)
        warm = [compiled]

        @functools.wraps(fn)
        def call(*args, **kwargs):
            first = next(iter(_tensors(list(args) + list(kwargs.values()))),
                         None)
            device = first.device if first is not None else None
            dev = self.clamp_dev(device.index if device is not None
                                 else None)
            if warm[0]:
                warm[0] = False
                out = fn(*args, **kwargs)
            else:
                est = self.gate(key, dev)
                t0 = time.monotonic()
                out = fn(*args, **kwargs)
                if device is not None and device.type == "cuda":
                    torch.cuda.synchronize(device)
                self.observe(key, est, (time.monotonic() - t0) * 1e6, dev)
            for t in _tensors(out):
                odev = self.clamp_dev(t.device.index)
                self.region.mem_acquire(odev, t.nbytes, True)
                self.track(t, t.nbytes, odev)
            return out

        call._vtpu_gated = True
        return call

    # -- introspection --
    def ledger(self, dev: int = 0) -> Dict[str, Any]:
        """The region's view of ``dev``: cap, bytes charged by all
        processes and by this one, device time, live processes."""
        return _ledger(self.region, dev)


def install_torch_enforcement(
        env: Optional[Mapping[str, str]] = None) -> Optional[TorchEnforcer]:
    """The enforcer for the quota that ``env`` (default ``os.environ``)
    sets, or None when it sets neither an HBM nor a compute limit, or
    when the native interposer is in this process and enforces it.  In a
    process that ``install_py_enforcement`` has set up, its enforcer."""
    if env is None and _enforcer is not None:
        return _enforcer
    spec = envspec.quota_from_env(env)
    if not _has_quota(spec):
        return None
    if interposer.loaded():
        log.info("libvtpu_cuda interposer loaded: it enforces the quota "
                 "natively; no in-process enforcer")
        return None
    enf = TorchEnforcer(spec, env)
    log.info("torch quota enforcement installed (limits=%s, core=%d%%)",
             spec.hbm_limit_bytes, spec.core_limit_pct)
    return enf


# -- the in-container bootstrap -----------------------------------------------

_local = threading.local()
_enforcer: Optional[TorchEnforcer] = None


@contextlib.contextmanager
def explicit():
    """A block whose caller admits its transfers itself
    (``TorchEnforcer.charge``/``track``, ``to_device``): the patched
    ``.to``/``.cuda`` pass them through, so nothing is charged twice."""
    _local.depth = getattr(_local, "depth", 0) + 1
    try:
        yield
    finally:
        _local.depth -= 1


def bootstrap() -> Optional[str]:
    """Which layer enforces this process's quota, logged: "interposer"
    when ``libvtpu_cuda.so`` is in the process, "python" when it is left
    to ``install_py_enforcement``, None when the environment sets no
    quota.  The container runtime filters the cards a container sees
    (``NVIDIA_VISIBLE_DEVICES``), so nothing else is set up here:
    ``vtpu``'s ``TPU_VISIBLE_CHIPS`` step has no counterpart."""
    spec = envspec.quota_from_env()
    if not _has_quota(spec):
        return None
    if interposer.loaded():
        log.info("shim bootstrap: the libvtpu_cuda interposer enforces the "
                 "quota (limits=%s, core=%d%%)", spec.hbm_limit_bytes,
                 spec.core_limit_pct)
        return "interposer"
    log.info("shim bootstrap: no interposer in this process; the quota "
             "(limits=%s, core=%d%%) is left to the python enforcement",
             spec.hbm_limit_bytes, spec.core_limit_pct)
    return "python"


class _AfterImport(importlib.abc.MetaPathFinder):
    """Runs ``then()`` once, right after the module ``name`` is first
    imported, whoever imports it."""

    def __init__(self, name: str, then: Callable[[], None]):
        self.name, self.then = name, then

    def find_spec(self, fullname, path=None, target=None):
        if fullname != self.name:
            return None
        sys.meta_path.remove(self)
        spec = importlib.util.find_spec(fullname)
        if spec is None or spec.loader is None:
            return spec
        exec_module = spec.loader.exec_module

        def run(module):
            exec_module(module)
            self.then()

        spec.loader.exec_module = run
        return spec


def install_py_enforcement(device: str = "cuda") -> bool:
    """Route torch's own transfers and compiled calls through one
    enforcer for this process; True when it is installed, or will be
    when the process imports torch.

    It installs only when the environment sets a quota and the native
    interposer is not in the process: under the interposer the quota is
    enforced there, and charging it here too would count every byte
    twice.  In a process that has not imported torch it waits for that
    import, so that a Python process of the container that never uses
    torch (``vtpu-smi``, a shell tool) neither imports it nor takes a
    slot in the region.  ``device`` is the device type it guards: the
    card, or the CPU when a caller asks for it (as every entry point of
    the port does).  What it routes, the torch form of ``vtpu``'s
    patched ``jax.device_put`` and ``jax.jit``:

    - ``Tensor.to``, ``Tensor.cuda``, ``Module.to`` and ``Module.cuda``
      when they name the guarded device: the bytes they will copy are
      admitted first (all of a module's or none, refused with
      ``MemoryError`` before anything is allocated), and each storage the
      call made is charged until it is freed (a cast or ``copy=True``
      that names the guarded device makes a storage there too).  A call
      that names no device (a dtype cast), names another, or copies
      nothing passes through uncharged, as do subclasses of Tensor (the
      fake tensors of ``torch.compile``'s tracing, DTensor) and calls
      traced by ``torch.compile``.
    - ``torch.compile``: the callable it returns (for a module, its
      ``forward``) is ``TorchEnforcer.gated``, with its first, compiling
      call left ungated.
    """
    global _enforcer
    if _enforcer is not None or any(isinstance(f, _AfterImport)
                                    for f in sys.meta_path):
        return True
    spec = envspec.quota_from_env()
    if not _has_quota(spec) or interposer.loaded():
        return False
    if "torch" not in sys.modules:
        sys.meta_path.insert(0, _AfterImport(
            "torch", lambda: install_py_enforcement(device)))
        return True

    import torch

    guarded = torch.device(device).type
    enf = TorchEnforcer(spec)
    plain = (torch.Tensor, torch.nn.Parameter)
    real_to, real_cuda = torch.Tensor.to, torch.Tensor.cuda
    real_module_to, real_module_cuda = torch.nn.Module.to, torch.nn.Module.cuda
    real_compile = torch.compile

    def unrouted() -> bool:
        return torch.compiler.is_compiling() or getattr(_local, "depth", 0)

    def dest_of(device) -> Optional[torch.device]:
        """``device`` with its index when it is of the guarded type."""
        if device is None:
            return None
        if isinstance(device, int):
            device = torch.device("cuda", device)
        d = torch.device(device)
        if d.type != guarded:
            return None
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        return d

    def parse(args, kwargs):
        """(device, dtype, copy) that ``Tensor.to``'s arguments name."""
        kw = dict(kwargs)
        copy = bool(kw.pop("copy", False))
        try:
            return (*torch._C._nn._parse_to(*args, **kw)[:2], copy)
        except (RuntimeError, TypeError):
            if not args:
                raise
            # copy given by position, after the arguments _parse_to takes
            return (*torch._C._nn._parse_to(*args[:-1], **kw)[:2],
                    bool(args[-1]))

    def copy_bytes(t, dest, dtype, copy=False) -> int:
        """The bytes a move of ``t`` to ``dest`` as ``dtype`` allocates
        (0 when it is there already and no copy is asked for)."""
        cast = dtype is not None and dtype != t.dtype
        if t.device == dest and not cast and not copy:
            return 0
        return t.numel() * (dtype.itemsize if cast else t.element_size())

    def moved(t, dest, dtype, call, copy=False):
        dev = enf.clamp_dev(dest.index)
        need = copy_bytes(t, dest, dtype, copy)
        enf.charge(need, dev)
        try:
            out = call()
        except BaseException:
            enf.release(need, dev)
            raise
        if out.untyped_storage().data_ptr() != t.untyped_storage().data_ptr():
            enf.track_storage(out, dev)
        enf.release(need, dev)
        return out

    def tensors_of(mod):
        """A module's parameters and buffers by name, shared ones once."""
        return {name: t for name, t in itertools.chain(
            mod.named_parameters(), mod.named_buffers())
            if t.layout == torch.strided}

    def module_moved(mod, dest, dtype, call):
        dev = enf.clamp_dev(dest.index)
        tensors = tensors_of(mod)
        # By name: a storage the move frees can be reused at once, so an
        # address seen before the move may be a new storage after it.
        before = {n: t.untyped_storage().data_ptr()
                  for n, t in tensors.items()}
        need = sum(copy_bytes(t, dest, dtype if t.is_floating_point()
                              or t.is_complex() else None)
                   for t in tensors.values())
        enf.charge(need, dev)
        try:
            with explicit():
                out = call()
        except BaseException:
            enf.release(need, dev)
            raise
        charged = set()
        for name, t in tensors_of(mod).items():
            ptr = t.untyped_storage().data_ptr()
            if t.device.type == guarded and ptr != before.get(name) \
                    and ptr not in charged:
                charged.add(ptr)
                enf.track_storage(t, dev)
        enf.release(need, dev)
        return out

    @functools.wraps(real_to)
    def tensor_to(self, *args, **kwargs):
        if unrouted() or type(self) not in plain \
                or self.layout != torch.strided:
            return real_to(self, *args, **kwargs)
        try:
            device, dtype, copy = parse(args, kwargs)
        except (RuntimeError, TypeError):
            return real_to(self, *args, **kwargs)   # raises torch's error
        dest = dest_of(device)
        if dest is None:
            return real_to(self, *args, **kwargs)
        return moved(self, dest, dtype,
                     lambda: real_to(self, *args, **kwargs), copy)

    @functools.wraps(real_cuda)
    def tensor_cuda(self, *args, **kwargs):
        dest = None
        if not (unrouted() or type(self) not in plain
                or self.layout != torch.strided):
            d = args[0] if args else kwargs.get("device")
            dest = dest_of("cuda" if d is None else d)
        if dest is None or dest.type != "cuda":
            return real_cuda(self, *args, **kwargs)
        return moved(self, dest, None,
                     lambda: real_cuda(self, *args, **kwargs))

    @functools.wraps(real_module_to)
    def module_to(self, *args, **kwargs):
        dest = dtype = None
        if not unrouted():
            try:
                device, dtype = torch._C._nn._parse_to(*args, **kwargs)[:2]
                dest = dest_of(device)
            except (RuntimeError, TypeError):
                pass   # the call below raises torch's error
        if dest is None:
            return real_module_to(self, *args, **kwargs)
        return module_moved(self, dest, dtype,
                            lambda: real_module_to(self, *args, **kwargs))

    @functools.wraps(real_module_cuda)
    def module_cuda(self, device=None):
        dest = None if unrouted() else dest_of(
            "cuda" if device is None else device)
        if dest is None or dest.type != "cuda":
            return real_module_cuda(self, device)
        return module_moved(self, dest, None,
                            lambda: real_module_cuda(self, device))

    @functools.wraps(real_compile)
    def compile(model=None, **kwargs):
        if model is None:   # @torch.compile(mode=...)
            return lambda m: compile(m, **kwargs)
        out = real_compile(model, **kwargs)
        if isinstance(out, torch.nn.Module):
            out.forward = enf.gated(out.forward, compiled=True)
            return out
        return enf.gated(out, compiled=True)

    torch.Tensor.to, torch.Tensor.cuda = tensor_to, tensor_cuda
    torch.nn.Module.to, torch.nn.Module.cuda = module_to, module_cuda
    torch.compile = compile
    _enforcer = enf
    log.info("python quota enforcement installed on %s (limits=%s, "
             "core=%d%%)", guarded, spec.hbm_limit_bytes,
             spec.core_limit_pct)
    return True


def enforcer() -> Optional[TorchEnforcer]:
    """The enforcer ``install_py_enforcement`` installed, or None."""
    return _enforcer
