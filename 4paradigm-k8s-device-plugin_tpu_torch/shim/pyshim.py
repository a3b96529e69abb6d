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

A libcuda interposer that enforces without the tenant's cooperation is
a later slice.
"""

from __future__ import annotations

import functools
import os
import time
import weakref
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

from ..utils import envspec
from ..utils import logging as log
from .core import RateLease, SharedRegion

DEFAULT_REGION = "/tmp/vtpushr.cache"
# Seed of the per-function device-time estimate (µs) before any
# measurement, and the weight of the newest sample in its EMA.
_COST_SEED_US = 5000.0
_EMA_NEW = 0.3
# How long the DEFAULT policy trusts one contention probe (s).
_PROBE_S = 0.1


def _tensors(obj) -> List[torch.Tensor]:
    """The tensors in a (nested) call result."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in _tensors(o)]
    return []


class TorchEnforcer:
    """Shared-region accounting for one tenant process."""

    def __init__(self, spec: envspec.QuotaSpec,
                 env: Optional[Mapping[str, str]] = None):
        env = os.environ if env is None else env
        self.spec = spec
        n = max([o for o in spec.hbm_limit_bytes if o >= 0], default=0) + 1
        limits = [spec.limit_for(i) for i in range(n)]
        pcts = [spec.core_limit_pct] * n
        self.region = SharedRegion(spec.shared_cache or DEFAULT_REGION,
                                   limits=limits, core_pcts=pcts)
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

    def track(self, tensor: torch.Tensor, nbytes: int, dev: int) -> None:
        """Tie an admitted charge to ``tensor``'s lifetime."""
        weakref.finalize(tensor, self.release, nbytes, dev)

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
        dev = self.dev_of(device)
        if isinstance(obj, torch.Tensor):
            self.charge(obj.nbytes, dev)
            try:
                out = obj.detach().to(device, copy=True)
            except BaseException:
                self.release(obj.nbytes, dev)
                raise
            self.track(out, obj.nbytes, dev)
            return out
        slots: List[Tuple[torch.nn.Module, str, torch.Tensor, bool]] = []
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

    def gated(self, fn: Callable) -> Callable:
        """``fn`` run under the device-time quota.  The device is that of
        the first tensor argument; the call is timed to completion on the
        card, and its outputs are charged (admitted past the cap: a
        finished call can neither be refused nor justify a kill) until
        they are collected."""
        key = id(fn)

        @functools.wraps(fn)
        def call(*args, **kwargs):
            first = next(iter(_tensors(list(args) + list(kwargs.values()))),
                         None)
            device = first.device if first is not None else None
            dev = self.clamp_dev(device.index if device is not None
                                 else None)
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

        return call

    # -- introspection --
    def ledger(self, dev: int = 0) -> Dict[str, Any]:
        """The region's view of ``dev``: cap, bytes charged by all
        processes and by this one, device time, live processes."""
        ds = self.region.device_stats(dev)
        mine = [p for p in self.region.proc_stats() if p.pid == os.getpid()]
        return {
            "limit_bytes": int(ds.limit_bytes),
            "used_bytes": int(ds.used_bytes),
            "proc_used_bytes": int(mine[0].used_bytes[dev]) if mine else 0,
            "busy_us": int(ds.busy_us),
            "proc_busy_us": int(mine[0].busy_us[dev]) if mine else 0,
            "active_procs": self.region.active_procs(),
        }


def install_torch_enforcement(
        env: Optional[Mapping[str, str]] = None) -> Optional[TorchEnforcer]:
    """The enforcer for the quota that ``env`` (default ``os.environ``)
    sets, or None when it sets neither an HBM nor a compute limit."""
    spec = envspec.quota_from_env(env)
    if not spec.hbm_limit_bytes and not spec.core_limit_pct:
        return None
    enf = TorchEnforcer(spec, env)
    log.info("torch quota enforcement installed (limits=%s, core=%d%%)",
             spec.hbm_limit_bytes, spec.core_limit_pct)
    return enf
