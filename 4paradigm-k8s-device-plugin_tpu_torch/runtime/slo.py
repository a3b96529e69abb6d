"""The always-on per-tenant SLO, fairness and noisy-neighbour plane.

The port of ``vtpu.runtime.slo``, whole: the same sketches, the same
arithmetic, the same JSON.  For the same samples a sketch here holds the
same buckets as ``vtpu``'s, and an ``export_state`` of one package is
``restore``d by the other (the journal's ``slo`` records cross both ways).
The plane is on by default (``VTPU_SLO=1``); ``0`` removes every hot-path
touch.

  - **Mergeable quantile sketches.**  Per tenant and phase (queue,
    bucket wait, device, end to end) DDSketch-style sketches:
    logarithmic buckets with relative accuracy ``alpha``, a hard cap on
    the bucket count (the lowest buckets collapse under pressure), O(1)
    insert, exact counts and sums, an associative ``merge``.
  - **Noisy-neighbour blame.**  Each request's queue and bucket wait is
    attributed to the co-tenants whose device time advanced during the
    wait, in proportion.  Conservation holds by construction: the blamed
    shares of one request are a normalised split of its measured wait,
    so a tenant's blame row sums to its measured wait (a wait with no
    co-tenant activity is blamed on ``(self)``).
  - **Objectives and burn rates.**  A latency target and a throughput
    floor per tenant (HELLO's ``slo_target_us``/``slo_floor_steps``, sent
    by the client from the Allocate env ``VTPU_SLO_TARGET_US``/
    ``VTPU_SLO_FLOOR_STEPS``; else a target from the quota share),
    attainment and burn rates over several windows, and attained share
    against quota share with Jain's index.

The plane is fed by the broker's metering threads only, never by a
dispatcher: ``runtime/server.py``'s ``DeviceScheduler._meter_batch`` for
the socket path and ``runtime/fastlane.py``'s ``meter_batch`` for a lane.
Each retired item stages one flat row ``[dt_enq_s, bucket_wait_us,
dt_disp_s, steps]`` (``stage_batch``), and ``_phase_cols`` turns rows into
phases at ingest: total ``dt_enq``, bucket ``min(bucket_wait, total)``,
queue ``dt_enq - dt_disp - bucket``, device ``dt_disp``.

**What is CUDA's: a batch's device time is split among its items.**  The
port's dispatcher records one CUDA event after each dispatch batch (one
per item only while ``VTPU_TRACE=1``), so with tracing off no item has a
completion of its own.  The metering thread splits the batch's window,
from its first item's dispatch to the batch's observed completion, among
the batch's items in proportion to what billing charges each
(``busy_us``, the metering rule ``busy = min(t_obs - prev_obs, t_obs - t0
- L)`` and its sparse and first-run arms, ``split_batch_window``); item i
is ready when the shares of items 1..i have run, so the last is ready at
the observation.  From that ready time the item's phases partition its
time in the broker: total = ready - enqueue, bucket = min(bucket wait,
total), queue = min(dispatch - enqueue - bucket, total - bucket) (at
least 0), device = total - bucket - queue.  The row staged for it is
``[total, bucket, device]`` in the units above, so queue + bucket +
device = total for every item up to float rounding.  A lane batch is
split the same way by estimate (the rule ``meter_batch`` bills and
teaches its routes with), each item's total running from its client's
submit stamp to the batch's observed completion.

Export is three-way: the bind-free ``SLO`` verb (a tenant connection sees
its own row, the admin socket the matrix), Prometheus histograms and
fairness gauges with trace-id exemplars (``tools/metrics_server.py
--broker``), and the pod's metricsd view.  ``vtpu-smi top`` renders the
live table.

Stdlib and numpy only (``python -m vtpu_torch.runtime.slo --smoke`` runs
the 64-tenant fairness smoke without torch).
"""

from __future__ import annotations

import collections
import json
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

# Optional bulk-ingest acceleration: the broker always has numpy; the
# stdlib-only consumers (analyze-job smoke, bench fallback) fall back
# to the per-value loop transparently.
try:
    import numpy as _np
except ImportError:  # pragma: no cover - broker images carry numpy
    _np = None

# One scheduler quantum (µs) — mirrors runtime/server.py
# SCHED_QUANTUM_US (imported there; duplicated here so this module
# stays import-light for the stdlib-only analyze smoke).
_QUANTUM_US = 100_000.0

PHASES = ("queue", "bucket", "device", "e2e")
# Blame bucket for wait with no co-tenant activity (the tenant's own
# queue depth / bucket level caused it).
SELF_BLAME = "(self)"


# -- env knobs -------------------------------------------------------------


def slo_enabled() -> bool:
    """VTPU_SLO=0 removes every hot-path touch (the A/B surface the
    bench overhead gate drives).  Default ON: the plane is the
    always-on substrate, unlike opt-in vtpu-trace."""
    return os.environ.get("VTPU_SLO", "1").strip() not in ("", "0")


def sketch_alpha() -> float:
    """Relative accuracy of the quantile sketches (DDSketch alpha)."""
    try:
        a = float(os.environ.get("VTPU_SLO_ALPHA", "0.02"))
    except ValueError:
        a = 0.02
    return min(max(a, 0.001), 0.25)


def sketch_max_buckets() -> int:
    """Hard memory cap per sketch (buckets); lowest buckets collapse
    past it, so a tenant's telemetry footprint is bounded for life."""
    try:
        return max(int(os.environ.get("VTPU_SLO_BUCKETS", "512")), 16)
    except ValueError:
        return 512


def slo_windows_s() -> Tuple[float, ...]:
    """Burn-rate windows, seconds (short first — the paging window)."""
    raw = os.environ.get("VTPU_SLO_WINDOWS", "300,3600")
    out: List[float] = []
    for tok in raw.replace(",", " ").split():
        try:
            v = float(tok)
        except ValueError:
            continue
        if v > 0:
            out.append(v)
    return tuple(out) or (300.0, 3600.0)


def slo_budget() -> float:
    """Error budget: the tolerated fraction of requests over the
    latency target.  burn_rate = violation_rate / budget."""
    try:
        b = float(os.environ.get("VTPU_SLO_BUDGET", "0.01"))
    except ValueError:
        b = 0.01
    return min(max(b, 1e-6), 1.0)


def burn_alert_threshold() -> float:
    """Short-window burn rate at which the alert flag fires."""
    try:
        return max(float(os.environ.get("VTPU_SLO_BURN_ALERT", "10")),
                   1.0)
    except ValueError:
        return 10.0


def journal_period_s() -> float:
    """How often the broker journals each tenant's sketch state so a
    crashed broker's successor resumes attainment history (0 disables
    the periodic records; the snapshot still carries them)."""
    try:
        return float(os.environ.get("VTPU_SLO_JOURNAL_S", "5"))
    except ValueError:
        return 5.0


def default_target_us(quota_pct: int) -> float:
    """Latency objective derived from the quota share when the grant
    declares none: two scheduler quanta divided by the share — a 50%
    tenant defaults to 400ms end-to-end, an unmetered tenant to two
    quanta.  Deliberately loose: a default must flag starvation, not
    page on honest queueing."""
    share = quota_pct / 100.0 if quota_pct and quota_pct > 0 else 1.0
    return 2.0 * _QUANTUM_US / max(share, 0.01)


# -- the port's split of a batch's device window ----------------------------


def split_batch_window(t_first: float, t_obs: float,
                       weights: List[float]) -> List[float]:
    """Ready times of a batch's items when only the batch's completion
    was observed: the window from ``t_first`` (its first dispatch) to
    ``t_obs`` split in proportion to ``weights`` (what billing charged
    each item; equal shares when they sum to 0).  The last item is ready
    at ``t_obs``."""
    n = len(weights)
    span = max(t_obs - t_first, 0.0)
    total = 0.0
    for w in weights:
        if w > 0.0:
            total += w
    out: List[float] = []
    acc = 0.0
    for i, w in enumerate(weights):
        acc += (max(w, 0.0) / total) if total > 0.0 else 1.0 / n
        out.append(t_obs if i == n - 1 else t_first + span * min(acc, 1.0))
    return out


def item_phases(t_enq: float, t_disp: float, t_ready: float,
                bucket_wait_us: float) -> Tuple[float, float, float, float]:
    """(queue, bucket, device, total) µs of one item from its monotonic
    enqueue, dispatch and ready times: a partition of its total by
    construction (the device phase takes what the others leave)."""
    total = max(t_ready - t_enq, 0.0) * 1e6
    bucket = min(max(float(bucket_wait_us), 0.0), total)
    queue = min(max((t_disp - t_enq) * 1e6 - bucket, 0.0), total - bucket)
    return queue, bucket, total - bucket - queue, total


def stage_row(queue: float, bucket: float, device: float, total: float,
              steps: int) -> Tuple[float, float, float, int]:
    """The flat row ``stage_batch`` takes for phases already split:
    ``_phase_cols`` reads back the same queue, bucket and device."""
    return total / 1e6, bucket, device / 1e6, steps


# -- mergeable quantile sketch --------------------------------------------


class QuantileSketch:
    """DDSketch-style mergeable quantile sketch (Masson et al.): value
    ``v`` lands in bucket ``ceil(log_gamma(v))`` with
    ``gamma = (1+alpha)/(1-alpha)``, so any reported quantile is within
    relative error ``alpha`` of the true value (while the bucket cap is
    not breached; past it the LOWEST buckets collapse — tail quantiles
    stay accurate, which is the half SLOs care about).  O(1) insert
    (one ``math.log``), fixed-memory, associative merge."""

    __slots__ = ("alpha", "gamma", "_inv_log_gamma", "max_buckets",
                 "count", "sum", "min", "max", "zero", "buckets")

    def __init__(self, alpha: Optional[float] = None,
                 max_buckets: Optional[int] = None):
        self.alpha = sketch_alpha() if alpha is None else float(alpha)
        self.gamma = (1.0 + self.alpha) / (1.0 - self.alpha)
        self._inv_log_gamma = 1.0 / math.log(self.gamma)
        self.max_buckets = (sketch_max_buckets() if max_buckets is None
                            else max(int(max_buckets), 2))
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = 0.0
        self.zero = 0            # values <= 0 (or sub-resolution)
        self.buckets: Dict[int, int] = {}

    # -- write --

    def add(self, v: float, n: int = 1) -> None:
        v = float(v)
        self.count += n
        self.sum += v * n
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= 0.0:
            self.zero += n
            return
        key = math.ceil(math.log(v) * self._inv_log_gamma)
        b = self.buckets
        b[key] = b.get(key, 0) + n
        if len(b) > self.max_buckets:
            self._collapse()

    def _collapse(self) -> None:
        """Fold the lowest bucket into its neighbour (smallest values
        lose resolution first; SLO tails keep theirs)."""
        keys = sorted(self.buckets)
        k0, k1 = keys[0], keys[1]
        self.buckets[k1] = self.buckets[k1] + self.buckets.pop(k0)

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Associative, commutative merge (same gamma required)."""
        if abs(other.gamma - self.gamma) > 1e-9:
            raise ValueError("cannot merge sketches of different alpha")
        self.count += other.count
        self.sum += other.sum
        self.zero += other.zero
        if other.count:
            self.min = min(self.min, other.min)
            self.max = max(self.max, other.max)
        for k, c in other.buckets.items():
            self.buckets[k] = self.buckets.get(k, 0) + c
        while len(self.buckets) > self.max_buckets:
            self._collapse()
        return self

    # -- read --

    def value_of(self, key: int) -> float:
        """Representative value of a bucket (within alpha of every
        member): 2*gamma^key/(gamma+1)."""
        return 2.0 * (self.gamma ** key) / (self.gamma + 1.0)

    def quantile(self, q: float) -> float:
        if self.count <= 0:
            return 0.0
        q = min(max(q, 0.0), 1.0)
        rank = q * (self.count - 1)
        if rank < self.zero:
            return 0.0
        cum = self.zero
        for key in sorted(self.buckets):
            cum += self.buckets[key]
            if cum > rank:
                return self.value_of(key)
        return self.max

    def bucket_bounds(self, per_doubling: bool = True
                      ) -> List[Tuple[float, int]]:
        """Cumulative (le_upper_bound, cumulative_count) pairs on a
        ~2x-spaced grid ANCHORED AT KEY 0, for Prometheus histogram
        export: bounds depend only on alpha (not on the data), so a
        series' ``le`` set is stable across scrapes and tenants."""
        if not self.buckets:
            return []
        stride = max(int(round(math.log(2.0) / math.log(self.gamma))), 1) \
            if per_doubling else 1
        groups: Dict[int, int] = {}
        for key, c in self.buckets.items():
            groups[key // stride] = groups.get(key // stride, 0) + c
        out: List[Tuple[float, int]] = []
        cum = self.zero
        for g in sorted(groups):
            cum += groups[g]
            le = self.gamma ** ((g + 1) * stride)
            out.append((le, cum))
        return out

    # -- wire / journal --

    def to_dict(self) -> Dict[str, Any]:
        return {
            "alpha": self.alpha,
            "count": self.count,
            "sum": round(self.sum, 3),
            "min": (None if self.count == 0 else round(self.min, 3)),
            "max": round(self.max, 3),
            "zero": self.zero,
            "buckets": {str(k): c for k, c in self.buckets.items()},
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any],
                  max_buckets: Optional[int] = None) -> "QuantileSketch":
        sk = cls(alpha=float(d.get("alpha", 0.02)),
                 max_buckets=max_buckets)
        sk.count = int(d.get("count", 0))
        sk.sum = float(d.get("sum", 0.0))
        mn = d.get("min")
        sk.min = math.inf if mn is None else float(mn)
        sk.max = float(d.get("max", 0.0))
        sk.zero = int(d.get("zero", 0))
        for k, c in (d.get("buckets") or {}).items():
            sk.buckets[int(k)] = int(c)
        while len(sk.buckets) > sk.max_buckets:
            sk._collapse()
        return sk


# -- burn-rate windows ----------------------------------------------------


class _Ring:
    """One sliding window as a ring of coarse slots: O(1) note, O(slots)
    read, fixed memory.  Slots are stamped with their absolute index so
    stale slots age out without a sweeper thread."""

    __slots__ = ("window_s", "granularity", "slots", "data", "stamp")

    N_SLOTS = 30

    def __init__(self, window_s: float):
        self.window_s = float(window_s)
        self.slots = self.N_SLOTS
        self.granularity = self.window_s / self.slots
        # count, violations, steps, device_us per slot
        self.data = [[0, 0, 0, 0.0] for _ in range(self.slots)]
        self.stamp = [-1] * self.slots

    def note(self, now: float, viol: int, steps: int,
             device_us: float, n: int = 1) -> None:
        idx = int(now / self.granularity)
        s = idx % self.slots
        if self.stamp[s] != idx:
            self.stamp[s] = idx
            self.data[s] = [0, 0, 0, 0.0]
        d = self.data[s]
        d[0] += n
        d[1] += viol
        d[2] += steps
        d[3] += device_us

    def totals(self, now: float) -> Tuple[int, int, int, float]:
        idx = int(now / self.granularity)
        c = v = s = 0
        du = 0.0
        for i in range(self.slots):
            st = self.stamp[i]
            if st >= 0 and 0 <= idx - st < self.slots:
                d = self.data[i]
                c += d[0]
                v += d[1]
                s += d[2]
                du += d[3]
        return c, v, s, du


# -- per-tenant row -------------------------------------------------------


class _TenantSlo:
    """One tenant's SLO state: 4 sketches, burn windows, blame row,
    objective.  All mutation happens under the plane's lock."""

    __slots__ = ("phases", "windows", "target_us", "floor_steps_s",
                 "target_explicit", "quota_pct", "blame", "wait_us",
                 "blamed_us", "exemplars", "violations_total",
                 "restored_n")

    def __init__(self, alpha: float, max_buckets: int,
                 window_lengths: Tuple[float, ...]):
        self.phases: Dict[str, QuantileSketch] = {
            p: QuantileSketch(alpha=alpha, max_buckets=max_buckets)
            for p in PHASES}
        self.windows: Dict[float, _Ring] = {
            w: _Ring(w) for w in window_lengths}
        self.target_us = default_target_us(0)
        self.floor_steps_s = 0.0
        self.target_explicit = False
        self.quota_pct = 0
        # culprit -> cumulative blamed wait µs; conservation:
        # sum(blame.values()) == blamed_us == wait_us (fp-exact split).
        self.blame: Dict[str, float] = {}
        self.wait_us = 0.0
        self.blamed_us = 0.0
        # Prometheus exemplars: bucket-group -> (value_us, trace_id,
        # wall_ts); bounded, replace-on-write.
        self.exemplars: Dict[int, Tuple[float, str, float]] = {}
        self.violations_total = 0
        # e2e request count carried in by a journal restore (0 for a
        # fresh row): the crash-survival evidence the chaos driver
        # judges directly — immune to the dispatch-ahead metering lag
        # that makes live counts race client-side step counters.
        self.restored_n = 0


class SloPlane:
    """The broker's always-on SLO/fairness/blame accounting.

    Thread-safe; ``record`` takes only the plane's own lock (declared a
    leaf in the server's lock-order ground truth — callers may hold no
    broker lock, and the plane never calls back out).  Disabled
    (``VTPU_SLO=0``) every method is a cheap no-op — the A/B surface
    the bench overhead gate drives."""

    MAX_BLAME_ENTRIES = 24   # per victim; smallest collapse into other
    OTHER_BLAME = "(other)"
    MAX_EXEMPLARS = 16

    def __init__(self, enabled: Optional[bool] = None,
                 alpha: Optional[float] = None,
                 max_buckets: Optional[int] = None,
                 windows: Optional[Tuple[float, ...]] = None,
                 budget: Optional[float] = None,
                 burn_alert: Optional[float] = None):
        self.enabled = slo_enabled() if enabled is None else bool(enabled)
        self.alpha = sketch_alpha() if alpha is None else float(alpha)
        self.max_buckets = (sketch_max_buckets() if max_buckets is None
                            else int(max_buckets))
        self.window_lengths = (slo_windows_s() if windows is None
                               else tuple(windows))
        self.budget = slo_budget() if budget is None else float(budget)
        self.burn_alert = (burn_alert_threshold() if burn_alert is None
                           else float(burn_alert))
        self.mu = threading.Lock()
        self._tenants: Dict[str, _TenantSlo] = {}
        self._journal_ts = 0.0
        # Staged batches awaiting bulk ingestion (the hot path's budget):
        # the metering thread parks a whole retired
        # batch's numeric rows with ONE deque append, and ingestion
        # folds them into the sketches in bulk (numpy when available)
        # once enough accumulate — or lazily on any read, so readers
        # always see every retired request.  This is what keeps the
        # always-on plane under the bench's <3% steps/s budget: the
        # per-request touch is a tuple append, never a sketch insert.
        self._pending: "collections.deque" = collections.deque()
        self._pending_n = 0

    # -- row lifecycle --

    def _row(self, tenant: str) -> _TenantSlo:
        row = self._tenants.get(tenant)
        if row is None:
            row = _TenantSlo(self.alpha, self.max_buckets,
                             self.window_lengths)
            self._tenants[tenant] = row
        return row

    def ensure_tenant(self, tenant: str, quota_pct: int = 0,
                      target_us: Optional[float] = None,
                      floor_steps_s: Optional[float] = None) -> None:
        """Seed/refresh a tenant's objective at HELLO: an explicit
        grant value wins for the tenant's lifetime (first HELLO wins,
        like the hbm/core grant); otherwise the target defaults from
        the quota share and tracks RESIZE."""
        if not self.enabled:
            return
        with self.mu:
            row = self._row(tenant)
            row.quota_pct = int(quota_pct or 0)
            if target_us is not None and not row.target_explicit:
                try:
                    row.target_us = max(float(target_us), 1.0)
                    row.target_explicit = True
                except (TypeError, ValueError):
                    pass
            elif not row.target_explicit:
                row.target_us = default_target_us(row.quota_pct)
            if floor_steps_s is not None:
                try:
                    row.floor_steps_s = max(float(floor_steps_s), 0.0)
                except (TypeError, ValueError):
                    pass

    def set_quota_pct(self, tenant: str, quota_pct: int) -> None:
        """RESIZE re-derives the default objective (explicit targets
        are the operator's word and stay)."""
        if not self.enabled:
            return
        with self.mu:
            row = self._tenants.get(tenant)
            if row is None:
                return
            row.quota_pct = int(quota_pct or 0)
            if not row.target_explicit:
                row.target_us = default_target_us(row.quota_pct)

    def forget(self, tenant: str) -> None:
        """Tenant torn down: a reused name is a NEW tenant whose
        attainment history must start at zero (same rule as the flight
        recorder)."""
        if not self.enabled:
            return
        self.ingest_pending()
        with self.mu:
            self._tenants.pop(tenant, None)

    # -- the write path (metering/retire thread) --

    def record(self, tenant: str, queue_us: float, bucket_us: float,
               device_us: float, total_us: float, steps: int = 1,
               ok: bool = True,
               wait_weights: Optional[Dict[str, float]] = None,
               trace_id: Optional[str] = None,
               now: Optional[float] = None,
               wall_ts: Optional[float] = None) -> None:
        """Fold one retired request into the plane: O(1) sketch inserts,
        one window note, one normalized blame split.  ``wait_weights``
        is {co-tenant: device µs it consumed during this request's
        broker residency} — the blame denominators."""
        if not self.enabled:
            return
        if now is None:
            now = time.monotonic()
        wait = max(queue_us, 0.0) + max(bucket_us, 0.0)
        with self.mu:
            row = self._row(tenant)
            ph = row.phases
            ph["queue"].add(queue_us)
            ph["bucket"].add(bucket_us)
            ph["device"].add(device_us)
            ph["e2e"].add(total_us)
            viol = 1 if (not ok or total_us > row.target_us) else 0
            row.violations_total += viol
            for ring in row.windows.values():
                ring.note(now, viol, steps, device_us)
            # -- blame split (conservation by construction) --
            if wait > 0.0:
                row.wait_us += wait
                total_w = 0.0
                if wait_weights:
                    for w in wait_weights.values():
                        if w > 0.0:
                            total_w += w
                if total_w > 0.0:
                    blame = row.blame
                    for name, w in wait_weights.items():
                        if w <= 0.0:
                            continue
                        blame[name] = blame.get(name, 0.0) \
                            + wait * (w / total_w)
                    if len(blame) > self.MAX_BLAME_ENTRIES:
                        self._collapse_blame(blame)
                else:
                    row.blame[SELF_BLAME] = \
                        row.blame.get(SELF_BLAME, 0.0) + wait
                row.blamed_us += wait
            # -- exemplar (trace-id linkage into the flight recorder) --
            if trace_id and total_us > 0.0:
                sk = ph["e2e"]
                stride = max(int(round(math.log(2.0)
                                       / math.log(sk.gamma))), 1)
                key = math.ceil(math.log(total_us)
                                * sk._inv_log_gamma) // stride
                ex = row.exemplars
                ex[key] = (total_us, str(trace_id),
                           wall_ts if wall_ts is not None else time.time())
                if len(ex) > self.MAX_EXEMPLARS:
                    ex.pop(min(ex))

    # -- staged bulk ingestion (the metering thread's fast path) --

    # Entries buffered before a forced bulk fold (~0.14 s at 30k
    # steps/s); reads ingest whatever is pending regardless, so this
    # bounds memory, not staleness.
    INGEST_THRESHOLD = 4096

    def stage_batch(self, stage: Dict[str, list],
                    weights: Optional[Dict[str, float]],
                    n_items: int) -> None:
        """Park one retired batch for bulk ingestion.  ``stage`` maps
        tenant -> a FLAT row list ``[dt_enq_s, bucket_wait_us,
        dt_disp_s, steps, ...]`` (4 values per retired item; the dt_*
        are the batch observation time MINUS the item's enqueue /
        dispatch monotonic stamps, so rows are self-contained and the
        phase math is vectorized at ingest, never paid per item);
        ``weights`` is the batch-window co-tenant device-time delta map
        the blame split divides by (each victim's own entry is excluded
        at ingest).  O(1): one deque append — deliberately no lock, no
        sketch work, no per-row touch."""
        if not self.enabled or not stage:
            return
        self._pending.append((stage, weights))
        self._pending_n += n_items
        if self._pending_n >= self.INGEST_THRESHOLD:
            self.ingest_pending()

    def ingest_pending(self) -> None:
        """Fold every parked batch into the sketches/windows/blame.
        Called by stage_batch past the threshold and by every read
        path, so readers always see every retired request."""
        if not self._pending:
            return
        with self.mu:
            self._ingest_pending_locked()

    @staticmethod
    def _phase_cols(flat: list):
        """(queue, bucket, device, total, steps) µs column arrays from
        flat dt-relative rows — one numpy pass, no per-item math."""
        arr = _np.asarray(flat, dtype=_np.float64).reshape(-1, 4)
        total = _np.maximum(arr[:, 0], 0.0) * 1e6
        bucket = _np.minimum(arr[:, 1], total)
        queue = _np.maximum((arr[:, 0] - arr[:, 2]) * 1e6 - bucket, 0.0)
        device = _np.maximum(arr[:, 2], 0.0) * 1e6
        return queue, bucket, device, total, arr[:, 3]

    def _ingest_pending_locked(self) -> None:
        pairs = []
        while True:
            try:
                pairs.append(self._pending.popleft())
            except IndexError:
                break
        if not pairs:
            return
        self._pending_n = 0
        now = time.monotonic()
        # Merge every pair's flat rows per tenant (C-speed extends) so
        # the sketch fold pays ONE numpy pass per tenant per ingest —
        # per-batch numpy overhead was measurable with the small
        # batches a fast metering loop produces.
        merged: Dict[str, list] = {}
        for stage, weights in pairs:
            for name, flat in stage.items():
                # Blame splits PER BATCH (each batch carries its own
                # co-tenant window).  wait = sum(dt_enq - dt_disp) ==
                # each item's enqueue->dispatch wall: two C-speed
                # slice-sums, no per-item python.
                wait = (sum(flat[0::4]) - sum(flat[2::4])) * 1e6
                if wait > 0.0:
                    self._apply_blame_locked(name, wait, weights)
                bucket = merged.get(name)
                if bucket is None:
                    merged[name] = list(flat)
                else:
                    bucket.extend(flat)
        if _np is not None:
            for name, flat in merged.items():
                self._ingest_cols_locked(name, self._phase_cols(flat),
                                         now)
            return
        # stdlib fallback (tests / analyze smoke): per-row loop through
        # the exact-path record arithmetic.
        for name, flat in merged.items():
            row = self._row(name)
            viol = 0
            steps_sum = 0
            device_sum = 0.0
            ph = row.phases
            n = 0
            for i in range(0, len(flat), 4):
                dt_enq, bw, dt_disp, steps = flat[i:i + 4]
                total = max(dt_enq, 0.0) * 1e6
                bucket = min(bw, total)
                queue = max((dt_enq - dt_disp) * 1e6 - bucket, 0.0)
                device = max(dt_disp, 0.0) * 1e6
                ph["queue"].add(queue)
                ph["bucket"].add(bucket)
                ph["device"].add(device)
                ph["e2e"].add(total)
                if total > row.target_us:
                    viol += 1
                steps_sum += int(steps)
                device_sum += device
                n += 1
            row.violations_total += viol
            for ring in row.windows.values():
                ring.note(now, viol, steps_sum, device_sum, n=n)

    def _apply_blame_locked(self, victim: str, wait: float,
                            weights: Optional[Dict[str, float]]) -> None:
        row = self._row(victim)
        row.wait_us += wait
        total_w = 0.0
        if weights:
            for name, w in weights.items():
                if name != victim and w > 0.0:
                    total_w += w
        if total_w > 0.0:
            blame = row.blame
            for name, w in weights.items():
                if name == victim or w <= 0.0:
                    continue
                blame[name] = blame.get(name, 0.0) \
                    + wait * (w / total_w)
            if len(blame) > self.MAX_BLAME_ENTRIES:
                self._collapse_blame(blame)
        else:
            row.blame[SELF_BLAME] = row.blame.get(SELF_BLAME, 0.0) + wait
        row.blamed_us += wait

    def _ingest_cols_locked(self, name: str, cols: list,
                            now: float) -> None:
        """Bulk-fold one tenant's concatenated phase columns (numpy
        path): one vectorized log per column replaces N sketch inserts
        — semantically identical to N ``record`` calls minus the
        per-request blame granularity (batch-window blame was already
        applied)."""
        row = self._row(name)
        n = int(cols[0].shape[0])
        if n == 0:
            return
        for ci, phase in enumerate(PHASES):
            col = cols[ci]
            sk = row.phases[phase]
            sk.count += n
            sk.sum += float(col.sum())
            cmin = float(col.min())
            cmax = float(col.max())
            if cmin < sk.min:
                sk.min = cmin
            if cmax > sk.max:
                sk.max = cmax
            pos = col[col > 0.0]
            sk.zero += n - len(pos)
            if len(pos):
                keys = _np.ceil(_np.log(pos) * sk._inv_log_gamma
                                ).astype(_np.int64)
                uk, cnt = _np.unique(keys, return_counts=True)
                b = sk.buckets
                for k, c in zip(uk.tolist(), cnt.tolist()):
                    b[k] = b.get(k, 0) + c
                while len(b) > sk.max_buckets:
                    sk._collapse()
        viol = int((cols[3] > row.target_us).sum())
        steps = int(cols[4].sum())
        device_us = float(cols[2].sum())
        row.violations_total += viol
        for ring in row.windows.values():
            ring.note(now, viol, steps, device_us, n=n)

    def _collapse_blame(self, blame: Dict[str, float]) -> None:
        """Fold the smallest culprits into (other): the matrix stays
        bounded and conservation holds (the collapsed µs move, never
        vanish)."""
        items = sorted(((v, k) for k, v in blame.items()
                        if k != self.OTHER_BLAME))
        spill = 0.0
        for v, k in items[:max(len(items) // 4, 1)]:
            spill += blame.pop(k)
        if spill:
            blame[self.OTHER_BLAME] = \
                blame.get(self.OTHER_BLAME, 0.0) + spill

    # -- the read path --

    def _row_report(self, name: str, row: _TenantSlo,
                    now: float) -> Dict[str, Any]:
        phases = {}
        for p, sk in row.phases.items():
            phases[p] = {
                "count": sk.count,
                "sum_us": round(sk.sum, 1),
                "p50_us": round(sk.quantile(0.50), 1),
                "p90_us": round(sk.quantile(0.90), 1),
                "p99_us": round(sk.quantile(0.99), 1),
                "max_us": round(sk.max, 1),
            }
        windows = {}
        short_burn = 0.0
        for i, (w, ring) in enumerate(sorted(row.windows.items())):
            c, v, s, du = ring.totals(now)
            rate = (v / c) if c else 0.0
            burn = rate / self.budget
            steps_per_s = s / w
            windows[str(int(w))] = {
                "count": c,
                "violations": v,
                "attainment_pct": round(100.0 * (1.0 - rate), 2),
                "burn_rate": round(burn, 2),
                "steps_per_s": round(steps_per_s, 1),
                "device_us": round(du, 1),
                "floor_ok": (row.floor_steps_s <= 0.0
                             or steps_per_s >= row.floor_steps_s),
            }
            if i == 0:
                short_burn = burn
        blame = {k: round(v, 1) for k, v in sorted(
            row.blame.items(), key=lambda kv: -kv[1])}
        top = next((k for k in blame if k != SELF_BLAME), None)
        # Trace-id exemplars (only the tenant's own ids land here):
        # the Prometheus exporter attaches them to the e2e histogram
        # buckets, linking a bucket's tail straight into the flight
        # recorder (``vtpu-smi trace <tenant>``).
        exemplars = {str(k): [round(v, 1), tid, round(ts, 3)]
                     for k, (v, tid, ts) in row.exemplars.items()}
        return {
            "objective": {
                "target_us": round(row.target_us, 1),
                "floor_steps_s": row.floor_steps_s,
                "source": ("explicit" if row.target_explicit
                           else "quota-default"),
                "quota_pct": row.quota_pct,
            },
            "phases": phases,
            "windows": windows,
            "violations_total": row.violations_total,
            "restored_count": row.restored_n,
            "burn_alert": short_burn >= self.burn_alert,
            "blame": blame,
            "wait_us_total": round(row.wait_us, 1),
            "blamed_us_total": round(row.blamed_us, 1),
            "top_blamer": top,
            "exemplars": exemplars,
            # Sketch-derived histogram bounds for the Prometheus
            # exporter: cumulative (le_us, count) on a stable ~2x grid.
            "e2e_buckets": [[round(le, 1), c] for le, c
                            in row.phases["e2e"].bucket_bounds()],
        }

    def fairness(self, quota_pcts: Dict[str, int],
                 now: Optional[float] = None) -> Dict[str, Any]:
        """Attained-share-vs-quota-share over the SHORT window (falling
        back to cumulative device time when the window is empty), plus
        Jain's fairness index over the per-tenant attainment ratios:
        J = (sum x)^2 / (n * sum x^2); 1.0 = perfectly proportional."""
        if now is None:
            now = time.monotonic()
        self.ingest_pending()
        with self.mu:
            rows = list(self._tenants.items())
            short_w = min(self.window_lengths)
            attained: Dict[str, float] = {}
            for name, row in rows:
                ring = row.windows.get(short_w)
                du = ring.totals(now)[3] if ring is not None else 0.0
                if du <= 0.0:
                    du = row.phases["device"].sum
                attained[name] = du
            pcts = {name: max(int(quota_pcts.get(name, 0) or 0), 0)
                    for name, _ in rows}
        total_du = sum(attained.values())
        total_pct = sum(p if p > 0 else 100 for p in pcts.values())
        out_rows: Dict[str, Any] = {}
        ratios: List[float] = []
        for name, du in attained.items():
            pct = pcts.get(name, 0)
            quota_share = (pct if pct > 0 else 100) / max(total_pct, 1)
            att_share = du / total_du if total_du > 0 else 0.0
            ratio = att_share / quota_share if quota_share > 0 else 0.0
            out_rows[name] = {
                "quota_share": round(quota_share, 4),
                "attained_share": round(att_share, 4),
                "ratio": round(ratio, 3),
            }
            if total_du > 0:
                ratios.append(ratio)
        jain = 1.0
        if ratios:
            sx = sum(ratios)
            sxx = sum(x * x for x in ratios)
            jain = (sx * sx) / (len(ratios) * sxx) if sxx > 0 else 1.0
        return {"window_s": min(self.window_lengths),
                "tenants": out_rows, "jain": round(jain, 4)}

    def report(self, tenant: Optional[str] = None, admin: bool = False,
               quota_pcts: Optional[Dict[str, int]] = None,
               now: Optional[float] = None) -> Dict[str, Any]:
        """The SLO verb's reply body.  Scoping: a tenant-socket caller
        gets ONE row (its own); the admin socket gets every row plus
        the full blame matrix.  Bind-free probes with no tenant name
        get the enabled flag and nothing else (no cross-tenant
        disclosure on the container-mounted socket)."""
        out: Dict[str, Any] = {"enabled": self.enabled,
                               "budget": self.budget,
                               "burn_alert_threshold": self.burn_alert}
        if not self.enabled:
            out["tenants"] = {}
            return out
        if now is None:
            now = time.monotonic()
        self.ingest_pending()
        with self.mu:
            if tenant is not None:
                row = self._tenants.get(tenant)
                rows = {tenant: self._row_report(tenant, row, now)} \
                    if row is not None else {}
            elif admin:
                rows = {name: self._row_report(name, row, now)
                        for name, row in self._tenants.items()}
            else:
                rows = {}
        out["tenants"] = rows
        if admin:
            out["matrix"] = {name: dict(body["blame"])
                             for name, body in rows.items()}
            out["fairness"] = self.fairness(quota_pcts or {}, now=now)
        elif tenant is not None and quota_pcts is not None:
            fair = self.fairness(quota_pcts, now=now)
            own = fair["tenants"].get(tenant)
            if own is not None:
                out["fairness"] = {"window_s": fair["window_s"],
                                   "tenants": {tenant: own},
                                   "jain": fair["jain"]}
        return out

    def burn_alerts(self, now: Optional[float] = None
                    ) -> Dict[str, float]:
        """Tenants whose SHORT-window burn rate is at or past the alert
        threshold, with the rate — the admission plane's burn→shed
        input: while a priority-0 tenant appears
        here, the broker's elastic keeper halves the lower priorities'
        shed thresholds.  Cheap enough for a 2 Hz poll."""
        if not self.enabled:
            return {}
        if now is None:
            now = time.monotonic()
        self.ingest_pending()
        out: Dict[str, float] = {}
        with self.mu:
            short_w = min(self.window_lengths)
            for name, row in self._tenants.items():
                ring = row.windows.get(short_w)
                if ring is None:
                    continue
                c, v, _s, _du = ring.totals(now)
                if not c:
                    continue
                burn = (v / c) / self.budget
                if burn >= self.burn_alert:
                    out[name] = round(burn, 2)
        return out

    def exemplars_for(self, tenant: str) -> Dict[int, Tuple[float, str,
                                                            float]]:
        """Trace-id exemplars of a tenant's e2e sketch (bucket-group ->
        (value_us, trace_id, wall_ts)) — the Prometheus exporter links
        them into the flight recorder."""
        self.ingest_pending()
        with self.mu:
            row = self._tenants.get(tenant)
            return dict(row.exemplars) if row is not None else {}

    # -- journal persistence (runtime/journal.py) --

    def journal_due(self, now: Optional[float] = None) -> bool:
        """Rate-limits the keeper's periodic slo journal records."""
        period = journal_period_s()
        if not self.enabled or period <= 0:
            return False
        if now is None:
            now = time.monotonic()
        if now - self._journal_ts < period:
            return False
        self._journal_ts = now
        return True

    def export_state(self, tenant: str) -> Optional[Dict[str, Any]]:
        """JSON-safe snapshot of one tenant's sketches + blame row for
        the journal.  Windows are deliberately NOT persisted (they are
        wall-time-relative; a respawned broker's burn windows restart
        cleanly while cumulative attainment history survives)."""
        if not self.enabled:
            return None
        self.ingest_pending()
        with self.mu:
            row = self._tenants.get(tenant)
            if row is None:
                return None
            return {
                "phases": {p: sk.to_dict()
                           for p, sk in row.phases.items()},
                "blame": {k: round(v, 3) for k, v in row.blame.items()},
                "wait_us": round(row.wait_us, 3),
                "blamed_us": round(row.blamed_us, 3),
                "violations_total": row.violations_total,
                "objective": {
                    "target_us": row.target_us,
                    "floor_steps_s": row.floor_steps_s,
                    "explicit": row.target_explicit,
                    "quota_pct": row.quota_pct,
                },
            }

    def restore(self, tenant: str, state: Dict[str, Any]) -> None:
        """Journal replay: re-seed a recovered tenant's row.  In-flight
        requests at the crash died unrecorded and unreplied — they are
        in NEITHER the journaled sketch nor the successor's, so resume
        can never double-count (asserted live by the chaos driver)."""
        if not self.enabled or not isinstance(state, dict):
            return
        with self.mu:
            row = _TenantSlo(self.alpha, self.max_buckets,
                             self.window_lengths)
            for p in PHASES:
                d = (state.get("phases") or {}).get(p)
                if isinstance(d, dict):
                    row.phases[p] = QuantileSketch.from_dict(
                        d, max_buckets=self.max_buckets)
            row.blame = {str(k): float(v)
                         for k, v in (state.get("blame") or {}).items()}
            row.wait_us = float(state.get("wait_us", 0.0))
            row.blamed_us = float(state.get("blamed_us", 0.0))
            row.violations_total = int(state.get("violations_total", 0))
            obj = state.get("objective") or {}
            try:
                row.target_us = float(obj.get("target_us",
                                              row.target_us))
                row.floor_steps_s = float(obj.get("floor_steps_s", 0.0))
                row.target_explicit = bool(obj.get("explicit", False))
                row.quota_pct = int(obj.get("quota_pct", 0))
            except (TypeError, ValueError):
                pass
            # Restore evidence for the chaos driver: how much history
            # this row carried in (the e2e count as replayed).
            row.restored_n = int(row.phases["e2e"].count)
            self._tenants[tenant] = row

    def tenant_names(self) -> List[str]:
        self.ingest_pending()
        with self.mu:
            return list(self._tenants.keys())


# -- 64-tenant fairness smoke ---------------------------------------------


def fairness_smoke(n_tenants: int = 64, seed: int = 7,
                   duration_s: float = 60.0) -> Dict[str, Any]:
    """Synthetic heterogeneous-load run through the REAL plane: 64
    tenants with zipf-ish quota shares and lognormal latencies, one
    deliberately starved tenant.  Asserts the acceptance properties —
    per-tenant blamed wait sums to measured wait, the starved tenant's
    burn rate fires, Jain's index is well-formed — and returns the
    report.  Deterministic (seeded), stdlib-only, no broker: this is
    the analyze-job smoke and the test-suite fixture."""
    import random
    rng = random.Random(seed)
    plane = SloPlane(enabled=True, alpha=0.02, max_buckets=256,
                     windows=(30.0, 300.0), budget=0.01, burn_alert=10.0)
    names = [f"t{i:02d}" for i in range(n_tenants)]
    starved = names[-1]
    # Heterogeneous quota shares: a few heavy tenants, a long tail.
    pcts = {}
    for i, name in enumerate(names):
        pcts[name] = max(1, int(100 / (1 + i)))  # zipf-ish
    for name in names:
        plane.ensure_tenant(name, quota_pct=pcts[name])
    heavy = names[:4]
    expected_wait: Dict[str, float] = {n: 0.0 for n in names}
    t = 1_000.0  # logical clock (monotonic seconds)
    while t < 1_000.0 + duration_s:
        for name in names:
            share = pcts[name] / 100.0
            reqs = 1 + int(6 * share)
            for _ in range(reqs):
                base = rng.lognormvariate(7.0, 0.8)  # ~1.1ms median
                if name == starved:
                    # Starved: almost no device time, huge waits — every
                    # request blows its target.
                    queue = 60.0 * default_target_us(pcts[name])
                    bucket = queue * 0.3
                    device = 50.0
                else:
                    queue = base * rng.random() * 0.5
                    bucket = base * rng.random() * 0.2
                    device = base * share * 4.0
                total = queue + bucket + device
                weights = {h: pcts[h] * rng.random()
                           for h in heavy if h != name}
                plane.record(name, queue_us=queue, bucket_us=bucket,
                             device_us=device, total_us=total,
                             steps=1, wait_weights=weights, now=t)
                expected_wait[name] += queue + bucket
        t += 1.0
    now = 1_000.0 + duration_s
    rep = plane.report(admin=True, quota_pcts=pcts, now=now)
    failures: List[str] = []
    for name, row in rep["tenants"].items():
        blamed = sum(row["blame"].values())
        wait = row["wait_us_total"]
        if wait > 0 and abs(blamed - wait) > max(1e-6 * wait, 0.5):
            failures.append(
                f"[blame-conservation] {name}: blamed {blamed:.1f}us "
                f"!= measured wait {wait:.1f}us")
        if abs(wait - expected_wait[name]) > max(
                1e-6 * expected_wait[name], 0.5):
            failures.append(
                f"[wait-accounting] {name}: measured {wait:.1f}us != "
                f"fed {expected_wait[name]:.1f}us")
    srow = rep["tenants"][starved]
    if not srow["burn_alert"]:
        failures.append(
            f"[burn-rate] starved tenant {starved} did not fire its "
            f"burn alert (windows: {srow['windows']})")
    jain = rep["fairness"]["jain"]
    if not (0.0 < jain <= 1.0 + 1e-9):
        failures.append(f"[fairness] Jain index {jain} out of (0, 1]")
    sfair = rep["fairness"]["tenants"][starved]
    if sfair["ratio"] >= 0.5:
        failures.append(
            f"[fairness] starved tenant attained ratio "
            f"{sfair['ratio']} not visibly below its share")
    return {
        "tenants": n_tenants,
        "seed": seed,
        "starved": starved,
        "starved_burn_alert": bool(srow["burn_alert"]),
        "starved_ratio": sfair["ratio"],
        "jain": jain,
        "failures": failures,
        "ok": not failures,
    }


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="vtpu-slo",
        description="SLO plane self-checks")
    ap.add_argument("--smoke", action="store_true",
                    help="64-tenant heterogeneous-load fairness smoke: "
                         "blame conservation, starved-tenant burn "
                         "alert, Jain index (the analyze CI job's "
                         "gate)")
    ap.add_argument("--tenants", type=int, default=64)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--json", action="store_true")
    ns = ap.parse_args(argv)
    if not ns.smoke:
        ap.error("nothing to do (pass --smoke)")
    rep = fairness_smoke(n_tenants=ns.tenants, seed=ns.seed)
    if ns.json:
        print(json.dumps(rep, indent=2))
    else:
        print(f"vtpu-slo smoke: {ns.tenants} tenants, starved="
              f"{rep['starved']} (burn_alert="
              f"{rep['starved_burn_alert']}, attained ratio "
              f"{rep['starved_ratio']}), jain={rep['jain']}")
        for f in rep["failures"]:
            print("  " + f)
    print("vtpu-slo smoke:", "ok" if rep["ok"] else "FAILED")
    return 0 if rep["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
