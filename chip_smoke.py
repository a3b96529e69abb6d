#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's native libraries from the sources in this checkout,
then runs fifteen phases, each of which asserts; any failure exits
non-zero and prints no result line.

1. Device: the card's name and power limit, the versions (msgpack and
   ml_dtypes looked up, not imported), the build (the CUDA kernels, the
   region, the interposer and its test programs).
   Fails if ptxas reports a spill in the Hopper attention kernel, or if
   the interposer's ABI header disagrees with the toolkit's cuda.h and
   nvml.h (native/abi_check.cc, compiled only).
2. Kernel vs plain: the CUDA attention kernels against their plain
   PyTorch version on the card, at the shapes of the JAX package's kernel
   tests, ragged and small head_dim cases, and the serving shapes; each
   call goes to the kernel ``kernel_route`` picks (sm90 for bf16 at
   head_dim 64 and 128, wmma otherwise).  At the serving shapes it also
   runs the wmma kernel, and times both kernels in turns beside the plain
   version, PyTorch's scaled_dot_product_attention (the yardstick only:
   the port never calls it) and the bound.
3. Serving: a quota-enforced tenant serves Llama-3-8B at full width and
   depth with random weights through ``vtpu_torch.entry.serve``; the
   attention kernels' launch counts are reset just before and read just
   after, and every launch must have taken the sm90 route.  The flash
   path's logits are held against the plain path's.
4. Quota: a second copy of the weights is refused under the 20 GiB cap
   before anything is allocated; releasing the model empties the ledger.
5. Two tenants: two processes at 50% compute shares serve the bench
   config on one region at once, under the in-process enforcer.
6. Interposed serving: a child started under the native interposer
   (``shim.interposer.tenant_env``, 20 GiB cap, core 100%) serves
   Llama-3-8B through ``entry.serve`` with no enforcer of its own.  It
   checks that mem_get_info and nvidia-smi show the cap, that all 128
   attention launches took the sm90 route, that one ctypes launch of the
   kernel passes the interposer's gate once, that the gate saw every
   kernel the profiler recorded over one forward, and that a second copy
   of the weights is refused (again with expandable segments, the
   cuMemCreate path); the ledger is 0 once the children have exited.
7. Interposed tenants: the bench config under the interposer at 100%,
   at 50% FORCE, and two processes at 50% FORCE on one region, each
   serving for at least 8 s, metered by the interposer's watcher (each
   process's busy time, shared among the region's busy processes).
8. The device-plugin daemon: NVML discovery held against nvidia-smi and
   torch (UUID, memory, SM count), procfs where the container has it, a
   health probe; the card split in two and one Allocate grant for each
   half (two private regions, one busy file for the card, made as the
   daemon makes it); then tenants started with exactly each grant's env
   serve the bench config, one alone and both at once, each checking its
   cap and the sm90 route, and the pair again without the busy files
   (information: the metering before the per-card busy file).  The pair's
   rates and booked device time a step are held against the solo
   grant's.  No grpc is imported.
9. Training, in child processes: one Adam step of the tiny model in f32
   on the card (TF32 off) against the same step on the CPU; the bench
   config (Llama-3-8B's layer width) trained at b=4, s=512 through
   ``vtpu_torch.entry.train`` under the interposer with a 16 GiB cap, its
   loss falling and every step's charge under the cap; the same under a
   3 GiB cap, below the weights, gradients and Adam state alone, refused
   with an out-of-memory error; both ledgers 0 after exit.  Then the
   sharded dry-run over NCCL at world size 1
   (``entry.dryrun_multichip(1)``), and the attention kernel refusing
   tensors that require grad.  Phase 9 alone:
   ``python3 -c "import chip_smoke, tempfile, torch;
   chip_smoke.phase_device(torch); chip_smoke.phase_train(torch,
   tempfile.mkdtemp())"``.
10. Pods, as the kubelet would start them: the interposer, the busy
   files and the in-container bootstrap staged (``plugin.grant.
   stage_shim``); the daemon (``plugin.main.Daemon``: NVML, the card split
   in two, monitor mode) with a pod lister that returns two pending pods,
   pod A declaring PYTHONPATH=/app/lib; two Allocates over gRPC from a
   fake kubelet.  Both pods' tenants start at once with exactly their
   grants' env, container paths mapped to the mounts' host paths (the
   interposer in LD_PRELOAD for the ld.so.preload mount, PYTHONPATH at the
   staged shim), and serve the bench config through ``entry.serve``: the
   shim's sitecustomize ran and stood down under the interposer, pod A
   sees /app/lib after the shim's entry, the regions are two files under
   the host's shared/.  While they hold the card, each pod's ``vtpu-smi
   --json`` shows the grant's cap and a ledger equal to that pod's own
   interposer charge, and the card's busy file two live tenants.  Then a
   tenant with pod A's grant but no interposer, under a 1.5 GiB cap:
   ``model.to("cuda")`` of the bench weights is admitted and charged, a
   second copy refused, and a ``torch.compile``d forward is gated at the
   grant's 50% FORCE share (against 100%, information); every ledger is 0
   after exit.  Last, the daemon restarted with the legacy controller
   over a kubelet checkpoint that gives vdevice 0 to a live pod: the stale
   ID 0 is answered with vdevice 1 and the controller's annotations.
11. What a pod sees: the daemon as in phase 10 with ``--enable-metricsd``;
   each of two grants carries VTPU_METRICSD_PORT (mapped to a port of the
   pod's own, as each container has its own localhost) and none of
   libtpu's metrics variables.  Both pods' tenants (interposed, bench
   config, 50% FORCE) serve their metricsd from the bootstrap.  While
   both hold the card idle: each pod's metricsd total is its cap and its
   usage its interposer's charge to the byte; so are tpu-info's (in the
   pod's env), vtpu-smi --scan's and the Prometheus exporter's (with each
   pod's metricsd gauges).  Then idle, pod A flat out beside an idle pod
   B, and both flat out: metricsd's duty of the share (flat out at least
   85, idle at most 10), nvidia-smi under each pod's interposer, in loop
   mode over metricsd's own window (the cap, and utilization.gpu within
   15 of metricsd's duty; the idle pod at most 10 while the card's own
   reading, averaged over the window, is at least 40) and tpu-info; no
   view takes a slot in a region.  Every ledger 0 after exit.  Prints
   metricsd's GetRuntimeMetric p50, nvmlDeviceGetUtilizationRates' first
   and later call under the interposer, and the pods' rates beside phase
   10's.  Phase 11 alone: ``python3 -c "import chip_smoke, tempfile,
   torch; chip_smoke.phase_device(torch); chip_smoke.phase_views(torch,
   tempfile.mkdtemp())"``.
12. The broker (``vtpu_torch.runtime.server``) in this process, its
   tenants as children started with ``CUDA_VISIBLE_DEVICES`` empty, which
   never initialise CUDA.  12a: the bench config at b=4, s=512, weights
   drawn on the CPU from a seed and sent as PUTs, 8 greedy steps as two
   chains of 4; the broker launches K1 exactly 16 times, all on the sm90
   route; the logits of the first step within ``LOGITS_REL_L2`` of
   in-process ``entry.serve`` with the same weights, and the tokens after
   steps 4 and 8 equal on at least 99.9% of positions.  12b: Llama-3-8B
   at full width, depth cut to 4 layers (phase 3 serves all 32 in
   process), b=2, s=512, from the broker's init program under a 6 GiB cap
   given in HELLO: 4 launches a step, a second init refused with
   RESOURCE_EXHAUSTED and the ledger unmoved, 0 after the tenant exits.  12c: the bench config at 50%
   shares given in HELLO, one tenant alone and two at once for 8 s each:
   each of the pair books 0.40-0.60 of its window, and the tenant alone
   (a sole demander, ungated in the work-conserving region) runs faster
   and books more of its window than each of the pair.  Phase 12 alone:
   ``python3 -c "import chip_smoke, tempfile, torch;
   chip_smoke.phase_device(torch); chip_smoke.phase_broker(torch,
   tempfile.mkdtemp())"``.
13. The broker's durability half: brokers as processes
   (``python -m vtpu_torch.runtime.server --device cuda``) with a journal
   (on /dev/shm when it has room for the weights twice, else the temp
   directory; the script prints which) and ``VTPU_TRACE=1``, tenants as
   children with ``CUDA_VISIBLE_DEVICES`` empty.  13a: Llama-3-8B at full
   width, depth cut to 2 layers (2.97 GB of bf16 weights drawn on the card
   from a seed, PUT by the tenant, so journaled), b=2, s=512, under an
   8 GiB cap and core 100 given in HELLO; after 8 steps (two chains of 4)
   the broker is killed with SIGKILL while the third chain is in flight,
   and a successor started with the same command shows in a bind-free
   STATS, before the tenant goes on, the tenant recovered, its ledger
   equal to the bytes of its journaled PUTs and its cost EMA keys; that
   successor exits 3 at its second dispatch (``VTPU_FAULTS=exit3@
   dispatch:nth=2``, the device-fault exit) and a third one takes over.
   The tenant's ``serve_brokered`` catches no exception on its way to step
   16; the tokens equal in-process ``entry.serve``'s on at least 99.9% of
   positions; the last broker's K1 launches, from its own log at
   shutdown, are all sm90, 4 a step it ran; the ledger reads 0 after the
   tenant exits.  13b: the bench config (b=4, s=512, PUT weights) flat
   out in a broker with ``--work-conserving 0``: 4 s at core 100, then
   ``vtpu-smi --broker <sock> --resize <tenant> --core 50`` and 4 s more,
   where it books 0.40-0.60 of its window and less than before;
   ``vtpu-smi trace --dump`` writes a Chrome trace of its spans, whose
   queue, bucket and device phases add up to each total, with the
   bucket's p50 0 before the resize and above 0 after; ``vtpu-smi
   leases`` names the broker's pid; ``vtpu-smi --broker <sock>
   --handover`` exits 0, the script starts the successor, the tenant
   serves on with no exception, and the successor holds core 50 and the
   cost EMA.  Phase 13 alone: ``python3 -c "import chip_smoke, tempfile,
   torch; chip_smoke.phase_device(torch); chip_smoke.phase_durability(
   torch, tempfile.mkdtemp(), {'serve': float('nan')})"``.

14. The fastlane (``vtpu_torch.runtime.fastlane``): tenants as children
   with ``CUDA_VISIBLE_DEVICES`` empty and ``VTPU_FASTLANE=1``, brokers in
   this process but 14f's.  14a: Llama-3-8B at full width, depth cut to 2
   layers, from the broker's init program (20 GiB, core 100 given in
   HELLO), b=2, s=512, 16 steps of one unchained execute each over the
   lane, then a second connection of the tenant closes its lane and 16 more
   go over the socket on the same weights: at least 15 ring steps (the
   first primes over the socket), the tokens of both equal at every
   position, one sm90 launch a layer a step and no WMMA, the ledger 0 after
   exit.  14b: the bench config
   at b=4, s=512, weights drawn from a seed and PUT, 8 steps over the lane
   and 8 over the socket: logits (a forward over the ring) within
   ``LOGITS_REL_L2`` of in-process ``entry.serve`` and tokens equal on at
   least 99.9% of positions.  14c: 2,000 synchronous executes of a
   256-float program over each path, at least 90% of the lane's on the
   ring (p50 and p99 µs printed).  14d: 32 MiB arrays PUT and fetched over
   the socket and through the arenas, with the journal off and on (on
   /dev/shm): bit-equal, the ledger equal to the bytes PUT (GB/s
   printed).  14e: two bench lane tenants at 50% in a broker with
   ``--work-conserving 0`` for 6 s, then one alone at 100%: each of the
   pair books 0.40-0.60 of its window, the one alone at least 0.85, both
   with lease grants.  14f (F1): each index op of the broker's list run
   raw on the card alone, in a process of its own (which assert:
   printed); then, in a broker process, a bench co-tenant serving in
   chains alone and beside a hostile tenant that sends every such op out
   of range over the socket and over the lane: the broker's pid holds, the
   hostile outputs equal the CPU reference of the clamp-and-drop rule, the
   co-tenant's tokens equal its solo run.  Phase 14 alone: ``python3 -c
   "import chip_smoke, tempfile, torch; chip_smoke.phase_device(torch);
   chip_smoke.phase_fastlane(torch, tempfile.mkdtemp(), {'serve':
   float('nan')})"``.

15. The SLO plane and the hot standby (``vtpu_torch.runtime.slo``,
   ``.replication``).  15a: a broker in this process with a journal,
   tracing off (so each batch's device window is split among its items by
   billing) and strict shares; two bench tenants (b=4, s=512, the init
   program, chains of 4, children without a card) at 50% for 6 s, then
   one alone, unmetered, in 1 s windows with the plane on and off in turns
   (steps/s printed).  Each batch's ready times rise from its first
   dispatch to its observed completion and cut that window in the shares
   billing charged its items (within 1 ns), and those charges sum to the
   tenant's booked ``busy_us``; every staged item's queue, bucket and
   device add up to its total within 0.5 us; each tenant's blame row adds
   up to its measured wait; a tenant's SLO reply holds its own row only
   (naming its neighbour too), the admin reply both and the matrix;
   ``vtpu-smi top``, the exporter's ``--broker`` histogram (one a tenant)
   and metricsd's SLO metrics agree with the verb; a HANDOVER's successor
   restores each row's count before the tenants return, and their resume
   adds nothing; the broker's K1 launches are all sm90, one a layer a step
   its tenants ran.  15b: 13a's cell cut to depth 1 (Llama-3-8B's width,
   2.54 GB PUT and journaled, b=2, s=512, chains of 4, 8 GiB and core 100
   in HELLO) under a primary broker process and a standby process
   (``python -m vtpu_torch.runtime.replication``, the default 64 MB
   stream queue) that has bootstrapped and follows the stream; the set-up
   and the tenant's PUT run while 15a's tenants warm up.  After 8 steps,
   with the third chain in flight, the primary is killed (kill -9); the
   standby takes over with the epoch fenced (its ledger equals the
   journaled PUTs' bytes before the tenant returns); the tenant's tokens
   after step 16 equal in-process serving's on at least 99.9% of
   positions with no exception, the successor's K1 launches are all sm90,
   one a layer a step it ran, the standby never initialised CUDA before
   the takeover, and the ledger reads 0 after the tenant exits.  A second
   pair without tenants shows the stale primary: stopped (SIGSTOP) with an
   admin connection open, taken over, resumed (SIGCONT), it refuses a
   journaled admin verb (fenced).  Printed: the blackout from the kill
   beside 13a's respawn, the takeover's split (confirm, fence, claim,
   restore, program load, first chain) after kill -9 and after SIGSTOP,
   the stream's bytes and lag.  Phase 15 alone: ``python3 -c "import
   chip_smoke, tempfile, torch; chip_smoke.phase_device(torch);
   chip_smoke.phase_standby(torch, tempfile.mkdtemp(), {'serve':
   float('nan')}, {'bound_s': float('nan'), 'resume_s': float('nan')})"``.

The line before the last is one JSON object with each kernel's numbers
(``launches`` from phase 3, ``brokered_launches`` from phase 12,
``phase13_launches`` from the phase 13 brokers that exit cleanly,
``phase14_launches`` from phase 14's brokers, ``phase15_launches`` from
15a's broker and 15b's successor, not in-process serving); the last is
``{"ok": true, "device": {...}}``.
"""

import dataclasses
import gc
import json
import math
import multiprocessing as mp
import os
import queue
import re
import socket as socketmod
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# NVIDIA's data sheet for the H100 SXM, dense, at its 700 W limit.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

# Each attention kernel (one per route of ops.flash_attention.ROUTES) is
# built from CSRC/<library>.cu and replaces KERNEL_REPLACES.
CSRC = "4paradigm-k8s-device-plugin_tpu_torch/ops/csrc"
KERNEL_REPLACES = "4paradigm-k8s-device-plugin_tpu/ops/flash_attention.py:39"
SERVE_S = 512              # the serving shape the kernels line reports

# Tolerances of the kernel against its plain version.  bf16: the kernel
# casts unnormalised probabilities to bf16 and normalises in f32 at the
# end, the plain version normalises and then casts (tests of the JAX
# package hold their kernel at the same 3e-2).  f32: summation order and
# the online rescale differ.
TOL = {"bfloat16": 3e-2, "float32": 1e-4}
# Relative L2 error of full-model logits, flash path against plain path,
# in bf16 over 32 layers of random weights: the rounding difference above
# (about one bf16 ulp of each attention output) is carried and amplified
# through the residual stream.  Measured 0.0197 on an H100 SXM; a layout
# or masking fault gives errors of order 1.
LOGITS_REL_L2 = 5e-2

QUOTA_ENV = {"VTPU_DEVICE_HBM_LIMIT_0": "20Gi",
             "VTPU_DEVICE_CORE_LIMIT": "100"}
TENANT_ENV = {"VTPU_DEVICE_HBM_LIMIT_0": "2048Mi",
              "VTPU_DEVICE_CORE_LIMIT": "50",
              "VTPU_CORE_UTILIZATION_POLICY": "FORCE"}
TENANT_STEPS = 60          # bench.py's step count
TENANT_SHAPE = (4, 512)    # bench.py's batch and sequence
# Phase 7 serves each interposed tenant this long, so the metering covers
# the run and the bucket's 400 ms burst allowance adds at most 0.05 to a
# 50% share.
METERED_S = 8.5
# Phase 7's cap, which two tenants share.  Under the interposer every
# segment the caching allocator holds is charged (init_module's cached f32
# draws and the activations too), where the pyshim charged the bf16
# weights alone: two bench tenants do not fit in phase 5's 2048 MiB, and
# the second one's init is refused (PERF.md).
METERED_CAP = {"VTPU_DEVICE_HBM_LIMIT_0": "8Gi"}
# Steps of the unsynchronised greedy loop that phases 3 and 6 time beside
# serve's own rate (three timed steps, which the host's jitter spreads).
LOOP_STEPS = 12


class Failed(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise Failed(msg)


def say(*args):
    print(*args, flush=True)


# -- phase 1 ------------------------------------------------------------------

def phase_device(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(),
          f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"capability {torch.cuda.get_device_capability(0)}")
    # The broker's wire needs msgpack; ml_dtypes is looked up, never
    # imported (the port carries bf16 as torch's bytes).
    from importlib import metadata
    wire = {}
    for pkg in ("msgpack", "ml_dtypes"):
        try:
            wire[pkg] = metadata.version(pkg)
        except metadata.PackageNotFoundError:
            wire[pkg] = None
    say(f"wire: msgpack {wire['msgpack']}, ml_dtypes {wire['ml_dtypes']} "
        "(not imported)")
    check(wire["msgpack"] is not None, "msgpack is not installed")
    from vtpu_torch.ops import _build
    from vtpu_torch.ops import flash_attention as fa

    t0 = time.monotonic()
    paths = _build.build_all()
    say(f"build: {time.monotonic() - t0:.1f} s for {sorted(paths)}")
    _build.abi_check()
    say("abi: native/cuda_abi.h agrees with the toolkit's cuda.h and nvml.h")
    for name in _build.KERNELS:
        spills = []
        for line in _build.build_log(name).splitlines():
            if "Used" in line or "spill" in line or "arning" in line:
                say(f"  ptxas {name}:" + line.split("ptxas info")[-1])
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spills.append(int(m.group(1)) + int(m.group(2)))
        if name == fa.ROUTES["sm90"][0]:
            check(spills and not any(spills),
                  f"ptxas reports spills in {name}: {spills}")
    return card


# -- phase 2 ------------------------------------------------------------------

HOLD_CYCLES = 40_000_000   # about 20 ms of an H100's clock


def time_ms(torch, fn, reps=5, iters=20):
    """Median over ``reps`` windows of ``iters`` back-to-back calls,
    timed with CUDA events after a warm-up.  A spin kernel holds the card
    while each window's calls are queued, so the window times the device
    and not the host's launch rate (a 25 µs kernel launched through
    ctypes from Python is otherwise timed at its launch rate)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def attention_bound(bh, s, d, causal, dtype_bytes, peak_flops):
    """(ms, 'bytes' | 'operations'): the least time for q, k, v read once
    and o written once, or for 4·d flops per unmasked (query, key) pair."""
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    t_ops = 4 * d * pairs / peak_flops
    t_bytes = 4 * bh * s * d * dtype_bytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def compare(torch, got, want, tol):
    """(max abs error, within ``tol`` abs + rel everywhere and finite)."""
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= tol + tol * want.float().abs()).all())
    return diff.max().item(), ok and torch.isfinite(got).all().item()


def phase_kernel(torch):
    from vtpu_torch.ops import flash_attention as fa

    # f32 references in full f32: TF32 keeps about three digits.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        # the JAX package's kernel tests
        ((4, 256, 64), f32, True), ((2, 128, 64), bf16, True),
        ((2, 128, 32), f32, False),
        # ragged s, the smallest head_dim, odd shapes
        ((2, 200, 64), bf16, True), ((3, 77, 128), bf16, False),
        ((2, 200, 16), f32, True), ((2, 130, 16), bf16, True),
        ((2, 96, 128), f32, True),
        # the sm90 kernel: ragged tails on its 128-row tiles; head_dim 64
        ((2, 130, 128), bf16, True), ((8, 1000, 128), bf16, True),
        ((64, 512, 64), bf16, True), ((64, 512, 64), bf16, False),
        # the long forward (batch 1 x 32 heads) and a longer one
        ((32, 2048, 128), bf16, True), ((8, 4096, 128), bf16, True),
        # serving: batch 2 x 32 heads, head_dim 128
        ((64, 512, 128), bf16, True), ((64, 2048, 128), bf16, True),
    ]
    timed = {}
    for shape, dtype, causal in cases:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        route = fa.kernel_route(dtype, shape[-1])
        got = fa.flash_attention(q, k, v, causal=causal)
        want = fa.flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        name = str(dtype).split(".")[-1]
        tol = TOL[name]
        err, ok = compare(torch, got, want, tol)
        say(f"kernel {route} {shape} {name} causal={causal}: max_abs_err "
            f"{err:.3g} (tol {tol}) {'ok' if ok else 'MISMATCH'}")
        check(ok, f"{route} kernel disagrees with plain version at {shape} "
              f"{name} causal={causal}")
        if shape[0] == 64 and shape[-1] == 128:
            timed[shape[1]] = time_serving_shape(torch, fa, q, k, v, causal,
                                                 err, want)
    return timed


def time_serving_shape(torch, fa, q, k, v, causal, err, want):
    """Per-route numbers at one serving shape.  The wmma kernel is run
    and checked here too; the two kernels are timed in turns (sm90, wmma,
    wmma, sm90) and each time is the mean of its two turns."""
    bh, s, d = q.shape
    got = fa._launch(q, k, v, causal, route="wmma")
    torch.cuda.synchronize()
    prev_err, ok = compare(torch, got, want, TOL["bfloat16"])
    check(ok, f"wmma kernel disagrees with plain version at {tuple(q.shape)}")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (t.unsqueeze(0) for t in (q, k, v))
    turns = {"sm90": [], "wmma": []}
    for route in ("sm90", "wmma", "wmma", "sm90"):
        turns[route].append(time_ms(torch, lambda: fa._launch(
            q, k, v, causal, route=route)))
    shared = {
        "plain_ms": time_ms(torch, lambda: fa.flash_attention_ref(
            q, k, v, causal=causal), reps=3, iters=5),
        "library_ms": time_ms(torch, lambda: sdpa(
            q4, k4, v4, is_causal=causal)),
    }
    shared["bound_ms"], shared["bound_by"] = attention_bound(
        bh, s, d, causal, 2, PEAK_BF16_FLOPS)
    rows = {route: {"max_abs_err": e, "ms": statistics.mean(turns[route]),
                    **shared}
            for route, e in (("sm90", err), ("wmma", prev_err))}
    rows["sm90"]["prev_ms"] = rows["wmma"]["ms"]
    say(f"  time at bh={bh} s={s} d={d} (turns {json.dumps(turns)}): "
        + json.dumps(rows))
    return rows


def greedy_rate(torch, model, tokens, steps=LOOP_STEPS):
    """Steps/s of ``steps`` greedy steps queued back to back (serve's
    loop, with nothing between the steps), after one untimed step."""
    with torch.inference_mode():
        tokens = torch.argmax(model(tokens), dim=-1).int()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(steps):
            tokens = torch.argmax(model(tokens), dim=-1).int()
        torch.cuda.synchronize()
    return steps / (time.monotonic() - t0)


def device_breakdown(torch, fn):
    """Device time of one call of ``fn`` by kernel family, summed from
    torch.profiler's kernel records, beside the call's wall time (taken
    under the profiler, so it includes the profiler's own overhead)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    parts = {"attention_kernel_ms": 0.0, "gemm_ms": 0.0, "other_ms": 0.0}
    others = []
    for e in prof.key_averages():
        # Kernel records only: an operator's record carries the device
        # time of the kernels it launched as well, and so does a
        # record_function's span on the device (Adam's step has one).
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        ms = e.self_device_time_total / 1e3
        name = e.key.lower()
        if "attn_fwd" in name:
            parts["attention_kernel_ms"] += ms
        elif any(w in name for w in ("gemm", "xmma", "nvjet", "cutlass")):
            parts["gemm_ms"] += ms
        else:
            parts["other_ms"] += ms
            others.append((ms, e.key[:60]))
    device_ms = sum(parts.values())
    return {"wall_ms": wall_ms, "device_ms": device_ms, **parts,
            "idle_share": 1 - device_ms / wall_ms,
            "top_other": sorted(others, reverse=True)[:4]}


# -- phases 3 and 4 -----------------------------------------------------------

def phase_serve(torch, tmp):
    from vtpu_torch import entry
    from vtpu_torch.models import transformer as tr
    from vtpu_torch.ops import flash_attention as fa

    os.environ.update(QUOTA_ENV, VTPU_DEVICE_MEMORY_SHARED_CACHE=os.path.join(
        tmp, "serve.shr"))
    cfg = tr.TransformerConfig.llama3_8b()
    fa.flash_attention.launches = 0
    fa.flash_attention.route_launches = dict.fromkeys(fa.ROUTES, 0)
    t0 = time.monotonic()
    out = entry.serve("llama3_8b", batch=2, seq=512, steps=4, device="cuda",
                      use_flash=True, seed=0)
    launches = dict(fa.flash_attention.route_launches)
    total = fa.flash_attention.launches
    wall = time.monotonic() - t0
    model, enf, ledger = out["model"], out["enforcer"], out["ledger"]
    tokens, out_rate = out["tokens"], out["steps_per_s"]
    param_bytes = tr.state_bytes(cfg)
    say(f"serve llama3_8b b=2 s=512: 4 steps, {out['steps_per_s']:.3f} "
        f"steps/s after the first, {wall:.1f} s with init; launches "
        f"{json.dumps(launches)}; weights {param_bytes / 2**30:.2f} GiB; "
        "ledger " + json.dumps(ledger))
    check(total == 4 * cfg.n_layers == out["launches"],
          f"kernel launches {total} != 4 steps x {cfg.n_layers} layers")
    check(launches["sm90"] == total,
          f"serving launches not all on the sm90 route: {launches}")
    check(tokens.shape == (2, 512) and int(tokens.min()) >= 0
          and int(tokens.max()) < cfg.vocab, "tokens out of range")
    check(ledger["used_bytes"] >= param_bytes,
          f"ledger {ledger['used_bytes']} < weights {param_bytes}")
    loop_rate = greedy_rate(torch, model, tokens.cuda())
    say(f"greedy loop, {LOOP_STEPS} steps, no enforcement: {loop_rate:.3f} "
        "steps/s")

    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.inference_mode():
        prompt = torch.randint(0, cfg.vocab, (2, 512), generator=gen,
                               device="cuda", dtype=torch.int32)
        n0 = fa.flash_attention.launches
        flash = model(prompt)
        check(fa.flash_attention.launches - n0 == cfg.n_layers,
              "flash forward did not launch the kernel once per layer")
        model.cfg = dataclasses.replace(cfg, use_flash=False)
        plain = model(prompt)
        model.cfg = dataclasses.replace(cfg, use_flash=True)
        rel = ((flash - plain).norm() / plain.norm()).item()
        agree = (flash.argmax(-1) == plain.argmax(-1)).float().mean().item()
        say(f"logits flash vs plain: rel L2 {rel:.3g} (tol {LOGITS_REL_L2}),"
            f" argmax agreement {agree:.4f}")
        check(torch.isfinite(flash).all().item() and rel < LOGITS_REL_L2,
              f"flash logits disagree with plain logits: {rel}")
        del flash, plain
        say("step breakdown b=2 s=512 (one forward, torch.profiler): "
            + json.dumps(device_breakdown(torch, lambda: model(prompt))))

        long = torch.randint(0, cfg.vocab, (1, 2048), generator=gen,
                             device="cuda", dtype=torch.int32)
        n0 = fa.flash_attention.launches
        torch.cuda.synchronize()
        t1 = time.monotonic()
        logits = model(long)
        torch.cuda.synchronize()
        say(f"forward b=1 s=2048: {time.monotonic() - t1:.3f} s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB allocated")
        check(fa.flash_attention.launches - n0 == cfg.n_layers,
              "long forward did not launch the kernel once per layer")
        check(logits.shape == (1, 2048, cfg.vocab)
              and torch.isfinite(logits).all().item(), "bad long logits")
        del logits

    # Phase 4: a second copy of the weights is refused before allocation.
    allocated = torch.cuda.memory_allocated()
    before = enf.ledger()
    try:
        enf.to_device(tr.Transformer(cfg), "cuda")
        raise Failed("a second copy of the weights was admitted")
    except MemoryError as e:
        check("RESOURCE_EXHAUSTED" in str(e), f"wrong refusal: {e}")
        say(f"quota: second copy refused: {e}")
    check(torch.cuda.memory_allocated() == allocated,
          "the refused copy allocated memory")
    check(enf.ledger()["used_bytes"] == before["used_bytes"],
          "the refused copy left charges behind")
    del model, out, tokens
    gc.collect()
    torch.cuda.empty_cache()
    after = enf.ledger()
    say("quota: after release " + json.dumps(after))
    check(after["proc_used_bytes"] == 0 and after["used_bytes"] == 0,
          "ledger not empty after the model was released")
    enf.close()
    for key in (*QUOTA_ENV, "VTPU_DEVICE_MEMORY_SHARED_CACHE"):
        del os.environ[key]
    return launches, {"serve": out_rate, "loop": loop_rate}


# -- phase 5 ------------------------------------------------------------------

def tenant(env, start, done, results):
    """One tenant process: serve the bench config under ``env``'s quota
    once ``start`` releases all tenants; report, then hold the region
    until every tenant has reported."""
    try:
        os.environ.update(env)
        sys.path.insert(0, REPO)
        import torch

        from vtpu_torch import entry

        torch.cuda.init()
        start.wait(timeout=120)
        out = entry.serve("bench", *TENANT_SHAPE, steps=TENANT_STEPS,
                          device="cuda", use_flash=True, seed=os.getpid())
        results.put({"pid": os.getpid(), "steps_per_s": out["steps_per_s"],
                     "launches": out["launches"], **out["ledger"]})
        done.wait(timeout=120)
        enf = out["enforcer"]
        del out
        gc.collect()
        enf.close()
    except Exception as e:  # noqa: BLE001 - reported to the parent
        start.abort()
        done.abort()
        results.put({"pid": os.getpid(), "error": repr(e)})


def run_tenants(n, region):
    ctx = mp.get_context("spawn")
    start, done, results = ctx.Barrier(n), ctx.Barrier(n), ctx.Queue()
    env = dict(TENANT_ENV, VTPU_DEVICE_MEMORY_SHARED_CACHE=region)
    procs = [ctx.Process(target=tenant, args=(env, start, done, results))
             for _ in range(n)]
    for p in procs:
        p.start()
    got = []
    deadline = time.monotonic() + 600
    try:
        while len(got) < n and time.monotonic() < deadline:
            try:
                got.append(results.get(timeout=5))
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
    for r in got:
        check("error" not in r, f"tenant failed: {r}")
    check(len(got) == n and all(p.exitcode == 0 for p in procs),
          f"tenants reported {len(got)} of {n}, exit codes "
          f"{[p.exitcode for p in procs]}")
    return got


def phase_tenants(tmp):
    from vtpu_torch.shim.core import SharedRegion

    solo = run_tenants(1, os.path.join(tmp, "solo.shr"))
    region = os.path.join(tmp, "shared.shr")
    shared = run_tenants(2, region)
    say("tenants solo: " + json.dumps(solo))
    say("tenants shared: " + json.dumps(shared))
    check(all(r["active_procs"] == 2 for r in shared),
          "the two tenants never shared the region")
    check(all(r["proc_busy_us"] > 0 for r in shared),
          "a tenant recorded no device time")
    with SharedRegion(region) as reg:
        reg.active_procs()   # sweeps slots of exited processes
        used = reg.device_stats(0).used_bytes
    check(used == 0, f"ledger holds {used} bytes after both tenants exited")
    say(f"tenants steps/s (bench config b={TENANT_SHAPE[0]} "
        f"s={TENANT_SHAPE[1]}, 50% shares, FORCE): solo "
        f"{solo[0]['steps_per_s']:.2f}, shared "
        + ", ".join(f"{r['steps_per_s']:.2f}" for r in shared))


# -- phases 6 and 7: the native interposer ----------------------------------

def child(args, env, timeout=600):
    """Run this script as ``--child <args>`` under ``env``; returns the
    dict it prints on its ``RESULT`` line."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        *args], env=env, capture_output=True, text=True,
                       timeout=timeout)
    for line in r.stderr.splitlines():
        if "[vtpu_cuda]" in line:
            say("  " + line)
    res = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    check(r.returncode == 0 and res, f"interposed child {args} failed "
          f"(rc {r.returncode}):\n{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
    return json.loads(res[-1][len("RESULT "):])


def kernel_records(torch, prof):
    """Kernel executions in a torch.profiler run (copies and fills
    excluded)."""
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset")))


def second_copy_refused(torch, cfg):
    """A second copy of the weights is refused with OutOfMemoryError, and
    leaves the ledger where it was once the cache is emptied."""
    from vtpu_torch.models import transformer as tr
    from vtpu_torch.shim.pyshim import region_ledger

    gc.collect()
    torch.cuda.empty_cache()
    before = region_ledger(0)["used_bytes"]
    try:
        # Transformer() holds its parameters on the meta device:
        # to_empty allocates them on the card, tensor by tensor.
        tr.Transformer(cfg).to_empty(device="cuda")
        raise Failed("a second copy of the weights was admitted")
    except torch.OutOfMemoryError as e:
        refusal = str(e).splitlines()[0][:200]
    gc.collect()
    torch.cuda.empty_cache()
    after = region_ledger(0)["used_bytes"]
    check(after == before, f"the refused copy left {after - before} bytes "
          "charged")
    return {"refusal": refusal, "used_bytes": after}


def nvml_process_view():
    """What NVML offers per process on this machine: the return code of
    nvmlDeviceGetProcessUtilization (the reference's metering source; 0 is
    success, 3 not supported, 6 no samples yet, 7 the buffer is too
    small) and the pids NVML lists with a context on card 0, beside this
    process's own pid."""
    import ctypes

    u32, u64 = ctypes.c_uint, ctypes.c_ulonglong

    class Sample(ctypes.Structure):
        _fields_ = [("pid", u32), ("timeStamp", u64), ("smUtil", u32),
                    ("memUtil", u32), ("encUtil", u32), ("decUtil", u32)]

    class Info(ctypes.Structure):
        _fields_ = [("pid", u32), ("usedGpuMemory", u64),
                    ("gpuInstanceId", u32), ("computeInstanceId", u32)]

    nvml = ctypes.CDLL("libnvidia-ml.so.1")
    dev = ctypes.c_void_p()
    check(nvml.nvmlInit_v2() == 0 and nvml.nvmlDeviceGetHandleByIndex_v2(
        0, ctypes.byref(dev)) == 0, "NVML does not open card 0")
    n, samples = u32(64), (Sample * 64)()
    rc = nvml.nvmlDeviceGetProcessUtilization(dev, samples, ctypes.byref(n),
                                              u64(0))
    m, infos = u32(64), (Info * 64)()
    rc_procs = nvml.nvmlDeviceGetComputeRunningProcesses_v3(
        dev, ctypes.byref(m), infos)
    return {"process_utilization_rc": rc, "pid": os.getpid(),
            "compute_pids": ([infos[i].pid for i in range(m.value)]
                             if rc_procs == 0 else rc_procs)}


def interposed_serve_child(torch):
    """Phase 6, inside the interposed child."""
    from vtpu_torch import entry
    from vtpu_torch.models import transformer as tr
    from vtpu_torch.ops import flash_attention as fa
    from vtpu_torch.shim import interposer
    from vtpu_torch.shim.pyshim import region_ledger

    check(interposer.loaded(), "the interposer is not in the child")
    cfg = tr.TransformerConfig.llama3_8b()
    res = {}
    if os.environ.get("PYTORCH_CUDA_ALLOC_CONF"):
        out = entry.serve("llama3_8b", 2, 512, 2)
        check(out["enforcer"] is None, "an in-process enforcer installed")
        res["ledger"] = out["ledger"]
        check(out["ledger"]["used_bytes"] >= tr.state_bytes(cfg),
              "the weights were not charged (cuMemCreate not hooked?)")
        res.update(second_copy_refused(torch, cfg))
        res["stats"] = interposer.stats()
        return res
    fa.flash_attention.launches = 0
    fa.flash_attention.route_launches = dict.fromkeys(fa.ROUTES, 0)
    out = entry.serve("llama3_8b", 2, 512, 4)
    res["launches"] = dict(fa.flash_attention.route_launches)
    res["steps_per_s"] = out["steps_per_s"]
    check(out["enforcer"] is None, "an in-process enforcer installed")
    check(fa.flash_attention.launches == 4 * cfg.n_layers
          == res["launches"]["sm90"], f"launches {res['launches']}")
    tokens = out["tokens"].cuda()
    check(tokens.shape == (2, 512) and int(tokens.max()) < cfg.vocab,
          "tokens out of range")
    res["loop_steps_per_s"] = greedy_rate(torch, out["model"], tokens)
    # Segment granularity: what the interposer charged beside what the
    # caching allocator holds.
    res["charged_bytes"] = interposer.stats()["charged_bytes"]
    res["torch_reserved_bytes"] = torch.cuda.memory_reserved()

    free, total = torch.cuda.mem_get_info()
    ledger = region_ledger(0)
    res["mem_get_info"] = [free, total]
    res["ledger"] = ledger
    check(total == ledger["limit_bytes"] == 20 * 2**30,
          f"mem_get_info total {total} is not the 20 GiB cap")
    check(free == total - ledger["used_bytes"],
          f"mem_get_info free {free} != cap - region used")
    check(ledger["used_bytes"] >= tr.state_bytes(cfg),
          "the weights are not charged")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=memory.total,"
                          "memory.used", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    res["nvidia_smi"] = smi.stdout.strip()
    check(smi.returncode == 0 and int(smi.stdout.split(",")[0]) == 20480,
          f"nvidia-smi does not show the cap: {smi.stdout} {smi.stderr}")
    res["nvml"] = nvml_process_view()

    # One launch of the kernel through ctypes passes the gate once: the
    # kernel library's own (static) CUDA runtime is hooked.
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn((64, 512, 128), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    fa._launch(q, k, v, True, route="sm90")
    torch.cuda.synchronize()
    n0 = interposer.stats()["launches"]
    fa._launch(q, k, v, True, route="sm90")
    torch.cuda.synchronize()
    res["k1_gate_delta"] = interposer.stats()["launches"] - n0
    check(res["k1_gate_delta"] == 1,
          f"one K1 launch passed the gate {res['k1_gate_delta']} times")

    # Every kernel of one forward passed the gate.
    from torch.profiler import ProfilerActivity, profile
    model = out["model"]
    with torch.inference_mode():
        model(tokens)
        torch.cuda.synchronize()
        n0 = interposer.stats()["launches"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(tokens)
            torch.cuda.synchronize()
        gated = interposer.stats()["launches"] - n0
    res["forward"] = {"gated": gated, "profiled": kernel_records(torch, prof)}
    check(gated == res["forward"]["profiled"] > 0,
          f"gate vs profiler over one forward: {res['forward']}")
    del q, k, v, prof
    res.update(second_copy_refused(torch, cfg))   # the model stays loaded
    res["stats"] = interposer.stats()
    return res


def phase_interposed(torch, tmp, direct):
    from vtpu_torch.shim import interposer
    from vtpu_torch.shim.core import SharedRegion

    region = os.path.join(tmp, "interposed.shr")
    env = interposer.tenant_env(dict(QUOTA_ENV,
                                     VTPU_DEVICE_MEMORY_SHARED_CACHE=region))
    got = child(["serve"], env)
    say("interposed serve llama3_8b b=2 s=512: " + json.dumps(got))
    say(f"interposed {got['steps_per_s']:.3f} steps/s vs phase 3 (in-process "
        f"enforcer) {direct['serve']:.3f}: "
        f"{got['steps_per_s'] / direct['serve']:.3f}x; greedy loop "
        f"{got['loop_steps_per_s']:.3f} vs {direct['loop']:.3f} with no "
        f"enforcement: {got['loop_steps_per_s'] / direct['loop']:.3f}x")
    vmm = child(["serve"], dict(
        env, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"))
    say("interposed, expandable segments: " + json.dumps(vmm))
    with SharedRegion(region) as reg:
        reg.active_procs()   # sweeps the slots of exited processes
        used = reg.device_stats(0).used_bytes
    check(used == 0, f"ledger holds {used} bytes after the children exited")
    say("interposed: ledger 0 after the children exited")
    return got


def metered_child(torch, go, report=None):
    """Phase 7, inside one interposed tenant: serve the bench config, then
    wait for ``go`` and run the greedy loop for METERED_S.  The memory
    readings taken before READY also go to the file ``report``, if
    given."""
    from vtpu_torch import entry
    from vtpu_torch.shim import interposer

    check(interposer.loaded(), "the interposer is not in the tenant")
    out = entry.serve("bench", *TENANT_SHAPE, steps=3)
    model, tokens = out["model"], out["tokens"].cuda()
    torch.cuda.synchronize()
    memory = {"charged_bytes": interposer.stats()["charged_bytes"],
              "torch_reserved_bytes": torch.cuda.memory_reserved()}
    if report is not None:
        with open(report, "w") as f:
            json.dump(memory, f)
    print("READY", flush=True)
    while not os.path.exists(go):
        time.sleep(0.005)
    s0 = interposer.stats()
    steps = 0
    t0 = time.monotonic()
    with torch.inference_mode():
        while time.monotonic() - t0 < METERED_S:
            tokens = torch.argmax(model(tokens), dim=-1).int()
            steps += 1
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    s1 = interposer.stats()
    return {"pid": os.getpid(), "steps_per_s": steps / wall,
            "booked_us": s1["booked_us"] - s0["booked_us"],
            "debited_us": s1["debited_us"] - s0["debited_us"],
            "gate_waits": s1["gate_waits"] - s0["gate_waits"],
            "launches": s1["launches"] - s0["launches"],
            "gate_ns_per_launch": (s1["gate_ns"] - s0["gate_ns"]
                                   - s1["wait_ns"] + s0["wait_ns"])
            / max(s1["launches"] - s0["launches"], 1),
            "wall_s": wall, "meter": s1["meter"],
            "busy_ticks": s1["busy_ticks"] - s0["busy_ticks"],
            "shared_ticks": s1["shared_ticks"] - s0["shared_ticks"],
            **memory}


def run_metered(quota, n, tmp, name):
    """``n`` interposed tenants on one region, released together."""
    from vtpu_torch.shim import interposer

    region = os.path.join(tmp, f"{name}.shr")
    env = interposer.tenant_env(dict(
        quota, VTPU_DEVICE_MEMORY_SHARED_CACHE=region))
    return run_released([env] * n, "metered", tmp, name)


def run_released(envs, mode, tmp, name, on_ready=None, args=None):
    """One ``--child <mode> <go> [args[i]...]`` tenant per environment;
    each reports READY after its warm-up, then ``on_ready()`` runs, if
    given, and all are released together by the go file.  Returns their
    RESULT dicts."""
    go = os.path.join(tmp, f"{name}.go")
    # stderr goes to a file: a pipe nobody reads could fill and stall the
    # tenant, and a tenant that dies early is reported with its traceback.
    errs = [open(os.path.join(tmp, f"{name}.{i}.err"), "w+")
            for i in range(len(envs))]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--child", mode, go,
                               *(args[i] if args else ())], env=env,
                              stdout=subprocess.PIPE, stderr=err, text=True)
             for i, (env, err) in enumerate(zip(envs, errs))]

    def stderr_of(i):
        if procs[i].poll() is None:
            return ""
        errs[i].seek(0)
        return errs[i].read()[-3000:]

    try:
        for i, p in enumerate(procs):
            line = p.stdout.readline()
            if line.strip() != "READY":
                try:
                    p.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    pass
            check(line.strip() == "READY", f"tenant not ready: {line!r} "
                  f"(rc {p.poll()}) {stderr_of(i)}")
        if on_ready is not None:
            on_ready()
        open(go, "w").close()
        got = []
        for i, p in enumerate(procs):
            out, _ = p.communicate(timeout=300)
            res = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            check(p.returncode == 0 and res,
                  f"tenant failed (rc {p.returncode}): {stderr_of(i)}")
            got.append(json.loads(res[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for err in errs:
            err.close()
    return got


def phase_metered(tmp):
    share = dict(TENANT_ENV, **METERED_CAP)
    solo100 = run_metered(dict(METERED_CAP, VTPU_DEVICE_CORE_LIMIT="100"), 1,
                          tmp, "solo100")[0]
    solo50 = run_metered(share, 1, tmp, "solo50")[0]
    shared = run_metered(share, 2, tmp, "shared50")
    for label, rows in (("100%", [solo100]), ("50% FORCE", [solo50]),
                        ("two at 50% FORCE", shared)):
        say(f"interposed tenants {label}: " + json.dumps(rows))
    base = solo50["steps_per_s"]
    rates = [r["steps_per_s"] for r in shared]
    say(f"interposed tenants steps/s (bench config b={TENANT_SHAPE[0]} "
        f"s={TENANT_SHAPE[1]}, {METERED_S} s each): 100% "
        f"{solo100['steps_per_s']:.2f}, 50% FORCE {base:.2f} "
        f"({base / solo100['steps_per_s']:.3f} of 100%), shared "
        + ", ".join(f"{r:.2f} ({r / base:.3f})" for r in rates)
        + f", together {sum(rates):.2f} ({sum(rates) / base:.3f} of the 50% "
        "solo rate)")
    check(all(r["meter"] == 1 and r["busy_ticks"] > 0 and r["booked_us"] > 0
              for r in [solo100, solo50, *shared]),
          "a tenant's device time was not metered")
    check(all(r["shared_ticks"] > 0 for r in shared),
          "the two tenants never saw each other busy")
    # What one call into the region costs on this machine: the reason the
    # interposer's launch path makes none.
    from vtpu_torch.shim.core import SharedRegion
    with SharedRegion(os.path.join(tmp, "shared50.shr")) as reg:
        t0 = time.perf_counter()
        for _ in range(2000):
            reg.mem_info(0)
        call_us = (time.perf_counter() - t0) / 2000 * 1e6
    say(f"region call (locked, through ctypes): {call_us:.2f} us")
    check(solo50["gate_waits"] > 0 and base < solo100["steps_per_s"],
          "the 50% share never held the tenant back")


# -- phase 8: the device-plugin daemon's discovery and grants ----------------

# The card is split in two, as --device-split-count 2 does.
PLUGIN_SPLIT = 2
# The container path of a grant's interposer mount (ld.so.preload names
# it).  No container is made here: a tenant gets the host path instead.
PRELOAD_MOUNT = "/usr/local/vtpu/libvtpu_cuda.so"
# Each of two pods granted halves of the card, running at once, against
# one such pod alone: a pod holds its own 50% share beside the other.
# Below 0.65 it is starved of it (metering by region files alone, where
# each pod books the other's time slices as its own, gave 0.54-0.58 on an
# H100: PERF.md).  Phase 7's band (0.30-0.70 each) is for two tenants that
# share ONE bucket, and does not apply to two pods with a bucket each.
SHARED_GRANT_BAND = (0.65, 1.05)
# The device time each of those pods books a step, against the solo pod's
# in the same run.  The card switching between the two makes a step cost
# more device time than alone (1.17-1.31 on an H100); a pod booking the
# other's slices as its own books 1.73-1.87 (region files alone), and one
# that under-bills (each tick divided among more pods than are busy)
# books less than alone (PERF.md).  This reading tells the faults apart
# where the rate cannot: two pods that fill the card are rarely gated.
SHARED_BOOKED_BAND = (1.0, 1.5)


def granted_child(torch, go):
    """Phase 8, inside a tenant started with one grant's env: its cap is
    what mem_get_info reports, then the bench config is served as in
    phase 7, and every attention launch must take the sm90 route."""
    from vtpu_torch.ops import flash_attention as fa
    from vtpu_torch.shim import interposer
    from vtpu_torch.utils.envspec import parse_quantity

    check(interposer.loaded(), "the interposer is not in the tenant")
    cap = parse_quantity(os.environ["VTPU_DEVICE_HBM_LIMIT_0"])
    free, total = torch.cuda.mem_get_info()
    check(total == cap, f"mem_get_info total {total} is not the grant's "
          f"cap {cap}")
    fa.flash_attention.launches = 0
    fa.flash_attention.route_launches = dict.fromkeys(fa.ROUTES, 0)
    res = metered_child(torch, go)
    res["launches_by_route"] = dict(fa.flash_attention.route_launches)
    check(fa.flash_attention.launches > 0 and
          fa.flash_attention.launches == res["launches_by_route"]["sm90"],
          f"attention launches off the sm90 route: "
          f"{res['launches_by_route']}")
    res["mem_get_info"] = [free, total]
    return res


def tenant_env_of(g, region):
    """A tenant's environment from grant ``g``: the grant's env, with the
    host paths of what the container would have mounted (the interposer
    library in LD_PRELOAD, as the ld.so.preload mount would load it; the
    directory of the card busy files), and its region in ``region`` (a
    container's /tmp is its own)."""
    from vtpu_torch.utils import envspec

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("VTPU_", "LD_PRELOAD"))}
    env.update(g.envs)
    host_of = {m.container_path: m.host_path for m in g.mounts}
    env["LD_PRELOAD"] = host_of[PRELOAD_MOUNT]
    busy = g.envs.get(envspec.ENV_DEVICE_BUSY_DIR)
    if busy is not None:
        dirs = {os.path.dirname(h) for c, h in host_of.items()
                if os.path.dirname(c) == busy}
        check(len(dirs) == 1, f"the grant's busy files lie in {dirs}")
        env[envspec.ENV_DEVICE_BUSY_DIR] = dirs.pop()
    env[envspec.ENV_SHARED_CACHE] = region
    return env


def phase_plugin(torch, tmp):
    from vtpu_torch.discovery.factory import make_backend
    from vtpu_torch.plugin.config import Config
    from vtpu_torch.plugin.grant import (grant, stage_busy_files,
                                         staged_files)
    from vtpu_torch.plugin.split import build_plugin_specs
    from vtpu_torch.shim import interposer
    from vtpu_torch.shim.core import SharedRegion
    from vtpu_torch.utils import envspec

    # Discovery through NVML, held against nvidia-smi and torch.
    nvml = make_backend("nvml")
    chips = nvml.chips()
    check(len(chips) == torch.cuda.device_count() == 1,
          f"NVML found {len(chips)} cards")
    chip = chips[0]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=uuid,memory.total",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_uuid, smi_mib = (x.strip() for x in smi.stdout.split(","))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    say(f"discovery nvml: {chip.model} uuid {chip.uuid} (nvidia-smi "
        f"{smi_uuid}), {chip.hbm_bytes} B (nvidia-smi {smi_mib} MiB), "
        f"{chip.sm_count} SMs from {nvml.sm_source} (torch {sms}), minor "
        f"{chip.minor}, bus {chip.pci_bus_id}, NUMA {chip.numa_node}, MIG "
        f"{'on' if chip.mig_enabled else 'off'}, links "
        f"{nvml.topology().links}")
    check(chip.uuid == smi_uuid, "NVML's UUID is not nvidia-smi's")
    check(chip.hbm_bytes // 2**20 == int(smi_mib),
          "NVML's memory total is not nvidia-smi's")
    check(chip.sm_count == sms and nvml.sm_source == "torch",
          f"SM count {chip.sm_count} ({nvml.sm_source}) != {sms}")
    probes = []
    for _ in range(2):   # the first also creates the XID event set
        t0 = time.perf_counter()
        reason = nvml.probe(chip)
        probes.append((time.perf_counter() - t0) * 1e3)
        check(reason is None, f"the healthy card probes unhealthy: {reason}")
    say(f"discovery nvml: the healthy card probes healthy; first probe "
        f"{probes[0]:.3f} ms, then {probes[1]:.3f} ms")
    gpus = "/proc/driver/nvidia/gpus"
    if os.path.isdir(gpus) and os.listdir(gpus):
        proc = make_backend("procfs").chips()
        check([(c.uuid, c.pci_bus_id) for c in proc]
              == [(chip.uuid, chip.pci_bus_id)],
              f"procfs disagrees with NVML: {proc}")
        say(f"discovery procfs: {proc[0].uuid} bus {proc[0].pci_bus_id}, "
            "as NVML")
    else:
        say(f"discovery procfs: LEFT OUT: {gpus} is absent in this "
            "container, so the procfs backend has nothing to read")

    # Split and grant.
    host = os.path.join(tmp, "host")
    staged_files(host, interposer.library_path())
    stage_busy_files(host, [chip.uuid])   # as the daemon does at start
    cfg = Config(device_split_count=PLUGIN_SPLIT, host_lib_dir=host)
    spec, = build_plugin_specs(cfg, nvml)
    check([(v.hbm_bytes, v.core_pct) for v in spec.vdevices]
          == [(chip.hbm_bytes // 2, 50)] * 2, "split 2: "
          f"{[(v.id, v.hbm_bytes, v.core_pct) for v in spec.vdevices]}")
    if not chip.mig_enabled:
        try:
            build_plugin_specs(Config(split_strategy="core"), nvml)
            raise Failed("the core strategy accepted a card without MIG")
        except RuntimeError as e:
            say(f"split core on a card without MIG: refused ({e})")
    grants = [grant(cfg, spec, [v], [v.id]) for v in spec.vdevices]
    for g in grants:
        say("grant: " + json.dumps({"envs": g.envs, "mounts": [
            m.__dict__ for m in g.mounts]}))
        check(g.envs[envspec.ENV_CORE_LIMIT] == "50"
              and g.envs[envspec.ENV_UTILIZATION_POLICY] == "FORCE"
              and envspec.ENV_MIN_EXEC_COST not in g.envs, "grant env")
        check(PRELOAD_MOUNT in [m.container_path for m in g.mounts]
              and "/etc/ld.so.preload" in [m.container_path
                                           for m in g.mounts],
              "the grant does not mount the interposer")
    regions = {g.envs[envspec.ENV_SHARED_CACHE] for g in grants}
    busy = {(g.envs.get(envspec.ENV_DEVICE_BUSY_DIR), m.container_path,
             m.host_path, m.read_only)
            for g in grants for m in g.mounts if "busy" in m.container_path}
    check(len(regions) == 2 and len(busy) == 1
          and next(iter(busy))[1].endswith(f"/{chip.uuid}.busy"),
          f"two grants: regions {regions}, busy files {busy}")

    # Two pods: each tenant with exactly its grant's env.
    def run(name, which, busy_dir=True):
        envs = []
        for i in which:
            env = tenant_env_of(grants[i], os.path.join(tmp,
                                                        f"{name}.{i}.shr"))
            if not busy_dir:
                del env[envspec.ENV_DEVICE_BUSY_DIR]
            envs.append(env)
        rows = run_released(envs, "granted", tmp, name)
        for i in which:
            with SharedRegion(os.path.join(tmp, f"{name}.{i}.shr")) as reg:
                reg.active_procs()   # sweeps the slots of exited processes
                used = reg.device_stats(0).used_bytes
            check(used == 0, f"{name}: region {i} holds {used} bytes after "
                  "its tenant exited")
        for r in rows:
            r["booked_us_per_step"] = r["booked_us"] / max(
                r["steps_per_s"] * r["wall_s"], 1)
        say(f"plugin {name}: " + json.dumps(rows))
        return rows

    solo = run("grant_solo", [0])[0]
    pair = run("grant_pair", [0, 1])
    old = run("grant_pair_region_files", [0, 1], busy_dir=False)
    base = solo["steps_per_s"]

    def line(rows):
        rates = [r["steps_per_s"] for r in rows]
        return (", ".join(f"{r:.2f} ({r / base:.3f})" for r in rates)
                + f", together {sum(rates) / base:.3f}; booked us/step "
                + ", ".join(f"{r['booked_us_per_step']:.0f}" for r in rows)
                + "; shared ticks "
                + ", ".join(str(r["shared_ticks"]) for r in rows))
    say(f"plugin two grants (bench b={TENANT_SHAPE[0]} s={TENANT_SHAPE[1]}, "
        f"{METERED_S} s each): solo {base:.2f} steps/s, booked us/step "
        f"{solo['booked_us_per_step']:.0f}; pair, per-card busy file: "
        f"{line(pair)}; pair, region files only (information): "
        f"{line(old)}")
    check(all(r["meter"] == 1 and r["booked_us"] > 0
              for r in [solo, *pair, *old]), "a tenant was not metered")
    check(all(r["shared_ticks"] > 0 for r in pair),
          "the two grants never saw each other busy on the card")
    # Each pod owns a 50% bucket, so beside the other it should hold its
    # whole share: about the solo grant's rate, less the card's cost of
    # switching between the two.  Booking the other pod's slices as its
    # own (region files only) held each to 0.57-0.58 (PERF.md).
    rates = [r["steps_per_s"] / base for r in pair]
    check(all(SHARED_GRANT_BAND[0] <= x <= SHARED_GRANT_BAND[1]
              for x in rates),
          f"shared grants at {rates} of the solo grant's rate (band "
          f"{SHARED_GRANT_BAND} each)")
    booked = [r["booked_us_per_step"] / solo["booked_us_per_step"]
              for r in pair]
    say(f"plugin two grants: booked device time a step of each against the "
        f"solo grant's: {', '.join(f'{x:.3f}' for x in booked)}; region "
        "files only (information): " + ", ".join(
            f"{r['booked_us_per_step'] / solo['booked_us_per_step']:.3f}"
            for r in old))
    check(all(SHARED_BOOKED_BAND[0] <= x <= SHARED_BOOKED_BAND[1]
              for x in booked),
          f"shared grants booked {booked} of the solo grant's device time a "
          f"step (band {SHARED_BOOKED_BAND})")


# -- phase 9: training --------------------------------------------------------

TRAIN_SHAPE = (4, 512)     # bench.py's batch and sequence
TRAIN_STEPS = 6
TRAIN_CAP = {"VTPU_DEVICE_HBM_LIMIT_0": "16Gi", "VTPU_DEVICE_CORE_LIMIT": "100"}
# Below the bench config's weights, gradients and Adam state alone (4.03
# GB in bf16): training must be refused.
SMALL_CAP = {"VTPU_DEVICE_HBM_LIMIT_0": "3Gi", "VTPU_DEVICE_CORE_LIMIT": "100"}
# The card against the CPU, one Adam step of the tiny model in f32 with
# TF32 off: the loss to rtol 1e-5; each weight within 1e-5 on at least
# 99.9% of each tensor's elements and within 2·lr everywhere (where |g| is
# near 0, summation order can flip the sign of Adam's first step; the same
# tolerance holds the port to vtpu in tests/test_torch_train.py).
PARITY_LR = 1e-3
PARITY_TOL = 1e-5
PARITY_SHARE = 0.999


def train_flops(cfg, batch, seq):
    """Model FLOPs of one training step: 6 per matmul weight per token
    (forward and backward), plus the plain attention's two s×s products,
    forward and backward, over every (query, key) pair."""
    from vtpu_torch.models import transformer as tr

    matmul = sum(math.prod(shape) for name, shape, _ in tr.param_shapes(cfg)
                 if len(shape) == 2 and not name.endswith("embed"))
    attention = 3 * 4 * batch * seq * seq * cfg.dim * cfg.n_layers
    return 6 * matmul * batch * seq + attention


def train_parity_child(torch):
    """Phase 9, a child with no quota: the tiny model's Adam step on the
    card and on the CPU, from the same weights and tokens."""
    import numpy as np

    from vtpu_torch import entry
    from vtpu_torch.models import transformer as tr
    from vtpu_torch.models.convert import init_module, params_to_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(tr.TransformerConfig.tiny(),
                              dtype=torch.float32)
    weights = params_to_numpy(init_module(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (4, 33),
                                               dtype=np.int32)
    runs = {dev: entry.train(cfg, 4, 32, steps=1, device=dev,
                             lr=PARITY_LR, weights=weights, tokens=tokens)
            for dev in ("cpu", "cuda")}
    cpu, gpu = (params_to_numpy(runs[d]["model"]) for d in ("cpu", "cuda"))
    pairs = [(k, cpu[k], gpu[k]) for k in cpu if k != "layers"] + [
        (f"layers.{i}.{k}", v, gpu["layers"][i][k])
        for i, layer in enumerate(cpu["layers"]) for k, v in layer.items()]
    worst, share = 0.0, 1.0
    for name, a, b in pairs:
        diff = np.abs(a.astype(np.float64) - b)
        worst = max(worst, float(diff.max()))
        share = min(share, float(np.mean(diff <= PARITY_TOL)))
    losses = [runs[d]["losses"][0] for d in ("cpu", "cuda")]
    res = {"losses": losses, "max_abs_err": worst,
           "least_share_within_tol": share}
    check(abs(losses[1] - losses[0]) <= PARITY_TOL * abs(losses[0]),
          f"loss on the card {losses[1]} vs the CPU {losses[0]}")
    check(worst <= 2 * PARITY_LR and share >= PARITY_SHARE,
          f"weights after one step, card vs CPU: {res}")
    return res


def train_child(torch):
    """Phase 9, one interposed tenant: TRAIN_STEPS Adam steps of the bench
    config on one fixed block under the env's cap."""
    from vtpu_torch import entry
    from vtpu_torch.models import transformer as tr
    from vtpu_torch.shim import interposer
    from vtpu_torch.utils.envspec import parse_quantity

    check(interposer.loaded(), "the interposer is not in the tenant")
    cap = parse_quantity(os.environ["VTPU_DEVICE_HBM_LIMIT_0"])
    cfg = tr.TransformerConfig.bench()
    try:
        out = entry.train("bench", *TRAIN_SHAPE, steps=TRAIN_STEPS)
    except torch.OutOfMemoryError as e:
        return {"refused": str(e).splitlines()[0][:300],
                "stats": interposer.stats()}
    check(out["enforcer"] is None, "an in-process enforcer installed")
    used = [ledger["used_bytes"] for ledger in out["step_ledgers"]]
    res = {"losses": out["losses"], "steps_per_s": out["steps_per_s"],
           "tokens_per_s": out["tokens_per_s"], "used_bytes": used,
           "limit_bytes": out["ledger"]["limit_bytes"],
           "torch_max_reserved_bytes": torch.cuda.max_memory_reserved(),
           "torch_max_allocated_bytes": torch.cuda.max_memory_allocated(),
           "stats": interposer.stats()}
    check(all(math.isfinite(x) for x in out["losses"]),
          f"non-finite loss: {out['losses']}")
    check(out["losses"][-1] < out["losses"][0],
          f"the loss did not fall: {out['losses']}")
    check(res["limit_bytes"] == cap and all(u <= cap for u in used),
          f"a step's charge passed the {cap}-byte cap: {used}")
    # Weights and Adam's two moments are charged from the first step on.
    check(all(u >= 3 * tr.state_bytes(cfg) for u in used),
          f"the training state is not charged: {used}")
    # Where a step's device time goes: one more step, profiled.
    step, _ = tr.make_train_step(out["model"])
    block = torch.randint(0, cfg.vocab, (TRAIN_SHAPE[0], TRAIN_SHAPE[1] + 1),
                          device="cuda", dtype=torch.int32)
    step(block)
    res["breakdown"] = device_breakdown(torch, lambda: step(block))
    res["array_charges"] = array_charges(interposer)
    return res


def array_charges(interposer):
    """On the card's driver: a 16 MiB CUDA array and a 64 MiB graph memory
    node are charged exactly, and their destroys return the charge; a
    launched node's charge lasts until its allocation is freed."""
    import ctypes

    c_size, c_uint, c_int = ctypes.c_size_t, ctypes.c_uint, ctypes.c_int

    class ArrayDesc(ctypes.Structure):   # CUDA_ARRAY_DESCRIPTOR
        _fields_ = [("Width", c_size), ("Height", c_size),
                    ("Format", c_int), ("NumChannels", c_uint)]

    class NodeParams(ctypes.Structure):  # CUDA_MEM_ALLOC_NODE_PARAMS
        _fields_ = [("allocType", c_int), ("handleTypes", c_int),
                    ("locationType", c_int), ("locationId", c_int),
                    ("win32SecurityAttributes", ctypes.c_void_p),
                    ("tail", ctypes.c_ubyte * 64),
                    ("accessDescs", ctypes.c_void_p),
                    ("accessDescCount", c_size), ("bytesize", c_size),
                    ("dptr", ctypes.c_uint64)]

    cu = ctypes.CDLL("libcuda.so.1")

    def charged():
        return interposer.stats()["charged_bytes"]

    res = {}
    base = charged()
    arr = ctypes.c_void_p()
    rc = cu.cuArrayCreate_v2(ctypes.byref(arr), ctypes.byref(
        ArrayDesc(1024, 1024, 0x20, 4)))     # 1024 x 1024 float4
    res["array"] = [rc, charged() - base]
    rc = cu.cuArrayDestroy(arr)
    res["array"] += [rc, charged() - base]
    check(res["array"] == [0, 16 * 2**20, 0, 0],
          f"CUDA array (rc, charged, rc, charged): {res['array']}")
    graph, node = ctypes.c_void_p(), ctypes.c_void_p()
    check(cu.cuGraphCreate(ctypes.byref(graph), 0) == 0, "cuGraphCreate")
    params = NodeParams(allocType=1, locationType=1, locationId=0,
                        bytesize=64 * 2**20)
    rc = cu.cuGraphAddMemAllocNode(ctypes.byref(node), graph, None,
                                   ctypes.c_size_t(0), ctypes.byref(params))
    res["graph_node"] = [rc, charged() - base]
    rc = cu.cuGraphDestroy(graph)
    res["graph_node"] += [rc, charged() - base]
    check(res["graph_node"] == [0, 64 * 2**20, 0, 0],
          f"graph memory node (rc, charged, rc, charged): "
          f"{res['graph_node']}")
    # Instantiated and launched, the node's charge outlives its graph (which
    # the driver refuses to clone), then its executable graph, and goes
    # with the free of the allocation the launch left.
    exe, clone = ctypes.c_void_p(), ctypes.c_void_p()
    check(cu.cuGraphCreate(ctypes.byref(graph), 0) == 0, "cuGraphCreate")
    steps = [cu.cuGraphAddMemAllocNode(
        ctypes.byref(node), graph, None, ctypes.c_size_t(0),
        ctypes.byref(params))]
    steps.append(cu.cuGraphClone(ctypes.byref(clone), graph))
    steps.append(cu.cuGraphInstantiateWithFlags(ctypes.byref(exe), graph,
                                                ctypes.c_ulonglong(0)))
    steps.append(cu.cuGraphDestroy(graph))
    steps.append(cu.cuGraphLaunch(exe, None))
    steps.append(cu.cuCtxSynchronize())
    held = [charged() - base]
    steps.append(cu.cuGraphExecDestroy(exe))
    held.append(charged() - base)
    steps.append(cu.cuMemFree_v2(ctypes.c_uint64(params.dptr)))
    held.append(charged() - base)
    res["graph_exec"] = {"rcs": steps, "charged": held}
    check(steps[0] == 0 and steps[1] != 0 and not any(steps[2:]),
          f"graph memory node, launched (rcs): {steps}")
    check(held == [64 * 2**20, 64 * 2**20, 0],
          f"graph memory node after its graph, its executable graph and "
          f"the free (charged): {held}")
    return res


def phase_train(torch, tmp):
    from vtpu_torch import entry
    from vtpu_torch.models import transformer as tr
    from vtpu_torch.ops import flash_attention as fa
    from vtpu_torch.shim import interposer
    from vtpu_torch.shim.core import SharedRegion

    plain_env = {k: v for k, v in os.environ.items()
                 if not k.startswith(("VTPU_", "LD_PRELOAD"))}
    parity = child(["train_parity"], plain_env)
    say("train parity, tiny f32, one Adam step, card vs CPU: "
        + json.dumps(parity))

    cfg = tr.TransformerConfig.bench()
    flops = train_flops(cfg, *TRAIN_SHAPE)
    runs = {}
    for name, cap in (("train16", TRAIN_CAP), ("train3", SMALL_CAP)):
        region = os.path.join(tmp, f"{name}.shr")
        env = interposer.tenant_env(dict(
            cap, VTPU_DEVICE_MEMORY_SHARED_CACHE=region))
        runs[name] = child(["train"], env)
        with SharedRegion(region) as reg:
            reg.active_procs()   # sweeps the slots of exited processes
            used = reg.device_stats(0).used_bytes
        check(used == 0, f"{name}: ledger holds {used} bytes after the "
              "tenant exited")
        say(f"train {name}: " + json.dumps(runs[name]))
    big, small = runs["train16"], runs["train3"]
    check("refused" not in big, f"training refused under 16 GiB: {big}")
    check("refused" in small and small["stats"]["refused"] > 0,
          f"training admitted under 3 GiB: {small}")
    step_ms = 1e3 / big["steps_per_s"]
    say(f"train bench b={TRAIN_SHAPE[0]} s={TRAIN_SHAPE[1]} under the "
        f"interposer (16 GiB, core 100%): losses "
        f"{', '.join(f'{x:.4f}' for x in big['losses'])}; {step_ms:.3f} ms "
        f"a step, {big['tokens_per_s']:.0f} tokens/s, "
        f"{flops / 1e12:.3f} TFLOP a step, "
        f"{flops / step_ms / 1e9:.1f} TFLOP/s "
        f"({flops / step_ms * 1e3 / PEAK_BF16_FLOPS:.3f} of the bf16 dense "
        f"peak); peak charge {max(big['used_bytes']) / 2**30:.2f} GiB; "
        f"3 GiB cap refused: {small['refused']}")

    loss = entry.dryrun_multichip(1, "cuda")
    check(math.isfinite(loss), f"dry-run loss {loss}")
    say(f"dryrun_multichip(1) over NCCL: loss {loss:.6f}")

    q = torch.randn((2, 128, 128), device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    n0 = fa.flash_attention.launches
    try:
        fa.flash_attention(q, q, q)
        raise Failed("the attention kernel took tensors that require grad")
    except RuntimeError as e:
        check("no backward" in str(e), f"wrong refusal: {e}")
        say(f"flash_attention with grad: refused ({e})")
    check(fa.flash_attention.launches == n0, "the refused call launched")
    return {"parity": parity, "train": big, "refused": small,
            "dryrun_loss": loss, "flops_per_step": flops}


# -- phase 10: a pod as the kubelet would start it ---------------------------

# Two pods pending on the node, each asking for one vtpu; pod A declares a
# PYTHONPATH of its own, which Allocate keeps behind the shim's entry.
APP_DIR = "/app/lib"
PODS = [{"metadata": {"namespace": "default", "name": name, "uid": uid},
         "status": {"phase": "Pending"},
         "spec": {"containers": [{
             "name": "main", "env": env,
             "resources": {"limits": {"4paradigm.com/vtpu": "1"}}}]}}
        for name, uid, env in (
            ("pod-a", "aaaa0000-0000", [{"name": "PYTHONPATH",
                                         "value": APP_DIR}]),
            ("pod-b", "bbbb0000-0000", []))]
# The live pod that the legacy controller's checkpoint gives vdevice 0.
LIVE_POD = {"metadata": {"namespace": "default", "name": "old",
                         "uid": "live0000-0000"},
            "status": {"phase": "Running"}, "spec": {"containers": []}}
# The Python enforcement's tenant: pod A's grant without the interposer,
# under a cap that admits the bench config's weights (1.01 GB in bf16)
# once and refuses a second copy.
PY_CAP = "1536Mi"
CONTAINER_LIB = "/usr/local/vtpu"
COMPILED_S = 4.0           # the compiled forward's timed window, per share


class FakeKubelet:
    """The kubelet's side of the device-plugin API: the Registration
    service on ``<dir>/kubelet.sock``, and a client of each plugin."""

    def __init__(self, plugin_dir):
        import grpc
        from concurrent import futures

        from vtpu_torch.proto import pb, rpc

        self.dir, self.pb, self.rpc, self.grpc = plugin_dir, pb, rpc, grpc
        self.registrations = queue.Queue()
        kubelet = self

        class Registration(rpc.RegistrationServicer):
            def Register(self, request, context):
                kubelet.registrations.put(request)
                return pb.Empty()

        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
        rpc.add_RegistrationServicer_to_server(Registration(), self.server)
        self.server.add_insecure_port(
            f"unix://{os.path.join(plugin_dir, 'kubelet.sock')}")
        self.server.start()

    def plugin(self, timeout=30):
        """(registration, stub, channel) of the next plugin to register."""
        reg = self.registrations.get(timeout=timeout)
        ch = self.grpc.insecure_channel(
            f"unix://{os.path.join(self.dir, reg.endpoint)}")
        self.grpc.channel_ready_future(ch).result(timeout=10)
        return reg, self.rpc.DevicePluginStub(ch), ch

    def allocate(self, stub, ids):
        """One container's Allocate answer, as (envs, mounts, annotations)
        with mounts as (container path, host path, read-only)."""
        car = stub.Allocate(self.pb.AllocateRequest(container_requests=[
            self.pb.ContainerAllocateRequest(devicesIDs=ids)]),
            timeout=30).container_responses[0]
        return (dict(car.envs), [(m.container_path, m.host_path, m.read_only)
                                 for m in car.mounts],
                dict(car.annotations))

    def stop(self):
        self.server.stop(grace=1).wait()


def pod_env(envs, mounts, image):
    """A tenant's environment from an Allocate answer: the base
    environment without any VTPU_*, preload or PYTHONPATH, the answer's
    env, and every container path in it mapped to the host path the
    container would see there (through the answer's mounts; a path under
    no mount lies in the pod's image, ``image``).  The interposer goes in
    LD_PRELOAD, as the ld.so.preload mount would load it."""
    host_of_mount = {c: h for c, h, _ in mounts}

    def host(path):
        for c in sorted(host_of_mount, key=len, reverse=True):
            if path == c or path.startswith(c + "/"):
                return host_of_mount[c] + path[len(c):]
        busy = [h for c, h, _ in mounts if os.path.dirname(c) == path]
        if busy:    # the busy dir: a mount per card file, no mount of its own
            return os.path.dirname(busy[0])
        return image + path

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("VTPU_", "LD_PRELOAD", "PYTHONPATH"))}
    env.update(envs)
    for key in ("VTPU_DEVICE_MEMORY_SHARED_CACHE", "VTPU_SHIM_PYTHONPATH",
                "VTPU_DEVICE_BUSY_DIR"):
        if key in env:
            env[key] = host(env[key])
    env["PYTHONPATH"] = ":".join(host(p) for p in envs["PYTHONPATH"]
                                 .split(":"))
    lib = host_of_mount[f"{CONTAINER_LIB}/libvtpu_cuda.so"]
    with open(host_of_mount["/etc/ld.so.preload"]) as f:
        check(f.read().split() == [f"{CONTAINER_LIB}/libvtpu_cuda.so"],
              "ld.so.preload does not name the interposer's mount")
    env["LD_PRELOAD"] = lib
    return env


def bootstrap_seen(interposed):
    """What the in-container bootstrap did in this tenant, checked: the
    shim's sitecustomize ran, the port came from the staged shim, and the
    quota went to the interposer (``interposed``) or to the Python
    enforcement, never to both."""
    import vtpu_torch
    from vtpu_torch.shim import interposer, pyshim

    shim = os.environ["VTPU_SHIM_PYTHONPATH"]
    site = getattr(sys.modules.get("sitecustomize"), "__file__", None)
    res = {"sitecustomize": site, "package": vtpu_torch.__file__,
           "interposer": interposer.loaded(), "layer": pyshim.bootstrap(),
           "enforcer": pyshim.enforcer() is not None}
    check(site == os.path.join(shim, "sitecustomize.py"),
          f"the shim's sitecustomize did not run: {res}")
    check(vtpu_torch.__file__.startswith(shim + "/"),
          f"the port did not come from the staged shim: {res}")
    check(res["interposer"] == interposed and res["enforcer"] != interposed
          and res["layer"] == ("interposer" if interposed else "python"),
          f"the quota's layer: {res}")
    return res


def pod_child(torch, go, report):
    """Phase 10, one pod's tenant, started with its grant's env: the
    bootstrap stood down under the interposer; pod A sees its own
    PYTHONPATH after the shim's entry; the bench config served through
    ``entry.serve`` with every attention launch on the sm90 route; its
    charge written to ``report`` at READY, before the views are read; then
    served for METERED_S after ``go``."""
    from vtpu_torch.ops import flash_attention as fa
    from vtpu_torch.shim import interposer
    from vtpu_torch.utils.envspec import parse_quantity

    res = bootstrap_seen(interposed=True)
    shim = os.environ["VTPU_SHIM_PYTHONPATH"]
    entries = os.environ["PYTHONPATH"].split(":")
    res["pythonpath"] = entries
    if len(entries) > 1:          # pod A: its app dir, after the shim
        app = entries[1]
        check(sys.path.index(shim) < sys.path.index(app),
              f"the pod's PYTHONPATH is not after the shim: {sys.path}")
        import pod_app
        res["app"] = pod_app.MARK
    cap = parse_quantity(os.environ["VTPU_DEVICE_HBM_LIMIT_0"])
    free, total = torch.cuda.mem_get_info()
    check(total == cap, f"mem_get_info total {total} != cap {cap}")
    fa.flash_attention.launches = 0
    fa.flash_attention.route_launches = dict.fromkeys(fa.ROUTES, 0)
    res.update(metered_child(torch, go, report))
    res["launches_by_route"] = dict(fa.flash_attention.route_launches)
    check(fa.flash_attention.launches > 0 and fa.flash_attention.launches
          == res["launches_by_route"]["sm90"],
          f"attention launches off the sm90 route: {res['launches_by_route']}")
    res["charged_end"] = interposer.stats()["charged_bytes"]
    return res


def pyshim_child(torch):
    """Phase 10's tenant under the Python enforcement alone (no
    interposer): an unmodified script moves the bench config's weights to
    the card, once admitted, again refused; then a ``torch.compile``d
    forward runs for COMPILED_S under the grant's share."""
    from vtpu_torch.models import transformer as tr
    from vtpu_torch.models.convert import init_module
    from vtpu_torch.shim import pyshim

    res = bootstrap_seen(interposed=False)
    enf = pyshim.enforcer()
    cfg = tr.TransformerConfig.bench()
    model = init_module(cfg, torch.Generator().manual_seed(0), "cpu")
    model.to("cuda")                                 # the first copy
    torch.cuda.synchronize()
    res["weights_bytes"] = tr.state_bytes(cfg)
    res["after_first"] = enf.ledger()["used_bytes"]
    check(res["after_first"] == res["weights_bytes"],
          f"the first copy charged {res['after_first']} bytes, the weights "
          f"are {res['weights_bytes']}")
    allocated = torch.cuda.memory_allocated()
    fresh = tr.Transformer(cfg).to_empty(device="cpu")
    try:
        fresh.to("cuda")
        raise Failed("a second copy of the weights was admitted")
    except MemoryError as e:
        check("RESOURCE_EXHAUSTED" in str(e), f"wrong refusal: {e}")
        res["refusal"] = str(e)[:200]
    check(torch.cuda.memory_allocated() == allocated
          and enf.ledger()["used_bytes"] == res["after_first"]
          and next(fresh.parameters()).device.type == "cpu",
          "the refused copy allocated or charged")
    del fresh
    model.cfg = dataclasses.replace(cfg, use_flash=False)
    forward = torch.compile(model)
    tokens = torch.zeros(TENANT_SHAPE, dtype=torch.int32).to("cuda")
    with torch.inference_mode():
        t0 = time.monotonic()
        forward(tokens)                  # compiles: ungated, unbooked
        res["compile_s"] = time.monotonic() - t0
        waits0, busy0 = enf.gate_waits(), enf.ledger()["proc_busy_us"]
        steps, t0 = 0, time.monotonic()
        while time.monotonic() - t0 < COMPILED_S:
            logits = forward(tokens)
            steps += 1
        wall = time.monotonic() - t0
    check(logits.shape == (*TENANT_SHAPE, cfg.vocab)
          and torch.isfinite(logits).all().item(), "bad compiled logits")
    res.update(steps_per_s=steps / wall, gate_waits=enf.gate_waits() - waits0,
               booked_us=enf.ledger()["proc_busy_us"] - busy0,
               core_pct=enf.spec.core_limit_pct)
    check(res["booked_us"] > 0, "the compiled forward booked no time")
    return res


def write_checkpoint(path, pb, pod_uid, request, using):
    """The kubelet's checkpoint with one pod's Allocate answer, annotated
    as the legacy controller annotates it."""
    import base64

    car = pb.ContainerAllocateResponse()
    car.annotations["4paradigm.com/vtpu-request"] = ",".join(request)
    car.annotations["4paradigm.com/vtpu-using"] = ",".join(using)
    with open(path, "w") as f:
        json.dump({"Data": {"PodDeviceEntries": [{
            "PodUID": pod_uid, "ContainerName": "main",
            "ResourceName": "4paradigm.com/vtpu", "DeviceIDs": request,
            "AllocResp": base64.b64encode(car.SerializeToString()).decode(),
        }], "RegisteredDevices": {}}, "Checksum": 0}, f)


def region_used(path):
    from vtpu_torch.shim.core import SharedRegion

    with SharedRegion(path) as reg:
        reg.active_procs()   # sweeps the slots of exited processes
        return int(reg.device_stats(0).used_bytes)


def phase_pods(torch, tmp):
    from vtpu_torch.plugin.config import parse_args
    from vtpu_torch.plugin.grant import stage_shim, staged_files
    from vtpu_torch.plugin.main import Daemon
    from vtpu_torch.proto import pb
    from vtpu_torch.shim import interposer
    from vtpu_torch.utils.envspec import parse_quantity

    host = os.path.join(tmp, "pods-host")
    plugins = os.path.join(tmp, "pods-kubelet")
    os.makedirs(plugins)
    staged_files(host, interposer.library_path())
    t0 = time.monotonic()
    staged = stage_shim(host)
    say(f"pods: shim staged in {time.monotonic() - t0:.2f} s: "
        + json.dumps(staged))
    lists = []

    def lister(node):
        lists.append(node)
        return PODS + [LIVE_POD]

    def daemon(*flags):
        cfg = parse_args(["--discovery", "nvml", "--device-split-count", "2",
                          "--monitor-mode", "true", "--node-name", "chip",
                          "--device-plugin-path", plugins + "/",
                          "--host-lib-dir", host, *flags])
        d = Daemon(cfg, pod_lister=lister)
        check(d.start_plugins(), "the daemon did not start its plugin")
        return d

    # 1. The daemon and two Allocates from the kubelet.
    kubelet = FakeKubelet(plugins)
    d = daemon()
    try:
        reg, stub, ch = kubelet.plugin()
        check(reg.options.get_preferred_allocation_available,
              "monitor mode alone advertises preferred allocation")
        ids = [dev.ID for dev in next(stub.ListAndWatch(pb.Empty()))
               .devices]
        check(len(ids) == 2, f"the card split in two: {ids}")
        answers = [kubelet.allocate(stub, [i]) for i in ids]
        ch.close()
    finally:
        d.stop_plugins()
    images, envs = [], []
    for (genv, mounts, ann), pod in zip(answers, PODS):
        say("pods: grant of " + pod["metadata"]["name"] + ": " + json.dumps(
            {"envs": genv, "mounts": mounts}))
        name = f"default_{pod['metadata']['name']}_main_" \
               f"{pod['metadata']['uid'][:8]}"
        region = f"{CONTAINER_LIB}/shared/{name}/vtpushr.cache"
        check(genv["VTPU_DEVICE_MEMORY_SHARED_CACHE"] == region,
              f"{name}: region {genv['VTPU_DEVICE_MEMORY_SHARED_CACHE']}")
        check((os.path.dirname(region), f"{host}/shared/{name}", False)
              in mounts and sum("/shared" in c for c, _, _ in mounts) == 1,
              f"{name}: its own shared dir, and no other, mounted")
        check({f"{CONTAINER_LIB}/shim", f"{CONTAINER_LIB}/libvtpucore.so",
               f"{CONTAINER_LIB}/vtpu-smi", "/etc/ld.so.preload"}
              <= {c for c, _, _ in mounts} and not ann,
              f"{name}: the bootstrap's mounts")
        image = os.path.join(tmp, f"image-{pod['metadata']['name']}")
        app = image + APP_DIR
        os.makedirs(app)
        with open(os.path.join(app, "pod_app.py"), "w") as f:
            f.write(f"MARK = {pod['metadata']['name']!r}\n")
        images.append(image)
        envs.append(pod_env(genv, mounts, image))
    check(answers[0][0]["PYTHONPATH"] == f"{CONTAINER_LIB}/shim:{APP_DIR}"
          and answers[0][0]["VTPU_PYTHONPATH_MERGED"] == "1"
          and answers[1][0]["PYTHONPATH"] == f"{CONTAINER_LIB}/shim"
          and "VTPU_PYTHONPATH_MERGED" not in answers[1][0],
          "PYTHONPATH merged for pod A only")
    regions = [e["VTPU_DEVICE_MEMORY_SHARED_CACHE"] for e in envs]
    check(len(set(regions)) == 2 and all(
        r.startswith(f"{host}/shared/") for r in regions),
        f"two regions under the host's shared/: {regions}")

    # 2-3. Both pods' tenants at once; their views while they hold the
    # card (served, idle until released).
    reports = [os.path.join(tmp, f"pod{i}.report") for i in range(2)]
    views = {}

    def read_views():
        smi = staged["vtpu-smi"]
        for i, env in enumerate(envs):
            r = subprocess.run([sys.executable, smi, "--json"], env=env,
                               capture_output=True, text=True, timeout=120,
                               cwd=tmp)
            check(r.returncode == 0, f"vtpu-smi failed: {r.stderr[-2000:]}")
            with open(reports[i]) as f:
                charged = json.load(f)["charged_bytes"]
            views[i] = {"smi": json.loads(r.stdout), "charged": charged,
                        "host_used": region_used(regions[i])}

    rows = run_released(envs, "pod", tmp, "pods", on_ready=read_views,
                        args=[[r] for r in reports])
    for i, (row, view) in enumerate(zip(rows, views.values())):
        cap = parse_quantity(answers[i][0]["VTPU_DEVICE_HBM_LIMIT_0"])
        smi = view["smi"]
        say(f"pods: pod {'AB'[i]} view: " + json.dumps(view))
        say(f"pods: pod {'AB'[i]} tenant: " + json.dumps(row))
        check(smi["grant"] and smi["devices"][0]["chip"]
              == answers[i][0]["VTPU_DEVICE_MAP"].split(":", 1)[1]
              and smi["region"][0]["limit"] == cap,
              f"pod {i}: vtpu-smi's grant and cap {smi}")
        # Its own charge exactly: the other pod's bytes would show as more.
        check(smi["region"][0]["used"] == view["charged"]
              == view["host_used"] > 0,
              f"pod {i}: the view's ledger is not its interposer's charge")
        check(smi["cards"][0]["live"] == 2,
              f"pod {i}: the card's busy file holds {smi['cards']}")
    check(rows[0]["app"] == "pod-a" and "app" not in rows[1],
          "pod A's PYTHONPATH")
    for i, r in enumerate(regions):
        used = region_used(r)
        check(used == 0, f"pod {i}: region holds {used} bytes after exit")
    rates = ", ".join(f"{r['steps_per_s']:.2f}" for r in rows)
    charges = [v["charged"] for v in views.values()]
    say(f"pods: two monitor-mode pods, regions {', '.join(regions)}; views "
        f"= interposer charges {charges}; bench {rates} steps/s; ledgers 0 "
        "after exit")

    # 4. The Python enforcement, without the interposer.
    py = {}
    for pct in ("50", "100"):
        env = {k: v for k, v in envs[0].items() if k != "LD_PRELOAD"}
        env.update(VTPU_DEVICE_HBM_LIMIT_0=PY_CAP, VTPU_DEVICE_CORE_LIMIT=pct,
                   VTPU_DEVICE_MEMORY_SHARED_CACHE=os.path.join(
                       os.path.dirname(regions[0]), f"python{pct}.cache"))
        py[pct] = child(["pyshim"], env, timeout=900)
        say(f"pods: python enforcement at {pct}%: " + json.dumps(py[pct]))
        used = region_used(env["VTPU_DEVICE_MEMORY_SHARED_CACHE"])
        check(used == 0, f"python enforcement: {used} bytes after exit")
    check(py["50"]["gate_waits"] > 0, "the 50% share never held the "
          "compiled forward")
    say(f"pods: compiled bench forward b={TENANT_SHAPE[0]} "
        f"s={TENANT_SHAPE[1]}: {py['50']['steps_per_s']:.2f} steps/s at 50% "
        f"FORCE, {py['100']['steps_per_s']:.2f} at 100% "
        f"({py['50']['steps_per_s'] / py['100']['steps_per_s']:.3f}); "
        f"compile {py['50']['compile_s']:.1f} s, "
        f"{py['100']['compile_s']:.1f} s")

    # 5. The legacy controller: vdevice 0 is the live pod's in the
    # kubelet's checkpoint (asked for as 1), so the stale ID 0 is re-picked.
    write_checkpoint(os.path.join(plugins, "kubelet_internal_checkpoint"), pb,
                     LIVE_POD["metadata"]["uid"], [ids[1]], [ids[0]])
    d = daemon("--enable-legacy-preferred", "true")
    try:
        reg, stub, ch = kubelet.plugin()
        genv, mounts, ann = kubelet.allocate(stub, [ids[0]])
        ch.close()
    finally:
        d.stop_plugins()
        kubelet.stop()
    say("pods: legacy Allocate of the stale " + ids[0] + ": " + json.dumps(
        {"annotations": ann, "VTPU_DEVICE_MAP": genv["VTPU_DEVICE_MAP"]}))
    check(not reg.options.get_preferred_allocation_available,
          "the legacy controller advertises preferred allocation")
    check(ann == {"4paradigm.com/vtpu-request": ids[0],
                  "4paradigm.com/vtpu-using": ids[1]},
          f"the controller did not re-pick vdevice 1: {ann}")
    check(genv["VTPU_DEVICE_HBM_LIMIT_0"]
          == answers[1][0]["VTPU_DEVICE_HBM_LIMIT_0"],
          "the re-picked grant's cap")
    check(all(node == "chip" for node in lists), f"pod lists for {lists}")
    return {"views": views, "tenants": rows, "python": py, "host": host}


# -- phase 11: what a pod sees ------------------------------------------------

# Two more pods pending on the node, granted halves of the card with
# metricsd's port.
VIEW_PODS = [{"metadata": {"namespace": "default", "name": name, "uid": uid},
              "status": {"phase": "Pending"},
              "spec": {"containers": [{
                  "name": "main", "env": [],
                  "resources": {"limits": {"4paradigm.com/vtpu": "1"}}}]}}
             for name, uid in (("view-a", "cccc0000-0000"),
                               ("view-b", "dddd0000-0000"))]
# Each stage runs this long before its views are read (the watcher books
# and the bucket settles), and metricsd's duty is read over this window.
VIEW_SETTLE_S = 3.0
VIEW_DUTY_S = 2.0
# The asserted bounds: a pod flat out at its 50% share reads at least
# DUTY_BUSY of its share (it books about 0.55 of the card, PERF.md §5, so
# its duty clamps at 100), an idle pod at most DUTY_IDLE; nvidia-smi under
# the interposer within SMI_DUTY_TOL points of metricsd; the card's raw
# utilisation, averaged over the window, at least RAW_BUSY while one pod
# runs.
DUTY_BUSY, DUTY_IDLE, SMI_DUTY_TOL, RAW_BUSY = 85.0, 10.0, 15.0, 40.0
# The card's own utilisation is read this often over a pod's window.
RAW_PERIOD_S = 0.25
SMI_QUERY = "--query-gpu=memory.total,memory.used,utilization.gpu"


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def view_pod_child(torch, rundir, name):
    """Phase 11, one pod's tenant with its grant's env: the bootstrap
    serves the pod's metricsd from this process; the bench config is
    served once and the charge written to ``<rundir>/<name>.report``;
    then, from the time ``<rundir>/run.<name>`` exists until
    ``<rundir>/stop`` does, the greedy loop runs flat out, its step count
    sampled against CLOCK_MONOTONIC."""
    from vtpu_torch import entry
    from vtpu_torch.metricsd import server as metricsd
    from vtpu_torch.ops import flash_attention as fa
    from vtpu_torch.shim import interposer

    res = bootstrap_seen(interposed=True)
    port = int(os.environ["VTPU_METRICSD_PORT"])
    check(metricsd._started is not None and metricsd._started[2] == port,
          f"the bootstrap serves no metricsd on {port} in this tenant")
    out = entry.serve("bench", *TENANT_SHAPE, steps=3)
    model, tokens = out["model"], out["tokens"].cuda()
    torch.cuda.synchronize()
    res["charged_bytes"] = interposer.stats()["charged_bytes"]
    with open(os.path.join(rundir, f"{name}.report"), "w") as f:
        json.dump({"charged_bytes": res["charged_bytes"]}, f)
    print("READY", flush=True)
    go, stop = os.path.join(rundir, f"run.{name}"), os.path.join(rundir,
                                                                 "stop")
    while not os.path.exists(go):
        time.sleep(0.005)
    fa.flash_attention.route_launches = dict.fromkeys(fa.ROUTES, 0)
    steps, trace = 0, [(time.monotonic(), 0)]
    with torch.inference_mode():
        while not os.path.exists(stop):
            tokens = torch.argmax(model(tokens), dim=-1).int()
            steps += 1
            if steps % 10 == 0:
                trace.append((time.monotonic(), steps))
        torch.cuda.synchronize()
    trace.append((time.monotonic(), steps))
    res.update(trace=trace, launches_by_route=dict(
        fa.flash_attention.route_launches),
        charged_end=interposer.stats()["charged_bytes"])
    check(steps > 0 and res["launches_by_route"]["sm90"] > 0
          and res["launches_by_route"]["wmma"] == 0,
          f"attention off the sm90 route: {res['launches_by_route']}")
    return res


def nvml_util_child():
    """Phase 11, under a pod's interposer: nvmlDeviceGetUtilizationRates
    called as nvidia-smi calls it (dlsym on libnvidia-ml), three times:
    the first (it samples the region), one right after (the last answer
    again) and one after 0.2 s (a new window); each call's ms and value."""
    import ctypes

    class Util(ctypes.Structure):
        _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]

    nvml = ctypes.CDLL("libnvidia-ml.so.1")
    dev = ctypes.c_void_p()
    check(nvml.nvmlInit_v2() == 0 and nvml.nvmlDeviceGetHandleByIndex_v2(
        0, ctypes.byref(dev)) == 0, "NVML does not open card 0")
    calls = []
    for pause in (0.0, 0.2, 0.0):
        u = Util()
        t0 = time.perf_counter()
        rc = nvml.nvmlDeviceGetUtilizationRates(dev, ctypes.byref(u))
        calls.append({"ms": (time.perf_counter() - t0) * 1e3, "rc": rc,
                      "gpu": u.gpu, "memory": u.memory})
        time.sleep(pause)
    check(all(c["rc"] == 0 and c["memory"] == 0 for c in calls),
          f"nvmlDeviceGetUtilizationRates under the interposer: {calls}")
    return {"calls": calls}


def smi_row(line, s):
    total, used, util = (int(v) for v in line.split(","))
    return {"total_mib": total, "used_mib": used, "gpu": util, "s": s}


class SmiLoop:
    """nvidia-smi in loop mode (``--loop-ms``) under ``env``: one process
    that stays alive, so under the interposer each row after its first
    covers the time since the row before, as metricsd's duty covers the
    time since its last sample.  Its rows are read through a
    pseudo-terminal, on which nvidia-smi writes each row as it is made."""

    def __init__(self, env, period_s):
        import pty

        self.master, slave = pty.openpty()
        self.err = tempfile.TemporaryFile()
        self.p = subprocess.Popen(
            ["nvidia-smi", SMI_QUERY, "--format=csv,noheader,nounits",
             f"--loop-ms={int(period_s * 1000)}"], env=env,
            stdin=subprocess.DEVNULL, stdout=slave, stderr=self.err)
        os.close(slave)
        self.buf, self.t0 = b"", time.monotonic()

    def stderr(self):
        self.err.seek(0)
        return self.err.read()[-1000:].decode(errors="replace")

    def row(self, timeout=30.0):
        """The next row, parsed, and the time it arrived."""
        import select

        deadline = time.monotonic() + timeout
        while not self.buf.strip(b"\r\n") or b"\n" not in self.buf.lstrip(
                b"\r\n"):
            left = deadline - time.monotonic()
            ready = select.select([self.master], [], [], max(left, 0))[0]
            check(ready and left > 0, f"nvidia-smi --loop-ms wrote no row "
                  f"in {timeout} s (rc {self.p.poll()}): {self.buf!r} "
                  f"{self.stderr()}")
            try:
                chunk = os.read(self.master, 4096)
            except OSError:
                chunk = b""
            check(chunk, f"nvidia-smi --loop-ms ended (rc {self.p.poll()}):"
                  f" {self.buf!r} {self.stderr()}")
            self.buf += chunk
        line, self.buf = self.buf.lstrip(b"\r\n").split(b"\n", 1)
        now = time.monotonic()
        try:
            return smi_row(line.decode().strip(), now - self.t0), now
        except ValueError:
            check(False, f"nvidia-smi --loop-ms wrote {line!r} "
                  f"{self.stderr()}")

    def close(self):
        if self.p.poll() is None:
            self.p.terminate()
            try:
                self.p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.p.kill()
                self.p.wait()
        os.close(self.master)
        self.err.close()


def rate_between(trace, t0, t1):
    """Steps a second between two CLOCK_MONOTONIC times, from a tenant's
    (time, steps) samples."""
    def steps_at(t):
        return max((s for ts, s in trace if ts <= t), default=0)

    return (steps_at(t1) - steps_at(t0)) / (t1 - t0)


def phase_views(torch, tmp, host=None, pods_rates=None):
    import grpc

    from vtpu_torch.metricsd import server as msrv
    from vtpu_torch.plugin.config import parse_args
    from vtpu_torch.plugin.grant import stage_shim, staged_files
    from vtpu_torch.plugin.main import Daemon
    from vtpu_torch.proto import pb
    from vtpu_torch.proto import tpu_metrics_grpc as mrpc
    from vtpu_torch.proto import tpu_metrics_pb2 as mpb
    from vtpu_torch.shim import interposer
    from vtpu_torch.shim.core import SharedRegion
    from vtpu_torch.utils.envspec import parse_quantity

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    if host is None:          # run alone: stage as phase 10 does
        host = os.path.join(tmp, "views-host")
        staged_files(host, interposer.library_path())
        stage_shim(host)
    plugins = os.path.join(tmp, "views-kubelet")
    os.makedirs(plugins)
    kubelet = FakeKubelet(plugins)
    cfg = parse_args(["--discovery", "nvml", "--device-split-count", "2",
                      "--monitor-mode", "true", "--node-name", "chip",
                      "--enable-metricsd", "true",
                      "--device-plugin-path", plugins + "/",
                      "--host-lib-dir", host])
    d = Daemon(cfg, pod_lister=lambda node: VIEW_PODS)
    try:
        check(d.start_plugins(), "the daemon with metricsd did not start")
        reg, stub, ch = kubelet.plugin()
        ids = [dev.ID for dev in next(stub.ListAndWatch(pb.Empty())).devices]
        answers = [kubelet.allocate(stub, [i]) for i in ids]
        ch.close()
    finally:
        d.stop_plugins()
        kubelet.stop()
    names = ("A", "B")
    envs, caps, regions, ports = [], [], [], []
    for (genv, mounts, _), pod in zip(answers, VIEW_PODS):
        check(genv.get("VTPU_METRICSD_PORT") == str(cfg.metricsd_port)
              and "TPU_RUNTIME_METRICS_PORTS" not in genv
              and "VTPU_METRICSD_UPSTREAM" not in genv,
              f"{pod['metadata']['name']}: metricsd's env {genv}")
        env = pod_env(genv, mounts, os.path.join(
            tmp, f"image-{pod['metadata']['name']}"))
        # Both pods share this host's ports: each gets its own, as each
        # container would have its own localhost.
        ports.append(free_port())
        env["VTPU_METRICSD_PORT"] = str(ports[-1])
        envs.append(env)
        caps.append(parse_quantity(genv["VTPU_DEVICE_HBM_LIMIT_0"]))
        regions.append(env["VTPU_DEVICE_MEMORY_SHARED_CACHE"])
    say("views: grants " + json.dumps([{k: v for k, v in a[0].items()
                                        if "METRIC" in k or "LIMIT" in k}
                                       for a in answers]))
    rundir = os.path.join(tmp, "views-run")
    os.makedirs(rundir)
    errs = [open(os.path.join(tmp, f"views.{n}.err"), "w+") for n in names]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--child", "viewpod", rundir, n], env=env,
                              stdout=subprocess.PIPE, stderr=err, text=True)
             for n, env, err in zip(names, envs, errs)]
    channels = [grpc.insecure_channel(f"127.0.0.1:{p}") for p in ports]
    stubs = [mrpc.RuntimeMetricServiceStub(c) for c in channels]
    tool_env = {k: v for k, v in os.environ.items()
                if not k.startswith(("VTPU_", "LD_PRELOAD", "PYTHONPATH"))}

    def stderr_of(i):
        errs[i].seek(0)
        return errs[i].read()[-3000:]

    def metric(i, name):
        resp = stubs[i].GetRuntimeMetric(mpb.MetricRequest(metric_name=name),
                                         timeout=10)
        vals = [m.gauge.as_double if m.gauge.WhichOneof("value")
                == "as_double" else m.gauge.as_int
                for m in resp.metric.metrics]
        check(len(vals) == 1, f"pod {names[i]}: metricsd shows {len(vals)} "
              f"devices for {name}")
        return vals[0]

    def n_procs(i):
        with SharedRegion(regions[i]) as r:
            return int(r.device_stats(0).n_procs)

    def tool(args, env):
        return subprocess.Popen([sys.executable, "-m", *args], env=env,
                                cwd=REPO, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    def tool_json(p):
        out, err = p.communicate(timeout=120)
        check(p.returncode == 0, f"{p.args}: {err[-2000:]}")
        return json.loads(out)

    def pod_window(i):
        """Pod i's window, read by nvidia-smi under its interposer and by
        metricsd alike: metricsd's duty is asked for as each of the two
        rows arrives, so both measure from one moment to the other."""
        loop = SmiLoop(envs[i], VIEW_DUTY_S)
        try:
            loop.row()                                # the window's start
            metric(i, msrv.METRIC_DUTY_CYCLE)
            smi, t_end = loop.row()                   # the window's end
            duty = metric(i, msrv.METRIC_DUTY_CYCLE)
            return smi, duty, time.monotonic() - t_end
        finally:
            loop.close()

    def duty_stage(label, busy):
        """Each pod's window (``pod_window``), and over it the card's own
        utilisation, nvidia-smi without an interposer every RAW_PERIOD_S
        (NVML's reading covers its own short sample period, so one row
        alone would be one 1/6 s sample of a card that runs a throttled
        pod in bursts: the mean of the rows is the window's); then each
        pod's tpu-info over a second of its own.  Asserted against
        ``busy`` (which pods run).  Nothing else starts in the window: a
        Python start beside them takes CPU from the launch-bound tenants
        (8 cores), and their device time with it."""
        from concurrent.futures import ThreadPoolExecutor

        procs_before = [n_procs(i) for i in range(2)]
        raw_loop = SmiLoop(tool_env, RAW_PERIOD_S)
        try:
            with ThreadPoolExecutor(2) as ex:
                windows = [ex.submit(pod_window, i) for i in range(2)]
                rows = []
                while not all(w.done() for w in windows):
                    rows.append(raw_loop.row()[0])
                windows = [w.result() for w in windows]
        finally:
            raw_loop.close()
        raw = {"gpu": statistics.mean(r["gpu"] for r in rows),
               "rows": [r["gpu"] for r in rows]}
        check([n_procs(i) for i in range(2)] == procs_before == [1, 1],
              f"{label}: a view took a slot: {procs_before}")
        smi = [w[0] for w in windows]
        duty = [w[1] for w in windows]
        infos = [tool(["vtpu_torch.tools.tpu_info", "--json",
                       "--interval", "1"],
                      {k: v for k, v in env.items() if k != "LD_PRELOAD"})
                 for env in envs]
        info = [tool_json(p) for p in infos]
        row = {"metricsd_duty": duty, "nvidia_smi": smi, "raw": raw,
               "duty_read_after_row_s": [w[2] for w in windows],
               "tpu_info_share_duty": [r[0]["share_duty_pct"] for r in info]}
        say(f"views: {label}: " + json.dumps(row))
        for i in range(2):
            if busy[i]:
                check(duty[i] >= DUTY_BUSY, f"{label}: pod {names[i]} flat "
                      f"out reads duty {duty[i]}")
            else:
                check(duty[i] <= DUTY_IDLE, f"{label}: idle pod "
                      f"{names[i]} reads duty {duty[i]}")
            check(abs(smi[i]["gpu"] - duty[i]) <= SMI_DUTY_TOL,
                  f"{label}: pod {names[i]}'s nvidia-smi reads "
                  f"{smi[i]['gpu']}, metricsd {duty[i]}")
            check(abs(row["tpu_info_share_duty"][i] - duty[i])
                  <= SMI_DUTY_TOL, f"{label}: pod {names[i]}'s tpu-info "
                  f"reads {row['tpu_info_share_duty'][i]}, metricsd "
                  f"{duty[i]}")
            # nvidia-smi rounds MiB up.
            check(smi[i]["total_mib"] == -(-caps[i] // 2**20),
                  f"{label}: pod {names[i]}'s nvidia-smi total "
                  f"{smi[i]['total_mib']} MiB, cap {caps[i]}")
        if any(busy) and not all(busy):
            check(raw["gpu"] >= RAW_BUSY and smi[busy.index(False)]["gpu"]
                  <= DUTY_IDLE, f"{label}: the idle pod's nvidia-smi does not "
                  f"differ from the card's: {row}")
        return row

    got = {}
    try:
        for i, p in enumerate(procs):
            line = p.stdout.readline()
            if line.strip() != "READY":
                try:
                    p.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    pass
            check(line.strip() == "READY", f"pod {names[i]} not ready: "
                  f"{line!r} (rc {p.poll()}) {stderr_of(i)}")
        charges = []
        for n in names:
            with open(os.path.join(rundir, f"{n}.report")) as f:
                charges.append(json.load(f)["charged_bytes"])
        # 1. Both pods hold the card's memory, idle: every view's ledger
        # is that pod's own charge, every total its cap.
        for i in range(2):
            total = metric(i, msrv.METRIC_HBM_TOTAL)
            usage = metric(i, msrv.METRIC_HBM_USAGE)
            check(total == caps[i] and usage == charges[i] > 0,
                  f"pod {names[i]}: metricsd total {total} usage {usage}, "
                  f"cap {caps[i]} charge {charges[i]}")
        lat = []
        for _ in range(50):
            for i in range(2):
                t0 = time.perf_counter()
                metric(i, msrv.METRIC_HBM_USAGE)
                lat.append((time.perf_counter() - t0) * 1e3)
        got["metricsd_ms_p50"] = statistics.median(lat)
        infos = [tool_json(tool(["vtpu_torch.tools.tpu_info", "--json",
                                 "--interval", "0.2"],
                                {k: v for k, v in env.items()
                                 if k != "LD_PRELOAD"})) for env in envs]
        for i, rows in enumerate(infos):
            check(len(rows) == 1 and rows[0]["hbm_limit_bytes"] == caps[i]
                  and rows[0]["hbm_used_bytes"] == charges[i]
                  and rows[0]["card"] == answers[i][0][
                      "VTPU_DEVICE_MAP"].split(":", 1)[1],
                  f"pod {names[i]}: tpu-info {rows}")
        shared = os.path.join(host, "shared")
        scan = tool_json(tool(["vtpu_torch.tools.vtpu_smi", "--scan", shared,
                               "--json"], tool_env))
        ledgers = {s["region"]: s["devices"][0]["used_bytes"] for s in scan}
        check([ledgers.get(r) for r in regions] == charges,
              f"vtpu-smi --scan: {ledgers}, charges {charges}")
        mport = free_port()
        exporter = tool(["vtpu_torch.tools.metrics_server", "--port",
                         str(mport), "--scan", shared,
                         *sum((["--metricsd", f"127.0.0.1:{p}"]
                               for p in ports), [])], tool_env)
        try:
            import urllib.request

            deadline = time.monotonic() + 60
            while True:
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{mport}/metrics",
                            timeout=30) as r:
                        text = r.read().decode()
                    break
                except OSError:
                    check(exporter.poll() is None
                          and time.monotonic() < deadline,
                          "the exporter did not answer")
                    time.sleep(0.2)
        finally:
            exporter.terminate()
            exporter.communicate(timeout=30)
        for i in range(2):
            region = os.path.basename(os.path.dirname(regions[i]))
            target = f'target="127.0.0.1:{ports[i]}"'
            for line in (
                    f'vtpu_hbm_used_bytes{{region="{region}",device="0"}} '
                    f'{charges[i]}',
                    f"vtpu_metricsd_up{{{target}}} 1",
                    f'vtpu_metricsd_virtual_value{{{target},metric='
                    f'"{msrv.METRIC_HBM_USAGE}",device="0"}} {charges[i]}',
                    f'vtpu_metricsd_virtual_value{{{target},metric='
                    f'"{msrv.METRIC_HBM_TOTAL}",device="0"}} {caps[i]}'):
                check(line in text, f"the exporter's /metrics lacks {line}")
        idle = duty_stage("both idle", (False, False))
        check([r["used_mib"] for r in idle["nvidia_smi"]]
              == [-(-c // 2**20) for c in charges],
              f"nvidia-smi's memory.used is not each pod's charge: {idle}")
        nvml = child(["nvmlutil"], {k: v for k, v in envs[0].items()
                                    if k != "PYTHONPATH"})
        check(n_procs(0) == 1, "the NVML probe took a slot in pod A's region")
        got["nvml_calls"] = nvml["calls"]
        say("views: nvmlDeviceGetUtilizationRates under the interposer: "
            + json.dumps(nvml["calls"]))
        # 2. Pod A flat out, pod B idle at READY; then both flat out.
        marks = [time.monotonic()]
        open(os.path.join(rundir, "run.A"), "w").close()
        time.sleep(VIEW_SETTLE_S)
        one = duty_stage("pod A flat out, pod B idle", (True, False))
        marks.append(time.monotonic())
        open(os.path.join(rundir, "run.B"), "w").close()
        time.sleep(VIEW_SETTLE_S)
        marks.append(time.monotonic())
        both = duty_stage("both flat out", (True, True))
        marks.append(time.monotonic())
        open(os.path.join(rundir, "stop"), "w").close()
        rows = []
        for i, p in enumerate(procs):
            out, _ = p.communicate(timeout=300)
            res = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            check(p.returncode == 0 and res, f"pod {names[i]} failed "
                  f"(rc {p.returncode}): {stderr_of(i)}")
            rows.append(json.loads(res[-1][len("RESULT "):]))
    finally:
        for c in channels:
            c.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for err in errs:
            err.close()
    for i, r in enumerate(regions):
        used = region_used(r)
        check(used == 0, f"pod {names[i]}: region holds {used} bytes after "
              "exit")
    alone = rate_between(rows[0]["trace"], marks[0] + 1.0, marks[1])
    paired = [rate_between(row["trace"], marks[2], marks[3]) for row in rows]
    got.update(idle=idle, one=one, both=both, charges=charges, caps=caps,
               alone_steps_per_s=alone, paired_steps_per_s=paired)
    say(f"views ({card}): metricsd GetRuntimeMetric p50 "
        f"{got['metricsd_ms_p50']:.3f} "
        f"ms; nvmlDeviceGetUtilizationRates first "
        f"{nvml['calls'][0]['ms']:.1f} ms, right after "
        f"{nvml['calls'][1]['ms']:.3f} ms, a new window "
        f"{nvml['calls'][2]['ms']:.3f} ms")
    say(f"views ({card}): pod A alone {alone:.2f} steps/s; both "
        + ", ".join(f"{r:.2f}" for r in paired) + " steps/s (phase 10's "
        "pair: " + (", ".join(f"{r:.2f}" for r in pods_rates)
                    if pods_rates else "not run") + "); charges "
        f"{charges}; ledgers 0 after exit")
    return got


# -- phase 12: the broker ---------------------------------------------------

BROKER_SEED = 12
BROKER_SHAPE = (4, 512)    # bench.py's batch and sequence
BROKER_STEPS = 8           # two chains of BROKER_CHAIN
BROKER_CHAIN = 4
TOKEN_AGREEMENT = 0.999    # share of token positions equal to in-process
FULL_SHAPE = (2, 512)      # phase 3's batch and sequence
FULL_STEPS = 16
B12_LAYERS = 4             # 12b: Llama-3-8B at full width, depth cut to 4
B12_CAP = 6 * 2**30        # 12b's cap: one init of 3.85 GB fits, two do not
FULL_CAP = 20 * 2**30      # phase 3's cap, given in HELLO
SHARE_S = 8.0              # each 12c tenant's timed window
SHARE_CORE = 50
# 12c's band on what each of two 50% tenants books of its window, set
# after runs agreed (PERF.md, runs AA-AD: 0.486-0.501); the bucket's
# 400 ms burst is 0.05 of an 8 s window.  The tenant alone, a sole
# demander in the work-conserving region, runs ungated: it must run
# faster and book more of its window than each of the pair.  Its own
# reading depends on the host: the dispatcher's Python bounded it at 0.84
# of the window on a slow host (run AD) and not at all on others (1.00).
SHARE_PAIR_BAND = (0.40, 0.60)


def broker_prompt(cfg):
    return np.random.default_rng(BROKER_SEED).integers(
        0, cfg.vocab, BROKER_SHAPE, dtype=np.int32)


def brokered_child(torch, torch_maps, go, mode, sock, out_dir):
    """Phase 12, inside one tenant that never opens the card (started with
    CUDA_VISIBLE_DEVICES empty): ``parity`` serves the bench config from
    the parent's weights (``out_dir``/parity_weights.pt) as PUTs, reports
    READY, then runs the logits program on the prompt once the go file
    appears; ``full`` serves Llama-3-8B from the broker's init program
    under a 20 GiB cap and runs that program again, which must be
    refused; ``share`` serves the bench config for SHARE_S at a 50%
    share, released by the go file.  The tenant reads which libcuda its
    process maps after ``import torch`` (``torch_maps``), after the
    port's imports and at the end, and checks that it never initialised
    CUDA and that torch sees no card."""
    from vtpu_torch import entry
    from vtpu_torch.models import transformer as tr
    from vtpu_torch.runtime.client import RuntimeClient, VtpuQuotaError

    res = {"pid": os.getpid(), "libcuda_after_torch": torch_maps,
           "libcuda_after_port": libcuda_maps()}

    check(os.environ.get("CUDA_VISIBLE_DEVICES") == "",
          "the tenant was started with a card visible")

    def released():
        print("READY", flush=True)
        while not os.path.exists(go):
            time.sleep(0.005)

    if mode == "parity":
        cfg = tr.TransformerConfig.bench()
        c = RuntimeClient(sock, tenant="parity")
        prompt = broker_prompt(cfg)
        t0 = time.monotonic()
        # Read into memory: PUTs sent from a file mapping measured about
        # ten times slower (PERF.md, run AG).
        weights = torch.load(os.path.join(out_dir, "parity_weights.pt"),
                             weights_only=True)
        t1 = time.monotonic()
        out = entry.serve_brokered(
            c, cfg, *BROKER_SHAPE, steps=BROKER_STEPS, weights=weights,
            chain=BROKER_CHAIN, depth=2, prompt=prompt)
        res.update(load_s=t1 - t0, serve_s=time.monotonic() - t1)
        released()
        t0 = time.monotonic()
        c.put(torch.from_numpy(prompt), "prompt")
        meta = [torch.empty(BROKER_SHAPE, dtype=torch.int32,
                            device="meta")] + [
            torch.empty(shape, dtype=dtype, device="meta")
            for _, shape, dtype in tr.param_shapes(
                dataclasses.replace(cfg, use_flash=True))]
        exe = c.compile(tr.functional_forward(
            dataclasses.replace(cfg, use_flash=True)), meta)
        c.execute_send_ids(exe.id, ["prompt"] + out["param_ids"],
                           ["logits"])
        c.execute_recv()
        np.savez(os.path.join(out_dir, "parity.npz"),
                 tokens4=out["prev_tokens"].numpy(),
                 tokens8=out["tokens"].numpy(),
                 logits=c.get("logits").numpy())
        res.update(steps=out["steps"], stats=out["stats"],
                   logits_s=time.monotonic() - t0)
        c.close()
    elif mode == "full":
        released()
        cfg = dataclasses.replace(tr.TransformerConfig.llama3_8b(),
                                  n_layers=B12_LAYERS)
        c = RuntimeClient(sock, tenant="full", hbm_limit=B12_CAP,
                          core_limit=100)
        t0 = time.monotonic()
        out = entry.serve_brokered(
            c, cfg, *FULL_SHAPE, steps=FULL_STEPS, init="program",
            seed=BROKER_SEED, chain=BROKER_CHAIN, depth=2)
        res.update(wall_s=time.monotonic() - t0, steps=out["steps"],
                   steps_per_s=out["steps_per_s"], stats=out["stats"],
                   tokens_ok=bool(out["tokens"].shape == FULL_SHAPE
                                  and int(out["tokens"].min()) >= 0
                                  and int(out["tokens"].max()) < cfg.vocab))
        before = c.stats()["full"]["used_bytes"]
        try:
            out["init_exe"]()
            res["second_init"] = "admitted"
        except VtpuQuotaError as e:
            res["second_init"] = str(e)
        res["ledger_before"] = before
        res["ledger_after"] = c.stats()["full"]["used_bytes"]
        c.close()
    else:
        c = RuntimeClient(sock, tenant=f"share-{os.getpid()}",
                          core_limit=SHARE_CORE)
        out = entry.serve_brokered(
            c, "bench", *BROKER_SHAPE, init="program", seed=BROKER_SEED,
            chain=BROKER_CHAIN, depth=2, seconds=SHARE_S, on_ready=released)
        c.close()
        res.update(steps_per_s=out["steps_per_s"], booked_us=out["booked_us"],
                   window_s=out["window_s"], steps=out["steps"],
                   core=out["stats"]["core_limit_pct"])
    # A CUDA build of torch may map libcuda when it is imported (the
    # three readings say which step maps it), so what the tenant must
    # never do is initialise CUDA: no context, no device, before torch is
    # asked for a card.
    res["libcuda_mapped"] = libcuda_maps()
    res["cuda_initialized"] = torch.cuda.is_initialized()
    check(not res["cuda_initialized"], "the tenant initialised CUDA")
    check(not torch.cuda.is_available(), "the tenant sees a card")
    return res


def drawn_weights(torch, cfg, seed, device):
    """``cfg``'s weights drawn on ``device`` by the port's seed init
    (``init_program``) and the same as ``vtpu``'s pytree of CPU tensors,
    which a tenant PUTs."""
    from vtpu_torch.models import transformer as tr
    from vtpu_torch.models.convert import init_program

    with torch.inference_mode():
        drawn = init_program(cfg, seed, device=device)()
    tree = {"layers": [{} for _ in range(cfg.n_layers)]}
    for (name, _, _), w in zip(tr.param_shapes(cfg), drawn):
        path = name.split(".")
        if path[0] == "layers":
            tree["layers"][int(path[1])][path[2]] = w.cpu()
        else:
            tree[name] = w.cpu()
    return drawn, tree


def libcuda_maps():
    """The libcuda files this process maps."""
    with open("/proc/self/maps") as f:
        return sorted({ln.split()[-1] for ln in f if "libcuda.so" in ln})


def broker_ledger(state):
    """Bytes charged in every tenant slot of the broker's card."""
    region = state.chips[0].region
    return sum(int(region.device_stats(i).used_bytes)
               for i in range(state.chips[0].region.ndevices))


def phase_broker(torch, tmp):
    import threading

    from vtpu_torch import entry
    from vtpu_torch.models import transformer as tr
    from vtpu_torch.ops import flash_attention as fa
    from vtpu_torch.runtime import server as rs

    sock = os.path.join(tmp, "broker.sock")
    srv = rs.make_server(sock, hbm_limit=0, core_limit=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True,
                          kwargs={"poll_interval": 0.1})
    th.start()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    launches = {}

    def reset():
        fa.flash_attention.launches = 0
        fa.flash_attention.route_launches = dict.fromkeys(fa.ROUTES, 0)

    try:
        # 12a: parity with in-process serving, same weights and prompt.
        t0 = time.monotonic()
        # The port's seed init (init_program) draws them on the card;
        # the tenant PUTs the same bytes from a file.
        cfg = dataclasses.replace(tr.TransformerConfig.bench(),
                                  use_flash=True)
        drawn, tree = drawn_weights(torch, cfg, BROKER_SEED, "cuda")
        torch.save(tree, os.path.join(tmp, "parity_weights.pt"))
        prompt = broker_prompt(cfg)
        ref = entry.serve(cfg, *BROKER_SHAPE, steps=BROKER_CHAIN,
                          device="cuda", weights=tree, prompt=prompt)
        ref4 = ref["tokens"]
        with torch.inference_mode():
            m = ref["model"]
            t = ref4.cuda()
            for _ in range(BROKER_STEPS - BROKER_CHAIN):
                t = torch.argmax(m(t), dim=-1).int()
            ref8 = t.cpu()
            ref_logits = m(torch.from_numpy(prompt).cuda()).float().cpu()
        del drawn, tree, ref, m, t
        gc.collect()
        torch.cuda.empty_cache()
        prep_s = time.monotonic() - t0

        def count():
            launches["parity"] = dict(fa.flash_attention.route_launches)
            launches["parity_total"] = fa.flash_attention.launches

        reset()
        t0 = time.monotonic()
        par = run_released([env], "brokered", tmp, "b_parity", on_ready=count,
                           args=[("parity", sock, tmp)])[0]
        got = np.load(os.path.join(tmp, "parity.npz"))
        steps_l = BROKER_STEPS * cfg.n_layers
        say(f"12a parity (bench b=4 s=512, PUT weights, 2 chains of 4): "
            f"{prep_s:.1f} s to draw, save and serve in process; the tenant "
            f"{time.monotonic() - t0:.1f} s (load {par['load_s']:.1f} s, "
            f"PUT, compile and 8 steps {par['serve_s']:.1f} s, logits "
            f"{par['logits_s']:.1f} s); broker launches "
            f"{json.dumps(launches['parity'])}; the tenant initialised "
            f"CUDA: {par['cuda_initialized']}; libcuda it maps after "
            f"import torch: {par['libcuda_after_torch']}, after the port's "
            f"imports: {par['libcuda_after_port']}, at the end: "
            f"{par['libcuda_mapped']}")
        check(launches["parity_total"] == steps_l
              and launches["parity"]["sm90"] == steps_l,
              f"brokered launches {launches['parity']} != {steps_l} sm90")
        logits = torch.from_numpy(got["logits"])
        rel = ((logits - ref_logits).norm() / ref_logits.norm()).item()
        same = sum(int((torch.from_numpy(got[k]) == r).sum())
                   for k, r in (("tokens4", ref4), ("tokens8", ref8)))
        total = 2 * ref8.numel()
        say(f"12a logits brokered vs in-process: rel L2 {rel:.3g} (tol "
            f"{LOGITS_REL_L2}); tokens after steps 4 and 8 equal at "
            f"{same} of {total} positions")
        check(torch.isfinite(logits).all().item() and rel < LOGITS_REL_L2,
              f"brokered logits disagree with in-process serving: {rel}")
        check(same >= TOKEN_AGREEMENT * total,
              f"brokered tokens agree at {same} of {total} positions")
        check(par["stats"]["executions"] == BROKER_STEPS,
              f"broker counted {par['stats']['executions']} steps")

        # 12b: Llama-3-8B at full width from the broker's init program.
        reset()
        full = run_released([env], "brokered", tmp, "b_full",
                            args=[("full", sock, tmp)])[0]
        launches["full"] = dict(fa.flash_attention.route_launches)
        llama = dataclasses.replace(tr.TransformerConfig.llama3_8b(),
                                    n_layers=B12_LAYERS)
        want = FULL_STEPS * llama.n_layers
        say(f"12b llama3_8b at depth {B12_LAYERS}, b=2 s=512 through the "
            f"broker: {full['wall_s']:.1f} s with init and compile; "
            f"{full['steps_per_s']:.3f} steps/s in chains of {BROKER_CHAIN} "
            f"after the first; launches "
            f"{json.dumps(launches['full'])}; ledger "
            f"{full['ledger_before']} B; second init: {full['second_init']}")
        check(fa.flash_attention.launches == want
              and launches["full"]["sm90"] == want,
              f"full-width launches {launches['full']} != {want} sm90")
        check(full["tokens_ok"], "full-width tokens out of range")
        check("RESOURCE_EXHAUSTED" in full["second_init"],
              f"second init not refused: {full['second_init']}")
        check(full["ledger_after"] == full["ledger_before"]
              >= tr.state_bytes(llama),
              f"ledger moved: {full['ledger_before']} -> "
              f"{full['ledger_after']}")
        deadline = time.monotonic() + 30
        while broker_ledger(srv.state) and time.monotonic() < deadline:
            time.sleep(0.05)
        check(broker_ledger(srv.state) == 0,
              f"ledger {broker_ledger(srv.state)} after the tenant exited")

        # 12c: shares, one tenant then two, 50% each given in HELLO.
        t0 = time.monotonic()
        solo = run_released([env], "brokered", tmp, "b_solo",
                            args=[("share", sock, tmp)])
        pair = run_released([env, env], "brokered", tmp, "b_pair",
                            args=[("share", sock, tmp)] * 2)
        for label, rows in (("alone", solo), ("pair", pair)):
            say(f"12c {label} at {SHARE_CORE}%: " + "; ".join(
                f"{r['steps_per_s']:.2f} steps/s, booked "
                f"{r['booked_us'] / 1e6:.3f} s of {r['window_s']:.3f} s "
                f"({r['booked_us'] / 1e6 / r['window_s']:.3f})"
                for r in rows))
            check(all(r["core"] == SHARE_CORE for r in rows),
                  "a share tenant's slot lacks its HELLO core share")
        say(f"12c took {time.monotonic() - t0:.1f} s")
        lo, hi = SHARE_PAIR_BAND
        alone = solo[0]["booked_us"] / 1e6 / solo[0]["window_s"]
        for r in pair:
            share = r["booked_us"] / 1e6 / r["window_s"]
            check(lo <= share <= hi,
                  f"a pair tenant booked {share:.3f} of its window, outside "
                  f"{lo}-{hi}")
            check(solo[0]["steps_per_s"] > r["steps_per_s"] and alone > share,
                  f"the tenant alone ({solo[0]['steps_per_s']:.2f} steps/s, "
                  f"{alone:.3f} of its window) did not outrun a 50% tenant "
                  f"beside another ({r['steps_per_s']:.2f}, {share:.3f})")
        deadline = time.monotonic() + 30
        while broker_ledger(srv.state) and time.monotonic() < deadline:
            time.sleep(0.05)
        check(broker_ledger(srv.state) == 0, "ledger not 0 after 12c")
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)
    return {"sm90": launches["parity"]["sm90"] + launches["full"]["sm90"],
            "wmma": launches["parity"]["wmma"] + launches["full"]["wmma"]}


# -- phase 13: the broker's durability half ----------------------------------

P13_SEED = 13
P13_LAYERS = 2             # Llama-3-8B at full width, depth cut to 2
P13_STEPS = 16             # four chains of P13_CHAIN
P13_CHAIN = 4
P13_KILL_AT = 8            # steps fetched when the broker is killed
P13_CAP = 8 * 2**30        # 13a's HBM cap, given in HELLO
P13_SHARE_S = 4.0          # each part of 13b's RESIZE window
P13_CORE = 50              # 13b's share after the RESIZE
# The card's settings; a rehearsal on the CPU passes its own.
P13_CARD = {"device": "cuda", "cfg": "llama4", "bench": "bench",
            "shape": [2, 512], "bench_shape": [4, 512], "cap": P13_CAP}


def p13_config(name, layers=None):
    """A named configuration with the flash path; ``layers`` cuts the
    Llama-3-8B one's depth (P13_LAYERS by default)."""
    from vtpu_torch.models import transformer as tr

    cfg = {"llama4": lambda: dataclasses.replace(
        tr.TransformerConfig.llama3_8b(), n_layers=layers or P13_LAYERS),
        "bench": tr.TransformerConfig.bench,
        "tiny": tr.TransformerConfig.tiny}[name]()
    return dataclasses.replace(cfg, use_flash=True)


def p13_prompt(cfg, shape):
    return np.random.default_rng(P13_SEED).integers(
        0, cfg.vocab, tuple(shape), dtype=np.int32)


def journal_home(tmp, need):
    """(directory, what it is) for a journal of ``need`` bytes of blobs: a
    tmpfs (/dev/shm) when it has room for them twice, where writes are
    fast and the journal's contract (it survives the broker's death, not
    the machine's) holds as on a disk; else the temp directory."""
    import shutil

    shm = "/dev/shm"
    try:
        free = shutil.disk_usage(shm).free
    except OSError:
        free = 0
    if os.path.isdir(shm) and free >= 2 * need:
        return (tempfile.mkdtemp(prefix="vtpu-p13-", dir=shm),
                f"{shm} (tmpfs, {free / 2**30:.1f} GiB free)")
    return (tmp, f"the temp directory ({shm} has {free / 2**30:.1f} GiB "
                 f"free, under {2 * need / 2**30:.1f})")


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)


class Broker:
    """One broker process (``python -m vtpu_torch.runtime.server``, or the
    standby's ``vtpu_torch.runtime.replication``) with a journal and
    tracing on; its stderr goes to a file."""

    def __init__(self, name, sock, jdir, tmp, s13, lease, faults=None,
                 args=(), module="vtpu_torch.runtime.server"):
        self.name, self.sock = name, sock
        env = dict(os.environ, VTPU_JOURNAL_DIR=jdir, VTPU_TRACE="1",
                   VTPU_TRACE_RING="1024", VTPU_LOG_LEVEL="3",
                   VTPU_LEASE_SIDECAR=lease,
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        env.pop("VTPU_FAULTS", None)
        if faults:
            env["VTPU_FAULTS"] = faults
        self.errpath = os.path.join(tmp, f"{name}.err")
        self.t0 = time.monotonic()
        with open(self.errpath, "w") as err:
            self.p = subprocess.Popen(
                [sys.executable, "-m", module,
                 "--socket", sock, "--device", s13["device"], *args],
                env=env, stdout=subprocess.DEVNULL, stderr=err, cwd=REPO)

    def log(self):
        with open(self.errpath) as f:
            return f.read()

    def bound(self, timeout=240.0):
        """Seconds from the start until a bind-free STATS answers (the
        journal's replay and the card's claim come before the bind)."""
        from vtpu_torch.tools.vtpu_smi import request

        deadline = self.t0 + timeout
        while True:
            check(self.p.poll() is None, f"broker {self.name} exited rc "
                  f"{self.p.returncode}: {self.log()[-3000:]}")
            try:
                if request(self.sock, {"kind": "stats"}, 5.0)["ok"]:
                    return time.monotonic() - self.t0
            except OSError:
                pass
            check(time.monotonic() < deadline,
                  f"broker {self.name} not bound after {timeout} s")
            time.sleep(0.05)

    def stats(self):
        from vtpu_torch.tools.vtpu_smi import request

        return request(self.sock, {"kind": "stats"})

    def row(self, tenant):
        return self.stats()["tenants"].get(tenant)

    def launches(self):
        """K1's launches by route, from the line the broker writes to its
        log at a graceful exit."""
        got = re.findall(r"K1 launches (\{.*\})", self.log())
        check(got, f"broker {self.name} logged no K1 launches")
        return json.loads(got[-1])

    def shutdown(self):
        from vtpu_torch.tools.vtpu_smi import request

        request(self.sock + ".admin", {"kind": "shutdown"})
        self.p.wait(timeout=60)

    def stop(self):
        if self.p.poll() is None:
            self.p.kill()
            self.p.wait()


def region_ledger(path):
    from vtpu_torch.shim.core import SharedRegion

    r = SharedRegion(path)
    try:
        return sum(int(r.device_stats(i).used_bytes)
                   for i in range(r.ndevices))
    finally:
        r.close()


def vtpu_smi(args, env=None):
    return subprocess.run([sys.executable, "-m", "vtpu_torch.tools.vtpu_smi",
                           *args], capture_output=True, text=True,
                          timeout=120, cwd=REPO, env=env)


def p13_child(torch, go, sock, role, s13):
    """Phase 13's tenant (no card: started with CUDA_VISIBLE_DEVICES
    empty).  ``crash`` serves the 13a model from the parent's weights as
    PUTs for P13_STEPS steps; at P13_KILL_AT steps it prints KILLPOINT
    and waits for the go file, while the parent kills the broker; the
    restarts after that come to it unannounced.  ``bench`` serves the
    bench config from PUT weights flat out, reports READY, starts on the
    go file, writes the steps it has fetched to ``<go>.progress``
    and stops once ``<go>.stop`` exists.  Either way it catches no
    exception: ``serve_brokered`` resumes across the restarts."""
    from vtpu_torch import entry
    from vtpu_torch.runtime.client import RuntimeClient

    check(os.environ.get("CUDA_VISIBLE_DEVICES") == "",
          "the tenant was started with a card visible")
    home = os.path.dirname(go)
    if role == "crash":
        cfg, shape = p13_config(s13["cfg"], s13.get("layers")), s13["shape"]
        weights = torch.load(os.path.join(s13["wdir"], "p13_weights.pt"),
                             weights_only=True)
        while s13.get("start") and not os.path.exists(s13["start"]):
            time.sleep(0.005)
        c = RuntimeClient(sock, tenant="p13", hbm_limit=s13["cap"],
                          core_limit=100)

        kill_at = s13.get("kill_at", P13_KILL_AT)

        def on_chain(n):
            if n == kill_at and not os.path.exists(go):
                print("KILLPOINT", flush=True)
                while not os.path.exists(go):
                    time.sleep(0.005)

        out = entry.serve_brokered(
            c, cfg, *shape, steps=s13.get("steps", P13_STEPS),
            weights=weights,
            chain=P13_CHAIN, depth=2, prompt=p13_prompt(cfg, shape),
            on_chain=on_chain)
        np.save(os.path.join(home, "p13_tokens.npy"), out["tokens"].numpy())
    else:
        cfg, shape = p13_config(s13["bench"]), s13["bench_shape"]
        c = RuntimeClient(sock, tenant="p13b", core_limit=100)
        weights = torch.load(os.path.join(s13["wdir"], "p13b_weights.pt"),
                             weights_only=True)
        progress = go + ".progress"

        def ready():
            print("READY", flush=True)
            while not os.path.exists(go):
                time.sleep(0.005)

        def on_chain(n):
            with open(progress + ".tmp", "w") as f:
                f.write(str(n))
            os.replace(progress + ".tmp", progress)
            return os.path.exists(go + ".stop")

        out = entry.serve_brokered(
            c, cfg, *shape, weights=weights, chain=P13_CHAIN, depth=2,
            seconds=600.0, prompt=p13_prompt(cfg, shape), on_ready=ready,
            on_chain=on_chain)
    c.close()
    return {"steps": out["steps"], "setup_s": out["setup_s"],
            "chain_times": out["chain_times"], "resumes": out["resumes"],
            "stats": out["stats"], "cuda_initialized":
            torch.cuda.is_initialized()}


def p13_tenant(tmp, go, sock, role, s13):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               VTPU_RECONNECT_TIMEOUT_S="240", VTPU_RPC_TIMEOUT_S="300",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    err = open(os.path.join(tmp, f"p13_{role}.err"), "w+")
    p = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                          "--child", "p13", go, sock, role, json.dumps(s13)],
                         env=env, stdout=subprocess.PIPE, stderr=err,
                         text=True, cwd=REPO)
    return p, err


def tenant_line(p, err, want, timeout=900.0):
    """Wait for the tenant's line ``want``; fail with its stderr if it
    exits first."""
    import selectors

    sel = selectors.DefaultSelector()
    sel.register(p.stdout, selectors.EVENT_READ)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if sel.select(timeout=1.0):
            line = p.stdout.readline()
            if line.strip() == want:
                return
            if not line:
                break
    err.seek(0)
    check(False, f"tenant never printed {want} (rc {p.poll()}): "
          f"{err.read()[-3000:]}")


def tenant_result(p, err, timeout=900.0):
    out, _ = p.communicate(timeout=timeout)
    res = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    err.seek(0)
    check(p.returncode == 0 and res,
          f"tenant failed (rc {p.returncode}): {err.read()[-3000:]}")
    return json.loads(res[-1][len("RESULT "):])


def wait_for(fn, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while True:
        got = fn()
        if got:
            return got
        check(time.monotonic() < deadline, f"timed out waiting for {what}")
        time.sleep(0.05)


def p50(xs):
    return statistics.median(xs) if xs else float("nan")


def phase_durability(torch, tmp, direct, s13=None):
    """Phase 13 (module docstring).  ``s13``: P13_CARD, or a rehearsal's
    settings (device "cpu", tiny configs), under which the checks that
    only a card can meet are left out.  13b's broker and tenant start
    while 13a waits on its restarts; its measurements begin after 13a."""
    from vtpu_torch import entry
    from vtpu_torch.models import transformer as tr

    s13 = dict(P13_CARD if s13 is None else s13)
    card = s13["device"] != "cpu"
    cfg, bench = p13_config(s13["cfg"]), p13_config(s13["bench"])
    shape = tuple(s13["shape"])
    wbytes, bbytes = tr.state_bytes(cfg), tr.state_bytes(bench)
    home, where = journal_home(tmp, wbytes + bbytes)
    s13["wdir"] = home
    brokers, tenants = [], []
    out = {}

    def broker(name, sock, jdir, lease, **kw):
        brokers.append(Broker(name, sock, jdir, tmp, s13,
                              os.path.join(tmp, lease), **kw))
        return brokers[-1]

    try:
        # 13a: kill -9 at step 8, then an injected exit 3.
        t_phase = time.monotonic()
        for c_, name, seed in ((cfg, "p13", P13_SEED),
                               (bench, "p13b", P13_SEED + 1)):
            drawn, tree = drawn_weights(torch, c_, seed, s13["device"])
            torch.save(tree, os.path.join(home, f"{name}_weights.pt"))
        del drawn
        tree = torch.load(os.path.join(home, "p13_weights.pt"),
                          weights_only=True)
        prompt = p13_prompt(cfg, shape)
        ref = entry.serve(cfg, *shape, steps=P13_STEPS, device=s13["device"],
                          weights=tree, prompt=prompt)
        ref_rate, ref = ref["steps_per_s"], ref["tokens"]
        del tree
        gc.collect()
        if card:
            torch.cuda.empty_cache()
        prep_s = time.monotonic() - t_phase
        sock, jdir = os.path.join(tmp, "p13.sock"), os.path.join(home, "j13a")
        a = broker("p13a", sock, jdir, "lease13a.json")
        bound_a = a.bound()
        go = os.path.join(tmp, "p13a.go")
        tenants.append(p13_tenant(tmp, go, sock, "crash", s13))
        tenant_line(*tenants[-1], "KILLPOINT")
        # 13b's broker and tenant get ready meanwhile.
        sock_b = os.path.join(tmp, "p13b.sock")
        jdir_b = os.path.join(home, "j13b")
        args_b = ["--work-conserving", "0"]
        d = broker("p13d", sock_b, jdir_b, "lease13b.json", args=args_b)
        go_b = os.path.join(tmp, "p13b.go")
        bench_tenant = None
        # The cost model must be journaled before the kill.
        before = wait_for(lambda: (a.row("p13") or {}).get("cost_ema_us")
                          and a.row("p13"), "the tenant's cost EMA")
        jbytes = dir_bytes(jdir)
        a.stop()  # SIGKILL
        b = broker("p13b", sock, jdir, "lease13a.json",
                   faults="exit3@dispatch:nth=2")
        bound_b = b.bound()
        rec = b.row("p13")
        check(rec is not None and rec["recovered"],
              f"the successor did not recover the tenant: {b.stats()}")
        check(rec["used_bytes"] == wbytes,
              f"recovered ledger {rec['used_bytes']} != the journaled PUTs' "
              f"{wbytes} B")
        check(set(rec["cost_ema_us"]) == set(before["cost_ema_us"]),
              f"cost EMA keys {rec['cost_ema_us']} != {before['cost_ema_us']}")
        open(go, "w").close()
        d.bound()
        bench_tenant = p13_tenant(tmp, go_b, sock_b, "bench", s13)
        tenants.append(bench_tenant)
        rc_b = b.p.wait(timeout=600)
        check(rc_b == 3, f"the injected exit gave rc {rc_b}: "
              f"{b.log()[-2000:]}")
        c = broker("p13c", sock, jdir, "lease13a.json")
        bound_c = c.bound()
        res = tenant_result(*tenants[0])
        got = torch.from_numpy(np.load(os.path.join(tmp, "p13_tokens.npy")))
        same = int((got == ref).sum())
        check(same >= TOKEN_AGREEMENT * ref.numel(),
              f"tokens after step {P13_STEPS} agree at {same} of "
              f"{ref.numel()} positions")
        check([r["resumed"] for r in res["resumes"]] == [True, True],
              f"resumes {res['resumes']}")
        check(not res["cuda_initialized"], "the tenant initialised CUDA")
        wait_for(lambda: region_ledger(sock + ".shr") == 0 or None,
                 "the ledger to read 0 after the tenant exited", 30)
        jc = c.stats()["journal"]
        c.shutdown()
        ran = P13_STEPS - res["resumes"][-1]["at_step"]
        l_c = c.launches()
        if card:
            check(l_c.get("sm90") == ran * cfg.n_layers
                  and not l_c.get("wmma"),
                  f"successor's K1 launches {l_c} != {ran} steps x "
                  f"{cfg.n_layers} sm90")
        ct = res["chain_times"]
        rate_before = P13_CHAIN / (ct[1][1] - ct[0][1])
        rate_after = ran / (ct[-1][1] - res["resumes"][-1]["t"])
        put_s = res["setup_s"]["weights"]
        say(f"13a journal in {where}: {jbytes} B after the PUTs of "
            f"{wbytes} B of weights, PUT {put_s:.2f} s "
            f"({wbytes / put_s / 1e9:.3f} GB/s journaled and copied), "
            f"compile {res['setup_s']['compile']:.2f} s; drawing and saving "
            f"both phases' weights and serving in process {prep_s:.1f} s")
        say(f"13a bound after {bound_a:.2f} s (first), {bound_b:.2f} s "
            f"(after kill -9, replay of the journal included), "
            f"{bound_c:.2f} s (after the injected exit 3); resume "
            f"(restoring {wbytes} B and loading the program) "
            f"{jc['resume_s_last']:.2f} s on the last successor; resumed "
            f"at steps {[r['at_step'] for r in res['resumes']]}; tokens "
            f"after step {P13_STEPS} equal at {same} of {ref.numel()}; "
            f"successor's launches {json.dumps(l_c)}")
        say(f"13a rate {rate_before:.3f} steps/s in the chain before the "
            f"kill, {rate_after:.3f} over the {ran} steps from the last "
            f"resume to the end (its first chain's first run included; in "
            f"process: {ref_rate:.3f}; phase 3, 32 layers: "
            f"{direct['serve']:.3f}); 13a took "
            f"{time.monotonic() - t_phase:.1f} s")
        out["sm90"] = l_c.get("sm90", 0)
        out["wmma"] = l_c.get("wmma", 0)
        # The respawn's outage after the kill -9, for 15b's takeover: the
        # successor's time to a bound socket and the resume.
        out["respawn"] = {"bound_s": bound_b, "resume_s": jc["resume_s_last"]}

        # 13b: RESIZE, trace and HANDOVER at the bench config.
        t_b = time.monotonic()
        sock, jdir, go = sock_b, jdir_b, go_b
        tenant_line(*bench_tenant, "READY")
        open(go, "w").close()

        def busy():
            return d.row("p13b")["busy_us"] / 1e6, time.monotonic()

        time.sleep(1.0)
        b0, t0 = busy()
        time.sleep(P13_SHARE_S)
        b1, t1 = busy()
        r = vtpu_smi(["--broker", sock, "--resize", "p13b", "--core",
                      str(P13_CORE)])
        t_resize = time.time()
        check(r.returncode == 0, f"vtpu-smi --resize: {r.stdout}{r.stderr}")
        time.sleep(0.5)
        b2, t2 = busy()
        time.sleep(P13_SHARE_S)
        b3, t3 = busy()
        share1, share2 = (b1 - b0) / (t1 - t0), (b3 - b2) / (t3 - t2)
        lo, hi = SHARE_PAIR_BAND
        dump = os.path.join(tmp, "p13b_trace.json")
        r = vtpu_smi(["trace", "p13b", "--broker", sock, "--dump", dump])
        check(r.returncode == 0, f"vtpu-smi trace: {r.stdout}{r.stderr}")
        with open(dump) as f:
            events = json.load(f)["traceEvents"]
        r = vtpu_smi(["trace", "p13b", "--broker", sock, "--json"])
        spans = json.loads(r.stdout)["tenants"]["p13b"]["spans"]
        check(any(e.get("ph") == "X" for e in events) and spans,
              "the Chrome trace holds no span of the tenant")
        worst = max(abs(sp["queue_us"] + sp["bucket_us"] + sp["device_us"]
                        - sp["total_us"]) for sp in spans)
        check(worst <= 0.5, f"a span's phases miss its total by {worst} us")
        pre = [sp for sp in spans if sp["ts"] < t_resize
               and not sp.get("first_run")]
        post = [sp for sp in spans if sp["ts"] > t_resize + 0.5]
        phases = {k: (p50([sp[k] for sp in pre]), p50([sp[k] for sp in post]))
                  for k in ("queue_us", "bucket_us", "device_us", "total_us")}
        r = vtpu_smi(["leases"], env=dict(
            os.environ, VTPU_LEASE_SIDECAR=os.path.join(tmp, "lease13b.json"),
            PYTHONPATH=REPO))
        check(r.returncode == 0 and f"pid {d.p.pid} " in r.stdout,
              f"vtpu-smi leases does not name the broker {d.p.pid}: "
              f"{r.stdout}{r.stderr}")
        ema = d.row("p13b")["cost_ema_us"]

        def progress():
            try:
                with open(go + ".progress") as f:
                    return int(f.read())
            except (OSError, ValueError):
                return 0

        steps_at = progress()
        r = vtpu_smi(["--broker", sock, "--handover"])
        check(r.returncode == 0, f"vtpu-smi --handover: {r.stdout}{r.stderr}")
        rc_d = d.p.wait(timeout=120)
        e = broker("p13e", sock, jdir, "lease13b.json", args=args_b)
        bound_e = e.bound()

        wait_for(lambda: progress() >= steps_at + 4 * P13_CHAIN,
                 "two chains after the handover", 300)
        row_e = e.row("p13b")
        open(go + ".stop", "w").close()
        res = tenant_result(*bench_tenant)
        e.shutdown()
        l_e = e.launches()
        ct = res["chain_times"]
        t_lost = res["resumes"][0]["t"]
        last = max(t for _, t in ct if t <= t_lost)
        first = min(t for _, t in ct if t > t_lost)
        say(f"13b shares: {share1:.3f} of the window at core 100, "
            f"{share2:.3f} after RESIZE to {P13_CORE} (vtpu-smi --resize); "
            f"span p50 before / after the resize (us): " + ", ".join(
                f"{k[:-3]} {v[0]:.0f} / {v[1]:.0f}"
                for k, v in phases.items())
            + f" ({len(pre)} and {len(post)} spans; worst partition error "
            f"{worst:.2f} us; {len(events)} Chrome trace events)")
        say(f"13b HANDOVER: the broker exited rc {rc_d}, the successor bound "
            f"after {bound_e:.2f} s; blackout {first - last:.2f} s (last "
            f"chain answered before to first after); successor's row: core "
            f"{row_e['core_limit_pct']}, cost EMA {row_e['cost_ema_us']} "
            f"(before: {ema}); launches {json.dumps(l_e)}; 13b took "
            f"{time.monotonic() - t_b:.1f} s")
        check(row_e["core_limit_pct"] == P13_CORE,
              f"the successor's grant is core {row_e['core_limit_pct']}")
        check(set(row_e["cost_ema_us"]) >= set(ema),
              f"the successor lost the cost EMA: {row_e['cost_ema_us']}")
        check(res["resumes"] and all(x["resumed"] for x in res["resumes"]),
              f"resumes {res['resumes']}")
        if card:
            check(lo <= share2 <= hi,
                  f"after RESIZE to {P13_CORE} the tenant booked {share2:.3f} "
                  f"of its window, outside {lo}-{hi}")
            check(share1 > share2, f"core 100 booked {share1:.3f}, not more "
                  f"than core {P13_CORE}'s {share2:.3f}")
            check(phases["bucket_us"][0] == 0 < phases["bucket_us"][1],
                  f"bucket p50 {phases['bucket_us']} (want 0 before the "
                  f"resize, above 0 after)")
            check(not l_e.get("wmma"), f"wmma launches {l_e}")
        out["sm90"] += l_e.get("sm90", 0)
        out["wmma"] += l_e.get("wmma", 0)
    finally:
        for p, err in tenants:
            if p.poll() is None:
                p.kill()
                p.wait()
            err.close()
        for b in brokers:
            b.stop()
        if home != tmp:
            import shutil
            shutil.rmtree(home, ignore_errors=True)
    return out


# -- phase 14: the fastlane ----------------------------------------------------

P14_SEED = 14
P14_LAYERS = 2             # 14a: Llama-3-8B at full width, depth cut to 2
P14_STEPS = 16             # 14a: unchained steps over each path
P14_RING_MIN = 15          # 14a: of 16 (the first primes over the socket)
P14_PAR_STEPS = 8          # 14b
P14_RTT_N = 2000           # 14c: synchronous executes over each path
P14_RTT_FLOATS = 256
P14_RTT_RING_SHARE = 0.9
P14_ARENA_BYTES = 32 << 20  # 14d: each array (the arena holds 64 MiB)
P14_ARENA_N = 4            # 14d: arrays PUT and fetched in each combination
P14_SHARE_S = 6.0          # 14e: each window
P14_SHARE_CORE = 50
P14_SHARE_BAND = (0.40, 0.60)
P14_LONE_MIN = 0.85
P14_CO_CHAIN = 4           # 14f: the co-tenant's chains
P14_CO_STEPS = 8
P14_PROBE_WAIT_S = 20.0    # 14f's raw probes: the longest wait after 14a
# 14f: every index op on the broker's list, sent with out-of-range operands
# (the raw op is also run on the card alone, in a process of its own, to
# see which assert there).
P14_PROBES = ("gather", "index_select", "index", "embedding",
              "take_along_dim", "one_hot", "scatter", "scatter_add",
              "index_put", "index_put_accumulate", "bernoulli",
              "repeat_interleave")


def hostile_cases(torch):
    """(name, program, arguments, the CPU reference of the clamp-and-drop
    rule in numpy) for each index op on the broker's list, its operands
    out of range; the reference is None for a program COMPILE refuses (a
    non-empty gather from an empty dim has nothing to clamp to)."""
    F = torch.nn.functional
    x = np.arange(20, dtype=np.float32).reshape(5, 4)
    n = x.shape[0]
    i = np.array([-7, -1, 0, 3, 4, 5, 9, 1 << 40], np.int64)
    clamp = np.clip(i, 0, n - 1)
    wrap = np.where((i < 0) & (i >= -n), i + n, i)
    g = np.array([[9, -2, 1, 0], [4, 5, -9, 2]], np.int64)
    cols = np.arange(4)
    put_i = np.array([1, 9, -1, -9, 3], np.int64)
    put_w = np.where((put_i < 0) & (put_i >= -n), put_i + n, put_i)
    put_v = np.stack([np.full(4, -1.0 - k, np.float32) for k in range(5)])
    ref_set = x.copy()
    ref_add = x.copy()
    for k, r in enumerate(put_w):
        if 0 <= r < n:
            ref_set[r] = put_v[k]
            ref_add[r] += put_v[k]
    sc_i = np.array([[0, 9, -1, 4], [2, -3, 7, 1]], np.int64)
    sc_v = -np.ones((2, 4), np.float32)
    ref_sc, ref_sca = x.copy(), x.copy()
    for a in range(2):
        for b in range(4):
            r = sc_i[a, b]
            if 0 <= r < n:
                ref_sc[r, b] = sc_v[a, b]
                ref_sca[r, b] += sc_v[a, b]
    oh = np.zeros((len(i), 5), np.int64)
    for k, r in enumerate(i):
        if 0 <= r < 5:
            oh[k, r] = 1
    p = np.array([-3.0, 0.0, 1.0, 7.0, np.nan], np.float32)
    # A 2-D mask covers dims 0-1: the integer index after it reads dim 2
    # (size 3), so 4 (which dim 1 would hold) and -9 are dropped.
    x3 = np.arange(36, dtype=np.float32).reshape(2, 6, 3)
    mask = np.zeros((2, 6), bool)
    mask[0, 1] = mask[1, 2] = mask[1, 5] = mask[0, 4] = True
    m_i = np.array([1, 4, -1, -9], np.int64)
    ref_m = x3.copy()
    for (r, c), k in zip(np.argwhere(mask), m_i):
        k = k + 3 if -3 <= k < 0 else k
        if 0 <= k < 3:
            ref_m[r, c, k] = -1.0
    return [
        ("gather", lambda a, b: torch.gather(a, 0, b), [x, g],
         x[np.clip(g, 0, n - 1), cols]),
        ("index_select", lambda a, b: torch.index_select(a, 0, b), [x, i],
         x[clamp]),
        ("index", lambda a, b: a[b], [x, i], x[np.clip(wrap, 0, n - 1)]),
        ("embedding", lambda w, b: F.embedding(b, w), [x, i], x[clamp]),
        ("take_along_dim", lambda a, b: torch.take_along_dim(a, b, 1),
         [x, np.array([[9], [0], [-3], [2], [1]], np.int64)],
         x[np.arange(n), np.clip([9, 0, -3, 2, 1], 0, 3)][:, None]),
        ("one_hot", lambda b: F.one_hot(b, 5), [i], oh),
        ("scatter", lambda a, b, v: torch.scatter(a, 0, b, v),
         [x, sc_i, sc_v], ref_sc),
        ("scatter_add", lambda a, b, v: torch.scatter_add(a, 0, b, v),
         [x, sc_i, sc_v], ref_sca),
        ("index_put", lambda a, b, v: torch.index_put(a, (b,), v),
         [x, put_i, put_v], ref_set),
        ("index_put_accumulate",
         lambda a, b, v: torch.index_put(a, (b,), v, True),
         [x, put_i, put_v], ref_add),
        ("bernoulli", lambda q: torch.bernoulli(q), [p],
         np.array([0.0, 0.0, 1.0, 1.0, 0.0], np.float32)),
        ("index_put_mask", lambda a, m, b, v: torch.index_put(a, (m, b), v),
         [x3, mask, m_i, np.array([-1.0], np.float32)], ref_m),
        ("gather_empty_dim", lambda a, b: torch.index_select(a, 0, b),
         [np.zeros((0, 4), np.float32), i], None),
    ]


def probe_child(torch, op):
    """One raw index op on the card with an out-of-range operand, in a
    process of its own: "ok" (it ran), "assert" (a device-side assert,
    which leaves the context unusable) or the host's error."""
    dev = "cuda"
    x = torch.arange(20.0, device=dev).reshape(5, 4)
    bad = torch.tensor([0, 9, -7], device=dev)
    runs = {
        "gather": lambda: torch.gather(x, 0, bad[:, None].expand(3, 4)),
        "index_select": lambda: torch.index_select(x, 0, bad),
        "index": lambda: x[bad],
        "embedding": lambda: torch.nn.functional.embedding(bad, x),
        "take_along_dim": lambda: torch.take_along_dim(x, bad[:, None], 0),
        "one_hot": lambda: torch.nn.functional.one_hot(bad.abs(), 5),
        "scatter": lambda: torch.scatter(x, 0, bad[:, None].expand(3, 4),
                                         -x[:3]),
        "scatter_add": lambda: torch.scatter_add(
            x, 0, bad[:, None].expand(3, 4), -x[:3]),
        "index_put": lambda: torch.index_put(x, (bad,), -x[:3]),
        "index_put_accumulate": lambda: torch.index_put(x, (bad,), -x[:3],
                                                        True),
        "bernoulli": lambda: torch.bernoulli(
            torch.tensor([-3.0, 0.5, 7.0], device=dev)),
        "repeat_interleave": lambda: torch.repeat_interleave(
            x, torch.tensor([5, 5, 5, 5, 5], device=dev), dim=0,
            output_size=6),
    }
    try:
        runs[op]()
        torch.cuda.synchronize()
        return {"op": op, "raw": "ok"}
    except RuntimeError as e:
        return {"op": op, "raw": "assert" if "device-side assert" in str(e)
                else f"error: {str(e).splitlines()[0][:120]}"}


def client_steps(torch, c, exe, param_ids, start, steps, chain=1, depth=2):
    """``steps`` greedy steps of ``exe``, a step program an earlier
    ``serve_brokered`` of this client compiled, on the weights
    ``param_ids`` it left in the broker, from the tokens ``start``: sent
    through the client as ``serve_brokered`` sends them (chains of
    ``chain``, each reply read before the next is sent, ``depth`` in
    flight, the first chain untimed).  Returns the final tokens, those of
    the chain before, the steps per second after the first chain and each
    fetch's monotonic time."""
    import collections

    c.put(torch.as_tensor(start, dtype=torch.int32), "tok0")
    ids = ["tok0", "tok1"]
    chains = collections.deque()
    out = {"tokens": None, "prev_tokens": None, "times": []}
    sent = 0

    def send():
        nonlocal sent
        k = min(chain, steps - sent)
        c.execute_send_ids(exe.id, [ids[0]] + list(param_ids), [ids[1]],
                           repeats=k, carry=((0, 0),))
        c.execute_recv()
        chains.append((k, ids[1]))
        ids.reverse()
        sent += k

    def fetch():
        k, oid = chains.popleft()
        out["prev_tokens"], out["tokens"] = out["tokens"], c.get(oid)
        out["times"].append(time.monotonic())
        return k

    send()
    fetch()
    timed, t0 = 0, time.monotonic()
    while sent < steps or chains:
        if sent < steps and len(chains) < depth:
            send()
        else:
            timed += fetch()
    out["steps_per_s"] = timed / (time.monotonic() - t0)
    return out


def step_gaps_ms(times):
    """The median and the largest gap, in ms, between successive
    fetches (one step each when unchained)."""
    gaps = [(b - a) * 1e3 for a, b in zip(times, times[1:])]
    return (statistics.median(gaps), max(gaps)) if gaps else (0.0, 0.0)


def p14_child(torch, go, mode, sock, out_dir):
    """Phase 14, one tenant that never opens the card
    (CUDA_VISIBLE_DEVICES empty, VTPU_FASTLANE=1): ``full``, ``parity``,
    ``rtt``, ``arena``, ``share``, ``co`` or ``hostile`` (the module
    docstring's 14a-14f)."""
    from vtpu_torch import entry
    from vtpu_torch.models import transformer as tr
    from vtpu_torch.runtime.client import RuntimeClient, RuntimeError_

    check(os.environ.get("CUDA_VISIBLE_DEVICES") == "",
          "the tenant was started with a card visible")
    res = {"pid": os.getpid()}

    def released():
        print("READY", flush=True)
        while not os.path.exists(go):
            time.sleep(0.005)

    def lane_of(c, name):
        return c.stats()[name].get("fastlane") or {}

    if mode == "full":
        cfg = dataclasses.replace(tr.TransformerConfig.llama3_8b(),
                                  n_layers=P14_LAYERS)
        c = RuntimeClient(sock, tenant="lane-full", hbm_limit=FULL_CAP,
                          core_limit=100)
        check(c._lane is not None, "14a: no lane negotiated")
        released()
        t0 = time.monotonic()
        a = entry.serve_brokered(c, cfg, *FULL_SHAPE, steps=P14_STEPS,
                                 init="program", seed=P14_SEED, chain=1,
                                 depth=2)
        fl = lane_of(c, "lane-full")
        # A second connection of the tenant closes the lane: the same
        # client, weights and program go on over the socket.
        c2 = RuntimeClient(sock, tenant="lane-full", fastlane=False)
        b = client_steps(torch, c, a["exe"], a["param_ids"],
                         np.zeros(FULL_SHAPE, np.int32), P14_STEPS)
        fl2 = lane_of(c, "lane-full")
        res.update(
            wall_s=time.monotonic() - t0, lane_rate=a["steps_per_s"],
            sock_rate=b["steps_per_s"], ring=fl.get("ring_steps", 0),
            lane_gaps=step_gaps_ms([t for _, t in a["chain_times"]]),
            sock_gaps=step_gaps_ms(b["times"]),
            fallback=fl.get("fallback_steps", 0),
            ring_after=fl2.get("ring_steps", 0), gate_after=fl2.get("gate"),
            same=int((a["tokens"] == b["tokens"]).sum())
            + int((a["prev_tokens"] == b["prev_tokens"]).sum()),
            total=2 * a["tokens"].numel(),
            in_range=bool(int(a["tokens"].min()) >= 0
                          and int(a["tokens"].max()) < cfg.vocab),
            device_us=fl2.get("device_us", 0), billed_us=fl2.get(
                "billed_us", 0), setup=a["setup_s"])
        c2.close()
        c.close()
    elif mode == "parity":
        released()
        cfg = tr.TransformerConfig.bench()
        c = RuntimeClient(sock, tenant="lane-parity")
        check(c._lane is not None, "14b: no lane negotiated")
        prompt = np.random.default_rng(P14_SEED).integers(
            0, cfg.vocab, BROKER_SHAPE, dtype=np.int32)
        weights = torch.load(os.path.join(out_dir, "p14_weights.pt"),
                             weights_only=True)
        a = entry.serve_brokered(c, cfg, *BROKER_SHAPE, steps=P14_PAR_STEPS,
                                 weights=weights, chain=1, depth=2,
                                 prompt=prompt)
        c.put(torch.from_numpy(prompt), "prompt")
        flash = dataclasses.replace(cfg, use_flash=True)
        meta = [torch.empty(BROKER_SHAPE, dtype=torch.int32, device="meta")]
        meta += [torch.empty(shape, dtype=dtype, device="meta")
                 for _, shape, dtype in tr.param_shapes(flash)]
        exe = c.compile(tr.functional_forward(flash), meta)
        for _ in range(2):  # the first run primes over the socket
            c.execute_send_ids(exe.id, ["prompt"] + a["param_ids"],
                               ["logits"])
            c.execute_recv()
        fl = lane_of(c, "lane-parity")
        logits = c.get("logits")
        c2 = RuntimeClient(sock, tenant="lane-parity", fastlane=False)
        b = client_steps(torch, c, a["exe"], a["param_ids"], prompt,
                         P14_PAR_STEPS)
        np.savez(os.path.join(out_dir, "p14_parity.npz"),
                 lane=a["tokens"].numpy(), sock=b["tokens"].numpy(),
                 logits=logits.float().numpy())
        res.update(lane_rate=a["steps_per_s"], sock_rate=b["steps_per_s"],
                   ring=fl.get("ring_steps", 0),
                   lane_gaps=step_gaps_ms([t for _, t in a["chain_times"]]),
                   sock_gaps=step_gaps_ms(b["times"]))
        c2.close()
        c.close()
    elif mode == "rtt":
        released()
        x = torch.ones(P14_RTT_FLOATS)
        for lane in (True, False):
            name = f"rtt-{'lane' if lane else 'sock'}"
            c = RuntimeClient(sock, tenant=name, fastlane=lane)
            c.put(x, "x0")
            exe = c.compile(lambda v: v * 2.0 + 1.0, [x])
            for _ in range(3):
                c.execute_send_ids(exe.id, ["x0"], ["y0"])
                c.recv_reply()
            lat = []
            for _ in range(P14_RTT_N):
                t0 = time.perf_counter()
                c.execute_send_ids(exe.id, ["x0"], ["y0"])
                c.recv_reply()
                lat.append((time.perf_counter() - t0) * 1e6)
            lat.sort()
            ok = bool(torch.equal(c.get("y0"), x * 2.0 + 1.0))
            fl = lane_of(c, name)
            res[name] = {"p50_us": lat[len(lat) // 2],
                         "p99_us": lat[int(len(lat) * 0.99)],
                         "ring": fl.get("ring_steps", 0), "ok": ok}
            c.close()
    elif mode == "arena":
        released()
        rng = np.random.default_rng(P14_SEED)
        data = [torch.from_numpy(rng.standard_normal(
            P14_ARENA_BYTES // 4).astype(np.float32))
            for _ in range(P14_ARENA_N)]
        total = P14_ARENA_N * P14_ARENA_BYTES
        for jname, path in (("off", sock), ("on", out_dir)):
            for lane in (False, True):
                name = f"arena-{jname}-{'arena' if lane else 'sock'}"
                c = RuntimeClient(path, tenant=name, fastlane=lane)
                check(lane == (c._lane is not None),
                      f"{name}: lane {c._lane is not None}")
                t0 = time.perf_counter()
                for k, d in enumerate(data):
                    c.put(d, f"a{k}")
                put_s = time.perf_counter() - t0
                used = c.stats()[name]["used_bytes"]
                t0 = time.perf_counter()
                got = [c.get(f"a{k}") for k in range(P14_ARENA_N)]
                get_s = time.perf_counter() - t0
                res[name] = {
                    "put_gbs": total / put_s / 1e9,
                    "get_gbs": total / get_s / 1e9,
                    "equal": all(torch.equal(g, d)
                                 for g, d in zip(got, data)),
                    "ledger": used, "want": total}
                c.close()
    elif mode == "share":
        core = int(out_dir)
        c = RuntimeClient(sock, tenant=f"share-{os.getpid()}",
                          core_limit=core)
        check(c._lane is not None, "14e: no lane negotiated")
        out = entry.serve_brokered(
            c, "bench", *BROKER_SHAPE, init="program", seed=P14_SEED,
            chain=1, depth=2, seconds=P14_SHARE_S, on_ready=released)
        fl = lane_of(c, c.tenant)
        res.update(steps_per_s=out["steps_per_s"], booked_us=out["booked_us"],
                   window_s=out["window_s"], core=out["stats"][
                       "core_limit_pct"], grants=c._lane.lease_grants
                   if c._lane is not None else 0,
                   ring=fl.get("ring_steps", 0),
                   fallback=fl.get("fallback_steps", 0))
        c.close()
    elif mode == "co":
        # Alone first, released by ``go``; then, released by ``go``.2,
        # again on the same weights and program beside the hostile one.
        c = RuntimeClient(sock, tenant="co", fastlane=False)
        solo = entry.serve_brokered(c, "bench", *BROKER_SHAPE,
                                    init="program", seed=P14_SEED,
                                    chain=P14_CO_CHAIN, depth=2,
                                    steps=P14_CO_STEPS, on_ready=released)
        print("SOLO", flush=True)
        while not os.path.exists(go + ".2"):
            time.sleep(0.005)
        # Served again and again from the same prompt until the hostile
        # tenant is done, each time held to the solo run's tokens.
        reps, same = 0, 0
        while reps == 0 or not os.path.exists(go + ".2.done"):
            beside = client_steps(torch, c, solo["exe"], solo["param_ids"],
                                  np.zeros(BROKER_SHAPE, np.int32),
                                  P14_CO_STEPS, chain=P14_CO_CHAIN)
            reps += 1
            same += int(torch.equal(beside["tokens"], solo["tokens"]))
        res.update(reps=reps, same=same, positions=solo["tokens"].numel())
        c.close()
    else:  # hostile
        released()
        rows = []
        for lane in (False, True):
            name = f"hostile-{'lane' if lane else 'sock'}"
            c = RuntimeClient(sock, tenant=name, fastlane=lane)
            for case, fn, args, ref in hostile_cases(torch):
                ts = [torch.from_numpy(a) for a in args]
                ids = [c.put(t).id for t in ts]
                if ref is None:
                    try:
                        c.compile(fn, ts)
                        refused = False
                    except RuntimeError_ as e:
                        refused = "INVALID_ARGUMENT" in str(e)
                    rows.append({"case": case, "path": name,
                                 "equal": refused})
                    continue
                exe = c.compile(fn, ts)
                for _ in range(2 if lane else 1):
                    c.execute_send_ids(exe.id, ids, ["out"])
                    c.recv_reply()
                got = c.get("out").numpy()
                rows.append({"case": case, "path": name,
                             "equal": bool(np.array_equal(got, ref))})
            fl = lane_of(c, name)
            res[name] = {"ring": fl.get("ring_steps", 0)}
            c.close()
        res["rows"] = rows
        open(go + ".done", "w").close()
    check(not torch.cuda.is_initialized(), "the tenant initialised CUDA")
    return res


def p14_tenant(env, tmp, go, name, args):
    """One phase 14 tenant, started now; it prints READY once set up and
    waits for ``go``."""
    err = open(os.path.join(tmp, f"{name}.err"), "w+")
    p = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                          "--child", "p14", go, *args], env=env,
                         stdout=subprocess.PIPE, stderr=err, text=True)
    return p, err


def phase_fastlane(torch, tmp, direct):
    """Phase 14 (module docstring): returns K1's launches by route.  The
    processes it starts ahead of their step are stopped however it ends."""
    started = []
    try:
        return _phase_fastlane(torch, tmp, direct, started)
    finally:
        for p in started:
            if isinstance(p, Broker):
                p.stop()
            elif p.poll() is None:
                p.kill()
                p.wait()


def _phase_fastlane(torch, tmp, direct, started):
    import threading

    from vtpu_torch import entry
    from vtpu_torch.models import transformer as tr
    from vtpu_torch.ops import flash_attention as fa
    from vtpu_torch.runtime import server as rs

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", VTPU_FASTLANE="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    launches = {r: 0 for r in fa.ROUTES}

    def reset():
        fa.flash_attention.launches = 0
        fa.flash_attention.route_launches = dict.fromkeys(fa.ROUTES, 0)

    def take(label):
        got = dict(fa.flash_attention.route_launches)
        for r in launches:
            launches[r] += got[r]
        return got

    def serve(sock, **kw):
        srv = rs.make_server(sock, hbm_limit=0, core_limit=0, **kw)
        th = threading.Thread(target=srv.serve_forever, daemon=True,
                              kwargs={"poll_interval": 0.1})
        th.start()
        return srv, th

    def stop(srv, th):
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)

    def gaps(g):
        return f"{g[0]:.2f}, {g[1]:.2f}"

    def drained(srv, what):
        deadline = time.monotonic() + 30
        while broker_ledger(srv.state) and time.monotonic() < deadline:
            time.sleep(0.05)
        check(broker_ledger(srv.state) == 0,
              f"{what}: ledger {broker_ledger(srv.state)} after the tenants "
              "exited")

    # 14f's raw probes start now, each alone in its process; they hold
    # the card for a moment and are read at 14f.
    t_probes, hung = time.monotonic(), {}
    probes = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                "--child", "p14probe", op],
                               stdout=subprocess.PIPE,
                               stderr=subprocess.DEVNULL, text=True)
              for op in P14_PROBES]
    started.extend(probes)
    sock = os.path.join(tmp, "p14.sock")
    jsock = os.path.join(tmp, "p14j.sock")
    srv, th = serve(sock)

    # The tenants of 14a-14d start now, each released by its go file when
    # its step comes (only 14a's connects before that).
    kids = {}
    for args in (("full", sock, tmp), ("parity", sock, tmp),
                 ("rtt", sock, tmp), ("arena", sock, jsock)):
        kids[args[0]] = p14_tenant(env, tmp, os.path.join(
            tmp, f"p14_{args[0]}.go"), f"p14_{args[0]}", args)
        started.append(kids[args[0]][0])

    def release(*names):
        for n in names:
            tenant_line(*kids[n], "READY", timeout=600)
        for n in names:
            open(os.path.join(tmp, f"p14_{n}.go"), "w").close()
        return [tenant_result(*kids[n], timeout=600) for n in names]

    try:
        # 14a: Llama-3-8B at full width over the lane, then the socket.
        t0 = time.monotonic()
        reset()
        full, = release("full")
        got = take("full")
        want = 2 * P14_STEPS * P14_LAYERS
        say(f"14a llama3_8b at depth {P14_LAYERS} b=2 s=512, one execute a "
            f"step: lane "
            f"{full['lane_rate']:.3f} steps/s, socket {full['sock_rate']:.3f} "
            f"steps/s, phase 3 in process {direct['serve']:.3f}; ms between "
            f"steps (median, largest): lane {gaps(full['lane_gaps'])}, socket "
            f"{gaps(full['sock_gaps'])}; ring steps "
            f"{full['ring']} of {P14_STEPS} (socket {full['fallback']}), "
            f"then {full['ring_after']} with the gate {full['gate_after']}; "
            f"tokens equal at {full['same']} of {full['total']}; launches "
            f"{json.dumps(got)}; lane device time {full['device_us']} us "
            f"billed {full['billed_us']} us; weights and compile "
            f"{json.dumps({k: round(v, 1) for k, v in full['setup'].items()})}"
            f" s; {time.monotonic() - t0:.1f} s")
        check(full["ring"] >= P14_RING_MIN, f"14a: {full['ring']} ring steps")
        check(full["ring_after"] == full["ring"] and full["gate_after"] == 2,
              "14a: the second connection did not close the lane")
        check(full["same"] == full["total"] and full["in_range"],
              f"14a: lane tokens differ from socket tokens at "
              f"{full['total'] - full['same']} positions")
        check(got["sm90"] == want and got["wmma"] == 0,
              f"14a: launches {got} != {want} sm90")
        drained(srv, "14a")
        # 14f's probes run beside 14a only: a probe whose out-of-range
        # kernel has not trapped by now shares the card with 14b-14e's
        # windows (one ran past 300 s after 14a on an H100), so it is killed
        # and reported as still running.
        t_w = time.monotonic()
        for op, pr in zip(P14_PROBES, probes):
            try:
                pr.wait(timeout=max(P14_PROBE_WAIT_S
                                    - (time.monotonic() - t_w), 0.1))
            except subprocess.TimeoutExpired:
                pr.kill()
                pr.wait()
                hung[op] = time.monotonic() - t_probes
        say(f"14f's probes: {len(probes) - len(hung)} ended within "
            f"{time.monotonic() - t_w:.1f} s after 14a; still running "
            f"and killed: " + (", ".join(f"{k} after {v:.1f} s"
                                         for k, v in hung.items())
                               or "none"))

        # 14b: parity with in-process serving, bench config.
        t0 = time.monotonic()
        cfg = dataclasses.replace(tr.TransformerConfig.bench(),
                                  use_flash=True)
        drawn, tree = drawn_weights(torch, cfg, P14_SEED, "cuda")
        torch.save(tree, os.path.join(tmp, "p14_weights.pt"))
        prompt = np.random.default_rng(P14_SEED).integers(
            0, cfg.vocab, BROKER_SHAPE, dtype=np.int32)
        ref = entry.serve(cfg, *BROKER_SHAPE, steps=P14_PAR_STEPS,
                          device="cuda", weights=tree, prompt=prompt)
        with torch.inference_mode():
            ref_logits = ref["model"](
                torch.from_numpy(prompt).cuda()).float().cpu()
        ref_tokens, ref_rate = ref["tokens"], ref["steps_per_s"]
        del drawn, tree, ref
        gc.collect()
        torch.cuda.empty_cache()
        reset()
        par, = release("parity")
        got = take("parity")
        out = np.load(os.path.join(tmp, "p14_parity.npz"))
        logits = torch.from_numpy(out["logits"])
        rel = ((logits - ref_logits).norm() / ref_logits.norm()).item()
        same = {k: int((torch.from_numpy(out[k]) == ref_tokens).sum())
                for k in ("lane", "sock")}
        total = ref_tokens.numel()
        say(f"14b parity (bench b=4 s=512, PUT weights, one execute a "
            f"step): lane {par['lane_rate']:.3f} steps/s, socket "
            f"{par['sock_rate']:.3f}, in process {ref_rate:.3f}; ms between "
            f"steps (median, largest): lane {gaps(par['lane_gaps'])}, socket "
            f"{gaps(par['sock_gaps'])}; logits rel "
            f"L2 {rel:.3g} (tol {LOGITS_REL_L2}); tokens after "
            f"{P14_PAR_STEPS} steps equal at {same['lane']} (lane) and "
            f"{same['sock']} (socket) of {total}; ring steps {par['ring']}; "
            f"launches {json.dumps(got)}; {time.monotonic() - t0:.1f} s")
        check(torch.isfinite(logits).all().item() and rel < LOGITS_REL_L2,
              f"14b: lane logits disagree with in-process serving: {rel}")
        check(min(same.values()) >= TOKEN_AGREEMENT * total,
              f"14b: tokens agree at {same} of {total}")
        check(par["ring"] >= P14_PAR_STEPS, f"14b: {par['ring']} ring steps")
        want = (2 * P14_PAR_STEPS + 2) * cfg.n_layers
        check(got["sm90"] == want and got["wmma"] == 0,
              f"14b: launches {got} != {want} sm90")
        drained(srv, "14b")

        # 14c and 14d: the round trip, and the arenas with the journal off
        # (this broker) and on (a second one, its journal on /dev/shm).
        t0 = time.monotonic()
        jdir, where = journal_home(tmp, 2 * P14_ARENA_N * P14_ARENA_BYTES)
        jsrv, jth = serve(jsock, journal_dir=jdir)
        try:
            rtt, arena = release("rtt", "arena")
        finally:
            stop(jsrv, jth)
        for name in ("rtt-lane", "rtt-sock"):
            r = rtt[name]
            say(f"14c {name}: p50 {r['p50_us']:.1f} us, p99 "
                f"{r['p99_us']:.1f} us over {P14_RTT_N} synchronous "
                f"executes of a {P14_RTT_FLOATS}-float program; ring steps "
                f"{r['ring']}")
            check(r["ok"], f"14c {name}: wrong values")
        check(rtt["rtt-lane"]["ring"] >= P14_RTT_RING_SHARE * P14_RTT_N,
              f"14c: {rtt['rtt-lane']['ring']} ring steps of {P14_RTT_N}")
        for name, r in sorted((k, v) for k, v in arena.items()
                              if k.startswith("arena-")):
            say(f"14d {name} (journal {'on ' + where if '-on-' in name else 'off'}"
                f"): PUT {r['put_gbs']:.3f} GB/s, GET {r['get_gbs']:.3f} GB/s "
                f"for {P14_ARENA_N} arrays of {P14_ARENA_BYTES >> 20} MiB; "
                f"ledger {r['ledger']} of {r['want']}")
            check(r["equal"], f"14d {name}: values differ")
            check(r["ledger"] == r["want"], f"14d {name}: ledger "
                  f"{r['ledger']} != {r['want']}")
        say(f"14c-d took {time.monotonic() - t0:.1f} s")
        drained(srv, "14c-d")
    finally:
        stop(srv, th)

    # 14f's broker process starts now and binds while 14e runs.
    fsock = os.path.join(tmp, "p14f.sock")
    lease = os.path.join(tmp, "p14f.lease.json")
    br = Broker("p14f", fsock, os.path.join(tmp, "p14f.journal"), tmp,
                {"device": "cuda"}, lease)
    started.append(br)

    # 14e: two lane tenants at 50% in a broker that does not lend idle
    # share, then one alone at 100%.
    t0 = time.monotonic()
    ssock = os.path.join(tmp, "p14s.sock")
    ssrv, sth = serve(ssock, work_conserving=False)
    try:
        reset()
        # All three set up at once; the pair is released together, then
        # the one alone once the pair is done.
        go_pair = os.path.join(tmp, "p14_pair.go")
        go_solo = os.path.join(tmp, "p14_solo.go")
        kids = [p14_tenant(env, tmp, go_pair, f"p14_pair{i}",
                           ("share", ssock, str(P14_SHARE_CORE)))
                for i in range(2)]
        kids.append(p14_tenant(env, tmp, go_solo, "p14_solo",
                               ("share", ssock, "100")))
        started.extend(p for p, _ in kids)
        for p, err in kids:
            tenant_line(p, err, "READY", timeout=300)
        open(go_pair, "w").close()
        pair = [tenant_result(p, err, timeout=300) for p, err in kids[:2]]
        open(go_solo, "w").close()
        solo = [tenant_result(*kids[2], timeout=300)]
        got = take("share")
        lo, hi = P14_SHARE_BAND
        for label, rows in (("pair", pair), ("alone", solo)):
            say(f"14e {label}: " + "; ".join(
                f"core {r['core']}%: {r['steps_per_s']:.2f} steps/s, booked "
                f"{r['booked_us'] / 1e6:.3f} s of {r['window_s']:.3f} s "
                f"({r['booked_us'] / 1e6 / r['window_s']:.3f}), lease grants "
                f"{r['grants']}, ring {r['ring']} socket {r['fallback']}"
                for r in rows))
        for r in pair:
            share = r["booked_us"] / 1e6 / r["window_s"]
            check(lo <= share <= hi, f"14e: a 50% lane tenant booked "
                  f"{share:.3f} of its window, outside {lo}-{hi}")
            check(r["grants"] > 0, "14e: no lease granted")
        share = solo[0]["booked_us"] / 1e6 / solo[0]["window_s"]
        check(share >= P14_LONE_MIN, f"14e: the lone tenant booked "
              f"{share:.3f} of its window")
        check(got["wmma"] == 0, f"14e: launches {got}")
        drained(ssrv, "14e")
    finally:
        stop(ssrv, sth)
    say(f"14e took {time.monotonic() - t0:.1f} s")

    # 14f: F1.  The raw ops on the card, each alone; then a broker process,
    # a co-tenant alone and beside a hostile one.
    t0 = time.monotonic()
    raw = {}
    for op, pr in zip(P14_PROBES, probes):
        out, _ = pr.communicate(timeout=300)
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        raw[op] = (json.loads(line[-1][7:])["raw"] if line
                   else f"still running after {hung[op]:.1f} s, killed"
                   if op in hung else f"rc {pr.returncode}")
    say("14f the raw ops on the card with an out-of-range operand: "
        + json.dumps(raw))
    try:
        br.bound()
        pid = br.p.pid
        fenv = dict(env, VTPU_RPC_TIMEOUT_S="300")
        go = os.path.join(tmp, "p14_f1.go")
        co = p14_tenant(fenv, tmp, go, "p14_co", ("co", fsock, tmp))
        host = p14_tenant(fenv, tmp, go + ".2", "p14_hostile",
                          ("hostile", fsock, tmp))
        started.extend((co[0], host[0]))
        for p, err in (co, host):
            tenant_line(p, err, "READY", timeout=300)
        open(go, "w").close()                   # the co-tenant alone
        tenant_line(*co, "SOLO", timeout=300)
        open(go + ".2", "w").close()            # both at once
        hostile = tenant_result(*host, timeout=300)
        cor = tenant_result(*co, timeout=300)
        bad = [r for r in hostile["rows"] if not r["equal"]]
        alive = br.p.poll() is None and br.p.pid == pid
        br.shutdown()
        f_launch = br.launches()
    finally:
        br.stop()
    for r in ("sm90", "wmma"):
        launches[r] += int(f_launch.get(r, 0))
    say(f"14f: {len(hostile['rows'])} hostile programs (socket and lane, "
        f"ring steps {hostile['hostile-lane']['ring']}): {len(bad)} differ "
        f"from the clamp-and-drop reference; broker pid {pid} alive "
        f"through them: {alive}; the co-tenant served {cor['reps']} runs of "
        f"{P14_CO_STEPS} steps beside them, {cor['same']} equal to its solo "
        f"run at all {cor['positions']} positions; broker launches "
        f"{json.dumps(f_launch)}; {time.monotonic() - t0:.1f} s")
    check(alive, "14f: the broker died under the hostile tenant")
    check(not bad, f"14f: hostile outputs differ from the reference: {bad}")
    check(hostile["hostile-lane"]["ring"] >= sum(
        ref is not None for *_, ref in hostile_cases(torch)),
          "14f: the hostile programs did not ride the ring")
    check(cor["same"] == cor["reps"],
          f"14f: {cor['reps'] - cor['same']} of the co-tenant's runs beside "
          "the hostile tenant changed its tokens")
    return launches


# -- phase 15: the SLO plane and the hot standby ------------------------------

P15_SEED = 15
P15_CORE = 50              # 15a: each of the pair's share (strict)
P15_SHARE_S = 6.0          # 15a: the pair's window
P15_COST_S = 1.0           # 15a: each window of the tenant alone
P15_TURNS = (True, False, True, False)  # the plane on and off in turns
P15_PARTITION_US = 0.5     # an item's phases against its total
P15_SPLIT_S = 1e-9         # a ready time against the billed share's
P15_LAYERS = 1             # 15b: 13a's cell cut to depth 1
# 15b's cell is 13a's (Llama-3-8B's width, chains of 4, 8 GiB, the kill
# after 8 of 16 steps) at depth 1; 15a's tenants are the bench config.
P15_CARD = dict(P13_CARD, layers=P15_LAYERS, steps=P13_STEPS,
                kill_at=P13_KILL_AT)


def p15_child(torch, go, sock, name, other, s15):
    """15a's tenant (no card): serves ``s15``'s bench config from the
    broker's init program at P15_CORE% until ``<go>.stop.<name>`` exists,
    reads its own SLO row and asks for ``other``'s (it must get its own),
    prints DONE; once ``<go>.resume`` exists it closes its end of the
    connection (the broker it knew is gone: handed over in the parent) and
    reads its row again, which resumes it on the successor."""
    from vtpu_torch import entry
    from vtpu_torch.runtime import protocol as P
    from vtpu_torch.runtime.client import RuntimeClient

    check(os.environ.get("CUDA_VISIBLE_DEVICES") == "",
          "the tenant was started with a card visible")
    c = RuntimeClient(sock, tenant=name, core_limit=P15_CORE)
    stop = f"{go}.stop.{name}"

    def ready():
        print("READY", flush=True)
        while not os.path.exists(go):
            time.sleep(0.005)

    out = entry.serve_brokered(
        c, s15["bench"], *s15["bench_shape"], init="program", seed=P15_SEED,
        chain=BROKER_CHAIN, depth=2, seconds=600.0, on_ready=ready,
        on_chain=lambda n: os.path.exists(stop))
    own = c.slo()
    scoped = c._rpc({"kind": P.SLO, "tenant": other})
    epoch = c.epoch
    print("DONE", flush=True)
    while not os.path.exists(go + ".resume"):
        time.sleep(0.005)
    c.sock.close()
    after = c.slo()
    res = {"steps": out["steps"], "own": own["tenants"],
           "setup_s": out["setup_s"],
           "scoped": sorted(scoped.get("tenants") or {}),
           "scoped_matrix": "matrix" in scoped, "after": after["tenants"],
           "epochs": [epoch, c.epoch],
           "cuda_initialized": torch.cuda.is_initialized()}
    c.close()
    return res


def p15_tenants(tmp, go, sock, names, s15):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               VTPU_RECONNECT_TIMEOUT_S="120", VTPU_RPC_TIMEOUT_S="300",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.pop("VTPU_SLO_TARGET_US", None)
    out = []
    for name, other in zip(names, names[::-1]):
        err = open(os.path.join(tmp, f"p15_{name}.err"), "w+")
        out.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", "p15", go,
             sock, name, other, json.dumps(s15)], env=env,
            stdout=subprocess.PIPE, stderr=err, text=True, cwd=REPO), err))
    return out


def stdout_of(fn, *args):
    """``fn(*args)``'s return and what it printed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


def split_faults(batches):
    """Each batch's split of its device window (tracing off), against the
    rule: its ready times rise from its first dispatch and end at its
    observed completion, and each cuts the window in the share billing
    charged its item.  Returns (batches out of that order, the largest
    error of a ready time in s, items ready before their own dispatch)."""
    disorder, worst, early = 0, 0.0, 0
    for b in batches:
        r, t_first, t_obs = b["readies"], b["t_first"], b["t_obs"]
        disorder += not (t_first == b["t0s"][0] and r[-1] == t_obs
                         and r == sorted(r) and t_first <= r[0])
        total = sum(max(x, 0.0) for x in b["busys"])
        acc = 0.0
        for ready, busy in zip(r, b["busys"]):
            acc += (max(busy, 0.0) / total if total > 0.0
                    else 1.0 / len(r))
            worst = max(worst, abs(ready - (t_first + (t_obs - t_first)
                                            * min(acc, 1.0))))
        early += sum(ready < t0 for ready, t0 in zip(r, b["t0s"]))
    return disorder, worst, early


def phase_slo(torch, tmp, s15, meanwhile=None):
    """15a (module docstring): the SLO plane in a broker in this process,
    tracing off, strict shares; ``meanwhile()`` runs while the tenants warm
    up (15b's set-up).  Returns K1's launches in 15a's broker (the
    in-process serving of ``meanwhile()`` counted apart)."""
    import threading

    from vtpu_torch.metricsd import backend as mbackend
    from vtpu_torch.metricsd import server as msrv
    from vtpu_torch.ops import flash_attention as fa
    from vtpu_torch.runtime import server as rs
    from vtpu_torch.runtime import slo as slo_mod
    from vtpu_torch.tools import metrics_server as tms
    from vtpu_torch.tools import vtpu_smi as tsmi
    from vtpu_torch.utils import envspec

    tmp = os.path.join(tmp, "p15a")
    os.makedirs(tmp)
    sock, jdir = os.path.join(tmp, "b.sock"), os.path.join(tmp, "j")
    names = ("p15a", "p15b")
    fa.flash_attention.route_launches = dict.fromkeys(fa.ROUTES, 0)
    os.environ.pop("VTPU_TRACE", None)
    os.environ.pop("VTPU_SLO", None)
    srv = rs.make_server(sock, 0, 0, work_conserving=False, journal_dir=jdir,
                         device=s15["device"])
    th = threading.Thread(target=srv.serve_forever, daemon=True,
                          kwargs={"poll_interval": 0.1})
    th.start()
    srv2 = th2 = None
    rows = []
    plane = srv.state.slo
    check(plane.enabled and not srv.state.flight.enabled,
          "15a wants the plane on (VTPU_SLO's default) and tracing off")
    stage = plane.stage_batch

    def staged(st, weights, n):
        rows.append({k: list(v) for k, v in st.items()})
        return stage(st, weights, n)

    plane.stage_batch = staged
    # Each batch's split, as the metering thread makes it.
    batches = []
    split, retire = slo_mod.split_batch_window, rs.DeviceScheduler.\
        _retire_phases

    def spy_split(t_first, t_obs, weights):
        out = split(t_first, t_obs, weights)
        batches[-1].update(t_first=t_first, t_obs=t_obs, readies=out)
        return out

    def spy_retire(self, batch, busys, event, t_obs, traced):
        batches.append({"names": [it.tenant.name for it, *_ in batch],
                        "t0s": [t0 for _, t0, _, _ in batch],
                        "busys": list(busys)})
        return retire(self, batch, busys, event, t_obs, traced)

    slo_mod.split_batch_window = spy_split
    rs.DeviceScheduler._retire_phases = spy_retire
    go = os.path.join(tmp, "go")
    tenants = p15_tenants(tmp, go, sock, names, s15)
    admin = sock + ".admin"

    def row(name):
        return rs.collect_stats(srv.state)[name]

    try:
        t_phase = time.monotonic()
        if meanwhile is not None:
            meanwhile()
        t_meanwhile = time.monotonic() - t_phase
        for p, err in tenants:
            tenant_line(p, err, "READY", timeout=300)
        t_ready = time.monotonic() - t_phase
        # The tenants have only run their init programs: what K1 counted
        # so far is the in-process serving of ``meanwhile()``.
        ref_launches = dict(fa.flash_attention.route_launches)
        fa.flash_attention.route_launches = dict.fromkeys(fa.ROUTES, 0)
        open(go, "w").close()
        time.sleep(1.0)
        b0 = {n: row(n)["busy_us"] for n in names}
        t0 = time.monotonic()
        time.sleep(P15_SHARE_S)
        b1 = {n: row(n)["busy_us"] for n in names}
        pair_s = time.monotonic() - t0
        shares = {n: (b1[n] - b0[n]) / 1e6 / pair_s for n in names}
        open(f"{go}.stop.p15b", "w").close()
        tenant_line(*tenants[1], "DONE")
        booked_b = row("p15b")["busy_us"]  # every batch of p15b metered
        # The tenant alone, unmetered, with the plane on and off in turns
        # (VTPU_SLO=0's state: every hot-path check reads ``enabled``).
        tsmi.request(admin, {"kind": "resize", "tenant": "p15a",
                             "core_limit": 0})
        time.sleep(0.5)
        rates = {True: [], False: []}
        for on in P15_TURNS:
            plane.enabled = on
            time.sleep(0.2)
            e0, t0 = row("p15a")["executions"], time.monotonic()
            time.sleep(P15_COST_S)
            rates[on].append((row("p15a")["executions"] - e0)
                             / (time.monotonic() - t0))
        plane.enabled = True
        open(f"{go}.stop.p15a", "w").close()
        tenant_line(*tenants[0], "DONE")
        launches = dict(fa.flash_attention.route_launches)
        slo_mod.split_batch_window, rs.DeviceScheduler._retire_phases = (
            split, retire)
        # Each batch's split by billing, and p15b's charges (every batch of
        # it retired with the plane on) against what its row booked.
        disorder, worst_split, early = split_faults(batches)
        n_split = sum(len(b["names"]) for b in batches)
        check(batches and not disorder and worst_split <= P15_SPLIT_S,
              f"{disorder} of {len(batches)} batches' ready times out of "
              f"order or outside their window; worst ready time "
              f"{worst_split} s from its billed share")
        billed_b = [x for b in batches for n_, x in zip(b["names"],
                                                         b["busys"])
                    if n_ == "p15b"]
        check(abs(sum(billed_b) - booked_b) <= len(billed_b),
              f"p15b's split weights sum to {sum(billed_b)} us, its row "
              f"booked {booked_b} us")
        # Every retired item's phases against its total.
        worst, n_rows = 0.0, {}
        for st in rows:
            for name, flat in st.items():
                q, b, d, tot, _s = slo_mod.SloPlane._phase_cols(flat)
                worst = max(worst, float(np.abs(q + b + d - tot).max()))
                n_rows[name] = n_rows.get(name, 0) + len(tot)
        check(worst <= P15_PARTITION_US,
              f"an item's phases miss its total by {worst} us")
        rep = tsmi.request(admin, {"kind": "slo"})
        check(rep["enabled"] and set(rep["tenants"]) == set(names)
              and set(rep["matrix"]) == set(names),
              f"the admin SLO reply lacks a tenant: {sorted(rep['tenants'])}")
        for name, body in rep["tenants"].items():
            blamed = sum(body["blame"].values())
            check(abs(blamed - body["wait_us_total"]) <= 1.0,
                  f"{name}'s blame row sums to {blamed} us, its wait "
                  f"{body['wait_us_total']} us")
        # The views, against the verb.
        _, out = stdout_of(tsmi.main, ["top", "--once", "--json", "--broker",
                                       sock])
        top = {r["tenant"]: r for r in json.loads(out)["rows"]}
        _, text = stdout_of(tsmi.main, ["top", "--once", "--broker", sock])
        prom = tms.broker_prometheus(
            tms.MetricsState(None, [], brokers=[sock]).collect_brokers())
        views = {}
        for name, body in rep["tenants"].items():
            ph = body["phases"]["e2e"]
            check(top[name]["p99_e2e_us"] == ph["p99_us"]
                  and top[name]["p50_e2e_us"] == ph["p50_us"],
                  f"vtpu-smi top's {name} row {top[name]} disagrees with "
                  f"the SLO verb's {ph}")
            check(name in text, f"vtpu-smi top shows no {name}")
            got = re.findall(r'vtpu_tenant_latency_us_count\{broker="b.sock",'
                             rf'tenant="{name}",chip="0"\}} (\d+)', prom)
            buckets = re.findall(r'vtpu_tenant_latency_us_bucket\{broker='
                                 rf'"b.sock",tenant="{name}",', prom)
            check(got == [str(ph["count"])] and len(buckets) > 1,
                  f"the exporter's {name} histogram ({got}, {len(buckets)} "
                  f"buckets) disagrees with the verb's count {ph['count']}")
            be = mbackend.RegionBackend(
                region_path=os.path.join(tmp, "none"),
                quota=envspec.quota_from_env({}), broker_socket=sock,
                tenant=name)
            server, _, port = msrv.make_server(0, be)
            try:
                m = tsmi.metricsd_view(f"127.0.0.1:{port}")["metrics"]
            finally:
                server.stop(grace=0)
            p99 = m[msrv.METRIC_SLO_P99]
            check(p99 and all(v == ph["p99_us"] for v in p99.values()),
                  f"metricsd's {name} e2e p99 {p99} != the verb's "
                  f"{ph['p99_us']}")
            views[name] = {"count": ph["count"], "p50_us": ph["p50_us"],
                           "p99_us": ph["p99_us"],
                           "attainment": m[msrv.METRIC_SLO_ATTAINMENT]}
        # HANDOVER: the snapshot carries the rows; a successor restores
        # them before the tenants return, and the resume adds nothing.
        pre = {n: b["phases"]["e2e"]["count"]
               for n, b in rep["tenants"].items()}
        t_h = time.monotonic()
        r = tsmi.request(admin, {"kind": "handover"}, timeout=90.0)
        check(r.get("ok"), f"HANDOVER: {r}")
        th.join(timeout=30)
        srv.server_close()
        srv2 = rs.make_server(sock, 0, 0, work_conserving=False,
                              journal_dir=jdir, device=s15["device"])
        th2 = threading.Thread(target=srv2.serve_forever, daemon=True,
                               kwargs={"poll_interval": 0.1})
        th2.start()
        rep2 = srv2.state.slo_report(admin=True)["tenants"]
        restored = {n: (b["phases"]["e2e"]["count"], b["restored_count"])
                    for n, b in rep2.items()}
        check(restored == {n: (c, c) for n, c in pre.items()},
              f"the successor restored {restored}, the broker had {pre}")
        open(go + ".resume", "w").close()
        res = [tenant_result(p, err, timeout=300) for p, err in tenants]
        handover_s = time.monotonic() - t_h
        for name, got in zip(names, res):
            check(got["scoped"] == [name] and not got["scoped_matrix"],
                  f"{name}'s SLO reply shows {got['scoped']}")
            check(set(got["own"]) == {name}
                  and got["own"][name]["phases"]
                  == rep["tenants"][name]["phases"],
                  f"{name}'s own row disagrees with the admin reply")
            after = got["after"][name]["phases"]["e2e"]["count"]
            check(got["epochs"][0] != got["epochs"][1] and after == pre[name],
                  f"{name} after the resume: {after} requests (before "
                  f"{pre[name]}), epochs {got['epochs']}")
            check(not got["cuda_initialized"], "a tenant initialised CUDA")
        steps = sum(r["steps"] for r in res)
        if s15["device"] != "cpu":
            want = steps * p13_config(s15["bench"]).n_layers
            check(launches.get("sm90") == want and not launches.get("wmma"),
                  f"15a's broker launched K1 {launches}, its tenants ran "
                  f"{steps} steps: want {want} sm90")
        wait_for(lambda: broker_ledger(srv2.state) == 0 or None,
                 "15a's ledger to read 0", 30)
        say(f"15a the plane, {s15['bench']} b={s15['bench_shape'][0]} "
            f"s={s15['bench_shape'][1]} in chains of {BROKER_CHAIN}, two "
            f"tenants at {P15_CORE}% strict for {pair_s:.1f} s: booked "
            + ", ".join(f"{n} {shares[n]:.3f}" for n in names)
            + f" of the window; {sum(n_rows.values())} items staged "
            f"({json.dumps(n_rows)}), worst partition error {worst:.3g} us; "
            f"blame rows " + ", ".join(
                f"{n} {json.dumps(b['blame'])} of {b['wait_us_total']} us"
                for n, b in rep["tenants"].items())
            + f"; Jain {rep['fairness']['jain']}")
        say(f"15a {len(batches)} batches of {n_split} items split by "
            f"billing: worst ready time {worst_split:.3g} s from its share, "
            f"{early} items ready (by the split) before their own dispatch; "
            f"p15b billed {sum(billed_b):.1f} us in {len(billed_b)} items, "
            f"booked {booked_b} us")
        say(f"15a views agree with the verb: {json.dumps(views)}")
        on = [round(x, 3) for x in rates[True]]
        off = [round(x, 3) for x in rates[False]]
        say(f"15a p15a alone, unmetered, {P15_COST_S:.0f} s windows in turns: "
            f"plane on {on} steps/s (mean {statistics.mean(on):.3f}), off "
            f"{off} (mean {statistics.mean(off):.3f})")
        say(f"15a HANDOVER: restored {json.dumps(restored)} before the "
            f"tenants returned, the same after their resume; handover and "
            f"resume {handover_s:.1f} s; tenants ready after {t_ready:.1f} "
            f"s (15b's set-up {t_meanwhile:.1f} s of it; each tenant's init "
            f"program and compile: " + ", ".join(
                f"{n} {r['setup_s']['weights']:.1f} s and "
                f"{r['setup_s']['compile']:.1f} s" for n, r in zip(names, res))
            + f"); K1 launches in the broker {json.dumps(launches)} for "
            f"{steps} steps (in-process serving before: "
            f"{json.dumps(ref_launches)}); 15a took "
            f"{time.monotonic() - t_phase:.1f} s")
    finally:
        slo_mod.split_batch_window, rs.DeviceScheduler._retire_phases = (
            split, retire)
        for p, err in tenants:
            if p.poll() is None:
                p.kill()
                p.wait()
            err.close()
        for s_, t_ in ((srv2, th2), (srv, th)):
            if s_ is not None:
                s_.shutdown()
                s_.server_close()
                t_.join(timeout=10)
    return launches


def repl_followers(sock):
    """The primary's followers (REPL_SYNC's status on its admin socket)."""
    from vtpu_torch.tools.vtpu_smi import request

    return request(sock + ".admin", {"kind": "repl_sync", "status": True},
                   5.0)["replication"]["followers"]


def successor_stats(sock, old_epoch):
    """STATS of a broker on ``sock`` whose epoch is not ``old_epoch``, or
    None (nothing answers, or the old broker still does)."""
    from vtpu_torch.tools.vtpu_smi import request

    try:
        st = request(sock, {"kind": "stats"}, 1.0)
    except OSError:
        return None
    return st if st["journal"]["epoch"] != old_epoch else None


def prepare_failover(torch, tmp, s15, fo):
    """15b's set-up, which runs while 15a's tenants warm up, into ``fo``:
    the weights drawn on the card and saved; a primary broker and a
    standby process, and a second pair without tenants for the stale
    primary; in-process serving's tokens; the tenant, which connects once
    the first primary's standby follows the stream, then PUTs, compiles
    and serves to its kill point.  ``fo["procs"]`` and ``fo["tenant"]``
    are the caller's to stop, whatever happens here."""
    from vtpu_torch import entry
    from vtpu_torch.models import transformer as tr

    s13 = dict(s15)
    fo.update(s13=s13, card=s13["device"] != "cpu", t0=time.monotonic())
    cfg = p13_config(s13["cfg"], s13.get("layers"))
    shape = tuple(s13["shape"])
    fo["cfg"], fo["wbytes"] = cfg, tr.state_bytes(cfg)
    tmp = fo["tmp"] = os.path.join(tmp, "p15b")
    os.makedirs(tmp)
    # The primaries' journals and the standbys' mirrors, side by side.
    home, fo["where"] = journal_home(tmp, 2 * fo["wbytes"])
    fo["home"] = s13["wdir"] = home
    drawn, tree = drawn_weights(torch, cfg, P13_SEED, s13["device"])
    torch.save(tree, os.path.join(home, "p13_weights.pt"))
    del drawn
    fo["sock"] = os.path.join(tmp, "p15.sock")
    fo["fsock"] = os.path.join(tmp, "p15f.sock")
    pairs = (("primary", "standby", fo["sock"]),
             ("fprimary", "fstandby", fo["fsock"]))
    for prim, _, sock in pairs:
        fo[prim] = Broker(f"p15-{prim}", sock, os.path.join(home, prim),
                          tmp, s13, os.path.join(tmp, f"lease-{prim}.json"))
        fo["procs"].append(fo[prim])
    # The tenant starts too; it connects once its start file exists.
    fo["go"] = os.path.join(tmp, "p15b.go")
    s13["start"] = fo["go"] + ".start"
    fo["tenant"] = p13_tenant(tmp, fo["go"], fo["sock"], "crash", s13)
    # In-process serving's tokens while the processes start.
    fo["ref"] = entry.serve(cfg, *shape, steps=s13["steps"],
                            device=s13["device"], weights=tree,
                            prompt=p13_prompt(cfg, shape))["tokens"]
    del tree
    gc.collect()
    if fo["card"]:
        torch.cuda.empty_cache()
    fo["prep_s"] = time.monotonic() - fo["t0"]
    # Each standby starts once its primary is bound: one that finds no
    # primary takes the socket over (vtpu's rule).
    for prim, stby, sock in pairs:
        bound = fo[prim].bound()
        fo.setdefault("bound_a", bound)
        jdir_s = os.path.join(home, stby)
        fo[stby] = Broker(f"p15-{stby}", sock, jdir_s, tmp, s13,
                          os.path.join(tmp, f"lease-{prim}.json"),
                          module="vtpu_torch.runtime.replication",
                          args=["--journal-dir", jdir_s])
        fo["procs"].append(fo[stby])
    wait_for(lambda: repl_followers(fo["sock"]), "the standby to follow",
             120)
    open(s13["start"], "w").close()
    fo["set_up_s"] = time.monotonic() - fo["t0"]


def stale_primary(fo):
    """15b's fence, on the pair without tenants: the primary is stopped
    (SIGSTOP) with an admin connection open, its standby takes over once
    the stream's heartbeats stop, and the primary, resumed (SIGCONT),
    must refuse a journaled verb.  Returns (seconds from the stop to a
    bound successor, the takeover's split, the stale primary's reply)."""
    import signal

    from vtpu_torch.runtime import protocol as P

    f, fs, sock = fo["fprimary"], fo["fstandby"], fo["fsock"]
    f.bound()
    wait_for(lambda: repl_followers(sock), "the second standby to follow",
             120)
    old_epoch = f.stats()["journal"]["epoch"]
    probe = socketmod.socket(socketmod.AF_UNIX, socketmod.SOCK_STREAM)
    probe.settimeout(30.0)
    probe.connect(sock + ".admin")
    os.kill(f.p.pid, signal.SIGSTOP)
    t_stop = time.monotonic()
    wait_for(lambda: successor_stats(sock, old_epoch),
             "the second standby's takeover", 120)
    took_s = time.monotonic() - t_stop
    os.kill(f.p.pid, signal.SIGCONT)
    P.send_msg(probe, {"kind": "suspend", "tenant": "p15-stale-probe"})
    stale = P.recv_msg(probe)
    probe.close()
    check(not stale.get("ok") and "fenced" in stale.get("error", ""),
          f"the stale primary acked a journaled verb: {stale}")
    f.stop()
    split = fs.stats()["replication"]["takeover"]
    fs.shutdown()
    return took_s, split, stale


def run_failover(torch, fo, respawn):
    """15b (module docstring): the crash-resume cell of 13a with a hot
    standby, from ``prepare_failover``'s state (a CPU rehearsal leaves
    out the checks only a card meets)."""
    from vtpu_torch.tools.vtpu_smi import request

    s13, cfg, wbytes, tmp = fo["s13"], fo["cfg"], fo["wbytes"], fo["tmp"]
    a, sb, sock, ref = fo["primary"], fo["standby"], fo["sock"], fo["ref"]
    steps = s13["steps"]
    t_run = time.monotonic()
    # The stale primary's check runs while the tenant PUTs and compiles.
    stop_s, stop_split, stale = stale_primary(fo)
    tenant = fo["tenant"]
    tenant_line(*tenant, "KILLPOINT")
    t_kill = time.monotonic()
    wait_for(lambda: (a.row("p13") or {}).get("cost_ema_us"),
             "the tenant's cost EMA")
    caught = wait_for(lambda: [f for f in repl_followers(sock)
                               if f["lag_records"] == 0 and not f["dropped"]],
                      "the standby to catch up", 60)
    repl = request(sock + ".admin", {"kind": "repl_sync", "status": True}
                   )["replication"]
    old_epoch = a.stats()["journal"]["epoch"]
    a.stop()  # SIGKILL, the third chain in flight
    t_stop = time.monotonic()
    st = wait_for(lambda: successor_stats(sock, old_epoch),
                  "the standby's takeover", 120)
    took_s = time.monotonic() - t_stop
    rec = st["tenants"].get("p13")
    check(rec is not None and rec["recovered"]
          and rec["used_bytes"] == wbytes,
          f"the successor's row before the tenant returned: {rec} (want "
          f"{wbytes} B recovered)")
    gen = st["replication"]["fence_generation"]
    check(gen > repl["fence_generation"],
          f"the killed primary's epoch is not fenced: generation {gen} "
          f"after the takeover, {repl['fence_generation']} before")
    open(fo["go"], "w").close()
    res = tenant_result(*tenant)
    got = torch.from_numpy(np.load(os.path.join(tmp, "p13_tokens.npy")))
    same = int((got == ref).sum())
    check(same >= TOKEN_AGREEMENT * ref.numel(),
          f"tokens after step {steps} agree at {same} of {ref.numel()} "
          f"positions")
    check(res["resumes"] and all(r["resumed"] for r in res["resumes"]),
          f"resumes {res['resumes']}")
    check(not res["cuda_initialized"], "the tenant initialised CUDA")
    wait_for(lambda: region_ledger(sock + ".shr") == 0 or None,
             "the successor's ledger to read 0", 30)
    st = sb.stats()
    split = st["replication"]["takeover"]
    jc = st["journal"]
    sb.shutdown()
    ran = steps - res["resumes"][-1]["at_step"]
    l_s = sb.launches()
    if fo["card"]:
        check(l_s.get("sm90") == ran * cfg.n_layers and not l_s.get("wmma"),
              f"the successor's K1 launches {l_s} != {ran} steps x "
              f"{cfg.n_layers} sm90")
    with open(sb.errpath) as f:
        warm = re.findall(r"imported in ([0-9.]+) s; CUDA initialised: "
                          r"(\w+)", f.read())
    check(warm and warm[0][1] == "False",
          f"the standby initialised CUDA before the takeover: {warm}")
    ct, t_lost = res["chain_times"], res["resumes"][0]["t"]
    last = max(t for _, t in ct if t <= t_lost)
    first = min(t for _, t in ct if t > t_lost)
    say(f"15b {s13['cfg']} (dim {cfg.dim}, depth {cfg.n_layers}), {steps} "
        f"steps in chains of {P13_CHAIN}, killed after {s13['kill_at']}; "
        f"journals and mirrors in {fo['where']}; weights {wbytes} B; drawing "
        f"them, starting the primaries and the tenant and serving in process "
        f"{fo['prep_s']:.1f} s, during 15a (the first primary bound within "
        f"{fo['bound_a']:.2f} s of its start, its standby following and the "
        f"tenant released {fo['set_up_s']:.1f} s into 15b's set-up); the "
        f"standby warmed torch and the broker in {float(warm[0][0]):.2f} s "
        f"without CUDA; the tenant's PUT {res['setup_s']['weights']:.2f} s, "
        f"compile {res['setup_s']['compile']:.2f} s; stream at the kill: seq "
        f"{repl['seq']}, follower lag {caught[0]['lag_records']} records "
        f"{caught[0]['lag_bytes']} B (queue cap VTPU_REPL_BUFFER_MB "
        f"{os.environ.get('VTPU_REPL_BUFFER_MB', 'default 64')}); streamed "
        f"{split['stream_bytes']} B of records and {split['blob_bytes']} B "
        f"of blobs")
    say(f"15b takeover {took_s:.2f} s from kill -9 to a bound successor "
        f"(confirm {split['confirm_s']:.3f} s, fence {split['fence_s']:.4f} "
        f"s, CUDA claim and boot {split['claim_s']:.3f} s); restore "
        f"{jc['restore_s_last']:.3f} s, program load {jc['load_s_last']:.3f} "
        f"s, first chain {first - res['resumes'][-1]['t']:.3f} s after the "
        f"resume; blackout {first - t_stop:.2f} s from the kill -9 to the "
        f"first chain answered after ({first - last:.2f} s from the last "
        f"answered before, the wait at the kill point in it); 13a's respawn "
        f"after kill -9: bound "
        f"{respawn['bound_s']:.2f} s + resume {respawn['resume_s']:.2f} s; "
        f"fence generation {repl['fence_generation']} -> {gen}")
    say(f"15b stale primary (the pair without tenants): SIGSTOP to a bound "
        f"successor {stop_s:.2f} s (the stream's 2 s heartbeat timeout, "
        f"confirm {stop_split['confirm_s']:.3f} s, fence "
        f"{stop_split['fence_s']:.4f} s, claim and boot "
        f"{stop_split['claim_s']:.3f} s); resumed, its SUSPEND answered "
        f"{stale.get('code')}")
    say(f"15b tokens after step {steps} equal at {same} of {ref.numel()}; "
        f"successor's launches {json.dumps(l_s)} ({ran} steps); from the "
        f"kill point to the end {time.monotonic() - t_kill:.1f} s; 15b took "
        f"{time.monotonic() - t_run:.1f} s after 15a (its set-up "
        f"{fo['set_up_s']:.1f} s ran while 15a's tenants warmed up)")
    return l_s


def phase_standby(torch, tmp, direct, respawn, s15=None):
    """Phase 15: 15a, with 15b's set-up run while 15a's tenants warm up,
    then 15b; K1's launches in 15a's broker and 15b's successor.
    ``s15``: P15_CARD, or a rehearsal's settings as phase 13 takes them."""
    import signal

    s15 = dict(P15_CARD if s15 is None else s15)
    fo = {"procs": []}

    def meanwhile():
        prepare_failover(torch, tmp, s15, fo)

    try:
        a = phase_slo(torch, tmp, s15, meanwhile)
        b = run_failover(torch, fo, respawn)
    finally:
        tenant = fo.get("tenant")
        if tenant is not None:
            p, err = tenant
            if p.poll() is None:
                p.kill()
                p.wait()
            err.close()
        for b_ in fo["procs"]:
            if b_.p.poll() is None:
                try:
                    os.kill(b_.p.pid, signal.SIGCONT)
                except OSError:
                    pass
            b_.stop()
        if fo.get("home") not in (None, fo.get("tmp")):
            import shutil
            shutil.rmtree(fo["home"], ignore_errors=True)
    return {r: a.get(r, 0) + b.get(r, 0) for r in set(a) | set(b)}


def child_main(args):
    """``--child serve`` (phase 6), ``--child metered <go file>`` (phase
    7), ``--child granted <go file>`` (phase 8), ``--child train`` or
    ``--child train_parity`` (phase 9), ``--child pod <go file> <report
    file>`` or ``--child pyshim`` (phase 10), ``--child viewpod <dir>
    <name>`` or ``--child nvmlutil`` (phase 11), ``--child brokered <go
    file> <mode> <socket> <dir>`` (phase 12), ``--child p13 <go file>
    <socket> crash|bench <settings>`` (phase 13), ``--child p14 ...`` or
    ``--child p14probe <op>`` (phase 14), ``--child p15 <go file> <socket>
    <name> <neighbour>`` (phase 15): one tenant or probe; prints its
    RESULT line."""
    import torch

    torch_maps = libcuda_maps()
    if args[0] not in ("pod", "pyshim", "viewpod"):  # the pod's shim
        sys.path.insert(0, REPO)
    try:
        if args[0] == "pod":
            res = pod_child(torch, args[1], args[2])
        elif args[0] == "viewpod":
            res = view_pod_child(torch, args[1], args[2])
        elif args[0] == "nvmlutil":
            res = nvml_util_child()
        elif args[0] == "pyshim":
            res = pyshim_child(torch)
        elif args[0] == "serve":
            res = interposed_serve_child(torch)
        elif args[0] == "granted":
            res = granted_child(torch, args[1])
        elif args[0] == "train":
            res = train_child(torch)
        elif args[0] == "train_parity":
            res = train_parity_child(torch)
        elif args[0] == "brokered":
            res = brokered_child(torch, torch_maps, *args[1:])
        elif args[0] == "p13":
            res = p13_child(torch, *args[1:4], json.loads(args[4]))
        elif args[0] == "p15":
            res = p15_child(torch, *args[1:5], json.loads(args[5]))
        elif args[0] == "p14":
            res = p14_child(torch, *args[1:5])
        elif args[0] == "p14probe":
            res = probe_child(torch, args[1])
        else:
            res = metered_child(torch, args[1])
    except Failed as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print("RESULT " + json.dumps(res), flush=True)
    return 0


def main():
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA card is available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import vtpu_torch.entry  # noqa: F401
    except ImportError as e:
        print(f"FAIL: the port is not importable here: {e}", file=sys.stderr)
        return 1
    def phase(n, fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        say(f"phase {n} took {time.monotonic() - t0:.1f} s")
        return out

    try:
        phase(1, phase_device, torch)
        timed = phase(2, phase_kernel, torch)
        with tempfile.TemporaryDirectory() as tmp:
            launches, direct = phase("3-4", phase_serve, torch, tmp)
            phase(5, phase_tenants, tmp)
            phase(6, phase_interposed, torch, tmp, direct)
            phase(7, phase_metered, tmp)
            phase(8, phase_plugin, torch, tmp)
            phase(9, phase_train, torch, tmp)
            pods = phase(10, phase_pods, torch, tmp)
            phase(11, phase_views, torch, tmp, pods["host"],
                  [r["steps_per_s"] for r in pods["tenants"]])
            brokered = phase(12, phase_broker, torch, tmp)
            durable = phase(13, phase_durability, torch, tmp, direct)
            laned = phase(14, phase_fastlane, torch, tmp, direct)
            standby = phase(15, phase_standby, torch, tmp, direct,
                            durable["respawn"])
    except Failed as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    from vtpu_torch.ops.flash_attention import ROUTES
    say(json.dumps({"kernels": [
        {"name": lib, "route": "cuda", "source": f"{CSRC}/{lib}.cu",
         "replaces": KERNEL_REPLACES, "launches": launches[route],
         "brokered_launches": brokered[route],
         "phase13_launches": durable[route],
         "phase14_launches": laned[route],
         "phase15_launches": standby.get(route, 0),
         "shape": {"bh": 64, "s": SERVE_S, "d": 128, "causal": True},
         **timed[SERVE_S][route]}
        for route, (lib, _symbol) in ROUTES.items()]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child_main(sys.argv[2:]))
    sys.exit(main())
