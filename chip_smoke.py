#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's native libraries from the sources in this checkout,
then runs nine phases, each of which asserts; any failure exits non-zero
and prints no result line.

1. Device: the card's name and power limit, the versions, the build (the
   CUDA kernels, the region, the interposer and its test programs).
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

The line before the last is one JSON object with each kernel's numbers;
the last is ``{"ok": true, "device": {...}}``.
"""

import dataclasses
import gc
import json
import math
import multiprocessing as mp
import os
import queue
import re
import statistics
import subprocess
import sys
import tempfile
import time

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


def metered_child(torch, go):
    """Phase 7, inside one interposed tenant: serve the bench config, then
    wait for ``go`` and run the greedy loop for METERED_S."""
    from vtpu_torch import entry
    from vtpu_torch.shim import interposer

    check(interposer.loaded(), "the interposer is not in the tenant")
    out = entry.serve("bench", *TENANT_SHAPE, steps=3)
    model, tokens = out["model"], out["tokens"].cuda()
    torch.cuda.synchronize()
    memory = {"charged_bytes": interposer.stats()["charged_bytes"],
              "torch_reserved_bytes": torch.cuda.memory_reserved()}
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


def run_released(envs, mode, tmp, name):
    """One ``--child <mode> <go>`` tenant per environment; each reports
    READY after its warm-up, then all are released together by the go
    file.  Returns their RESULT dicts."""
    go = os.path.join(tmp, f"{name}.go")
    # stderr goes to a file: a pipe nobody reads could fill and stall the
    # tenant, and a tenant that dies early is reported with its traceback.
    errs = [open(os.path.join(tmp, f"{name}.{i}.err"), "w+")
            for i in range(len(envs))]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--child", mode, go], env=env,
                              stdout=subprocess.PIPE, stderr=err, text=True)
             for env, err in zip(envs, errs)]

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


def child_main(args):
    """``--child serve`` (phase 6), ``--child metered <go file>`` (phase
    7), ``--child granted <go file>`` (phase 8), ``--child train`` or
    ``--child train_parity`` (phase 9): one tenant; prints its RESULT
    line."""
    import torch

    sys.path.insert(0, REPO)
    try:
        if args[0] == "serve":
            res = interposed_serve_child(torch)
        elif args[0] == "granted":
            res = granted_child(torch, args[1])
        elif args[0] == "train":
            res = train_child(torch)
        elif args[0] == "train_parity":
            res = train_parity_child(torch)
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
    try:
        phase_device(torch)
        timed = phase_kernel(torch)
        with tempfile.TemporaryDirectory() as tmp:
            launches, direct = phase_serve(torch, tmp)
            phase_tenants(tmp)
            phase_interposed(torch, tmp, direct)
            phase_metered(tmp)
            phase_plugin(torch, tmp)
            phase_train(torch, tmp)
    except Failed as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    from vtpu_torch.ops.flash_attention import ROUTES
    say(json.dumps({"kernels": [
        {"name": lib, "route": "cuda", "source": f"{CSRC}/{lib}.cu",
         "replaces": KERNEL_REPLACES, "launches": launches[route],
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
