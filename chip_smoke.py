#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's native libraries from the sources in this checkout,
then runs five phases, each of which asserts; any failure exits non-zero
and prints no result line.

1. Device: the card's name and power limit, the versions, the build.
   Fails if ptxas reports a spill in the Hopper attention kernel.
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
   config on one region at once.

The line before the last is one JSON object with each kernel's numbers;
the last is ``{"ok": true, "device": {...}}``.
"""

import dataclasses
import gc
import json
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
        # time of the kernels it launched as well.
        if e.device_type != torch.autograd.DeviceType.CUDA:
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
    tokens = out["tokens"]
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
    return launches


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
            launches = phase_serve(torch, tmp)
            phase_tenants(tmp)
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
    sys.exit(main())
