"""The ('dp','tp') device mesh for the transformer's sharded training
step, and the process group it lives in.

The port of ``vtpu.parallel.mesh``.  JAX sees every local device from one
process; PyTorch runs one process per device, joined in a process group
(gloo on the CPU, NCCL on CUDA), and a ``DeviceMesh`` lays the group's
ranks out as [dp, tp].  A PartitionSpec becomes one DTensor placement per
mesh axis: ``P(None, "tp")`` over ("dp", "tp") is ``(Replicate(),
Shard(1))``.

- ``mesh_shape(n, tp)`` is ``make_mesh``'s shape rule alone;
- ``make_mesh(n, tp, device_type)`` the mesh over the first n ranks;
- ``placements(*spec)``, ``shard(mesh, *spec)`` and ``replicate(mesh)``
  the placement helpers;
- ``run_group(n, fn, args, device_type)`` starts n worker processes in one
  group, runs ``fn(*args)`` in each and returns their results.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.placement_types import Placement

AXES = ("dp", "tp")
# Seconds a process group of run_group may take from spawn to its last
# result, imports included (about 20 s for 8 gloo processes on an idle
# 8-core machine); a hung collective fails the call instead of hanging it.
GROUP_TIMEOUT_S = 300.0


def mesh_shape(n: int, tp: Optional[int] = None) -> Tuple[int, int]:
    """(dp, tp) of an n-device mesh.  ``tp`` defaults to the largest of
    8, 4 and 2 that divides n (1 if none does), as in ``vtpu``."""
    if tp is None:
        tp = next((c for c in (8, 4, 2) if n % c == 0), 1)
    if tp <= 0 or n % tp != 0:
        raise ValueError(f"{n} devices not divisible by tp={tp}")
    return n // tp, tp


def make_mesh(n_devices: Optional[int] = None, tp: Optional[int] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A ('dp','tp') mesh over the first ``n_devices`` ranks of the
    default process group (all of them by default), tp adjacent."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group with one rank "
                           "per device (see run_group)")
    world = dist.get_world_size()
    n = n_devices or world
    if n > world:
        raise ValueError(f"need {n} ranks, the process group has {world}")
    dp, tp = mesh_shape(n, tp)
    return DeviceMesh(device_type, torch.arange(n).view(dp, tp),
                      mesh_dim_names=AXES)


def placements(*spec: Optional[str],
               axes: Sequence[str] = AXES) -> Tuple[Placement, ...]:
    """One placement per mesh axis of ``axes`` for the PartitionSpec
    ``P(*spec)``: ``Shard(i)`` where tensor dim i is split over that
    axis, ``Replicate()`` where no dim is."""
    unknown = [s for s in spec if s is not None and s not in axes]
    if unknown:
        raise ValueError(f"spec {spec} names axes {unknown} not in {axes}")
    return tuple(Shard(spec.index(a)) if a in spec else Replicate()
                 for a in axes)


def shard(mesh: DeviceMesh, *spec: Optional[str]) -> Tuple[Placement, ...]:
    return placements(*spec, axes=mesh.mesh_dim_names)


def replicate(mesh: DeviceMesh) -> Tuple[Placement, ...]:
    return (Replicate(),) * mesh.ndim


# -- process groups -----------------------------------------------------------

def _worker(rank: int, n: int, store: str, device_type: str, fn: Callable,
            args: tuple, results) -> None:
    try:
        backend = "gloo"
        if device_type == "cuda":
            torch.cuda.set_device(rank)
            backend = "nccl"
        dist.init_process_group(
            backend, init_method="file://" + store, rank=rank,
            world_size=n,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, out, None))
    except Exception:  # noqa: BLE001 - reported to the parent
        results.put((rank, None, traceback.format_exc()))


def run_group(n: int, fn: Callable, args: tuple = (),
              device_type: str = "cuda") -> List[Any]:
    """Run ``fn(*args)`` in n new processes that form one process group
    (gloo on the CPU, NCCL on CUDA with rank r on card r); returns each
    rank's result, in rank order.

    ``fn`` must be importable by name (the workers are spawned).  The
    group meets in a FileStore in a fresh temporary directory, so two
    groups never collide.  Raises when a worker fails, dies, or the group
    has not finished within ``GROUP_TIMEOUT_S`` seconds; every worker is
    ended before this returns."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="vtpu-torch-group-")
    procs = [ctx.Process(target=_worker, daemon=True, args=(
        rank, n, os.path.join(tmp, "store"), device_type, fn, args, results))
        for rank in range(n)]
    got = {}
    deadline = time.monotonic() + GROUP_TIMEOUT_S
    try:
        for p in procs:
            p.start()
        while len(got) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"process group of {n} did not finish "
                                   f"within {GROUP_TIMEOUT_S} s (ranks "
                                   f"done: {sorted(got)})")
            try:
                rank, out, err = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [(i, p.exitcode) for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in got]
                if dead:
                    raise RuntimeError(f"workers died (rank, exit code): "
                                       f"{dead}") from None
                continue
            if err is not None:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{err}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(n)]
