"""Builds the port's native libraries from the repo's sources at first use.

Shared libraries with a plain C interface, loaded through ctypes:

- one per CUDA source ``ops/csrc/<name>.cu``, named ``<name>`` and
  compiled by ``nvcc`` for Hopper (``sm_90a``), with every ``.cuh``
  under ``ops/csrc/`` among its inputs;
- ``vtpucore``: the shared accounting region, compiled by ``g++`` from the
  unchanged ``native/vtpucore/vtpu_core.cc`` with the recipe of
  ``native/Makefile``.  The region is the cross-process contract that
  ``vtpu``'s tools read too, so the port never keeps a copy of its source.

Outputs go to ``build/vtpu_torch/`` at the repo root (listed in
``.gitignore``), named by a hash of the sources and the command, so an
edited source rebuilds and an unchanged one is reused.  Each output is
written under a temporary name and ``os.replace``d into place: parallel
processes may build the same library at once without tearing it.  A
failed build raises; nothing is prebuilt or committed.

``build_all()`` starts one compiler per library, all at once, and waits
for them: a cold start costs the slowest build, not the sum.
``KERNELS`` names the CUDA libraries.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(_PKG)
BUILD_DIR = os.path.join(REPO, "build", "vtpu_torch")
CSRC = os.path.join(_PKG, "ops", "csrc")
VTPUCORE_SRC = os.path.join(REPO, "native", "vtpucore")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


KERNELS = tuple(sorted(f[:-3] for f in os.listdir(CSRC)
                     if f.endswith(".cu")))


def _headers() -> List[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(".cuh"))


def _recipe(name: str, out: str) -> List[str]:
    """The compile command for one library, writing to ``out``."""
    if name in KERNELS:
        return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-lineinfo", "-Xptxas", "-v",
                "-shared", "-Xcompiler", "-fPIC", "-o", out,
                os.path.join(CSRC, name + ".cu")]
    if name == "vtpucore":
        return ["g++", "-O2", "-fPIC", "-std=c++17", "-shared", "-pthread",
                "-I" + VTPUCORE_SRC, "-o", out,
                os.path.join(VTPUCORE_SRC, "vtpu_core.cc")]
    raise KeyError(name)


def _inputs(name: str) -> List[str]:
    if name in KERNELS:
        return [os.path.join(CSRC, name + ".cu"), *_headers()]
    return [os.path.join(VTPUCORE_SRC, f) for f in ("vtpu_core.cc",
                                                    "vtpu_core.h")]


def _target(name: str) -> str:
    h = hashlib.sha256()
    for path in _inputs(name):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(_recipe(name, "OUT")[1:]).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start the compiler for ``name`` unless its output exists; returns
    (process, temporary path, target path) or None."""
    target = _target(name)
    if os.path.exists(target):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.Popen(_recipe(name, tmp), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, target = started
    out, _ = proc.communicate()
    with open(target + ".log", "w") as f:
        f.write(out)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"building lib{name} failed "
                           f"(rc={proc.returncode}):\n{out[-4000:]}")
    os.replace(tmp, target)


def build_all(names=(*KERNELS, "vtpucore")) -> Dict[str, str]:
    """Build every library in ``names`` concurrently; returns each
    library's path.  Raises if any build failed, after every compiler
    it started has ended."""
    started, errors = {}, []
    for n in names:
        try:
            started[n] = _start(n)
        except (RuntimeError, OSError) as e:   # no compiler: build none
            errors.append(str(e))
    for n, st in started.items():
        try:
            _finish(n, st)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: _target(n) for n in names}


def build_log(name: str) -> str:
    """The compiler's output from the build that made the current
    library ``name`` (for a kernel library, nvcc's ``-Xptxas -v`` report
    of registers, shared memory and spills); empty when there is none."""
    path = _target(name) + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all((name,))[name]
            lib = _libs[name] = ctypes.CDLL(path)
        return lib
