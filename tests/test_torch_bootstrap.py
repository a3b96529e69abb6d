"""The port's in-container bootstrap against vtpu's: shim/sitecustomize.py,
pyshim.bootstrap()/install_py_enforcement(), the vtpu-smi view and the
staged shim, each in its own interpreter on the CPU; and the env-flag
registry held to every variable the port reads.

vtpu's Python enforcement patches jax.device_put; the port's patches
torch's own moves.  On the CPU the port guards the CPU
(install_py_enforcement(device="cpu")) and a move is an explicit copy
onto it, so the same sequence of byte counts under the same cap must be
admitted and refused exactly as vtpu's device_put admits and refuses
it, with the same ledger after each."""

import ast
import json
import os
import re
import struct
import subprocess
import sys
import textwrap
import time

import pytest

from test_torch_pyshim import preloaded
from vtpu_torch.ops import _build
from vtpu_torch.plugin.grant import stage_busy_files, stage_shim
from vtpu_torch.shim.core import SharedRegion
from vtpu_torch.utils import envspec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "4paradigm-k8s-device-plugin_tpu_torch")
JSHIM = os.path.join(REPO, "4paradigm-k8s-device-plugin_tpu", "shim")


def clean_env(**kw):
    """This process's environment without any VTPU_* or preload, plus
    ``kw``."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("VTPU_", "LD_", "PYTHON"))}
    env.update(kw)
    return env


def run(code, env, cwd=None, timeout=240):
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, env=env, cwd=cwd,
                       timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return r


def last_json(r):
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """A host lib dir with the shim staged; returns the shim dir."""
    return stage_shim(str(tmp_path_factory.mktemp("host")))["shim"]


# -- sitecustomize ------------------------------------------------------------

PROBE = """
    import json, sys
    torch_at_start = "torch" in sys.modules
    mods = sorted(m for m in sys.modules if m.startswith("vtpu_torch"))
    path = list(sys.path)
    hooks = [type(f).__name__ for f in sys.meta_path]
    import torch
    print(json.dumps({
        "site": getattr(sys.modules.get("sitecustomize"), "__file__", None),
        "torch_at_start": torch_at_start, "mods": mods, "path": path,
        "hooks": hooks, "to_untouched": torch.Tensor.to is
        torch._C.TensorBase.to, "ok": float(torch.ones(4).sum())}))
"""


def test_sitecustomize_noop_without_grant(staged, tmp_path):
    """Without a grant the staged sitecustomize runs and changes nothing:
    sys.path as without it, torch neither imported nor patched, no import
    hook, no enforcement imported; user code runs, as under vtpu's
    (vtpu tests/test_pyshim.py:100)."""
    base = tmp_path / "base"
    base.mkdir()
    got = last_json(run(PROBE, clean_env(PYTHONPATH=staged)))
    bare = last_json(run(PROBE, clean_env(PYTHONPATH=str(base))))
    assert got["site"] == os.path.join(staged, "sitecustomize.py")
    assert got["path"] == [p.replace(str(base), staged) for p in bare["path"]]
    assert got["torch_at_start"] is False and got["to_untouched"] is True
    assert got["hooks"] == bare["hooks"]
    assert got["mods"] == ["vtpu_torch", "vtpu_torch.utils",
                           "vtpu_torch.utils.envspec"]
    assert got["ok"] == 4.0
    jax = run("""
        import jax, numpy as np
        print("ok", jax.device_put(np.ones(4)).sum())
    """, clean_env(PYTHONPATH=JSHIM + os.pathsep + REPO,
                   JAX_PLATFORMS="cpu"))
    assert "ok 4.0" in jax.stdout


@pytest.mark.parametrize("forced", [False, True], ids=["default", "forced"])
def test_sitecustomize_stands_down_under_interposer(staged, tmp_path, forced):
    """With the interposer preloaded (the mock driver as libcuda) and a
    quota, bootstrap names the interposer and nothing of torch is patched
    or charged, VTPU_FORCE_PY_ENFORCEMENT=1 included: vtpu installs beside
    its native path under that flag, the port would charge twice."""
    env = preloaded(tmp_path, {"VTPU_DEVICE_HBM_LIMIT_0": "64Mi"})
    env["PYTHONPATH"] = staged
    if forced:
        env["VTPU_FORCE_PY_ENFORCEMENT"] = "1"
    code = """
        import json, sys
        from vtpu_torch.shim import interposer, pyshim
        import torch
        x = torch.ones(1024).to("cpu", copy=True)
        print(json.dumps({"loaded": interposer.loaded(),
                          "layer": pyshim.bootstrap(),
                          "enforcer": pyshim.enforcer() is not None,
                          "installed": pyshim.install_py_enforcement("cpu"),
                          "to_untouched": torch.Tensor.to is
                          torch._C.TensorBase.to,
                          "pkg": sys.modules["vtpu_torch"].__file__}))
    """
    r = run(code, env)
    assert last_json(r) == {
        "loaded": True, "layer": "interposer", "enforcer": False,
        "installed": False, "to_untouched": True,
        "pkg": os.path.join(staged, "vtpu_torch", "__init__.py")}
    assert ("VTPU_FORCE_PY_ENFORCEMENT ignored" in r.stderr) == forced


def test_sitecustomize_installs_on_torch_import(staged, tmp_path):
    """Without the interposer a grant's quota is installed when the
    process imports torch, not before; the pod-declared PYTHONPATH merge
    is announced and VTPU_EXTRA_PYTHONPATH entries follow the shim's."""
    extra = tmp_path / "extra"
    extra.mkdir()
    env = clean_env(PYTHONPATH=staged + os.pathsep + "/app/lib",
                    VTPU_SHIM_PYTHONPATH=staged, VTPU_PYTHONPATH_MERGED="1",
                    VTPU_EXTRA_PYTHONPATH=str(extra),
                    VTPU_DEVICE_HBM_LIMIT_0="64Mi",
                    VTPU_DEVICE_MEMORY_SHARED_CACHE=str(tmp_path / "r.cache"))
    code = """
        import json, sys
        from vtpu_torch.shim import pyshim
        before = pyshim.enforcer() is not None
        started = "torch" in sys.modules
        import torch
        print(json.dumps({"before": before, "started": started,
                          "after": pyshim.enforcer() is not None,
                          "patched": torch.Tensor.to is not
                          torch._C.TensorBase.to, "path": sys.path}))
    """
    r = run(code, env)
    got = last_json(r)
    assert (got["before"], got["started"], got["after"], got["patched"]) == \
        (False, False, True, True)
    i = got["path"].index(staged)
    assert got["path"][i + 1] == str(extra)
    assert "/app/lib" in got["path"][i:]
    assert "PYTHONPATH merged: kept /app/lib after the vtpu shim" in r.stderr


def test_sitecustomize_starts_metricsd_once(staged, tmp_path):
    """With the grant's VTPU_METRICSD_PORT the staged bootstrap serves the
    pod's metricsd from the first process to bind the port, and a second
    process of the container starts none; without the port the bootstrap
    imports neither metricsd nor grpc."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    grant = dict(PYTHONPATH=staged, VTPU_DEVICE_HBM_LIMIT_0="3Gi",
                 VTPU_DEVICE_MAP="0:GPU-test",
                 VTPU_DEVICE_MEMORY_SHARED_CACHE=str(tmp_path / "r.cache"))
    code = """
        import json, sys, time
        m = sys.modules.get("vtpu_torch.metricsd.server")
        print(json.dumps({"grpc": "grpc" in sys.modules,
                          "served": m is not None and m._started is not None,
                          "port": m._started[2] if m and m._started
                          else None}), flush=True)
        time.sleep(float(sys.argv[1]))
    """
    env = clean_env(VTPU_METRICSD_PORT=str(port), **grant)
    first = subprocess.Popen([sys.executable, "-c", textwrap.dedent(code),
                              "30"], env=env, stdout=subprocess.PIPE,
                             text=True)
    try:
        got = json.loads(first.stdout.readline())
        assert got == {"grpc": True, "served": True, "port": port}
        second = subprocess.run([sys.executable, "-c",
                                 textwrap.dedent(code), "0"], env=env,
                                capture_output=True, text=True, timeout=120)
        assert last_json(second) == {"grpc": True, "served": False,
                                     "port": None}
    finally:
        first.kill()
        first.communicate()
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code), "0"],
                       env=clean_env(**grant), capture_output=True,
                       text=True, timeout=120)
    assert last_json(r) == {"grpc": False, "served": False, "port": None}


# -- the python enforcement, against vtpu's device_put ------------------------

SIZES = [16384, 4 << 20, 512 << 10, 600 << 10, 1000, 100 << 10, 350 << 10]


def test_moves_admitted_as_vtpu_device_put(tmp_path):
    """The same byte counts under a 1 MiB cap: vtpu's device_put of numpy
    arrays and the port's .to copies admit and refuse alike, with equal
    ledgers after each and 0 once all are collected."""
    jax_code = f"""
        import gc, json, jax, numpy as np
        from vtpu.shim import pyshim
        kept, rows = [], []
        region = pyshim.enforcer().region
        for n in {SIZES!r}:
            try:
                kept.append(jax.device_put(np.ones(n, np.uint8)))
                ok = True
            except MemoryError:
                ok = False
            rows.append([ok, region.device_stats(0).used_bytes])
        del kept
        gc.collect()
        rows.append(region.device_stats(0).used_bytes)
        print(json.dumps(rows))
    """
    torch_code = f"""
        import gc, json, numpy as np
        from vtpu_torch.shim import pyshim
        assert pyshim.install_py_enforcement(device="cpu")
        import torch
        enf = pyshim.enforcer()
        kept, rows = [], []
        for n in {SIZES!r}:
            try:
                kept.append(torch.from_numpy(np.ones(n, np.uint8))
                            .to("cpu", copy=True))
                ok = True
            except MemoryError:
                ok = False
            rows.append([ok, enf.ledger()["used_bytes"]])
        del kept
        gc.collect()
        rows.append(enf.ledger()["used_bytes"])
        print(json.dumps(rows))
    """
    quota = {"VTPU_DEVICE_HBM_LIMIT_0": "1Mi"}
    (tmp_path / "j").mkdir()
    jax_rows = last_json(run(jax_code, clean_env(
        PYTHONPATH=JSHIM + os.pathsep + REPO, JAX_PLATFORMS="cpu",
        VTPU_CORE_LIB=_build.build_all(("vtpucore",))["vtpucore"],
        VTPU_DEVICE_MEMORY_SHARED_CACHE=str(tmp_path / "j" / "r.cache"),
        **quota)))
    torch_rows = last_json(run(torch_code, clean_env(
        PYTHONPATH=REPO,
        VTPU_DEVICE_MEMORY_SHARED_CACHE=str(tmp_path / "t.cache"), **quota)))
    assert torch_rows == jax_rows
    assert [ok for ok, _ in jax_rows[:-1]] == [True, False, True, False,
                                               True, True, True]
    assert jax_rows[-1] == 0


def test_module_and_tensor_moves(tmp_path):
    """Module.to keeps its parameters (in place), charges each storage
    once (tied weights too) while it lives, and moves all or nothing;
    casts that name no device, moves that copy nothing and views are not
    charged again."""
    code = """
        import gc, json, torch
        from vtpu_torch.shim import pyshim
        assert pyshim.install_py_enforcement(device="cpu")
        enf = pyshim.enforcer()
        used = lambda: enf.ledger()["used_bytes"]
        out = {}
        m = torch.nn.Sequential(torch.nn.Linear(64, 64),
                                torch.nn.Linear(64, 64))
        m[1].weight = m[0].weight                      # tied
        w = m[0].weight
        m.to("cpu", torch.float64)
        out["module"] = used()
        out["in_place"] = m[0].weight is w and m[1].weight is w
        out["dtype"] = str(w.dtype)
        big = torch.nn.Linear(512, 512)
        try:
            big.to("cpu", torch.float64)
            out["big"] = "admitted"
        except MemoryError:
            out["big"] = str(big.weight.dtype)
        out["after_refusal"] = used()
        # A move frees each old storage as it goes, and the allocator may
        # hand its address to the next new one: all are charged still.
        many = torch.nn.Sequential(*[torch.nn.Linear(16, 16)
                                     for _ in range(12)])
        base = used()
        many.to("cpu", torch.float64)
        out["many"] = used() - base
        del many
        gc.collect()
        x = w.to(torch.float32)                        # a cast: no device
        v = w[:8]
        out["noop"] = [v.to("cpu") is v, w.to("cpu") is w, used()]
        del m, w, v, x     # x's autograd graph holds w
        gc.collect()
        out["released"] = used()
        print(json.dumps(out))
    """
    got = last_json(run(code, clean_env(
        PYTHONPATH=REPO, VTPU_DEVICE_HBM_LIMIT_0="1Mi",
        VTPU_DEVICE_MEMORY_SHARED_CACHE=str(tmp_path / "r.cache"))))
    module = 64 * 64 * 8 + 2 * 64 * 8
    assert got == {"module": module, "in_place": True,
                   "dtype": "torch.float64", "big": "torch.float32",
                   "after_refusal": module, "many": 12 * (16 * 16 + 16) * 8,
                   "noop": [True, True, module], "released": 0}


def test_compiled_callables_gated(tmp_path):
    """torch.compile's callable (called, decorated or a module) is gated:
    its first, compiling call passes free; then 30 calls at a 20 ms floor
    (600 ms of device time) overrun the bucket's 400 ms burst, and a 20%
    FORCE share holds them to about a second, with waits in the gate."""
    code = """
        import json, time, torch
        from vtpu_torch.shim import pyshim
        assert pyshim.install_py_enforcement(device="cpu")
        enf = pyshim.enforcer()
        f = torch.compile(lambda a: a @ a, backend="eager")

        @torch.compile(backend="eager")
        def g(a):
            return a + 1

        m = torch.compile(torch.nn.Linear(8, 8), backend="eager")
        a = torch.ones(8, 8)
        for fn in (f, g, m):
            fn(a)
        first = enf.gate_waits()
        t0 = time.monotonic()
        for _ in range(10):
            for fn in (f, g, m):
                fn(a)
        print(json.dumps({"first": first, "waits": enf.gate_waits(),
                          "elapsed": time.monotonic() - t0,
                          "busy": enf.ledger()["proc_busy_us"],
                          "module": isinstance(m, torch.nn.Module)}))
    """
    got = last_json(run(code, clean_env(
        PYTHONPATH=REPO, VTPU_DEVICE_CORE_LIMIT="20",
        VTPU_CORE_UTILIZATION_POLICY="FORCE", VTPU_MIN_EXEC_COST_US="20000",
        VTPU_DEVICE_MEMORY_SHARED_CACHE=str(tmp_path / "r.cache"))))
    assert got["first"] == 0 and got["waits"] > 0 and got["module"]
    assert got["busy"] > 0
    # (600 ms - 400 ms of burst) / 20% = 1 s.
    assert got["elapsed"] > 0.5, got


# -- vtpu-smi -----------------------------------------------------------------

def smi(script, env, *args):
    r = subprocess.run([sys.executable, script, *args], capture_output=True,
                       text=True, env=env, timeout=120, cwd="/")
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


def test_smi_matches_vtpu(staged, tmp_path):
    """On a region the port made, with only the grant's env: the port's
    vtpu-smi --json gives vtpu's fields and values, and the card's busy
    file beside them (live and busy slots, nothing of whose); the staged
    copy runs with no PYTHONPATH; no grant exits 0 and says so."""
    shr = str(tmp_path / "shr.cache")
    host = str(tmp_path / "host")
    busy, = stage_busy_files(host, ["GPU-test"])
    now = time.monotonic_ns()
    slot = 24 + 8 * envspec.MAX_DEVICES_PER_NODE
    late = now + 600 * 10**9         # heartbeats that stay fresh
    with open(busy, "r+b") as f:     # two live slots, one of them busy,
        for i, (beat, until) in enumerate(((late, late), (late, 0),
                                           (now - 10**10, 0))):   # 1 lapsed
            f.seek(i * slot)
            f.write(struct.pack("=QQiiQ", 7 + i, beat, 1, 0, until))
    with SharedRegion(shr, limits=[2 * 10**9], core_pcts=[40]) as reg:
        reg.register()
        assert reg.mem_acquire(0, 500 * 10**6)
        reg.busy_add(0, 1_500_000)
        env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
               "VTPU_DEVICE_HBM_LIMIT_0": "2G", "VTPU_DEVICE_CORE_LIMIT": "40",
               "VTPU_DEVICE_MAP": "0:GPU-test",
               "VTPU_DEVICE_MEMORY_SHARED_CACHE": shr}
        jout = json.loads(smi(os.path.join(JSHIM, "vtpu_smi_lite.py"), dict(
            env, VTPU_CORE_LIB=_build.build_all(("vtpucore",))["vtpucore"]),
            "--json"))
        tout = json.loads(smi(os.path.join(PORT, "shim", "vtpu_smi_lite.py"),
                              dict(env, VTPU_DEVICE_BUSY_DIR=f"{host}/busy"),
                              "--json"))
        staged_out = json.loads(smi(os.path.join(staged, "vtpu_smi_lite.py"),
                                    env, "--json"))
        table = smi(os.path.join(staged, "vtpu_smi_lite.py"), dict(
            env, VTPU_DEVICE_BUSY_DIR=f"{host}/busy"))
    assert tout.pop("cards") == [{"card": "GPU-test", "live": 2, "busy": 1}]
    assert tout == jout == staged_out
    assert jout["region"][0]["used"] == 500 * 10**6
    assert "vtpu grant" in table and "2 tenant(s) live, 1 busy now" in table
    assert "no vtpu grant" in smi(os.path.join(staged, "vtpu_smi_lite.py"),
                                  {"PATH": env["PATH"]})


# -- the staged shim ----------------------------------------------------------

def test_staged_shim_imports_off_the_repo(staged, tmp_path):
    """With only the staged shim on PYTHONPATH, run outside the source
    tree: every module of the copy imports from it, none from the repo,
    and the region opens through the libvtpucore.so staged beside it."""
    mods = []
    pkg = os.path.join(staged, "vtpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                parts = os.path.relpath(os.path.join(root, f), pkg)[:-3]
                parts = parts.split(os.sep)
                if parts[-1] == "__init__":
                    parts = parts[:-1]
                if parts[-1:] != ["sitecustomize"]:
                    mods.append(".".join(["vtpu_torch"] + parts))
    code = f"""
        import importlib, json, sys
        for name in {sorted(mods)!r}:
            importlib.import_module(name)
        from vtpu_torch.ops import _build
        from vtpu_torch.shim.core import SharedRegion
        region = {str(tmp_path / "r.cache")!r}
        with SharedRegion(region, limits=[1 << 20]) as r:
            limit = r.device_stats(0).limit_bytes
        files = sorted({{m.__file__ for m in sys.modules.values()
                         if getattr(m, "__file__", None)
                         and m.__name__.startswith("vtpu_torch")}})
        print(json.dumps({{"files": files, "limit": limit,
                           "core": _build.library("vtpucore")._name,
                           "repo": [p for p in sys.path
                                    if p.startswith({REPO!r})]}}))
    """
    got = last_json(run(code, clean_env(PYTHONPATH=staged),
                        cwd=str(tmp_path)))
    assert len(got["files"]) >= len(mods) >= 30
    assert all(f.startswith(pkg + os.sep) for f in got["files"])
    assert got["limit"] == 1 << 20 and got["repo"] == []
    assert got["core"] == os.path.join(os.path.dirname(staged),
                                       "libvtpucore.so")


# -- the env-flag registry ----------------------------------------------------

def _module_strings(tree):
    return {n.targets[0].id: n.value.value for n in ast.walk(tree)
            if isinstance(n, ast.Assign) and len(n.targets) == 1
            and isinstance(n.targets[0], ast.Name)
            and isinstance(n.value, ast.Constant)
            and isinstance(n.value.value, str)}


def env_reads(path):
    """(name, line) of each environment read in one source: the first
    argument of ``os.environ.get``/``os.getenv``/config's ``_env``, a
    subscript load of ``os.environ`` and ``"X" in os.environ``, and the
    same on ``env``, the name under which the port passes an environment
    mapping (``os.environ`` by default); a name given by a constant
    resolved through the file's own constants and envspec's.  An
    argument that does not resolve is returned as None."""
    with open(path) as f:
        tree = ast.parse(f.read())
    consts = {**{k: v for k, v in vars(envspec).items()
                 if isinstance(v, str)}, **_module_strings(tree)}
    # config's helper reads the name its callers give it, read there.
    helpers = {id(n) for f in ast.walk(tree)
               if isinstance(f, ast.FunctionDef) and f.name == "_env"
               for n in ast.walk(f)}

    def resolve(node):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        if isinstance(node, ast.Name):
            return consts.get(node.id)
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "envspec":
            return consts.get(node.attr)
        return None

    def chain(node):
        if isinstance(node, ast.Attribute):
            return chain(node.value) + "." + node.attr
        return node.id if isinstance(node, ast.Name) else "?"

    out = []
    for node in ast.walk(tree):
        arg = None
        if isinstance(node, ast.Call) and node.args and (
                chain(node.func) in ("env.get", "os.getenv", "_env")
                or chain(node.func).endswith("environ.get")):
            arg = node.args[0]
        elif isinstance(node, ast.Subscript) and \
                isinstance(node.ctx, ast.Load) and \
                chain(node.value) in ("env", "os.environ"):
            arg = node.slice
        elif isinstance(node, ast.Compare) and \
                any(isinstance(op, ast.In) for op in node.ops) and \
                any(chain(c) in ("env", "os.environ")
                    for c in node.comparators):
            arg = node.left
        if arg is not None and id(node) not in helpers:
            out.append((resolve(arg), node.lineno))
    return out


def test_env_flags_declared():
    """Every variable the port's Python reads from its environment and
    every one native/interposer.cc reads with getenv is in the registry;
    every registered name is read or set somewhere; no TPU-only key."""
    reads = []
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                reads += [(n, f"{os.path.relpath(path, PORT)}:{line}")
                          for n, line in env_reads(path)]
    with open(os.path.join(PORT, "native", "interposer.cc")) as f:
        src = f.read()
    getenvs = re.findall(r"getenv\(([^)]*)\)", src)
    native = re.findall(r'getenv\("([A-Z0-9_]+)"\)', src)
    assert len(native) == len(getenvs) >= 10, getenvs
    reads += [(n, "native/interposer.cc") for n in native]
    bad = [(n, where) for n, where in reads
           if n is None or not envspec.flag_declared(n)]
    assert not bad, bad
    assert len(reads) >= 40
    assert envspec.flag_declared("VTPU_DEVICE_HBM_LIMIT_3")
    assert not envspec.flag_declared("VTPU_DEVICE_HBM_LIMIT_x")
    for key in ("TPU_VISIBLE_CHIPS", "TPU_LIBRARY_PATH", "VTPU_REAL_LIBTPU"):
        assert not envspec.flag_declared(key)
    # Declared and used: read above, set by Allocate, or the interposer's
    # per-ordinal prefix.
    with open(os.path.join(PORT, "plugin", "grant.py")) as f:
        grant_src = f.read()
    used = {n for n, _ in reads}
    for name, scope in envspec.ENV_FLAGS.items():
        const = [k for k, v in vars(envspec).items() if v == name]
        assert name in used or name in grant_src or \
            any(f"envspec.{c}" in grant_src for c in const) or \
            name == envspec.ENV_HBM_LIMIT, (name, scope)
    assert set(envspec.ALL_ENV_VARS) <= set(envspec.ENV_FLAGS)
