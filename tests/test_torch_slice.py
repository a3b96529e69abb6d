"""The port's first slice end to end on the CPU: env contract → in-process
enforcer over the shared region → transformer serving greedy steps
(vtpu_torch.entry.serve), held against the JAX greedy loop of bench.py
on the same weights; and the port's import hygiene."""

import dataclasses
import json
import os
import re
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu.models import transformer as jtr
from vtpu_torch import entry
from vtpu_torch.models import transformer as ttr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "4paradigm-k8s-device-plugin_tpu_torch")


def _jax_greedy(params, tokens, cfg, steps):
    """bench.py's _direct_loop step: argmax of the logits, fed back."""
    @jax.jit
    def step_fn(p, t):
        return jnp.argmax(jtr.forward(p, t, cfg), axis=-1).astype(jnp.int32)

    for _ in range(steps):
        tokens = step_fn(params, tokens)
    return np.asarray(tokens)


def test_serve_matches_jax_greedy_loop(tmp_path, monkeypatch):
    """Three greedy steps of the tiny model in f32 under a quota env give
    the JAX loop's token ids exactly (the logits agree to ~1e-5, far
    inside the gaps argmax decides on)."""
    monkeypatch.setenv("VTPU_DEVICE_HBM_LIMIT_0", "64Mi")
    monkeypatch.setenv("VTPU_DEVICE_CORE_LIMIT", "100")
    monkeypatch.setenv("VTPU_DEVICE_MEMORY_SHARED_CACHE",
                       str(tmp_path / "shr.cache"))
    jcfg = dataclasses.replace(jtr.TransformerConfig.tiny(),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(ttr.TransformerConfig.tiny(),
                               dtype=torch.float32)
    params = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 32),
                                               dtype=np.int32)
    want = _jax_greedy(params, jnp.asarray(prompt), jcfg, 3)

    out = entry.serve(tcfg, batch=2, seq=32, steps=3, device="cpu",
                      use_flash=True,
                      weights=jax.tree_util.tree_map(np.asarray, params),
                      prompt=prompt)
    try:
        np.testing.assert_array_equal(out["tokens"].numpy(), want)
        assert out["launches"] == 0           # CPU: the plain version
        ledger = out["ledger"]
        assert ledger["used_bytes"] >= ttr.state_bytes(tcfg)
        assert ledger["limit_bytes"] == 64 * 2**20
        assert ledger["proc_busy_us"] > 0
    finally:
        out["enforcer"].close()


def test_serve_without_quota_env_runs_unenforced(monkeypatch):
    for k in list(os.environ):
        if k.startswith("VTPU_DEVICE_"):
            monkeypatch.delenv(k)
    out = entry.serve("tiny", batch=1, seq=16, steps=2, device="cpu")
    assert out["enforcer"] is None and out["ledger"] is None
    assert out["tokens"].shape == (1, 16)
    assert int(out["tokens"].max()) < 256


def test_entry_forward_on_cpu():
    model, args = entry.entry(device="cpu")
    with torch.inference_mode():
        logits = model(*args)
    assert logits.shape == (2, 32, 256) and logits.dtype == torch.float32
    assert torch.isfinite(logits).all()


def test_serve_ledger_from_region_under_interposer(tmp_path, monkeypatch):
    """A tenant started under the native interposer serves with no
    in-process enforcer, and serve's ledger, read from the region, has
    the keys the enforcer's ledger has."""
    from test_torch_pyshim import preloaded

    code = f"""
        import json, sys
        sys.path.insert(0, {REPO!r})
        from vtpu_torch import entry
        out = entry.serve("tiny", batch=1, seq=16, steps=2, device="cpu")
        print(json.dumps({{"enforcer": out["enforcer"] is not None,
                           "ledger": out["ledger"]}}))
    """
    env = preloaded(tmp_path, {"VTPU_DEVICE_HBM_LIMIT_0": "64Mi"})
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["enforcer"] is False
    ledger = got["ledger"]
    assert ledger["limit_bytes"] == 64 * 2**20

    monkeypatch.setenv("VTPU_DEVICE_HBM_LIMIT_0", "64Mi")
    monkeypatch.setenv("VTPU_DEVICE_MEMORY_SHARED_CACHE",
                       str(tmp_path / "own.cache"))
    out = entry.serve("tiny", batch=1, seq=16, steps=2, device="cpu")
    try:
        assert set(ledger) == set(out["ledger"])
    finally:
        out["enforcer"].close()


def test_cuda_without_card_raises():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        entry.serve("tiny", device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        entry.entry()


def test_import_hygiene():
    """Every module of the port, and chip_smoke.py, import with jax,
    ml_dtypes and vtpu made unimportable, and leave no vtpu module behind; the
    in-container bootstrap's two scripts, imported last with no grant in
    the environment, change nothing: not sys.path, not the import hooks,
    not torch, and they import no module of their own; the port's C++
    sources include nothing of the JAX package's native/ tree but the
    region's header."""
    mods = []
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), PORT)[:-3]
                parts = rel.split(os.sep)
                if parts[-1] == "__init__":
                    parts = parts[:-1]
                mods.append(".".join(["vtpu_torch"] + parts))
    boot = ["vtpu_torch.shim.sitecustomize", "vtpu_torch.shim.vtpu_smi_lite"]
    assert {"vtpu_torch.runtime.slo", "vtpu_torch.runtime.replication"} \
        <= set(mods)
    code = f"""
        import importlib, sys
        sys.path.insert(0, {REPO!r})

        def banned(name):
            return name.split(".")[0] in ("jax", "jaxlib", "vtpu",
                                          "ml_dtypes")

        for name in [m for m in sys.modules if banned(m)]:
            del sys.modules[name]

        class Block:
            def find_spec(self, name, path=None, target=None):
                if banned(name):
                    raise ImportError("port imported " + name)
                return None

        sys.meta_path.insert(0, Block())
        boot = {sorted(boot)!r}
        for name in {sorted(mods)!r} + ["chip_smoke"]:
            if name not in boot:
                importlib.import_module(name)
        import torch
        state = lambda: (list(sys.path), list(sys.meta_path),
                         torch.Tensor.to, torch.Tensor.cuda,
                         torch.nn.Module.to, torch.compile)
        before, known = state(), set(sys.modules)
        for name in boot:
            importlib.import_module(name)
        assert state() == before, "a bootstrap script changed the process"
        assert set(sys.modules) - known == set(boot), set(sys.modules) - known
        left = [m for m in sys.modules if banned(m)]
        assert not left, left
        print("clean", len({sorted(mods)!r}))
    """
    env = {k: v for k, v in os.environ.items() if not k.startswith("VTPU_")}
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=120,
                       cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "clean" in r.stdout
    assert len(mods) >= 19 and {
        "vtpu_torch.shim.interposer", "vtpu_torch.k8s.client",
        "vtpu_torch.plugin.controller", "vtpu_torch.metricsd.server",
        "vtpu_torch.tools.vtpu_smi", "vtpu_torch.tools.tpu_info",
        "vtpu_torch.tools.metrics_server", "vtpu_torch.runtime.protocol",
        "vtpu_torch.runtime.server", "vtpu_torch.runtime.client",
        "vtpu_torch.utils.dtypes", "vtpu_torch.runtime.journal",
        "vtpu_torch.runtime.faults", "vtpu_torch.runtime.timers",
        "vtpu_torch.runtime.trace", "vtpu_torch.runtime.degraded",
        "vtpu_torch.runtime.replication", *boot} <= set(mods)

    native = os.path.join(PORT, "native")
    sources = sorted(os.listdir(native))
    assert {"interposer.cc", "mock_cuda.cc", "interposer_test.cc",
            "abi_check.cc", "cuda_abi.h"} <= set(sources)
    for f in sources:
        with open(os.path.join(native, f)) as fh:
            includes = re.findall(r'^#include\s+"([^"]+)"', fh.read(), re.M)
        assert set(includes) <= {"cuda_abi.h", "vtpu_core.h"}, (f, includes)
