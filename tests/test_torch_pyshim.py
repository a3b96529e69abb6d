"""The port's in-process quota enforcement (vtpu_torch.shim.pyshim) against
vtpu's python shim: the same env contract, the same shared-region
ledger and token bucket.  Every region file lives under tmp_path."""

import dataclasses
import gc
import json
import os
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch

from vtpu.models import transformer as jtr
from vtpu.utils import envspec as jenv
from vtpu_torch.models import transformer as ttr
from vtpu_torch.models.convert import params_from_numpy
from vtpu_torch.ops import _build
from vtpu_torch.shim import interposer
from vtpu_torch.shim.pyshim import install_torch_enforcement
from vtpu_torch.utils import envspec as tenv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIM_DIR = os.path.join(REPO, "4paradigm-k8s-device-plugin_tpu", "shim")


def _env(tmp_path, **kw):
    env = {"VTPU_DEVICE_MEMORY_SHARED_CACHE": str(tmp_path / "shr.cache"),
           "VTPU_DEVICE_HBM_LIMIT_0": "1Gi"}
    env.update(kw)
    return env


@pytest.fixture
def enforcer_for(tmp_path):
    made = []

    def make(**kw):
        enf = install_torch_enforcement(_env(tmp_path, **kw))
        made.append(enf)
        return enf

    yield make
    for enf in made:
        enf.close()


def test_quota_from_env_matches_vtpu():
    env = {
        "VTPU_DEVICE_HBM_LIMIT": "2Gi",
        "VTPU_DEVICE_HBM_LIMIT_1": "3000m",
        "VTPU_DEVICE_CORE_LIMIT": "150",
        "VTPU_DEVICE_MAP": "0:TPU-a 1:TPU-b",
        "VTPU_DEVICE_MEMORY_SHARED_CACHE": "/x/shr.cache",
        "VTPU_OVERSUBSCRIBE": "true",
        "VTPU_TASK_PRIORITY": "0",
        "VTPU_CORE_UTILIZATION_POLICY": "force",
        "VTPU_ACTIVE_OOM_KILLER": "1",
        "VTPU_VISIBLE_DEVICES": "TPU-a,TPU-b",
        "VTPU_RUNTIME_SOCKET": "/x/rt.sock",
        "VTPU_LOG_LEVEL": "3",
    }
    want = dataclasses.asdict(jenv.quota_from_env(env))
    got = dataclasses.asdict(tenv.quota_from_env(env))
    assert got == want
    assert got["core_limit_pct"] == 100 and got["hbm_limit_bytes"][1] == \
        3 * 10**9
    for q in ("1Ki", "5m", "7", "1.5Gi"):
        assert tenv.parse_quantity(q) == jenv.parse_quantity(q)


def test_no_quota_env_installs_nothing():
    assert install_torch_enforcement({}) is None


def test_upload_over_cap_raises_and_rolls_back(enforcer_for):
    enf = enforcer_for(VTPU_DEVICE_HBM_LIMIT_0="64Ki")
    model = torch.nn.Sequential(torch.nn.Linear(64, 64),
                                torch.nn.Linear(64, 256))
    before = [p for p in model.parameters()]
    with pytest.raises(MemoryError, match="RESOURCE_EXHAUSTED"):
        enf.to_device(model, "cpu")
    assert enf.ledger()["used_bytes"] == 0
    assert [p for p in model.parameters()] == before   # nothing moved
    small = torch.nn.Linear(64, 64)
    enf.to_device(small, "cpu")
    assert enf.ledger()["used_bytes"] == sum(p.nbytes
                                             for p in small.parameters())


def test_charges_released_when_collected(enforcer_for):
    enf = enforcer_for()
    t = torch.ones(1024, 64)
    out = enf.to_device(t, "cpu")
    assert out is not t and torch.equal(out, t)
    assert enf.ledger()["proc_used_bytes"] == t.nbytes
    del out
    gc.collect()
    assert enf.ledger()["used_bytes"] == 0

    model = enf.to_device(torch.nn.Linear(32, 32), "cpu")
    assert enf.ledger()["used_bytes"] == 32 * 32 * 4 + 32 * 4
    del model
    gc.collect()
    assert enf.ledger()["used_bytes"] == 0


def test_gated_outputs_charged_until_collected(enforcer_for):
    enf = enforcer_for()
    f = enf.gated(lambda a: a @ a)
    out = f(torch.ones(64, 64))
    assert enf.ledger()["used_bytes"] == out.nbytes
    assert enf.ledger()["proc_busy_us"] > 0
    del out
    gc.collect()
    assert enf.ledger()["used_bytes"] == 0


def test_force_throttles_with_pinned_cost(enforcer_for):
    """As tests/test_pyshim.py::test_jit_throttled: a 20% share with a
    5 ms floor per call under FORCE visibly slows 20 tiny calls."""
    enf = enforcer_for(VTPU_DEVICE_CORE_LIMIT="20",
                       VTPU_MIN_EXEC_COST_US="5000",
                       VTPU_CORE_UTILIZATION_POLICY="FORCE")
    f = enf.gated(lambda a: a @ a)
    x = torch.ones(128, 128)
    for _ in range(80):     # drain the burst, train the estimate
        f(x)
    t0 = time.monotonic()
    for _ in range(20):
        f(x)
    elapsed = time.monotonic() - t0
    assert elapsed > 0.2, f"no throttle: {elapsed}"


def test_sole_tenant_ungated_under_default(enforcer_for):
    """Under DEFAULT a sole tenant is never gated, even with a floor per
    call: ``gate`` returns a negative estimate (ungated) on every call."""
    enf = enforcer_for(VTPU_DEVICE_CORE_LIMIT="20",
                       VTPU_MIN_EXEC_COST_US="5000")
    estimates = []
    gate = enf.gate

    def spy(key, dev=0):
        estimates.append(gate(key, dev))
        return estimates[-1]

    enf.gate = spy
    f = enf.gated(lambda a: a @ a)
    x = torch.ones(128, 128)
    for _ in range(20):
        f(x)
    assert len(estimates) == 20
    assert all(est < 0 for est in estimates), estimates


def test_tiny_model_ledger_matches_vtpu_pyshim(tmp_path, enforcer_for):
    """The bytes the port charges for the tiny model equal what vtpu's
    python shim charges when device_put uploads the same params.  The
    JAX side runs in a fresh interpreter with its shim on PYTHONPATH,
    against a libvtpucore built from the same source."""
    code = """
        import json, jax, numpy as np
        from vtpu.models import transformer as tr
        from vtpu.shim import pyshim
        p = tr.init_params(tr.TransformerConfig.tiny(), jax.random.PRNGKey(0))
        p = jax.tree_util.tree_map(np.asarray, p)
        region = pyshim.enforcer().region
        before = region.device_stats(0).used_bytes
        kept = jax.device_put(p)
        print(json.dumps(region.device_stats(0).used_bytes - before))
    """
    env = dict(os.environ)
    env.update(_env(tmp_path / "jax"), JAX_PLATFORMS="cpu",
               PYTHONPATH=SHIM_DIR + os.pathsep + REPO,
               VTPU_CORE_LIB=_build.build_all(("vtpucore",))["vtpucore"])
    (tmp_path / "jax").mkdir()
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    jax_bytes = json.loads(r.stdout.strip().splitlines()[-1])

    tree = jax.tree_util.tree_map(
        np.asarray, jtr.init_params(jtr.TransformerConfig.tiny(),
                                    jax.random.PRNGKey(0)))
    enf = enforcer_for()
    model = params_from_numpy(tree, ttr.TransformerConfig.tiny(), "cpu", enf)
    assert enf.ledger()["used_bytes"] == jax_bytes
    assert jax_bytes == ttr.state_bytes(model.cfg) > 0


def preloaded(tmp_path, quota):
    """The env of a process started under the native interposer, with the
    mock driver (native/mock_cuda.cc) as libcuda.so.1."""
    paths = _build.build_all(("vtpu_cuda", "mockcuda", "mocknvml"))
    mocks = tmp_path / "mock_driver"
    mocks.mkdir()
    os.symlink(paths["mockcuda"], mocks / "libcuda.so.1")
    os.symlink(paths["mocknvml"], mocks / "libnvidia-ml.so.1")
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("VTPU_", "LD_"))}
    env = interposer.tenant_env(_env(tmp_path, **quota), base=base)
    env["LD_LIBRARY_PATH"] = str(mocks)
    return env


def test_install_stands_down_only_under_interposer(tmp_path,
                                                   enforcer_for):
    """Under the interposer (its ident symbol resolves in the process)
    install_torch_enforcement returns None: the quota is enforced
    natively.  Without the symbol it installs the enforcer as before."""
    code = f"""
        import json, sys
        sys.path.insert(0, {REPO!r})
        from vtpu_torch.shim import interposer
        from vtpu_torch.shim.pyshim import install_torch_enforcement
        enf = install_torch_enforcement()
        print(json.dumps({{"loaded": interposer.loaded(),
                           "enforcer": enf is not None}}))
    """
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=300,
                       env=preloaded(tmp_path, {}))
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == {
        "loaded": True, "enforcer": False}
    assert not interposer.loaded()
    assert enforcer_for() is not None
