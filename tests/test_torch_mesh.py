"""The port's ('dp','tp') mesh and sharded training step on the CPU: the
shape rule and the weights' placements held against vtpu's, and, in gloo
process groups of n worker processes, one sharded Adam step held against
the port's unsharded step and the sharded dry-run.

Tolerances of the sharded step against the unsharded one (f32): the
loss to rtol 1e-5; every weight within 1e-5 on at least 99.9% of each
tensor's elements and within 2·lr everywhere (the reduction order of the
collectives differs from one process's, and where |g| is near 0 Adam's
first step can flip its sign: see tests/test_torch_train.py).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from vtpu_torch import entry
from vtpu_torch.models import transformer as ttr
from vtpu_torch.models.convert import init_module, params_to_numpy
from vtpu_torch.parallel import mesh as pm

LR = 1e-3


def test_param_specs_match_vtpu():
    """Weight by weight, P(None, "tp") is (Replicate(), Shard(1)),
    P("tp", None) is (Replicate(), Shard(0)) and P() is replicated."""
    from vtpu.models import transformer as jtr

    jcfg = jtr.TransformerConfig.tiny()
    want = {k: v for k, v in jtr.param_specs(jcfg).items() if k != "layers"}
    for i, layer in enumerate(jtr.param_specs(jcfg)["layers"]):
        want.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    got = ttr.param_specs(ttr.TransformerConfig.tiny())
    assert set(got) == set(want)
    for name, spec in want.items():
        spec = tuple(spec)
        expect = (Replicate(), Shard(spec.index("tp")) if "tp" in spec
                  else Replicate())
        assert got[name] == expect, (name, spec, got[name])


@pytest.mark.parametrize("n,tp", [(8, None), (8, 4), (8, 2), (4, None),
                                  (2, None), (6, None), (1, None)])
def test_mesh_shape_matches_vtpu(n, tp):
    from vtpu.parallel.mesh import make_mesh as jax_make_mesh

    jmesh = jax_make_mesh(n, tp=tp)
    assert pm.mesh_shape(n, tp) == (jmesh.shape["dp"], jmesh.shape["tp"])


def test_mesh_shape_rule():
    assert pm.mesh_shape(8) == (1, 8)
    assert pm.mesh_shape(8, tp=4) == (2, 4)
    assert pm.mesh_shape(12) == (3, 4)
    assert pm.mesh_shape(3) == (3, 1)
    for n, tp in ((8, 3), (4, 8), (8, 0)):
        with pytest.raises(ValueError, match="not divisible"):
            pm.mesh_shape(n, tp)


def test_bad_tp_raises_as_vtpu():
    from vtpu.parallel.mesh import make_mesh as jax_make_mesh

    with pytest.raises(ValueError):
        jax_make_mesh(8, tp=3)
    with pytest.raises(ValueError):
        pm.mesh_shape(8, tp=3)


def test_placements():
    assert pm.placements(None, "tp") == (Replicate(), Shard(1))
    assert pm.placements("tp", None) == (Replicate(), Shard(0))
    assert pm.placements("dp") == (Shard(0), Replicate())
    assert pm.placements() == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="not in"):
        pm.placements("sp")


def test_make_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        pm.make_mesh(2, device_type="cpu")


def _fail():
    raise ValueError("worker fault")


def test_run_group_reports_a_worker_failure():
    with pytest.raises(RuntimeError, match="worker fault"):
        pm.run_group(2, _fail, device_type="cpu")


def _sharded_step(n, tp):
    """In each rank of an n-process gloo group: one Adam step of the tiny
    f32 model unsharded and sharded over make_mesh(n, tp), and the
    dry-run in this group.  Rank 0 returns both losses and both sets of
    updated weights; the dry-run's loss comes from every rank."""
    cfg = dataclasses.replace(ttr.TransformerConfig.tiny(),
                              dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 17), dtype=np.int32))

    def model():
        return init_module(cfg, torch.Generator().manual_seed(0), "cpu",
                           trainable=True)

    plain = model()
    step, _ = ttr.make_train_step(plain, lr=LR)
    plain_loss = float(step(tokens))
    mesh = pm.make_mesh(n, tp, device_type="cpu")
    assert pm.shard(mesh, None, "tp") == (Replicate(), Shard(1))
    assert pm.replicate(mesh) == (Replicate(), Replicate())
    sharded = ttr.shard_params(model(), mesh)
    placed = {k: tuple(p.placements) for k, p in sharded.named_parameters()}
    step, _ = ttr.make_train_step(sharded, mesh=mesh, lr=LR)
    sharded_loss = float(step(tokens))
    sharded_weights = params_to_numpy(sharded)   # a collective: every rank
    dry_loss = entry.dryrun_multichip(n, "cpu")
    out = {"dry_loss": dry_loss, "mesh": tuple(mesh.shape)}
    if torch.distributed.get_rank() == 0:
        out.update(plain_loss=plain_loss, sharded_loss=sharded_loss,
                   plain=params_to_numpy(plain), sharded=sharded_weights,
                   placed=placed)
    return out


@pytest.mark.parametrize("n,tp", [(2, None), (4, 2), (8, None)],
                         ids=["2-auto", "4-tp2", "8-auto"])
def test_sharded_step_matches_unsharded(n, tp):
    """(8, auto) is tp=8 over the tiny model's 4 query and 2 KV heads:
    heads that do not divide over 'tp'."""
    ranks = pm.run_group(n, _sharded_step, (n, tp), device_type="cpu")
    r0 = ranks[0]
    assert r0["mesh"] == pm.mesh_shape(n, tp)
    assert r0["placed"] == ttr.param_specs(ttr.TransformerConfig.tiny())
    np.testing.assert_allclose(r0["sharded_loss"], r0["plain_loss"],
                               rtol=1e-5)
    pairs = [(k, r0["plain"][k], r0["sharded"][k])
             for k in r0["plain"] if k != "layers"]
    for i, layer in enumerate(r0["plain"]["layers"]):
        pairs += [(f"layers.{i}.{k}", v, r0["sharded"]["layers"][i][k])
                  for k, v in layer.items()]
    assert len(pairs) == len(ttr.param_shapes(ttr.TransformerConfig.tiny()))
    for name, want, got in pairs:
        diff = np.abs(got.astype(np.float64) - want)
        assert diff.max() <= 2 * LR, (name, diff.max())
        assert np.mean(diff <= 1e-5) >= 0.999, name
    dry = [r["dry_loss"] for r in ranks]
    assert all(np.isfinite(dry)) and len(set(dry)) == 1, dry
