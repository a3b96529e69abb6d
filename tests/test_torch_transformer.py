"""The port's transformer (vtpu_torch.models) against vtpu.models.transformer
on the CPU, on the same weights carried across as numpy arrays.

Tolerances: f32 units and logits at 1e-5 (only summation order and the
last ulp of libm's transcendentals differ); bf16 logits at the 5e-2 of
tests/test_flash_attention.py (the two frameworks round bf16
intermediates at different places).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu.models import transformer as jtr
from vtpu_torch.models import transformer as ttr
from vtpu_torch.models.convert import params_from_numpy, tensor_from_numpy

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 5e-2}


def _pair(rng, shape, dtype):
    j = jnp.asarray(rng.standard_normal(shape, np.float32), DT[dtype][0])
    return j, tensor_from_numpy(np.asarray(j))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng, (2, 8, 64), dtype)
    jw, tw = _pair(rng, (64,), "float32")
    want = jtr.rmsnorm(jx, jw)
    got = ttr.rmsnorm(tx, tw)
    assert got.dtype == tx.dtype
    # bf16: both compute in f32 and round once, so at most one ulp apart.
    tol = 1e-6 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(dtype):
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng, (2, 16, 4, 32), dtype)
    jcos, jsin = jtr._rope_tables(10000.0, DT[dtype][0], 16, 32)
    tcos, tsin = ttr.rope_tables(10000.0, DT[dtype][1], 16, 32, "cpu")
    tol = 1e-6 if dtype == "float32" else 8e-3
    for j, t in ((jcos, tcos), (jsin, tsin)):
        np.testing.assert_allclose(_np(t), np.asarray(j, np.float32),
                                   atol=tol, rtol=tol)
    # Rotate with the JAX tables on both sides: the halves, not pairs.
    want = jtr.apply_rope(jx, jcos, jsin)
    got = ttr.apply_rope(tx, tensor_from_numpy(np.asarray(jcos)),
                         tensor_from_numpy(np.asarray(jsin)))
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_gqa_repeat_matches_jnp_repeat():
    x = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    want = np.asarray(jnp.repeat(jnp.asarray(x), 3, axis=2))
    got = torch.from_numpy(x).repeat_interleave(3, dim=2).numpy()
    np.testing.assert_array_equal(got, want)


def _jax_params(cfg, seed=0):
    params = jtr.init_params(cfg, jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, params)


def test_params_from_numpy_round_trips_every_leaf():
    jcfg = jtr.TransformerConfig.tiny()
    tree = _jax_params(jcfg)
    model = params_from_numpy(tree, ttr.TransformerConfig.tiny())
    got = dict(model.named_parameters())
    leaves = {k: v for k, v in tree.items() if k != "layers"}
    for i, layer in enumerate(tree["layers"]):
        leaves.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    assert set(got) == set(leaves)
    for name, arr in leaves.items():
        t = got[name]
        assert tuple(t.shape) == arr.shape, name
        if arr.dtype.name == "bfloat16":
            back = t.view(torch.int16).numpy().view(np.uint16)
            np.testing.assert_array_equal(back, arr.view(np.uint16))
        else:
            np.testing.assert_array_equal(t.numpy(), arr)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_flash", [False, True])
def test_tiny_logits_match_vtpu(dtype, use_flash):
    jcfg = dataclasses.replace(jtr.TransformerConfig.tiny(),
                               dtype=DT[dtype][0], use_flash=use_flash)
    tcfg = dataclasses.replace(ttr.TransformerConfig.tiny(),
                               dtype=DT[dtype][1], use_flash=use_flash)
    tree = _jax_params(jcfg)
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 32),
                                               dtype=np.int32)
    want = np.asarray(jtr.forward(tree, jnp.asarray(tokens), jcfg))
    model = params_from_numpy(tree, tcfg)
    with torch.inference_mode():
        got = model(torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_state_bytes_counts_every_weight():
    cfg = ttr.TransformerConfig.tiny()
    model = params_from_numpy(_jax_params(jtr.TransformerConfig.tiny()), cfg)
    assert ttr.state_bytes(cfg) == sum(p.nbytes
                                       for p in model.parameters())
