"""The port's attention (vtpu_torch.ops.flash_attention) against the JAX
package's Pallas kernel, run in interpret mode on the CPU as
tests/test_flash_attention.py runs it.

On the CPU the port's wrapper takes its plain version; the CUDA kernel
itself is held against that plain version on the card by chip_smoke.py.
Inputs come from numpy and go to both sides.  Tolerances are those of
tests/test_flash_attention.py: f32 2e-5 (the two sides differ only in
summation order), bf16 3e-2 (one bf16 rounding of the probabilities may
land on either side).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu.models import transformer as jtr
from vtpu.ops import flash_attention as jfa
from vtpu_torch.models import transformer as ttr
from vtpu_torch.models.convert import params_from_numpy, tensor_from_numpy
from vtpu_torch.ops import flash_attention as tfa

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(seed, shape, dtype):
    """q, k, v as JAX arrays and as torch tensors with the same bits."""
    rng = np.random.default_rng(seed)
    jx = [jnp.asarray(rng.standard_normal(shape, np.float32), dtype)
          for _ in range(3)]
    return jx, [tensor_from_numpy(np.asarray(a)) for a in jx]


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("seed,shape,dtype,causal", [
    (0, (4, 256, 64), "float32", True),      # test_kernel_matches_reference_f32
    (1, (2, 128, 64), "bfloat16", True),     # ..._bf16
    (2, (2, 128, 32), "float32", False),     # test_non_causal
    (3, (2, 200, 16), "float32", True),      # ragged s, smallest head_dim
    (4, (2, 200, 64), "bfloat16", False),
])
def test_matches_pallas_kernel(seed, shape, dtype, causal):
    (jq, jk, jv), (q, k, v) = _inputs(seed, shape, getattr(jnp, dtype))
    want = jfa.flash_attention(jq, jk, jv, causal=causal, block_q=128)
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, causal=causal, block_q=128)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, dtype)
    assert tfa.flash_attention.launches == before   # CPU: no kernel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_bshd_layout(dtype):
    (jq, jk, jv), (q, k, v) = _inputs(5, (2, 64, 4, 32), getattr(jnp, dtype))
    want = jfa.attention_bshd(jq, jk, jv, causal=True)
    got = tfa.attention_bshd(q, k, v, causal=True)
    assert got.shape == q.shape
    _close(got, want, dtype)


def test_transformer_flash_path_matches_reference_path():
    """As tests/test_flash_attention.py's fourth case, across the two
    packages: the port's tiny model on its flash path against vtpu's on
    its plain path, same bf16 weights, at that test's 5e-2."""
    cfg = jtr.TransformerConfig.tiny()
    params = jax.tree_util.tree_map(
        np.asarray, jtr.init_params(cfg, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, 64),
                                               dtype=np.int32)
    want = np.asarray(jtr.forward(params, jnp.asarray(tokens), cfg))
    tcfg = dataclasses.replace(ttr.TransformerConfig.tiny(), use_flash=True)
    with torch.inference_mode():
        got = params_from_numpy(params, tcfg)(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-2, rtol=5e-2)


def test_cuda_call_without_card_raises(monkeypatch):
    """A tensor off the CPU goes to the kernel path, and the kernel path
    raises rather than falling back to the plain version."""
    assert not torch.cuda.is_available()
    q = torch.zeros(2, 64, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, q, q)

    seen = []
    monkeypatch.setattr(tfa, "_launch",
                        lambda *a: seen.append(a[0].device.type))
    tfa.flash_attention(q, q, q)
    assert seen == ["meta"]
    with pytest.raises((RuntimeError, AssertionError)):
        tfa.flash_attention(*(torch.zeros(2, 64, 16, device="cuda"),) * 3)

