"""The port's attention (vtpu_torch.ops.flash_attention) against the JAX
package's Pallas kernel, run in interpret mode on the CPU as
tests/test_flash_attention.py runs it.

On the CPU the port's wrapper takes its plain version; the CUDA kernels
themselves are held against that plain version on the card by
chip_smoke.py.  What the CPU can pin of them is here too: which kernel
a CUDA call takes, that it never falls back, and a tile-by-tile model of
the Hopper kernel's algorithm.  Inputs come from numpy and go to both
sides.  Tolerances are those of tests/test_flash_attention.py: f32 2e-5
(the two sides differ only in summation order), bf16 3e-2 (one bf16
rounding of the probabilities may land on either side).
"""

import dataclasses
import math

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



@pytest.mark.parametrize("dtype,head_dim,route", [
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.bfloat16, 16, "wmma"), (torch.bfloat16, 32, "wmma"),
    (torch.float32, 16, "wmma"), (torch.float32, 32, "wmma"),
    (torch.float32, 64, "wmma"), (torch.float32, 128, "wmma"),
])
def test_kernel_route(dtype, head_dim, route):
    """bf16 at head_dim 64 and 128 takes the Hopper kernel; f32 and the
    small head dims take the wmma kernel."""
    assert tfa.kernel_route(dtype, head_dim) == route
    assert route in tfa.ROUTES


def test_sm90_call_without_card_raises(monkeypatch):
    """A bf16 head_dim-128 call off the CPU goes to the sm90 launcher,
    which raises here (no nvcc, no card) rather than falling back to the
    plain version or to the other kernel."""
    assert not torch.cuda.is_available()
    q = torch.zeros(2, 64, 128, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, q, q)

    seen, real = [], tfa._kernel
    monkeypatch.setattr(tfa, "_check", lambda *a: None)  # let meta through
    monkeypatch.setattr(tfa, "_kernel",
                        lambda route: (seen.append(route), real(route))[1])
    before = (tfa.flash_attention.launches,
              dict(tfa.flash_attention.route_launches))
    with pytest.raises(RuntimeError):
        tfa.flash_attention(q, q, q)
    assert seen == ["sm90"]
    assert (tfa.flash_attention.launches,
            tfa.flash_attention.route_launches) == before


# -- a plain model of the sm90 kernel's tiling --------------------------------

BM, BN, WG_ROWS = 128, 128, 64   # as csrc/flash_attention_sm90.cu


def _rows(t, r0, n):
    """Rows r0 .. r0+n-1 of [bh, s, d] in f32, zero past s (as TMA
    zero-fills a box that runs past the head)."""
    out = torch.zeros(t.shape[0], n, t.shape[2])
    end = min(r0 + n, t.shape[1])
    if end > r0:
        out[:, :end - r0] = t[:, r0:end].float()
    return out


def sm90_tiling_model(q, k, v, causal):
    """The algorithm of csrc/flash_attention_sm90.cu, tile by tile: a
    block per 128 query rows, split into two 64-row warpgroups; keys in
    128-key tiles up to the diagonal tile (later ones are never loaded);
    a mask only on tiles that cross the diagonal or run past s; an online
    softmax in the exp2 domain; unnormalised probabilities cast to the
    input type before p·v; the f32 sum divides at the end."""
    bh, s, d = q.shape
    scale_log2 = d ** -0.5 * math.log2(math.e)
    out = torch.zeros(bh, s, d)
    n_qt = -(-s // BM)
    for qt in range(n_qt):
        m0 = qt * BM
        n_tiles = qt + 1 if causal else -(-s // BN)
        for wg in range(BM // WG_ROWS):
            r0 = m0 + wg * WG_ROWS
            rows = torch.arange(r0, r0 + WG_ROWS)
            qw = _rows(q, r0, WG_ROWS)
            run_max = torch.full((bh, WG_ROWS), -math.inf)
            run_sum = torch.zeros(bh, WG_ROWS)
            acc = torch.zeros(bh, WG_ROWS, d)
            for t in range(n_tiles):
                n0 = t * BN
                keys = torch.arange(n0, n0 + BN)
                sc = qw @ _rows(k, n0, BN).transpose(1, 2)
                if n0 + BN > s or (causal and n0 + BN - 1 > r0):
                    dead = keys[None, :] >= s
                    if causal:
                        dead = dead | (keys[None, :] > rows[:, None])
                    sc = sc.masked_fill(dead, -math.inf)
                else:   # a tile the kernel leaves unmasked has no dead key
                    assert keys.max() < s
                    assert not causal or keys.max() <= rows.min()
                new_max = torch.maximum(run_max,
                                        sc.amax(-1) * scale_log2)
                assert torch.isfinite(new_max).all()   # key 0 is live
                alpha = torch.exp2(run_max - new_max)
                p = torch.exp2(sc * scale_log2 - new_max[..., None])
                run_sum = run_sum * alpha + p.sum(-1)
                acc = (acc * alpha[..., None]
                       + p.to(v.dtype).float() @ _rows(v, n0, BN))
                run_max = new_max
            live = min(WG_ROWS, s - r0)
            if live > 0:
                out[:, r0:r0 + live] = (acc / run_sum[..., None])[:, :live]
    return out.to(q.dtype)


@pytest.mark.parametrize("seed,shape,dtype,causal", [
    (10, (2, 200, 64), "float32", True),
    (11, (2, 200, 64), "float32", False),
    (12, (2, 77, 128), "float32", True),
    (13, (3, 77, 128), "float32", False),
    (14, (2, 200, 128), "bfloat16", True),
    (15, (2, 200, 64), "bfloat16", False),
    (16, (3, 77, 128), "bfloat16", True),
    (17, (2, 77, 64), "bfloat16", False),
])
def test_sm90_tiling_model_matches_pallas_kernel(seed, shape, dtype, causal):
    """The model of the Hopper kernel's tiling against the Pallas kernel
    in interpret mode at ragged s: pins the index arithmetic (tile
    counts, diagonal masking, zero-filled tails) that the CUDA code
    implements."""
    (jq, jk, jv), (q, k, v) = _inputs(seed, shape, getattr(jnp, dtype))
    want = jfa.flash_attention(jq, jk, jv, causal=causal, block_q=128)
    got = sm90_tiling_model(q, k, v, causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, dtype)
