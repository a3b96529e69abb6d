"""The port's training slice on the CPU: loss_fn and one Adam step of
make_train_step held against vtpu.models.transformer's on the same
weights (carried across as numpy arrays) and tokens, entry.train, the
weights' way back to numpy, and the fused kernel's refusal to run where
autograd would need its backward.

Tolerances:
- loss, f32: rtol 1e-5 (summation order only).
- loss, bf16: rtol 1e-3 (the frameworks round bf16 intermediates at
  different places; the logits agree to 5e-2, tests/test_torch_transformer
  .py, and the mean over every position averages that out).
- weights after one step, f32: within 1e-5 on at least 99.9% of each
  tensor's elements, and within 2·lr everywhere.  Adam's first step moves
  each weight by lr·g/(|g|+eps), so where |g| is near 0 the two sides'
  rounding can flip the step's sign: at most 2·lr apart.
- weights after one step, bf16: within one bf16 ulp on at least 98% of
  each tensor's elements, and within 2·lr + one ulp everywhere.  optax
  rounds the update once, torch's Adam at each bf16 op, and the bf16
  gradients differ more than f32's, so the sign flips above are more
  frequent; near 0, where an ulp is tiny, the update's own rounding also
  spans ulps.  Measured on seeds 0-2: 0.23-0.85% of a tensor's elements
  beyond one ulp, the worst 0.0039 (2·lr plus rounding).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu.models import transformer as jtr
from vtpu_torch import entry
from vtpu_torch.models import transformer as ttr
from vtpu_torch.models.convert import (init_module, params_from_numpy,
                                       params_to_numpy)
from vtpu_torch.ops import flash_attention as tfa

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LR = 1e-3


def _configs(dtype):
    jcfg = dataclasses.replace(jtr.TransformerConfig.tiny(),
                               dtype=DT[dtype][0])
    tcfg = dataclasses.replace(ttr.TransformerConfig.tiny(),
                               dtype=DT[dtype][1])
    return jcfg, tcfg


def _weights_and_tokens(jcfg, seed=0):
    params = jtr.init_params(jcfg, jax.random.PRNGKey(seed))
    tokens = np.random.default_rng(seed).integers(0, jcfg.vocab, (4, 33),
                                                  dtype=np.int32)
    return params, jax.tree_util.tree_map(np.asarray, params), tokens


def _leaves(tree):
    """(name, array) of every weight of a vtpu pytree."""
    out = [(k, v) for k, v in tree.items() if k != "layers"]
    for i, layer in enumerate(tree["layers"]):
        out += [(f"layers.{i}.{k}", v) for k, v in layer.items()]
    return out


def _bf16_ulp(x):
    """One bf16 ulp at |x|: 2^(e-7) for |x| in [2^e, 2^(e+1))."""
    _, e = np.frexp(np.abs(x.astype(np.float64)))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_fn_matches_vtpu(dtype):
    jcfg, tcfg = _configs(dtype)
    params, tree, tokens = _weights_and_tokens(jcfg)
    want = float(jtr.loss_fn(params, jnp.asarray(tokens), jcfg))
    model = params_from_numpy(tree, tcfg)
    with torch.no_grad():
        got = ttr.loss_fn(model, torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == ()
    rtol = 1e-5 if dtype == "float32" else 1e-3
    np.testing.assert_allclose(float(got), want, rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_vtpu(dtype):
    """One Adam step: the same loss, and the same updated weights."""
    jcfg, tcfg = _configs(dtype)
    params, tree, tokens = _weights_and_tokens(jcfg)
    jstep, opt = jtr.make_train_step(jcfg, lr=LR)
    jparams, _, jloss = jstep(params, opt.init(params), jnp.asarray(tokens))
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, jparams)))

    model = params_from_numpy(tree, tcfg, trainable=True)
    step, _ = ttr.make_train_step(model, lr=LR)
    loss = step(torch.from_numpy(tokens))
    got = dict(_leaves(params_to_numpy(model)))

    assert set(got) == set(want)
    if dtype == "float32":
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        for name, w in want.items():
            diff = np.abs(got[name].astype(np.float64) - w)
            assert diff.max() <= 2 * LR, (name, diff.max())
            assert np.mean(diff <= 1e-5) >= 0.999, (name, np.mean(
                diff <= 1e-5))
    else:
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-3)
        for name, w in want.items():
            a = got[name].astype(np.float64)
            b = w.astype(np.float64)
            ulp = _bf16_ulp(np.maximum(np.abs(a), np.abs(b)))
            diff = np.abs(a - b)
            assert (diff <= 2 * LR + ulp).all(), (name, diff.max())
            assert np.mean(diff <= ulp) >= 0.98, (name, np.mean(diff <= ulp))


def test_training_reduces_loss():
    """The twin of tests/test_models.py::test_transformer_training_reduces
    _loss, through entry.train: ten steps at lr 1e-2 on one fixed block
    bring the tiny model's loss under 0.8 of its start."""
    tokens = np.random.default_rng(1).integers(0, 256, (4, 33),
                                               dtype=np.int32)
    out = entry.train("tiny", batch=4, seq=32, steps=10, device="cpu",
                      lr=1e-2, tokens=tokens)
    losses = out["losses"]
    assert len(losses) == 10 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.8, losses
    assert out["steps_per_s"] > 0
    assert out["tokens_per_s"] == pytest.approx(out["steps_per_s"] * 4 * 32)


def test_train_under_quota(tmp_path, monkeypatch):
    """Under a quota env the weights are admitted against the cap and
    every step is gated and timed: each step's ledger holds at least the
    weights and stays under the cap."""
    monkeypatch.setenv("VTPU_DEVICE_HBM_LIMIT_0", "64Mi")
    monkeypatch.setenv("VTPU_DEVICE_CORE_LIMIT", "100")
    monkeypatch.setenv("VTPU_DEVICE_MEMORY_SHARED_CACHE",
                       str(tmp_path / "shr.cache"))
    out = entry.train("tiny", batch=2, seq=16, steps=3, device="cpu")
    try:
        cfg = ttr.TransformerConfig.tiny()
        assert len(out["step_ledgers"]) == 3
        for ledger in out["step_ledgers"] + [out["ledger"]]:
            assert ttr.state_bytes(cfg) <= ledger["used_bytes"] \
                <= ledger["limit_bytes"] == 64 * 2**20
        assert out["ledger"]["proc_busy_us"] > 0
        assert all(p.requires_grad for p in out["model"].parameters())
    finally:
        out["enforcer"].close()


def test_train_without_card_raises():
    """Both training entry points run on the card unless told otherwise."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        entry.train("tiny")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        entry.dryrun_multichip(1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_to_numpy_round_trip(dtype):
    """params_to_numpy(params_from_numpy(tree)) is ``tree``, bit for bit,
    names, nesting and dtypes."""
    jcfg, tcfg = _configs(dtype)
    _, tree, _ = _weights_and_tokens(jcfg, seed=3)
    back = params_to_numpy(params_from_numpy(tree, tcfg))
    assert set(back) == set(tree)
    assert len(back["layers"]) == len(tree["layers"])
    want, got = dict(_leaves(tree)), dict(_leaves(back))
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype and got[name].shape == w.shape
        assert got[name].tobytes() == w.tobytes(), name


def test_weights_frozen_unless_trainable():
    cfg = ttr.TransformerConfig.tiny()
    gen = torch.Generator().manual_seed(0)
    frozen = init_module(cfg, gen, "cpu")
    assert not any(p.requires_grad for p in frozen.parameters())
    trained = init_module(cfg, gen, "cpu", trainable=True)
    assert all(p.requires_grad for p in trained.parameters())


def test_cuda_kernel_refuses_autograd(monkeypatch):
    """The CUDA route has no backward: a call that autograd would record
    raises before any kernel is fetched; under no_grad (or with no input
    requiring grad) it goes on to the kernel."""
    q = torch.zeros(2, 64, 128, dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    fetched = []
    monkeypatch.setattr(tfa, "_check", lambda *a: None)  # let meta through

    def kernel(route):
        fetched.append(route)
        raise RuntimeError("no kernel here")

    monkeypatch.setattr(tfa, "_kernel", kernel)
    with pytest.raises(RuntimeError, match="no backward"):
        tfa.flash_attention(q, q, q)
    assert fetched == []
    with torch.no_grad(), pytest.raises(RuntimeError, match="no kernel"):
        tfa.flash_attention(q, q, q)
    with pytest.raises(RuntimeError, match="no kernel"):
        tfa.flash_attention(*(q.detach(),) * 3)
    assert fetched == ["sm90", "sm90"]


def test_cpu_route_stays_differentiable():
    """On the CPU the plain version runs, and gradients reach q, k, v."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 16, 32, generator=gen, requires_grad=True)
               for _ in range(3))
    tfa.flash_attention(q, k, v).square().sum().backward()
    for t in (q, k, v):
        assert t.grad is not None and torch.isfinite(t.grad).all()
        assert t.grad.abs().sum() > 0


def test_cli_train_on_cpu(capsys, monkeypatch):
    """``python -m vtpu_torch.entry --train --device cpu --cfg tiny``."""
    monkeypatch.delenv("VTPU_DEVICE_HBM_LIMIT_0", raising=False)
    entry.main(["--train", "--device", "cpu", "--cfg", "tiny", "--batch",
                "2", "--seq", "16", "--steps", "2"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["cfg"] == "tiny" and len(got["losses"]) == 2
    assert all(np.isfinite(got["losses"])) and got["ledger"] is None
