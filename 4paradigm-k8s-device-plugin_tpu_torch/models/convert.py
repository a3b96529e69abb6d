"""Weights for the port's transformer: carried across from ``vtpu`` or
drawn anew, placed tensor by tensor on the caller's device.

- ``params_from_numpy(tree, cfg, device)`` takes the pytree of
  ``vtpu.models.transformer.init_params`` as numpy arrays (bf16 leaves as
  numpy's ``bfloat16`` extension type) and returns the port's module.
- ``init_module(cfg, generator, device)`` draws weights with the same
  shapes, scales and dtypes as ``init_params`` (norms f32, everything else
  ``cfg.dtype``) from a ``torch.Generator``; the numbers differ from JAX's.
- ``init_program(cfg, seed)`` is a function of no argument that makes
  weights of the same shapes, scales and dtypes from a counter hash of
  ``seed``, in aten ops only: the broker runs it as a tenant's program, so
  the weights are made on the card and never cross the socket (the
  numbers differ from both of the above).
- ``params_to_numpy(model)`` is the way back: the pytree's names and
  nesting, bf16 as numpy's ``bfloat16``, a sharded weight gathered whole.

Weights are frozen (``requires_grad`` False) for serving; ``trainable``
makes them leaves of autograd for ``transformer.make_train_step``.

With an enforcer, every tensor is admitted against the HBM quota before
it is allocated and its charge is tied to the parameter's lifetime.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor

from ..shim.pyshim import TorchEnforcer, explicit
from .transformer import Transformer, TransformerConfig, param_shapes


def _flatten(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    flat = {k: v for k, v in tree.items() if k != "layers"}
    for i, layer in enumerate(tree["layers"]):
        flat.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    return flat


def tensor_from_numpy(arr) -> torch.Tensor:
    """A CPU tensor with ``arr``'s bits; numpy's ``bfloat16`` extension
    type maps to ``torch.bfloat16``.  A tensor is taken as it is."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().contiguous()
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """``t``'s bits as a numpy array; ``torch.bfloat16`` maps to numpy's
    ``bfloat16`` extension type (from ``ml_dtypes``, imported only then)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def _fill(cfg: TransformerConfig, device, enforcer: Optional[TorchEnforcer],
          make: Callable[[str, Tuple[int, ...], torch.dtype], torch.Tensor],
          trainable: bool = False) -> Transformer:
    """Build the module and fill each weight with ``make(name, shape,
    dtype)`` on ``device``, admitting it first under ``enforcer``."""
    model = Transformer(cfg)
    dev = enforcer.dev_of(device) if enforcer is not None else 0
    for name, shape, dtype in param_shapes(cfg):
        nbytes = math.prod(shape) * dtype.itemsize
        if enforcer is not None:
            enforcer.charge(nbytes, dev)
        try:
            with explicit():   # admitted above, not again by the pyshim
                t = make(name, shape, dtype)
        except BaseException:
            if enforcer is not None:
                enforcer.release(nbytes, dev)
            raise
        owner_path, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_path) if owner_path else model
        p = nn.Parameter(t, requires_grad=trainable)
        setattr(owner, leaf, p)
        if enforcer is not None:
            enforcer.track(p, nbytes, dev)
    return model


def params_from_numpy(tree: Dict[str, Any], cfg: TransformerConfig,
                      device="cpu",
                      enforcer: Optional[TorchEnforcer] = None,
                      trainable: bool = False) -> Transformer:
    """The module holding ``tree``'s weights on ``device``."""
    flat = _flatten(tree)
    want = {name for name, _, _ in param_shapes(cfg)}
    if set(flat) != want:
        raise ValueError(f"weight names differ from the config's: "
                         f"{sorted(set(flat) ^ want)}")

    def make(name, shape, dtype):
        t = tensor_from_numpy(flat[name])
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: got {tuple(t.shape)} {t.dtype}, "
                             f"want {shape} {dtype}")
        return t.to(device)

    return _fill(cfg, device, enforcer, make, trainable)


def init_module(cfg: TransformerConfig, generator: torch.Generator,
                device="cuda", enforcer: Optional[TorchEnforcer] = None,
                trainable: bool = False) -> Transformer:
    """Random weights with ``init_params``' shapes, scales and dtypes,
    drawn on ``device`` from ``generator`` (which must live there)."""

    def make(name, shape, dtype):
        leaf = name.rpartition(".")[2]
        if leaf.endswith("norm"):
            return torch.ones(shape, dtype=dtype, device=device)
        # embed: dim^-1/2; dense weights: fan_in^-1/2 (fan_in = rows).
        scale = cfg.dim ** -0.5 if leaf == "embed" else shape[0] ** -0.5
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(scale).to(dtype)

    return _fill(cfg, device, enforcer, make, trainable)


def _hash_uniform(n: int, salt: int, device) -> torch.Tensor:
    """n floats uniform in [-0.5, 0.5) from a counter hash (a 32-bit
    integer mix of index and salt), with no generator state."""
    m = 0xFFFFFFFF
    h = (torch.arange(n, dtype=torch.int64, device=device)
         * 0x9E3779B1 + salt) & m
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & m
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & m
    h = h ^ (h >> 16)
    return (h & 0xFFFFFF).to(torch.float32) * 2.0 ** -24 - 0.5


def init_program(cfg: TransformerConfig, seed: int = 0,
                 device="meta") -> Callable[[], Tuple[torch.Tensor, ...]]:
    """A function of no argument returning every weight in
    ``param_shapes`` order: norms ones, the rest uniform with
    ``init_module``'s standard deviation (embed dim^-1/2, dense weights
    fan_in^-1/2), drawn from a hash of ``seed`` and the weight's index.
    Traced on ``device`` ("meta": nothing is allocated)."""

    def fn():
        out = []
        for i, (name, shape, dtype) in enumerate(param_shapes(cfg)):
            leaf = name.rpartition(".")[2]
            if leaf.endswith("norm"):
                out.append(torch.ones(shape, dtype=dtype, device=device))
                continue
            scale = cfg.dim ** -0.5 if leaf == "embed" else shape[0] ** -0.5
            u = _hash_uniform(math.prod(shape), seed * 1000003 + i, device)
            out.append((u * (scale * 12 ** 0.5)).reshape(shape).to(dtype))
        return tuple(out)

    return fn


def params_to_numpy(model: Transformer) -> Dict[str, Any]:
    """``model``'s weights as ``vtpu``'s pytree of numpy arrays (the
    reverse of ``params_from_numpy``).  A DTensor weight is gathered with
    ``full_tensor()``, a collective: every rank of its mesh must call."""
    tree: Dict[str, Any] = {"layers": [{} for _ in model.layers]}
    for name, p in model.named_parameters():
        t = p.full_tensor() if isinstance(p, DTensor) else p
        path = name.split(".")
        if path[0] == "layers":
            tree["layers"][int(path[1])][path[2]] = tensor_to_numpy(t)
        else:
            tree[name] = tensor_to_numpy(t)
    return tree
