"""Dtype names on the broker's wire, resolved to torch and numpy types.

The port of ``vtpu.utils.dtypes``.  Both ends of the protocol ship dtype
*names* (numpy's: ``"float32"``, ``"int32"``, ``"bfloat16"``, ...), so a
``vtpu`` client and the port's broker, or the port's client and
``vtpu``'s broker, read each other's arrays.  ``vtpu`` resolves the
extended names (bf16, the fp8 types) through ``ml_dtypes``; the port
carries their bytes as torch tensors instead and never imports it, so
``np_dtype`` refuses them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

# The wire name of every dtype a tensor may cross the wire in.
_TORCH = {
    "bool": torch.bool,
    "int8": torch.int8, "uint8": torch.uint8,
    "int16": torch.int16, "uint16": torch.uint16,
    "int32": torch.int32, "uint32": torch.uint32,
    "int64": torch.int64, "uint64": torch.uint64,
    "float16": torch.float16, "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}
_NAMES = {v: k for k, v in _TORCH.items()}
# The names numpy has no type of its own for.
_EXTENDED = ("bfloat16", "float8_e4m3fn", "float8_e5m2")


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a wire name; raises TypeError for an unknown
    one."""
    try:
        return _TORCH[str(name)]
    except KeyError:
        raise TypeError(f"unknown dtype name {name!r}") from None


def dtype_name(dtype: torch.dtype) -> str:
    """The wire name of a torch dtype."""
    try:
        return _NAMES[dtype]
    except KeyError:
        raise TypeError(f"dtype {dtype} has no wire name") from None


def np_dtype(name: str) -> np.dtype:
    """The numpy dtype of a wire name numpy has (bf16 and the fp8 types
    it has not: those cross as torch tensors)."""
    torch_dtype(name)
    if name in _EXTENDED:
        raise TypeError(f"numpy has no {name!r}; read it as a torch tensor "
                        "(tensor_from_bytes)")
    return np.dtype(str(name))


def tensor_from_bytes(buf, name: str, shape: Sequence[int]) -> torch.Tensor:
    """A CPU tensor of ``shape`` and wire dtype ``name`` over ``buf``'s
    bytes (copied, so the tensor owns its storage)."""
    dtype = torch_dtype(name)
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    want = n * dtype.itemsize
    if len(memoryview(buf).cast("B")) != want:
        raise ValueError(f"{len(memoryview(buf).cast('B'))} bytes for "
                         f"{shape} {name} ({want} bytes)")
    if want == 0:
        return torch.empty(shape, dtype=dtype)
    flat = torch.frombuffer(bytearray(buf), dtype=torch.uint8)
    return flat.view(dtype).reshape(shape)


def tensor_bytes(t: torch.Tensor) -> memoryview:
    """The bytes of a CPU tensor, C order, as a flat memoryview (no copy
    when ``t`` is contiguous)."""
    t = t.detach()
    if t.device.type != "cpu":
        raise ValueError(f"tensor_bytes takes a CPU tensor, got {t.device}")
    t = t.contiguous()
    if t.numel() == 0:
        return memoryview(b"")
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())
