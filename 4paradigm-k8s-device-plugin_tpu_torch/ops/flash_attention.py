"""Fused causal attention: a hand-written CUDA kernel for Hopper and its
plain PyTorch version.

The port of ``vtpu.ops.flash_attention``, with the same public functions
and layouts: ``flash_attention`` on [batch·heads, seq, head_dim] with K/V
already repeated per head, and ``attention_bshd`` on the model's
[batch, seq, heads, head_dim].

Dispatch follows the tensors: CPU tensors go to ``flash_attention_ref``,
CUDA tensors to one of two hand-written kernels, chosen by
``kernel_route`` from the dtype and head_dim alone:

- ``"sm90"``, ``csrc/flash_attention_sm90.cu``: bf16 at head_dim 64 and
  128 (the serving path), TMA-fed wgmma with the softmax and the output
  in registers;
- ``"wmma"``, ``csrc/flash_attention.cu``: f32, and bf16 at head_dim 16
  and 32.

A CUDA call no kernel can take (dtype, head_dim, layout) raises, as does
a failed build or launch; nothing falls back to the plain version or to
the other kernel.  The kernels have no backward (the JAX package's has
none either), so a CUDA call that autograd would record (grad mode on, and
q, k or v requiring grad) raises too: its result would carry no gradient.
The CPU route stays differentiable.  Every launch adds one to
``flash_attention.launches`` and one to its route's entry in
``flash_attention.route_launches``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Head dims of the kernel instances: csrc/flash_attention.cu (both
# dtypes) and csrc/flash_attention_sm90.cu (bf16).
HEAD_DIMS = (16, 32, 64, 128)
SM90_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# route -> (library built from csrc/<library>.cu, its C entry point)
ROUTES = {"sm90": ("flash_attention_sm90", "vtpu_flash_attention_fwd_sm90"),
          "wmma": ("flash_attention", "vtpu_flash_attention_fwd")}

_NEG = torch.finfo(torch.float32).min


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Plain attention with the Pallas kernel's numerics: f32 scores, mask
    and softmax; probabilities cast to ``v.dtype`` before the p·v product,
    which accumulates in f32; output in ``q.dtype``."""
    bh, s, d = q.shape
    scores = torch.matmul(q.float(), k.float().transpose(1, 2)) * d ** -0.5
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, _NEG)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def kernel_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that a CUDA call of this dtype and head_dim takes."""
    if dtype == torch.bfloat16 and head_dim in SM90_HEAD_DIMS:
        return "sm90"
    return "wmma"


def _kernel(route: str):
    lib, symbol = ROUTES[route]
    fn = getattr(_build.library(lib), symbol)
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for t in (q, k, v):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError("flash_attention: q, k, v must lie on one CUDA "
                             f"device, got {q.device}, {k.device}, {v.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise TypeError("flash_attention: the kernel takes float32 or "
                            f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
        if t.dim() != 3 or t.shape != q.shape:
            raise ValueError("flash_attention: q, k, v must share one "
                             f"[bh, s, d] shape, got {tuple(q.shape)}, "
                             f"{tuple(k.shape)}, {tuple(v.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention: the kernel takes contiguous, "
                             "16-byte aligned tensors")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {q.shape[-1]} not in "
                         f"{HEAD_DIMS}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, route: str | None = None) -> torch.Tensor:
    """Launch the kernel of ``kernel_route`` on CUDA tensors, or the one
    ``route`` names (chip_smoke.py times the wmma kernel at the serving
    shapes so)."""
    _check(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention: the CUDA kernel has no backward "
                           "and would drop the gradients of q, k and v; "
                           "train with use_flash=False (the plain "
                           "attention), or call it under torch.no_grad()")
    bh, s, d = q.shape
    route = route or kernel_route(q.dtype, d)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _kernel(route)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                bh, s, d, _DTYPE_CODES[q.dtype], int(causal), d ** -0.5,
                stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention {route} kernel launch failed: "
                           f"CUDA error {rc}")
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 128) -> torch.Tensor:
    """Fused attention over [bh, s, d] tensors (kv already head-repeated);
    returns [bh, s, d] in ``q.dtype``.  ``block_q`` is kept for signature
    parity with ``vtpu``; it does not change the result."""
    del block_q
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_ref(q, k, v, causal)
    return _launch(q, k, v, causal)


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)


def attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True) -> torch.Tensor:
    """[b, s, h, d] convenience wrapper matching the model's layout."""
    b, s, h, d = q.shape

    def fold(t):   # at b == 1 the reshape is a strided view: copy it
        return t.transpose(1, 2).reshape(b * h, s, d).contiguous()

    out = flash_attention(fold(q), fold(k), fold(v), causal=causal)
    return out.reshape(b, h, s, d).transpose(1, 2)
