"""Decoder-only transformer (Llama-style): the flagship tenant workload.

The port of ``vtpu.models.transformer``'s forward pass: bf16 weights and
activations with f32 RMSNorm, RoPE on the two halves of each head
vector, SwiGLU, GQA, an untied ``lm_head`` and f32 logits.  The weight
layout is JAX's ``[in, out]`` with ``x @ w``, and the parameter names are
the JAX pytree's (``embed``, ``layers.<i>.wq``, ...), so carrying weights
across is a rename (``models.convert``).

The module is built empty, on the meta device; ``models.convert`` fills
it, tensor by tensor, on the device the caller names.  Inference only:
the train step and sharding are later slices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch
from torch import nn

from ..ops.flash_attention import attention_bshd


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 32000
    dim: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4
    hidden: int = 1408          # SwiGLU hidden (~2.75x dim)
    max_seq: int = 1024
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    # Fused attention kernel (ops.flash_attention); the plain attention
    # below stays the default, as in vtpu.
    use_flash: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def tiny() -> "TransformerConfig":
        return TransformerConfig(vocab=256, dim=64, n_layers=2, n_heads=4,
                                 n_kv_heads=2, hidden=192, max_seq=128)

    @staticmethod
    def llama_8b_proportions(layers: int = 4) -> "TransformerConfig":
        """Llama-3-8B shapes with a truncated layer stack (full depth =
        32)."""
        return TransformerConfig(vocab=128256, dim=4096, n_layers=layers,
                                 n_heads=32, n_kv_heads=8, hidden=14336,
                                 max_seq=2048)

    @staticmethod
    def llama3_8b() -> "TransformerConfig":
        """Full Llama-3-8B geometry: 32 layers, GQA 32/8, 128k vocab,
        rope 500k."""
        return TransformerConfig(vocab=128256, dim=4096, n_layers=32,
                                 n_heads=32, n_kv_heads=8, hidden=14336,
                                 max_seq=8192, rope_theta=500000.0)

    @staticmethod
    def bench() -> "TransformerConfig":
        """Llama-3-8B layer geometry with reduced vocab and depth (2
        layers, vocab 8192), so several tenant replicas share one
        device."""
        return TransformerConfig(vocab=8192, dim=4096, n_layers=2,
                                 n_heads=32, n_kv_heads=8, hidden=14336,
                                 max_seq=2048)


def layer_shapes(cfg: TransformerConfig
                 ) -> List[Tuple[str, Tuple[int, ...], torch.dtype]]:
    """(name, shape, dtype) of one decoder layer's weights."""
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    f32, dt = torch.float32, cfg.dtype
    return [("attn_norm", (cfg.dim,), f32),
            ("mlp_norm", (cfg.dim,), f32),
            ("wq", (cfg.dim, cfg.dim), dt),
            ("wk", (cfg.dim, kv_dim), dt),
            ("wv", (cfg.dim, kv_dim), dt),
            ("wo", (cfg.dim, cfg.dim), dt),
            ("w_gate", (cfg.dim, cfg.hidden), dt),
            ("w_up", (cfg.dim, cfg.hidden), dt),
            ("w_down", (cfg.hidden, cfg.dim), dt)]


def top_shapes(cfg: TransformerConfig
               ) -> List[Tuple[str, Tuple[int, ...], torch.dtype]]:
    """(name, shape, dtype) of the weights outside the layers."""
    return [("embed", (cfg.vocab, cfg.dim), cfg.dtype),
            ("final_norm", (cfg.dim,), torch.float32),
            ("lm_head", (cfg.dim, cfg.vocab), cfg.dtype)]


def param_shapes(cfg: TransformerConfig
                 ) -> List[Tuple[str, Tuple[int, ...], torch.dtype]]:
    """(name, shape, dtype) of every weight, in ``init_params`` order:
    norms in f32, everything else in ``cfg.dtype``."""
    return top_shapes(cfg) + [
        (f"layers.{i}.{name}", shape, dtype)
        for i in range(cfg.n_layers)
        for name, shape, dtype in layer_shapes(cfg)]


def _empty(shape, dtype) -> nn.Parameter:
    """A weight slot with no storage, for ``models.convert`` to fill."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device="meta"),
                        requires_grad=False)


def rmsnorm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """RMSNorm in f32 against the f32 weight, cast back to ``x.dtype``."""
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-6)
    return ((xf * rms) * w).to(x.dtype)


def rope_tables(theta: float, dtype: torch.dtype, seq: int, head_dim: int,
                device) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [seq, head_dim/2], computed in f32 and cast to
    ``dtype`` before use."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    freq = theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)
    ang = pos * freq[None, :]
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of each head vector; x: [b, s, h, d]."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


class Block(nn.Module):
    """One decoder layer's weights."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        for name, shape, dtype in layer_shapes(cfg):
            setattr(self, name, _empty(shape, dtype))


class Transformer(nn.Module):
    """tokens [b, s] int -> logits [b, s, vocab] f32 (causal LM)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        for name, shape, dtype in top_shapes(cfg):
            setattr(self, name, _empty(shape, dtype))
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))

    def attention(self, x: torch.Tensor, lp: Block, cos: torch.Tensor,
                  sin: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape
        q = (x @ lp.wq).view(b, s, cfg.n_heads, cfg.head_dim)
        k = (x @ lp.wk).view(b, s, cfg.n_kv_heads, cfg.head_dim)
        v = (x @ lp.wv).view(b, s, cfg.n_kv_heads, cfg.head_dim)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        rep = cfg.n_heads // cfg.n_kv_heads
        # jnp.repeat(k, rep, axis=2): each kv head serves `rep` adjacent
        # query heads.
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        if cfg.use_flash:
            out = attention_bshd(q, k, v, causal=True).reshape(b, s, cfg.dim)
            return out @ lp.wo
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))   # [b, h, s, d]
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        scores = scores * (cfg.head_dim ** -0.5)
        scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.matmul(probs, v)
        out = out.transpose(1, 2).reshape(b, s, cfg.dim)
        return out @ lp.wo

    @staticmethod
    def mlp(x: torch.Tensor, lp: Block) -> torch.Tensor:
        return (nn.functional.silu(x @ lp.w_gate) * (x @ lp.w_up)) @ lp.w_down

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        s = tokens.shape[1]
        x = nn.functional.embedding(tokens, self.embed)
        cos, sin = rope_tables(cfg.rope_theta, cfg.dtype, s, cfg.head_dim,
                               x.device)
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        for lp in self.layers:
            x = x + self.attention(rmsnorm(x, lp.attn_norm), lp, cos, sin,
                                   causal)
            x = x + self.mlp(rmsnorm(x, lp.mlp_norm), lp)
        x = rmsnorm(x, self.final_norm)
        return (x @ self.lm_head).float()


def state_bytes(cfg: TransformerConfig) -> int:
    """Bytes of all weights of ``cfg``."""
    return sum(math.prod(shape) * dtype.itemsize
               for _, shape, dtype in param_shapes(cfg))
