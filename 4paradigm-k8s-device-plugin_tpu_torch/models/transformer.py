"""Decoder-only transformer (Llama-style): the flagship tenant workload.

The port of ``vtpu.models.transformer``'s forward pass: bf16 weights and
activations with f32 RMSNorm, RoPE on the two halves of each head
vector, SwiGLU, GQA, an untied ``lm_head`` and f32 logits.  The weight
layout is JAX's ``[in, out]`` with ``x @ w``, and the parameter names are
the JAX pytree's (``embed``, ``layers.<i>.wq``, ...), so carrying weights
across is a rename (``models.convert``).

The module is built empty, on the meta device; ``models.convert`` fills
it, tensor by tensor, on the device the caller names.

Training is ``vtpu``'s too: ``loss_fn`` (next-token cross-entropy) and
``make_train_step`` (one Adam step with optax's defaults).  With a mesh
(``parallel.mesh``), ``shard_params`` places each weight as
``param_specs`` says (``vtpu``'s PartitionSpecs as DTensor placements:
attention heads and the MLP hidden split over 'tp'), the batch is split
over 'dp', and DTensor inserts the collectives that XLA's GSPMD inserts
in ``vtpu``; the per-head part of attention and the loss run on each
rank's own rows and heads.  Training takes the plain attention, as
``vtpu``'s does: the fused kernel has no backward.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                      distribute_tensor)
from torch.distributed.tensor.placement_types import Placement

from ..ops.flash_attention import attention_bshd
from ..parallel.mesh import placements


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


# vtpu's param_specs: the weights split over 'tp' and the dim split, the
# contraction-free one (P(None, "tp") is dim 1, P("tp", None) dim 0).
# Every other weight is replicated (P()).
_TP_DIM = {"wq": 1, "wk": 1, "wv": 1, "w_gate": 1, "w_up": 1, "lm_head": 1,
           "wo": 0, "w_down": 0}


def param_specs(cfg: TransformerConfig) -> Dict[str, Tuple[Placement, ...]]:
    """Each weight's placements over the ('dp', 'tp') mesh, by name."""
    specs = {}
    for name, shape, _ in param_shapes(cfg):
        dim = _TP_DIM.get(name.rpartition(".")[2])
        spec = [None] * len(shape)
        if dim is not None:
            spec[dim] = "tp"
        specs[name] = placements(*spec)
    return specs


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


def heads_placements(t: DTensor, cfg: TransformerConfig) -> List[Placement]:
    """Where the per-head part of attention can run on each rank's own
    shard of q, k and v ([b, s, heads·head_dim]): the batch may stay split
    (Shard(0)) and the heads too (Shard(2)) when the mesh axis divides
    both the query and the KV heads; anything else is replicated.  GSPMD
    shards heads unevenly where they do not divide; DTensor's view
    refuses that, so such heads are replicated over the axis."""
    mesh = t.device_mesh
    want = []
    for i, p in enumerate(t.placements):
        n = mesh.size(i)
        keep = p.is_shard(0) or (p.is_shard(2) and cfg.n_heads % n == 0
                                 and cfg.n_kv_heads % n == 0)
        want.append(p if keep else Replicate())
    return want


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
        q, k, v = x @ lp.wq, x @ lp.wk, x @ lp.wv
        if isinstance(q, DTensor):
            # Every head attends within its own batch row: each rank runs
            # the heads of its shard (heads_placements), as plain tensors.
            want = heads_placements(q, self.cfg)
            q, k, v = (t.redistribute(placements=want) for t in (q, k, v))
            out = DTensor.from_local(
                self.attend(q.to_local(), k.to_local(), v.to_local(), cos,
                            sin, mask),
                q.device_mesh, want, run_check=False, shape=q.shape,
                stride=q.stride())
        else:
            out = self.attend(q, k, v, cos, sin, mask)
        return out @ lp.wo

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               cos: torch.Tensor, sin: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
        """Causal attention of [b, s, heads·head_dim] projections, any
        whole number of query heads and the KV heads that serve them."""
        cfg = self.cfg
        b, s, _ = q.shape
        q = q.view(b, s, -1, cfg.head_dim)
        k = k.view(b, s, -1, cfg.head_dim)
        v = v.view(b, s, -1, cfg.head_dim)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        rep = cfg.n_heads // cfg.n_kv_heads
        # jnp.repeat(k, rep, axis=2): each kv head serves `rep` adjacent
        # query heads.
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        if cfg.use_flash:
            return attention_bshd(q, k, v, causal=True).reshape(b, s, -1)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))   # [b, h, s, d]
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        scores = scores * (cfg.head_dim ** -0.5)
        scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.matmul(probs, v)
        return out.transpose(1, 2).reshape(b, s, -1)

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


def loss_fn(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy over the shifted sequence: the mean, over
    every position, of -log softmax(logits) at the next token (f32).
    With DTensor tokens each rank takes the rows of its batch shard whole
    (the vocab gathered over 'tp') and the sum over ranks is pending
    (Partial) until the loss is read."""
    logits = model(tokens[:, :-1])
    targets = tokens[:, 1:, None].long()
    if not isinstance(logits, DTensor):
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, targets).mean()
    rows = [p if p.is_shard(0) else Replicate() for p in logits.placements]
    logits = logits.redistribute(placements=rows)
    targets = targets.redistribute(placements=rows)
    logp = torch.log_softmax(logits.to_local(), dim=-1)
    total = -torch.gather(logp, -1, targets.to_local()).sum()
    return DTensor.from_local(
        total, logits.device_mesh,
        [Partial() if p.is_shard(0) else p for p in rows],
        run_check=False) / targets.numel()


def shard_params(model: Transformer, mesh: DeviceMesh) -> Transformer:
    """Place every weight of ``model`` on ``mesh`` as ``param_specs``
    says; the model is changed in place and returned."""
    specs = param_specs(model.cfg)
    for name, p in list(model.named_parameters()):
        owner_path, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_path) if owner_path else model
        setattr(owner, leaf, nn.Parameter(
            distribute_tensor(p.detach(), mesh, specs[name]),
            requires_grad=p.requires_grad))
    return model


def make_train_step(model: Transformer, mesh: Optional[DeviceMesh] = None,
                    lr: float = 1e-3
                    ) -> Tuple[Callable[[torch.Tensor], torch.Tensor],
                               torch.optim.Adam]:
    """``vtpu``'s Adam training step: (step, opt), where ``step(tokens)``
    takes a [batch, seq+1] block, runs the loss, its backward and one Adam
    update of ``model``'s weights in place, and returns the loss (a
    plain tensor).  Adam has optax's defaults (betas 0.9 and 0.999, eps
    1e-8, no weight decay) and keeps its moments in each weight's dtype,
    as optax does.  With a mesh the weights must already be placed
    (``shard_params``), and the block is split over 'dp'."""
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8, weight_decay=0.0)
    data = None if mesh is None else placements("dp", axes=mesh.mesh_dim_names)

    def step(tokens: torch.Tensor) -> torch.Tensor:
        if data is not None:
            tokens = distribute_tensor(tokens, mesh, data)
        loss = loss_fn(model, tokens)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        loss = loss.detach()
        return loss.full_tensor() if isinstance(loss, DTensor) else loss

    return step, opt


def state_bytes(cfg: TransformerConfig) -> int:
    """Bytes of all weights of ``cfg``."""
    return sum(math.prod(shape) * dtype.itemsize
               for _, shape, dtype in param_shapes(cfg))
