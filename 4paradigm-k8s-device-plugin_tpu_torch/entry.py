"""Entry points of the port: one forward of the tiny model, and the greedy
serving loop of a quota-enforced tenant.

- ``entry(device)`` is the twin of ``__graft_entry__.entry()``: the tiny
  config's model and example tokens, ``fn(*args)`` runs one forward.
- ``serve(cfg, batch, seq, steps, device)`` is the greedy next-token loop
  that ``bench.py`` times (``_direct_loop``): each step feeds back
  ``argmax(forward(tokens), -1)``, so the steps form one dependency
  chain on the device.  When the environment sets a quota (the Allocate
  env contract, ``utils.envspec``), the weights are admitted against the
  HBM cap tensor by tensor and every step is gated on the compute share;
  in a process started under the native interposer
  (``shim.interposer.tenant_env``) the interposer enforces the quota
  instead, with no call of ``serve``'s, and ``serve`` reads its ledger
  from the region.

Both run on the card unless the caller passes ``device="cpu"``; asking for
CUDA on a machine without a card raises.

    python -m vtpu_torch.entry --cfg llama3_8b --batch 2 --seq 512 --steps 4
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from .models.convert import init_module, params_from_numpy
from .models.transformer import TransformerConfig
from .ops.flash_attention import flash_attention
from .shim.pyshim import install_torch_enforcement, region_ledger


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA card "
                           "is available (pass device='cpu' to run on the "
                           "CPU)")
    return dev


def _config(cfg: Union[str, TransformerConfig]) -> TransformerConfig:
    return cfg if isinstance(cfg, TransformerConfig) else getattr(
        TransformerConfig, cfg)()


def entry(device="cuda"):
    """(model, (tokens,)): one forward of the tiny transformer."""
    dev = _device(device)
    cfg = TransformerConfig.tiny()
    model = init_module(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.zeros((2, 32), dtype=torch.int32, device=dev)
    return model, (tokens,)


def serve(cfg: Union[str, TransformerConfig] = "llama3_8b", batch: int = 2,
          seq: int = 512, steps: int = 4, device="cuda",
          use_flash: bool = True, seed: int = 0,
          weights: Optional[Dict[str, Any]] = None,
          prompt: Optional[np.ndarray] = None) -> Dict[str, Any]:
    """Run ``steps`` greedy steps of ``cfg`` on a [batch, seq] token block.

    Weights come from ``weights`` (``vtpu``'s pytree as numpy arrays) or
    are drawn from ``seed``; the first block is ``prompt`` or zeros.
    Returns the final tokens, the steps per second after the first step,
    the attention kernel's launches in this run, the enforcer (None
    without a quota, or under the interposer), the region ledger (None
    without a quota) and the model."""
    dev = _device(device)
    cfg = dataclasses.replace(_config(cfg), use_flash=use_flash)
    enf = install_torch_enforcement()
    if weights is not None:
        model = params_from_numpy(weights, cfg, dev, enf)
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)
        model = init_module(cfg, gen, dev, enf)

    def step(tokens):
        return torch.argmax(model(tokens), dim=-1).int()

    if enf is not None:
        step = enf.gated(step)
    start = np.zeros((batch, seq), np.int32) if prompt is None else prompt
    tokens = torch.as_tensor(start, dtype=torch.int32).to(dev)
    launches0 = flash_attention.launches
    rate = float("nan")
    with torch.inference_mode():
        for i in range(steps):
            if i == 1:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t0 = time.monotonic()
            tokens = step(tokens)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if steps > 1:
            rate = (steps - 1) / (time.monotonic() - t0)
    return {
        "tokens": tokens.cpu(),
        "steps_per_s": rate,
        "launches": flash_attention.launches - launches0,
        "ledger": (enf.ledger(enf.dev_of(dev)) if enf is not None
                   else region_ledger(dev.index)),
        "enforcer": enf,
        "model": model,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cfg", default="llama3_8b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-flash", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    out = serve(args.cfg, args.batch, args.seq, args.steps, args.device,
                use_flash=not args.no_flash, seed=args.seed)
    print(json.dumps({"cfg": args.cfg, "tokens_shape": list(out["tokens"].shape),
                      "steps_per_s": out["steps_per_s"],
                      "launches": out["launches"], "ledger": out["ledger"]}))


if __name__ == "__main__":
    main()
