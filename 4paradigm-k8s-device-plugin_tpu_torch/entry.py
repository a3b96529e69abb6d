"""Entry points of the port: one forward of the tiny model, the greedy
serving loop and the training loop of a quota-enforced tenant, and the
sharded training dry-run.

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
- ``train(cfg, batch, seq, steps, device)`` takes ``steps`` Adam steps
  (``transformer.make_train_step``) on one fixed [batch, seq+1] block,
  under the quota as ``serve`` is: weights admitted, steps gated.
- ``serve_brokered(client, cfg, batch, seq, steps)`` is ``bench.py``'s
  brokered transformer tenant: a process that never opens the card sends
  its weights to a broker (``runtime.server``) as PUTs, or has the broker
  make them with a no-argument init program, compiles the greedy step as
  a ``torch.export`` graph (the weights are its arguments), and runs the
  steps as broker-side chains of ``chain`` steps, ``depth`` chains in
  flight.
- ``dryrun_multichip(n, device)`` is the twin of
  ``__graft_entry__.dryrun_multichip``'s unbrokered half: one Adam step
  of the tiny model sharded over an n-device ('dp','tp') mesh.

All but ``serve_brokered`` run on the card unless the caller passes
``device="cpu"``; asking for CUDA on a machine without a card raises.
``serve_brokered`` runs where its broker runs.

    python -m vtpu_torch.entry --cfg llama3_8b --batch 2 --seq 512 --steps 4
    python -m vtpu_torch.entry --train --cfg bench --batch 4 --seq 512
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from .models.convert import (_flatten, init_module, init_program,
                             params_from_numpy, tensor_from_numpy)
from .models.transformer import (TransformerConfig, functional_forward,
                                 make_train_step, param_shapes, shard_params)
from .ops.flash_attention import flash_attention
from .parallel.mesh import make_mesh, run_group
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


def _tenant(cfg: TransformerConfig, dev: torch.device, seed: int,
            weights: Optional[Dict[str, Any]], trainable: bool):
    """(model, enforcer): ``cfg``'s model on ``dev`` under the
    environment's quota.  Weights come from ``weights`` (``vtpu``'s pytree
    as numpy arrays) or are drawn from ``seed``; under the pyshim they are
    admitted against the HBM cap tensor by tensor.  The enforcer is None
    without a quota, or under the interposer."""
    enf = install_torch_enforcement()
    if weights is not None:
        model = params_from_numpy(weights, cfg, dev, enf, trainable=trainable)
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)
        model = init_module(cfg, gen, dev, enf, trainable=trainable)
    return model, enf


def _ledger(enf, dev: torch.device):
    """The region's ledger of ``dev`` (None without a quota)."""
    return (enf.ledger(enf.dev_of(dev)) if enf is not None
            else region_ledger(dev.index))


def _gated(enf, fn):
    """``fn`` gated on the compute share under the pyshim (as is without
    it); the device is that of its first tensor argument."""
    return enf.gated(fn) if enf is not None else fn


def _timed(body, steps: int, dev: torch.device) -> float:
    """Call ``body()`` ``steps`` times; returns the steps per second after
    the first (NaN for one step), the card drained before each reading
    of the clock."""

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rate = float("nan")
    for i in range(steps):
        if i == 1:
            sync()
            t0 = time.monotonic()
        body()
    sync()
    if steps > 1:
        rate = (steps - 1) / (time.monotonic() - t0)
    return rate


def serve(cfg: Union[str, TransformerConfig] = "llama3_8b", batch: int = 2,
          seq: int = 512, steps: int = 4, device="cuda",
          use_flash: bool = True, seed: int = 0,
          weights: Optional[Dict[str, Any]] = None,
          prompt: Optional[np.ndarray] = None) -> Dict[str, Any]:
    """Run ``steps`` greedy steps of ``cfg`` on a [batch, seq] token block.

    Weights come from ``weights`` or ``seed`` (``_tenant``); the first
    block is ``prompt`` or zeros.  Returns the final tokens, the steps per
    second after the first step, the attention kernel's launches in this
    run, the enforcer (None without a quota, or under the interposer),
    the region ledger (None without a quota) and the model."""
    dev = _device(device)
    cfg = dataclasses.replace(_config(cfg), use_flash=use_flash)
    model, enf = _tenant(cfg, dev, seed, weights, trainable=False)
    start = np.zeros((batch, seq), np.int32) if prompt is None else prompt
    tokens = torch.as_tensor(start, dtype=torch.int32).to(dev)

    step = _gated(enf, lambda t: torch.argmax(model(t), dim=-1).int())

    def body():
        nonlocal tokens
        tokens = step(tokens)

    launches0 = flash_attention.launches
    with torch.inference_mode():
        rate = _timed(body, steps, dev)
    return {
        "tokens": tokens.cpu(),
        "steps_per_s": rate,
        "launches": flash_attention.launches - launches0,
        "ledger": _ledger(enf, dev),
        "enforcer": enf,
        "model": model,
    }


def train(cfg: Union[str, TransformerConfig] = "bench", batch: int = 4,
          seq: int = 512, steps: int = 4, device="cuda", lr: float = 1e-3,
          seed: int = 0, weights: Optional[Dict[str, Any]] = None,
          tokens: Optional[np.ndarray] = None) -> Dict[str, Any]:
    """Take ``steps`` Adam steps of ``cfg`` on one [batch, seq+1] block.

    Weights come from ``weights`` or ``seed`` (``_tenant``); the block is
    ``tokens`` or drawn from ``seed``.  Attention is the plain one (the
    fused kernel has no backward).  Returns the loss of each step, the
    steps and tokens per second after the first step, the ledger after
    each step and at the end (None without a quota), the enforcer and
    the model."""
    dev = _device(device)
    cfg = dataclasses.replace(_config(cfg), use_flash=False)
    model, enf = _tenant(cfg, dev, seed, weights, trainable=True)
    step = _gated(enf, make_train_step(model, lr=lr)[0])
    if tokens is None:
        tokens = np.random.default_rng(seed).integers(
            0, cfg.vocab, (batch, seq + 1), dtype=np.int32)
    block = torch.as_tensor(tokens, dtype=torch.int32).to(dev)
    losses, ledgers = [], []

    def body():
        losses.append(step(block))
        ledgers.append(_ledger(enf, dev))

    rate = _timed(body, steps, dev)
    return {
        "losses": [float(x) for x in losses],
        "steps_per_s": rate,
        "tokens_per_s": rate * block.shape[0] * (block.shape[1] - 1),
        "step_ledgers": ledgers,
        "ledger": _ledger(enf, dev),
        "enforcer": enf,
        "model": model,
    }


def greedy_program(cfg: TransformerConfig):
    """``fn(tokens, *weights) -> next tokens``: one greedy step."""
    forward = functional_forward(cfg)

    def fn(tokens, *weights):
        return torch.argmax(forward(tokens, *weights), dim=-1).int()

    return fn


def serve_brokered(client,
                   cfg: Union[str, TransformerConfig] = "bench",
                   batch: int = 4, seq: int = 512, steps: int = 8,
                   weights: Optional[Dict[str, Any]] = None, seed: int = 0,
                   init: str = "program", chain: int = 4, depth: int = 2,
                   seconds: Optional[float] = None,
                   prompt: Optional[np.ndarray] = None,
                   on_ready=None, on_chain=None) -> Dict[str, Any]:
    """Serve ``cfg`` greedily as the tenant of ``client`` (an open
    ``runtime.client.RuntimeClient``, whose HELLO set the grant), on the
    flash path (K1 runs in the broker).

    Weights: ``weights`` (``vtpu``'s pytree, numpy arrays or CPU tensors)
    as PUTs; else ``init="put"`` draws them here on the CPU from ``seed``
    (``init_module``) and PUTs them; else the broker runs
    ``init_program(cfg, seed)`` and they never cross the socket.  The
    first block is ``prompt`` or zeros.  The steps run as chains of
    ``chain`` steps (``repeats=chain``, ``carry=((0, 0),)``), ``depth``
    in flight; ``seconds`` runs chains until that long has passed
    instead of ``steps``.  ``chain=1`` sends one unchained execute a step,
    which a client with a fastlane lane sends over the ring.
    ``on_ready()`` is called once the weights are in place and the
    program compiled, before the first chain;
    ``on_chain(n)`` after each chain's tokens are fetched, ``n`` the
    steps done, and a true return sends no more chains.

    Each chain's reply (sent at its dispatch) is read before the next
    chain is sent, so no two chains share a dispatch, a metering batch or
    a GET's wait; the oldest chain's tokens are then fetched (a GET waits
    for that chain alone) while the next one, already queued behind it on
    the card, runs, so ``depth`` chains stay in flight.  Those tokens are
    what a restart resumes from: an execute's outputs are not journaled,
    so on a ``VtpuConnectionLost`` (the broker restarted and the journal
    resumed this tenant, or the connection dropped) the chains in flight
    are gone, and the last fetched tokens are PUT again and the chains
    sent again from there (so is a chain whose reply came from the old
    broker and whose output was NOT_FOUND on the new one).  A
    ``VtpuStateLost`` (the tenant's weights and program are gone) is
    raised; so is the NOT_FOUND of weights made by the init program,
    which are outputs too and do not survive a restart.  The client
    stays open.

    Returns the final tokens and those of the chain before (None after
    one chain), the steps run, the steps per second after the first
    chain, the device time booked to the tenant in that window
    (``busy_us`` of STATS) beside the window, the tenant's STATS row at
    the end, the weights' ids, the step program, the init program (None
    when the weights were PUT), the seconds the weights and the compile took, each
    fetched chain's (steps done, monotonic time) and each resume's step,
    time and error."""
    from .runtime.client import (RuntimeError_, VtpuConnectionLost,
                                 VtpuStateLost)

    cfg = dataclasses.replace(_config(cfg), use_flash=True)
    names = [name for name, _, _ in param_shapes(cfg)]
    init_exe = None
    t_setup = time.monotonic()
    if weights is not None or init == "put":
        if weights is None:
            model = init_module(cfg, torch.Generator().manual_seed(seed),
                                "cpu")
            flat = dict(model.named_parameters())
        else:
            flat = _flatten(weights)
        param_ids = [client.put(tensor_from_numpy(flat[n]), f"w.{n}").id
                     for n in names]
    else:
        init_exe = client.compile(init_program(cfg, seed), [])
        outs = init_exe()
        param_ids = [h.id for h in outs]
    start = np.zeros((batch, seq), np.int32) if prompt is None else prompt
    tokens = torch.as_tensor(start, dtype=torch.int32)
    client.put(tokens, "tok0")
    meta = [torch.empty((batch, seq), dtype=torch.int32, device="meta")]
    meta += [torch.empty(shape, dtype=dtype, device="meta")
             for _, shape, dtype in param_shapes(cfg)]
    t_compile = time.monotonic()
    exe = client.compile(greedy_program(cfg), meta)
    setup_s = {"weights": t_compile - t_setup,
               "compile": time.monotonic() - t_compile}
    ids = {"cur": "tok0", "nxt": "tok1"}
    sent, done, timed = 0, 0, 0
    chains: "collections.deque" = collections.deque()
    prev = None
    chain_times, resumes = [], []
    stop = False

    # The broker epoch the last tokens and the chains in flight belong
    # to: a request may resume under a new one transparently (an
    # idempotent STATS, GET or PUT), and then nothing in flight survived.
    live = client.epoch

    def restart(why: str, resumed: bool) -> None:
        """Drop the chains in flight and PUT the last tokens again."""
        nonlocal sent, live
        resumes.append({"at_step": done, "t": time.monotonic(),
                        "resumed": resumed, "error": why})
        chains.clear()
        ids["cur"], ids["nxt"] = "tok0", "tok1"
        client.put(tokens, "tok0")
        live = client.epoch
        sent = done

    def lost(e: Exception) -> bool:
        """Whether ``e`` means the broker went away under this request
        (the chains are then sent again), not the tenant's own error."""
        if isinstance(e, VtpuStateLost) or not (
                isinstance(e, VtpuConnectionLost)
                or client.epoch != live):
            return False
        restart(str(e), bool(getattr(e, "resumed", True)))
        return True

    def send(k: int) -> None:
        nonlocal sent
        if client.epoch != live:
            restart(f"epoch {live} -> {client.epoch}", True)
        try:
            client.execute_send_ids(exe.id, [ids["cur"]] + param_ids,
                                    [ids["nxt"]], repeats=k,
                                    carry=((0, 0),))
            client.execute_recv()
        except RuntimeError_ as e:
            if not lost(e):
                raise
            return
        chains.append((k, ids["nxt"]))
        ids["cur"], ids["nxt"] = ids["nxt"], ids["cur"]
        sent += k

    def fetch() -> int:
        """The oldest chain's tokens; 0 when the broker went away (the
        chains are sent again from the last tokens)."""
        nonlocal tokens, prev, done, stop
        if client.epoch != live:
            restart(f"epoch {live} -> {client.epoch}", True)
            return 0
        k, out = chains[0]
        try:
            got = client.get(out)
        except RuntimeError_ as e:
            if not lost(e):
                raise
            return 0
        chains.popleft()
        prev, tokens, done = tokens, got, done + k
        chain_times.append((done, time.monotonic()))
        if on_chain is not None and on_chain(done):
            stop = True
        return k

    def more(t0: float) -> bool:
        if stop:
            return False
        if seconds is None:
            return sent < steps
        return time.monotonic() - t0 < seconds

    if on_ready is not None:
        on_ready()
    # The first chain carries the program's first run, untimed.
    first = chain if seconds is not None else min(chain, steps)
    while done < first:
        if not chains:
            send(first)
        if chains:
            fetch()
    busy0 = client.stats()[client.tenant]["busy_us"]
    t0 = time.monotonic()
    while True:
        if more(t0) and len(chains) < depth:
            send(chain if seconds is not None
                 else min(chain, steps - sent))
            continue
        if not chains:
            break
        timed += fetch()
    # STATS waits until the broker has metered every dispatched step.
    stats = client.stats()[client.tenant]
    window = time.monotonic() - t0
    return {
        "tokens": tokens,
        "prev_tokens": prev if done > first else None,
        "steps": done,
        "steps_per_s": timed / window if timed else float("nan"),
        "booked_us": stats["busy_us"] - busy0,
        "window_s": window,
        "stats": stats,
        "param_ids": param_ids,
        "exe": exe,
        "init_exe": init_exe,
        "setup_s": setup_s,
        "chain_times": chain_times,
        "resumes": resumes,
    }


def _dryrun(n_devices: int, device_type: str) -> float:
    """One Adam step of the tiny model over an n-device mesh of the
    current process group; returns the loss."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))
    mesh = make_mesh(n_devices, device_type=device_type)
    cfg = TransformerConfig.tiny()
    model = init_module(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                        trainable=True)
    shard_params(model, mesh)
    step, _ = make_train_step(model, mesh=mesh)
    batch = mesh.size(0) * 2
    loss = float(step(torch.zeros((batch, 33), dtype=torch.int32,
                                  device=dev)))
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    return loss


def dryrun_multichip(n_devices: int, device="cuda") -> float:
    """The full training step (loss, gradients, Adam update) over an
    n-device ('dp','tp') mesh with ``vtpu``'s tensor-parallel weight
    placements and the batch split over 'dp', one step on zeros of
    [dp·2, 33]; returns the loss, which must be finite.

    Runs in the current process group when it has n ranks; otherwise
    starts n workers (gloo on the CPU, NCCL on CUDA, one card each) and
    fails if they have not finished within ``mesh.GROUP_TIMEOUT_S``
    seconds."""
    dev_type = _device(device).type
    if dist.is_initialized() and dist.get_world_size() == n_devices:
        return _dryrun(n_devices, dev_type)
    if dev_type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"need {n_devices} CUDA cards, have "
                           f"{torch.cuda.device_count()}")
    return run_group(n_devices, _dryrun, (n_devices, dev_type), dev_type)[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train", action="store_true",
                    help="take Adam steps instead of serving")
    ap.add_argument("--cfg", default=None,
                    help="llama3_8b when serving, bench when training")
    ap.add_argument("--batch", type=int, default=None,
                    help="2 when serving, 4 when training")
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-flash", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.train:
        cfg = args.cfg or "bench"
        out = train(cfg, args.batch or 4, args.seq, args.steps, args.device,
                    seed=args.seed)
        print(json.dumps({"cfg": cfg, "losses": out["losses"],
                          "steps_per_s": out["steps_per_s"],
                          "tokens_per_s": out["tokens_per_s"],
                          "ledger": out["ledger"]}))
        return
    cfg = args.cfg or "llama3_8b"
    out = serve(cfg, args.batch or 2, args.seq, args.steps, args.device,
                use_flash=not args.no_flash, seed=args.seed)
    print(json.dumps({"cfg": cfg, "tokens_shape": list(out["tokens"].shape),
                      "steps_per_s": out["steps_per_s"],
                      "launches": out["launches"], "ledger": out["ledger"]}))


if __name__ == "__main__":
    main()
