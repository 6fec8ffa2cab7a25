"""End-to-end trainer, ported from the reference's ``launch/train.py``:
the synthetic token stream -> train step -> checkpoints, with
fault-tolerant restart and deterministic replay.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch qwen2-7b --smoke --steps 20 --batch 2 --seq 64

Runs on ``cuda`` unless ``--device`` says otherwise; ``--backend`` picks
the attention arm (``cuda`` kernels or plain ``torch``; default: the
kernels on a card); ``--layers`` cuts the depth (a model too deep for one
card). The weights are float32 masters drawn from ``--seed``, computed in
the config's dtype. Otherwise the reference's flags, with its defaults;
its prefetching loader is not started, as no step reads from it (each
step's batch is drawn for that step, so a replay sees the same batches).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from ..checkpoint import ckpt
from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..data.tokens import SyntheticTokens
from ..distributed.fault import (FaultInjector, StragglerWatchdog,
                                 resilient_loop)
from ..kernels import ops
from ..launch.steps import make_train_step
from ..models import lm
from ..optim import adamw


def train_batch(cfg, tokens, dev):
    """A ``SyntheticTokens`` batch (``tokens``, ``labels`` numpy (B, S)) on
    ``dev``, with the reference trainer's extra inputs: zero bf16 vision
    embeddings in front of a vlm's text and (3, B, S + nv) positions
    counting through both; zero bf16 frames (B, S, D) for encdec."""
    b = {k: torch.from_numpy(v).to(dev) for k, v in tokens.items()
         if k != "step"}
    B, S = b["tokens"].shape
    if cfg.family == "vlm":
        nv = cfg.n_vision_tokens
        b["vision_embeds"] = torch.zeros((B, nv, cfg.d_model),
                                         dtype=torch.bfloat16, device=dev)
        b["positions3d"] = torch.arange(
            S + nv, dtype=torch.int32, device=dev)[None, None].expand(
            3, B, S + nv)
    if cfg.family == "encdec":
        b["frames"] = torch.zeros((B, S, cfg.d_model), dtype=torch.bfloat16,
                                  device=dev)
    return b


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--remat", default="none", choices=lm.REMATS)
    ap.add_argument("--inject-fault-at", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=ops.BACKENDS)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the "
                         "config's)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    dev = ops.resolve_device(args.device)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                warmup_steps=max(args.steps // 20, 5))

    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), dev, param_dtype=torch.float32)
    opt_state = adamw.init_state(dict(params.named_parameters()), opt_cfg)
    print(f"[train] {cfg.name}: {lm.param_count(params):,} params")

    raw_step = make_train_step(cfg, opt_cfg, args.backend, remat=args.remat)
    source = SyntheticTokens(cfg.vocab, seed=args.seed)
    ckpt_dir = args.ckpt_dir or os.path.join("experiments", "ckpt", cfg.name)

    def tree(state):
        params, opt_state = state
        return {"params": dict(params.named_parameters()),
                "opt": opt_state}

    def step_fn(state, batch):
        params, opt_state = state
        params, opt_state, metrics = raw_step(
            params, opt_state, train_batch(cfg, batch, dev))
        return (params, opt_state), metrics

    def save_fn(state, step):
        ckpt.save(ckpt_dir, tree(state), step)

    def restore_fn():
        """The latest checkpoint copied into the live tensors (the step
        updates them in place)."""
        step = ckpt.latest_step(ckpt_dir)
        if step is None:
            return None
        live = tree((params, opt_state))
        saved, step = ckpt.restore(ckpt_dir, live, step)
        live = ckpt.flatten(live)
        with torch.no_grad():
            for name, t in ckpt.flatten(saved).items():
                live[name].copy_(t)
        return (params, opt_state), step

    injector = FaultInjector(
        [args.inject_fault_at] if args.inject_fault_at >= 0 else [])
    watchdog = StragglerWatchdog()

    def batch_for_step(step):
        # deterministic in step -> replay after restart is bit-identical
        return source.batch(step, args.batch, args.seq)

    t0 = time.time()
    (params, opt_state), history = resilient_loop(
        step_fn, (params, opt_state), batch_for_step, args.steps,
        save_fn, restore_fn, ckpt_every=args.ckpt_every,
        injector=injector, watchdog=watchdog)
    wall = time.time() - t0

    losses = [h["loss"] for h in history]
    print(f"[train] {len(history)} steps in {wall:.1f}s | "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} | "
          f"injected faults: {injector.injected} | "
          f"stragglers: {len(watchdog.stragglers)}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"history": history, "wall_s": wall,
                       "injected": injector.injected}, f)
    return history


if __name__ == "__main__":
    main()
