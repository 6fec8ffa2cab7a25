"""Batched serving loop, ported from the reference's ``launch/serve.py``:
prefill a batch of prompts through the decode path, then greedy-decode
with the per-family cache (KV / SSM state / hybrid).

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch mamba2-130m --smoke --batch 4 --prompt-len 32 --gen 16

Runs on ``cuda`` unless ``--device`` says otherwise; ``--backend`` picks
the attention arm (``cuda`` kernels or plain ``torch``; default: the
kernels on a card). Weights are random, drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..kernels import ops
from ..launch.steps import make_serve_step
from ..models import lm


def generate(cfg, params, prompts: np.ndarray, gen: int, cache_len: int,
             *, backend: Optional[str] = None, rt=None) -> np.ndarray:
    """prompts (B, P) -> generated tokens (B, gen). Greedy. The prompt is
    consumed through the decode path token-by-token (prefill-by-decode),
    as in the reference; a vlm step's rope positions are (t, t, t).
    ``rt``: the runtime whose mesh the parameters are distributed on (the
    cache is laid out on it)."""
    B, P = prompts.shape
    dev = params.embed.table.device
    cache = lm.init_cache(cfg, B, cache_len, dev, rt=rt)
    step = make_serve_step(cfg, backend, rt)
    prompts_d = torch.as_tensor(np.asarray(prompts, np.int32), device=dev)
    tok = prompts_d[:, :1]
    out = []
    for t in range(P + gen - 1):
        batch = {"token": tok,
                 "pos": torch.full((B,), t, dtype=torch.int32, device=dev)}
        if cfg.family == "vlm":
            batch["positions3d"] = torch.full((3, B, 1), t,
                                              dtype=torch.int32, device=dev)
        nxt, cache = step(params, cache, batch)
        if t + 1 < P:
            tok = prompts_d[:, t + 1: t + 2]
        else:
            tok = nxt
            out.append(nxt[:, 0])
    return torch.stack(out, dim=1).cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the "
                         "config's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=ops.BACKENDS)
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if cfg.family == "encdec":
        raise SystemExit("encdec is served through prefill_fn / decode_fn, "
                         "not this prompt loop")
    dev = ops.resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = lm.init_params(cfg, gen, dev)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len),
                           dtype=np.int32)
    t0 = time.perf_counter()
    toks = generate(cfg, params, prompts, args.gen, args.cache_len,
                    backend=args.backend)
    dt = time.perf_counter() - t0
    n = args.batch * (args.prompt_len + args.gen)
    print(f"[serve] {cfg.name}: {toks.shape} generated, "
          f"{n / dt:.1f} tok/s, sample: {toks[0][:8].tolist()}")
    return toks


if __name__ == "__main__":
    main()
