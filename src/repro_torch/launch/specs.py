"""Smoke batches for the LM substrate: a port of the reference's
``launch/specs.py`` ``input_specs`` / ``concrete_batch`` for every cell
kind (``train``, ``prefill``, ``decode``) of every family, drawing the
same numbers from the same numpy seed in the same key order."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..kernels import ops


def input_specs(cfg: ArchConfig, shape: ShapeConfig
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """name -> (shape, dtype) of one cell's batch, in the reference's key
    order. Decode shapes describe ONE new token against a KV cache of
    ``shape.seq_len``; a vlm's vision tokens count in ``seq_len``."""
    B, S = shape.global_batch, shape.seq_len
    kind = shape.kind
    i32, bf16 = torch.int32, torch.bfloat16
    if cfg.family == "encdec":
        if kind == "decode":
            return {"token": ((B, 1), i32), "pos": ((B,), i32)}
        out = {"frames": ((B, S, cfg.d_model), bf16),
               "tokens": ((B, S), i32)}
        if kind == "train":
            out["labels"] = ((B, S), i32)
        return out
    if cfg.family == "vlm":
        nv = cfg.n_vision_tokens
        if kind == "decode":
            return {"token": ((B, 1), i32), "pos": ((B,), i32),
                    "positions3d": ((3, B, 1), i32)}
        out = {"tokens": ((B, S - nv), i32)}   # text; the total stays S
        if kind == "train":
            out["labels"] = ((B, S - nv), i32)
        out.update(vision_embeds=((B, nv, cfg.d_model), bf16),
                   positions3d=((3, B, S), i32))
        return out
    if kind == "train":
        return {"tokens": ((B, S), i32), "labels": ((B, S), i32)}
    if kind == "prefill":
        return {"tokens": ((B, S), i32)}
    return {"token": ((B, 1), i32), "pos": ((B,), i32)}


def concrete_batch(cfg: ArchConfig, shape: ShapeConfig, rng=None,
                   device=None) -> Dict[str, torch.Tensor]:
    """A random batch matching :func:`input_specs` on ``device`` (``cuda``
    unless given): the reference's numbers from ``default_rng(rng or 0)``,
    float inputs rounded to their bf16 spec as the reference's are."""
    dev = ops.resolve_device(device)
    r = np.random.default_rng(0 if rng is None else rng)
    out = {}
    for k, (s, dt) in input_specs(cfg, shape).items():
        if dt == torch.int32:
            hi = cfg.vocab if k in ("tokens", "labels", "token") else \
                max(shape.seq_len, 2)
            a = r.integers(0, hi, size=s, dtype=np.int32)
        else:
            a = r.normal(0, 1, size=s).astype(np.float32)
        out[k] = torch.from_numpy(a).to(device=dev, dtype=dt)
    return out
