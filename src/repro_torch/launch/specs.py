"""Smoke batches for the LM substrate: a port of the reference's
``launch/specs.py`` ``input_specs`` / ``concrete_batch`` for the dense and
encdec families, drawing the same numbers from the same numpy seed."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..kernels import ops


def input_specs(cfg: ArchConfig, shape: ShapeConfig
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """name -> (shape, dtype) of one serving cell's batch (``prefill`` or
    ``decode``), in the reference's key order. Decode shapes describe ONE
    new token against a KV cache of ``shape.seq_len``."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if cfg.family not in ("dense", "encdec") or shape.kind == "train":
        raise NotImplementedError(
            f"{shape.kind} batches of the {cfg.family} family are not "
            f"ported yet (ROADMAP queue 1 item 3)")
    if shape.kind == "decode":
        return {"token": ((B, 1), i32), "pos": ((B,), i32)}
    if cfg.family == "encdec":
        return {"frames": ((B, S, cfg.d_model), torch.bfloat16),
                "tokens": ((B, S), i32)}
    return {"tokens": ((B, S), i32)}


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
            hi = cfg.vocab if k in ("tokens", "token") else \
                max(shape.seq_len, 2)
            a = r.integers(0, hi, size=s, dtype=np.int32)
        else:
            a = r.normal(0, 1, size=s).astype(np.float32)
        out[k] = torch.from_numpy(a).to(device=dev, dtype=dt)
    return out
