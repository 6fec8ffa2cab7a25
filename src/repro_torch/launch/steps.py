"""Step functions (prefill / serve) shared by the server and its tests,
ported from the reference's ``launch/steps.py``. ``backend`` picks the
attention arm (:func:`repro_torch.models.layers.attention`)."""

from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..models import lm


def make_prefill_step(cfg: ArchConfig, backend: Optional[str] = None):
    def prefill_step(params, batch):
        logits, _ = lm.prefill_fn(params, batch, cfg, backend)
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return prefill_step


def make_serve_step(cfg: ArchConfig, backend: Optional[str] = None):
    """One greedy decode step: (params, cache, {token,pos,...}) ->
    (next_token (B, 1) int32, cache)."""
    def serve_step(params, cache, batch):
        logits, new_cache = lm.decode_fn(params, cache, batch, cfg, backend)
        return torch.argmax(logits, dim=-1).to(torch.int32), new_cache
    return serve_step
