"""Step functions (train / prefill / serve) shared by the trainer, the
server and their tests, ported from the reference's ``launch/steps.py``.
``backend`` picks the attention arm (:func:`repro_torch.models.layers.
attention`)."""

from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..models import lm
from ..optim import adamw


def loss_and_grads(params, batch, cfg: ArchConfig,
                   backend: Optional[str] = None, **loss_kw):
    """(loss, {name: gradient}) of :func:`lm.loss_fn` for every parameter
    (zeros where a parameter does not reach the loss), forward and
    backward with TF32 off. Turns on the parameters' ``requires_grad``."""
    params.requires_grad_(True)
    named = dict(params.named_parameters())
    with lm.full_fp32():
        loss = lm.loss_fn(params, batch, cfg, backend, **loss_kw)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
    return loss.detach(), {
        n: torch.zeros_like(p) if g is None else g
        for (n, p), g in zip(named.items(), grads)}


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                    backend: Optional[str] = None, *, loss_chunk: int = 0,
                    remat: str = "none"):
    """(params, opt_state, batch) -> (params, opt_state, metrics): the loss
    and gradients (:func:`loss_and_grads`), then ``adamw.apply_updates``
    in place, in the reference's layout (``lm.reference_layout``).
    ``metrics``: ``loss``, ``grad_norm``, ``lr``."""
    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch, cfg, backend,
                                     loss_chunk=loss_chunk, remat=remat)
        _, opt_state, metrics = adamw.apply_updates(
            dict(params.named_parameters()), grads, opt_state, opt_cfg,
            lm.reference_layout(params))
        metrics["loss"] = loss
        return params, opt_state, metrics
    return train_step


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
