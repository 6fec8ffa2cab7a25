"""Step functions (train / prefill / serve) shared by the trainer, the
server, the dry run and their tests, ported from the reference's
``launch/steps.py``. ``backend`` picks the attention arm
(:func:`repro_torch.models.layers.attention`); ``rt``, the reference's
:class:`~repro_torch.distributed.sharding.Runtime`, its mesh: each step
then splits the batch it is given (every rank holds it alike) by
``batch_specs`` and returns plain tensors, the same on every rank."""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.distributed.tensor import DTensor
from torch.nn.utils.stateless import _reparametrize_module

from ..configs.base import ArchConfig
from ..distributed.sharding import NO_MESH, Runtime
from ..models import lm
from ..optim import adamw


def _whole(t):
    """A DTensor's full value on every rank; a tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def bf16_casts(params):
    """``bf16_gather``'s casts: each float32 parameter whose leaf in the
    reference's stacked layout has rank 2 or more, cast to bf16 (a block's
    norm gain (D,) is a slice of an (L, D) leaf, so it is cast too)."""
    layout = lm.reference_layout(params)
    return {n: p.to(torch.bfloat16) for n, p in params.named_parameters()
            if layout[n][1] >= 2 and p.dtype == torch.float32}


def loss_and_grads(params, batch, cfg: ArchConfig,
                   backend: Optional[str] = None,
                   rt: Optional[Runtime] = None, **loss_kw):
    """(loss, {name: gradient}) of :func:`lm.loss_fn` for every parameter
    (zeros where a parameter does not reach the loss), forward and
    backward with TF32 off. Turns on the parameters' ``requires_grad``.
    Under ``rt``'s mesh the batch is split first, each gradient comes back
    on its parameter's placements (the data-parallel sums and the FSDP
    reduce-scatters), and with ``rt.bf16_gather`` the float32 masters of
    rank 2 or more in the reference's layout enter the forward as bf16
    casts of their shards, so that their gathers move half the bytes."""
    rt = rt or NO_MESH
    params.requires_grad_(True)
    named = dict(params.named_parameters())
    batch = rt.shard_batch(batch, "train", cfg)
    casts = bf16_casts(params) if rt.bf16_gather else {}
    swap = _reparametrize_module(params, casts) if casts else \
        contextlib.nullcontext()
    with lm.full_fp32(), swap:
        loss = lm.loss_fn(params, batch, cfg, backend, rt=rt, **loss_kw)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
    out = {}
    for (n, p), g in zip(named.items(), grads):
        if g is None:
            g = torch.zeros_like(p)
        elif isinstance(p, DTensor) and tuple(g.placements) != \
                tuple(p.placements):
            g = g.redistribute(p.device_mesh, p.placements)
        out[n] = g
    return _whole(loss.detach()), out


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                    backend: Optional[str] = None, *,
                    loss_chunk: Optional[int] = None,
                    remat: Optional[str] = None,
                    rt: Optional[Runtime] = None):
    """(params, opt_state, batch) -> (params, opt_state, metrics): the loss
    and gradients (:func:`loss_and_grads`), then ``adamw.apply_updates``
    in place, in the reference's layout (``lm.reference_layout``).
    ``metrics``: ``loss``, ``grad_norm``, ``lr``. ``loss_chunk`` and
    ``remat`` come from the keywords (0 and ``"none"`` when not given) or,
    with ``rt``, from ``rt`` alone: giving both raises."""
    if rt is not None:
        if loss_chunk is not None or remat is not None:
            raise ValueError("with rt, loss_chunk and remat come from rt "
                             "(Runtime(loss_chunk=, remat=))")
        loss_chunk, remat = rt.loss_chunk, rt.remat
    else:
        loss_chunk = 0 if loss_chunk is None else loss_chunk
        remat = "none" if remat is None else remat

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch, cfg, backend, rt,
                                     loss_chunk=loss_chunk, remat=remat)
        _, opt_state, metrics = adamw.apply_updates(
            dict(params.named_parameters()), grads, opt_state, opt_cfg,
            lm.reference_layout(params))
        metrics["loss"] = loss
        return params, opt_state, {k: _whole(v) for k, v in
                                   metrics.items()}
    return train_step


def make_prefill_step(cfg: ArchConfig, backend: Optional[str] = None,
                      rt: Optional[Runtime] = None):
    rt = rt or NO_MESH

    def prefill_step(params, batch):
        logits, _ = lm.prefill_fn(params, rt.shard_batch(batch, "prefill",
                                                         cfg),
                                  cfg, backend, rt)
        return torch.argmax(_whole(logits), dim=-1).to(torch.int32)
    return prefill_step


def make_serve_step(cfg: ArchConfig, backend: Optional[str] = None,
                    rt: Optional[Runtime] = None):
    """One greedy decode step: (params, cache, {token,pos,...}) ->
    (next_token (B, 1) int32, cache)."""
    rt = rt or NO_MESH

    def serve_step(params, cache, batch):
        logits, new_cache = lm.decode_fn(
            params, cache, rt.shard_batch(batch, "decode", cfg), cfg,
            backend, rt)
        return torch.argmax(_whole(logits), dim=-1).to(torch.int32), \
            new_cache
    return serve_step
