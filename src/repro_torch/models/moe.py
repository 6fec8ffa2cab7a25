"""Mixture-of-Experts FFN with top-k routing and sort-based dispatch, ported
from the reference's ``models/moe.py``: ``moe_ffn``'s local path (one
device, ``ep = 1``: the expert-parallel exchange is the identity).

The routing and the capacity are the reference's, step for step: a softmax
over the float32 router logits with padded experts masked to ``-inf``; the
top ``k`` experts of each token (lower expert first where probabilities
tie, as ``jax.lax.top_k`` orders them: a stable descending sort, since
``torch.topk`` promises no order); the gates renormalised; token-major
``(token, slot)`` pairs; a send capacity ``c_send = ceil(T k cf)``; a
stable sort of the pairs by expert; a per-expert capacity ``c_loc =
min(R, ceil(R / E cf))`` with ``R = c_send``, pairs past it dropped; GLU
experts as batched products; the gates applied on the way back. Dropped
and padding rows are scattered as zeros into slot 0, as the reference's
``.at[].add`` / ``.at[].max`` with masks do (``index_add_`` /
``scatter_reduce(amax)``; the expert buffer's (expert, rank) slots are
indexed flat: ``index_put_(accumulate=True)`` runs a sort-based kernel
that dominated granite-moe-3b's prefill on the card).

Expert-count padding: with ``ep`` devices the expert axis is padded to a
multiple of ``ep``; padded experts are never routed to. The expert
products are plain matrix products (the reference runs them outside any
Pallas kernel), so they stay torch products on both arms.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from .layers import _ACT, _param, trunc_normal_


def padded_experts(n_experts: int, ep: int) -> int:
    return int(np.ceil(n_experts / ep) * ep)


class MoE(nn.Module):
    """router (D, E_pad), wi/wg (E_pad, D, F), wo (E_pad, F, D): raw
    parameters with the reference's names (``moe_init``), in the storage
    dtype; every use casts them to the compute dtype."""

    def __init__(self, cfg, *, dtype, device, ep: int = 1):
        super().__init__()
        e_pad = padded_experts(cfg.n_experts, ep)
        d, f = cfg.d_model, cfg.d_ff
        self.router = _param((d, e_pad), dtype, device)
        self.wi = _param((e_pad, d, f), dtype, device)
        self.wg = _param((e_pad, d, f), dtype, device)
        self.wo = _param((e_pad, f, d), dtype, device)

    def reset(self, generator):
        d, f = self.router.shape[0], self.wo.shape[1]
        for w in (self.router, self.wi, self.wg):
            trunc_normal_(w, 1.0 / np.sqrt(d), generator)
        trunc_normal_(self.wo, 1.0 / np.sqrt(f), generator)


def route(p: MoE, x: torch.Tensor, cfg):
    """x (T, D) -> (gates (T, k) float32, renormalised; eidx (T, k) int64,
    each token's experts in descending probability, the lower expert first
    on a tie)."""
    e_pad = p.router.shape[1]
    logits = (x @ p.router.to(x.dtype)).float()
    emask = torch.arange(e_pad, device=x.device) < cfg.n_experts
    logits = logits.masked_fill(~emask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = gates[:, :cfg.top_k], eidx[:, :cfg.top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, eidx


class Plan(NamedTuple):
    """Where each routed pair goes (``ep = 1``). The ``T k`` flat pairs
    fill the first send rows (``keep``: within ``c_send``); the ``R =
    c_send`` rows are sorted by expert (``order2``, stable; padding rows
    last), and a row is computed where ``keep2`` (its rank within its
    expert below ``c_loc``), at ``(erow, crow)`` of the expert buffer."""
    keep: torch.Tensor        # (T k,) bool
    slot: torch.Tensor        # (T k,) send row of each pair (0 if dropped)
    order2: torch.Tensor      # (R,) send rows sorted by expert
    keep2: torch.Tensor       # (R,) bool, in order2's order
    erow: torch.Tensor        # (R,) expert of each sorted row (0 if not)
    crow: torch.Tensor        # (R,) rank within it (0 if not)
    counts: torch.Tensor      # (E_pad + 1,) rows per expert, padding last
    c_send: int
    c_loc: int


def dispatch(eidx: torch.Tensor, cfg, e_pad: int) -> Plan:
    """The reference's dispatch and grouping for ``eidx`` (T, k) at ``ep =
    1``: one destination, so the first sort is the identity."""
    T, k = eidx.shape
    dev = eidx.device
    ep = 1
    n = T * k
    flat_e = eidx.reshape(-1)
    rank = torch.arange(n, device=dev)
    c_send = int(np.ceil(T * k / ep * cfg.moe_capacity_factor))
    keep = rank < c_send
    slot = torch.where(keep, rank, 0)
    R = ep * c_send
    send_e = torch.full((R,), -1, dtype=torch.long, device=dev)
    send_e.scatter_reduce_(0, slot, torch.where(keep, flat_e, -1),
                           reduce="amax", include_self=True)
    e_loc = e_pad
    gkey = torch.where(send_e >= 0, send_e, e_loc)
    order2 = torch.argsort(gkey, stable=True)
    gkey_s = gkey[order2]
    counts = torch.bincount(gkey, minlength=e_loc + 1)
    starts = torch.cumsum(counts, 0) - counts
    rank2 = torch.arange(R, device=dev) - starts[gkey_s]
    c_loc = min(R, int(np.ceil(R / max(e_loc, 1)
                               * cfg.moe_capacity_factor)))
    keep2 = (rank2 < c_loc) & (gkey_s < e_loc)
    erow = torch.where(keep2, gkey_s, 0)
    crow = torch.where(keep2, rank2, 0)
    return Plan(keep, slot, order2, keep2, erow, crow, counts, c_send,
                c_loc)


def moe_ffn(p: MoE, x: torch.Tensor, cfg) -> torch.Tensor:
    """x (T, D) local tokens in the compute dtype -> (T, D)."""
    T, d = x.shape
    k = cfg.top_k
    dtype = x.dtype
    e_pad = p.router.shape[1]
    gates, eidx = route(p, x, cfg)
    plan = dispatch(eidx, cfg, e_pad)
    R = plan.c_send
    flat_t = torch.arange(T * k, device=x.device) // k

    def masked(rows, mask):
        return torch.where(mask[:, None], rows, rows.new_zeros(()))

    send_x = x.new_zeros((R, d)).index_add_(
        0, plan.slot, masked(x[flat_t], plan.keep))
    # the (expert, rank) slots flattened: one index_add_ row per sorted row
    buf = x.new_zeros((e_pad * plan.c_loc, d)).index_add_(
        0, plan.erow * plan.c_loc + plan.crow,
        masked(send_x[plan.order2], plan.keep2)).view(e_pad, plan.c_loc, d)

    act = _ACT[cfg.activation]
    h = act(torch.bmm(buf, p.wg.to(dtype))) * torch.bmm(buf, p.wi.to(dtype))
    y = torch.bmm(h, p.wo.to(dtype))

    y_rows = x.new_zeros((R, d)).index_add_(
        0, plan.order2, masked(y[plan.erow, plan.crow], plan.keep2))
    # the return trip's sort by destination is the identity at ep = 1
    y_pairs = masked(y_rows[plan.slot], plan.keep)
    return (y_pairs.reshape(T, k, d) * gates.to(dtype)[..., None]).sum(1)


def aux_load_balance_loss(p: MoE, x: torch.Tensor, cfg) -> torch.Tensor:
    """Switch-style auxiliary loss of x (T, D) in the compute dtype: ``E *
    sum_e f_e P_e``, the share of (token, slot) pairs routed to expert e
    times its mean router probability, in float32 (the reference's ``moe.
    aux_load_balance_loss``; its ``loss_fn`` does not add it, nor does the
    port's)."""
    e_pad = p.router.shape[1]
    logits = (x @ p.router.to(x.dtype)).float()
    emask = torch.arange(e_pad, device=x.device) < cfg.n_experts
    probs = torch.softmax(logits.masked_fill(~emask, float("-inf")), dim=-1)
    _, eidx = route(p, x, cfg)
    f = torch.zeros(e_pad, dtype=torch.float32, device=x.device).index_add_(
        0, eidx.reshape(-1), torch.ones(eidx.numel(), device=x.device)) \
        / eidx.numel()
    return cfg.n_experts * (f * probs.mean(0)).sum()
