"""Mixture-of-Experts FFN with top-k routing and sort-based dispatch, ported
from the reference's ``models/moe.py``: ``moe_ffn``'s local path (one
device, ``ep = 1``: the expert-parallel exchange is the identity), its
expert-parallel path (``ep_group``: the experts split over a group, tokens
sent to their experts' ranks and back by two all-to-alls; ``tp_group``:
each expert's d_ff split over a group, the parts summed) and
``moe_ffn_ep_replicated`` (the experts split over a group that holds every
token: each rank takes its own experts' pairs, one sum combines them).
The sharded paths run on each rank's shards under
``Runtime.moe_apply``; their collectives are differentiable.

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
    """Where each routed pair goes at ``ep = 1`` (:func:`dispatch`). The
    ``T k`` flat pairs fill the first send rows (``keep``: within
    ``c_send``); the ``R = c_send`` rows are sorted by expert (``order2``,
    stable; padding rows last), and a row is computed where ``keep2`` (its
    rank within its expert below ``c_loc``), at ``(erow, crow)`` of the
    expert buffer."""
    keep: torch.Tensor        # (T k,) bool
    slot: torch.Tensor        # (T k,) send row of each pair (0 if dropped)
    order2: torch.Tensor      # (R,) send rows sorted by expert
    keep2: torch.Tensor       # (R,) bool, in order2's order
    erow: torch.Tensor        # (R,) expert of each sorted row (0 if not)
    crow: torch.Tensor        # (R,) rank within it (0 if not)
    counts: torch.Tensor      # (E_pad + 1,) rows per expert, padding last
    c_send: int
    c_loc: int


def _masked(rows, mask):
    return torch.where(mask[:, None], rows, rows.new_zeros(()))


def _count(key: torch.Tensor, n: int) -> torch.Tensor:
    """``bincount(key, minlength=n)`` for keys below ``n``, of a static
    length (the dry run traces shapes only)."""
    return torch.zeros(n, dtype=torch.long, device=key.device).scatter_add_(
        0, key, torch.ones_like(key))


def _send_plan(flat_e: torch.Tensor, e_loc: int, ep: int, cfg, sort: bool):
    """The reference's dispatch of the token-major pairs ``flat_e`` (T k,)
    to their experts' EP ranks (expert ``e`` on rank ``e // e_loc``):
    (order, keep, slot, send_e, c_send). ``order`` sorts the pairs stably
    by rank (None without ``sort``: one destination, the sort is the
    identity); in that order a pair is kept within ``c_send = ceil(T k /
    ep cf)`` of its rank and goes to send row ``slot``, whose expert is
    ``send_e`` (-1 for an empty row)."""
    n = flat_e.shape[0]
    dev = flat_e.device
    c_send = int(np.ceil(n / ep * cfg.moe_capacity_factor))
    rank = torch.arange(n, device=dev)
    order, base = None, 0
    if sort:
        dest = flat_e // e_loc
        order = torch.argsort(dest, stable=True)
        dest_s = dest[order]
        counts = _count(dest, ep)
        rank = rank - (torch.cumsum(counts, 0) - counts)[dest_s]
        base = dest_s * c_send
        flat_e = flat_e[order]
    keep = rank < c_send
    slot = torch.where(keep, base + rank, 0)
    send_e = torch.full((ep * c_send,), -1, dtype=torch.long, device=dev)
    send_e.scatter_reduce_(0, slot, torch.where(keep, flat_e, -1),
                           reduce="amax", include_self=True)
    return order, keep, slot, send_e, c_send


def _group_by_expert(key: torch.Tensor, n_local: int, capacity: int):
    """The reference's grouping of rows by local expert: ``key`` (R,) each
    row's local expert, ``n_local`` for rows of none; returns (order, keep,
    expert row, capacity row, rows per key) of the rows sorted stably by
    expert, kept where within ``capacity`` of their expert."""
    R = key.shape[0]
    order = torch.argsort(key, stable=True)
    key_s = key[order]
    counts = _count(key, n_local + 1)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(R, device=key.device) - starts[key_s]
    keep = (rank < capacity) & (key_s < n_local)
    return (order, keep, torch.where(keep, key_s, 0),
            torch.where(keep, rank, 0), counts)


def _c_loc(R: int, e_loc: int, cfg) -> int:
    return min(R, int(np.ceil(R / max(e_loc, 1) * cfg.moe_capacity_factor)))


def dispatch(eidx: torch.Tensor, cfg, e_pad: int) -> Plan:
    """:func:`moe_ffn`'s plan for ``eidx`` (T, k) at ``ep = 1``."""
    _, keep, slot, send_e, c_send = _send_plan(eidx.reshape(-1), e_pad, 1,
                                               cfg, sort=False)
    c_loc = _c_loc(c_send, e_pad, cfg)
    order2, keep2, erow, crow, counts = _group_by_expert(
        torch.where(send_e >= 0, send_e, e_pad), e_pad, c_loc)
    return Plan(keep, slot, order2, keep2, erow, crow, counts, c_send,
                c_loc)


def _experts(p, buf: torch.Tensor, cfg) -> torch.Tensor:
    dtype = buf.dtype
    act = _ACT[cfg.activation]
    h = act(torch.bmm(buf, p.wg.to(dtype))) * torch.bmm(buf, p.wi.to(dtype))
    return torch.bmm(h, p.wo.to(dtype))


def moe_ffn(p, x: torch.Tensor, cfg, ep_group=None, tp_group=None
            ) -> torch.Tensor:
    """x (T, D) local tokens in the compute dtype -> (T, D). Without
    groups ``p`` holds every expert (``ep = 1``: one destination, so the
    pairs are not sorted by it and the exchanges are the identity). Under
    ``Runtime.moe_apply`` (the reference's ``shard_map``) ``p`` holds this
    rank's ``e_loc`` experts of ``ep_group`` (``e_loc * ep`` = E_pad, rank
    r owning experts ``r e_loc ..``) and, with ``tp_group``, its slice of
    each expert's d_ff: pairs go to their expert's EP rank (``c_send =
    ceil(T k / ep cf)`` a destination, the rest dropped), one all-to-all
    there and one back; the experts' TP parts are summed over ``tp_group``.
    The routing runs alike on every TP rank; the tokens' part of the
    gradient through the experts is summed over ``tp_group``."""
    T, d = x.shape
    k = cfg.top_k
    dtype = x.dtype
    ep, my = 1, 0
    if ep_group is not None or tp_group is not None:
        import torch.distributed as dist

        from ..distributed.sharding import all_to_all, copy_to, sum_over
        if ep_group is not None:
            ep, my = dist.get_world_size(ep_group), dist.get_rank(ep_group)
    e_loc = p.wi.shape[0]
    gates, eidx = route(p, x, cfg)
    x_ffn = copy_to(x, tp_group) if tp_group is not None else x

    flat_t = torch.arange(T * k, device=x.device) // k
    order, keep, slot, send_e, c_send = _send_plan(
        eidx.reshape(-1), e_loc, ep, cfg, sort=ep_group is not None)
    if order is not None:
        flat_t = flat_t[order]
    R = ep * c_send
    send_x = x.new_zeros((R, d)).index_add_(0, slot,
                                            _masked(x_ffn[flat_t], keep))
    if ep_group is not None:
        recv_x = all_to_all(send_x, ep_group)
        recv_e = all_to_all(send_e, ep_group)
    else:
        recv_x, recv_e = send_x, send_e

    lidx = recv_e - my * e_loc
    valid = (recv_e >= 0) & (lidx >= 0) & (lidx < e_loc)
    c_loc = _c_loc(R, e_loc, cfg)
    order2, keep2, erow, crow, _ = _group_by_expert(
        torch.where(valid, lidx, e_loc), e_loc, c_loc)
    # the (expert, rank) slots flattened: one index_add_ row per sorted row
    buf = x.new_zeros((e_loc * c_loc, d)).index_add_(
        0, erow * c_loc + crow,
        _masked(recv_x[order2], keep2)).view(e_loc, c_loc, d)
    y = _experts(p, buf, cfg)
    if tp_group is not None:
        y = sum_over(y, tp_group)

    y_rows = x.new_zeros((R, d)).index_add_(
        0, order2, _masked(y[erow, crow], keep2))
    y_back = all_to_all(y_rows, ep_group) if ep_group is not None \
        else y_rows
    y_pairs = _masked(y_back[slot], keep)
    if order is not None:
        # back from the destination order to the token-major pairs
        y_pairs = x.new_zeros((T * k, d)).index_add_(0, order, y_pairs)
    return (y_pairs.reshape(T, k, d) * gates.to(dtype)[..., None]).sum(1)


def moe_ffn_ep_replicated(p, x: torch.Tensor, cfg, ep_group
                          ) -> torch.Tensor:
    """Expert parallelism over a group where every rank holds every token
    (the TP axis): ``p`` holds this rank's ``e_loc`` experts, each with its
    whole d_ff. No all-to-all: each rank groups the pairs routed to its own
    experts (capacity ``ceil(T k / E_pad cf)`` an expert), runs them, and
    one sum over ``ep_group`` combines the ranks' outputs. Each rank's
    gradient is its own experts' part (summed by the caller's DTensor)."""
    from ..distributed.sharding import sum_over
    import torch.distributed as dist
    T, d = x.shape
    k = cfg.top_k
    dtype = x.dtype
    e_pad = p.router.shape[1]
    e_loc = p.wi.shape[0]
    my0 = dist.get_rank(ep_group) * e_loc
    gates, eidx = route(p, x, cfg)
    flat_e = eidx.reshape(-1)
    flat_t = torch.arange(T * k, device=x.device) // k
    lidx = flat_e - my0
    mine = (lidx >= 0) & (lidx < e_loc)
    c_loc = int(np.ceil(T * k / max(e_pad, 1) * cfg.moe_capacity_factor))
    order, keep, erow, crow, _ = _group_by_expert(
        torch.where(mine, lidx, e_loc), e_loc, c_loc)
    buf = x.new_zeros((e_loc * c_loc, d)).index_add_(
        0, erow * c_loc + crow,
        _masked(x[flat_t[order]], keep)).view(e_loc, c_loc, d)
    y = _experts(p, buf, cfg)
    y_pairs = x.new_zeros((T * k, d)).index_add_(
        0, order, _masked(y[erow, crow], keep))
    out = (y_pairs.reshape(T, k, d) * gates.to(dtype)[..., None]).sum(1)
    return sum_over(out, ep_group)


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
