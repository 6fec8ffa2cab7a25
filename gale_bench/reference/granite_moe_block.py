"""The MoE family's feed-forward block (Granite 3.0 MoE), plain PyTorch.

Routing: float32 router logits ``x Wr`` over the E experts, a softmax, each
token's ``top_k`` experts by descending probability (the lower expert first
on a tie), their probabilities renormalised to sum to one (the same gates
as Granite's softmax over the top-k logits). Each expert is a gated linear
unit ``(silu(x Wg_e) * (x Wi_e)) Wo_e``; a token's output is the gate-
weighted sum of its experts' outputs.

The capacity the program applies (``moe_capacity_factor`` cf; published
Granite routes without one, a departure the configuration file lists): the
batch's T tokens make ``T k`` (token, slot) pairs in token-major order;
``R = ceil(T k cf)`` and each expert keeps its first ``c = min(R, ceil(R /
E cf))`` pairs in that order; a pair past its expert's capacity adds
nothing. So the whole batch decides what is dropped, and the reference is
run on the batch the program served.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def param_specs(cfg, prefix: str):
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return [(prefix + "moe.router", (D, E), 1 / math.sqrt(D)),
            (prefix + "moe.wi", (E, D, Fd), 1 / math.sqrt(D)),
            (prefix + "moe.wg", (E, D, Fd), 1 / math.sqrt(D)),
            (prefix + "moe.wo", (E, Fd, D), 1 / math.sqrt(Fd))]


def ffn_flops(cfg) -> int:
    """Forward flops of one token: the router's product and its ``top_k``
    experts' three products of D x F (not the capacity's padding)."""
    d = cfg.d_model
    return 2 * d * cfg.n_experts + cfg.top_k * 3 * 2 * d * cfg.d_ff


def route(x, router, cfg, prec):
    """x (T, D) float32 -> (gates (T, k), experts (T, k), kept (T, k))."""
    T = x.shape[0]
    E, k, cf = cfg.n_experts, cfg.top_k, cfg.moe_capacity_factor
    probs = torch.softmax(prec.mm(x, router.float()), dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[:, :k], experts[:, :k]
    gates = gates / gates.sum(-1, keepdim=True)
    R = math.ceil(T * k * cf)
    cap = min(R, math.ceil(R / E * cf))
    flat = experts.reshape(-1)
    onehot = F.one_hot(flat, E)
    rank = (onehot.cumsum(0) - onehot).gather(1, flat[:, None])[:, 0]
    return gates, experts, (rank < cap).view(T, k)


def ffn(params, prefix: str, x, cfg, prec):
    """x (T, D) float32 -> (T, D): each expert's kept pairs as one block
    of rows (the pairs sorted by expert)."""
    def w(name):
        return params[prefix + "moe." + name]
    gates, experts, kept = route(x, w("router"), cfg, prec)
    pairs = torch.nonzero(kept.reshape(-1))[:, 0]
    pe = experts.reshape(-1)[pairs]
    order = torch.argsort(pe, stable=True)
    pairs = pairs[order]
    counts = torch.bincount(pe, minlength=cfg.n_experts).tolist()
    tok = pairs // cfg.top_k
    gate = gates.reshape(-1)[pairs, None]
    ys, at = [], 0
    for e, c in enumerate(counts):
        if c == 0:
            continue
        xe = x[tok[at:at + c]]
        h = F.silu(prec.mm(xe, w("wg")[e].float())) * \
            prec.mm(xe, w("wi")[e].float())
        ys.append(prec.mm(h, w("wo")[e].float()) * gate[at:at + c])
        at += c
    return torch.zeros_like(x).index_add(0, tok, torch.cat(ys))
