"""Plain PyTorch reference of the decoder stack the benchmark's
configurations run: token embedding, pre-norm blocks of rotary GQA
attention and a feed-forward block of the configuration's family, a final
RMSNorm and the LM head; its loss is the mean next-token cross entropy.

It computes in float32 (or the control's precision, :mod:`.precision`),
imports nothing of the program, and reads its weights from a dict of
tensors named as the weights the benchmark makes (:func:`param_specs`),
stored in any dtype and cast to float32 where used. The family's block is
a module of this package named by the configuration (``dense_block``,
``granite_moe_block``): ``param_specs(cfg, prefix)``, ``ffn(params,
prefix, x, cfg, prec)`` and ``ffn_flops(cfg)`` for the feed-forward block
of the attention layer below. A family whose layers are not that layer
(state-space or hybrid layers) gives ``layer(params, i, x, cos, sin, cfg,
block, prec)`` and ``layer_flops(cfg, i, B, S)`` as well; its
``param_specs`` then names all of layer ``i``'s weights.

The mathematics, as the configurations state it (departures from the
published models are listed in each configuration file):

- RMSNorm: ``x * rsqrt(mean(x^2) + eps) * g``.
- Rotary embedding on the two halves of each head: ``[x1 cos - x2 sin,
  x2 cos + x1 sin]`` at angles ``position * theta ** (-i / half)``.
- Attention: query head h reads KV head ``h // (H / KV)``; scores scaled
  by ``1 / sqrt(hd)``, causal, softmax, in query blocks of ``Q_BLOCK``.
- Residual adds around attention and the feed-forward block.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .precision import Precision

Q_BLOCK = 512          # query rows a step of the blocked attention
LOSS_CHUNK = 512       # positions a step of the blocked cross entropy

Spec = Tuple[str, Tuple[int, ...], Optional[float]]


def param_specs(cfg, block) -> List[Spec]:
    """(name, shape, scale) of every weight in the order the benchmark
    draws them: ``scale`` times a normal cut to [-2, 2], or ``None`` for a
    norm gain of ones. Projections scale by one over the square root of
    their fan-in, the embedding by 1."""
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    out: List[Spec] = [("embed.table", (cfg.vocab, D), 1.0)]
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        if hasattr(block, "layer"):
            out += block.param_specs(cfg, p)
            continue
        out += [(p + "ln1.g", (D,), None),
                (p + "attn.wq", (D, H, hd), 1 / math.sqrt(D)),
                (p + "attn.wk", (D, KV, hd), 1 / math.sqrt(D)),
                (p + "attn.wv", (D, KV, hd), 1 / math.sqrt(D)),
                (p + "attn.wo", (H, hd, D), 1 / math.sqrt(H * hd)),
                (p + "ln2.g", (D,), None)]
        out += block.param_specs(cfg, p)
    out.append(("ln_f.g", (D,), None))
    if not cfg.tie_embeddings:
        out.append(("unembed.w", (D, cfg.vocab), 1 / math.sqrt(D)))
    return out


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g.float()


def rope_tables(S: int, hd: int, theta: float, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    half = hd // 2
    freqs = torch.tensor([theta ** (-i / half) for i in range(half)],
                         dtype=torch.float64, device=device).float()
    ang = torch.arange(S, dtype=torch.float32, device=device)[:, None] * freqs
    return torch.cos(ang), torch.sin(ang)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
         ) -> torch.Tensor:
    """x (B, S, H, hd); cos/sin (S, hd / 2)."""
    half = x.shape[-1] // 2
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(q, k, v, prec: Precision) -> torch.Tensor:
    """Causal attention: q (B, S, H, hd), k/v (B, S, KV, hd) -> (B, S, H,
    hd), one block of query rows at a time against the keys it can see."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    q = q.transpose(1, 2)
    k = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    v = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    outs = []
    for s0 in range(0, S, Q_BLOCK):
        s1 = min(S, s0 + Q_BLOCK)
        scores = prec.mm(q[:, :, s0:s1], k[:, :, :s1].transpose(-1, -2)) \
            / math.sqrt(hd)
        rows = torch.arange(s0, s1, device=q.device)[:, None]
        cols = torch.arange(s1, device=q.device)[None, :]
        scores = scores.masked_fill(cols > rows, float("-inf"))
        outs.append(prec.mm(torch.softmax(scores, dim=-1), v[:, :, :s1]))
    return torch.cat(outs, dim=2).transpose(1, 2)


def layer(params: Dict[str, torch.Tensor], i: int, x: torch.Tensor, cos,
          sin, cfg, block, prec: Precision) -> torch.Tensor:
    """One pre-norm block on x (B, S, D), float32."""
    p = f"layers.{i}."
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rmsnorm(x, params[p + "ln1.g"], cfg.norm_eps).reshape(B * S, D)

    def proj(name, heads):
        w = params[p + name].float().reshape(D, heads * hd)
        return prec.mm(h, w).view(B, S, heads, hd)
    q = rope(proj("attn.wq", H), cos, sin)
    k = rope(proj("attn.wk", KV), cos, sin)
    v = proj("attn.wv", KV)
    o = attention(q, k, v, prec).reshape(B * S, H * hd)
    x = x + prec.mm(o, params[p + "attn.wo"].float().reshape(H * hd, D)) \
        .view(B, S, D)
    h = rmsnorm(x, params[p + "ln2.g"], cfg.norm_eps).reshape(B * S, D)
    return x + block.ffn(params, p, h, cfg, prec).view(B, S, D)


def hidden(params, tokens: torch.Tensor, cfg, block, prec: Precision,
           remat: bool = False) -> torch.Tensor:
    """The final-normed hidden states (B, S, D) of ``tokens`` (B, S);
    ``remat`` recomputes each block in the backward (training)."""
    S = tokens.shape[1]
    cos, sin = rope_tables(S, cfg.hd, cfg.rope_theta, tokens.device)
    x = params["embed.table"].float()[tokens.long()]
    step = getattr(block, "layer", layer)
    for i in range(cfg.n_layers):
        if remat:
            x = checkpoint(step, params, i, x, cos, sin, cfg, block, prec,
                           use_reentrant=False)
        else:
            x = step(params, i, x, cos, sin, cfg, block, prec)
    return rmsnorm(x, params["ln_f.g"], cfg.norm_eps)


def head_weight(params, cfg) -> torch.Tensor:
    """(D, V): the unembedding, or the embedding's transpose when tied."""
    if cfg.tie_embeddings:
        return params["embed.table"].float().t()
    return params["unembed.w"].float()


@torch.no_grad()
def last_logits(params, tokens, cfg, block, prec: Precision) -> torch.Tensor:
    """Float32 logits (B, V) at each row's last position: what a prefill
    serves its first token from."""
    h = hidden(params, tokens, cfg, block, prec)[:, -1]
    return prec.mm(h, head_weight(params, cfg))


def _nll_sum(h, labels, w, prec: Precision) -> torch.Tensor:
    logits = prec.mm(h, w)
    gold = logits.gather(-1, labels.long()[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def loss(params, tokens, labels, cfg, block, prec: Precision
         ) -> torch.Tensor:
    """Mean cross entropy over every position of (B, S) ``tokens`` against
    ``labels``; each block and each chunk of ``LOSS_CHUNK`` positions'
    logits recomputed in the backward, so the reference fits beside a
    full card's worth of optimizer state."""
    B, S = tokens.shape
    h = hidden(params, tokens, cfg, block, prec, remat=True)
    w = head_weight(params, cfg)
    D = h.shape[-1]
    total = h.new_zeros(())
    for s0 in range(0, S, LOSS_CHUNK):
        hc = h[:, s0:s0 + LOSS_CHUNK].reshape(-1, D)
        lc = labels[:, s0:s0 + LOSS_CHUNK].reshape(-1)
        total = total + checkpoint(_nll_sum, hc, lc, w, prec,
                                   use_reentrant=False)
    return total / (B * S)

