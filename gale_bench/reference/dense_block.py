"""The dense family's feed-forward block, plain PyTorch: a gated linear
unit ``(silu(x Wg) * (x Wi)) Wo`` (llama's MLP; deepseek-llm-7b's)."""

from __future__ import annotations

import math

import torch.nn.functional as F


def param_specs(cfg, prefix: str):
    D, Fd = cfg.d_model, cfg.d_ff
    return [(prefix + "mlp.wi.w", (D, Fd), 1 / math.sqrt(D)),
            (prefix + "mlp.wg.w", (D, Fd), 1 / math.sqrt(D)),
            (prefix + "mlp.wo.w", (Fd, D), 1 / math.sqrt(Fd))]


def ffn_flops(cfg) -> int:
    """Forward flops of one token: three products of D x F."""
    return 3 * 2 * cfg.d_model * cfg.d_ff


def ffn(params, prefix: str, x, cfg, prec):
    """x (T, D) float32 -> (T, D)."""
    def w(name):
        return params[prefix + name].float()
    h = F.silu(prec.mm(x, w("mlp.wg.w"))) * prec.mm(x, w("mlp.wi.w"))
    return prec.mm(h, w("mlp.wo.w"))
