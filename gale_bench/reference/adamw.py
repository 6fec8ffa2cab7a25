"""AdamW as the training cell's optimizer block states it, plain PyTorch in
float32: a linear warm-up then a cosine from ``lr`` to ``lr *
min_lr_ratio``; the gradients clipped to ``clip_norm`` by their global
norm; the moments; bias corrections; and decoupled weight decay on every
weight but the final norm's gain (a stacked model's per-layer gains are
decayed with their stack)."""

from __future__ import annotations

import math
from typing import Dict

import torch


def schedule(step: int, opt: dict) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * (opt["min_lr_ratio"]
                               + (1 - opt["min_lr_ratio"]) * cos)


def decayed(name: str, p: torch.Tensor) -> bool:
    return p.dim() >= 2 or name.startswith("layers.")


class AdamW:
    """The optimizer state of float32 weights ``params`` (name -> leaf)."""

    def __init__(self, params: Dict[str, torch.Tensor], opt: dict):
        self.params, self.opt, self.step_count = params, opt, 0
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One update in place; returns each leaf's norm of the clipped
        gradient, as the moments take it."""
        o = self.opt
        self.step_count += 1
        t = self.step_count
        lr = schedule(t, o)
        gn = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        scale = torch.clamp(o["clip_norm"] / gn.clamp_min(1e-12), max=1.0)
        b1, b2 = o["beta1"], o["beta2"]
        norms = {}
        for n, p in self.params.items():
            g = grads[n] * scale
            norms[n] = float(g.norm())
            self.mu[n].mul_(b1).add_(g, alpha=1 - b1)
            self.nu[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            delta = (self.mu[n] / (1 - b1 ** t)) / (
                (self.nu[n] / (1 - b2 ** t)).sqrt() + o["eps"])
            if decayed(n, p):
                delta = delta + o["weight_decay"] * p
            p.sub_(lr * delta)
        return norms
