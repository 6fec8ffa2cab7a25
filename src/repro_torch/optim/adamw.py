"""AdamW with decoupled weight decay, global-norm clipping, a cosine
schedule and optional error-feedback int8 gradient compression, ported
from the reference's ``optim/adamw.py`` with its semantics.

Parameters, gradients and moments are dicts keyed by parameter name
(``dict(model.named_parameters())``). The moments, the clipping norm and
the schedule are float32, as the reference computes them. Unlike the
reference, which returns updated copies, :func:`apply_updates` updates the
parameters and the state in place (under ``no_grad``), so a step holds one
copy of each master and moment.

Decoupled decay and gradient compression follow the reference's layout,
not the port's. The reference decays every array of rank 2 or more, and
its stacked groups carry a leading layer axis, so a block's norm gains,
biases and Mamba2 vectors are decayed there although they are 1-d here;
and it quantizes each stacked array with one scale, the largest entry over
all its layers. The caller passes each parameter's leaf and rank in that
layout (``lm.reference_layout``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models import lm

Named = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    compress_grads: bool = False   # int8 error-feedback compression


def _zeros(params: Named) -> Named:
    """float32 zeros laid out as each parameter (a DTensor's on its
    placements)."""
    return {n: torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)
            for n, p in params.items()}


def init_state(params: Named, cfg: AdamWConfig) -> dict:
    """``{"mu", "nu"}`` (and ``"ef"`` with compression): float32 zeros per
    parameter; ``"step"``: a 0-d int32 tensor on the CPU."""
    state = {"mu": _zeros(params), "nu": _zeros(params),
             "step": torch.zeros((), dtype=torch.int32)}
    if cfg.compress_grads:
        state["ef"] = _zeros(params)
    return state


def state_from_reference(tree: dict, model_cfg, device) -> dict:
    """The reference's AdamW state (``mu``/``nu``/``ef`` trees laid out as
    its parameters, ``step``) as the port's: each moment unstacked into
    per-block float32 tensors as :func:`lm.params_from_reference` unstacks
    the weights."""
    out = {"step": torch.tensor(int(np.asarray(tree["step"])),
                                dtype=torch.int32)}
    for key in ("mu", "nu", "ef"):
        if key in tree:
            out[key] = {n: torch.from_numpy(np.array(a, np.float32)).to(
                device) for n, a in lm.unstacked(tree[key], model_cfg)
                .items()}
    return out


def schedule(step, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warm-up, then a cosine from ``lr`` to ``lr * min_lr_ratio``:
    a 0-d float32 tensor, each operation in float32 as the reference's."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: Named) -> torch.Tensor:
    """The float32 L2 norm over every tensor of ``tree``."""
    return torch.sqrt(sum(x.float().square().sum() for x in tree.values()))


def _quantize(x: torch.Tensor, amax: torch.Tensor):
    scale = amax.clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, x - deq


def compress_int8(g: torch.Tensor, ef: torch.Tensor):
    """Error-feedback int8 quantization: quantize (g + carry) at the scale
    of its largest entry, carry the residual. Returns (dequantized, new
    carry)."""
    x = g + ef
    return _quantize(x, x.abs().max())


@torch.no_grad()
def apply_updates(params: Named, grads: Named, state: dict,
                  cfg: AdamWConfig,
                  layout: Optional[Dict[str, Tuple[str, int]]] = None):
    """One AdamW step, in place: ``step`` += 1, the schedule's lr, the
    gradients (int8-compressed with error feedback when configured, one
    scale per reference leaf) clipped to ``clip_norm`` by their float32
    global norm, the moments, and ``p -= lr * (mu_hat / (sqrt(nu_hat) +
    eps) + wd * p)`` with the decay term only where the reference leaf's
    rank is 2 or more. ``layout``: name -> (reference leaf, its rank)
    (default: each tensor its own leaf). Returns (params, state,
    {"grad_norm", "lr"}): the same objects."""
    if layout is None:
        layout = {n: (n, p.dim()) for n, p in params.items()}
    step = state["step"] + 1
    state["step"] = step
    lr = float(schedule(step, cfg))
    if cfg.compress_grads:
        x = {n: g + state["ef"][n] for n, g in grads.items()}
        amax: Dict[str, torch.Tensor] = {}
        for n, t in x.items():
            leaf = layout[n][0]
            m = t.abs().max()
            amax[leaf] = m if leaf not in amax else torch.maximum(
                amax[leaf], m)
        pairs = {n: _quantize(t, amax[layout[n][0]]) for n, t in x.items()}
        grads = {n: d for n, (d, _) in pairs.items()}
        state["ef"] = {n: e for n, (_, e) in pairs.items()}
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / gn.clamp_min(1e-12), max=1.0)
    b1, b2 = cfg.beta1, cfg.beta2
    f32 = torch.float32
    sf = step.to(f32)
    bc1 = float(1 - torch.tensor(b1, dtype=f32) ** sf)
    bc2 = float(1 - torch.tensor(b2, dtype=f32) ** sf)
    for name, p in params.items():
        g = grads[name].to(f32) * scale
        mu, nu = state["mu"][name], state["nu"][name]
        mu.mul_(b1).add_(g * (1 - b1))
        nu.mul_(b2).add_(g * (1 - b2) * g)
        delta = (mu / bc1).div_((nu / bc2).sqrt_().add_(cfg.eps))
        if layout[name][1] >= 2:
            delta.add_(p * cfg.weight_decay)
        delta.mul_(lr)
        if p.dtype == f32:
            p.sub_(delta)
        else:                        # rounded once, as the reference's cast
            p.copy_(p.float() - delta)
    return params, state, {"grad_norm": gn, "lr": torch.tensor(lr)}
