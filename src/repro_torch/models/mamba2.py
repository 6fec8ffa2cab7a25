"""Mamba2 / SSD (state-space duality) blocks [arXiv:2405.21060], ported from
the reference's ``models/mamba2.py``.

The chunked SSD algorithm: within a chunk the recurrence is evaluated in
its dual quadratic form (products over the 1-semiseparable mask), across
chunks a linear recurrence carries the (heads, headdim, state) chunk
states. Decode is the O(1) recurrent update. Single group (B/C shared
across heads), as the published 130m config.

Dtypes follow the reference's: the decay terms (``dt``, ``A``, the segment
sums and their exponentials) in float32, cast to the compute dtype where
the reference casts them; a streaming state is returned as a new tensor
whose dtype follows the promotion of the cached state with the compute
dtype (a bf16 cache in a float32 config gives float32 states after one
step, as in the reference), never written into the cache in place.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, RMSNorm, _param, dense, rmsnorm, trunc_normal_


class Mamba2(nn.Module):
    """in_proj (D, 2 d_inner + 2 state + heads), conv_w (K, C), conv_b (C,),
    A_log/D/dt_bias (heads,), norm (d_inner), out_proj (d_inner, D), with
    C = d_inner + 2 state: the reference's names (``mamba2_init``).
    ``A_log`` and ``dt_bias`` stay float32, as the reference applies them
    in float32; the rest is in the storage dtype, cast to the compute dtype
    at every use, as the reference casts them."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        d, di, st, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        conv_ch = di + 2 * st
        f32 = torch.float32
        self.in_proj = Dense(d, 2 * di + 2 * st + h, dtype=dtype,
                             device=device)
        self.conv_w = _param((cfg.ssm_conv, conv_ch), dtype, device)
        self.conv_b = _param((conv_ch,), dtype, device)
        self.A_log = _param((h,), f32, device)
        self.D = _param((h,), dtype, device)
        self.dt_bias = _param((h,), f32, device)
        self.norm = RMSNorm(di, device=device)
        self.out_proj = Dense(di, d, dtype=dtype, device=device)

    def reset(self, generator):
        trunc_normal_(self.conv_w, 1.0 / np.sqrt(self.conv_w.shape[0]),
                      generator)
        h = self.A_log.shape[0]
        with torch.no_grad():
            self.conv_b.zero_()
            self.A_log.copy_(torch.log(torch.linspace(
                1.0, 16.0, h, dtype=torch.float32)))
            self.D.fill_(1.0)
            self.dt_bias.zero_()


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., l) -> (..., l, l) with out[i, j] = sum_{j<k<=i} x[k], -inf above
    the diagonal (the 1-SS decay mask in log space)."""
    n = x.shape[-1]
    c = torch.cumsum(x, dim=-1)
    diff = c[..., :, None] - c[..., None, :]
    mask = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d. xBC (B,S,C), w (K,C). Returns (out,
    new_state) where new_state is the trailing K-1 inputs (a new tensor, in
    xBC's dtype) for streaming decode."""
    K = w.shape[0]
    S = xBC.shape[1]
    if state is None:
        pad = xBC.new_zeros((xBC.shape[0], K - 1, xBC.shape[2]))
    else:
        pad = state.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)
    dt = xBC.dtype
    out = sum(xp[:, i:i + S, :] * w[i].to(dt) for i in range(K))
    out = out + b.to(dt)
    return out, xp[:, -(K - 1):, :].clone()


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan.
    x (b,s,h,p); dt (b,s,h) float32; A (h,) float32; Bm/Cm (b,s,n).
    Returns (y (b,s,h,p), final_state (b,h,p,n)), both in x's dtype. The
    sequence must be a whole number of chunks (the reference's reshape
    fails otherwise; nothing is padded)."""
    b, s, h, pdim = x.shape
    n = Bm.shape[-1]
    if s % chunk:
        raise ValueError(
            f"ssd_chunked needs a whole number of chunks: sequence {s} is "
            f"not a multiple of the chunk {chunk} (x {tuple(x.shape)}, "
            f"B {tuple(Bm.shape)})")
    nc = s // chunk
    xt = x.dtype
    xc = x.reshape(b, nc, chunk, h, pdim)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = Bm.reshape(b, nc, chunk, n)
    Cc = Cm.reshape(b, nc, chunk, n)

    dA = dtc.float() * A[None, None, None, :]          # (b,c,l,h) log
    xdt = xc * dtc[..., None].to(xt)

    # intra-chunk (dual quadratic form)
    L = torch.exp(_segsum(dA.movedim(-1, 2)))          # (b,c,h,l,l)
    CB = torch.einsum("bcln,bcmn->bclm", Cc, Bc)       # (b,c,l,l)
    y_diag = torch.einsum("bchlm,bcmhp->bclhp",
                          L.to(xt) * CB.to(xt)[:, :, None], xdt)

    # chunk states
    cum = torch.cumsum(dA, dim=2)                      # (b,c,l,h)
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)     # (b,c,l,h)
    states = torch.einsum("bcln,bclhp->bchpn", Bc,
                          decay_out.to(xt)[..., None] * xdt)

    # inter-chunk recurrence: each chunk sees the state BEFORE it
    tot = cum[:, :, -1, :]                             # (b,c,h)
    st = (x.new_zeros((b, h, pdim, n)) if init_state is None
          else init_state.to(xt))
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * torch.exp(tot[:, c])[:, :, None, None].to(xt) \
            + states[:, c]
    prev_states = torch.stack(prev, dim=1)             # (b,c,h,p,n)

    decay_in = torch.exp(cum)                          # (b,c,l,h)
    y_off = torch.einsum("bcln,bchpn->bclhp", Cc, prev_states) \
        * decay_in.to(xt)[..., None]
    y = (y_diag + y_off).reshape(b, s, h, pdim)
    return y, st


def mamba2_forward(p: Mamba2, u: torch.Tensor, cfg, dtype,
                   state: Optional[Tuple] = None, rt=None):
    """u (B,S,d). state = (ssm_state (B,h,p,n), conv_state (B,K-1,C)) for
    streaming. Returns (out (B,S,d), new_state): one token against a state
    takes the recurrent update, anything else the chunked scan.

    Under ``rt``'s mesh the projections are DTensor products and the mixer
    between them (:func:`_mixer`: the conv, the scan's cumsums and the
    gated norm, which DTensor has no rules for) runs on each rank's batch
    rows, its input redistributed to the TP axis replicated."""
    if rt is not None and rt.mesh is not None:
        zxbcdt = dense(p.in_proj, u)
        B = u.shape[0]
        b3, b4, b5 = (rt.batch_spec(B, n) for n in (3, 4, 5))
        ssm_in, conv_in = (None, None) if state is None else state
        params = (p.conv_w, p.conv_b, p.A_log, p.D, p.dt_bias, p.norm.g)
        pl = [rt.placements_for(zxbcdt.shape, b3)]
        pl.append(rt.placements_for((B, 1, 1, 1), b4))
        pl.append(pl[0])
        y, final, conv_out = rt.local(
            lambda z, ssm, conv, *w: _mixer(z, *w, cfg, dtype,
                                            None if ssm is None
                                            else (ssm, conv)),
            (zxbcdt, ssm_in, conv_in) + params,
            (b3, b4, b3) + ((),) * len(params), pl)
        return dense(p.out_proj, y), (final, conv_out)
    y, final, conv_out = _mixer(dense(p.in_proj, u), p.conv_w, p.conv_b,
                                p.A_log, p.D, p.dt_bias, p.norm.g, cfg,
                                dtype, state)
    return dense(p.out_proj, y), (final, conv_out)


def _mixer(zxbcdt, conv_w, conv_b, A_log, Dp, dt_bias, norm_g, cfg, dtype,
           state):
    """The mixer between the two projections: the causal conv, the scan
    (or the recurrent step) and the gated norm. Returns (y (B,S,d_inner),
    the ssm state, the conv state)."""
    di, st, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    pdim = cfg.ssm_headdim
    B, S = zxbcdt.shape[:2]
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + di + 2 * st]
    dt = zxbcdt[..., di + di + 2 * st:]
    conv_in = None if state is None else state[1]
    xBC, conv_out = _causal_conv(xBC, conv_w, conv_b, conv_in)
    xBC = F.silu(xBC)
    x = xBC[..., :di].reshape(B, S, h, pdim)
    Bm = xBC[..., di:di + st]
    Cm = xBC[..., di + st:]
    dtf = dt.float() + dt_bias
    dtv = torch.logaddexp(dtf, dtf.new_zeros(()))     # jax.nn.softplus
    A = -torch.exp(A_log)
    ssm_in = None if state is None else state[0]

    if S == 1 and state is not None:
        # recurrent decode step
        dA = torch.exp(dtv[:, 0, :] * A[None, :])              # (B,h)
        inc = torch.einsum("bn,bhp->bhpn", Bm[:, 0].to(dtype),
                           x[:, 0] * dtv[:, 0, :, None].to(dtype))
        new_ssm = ssm_in * dA[:, :, None, None].to(dtype) + inc
        y = torch.einsum("bhpn,bn->bhp", new_ssm,
                         Cm[:, 0].to(new_ssm.dtype))
        y = y[:, None]                                         # (B,1,h,p)
        final = new_ssm
    else:
        y, final = ssd_chunked(x, dtv, A, Bm, Cm, cfg.ssm_chunk, ssm_in)
    y = y + x * Dp.to(dtype)[None, None, :, None]
    y = y.reshape(B, S, di)
    y = rmsnorm(SimpleNamespace(g=norm_g), y * F.silu(z), cfg.norm_eps)
    return y, final, conv_out
