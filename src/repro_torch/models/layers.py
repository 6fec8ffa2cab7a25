"""Shared layers of the LM substrate, ported from the reference's
``models/layers.py``: norms, rotary embeddings (with M-RoPE), GQA/MQA/MHA
attention with a KV cache, GLU and GELU MLPs, the embedding and its
transpose.

Parameters live in small ``nn.Module``s with the reference's names and
head-shaped layouts (``wq (D, H, hd)``, ``wo (H, hd, D)``), in a storage
dtype the model is built with: the config's compute dtype for serving
(rounding once at load gives the values the reference's casts give), or
float32 masters for training, as the reference keeps them. Every use casts
a weight to the compute dtype, as the reference's ``.astype(dtype)`` does
(``Tensor.to`` returns the weight itself where the dtypes agree), so a
weight used several times gets one gradient per use in the compute dtype,
summed in its own. Norm gains stay float32, as the reference applies them
in float32. The functions take a module, as the reference's take a dict.

Attention without a KV cache forks on ``backend``: ``"cuda"`` runs the
hand-written flash-attention kernel (:mod:`repro_torch.kernels.
flash_attention`) inside :func:`flash_attention_trainable`, whose backward
is the ``"torch"`` arm's, the reference's ``_sdpa`` / ``_sdpa_chunked``.
Attention against a KV cache is plain torch on both arms: each request is
masked at its own position, a function the TPU kernel never computed.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import flash_attention_cuda


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def trunc_normal_(t: torch.Tensor, scale: float,
                  generator: torch.Generator) -> torch.Tensor:
    """``scale`` x a normal truncated to [-2, 2] (the reference's
    ``layers._init``), drawn in float32 and cast to ``t``'s dtype."""
    x = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    with torch.no_grad():
        t.copy_(x.mul_(scale))
    return t


class Dense(nn.Module):
    def __init__(self, d_in, d_out, bias=False, *, dtype, device):
        super().__init__()
        self.w = _param((d_in, d_out), dtype, device)
        self.b = _param((d_out,), dtype, device) if bias else None

    def reset(self, generator):
        trunc_normal_(self.w, 1.0 / np.sqrt(self.w.shape[0]), generator)
        if self.b is not None:
            nn.init.zeros_(self.b)


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    """``x @ w (+ b)`` in x's dtype, the compute dtype."""
    y = x @ p.w.to(x.dtype)
    if p.b is not None:
        y = y + p.b.to(x.dtype)
    return y


class RMSNorm(nn.Module):
    def __init__(self, d, *, device):
        super().__init__()
        self.g = _param((d,), torch.float32, device)

    def reset(self, generator=None):
        nn.init.ones_(self.g)


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * p.g).to(dt)


class LayerNorm(nn.Module):
    def __init__(self, d, *, device):
        super().__init__()
        self.g = _param((d,), torch.float32, device)
        self.b = _param((d,), torch.float32, device)

    def reset(self, generator=None):
        nn.init.ones_(self.g)
        nn.init.zeros_(self.b)


def layernorm(p: LayerNorm, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * p.g + p.b).to(dt)


# ---------------------------------------------------------------------------
# Rotary embeddings


def _rope_freqs(half: int, theta: float, device) -> torch.Tensor:
    """The rotary frequencies ``theta ** (-arange(half) / half)``: the
    float32 power taken in float64 and rounded once, which matches the
    reference's float32 ``theta ** x`` where torch's own float32 power is
    off by an ulp in a few slots."""
    expo = -(torch.arange(0, half, dtype=torch.float32, device=device)
             / half)
    base = torch.tensor(float(np.float32(theta)), dtype=torch.float64,
                        device=device)
    return torch.pow(base, expo.double()).float()


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> cos/sin (..., S, head_dim//2), float32."""
    freqs = _rope_freqs(head_dim // 2, theta, positions.device)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                 sections: Tuple[int, int, int]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multimodal RoPE (Qwen2-VL): positions (3, B, S) are (t, h, w) ids;
    frequency slot ``j`` takes the component whose section holds it ->
    cos/sin (B, S, head_dim//2), float32."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"head_dim // 2 = {half}")
    dev = positions.device
    freqs = _rope_freqs(half, theta, dev)
    comp = torch.cat([torch.full((s,), i, dtype=torch.long, device=dev)
                      for i, s in enumerate(sections)])
    p = positions.float().movedim(0, -1)              # (B, S, 3)
    ang = p[..., comp] * freqs                         # (B, S, half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (B, S, H, hd); cos/sin (B, S, half) or (S, half)."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA / MQA / MHA) with optional KV cache


class Attention(nn.Module):
    """Head-shaped projections: wq (D, H, hd), wk/wv (D, KV, hd), wo (H, hd,
    D), optional biases bq (H, hd), bk/bv (KV, hd)."""

    def __init__(self, d_model, n_heads, n_kv, head_dim, bias=False, *,
                 dtype, device):
        super().__init__()
        self.wq = _param((d_model, n_heads, head_dim), dtype, device)
        self.wk = _param((d_model, n_kv, head_dim), dtype, device)
        self.wv = _param((d_model, n_kv, head_dim), dtype, device)
        self.wo = _param((n_heads, head_dim, d_model), dtype, device)
        for name, h in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            setattr(self, name,
                    _param((h, head_dim), dtype, device) if bias else None)

    def reset(self, generator):
        d_model, n_heads, head_dim = self.wq.shape
        for w in (self.wq, self.wk, self.wv):
            trunc_normal_(w, 1.0 / np.sqrt(d_model), generator)
        trunc_normal_(self.wo, 1.0 / np.sqrt(n_heads * head_dim), generator)
        for b in (self.bq, self.bk, self.bv):
            if b is not None:
                nn.init.zeros_(b)


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """GQA: repeat KV heads to the full head count, each head ``rep`` times
    in place (``jnp.repeat``)."""
    rep = n_heads // k.shape[2]
    return k.repeat_interleave(rep, dim=2) if rep > 1 else k


def _sdpa(q, k, v, mask, dtype):
    """q (B,S,H,hd), k/v (B,T,H,hd) (KV already repeated). float32 softmax;
    mask broadcastable to (B,H,S,T)."""
    hd = q.shape[-1]
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float())
    scores = scores / np.sqrt(hd)
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


# Sequences at or above this length use the query-chunked attention path
# (the reference's threshold: the full S x S float32 score buffer is what
# it avoids).
ATTN_CHUNK_THRESHOLD = 2048
ATTN_Q_CHUNK = 1024


def _sdpa_chunked(q, k, v, causal, dtype, chunk=ATTN_Q_CHUNK):
    """Query chunks of ``chunk`` rows, each attending to the full K/V with a
    positionwise causal mask; the peak score buffer is (B, H, chunk, T).
    Under autograd each chunk is checkpointed, as the reference's
    ``jax.checkpoint`` does: the backward recomputes a chunk's scores
    instead of keeping every chunk's probabilities."""
    S, T = q.shape[1], k.shape[1]
    t_pos = torch.arange(T, device=q.device)
    remat = torch.is_grad_enabled()
    outs = []
    for i in range(S // chunk):
        pos_q = i * chunk + torch.arange(chunk, device=q.device)
        if causal:
            mask = (t_pos[None, :] <= pos_q[:, None])[None, None]
        else:
            mask = torch.ones((1, 1, chunk, T), dtype=torch.bool,
                              device=q.device)
        qc = q[:, i * chunk:(i + 1) * chunk]
        if remat:
            outs.append(checkpoint(_sdpa, qc, k, v, mask, dtype,
                                   use_reentrant=False))
        else:
            outs.append(_sdpa(qc, k, v, mask, dtype))
    return torch.cat(outs, dim=1)


def sdpa_backward(q, k, v, dout, causal):
    """``(dq, dk, dv)`` of the ``"torch"`` arm's attention (``_sdpa`` in
    q's dtype, keys ``repeat_kv``'d to the query heads) at q ``(B, S, H,
    hd)``, k/v ``(B, T, KV, hd)`` for the output gradient ``dout``. Each
    chunk of ``ATTN_Q_CHUNK`` query rows is recomputed under autograd and
    differentiated alone, so one chunk's (B, H, chunk, T) buffers are the
    peak, as in the reference's ``jax.checkpoint`` of each
    ``_sdpa_chunked`` step; the causal mask is aligned top-left from
    position 0, and a causal chunk reads only the keys its rows can see
    (the others' probabilities are exactly 0). dk and dv sum the chunks in
    float32."""
    S, H, T = q.shape[1], q.shape[2], k.shape[1]
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    with torch.enable_grad():
        for s0 in range(0, S, ATTN_Q_CHUNK):
            s1 = min(S, s0 + ATTN_Q_CHUNK)
            t1 = min(T, s1) if causal else T
            if causal:
                pos_q = torch.arange(s0, s1, device=q.device)
                mask = (torch.arange(t1, device=q.device)[None, :]
                        <= pos_q[:, None])[None, None]
            else:
                mask = torch.ones((1, 1, s1 - s0, t1), dtype=torch.bool,
                                  device=q.device)
            qc = q[:, s0:s1].detach().requires_grad_()
            kc = k[:, :t1].detach().requires_grad_()
            vc = v[:, :t1].detach().requires_grad_()
            out = _sdpa(qc, repeat_kv(kc, H), repeat_kv(vc, H), mask,
                        q.dtype)
            gq, gk, gv = torch.autograd.grad(out, (qc, kc, vc),
                                             dout[:, s0:s1])
            dq[:, s0:s1] = gq
            dk[:, :t1] += gk
            dv[:, :t1] += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """The flash kernel's forward with the ``"torch"`` arm's backward
    (:func:`sdpa_backward` on the saved q, k, v)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, forward):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return forward(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        return (*sdpa_backward(q, k, v, dout, ctx.causal), None, None)


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              forward: Callable = flash_attention_cuda
                              ) -> torch.Tensor:
    """:func:`~repro_torch.kernels.flash_attention.flash_attention_cuda`
    with a gradient: the forward is the kernel the wrapper routes to (it
    raises where no kernel takes q, k, v: nothing falls back), the backward
    the ``"torch"`` arm's (:func:`sdpa_backward`). The reference's TPU
    kernel has no backward kernel (its model differentiates the plain
    ``_sdpa_chunked``), so neither has the port. ``forward`` replaces the
    kernel, for a test of the backward on the CPU."""
    return _FlashAttention.apply(q, k, v, causal, forward)


def attention(
    p: Attention, x: torch.Tensor, cos, sin, *,
    n_heads: int, n_kv: int, head_dim: int, dtype,
    causal: bool = True,
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_pos: Optional[torch.Tensor] = None,
    kv: Optional[torch.Tensor] = None,     # cross-attention source
    backend: str = "torch",
    rt=None,
):
    """Returns (out (B,S,D), the KV cache or None).

    Modes:
      - training/prefill: kv_cache=None -> full causal self attention
      - decode:  kv_cache=(K (B,T,kv,hd), V), cache_pos (B,) write index;
                 the new tokens are written into K and V in place (the
                 reference returns updated copies) at ``cache_pos`` clamped
                 to ``[0, T - S]``, as ``dynamic_update_slice`` clamps, in
                 the cache's dtype, and read back in ``dtype``
      - cross:   kv = encoder states (no cache logic, no causal mask)

    ``backend`` forks the modes without a cache: ``"cuda"`` -> the flash
    kernel (with the ``"torch"`` arm's backward,
    :func:`flash_attention_trainable`), ``"torch"`` -> ``_sdpa`` /
    ``_sdpa_chunked``.

    ``rt`` (a :class:`~repro_torch.distributed.sharding.Runtime` with a
    mesh) runs :func:`_attention_sharded` instead.
    """
    if rt is not None and rt.mesh is not None:
        return _attention_sharded(
            p, x, cos, sin, n_heads=n_heads, n_kv=n_kv, head_dim=head_dim,
            dtype=dtype, causal=causal, kv_cache=kv_cache,
            cache_pos=cache_pos, kv=kv, backend=backend, rt=rt)
    B, S, D = x.shape
    src = x if kv is None else kv.to(dtype)
    Ts = src.shape[1]

    def w(t):
        return t.to(dtype)
    q = (x @ w(p.wq).reshape(D, -1)).view(B, S, n_heads, head_dim)
    k = (src @ w(p.wk).reshape(D, -1)).view(B, Ts, n_kv, head_dim)
    v = (src @ w(p.wv).reshape(D, -1)).view(B, Ts, n_kv, head_dim)
    if p.bq is not None:
        q = q + w(p.bq)
        k = k + w(p.bk)
        v = v + w(p.bv)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        if kv is None:
            k = apply_rope(k, cos, sin)
    new_cache = None
    if kv_cache is not None:
        K, V = kv_cache
        T = K.shape[1]
        start = cache_pos.long().clamp(0, T - S)
        rows = start[:, None] + torch.arange(S, device=x.device)
        bidx = torch.arange(B, device=x.device)[:, None]
        K[bidx, rows] = k.to(K.dtype)
        V[bidx, rows] = v.to(V.dtype)
        new_cache = (K, V)
        iota_t = torch.arange(T, device=x.device)[None, :]
        mask = (iota_t <= cache_pos.long()[:, None])[:, None, None, :]
        out = _sdpa(q, repeat_kv(K.to(dtype), n_heads),
                    repeat_kv(V.to(dtype), n_heads), mask, dtype)
    else:
        out = _attend(q, k, v, causal and kv is None, backend, dtype)
    out = out.reshape(B, S, n_heads * head_dim) @ w(p.wo).reshape(-1, D)
    return out, new_cache


def _attend(q, k, v, is_causal: bool, backend: str, dtype):
    """Attention without a cache: q (B, S, H, hd), k/v (B, T, KV, hd)."""
    S, Ts, n_heads = q.shape[1], k.shape[1], q.shape[2]
    if backend == "cuda":
        return flash_attention_trainable(q, k, v, causal=is_causal)
    kf, vf = repeat_kv(k, n_heads), repeat_kv(v, n_heads)
    if S >= ATTN_CHUNK_THRESHOLD and S % ATTN_Q_CHUNK == 0:
        return _sdpa_chunked(q, kf, vf, is_causal, dtype)
    if is_causal:
        mask = torch.ones((S, Ts), dtype=torch.bool,
                          device=q.device).tril()[None, None]
    else:
        mask = torch.ones((1, 1, S, Ts), dtype=torch.bool, device=q.device)
    return _sdpa(q, kf, vf, mask, dtype)


def _attention_sharded(p: Attention, x, cos, sin, *, n_heads, n_kv,
                       head_dim, dtype, causal, kv_cache, cache_pos, kv,
                       backend, rt):
    """:func:`attention` under ``rt``'s mesh. The projections are DTensor
    products on the sharded weights; the rest runs on each rank's shards
    (``rt.local``), as the reference's GSPMD and ``shard_map`` place it.

    Without a cache, q, k and v go to their heads over the TP axis
    (``hint_heads``; k and v stay whole where the KV heads do not divide,
    and each rank repeats them to its own query heads), and each rank
    applies rope and runs :func:`_attend` (the flash kernel on the
    ``"cuda"`` arm: a ctypes kernel takes no DTensor) on its batch rows
    and heads. In decode (one token), the cache must lie as
    ``rt.kv_seq_spec()`` says: each rank writes the new K and V only where
    the position falls in its own slice of the sequence (DTensor has no
    rule for that indexed write), then ``rt.flash_decode`` attends over
    the slices, their max and sums reduced across them."""
    from ..distributed.sharding import Shard
    B, S, D = x.shape
    src = x if kv is None else kv.to(dtype)
    Ts = src.shape[1]

    def w(t):
        return t.to(dtype)
    q = (x @ w(p.wq).reshape(D, -1)).view(B, S, n_heads, head_dim)
    k = (src @ w(p.wk).reshape(D, -1)).view(B, Ts, n_kv, head_dim)
    v = (src @ w(p.wv).reshape(D, -1)).view(B, Ts, n_kv, head_dim)
    if p.bq is not None:
        q = q + w(p.bq)
        k = k + w(p.bk)
        v = v + w(p.bv)
    rope_k = cos is not None and kv is None
    b4 = rt.batch_spec(B, 4)
    b3 = rt.batch_spec(B, 3)

    if kv_cache is None:
        q = rt.hint_heads(q)
        heads = isinstance(q.placements[rt.mesh.mesh_dim_names.index(
            rt.tp_axis)], Shard)
        kv_spec = (b4[0], None, rt.tp_axis, None) \
            if heads and n_kv % rt.size(rt.tp_axis) == 0 else b4
        is_causal = causal and kv is None
        tp_rank = rt.mesh.get_local_rank(rt.tp_axis)

        def body(q_, k_, v_, cos_, sin_):
            if cos_ is not None:
                q_ = apply_rope(q_, cos_, sin_)
                if rope_k:
                    k_ = apply_rope(k_, cos_, sin_)
            h_loc = q_.shape[2]
            if h_loc < n_heads and k_.shape[2] == n_kv:
                # whole KV heads here: this rank's query heads' share
                h0 = tp_rank * h_loc
                k_ = repeat_kv(k_, n_heads)[:, :, h0:h0 + h_loc]
                v_ = repeat_kv(v_, n_heads)[:, :, h0:h0 + h_loc]
            return _attend(q_, k_, v_, is_causal, backend, dtype)
        out = rt.local(body, (q, k, v, cos, sin),
                       ((b4[0], None, rt.tp_axis, None), kv_spec, kv_spec,
                        b3, b3), q.placements)
    else:
        if S != 1:
            raise ValueError(f"sharded decode writes one token a step, got "
                             f"{S}")
        K, V = kv_cache
        want = rt.placements_for(K.shape, rt.kv_seq_spec())
        for name, t in (("K", K), ("V", V)):
            if tuple(t.placements) != want:
                raise ValueError(f"the {name} cache lies as {t.placements}, "
                                 f"not as the runtime's kv_seq_spec {want} "
                                 f"(lm.init_cache(..., rt=rt))")
        T = K.shape[1]
        K_l, V_l = K.to_local(), V.to_local()
        t_loc = K_l.shape[1]
        # the sequence is split where the cache's spec kept its axes
        split = any(isinstance(pl, Shard) and pl.dim == 1 for pl in want)
        off = rt.seq_offset(t_loc) if split else 0
        # the cache's own batch split (none for a long context's)
        b = rt.batch_axes if any(isinstance(pl, Shard) and pl.dim == 0
                                 for pl in want) else None

        def write(q_, k_, v_, cos_, sin_, pos_):
            if cos_ is not None:
                q_ = apply_rope(q_, cos_, sin_)
                k_ = apply_rope(k_, cos_, sin_)
            rows = pos_.long().clamp(0, T - 1) - off
            mine = ((rows >= 0) & (rows < t_loc))[:, None, None]
            r = rows.clamp(0, t_loc - 1)
            bidx = torch.arange(q_.shape[0], device=q_.device)
            for C, new in ((K_l, k_), (V_l, v_)):
                C[bidx, r] = torch.where(mine, new[:, 0].to(C.dtype),
                                         C[bidx, r])
            return q_
        bq = (b, None, None, None)
        q = rt.local(write, (q, k, v, cos, sin, cache_pos),
                     (bq, bq, bq, (b, None, None), (b, None, None), (b,)),
                     rt.placements_for(q.shape, bq))
        out = rt.flash_decode(q, K, V, cache_pos)
    out = rt.hint_heads(out)
    out = out.reshape(B, S, n_heads * head_dim) @ w(p.wo).reshape(-1, D)
    return out, kv_cache


# ---------------------------------------------------------------------------
# MLPs

_ACT = {"silu": F.silu,
        # jax.nn.gelu defaults to the tanh approximation
        "gelu": lambda x: F.gelu(x, approximate="tanh")}


class GluMLP(nn.Module):
    def __init__(self, d_model, d_ff, *, dtype, device):
        super().__init__()
        self.wi = Dense(d_model, d_ff, dtype=dtype, device=device)
        self.wg = Dense(d_model, d_ff, dtype=dtype, device=device)
        self.wo = Dense(d_ff, d_model, dtype=dtype, device=device)


def glu_mlp(p: GluMLP, x, activation: str = "silu"):
    h = _ACT[activation](dense(p.wg, x)) * dense(p.wi, x)
    return dense(p.wo, h)


class GeluMLP(nn.Module):
    def __init__(self, d_model, d_ff, *, dtype, device):
        super().__init__()
        self.wi = Dense(d_model, d_ff, dtype=dtype, device=device)
        self.wo = Dense(d_ff, d_model, dtype=dtype, device=device)


def gelu_mlp(p: GeluMLP, x):
    return dense(p.wo, _ACT["gelu"](dense(p.wi, x)))


# ---------------------------------------------------------------------------
# Embedding


class Embed(nn.Module):
    def __init__(self, vocab, d_model, *, dtype, device):
        super().__init__()
        self.table = _param((vocab, d_model), dtype, device)

    def reset(self, generator):
        trunc_normal_(self.table, 1.0, generator)


def unembed(p: Embed, x: torch.Tensor) -> torch.Tensor:
    """Logits via the (possibly tied) embedding table."""
    return x @ p.table.to(x.dtype).T


def xent_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position cross entropy in float32: the logsumexp less the gold
    logit (read by a gather, the number the reference's one-hot dot
    gives)."""
    lf = logits.float()
    gold = lf.gather(-1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(lf, dim=-1) - gold


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross entropy (:func:`xent_nll`), over ``mask`` where one is
    given (at least one position)."""
    nll = xent_nll(logits, labels)
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp_min(1)
    return nll.mean()
