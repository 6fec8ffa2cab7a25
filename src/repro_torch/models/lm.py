"""Language-model assembly of the LM substrate, ported from the reference's
``models/lm.py``: the serving path (prefill, caches, one-token decode) of
all six families: ``dense``, ``moe`` (:mod:`.moe`), ``vlm`` (M-RoPE and
vision embeddings in front of the text), ``ssm`` (:mod:`.mamba2`),
``hybrid`` (Mamba2 layers with one weight-shared attention block every
``attn_every`` layers) and ``encdec``.

The reference stacks each layer's parameters on a leading L axis (two for
the hybrid's ``(groups, attn_every)``) and runs the stack under
``lax.scan``; here a model is an ``nn.Module`` per family (:class:`DenseLM`
for dense, moe and vlm, :class:`SSMLM`, :class:`HybridLM`,
:class:`EncDecLM`) holding ``ModuleList`` s of blocks, run by Python loops.
Parameter names follow the reference's tree (``layers.<l>.attn.wq``,
``layers.<g>.<j>.mix.A_log``, ``embed.table``, ...), so
:func:`params_from_reference` loads a reference parameter tree as it is.
There is no ``Runtime``: with ``mesh=None`` every sharding hint of the
reference is the identity and ``moe_apply`` is the local ``moe_ffn``
(sharding the LM is ROADMAP queue 1 item 3.5).

Entry points (used by ``launch/{steps,serve}.py``):
  init_params(cfg, generator, device)        -> model (random weights)
  params_from_reference(tree, cfg, device)   -> model (the reference's)
  prefill_fn(params, batch, cfg, backend)    -> (last_logits, state)
  init_cache(cfg, batch, seq, device)        -> zeroed cache
  decode_fn(params, cache, batch, cfg, backend) -> (logits, cache)

``backend`` (``None``, ``"cuda"`` or ``"torch"``) picks the attention arm
for the modes without a KV cache (:func:`layers.attention`); ``None`` is
``"cuda"`` on a card and ``"torch"`` on the CPU. Products run with TF32
off, so float32 configs compute in full float32.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..kernels.ops import resolve_backend
from . import layers, mamba2, moe

# parameter groups the reference stacks on a leading layer axis
_STACKED = ("layers", "enc_layers", "dec_layers")
# families whose stack is attention blocks (DenseLM)
_ATTN = ("dense", "moe", "vlm")


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _stack_depth(cfg, group: str) -> int:
    """Leading stacked axes of a reference parameter group: the hybrid's
    ``layers`` are ``(groups, attn_every, ...)``."""
    if group not in _STACKED:
        return 0
    return 2 if cfg.family == "hybrid" and group == "layers" else 1


def _norm(cfg):
    if cfg.norm == "layernorm":
        return layers.LayerNorm, layers.layernorm
    return layers.RMSNorm, layers.rmsnorm


# ===========================================================================
# Modules


class Block(nn.Module):
    """ln1 -> attention -> ln2 -> MLP (the MoE FFN in a moe model), plus
    ln_x -> cross attention in a decoder block."""

    def __init__(self, cfg, *, cross=False, dtype, device):
        super().__init__()
        norm, _ = _norm(cfg)
        self.ln1 = norm(cfg.d_model, device=device)
        self.attn = layers.Attention(cfg.d_model, cfg.n_heads,
                                     cfg.n_kv_heads, cfg.hd, cfg.qkv_bias,
                                     dtype=dtype, device=device)
        self.ln2 = norm(cfg.d_model, device=device)
        if cfg.family == "moe":
            self.moe = moe.MoE(cfg, dtype=dtype, device=device)
        else:
            mlp = layers.GeluMLP if cfg.norm == "layernorm" else \
                layers.GluMLP
            self.mlp = mlp(cfg.d_model, cfg.d_ff, dtype=dtype, device=device)
        if cross:
            self.ln_x = norm(cfg.d_model, device=device)
            self.xattn = layers.Attention(cfg.d_model, cfg.n_heads,
                                          cfg.n_kv_heads, cfg.hd,
                                          dtype=dtype, device=device)


class _LM(nn.Module):
    """The embedding, final norm and (untied) unembedding every family
    shares."""

    def __init__(self, cfg, *, device):
        super().__init__()
        self.cfg = cfg
        dt = _dtype(cfg)
        norm, _ = _norm(cfg)
        self.embed = layers.Embed(cfg.vocab, cfg.d_model, dtype=dt,
                                  device=device)
        self.ln_f = norm(cfg.d_model, device=device)
        if not cfg.tie_embeddings:
            self.unembed = layers.Dense(cfg.d_model, cfg.vocab, dtype=dt,
                                        device=device)


class DenseLM(_LM):
    """The attention stack of the dense, moe and vlm families."""

    def __init__(self, cfg, *, device):
        super().__init__(cfg, device=device)
        self.layers = nn.ModuleList(
            Block(cfg, dtype=_dtype(cfg), device=device)
            for _ in range(cfg.n_layers))


class MambaLayer(nn.Module):
    """ln -> Mamba2 mixer, with a residual."""

    def __init__(self, cfg, *, device):
        super().__init__()
        norm, _ = _norm(cfg)
        self.ln = norm(cfg.d_model, device=device)
        self.mix = mamba2.Mamba2(cfg, dtype=_dtype(cfg), device=device)


class SSMLM(_LM):
    def __init__(self, cfg, *, device):
        super().__init__(cfg, device=device)
        self.layers = nn.ModuleList(MambaLayer(cfg, device=device)
                                    for _ in range(cfg.n_layers))


class HybridLM(_LM):
    """``layers.<g>.<j>``: ``n_layers // attn_every`` groups of
    ``attn_every`` Mamba2 layers; ``shared_attn``: one attention block
    applied before every group, with ``in_proj (2D, D)`` taking the hidden
    state concatenated with the original embeddings."""

    def __init__(self, cfg, *, device):
        super().__init__(cfg, device=device)
        groups = cfg.n_layers // cfg.attn_every
        self.layers = nn.ModuleList(
            nn.ModuleList(MambaLayer(cfg, device=device)
                          for _ in range(cfg.attn_every))
            for _ in range(groups))
        dt = _dtype(cfg)
        self.shared_attn = Block(cfg, dtype=dt, device=device)
        self.shared_attn.in_proj = layers.Dense(2 * cfg.d_model, cfg.d_model,
                                                dtype=dt, device=device)


class EncDecLM(_LM):
    def __init__(self, cfg, *, device):
        super().__init__(cfg, device=device)
        dt = _dtype(cfg)
        norm, _ = _norm(cfg)
        self.enc_layers = nn.ModuleList(
            Block(cfg, dtype=dt, device=device)
            for _ in range(cfg.enc_layers))
        self.dec_layers = nn.ModuleList(
            Block(cfg, cross=True, dtype=dt, device=device)
            for _ in range(cfg.n_layers))
        self.pos_enc = layers._param((cfg.max_pos, cfg.d_model), dt, device)
        self.pos_dec = layers._param((cfg.max_pos, cfg.d_model), dt, device)
        self.ln_enc = norm(cfg.d_model, device=device)


_MODELS = {"dense": DenseLM, "moe": DenseLM, "vlm": DenseLM,
           "ssm": SSMLM, "hybrid": HybridLM, "encdec": EncDecLM}


def build(cfg, device) -> _LM:
    """The family's module with uninitialised weights on ``device``."""
    if cfg.family not in _MODELS:
        raise ValueError(cfg.family)
    return _MODELS[cfg.family](cfg, device=torch.device(device))


def init_params(cfg, generator: torch.Generator, device) -> _LM:
    """Random weights at the reference's scales: truncated normals in
    [-2, 2] x 1/sqrt(fan-in) for projections (1/sqrt(H*hd) for wo, 1/sqrt
    (F) for an expert's wo, 1/sqrt(K) for the conv taps), x 1 for the
    embedding, x 0.02 for the encdec position tables; norm gains 1, biases
    0; Mamba2's ``A_log = log(linspace(1, 16, heads))``, ``D = 1``,
    ``dt_bias = conv_b = 0``. Drawn from ``generator`` (on ``device``) in
    module order; the numbers differ from the reference's JAX PRNG."""
    model = build(cfg, device)
    for m in model.modules():
        if hasattr(m, "reset"):
            m.reset(generator)
    if cfg.family == "encdec":
        layers.trunc_normal_(model.pos_enc, 0.02, generator)
        layers.trunc_normal_(model.pos_dec, 0.02, generator)
    return model


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten(v, name + ".")
        else:
            yield name, v


def _unstack(prefix, rest, arr, depth):
    if depth == 0:
        yield f"{prefix}.{rest}", arr
        return
    for i in range(arr.shape[0]):
        yield from _unstack(f"{prefix}.{i}", rest, arr[i], depth - 1)


def params_from_reference(tree: Dict[str, Any], cfg, device) -> _LM:
    """Load the reference's parameter tree (nested dicts of numpy arrays,
    e.g. ``jax.tree.map(np.asarray, params)``): the stacked arrays of
    ``layers`` / ``enc_layers`` / ``dec_layers`` are unstacked into the
    blocks (both leading axes of the hybrid's ``layers``), every array is
    cast to its parameter's dtype. Every parameter must be given, with the
    reference's shape."""
    model = build(cfg, device)
    state = {}
    for name, arr in _flatten(tree):
        group, _, rest = name.partition(".")
        arr = np.asarray(arr)
        depth = _stack_depth(cfg, group)
        if depth:
            state.update(_unstack(group, rest, arr, depth))
        else:
            state[name] = arr
    own = dict(model.named_parameters())
    if set(state) != set(own):
        raise ValueError(
            f"parameter names differ from the model's: missing "
            f"{sorted(set(own) - set(state))[:5]}, unexpected "
            f"{sorted(set(state) - set(own))[:5]}")
    with torch.no_grad():
        for name, p in own.items():
            src = torch.from_numpy(np.ascontiguousarray(state[name]))
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)}, the "
                                 f"model's is {tuple(p.shape)}")
            p.copy_(src.to(p.dtype))
    return model


# ===========================================================================
# Blocks


def _attn_block(p: Block, x, cos_sin, cfg, dtype, backend, cache=None,
                pos=None, causal=True):
    _, nfn = _norm(cfg)
    cos, sin = cos_sin if cos_sin is not None else (None, None)
    h, _ = layers.attention(
        p.attn, nfn(p.ln1, x, cfg.norm_eps), cos, sin,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
        dtype=dtype, causal=causal, kv_cache=cache, cache_pos=pos,
        backend=backend)
    x = x + h
    hin = nfn(p.ln2, x, cfg.norm_eps)
    if cfg.family == "moe":
        B, S, D = hin.shape
        h2 = moe.moe_ffn(p.moe, hin.reshape(B * S, D), cfg).reshape(B, S, D)
    elif cfg.norm == "layernorm":
        h2 = layers.gelu_mlp(p.mlp, hin)
    else:
        h2 = layers.glu_mlp(p.mlp, hin, cfg.activation)
    return x + h2


def _rope(cfg, positions):
    """positions (B, S) or (3, B, S) for mrope -> (cos, sin) (B, S, half)."""
    if cfg.mrope:
        return layers.mrope_angles(positions, cfg.hd, cfg.rope_theta,
                                   cfg.mrope_sections)
    return layers.rope_angles(positions, cfg.hd, cfg.rope_theta)


# ===========================================================================
# Forward passes (teacher-forced / prefill)


def _embed_inputs(params, batch, cfg):
    """-> (x (B,S,D), positions for rope). A vlm batch's vision embeddings,
    cast to the compute dtype, go in front of the text, and its
    ``positions3d`` (3, B, S) are the rope positions."""
    tokens = batch["tokens"]
    x = layers.embed(params.embed, tokens)
    if cfg.family == "vlm":
        vis = batch["vision_embeds"].to(x.dtype)          # (B, Nv, D)
        x = torch.cat([vis, x], dim=1)
        return x, batch["positions3d"]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    return x, positions


def _mamba_stack(lps, h, cfg, dtype, states=None):
    """Mamba2 layers with residuals; ``states`` (ssm (n, B, h, p, n), conv
    (n, B, K-1, C)) -> decode. Returns (hidden, (ssm, conv) stacked over
    the layers: new tensors)."""
    _, nfn = _norm(cfg)
    ssm, conv = [], []
    for i, lp in enumerate(lps):
        st = None if states is None else (states[0][i], states[1][i])
        out, (s1, s2) = mamba2.mamba2_forward(
            lp.mix, nfn(lp.ln, h, cfg.norm_eps), cfg, dtype, state=st)
        h = h + out
        ssm.append(s1)
        conv.append(s2)
    return h, (torch.stack(ssm), torch.stack(conv))


def backbone(params, x, positions, cfg, backend, caches=None, pos=None):
    """Run the stack. caches and pos given -> decode mode (S == 1): the KV
    caches are written in place, the SSM states come back as new tensors.
    Returns (hidden, caches): the prefill of an ssm model returns its
    stacked (ssm, conv) states, of the others None."""
    dtype = _dtype(cfg)
    fam = cfg.family
    if fam in _ATTN:
        cos_sin = _rope(cfg, positions)
        for i, lp in enumerate(params.layers):
            cache = (caches[0][i], caches[1][i]) if caches is not None \
                else None
            x = _attn_block(lp, x, cos_sin, cfg, dtype, backend,
                            cache=cache, pos=pos)
        return x, caches
    if fam == "ssm":
        return _mamba_stack(params.layers, x, cfg, dtype, caches)
    if fam == "hybrid":
        cos_sin = _rope(cfg, positions)
        x0 = x        # the original embeddings feed every shared block
        shared = params.shared_attn
        ssm, conv = [], []
        for g, gp in enumerate(params.layers):
            kv = None if caches is None else \
                (caches[1][0][g], caches[1][1][g])
            hin = layers.dense(shared.in_proj, torch.cat([x, x0], dim=-1))
            x = x + _attn_block(shared, hin, cos_sin, cfg, dtype, backend,
                                cache=kv, pos=pos)
            st = None if caches is None else \
                (caches[0][0][g], caches[0][1][g])
            x, (s1, s2) = _mamba_stack(gp, x, cfg, dtype, st)
            ssm.append(s1)
            conv.append(s2)
        if caches is None:
            return x, None
        return x, ((torch.stack(ssm), torch.stack(conv)), caches[1])
    raise ValueError(fam)


def _final_logits(params, h, cfg):
    _, nfn = _norm(cfg)
    h = nfn(params.ln_f, h, cfg.norm_eps)
    if cfg.tie_embeddings:
        return layers.unembed(params.embed, h)
    return layers.dense(params.unembed, h)


# ===========================================================================
# Encoder-decoder (whisper)


def _encdec_encode(params, frames, cfg, backend):
    dtype = _dtype(cfg)
    _, nfn = _norm(cfg)
    x = frames.to(dtype)
    x = x + params.pos_enc[: x.shape[1]][None]
    for lp in params.enc_layers:
        x = _attn_block(lp, x, None, cfg, dtype, backend, causal=False)
    return nfn(params.ln_enc, x, cfg.norm_eps)


def _encdec_decode_stack(params, x, enc, cfg, backend, caches=None,
                         pos=None):
    dtype = _dtype(cfg)
    _, nfn = _norm(cfg)
    for i, lp in enumerate(params.dec_layers):
        cache = (caches[0][i], caches[1][i]) if caches is not None else None
        x = _attn_block(lp, x, None, cfg, dtype, backend, cache=cache,
                        pos=pos)
        xh, _ = layers.attention(
            lp.xattn, nfn(lp.ln_x, x, cfg.norm_eps), None, None,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
            dtype=dtype, kv=enc, backend=backend)
        x = x + xh
    return x, caches


# ===========================================================================
# Public API


@contextlib.contextmanager
def _full_fp32():
    """Products in full float32 (TF32 off) for the call; bf16 products do
    not use TF32 either way."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _backend(params, backend):
    return resolve_backend(backend, params.embed.table.device)


@torch.no_grad()
def prefill_fn(params, batch, cfg, backend: Optional[str] = None):
    """Teacher-forced forward for serving prefill: returns last-position
    logits (B, 1, vocab) in the compute dtype, and the encoder states for
    encdec, the stacked (ssm, conv) states for ssm (None for the rest)."""
    backend = _backend(params, backend)
    with _full_fp32():
        if cfg.family == "encdec":
            enc = _encdec_encode(params, batch["frames"], cfg, backend)
            x = layers.embed(params.embed, batch["tokens"])
            x = x + params.pos_dec[: x.shape[1]][None]
            h, _ = _encdec_decode_stack(params, x, enc, cfg, backend)
            return _final_logits(params, h[:, -1:], cfg), enc
        x, positions = _embed_inputs(params, batch, cfg)
        h, states = backbone(params, x, positions, cfg, backend)
        return _final_logits(params, h[:, -1:], cfg), states


def init_cache(cfg, batch_size: int, seq_len: int, device,
               dtype=torch.bfloat16):
    """Zeroed decode caches, bf16 whatever ``cfg.dtype`` (the reference's
    default): dense/moe/vlm ``(K, V)`` of ``(L, B, T, KV, hd)``; ssm
    ``(ssm (L, B, h, p, n), conv (L, B, K-1, d_inner + 2n))``; hybrid
    ``((ssm, conv) of (G, attn_every, ...), (K, V) of (G, B, T, KV, hd))``
    with G = n_layers // attn_every; encdec ``((K, V), enc (B, T, D))``.
    K and V are always two tensors."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    fam = cfg.family
    B = batch_size
    if fam in ("ssm", "hybrid"):
        h, pd, st = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
        conv_ch = cfg.d_inner + 2 * st
        lead = (cfg.n_layers,) if fam == "ssm" else \
            (cfg.n_layers // cfg.attn_every, cfg.attn_every)
        m = (zeros(*lead, B, h, pd, st),
             zeros(*lead, B, cfg.ssm_conv - 1, conv_ch))
        if fam == "ssm":
            return m
        kv_shape = (lead[0], B, seq_len, cfg.n_kv_heads, cfg.hd)
        return m, (zeros(*kv_shape), zeros(*kv_shape))
    if fam not in _ATTN + ("encdec",):
        raise ValueError(fam)
    shape = (cfg.n_layers, B, seq_len, cfg.n_kv_heads, cfg.hd)
    kv = (zeros(*shape), zeros(*shape))
    if fam == "encdec":
        return kv, zeros(B, seq_len, cfg.d_model)
    return kv


@torch.no_grad()
def decode_fn(params, cache, batch, cfg, backend: Optional[str] = None):
    """One decode step: batch = {token (B,1), pos (B,)} (+ positions3d (3,
    B, 1) for vlm). Returns (logits (B,1,V), cache); the new token's K/V
    are written into ``cache`` in place, SSM states are new tensors."""
    backend = _backend(params, backend)
    tok, pos = batch["token"], batch["pos"]
    with _full_fp32():
        x = layers.embed(params.embed, tok)
        if cfg.family == "encdec":
            (K, V), enc = cache
            x = x + params.pos_dec[pos.long()][:, None, :]
            h, nkv = _encdec_decode_stack(params, x, enc, cfg, backend,
                                          caches=(K, V), pos=pos)
            return _final_logits(params, h, cfg), (nkv, enc)
        positions = batch["positions3d"] if cfg.family == "vlm" else \
            pos[:, None]
        h, new = backbone(params, x, positions, cfg, backend, caches=cache,
                          pos=pos)
        return _final_logits(params, h, cfg), new
