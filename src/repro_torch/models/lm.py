"""Language-model assembly of the LM substrate, ported from the reference's
``models/lm.py`` for the ``dense`` and ``encdec`` families: the serving
path (prefill, KV cache, one-token decode).

The reference stacks each layer's parameters on a leading L axis and runs
the stack under ``lax.scan``; here a model is an ``nn.Module`` per family
(:class:`DenseLM`, :class:`EncDecLM`) holding a ``ModuleList`` of blocks,
run by a Python loop. Parameter names follow the reference's tree
(``layers.<l>.attn.wq``, ``embed.table``, ``ln_f.g``, ...), so
:func:`params_from_reference` loads a reference parameter tree as it is.
The families ``moe``, ``ssm``, ``hybrid`` and ``vlm`` raise
``NotImplementedError``. There is no ``Runtime``: with ``mesh=None`` every
sharding hint of the reference is the identity (sharding the LM is ROADMAP
queue 1 item 3).

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
from . import layers

# what each family that is not ported yet waits for
_NOT_PORTED = {
    "moe": "ROADMAP queue 1 item 3 (models/moe.py)",
    "ssm": "ROADMAP queue 1 item 3 (models/mamba2.py)",
    "hybrid": "ROADMAP queue 1 item 3 (models/mamba2.py)",
    "vlm": "ROADMAP queue 1 item 3 (mrope_angles, the vision inputs)",
}
# parameter groups the reference stacks on a leading layer axis
_STACKED = ("layers", "enc_layers", "dec_layers")


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_family(cfg) -> None:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"the {cfg.family} family ({cfg.name}) is not ported yet: "
            f"{_NOT_PORTED[cfg.family]}")
    if cfg.family not in ("dense", "encdec"):
        raise ValueError(cfg.family)


def _norm(cfg):
    if cfg.norm == "layernorm":
        return layers.LayerNorm, layers.layernorm
    return layers.RMSNorm, layers.rmsnorm


# ===========================================================================
# Modules


class Block(nn.Module):
    """ln1 -> attention -> ln2 -> MLP, plus ln_x -> cross attention in a
    decoder block."""

    def __init__(self, cfg, *, cross=False, dtype, device):
        super().__init__()
        norm, _ = _norm(cfg)
        self.ln1 = norm(cfg.d_model, device=device)
        self.attn = layers.Attention(cfg.d_model, cfg.n_heads,
                                     cfg.n_kv_heads, cfg.hd, cfg.qkv_bias,
                                     dtype=dtype, device=device)
        self.ln2 = norm(cfg.d_model, device=device)
        mlp = layers.GeluMLP if cfg.norm == "layernorm" else layers.GluMLP
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
    def __init__(self, cfg, *, device):
        super().__init__(cfg, device=device)
        self.layers = nn.ModuleList(
            Block(cfg, dtype=_dtype(cfg), device=device)
            for _ in range(cfg.n_layers))


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


def build(cfg, device) -> _LM:
    """The family's module with uninitialised weights on ``device``."""
    _check_family(cfg)
    cls = EncDecLM if cfg.family == "encdec" else DenseLM
    return cls(cfg, device=torch.device(device))


def init_params(cfg, generator: torch.Generator, device) -> _LM:
    """Random weights at the reference's scales: truncated normals in
    [-2, 2] x 1/sqrt(fan-in) for projections (1/sqrt(H*hd) for wo), x 1
    for the embedding, x 0.02 for the encdec position tables; norm gains 1,
    biases 0. Drawn from ``generator`` (on ``device``) in module order; the
    numbers differ from the reference's JAX PRNG."""
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


def params_from_reference(tree: Dict[str, Any], cfg, device) -> _LM:
    """Load the reference's parameter tree (nested dicts of numpy arrays,
    e.g. ``jax.tree.map(np.asarray, params)``): the leading-L arrays of
    ``layers`` / ``enc_layers`` / ``dec_layers`` are unstacked into the
    blocks, every array is cast to its parameter's dtype. Every parameter
    must be given, with the reference's shape."""
    model = build(cfg, device)
    state = {}
    for name, arr in _flatten(tree):
        group, _, rest = name.partition(".")
        arr = np.asarray(arr)
        if group in _STACKED:
            for i in range(arr.shape[0]):
                state[f"{group}.{i}.{rest}"] = arr[i]
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
    if cfg.norm == "layernorm":
        h2 = layers.gelu_mlp(p.mlp, hin)
    else:
        h2 = layers.glu_mlp(p.mlp, hin, cfg.activation)
    return x + h2


def _rope(cfg, positions):
    """positions (B, S) -> (cos, sin) (B, S, half)."""
    return layers.rope_angles(positions, cfg.hd, cfg.rope_theta)


# ===========================================================================
# Forward passes (teacher-forced / prefill)


def _embed_inputs(params, batch):
    """-> (x (B,S,D), positions for rope)."""
    tokens = batch["tokens"]
    x = layers.embed(params.embed, tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    return x, positions


def backbone(params, x, positions, cfg, backend, caches=None, pos=None):
    """Run the dense stack. caches=(K, V) (L, B, T, KV, hd) and pos given ->
    decode mode, writing each layer's cache in place. Returns (hidden,
    caches)."""
    dtype = _dtype(cfg)
    cos_sin = _rope(cfg, positions)
    for i, lp in enumerate(params.layers):
        cache = (caches[0][i], caches[1][i]) if caches is not None else None
        x = _attn_block(lp, x, cos_sin, cfg, dtype, backend, cache=cache,
                        pos=pos)
    return x, caches


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
    encdec (None for dense)."""
    _check_family(cfg)
    backend = _backend(params, backend)
    with _full_fp32():
        if cfg.family == "encdec":
            enc = _encdec_encode(params, batch["frames"], cfg, backend)
            x = layers.embed(params.embed, batch["tokens"])
            x = x + params.pos_dec[: x.shape[1]][None]
            h, _ = _encdec_decode_stack(params, x, enc, cfg, backend)
            return _final_logits(params, h[:, -1:], cfg), enc
        x, positions = _embed_inputs(params, batch)
        h, _ = backbone(params, x, positions, cfg, backend)
        return _final_logits(params, h[:, -1:], cfg), None


def init_cache(cfg, batch_size: int, seq_len: int, device,
               dtype=torch.bfloat16):
    """Zeroed decode caches, bf16 whatever ``cfg.dtype`` (the reference's
    default): dense ``(K, V)`` of ``(L, B, T, KV, hd)``; encdec ``((K, V),
    enc (B, T, D))``."""
    _check_family(cfg)
    shape = (cfg.n_layers, batch_size, seq_len, cfg.n_kv_heads, cfg.hd)
    kv = (torch.zeros(shape, dtype=dtype, device=device),
          torch.zeros(shape, dtype=dtype, device=device))
    if cfg.family == "encdec":
        return kv, torch.zeros((batch_size, seq_len, cfg.d_model),
                               dtype=dtype, device=device)
    return kv


@torch.no_grad()
def decode_fn(params, cache, batch, cfg, backend: Optional[str] = None):
    """One decode step: batch = {token (B,1), pos (B,)}. Returns (logits
    (B,1,V), cache); the new token's K/V are written into ``cache`` in
    place."""
    _check_family(cfg)
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
        h, new = backbone(params, x, pos[:, None], cfg, backend,
                          caches=cache, pos=pos)
        return _final_logits(params, h, cfg), new
