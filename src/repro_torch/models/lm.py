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
Every entry point takes an optional ``rt``, the reference's
:class:`~repro_torch.distributed.sharding.Runtime`: with a mesh, the
parameters (``distribute_params``), the batch (``rt.shard_batch``) and the
caches (:func:`init_cache` with ``rt``) are DTensors, the reference's
sharding hints redistribute the activations, and the attention core, the
Mamba2 mixer, the MoE, the embedding gather and the cross entropy run on
each rank's shards; without ``rt`` (or with ``mesh=None``) every hint is
the identity and ``moe_apply`` is the local ``moe_ffn``. The two knobs a
single device uses, ``loss_chunk`` and ``remat``, are keyword arguments of
:func:`loss_fn`.

Entry points (used by ``launch/{steps,serve,train}.py``):
  init_params(cfg, generator, device)        -> model (random weights)
  params_from_reference(tree, cfg, device)   -> model (the reference's)
  loss_fn(params, batch, cfg, backend)       -> scalar loss (train batches)
  prefill_fn(params, batch, cfg, backend)    -> (last_logits, state)
  init_cache(cfg, batch, seq, device)        -> zeroed cache
  decode_fn(params, cache, batch, cfg, backend) -> (logits, cache)

A model's parameters are stored in ``param_dtype``: the compute dtype by
default (serving), float32 masters for training (the reference's). Every
use casts them to the compute dtype (:mod:`.layers`).

``backend`` (``None``, ``"cuda"`` or ``"torch"``) picks the attention arm
for the modes without a KV cache (:func:`layers.attention`); ``None`` is
``"cuda"`` on a card and ``"torch"`` on the CPU. Products run with TF32
off, so float32 configs compute in full float32.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn.utils.stateless import _reparametrize_module
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..distributed.sharding import NO_MESH, Runtime
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

    def __init__(self, cfg, *, cross=False, dtype, device, ep: int = 1):
        super().__init__()
        norm, _ = _norm(cfg)
        self.ln1 = norm(cfg.d_model, device=device)
        self.attn = layers.Attention(cfg.d_model, cfg.n_heads,
                                     cfg.n_kv_heads, cfg.hd, cfg.qkv_bias,
                                     dtype=dtype, device=device)
        self.ln2 = norm(cfg.d_model, device=device)
        if cfg.family == "moe":
            self.moe = moe.MoE(cfg, dtype=dtype, device=device, ep=ep)
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
    shares; ``dtype`` is the storage dtype of the weights."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        norm, _ = _norm(cfg)
        self.embed = layers.Embed(cfg.vocab, cfg.d_model, dtype=dtype,
                                  device=device)
        self.ln_f = norm(cfg.d_model, device=device)
        if not cfg.tie_embeddings:
            self.unembed = layers.Dense(cfg.d_model, cfg.vocab, dtype=dtype,
                                        device=device)


class DenseLM(_LM):
    """The attention stack of the dense, moe and vlm families (a moe
    model's experts padded to a multiple of ``ep``)."""

    def __init__(self, cfg, *, dtype, device, ep: int = 1):
        super().__init__(cfg, dtype=dtype, device=device)
        self.layers = nn.ModuleList(
            Block(cfg, dtype=dtype, device=device, ep=ep)
            for _ in range(cfg.n_layers))


class MambaLayer(nn.Module):
    """ln -> Mamba2 mixer, with a residual."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        norm, _ = _norm(cfg)
        self.ln = norm(cfg.d_model, device=device)
        self.mix = mamba2.Mamba2(cfg, dtype=dtype, device=device)


class SSMLM(_LM):
    def __init__(self, cfg, *, dtype, device):
        super().__init__(cfg, dtype=dtype, device=device)
        self.layers = nn.ModuleList(MambaLayer(cfg, dtype=dtype,
                                               device=device)
                                    for _ in range(cfg.n_layers))


class HybridLM(_LM):
    """``layers.<g>.<j>``: ``n_layers // attn_every`` groups of
    ``attn_every`` Mamba2 layers; ``shared_attn``: one attention block
    applied before every group, with ``in_proj (2D, D)`` taking the hidden
    state concatenated with the original embeddings."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__(cfg, dtype=dtype, device=device)
        groups = cfg.n_layers // cfg.attn_every
        self.layers = nn.ModuleList(
            nn.ModuleList(MambaLayer(cfg, dtype=dtype, device=device)
                          for _ in range(cfg.attn_every))
            for _ in range(groups))
        self.shared_attn = Block(cfg, dtype=dtype, device=device)
        self.shared_attn.in_proj = layers.Dense(2 * cfg.d_model, cfg.d_model,
                                                dtype=dtype, device=device)


class EncDecLM(_LM):
    def __init__(self, cfg, *, dtype, device):
        super().__init__(cfg, dtype=dtype, device=device)
        norm, _ = _norm(cfg)
        self.enc_layers = nn.ModuleList(
            Block(cfg, dtype=dtype, device=device)
            for _ in range(cfg.enc_layers))
        self.dec_layers = nn.ModuleList(
            Block(cfg, cross=True, dtype=dtype, device=device)
            for _ in range(cfg.n_layers))
        self.pos_enc = layers._param((cfg.max_pos, cfg.d_model), dtype,
                                     device)
        self.pos_dec = layers._param((cfg.max_pos, cfg.d_model), dtype,
                                     device)
        self.ln_enc = norm(cfg.d_model, device=device)


_MODELS = {"dense": DenseLM, "moe": DenseLM, "vlm": DenseLM,
           "ssm": SSMLM, "hybrid": HybridLM, "encdec": EncDecLM}


def build(cfg, device, param_dtype: Optional[torch.dtype] = None,
          ep: int = 1) -> _LM:
    """The family's module with uninitialised weights on ``device``, stored
    in ``param_dtype`` (default: the compute dtype; float32 masters for
    training), a moe model's experts padded to a multiple of ``ep`` (the
    expert-parallel size, ``Runtime.ep_size``). Parameters do not require
    gradients until the caller asks (``model.requires_grad_()``)."""
    if cfg.family not in _MODELS:
        raise ValueError(cfg.family)
    kw = {"ep": ep} if cfg.family == "moe" else {}
    return _MODELS[cfg.family](cfg, dtype=param_dtype or _dtype(cfg),
                               device=torch.device(device), **kw)


def init_params(cfg, generator: torch.Generator, device,
                param_dtype: Optional[torch.dtype] = None,
                ep: int = 1) -> _LM:
    """Random weights at the reference's scales: truncated normals in
    [-2, 2] x 1/sqrt(fan-in) for projections (1/sqrt(H*hd) for wo, 1/sqrt
    (F) for an expert's wo, 1/sqrt(K) for the conv taps), x 1 for the
    embedding, x 0.02 for the encdec position tables; norm gains 1, biases
    0; Mamba2's ``A_log = log(linspace(1, 16, heads))``, ``D = 1``,
    ``dt_bias = conv_b = 0``. Drawn in float32 from ``generator`` (on
    ``device``) in module order, then stored in ``param_dtype`` (see
    :func:`build`, also for ``ep``); the numbers differ from the
    reference's JAX PRNG."""
    model = build(cfg, device, param_dtype, ep)
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


def unstacked(tree: Dict[str, Any], cfg) -> Dict[str, np.ndarray]:
    """A tree in the reference's parameter layout (nested dicts of arrays)
    as the port's parameter names -> numpy arrays: the stacked arrays of
    ``layers`` / ``enc_layers`` / ``dec_layers`` split into their blocks
    (both leading axes of the hybrid's ``layers``). Serves the weights and
    anything laid out like them (AdamW's moments)."""
    out = {}
    for name, arr in _flatten(tree):
        group, _, rest = name.partition(".")
        arr = np.asarray(arr)
        depth = _stack_depth(cfg, group)
        if depth:
            out.update(_unstack(group, rest, arr, depth))
        else:
            out[name] = arr
    return out


def reference_layout(model: _LM) -> Dict[str, Tuple[str, int]]:
    """Each parameter's leaf in the reference's tree and that leaf's rank:
    a block's tensor is a slice of its group's stacked leaf
    (``layers.3.ln1.g`` of ``layers.ln1.g``, ``(L, D)``: rank 2 there, 1
    here). AdamW decays, and compresses gradients, by these leaves."""
    cfg = model.cfg
    out = {}
    for name, p in model.named_parameters():
        group, _, rest = name.partition(".")
        depth = _stack_depth(cfg, group)
        leaf = ".".join([group] + rest.split(".")[depth:]) if depth \
            else name
        out[name] = (leaf, p.dim() + depth)
    return out


def params_from_reference(tree: Dict[str, Any], cfg, device,
                          param_dtype: Optional[torch.dtype] = None) -> _LM:
    """Load the reference's parameter tree (nested dicts of numpy arrays,
    e.g. ``jax.tree.map(np.asarray, params)``), unstacked by
    :func:`unstacked`, every array cast to its parameter's dtype (see
    :func:`build` for ``param_dtype``). Every parameter must be given, with
    the reference's shape."""
    model = build(cfg, device, param_dtype)
    state = unstacked(tree, cfg)
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


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


# ===========================================================================
# Blocks


def _gathered(module: nn.Module, rt: Runtime):
    """A context in which ``module``'s weights split over the fsdp axis are
    their gathers (``rt.fsdp_gather``), one block at a time; the experts
    stay split (``rt.moe_apply`` places them). Nothing without a mesh."""
    if rt.mesh is None:
        return contextlib.nullcontext()
    swaps = {}
    for n, t in module.named_parameters():
        # under steps' bf16_gather the tensors are already its casts
        g = t if n.startswith("moe.") else rt.fsdp_gather(t)
        if g is not t:
            swaps[n] = g
    return _reparametrize_module(module, swaps)


def _attn_block(p: Block, x, cos_sin, cfg, dtype, backend, cache=None,
                pos=None, causal=True, rt: Runtime = NO_MESH):
    with _gathered(p, rt):
        return _attn_block_body(p, x, cos_sin, cfg, dtype, backend, cache,
                                pos, causal, rt)


def _attn_block_body(p: Block, x, cos_sin, cfg, dtype, backend, cache, pos,
                     causal, rt: Runtime):
    _, nfn = _norm(cfg)
    cos, sin = cos_sin if cos_sin is not None else (None, None)
    h, _ = layers.attention(
        p.attn, nfn(p.ln1, x, cfg.norm_eps), cos, sin,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
        dtype=dtype, causal=causal, kv_cache=cache, cache_pos=pos,
        backend=backend, rt=rt)
    x = rt.hint_act(x + h)
    hin = nfn(p.ln2, x, cfg.norm_eps)
    if cfg.family == "moe":
        B, S, D = hin.shape
        h2 = rt.moe_apply(p.moe, hin.reshape(B * S, D), cfg).reshape(B, S,
                                                                     D)
    elif cfg.norm == "layernorm":
        h2 = layers.gelu_mlp(p.mlp, hin)
    else:
        h2 = layers.glu_mlp(p.mlp, hin, cfg.activation)
    return rt.hint_act(x + h2)


def _rope(cfg, positions, rt: Runtime = NO_MESH):
    """positions (B, S) or (3, B, S) for mrope -> (cos, sin) (B, S, half);
    under a mesh from each rank's batch rows of the positions."""
    if rt.mesh is not None:
        B, S = positions.shape[-2:]
        pos_spec = rt.batch_spec(B, positions.dim(), positions.dim() - 2)
        pl = rt.placements_for((B, S, 1), rt.batch_spec(B, 3))
        return rt.local(lambda p: _rope(cfg, p), (positions,), (pos_spec,),
                        [pl, pl])
    if cfg.mrope:
        return layers.mrope_angles(positions, cfg.hd, cfg.rope_theta,
                                   cfg.mrope_sections)
    return layers.rope_angles(positions, cfg.hd, cfg.rope_theta)


def _gather_rows(table, idx, dtype, rt: Runtime):
    """``table`` cast to ``dtype``, its rows at ``idx`` (the embedding and
    the encdec position tables). Under a mesh the cast table is gathered
    whole on every rank (DTensor has no rule for a gather from a table
    split over the vocab) and each rank reads its batch rows."""
    if rt.mesh is None:
        return table.to(dtype)[idx.long()]
    spec = rt.batch_spec(idx.shape[0], idx.dim())
    shape = tuple(idx.shape) + (table.shape[-1],)
    return rt.local(lambda t, i: t[i.long()], (table.to(dtype), idx),
                    ((None, None), spec),
                    rt.placements_for(shape, spec + (None,)))


# the reference's ``Runtime.remat`` knob
REMATS = ("none", "dots", "full")
# the matrix products without a batch dimension (the projections and MLPs;
# ``x @ w`` of a 3-d x runs as ``mm``): what the reference's
# ``dots_with_no_batch_dims_saveable`` policy saves
_save_dots = functools.partial(
    create_selective_checkpoint_contexts,
    [torch.ops.aten.mm.default, torch.ops.aten.addmm.default])


def _remat(fn, remat: str):
    """``fn``, one block of a stack, under the reference's remat knob
    (``_maybe_remat``): ``"none"`` keeps its activations for the backward,
    ``"full"`` checkpoints it (recomputed in the backward), ``"dots"``
    checkpoints it but keeps its ``mm`` outputs. Outside autograd every
    knob runs ``fn`` as it is."""
    if remat not in REMATS:
        raise ValueError(f"remat must be one of {REMATS}, got {remat!r}")
    if remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {"context_fn": _save_dots} if remat == "dots" else {}
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


# ===========================================================================
# Forward passes (teacher-forced / prefill)


def _embed_inputs(params, batch, cfg, rt: Runtime = NO_MESH):
    """-> (x (B,S,D), positions for rope). A vlm batch's vision embeddings,
    cast to the compute dtype, go in front of the text, and its
    ``positions3d`` (3, B, S) are the rope positions."""
    dtype = _dtype(cfg)
    tokens = batch["tokens"]
    x = _gather_rows(params.embed.table, tokens, dtype, rt)
    if cfg.family == "vlm":
        vis = batch["vision_embeds"].to(dtype)            # (B, Nv, D)
        x = torch.cat([vis, x], dim=1)
        return rt.hint_act(x), batch["positions3d"]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    return rt.hint_act(x), rt.hint(positions, rt.batch_spec(B, 2))


def _mamba_layer(lp: MambaLayer, h, cfg, dtype, state=None,
                 rt: Runtime = NO_MESH):
    _, nfn = _norm(cfg)
    with _gathered(lp, rt):
        out, new = mamba2.mamba2_forward(lp.mix, nfn(lp.ln, h, cfg.norm_eps),
                                         cfg, dtype, state=state, rt=rt)
    return rt.hint_act(h + out), new


def _mamba_stack(lps, h, cfg, dtype, states=None, remat="none",
                 rt: Runtime = NO_MESH):
    """Mamba2 layers with residuals; ``states`` (ssm (n, B, h, p, n), conv
    (n, B, K-1, C)) -> decode. Returns (hidden, (ssm, conv) stacked over
    the layers: new tensors)."""
    layer = _remat(_mamba_layer, remat)
    ssm, conv = [], []
    for i, lp in enumerate(lps):
        st = None if states is None else (states[0][i], states[1][i])
        h, (s1, s2) = layer(lp, h, cfg, dtype, st, rt)
        ssm.append(s1)
        conv.append(s2)
    return h, (torch.stack(ssm), torch.stack(conv))


def _hybrid_group(params, gp, x, x0, cos_sin, cfg, dtype, backend, kv=None,
                  states=None, pos=None, rt: Runtime = NO_MESH):
    """The shared attention block on (hidden, original embeddings), then
    one group's Mamba2 layers."""
    shared = params.shared_attn
    with _gathered(shared.in_proj, rt):
        hin = layers.dense(shared.in_proj, torch.cat([x, x0], dim=-1))
    x = rt.hint_act(x + _attn_block(shared, hin, cos_sin, cfg, dtype,
                                    backend, cache=kv, pos=pos, rt=rt))
    return _mamba_stack(gp, x, cfg, dtype, states, rt=rt)


def backbone(params, x, positions, cfg, backend, caches=None, pos=None,
             remat="none", rt: Optional[Runtime] = None):
    """Run the stack. caches and pos given -> decode mode (S == 1): the KV
    caches are written in place, the SSM states come back as new tensors.
    Returns (hidden, caches): the prefill of an ssm model returns its
    stacked (ssm, conv) states, of the others None. ``remat`` applies to
    each block (a group for the hybrid) of a forward without caches."""
    rt = rt or NO_MESH
    dtype = _dtype(cfg)
    fam = cfg.family
    if caches is not None:
        remat = "none"
    if fam in _ATTN:
        cos_sin = _rope(cfg, positions, rt)
        block = _remat(_attn_block, remat)
        for i, lp in enumerate(params.layers):
            cache = (caches[0][i], caches[1][i]) if caches is not None \
                else None
            x = block(lp, x, cos_sin, cfg, dtype, backend, cache=cache,
                      pos=pos, rt=rt)
        return x, caches
    if fam == "ssm":
        return _mamba_stack(params.layers, x, cfg, dtype, caches, remat, rt)
    if fam == "hybrid":
        cos_sin = _rope(cfg, positions, rt)
        x0 = x        # the original embeddings feed every shared block
        group = _remat(_hybrid_group, remat)
        ssm, conv = [], []
        for g, gp in enumerate(params.layers):
            kv = st = None
            if caches is not None:
                kv = (caches[1][0][g], caches[1][1][g])
                st = (caches[0][0][g], caches[0][1][g])
            x, (s1, s2) = group(params, gp, x, x0, cos_sin, cfg, dtype,
                                backend, kv, st, pos, rt)
            ssm.append(s1)
            conv.append(s2)
        if caches is None:
            return x, None
        return x, ((torch.stack(ssm), torch.stack(conv)), caches[1])
    raise ValueError(fam)


def _final_logits(params, h, cfg, rt: Runtime = NO_MESH):
    _, nfn = _norm(cfg)
    h = nfn(params.ln_f, h, cfg.norm_eps)
    if cfg.tie_embeddings:
        return rt.hint_logits(layers.unembed(params.embed, h))
    return rt.hint_logits(layers.dense(params.unembed, h))


def _nll(logits, labels, rt: Runtime = NO_MESH):
    """Per-position cross entropy (:func:`layers.xent_nll`); under a mesh
    on each rank's rows and vocab slice (vocab over the TP axis, as
    ``hint_logits`` splits it): the max, exp-sums and gold logit reduced
    over the TP group, the gradient staying in each rank's slice."""
    if rt.mesh is None:
        return layers.xent_nll(logits, labels)
    from ..distributed.sharding import Shard, reduce_max, sum_over
    B, S, V = logits.shape
    b = rt.batch_spec(B, 3)
    spec = (b[0], None, rt.tp_axis)
    pl = rt.placements_for(logits.shape, spec)
    split = rt.size(rt.tp_axis) > 1 and any(
        isinstance(p, Shard) and p.dim == 2 for p in pl)
    group = rt.group(rt.tp_axis) if split else None
    rank = rt.mesh.get_local_rank(rt.tp_axis) if split else 0

    def body(lg, lab):
        if not split:
            return layers.xent_nll(lg, lab)
        lf = lg.float()
        v0 = rank * lf.shape[-1]
        m = reduce_max(lf.detach().amax(-1), group)
        se = torch.exp(lf - m[..., None]).sum(-1)
        idx = lab.long() - v0
        mine = (idx >= 0) & (idx < lf.shape[-1])
        gold = torch.where(mine, lf.gather(
            -1, idx.clamp(0, lf.shape[-1] - 1)[..., None])[..., 0],
            lf.new_zeros(()))
        se, gold = sum_over(se, group), sum_over(gold, group)
        return torch.log(se) + m - gold
    return rt.local(body, (logits, labels), (spec, b[:2]),
                    rt.placements_for((B, S), b[:2]))


# ===========================================================================
# Encoder-decoder (whisper)


def _encdec_encode(params, frames, cfg, backend, remat="none",
                   rt: Runtime = NO_MESH):
    dtype = _dtype(cfg)
    _, nfn = _norm(cfg)
    x = frames.to(dtype)
    x = rt.hint_act(x + rt.fsdp_gather(params.pos_enc)[: x.shape[1]]
                    .to(dtype)[None])
    block = _remat(_attn_block, remat)
    for lp in params.enc_layers:
        x = block(lp, x, None, cfg, dtype, backend, causal=False, rt=rt)
    return nfn(params.ln_enc, x, cfg.norm_eps)


def _dec_block(lp: Block, x, enc, cfg, dtype, backend, cache=None,
               pos=None, rt: Runtime = NO_MESH):
    _, nfn = _norm(cfg)
    x = _attn_block(lp, x, None, cfg, dtype, backend, cache=cache, pos=pos,
                    rt=rt)
    with _gathered(lp.xattn, rt):
        xh, _ = layers.attention(
            lp.xattn, nfn(lp.ln_x, x, cfg.norm_eps), None, None,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
            dtype=dtype, kv=enc, backend=backend, rt=rt)
    return rt.hint_act(x + xh)


def _encdec_decode_stack(params, x, enc, cfg, backend, caches=None,
                         pos=None, remat="none", rt: Runtime = NO_MESH):
    dtype = _dtype(cfg)
    block = _remat(_dec_block, "none" if caches is not None else remat)
    for i, lp in enumerate(params.dec_layers):
        cache = (caches[0][i], caches[1][i]) if caches is not None else None
        x = block(lp, x, enc, cfg, dtype, backend, cache, pos, rt)
    return x, caches


# ===========================================================================
# Public API


@contextlib.contextmanager
def full_fp32():
    """Products in full float32 (TF32 off) for the call; bf16 products do
    not use TF32 either way. A train step holds it over the backward too."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _backend(params, backend):
    return resolve_backend(backend, params.embed.table.device)


def loss_fn(params, batch, cfg, backend: Optional[str] = None, *,
            loss_chunk: int = 0, remat: str = "none",
            rt: Optional[Runtime] = None) -> torch.Tensor:
    """Teacher-forced mean cross entropy of a train batch (``tokens``,
    ``labels`` (B, S); a vlm batch's ``vision_embeds`` and ``positions3d``,
    an encdec batch's ``frames``), a float32 scalar under autograd. The
    vlm's vision positions are cut off before the loss. ``loss_chunk`` C
    (the reference's ``Runtime.loss_chunk``; 0: off) takes the loss over
    sequence chunks of C positions where C divides S and is smaller
    (:func:`_chunked_xent`); ``remat`` is the reference's knob for each
    block (:data:`REMATS`). ``rt``: the runtime (its mesh; its own knobs
    are the caller's to pass)."""
    backend = _backend(params, backend)
    dtype = _dtype(cfg)
    rt = rt or NO_MESH
    with full_fp32():
        if cfg.family == "encdec":
            enc = _encdec_encode(params, batch["frames"], cfg, backend,
                                 remat, rt)
            x = _decoder_inputs(params, batch["tokens"], cfg, rt)
            h, _ = _encdec_decode_stack(params, x, enc, cfg, backend,
                                        remat=remat, rt=rt)
            return _mean_xent(_final_logits(params, h, cfg, rt),
                              batch["labels"], None, rt)
        x, positions = _embed_inputs(params, batch, cfg, rt)
        h, _ = backbone(params, x, positions, cfg, backend, remat=remat,
                        rt=rt)
        if cfg.family == "vlm":
            h = h[:, batch["vision_embeds"].shape[1]:]
        labels = batch["labels"]
        mask = rt.hint(torch.ones(labels.shape, dtype=torch.float32,
                                  device=h.device),
                       rt.batch_spec(labels.shape[0], 2))
        C = loss_chunk
        if C and h.shape[1] % C == 0 and h.shape[1] > C:
            return _chunked_xent(params, h, labels, mask, cfg, C, rt)
        return _mean_xent(_final_logits(params, h, cfg, rt), labels, mask,
                          rt)


def _decoder_inputs(params, tokens, cfg, rt: Runtime):
    """The encdec decoder's embedded tokens plus their position rows."""
    dtype = _dtype(cfg)
    x = _gather_rows(params.embed.table, tokens, dtype, rt)
    return rt.hint_act(x + rt.fsdp_gather(params.pos_dec)[: x.shape[1]]
                       .to(dtype)[None])


def _batch_sum(t, rt: Runtime):
    """``t.sum()``; under a mesh each rank sums its own rows and one
    all-reduce adds them, so that the gradient comes back split as ``t``
    is (DTensor's own sum of a split tensor hands every rank the whole
    batch's gradient)."""
    if rt.mesh is None:
        return t.sum()
    from ..distributed.sharding import DTensor, Partial, Replicate, Shard
    pl = [Partial() if isinstance(p, Shard) else Replicate()
          for p in t.placements]
    part = DTensor.from_local(t.to_local().sum(), rt.mesh, pl,
                              run_check=False)
    return part.redistribute(rt.mesh, [Replicate()] * rt.mesh.ndim)


def _mean_xent(logits, labels, mask, rt: Runtime):
    """:func:`layers.softmax_xent`, through :func:`_nll` under a mesh."""
    if rt.mesh is None:
        return layers.softmax_xent(logits, labels, mask)
    nll = _nll(logits, labels, rt)
    if mask is None:
        return _batch_sum(nll, rt) / nll.numel()
    return _batch_sum(nll * mask, rt) / _batch_sum(mask, rt).clamp_min(1)


def _xent_sum(params, h, labels, mask, cfg, rt: Runtime = NO_MESH):
    return _batch_sum(_nll(_final_logits(params, h, cfg, rt), labels, rt)
                      * mask, rt)


def _chunked_xent(params, h, labels, mask, cfg, C, rt: Runtime = NO_MESH):
    """The masked mean cross entropy over sequence chunks of C positions,
    each chunk's logits checkpointed (recomputed in the backward): one
    (B, C, V) float32 chunk is the peak, never the (B, S, V) logits. The
    chunks' sums add up in order, as the reference's scan carries them."""
    chunk_sum = _xent_sum
    if torch.is_grad_enabled():
        chunk_sum = functools.partial(checkpoint, _xent_sum,
                                      use_reentrant=False)
    tot = rt.hint(torch.zeros((), dtype=torch.float32, device=h.device), ())
    cnt = rt.hint(torch.zeros((), dtype=torch.float32, device=h.device), ())
    for i in range(h.shape[1] // C):
        sl = slice(i * C, (i + 1) * C)
        tot = tot + chunk_sum(params, h[:, sl], labels[:, sl], mask[:, sl],
                              cfg, rt)
        cnt = cnt + _batch_sum(mask[:, sl], rt)
    return tot / cnt.clamp_min(1)


@torch.no_grad()
def prefill_fn(params, batch, cfg, backend: Optional[str] = None,
               rt: Optional[Runtime] = None):
    """Teacher-forced forward for serving prefill: returns last-position
    logits (B, 1, vocab) in the compute dtype, and the encoder states for
    encdec, the stacked (ssm, conv) states for ssm (None for the rest)."""
    backend = _backend(params, backend)
    rt = rt or NO_MESH
    with full_fp32():
        if cfg.family == "encdec":
            enc = _encdec_encode(params, batch["frames"], cfg, backend,
                                 rt=rt)
            x = _decoder_inputs(params, batch["tokens"], cfg, rt)
            h, _ = _encdec_decode_stack(params, x, enc, cfg, backend, rt=rt)
            return _final_logits(params, h[:, -1:], cfg, rt), enc
        x, positions = _embed_inputs(params, batch, cfg, rt)
        h, states = backbone(params, x, positions, cfg, backend, rt=rt)
        return _final_logits(params, h[:, -1:], cfg, rt), states


def init_cache(cfg, batch_size: int, seq_len: int, device,
               dtype=torch.bfloat16, rt: Optional[Runtime] = None):
    """Zeroed decode caches, bf16 whatever ``cfg.dtype`` (the reference's
    default): dense/moe/vlm ``(K, V)`` of ``(L, B, T, KV, hd)``; ssm
    ``(ssm (L, B, h, p, n), conv (L, B, K-1, d_inner + 2n))``; hybrid
    ``((ssm, conv) of (G, attn_every, ...), (K, V) of (G, B, T, KV, hd))``
    with G = n_layers // attn_every; encdec ``((K, V), enc (B, T, D))``.
    K and V are always two tensors. Under ``rt``'s mesh each is a DTensor
    on ``cache_specs`` (long-context with ``rt.seq_shard_decode``), each
    rank allocating its shard only."""
    if rt is not None and rt.mesh is not None:
        from torch.distributed.tensor import zeros
        from ..distributed.sharding import cache_specs, normalize_shardings
        plain = init_cache(cfg, batch_size, seq_len, "meta", dtype)
        shardings = normalize_shardings(
            rt.mesh, cache_specs(cfg, rt, rt.seq_shard_decode), plain)
        return _tree_map2(
            lambda t, sh: zeros(tuple(t.shape), dtype=dtype,
                                device_mesh=rt.mesh,
                                placements=sh.placements),
            plain, shardings)

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


def _tree_map2(fn, tree, other):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map2(fn, t, o) for t, o in zip(tree, other))
    return fn(tree, other)


@torch.no_grad()
def decode_fn(params, cache, batch, cfg, backend: Optional[str] = None,
              rt: Optional[Runtime] = None):
    """One decode step: batch = {token (B,1), pos (B,)} (+ positions3d (3,
    B, 1) for vlm). Returns (logits (B,1,V), cache); the new token's K/V
    are written into ``cache`` in place, SSM states are new tensors."""
    backend = _backend(params, backend)
    rt = rt or NO_MESH
    tok, pos = batch["token"], batch["pos"]
    dtype = _dtype(cfg)
    with full_fp32():
        x = rt.hint_act(_gather_rows(params.embed.table, tok, dtype, rt))
        if cfg.family == "encdec":
            (K, V), enc = cache
            x = rt.hint_act(x + _gather_rows(rt.fsdp_gather(params.pos_dec),
                                             pos, dtype, rt)[:, None, :])
            h, nkv = _encdec_decode_stack(params, x, enc, cfg, backend,
                                          caches=(K, V), pos=pos, rt=rt)
            return _final_logits(params, h, cfg, rt), (nkv, enc)
        positions = batch["positions3d"] if cfg.family == "vlm" else \
            pos[:, None]
        h, new = backbone(params, x, positions, cfg, backend, caches=cache,
                          pos=pos, rt=rt)
        return _final_logits(params, h, cfg, rt), new
