"""Segment sharding for the relation engine (docs/DESIGN.md §9): the
:class:`ShardPlan` that splits the segments into contiguous shards, and
the integer sum that joins the shards' halves of the completion exchange.
The sharded LM's :class:`Runtime` and its parameter, batch and cache
specs follow them (the second half of this module).

Shards may repeat a device, as in the reference: one card then runs
several logical shards, each with its own sliced tables, device pool and
stats, and the exchange's sum runs on that card. Shards on distinct cards
would need the sum across cards (the reference's ``psum`` over its
``("data",)`` mesh); :func:`all_sum_shards` raises for that case, which
needs a second card to verify.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate,
                                      Shard)


def _card(d) -> Optional[Tuple[str, int]]:
    """A device's normalised ``(type, index)`` when it is a card, so that
    ``cuda`` and ``cuda:0`` name one card; ``None`` for the CPU and for an
    unplaced shard."""
    if d is None:
        return None
    d = torch.device(d)
    if d.type == "cpu":
        return None
    return d.type, d.index or 0


def _distinct_cards(devices: Sequence[Any]) -> int:
    """How many distinct cards ``devices`` name, or 0 when any entry is
    the CPU or unplaced."""
    cards = [_card(d) for d in devices]
    if any(c is None for c in cards):
        return 0
    return len(set(cards))


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Contiguous segment shards.

    Shard ``k`` owns segments ``[bounds[k], bounds[k+1])`` and produces and
    retains exactly those blocks on ``devices[k]``. Contiguity matters:
    Morton-ordered segments make each shard a spatially compact region, so
    cross-shard completion traffic concentrates on shard-boundary faces.
    ``devices`` may repeat (more shards than cards): the plan is then
    purely logical."""

    n_segments: int
    bounds: Tuple[int, ...]          # len n_shards + 1; [0] == 0, [-1] == ns
    devices: Tuple[Any, ...]         # one torch.device per shard (None = any)

    @property
    def n_shards(self) -> int:
        return len(self.bounds) - 1

    @property
    def multi_device(self) -> bool:
        """True when every shard sits on its own distinct card (the
        cross-card exchange path is only meaningful then); the CPU is
        never a distinct card."""
        return self.n_shards > 1 and \
            _distinct_cards(self.devices) == self.n_shards

    def shard_of(self, segment: int) -> int:
        return int(np.searchsorted(np.asarray(self.bounds[1:]),
                                   int(segment), side="right"))

    def shard_of_array(self, segments) -> np.ndarray:
        return np.searchsorted(np.asarray(self.bounds[1:]),
                               np.asarray(segments), side="right")

    def shard_bounds(self, shard: int) -> Tuple[int, int]:
        return self.bounds[shard], self.bounds[shard + 1]

    def rehomed(self, lost: int, target: int) -> "ShardPlan":
        """The plan after shard ``lost``'s device died and its segments
        were re-homed onto shard ``target``'s device. Segment ownership
        (``bounds``) is unchanged; only the lost slot's device is
        replaced, so the plan then repeats a device."""
        devices = list(self.devices)
        devices[lost] = devices[target]
        return ShardPlan(self.n_segments, self.bounds, tuple(devices))

    def segments(self, shard: int) -> range:
        return range(self.bounds[shard], self.bounds[shard + 1])

    @staticmethod
    def make(n_segments: int, shards: int = 1,
             devices: Optional[Sequence[Any]] = None) -> "ShardPlan":
        """Even contiguous split of ``n_segments`` into ``shards`` shards
        (clamped to the segment count), devices round-robin over the
        visible cards; without a card that raises, and shards on the CPU
        take ``devices=("cpu",) * shards``. ``shards=1`` keeps
        ``devices=(None,)`` and touches no device API."""
        n_segments = int(n_segments)
        shards = max(1, min(int(shards), max(1, n_segments)))
        base, rem = divmod(n_segments, shards)
        bounds = [0]
        for k in range(shards):
            bounds.append(bounds[-1] + base + (1 if k < rem else 0))
        if devices is None:
            if shards == 1:
                devices = (None,)
            else:
                if not torch.cuda.is_available():
                    raise RuntimeError(
                        f"{shards} shards on the visible cards requested but "
                        f"torch.cuda.is_available() is False; pass "
                        f"devices=('cpu',) * {shards} to shard on the CPU")
                n = torch.cuda.device_count()
                devices = tuple(torch.device("cuda", k % n)
                                for k in range(shards))
        else:
            devices = tuple(None if d is None else torch.device(d)
                            for d in devices)
        return ShardPlan(n_segments, tuple(bounds), tuple(devices))


def all_sum_shards(parts: List[Tuple[torch.Tensor, torch.Tensor]],
                   devices: Optional[Sequence[Any]] = None):
    """Integer sum of per-shard ``(cand, cand_len)`` contributions.

    Each completion pair has exactly one owning shard; the owner
    contributes the gathered pool rows, every other shard exact zeros, so
    an elementwise integer sum reconstructs the single-pool candidate
    matrix bit for bit (docs/DESIGN.md §9). The sum keeps the parts'
    int32. Shards sharing a card (or the CPU) stack and sum on the first
    part's device; parts on distinct cards raise ``NotImplementedError``:
    the cross-card sum needs a second card to verify."""
    if len(parts) == 1:
        return parts[0]
    n = len(parts)
    if devices is not None and n > 1 and _distinct_cards(devices) == n:
        raise NotImplementedError(
            f"all_sum_shards over {n} distinct cards: the cross-card sum "
            f"is not verified, it needs a second card (ROADMAP queue 3); "
            f"run the shards on one card")
    dev = parts[0][0].device
    cands = torch.stack([c.to(dev) for c, _ in parts])
    lens = torch.stack([cl.to(dev) for _, cl in parts])
    return (torch.sum(cands, dim=0, dtype=cands.dtype),
            torch.sum(lens, dim=0, dtype=lens.dtype))


# ===========================================================================
# The sharded LM: the reference's ``Runtime``, its activation hints and its
# parameter, batch and cache specs, over a ``DeviceMesh``.
#
# Mesh convention (``launch/mesh.py``): single-pod ``("data", "model")``,
# multi-pod ``("pod", "data", "model")``. "model" is tensor parallelism
# (heads, FFN columns, vocab) and the MoE's intra-expert TP axis; "data" is
# batch data parallelism, FSDP weight sharding and the MoE's expert-parallel
# axis; "pod" is pure data parallelism.
#
# A spec is the reference's ``PartitionSpec`` as a tuple: one entry per
# tensor dim, ``None``, a mesh dim's name, or a tuple of names (their sizes
# multiply; the first is the outer split, so a tuple must name mesh dims in
# mesh order: only then do JAX's ``P(("data", "model"))`` and two
# ``Shard(d)`` placements split the dim alike). :func:`placements` turns a
# spec into DTensor placements: ``Shard(d)`` on each named mesh dim,
# ``Replicate()`` elsewhere. GSPMD's ``with_sharding_constraint`` becomes
# ``redistribute``; the reference's ``shard_map`` bodies run on each rank's
# local shards (``to_local`` / ``from_local``) with functional collectives
# on ``mesh.get_group(name)``.

Spec = Tuple[Any, ...]


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def dim_size(mesh: DeviceMesh, name: str) -> int:
    """The size of the mesh dim ``name``."""
    return mesh.size(mesh.mesh_dim_names.index(name))


def drop_indivisible(mesh: DeviceMesh, spec: Spec, shape) -> Spec:
    """``spec`` padded with ``None`` to ``len(shape)`` dims, each entry
    whose mesh size does not divide its dim dropped (the reference's rule,
    e.g. a batch of 1 on a data axis of 16)."""
    out = list(spec)[:len(shape)] + [None] * (len(shape) - len(spec))
    for i, e in enumerate(out):
        names = _names(e)
        if names and shape[i] % math.prod(dim_size(mesh, n)
                                          for n in names):
            out[i] = None
    return tuple(out)


def placements(mesh: DeviceMesh, spec: Spec, shape=None
               ) -> Tuple[Placement, ...]:
    """The DTensor placements of ``spec`` on ``mesh`` (after the drop rule
    when ``shape`` is given). A tuple entry must name mesh dims in mesh
    order, and a mesh dim may shard one tensor dim only."""
    if shape is not None:
        spec = drop_indivisible(mesh, spec, shape)
    dims = mesh.mesh_dim_names
    out: list = [Replicate()] * mesh.ndim
    for d, e in enumerate(spec):
        idx = []
        for n in _names(e):
            if n not in dims:
                raise ValueError(f"spec {spec} names {n!r}, not a dim of "
                                 f"the mesh {dims}")
            idx.append(dims.index(n))
        if idx != sorted(idx):
            raise ValueError(f"spec entry {e} must name mesh dims in mesh "
                             f"order {dims}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} uses mesh dim {dims[i]!r} "
                                 f"twice")
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""

    mesh: DeviceMesh
    spec: Spec

    @property
    def placements(self) -> Tuple[Placement, ...]:
        return placements(self.mesh, self.spec)


def as_dtensor(x: torch.Tensor, mesh: DeviceMesh) -> DTensor:
    """``x`` itself if it is a DTensor, else ``x`` as a replicated DTensor
    (every rank holds the same values: no communication)."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def redistribute(x: torch.Tensor, mesh: DeviceMesh, pl) -> DTensor:
    """``x`` (a DTensor, or a plain tensor that every rank holds alike) on
    placements ``pl``."""
    x = as_dtensor(x, mesh)
    if tuple(x.placements) != tuple(pl):
        x = x.redistribute(mesh, tuple(pl))
    return x


# -- differentiable collectives (the c10d functional ops, out of place) ----

def _reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    f = torch.ops._c10d_functional
    return f.wait_tensor(f.all_reduce(x.contiguous(), op, group.group_name))


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Equal splits of dim 0 exchanged across ``group``."""
    f = torch.ops._c10d_functional
    n = dist.get_world_size(group)
    sizes = [x.shape[0] // n] * n
    return f.wait_tensor(f.all_to_all_single(x.contiguous(), sizes, sizes,
                                             group.group_name))


class _SumOver(torch.autograd.Function):
    """Forward: the sum across ``group``; backward: the identity (each
    rank's part of a sum gets the whole gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    """Forward: the identity on a tensor every rank of ``group`` holds;
    backward: the sum of the ranks' gradients (each used it for its part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, "sum", ctx.group), None


class _AllToAll(torch.autograd.Function):
    """Equal-split all-to-all; its gradient is the same exchange back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def sum_over(x, group):
    return _SumOver.apply(x, group)


def copy_to(x, group):
    return _CopyTo.apply(x, group)


def all_to_all(x, group):
    return _AllToAll.apply(x, group)


def reduce_max(x, group):
    return _reduce(x, "max", group)


def decode_attention(q, K, V, pos, off: int, reduce_max=None,
                     reduce_sum=None) -> torch.Tensor:
    """Exact decode attention of one query per row over a shard of a KV
    cache: q (B, 1, H, hd), K/V (B, t, kv, hd) holding the cache's
    positions ``off .. off + t - 1``, pos (B,) each row's last valid
    position. Two passes of an online softmax: the shard's float32 max,
    ``reduce_max`` across the shards, the shard's exp-sums,
    ``reduce_sum``, then the probabilities (divided before the product,
    in q's dtype, as the plain ``_sdpa`` rounds them) times V, summed by
    ``reduce_sum``. Without reductions one shard holds every position, and
    it is the plain ``_sdpa`` itself: a mesh whose sequence is not split
    changes no bit."""
    from ..models.layers import _sdpa, repeat_kv
    H, hd = q.shape[2], q.shape[3]
    t = K.shape[1]
    kf, vf = repeat_kv(K, H), repeat_kv(V, H)
    iota = off + torch.arange(t, device=q.device)
    mask = (iota[None, :] <= pos.long()[:, None])[:, None, None, :]
    if reduce_max is None:
        return _sdpa(q, kf.to(q.dtype), vf.to(q.dtype), mask, q.dtype)
    s = torch.einsum("bshd,bthd->bhst", q.float(), kf.float())
    s = s / np.sqrt(hd)
    s = s.masked_fill(~mask, float("-inf"))
    m = reduce_max(s.amax(dim=-1))                         # (B, H, 1)
    e = torch.exp(s - m[..., None])
    e = torch.where(mask, e, e.new_zeros(()))
    den = reduce_sum(e.sum(dim=-1))
    probs = (e / den.clamp_min(1e-30)[..., None]).to(q.dtype)
    return reduce_sum(torch.einsum("bhst,bthd->bshd", probs,
                                   vf.to(q.dtype)))


@dataclasses.dataclass
class Runtime:
    """Execution context handed to the model code (the reference's
    ``Runtime``). With ``mesh=None`` every hint is the identity and the
    model runs as it does without one."""

    mesh: Optional[DeviceMesh] = None
    batch_axes: Tuple[str, ...] = ("data",)
    fsdp_axis: Optional[str] = "data"
    tp_axis: Optional[str] = "model"
    remat: str = "full"             # none | dots | full
    moe_impl: str = "shard_map"     # shard_map (per-rank EP/TP) | local
    seq_shard_decode: bool = False  # shard long KV caches over fsdp too
    seq_parallel: bool = False      # shard the hidden states' sequence dim
    #                                 over the TP axis between blocks
    bf16_gather: bool = False       # cast float32 masters to bf16 before
    #                                 the FSDP gather (launch/steps.py)
    moe_ep: str = "data"            # EP axis: "data" (all-to-all dispatch)
    #                                 or "model" (tokens replicated over TP:
    #                                 local selection and one all-reduce)
    loss_chunk: int = 0             # chunked cross entropy (lm.loss_fn)

    def __post_init__(self):
        if self.moe_ep not in ("data", "model"):
            raise ValueError(f"moe_ep must be 'data' or 'model', got "
                             f"{self.moe_ep!r}")
        if self.moe_impl not in ("shard_map", "local"):
            raise ValueError(f"moe_impl must be 'shard_map' or 'local', "
                             f"got {self.moe_impl!r}")
        if self.mesh is None:
            return
        dims = self.mesh.mesh_dim_names
        if dims is None:
            raise ValueError("the mesh needs named dims (make_mesh)")
        for n in (*self.batch_axes, self.fsdp_axis, self.tp_axis):
            if n is not None and n not in dims:
                raise ValueError(f"{n!r} is not a dim of the mesh {dims}")

    # -- sizes -------------------------------------------------------------

    def size(self, name: Optional[str]) -> int:
        return 1 if self.mesh is None or name is None else \
            dim_size(self.mesh, name)

    @property
    def ep_size(self) -> int:
        if self.mesh is None or self.moe_impl != "shard_map":
            return 1
        return self.size(self.fsdp_axis if self.moe_ep == "data"
                         else self.tp_axis)

    def group(self, name: str):
        return self.mesh.get_group(name)

    def placements_for(self, shape, spec: Spec) -> Tuple[Placement, ...]:
        return placements(self.mesh, spec, shape)

    # -- activation hints --------------------------------------------------

    def hint(self, x, spec: Spec):
        """``x`` redistributed to ``spec`` (dropped by its shape); a plain
        tensor is taken as replicated first. The identity without a
        mesh."""
        if self.mesh is None:
            return x
        return redistribute(x, self.mesh, self.placements_for(x.shape,
                                                              spec))

    def hint_act(self, x):
        """(B, S, D) hidden states: batch-sharded; with ``seq_parallel``
        the sequence dim also over the TP axis between blocks."""
        if self.mesh is None:
            return x
        spec = [self.batch_axes] + [None] * (x.dim() - 1)
        if (self.seq_parallel and x.dim() >= 3 and x.shape[1] > 1
                and x.shape[1] % self.size(self.tp_axis) == 0):
            spec[1] = self.tp_axis
        return self.hint(x, tuple(spec))

    def hint_logits(self, x):
        """(B, S, V): vocab over the TP axis."""
        return self.hint(x, (self.batch_axes, None, self.tp_axis))

    def hint_heads(self, x):
        """(B, S, H, hd): heads over the TP axis (dropped where they do not
        divide)."""
        return self.hint(x, (self.batch_axes, None, self.tp_axis, None))

    def kv_seq_spec(self) -> Spec:
        """The decode KV cache's (B, T, kv, hd) spec: the sequence over the
        TP axis; with ``seq_shard_decode`` (long contexts, batch 1) over
        the fsdp and TP axes, the batch whole."""
        if self.seq_shard_decode:
            return (None, (self.fsdp_axis, self.tp_axis), None, None)
        return (self.batch_axes, self.tp_axis, None, None)

    def hint_kv_seq(self, x):
        return self.hint(x, self.kv_seq_spec())

    def batch_spec(self, n: int, ndim: int, dim: int = 0) -> Spec:
        """A spec sharding dim ``dim`` (of size ``n``) of an ``ndim``-d
        tensor over the batch axes, dropped where they do not divide."""
        spec = [None] * ndim
        if n % math.prod(self.size(a) for a in self.batch_axes) == 0:
            spec[dim] = self.batch_axes
        return tuple(spec)

    def fsdp_gather(self, t):
        """``t`` whole over the fsdp axis (its other placements kept): a
        weight gathered for one block's use, FSDP's per-layer gather (and
        what GSPMD does for the reference, the activations being pinned to
        their batch split). DTensor would otherwise be free to move the
        activations instead. Anything else passes as it is."""
        if not isinstance(t, DTensor) or self.fsdp_axis is None:
            return t
        i = self.mesh.mesh_dim_names.index(self.fsdp_axis)
        if not isinstance(t.placements[i], Shard) or self.size(
                self.fsdp_axis) == 1:
            return t
        pl = list(t.placements)
        pl[i] = Replicate()
        return t.redistribute(self.mesh, pl)

    # -- per-rank code -----------------------------------------------------

    def local(self, fn: Callable, args, in_specs, out_placements,
              partial_axes: Sequence[str] = ()):
        """``fn`` on each rank's shards (the reference's ``shard_map``
        bodies): each tensor argument redistributed to its spec (a ``None``
        spec passes the argument as it is), ``fn`` called on the local
        tensors, each output wrapped with its placements. An input's
        gradient keeps its ``Shard`` placements; on a mesh dim where the
        input is replicated it is ``Partial`` where an output is sharded on
        that dim (each rank used the whole input for its part of the
        output) or the dim is in ``partial_axes``, else replicated."""
        mesh = self.mesh
        outs_pl = [tuple(p) for p in (out_placements
                                      if isinstance(out_placements, list)
                                      else [out_placements])]
        split = [any(isinstance(p[i], Shard) for p in outs_pl)
                 or mesh.mesh_dim_names[i] in partial_axes
                 for i in range(mesh.ndim)]
        local_args = []
        for a, spec in zip(args, in_specs):
            if spec is None or not isinstance(a, torch.Tensor):
                local_args.append(a)
                continue
            d = redistribute(a, mesh, self.placements_for(a.shape, spec))
            grad_pl = [p if isinstance(p, Shard)
                       else (Partial() if split[i] else Replicate())
                       for i, p in enumerate(d.placements)]
            local_args.append(d.to_local(grad_placements=grad_pl))
        out = fn(*local_args)
        single = not isinstance(out, (tuple, list))
        outs = [out] if single else list(out)
        wrapped = [DTensor.from_local(o, mesh, pl, run_check=False)
                   for o, pl in zip(outs, outs_pl)]
        return wrapped[0] if single else tuple(wrapped)

    # -- flash-decode attention --------------------------------------------

    def seq_names(self) -> Tuple[str, ...]:
        return ((self.fsdp_axis, self.tp_axis) if self.seq_shard_decode
                else (self.tp_axis,))

    def seq_offset(self, t_local: int) -> int:
        """This rank's first cache position of a sequence split over
        :meth:`seq_names`, of ``t_local`` positions a shard."""
        off, mult = 0, t_local
        for name in reversed(self.seq_names()):
            off += self.mesh.get_local_rank(name) * mult
            mult *= self.size(name)
        return off

    def seq_reductions(self):
        """(max, sum) across the sequence shards: over each of
        :meth:`seq_names`' groups in turn; (None, None) where one shard
        holds the whole sequence."""
        if math.prod(self.size(n) for n in self.seq_names()) == 1:
            return None, None
        groups = [self.group(n) for n in self.seq_names()]

        def red(op):
            def f(x):
                for g in groups:
                    x = _reduce(x, op, g)
                return x
            return f
        return red("max"), red("sum")

    def decode_specs(self, B: int):
        """The batch entry of :meth:`flash_decode`'s q, K, V and pos: the
        batch axes where they divide B (the reference's rule), less those
        that split the sequence."""
        axes = tuple(a for a in self.batch_axes if a not in self.seq_names())
        if not axes or B % math.prod(self.size(a) for a in axes):
            return None
        return axes

    def flash_decode(self, q, K, V, pos):
        """Distributed decode attention over a KV cache sharded along the
        sequence (:func:`decode_attention` on each rank's shard, its max and
        sums reduced over :meth:`seq_names`, the ``data`` group then the
        ``model`` group with ``seq_shard_decode``). q (B, 1, H, hd), K/V (B,
        T, kv, hd), pos (B,): DTensors, or tensors every rank holds alike.
        Where the shards do not divide T the cache is whole along it on
        every rank (the reference's drop rule) and nothing is reduced.
        Returns (B, 1, H, hd) split over the batch axes; None without a
        mesh."""
        if self.mesh is None:
            return None
        B, T = K.shape[0], K.shape[1]
        s_names = self.seq_names()
        split = T % math.prod(self.size(n) for n in s_names) == 0
        red_max, red_sum = self.seq_reductions() if split else (None, None)
        b = self.decode_specs(B)
        s_ax = s_names if len(s_names) > 1 else s_names[0]

        def body(q_, K_, V_, pos_):
            off = self.seq_offset(K_.shape[1]) if split else 0
            return decode_attention(q_, K_, V_, pos_, off, red_max, red_sum)
        out_pl = self.placements_for(q.shape, (b, None, None, None))
        return self.local(body, (q, K, V, pos),
                          ((b, None, None, None), (b, s_ax, None, None),
                           (b, s_ax, None, None), (b,)), out_pl)

    # -- MoE dispatch -------------------------------------------------------

    def moe_param_specs(self) -> Dict[str, Spec]:
        if self.moe_ep == "model":
            # experts over the TP axis, each expert's full d_ff
            e = self.tp_axis
            return {"router": (None, None), "wi": (e, None, None),
                    "wg": (e, None, None), "wo": (e, None, None)}
        return {"router": (None, None),
                "wi": (self.fsdp_axis, None, self.tp_axis),
                "wg": (self.fsdp_axis, None, self.tp_axis),
                "wo": (self.fsdp_axis, self.tp_axis, None)}

    def moe_apply(self, p, x_flat, cfg):
        """The MoE FFN of ``x_flat`` (T, D) tokens: the local ``moe_ffn``
        without a mesh; else per rank on its batch rows of the tokens:
        with ``moe_impl="local"`` every expert whole on every rank, else
        the experts as :meth:`moe_param_specs` places them:
        ``moe_ep="data"`` dispatches by all-to-all over the fsdp axis and
        sums each expert's TP parts over the TP axis (``moe.moe_ffn``),
        ``"model"`` picks each TP rank's own experts' pairs from the
        replicated tokens and sums the outputs over the TP axis
        (``moe.moe_ffn_ep_replicated``)."""
        from types import SimpleNamespace

        from ..models import moe
        if self.mesh is None:
            return moe.moe_ffn(p, x_flat, cfg)
        specs = self.moe_param_specs()
        names = tuple(specs)
        if self.moe_impl != "shard_map":
            specs = {n: () for n in names}
        tok = self.batch_spec(x_flat.shape[0], 2)
        replicated_ep = self.moe_ep == "model"

        def body(x, *w):
            loc = SimpleNamespace(**dict(zip(names, w)))
            if self.moe_impl != "shard_map":
                return moe.moe_ffn(loc, x, cfg)
            if replicated_ep:
                return moe.moe_ffn_ep_replicated(loc, x, cfg,
                                                 self.group(self.tp_axis))
            tp = self.group(self.tp_axis) if self.size(self.tp_axis) > 1 \
                else None
            return moe.moe_ffn(loc, x, cfg,
                               ep_group=self.group(self.fsdp_axis),
                               tp_group=tp)
        # with replicated EP each TP rank routes through its own experts
        # only, so the tokens' and the router's gradients are a part per
        # TP rank; on the all-to-all path moe_ffn sums the experts' TP
        # parts itself and the routing runs alike on every TP rank
        return self.local(body, (x_flat,) + tuple(getattr(p, n)
                                                  for n in names),
                          (tok,) + tuple(specs[n] for n in names),
                          self.placements_for(x_flat.shape, tok),
                          partial_axes=(self.tp_axis,) if replicated_ep
                          and self.moe_impl == "shard_map" else ())

    # -- inputs ------------------------------------------------------------

    def shard_batch(self, batch: Dict[str, torch.Tensor], kind: str, cfg
                    ) -> Dict[str, torch.Tensor]:
        """A batch that every rank holds alike, split by
        :func:`batch_specs` (dropped by each input's shape); the batch as
        it is without a mesh."""
        if self.mesh is None:
            return batch
        specs = batch_specs(kind, cfg, self)
        shardings = normalize_shardings(
            self.mesh, {k: specs.get(k, ()) for k in batch}, batch)
        return {k: redistribute(v, self.mesh, shardings[k].placements)
                for k, v in batch.items()}


NO_MESH = Runtime()


# ===========================================================================
# Parameter sharding rules (the reference's ``_RULES``, rewritten for the
# port's per-layer, dot-named parameters: ``layers.3.attn.wq``, not the
# reference's stacked ``layers/attn/wq`` with a leading L axis)

_RULES = [
    # (name regex, spec builder (f = fsdp axis, t = tp axis)); vocab-only
    # embedding sharding, as the reference's
    (r"(^|\.)embed\.table$",          lambda f, t: (t, None)),
    (r"(^|\.)unembed\.w$",            lambda f, t: (None, t)),
    (r"(attn|xattn)\.wq$",            lambda f, t: (f, t, None)),
    (r"(attn|xattn)\.w[kv]$",         lambda f, t: (f, None, None)),
    (r"(attn|xattn)\.wo$",            lambda f, t: (t, None, f)),
    (r"(attn|xattn)\.bq$",            lambda f, t: (t, None)),
    (r"(attn|xattn)\.b[kv]$",         lambda f, t: ()),
    (r"mlp\.w[ig]\.w$",               lambda f, t: (f, t)),
    (r"mlp\.wo\.w$",                  lambda f, t: (t, f)),
    (r"moe\.router$",                 lambda f, t: (None, None)),
    (r"moe\.w[ig]$",                  lambda f, t: (f, None, t)),
    (r"moe\.wo$",                     lambda f, t: (f, t, None)),
    (r"mix\.in_proj\.w$",             lambda f, t: (f, t)),
    (r"mix\.out_proj\.w$",            lambda f, t: (t, f)),
    (r"mix\.conv_[wb]$",              lambda f, t: ()),
    (r"mix\.(A_log|D|dt_bias)$",      lambda f, t: ()),
    (r"mix\.norm\.g$",                lambda f, t: ()),
    (r"shared_attn\.in_proj\.w$",     lambda f, t: (f, None)),
    (r"(^|\.)pos_(enc|dec)$",         lambda f, t: (None, f)),
]


def param_spec(name: str, ndim: int, fsdp, tp) -> Spec:
    """The rule's spec for parameter ``name`` of rank ``ndim`` (norms,
    biases and scalars replicate). A port parameter is one block's slice of
    the reference's stacked leaf, so no leading ``None`` is prepended:
    the rule's rank is the parameter's; a spec longer than it keeps its
    last ``ndim`` entries, as the reference does."""
    base: Spec = ()
    for pat, builder in _RULES:
        if re.search(pat, name):
            base = builder(fsdp, tp)
            break
    if len(base) > ndim:
        base = base[len(base) - ndim:]
    return tuple([None] * (ndim - len(base))) + tuple(base)


def make_param_shardings(mesh: DeviceMesh, model, fsdp="data", tp="model",
                         moe_ep="data") -> Dict[str, NamedSharding]:
    """Parameter name -> :class:`NamedSharding` of ``model``'s parameters
    (meta or fake tensors will do), the axes that do not divide a dim
    dropped. ``fsdp=None``: weight-stationary serving, sharded over the TP
    axis only; ``moe_ep="model"``: experts over the TP axis."""
    out = {}
    for name, p in model.named_parameters():
        if moe_ep == "model" and re.search(r"moe\.w[igo]$", name):
            spec = (tp, None, None)
        else:
            spec = param_spec(name, p.dim(), fsdp, tp)
        out[name] = NamedSharding(mesh,
                                  drop_indivisible(mesh, spec, p.shape))
    return out


def distribute_params(model, shardings: Dict[str, NamedSharding]):
    """Each parameter of ``model`` replaced, in place, by a DTensor on its
    sharding (``distribute_tensor``: rank 0's values scattered); returns
    ``model``."""
    from torch.distributed.tensor import distribute_tensor
    named = dict(model.named_parameters())
    if set(named) != set(shardings):
        raise ValueError(
            f"shardings name other parameters: missing "
            f"{sorted(set(named) - set(shardings))[:5]}, unexpected "
            f"{sorted(set(shardings) - set(named))[:5]}")
    for name, p in named.items():
        sh = shardings[name]
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        d = distribute_tensor(p.detach(), sh.mesh, sh.placements)
        setattr(mod, attr, torch.nn.Parameter(
            d, requires_grad=p.requires_grad))
    return model


def batch_specs(shape_kind: str, cfg, rt: Runtime) -> Dict[str, Spec]:
    """The specs of each step kind's batch inputs."""
    b = rt.batch_axes
    if cfg.family == "encdec":
        if shape_kind == "train":
            return {"frames": (b, None, None), "tokens": (b, None),
                    "labels": (b, None)}
        if shape_kind == "prefill":
            return {"frames": (b, None, None), "tokens": (b, None)}
        return {"token": (b, None), "pos": (b,)}
    if shape_kind == "train":
        specs = {"tokens": (b, None), "labels": (b, None)}
    elif shape_kind == "prefill":
        specs = {"tokens": (b, None)}
    else:
        specs = {"token": (b, None), "pos": (b,)}
    if cfg.family == "vlm":
        if shape_kind in ("train", "prefill"):
            specs["vision_embeds"] = (b, None, None)
        specs["positions3d"] = (None, b, None)
    return specs


def cache_specs(cfg, rt: Runtime, long_context: bool = False):
    """The specs of the port's decode caches (``lm.init_cache``'s trees):
    KV caches split along the sequence over the TP axis (and the fsdp axis
    for long contexts), so that decode attention stays local but for its
    max and sums (:meth:`Runtime.flash_decode`); SSM states over the TP
    axis on their head dim, conv states on their channels. K and V are two
    tensors in every family."""
    b, t = rt.batch_axes, rt.tp_axis
    s_ax = (rt.fsdp_axis, t) if long_context else t
    fam = cfg.family
    kv = (None, b, s_ax, None, None)                 # (L, B, T, kv, hd)
    if fam in ("dense", "moe", "vlm"):
        return (kv, kv)
    if fam == "ssm":
        return ((None, b, None, t, None), (None, b, None, t))
    if fam == "hybrid":
        m = ((None, None, b, None, t, None), (None, None, b, None, t))
        return (m, (kv, kv))
    if fam == "encdec":
        return ((kv, kv), (b, None, None))
    raise ValueError(fam)


def normalize_shardings(mesh: DeviceMesh, specs, shapes):
    """A tree (tuples, lists, dicts) of specs as :class:`NamedSharding`s,
    each dropped by the shape at its place in ``shapes`` (a tree of tensors
    or shapes)."""
    def is_spec(s):
        return isinstance(s, tuple) and all(
            e is None or isinstance(e, str) or (
                isinstance(e, tuple) and all(isinstance(n, str) for n in e))
            for e in s)

    def fix(spec, leaf):
        if isinstance(spec, dict):
            return {k: fix(spec[k], leaf[k]) for k in spec}
        if not is_spec(spec):
            return type(spec)(fix(s, l) for s, l in zip(spec, leaf))
        shape = leaf.shape if hasattr(leaf, "shape") else leaf
        return NamedSharding(mesh, drop_indivisible(mesh, spec, shape))
    return fix(specs, shapes)
