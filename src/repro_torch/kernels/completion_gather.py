"""Device-side cross-segment completion gather (docs/DESIGN.md §5).

Given the engine's device-resident inverse maps and a stacked pool of
produced relation blocks, this module

  1. resolves every planned ``(segment, global id)`` pair to its local block
     row by **batched binary search** over the sorted inverse maps (the
     kernel searches only the pair's segment's run, from the engine's start
     table),
  2. gathers the pair's ``(M, L)`` row from the block pool, and
  3. performs the union / self-removal / dedup / compaction into the paper's
     padded ``(M, L)`` layout with two lane-wise sorts,

returning one device tensor per completion batch — a single host round trip
instead of one per consulted block.

Backends (the engine's ``backend``):

  - ``"torch"`` : plain PyTorch — the row resolve is a ``torch.searchsorted``
                  over the combined int32 keys when they fit (``inv_key``),
                  else an int32-safe lexicographic binary search; the plain
                  version of the kernel is :func:`resolve_gather_torch`
  - ``"cuda"``  : steps 1-2 run in the hand-written Hopper kernel of
                  ``csrc/completion_gather.cu`` (:func:`resolve_gather_cuda`,
                  replacing the reference's ``_gather_kernel`` /
                  ``_resolve_gather_pallas``); CUDA tensors only

The union epilogue (:func:`union_pairs`) is plain PyTorch on both, as it is
plain ``jnp`` in the reference.

A sharded engine (docs/DESIGN.md §9) splits steps 1-2 over its shards:
:func:`gather_candidates` is one shard's half, the same resolve + gather
with the rows of pairs the shard does not own set to exact zeros (the
kernel's ``mask`` mode on the card), and
``distributed.sharding.all_sum_shards`` sums the halves before the one
union. All ids are int32; ``BIG`` (int32 max) is
the sentinel for removed entries and sorts last, so two ascending sorts with
a duplicate mask in between give "all unique neighbours, ascending".

No single PyTorch call computes the resolve-and-gather (a search over
split keys, then a row gather masked by the result), so the kernel has no
library yardstick.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, Optional, Tuple

import torch

from . import _build
from .segment_relations import _check

BIG = 2 ** 31 - 1

LAUNCHES: Dict[str, int] = {"gather": 0}
_LAUNCH_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int


def _bisect_steps(n: int) -> int:
    """Iterations for a vectorized bisection over n sorted keys."""
    return int(math.ceil(math.log2(max(n, 2)))) + 1


def _resolve_key(inv_key, inv_row, seg, gid, n_global: int):
    """Combined-int32-key row resolve: one ``torch.searchsorted`` over the
    sorted ``seg * n_global + gid`` keys (int32 arithmetic, as the
    reference's)."""
    q = seg * n_global + gid
    pos = torch.searchsorted(inv_key, q)
    pos_c = pos.clamp(max=inv_key.shape[0] - 1)
    return torch.where(inv_key[pos_c] == q, inv_row[pos_c], -1)


def _resolve_lex(inv_seg, inv_gid, inv_row, seg, gid):
    """Lexicographic ``(segment, gid)`` binary search — int32-safe for any
    mesh size: ``_bisect_steps(K)`` frozen-interval steps over the unpadded
    maps, ``mid`` clamped to ``K - 1``."""
    K = inv_seg.shape[0]
    lo = torch.zeros_like(seg, dtype=torch.int64)
    hi = torch.full_like(seg, K, dtype=torch.int64)
    for _ in range(_bisect_steps(K)):
        mid = (lo + hi) // 2
        mid_c = mid.clamp(max=K - 1)
        ks = inv_seg[mid_c]
        kg = inv_gid[mid_c]
        less = (ks < seg) | ((ks == seg) & (kg < gid))
        upd = mid < hi
        lo = torch.where(upd & less, mid + 1, lo)
        hi = torch.where(upd & ~less, mid, hi)
    pos = lo.clamp(max=K - 1)
    found = (lo < K) & (inv_seg[pos] == seg) & (inv_gid[pos] == gid)
    return torch.where(found, inv_row[pos], -1)


def resolve_rows(inv_seg, inv_gid, inv_row, seg, gid,
                 inv_key=None, n_global: int = 0) -> torch.Tensor:
    """Batched ``(segment, gid) -> local block row`` (-1 absent).

    With ``inv_key`` (combined int32 keys, only staged when
    ``n_segments * n_global < 2**31``) this is one ``torch.searchsorted``;
    without it, a lexicographic binary search over the split columns."""
    if inv_seg.shape[0] == 0:
        return torch.full(seg.shape, -1, dtype=torch.int32, device=seg.device)
    if inv_key is not None:
        return _resolve_key(inv_key, inv_row, seg, gid, int(n_global))
    return _resolve_lex(inv_seg, inv_gid, inv_row, seg, gid)


def resolve_gather_torch(pool_M, pool_L, inv_seg, inv_gid, inv_row,
                         pair_slot, pair_seg, pair_gid, inv_key=None,
                         n_global: int = 0, mask: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the resolve + gather kernel: ``(cand (P, degp),
    clen (P,))``. ``cand`` is the pool row at the clamped flat index for
    every pair; ``clen`` is its length where the pair resolved and has a
    slot, else 0. ``mask`` sets ``cand`` to 0 on the rows of the other
    pairs (the reference's ``_gather_candidates_xla``)."""
    S, R, degp = pool_M.shape
    rows = resolve_rows(inv_seg, inv_gid, inv_row, pair_seg, pair_gid,
                        inv_key=inv_key, n_global=n_global)
    ok = (pair_slot >= 0) & (rows >= 0)
    flat = (pair_slot.clamp(min=0).long() * R
            + rows.clamp(0, R - 1).long())
    cand = pool_M.reshape(S * R, degp)[flat]
    if mask:
        cand = torch.where(ok[:, None], cand, 0)
    clen = torch.where(ok, pool_L.reshape(S * R)[flat], 0)
    return cand, clen.to(torch.int32)


def _lib() -> ctypes.CDLL:
    lib = _build.load("completion_gather")
    if not getattr(lib, "_repro_bound", False):
        lib.cg_error_string.argtypes = [_I]
        lib.cg_error_string.restype = ctypes.c_char_p
        lib.cg_resolve_gather.argtypes = [_I] + [_P] * 12 + [_I] * 7 + [_P]
        lib.cg_resolve_gather.restype = _I
        lib._repro_bound = True
    return lib


def resolve_gather_cuda(pool_M, pool_L, inv_seg, inv_gid, inv_row,
                        pair_slot, pair_seg, pair_gid, inv_key=None,
                        n_global: int = 0, mask: bool = False, *, inv_start
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The resolve + gather on the card (``csrc/completion_gather.cu``):
    the same ``(cand, clen)`` as :func:`resolve_gather_torch`, ``mask``
    included (the kernel zeroes the rows itself). ``inv_start``
    (``(S + 1,)`` int32, the engine's ``dev_inverse_starts``) holds where
    each segment's run of the maps starts, so a pair searches only its own
    segment's run. Takes CUDA int32 contiguous tensors on one device and
    raises on anything else; launches on the current stream without
    synchronising."""
    if not isinstance(pool_M, torch.Tensor) or pool_M.dim() != 3:
        raise ValueError("pool_M must be an (S, R, degp) tensor")
    S, R, degp = pool_M.shape
    K, P = len(inv_seg), len(pair_slot)
    for name, t, shape in (("pool_M", pool_M, (S, R, degp)),
                           ("pool_L", pool_L, (S, R)),
                           ("inv_seg", inv_seg, (K,)),
                           ("inv_gid", inv_gid, (K,)),
                           ("inv_row", inv_row, (K,)),
                           ("inv_key", inv_key, (K,)),
                           ("pair_slot", pair_slot, (P,)),
                           ("pair_seg", pair_seg, (P,)),
                           ("pair_gid", pair_gid, (P,))):
        if t is not None:
            _check(t, name, shape)
    if not isinstance(inv_start, torch.Tensor) or inv_start.dim() != 1 \
            or len(inv_start) < 1:
        raise ValueError("inv_start must be the (S + 1,) segment start "
                         "table of the inverse maps")
    _check(inv_start, "inv_start", tuple(inv_start.shape))
    dev = pool_M.device
    for t in (pool_L, inv_seg, inv_gid, inv_row, inv_key, inv_start,
              pair_slot, pair_seg, pair_gid):
        if t is not None and t.device != dev:
            raise ValueError("every input must lie on one device")
    if S * R == 0 or K >= 2 ** 31 or S * R * degp >= 2 ** 62:
        raise ValueError(f"pool {tuple(pool_M.shape)} / K={K} out of range")
    cand = torch.empty((P, degp), dtype=torch.int32, device=dev)
    clen = torch.empty((P,), dtype=torch.int32, device=dev)
    if P == 0:
        return cand, clen
    lib = _lib()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.cg_resolve_gather(
        idx, pool_M.data_ptr(), pool_L.data_ptr(), inv_seg.data_ptr(),
        inv_gid.data_ptr(), inv_row.data_ptr(),
        inv_key.data_ptr() if inv_key is not None else None,
        inv_start.data_ptr(), pair_slot.data_ptr(), pair_seg.data_ptr(),
        pair_gid.data_ptr(), cand.data_ptr(), clen.data_ptr(), P, K, R, degp,
        int(n_global), len(inv_start) - 1, int(bool(mask)), stream)
    if rc != 0:
        msg = lib.cg_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"completion gather kernel launch failed: "
                           f"cudaError {rc} ({msg})")
    with _LAUNCH_LOCK:
        LAUNCHES["gather"] += 1
    return cand, clen


# -- union / self-removal / dedup / compaction epilogue ----------------------


# contract: device-resident
def union_pairs(cand, cand_len, pair_gid, pair_at, deg_out: int):
    """cand (P, degp) gathered rows, cand_len (P,) their valid lengths,
    pair_at (n, w) pair index per query slot (-1 empty). Returns
    ``(M (n, min(w * degp, deg_out)), L (n,), raw, kept)`` — L is the TRUE
    unique count (may exceed deg_out; the caller raises on that
    overflow)."""
    degp = cand.shape[1]
    col = torch.arange(degp, device=cand.device, dtype=torch.int32)[None, :]
    valid = (col < cand_len[:, None]) & (cand >= 0)
    raw = valid.sum()
    vals = torch.where(valid & (cand != pair_gid[:, None]), cand, BIG)
    buck = torch.where(pair_at[..., None] >= 0,
                       vals[pair_at.clamp(min=0).long()], BIG)  # (n, w, degp)
    flat = torch.sort(buck.reshape(buck.shape[0], -1), dim=1).values
    dup = torch.zeros_like(flat, dtype=torch.bool)
    dup[:, 1:] = flat[:, 1:] == flat[:, :-1]
    flat = torch.sort(torch.where(dup, BIG, flat), dim=1).values
    L = (flat < BIG).sum(dim=1).to(torch.int32)
    M = flat[:, :deg_out]
    M = torch.where(M == BIG, -1, M).to(torch.int32)
    return M, L, raw, L.sum()


# -- public entry -------------------------------------------------------------


# contract: device-resident
def gather_union(
    pool_M: torch.Tensor,        # (S, R, degp) i32 stacked full blocks
    pool_L: torch.Tensor,        # (S, R) i32 row lengths
    inv_seg: torch.Tensor,       # (K,) i32 sorted lexicographically with
    inv_gid: torch.Tensor,       # (K,) i32   inv_gid (docs/DESIGN.md §2)
    inv_row: torch.Tensor,       # (K,) i32 local row per appearance
    pair_slot: torch.Tensor,     # (P,) i32 pool slot per pair (-1 padding)
    pair_seg: torch.Tensor,      # (P,) i32 segment per pair (row resolve)
    pair_gid: torch.Tensor,      # (P,) i32 query gid per pair
    pair_at: torch.Tensor,       # (n, w) i32 pair index per query (-1 empty)
    deg_out: int,
    backend: str = "torch",
    inv_key: Optional[torch.Tensor] = None,
    n_global: int = 0,
    inv_start: Optional[torch.Tensor] = None,   # (S + 1,) i32 run starts
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Device-side completion gather: resolve rows, gather, union, compact.

    Returns ``(M (n, deg_out) i32, L (n,) i32, raw, kept)`` on the inputs'
    device; ``L`` is the TRUE unique-neighbour count and may exceed
    ``deg_out``, in which case ``M`` is truncated and the caller must raise
    (the engine's preallocated-width contract). ``raw``/``kept`` are the
    gathered-entry counters feeding ``EngineStats``. ``backend="cuda"``
    launches the kernel (CUDA tensors only), which needs ``inv_start``;
    ``"torch"`` runs the plain version on any device and ignores it."""
    if backend == "cuda":
        cand, clen = resolve_gather_cuda(
            pool_M, pool_L, inv_seg, inv_gid, inv_row, pair_slot, pair_seg,
            pair_gid, inv_key=inv_key, n_global=n_global,
            inv_start=inv_start)
    elif backend == "torch":
        cand, clen = resolve_gather_torch(
            pool_M, pool_L, inv_seg, inv_gid, inv_row, pair_slot, pair_seg,
            pair_gid, inv_key=inv_key, n_global=n_global)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return union_pairs(cand, clen, pair_gid, pair_at, deg_out)


# contract: device-resident
def gather_candidates(pool_M, pool_L, inv_seg, inv_gid, inv_row,
                      pair_slot, pair_seg, pair_gid, inv_key=None,
                      n_global: int = 0, backend: str = "torch",
                      inv_start: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's half of the sharded completion exchange (docs/DESIGN.md
    §9): resolve the ``(segment, gid)`` pairs against the global inverse
    maps and gather candidate rows from THIS shard's block pool, with the
    pairs the shard does not own (``pair_slot == -1``) and the unresolved
    ones given exact zeros in both ``cand`` and ``cand_len``.

    The returned ``(cand (P, degp), cand_len (P,))`` int32 are summed
    over the shards (``distributed.sharding.all_sum_shards``) and fed to
    :func:`union_pairs`: together bit-identical to :func:`gather_union`
    over one combined pool. ``backend="cuda"`` launches the resolve +
    gather kernel in its mask mode (CUDA tensors only, needs
    ``inv_start``); ``"torch"`` runs its plain version."""
    if backend == "cuda":
        return resolve_gather_cuda(
            pool_M, pool_L, inv_seg, inv_gid, inv_row, pair_slot, pair_seg,
            pair_gid, inv_key=inv_key, n_global=n_global, mask=True,
            inv_start=inv_start)
    if backend == "torch":
        return resolve_gather_torch(
            pool_M, pool_L, inv_seg, inv_gid, inv_row, pair_slot, pair_seg,
            pair_gid, inv_key=inv_key, n_global=n_global, mask=True)
    raise ValueError(f"unknown backend {backend!r}")
