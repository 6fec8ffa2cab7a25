"""Cross-segment completion of adjacency relations (EE / FF / TT).

A segment-local kernel sees only the segment's internal+external tets, so an
adjacency row for simplex sigma can miss neighbours that share only the
sub-simplex *not* containing the owner segment's vertex (docs/DESIGN.md §5).
The complete answer is the union of sigma's row over the owner segments of
each of its boundary (k-1)-faces — every neighbour shares one of those faces,
and both simplices contain that face's minimum vertex, hence appear in that
owner's local tables.

This module assembles that union through the engine as a batched pipeline
with a plan/execute split:

  - :func:`plan_completion` vectorizes the boundary-face -> owner-segment
    fan-out for the whole query batch, resolves every (segment, query) pair
    to a local block row through the inverse maps built at table time, and
    issues ONE :meth:`RelationEngine.prefetch_many` for every block the
    batch needs, so production overlaps with whatever the consumer does next.
  - :func:`execute_completion_device` — the GALE path — keeps the gather on
    the device: it stacks the consulted blocks from the engine's device
    block pool, re-resolves every (segment, gid) pair to its row by batched
    binary search over the DEVICE inverse maps, and unions/dedups/compacts
    on the device (``kernels/completion_gather.py``) — ONE host round trip
    per batch, or none with ``out="dev"``.
  - :func:`execute_completion_sharded` is the device path of a sharded
    engine (docs/DESIGN.md §9): each shard resolves and gathers the pairs
    of its own segments from its own pool, the other pairs as exact
    zeros, and the shards' halves are summed before the one union.
  - :func:`execute_completion` is the host reference: one
    :meth:`RelationEngine.get_full` per distinct segment, union as
    vectorized numpy ops.

:func:`complete_adjacency` drives plan + execute; ``path=`` selects the
execute arm and ``batch=`` pipelines chunks (plan + prefetch chunk k+1 before
executing chunk k). Both paths are bit-identical for any chunking.
Completion work is accounted in ``EngineStats`` (``completion_queries``,
``completion_fanout_blocks``, ``completion_raw_neighbors`` /
``completion_neighbors`` and the derived ``completion_dedup_ratio``).

:func:`complete_adjacency_scalar` is the one-simplex-at-a-time reference
kept for the bit-identical regression tests.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..distributed.sharding import all_sum_shards
from ..errors import RelationWidthError
from ..kernels import completion_gather, ops
from .engine import RelationEngine

ADJ_COMPLETION_RELATIONS = ("EE", "FF", "TT")


@dataclasses.dataclass
class CompletionPlan:
    """Resolved fan-out of one completion batch: which block rows to union.

    ``pair_*`` arrays describe the deduplicated (query, segment) pairs, each
    carrying the query simplex's local row inside that segment's full block.
    """

    relation: str
    ids: np.ndarray         # (n,) i64 query global ids
    pair_query: np.ndarray  # (P,) i64 index into ids
    pair_seg: np.ndarray    # (P,) i64 segment whose block is consulted
    pair_row: np.ndarray    # (P,) i32 row of the query in that full block
    segments: np.ndarray    # distinct consulted segments, ascending


def _boundary_owner_segments(eng: RelationEngine, relation: str,
                             ids: np.ndarray) -> np.ndarray:
    """Owner segments of each query's boundary (k-1)-faces: (n, k+1)."""
    kind = relation[0]
    pre = eng.pre
    if kind == "E":
        verts = pre.E[ids]                            # (n, 2) vertices
        return pre.smesh.seg_of_vertex[verts].astype(np.int64)
    if kind == "F":
        fe = eng.boundary_FE(ids)                     # (n, 3) edge ids
        return pre.owner_segment("E", fe).astype(np.int64)
    tf = eng.boundary_TF(ids)                         # (n, 4) face ids
    return pre.owner_segment("F", tf).astype(np.int64)


def plan_completion(eng: RelationEngine, relation: str,
                    ids: Sequence[int], prefetch: bool = True
                    ) -> CompletionPlan:
    """Vectorized fan-out planning for a whole query batch.

    Dedups the (query, owner-segment) pairs, resolves each pair's local block
    row via the inverse maps, and (by default) prefetches every distinct
    ``(relation, segment)`` block in one non-blocking ``prefetch_many`` so
    the producer runs while the consumer proceeds."""
    assert relation in ADJ_COMPLETION_RELATIONS
    if relation not in eng.relations:
        raise ValueError(
            f"completion of {relation!r} needs it in the engine's relation "
            f"set (got {eng.relations}); construct the RelationEngine with "
            f"it so the producer has a queue to serve the fan-out from")
    kind = relation[0]
    ids = np.asarray(ids, dtype=np.int64).reshape(-1)
    n = len(ids)
    ns = eng.smesh.n_segments
    if n == 0:
        empty = np.zeros(0, dtype=np.int64)
        return CompletionPlan(relation, ids, empty, empty,
                              empty.astype(np.int32), empty)

    owners = _boundary_owner_segments(eng, relation, ids)   # (n, k+1)
    w = owners.shape[1]
    qidx = np.repeat(np.arange(n, dtype=np.int64), w)
    # dedup (query, segment) pairs across boundary faces in one unique pass
    ukey = np.unique(qidx * ns + owners.reshape(-1))
    pair_query = ukey // ns
    pair_seg = ukey % ns
    pair_row = eng.local_rows(kind, pair_seg, ids[pair_query])
    # completion invariant (docs/DESIGN.md §5): every boundary-face owner's
    # table contains the query simplex; tolerate (and skip) violations so
    # the batched path degrades exactly like the scalar one
    ok = pair_row >= 0
    if not ok.all():
        pair_query, pair_seg, pair_row = (
            pair_query[ok], pair_seg[ok], pair_row[ok])
    segments = np.unique(pair_seg)

    eng.stat_bump(completion_queries=n,
                  completion_fanout_blocks=len(segments))
    if prefetch:
        eng.prefetch_many({relation: [int(s) for s in segments]})
    return CompletionPlan(relation, ids, pair_query, pair_seg,
                          pair_row.astype(np.int32), segments)


def execute_completion(eng: RelationEngine, plan: CompletionPlan
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Gather + union the planned rows into padded ``(M, L)`` arrays on the
    host: each distinct segment block is read once through ``get_full``,
    then the union / self-removal / dedup / compaction run as vectorized
    numpy ops. Rows come out ascending — bit-identical to the scalar
    reference."""
    n = len(plan.ids)
    P = len(plan.pair_seg)
    if P == 0:
        return (np.full((n, 1), -1, dtype=np.int64),
                np.zeros(n, dtype=np.int32))

    # one gather per consulted segment: re-sort the pairs by segment so each
    # block is sliced exactly once
    order = np.argsort(plan.pair_seg, kind="stable")
    seg_sorted = plan.pair_seg[order]
    lo = np.searchsorted(seg_sorted, plan.segments, side="left")
    hi = np.searchsorted(seg_sorted, plan.segments, side="right")
    deg = eng.deg[plan.relation]
    vals = np.full((P, deg), -1, dtype=np.int64)
    lens = np.zeros(P, dtype=np.int64)
    for s, a, b in zip(plan.segments, lo, hi):
        Mf, Lf = eng.get_full(plan.relation, int(s))
        sel = order[a:b]
        rows = plan.pair_row[sel]
        width = min(deg, Mf.shape[1])
        vals[sel, :width] = Mf[rows, :width]
        lens[sel] = np.minimum(Lf[rows], width)

    # flatten valid entries -> (query, neighbor) pairs
    col = np.arange(deg, dtype=np.int64)
    valid = (col[None, :] < lens[:, None]) & (vals >= 0)
    nb = vals[valid]
    q = np.broadcast_to(plan.pair_query[:, None], (P, deg))[valid]
    raw = len(nb)
    # remove the query simplex itself, then dedup per query (sorted)
    keep = nb != plan.ids[q]
    nb, q = nb[keep], q[keep]
    if len(nb):
        srt = np.lexsort((nb, q))
        nb, q = nb[srt], q[srt]
        first = np.ones(len(nb), dtype=bool)
        first[1:] = (q[1:] != q[:-1]) | (nb[1:] != nb[:-1])
        nb, q = nb[first], q[first]

    counts = np.bincount(q, minlength=n) if len(nb) else np.zeros(n, np.int64)
    width = max(int(counts.max()) if len(counts) else 0, 1)
    M = np.full((n, width), -1, dtype=np.int64)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    M[q, np.arange(len(nb)) - offsets[q]] = nb
    L = counts.astype(np.int32)

    eng.stat_bump(completion_raw_neighbors=raw,
                  completion_neighbors=len(nb))
    return M, L


# Max (query, segment) pairs per query = number of boundary (k-1)-faces.
_PAIR_WIDTH = {"E": 2, "F": 3, "T": 4}

_pow2 = ops.bucket_rows


def _width_error(relation: str, worst: int, deg: int) -> RelationWidthError:
    return RelationWidthError(
        f"completed {relation!r} row has {worst} neighbours but the "
        f"preallocated width is deg[{relation!r}]={deg}; construct the "
        f"engine with deg={{{relation!r}: {worst}}} (or larger).",
        relation=relation)


def _pair_meta(plan: CompletionPlan, w: int):
    """The pair columns shared by every execute arm of the device path:
    the ``(pow2(n), w)`` per-query pair map and the pairs' segment and
    query gid, padded to a power-of-two pair count with inert entries."""
    n, P = len(plan.ids), len(plan.pair_seg)
    # per-query pair positions (pairs come sorted by query from the plan's
    # unique pass) -> the (n, w) pair_at gather map
    counts_p = np.bincount(plan.pair_query, minlength=n)
    off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts_p, out=off[1:])
    pos = np.arange(P, dtype=np.int64) - off[plan.pair_query]
    pair_at = np.full((_pow2(n), w), -1, dtype=np.int32)
    pair_at[plan.pair_query, pos] = np.arange(P, dtype=np.int32)
    pad = _pow2(P) - P
    pair_seg = np.concatenate(
        [plan.pair_seg.astype(np.int32), np.zeros(pad, np.int32)])
    pair_gid = np.concatenate(
        [plan.ids[plan.pair_query].astype(np.int32),
         np.full(pad, -1, np.int32)])
    return pair_at, pair_seg, pair_gid, pad


def _finish(relation: str, M_dev, L_dev, n: int, deg: int, out: str):
    """The device path's overflow check and output: the padded ``(n,
    deg)`` device rows for ``out="dev"`` (one scalar reduce), else the
    batch's ONE host round trip, trimmed to the realized width."""
    if out == "dev":
        worst = int(L_dev[:n].max()) if n else 0
        if worst > deg:
            raise _width_error(relation, worst, deg)
        return M_dev[:n], L_dev[:n]
    Mh = M_dev[:n].cpu().numpy()          # contract: host-roundtrip
    Lh = L_dev[:n].cpu().numpy()          # contract: host-roundtrip
    worst = int(Lh.max()) if n else 0
    if worst > deg:
        raise _width_error(relation, worst, deg)
    width = max(worst, 1)
    return Mh[:, :width].astype(np.int64), Lh.astype(np.int32)


def _empty(eng, plan: CompletionPlan, out: str):
    """All-empty rows for a batch with no resolved pair."""
    n = len(plan.ids)
    if out == "dev":   # width stays deg so chunked device concat lines up
        return (torch.full((n, eng.deg[plan.relation]), -1,
                           dtype=torch.int32, device=eng.device),
                torch.zeros(n, dtype=torch.int32, device=eng.device))
    return (np.full((n, 1), -1, dtype=np.int64),
            np.zeros(n, dtype=np.int32))


# contract: device-resident
def execute_completion_device(eng: RelationEngine, plan: CompletionPlan,
                              out: str = "host"):
    """Device-side gather + union of the planned rows (the GALE path).

    Stacks the consulted blocks from the engine's device block pool
    (``get_full_dev_batch`` — blocking only on launches still in flight),
    re-resolves every (segment, gid) pair to its block row by batched binary
    search over the DEVICE inverse maps, and performs the union /
    self-removal / dedup / compaction on the device
    (``kernels/completion_gather.py``, backend per ``eng.backend``). One
    host round trip per batch; bit-identical to :func:`execute_completion`.

    With ``out="dev"`` the completed rows STAY on the device: the return
    value is ``(M (n, deg) int32, L (n,) int32)`` device tensors for a
    device-resident consumer (docs/DESIGN.md §6); the overflow check reduces
    ``L`` to one scalar.

    Raises :class:`RelationWidthError` if a completed row would overflow
    ``deg[relation]`` (the preallocated relation-array width)."""
    if not hasattr(eng, "get_full_dev"):
        raise TypeError(
            "the device completion path needs a RelationEngine (device "
            "block pool + device inverse maps); use path='host' for "
            f"{type(eng).__name__}")
    n = len(plan.ids)
    P = len(plan.pair_seg)
    if P == 0:
        return _empty(eng, plan, out)
    relation = plan.relation
    kind = relation[0]
    deg = eng.deg[relation]
    dev = eng.device

    # device block pool, padded to a power-of-two slot count (padding
    # repeats slot 0; no pair references it), as the reference
    pool_M, pool_L = eng.get_full_dev_batch(
        relation, plan.segments, pad_to=_pow2(len(plan.segments)))
    pair_at, pair_seg, pair_gid, pad = _pair_meta(plan, _PAIR_WIDTH[kind])
    # padding pairs are inert (slot == -1)
    slot = np.searchsorted(plan.segments, plan.pair_seg).astype(np.int32)
    pair_slot = np.concatenate([slot, np.full(pad, -1, np.int32)])

    inv_seg, inv_gid, inv_row, inv_key, n_glob = eng.dev_inverse(kind)
    M_dev, L_dev, raw, kept = completion_gather.gather_union(
        pool_M, pool_L, inv_seg, inv_gid, inv_row,
        *(torch.from_numpy(a).to(dev)
          for a in (pair_slot, pair_seg, pair_gid, pair_at)),
        deg_out=deg, backend=eng.backend, inv_key=inv_key, n_global=n_glob,
        inv_start=eng.dev_inverse_starts(kind))

    eng.stat_bump(completion_raw_neighbors=int(raw),
                  completion_neighbors=int(kept))
    return _finish(relation, M_dev, L_dev, n, deg, out)


# contract: device-resident
def execute_completion_sharded(eng: RelationEngine, plan: CompletionPlan,
                               out: str = "host"):
    """The completion exchange of a sharded engine (docs/DESIGN.md §9).

    Each (query, segment) pair is owned by exactly one shard: the one that
    produced and retains the consulted segment's block. Per shard, the
    ``(segment, gid)`` resolve + pool gather of the device path runs over
    the shard's OWN blocks only
    (:func:`~repro_torch.kernels.completion_gather.gather_candidates`,
    backend per ``eng.backend``), with non-owned pairs as exact zeros; an
    elementwise integer sum over the shards
    (:func:`~repro_torch.distributed.sharding.all_sum_shards`) rebuilds
    the single-pool candidate matrix bit for bit, and the shared union
    epilogue runs once. Bit-identical to
    :func:`execute_completion_device`, with one host round trip per batch
    (none with ``out="dev"``)."""
    splan = eng.shard_plan
    n = len(plan.ids)
    P = len(plan.pair_seg)
    if P == 0:
        return _empty(eng, plan, out)
    relation = plan.relation
    kind = relation[0]
    deg = eng.deg[relation]
    dev = eng.device
    pair_at, pair_seg, pair_gid, pad = _pair_meta(plan, _PAIR_WIDTH[kind])
    pair_shard = splan.shard_of_array(plan.pair_seg)
    pair_seg_dev = torch.from_numpy(pair_seg).to(dev)
    pair_gid_dev = torch.from_numpy(pair_gid).to(dev)

    # per-shard halves: each shard consults only its own contiguous slice
    # of the planned segments, served from ITS device pool
    parts, part_devs = [], []
    seg_lo = np.searchsorted(plan.segments, splan.bounds[:-1], side="left")
    seg_hi = np.searchsorted(plan.segments, splan.bounds[1:], side="left")
    for k in range(splan.n_shards):
        segs_k = plan.segments[seg_lo[k]:seg_hi[k]]
        sel = pair_shard == k
        if len(segs_k) == 0 or not sel.any():
            continue
        pool_M, pool_L = eng.get_full_dev_batch(
            relation, segs_k, pad_to=_pow2(len(segs_k)))
        slot_k = np.where(
            sel, np.searchsorted(segs_k, plan.pair_seg).astype(np.int32),
            np.int32(-1))
        pair_slot = np.concatenate([slot_k, np.full(pad, -1, np.int32)])
        inv_seg, inv_gid, inv_row, inv_key, n_glob = eng.dev_inverse(
            kind, shard=k)
        parts.append(completion_gather.gather_candidates(
            pool_M, pool_L, inv_seg, inv_gid, inv_row,
            torch.from_numpy(pair_slot).to(dev), pair_seg_dev,
            pair_gid_dev, inv_key=inv_key, n_global=n_glob,
            backend=eng.backend, inv_start=eng.dev_inverse_starts(kind)))
        part_devs.append(splan.devices[k])
    if not parts:      # no pair resolved anywhere: all-empty rows
        return _empty(eng, plan, out)

    cand, clen = all_sum_shards(parts, part_devs)
    M_dev, L_dev, raw, kept = completion_gather.union_pairs(
        cand, clen, pair_gid_dev, torch.from_numpy(pair_at).to(dev), deg)
    eng.stat_bump(completion_raw_neighbors=int(raw),
                  completion_neighbors=int(kept))
    return _finish(relation, M_dev, L_dev, n, deg, out)


def complete_adjacency(
    eng: RelationEngine, relation: str, ids: Sequence[int],
    batch: Optional[int] = None, path: Optional[str] = None,
    out: str = "host", workers: int = 1, shards: Optional[int] = None,
):
    """Complete EE/FF/TT rows for global simplex ids. Returns padded (M, L).

    ``path`` selects the execute arm: ``"device"`` gathers/unions on the
    engine's device (:func:`execute_completion_device`), ``"host"`` in numpy
    (:func:`execute_completion`); ``None`` picks "device" when the engine
    runs on a CUDA device or ``out == "dev"``, else "host". Both arms are
    bit-identical.

    ``out="dev"`` (device execute arm only) keeps the completed rows on the
    device: ``(M (n, deg[relation]) int32, L (n,) int32)`` tensors for
    device-resident consumers (docs/DESIGN.md §6) — rows stay at the full
    preallocated width, and no host round trip happens.

    With ``batch=k`` the query list is processed in pipelined chunks: chunk
    i+1 is planned (and its blocks prefetched) *before* chunk i is executed.
    ``workers=N`` (with ``batch``) partitions the chunk stream across N
    consumer threads through the scheduler (docs/DESIGN.md §8); chunk
    results are assembled in chunk order. The result is bit-identical for
    any ``batch`` and any ``workers``.

    Sharding follows the *engine's*
    :class:`~repro_torch.distributed.sharding.ShardPlan`: on an engine of
    more than one shard the device arm is the exchange of
    :func:`execute_completion_sharded`. ``shards=`` only validates: a
    count that does not match the engine's plan raises ``ValueError``.
    The result is bit-identical for any shard count."""
    n_shards = getattr(getattr(eng, "shard_plan", None), "n_shards", 1)
    if shards is not None and int(shards) != n_shards:
        raise ValueError(
            f"shards={shards} requested but the engine's shard plan has "
            f"{n_shards} shard(s); construct the RelationEngine with "
            f"shards={shards}")
    if path is None:
        on_card = getattr(getattr(eng, "device", None), "type", "") == "cuda"
        path = ("device" if hasattr(eng, "get_full_dev")
                and (out == "dev" or on_card) else "host")
    if path not in ("host", "device"):
        raise ValueError(f"path must be 'host' or 'device', got {path!r}")
    if out == "dev" and path != "device":
        raise ValueError("out='dev' needs the device execute arm "
                         f"(got path={path!r})")
    if path == "device":
        arm = (execute_completion_sharded if n_shards > 1
               else execute_completion_device)

        def execute(e, p):
            return arm(e, p, out=out)
    else:
        execute = execute_completion
    ids = np.asarray(ids, dtype=np.int64).reshape(-1)
    if batch is None or batch <= 0 or batch >= len(ids):
        return execute(eng, plan_completion(eng, relation, ids))

    chunks = [ids[i:i + batch] for i in range(0, len(ids), batch)]
    if workers and workers > 1:
        from .scheduler import run_collect

        def consume_chunk(i, chunk):       # plan + prefetch (non-blocking)
            return plan_completion(eng, relation, chunk)

        def finalize_chunk(plan):          # gather/union one chunk
            return execute(eng, plan)

        outs = run_collect(chunks, consume_chunk, workers=workers,
                           finalize=finalize_chunk, scope=eng,
                           name=f"completion/{relation}")
    else:
        outs = [None] * len(chunks)
        plans = [plan_completion(eng, relation, chunks[0])]
        for i in range(len(chunks)):
            if i + 1 < len(chunks):  # plan + prefetch ahead of the execute
                plans.append(plan_completion(eng, relation, chunks[i + 1]))
            outs[i] = execute(eng, plans[i])
    if out == "dev":
        # chunk widths are all deg[relation]: one device concat, no host copy
        return (torch.cat([Mc for Mc, _ in outs]),
                torch.cat([Lc for _, Lc in outs]))
    width = max(max(M.shape[1] for M, _ in outs), 1)
    M = np.full((len(ids), width), -1, dtype=np.int64)
    L = np.concatenate([Lc for _, Lc in outs])
    at = 0
    for Mc, Lc in outs:
        M[at:at + len(Lc), : Mc.shape[1]] = Mc
        at += len(Lc)
    return M, L


def complete_adjacency_scalar(
    eng: RelationEngine, relation: str, ids: Sequence[int]
) -> Tuple[np.ndarray, np.ndarray]:
    """One-simplex-at-a-time reference for the batched pipeline: the same
    union over boundary-face owner segments, resolved with Python sets and
    one blocking block read per (query, segment) pair."""
    assert relation in ADJ_COMPLETION_RELATIONS
    kind = relation[0]
    ids = np.asarray(ids, dtype=np.int64).reshape(-1)
    owners = (_boundary_owner_segments(eng, relation, ids)
              if len(ids) else np.zeros((0, 1), np.int64))
    rows = []
    for i, gid in enumerate(ids):
        acc: set = set()
        for s in sorted(set(int(x) for x in owners[i])):
            r = int(eng.local_rows(kind, np.array([s]), np.array([gid]))[0])
            if r < 0:
                continue
            Mf, Lf = eng.get_full(relation, s)
            acc |= set(int(x) for x in Mf[r][: Lf[r]] if x >= 0)
        acc.discard(int(gid))
        rows.append(sorted(acc))
    deg = max((len(r) for r in rows), default=1)
    M = np.full((len(rows), max(deg, 1)), -1, dtype=np.int64)
    L = np.zeros(len(rows), dtype=np.int32)
    for i, r in enumerate(rows):
        M[i, : len(r)] = r
        L[i] = len(r)
    return M, L
