"""Critical point extraction (paper §5.1 'CriticalPoints').

Classifies every vertex by the connectivity of its lower/upper link
(Banchoff [1]): a vertex is a minimum if its lower link is empty, a maximum
if its upper link is empty, regular if both lower and upper links are single
connected components, and a (multi-)saddle otherwise.

Consumes exactly the relations the paper lists for this algorithm: **VV**
(link vertices) and **VT** (link edges come from co-incident tets: two
neighbors of v are link-adjacent iff they share a tet with v).

Per-vertex link connectivity is a transitive closure by repeated boolean
matrix squaring over (deg × deg) link adjacency blocks, batch-parallel over
vertices, instead of the sequential union-find of TTK's CPU implementation.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.adjacency import complete_adjacency
from ..core.mesh import _FACE_COMBOS
from ..core.scheduler import run_partitioned, segment_batches
from ..kernels import ops
from . import consume

# type codes
REGULAR, MINIMUM, SADDLE1, SADDLE2, MAXIMUM, DEGENERATE = -1, 0, 1, 2, 3, 4

_I32_MAX = int(np.iinfo(np.int32).max)

# full-float32 closure products: TF32 is switched off while any classify
# batch runs and restored when the last one leaves (consumer threads share
# the process-wide flag, so a plain save/restore per call would race)
_FP32_LOCK = threading.Lock()
_FP32_USERS = [0, False]          # active batches, saved allow_tf32


@contextlib.contextmanager
def _fp32_matmul():
    with _FP32_LOCK:
        if _FP32_USERS[0] == 0:
            _FP32_USERS[1] = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
        _FP32_USERS[0] += 1
    try:
        yield
    finally:
        with _FP32_LOCK:
            _FP32_USERS[0] -= 1
            if _FP32_USERS[0] == 0:
                torch.backends.cuda.matmul.allow_tf32 = _FP32_USERS[1]


# contract: device-resident
def _boundary_mask(M: torch.Tensor,      # (nt, deg) completed TT, -1 pad
                   T: torch.Tensor,      # (nt, 4) global TV
                   nv: int) -> torch.Tensor:
    """Device boundary-vertex mask from completed TT: a face of tet ``t`` is
    interior iff some TT neighbour contains all three of its vertices (a tet
    containing a face's vertex triple shares that face); vertices of the
    remaining faces are boundary. Same faces/vertices as the host arm's
    ``boundary_TF`` id matching — bit-identical mask."""
    nbT = torch.where(M[..., None] >= 0, T[M.clamp(min=0).long()],
                      -1)                                       # (nt,deg,4)
    faces = torch.stack([T[:, [int(i) for i in c]] for c in _FACE_COMBOS],
                        dim=1)                                  # (nt,4,3)
    # (nt, 4 faces, 3 verts) vs neighbour vertex sets
    shared = (faces[:, :, :, None, None] == nbT[:, None, None, :, :]).any(-1)
    interior = shared.all(2).any(-1)                            # (nt, 4)
    bvert = torch.where(~interior[:, :, None], faces, -1)
    ids = torch.where(bvert >= 0, bvert, nv).reshape(-1).long()
    mask = torch.zeros(nv + 1, dtype=torch.bool, device=M.device)
    mask[ids] = True
    return mask[:nv]


def boundary_vertices(ds, pre, batch: int = 4096,
                      consumer: str = "auto", workers: int = 1,
                      shards=None) -> np.ndarray:
    """Boolean mask of mesh-boundary vertices, via completed TT.

    A tet has one completed-TT neighbour per *interior* face, so a tet with
    fewer than 4 neighbours carries at least one boundary face; a face of
    such a tet is boundary iff no TT neighbour also contains it. Banchoff
    link classification is only exact for interior vertices, so callers use
    this mask to qualify critical points on the domain boundary.

    Requires a ``RelationEngine`` whose relation set includes TT; TT rows
    are requested in pipelined batches. The device consumer arm keeps the
    completed rows on the device and derives the mask there; the host arm
    is the numpy reference. Both arms are bit-identical."""
    sm = pre.smesh
    consume.shard_plan(ds, shards)   # validate; completion follows the plan
    mask = np.zeros(sm.n_vertices, dtype=bool)
    if sm.n_tets == 0:
        return mask
    if (consume.consumer_mode(ds, consumer) == "device"
            and hasattr(ds, "get_full_dev")):
        M, _ = complete_adjacency(ds, "TT", np.arange(sm.n_tets),
                                  batch=batch, path="device", out="dev",
                                  workers=workers)
        T = torch.from_numpy(sm.tets.astype(np.int32)).to(M.device)
        return _boundary_mask(M, T, sm.n_vertices).cpu().numpy()
    M, L = complete_adjacency(ds, "TT", np.arange(sm.n_tets), batch=batch,
                              workers=workers)
    cand = np.nonzero(L < 4)[0]            # tets with >= 1 boundary face
    if len(cand) == 0:
        return mask
    Mc = M[cand]
    deg = Mc.shape[1]
    tf_t = ds.boundary_TF(cand)            # (c, 4) the candidates' faces
    tf_nb = ds.boundary_TF(np.maximum(Mc, 0).reshape(-1)) \
        .reshape(len(cand), deg, 4)        # (c, deg, 4) neighbours' faces
    shared = (tf_t[:, :, None, None] == tf_nb[:, None, :, :]).any(-1)
    interior = (shared & (Mc >= 0)[:, None, :]).any(-1)   # (c, 4)
    bf = tf_t[~interior]                   # boundary face ids
    mask[pre.F[bf].reshape(-1)] = True
    return mask


def total_order(scalars: np.ndarray) -> np.ndarray:
    """Injective vertex order (simulation of simplicity): rank under
    (scalar, index)."""
    n = len(scalars)
    order = np.lexsort((np.arange(n), np.asarray(scalars)))
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n)
    return rank


# contract: device-resident
def _classify_batch(
    vv_M: torch.Tensor,    # (B, deg_v) neighbor global ids, -1 pad
    vt_M: torch.Tensor,    # (B, deg_t) incident tet ids, -1 pad
    row_gid: torch.Tensor,  # (B,) vertex global ids, -1 pad
    tets: torch.Tensor,    # (nt, 4) global TV
    rank: torch.Tensor,    # (nv,) injective order
    deg_v: int, deg_t: int,
) -> torch.Tensor:
    B = vv_M.shape[0]
    dev = vv_M.device
    valid_n = vv_M >= 0
    r_v = rank[row_gid.clamp(min=0).long()]                  # (B,)
    r_n = torch.where(valid_n, rank[vv_M.clamp(min=0).long()], 0)
    lower = valid_n & (r_n < r_v[:, None])                   # (B, deg_v)
    upper = valid_n & ~lower

    # Link edges via shared tets: for each incident tet, the 3 vertices
    # other than v form a triangle in link(v).
    tv = torch.where(vt_M[..., None] >= 0,
                     tets[vt_M.clamp(min=0).long()], -1)    # (B, deg_t, 4)
    is_v = tv == row_gid[:, None, None]
    # compact the 3 non-v vertices per tet: sort puts v's slot last
    key = torch.where(is_v | (tv < 0), _I32_MAX, tv)
    others = torch.sort(key, dim=-1).values[..., :3]         # (B, deg_t, 3)
    others = torch.where(others == _I32_MAX, -1, others)

    # map neighbor global ids -> link positions (index into vv_M row)
    eq = others[..., None] == vv_M[:, None, None, :]         # (B,deg_t,3,deg_v)
    # first matching slot: argmax over an integer view (first-max rule)
    pos = torch.argmax(eq.to(torch.uint8), dim=-1)           # (B, deg_t, 3)
    ok = eq.any(dim=-1)                                      # padded -> False

    # scatter-max of link edges into (B, deg_v, deg_v): duplicate indices
    # accumulate into an int32 count, and > 0 is the max of the booleans
    cnt = torch.zeros(B * deg_v * deg_v, dtype=torch.int32, device=dev)
    base = (torch.arange(B, device=dev) * (deg_v * deg_v))[:, None]
    for a, b in ((0, 1), (0, 2), (1, 2)):
        good = ok[:, :, a] & ok[:, :, b]                     # (B, deg_t)
        pa = torch.where(good, pos[:, :, a], 0)
        pb = torch.where(good, pos[:, :, b], 0)
        upd = good.to(torch.int32).reshape(-1)
        cnt.index_add_(0, (base + pa * deg_v + pb).reshape(-1), upd)
        cnt.index_add_(0, (base + pb * deg_v + pa).reshape(-1), upd)
    adj = (cnt > 0).reshape(B, deg_v, deg_v)

    eye = torch.eye(deg_v, dtype=torch.bool, device=dev)
    iota = torch.arange(deg_v, device=dev)[None, :]
    n_iter = max(1, int(math.ceil(math.log2(deg_v))))

    def n_components(mask):
        A = adj & mask[:, :, None] & mask[:, None, :]
        A = A | (eye[None] & mask[:, :, None])
        # transitive closure by squaring, in full float32 (0/1 entries,
        # counts <= deg_v: exact)
        for _ in range(n_iter):
            Af = A.to(torch.float32)
            A = A | (torch.bmm(Af, Af) > 0)
        root = torch.argmax(A.to(torch.uint8), dim=-1)       # first = min id
        return (mask & (root == iota)).sum(dim=-1)           # #components

    with _fp32_matmul():
        nl = n_components(lower)
        nu = n_components(upper)

    t = torch.full((B,), REGULAR, dtype=torch.int32, device=dev)
    t = torch.where((nl >= 2) & (nu >= 2), DEGENERATE, t)
    t = torch.where((nl >= 2) & (nu <= 1), SADDLE1, t)
    t = torch.where((nl <= 1) & (nu >= 2), SADDLE2, t)
    t = torch.where(nl == 0, MINIMUM, t)
    t = torch.where(nu == 0, MAXIMUM, t)
    # an isolated vertex (empty link: no lower AND no upper component) has
    # no Banchoff classification — flag DEGENERATE, never MAXIMUM
    t = torch.where((nl == 0) & (nu == 0), DEGENERATE, t)
    return t


def critical_points(
    ds,                      # RelationEngine
    pre,
    rank: np.ndarray,
    batch_segments: int = 8,
    lookahead_hint: bool = True,
    flag_boundary: bool = False,
    consumer: str = "auto",
    workers: int = 1,
    shards=None,
) -> Tuple[np.ndarray, Dict[str, int]]:
    """Run the algorithm over all segments through data structure ``ds``,
    on ``ds.device`` (the engine's device).

    The traversal is the paper's embarrassingly-parallel vertex sweep: for
    each batch of segments the consumer requests VV and VT blocks (the
    producer precomputes ahead via the engine's lookahead) and classifies the
    batch on the device.

    ``consumer`` selects the consumer arm (docs/DESIGN.md §6): ``"device"``
    feeds :func:`_classify_batch` straight from the engine's device block
    pool (one :meth:`get_full_dev_many` batch per step, columns trimmed to
    the exact per-mesh degree bounds), ``"host"`` assembles the blocks of
    :meth:`get_batch` in numpy, and ``"auto"`` picks "device" whenever
    ``ds`` exposes the batch API. Results are bit-identical either way.

    ``workers`` is the consumer-thread count (docs/DESIGN.md §8); per-batch
    classifications are reduced in segment order, so the result is
    bit-identical for any worker count.

    With ``flag_boundary=True`` (requires an engine with TT in its relation
    set, see :func:`boundary_vertices`) the counts gain a
    ``boundary_critical`` entry: non-regular vertices lying on the domain
    boundary, where the interior link classification is only approximate.

    ``shards`` validates against the data structure's
    :class:`~repro_torch.distributed.sharding.ShardPlan` (sharding is fixed
    at engine construction); on a sharded engine the batch stream aligns
    to shard boundaries and workers partition shard-affinely, both of which
    keep the result bit for bit (docs/DESIGN.md §9)."""
    plan = consume.shard_plan(ds, shards)
    sm = pre.smesh
    mode = consume.consumer_mode(ds, consumer)
    dev = ds.device
    tets_dev = torch.from_numpy(sm.tets.astype(np.int32)).to(dev)
    rank_dev = torch.from_numpy(np.asarray(rank)).to(dev)
    types = np.empty(sm.n_vertices, dtype=np.int32)
    cols = consume.degree_cols(pre, ("VV", "VT")) if mode == "device" else None
    batches = segment_batches(sm.n_segments, batch_segments, plan)
    shard_of = ((lambda i: plan.shard_of(batches[i][0]))
                if plan is not None else None)

    prefetch = None
    if lookahead_hint and hasattr(ds, "prefetch"):
        # dispatched for the worker's NEXT batch before it consumes the
        # current one, so the kernels execute behind the classification
        def prefetch(segs):
            ds.prefetch_many({"VV": segs, "VT": segs})

    if mode == "device":
        # device-resident arm: blocks go pool -> classify with no host
        # copy; batch k's types download only after batch k+1 is dispatched
        def consume_batch(i, segs):
            cb = ds.get_full_dev_many(("VV", "VT"), segs, cols=cols)
            t = _classify_batch(cb.M["VV"], cb.M["VT"], cb.gid_dev,
                                tets_dev, rank_dev,
                                deg_v=cb.width("VV"), deg_t=cb.width("VT"))
            return cb.gid, cb.n_rows, t
    else:
        def consume_batch(i, segs):
            vv = ds.get_batch("VV", segs)
            vt = ds.get_batch("VT", segs)
            deg_v = -32 * (-max(M.shape[1] for M, _ in vv) // 32)
            deg_t = -32 * (-max(M.shape[1] for M, _ in vt) // 32)

            rows = sum(M.shape[0] for M, _ in vv)
            rows_pad = ops.bucket_rows(rows)  # stable shapes, ragged tails
            vvM = np.full((rows_pad, deg_v), -1, dtype=np.int32)
            vtM = np.full((rows_pad, deg_t), -1, dtype=np.int32)
            gid = np.full(rows_pad, -1, dtype=np.int32)
            at = 0
            for s, (Mv, _), (Mt, _) in zip(segs, vv, vt):
                n = Mv.shape[0]
                vvM[at:at + n, :Mv.shape[1]] = Mv
                vtM[at:at + n, :Mt.shape[1]] = Mt
                gid[at:at + n] = np.arange(sm.I_V[s], sm.I_V[s] + n)
                at += n
            t = _classify_batch(torch.from_numpy(vvM).to(dev),
                                torch.from_numpy(vtM).to(dev),
                                torch.from_numpy(gid).to(dev), tets_dev,
                                rank_dev, deg_v=deg_v, deg_t=deg_t)
            return gid[:rows], rows, t

    def finalize(inter):
        gid, n, t = inter
        return gid, t[:n].cpu().numpy()

    def reduce_batch(i, res):
        gid, t = res
        types[gid] = t

    run_partitioned(batches, consume_batch, reduce_batch, workers=workers,
                    finalize=finalize, prefetch=prefetch, scope=ds,
                    name="critical_points", shard_of=shard_of)

    counts = {
        "minima": int((types == MINIMUM).sum()),
        "saddles1": int((types == SADDLE1).sum()),
        "saddles2": int((types == SADDLE2).sum()),
        "maxima": int((types == MAXIMUM).sum()),
        "degenerate": int((types == DEGENERATE).sum()),
        "regular": int((types == REGULAR).sum()),
    }
    if flag_boundary:
        on_bd = boundary_vertices(ds, pre, consumer=consumer,
                                  workers=workers, shards=shards)
        counts["boundary_critical"] = int((on_bd & (types != REGULAR)).sum())
    return types, counts
