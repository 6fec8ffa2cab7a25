"""Discrete gradient field via lower-star processing (Robins et al. [37],
the paper's 'DiscreteGradient' benchmark algorithm).

Every simplex belongs to exactly one lower star (that of its highest vertex
under the injective order), so vertices are processed independently — the
paper calls this embarrassingly parallel. Consumes the relations the paper
lists: coboundary **VE, VF, VT** through the data structure (offloaded) and
boundary **EV, FV, TV** (+FE/TF implicitly via slot matching) locally.

TTK's per-vertex priority-queue loop (PQzero/PQone) is kept algorithmically
identical but executed as a batch of independent state machines: each pass
of the loop performs one PQ operation for every vertex in the batch at
once, on the engine's device. The mixed-dimension lexicographic keys
(descending-sorted vertex ranks) reduce to a local dense rank per lower
star, so each PQ pop is an integer argmin.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.adjacency import complete_adjacency
from ..core.scheduler import run_partitioned, segment_batches
from ..kernels import ops
from . import consume

_BIG = int(np.iinfo(np.int32).max)

# the lower-star loop tests its "did any vertex act?" condition (a host
# sync) once every this many passes; a pass in which no vertex acts changes
# nothing, so the extra passes cannot change the result
_CHECK_EVERY = 4


@dataclasses.dataclass
class GradientField:
    """Global discrete gradient: pair arrows point facet -> cofacet."""
    pair_v2e: np.ndarray   # (nv,) edge gid paired with vertex, -1 if none
    pair_e2f: np.ndarray   # (ne,) face gid the edge points to, -1
    pair_f2t: np.ndarray   # (nf,) tet gid the face points to, -1
    # reverse maps (cofacet -> facet), derived, for path tracing
    pair_e2v: np.ndarray   # (ne,) vertex gid the edge is head of, -1
    pair_f2e: np.ndarray   # (nf,)
    pair_t2f: np.ndarray   # (nt,)
    crit_v: np.ndarray     # (nv,) bool
    crit_e: np.ndarray
    crit_f: np.ndarray
    crit_t: np.ndarray

    def counts(self) -> Dict[str, int]:
        return {"crit_v": int(self.crit_v.sum()),
                "crit_e": int(self.crit_e.sum()),
                "crit_f": int(self.crit_f.sum()),
                "crit_t": int(self.crit_t.sum())}

    def euler(self) -> int:
        c = self.counts()
        return c["crit_v"] - c["crit_e"] + c["crit_f"] - c["crit_t"]


def _first_true(mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first True along ``dim`` (0 when none): argmax over an
    integer view, which returns the first maximum."""
    return torch.argmax(mask.to(torch.uint8), dim=dim)


# contract: device-resident
def _lower_star_batch(
    ve_M, vf_M, vt_M,            # (B, de/df/dt) coboundary gids, -1 pad
    row_gid,                     # (B,) vertex gids, -1 pad
    E, F, T,                     # global boundary tables (device)
    rank,                        # (nv,) injective order
    de: int, df: int, dt: int,
):
    B = ve_M.shape[0]
    dev = ve_M.device
    big = _BIG
    # padding rows (gid -1) are discarded by the caller; clamp their index
    gid = row_gid.long()
    r_v = rank[gid.clamp(min=0)]

    # --- lower-star membership & "others" ----------------------------------
    ev = torch.where(ve_M[..., None] >= 0, E[ve_M.clamp(min=0).long()],
                     -1)                                            # (B,de,2)
    e_other = torch.where(ev[..., 0] == row_gid[:, None], ev[..., 1],
                          ev[..., 0])
    e_ok = (ve_M >= 0) & (rank[e_other.clamp(min=0).long()] < r_v[:, None])

    fv = torch.where(vf_M[..., None] >= 0, F[vf_M.clamp(min=0).long()],
                     -1)                                            # (B,df,3)

    def others(sv, keep):  # drop v's slot, keep ascending others
        key = torch.where((sv == row_gid[:, None, None]) | (sv < 0), big, sv)
        o = torch.sort(key, dim=-1).values[..., :keep]
        return torch.where(o == big, -1, o)

    f_oth = others(fv, 2)                                           # (B,df,2)
    f_lower = ((rank[f_oth.clamp(min=0).long()] < r_v[:, None, None])
               & (f_oth >= 0))
    f_ok = (vf_M >= 0) & f_lower.all(-1)

    tv = torch.where(vt_M[..., None] >= 0, T[vt_M.clamp(min=0).long()],
                     -1)                                            # (B,dt,4)
    t_oth = others(tv, 3)                                           # (B,dt,3)
    t_lower = ((rank[t_oth.clamp(min=0).long()] < r_v[:, None, None])
               & (t_oth >= 0))
    t_ok = (vt_M >= 0) & t_lower.all(-1)

    # --- facet slot matching ------------------------------------------------
    # face (v,a,b): facets in lower star = edge slots with other == a / b
    def match_edge(target):  # target (B, df) global vid -> edge slot or -1
        eq = (e_other[:, None, :] == target[..., None]) & e_ok[:, None, :]
        return torch.where(eq.any(-1), _first_true(eq), -1)

    none = torch.full((B, df), -1, dtype=torch.int64, device=dev)
    f_fac = torch.stack([match_edge(f_oth[..., 0]),
                         match_edge(f_oth[..., 1]), none], dim=-1)

    # tet (v,a,b,c): facets = face slots with others == each sorted pair
    def match_face(pa, pb):  # (B, dt) -> face slot
        eq = ((f_oth[:, None, :, 0] == pa[..., None])
              & (f_oth[:, None, :, 1] == pb[..., None])
              & f_ok[:, None, :])
        return torch.where(eq.any(-1), _first_true(eq) + de, -1)

    a, b, c = t_oth[..., 0], t_oth[..., 1], t_oth[..., 2]
    t_fac = torch.stack([match_face(a, b), match_face(a, c),
                         match_face(b, c)], dim=-1)

    # --- unified slot arrays: [edges | faces | tets] ------------------------
    N = de + df + dt
    exists = torch.cat([e_ok, f_ok, t_ok], dim=1)
    # facet slots (absolute), -1 pad; faces offset 0 (edges), tets offset de
    fac = torch.cat([torch.full((B, de, 3), -1, dtype=torch.int64,
                                device=dev), f_fac, t_fac], dim=1)

    # --- Robins keys: lexicographic on desc-sorted vertex ranks -------------
    # a *local* dense rank per lower star via an (N x N) pairwise comparison
    re_ = rank[e_other.clamp(min=0).long()] + 1
    rf = torch.sort(rank[f_oth.clamp(min=0).long()] + 1, dim=-1).values
    rt = torch.sort(rank[t_oth.clamp(min=0).long()] + 1, dim=-1).values
    zed = torch.zeros((B, de), dtype=rank.dtype, device=dev)
    k1 = torch.cat([re_, rf[..., 1], rt[..., 2]], dim=1)
    k2 = torch.cat([zed, rf[..., 0], rt[..., 1]], dim=1)
    k3 = torch.cat([zed, torch.zeros((B, df), dtype=rank.dtype, device=dev),
                    rt[..., 0]], dim=1)
    k1 = torch.where(exists, k1, big)
    k2 = torch.where(exists, k2, big)
    k3 = torch.where(exists, k3, big)

    a1, b1 = k1[:, :, None], k1[:, None, :]
    a2, b2 = k2[:, :, None], k2[:, None, :]
    a3, b3 = k3[:, :, None], k3[:, None, :]
    lt = ((b1 < a1) | ((b1 == a1) & (b2 < a2))
          | ((b1 == a1) & (b2 == a2) & (b3 < a3)))      # key_j < key_i
    key = lt.sum(-1)                                    # local dense rank
    key = torch.where(exists, key, big)
    key_e = torch.where(e_ok, key[:, :de], big)

    # --- init: pair v with its minimal lower edge ---------------------------
    rows = torch.arange(B, device=dev)
    has_edge = e_ok.any(-1)
    min_e = torch.argmin(torch.where(e_ok, key_e, _BIG), dim=-1)
    crit_vertex = ~has_edge
    processed = torch.zeros((B, N), dtype=torch.bool, device=dev)
    processed[rows, min_e] = has_edge
    pair = torch.full((B, N), -1, dtype=torch.int64, device=dev)
    pair[rows, min_e] = torch.where(has_edge, -2, -1)   # -2: paired with v
    crit = torch.zeros((B, N), dtype=torch.bool, device=dev)
    fac_ok = fac >= 0
    fac_idx = fac.clamp(min=0).reshape(B, -1)

    passes = 0
    while True:
        avail = exists & ~processed
        p = torch.gather(processed, 1, fac_idx).reshape(B, N, 3)
        un = fac_ok & ~p
        cnt = un.sum(-1)
        pq1 = avail & (cnt == 1)
        pq0 = avail & (cnt == 0)

        a1 = torch.argmin(torch.where(pq1, key, _BIG), dim=-1)
        a0 = torch.argmin(torch.where(pq0, key, _BIG), dim=-1)
        use1 = pq1.any(-1)
        use0 = ~use1 & pq0.any(-1)

        # pair α (cofacet) with its single unprocessed facet β
        un_a = un[rows, a1]                              # (B, 3)
        beta = fac[rows, a1, _first_true(un_a)]
        bc = beta.clamp(min=0)
        processed[rows, a1] = processed[rows, a1] | use1
        processed[rows, bc] = processed[rows, bc] | use1
        pair[rows, a1] = torch.where(use1, beta, pair[rows, a1])
        pair[rows, bc] = torch.where(use1, a1, pair[rows, bc])
        # or: pop PQzero as critical
        processed[rows, a0] = processed[rows, a0] | use0
        crit[rows, a0] = crit[rows, a0] | use0
        passes += 1
        if passes % _CHECK_EVERY == 0 and not bool((use1 | use0).any()):
            break

    return crit_vertex, min_e, has_edge, pair, crit, exists


def audit_gradient(ds, pre, grad: GradientField,
                   batch: int = 4096, workers: int = 1,
                   shards=None) -> Dict[str, int]:
    """Cross-segment audit of the discrete vector field's matching property.

    Lower stars partition the simplices, so pairing decisions made in
    different segments can never claim the same cell — this audit verifies
    that global invariant across segment boundaries using completed
    adjacency (``core/adjacency.py``), requested in pipelined batches:

    - ``tt_conflicts``: for every face->tet pair ``f -> t``, the *other*
      cofacet of ``f`` (t's completed-TT neighbour across ``f``) must not
      also be paired to ``f``.
    - ``ff_conflicts``: for every edge->face pair ``e -> f``, no other face
      containing ``e`` (an FF neighbour of ``f`` through ``e``) may claim
      ``e`` as its paired edge.
    - ``reverse_mismatch``: forward/reverse pair arrays must agree.

    Requires a data structure with engine-native completion for TT and FF
    (FF blocks come from the dense counts fallback: the meet kernel on a
    card). All counts are zero for a valid field. ``shards`` validates
    against the data structure's plan; the completion follows it."""
    consume.shard_plan(ds, shards)   # validate; completion follows ds's plan
    out = {"tt_conflicts": 0, "ff_conflicts": 0, "reverse_mismatch": 0}
    f_paired = np.nonzero(grad.pair_f2t >= 0)[0]
    out["reverse_mismatch"] += int(
        (grad.pair_t2f[grad.pair_f2t[f_paired]] != f_paired).sum())
    e_paired = np.nonzero(grad.pair_e2f >= 0)[0]
    out["reverse_mismatch"] += int(
        (grad.pair_f2e[grad.pair_e2f[e_paired]] != e_paired).sum())

    if len(f_paired):
        t = grad.pair_f2t[f_paired]
        M, _ = complete_adjacency(ds, "TT", t, batch=batch, workers=workers)
        deg = M.shape[1]
        tf_nb = ds.boundary_TF(np.maximum(M, 0).reshape(-1)) \
            .reshape(len(t), deg, 4)
        across = (tf_nb == f_paired[:, None, None]).any(-1) & (M >= 0)
        nb = np.where(across, M, -1)
        claimed = (nb >= 0) & (grad.pair_t2f[np.maximum(nb, 0)]
                               == f_paired[:, None])
        out["tt_conflicts"] = int(claimed.any(-1).sum())
    if len(e_paired):
        fh = grad.pair_e2f[e_paired]
        M, _ = complete_adjacency(ds, "FF", fh, batch=batch, workers=workers)
        deg = M.shape[1]
        fe_nb = ds.boundary_FE(np.maximum(M, 0).reshape(-1)) \
            .reshape(len(fh), deg, 3)
        through_e = (fe_nb == e_paired[:, None, None]).any(-1) & (M >= 0)
        nb = np.where(through_e, M, -1)
        claimed = (nb >= 0) & (grad.pair_f2e[np.maximum(nb, 0)]
                               == e_paired[:, None])
        out["ff_conflicts"] = int(claimed.any(-1).sum())
    return out


def _scatter_batch(g: GradientField, gid, veM, vfM, vtM,
                   crit_vx, min_e, has_edge, pair, crit,
                   de: int, df: int, dt: int) -> None:
    """Integrate one classified batch into the global gradient field (host
    numpy — the pipeline's final-assembly edge, shared bit-identically by
    the device and host consumer arms). All inputs are host arrays already
    sliced to the batch's real rows."""
    g.crit_v[gid] = crit_vx
    # v -> min edge arrows
    e_gid = np.take_along_axis(veM, min_e[:, None], 1)[:, 0]
    sel = has_edge
    g.pair_v2e[gid[sel]] = e_gid[sel]
    g.pair_e2v[e_gid[sel]] = gid[sel]
    # slot-level pairs/criticals
    slot_gid = np.concatenate([veM, vfM, vtM], axis=1)  # (B, N)
    crit_e_rows = crit[:, :de] & (veM >= 0)
    crit_f_rows = crit[:, de:de + df] & (vfM >= 0)
    crit_t_rows = crit[:, de + df:] & (vtM >= 0)
    g.crit_e[veM[crit_e_rows]] = True
    g.crit_f[vfM[crit_f_rows]] = True
    g.crit_t[vtM[crit_t_rows]] = True
    # face->edge pairs live in slots [de, de+df); a face slot's pair
    # value >= de means it was paired as the *facet of a tet* (recorded
    # via the tet side below), so only values < de are edge pairings.
    fslots = pair[:, de:de + df]
    selF = (fslots >= 0) & (fslots < de) & (vfM >= 0)
    if selF.any():
        rowsF, colsF = np.nonzero(selF)
        e_of = slot_gid[rowsF, fslots[rowsF, colsF]]
        f_of = vfM[rowsF, colsF]
        g.pair_e2f[e_of] = f_of
        g.pair_f2e[f_of] = e_of
    tslots = pair[:, de + df:]
    selT = (tslots >= 0) & (vtM >= 0)
    if selT.any():
        rowsT, colsT = np.nonzero(selT)
        f_of = slot_gid[rowsT, tslots[rowsT, colsT]]
        t_of = vtM[rowsT, colsT]
        g.pair_f2t[f_of] = t_of
        g.pair_t2f[t_of] = f_of


def _host(t: torch.Tensor, n: int) -> np.ndarray:
    return t[:n].cpu().numpy()


def _download_device_batch(cb, degs, out):
    """Download one device batch's results into the :func:`_scatter_batch`
    argument tuple (the device arm's host edge — the scheduler's finalize
    step); releasing ``cb`` afterwards frees its device buffers, so each
    worker retains at most one batch."""
    de, df, dt = degs
    crit_vx, min_e, has_edge, pair, crit, _ = out
    n = cb.n_rows
    return (cb.gid, _host(cb.M["VE"], n), _host(cb.M["VF"], n),
            _host(cb.M["VT"], n), _host(crit_vx, n), _host(min_e, n),
            _host(has_edge, n), _host(pair, n), _host(crit, n), de, df, dt)


def discrete_gradient(
    ds, pre, rank: np.ndarray, batch_segments: int = 8,
    audit: bool = False, consumer: str = "auto",
    co_prefetch: Tuple[str, ...] = (),
    workers: int = 1, shards=None,
) -> GradientField:
    """Drive the lower-star batches through the data structure (GALE queues
    VE/VF/VT — the paper's 3-queue configuration for this algorithm), on
    ``ds.device``.

    ``consumer`` selects the consumer arm (docs/DESIGN.md §6): ``"device"``
    feeds :func:`_lower_star_batch` straight from the engine's device block
    pool via :meth:`get_full_dev_many` (columns at the exact per-mesh degree
    bounds), ``"host"`` assembles the blocks of :meth:`get_batch` in numpy,
    ``"auto"`` picks "device" whenever ``ds`` exposes the batch API.
    Bit-identical either way.

    ``workers`` is the consumer-thread count (docs/DESIGN.md §8); per-batch
    results are scattered in segment order on the calling thread, so the
    field is bit-identical for any worker count.

    ``co_prefetch`` names extra engine relations to dispatch alongside each
    batch's VE/VF/VT prefetch: a driver that will consume completed TT
    right after the gradient (``morse_smale``) passes ``("TT",)`` so those
    kernels execute behind the lower-star state machines. Relations the
    data structure does not serve are ignored.

    ``audit=True`` runs :func:`audit_gradient` on the finished field and
    raises ``ValueError`` on any conflict.

    ``shards`` follows the engine's :class:`ShardPlan` (docs/DESIGN.md
    §9): segment batches restart at shard boundaries and workers are
    assigned shard-affinely, so each worker drives one shard's pipeline.
    The field stays bit-identical for any shard count."""
    plan = consume.shard_plan(ds, shards)
    sm = pre.smesh
    nv, nt = sm.n_vertices, sm.n_tets
    ne, nf = pre.n_edges, pre.n_faces
    mode = consume.consumer_mode(ds, consumer)
    dev = ds.device

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    E_dev = put(pre.E.astype(np.int32))
    F_dev = put(pre.F.astype(np.int32))
    T_dev = put(sm.tets.astype(np.int32))
    rank_dev = put(np.asarray(rank))
    rels = ("VE", "VF", "VT")
    cols = consume.degree_cols(pre, rels) if mode == "device" else None

    g = GradientField(
        pair_v2e=np.full(nv, -1, np.int64), pair_e2f=np.full(ne, -1, np.int64),
        pair_f2t=np.full(nf, -1, np.int64), pair_e2v=np.full(ne, -1, np.int64),
        pair_f2e=np.full(nf, -1, np.int64), pair_t2f=np.full(nt, -1, np.int64),
        crit_v=np.zeros(nv, bool), crit_e=np.zeros(ne, bool),
        crit_f=np.zeros(nf, bool), crit_t=np.zeros(nt, bool))

    extra = tuple(r for r in co_prefetch
                  if r in getattr(ds, "relations", co_prefetch))
    batches = segment_batches(sm.n_segments, batch_segments, plan)
    shard_of = ((lambda i: plan.shard_of(batches[i][0]))
                if plan is not None else None)

    prefetch = None
    if hasattr(ds, "prefetch"):
        # dispatched for the worker's next batch before it consumes the
        # current one: VE/VF/VT production (three kernels in flight
        # round-robin) plus any co_prefetch relations a later consumer will
        # need, all overlapping the lower-star state machines below
        def prefetch(segs):
            ds.prefetch_many({R: segs for R in rels + extra})

    if mode == "device":
        # device-resident arm: blocks go pool -> lower-star batch; batch
        # k's downloads happen only after batch k+1 is dispatched (the
        # scheduler's per-worker depth-1 double buffer)
        def consume_batch(i, segs):
            cb = ds.get_full_dev_many(rels, segs, cols=cols)
            de, df, dt = (cb.width(R) for R in rels)
            out = _lower_star_batch(
                cb.M["VE"], cb.M["VF"], cb.M["VT"], cb.gid_dev,
                E_dev, F_dev, T_dev, rank_dev, de=de, df=df, dt=dt)
            return cb, (de, df, dt), out

        def finalize(inter):
            return _download_device_batch(*inter)
    else:
        def consume_batch(i, segs):
            blocks = {R: ds.get_batch(R, segs) for R in rels}
            degs = {R: -32 * (-max(M.shape[1] for M, _ in blocks[R]) // 32)
                    for R in blocks}
            rows = sum(M.shape[0] for M, _ in blocks["VE"])
            rows_pad = ops.bucket_rows(rows)  # stable shapes, ragged tails
            stacked = {R: np.full((rows_pad, degs[R]), -1, np.int32)
                       for R in blocks}
            gid = np.full(rows_pad, -1, dtype=np.int32)
            at = 0
            for i_s, s in enumerate(segs):
                n = blocks["VE"][i_s][0].shape[0]
                for R in blocks:
                    M = blocks[R][i_s][0]
                    stacked[R][at:at + n, :M.shape[1]] = M
                gid[at:at + n] = np.arange(sm.I_V[s], sm.I_V[s] + n)
                at += n
            out = _lower_star_batch(
                put(stacked["VE"]), put(stacked["VF"]), put(stacked["VT"]),
                put(gid), E_dev, F_dev, T_dev, rank_dev,
                de=degs["VE"], df=degs["VF"], dt=degs["VT"])
            return gid, rows, stacked, degs, out

        def finalize(inter):
            gid, rows, stacked, degs, out = inter
            crit_vx, min_e, has_edge, pair, crit, _ = out
            return (gid[:rows], stacked["VE"][:rows], stacked["VF"][:rows],
                    stacked["VT"][:rows], _host(crit_vx, rows),
                    _host(min_e, rows), _host(has_edge, rows),
                    _host(pair, rows), _host(crit, rows),
                    degs["VE"], degs["VF"], degs["VT"])

    def reduce_batch(i, args):
        _scatter_batch(g, *args)

    run_partitioned(batches, consume_batch, reduce_batch, workers=workers,
                    finalize=finalize, prefetch=prefetch, scope=ds,
                    name="discrete_gradient", shard_of=shard_of)
    if audit:
        report = audit_gradient(ds, pre, g, workers=workers, shards=shards)
        if any(report.values()):
            raise ValueError(f"gradient matching audit failed: {report}")
    return g
