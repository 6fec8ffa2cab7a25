"""Persistence pairing of critical points over the discrete gradient, and
persistence-threshold simplification of the MS complex (docs/DESIGN.md §10).

The fourth driver through the consumer pipeline: after the gradient sweep
(``discrete_gradient`` — relations VE/VF/VT) the critical-cell connectivity
is assembled exactly like ``morse_smale``'s 1-skeleton — descending V-paths
by pointer jumping, ascending successors from completed TT adjacency
(``core/adjacency.py``) or the FT gather, the critical faces' cofacet rows
streamed in owner-segment batches through the consumer scheduler — so every
read goes through ``get_full_dev_many`` / ``complete_adjacency`` and
schedules against relation production like the paper's Fig. 10 workloads.

Pairing itself runs on the critical cells (hundreds, not millions):

  - **merge-tree union-find** (``method="pairing"``): 0-dimensional pairs
    (minimum, 1-saddle) from the sublevel merge tree over the critical
    vertex/edge graph, and (d-1)-dimensional pairs (2-saddle, maximum) from
    the dual split tree over the critical face/tet graph, both by the elder
    rule under the global simulation-of-simplicity order;
  - **matrix reduction** (``method="reduction"``): the standard boundary
    reduction over the same Morse-complex boundary columns in the same
    filtration order — an independent code path kept as the A/B oracle.
    The two arms are bit-identical (``PersistenceDiagram.digest()``) on
    every adversarial mesh family, and equal to the reference package's.

Ascending V-paths that exit through the mesh boundary (``dest_max == -1``)
merge with a *virtual boundary node* that is elder than every maximum and
never dies — the convention both arms share, so the A/B stays exact on
meshes with boundary.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Tuple

import numpy as np

from .discrete_gradient import GradientField, discrete_gradient
from .morse_smale import (MSComplex, _ascending_successors_tt, _cofacet_rows,
                          _gather_ft, _jump_host, _supports_completion)
from . import consume

# the paper's 5-queue configuration for a persistence-grade consumer:
# VE/VF/VT for the gradient sweep, FT/TT for the ascending connectivity
PD_RELS = ("VE", "VF", "VT", "FT", "TT")


@dataclasses.dataclass
class PersistenceDiagram:
    """Persistence pairs of the sublevel filtration, by dimension.

    ``pairs0`` rows are ``[minimum vertex gid, 1-saddle edge gid]`` with
    birth/death VALUES in ``births0``/``deaths0`` (death = the saddle
    edge's lower-star value). ``pairs2`` rows are ``[2-saddle face gid,
    maximum tet gid]`` from the dual (superlevel) tree: ``births2`` is the
    maximum's value, ``deaths2`` the saddle face's, so persistence is
    ``births2 - deaths2``. ``essential0`` holds the never-dying minima (one
    per mesh component — β₀), ``essential2`` the never-dying maxima.
    ``unpaired1`` / ``unpaired2`` are saddles whose Morse boundary
    vanished (both V-path ends in the same class — births of
    1-dimensional classes, not paired by this driver).

    ``merge_into0`` / ``merge_into2`` record, per pair, the surviving
    extremum at merge time — the merge-tree ancestry
    :func:`simplify_ms` relabels basins through. Only the union-find arm
    produces it (the reduction oracle leaves -1), so it is excluded from
    :meth:`digest`, which covers every filtration-determined field and is
    the bit-identity witness across methods, consumer arms, worker counts,
    and the two packages."""
    method: str
    pairs0: np.ndarray       # (n0, 2) int64
    births0: np.ndarray      # (n0,) float64
    deaths0: np.ndarray      # (n0,) float64
    merge_into0: np.ndarray  # (n0,) int64, -1 on the reduction arm
    essential0: np.ndarray   # (b0,) int64 minimum gids
    unpaired1: np.ndarray    # (u1,) int64 saddle edge gids
    pairs2: np.ndarray       # (n2, 2) int64
    births2: np.ndarray      # (n2,) float64
    deaths2: np.ndarray      # (n2,) float64
    merge_into2: np.ndarray  # (n2,) int64
    essential2: np.ndarray   # (b2,) int64 maximum tet gids
    unpaired2: np.ndarray    # (u2,) int64 saddle face gids

    def persistence0(self) -> np.ndarray:
        return self.deaths0 - self.births0

    def persistence2(self) -> np.ndarray:
        return self.births2 - self.deaths2

    def counts(self) -> Dict[str, int]:
        return {"pairs0": len(self.pairs0), "pairs2": len(self.pairs2),
                "essential0": len(self.essential0),
                "essential2": len(self.essential2),
                "unpaired1": len(self.unpaired1),
                "unpaired2": len(self.unpaired2)}

    def digest(self) -> str:
        h = hashlib.sha1()
        for a in (self.pairs0, self.births0, self.deaths0, self.essential0,
                  self.unpaired1, self.pairs2, self.births2, self.deaths2,
                  self.essential2, self.unpaired2):
            h.update(np.ascontiguousarray(a).tobytes())
            h.update(b"|")
        return h.hexdigest()


# ---------------------------------------------------------------------------
# pairing arms: union-find merge forest vs boundary-matrix reduction
# ---------------------------------------------------------------------------

def _merge_forest(n_nodes: int, node_key: np.ndarray, ends: np.ndarray,
                  order: np.ndarray, sad_idx_virtual: bool):
    """Elder-rule union-find over the critical graph. ``node_key`` is
    (n, 2) int64 with lexicographically smaller = elder (born earlier);
    ``ends`` holds node INDICES (or -1 for the virtual boundary node, only
    with ``sad_idx_virtual``); ``order`` is the saddle filtration order.
    Returns (paired node idx, paired saddle positions, merged-into node
    idx, unpaired saddle positions, essential node idx)."""
    VIRT = n_nodes
    parent = np.arange(n_nodes + 1)
    rep = np.arange(n_nodes + 1)   # elder (birth) node of each root's class

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return int(i)

    def elder(a, b):               # node index a born before node index b?
        if a == VIRT or b == VIRT:
            return a == VIRT
        return (node_key[a, 0], node_key[a, 1]) \
            < (node_key[b, 0], node_key[b, 1])

    p_node, p_sad, m_into, unpaired = [], [], [], []
    for t in order:
        e0, e1 = int(ends[t, 0]), int(ends[t, 1])
        if (e0 < 0 or e1 < 0) and not sad_idx_virtual:
            raise ValueError("unresolved saddle end without a virtual node")
        a = find(e0 if e0 >= 0 else VIRT)
        b = find(e1 if e1 >= 0 else VIRT)
        if a == b:
            unpaired.append(int(t))
            continue
        ra, rb = rep[a], rep[b]
        if elder(rb, ra):
            a, b, ra, rb = b, a, rb, ra
        # the younger class (birth node rb) dies at this saddle
        p_node.append(int(rb))
        p_sad.append(int(t))
        m_into.append(int(ra))
        parent[b] = a              # rep[a] stays ra — the elder survives
    essential = sorted(set(range(n_nodes)) - set(p_node))
    return p_node, p_sad, m_into, unpaired, essential


def _reduce_pairs(n_nodes: int, node_key: np.ndarray, ends: np.ndarray,
                  order: np.ndarray, sad_idx_virtual: bool):
    """Standard persistence matrix reduction over the same Morse boundary:
    rows are nodes in birth order (virtual node first when present),
    columns the saddles in filtration order with ∂ = {end0, end1} over
    Z/2; reduce by lowest-one collisions. Independent of the union-find
    arm but provably — and here bit-for-bit testably — the same pairing."""
    VIRT = n_nodes
    perm = np.lexsort((node_key[:, 1], node_key[:, 0])) if n_nodes else \
        np.zeros(0, np.int64)
    off = 1 if sad_idx_virtual else 0
    row_of = np.empty(n_nodes + 1, np.int64)
    row_of[perm] = np.arange(n_nodes) + off
    row_of[VIRT] = 0
    node_at = np.empty(n_nodes + off, np.int64)
    node_at[np.arange(n_nodes) + off] = perm
    if sad_idx_virtual:
        node_at[0] = VIRT

    low_of = {}                    # lowest row -> reduced column (set of rows)
    p_node, p_sad, unpaired = [], [], []
    for t in order:
        e0, e1 = int(ends[t, 0]), int(ends[t, 1])
        if (e0 < 0 or e1 < 0) and not sad_idx_virtual:
            raise ValueError("unresolved saddle end without a virtual node")
        r0 = int(row_of[e0 if e0 >= 0 else VIRT])
        r1 = int(row_of[e1 if e1 >= 0 else VIRT])
        col = set() if r0 == r1 else {r0, r1}
        while col:
            lo = max(col)
            if lo not in low_of:
                break
            col = col ^ low_of[lo]
        if not col:
            unpaired.append(int(t))
            continue
        lo = max(col)
        low_of[lo] = col
        p_node.append(int(node_at[lo]))
        p_sad.append(int(t))
    essential = sorted(i for i in range(n_nodes)
                       if int(row_of[i]) not in low_of)
    m_into = [-1] * len(p_node)
    return p_node, p_sad, m_into, unpaired, essential


_ARMS = {"pairing": _merge_forest, "reduction": _reduce_pairs}


# ---------------------------------------------------------------------------
# connectivity assembly (the driver's engine-consuming stage)
# ---------------------------------------------------------------------------

def _connectivity(ds, pre, grad: GradientField, batch_segments: int,
                  adjacency: str, mode: str, workers: int, plan):
    """V-path destinations + critical-face cofacets, scheduled exactly like
    ``morse_smale``: completed-TT successors / targeted FT rows on engines,
    the whole-mesh FT gather on the baselines — bit-identical arms."""
    sm = pre.smesh
    nv, nt = sm.n_vertices, sm.n_tets
    E = pre.E
    use_tt = adjacency == "tt" or (
        adjacency == "auto" and _supports_completion(ds, "TT", "FT"))

    e = grad.pair_v2e
    other = np.where(e >= 0,
                     np.where(E[np.maximum(e, 0), 0] == np.arange(nv),
                              E[np.maximum(e, 0), 1],
                              E[np.maximum(e, 0), 0]),
                     np.arange(nv))
    dest_min = _jump_host(other, ds.device)

    s2 = np.nonzero(grad.crit_f)[0]
    if use_tt:
        succ_t = _ascending_successors_tt(ds, pre, grad,
                                          batch=64 * batch_segments,
                                          mode=mode, workers=workers)
        cof_s2 = _cofacet_rows(ds, pre, s2, batch_segments, mode=mode,
                               workers=workers, plan=plan)
    else:
        ft = _gather_ft(ds, pre, batch_segments, workers=workers, plan=plan)
        f = grad.pair_t2f
        cof0 = ft[np.maximum(f, 0), 0]
        cof1 = ft[np.maximum(f, 0), 1]
        me = np.arange(nt)
        nxt = np.where(cof0 == me, cof1, cof0)
        succ_t = np.where((f >= 0) & (nxt >= 0), nxt, me)
        cof_s2 = ft[s2]
    dest_t = _jump_host(succ_t, ds.device)
    dest_max = np.where(grad.crit_t[dest_t], dest_t, -1)
    s1 = np.nonzero(grad.crit_e)[0]
    return dest_min, dest_max, cof_s2, s1, s2


def _cell_values(scal: np.ndarray, cells: np.ndarray) -> np.ndarray:
    """Lower-star filtration value of simplices given their vertex rows."""
    if len(cells) == 0:
        return np.zeros(0, np.float64)
    return scal[cells].max(axis=1)


def persistence_pairs(
    ds, pre, rank: np.ndarray, scalars=None, *,
    grad: GradientField = None, method: str = "pairing",
    batch_segments: int = 16, adjacency: str = "auto",
    consumer: str = "auto", workers: int = 1, shards=None,
) -> PersistenceDiagram:
    """Pair the critical points of the discrete gradient by persistence.

    The fourth algorithm driver (docs/DESIGN.md §10): computes the gradient
    when ``grad`` is not supplied (``discrete_gradient`` with TT/FT
    co-prefetch so completion kernels hide behind the lower-star state
    machines), assembles the critical-cell connectivity through the same
    engine-scheduled reads as ``morse_smale`` (completed TT, owner-batched
    FT rows via the consumer scheduler), then pairs:

      - 0-dimensional (minimum, 1-saddle) pairs from the sublevel merge
        tree of the critical vertex/edge graph,
      - (d-1)-dimensional (2-saddle, maximum) pairs from the dual split
        tree of the critical face/tet graph (ascending ends that exit the
        boundary merge with a virtual, never-dying boundary node).

    ``method="pairing"`` is the union-find merge-forest arm (also records
    the merge ancestry :func:`simplify_ms` consumes); ``"reduction"`` is
    the boundary-matrix oracle. ``consumer`` / ``workers`` / ``shards``
    follow the shared driver contract (docs/DESIGN.md §6/§8/§9): the
    diagram is bit-identical (equal :meth:`~PersistenceDiagram.digest`)
    for every method, consumer arm, worker count and shard plan."""
    if method not in _ARMS:
        raise ValueError(f"method must be pairing/reduction, got {method!r}")
    mode = consume.consumer_mode(ds, consumer)
    plan = consume.shard_plan(ds, shards)
    sm = pre.smesh
    scal = np.asarray(sm.scalars if scalars is None else scalars, np.float64)
    rank = np.asarray(rank, np.int64)
    if grad is None:
        co = tuple(r for r in ("TT", "FT")
                   if r in getattr(ds, "relations", ()))
        grad = discrete_gradient(ds, pre, rank, batch_segments=batch_segments,
                                 consumer=consumer, co_prefetch=co,
                                 workers=workers, shards=shards)
    dest_min, dest_max, cof_s2, s1, s2 = _connectivity(
        ds, pre, grad, batch_segments, adjacency, mode, workers, plan)
    arm = _ARMS[method]
    E, F, T = pre.E, pre.F, sm.tets

    # ---- dim 0: sublevel merge tree over (minima, critical edges) ----------
    mins = np.nonzero(grad.crit_v)[0]
    key0 = np.stack([rank[mins], mins], axis=1) if len(mins) else \
        np.zeros((0, 2), np.int64)
    if len(s1):
        ends0 = np.stack([np.searchsorted(mins, dest_min[E[s1, 0]]),
                          np.searchsorted(mins, dest_min[E[s1, 1]])], axis=1)
        r_e = rank[E[s1]]
        order0 = np.lexsort((s1, r_e.min(1), r_e.max(1)))
    else:
        ends0 = np.zeros((0, 2), np.int64)
        order0 = np.zeros(0, np.int64)
    p_node, p_sad, m_into, unp, ess = arm(len(mins), key0, ends0, order0,
                                          sad_idx_virtual=False)
    pairs0 = np.stack([mins[p_node], s1[p_sad]], axis=1).astype(np.int64) \
        if p_node else np.zeros((0, 2), np.int64)
    births0 = scal[pairs0[:, 0]] if len(pairs0) else np.zeros(0, np.float64)
    deaths0 = _cell_values(scal, E[pairs0[:, 1]]) if len(pairs0) \
        else np.zeros(0, np.float64)
    merge_into0 = (np.asarray([mins[i] if i >= 0 else -1 for i in m_into],
                              np.int64) if m_into else np.zeros(0, np.int64))
    essential0 = mins[ess].astype(np.int64) if ess else np.zeros(0, np.int64)
    unpaired1 = np.sort(s1[unp]).astype(np.int64) if unp \
        else np.zeros(0, np.int64)

    # ---- dim d-1: dual split tree over (maxima, critical faces) ------------
    maxs = np.nonzero(grad.crit_t)[0]
    # smaller key = elder: in the descending (superlevel) filtration the
    # elder class is the HIGHER maximum, so negate the top-vertex rank
    key2 = np.stack([-rank[T[maxs]].max(1), maxs], axis=1) if len(maxs) \
        else np.zeros((0, 2), np.int64)
    if len(s2):
        c0, c1 = cof_s2[:, 0], cof_s2[:, 1]
        m0 = np.where(c0 >= 0, dest_max[np.maximum(c0, 0)], -1)
        m1 = np.where(c1 >= 0, dest_max[np.maximum(c1, 0)], -1)
        ends2 = np.stack([
            np.where(m0 >= 0, np.searchsorted(maxs, np.maximum(m0, 0)), -1),
            np.where(m1 >= 0, np.searchsorted(maxs, np.maximum(m1, 0)), -1),
        ], axis=1)
        rf = np.sort(rank[F[s2]], axis=1)
        order2 = np.lexsort((s2, rf[:, 0], rf[:, 1], rf[:, 2]))[::-1]
    else:
        ends2 = np.zeros((0, 2), np.int64)
        order2 = np.zeros(0, np.int64)
    p_node, p_sad, m_into, unp, ess = arm(len(maxs), key2, ends2, order2,
                                          sad_idx_virtual=True)
    pairs2 = np.stack([s2[p_sad], maxs[p_node]], axis=1).astype(np.int64) \
        if p_node else np.zeros((0, 2), np.int64)
    births2 = _cell_values(scal, T[pairs2[:, 1]]) if len(pairs2) \
        else np.zeros(0, np.float64)
    deaths2 = _cell_values(scal, F[pairs2[:, 0]]) if len(pairs2) \
        else np.zeros(0, np.float64)
    # merging into the virtual boundary node (index n_maxima) records -1:
    # the cancelled basin drains through the boundary, like dest_max == -1
    merge_into2 = (np.asarray([maxs[i] if 0 <= i < len(maxs) else -1
                               for i in m_into],
                              np.int64) if m_into else np.zeros(0, np.int64))
    essential2 = maxs[ess].astype(np.int64) if ess else np.zeros(0, np.int64)
    unpaired2 = np.sort(s2[unp]).astype(np.int64) if unp \
        else np.zeros(0, np.int64)

    return PersistenceDiagram(
        method=method,
        pairs0=pairs0, births0=births0, deaths0=deaths0,
        merge_into0=merge_into0, essential0=essential0, unpaired1=unpaired1,
        pairs2=pairs2, births2=births2, deaths2=deaths2,
        merge_into2=merge_into2, essential2=essential2, unpaired2=unpaired2)


# ---------------------------------------------------------------------------
# persistence-threshold simplification of the MS complex
# ---------------------------------------------------------------------------

def _resolve_targets(killed: np.ndarray, into: np.ndarray,
                     cancel: np.ndarray) -> Dict[int, int]:
    """Cancelled extremum gid -> surviving extremum gid, resolving chains
    (the merge partner may itself be cancelled at a later death)."""
    parent = {int(g): int(t)
              for g, t, c in zip(killed, into, cancel) if c}
    out: Dict[int, int] = {}
    for g0 in parent:
        chain, g = [], g0
        while g in parent and g not in out:
            chain.append(g)
            g = parent[g]
        g = out.get(g, g)
        for s in chain:
            out[s] = g
    return out

def _apply_targets(arr: np.ndarray, mapping: Dict[int, int]) -> np.ndarray:
    out = np.asarray(arr, np.int64).copy()
    if not mapping or out.size == 0:
        return out
    lut = np.arange(int(out.max()) + 1, dtype=np.int64)
    for k, v in mapping.items():
        if k < len(lut):
            lut[k] = v
    mask = out >= 0
    out[mask] = lut[out[mask]]
    return out


def simplify_ms(ms: MSComplex, diagram: PersistenceDiagram,
                threshold: float) -> Tuple[MSComplex, Dict[str, int]]:
    """Cancel every pair with persistence below ``threshold`` and relabel
    the MS complex accordingly (docs/DESIGN.md §10).

    Each cancelled minimum's basin is merged into the basin it joined in
    the merge tree (``merge_into0`` at death time, chains resolved), and
    dually for maxima; separatrix rows whose saddle died in a cancelled
    pair are dropped, surviving rows are relabelled. Essential extrema
    (infinite persistence) are never cancelled.

    Simplification invariant (checked by the tests): the
    surviving minima are exactly ``{pairs0 with persistence >= threshold}
    ∪ essential0`` — every vertex maps to one of them — and symmetrically
    for maxima (with -1 preserved where ascending paths left the mesh).

    Requires a ``method="pairing"`` diagram (the reduction oracle does not
    record merge ancestry)."""
    if diagram.method != "pairing":
        raise ValueError(
            "simplify_ms needs the merge ancestry only method='pairing' "
            f"records; got a {diagram.method!r} diagram")
    thr = float(threshold)
    cancel0 = diagram.persistence0() < thr
    cancel2 = diagram.persistence2() < thr
    map0 = _resolve_targets(diagram.pairs0[:, 0], diagram.merge_into0,
                            cancel0)
    map2 = _resolve_targets(diagram.pairs2[:, 1], diagram.merge_into2,
                            cancel2)
    dest_min = _apply_targets(ms.dest_min, map0)
    dest_max = _apply_targets(ms.dest_max, map2)

    dead1 = set(int(e) for e in diagram.pairs0[cancel0, 1])
    keep1 = np.asarray([int(r[0]) not in dead1 for r in ms.saddle1_ends],
                       bool) if len(ms.saddle1_ends) else np.zeros(0, bool)
    ends1 = ms.saddle1_ends[keep1].copy() if len(ms.saddle1_ends) \
        else ms.saddle1_ends.copy()
    if len(ends1):
        ends1[:, 1:] = _apply_targets(ends1[:, 1:], map0)

    dead2 = set(int(f) for f in diagram.pairs2[cancel2, 0])
    keep2 = np.asarray([int(r[0]) not in dead2 for r in ms.saddle2_ends],
                       bool) if len(ms.saddle2_ends) else np.zeros(0, bool)
    ends2 = ms.saddle2_ends[keep2].copy() if len(ms.saddle2_ends) \
        else ms.saddle2_ends.copy()
    if len(ends2):
        ends2[:, 1:] = _apply_targets(ends2[:, 1:], map2)

    simplified = MSComplex(dest_min=dest_min, dest_max=dest_max,
                           saddle1_ends=ends1, saddle2_ends=ends2)
    report = {
        "threshold": thr,
        "cancelled0": int(cancel0.sum()), "cancelled2": int(cancel2.sum()),
        "minima_before": int(len(np.unique(ms.dest_min))),
        "minima_after": int(len(np.unique(dest_min))),
        "maxima_before": int(len(np.unique(ms.dest_max[ms.dest_max >= 0]))),
        "maxima_after": int(len(np.unique(dest_max[dest_max >= 0]))),
    }
    return simplified, report
