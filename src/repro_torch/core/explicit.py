"""The data structures GALE is compared with (paper §5.2).

  - :class:`ExplicitTriangulation`: a *global* structure that precomputes
    and stores every requested topological relation at initialization
    (TTK's explicit triangulation). Built in vectorized numpy on the host,
    as the reference builds it: its build time is the baseline's init
    time. It doubles as the brute-force oracle the tests hold the engine
    against.
  - :class:`TopoClusterDS` and :class:`ActopoDS`: the localized baselines,
    wrappers over the port's :class:`~repro_torch.core.engine.RelationEngine`
    with one segment a launch and every launch synced right after dispatch
    (``async_dispatch=False``), with no lookahead and an 8-segment cache
    (TopoCluster) or lookahead 8 and a 512-segment cache (ACTOPO).

Relations are stored as padded ``(n, deg)`` global-id arrays with ``-1``
padding plus a count vector — the same ``(M, L)`` format the engine emits.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from .engine import ConsumerBatch, RelationEngine, StatsHost
from .mesh import (_EDGE_COMBOS, _FACE_COMBOS, edge_lookup, enumerate_edges,
                   face_lookup)
from .segtables import Preconditioned


def _invert_to_padded(src_ids: np.ndarray, dst_ids: np.ndarray, n_src: int,
                      deg: Optional[int] = None):
    """Group dst_ids by src_ids into a padded (n_src, deg) array (rows sorted
    ascending)."""
    order = np.lexsort((dst_ids, src_ids))
    s, d = src_ids[order], dst_ids[order]
    counts = np.bincount(s, minlength=n_src)
    width = int(counts.max()) if len(counts) and counts.max() > 0 else 1
    deg = width if deg is None else max(deg, width)
    M = np.full((n_src, deg), -1, dtype=np.int64)
    offsets = np.zeros(n_src + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    pos = np.arange(len(s)) - offsets[s]
    M[s, pos] = d
    return M, counts.astype(np.int32)


def _pairs_within_rows(M: np.ndarray, n: int):
    """Sorted unique ``src * n + dst`` keys of every ordered pair of
    distinct valid entries sharing a row of ``M`` (-1 padded)."""
    pairs_src, pairs_dst = [], []
    for col in range(M.shape[1]):
        a = M[:, col]
        ok = a >= 0
        for col2 in range(M.shape[1]):
            b = M[:, col2]
            sel = ok & (b >= 0) & (a != b)
            pairs_src.append(a[sel])
            pairs_dst.append(b[sel])
    src = np.concatenate(pairs_src)
    dst = np.concatenate(pairs_dst)
    return np.unique(src * np.int64(n) + dst)


class ExplicitTriangulation(StatsHost):
    """Precompute-everything baseline. ``relations`` limits what gets built
    (so init time and memory reflect the algorithm's needs, as in TTK).

    Queries are read-only over tables frozen at init, so concurrent
    consumer threads (``core/scheduler.py``) are safe; the only mutable
    state is the stats, which go through the thread-safe
    :class:`StatsHost` accounting shared with the engine.

    ``device`` (``cuda`` unless the caller asks for another; a missing card
    raises) is where :meth:`get_full_dev_many` puts its consumer batches,
    and so where the device-resident drivers run."""

    def __init__(self, pre: Preconditioned, relations: Sequence[str],
                 device=None):
        self.device = ops.resolve_device(device)
        self.pre = pre
        self.smesh = pre.smesh
        self.rel: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        # RelationEngine-compatible surface so the cross-segment completion
        # pipeline (core/adjacency.py, host path) and its consumers accept
        # the explicit baseline: stats / deg / the built relation set.
        self.relations = tuple(relations)
        self._init_stats()   # stats + per-worker breakdown + lock
        self.deg = dict(ops.DEFAULT_DEG)
        t0 = time.perf_counter()
        for r in relations:
            self._build(r)
        self.init_time = time.perf_counter() - t0

    # -- construction ---------------------------------------------------------

    def _tet_edges(self) -> np.ndarray:
        T, nv = self.smesh.tets, self.smesh.n_vertices
        return np.stack(
            [edge_lookup(self.pre.E_keys, nv, T[:, a], T[:, b])
             for a, b in _EDGE_COMBOS], axis=1)  # (nt, 6)

    def _tet_faces(self) -> np.ndarray:
        T, nv = self.smesh.tets, self.smesh.n_vertices
        return np.stack(
            [face_lookup(self.pre.F_keys, nv, T[:, a], T[:, b], T[:, c])
             for a, b, c in _FACE_COMBOS], axis=1)  # (nt, 4)

    def _face_edges(self) -> np.ndarray:
        F, nv = self.pre.F, self.smesh.n_vertices
        return np.stack(
            [edge_lookup(self.pre.E_keys, nv, F[:, 0], F[:, 1]),
             edge_lookup(self.pre.E_keys, nv, F[:, 0], F[:, 2]),
             edge_lookup(self.pre.E_keys, nv, F[:, 1], F[:, 2])], axis=1)

    def _build(self, r: str) -> None:
        if r in self.rel:
            return
        sm, pre = self.smesh, self.pre
        nv, nt = sm.n_vertices, sm.n_tets
        T = sm.tets
        if r == "VT":
            dst = np.repeat(np.arange(nt, dtype=np.int64), 4)
            self.rel[r] = _invert_to_padded(T.reshape(-1), dst, nv)
        elif r == "VE":
            E = pre.E
            dst = np.repeat(np.arange(len(E), dtype=np.int64), 2)
            self.rel[r] = _invert_to_padded(E.reshape(-1), dst, nv)
        elif r == "VF":
            F = pre.F
            dst = np.repeat(np.arange(len(F), dtype=np.int64), 3)
            self.rel[r] = _invert_to_padded(F.reshape(-1), dst, nv)
        elif r == "VV":
            # VV alone does not precondition the edge table
            E = pre.E if pre.E is not None else enumerate_edges(T, nv)[0]
            src = np.concatenate([E[:, 0], E[:, 1]])
            dst = np.concatenate([E[:, 1], E[:, 0]])
            self.rel[r] = _invert_to_padded(src, dst, nv)
        elif r == "ET":
            dst = np.repeat(np.arange(nt, dtype=np.int64), 6)
            self.rel[r] = _invert_to_padded(self._tet_edges().reshape(-1),
                                            dst, len(pre.E))
        elif r == "FT":
            dst = np.repeat(np.arange(nt, dtype=np.int64), 4)
            self.rel[r] = _invert_to_padded(self._tet_faces().reshape(-1),
                                            dst, len(pre.F))
        elif r == "EF":
            dst = np.repeat(np.arange(len(pre.F), dtype=np.int64), 3)
            self.rel[r] = _invert_to_padded(self._face_edges().reshape(-1),
                                            dst, len(pre.E))
        elif r == "TT":
            self._build("FT")
            M, L = self.rel["FT"]
            both = M[L == 2]  # interior faces: exactly two cofacet tets
            src = np.concatenate([both[:, 0], both[:, 1]])
            dst = np.concatenate([both[:, 1], both[:, 0]])
            self.rel[r] = _invert_to_padded(src, dst, nt)
        elif r == "EE":      # edges sharing a vertex
            ne = len(pre.E)
            self._build("VE")
            key = _pairs_within_rows(self.rel["VE"][0], ne)
            self.rel[r] = _invert_to_padded(key // ne, key % ne, ne)
        elif r == "FF":      # faces sharing an edge
            nf = len(pre.F)
            self._build("EF")
            key = _pairs_within_rows(self.rel["EF"][0], nf)
            self.rel[r] = _invert_to_padded(key // nf, key % nf, nf)
        elif r in ("EV", "FV", "TV", "FE", "TE", "TF"):
            pass  # boundary relations answered directly below
        else:
            raise KeyError(r)
        if r in self.rel:
            # a global structure never truncates: widen the nominal relation
            # width to the actually built one (completion gathers rely on it)
            self.deg[r] = max(self.deg.get(r, 1), self.rel[r][0].shape[1])

    # -- query API (matches RelationEngine semantics) -------------------------

    def get(self, relation: str, segment: int) -> Tuple[np.ndarray, np.ndarray]:
        iv = self.pre.interval(relation[0])
        lo, hi = int(iv[segment]), int(iv[segment + 1])
        M, L = self.rel[relation]
        return M[lo:hi], L[lo:hi]

    def get_batch(self, relation: str, segments):
        return [self.get(relation, s) for s in segments]

    def get_full(self, relation: str, segment: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Full block of a segment. A global structure has no external rows
        — every global row is already complete — so this is :meth:`get`;
        the row indices are exactly what :meth:`local_rows` yields."""
        return self.get(relation, segment)

    def local_rows(self, kind: str, segs: np.ndarray,
                   gids: np.ndarray) -> np.ndarray:
        """``(segment, global id) -> block row`` for the explicit layout:
        a simplex appears only in its owner segment's block (at
        ``gid - interval[kind][segment]``); ``-1`` elsewhere. Rows are
        already complete, so cross-segment completion consults exactly one
        block per query and the union is the identity."""
        iv = self.pre.interval(kind)
        segs = np.asarray(segs, dtype=np.int64)
        gids = np.asarray(gids, dtype=np.int64)
        lo = iv[segs]
        owned = (gids >= lo) & (gids < iv[segs + 1])
        return np.where(owned, gids - lo, -1).astype(np.int32)

    def get_full_dev_many(self, relations, segments, cols=None
                          ) -> ConsumerBatch:
        """Same device-batch consumer API as
        :meth:`RelationEngine.get_full_dev_many`, so the device-resident
        drivers compare with the baseline like for like. A global
        structure's rows are already the concatenated internal rows in
        global-id order, so the batch is one contiguous slice per relation,
        uploaded to ``self.device`` once per call (counted as
        ``devpool_uploads`` — the explicit baseline has no producer
        launches to keep resident)."""
        relations = tuple(relations)
        kind = relations[0][0]       # subject kind ("VV" subjects are V)
        segments = [int(s) for s in segments]
        iv = self.pre.interval(kind)
        parts = [np.arange(iv[s], iv[s + 1]) for s in segments]
        gid = (np.concatenate(parts) if parts
               else np.zeros(0, dtype=np.int64))
        n_rows = len(gid)
        rows_pad = ops.bucket_rows(n_rows)
        gid_pad = np.full(rows_pad, -1, dtype=np.int32)
        gid_pad[:n_rows] = gid
        put = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        M, L = {}, {}
        for r in relations:
            Mg, Lg = self.rel[r]
            w = Mg.shape[1]
            if cols and r in cols:
                w = min(w, max(int(cols[r]), 1))
            Mp = np.full((rows_pad, w), -1, dtype=np.int32)
            Lp = np.zeros(rows_pad, dtype=np.int32)
            Mp[:n_rows] = Mg[gid, :w]
            Lp[:n_rows] = np.minimum(Lg[gid], w)
            M[r], L[r] = put(Mp), put(Lp)
            self.stat_bump(requests=len(segments),
                           devpool_uploads=len(segments))
        return ConsumerBatch(kind=kind, segments=tuple(segments),
                             n_rows=n_rows, gid=gid, gid_dev=put(gid_pad),
                             M=M, L=L)

    def prefetch(self, relation, segments) -> None:
        pass  # everything is precomputed

    def prefetch_many(self, requests) -> None:
        pass

    # boundary relations: the same host-side lookups as the engine (§4.4)

    def boundary_EV(self, edge_ids) -> np.ndarray:
        return self.pre.E[np.asarray(edge_ids)]

    def boundary_FV(self, face_ids) -> np.ndarray:
        return self.pre.F[np.asarray(face_ids)]

    def boundary_TV(self, tet_ids) -> np.ndarray:
        return self.smesh.tets[np.asarray(tet_ids)]

    def boundary_FE(self, face_ids) -> np.ndarray:
        F = self.pre.F[np.asarray(face_ids)]
        nv = self.smesh.n_vertices
        return np.stack(
            [edge_lookup(self.pre.E_keys, nv, F[:, 0], F[:, 1]),
             edge_lookup(self.pre.E_keys, nv, F[:, 0], F[:, 2]),
             edge_lookup(self.pre.E_keys, nv, F[:, 1], F[:, 2])], axis=1)

    def boundary_TE(self, tet_ids) -> np.ndarray:
        T = self.smesh.tets[np.asarray(tet_ids)]
        nv = self.smesh.n_vertices
        return np.stack([edge_lookup(self.pre.E_keys, nv, T[:, a], T[:, b])
                         for a, b in _EDGE_COMBOS], axis=1)

    def boundary_TF(self, tet_ids) -> np.ndarray:
        T = self.smesh.tets[np.asarray(tet_ids)]
        nv = self.smesh.n_vertices
        return np.stack(
            [face_lookup(self.pre.F_keys, nv, T[:, a], T[:, b], T[:, c])
             for a, b, c in _FACE_COMBOS], axis=1)

    def rows(self, relation: str, ids: np.ndarray):
        M, L = self.rel[relation]
        ids = np.asarray(ids)
        return M[ids], L[ids]

    def memory_bytes(self) -> int:
        return sum(M.nbytes + L.nbytes for (M, L) in self.rel.values())


class _LocalizedDS:
    """A localized baseline: the port's engine producing one segment a
    launch (``batch_max=1``) and syncing every launch right after dispatch
    (``async_dispatch=False``). ``backend=None`` runs the kernels on a card
    and the plain torch arm on the CPU; ``device`` is ``cuda`` unless the
    caller asks for another."""

    LOOKAHEAD = 0
    CACHE_SEGMENTS = 8

    def __init__(self, pre: Preconditioned, relations, backend=None,
                 device=None, **kw):
        self.engine = RelationEngine(
            pre, relations, backend=backend, device=device,
            lookahead=self.LOOKAHEAD, batch_max=1,
            cache_segments=self.CACHE_SEGMENTS, async_dispatch=False, **kw)
        self.device = self.engine.device
        self.worker_scope = self.engine.worker_scope

    @property
    def stats(self):
        return self.engine.stats

    def get(self, relation, segment):
        return self.engine.get(relation, segment)

    def get_batch(self, relation, segments):
        return self.engine.get_batch(relation, segments)


class TopoClusterDS(_LocalizedDS):
    """TopoCluster-style baseline [30]: localized, computes relations for the
    requested segment on demand and discards them soon after (a cache of 8
    segments, no lookahead, no task parallelism)."""

    def prefetch(self, relation, segments):
        pass  # no proactive computation

    def prefetch_many(self, requests):
        pass


class ActopoDS(_LocalizedDS):
    """ACTOPO-style baseline [29]: producers precompute ahead along the
    traversal (lookahead 8, a 512-segment cache) but execute synchronously
    with the consumers, one segment a launch."""

    LOOKAHEAD = 8
    CACHE_SEGMENTS = 512

    def prefetch(self, relation, segments):
        self.engine.prefetch(relation, segments)

    def prefetch_many(self, requests):
        self.engine.prefetch_many(requests)
