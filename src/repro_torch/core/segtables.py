"""Init-time preconditioning: global edge/face enumeration and per-segment
padded local tables (GALE §4.3 'Initialization').

The paper enumerates mesh edges and triangles on the CPU during
initialization and keeps interval arrays ``I_E``/``I_F`` so the owner segment
of any simplex resolves via its index. We additionally materialize, per
segment, the *local tables* the accelerator kernels consume:

  - ``T_local``  (NT, 4): local vertex ids of internal+external tets
  - ``E_local``  (NE, 2): local vertex ids of all edges of local tets
  - ``F_local``  (NF, 3): local vertex ids of all faces of local tets
  - ``L?_global``: local -> global simplex id maps

Everything is padded with ``-1`` to shared shapes (multiples of 128, the
reference's padding, so both packages see identical tables). Internal simplices
come first in every local table, and internal edges/faces appear in global
order, so row ``r`` of a relation block for segment ``k`` is the simplex with
global id ``I_X[k] + r``.

Mirrors TTK-style preconditioning: edge/face tables are only built when a
requested relation needs them.

A copy of the reference package's ``core/segtables.py`` (pure numpy), plus
:func:`from_arrays`, which rebuilds a :class:`Preconditioned` from plain
numpy fields so that the port can be handed tables made elsewhere.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np

from .mesh import (
    SegmentedMesh,
    _EDGE_COMBOS,
    _FACE_COMBOS,
    edge_lookup,
    enumerate_edges,
    enumerate_faces,
    face_lookup,
)

# ---------------------------------------------------------------------------
# Relation taxonomy (paper Table 1).
BOUNDARY_RELATIONS = ("EV", "FV", "TV", "FE", "TE", "TF")
COBOUNDARY_RELATIONS = ("VE", "VF", "VT", "EF", "ET", "FT")
ADJACENCY_RELATIONS = ("VV", "EE", "FF", "TT")
OFFLOADED_RELATIONS = COBOUNDARY_RELATIONS + ADJACENCY_RELATIONS
ALL_RELATIONS = BOUNDARY_RELATIONS + OFFLOADED_RELATIONS

_DIM = {"V": 0, "E": 1, "F": 2, "T": 3}

# (shared-vertex count k, exact?) predicate per offloaded relation: the
# relation X->Y holds between x and y iff |verts(x) ∩ verts(y)| == k (exact)
# or >= k (VV/EE, which only need one shared containing simplex / vertex).
RELATION_PREDICATE = {
    "VE": (1, True), "VF": (1, True), "VT": (1, True),
    "EF": (2, True), "ET": (2, True), "FT": (3, True),
    "VV": (1, False),   # via shared tet: (A_vt A_vt^T) >= 1, off-diagonal
    "EE": (1, True),    # edges sharing exactly one vertex (distinct edges)
    "FF": (2, True),    # faces sharing an edge
    "TT": (3, True),    # tets sharing a face
}

# Which local table backs each side of a relation. VV is computed through the
# tet incidence (every pair of vertices of a tet spans an edge of the mesh).
RELATION_TABLES = {
    "VV": ("T", "T"),  # special-cased: product A_vt A_vt^T over vertices
    "VE": ("V", "E"), "VF": ("V", "F"), "VT": ("V", "T"),
    "EF": ("E", "F"), "ET": ("E", "T"), "FT": ("F", "T"),
    "EE": ("E", "E"), "FF": ("F", "F"), "TT": ("T", "T"),
}


def _round_up(x: int, m: int) -> int:
    return ((max(x, 1) + m - 1) // m) * m


@dataclasses.dataclass
class SegmentTables:
    """Stacked per-segment padded local tables (see module docstring)."""

    # vertex side
    LV_global: np.ndarray   # (ns, NV) i32, -1 pad; first n_int internal
    n_int_v: np.ndarray     # (ns,) i32
    n_loc_v: np.ndarray     # (ns,) i32
    # tets
    T_local: np.ndarray     # (ns, NT, 4) i32 local vertex ids, -1 pad
    LT_global: np.ndarray   # (ns, NT) i32
    n_int_t: np.ndarray     # (ns,)
    n_loc_t: np.ndarray     # (ns,)
    # edges (optional)
    E_local: Optional[np.ndarray] = None    # (ns, NE, 2)
    LE_global: Optional[np.ndarray] = None  # (ns, NE)
    n_int_e: Optional[np.ndarray] = None
    n_loc_e: Optional[np.ndarray] = None
    # faces (optional)
    F_local: Optional[np.ndarray] = None    # (ns, NF, 3)
    LF_global: Optional[np.ndarray] = None  # (ns, NF)
    n_int_f: Optional[np.ndarray] = None
    n_loc_f: Optional[np.ndarray] = None
    # Inverse maps, built once at table time (docs/DESIGN.md §5): for each
    # simplex kind, every (segment, global id) appearance in the local tables
    # packed as a sorted key array so `(segment, gid) -> local row` resolves
    # with one binary search instead of scanning the table. Per kind:
    # (sorted_keys i64 [seg * n_global + gid], rows i32, n_global).
    inverse: Optional[Dict[str, Tuple[np.ndarray, np.ndarray, int]]] = None

    @property
    def NV(self) -> int:
        return self.LV_global.shape[1]

    @property
    def NT(self) -> int:
        return self.LT_global.shape[1]

    @property
    def NE(self) -> Optional[int]:
        return None if self.LE_global is None else self.LE_global.shape[1]

    @property
    def NF(self) -> Optional[int]:
        return None if self.LF_global is None else self.LF_global.shape[1]

    def table(self, kind: str, segs=None):
        """(local_table (ns,N,a), global_ids (ns,N)) for kind in V/E/F/T;
        with ``segs`` (an index array), only those segments' rows."""
        if kind == "V":
            lv = self.LV_global if segs is None else self.LV_global[segs]
            iota = np.arange(self.NV, dtype=np.int32)[None, :, None]
            tab = np.broadcast_to(iota, lv.shape + (1,)).copy()
            tab[lv < 0] = -1
            return tab, lv
        tab, glob = {"E": (self.E_local, self.LE_global),
                     "F": (self.F_local, self.LF_global),
                     "T": (self.T_local, self.LT_global)}[kind]
        return (tab, glob) if segs is None else (tab[segs], glob[segs])

    def counts(self, kind: str):
        """(n_internal, n_local) per segment for kind."""
        return {
            "V": (self.n_int_v, self.n_loc_v),
            "E": (self.n_int_e, self.n_loc_e),
            "F": (self.n_int_f, self.n_loc_f),
            "T": (self.n_int_t, self.n_loc_t),
        }[kind]

    def local_rows(self, kind: str, segs: np.ndarray,
                   gids: np.ndarray) -> np.ndarray:
        """Vectorized ``(segment, global id) -> local table row`` for one
        simplex kind; ``-1`` where the simplex does not appear in that
        segment's local table. One batched binary search over the inverse
        map — no per-query table scans (docs/DESIGN.md §5)."""
        if self.inverse is None or kind not in self.inverse:
            raise KeyError(f"no inverse map for kind {kind!r}")
        keys, rows, n_glob = self.inverse[kind]
        q = (np.asarray(segs, dtype=np.int64) * n_glob
             + np.asarray(gids, dtype=np.int64))
        if len(keys) == 0:
            return np.full(q.shape, -1, dtype=np.int32)
        pos = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
        return np.where(keys[pos] == q, rows[pos], -1)


@dataclasses.dataclass
class Preconditioned:
    """A segmented mesh plus everything the relation engine needs."""

    smesh: SegmentedMesh
    needs_edges: bool
    needs_faces: bool
    E: Optional[np.ndarray] = None        # (ne, 2) global, lex-sorted
    E_keys: Optional[np.ndarray] = None
    I_E: Optional[np.ndarray] = None      # (ns+1,)
    F: Optional[np.ndarray] = None        # (nf, 3)
    F_keys: Optional[Tuple[np.ndarray, np.ndarray]] = None
    I_F: Optional[np.ndarray] = None
    tables: Optional[SegmentTables] = None

    @property
    def n_edges(self) -> int:
        return 0 if self.E is None else len(self.E)

    @property
    def n_faces(self) -> int:
        return 0 if self.F is None else len(self.F)

    def interval(self, kind: str) -> np.ndarray:
        return {"V": self.smesh.I_V, "E": self.I_E,
                "F": self.I_F, "T": self.smesh.I_T}[kind]

    def owner_segment(self, kind: str, ids: np.ndarray) -> np.ndarray:
        """Segment owning each simplex id (via interval arrays, paper §4.3)."""
        iv = self.interval(kind)
        return np.searchsorted(iv, np.asarray(ids), side="right") - 1


def _relations_need(relations: Iterable[str]) -> Tuple[bool, bool]:
    needs_e = needs_f = False
    for r in relations:
        if r not in ALL_RELATIONS:
            raise KeyError(f"unknown relation {r!r}")
        for kind in r:
            needs_e |= kind == "E"
            needs_f |= kind == "F"
    return needs_e, needs_f


def precondition(
    smesh: SegmentedMesh,
    relations: Sequence[str] = ("VV", "VT"),
    build_tables: bool = True,
) -> Preconditioned:
    """Run the init phase for the given relation set (TTK-style lazy
    preconditioning: E/F tables are only enumerated when needed)."""
    needs_e, needs_f = _relations_need(relations)
    nv = smesh.n_vertices
    ns = smesh.n_segments
    pre = Preconditioned(smesh=smesh, needs_edges=needs_e, needs_faces=needs_f)

    seg_of = smesh.seg_of_vertex
    if needs_e:
        E, E_keys = enumerate_edges(smesh.tets, nv)
        pre.E, pre.E_keys = E, E_keys
        owner = seg_of[E[:, 0]]
        I_E = np.zeros(ns + 1, dtype=np.int64)
        np.cumsum(np.bincount(owner, minlength=ns), out=I_E[1:])
        pre.I_E = I_E
    if needs_f:
        F, F_keys = enumerate_faces(smesh.tets, nv)
        pre.F, pre.F_keys = F, F_keys
        owner = seg_of[F[:, 0]]
        I_F = np.zeros(ns + 1, dtype=np.int64)
        np.cumsum(np.bincount(owner, minlength=ns), out=I_F[1:])
        pre.I_F = I_F

    if build_tables and any(r in OFFLOADED_RELATIONS for r in relations):
        pre.tables = _build_segment_tables(pre)
    return pre


def from_arrays(arrays: Mapping[str, np.ndarray]) -> Preconditioned:
    """Rebuild a :class:`Preconditioned` from its numpy fields.

    ``arrays`` holds every :class:`SegmentedMesh` field (``points``,
    ``tets``, ``I_V``, ``I_T``, ...) and every :class:`SegmentTables`
    field (``T_local``, ``LV_global``, ``LT_global``, ``n_int_v``, ...),
    under their field names; the edge/face fields (``E``, ``I_E``,
    ``E_local``, ...; ``F``, ``I_F``, ``F_local``, ...) only when the
    tables carry that kind. Lookup keys and inverse maps are derived data
    and are rebuilt here, so no precondition work is repeated beyond them.
    """
    sm = SegmentedMesh(**{f.name: np.asarray(arrays[f.name])
                          for f in dataclasses.fields(SegmentedMesh)})
    nv = sm.n_vertices
    E = arrays.get("E")
    F = arrays.get("F")
    pre = Preconditioned(smesh=sm, needs_edges=E is not None,
                         needs_faces=F is not None)
    if E is not None:
        pre.E = np.asarray(E)
        pre.E_keys = pre.E[:, 0] * np.int64(nv) + pre.E[:, 1]
        pre.I_E = np.asarray(arrays["I_E"])
    if F is not None:
        pre.F = np.asarray(F)
        pre.F_keys = (pre.F[:, 0].copy(),
                      pre.F[:, 1] * np.int64(nv) + pre.F[:, 2])
        pre.I_F = np.asarray(arrays["I_F"])
    fields = [f.name for f in dataclasses.fields(SegmentTables)
              if f.name != "inverse"]
    tabs = SegmentTables(**{name: (None if arrays.get(name) is None
                                   else np.asarray(arrays[name]))
                            for name in fields})
    tabs.inverse = _build_inverse_maps(tabs, pre)
    pre.tables = tabs
    return pre


def _build_segment_tables(pre: Preconditioned) -> SegmentTables:
    sm = pre.smesh
    ns, nv = sm.n_segments, sm.n_vertices
    tets = sm.tets

    per_seg = []
    for k in range(ns):
        vstart, vend = int(sm.I_V[k]), int(sm.I_V[k + 1])
        n_int = vend - vstart
        lt = sm.local_tets(k)
        tv = tets[lt]  # (n,4) global vertex ids
        uniq = np.unique(tv)
        ext = uniq[(uniq < vstart) | (uniq >= vend)]
        lv = np.concatenate([np.arange(vstart, vend, dtype=np.int64), ext])

        def to_local(g):
            g = np.asarray(g)
            internal = (g >= vstart) & (g < vend)
            loc_ext = n_int + np.searchsorted(ext, g)
            return np.where(g < 0, -1,
                            np.where(internal, g - vstart, loc_ext))

        t_local = to_local(tv)
        entry = {
            "lv": lv, "n_int_v": n_int, "lt": lt,
            "t_local": t_local, "n_int_t": int(sm.I_T[k + 1] - sm.I_T[k]),
        }

        if pre.needs_edges:
            pairs = tv[:, _EDGE_COMBOS].reshape(-1, 2)
            keys = pairs[:, 0] * np.int64(nv) + pairs[:, 1]
            ukeys = np.unique(keys)
            gu, gvv = ukeys // nv, ukeys % nv
            # internal edges first (owner = segment of min vertex)
            is_int = (gu >= vstart) & (gu < vend)
            order = np.argsort(~is_int, kind="stable")
            gu, gvv = gu[order], gvv[order]
            ge = edge_lookup(pre.E_keys, nv, gu, gvv)
            entry["e_local"] = np.stack([to_local(gu), to_local(gvv)], 1)
            entry["le"] = ge
            entry["n_int_e"] = int(is_int.sum())

        if pre.needs_faces:
            tris = tv[:, _FACE_COMBOS].reshape(-1, 3)
            lo = tris[:, 1] * np.int64(nv) + tris[:, 2]
            order = np.lexsort((lo, tris[:, 0]))
            tris, lo = tris[order], lo[order]
            keep = np.ones(len(tris), dtype=bool)
            if len(tris) > 1:
                keep[1:] = (np.diff(tris[:, 0]) != 0) | (np.diff(lo) != 0)
            tris = tris[keep]
            is_int = (tris[:, 0] >= vstart) & (tris[:, 0] < vend)
            order = np.argsort(~is_int, kind="stable")
            tris = tris[order]
            gf = face_lookup(pre.F_keys, nv, tris[:, 0], tris[:, 1], tris[:, 2])
            entry["f_local"] = to_local(tris)
            entry["lf"] = gf
            entry["n_int_f"] = int(is_int.sum())

        per_seg.append(entry)

    # Pad + stack.
    NV = _round_up(max(len(e["lv"]) for e in per_seg), 128)
    NT = _round_up(max(len(e["lt"]) for e in per_seg), 128)

    def pad1(rows, n, fill=-1, dtype=np.int32):
        out = np.full((ns, n), fill, dtype=dtype)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r
        return out

    def pad2(rows, n, w, fill=-1, dtype=np.int32):
        out = np.full((ns, n, w), fill, dtype=dtype)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r
        return out

    tabs = SegmentTables(
        LV_global=pad1([e["lv"] for e in per_seg], NV),
        n_int_v=np.array([e["n_int_v"] for e in per_seg], np.int32),
        n_loc_v=np.array([len(e["lv"]) for e in per_seg], np.int32),
        T_local=pad2([e["t_local"] for e in per_seg], NT, 4),
        LT_global=pad1([e["lt"] for e in per_seg], NT),
        n_int_t=np.array([e["n_int_t"] for e in per_seg], np.int32),
        n_loc_t=np.array([len(e["lt"]) for e in per_seg], np.int32),
    )
    if pre.needs_edges:
        NE = _round_up(max(len(e["le"]) for e in per_seg), 128)
        tabs.E_local = pad2([e["e_local"] for e in per_seg], NE, 2)
        tabs.LE_global = pad1([e["le"] for e in per_seg], NE)
        tabs.n_int_e = np.array([e["n_int_e"] for e in per_seg], np.int32)
        tabs.n_loc_e = np.array([len(e["le"]) for e in per_seg], np.int32)
    if pre.needs_faces:
        NF = _round_up(max(len(e["lf"]) for e in per_seg), 128)
        tabs.F_local = pad2([e["f_local"] for e in per_seg], NF, 3)
        tabs.LF_global = pad1([e["lf"] for e in per_seg], NF)
        tabs.n_int_f = np.array([e["n_int_f"] for e in per_seg], np.int32)
        tabs.n_loc_f = np.array([len(e["lf"]) for e in per_seg], np.int32)
    tabs.inverse = _build_inverse_maps(tabs, pre)
    return tabs


def _build_inverse_maps(
    tabs: SegmentTables, pre: Preconditioned,
) -> Dict[str, Tuple[np.ndarray, np.ndarray, int]]:
    """One-time inversion of the L?_global tables: every (segment, gid)
    appearance keyed as ``seg * n_global + gid`` and sorted, so cross-segment
    completion resolves `(segment, gid) -> local row` by binary search."""
    n_global = {
        "V": pre.smesh.n_vertices,
        "E": pre.n_edges,
        "F": pre.n_faces,
        "T": pre.smesh.n_tets,
    }
    out: Dict[str, Tuple[np.ndarray, np.ndarray, int]] = {}
    for kind, glob in (("V", tabs.LV_global), ("E", tabs.LE_global),
                       ("F", tabs.LF_global), ("T", tabs.LT_global)):
        if glob is None:
            continue
        seg_idx, row_idx = np.nonzero(glob >= 0)
        keys = (seg_idx.astype(np.int64) * n_global[kind]
                + glob[seg_idx, row_idx].astype(np.int64))
        order = np.argsort(keys)
        out[kind] = (keys[order], row_idx[order].astype(np.int32),
                     n_global[kind])
    return out
