"""Tetrahedral mesh encoding and segmentation (GALE §4.3).

A copy of the reference package's ``core/mesh.py``: pure numpy, kept here so
the port never imports the reference.

The input encoding is top-simplex based: a vertex coordinate list ``V``, a
tetrahedron list ``T`` (the TV relation), and a vertex->segment assignment
``S``. Following the paper we canonicalize the mesh so that vertex indices are
sorted by segment (segments are contiguous index ranges), which makes the
interval arrays ``I_V``/``I_E``/``I_F``/``I_T`` sufficient to locate the
segment owning any simplex.

Segmentation uses Morton-order chunking of the vertices — a linearized PR
octree [38]: spatially coherent leaves with a bounded number of vertices per
segment (the paper uses <=100 vertices per leaf).

All of this is host-side (numpy) init work, mirroring the paper's CPU
initialization phase.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "TetMesh",
    "SegmentedMesh",
    "morton_order",
    "segment_mesh",
]

# Per-tet vertex-pair / vertex-triple enumeration (vertices inside a tet are
# kept sorted ascending, so these combinations are already lexicographic).
_EDGE_COMBOS = np.array([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)], dtype=np.int64)
_FACE_COMBOS = np.array([(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)], dtype=np.int64)


@dataclasses.dataclass
class TetMesh:
    """A raw tetrahedral mesh: ``points`` (nv,3) f32, ``tets`` (nt,4) i32,
    ``scalars`` (nv,) f32 (the input scalar field; zeros if absent)."""

    points: np.ndarray
    tets: np.ndarray
    scalars: np.ndarray

    def __post_init__(self):
        self.points = np.asarray(self.points, dtype=np.float32)
        self.tets = np.asarray(self.tets, dtype=np.int64)
        if self.scalars is None:
            self.scalars = np.zeros(len(self.points), dtype=np.float32)
        self.scalars = np.asarray(self.scalars, dtype=np.float32)
        if self.tets.ndim != 2 or self.tets.shape[1] != 4:
            raise ValueError(f"tets must be (nt, 4), got {self.tets.shape}")
        if len(self.scalars) != len(self.points):
            raise ValueError("scalars must align with points")
        # Canonical order inside each tet: ascending vertex ids. This fixes
        # the edge/face enumeration order used everywhere downstream.
        self.tets = np.sort(self.tets, axis=1)
        if len(self.tets) and (self.tets[:, 0] < 0).any():
            raise ValueError("negative vertex index in tets")

    @property
    def n_vertices(self) -> int:
        return len(self.points)

    @property
    def n_tets(self) -> int:
        return len(self.tets)


def _expand_bits(x: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of x so consecutive bits are 3 apart."""
    x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def morton_order(points: np.ndarray, bits: int = 16) -> np.ndarray:
    """Return the permutation sorting points along a 3D Morton (Z-order)
    curve. This linearizes a PR octree: chunks of the sorted order are
    spatially coherent boxes."""
    p = np.asarray(points, dtype=np.float64)
    lo = p.min(axis=0)
    span = np.maximum(p.max(axis=0) - lo, 1e-12)
    q = ((p - lo) / span * (2**bits - 1)).astype(np.uint64)
    code = (
        _expand_bits(q[:, 0])
        | (_expand_bits(q[:, 1]) << np.uint64(1))
        | (_expand_bits(q[:, 2]) << np.uint64(2))
    )
    return np.argsort(code, kind="stable")


@dataclasses.dataclass
class SegmentedMesh:
    """A canonicalized, segmented tetrahedral mesh (paper Fig. 4/5).

    Vertices are relabeled so segment k owns the contiguous index range
    ``[I_V[k], I_V[k+1])`` (we store interval arrays with a leading 0, i.e.
    ``I_V`` has ``n_segments+1`` entries; the paper's ``I[S_k-1], I[S_k]``
    convention is the same data). Tets are sorted by owner segment, where the
    owner of a simplex is the segment of its lowest-index vertex.
    """

    points: np.ndarray          # (nv, 3) f32, relabeled order
    scalars: np.ndarray         # (nv,) f32
    tets: np.ndarray            # (nt, 4) i64, rows sorted asc, sorted by owner
    seg_of_vertex: np.ndarray   # (nv,) i32  == paper's S (canonical: sorted)
    I_V: np.ndarray             # (ns+1,) i64 vertex intervals
    I_T: np.ndarray             # (ns+1,) i64 tet intervals (internal tets)
    Tex_index: np.ndarray       # (ns+1,) i64 CSR offsets into Tex_tets
    Tex_tets: np.ndarray        # (sum,) i64 external tet ids per segment
    # Vertex -> incident tets (global CSR), used to build Tex and local tables.
    vt_offsets: np.ndarray      # (nv+1,) i64
    vt_tets: np.ndarray         # (4*nt,) i64

    @property
    def n_segments(self) -> int:
        return len(self.I_V) - 1

    @property
    def n_vertices(self) -> int:
        return len(self.points)

    @property
    def n_tets(self) -> int:
        return len(self.tets)

    def segment_of_tet(self, t: np.ndarray) -> np.ndarray:
        """Owner segment of tets (segment of the min = first vertex)."""
        return self.seg_of_vertex[self.tets[np.asarray(t), 0]]

    def local_tets(self, k: int) -> np.ndarray:
        """Internal + external tet ids for segment k (paper's kernel input)."""
        internal = np.arange(self.I_T[k], self.I_T[k + 1], dtype=np.int64)
        external = self.Tex_tets[self.Tex_index[k]: self.Tex_index[k + 1]]
        return np.concatenate([internal, external])


def _build_vertex_tet_csr(tets: np.ndarray, nv: int):
    """CSR map vertex -> incident tet ids."""
    nt = len(tets)
    flat_v = tets.reshape(-1)
    flat_t = np.repeat(np.arange(nt, dtype=np.int64), 4)
    order = np.argsort(flat_v, kind="stable")
    sorted_v = flat_v[order]
    sorted_t = flat_t[order]
    offsets = np.zeros(nv + 1, dtype=np.int64)
    counts = np.bincount(sorted_v, minlength=nv)
    np.cumsum(counts, out=offsets[1:])
    return offsets, sorted_t


def segment_mesh(mesh: TetMesh, capacity: int = 64) -> SegmentedMesh:
    """Segment + canonicalize a mesh (paper §4.3 with a PR-octree [38]
    linearized via Morton order). ``capacity`` = max vertices per segment
    (paper uses 100; the default 64 keeps one segment's entry lanes inside
    one thread block's shared memory).
    """
    if capacity < 1:
        raise ValueError("capacity must be >= 1")
    nv = mesh.n_vertices
    order = morton_order(mesh.points)
    # Relabel vertices: new id = position in morton order.
    new_of_old = np.empty(nv, dtype=np.int64)
    new_of_old[order] = np.arange(nv, dtype=np.int64)

    points = mesh.points[order]
    scalars = mesh.scalars[order]
    tets = np.sort(new_of_old[mesh.tets], axis=1)

    n_segments = max(1, -(-nv // capacity))
    # Even chunking of the morton order (last segment may be smaller).
    I_V = np.minimum(np.arange(n_segments + 1, dtype=np.int64) * capacity, nv)
    seg_of_vertex = np.repeat(np.arange(n_segments, dtype=np.int32),
                              np.diff(I_V))

    # Sort tets by owner segment (segment of min vertex = tets[:,0]).
    owner = seg_of_vertex[tets[:, 0]]
    tet_order = np.argsort(owner, kind="stable")
    tets = tets[tet_order]
    owner = owner[tet_order]
    I_T = np.zeros(n_segments + 1, dtype=np.int64)
    np.cumsum(np.bincount(owner, minlength=n_segments), out=I_T[1:])

    # Vertex->tet CSR on the canonical mesh.
    vt_offsets, vt_tets = _build_vertex_tet_csr(tets, nv)

    # External tets per segment: tets incident to a segment vertex but not
    # internal to that segment (paper's Tex).
    tex_lists = []
    tex_counts = np.zeros(n_segments, dtype=np.int64)
    for k in range(n_segments):
        lo, hi = I_V[k], I_V[k + 1]
        incident = vt_tets[vt_offsets[lo]: vt_offsets[hi]]
        incident = np.unique(incident)
        # internal tets form the contiguous range [I_T[k], I_T[k+1])
        ext = incident[(incident < I_T[k]) | (incident >= I_T[k + 1])]
        tex_lists.append(ext)
        tex_counts[k] = len(ext)
    Tex_index = np.zeros(n_segments + 1, dtype=np.int64)
    np.cumsum(tex_counts, out=Tex_index[1:])
    Tex_tets = (np.concatenate(tex_lists) if tex_lists
                else np.zeros(0, dtype=np.int64))

    return SegmentedMesh(
        points=points, scalars=scalars, tets=tets,
        seg_of_vertex=seg_of_vertex, I_V=I_V, I_T=I_T,
        Tex_index=Tex_index, Tex_tets=Tex_tets,
        vt_offsets=vt_offsets, vt_tets=vt_tets,
    )


def enumerate_edges(tets: np.ndarray, nv: int):
    """Global sorted unique edge list E (ne,2) and per-edge big-endian key
    view for O(log) lookup. Rows lex-sorted, so edges are grouped by owner
    segment for any segment-contiguous vertex labeling."""
    pairs = tets[:, _EDGE_COMBOS].reshape(-1, 2)
    key = pairs[:, 0] * np.int64(nv) + pairs[:, 1]
    uniq = np.unique(key)
    E = np.stack([uniq // nv, uniq % nv], axis=1)
    return E, uniq


def enumerate_faces(tets: np.ndarray, nv: int):
    """Global sorted unique triangle list F (nf,3) + composite keys.

    Uses a two-level (hi, lo) 128-bit-safe composite: hi = v0, lo = v1*nv+v2.
    Sorted lexicographically by (v0, v1, v2)."""
    tris = tets[:, _FACE_COMBOS].reshape(-1, 3)
    lo = tris[:, 1] * np.int64(nv) + tris[:, 2]
    # lexsort: primary v0, secondary lo
    order = np.lexsort((lo, tris[:, 0]))
    tris = tris[order]
    lo = lo[order]
    keep = np.ones(len(tris), dtype=bool)
    if len(tris) > 1:
        keep[1:] = (np.diff(tris[:, 0]) != 0) | (np.diff(lo) != 0)
    F = tris[keep]
    return F, (F[:, 0].copy(), F[:, 1] * np.int64(nv) + F[:, 2])


def edge_lookup(E_keys: np.ndarray, nv: int, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Global edge id of edges (u,v) with u<v. -1 if not present."""
    key = np.asarray(u) * np.int64(nv) + np.asarray(v)
    idx = np.searchsorted(E_keys, key)
    idx = np.clip(idx, 0, len(E_keys) - 1)
    ok = E_keys[idx] == key
    return np.where(ok, idx, -1)


def face_lookup(F_keys, nv: int, a, b, c) -> np.ndarray:
    """Global face id of faces (a,b,c) with a<b<c; -1 if absent. Vectorized
    two-level binary search: runs share the lowest vertex `a` (run length is
    bounded by the max vertex-face degree), then a padded gather+compare
    resolves the (b,c) composite within the run."""
    hi_keys, lo_keys = F_keys
    a = np.asarray(a, dtype=np.int64).reshape(-1)
    lo = (np.asarray(b, dtype=np.int64).reshape(-1) * np.int64(nv)
          + np.asarray(c, dtype=np.int64).reshape(-1))
    left = np.searchsorted(hi_keys, a, side="left")
    right = np.searchsorted(hi_keys, a, side="right")
    run = right - left
    rmax = int(run.max()) if len(run) else 0
    if rmax == 0:
        return np.full(len(a), -1, dtype=np.int64)
    # Padded gather of each run's lo keys, then a row-wise match.
    j = np.arange(rmax, dtype=np.int64)[None, :]
    idx = np.minimum(left[:, None] + j, len(lo_keys) - 1)
    cand = lo_keys[idx]
    hit = (cand == lo[:, None]) & (j < run[:, None])
    pos = hit.argmax(axis=1)
    found = hit.any(axis=1)
    return np.where(found, left + pos, -1)
