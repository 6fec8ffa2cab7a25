"""Synthetic tetrahedral mesh generators (the subset the critical-points
path and its tests use; the adversarial families come with the persistence
slice).

The paper's datasets are (a) native unstructured tet meshes (Fish, Hole) and
(b) regular volumes with null values removed, then tetrahedralized (Engine,
Foot, Asteroid, Stent). We mirror (b) with a Kuhn/Freudenthal subdivision of
a voxel grid with an optional cell mask ('holey'), and approximate (a) by
jittering interior vertices (same topology, irregular geometry).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..core.mesh import TetMesh

# Kuhn subdivision: six tets per cube, all sharing the main diagonal
# (0,0,0)-(1,1,1). Corners bit-coded as x + 2y + 4z.
_KUHN_PATHS = [
    (0, 1, 3, 7), (0, 1, 5, 7), (0, 2, 3, 7),
    (0, 2, 6, 7), (0, 4, 5, 7), (0, 4, 6, 7),
]
# _CORNER_OFFSETS[i] = offset of corner with bit code x + 2y + 4z
_CORNER_OFFSETS = np.array(
    [[b & 1, (b >> 1) & 1, (b >> 2) & 1] for b in range(8)])


def structured_grid(
    nx: int, ny: int, nz: int,
    scalar_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    cell_mask_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    jitter: float = 0.0,
    seed: int = 0,
) -> TetMesh:
    """(nx, ny, nz) vertices -> Kuhn-subdivided tet mesh.

    cell_mask_fn(centers (c,3)) -> bool keep-mask emulates the paper's
    'removing null values' preprocessing. jitter>0 displaces interior
    vertices to emulate unstructured geometry."""
    xs = np.arange(nx); ys = np.arange(ny); zs = np.arange(nz)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    pts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3).astype(np.float32)

    def vid(ix, iy, iz):
        return (ix * ny + iy) * nz + iz

    cx, cy, cz = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                             np.arange(nz - 1), indexing="ij")
    cells = np.stack([cx, cy, cz], axis=-1).reshape(-1, 3)
    if cell_mask_fn is not None:
        keep = cell_mask_fn(cells + 0.5)
        cells = cells[keep]

    # corner vertex ids per cell: (ncell, 8)
    corners = np.stack(
        [vid(cells[:, 0] + dx, cells[:, 1] + dy, cells[:, 2] + dz)
         for dx, dy, dz in _CORNER_OFFSETS], axis=1)
    tets = np.concatenate([corners[:, list(p)] for p in _KUHN_PATHS], axis=0)

    # drop unreferenced vertices (masked grids)
    used = np.unique(tets)
    remap = np.full(len(pts), -1, dtype=np.int64)
    remap[used] = np.arange(len(used))
    pts = pts[used]
    tets = remap[tets]

    if jitter > 0:
        rng = np.random.default_rng(seed)
        pts = pts + rng.uniform(-jitter, jitter, pts.shape).astype(np.float32)

    scal = scalar_fn(pts) if scalar_fn is not None else np.zeros(len(pts))
    return TetMesh(points=pts, tets=tets, scalars=np.asarray(scal, np.float32))


def sphere_hole_mask(center, radius):
    """Cell mask removing a spherical hole (emulates 'Hole'-like data)."""
    c = np.asarray(center, dtype=np.float64)

    def fn(centers):
        return np.linalg.norm(centers - c[None, :], axis=1) > radius
    return fn


# Named datasets, the same constructors as the reference's pool.
DATASETS = {
    "engine":   lambda: structured_grid(14, 14, 14),
    "foot":     lambda: structured_grid(
        18, 18, 18, cell_mask_fn=sphere_hole_mask((5, 5, 5), 4.0)),
    "fish":     lambda: structured_grid(16, 16, 16, jitter=0.25, seed=1),
    # long thin bar: Morton-ordered segments stack along x
    "bar":      lambda: structured_grid(48, 4, 4),
}


def load_dataset(name: str, scalar_fn=None) -> TetMesh:
    mesh = DATASETS[name]()
    if scalar_fn is not None:
        mesh.scalars = np.asarray(scalar_fn(mesh.points), np.float32)
    return mesh
