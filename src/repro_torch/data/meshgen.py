"""Synthetic tetrahedral mesh generators: the grids of the quickstart and
the named datasets, and the adversarial families with analytically known
topology that the persistence tests use (graded, sliver, tunnel, cavity,
multi-component).

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


def two_tets() -> TetMesh:
    """The paper's Fig. 1/4 toy: two tetrahedra sharing a triangular face."""
    pts = np.array([[0, 0, 0], [1, 0, 0], [0.5, 1, 0],
                    [0.5, 0.5, 1], [0.5, 0.5, -1], [1.5, 1, 0]],
                   dtype=np.float32)
    tets = np.array([[0, 1, 2, 3], [0, 1, 2, 4], [1, 2, 3, 5]])
    scal = np.array([2.0, 4.0, 5.0, 1.0, 0.0, 3.0], np.float32)
    return TetMesh(points=pts, tets=tets, scalars=scal)


def sphere_hole_mask(center, radius):
    """Cell mask removing a spherical hole (emulates 'Hole'-like data)."""
    c = np.asarray(center, dtype=np.float64)

    def fn(centers):
        return np.linalg.norm(centers - c[None, :], axis=1) > radius
    return fn


def cylinder_hole_mask(center2d, radius, axis=2):
    """Cell mask drilling a through-hole along ``axis``: the removed cells
    form a cylinder spanning the full extent, so the remaining solid is a
    handlebody with one tunnel (β₁ += 1) instead of a cavity (β₂ += 1)."""
    c = np.asarray(center2d, dtype=np.float64)
    keep_axes = [a for a in range(3) if a != axis]

    def fn(centers):
        d = centers[:, keep_axes] - c[None, :]
        return np.sqrt((d * d).sum(axis=1)) > radius
    return fn


def graded_grid(
    nx: int, ny: int, nz: int,
    ratio: float = 4.0, axis: int = 0,
    scalar_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    cell_mask_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
) -> TetMesh:
    """AMR-like geometric grading: the Kuhn topology of ``structured_grid``
    with vertex coordinates along ``axis`` remapped by an exponential so
    consecutive cell widths shrink geometrically — the last cell is
    ``ratio`` times wider than the first. The map is strictly monotone, so
    no tet is inverted or degenerate, but segment spatial densities vary by
    ``ratio`` across the mesh (the refinement-region stress case for the
    Morton segmentation and the device block pool)."""
    if ratio <= 0:
        raise ValueError(f"ratio must be positive, got {ratio}")
    mesh = structured_grid(nx, ny, nz, cell_mask_fn=cell_mask_fn)
    n = (nx, ny, nz)[axis]
    span = float(n - 1)
    t = mesh.points[:, axis].astype(np.float64) / span
    if abs(ratio - 1.0) > 1e-12:
        warped = span * (np.power(ratio, t) - 1.0) / (ratio - 1.0)
    else:
        warped = span * t
    mesh.points[:, axis] = warped.astype(np.float32)
    if scalar_fn is not None:
        mesh.scalars = np.asarray(scalar_fn(mesh.points), np.float32)
    return mesh


def anisotropic_grid(
    nx: int, ny: int, nz: int,
    aspect=(1.0, 1.0, 0.1), shear: float = 0.0,
    scalar_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    cell_mask_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
) -> TetMesh:
    """Sliver-heavy anisotropic tets: the structured grid scaled per axis by
    ``aspect`` (a small component flattens every Kuhn tet into a sliver)
    plus an optional x-by-z ``shear``. The map is linear with determinant
    ``prod(aspect) != 0``, so volumes shrink but never vanish or flip —
    adversarial geometry with unchanged (analytically known) topology."""
    a = np.asarray(aspect, dtype=np.float64)
    if (a <= 0).any():
        raise ValueError(f"aspect components must be positive, got {aspect}")
    mesh = structured_grid(nx, ny, nz, cell_mask_fn=cell_mask_fn)
    pts = mesh.points.astype(np.float64) * a[None, :]
    pts[:, 0] += shear * pts[:, 2]
    mesh.points = pts.astype(np.float32)
    if scalar_fn is not None:
        mesh.scalars = np.asarray(scalar_fn(mesh.points), np.float32)
    return mesh


def component_stride(nx: int, gap: float = 3.0) -> float:
    """x-distance between copies of a :func:`multi_component` mesh — the
    value field constructors (``fields.per_component``) need to recover the
    component index from a point's x coordinate."""
    return float(nx - 1) + float(gap)


def multi_component(
    k: int, nx: int, ny: int, nz: int,
    gap: float = 3.0, hole: Optional[str] = None,
    scalar_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
) -> TetMesh:
    """``k`` disjoint translated copies of a grid along x, each optionally
    carrying a hole — the multi-component family with closed-form Betti
    numbers. Per copy: ``hole=None`` is a solid box (β = 1,0,0),
    ``"cavity"`` removes an interior ball (β = 1,0,1 — an enclosed void),
    ``"tunnel"`` drills a cylinder through z (β = 1,1,0 — a handle). Totals
    are k-fold sums, so χ = V - E + F - T = k·(1 - β₁ + β₂) is an analytic
    invariant the property suite checks per family."""
    if k < 1:
        raise ValueError(f"need k >= 1 components, got {k}")
    if hole not in (None, "cavity", "tunnel"):
        raise ValueError(f"hole must be None/'cavity'/'tunnel', got {hole!r}")
    mask = None
    if hole == "cavity":
        # strictly interior ball: never touches the outer boundary
        c = ((nx - 1) / 2, (ny - 1) / 2, (nz - 1) / 2)
        mask = sphere_hole_mask(c, max(1.1, min(nx, ny, nz) / 4))
    elif hole == "tunnel":
        c = ((nx - 1) / 2, (ny - 1) / 2)
        mask = cylinder_hole_mask(c, max(1.1, min(nx, ny) / 4), axis=2)
    stride = component_stride(nx, gap)
    pts, tets, off = [], [], 0
    for j in range(k):
        m = structured_grid(nx, ny, nz, cell_mask_fn=mask)
        p = m.points.copy()
        p[:, 0] += j * stride
        pts.append(p)
        tets.append(m.tets + off)
        off += len(p)
    points = np.concatenate(pts, axis=0)
    tetarr = np.concatenate(tets, axis=0)
    scal = (scalar_fn(points) if scalar_fn is not None
            else np.zeros(len(points)))
    return TetMesh(points=points, tets=tetarr,
                   scalars=np.asarray(scal, np.float32))


# Named datasets, the same constructors as the reference's pool.
DATASETS = {
    "toy":      lambda: two_tets(),
    "engine":   lambda: structured_grid(14, 14, 14),
    "foot":     lambda: structured_grid(
        18, 18, 18, cell_mask_fn=sphere_hole_mask((5, 5, 5), 4.0)),
    "fish":     lambda: structured_grid(16, 16, 16, jitter=0.25, seed=1),
    "asteroid": lambda: structured_grid(
        24, 24, 14, cell_mask_fn=sphere_hole_mask((12, 12, 7), 5.0)),
    "hole":     lambda: structured_grid(
        22, 22, 22, cell_mask_fn=sphere_hole_mask((11, 11, 11), 6.0)),
    "stent":    lambda: structured_grid(28, 28, 20),
    # long thin bar: Morton-ordered segments stack along x
    "bar":      lambda: structured_grid(48, 4, 4),
    # adversarial families with analytically known topology (Betti
    # numbers, Euler characteristic, profile-field diagrams)
    "graded":      lambda: graded_grid(24, 8, 8, ratio=8.0),
    "slivers":     lambda: anisotropic_grid(14, 12, 10,
                                            aspect=(1.0, 1.0, 0.08),
                                            shear=0.35),
    "tunnel":      lambda: multi_component(1, 10, 10, 8, hole="tunnel"),
    "pockets":     lambda: multi_component(2, 8, 8, 8, hole="cavity"),
    "archipelago": lambda: multi_component(3, 7, 6, 6),
}


def load_dataset(name: str, scalar_fn=None) -> TetMesh:
    mesh = DATASETS[name]()
    if scalar_fn is not None:
        mesh.scalars = np.asarray(scalar_fn(mesh.points), np.float32)
    return mesh
