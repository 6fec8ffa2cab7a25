"""Synthetic scalar fields with analytically known critical structure:
lattice sinusoids, a radial bowl, random Gaussian bumps, and the slab
profiles with closed-form persistence diagrams that the persistence tests
use."""

from __future__ import annotations

import numpy as np


def sinusoid(freq: float = 0.5):
    """f = sin(fx)·sin(fy)·sin(fz): a periodic Morse function whose minima /
    maxima / saddles are known lattice points — used to sanity-check the
    critical point counts."""
    def fn(p):
        q = np.asarray(p, dtype=np.float64) * freq
        return (np.sin(q[:, 0]) * np.sin(q[:, 1]) * np.sin(q[:, 2])
                ).astype(np.float32)
    return fn


def radial(center=(0.0, 0.0, 0.0)):
    """f = |p - c|²: exactly one minimum (vertex nearest c), maxima on the
    domain boundary."""
    c = np.asarray(center, dtype=np.float64)

    def fn(p):
        d = np.asarray(p, dtype=np.float64) - c[None, :]
        return (d * d).sum(axis=1).astype(np.float32)
    return fn


def gaussians(seed: int = 0, k: int = 6, sigma: float = 6.0, scale=32.0):
    """Sum of k random Gaussian bumps — a generic multi-extremum field.
    Drawn from a numpy generator, so a seed gives the reference's field."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, scale, size=(k, 3))
    signs = rng.choice([-1.0, 1.0], size=k)

    def fn(p):
        p = np.asarray(p, dtype=np.float64)
        acc = np.zeros(len(p))
        for c, s in zip(centers, signs):
            d2 = ((p - c[None, :]) ** 2).sum(axis=1)
            acc += s * np.exp(-d2 / (2 * sigma * sigma))
        return acc.astype(np.float32)
    return fn


def axis_profile(xs, ys, axis=0):
    """f(p) = g(p[axis]) for the piecewise-linear profile g through control
    points (xs ascending, clamped beyond the ends).

    On a grid whose constant-``axis`` slabs are connected (every box /
    graded / sliver / holey family in ``data/meshgen.py``), the sublevel
    0-dimensional persistence diagram of f is EXACTLY the 1-D diagram of g
    sampled at the slab coordinates (:func:`profile_diagram0`) up to
    diagonal (zero-persistence) points: slabs share a value, components of
    {f <= t} are unions of slab runs, and merges happen at the pass slabs.
    This is the closed-form oracle the persistence tests pin the pipeline
    against."""
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    if len(xs) != len(ys) or len(xs) < 2:
        raise ValueError("need matching xs/ys with at least 2 control points")
    if (np.diff(xs) <= 0).any():
        raise ValueError("profile control xs must be strictly ascending")

    def fn(p):
        x = np.asarray(p, dtype=np.float64)[:, axis]
        return np.interp(x, xs, ys).astype(np.float32)
    return fn


def per_component(stride, base_fn, delta=0.0, axis=0):
    """Per-component field for ``data.meshgen.multi_component`` meshes:
    component j (points with ``p[axis] in [j*stride, j*stride + span]``,
    ``stride = meshgen.component_stride(nx, gap)``) sees ``base_fn`` in its
    local frame plus ``j * delta``. The diagram of the whole field is the
    disjoint union of the per-component diagrams, each shifted by
    ``j * delta`` — still closed form."""
    stride = float(stride)

    def fn(p):
        p = np.asarray(p, dtype=np.float64)
        j = np.floor(p[:, axis] / stride + 0.5 / stride)
        q = p.copy()
        q[:, axis] -= j * stride
        return (np.asarray(base_fn(q), np.float64) + j * delta) \
            .astype(np.float32)
    return fn


def profile_diagram0(values):
    """Exact sublevel 0-dim persistence of a PL function on a path graph,
    given its values at the path vertices — the closed-form oracle for
    :func:`axis_profile` fields (evaluate the profile at the mesh's slab
    coordinates and pass the sequence here).

    Elder rule with (value, index) tie-break. Returns ``(pairs, essential)``:
    ``pairs`` a float64 (m, 2) array of (birth, death) rows sorted by
    (death, birth), ``essential`` the sorted birth values of the classes
    that never die (one per path component — exactly one here)."""
    v = np.asarray(values, dtype=np.float64).reshape(-1)
    n = len(v)
    if n == 0:
        return np.zeros((0, 2)), np.zeros((0,))
    order = np.lexsort((np.arange(n), v))   # ascending (value, index)
    parent = np.arange(n)
    birth = v.copy()                        # birth value of each root's class
    active = np.zeros(n, bool)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    pairs = []
    for i in order:
        active[i] = True
        for j in (i - 1, i + 1):
            if 0 <= j < n and active[j]:
                a, b = find(i), find(j)
                if a == b:
                    continue
                # elder rule: the younger class (larger birth) dies at v[i]
                if (birth[a], a) < (birth[b], b):
                    a, b = b, a
                pairs.append((birth[a], v[i]))
                parent[a] = b
    roots = {find(i) for i in range(n)}
    essential = np.sort(np.array([birth[r] for r in roots]))
    pairs = np.array(sorted(pairs, key=lambda p: (p[1], p[0])), np.float64) \
        if pairs else np.zeros((0, 2))
    return pairs, essential


def with_sos_tiebreak(scalars: np.ndarray) -> np.ndarray:
    """Simulation-of-simplicity: make the field injective by breaking ties
    with the vertex index (order-preserving). Returns float64."""
    s = np.asarray(scalars, dtype=np.float64)
    n = len(s)
    span = np.ptp(s)
    span = span if span > 0 else 1.0
    eps = span * 1e-9
    return s + eps * (np.arange(n) / max(n, 1))
