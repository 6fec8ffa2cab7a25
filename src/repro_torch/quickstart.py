"""Quickstart: build a mesh, stand up GALE, extract critical points.

  PYTHONPATH=src python -m repro_torch.quickstart [--n 12] [--device cuda]

On a card the relation blocks come from the CUDA kernels; ``--device cpu``
runs the plain torch arm.
"""

from __future__ import annotations

import argparse

from .algorithms import fields
from .algorithms.critical_points import critical_points, total_order
from .core.engine import RelationEngine
from .core.mesh import segment_mesh
from .core.segtables import precondition
from .data.meshgen import structured_grid


def run(n: int = 12, device="cuda", backend=None, workers: int = 1):
    """The quickstart's main path at an ``n``³ grid: returns the engine,
    the per-vertex types and the counts."""
    # 1. A tetrahedral mesh with a scalar field (4 Gaussian bumps).
    mesh = structured_grid(n, n, n,
                           scalar_fn=fields.gaussians(0, k=4, sigma=3.0,
                                                      scale=n))
    # 2. Segment (localized PR-octree leaves) + preconditioning: only the
    #    relations the algorithm needs (paper: VV + VT for critical points).
    sm = segment_mesh(mesh, capacity=64)
    pre = precondition(sm, relations=["VV", "VT"])
    # 3. GALE: the task-parallel relation engine.
    gale = RelationEngine(pre, ["VV", "VT"], lookahead=8, device=device,
                          backend=backend)
    # 4. Run the consumer algorithm.
    types, counts = critical_points(gale, pre, total_order(sm.scalars),
                                    workers=workers)
    return mesh, gale, types, counts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=12, help="grid vertices per axis")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    mesh, gale, _, counts = run(args.n, device=args.device)
    print(f"mesh: {mesh.n_vertices} vertices, {mesh.n_tets} tets")
    print("critical points:", counts)
    s = gale.stats
    print(f"engine: {s.kernel_launches} launches for "
          f"{s.segments_produced} segments produced, "
          f"{s.cache_hits} hits / {s.cache_misses} misses")


if __name__ == "__main__":
    main()
