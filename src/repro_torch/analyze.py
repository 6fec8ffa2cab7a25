"""The topological pipeline after the quickstart: critical points, the
discrete gradient and the Morse–Smale complex on one mesh, through one
engine.

  PYTHONPATH=src python -m repro_torch.analyze [--n 12] [--device cuda]
                                               [--workers N]

The mesh is the quickstart's (an ``n``³ grid with four Gaussian bumps). The
gradient co-prefetches the TT queue, so the completion kernels the
Morse–Smale step needs run behind the lower-star sweep. On a card the
relation blocks and the completion gather come from the CUDA kernels;
``--device cpu`` runs the plain torch arm. The discrete gradient must
satisfy the Morse–Euler identity (its critical cells' alternating sum
equals the mesh's Euler characteristic); the run fails otherwise.
"""

from __future__ import annotations

import argparse
import time

from .algorithms import fields
from .algorithms.critical_points import critical_points, total_order
from .algorithms.discrete_gradient import discrete_gradient
from .algorithms.morse_smale import morse_smale
from .core.engine import RelationEngine
from .core.mesh import segment_mesh
from .core.segtables import precondition
from .data.meshgen import structured_grid

RELS = ["VV", "VE", "VF", "VT", "FT", "TT"]


def run(n: int = 12, device="cuda", workers: int = 1):
    """Critical points -> discrete gradient -> Morse–Smale complex at an
    ``n``³ grid. Returns ``(pre, chi, engine, cp_counts, grad, ms)``."""
    mesh = structured_grid(n, n, n, scalar_fn=fields.gaussians(
        0, k=4, sigma=3.0, scale=n))
    sm = segment_mesh(mesh, capacity=64)
    pre = precondition(sm, relations=RELS)
    chi = sm.n_vertices - pre.n_edges + pre.n_faces - sm.n_tets
    rank = total_order(sm.scalars)
    eng = RelationEngine(pre, RELS, lookahead=8, dev_pool_segments=4096,
                         device=device)
    _, cp = critical_points(eng, pre, rank, batch_segments=16,
                            workers=workers)
    # co-prefetch the TT queue: completion kernels for the Morse-Smale
    # step execute behind the lower-star sweep (DESIGN.md §6)
    grad = discrete_gradient(eng, pre, rank, batch_segments=16,
                             co_prefetch=("TT",), workers=workers)
    ms = morse_smale(eng, pre, grad, workers=workers)
    if grad.euler() != chi:
        raise AssertionError(f"Morse-Euler identity violated: "
                             f"{grad.euler()} != chi {chi}")
    return pre, chi, eng, cp, grad, ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=12, help="grid vertices per axis")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--workers", type=int, default=1,
                    help="consumer threads per driver (DESIGN.md §8)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    pre, chi, eng, cp, grad, ms = run(args.n, device=args.device,
                                      workers=args.workers)
    dt = time.perf_counter() - t0
    sm = pre.smesh
    print(f"mesh: v={sm.n_vertices} e={pre.n_edges} f={pre.n_faces} "
          f"t={sm.n_tets} chi={chi}")
    print("critical points:", cp)
    print("gradient:", grad.counts(), "euler:", grad.euler())
    print("morse-smale:", ms.counts())
    s = eng.stats
    print(f"engine: {s.kernel_launches} launches for {s.segments_produced} "
          f"segments produced, {s.devpool_hits} device-pool hits + "
          f"{s.devpool_uploads} uploads of {s.requests} block reads")
    print(f"completion: {s.completion_queries} queries over "
          f"{s.completion_fanout_blocks} blocks, "
          f"{s.completion_raw_neighbors} raw -> {s.completion_neighbors} "
          f"neighbours (dedup ratio {s.completion_dedup_ratio:.3f})")
    print(f"wall: {dt:.2f} s on {eng.device}")


if __name__ == "__main__":
    main()
