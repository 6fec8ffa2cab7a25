"""The topological pipeline after the quickstart: critical points, the
discrete gradient and the Morse–Smale complex on one mesh, through one
engine; optionally the gradient's matching audit, persistence pairing and
persistence simplification of the complex.

  PYTHONPATH=src python -m repro_torch.analyze [--n 12] [--device cuda]
      [--workers N] [--audit] [--persistence THRESHOLD]
      [--assembly sparse|dense]

The mesh is the quickstart's (an ``n``³ grid with four Gaussian bumps). The
gradient co-prefetches the TT queue, so the completion kernels the
Morse–Smale step needs run behind the lower-star sweep. On a card the
relation blocks and the completion gather come from the CUDA kernels;
``--device cpu`` runs the plain torch arm. The discrete gradient must
satisfy the Morse–Euler identity (its critical cells' alternating sum
equals the mesh's Euler characteristic); the run fails otherwise.

``--audit`` adds FF to the engine and prints the cross-segment matching
audit (TT and FF completion; all zeros for a valid field).
``--persistence T`` prints the persistence pair counts and the diagram's
digest, then the Morse–Smale counts after cancelling every pair of
persistence below ``T``. ``--assembly dense`` sends every relation through
the dense counts fallback (the meet and VV count kernels on a card).
"""

from __future__ import annotations

import argparse
import time

from .algorithms import fields
from .algorithms.critical_points import critical_points, total_order
from .algorithms.discrete_gradient import audit_gradient, discrete_gradient
from .algorithms.morse_smale import morse_smale
from .algorithms.persistence import persistence_pairs, simplify_ms
from .core.engine import RelationEngine
from .core.mesh import segment_mesh
from .core.segtables import precondition
from .data.meshgen import structured_grid
from .kernels.ops import ASSEMBLIES

RELS = ["VV", "VE", "VF", "VT", "FT", "TT"]


def run(n: int = 12, device="cuda", workers: int = 1, audit: bool = False,
        assembly: str = "sparse"):
    """Critical points -> discrete gradient -> Morse–Smale complex at an
    ``n``³ grid. Returns ``(pre, chi, engine, cp_counts, grad, ms)``; with
    ``audit`` the engine also serves FF (for :func:`audit_gradient`)."""
    mesh = structured_grid(n, n, n, scalar_fn=fields.gaussians(
        0, k=4, sigma=3.0, scale=n))
    sm = segment_mesh(mesh, capacity=64)
    pre = precondition(sm, relations=RELS)
    chi = sm.n_vertices - pre.n_edges + pre.n_faces - sm.n_tets
    rank = total_order(sm.scalars)
    eng = RelationEngine(pre, RELS + ["FF"] if audit else RELS, lookahead=8,
                         dev_pool_segments=4096, device=device,
                         assembly=assembly)
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
    ap.add_argument("--audit", action="store_true",
                    help="print the gradient's matching audit")
    ap.add_argument("--persistence", type=float, default=None,
                    metavar="THRESHOLD",
                    help="pair by persistence and simplify below THRESHOLD")
    ap.add_argument("--assembly", choices=ASSEMBLIES,
                    default="sparse", help="relation-block assembly")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    pre, chi, eng, cp, grad, ms = run(args.n, device=args.device,
                                      workers=args.workers, audit=args.audit,
                                      assembly=args.assembly)
    report = diag = None
    if args.audit:
        report = audit_gradient(eng, pre, grad, workers=args.workers)
    if args.persistence is not None:
        diag = persistence_pairs(eng, pre, total_order(pre.smesh.scalars),
                                 grad=grad, workers=args.workers)
        simp, cancelled = simplify_ms(ms, diag, args.persistence)
    dt = time.perf_counter() - t0
    sm = pre.smesh
    print(f"mesh: v={sm.n_vertices} e={pre.n_edges} f={pre.n_faces} "
          f"t={sm.n_tets} chi={chi}")
    print("critical points:", cp)
    print("gradient:", grad.counts(), "euler:", grad.euler())
    print("morse-smale:", ms.counts())
    if report is not None:
        print("audit:", report)
    if diag is not None:
        print("persistence:", diag.counts(), "digest:", diag.digest())
        print(f"simplified at {args.persistence}:", simp.counts(),
              {k: v for k, v in cancelled.items() if k != "threshold"})
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
