"""Full TDA pipeline (the paper's four algorithms) on one named dataset,
with a GALE vs Explicit-Triangulation comparison — the results must be
identical.

  PYTHONPATH=src python -m repro_torch.analyze_mesh [dataset] [--workers N]
      [--shards K] [--simplify T] [--device cuda|cpu]

Both structures run the device-resident consumer arm: the drivers read
relation blocks as ConsumerBatch tensors (``get_full_dev_many``); the GALE
engine serves every read from its device block pool, the explicit
structure uploads its precomputed rows. ``--workers N`` runs the drivers'
consumer arms on N threads, and ``--shards K`` splits the GALE engine's
segments into K shards (docs/DESIGN.md §9: shard-pure launches, per-shard
pools, the sharded completion exchange; on one card or the CPU, as K
logical shards); results are bit-identical for any N and K.
``--simplify T`` also cancels every persistence pair below threshold T and
reports the simplified Morse–Smale complex. On a card GALE's relation
blocks and completion gathers come from the CUDA kernels; ``--device cpu``
runs the plain torch arm.
"""

from __future__ import annotations

import argparse
import time

from .algorithms import fields
from .algorithms.critical_points import critical_points, total_order
from .algorithms.discrete_gradient import discrete_gradient
from .algorithms.morse_smale import morse_smale
from .algorithms.persistence import persistence_pairs, simplify_ms
from .core.engine import RelationEngine
from .core.explicit import ExplicitTriangulation
from .core.mesh import segment_mesh
from .core.segtables import precondition
from .data.meshgen import load_dataset

RELS = ["VV", "VE", "VF", "VT", "FT", "TT"]


def run(name: str = "foot", workers: int = 1, simplify=None, device="cuda",
        shards: int = 1):
    """Both rows on dataset ``name``. Returns ``(header, rows)``: the mesh's
    sizes and Euler characteristic, and per structure (``"GALE"``,
    ``"Explicit"``) a dict of its results, wall and stats. ``shards``
    applies to the GALE engine."""
    mesh = load_dataset(name, scalar_fn=fields.gaussians(2, k=5, sigma=5.0))
    sm = segment_mesh(mesh, capacity=64)
    pre = precondition(sm, relations=RELS)
    rank = total_order(sm.scalars)
    chi = sm.n_vertices - pre.n_edges + pre.n_faces - sm.n_tets
    header = {"name": name, "v": sm.n_vertices, "e": pre.n_edges,
              "f": pre.n_faces, "t": sm.n_tets, "chi": chi}
    rows = {}
    for label, make in (
            ("GALE", lambda: RelationEngine(pre, RELS, lookahead=8,
                                            dev_pool_segments=4096,
                                            device=device, shards=shards)),
            ("Explicit", lambda: ExplicitTriangulation(pre, RELS,
                                                       device=device))):
        ds = make()
        t0 = time.perf_counter()
        _, cp = critical_points(ds, pre, rank, batch_segments=16,
                                workers=workers)
        # co-prefetch the TT queue: completion kernels for the Morse-Smale
        # step execute behind the lower-star sweep (DESIGN.md §6)
        g = discrete_gradient(ds, pre, rank, batch_segments=16,
                              co_prefetch=("TT",), workers=workers)
        ms = morse_smale(ds, pre, g, workers=workers)
        diag = persistence_pairs(ds, pre, rank, grad=g, workers=workers)
        row = {"ds": ds, "critical": cp, "gradient": g.counts(),
               "ms": ms.counts(), "euler": g.euler(), "diagram": diag,
               "persistence": diag.counts(), "digest": diag.digest()}
        if simplify is not None:
            row["simplified"] = simplify_ms(ms, diag, simplify)[1]
        row["wall_s"] = time.perf_counter() - t0
        if g.euler() != chi:
            raise AssertionError(f"{label}: Morse-Euler identity violated: "
                                 f"{g.euler()} != chi {chi}")
        rows[label] = row
    return header, rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dataset", nargs="?", default="foot")
    ap.add_argument("--workers", type=int, default=1,
                    help="consumer threads per driver (DESIGN.md §8)")
    ap.add_argument("--shards", type=int, default=1,
                    help="segment shards on the GALE engine (DESIGN.md §9)")
    ap.add_argument("--simplify", type=float, default=None, metavar="T",
                    help="cancel persistence pairs below threshold T and "
                         "report the simplified MS complex (DESIGN.md §10)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    h, rows = run(args.dataset, workers=args.workers,
                  simplify=args.simplify, device=args.device,
                  shards=args.shards)
    print(f"{h['name']}: v={h['v']} e={h['e']} f={h['f']} t={h['t']}  "
          f"chi={h['chi']}")
    for label, r in rows.items():
        s = r["ds"].stats
        print(f"[{label:9s}] {r['wall_s']:6.2f}s  critical={r['critical']}  "
              f"gradient={r['gradient']}  ms={r['ms']}")
        pd = r["persistence"]
        pers = r["diagram"].persistence0()
        print(f"            persistence: {pd['pairs0']} dim-0 pairs "
              f"(max pers {pers.max() if len(pers) else 0:.3f}), "
              f"{pd['pairs2']} dim-2 pairs, "
              f"{pd['essential0']} essential component(s)  "
              f"digest={r['digest'][:12]}")
        if "simplified" in r:
            rep = r["simplified"]
            print(f"            simplified @ {args.simplify:g}: "
                  f"cancelled {rep['cancelled0']}+{rep['cancelled2']} pairs, "
                  f"minima {rep['minima_before']}->{rep['minima_after']}, "
                  f"maxima {rep['maxima_before']}->{rep['maxima_after']}")
        print(f"            consumer: {s.requests} block reads = "
              f"{s.devpool_hits} device-pool hits + "
              f"{s.devpool_uploads} uploads "
              f"(host reads: {s.requests - s.devpool_hits - s.devpool_uploads})"
              f"  t_sync={s.t_sync:.3f}s")
    a, b = rows["GALE"], rows["Explicit"]
    for key in ("critical", "gradient", "ms", "persistence", "digest"):
        if a[key] != b[key]:
            raise AssertionError(f"GALE and Explicit differ in {key}: "
                                 f"{a[key]} != {b[key]}")


if __name__ == "__main__":
    main()
