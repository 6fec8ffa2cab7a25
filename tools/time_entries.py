"""Time the VV, VE/VF/VT and EF/ET/FT entry kernels of one tree of the port
on one NVIDIA card, three ways, at the shapes of ``PERF.md``'s rows 1, 2
and 4.

    PYTHONPATH=src python tools/time_entries.py [--n 96] [--big]
        [--capacity 1024] [--big-rels VV,VT,EF,ET] [--rels VV,VE,VF,VT,EF,
        ET,FT] [--counts] [--tag NAME]

The tree is whichever ``repro_torch`` the ``PYTHONPATH`` names, so two
commits compare in one call: unpack the parent into a directory that
``.gitignore`` lists (``git archive``) and run parent, change, change,
parent, each with ``PYTHONPATH=<tree>/src``. The timing helpers come from
this checkout's ``chip_smoke.py``.

Inputs: ``structured_grid(n, n, n)`` with the quickstart's field,
``segment_mesh(capacity=64)``, ``precondition`` of the seven relations;
the first 64 segments' tables (NV 256, NE 1280, NF 1920, NT 896 at n = 48
and at n = 96), each relation at its default width. With ``--big``, also
the 48^3 mesh at ``segment_mesh(capacity=C)``, C from ``--capacity``
(1024: NV 2048, NE 11,520, NF 18,048, NT 8576, 108 segments; 8192: NV
11,008, NE 68,480, NF 111,616, NT 54,016, 14 segments, where VF takes
the sort route), its first 64 segments' tables of the relations of
``--big-rels`` (by default VV and VT), and, when VV and VT are among
them, that mesh's critical-points path on the kernels (three runs after a
warm-up: wall, ``t_sync``, ``t_kernel``, launches). With ``--counts``, also the VV count kernel
(``relation_counts_vv_cuda``) on the first 64 and the first 8 segments'
tets (``PERF.md``'s rows 7 and 7b), at the wrapper's row tile and, where
the tree offers ``rows=``, at each one. Each arm that
the tree routes (``entry_route``; the sub-join where ``LAUNCHES`` counts
``"sub_bits"``) is timed on both routes, the bitmask route with each
segment's rows shared by 1 to 8 blocks (up to 22 on the capacity-1024
tables), each share count as the wrapper launches it (``bits_shares``:
never fewer than fit); an arm the tree does not route on its one
kernel. Each by ``time_ms`` (the eager CUDA-event loop),
``graph_ms`` (CUDA-graph replay) and the profiler's kernel time a call,
also by kernel (``passes_ms``: the VV and member sort route runs four),
after a check that the blocks equal the plain arm's.
Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
from time_tt_gather import three_ways  # noqa: E402

RELS = ["VV", "VE", "VF", "VT", "EF", "ET", "FT"]
SHARES = (1, 2, 3, 4, 6, 8)
BIG_SHARES = SHARES + (11, 12, 16, 22)


def cases(tables, rels):
    """relation -> (subject table, coface table, column map): VV the tets
    twice with the vertex map; member the vertex table and the coface
    table; the sub-join its two tables."""
    t = tables
    tab = {"V": t.table("V")[0], "E": t.E_local, "F": t.F_local,
           "T": t.T_local}
    glob = {"V": t.LV_global, "E": t.LE_global, "F": t.LF_global,
            "T": t.LT_global}
    out = {}
    for rel in rels:
        if rel == "VV":
            out[rel] = (tab["T"], tab["T"], glob["V"])
        else:
            out[rel] = (tab[rel[0]], tab[rel[1]], glob[rel[1]])
    return out


def time_arm(sr, ops, dev, relation, tx, ty, colg, nvl, shares):
    cu = lambda a: torch.from_numpy(np.ascontiguousarray(a[:64])).to(dev)
    tx, ty, colg = cu(tx), cu(ty), cu(colg)
    deg = ops.DEFAULT_DEG[relation]
    want = ops.relation_block(relation, tx, ty, colg, nvl, deg=deg,
                              backend="torch")
    sub = relation in ("EF", "ET", "FT")
    routed = (hasattr(sr, "entry_route") and not sub) or \
        (sub and "sub_bits" in sr.LAUNCHES)
    launch = (lambda route=None: sr.relation_entries_cuda(
        relation, tx, ty, colg, nvl=nvl, deg=deg,
        **({"route": route} if route else {})))

    def checked(fn, what):
        got = fn()
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"{relation}: {what} disagrees with the plain "
                             f"arm")

    if not routed:
        checked(launch, "the kernel")
        return {"kernel": three_ways(launch, "_entries")}
    row = {}
    checked(lambda: launch("sort"), "the sort kernel")
    row["sort"] = three_ways(lambda: launch("sort"), "_entries")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    limit = sr.smem_limit(dev)
    if hasattr(sr, "bits_rows_fit"):
        R = tx.shape[1] if sub else nvl
        # the tree's fit: by the lookup of all NX keys where it takes NX
        nx = (tx.shape[1] if sub else 0,) if "NX" in inspect.signature(
            sr.bits_rows_fit).parameters else ()
        fit = sr.bits_rows_fit(relation, nvl, ty.shape[1], limit, *nx)
        if not fit:
            return row
        plan = lambda k: sr.bits_shares(relation, tx.shape[0], R, fit, sms)
    else:
        if sr.entry_route(relation, nvl, ty.shape[1], limit) != "bits":
            return row
        plan = lambda k: k or sr.bits_row_blocks(tx.shape[0], nvl, sms)
    # the tree's share rule, replaced by each forced count in turn
    rule = "sub_row_blocks" if sub and hasattr(sr, "sub_row_blocks") \
        else "bits_row_blocks"
    chosen = getattr(sr, rule)
    row["bits_shares_chosen"] = plan(None)
    done = set()
    try:
        for blocks in shares:
            setattr(sr, rule, lambda B, R, sms, k=blocks: k)
            got = plan(blocks)
            if got in done:
                continue
            done.add(got)
            checked(lambda: launch("bits"), f"the bitmask kernel at {got} "
                                            f"blocks a segment")
            row[f"bits_{got}"] = three_ways(lambda: launch("bits"), "_bits")
    finally:
        setattr(sr, rule, chosen)
    return row


def time_counts(sr, ops, dev, T_local, nvl):
    """The VV count kernel on the first 64 and the first 8 segments' tets,
    each held against the plain arm first; where the tree's wrapper takes
    ``rows``, also at each row tile it offers."""
    tiles = [None] + list(getattr(sr, "VV_COUNT_ROWS", ()))
    row = {}
    for B in (64, 8):
        T = torch.from_numpy(np.ascontiguousarray(T_local[:B])).to(dev)
        want = ops.counts_vv(T, nvl, backend="torch")
        for rows in tiles:
            kw = {"rows": rows} if rows else {}
            launch = lambda kw=kw: sr.relation_counts_vv_cuda(T, nvl, **kw)
            got = launch()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"vv_counts at B={B}, rows={rows} "
                                 f"disagrees with the plain arm")
            key = f"B{B}" + (f"_rows{rows}" if rows else "")
            row[key] = three_ways(launch, "vv_counts")
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=96)
    ap.add_argument("--big", action="store_true",
                    help="also the 48^3 mesh at --capacity")
    ap.add_argument("--capacity", type=int, default=1024,
                    help="the segment capacity of --big's 48^3 mesh")
    ap.add_argument("--big-rels", default="VV,VT",
                    help="the relations timed at that capacity")
    ap.add_argument("--counts", action="store_true",
                    help="also the VV count kernel at B = 64 and B = 8")
    ap.add_argument("--rels", default=",".join(RELS),
                    help="the relations timed at capacity 64")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card: torch.cuda.is_available() "
                         "is False")
    from repro_torch.algorithms import fields
    from repro_torch.core.mesh import segment_mesh
    from repro_torch.core.segtables import precondition
    from repro_torch.data.meshgen import structured_grid
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_relations as sr

    dev = torch.device("cuda")
    n = args.n
    t0 = time.perf_counter()
    mesh = lambda n: structured_grid(n, n, n, scalar_fn=fields.gaussians(
        0, k=4, sigma=3.0, scale=n))
    pre = precondition(segment_mesh(mesh(n), capacity=64), RELS)
    t = pre.tables
    out = {"tag": args.tag, "card": chip_smoke.nvidia_smi(), "n": n,
           "NV": t.NV, "NE": t.NE, "NF": t.NF, "NT": t.NT,
           "setup_s": round(time.perf_counter() - t0, 3)}
    rels = [r for r in args.rels.split(",") if r]
    for relation, (tx, ty, colg) in cases(t, rels).items():
        out[relation] = time_arm(sr, ops, dev, relation, tx, ty, colg, t.NV,
                                 SHARES)
    if args.counts:
        out["vv_counts"] = time_counts(sr, ops, dev, t.T_local, t.NV)
    big_rels = args.big_rels.split(",")
    if args.big:
        bsm = segment_mesh(mesh(48), capacity=args.capacity)
        bpre = precondition(bsm, big_rels)
        bt = bpre.tables
        big = {"capacity": args.capacity, "segments": bsm.n_segments,
               "NV": bt.NV, "NE": bt.NE, "NF": bt.NF, "NT": bt.NT}
        for relation, (tx, ty, colg) in cases(bt, big_rels).items():
            big[relation] = time_arm(sr, ops, dev, relation, tx, ty, colg,
                                     bt.NV, BIG_SHARES)
        out[f"capacity_{args.capacity}"] = big
    if args.big and {"VV", "VT"} <= set(big_rels):
        from repro_torch.algorithms.critical_points import \
            critical_points, total_order
        from repro_torch.core.engine import RelationEngine

        rank = total_order(bpre.smesh.scalars)
        runs = []
        for i in range(4):                       # the first is a warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng = RelationEngine(bpre, ["VV", "VT"], lookahead=8,
                                 device="cuda")
            critical_points(eng, bpre, rank)
            torch.cuda.synchronize()
            if i:
                runs.append({"wall_s": time.perf_counter() - t0,
                             "t_sync_s": eng.stats.t_sync,
                             "t_kernel_s": eng.stats.t_kernel,
                             "launches": eng.stats.kernel_launches})
        big["critical_points_path"] = runs
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
