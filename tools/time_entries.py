"""Time the VV and VE/VF/VT entry kernels of one tree of the port on one
NVIDIA card, three ways, at the shapes of ``PERF.md``'s rows 1 and 2.

    PYTHONPATH=src python tools/time_entries.py [--n 96] [--tag NAME]

The tree is whichever ``repro_torch`` the ``PYTHONPATH`` names, so two
commits compare in one call: unpack the parent into a directory that
``.gitignore`` lists (``git archive``) and run parent, change, change,
parent, each with ``PYTHONPATH=<tree>/src``. The timing helpers come from
this checkout's ``chip_smoke.py``.

Inputs: ``structured_grid(n, n, n)`` with the quickstart's field,
``segment_mesh(capacity=64)``, ``precondition(["VV", "VE", "VF", "VT"])``;
the first 64 segments' tables (NV 256, NE 1280, NF 1920, NT 896 at n = 48
and at n = 96), each relation at its default width. A tree whose wrapper
routes (``entry_route``) is timed on both routes, and the bitmask route
with its rows shared by 1 to 8 blocks a segment; an older tree on its one
kernel. Each by ``time_ms`` (the eager CUDA-event loop), ``graph_ms``
(CUDA-graph replay) and the profiler's kernel time. Prints one JSON line
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=96)
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
    sm = segment_mesh(structured_grid(n, n, n, scalar_fn=fields.gaussians(
        0, k=4, sigma=3.0, scale=n)), capacity=64)
    pre = precondition(sm, ["VV", "VE", "VF", "VT"])
    t = pre.tables
    out = {"tag": args.tag, "card": chip_smoke.nvidia_smi(), "n": n,
           "NV": t.NV, "NE": t.NE, "NF": t.NF, "NT": t.NT,
           "setup_s": round(time.perf_counter() - t0, 3)}
    cu = lambda a: torch.from_numpy(np.ascontiguousarray(a[:64])).to(dev)
    cases = {"VV": (t.T_local, t.LV_global), "VE": (t.E_local, t.LE_global),
             "VF": (t.F_local, t.LF_global), "VT": (t.T_local, t.LT_global)}
    routed = hasattr(sr, "entry_route")
    for relation, (tab, colg) in cases.items():
        tab, colg = cu(tab), cu(colg)
        deg = ops.DEFAULT_DEG[relation]
        want = ops.relation_block(relation, tab, tab, colg, t.NV, deg=deg,
                                  backend="torch")
        row = {}
        if not routed:
            row["kernel"] = three_ways(lambda: sr.relation_entries_cuda(
                relation, tab, tab, colg, nvl=t.NV, deg=deg), "_entries")
            out[relation] = row
            continue
        row["sort"] = three_ways(lambda: sr.relation_entries_cuda(
            relation, tab, tab, colg, nvl=t.NV, deg=deg, route="sort"),
            "_entries")
        chosen = sr.bits_row_blocks
        try:
            for blocks in (1, 2, 3, 4, 6, 8):
                sr.bits_row_blocks = lambda B, R, sms, k=blocks: k
                fn = (lambda: sr.relation_entries_cuda(
                    relation, tab, tab, colg, nvl=t.NV, deg=deg,
                    route="bits"))
                got = fn()
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise SystemExit(f"{relation}: the bitmask kernel at "
                                     f"{blocks} blocks a segment disagrees "
                                     f"with the plain arm")
                row[f"bits_{blocks}"] = three_ways(fn, "_bits")
        finally:
            sr.bits_row_blocks = chosen
        row["bits_blocks_chosen"] = chosen(64, t.NV, torch.cuda
                                           .get_device_properties(dev)
                                           .multi_processor_count)
        out[relation] = row
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
