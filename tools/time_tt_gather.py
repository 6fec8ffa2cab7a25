"""Time the TT entry kernel and the completion gather kernel of one tree of
the port on one NVIDIA card, three ways, at the shapes of ``PERF.md``'s
rows 3 and 5.

    PYTHONPATH=src python tools/time_tt_gather.py [--n 96] [--tag NAME]

The tree is whichever ``repro_torch`` the ``PYTHONPATH`` names, so two
commits compare in one call: unpack the parent into a directory that
``.gitignore`` lists (``git archive``) and run parent, change, change,
parent, each with ``PYTHONPATH=<tree>/src``. The timing helpers come from
this checkout's ``chip_smoke.py``.

Inputs: ``structured_grid(n, n, n)`` with the quickstart's field,
``segment_mesh(capacity=64)``, ``precondition(["FT", "TT"])``. TT: the
first 64 segments' tets (NT = 896 at n = 96), deg 8. Gather: the TT
completion chunk of 1024 seeded tet ids (``plan_completion``, the pool from
``get_full_dev_batch``, pairs padded to a power of two), the T inverse
maps. Each kernel is timed by ``time_ms`` (the eager CUDA-event loop),
``graph_ms`` (CUDA-graph replay) and the profiler's kernel time; the
eager loop shows the wrapper's host cost when the kernel is faster than
it. Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import inspect
import json
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402


def kernels_ms(fn, name: str, reps: int = 20) -> dict:
    """Device time one call of ``fn`` spends in each kernel whose name holds
    ``name`` (by its short name, template arguments kept: a wrapper whose
    call runs several passes shows each), from ``torch.profiler``; empty
    when it records none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if name in ev.key:
            short = re.search(r"\w+(<[^()]*>)?(?=\()", ev.key)
            key = short.group(0) if short else ev.key
            out[key] = out.get(key, 0.0) + getattr(
                ev, "device_time_total", 0.0) / reps / 1e3
    return out


def three_ways(fn, name: str) -> dict:
    """``fn`` timed by the eager loop, graph replay and the profiler, and the
    profiler's time of each kernel a call runs (``passes_ms``)."""
    per = kernels_ms(fn, name)
    return {"eager_ms": chip_smoke.time_ms(torch, fn),
            "graph_ms": chip_smoke.graph_ms(torch, fn),
            "profiler_ms": sum(per.values()) if per else None,
            "passes_ms": per}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=96)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card: torch.cuda.is_available() "
                         "is False")
    from repro_torch.algorithms import fields
    from repro_torch.core.adjacency import plan_completion
    from repro_torch.core.engine import RelationEngine
    from repro_torch.core.mesh import segment_mesh
    from repro_torch.core.segtables import precondition
    from repro_torch.data.meshgen import structured_grid
    from repro_torch.kernels import completion_gather as cg
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_relations as sr

    dev = torch.device("cuda")
    n = args.n
    t0 = time.perf_counter()
    sm = segment_mesh(structured_grid(n, n, n, scalar_fn=fields.gaussians(
        0, k=4, sigma=3.0, scale=n)), capacity=64)
    pre = precondition(sm, ["FT", "TT"])      # faces: the plan's lookups
    tabs = pre.tables
    out = {"tag": args.tag, "card": chip_smoke.nvidia_smi(), "n": n,
           "NT": tabs.NT, "setup_s": round(time.perf_counter() - t0, 3)}

    cu = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    T, colg = cu(tabs.T_local[:64]), cu(tabs.LT_global[:64])
    out["TT"] = three_ways(lambda: sr.relation_entries_cuda(
        "TT", T, T, colg, nvl=tabs.NV, deg=8), "tt_entries")

    eng = RelationEngine(pre, ["TT"], device="cuda")
    ids = np.sort(np.random.default_rng(0).choice(sm.n_tets, 1024,
                                                  replace=False))
    plan = plan_completion(eng, "TT", ids, prefetch=False)
    pool_M, pool_L = eng.get_full_dev_batch(
        "TT", plan.segments, pad_to=ops.bucket_rows(len(plan.segments)))
    inv_seg, inv_gid, inv_row, inv_key, _ = eng.dev_inverse("T")
    P = len(plan.pair_seg)
    P_pad = ops.bucket_rows(P)
    slot = np.full(P_pad, -1, np.int32)
    slot[:P] = np.searchsorted(plan.segments, plan.pair_seg)
    seg = np.zeros(P_pad, np.int32)
    seg[:P] = plan.pair_seg
    gid = np.full(P_pad, -1, np.int32)
    gid[:P] = plan.ids[plan.pair_query]
    pairs = (cu(slot), cu(seg), cu(gid))
    kw = {}
    if "inv_start" in inspect.signature(cg.resolve_gather_cuda).parameters:
        kw["inv_start"] = eng.dev_inverse_starts("T")   # absent before it
    out["gather"] = {"pairs": P_pad, "K": int(inv_seg.shape[0]),
                     "key_staged": inv_key is not None, **three_ways(
                         lambda: cg.resolve_gather_cuda(
                             pool_M, pool_L, inv_seg, inv_gid, inv_row,
                             *pairs, **kw), "resolve_gather")}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
