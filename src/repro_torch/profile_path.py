"""Where a path's time goes on a card.

    PYTHONPATH=src python -m repro_torch.profile_path [--n 96] [--profile-n 48]
                  [--path critical_points|gradient_ms|audit_persistence]

``--path critical_points`` (the default) runs ``critical_points`` on an
engine over VV/VT; ``--path gradient_ms`` runs ``discrete_gradient
(co_prefetch=("TT",))`` -> ``morse_smale`` on an engine over
VE/VF/VT/FT/TT; ``--path audit_persistence`` runs ``discrete_gradient
(audit=True)`` -> ``morse_smale`` -> ``persistence_pairs`` ->
``simplify_ms`` (threshold 0.05) on an engine over VE/VF/VT/FT/TT/FF, the
audit's FF blocks coming from the dense counts fallback. Prints one JSON
line per measurement:

  - ``turns``: after a warm-up of both arms on a 16³ mesh, the path
    at ``n``³ in turns — kernels (``backend="cuda"``), plain torch, plain
    torch, kernels — each with its wall time (host clock, ending in a
    device synchronise) and the engine's stats;
  - ``device``: one kernels-arm run at ``profile_n``³ under
    ``torch.profiler``: the device's busy time (sum of kernel self times)
    over the wall, and the kernels with the most device time;
  - ``host``: the same run under ``cProfile``: the host functions with the
    most own time (cProfile slows Python code, not device work, so read it
    for the ranking, not for absolute times).

Needs a card: it measures device behaviour and never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import subprocess
import time

import torch

from .algorithms import fields
from .algorithms.critical_points import critical_points, total_order
from .algorithms.discrete_gradient import discrete_gradient
from .algorithms.morse_smale import morse_smale
from .algorithms.persistence import persistence_pairs, simplify_ms
from .core.engine import RelationEngine
from .core.mesh import segment_mesh
from .core.segtables import precondition
from .data.meshgen import structured_grid


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


_RELS = {"critical_points": ["VV", "VT"],
         "gradient_ms": ["VE", "VF", "VT", "FT", "TT"],
         "audit_persistence": ["VE", "VF", "VT", "FT", "TT", "FF"]}


def _prepare(n: int, path: str):
    mesh = structured_grid(n, n, n, scalar_fn=fields.gaussians(
        0, k=4, sigma=3.0, scale=n))
    sm = segment_mesh(mesh, capacity=64)
    return sm, precondition(sm, relations=_RELS[path])


def _run(pre, rank, backend: str, path: str):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if path == "critical_points":
        eng = RelationEngine(pre, _RELS[path], lookahead=8, device="cuda",
                             backend=backend)
        _, counts = critical_points(eng, pre, rank)
    else:
        eng = RelationEngine(pre, _RELS[path], lookahead=8,
                             dev_pool_segments=4096, device="cuda",
                             backend=backend)
        g = discrete_gradient(eng, pre, rank, batch_segments=16,
                              co_prefetch=("TT",),
                              audit=path == "audit_persistence")
        ms = morse_smale(eng, pre, g)
        counts = {**g.counts(), **ms.counts()}
        if path == "audit_persistence":
            d = persistence_pairs(eng, pre, rank, grad=g)
            counts.update(d.counts())
            counts["simplified"] = simplify_ms(ms, d, 0.05)[0].counts()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, eng.stats, counts


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=96)
    ap.add_argument("--profile-n", type=int, default=48)
    ap.add_argument("--path", choices=sorted(_RELS),
                    default="critical_points")
    args = ap.parse_args(argv)
    path = args.path
    if not torch.cuda.is_available():
        raise RuntimeError("profile_path measures a card; none is present")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()

    sm, pre = _prepare(16, path)
    rank = total_order(sm.scalars)
    for backend in ("cuda", "torch"):       # warm-up: loads, allocator
        _run(pre, rank, backend, path)

    sm, pre = _prepare(args.n, path)
    rank = total_order(sm.scalars)
    for backend in ("cuda", "torch", "torch", "cuda"):
        wall, s, counts = _run(pre, rank, backend, path)
        _emit({"measure": "turns", "path": path, "n": args.n,
               "backend": backend,
               "wall_s": wall, "kernel_launches": s.kernel_launches,
               "segments_produced": s.segments_produced,
               "t_kernel_s": s.t_kernel, "t_sync_s": s.t_sync,
               "t_prepare_s": s.t_prepare, "t_integrate_s": s.t_integrate,
               "counts": counts, "gpu": smi})

    sm, pre = _prepare(args.profile_n, path)
    rank = total_order(sm.scalars)
    _run(pre, rank, "cuda", path)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall, _, _ = _run(pre, rank, "cuda", path)
    ev = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    busy = sum(dev_us(e) for e in ev) / 1e6
    top = sorted(ev, key=dev_us, reverse=True)[:12]
    _emit({"measure": "device", "path": path, "n": args.profile_n,
           "wall_s": wall,
           "device_busy_s": busy, "idle_share": 1 - busy / wall,
           "top_device": [{"name": e.key[:80], "count": e.count,
                           "ms": dev_us(e) / 1e3} for e in top],
           "gpu": smi})

    prof_host = cProfile.Profile()
    prof_host.enable()
    wall, _, _ = _run(pre, rank, "cuda", path)
    prof_host.disable()
    st = pstats.Stats(prof_host).stats
    rows = sorted(st.items(), key=lambda kv: kv[1][2], reverse=True)[:15]
    _emit({"measure": "host", "path": path, "n": args.profile_n,
           "wall_s": wall,
           "top_own_s": [{"fn": f"{k[0].rsplit('/', 1)[-1]}:{k[1]}:{k[2]}",
                          "calls": v[1], "own_s": v[2], "cum_s": v[3]}
                         for k, v in rows], "gpu": smi})


if __name__ == "__main__":
    main()
