"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    PYTHONPATH=src python3 chip_smoke.py        # from the repository root

Phases, one JSON line each:

  1. device: the card, the kernel build from ``src/repro_torch/kernels/csrc``
     (nvcc, sm_90a) and its ptxas report.
  2. kernels: each CUDA kernel arm held bit for bit against its plain torch
     version on the card, at the main path's shapes (B=64, NT=896, NV=256,
     real tables of the 96^3 mesh) and on edge cases (B=1; prime sizes
     1/7/127; a fully valid lane vector; rows with L > deg; lanes too large
     for shared memory, which run from a device workspace). Times from CUDA
     events beside the bytes bound and the plain version's time.
  3. main path: ``structured_grid(96, 96, 96)`` with the quickstart's
     Gaussian field -> ``segment_mesh(capacity=64)`` -> ``precondition``
     -> ``RelationEngine(backend="cuda")`` -> ``critical_points``, with the
     kernels' launch counters zeroed just before and read just after; the
     same run on the plain torch arm must give identical ``types``, and the
     counts must equal the JAX reference's (pinned below).

Then the ``{"kernels": [...]}`` summary, the ``nvidia-smi`` name and power
limit, and the final ``{"ok": true, ...}`` line. Any failure exits non-zero
before that line; without a card it exits non-zero and prints no result.
"""

from __future__ import annotations

import hashlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N = 96                       # grid vertices per axis on the main path
BATCH = 64                   # the engine's batch_max: the launch shape

# The JAX reference at N=96 (xla arm, tune="off", device consumer arm, one
# worker), computed on a CPU with:
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c '<build the quickstart mesh at
#   n=96; RelationEngine(pre, ["VV","VT"], lookahead=8, backend="xla",
#   tune="off"); critical_points(...)>'
# -> 1728 launches, 27648 segments produced.
REF_COUNTS = {"minima": 322, "saddles1": 570, "saddles2": 345, "maxima": 23,
              "degenerate": 0, "regular": 883476}
REF_TYPES_SHA256 = ("46b39eccfd74eda185ac49442a81d318"
                    "a3959b05cadcc3b0239aa12a294395bd")

# H100 SXM peaks (NVIDIA data sheet, as tabled in the on-chip measurement
# notes): HBM3 bytes/s, and the float32 non-tensor rate, the table's closest
# entry for the kernels' int32 compare/select work.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12

KERNELS = {
    "VV": {"name": "vv_entries_kernel", "arm": "VV", "relation": "VV",
           "replaces": "src/repro/kernels/segment_relations.py:360"},
    "member": {"name": "member_entries_kernel", "arm": "member",
               "relation": "VT",
               "replaces": "src/repro/kernels/segment_relations.py:343"},
}
SOURCE = "src/repro_torch/kernels/csrc/segment_relations.cu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Failed(Exception):
    pass


def check(cond, msg) -> None:
    if not cond:
        raise Failed(msg)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back
    calls, from CUDA events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1) / reps)
    out.sort()
    return out[len(out) // 2]


def bound_ms(tab, colg, M, L, valid_per_segment) -> tuple:
    """Least time for the work: each input read once and each output
    written once at the HBM rate, or the comparisons a comparison sort of
    this run's valid entries needs (n log2 n per segment) at the int32
    proxy rate, whichever is larger."""
    nbytes = sum(t.numel() * t.element_size() for t in (tab, colg, M, L))
    ops = sum(n * math.log2(n) for n in valid_per_segment if n > 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise Failed("torch.cuda.is_available() is False: needs an NVIDIA "
                     "card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise Failed(f"no src/repro_torch beside {Path(__file__).name}: run "
                     f"it from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.algorithms import fields
    from repro_torch.algorithms.consume import degree_cols
    from repro_torch.algorithms.critical_points import critical_points, \
        total_order
    from repro_torch.core.engine import RelationEngine
    from repro_torch.core.mesh import segment_mesh
    from repro_torch.core.segtables import precondition
    from repro_torch.data.meshgen import structured_grid
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import segment_relations as sr

    dev = torch.device("cuda")
    smi = nvidia_smi()

    # -- 1. device and build -------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build(["segment_relations"])["segment_relations"]
    t_build = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in
             (lib.parent / "build.log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": round(t_build, 3), "ptxas": ptxas,
          "smem_optin_bytes": sr.smem_limit(dev)})

    # the main path's mesh (its tables are the kernels' inputs in phase 2)
    t0 = time.perf_counter()
    mesh = structured_grid(N, N, N, scalar_fn=fields.gaussians(
        0, k=4, sigma=3.0, scale=N))
    sm = segment_mesh(mesh, capacity=64)
    t1 = time.perf_counter()
    pre = precondition(sm, relations=["VV", "VT"])
    t2 = time.perf_counter()
    # the consumer's exact column widths: one-time host work cached on
    # ``pre``, done here so that it lands in neither main-path wall below
    degree_cols(pre, ("VV", "VT"))
    t3 = time.perf_counter()
    tabs = pre.tables
    emit({"phase": "mesh", "vertices": mesh.n_vertices, "tets": mesh.n_tets,
          "segments": sm.n_segments, "NV": tabs.NV, "NT": tabs.NT,
          "T_local_bytes": int(tabs.T_local.nbytes),
          "segment_s": round(t1 - t0, 3), "precondition_s": round(t2 - t1, 3),
          "degree_bound_s": round(t3 - t2, 3)})

    # -- 2. each kernel arm against its plain version --------------------------
    rng = np.random.default_rng(0)
    cu = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    T = cu(tabs.T_local[:BATCH])
    inputs = {"VV": (T, cu(tabs.LV_global[:BATCH])),
              "VT": (T, cu(tabs.LT_global[:BATCH]))}
    max_err = {"VV": 0, "member": 0}

    def plain(relation, tab, colg, nvl, deg):
        if relation == "VV":
            return ops._block_vv(tab, colg, nvl, deg)
        return ops._block_member_v(tab, colg, nvl, deg)

    def compare(case, relation, tab, colg, nvl, deg):
        got = sr.relation_entries_cuda(relation, tab, tab, colg,
                                       nvl=nvl, deg=deg)
        want = plain(relation, tab, colg, nvl, deg)
        torch.cuda.synchronize()
        arm = "VV" if relation == "VV" else "member"
        err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
                  for g, w in zip(got, want))
        max_err[arm] = max(max_err[arm], err)
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
        emit({"phase": "kernel_case", "case": case, "relation": relation,
              "shape": list(tab.shape), "deg": deg, "equal": ok,
              "max_L": int(want[1].max()) if want[1].numel() else 0})
        check(ok, f"{relation} kernel disagrees with the plain arm ({case})")
        return want

    def rand_tets(B, NT, nvl, fill=0.7, valid_all=False):
        tab = np.full((B, NT, 4), -1, dtype=np.int32)
        n = NT if valid_all else max(1, int(NT * fill))
        for b in range(B):
            tab[b, :n] = np.argsort(rng.random((n, nvl)), axis=1)[:, :4]
        return cu(tab)

    nvl = tabs.NV
    for relation, (tab, colg) in inputs.items():
        deg = ops.DEFAULT_DEG[relation]
        compare("main", relation, tab, colg, nvl, deg)
        compare("B=1", relation, tab[:1].contiguous(),
                colg[:1].contiguous(), nvl, deg)
        want = compare("L>deg", relation, tab, colg, nvl, 4)
        check(int(want[1].max()) > 4, "the L > deg case has no such row")
    for n in (1, 7, 127):
        tt = rand_tets(2, n, max(8, n))
        cv = cu(rng.integers(0, 10 ** 6, (2, max(8, n))).astype(np.int32))
        ct = cu(rng.integers(0, 10 ** 6, (2, n)).astype(np.int32))
        compare(f"prime {n}", "VV", tt, cv, max(8, n), 8)
        compare(f"prime {n}", "VT", tt, ct, max(8, n), 8)
    # fully valid lane vector: 4 * 128 entries, a power of two, none padding
    tt = rand_tets(3, 128, 64, valid_all=True)
    compare("fully valid lanes", "VT", tt,
            cu(np.arange(3 * 128, dtype=np.int32).reshape(3, 128)), 64, 64)
    # NT=1408: 8*E = 256 KB of lanes > the opt-in limit -> device workspace
    big = 1408
    check(4 * sr.lane_ints(sr.next_pow2(12 * big), 256) > sr.smem_limit(dev),
          "the workspace case fits shared memory")
    tt = rand_tets(2, big, 256)
    compare("device-workspace lanes", "VV", tt,
            cu(rng.integers(0, 10 ** 6, (2, 256)).astype(np.int32)), 256, 256)
    compare("device-workspace lanes", "VT",
            rand_tets(2, 2 ** 14 // 4 + 64, 256),
            cu(rng.integers(0, 10 ** 6, (2, 2 ** 14 // 4 + 64))
               .astype(np.int32)), 256, 128)

    timing = {}
    for relation, (tab, colg) in inputs.items():
        arm = "VV" if relation == "VV" else "member"
        deg = ops.DEFAULT_DEG[relation]
        k_ms = time_ms(torch, lambda: sr.relation_entries_cuda(
            relation, tab, tab, colg, nvl=nvl, deg=deg))
        p_ms = time_ms(torch, lambda: plain(relation, tab, colg, nvl, deg))
        M, L = plain(relation, tab, colg, nvl, deg)
        if relation == "VV":
            va = (tab >= 0).sum(-1)                  # valid verts per tet
            valid = (va * (va - 1)).sum(-1)          # ordered pairs
        else:
            valid = (tab >= 0).sum((1, 2))
        b_ms, b_by = bound_ms(tab, colg, M, L, valid.tolist())
        timing[arm] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                       "bound_by": b_by}
        emit({"phase": "kernel_time", "arm": arm, "relation": relation,
              "shape": list(tab.shape), "deg": deg, **timing[arm],
              "entries": int(valid.sum())})

    # -- 3. the main path ------------------------------------------------------
    # warm both arms up on a small mesh first (module loading, allocator
    # pools), so that the two walls below compare like with like
    wsm = segment_mesh(structured_grid(16, 16, 16), capacity=64)
    wpre = precondition(wsm, relations=["VV", "VT"])
    for backend in ("cuda", "torch"):
        critical_points(RelationEngine(wpre, ["VV", "VT"], device="cuda",
                                       backend=backend),
                        wpre, total_order(wsm.scalars))
    rank = total_order(sm.scalars)
    runs = {}
    for backend in ("cuda", "torch"):
        if backend == "cuda":
            for k in sr.LAUNCHES:
                sr.LAUNCHES[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = RelationEngine(pre, ["VV", "VT"], lookahead=8, device="cuda",
                             backend=backend)
        types, counts = critical_points(eng, pre, rank)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if backend == "cuda":
            launches = dict(sr.LAUNCHES)
        s = eng.stats
        runs[backend] = types
        digest = hashlib.sha256(types.astype(np.int32).tobytes()).hexdigest()
        emit({"phase": "main_path", "backend": backend, "n": N,
              "counts": counts, "kernel_launches": s.kernel_launches,
              "segments_produced": s.segments_produced,
              "cache_hits": s.cache_hits, "cache_misses": s.cache_misses,
              "devpool_hits": s.devpool_hits,
              "devpool_uploads": s.devpool_uploads,
              "wall_s": round(wall, 3), "t_sync_s": round(s.t_sync, 3),
              "t_kernel_s": round(s.t_kernel, 3),
              "types_sha256": digest,
              **({"kernel_counters": launches} if backend == "cuda" else {})})
        check(types.shape == (mesh.n_vertices,), "types has the wrong shape")
        check(counts == REF_COUNTS,
              f"{backend} counts {counts} != reference {REF_COUNTS}")
        check(digest == REF_TYPES_SHA256,
              f"{backend} types differ from the reference's")
        check(s.segments_produced == 2 * sm.n_segments,
              "a block was produced twice or not at all")
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched on the main path: {launches}")
    check(np.array_equal(runs["cuda"], runs["torch"]),
          "cuda and plain torch arms give different types")

    # -- 4. summary ------------------------------------------------------------
    emit({"kernels": [
        {"name": k["name"], "route": "cuda", "source": SOURCE,
         "replaces": k["replaces"], "launches": launches[arm],
         "max_abs_err": max_err[arm], "ms": timing[arm]["ms"],
         "plain_ms": timing[arm]["plain_ms"],
         "bound_ms": timing[arm]["bound_ms"],
         "bound_by": timing[arm]["bound_by"], "library_ms": None}
        for arm, k in KERNELS.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
