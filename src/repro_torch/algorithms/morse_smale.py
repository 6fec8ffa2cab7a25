"""Morse–Smale complex extraction from a discrete gradient (paper §5.1,
'MorseSmaleComplex', following Robins et al. [37]).

We compute the 1-skeleton of the MS complex plus the descending/ascending
segmentation:

  - descending 1-separatrices: V-paths from each critical edge's endpoints
    through vertex→edge gradient pairs down to minima;
  - ascending 1-separatrices: dual V-paths from each critical face's cofacet
    tets through tet→face pairs up to maxima (needs the **FT** relation — one
    of the paper's 7 MS queues);
  - basin segmentation: every vertex labeled by the minimum its V-path
    reaches, every tet by the maximum.

Path-following is **pointer jumping** on global successor arrays: log₂(n)
rounds of ``succ = succ[succ]`` on the engine's device, fully data-parallel,
instead of TTK's sequential separatrix tracing.

Two interchangeable (bit-identical) ways to assemble the ascending successor
array:

  - **FT gather**: every segment's FT block is requested and the global
    face->cofacet table is materialized (``_gather_ft``).
  - **Completed TT** (``adjacency="auto"`` on a `RelationEngine` whose
    relation set covers TT+FT): the successor of a paired tet is its
    cross-segment-completed TT neighbour across the paired face
    (``core/adjacency.py``), requested in pipelined batches; the few FT rows
    the 2-saddle separatrices still need are fetched only for the owner
    segments of critical faces.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.adjacency import complete_adjacency
from ..core.scheduler import run_collect, run_partitioned, segment_batches
from . import consume
from .discrete_gradient import GradientField


def _supports_completion(ds, *relations) -> bool:
    """Engine-native adjacency completion is available on data structures
    exposing the inverse-map + full-block API with the needed relations."""
    return (hasattr(ds, "local_rows") and hasattr(ds, "get_full")
            and all(r in getattr(ds, "relations", ()) for r in relations))


@dataclasses.dataclass
class MSComplex:
    # vertex-side (descending)
    dest_min: np.ndarray        # (nv,) gid of reached minimum
    # tet-side (ascending); -1 where the path exits through the boundary
    dest_max: np.ndarray        # (nt,)
    saddle1_ends: np.ndarray    # (n_s1, 3): [edge gid, min0, min1]
    saddle2_ends: np.ndarray    # (n_s2, 3): [face gid, max0, max1]

    def counts(self) -> Dict[str, int]:
        con1 = {(int(e[1]), int(e[2])) for e in self.saddle1_ends}
        con2 = {(int(e[1]), int(e[2])) for e in self.saddle2_ends}
        return {
            "saddle1": len(self.saddle1_ends),
            "saddle2": len(self.saddle2_ends),
            "basins_min": len(np.unique(self.dest_min)),
            "basins_max": len(np.unique(self.dest_max[self.dest_max >= 0])),
            "arcs": len(con1) + len(con2),
        }


# contract: device-resident
def _pointer_jump(succ: torch.Tensor) -> torch.Tensor:
    """``ceil(log2(n)) + 1`` rounds of ``s = s[s]``: every path's end."""
    n = succ.shape[0]
    rounds = int(math.ceil(math.log2(max(n, 2)))) + 1
    s = succ
    for _ in range(rounds):
        s = s[s]
    return s


def _jump_host(succ: np.ndarray, device) -> np.ndarray:
    """Every V-path's end (:func:`_pointer_jump` on ``device``), on the
    host."""
    s = torch.from_numpy(np.asarray(succ, dtype=np.int64)).to(device)
    return _pointer_jump(s).cpu().numpy()


def _gather_ft(ds, pre, batch_segments: int = 16,
               workers: int = 1, plan=None) -> np.ndarray:
    """Assemble the global FT table (nf, 2) through the data structure —
    every segment's FT block is produced/consumed (GALE's FT queue). The
    batch stream goes through the consumer scheduler: each worker
    dispatches its next batch before integrating the current one, and rows
    land in disjoint per-segment slices reduced in segment order. With a
    shard ``plan`` the batches restart at shard boundaries and the workers
    are shard-affine."""
    nf = pre.n_faces
    ft = np.full((nf, 2), -1, dtype=np.int64)
    batches = segment_batches(pre.smesh.n_segments, batch_segments, plan)
    shard_of = ((lambda i: plan.shard_of(batches[i][0]))
                if plan is not None else None)
    prefetch = ((lambda segs: ds.prefetch("FT", segs))
                if hasattr(ds, "prefetch") else None)

    def consume_batch(i, segs):
        return segs, ds.get_batch("FT", segs)

    def reduce_batch(i, res):
        segs, blocks = res
        for s, (M, L) in zip(segs, blocks):
            lo = int(pre.I_F[s])
            n = M.shape[0]
            w = min(2, M.shape[1])
            ft[lo:lo + n, :w] = M[:, :w]

    run_partitioned(batches, consume_batch, reduce_batch, workers=workers,
                    prefetch=prefetch, scope=ds, name="gather_ft",
                    shard_of=shard_of)
    return ft


def _cofacet_rows(ds, pre, face_ids, batch_segments: int = 16,
                  mode: str = "host", workers: int = 1,
                  plan=None) -> np.ndarray:
    """FT rows (m, 2) for specific faces only: the owner segments are
    streamed in pipelined batches through the consumer scheduler
    (:func:`run_collect`) — each worker prefetches its next owner batch
    before consuming the current one, and batches restart at shard
    boundaries with shard-affine workers. The device arm reads the owner
    blocks through :meth:`get_full_dev_many` and downloads only the
    selected ``(m, 2)`` rows; results are bit-identical for any batch
    size, worker count or shard plan (rows are keyed by face gid, not by
    batch)."""
    face_ids = np.asarray(face_ids, dtype=np.int64)
    out = np.full((len(face_ids), 2), -1, dtype=np.int64)
    if len(face_ids) == 0:
        return out
    segs = pre.owner_segment("F", face_ids)
    uniq = np.unique(segs)
    sh = (plan.shard_of_array(uniq) if plan is not None
          else np.zeros(len(uniq), np.int64))
    batches, cur = [], [int(uniq[0])]
    for a in range(1, len(uniq)):
        if len(cur) >= batch_segments or sh[a] != sh[a - 1]:
            batches.append(cur)
            cur = []
        cur.append(int(uniq[a]))
    batches.append(cur)
    shard_of = ((lambda i: plan.shard_of(batches[i][0]))
                if plan is not None else None)
    prefetch = ((lambda sl: ds.prefetch("FT", sl))
                if hasattr(ds, "prefetch") else None)

    if mode == "device":
        def consume_batch(i, sl):
            sel = np.nonzero(np.isin(segs, sl))[0]
            cb = ds.get_full_dev_many(("FT",), sl, cols={"FT": 2})
            # batch rows are ascending internal gids of the (sorted) owner
            # segments, so each face resolves by one binary search
            pos = np.searchsorted(cb.gid, face_ids[sel])
            rows = cb.M["FT"].index_select(
                0, torch.from_numpy(pos).to(cb.M["FT"].device))
            return sel, rows

        def finalize(inter):
            sel, rows = inter
            return sel, rows.cpu().numpy()
    else:
        finalize = None

        def consume_batch(i, sl):
            sel = np.nonzero(np.isin(segs, sl))[0]
            rows = np.full((len(sel), 2), -1, np.int64)
            for s, (M, L) in zip(sl, ds.get_batch("FT", sl)):
                m = segs[sel] == s
                r = face_ids[sel][m] - int(pre.I_F[s])
                w = min(2, M.shape[1])
                rows[m, :w] = M[r][:, :w]
            return sel, rows

    for sel, rows in run_collect(batches, consume_batch, workers=workers,
                                 finalize=finalize, prefetch=prefetch,
                                 scope=ds, name="cofacet_rows",
                                 shard_of=shard_of):
        w = min(2, rows.shape[1])
        out[sel, :w] = rows[:, :w]
    return out


# contract: device-resident
def _across_successors(M: torch.Tensor,   # (p, deg) completed TT, -1 pad
                       f: torch.Tensor,   # (p,) paired face gid per tet
                       F: torch.Tensor,   # (nf, 3) global FV
                       T: torch.Tensor,   # (nt, 4) global TV
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Successor assembly on the device: the TT neighbour across the paired
    face is the one containing all three of the face's vertices (a tet
    contains a face's vertex triple iff that face is on its boundary) —
    the same predicate the host arm resolves through ``boundary_TF`` face
    ids, with the same first-match tie-break."""
    fv = F[f.clamp(min=0).long()]                                  # (p, 3)
    nbT = torch.where(M[..., None] >= 0, T[M.clamp(min=0).long()],
                      -1)                                          # (p,deg,4)
    across = (fv[:, None, :, None] == nbT[:, :, None, :]).any(-1).all(-1)
    has = across.any(-1)
    pick = torch.argmax(across.to(torch.uint8), dim=-1)
    nxt = M[torch.arange(M.shape[0], device=M.device), pick]
    return nxt, has


def _ascending_successors_tt(ds, pre, grad: GradientField,
                             batch: int, mode: str = "host",
                             workers: int = 1) -> np.ndarray:
    """Tet -> tet-across-its-paired-face successor via completed TT: the
    unique cross-segment TT neighbour whose boundary contains the paired
    face. Bit-identical to the FT-gather successor.

    The device consumer arm takes the completed rows as device tensors
    (``complete_adjacency(..., out="dev")`` — no host block round trip) and
    assembles successors on the device; the host arm is the numpy
    reference."""
    nt = pre.smesh.n_tets
    succ = np.arange(nt)
    paired = np.nonzero(grad.pair_t2f >= 0)[0]
    if len(paired) == 0:
        return succ
    f = grad.pair_t2f[paired]
    if mode == "device" and hasattr(ds, "get_full_dev"):
        M_dev, _ = complete_adjacency(ds, "TT", paired, batch=batch,
                                      path="device", out="dev",
                                      workers=workers)
        nxt, has = _across_successors(
            M_dev, *(torch.from_numpy(a.astype(np.int32)).to(M_dev.device)
                     for a in (f, pre.F, pre.smesh.tets)))
        nxt, has = nxt.cpu().numpy(), has.cpu().numpy()
        succ[paired[has]] = nxt[has]
        return succ
    M, _ = complete_adjacency(ds, "TT", paired, batch=batch, workers=workers)
    p, deg = M.shape
    tf_nb = ds.boundary_TF(np.maximum(M, 0).reshape(-1)).reshape(p, deg, 4)
    across = (tf_nb == f[:, None, None]).any(-1) & (M >= 0)
    has = across.any(-1)
    nxt = M[np.arange(p), np.argmax(across, -1)]
    # boundary faces have no second cofacet: the path stalls (succ = self)
    succ[paired[has]] = nxt[has]
    return succ


def morse_smale(ds, pre, grad: GradientField,
                batch_segments: int = 16,
                adjacency: str = "auto",
                consumer: str = "auto",
                workers: int = 1, shards=None) -> MSComplex:
    """Extract the MS 1-skeleton + segmentation.

    ``adjacency`` selects how ascending successors are assembled: ``"tt"``
    forces the completed-TT path, ``"ft"`` the whole-mesh FT gather, and
    ``"auto"`` (default) uses TT when ``ds`` supports engine-native
    completion for TT and FT. ``consumer`` selects the consumer arm
    (docs/DESIGN.md §6): the device arm keeps completed TT rows and the
    targeted FT reads on the device. ``workers`` threads the
    successor-assembly streams (the FT gather's batch stream, or the TT
    completion's chunk stream) through the consumer scheduler
    (docs/DESIGN.md §8). ``shards`` follows the engine's
    :class:`ShardPlan` (docs/DESIGN.md §9): segment batches restart at
    shard boundaries with shard-affine workers, and the TT completion
    exchanges per-shard gathers. Results are bit-identical across all
    combinations and any worker or shard count."""
    sm = pre.smesh
    nv, nt = sm.n_vertices, sm.n_tets
    E = pre.E
    mode = consume.consumer_mode(ds, consumer)
    plan = consume.shard_plan(ds, shards)
    dev = ds.device
    use_tt = adjacency == "tt" or (
        adjacency == "auto" and _supports_completion(ds, "TT", "FT"))

    # ---- descending: vertex successor through v->e pairs -------------------
    e = grad.pair_v2e                      # (nv,)
    other = np.where(e >= 0,
                     np.where(E[np.maximum(e, 0), 0] == np.arange(nv),
                              E[np.maximum(e, 0), 1],
                              E[np.maximum(e, 0), 0]),
                     np.arange(nv))
    dest_min = _jump_host(other, dev)

    # ---- ascending: tet successor through t->f pairs -----------------------
    s2 = np.nonzero(grad.crit_f)[0]
    if use_tt:
        # completed TT gives the tet across each paired face directly;
        # only the critical faces' FT rows are fetched (targeted segments)
        succ_t = _ascending_successors_tt(ds, pre, grad,
                                          batch=64 * batch_segments,
                                          mode=mode, workers=workers)
        cof_s2 = _cofacet_rows(ds, pre, s2, batch_segments, mode=mode,
                               workers=workers, plan=plan)
    else:
        ft = _gather_ft(ds, pre, batch_segments, workers=workers, plan=plan)
        f = grad.pair_t2f                  # (nt,) face this tet is paired to
        cof0 = ft[np.maximum(f, 0), 0]
        cof1 = ft[np.maximum(f, 0), 1]
        me = np.arange(nt)
        nxt = np.where(cof0 == me, cof1, cof0)   # tet across the paired face
        succ_t = np.where((f >= 0) & (nxt >= 0), nxt, me)
        cof_s2 = ft[s2]
    # paths that exit through a boundary face stall on a non-critical tet
    dest_t = _jump_host(succ_t, dev)
    reached_max = grad.crit_t[dest_t]
    dest_max = np.where(reached_max, dest_t, -1)

    # ---- separatrices -------------------------------------------------------
    s1 = np.nonzero(grad.crit_e)[0]
    ends1 = np.stack([s1, dest_min[E[s1, 0]], dest_min[E[s1, 1]]], axis=1) \
        if len(s1) else np.zeros((0, 3), np.int64)

    if len(s2):
        c0, c1 = cof_s2[:, 0], cof_s2[:, 1]
        m0 = np.where(c0 >= 0, dest_max[np.maximum(c0, 0)], -1)
        m1 = np.where(c1 >= 0, dest_max[np.maximum(c1, 0)], -1)
        ends2 = np.stack([s2, m0, m1], axis=1)
    else:
        ends2 = np.zeros((0, 3), np.int64)

    return MSComplex(dest_min=dest_min, dest_max=dest_max,
                     saddle1_ends=ends1, saddle2_ends=ends2)
