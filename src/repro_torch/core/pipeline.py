"""Fused pipeline mode (DESIGN.md §2.3): for regular traversals, the whole
produce -> consume loop runs on the device over segment batches with no
host round trip — the paper's Fig. 2(b). Each batch's relations are
produced and consumed by kernels queued on one stream, so the host only
enqueues work and the masks come back once, at the end.

Demonstrated for extremum extraction (minima and maxima need only the VV
relation): the producer stage is the shared-tet counts the engine's dense
VV arm launches (``ops.counts_vv``: ``vv_counts_kernel`` on a card, the
plain one-hot product on the CPU), the consumer stage classifies vertices
against their neighbours.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..kernels import ops
from .segtables import Preconditioned


def stage_fused(pre: Preconditioned, rank: np.ndarray, batch: int = 8,
                device=None):
    """Upload the fused loop's inputs to ``device``: ``T_local`` and
    ``LV_global`` padded with ``-1`` segments (and ``n_int_v`` with 0) to a
    multiple of ``batch``, as ``(nb, batch, ...)`` tensors, plus ``rank``."""
    dev = ops.resolve_device(device)
    t = pre.tables
    ns = pre.smesh.n_segments
    pad = (-ns) % batch
    T_local = np.concatenate(
        [t.T_local, np.full((pad,) + t.T_local.shape[1:], -1, np.int32)])
    LV = np.concatenate([t.LV_global, np.full((pad, t.NV), -1, np.int32)])
    nint = np.concatenate([t.n_int_v, np.zeros(pad, np.int32)])
    nb = (ns + pad) // batch
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return (put(T_local.reshape(nb, batch, *T_local.shape[1:])),
            put(LV.reshape(nb, batch, t.NV)),
            put(nint.reshape(nb, batch).astype(np.int32)),
            put(np.asarray(rank, dtype=np.int64)))


# contract: device-resident
def fused_masks(T_local: torch.Tensor, LV: torch.Tensor, nint: torch.Tensor,
                rank: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The loop over segment batches: produce VV counts for batch k, then
    classify its vertices. ``(nb, batch, ...)`` inputs from
    :func:`stage_fused`; returns the ``(nb * batch, NV)`` minimum and
    maximum masks on the device. Nothing in it synchronises with the
    host."""
    nb, NV = T_local.shape[0], LV.shape[2]
    dev = T_local.device
    off_diag = ~torch.eye(NV, dtype=torch.bool, device=dev)[None]
    iota = torch.arange(NV, device=dev)[None, :]
    mins, maxs = [], []
    for k in range(nb):
        tloc, lv, n_int = T_local[k], LV[k], nint[k]
        # -- produce: VV counts via the shared-tet incidence product ------
        C = ops.counts_vv(tloc, NV)                      # (batch, NV, NV)
        adj = (C > 0) & off_diag
        # -- consume: extremum classification against neighbours ----------
        r_self = torch.where(lv >= 0, rank[lv.clamp(min=0).long()], 0)
        r_nbr = r_self[:, None, :]                       # (batch, 1, NV)
        lower_any = (adj & (r_nbr < r_self[:, :, None])).any(-1)
        upper_any = (adj & (r_nbr > r_self[:, :, None])).any(-1)
        has_nbr = adj.any(-1)
        internal = (iota < n_int[:, None]) & (lv >= 0)
        mins.append(internal & has_nbr & ~lower_any)
        maxs.append(internal & has_nbr & ~upper_any)
    return torch.cat(mins), torch.cat(maxs)


def fused_extrema(pre: Preconditioned, rank: np.ndarray, batch: int = 8,
                  device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (minima gids, maxima gids), sorted — the entire pipeline on
    ``device`` (``cuda`` unless the caller asks for another; a missing
    card raises). Only the final masks come back to the host."""
    T_local, LV, nint, rank_dev = stage_fused(pre, rank, batch, device)
    mins, maxs = fused_masks(T_local, LV, nint, rank_dev)
    lv = LV.reshape(-1, LV.shape[2]).cpu().numpy()
    out = []
    for m in (mins.cpu().numpy(), maxs.cpu().numpy()):
        rows, cols = np.nonzero(m)
        out.append(np.sort(lv[rows, cols]))
    return out[0], out[1]
