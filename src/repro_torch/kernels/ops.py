"""Relation-block dispatch: the plain PyTorch arms of the sparse entry
assembly and of the dense counts fallback, and the backend fork onto the
hand-written CUDA kernels.

Backends:
  - ``"torch"`` : plain PyTorch on the tensors' own device — the entry
                  inversion (sort, dedup, row-boundary search, gather) of
                  :func:`_invert_entries`, and the counts of
                  :func:`_counts_pairwise` / :func:`_counts_vv_onehot`; the
                  CPU path, and on a card the yardstick the kernels are held
                  against
  - ``"cuda"``  : the hand-written Hopper kernels of ``kernels/csrc/``
                  through :mod:`~repro_torch.kernels.segment_relations`;
                  CUDA tensors only

Assembly: VV/VE/VF/VT/TT/EF/ET/FT are assembled sparsely (entries ->
``(M, L)``) while their keys fit int32 (:func:`sparse_arm_ok`); EE/FF
(count predicates, not membership), oversize keys and
``assembly="dense"`` take the dense fallback — counts ``C``, then the
predicate and the compaction (:func:`_predicate`, :func:`_compact`) in
torch, as the reference computes that epilogue outside its kernels. Both
arms are bit-identical to the reference package's ``xla`` and ``pallas``
arms for every relation.

:func:`relation_block_host` is the engine's degraded arm (docs/DESIGN.md
§12), not a kernel fallback: dense counts, predicate and compaction in
numpy, run only while a relation's circuit breaker is open, with the same
``(M, L)`` as the arms above.
"""

from __future__ import annotations

import itertools
from typing import Optional, Tuple

import numpy as np
import torch

# Maximum relation-list width (the paper's preallocated relation-array width).
# RelationEngine._integrate raises RelationWidthError (naming the deg=
# override) whenever a produced row's true count L exceeds this width.
DEFAULT_DEG = {
    "VV": 32, "VE": 32, "VF": 96, "VT": 64,
    "EF": 16, "ET": 16, "FT": 4, "TT": 8, "EE": 64, "FF": 48,
}

# (shared count k, exact match?) — see core.segtables.RELATION_PREDICATE.
PREDICATE = {
    "VE": (1, True), "VF": (1, True), "VT": (1, True),
    "EF": (2, True), "ET": (2, True), "FT": (3, True),
    "VV": (1, False), "EE": (1, True), "FF": (2, True), "TT": (3, True),
}

BACKENDS = ("torch", "cuda")
ASSEMBLIES = ("sparse", "dense")

_BIG = int(np.iinfo(np.int32).max)


def bucket_rows(n: int, floor: int = 1) -> int:
    """Round a batch-sized leading dimension up to a power-of-two bucket.

    Launch batches and stacked consumer rows pad to this bucket, so ragged
    tails give O(log n) distinct shapes; ``floor`` sets the minimum bucket.
    The same buckets as the reference, so both engines launch the same
    padded batches."""
    return 1 << max(int(max(n, floor, 1)) - 1, 0).bit_length()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Asking for ``cuda`` without a card raises — the port never
    falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the plain torch arm")
    return dev


def resolve_backend(backend: Optional[str], device: torch.device) -> str:
    """``backend=None`` picks the kernels on a card and the plain arm on the
    CPU; ``"cuda"`` on a CPU device raises."""
    if backend is None:
        backend = "cuda" if device.type == "cuda" else "torch"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(
            f"backend='cuda' runs the CUDA kernels and needs a CUDA device, "
            f"got {str(device)!r}")
    return backend


def _invert_entries(row, order, val, valid, R: int, O: int, deg: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse relation assembly: per-batch entry lists -> the padded
    ``(M (B, R, deg), L (B, R))`` block.

    ``row``/``order``/``val``/``valid``: (B, E) entry columns — the block
    row, the intra-row sort key (local column index, so M rows come out in
    ascending local order), and the global id to store. Entries sharing
    ``(row, order)`` are stored/counted once (they always carry the same
    ``val``); ``L`` is the TRUE count, so overflow past ``deg`` stays
    detectable by the engine's width check.

    The same steps as the CUDA kernels' ``emit_entries``: sort by key
    ``row * O + order`` (int32: the caller's :func:`sparse_arm_ok` keeps
    ``R * O + O < 2**31``), re-key duplicates to the sentinel and sort
    again, lower-bound the ``R + 1`` row starts ``r * O``, and gather
    ``M[r, d] = val[starts[r] + d]``. Every key family is tie-insensitive
    (equal keys carry equal values), so the sort need not be stable."""
    B, E = row.shape
    dev = row.device
    key = torch.where(valid, row.to(torch.int32) * O + order.to(torch.int32),
                      _BIG)
    val = val.to(torch.int32)
    key, perm = torch.sort(key, dim=1)
    val = torch.gather(val, 1, perm)
    dup = torch.zeros_like(valid)
    dup[:, 1:] = key[:, 1:] == key[:, :-1]
    key = key.masked_fill(dup, _BIG)
    key, perm = torch.sort(key, dim=1)
    val = torch.gather(val, 1, perm)

    queries = (torch.arange(R + 1, device=dev, dtype=torch.int32) * O
               ).expand(B, R + 1).contiguous()
    starts = torch.searchsorted(key, queries)            # (B, R+1) int64
    L = starts[:, 1:] - starts[:, :-1]                   # true counts
    d = torch.arange(deg, device=dev)
    idx = (starts[:, :R, None] + d).clamp(max=E - 1)     # (B, R, deg)
    vals = torch.gather(val, 1, idx.reshape(B, R * deg)).reshape(B, R, deg)
    M = torch.where(d < L.clamp(max=deg)[..., None], vals, -1)
    return M.to(torch.int32), L.to(torch.int32)


def _block_member_v(tabY, col_global, nvl: int, deg: int):
    """VE/VF/VT block via entry inversion: local vertex ``v`` relates to
    simplex ``y`` iff ``v ∈ verts(y)`` (the exact ``C == 1`` predicate — a
    simplex lists distinct vertices), so the ``(B, NY, arity)`` table IS
    the entry list."""
    B, NY, a = tabY.shape
    yid = torch.arange(NY, device=tabY.device, dtype=torch.int32)
    return _invert_entries(
        tabY.clamp(min=0).reshape(B, -1),
        yid[None, :, None].expand(B, NY, a).reshape(B, -1),
        col_global[:, :, None].expand(B, NY, a).reshape(B, -1),
        (tabY >= 0).reshape(B, -1), R=nvl, O=NY, deg=deg)


_TET_PAIRS = tuple((a, b) for a in range(4) for b in range(4) if a != b)


def _block_vv(T_local, col_global, nvl: int, deg: int):
    """VV block via entry inversion: ``v ~ w`` iff some local tet contains
    both (the ``C >= 1`` off-diagonal predicate). The 12 ordered vertex
    pairs of each tet are the entries; a tet's vertices are distinct, so
    the diagonal never appears, and repeated pairs from different tets
    dedup inside :func:`_invert_entries`."""
    B = T_local.shape[0]
    ia = torch.tensor([a for a, _ in _TET_PAIRS], device=T_local.device)
    ib = torch.tensor([b for _, b in _TET_PAIRS], device=T_local.device)
    va = T_local[:, :, ia].transpose(1, 2).reshape(B, -1)   # pair-major
    vb = T_local[:, :, ib].transpose(1, 2).reshape(B, -1)
    vals = torch.gather(col_global, 1, vb.clamp(min=0).long())
    return _invert_entries(va.clamp(min=0), vb.clamp(min=0), vals,
                           (va >= 0) & (vb >= 0), R=nvl, O=nvl, deg=deg)


_TET_FACES = ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3))


def _block_tt(T_local, col_global, nvl: int, deg: int):
    """TT block via a sort join on canonical face keys: two distinct tets
    relate iff they share exactly three vertices — a common face (the
    exact ``C == 3`` predicate). Each local tet contributes its four sorted
    vertex triples; after one lane-wise sort, equal adjacent keys are the
    shared faces (a face has at most two cofacet tets), yielding both
    directed entries."""
    B, NT, _ = T_local.shape
    dev = T_local.device
    w = torch.sort(T_local, dim=-1).values              # ascending vertices
    valid_t = (T_local >= 0).all(-1)                    # (B, NT)
    keys = [(w[..., i] * nvl + w[..., j]) * nvl + w[..., k]
            for i, j, k in _TET_FACES]
    fkey = torch.stack(keys, dim=-1).reshape(B, 4 * NT)
    tid = torch.arange(NT, device=dev, dtype=torch.int32)[None, :, None] \
        .expand(B, NT, 4).reshape(B, 4 * NT)
    fkey = torch.where(valid_t.repeat_interleave(4, dim=1), fkey, _BIG)
    fkey, perm = torch.sort(fkey, dim=1)
    tid = torch.gather(tid, 1, perm)
    eq = (fkey[:, :-1] == fkey[:, 1:]) & (fkey[:, :-1] != _BIG)
    t0, t1 = tid[:, :-1], tid[:, 1:]
    row = torch.cat([t0, t1], dim=1)
    order = torch.cat([t1, t0], dim=1)
    valid = torch.cat([eq, eq], dim=1)
    val = torch.gather(col_global, 1, order.long())
    return _invert_entries(row, order, val, valid, R=NT, O=NT, deg=deg)


def _block_sub_join(tabX, tabY, col_global, nvl: int, deg: int):
    """EF/ET/FT block via a sort join: subject ``x`` relates to ``y`` iff
    every vertex of ``x`` lies in ``y`` (the exact ``C == arity(x)``
    predicate — x then is a boundary sub-simplex of y). X rows contribute
    their canonical sorted vertex key once; each y contributes the keys of
    all its arity(x)-vertex subsets. After one lane-wise sort (x keys are
    even, y keys odd, so an x entry sorts before the equal-key y entries),
    every y entry resolves its x row from the latest x entry seen (a
    running max over lane indices) and re-checks the key."""
    B, NX, ax = tabX.shape
    _, NY, ay = tabY.shape
    dev = tabX.device
    wx = torch.sort(tabX, dim=-1).values
    kx = wx[..., 0]
    for i in range(1, ax):
        kx = kx * nvl + wx[..., i]
    kx = torch.where((tabX >= 0).all(-1), kx * 2, _BIG)      # is_y = 0
    wy = torch.sort(tabY, dim=-1).values
    oky = (tabY >= 0).all(-1)
    ykeys = []
    for comb in itertools.combinations(range(ay), ax):
        k = wy[..., comb[0]]
        for c in comb[1:]:
            k = k * nvl + wy[..., c]
        ykeys.append(k)
    nyk = len(ykeys)
    ky = torch.stack(ykeys, dim=-1).reshape(B, NY * nyk)
    ky = torch.where(oky.repeat_interleave(nyk, dim=1), ky * 2 + 1, _BIG)
    yid = torch.arange(NY, device=dev, dtype=torch.int32)[None, :, None] \
        .expand(B, NY, nyk).reshape(B, NY * nyk)

    key = torch.cat([kx, ky], dim=1)
    payload = torch.cat(
        [torch.arange(NX, device=dev, dtype=torch.int32).expand(B, NX), yid],
        dim=1)
    is_y = torch.cat([torch.zeros((B, NX), dtype=torch.bool, device=dev),
                      torch.ones((B, NY * nyk), dtype=torch.bool,
                                 device=dev)], dim=1)
    key, perm = torch.sort(key, dim=1)
    payload = torch.gather(payload, 1, perm)
    is_y = torch.gather(is_y, 1, perm)
    iota = torch.arange(key.shape[1], device=dev)[None, :]
    lastX = torch.cummax(torch.where(is_y, -1, iota), dim=1).values
    take = lastX.clamp(min=0)
    xkey = torch.gather(key, 1, take)
    ok = is_y & (lastX >= 0) & (key != _BIG) & (xkey == key - 1)
    row = torch.gather(payload, 1, take)
    order = torch.where(ok, payload, 0)
    val = torch.gather(col_global, 1, order.long())
    return _invert_entries(row, order, val, ok, R=NX, O=NY, deg=deg)


def sparse_arm_ok(relation: str, tabX, tabY, nvl: int) -> bool:
    """True when ``relation`` has a sparse entry-assembly arm AND its entry
    keys fit int32 — the reference's guard, so both packages take the
    sparse/dense fork under identical conditions."""
    if relation == "VV":
        return nvl * nvl + nvl < 2 ** 31
    if relation in ("VE", "VF", "VT"):
        NY = tabY.shape[1]
        return nvl * NY + NY < 2 ** 31
    if relation == "TT":
        NT = tabX.shape[1]
        return nvl ** 3 < 2 ** 31 and NT * NT + NT < 2 ** 31
    if relation in ("EF", "ET", "FT"):
        NX, NY = tabX.shape[1], tabY.shape[1]
        ax = tabX.shape[2]
        return nvl ** ax * 2 < 2 ** 31 and NX * NY + NY < 2 ** 31
    return False


def _counts_pairwise(tabX: torch.Tensor, tabY: torch.Tensor) -> torch.Tensor:
    """Shared-vertex counts by direct slot comparison: ``C[b, x, y]`` =
    number of valid ``tabX[b, x]`` slots whose vertex appears in
    ``tabY[b, y]`` (the reference xla arm's meet counts; a ``-1`` x slot
    never scores, so ``-1 == -1`` never counts). ``C`` does not depend on
    ``nvl``."""
    B, NX, ax = tabX.shape
    C = torch.zeros((B, NX, tabY.shape[1]), dtype=torch.int32,
                    device=tabX.device)
    for i in range(ax):
        xi = tabX[:, :, i]                                    # (B, NX)
        m = (xi[:, :, None, None] == tabY[:, None, :, :]).any(-1)
        C += (m & (xi >= 0)[:, :, None]).to(torch.int32)
    return C


def _counts_vv_onehot(T_local: torch.Tensor, nvl: int) -> torch.Tensor:
    """Shared-tet counts ``C (B, nvl, nvl)``, diagonal included, as the
    reference's ``ref.relation_counts_vv``: the product of the one-hot
    (vertex, tet) incidence with itself. The one-hot is built in float32
    (a CUDA ``bmm`` takes no int32): its entries are 0 and 1, exact in
    float32 and in TF32, and the sums (at most NT) are exact float32
    integers, so the product is exact whatever the TF32 setting."""
    B, NT, _ = T_local.shape
    iota = torch.arange(nvl, device=T_local.device, dtype=T_local.dtype)
    A = (T_local[:, None, :, :] == iota[None, :, None, None]).any(-1)
    A = A.to(torch.float32)                                   # (B, nvl, NT)
    return torch.bmm(A, A.transpose(1, 2)).to(torch.int32)


def counts_meet(tabX: torch.Tensor, tabY: torch.Tensor,
                backend: Optional[str] = None) -> torch.Tensor:
    """Shared-vertex counts ``C (B, NX, NY)`` int32 of ``(B, N, arity)``
    tables: the meet kernel on a card, :func:`_counts_pairwise` on the
    CPU or with ``backend="torch"``."""
    if resolve_backend(backend, tabX.device) == "cuda":
        from .segment_relations import relation_counts_meet_cuda
        return relation_counts_meet_cuda(tabX, tabY)
    return _counts_pairwise(tabX, tabY)


def counts_vv(T_local: torch.Tensor, nvl: int,
              backend: Optional[str] = None) -> torch.Tensor:
    """Shared-tet counts ``C (B, nvl, nvl)`` int32 of the ``(B, NT, 4)``
    tet table: the VV count kernel on a card, :func:`_counts_vv_onehot`
    on the CPU or with ``backend="torch"``."""
    if resolve_backend(backend, T_local.device) == "cuda":
        from .segment_relations import relation_counts_vv_cuda
        return relation_counts_vv_cuda(T_local, nvl)
    return _counts_vv_onehot(T_local, nvl)


def _predicate(C: torch.Tensor, k: int, exact: bool,
               exclude_diag: bool) -> torch.Tensor:
    """Counts -> boolean relation block (``C == k`` or ``C >= k``); VV
    drops the diagonal (a vertex is not its own neighbour)."""
    m = (C == k) if exact else (C >= k)
    if exclude_diag:
        n = min(C.shape[1], C.shape[2])
        i = torch.arange(n, device=C.device)
        m[:, i, i] = False
    return m


def _compact(mask: torch.Tensor, col_global: torch.Tensor, deg: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Boolean relation rows -> ``(M (B, R, deg), L (B, R))`` int32: the
    global ids of the set columns in ascending local order (``-1`` padded)
    and the TRUE row counts (overflow past ``deg`` stays visible to the
    engine's width check).

    Set columns score ``N - column`` and the rest 0, so ``topk`` yields
    "all set columns, ascending". Scores of set columns are distinct; ties
    occur only at 0, whose slots are masked to ``-1``, so the result is the
    same whatever order ``topk`` gives the ties. ``k = min(deg, N)``, and
    ``M`` right-pads with ``-1`` when a table is narrower than ``deg``."""
    B, R, N = mask.shape
    iota = torch.arange(N, device=mask.device, dtype=torch.int32)
    scores = torch.where(mask, N - iota, 0).to(torch.int32)
    k = min(deg, N)
    vals, idx = torch.topk(scores, k, dim=2, sorted=True)
    gathered = torch.gather(col_global[:, None, :].expand(B, R, N), 2, idx)
    M = torch.where(vals > 0, gathered, -1).to(torch.int32)
    if k < deg:
        M = torch.nn.functional.pad(M, (0, deg - k), value=-1)
    return M, mask.sum(2).to(torch.int32)


def relation_block(
    relation: str,
    tabX: torch.Tensor,       # (B, NX, ax) rows table (or T_local for VV)
    tabY: torch.Tensor,       # (B, NY, ay) cols table (ignored for VV)
    col_global: torch.Tensor,  # (B, NY) local->global map for columns
    nvl: int,
    deg: Optional[int] = None,
    backend: Optional[str] = None,
    assembly: str = "sparse",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Entries (or counts -> predicate -> compaction) -> ``(M (B, R,
    deg), L (B, R))`` int32, on the tables' device.

    For VV, pass ``tabX = tabY = T_local`` and ``col_global = LV_global``;
    rows/cols are local vertices. ``backend=None`` launches the CUDA
    kernels on CUDA tensors and runs the plain torch arm on CPU tensors;
    ``backend="torch"`` forces the plain arm on any device, and
    ``backend="cuda"`` on CPU tensors raises. The sparse/dense fork is the
    reference's: sparse while :func:`sparse_arm_ok`, dense otherwise;
    ``assembly="dense"`` forces the dense fallback for every relation (the
    reference's benchmark A/B arm)."""
    if assembly not in ASSEMBLIES:
        raise ValueError(f"assembly must be one of {ASSEMBLIES}, "
                         f"got {assembly!r}")
    k, exact = PREDICATE[relation]
    deg = DEFAULT_DEG[relation] if deg is None else deg
    backend = resolve_backend(backend, tabX.device)
    colg = col_global.to(torch.int32)
    if assembly == "sparse" and sparse_arm_ok(relation, tabX, tabY, nvl):
        if backend == "cuda":
            from .segment_relations import relation_entries_cuda
            return relation_entries_cuda(relation, tabX, tabY, colg,
                                         nvl=nvl, deg=deg)
        if relation == "VV":
            return _block_vv(tabX, colg, nvl, deg)
        if relation in ("VE", "VF", "VT"):
            return _block_member_v(tabY, colg, nvl, deg)
        if relation == "TT":
            return _block_tt(tabX, colg, nvl, deg)
        return _block_sub_join(tabX, tabY, colg, nvl, deg)
    if relation == "VV":
        mask = _predicate(counts_vv(tabX, nvl, backend), k, exact,
                          exclude_diag=True)
    else:
        mask = _predicate(counts_meet(tabX, tabY, backend), k, exact,
                          exclude_diag=False)
    return _compact(mask, colg, deg)


def _counts_vv_host(T_local: np.ndarray, nvl: int) -> np.ndarray:
    """Shared-tet counts ``C (B, nvl, nvl)`` on the host: the product of
    each segment's tet-vertex incidence with itself (the numpy twin of
    :func:`_counts_vv_onehot`). The product runs in float32, which is
    exact here: every count is at most NT, far below 2**24."""
    B, NT, arity = T_local.shape
    onehot = np.zeros((B, NT, nvl), dtype=np.float32)
    for a in range(arity):
        v = T_local[:, :, a]
        bi, ti = np.nonzero(v >= 0)
        onehot[bi, ti, v[bi, ti]] = 1
    return np.matmul(onehot.transpose(0, 2, 1), onehot).astype(np.int32)


def _counts_pairwise_host(tabX: np.ndarray, tabY: np.ndarray,
                          nvl: int) -> np.ndarray:
    """``C[b, x, y]`` = number of ``tabX[b, x]`` slots whose vertex appears
    in ``tabY[b, y]``, on the host (the numpy twin of
    :func:`_counts_pairwise`): how many of x's slots hold each local
    vertex, times whether y holds it, summed over the ``nvl`` vertices.
    Exact in float32 (every count is at most the arity)."""
    B, NX, ax = tabX.shape
    NY, ay = tabY.shape[1:]
    slots = np.zeros((B, NX, nvl), dtype=np.float32)
    for i in range(ax):
        bi, xi = np.nonzero(tabX[:, :, i] >= 0)
        slots[bi, xi, tabX[bi, xi, i]] += 1
    holds = np.zeros((B, NY, nvl), dtype=np.float32)
    for j in range(ay):
        bi, yi = np.nonzero(tabY[:, :, j] >= 0)
        holds[bi, yi, tabY[bi, yi, j]] = 1
    return np.matmul(slots, holds.transpose(0, 2, 1)).astype(np.int32)


def relation_block_host(
    relation: str,
    tabX: np.ndarray,
    tabY: np.ndarray,
    col_global: np.ndarray,
    nvl: int,
    deg: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pure-numpy host arm of :func:`relation_block` (docs/DESIGN.md §12).

    The degraded production path while a relation's circuit breaker is
    open: dense counts -> predicate -> compaction, all on the host, for
    all ten relations. It gives the same ``(M, L)`` as the card's entry,
    TT, sub-join and count kernels, the plain torch arm and the
    reference's host arm: global ids in ascending local column order,
    ``-1`` padding, and ``L`` the TRUE row count (it may exceed ``deg``),
    so the engine's :class:`~repro_torch.errors.RelationWidthError` check
    still fires. The tables hold local vertex ids below ``nvl``."""
    k, exact = PREDICATE[relation]
    deg = DEFAULT_DEG[relation] if deg is None else deg
    tabX = np.asarray(tabX)
    tabY = np.asarray(tabY)
    colg = np.asarray(col_global).astype(np.int32)
    if relation == "VV":
        C = _counts_vv_host(tabX, nvl)
        mask = (C == k) if exact else (C >= k)
        n = min(C.shape[1], C.shape[2])
        mask[:, np.arange(n), np.arange(n)] = False
    else:
        C = _counts_pairwise_host(tabX, tabY, nvl)
        mask = (C == k) if exact else (C >= k)
    # compaction: a set column's slot is the number of set columns before
    # it; those past deg are dropped, and L keeps the true count
    B, R, _ = mask.shape
    L = mask.sum(axis=2, dtype=np.int32)
    slot = np.cumsum(mask, axis=2, dtype=np.int32) - 1
    b, r, c = np.nonzero(mask & (slot < deg))
    M = np.full((B, R, deg), -1, dtype=np.int32)
    M[b, r, slot[b, r, c]] = colg[b, c]
    return M, L
