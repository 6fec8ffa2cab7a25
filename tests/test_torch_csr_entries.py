"""The VV and VE/VF/VT sort route's CSR design (``vv_entries_kernel``,
``member_entries_kernel`` of ``csrc/segment_relations.cu``) against the
plain arm and the reference.

The kernels cannot run on a CPU, so :func:`csr_blocks` models them step
for step: the count pass over tiles of the table, the scan of the row
counts, the place pass in a seeded random order of the entries (standing in
for the order in which the atomic cursors are taken), and one row at a time
the warp's sort (the 128-key register network, or the in-place network
past that) and emission. Its blocks must equal ``ops._block_vv`` /
``ops._block_member_v`` and the reference's xla arm on tables with ``-1``
padding, ids past ``nvl``, a vertex repeated within a row, rows of more
than 128 entries, rows past ``deg`` and empty rows. Inputs are made with
numpy from a seed; every case shares one shape per relation, so the
reference compiles once."""

import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import ops, segment_relations

_BIG = 0x7FFFFFFF
_SHORT = 128                       # kCsrShort: rows sorted in registers
_PAIRS = [(a, c) for a in range(4) for c in range(4) if a != c]
_ARITY = {"VE": 2, "VF": 3, "VT": 4}
NVL = 97                           # local vertices (rows) of each segment
B = 3


def _entries(relation, tab, nvl):
    """(row, order) of one segment's valid entries in the table's unit
    order: VV a tet's ordered pairs of ids in [0, nvl), member the slots in
    [0, nvl) of the table walked row-major."""
    if relation == "VV":
        v = tab.reshape(-1, 4)
        rows = np.stack([v[:, a] for a, _ in _PAIRS], 1).reshape(-1)
        orders = np.stack([v[:, c] for _, c in _PAIRS], 1).reshape(-1)
        ok = (rows >= 0) & (rows < nvl) & (orders >= 0) & (orders < nvl)
    else:
        a = tab.shape[-1]
        rows = tab.reshape(-1)
        orders = np.repeat(np.arange(tab.shape[0]), a)
        ok = (rows >= 0) & (rows < nvl)
    return rows[ok].astype(np.int64), orders[ok].astype(np.int64)


def _register_sort(keys):
    """The row of at most 128 keys as the warp sorts it in registers: key
    ``i`` in lane ``i % 32`` of register ``i // 32``, padded with INT32_MAX,
    the direction-flagged bitonic passes of merge sizes 2..P (P the row's
    length up to a power of two, at least 32), as ``warp_passes``."""
    v = np.full(_SHORT, _BIG, dtype=np.int64)
    v[:len(keys)] = keys
    P = 32
    while P < len(keys):
        P *= 2
    idx = np.arange(_SHORT)
    k = 2
    while k <= P:
        j = k // 2
        while j > 0:
            lo = idx[(idx & j) == 0]
            hi = lo + j
            up = (lo & k) == 0
            swap = (v[lo] > v[hi]) == up
            a, b = v[lo].copy(), v[hi].copy()
            v[lo] = np.where(swap, b, a)
            v[hi] = np.where(swap, a, b)
            j //= 2
        k *= 2
    return v


def _in_place_sort(keys):
    """The row of more than 128 keys as ``warp_sort_in_place`` sorts it in
    the workspace: merge sizes k = 2..P, the first comparator of each merge
    pairing ``lo`` with its mirror ``lo ^ (k - 1)``, the others ``lo`` with
    ``lo + j``, the smaller key kept at the lower index, and every
    comparator whose upper index passes the row's length skipped."""
    v = np.array(keys, dtype=np.int64)
    c = len(v)
    P = 1
    while P < c:
        P *= 2
    i = np.arange(P // 2)
    k = 2
    while k <= P:
        j = k // 2
        while j > 0:
            lo = ((i & ~(j - 1)) << 1) | (i & (j - 1))
            hi = lo ^ (k - 1) if j == k // 2 else lo + j
            live = hi < c
            lo, hi = lo[live], hi[live]
            a, b = v[lo].copy(), v[hi].copy()
            v[lo] = np.minimum(a, b)
            v[hi] = np.maximum(a, b)
            j //= 2
        k *= 2
    return v


def _emit(sorted_keys, c, deg, value):
    """One warp's emission of a sorted row of c keys: the keys that differ
    from their left neighbour, their TRUE count, the first deg as values
    and -1 after."""
    x = sorted_keys[:c]
    prev = np.concatenate([[-1], x[:-1]])
    uniq = x[(x != prev) & (x != _BIG)]
    row = np.full(deg, -1, dtype=np.int64)
    row[:min(len(uniq), deg)] = value(uniq[:deg])
    return row, len(uniq)


def csr_blocks(relation, tab, col_global, nvl, deg, seed=0, sms=132):
    """``(M, L)`` as the four passes of the sort route compute them (see the
    module docstring); ``seed`` orders the place pass's atomics."""
    rng = np.random.default_rng(seed)
    Bn = tab.shape[0]
    units = tab.shape[1] * (1 if relation == "VV" else tab.shape[2])
    n = 12 * tab.shape[1] if relation == "VV" else units
    tile = max(1, -(-units // segment_relations.csr_tiles(Bn, n, sms)))
    M = np.full((Bn, nvl, deg), -1, dtype=np.int64)
    L = np.zeros((Bn, nvl), dtype=np.int64)
    for b in range(Bn):
        # count: each tile's histogram, added into the row counts
        cnt = np.zeros(nvl, dtype=np.int64)
        for u0 in range(0, units, tile):
            part = (tab[b, u0:u0 + tile] if relation == "VV" else
                    tab[b].reshape(-1)[u0:u0 + tile])
            if relation == "VV":
                rows, _ = _entries("VV", part, nvl)
            else:
                rows = part[(part >= 0) & (part < nvl)]
            cnt += np.bincount(rows, minlength=nvl)
        # scan: the row starts, and the cursors back at 0
        start = np.concatenate([[0], np.cumsum(cnt)])
        # place: each entry in its row's next slot, in the atomics' order
        rows, orders = _entries(relation, tab[b], nvl)
        assert len(rows) == start[-1]
        keys = np.full(len(rows), -7, dtype=np.int64)
        cursor = np.zeros(nvl, dtype=np.int64)
        for e in rng.permutation(len(rows)):
            r = rows[e]
            keys[start[r] + cursor[r]] = orders[e]
            cursor[r] += 1
        assert (cursor == cnt).all() and (keys >= 0).all()
        colg = col_global[b].astype(np.int64)
        if relation == "VV":
            def value(o, colg=colg):
                return np.where(o < len(colg), colg[o.clip(max=len(colg)
                                                             - 1)], 0)
        else:
            def value(o, colg=colg):
                return colg[o]
        # rows: sort, drop duplicates, emit
        for r in range(nvl):
            row = keys[start[r]:start[r + 1]]
            c = len(row)
            srt = _register_sort(row) if c <= _SHORT else _in_place_sort(row)
            M[b, r], L[b, r] = _emit(srt, c, deg, value)
    return M.astype(np.int32), L.astype(np.int32)


def _tables(relation, seed):
    """One relation's adversarial tables (B = 3 segments, NVL rows, a shape
    fixed per relation): random simplices of distinct local ids below 80
    (rows 80..96 stay empty), the last rows -1 padding, -1 slots inside rows;
    one vertex in 60 tets (VV: 180 raw entries, 59 distinct neighbours at
    most) or in 150 member rows (a row of 150 entries); segment 1 with a
    vertex repeated within a row and ids past nvl."""
    rng = np.random.default_rng(seed)
    a = 4 if relation == "VV" else _ARITY[relation]
    N = 211 if relation == "VV" else 263
    tab = np.full((B, N, a), -1, dtype=np.int32)
    for b in range(B):
        k = N - 9
        tab[b, :k] = np.argsort(rng.random((k, 80)), axis=1)[:, :a]
    heavy = 60 if relation == "VV" else 150
    for b in range(B):
        rows = rng.choice(N - 9, heavy, replace=False)
        rows = rows[~(tab[b, rows] == 5).any(-1)]
        tab[b, rows, 0] = 5
    holes = rng.random(tab.shape) < 0.05
    tab[holes] = -1
    tab[1, 3, :2] = [7, 7]                 # a vertex twice in one row
    tab[1, 4, a - 2:] = [11, 11]
    tab[1, 10, 0] = NVL + 3                # ids past nvl
    tab[1, 12, a - 1] = NVL
    ncol = NVL if relation == "VV" else N
    colg = rng.integers(0, 10 ** 6, (B, ncol)).astype(np.int32)
    return tab, colg


def _plain(relation, tab, colg, deg):
    """The plain arm's block of ``relation``; VV ids past nvl are dropped as
    ``-1`` slots first (the plain VV key ``va * nvl + vb`` would carry such
    a vb into a later row; the kernels of both routes drop it)."""
    if relation == "VV":
        tab = np.where(tab >= NVL, -1, tab).astype(np.int32)
    t = torch.from_numpy(tab)
    c = torch.from_numpy(colg)
    if relation == "VV":
        got = ops._block_vv(t, c, NVL, deg)
    else:
        got = ops._block_member_v(t, c, NVL, deg)
    return [g.numpy() for g in got], tab


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("relation", ["VV", "VE", "VF", "VT"])
def test_csr_blocks_equal_the_plain_arm_and_the_reference(relation, seed):
    """The design's blocks equal the plain arm's and the reference's xla
    arm's at the default width and at width 3 (rows past deg), on tables
    with every adversarial case of :func:`_tables`; the tables have them."""
    tab, colg = _tables(relation, seed)
    for deg in (ops.DEFAULT_DEG[relation], 3):
        got = csr_blocks(relation, tab, colg, NVL, deg, seed=seed)
        want, clean = _plain(relation, tab, colg, deg)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        ref = ref_ops.relation_block(relation, clean, clean, colg, NVL,
                                     deg=deg, backend="xla")
        for g, w in zip(got, ref):
            np.testing.assert_array_equal(g, np.asarray(w))
        L = got[1]
        assert (L > deg).any()                     # rows past deg
        assert (L[:, 80:] == 0).all()              # empty rows
    rows, _ = _entries(relation, tab[0], NVL)
    assert np.bincount(rows).max() > _SHORT        # a row past 128 entries


@pytest.mark.parametrize("relation", ["VV", "VF"])
def test_two_place_orders_give_equal_blocks(relation):
    """The order in which the place pass's atomic cursors are taken changes
    where a key lands in its row, never the block."""
    tab, colg = _tables(relation, 2)
    first = csr_blocks(relation, tab, colg, NVL, 8, seed=0)
    for seed in (1, 2):
        for g, w in zip(csr_blocks(relation, tab, colg, NVL, 8, seed=seed),
                        first):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("c", [1, 2, 31, 33, 64, 100, 128, 129, 200, 255,
                               256, 257, 777])
def test_row_sort_networks_sort_every_length(c):
    """The register network (up to 128 keys) and the in-place network (past
    128; also checked below it) sort rows of any length, duplicates
    included, without touching a slot past the row."""
    rng = np.random.default_rng(c)
    keys = rng.integers(0, max(2, c // 3), c)
    want = np.sort(keys)
    np.testing.assert_array_equal(_in_place_sort(keys), want)
    if c <= _SHORT:
        got = _register_sort(keys)
        np.testing.assert_array_equal(got[:c], want)
        assert (got[c:] == _BIG).all()


def test_workspace_and_tiles():
    """``csr_ints``: a segment's nvl counts, nvl + 1 starts and n keys;
    ``csr_tiles``: four blocks a multiprocessor over the launch, at least
    2048 entries a block, at least one and at most 65,535 blocks."""
    ints, tiles = segment_relations.csr_ints, segment_relations.csr_tiles
    assert ints(0, 1) == 3
    assert ints(3 * 111616, 11008) == 334848 + 22017      # VF, capacity 8192
    assert ints(12 * 8576, 2048) == 102912 + 4097         # VV, capacity 1024
    assert ints(4 * 8576, 2048) == 34304 + 4097           # VT, capacity 1024
    assert tiles(14, 3 * 111616, 132) == 38
    assert tiles(64, 4 * 8576, 132) == 9
    assert tiles(64, 12 * 8576, 132) == 9
    assert tiles(64, 3584, 132) == 2                      # 2048 a block
    assert tiles(1, 10, 132) == 1
    assert tiles(0, 0, 132) == 1
    assert tiles(1, 10 ** 9, 10 ** 6) == 65535


def test_entry_route_at_the_capacity_8192_tables():
    """The 48^3 quickstart mesh at capacity 8192 (nvl 11,008, NF 111,616,
    NT 54,016): VF passes the member kernel's one-row limit on an H100
    (232,448 bytes) and takes the sort route; VT and VE stay on the
    bitmask route."""
    route = segment_relations.entry_route
    h100 = 232448
    assert route("VF", 11008, 111616, h100) == "sort"
    assert route("VT", 11008, 54016, h100) == "bits"
    assert route("VE", 11008, 68480, h100) == "bits"
