"""The port's TT and EF/ET/FT relation blocks and the engine's completion
API against the reference's.

The blocks of ``repro_torch.kernels.ops`` (the plain arms the CUDA kernels
``tt_entries_kernel`` / ``sub_entries_kernel`` are held against) are
compared bit for bit with the reference's ``xla`` arm on several seeds and
with its Pallas kernels in interpret mode on one small shape each; the
engine's full-block reads, device inverse maps, local-row lookups and
boundary relations with the reference engine's on one mesh. Inputs are made
with numpy from a seed and handed to both packages."""

import itertools

import numpy as np
import pytest
import torch

from repro.core.engine import RelationEngine as RefEngine
from repro.core.mesh import segment_mesh as ref_segment_mesh
from repro.core.segtables import precondition as ref_precondition
from repro.data.meshgen import structured_grid as ref_structured_grid
from repro.kernels import ops as ref_ops
from repro.kernels.segment_relations import relation_entries_pallas
from repro_torch.core.engine import RelationEngine
from repro_torch.core.segtables import from_arrays
from repro_torch.kernels import ops, segment_relations

JOIN_RELATIONS = ("TT", "EF", "ET", "FT")
_ARITY = {"E": 2, "F": 3, "T": 4}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_blocks_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


_GRID_TETS = ref_structured_grid(3, 3, 3).tets       # 27 vertices, 48 tets


def _segment_tables(rng, B, n_tets, nvl, pad):
    """Per-segment local tables derived from ``n_tets`` random tets of a
    small grid (so tets share faces as in a mesh), relabelled by a random
    permutation of ``nvl >= 27`` local ids: every edge and face of the tets
    (as local simplex tables list them), vertex order shuffled within each
    row, rows shuffled, ``-1`` padding rows appended. The row counts are
    fixed by ``n_tets`` and ``pad`` alone (every seed gives the reference's
    jit one shape)."""
    tabs = {k: [] for k in "EFT"}
    for _ in range(B):
        pick = rng.choice(len(_GRID_TETS), n_tets, replace=False)
        relabel = rng.permutation(nvl)[:27]
        tets = relabel[_GRID_TETS[pick]].astype(np.int32)
        srt = np.sort(tets, axis=1)
        subs = {"T": srt,
                "F": srt[:, [[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]]],
                "E": srt[:, [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3],
                             [2, 3]]]}
        for k, a in subs.items():
            rows = np.unique(a.reshape(-1, _ARITY[k]), axis=0)
            rows = rows[rng.permutation(len(rows))]
            rows = np.stack([rng.permutation(r) for r in rows])
            tabs[k].append(rows)
    out = {}
    for k, per in tabs.items():
        n = n_tets * {"T": 1, "F": 4, "E": 6}[k] + pad
        tab = np.full((B, n, _ARITY[k]), -1, dtype=np.int32)
        for b, rows in enumerate(per):
            tab[b, :len(rows)] = rows
        out[k] = tab
    return out


def _inputs(relation, tabs, rng):
    tx = tabs[relation[0]]
    ty = tabs[relation[1]]
    B, NY, _ = ty.shape
    colg = rng.integers(0, 10 ** 6, (B, NY)).astype(np.int32)
    colg[(ty < 0).all(-1)] = -1
    return tx, ty, colg


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("relation", JOIN_RELATIONS)
def test_join_blocks_equal_the_xla_arm(relation, seed):
    rng = np.random.default_rng(seed)
    nvl = 31                        # prime; 27 grid vertices relabelled
    tabs = _segment_tables(rng, 3, 19, nvl, pad=2)
    tx, ty, colg = _inputs(relation, tabs, rng)
    got = ops.relation_block(relation, _t(tx), _t(ty), _t(colg), nvl)
    assert [g.dtype for g in got] == [torch.int32, torch.int32]
    _assert_blocks_equal(got, ref_ops.relation_block(
        relation, tx, ty, colg, nvl, backend="xla"))
    assert got[1].max() > 0
    # a narrow width keeps the TRUE counts past it
    narrow = ops.relation_block(relation, _t(tx), _t(ty), _t(colg), nvl,
                                deg=1)
    _assert_blocks_equal(narrow, ref_ops.relation_block(
        relation, tx, ty, colg, nvl, deg=1, backend="xla"))
    assert (narrow[1] > 1).any()


@pytest.mark.parametrize("relation", JOIN_RELATIONS)
def test_join_blocks_equal_the_pallas_kernels(relation):
    # one small shape each: interpret mode compiles once per shape
    rng = np.random.default_rng(7)
    nvl = 27
    tabs = _segment_tables(rng, 2, 5, nvl, pad=1)
    tx, ty, colg = _inputs(relation, tabs, rng)
    deg = ops.DEFAULT_DEG[relation]
    got = ops.relation_block(relation, _t(tx), _t(ty), _t(colg), nvl)
    _assert_blocks_equal(got, relation_entries_pallas(
        relation, tx, ty, colg, nvl=nvl, deg=deg, interpret=True))


def test_dense_fallback_relations_raise():
    """EE/FF and keys past int32 take the dense fallback (counts ->
    predicate -> compaction) in both packages, with equal blocks. (The
    name is the one this check had while the fallback raised.)"""
    rng = np.random.default_rng(11)
    tabs = _segment_tables(rng, 2, 7, 29, pad=2)
    for relation in ("EE", "FF"):
        tx, ty, colg = _inputs(relation, tabs, rng)
        got = ops.relation_block(relation, _t(tx), _t(ty), _t(colg), 29)
        _assert_blocks_equal(got, ref_ops.relation_block(
            relation, tx, ty, colg, 29, backend="xla"))
        assert got[1].max() > 0
    # nvl = 2**11: TT keys (nvl**3) overflow int32 -> the dense fork
    tx, _, colg = _inputs("TT", tabs, rng)
    big = rng.permutation(2 ** 11)[tx].astype(np.int32)
    big[tx < 0] = -1
    assert not ops.sparse_arm_ok("TT", _t(big), _t(big), 2 ** 11)
    got = ops.relation_block("TT", _t(big), _t(big), _t(colg), 2 ** 11)
    _assert_blocks_equal(got, ref_ops.relation_block(
        "TT", big, big, colg, 2 ** 11, backend="xla"))
    assert got[1].max() > 0


# -- the engine's completion API ---------------------------------------------

RELS = ["VE", "VF", "VT", "EF", "ET", "FT", "TT"]


@pytest.fixture(scope="module")
def engines():
    sm = ref_segment_mesh(ref_structured_grid(5, 5, 4), capacity=16)
    ref_pre = ref_precondition(sm, RELS)
    arrays = {k: getattr(ref_pre.smesh, k) for k in
              ref_pre.smesh.__dataclass_fields__}
    arrays.update({k: getattr(ref_pre.tables, k) for k in
                   ref_pre.tables.__dataclass_fields__ if k != "inverse"})
    arrays.update({k: getattr(ref_pre, k) for k in ("E", "I_E", "F", "I_F")})
    pre = from_arrays(arrays)
    return (RefEngine(ref_pre, RELS, tune="off", lookahead=2, batch_max=4),
            RelationEngine(pre, RELS, device="cpu", lookahead=2,
                           batch_max=4))


def test_full_block_reads_equal_the_reference(engines):
    ref, port = engines
    ns = port.smesh.n_segments
    for relation in ("TT", "FT", "EF"):
        for s in (0, ns - 1, 3):
            a, b = ref.get_full(relation, s), port.get_full(relation, s)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
            a = ref.get_full_dev(relation, s)
            b = port.get_full_dev(relation, s)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(np.asarray(x), y.numpy())
        segs = [ns - 1, 2, 0, 2, 5]
        a = ref.get_full_dev_batch(relation, segs, pad_to=8)
        b = port.get_full_dev_batch(relation, segs, pad_to=8)
        for x, y in zip(a, b):
            assert tuple(y.shape[:1]) == (8,)
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
    for f in ("requests", "kernel_launches", "segments_produced",
              "cache_hits", "cache_misses"):
        assert getattr(port.stats, f) == getattr(ref.stats, f), f
    assert port.merged_worker_stats() == port.stats


def test_inverse_maps_and_boundary_relations_equal_the_reference(engines):
    ref, port = engines
    rng = np.random.default_rng(3)
    for kind in "EFT":
        a, b = ref.dev_inverse(kind), port.dev_inverse(kind)
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
        assert (a[3] is None) == (b[3] is None) and a[4] == b[4]
        if a[3] is not None:
            np.testing.assert_array_equal(np.asarray(a[3]), b[3].numpy())
        n = {"E": port.pre.n_edges, "F": port.pre.n_faces,
             "T": port.smesh.n_tets}[kind]
        segs = rng.integers(0, port.smesh.n_segments, 200)
        gids = rng.integers(0, n, 200)
        np.testing.assert_array_equal(ref.local_rows(kind, segs, gids),
                                      port.local_rows(kind, segs, gids))
    with pytest.raises(ValueError, match="shard 1"):
        port.dev_inverse("T", shard=1)
    ids = {"EV": port.pre.n_edges, "FV": port.pre.n_faces,
           "TV": port.smesh.n_tets, "FE": port.pre.n_faces,
           "TE": port.smesh.n_tets, "TF": port.smesh.n_tets}
    for rel, n in ids.items():
        q = rng.integers(0, n, 50)
        np.testing.assert_array_equal(getattr(ref, f"boundary_{rel}")(q),
                                      getattr(port, f"boundary_{rel}")(q))



def test_inverse_start_tables_are_consistent(engines):
    """Each kind's start table covers its maps: segment ``s``'s appearances
    are exactly rows ``start[s]:start[s + 1]`` and ``start[S] == K``."""
    _, port = engines
    S = port.smesh.n_segments
    for kind in "EFT":
        seg = port.dev_inverse(kind)[0].numpy()
        start = port.dev_inverse_starts(kind)
        assert start.dtype == torch.int32 and start.shape == (S + 1,)
        start = start.numpy()
        assert start[0] == 0 and start[S] == len(seg)
        assert (np.diff(start) >= 0).all()
        for s in range(S):
            assert (seg[start[s]:start[s + 1]] == s).all()
    with pytest.raises(KeyError, match="inverse map"):
        port.dev_inverse_starts("V")


# -- the TT kernel's design, in numpy ----------------------------------------

_BIG = 2 ** 31 - 1
_TET_FACES = ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3))


def _tt_partner_slots(T_local, col_global, nvl, deg):
    """What ``tt_entries_kernel`` computes, step for step: face lanes
    ``f * NT + t`` sorted as 64-bit ``(face_key << 32) | lane`` composites,
    each lane's (previous, next) partner slots, then one row per tet from
    the 8 slots of its four face lanes (sorted, ``-1`` and duplicates
    dropped, ``L`` the true count)."""
    B, NT, _ = T_local.shape
    EJ = segment_relations.tt_face_lanes(NT)
    M = np.full((B, NT, deg), -1, dtype=np.int32)
    L = np.zeros((B, NT), dtype=np.int32)
    for b in range(B):
        w = np.sort(T_local[b].astype(np.int64), axis=1)
        fk = np.stack([(w[:, i] * nvl + w[:, j]) * nvl + w[:, k]
                       for i, j, k in _TET_FACES])           # face-major
        key = np.full(EJ, _BIG, dtype=np.int64)
        key[:4 * NT] = np.where(w[None, :, 0] >= 0, fk, _BIG).reshape(-1)
        comp = np.sort((key << 32) | np.arange(EJ))          # all distinct
        face, lane = comp >> 32, comp & 0xffffffff
        same = (face[1:] == face[:-1]) & (face[1:] != _BIG)
        prev = np.full(EJ, -1, dtype=np.int64)
        nxt = np.full(EJ, -1, dtype=np.int64)
        prev[1:] = np.where(same, lane[:-1] % max(NT, 1), -1)
        nxt[:-1] = np.where(same, lane[1:] % max(NT, 1), -1)
        real = lane < 4 * NT
        slots = np.full((4 * NT, 2), -1, dtype=np.int64)
        slots[lane[real], 0] = prev[real]
        slots[lane[real], 1] = nxt[real]
        s = np.sort(slots.reshape(4, NT, 2).transpose(1, 0, 2)
                    .reshape(NT, 8), axis=1)
        before = np.concatenate([np.full((NT, 1), -1), s[:, :-1]], axis=1)
        keep = (s >= 0) & (s != before)
        L[b] = keep.sum(1)
        order = np.argsort(~keep, axis=1, kind="stable")     # kept first
        vals = np.take_along_axis(s, order, axis=1)[:, :deg]
        d = np.arange(vals.shape[1])
        M[b, :, :vals.shape[1]] = np.where(
            d < L[b][:, None], col_global[b][vals.clip(min=0)], -1)
    return M, L


@pytest.mark.parametrize("seed,n_tets,pad", [(0, 19, 2), (1, 19, 2),
                                             (2, 37, 5)])
@pytest.mark.parametrize("deg", [8, 2])
def test_tt_partner_slots_equal_the_blocks(seed, n_tets, pad, deg):
    """Random segment tables (shared faces as in a mesh, -1 padding rows,
    NT not a power of two): the kernel's design gives the plain arm's block
    and the reference's xla block, with at most 4 neighbours a tet."""
    rng = np.random.default_rng(seed)
    nvl = 31
    tabs = _segment_tables(rng, 3, n_tets, nvl, pad=pad)
    tx, _, colg = _inputs("TT", tabs, rng)
    got = _tt_partner_slots(tx, colg, nvl, deg)
    want = ops.relation_block("TT", _t(tx), _t(tx), _t(colg), nvl, deg=deg)
    _assert_blocks_equal(want, got)
    _assert_blocks_equal(want, ref_ops.relation_block(
        "TT", tx, tx, colg, nvl, deg=deg, backend="xla"))
    assert 0 < got[1].max() <= 4
    if deg == 2:                       # the TRUE counts past a narrow width
        assert (got[1] > deg).any()


@pytest.mark.parametrize("name", ["engine", "foot", "fish", "bar"])
def test_tt_partner_slots_on_the_meshgen_datasets(name):
    """The port's datasets, segmented and preconditioned: every segment's
    TT block from the kernel's design equals the plain arm's and the
    reference's xla arm's (NT = 768: 3072 face lanes padded to 4096)."""
    from repro_torch.core.mesh import segment_mesh
    from repro_torch.core.segtables import precondition
    from repro_torch.data.meshgen import load_dataset

    pre = precondition(segment_mesh(load_dataset(name), capacity=64),
                       ["TT"])
    tx = pre.tables.T_local[:16]
    colg = pre.tables.LT_global[:16]
    nvl = pre.tables.NV
    got = _tt_partner_slots(tx, colg, nvl, 8)
    _assert_blocks_equal(ops.relation_block("TT", _t(tx), _t(tx), _t(colg),
                                            nvl, deg=8), got)
    for w, g in zip(ref_ops.relation_block("TT", tx, tx, colg, nvl, deg=8,
                                           backend="xla"), got):
        np.testing.assert_array_equal(np.asarray(w), g)
    assert got[1].max() == 4


def test_tt_face_lanes_and_working_set():
    """The wrapper's sizes match the kernel's layout: at least one warp's
    chunk of 128 face lanes, 4 * NT up to a power of two, and the lane,
    staged-row and slot words of one segment."""
    assert segment_relations.tt_face_lanes(1) == 128
    assert segment_relations.tt_face_lanes(32) == 128
    assert segment_relations.tt_face_lanes(33) == 256
    assert segment_relations.tt_face_lanes(896) == 4096
    # NT = 896, deg 8: 4096 lanes of 8 bytes, then 2 slots a face lane
    assert segment_relations.tt_lane_ints(896, 8) == 8192 + 8 * 896
    # staged rows wider than the lanes take their place, kept even
    assert segment_relations.tt_lane_ints(3, 101) == 304 + 24


# -- the VV and member bitmask kernels' design, in numpy ----------------------

_VV_PAIRS = tuple((a, c) for a in range(4) for c in range(4) if a != c)


def _select_bit(x, k):
    """The ``k``-th (from 0) set bit of each uint32 ``x``: five halvings of
    the window, as ``select_bit`` in ``csrc/segment_relations.cu``."""
    x, k = x.astype(np.uint64), k.astype(np.int64)
    pos = np.zeros(x.shape, dtype=np.int64)
    for s in (16, 8, 4, 2, 1):
        c = _popcount(x & ((1 << s) - 1))
        up = k >= c
        k = np.where(up, k - c, k)
        x = np.where(up, x >> s, x)
        pos += np.where(up, s, 0)
    return pos


def _popcount(x):
    x = np.asarray(x, dtype=np.uint64)
    return np.unpackbits(x.view(np.uint8).reshape(*x.shape, 8),
                         axis=-1).sum(-1).astype(np.int64)


def _emit_bit_rows(mask, values, deg):
    """Mask rows -> ``(M, L)`` as ``emit_bit_rows`` emits them: each
    word's popcount, their exclusive scan along the row (each word's first
    rank), ``L`` the row's total, and ``M[r, d]`` for ``d < min(L, deg)``
    the value of rank ``d``'s order: the last word whose first rank is
    ``<= d``, its ``(d - first)``-th set bit; ``-1`` past. ``values``
    maps an order array to M's values."""
    R, W = mask.shape
    count = _popcount(mask)                                   # (R, W)
    first = np.cumsum(count, axis=1) - count                  # exclusive
    L = count.sum(1).astype(np.int32)
    d = np.arange(deg)
    live = d[None, :] < np.minimum(L, deg)[:, None]           # (R, deg)
    word = (first[:, None, :] <= d[None, :, None]).sum(-1) - 1
    word = word.clip(0, max(W - 1, 0))
    r = np.arange(R)[:, None]
    if W:
        o = word * 32 + _select_bit(mask[r, word], d[None, :]
                                    - first[r, word])
    else:
        o = np.zeros((R, deg), dtype=np.int64)
    return np.where(live, values(o), -1).astype(np.int32), L


def _set_bits(mask, rows, orders):
    rows, orders = rows.astype(np.int64), orders.astype(np.int64)
    np.bitwise_or.at(mask, (rows, orders >> 5),
                     (np.uint32(1) << (orders & 31).astype(np.uint32)))


def _bits_rows(relation, tab, col_global, nvl, deg):
    """What ``vv_bits_kernel`` / ``member_bits_kernel`` compute, step for
    step. The mask: ``nvl`` rows of ``W = ceil(O / 32)`` uint32 words (bit
    ``j`` of word ``w`` is order ``32 * w + j``; O = ``nvl`` for VV, NY for
    member), OR-ed from one walk of the table with ids outside ``[0, nvl)``
    dropped: VV a tet's 12 ordered pairs ``(va, vb)``, member each slot
    ``v`` of row ``y``. Then the rows as :func:`_emit_bit_rows` emits
    them."""
    B, N, a = tab.shape
    O = nvl if relation == "VV" else N
    W = -(-O // 32)
    M = np.full((B, nvl, deg), -1, dtype=np.int32)
    L = np.zeros((B, nvl), dtype=np.int32)
    for b in range(B):
        mask = np.zeros((nvl, W), dtype=np.uint32)
        if relation == "VV":
            rows = np.concatenate([tab[b, :, p] for p, _ in _VV_PAIRS])
            orders = np.concatenate([tab[b, :, c] for _, c in _VV_PAIRS])
            ok = (rows >= 0) & (rows < nvl) & (orders >= 0) & (orders < nvl)
        else:
            rows = tab[b].reshape(-1)
            orders = np.repeat(np.arange(N), a)
            ok = (rows >= 0) & (rows < nvl)
        _set_bits(mask, rows[ok], orders[ok])
        colg = col_global[b]
        if relation == "VV":
            def values(o, colg=colg):
                return np.where(o < len(colg),
                                colg[o.clip(max=len(colg) - 1)], 0)
        else:
            def values(o, colg=colg):
                return colg[o.clip(max=max(N - 1, 0))] if N else o
        M[b], L[b] = _emit_bit_rows(mask, values, deg)
    return M, L


@pytest.mark.parametrize("seed,nvl,holes", [(0, 31, False), (1, 32, True),
                                            (2, 33, False)])
@pytest.mark.parametrize("relation", ["VV", "VE", "VF", "VT"])
def test_bits_rows_equal_the_blocks(relation, seed, nvl, holes):
    """Random segment tables (tets of a grid, so VV pairs repeat across
    tets; -1 padding rows; NY of 116/78/21, not multiples of 32; nvl
    31/32/33 around a word's edge; with ``holes``, -1 slots inside rows):
    the bitmask kernels' design gives the plain arm's block and the
    reference's xla block, at the default width and at one below the
    true counts."""
    rng = np.random.default_rng(seed)
    tabs = _segment_tables(rng, 3, 19, nvl, pad=2)
    if relation == "VV":
        tab = tabs["T"]
        colg = rng.integers(0, 10 ** 6, (3, nvl)).astype(np.int32)
    else:
        tab = tabs[relation[1]]
        colg = rng.integers(0, 10 ** 6, tab.shape[:2]).astype(np.int32)
        colg[(tab < 0).all(-1)] = -1
    if holes:
        tab = tab.copy()
        tab[rng.random(tab.shape) < 0.1] = -1
    for deg in (ops.DEFAULT_DEG[relation], 2):
        got = _bits_rows(relation, tab, colg, nvl, deg)
        _assert_blocks_equal(ops.relation_block(
            relation, _t(tab), _t(tab), _t(colg), nvl, deg=deg), got)
        for w, g in zip(ref_ops.relation_block(relation, tab, tab, colg, nvl,
                                               deg=deg, backend="xla"), got):
            np.testing.assert_array_equal(np.asarray(w), g)
        assert (got[1] > 2).any()          # the TRUE counts past deg 2


@pytest.mark.parametrize("name", ["engine", "foot", "fish", "bar"])
def test_bits_rows_on_the_meshgen_datasets(name):
    """The port's datasets, segmented and preconditioned: every segment's
    VV/VE/VF/VT block from the bitmask design equals the plain arm's and
    the reference's xla arm's (NV of 256 or 384 rows; NE 1024-1280, NF
    1536-1792, NT 768 at capacity 64: 8 to 56 words a row)."""
    from repro_torch.core.mesh import segment_mesh
    from repro_torch.core.segtables import precondition
    from repro_torch.data.meshgen import load_dataset

    rels = ["VV", "VE", "VF", "VT"]
    pre = precondition(segment_mesh(load_dataset(name), capacity=64), rels)
    t, nvl = pre.tables, pre.tables.NV
    cases = {"VV": (t.T_local, t.LV_global), "VE": (t.E_local, t.LE_global),
             "VF": (t.F_local, t.LF_global), "VT": (t.T_local, t.LT_global)}
    for relation, (tab, colg) in cases.items():
        tab, colg = tab[:8], colg[:8]
        deg = ops.DEFAULT_DEG[relation]
        got = _bits_rows(relation, tab, colg, nvl, deg)
        _assert_blocks_equal(ops.relation_block(
            relation, _t(tab), _t(tab), _t(colg), nvl, deg=deg), got)
        for w, g in zip(ref_ops.relation_block(relation, tab, tab, colg, nvl,
                                               deg=deg, backend="xla"), got):
            np.testing.assert_array_equal(np.asarray(w), g)
        assert got[1].max() > 0


# -- the sub-join's keyed bitmask, in numpy ---------------------------------

_SUB_ARITY = {"EF": (2, 3), "ET": (2, 4), "FT": (3, 4)}


def _sub_hash(key, lg):
    return ((key * 2654435761) & 0xffffffff) >> (32 - lg)


def _sorted_key(ids, nvl):
    key = 0
    for v in ids:
        key = key * nvl + int(v)
    return key


def _emit_sparse_rows(mask, values, deg):
    """Mask rows -> ``(M, L)`` as ``emit_sparse_rows`` emits them, one
    row at a time: the row's words in order, each set bit's value written
    while fewer than ``deg`` are, the rest counted by popcount (``L`` the
    TRUE count), ``-1`` past."""
    R, W = mask.shape
    M = np.full((R, deg), -1, dtype=np.int32)
    L = np.zeros(R, dtype=np.int32)
    for r in range(R):
        n = 0
        for w in range(W):
            bits = int(mask[r, w])
            while bits and n < deg:
                low = bits & -bits
                M[r, n] = values(np.array(32 * w + low.bit_length() - 1))
                n += 1
                bits ^= low
            n += bin(bits).count("1")
        L[r] = n
    return M, L


def _emit_wide_rows(mask, values, deg, g):
    """Mask rows -> ``(M, L)`` as ``emit_wide_rows`` emits them, g lanes a
    row: the lanes take g consecutive words at a time, an inclusive scan of
    the words' bit counts gives each lane the rank of its word's first set
    bit, and each lane writes its bits' values at those ranks while below
    ``deg``; ``L`` the TRUE count, ``-1`` from ``min(L, deg)`` on."""
    R, W = mask.shape
    M = np.full((R, deg), -1, dtype=np.int32)
    L = np.zeros(R, dtype=np.int32)
    for r in range(R):
        n = 0
        for w0 in range(0, W, g):
            words = [int(mask[r, w]) if w < W else 0
                     for w in range(w0, w0 + g)]
            counts = [bin(b).count("1") for b in words]
            incl = np.cumsum(counts)
            for lane, bits in enumerate(words):
                pos = n + int(incl[lane]) - counts[lane]
                while bits and pos < deg:
                    low = bits & -bits
                    M[r, pos] = values(np.array(32 * (w0 + lane)
                                                + low.bit_length() - 1))
                    pos += 1
                    bits ^= low
            n += int(incl[-1])
        L[r] = n
    return M, L


def _sub_lanes(rows, threads=1024):
    """Lanes a row of ``sub_bits_kernel``'s emission for blocks of
    ``rows`` rows: the largest power of two up to 32 with ``g * rows <=
    threads`` (1: one thread a row)."""
    g = 1
    while g < 32 and 2 * g * rows <= threads:
        g *= 2
    return g


def _probe(hkey, key, lg):
    """The slot of ``key`` in an open-addressing lookup, or of the empty
    slot that ends its probe."""
    S = len(hkey)
    h = _sub_hash(key, lg)
    while hkey[h] not in (-1, key):
        h = (h + 1) & (S - 1)
    return h


def _sub_bits_rows(relation, tx, ty, col_global, nvl, deg, order=None,
                   rows=None):
    """What ``sub_bits_kernel`` computes, step for step, in blocks of
    ``rows`` subject rows (default all NX: one block a segment). A block's
    lookup: ``segment_relations.sub_slots(rows)`` slots of (key, x),
    filled from its OWN valid x rows ``[r0, r0 + nr)``, in ``order``
    (default ascending x), by linear probing from the Fibonacci hash of
    each one's sorted vertex key (base ``nvl``); a key already held keeps
    the larger x. Then the segment's later valid x rows (``x >= r0 + nr``),
    each raising the x of a key the lookup holds (the tie rule across
    blocks). The walk: each valid y row's ids sorted, the key of each of
    its ``C(ay, ax)`` subsets (``itertools.combinations`` order) probed
    until the key or an empty slot; a hit x among the block's rows sets
    bit y of row x. Keys outside the least and largest key the lookup
    holds are not probed (in the tie pass and in the walk). A row is valid when every id lies in ``[0, nvl)``.
    Then the rows as the kernel emits them, with ``col_global[y]``: one
    thread a row (:func:`_emit_sparse_rows`) or g lanes a row
    (:func:`_emit_wide_rows`, g by :func:`_sub_lanes`)."""
    ax, ay = _SUB_ARITY[relation]
    B, NX, _ = tx.shape
    NY = ty.shape[1]
    rows = NX if rows is None else rows
    S = segment_relations.sub_slots(rows)
    lg = S.bit_length() - 1
    W = -(-NY // 32)
    g = _sub_lanes(rows)
    M = np.full((B, NX, deg), -1, dtype=np.int32)
    L = np.zeros((B, NX), dtype=np.int32)

    def key_of(ids):
        w = np.sort(ids)
        return None if w[0] < 0 or w[-1] >= nvl else _sorted_key(w, nvl)

    for b in range(B):
        mask = np.zeros((NX, W), dtype=np.uint32)
        for r0 in range(0, NX, rows):
            nr = min(rows, NX - r0)
            hkey = np.full(S, -1, dtype=np.int64)
            hx = np.full(S, -1, dtype=np.int64)
            own = range(r0, r0 + nr) if order is None else \
                [x for x in order if r0 <= x < r0 + nr]
            for x in own:
                key = key_of(tx[b, x])
                if key is not None:
                    h = _probe(hkey, key, lg)
                    hkey[h], hx[h] = key, max(hx[h], x)
            held = hkey[hkey >= 0]
            lo, hi = (held.min(), held.max()) if len(held) else (1, 0)
            for x in range(r0 + nr, NX):
                key = key_of(tx[b, x])
                if key is not None and lo <= key <= hi:
                    h = _probe(hkey, key, lg)
                    if hkey[h] == key:
                        hx[h] = max(hx[h], x)
            hit_rows, orders = [], []
            for y in range(NY):
                w = np.sort(ty[b, y])
                if w[0] < 0 or w[-1] >= nvl:
                    continue
                for comb in itertools.combinations(range(ay), ax):
                    key = _sorted_key(w[list(comb)], nvl)
                    if not lo <= key <= hi:
                        continue
                    h = _probe(hkey, key, lg)
                    if hkey[h] == key and r0 <= hx[h] < r0 + nr:
                        hit_rows.append(hx[h])
                        orders.append(y)
            _set_bits(mask, np.array(hit_rows, dtype=np.int64),
                      np.array(orders, dtype=np.int64))
        colg = col_global[b]
        value = lambda o, colg=colg: colg[o]
        M[b], L[b] = _emit_sparse_rows(mask, value, deg) if g == 1 else \
            _emit_wide_rows(mask, value, deg, g)
    return M, L


def _holes(rng, tab):
    tab = tab.copy()
    tab[rng.random(tab.shape) < 0.1] = -1
    return tab


@pytest.mark.parametrize("seed,nvl,holes", [(0, 31, False), (1, 32, True),
                                            (2, 33, False)])
@pytest.mark.parametrize("relation", ["EF", "ET", "FT"])
def test_sub_bits_rows_equal_the_blocks(relation, seed, nvl, holes):
    """Random segment tables (the edges and faces of a grid's tets, so a
    subject has several cofaces; -1 padding rows; NX and NY of 116/78/21,
    not multiples of 32; with ``holes``, -1 slots inside rows): the keyed
    bitmask design gives the plain arm's block and the reference's xla
    block, at the default width and at one below the true counts."""
    rng = np.random.default_rng(seed)
    tabs = _segment_tables(rng, 3, 19, nvl, pad=2)
    tx, ty, colg = _inputs(relation, tabs, rng)
    if holes:
        tx, ty = _holes(rng, tx), _holes(rng, ty)
    for deg in (ops.DEFAULT_DEG[relation], 1):
        got = _sub_bits_rows(relation, tx, ty, colg, nvl, deg)
        _assert_blocks_equal(ops.relation_block(
            relation, _t(tx), _t(ty), _t(colg), nvl, deg=deg), got)
        for w, g in zip(ref_ops.relation_block(relation, tx, ty, colg, nvl,
                                               deg=deg, backend="xla"), got):
            np.testing.assert_array_equal(np.asarray(w), g)
        assert (got[1] > 1).any()          # the TRUE counts past deg 1


@pytest.mark.parametrize("relation", ["EF", "ET", "FT"])
def test_sub_bits_rows_equal_the_pallas_kernel(relation):
    """The shape of ``test_join_blocks_equal_the_pallas_kernels`` (one
    interpret-mode compile each): the keyed bitmask design gives the
    reference's Pallas sub-join block."""
    rng = np.random.default_rng(7)
    nvl = 27
    tabs = _segment_tables(rng, 2, 5, nvl, pad=1)
    tx, ty, colg = _inputs(relation, tabs, rng)
    deg = ops.DEFAULT_DEG[relation]
    got = _sub_bits_rows(relation, tx, ty, colg, nvl, deg)
    for w, g in zip(relation_entries_pallas(relation, tx, ty, colg, nvl=nvl,
                                            deg=deg, interpret=True), got):
        np.testing.assert_array_equal(np.asarray(w), g)
    assert got[1].max() > 0


@pytest.mark.parametrize("name", ["engine", "foot", "fish", "bar"])
def test_sub_bits_rows_on_the_meshgen_datasets(name):
    """The port's datasets, segmented and preconditioned: every segment's
    EF/ET/FT block from the keyed bitmask design equals the plain arm's
    and the reference's xla arm's (NE 1024-1280, NF 1536-1792, NT 768 at
    capacity 64)."""
    from repro_torch.core.mesh import segment_mesh
    from repro_torch.core.segtables import precondition
    from repro_torch.data.meshgen import load_dataset

    rels = ["EF", "ET", "FT"]
    pre = precondition(segment_mesh(load_dataset(name), capacity=64), rels)
    t, nvl = pre.tables, pre.tables.NV
    tables = {"E": t.E_local, "F": t.F_local, "T": t.T_local}
    maps = {"F": t.LF_global, "T": t.LT_global}
    for relation in rels:
        tx, ty = tables[relation[0]][:4], tables[relation[1]][:4]
        colg = maps[relation[1]][:4]
        deg = ops.DEFAULT_DEG[relation]
        got = _sub_bits_rows(relation, tx, ty, colg, nvl, deg)
        _assert_blocks_equal(ops.relation_block(
            relation, _t(tx), _t(ty), _t(colg), nvl, deg=deg), got)
        for w, g in zip(ref_ops.relation_block(relation, tx, ty, colg, nvl,
                                               deg=deg, backend="xla"), got):
            np.testing.assert_array_equal(np.asarray(w), g)
        assert got[1].max() > 0


def test_sub_bits_tie_rule_on_a_repeated_subject_key():
    """Equal subject keys lie outside the arm's precondition. There the
    keyed bitmask gives every entry of the key to its LARGEST subject row
    and none to the others, whatever the order the lookup is filled in;
    every other row equals the plain arm's, and the repeated rows hold
    together what the plain arm's hold."""
    rng = np.random.default_rng(5)
    nvl = 31
    tabs = _segment_tables(rng, 2, 19, nvl, pad=2)
    tx, ty, colg = _inputs("FT", tabs, rng)
    tx = tx.copy()
    tx[:, 40] = tx[:, 3][:, ::-1]            # face 3 again, slots reversed
    tx[:, 60] = tx[:, 3]
    deg = ops.DEFAULT_DEG["FT"]
    got = _sub_bits_rows("FT", tx, ty, colg, nvl, deg)
    again = _sub_bits_rows("FT", tx, ty, colg, nvl, deg,
                           order=rng.permutation(tx.shape[1]))
    for g, a in zip(got, again):
        np.testing.assert_array_equal(g, a)
    assert (got[1][:, 60] > 0).all()
    assert (got[1][:, [3, 40]] == 0).all()
    assert (got[0][:, [3, 40]] == -1).all()
    want = [w.numpy() for w in ops.relation_block(
        "FT", _t(tx), _t(ty), _t(colg), nvl, deg=deg)]
    rest = np.setdiff1d(np.arange(tx.shape[1]), [3, 40, 60])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[:, rest], w[:, rest])
    np.testing.assert_array_equal(got[1][:, [3, 40, 60]].sum(1),
                                  want[1][:, [3, 40, 60]].sum(1))
    for b in range(2):
        held = want[0][b, [3, 40, 60]]
        np.testing.assert_array_equal(got[0][b, 60], held[held[:, 0] >= 0][0])


@pytest.mark.parametrize("rows", [5, 16, 37])
@pytest.mark.parametrize("relation", ["EF", "ET", "FT"])
def test_sub_bits_rows_in_shares_equal_the_blocks(relation, rows):
    """The keyed bitmask design in row shares: each block's lookup holds
    only its own rows' keys (``sub_slots(rows)`` slots), and with few rows
    a block the rows are emitted by g lanes each (32, 32 and 16 lanes at
    5, 16 and 37 rows); the blocks equal the plain arm's and the reference's
    xla block, at the default width and at one below the true counts."""
    assert [_sub_lanes(r) for r in (5, 16, 37, 116, 512, 513)] == \
        [32, 32, 16, 8, 2, 1]
    rng = np.random.default_rng(11)
    nvl = 33
    tabs = _segment_tables(rng, 2, 19, nvl, pad=2)
    tx, ty, colg = _inputs(relation, tabs, rng)
    tx, ty = _holes(rng, tx), _holes(rng, ty)
    for deg in (ops.DEFAULT_DEG[relation], 1):
        got = _sub_bits_rows(relation, tx, ty, colg, nvl, deg, rows=rows)
        _assert_blocks_equal(ops.relation_block(
            relation, _t(tx), _t(ty), _t(colg), nvl, deg=deg), got)
        for w, g in zip(ref_ops.relation_block(relation, tx, ty, colg, nvl,
                                               deg=deg, backend="xla"), got):
            np.testing.assert_array_equal(np.asarray(w), g)
        assert got[1].max() > 0


@pytest.mark.parametrize("rows", [7, 16, 41])
def test_sub_bits_tie_rule_holds_across_shares(rows):
    """A subject key repeated in rows 3, 40 and 60, which fall in three
    different blocks at 7 and 16 rows a block and in two at 41: every
    block's lookup resolves the key to the segment's largest row, 60, so
    that row gets every entry of the key and rows 3 and 40 none, on any
    order of the lookup's inserts, and the blocks equal those of one
    block a segment."""
    rng = np.random.default_rng(5)
    nvl = 31
    tabs = _segment_tables(rng, 2, 19, nvl, pad=2)
    tx, ty, colg = _inputs("FT", tabs, rng)
    tx = tx.copy()
    tx[:, 40] = tx[:, 3][:, ::-1]            # face 3 again, slots reversed
    tx[:, 60] = tx[:, 3]
    deg = ops.DEFAULT_DEG["FT"]
    assert len({x // rows for x in (3, 40, 60)}) >= 2
    whole = _sub_bits_rows("FT", tx, ty, colg, nvl, deg)
    for order in (None, rng.permutation(tx.shape[1])):
        got = _sub_bits_rows("FT", tx, ty, colg, nvl, deg, order=order,
                             rows=rows)
        for g, w in zip(got, whole):
            np.testing.assert_array_equal(g, w)
    assert (whole[1][:, 60] > 0).all()
    assert (whole[1][:, [3, 40]] == 0).all()


def test_entry_route_on_both_sides_of_the_limit():
    """``entry_route`` takes the bitmask kernel exactly while ONE mask row
    fits the given limit: VV and VE/VF/VT beside the 16 warps' rank rows
    (``4 * (1 + 16) * ceil(O / 32)`` bytes, O = nvl for VV and NY
    otherwise), EF/ET/FT (rows of ``ceil(NY / 32) | 1`` words) beside the
    lookup of the block's own subject keys (8 bytes a slot,
    ``next_pow2(4 * rows)`` slots: four for one row, whatever NX) and its
    key range (8 bytes); the wrapper then gives each segment
    ``bits_shares`` blocks, more than the share rule where fewer would not
    fit."""
    route, size = segment_relations.entry_route, \
        segment_relations.bits_smem_bytes
    fit, shares = segment_relations.bits_rows_fit, \
        segment_relations.bits_shares
    slots = segment_relations.sub_slots
    assert size(256, 256) == 4 * 272 * 8
    assert size(256, 1920) == 4 * 272 * 60 and size(256, 1921) == \
        4 * 272 * 61
    assert size(1, 896, True) == 4 * 29 + 8 * 4 + 8
    assert size(3, 1920, True) == 4 * 3 * 61 + 8 * 16 + 8
    assert size(818, 1920, True) == 4 * 818 * 61 + 8 * 4096 + 8
    assert [slots(n) for n in (0, 1, 2, 3, 1280, 1920, 8192, 8193)] == \
        [4, 4, 8, 16, 8192, 8192, 32768, 65536]
    for relation, nvl, NY, NX in (("VV", 256, 0, 0), ("VV", 33, 5, 0),
                                  ("VT", 256, 896, 0), ("VF", 256, 1920, 0),
                                  ("VE", 31, 1281, 0), ("FT", 31, 896, 1920),
                                  ("EF", 31, 1921, 1280), ("ET", 7, 5, 3)):
        O = nvl if relation == "VV" else NY
        sub = relation in _SUB_ARITY
        one = size(1, O, sub)
        assert route(relation, nvl, NY, one) == "bits"
        assert fit(relation, nvl, NY, one) == 1
        assert route(relation, nvl, NY, one - 1) == "sort"
        assert fit(relation, nvl, NY, one - 1) == 0
        # a whole segment's mask: every row in one block
        R = NX if sub else nvl
        whole = size(R, O, sub)
        assert fit(relation, nvl, NY, whole) == R
    h100 = 232448                          # the opt-in limit of an H100
    for relation, NY, NX in (("VV", 896, 0), ("VE", 1280, 0),
                             ("VF", 1920, 0), ("VT", 896, 0),
                             ("EF", 1920, 1280), ("ET", 896, 1280),
                             ("FT", 896, 1920)):     # the 96^3 tables
        assert route(relation, 256, NY, h100) == "bits"
    # masks past the limit now take row shares: VV at nvl 1376 (1335 rows
    # a block) and VT at NY 7680 (226 rows a block), and the capacity-1024
    # tables (NV 2048, NT 8576: 892 and 200 rows a block)
    for relation, nvl, NY, rows in (("VV", 1344, 0, 1367),
                                    ("VV", 1376, 0, 1335),
                                    ("VT", 1664, 7680, 226),
                                    ("VV", 2048, 0, 892),
                                    ("VT", 2048, 8576, 200)):
        assert route(relation, nvl, NY, h100) == "bits"
        assert fit(relation, nvl, NY, h100) == rows
    assert shares("VV", 64, 1376, 1335, 132) == 4
    assert shares("VT", 2, 1664, 226, 132) == 16     # the rule's, past 8
    assert shares("VT", 2, 1664, 226, 4) == 8         # the limit's floor
    assert shares("VV", 64, 2048, 892, 132) == 4
    assert shares("VT", 64, 2048, 200, 132) == 11
    # the single-row limits on an H100: member NY 109,376 (VV never passes
    # it within the int32 key guard, nvl < 46,341), the sub-join NY
    # 1,859,232 (a row of 58,101 words, a lookup of four slots and the key
    # range) whatever its NX: the lookup holds only the block's rows
    assert route("VT", 256, 109376, h100) == "bits"
    assert route("VT", 256, 109377, h100) == "sort"
    assert route("VV", 46340, 0, h100) == "bits"
    assert shares("VV", 64, 46340, fit("VV", 46340, 0, h100), 132) <= 65535
    assert route("FT", 256, 1859232, h100) == "bits"
    assert route("FT", 256, 1859233, h100) == "sort"
    assert fit("FT", 256, 1859232, h100) == 1
    for NX, blocks in ((8192, 6), (8193, 6), (11520, 9), (10 ** 6, 696)):
        # past the old NX limit: as many blocks as 1438 rows a block need
        assert segment_relations.bits_blocks("FT", 64, 256, NX, 896, h100,
                                             132) == blocks
        assert -(-NX // blocks) <= 1438
    # the 48^3 tables at capacity 1024 (NE 11,520, NF 18,048, NT 8576):
    # EF 101 rows of 565 words a block (a lookup of 512 slots), ET 208 of
    # 269 (1024 slots), so 115 and 56 blocks a segment
    assert fit("EF", 2048, 18048, h100) == 101
    assert fit("ET", 2048, 8576, h100) == 208
    assert size(101, 18048, True) <= h100 < size(102, 18048, True)
    assert size(208, 8576, True) <= h100 < size(209, 8576, True)
    for relation, NY, blocks in (("EF", 18048, 115), ("ET", 8576, 56)):
        for B in (8, 64):
            assert segment_relations.bits_blocks(relation, B, 2048, 11520,
                                                 NY, h100, 132) == blocks
        # one segment: the share rule's 132 blocks (88 rows each), 131 whole
        assert segment_relations.bits_blocks(relation, 1, 2048, 11520, NY,
                                             h100, 132) == 131
    # at 96^3, B = 64: FT and EF need two shares at least, ET one; the
    # sub-join's rule gives each of 132 SMs one block (132 // B a segment)
    assert fit("FT", 256, 896, h100) == 1438
    assert fit("EF", 256, 1920, h100) == 818
    assert fit("ET", 256, 896, h100) == 1438
    for relation, R, rows in (("FT", 1920, 1438), ("EF", 1280, 818),
                              ("ET", 1280, 1438)):
        assert shares(relation, 64, R, rows, 132) == 2
    assert shares("EF", 64, 1280, 300, 132) == 5      # fewer would not fit
    sub_blocks = segment_relations.sub_row_blocks
    assert [sub_blocks(B, 1920, 132) for B in (1, 2, 32, 64, 66, 67, 133,
                                               500)] == \
        [132, 66, 4, 2, 2, 1, 1, 1]
    assert sub_blocks(1, 5, 132) == 5
    with pytest.raises(KeyError):
        route("TT", 256, 896, h100)
    # row shares: two blocks for each of 132 SMs in one wave, at most 16 a
    # segment
    blocks = segment_relations.bits_row_blocks
    assert [blocks(B, 256, 132) for B in (1, 8, 16, 17, 32, 64, 66, 67, 88,
                                          132, 264, 500)] == \
        [16, 16, 16, 15, 8, 4, 4, 3, 3, 2, 1, 1]
    assert blocks(1, 3, 132) == 3
