"""The port's cross-segment completion against the reference's: the row
resolve (single-key and lexicographic searches) and the gather + union of
``kernels/completion_gather.py`` against the reference's ``xla`` arm and its
Pallas kernel in interpret mode; ``complete_adjacency("TT")`` on the host
path, the device path and the device path with ``out="dev"`` against the
reference, the scalar oracle and the reference's completion stats; and the
boundary flag of ``critical_points`` built on it. Inputs are made with numpy
from a seed and handed to both packages."""

import numpy as np
import pytest
import torch

from repro.algorithms import fields as ref_fields
from repro.algorithms.critical_points import \
    boundary_vertices as ref_boundary_vertices
from repro.algorithms.critical_points import \
    critical_points as ref_critical_points
from repro.core.adjacency import complete_adjacency as ref_complete
from repro.core.engine import RelationEngine as RefEngine
from repro.core.mesh import segment_mesh as ref_segment_mesh
from repro.core.segtables import precondition as ref_precondition
from repro.data.meshgen import structured_grid as ref_structured_grid
from repro.kernels import completion_gather as ref_cg
from repro_torch.algorithms import fields
from repro_torch.algorithms.critical_points import boundary_vertices, \
    critical_points, total_order
from repro_torch.core.adjacency import complete_adjacency, \
    complete_adjacency_scalar
from repro_torch.core.engine import RelationEngine
from repro_torch.core.mesh import segment_mesh
from repro_torch.core.segtables import precondition
from repro_torch.data.meshgen import structured_grid
from repro_torch.errors import RelationWidthError
from repro_torch.kernels import completion_gather as cg


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inverse_maps(rng, ns, n_global, K):
    """Sorted unique (seg, gid) appearances with random local rows."""
    key = np.unique(rng.integers(0, ns * n_global, K))
    seg = (key // n_global).astype(np.int32)
    gid = (key % n_global).astype(np.int32)
    row = rng.integers(0, 50, len(key)).astype(np.int32)
    return key.astype(np.int32), seg, gid, row


def _queries(rng, seg, gid, ns, n_global, P):
    """Present pairs, absent pairs, pairs past the last key (the search
    ends at lo == K) and the padding pair (0, -1)."""
    pick = rng.integers(0, len(seg), P)
    qs, qg = seg[pick].copy(), gid[pick].copy()
    absent = rng.random(P) < 0.3
    qs[absent] = rng.integers(0, ns, absent.sum())
    qg[absent] = rng.integers(0, n_global, absent.sum())
    qs[:3], qg[:3] = ns + 1, [0, 5, n_global - 1]     # beyond every key
    qs[3], qg[3] = 0, -1                              # padding
    return qs.astype(np.int32), qg.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_resolve_rows_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    ns, n_global = 13, 101
    key, seg, gid, row = _inverse_maps(rng, ns, n_global, 600)
    qs, qg = _queries(rng, seg, gid, ns, n_global, 257)
    want_lex = np.asarray(ref_cg.resolve_rows(seg, gid, row, qs, qg))
    want_key = np.asarray(ref_cg.resolve_rows(
        seg, gid, row, qs, qg, inv_key=key, n_global=n_global))
    np.testing.assert_array_equal(want_lex, want_key)
    got_lex = cg.resolve_rows(_t(seg), _t(gid), _t(row), _t(qs), _t(qg))
    got_key = cg.resolve_rows(_t(seg), _t(gid), _t(row), _t(qs), _t(qg),
                              inv_key=_t(key), n_global=n_global)
    np.testing.assert_array_equal(got_lex.numpy(), want_lex)
    np.testing.assert_array_equal(got_key.numpy(), want_lex)
    assert (want_lex == -1).sum() > 3 and (want_lex >= 0).sum() > 100
    # a map of one appearance, and no appearance at all
    one = [a[:1] for a in (seg, gid, row)]
    np.testing.assert_array_equal(
        cg.resolve_rows(*map(_t, one), _t(qs), _t(qg)).numpy(),
        np.asarray(ref_cg.resolve_rows(*one, qs, qg)))
    empty = [a[:0] for a in (seg, gid, row)]
    assert (cg.resolve_rows(*map(_t, empty), _t(qs), _t(qg)) == -1).all()


def _gather_inputs(rng, S=5, R=9, degp=4, n=11, w=4):
    ns, n_global = 7, 40
    key, seg, gid, row = _inverse_maps(rng, ns, n_global, 120)
    row = (row % R).astype(np.int32)
    pool_M = rng.integers(-1, 60, (S, R, degp)).astype(np.int32)
    pool_L = rng.integers(0, degp + 2, (S, R)).astype(np.int32)  # L > degp
    P = 29
    qs, qg = _queries(rng, seg, gid, ns, n_global, P)
    slot = rng.integers(0, S, P).astype(np.int32)
    slot[-4:] = -1                                    # inert padding pairs
    pair_at = np.full((n, w), -1, dtype=np.int32)
    q = rng.integers(0, n, P)
    for p in range(P):
        free = np.nonzero(pair_at[q[p]] < 0)[0]
        if len(free):
            pair_at[q[p], free[0]] = p
    return dict(pool_M=pool_M, pool_L=pool_L, inv_seg=seg, inv_gid=gid,
                inv_row=row, pair_slot=slot, pair_seg=qs, pair_gid=qg,
                pair_at=pair_at), key, n_global


@pytest.mark.parametrize("use_key", [False, True])
def test_gather_union_equals_the_reference(use_key):
    rng = np.random.default_rng(5 + use_key)
    args, key, n_global = _gather_inputs(rng)
    kw = dict(inv_key=key, n_global=n_global) if use_key else {}
    for deg_out in (3, 8):
        want = ref_cg.gather_union(**args, deg_out=deg_out, backend="xla",
                                   **kw)
        got = cg.gather_union(**{k: _t(v) for k, v in args.items()},
                              deg_out=deg_out, backend="torch",
                              **{k: _t(v) if k == "inv_key" else v
                                 for k, v in kw.items()})
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert int(want[1].max()) > 3        # rows truncated at deg_out=3
    # the Pallas resolve + gather kernel, in interpret mode (one shape)
    if not use_key:
        want = ref_cg.gather_union(**args, deg_out=8,
                                   backend="pallas_interpret")
        got = cg.gather_union(**{k: _t(v) for k, v in args.items()},
                              deg_out=8, backend="torch")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the plain version of the kernel, alone: every pair gets the clamped
    # pool row; unresolved or slot -1 pairs get length 0
    cand, clen = cg.resolve_gather_torch(
        *(_t(args[k]) for k in ("pool_M", "pool_L", "inv_seg", "inv_gid",
                                "inv_row", "pair_slot", "pair_seg",
                                "pair_gid")))
    assert cand.shape == (29, 4) and (clen[-4:] == 0).all()


def test_cuda_backend_needs_cuda_tensors():
    rng = np.random.default_rng(1)
    args, _, _ = _gather_inputs(rng)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cg.gather_union(**{k: _t(v) for k, v in args.items()}, deg_out=8,
                        backend="cuda")
    # one shard's half of the sharded exchange: the masked kernel, the
    # same CUDA-only contract
    with pytest.raises(ValueError, match="CUDA tensor"):
        cg.gather_candidates(**{k: _t(v) for k, v in args.items()
                                if k != "pair_at"}, backend="cuda")


# -- complete_adjacency("TT") --------------------------------------------------

def _grid(gen, fld):
    return gen(6, 5, 5, scalar_fn=fld.gaussians(3, k=3, sigma=2.0, scale=6))


@pytest.fixture(scope="module")
def meshes():
    ref_pre = ref_precondition(ref_segment_mesh(
        _grid(ref_structured_grid, ref_fields), capacity=16),
        ["VV", "VT", "FT", "TT"])
    pre = precondition(segment_mesh(_grid(structured_grid, fields),
                                    capacity=16), ["VV", "VT", "FT", "TT"])
    return ref_pre, pre


STATS = ("completion_queries", "completion_fanout_blocks",
         "completion_raw_neighbors", "completion_neighbors")


@pytest.mark.parametrize("batch,workers", [(None, 1), (97, 1), (61, 3)])
def test_complete_tt_equals_the_reference(meshes, batch, workers):
    ref_pre, pre = meshes
    nt = pre.smesh.n_tets
    ids = np.random.default_rng(batch or 0).permutation(nt)[:300]
    ref = RefEngine(ref_pre, ["TT"], tune="off")
    want_M, want_L = ref_complete(ref, "TT", ids, batch=batch,
                                  workers=workers)
    outs = {}
    for path, out in (("host", "host"), ("device", "host"),
                      ("device", "dev")):
        eng = RelationEngine(pre, ["TT"], device="cpu")
        M, L = complete_adjacency(eng, "TT", ids, batch=batch, path=path,
                                  out=out, workers=workers)
        if out == "dev":
            assert isinstance(M, torch.Tensor) and M.shape[1] == 8
            assert (M[:, want_M.shape[1]:] == -1).all()
            M, L = M[:, :want_M.shape[1]].numpy(), L.numpy()
        np.testing.assert_array_equal(M, want_M)
        np.testing.assert_array_equal(L, want_L)
        outs[(path, out)] = eng.stats
        for f in STATS:
            assert getattr(eng.stats, f) == getattr(ref.stats, f), (path, f)
        assert eng.merged_worker_stats() == eng.stats
    assert outs[("device", "dev")].completion_dedup_ratio == \
        ref.stats.completion_dedup_ratio > 1.0
    sM, sL = complete_adjacency_scalar(RelationEngine(pre, ["TT"],
                                                      device="cpu"),
                                       "TT", ids)
    np.testing.assert_array_equal(sM, want_M)
    np.testing.assert_array_equal(sL, want_L)


def test_completion_checks(meshes):
    _, pre = meshes
    eng = RelationEngine(pre, ["TT"], device="cpu", deg={"TT": 2})
    with pytest.raises(RelationWidthError, match="deg"):
        complete_adjacency(eng, "TT", np.arange(40), path="device")
    eng = RelationEngine(pre, ["VV", "TT"], device="cpu")
    with pytest.raises(ValueError, match="engine's relation set"):
        complete_adjacency(eng, "FF", [0])
    with pytest.raises(ValueError, match="device execute arm"):
        complete_adjacency(eng, "TT", [0], path="host", out="dev")
    with pytest.raises(ValueError, match="shards=2"):
        complete_adjacency(eng, "TT", [0], shards=2)
    # no query: empty rows of the right width on either arm
    M, L = complete_adjacency(eng, "TT", [], path="device", out="dev")
    assert M.shape == (0, 8) and L.shape == (0,)


# -- critical_points(flag_boundary=True) / boundary_vertices -----------------

@pytest.mark.parametrize("consumer,workers", [("device", 1), ("host", 3)])
def test_boundary_flag_equals_the_reference(meshes, consumer, workers):
    ref_pre, pre = meshes
    rels = ["VV", "VT", "TT"]
    rank = total_order(pre.smesh.scalars)
    ref = RefEngine(ref_pre, rels, tune="off")
    want_types, want = ref_critical_points(ref, ref_pre, rank,
                                           flag_boundary=True)
    want_mask = ref_boundary_vertices(ref, ref_pre)
    eng = RelationEngine(pre, rels, device="cpu")
    types, counts = critical_points(eng, pre, rank, flag_boundary=True,
                                    consumer=consumer, workers=workers)
    assert counts == want and counts["boundary_critical"] > 0
    np.testing.assert_array_equal(types, want_types)
    mask = boundary_vertices(eng, pre, batch=211, consumer=consumer,
                             workers=workers)
    np.testing.assert_array_equal(mask, want_mask)
    assert 0 < mask.sum() < len(mask)


# -- the gather kernel's design, in numpy ------------------------------------

def _warp_lower_bound(gids, lo, hi, qg):
    """``warp_lower_bound`` of ``csrc/completion_gather.cu``: 32 evenly
    spaced reads and a ballot narrow the run until at most 32 gids are
    left, then one read of those."""
    lanes = np.arange(32)
    while hi - lo > 32:
        step = (hi - lo + 31) // 32
        pos = lo + lanes * step
        less = (pos < hi) & (gids[np.minimum(pos, hi - 1)] < qg)
        c = int(less.sum())
        assert less[:c].all()                 # the ballot is a prefix
        if c == 0:
            return lo
        lo, hi = lo + (c - 1) * step + 1, min(lo + c * step, hi)
    pos = lo + lanes
    less = (pos < hi) & (gids[np.minimum(pos, max(hi - 1, 0))] < qg)
    return lo + int(less.sum())


def _windowed_resolve_gather(pool_M, pool_L, inv_seg, inv_gid, inv_row,
                             slot, seg, gid, inv_key=None, n_global=0,
                             start=None):
    """What ``resolve_gather_kernel`` computes for each pair: inside the
    start table's domain, the warp's search of the pair's segment run
    (bounds clamped to [0, K]); outside it, the full binary search (the
    combined key wrapping as int32 on the key arm)."""
    S, R, degp = pool_M.shape
    K, n_seg = len(inv_seg), len(start) - 1
    rows = np.full(len(slot), -1, dtype=np.int64)
    for p, (qs, qg) in enumerate(zip(seg.tolist(), gid.tolist())):
        if K == 0:
            continue
        dom = 0 <= qs < n_seg
        if inv_key is not None:
            dom = dom and 0 <= qg < n_global and qs * n_global + qg < 2 ** 31
        if dom:
            lo = min(max(int(start[qs]), 0), K)
            hi = min(max(int(start[qs + 1]), 0), K)
            pos = _warp_lower_bound(inv_gid, lo, hi, qg)
            if pos < hi and inv_gid[pos] == qg:
                rows[p] = inv_row[pos]
        elif inv_key is not None:
            q = (qs * n_global + qg + 2 ** 31) % 2 ** 32 - 2 ** 31
            pos = min(int(np.searchsorted(inv_key, q)), K - 1)
            rows[p] = inv_row[pos] if inv_key[pos] == q else -1
        else:
            pos = int(np.searchsorted(
                inv_seg.astype(np.int64) * 2 ** 32 + inv_gid + 2 ** 31,
                qs * 2 ** 32 + qg + 2 ** 31))
            if pos < K and inv_seg[pos] == qs and inv_gid[pos] == qg:
                rows[p] = inv_row[pos]
    ok = (slot >= 0) & (rows >= 0)
    flat = np.maximum(slot, 0).astype(np.int64) * R + rows.clip(0, R - 1)
    cand = pool_M.reshape(S * R, degp)[flat]
    clen = np.where(ok, pool_L.reshape(S * R)[flat], 0).astype(np.int32)
    return cand, clen


def _assert_gather_equal(args, **kw):
    """The design's answer equals the plain arm's, on the same inputs."""
    start = kw.pop("start")
    key = kw.get("inv_key")
    want = cg.resolve_gather_torch(
        *map(_t, args), **{k: _t(v) if k == "inv_key" else v
                           for k, v in kw.items()})
    got = _windowed_resolve_gather(*args, start=start, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    assert key is None or key.dtype == np.int32
    return want


def _start_table(seg, n_seg):
    return np.searchsorted(seg, np.arange(n_seg + 1)).astype(np.int32)


@pytest.mark.parametrize("use_key", [False, True])
def test_windowed_gather_equals_the_plain_arm_on_synthetic_maps(use_key):
    """Runs longer than 32 and 1024 gids (two and three rounds), an empty
    segment, the last segment, a far segment, segments past S and below 0,
    the padding pair, and maps cut to an odd K inside a segment's run."""
    rng = np.random.default_rng(3 + use_key)
    n_seg, n_global, R, degp = 9, 5000, 40, 4
    runs = {0: 3000, 1: 700, 2: 33, 3: 0, 4: 1, 5: 32, 6: 200, 7: 0,
            8: 1500}                                   # 3 and 7 are empty
    seg = np.concatenate([np.full(n, s) for s, n in runs.items()])
    gid = np.concatenate([np.sort(rng.choice(n_global, n, replace=False))
                          for n in runs.values()])
    seg, gid = seg.astype(np.int32), gid.astype(np.int32)
    row = rng.integers(0, R, len(seg)).astype(np.int32)
    start = _start_table(seg, n_seg)
    P = 600
    pick = rng.integers(0, len(seg), P)
    qs, qg = seg[pick].copy(), gid[pick].copy()
    qg[::3] = rng.integers(-1, n_global + 1, len(qg[::3]))    # absent
    qs[::7] = rng.integers(0, n_seg, len(qs[::7]))            # far
    qs[1:12] = [3, 7, 8, 8, n_seg, n_seg + 4, -1, -5, 0, 0, 0]
    qg[1:12] = [5, 0, gid[-1], n_global - 1, 0, 3, gid[0], 0, -1,
                gid[0], gid[2999]]
    slot = rng.integers(-1, 6, P).astype(np.int32)
    slot[-8:] = -1                                             # padding
    qs[-8:], qg[-8:] = 0, -1
    pool_M = rng.integers(-1, 10 ** 5, (6, R, degp)).astype(np.int32)
    pool_L = rng.integers(0, degp + 1, (6, R)).astype(np.int32)
    key = (seg.astype(np.int64) * n_global + gid).astype(np.int32)
    kw = dict(inv_key=key, n_global=n_global) if use_key else {}
    want = _assert_gather_equal(
        (pool_M, pool_L, seg, gid, row, slot, qs, qg), start=start, **kw)
    assert (want[1] > 0).sum() > P // 3 and (want[1] == 0).sum() > P // 5
    # maps cut to an odd K inside segment 0's run: the start table of the
    # whole maps still serves, its bounds clamped to K
    K2 = 1501
    cut = tuple(a[:K2] for a in (seg, gid, row))
    kw = dict(inv_key=key[:K2], n_global=n_global) if use_key else {}
    _assert_gather_equal((pool_M, pool_L, *cut, slot, qs, qg), start=start,
                         **kw)
    # no appearance at all
    empty = tuple(a[:0] for a in (seg, gid, row))
    kw = dict(inv_key=key[:0], n_global=n_global) if use_key else {}
    cand, clen = _windowed_resolve_gather(pool_M, pool_L, *empty, slot, qs,
                                          qg, start=start, **kw)
    assert (clen == 0).all()


def test_windowed_gather_follows_a_key_that_wraps_int32():
    """On the inv_key arm a pair whose combined key passes 2**31 leaves the
    start table's domain and takes the full search with the wrapped key,
    which may land on another segment's appearance: the plain arm's
    answer, found rows included."""
    rng = np.random.default_rng(11)
    n_global, n_seg = 2 ** 20, 4100                   # start table past 2**32
    seg = np.repeat(np.array([0, 1, 2040], np.int32), 50)
    gid = np.concatenate([np.sort(rng.choice(n_global, 50, replace=False))
                          for _ in range(3)]).astype(np.int32)
    row = rng.integers(0, 9, len(seg)).astype(np.int32)
    key = (seg.astype(np.int64) * n_global + gid)
    assert key[-1] < 2 ** 31
    start = _start_table(seg, n_seg)
    qs = np.array([4096, 4097, 4096, 2048, 2040, 1, 4099], np.int32)
    qg = np.array([gid[0], gid[60], 7, gid[3], gid[120], gid[70], 0],
                  np.int32)
    slot = np.zeros(len(qs), np.int32)
    pool_M = rng.integers(0, 99, (1, 9, 2)).astype(np.int32)
    pool_L = np.full((1, 9), 2, np.int32)
    want = _assert_gather_equal(
        (pool_M, pool_L, seg, gid, row, slot, qs, qg), start=start,
        inv_key=key.astype(np.int32), n_global=n_global)
    assert want[1][:2].tolist() == [2, 2]          # found through the wrap
    assert want[1][2] == 0 and want[1][4] == 2


def test_windowed_gather_with_the_engines_start_table(meshes):
    """A real TT completion chunk: the engine's inverse maps and start
    table, the pool of its planned segments, on the key arm (this mesh's
    keys fit int32) and the lexicographic arm, plus far and past-the-end
    segments."""
    from repro_torch.core.adjacency import plan_completion

    _, pre = meshes
    kind, relation = "T", "TT"
    eng = RelationEngine(pre, ["TT"], device="cpu")
    ids = np.random.default_rng(2).permutation(pre.smesh.n_tets)[:200]
    plan = plan_completion(eng, relation, ids, prefetch=False)
    pool_M, pool_L = (t.numpy() for t in eng.get_full_dev_batch(
        relation, plan.segments, pad_to=8 * len(plan.segments)))
    seg, gid, row, key, n_glob = (t.numpy() if isinstance(t, torch.Tensor)
                                  else t for t in eng.dev_inverse(kind))
    assert key is not None
    start = eng.dev_inverse_starts(kind).numpy()
    P = len(plan.pair_seg)
    slot = np.searchsorted(plan.segments, plan.pair_seg).astype(np.int32)
    qs = plan.pair_seg.astype(np.int32)
    qg = plan.ids[plan.pair_query].astype(np.int32)
    ns = pre.smesh.n_segments
    far = qs.copy()
    far[::3] = (far[::3] + ns // 2) % ns
    far[1::5] = ns + 2
    for q in (qs, far):
        for kw in ({}, dict(inv_key=key, n_global=n_glob)):
            want = _assert_gather_equal(
                (pool_M, pool_L, seg, gid, row, slot, q, qg), start=start,
                **kw)
            if q is qs:
                assert (want[1] > 0).sum() >= min(P, 200)
