"""The port's segment-sharding pieces against the reference's, on the CPU:
``ShardPlan`` (bounds, ``shard_of``, clamping, ``multi_device`` over torch
devices, ``rehomed``), the scheduler's shard-affine half (``partition``
with ``shard_of``, ``segment_batches`` with a plan), the per-shard pools
of ``BlockStore``, ``all_sum_shards`` (int32 in, int32 out; distinct cards
raise) and the plain arm of ``gather_candidates`` (exact zeros for the
pairs a shard does not own), each on the same inputs as the reference."""

import numpy as np
import pytest
import torch

from repro.core import scheduler as ref_scheduler
from repro.distributed import sharding as ref_sharding
from repro.kernels import completion_gather as ref_cg
from repro_torch.core.blockstore import BlockStore, DevBlockPool
from repro_torch.core.scheduler import partition, segment_batches
from repro_torch.distributed.sharding import ShardPlan, all_sum_shards
from repro_torch.kernels import completion_gather as cg


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _cpu_plan(ns, shards):
    """``ShardPlan.make`` with its shards on the CPU, spelled out: without
    ``devices`` more than one shard takes the visible cards."""
    return ShardPlan.make(ns, shards, devices=None if shards <= 1 else
                          ("cpu",) * max(1, min(shards, ns)))


# -- ShardPlan ---------------------------------------------------------------

@pytest.mark.parametrize("ns,shards", [(10, 4), (10, 3), (3, 8), (5, 1),
                                       (12, 4), (13824, 4), (1, 2)])
def test_plan_equals_the_reference(ns, shards):
    ref = ref_sharding.ShardPlan.make(ns, shards)
    got = _cpu_plan(ns, shards)
    assert got.bounds == ref.bounds and got.n_shards == ref.n_shards
    segs = np.arange(ns)
    np.testing.assert_array_equal(got.shard_of_array(segs),
                                  ref.shard_of_array(segs))
    assert [got.shard_of(s) for s in segs] == [ref.shard_of(s) for s in segs]
    for k in range(got.n_shards):
        assert got.shard_bounds(k) == ref.shard_bounds(k)
        assert got.segments(k) == ref.segments(k)
        lo, hi = got.shard_bounds(k)
        assert list(got.shard_of_array(np.arange(lo, hi))) == [k] * (hi - lo)


def test_plan_bounds_and_clamping():
    p = _cpu_plan(10, shards=4)
    assert p.bounds == (0, 3, 6, 8, 10)
    assert [p.shard_bounds(k) for k in range(4)] == [
        (0, 3), (3, 6), (6, 8), (8, 10)]
    assert list(p.segments(1)) == [3, 4, 5]
    p = _cpu_plan(3, shards=8)                   # clamped to the segments
    assert p.n_shards == 3 and p.bounds == (0, 1, 2, 3)


def test_unsharded_plan_stays_off_the_device_api(monkeypatch):
    def boom():
        raise AssertionError("shards=1 touched the device API")
    monkeypatch.setattr(torch.cuda, "is_available", boom)
    monkeypatch.setattr(torch.cuda, "device_count", boom)
    p = ShardPlan.make(5, shards=1)
    assert p.devices == (None,) and not p.multi_device


def test_multi_device_compares_normalised_cards(monkeypatch):
    # round-robin over the visible cards; without one that raises, and the
    # CPU is asked for by name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ShardPlan.make(8, shards=4)
    p = ShardPlan.make(8, shards=4, devices=("cpu",) * 4)
    assert p.devices == (torch.device("cpu"),) * 4 and not p.multi_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    p = ShardPlan.make(8, shards=4)
    assert p.devices == tuple(torch.device("cuda", k) for k in (0, 1, 0, 1))
    assert not p.multi_device                     # shards repeat a card
    assert ShardPlan.make(8, 2).multi_device      # one card each
    cases = {("cuda:0", "cuda:1", "cuda:2", "cuda:3"): True,
             ("cuda", "cuda:0"): False,           # the same card
             ("cuda:0", "cuda:0"): False,
             ("cpu", "cpu"): False,
             ("cpu", "cuda:0"): False,            # the CPU is no card
             (None, "cuda:1"): False}
    for devs, want in cases.items():
        assert ShardPlan.make(8, len(devs), devices=devs).multi_device \
            == want, devs


def test_rehomed_repeats_the_target_device():
    p = ShardPlan.make(8, 4, devices=("cuda:0", "cuda:1", "cuda:2",
                                      "cuda:3"))
    q = p.rehomed(2, 0)
    assert q.bounds == p.bounds and not q.multi_device
    assert q.devices[2] == q.devices[0] == torch.device("cuda", 0)
    assert q.devices[1] == p.devices[1]


# -- the scheduler's shard-affine half ----------------------------------------

@pytest.mark.parametrize("n,shards", [(16, 4), (12, 2), (10, 3), (7, 1),
                                      (5, 8)])
@pytest.mark.parametrize("workers", [1, 2, 3, 4, 5, 9])
def test_partition_equals_the_reference(n, shards, workers):
    plan = _cpu_plan(n, shards)
    shard_of = plan.shard_of
    want = ref_scheduler.partition(n, workers, shard_of)
    got = partition(n, workers, shard_of)
    assert got == want
    assert sorted(i for sh in got for i in sh) == list(range(n))
    for sh in got:
        assert sh == sorted(sh)
    assert partition(n, workers) == ref_scheduler.partition(n, workers)


def test_partition_is_shard_affine():
    plan = _cpu_plan(16, shards=4)
    shares = partition(16, 2, plan.shard_of)     # fewer workers than shards
    assert {plan.shard_of(i) for i in shares[0]} == {0, 2}
    assert {plan.shard_of(i) for i in shares[1]} == {1, 3}
    plan = _cpu_plan(12, shards=2)
    for sh in partition(12, 5, plan.shard_of):   # more workers than shards
        assert len({plan.shard_of(i) for i in sh}) == 1
    assert partition(7, 3) == [[0, 3, 6], [1, 4], [2, 5]]


@pytest.mark.parametrize("ns,shards,batch", [(10, 3, 3), (12, 4, 4),
                                             (13, 2, 16), (9, 1, 4)])
def test_segment_batches_restart_at_shard_boundaries(ns, shards, batch):
    plan = _cpu_plan(ns, shards)
    ref = ref_sharding.ShardPlan.make(ns, shards)
    got = segment_batches(ns, batch, plan)
    assert got == ref_scheduler.segment_batches(ns, batch, ref)
    for b in got:
        assert len({plan.shard_of(s) for s in b}) == 1
    assert segment_batches(ns, batch) == \
        ref_scheduler.segment_batches(ns, batch, None)
    if (ns, shards, batch) == (10, 3, 3):
        assert got == [[0, 1, 2], [3], [4, 5, 6], [7, 8, 9]]


# -- per-shard pools ------------------------------------------------------------

def _blk(fill=0):
    return torch.full((4, 2), fill, dtype=torch.int32)


def test_single_shard_store_is_one_pool():
    st = BlockStore(cache_segments=4, pool_arrays=2)
    A = _blk()
    st.put(("VV", 5), A, A, 0)
    assert ("VV", 5) in st and len(st.pools) == 1
    assert st.pool(0) is st.pools[0] and st.shard_of(5) == 0
    assert st.get(("VV", 5))[0] is A


def test_shard_routing_and_occupancy():
    st = BlockStore(cache_segments=4, pool_arrays=2, n_shards=2,
                    shard_of=lambda s: 0 if s < 8 else 1)
    A, B = _blk(1), _blk(2)
    st.put(("VV", 3), A, A, 0)       # shard 0
    st.put(("VV", 9), B, B, 0)       # shard 1
    assert len(st.pool(0)) == 1 and len(st.pool(1)) == 1
    assert st.get(("VV", 9))[0] is B and len(st) == 2
    assert ("VV", 3) in st.pool(0) and ("VV", 3) not in st.pool(1)
    occ = st.shard_occupancy()
    assert [o["entries"] for o in occ] == [1, 1]
    assert [o["arrays"] for o in occ] == [1, 1]
    assert [o["bytes"] for o in occ] == [64, 64]     # M + L, int32
    assert st.cache_nbytes() == 128
    assert st.clear_shard(0) == 1
    assert ("VV", 3) not in st and ("VV", 9) in st
    assert st.clear_cache() == 1 and len(st) == 0


def test_per_shard_eviction_bounds():
    """The pool bound holds per shard: filling shard 0 never evicts
    shard 1's blocks."""
    st = BlockStore(cache_segments=4, pool_arrays=1, n_shards=2,
                    shard_of=lambda s: 0 if s < 8 else 1)
    keep = _blk(7)
    st.put(("VV", 9), keep, keep, 0)
    for seg in range(4):
        A = _blk(seg)
        st.put(("VV", seg), A, A, 0)
    assert ("VV", 9) in st
    assert st.pool(0).evictions == 3 and st.pool(1).evictions == 0
    assert st.evictions == 3


def test_occupancy_conserves_across_eviction():
    st = BlockStore(cache_segments=8, pool_arrays=2, n_shards=2,
                    shard_of=lambda s: s % 2)
    for seg in range(12):                    # 6 launches per shard
        st.put(("VV", seg), _blk(seg), _blk(-seg), 0)
        for k, o in enumerate(st.shard_occupancy()):
            p = st.pool(k)
            assert o["arrays"] <= p.max_arrays and o["entries"] == len(p)
            assert o["bytes"] == o["arrays"] * 64
    assert [st.pool(k).evictions for k in (0, 1)] == [4, 4]
    assert sum(o["entries"] for o in st.shard_occupancy()) == len(st)
    assert isinstance(st.pool(1), DevBlockPool)


# -- all_sum_shards -------------------------------------------------------------

def test_all_sum_shards_keeps_int32_and_equals_the_reference():
    rng = np.random.default_rng(3)
    parts = [(rng.integers(-5, 10 ** 6, (33, 8)).astype(np.int32),
              rng.integers(0, 9, 33).astype(np.int32)) for _ in range(4)]
    want = ref_sharding.all_sum_shards(parts)
    got = all_sum_shards([(_t(c), _t(cl)) for c, cl in parts],
                         [torch.device("cpu")] * 4)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    one = (_t(parts[0][0]), _t(parts[0][1]))
    assert all_sum_shards([one]) is one
    cards = [torch.device("cuda", k) for k in range(4)]
    with pytest.raises(NotImplementedError, match="second card"):
        all_sum_shards([(_t(c), _t(cl)) for c, cl in parts], cards)


# -- gather_candidates: one shard's half of the exchange ----------------------

def _pairs(rng):
    """Inverse maps, a 4-slot pool and 96 pairs (a quarter unresolved,
    some padding), as the completion exchange builds them."""
    ns, n_global, S, R, degp = 11, 400, 4, 50, 6
    key = np.unique(rng.integers(0, ns * n_global, 900))
    seg, gid = key // n_global, key % n_global
    row = rng.integers(0, R, len(key))
    pick = rng.integers(0, len(key), 96)
    qs, qg = seg[pick].copy(), gid[pick].copy()
    qg[::4] = rng.integers(0, n_global, len(qg[::4]))   # mostly absent
    slot = rng.integers(0, S, 96)
    slot[-6:], qs[-6:], qg[-6:] = -1, 0, -1               # padding pairs
    pool_M = rng.integers(-1, 10 ** 5, (S, R, degp))
    pool_L = rng.integers(0, degp + 1, (S, R))
    i32 = (lambda a: np.asarray(a, dtype=np.int32))
    return dict(pool_M=i32(pool_M), pool_L=i32(pool_L), inv_seg=i32(seg),
                inv_gid=i32(gid), inv_row=i32(row), pair_slot=i32(slot),
                pair_seg=i32(qs), pair_gid=i32(qg)), i32(key), n_global


@pytest.mark.parametrize("use_key", [False, True])
def test_gather_candidates_equals_the_reference(use_key):
    rng = np.random.default_rng(11 + use_key)
    args, key, n_global = _pairs(rng)
    kw = dict(inv_key=key, n_global=n_global) if use_key else {}
    slot = args["pair_slot"]
    # this shard owns the even slots, no pair, every pair
    for owned in (slot % 2 == 0, np.zeros_like(slot, bool),
                  np.ones_like(slot, bool)):
        a = dict(args, pair_slot=np.where(owned, slot, -1).astype(np.int32))
        want = ref_cg.gather_candidates(**a, **kw)
        got = cg.gather_candidates(**{k: _t(v) for k, v in a.items()},
                                   **{k: _t(v) if k == "inv_key" else v
                                      for k, v in kw.items()})
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        # exact zeros wherever the pair is not this shard's or not resolved
        plain = cg.resolve_gather_torch(**{k: _t(v) for k, v in a.items()},
                                        **{k: _t(v) if k == "inv_key" else v
                                           for k, v in kw.items()})
        ok = cg.resolve_rows(*(_t(a[k]) for k in ("inv_seg", "inv_gid",
                                                  "inv_row", "pair_seg",
                                                  "pair_gid")),
                             **{k: _t(v) if k == "inv_key" else v
                                for k, v in kw.items()}) >= 0
        ok &= _t(a["pair_slot"]) >= 0
        assert (got[0][~ok] == 0).all() and (got[1][~ok] == 0).all()
        assert torch.equal(got[0][ok], plain[0][ok])
        if not owned.any():
            assert not got[0].any() and not got[1].any()
    assert int(ok.sum()) > 30


def test_shard_halves_sum_to_the_single_pool_union():
    """Two shards' halves, summed and unioned, equal the single-pool
    gather + union of the reference."""
    rng = np.random.default_rng(21)
    args, _, _ = _pairs(rng)
    P = len(args["pair_slot"])
    pair_at = np.full((64, 3), -1, np.int32)
    q = rng.integers(0, 64, P)
    for p in range(P):
        free = np.nonzero(pair_at[q[p]] < 0)[0]
        if len(free):
            pair_at[q[p], free[0]] = p
    want = ref_cg.gather_union(**args, pair_at=pair_at, deg_out=8,
                               backend="xla")
    slot = args["pair_slot"]
    parts = []
    for k in range(2):          # shard k owns the slots of parity k
        own = np.where((slot >= 0) & (slot % 2 == k), slot, -1)
        a = dict(args, pair_slot=own.astype(np.int32))
        parts.append(cg.gather_candidates(**{n: _t(v)
                                             for n, v in a.items()}))
    cand, clen = all_sum_shards(parts, [torch.device("cpu")] * 2)
    got = cg.union_pairs(cand, clen, _t(args["pair_gid"]), _t(pair_at), 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_make_mesh_needs_a_card_or_the_cpu_spelled_out(monkeypatch):
    """``make_mesh`` and the two named meshes default to ``cuda`` and raise
    without a card (the port's ``ops.resolve_device`` rule); with
    ``device_type="cpu"`` they build the mesh as before, here on the dry
    run's fake group of four ranks."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as meshes

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: meshes.make_mesh((2, 2), ("data", "model")),
                  lambda: meshes.make_test_mesh(),
                  lambda: meshes.make_production_mesh(multi_pod=True)):
        with pytest.raises(RuntimeError, match="is_available"):
            build()
    meshes.init_group("fake", 0, 4)
    try:
        mesh = meshes.make_mesh((2, 2), ("data", "model"), "cpu")
        assert mesh.device_type == "cpu"
        assert mesh.mesh_dim_names == ("data", "model")
        assert meshes.batch_axes(mesh) == ("data",)
        test_mesh = meshes.make_test_mesh(device_type="cpu")
        assert tuple(test_mesh.shape) == (2, 2)
    finally:
        dist.destroy_process_group()
