"""The port's sharded engine against the reference, on the CPU, on the
``bar`` dataset (``structured_grid(48, 4, 4)``, 12 segments): the three
drivers at ``(shards, workers)`` in {(4, 1), (4, 4), (2, 1)} bit-identical
to the reference's unsharded run, with the per-shard producer counters
equal to the reference's sharded engine's at one worker; blocks at
shard-local indices (the last segment of every shard); one full sweep
producing each shard's own segments once; the completion exchange (TT and
FF, shards 2 and 4, device and host arms) against the reference's rows;
cross-shard pairs on neighbouring shards; persistence across workers and
shards; and the validation errors. Each reference result is computed once
per module."""

import dataclasses

import numpy as np
import pytest

from repro.algorithms import fields as ref_fields
from repro.algorithms.critical_points import \
    critical_points as ref_critical_points
from repro.algorithms.critical_points import total_order as ref_total_order
from repro.algorithms.discrete_gradient import \
    discrete_gradient as ref_discrete_gradient
from repro.algorithms.morse_smale import morse_smale as ref_morse_smale
from repro.algorithms.persistence import \
    persistence_pairs as ref_persistence_pairs
from repro.core.adjacency import complete_adjacency as ref_complete_adjacency
from repro.core.engine import RelationEngine as RefEngine
from repro.core.mesh import segment_mesh as ref_segment_mesh
from repro.core.segtables import precondition as ref_precondition
from repro.data.meshgen import load_dataset as ref_load_dataset
from repro_torch.algorithms import fields
from repro_torch.algorithms.critical_points import critical_points, \
    total_order
from repro_torch.algorithms.discrete_gradient import audit_gradient, \
    discrete_gradient
from repro_torch.algorithms.morse_smale import morse_smale
from repro_torch.algorithms.persistence import persistence_pairs
from repro_torch.core.adjacency import complete_adjacency, plan_completion
from repro_torch.core.engine import RelationEngine
from repro_torch.core.mesh import segment_mesh
from repro_torch.core.segtables import precondition
from repro_torch.data.meshgen import load_dataset
from repro_torch.distributed.sharding import ShardPlan

RELS = ["VV", "VE", "VF", "VT", "FT", "TT"]
PRODUCER = ("kernel_launches", "segments_produced", "devpool_hits",
            "devpool_uploads")


def _ints(st):
    """The integer counters (the float ``t_*`` phases sum in another order
    per worker)."""
    return {k: v for k, v in dataclasses.asdict(st).items()
            if isinstance(v, int)}


def _bar(gen, fld, seg, prec):
    mesh = gen("bar", scalar_fn=fld.gaussians(2, k=5, sigma=5.0))
    return prec(seg(mesh, capacity=64), relations=RELS + ["FF"])


@pytest.fixture(scope="module")
def bar():
    """(reference pre, port pre, rank), built once."""
    ref = _bar(ref_load_dataset, ref_fields, ref_segment_mesh,
               ref_precondition)
    port = _bar(load_dataset, fields, segment_mesh, precondition)
    rank = total_order(port.smesh.scalars)
    np.testing.assert_array_equal(rank, ref_total_order(ref.smesh.scalars))
    assert port.smesh.n_segments == 12
    return ref, port, rank


def _ref_engine(pre, rels=RELS, **kw):
    return RefEngine(pre, rels, lookahead=8, dev_pool_segments=4096,
                     tune="off", **kw)


def _engine(pre, rels=RELS, **kw):
    return RelationEngine(pre, rels, lookahead=8, dev_pool_segments=4096,
                          device="cpu", **kw)


def _run_drivers(cp, dg, ms_fn, eng, pre, rank, workers):
    _, counts = cp(eng, pre, rank, batch_segments=4, workers=workers)
    g = dg(eng, pre, rank, batch_segments=4, co_prefetch=("TT",),
           workers=workers)
    ms = ms_fn(eng, pre, g, batch_segments=4, workers=workers)
    # the packages' dtypes differ (jnp int32, numpy int64): compare values
    return (counts, g.counts(), ms.counts(),
            *(np.asarray(getattr(o, f.name)).astype(np.int64).tobytes()
              for o in (g, ms) for f in dataclasses.fields(o)))


@pytest.fixture(scope="module")
def ref_runs(bar):
    """The reference's drivers, unsharded, and its sharded engines'
    per-shard producer counters at one worker."""
    ref, _, rank = bar
    drv = (ref_critical_points, ref_discrete_gradient, ref_morse_smale)
    base = _run_drivers(*drv, _ref_engine(ref), ref, rank, workers=1)
    shard_counts = {}
    for shards in (2, 4):
        eng = _ref_engine(ref, shards=shards)
        _run_drivers(*drv, eng, ref, rank, workers=1)
        shard_counts[shards] = {
            k: (st.segments_produced, st.kernel_launches)
            for k, st in eng.shard_stats.items()}
    return base, shard_counts


@pytest.mark.parametrize("shards,workers", [(4, 1), (4, 4), (2, 1)])
def test_drivers_equal_the_unsharded_reference(bar, ref_runs, shards,
                                               workers):
    _, port, rank = bar
    base, shard_counts = ref_runs
    eng = _engine(port, shards=shards)
    assert eng.shard_plan.n_shards == eng.n_shards == shards
    got = _run_drivers(critical_points, discrete_gradient, morse_smale,
                       eng, port, rank, workers)
    assert got == base
    # the per-shard counters partition the global ones exactly
    st, m = eng.stats, eng.merged_shard_stats()
    for f in PRODUCER:
        assert getattr(m, f) == getattr(st, f), f
    assert set(eng.shard_stats) <= set(range(shards))
    assert _ints(eng.merged_worker_stats()) == _ints(st)
    if workers == 1:
        assert {k: (s.segments_produced, s.kernel_launches)
                for k, s in eng.shard_stats.items()} == shard_counts[shards]


def test_blocks_at_shard_local_indices_equal_the_reference(bar):
    """Every segment's block, the last of each shard included (an
    off-by-``lo`` slip shows only past the first shard), read through a
    4-shard engine, equals the reference's unsharded block."""
    ref, port, _ = bar
    a = _ref_engine(ref)
    b = _engine(port, shards=4)
    plan = b.shard_plan
    lasts = [plan.bounds[k + 1] - 1 for k in range(plan.n_shards)]
    assert lasts == [2, 5, 8, 11]
    for r in RELS:
        for s in lasts + list(range(port.smesh.n_segments)):
            for x, y in zip(a.get_full(r, s), b.get_full(r, s)):
                np.testing.assert_array_equal(y, x, err_msg=f"{r} {s}")
    dev = b.get_full_dev_batch("VT", lasts)
    for i, s in enumerate(lasts):
        np.testing.assert_array_equal(dev[0][i].numpy(), a.get_full("VT",
                                                                    s)[0])


def test_full_sweep_produces_each_shard_once(bar):
    ref, port, _ = bar
    a = RefEngine(ref, ["VV"], lookahead=4, shards=4, tune="off")
    b = RelationEngine(port, ["VV"], lookahead=4, shards=4, device="cpu")
    for s in range(port.smesh.n_segments):
        a.get("VV", s)
        b.get("VV", s)
    plan = b.shard_plan
    sizes = {k: plan.bounds[k + 1] - plan.bounds[k]
             for k in range(plan.n_shards)}
    produced = {k: st.segments_produced for k, st in b.shard_stats.items()}
    assert produced == sizes
    assert b.stats.segments_produced == port.smesh.n_segments
    assert {k: (st.segments_produced, st.kernel_launches)
            for k, st in b.shard_stats.items()} == \
        {k: (st.segments_produced, st.kernel_launches)
         for k, st in a.shard_stats.items()}


def test_cross_shard_pairs_land_on_neighbouring_shards(bar):
    _, port, _ = bar
    eng = _engine(port, shards=4)
    splan = eng.shard_plan
    ids = np.arange(port.smesh.n_tets, dtype=np.int64)
    plan = plan_completion(eng, "TT", ids, prefetch=False)
    q_shard = splan.shard_of_array(
        port.owner_segment("T", plan.ids[plan.pair_query]))
    p_shard = splan.shard_of_array(plan.pair_seg)
    delta = p_shard - q_shard
    assert (delta != 0).any() and (delta == 1).any()
    cross = np.abs(delta[delta != 0])
    assert cross.max() <= 2 and (cross == 1).mean() >= 0.5
    assert any(((q_shard == k) & (p_shard == k + 1)).any()
               for k in range(splan.n_shards - 1))


@pytest.fixture(scope="module")
def ref_rows(bar):
    """The reference's completed TT and FF rows of every other simplex."""
    ref, port, _ = bar
    out = {}
    for relation in ("TT", "FF"):
        nq = port.smesh.n_tets if relation == "TT" else port.n_faces
        ids = np.arange(0, nq, 2, dtype=np.int64)
        rels = RELS + ([relation] if relation not in RELS else [])
        out[relation] = (ids, rels, ref_complete_adjacency(
            _ref_engine(ref, rels), relation, ids, path="host"))
    return out


@pytest.mark.parametrize("relation", ["TT", "FF"])
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_exchange_equals_the_reference(bar, ref_rows, relation,
                                               shards):
    _, port, _ = bar
    ids, rels, (M0, L0) = ref_rows[relation]
    eng = _engine(port, rels, shards=shards)
    for path in ("device", "host"):
        M, L = complete_adjacency(eng, relation, ids, path=path,
                                  shards=shards)
        np.testing.assert_array_equal(M, M0, err_msg=path)
        np.testing.assert_array_equal(L, L0, err_msg=path)
    # chunked, on two workers, and kept on the device
    M, L = complete_adjacency(eng, relation, ids, batch=97, workers=2,
                              path="device", out="dev")
    w = M0.shape[1]
    np.testing.assert_array_equal(M[:, :w].numpy(), M0)
    assert (M[:, w:] == -1).all()
    np.testing.assert_array_equal(L.numpy(), L0)
    assert eng.stats.completion_queries == 3 * len(ids)


def test_sharded_audit_and_persistence_equal_the_reference(bar):
    ref, port, rank = bar
    a = _ref_engine(ref, RELS + ["FF"])
    ga = ref_discrete_gradient(a, ref, rank, co_prefetch=("TT",))
    want_audit = {"tt_conflicts": 0, "ff_conflicts": 0,
                  "reverse_mismatch": 0}
    want = ref_persistence_pairs(a, ref, rank, grad=ga)
    digests = set()
    for shards in (1, 2, 4):
        eng = _engine(port, RELS + ["FF"], shards=shards)
        for workers in (1, 2, 4):
            g = discrete_gradient(eng, port, rank, co_prefetch=("TT",),
                                  workers=workers, shards=shards)
            assert audit_gradient(eng, port, g, workers=workers,
                                  shards=shards) == want_audit
            d = persistence_pairs(eng, port, rank, grad=g, workers=workers,
                                  shards=shards)
            digests.add(d.digest())
            assert d.counts() == want.counts()
    assert digests == {want.digest()}


def test_shards_arguments_validate(bar):
    ref, port, rank = bar
    eng = _engine(port, shards=2)
    ids = np.arange(8, dtype=np.int64)
    M, L = complete_adjacency(eng, "TT", ids, shards=2)
    assert M.shape[0] == 8
    with pytest.raises(ValueError, match="shards=4"):
        complete_adjacency(eng, "TT", ids, shards=4)
    with pytest.raises(ValueError, match="shards=4"):
        critical_points(eng, port, rank, shards=4)
    with pytest.raises(ValueError, match="shards=3"):
        discrete_gradient(eng, port, rank, shards=3)
    with pytest.raises(ValueError, match="shards=3"):
        persistence_pairs(eng, port, rank, shards=3)
    with pytest.raises(ValueError, match="segments"):
        RelationEngine(port, RELS, device="cpu",
                       shard_plan=ShardPlan.make(17, shards=2,
                                                 devices=("cpu",) * 2))
    with pytest.raises(ValueError, match="shard 2"):
        eng.dev_inverse("T", shard=2)
    # an explicit plan of the engine's size: the shards it names
    plan = ShardPlan.make(12, 3, devices=("cpu",) * 3)
    eng3 = RelationEngine(port, ["VV"], device="cpu", shard_plan=plan)
    assert eng3.shard_plan is plan and eng3.n_shards == 3
    assert eng3.dev_inverse("T", shard=2)[0] is eng3.dev_inverse("T")[0]


def test_concurrent_consumers_keep_the_shard_stats_exact(bar):
    """More consumer threads than cores, switching often, reading batches
    that cross shard boundaries: every block is produced once on its own
    shard, and the per-shard and per-worker stats merge to the global
    ones."""
    import sys
    import threading
    _, port, _ = bar
    eng = _engine(port, ["VV", "VT"], shards=4)
    ns = port.smesh.n_segments
    errors = []

    def consume(w):
        try:
            with eng.worker_scope(f"w{w}"):
                for i in range(ns):
                    segs = [(w + i) % ns, (w + i + 5) % ns]
                    eng.get_full_dev_many(("VV", "VT"), segs)
        except Exception as exc:  # pragma: no cover - failure path
            errors.append(exc)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=consume, args=(w,))
                   for w in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(prev)
    assert not errors and not any(t.is_alive() for t in threads)
    plan = eng.shard_plan
    assert {k: st.segments_produced for k, st in eng.shard_stats.items()} \
        == {k: 2 * (plan.bounds[k + 1] - plan.bounds[k])
            for k in range(plan.n_shards)}
    m = eng.merged_shard_stats()
    for f in PRODUCER:
        assert getattr(m, f) == getattr(eng.stats, f), f
    assert _ints(eng.merged_worker_stats()) == _ints(eng.stats)
