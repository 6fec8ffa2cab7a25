"""Scheduling fuzz for the port's async engine contract (docs/DESIGN.md
§3/§8/§12), against the reference, on the CPU: every case of
``tests/test_scheduling_fuzz.py`` on the port's engine and drivers, with
the same meshes, seeds and schedules. Randomized prefetch / get /
get_batch / request / get_full_dev_many interleavings — single-threaded
and from 2–8 consumer threads — over random lookahead / batch_max / cache
capacities must return blocks equal to the reference's fault-free blocks,
never produce a block twice while it is cached or in flight, never lose a
stat update and never deadlock; the persistence driver under fuzzed
policies, and all four drivers under fuzzed survivable fault schedules
(the chaos arm), must give the reference's fault-free digests."""

import hashlib
import threading
import time

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
from repro.core.engine import RelationEngine as RefEngine
from repro.core.faults import FaultPolicy as RefFaultPolicy
from repro.core.mesh import segment_mesh as ref_segment_mesh
from repro.core.segtables import precondition as ref_precondition
from repro.data.meshgen import structured_grid as ref_structured_grid
from repro_torch.algorithms import fields
from repro_torch.algorithms.critical_points import critical_points, \
    total_order
from repro_torch.algorithms.discrete_gradient import discrete_gradient
from repro_torch.algorithms.morse_smale import morse_smale
from repro_torch.algorithms.persistence import persistence_pairs
from repro_torch.core.engine import RelationEngine
from repro_torch.core.faults import FaultInjector, FaultPolicy, FaultSpec
from repro_torch.core.mesh import segment_mesh
from repro_torch.core.segtables import precondition
from repro_torch.data.meshgen import structured_grid

RELS = ["VV", "VT"]
REF_DRIVERS = (ref_critical_points, ref_discrete_gradient, ref_morse_smale,
               ref_persistence_pairs)
DRIVERS = (critical_points, discrete_gradient, morse_smale,
           persistence_pairs)


def _ref_engine(pre, rels):
    """The reference's blocking engine with no faults: the yardstick."""
    return RefEngine(pre, rels, lookahead=0, batch_max=1,
                     cache_segments=4096, async_dispatch=False, tune="off",
                     fault_policy=RefFaultPolicy())


@pytest.fixture(scope="module")
def setup():
    """(port segmented mesh, port pre, the reference's blocks)."""
    ref_sm = ref_segment_mesh(
        ref_structured_grid(6, 6, 5, jitter=0.2, seed=11), capacity=24)
    ref = _ref_engine(ref_precondition(ref_sm, relations=RELS), RELS)
    blocks = {(r, s): ref.get(r, s)
              for r in RELS for s in range(ref_sm.n_segments)}
    sm = segment_mesh(structured_grid(6, 6, 5, jitter=0.2, seed=11),
                      capacity=24)
    return sm, precondition(sm, relations=RELS), blocks


def _record_launches(eng):
    """Wrap _dispatch to record every launch's segment batch."""
    launches = []
    orig = eng._dispatch

    def wrapped(relation):
        launch = orig(relation)
        if launch is not None:
            launches.append((relation, list(launch.segments)))
        return launch

    eng._dispatch = wrapped
    return launches


def _check_launches(eng, launches):
    """Every produced segment came from a recorded launch, no launch holds
    a duplicate, and without evictions no block was produced twice."""
    total = sum(len(segs) for _, segs in launches)
    assert eng.stats.segments_produced == total
    for _, segs in launches:
        assert len(set(segs)) == len(segs)
    if eng.cache.evictions == 0:
        distinct = {(r, s) for r, segs in launches for s in segs}
        assert eng.stats.segments_produced == len(distinct)
    s = eng.stats
    assert s.cache_hits + s.cache_misses == s.requests


@pytest.mark.parametrize("seed", range(6))
def test_fuzzed_interleavings_bit_identical(setup, seed):
    sm, pre, blocks = setup
    ns = sm.n_segments
    rng = np.random.default_rng(seed)
    cap = int(rng.choice([1, 2, 3, 8, 4096]))     # incl. capacity < batch
    batch_max = int(rng.choice([1, 4, 16]))
    lookahead = int(rng.choice([0, 3, 8]))
    eng = RelationEngine(pre, RELS, cache_segments=cap, device="cpu",
                         batch_max=batch_max, lookahead=lookahead)
    launches = _record_launches(eng)

    for _ in range(50):
        r = RELS[int(rng.integers(len(RELS)))]
        segs = rng.integers(0, ns, size=int(rng.integers(1, 5)))
        op = int(rng.integers(5))
        if op == 0:
            eng.request(r, segs)
        elif op == 1:
            eng.prefetch(r, segs)
        elif op == 2:
            eng.prefetch_many({R: segs for R in RELS})
        elif op == 3:
            M, L = eng.get(r, int(segs[0]))
            Mr, Lr = blocks[(r, int(segs[0]))]
            np.testing.assert_array_equal(M, Mr)
            np.testing.assert_array_equal(L, Lr)
        else:
            for (M, L), s in zip(eng.get_batch(r, segs), segs):
                Mr, Lr = blocks[(r, int(s))]
                np.testing.assert_array_equal(M, Mr)
                np.testing.assert_array_equal(L, Lr)
    _check_launches(eng, launches)


def _check_block(blocks, r, s, M, L):
    Mr, Lr = blocks[(r, int(s))]
    np.testing.assert_array_equal(np.asarray(M), Mr)
    np.testing.assert_array_equal(np.asarray(L), Lr)


def _fuzz_ops(eng, blocks, ns, rng, iters):
    """One consumer's randomized op stream (shared by every fuzz worker)."""
    for _ in range(iters):
        r = RELS[int(rng.integers(len(RELS)))]
        segs = rng.integers(0, ns, size=int(rng.integers(1, 5)))
        op = int(rng.integers(7))
        if op == 0:
            eng.request(r, segs)
        elif op == 1:
            eng.prefetch(r, segs)
        elif op == 2:
            eng.prefetch_many({R: segs for R in RELS})
        elif op == 3:
            M, L = eng.get(r, int(segs[0]))
            _check_block(blocks, r, segs[0], M, L)
        elif op == 4:
            for (M, L), s in zip(eng.get_batch(r, segs), segs):
                _check_block(blocks, r, s, M, L)
        elif op == 5:
            Mf, Lf = eng.get_full(r, int(segs[0]))
            n = blocks[(r, int(segs[0]))][0].shape[0]
            _check_block(blocks, r, segs[0], Mf[:n], Lf[:n])
        else:
            # multi-relation device-batch read: internal rows of the
            # (sorted, unique) segments across both relations
            uniq = sorted(set(int(s) for s in segs))
            cb = eng.get_full_dev_many(RELS, uniq)
            at = 0
            for s in uniq:
                n = blocks[(RELS[0], s)][0].shape[0]
                for R in RELS:
                    Mr, Lr = blocks[(R, s)]
                    M = cb.M[R].numpy()[at:at + n, :Mr.shape[1]]
                    L = cb.L[R].numpy()[at:at + n]
                    np.testing.assert_array_equal(M, Mr)
                    np.testing.assert_array_equal(L, Lr)
                at += n


def _run_threads(eng, blocks, ns, n_threads, seed_of, iters):
    errors = []

    def worker(widx):
        try:
            with eng.worker_scope(f"w{widx}"):
                wrng = np.random.default_rng(seed_of(widx))
                _fuzz_ops(eng, blocks, ns, wrng, iters=iters)
        except BaseException as e:   # pragma: no cover - failure path
            errors.append((widx, e))

    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive(), \
            f"deadlock: consumer thread {t.name} still running"
    assert not errors, errors[0]


@pytest.mark.parametrize("seed", range(6))
def test_concurrent_fuzzed_interleavings(setup, seed):
    """2–8 consumer threads fuzzing the full consumer surface
    concurrently: blocks stay equal to the reference's, production stays
    duplicate-free, stats stay conserved, and nothing deadlocks."""
    sm, pre, blocks = setup
    ns = sm.n_segments
    rng = np.random.default_rng(1000 + seed)
    n_threads = int(rng.choice([2, 3, 4, 8]))
    cap = int(rng.choice([2, 3, 8, 4096]))        # incl. capacity < batch
    batch_max = int(rng.choice([1, 4, 16]))
    lookahead = int(rng.choice([0, 3, 8]))
    eng = RelationEngine(pre, RELS, cache_segments=cap, device="cpu",
                         batch_max=batch_max, lookahead=lookahead)
    launches = _record_launches(eng)
    _run_threads(eng, blocks, ns, n_threads,
                 lambda widx: 7919 * seed + widx, iters=25)
    _check_launches(eng, launches)
    s = eng.stats
    merged = eng.merged_worker_stats()
    for f in ("requests", "cache_hits", "cache_misses", "inflight_hits",
              "kernel_launches", "segments_produced", "evictions",
              "devpool_hits", "devpool_uploads"):
        assert getattr(merged, f) == getattr(s, f), f


# ---- the persistence driver under fuzzed engine policies -------------------

PD_RELS = ["VE", "VF", "VT", "FT", "TT"]


def _pd_mesh(gen, fld, seg):
    return seg(gen(7, 7, 6, jitter=0.15, seed=11,
               scalar_fn=fld.gaussians(4, k=4, sigma=2.5,
                                       scale=7.0)),
               capacity=24)


@pytest.fixture(scope="module")
def pd_setup():
    ref_sm = _pd_mesh(ref_structured_grid, ref_fields, ref_segment_mesh)
    ref_pre = ref_precondition(ref_sm, relations=PD_RELS)
    ref_rank = ref_total_order(ref_sm.scalars)
    digest = ref_persistence_pairs(_ref_engine(ref_pre, PD_RELS), ref_pre,
                                   ref_rank).digest()
    sm = _pd_mesh(structured_grid, fields, segment_mesh)
    rank = total_order(sm.scalars)
    np.testing.assert_array_equal(rank, ref_rank)
    return precondition(sm, relations=PD_RELS), rank, digest


@pytest.mark.parametrize("seed", range(4))
def test_persistence_driver_fuzzed_policies(pd_setup, seed):
    """The persistence driver under random engine policies and worker
    counts: the diagram digest equals the reference's blocking-engine
    digest, production stays duplicate-free, and the per-worker stats
    round-trip."""
    pre, rank, ref_digest = pd_setup
    rng = np.random.default_rng(500 + seed)
    cap = int(rng.choice([2, 8, 4096]))           # incl. capacity < batch
    batch_max = int(rng.choice([1, 4, 16]))
    lookahead = int(rng.choice([0, 3, 8]))
    workers = int(rng.choice([1, 2, 4]))
    batch_segments = int(rng.choice([2, 5, 16]))
    method = ("pairing", "reduction")[seed % 2]
    eng = RelationEngine(pre, PD_RELS, cache_segments=cap, device="cpu",
                         batch_max=batch_max, lookahead=lookahead)
    launches = _record_launches(eng)
    d = persistence_pairs(eng, pre, rank, method=method,
                          batch_segments=batch_segments, workers=workers)
    assert d.digest() == ref_digest
    _check_launches(eng, launches)
    s = eng.stats
    merged = eng.merged_worker_stats()
    for f in ("requests", "cache_hits", "cache_misses", "inflight_hits",
              "kernel_launches", "segments_produced", "evictions"):
        assert getattr(merged, f) == getattr(s, f), f


# ---- chaos arm: fuzzed SURVIVABLE fault schedules (docs/DESIGN.md §12) -----
#
# For any eventually-survivable injected schedule (transient launch
# failures, permanent ones behind the breaker's host arm, hung syncs
# reclaimed by the watchdog, whole-shard device loss re-homed), every
# driver's output equals the reference's fault-free output, production
# stays duplicate-free (counted at INTEGRATION — failed launches
# re-dispatch by design), and every join is bounded.

CHAOS_RELS = ["VV", "VE", "VF", "VT", "FT", "TT"]
ALGOS = ("critical_points", "discrete_gradient", "morse_smale",
         "persistence")


def _sha(*arrays) -> str:
    """Digest of the values: the packages' integer dtypes differ (jnp
    int32, numpy int64), so every array is hashed as int64."""
    h = hashlib.sha1()
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a).astype(np.int64))
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def _driver_digest(drivers, algo, eng, pre, rank, workers=1):
    """One full driver run -> signature over the COMPLETE output arrays."""
    cp, dg, ms_fn, pp = drivers
    if algo == "critical_points":
        t, _ = cp(eng, pre, rank, batch_segments=8, workers=workers)
        return _sha(t)
    if algo == "discrete_gradient":
        g = dg(eng, pre, rank, batch_segments=8, workers=workers)
        return _sha(g.pair_v2e, g.pair_e2f, g.pair_f2t, g.crit_v,
                    g.crit_e, g.crit_f, g.crit_t)
    if algo == "morse_smale":
        g = dg(eng, pre, rank, batch_segments=8, workers=workers,
               co_prefetch=("TT",))
        ms = ms_fn(eng, pre, g, batch_segments=8, workers=workers)
        return _sha(ms.dest_min, ms.dest_max, ms.saddle1_ends,
                    ms.saddle2_ends)
    return pp(eng, pre, rank, batch_segments=8, workers=workers).digest()


def _record_integrations(eng):
    """Wrap _integrate to record every block the moment it LANDS (done
    turns False -> True). Unlike the _dispatch wrapper above this
    excludes failed launches, which re-dispatch by design."""
    integrated = []
    orig = eng._integrate

    def wrapped(launch):
        fresh = not (launch.done or launch.error is not None)
        out = orig(launch)
        if fresh and launch.done:
            integrated.extend((launch.relation, int(s))
                              for s in launch.segments)
        return out

    eng._integrate = wrapped
    return integrated


def _chaos_policy(rng, rels, shards):
    """A random eventually-survivable fault schedule: bounded fault counts,
    degrade=True (host arm behind the breaker), watchdog armed against the
    injected hangs, device loss only where a survivor exists to re-home
    onto (or the host arm absorbs it)."""
    specs = []
    for _ in range(int(rng.integers(1, 4))):
        kind = ("launch", "launch", "sync",
                "device-lost")[int(rng.integers(4))]
        if kind == "launch":
            specs.append(FaultSpec(
                kind="launch", relation=str(rng.choice(rels)),
                transient=bool(rng.integers(2)),
                count=int(rng.integers(1, 4))))
        elif kind == "sync":
            specs.append(FaultSpec(kind="sync", hang_s=0.3, count=1))
        else:
            specs.append(FaultSpec(kind="device-lost",
                                   shard=int(rng.integers(shards)),
                                   count=1))
    injector = FaultInjector(specs, seed=int(rng.integers(1 << 30)))
    return FaultPolicy(injector=injector, backoff_s=0.001,
                       breaker_threshold=2, breaker_cooldown_s=0.01,
                       sync_timeout_s=0.05, sync_poll_s=0.005)


@pytest.fixture(scope="module")
def chaos_setup():
    ref_sm = _pd_mesh(ref_structured_grid, ref_fields, ref_segment_mesh)
    ref_pre = ref_precondition(ref_sm, relations=CHAOS_RELS)
    ref_rank = ref_total_order(ref_sm.scalars)
    ref = _ref_engine(ref_pre, CHAOS_RELS)
    digests = {a: _driver_digest(REF_DRIVERS, a, ref, ref_pre, ref_rank)
               for a in ALGOS}
    sm = _pd_mesh(structured_grid, fields, segment_mesh)
    pre = precondition(sm, relations=CHAOS_RELS)
    return sm, pre, total_order(sm.scalars), digests


def _check_integrations(eng, integrated):
    # no block integrated twice while cached (the cache never evicts here)
    assert eng.cache.evictions == 0
    assert len(set(integrated)) == len(integrated), \
        "duplicate production under faults"
    # failed launches reversed their dispatch-time counters, so the
    # produced count still equals the distinct-block count
    assert eng.stats.segments_produced == len(set(integrated))
    s = eng.stats
    assert s.cache_hits + s.cache_misses == s.requests


@pytest.mark.parametrize("seed", range(4))
def test_chaos_schedules_four_drivers_bit_identical(chaos_setup, seed):
    """All four drivers under random survivable fault schedules crossed
    with worker counts {1,2,4} and shard counts {1,2}: every digest equals
    the reference's fault-free digest, integration stays duplicate-free,
    and the stats stay conserved."""
    sm, pre, rank, digests = chaos_setup
    rng = np.random.default_rng(9000 + seed)
    injected_total = 0
    for algo in ALGOS:
        shards = int(rng.choice([1, 2]))
        workers = int(rng.choice([1, 2, 4]))
        policy = _chaos_policy(rng, CHAOS_RELS, shards)
        eng = RelationEngine(pre, CHAOS_RELS, shards=shards, device="cpu",
                             cache_segments=4096,
                             batch_max=int(rng.choice([1, 4, 16])),
                             lookahead=int(rng.choice([0, 3, 8])),
                             fault_policy=policy)
        integrated = _record_integrations(eng)
        assert _driver_digest(DRIVERS, algo, eng, pre, rank,
                              workers=workers) == digests[algo], \
            f"identical=False algo={algo} seed={seed}"
        injected_total += len(policy.injector.injected)
        _check_integrations(eng, integrated)
    # the schedules actually fired (not vacuously survivable)
    assert injected_total > 0


@pytest.mark.parametrize("seed", range(4))
def test_chaos_concurrent_consumers_bounded_joins(setup, seed):
    """2–8 consumer threads fuzzing the full surface while faults fire:
    blocks stay equal to the reference's, every thread joins within the
    bound (no waiter is left behind on a failed or hung launch), and
    integration stays duplicate-free."""
    sm, pre, blocks = setup
    ns = sm.n_segments
    rng = np.random.default_rng(4242 + seed)
    shards = int(rng.choice([1, 2]))
    policy = _chaos_policy(rng, RELS, shards)
    eng = RelationEngine(pre, RELS, shards=shards, cache_segments=4096,
                         batch_max=int(rng.choice([1, 4, 16])),
                         lookahead=int(rng.choice([0, 3, 8])),
                         device="cpu", fault_policy=policy)
    integrated = _record_integrations(eng)
    n_threads = int(rng.choice([2, 3, 4, 8]))
    _run_threads(eng, blocks, ns, n_threads,
                 lambda widx: 104729 * seed + widx, iters=20)
    _check_integrations(eng, integrated)


def test_chaos_hung_sync_terminates_via_watchdog(chaos_setup):
    """A launch hung far past the test budget must terminate through the
    watchdog's SyncTimeoutError -> syncer takeover -> re-dispatch path,
    with the driver output still equal to the reference's."""
    sm, pre, rank, digests = chaos_setup
    inj = FaultInjector([FaultSpec(kind="sync", hang_s=120.0, count=1)])
    eng = RelationEngine(pre, CHAOS_RELS, device="cpu",
                         fault_policy=FaultPolicy(injector=inj,
                                                  sync_timeout_s=0.05,
                                                  sync_poll_s=0.005))
    t0 = time.perf_counter()
    d = _driver_digest(DRIVERS, "critical_points", eng, pre, rank,
                       workers=2)
    dt = time.perf_counter() - t0
    assert d == digests["critical_points"]
    assert dt < 60.0, f"hung sync not reclaimed ({dt:.1f}s)"
    assert eng.stats.sync_timeouts >= 1
    assert eng.stats.failed_launches >= 1
