"""The port's fault injection and recovery ladder (docs/DESIGN.md §12) against
the reference, on the CPU: every case of ``tests/test_faults.py`` on the
port's engine with the same mesh and schedules — deterministic injector
schedules, bounded launch retries, the sync watchdog, the per-relation
circuit breaker with the numpy host arm, shard re-homing on device loss,
block-pool upload OOM, poisoning under ``degrade=False``, the error
taxonomy — with every block held to the reference's fault-free block; the
numpy host arm (``ops.relation_block_host``) for all ten relations against
the reference's host arm and the port's plain torch arm, rows past ``deg``
included; then the synced scenarios (``async_dispatch=False, batch_max=1,
lookahead=0``) run on both engines under the same schedule, where the
port's ``EngineStats.as_dict()`` equals the reference's key for key (the
timing counters ``t_*`` and ``sync_timeouts`` left out) and both injectors
log the same faults; and a ``RuntimeError`` of a kernel arm, which no
ladder may catch."""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import faults as ref_faults
from repro.core.engine import RelationEngine as RefEngine
from repro.core.mesh import segment_mesh as ref_segment_mesh
from repro.core.segtables import precondition as ref_precondition
from repro.data.meshgen import structured_grid as ref_structured_grid
from repro.kernels import ops as ref_ops
from repro_torch.core import engine as engine_mod
from repro_torch.core.engine import EngineStats, RelationEngine
from repro_torch.core.engine import RelationWidthError as ReexportedWidthError
from repro_torch.core.faults import (
    FaultInjector,
    FaultPolicy,
    FaultSpec,
    parse_fault_spec,
)
from repro_torch.core.mesh import segment_mesh
from repro_torch.core.scheduler import run_partitioned
from repro_torch.core.segtables import precondition
from repro_torch.data.meshgen import structured_grid
from repro_torch.kernels import ops
from repro_torch.errors import (
    LaunchError,
    PoolUploadError,
    RelationError,
    RelationPoisonedError,
    RelationWidthError,
    SyncTimeoutError,
)

RELS = ["VV", "VT"]


@pytest.fixture(scope="module")
def setup():
    """(port segmented mesh, port pre, reference pre, the reference's
    fault-free blocks)."""
    ref_sm = ref_segment_mesh(
        ref_structured_grid(6, 6, 5, jitter=0.2, seed=11), capacity=24)
    ref_pre = ref_precondition(ref_sm, relations=RELS)
    ref = RefEngine(ref_pre, RELS, lookahead=0, batch_max=1,
                    cache_segments=4096, async_dispatch=False, tune="off",
                    fault_policy=ref_faults.FaultPolicy())
    blocks = {(r, s): ref.get(r, s)
              for r in RELS for s in range(ref_sm.n_segments)}
    sm = segment_mesh(structured_grid(6, 6, 5, jitter=0.2, seed=11),
                      capacity=24)
    assert sm.n_segments == ref_sm.n_segments
    pre = precondition(sm, relations=RELS)
    return sm, pre, ref_pre, blocks


def _assert_identical(eng, blocks):
    for (r, s), (M0, L0) in blocks.items():
        M1, L1 = eng.get(r, s)
        assert np.array_equal(M0, M1) and np.array_equal(L0, L1), (r, s)


def _engine(pre, injector=None, **policy_kw):
    kw = dict(lookahead=0, batch_max=1, device="cpu")
    kw.update(policy_kw.pop("engine_kw", {}))
    return RelationEngine(
        pre, RELS,
        fault_policy=FaultPolicy(injector=injector, **policy_kw), **kw)


# -- injector / spec parsing -------------------------------------------------

def test_injector_is_deterministic_and_logged():
    specs = [FaultSpec(kind="launch", relation="VV", count=2, p=0.5)]
    logs = []
    for _ in range(2):
        inj = FaultInjector(specs, seed=7)
        for s in range(20):
            inj.launch_fault("VV", [s], 1, 0)
        logs.append(list(inj.injected))
    assert logs[0] == logs[1]          # seeded: replays bit-identically
    assert 0 < len(logs[0]) <= 2       # count bounds total fires
    # the same seeded p < 1 schedule fires at the reference's points
    ref = ref_faults.FaultInjector(
        [ref_faults.FaultSpec(kind="launch", relation="VV", count=2,
                              p=0.5)], seed=7)
    for s in range(20):
        ref.launch_fault("VV", [s], 1, 0)
    assert ref.injected == logs[0]


def test_spec_matchers_and_counts():
    inj = FaultInjector([FaultSpec(kind="launch", relation="VT",
                                   segment=3, attempt=1, count=1)])
    assert inj.launch_fault("VV", [3], 1, 0) is None      # wrong relation
    assert inj.launch_fault("VT", [0, 1], 1, 0) is None   # segment absent
    assert inj.launch_fault("VT", [2, 3], 2, 0) is None   # wrong attempt
    exc = inj.launch_fault("VT", [2, 3], 1, 0)
    assert isinstance(exc, LaunchError) and exc.transient
    assert exc.relation == "VT" and exc.attempt == 1
    assert inj.launch_fault("VT", [2, 3], 1, 0) is None   # count exhausted
    assert inj.injected == [("launch", "VT", (2, 3), 1, 0)]


def test_bad_fault_kind_rejected():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec(kind="meteor")


def test_parse_fault_spec_grammar():
    text = ("launch:relation=VV,count=2,transient=0;"
            "sync:hang_s=0.4,count=1;device-lost:shard=0;"
            "policy:max_attempts=4,breaker_threshold=2;seed=7")
    p = parse_fault_spec(text)
    assert p.max_attempts == 4 and p.breaker_threshold == 2
    kinds = [s.kind for s in p.injector.specs]
    assert kinds == ["launch", "sync", "device-lost"]
    assert p.injector.specs[0].transient is False
    # sync specs without an explicit timeout auto-arm the watchdog
    assert p.sync_timeout_s == 0.25
    # the reference parses the same text to the same policy and specs
    r = ref_faults.parse_fault_spec(text)
    assert ({k: v for k, v in dataclasses.asdict(p).items()
             if k != "injector"}
            == {k: v for k, v in dataclasses.asdict(r).items()
                if k != "injector"})
    assert ([dataclasses.asdict(s) for s in p.injector.specs]
            == [dataclasses.asdict(s) for s in r.injector.specs])


def test_parse_fault_spec_rejects_malformed():
    with pytest.raises(ValueError, match="malformed"):
        parse_fault_spec("launch-without-colon")
    with pytest.raises(ValueError, match="unknown policy field"):
        parse_fault_spec("policy:warp_speed=9")


def test_parse_empty_spec_is_default_policy():
    p = parse_fault_spec("")
    assert p == FaultPolicy()
    assert p.injector is None


# -- error taxonomy ----------------------------------------------------------

def test_relation_error_structured_fields():
    exc = LaunchError("kaput", transient=False, relation="VV", segment=4,
                      shard=1, attempt=2)
    assert isinstance(exc, RelationError)
    assert exc.fields == {"relation": "VV", "segment": 4, "shard": 1,
                          "attempt": 2}
    s = str(exc)
    assert "kaput" in s and "relation='VV'" in s and "attempt=2" in s
    assert RelationError("bare").fields == {}
    assert str(RelationError("bare")) == "bare"


def test_width_error_folded_into_taxonomy():
    # the one non-retryable case: still a ValueError, still importable
    # from core/engine.py
    assert ReexportedWidthError is RelationWidthError
    exc = RelationWidthError("too wide", relation="TT")
    assert isinstance(exc, ValueError) and isinstance(exc, RelationError)
    with pytest.raises(ValueError):
        raise RelationWidthError("x")


def test_sync_timeout_error_carries_timeout():
    exc = SyncTimeoutError("late", timeout_s=0.5, relation="VV")
    assert exc.timeout_s == 0.5 and exc.relation == "VV"


# -- transient launch retries ------------------------------------------------

def test_transient_launch_retries_bit_identical(setup):
    sm, pre, _, blocks = setup
    inj = FaultInjector([FaultSpec(kind="launch", relation="VV", count=2)])
    eng = _engine(pre, inj, backoff_s=0.001)
    _assert_identical(eng, blocks)
    assert eng.stats.retries >= 2
    assert eng.stats.failed_launches == 0      # retried, never abandoned
    assert len(inj.injected) == 2
    # produced == distinct blocks still holds after the retry churn
    assert eng.stats.segments_produced == len(blocks)


def test_retries_deduplicate_against_concurrent_production(setup):
    """While one thread sleeps in the retry backoff (lock released),
    another thread producing the same segment must win; the retry
    re-filters and never produces the segment twice."""
    sm, pre, _, blocks = setup
    inj = FaultInjector([FaultSpec(kind="launch", relation="VV",
                                   segment=0, attempt=1, count=1)])
    eng = _engine(pre, inj, backoff_s=0.2)
    produced = []
    orig = eng._integrate

    def counting_integrate(launch):
        produced.extend((launch.relation, s) for s in launch.segments)
        return orig(launch)

    eng._integrate = counting_integrate
    t = threading.Thread(target=lambda: eng.get("VV", 0))
    t.start()
    time.sleep(0.05)       # thread 1 is now inside the backoff sleep
    M1, L1 = eng.get("VV", 0)   # thread 2 produces segment 0 meanwhile
    t.join(timeout=10.0)
    assert not t.is_alive()
    M0, L0 = blocks[("VV", 0)]
    assert np.array_equal(M0, M1) and np.array_equal(L0, L1)
    assert produced.count(("VV", 0)) == 1      # never produced twice


# -- circuit breaker + host-arm degradation ----------------------------------

def _breaker_walk(eng, n_segments, blocks=None):
    """Read every VT block once, sleeping past the cooldown whenever the
    breaker is open and has not yet recovered (the next launch probes)."""
    for s in range(n_segments):
        M1, L1 = eng.get("VT", s)
        if blocks is not None:
            M0, L0 = blocks[("VT", s)]
            assert np.array_equal(M0, M1) and np.array_equal(L0, L1), s
        if eng.stats.breaker_trips and not eng.stats.breaker_recoveries:
            time.sleep(0.03)   # cooldown expires -> next launch probes


def test_breaker_opens_degrades_and_recovers(setup):
    sm, pre, _, blocks = setup
    inj = FaultInjector([FaultSpec(kind="launch", relation="VT",
                                   transient=False, count=3)])
    eng = _engine(pre, inj, breaker_threshold=2, breaker_cooldown_s=0.02)
    _breaker_walk(eng, sm.n_segments, blocks)
    assert eng.stats.breaker_trips >= 1
    assert eng.stats.breaker_recoveries >= 1   # probe closed the breaker
    assert eng.stats.degraded_launches >= 1
    assert eng.stats.degraded_segments >= 1
    # degraded production still lands in the per-shard partition
    merged = eng.merged_shard_stats()
    assert merged.segments_produced == eng.stats.segments_produced
    assert merged.degraded_launches == eng.stats.degraded_launches


def test_get_full_dev_many_degrades_to_host_arm(setup):
    """With a relation's breaker OPEN, the consumer batch read serves that
    relation from the host cache (degraded_reads) bit-identically to the
    reference's pooled device gather."""
    sm, pre, ref_pre, _ = setup
    segs = list(range(min(4, sm.n_segments)))
    base = RefEngine(ref_pre, RELS, tune="off",
                     fault_policy=ref_faults.FaultPolicy())
    want = base.get_full_dev_many(RELS, segs)
    # open VT's breaker via permanent failures with a LONG cooldown so the
    # read below stays degraded
    inj = FaultInjector([FaultSpec(kind="launch", relation="VT",
                                   transient=False, count=2)])
    eng = RelationEngine(pre, RELS, lookahead=0, batch_max=1, device="cpu",
                         fault_policy=FaultPolicy(
                             injector=inj, breaker_threshold=2,
                             breaker_cooldown_s=60.0))
    eng.get("VT", 0)
    eng.get("VT", 1)
    assert eng.stats.breaker_trips == 1
    got = eng.get_full_dev_many(RELS, segs)
    assert eng.stats.degraded_reads >= len(segs)
    for r in RELS:
        assert np.array_equal(np.asarray(want.M[r]), got.M[r].numpy())
        assert np.array_equal(np.asarray(want.L[r]), got.L[r].numpy())
    # and equal to the port's own fault-free pooled gather
    clean = RelationEngine(pre, RELS, device="cpu",
                           fault_policy=FaultPolicy()).get_full_dev_many(
                               RELS, segs)
    for r in RELS:
        assert got.M[r].dtype == clean.M[r].dtype
        assert np.array_equal(clean.M[r].numpy(), got.M[r].numpy())


# -- poisoning (degrade=False) -----------------------------------------------

def test_permanent_failure_without_degrade_poisons_relation(setup):
    sm, pre, _, blocks = setup
    inj = FaultInjector([FaultSpec(kind="launch", relation="VV",
                                   transient=False, count=99)])
    eng = _engine(pre, inj, degrade=False, breaker_threshold=1)
    with pytest.raises(LaunchError, match="permanent launch failure"):
        eng.get("VV", 0)
    # every later consumer call fails fast with the cause chained — no hang
    with pytest.raises(RelationPoisonedError,
                       match="permanently failed") as ei:
        eng.get("VV", 1)
    assert isinstance(ei.value.__cause__, LaunchError)
    with pytest.raises(RelationPoisonedError):
        eng.request("VV", [2])
    with pytest.raises(RelationPoisonedError):
        eng.get_full_dev("VV", 0)
    # other relations keep working
    M, L = eng.get("VT", 0)
    assert np.array_equal(M, blocks[("VT", 0)][0])


def test_prefetch_many_racing_a_failing_launch(setup):
    """prefetch_many hitting a transiently failing launch must retry and
    leave the engine consistent; a permanently failing one (degrade=False)
    must surface the error without wedging the in-flight table."""
    sm, pre, _, blocks = setup
    inj = FaultInjector([FaultSpec(kind="launch", relation="VV", count=1)])
    eng = _engine(pre, inj, backoff_s=0.001)
    eng.prefetch_many({r: list(range(sm.n_segments)) for r in RELS})
    _assert_identical(eng, blocks)
    assert eng.stats.retries >= 1

    inj2 = FaultInjector([FaultSpec(kind="launch", relation="VV",
                                    transient=False, count=99)])
    eng2 = _engine(pre, inj2, degrade=False, breaker_threshold=1)
    with pytest.raises(LaunchError):
        eng2.prefetch_many({"VV": list(range(sm.n_segments))})
    with pytest.raises(RelationPoisonedError):
        eng2.prefetch("VV", [0])
    assert not eng2._inflight          # nothing wedged in flight
    for s in range(sm.n_segments):     # the healthy relation still serves
        M, L = eng2.get("VT", s)
        assert np.array_equal(M, blocks[("VT", s)][0])


# -- sync watchdog -----------------------------------------------------------

def test_sync_watchdog_times_out_and_recovers(setup):
    sm, pre, _, blocks = setup
    inj = FaultInjector([FaultSpec(kind="sync", relation="VV", hang_s=5.0,
                                   count=1)])
    eng = _engine(pre, inj, sync_timeout_s=0.05, sync_poll_s=0.005)
    t0 = time.perf_counter()
    _assert_identical(eng, blocks)
    dt = time.perf_counter() - t0
    assert dt < 5.0                    # the hang never ran to completion
    assert eng.stats.sync_timeouts >= 1
    assert eng.stats.failed_launches >= 1


def test_sync_watchdog_slow_launch_recovers_without_failing(setup):
    # hang shorter than timeout * max_attempts: retried waits succeed
    sm, pre, _, blocks = setup
    inj = FaultInjector([FaultSpec(kind="sync", relation="VV", hang_s=0.08,
                                   count=1)])
    eng = _engine(pre, inj, sync_timeout_s=0.05, sync_poll_s=0.005)
    _assert_identical(eng, blocks)
    assert eng.stats.sync_timeouts >= 1
    assert eng.stats.failed_launches == 0


def test_hung_sync_waiters_wake_bounded(setup):
    """Threads waiting on a hung launch's condvar must wake when the
    watchdog fails it — bounded joins, no deadlock."""
    sm, pre, _, blocks = setup
    inj = FaultInjector([FaultSpec(kind="sync", relation="VV", hang_s=5.0,
                                   count=1)])
    eng = RelationEngine(pre, RELS, lookahead=0, batch_max=4, device="cpu",
                         fault_policy=FaultPolicy(
                             injector=inj, sync_timeout_s=0.05,
                             sync_poll_s=0.005))
    errs = []

    def read(s):
        try:
            M, L = eng.get("VV", s)
            M0, L0 = blocks[("VV", s)]
            assert np.array_equal(M0, M) and np.array_equal(L0, L)
        except BaseException as exc:  # surfaced, not hung
            errs.append(exc)

    threads = [threading.Thread(target=read, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    assert not any(t.is_alive() for t in threads), "waiter deadlocked"
    assert not errs
    assert eng.stats.sync_timeouts >= 1


# -- shard device loss -------------------------------------------------------

def test_device_loss_rehomes_shard_bit_identical(setup):
    sm, pre, _, blocks = setup
    inj = FaultInjector([FaultSpec(kind="device-lost", shard=0, count=1)])
    eng = RelationEngine(pre, RELS, shards=2, device="cpu",
                         fault_policy=FaultPolicy(injector=inj))
    _assert_identical(eng, blocks)
    assert eng.stats.shards_lost == 1
    assert eng.stats.rehomed_segments > 0
    assert eng.stats.retries >= 1
    # the logical per-shard production partition survives the re-home
    merged = eng.merged_shard_stats()
    assert merged.segments_produced == eng.stats.segments_produced
    # the lost shard's reads now route through the survivor's pool
    lost_pool = eng.store._route[0]
    assert lost_pool == eng.store._route[1]


def test_single_shard_device_loss_degrades_to_host(setup):
    # no surviving shard: production must fall back to the host arm
    sm, pre, _, blocks = setup
    inj = FaultInjector([FaultSpec(kind="device-lost", count=1)])
    eng = _engine(pre, inj)
    _assert_identical(eng, blocks)
    assert eng.stats.shards_lost == 0
    assert eng.stats.degraded_launches >= 1


# -- block-pool upload OOM ---------------------------------------------------

def _pool_evicted_engine(pre, injector, **policy_kw):
    """Engine whose 1-launch device pool evicts segment 0 after segment 1
    is produced — so get_full_dev(0) must take the upload path."""
    eng = RelationEngine(pre, RELS, lookahead=0, batch_max=1,
                         dev_pool_segments=1, device="cpu",
                         fault_policy=FaultPolicy(injector=injector,
                                                  **policy_kw))
    eng.get("VV", 0)
    eng.get("VV", 1)
    assert ("VV", 0) not in eng._dev_pool
    return eng


def test_upload_oom_clears_pool_and_retries(setup):
    sm, pre, _, blocks = setup
    inj = FaultInjector([FaultSpec(kind="upload", relation="VV", count=1)])
    eng = _pool_evicted_engine(pre, inj)
    M, L = eng.get_full_dev("VV", 0)
    assert np.array_equal(M.numpy()[:blocks[("VV", 0)][0].shape[0]],
                          blocks[("VV", 0)][0])
    # clear + one retry succeeded: pooled, not degraded
    assert eng.stats.degraded_reads == 0
    assert ("VV", 0) in eng._dev_pool


def test_upload_oom_twice_serves_unpooled(setup):
    sm, pre, _, blocks = setup
    inj = FaultInjector([FaultSpec(kind="upload", relation="VV", count=2)])
    eng = _pool_evicted_engine(pre, inj)
    M, L = eng.get_full_dev("VV", 0)
    assert np.array_equal(M.numpy()[:blocks[("VV", 0)][0].shape[0]],
                          blocks[("VV", 0)][0])
    assert eng.stats.degraded_reads == 1
    assert ("VV", 0) not in eng._dev_pool


def test_upload_oom_raises_without_degrade(setup):
    sm, pre, _, blocks = setup
    inj = FaultInjector([FaultSpec(kind="upload", relation="VV", count=2)])
    eng = _pool_evicted_engine(pre, inj, degrade=False)
    with pytest.raises(PoolUploadError, match="failed twice") as ei:
        eng.get_full_dev("VV", 0)
    assert ei.value.segment == 0 and ei.value.relation == "VV"


# -- stats lifecycle ---------------------------------------------------------

def test_reset_stats_clears_fault_counters_exactly(setup):
    sm, pre, _, blocks = setup
    inj = FaultInjector([
        FaultSpec(kind="launch", relation="VV", count=1),
        FaultSpec(kind="launch", relation="VT", transient=False, count=2),
    ])
    eng = _engine(pre, inj, backoff_s=0.001, breaker_threshold=2)
    _assert_identical(eng, blocks)
    assert eng.stats.retries > 0 and eng.stats.degraded_launches > 0
    eng.reset_stats()
    assert eng.stats == EngineStats()      # every field, exactly zero
    assert eng.worker_stats == {} and eng.shard_stats == {}
    d = dataclasses.asdict(eng.stats)
    assert all(v == 0 for v in d.values())


def test_engine_stats_has_fault_fields():
    s = EngineStats()
    for f in ("retries", "sync_timeouts", "failed_launches",
              "failed_segments", "breaker_trips", "breaker_recoveries",
              "degraded_launches", "degraded_segments", "degraded_reads",
              "shards_lost", "rehomed_segments"):
        assert getattr(s, f) == 0


# -- env installation --------------------------------------------------------

def test_env_spec_installs_policy(setup, monkeypatch):
    sm, pre, _, blocks = setup
    monkeypatch.setenv("REPRO_FAULT_SPEC",
                       "launch:relation=VV,count=1;policy:max_attempts=5")
    eng = RelationEngine(pre, RELS, lookahead=0, batch_max=1, device="cpu")
    assert eng._fault_policy.max_attempts == 5
    assert eng._injector is not None
    _assert_identical(eng, blocks)
    assert eng.stats.retries >= 1
    # an explicit policy shields reference engines from the env
    clean = RelationEngine(pre, RELS, device="cpu",
                           fault_policy=FaultPolicy())
    assert clean._injector is None


def test_sync_timeout_kwarg_overrides_policy(setup):
    sm, pre, _, blocks = setup
    eng = RelationEngine(pre, RELS, device="cpu", fault_policy=FaultPolicy(),
                         sync_timeout_s=1.5)
    assert eng._fault_policy.sync_timeout_s == 1.5
    _assert_identical(eng, blocks)     # watchdog armed, no faults: clean


# -- scheduler error attribution ---------------------------------------------

def test_scheduler_names_worker_and_batch_in_error():
    def consume(i, item):
        if i == 5:
            raise LaunchError("kaput", relation="VV", segment=5)
        return i

    with pytest.raises(LaunchError) as ei:
        run_partitioned(list(range(16)), consume, lambda i, r: None,
                        workers=4, name="faulty")
    msg = str(ei.value)
    assert "kaput" in msg                       # original text preserved
    assert "faulty: worker w" in msg and "failed at batch 5" in msg
    assert ei.value.__traceback__ is not None   # original traceback chained
    assert ei.value.relation == "VV"            # structured fields intact


# -- the host arm: all ten relations ---------------------------------------

@pytest.fixture(scope="module")
def host_tables():
    """(nvl, relation -> (tabX, tabY, colg)) of every segment of a small
    mesh, preconditioned for all ten relations."""
    sm = segment_mesh(structured_grid(5, 5, 5), capacity=16)
    t = precondition(sm, relations=list(ops.DEFAULT_DEG)).tables
    out = {}
    for relation in ops.DEFAULT_DEG:
        if relation == "VV":
            out[relation] = (t.T_local, t.T_local, t.LV_global)
        else:
            tabX, _ = t.table(relation[0])
            tabY, colg = t.table(relation[1])
            out[relation] = (tabX, tabY, colg)
    return t.NV, out


@pytest.mark.parametrize("deg", [None, 1])
@pytest.mark.parametrize("relation", sorted(ops.DEFAULT_DEG))
def test_host_arm_equals_the_reference_and_the_plain_arm(host_tables,
                                                         relation, deg):
    """The degraded arm gives the same ``(M, L)`` as the reference's host
    arm and the port's plain torch arm (both assemblies): ascending local
    columns, -1 padding, and ``L`` the true count past a width of 1."""
    nvl, tabs = host_tables
    tabX, tabY, colg = tabs[relation]
    M, L = ops.relation_block_host(relation, tabX, tabY, colg, nvl, deg=deg)
    assert M.dtype == L.dtype == np.int32
    rM, rL = ref_ops.relation_block_host(relation, tabX, tabY, colg, nvl,
                                         deg=deg)
    assert np.array_equal(M, rM) and np.array_equal(L, rL)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in tabs[relation]]
    for assembly in ("sparse", "dense"):
        pM, pL = ops.relation_block(relation, *t, nvl, deg=deg,
                                    backend="torch", assembly=assembly)
        assert np.array_equal(M, pM.numpy()) and np.array_equal(L, pL.numpy())
    if deg == 1:
        assert L.max() > 1               # rows past the width stay visible


def test_degraded_launch_past_the_width_raises(setup):
    """A host-arm launch whose rows overflow ``deg`` raises the same
    RelationWidthError as a device launch: the ladder does not absorb it."""
    sm, pre, _, _ = setup
    inj = FaultInjector([FaultSpec(kind="launch", relation="VV",
                                   transient=False, count=9)])
    eng = RelationEngine(pre, RELS, lookahead=0, batch_max=1, device="cpu",
                         deg={"VV": 2}, fault_policy=FaultPolicy(
                             injector=inj, breaker_threshold=1))
    with pytest.raises(RelationWidthError, match="deg=\\{'VV'"):
        eng.get("VV", 0)
    assert eng.stats.degraded_launches == 1


# -- no ladder for errors the injector did not raise -------------------------

def test_kernel_arm_runtime_error_propagates_undegraded(setup, monkeypatch):
    """A RuntimeError inside the plain arm's relation_block (as a CUDA
    error or a failed kernel build would raise it) is no taxonomy fault:
    it propagates unchanged, nothing retries, trips or degrades, and the
    engine serves the block once the arm works again."""
    sm, pre, _, blocks = setup
    eng = _engine(pre, backoff_s=0.001, breaker_threshold=1)
    real = engine_mod.ops.relation_block

    def broken(*args, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(engine_mod.ops, "relation_block", broken)
    with pytest.raises(RuntimeError, match="illegal memory access") as ei:
        eng.get("VV", 0)
    assert not isinstance(ei.value, RelationError)
    st = eng.stats
    assert (st.degraded_launches, st.degraded_segments, st.retries,
            st.breaker_trips, st.failed_launches, st.kernel_launches) \
        == (0, 0, 0, 0, 0, 0)
    assert not eng._inflight
    monkeypatch.setattr(engine_mod.ops, "relation_block", real)
    M, L = eng.get("VV", 0)
    assert np.array_equal(M, blocks[("VV", 0)][0])
    assert eng.stats.degraded_launches == 0


# -- synced scenarios: the reference's counters, key for key -----------------

# name -> (fault spec rows, policy knobs, engine knobs, ops); every
# schedule's counters are independent of the machine's speed: a breaker
# cooldown is either outwaited by the ops' sleeps or never expires
SYNCED = {
    "transient": ([dict(kind="launch", relation="VV", count=2)],
                  dict(backoff_s=0.001), {}, "all"),
    "breaker": ([dict(kind="launch", relation="VT", transient=False,
                      count=3)],
                dict(breaker_threshold=2, breaker_cooldown_s=0.02), {},
                "breaker"),
    "mixed": ([dict(kind="launch", relation="VV", count=1),
               dict(kind="launch", relation="VT", transient=False,
                    count=2)],
              # a cooldown no run outlasts: every VT launch after the trip
              # degrades, however slow the machine
              dict(backoff_s=0.001, breaker_threshold=2,
                   breaker_cooldown_s=60.0), {}, "all"),
    "poison": ([dict(kind="launch", relation="VV", transient=False,
                     count=99)],
               dict(degrade=False, breaker_threshold=1), {}, "poison"),
    "hung_sync": ([dict(kind="sync", relation="VV", hang_s=5.0, count=1)],
                  dict(sync_timeout_s=0.05, sync_poll_s=0.005), {}, "all"),
    "device_lost_2": ([dict(kind="device-lost", shard=0, count=1)], {},
                      dict(shards=2), "all"),
    "device_lost_1": ([dict(kind="device-lost", count=1)], {}, {}, "all"),
    "upload_once": ([dict(kind="upload", relation="VV", count=1)], {},
                    dict(dev_pool_segments=1), "upload"),
    "upload_twice": ([dict(kind="upload", relation="VV", count=2)], {},
                     dict(dev_pool_segments=1), "upload"),
}


def _drive(eng, ops, n_segments):
    if ops == "all":
        for r in RELS:
            for s in range(n_segments):
                eng.get(r, s)
    elif ops == "breaker":
        _breaker_walk(eng, n_segments)
        # device reads of the degraded blocks: uploads, the host arm's
        # launches are never pooled
        for s in range(n_segments):
            eng.get_full_dev("VT", s)
    elif ops == "poison":
        for s in (0, 1):
            # LaunchError, then RelationPoisonedError (either package's)
            with pytest.raises(RuntimeError, match="permanent"):
                eng.get("VV", s)
        for s in range(n_segments):
            eng.get("VT", s)
    else:                                   # upload
        eng.get("VV", 0)
        eng.get("VV", 1)
        eng.get_full_dev("VV", 0)


def _counters(stats):
    return {k: v for k, v in stats.as_dict().items()
            if not k.startswith("t_") and k != "sync_timeouts"}


@pytest.mark.parametrize("name", sorted(SYNCED))
def test_synced_stats_equal_the_reference(setup, name):
    sm, pre, ref_pre, _ = setup
    rows, policy_kw, engine_kw, ops = SYNCED[name]
    kw = dict(lookahead=0, batch_max=1, async_dispatch=False, **engine_kw)
    ref_inj = ref_faults.FaultInjector(
        [ref_faults.FaultSpec(**row) for row in rows])
    ref = RefEngine(ref_pre, RELS, tune="off", **kw,
                    fault_policy=ref_faults.FaultPolicy(injector=ref_inj,
                                                        **policy_kw))
    inj = FaultInjector([FaultSpec(**row) for row in rows])
    eng = RelationEngine(pre, RELS, device="cpu", **kw,
                         fault_policy=FaultPolicy(injector=inj, **policy_kw))
    _drive(ref, ops, sm.n_segments)
    _drive(eng, ops, sm.n_segments)
    assert len(inj.injected) > 0
    assert inj.injected == ref_inj.injected
    assert _counters(eng.stats) == _counters(ref.stats)
    assert ({k: _counters(v) for k, v in eng.shard_stats.items()}
            == {k: _counters(v) for k, v in ref.shard_stats.items()})
    assert eng.merged_worker_stats().as_dict().keys() \
        == ref.stats.as_dict().keys()
