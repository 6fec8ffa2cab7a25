"""The port's relation engine (``repro_torch.core.engine``) against the
reference engine (``repro.core.engine``, ``tune="off"``): for one call
sequence the blocks are equal and so are the launch and production counts;
the width check raises; concurrent device-batch reads produce every block
exactly once. Plain torch arm on the CPU."""

import sys
import threading

import numpy as np
import pytest
import torch

from repro.algorithms import fields as ref_fields
from repro.core.engine import RelationEngine as RefEngine
from repro.core.mesh import segment_mesh as ref_segment_mesh
from repro.core.segtables import precondition as ref_precondition
from repro.data.meshgen import structured_grid as ref_structured_grid
from repro_torch.algorithms import fields
from repro_torch.core.engine import RelationEngine
from repro_torch.core.faults import FaultPolicy
from repro_torch.core.mesh import segment_mesh
from repro_torch.core.segtables import precondition
from repro_torch.data.meshgen import structured_grid
from repro_torch.distributed.sharding import ShardPlan
from repro_torch.errors import RelationWidthError

RELATIONS = ["VV", "VT", "VE"]


def _grid(mod_grid, mod_fields):
    return mod_grid(8, 8, 8, scalar_fn=mod_fields.gaussians(1, k=3,
                                                             sigma=3.0))


@pytest.fixture(scope="module")
def pres():
    ref = ref_precondition(ref_segment_mesh(
        _grid(ref_structured_grid, ref_fields), capacity=32), RELATIONS)
    port = precondition(segment_mesh(
        _grid(structured_grid, fields), capacity=32), RELATIONS)
    return ref, port


def _engines(pres, **kw):
    ref, port = pres
    return (RefEngine(ref, RELATIONS, tune="off", **kw),
            RelationEngine(port, RELATIONS, device="cpu", **kw))


def _same_blocks(a, b):
    assert len(a) == len(b)
    for (Ma, La), (Mb, Lb) in zip(a, b):
        np.testing.assert_array_equal(Ma, Mb)
        np.testing.assert_array_equal(La, Lb)


@pytest.mark.parametrize("kw", [{}, {"lookahead": 2, "batch_max": 4},
                                {"lookahead": 0, "batch_max": 1}])
def test_call_sequence_matches_the_reference(pres, kw):
    ref, port = _engines(pres, **kw)
    ns = pres[0].smesh.n_segments
    calls = [("get_batch", "VV", [0, 1, 2]),
             ("get", "VT", 3),
             ("prefetch_many", {"VV": [5, 6], "VT": [5, 9]}),
             ("get_batch", "VT", [5, 9, 2, 5]),
             ("get_batch", "VE", [ns - 1, 0]),
             ("prefetch", "VV", [10, 11, 12]),
             ("get_batch", "VV", [12, 4, ns - 2])]
    for name, *args in calls:
        a = getattr(ref, name)(*args)
        b = getattr(port, name)(*args)
        if name == "get":
            a, b = [a], [b]
        if a is not None:
            _same_blocks(a, b)
    for f in ("kernel_launches", "segments_produced", "requests",
              "cache_hits", "cache_misses"):
        assert getattr(port.stats, f) == getattr(ref.stats, f), f
    # produced == distinct: every produced block is cached exactly once
    assert port.stats.segments_produced == len(port.cache)
    assert port.merged_worker_stats() == port.stats


@pytest.mark.parametrize("kw", [{}, {"dev_pool_segments": 1,
                                     "batch_max": 2, "lookahead": 0}])
def test_device_batches_match_the_reference(pres, kw):
    # the second engine's pool holds one launch: reads of evicted blocks
    # take the host-cache upload path
    ref, port = _engines(pres, **kw)
    ns = pres[0].smesh.n_segments
    cols = {"VV": 16, "VT": 32}
    for segs in ([0, 1, 2, 3], [4, 9], [ns - 1, 1, 7], [0, 2, 9]):
        a = ref.get_full_dev_many(("VV", "VT"), segs, cols=cols)
        b = port.get_full_dev_many(("VV", "VT"), segs, cols=cols)
        assert a.n_rows == b.n_rows and a.segments == b.segments
        np.testing.assert_array_equal(a.gid, b.gid)
        np.testing.assert_array_equal(np.asarray(a.gid_dev), b.gid_dev)
        for r in ("VV", "VT"):
            np.testing.assert_array_equal(np.asarray(a.M[r]), b.M[r])
            np.testing.assert_array_equal(np.asarray(a.L[r]), b.L[r])
    for f in ("kernel_launches", "segments_produced"):
        assert getattr(port.stats, f) == getattr(ref.stats, f), f
    # every read is a pool hit or a counted upload; which one depends on
    # whether a launch finished (and was integrated, filling the pool)
    # before a later launch evicted it — timing, on both engines
    reads = lambda st: st.devpool_hits + st.devpool_uploads
    assert reads(port.stats) == reads(ref.stats) == 2 * 12
    if kw:
        assert port.stats.devpool_uploads > 0
    else:
        assert port.stats.devpool_uploads == ref.stats.devpool_uploads == 0


def test_small_cache_re_produces_evicted_blocks_identically(pres):
    ref, port = _engines(pres, lookahead=0, batch_max=1, cache_segments=2)
    for s in (0, 1, 2, 3, 0):
        _same_blocks([ref.get("VV", s)], [port.get("VV", s)])
    assert len(port.cache) <= 2 and port.cache.evictions >= 3


def test_width_overflow_raises(pres):
    eng = RelationEngine(pres[1], ["VV"], device="cpu", lookahead=0,
                         deg={"VV": 4})
    with pytest.raises(RelationWidthError, match="deg"):
        eng.get("VV", 0)


def test_concurrent_device_batches_produce_each_block_once(pres):
    port = pres[1]
    ns = port.smesh.n_segments
    serial = RelationEngine(port, ["VV", "VT"], device="cpu")
    want = {s: serial.get_full_dev_many(("VV", "VT"), [s]) for s in range(ns)}
    eng = RelationEngine(port, ["VV", "VT"], device="cpu", lookahead=3,
                         batch_max=4)
    got, errors = {}, []

    def work(w):
        try:
            with eng.worker_scope(f"w{w}"):
                for s in list(range(w, ns, 4)) + list(range(ns)):
                    got[(w, s)] = eng.get_full_dev_many(("VV", "VT"), [s])
        except BaseException as exc:  # surfaced by the assert below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(w,))
                   for w in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    # every (relation, segment) block was produced exactly once
    assert eng.stats.segments_produced == 2 * ns
    assert eng.merged_worker_stats() == eng.stats
    for (w, s), cb in got.items():
        for r in ("VV", "VT"):
            assert torch.equal(cb.M[r], want[s].M[r])
            assert torch.equal(cb.L[r], want[s].L[r])


def test_unported_options_and_missing_card_raise(pres):
    port = pres[1]
    # shards on distinct cards: the cross-card exchange is unverified
    cards = ShardPlan.make(port.smesh.n_segments, 2,
                           devices=("cuda:0", "cuda:1"))
    with pytest.raises(NotImplementedError, match="second card"):
        RelationEngine(port, ["VV"], device="cpu", shard_plan=cards)
    # the fault ladder is ported: an explicit policy is taken as given
    eng = RelationEngine(port, ["VV"], device="cpu",
                         fault_policy=FaultPolicy(max_attempts=5))
    assert eng._fault_policy.max_attempts == 5
    with pytest.raises(ValueError, match="CUDA device"):
        RelationEngine(port, ["VV"], device="cpu", backend="cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            RelationEngine(port, ["VV"])


def test_reentrant_call_raises(pres, monkeypatch):
    eng = RelationEngine(pres[1], ["VV"], device="cpu", lookahead=0)
    from repro_torch.kernels import ops
    real = ops.relation_block

    def reenter(*a, **k):
        eng.get("VV", 1)
        return real(*a, **k)

    monkeypatch.setattr(ops, "relation_block", reenter)
    with pytest.raises(RuntimeError, match="re-entrant"):
        eng.get("VV", 0)
    monkeypatch.setattr(ops, "relation_block", real)
    M, L = eng.get("VV", 0)
    assert L.shape[0] > 0
