"""The engine API the benchmarks call and the dataset pool, against the
reference, exactly, on the CPU: ``request`` de-duplication,
``clear_cache``'s return value, ``cache_nbytes`` before and after,
``reset_stats`` (and ``merged_worker_stats() == stats`` across it),
``EngineStats.as_dict``, ``async_dispatch=False``; all thirteen named
datasets and the ``sinusoid`` and ``radial`` fields."""

import numpy as np
import pytest

from repro.algorithms import fields as ref_fields
from repro.core.engine import RelationEngine as RefEngine
from repro.core.mesh import segment_mesh as ref_segment_mesh
from repro.core.segtables import precondition as ref_precondition
from repro.data import meshgen as ref_meshgen
from repro_torch.algorithms import fields
from repro_torch.core.engine import EngineStats, RelationEngine
from repro_torch.core.mesh import segment_mesh
from repro_torch.core.segtables import precondition
from repro_torch.data import meshgen

RELATIONS = ["VV", "VT", "VE"]
COUNTERS = ("requests", "kernel_launches", "segments_produced",
            "cache_hits", "cache_misses", "evictions")
# counters of the reference's EngineStats that the port lacks: none, since
# the fault-recovery counters were ported with the fault ladder
REFERENCE_ONLY_KEYS = set()


@pytest.fixture(scope="module")
def pres():
    def grid(gen, fld):
        return gen.structured_grid(9, 9, 9, scalar_fn=fld.gaussians(
            5, k=4, sigma=3.0, scale=9))
    return (ref_precondition(ref_segment_mesh(
                grid(ref_meshgen, ref_fields), 32), RELATIONS),
            precondition(segment_mesh(grid(meshgen, fields), 32), RELATIONS))


def _engines(pres, **kw):
    ref, port = pres
    # both synced a launch at a time, so every counter is deterministic
    return (RefEngine(ref, RELATIONS, tune="off", async_dispatch=False, **kw),
            RelationEngine(port, RELATIONS, device="cpu",
                           async_dispatch=False, **kw))


def _same_counters(a, b):
    for f in COUNTERS + ("devpool_hits", "devpool_uploads"):
        assert getattr(b.stats, f) == getattr(a.stats, f), f


def test_request_enqueues_once_and_never_launches(pres):
    a, b = _engines(pres, lookahead=0)
    for eng in (a, b):
        eng.get("VV", 2)                       # cached
        eng.request("VV", [0, 1, 2, 1, 0, 3])
        eng.request("VV", [3, 4, 0])
        assert eng.queues["VV"] == [0, 1, 3, 4]
        assert eng.stats.kernel_launches == 1
    _same_counters(a, b)
    # the queued segments are produced by the next drain, each once
    for eng in (a, b):
        eng.get_batch("VV", [0, 1, 3, 4])
    _same_counters(a, b)


@pytest.mark.parametrize("kw", [{}, {"cache_segments": 4, "batch_max": 2,
                                     "lookahead": 1}])
def test_clear_cache_and_cache_nbytes_equal_the_reference(pres, kw):
    a, b = _engines(pres, **kw)
    assert b.cache_nbytes() == a.cache_nbytes() == 0
    assert b.clear_cache() == a.clear_cache() == 0
    for eng in (a, b):
        eng.get_batch("VV", [0, 1, 2])
        eng.get_full_dev_many(("VT",), [3, 4])
        eng.prefetch("VE", [5, 6])
    assert b.cache_nbytes() == a.cache_nbytes() > 0
    assert len(b.cache) == len(a.cache)
    dropped = b.clear_cache()
    assert dropped == a.clear_cache() > 0
    assert b.cache_nbytes() == a.cache_nbytes() == 0
    assert len(b.cache) == 0
    # a cold read after the clear produces the block again
    produced = b.stats.segments_produced
    for eng in (a, b):
        eng.get("VV", 0)
    assert b.stats.segments_produced > produced
    _same_counters(a, b)


def test_clear_cache_retires_in_flight_launches(pres):
    _, port = pres
    eng = RelationEngine(port, RELATIONS, device="cpu", batch_max=2,
                         lookahead=0, inflight_max=8)
    eng.prefetch("VV", [0, 1, 2, 3])          # two launches, not integrated
    before = eng.stats.segments_produced
    assert eng.clear_cache() > 0
    assert not eng._flights and not eng._inflight
    assert eng.cache_nbytes() == 0 and len(eng.cache) == 0
    eng.get("VV", 1)                          # produced again, not revived
    assert eng.stats.segments_produced == before + 1


def test_reset_stats_keeps_the_worker_invariant(pres):
    _, b = _engines(pres)
    with b.worker_scope("w1"):
        b.get_batch("VT", [0, 1])
    b.get("VV", 3)
    assert b.merged_worker_stats() == b.stats and b.stats.requests == 3
    b.reset_stats()
    assert b.stats == EngineStats() and b.worker_stats == {}
    assert b.merged_worker_stats() == b.stats
    with b.worker_scope("w2"):
        b.get("VV", 3)                        # a hit after the reset
    assert b.stats.requests == 1 and b.stats.cache_hits == 1
    assert b.stats.kernel_launches == 0
    assert b.merged_worker_stats() == b.stats


def test_as_dict_matches_the_reference(pres):
    a, b = _engines(pres)
    for eng in (a, b):
        eng.get_batch("VV", [0, 1, 2])
        eng.get("VT", 5)
        eng.stat_bump(completion_raw_neighbors=9, completion_neighbors=4)
    da, db = a.stats.as_dict(), b.stats.as_dict()
    assert set(da) - set(db) == REFERENCE_ONLY_KEYS
    assert set(db) <= set(da)
    for k, v in db.items():
        if k.startswith("t_"):
            assert isinstance(v, float) and v >= 0.0, k
        else:
            assert v == da[k], k
    assert db["completion_dedup_ratio"] == 9 / 4
    assert EngineStats().as_dict()["completion_dedup_ratio"] == 0.0


@pytest.mark.parametrize("kw", [{}, {"batch_max": 1, "lookahead": 0,
                                     "cache_segments": 8},
                                {"batch_max": 1, "lookahead": 8}])
def test_synced_dispatch_matches_the_reference(pres, kw):
    a, b = _engines(pres, **kw)
    ns = pres[1].smesh.n_segments
    calls = [("get_batch", "VV", [0, 1, 2]), ("get", "VT", 3),
             ("prefetch_many", {"VV": [5, 6], "VT": [5, 9]}),
             ("get_batch", "VT", [5, 9, 2, 5]),
             ("get_full_dev_many", ("VV",), [ns - 1, 0]),
             ("prefetch", "VE", [10, 11, 12]),
             ("get_batch", "VE", [12, 4, ns - 2])]
    for name, *args in calls:
        x = getattr(a, name)(*args)
        y = getattr(b, name)(*args)
        if name == "get":
            x, y = [x], [y]
        if name == "get_full_dev_many":
            np.testing.assert_array_equal(y.M["VV"].numpy(),
                                          np.asarray(x.M["VV"]))
        elif x is not None:
            for (xm, xl), (ym, yl) in zip(x, y):
                np.testing.assert_array_equal(ym, xm)
                np.testing.assert_array_equal(yl, xl)
        _same_counters(a, b)
        # every launch was synced and integrated at its dispatch
        assert not b._inflight
    assert b.cache_nbytes() == a.cache_nbytes()


NAMES = ["toy", "engine", "foot", "fish", "asteroid", "hole", "stent", "bar",
         "graded", "slivers", "tunnel", "pockets", "archipelago"]


def test_the_dataset_pool_is_the_references():
    assert sorted(meshgen.DATASETS) == sorted(ref_meshgen.DATASETS)
    assert sorted(NAMES) == sorted(meshgen.DATASETS)


@pytest.mark.parametrize("name", NAMES)
def test_datasets_equal_the_reference(name):
    fn, ref_fn = fields.gaussians(2, k=5, sigma=5.0), \
        ref_fields.gaussians(2, k=5, sigma=5.0)
    a = ref_meshgen.load_dataset(name, scalar_fn=ref_fn)
    b = meshgen.load_dataset(name, scalar_fn=fn)
    for f in ("points", "tets", "scalars"):
        x, y = getattr(a, f), getattr(b, f)
        assert y.dtype == x.dtype, f
        np.testing.assert_array_equal(y, x, err_msg=f)
    assert b.n_vertices == a.n_vertices and b.n_tets == a.n_tets


@pytest.mark.parametrize("field,args", [
    ("sinusoid", ()), ("sinusoid", (0.9,)), ("radial", ()),
    ("radial", ((4.0, 2.5, -1.0),))])
def test_fields_equal_the_reference(field, args):
    pts = np.random.default_rng(7).uniform(-5, 20, (500, 3)).astype(
        np.float32)
    x = getattr(ref_fields, field)(*args)(pts)
    y = getattr(fields, field)(*args)(pts)
    assert y.dtype == x.dtype == np.float32
    np.testing.assert_array_equal(y, x)
