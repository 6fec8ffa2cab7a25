"""The port's compared data structures (``repro_torch.core.explicit``)
against the reference's (``repro.core.explicit``), exactly, on the CPU:
``ExplicitTriangulation``'s ``(M, L)`` for all ten relations and its query
API; the TopoCluster and ACTOPO blocks and counters (both sync every
launch, so both are deterministic); the drivers' outputs through the
explicit structure and the localized baselines; and ``analyze_mesh``'s
GALE and Explicit rows against the reference drivers."""

import dataclasses
import hashlib

import numpy as np
import pytest

from repro.algorithms import fields as ref_fields
from repro.algorithms.critical_points import \
    critical_points as ref_critical_points
from repro.algorithms.discrete_gradient import \
    discrete_gradient as ref_discrete_gradient
from repro.algorithms.morse_smale import morse_smale as ref_morse_smale
from repro.algorithms.persistence import \
    persistence_pairs as ref_persistence_pairs
from repro.core import explicit as ref_explicit
from repro.core.mesh import segment_mesh as ref_segment_mesh
from repro.core.segtables import precondition as ref_precondition
from repro.data import meshgen as ref_meshgen
from repro_torch import analyze_mesh
from repro_torch.algorithms import fields
from repro_torch.algorithms.critical_points import critical_points, \
    total_order
from repro_torch.algorithms.discrete_gradient import discrete_gradient
from repro_torch.algorithms.morse_smale import morse_smale
from repro_torch.algorithms.persistence import persistence_pairs
from repro_torch.core import explicit
from repro_torch.core.engine import RelationEngine
from repro_torch.core.mesh import segment_mesh
from repro_torch.core.segtables import precondition
from repro_torch.data import meshgen

ALL = ["VV", "VE", "VF", "VT", "ET", "FT", "EF", "TT", "EE", "FF"]
RELS = ["VV", "VE", "VF", "VT", "FT", "TT"]
COUNTERS = ("requests", "kernel_launches", "segments_produced",
            "cache_hits", "cache_misses", "evictions")


def _mesh(gen, fld, name):
    if name == "grid9":
        return gen.structured_grid(9, 9, 9, scalar_fn=fld.gaussians(
            5, k=4, sigma=3.0, scale=9))
    return gen.load_dataset(name, scalar_fn=fld.gaussians(2, k=5, sigma=5.0))


_PRE = {}


def _pres(name, capacity=32):
    """(reference, port) preconditioned for every relation, built once."""
    if name not in _PRE:
        _PRE[name] = (
            ref_precondition(ref_segment_mesh(
                _mesh(ref_meshgen, ref_fields, name), capacity), ALL),
            precondition(segment_mesh(
                _mesh(meshgen, fields, name), capacity), ALL))
    return _PRE[name]


_EXPLICIT = {}


def _explicit(name):
    """Both packages' explicit structures over all ten relations."""
    if name not in _EXPLICIT:
        ref, port = _pres(name)
        _EXPLICIT[name] = (ref_explicit.ExplicitTriangulation(ref, ALL),
                           explicit.ExplicitTriangulation(port, ALL,
                                                          device="cpu"))
    return _EXPLICIT[name]


def _digest(obj) -> str:
    h = hashlib.sha256()
    for f in dataclasses.fields(obj):
        h.update(np.ascontiguousarray(
            np.asarray(getattr(obj, f.name)).astype(np.int64)).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("relation", ALL)
@pytest.mark.parametrize("name", ["grid9", "toy", "graded"])
def test_relation_tables_equal_the_reference(name, relation):
    ref, port = _pres(name)
    a = ref_explicit.ExplicitTriangulation(ref, [relation])
    b = explicit.ExplicitTriangulation(port, [relation], device="cpu")
    assert sorted(a.rel) == sorted(b.rel)
    for r in a.rel:
        np.testing.assert_array_equal(b.rel[r][0], a.rel[r][0], err_msg=r)
        np.testing.assert_array_equal(b.rel[r][1], a.rel[r][1], err_msg=r)
        assert b.rel[r][0].dtype == a.rel[r][0].dtype
        assert b.rel[r][1].dtype == a.rel[r][1].dtype
    assert b.deg == a.deg
    assert b.memory_bytes() == a.memory_bytes()
    assert b.relations == a.relations


def test_query_api_equals_the_reference():
    a, b = _explicit("grid9")
    pre = b.pre
    ns = pre.smesh.n_segments
    rng = np.random.default_rng(3)
    for r in ALL:
        for s in (0, ns // 2, ns - 1):
            for x, y in zip(a.get(r, s), b.get(r, s)):
                np.testing.assert_array_equal(y, x)
            for x, y in zip(a.get_full(r, s), b.get_full(r, s)):
                np.testing.assert_array_equal(y, x)
        for (xm, xl), (ym, yl) in zip(a.get_batch(r, [2, 0, 2]),
                                      b.get_batch(r, [2, 0, 2])):
            np.testing.assert_array_equal(ym, xm)
            np.testing.assert_array_equal(yl, xl)
    for kind, n in (("V", pre.smesh.n_vertices), ("E", pre.n_edges),
                    ("F", pre.n_faces), ("T", pre.smesh.n_tets)):
        segs = rng.integers(0, ns, 200)
        gids = rng.integers(0, n, 200)
        np.testing.assert_array_equal(b.local_rows(kind, segs, gids),
                                      a.local_rows(kind, segs, gids))
    ids = {"E": rng.integers(0, pre.n_edges, 50),
           "F": rng.integers(0, pre.n_faces, 50),
           "T": rng.integers(0, pre.smesh.n_tets, 50)}
    for rel in ("EV", "FV", "TV", "FE", "TE", "TF"):
        np.testing.assert_array_equal(
            getattr(b, f"boundary_{rel}")(ids[rel[0]]),
            getattr(a, f"boundary_{rel}")(ids[rel[0]]), err_msg=rel)
    for r in ("VT", "TT", "FF"):
        sel = rng.integers(0, len(b.rel[r][1]), 40)
        for x, y in zip(a.rows(r, sel), b.rows(r, sel)):
            np.testing.assert_array_equal(y, x)
    assert b.deg == a.deg and b.memory_bytes() == a.memory_bytes()
    b.prefetch("VV", [0, 1])
    b.prefetch_many({"VV": [0]})
    assert b.stats.requests == 0      # queries and hints count nothing


@pytest.mark.parametrize("cols", [None, {"VV": 8, "VT": 16}])
def test_device_batches_equal_the_reference(cols):
    ref, port = _pres("grid9")
    a = ref_explicit.ExplicitTriangulation(ref, ["VV", "VT"])
    b = explicit.ExplicitTriangulation(port, ["VV", "VT"], device="cpu")
    ns = port.smesh.n_segments
    for segs in ([0, 1, 2], [ns - 1, 3], [5]):
        x = a.get_full_dev_many(("VV", "VT"), segs, cols=cols)
        y = b.get_full_dev_many(("VV", "VT"), segs, cols=cols)
        assert (y.kind, y.segments, y.n_rows) == (x.kind, x.segments,
                                                 x.n_rows)
        np.testing.assert_array_equal(y.gid, x.gid)
        assert y.gid_dev.device.type == "cpu"
        np.testing.assert_array_equal(y.gid_dev.numpy(), np.asarray(x.gid_dev))
        for r in ("VV", "VT"):
            assert y.M[r].dtype == y.L[r].dtype == y.gid_dev.dtype
            np.testing.assert_array_equal(y.M[r].numpy(), np.asarray(x.M[r]))
            np.testing.assert_array_equal(y.L[r].numpy(), np.asarray(x.L[r]))
    for f in ("requests", "devpool_uploads", "devpool_hits"):
        assert getattr(b.stats, f) == getattr(a.stats, f), f
    assert b.merged_worker_stats() == b.stats


def _baselines(name, cls, relations, **kw):
    ref, port = _pres(name)
    return (getattr(ref_explicit, cls)(ref, relations, tune="off", **kw),
            getattr(explicit, cls)(port, relations, device="cpu", **kw))


@pytest.mark.parametrize("cls", ["TopoClusterDS", "ActopoDS"])
def test_localized_blocks_and_counters_equal_the_reference(cls):
    a, b = _baselines("grid9", cls, ["VV", "VT"])
    ns = b.engine.smesh.n_segments
    assert ns > 16
    calls = [("get_batch", "VV", list(range(8))),      # TopoCluster's cache
             ("get", "VT", 3),
             ("prefetch_many", {"VV": [17, 18], "VT": [5, 9]}),
             ("get_batch", "VT", [5, 9, 2, 5]),
             ("prefetch", "VV", [10, 11, 12]),
             ("get_batch", "VV", [12, 4, ns - 2, 0]),
             ("get", "VV", ns - 1)]
    for name, *args in calls:
        x = getattr(a, name)(*args)
        y = getattr(b, name)(*args)
        if name == "get":
            x, y = [x], [y]
        if x is not None:
            assert len(x) == len(y)
            for (xm, xl), (ym, yl) in zip(x, y):
                np.testing.assert_array_equal(ym, xm)
                np.testing.assert_array_equal(yl, xl)
        for f in COUNTERS:
            assert getattr(b.stats, f) == getattr(a.stats, f), (name, f)
    assert b.engine.async_dispatch is False and b.engine.batch_max == 1
    assert b.engine.merged_worker_stats() == b.stats


def test_topocluster_batch_past_its_cache_counts_like_the_reference():
    # 16 segments through an 8-segment cache: both packages drain all 16
    # launches before reading, so the last 8 evict the first 8, whose
    # re-production at their reads evicts the last 8 in turn: every block
    # is produced twice (32), with the reference's launches and evictions
    a, b = _baselines("grid9", "TopoClusterDS", ["VV"])
    for _ in range(2):             # a second pass over the same segments
        x = a.get_batch("VV", list(range(16)))
        blocks = b.get_batch("VV", list(range(16)))
        assert len(blocks) == 16 and len(b.engine.cache) == 8
        for (xm, xl), (ym, yl) in zip(x, blocks):
            np.testing.assert_array_equal(ym, xm)
            np.testing.assert_array_equal(yl, xl)
        for f in COUNTERS:
            assert getattr(b.stats, f) == getattr(a.stats, f), f
        if _ == 0:
            assert b.stats.segments_produced == 32
    assert b.engine.merged_worker_stats() == b.stats


@pytest.mark.parametrize("structure", ["Explicit", "TopoClusterDS",
                                       "ActopoDS", "GALE"])
def test_critical_points_equal_the_reference(structure):
    ref, port = _pres("foot", 64)
    rank = total_order(port.smesh.scalars)
    if structure == "Explicit":
        a = ref_explicit.ExplicitTriangulation(ref, ["VV", "VT"])
        b = explicit.ExplicitTriangulation(port, ["VV", "VT"], device="cpu")
    elif structure == "GALE":
        a = ref_explicit.ExplicitTriangulation(ref, ["VV", "VT"])
        b = RelationEngine(port, ["VV", "VT"], device="cpu")
    else:
        a, b = _baselines("foot", structure, ["VV", "VT"])
    want, want_counts = ref_critical_points(a, ref, rank)
    got, counts = critical_points(b, port, rank)
    np.testing.assert_array_equal(got, want)
    assert counts == want_counts
    if structure in ("TopoClusterDS", "ActopoDS"):
        for f in COUNTERS:
            assert getattr(b.stats, f) == getattr(a.stats, f), f
        # one launch a segment produced, each synced
        assert b.stats.kernel_launches == b.stats.segments_produced


def test_drivers_on_explicit_equal_the_reference():
    ref, port = _pres("grid9")
    rank = total_order(port.smesh.scalars)
    a = ref_explicit.ExplicitTriangulation(ref, RELS)
    b = explicit.ExplicitTriangulation(port, RELS, device="cpu")
    ga = ref_discrete_gradient(a, ref, rank, co_prefetch=("TT",))
    gb = discrete_gradient(b, port, rank, co_prefetch=("TT",))
    assert _digest(gb) == _digest(ga)
    assert gb.euler() == ga.euler()
    ma, mb = ref_morse_smale(a, ref, ga), morse_smale(b, port, gb)
    assert _digest(mb) == _digest(ma)
    da = ref_persistence_pairs(a, ref, rank, grad=ga)
    db = persistence_pairs(b, port, rank, grad=gb)
    assert db.digest() == da.digest() and db.counts() == da.counts()
    # the host consumer arm and the completion through explicit rows
    gh = discrete_gradient(b, port, rank, consumer="host")
    assert _digest(gh) == _digest(ga)
    assert b.merged_worker_stats() == b.stats


@pytest.mark.parametrize("name", ["toy", "graded"])
def test_analyze_mesh_rows_equal_the_reference_drivers(name):
    h, rows = analyze_mesh.run(name, device="cpu", simplify=0.05)
    mesh = ref_meshgen.load_dataset(
        name, scalar_fn=ref_fields.gaussians(2, k=5, sigma=5.0))
    sm = ref_segment_mesh(mesh, 64)
    pre = ref_precondition(sm, RELS)
    rank = total_order(sm.scalars)
    ex = ref_explicit.ExplicitTriangulation(pre, RELS)
    _, cp = ref_critical_points(ex, pre, rank, batch_segments=16)
    g = ref_discrete_gradient(ex, pre, rank, batch_segments=16,
                              co_prefetch=("TT",))
    ms = ref_morse_smale(ex, pre, g)
    d = ref_persistence_pairs(ex, pre, rank, grad=g)
    assert h["chi"] == sm.n_vertices - pre.n_edges + pre.n_faces - sm.n_tets
    for label in ("GALE", "Explicit"):
        r = rows[label]
        assert r["critical"] == cp and r["gradient"] == g.counts()
        assert r["ms"] == ms.counts() and r["euler"] == g.euler()
        assert r["persistence"] == d.counts() and r["digest"] == d.digest()


def test_analyze_mesh_cli_and_unported_shards(capsys):
    analyze_mesh.main(["toy", "--device", "cpu", "--simplify", "0.1"])
    out = capsys.readouterr().out
    assert "[GALE     ]" in out and "[Explicit ]" in out
    assert "simplified @ 0.1" in out
    # --shards splits the GALE engine; every result line stays the same
    analyze_mesh.main(["toy", "--device", "cpu", "--simplify", "0.1",
                       "--shards", "2"])
    sharded = capsys.readouterr().out

    def results(text):
        return [ln.split("s  ", 1)[-1] for ln in text.splitlines()
                if "t_sync" not in ln]

    assert results(sharded) == results(out)


def test_structures_run_on_cuda_unless_asked_and_raise_without_a_card(
        monkeypatch):
    _, port = _pres("toy")
    monkeypatch.setattr(explicit.torch.cuda, "is_available", lambda: False)
    for make in (lambda: explicit.ExplicitTriangulation(port, ["VV"]),
                 lambda: explicit.TopoClusterDS(port, ["VV"]),
                 lambda: explicit.ActopoDS(port, ["VV"])):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    assert explicit.ActopoDS(port, ["VV"], device="cpu").device.type == "cpu"
