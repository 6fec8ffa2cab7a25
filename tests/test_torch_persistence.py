"""The port's persistence pairing and Morse–Smale simplification against
the reference's, on the CPU: ``PersistenceDiagram`` (every array, and
``digest()``) on the six adversarial mesh families of the reference's
persistence tests, under both pairing methods, both consumer arms, 1 and 4
workers and the completed-TT and FT-gather routes; ``simplify_ms``
survivors and reports. Meshes are built by each package's own generators
from the same arguments; every comparison is exact."""

import dataclasses

import numpy as np
import pytest

from repro.algorithms import fields as ref_fields
from repro.algorithms.discrete_gradient import \
    discrete_gradient as ref_discrete_gradient
from repro.algorithms.morse_smale import morse_smale as ref_morse_smale
from repro.algorithms.persistence import \
    persistence_pairs as ref_persistence_pairs
from repro.algorithms.persistence import simplify_ms as ref_simplify_ms
from repro.core.engine import RelationEngine as RefEngine
from repro.core.mesh import segment_mesh as ref_segment_mesh
from repro.core.segtables import precondition as ref_precondition
from repro.data import meshgen as ref_meshgen
from repro_torch.algorithms import fields
from repro_torch.algorithms.critical_points import total_order
from repro_torch.algorithms.discrete_gradient import discrete_gradient
from repro_torch.algorithms.morse_smale import morse_smale
from repro_torch.algorithms.persistence import PersistenceDiagram, \
    persistence_pairs, simplify_ms
from repro_torch.core.engine import RelationEngine
from repro_torch.core.mesh import segment_mesh
from repro_torch.core.segtables import precondition
from repro_torch.data import meshgen

RELS = ["VE", "VF", "VT", "FT", "TT"]

# the reference persistence tests' 7-point double-well profile
_YS = [9.0, 1.0, 6.0, 0.0, 8.0, 2.0, 10.0]


def _wells(fld, extent, axis=0):
    xs = np.linspace(0.0, float(extent), len(_YS))
    return fld.axis_profile(xs, _YS, axis=axis)


# the six families of tests/test_persistence.py, built by either package
FAMILIES = {
    "bar_wells": lambda g, f: g.structured_grid(
        25, 4, 4, scalar_fn=_wells(f, 24)),
    "graded_wells": lambda g, f: g.graded_grid(
        24, 6, 6, ratio=8.0, scalar_fn=_wells(f, 23)),
    "sliver_wells": lambda g, f: g.anisotropic_grid(
        8, 25, 6, aspect=(1.0, 1.0, 0.08), shear=0.35,
        scalar_fn=_wells(f, 24, axis=1)),
    "tunnel_wells": lambda g, f: g.multi_component(
        1, 10, 10, 12, hole="tunnel", scalar_fn=_wells(f, 11, axis=2)),
    "pocket_wells": lambda g, f: g.multi_component(
        2, 9, 9, 9, hole="cavity",
        scalar_fn=_wells(f, 2 * g.component_stride(9))),
    "archipelago_wells": lambda g, f: g.multi_component(
        3, 7, 6, 6, scalar_fn=_wells(f, 3 * g.component_stride(7))),
}

_REF = {}


def _reference(name):
    """The reference's diagram (pairing arm, device consumer arm, TT
    route) for one family, computed once."""
    if name not in _REF:
        sm = ref_segment_mesh(FAMILIES[name](ref_meshgen, ref_fields), 48)
        pre = ref_precondition(sm, RELS)
        eng = RefEngine(pre, RELS, tune="off")
        _REF[name] = ref_persistence_pairs(eng, pre, total_order(sm.scalars))
    return _REF[name]


_FIELDS = [f.name for f in dataclasses.fields(PersistenceDiagram)
           if f.name != "method"]


@pytest.mark.parametrize("name,method,consumer,workers,adjacency", [
    ("bar_wells", "pairing", "device", 1, "auto"),
    ("bar_wells", "reduction", "host", 4, "ft"),
    ("graded_wells", "pairing", "host", 1, "tt"),
    ("graded_wells", "reduction", "device", 4, "auto"),
    ("sliver_wells", "pairing", "device", 4, "ft"),
    ("sliver_wells", "reduction", "host", 1, "tt"),
    ("tunnel_wells", "pairing", "host", 4, "auto"),
    ("tunnel_wells", "reduction", "device", 1, "ft"),
    ("pocket_wells", "pairing", "device", 1, "tt"),
    ("pocket_wells", "reduction", "host", 4, "auto"),
    ("archipelago_wells", "pairing", "host", 1, "ft"),
    ("archipelago_wells", "reduction", "device", 4, "tt"),
])
def test_diagram_equals_the_reference(name, method, consumer, workers,
                                      adjacency):
    want = _reference(name)
    sm = segment_mesh(FAMILIES[name](meshgen, fields), 48)
    pre = precondition(sm, RELS)
    eng = RelationEngine(pre, RELS, device="cpu")
    d = persistence_pairs(eng, pre, total_order(sm.scalars), method=method,
                          consumer=consumer, workers=workers,
                          adjacency=adjacency)
    assert d.method == method
    assert d.digest() == want.digest(), name
    for f in _FIELDS:
        if f.startswith("merge_into") and method == "reduction":
            # the reduction oracle records no merge ancestry
            assert (getattr(d, f) == -1).all()
            continue
        np.testing.assert_array_equal(getattr(d, f), getattr(want, f),
                                      err_msg=f)
    assert d.counts() == want.counts()
    if adjacency == "ft":
        assert eng.stats.completion_queries == 0


# -- simplify_ms on a bumpy field ----------------------------------------------

def _bumpy(gen, fld):
    return gen.structured_grid(12, 12, 10, scalar_fn=fld.gaussians(
        2, k=5, sigma=3.0, scale=12.0))


@pytest.fixture(scope="module")
def bumpy():
    sm = ref_segment_mesh(_bumpy(ref_meshgen, ref_fields), 48)
    pre = ref_precondition(sm, RELS)
    eng = RefEngine(pre, RELS, tune="off")
    rank = total_order(sm.scalars)
    g = ref_discrete_gradient(eng, pre, rank)
    want_ms = ref_morse_smale(eng, pre, g)
    want_d = ref_persistence_pairs(eng, pre, rank, grad=g)

    sm = segment_mesh(_bumpy(meshgen, fields), 48)
    pre = precondition(sm, RELS)
    eng = RelationEngine(pre, RELS, device="cpu")
    g = discrete_gradient(eng, pre, rank)
    ms = morse_smale(eng, pre, g)
    d = persistence_pairs(eng, pre, rank, grad=g)
    return (want_ms, want_d), (ms, d), (eng, pre, rank, g)


@pytest.mark.parametrize("where", ["zero", "median", "above_max"])
def test_simplify_equals_the_reference(bumpy, where):
    (want_ms, want_d), (ms, d), _ = bumpy
    assert d.digest() == want_d.digest()
    pers = want_d.persistence0()
    thr = {"zero": 0.0, "median": float(np.median(pers)),
           "above_max": float(pers.max()) + 1.0}[where]
    want_simp, want_rep = ref_simplify_ms(want_ms, want_d, thr)
    simp, rep = simplify_ms(ms, d, thr)
    assert rep == want_rep
    for f in ("dest_min", "dest_max", "saddle1_ends", "saddle2_ends"):
        np.testing.assert_array_equal(getattr(simp, f),
                                      getattr(want_simp, f), err_msg=f)
    # the survivor invariant: surviving minima are exactly the pairs at or
    # above the threshold and the essential minima
    keep = set(d.pairs0[d.persistence0() >= thr, 0].tolist()) \
        | set(d.essential0.tolist())
    assert set(np.unique(simp.dest_min).tolist()) == keep


def test_simplify_and_pairing_checks(bumpy):
    _, (ms, _), (eng, pre, rank, g) = bumpy
    red = persistence_pairs(eng, pre, rank, grad=g, method="reduction")
    with pytest.raises(ValueError, match="pairing"):
        simplify_ms(ms, red, 0.5)
    with pytest.raises(ValueError, match="method"):
        persistence_pairs(eng, pre, rank, grad=g, method="euler")
    with pytest.raises(ValueError, match="shards=2"):
        persistence_pairs(eng, pre, rank, grad=g, shards=2)
