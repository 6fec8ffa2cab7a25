"""The port's critical-points path against the reference's, end to end on
the CPU: per-vertex ``types`` equal element for element on the quickstart
mesh, ``fish`` and ``bar`` (both consumer arms, 1 and 4 workers); the
quickstart's counts and launch totals; and the precondition state carried
across packages through ``segtables.from_arrays``."""

import dataclasses

import numpy as np
import pytest

from repro.algorithms import fields as ref_fields
from repro.algorithms.critical_points import \
    critical_points as ref_critical_points
from repro.core.engine import RelationEngine as RefEngine
from repro.core.mesh import segment_mesh as ref_segment_mesh
from repro.core.segtables import precondition as ref_precondition
from repro.data import meshgen as ref_meshgen
from repro_torch import quickstart
from repro_torch.algorithms import fields
from repro_torch.algorithms.critical_points import critical_points, \
    total_order
from repro_torch.core.engine import RelationEngine
from repro_torch.core.mesh import segment_mesh
from repro_torch.core.segtables import from_arrays, precondition
from repro_torch.data import meshgen

QUICKSTART_COUNTS = {"minima": 3, "saddles1": 4, "saddles2": 1, "maxima": 2,
                     "degenerate": 0, "regular": 1718}


def _mesh(gen, fld, name):
    if name == "quickstart":
        return gen.structured_grid(
            12, 12, 12, scalar_fn=fld.gaussians(0, k=4, sigma=3.0, scale=12))
    return gen.load_dataset(name, scalar_fn=fld.gaussians(
        2, k=5, sigma=3.0, scale=16))


_REF = {}


def _reference(name):
    """Reference types (xla arm) for one dataset, computed once."""
    if name not in _REF:
        sm = ref_segment_mesh(_mesh(ref_meshgen, ref_fields, name), 64)
        pre = ref_precondition(sm, ["VV", "VT"])
        eng = RefEngine(pre, ["VV", "VT"], lookahead=8, tune="off")
        types, counts = ref_critical_points(eng, pre, total_order(sm.scalars))
        _REF[name] = (pre, types, counts, eng.stats)
    return _REF[name]


@pytest.mark.parametrize("consumer", ["device", "host"])
@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("name", ["quickstart", "fish", "bar"])
def test_types_equal_the_reference(name, workers, consumer):
    _, want, want_counts, _ = _reference(name)
    sm = segment_mesh(_mesh(meshgen, fields, name), 64)
    pre = precondition(sm, ["VV", "VT"])
    eng = RelationEngine(pre, ["VV", "VT"], lookahead=8, device="cpu")
    types, counts = critical_points(eng, pre, total_order(sm.scalars),
                                    consumer=consumer, workers=workers)
    np.testing.assert_array_equal(types, want)
    assert counts == want_counts
    assert eng.merged_worker_stats() == eng.stats
    assert eng.stats.segments_produced == 2 * sm.n_segments


def test_quickstart_counts_and_launches(capsys):
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "mesh: 1728 vertices, 7986 tets" in out
    assert f"critical points: {QUICKSTART_COUNTS}" in out
    assert "engine: 4 launches for 54 segments produced, 54 hits / 0 misses" \
        in out
    _, _, counts, stats = _reference("quickstart")
    assert counts == QUICKSTART_COUNTS
    assert (stats.kernel_launches, stats.segments_produced) == (4, 54)


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def test_state_carried_across_packages():
    ref_pre, want, _, _ = _reference("fish")
    # the port's own precondition builds the reference's arrays
    sm = segment_mesh(_mesh(meshgen, fields, "fish"), 64)
    pre = precondition(sm, ["VV", "VT"])
    for a, b in ((_fields(ref_pre.smesh), _fields(pre.smesh)),
                 ({k: v for k, v in _fields(ref_pre.tables).items()
                   if k != "inverse"},
                  {k: v for k, v in _fields(pre.tables).items()
                   if k != "inverse"})):
        assert a.keys() == b.keys()
        for k in a:
            if a[k] is None:
                assert b[k] is None, k
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for kind, (keys, rows, n) in ref_pre.tables.inverse.items():
        pk, pr, pn = pre.tables.inverse[kind]
        np.testing.assert_array_equal(keys, pk)
        np.testing.assert_array_equal(rows, pr)
        assert n == pn
    # tables handed over as plain numpy fields give the same result
    arrays = {**_fields(ref_pre.smesh), **_fields(ref_pre.tables)}
    arrays.pop("inverse")
    carried = from_arrays(arrays)
    eng = RelationEngine(carried, ["VV", "VT"], device="cpu")
    types, _ = critical_points(eng, carried,
                               total_order(carried.smesh.scalars))
    np.testing.assert_array_equal(types, want)


def test_flag_boundary_is_not_ported_yet():
    # flag_boundary is ported (held against the reference in
    # tests/test_torch_completion.py); it needs TT completion, so an engine
    # without TT in its relation set refuses it, naming TT
    sm = segment_mesh(meshgen.structured_grid(3, 3, 3), 16)
    pre = precondition(sm, ["VV", "VT"])
    eng = RelationEngine(pre, ["VV", "VT"], device="cpu")
    with pytest.raises(ValueError, match="'TT'"):
        critical_points(eng, pre, total_order(sm.scalars),
                        flag_boundary=True)
