"""The port's discrete gradient and Morse–Smale complex against the
reference's, end to end on the CPU: every ``GradientField`` array, its
Euler characteristic and every ``MSComplex`` field equal element for
element on the quickstart mesh, ``fish`` and ``bar``, over both consumer
arms, 1 and 4 workers, and the completed-TT and FT-gather successor routes;
and the counts ``python -m repro_torch.analyze --device cpu`` prints."""

import dataclasses

import numpy as np
import pytest

from repro.algorithms import fields as ref_fields
from repro.algorithms.discrete_gradient import \
    discrete_gradient as ref_discrete_gradient
from repro.algorithms.morse_smale import morse_smale as ref_morse_smale
from repro.core.engine import RelationEngine as RefEngine
from repro.core.mesh import segment_mesh as ref_segment_mesh
from repro.core.segtables import precondition as ref_precondition
from repro.data import meshgen as ref_meshgen
from repro_torch import analyze
from repro_torch.algorithms import fields
from repro_torch.algorithms.critical_points import total_order
from repro_torch.algorithms.discrete_gradient import discrete_gradient
from repro_torch.algorithms.morse_smale import morse_smale
from repro_torch.core.engine import RelationEngine
from repro_torch.core.mesh import segment_mesh
from repro_torch.core.segtables import precondition
from repro_torch.data import meshgen

RELS = ["VE", "VF", "VT", "FT", "TT"]

# python -m repro_torch.analyze --device cpu (the quickstart mesh at 12^3),
# equal to the reference's counts on the same mesh
ANALYZE_COUNTS = {
    "gradient": {"crit_v": 3, "crit_e": 4, "crit_f": 3, "crit_t": 1},
    "morse-smale": {"saddle1": 4, "saddle2": 3, "basins_min": 3,
                    "basins_max": 1, "arcs": 4},
}


def _mesh(gen, fld, name):
    if name == "quickstart":
        return gen.structured_grid(
            12, 12, 12, scalar_fn=fld.gaussians(0, k=4, sigma=3.0, scale=12))
    return gen.load_dataset(name, scalar_fn=fld.gaussians(
        2, k=5, sigma=3.0, scale=16))


_REF = {}


def _reference(name):
    """The reference's field and complex (xla arm, device consumer arm, TT
    route) for one dataset, computed once."""
    if name not in _REF:
        sm = ref_segment_mesh(_mesh(ref_meshgen, ref_fields, name), 64)
        pre = ref_precondition(sm, RELS)
        eng = RefEngine(pre, RELS, lookahead=8, tune="off")
        rank = total_order(sm.scalars)
        g = ref_discrete_gradient(eng, pre, rank, co_prefetch=("TT",))
        ms = ref_morse_smale(eng, pre, g)
        chi = sm.n_vertices - pre.n_edges + pre.n_faces - sm.n_tets
        _REF[name] = (g, ms, chi)
    return _REF[name]


def _assert_fields_equal(got, want):
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name), err_msg=f.name)


@pytest.mark.parametrize("name,consumer,workers,adjacency", [
    ("quickstart", "device", 1, "tt"),
    ("quickstart", "host", 4, "ft"),
    ("quickstart", "device", 4, "ft"),
    ("fish", "device", 4, "tt"),
    ("fish", "host", 1, "ft"),
    ("bar", "host", 1, "tt"),
    ("bar", "device", 4, "ft"),
])
def test_gradient_and_complex_equal_the_reference(name, consumer, workers,
                                                  adjacency):
    want_g, want_ms, chi = _reference(name)
    sm = segment_mesh(_mesh(meshgen, fields, name), 64)
    pre = precondition(sm, RELS)
    eng = RelationEngine(pre, RELS, lookahead=8, device="cpu")
    rank = total_order(sm.scalars)
    g = discrete_gradient(eng, pre, rank, batch_segments=16,
                          co_prefetch=("TT",), consumer=consumer,
                          workers=workers)
    _assert_fields_equal(g, want_g)
    assert g.euler() == want_g.euler() == chi
    ms = morse_smale(eng, pre, g, adjacency=adjacency, consumer=consumer,
                     workers=workers)
    _assert_fields_equal(ms, want_ms)
    assert ms.counts() == want_ms.counts()
    assert eng.merged_worker_stats() == eng.stats
    if adjacency == "tt":
        assert eng.stats.completion_queries == int((g.pair_t2f >= 0).sum())


def test_analyze_counts(capsys):
    analyze.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "mesh: v=1728 e=10439 f=16698 t=7986 chi=1" in out
    assert f"gradient: {ANALYZE_COUNTS['gradient']} euler: 1" in out
    assert f"morse-smale: {ANALYZE_COUNTS['morse-smale']}" in out
    want_g, want_ms, _ = _reference("quickstart")
    assert want_g.counts() == ANALYZE_COUNTS["gradient"]
    assert want_ms.counts() == ANALYZE_COUNTS["morse-smale"]


def test_unported_options_raise():
    sm = segment_mesh(meshgen.structured_grid(3, 3, 3), 16)
    pre = precondition(sm, RELS)
    eng = RelationEngine(pre, RELS, device="cpu")
    rank = total_order(sm.scalars)
    # shards= validates against the engine's plan (one shard here)
    with pytest.raises(ValueError, match="shards=2"):
        discrete_gradient(eng, pre, rank, shards=2)
    g = discrete_gradient(eng, pre, rank, shards=1)
    with pytest.raises(ValueError, match="shards=4"):
        morse_smale(eng, pre, g, shards=4)
