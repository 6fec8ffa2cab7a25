"""The port's dense counts fallback, and the gradient audit that runs it,
against the reference's: the meet and
VV counts (the plain versions the CUDA kernels ``meet_counts_kernel`` and
``vv_counts_kernel`` are held against) against the reference's
``_counts_pairwise``, ``ref.relation_counts_*`` and its Pallas kernels in
interpret mode; the relation blocks of every relation under
``assembly="dense"``, EE/FF under the default and oversize keys, against
the reference's fused ``xla`` arm; the engine's EE/FF blocks, EE/FF
completion on the host, device and scalar-oracle arms with the completion
stats; the critical-points path under ``assembly="dense"``; the audit
report of ``audit_gradient`` (FF completion) on a clean and a corrupted
field; and what ``python -m repro_torch.analyze --device cpu --audit
--persistence 0.5`` prints. Inputs are made with numpy from a seed and
handed to both packages; every comparison is exact."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro.algorithms import fields as ref_fields
from repro.algorithms.critical_points import \
    critical_points as ref_critical_points
from repro.algorithms.discrete_gradient import \
    audit_gradient as ref_audit_gradient
from repro.algorithms.discrete_gradient import \
    discrete_gradient as ref_discrete_gradient
from repro.core.adjacency import complete_adjacency as ref_complete
from repro.core.engine import RelationEngine as RefEngine
from repro.core.mesh import segment_mesh as ref_segment_mesh
from repro.core.segtables import precondition as ref_precondition
from repro.data import meshgen as ref_meshgen
from repro.data.meshgen import structured_grid as ref_structured_grid
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_counts
from repro.kernels.segment_relations import relation_counts_meet_pallas, \
    relation_counts_vv_pallas
from repro_torch import analyze
from repro_torch.algorithms import fields
from repro_torch.algorithms.critical_points import critical_points, \
    total_order
from repro_torch.algorithms.discrete_gradient import audit_gradient, \
    discrete_gradient
from repro_torch.core.adjacency import complete_adjacency, \
    complete_adjacency_scalar
from repro_torch.core.engine import RelationEngine
from repro_torch.core.mesh import segment_mesh
from repro_torch.core.segtables import precondition
from repro_torch.data import meshgen
from repro_torch.data.meshgen import structured_grid
from repro_torch.kernels import ops, segment_relations

ALL_RELATIONS = ("VV", "VE", "VF", "VT", "EF", "ET", "FT", "EE", "FF", "TT")
_ARITY = {"V": 1, "E": 2, "F": 3, "T": 4}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_equal(got, want):
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _simplices(rng, B, N, arity, nvl, fill=0.8):
    """(B, N, arity) int32 rows of distinct local vertices < nvl in random
    order, the last rows -1 padding."""
    tab = np.full((B, N, arity), -1, dtype=np.int32)
    n = max(1, int(N * fill)) if N else 0
    for b in range(B):
        tab[b, :n] = np.argsort(rng.random((n, nvl)), axis=1)[:, :arity]
    return tab


def _distinct_simplices(rng, B, N, arity, nvl, fill=0.8):
    """As :func:`_simplices`, with no two rows of one segment spanning the
    same vertices (as a mesh's local tables list each simplex once: the
    sparse arms' precondition)."""
    combos = np.array(list(itertools.combinations(range(nvl), arity)),
                      dtype=np.int32)
    tab = np.full((B, N, arity), -1, dtype=np.int32)
    n = max(1, int(N * fill))
    for b in range(B):
        rows = combos[rng.choice(len(combos), n, replace=False)]
        tab[b, :n] = rng.permuted(rows, axis=1)
    return tab


def _colg(rng, tab):
    c = rng.integers(0, 10 ** 6, tab.shape[:2]).astype(np.int32)
    c[(tab < 0).all(-1)] = -1
    return c


# -- counts ------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 127])
def test_meet_counts_equal_the_reference(n):
    rng = np.random.default_rng(n)
    nvl = 11
    for ax, ay in ((1, 4), (2, 2), (3, 3), (3, 4), (4, 4)):
        tx = _simplices(rng, 2, n, ax, nvl)
        ty = _simplices(rng, 2, n + 2, ay, nvl)
        got = ops.counts_meet(_t(tx), _t(ty))
        assert got.dtype == torch.int32 and got.shape == (2, n, n + 2)
        _assert_equal(got, ref_ops._counts_pairwise(tx, ty))
        # the one-hot contract: equal for rows of distinct local vertices
        _assert_equal(got, ref_counts.relation_counts_meet(tx, ty, nvl))
        _assert_equal(ops.counts_meet(_t(tx), _t(ty), backend="torch"), got)
    # a vertex id past nvl still counts: C does not depend on nvl
    x = np.array([[[40, -1]]], np.int32)
    y = np.array([[[-1, 40, 3]]], np.int32)
    assert int(ops.counts_meet(_t(x), _t(y))[0, 0, 0]) == 1
    # -1 slots never meet
    m = np.full((1, 2, 3), -1, np.int32)
    assert int(ops.counts_meet(_t(m), _t(m)).abs().sum()) == 0


def test_meet_counts_equal_the_pallas_kernel():
    # one shape: interpret mode compiles once per shape
    rng = np.random.default_rng(5)
    nvl = 29
    tx = _simplices(rng, 2, 37, 3, nvl)
    ty = _simplices(rng, 2, 53, 4, nvl)
    want = relation_counts_meet_pallas(
        np.swapaxes(tx, 1, 2), np.swapaxes(ty, 1, 2), nvl=nvl,
        interpret=True)
    _assert_equal(ops.counts_meet(_t(tx), _t(ty)), want)
    assert int(np.asarray(want).max()) == 3


@pytest.mark.parametrize("n", [1, 7, 127])
def test_vv_counts_equal_the_reference(n):
    rng = np.random.default_rng(10 + n)
    for nvl in (5, 31):
        tt = _simplices(rng, 3, n, 4, nvl)
        got = ops.counts_vv(_t(tt), nvl)
        assert got.dtype == torch.int32 and got.shape == (3, nvl, nvl)
        want = ref_counts.relation_counts_vv(tt, nvl)
        _assert_equal(got, want)
        _assert_equal(got, ref_ops._counts_vv_host(tt, nvl))
        # the diagonal counts the tets containing each vertex
        deg = np.stack([np.bincount(t[t >= 0], minlength=nvl) for t in tt])
        np.testing.assert_array_equal(
            np.diagonal(got.numpy(), axis1=1, axis2=2), deg)


def test_vv_counts_equal_the_pallas_kernel():
    rng = np.random.default_rng(6)
    nvl = 41
    tt = _simplices(rng, 2, 97, 4, nvl)
    want = relation_counts_vv_pallas(np.swapaxes(tt, 1, 2), nvl=nvl,
                                     interpret=True)
    _assert_equal(ops.counts_vv(_t(tt), nvl), want)


def test_count_kernels_need_cuda_tensors():
    t = torch.zeros((1, 4, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        segment_relations.relation_counts_meet_cuda(t, t)
    with pytest.raises(ValueError, match="CUDA tensor"):
        segment_relations.relation_counts_vv_cuda(
            torch.zeros((1, 4, 4), dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="CUDA"):
        ops.counts_meet(t, t, backend="cuda")
    with pytest.raises(ValueError, match="assembly"):
        ops.relation_block("FF", t, t, torch.zeros((1, 4), dtype=torch.int32),
                           8, assembly="onehot")
    assert segment_relations.LAUNCHES["meet"] == 0
    assert segment_relations.LAUNCHES["vv_counts"] == 0


# -- relation blocks -----------------------------------------------------------

def _relation_inputs(rng, relation, nvl, n, B=2):
    kx, ky = relation
    if relation == "VV":
        tt = _distinct_simplices(rng, B, n, 4, nvl)
        return tt, tt, _colg(rng, np.zeros((B, nvl, 1)))
    if kx == "V":
        tx = np.broadcast_to(np.arange(nvl, dtype=np.int32)[None, :, None],
                             (B, nvl, 1)).copy()
    else:
        tx = _distinct_simplices(rng, B, n, _ARITY[kx], nvl)
    ty = tx if kx == ky else \
        _distinct_simplices(rng, B, n + 3, _ARITY[ky], nvl)
    return tx, ty, _colg(rng, ty)


@pytest.mark.parametrize("relation", ALL_RELATIONS)
def test_dense_assembly_blocks_equal_the_reference(relation):
    rng = np.random.default_rng(sum(map(ord, relation)))
    nvl = 8                   # few vertices: rows meet often
    tx, ty, colg = _relation_inputs(rng, relation, nvl, 19)
    full = ref_ops.relation_block(relation, tx, ty, colg, nvl,
                                  backend="xla", assembly="dense")
    top = int(np.asarray(full[1]).max())
    assert top > 1
    for deg in (None, top - 1):               # top - 1 truncates a row
        want = ref_ops.relation_block(relation, tx, ty, colg, nvl, deg=deg,
                                      backend="xla", assembly="dense")
        got = ops.relation_block(relation, _t(tx), _t(ty), _t(colg), nvl,
                                 deg=deg, assembly="dense")
        _assert_equal(got, want)
        if relation == "TT":
            # random tets put a face in more than two tets, which the TT
            # sort join does not take (test_torch_relations covers it on
            # mesh tables)
            continue
        # the default fork (EE/FF dense, the others sparse) in both
        _assert_equal(
            ops.relation_block(relation, _t(tx), _t(ty), _t(colg), nvl,
                               deg=deg),
            ref_ops.relation_block(relation, tx, ty, colg, nvl, deg=deg,
                                   backend="xla"))


def test_narrow_tables_pad_past_their_width():
    # N < deg: M right-pads with -1 past the table's width
    rng = np.random.default_rng(3)
    tx, ty, colg = _relation_inputs(rng, "FF", 7, 5)
    want = ref_ops.relation_block("FF", tx, ty, colg, 7, backend="xla")
    got = ops.relation_block("FF", _t(tx), _t(ty), _t(colg), 7)
    assert got[0].shape[2] == ops.DEFAULT_DEG["FF"] > tx.shape[1]
    _assert_equal(got, want)


@pytest.mark.parametrize("relation", ["TT", "FT"])
def test_oversize_keys_take_the_dense_fork(relation):
    rng = np.random.default_rng(17)
    nvl = 2 ** 11                       # TT nvl**3, FT nvl**3 * 2 > 2**31
    tx, ty, colg = _relation_inputs(rng, relation, 40, 23)
    relabel = rng.permutation(nvl)[:40].astype(np.int32)
    tx = np.where(tx >= 0, relabel[np.maximum(tx, 0)], -1).astype(np.int32)
    ty = tx if relation == "TT" else \
        np.where(ty >= 0, relabel[np.maximum(ty, 0)], -1).astype(np.int32)
    assert not ops.sparse_arm_ok(relation, _t(tx), _t(ty), nvl)
    assert not ref_ops.sparse_arm_ok(relation, tx, ty, nvl)
    want = ref_ops.relation_block(relation, tx, ty, colg, nvl, backend="xla")
    got = ops.relation_block(relation, _t(tx), _t(ty), _t(colg), nvl)
    _assert_equal(got, want)


# -- the engine: EE/FF blocks and completion ---------------------------------

ENG_RELS = ["VV", "VT", "EE", "FF", "TT"]


def _grid(gen, fld):
    return gen(6, 5, 5, scalar_fn=fld.gaussians(4, k=3, sigma=2.0, scale=6))


@pytest.fixture(scope="module")
def meshes():
    ref_pre = ref_precondition(ref_segment_mesh(
        _grid(ref_structured_grid, ref_fields), capacity=16), ENG_RELS)
    pre = precondition(segment_mesh(_grid(structured_grid, fields),
                                    capacity=16), ENG_RELS)
    return ref_pre, pre


def test_engine_blocks_equal_the_reference(meshes):
    ref_pre, pre = meshes
    ns = pre.smesh.n_segments
    for assembly in ("sparse", "dense"):
        ref = RefEngine(ref_pre, ENG_RELS, tune="off", lookahead=2,
                        batch_max=4, assembly=assembly)
        eng = RelationEngine(pre, ENG_RELS, device="cpu", lookahead=2,
                             batch_max=4, assembly=assembly)
        assert eng.assembly == assembly
        for relation in ENG_RELS:
            for s in (0, ns // 2, ns - 1):
                for a, b in zip(ref.get_full(relation, s),
                                eng.get_full(relation, s)):
                    np.testing.assert_array_equal(a, b)
        for f in ("requests", "kernel_launches", "segments_produced"):
            assert getattr(eng.stats, f) == getattr(ref.stats, f), f
    # the E and F device inverse maps are staged for EE/FF completion
    for kind in "EF":
        seg, gid, row, _, _ = eng.dev_inverse(kind)
        assert len(seg) == len(gid) == len(row) > 0
    assert eng.dev_inverse("E")[4] == pre.n_edges
    with pytest.raises(ValueError, match="assembly"):
        RelationEngine(pre, ENG_RELS, device="cpu", assembly="onehot")


STATS = ("completion_queries", "completion_fanout_blocks",
         "completion_raw_neighbors", "completion_neighbors")


@pytest.mark.parametrize("relation,batch,workers", [
    ("EE", None, 1), ("EE", 83, 3), ("FF", None, 1), ("FF", 131, 3)])
def test_complete_ee_ff_equals_the_reference(meshes, relation, batch,
                                             workers):
    ref_pre, pre = meshes
    n = pre.n_edges if relation == "EE" else pre.n_faces
    ids = np.random.default_rng(len(relation) + (batch or 0)) \
        .permutation(n)[:400]
    ref = RefEngine(ref_pre, [relation], tune="off")
    want_M, want_L = ref_complete(ref, relation, ids, batch=batch,
                                  workers=workers)
    assert want_L.max() > 0
    for path, out in (("host", "host"), ("device", "host"),
                      ("device", "dev")):
        eng = RelationEngine(pre, [relation], device="cpu")
        M, L = complete_adjacency(eng, relation, ids, batch=batch,
                                  path=path, out=out, workers=workers)
        if out == "dev":
            assert M.shape[1] == ops.DEFAULT_DEG[relation]
            assert (M[:, want_M.shape[1]:] == -1).all()
            M, L = M[:, :want_M.shape[1]].numpy(), L.numpy()
        np.testing.assert_array_equal(M, want_M)
        np.testing.assert_array_equal(L, want_L)
        for f in STATS:
            assert getattr(eng.stats, f) == getattr(ref.stats, f), (path, f)
        assert eng.merged_worker_stats() == eng.stats
    sM, sL = complete_adjacency_scalar(
        RelationEngine(pre, [relation], device="cpu"), relation, ids[:60])
    np.testing.assert_array_equal(sM, want_M[:60, :sM.shape[1]])
    np.testing.assert_array_equal(sL, want_L[:60])


# -- the critical-points path under assembly="dense" -------------------------

def test_dense_critical_points_equal_the_reference(meshes):
    ref_pre, pre = meshes
    rank = total_order(pre.smesh.scalars)
    ref = RefEngine(ref_pre, ["VV", "VT"], tune="off", assembly="dense")
    want_types, want = ref_critical_points(ref, ref_pre, rank)
    eng = RelationEngine(pre, ["VV", "VT"], device="cpu", assembly="dense")
    types, counts = critical_points(eng, pre, rank)
    assert counts == want
    np.testing.assert_array_equal(types, want_types)
    sparse = RelationEngine(pre, ["VV", "VT"], device="cpu")
    np.testing.assert_array_equal(critical_points(sparse, pre, rank)[0],
                                  types)


# -- the gradient audit ------------------------------------------------------

AUDIT_RELS = ["VE", "VF", "VT", "FT", "TT", "FF"]


def _audit_mesh(gen, fld):
    return gen.structured_grid(8, 8, 7, jitter=0.15, seed=5,
                               scalar_fn=fld.gaussians(0, k=4, sigma=3.0,
                                                       scale=8))


def _corrupt(grad, ds, sites):
    """Double claims at seeded sites: a tet claims a face another tet is
    paired with (TT check), a face an edge another face is paired with
    (FF check)."""
    rng = np.random.default_rng(1)
    bad = dataclasses.replace(grad, pair_t2f=grad.pair_t2f.copy(),
                              pair_f2e=grad.pair_f2e.copy())
    for owner, claimed, boundary in (
            (bad.pair_t2f, grad.pair_f2t, ds.boundary_TF),
            (bad.pair_f2e, grad.pair_e2f, ds.boundary_FE)):
        done = 0
        for c in rng.permutation(len(owner)):
            if done == sites:
                break
            for s in boundary([c])[0]:
                if claimed[s] >= 0 and claimed[s] != c and owner[c] != s:
                    owner[c] = s
                    done += 1
                    break
    return bad


@pytest.fixture(scope="module")
def audited():
    sm = ref_segment_mesh(_audit_mesh(ref_meshgen, ref_fields), 24)
    ref_pre = ref_precondition(sm, AUDIT_RELS)
    ref = RefEngine(ref_pre, AUDIT_RELS, tune="off", cache_segments=4096)
    rank = total_order(sm.scalars)
    ref_g = ref_discrete_gradient(ref, ref_pre, rank)
    pre = precondition(segment_mesh(_audit_mesh(meshgen, fields), 24),
                       AUDIT_RELS)
    return ref, ref_pre, ref_g, pre, rank


@pytest.mark.parametrize("sites", [0, 1, 5])
def test_audit_equals_the_reference(audited, sites):
    ref, ref_pre, ref_g, pre, rank = audited
    eng = RelationEngine(pre, AUDIT_RELS, device="cpu")
    g = discrete_gradient(eng, pre, rank, audit=True)   # clean: no raise
    assert g.counts() == ref_g.counts()
    want = ref_audit_gradient(ref, ref_pre, _corrupt(ref_g, ref, sites))
    got = audit_gradient(eng, pre, _corrupt(g, eng, sites), batch=1000)
    assert got == want
    if sites:
        assert want["tt_conflicts"] > 0 and want["ff_conflicts"] > 0
    else:
        assert not any(want.values())
    assert eng.stats.completion_queries > 0


# -- python -m repro_torch.analyze --device cpu --audit --persistence 0.5 -----

# the reference's values on the same mesh (the quickstart's at 12^3):
# audit_gradient on its gradient, persistence_pairs(grad=...).counts() and
# .digest(), and simplify_ms(ms, diagram, 0.5) (xla arm, tune="off")
ANALYZE_LINES = (
    "audit: {'tt_conflicts': 0, 'ff_conflicts': 0, 'reverse_mismatch': 0}",
    "persistence: {'pairs0': 2, 'pairs2': 1, 'essential0': 1, "
    "'essential2': 0, 'unpaired1': 2, 'unpaired2': 2} digest: "
    "070a41f6bbbae3888620d6155826fa80223b9f1b",
    "simplified at 0.5: {'saddle1': 2, 'saddle2': 2, 'basins_min': 1, "
    "'basins_max': 0, 'arcs': 2} {'cancelled0': 2, 'cancelled2': 1, "
    "'minima_before': 3, 'minima_after': 1, 'maxima_before': 1, "
    "'maxima_after': 0}",
)


def test_analyze_audit_and_persistence(capsys):
    analyze.main(["--device", "cpu", "--audit", "--persistence", "0.5"])
    out = capsys.readouterr().out
    for line in ANALYZE_LINES:
        assert line in out
