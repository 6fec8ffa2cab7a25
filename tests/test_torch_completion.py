"""The port's cross-segment completion against the reference's: the row
resolve (single-key and lexicographic searches) and the gather + union of
``kernels/completion_gather.py`` against the reference's ``xla`` arm and its
Pallas kernel in interpret mode; ``complete_adjacency("TT")`` on the host
path, the device path and the device path with ``out="dev"`` against the
reference, the scalar oracle and the reference's completion stats; and the
boundary flag of ``critical_points`` built on it. Inputs are made with numpy
from a seed and handed to both packages."""

import numpy as np
import pytest
import torch

from repro.algorithms import fields as ref_fields
from repro.algorithms.critical_points import \
    boundary_vertices as ref_boundary_vertices
from repro.algorithms.critical_points import \
    critical_points as ref_critical_points
from repro.core.adjacency import complete_adjacency as ref_complete
from repro.core.engine import RelationEngine as RefEngine
from repro.core.mesh import segment_mesh as ref_segment_mesh
from repro.core.segtables import precondition as ref_precondition
from repro.data.meshgen import structured_grid as ref_structured_grid
from repro.kernels import completion_gather as ref_cg
from repro_torch.algorithms import fields
from repro_torch.algorithms.critical_points import boundary_vertices, \
    critical_points, total_order
from repro_torch.core.adjacency import complete_adjacency, \
    complete_adjacency_scalar
from repro_torch.core.engine import RelationEngine
from repro_torch.core.mesh import segment_mesh
from repro_torch.core.segtables import precondition
from repro_torch.data.meshgen import structured_grid
from repro_torch.errors import RelationWidthError
from repro_torch.kernels import completion_gather as cg


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inverse_maps(rng, ns, n_global, K):
    """Sorted unique (seg, gid) appearances with random local rows."""
    key = np.unique(rng.integers(0, ns * n_global, K))
    seg = (key // n_global).astype(np.int32)
    gid = (key % n_global).astype(np.int32)
    row = rng.integers(0, 50, len(key)).astype(np.int32)
    return key.astype(np.int32), seg, gid, row


def _queries(rng, seg, gid, ns, n_global, P):
    """Present pairs, absent pairs, pairs past the last key (the search
    ends at lo == K) and the padding pair (0, -1)."""
    pick = rng.integers(0, len(seg), P)
    qs, qg = seg[pick].copy(), gid[pick].copy()
    absent = rng.random(P) < 0.3
    qs[absent] = rng.integers(0, ns, absent.sum())
    qg[absent] = rng.integers(0, n_global, absent.sum())
    qs[:3], qg[:3] = ns + 1, [0, 5, n_global - 1]     # beyond every key
    qs[3], qg[3] = 0, -1                              # padding
    return qs.astype(np.int32), qg.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_resolve_rows_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    ns, n_global = 13, 101
    key, seg, gid, row = _inverse_maps(rng, ns, n_global, 600)
    qs, qg = _queries(rng, seg, gid, ns, n_global, 257)
    want_lex = np.asarray(ref_cg.resolve_rows(seg, gid, row, qs, qg))
    want_key = np.asarray(ref_cg.resolve_rows(
        seg, gid, row, qs, qg, inv_key=key, n_global=n_global))
    np.testing.assert_array_equal(want_lex, want_key)
    got_lex = cg.resolve_rows(_t(seg), _t(gid), _t(row), _t(qs), _t(qg))
    got_key = cg.resolve_rows(_t(seg), _t(gid), _t(row), _t(qs), _t(qg),
                              inv_key=_t(key), n_global=n_global)
    np.testing.assert_array_equal(got_lex.numpy(), want_lex)
    np.testing.assert_array_equal(got_key.numpy(), want_lex)
    assert (want_lex == -1).sum() > 3 and (want_lex >= 0).sum() > 100
    # a map of one appearance, and no appearance at all
    one = [a[:1] for a in (seg, gid, row)]
    np.testing.assert_array_equal(
        cg.resolve_rows(*map(_t, one), _t(qs), _t(qg)).numpy(),
        np.asarray(ref_cg.resolve_rows(*one, qs, qg)))
    empty = [a[:0] for a in (seg, gid, row)]
    assert (cg.resolve_rows(*map(_t, empty), _t(qs), _t(qg)) == -1).all()


def _gather_inputs(rng, S=5, R=9, degp=4, n=11, w=4):
    ns, n_global = 7, 40
    key, seg, gid, row = _inverse_maps(rng, ns, n_global, 120)
    row = (row % R).astype(np.int32)
    pool_M = rng.integers(-1, 60, (S, R, degp)).astype(np.int32)
    pool_L = rng.integers(0, degp + 2, (S, R)).astype(np.int32)  # L > degp
    P = 29
    qs, qg = _queries(rng, seg, gid, ns, n_global, P)
    slot = rng.integers(0, S, P).astype(np.int32)
    slot[-4:] = -1                                    # inert padding pairs
    pair_at = np.full((n, w), -1, dtype=np.int32)
    q = rng.integers(0, n, P)
    for p in range(P):
        free = np.nonzero(pair_at[q[p]] < 0)[0]
        if len(free):
            pair_at[q[p], free[0]] = p
    return dict(pool_M=pool_M, pool_L=pool_L, inv_seg=seg, inv_gid=gid,
                inv_row=row, pair_slot=slot, pair_seg=qs, pair_gid=qg,
                pair_at=pair_at), key, n_global


@pytest.mark.parametrize("use_key", [False, True])
def test_gather_union_equals_the_reference(use_key):
    rng = np.random.default_rng(5 + use_key)
    args, key, n_global = _gather_inputs(rng)
    kw = dict(inv_key=key, n_global=n_global) if use_key else {}
    for deg_out in (3, 8):
        want = ref_cg.gather_union(**args, deg_out=deg_out, backend="xla",
                                   **kw)
        got = cg.gather_union(**{k: _t(v) for k, v in args.items()},
                              deg_out=deg_out, backend="torch",
                              **{k: _t(v) if k == "inv_key" else v
                                 for k, v in kw.items()})
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert int(want[1].max()) > 3        # rows truncated at deg_out=3
    # the Pallas resolve + gather kernel, in interpret mode (one shape)
    if not use_key:
        want = ref_cg.gather_union(**args, deg_out=8,
                                   backend="pallas_interpret")
        got = cg.gather_union(**{k: _t(v) for k, v in args.items()},
                              deg_out=8, backend="torch")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the plain version of the kernel, alone: every pair gets the clamped
    # pool row; unresolved or slot -1 pairs get length 0
    cand, clen = cg.resolve_gather_torch(
        *(_t(args[k]) for k in ("pool_M", "pool_L", "inv_seg", "inv_gid",
                                "inv_row", "pair_slot", "pair_seg",
                                "pair_gid")))
    assert cand.shape == (29, 4) and (clen[-4:] == 0).all()


def test_cuda_backend_needs_cuda_tensors():
    rng = np.random.default_rng(1)
    args, _, _ = _gather_inputs(rng)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cg.gather_union(**{k: _t(v) for k, v in args.items()}, deg_out=8,
                        backend="cuda")
    with pytest.raises(NotImplementedError, match="item 9"):
        cg.gather_candidates()


# -- complete_adjacency("TT") --------------------------------------------------

def _grid(gen, fld):
    return gen(6, 5, 5, scalar_fn=fld.gaussians(3, k=3, sigma=2.0, scale=6))


@pytest.fixture(scope="module")
def meshes():
    ref_pre = ref_precondition(ref_segment_mesh(
        _grid(ref_structured_grid, ref_fields), capacity=16),
        ["VV", "VT", "FT", "TT"])
    pre = precondition(segment_mesh(_grid(structured_grid, fields),
                                    capacity=16), ["VV", "VT", "FT", "TT"])
    return ref_pre, pre


STATS = ("completion_queries", "completion_fanout_blocks",
         "completion_raw_neighbors", "completion_neighbors")


@pytest.mark.parametrize("batch,workers", [(None, 1), (97, 1), (61, 3)])
def test_complete_tt_equals_the_reference(meshes, batch, workers):
    ref_pre, pre = meshes
    nt = pre.smesh.n_tets
    ids = np.random.default_rng(batch or 0).permutation(nt)[:300]
    ref = RefEngine(ref_pre, ["TT"], tune="off")
    want_M, want_L = ref_complete(ref, "TT", ids, batch=batch,
                                  workers=workers)
    outs = {}
    for path, out in (("host", "host"), ("device", "host"),
                      ("device", "dev")):
        eng = RelationEngine(pre, ["TT"], device="cpu")
        M, L = complete_adjacency(eng, "TT", ids, batch=batch, path=path,
                                  out=out, workers=workers)
        if out == "dev":
            assert isinstance(M, torch.Tensor) and M.shape[1] == 8
            assert (M[:, want_M.shape[1]:] == -1).all()
            M, L = M[:, :want_M.shape[1]].numpy(), L.numpy()
        np.testing.assert_array_equal(M, want_M)
        np.testing.assert_array_equal(L, want_L)
        outs[(path, out)] = eng.stats
        for f in STATS:
            assert getattr(eng.stats, f) == getattr(ref.stats, f), (path, f)
        assert eng.merged_worker_stats() == eng.stats
    assert outs[("device", "dev")].completion_dedup_ratio == \
        ref.stats.completion_dedup_ratio > 1.0
    sM, sL = complete_adjacency_scalar(RelationEngine(pre, ["TT"],
                                                      device="cpu"),
                                       "TT", ids)
    np.testing.assert_array_equal(sM, want_M)
    np.testing.assert_array_equal(sL, want_L)


def test_completion_checks(meshes):
    _, pre = meshes
    eng = RelationEngine(pre, ["TT"], device="cpu", deg={"TT": 2})
    with pytest.raises(RelationWidthError, match="deg"):
        complete_adjacency(eng, "TT", np.arange(40), path="device")
    eng = RelationEngine(pre, ["VV", "TT"], device="cpu")
    with pytest.raises(ValueError, match="engine's relation set"):
        complete_adjacency(eng, "FF", [0])
    with pytest.raises(ValueError, match="device execute arm"):
        complete_adjacency(eng, "TT", [0], path="host", out="dev")
    with pytest.raises(NotImplementedError, match="item 9"):
        complete_adjacency(eng, "TT", [0], shards=2)
    # no query: empty rows of the right width on either arm
    M, L = complete_adjacency(eng, "TT", [], path="device", out="dev")
    assert M.shape == (0, 8) and L.shape == (0,)


# -- critical_points(flag_boundary=True) / boundary_vertices -----------------

@pytest.mark.parametrize("consumer,workers", [("device", 1), ("host", 3)])
def test_boundary_flag_equals_the_reference(meshes, consumer, workers):
    ref_pre, pre = meshes
    rels = ["VV", "VT", "TT"]
    rank = total_order(pre.smesh.scalars)
    ref = RefEngine(ref_pre, rels, tune="off")
    want_types, want = ref_critical_points(ref, ref_pre, rank,
                                           flag_boundary=True)
    want_mask = ref_boundary_vertices(ref, ref_pre)
    eng = RelationEngine(pre, rels, device="cpu")
    types, counts = critical_points(eng, pre, rank, flag_boundary=True,
                                    consumer=consumer, workers=workers)
    assert counts == want and counts["boundary_critical"] > 0
    np.testing.assert_array_equal(types, want_types)
    mask = boundary_vertices(eng, pre, batch=211, consumer=consumer,
                             workers=workers)
    np.testing.assert_array_equal(mask, want_mask)
    assert 0 < mask.sum() < len(mask)
