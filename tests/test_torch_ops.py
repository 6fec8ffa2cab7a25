"""The port's relation-block producer (``repro_torch.kernels.ops``) against
the reference's (``repro.kernels.ops``): the copied constants, the entry
inversion, both entry-assembly arms, and ``relation_block`` for VV/VE/VF/VT,
held bit for bit against the reference's ``xla`` arm and its Pallas kernel
in interpret mode, on mesh tables and on prime-size random tables.

Inputs are made with numpy from a seed and handed to both packages. The
CUDA kernels are held against the plain arm on a card by
``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from repro.core.mesh import segment_mesh as ref_segment_mesh
from repro.core.segtables import precondition as ref_precondition
from repro.data.meshgen import structured_grid as ref_structured_grid
from repro.kernels import ops as ref_ops
from repro.kernels.segment_relations import relation_entries_pallas
from repro_torch.kernels import ops, segment_relations

RELATIONS = ("VV", "VE", "VF", "VT")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_blocks_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- copied constants --------------------------------------------------------

def test_constants_equal_the_reference():
    assert ops.DEFAULT_DEG == ref_ops.DEFAULT_DEG
    assert ops.PREDICATE == ref_ops.PREDICATE
    for floor in (1, 2, 8):
        assert [ops.bucket_rows(n, floor) for n in range(301)] == \
            [ref_ops.bucket_rows(n, floor) for n in range(301)]


@pytest.mark.parametrize("relation", ["VV", "VT", "VE", "TT", "EF", "EE"])
def test_sparse_arm_guard_equals_the_reference(relation):
    for nvl, N in ((256, 896), (40000, 128), (2 ** 11, 2 ** 20)):
        x = np.zeros((1, N, 3), np.int32)
        assert ops.sparse_arm_ok(relation, x, x, nvl) == \
            ref_ops.sparse_arm_ok(relation, x, x, nvl)


# -- the entry inversion -----------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_invert_entries_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    B, E, R, O, deg = 3, 97, 7, 11, 4
    row = rng.integers(0, R, (B, E)).astype(np.int32)
    order = rng.integers(0, O, (B, E)).astype(np.int32)
    val = (order * 1000 + 3).astype(np.int32)   # equal keys, equal values
    valid = rng.random((B, E)) < 0.8
    got = ops._invert_entries(_t(row), _t(order), _t(val), _t(valid),
                              R=R, O=O, deg=deg)
    want = ref_ops._invert_entries(row, order, val, valid, R, O, deg)
    _assert_blocks_equal(got, want)
    assert (got[1] > deg).any()        # rows past the width keep true L


# -- both arms on mesh tables ------------------------------------------------

@pytest.fixture(scope="module")
def mesh_tables():
    sm = ref_segment_mesh(ref_structured_grid(5, 5, 5), capacity=16)
    pre = ref_precondition(sm, relations=list(RELATIONS))
    t = pre.tables
    out = {}
    for relation in RELATIONS:
        if relation == "VV":
            out[relation] = (t.T_local, t.T_local, t.LV_global)
        else:
            tabX, _ = t.table(relation[0])
            tabY, colg = t.table(relation[1])
            out[relation] = (tabX, tabY, colg)
    return t.NV, out


@pytest.mark.parametrize("relation", RELATIONS)
def test_relation_block_on_mesh_tables(mesh_tables, relation):
    nvl, tabs = mesh_tables
    tabX, tabY, colg = tabs[relation]
    deg = ops.DEFAULT_DEG[relation]
    got = ops.relation_block(relation, _t(tabX), _t(tabY), _t(colg), nvl)
    assert [g.dtype for g in got] == [torch.int32, torch.int32]
    _assert_blocks_equal(got, ref_ops.relation_block(
        relation, tabX, tabY, colg, nvl, backend="xla"))
    if relation in ("VV", "VT"):
        # the main path's two Pallas arms, in interpret mode (VE/VF share
        # the VT arm's kernel; the reference's own parity test covers them)
        _assert_blocks_equal(got, relation_entries_pallas(
            relation, tabX, tabY, colg, nvl=nvl, deg=deg, interpret=True))
    # the arm functions themselves, against the reference's
    colg32 = colg.astype(np.int32)
    if relation == "VV":
        arm = ops._block_vv(_t(tabX), _t(colg32), nvl, deg)
        want = ref_ops._block_vv(tabX, colg32, nvl, deg)
    else:
        arm = ops._block_member_v(_t(tabY), _t(colg32), nvl, deg)
        want = ref_ops._block_member_v(tabY, colg32, nvl, deg)
    _assert_blocks_equal(arm, want)


# -- prime-size random tables (ragged tails, rows past deg) -------------------

def _rand_tables(rng, B, N, arity, nvl, fill=0.7):
    tab = np.full((B, N, arity), -1, dtype=np.int32)
    for b in range(B):
        for i in range(max(1, int(N * fill))):
            tab[b, i] = rng.choice(nvl, size=arity, replace=False)
    return tab


@pytest.mark.parametrize("n", [1, 7, 127])
def test_prime_sized_tables(n):
    rng = np.random.default_rng(n)
    nvl = max(8, n)
    # member arm on an arity-2 table, as the reference's kernel parity test
    tx = _rand_tables(rng, 2, n, 2, nvl)
    colg = np.where(tx[:, :, 0] >= 0,
                    np.arange(n, dtype=np.int32)[None, :], -1)
    # (interpret mode costs a compile per shape: the largest size is held
    # against the xla arm only, which the reference proves equal to it)
    interpret = n < 127
    got = ops.relation_block("VE", _t(tx), _t(tx), _t(colg), nvl, deg=8)
    _assert_blocks_equal(got, ref_ops.relation_block(
        "VE", tx, tx, colg, nvl, deg=8, backend="xla"))
    if interpret:
        _assert_blocks_equal(got, ref_ops.relation_block(
            "VE", tx, tx, colg, nvl, deg=8, backend="pallas_interpret"))
    # VV and VT on random tet tables
    tt = _rand_tables(rng, 2, n, 4, nvl)
    colv = rng.integers(0, 10 ** 6, (2, nvl)).astype(np.int32)
    colt = rng.integers(0, 10 ** 6, (2, n)).astype(np.int32)
    for relation, colg in (("VV", colv), ("VT", colt)):
        got = ops.relation_block(relation, _t(tt), _t(tt), _t(colg), nvl,
                                 deg=4)
        _assert_blocks_equal(got, ref_ops.relation_block(
            relation, tt, tt, colg, nvl, deg=4, backend="xla"))
        if interpret:
            _assert_blocks_equal(got, relation_entries_pallas(
                relation, tt, tt, colg, nvl=nvl, deg=4, interpret=True))


# -- no silent fallbacks -----------------------------------------------------

def test_cuda_backend_on_cpu_tensors_raises():
    t = torch.zeros((1, 4, 4), dtype=torch.int32)
    c = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ops.relation_block("VV", t, t, c, 8, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        segment_relations.relation_entries_cuda("VV", t, t, c, nvl=8, deg=4)
    # EE has no CUDA-only path on CPU tensors: the dense fallback's plain
    # arm gives the reference's block
    e = torch.tensor([[[0, 1], [1, 2], [2, 3], [0, 3]]], dtype=torch.int32)
    ce = torch.tensor([[5, 6, 7, 8]], dtype=torch.int32)
    want = ref_ops.relation_block("EE", e.numpy(), e.numpy(), ce.numpy(), 8,
                                  backend="xla")
    got = ops.relation_block("EE", e, e, ce, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ops.resolve_device("cuda")
