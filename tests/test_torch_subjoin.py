"""The sub-join (EF/ET) past NX 8192 on the CPU: the port's blocks at the
size of the bitmask route's row shares against the reference's.

``structured_grid(24, 24, 24)`` segmented at capacity 1024 has 14
segments of up to NV 1792, NE 9984 and NF 15,488 local rows: an edge
table past 8192 rows, where the sub-join kernel once took the sort route
and now keeps its bitmask in row shares (``entry_route`` at an H100's
opt-in limit). Every segment's EF and ET block from the port's plain arm
(the version the kernel is held against on the card) equals the
reference's ``relation_block`` (xla arm), element for element, on the
same tables; both packages' preconditioning gives the same tables."""

import numpy as np
import pytest
import torch

from repro.core.mesh import segment_mesh as ref_segment_mesh
from repro.core.segtables import precondition as ref_precondition
from repro.data.meshgen import structured_grid as ref_structured_grid
from repro.kernels import ops as ref_ops
from repro_torch.core.mesh import segment_mesh
from repro_torch.core.segtables import precondition
from repro_torch.data.meshgen import structured_grid
from repro_torch.kernels import ops, segment_relations

_H100_SMEM = 232448        # the opt-in shared memory of an H100's block


@pytest.fixture(scope="module")
def tables():
    rels = ["EF", "ET"]
    pre = precondition(segment_mesh(structured_grid(24, 24, 24),
                                     capacity=1024), rels)
    ref = ref_precondition(ref_segment_mesh(ref_structured_grid(24, 24, 24),
                                            capacity=1024), rels)
    return pre.tables, ref.tables


def test_capacity_1024_tables_are_past_the_old_limit(tables):
    t, r = tables
    assert t.NE > 8192 and (t.NV, t.NE, t.NF, t.NT) == (1792, 9984, 15488,
                                                         7296)
    assert t.E_local.shape[0] == 14
    for name in ("E_local", "F_local", "T_local", "LF_global", "LT_global"):
        np.testing.assert_array_equal(getattr(t, name),
                                      np.asarray(getattr(r, name)))
    for relation, NY in (("EF", t.NF), ("ET", t.NT)):
        assert segment_relations.entry_route(relation, t.NV, NY,
                                             _H100_SMEM) == "bits"
        assert segment_relations.bits_blocks(relation, 14, t.NV, t.NE, NY,
                                             _H100_SMEM, 132) > 1


@pytest.mark.parametrize("relation", ["EF", "ET"])
def test_capacity_1024_blocks_equal_the_reference(tables, relation):
    t, _ = tables
    tx = t.E_local
    ty = t.F_local if relation == "EF" else t.T_local
    colg = t.LF_global if relation == "EF" else t.LT_global
    M, L = ops.relation_block(relation, torch.from_numpy(tx),
                              torch.from_numpy(ty), torch.from_numpy(colg),
                              t.NV)
    rM, rL = ref_ops.relation_block(relation, tx, ty, colg, t.NV,
                                    backend="xla")
    np.testing.assert_array_equal(M.numpy(), np.asarray(rM))
    np.testing.assert_array_equal(L.numpy(), np.asarray(rL))
    assert M.shape == (14, t.NE, ops.DEFAULT_DEG[relation])
    assert int(L.max()) > 1 and int((L > 0).sum()) > 14 * 8192
