"""The VV count kernel's design (``vv_counts_kernel`` of
``csrc/counts.cu``) against its plain arm and the reference.

The kernel cannot run on the CPU, so a numpy model of it, block for block,
is held against ``ops._counts_vv_onehot`` (the plain arm the kernel is held
against on the card) and the reference's ``ref.relation_counts_vv``: a
grid of ``ceil(nvl / rows)`` row tiles by B segments, each block walking
its segment's tets in staged chunks of 1024 for each 256-column chunk of
C, adding one per ordered slot pair whose row lies in its tile and whose
column in its chunk. Inputs are made with numpy from a seed and handed to
both packages."""

import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import ops, segment_relations

_COLS = 256       # kVvCols: columns of C a block keeps at a time
_STAGE = 1024     # kVvStage: tets staged in shared memory at a time


def _vv_counts_blocks(T_local, nvl, rows):
    """What ``vv_counts_kernel<rows>`` computes, block by block: block
    (tile, b) keeps C rows ``[tile * rows, tile * rows + rows)`` of segment
    b and, for each column chunk, a zeroed ``rows x 256`` tile; it walks
    the segment's tets in stages of 1024 and adds one for each ordered slot
    pair (a, c) with ``0 <= v[a] - i0 < rows`` and ``0 <= v[c] - c0 <
    cols`` (both ids valid), then stores the chunk's columns."""
    B, NT, _ = T_local.shape
    C = np.zeros((B, nvl, nvl), dtype=np.int32)
    for b in range(B):
        for i0 in range(0, nvl, rows):
            nr = min(rows, nvl - i0)
            for c0 in range(0, nvl, _COLS):
                cols = min(_COLS, nvl - c0)
                tile = np.zeros((rows, _COLS), dtype=np.int32)
                for t0 in range(0, NT, _STAGE):
                    for v in T_local[b, t0:t0 + _STAGE]:
                        for a in range(4):
                            ra = v[a] - i0
                            if v[a] < 0 or not 0 <= ra < nr:
                                continue
                            for c in range(4):
                                cb = v[c] - c0
                                if v[c] >= 0 and 0 <= cb < cols:
                                    tile[ra, cb] += 1
                C[b, i0:i0 + nr, c0:c0 + cols] = tile[:nr, :cols]
    return C


def _tets(rng, B, NT, nvl, hi=None):
    """(B, NT, 4) rows of distinct random ids below ``hi`` (default
    ``nvl``), about a tenth of the rows -1 padding, the last segment all
    padding."""
    hi = nvl if hi is None else hi
    T = np.stack([np.stack([rng.choice(hi, 4, replace=False)
                            for _ in range(NT)]) for _ in range(B)])
    T = T.astype(np.int32)
    T[rng.random((B, NT)) < 0.1] = -1
    T[-1] = -1
    return T


@pytest.mark.parametrize("rows", segment_relations.VV_COUNT_ROWS)
@pytest.mark.parametrize("nvl,NT,hi", [(37, 61, None), (257, 300, None),
                                       (40, 1100, 48)])
def test_vv_counts_tiles_equal_the_plain_arm(rows, nvl, NT, hi):
    """Row tiles of 8, 16 and 32 rows give the plain arm's and the
    reference's counts: an nvl that no tile divides, nvl 257 (two column
    chunks), more tets than one stage (1100), ids past nvl (up to 47 at nvl
    40) that count nowhere, and a segment of -1 padding."""
    rng = np.random.default_rng(rows + nvl)
    T = _tets(rng, 3, NT, nvl, hi)
    got = _vv_counts_blocks(T, nvl, rows)
    np.testing.assert_array_equal(
        ops._counts_vv_onehot(torch.from_numpy(T), nvl).numpy(), got)
    if hi is None:      # the reference's one-hot needs ids below nvl
        np.testing.assert_array_equal(
            np.asarray(ref.relation_counts_vv(T, nvl)), got)
    assert got[:-1].max() > 0 and not got[-1].any()


def test_vv_count_rows_fill_the_card():
    """The grid is sized by B: the tallest tile, 32 or 16 rows, whose B
    segments' blocks occupy at least half of 132 SMs, else 8 rows; at the
    fused extrema loop's batch (B 8, NV 256) 16 rows, 128 blocks."""
    rows = segment_relations.vv_count_rows
    assert [rows(B, 256, 132) for B in (1, 2, 4, 5, 8, 9, 64, 500)] == \
        [8, 8, 8, 16, 16, 32, 32, 32]
    assert 8 * -(-256 // rows(8, 256, 132)) == 128        # blocks at B 8
    assert [rows(1, n, 132) for n in (256, 1056, 2048, 2112)] == \
        [8, 16, 16, 32]
    assert all(rows(B, n, 132) in segment_relations.VV_COUNT_ROWS
               for B in (1, 3, 64) for n in (1, 31, 257, 4096))
