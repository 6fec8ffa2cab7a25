"""The port's CUDA kernels on a card, against the plain torch arm: each
entry-assembly arm at the main path's shapes and at edge sizes (including
lanes too large for shared memory), and the critical-points path on the
``cuda`` backend against the CPU. These tests need an NVIDIA card and
``nvcc``; elsewhere they skip with a reason. They import only the port, so
they run where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, segment_relations
from repro_torch.quickstart import run

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _rand_tets(rng, B, NT, nvl, fill=0.7):
    tab = np.full((B, NT, 4), -1, dtype=np.int32)
    n = max(1, int(NT * fill))
    for b in range(B):
        tab[b, :n] = np.argsort(rng.random((n, nvl)), axis=1)[:, :4]
    return tab


@pytest.mark.parametrize("relation", ["VV", "VT"])
@pytest.mark.parametrize("B,NT,deg", [(1, 1, 8), (2, 127, 4), (64, 896, 64),
                                      (2, 1408, 256)])
def test_kernel_equals_plain_arm(cuda, relation, B, NT, deg):
    rng = np.random.default_rng(NT)
    nvl = 256
    tt = torch.from_numpy(_rand_tets(rng, B, NT, nvl)).to(cuda)
    N = nvl if relation == "VV" else NT
    colg = torch.from_numpy(
        rng.integers(0, 10 ** 6, (B, N)).astype(np.int32)).to(cuda)
    arm = "VV" if relation == "VV" else "member"
    before = segment_relations.LAUNCHES[arm]
    got = ops.relation_block(relation, tt, tt, colg, nvl, deg=deg)
    want = ops.relation_block(relation, tt, tt, colg, nvl, deg=deg,
                              backend="torch")
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert segment_relations.LAUNCHES[arm] == before + 1


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    t = torch.zeros((1, 4, 4), dtype=torch.int64, device=cuda)
    c = torch.zeros((1, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        segment_relations.relation_entries_cuda("VV", t, t, c, nvl=8, deg=4)
    t = torch.zeros((1, 4, 8), dtype=torch.int32, device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        segment_relations.relation_entries_cuda("VV", t, t, c, nvl=8, deg=4)


@pytest.mark.parametrize("workers", [1, 4])
def test_critical_points_on_the_card_equal_the_cpu(cuda, workers):
    _, gale, types, counts = run(16, device="cuda", workers=workers)
    _, _, want, want_counts = run(16, device="cpu")
    np.testing.assert_array_equal(types, want)
    assert counts == want_counts
    assert gale.backend == "cuda"
    assert gale.stats.segments_produced == 2 * len(gale.smesh.I_V[1:])
