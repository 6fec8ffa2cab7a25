"""On a card, each cell at its own size: the program's numbers within
their limits and the control (the reference in float8 in the program's
place), and a training cell's fault (half of each batch), outside one of
them. Skips without a card."""

import pytest
import torch

from gale_bench import control, registry
from gale_bench.harness import context

CELLS = [w["name"] for w in registry.load_benchmark()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda")


def _fails(nums, limits):
    return any(not nums[k] <= lim for k, lim in limits.items())


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(card, name):
    cell = registry.cell(name)
    job = registry.job(cell.kind).Job(context(cell, 20261018, card, "cuda"))
    job.setup()
    job.window(3.0)
    job.drain()
    job.release()
    r = control.readings(job, cell.kind, True)
    assert not _fails(r["program"], cell.limits), r
    for who in set(r) - {"program"}:
        assert _fails(r[who], cell.limits), (who, r)
