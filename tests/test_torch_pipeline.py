"""The port's fused extrema pipeline (``repro_torch.core.pipeline``)
against the reference's ``fused_extrema`` (its ``lax.scan`` over segment
batches), exactly, on the CPU: the minima and maxima at batch 1, 3, 4 and
8 (segment counts that are and are not multiples of the batch), the
padding segments, one producer call a batch, and agreement with the
engine's critical points."""

import numpy as np
import pytest
import torch

from repro.algorithms import fields as ref_fields
from repro.core.mesh import segment_mesh as ref_segment_mesh
from repro.core.pipeline import fused_extrema as ref_fused_extrema
from repro.core.segtables import precondition as ref_precondition
from repro.data import meshgen as ref_meshgen
from repro_torch.algorithms import fields
from repro_torch.algorithms.critical_points import MAXIMUM, MINIMUM, \
    critical_points, total_order
from repro_torch.core import pipeline
from repro_torch.core.engine import RelationEngine
from repro_torch.core.mesh import segment_mesh
from repro_torch.core.segtables import precondition
from repro_torch.data import meshgen
from repro_torch.kernels import ops


def _mesh(gen, fld, name):
    if name == "grid9":
        return gen.structured_grid(9, 9, 9, scalar_fn=fld.gaussians(
            5, k=4, sigma=3.0, scale=9))
    return gen.load_dataset(name, scalar_fn=fld.gaussians(2, k=5, sigma=5.0))


_PRE = {}


def _pres(name):
    if name not in _PRE:
        _PRE[name] = (
            ref_precondition(ref_segment_mesh(
                _mesh(ref_meshgen, ref_fields, name), 32), ["VV", "VT"]),
            precondition(segment_mesh(_mesh(meshgen, fields, name), 32),
                         ["VV", "VT"]))
    return _PRE[name]


@pytest.mark.parametrize("batch", [1, 3, 4, 8])
@pytest.mark.parametrize("name", ["grid9", "graded"])
def test_fused_extrema_equal_the_reference(name, batch):
    ref, port = _pres(name)
    rank = total_order(port.smesh.scalars)
    want = ref_fused_extrema(ref, rank, batch=batch)
    got = pipeline.fused_extrema(port, rank, batch=batch, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert np.all(np.diff(g) > 0)


def test_segment_count_not_a_multiple_of_the_batch_pads_inert_segments():
    _, port = _pres("grid9")
    ns = port.smesh.n_segments
    batch = 4 if ns % 4 else 3
    assert ns % batch, ns
    rank = total_order(port.smesh.scalars)
    T, LV, nint, r = pipeline.stage_fused(port, rank, batch, device="cpu")
    nb = -(-ns // batch)
    assert T.shape[:2] == LV.shape[:2] == nint.shape == (nb, batch)
    flat_T = T.reshape(nb * batch, *T.shape[2:])
    assert (flat_T[ns:] == -1).all() and (LV.reshape(-1, LV.shape[2])[ns:]
                                          == -1).all()
    assert (nint.reshape(-1)[ns:] == 0).all()
    np.testing.assert_array_equal(flat_T[:ns].numpy(), port.tables.T_local)
    mins, maxs = pipeline.fused_masks(T, LV, nint, r)
    assert mins.shape == maxs.shape == (nb * batch, port.tables.NV)
    assert not mins[ns:].any() and not maxs[ns:].any()


def test_one_producer_call_a_batch(monkeypatch):
    _, port = _pres("grid9")
    calls = []
    real = ops.counts_vv

    def spy(T_local, nvl, backend=None):
        calls.append(tuple(T_local.shape))
        return real(T_local, nvl, backend)

    monkeypatch.setattr(ops, "counts_vv", spy)
    rank = total_order(port.smesh.scalars)
    pipeline.fused_extrema(port, rank, batch=4, device="cpu")
    ns = port.smesh.n_segments
    assert len(calls) == -(-ns // 4)
    assert set(calls) == {(4, port.tables.NT, 4)}


@pytest.mark.parametrize("name", ["grid9", "graded"])
def test_fused_extrema_equal_the_engine_critical_points(name):
    _, port = _pres(name)
    rank = total_order(port.smesh.scalars)
    types, _ = critical_points(RelationEngine(port, ["VV", "VT"],
                                              device="cpu"), port, rank)
    got_min, got_max = pipeline.fused_extrema(port, rank, device="cpu")
    np.testing.assert_array_equal(got_min, np.nonzero(types == MINIMUM)[0])
    np.testing.assert_array_equal(got_max, np.nonzero(types == MAXIMUM)[0])


def test_runs_on_cuda_unless_asked_and_raises_without_a_card(monkeypatch):
    _, port = _pres("grid9")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.fused_extrema(port, total_order(port.smesh.scalars))
