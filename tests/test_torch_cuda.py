"""The port's CUDA kernels on a card, against the plain torch arm: each
entry-assembly arm (VV, member, TT, sub-join; VV, member and sub-join on
both the bitmask and the sort route, and on each side of the routing
limit; the sub-join past its precondition; the VV and member sort route's
CSR kernels at the capacity-8192 VF and capacity-1024 VT and VV shapes and
past their precondition) at the
main path's shapes and at edge sizes (including lanes too large for shared
memory), the completion
gather kernel (and its mask mode, one shard's half of the sharded
exchange), the meet and VV count kernels of the dense fallback, the
flash-attention kernels (float32 2e-5, bf16 2e-2; the mma kernel on both
its load paths, twice for equal outputs; the SIMT kernel by force), the
critical-points (both
assemblies), gradient -> Morse-Smale and audit + persistence paths on the
``cuda`` backend against the CPU (also at 2 and 4 segment shards), the
fault ladder on the card (the numpy host arm against every kernel, the
sync watchdog reclaiming an injected hang on a CUDA event, a lost shard
re-homed on one card), the bitmask kernels at every tuned share count
and a tuned engine against an untuned one, and the LM smoke configs'
prefill and
decode on both attention arms against the CPU (every family; the flash
kernels at the moe and hybrid path shapes; the bf16 smoke configs of
gemma-7b at hd 256, command-r-35b and phi3.5-moe on both arms), and
training: the flash
kernels' autograd Function against the plain gradient, a train step on
both arms. These tests need an NVIDIA card and
``nvcc``; elsewhere they skip with a reason. They import only the port, so
they run where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""

import dataclasses
import math
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import analyze, analyze_mesh, configs
from repro_torch.algorithms import fields
from repro_torch.algorithms.critical_points import critical_points, \
    total_order
from repro_torch.algorithms.discrete_gradient import discrete_gradient
from repro_torch.algorithms.morse_smale import morse_smale
from repro_torch.core import explicit, pipeline
from repro_torch.core.adjacency import complete_adjacency
from repro_torch.core.engine import RelationEngine
from repro_torch.core.mesh import segment_mesh
from repro_torch.core.segtables import precondition
from repro_torch.data.meshgen import structured_grid
from repro_torch.kernels import completion_gather, flash_attention, ops, \
    segment_relations
from repro_torch.launch import serve
from repro_torch.models import layers, lm
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


def _entry_inputs(rng, cuda, relation, B, NT, nvl):
    """The tet table of B segments and the table, column map and row count
    (``nvl`` for VV, NY for the member arm) of ``relation``."""
    tets = _rand_tets(rng, B, NT, nvl)
    if relation == "VV":
        tab, N = tets, nvl
    else:
        tab = _sub_tables(rng, tets)[relation[1]] if relation != "VT" \
            else tets
        N = tab.shape[1]
    colg = rng.integers(0, 10 ** 6, (B, N)).astype(np.int32)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in (tab, colg)]


@pytest.mark.parametrize("route", ["bits", "sort"])
@pytest.mark.parametrize("relation", ["VV", "VE", "VF", "VT"])
@pytest.mark.parametrize("B,NT,deg", [(1, 1, 8), (2, 127, 4), (64, 896, 64),
                                      (2, 1408, 256)])
def test_kernel_equals_plain_arm(cuda, relation, B, NT, deg, route):
    """Both routes of the VV and member arms on the same tables; each
    launch moves its route's counter, and ``route=None`` picks the
    bitmask kernel at nvl 256."""
    rng = np.random.default_rng(NT)
    nvl = 256
    tab, colg = _entry_inputs(rng, cuda, relation, B, NT, nvl)
    arm = "VV" if relation == "VV" else "member"
    before = dict(segment_relations.LAUNCHES)
    got = segment_relations.relation_entries_cuda(
        relation, tab, tab, colg, nvl=nvl, deg=deg, route=route)
    want = ops.relation_block(relation, tab, tab, colg, nvl, deg=deg,
                              backend="torch")
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert segment_relations.LAUNCHES[arm] == before[arm] + 1
    assert segment_relations.LAUNCHES[f"{arm}_{route}"] == \
        before[f"{arm}_{route}"] + 1
    before = dict(segment_relations.LAUNCHES)
    again = ops.relation_block(relation, tab, tab, colg, nvl, deg=deg)
    torch.cuda.synchronize()
    for g, w in zip(again, want):     # two launches: equal blocks
        assert torch.equal(g, w)
    assert segment_relations.LAUNCHES[f"{arm}_bits"] == \
        before[f"{arm}_bits"] + 1


@pytest.mark.parametrize("relation,nvl,NT", [("VV", 1344, 2000),
                                             ("VV", 1376, 2000),
                                             ("VT", 256, 6816),
                                             ("VT", 256, 6848),
                                             ("VT", 8, 110000)])
def test_entry_route_on_the_card(cuda, relation, nvl, NT):
    """Tables on each side of the old whole-mask limit and past the new
    one-row limit (on an H100: VV at nvl 1344 and VT at NY 6816 fit whole,
    nvl 1376 and NY 6848 now take the bitmask route with several shares a
    segment; VT at NY 110,000 does not fit one row): the wrapper's own
    choice (``entry_route`` at the card's opt-in limit) runs, equals the
    plain arm, and moves that route's counter; forcing the bitmask kernel
    past the limit raises."""
    rng = np.random.default_rng(nvl + NT)
    tab, colg = _entry_inputs(rng, cuda, relation, 2, NT, nvl)
    arm = "VV" if relation == "VV" else "member"
    limit = segment_relations.smem_limit(cuda)
    route = segment_relations.entry_route(relation, nvl, NT, limit)
    assert route == ("sort" if NT == 110000 else "bits")
    if (nvl, NT) in ((1376, 2000), (256, 6848)):
        fit = segment_relations.bits_rows_fit(relation, nvl, NT, limit)
        assert fit < nvl
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        assert segment_relations.bits_shares(relation, 2, nvl, fit,
                                             sms) >= 2
    before = dict(segment_relations.LAUNCHES)
    got = ops.relation_block(relation, tab, tab, colg, nvl, deg=32)
    want = ops.relation_block(relation, tab, tab, colg, nvl, deg=32,
                              backend="torch")
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert segment_relations.LAUNCHES[f"{arm}_{route}"] == \
        before[f"{arm}_{route}"] + 1
    if route == "sort":
        with pytest.raises(ValueError, match="does not fit"):
            segment_relations.relation_entries_cuda(
                relation, tab, tab, colg, nvl=nvl, deg=32, route="bits")


_QUICKSTART = {}


def _quickstart_pre(capacity, relations):
    """The 48^3 quickstart mesh segmented at ``capacity`` and
    preconditioned for ``relations``, built once a process."""
    key = (capacity, tuple(relations))
    if key not in _QUICKSTART:
        sm = segment_mesh(structured_grid(48, 48, 48, scalar_fn=fields
                                          .gaussians(0, k=4, sigma=3.0,
                                                     scale=48)),
                          capacity=capacity)
        _QUICKSTART[key] = precondition(sm, list(relations))
    return _QUICKSTART[key]


def _sort_route_equals_plain(cuda, relation, tab, colg, nvl, deg,
                             route="sort", plain_tab=None):
    """The sort route's kernel (forced, or the wrapper's own choice with
    ``route=None``) against the plain arm on ``plain_tab`` (default
    ``tab``), bit for bit, one ``_sort`` launch counted; launched again,
    the same blocks. Returns the plain arm's ``L``."""
    arm = "VV" if relation == "VV" else "member"
    cu = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    tab, colg = cu(tab), cu(colg)
    ptab = tab if plain_tab is None else cu(plain_tab)
    before = dict(segment_relations.LAUNCHES)
    got = segment_relations.relation_entries_cuda(
        relation, tab, tab, colg, nvl=nvl, deg=deg, route=route)
    again = segment_relations.relation_entries_cuda(
        relation, tab, tab, colg, nvl=nvl, deg=deg, route=route)
    want = ops.relation_block(relation, ptab, ptab, colg, nvl, deg=deg,
                              backend="torch")
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, w)
        assert torch.equal(a, g)
    assert segment_relations.LAUNCHES[f"{arm}_sort"] == \
        before[f"{arm}_sort"] + 2
    assert segment_relations.LAUNCHES[arm] == before[arm] + 2
    return want[1]


@pytest.mark.parametrize("relation,capacity", [("VF", 8192), ("VT", 1024),
                                               ("VV", 1024)])
def test_csr_sort_kernels_at_the_path_shapes(cuda, relation, capacity):
    """The redesigned sort kernels at their shapes: VF of the 48^3 mesh at
    capacity 8192 (14 segments, nvl 11,008, NY 111,616), which the wrapper
    sends to ``member_entries_kernel`` by itself, and the capacity-1024
    VT and VV tables (B 64, nvl 2048, NT 8576), forced; twice, equal."""
    pre = _quickstart_pre(capacity, (relation,))
    t = pre.tables
    if relation == "VV":
        tab, colg = t.T_local[:64], t.LV_global[:64]
    else:
        tab, colg = (a[:64] for a in t.table(relation[1]))
    limit = segment_relations.smem_limit(cuda)
    own = segment_relations.entry_route(relation, t.NV, tab.shape[1], limit)
    assert own == ("sort" if capacity == 8192 else "bits")
    L = _sort_route_equals_plain(cuda, relation, tab, colg, t.NV,
                                 ops.DEFAULT_DEG[relation],
                                 route=None if own == "sort" else "sort")
    assert int(L.max()) > 0


def _adversarial_tables(rng, relation, B, N, nvl, used, heavy):
    """(B, N, arity) tables past the arms' precondition: random simplices of
    distinct ids below ``used`` (rows ``used`` .. nvl - 1 stay empty), -1
    padding rows and -1 slots, vertex 5 in ``heavy`` rows (a row of that
    many entries; for VV three times as many, with duplicates), a vertex
    twice in one row, and ids past nvl. Returns the table and the one the
    plain arm takes: for VV the ids past nvl as -1 slots (the plain VV key
    ``va * nvl + vb`` would carry such a vb into a later row; the kernels
    drop it, as the bitmask kernels do)."""
    a = 4 if relation == "VV" else {"E": 2, "F": 3, "T": 4}[relation[1]]
    tab = np.full((B, N, a), -1, dtype=np.int32)
    k = N - 7
    for b in range(B):
        tab[b, :k] = np.argsort(rng.random((k, used)), axis=1)[:, :a]
        rows = rng.choice(k, heavy, replace=False)
        rows = rows[~(tab[b, rows] == 5).any(-1)]
        tab[b, rows, 0] = 5
    tab[rng.random(tab.shape) < 0.05] = -1
    tab[:, 3, :2] = 7
    tab[:, 10, 0] = nvl + 3
    tab[:, 12, a - 1] = nvl
    plain = np.where(tab >= nvl, -1, tab).astype(np.int32) \
        if relation == "VV" else tab
    return tab, plain


@pytest.mark.parametrize("relation,N,nvl,used,heavy,deg",
                         [("VV", 1500, 500, 400, 900, 16),
                          ("VF", 5000, 400, 350, 3000, 8),
                          ("VT", 2000, 300, 250, 1500, 4),
                          ("VE", 3000, 60000, 500, 2000, 8)])
def test_csr_sort_kernels_past_the_precondition(cuda, relation, N, nvl,
                                                used, heavy, deg):
    """The redesigned sort kernels on adversarial tables (-1 padding, ids
    past nvl, a vertex twice in a row, a row of ``heavy`` entries sorted in
    the workspace, rows past deg, empty rows) equal the plain arm; twice,
    the same blocks. VE at nvl 60,000 counts past the shared-memory
    histogram (240 KB), in device memory."""
    rng = np.random.default_rng(N + nvl)
    tab, plain = _adversarial_tables(rng, relation, 2, N, nvl, used, heavy)
    ncol = nvl if relation == "VV" else N
    colg = rng.integers(0, 10 ** 6, (2, ncol)).astype(np.int32)
    L = _sort_route_equals_plain(cuda, relation, tab, colg, nvl, deg,
                                 plain_tab=plain)
    assert int(L.max()) > deg and int((L == 0).sum()) > 0
    if nvl == 60000:
        assert 4 * nvl > segment_relations.smem_limit(cuda)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    t = torch.zeros((1, 4, 4), dtype=torch.int64, device=cuda)
    c = torch.zeros((1, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        segment_relations.relation_entries_cuda("VV", t, t, c, nvl=8, deg=4)
    t = torch.zeros((1, 4, 8), dtype=torch.int32, device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        segment_relations.relation_entries_cuda("VV", t, t, c, nvl=8, deg=4)
    t = torch.zeros((1, 4, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="at least one block"):
        segment_relations.relation_entries_cuda("VV", t, t, c, nvl=8, deg=4,
                                                shares=0)


@pytest.mark.parametrize("workers", [1, 4])
def test_critical_points_on_the_card_equal_the_cpu(cuda, workers):
    _, gale, types, counts = run(16, device="cuda", workers=workers)
    _, _, want, want_counts = run(16, device="cpu")
    np.testing.assert_array_equal(types, want)
    assert counts == want_counts
    assert gale.backend == "cuda"
    assert gale.stats.segments_produced == 2 * len(gale.smesh.I_V[1:])


def _sub_tables(rng, tets):
    """Every edge and face of each segment's valid tets, rows shuffled."""
    out = {"T": tets}
    for k, combos in (("E", [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3),
                             (2, 3)]),
                      ("F", [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)])):
        per = []
        for t in tets:
            t = np.sort(t[(t >= 0).all(-1)], axis=1)
            rows = np.unique(t[:, combos].reshape(-1, len(combos[0])), axis=0)
            per.append(rows[rng.permutation(len(rows))])
        n = max(len(r) for r in per) + 3
        tab = np.full((len(tets), n, len(combos[0])), -1, dtype=np.int32)
        for b, rows in enumerate(per):
            tab[b, :len(rows)] = rows
        out[k] = tab
    return out


@pytest.mark.parametrize("relation,route", [("TT", None), ("FT", "bits"),
                                            ("FT", "sort"), ("EF", "bits"),
                                            ("EF", "sort"), ("ET", "bits"),
                                            ("ET", "sort")])
@pytest.mark.parametrize("B,NT,deg", [(1, 1, 8), (2, 127, 2), (64, 896, 16),
                                      (2, 3001, 8)])
def test_join_kernels_equal_plain_arm(cuda, relation, route, B, NT, deg):
    """TT, and the sub-join on both routes: each launch equals the plain
    arm and moves its counters, and ``route=None`` takes ``entry_route``'s
    choice, the bitmask route. At NT 3001 the subject tables pass NX 8192,
    the sub-join's old one-row limit on an H100, which the bitmask kernel
    now takes in row shares."""
    rng = np.random.default_rng(NT)
    nvl = 256
    tabs = _sub_tables(rng, _rand_tets(rng, B, NT, nvl))
    tx = torch.from_numpy(tabs[relation[0]]).to(cuda)
    ty = torch.from_numpy(tabs[relation[1]]).to(cuda)
    colg = torch.from_numpy(rng.integers(
        0, 10 ** 6, ty.shape[:2]).astype(np.int32)).to(cuda)
    want = ops.relation_block(relation, tx, ty, colg, nvl, deg=deg,
                              backend="torch")
    if relation == "TT":
        before = segment_relations.LAUNCHES["TT"]
        got = ops.relation_block(relation, tx, ty, colg, nvl, deg=deg)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert segment_relations.LAUNCHES["TT"] == before + 1
        return
    fits = segment_relations.entry_route(
        relation, nvl, ty.shape[1], segment_relations.smem_limit(cuda))
    assert fits == "bits"
    for r, call in ((route, lambda: segment_relations.relation_entries_cuda(
            relation, tx, ty, colg, nvl=nvl, deg=deg, route=route)),
                    (fits, lambda: ops.relation_block(relation, tx, ty, colg,
                                                      nvl, deg=deg))):
        before = dict(segment_relations.LAUNCHES)
        got = call()
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert segment_relations.LAUNCHES["sub"] == before["sub"] + 1
        assert segment_relations.LAUNCHES[f"sub_{r}"] == \
            before[f"sub_{r}"] + 1


def test_sub_kernel_is_deterministic_past_its_precondition(cuda):
    """A subject table that lists one face three times (outside the
    arm's precondition): the bitmask kernel gives every entry of the key
    to the largest of the three rows and none to the others, equal blocks
    on two launches, and the plain arm's rows everywhere else."""
    rng = np.random.default_rng(41)
    nvl = 64
    tabs = _sub_tables(rng, _rand_tets(rng, 2, 300, nvl))
    tx, ty = tabs["F"].copy(), tabs["T"]
    tx[:, 40] = tx[:, 3][:, ::-1]
    tx[:, 90] = tx[:, 3]
    tx, ty = (torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
              for a in (tx, ty))
    colg = torch.from_numpy(rng.integers(
        0, 10 ** 6, ty.shape[:2]).astype(np.int32)).to(cuda)
    first = segment_relations.relation_entries_cuda(
        "FT", tx, ty, colg, nvl=nvl, deg=4, route="bits")
    again = segment_relations.relation_entries_cuda(
        "FT", tx, ty, colg, nvl=nvl, deg=4, route="bits")
    want = ops.relation_block("FT", tx, ty, colg, nvl, deg=4,
                              backend="torch")
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    M, L = first
    assert (L[:, 90] > 0).all() and (L[:, [3, 40]] == 0).all()
    assert torch.equal(L[:, [3, 40, 90]].sum(1),
                       want[1][:, [3, 40, 90]].sum(1))
    rest = [i for i in range(tx.shape[1]) if i not in (3, 40, 90)]
    for g, w in zip(first, want):
        assert torch.equal(g[:, rest], w[:, rest])
    # the three rows in three blocks (at most 38 rows a block): each
    # block's lookup still resolves the key to row 90
    for k in (32, 64):
        blocks = segment_relations.bits_blocks(
            "FT", 2, nvl, tx.shape[1], ty.shape[1],
            segment_relations.smem_limit(cuda), 132, k)
        rows = -(-tx.shape[1] // blocks)
        assert len({3 // rows, 40 // rows, 90 // rows}) == 3
        split = segment_relations.relation_entries_cuda(
            "FT", tx, ty, colg, nvl=nvl, deg=4, route="bits", shares=k)
        torch.cuda.synchronize()
        for a, b in zip(split, first):
            assert torch.equal(a, b)


@pytest.mark.parametrize("relation", ["EF", "ET", "FT"])
@pytest.mark.parametrize("NX", [8193, 11520, 18048])
def test_sub_join_past_nx_8192_equals_plain_arm(cuda, relation, NX):
    """Subject tables of 8193, 11,520 (the 48^3 edges at capacity 1024)
    and 18,048 (its faces) rows, cut from or padded to that size, at nvl
    1000 (FT's keys, 2 * nvl^3, stay inside the int32 guard): the wrapper
    takes the bitmask route in row shares, each launch equals the plain
    arm, moves ``sub_bits`` and not ``sub_sort``, and the forced sort
    kernel gives the same blocks."""
    rng = np.random.default_rng(NX)
    nvl = 1000
    tabs = _sub_tables(rng, _rand_tets(rng, 2, 4000, nvl, fill=0.9))
    sx = tabs[relation[0]]
    tx = np.full((2, NX, sx.shape[2]), -1, dtype=np.int32)
    tx[:, :min(NX, sx.shape[1])] = sx[:, :NX]
    tx, ty = (torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
              for a in (tx, tabs[relation[1]]))
    colg = torch.from_numpy(rng.integers(
        0, 10 ** 6, ty.shape[:2]).astype(np.int32)).to(cuda)
    limit = segment_relations.smem_limit(cuda)
    assert segment_relations.entry_route(relation, nvl, ty.shape[1],
                                         limit) == "bits"
    assert segment_relations.bits_blocks(relation, 2, nvl, NX, ty.shape[1],
                                         limit, 132) >= 2
    want = ops.relation_block(relation, tx, ty, colg, nvl, backend="torch")
    before = dict(segment_relations.LAUNCHES)
    got = ops.relation_block(relation, tx, ty, colg, nvl)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert segment_relations.LAUNCHES["sub_bits"] == before["sub_bits"] + 1
    assert segment_relations.LAUNCHES["sub_sort"] == before["sub_sort"]
    assert int(want[1].max()) > 0
    deg = ops.DEFAULT_DEG[relation]
    forced = segment_relations.relation_entries_cuda(
        relation, tx, ty, colg, nvl=nvl, deg=deg, route="sort")
    torch.cuda.synchronize()
    for g, w in zip(forced, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("use_key", [False, True])
@pytest.mark.parametrize("P", [1, 255, 4096])
def test_gather_kernel_equals_plain_arm(cuda, use_key, P):
    rng = np.random.default_rng(P)
    ns, n_global, S, R, degp = 97, 1000, 8, 300, 8
    key = np.unique(rng.integers(0, ns * n_global, 20011))
    inv = [torch.from_numpy(a.astype(np.int32)).to(cuda) for a in
           (key // n_global, key % n_global, rng.integers(0, R, len(key)))]
    pick = rng.integers(0, len(key), P)
    seg = (key[pick] // n_global).astype(np.int32)
    gid = (key[pick] % n_global).astype(np.int32)
    seg[::4] = rng.integers(0, ns + 3, len(seg[::4]))   # absent / past end
    slot = rng.integers(-1, S, P).astype(np.int32)       # -1: padding
    pool_M = torch.from_numpy(rng.integers(
        -1, 10 ** 5, (S, R, degp)).astype(np.int32)).to(cuda)
    pool_L = torch.from_numpy(rng.integers(
        0, degp + 1, (S, R)).astype(np.int32)).to(cuda)
    pairs = [torch.from_numpy(a).to(cuda) for a in (slot, seg, gid)]
    kw = {}
    if use_key:
        kw = dict(inv_key=torch.from_numpy(key.astype(np.int32)).to(cuda),
                  n_global=n_global)
    start = torch.from_numpy(np.searchsorted(
        key // n_global, np.arange(ns + 1)).astype(np.int32)).to(cuda)
    before = completion_gather.LAUNCHES["gather"]
    got = completion_gather.resolve_gather_cuda(pool_M, pool_L, *inv,
                                                *pairs, inv_start=start,
                                                **kw)
    want = completion_gather.resolve_gather_torch(pool_M, pool_L, *inv,
                                                  *pairs, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert completion_gather.LAUNCHES["gather"] == before + 1


def _gather_both_arms(cuda, maps, start, slot, seg, gid, L_fill=None,
                      **kw):
    """The kernel and the plain arm on one synthetic case: equal, and the
    plain arm's answer."""
    rng = np.random.default_rng(len(seg))
    pool_M = rng.integers(-1, 10 ** 5, (4, 40, 4)).astype(np.int32)
    pool_L = rng.integers(0, 5, (4, 40)).astype(np.int32) \
        if L_fill is None else np.full((4, 40), L_fill, np.int32)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in
         (pool_M, pool_L, *maps, slot, seg, gid)]
    if kw.get("inv_key") is not None:
        kw["inv_key"] = torch.from_numpy(kw["inv_key"]).to(cuda)
    got = completion_gather.resolve_gather_cuda(
        *t, inv_start=torch.from_numpy(start).to(cuda), **kw)
    want = completion_gather.resolve_gather_torch(*t, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return want


def _runs(rng, runs, n_global):
    seg = np.concatenate([np.full(n, q) for q, n in runs.items()])
    gid = np.concatenate([np.sort(rng.choice(n_global, n, replace=False))
                          for n in runs.values()])
    key = seg.astype(np.int64) * n_global + gid
    assert key[-1] < 2 ** 31
    row = rng.integers(0, 40, len(seg))
    return ([a.astype(np.int32) for a in (seg, gid, row)],
            key.astype(np.int32))


@pytest.mark.parametrize("use_key", [False, True])
@pytest.mark.parametrize("cut", [None, 1501])
def test_gather_kernel_edge_cases_equal_plain_arm(cuda, use_key, cut):
    """Empty segments, the last segment, segments past the start table and
    below 0, the padding pair, runs of 1 to 3000 gids, and maps cut to an
    odd K inside a run (the whole maps' start table clamped to K)."""
    rng = np.random.default_rng(16)
    n_seg, n_global = 9, 5000
    maps, key = _runs(rng, {0: 3000, 1: 700, 2: 33, 3: 0, 4: 1, 5: 32,
                            6: 200, 7: 0, 8: 1500}, n_global)
    start = np.searchsorted(maps[0], np.arange(n_seg + 1)).astype(np.int32)
    pick = rng.integers(0, len(key), 600)
    seg, gid = maps[0][pick].copy(), maps[1][pick].copy()
    gid[::3] = rng.integers(-1, n_global + 1, len(gid[::3]))
    seg[1:12] = [3, 7, 8, 8, 9, 13, -1, -5, 0, 0, 0]
    gid[1:12] = [5, 0, maps[1][-1], n_global - 1, 0, 3, maps[1][0], 0, -1,
                 maps[1][0], maps[1][2999]]
    slot = rng.integers(-1, 4, 600).astype(np.int32)
    slot[-8:], seg[-8:], gid[-8:] = -1, 0, -1
    K = len(key) if cut is None else cut
    kw = dict(inv_key=key[:K], n_global=n_global) if use_key else {}
    want = _gather_both_arms(cuda, [a[:K] for a in maps], start, slot, seg,
                             gid, **kw)
    assert int((want[1] > 0).sum()) > (100 if cut is None else 20)


def test_gather_kernel_follows_a_key_that_wraps_int32(cuda):
    """On the inv_key arm a combined key past 2**31 wraps onto another
    segment's appearance; the kernel finds what the plain arm finds."""
    rng = np.random.default_rng(17)
    maps, key = _runs(rng, {0: 50, 1: 50, 2040: 50}, 2 ** 20)
    start = np.searchsorted(maps[0], np.arange(4101)).astype(np.int32)
    seg = np.array([4096, 4097, 4096, 2048, 2040, 1, 4099], np.int32)
    gid = np.array([maps[1][0], maps[1][60], 7, maps[1][3], maps[1][120],
                    maps[1][70], 0], np.int32)
    want = _gather_both_arms(cuda, maps, start, np.zeros(7, np.int32), seg,
                             gid, L_fill=4, inv_key=key, n_global=2 ** 20)
    assert want[1].tolist() == [4, 4, 0, 0, 4, 4, 0]


@pytest.mark.parametrize("use_key", [False, True])
@pytest.mark.parametrize("owned", ["none", "half", "all"])
def test_masked_gather_kernel_equals_plain_arm(cuda, use_key, owned):
    """One shard's half of the sharded completion exchange: the gather
    kernel's mask mode (rows of pairs not owned or not resolved set to 0)
    bit for bit the plain arm, for a shard owning no pair, half of them
    and every pair; two halves sum to the unmasked gather's ok rows."""
    rng = np.random.default_rng(40 + use_key)
    ns, n_global, S, R, degp, P = 31, 700, 6, 90, 8, 700
    key = np.unique(rng.integers(0, ns * n_global, 5000))
    inv = [torch.from_numpy(a.astype(np.int32)).to(cuda) for a in
           (key // n_global, key % n_global, rng.integers(0, R, len(key)))]
    pick = rng.integers(0, len(key), P)
    seg = (key[pick] // n_global).astype(np.int32)
    gid = (key[pick] % n_global).astype(np.int32)
    gid[::5] = rng.integers(0, n_global, len(gid[::5]))  # mostly absent
    slot = rng.integers(0, S, P).astype(np.int32)
    slot[-9:] = -1                                       # padding pairs
    own = {"none": np.zeros(P, bool), "all": slot >= 0,
           "half": (slot % 2 == 0) & (slot >= 0)}[owned]
    pool = [torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int32))
            .to(cuda) for lo, hi, shape in ((-1, 10 ** 5, (S, R, degp)),
                                             (0, degp + 1, (S, R)))]
    start = torch.from_numpy(np.searchsorted(
        key // n_global, np.arange(ns + 1)).astype(np.int32)).to(cuda)
    kw = {}
    if use_key:
        kw = dict(inv_key=torch.from_numpy(key.astype(np.int32)).to(cuda),
                  n_global=n_global)
    halves = []
    for mine in (own, ~own & (slot >= 0)):
        pairs = [torch.from_numpy(a).to(cuda) for a in
                 (np.where(mine, slot, -1).astype(np.int32), seg, gid)]
        before = completion_gather.LAUNCHES["gather"]
        got = completion_gather.gather_candidates(
            *pool, *inv, *pairs, backend="cuda", inv_start=start, **kw)
        want = completion_gather.gather_candidates(*pool, *inv, *pairs,
                                                   **kw)
        direct = completion_gather.resolve_gather_cuda(
            *pool, *inv, *pairs, inv_start=start, mask=True, **kw)
        torch.cuda.synchronize()
        assert completion_gather.LAUNCHES["gather"] == before + 2
        for g, d, w in zip(got, direct, want):
            assert torch.equal(g, w) and torch.equal(d, w)
        if not mine.any():
            assert not got[0].any() and not got[1].any()
        halves.append(got)
    full = completion_gather.resolve_gather_cuda(
        *pool, *inv, *(torch.from_numpy(a).to(cuda) for a in
                       (slot, seg, gid)), inv_start=start, **kw)
    ok = (full[1] > 0)
    summed = [a + b for a, b in zip(*halves)]
    assert torch.equal(summed[1], full[1])
    assert torch.equal(summed[0][ok], full[0][ok])


@pytest.mark.parametrize("shards,workers", [(4, 1), (4, 4), (2, 2)])
def test_sharded_engine_on_the_card_equals_the_cpu(cuda, shards, workers):
    """The sharded engine's drivers and completion exchange on the card,
    bit for bit the unsharded CPU run, with shard-pure launches."""
    pre = _grid_pre(12, ("VV", "VE", "VF", "VT", "FT", "TT", "FF"))
    rank = total_order(pre.smesh.scalars)
    rels = ["VV", "VE", "VF", "VT", "FT", "TT", "FF"]
    outs = []
    for device, k in (("cpu", 1), ("cuda", shards)):
        eng = RelationEngine(pre, rels, device=device, shards=k)
        before = completion_gather.LAUNCHES["gather"]
        types, _ = critical_points(eng, pre, rank, workers=workers)
        g = discrete_gradient(eng, pre, rank, co_prefetch=("TT",),
                              workers=workers, audit=True)
        ms = morse_smale(eng, pre, g, workers=workers)
        ff = complete_adjacency(eng, "FF", np.arange(0, pre.n_faces, 3),
                                path="device")
        outs.append((types, g, ms, ff))
        if device == "cuda":
            assert eng.backend == "cuda" and eng.n_shards == shards
            assert completion_gather.LAUNCHES["gather"] > before
            m = eng.merged_shard_stats()
            assert m.segments_produced == eng.stats.segments_produced
            assert m.kernel_launches == eng.stats.kernel_launches
    (t0, g0, ms0, ff0), (t1, g1, ms1, ff1) = outs
    np.testing.assert_array_equal(t1, t0)
    for name in ("pair_v2e", "pair_e2f", "pair_f2t", "crit_v", "crit_e",
                 "crit_f", "crit_t"):
        np.testing.assert_array_equal(getattr(g1, name), getattr(g0, name))
    for name in ("dest_min", "dest_max", "saddle1_ends", "saddle2_ends"):
        np.testing.assert_array_equal(getattr(ms1, name),
                                      getattr(ms0, name))
    for a, b in zip(ff1, ff0):
        np.testing.assert_array_equal(a, b)


def test_tt_kernel_is_deterministic_past_its_precondition(cuda):
    """A table whose faces have three and four cofacet tets: the blocks
    depend on the order of a face's cofacets, which the kernel fixes by
    face lane, so two runs are equal."""
    rng = np.random.default_rng(5)
    tt = _rand_tets(rng, 2, 131, 40)
    tt[:, 0] = [0, 1, 2, 3]
    tt[:, 1:3, :3] = [0, 1, 2]
    tt[:, 1:3, 3] = [[4], [5]]
    tt[1, 3] = [2, 1, 0, 7]
    t = torch.from_numpy(tt).to(cuda)
    colg = torch.from_numpy(
        rng.integers(0, 10 ** 6, (2, 131)).astype(np.int32)).to(cuda)
    first = segment_relations.relation_entries_cuda("TT", t, t, colg,
                                                    nvl=40, deg=8)
    again = segment_relations.relation_entries_cuda("TT", t, t, colg,
                                                    nvl=40, deg=8)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    # tet 1 sits between tets 0 and 2 in face (0, 1, 2)'s lane order
    assert int(first[1][:, 1].min()) >= 2


def test_analyze_on_the_card_equals_the_cpu(cuda):
    _, chi, eng, cp, g, ms = analyze.run(16, device="cuda", workers=2)
    _, _, _, want_cp, want_g, want_ms = analyze.run(16, device="cpu")
    assert cp == want_cp and g.euler() == chi
    for name in ("pair_v2e", "pair_e2f", "pair_f2t", "crit_v", "crit_e",
                 "crit_f", "crit_t"):
        np.testing.assert_array_equal(getattr(g, name),
                                      getattr(want_g, name))
    for name in ("dest_min", "dest_max", "saddle1_ends", "saddle2_ends"):
        np.testing.assert_array_equal(getattr(ms, name),
                                      getattr(want_ms, name))
    assert eng.backend == "cuda"


def _grid_pre(n, relations=("VV", "VT")):
    sm = segment_mesh(structured_grid(n, n, n, scalar_fn=fields.gaussians(
        0, k=4, sigma=3.0, scale=n)), capacity=64)
    return precondition(sm, list(relations))


@pytest.mark.parametrize("relation", ["VV", "VE", "VF", "VT"])
def test_bits_kernels_at_b1_equal_plain_arm(cuda, relation):
    """The localized baselines' launch: one real segment a launch, on the
    bitmask route, bit for bit the plain arm."""
    pre = _grid_pre(12, ("VV", "VE", "VF", "VT"))
    t = pre.tables
    cu = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    arm = "VV" if relation == "VV" else "member"
    for s in range(0, pre.smesh.n_segments, 7):
        T = cu(t.T_local[s:s + 1])
        if relation == "VV":
            tx, ty, colg = T, T, cu(t.LV_global[s:s + 1])
        else:
            ky = relation[1]
            tx = cu(t.table("V")[0][s:s + 1])
            ty = T if ky == "T" else cu(t.table(ky)[0][s:s + 1])
            colg = cu(getattr(t, f"L{ky}_global")[s:s + 1])
        deg = ops.DEFAULT_DEG[relation]
        before = segment_relations.LAUNCHES[f"{arm}_bits"]
        got = segment_relations.relation_entries_cuda(relation, tx, ty, colg,
                                                      nvl=t.NV, deg=deg)
        want = ops.relation_block(relation, tx, ty, colg, t.NV, deg=deg,
                                  backend="torch")
        torch.cuda.synchronize()
        assert segment_relations.LAUNCHES[f"{arm}_bits"] == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("cls", ["TopoClusterDS", "ActopoDS"])
def test_localized_baselines_on_the_card_equal_the_cpu(cuda, cls):
    pre = _grid_pre(16)
    rank = total_order(pre.smesh.scalars)
    ds = getattr(explicit, cls)(pre, ["VV", "VT"])
    assert ds.device.type == "cuda" and ds.engine.backend == "cuda"
    before = dict(segment_relations.LAUNCHES)
    types, counts = critical_points(ds, pre, rank)
    moved = {k: segment_relations.LAUNCHES[k] - before[k] for k in before}
    want, want_counts = critical_points(
        getattr(explicit, cls)(pre, ["VV", "VT"], device="cpu"), pre, rank)
    np.testing.assert_array_equal(types, want)
    assert counts == want_counts
    # one B=1 launch a segment produced, every one on the bitmask route
    st = ds.stats
    assert st.kernel_launches == st.segments_produced
    assert moved["VV_bits"] + moved["member_bits"] == st.kernel_launches
    assert moved["VV_sort"] == moved["member_sort"] == 0


def test_explicit_on_the_card_equals_the_cpu(cuda):
    pre = _grid_pre(16, ("VV", "VE", "VF", "VT", "FT", "TT"))
    rank = total_order(pre.smesh.scalars)
    ex = explicit.ExplicitTriangulation(pre, ["VV", "VT"])
    assert ex.device.type == "cuda"
    cb = ex.get_full_dev_many(("VV", "VT"), [0, 3])
    assert cb.M["VV"].device.type == "cuda" and cb.gid_dev.dtype == \
        torch.int32
    types, counts = critical_points(ex, pre, rank)
    want, want_counts = critical_points(
        explicit.ExplicitTriangulation(pre, ["VV", "VT"], device="cpu"),
        pre, rank)
    np.testing.assert_array_equal(types, want)
    assert counts == want_counts


@pytest.fixture(scope="module")
def share_tables():
    """The bitmask kernels' B=64 inputs on the 48^3 mesh at capacity 64
    (the 96^3 tables' row shapes: NV 256, NE 1280, NF 1920, NT 896) and at
    capacity 1024 (NV 2048, NT 8576: whole masks past the opt-in limit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    out = {}
    for cap, rels in ((64, ("VV", "VE", "VF", "VT", "EF", "ET", "FT")),
                      (1024, ("VV", "VT"))):
        sm = segment_mesh(structured_grid(48, 48, 48,
                                          scalar_fn=fields.gaussians(
                                              0, k=4, sigma=3.0, scale=48)),
                          capacity=cap)
        t = precondition(sm, list(rels)).tables
        cu = lambda a: torch.from_numpy(np.ascontiguousarray(a[:64])) \
            .to("cuda")
        for relation in rels:
            if relation == "VV":
                ins = (cu(t.T_local), cu(t.T_local), cu(t.LV_global))
            else:
                kx, ky = relation
                ins = (cu(t.table(kx)[0]), cu(t.table(ky)[0]),
                       cu(getattr(t, f"L{ky}_global")))
            out[(cap, relation)] = (ins, t.NV)
    return out


@pytest.mark.parametrize("cap,relation", [
    (64, r) for r in ("VV", "VE", "VF", "VT", "EF", "ET", "FT")]
    + [(1024, "VV"), (1024, "VT")])
def test_bits_kernels_equal_at_every_share_count(cuda, share_tables, cap,
                                                 relation):
    """A share count splits a segment's rows over more or fewer blocks,
    never changes a block: at 1, 2, 4, 8 and 16 shares (fewer give way to
    the shared-memory floor on the capacity-1024 tables) the bitmask
    kernel's blocks equal the plain arm's, bit for bit, on the bitmask
    route."""
    (tx, ty, colg), nvl = share_tables[(cap, relation)]
    deg = ops.DEFAULT_DEG[relation]
    arm = {"VV": "VV", "EF": "sub", "ET": "sub", "FT": "sub"}.get(relation,
                                                                  "member")
    want = ops.relation_block(relation, tx, ty, colg, nvl, deg=deg,
                              backend="torch")
    for k in (1, 2, 4, 8, 16):
        before = segment_relations.LAUNCHES[f"{arm}_bits"]
        got = segment_relations.relation_entries_cuda(
            relation, tx, ty, colg, nvl=nvl, deg=deg, route="bits",
            shares=k)
        torch.cuda.synchronize()
        assert segment_relations.LAUNCHES[f"{arm}_bits"] == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w), (relation, cap, k)


def test_tuned_engine_types_equal_the_untuned(cuda, tmp_path):
    """An engine built from a tuning table (batch 16, floor 4) gives the
    untuned engine's types and blocks; its kernel launches are the
    wrappers' launches."""
    from repro_torch.launch import autotune
    pre = _grid_pre(24, ("VV", "VT", "FT"))
    rank = total_order(pre.smesh.scalars)
    path = str(tmp_path / "tune.json")
    cfg = autotune.KernelConfig(batch_max=16, bucket_floor=4)
    autotune.record("cuda", pre.smesh.n_segments, cfg, path=path)
    eng = RelationEngine(pre, ["VV", "VT", "FT"], tune=path)
    assert eng.kernel_config == cfg
    base = RelationEngine(pre, ["VV", "VT", "FT"], tune="off")
    before = dict(segment_relations.LAUNCHES)
    types, counts = critical_points(eng, pre, rank)
    moved = {k: segment_relations.LAUNCHES[k] - before[k] for k in before}
    assert moved["VV"] + moved["member"] == eng.stats.kernel_launches
    want, want_counts = critical_points(base, pre, rank)
    np.testing.assert_array_equal(types, want)
    assert counts == want_counts
    for s in range(0, pre.smesh.n_segments, 17):
        for r in ("VV", "VT", "FT"):
            for a, b in zip(eng.get(r, s), base.get(r, s)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("batch", [3, 8])
def test_fused_batch_with_padding_segments_equals_plain_arm(cuda, batch):
    """vv_counts on the fused loop's batches, the last padded with -1
    segments, bit for bit the plain arm; the extrema equal the CPU's."""
    pre = _grid_pre(13)
    ns = pre.smesh.n_segments
    assert ns % batch, (ns, batch)
    rank = total_order(pre.smesh.scalars)
    T = pipeline.stage_fused(pre, rank, batch)[0]
    last = T[-1]
    assert (last[ns % batch:] == -1).all()
    got = ops.counts_vv(last, pre.tables.NV)
    want = ops.counts_vv(last, pre.tables.NV, backend="torch")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    before = segment_relations.LAUNCHES["vv_counts"]
    mins, maxs = pipeline.fused_extrema(pre, rank, batch=batch)
    assert segment_relations.LAUNCHES["vv_counts"] == before + T.shape[0]
    wmin, wmax = pipeline.fused_extrema(pre, rank, batch=batch, device="cpu")
    np.testing.assert_array_equal(mins, wmin)
    np.testing.assert_array_equal(maxs, wmax)


def test_fused_loop_makes_no_host_sync(cuda):
    pre = _grid_pre(12)
    staged = pipeline.stage_fused(pre, total_order(pre.smesh.scalars), 8)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        mins, maxs = pipeline.fused_masks(*staged)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert mins.shape == maxs.shape


def test_analyze_mesh_on_the_card_equals_the_cpu(cuda):
    _, rows = analyze_mesh.run("toy", device="cuda")
    _, want = analyze_mesh.run("toy", device="cpu")
    for label in ("GALE", "Explicit"):
        for key in ("critical", "gradient", "ms", "persistence", "digest"):
            assert rows[label][key] == want[label][key], (label, key)
    assert rows["GALE"]["ds"].backend == "cuda"


def _rand_simplices(rng, B, N, arity, nvl, fill=0.8):
    tab = np.full((B, N, arity), -1, dtype=np.int32)
    n = max(1, int(N * fill)) if N else 0
    for b in range(B):
        tab[b, :n] = np.argsort(rng.random((n, nvl)), axis=1)[:, :arity]
    return tab


@pytest.mark.parametrize("ax,ay", [(1, 4), (2, 2), (3, 3), (3, 4)])
@pytest.mark.parametrize("B,NX,NY,nvl", [(1, 1, 7, 16), (3, 127, 131, 256),
                                         (64, 1920, 1920, 256),
                                         (2, 1931, 1283, 2 ** 11)])
def test_meet_kernel_equals_plain_arm(cuda, ax, ay, B, NX, NY, nvl):
    rng = np.random.default_rng(NX + ax)
    tx = torch.from_numpy(_rand_simplices(rng, B, NX, ax, nvl)).to(cuda)
    ty = torch.from_numpy(_rand_simplices(rng, B, NY, ay, nvl)).to(cuda)
    before = segment_relations.LAUNCHES["meet"]
    got = ops.counts_meet(tx, ty)
    want = ops.counts_meet(tx, ty, backend="torch")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert segment_relations.LAUNCHES["meet"] == before + 1


@pytest.mark.parametrize("B,NT,nvl", [(1, 1, 8), (3, 127, 64),
                                      (64, 896, 256), (2, 1931, 257),
                                      (2, 131, 200), (8, 896, 256),
                                      (1, 896, 256), (8, 300, 37),
                                      (4, 2100, 131)])
def test_vv_counts_kernel_equals_plain_arm(cuda, B, NT, nvl):
    """The VV count kernel at the wrapper's row tiles and at each forced
    one (8, 16, 32 rows): the fused extrema loop's batch (B 8, NT 896),
    one segment, nvl 37 and 131 (no multiple of a tile, nor of 4: scalar
    stores), more tets than one stage (2100), ids past nvl, and from B 4
    the same batch ending in three -1 padding segments."""
    rng = np.random.default_rng(NT)
    # ids up to 256: with nvl=200 some lie past nvl and count nowhere
    tt = torch.from_numpy(_rand_tets(rng, B, NT, max(nvl, 257))).to(cuda)
    before = segment_relations.LAUNCHES["vv_counts"]
    got = ops.counts_vv(tt, nvl)
    want = ops.counts_vv(tt, nvl, backend="torch")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert segment_relations.LAUNCHES["vv_counts"] == before + 1
    for rows in segment_relations.VV_COUNT_ROWS:
        tiled = segment_relations.relation_counts_vv_cuda(tt, nvl, rows=rows)
        torch.cuda.synchronize()
        assert torch.equal(tiled, want)
    if B >= 4:
        padded = tt.clone()
        padded[B - 3:] = -1
        got = ops.counts_vv(padded, nvl)
        want = ops.counts_vv(padded, nvl, backend="torch")
        torch.cuda.synchronize()
        assert torch.equal(got, want) and not got[B - 3:].any()


@pytest.mark.parametrize("relation", ["FF", "EE", "TT", "VV"])
def test_dense_blocks_on_the_card_equal_plain_arm(cuda, relation):
    rng = np.random.default_rng(len(relation))
    nvl = 64
    a = {"F": 3, "E": 2, "T": 4, "V": 4}[relation[0]]
    tab = torch.from_numpy(_rand_simplices(rng, 4, 300, a, nvl)).to(cuda)
    N = nvl if relation == "VV" else 300
    colg = torch.from_numpy(
        rng.integers(0, 10 ** 6, (4, N)).astype(np.int32)).to(cuda)
    got = ops.relation_block(relation, tab, tab, colg, nvl, deg=16,
                             assembly="dense")
    want = ops.relation_block(relation, tab, tab, colg, nvl, deg=16,
                              backend="torch", assembly="dense")
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_count_wrappers_reject_what_the_kernels_do_not_take(cuda):
    t = torch.zeros((1, 4, 5), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="arities"):
        segment_relations.relation_counts_meet_cuda(t, t)
    t = torch.zeros((1, 4, 8), dtype=torch.int32, device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        segment_relations.relation_counts_vv_cuda(t, 8)


@pytest.mark.parametrize("assembly", ["sparse", "dense"])
def test_analyze_audit_persistence_on_the_card_equals_the_cpu(cuda,
                                                               assembly):
    from repro_torch.algorithms.critical_points import total_order
    from repro_torch.algorithms.discrete_gradient import audit_gradient
    from repro_torch.algorithms.persistence import persistence_pairs

    out = {}
    for device in ("cuda", "cpu"):
        pre, _, eng, cp, g, ms = analyze.run(12, device=device, audit=True,
                                             assembly=assembly)
        d = persistence_pairs(eng, pre, total_order(pre.smesh.scalars),
                              grad=g)
        out[device] = (cp, audit_gradient(eng, pre, g), d.digest(),
                       ms.counts())
    assert out["cuda"] == out["cpu"]
    assert not any(out["cuda"][1].values())



@pytest.mark.parametrize("B,S,T,H,KV,hd,causal,dtype,odd", [
    (2, 128, 128, 4, 4, 64, True, torch.float32, False),
    (1, 100, 150, 28, 4, 128, True, torch.bfloat16, False),
    (1, 150, 100, 8, 1, 80, False, torch.float32, False),
    (2, 1, 37, 4, 2, 256, True, torch.bfloat16, False),
    (1, 1000, 1500, 8, 8, 28, False, torch.float32, False),
    # the wgmma kernel (bf16, hd 64/128/256): GQA 8/1 and 28/4, MHA,
    # ragged S and T both ways, S != T causal, S=1, partial key tiles
    (2, 130, 130, 8, 1, 64, True, torch.bfloat16, False),
    (2, 130, 130, 8, 1, 64, False, torch.bfloat16, False),
    (1, 1000, 1500, 28, 4, 128, True, torch.bfloat16, False),
    (1, 1000, 1500, 28, 4, 128, False, torch.bfloat16, False),
    (1, 1500, 1000, 28, 4, 128, True, torch.bfloat16, False),
    (1, 1500, 1000, 4, 4, 128, False, torch.bfloat16, False),
    (2, 200, 200, 16, 16, 256, True, torch.bfloat16, False),
    (1, 300, 77, 8, 2, 256, False, torch.bfloat16, False),
    (2, 1, 1500, 8, 8, 64, False, torch.bfloat16, False),
    (2, 1, 37, 28, 4, 128, True, torch.bfloat16, False),
    # the mma kernel: hd 16, 28, 80 and 256 in both dtypes (bf16 hd 256
    # from a base one element off, which TMA cannot read), ragged tiles
    (2, 130, 130, 4, 2, 16, True, torch.float32, False),
    (1, 100, 150, 4, 2, 16, False, torch.bfloat16, False),
    (1, 150, 100, 28, 4, 28, True, torch.float32, False),
    (2, 130, 130, 8, 8, 28, True, torch.bfloat16, False),
    (1, 333, 200, 28, 4, 80, True, torch.float32, False),
    (1, 200, 333, 4, 4, 80, False, torch.bfloat16, False),
    (1, 200, 300, 8, 2, 256, True, torch.float32, False),
    (1, 300, 200, 8, 2, 256, False, torch.float32, False),
    (1, 200, 200, 4, 4, 256, True, torch.bfloat16, True),
    (1, 1500, 1000, 28, 4, 128, True, torch.float32, False),
    # head dims short of their bucket (40 -> 64, 100 -> 128, 200 -> 256),
    # the columns past hd zero-filled
    (1, 130, 200, 4, 2, 40, True, torch.float32, False),
    (1, 200, 130, 4, 4, 100, False, torch.bfloat16, False),
    (1, 150, 150, 8, 2, 200, True, torch.float32, False),
])
def test_flash_kernel_equals_plain(cuda, B, S, T, H, KV, hd, causal, dtype,
                                   odd):
    g = torch.Generator(device=cuda).manual_seed(S + T)
    shapes = ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd))
    if odd:      # each tensor one element past a 16-byte aligned base
        q, k, v = (torch.randn(math.prod(s) + 1, device=cuda, generator=g)
                   .to(dtype)[1:].view(s) for s in shapes)
    else:
        q, k, v = (torch.randn(s, device=cuda, generator=g).to(dtype)
                   for s in shapes)
    variant = "wgmma" if dtype == torch.bfloat16 and hd in (64, 128, 256) \
        and not odd else "mma"
    before = dict(flash_attention.LAUNCHES)
    got = flash_attention.flash_attention(q, k, v, causal=causal)
    want = flash_attention.flash_attention(q, k, v, causal=causal,
                                           backend="torch")
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES["flash"] == before["flash"] + 1
    assert flash_attention.LAUNCHES[f"flash_{variant}"] == \
        before[f"flash_{variant}"] + 1
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_kernel_reads_strided_views(cuda):
    """q/k/v as views with unit stride along hd only: read in place, and
    the same result as their contiguous copies; the bh layout too."""
    g = torch.Generator(device=cuda).manual_seed(1)
    big = torch.randn((2, 70, 12, 64), device=cuda, generator=g)
    q, k, v = big[:, :, 0:8], big[:, :50, 8:10], big[:, :50, 10:12]
    assert not q.is_contiguous()
    got = flash_attention.flash_attention_cuda(q, k, v, causal=True)
    want = flash_attention.flash_attention_cuda(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    qb = big[:, :, 0].contiguous()
    torch.testing.assert_close(
        flash_attention.flash_attention_bh(qb, qb, qb, causal=False),
        flash_attention.flash_attention_bh(qb, qb, qb, causal=False,
                                           backend="torch"),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_mma_element_loads_equal_16_byte_loads(cuda, hd):
    """float32 heads of a fused buffer whose head stride (hd + 1 elements)
    is no multiple of 16 bytes take the mma kernel's element loads: within
    2e-5 of the plain version and bit for bit the 16-byte loads' result on
    contiguous copies."""
    g = torch.Generator(device=cuda).manual_seed(hd)
    big = torch.randn((2, 333, 12, hd + 1), device=cuda, generator=g)
    q, k, v = (big[:, :, :8, :hd], big[:, :300, 8:10, :hd],
               big[:, :300, 10:12, :hd])
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    assert not flash_attention.vec_loads(k, v)
    assert flash_attention.vec_loads(kc, vc)
    before = flash_attention.LAUNCHES["flash_mma"]
    got = flash_attention.flash_attention_cuda(q, k, v, causal=True)
    vec = flash_attention.flash_attention_cuda(qc, kc, vc, causal=True)
    assert flash_attention.LAUNCHES["flash_mma"] == before + 2
    torch.testing.assert_close(got, vec, rtol=0, atol=0)
    torch.testing.assert_close(
        got, flash_attention.flash_attention_ref(q, k, v), rtol=2e-5,
        atol=2e-5)


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 128),
                                      (torch.float32, 256),
                                      (torch.bfloat16, 80)])
def test_flash_mma_is_deterministic(cuda, dtype, hd):
    """The same inputs launched twice give the same output bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn(s, device=cuda, generator=g).to(dtype)
               for s in ((2, 700, 28, hd), (2, 700, 4, hd),
                         (2, 700, 4, hd)))
    before = flash_attention.LAUNCHES["flash_mma"]
    a = flash_attention.flash_attention_cuda(q, k, v, causal=True)
    b = flash_attention.flash_attention_cuda(q, k, v, causal=True)
    assert flash_attention.LAUNCHES["flash_mma"] == before + 2
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,hd,causal", [(torch.float32, 64, True),
                                             (torch.float32, 128, False),
                                             (torch.bfloat16, 80, True)])
def test_flash_simt_by_force_equals_plain(cuda, dtype, hd, causal):
    """The SIMT kernel is on no route; ``simt=True`` still launches it, and
    it still holds its tolerance."""
    g = torch.Generator(device=cuda).manual_seed(hd)
    q, k, v = (torch.randn(s, device=cuda, generator=g).to(dtype)
               for s in ((1, 150, 8, hd), (1, 100, 2, hd), (1, 100, 2, hd)))
    before = dict(flash_attention.LAUNCHES)
    got = flash_attention.flash_attention_cuda(q, k, v, causal=causal,
                                               simt=True)
    assert flash_attention.LAUNCHES["flash_simt"] == \
        before["flash_simt"] + 1
    assert flash_attention.LAUNCHES["flash_mma"] == before["flash_mma"]
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(
        got.float(), flash_attention.flash_attention_ref(
            q, k, v, causal=causal).float(), rtol=tol, atol=tol)


def test_flash_wgmma_reads_strided_views(cuda):
    """bf16 views whose strides TMA takes run the wgmma kernel in place,
    bit for bit like their contiguous copies; a sequence stride that is no
    multiple of 16 bytes goes to the mma kernel."""
    g = torch.Generator(device=cuda).manual_seed(2)
    big = torch.randn((2, 300, 12, 128), device=cuda,
                      generator=g).to(torch.bfloat16)
    q, k, v = big[:, :, 0:8], big[:, :250, 8:10], big[:, :250, 10:12]
    assert not q.is_contiguous()
    before = flash_attention.LAUNCHES["flash_wgmma"]
    got = flash_attention.flash_attention_cuda(q, k, v, causal=True)
    want = flash_attention.flash_attention_cuda(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    assert flash_attention.LAUNCHES["flash_wgmma"] == before + 2
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(
        got.float(), flash_attention.flash_attention_ref(q, k, v).float(),
        rtol=2e-2, atol=2e-2)
    odd = torch.randn((1, 90, 2 * 128 + 4), device=cuda,
                      generator=g).to(torch.bfloat16)
    t = odd[..., :256].unflatten(-1, (2, 128))     # 520-byte row stride
    before = flash_attention.LAUNCHES["flash_mma"]
    got = flash_attention.flash_attention_cuda(t, t, t, causal=False)
    assert flash_attention.LAUNCHES["flash_mma"] == before + 1
    torch.testing.assert_close(
        got.float(), flash_attention.flash_attention_ref(
            t, t, t, causal=False).float(), rtol=2e-2, atol=2e-2)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((1, 4, 2, 16), device=cuda)
    with pytest.raises(TypeError, match="float32 or bf16"):
        flash_attention.flash_attention_cuda(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="unit stride"):
        t = torch.zeros((1, 4, 2, 32), device=cuda)[..., ::2]
        flash_attention.flash_attention_cuda(t, t, t)
    with pytest.raises(ValueError, match="T >= 1"):
        flash_attention.flash_attention_cuda(q, q[:, :0], q[:, :0])
    with pytest.raises(ValueError, match="head dim"):
        t = torch.zeros((1, 4, 1, 320), device=cuda)
        flash_attention.flash_attention_cuda(t, t, t)


@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma-7b", "whisper-base"])
def test_lm_prefill_and_decode_on_the_card_equal_the_cpu(cuda, arch):
    """A float32 smoke config: prefill on both attention arms of the card
    and on the CPU, the flash kernel once per attention without a cache,
    and two decode steps."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              dtype="float32")
    model = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = lm.build(cfg, cuda)
    on_card.load_state_dict(model.state_dict())
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (2, 75), dtype=np.int32))}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(
            rng.normal(0, 1, (2, 90, cfg.d_model)).astype(np.float32))
    want, _ = lm.prefill_fn(model, batch, cfg)
    card = {k: t.to(cuda) for k, t in batch.items()}
    before = flash_attention.LAUNCHES["flash"]
    got, _ = lm.prefill_fn(on_card, card, cfg)
    torch.cuda.synchronize()
    per_call = cfg.n_layers if cfg.family == "dense" else \
        cfg.enc_layers + 2 * cfg.n_layers
    assert flash_attention.LAUNCHES["flash"] == before + per_call
    plain, _ = lm.prefill_fn(on_card, card, cfg, backend="torch")
    for g in (got, plain):
        torch.testing.assert_close(g.cpu(), want, rtol=1e-4, atol=1e-4)
    if cfg.family == "dense":
        prompts = rng.integers(0, cfg.vocab, (2, 6), dtype=np.int32)
        np.testing.assert_array_equal(
            serve.generate(cfg, on_card, prompts, 5, 16),
            serve.generate(cfg, model, prompts, 5, 16))


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "granite-moe-3b-a800m",
                                  "phi3.5-moe-42b-a6.6b", "mamba2-130m",
                                  "zamba2-2.7b"])
def test_lm_family_prefill_on_the_card_equals_the_cpu(cuda, arch):
    """The vlm, moe, ssm and hybrid smoke configs in float32: prefill on
    both arms of the card equal to the CPU's (the flash kernel once per
    attention without a cache on the kernels' arm: none for the ssm, one
    per group for the hybrid), the moe's expert choices equal on all
    three, the ssm's prefill states too, and generate equal to the
    CPU's."""
    from repro_torch.models import moe
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              dtype="float32")
    model = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = lm.build(cfg, cuda)
    on_card.load_state_dict(model.state_dict())
    rng = np.random.default_rng(0)
    S = 64 if cfg.family in ("ssm", "hybrid") else 75
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (2, S), dtype=np.int32))}
    if cfg.family == "vlm":
        nv = cfg.n_vision_tokens
        batch["vision_embeds"] = torch.from_numpy(
            rng.normal(0, 1, (2, nv, cfg.d_model)).astype(np.float32))
        g = int(math.isqrt(nv))
        h, w = np.divmod(np.arange(nv), g)
        pos = np.concatenate([np.stack([0 * h, h, w]),
                              np.tile(g + np.arange(S), (3, 1))], 1)
        batch["positions3d"] = torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(pos[:, None], (3, 2, nv + S))).astype(np.int32))
    routed = []
    route = moe.route

    def recording(p, x, c):
        gates, eidx = route(p, x, c)
        routed.append(eidx.cpu())
        return gates, eidx
    moe.route = recording
    try:
        want, wstate = lm.prefill_fn(model, batch, cfg)
        card = {k: t.to(cuda) for k, t in batch.items()}
        before = flash_attention.LAUNCHES["flash"]
        got, gstate = lm.prefill_fn(on_card, card, cfg)
        torch.cuda.synchronize()
        per_call = {"ssm": 0, "hybrid": cfg.n_layers // max(
            cfg.attn_every, 1)}.get(cfg.family, cfg.n_layers)
        assert flash_attention.LAUNCHES["flash"] == before + per_call
        plain, _ = lm.prefill_fn(on_card, card, cfg, backend="torch")
    finally:
        moe.route = route
    for g in (got, plain):
        torch.testing.assert_close(g.cpu(), want, rtol=1e-4, atol=1e-4)
    if cfg.family == "moe":
        L = cfg.n_layers
        assert len(routed) == 3 * L
        for i in range(L):
            assert torch.equal(routed[i], routed[L + i])
            assert torch.equal(routed[i], routed[2 * L + i])
    if cfg.family == "ssm":
        for g, w in zip(gstate, wstate):
            torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)
    prompts = rng.integers(0, cfg.vocab, (2, 6), dtype=np.int32)
    np.testing.assert_array_equal(
        serve.generate(cfg, on_card, prompts, 5, 16),
        serve.generate(cfg, model, prompts, 5, 16))


@pytest.mark.parametrize("config, H, KV, hd, variant", [
    ("granite-moe-3b-a800m", 24, 8, 64, "wgmma"),
    ("zamba2-2.7b", 32, 32, 80, "mma")])
def test_flash_kernel_at_the_new_path_shapes(cuda, config, H, KV, hd,
                                             variant):
    """bf16 prefill attention of granite-moe-3b (GQA 24/8, hd 64) and
    zamba2-2.7b (MHA 32, hd 80), causal at S 1000: the kernel the routing
    names, against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((2, 1000, H, hd), device=cuda, generator=g).bfloat16()
    k, v = (torch.randn((2, 1000, KV, hd), device=cuda,
                        generator=g).bfloat16() for _ in range(2))
    before = dict(flash_attention.LAUNCHES)
    got = flash_attention.flash_attention(q, k, v, causal=True)
    assert flash_attention.LAUNCHES[f"flash_{variant}"] == \
        before[f"flash_{variant}"] + 1
    torch.testing.assert_close(
        got.float(), flash_attention.flash_attention_ref(q, k, v).float(),
        rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch, head_dim, variant", [
    ("gemma-7b", 256, "wgmma"), ("command-r-35b", None, "mma"),
    ("phi3.5-moe-42b-a6.6b", None, "mma")])
def test_bf16_smoke_configs_agree_on_both_arms(cuda, arch, head_dim,
                                               variant):
    """The configured bf16 smoke configs of gemma-7b (at head dim 256,
    which sends its prefill to ``flash_fwd_wgmma``), command-r-35b and
    phi3.5-moe (hd 16: ``flash_fwd_mma``): the kernels' arm's last-position
    logits within ``chip_smoke.LM_ARM_TOL`` of the largest of the torch
    arm's, every flash launch on the routed kernel, once per layer."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from chip_smoke import LM_ARM_TOL
    cfg = configs.get_smoke_config(arch)
    assert cfg.dtype == "bfloat16"
    if head_dim:
        cfg = dataclasses.replace(cfg, head_dim=head_dim)
    model = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = lm.build(cfg, cuda)
    on_card.load_state_dict(model.state_dict())
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 75),
                                               dtype=np.int32)
    batch = {"tokens": torch.from_numpy(tokens).to(cuda)}
    before = dict(flash_attention.LAUNCHES)
    got, _ = lm.prefill_fn(on_card, batch, cfg, backend="cuda")
    torch.cuda.synchronize()
    n = {k: flash_attention.LAUNCHES[k] - before[k] for k in before}
    want = {k: 0 for k in before}
    want.update({"flash": cfg.n_layers, f"flash_{variant}": cfg.n_layers})
    assert n == want
    plain, _ = lm.prefill_fn(on_card, batch, cfg, backend="torch")
    assert got.dtype == plain.dtype == torch.bfloat16
    diff = float((got.float() - plain.float()).abs().max())
    assert diff <= LM_ARM_TOL * float(plain.float().abs().max())


# -- training: the flash kernels' gradient, a train step -------------------

_TRAIN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H, KV, hd, dtype, variant", [
    (28, 4, 128, torch.bfloat16, "wgmma"),
    (32, 32, 80, torch.bfloat16, "mma"),
    (8, 2, 80, torch.float32, "mma")])
def test_flash_trainable_gradient_equals_the_plain_one(cuda, causal, H, KV,
                                                       hd, dtype, variant):
    """The autograd Function with the kernel as its forward: the kernel
    the routing names runs once, its output matches the plain version's,
    and (dq, dk, dv) equal autograd through the plain version (float32
    2e-5, bf16 2e-2 of each gradient's largest entry); GQA and MHA, S past
    one 1024-row chunk of the backward."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((2, 1100, H, hd), device=cuda, generator=g).to(dtype)
    k, v = (torch.randn((2, 1100, KV, hd), device=cuda, generator=g)
            .to(dtype) for _ in range(2))
    dout = torch.randn((2, 1100, H, hd), device=cuda, generator=g).to(dtype)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = dict(flash_attention.LAUNCHES)
    out = layers.flash_attention_trainable(q, k, v, causal=causal)
    assert flash_attention.LAUNCHES[f"flash_{variant}"] == \
        before[f"flash_{variant}"] + 1
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert flash_attention.LAUNCHES["flash"] == before["flash"] + 1
    ref = flash_attention.flash_attention_ref(q, k, v, causal=causal)
    want = torch.autograd.grad(ref, (q, k, v), dout)
    tol = _TRAIN_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), rtol=tol,
                                   atol=tol * scale)


def _flash_calls(cfg) -> int:
    """Flash-attention calls in one forward of ``cfg``'s model: each
    attention without a cache (the hybrid's shared block once a group;
    encdec's encoder, decoder and cross attention)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "encdec":
        return cfg.enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


# one smoke arch per family (deepseek-7b: dense), each in the dtypes its
# kernels serve: gemma-7b's at hd 256 in bf16 is flash_fwd_wgmma's. The moe
# in float32 only: in bf16 the arms' attention outputs differ in the last
# bits, enough to flip a token's expert choice. The tolerances are
# tests/_train_tol.py's: the dtype's, the hybrid's scaled by its measured
# conditioning (float32) or by the spread of two correct arms (bf16).
_TRAIN_ARCHS = [("deepseek-7b", "float32"), ("deepseek-7b", "bfloat16"),
                ("qwen2-vl-7b", "float32"), ("qwen2-vl-7b", "bfloat16"),
                ("granite-moe-3b-a800m", "float32"),
                ("zamba2-2.7b", "float32"), ("zamba2-2.7b", "bfloat16"),
                ("whisper-base", "float32"), ("whisper-base", "bfloat16"),
                ("gemma-7b", "bfloat16")]


@pytest.mark.parametrize("arch, dtype", _TRAIN_ARCHS)
def test_train_step_on_the_card_equals_the_torch_arm(cuda, arch, dtype):
    """One make_train_step of a smoke config on the kernels' arm and on
    the plain arm of the card from the same float32 masters: the flash
    kernel once per attention call, the loss and every gradient within
    float32 2e-5 / bf16 2e-2 of the plain arm's, every updated parameter
    too, plus 2 lr: AdamW's first step moves a weight by lr * sign(g), so
    a gradient entry near zero whose sign differs between the arms moves
    its weight 2 lr apart. The vlm trains through M-RoPE, the moe through
    the index_add_ backward, the hybrid through its shared block's summed
    gradient (at ``_train_tol.tolerance``: its recurrence amplifies the
    attention's rounding), encdec through non-causal cross attention, and
    gemma-7b (its head dim set to the full config's 256) through
    flash_fwd_wgmma."""
    from _train_tol import tolerance
    from repro_torch.launch import steps, train
    from repro_torch.optim import adamw
    from repro_torch.data.tokens import SyntheticTokens
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype)
    if arch == "gemma-7b":
        cfg = dataclasses.replace(cfg, head_dim=256)
    model = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                           torch.float32)
    batch = train.train_batch(cfg, SyntheticTokens(cfg.vocab).batch(
        0, 2, 128), cuda)
    tol = tolerance(arch, dtype)
    out = {}
    for backend in ("cuda", "torch"):
        on_card = lm.build(cfg, cuda, torch.float32)
        on_card.load_state_dict(model.state_dict())
        before = dict(flash_attention.LAUNCHES)
        loss, grads = steps.loss_and_grads(on_card, batch, cfg, backend)
        torch.cuda.synchronize()
        ran = {k: flash_attention.LAUNCHES[k] - before[k]
               for k in before}
        assert ran["flash"] == (_flash_calls(cfg) if backend == "cuda"
                                else 0), ran
        if arch == "gemma-7b" and backend == "cuda":
            assert ran["flash_wgmma"] == ran["flash"], ran
        opt = adamw.AdamWConfig(total_steps=4)
        step = steps.make_train_step(cfg, opt, backend)
        state = adamw.init_state(dict(on_card.named_parameters()), opt)
        step(on_card, state, batch)
        out[backend] = (loss, grads, dict(on_card.named_parameters()))
    lr = float(adamw.schedule(1, adamw.AdamWConfig(total_steps=4)))
    (lc, gc, pc), (lt, gt, pt) = out["cuda"], out["torch"]
    assert abs(float(lc) - float(lt)) <= tol * abs(float(lt))
    for name, g in gt.items():
        assert bool(gc[name].any()), name
        torch.testing.assert_close(gc[name], g, rtol=tol,
                                   atol=tol * float(g.abs().max()))
        torch.testing.assert_close(
            pc[name], pt[name], rtol=tol,
            atol=tol * float(pt[name].abs().max()) + 2 * lr)


# -- fault recovery on the card (docs/DESIGN.md §12) -------------------------

@pytest.mark.parametrize("relation", sorted(ops.DEFAULT_DEG))
def test_host_arm_equals_the_kernels(cuda, relation):
    """The breaker's numpy host arm gives the kernels' blocks (both
    assemblies: the entry, TT and sub-join kernels, and the meet and VV
    count kernels) bit for bit on a small mesh, rows past deg included."""
    pre = _grid_pre(12, ("VV", "VE", "VF", "VT", "FT", "TT"))
    t = pre.tables
    if relation == "VV":
        tabs = (t.T_local, t.T_local, t.LV_global)
    else:
        tabs = (t.table(relation[0])[0], *t.table(relation[1]))
    cu = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in tabs]
    for deg in (None, 1):
        hM, hL = ops.relation_block_host(relation, *tabs, t.NV, deg=deg)
        for assembly in ("sparse", "dense"):
            M, L = ops.relation_block(relation, *cu, t.NV, deg=deg,
                                      backend="cuda", assembly=assembly)
            np.testing.assert_array_equal(M.cpu().numpy(), hM)
            np.testing.assert_array_equal(L.cpu().numpy(), hL)


def test_watchdog_reclaims_an_injected_hang_on_a_cuda_event(cuda):
    """A launch held un-ready for 5 s past its CUDA event is failed by the
    0.05 s watchdog and re-dispatched: the blocks equal the CPU engine's,
    well inside the hang, and no launch degrades to the host arm."""
    from repro_torch.core.faults import FaultInjector, FaultPolicy, \
        FaultSpec
    pre = _grid_pre(12)
    cpu = RelationEngine(pre, ["VV", "VT"], device="cpu", lookahead=0,
                         batch_max=4)
    inj = FaultInjector([FaultSpec(kind="sync", relation="VV", hang_s=5.0,
                                   count=1)])
    eng = RelationEngine(pre, ["VV", "VT"], device="cuda", lookahead=0,
                         batch_max=4, fault_policy=FaultPolicy(
                             injector=inj, sync_timeout_s=0.05,
                             sync_poll_s=0.005))
    t0 = time.perf_counter()
    for r in ("VV", "VT"):
        for s in range(pre.smesh.n_segments):
            for a, b in zip(eng.get(r, s), cpu.get(r, s)):
                np.testing.assert_array_equal(a, b)
    assert time.perf_counter() - t0 < 5.0
    st = eng.stats
    assert st.sync_timeouts >= 1 and st.failed_launches == 1
    assert st.degraded_launches == 0 and len(inj.injected) == 1


def test_device_loss_on_one_card_leaves_blocks_bit_identical(cuda):
    """shards=2 on one card, shard 0 lost at its first launch: it is
    re-homed onto shard 1's pool (same card), and every block and the
    drivers' results equal the CPU engine's."""
    from repro_torch.core.faults import FaultInjector, FaultPolicy, \
        FaultSpec
    pre = _grid_pre(12, ("VV", "VE", "VF", "VT", "FT", "TT"))
    rank = total_order(pre.smesh.scalars)
    rels = ["VV", "VE", "VF", "VT", "FT", "TT"]
    inj = FaultInjector([FaultSpec(kind="device-lost", shard=0, count=1)])
    eng = RelationEngine(pre, rels, device="cuda", shards=2,
                         fault_policy=FaultPolicy(injector=inj))
    cpu = RelationEngine(pre, rels, device="cpu")
    outs = []
    for e in (eng, cpu):
        types, _ = critical_points(e, pre, rank, workers=2)
        g = discrete_gradient(e, pre, rank, co_prefetch=("TT",), workers=2)
        outs.append((types, g, morse_smale(e, pre, g, workers=2)))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    for name in ("pair_v2e", "pair_e2f", "pair_f2t"):
        np.testing.assert_array_equal(getattr(outs[0][1], name),
                                      getattr(outs[1][1], name))
    for name in ("dest_min", "dest_max", "saddle1_ends", "saddle2_ends"):
        np.testing.assert_array_equal(getattr(outs[0][2], name),
                                      getattr(outs[1][2], name))
    assert eng.stats.shards_lost == 1 and list(eng.store._route) == [1, 1]
    lo, hi = eng.shard_plan.shard_bounds(0)
    assert eng.stats.rehomed_segments == hi - lo
    for r in rels:
        for s in (lo, hi - 1, hi):
            for a, b in zip(eng.get(r, s), cpu.get(r, s)):
                np.testing.assert_array_equal(a, b)
