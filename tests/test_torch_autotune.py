"""The port's kernel-parameter autotuning (``repro_torch.launch.autotune``,
``RelationEngine(tune=)``) against the reference's
(``tests/test_kernel_parity.py``'s round trip): the table round trip, the
resolution order (explicit argument > table > built-in default), ``tune=
"off"`` and a corrupt, stale or reference-format table giving the defaults,
a tuned engine's blocks equal to an untuned one's, and the port's engine
equal to the reference's (blocks and ``EngineStats``, key for key) under
the same ``batch_max`` and ``bucket_floor``; the ranking's determinism, the
pick of a winner against the repeats' spread and the bitmask grids' share
arithmetic; and the H100 roofline model (``launch/roofline.py``)
giving the bounds of ``PERF.md`` §6 from shapes alone. Plain torch arm on
the CPU."""

import json

import numpy as np
import pytest

from repro.algorithms import fields as ref_fields
from repro.core.engine import RelationEngine as RefEngine
from repro.core.mesh import segment_mesh as ref_segment_mesh
from repro.core.segtables import precondition as ref_precondition
from repro.data.meshgen import structured_grid as ref_structured_grid
from repro.launch import autotune as ref_autotune
from repro_torch.algorithms import fields
from repro_torch.core.engine import RelationEngine
from repro_torch.core.mesh import segment_mesh
from repro_torch.core.segtables import precondition
from repro_torch.data.meshgen import structured_grid
from repro_torch.kernels import ops
from repro_torch.kernels import segment_relations as sr
from repro_torch.launch import autotune, roofline

RELS = ["VV", "VT", "FT"]
# the 96^3 quickstart mesh's segment tables at capacity 64, and the 48^3
# mesh's at capacity 1024 (chip_smoke.py phases 2 and 4)
SHAPES_96 = {"NV": 256, "NE": 1280, "NF": 1920, "NT": 896}
BIG_NV, BIG_NT = 2048, 8576


def _mesh(grid, flds):
    return grid(12, 12, 12, scalar_fn=flds.gaussians(0, k=4, sigma=3.0,
                                                      scale=12))


@pytest.fixture(scope="module")
def pres():
    ref = ref_precondition(ref_segment_mesh(
        _mesh(ref_structured_grid, ref_fields), capacity=64), RELS)
    port = precondition(segment_mesh(_mesh(structured_grid, fields),
                                     capacity=64), RELS)
    return ref, port


def _knobs(eng):
    cfg = eng.kernel_config
    assert (eng.batch_max, eng.bucket_floor) == (cfg.batch_max,
                                                 cfg.bucket_floor)
    return cfg.batch_max, cfg.bucket_floor


def _same_blocks(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# -- the round trip -----------------------------------------------------------

def test_autotune_roundtrip(pres, tmp_path):
    _, pre = pres
    cfg = autotune.KernelConfig(batch_max=8, bucket_floor=2)
    path = str(tmp_path / "tune.json")
    ns = pre.smesh.n_segments
    autotune.record("torch", ns, cfg, path=path, score_s=1.0)
    assert autotune.lookup("torch", ns, path=path) == cfg
    # other backends and other mesh buckets miss
    assert autotune.lookup("cuda", ns, path=path) is None
    assert autotune.lookup("torch", 4 * ns, path=path) is None

    eng = RelationEngine(pre, RELS, device="cpu", lookahead=0, tune=path)
    assert _knobs(eng) == (8, 2)
    assert eng.kernel_config == cfg
    # explicit arguments win over the tuned table
    eng2 = RelationEngine(pre, RELS, device="cpu", lookahead=0, tune=path,
                          batch_max=4)
    assert _knobs(eng2) == (4, 2)

    # a tuned engine produces the identical blocks as today's defaults
    base = RelationEngine(pre, RELS, device="cpu", lookahead=0, tune="off")
    for r in RELS:
        for s in range(min(3, ns)):
            _same_blocks(base.get(r, s), eng.get(r, s))


def test_tune_off_matches_built_in_defaults(pres, tmp_path):
    _, pre = pres
    path = str(tmp_path / "tune.json")
    autotune.record("torch", pre.smesh.n_segments,
                    autotune.KernelConfig(batch_max=8, bucket_floor=2),
                    path=path)
    for tune in ("off", str(tmp_path / "missing.json")):
        eng = RelationEngine(pre, RELS, device="cpu", tune=tune)
        assert _knobs(eng) + (eng.assembly,) == (64, 1, "sparse")
        assert eng.kernel_config == autotune.KernelConfig()


def test_corrupt_table_falls_back_to_defaults(pres, tmp_path):
    _, pre = pres
    bad = tmp_path / "bad.json"
    bad.write_text("{not json", encoding="utf-8")
    eng = RelationEngine(pre, RELS, device="cpu", tune=str(bad))
    assert _knobs(eng) == (64, 1)
    stale = tmp_path / "stale.json"
    stale.write_text('{"version": -1, "configs": {}}', encoding="utf-8")
    assert autotune.load_table(str(stale)) == {}
    # an entry the knobs cannot take (a floor of 0, a float batch, a
    # string) is no entry: the defaults
    key = autotune.table_key("torch", pre.smesh.n_segments)
    for entry in ({"bucket_floor": 0}, {"batch_max": 8.5},
                  {"batch_max": "two"}):
        odd = tmp_path / "odd.json"
        odd.write_text(json.dumps({"version": autotune.TABLE_VERSION,
                                   "configs": {key: entry}}),
                       encoding="utf-8")
        assert autotune.lookup("torch", pre.smesh.n_segments,
                               path=str(odd)) is None
        eng = RelationEngine(pre, RELS, device="cpu", tune=str(odd))
        assert _knobs(eng) == (64, 1)
    # an explicit argument the knobs cannot take raises
    with pytest.raises(ValueError, match="batch_max"):
        RelationEngine(pre, RELS, device="cpu", tune="off", batch_max=0)


def test_version_mismatch_invalidates(tmp_path):
    path = str(tmp_path / "t.json")
    autotune.record("cuda", 64, autotune.KernelConfig(), path=path)
    with open(path) as f:
        data = json.load(f)
    data["version"] = autotune.TABLE_VERSION + 1
    with open(path, "w") as f:
        json.dump(data, f)
    assert autotune.lookup("cuda", 64, path=path) is None


def test_auto_reads_the_ports_table_only(pres, tmp_path, monkeypatch):
    """``tune="auto"`` reads ``$REPRO_TORCH_TUNE_TABLE``, else
    ``TUNE_torch_kernel_params.json`` in the working directory; never the
    reference's table (``$REPRO_TUNE_TABLE``, ``TUNE_kernel_params.json``),
    whose entries hold Pallas tiles."""
    _, pre = pres
    ns = pre.smesh.n_segments
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("REPRO_TORCH_TUNE_TABLE", raising=False)
    ref_cfg = ref_autotune.KernelConfig(batch_max=8, bucket_floor=2)
    ref_path = str(tmp_path / "ref.json")
    monkeypatch.setenv("REPRO_TUNE_TABLE", ref_path)
    for p in (ref_path, str(tmp_path / "TUNE_kernel_params.json")):
        ref_autotune.record("torch", ns, ref_cfg, path=p)
    eng = RelationEngine(pre, RELS, device="cpu")
    assert _knobs(eng) == (64, 1)

    autotune.record("torch", ns, autotune.KernelConfig(batch_max=16),
                    path=str(tmp_path / "TUNE_torch_kernel_params.json"))
    assert RelationEngine(pre, RELS, device="cpu").batch_max == 16
    env = str(tmp_path / "env.json")
    autotune.record("torch", ns, autotune.KernelConfig(batch_max=32,
                                                       bucket_floor=4),
                    path=env)
    monkeypatch.setenv("REPRO_TORCH_TUNE_TABLE", env)
    assert _knobs(RelationEngine(pre, RELS, device="cpu")) == (32, 4)
    assert autotune.default_path() == env


# -- the port's engine against the reference's under the same knobs ---------

def _counters(stats):
    return {k: v for k, v in stats.as_dict().items()
            if not k.startswith("t_")}


@pytest.mark.parametrize("lookahead", [0, 8])
def test_engine_equals_the_reference_under_tuned_knobs(pres, tmp_path,
                                                       lookahead):
    """``batch_max=8, bucket_floor=2`` from each package's own table: one
    sweep of VV and VT over the quickstart mesh (27 segments; launches of
    8 and a ragged 3 with lookahead, of 1 padded to the floor of 2
    without) gives equal blocks and equal ``EngineStats``, key for key;
    ``segments_produced`` counts the segments, not the padded bucket."""
    ref_pre, pre = pres
    ns = pre.smesh.n_segments
    assert ns % 8 and ns == ref_pre.smesh.n_segments
    rpath, ppath = str(tmp_path / "ref.json"), str(tmp_path / "port.json")
    ref_autotune.record("xla", ns, ref_autotune.KernelConfig(
        batch_max=8, bucket_floor=2), path=rpath)
    autotune.record("torch", ns, autotune.KernelConfig(
        batch_max=8, bucket_floor=2), path=ppath)
    kw = dict(lookahead=lookahead, async_dispatch=False)
    ref = RefEngine(ref_pre, RELS, backend="xla", tune=rpath, **kw)
    eng = RelationEngine(pre, RELS, device="cpu", tune=ppath, **kw)
    assert (ref.batch_max, ref.bucket_floor) == (eng.batch_max,
                                                 eng.bucket_floor) == (8, 2)
    for r in ("VV", "VT"):
        for s in range(ns):
            _same_blocks(ref.get(r, s), eng.get(r, s))
    assert _counters(eng.stats) == _counters(ref.stats)
    assert eng.stats.segments_produced == 2 * ns


# -- the ranking -------------------------------------------------------------

def test_candidate_configs_are_deterministic():
    a = autotune.candidate_configs(1728, SHAPES_96, demand=72)
    b = autotune.candidate_configs(1728, SHAPES_96, demand=72)
    assert a == b and 0 < len(a) <= 8
    widths = {r: ops.DEFAULT_DEG[r] for r in ("VV", "VT")}
    scores = [autotune._predicted_launch_s(c, 1728, SHAPES_96, ("VV", "VT"),
                                           widths, 72, roofline.SMS,
                                           roofline.SMEM_OPTIN_BYTES)
              for c in a]
    assert scores == sorted(scores)
    # a sweep (no demand) favours the largest batch: fewest launches
    assert autotune.candidate_configs(13824, SHAPES_96)[0].batch_max == 128
    # every candidate is a grid point or the default, and no two give the
    # same launches: at 72 segments a launch, batch_max 16, 32, 64 (the
    # default, standing for its floor-4 twin) and 128 launch differently
    assert len(set(a)) == len(a) == 4
    assert autotune.KernelConfig() in a
    plans = {tuple(autotune._launch_plan(c, 1728, 72)) for c in a}
    assert len(plans) == len(a)
    for c in a:
        assert c.batch_max in autotune.BATCH_MAX
        assert c.bucket_floor in autotune.BUCKET_FLOOR
    # critical points' launches of 8 + 8 lookahead: every batch_max >= 16
    # launches 16, and 1728 = 108 * 16 leaves no tail for a floor to pad,
    # so the whole grid launches as the default does and the default alone
    # stands for it
    assert autotune.candidate_configs(1728, SHAPES_96, demand=16) == \
        [autotune.KernelConfig()]


def test_measure_engine_times_a_cold_sweep(pres):
    """The reference's measurement: a warm-up sweep, then the best of
    ``repeats`` sweeps after ``clear_cache``, each producing every block
    again."""
    _, pre = pres
    built = []

    def make(cfg):
        built.append(RelationEngine(pre, ["VV", "VT"], device="cpu",
                                    lookahead=0, tune="off",
                                    batch_max=cfg.batch_max))
        return built[-1]

    segs = range(pre.smesh.n_segments)
    t = autotune.measure_engine(make, ["VV", "VT"], segs,
                                autotune.KernelConfig(batch_max=4),
                                repeats=2)
    assert t > 0 and len(built) == 1
    st = built[0].stats
    assert st.segments_produced == 3 * 2 * len(segs)
    assert st.kernel_launches == st.segments_produced  # lookahead 0


def test_kernel_config_default_is_todays_launch():
    cfg = autotune.KernelConfig()
    assert cfg.to_dict() == {"batch_max": 64, "bucket_floor": 1}
    assert autotune.KernelConfig.from_dict(cfg.to_dict()) == cfg
    assert autotune.KernelConfig.from_dict(
        {"batch_max": 8, "score_s": 1.0, "bits_shares": 2}) == \
        autotune.KernelConfig(batch_max=8)
    assert [b for b, _ in autotune._launch_plan(cfg, 1728, 1728)] == [64]
    # no share count given is the kernels' own share rule, at every batch
    for B in (1, 8, 16, 64):
        for relation, R in (("VV", 256), ("VT", 256), ("FT", 1920)):
            fit = 10 ** 6
            rule = sr.sub_row_blocks if relation == "FT" else \
                sr.bits_row_blocks
            assert sr.bits_shares(relation, B, R, fit, 132) == \
                rule(B, R, 132)


@pytest.mark.parametrize("relation,R,O", [("VV", BIG_NV, BIG_NV),
                                          ("VT", BIG_NV, BIG_NT),
                                          ("VV", 256, 256),
                                          ("FT", 1920, 896),
                                          ("EF", 11520, 18048)])
def test_tuned_shares_never_outgrow_shared_memory(relation, R, O):
    """On the capacity-1024 tables a block holds only ``fit`` rows: a tuned
    share count below ``ceil(R / fit)`` gives way to it (VV over at least
    3 blocks, VT over 11 at an H100's 227 KiB; the rule gives VV 4 at
    B=64; EF at NE 11,520, NF 18,048 over at least 115), and no count
    exceeds R; a block's rows then fit its shared memory."""
    limit = roofline.SMEM_OPTIN_BYTES
    sub = relation in ("FT", "EF")
    fit = sr.bits_rows_fit(relation, 256 if sub else R, O, limit)
    floor = -(-R // fit)
    NX, NY = (R, O) if sub else (0, O)
    for k in (1, 2, 4, 8, 11, 16, 10 ** 6):
        got = sr.bits_shares(relation, 64, R, fit, 132, k)
        assert got == max(min(k, R), floor)
        rows = -(-R // got)
        assert rows <= fit
        # the wrapper's grid: whole rows a block, as many blocks as cover R
        blocks = sr.bits_blocks(relation, 64, 256 if sub else R, NX, NY,
                                limit, 132, k)
        assert blocks == -(-R // rows) and -(-R // blocks) == rows
        assert sr.bits_smem_bytes(rows, O, sub) <= limit
    if (relation, R) == ("VV", BIG_NV):
        assert floor == 3
        assert sr.bits_shares(relation, 64, R, fit, 132) == 4
    if relation == "VT" and R == BIG_NV:
        assert floor == 11
    if relation == "EF":
        assert floor == 115


@pytest.mark.parametrize("relation", ["VV", "VE", "VT", "FT", "EF", "TT",
                                      "FF"])
def test_model_prices_the_wrappers_grid(relation):
    """The ranking prices each launch at the blocks the wrapper launches
    (``segment_relations.bits_blocks``, the share rule's) on the 96^3
    tables: ``min(16, 264 // B)`` a segment for VV and the member
    kernels (16 at B = 8 and 16, 8 at 32, 4 at 64), the sub-join's ``132 // B`` (at least the 2 its shared memory needs at
    B=64) in whole rows a block; one where a relation takes no bitmask
    kernel; none for an empty segment or a table past one row's limit."""
    limit = roofline.SMEM_OPTIN_BYTES
    for B in (1, 8, 16, 64):
        k = autotune._blocks(relation, B, None, SHAPES_96, 132, limit)
        if relation in ("TT", "FF"):
            assert k == 1
        elif relation in ("FT", "EF"):
            R = SHAPES_96["N" + relation[0]]
            assert k == -(-R // -(-R // max(132 // B, 2)))
        else:
            assert k == min(16, 264 // B)
    assert [autotune._blocks("FT", B, None, SHAPES_96, 132, limit)
            for B in (1, 8, 16, 64)] == [128, 16, 8, 2]
    assert sr.bits_blocks("VT", 64, 256, 0, 109377, limit, 132) == 0
    assert sr.bits_blocks("FT", 64, 256, 8193, 1859233, limit, 132) == 0
    assert sr.bits_blocks("FT", 64, 256, 0, 896, limit, 132) == 0
    # past the sub-join's old NX 8192 limit: row shares of 1438 rows
    assert sr.bits_blocks("FT", 64, 256, 8193, 896, limit, 132) == 6


def test_pick_winner_needs_more_than_the_spread():
    """A configuration is recorded over the default only when its best
    repeat beats the default's best by more than either's spread; equal
    walls (the same launches) keep the default."""
    d, a, b = (autotune.KernelConfig(), autotune.KernelConfig(batch_max=16),
               autotune.KernelConfig(batch_max=128))
    assert autotune.pick_winner({d: [1.0, 1.1], a: [0.95, 1.2]}) == d
    assert autotune.pick_winner({d: [1.0, 1.0], a: [1.0, 1.0]}) == d
    assert autotune.pick_winner({d: [1.0, 1.05], a: [0.8, 0.82],
                                 b: [0.9, 0.9]}) == a
    assert autotune.pick_winner({d: [1.0, 1.3], a: [0.8, 0.82]}) == d
    with pytest.raises(ValueError, match="default"):
        autotune.pick_winner({a: [1.0]})


# -- the roofline model -------------------------------------------------------

def test_roofline_reproduces_the_perf_bounds():
    """``PERF.md`` §6's bounds (NVIDIA H100 SXM peaks) from shapes alone."""
    cases = [
        # VV bitmask at B=64 on 96^3 tables, and at B=1 (rows 1a, 1d)
        (roofline.entry_work("VV", 64, 256, 896, 896, 32), 0.000939, "bytes"),
        (roofline.entry_work("VV", 1, 256, 896, 896, 32), 0.0000147,
         "bytes"),
        # meet counts on the FF tables, VV counts at B=64 and B=8 (6, 7, 7b)
        (roofline.meet_work(64, 1920, 3, 1920, 3), 0.2826, "bytes"),
        (roofline.vv_counts_work(64, 896, 256), 0.005282, "bytes"),
        (roofline.vv_counts_work(8, 896, 256), 0.000660, "bytes"),
        # flash: the qwen2-7b prefill (bf16), the float32 pin, gemma-7b
        (roofline.flash_work(4, 4096, 4096, 28, 4, 128, True, "bfloat16"),
         0.4865, "operations"),
        (roofline.flash_work(2, 2048, 2048, 28, 4, 128, True, "float32"),
         0.3646, "operations"),
        (roofline.flash_work(4, 4096, 4096, 16, 16, 256, True, "bfloat16"),
         0.5560, "operations"),
    ]
    for work, ms, by in cases:
        got, got_by = work.bound_ms()
        assert got_by == by
        # PERF.md prints 3-4 significant digits
        assert abs(got - ms) <= 2e-3 * ms, (got, ms)
    r = roofline.kernel_roofline(67e12, 3.35e12)
    assert r["t_compute_s"] == r["t_memory_s"] == 1.0
    assert r["bottleneck"] == "memory" and r["t_collective_s"] == 0.0


def test_roofline_counts_data_dependent_work():
    """Counts this run's data needs replace the full-table counts: fewer
    valid entries, fewer comparisons; the bytes stay."""
    full = roofline.entry_work("TT", 4, 256, 896, 896, 8)
    part = roofline.entry_work("TT", 4, 256, 896, 896, 8,
                               first=[4 * 800] * 4, emitted=[3000] * 4)
    assert part.nbytes == full.nbytes and part.ops < full.ops
    assert part.ops == roofline.sort_ops([3200] * 4 + [3000] * 8)
    assert roofline.attention_pairs(5, 3, True) == 1 + 2 + 3 + 3 + 3
    assert roofline.attention_pairs(3, 5, True) == 6
    assert roofline.attention_pairs(3, 5, False) == 15
    with pytest.raises(ValueError, match="counts"):
        roofline.entry_work("VV", 2, 8, 4, 4, 4, first=[1, 2, 3])
