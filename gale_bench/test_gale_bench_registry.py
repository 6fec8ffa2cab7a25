"""The benchmark's files are found by name, a new cell by adding files,
and ``BENCHMARK.json`` keeps the contract's shape."""

import json
import re

import pytest

from gale_bench import _testing, registry
from gale_bench.harness import context
from gale_bench.reference import lm as ref_lm

BENCH = registry.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(name):
    cell = registry.cell(name)
    assert registry.job(cell.kind).Job
    block = registry.reference_block(cell.config["reference"])
    specs = ref_lm.param_specs(registry.model_shape(cell.config), block)
    assert len({n for n, _, _ in specs}) == len(specs)
    assert set(cell.limits) and all(v >= 0 for v in cell.limits.values())
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(registry.metric(m["name"]).read)


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gale_bench"]
    rs = BENCH["run_seconds"]
    n = 24                               # the most cells a later PR may add
    assert (2 + 14 * n) * (rs + 60) + n * 180 + 1200 <= 43200
    confs = {c["name"] for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert confs == used
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("gale_bench/")
        assert all(NAME.match(k) for k in c["reduced"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_states_what_runs(conf):
    """The published keys as run agree with the program's model block, and
    each reduced key is listed with its published value."""
    with open(registry.ROOT / conf["file"], encoding="utf-8") as f:
        cfg = json.load(f)
    hf, m = cfg["config"], cfg["model"]
    assert hf["hidden_size"] == m["d_model"]
    assert hf["num_hidden_layers"] == m["n_layers"]
    assert hf["num_attention_heads"] == m["n_heads"]
    assert hf["num_key_value_heads"] == m["n_kv_heads"]
    assert hf["intermediate_size"] == m["d_ff"]
    assert hf["vocab_size"] == m["vocab"]
    assert hf["rms_norm_eps"] == m["norm_eps"]
    assert float(hf["rope_theta"]) == m["rope_theta"]
    assert hf["tie_word_embeddings"] == m["tie_embeddings"]
    if m["family"] == "moe":
        assert hf["num_local_experts"] == m["n_experts"]
        assert hf["num_experts_per_tok"] == m["top_k"]
        # the published multipliers the port does not apply are departures
        for k in ("attention_multiplier", "embedding_multiplier",
                  "logits_scaling", "residual_multiplier"):
            assert any(d.startswith(k) for d in cfg["departures"]), k
    assert sorted(cfg["reduced"]) == sorted(conf["reduced"])
    for k, v in cfg["reduced"].items():
        assert hf[k] == v["run"] != v["published"]


def test_fixture_cell_found_without_edits(tmp_path):
    """A cell, configuration, mix and limits added as files in another
    root are found by name; metrics with ``workloads`` follow them."""
    root = _testing.write_tree(tmp_path)
    bench = registry.load_benchmark(root)
    for name in _testing.TINY_CELLS:
        cell = registry.cell(name, root=root)
        assert cell.config["name"] in _testing.TINY_MODELS
        real = _testing.TINY_CELLS[name][2]
        assert cell.limits == registry.cell(real).limits
        assert {m["name"] for m in cell.per_layer} == \
            {m["name"] for m in registry.cell(real).per_layer}
    assert len(bench["workloads"]) == len(_testing.TINY_CELLS)


@pytest.mark.parametrize("change", [{"loop": "open"}, {"rate": 4.0},
                                    {"deck_size": None}])
def test_mix_with_an_unread_knob_is_refused(tmp_path, change):
    """A prefill mix that names a parameter the job does not read (or an
    open loop, which it does not drive) is refused, not run as another."""
    root = _testing.write_tree(tmp_path)
    cell = registry.cell("prefill.tiny-dense", root=root)
    for k, v in change.items():
        if v is None:
            del cell.traffic[k]
        else:
            cell.traffic[k] = v
    with pytest.raises(ValueError):
        registry.job(cell.kind).Job(context(cell, 1, "cpu", "torch"))
