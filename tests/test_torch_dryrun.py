"""The port's dry run (``repro_torch.launch.dryrun``) and its report: the
reference's test_dryrun_test_mesh cells traced on the test meshes under a
fake process group, in one process of their own (it holds one default
group at a time and imports no JAX), each with a status of ok and FLOPs
per device; ``roofline.model_flops`` equal to the reference's for every
arch and shape; ``report`` rendering the port's records."""

import json
import os
import subprocess
import sys

import pytest

from repro import configs as rconfigs
from repro.launch import roofline as rroofline
from repro_torch import configs
from repro_torch.launch import report, roofline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [("qwen2-7b", "train_4k"), ("granite-moe-3b-a800m", "train_4k"),
         ("mamba2-130m", "decode_32k"), ("whisper-base", "prefill_32k")]

_RUN = """
import json, sys
from repro_torch.launch import dryrun
for arch, shape in json.loads(sys.argv[1]):
    for multipod in (False, True):
        rec = dryrun.run_cell(arch, shape, multipod, "test", smoke=True)
        print(json.dumps(rec), flush=True)
"""


@pytest.fixture(scope="module")
def records():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _RUN, json.dumps(CELLS)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    recs = [json.loads(ln) for ln in out.stdout.splitlines()
            if ln.startswith("{")]
    assert len(recs) == 2 * len(CELLS), out.stderr[-3000:]
    return {(r["arch"], r["shape"], r["mesh"]): r for r in recs}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_dryrun_test_mesh(records, arch, shape):
    """Each cell on (2, 2) and, with --multipod, (2, 2, 2): ok, FLOPs and
    live bytes per device, the model's FLOPs per device, and the expected
    collectives (FSDP gathers; the MoE's all-to-alls)."""
    for mesh, n_dev in (("singlepod", 4), ("multipod", 8)):
        rec = records[(arch, shape, mesh)]
        assert rec["status"] == "ok", rec
        assert rec["n_devices"] == n_dev
        assert rec["flops_per_dev"] > 0
        assert rec["memory"]["peak_bytes_per_dev"] >= \
            rec["memory"]["param_bytes_per_dev"] > 0
        cfg = configs.get_smoke_config(arch)
        want = roofline.model_flops(cfg, configs.SHAPES[shape])
        assert rec["model_flops_per_dev"] == want / n_dev
        assert rec["collectives"].get("all_gather_into_tensor", 0) > 0
        moe = cfg.family == "moe" and cfg.moe_ep_pref == "data"
        assert (rec["collectives"].get("all_to_all_single", 0) > 0) == moe
        if configs.SHAPES[shape].kind == "train":
            # float32 mu and nu beside the float32 masters, and the step
            assert rec["memory"]["opt_state_bytes_per_dev"] == \
                2 * rec["memory"]["param_bytes_per_dev"] + 4
    # the multi-pod mesh halves each device's share of the batch
    one, two = records[(arch, shape, "singlepod")], \
        records[(arch, shape, "multipod")]
    assert two["flops_per_dev"] < one["flops_per_dev"]


@pytest.mark.parametrize("shape", tuple(configs.SHAPES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_model_flops_equal_the_reference(arch, shape):
    for get, rget in ((configs.get_config, rconfigs.get_config),
                      (configs.get_smoke_config,
                       rconfigs.get_smoke_config)):
        assert roofline.model_flops(get(arch), configs.SHAPES[shape]) == \
            rroofline.model_flops(rget(arch), rconfigs.SHAPES[shape])


def test_report_renders_the_records(records, tmp_path):
    for i, rec in enumerate(records.values()):
        (tmp_path / f"cell{i}.json").write_text(json.dumps(rec))
    (tmp_path / "skipped.json").write_text(json.dumps(
        {"arch": "qwen2-7b", "shape": "long_500k", "mesh": "singlepod",
         "status": "skipped"}))
    recs = report.load(str(tmp_path))
    assert report.summary(recs) == f"{len(records)} traced, 1 skipped, " \
                                   f"0 errors"
    table = report.roofline_table(recs)
    for arch, shape in CELLS:
        assert f"| {arch} | {shape} |" in table
    assert "SKIP" in table
    assert report.dryrun_table(recs).count("| ok |") == len(records)
