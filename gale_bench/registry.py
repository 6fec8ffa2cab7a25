"""Find what a cell needs by the names ``BENCHMARK.json`` gives.

- a cell: an entry of ``workloads``, naming a configuration and a traffic
  mix;
- a configuration: ``configs/<name>.json`` (the file its entry names), which
  names its reference block, ``reference/<block>.py``;
- a traffic mix: ``traffic/<name>.json``, whose ``kind`` names the job that
  drives it, ``jobs/<kind>.py``;
- the limits of the cell's correctness check: ``limits/<cell>.json``;
- a metric: ``metrics/<name>.py`` with a ``read(run)`` function.

A later change adds a configuration, a mix, a metric or a cell by adding
files and entries; nothing here lists them.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import types
from pathlib import Path
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json", encoding="utf-8") as f:
        return json.load(f)


def _load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict          # the configuration file
    traffic: dict         # the traffic mix's file
    limits: dict          # number compared -> its limit
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _applies(metric: dict, cell: str, reported: set) -> bool:
    """A metric with ``workloads`` applies to those cells; one without,
    where the cell reports the end-to-end metric it moves (or, for an
    end-to-end metric, to every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def cell(name: str, bench: dict = None, root: Path = ROOT) -> Cell:
    root = Path(root)
    bench = bench if bench is not None else load_benchmark(root)
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{sorted(wl)})")
    w = wl[name]
    confs = {c["name"]: c for c in bench["configs"]}
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name=name, chips=int(w["chips"]),
                config=_load_json(root / confs[w["config"]]["file"]),
                traffic=traffic(w["traffic"], root),
                limits=_load_json(root / HERE.name / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per)


def traffic(name: str, root: Path = ROOT) -> dict:
    return _load_json(Path(root) / HERE.name / "traffic" / f"{name}.json")


def job(kind: str):
    """The module that drives a traffic kind: ``jobs/<kind>.py``."""
    return importlib.import_module(f"{__package__}.jobs.{kind}")


def reference_block(name: str):
    return importlib.import_module(f"{__package__}.reference.{name}")


def metric(name: str) -> types.ModuleType:
    """``metrics/<name>.py`` (the name may hold dots), loaded by path."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"{__package__}.metrics._m_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def model_shape(config: dict) -> types.SimpleNamespace:
    """The configuration's ``model`` block as attributes, with ``hd`` (the
    head size) and ``reference`` (its block's module) filled in: what the
    references and the FLOP counts read."""
    m = dict(config["model"], reference=config["reference"])
    m["hd"] = m.get("head_dim") or m["d_model"] // m["n_heads"]
    m.setdefault("n_experts", 0)
    m.setdefault("top_k", 0)
    m.setdefault("tie_embeddings", False)
    m.setdefault("moe_capacity_factor", 1.25)
    return types.SimpleNamespace(name=config["name"], **m)


