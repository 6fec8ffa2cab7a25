"""One run of one cell: set-up, the measured window, the correctness check
against the plain reference, and the metrics.

A run, in order (the job of the cell's traffic kind does each step,
:mod:`gale_bench.jobs`):

1. ``setup``: the program's objects, the seed's weights, warm-up of every
   shape the traffic uses (training: the first steps, which the check
   reads). ``setup_s`` runs from the process's start to its end.
2. ``window``: the timed loop for ``seconds`` (under the profiler with
   ``trace``; the traced window is at most ``TRACE_SECONDS``).
3. ``drain``: answers still owed when the window closed.
4. The peak of device memory is read; ``release`` frees the program's state.
5. ``check``: the plain reference recomputes what the window produced
   (the weights drawn again from the seed), each number beside its limit
   (``limits/<cell>.json``).
6. The cell's metrics, each read by ``metrics/<name>.py`` from the run.
"""

from __future__ import annotations

import dataclasses
import math
import time
import types
from pathlib import Path
from typing import Dict, Optional

import torch

from . import registry, trace
from .metrics.peaks import FLOPS_PER_S
from .reference import lm as ref_lm

TRACE_SECONDS = 6.0


@dataclasses.dataclass
class Context:
    """What a job is given: the cell, the configuration's shapes (``shape``
    for the references and the FLOP counts; ``arch`` for the program), the
    seed, and where to run."""

    cell: registry.Cell
    shape: types.SimpleNamespace
    seed: int
    device: torch.device
    backend: str
    block: types.ModuleType
    specs: list
    marks: list = dataclasses.field(default_factory=list)

    def mark(self, phase: str) -> None:
        """Note the end of a phase of set-up (``setup_phases``)."""
        self.marks.append((phase, time.time()))

    def arch(self):
        """The program's configuration object for the ``model`` block."""
        from repro_torch.configs.base import ArchConfig
        return ArchConfig(name=self.shape.name, **self.cell.config["model"])


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def context(cell: registry.Cell, seed: int, device, backend: str) -> Context:
    shape = registry.model_shape(cell.config)
    block = registry.reference_block(cell.config["reference"])
    return Context(cell=cell, shape=shape, seed=int(seed),
                   device=torch.device(device), backend=backend, block=block,
                   specs=ref_lm.param_specs(shape, block))


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> dict:
    """Each number the cell's limits name, beside its limit; a number
    passes at or below it (a NaN fails). A job may read more numbers than
    a cell compares."""
    missing = sorted(set(limits) - set(readings))
    if missing:
        raise ValueError(f"no reading for the limits {missing}")
    return {k: {"value": float(readings[k]), "limit": float(limits[k])}
            for k in sorted(limits)}


def passed(checks: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def run_cell(name: str, seed: int, seconds: float, trace_on: bool, *,
             device="cuda", backend="cuda", t_start: Optional[float] = None,
             root: Path = registry.ROOT, marks=()) -> dict:
    """Run the cell once and return the result line's object (``checks``
    last). ``t_start``: the process's start on ``time.time()``'s clock;
    ``root``: where ``BENCHMARK.json`` and the cell's data files are;
    ``marks``: (phase, time) of set-up before this call."""
    t_start = time.time() if t_start is None else t_start
    cell = registry.cell(name, root=root)
    ctx = context(cell, seed, device, backend)
    ctx.marks.extend(marks)
    if ctx.device.type == "cuda":
        torch.empty(1, device=ctx.device)
        ctx.mark("cuda_context")
    job = registry.job(cell.kind).Job(ctx)
    job.setup()
    sync(ctx.device)
    ctx.mark("sync")
    setup_s = time.time() - t_start
    phases, t = {}, t_start
    for phase, at in ctx.marks:
        phases[phase] = at - t
        t = at

    summary = None
    if trace_on:
        with trace.profiler() as prof:
            win = job.window(min(float(seconds), TRACE_SECONDS))
        summary = trace.summarize(prof)
    else:
        win = job.window(float(seconds))
    job.drain()
    peak = torch.cuda.max_memory_allocated(ctx.device) \
        if ctx.device.type == "cuda" else None
    job.release()
    checks = judge(job.check(), cell.limits)

    run = types.SimpleNamespace(
        kind=cell.kind, shape=ctx.shape, setup_s=setup_s, peak_bytes=peak, window=win, trace=summary,
        peak_flops=FLOPS_PER_S["bfloat16"] if ctx.device.type == "cuda"
        else None)
    wanted = cell.per_layer if trace_on else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = registry.metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(ctx.device)
           if ctx.device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": passed(checks), "attempted": win["attempted"],
           "failed": win["failed"], "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = win["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["setup_phases"] = phases
    out["checks"] = checks
    return out
