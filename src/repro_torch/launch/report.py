"""Render the dry run's tables from its per-cell JSON records, ported from
the reference's ``launch/report.py``:

  PYTHONPATH=src python -m repro_torch.launch.report experiments/dryrun_torch

The port's records (``launch/dryrun.py``) hold FLOPs and live tensor bytes
per device, the model's FLOPs and the collectives by kind; the
reference's HLO roofline terms (compute, memory and collective times, the
bottleneck) have no counterpart there, so the roofline table shows the
recorded quantities only, against one H100's 80 GB.
"""

from __future__ import annotations

import json
import os
import sys
from typing import List

SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
DEVICE_BYTES = 80e9           # one H100's memory


def load(d: str) -> List[dict]:
    recs = []
    for f in sorted(os.listdir(d)):
        if f.endswith(".json"):
            with open(os.path.join(d, f)) as fh:
                recs.append(json.load(fh))
    return recs


def fmt_s(x):
    if x is None:
        return "-"
    if x >= 0.1:
        return f"{x:.2f}s"
    if x >= 1e-4:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}us"


def fmt_b(x):
    if x is None:
        return "-"
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x / div:.2f}{unit}"
    return f"{x:.0f}B"


def fmt_f(x):
    if x is None:
        return "-"
    for unit, div in (("P", 1e15), ("T", 1e12), ("G", 1e9), ("M", 1e6)):
        if x >= div:
            return f"{x / div:.2f}{unit}"
    return f"{x:.0f}"


def _order(r):
    return (r["arch"], SHAPE_ORDER.index(r["shape"]), r.get("mesh", ""))


def roofline_table(recs: List[dict]) -> str:
    """Single-pod table, one row per arch x shape: FLOPs per device
    (counted, and the model's), their ratio, and the peak of live tensor
    bytes per device against one H100."""
    lines = [
        "| arch | shape | FLOPs/dev | model FLOPs/dev | useful FLOPs | "
        "peak bytes/dev | fits 80G |",
        "|---|---|---|---|---|---|---|"]
    rows = sorted((r for r in recs if r.get("mesh") == "singlepod"),
                  key=_order)
    for r in rows:
        if r.get("status") == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | "
                         "SKIP (full attention @500k) | — | — |")
            continue
        if r.get("status") != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | ERROR | "
                         "— | — |")
            continue
        peak = r["memory"]["peak_bytes_per_dev"]
        u = r.get("useful_flops_ratio")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_f(r['flops_per_dev'])} | "
            f"{fmt_f(r['model_flops_per_dev'])} | "
            f"{'-' if u is None else f'{u:.2f}'} | {fmt_b(peak)} | "
            f"{'yes' if peak < DEVICE_BYTES else 'NO'} |")
    return "\n".join(lines)


def dryrun_table(recs: List[dict]) -> str:
    lines = [
        "| arch | shape | mesh | status | trace | params/dev | peak/dev | "
        "collectives (AR/AG/RS/A2A) |",
        "|---|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=_order):
        if r.get("status") != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r.get('mesh', '-')} | "
                f"{r.get('status')} | - | - | - | - |")
            continue
        m = r["memory"]
        c = r["collectives"]
        cc = "/".join(str(c.get(k, 0)) for k in (
            "all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
            "all_to_all_single"))
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
            f"{fmt_s(r['t_trace_s'])} | {fmt_b(m['param_bytes_per_dev'])} | "
            f"{fmt_b(m['peak_bytes_per_dev'])} | {cc} |")
    return "\n".join(lines)


def summary(recs):
    ok = [r for r in recs if r.get("status") == "ok"]
    sk = [r for r in recs if r.get("status") == "skipped"]
    er = [r for r in recs if r.get("status") not in ("ok", "skipped")]
    return f"{len(ok)} traced, {len(sk)} skipped, {len(er)} errors"


def main():
    d = sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun_torch"
    recs = load(d)
    print("## Summary:", summary(recs))
    print()
    print("### Per device (single-pod 16x16)")
    print(roofline_table(recs))
    print()
    print("### Dry run (all cells x both meshes)")
    print(dryrun_table(recs))


if __name__ == "__main__":
    main()
