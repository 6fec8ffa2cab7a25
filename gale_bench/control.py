"""The readings a cell's correctness limits are set from, in one process:

    python3 -m gale_bench.control --workload <name> --seeds 1 2 ... \
        [--control-seeds 1 2 3] [--seconds 3] [--out FILE]

For each seed, a run of the cell as ``gale_bench.run`` makes it (set-up,
a window of ``--seconds``, drain), then the numbers its check compares:

- ``program``: the program's, against the float32 reference (the sound
  runs: the largest over a dozen seeds or more is the lower reading);
- on ``--control-seeds``, ``fp8``: the reference computed in float8, the
  precision below the bf16 the configurations state, in the program's
  place (the control: it must fail), and for a training cell
  ``half_batch``: the float32 reference trained on half of each batch
  (a fault the check must see). A step that returns its state unchanged
  reads 1 on ``grad_gap`` and ``change_gap`` by their definition and
  needs no run.

One JSON line a seed and precision, then one ``summary`` line: each
number's largest program reading and each control's smallest.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _emit(obj, out) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if out:
        with open(out, "a", encoding="utf-8") as f:
            f.write(line + "\n")


def readings(job, kind: str, controls: bool) -> dict:
    """``{"program": {...}[, "fp8": {...}, "half_batch": {...}]}``."""
    if kind == "prefill":
        return job.readings(("fp8",) if controls else ())
    from .jobs.train import compare
    ref = job.reference()
    out = {"program": compare(job.prog, ref)}
    if controls:
        out["fp8"] = compare(job.reference("fp8"), ref)
        half = int(job.mix["batch"]) // 2
        out["half_batch"] = compare(job.reference(rows=slice(0, half)), ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    os.environ["USE_FLAX"] = "0"
    import torch

    from . import registry
    from .harness import context
    worst: dict = {}
    least: dict = {}
    for seed in args.seeds:
        t0 = time.time()
        cell = registry.cell(args.workload, root=ROOT)
        ctx = context(cell, seed, "cuda", "cuda")
        job = registry.job(cell.kind).Job(ctx)
        job.setup()
        t_setup = time.time() - t0
        win = job.window(args.seconds)
        job.drain()
        job.release()
        t1 = time.time()
        r = readings(job, cell.kind, seed in args.control_seeds)
        for who, nums in r.items():
            _emit({"workload": args.workload, "seed": seed, "who": who,
                   **nums, "setup_s": t_setup, "check_s": time.time() - t1,
                   "window_s": win["window_s"]}, args.out)
            for k, v in nums.items():
                if who == "program":
                    worst[k] = max(worst.get(k, v), v)
                else:
                    least.setdefault(who, {})
                    least[who][k] = min(least[who].get(k, v), v)
        del job
        torch.cuda.empty_cache()
    _emit({"summary": args.workload, "program_max": worst,
           "control_min": least, "seeds": args.seeds,
           "control_seeds": args.control_seeds}, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
