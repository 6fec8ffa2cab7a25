"""Run one cell of ``BENCHMARK.json`` once and print its result.

    python3 -m gale_bench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (the port's package under ``src/``). The last
line of standard output is the result: one JSON object with ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the correctness check
compared, with its limit. The same numbers end standard error.

Exits with 3, printing no result, without a CUDA device (or fewer than the
cell asks for) or without the port's package; with 4 if a JAX module was
loaded. Kernel builds stay inside the checkout: the port builds its CUDA
sources under ``src/repro_torch/kernels/_build/``, and the Triton and
extension caches are pointed at ``.gale_bench_cache/`` beside it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """The process's start on ``time.time()``'s clock (Linux's process
    table; the time of this module's import elsewhere)."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat", encoding="ascii") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _IMPORTED


_IMPORTED = time.time()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or its package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _fail(code: int, msg: str) -> int:
    print(f"gale_bench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    t_start = process_start()
    marks = [("python", time.time())]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / ".gale_bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").exists():
        return _fail(3, f"the port's package is not under {src}")
    sys.path.insert(0, str(src))

    from . import registry
    cell = registry.cell(args.workload, root=ROOT)
    import torch
    marks.append(("import_torch", time.time()))
    if not torch.cuda.is_available():
        return _fail(3, "no CUDA device (torch.cuda.is_available() is "
                        "False)")
    if torch.cuda.device_count() < cell.chips:
        return _fail(3, f"the cell needs {cell.chips} devices, "
                        f"{torch.cuda.device_count()} present")

    from .harness import run_cell
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", backend="cuda",
                      t_start=t_start, root=ROOT, marks=marks)
    found = forbidden_modules()
    if found:
        return _fail(4, f"modules of JAX or its package were loaded: "
                        f"{found}")
    result["device"]["power_limit_w"] = _power_limit()
    print("setup phases (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in result["setup_phases"].items()),
        file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


def _power_limit():
    """The card's power limit in W (``nvidia-smi``), or None."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


if __name__ == "__main__":
    sys.exit(main())
