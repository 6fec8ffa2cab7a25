"""Time the mma flash-attention kernel (``csrc/flash_attention_mma.cu``) on
one NVIDIA card, beside the SIMT kernel and SDPA, at the main path's
shapes; and edited copies of its source beside it.

    PYTHONPATH=src python tools/time_flash.py [--shapes pin,whisper]
        [--variant NAME=PATH ...] [--simt] [--sass] [--tag NAME]

The package's source is the variant ``default``; each ``--variant`` is a
copy of it (an edited design: another tile size, rounding or layout) at
PATH, kept in a directory ``.gitignore`` lists. Every variant is built by
``nvcc`` with the package's flags into ``kernels/_build/variants/`` (all
started together), held against the plain version at every shape
(float32 2e-5, bf16 2e-2), then timed by ``chip_smoke.time_ms`` (the
CUDA-event loop), the variants in turns (a, b, ..., b, a) so that drift
shows. ``--simt`` also times the SIMT kernel (``simt=True``) and one SDPA
call (the matmul TF32 switch False) on the same inputs; ``--sass`` prints
each variant's SASS opcode counts for the float32 hd 128 instantiation
(``cuobjdump``). Shapes: the float32 qwen2-7b pin (B 2, S 2048, H 28, KV
4, hd 128, causal), whisper-base's encoder (B 2, S 1500, H 8, hd 64,
unmasked), float32 hd 256 (B 2, S 2048, H 16, causal) and bf16 hd 80 (B
2, S 2048, H 32, causal). One JSON line per variant (its registers and
spills), one per (variant, shape), and one with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

# name -> (B, S, H, KV, hd, causal, dtype)
SHAPES = {
    "pin": (2, 2048, 28, 4, 128, True, torch.float32),
    "whisper": (2, 1500, 8, 8, 64, False, torch.float32),
    "hd256": (2, 2048, 16, 16, 256, True, torch.float32),
    "hd80_bf16": (2, 2048, 32, 32, 80, True, torch.bfloat16),
}


def build_variants(sources):
    """name -> library path for name -> source path, every source built
    by its own nvcc, all started together."""
    out, procs = {}, {}
    for n, src in sources.items():
        h = hashlib.sha256(src.read_bytes())
        h.update(" ".join(_build.NVCC_FLAGS).encode())
        path = (_build.BUILD_DIR / "variants" / h.hexdigest()[:16]
                / "libflash_attention_mma.so")
        out[n] = path
        if path.exists():
            continue
        path.parent.mkdir(parents=True, exist_ok=True)
        procs[n] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(path), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for n, proc in procs.items():
        log, _ = proc.communicate()
        (out[n].parent / "build.log").write_text(log, encoding="utf-8")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {n}:\n{log}")
    return out


def bind(path):
    """The library at ``path`` with ``fam_forward`` typed as the wrapper
    types it."""
    lib = ctypes.CDLL(str(path))
    lib.fam_error_string.argtypes = [ctypes.c_int]
    lib.fam_error_string.restype = ctypes.c_char_p
    lib.fam_forward.argtypes = [ctypes.c_int, ctypes.c_int,
                                *[ctypes.c_void_p] * 4,
                                ctypes.POINTER(ctypes.c_longlong),
                                *[ctypes.c_int] * 7, ctypes.c_float,
                                ctypes.c_float, ctypes.c_int,
                                ctypes.c_void_p]
    lib.fam_forward.restype = ctypes.c_int
    return lib


def ptxas(path):
    """registers / spills by instantiation, from the variant's build log"""
    out, fn = {}, None
    for ln in (path.parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in ln:
            fn = re.sub(r".*flash_fwd_mma", "flash_fwd_mma", ln.split("'")[1])
        elif fn and ("registers" in ln or "spill" in ln):
            out.setdefault(fn, []).append(ln.split(":", 1)[-1].strip())
    return out


def sass_counts(path):
    """opcode -> count in the float32 hd 128 instantiation"""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True).stdout
    counts, inside = collections.Counter(), False
    for ln in text.splitlines():
        if "Function :" in ln:
            inside = "flash_fwd_mmaIfLi128EE" in ln
        elif inside:
            m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                         ln)
            if m:
                counts[m.group(2).split(".")[0]] += 1
    return dict(counts.most_common(25))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=PATH: an edited copy of the source")
    ap.add_argument("--simt", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = {"default": _build.CSRC / "flash_attention_mma.cu"}
    for spec in args.variant:
        name, path = spec.split("=", 1)
        sources[name] = Path(path)
    paths = build_variants(sources)
    libs = {n: bind(p) for n, p in paths.items()}
    names = list(sources)
    for n in names:
        line = {"variant": n, "source": str(sources[n]),
                "ptxas": ptxas(paths[n])}
        if args.sass:
            line["sass_f32_128"] = sass_counts(paths[n])
        print(json.dumps(line), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    order = names + names[::-1]
    for shape in args.shapes.split(","):
        B, S, H, KV, hd, causal, dt = SHAPES[shape]
        q, k, v = (torch.randn(s, device=dev, generator=gen).to(dt)
                   for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
        want = fa.flash_attention_ref(q, k, v, causal=causal)
        tol = 2e-5 if dt == torch.float32 else 2e-2
        pairs = sum(min(i + 1, S) for i in range(S)) if causal else S * S
        flops = 4 * B * H * hd * pairs
        rate = chip_smoke.FLOPS_PER_S[str(dt).split(".")[-1]]
        moved = chip_smoke.nbytes(q, k, v, q)     # q, k, v read; o written
        bound = max(flops / rate, moved / chip_smoke.HBM_BYTES_PER_S) * 1e3
        run = {}

        def call(n):
            fa._lib_mma = lambda: libs[n]
            return fa.flash_attention_cuda(q, k, v, causal=causal)

        for n in names:
            got = call(n)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            ok = bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                     atol=tol))
            run[n] = {"max_abs_err": err, "close": ok, "ms": []}
        for n in order:
            run[n]["ms"].append(chip_smoke.time_ms(torch, lambda: call(n),
                                                   reps=10))
        extra = {}
        if args.simt:
            extra["simt_ms"] = chip_smoke.time_ms(
                torch, lambda: fa.flash_attention_cuda(
                    q, k, v, causal=causal, simt=True), reps=3)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            extra["sdpa_ms"] = chip_smoke.time_ms(
                torch, lambda: torch.nn.functional
                .scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True), reps=3)
        for n in names:
            print(json.dumps({"tag": args.tag, "variant": n, "shape": shape,
                              "dtype": str(dt).split(".")[-1], "B": B,
                              "S": S, "H": H, "KV": KV, "hd": hd,
                              "causal": causal, "flops": flops,
                              "bound_ms": bound, **run[n], **extra,
                              "tflops_per_s": flops / min(run[n]["ms"])
                              / 1e9}), flush=True)
        del q, k, v, want
    print(json.dumps({"tag": args.tag, "card": chip_smoke.nvidia_smi(),
                      "torch": torch.__version__}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
