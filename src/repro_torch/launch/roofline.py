"""The H100 roofline model of the port's kernels: the card's peaks, and the
work each kernel does on its inputs, from their shapes.

Every bound in ``chip_smoke.py``'s ``{"kernels": [...]}`` line and in
``PERF.md`` §6, and the candidate ranking of :mod:`.autotune`, comes from
here: the least time the card could take for a launch is the larger of the
bytes it must move (each input read once, each output written once) over
the HBM rate, and the operations it does over the peak rate for their type
(:func:`kernel_roofline`). The work functions take shapes, and optionally
the counts this run's data needs (valid entries, emitted entries); without
them they count full tables, which is the most the shapes allow.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at the
700 W power limit): HBM3 at 3.35 TB/s; 67 TFLOP/s float32 outside the
tensor cores, the closest entry for the relation kernels' int32 compare and
select work; 989 TFLOP/s bf16 on the tensor cores; 495 TFLOP/s TF32, of
which a float32-accurate product takes three (3xTF32), so float32
attention is priced at a third of it. The card has 132 multiprocessors,
and one block may opt into 227 KiB of shared memory.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple, Union

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
FLOPS_PER_S = {"bfloat16": 989e12, "float32": 495e12 / 3}
SMS = 132
SMEM_OPTIN_BYTES = 227 * 1024

# (arity of x, arity of y) of the sub-join relations, the arity of each
# simplex kind, and the arm of each relation-entry relation
_SUB_ARITY = {"EF": (2, 3), "ET": (2, 4), "FT": (3, 4)}
KIND_ARITY = {"V": 1, "E": 2, "F": 3, "T": 4}
ENTRY_ARM = {"VV": "VV", "VE": "member", "VF": "member", "VT": "member",
             "TT": "TT", "EF": "sub", "ET": "sub", "FT": "sub"}

Counts = Union[None, int, Sequence[int]]


def kernel_roofline(ops: float, hbm_bytes: float,
                    ops_per_s: float = INT32_OPS_PER_S) -> Dict[str, float]:
    """Roofline terms of one launch that does ``ops`` operations at
    ``ops_per_s`` and moves ``hbm_bytes``: the reference's dict
    (``t_compute_s``, ``t_memory_s``, ``t_collective_s``, ``bottleneck``,
    ``roofline_fraction``) at the H100's rates. One card: no collective."""
    tc = float(ops) / ops_per_s
    tm = float(hbm_bytes) / HBM_BYTES_PER_S
    total = max(tc, tm)
    return {"t_compute_s": tc, "t_memory_s": tm, "t_collective_s": 0.0,
            "bottleneck": "compute" if tc > tm else "memory",
            "roofline_fraction": tc / total if total > 0 else 0.0}


@dataclasses.dataclass(frozen=True)
class Work:
    """What one launch must do: ``nbytes`` moved, ``ops`` operations at
    ``ops_per_s``."""

    nbytes: float
    ops: float = 0.0
    ops_per_s: float = INT32_OPS_PER_S

    def roofline(self) -> Dict[str, float]:
        return kernel_roofline(self.ops, self.nbytes, self.ops_per_s)

    def bound_s(self) -> float:
        """The least time the card could take, in seconds."""
        r = self.roofline()
        return max(r["t_compute_s"], r["t_memory_s"])

    def bound_ms(self) -> Tuple[float, str]:
        """``(ms, "bytes" | "operations")``: the bound and what sets it
        (bytes on a tie, as ``chip_smoke.py`` always reported)."""
        r = self.roofline()
        if r["t_memory_s"] >= r["t_compute_s"]:
            return r["t_memory_s"] * 1e3, "bytes"
        return r["t_compute_s"] * 1e3, "operations"


def sort_ops(sorts: Sequence[int]) -> float:
    """Comparisons that comparison sorts of these sizes need: n log2 n for
    each sort of n > 1 entries."""
    return float(sum(n * math.log2(n) for n in sorts if n > 1))


def _per_segment(counts: Counts, B: int, full: int) -> list:
    if counts is None:
        return [full] * B
    if isinstance(counts, int):
        return [counts] * B
    counts = [int(c) for c in counts]
    if len(counts) != B:
        raise ValueError(f"{len(counts)} counts for {B} segments")
    return counts


def entry_work(relation: str, B: int, nvl: int, NX: int, NY: int, deg: int,
               first: Counts = None, emitted: Counts = None) -> Work:
    """One launch of a relation-entry kernel (either route) over B segments:
    its tables read once, its ``col_global`` map read once, ``M (B, R,
    deg)`` and ``L (B, R)`` int32 written once, and n log2 n comparisons
    for each sort of the entries (the row bound counts the same work
    whatever implements it).

    Shapes, as the engine stages them: VV reads the ``(NX, 4)`` tet table
    and ``(nvl,)`` vertex map, R = ``nvl``; VE/VF/VT the ``(NY, arity)``
    coface table and its map, R = ``nvl``; TT the ``(NX, 4)`` tets and
    their map, R = ``NX``; EF/ET/FT the ``(NX, ax)`` subject and ``(NY,
    ay)`` coface tables and the coface map, R = ``NX``.

    ``first`` (per segment, or one count for all) is the valid entries of
    the first sort: VV the ordered pairs of valid tet slots, VE/VF/VT the
    valid slots, TT four face keys a valid tet, EF/ET/FT the valid subject
    rows plus the valid cofaces' subsets; VV and VE/VF/VT sort them twice.
    ``emitted`` (TT, EF/ET/FT) is the entries of the block, sorted twice
    after the join. ``None`` counts full tables: every row valid, and for
    TT and the sub-join every join lane emitted."""
    arm = ENTRY_ARM[relation]
    joined = 0                                # join lanes: TT, sub-join
    if arm == "VV":
        cols, R, full = nvl, nvl, 12 * NX
    elif arm == "member":
        cols, R, full = NY, nvl, KIND_ARITY[relation[1]] * NY
    elif arm == "TT":
        cols, R, full, joined = NX, NX, 4 * NX, 4 * NX
    else:
        ax, ay = _SUB_ARITY[relation]
        joined = math.comb(ay, ax) * NY
        cols, R, full = NY, NX, NX + joined
    firsts = _per_segment(first, B, full)
    if arm in ("VV", "member"):
        sorts = firsts * 2
    else:
        sorts = firsts + _per_segment(emitted, B, joined) * 2
    moved = table_bytes(relation, B, nvl, NX, NY) + B * cols * 4 \
        + B * R * (deg + 1) * 4
    return Work(moved, sort_ops(sorts))


def table_bytes(relation: str, B: int, nvl: int, NX: int, NY: int) -> int:
    """Bytes of the tables one walk of a relation-entry launch reads: what
    each extra bitmask share reads again (:mod:`.autotune`)."""
    arm = ENTRY_ARM[relation]
    if arm in ("VV", "TT"):
        return B * NX * 16
    if arm == "member":
        return B * NY * KIND_ARITY[relation[1]] * 4
    ax, ay = _SUB_ARITY[relation]
    return B * (NX * ax + NY * ay) * 4


def gather_work(P: int, K: int, degp: int) -> Work:
    """One resolve + gather launch of P pairs over inverse maps of K
    appearances and a pool of ``degp``-wide rows: the three pair columns
    in, each pair's bisection (a segment and a gid word a step, ``ceil(log2
    K) + 1`` steps, then its row), its pool row and length read, and
    ``cand (P, degp)`` + ``clen (P,)`` written."""
    steps = math.ceil(math.log2(max(int(K), 2))) + 1
    return Work(P * 12 + P * (steps * 8 + 4) + 2 * P * (degp + 1) * 4)


def meet_work(B: int, NX: int, ax: int, NY: int, ay: int) -> Work:
    """One meet-count launch: both tables read, ``C (B, NX, NY)`` int32
    written, and ``ax * ay`` slot compares an output."""
    return Work(B * (NX * ax + NY * ay) * 4 + B * NX * NY * 4,
                float(B * NX * NY * ax * ay))


def vv_counts_work(B: int, NT: int, nvl: int,
                   valid_tets: Optional[int] = None) -> Work:
    """One VV-count launch: the tets read, ``C (B, nvl, nvl)`` int32
    written, one add for each ordered slot pair of each valid tet (all B *
    NT when ``valid_tets`` is None)."""
    valid = B * NT if valid_tets is None else int(valid_tets)
    return Work(B * NT * 16 + B * nvl * nvl * 4, 16.0 * valid)


def attention_pairs(S: int, T: int, causal: bool) -> int:
    """(query, key) pairs attention scores: every one unmasked; under the
    causal mask query s sees keys 0..s (``min(s + 1, T)`` of them)."""
    if not causal:
        return S * T
    m = min(S, T)
    return m * (m + 1) // 2 + (S - m) * T


def flash_work(B: int, S: int, T: int, H: int, KV: int, hd: int,
               causal: bool, dtype: str) -> Work:
    """One forward attention launch, ``dtype`` ``"bfloat16"`` or
    ``"float32"``: q, k and v read and o written once, and four flops a
    (query, key) pair and head dimension (QK^T and PV) at the dtype's
    tensor-core rate."""
    es = {"bfloat16": 2, "float32": 4}[dtype]
    moved = (2 * B * S * H + 2 * B * T * KV) * hd * es
    flops = 4 * B * H * hd * attention_pairs(S, T, causal)
    return Work(moved, float(flops), FLOPS_PER_S[dtype])


def model_flops(cfg, shape) -> float:
    """The reference's MODEL_FLOPS (``launch/roofline.py``): 6 N D for a
    train step, 2 N D for inference, N the active parameters (a MoE's
    routed experts only), D the tokens of the global batch a step (one per
    row in decode). The dry run divides it by the mesh's devices."""
    n = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6 if shape.kind == "train" else 2
    return mult * n * tokens
