"""The yardstick's frozen arithmetic: the H100's peaks, the roofline of one
launch, the flash-attention forward's work, and the device's idle share.

Copied from the port (``repro_torch/launch/roofline.py``: the peaks,
``kernel_roofline``, ``attention_pairs``, ``flash_work``;
``repro_torch/profile_path.py``: the idle share) so that a later change to
the program cannot move the benchmark's scale.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at the 700 W
power limit): HBM3 at 3.35 TB/s, 989 TFLOP/s bf16 on the tensor cores, 495
TFLOP/s TF32, of which a float32-accurate product takes three.
"""

from __future__ import annotations

from typing import Dict, Tuple

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"bfloat16": 989e12, "float32": 495e12 / 3}
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def kernel_roofline(ops: float, hbm_bytes: float, ops_per_s: float
                    ) -> Dict[str, float]:
    """The least time one launch can take: ``ops`` operations at
    ``ops_per_s`` against ``hbm_bytes`` at the HBM rate; the larger term
    bounds it."""
    tc = float(ops) / ops_per_s
    tm = float(hbm_bytes) / HBM_BYTES_PER_S
    return {"t_compute_s": tc, "t_memory_s": tm, "bound_s": max(tc, tm),
            "bottleneck": "compute" if tc > tm else "memory"}


def attention_pairs(S: int, T: int, causal: bool) -> int:
    """(query, key) pairs attention scores: every one unmasked; under the
    causal mask aligned top-left query s sees keys 0..s."""
    if not causal:
        return S * T
    m = min(S, T)
    return m * (m + 1) // 2 + (S - m) * T


def flash_work(B: int, S: int, T: int, H: int, KV: int, hd: int,
               causal: bool, dtype: str) -> Tuple[float, float, float]:
    """One forward attention launch: (bytes, flops, flops per second) for
    q, k and v read and o written once, and four flops a (query, key) pair
    and head dimension (QK^T and PV) at the dtype's tensor-core rate."""
    es = ELEMENT_BYTES[dtype]
    moved = (2 * B * S * H + 2 * B * T * KV) * hd * es
    flops = 4 * B * H * hd * attention_pairs(S, T, causal)
    return float(moved), float(flops), FLOPS_PER_S[dtype]


def flash_bound_s(B: int, S: int, T: int, H: int, KV: int, hd: int,
                  causal: bool, dtype: str) -> float:
    moved, flops, rate = flash_work(B, S, T, H, KV, hd, causal, dtype)
    return kernel_roofline(flops, moved, rate)["bound_s"]


def idle_share(busy_s: float, window_s: float) -> float:
    """``1 - busy / wall``: the share of the window in which no operation
    ran on the device (``busy``: the sum of the device operations' own
    times)."""
    return 1.0 - busy_s / window_s
