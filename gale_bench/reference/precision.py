"""The precision a plain reference computes its products in.

``"float32"``: every product in full float32 (TF32 off, see
:func:`full_fp32`). ``"fp8"``: the control, the precision below the bf16
that the configurations state: each product's operands rounded to float8
(e4m3 in the forward, the output gradient in e5m2 in the backward, as fp8
training keeps them) at one scale a tensor, its largest magnitude at the
format's largest finite value, then multiplied in float32.
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("float32", "fp8")
_FP8 = {"e4m3": (torch.float8_e4m3fn, 448.0),
        "e5m2": (torch.float8_e5m2, 57344.0)}


@contextlib.contextmanager
def full_fp32():
    """Float32 products without TF32 for the block, on the card and off."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def round_fp8(t: torch.Tensor, fmt: str = "e4m3") -> torch.Tensor:
    """``t`` (float32) rounded to float8 at one scale for the tensor, back
    in float32."""
    dtype, fmax = _FP8[fmt]
    scale = t.detach().abs().amax().clamp_min(1e-30) / fmax
    return (t / scale).to(dtype).to(torch.float32) * scale


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` (equal batch dimensions, no broadcasting) with fp8
    operands in both passes."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = round_fp8(a), round_fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = round_fp8(g, "e5m2")
        return qg @ _t(qb), _t(qa) @ qg


class Precision:
    """The products of a reference run: ``mm(a, b)`` of float32 operands
    with equal batch dimensions (a 2-d ``b`` for a 2-d ``a``)."""

    def __init__(self, name: str = "float32"):
        if name not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got "
                             f"{name!r}")
        self.name = name

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = a.float(), b.float()
        if self.name == "fp8":
            return _Fp8Matmul.apply(a, b)
        return a @ b
