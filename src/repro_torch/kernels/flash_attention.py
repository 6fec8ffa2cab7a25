"""Flash attention forward for the LM substrate: the wrapper of the
hand-written Hopper kernel (``csrc/flash_attention.cu``) and its plain
PyTorch version.

Blocked online-softmax attention over q ``(B, S, H, hd)`` and k/v ``(B, T,
KV, hd)`` with KV dividing H (query head ``h`` reads KV head ``h // (H //
KV)``, ``jnp.repeat``'s mapping, which is ``torch.repeat_interleave``):
causal with the mask ``t <= s`` aligned top-left from position 0, or
unmasked; q scaled by ``1/sqrt(hd)`` before the product, float32 softmax
and accumulation, the output in q's type (float32 or bf16). Any ``S`` and
``T`` are taken: the kernel masks ragged tiles itself.

It replaces the reference's TPU kernel ``_flash_fwd_kernel``
(``kernels/flash_attention.py``, launched by ``flash_attention_bh``; GQA
wrapper ``flash_attention``). The model's ``"cuda"`` arm sends every
attention without a KV cache here (``models.layers.attention``).

Backends (:func:`~repro_torch.kernels.ops.resolve_backend`): ``"cuda"``
launches the kernel on CUDA tensors and raises on anything else;
``"torch"`` runs :func:`flash_attention_ref`, the plain version the kernel
is held against. ``backend=None`` picks ``"cuda"`` on a card and
``"torch"`` on the CPU. ``LAUNCHES["flash"]`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, Optional

import torch

from . import _build
from .ops import resolve_backend

# masked scores in the plain version, as in the TPU kernel and ``_sdpa``
NEG_INF = -1e30
# query rows per step of the plain version (bounds its score buffer)
REF_Q_CHUNK = 1024
# the grid's y and z extents (heads, batch) and the kernel's widest head
_GRID_YZ = 65535
_MAX_HD = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: Dict[str, int] = {"flash": 0}
_LAUNCH_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if not getattr(lib, "_repro_bound", False):
        lib.fa_error_string.argtypes = [_I]
        lib.fa_error_string.restype = ctypes.c_char_p
        lib.fa_forward.argtypes = [_I, _I, _P, _P, _P, _P,
                                   ctypes.POINTER(ctypes.c_longlong),
                                   _I, _I, _I, _I, _I, _I, _I,
                                   ctypes.c_float, _P]
        lib.fa_forward.restype = _I
        lib._repro_bound = True
    return lib


def _check_shapes(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name} must be a 4-d tensor (B, S|T, heads, "
                             f"hd), got {getattr(t, 'shape', type(t))}")
    B, _, H, hd = q.shape
    _, T, KV, _ = k.shape
    if tuple(k.shape) != (B, T, KV, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be (B={B}, T, KV, hd={hd}) alike, "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"KV={KV} must divide H={H}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v must share one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """The plain version: the same function in float32 torch ops on the
    tensors' own device, a chunk of query rows at a time."""
    _check_shapes(q, k, v)
    S, H, hd = q.shape[1:]
    T, KV = k.shape[1], k.shape[2]
    rep = H // KV
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    kf = k.float().repeat_interleave(rep, dim=2) if rep > 1 else k.float()
    vf = v.float().repeat_interleave(rep, dim=2) if rep > 1 else v.float()
    t_pos = torch.arange(T, device=q.device)
    outs = []
    for s0 in range(0, S, REF_Q_CHUNK):
        qc = q[:, s0:s0 + REF_Q_CHUNK].float() * scale.to(q.device)
        s = torch.einsum("bshd,bthd->bhst", qc, kf)
        if causal:
            q_pos = torch.arange(s0, s0 + qc.shape[1], device=q.device)
            s = s.masked_fill(t_pos[None, :] > q_pos[:, None], NEG_INF)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhst,bthd->bshd", p, vf))
    return torch.cat(outs, dim=1).to(q.dtype)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """Launch the kernel: q ``(B, S, H, hd)``, k/v ``(B, T, KV, hd)``, CUDA
    float32 or bf16 tensors on one device with unit stride along hd (the
    other strides are passed through, so views of the model's activations
    are read in place). Returns a new contiguous ``(B, S, H, hd)`` tensor;
    launches on the current stream without synchronising."""
    _check_shapes(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride along hd")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must share one device")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes float32 or bf16, got {q.dtype}")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if T < 1:
        raise ValueError("attention needs at least one key (T >= 1)")
    if not 1 <= hd <= _MAX_HD:
        raise ValueError(f"head dim {hd} outside the kernel's 1..{_MAX_HD}")
    if B > _GRID_YZ or H > _GRID_YZ:
        raise ValueError(f"B={B}, H={H} exceed the kernel's grid")
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    strides = (ctypes.c_longlong * 12)(*(
        st for t in (q, k, v, o) for st in t.stride()[:3]))
    dev = q.device
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    lib = _lib()
    rc = lib.fa_forward(idx, _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), o.data_ptr(), strides, B, S, T, H, KV,
                        hd, int(bool(causal)), 1.0 / math.sqrt(hd),
                        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.fa_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"flash attention kernel launch failed: "
                           f"cudaError {rc} ({msg})")
    with _LAUNCH_LOCK:
        LAUNCHES["flash"] += 1
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, backend: Optional[str] = None
                    ) -> torch.Tensor:
    """q ``(B, S, H, hd)``, k/v ``(B, T, KV, hd)`` with KV | H (GQA) ->
    ``(B, S, H, hd)`` in q's dtype."""
    if resolve_backend(backend, q.device) == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal)
    return flash_attention_ref(q, k, v, causal=causal)


def flash_attention_bh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, backend: Optional[str] = None
                       ) -> torch.Tensor:
    """q ``(BH, S, hd)``, k/v ``(BH, T, hd)`` -> ``(BH, S, hd)``: one head
    per leading index, the reference's layout."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 3:
            raise ValueError(f"{name} must be a 3-d tensor (BH, S|T, hd)")
    out = flash_attention(q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2),
                          causal=causal, backend=backend)
    return out.squeeze(2)
