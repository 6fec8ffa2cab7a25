"""Flash attention forward for the LM substrate: the wrappers of the three
hand-written Hopper kernels and their plain PyTorch version.

Blocked online-softmax attention over q ``(B, S, H, hd)`` and k/v ``(B, T,
KV, hd)`` with KV dividing H (query head ``h`` reads KV head ``h // (H //
KV)``, ``jnp.repeat``'s mapping, which is ``torch.repeat_interleave``):
causal with the mask ``t <= s`` aligned top-left from position 0, or
unmasked; scores scaled by ``1/sqrt(hd)``, float32 softmax and
accumulation, the output in q's type (float32 or bf16). Any ``S`` and
``T`` are taken: the kernels mask ragged tiles themselves.

The kernels replace the reference's TPU kernel ``_flash_fwd_kernel``
(``kernels/flash_attention.py``, launched by ``flash_attention_bh``; GQA
wrapper ``flash_attention``). The model's ``"cuda"`` arm sends every
attention without a KV cache here (``models.layers.attention``).

Routing (:func:`_variant`), by dtype and shape, decided before the launch
between the first two kernels; nothing falls back after a failed build or
launch:

- ``"wgmma"`` -> ``flash_fwd_wgmma`` (``csrc/flash_attention_wgmma.cu``):
  bf16 q, k, v with hd 64, 128 or 256 whose layout TMA can read (every
  base address and every batch, sequence and head stride a multiple of 16
  bytes; :func:`wgmma_problems`). Products on the tensor cores, K/V tiles
  by TMA, P rounded to bf16 for the PV product. Every bf16 attention of
  qwen2-7b (hd 128) and whisper-base (hd 64) takes it.
- ``"mma"`` -> ``flash_fwd_mma`` (``csrc/flash_attention_mma.cu``): every
  float32 input, at any hd up to 256, and the bf16 inputs the wgmma kernel
  does not take (hd 80 and other head dims, layouts TMA cannot read).
  ``mma.sync`` on the tensor cores: float32 products as 3xTF32 (each
  operand split into two TF32 parts, three products, which holds the
  float32 tolerance where one TF32 product, 10 mantissa bits, would not);
  bf16 as one bf16 product with P rounded to bf16. K/V tiles by
  ``cp.async``, 16 bytes a thread where :func:`vec_loads` allows it.
- ``"simt"`` -> ``flash_fwd_kernel`` (``csrc/flash_attention.cu``): float32
  FMAs on the CUDA cores. On no route: only
  ``flash_attention_cuda(..., simt=True)`` launches it, so that it can be
  held against the plain version and timed beside the others.

Backends (:func:`~repro_torch.kernels.ops.resolve_backend`): ``"cuda"``
launches a kernel on CUDA tensors and raises on anything else;
``"torch"`` runs :func:`flash_attention_ref`, the plain version the kernels
are held against. ``backend=None`` picks ``"cuda"`` on a card and
``"torch"`` on the CPU. ``LAUNCHES["flash"]`` counts every kernel launch,
``LAUNCHES["flash_wgmma"]``, ``LAUNCHES["flash_mma"]`` and
``LAUNCHES["flash_simt"]`` each kernel's.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, List, Optional, Tuple

import torch

from . import _build
from .ops import resolve_backend

# masked scores in the plain version, as in the TPU kernel and ``_sdpa``
NEG_INF = -1e30
# query rows per step of the plain version (bounds its score buffer)
REF_Q_CHUNK = 1024
# the grid's y and z extents (heads, batch) and the kernels' widest head
_GRID_YZ = 65535
_MAX_HD = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the wgmma kernel: its head dims, query rows per block, TMA's alignment
WGMMA_HEAD_DIMS = (64, 128, 256)
_WGMMA_Q_TILE = 128
_TMA_ALIGN = 16
_TMA_MAX_STRIDE = 1 << 40

# the mma kernel's 16-byte K/V loads
_VEC_BYTES = 16

LAUNCHES: Dict[str, int] = {"flash": 0, "flash_wgmma": 0, "flash_mma": 0,
                            "flash_simt": 0}
_LAUNCH_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib_wgmma() -> ctypes.CDLL:
    lib = _build.load("flash_attention_wgmma")
    if not getattr(lib, "_repro_bound", False):
        lib.faw_error_string.argtypes = [_I]
        lib.faw_error_string.restype = ctypes.c_char_p
        lib.faw_forward.argtypes = [_I, _P, _P, _P, _P,
                                    ctypes.POINTER(ctypes.c_longlong),
                                    _I, _I, _I, _I, _I, _I, _I,
                                    ctypes.c_float, _P]
        lib.faw_forward.restype = _I
        lib._repro_bound = True
    return lib


def _lib_mma() -> ctypes.CDLL:
    lib = _build.load("flash_attention_mma")
    if not getattr(lib, "_repro_bound", False):
        lib.fam_error_string.argtypes = [_I]
        lib.fam_error_string.restype = ctypes.c_char_p
        lib.fam_forward.argtypes = [_I, _I, _P, _P, _P, _P,
                                    ctypes.POINTER(ctypes.c_longlong),
                                    _I, _I, _I, _I, _I, _I, _I,
                                    ctypes.c_float, ctypes.c_float, _I, _P]
        lib.fam_forward.restype = _I
        lib._repro_bound = True
    return lib


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


def wgmma_problems(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                   ) -> List[str]:
    """Why ``flash_fwd_wgmma`` cannot take q, k, v ``(B, S|T, heads, hd)``
    (empty when it can): the dtype, the head dim, and what TMA needs of
    each tensor: a 16-byte aligned base address, and batch, sequence and
    head strides that are positive multiples of 16 bytes below 2**40 (a
    dimension of size 1 is never stepped, so its stride is not checked),
    and the grid's limits."""
    out = []
    if q.dtype != torch.bfloat16:
        out.append(f"dtype {q.dtype} is not bf16")
    hd = q.shape[-1]
    if hd not in WGMMA_HEAD_DIMS:
        out.append(f"head dim {hd} is not one of {WGMMA_HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        esz = t.element_size()
        if t.data_ptr() % _TMA_ALIGN:
            out.append(f"{name}'s base address is not {_TMA_ALIGN}-byte "
                       f"aligned")
        for dim, label in enumerate(("batch", "sequence", "head")):
            st = t.stride(dim) * esz
            if t.shape[dim] > 1 and (st % _TMA_ALIGN or st <= 0
                                     or st >= _TMA_MAX_STRIDE):
                out.append(f"{name}'s {label} stride of {st} bytes is not a "
                           f"positive multiple of {_TMA_ALIGN} below 2**40")
    B, S = q.shape[:2]
    if B > _GRID_YZ or -(-S // _WGMMA_Q_TILE) > _GRID_YZ:
        out.append(f"B={B}, S={S} exceed the wgmma kernel's grid")
    return out


def _variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel that takes q, k, v: ``"wgmma"`` for bf16 at hd 64, 128
    or 256 with a layout TMA reads, else ``"mma"``."""
    return "mma" if wgmma_problems(q, k, v) else "wgmma"


def vec_loads(k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the mma kernel may read k and v ``(B, T, KV, hd)`` 16 bytes
    a thread: both base addresses, the batch, sequence and head strides of
    each (of dimensions longer than 1) and ``hd`` times the element size
    all multiples of 16 bytes. Else it loads element by element."""
    esz = k.element_size()
    if (k.shape[-1] * esz) % _VEC_BYTES:
        return False
    for t in (k, v):
        if t.data_ptr() % _VEC_BYTES:
            return False
        if any(n > 1 and (st * esz) % _VEC_BYTES
               for n, st in zip(t.shape[:3], t.stride()[:3])):
            return False
    return True


def _tma_strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """``t``'s batch, sequence and head strides (elements) for a tensor
    map: a dimension of size 1 takes the stride a contiguous tensor would
    have, which TMA accepts and the kernel never steps."""
    return tuple(st if n > 1 else math.prod(t.shape[d + 1:])
                 for d, (n, st) in enumerate(zip(t.shape[:3],
                                                 t.stride()[:3])))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         simt: bool = False) -> torch.Tensor:
    """Launch a kernel: q ``(B, S, H, hd)``, k/v ``(B, T, KV, hd)``, CUDA
    float32 or bf16 tensors on one device with unit stride along hd (the
    other strides are passed through, so views of the model's activations
    are read in place). Returns a new contiguous ``(B, S, H, hd)`` tensor;
    launches on the current stream without synchronising.

    The kernel is :func:`_variant`'s choice; ``simt=True`` launches
    ``flash_fwd_kernel`` whatever that choice (it is on no route), so that
    it can be held and timed on the same inputs as the others."""
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
    variant = "simt" if simt else _variant(q, k, v)
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    dev = q.device
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if variant == "wgmma":
        strides = (ctypes.c_longlong * 12)(*(
            st for t in (q, k, v, o) for st in _tma_strides(t)))
        lib = _lib_wgmma()
        rc = lib.faw_forward(idx, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             o.data_ptr(), strides, B, S, T, H, KV, hd,
                             int(bool(causal)),
                             math.log2(math.e) / math.sqrt(hd), stream)
        err = lib.faw_error_string
    else:
        strides = (ctypes.c_longlong * 12)(*(
            st for t in (q, k, v, o) for st in t.stride()[:3]))
        args = (idx, _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), strides, B, S, T, H, KV, hd,
                int(bool(causal)), 1.0 / math.sqrt(hd))
        if variant == "mma":
            lib = _lib_mma()
            rc = lib.fam_forward(*args, math.log2(math.e) / math.sqrt(hd),
                                 int(vec_loads(k, v)), stream)
            err = lib.fam_error_string
        else:
            lib = _lib()
            rc = lib.fa_forward(*args, stream)
            err = lib.fa_error_string
    if rc != 0:
        msg = err(rc).decode(errors="replace")
        raise RuntimeError(f"flash attention kernel ({variant}) launch "
                           f"failed: error {rc} ({msg})")
    with _LAUNCH_LOCK:
        LAUNCHES["flash"] += 1
        LAUNCHES[f"flash_{variant}"] += 1
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
