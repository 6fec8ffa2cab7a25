"""Python wrapper of the hand-written Hopper kernels for the sparse relation
entry assembly (``csrc/segment_relations.cu``).

Each launch emits the padded ``(M (B, R, deg), L (B, R))`` blocks of B
batched segments straight from their local tables. Four arms:

  - ``"VV"``     — the 12 ordered vertex pairs of every local tet;
  - ``"member"`` — VE/VF/VT, where the ``(NY, arity)`` table is the entry
                   list;
  - ``"TT"``     — one sort of the tets' canonical face keys; each face
                   lane keeps its equal neighbours' tets in two partner
                   slots, and one thread per tet builds its row from its
                   four lanes' slots (no entry inversion);
  - ``"sub"``    — EF/ET/FT: subject x relates to coface y iff x's sorted
                   vertex key is the key of one of y's vertex subsets.

VV, member and sub have two routes, chosen in Python before the launch by
:func:`entry_route`:

  - ``"bits"``   — ``vv_bits_kernel`` / ``member_bits_kernel`` /
                   ``sub_bits_kernel``: a share of one segment's ``(row,
                   order)`` relation as a bitmask in shared memory (rows of
                   ``ceil(O / 32)`` words, O = ``nvl`` for VV and NY
                   otherwise), set by atomics in one walk of the table and
                   emitted one warp a row, with no sort; the sub-join probes
                   a shared-memory lookup of the block's own subject keys
                   (raised to a later row of the segment that repeats a
                   key) for each coface subset, and emits its sparse rows
                   one thread a row, or a few lanes a row where a block
                   holds few wide rows. The route holds while one mask row
                   and the warps' rank rows (VV, member) or its lookup
                   (sub-join) fit the opt-in limit (:func:`bits_rows_fit`),
                   and a segment's rows are split over as many blocks as
                   the share rule (:func:`bits_row_blocks`,
                   :func:`sub_row_blocks`) or the limit asks
                   (:func:`bits_blocks`);
  - ``"sort"``   — for the tables past one row's limit (member past NY
                   109,376, the sub-join past NY 1,859,232 on an H100;
                   never VV within its int32 key guard) and for callers
                   that force it. ``vv_entries_kernel`` /
                   ``member_entries_kernel`` build a segment's relation as
                   CSR rows in a device workspace (:func:`csr_ints`): a
                   grid of (B, :func:`csr_tiles`) blocks counts each row's
                   entries in a shared-memory histogram, a scan gives the
                   row starts, the same grid places each entry's order key
                   in its row by an atomic cursor, and one warp a row sorts
                   its keys (in registers up to 128), drops duplicates and
                   emits: four launches, one count in ``LAUNCHES``. The VF
                   tables of the 48^3 quickstart mesh at capacity 8192 (NY
                   111,616) take it. ``sub_entries_kernel``: the join and
                   entry lanes sorted, deduplicated and inverted by one
                   block a segment in shared memory (or a device workspace
                   past the limit).

They replace the TPU kernels of the reference's
``kernels/segment_relations.py`` (``_vv_entries_kernel``,
``_member_entries_kernel``, ``_tt_entries_kernel`` and
``_sub_entries_kernel`` with ``_emit_entries``). The plain version of each
arm is :func:`repro_torch.kernels.ops._block_vv` /
:func:`~repro_torch.kernels.ops._block_member_v` /
:func:`~repro_torch.kernels.ops._block_tt` /
:func:`~repro_torch.kernels.ops._block_sub_join`; the kernels, on both
routes, are bit-identical to it within the arms' precondition (for the
sub-join: each subject key once; past it the bitmask kernel gives every
entry of a repeated key to its largest subject row).

Two more kernels (``csrc/counts.cu``) compute the count blocks of the dense
fallback arm, from which ``ops`` builds ``(M, L)`` by predicate and
compaction: :func:`relation_counts_meet_cuda` (shared-vertex counts,
replacing ``_meet_kernel``) and :func:`relation_counts_vv_cuda`
(shared-tet counts, replacing ``_vv_kernel``). Their plain versions are
:func:`repro_torch.kernels.ops._counts_pairwise` and
:func:`~repro_torch.kernels.ops._counts_vv_onehot`; the kernels are
bit-identical to them.

The wrappers take CUDA int32 tensors only and raise on anything else; they
allocate the outputs (and the VV and member sort route's workspace, or,
when the TT or sub-join kernel's lanes exceed the per-block shared-memory
limit, a lane workspace in device memory), launch on the
current stream without synchronising, and raise on a refused launch.
``LAUNCHES`` counts kernel launches per arm (``"meet"`` and
``"vv_counts"`` for the two count kernels), and per route for VV, member
and sub (``"VV_bits"``, ``"VV_sort"``, ``"member_bits"``,
``"member_sort"``, ``"sub_bits"``, ``"sub_sort"``).
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, Optional, Tuple

import torch

from . import _build

LAUNCHES: Dict[str, int] = {"VV": 0, "VV_bits": 0, "VV_sort": 0,
                             "member": 0, "member_bits": 0, "member_sort": 0,
                             "TT": 0, "sub": 0, "sub_bits": 0, "sub_sort": 0,
                             "meet": 0, "vv_counts": 0}
_LAUNCH_LOCK = threading.Lock()
_SMEM_LIMIT: Dict[int, int] = {}
_SMS: Dict[int, int] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("segment_relations")
    if not getattr(lib, "_repro_bound", False):
        lib.sr_smem_optin_limit.argtypes = [_I, ctypes.POINTER(_I)]
        lib.sr_smem_optin_limit.restype = _I
        lib.sr_error_string.argtypes = [_I]
        lib.sr_error_string.restype = ctypes.c_char_p
        lib.repro_error_string = lib.sr_error_string
        lib.sr_vv_entries.argtypes = [_I, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _I, _I, _P]
        lib.sr_vv_entries.restype = _I
        lib.sr_member_entries.argtypes = [_I, _P, _P, _P, _P, _P,
                                          _I, _I, _I, _I, _I, _I, _P]
        lib.sr_member_entries.restype = _I
        lib.sr_vv_bits.argtypes = [_I, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _I, _I, _P]
        lib.sr_vv_bits.restype = _I
        lib.sr_member_bits.argtypes = [_I, _P, _P, _P, _P,
                                       _I, _I, _I, _I, _I, _I, _P]
        lib.sr_member_bits.restype = _I
        lib.sr_tt_entries.argtypes = [_I, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _I, _P]
        lib.sr_tt_entries.restype = _I
        lib.sr_sub_entries.argtypes = [_I, _P, _P, _P, _P, _P, _P,
                                       _I, _I, _I, _I, _I, _I, _I, _I, _P]
        lib.sr_sub_entries.restype = _I
        lib.sr_sub_bits.argtypes = [_I, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _I, _I, _P]
        lib.sr_sub_bits.restype = _I
        lib._repro_bound = True
    return lib


def _counts_lib() -> ctypes.CDLL:
    lib = _build.load("counts")
    if not getattr(lib, "_repro_bound", False):
        lib.ct_error_string.argtypes = [_I]
        lib.ct_error_string.restype = ctypes.c_char_p
        lib.repro_error_string = lib.ct_error_string
        lib.ct_meet_counts.argtypes = [_I, _P, _P, _P, _I, _I, _I, _I, _I, _P]
        lib.ct_meet_counts.restype = _I
        lib.ct_vv_counts.argtypes = [_I, _P, _P, _I, _I, _I, _I, _P]
        lib.ct_vv_counts.restype = _I
        lib._repro_bound = True
    return lib


def _check_rc(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.repro_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} failed: cudaError {rc} ({msg})")


def next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def lane_ints(E: int, R: int) -> int:
    """int32 words of one segment's lanes in the sub-join's sort kernel:
    keys, values, the R + 1 row starts."""
    return 2 * E + R + 1


def csr_ints(n: int, nvl: int) -> int:
    """int32 words of one segment's workspace on the VV and member sort
    route (``vv_entries_kernel``, ``member_entries_kernel``): its ``nvl``
    row counts (the place pass's cursors after the scan), its ``nvl + 1``
    row starts, and its ``n`` order keys (``n = 12 * NT`` for VV, ``arity
    * NY`` for member). Values are not stored: each is a function of its
    order key."""
    return n + 2 * nvl + 1


# blocks that fill the card: the count and place passes of the sort route
# aim at this many blocks a multiprocessor over a launch
_CSR_BLOCKS_PER_SM = 4
# entries a count or place block walks at least, so that zeroing and
# flushing its nvl-int histogram stays a small share of its work
_CSR_MIN_TILE = 2048


def csr_tiles(B: int, n: int, sms: int) -> int:
    """Blocks that share one segment's ``n`` entries in the count and place
    passes of the VV and member sort route: as many as put
    ``_CSR_BLOCKS_PER_SM`` blocks on each of the card's ``sms``
    multiprocessors over B segments, no more than give each block
    ``_CSR_MIN_TILE`` entries, at least one, at most the grid's 65,535."""
    want = -(-_CSR_BLOCKS_PER_SM * sms // max(B, 1))
    return max(1, min(want, -(-n // _CSR_MIN_TILE), 65535))


# face lanes one warp of the TT kernel sorts in registers (kTTChunk)
_TT_CHUNK = 128


def tt_face_lanes(NT: int) -> int:
    """Face lanes of one TT segment: ``4 * NT`` up to a power of two, at
    least one warp's chunk."""
    return max(_TT_CHUNK, next_pow2(4 * NT))


def tt_lane_ints(NT: int, deg: int) -> int:
    """int32 words of one TT segment's working set: the sorted 64-bit face
    lanes (whose space the staged ``M`` rows reuse), then two partner slots
    per face lane (``tt_lane_ints`` of ``csrc/segment_relations.cu``)."""
    m = NT * deg
    return max(2 * tt_face_lanes(NT), m + m % 2) + 8 * NT


# static shared memory of the sub-join kernel (its scan's warp carries)
_SUB_STATIC_SMEM = 32 * 4

# (arity of x, arity of y) of the sub-join relations
_SUB_ARITY = {"EF": (2, 3), "ET": (2, 4), "FT": (3, 4)}


# warps of a bitmask block (kBitsWarps): each emits one row at a time
_BITS_WARPS = 16
# VE/VF/VT: the member arm
_MEMBER = ("VE", "VF", "VT")
# the arms with two routes
_ROUTED = ("VV", "member", "sub")


def sub_slots(rows: int) -> int:
    """Slots of the key lookup of a sub-join bitmask block that holds
    ``rows`` subject rows: ``next_pow2(4 * rows)``, at least 4, so open
    addressing runs at a load of at most one quarter (``sub_slots`` of
    ``csrc/segment_relations.cu``)."""
    return max(4, next_pow2(4 * rows))


def _row_words(O: int, sub: bool) -> int:
    """Words a mask row takes: ``ceil(O / 32)``, made odd for the
    sub-join, whose rows one thread each reads (an odd stride spreads a
    warp over the 32 banks)."""
    W = -(-O // 32)
    return W | 1 if sub else W


def bits_smem_bytes(rows: int, O: int, sub: bool = False) -> int:
    """Shared memory of one bitmask block, in bytes. VV and member:
    ``rows`` mask rows and one rank row per warp, each ``ceil(O / 32)``
    words (``bits_smem_ints`` of ``csrc/segment_relations.cu``). The
    sub-join (``sub``): ``rows`` mask rows of ``ceil(O / 32) | 1`` words,
    then the lookup of those rows' keys, :func:`sub_slots` slots of a key
    and an x index, and the least and largest key it holds
    (``sub_bits_smem_ints``)."""
    if sub:
        return 4 * rows * _row_words(O, True) + 8 * sub_slots(rows) + 8
    return 4 * (rows + _BITS_WARPS) * _row_words(O, False)


def _orders(relation: str, nvl: int, NY: int) -> int:
    """Orders O (columns) of one segment's bitmask."""
    if relation == "VV":
        return nvl
    if relation in _MEMBER or relation in _SUB_ARITY:
        return NY
    raise KeyError(f"relation {relation!r} has one entry kernel")


def bits_rows_fit(relation: str, nvl: int, NY: int, limit: int) -> int:
    """Mask rows one bitmask block holds in ``limit`` bytes of shared
    memory beside its rank rows (VV, VE/VF/VT) or the lookup of its rows'
    keys (EF/ET/FT); 0 where not one row fits. ``NY`` is the coface
    table's rows (ignored for VV). The sub-join's lookup grows with the
    rows (:func:`sub_slots`), so its fit is the best over the lookup's
    power-of-two sizes S of ``min(S / 4, (limit - 8 S - 8) / (4 Ws))``."""
    O = _orders(relation, nvl, NY)
    if relation not in _SUB_ARITY:
        spare = limit - bits_smem_bytes(0, O)
        W = _row_words(O, False)
        if spare < 0:
            return 0
        return spare // (4 * W) if W else max(nvl, 1)
    row = 4 * _row_words(O, True)
    best, S = 0, 4
    while 8 * S + 8 + row <= limit:
        best = max(best, min(S // 4, (limit - 8 * S - 8) // row))
        S *= 2
    return best


def entry_route(relation: str, nvl: int, NY: int, limit: int) -> str:
    """The kernel that serves a VV, VE/VF/VT or EF/ET/FT block:
    ``"bits"`` while one mask row fits beside the rank rows or its lookup
    (:func:`bits_rows_fit`), ``"sort"`` otherwise."""
    return "bits" if bits_rows_fit(relation, nvl, NY, limit) else "sort"


def bits_row_blocks(B: int, R: int, sms: int) -> int:
    """Blocks that share one segment's R rows on the bitmask route, where
    any count fits: as many as B segments' blocks fill two on each of the
    card's ``sms`` multiprocessors in one wave, at most 16 a segment (each
    block walks the whole table). On an H100 (132 SMs, 700 W; VV and VT on
    the 96^3 tables, ``chip_smoke.py`` phase 8e) the fastest of 1, 2, 4, 8
    and 16 shares was 16 at B = 8 and 16, 8 at B = 32 and 4 at B = 64:
    256 blocks or fewer, never a second wave."""
    return max(1, min(16, 2 * sms // max(B, 1), R))


def sub_row_blocks(B: int, R: int, sms: int) -> int:
    """Blocks that share one segment's R subject rows on the sub-join's
    bitmask route, where any count fits: one 1024-thread block for each of
    the card's ``sms`` multiprocessors in one wave, ``sms // B`` a segment
    (each block builds the whole lookup and walks the whole coface table;
    on an H100 at B = 64, 2 blocks a segment beat 1, 3, 4, 6 and 8 for
    FT, EF and ET: ``tools/time_entries.py``)."""
    return max(1, min(sms // max(B, 1), R))


def bits_shares(relation: str, B: int, R: int, fit: int, sms: int,
                shares: Optional[int] = None) -> int:
    """Shares a bitmask launch asks for each segment's R rows: ``shares``
    (at most R) where the caller gives it, else the share rule
    (:func:`bits_row_blocks`, :func:`sub_row_blocks` for EF/ET/FT); in
    either case more where a block holds only ``fit`` rows
    (:func:`bits_rows_fit`, at least 1), so a share never outgrows shared
    memory. The blocks are the same for every share count."""
    if shares is None:
        rule = sub_row_blocks if relation in _SUB_ARITY else bits_row_blocks
        want = rule(B, R, sms)
    else:
        want = min(int(shares), max(R, 1))
    return max(want, -(-R // fit))


def bits_blocks(relation: str, B: int, nvl: int, NX: int, NY: int,
                smem: int, sms: int, shares: Optional[int] = None) -> int:
    """Blocks a segment of a bitmask launch of ``relation`` over B
    segments, as the wrapper sizes its grid: :func:`bits_shares` rounded
    to whole rows a block (``ceil(R / ceil(R / shares))``), on tables of
    ``NX`` subject rows (EF/ET/FT only) and ``NY`` coface rows (ignored
    for VV), ``smem`` bytes of shared memory a block and ``sms``
    multiprocessors; 0 where the segment has no rows or not one mask row
    fits (the sort route serves it)."""
    R = NX if relation in _SUB_ARITY else nvl
    fit = bits_rows_fit(relation, nvl, NY, smem)
    if not fit or R == 0:
        return 0
    rows = -(-R // bits_shares(relation, B, R, fit, sms, shares))
    return -(-R // rows)


def smem_limit(device: torch.device) -> int:
    """Shared memory one block may opt into on ``device``, in bytes."""
    idx = _dev_index(device)
    if idx not in _SMEM_LIMIT:
        lib = _lib()
        out = _I(0)
        _check_rc(lib, lib.sr_smem_optin_limit(idx, ctypes.byref(out)),
                  "cudaDeviceGetAttribute")
        _SMEM_LIMIT[idx] = out.value
    return _SMEM_LIMIT[idx]


def _sm_count(idx: int) -> int:
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _count(*keys: str) -> None:
    with _LAUNCH_LOCK:
        for key in keys:
            LAUNCHES[key] += 1


def _dev_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _check(t: torch.Tensor, name: str, shape: Tuple[int, ...]) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def relation_entries_cuda(relation: str, tabX: torch.Tensor,
                          tabY: torch.Tensor, col_global: torch.Tensor, *,
                          nvl: int, deg: int, route: Optional[str] = None,
                          shares: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(M (B, R, deg), L (B, R))`` int32, where R is ``nvl`` for VV
    (``tabX`` is the ``(B, NT, 4)`` tet table, ``col_global`` the
    ``(B, NV)`` vertex map) and VE/VF/VT (``tabY`` is the ``(B, NY,
    arity)`` table, ``col_global`` its ``(B, NY)`` map); ``NT`` for TT
    (``tabX`` the tet table, ``col_global`` the ``(B, NT)`` tet map); and
    ``NX`` for EF/ET/FT (``tabX`` the ``(B, NX, ax)`` subject table,
    ``tabY`` the ``(B, NY, ay)`` coface table, ``col_global`` its ``(B,
    NY)`` map). The caller guarantees local ids in ``[0, nvl)`` (``-1``
    marks padding) and keys that fit int32 (``ops.sparse_arm_ok``); the
    blocks equal the plain arm's within that precondition. The bitmask
    kernels and the VV and member sort kernels drop an entry with an id
    outside it (as a ``-1`` slot), and never write outside their mask or
    workspace.

    ``route`` picks the VV, member or sub-join kernel: ``None`` takes
    :func:`entry_route`'s choice on this device, ``"bits"`` or ``"sort"``
    forces one (``"bits"`` raises when not one mask row fits); TT takes
    ``None``. The bitmask route launches :func:`bits_blocks` blocks a
    segment: the share rule's, or ``shares`` where given (a parameter
    study's), never fewer than shared memory allows; the sort route and
    TT ignore it."""
    for name, t in (("tabX", tabX), ("tabY", tabY)):
        if isinstance(t, torch.Tensor) and t.dim() != 3:
            raise ValueError(f"{name} must be (B, N, arity), got "
                             f"{tuple(t.shape)}")
    extra = 0
    if relation == "VV":
        arm, tab = "VV", tabX
        B, N, a = tab.shape
        _check(tab, "tabX", (B, N, 4))
        _check(col_global, "col_global", (B, col_global.shape[-1]))
        units, n, R = N, 12 * N, nvl
    elif relation in _MEMBER:
        arm, tab = "member", tabY
        B, N, a = tab.shape
        _check(tab, "tabY", (B, N, a))
        _check(col_global, "col_global", (B, N))
        units, n, R = a * N, a * N, nvl
    elif relation == "TT":
        arm, tab = "TT", tabX
        B, N, a = tab.shape
        _check(tab, "tabX", (B, N, 4))
        _check(col_global, "col_global", (B, N))
        EJ, R = tt_face_lanes(N), N
    elif relation in _SUB_ARITY:
        arm, tab = "sub", tabX
        ax, ay = _SUB_ARITY[relation]
        B, N, _ = tab.shape
        NY = tabY.shape[1]
        _check(tab, "tabX", (B, N, ax))
        _check(tabY, "tabY", (B, NY, ay))
        _check(col_global, "col_global", (B, NY))
        E, R = next_pow2(N + NY * math.comb(ay, ax)), N
        extra = _SUB_STATIC_SMEM
    else:
        raise KeyError(f"no CUDA entry kernel for relation {relation!r}")
    same = (col_global, tabY) if arm == "sub" else (col_global,)
    if any(t.device != tab.device for t in same):
        raise ValueError("the tables and col_global must share one device")
    if shares is not None and int(shares) < 1:
        raise ValueError(f"shares={shares}: a segment takes at least one "
                         f"block")
    if route not in (None, "bits", "sort") or (
            route is not None and arm not in _ROUTED):
        raise ValueError(f"route={route!r} for relation {relation!r}: "
                         f"VV, VE/VF/VT and EF/ET/FT take None, 'bits' or "
                         f"'sort', TT None")
    if arm == "TT":
        per = tt_lane_ints(N, deg)
    elif arm == "sub":
        per = lane_ints(E, R)
    else:
        per = csr_ints(n, nvl)
    if max(nvl, deg) < 1 or R * deg >= 2 ** 31 or per >= 2 ** 31:
        raise ValueError(f"nvl={nvl}, deg={deg}, {per} lane words out of "
                         f"range")
    dev = tab.device
    M = torch.empty((B, R, deg), dtype=torch.int32, device=dev)
    L = torch.empty((B, R), dtype=torch.int32, device=dev)
    if B == 0:
        return M, L
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    idx = _dev_index(dev)
    if arm in _ROUTED:
        fit = bits_rows_fit(relation, nvl, NY if arm == "sub" else N,
                            smem_limit(dev))
        if route == "bits" and not fit:
            raise ValueError(f"{relation} at nvl={nvl}, N={N}: one bitmask "
                             f"row does not fit in shared memory")
        route = route or ("bits" if fit else "sort")
    if route == "bits":
        if R == 0:
            return M, L
        blocks = bits_blocks(relation, B, nvl, N, NY if arm == "sub" else N,
                             smem_limit(dev), _sm_count(idx), shares)
        rows = -(-R // blocks)
        if arm == "VV":
            rc = lib.sr_vv_bits(idx, tab.data_ptr(), col_global.data_ptr(),
                                M.data_ptr(), L.data_ptr(), B, N,
                                col_global.shape[1], nvl, deg, rows, stream)
        elif arm == "member":
            rc = lib.sr_member_bits(idx, tab.data_ptr(),
                                    col_global.data_ptr(), M.data_ptr(),
                                    L.data_ptr(), B, N, a, nvl, deg, rows,
                                    stream)
        else:
            rc = lib.sr_sub_bits(idx, tab.data_ptr(), tabY.data_ptr(),
                                 col_global.data_ptr(), M.data_ptr(),
                                 L.data_ptr(), B, N, ax, NY, ay, nvl, deg,
                                 rows, stream)
        _check_rc(lib, rc, f"{arm} bitmask kernel launch")
        _count(arm, f"{arm}_bits")
        return M, L
    if arm in ("VV", "member"):
        if R == 0:
            return M, L
        work = torch.empty(B * per, dtype=torch.int32, device=dev)
        tile = max(1, -(-units // csr_tiles(B, n, _sm_count(idx))))
        if arm == "VV":
            rc = lib.sr_vv_entries(idx, tab.data_ptr(), col_global.data_ptr(),
                                   M.data_ptr(), L.data_ptr(),
                                   work.data_ptr(), B, N,
                                   col_global.shape[1], nvl, deg, tile,
                                   stream)
        else:
            rc = lib.sr_member_entries(idx, tab.data_ptr(),
                                       col_global.data_ptr(), M.data_ptr(),
                                       L.data_ptr(), work.data_ptr(), B, N,
                                       a, nvl, deg, tile, stream)
        _check_rc(lib, rc, f"{arm} entry kernel launch")
        _count(arm, f"{arm}_sort")
        return M, L
    work = None
    if 4 * per + extra > smem_limit(dev):
        work = torch.empty(B * per, dtype=torch.int32, device=dev)
    wp = work.data_ptr() if work is not None else None
    if arm == "TT":
        rc = lib.sr_tt_entries(idx, tab.data_ptr(), col_global.data_ptr(),
                               M.data_ptr(), L.data_ptr(), wp, B, N, nvl,
                               deg, EJ, stream)
    else:
        rc = lib.sr_sub_entries(idx, tab.data_ptr(), tabY.data_ptr(),
                                col_global.data_ptr(), M.data_ptr(),
                                L.data_ptr(), wp, B, N, ax, NY, ay, nvl,
                                deg, E, stream)
    _check_rc(lib, rc, f"{arm} entry kernel launch")
    _count(arm, *([f"{arm}_sort"] if route else []))
    return M, L


# the grid's y and z extents
_GRID_YZ = 65535
# rows of C per block of the meet count kernel (csrc/counts.cu)
_MEET_TX = 64


def relation_counts_meet_cuda(tabX: torch.Tensor, tabY: torch.Tensor
                              ) -> torch.Tensor:
    """Shared-vertex counts ``C (B, NX, NY)`` int32: ``C[b, x, y]`` is the
    number of valid slots of ``tabX[b, x]`` whose vertex appears among the
    slots of ``tabY[b, y]``; ``-1`` slots never count. Tables are ``(B, N,
    arity)`` int32 with arities 1..4, on one CUDA device."""
    for name, t in (("tabX", tabX), ("tabY", tabY)):
        if not isinstance(t, torch.Tensor) or t.dim() != 3:
            raise ValueError(f"{name} must be a (B, N, arity) tensor")
    B, NX, ax = tabX.shape
    NY, ay = tabY.shape[1], tabY.shape[2]
    _check(tabX, "tabX", (B, NX, ax))
    _check(tabY, "tabY", (B, NY, ay))
    if tabY.device != tabX.device:
        raise ValueError("tabX and tabY must share one device")
    if not (1 <= ax <= 4 and 1 <= ay <= 4):
        raise ValueError(f"arities must be 1..4, got {ax} and {ay}")
    if B > _GRID_YZ or -(-NX // _MEET_TX) > _GRID_YZ:
        raise ValueError(f"B={B}, NX={NX} exceed the kernel's grid")
    dev = tabX.device
    C = torch.empty((B, NX, NY), dtype=torch.int32, device=dev)
    if C.numel() == 0:
        return C
    lib = _counts_lib()
    rc = lib.ct_meet_counts(_dev_index(dev), tabX.data_ptr(),
                            tabY.data_ptr(), C.data_ptr(), B, NX, ax, NY, ay,
                            torch.cuda.current_stream(dev).cuda_stream)
    _check_rc(lib, rc, "meet count kernel launch")
    _count("meet")
    return C


# rows of C a block of the VV count kernel may keep (its ROWS instances)
VV_COUNT_ROWS = (8, 16, 32)


def vv_count_rows(B: int, nvl: int, sms: int) -> int:
    """Rows of C one block of the VV count kernel keeps: the largest tile,
    32 or 16 rows, whose B segments' blocks occupy at least half of the
    card's ``sms`` multiprocessors, else 8. Each block walks its
    segment's whole tet table, so fewer, taller tiles cost less where the
    card is filled anyway: on an H100 (132 SMs, 700 W; 96^3-shaped tables,
    NV 256, NT 896, ``tools/time_entries.py --counts``) 16 rows (128
    blocks) beat 32 and 8 at the fused extrema loop's B = 8, and 32 rows
    beat 16 and 8 at B = 64."""
    for rows in (32, 16):
        if 2 * B * -(-nvl // rows) >= sms:
            return rows
    return 8


def relation_counts_vv_cuda(T_local: torch.Tensor, nvl: int,
                            rows: Optional[int] = None) -> torch.Tensor:
    """Shared-tet counts ``C (B, nvl, nvl)`` int32: ``C[b, i, j]`` is the
    number of tets of ``T_local[b]`` (``(B, NT, 4)`` int32, ``-1`` padded)
    that contain both local vertices ``i`` and ``j``, diagonal included.
    Vertex ids outside ``[0, nvl)`` count nowhere. A block keeps ``rows``
    rows of C (one of ``VV_COUNT_ROWS``; by default
    :func:`vv_count_rows`'s); C is the same for each."""
    if not isinstance(T_local, torch.Tensor) or T_local.dim() != 3:
        raise ValueError("T_local must be a (B, NT, 4) tensor")
    B, NT, _ = T_local.shape
    _check(T_local, "T_local", (B, NT, 4))
    if T_local.data_ptr() % 16:
        raise ValueError("T_local must be 16-byte aligned (int4 rows)")
    nvl = int(nvl)
    if nvl < 0 or B > _GRID_YZ:
        raise ValueError(f"nvl={nvl}, B={B} out of range")
    if rows is not None and rows not in VV_COUNT_ROWS:
        raise ValueError(f"rows={rows}: one of {VV_COUNT_ROWS}")
    dev = T_local.device
    C = torch.empty((B, nvl, nvl), dtype=torch.int32, device=dev)
    if C.numel() == 0:
        return C
    lib = _counts_lib()
    idx = _dev_index(dev)
    rows = rows or vv_count_rows(B, nvl, _sm_count(idx))
    rc = lib.ct_vv_counts(idx, T_local.data_ptr(), C.data_ptr(), B, NT, nvl,
                          rows, torch.cuda.current_stream(dev).cuda_stream)
    _check_rc(lib, rc, "VV count kernel launch")
    _count("vv_counts")
    return C
