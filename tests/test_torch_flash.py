"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the reference's: its plain version ``flash_attention_ref`` against
the reference's Pallas kernel in interpret mode at the shapes and block
sizes of ``tests/test_flash_attention.py``; ragged ``S``/``T`` and ``S !=
T`` (which the reference's kernel does not take) against the reference's
``_sdpa`` with a top-left ``tril`` mask; the GQA head mapping; and the
backend fork. Tolerances are those of the reference's own kernel test:
float32 ``2e-5``, bf16 ``2e-2`` (the kernel scales q before the product,
``_sdpa`` divides the scores after it, so they agree to rounding only).
The wrapper's routing between its three kernels (``_variant``,
``wgmma_problems``: dtype, head dim and what TMA needs of the layout;
``vec_loads``), plain models of the wgmma kernel's and the mma kernel's
roundings (3xTF32 for float32), and an emulation of the mma kernel's
fragment layouts run here too; the CUDA kernels themselves run on a card
(``tests/test_torch_cuda.py``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as rfa
from repro.models.layers import _sdpa, repeat_kv
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, B, S, T, H, KV, hd, dtype):
    """q, k, v as (jax, torch) pairs holding the same values."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd)):
        a = rng.normal(0, 1, shape).astype(np.float32)
        j = jnp.asarray(a, _JNP[dtype])
        out.append((j, torch.from_numpy(np.array(j.astype(jnp.float32)))
                    .to(_TORCH[dtype])))
    return out


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def _sdpa_oracle(q, k, v, causal):
    S, H, T = q.shape[1], q.shape[2], k.shape[1]
    if causal:
        mask = jnp.tril(jnp.ones((S, T), bool))[None, None]
    else:
        mask = jnp.ones((1, 1, S, T), bool)
    return _sdpa(q, repeat_kv(k, H), repeat_kv(v, H), mask, q.dtype)


# the reference kernel test's shapes (q_blk = k_blk = 64)
@pytest.mark.parametrize("B,S,T,H,KV,hd,causal,dtype", [
    (2, 128, 128, 4, 4, 64, True, "float32"),
    (1, 256, 256, 4, 2, 64, True, "float32"),
    (2, 128, 128, 8, 1, 128, True, "bfloat16"),
    (1, 128, 256, 4, 4, 64, False, "float32"),
    (1, 128, 128, 2, 2, 256, True, "float32"),
])
def test_plain_matches_reference_kernel(B, S, T, H, KV, hd, causal, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(S + H, B, S, T, H, KV, hd, dtype)
    want = rfa.flash_attention(qj, kj, vj, causal=causal, interpret=True,
                               q_blk=64, k_blk=64)
    got = fa.flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == (B, S, H, hd)
    _close(got, want, dtype)


@pytest.mark.parametrize("q_blk,k_blk", [(32, 128), (128, 32), (64, 64)])
def test_plain_matches_reference_block_sweep(q_blk, k_blk):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(0, 1, 128, 128, 2, 2, 64,
                                           "float32")
    want = rfa.flash_attention(qj, kj, vj, causal=True, interpret=True,
                               q_blk=q_blk, k_blk=k_blk)
    _close(fa.flash_attention(qt, kt, vt, causal=True), want, "float32")


def test_bh_layout_matches_reference():
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(0, 1, (6, 128, 64)).astype(np.float32)
               for _ in range(3))
    want = rfa.flash_attention_bh(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, q_blk=64,
                                  k_blk=64, interpret=True)
    got = fa.flash_attention_bh(*(torch.from_numpy(a) for a in (q, k, v)),
                                causal=True)
    _close(got, want, "float32")


# ragged tiles and S != T in both directions: the port's kernel masks
# them itself; the reference's asserts divisibility, so its _sdpa with the
# same top-left tril mask is the oracle
@pytest.mark.parametrize("S,T", [(100, 150), (150, 100), (1, 37), (77, 77),
                                 (1000, 1500)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_ragged_matches_sdpa(S, T, causal):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(S * 7 + T, 1, S, T, 4, 2, 32,
                                           "float32")
    want = _sdpa_oracle(qj, kj, vj, causal)
    _close(fa.flash_attention(qt, kt, vt, causal=causal), want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_bf16_and_f32_ragged_gqa(dtype):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(11, 2, 70, 130, 8, 2, 80, dtype)
    want = _sdpa_oracle(qj, kj, vj, True)
    got = fa.flash_attention(qt, kt, vt, causal=True)
    assert got.dtype == _TORCH[dtype]
    _close(got, want, dtype)


@pytest.mark.parametrize("H,KV", [(28, 4), (8, 1), (4, 4)])
def test_gqa_head_mapping_is_repeat_interleave(H, KV):
    """Query head h reads KV head h // (H // KV): the same as repeating
    every KV head H // KV times in place (jnp.repeat), not tiling them."""
    rng = np.random.default_rng(H)
    q = torch.from_numpy(rng.normal(0, 1, (1, 9, H, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(0, 1, (1, 12, KV, 16))
                             .astype(np.float32)) for _ in range(2))
    got = fa.flash_attention(q, k, v, causal=True)
    kr = torch.from_numpy(np.repeat(k.numpy(), H // KV, axis=2))
    vr = torch.from_numpy(np.repeat(v.numpy(), H // KV, axis=2))
    torch.testing.assert_close(got, fa.flash_attention(q, kr, vr,
                                                       causal=True))
    torch.testing.assert_close(layers.repeat_kv(k, H), kr)
    if 1 < KV < H:   # tiling (Tensor.repeat) would pair other heads
        kt = k.repeat(1, 1, H // KV, 1)
        assert not torch.allclose(
            got, fa.flash_attention(q, kt, v.repeat(1, 1, H // KV, 1),
                                    causal=True))


def test_backend_fork_on_cpu():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (1, 8, 2, 16))
                                .astype(np.float32)) for _ in range(3))
    before = fa.LAUNCHES["flash"]
    fa.flash_attention(q, k, v)                 # None -> plain on the CPU
    fa.flash_attention(q, k, v, backend="torch")
    assert fa.LAUNCHES["flash"] == before
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention(q, k, v, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="must divide"):
        fa.flash_attention(q, k[:, :, :1].expand(1, 8, 3, 16).contiguous(),
                           v[:, :, :1].expand(1, 8, 3, 16).contiguous())


# -- routing between the two kernels ------------------------------------------

def _layout(kind, dtype, H, hd):
    """q-shaped (2, 70, H, hd) CPU tensors: contiguous; the heads of a
    wider buffer (aligned strides); a sequence stride 2 elements past a
    multiple of 16 bytes; a base address one element off."""
    if kind == "contiguous":
        return torch.zeros((2, 70, H, hd), dtype=dtype)
    if kind == "strided":
        return torch.zeros((2, 70, H + 2, hd), dtype=dtype)[:, :, 1:H + 1]
    if kind == "stride":
        return torch.zeros((2, 70, H * hd + 2), dtype=dtype)[
            ..., :H * hd].unflatten(-1, (H, hd))
    flat = torch.zeros(2 * 70 * H * hd + 1, dtype=dtype)
    return flat[1:].view(2, 70, H, hd)


@pytest.mark.parametrize("kind", ["contiguous", "strided", "stride", "base"])
@pytest.mark.parametrize("hd", [16, 28, 32, 64, 80, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_variant_by_dtype_head_dim_and_alignment(dtype, hd, kind):
    """Two routes: wgmma for bf16 at hd 64/128/256 on a layout TMA
    reads; mma for every float32 input and every other bf16 one (the SIMT
    kernel is on neither: ``flash_attention_cuda(..., simt=True)`` alone
    launches it, held on the card in ``tests/test_torch_cuda.py``)."""
    q = _layout(kind, dtype, 4, hd)
    k = v = torch.zeros((2, 50, 2, hd), dtype=dtype)
    wgmma = dtype == torch.bfloat16 and hd in (64, 128, 256) and \
        kind in ("contiguous", "strided")
    assert fa._variant(q, k, v) == ("wgmma" if wgmma else "mma")
    assert (fa.wgmma_problems(q, k, v) == []) == wgmma
    assert fa._variant(k.expand(2, 50, 2, hd), q[:, :50, :2], v) == \
        fa._variant(q[:, :50, :2], k, v)


@pytest.mark.parametrize("kind", ["contiguous", "strided", "stride", "base"])
@pytest.mark.parametrize("hd", [16, 28, 30, 64, 80, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vec_loads_need_16_byte_bases_strides_and_rows(dtype, hd, kind):
    """The mma kernel reads K and V 16 bytes a thread only when both bases,
    their batch, sequence and head strides and hd's bytes are multiples of
    16; a head stride of hd + 1 elements takes the element loads."""
    k = _layout(kind, dtype, 2, hd)
    v = torch.zeros((2, 70, 2, hd), dtype=dtype)
    esz = k.element_size()
    want = (hd * esz) % 16 == 0 and kind in ("contiguous", "strided")
    assert fa.vec_loads(k, v) == want
    assert fa.vec_loads(v, k) == want
    fused = torch.zeros((2, 70, 4, hd + 1), dtype=dtype)[..., :hd]
    assert not fa.vec_loads(fused[:, :, :2], fused[:, :, 2:])
    # a dimension of size 1 is never stepped: its stride is not checked
    one = torch.zeros(2 * 64, dtype=torch.float32).as_strided(
        (1, 1, 2, 64), (3, 5, 64, 1))
    assert fa.vec_loads(one, one)


def test_wgmma_problems_name_what_tma_cannot_take():
    bf = torch.bfloat16
    k = torch.zeros((2, 50, 2, 128), dtype=bf)
    assert fa.wgmma_problems(torch.zeros((2, 70, 4, 128), dtype=bf), k,
                             k) == []
    assert fa.wgmma_problems(k.float(), k.float(), k.float()) == [
        "dtype torch.float32 is not bf16"]
    k80 = torch.zeros((2, 50, 2, 80), dtype=bf)
    assert fa.wgmma_problems(k80, k80, k80) == [
        "head dim 80 is not one of (64, 128, 256)"]
    base = _layout("base", bf, 4, 128)
    assert fa.wgmma_problems(base, k, k) == [
        "q's base address is not 16-byte aligned"]
    odd = _layout("stride", bf, 4, 128)
    assert fa.wgmma_problems(k, odd[:, :50, :2], k) == [
        "k's batch stride of 71960 bytes is not a positive multiple of 16 "
        "below 2**40",
        "k's sequence stride of 1028 bytes is not a positive multiple of 16 "
        "below 2**40"]
    # a dimension of size 1 is never stepped: its stride is not checked,
    # and the tensor map gets a contiguous tensor's instead
    one = torch.zeros(4 * 128, dtype=bf).as_strided((1, 1, 4, 128),
                                                    (3, 5, 128, 1))
    assert fa.wgmma_problems(one, k[:1], k[:1]) == []
    assert fa._tma_strides(one) == (512, 512, 128)
    assert fa._tma_strides(odd) == (70 * 514, 514, 128)
    # an expanded (stride 0) dimension, and the grid's limits
    k64 = torch.zeros((1, 1, 1, 64), dtype=bf)
    wide = k64.expand(70000, 1, 1, 64)
    assert fa.wgmma_problems(wide, k64, k64) == [
        "q's batch stride of 0 bytes is not a positive multiple of 16 below "
        "2**40", "B=70000, S=1 exceed the wgmma kernel's grid"]
    long = k64.expand(1, 128 * 65535 + 1, 1, 64)
    assert fa.wgmma_problems(long, k64, k64) == [
        "q's sequence stride of 0 bytes is not a positive multiple of 16 "
        "below 2**40", f"B=1, S={128 * 65535 + 1} exceed the wgmma "
        "kernel's grid"]


# -- a plain model of the wgmma kernel's roundings ----------------------------

def _wgmma_model(q, k, v, causal, bk):
    """The wgmma kernel's arithmetic in float32 torch ops: bf16 inputs;
    scores as float32 sums of the bf16 products, scaled by 1/sqrt(hd) after
    the product in log2 units; an online softmax over key tiles of ``bk``
    with float32 running max, sum and accumulator; the unnormalised
    probabilities rounded to bf16 for the PV product while the sum adds
    them in float32; ``acc / max(l, 1e-30)`` rounded to bf16."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    rep = H // KV
    sl2 = math.log2(math.e) / math.sqrt(hd)
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    m = torch.full((B, H, S, 1), -math.inf)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, hd))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, T, bk):
        s = qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2)
        if causal:
            keys = torch.arange(k0, min(k0 + bk, T))[None, :]
            s = s.masked_fill(keys > rows, -math.inf)
        mn = torch.maximum(m, s.amax(-1, keepdim=True) * sl2)
        base = torch.where(mn == -math.inf, torch.zeros(()), mn)
        alpha = torch.exp2(m - base)
        p = torch.exp2(s * sl2 - base)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ \
            vf[:, :, k0:k0 + bk]
        m = mn
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).to(torch.bfloat16)


# qwen2-7b (28/4, hd 128), whisper-base (8/8, hd 64, cross attention over
# its 1500 frames), gemma-7b (16/16, hd 256, 64-key tiles), GQA 8/1;
# ragged tiles and S != T
@pytest.mark.parametrize("B,S,T,H,KV,hd,causal", [
    (1, 300, 300, 28, 4, 128, True),
    (1, 200, 333, 28, 4, 128, False),
    (1, 333, 200, 28, 4, 128, True),
    (2, 1, 37, 28, 4, 128, True),
    (2, 130, 130, 8, 1, 64, True),
    (1, 64, 1500, 8, 8, 64, False),
    (1, 100, 100, 16, 16, 256, True),
])
def test_wgmma_rounding_model_matches_plain(B, S, T, H, KV, hd, causal):
    """The kernel's numeric design (scale after the product, P in bf16)
    stays within the bf16 tolerance of the plain version and of the
    reference's ``_sdpa`` at the served models' head layouts."""
    (qj, qt), (kj, kt), (vj, vt) = _inputs(S + T + hd, B, S, T, H, KV, hd,
                                           "bfloat16")
    got = _wgmma_model(qt, kt, vt, causal, 128 if hd <= 128 else 64)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, hd)
    want = fa.flash_attention_ref(qt, kt, vt, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    _close(got, _sdpa_oracle(qj, kj, vj, causal), "bfloat16")


# -- the mma kernel (csrc/flash_attention_mma.cu): a plain model of its ------
# -- 3xTF32 roundings, and an emulation of its fragment layouts ---------------

def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero on the bit pattern, as ``cvt.rna.tf32.f32`` does."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    """x = hi + lo, both TF32: ``hi = rna(x)``, ``lo = rna(x - hi)``."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _tf32_matmul(a, b, products):
    """a @ b as the kernel's TF32 mma.sync products: 3xTF32 (hi.hi + hi.lo
    + lo.hi, lo.lo dropped) or one TF32 product (hi.hi)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    if products == 1:
        return ah @ bh
    return ah @ bh + (ah @ bl + al @ bh)


def _mma_model(q, k, v, causal, bk=None, products=3):
    """The float32 mma kernel's arithmetic in float32 torch ops: q scaled by
    1/sqrt(hd) on load; S = Q K^T and O += P V as TF32 products
    (:func:`_tf32_matmul`); an online softmax over key tiles of ``bk``
    (by default the kernel's own: 32 keys up to hd 128, 16 past it) with
    float32 running max, sum and accumulator, exp of the scores as in the
    SIMT kernel; ``acc / max(l, 1e-30)``."""
    B, S, H, hd = q.shape
    if bk is None:
        bk = 32 if hd <= 128 else 16
    T, KV = k.shape[1], k.shape[2]
    rep = H // KV
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    qf = (q.float() * scale).transpose(1, 2)
    kf = k.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    m = torch.full((B, H, S, 1), -math.inf)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, hd))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, T, bk):
        s = _tf32_matmul(qf, kf[:, :, k0:k0 + bk].transpose(-1, -2),
                         products)
        if causal:
            keys = torch.arange(k0, min(k0 + bk, T))[None, :]
            s = s.masked_fill(keys > rows, -math.inf)
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        base = torch.where(mn == -math.inf, torch.zeros(()), mn)
        alpha = torch.exp(m - base)
        p = torch.exp(s - base)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _tf32_matmul(p, vf[:, :, k0:k0 + bk], products)
        m = mn
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).to(q.dtype)


def test_tf32_rounding_is_rna_on_the_bit_pattern():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -(1.0 + 2 ** -11), 3.0 * 2 ** -12, 0.0, -2.5],
                     dtype=torch.float32)
    want = [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9,
            -(1.0 + 2 ** -10), 3.0 * 2 ** -12, 0.0, -2.5]
    assert _tf32(x).tolist() == want        # ties go away from zero
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.normal(0, 3, 4096).astype(np.float32))
    hi, lo = _split(y)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((hi + lo - y).abs() / y.abs()).max()) < 2 ** -21
    assert float(((hi - y).abs() / y.abs()).max()) <= 2 ** -11


# the reference's kernel in interpret mode (q_blk = k_blk = 64, S and T
# multiples of 64): hd 28, 64, 80 and 128, GQA 28/4, causal and unmasked
@pytest.mark.parametrize("B,S,T,H,KV,hd,causal", [
    (1, 128, 128, 4, 2, 28, True),
    (1, 128, 128, 4, 4, 64, False),
    (2, 128, 128, 4, 2, 80, True),
    (1, 128, 128, 28, 4, 128, True),
    (1, 128, 256, 4, 4, 128, False),
])
def test_mma_rounding_model_matches_reference_kernel(B, S, T, H, KV, hd,
                                                     causal):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(S + H + hd, B, S, T, H, KV, hd,
                                           "float32")
    want = rfa.flash_attention(qj, kj, vj, causal=causal, interpret=True,
                               q_blk=64, k_blk=64)
    got = _mma_model(qt, kt, vt, causal)
    assert got.dtype == torch.float32 and got.shape == (B, S, H, hd)
    _close(got, want, "float32")


# ragged tiles, S < T and S > T, at GQA 28/4, against the reference's _sdpa,
# over the kernel's own key tiles (hd 256: 16 keys)
@pytest.mark.parametrize("S,T", [(100, 150), (150, 100)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [28, 64, 80, 128, 256])
def test_mma_rounding_model_matches_sdpa(hd, causal, S, T):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(S * 3 + T + hd, 1, S, T, 28, 4,
                                           hd, "float32")
    want = _sdpa_oracle(qj, kj, vj, causal)
    _close(_mma_model(qt, kt, vt, causal), want, "float32")
    # the other tilings: 64 keys, and hd 256's 16 keys at hd 128
    if hd == 128:
        for bk in (16, 64):
            _close(_mma_model(qt, kt, vt, causal, bk=bk), want, "float32")


def test_one_tf32_product_misses_the_float32_tolerance():
    """Why the kernel takes three products: on the same seeded inputs at
    hd 128, one TF32 product (10 mantissa bits) is far outside float32's
    2e-5, and 3xTF32 well inside it."""
    (qj, qt), (kj, kt), (vj, vt) = _inputs(7, 1, 128, 128, 28, 4, 128,
                                           "float32")
    want = np.asarray(_sdpa_oracle(qj, kj, vj, True), np.float32)
    one = _mma_model(qt, kt, vt, True, products=1).numpy()
    three = _mma_model(qt, kt, vt, True).numpy()
    err_one = float(np.abs(one - want).max())
    err_three = float(np.abs(three - want).max())
    assert not np.allclose(one, want, rtol=2e-5, atol=2e-5)
    assert err_one > 20 * 2e-5
    assert err_three < 2e-5 / 4
    np.testing.assert_allclose(three, want, rtol=2e-5, atol=2e-5)


# the bf16 instantiation of the mma kernel computes as the wgmma kernel
# does (bf16 products, scale after the product in log2 units, P rounded to
# bf16), over 64-key tiles (32 past hd 128): the head dims wgmma rejects
@pytest.mark.parametrize("B,S,T,H,KV,hd,causal", [
    (1, 150, 100, 4, 4, 80, True),
    (1, 100, 150, 8, 2, 28, False),
    (2, 130, 130, 4, 2, 16, True),
    (1, 70, 130, 4, 4, 200, True),
])
def test_bf16_mma_rounding_model_matches_plain(B, S, T, H, KV, hd, causal):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(S + T + hd, B, S, T, H, KV, hd,
                                           "bfloat16")
    got = _wgmma_model(qt, kt, vt, causal, 64 if hd <= 128 else 32)
    want = fa.flash_attention_ref(qt, kt, vt, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    _close(got, _sdpa_oracle(qj, kj, vj, causal), "bfloat16")


def _mma_emulate(a, b, c, k16):
    """D = A B + C of one warp's ``mma.sync`` from its lanes' fragments, by
    the PTX ISA's layouts (g = lane / 4, t = lane % 4): m16n8k8 TF32 (a
    ``(32, 4)``: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); b ``(32,
    2)``: (t, g), (t + 4, g)) or m16n8k16 bf16 (each register a pair of
    columns: a (g, 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..);
    b (2t.., g), (2t + 8.., g)); c and d ``(32, 4)``: (g, 2t), (g, 2t + 1),
    (g + 8, 2t), (g + 8, 2t + 1)."""
    K = 16 if k16 else 8
    A, B, C = np.zeros((16, K)), np.zeros((K, 8)), np.zeros((16, 8))
    for lane in range(32):
        g, t = divmod(lane, 4)
        C[g, 2 * t:2 * t + 2], C[g + 8, 2 * t:2 * t + 2] = \
            c[lane, :2], c[lane, 2:]
        if k16:
            for r, (row, col) in enumerate(((g, 2 * t), (g + 8, 2 * t),
                                            (g, 2 * t + 8),
                                            (g + 8, 2 * t + 8))):
                A[row, col:col + 2] = a[lane, r]
            B[2 * t:2 * t + 2, g] = b[lane, 0]
            B[2 * t + 8:2 * t + 10, g] = b[lane, 1]
        else:
            A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a[lane]
            B[t, g], B[t + 4, g] = b[lane]
    D = A @ B + C
    return np.array([[D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t],
                      D[g + 8, 2 * t + 1]]
                     for g, t in (divmod(lane, 4) for lane in range(32))])


def _acc_fragment(P):
    """An m16n8 accumulator's lanes holding the 16 x 8 matrix P."""
    return np.array([[P[g, 2 * t], P[g, 2 * t + 1], P[g + 8, 2 * t],
                      P[g + 8, 2 * t + 1]]
                     for g, t in (divmod(lane, 4) for lane in range(32))])


def _q_slot(r, d, nkq, k16):
    """The kernel's shared-memory word (float32; bf16: half-word) of Q's
    element (r, d) in its warp's A fragments, as flash_fwd_mma stores it."""
    rw, rg, up = r >> 4, r & 7, (r >> 3) & 1
    if not k16:
        kk, c = divmod(d, 8)
        return ((rw * nkq + kk) * 32 + rg * 4 + (c & 3)) * 4 + up + \
            2 * (c >> 2)
    kk, c = divmod(d, 16)
    slot = ((rw * nkq + kk) * 32 + rg * 4 + ((c & 7) >> 1)) * 4 + up + \
        2 * (c >> 3)
    return 2 * slot + (c & 1)


@pytest.mark.parametrize("k16", [False, True])
def test_mma_fragments_give_the_products(k16):
    """The mma kernel's index arithmetic on an emulated warp: Q's
    fragment-order slots are a bijection whose 16 bytes per lane are the A
    fragment of every hd step; S = Q K^T from K's rows; and O += P V with P
    taken from the S accumulator as it stands: float32 relabels columns
    (2t, 2t + 1) as (t, t + 4) and reads V's rows 2t and 2t + 1, bf16 pairs
    two n-tiles and reads V transposed (ldmatrix.trans)."""
    rng = np.random.default_rng(3)
    ks, hdp = (16, 32) if k16 else (8, 24)
    nkq = hdp // ks
    Q = rng.normal(0, 1, (64, hdp))
    words = np.full(64 * hdp, np.nan)
    for r in range(64):
        for d in range(hdp):
            words[_q_slot(r, d, nkq, k16)] = Q[r, d]
    assert not np.isnan(words).any()
    if k16:
        words = words.reshape(-1, 2)            # two bf16 to a word
    regs = words.reshape(4, nkq, 32, 4, *words.shape[1:])  # warp, kk, lane
    Kt = rng.normal(0, 1, (8, hdp))             # 8 keys
    for w in range(4):
        acc = np.zeros((32, 4))
        for kk in range(nkq):
            if k16:
                b = np.array([[Kt[g, kk * 16 + 2 * t:kk * 16 + 2 * t + 2],
                               Kt[g, kk * 16 + 2 * t + 8:kk * 16 + 2 * t
                                  + 10]]
                              for g, t in (divmod(x, 4) for x in range(32))])
            else:
                b = np.array([[Kt[g, kk * 8 + t], Kt[g, kk * 8 + t + 4]]
                              for g, t in (divmod(x, 4) for x in range(32))])
            acc = _mma_emulate(regs[w, kk], b, acc, k16)
        np.testing.assert_allclose(
            acc, _acc_fragment(Q[16 * w:16 * w + 16] @ Kt.T), atol=1e-12)

    V = rng.normal(0, 1, (ks, 8))               # one key step x 8 columns
    lanes = [divmod(x, 4) for x in range(32)]
    if k16:
        P = rng.uniform(0, 1, (16, 16))
        s0, s1 = _acc_fragment(P[:, :8]), _acc_fragment(P[:, 8:])
        a = np.stack([s0[:, :2], s0[:, 2:], s1[:, :2], s1[:, 2:]], axis=1)
        b = np.array([[V[2 * t:2 * t + 2, g], V[2 * t + 8:2 * t + 10, g]]
                      for g, t in lanes])
    else:
        P = rng.uniform(0, 1, (16, 8))
        s = _acc_fragment(P)
        a = s[:, [0, 2, 1, 3]]                  # (2t, 2t+1) -> (t, t+4)
        b = np.array([[V[2 * t, g], V[2 * t + 1, g]] for g, t in lanes])
        # without the relabelling the rows of V would have to be t, t + 4
        naive = np.array([[V[t, g], V[t + 4, g]] for g, t in lanes])
        assert not np.allclose(_mma_emulate(a, naive, np.zeros((32, 4)),
                                            False), _acc_fragment(P @ V))
    np.testing.assert_allclose(_mma_emulate(a, b, np.zeros((32, 4)), k16),
                               _acc_fragment(P @ V), atol=1e-12)
