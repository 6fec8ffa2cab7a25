"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the reference's: its plain version ``flash_attention_ref`` against
the reference's Pallas kernel in interpret mode at the shapes and block
sizes of ``tests/test_flash_attention.py``; ragged ``S``/``T`` and ``S !=
T`` (which the reference's kernel does not take) against the reference's
``_sdpa`` with a top-left ``tril`` mask; the GQA head mapping; and the
backend fork. Tolerances are those of the reference's own kernel test:
float32 ``2e-5``, bf16 ``2e-2`` (the kernel scales q before the product,
``_sdpa`` divides the scores after it, so they agree to rounding only).
The wrapper's routing between its two kernels (``_variant``,
``wgmma_problems``: dtype, head dim and what TMA needs of the layout) and a
plain model of the wgmma kernel's roundings run here too; the CUDA kernels
themselves run on a card (``tests/test_torch_cuda.py``).
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
@pytest.mark.parametrize("hd", [32, 64, 80, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_variant_by_dtype_head_dim_and_alignment(dtype, hd, kind):
    q = _layout(kind, dtype, 4, hd)
    k = v = torch.zeros((2, 50, 2, hd), dtype=dtype)
    wgmma = dtype == torch.bfloat16 and hd in (64, 128, 256) and \
        kind in ("contiguous", "strided")
    assert fa._variant(q, k, v) == ("wgmma" if wgmma else "simt")
    assert (fa.wgmma_problems(q, k, v) == []) == wgmma
    assert fa._variant(k.expand(2, 50, 2, hd), q[:, :50, :2], v) == \
        fa._variant(q[:, :50, :2], k, v)


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
