"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the reference's: its plain version ``flash_attention_ref`` against
the reference's Pallas kernel in interpret mode at the shapes and block
sizes of ``tests/test_flash_attention.py``; ragged ``S``/``T`` and ``S !=
T`` (which the reference's kernel does not take) against the reference's
``_sdpa`` with a top-left ``tril`` mask; the GQA head mapping; and the
backend fork. Tolerances are those of the reference's own kernel test:
float32 ``2e-5``, bf16 ``2e-2`` (the kernel scales q before the product,
``_sdpa`` divides the scores after it, so they agree to rounding only).
The CUDA kernel itself runs on a card (``tests/test_torch_cuda.py``).
"""

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
