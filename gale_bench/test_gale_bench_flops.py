"""The FLOP counts behind the ``mfu`` metrics, against hand counts at SMOKE
widths, and the frozen roofline arithmetic."""

import sys
import types

import pytest

from gale_bench.metrics import flops, peaks

DENSE = types.SimpleNamespace(reference="dense_block", n_layers=2, d_model=128,
                              n_heads=4, n_kv_heads=4, hd=32, d_ff=256,
                              vocab=512, n_experts=0, top_k=0)
MOE = types.SimpleNamespace(reference="granite_moe_block", n_layers=2, d_model=64, n_heads=4,
                            n_kv_heads=2, hd=16, d_ff=32, vocab=512,
                            n_experts=8, top_k=2)


def test_dense_hand_count():
    # a token through a layer: qkv 2*128*12*32 + out 2*128*128 + GLU
    # 3*2*128*256 = 327,680; B 2 S 8: 36 causal pairs a row, 4*2*4*32*36
    # = 36,864 a layer; head 2*128*512 a row it is applied to
    layers = 2 * (16 * 327680 + 36864)
    assert flops.train_step_flops(DENSE, 2, 8) == 3 * (layers + 2097152 * 1)
    assert flops.prefill_flops(DENSE, 2, 8) == layers + 2 * 128 * 512 * 2


def test_moe_hand_count():
    # qkv 2*64*8*16 + out 2*64*64 + router 2*64*8 + 2 experts x 3*2*64*32
    per_token = 16384 + 8192 + 1024 + 24576
    layers = 2 * (4 * per_token + 4 * 1 * 4 * 16 * 10)
    assert flops.prefill_flops(MOE, 1, 4) == layers + 2 * 64 * 512


def test_not_six_n_d():
    """The head counts once a row in prefill: far below 2 N D with the
    embedding and head in N."""
    n = 2 * 327680 // 2 + 2 * 512 * 128
    assert flops.prefill_flops(DENSE, 1, 64) < 2 * n * 64


def test_flash_bound():
    moved, fl, rate = peaks.flash_work(4, 4096, 4096, 32, 32, 128, True,
                                       "bfloat16")
    assert fl == 4 * 4 * 32 * 128 * (4096 * 4097 // 2)
    assert moved == 4 * 4 * 4096 * 32 * 128 * 2
    b = peaks.flash_bound_s(4, 4096, 4096, 32, 32, 128, True, "bfloat16")
    assert b == pytest.approx(fl / 989e12)
    assert peaks.idle_share(0.25, 1.0) == 0.75


def test_a_family_counts_its_own_layers(monkeypatch):
    """A block that replaces the attention layer counts the layer itself;
    the harness adds the head and the training step's backward."""
    block = types.ModuleType("gale_bench.reference.counted_block")
    block.layer_flops = lambda cfg, i, B, S: 1000.0 * (i + 1) * B * S
    monkeypatch.setitem(sys.modules, block.__name__, block)
    cfg = types.SimpleNamespace(reference="counted_block", n_layers=3,
                                d_model=8, vocab=10)
    assert flops.prefill_flops(cfg, 2, 4) == 6000.0 * 8 + 2 * 8 * 10 * 2
    assert flops.train_step_flops(cfg, 1, 4) == 3 * (6000.0 * 4
                                                     + 2 * 8 * 10 * 4)
