"""The bf16 pin rule (``chip_smoke.check_lm_pins_bf16``) on the CPU: at the
``SMOKE`` configuration of every arch, the port's torch arm in bf16 meets
the JAX reference's bf16 pins, computed here by ``tools/lm_pins.py``'s own
functions from float32 and bf16 runs of the reference on the same tree
(``chip_smoke.reference_tree``) and inputs; two broken ports fail the rule
at the committed ``BF16_PIN_FACTOR``; and the committed pins hold a
float32 and a bf16 pin for every name of ``LM_PIN_ARCH``.

Every case runs at one prefill shape (B 2, S 64; whisper's 40 frames), so
the reference's compiles are one per arch and dtype, at XLA's optimization
level 0 (``lm_pins.JIT_OPTIONS``), which compiles ~2.4x faster.
"""

import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT, ROOT / "tools"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import chip_smoke as cs  # noqa: E402
import lm_pins as tool  # noqa: E402
from repro import configs as rconfigs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import layers, lm, moe  # noqa: E402

CPU = torch.device("cpu")
SHAPE = (2, 64, 3)          # B, S, input seed
FRAMES = 40
_REF = {}
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True)
def _fast_compiles(monkeypatch):
    monkeypatch.setattr(tool, "JIT_OPTIONS", FAST)


def _cfg(pkg, arch, dtype):
    return dataclasses.replace(pkg.get_smoke_config(arch), dtype=dtype)


def _reference(arch):
    """(numpy tree, numpy inputs, pins): the reference's float32 pin
    ``"p"`` and bf16 pin ``"p_bf16"`` of one prefill of the arch's SMOKE
    config, by the tool's ``prefill_pin`` and ``bf16_prefill_pin``."""
    if arch not in _REF:
        c32, c16 = (_cfg(rconfigs, arch, d) for d in ("float32", "bfloat16"))
        tree = cs.reference_tree(c32, 0)
        params = tool.to_jax(tree)
        inputs = cs.lm_pin_inputs(c32, "smoke", SHAPE, FRAMES)
        batch = {k: jnp.asarray(v) for k, v in inputs.items()}
        f32 = tool.prefill_pin(params, c32, batch)
        pins = {"p": f32[0], "p_bf16": tool.bf16_prefill_pin(
            f32, tool.prefill_pin(params, c16, batch), c16)}
        _REF[arch] = (tree, inputs, pins)
    return _REF[arch]


def _port(arch, tree, inputs, pins):
    """The port's torch arm in bf16 on the same tree and inputs, in the
    layout ``bf16_pin_faults`` reads (a moe model's first-layer routing
    counts too)."""
    cfg = _cfg(configs, arch, "bfloat16")
    model = lm.params_from_reference(tree, cfg, CPU)
    batch = {k: torch.from_numpy(v) for k, v in inputs.items()}
    routed = []
    route = moe.route

    def recording(p, x, c):
        gates, eidx = route(p, x, c)
        routed.append(eidx)
        return gates, eidx
    moe.route = recording
    try:
        logits, _ = lm.prefill_fn(model, batch, cfg, "torch")
    finally:
        moe.route = route
    nxt = steps.make_prefill_step(cfg, "torch")(model, batch)
    got = cs.prefill_result(torch, logits[:, -1], nxt, "p", pins)
    if cfg.family == "moe":
        got["counts"] = cs.routing_counts(routed[0].numpy(), cfg)["counts"]
    return got


@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_the_bf16_port_meets_the_reference_bf16_pins(arch):
    tree, inputs, pins = _reference(arch)
    assert pins["p_bf16"]["ref_err"] > 0
    got = _port(arch, tree, inputs, pins)
    assert cs.bf16_pin_faults(got, pins["p"], pins["p_bf16"]) == []
    print(f"{arch}: port err {cs.bf16_port_err(got, pins['p'])} ref_err "
          f"{pins['p_bf16']['ref_err']}")


def _rolled_kv(orig):
    def repeat_kv(k, n_heads):
        return orig(k.roll(1, dims=2), n_heads)
    return repeat_kv


def _no_causal_mask(orig):
    def attend(q, k, v, is_causal, backend, dtype):
        return orig(q, k, v, False, backend, dtype)
    return attend


@pytest.mark.parametrize("name, attr, broken", [
    ("K/V heads rolled by one", "repeat_kv", _rolled_kv),
    ("causal mask dropped", "_attend", _no_causal_mask)])
def test_a_broken_port_fails_the_bf16_rule(monkeypatch, name, attr, broken):
    tree, inputs, pins = _reference("qwen2-7b")
    monkeypatch.setattr(layers, attr, broken(getattr(layers, attr)))
    got = _port("qwen2-7b", tree, inputs, pins)
    faults = cs.bf16_pin_faults(got, pins["p"], pins["p_bf16"])
    print(f"{name}: port err {cs.bf16_port_err(got, pins['p'])} ref_err "
          f"{pins['p_bf16']['ref_err']}")
    assert faults, name


def _pin(next_, vals, ids=None, ref_err=0.1):
    ids = ids or [[10, 11, 12, 13, 14]]
    return {"next": [next_], "top5_ids": ids, "top5_vals": [vals],
            "ref_err": ref_err, "margin": [vals[0] - vals[1]]}


def _got(next_, vals, ids=None, f32=None):
    ids = ids or [[10, 11, 12, 13, 14]]
    return {"next": [next_], "top5_ids": ids, "top5_vals": [vals],
            "at_f32_ids": [f32 or vals], "at_bf16_ids": [vals]}


@pytest.mark.parametrize("case, got, want_faults", [
    ("exact", _got(10, [5.0, 4.0, 3.0, 2.0, 1.0]), []),
    ("within tol", _got(10, [5.15, 4.1, 3.0, 2.0, 1.0]), []),
    ("accuracy", _got(10, [5.0, 4.0, 3.0, 2.0, 1.0],
                      f32=[5.3, 4.0, 3.0, 2.0, 1.0]), ["(a)"]),
    ("agreement", _got(10, [5.0, 4.5, 3.0, 2.0, 1.0],
                       f32=[5.0, 4.0, 3.0, 2.0, 1.0]), ["(b)"]),
    ("next at a wide margin", _got(11, [5.0, 4.0, 3.0, 2.0, 1.0]), ["(c)"]),
])
def test_the_bf16_rule_on_made_up_pins(case, got, want_faults):
    """tol = 2 x ref_err = 0.2: (a) within tol of the float32 values, (b)
    within 2 tol of the bf16 pin's, (c) the next token at a margin above
    2 tol."""
    f32 = {"top5_ids": [[10, 11, 12, 13, 14]],
           "top5_vals": [[5.0, 4.0, 3.0, 2.0, 1.0]]}
    pin = _pin(10, [5.0, 4.0, 3.0, 2.0, 1.0])
    faults = cs.bf16_pin_faults(got, f32, pin, factor=2.0)
    assert [f[:3] for f in faults] == want_faults, faults


def test_the_bf16_rule_at_a_near_tie():
    """Within 2 tol a next token may be the pin's second, if its logit is
    within tol of the pin's top-1; a token outside the pin's top-5 fails;
    generated tokens after a near tie are not compared; moe counts may
    move by the near ties."""
    f32 = {"top5_ids": [[10, 11, 12, 13, 14]],
           "top5_vals": [[5.0, 4.9, 3.0, 2.0, 1.0]]}
    pin = _pin(10, [5.0, 4.9, 3.0, 2.0, 1.0])
    second = _got(11, [5.0, 4.95, 3.0, 2.0, 1.0], ids=[[11, 10, 12, 13, 14]])
    second["at_f32_ids"] = second["at_bf16_ids"] = [[4.95, 5.0, 3.0, 2.0,
                                                       1.0]]
    assert cs.bf16_pin_faults(second, f32, pin, factor=2.0) == []
    outside = dict(second, next=[99])
    assert cs.bf16_pin_faults(outside, f32, pin, factor=2.0)
    gen = {"tokens": [[1, 2, 3, 4]], "ref_err": 0.1,
           "margin": [[1.0, 1.0, 0.3, 1.0]]}
    assert cs.bf16_pin_faults({"tokens": [[1, 2, 9, 9]]}, {}, gen) == []
    assert cs.bf16_pin_faults({"tokens": [[1, 9, 3, 4]]}, {}, gen)
    routing = {"counts": [4, 4], "near_ties": 1, "ref_err": 0.1}
    assert cs.bf16_pin_faults({"counts": [5, 3]}, {}, routing) == []
    assert cs.bf16_pin_faults({"counts": [6, 2]}, {}, routing)


def test_lm_pin_cfg_is_float32_unless_asked():
    for pkg in (rconfigs, configs):
        for arch in set(cs.LM_PIN_ARCH.values()):
            assert cs.lm_pin_cfg(pkg, arch).dtype == "float32"
            cfg = cs.lm_pin_cfg(pkg, arch, "bfloat16")
            assert cfg.dtype == "bfloat16"
            assert cfg.d_model == pkg.get_config(arch).d_model


def test_every_pin_has_a_float32_and_a_bf16_pin():
    for name in cs.LM_PIN_ARCH:
        assert name in cs.LM_PINS, name
        pin = cs.LM_PINS[f"{name}_bf16"]
        assert pin["ref_err"] > 0, name
        B, S = cs.LM_PIN_SHAPES[name][:2]
        if name.endswith("generate"):
            assert np.shape(pin["tokens"]) == (B, cs.LM_GEN)
            assert np.shape(pin["margin"]) == (B, cs.LM_GEN)
        else:
            assert np.shape(pin["top5_ids"]) == (B, 5)
            assert len(pin["margin"]) == B
            assert ("near_ties" in pin) == ("counts" in cs.LM_PINS[name])
