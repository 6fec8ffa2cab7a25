"""The plain references against the program's plain torch arm at SMOKE
widths, float32 on the CPU: the dense loss and every gradient, the prefill
logits of both families (the MoE with its capacity dropping pairs), and one
AdamW step."""

import dataclasses

import pytest
import torch

from gale_bench import registry, weights
from gale_bench.reference import adamw as ref_adamw
from gale_bench.reference import lm as ref_lm
from gale_bench.reference.precision import Precision, full_fp32
from repro_torch.configs import get_smoke_config
from repro_torch.models import lm
from repro_torch.optim import adamw

F32 = Precision("float32")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch_id, **changes):
    arch = dataclasses.replace(get_smoke_config(arch_id), dtype="float32",
                               norm_eps=1e-6, **changes)
    fields = {f.name: getattr(arch, f.name)
              for f in dataclasses.fields(arch) if f.name != "name"}
    name = "granite_moe_block" if arch.family == "moe" else "dense_block"
    shape = registry.model_shape({"name": arch.name, "model": fields,
                                  "reference": name})
    block = registry.reference_block(name)
    specs = ref_lm.param_specs(shape, block)
    model = lm.build(arch, "cpu", torch.float32)
    weights.fill(dict(model.named_parameters()), specs, 5)
    ref = weights.make(specs, 5, "cpu", torch.float32)
    return arch, shape, block, model, ref


def test_dense_loss_and_gradients():
    arch, shape, block, model, ref = _pair("deepseek-7b")
    g = torch.Generator().manual_seed(0)
    tok = torch.randint(0, arch.vocab, (2, 24), generator=g)
    lab = torch.randint(0, arch.vocab, (2, 24), generator=g)
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    loss = lm.loss_fn(model, {"tokens": tok.int(), "labels": lab.int()}, arch,
                      "torch")
    got = torch.autograd.grad(loss, list(named.values()))
    for p in ref.values():
        p.requires_grad_(True)
    with full_fp32():
        want_loss = ref_lm.loss(ref, tok, lab, shape, block, F32)
    want = torch.autograd.grad(want_loss, [ref[n] for n in named])
    assert float(loss) == pytest.approx(float(want_loss), abs=2e-5)
    for n, a, b in zip(named, got, want):
        torch.testing.assert_close(a, b, atol=2e-6, rtol=2e-4, msg=n)


@pytest.mark.parametrize("arch_id,changes", [
    ("deepseek-7b", {}),
    ("granite-moe-3b-a800m", {}),
    ("granite-moe-3b-a800m", {"moe_capacity_factor": 1.0}),
])
def test_prefill_logits(arch_id, changes):
    arch, shape, block, model, ref = _pair(arch_id, **changes)
    tok = torch.randint(0, arch.vocab, (3, 40),
                        generator=torch.Generator().manual_seed(1))
    got, _ = lm.prefill_fn(model, {"tokens": tok.int()}, arch, "torch")
    with full_fp32():
        want = ref_lm.last_logits(ref, tok, shape, block, F32)
    torch.testing.assert_close(got[:, -1], want, atol=2e-4, rtol=2e-4)
    if arch.family == "moe" and arch.moe_capacity_factor == 1.0:
        x = torch.randn(120, arch.d_model, generator=torch.Generator()
                        .manual_seed(2))
        _, _, kept = block.route(x, ref["layers.0.moe.router"], shape, F32)
        assert not bool(kept.all())          # the capacity drops pairs


def test_adamw_step():
    arch, shape, block, model, ref = _pair("deepseek-7b")
    named = dict(model.named_parameters())
    g = torch.Generator().manual_seed(3)
    grads = {n: torch.randn(p.shape, generator=g) * 1e-2
             for n, p in named.items()}
    opt = {"lr": 3e-4, "beta1": 0.9, "beta2": 0.95, "eps": 1e-8,
           "weight_decay": 0.1, "clip_norm": 1.0, "warmup_steps": 2,
           "total_steps": 10, "min_lr_ratio": 0.1}
    cfg = adamw.AdamWConfig(**opt)
    state = adamw.init_state(named, cfg)
    r = ref_adamw.AdamW(ref, opt)
    for _ in range(3):
        adamw.apply_updates(named, grads, state, cfg,
                            lm.reference_layout(model))
        r.step(grads)
    for n, p in named.items():
        torch.testing.assert_close(p, ref[n], atol=1e-7, rtol=1e-6, msg=n)
