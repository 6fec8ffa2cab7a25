"""The port's LM training path (``lm.loss_fn``, ``layers.softmax_xent``,
``lm._chunked_xent``, the flash kernels' autograd Function,
``moe.aux_load_balance_loss``, ``lm.param_count``, ``launch/steps.
make_train_step`` and ``launch/train``) against the JAX reference on the
CPU, over every ``SMOKE`` config in float32 with the reference's weights
carried across (``tests/_lm_ref.py``).

Tolerances, float32 throughout (the two packages sum in other orders):
losses to ``rtol 2e-6``; every parameter's gradient within ``2e-4`` of
its largest entry (an entry near zero is a difference of large terms);
the flash Function's gradient against autograd through the plain version
to ``1e-5``; the trainer's clean and faulted runs within the reference's
own ``1e-5`` (``tests/test_distributed.py``); three train steps' losses to
``rtol 1e-5``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.configs import base as rbase
from repro.data.tokens import SyntheticTokens as RSyntheticTokens
from repro.distributed.sharding import Runtime
from repro.launch import specs as rspecs
from repro.launch import steps as rsteps
from repro.models import layers as rlayers
from repro.models import lm as rlm
from repro.models import moe as rmoe
from repro.optim import adamw as radamw
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import specs, steps, train
from repro_torch.models import layers, lm, moe
from repro_torch.optim import adamw

import _train_tol
from _lm_ref import CPU, RT, setup

B, S = 2, 64
LOSS_RTOL = 2e-6
GRAD_TOL = 2e-4


def _batches(arch, rcfg, cfg, seq=S, seed=3):
    shape = ("train", seq, B, "train")
    want = rspecs.concrete_batch(rcfg, rbase.ShapeConfig(*shape), rng=seed)
    got = specs.concrete_batch(cfg, base.ShapeConfig(*shape), rng=seed,
                               device="cpu")
    return want, got


def _grads_close(got, want_tree, cfg):
    want = lm.unstacked(jax.tree.map(np.asarray, want_tree), cfg)
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name]
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * scale, err_msg=name)


# ---------------------------------------------------------------------------
# the loss


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_reference(masked):
    r = np.random.default_rng(0)
    logits = r.normal(0, 3, (2, 9, 50)).astype(np.float32)
    labels = r.integers(0, 50, (2, 9), dtype=np.int32)
    mask = (r.random((2, 9)) < 0.6).astype(np.float32) if masked else None
    want = rlayers.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                None if mask is None else jnp.asarray(mask))
    got = layers.softmax_xent(torch.from_numpy(logits),
                              torch.from_numpy(labels),
                              None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_loss_and_every_gradient_match_reference(arch):
    """loss_fn and the gradient of every parameter, from the same weights
    and the same train batch, equal the reference's ``jax.value_and_grad``
    (its stacked gradients unstacked)."""
    cfg, rcfg, _, params, model = setup(arch, "float32")
    bj, bt = _batches(arch, rcfg, cfg)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: rlm.loss_fn(p, bj, rcfg, RT)))(params)
    loss, grads = steps.loss_and_grads(model, bt, cfg)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    _grads_close(grads, want_grads, cfg)
    assert all(torch.isfinite(g).all() for g in grads.values())


def test_chunked_xent_equals_the_unchunked_loss_and_the_reference():
    """loss_chunk=16 over S=64 (the reference's remat'd scan of the loss):
    the same loss as one pass, and as the reference's chunked loss; the
    gradients equal the unchunked ones."""
    cfg, rcfg, _, params, model = setup("qwen2-7b", "float32")
    bj, bt = _batches("qwen2-7b", rcfg, cfg)
    want = rlm.loss_fn(params, bj, rcfg, Runtime(mesh=None, remat="none",
                                                 loss_chunk=16))
    loss, grads = steps.loss_and_grads(model, bt, cfg, loss_chunk=16)
    one, grads1 = steps.loss_and_grads(model, bt, cfg)
    np.testing.assert_allclose(float(loss), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(loss), float(one), rtol=LOSS_RTOL)
    for name, g in grads.items():
        torch.testing.assert_close(g, grads1[name], rtol=1e-5,
                                   atol=1e-5 * float(g.abs().max()))


@pytest.mark.parametrize("arch", ["qwen2-7b", "mamba2-130m", "zamba2-2.7b",
                                  "whisper-base"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_keeps_the_loss_and_gradients(arch, remat):
    """Checkpointing each block (a hybrid's group) recomputes the same
    numbers: the loss and gradients of remat="none"."""
    cfg, _, _, _, model = setup(arch, "float32")
    _, bt = _batches(arch, rconfigs.get_smoke_config(arch), cfg)
    want, wgrads = steps.loss_and_grads(model, bt, cfg)
    got, grads = steps.loss_and_grads(model, bt, cfg, remat=remat)
    assert float(got) == float(want)
    for name, g in grads.items():
        torch.testing.assert_close(g, wgrads[name], rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="remat"):
        lm.loss_fn(model, bt, cfg, remat="some")


# ---------------------------------------------------------------------------
# the flash kernels' gradient, with the plain forward


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV", [(4, 2), (4, 4)])
def test_flash_function_gradient_equals_autograd_of_the_plain_version(
        causal, H, KV):
    """The autograd Function with flash_attention_ref as its forward: the
    output and (dq, dk, dv) equal autograd through flash_attention_ref
    itself; S and T past one 1024-row chunk of the backward, S != T."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 1030, H, 16), generator=g, requires_grad=True)
    k = torch.randn((1, 1040, KV, 16), generator=g, requires_grad=True)
    v = torch.randn((1, 1040, KV, 16), generator=g, requires_grad=True)
    dout = torch.randn((1, 1030, H, 16), generator=g)
    out = layers.flash_attention_trainable(
        q, k, v, causal=causal, forward=fa.flash_attention_ref)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), dout)
    ref = fa.flash_attention_ref(q, k, v, causal=causal)
    want = torch.autograd.grad(ref, (q, k, v), dout)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S", [1030, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_backward_is_the_torch_arms(S, dtype):
    """The Function's backward is the gradient of the ``"torch"`` arm's
    attention (``_sdpa`` below ATTN_CHUNK_THRESHOLD, ``_sdpa_chunked`` at
    it), in the compute dtype: with that arm as its forward, (dq, dk, dv)
    equal autograd through the arm, causal GQA. The backward cuts the rows
    into other chunks and a causal chunk into fewer keys, so the products
    are summed in other blocks: float32 to 1e-5, bf16 to one bf16 ulp
    (2**-8) of each gradient's largest entry."""
    g = torch.Generator().manual_seed(1)
    H, KV, hd = 4, 2, 16
    q = torch.randn((1, S, H, hd), generator=g).to(dtype).requires_grad_()
    k, v = (torch.randn((1, S, KV, hd), generator=g).to(dtype)
            .requires_grad_() for _ in range(2))
    dout = torch.randn((1, S, H, hd), generator=g).to(dtype)

    def torch_arm(q, k, v, causal=True):
        kf, vf = layers.repeat_kv(k, H), layers.repeat_kv(v, H)
        if S >= layers.ATTN_CHUNK_THRESHOLD:
            return layers._sdpa_chunked(q, kf, vf, causal, dtype)
        mask = torch.ones((S, S), dtype=torch.bool).tril()[None, None]
        return layers._sdpa(q, kf, vf, mask, dtype)
    out = layers.flash_attention_trainable(q, k, v, forward=torch_arm)
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = torch.autograd.grad(torch_arm(q, k, v), (q, k, v), dout)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        tol = 1e-5 if dtype == torch.float32 else 2 ** -8
        torch.testing.assert_close(a.float(), b.float(), rtol=tol,
                                   atol=tol * float(b.float().abs().max()))


def test_flash_function_never_falls_back_on_the_cpu():
    q = torch.zeros((1, 4, 2, 16), requires_grad=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        layers.flash_attention_trainable(q, q, q)


# ---------------------------------------------------------------------------
# MoE auxiliary loss, parameter counts


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "phi3.5-moe-42b-a6.6b"])
def test_aux_load_balance_loss_matches_reference(arch):
    cfg, rcfg, tree, _, model = setup(arch, "float32")
    x = np.random.default_rng(5).normal(0, 1, (96, cfg.d_model)).astype(
        np.float32)
    p = {k: jnp.asarray(v[0]) for k, v in tree["layers"]["moe"].items()}
    want = rmoe.aux_load_balance_loss(p, jnp.asarray(x), rcfg, jnp.float32)
    got = moe.aux_load_balance_loss(model.layers[0].moe,
                                    torch.from_numpy(x), cfg)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)


@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_param_count_matches_reference(arch):
    """lm.param_count equals the reference's on its tree, and the analytic
    count within 5% (plus encdec's position tables and unembedding, as the
    reference's test allows)."""
    cfg = configs.get_smoke_config(arch)
    shapes = jax.eval_shape(lambda: rlm.init_params(
        jax.random.PRNGKey(0), rconfigs.get_smoke_config(arch), RT))
    model = lm.build(cfg, "meta", torch.float32)
    got = lm.param_count(model)
    assert got == rlm.param_count(shapes)
    analytic = cfg.param_count()
    if cfg.family == "encdec":
        analytic += 2 * cfg.max_pos * cfg.d_model + cfg.d_model * cfg.vocab
    assert abs(got - analytic) / got < 0.05


# ---------------------------------------------------------------------------
# the train step and the trainer


def test_three_train_steps_match_reference():
    """make_train_step from the reference's smoke weights (float32 masters
    and compute) on SyntheticTokens batches 0-2: the loss history, the
    grad norms and the learning rates equal the reference's."""
    arch = "deepseek-7b"
    cfg, rcfg, tree, _, _ = setup(arch, "float32")
    opt = radamw.AdamWConfig(total_steps=3, warmup_steps=2)
    step_j = jax.jit(rsteps.make_train_step(rcfg, RT, opt))
    params = jax.tree.map(jnp.asarray, tree)
    state = radamw.init_state(params, opt)
    model = lm.params_from_reference(tree, cfg, CPU, torch.float32)
    ostate = adamw.init_state(dict(model.named_parameters()),
                              adamw.AdamWConfig(total_steps=3,
                                                warmup_steps=2))
    step_t = steps.make_train_step(cfg, adamw.AdamWConfig(total_steps=3,
                                                          warmup_steps=2))
    src = RSyntheticTokens(cfg.vocab, seed=0)
    for i in range(3):
        b = src.batch(i, B, S)
        params, state, mj = step_j(params, state,
                                   {k: jnp.asarray(v) for k, v in b.items()})
        model, ostate, mt = step_t(model, ostate, train.train_batch(
            cfg, b, CPU))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(mt[key]), float(mj[key]),
                                       rtol=1e-5, err_msg=f"{key} {i}")


def test_trainer_replays_after_an_injected_fault(tmp_path, capsys):
    """The reference's test_fault_tolerant_training_replays in process: a
    clean run and one faulted at step 6 (restored from step 4) give the
    same step-11 loss within 1e-5."""
    common = ["--device", "cpu", "--arch", "deepseek-7b", "--smoke",
              "--steps", "12", "--batch", "2", "--seq", "64",
              "--ckpt-every", "4"]
    train.main(common + ["--ckpt-dir", str(tmp_path / "a"),
                         "--out", str(tmp_path / "a.json")])
    train.main(common + ["--inject-fault-at", "6",
                         "--ckpt-dir", str(tmp_path / "b"),
                         "--out", str(tmp_path / "b.json")])
    out = capsys.readouterr().out
    assert "[train] deepseek-7b-smoke: 459,392 params" in out
    assert "[fault] restored step 4" in out
    a = json.load(open(tmp_path / "a.json"))
    b = json.load(open(tmp_path / "b.json"))
    assert b["injected"] == [6] and a["injected"] == []
    assert [h["step"] for h in b["history"]] == \
        list(range(6)) + list(range(4, 12))
    la = [h["loss"] for h in a["history"] if h["step"] == 11][-1]
    lb = [h["loss"] for h in b["history"] if h["step"] == 11][-1]
    assert abs(la - lb) < 1e-5, (la, lb)


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "whisper-base",
                                  "granite-moe-3b-a800m", "zamba2-2.7b"])
def test_trainer_runs_every_family_on_the_cpu(arch, tmp_path):
    """The reference trainer's extra inputs (zero vision embeddings and
    positions through them; zero frames) and a few finite steps."""
    hist = train.main(["--device", "cpu", "--arch", arch, "--smoke",
                       "--steps", "2", "--batch", "2", "--seq", "32",
                       "--ckpt-dir", str(tmp_path)])
    assert len(hist) == 2
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in hist)


def test_the_hybrids_gradients_amplify_attention_rounding():
    """Why the hybrid's train step on the card is held at a wider float32
    tolerance (``tests/_train_tol.py``): a 1e-6 relative perturbation of
    the attention output moves zamba2's gradients over 10x as far
    (relative to that tolerance) as the dense family's; its recurrence
    amplifies the kernels' 3xTF32 rounding, which is of that order. The
    ratio is the factor the card test applies."""
    dense = _train_tol.sensitivity(_train_tol.DENSE)
    hybrid = _train_tol.sensitivity("zamba2-2.7b")
    print(f"sensitivity: dense {dense}, hybrid {hybrid}, ratio "
          f"{hybrid / dense}")
    assert dense < 0.1 and hybrid > 10 * dense, (dense, hybrid)
    assert _train_tol.tolerance("zamba2-2.7b", "float32") == \
        _train_tol.TRAIN_TOL[torch.float32] * hybrid / dense


def _wrong_kernels():
    """Forwards a broken kernel could compute: the causal mask ignored, the
    KV heads taken in the wrong order, the scores' scale 1% off."""
    def noncausal(q, k, v, causal=True):
        return fa.flash_attention_ref(q, k, v, causal=False)

    def kv_flipped(q, k, v, causal=True):
        return fa.flash_attention_ref(q, k.flip(2), v.flip(2), causal=causal)

    def scale_off(q, k, v, causal=True):
        return fa.flash_attention_ref(q * 0.99, k, v, causal=causal)
    return {"noncausal": noncausal, "kv_flipped": kv_flipped,
            "scale_off": scale_off}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_hybrids_card_tolerance_fails_a_wrong_kernel(dtype):
    """The control of the hybrid's card tolerance (``tests/_train_tol.
    py``): the kernel's plain forward stays within it, and a kernel that
    ignores the causal mask or maps the KV heads wrongly does not, on the
    card test's own measure. In float32 a 1% error in the scores' scale
    fails it too; in bf16 it does not (the gradients through the hybrid
    cannot tell it from bf16 rounding: within 2 spreads)."""
    arch = "zamba2-2.7b"
    factor = _train_tol.tolerance(arch, dtype) / \
        _train_tol.TRAIN_TOL[getattr(torch, dtype)]
    plain = _train_tol.deviation(arch, dtype, fa.flash_attention_ref)
    wrong = {name: _train_tol.deviation(arch, dtype, f)
             for name, f in _wrong_kernels().items()}
    print(f"{dtype}: factor {factor}, plain forward {plain}, wrong {wrong}")
    assert factor > 1
    assert plain < factor
    caught = ("noncausal", "kv_flipped") + (
        ("scale_off",) if dtype == "float32" else ())
    for name in caught:
        assert wrong[name] > factor, (name, wrong[name], factor)
