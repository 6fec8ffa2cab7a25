"""The port's optimizer, checkpoints, token stream and resilient loop
(``optim/adamw.py``, ``checkpoint/ckpt.py``, ``data/tokens.py``,
``distributed/fault.py``) against the JAX reference's on the CPU.

Tolerances: one AdamW step from a shared state (``state_from_reference``)
to ``rtol 1e-6`` on parameters and moments (float32 elementwise
arithmetic; the two compilers may fuse differently; the error feedback
within ``1e-6`` of its compressed gradient's largest entry) and ``rtol
1e-6`` on the grad norm (summed in another order); the schedule to
``rtol 1e-6`` (float32 ``cos`` and ``pow`` of two libraries); int8
compression exact; checkpoints, token batches and the loop's histories
exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import tokens as rtokens
from repro.distributed import fault as rfault
from repro.optim import adamw as radamw
from repro_torch.checkpoint import ckpt
from repro_torch.data import tokens
from repro_torch.distributed import fault
from repro_torch.models import lm
from repro_torch.optim import adamw

from _lm_ref import CPU, setup

RTOL = 1e-6


def _shared_state(tree, seed, compress):
    """Seeded gradients and moments in the reference's layout."""
    r = np.random.default_rng(seed)

    def draw(scale, positive=False):
        def f(x):
            y = r.standard_normal(np.shape(x)).astype(np.float32) * scale
            return np.abs(y) if positive else y
        return jax.tree.map(f, tree)
    state = {"mu": draw(1e-2), "nu": draw(1e-4, True),
             "step": np.int32(3)}
    if compress:
        state["ef"] = draw(1e-3)
    return draw(1e-2), state


def _close(got: torch.Tensor, want, name, size=None):
    """Within RTOL of the largest entry of ``want``, or of ``size`` where
    given (the error feedback is the difference of two numbers of the
    compressed gradient's size, and holds their rounding)."""
    want = np.asarray(want, np.float32)
    size = np.abs(want).max() if size is None else size
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * max(size, 1e-30), err_msg=name)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("arch", ["qwen2-7b", "zamba2-2.7b",
                                  "whisper-base"])
def test_apply_updates_matches_reference(arch, compress):
    """One step from a shared state: parameters, mu, nu (and the error
    feedback), grad_norm, lr and step equal the reference's; the stacked
    groups' 1-d leaves (norm gains, biases, Mamba2 vectors) are decayed as
    the reference decays their stacked arrays, the hybrid's unstacked
    shared block's are not; compression takes one scale per stacked
    array."""
    cfg, _, tree, _, _ = setup(arch, "float32")
    grads_np, state_np = _shared_state(tree, 7, compress)
    opt = adamw.AdamWConfig(total_steps=50, warmup_steps=5,
                            compress_grads=compress)
    ropt = radamw.AdamWConfig(total_steps=50, warmup_steps=5,
                              compress_grads=compress)
    jt = lambda t: jax.tree.map(jnp.asarray, t)   # noqa: E731
    wp, ws, wm = jax.jit(lambda p, g, s: radamw.apply_updates(p, g, s, ropt))(
        jt(tree), jt(grads_np), jt(state_np))

    model = lm.params_from_reference(tree, cfg, CPU, torch.float32)
    named = dict(model.named_parameters())
    state = adamw.state_from_reference(state_np, cfg, CPU)
    ef0 = {n: t.clone() for n, t in state.get("ef", {}).items()}
    grads = {n: torch.from_numpy(a) for n, a in
             lm.unstacked(grads_np, cfg).items()}
    layout = lm.reference_layout(model)
    _, state, metrics = adamw.apply_updates(named, grads, state, opt, layout)

    assert int(state["step"]) == int(ws["step"]) == 4
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(wm["grad_norm"]), rtol=RTOL)
    np.testing.assert_allclose(float(metrics["lr"]), float(wm["lr"]),
                               rtol=RTOL)
    for key, got_tree, want_tree in (("params", named, wp),
                                     ("mu", state["mu"], ws["mu"]),
                                     ("nu", state["nu"], ws["nu"])) + (
            (("ef", state["ef"], ws["ef"]),) if compress else ()):
        want = lm.unstacked(want_tree, cfg)
        assert set(want) == set(got_tree), key
        for name, t in got_tree.items():
            size = float((grads[name] + ef0[name]).abs().max()) \
                if key == "ef" else None
            _close(t.detach(), want[name], f"{key} {name}", size)

    # the decay rule: by the reference's rank, not the port's
    norm = "layers.0.0.ln.g" if cfg.family == "hybrid" else \
        ("enc_layers.0.ln1.g" if cfg.family == "encdec" else
         "layers.0.ln1.g")
    assert named[norm].dim() == 1 and layout[norm][1] >= 2
    if cfg.family == "hybrid":
        assert layout["shared_attn.ln1.g"] == ("shared_attn.ln1.g", 1)
    again = lm.params_from_reference(tree, cfg, CPU, torch.float32)
    adamw.apply_updates(dict(again.named_parameters()), grads,
                        adamw.state_from_reference(state_np, cfg, CPU), opt)
    assert not torch.equal(dict(again.named_parameters())[norm],
                           named[norm])


@pytest.mark.parametrize("step", [0, 1, 3, 5, 17, 50, 80])
def test_schedule_matches_reference(step):
    for kw in ({}, {"warmup_steps": 5, "total_steps": 50},
               {"warmup_steps": 0, "total_steps": 1, "lr": 1e-3}):
        got = adamw.schedule(torch.tensor(step, dtype=torch.int32),
                             adamw.AdamWConfig(**kw))
        want = radamw.schedule(jnp.int32(step), radamw.AdamWConfig(**kw))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_global_norm_and_init_state_match_reference():
    cfg, _, tree, _, _ = setup("mamba2-130m", "float32")
    want = radamw.global_norm(jax.tree.map(jnp.asarray, tree))
    named = {n: torch.from_numpy(a) for n, a in
             lm.unstacked(tree, cfg).items()}
    got = adamw.global_norm(named)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    st = adamw.init_state(named, adamw.AdamWConfig(compress_grads=True))
    assert set(st) == {"mu", "nu", "ef", "step"} and int(st["step"]) == 0
    for key in ("mu", "nu", "ef"):
        assert all(t.dtype == torch.float32 and not t.any() and
                   t.shape == named[n].shape for n, t in st[key].items())


def test_compress_int8_matches_reference_with_error_feedback():
    """Equal to the reference's quantisation, and its error-feedback check
    (tests/test_distributed.py): two steps of a constant gradient rebuild
    it to int8 accuracy."""
    g = np.linspace(-1, 1, 64, dtype=np.float32) * 0.01
    rng = np.random.default_rng(2)
    ef0 = rng.normal(0, 1e-3, 64).astype(np.float32)
    wd, we = radamw.compress_int8(jnp.asarray(g), jnp.asarray(ef0))
    gd, ge = adamw.compress_int8(torch.from_numpy(g), torch.from_numpy(ef0))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(ge.numpy(), np.asarray(we))
    gt = torch.from_numpy(g)
    deq1, ef = adamw.compress_int8(gt, torch.zeros_like(gt))
    deq2, ef = adamw.compress_int8(gt, ef)
    err = float((deq1 + deq2 - 2 * gt).abs().max())
    assert err <= 0.01 * 2 / 127 + 1e-6


# ---------------------------------------------------------------------------
# checkpoints


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"layers.0.attn.wq": torch.randn((3, 2, 4),
                                                       generator=g),
                       "embed.table": torch.randn((5, 4), generator=g)
                       .to(torch.bfloat16)},
            "opt": {"mu": {"layers.0.attn.wq": torch.randn((3, 2, 4),
                                                           generator=g)},
                    "step": torch.tensor(seed, dtype=torch.int32)}}


def test_checkpoint_round_trip_and_keeps_three(tmp_path):
    for step in range(1, 6):
        ckpt.save(str(tmp_path), _tree(step), step)
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_00000003", "step_00000004", "step_00000005"]
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    like = _tree(0)
    got, step = ckpt.restore(str(tmp_path), like, 4)
    assert step == 4
    want = ckpt.flatten(_tree(4))
    flat = ckpt.flatten(got)
    assert list(flat) == list(want)
    for name, t in flat.items():
        assert t.dtype == want[name].dtype and t.device == CPU
        assert torch.equal(t, want[name]), name
    latest, step = ckpt.restore(str(tmp_path), like)
    assert step == 5 and torch.equal(latest["opt"]["step"],
                                      torch.tensor(5, dtype=torch.int32))


def test_checkpoint_restore_refuses_what_it_cannot_do(tmp_path):
    ckpt.save(str(tmp_path), _tree(1), 1)
    with pytest.raises(ValueError, match="shardings name other tensors"):
        ckpt.restore(str(tmp_path), _tree(1), shardings={})
    other = _tree(1)
    del other["opt"]["mu"]
    with pytest.raises(ValueError, match="other tensors"):
        ckpt.restore(str(tmp_path), other)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "empty"), _tree(1))
    ckpt.save(str(tmp_path), _tree(2), 1)          # the same step again
    got, _ = ckpt.restore(str(tmp_path), _tree(0), 1)
    assert torch.equal(got["opt"]["step"], torch.tensor(2,
                                                        dtype=torch.int32))
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".tmp")]


# ---------------------------------------------------------------------------
# the token stream and the resilient loop


def test_synthetic_tokens_and_loader_equal_reference():
    ours, theirs = tokens.SyntheticTokens(512, 3), rtokens.SyntheticTokens(
        512, 3)
    for step in (0, 1, 7):
        a, b = ours.batch(step, 2, 16), theirs.batch(step, 2, 16)
        assert list(a) == list(b) == ["tokens", "labels"]
        for k in a:
            assert a[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    loader = tokens.PrefetchingLoader(ours, 2, 16, start_step=5, depth=2)
    try:
        it = iter(loader)
        for step in (5, 6, 7):
            b = next(it)
            assert b["step"] == step
            np.testing.assert_array_equal(b["tokens"],
                                          theirs.batch(step, 2, 16)["tokens"])
    finally:
        loader.close()
    assert not loader._thread.is_alive()


def _loop(mod, fail_at, n_steps=9, ckpt_every=2):
    saved, logs = {}, []

    def step_fn(state, batch):
        if batch == 99:
            raise ValueError("bad batch")
        return state + batch, {"loss": state * 0.5}

    def restore_fn():
        if not saved:
            return None
        step = max(saved)
        return saved[step], step

    inj = mod.FaultInjector(fail_at)
    wd = mod.StragglerWatchdog()
    state, hist = mod.resilient_loop(
        step_fn, 1, lambda s: s + 1, n_steps, lambda st, s: saved.__setitem__(
            s, st), restore_fn, ckpt_every=ckpt_every, injector=inj,
        watchdog=wd, log=logs.append)
    return state, [{k: v for k, v in h.items() if k != "dt"} for h in hist], \
        inj.injected, logs, sorted(saved)


@pytest.mark.parametrize("fail_at", [(), (3,), (0, 5), (1, 6)])
def test_resilient_loop_equals_reference(fail_at):
    assert _loop(fault, fail_at) == _loop(rfault, fail_at)


def test_straggler_watchdog_equals_reference():
    ours, theirs = fault.StragglerWatchdog(window=8), \
        rfault.StragglerWatchdog(window=8)
    for step, dt in enumerate([1.0] * 9 + [5.0, 1.0, 2.9, 3.5]):
        ours.record(step, dt)
        theirs.record(step, dt)
    assert ours.stragglers == theirs.stragglers != []
