"""The port's vlm family (``layers.mrope_angles``, the vision inputs of
``models/lm.py``, the ``vlm`` branch of ``launch/specs.py``, the (t, t, t)
positions of ``serve.generate``) against the JAX reference on the CPU, at
qwen2-vl-7b's ``SMOKE`` config, with the reference's weights carried
across (``tests/_lm_ref.py``; qkv biases and gains perturbed).

M-RoPE at positions (t, t, t) is plain RoPE, so these tests feed vision
tokens on a real (t, h, w) grid: a 4 x 4 grid of (0, h, w) ids, then text
whose ids continue from 4 as (p, p, p). Tolerances are those of
``tests/test_torch_lm.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.configs import base as rbase
from repro.launch import specs as rspecs
from repro.models import layers as rlayers
from repro.models import lm as rlm
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.launch import serve, specs, steps
from repro_torch.models import layers, lm

from _lm_ref import CPU, DTYPES, RT, cache_close, filled_cache, \
    generate_matches, logits_close, setup

ARCH = "qwen2-vl-7b"
B, TEXT = 2, 32


def grid_positions(nv, n_text, batch):
    """(3, batch, nv + n_text) int32: nv vision tokens on a sqrt(nv) square
    grid with (0, h, w) ids, then text ids continuing from the grid's side
    as (p, p, p)."""
    g = int(round(np.sqrt(nv)))
    assert g * g == nv
    h, w = np.divmod(np.arange(nv), g)
    vis = np.stack([np.zeros(nv, np.int64), h, w])
    text = np.tile(g + np.arange(n_text), (3, 1))
    pos = np.concatenate([vis, text], axis=1).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None],
                                                (3, batch, pos.shape[1])))


def _batch(cfg, seed=2):
    r = np.random.default_rng(seed)
    nv = cfg.n_vision_tokens
    toks = r.integers(0, cfg.vocab, (B, TEXT), dtype=np.int32)
    vis = r.normal(0, 1, (B, nv, cfg.d_model)).astype(np.float32)
    pos = grid_positions(nv, TEXT, B)
    bj = {"tokens": jnp.asarray(toks), "vision_embeds": jnp.asarray(vis),
          "positions3d": jnp.asarray(pos)}
    bt = {"tokens": torch.from_numpy(toks),
          "vision_embeds": torch.from_numpy(vis),
          "positions3d": torch.from_numpy(pos)}
    return bj, bt


# ---------------------------------------------------------------------------
# M-RoPE


@pytest.mark.parametrize("theta, hd, sections", [
    (1e6, 128, (16, 24, 24)), (1e4, 24, (4, 4, 4))])
def test_mrope_angles_match_reference_on_a_grid(theta, hd, sections):
    """A 16 x 16 vision grid then 200 text positions, two rows offset from
    each other: cos and sin equal the reference's, and each frequency slot
    follows its section's component."""
    pos = grid_positions(256, 200, 2)
    pos[:, 1] += 7
    cj, sj = rlayers.mrope_angles(jnp.asarray(pos), hd, theta, sections)
    ct, st = layers.mrope_angles(torch.from_numpy(pos), hd, theta, sections)
    assert ct.shape == (2, 456, hd // 2) and ct.dtype == torch.float32
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)
    # slots of the h section (the second) rotate with the h ids alone
    h0 = sections[0]
    c1, _ = layers.rope_angles(torch.from_numpy(pos[1]), hd, theta)
    np.testing.assert_array_equal(ct[:, :, h0].numpy(), c1[:, :, h0].numpy())
    with pytest.raises(ValueError, match="sum to"):
        layers.mrope_angles(torch.from_numpy(pos), hd, theta, (1, 2, 3))


def test_mrope_at_t_t_t_is_rope():
    """The reason the grid matters: at (t, t, t) M-RoPE is plain RoPE."""
    t = np.arange(300, dtype=np.int32)[None].repeat(2, 0)
    cm, sm = layers.mrope_angles(torch.from_numpy(np.stack([t] * 3)), 128,
                                 1e6, (16, 24, 24))
    cr, sr = layers.rope_angles(torch.from_numpy(t), 128, 1e6)
    assert torch.equal(cm, cr) and torch.equal(sm, sr)


# ---------------------------------------------------------------------------
# batches and parameters


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_concrete_batch_equals_reference(kind):
    """The vlm batch: the reference's keys in its order (tokens,
    vision_embeds, positions3d), dtypes and numbers."""
    cfg = configs.get_smoke_config(ARCH)
    want = rspecs.concrete_batch(rconfigs.get_smoke_config(ARCH),
                                 rbase.ShapeConfig("smoke", 48, 2, kind),
                                 rng=3)
    got = specs.concrete_batch(
        cfg, base.ShapeConfig("smoke", seq_len=48, global_batch=2,
                              kind=kind), rng=3, device="cpu")
    assert list(got) == list(want)
    for k in want:
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want[k], np.float32))
    if kind == "prefill":
        assert got["tokens"].shape[1] == 48 - cfg.n_vision_tokens


@pytest.mark.parametrize("dtype", DTYPES)
def test_params_from_reference_round_trip(dtype):
    cfg, _, tree, _, model = setup(ARCH, dtype)
    flat = dict(lm._flatten(tree))
    own = dict(model.named_parameters())
    assert len(own) == sum(np.asarray(a).shape[0] if n.startswith("layers.")
                           else 1 for n, a in flat.items())
    for name, p in own.items():
        parts = name.split(".")
        want = flat[".".join([parts[0]] + parts[2:])][int(parts[1])] \
            if parts[0] == "layers" else flat[name]
        norm = parts[-2].startswith("ln")
        assert p.dtype == (torch.float32 if norm else lm._dtype(cfg)), name
        assert torch.equal(p, torch.from_numpy(np.array(want)).to(p.dtype))
    assert model.layers[0].attn.bq is not None


def test_init_params_has_the_reference_tree():
    cfg = configs.get_smoke_config(ARCH)
    shapes = jax.eval_shape(lambda: rlm.init_params(
        jax.random.PRNGKey(0), rconfigs.get_smoke_config(ARCH), RT))
    want = dict(lm._flatten(jax.tree.map(lambda s: tuple(s.shape), shapes)))
    model = lm.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    got = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            got[".".join(["layers"] + parts[2:])] = \
                (cfg.n_layers,) + tuple(p.shape)
        else:
            got[name] = tuple(p.shape)
    assert got == want


# ---------------------------------------------------------------------------
# the serving path


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_matches_reference(dtype):
    """Vision embeddings (float32, cast to the compute dtype) in front of
    the text, rope at the grid's positions: the last position's logits."""
    cfg, rcfg, _, params, model = setup(ARCH, dtype)
    bj, bt = _batch(cfg)
    want, _ = jax.jit(lambda p, b: rlm.prefill_fn(p, b, rcfg, RT))(params, bj)
    got, state = lm.prefill_fn(model, bt, cfg)
    assert state is None and got.shape == (B, 1, cfg.vocab)
    logits_close(got, want, dtype)
    nxt = steps.make_prefill_step(cfg)(model, bt)
    np.testing.assert_array_equal(nxt.numpy()[:, 0],
                                  np.asarray(want, np.float32)[:, -1]
                                  .argmax(-1))
    # the grid matters: (t, t, t) positions give other logits
    flat = dict(bt, positions3d=torch.arange(
        cfg.n_vision_tokens + TEXT, dtype=torch.int32)[None, None]
        .expand(3, B, -1).contiguous())
    other, _ = lm.prefill_fn(model, flat, cfg)
    assert float((other.float() - got.float()).abs().max()) > \
        0.05 * float(got.float().abs().max())


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_matches_reference(dtype):
    """Two decode steps from a filled cache, each token at its own (t, h,
    w) position: logits and the cache."""
    cfg, rcfg, _, params, model = setup(ARCH, dtype)
    jc, tc = filled_cache(rcfg, 2, 24)
    r = np.random.default_rng(5)
    step = jax.jit(lambda p, c, b: rlm.decode_fn(p, c, b, rcfg, RT))
    for pos in ([3, 7], [4, 8]):
        tok = r.integers(0, cfg.vocab, (2, 1), dtype=np.int32)
        p3 = r.integers(0, 20, (3, 2, 1), dtype=np.int32)
        want, jc = step(params, jc, {"token": jnp.asarray(tok),
                                     "pos": jnp.asarray(pos, jnp.int32),
                                     "positions3d": jnp.asarray(p3)})
        got, tc = lm.decode_fn(model, tc, {
            "token": torch.from_numpy(tok),
            "pos": torch.tensor(pos, dtype=torch.int32),
            "positions3d": torch.from_numpy(p3)}, cfg)
        logits_close(got, want, dtype)
    cache_close(tc, jc)


@pytest.mark.parametrize("dtype", DTYPES)
def test_generate_matches_reference(dtype):
    cfg, rcfg, _, params, model = setup(ARCH, dtype)
    prompts = np.random.default_rng(6).integers(0, cfg.vocab, (2, 8),
                                                dtype=np.int32)
    got = serve.generate(cfg, model, prompts, 6, 32)
    generate_matches(rcfg, params, got, prompts, 6, 32, dtype)


def test_serve_main_smoke_on_cpu(capsys):
    toks = serve.main(["--device", "cpu", "--arch", ARCH, "--smoke",
                       "--batch", "2", "--prompt-len", "5", "--gen", "4",
                       "--cache-len", "16"])
    assert toks.shape == (2, 4)
    assert capsys.readouterr().out.startswith(
        "[serve] qwen2-vl-smoke: (2, 4) generated")


def test_float32_config_reads_the_vision_embeddings_in_float32():
    """A float32 config casts bf16 vision embeddings up, a bf16 one rounds
    float32 ones down, as the reference's astype(dtype) does."""
    for dtype in DTYPES:
        cfg = dataclasses.replace(configs.get_smoke_config(ARCH),
                                  dtype=dtype)
        _, bt = _batch(cfg)
        model = setup(ARCH, dtype)[4]
        x, pos = lm._embed_inputs(model, bt, cfg)
        assert x.dtype == lm._dtype(cfg)
        assert x.shape == (B, cfg.n_vision_tokens + TEXT, cfg.d_model)
        torch.testing.assert_close(
            x[:, :cfg.n_vision_tokens],
            bt["vision_embeds"].to(lm._dtype(cfg)), rtol=0, atol=0)
        assert pos is bt["positions3d"]
