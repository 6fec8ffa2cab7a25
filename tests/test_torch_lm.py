"""The port's LM serving path (``repro_torch.models``, ``repro_torch.launch``)
against the JAX reference on the CPU, over the four dense ``SMOKE`` configs
and whisper's, with the reference's weights carried across
(``lm.params_from_reference``; biases and norm parameters perturbed from
their zero/one init so that their adds are exercised: ``tests/_lm_ref.py``,
shared with the other LM families' test files).

Tolerances: in float32 (``dataclasses.replace(cfg, dtype="float32")``)
logits to ``rtol 1e-4`` and tokens equal; in the configured bf16 logits
within ``2e-2`` of the largest logit (bf16 activations round at other
places in XLA and torch; the tokens of these inputs are equal too). The
``"torch"`` attention arm runs here; the ``"cuda"`` arm runs on a card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.configs import base as rbase
from repro.launch import serve as rserve
from repro.launch import specs as rspecs
from repro.launch import steps as rsteps
from repro.models import layers as rlayers
from repro.models import lm as rlm
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.launch import serve, specs, steps
from repro_torch.models import layers, lm

from _lm_ref import CPU, DTYPES, RT, logits_close as _logits_close, \
    setup as _setup

DENSE = ["qwen2-7b", "gemma-7b", "deepseek-7b", "command-r-35b"]
ARCHS = DENSE + ["whisper-base"]


def _batch(cfg, B, S, seed=2, frames_len=40):
    """The same prefill batch for both packages."""
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    bj, bt = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.family == "encdec":
        fr = jnp.asarray(r.normal(0, 1, (B, frames_len, cfg.d_model)),
                         jnp.bfloat16)
        bj["frames"] = fr
        bt["frames"] = torch.from_numpy(
            np.array(fr.astype(jnp.float32))).to(torch.bfloat16)
    return bj, bt


# ---------------------------------------------------------------------------
# configs


@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_configs_equal_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        ours = getattr(configs, get)(arch)
        theirs = getattr(rconfigs, get)(arch)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.param_count() == theirs.param_count()
        assert ours.active_param_count() == theirs.active_param_count()


def test_shapes_equal_reference():
    assert configs.ARCH_IDS == rconfigs.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in rbase.SHAPES.items()}
    for arch in configs.ARCH_IDS:
        for name in base.SHAPES:
            assert base.shape_applicable(configs.get_config(arch),
                                         base.SHAPES[name]) == \
                rbase.shape_applicable(rconfigs.get_config(arch),
                                       rbase.SHAPES[name])


# ---------------------------------------------------------------------------
# parameters


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_round_trip(arch, dtype):
    """Every port parameter equals its slice of the reference tree, cast
    once to its dtype (float32 for norm parameters)."""
    cfg, _, tree, _, model = _setup(arch, dtype)
    flat = dict(lm._flatten(tree))
    own = dict(model.named_parameters())
    assert len(own) == sum(
        np.asarray(a).shape[0] if n.split(".")[0] in lm._STACKED else 1
        for n, a in flat.items())
    for name, p in own.items():
        parts = name.split(".")
        if parts[0] in lm._STACKED:
            want = flat[".".join([parts[0]] + parts[2:])][int(parts[1])]
        else:
            want = flat[name]
        want = torch.from_numpy(np.array(want))
        norm = len(parts) > 1 and parts[-2].startswith("ln")
        assert p.dtype == (torch.float32 if norm else lm._dtype(cfg)), name
        assert torch.equal(p, want.to(p.dtype)), name


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_tree(arch):
    """init_params gives the reference's parameter names and shapes, norm
    gains 1, biases 0, and truncated normals within 2 x their scale."""
    cfg = configs.get_smoke_config(arch)
    rcfg = rconfigs.get_smoke_config(arch)
    shapes = jax.eval_shape(
        lambda: rlm.init_params(jax.random.PRNGKey(0), rcfg, RT))
    flat = dict(lm._flatten(jax.tree.map(lambda s: tuple(s.shape), shapes)))
    model = lm.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    stacked = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        leaf = parts[-1]
        if parts[0] in lm._STACKED:
            key = ".".join([parts[0]] + parts[2:])
            stacked.setdefault(key, []).append(tuple(p.shape))
        else:
            stacked[name] = tuple(p.shape)
        if len(parts) > 1 and parts[-2].startswith("ln"):
            assert torch.all(p == (1.0 if leaf == "g" else 0.0)), name
        elif leaf in ("bq", "bk", "bv"):
            assert torch.all(p == 0), name
        else:
            if leaf.startswith("pos_"):
                scale = 0.02
            elif leaf == "table":
                scale = 1.0
            elif leaf == "wo" and p.dim() == 3:          # (H, hd, D)
                scale = 1.0 / np.sqrt(p.shape[0] * p.shape[1])
            else:                                         # fan-in first
                scale = 1.0 / np.sqrt(p.shape[0])
            assert float(p.float().abs().max()) <= 2 * scale * (1 + 1e-2)
            assert float(p.float().std()) > 0.5 * scale, name
    got = {k: (len(v),) + v[0] if isinstance(v, list) else v
           for k, v in stacked.items()}
    assert got == flat


# ---------------------------------------------------------------------------
# the serving path


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, dtype):
    cfg, rcfg, _, params, model = _setup(arch, dtype)
    bj, bt = _batch(cfg, 2, 48)
    want, wstate = jax.jit(lambda p, b: rlm.prefill_fn(p, b, rcfg, RT))(
        params, bj)
    got, state = lm.prefill_fn(model, bt, cfg)
    assert got.dtype == lm._dtype(cfg)
    _logits_close(got, want, dtype)
    if cfg.family == "encdec":        # the encoder states
        _logits_close(state, wstate, dtype)
    toks = steps.make_prefill_step(cfg)(model, bt)
    want_toks = jax.jit(rsteps.make_prefill_step(rcfg, RT))(params, bj)
    assert toks.dtype == torch.int32
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want_toks))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch, dtype):
    """Two decode steps from a filled cache: logits and every cache entry
    (bf16 in both packages, whatever cfg.dtype)."""
    cfg, rcfg, _, params, model = _setup(arch, dtype)
    B, T = 2, 24
    r = np.random.default_rng(4)
    jc = rlm.init_cache(rcfg, B, T, RT)
    fill = jax.tree.map(lambda c: jnp.asarray(
        r.normal(0, 1, c.shape), jnp.bfloat16), jc)
    tc = jax.tree.map(lambda c: torch.from_numpy(
        np.array(c.astype(jnp.float32))).to(torch.bfloat16), fill)
    if cfg.family == "encdec":
        tc = (tuple(tc[0]), tc[1])
    else:
        tc = tuple(tc)
    step = jax.jit(lambda p, c, b: rlm.decode_fn(p, c, b, rcfg, RT))
    jcache = fill
    for pos in ([3, 7], [4, 8]):
        tok = r.integers(0, cfg.vocab, (B, 1), dtype=np.int32)
        want, jcache = step(params, jcache,
                            {"token": jnp.asarray(tok),
                             "pos": jnp.asarray(pos, jnp.int32)})
        got, tc = lm.decode_fn(model, tc, {
            "token": torch.from_numpy(tok),
            "pos": torch.tensor(pos, dtype=torch.int32)}, cfg)
        _logits_close(got, want, dtype)
    for g, w in zip(jax.tree.leaves(tc), jax.tree.leaves(jcache)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32),
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE)
def test_generate_matches_reference(arch, dtype):
    cfg, rcfg, _, params, model = _setup(arch, dtype)
    prompts = np.random.default_rng(6).integers(0, cfg.vocab, (2, 8),
                                                dtype=np.int32)
    want = rserve.generate(rcfg, RT, params, prompts, 6, 32)
    got = serve.generate(cfg, model, prompts, 6, 32)
    assert got.shape == (2, 6)
    np.testing.assert_array_equal(got, want)


def test_chunked_attention_at_2048_matches_reference():
    """S = 2048 takes _sdpa_chunked in both packages."""
    cfg, rcfg, _, params, model = _setup("qwen2-7b", "float32")
    bj, bt = _batch(cfg, 1, layers.ATTN_CHUNK_THRESHOLD)
    want, _ = jax.jit(lambda p, b: rlm.prefill_fn(p, b, rcfg, RT))(params, bj)
    got, _ = lm.prefill_fn(model, bt, cfg)
    _logits_close(got, want, "float32")


def test_sdpa_chunked_equals_sdpa():
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (1, 2048, 2, 16))
                                .astype(np.float32)) for _ in range(3))
    mask = torch.ones((2048, 2048), dtype=torch.bool).tril()[None, None]
    torch.testing.assert_close(
        layers._sdpa_chunked(q, k, v, True, torch.float32),
        layers._sdpa(q, k, v, mask, torch.float32), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# numerics the port mirrors


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = layers._ACT["gelu"](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4      # the erf form differs


def test_rope_angles_match_reference():
    pos = np.arange(4096, dtype=np.int32)[None]
    for theta, hd in ((1e4, 128), (1e6, 128), (8e6, 128), (1e4, 256),
                      (1e4, 28)):
        cj, sj = rlayers.rope_angles(jnp.asarray(pos), hd, theta)
        ct, st = layers.rope_angles(torch.from_numpy(pos), hd, theta)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)


@pytest.mark.parametrize("arch", ["qwen2-7b", "whisper-base"])
def test_cache_is_bf16_in_a_float32_config(arch):
    """init_cache is bf16 whatever cfg.dtype: a float32 config's new K/V
    are rounded to bf16 on the write, as in the reference."""
    cfg, rcfg, _, params, model = _setup(arch, "float32")
    cache = lm.init_cache(cfg, 2, 16, CPU)
    jc = rlm.init_cache(rcfg, 2, 16, RT)
    for c in jax.tree.leaves(cache):
        assert c.dtype == torch.bfloat16
    assert all(c.dtype == jnp.bfloat16 for c in jax.tree.leaves(jc))
    batch = {"token": np.array([[5], [9]], np.int32),
             "pos": np.array([0, 3], np.int32)}
    _, jc = jax.jit(lambda p, c, b: rlm.decode_fn(p, c, b, rcfg, RT))(
        params, jc, jax.tree.map(jnp.asarray, batch))
    _, cache = lm.decode_fn(model, cache, jax.tree.map(torch.from_numpy,
                                                       batch), cfg)
    K = cache[0] if cfg.family == "dense" else cache[0][0]
    Kj = jc[0] if cfg.family == "dense" else jc[0][0]
    assert torch.count_nonzero(K[:, 0, 0]) > 0 and \
        torch.count_nonzero(K[:, 1, 3]) > 0
    np.testing.assert_array_equal(K.float().numpy(),
                                  np.asarray(Kj, np.float32))


def test_cache_write_clamps_past_the_end():
    """A decode position past T-1 writes at T-1 (dynamic_update_slice
    clamps its start) and attends to every cached position."""
    cfg, rcfg, _, params, model = _setup("deepseek-7b", "float32")
    T = 8
    r = np.random.default_rng(9)
    fill = np.stack([r.normal(0, 1, (cfg.n_layers, 2, T, cfg.n_kv_heads,
                                     cfg.hd)) for _ in range(2)])
    jc = tuple(jnp.asarray(f, jnp.bfloat16) for f in fill)
    tc = tuple(torch.from_numpy(np.array(c.astype(jnp.float32)))
               .to(torch.bfloat16) for c in jc)
    batch = {"token": np.array([[5], [9]], np.int32),
             "pos": np.array([T + 3, T - 1], np.int32)}
    want, jc = jax.jit(lambda p, c, b: rlm.decode_fn(p, c, b, rcfg, RT))(
        params, jc, jax.tree.map(jnp.asarray, batch))
    got, tc = lm.decode_fn(model, tc, jax.tree.map(torch.from_numpy, batch),
                           cfg)
    _logits_close(got, want, "float32")
    for g, w, f in zip(tc, jc, fill):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
        assert not np.array_equal(g[:, 0, T - 1].float().numpy(),
                                  np.asarray(jnp.asarray(f[:, 0, T - 1],
                                                         jnp.bfloat16),
                                             np.float32))


# ---------------------------------------------------------------------------
# batches, entry points, families


@pytest.mark.parametrize("arch", ["qwen2-7b", "whisper-base"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_concrete_batch_equals_reference(arch, kind):
    cfg = configs.get_smoke_config(arch)
    shape = base.ShapeConfig("smoke", seq_len=32, global_batch=2, kind=kind)
    want = rspecs.concrete_batch(rconfigs.get_smoke_config(arch),
                                 rbase.ShapeConfig("smoke", 32, 2, kind),
                                 rng=3)
    got = specs.concrete_batch(cfg, shape, rng=3, device="cpu")
    assert list(got) == list(want)
    for k in want:
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want[k], np.float32))


def test_serve_main_smoke_on_cpu(capsys):
    toks = serve.main(["--device", "cpu", "--arch", "qwen2-7b", "--smoke",
                       "--batch", "2", "--prompt-len", "5", "--gen", "4",
                       "--cache-len", "16"])
    assert toks.shape == (2, 4)
    out = capsys.readouterr().out
    assert out.startswith("[serve] qwen2-7b-smoke: (2, 4) generated")
    again = serve.main(["--device", "cpu", "--arch", "qwen2-7b", "--smoke",
                        "--batch", "2", "--prompt-len", "5", "--gen", "4",
                        "--cache-len", "16"])
    np.testing.assert_array_equal(toks, again)   # seeded


def test_encdec_serve_exits_and_unported_families_raise():
    """whisper exits from serve.main, as in the reference; every family
    serves, and since training is ported every family's train batch
    builds, with the reference's keys, shapes and dtypes."""
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--arch", "whisper-base", "--smoke"])
    for arch in configs.ARCH_IDS:
        got = specs.concrete_batch(configs.get_smoke_config(arch),
                                   base.ShapeConfig("t", 32, 2, "train"),
                                   device="cpu")
        want = rspecs.concrete_batch(rconfigs.get_smoke_config(arch),
                                     rbase.ShapeConfig("t", 32, 2, "train"))
        assert list(got) == list(want)
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape), (arch, k)
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)


def test_cuda_backend_on_cpu_raises():
    cfg, _, _, _, model = _setup("qwen2-7b", "float32")
    _, bt = _batch(cfg, 1, 8)
    with pytest.raises(ValueError, match="CUDA device"):
        lm.prefill_fn(model, bt, cfg, backend="cuda")
