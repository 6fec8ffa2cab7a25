"""The port's ssm and hybrid families (``repro_torch.models.mamba2``, the
``ssm`` / ``hybrid`` stacks of ``models/lm.py``) against the JAX reference
on the CPU, for mamba2-130m and zamba2-2.7b at their ``SMOKE`` configs,
with the reference's weights carried across (``tests/_lm_ref.py``:
``conv_b``, ``dt_bias``, ``A_log``, ``D``, biases and gains perturbed).

Tolerances are those of ``tests/test_torch_lm.py``. The SSD pieces
(``_causal_conv``, ``ssd_chunked`` over three chunks from an initial state,
one recurrent step) are held one by one, then the stacks: prefill (with
the ssm's stacked states), two decode steps from a filled cache, and
``generate``. A float32 config's SSM states come back float32 after one
decode step, as the reference's do; the hybrid cache's K and V are two
tensors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import lm as rlm
from repro.models import mamba2 as rmamba
from repro_torch import configs
from repro_torch.launch import serve, steps
from repro_torch.models import lm, mamba2

from _lm_ref import CPU, DTYPES, RT, cache_close, filled_cache, \
    generate_matches, logits_close, setup, to_torch

ARCHS = ["mamba2-130m", "zamba2-2.7b"]
B, S = 2, 64                      # two chunks of the smoke configs' 32
# parameters the reference applies in float32
_F32 = ("A_log", "dt_bias")


def _names(cfg, tree):
    """Port parameter name -> the reference array it is a slice of."""
    out = {}
    for name, arr in lm._flatten(tree):
        group, _, rest = name.partition(".")
        arr = np.asarray(arr)
        depth = lm._stack_depth(cfg, group)
        if depth == 0:
            out[name] = arr
        elif depth == 1:
            for i in range(arr.shape[0]):
                out[f"{group}.{i}.{rest}"] = arr[i]
        else:
            for g in range(arr.shape[0]):
                for j in range(arr.shape[1]):
                    out[f"{group}.{g}.{j}.{rest}"] = arr[g, j]
    return out


def _mix(tree, cfg):
    """The first Mamba2 layer's reference parameters."""
    lead = (0,) if cfg.family == "ssm" else (0, 0)
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[lead]),
                        tree["layers"]["mix"])


def _first_mix(model):
    layer = model.layers[0]
    return (layer if isinstance(layer, lm.MambaLayer) else layer[0]).mix


# ---------------------------------------------------------------------------
# parameters


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_round_trip(arch, dtype):
    """Every port parameter equals its slice of the reference tree (both
    stacked axes of the hybrid's layers; its shared block unstacked), cast
    once to its dtype: norm gains, A_log and dt_bias float32."""
    cfg, _, tree, _, model = setup(arch, dtype)
    want = _names(cfg, tree)
    own = dict(model.named_parameters())
    assert set(own) == set(want)
    for name, p in own.items():
        leaf, parent = name.split(".")[-1], name.split(".")[-2]
        f32 = leaf in _F32 or parent.startswith("ln") or parent == "norm"
        assert p.dtype == (torch.float32 if f32 else lm._dtype(cfg)), name
        assert torch.equal(p, torch.from_numpy(want[name]).to(p.dtype)), name
    if cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.attn_every
        assert len(model.layers) == groups
        assert all(len(g) == cfg.attn_every for g in model.layers)
        assert tuple(model.shared_attn.in_proj.w.shape) == \
            (2 * cfg.d_model, cfg.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_tree(arch):
    """init_params gives the reference's names and shapes, and Mamba2's
    init: A_log = log(linspace(1, 16, h)) (to an ulp: XLA's linspace and
    log round their own way), D = 1, dt_bias = conv_b = 0, conv taps at
    1/sqrt(K), projections at 1/sqrt(fan-in)."""
    cfg = configs.get_smoke_config(arch)
    rcfg = rconfigs.get_smoke_config(arch)
    shapes = jax.eval_shape(
        lambda: rlm.init_params(jax.random.PRNGKey(0), rcfg, RT))
    want = {k: v.shape for k, v in _names(cfg, jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    model = lm.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == want
    ref = rmamba.mamba2_init(jax.random.PRNGKey(0), rcfg)
    m = _first_mix(model)
    for name in ("D", "dt_bias", "conv_b"):
        np.testing.assert_array_equal(getattr(m, name).float().numpy(),
                                      np.asarray(ref[name]))
    np.testing.assert_allclose(m.A_log.numpy(), np.asarray(ref["A_log"]),
                               rtol=3e-7, atol=0)
    for w, fan in ((m.conv_w, cfg.ssm_conv), (m.in_proj.w, cfg.d_model),
                   (m.out_proj.w, cfg.d_inner)):
        s = 1.0 / np.sqrt(fan)
        assert float(w.float().abs().max()) <= 2 * s * (1 + 1e-2)
        assert float(w.float().std()) > 0.5 * s
    if cfg.family == "hybrid":
        w = model.shared_attn.in_proj.w
        assert float(w.float().std()) > 0.5 / np.sqrt(2 * cfg.d_model)


# ---------------------------------------------------------------------------
# the SSD pieces


def test_causal_conv_matches_reference():
    """From zeros and from a streaming state: the output and the new state
    (the trailing K-1 inputs)."""
    r = np.random.default_rng(1)
    x = r.normal(0, 1, (2, 9, 12)).astype(np.float32)
    w = r.normal(0, 1, (4, 12)).astype(np.float32)
    b = r.normal(0, 1, (12,)).astype(np.float32)
    st = r.normal(0, 1, (2, 3, 12)).astype(np.float32)
    for state in (None, st):
        want = rmamba._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), None if state is None
                                   else jnp.asarray(state))
        got = mamba2._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(b), None if state is None
                                  else torch.from_numpy(state))
        for g, wnt in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(wnt),
                                       rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), x[:, -3:])


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_chunked_matches_reference(dtype):
    """Three chunks from a nonzero initial state; the segment sums' -inf
    above the diagonal, exp(cum[-1] - cum) and the chunk states in float32
    where the reference keeps them, cast where it casts."""
    r = np.random.default_rng(2)
    b, s, h, p, n, chunk = 2, 48, 3, 4, 5, 16
    jt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    x = jnp.asarray(r.normal(0, 1, (b, s, h, p)), jt)
    dt = jnp.asarray(np.log1p(np.exp(r.normal(0, 1, (b, s, h)))),
                     jnp.float32)
    A = -jnp.exp(jnp.asarray(r.normal(0, 0.5, (h,)), jnp.float32))
    Bm = jnp.asarray(r.normal(0, 1, (b, s, n)), jt)
    Cm = jnp.asarray(r.normal(0, 1, (b, s, n)), jt)
    init = jnp.asarray(r.normal(0, 1, (b, h, p, n)), jt)
    want = rmamba.ssd_chunked(x, dt, A, Bm, Cm, chunk, init)
    got = mamba2.ssd_chunked(*map(to_torch, (x, dt, A, Bm, Cm)), chunk,
                             to_torch(init))
    for g, wnt in zip(got, want):
        assert str(g.dtype).split(".")[-1] == str(wnt.dtype)
        logits_close(g, wnt, dtype)
    seg = mamba2._segsum(torch.arange(4.0))
    assert torch.isneginf(seg[0, 1]) and seg[3, 0] == 6.0
    np.testing.assert_array_equal(
        seg.numpy(), np.asarray(rmamba._segsum(jnp.arange(4.0))))


def test_ssd_chunked_raises_on_a_partial_chunk():
    """The reference's reshape fails when the sequence is no whole number of
    chunks; the port raises there too, naming the shapes, and pads
    nothing."""
    x = torch.zeros((1, 40, 2, 4))
    with pytest.raises(ValueError, match="40 is not a multiple of the "
                                         "chunk 16"):
        mamba2.ssd_chunked(x, torch.zeros((1, 40, 2)), torch.zeros(2),
                           torch.zeros((1, 40, 3)), torch.zeros((1, 40, 3)),
                           16)
    with pytest.raises(TypeError):
        rmamba.ssd_chunked(jnp.zeros((1, 40, 2, 4)), jnp.zeros((1, 40, 2)),
                           jnp.zeros(2), jnp.zeros((1, 40, 3)),
                           jnp.zeros((1, 40, 3)), 16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_step_matches_reference(arch, dtype):
    """One token through mamba2_forward against a streaming state (bf16, as
    the cache holds it): the output and both new states, whose dtype
    follows the reference's promotion."""
    cfg, rcfg, tree, _, model = setup(arch, dtype)
    r = np.random.default_rng(3)
    u = r.normal(0, 1, (2, 1, cfg.d_model))
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    ssm = jnp.asarray(r.normal(0, 1, (2, cfg.ssm_heads, cfg.ssm_headdim,
                                      cfg.ssm_state)), jnp.bfloat16)
    conv = jnp.asarray(r.normal(0, 1, (2, cfg.ssm_conv - 1, conv_ch)),
                       jnp.bfloat16)
    jt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    uj = jnp.asarray(u, jt)
    want, (wssm, wconv) = rmamba.mamba2_forward(
        _mix(tree, cfg), uj, rcfg, jt, state=(ssm, conv))
    got, (gssm, gconv) = mamba2.mamba2_forward(
        _first_mix(model), to_torch(uj), cfg, lm._dtype(cfg),
        state=(to_torch(ssm), to_torch(conv)))
    logits_close(got, want, dtype)
    cache_close((gssm, gconv), (wssm, wconv))


# ---------------------------------------------------------------------------
# the serving path


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, dtype):
    """Logits, and the ssm's stacked (ssm, conv) states as the reference's
    prefill_fn returns them (none for the hybrid)."""
    cfg, rcfg, _, params, model = setup(arch, dtype)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (B, S),
                                             dtype=np.int32)
    bj, bt = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    want, wstate = jax.jit(lambda p, b: rlm.prefill_fn(p, b, rcfg, RT))(
        params, bj)
    got, state = lm.prefill_fn(model, bt, cfg)
    assert got.dtype == lm._dtype(cfg)
    logits_close(got, want, dtype)
    if cfg.family == "ssm":
        cache_close(state, wstate)
    else:
        assert state is None and wstate is None
    nxt = steps.make_prefill_step(cfg)(model, bt)
    np.testing.assert_array_equal(nxt.numpy()[:, 0],
                                  np.asarray(want, np.float32)[:, -1]
                                  .argmax(-1))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch, dtype):
    """Two decode steps from a filled cache: logits and every cache entry
    (KV written in place, SSM states new)."""
    cfg, rcfg, _, params, model = setup(arch, dtype)
    jc, tc = filled_cache(rcfg, 2, 24)
    r = np.random.default_rng(5)
    step = jax.jit(lambda p, c, b: rlm.decode_fn(p, c, b, rcfg, RT))
    for pos in ([3, 7], [4, 8]):
        tok = r.integers(0, cfg.vocab, (2, 1), dtype=np.int32)
        want, jc = step(params, jc, {"token": jnp.asarray(tok),
                                     "pos": jnp.asarray(pos, jnp.int32)})
        got, tc = lm.decode_fn(model, tc, {
            "token": torch.from_numpy(tok),
            "pos": torch.tensor(pos, dtype=torch.int32)}, cfg)
        logits_close(got, want, dtype)
    cache_close(tc, jc)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(arch, dtype):
    cfg, rcfg, _, params, model = setup(arch, dtype)
    prompts = np.random.default_rng(6).integers(0, cfg.vocab, (2, 8),
                                                dtype=np.int32)
    got = serve.generate(cfg, model, prompts, 6, 32)
    generate_matches(rcfg, params, got, prompts, 6, 32, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_states_are_float32_after_a_float32_decode_step(arch):
    """init_cache is bf16 whatever cfg.dtype; in a float32 config the
    recurrent update promotes, so after one decode step the SSM and conv
    states are float32 in both packages (new tensors: the bf16 cache is
    not written), while the hybrid's KV cache stays bf16."""
    cfg, rcfg, _, params, model = setup(arch, "float32")
    cache = lm.init_cache(cfg, 2, 16, CPU)
    jc = jax.tree.map(jnp.copy, rlm.init_cache(rcfg, 2, 16, RT))
    assert all(c.dtype == torch.bfloat16 for c in jax.tree.leaves(cache))
    m0 = cache if cfg.family == "ssm" else cache[0]
    batch = {"token": np.array([[5], [9]], np.int32),
             "pos": np.array([0, 3], np.int32)}
    _, jc = jax.jit(lambda p, c, b: rlm.decode_fn(p, c, b, rcfg, RT))(
        params, jc, jax.tree.map(jnp.asarray, batch))
    _, new = lm.decode_fn(model, cache, jax.tree.map(torch.from_numpy,
                                                     batch), cfg)
    m, jm = (new, jc) if cfg.family == "ssm" else (new[0], jc[0])
    for g, w in zip(m, jm):
        assert w.dtype == jnp.float32 and g.dtype == torch.float32
    assert all(torch.count_nonzero(t) == 0 for t in m0)
    assert all(torch.count_nonzero(t) > 0 for t in m)
    if cfg.family == "hybrid":
        assert all(t.dtype == torch.bfloat16 for t in new[1])
        assert all(w.dtype == jnp.bfloat16 for w in jc[1])
    cache_close(new, jc)


def test_hybrid_cache_k_and_v_are_separate():
    """The reference builds the hybrid KV cache as one zeros array twice;
    the port allocates two, so a decode step writes K and V apart."""
    cfg = dataclasses.replace(configs.get_smoke_config("zamba2-2.7b"),
                              dtype="float32")
    (ssm, conv), (K, V) = lm.init_cache(cfg, 2, 16, CPU)
    rk, rv = rlm.init_cache(rconfigs.get_smoke_config("zamba2-2.7b"), 2, 16,
                            RT)[1]
    assert rk is rv                       # the reference's aliasing
    assert K.data_ptr() != V.data_ptr()
    assert K.shape == V.shape == (cfg.n_layers // cfg.attn_every, 2, 16,
                                  cfg.n_kv_heads, cfg.hd)
    _, _, _, _, model = setup("zamba2-2.7b", "float32")
    _, (_, (K, V)) = lm.decode_fn(model, ((ssm, conv), (K, V)), {
        "token": torch.tensor([[5], [9]], dtype=torch.int32),
        "pos": torch.tensor([0, 3], dtype=torch.int32)}, cfg)
    assert not torch.equal(K[:, 0, 0], V[:, 0, 0])
    assert torch.count_nonzero(K[:, 1, 3]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch):
    cfg = configs.get_smoke_config(arch)
    got = lm.init_cache(cfg, 3, 20, CPU)
    want = rlm.init_cache(rconfigs.get_smoke_config(arch), 3, 20, RT)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, got)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, want))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16
        assert torch.count_nonzero(g) == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_smoke_on_cpu(arch, capsys):
    """mamba2-130m is serve.main's default arch, as in the reference."""
    argv = ["--device", "cpu", "--smoke", "--batch", "2", "--prompt-len",
            "5", "--gen", "4", "--cache-len", "16"]
    if arch != "mamba2-130m":
        argv += ["--arch", arch]
    toks = serve.main(argv)
    assert toks.shape == (2, 4)
    name = configs.get_smoke_config(arch).name
    assert capsys.readouterr().out.startswith(
        f"[serve] {name}: (2, 4) generated")
