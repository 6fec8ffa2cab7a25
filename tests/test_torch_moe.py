"""The port's moe family (``repro_torch.models.moe``, the ``moe`` blocks of
``models/lm.py``) against the JAX reference on the CPU, for granite-moe-3b
and phi3.5-moe at their ``SMOKE`` configs, with the reference's weights
carried across (``tests/_lm_ref.py``: biases, gains, ``D`` and the router
perturbed).

Routing is held exactly in float32: equal expert choices (``eidx``), per-
expert counts and drop masks, on inputs where the reference drops pairs.
In bf16 the router logits round to bf16 before the softmax, in XLA's and
torch's own order of accumulation; a choice may then flip where two
experts' bf16 probabilities tie or nearly tie. Those flips are counted,
each must sit on such a near-tie, and the outputs are held within the
bf16 tolerance; the token streams are held by ``_lm_ref.generate_matches``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import lm as rlm
from repro.models import moe as rmoe
from repro_torch import configs
from repro_torch.launch import serve, steps
from repro_torch.models import lm, moe

from _lm_ref import CPU, DTYPES, RT, cache_close, filled_cache, \
    generate_matches, logits_close, setup

ARCHS = ["granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b"]
B, S = 2, 48


def _tokens(cfg, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S),
                                                dtype=np.int32)


def _layer(tree, i):
    return {k: np.asarray(v[i]) for k, v in tree["layers"]["moe"].items()}


def _ref_routing(p, x, cfg):
    """The reference's routing and local dispatch (``moe.py`` ``moe_ffn``,
    ep = 1), its lines as they stand, stopped where the expert buffer is
    filled: (eidx, per-expert row counts, keep2 in sorted order)."""
    T, d = x.shape
    k = cfg.top_k
    dtype = x.dtype
    e_pad = p["router"].shape[1]
    ep, e_loc = 1, p["wi"].shape[0]
    logits = (x @ p["router"].astype(dtype)).astype(jnp.float32)
    emask = jnp.arange(e_pad) < cfg.n_experts
    logits = jnp.where(emask[None, :], logits, -jnp.inf)
    probs = jax.nn.softmax(logits, axis=-1)
    _, eidx = jax.lax.top_k(probs, k)
    flat_e = eidx.reshape(-1)
    dest = flat_e // e_loc
    order = jnp.argsort(dest, stable=True)
    dest_s = dest[order]
    counts = jnp.bincount(dest, length=ep)
    starts = jnp.concatenate([jnp.zeros(1, counts.dtype),
                              jnp.cumsum(counts)[:-1]])
    rank = jnp.arange(T * k) - starts[dest_s]
    c_send = int(np.ceil(T * k / ep * cfg.moe_capacity_factor))
    keep = rank < c_send
    slot = jnp.where(keep, dest_s * c_send + rank, 0).astype(jnp.int32)
    recv_e = jnp.full((ep * c_send,), -1, jnp.int32).at[slot].max(
        jnp.where(keep, flat_e[order], -1))
    R = ep * c_send
    valid = (recv_e >= 0) & (recv_e < e_loc)
    gkey = jnp.where(valid, recv_e, e_loc)
    order2 = jnp.argsort(gkey, stable=True)
    gkey_s = gkey[order2]
    counts2 = jnp.bincount(gkey, length=e_loc + 1)
    starts2 = jnp.concatenate([jnp.zeros(1, counts2.dtype),
                               jnp.cumsum(counts2)[:-1]])
    rank2 = jnp.arange(R) - starts2[gkey_s]
    c_loc = min(R, int(np.ceil(R / max(e_loc, 1)
                               * cfg.moe_capacity_factor)))
    keep2 = (rank2 < c_loc) & (gkey_s < e_loc)
    return (np.asarray(eidx), np.asarray(counts2), np.asarray(keep2),
            np.asarray(probs))


def _dropping_input(cfg, T=12, seed=11):
    """Router inputs (T, D) on which the reference drops pairs: tokens
    near one direction, so that most choose the same experts and overflow
    their capacity."""
    r = np.random.default_rng(seed)
    base = r.normal(0, 1, cfg.d_model)
    return (base + 0.3 * r.normal(0, 1, (T, cfg.d_model))).astype(
        np.float32)


def _c_loc(T, cfg):
    R = int(np.ceil(T * cfg.top_k * cfg.moe_capacity_factor))
    return min(R, int(np.ceil(R / cfg.n_experts * cfg.moe_capacity_factor)))


# ---------------------------------------------------------------------------
# parameters


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_round_trip(arch, dtype):
    """Every port parameter equals its slice of the reference tree, cast
    once to its dtype: the router and the experts are raw arrays."""
    cfg, _, tree, _, model = setup(arch, dtype)
    flat = dict(lm._flatten(tree))
    own = dict(model.named_parameters())
    assert len(own) == sum(np.asarray(a).shape[0] if n.startswith("layers.")
                           else 1 for n, a in flat.items())
    for name, p in own.items():
        parts = name.split(".")
        if parts[0] == "layers":
            want = flat[".".join([parts[0]] + parts[2:])][int(parts[1])]
        else:
            want = flat[name]
        norm = parts[-2].startswith("ln")
        assert p.dtype == (torch.float32 if norm else lm._dtype(cfg)), name
        assert torch.equal(p, torch.from_numpy(np.array(want)).to(p.dtype))
    e_pad = rmoe.padded_experts(cfg.n_experts, 1)
    assert moe.padded_experts(cfg.n_experts, 1) == e_pad
    assert tuple(model.layers[0].moe.router.shape) == (cfg.d_model, e_pad)
    assert not hasattr(model.layers[0], "mlp")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_tree(arch):
    """init_params gives the reference's names and shapes, and the experts
    and router at their scales (1/sqrt(D); 1/sqrt(F) for wo)."""
    cfg = configs.get_smoke_config(arch)
    rcfg = rconfigs.get_smoke_config(arch)
    shapes = jax.eval_shape(
        lambda: rlm.init_params(jax.random.PRNGKey(0), rcfg, RT))
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
    m = model.layers[1].moe
    for w, scale in ((m.router, cfg.d_model), (m.wi, cfg.d_model),
                     (m.wg, cfg.d_model), (m.wo, cfg.d_ff)):
        s = 1.0 / np.sqrt(scale)
        assert float(w.float().abs().max()) <= 2 * s * (1 + 1e-2)
        assert float(w.float().std()) > 0.5 * s
    assert moe.padded_experts(40, 16) == rmoe.padded_experts(40, 16) == 48


# ---------------------------------------------------------------------------
# routing


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_routing_and_drops_equal_reference_float32(arch):
    """On an input where the reference drops pairs: the port's expert
    choices, per-expert counts and drop masks equal the reference's, and
    so does moe_ffn's output."""
    cfg, rcfg, tree, _, model = setup(arch, "float32")
    p = _layer(tree, 0)
    x = _dropping_input(cfg)
    eidx, counts, keep2, _ = _ref_routing(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), rcfg)
    dropped = int(np.maximum(counts[:-1] - _c_loc(x.shape[0], cfg), 0).sum())
    assert dropped > 0, "the reference drops no pair on this input"
    assert int((~keep2).sum()) == dropped + counts[-1]
    xt = torch.from_numpy(x)
    _, geidx = moe.route(model.layers[0].moe, xt, cfg)
    plan = moe.dispatch(geidx, cfg, p["router"].shape[1])
    np.testing.assert_array_equal(geidx.numpy(), eidx)
    np.testing.assert_array_equal(plan.counts.numpy(), counts)
    np.testing.assert_array_equal(plan.keep2.numpy(), keep2)
    assert plan.c_loc == _c_loc(x.shape[0], cfg)
    want = rmoe.moe_ffn({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), rcfg, jnp.float32)
    got = moe.moe_ffn(model.layers[0].moe, xt, cfg)
    logits_close(got, want, "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_bfloat16_flips_sit_on_ties(arch):
    """bf16 routing of the prefill's first layer input: every (token,
    expert) choice that differs from the reference's sits where the two
    experts' reference probabilities are within a bf16 rounding of each
    other; the outputs agree within the bf16 tolerance."""
    cfg, rcfg, tree, _, model = setup(arch, "bfloat16")
    p = {k: jnp.asarray(v) for k, v in _layer(tree, 0).items()}
    x = np.random.default_rng(12).normal(0, 1, (B * S, cfg.d_model))
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16)
    eidx, _, _, probs = _ref_routing(p, xj, rcfg)
    _, geidx = moe.route(model.layers[0].moe, xt, cfg)
    geidx = geidx.numpy()
    flips = 0
    for t in range(len(x)):
        a, b = set(eidx[t]), set(geidx[t])
        for e_ref, e_got in zip(sorted(a - b), sorted(b - a)):
            flips += 1
            gap = abs(probs[t, e_ref] - probs[t, e_got])
            assert gap <= 2 ** -7 * probs[t, e_ref], (t, e_ref, e_got, gap)
    print(f"{arch}: {flips} flipped (token, expert) choices of "
          f"{eidx.size}")
    want = rmoe.moe_ffn(p, xj, rcfg, jnp.bfloat16)
    got = moe.moe_ffn(model.layers[0].moe, xt, cfg)
    logits_close(got, want, "bfloat16")


def test_top_k_ties_take_the_lower_expert_first():
    """Equal probabilities: the port takes the experts jax.lax.top_k takes,
    in its order (the lower index first)."""
    cfg = dataclasses.replace(configs.get_smoke_config(ARCHS[0]),
                              dtype="float32")
    m = moe.MoE(cfg, dtype=torch.float32, device=CPU)
    col = np.random.default_rng(3).normal(0, 1, cfg.d_model)
    router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    for e in (1, 4, 6):                 # three equal experts, k = 2
        router[:, e] = col
    router[:, 2] = 0.5 * col
    with torch.no_grad():
        m.router.copy_(torch.from_numpy(router))
    x = np.abs(np.random.default_rng(4).normal(0, 1, (5, cfg.d_model))) \
        * np.sign(col)
    x = x.astype(np.float32)
    gates, eidx = moe.route(m, torch.from_numpy(x), cfg)
    probs = jax.nn.softmax(jnp.asarray(x @ router), axis=-1)
    g_ref, e_ref = jax.lax.top_k(probs, cfg.top_k)
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(e_ref))
    assert (eidx.numpy() == [1, 4]).all()
    np.testing.assert_allclose(gates.numpy(), np.asarray(
        g_ref / g_ref.sum(-1, keepdims=True)), rtol=1e-6)


# ---------------------------------------------------------------------------
# the serving path


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, dtype):
    cfg, rcfg, _, params, model = setup(arch, dtype)
    toks = _tokens(cfg)
    bj, bt = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    want, _ = jax.jit(lambda p, b: rlm.prefill_fn(p, b, rcfg, RT))(params, bj)
    got, state = lm.prefill_fn(model, bt, cfg)
    assert state is None and got.dtype == lm._dtype(cfg)
    logits_close(got, want, dtype)
    nxt = steps.make_prefill_step(cfg)(model, bt)
    np.testing.assert_array_equal(nxt.numpy()[:, 0],
                                  np.asarray(want, np.float32)[:, -1]
                                  .argmax(-1))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch, dtype):
    """Two decode steps from a filled cache: logits and every cache entry.
    A step routes B = 2 tokens, so granite's c_loc is 1 and an expert both
    tokens choose drops a pair."""
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
def test_serve_main_smoke_on_cpu(arch, capsys):
    toks = serve.main(["--device", "cpu", "--arch", arch, "--smoke",
                       "--batch", "2", "--prompt-len", "5", "--gen", "4",
                       "--cache-len", "16"])
    assert toks.shape == (2, 4)
    name = configs.get_smoke_config(arch).name
    assert capsys.readouterr().out.startswith(
        f"[serve] {name}: (2, 4) generated")
