"""Shared helpers of the LM port tests (``tests/test_torch_lm.py``,
``test_torch_vlm.py``, ``test_torch_moe.py``, ``test_torch_mamba2.py``):
the reference's parameters carried across to the port, perturbed so that
every add and scale of the path is exercised, and the tolerances.

Tolerances: in float32 (``dataclasses.replace(cfg, dtype="float32")``)
logits to ``rtol 1e-4`` and tokens equal; in the configured bf16 logits
within ``2e-2`` of the largest logit (bf16 activations round at other
places in XLA and torch).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as rconfigs
from repro.distributed.sharding import Runtime
from repro.models import lm as rlm
from repro_torch import configs
from repro_torch.models import lm

RT = Runtime(mesh=None, remat="none")
DTYPES = ["float32", "bfloat16"]
CPU = torch.device("cpu")

# leaves the reference initialises to zeros (shifted) or ones (scaled)
_ZERO_INIT = ("b", "bq", "bk", "bv", "conv_b", "dt_bias", "A_log")
_ONE_INIT = ("g", "D", "router")


def perturb(tree, seed=1):
    """Nonzero biases, ``conv_b``, ``dt_bias`` and shifted ``A_log``;
    non-unit norm gains and ``D``; a router scaled per entry: every add and
    scale of the path is exercised."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        x = np.array(x, np.float32)
        key = path[-1].key
        if key in _ZERO_INIT:
            x = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        elif key in _ONE_INIT:
            x = x * (1 + 0.1 * rng.standard_normal(x.shape)
                     .astype(np.float32))
        return x
    return jax.tree_util.tree_map_with_path(f, tree)


_CACHE = {}


def setup(arch, dtype):
    """(cfg, reference cfg, numpy tree, reference params (jax), port model)
    for one arch's SMOKE config in one dtype."""
    key = (arch, dtype)
    if key not in _CACHE:
        cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype)
        rcfg = dataclasses.replace(rconfigs.get_smoke_config(arch),
                                   dtype=dtype)
        tree = perturb(jax.tree.map(
            np.asarray, rlm.init_params(jax.random.PRNGKey(0), rcfg, RT)))
        _CACHE[key] = (cfg, rcfg, tree, jax.tree.map(jnp.asarray, tree),
                       lm.params_from_reference(tree, cfg, CPU))
    return _CACHE[key]


def logits_close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def to_torch(x):
    """A JAX or numpy array as a torch tensor of the same dtype (bf16 kept
    bf16)."""
    a = jnp.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def cache_close(got, want):
    """Each leaf of the port's cache has the reference's dtype and values
    (bf16 leaves within 2e-2, float32 leaves within 1e-4 of their
    largest entry)."""
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), (g.dtype,
                                                             w.dtype)
        wf = np.asarray(w, np.float32)
        tol = 1e-4 if w.dtype == jnp.float32 else 2e-2
        np.testing.assert_allclose(g.float().numpy(), wf, rtol=tol,
                                   atol=tol * max(np.abs(wf).max(), 1.0))


def filled_cache(rcfg, B, T, seed=4):
    """The reference's zeroed cache filled with seeded bf16 normals, and
    the same values as the port's cache (K and V two tensors)."""
    r = np.random.default_rng(seed)
    jc = rlm.init_cache(rcfg, B, T, RT)
    fill = jax.tree.map(lambda c: jnp.asarray(
        r.normal(0, 1, c.shape), jnp.bfloat16), jc)

    def tup(x):
        return tuple(tup(v) for v in x) if isinstance(x, (tuple, list)) \
            else to_torch(x)
    return fill, tup(fill)


def ref_generate(rcfg, params, prompts, gen, cache_len):
    """The reference's ``serve.generate``. Its hybrid cache holds one
    zeros array as both K and V (``(zeros,) * 2``), which its jitted step
    donates twice and XLA refuses; the cache is handed over with every
    leaf its own copy, the same values."""
    from repro.launch import serve as rserve
    init = rlm.init_cache

    def distinct(*a, **k):
        return jax.tree.map(jnp.copy, init(*a, **k))
    rserve.lm.init_cache = distinct
    try:
        return rserve.generate(rcfg, RT, params, prompts, gen, cache_len)
    finally:
        rserve.lm.init_cache = init


def ref_last_logits(rcfg, params, tokens, cache_len):
    """The reference's decode logits (B, V) after consuming ``tokens`` (B,
    n) one at a time through its decode step, as ``generate`` does (a vlm
    step at positions (t, t, t))."""
    B, n = tokens.shape
    cache = jax.tree.map(jnp.copy, rlm.init_cache(rcfg, B, cache_len, RT))
    step = jax.jit(lambda p, c, b: rlm.decode_fn(p, c, b, rcfg, RT))
    for t in range(n):
        batch = {"token": jnp.asarray(tokens[:, t:t + 1]),
                 "pos": jnp.full((B,), t, jnp.int32)}
        if rcfg.family == "vlm":
            batch["positions3d"] = jnp.full((3, B, 1), t, jnp.int32)
        logits, cache = step(params, cache, batch)
    return np.asarray(logits, np.float32)[:, 0]


def generate_matches(rcfg, params, got, prompts, gen, cache_len, dtype):
    """The port's generated tokens ``got`` against the reference's: equal
    in float32. In bf16 equal up to the first step where a row's token
    differs, and there the reference's own logit of the port's token must
    be within the bf16 tolerance (2e-2 of the largest logit) of its best:
    a tie that bf16 logits break either way. Rows are not held apart after
    that step (a moe batch's rows share the experts' capacity). Returns
    the first differing step (``gen`` if none)."""
    want = ref_generate(rcfg, params, prompts, gen, cache_len)
    assert got.shape == want.shape == (prompts.shape[0], gen)
    if dtype == "float32" or np.array_equal(got, want):
        np.testing.assert_array_equal(got, want)
        return gen
    s = int(np.flatnonzero((got != want).any(0))[0])
    seq = np.concatenate([prompts, want[:, :s]], axis=1)
    logits = ref_last_logits(rcfg, params, seq, cache_len)
    best = logits.max(-1)
    mine = logits[np.arange(len(got)), got[:, s]]
    tol = 2e-2 * np.abs(logits).max()
    assert np.all(best - mine <= tol), (s, best, mine, tol)
    return s
