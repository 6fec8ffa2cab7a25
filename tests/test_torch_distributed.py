"""The sharded LM on the CPU, held against the JAX reference and against the
port without a mesh: eight gloo ranks (``tests/_dist_worker.py``, which
imports no JAX) run ``Runtime.flash_decode`` on a (2, 4) mesh, the
expert-parallel MoE on (2, 2, 2) for both EP axes, the elastic checkpoint
restore from (4, 2) onto (2, 4), and prefill, decode and one train step
of each family's SMOKE arch on (2, 2) meshes from the reference's weights
(and qwen2-7b's with each of the runtime's ``seq_shard_decode``,
``seq_parallel`` and ``bf16_gather``); the reference's inputs and outputs
are computed here, its outputs while the ranks run, and handed over as
numpy. The spec rules are held against the reference's in this process.

Tolerances: float32 ``2e-4`` (of the largest entry for logits and
gradients); with ``bf16_gather`` the gradients reach the float32 masters
through a bf16 cast, so each entry also within one bf16 step of itself
(``2**-7`` relative: two arms whose float32 gradients differ in the last
places may round to neighbouring bf16 values)."""

import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro import configs as rconfigs
from repro.configs import base as rbase
from repro.distributed import sharding as rshd
from repro.launch import specs as rspecs
from repro.models import layers as rlayers
from repro.models import lm as rlm
from repro.models import moe as rmoe
from repro_torch import configs
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps
from repro_torch.models import lm

from _lm_ref import RT, setup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_dist_worker.py")
WORLD = 8
TOL = 2e-4
# a cache length the (2, 4) mesh's model axis does not divide
T_INDIVISIBLE = 62
BF16_STEP = 2.0 ** -7
# as tests/_dist_worker.py
FAMILY_ARCHS = ("qwen2-7b", "qwen2-vl-7b", "granite-moe-3b-a800m",
                "mamba2-130m", "zamba2-2.7b", "whisper-base")
LM_B, LM_S = 4, 32
OPTION_ARCH = "qwen2-7b"
OPTIONS = ("seq_shard_decode", "seq_parallel", "bf16_gather")


def _flash_decode_inputs():
    """The inputs of the reference's test_flash_decode_matches_plain_
    attention, and its ``_sdpa`` over the whole cache and over its first
    ``T_INDIVISIBLE`` positions."""
    rng = np.random.default_rng(1)
    B, T, H, kv, hd = 4, 64, 8, 2, 16
    q = rng.normal(0, 1, (B, 1, H, hd)).astype(np.float32)
    K = rng.normal(0, 1, (B, T, kv, hd)).astype(np.float32)
    V = rng.normal(0, 1, (B, T, kv, hd)).astype(np.float32)
    pos = np.asarray([5, 17, 33, 63], np.int32)
    want = {}
    for t in (T, T_INDIVISIBLE):
        mask = (jnp.arange(t)[None, :] <= pos[:, None])[:, None, None, :]
        want[t] = np.asarray(rlayers._sdpa(
            q, rlayers.repeat_kv(K[:, :t], H), rlayers.repeat_kv(V[:, :t], H),
            mask, jnp.float32))
    return {"q": q, "K": K, "V": V, "pos": pos,
            "T_indivisible": T_INDIVISIBLE}, want


def _moe_inputs():
    """test_moe_shard_map_matches_local's config (granite SMOKE, capacity
    factor 8.0: no drops), tokens and weights (``moe_init`` at the EP
    size 2 of either axis on (2, 2, 2)), and the reference's local
    ``moe_ffn`` of them with the gradients of sum(out * r)."""
    cfg = dataclasses.replace(rconfigs.get_smoke_config(
        "granite-moe-3b-a800m"), moe_capacity_factor=8.0)
    rng = np.random.default_rng(0)
    T, d = 16, cfg.d_model
    x = rng.normal(0, 1, (T, d)).astype(np.float32)
    r = rng.normal(0, 1, (T, d)).astype(np.float32)
    p = rmoe.moe_init(jax.random.PRNGKey(0), cfg, ep=2)

    def f(p, x):
        return jnp.sum(rmoe.moe_ffn(p, x, cfg, jnp.float32) * r)
    out = rmoe.moe_ffn(p, x, cfg, jnp.float32)
    gp, gx = jax.grad(f, argnums=(0, 1))(p, x)
    weights = {k: np.asarray(v) for k, v in p.items()}
    want = {"out": np.asarray(out), "x": np.asarray(gx),
            **{k: np.asarray(v) for k, v in gp.items()}}
    return {"x": x, "r": r, "weights": weights}, want


def _np_batch(b):
    """A reference batch as numpy, bf16 inputs as float32 beside their
    dtype's name."""
    return {k: (np.asarray(v, np.float32 if v.dtype == jnp.bfloat16
                           else v.dtype), str(v.dtype)) for k, v in b.items()}


def _lm_inputs(arch):
    """The reference's perturbed SMOKE weights in float32 (``_lm_ref.
    setup``), its prefill and train batches, and what computes its outputs
    from them."""
    cfg, rcfg, tree, params, _ = setup(arch, "float32")
    if rcfg.family == "moe":
        rcfg = dataclasses.replace(rcfg, moe_capacity_factor=8.0)
    pre, train = (rspecs.concrete_batch(rcfg, rbase.ShapeConfig(
        kind, LM_S, LM_B, kind), rng=0) for kind in ("prefill", "train"))
    inp = {"tree": tree, "prefill": _np_batch(pre),
           "train": _np_batch(train)}
    return inp, (cfg, rcfg, params, pre, train)


def _lm_reference(cfg, rcfg, params, pre, train, bf16_gather=False):
    """The reference's prefill logits, and its loss and gradients
    (unstacked to the port's names); with ``bf16_gather`` its
    ``launch/steps.py`` cast of the float32 masters of rank 2 or more to
    bf16 before the loss."""
    def cast(p):
        if not bf16_gather:
            return p
        return jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                            if x.ndim >= 2 and x.dtype == jnp.float32
                            else x, p)
    logits, _ = jax.jit(lambda p, b: rlm.prefill_fn(p, b, rcfg, RT))(
        params, pre)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: rlm.loss_fn(cast(p), train, rcfg, RT)))(params)
    return {"prefill": np.asarray(logits, np.float32), "loss": float(loss),
            "grads": lm.unstacked(jax.tree.map(np.asarray, grads), cfg)}


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    """One 8-rank gloo group running every case; rank 0's results, and the
    reference's outputs, computed while the ranks run."""
    work = str(tmp_path_factory.mktemp("dist"))
    fd, fd_want = _flash_decode_inputs()
    mo, mo_want = _moe_inputs()
    lm_inp, lm_ref = {}, {}
    for arch in FAMILY_ARCHS:
        lm_inp[arch], lm_ref[arch] = _lm_inputs(arch)
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump({"flash_decode": fd, "moe": mo, "lm": lm_inp}, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(WORLD),
                               work], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        lm_want = {arch: _lm_reference(*lm_ref[arch])
                   for arch in FAMILY_ARCHS}
        lm_want["bf16_gather"] = _lm_reference(*lm_ref[OPTION_ARCH],
                                               bf16_gather=True)
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    path = os.path.join(work, "results.pkl")
    assert os.path.exists(path), logs[0][-4000:]
    with open(path, "rb") as f:
        res = pickle.load(f)
    return {"res": res, "logs": logs, "rcs": [p.returncode for p in procs],
            "flash_decode_want": fd_want, "moe_want": mo_want,
            "lm_want": lm_want}


def _case(dist_run, name):
    got = dist_run["res"].get(name)
    assert got is not None, (name, dist_run["logs"][0][-3000:])
    assert "error" not in got, got["error"]
    return got


def test_every_rank_exits_cleanly(dist_run):
    assert dist_run["rcs"] == [0] * WORLD, dist_run["logs"][0][-3000:]


@pytest.mark.parametrize("case", ["plain", "seq_shard", "indivisible"])
def test_flash_decode_matches_plain_attention(dist_run, case):
    """Runtime.flash_decode on (2, 4) against the reference's _sdpa: the
    cache over the model axis (batch over data), with seq_shard_decode
    over both axes (batch whole), and at a length the model axis does not
    divide (the cache whole along it, as the drop rule leaves it)."""
    got = _case(dist_run, "flash_decode")[case]
    wants = dist_run["flash_decode_want"]
    want = wants[T_INDIVISIBLE] if case == "indivisible" else wants[64]
    np.testing.assert_allclose(got["out"], want, rtol=TOL, atol=TOL)
    want_pl = ["R", "R"] if case == "seq_shard" else ["S(0)", "R"]
    assert got["placements"] == want_pl


@pytest.mark.parametrize("ep", ["data", "model", "local"])
def test_moe_matches_the_reference_local_moe(dist_run, ep):
    """Runtime.moe_apply on (2, 2, 2) (tokens over pod and data) with
    moe_ep "data" (all-to-all dispatch, experts' d_ff over model), "model"
    (replicated-token EP) and moe_impl "local" (every expert on every
    rank): its output and the gradients of sum(out * r) for the tokens and
    every weight equal the reference's local moe_ffn (2e-4), and the
    port's local moe_ffn too."""
    got = _case(dist_run, "moe")[ep]
    want = dist_run["moe_want"]
    assert got["ep_size"] == (1 if ep == "local" else 2)
    for arm in ("mesh", "local"):
        np.testing.assert_allclose(got[arm]["out"], want["out"], rtol=TOL,
                                   atol=TOL)
        for name, g in got[arm]["grads"].items():
            np.testing.assert_allclose(
                g, want[name], rtol=TOL,
                atol=TOL * max(1.0, float(np.abs(want[name]).max())),
                err_msg=f"{arm} d/d{name}")


def test_spec_placements_follow_jax(dist_run):
    """A tuple of mesh dims on one tensor dim splits it data-major, as
    JAX's P(("data", "model")) does; out of mesh order it is refused; an
    axis that does not divide its dim is dropped."""
    got = _case(dist_run, "spec_rules")
    assert got["placements"] == ["S(0)", "S(0)"]
    assert got["rows_of_rank0"] == [0.0, 3.0]
    assert "mesh order" in got["out_of_order"]
    assert got["dropped"] == ["S(1)", "R"]


def test_elastic_restore_onto_another_mesh(dist_run):
    """Saved on (4, 2) as ("data", "model"), restored on (2, 4) as
    ("model", "data"): the values equal, the placements and the mesh the
    ones asked for."""
    got = _case(dist_run, "restore")
    assert got["step"] == 1
    np.testing.assert_array_equal(got["value"], got["want"])
    assert got["placements"] == got["want_placements"] == ["S(1)", "S(0)"]
    assert got["same_mesh"]
    assert got["local_shape"] == [2, 4]


def _close(got, want, what, rtol=TOL):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=TOL * scale,
                               err_msg=what)


def _loss_close(got, want):
    assert abs(got - want) <= TOL * abs(want), (got, want)


def _arms_agree(a, b, part, grad_rtol=TOL):
    """The mesh arm ``a`` against the plain arm ``b`` for one part."""
    if part == "prefill":
        _close(a["prefill"], b["prefill"], "prefill logits")
    elif part == "decode":
        _close(a["decode"], b["decode"], "decode logits")
        np.testing.assert_array_equal(a["decode_token"], b["decode_token"])
    else:
        _loss_close(a["loss"], b["loss"])
        assert set(a["grads"]) == set(b["grads"])
        for n, g in b["grads"].items():
            assert np.abs(g).max() > 0, n
            _close(a["grads"][n], g, f"d/d{n}", grad_rtol)
        for k, v in b["train_metrics"].items():
            assert abs(a["train_metrics"][k] - v) <= \
                grad_rtol * abs(v) + 1e-12, k
        assert a["placements_kept"] and b["placements_kept"]
        lr = b["train_metrics"]["lr"]
        for n, p in b["params"].items():
            np.testing.assert_allclose(a["params"][n], p, rtol=TOL,
                                       atol=TOL * np.abs(p).max() + 2 * lr,
                                       err_msg=n)


def _matches_reference(got, want, part, grad_rtol=TOL):
    """One arm against the reference's prefill logits, or its loss and
    every gradient."""
    if part == "prefill":
        _close(got["prefill"], want["prefill"], "prefill logits")
        return
    _loss_close(got["loss"], want["loss"])
    assert set(got["grads"]) == set(want["grads"])
    for n, g in want["grads"].items():
        _close(got["grads"][n], g, f"d/d{n}", grad_rtol)


@pytest.mark.parametrize("part", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_sharded_lm_matches_unsharded(dist_run, arch, part):
    """Each family's SMOKE arch in float32 on a (2, 2) mesh against the
    same model without one (2e-4 of the largest entry): the prefill's
    last logits; three decode steps' logits and a greedy step's tokens;
    the loss and every gradient of loss_and_grads, then make_train_step's
    metrics and updated parameters (plus 2 lr: AdamW's first step moves a
    weight by lr * sign(g), and a gradient near 0 may flip sign). Both
    arms train at remat "full"."""
    got = _case(dist_run, f"lm/{arch}")
    _arms_agree(got["mesh"], got["plain"], part)


@pytest.mark.parametrize("part", ["prefill", "train"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_sharded_lm_matches_the_reference(dist_run, arch, part):
    """The (2, 2) mesh arm against the JAX reference on the same weights
    and batches: its prefill logits, and its loss and every gradient."""
    got = _case(dist_run, f"lm/{arch}")["mesh"]
    _matches_reference(got, dist_run["lm_want"][arch], part)


@pytest.mark.parametrize("option", OPTIONS)
def test_sharded_lm_runtime_options(dist_run, option):
    """qwen2-7b on the (2, 2) mesh with each runtime option the model path
    branches on, against the same runtime without the mesh (and the
    reference where the option changes the numbers):

    - ``seq_shard_decode``: one request's decode cache split over both
      mesh axes (the batch of 1 whole); the decode logits and tokens;
    - ``seq_parallel``: the hidden states' sequence split over the TP
      axis between blocks; the prefill and the training;
    - ``bf16_gather``: the float32 masters cast to bf16 before the
      forward; the training, against the reference's own cast, which moves
      the loss away from the float32 one (each arm's loss nearer the cast
      reference's)."""
    got = _case(dist_run, f"lm/{OPTION_ARCH}/{option}")
    a, b = got["mesh"], got["plain"]
    if option == "seq_shard_decode":
        # K (L, B, T, kv, hd): the sequence over data then model
        assert a["cache_placements"] == ["S(2)", "S(2)"], \
            a["cache_placements"]
        _arms_agree(a, b, "decode")
    elif option == "seq_parallel":
        for part in ("prefill", "train"):
            _arms_agree(a, b, part)
    else:
        want = dist_run["lm_want"]["bf16_gather"]
        _arms_agree(a, b, "train", BF16_STEP)
        for arm in (a, b):
            _matches_reference(arm, want, "train", BF16_STEP)
        # the cast moves the loss well past the packages' float32 spread
        # (2e-6, tests/test_torch_train.py), and each arm lies nearer the
        # cast reference than the float32 one
        f32 = dist_run["lm_want"][OPTION_ARCH]["loss"]
        assert abs(want["loss"] - f32) > 10 * 2e-6 * abs(f32), \
            (want["loss"], f32)
        for arm in (a, b):
            assert abs(arm["loss"] - want["loss"]) < \
                abs(arm["loss"] - f32), (arm["loss"], want["loss"], f32)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_bf16_gather_casts_the_reference_leaves(arch):
    """bf16_gather casts exactly the parameters whose reference leaves the
    reference's make_train_step casts (float32, rank 2 or more stacked)."""
    _, _, tree, _, model = setup(arch, "float32")
    stacked = lm.unstacked(jax.tree.map(
        lambda x: np.full(x.shape, x.ndim >= 2 and x.dtype == np.float32),
        tree), model.cfg)
    want = {n for n, a in stacked.items() if a.all()}
    assert set(steps.bf16_casts(model)) == want
    assert all(t.dtype == torch.bfloat16
               for t in steps.bf16_casts(model).values())


# -- the spec rules, against the reference's --------------------------------

class _Key:
    def __init__(self, key):
        self.key = key


class _Leaf:
    def __init__(self, ndim):
        self.ndim = ndim


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_match_the_reference(arch):
    """Every parameter's spec equals the reference's for its stacked leaf
    with the stacked axes' leading Nones taken off."""
    cfg = configs.get_smoke_config(arch)
    model = lm.build(cfg, "meta")
    layout = lm.reference_layout(model)
    for name, p in model.named_parameters():
        leaf, rank = layout[name]
        path = [_Key(k) for k in leaf.split(".")]
        want = tuple(rshd.param_spec(path, _Leaf(rank), "data", "model"))
        extra = rank - p.dim()
        assert want[:extra] == (None,) * extra, (name, want)
        assert shd.param_spec(name, p.dim(), "data", "model") == \
            want[extra:], name


def _entry(e):
    """A spec entry as JAX keeps it: a one-name tuple is the name."""
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def _spec_tree(t):
    """A tree of specs (PartitionSpecs or the port's tuples) in one form."""
    if isinstance(t, PartitionSpec):
        return tuple(_entry(e) for e in t)
    if isinstance(t, dict):
        return {k: _spec_tree(v) for k, v in t.items()}
    if all(e is None or isinstance(e, str) or (
            isinstance(e, tuple) and all(isinstance(n, str) for n in e))
           for e in t):
        return tuple(_entry(e) for e in t)
    return tuple(_spec_tree(s) for s in t)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_batch_and_cache_specs_match_the_reference(arch):
    cfg = configs.get_smoke_config(arch)
    rcfg = rconfigs.get_smoke_config(arch)
    for axes in (("data",), ("pod", "data")):
        rt = shd.Runtime(batch_axes=axes)
        rrt = rshd.Runtime(batch_axes=axes)
        for kind in ("train", "prefill", "decode"):
            assert _spec_tree(shd.batch_specs(kind, cfg, rt)) == \
                _spec_tree(rshd.batch_specs(kind, rcfg, rrt)), kind
        for long in (False, True):
            assert _spec_tree(shd.cache_specs(cfg, rt, long)) == \
                _spec_tree(rshd.cache_specs(rcfg, rrt, long)), long
