"""Compute the JAX reference's full-width LM pins that ``chip_smoke.py``
holds the PyTorch port to (its ``LM_PINS``).

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tools/lm_pins.py [NAME ...]
        [--port] [--dtype bfloat16]

Runs the reference on the CPU, in float32, for every pin of
``chip_smoke.LM_PIN_ARCH`` (or the names given), each configuration from
``chip_smoke.lm_pin_cfg``: qwen2-7b at full width cut to two layers
(``make_prefill_step`` / ``prefill_fn`` on prompts of 2048 tokens, the
``_sdpa_chunked`` branch, and of 100 tokens, the ``_sdpa`` branch);
whisper-base whole (``prefill_fn`` on 1500 encoder frames and 64 decoder
tokens); qwen2-vl-7b cut to two layers (256 vision tokens on a 16 x 16
grid and 768 text tokens); granite-moe-3b cut to two layers, with its
first layer's per-expert counts and dropped pairs (the expert choices read
from the reference's own ``top_k`` while it runs); mamba2-130m whole;
zamba2-2.7b cut to one group (S 2048 for the last three); gemma-7b,
deepseek-7b, command-r-35b and phi3.5-moe (its counts too) cut to two
layers, S 2048; and per
configuration ``generate`` with 16-token prompts, 8 new tokens, a 64-slot
cache. The reference's hybrid cache holds one array as both K and V, which
its jitted step donates twice and XLA refuses, so the hybrid's generate
gets each cache leaf as its own copy (the same values). Weights are
``chip_smoke.reference_tree(cfg, 0)``, inputs ``chip_smoke.lm_pin_inputs``.
Prints one JSON object: per pin the next tokens, the last position's top-5
logit ids and values, the generated tokens, and the moe counts. Wall time
and peak host memory go to stderr: 156.7 s and 12.9 GB peak RSS for all
twelve pins in one CPU run, the peak at the two-layer qwen2 trees in
numpy and in JAX.

The training pins (``chip_smoke.LM_TRAIN_PINS``, run only when named:
``train``, ``train_chunked``) run the reference's ``make_train_step``
(jitted, parameters and state donated, as its trainer runs it) on
deepseek-7b at full width cut to two layers, float32, for
``TRAIN_PIN_STEPS`` steps on ``chip_smoke.train_pin_batches``, and pin
each step's loss, grad norm and learning rate, and print the batches'
digest (``TRAIN_BATCH_SHA256``). With ``--port`` the port's
``make_train_step`` runs the same steps on the CPU from the same tree
afterwards and its numbers are printed beside the pins (stderr): the gap
of two float32 implementations that differ only in summation order.

With ``--dtype bfloat16`` every named pin runs twice on the same tree and
inputs, in float32 and in the reference's configured bf16, and both are
printed: the float32 pin under its name (it must equal ``LM_PINS``' where
that has one; a mismatch goes to stderr) and the bf16 pin under
``<name>_bf16``, which adds ``ref_err``, the largest |bf16 - float32| of
the reference's own last-position logits at the float32 pin's top-5 ids,
and ``margin``, each row's top-1 minus top-2 bf16 logit. A generate pin's
``margin`` is each row's per step (B, steps) and its ``ref_err`` the
largest over the steps, both from the reference's decode step (the logits
``generate`` takes its argmax of; ``prefill_fn`` over the prompt and the
tokens so far cannot run the ssm and hybrid families below one scan chunk
of 128), the float32 run fed the bf16 run's tokens. A moe prefill's bf16
pin adds ``router_err``, the largest |bf16 - float32| of its first
layer's router probabilities, and ``near_ties``, the (token, expert)
choices of the bf16 run whose probability lies within ``BF16_PIN_FACTOR x
router_err`` of the token's (k+1)-th expert's. The trees go to JAX
without a copy (``jax.dlpack``): command-r-35b's two-layer tree is 22.4
GB of float32. On an 8-core CPU the 18 names but command-r's took 932.1 s
and 21.7 GB peak RSS, and ``command_r command_r_generate`` 236.1 s and
36.3 GB; the twelve float32 pins of ``LM_PINS`` came out unchanged.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tools/lm_pins.py \\
        --dtype bfloat16 [NAME ...]
"""

from __future__ import annotations

import json
import resource
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from repro import configs  # noqa: E402
from repro.distributed.sharding import Runtime  # noqa: E402
from repro.launch import serve  # noqa: E402
from repro.launch.steps import make_train_step  # noqa: E402
from repro.models import lm  # noqa: E402
from repro.optim import adamw  # noqa: E402

RT = Runtime(mesh=None, remat="none")
# XLA options of the prefill and decode jits here (None: XLA's defaults,
# which computed LM_PINS); the CPU tests of the bf16 rule compile at
# optimization level 0, about 2.4x faster to compile at SMOKE widths
JIT_OPTIONS = None


def to_jax(tree):
    """The numpy tree as JAX arrays that alias its buffers (no copy)."""
    def one(a):
        try:
            return jax.dlpack.from_dlpack(a)
        except (TypeError, ValueError, RuntimeError):
            return jnp.asarray(a)
    return jax.tree.map(one, tree)


def top5_ids(last):
    """Each row's five largest logits' ids, largest first (a tie to the
    lower id), of ``last`` (B, V) float32."""
    return np.argsort(-last, axis=-1, kind="stable")[:, :5]


def ref_err(f32_last, bf16_last, ids) -> float:
    """The largest |bf16 - float32| of last-position logits (B, V) at the
    float32 pin's top-5 ids (B, 5): the reference's own bf16 error."""
    ids = np.asarray(ids)
    return float(np.abs(np.take_along_axis(bf16_last, ids, -1)
                        - np.take_along_axis(f32_last, ids, -1)).max())


def margins(last) -> list:
    """Each row's top-1 minus top-2 logit of ``last`` (..., V)."""
    s = np.partition(last, -2, axis=-1)
    return (s[..., -1] - s[..., -2]).tolist()


def near_ties(probs, k: int, tol: float) -> int:
    """The (token, expert) choices of router probabilities ``probs`` (T,
    E) whose probability lies within ``tol`` of the token's (k+1)-th
    largest: the choices a rounding of ``tol`` could flip."""
    s = -np.sort(-probs, axis=-1)
    return int((s[:, :k] - s[:, k:k + 1] <= tol).sum())


def prefill_pin(params, cfg, batch):
    """Next tokens (``make_prefill_step``'s argmax of ``prefill_fn``'s
    logits, in the same jit as the logits) and the last position's top-5;
    for a moe model also its
    first layer's routing counts, from the expert choices the reference's
    ``jax.lax.top_k`` returns inside ``moe_ffn`` while ``prefill_fn``
    runs. Returns the pin, the last position's logits (B, V) float32 and
    the first moe layer's router probabilities (T, E) (None but for a moe
    model)."""
    seen = []
    top_k = jax.lax.top_k

    def recording(x, k):
        vals, idx = top_k(x, k)
        jax.debug.callback(lambda p, i: seen.append(
            (np.asarray(p, np.float32), np.asarray(i))), x, idx,
            ordered=True)
        return vals, idx
    if cfg.family == "moe":
        jax.lax.top_k = recording
    def both(p, b):
        logits, _ = lm.prefill_fn(p, b, cfg, RT)
        return logits, jnp.argmax(logits, axis=-1)
    try:
        logits, nxt = jax.jit(both, compiler_options=JIT_OPTIONS)(params,
                                                                  batch)
        logits = np.asarray(logits, np.float32)
    finally:
        jax.lax.top_k = top_k
    last = logits[:, -1]
    ids = top5_ids(last)
    out = {"next": np.asarray(nxt)[:, 0].tolist(),
           "top5_ids": ids.tolist(),
           "top5_vals": np.take_along_axis(last, ids, -1).tolist()}
    probs = None
    if cfg.family == "moe":
        assert len(seen) == cfg.n_layers, len(seen)
        probs = seen[0][0]
        rc = cs.routing_counts(seen[0][1], cfg)
        out.update(counts=rc["counts"], dropped=rc["dropped"])
    return out, last, probs


def bf16_prefill_pin(f32, bf16, cfg):
    """The bf16 pin from ``prefill_pin``'s results in float32 and in bf16
    on the same tree and batch: the bf16 run's pin with ``ref_err`` and
    ``margin``, and for a moe model ``router_err`` and ``near_ties``."""
    pin, last, probs = bf16
    pin = dict(pin, ref_err=ref_err(f32[1], last, f32[0]["top5_ids"]),
               margin=margins(last))
    if probs is not None:
        err = float(np.abs(probs - f32[2]).max())
        pin.update(router_err=err, near_ties=near_ties(
            probs, cfg.top_k, cs.BF16_PIN_FACTOR * err))
    return pin


def decode_trace(cfg, params, prompts, gen: int, cache_len: int,
                 force=None):
    """The reference's greedy decode as ``serve.generate`` runs it (the
    prompt consumed token by token through ``decode_fn``): the tokens (B,
    gen) and each generated step's logits (B, gen, V) float32. ``force``
    (B, gen) feeds its tokens back instead of the argmax."""
    B, P = prompts.shape
    cache = jax.tree.map(jnp.copy, lm.init_cache(cfg, B, cache_len, RT))
    step = jax.jit(lambda p, c, b: lm.decode_fn(p, c, b, cfg, RT),
                   compiler_options=JIT_OPTIONS)
    tok, toks, logits = prompts[:, :1], [], []
    for t in range(P + gen - 1):
        batch = {"token": jnp.asarray(tok, jnp.int32),
                 "pos": jnp.full((B,), t, jnp.int32)}
        if cfg.family == "vlm":
            batch["positions3d"] = jnp.full((3, B, 1), t, jnp.int32)
        lg, cache = step(params, cache, batch)
        if t + 1 < P:
            tok = prompts[:, t + 1:t + 2]
            continue
        lg = np.asarray(lg, np.float32)[:, 0]
        logits.append(lg)
        toks.append(np.argmax(lg, axis=-1))
        tok = (force[:, len(toks) - 1] if force is not None
               else toks[-1])[:, None]
    return np.stack(toks, 1).astype(np.int32), np.stack(logits, 1)


def bf16_generate_pin(cfg32, cfg16, params, prompts, gen=None,
                      cache_len=None):
    """The bf16 generate pin: ``generate``'s tokens in bf16, each step's
    margin (B, steps) and ``ref_err``, the largest over the steps of the
    decode logits' |bf16 - float32| at the float32 run's top-5 ids, the
    float32 run fed the bf16 tokens."""
    gen, cache_len = gen or cs.LM_GEN, cache_len or cs.LM_CACHE
    tokens = generate(cfg16, params, prompts, gen, cache_len)
    toks, lg16 = decode_trace(cfg16, params, prompts, gen, cache_len)
    assert np.array_equal(toks, tokens), (toks, tokens)
    _, lg32 = decode_trace(cfg32, params, prompts, gen, cache_len,
                           force=toks)
    err = max(ref_err(lg32[:, t], lg16[:, t], top5_ids(lg32[:, t]))
              for t in range(lg16.shape[1]))
    return {"tokens": tokens.tolist(), "margin": margins(lg16),
            "ref_err": err}


def generate(cfg, params, prompts, gen=None, cache_len=None):
    """The reference's ``serve.generate`` (``LM_GEN`` tokens against an
    ``LM_CACHE``-slot cache unless given), each cache leaf its own copy:
    the hybrid's one array as both K and V would be donated twice."""
    init = lm.init_cache

    def distinct(*a, **k):
        return jax.tree.map(jnp.copy, init(*a, **k))
    serve.lm.init_cache = distinct
    try:
        return serve.generate(cfg, RT, params, prompts,
                              gen or cs.LM_GEN, cache_len or cs.LM_CACHE)
    finally:
        serve.lm.init_cache = init


def train_pin(name):
    """Each step's loss, grad norm and lr of the reference's train step;
    the parameter tree is drawn for the pin and donated to the steps."""
    cfg = cs.lm_pin_cfg(configs, cs.TRAIN_PIN_ARCH)
    rt = Runtime(mesh=None, remat="none", loss_chunk=cs.LM_TRAIN_PINS[name])
    opt = adamw.AdamWConfig(**cs.TRAIN_PIN_OPT)
    params = jax.tree.map(jnp.asarray, cs.reference_tree(cfg, 0))
    state = adamw.init_state(params, opt)
    step = jax.jit(make_train_step(cfg, rt, opt), donate_argnums=(0, 1))
    out = {"loss": [], "grad_norm": [], "lr": []}
    for b in cs.train_pin_batches(cfg.vocab):
        params, state, m = step(params, state,
                                {k: jnp.asarray(v) for k, v in b.items()})
        for k in out:
            out[k].append(float(m[k]))
    return out


def main(argv=None) -> None:
    argv = list(argv or [])
    port = "--port" in argv
    bf16 = False
    if "--dtype" in argv:
        i = argv.index("--dtype")
        assert argv[i + 1] in ("float32", "bfloat16"), argv[i + 1]
        bf16 = argv[i + 1] == "bfloat16"
        del argv[i:i + 2]
    names = [n for n in argv if n != "--port"] or list(cs.LM_PIN_ARCH)
    pins = {}
    t0 = time.perf_counter()
    if any(n in cs.LM_TRAIN_PINS for n in names):
        from repro.data.tokens import SyntheticTokens
        vocab = cs.lm_pin_cfg(configs, cs.TRAIN_PIN_ARCH).vocab
        print(f"# TRAIN_BATCH_SHA256 = "
              f"{cs.train_batch_digests(vocab, SyntheticTokens)} (numpy "
              f"{np.__version__})", file=sys.stderr)
    for name in names:
        if name in cs.LM_TRAIN_PINS:
            pins[name] = train_pin(name)
            print(f"# {name}: {time.perf_counter() - t0:.1f} s",
                  file=sys.stderr)
            if port:
                import torch
                tree = cs.reference_tree(
                    cs.lm_pin_cfg(configs, cs.TRAIN_PIN_ARCH), 0)
                got, _ = cs.train_pin_run(torch, torch.device("cpu"),
                                          "torch", name, tree)
                del tree
                gap = {k: [abs(a - b) / abs(b) for a, b in
                           zip(got[k], pins[name][k])] for k in got}
                print(f"# {name} port {json.dumps(got)} rel gap "
                      f"{json.dumps(gap)}", file=sys.stderr)
    arch = params = None
    for name in [n for n in names if n not in cs.LM_TRAIN_PINS]:
        if cs.LM_PIN_ARCH[name] != arch:
            arch, params = cs.LM_PIN_ARCH[name], None
            cfg = cs.lm_pin_cfg(configs, arch)
            cfg16 = cs.lm_pin_cfg(configs, arch, "bfloat16")
            params = to_jax(cs.reference_tree(cfg, 0))
        inputs = cs.lm_pin_inputs(cfg, name)
        if name.endswith("generate"):
            pins[name] = {"tokens": generate(cfg, params,
                                             inputs["tokens"]).tolist()}
            if bf16:
                pins[f"{name}_bf16"] = bf16_generate_pin(
                    cfg, cfg16, params, inputs["tokens"])
        else:
            batch = {k: jnp.asarray(v) for k, v in inputs.items()}
            f32 = prefill_pin(params, cfg, batch)
            pins[name] = f32[0]
            if bf16:
                pins[f"{name}_bf16"] = bf16_prefill_pin(
                    f32, prefill_pin(params, cfg16, batch), cfg16)
        if name in cs.LM_PINS and pins[name] != cs.LM_PINS[name]:
            print(f"# {name}: the float32 pin differs from LM_PINS'",
                  file=sys.stderr)
        print(f"# {name}: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    print(json.dumps(pins))
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    print(f"# {time.perf_counter() - t0:.1f} s, peak RSS {peak:.1f} GB",
          file=sys.stderr)


if __name__ == "__main__":
    main(sys.argv[1:])
