"""Compute the JAX reference's full-width LM pins that ``chip_smoke.py``
holds the PyTorch port to (its ``LM_PINS``).

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tools/lm_pins.py [NAME ...]
        [--port]

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
zamba2-2.7b cut to one group (S 2048 for the last three); and per
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
from repro.launch.steps import make_prefill_step, make_train_step  # noqa
from repro.models import lm  # noqa: E402
from repro.optim import adamw  # noqa: E402

RT = Runtime(mesh=None, remat="none")


def prefill_pin(params, cfg, batch):
    """Next tokens and the last position's top-5; for a moe model also its
    first layer's routing counts, from the expert choices the reference's
    ``jax.lax.top_k`` returns inside ``moe_ffn`` while ``prefill_fn``
    runs."""
    seen = []
    top_k = jax.lax.top_k

    def recording(x, k):
        vals, idx = top_k(x, k)
        jax.debug.callback(lambda i: seen.append(np.asarray(i)), idx,
                           ordered=True)
        return vals, idx
    if cfg.family == "moe":
        jax.lax.top_k = recording
    try:
        logits, _ = jax.jit(lambda p, b: lm.prefill_fn(p, b, cfg, RT))(
            params, batch)
        logits = np.asarray(logits, np.float32)
    finally:
        jax.lax.top_k = top_k
    nxt = jax.jit(make_prefill_step(cfg, RT))(params, batch)
    last = logits[:, -1]
    ids = np.argsort(-last, axis=-1, kind="stable")[:, :5]
    out = {"next": np.asarray(nxt)[:, 0].tolist(),
           "top5_ids": ids.tolist(),
           "top5_vals": np.take_along_axis(last, ids, -1).tolist()}
    if cfg.family == "moe":
        assert len(seen) == cfg.n_layers, len(seen)
        rc = cs.routing_counts(seen[0], cfg)
        out.update(counts=rc["counts"], dropped=rc["dropped"])
    return out


def generate(cfg, params, prompts):
    init = lm.init_cache

    def distinct(*a, **k):
        return jax.tree.map(jnp.copy, init(*a, **k))
    serve.lm.init_cache = distinct
    try:
        return serve.generate(cfg, RT, params, prompts, cs.LM_GEN,
                              cs.LM_CACHE)
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


def main(names=None) -> None:
    port = "--port" in (names or [])
    names = [n for n in names or [] if n != "--port"] or list(cs.LM_PIN_ARCH)
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
            params = jax.tree.map(jnp.asarray, cs.reference_tree(cfg, 0))
        inputs = cs.lm_pin_inputs(cfg, name)
        if name.endswith("generate"):
            pins[name] = {"tokens": generate(cfg, params,
                                             inputs["tokens"]).tolist()}
        else:
            pins[name] = prefill_pin(params, cfg, {
                k: jnp.asarray(v) for k, v in inputs.items()})
        print(f"# {name}: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    print(json.dumps(pins))
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    print(f"# {time.perf_counter() - t0:.1f} s, peak RSS {peak:.1f} GB",
          file=sys.stderr)


if __name__ == "__main__":
    main(sys.argv[1:])
