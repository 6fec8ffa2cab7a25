"""Compute the JAX reference's full-width LM pins that ``chip_smoke.py``
holds the PyTorch port to (its ``LM_PINS``).

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tools/lm_pins.py

Runs the reference on the CPU, in float32: qwen2-7b at full width cut to
two layers (``make_prefill_step`` / ``prefill_fn`` on prompts of 2048
tokens, the ``_sdpa_chunked`` branch, and of 100 tokens, the ``_sdpa``
branch; ``generate`` with 16-token prompts, 8 new tokens, a 64-slot cache)
and whisper-base whole (``prefill_fn`` on 1500 encoder frames and 64
decoder tokens). Weights are ``chip_smoke.reference_tree(cfg, 0)``, inputs
``chip_smoke.lm_pin_inputs``. Prints one JSON object: per pin the next
tokens, the last position's top-5 logit ids and values, and the generated
tokens. About 13 GB of host memory at its peak (the two-layer qwen2 tree
in numpy and in JAX).
"""

from __future__ import annotations

import json
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
from repro.launch.serve import generate  # noqa: E402
from repro.launch.steps import make_prefill_step  # noqa: E402
from repro.models import lm  # noqa: E402

RT = Runtime(mesh=None, remat="none")


def prefill_pin(params, cfg, batch):
    logits, _ = jax.jit(lambda p, b: lm.prefill_fn(p, b, cfg, RT))(params,
                                                                  batch)
    nxt = jax.jit(make_prefill_step(cfg, RT))(params, batch)
    last = np.asarray(logits, np.float32)[:, -1]
    ids = np.argsort(-last, axis=-1, kind="stable")[:, :5]
    return {"next": np.asarray(nxt)[:, 0].tolist(),
            "top5_ids": ids.tolist(),
            "top5_vals": np.take_along_axis(last, ids, -1).tolist()}


def main() -> None:
    pins = {}
    t0 = time.perf_counter()
    cfg = cs.lm_pin_cfg(configs, "qwen2-7b")
    params = jax.tree.map(jnp.asarray, cs.reference_tree(cfg, 0))
    for name in ("S2048", "S100"):
        batch = {"tokens": jnp.asarray(cs.lm_pin_inputs(cfg, name)["tokens"])}
        pins[name] = prefill_pin(params, cfg, batch)
    prompts = cs.lm_pin_inputs(cfg, "generate")["tokens"]
    pins["generate"] = {"tokens": generate(cfg, RT, params, prompts,
                                           cs.LM_GEN, cs.LM_CACHE).tolist()}
    del params
    cfg = cs.lm_pin_cfg(configs, "whisper-base")
    params = jax.tree.map(jnp.asarray, cs.reference_tree(cfg, 0))
    batch = {k: jnp.asarray(v)
             for k, v in cs.lm_pin_inputs(cfg, "whisper").items()}
    pins["whisper"] = prefill_pin(params, cfg, batch)
    print(json.dumps(pins))
    print(f"# {time.perf_counter() - t0:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main()
