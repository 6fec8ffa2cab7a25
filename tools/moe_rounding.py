"""How far an MoE's greedy routing carries an attention rounding, on the CPU.

    PYTHONPATH=src:. python tools/moe_rounding.py [--layers 16]

The port's torch arm runs one bf16 prefill (B 2, S 1024, seeded weights
and tokens) of a narrow stand-in of each configuration (d_model 512, 8
heads over 2 KV heads of 64, d_ff 512, vocab 4096, ``--layers`` layers)
twice: with its own attention (``layers._sdpa``, which rounds the
normalised probabilities to bf16 before P V) and with the flash kernels'
plain version (``flash_attention_ref``, which keeps them in float32): two
roundings of one function, as the card's two attention arms are. For
phi3.5-moe's routing (16 experts, top-2), granite-moe-3b's (40, top-8) and
a dense FFN it prints one JSON line: the expert choices that differ
between the two runs in each layer (``chip_smoke.moe_flips``) and the
largest gap of the last position's logits as a share of the largest
logit (``chip_smoke.LM_ARM_TOL`` bounds that share). A run with the K/V
heads rolled by one (a fault) is the yardstick of a real difference.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import layers, lm, moe  # noqa: E402

NARROW = dict(d_model=512, n_heads=8, n_kv_heads=2, head_dim=64, d_ff=512,
              vocab=4096)
ROUTINGS = {"phi3.5-moe-42b-a6.6b": "phi3.5-moe-42b-a6.6b",
            "granite-moe-3b-a800m": "granite-moe-3b-a800m",
            "dense": "deepseek-7b"}
B, S = 2, 1024


def prefill(model, cfg, tokens, attend=None, kv_roll=False):
    """Last-position logits (B, V) float32 and each moe layer's choices."""
    routed = []
    route, own_attend, own_repeat = moe.route, layers._attend, \
        layers.repeat_kv

    def recording(p, x, c):
        gates, eidx = route(p, x, c)
        routed.append(eidx)
        return gates, eidx
    moe.route = recording
    if attend is not None:
        layers._attend = attend
    if kv_roll:
        layers.repeat_kv = lambda k, n: own_repeat(k.roll(1, dims=2), n)
    try:
        with torch.no_grad():
            logits, _ = lm.prefill_fn(model, {"tokens": tokens}, cfg,
                                      "torch")
    finally:
        moe.route, layers._attend, layers.repeat_kv = route, own_attend, \
            own_repeat
    return logits[:, -1].float(), routed


def plain_flash(q, k, v, is_causal, backend, dtype):
    return fa.flash_attention_ref(q, k, v, causal=is_causal)


def main(argv=None) -> None:
    argv = list(argv or [])
    n_layers = int(argv[argv.index("--layers") + 1]) \
        if "--layers" in argv else 16
    torch.manual_seed(0)
    for name, arch in ROUTINGS.items():
        cfg = dataclasses.replace(configs.get_config(arch), **NARROW,
                                  n_layers=n_layers, dtype="bfloat16")
        model = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab, (B, S), dtype=np.int32))
        own, r_own = prefill(model, cfg, tokens)
        out = {"routing": name, "n_layers": n_layers, "B": B, "S": S,
               "choices_per_layer": B * S * cfg.top_k}
        for key, kw in (("plain_flash", {"attend": plain_flash}),
                        ("kv_rolled", {"kv_roll": True})):
            got, r_got = prefill(model, cfg, tokens, **kw)
            out[key] = {
                "logit_gap_share": float((got - own).abs().max()
                                         / own.abs().max()),
                "flipped_choices_per_layer": [
                    cs.moe_flips(a, b, cfg.n_experts)
                    for a, b in zip(r_own, r_got)]}
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
