"""Model FLOPs of the benchmark's jobs, one matrix product at a time, from a
configuration's shapes (:func:`gale_bench.registry.model_shape`: the fields
of the port's ``ArchConfig``, ``hd``, and ``reference``, the module of
``gale_bench/reference/`` that holds the family's block).

What counts: two flops a multiply-add of every product the model needs.
The embedding lookup is no product. The score and value products count the
causal (query, key) pairs alone. The LM head counts the rows it is applied
to: every position in training, the last position of a row in prefill. The
family's block counts its own feed-forward products (``ffn_flops(cfg)``, a
token's; a MoE its router and its routed experts' products, not the
capacity's padding), or, where it replaces the attention layer as a whole,
the layer's (``layer_flops(cfg, i, B, S)``). A training step is the
forward three times over (the backward's two products for each forward
one); products a backward recomputes are not counted. ``6 N D`` is not
used: it counts the embedding as a product and the head at every position.
"""

from __future__ import annotations

from ..registry import reference_block
from .peaks import attention_pairs


def _attention_layer(cfg, block, B: int, S: int) -> float:
    """Forward flops of an attention layer over B rows of S positions: its
    projections, the causal score and value products, the family's
    feed-forward block."""
    d, hd = cfg.d_model, cfg.hd
    qkv = 2 * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    out = 2 * cfg.n_heads * hd * d
    pairs = 4.0 * B * cfg.n_heads * hd * attention_pairs(S, S, True)
    return B * S * float(qkv + out + block.ffn_flops(cfg)) + pairs


def forward_flops(cfg, B: int, S: int, head_rows: int) -> float:
    """One forward pass over B rows of S positions, the head applied to
    ``head_rows`` rows."""
    block = reference_block(cfg.reference)
    own = getattr(block, "layer_flops", None)
    layers = sum(own(cfg, i, B, S) for i in range(cfg.n_layers)) if own \
        else cfg.n_layers * _attention_layer(cfg, block, B, S)
    head = 2.0 * cfg.d_model * cfg.vocab * head_rows
    return layers + head


def train_step_flops(cfg, B: int, S: int) -> float:
    """A training step: forward and backward, the head at every position."""
    return 3.0 * forward_flops(cfg, B, S, head_rows=B * S)


def prefill_flops(cfg, B: int, S: int) -> float:
    """A prefill batch: the forward, the head at each row's last position."""
    return forward_flops(cfg, B, S, head_rows=B)
