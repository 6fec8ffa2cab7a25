"""granite-moe-3b-a800m [moe]: 32L, d=1536, 24H GQA(kv=8), per-expert
ff=512, vocab=49155, 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536,
    n_heads=24, n_kv_heads=8, d_ff=512, vocab=49155, head_dim=64,
    n_experts=40, top_k=8, tie_embeddings=True,
    moe_ep_pref="model")  # 2.4M-param experts: replicated-activation EP (§Perf B)

SMOKE = ArchConfig(
    name="granite-moe-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=32, vocab=512, head_dim=16,
    n_experts=8, top_k=2, tie_embeddings=True)
