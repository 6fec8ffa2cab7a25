"""qwen2-7b [dense]: 28L, d=3584, 28H GQA(kv=4), ff=18944, vocab=152064 —
QKV bias. [arXiv:2407.10671; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b", family="dense", n_layers=28, d_model=3584,
    n_heads=28, n_kv_heads=4, d_ff=18944, vocab=152064, head_dim=128,
    qkv_bias=True, activation="silu", rope_theta=1e6)

SMOKE = ArchConfig(
    name="qwen2-7b-smoke", family="dense", n_layers=2, d_model=112,
    n_heads=4, n_kv_heads=2, d_ff=224, vocab=512, head_dim=28,
    qkv_bias=True)
