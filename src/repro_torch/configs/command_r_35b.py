"""command-r-35b [dense]: 40L, d=8192, 64H GQA(kv=8), ff=22528, vocab=256000.
GQA, no biases. [hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b", family="dense", n_layers=40, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=22528, vocab=256000, head_dim=128,
    qkv_bias=False, activation="silu", rope_theta=8e6)

SMOKE = ArchConfig(
    name="command-r-35b-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=8, n_kv_heads=2, d_ff=256, vocab=512, head_dim=16,
    qkv_bias=False, activation="silu")
