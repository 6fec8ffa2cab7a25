"""deepseek-7b [dense]: 30L, d=4096, 32H GQA(kv=32)=MHA, ff=11008,
vocab=102400 — llama architecture. [arXiv:2401.02954; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b", family="dense", n_layers=30, d_model=4096,
    n_heads=32, n_kv_heads=32, d_ff=11008, vocab=102400,
    activation="silu", rope_theta=1e4)

SMOKE = ArchConfig(
    name="deepseek-7b-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, d_ff=256, vocab=512)
