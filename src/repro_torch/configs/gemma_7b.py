"""gemma-7b [dense]: 28L, d=3072, 16H (kv=16), ff=24576, vocab=256000 —
GeGLU, head_dim=256. [arXiv:2403.08295; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b", family="dense", n_layers=28, d_model=3072,
    n_heads=16, n_kv_heads=16, d_ff=24576, vocab=256000, head_dim=256,
    activation="gelu", tie_embeddings=True, rope_theta=1e4)

SMOKE = ArchConfig(
    name="gemma-7b-smoke", family="dense", n_layers=2, d_model=96,
    n_heads=4, n_kv_heads=4, d_ff=192, vocab=512, head_dim=32,
    activation="gelu", tie_embeddings=True)
