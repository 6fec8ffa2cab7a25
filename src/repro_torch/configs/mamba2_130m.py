"""mamba2-130m [ssm]: 24L, d=768, attn-free, vocab=50280, ssm_state=128 —
SSD (state-space duality). [arXiv:2405.21060; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm", n_layers=24, d_model=768,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=128,
    tie_embeddings=True)

SMOKE = ArchConfig(
    name="mamba2-130m-smoke", family="ssm", n_layers=2, d_model=64,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab=512,
    ssm_state=16, ssm_expand=2, ssm_headdim=16, ssm_chunk=32,
    tie_embeddings=True)
