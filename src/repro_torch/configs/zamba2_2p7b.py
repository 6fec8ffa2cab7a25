"""zamba2-2.7b [hybrid]: 54L Mamba2 (d=2560, state=64) + one weight-shared
attention/MLP block (32H, ff=10240) applied every 6 layers, vocab=32000.
[arXiv:2411.15242; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=10240, vocab=32000, head_dim=80,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_chunk=128,
    attn_every=6, tie_embeddings=True)

SMOKE = ArchConfig(
    name="zamba2-2.7b-smoke", family="hybrid", n_layers=4, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=512, head_dim=16,
    ssm_state=16, ssm_expand=2, ssm_headdim=16, ssm_chunk=32,
    attn_every=2, tie_embeddings=True)
