"""qwen2-vl-7b [vlm]: qwen2-7b backbone + M-RoPE + dynamic-resolution vision
frontend (STUB: input_specs provides patch embeddings + 3D position ids).
[arXiv:2409.12191; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm", n_layers=28, d_model=3584,
    n_heads=28, n_kv_heads=4, d_ff=18944, vocab=152064, head_dim=128,
    qkv_bias=True, activation="silu", rope_theta=1e6,
    mrope=True, mrope_sections=(16, 24, 24), n_vision_tokens=256)

SMOKE = ArchConfig(
    name="qwen2-vl-smoke", family="vlm", n_layers=2, d_model=96,
    n_heads=4, n_kv_heads=2, d_ff=192, vocab=512, head_dim=24,
    qkv_bias=True, mrope=True, mrope_sections=(4, 4, 4),
    n_vision_tokens=16)
