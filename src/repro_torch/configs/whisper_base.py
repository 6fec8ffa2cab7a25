"""whisper-base [audio]: 6L enc + 6L dec, d=512, 8H MHA, ff=2048,
vocab=51865 — encoder-decoder; conv frontend is a STUB (input_specs provides
precomputed frame embeddings). [arXiv:2212.04356; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="encdec", n_layers=6, enc_layers=6,
    d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048, vocab=51865,
    norm="layernorm", activation="gelu")

SMOKE = ArchConfig(
    name="whisper-base-smoke", family="encdec", n_layers=2, enc_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    norm="layernorm", activation="gelu")
