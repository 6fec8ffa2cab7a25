"""Architecture + run configuration system.

Each assigned architecture gets one ``configs/<id>.py`` exporting ``CONFIG``
(exact published shape) and ``SMOKE`` (a reduced same-family config for CPU
smoke tests). Input-shape suites (train_4k / prefill_32k / decode_32k /
long_500k) are defined here and apply to every LM architecture.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    activation: str = "silu"          # GLU gate act: silu | gelu
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25
    moe_ep_pref: str = "data"   # EP axis: 'model' when one expert fits a chip
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    ssm_conv: int = 4
    # Hybrid (Zamba2): one weight-shared attention block every k SSM layers
    attn_every: int = 0
    # Encoder-decoder (Whisper)
    enc_layers: int = 0
    # VLM (Qwen2-VL)
    mrope: bool = False
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    n_vision_tokens: int = 0
    # encdec positional-table capacity (largest assigned shape)
    max_pos: int = 32768
    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline terms)."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "vlm"):
            attn = d * self.hd * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * self.hd * d
            mlp = 3 * d * self.d_ff
            return emb + self.n_layers * (attn + mlp + 2 * d)
        if self.family == "moe":
            attn = d * self.hd * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * self.hd * d
            moe = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
            return emb + self.n_layers * (attn + moe + 2 * d)
        if self.family == "ssm":
            per = self._ssm_layer_params()
            return emb + self.n_layers * per
        if self.family == "hybrid":
            per = self._ssm_layer_params()
            shared_attn = 2 * d * self.hd * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * self.hd * d + 3 * d * self.d_ff
            return emb + self.n_layers * per + shared_attn
        if self.family == "encdec":
            attn = d * self.hd * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * self.hd * d
            mlp = 2 * d * self.d_ff
            dec = self.n_layers * (2 * attn + mlp + 3 * d)
            enc = self.enc_layers * (attn + mlp + 2 * d)
            return emb + enc + dec
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed experts only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        moe_all = self.n_layers * self.n_experts * 3 * d * self.d_ff
        moe_act = self.n_layers * self.top_k * 3 * d * self.d_ff
        return full - moe_all + moe_act

    def _ssm_layer_params(self) -> int:
        d, di, st = self.d_model, self.d_inner, self.ssm_state
        h = self.ssm_heads
        in_proj = d * (2 * di + 2 * st + h)
        conv = self.ssm_conv * (di + 2 * st)
        out = di * d
        return in_proj + conv + out + 3 * h + di + d


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: run only for SSM/hybrid archs
# (see DESIGN.md §Arch-applicability).
LONG_CONTEXT_ARCHS = {"mamba2-130m", "zamba2-2.7b"}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return arch.name in LONG_CONTEXT_ARCHS
    return True
