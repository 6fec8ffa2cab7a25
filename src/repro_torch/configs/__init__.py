"""Architecture registry: ``--arch <id>`` resolves here."""

from . import (
    command_r_35b, deepseek_7b, gemma_7b, granite_moe_3b, mamba2_130m,
    phi35_moe, qwen2_7b, qwen2_vl_7b, whisper_base, zamba2_2p7b,
)
from .base import SHAPES, ArchConfig, ShapeConfig, shape_applicable

_MODULES = {
    "command-r-35b": command_r_35b,
    "deepseek-7b": deepseek_7b,
    "gemma-7b": gemma_7b,
    "qwen2-7b": qwen2_7b,
    "whisper-base": whisper_base,
    "mamba2-130m": mamba2_130m,
    "zamba2-2.7b": zamba2_2p7b,
    "granite-moe-3b-a800m": granite_moe_3b,
    "phi3.5-moe-42b-a6.6b": phi35_moe,
    "qwen2-vl-7b": qwen2_vl_7b,
}

ARCH_IDS = tuple(_MODULES)

__all__ = [
    "ARCH_IDS", "ArchConfig", "SHAPES", "ShapeConfig",
    "get_config", "get_smoke_config", "shape_applicable",
]


def get_config(arch_id: str) -> ArchConfig:
    return _MODULES[arch_id].CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    return _MODULES[arch_id].SMOKE
