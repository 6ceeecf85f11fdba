"""Architecture config registry: get_config(arch_id) / get_smoke_config,
the ten arch ids of the reference with their published widths, and the
reference's training and shape-cell configs."""
from __future__ import annotations

import importlib

from .base import SHAPE_CELLS, MLAConfig, ModelConfig, MoEConfig, ShapeCell, SSMConfig, TrainConfig

ARCH_IDS = (
    "granite-34b",
    "stablelm-3b",
    "h2o-danube-3-4b",
    "qwen1.5-4b",
    "seamless-m4t-large-v2",
    "paligemma-3b",
    "zamba2-2.7b",
    "mamba2-780m",
    "deepseek-v2-lite-16b",
    "llama4-maverick-400b-a17b",
)

_MODULES = {
    "granite-34b": "granite_34b",
    "stablelm-3b": "stablelm_3b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "qwen1.5-4b": "qwen1_5_4b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "paligemma-3b": "paligemma_3b",
    "zamba2-2.7b": "zamba2_2_7b",
    "mamba2-780m": "mamba2_780m",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
}


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_MODULES)}")
    return importlib.import_module(f".{_MODULES[arch_id]}", __package__)


def get_config(arch_id: str) -> ModelConfig:
    """The exact published configuration."""
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return _module(arch_id).smoke()


__all__ = [
    "ARCH_IDS", "get_config", "get_smoke_config",
    "ModelConfig", "MoEConfig", "SSMConfig", "MLAConfig",
    "TrainConfig", "ShapeCell", "SHAPE_CELLS",
]
