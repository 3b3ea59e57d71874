"""Arch-id -> config registry (``--arch <id>`` on every launcher)."""
from __future__ import annotations

import importlib
from typing import Dict

from .base import ModelConfig

_MODULES: Dict[str, str] = {
    "qwen1.5-32b": "qwen1_5_32b",
    "yi-34b": "yi_34b",
    "deepseek-7b": "deepseek_7b",
    "qwen2-72b": "qwen2_72b",
    "hubert-xlarge": "hubert_xlarge",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "xlstm-350m": "xlstm_350m",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "deepseek-v3-671b": "deepseek_v3",
    "jamba-v0.1-52b": "jamba_52b",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {', '.join(ARCH_IDS)}")
    return importlib.import_module(f".{_MODULES[arch]}", __package__)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
