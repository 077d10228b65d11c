"""Architecture registry of the port: one module per architecture of the
JAX package's model zoo, each a copy of its ``configs/*.py``.

``get_config(arch_id)`` returns the full published configuration;
``get_smoke_config(arch_id)`` a reduced same-family one for CPU tests
(small widths, layers and experts; the same code paths).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    SHAPES,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    RetrievalConfig,
    RWKVConfig,
    ShapeConfig,
    SSMConfig,
    shape_applicable,
)

ARCH_IDS = [
    "whisper-tiny",
    "pixtral-12b",
    "jamba-1.5-large-398b",
    "smollm-135m",
    "granite-20b",
    "qwen2-0.5b",
    "deepseek-67b",
    "rwkv6-3b",
    "deepseek-v2-236b",
    "qwen3-moe-235b-a22b",
]

PORTED = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def _module(arch: str):
    if arch not in PORTED:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(PORTED[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE_CONFIG


__all__ = [
    "ARCH_IDS", "PORTED", "get_config", "get_smoke_config", "ModelConfig",
    "MoEConfig", "MLAConfig", "SSMConfig", "RWKVConfig", "RetrievalConfig",
    "SHAPES", "ShapeConfig", "shape_applicable",
]
