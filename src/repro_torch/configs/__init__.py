"""Architecture registry of the port.

``get_config(arch_id)`` returns the full published configuration;
``get_smoke_config(arch_id)`` a reduced same-family one for CPU tests.  The
port runs the dense GQA architectures so far (qwen2-0.5b, smollm-135m);
every other architecture the JAX package knows raises ``NotImplementedError``
until the LM-substrate slice ports its modules (MoE, MLA, Mamba, RWKV,
encoder-decoder, vision stub).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    MLAConfig,
    ModelConfig,
    MoEConfig,
    RetrievalConfig,
    RWKVConfig,
    SSMConfig,
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

PORTED = {
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
}


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet: its modules come with the "
            f"LM-substrate slice; ported so far: {sorted(PORTED)}"
        )
    return importlib.import_module(PORTED[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE_CONFIG


__all__ = [
    "ARCH_IDS", "PORTED", "get_config", "get_smoke_config", "ModelConfig",
    "MoEConfig", "MLAConfig", "SSMConfig", "RWKVConfig", "RetrievalConfig",
]
