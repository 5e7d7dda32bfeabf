"""Config registry (port of ``repro/configs/__init__.py``): ``--arch <id>``
resolution for every assigned architecture. All ten ids resolve to a
config, and every family runs in the port (``models/registry.py``).
``ParallelConfig`` says how a model maps onto a device mesh."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (SHAPES, ModelConfig, ParallelConfig,
                                      ShapeConfig, reduced, with_blast)

_ARCH_MODULES = {
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "stablelm-3b": "stablelm_3b",
    "gemma2-27b": "gemma2_27b",
    "stablelm-12b": "stablelm_12b",
    "qwen2-7b": "qwen2_7b",
    "rwkv6-3b": "rwkv6_3b",
    "whisper-large-v3": "whisper_large_v3",
    "zamba2-1.2b": "zamba2_1b",
    "internvl2-2b": "internvl2_2b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = _module(arch)
    return mod.SMOKE if smoke else mod.CONFIG


def skip_shapes(arch: str) -> dict[str, str]:
    return dict(getattr(_module(arch), "SKIP_SHAPES", {}))


def cells(include_skipped: bool = False):
    """All runnable (arch, shape) cells."""
    out = []
    for arch in ARCH_IDS:
        skips = skip_shapes(arch)
        for shape in SHAPES:
            if shape in skips and not include_skipped:
                continue
            out.append((arch, shape))
    return out


__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "ParallelConfig",
           "ShapeConfig", "cells",
           "get_config", "reduced", "skip_shapes", "with_blast"]
