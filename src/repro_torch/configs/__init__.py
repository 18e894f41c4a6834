"""Architecture config registry of the port: ``get_config(name)`` /
``get_smoke_config(name)``.

Only the architectures whose model the port runs are listed; the other
architectures of the reference raise :class:`repro_torch.NotPortedError`.
"""
from __future__ import annotations

import importlib

from repro_torch import NotPortedError
from repro_torch.configs.base import ModelConfig

ARCH_MODULES = {
    "qwen1.5-0.5b": "qwen15_0_5b",
}

# the reference's other architectures, in its registry
NOT_PORTED = ("internlm2-20b", "deepseek-67b", "stablelm-3b", "arctic-480b",
              "kimi-k2-1t-a32b", "zamba2-7b", "llava-next-34b",
              "whisper-medium", "mamba2-780m")

ARCH_NAMES = list(ARCH_MODULES)


def _module(name: str):
    if name in NOT_PORTED:
        raise NotPortedError(f"architecture {name!r}")
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE
