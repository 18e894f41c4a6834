"""Architecture config registry of the port: ``get_config(name)`` /
``get_smoke_config(name)`` / ``list_configs()``.

Every architecture of the reference is listed, in its order, each module a
copy of the reference's ``CONFIG`` (the published configuration) and
``SMOKE`` (a reduced config of the same family). ``NOT_PORTED`` names the
reference's architectures that the port lacks (none now); asking for one
raises :class:`repro_torch.NotPortedError`.
"""
from __future__ import annotations

import importlib

from repro_torch import NotPortedError
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    ShapeConfig,
    shape_applicable,
)

ARCH_MODULES = {
    "qwen1.5-0.5b": "qwen15_0_5b",
    "internlm2-20b": "internlm2_20b",
    "deepseek-67b": "deepseek_67b",
    "stablelm-3b": "stablelm_3b",
    "arctic-480b": "arctic_480b",
    "kimi-k2-1t-a32b": "kimi_k2",
    "zamba2-7b": "zamba2_7b",
    "llava-next-34b": "llava_next_34b",
    "whisper-medium": "whisper_medium",
    "mamba2-780m": "mamba2_780m",
}

# the reference's other architectures, in its registry
NOT_PORTED: tuple = ()

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


def list_configs() -> dict:
    """``{name: get_config(name)}`` in ``ARCH_NAMES`` order."""
    return {n: get_config(n) for n in ARCH_NAMES}
