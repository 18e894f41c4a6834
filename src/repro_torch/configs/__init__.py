"""Architecture config registry of the port: ``get_config(name)`` /
``get_smoke_config(name)`` / ``list_configs()``.

Every architecture of the reference is listed, in its order, each module a
copy of the reference's ``CONFIG`` (the published configuration) and
``SMOKE`` (a reduced config of the same family). ``PORT_MODULES`` lists the
port's own configs (``zamba2-7b-published``), found by name but kept out
of ``ARCH_NAMES`` and ``list_configs()``. ``NOT_PORTED`` names the
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

# the port's own configs, beside the reference's list (not in ARCH_NAMES nor
# list_configs(), which are the reference's): get_config and the CLIs find them
PORT_MODULES = {
    "zamba2-7b-published": "zamba2_7b_published",
}


def _module(name: str):
    if name in NOT_PORTED:
        raise NotPortedError(f"architecture {name!r}")
    module = ARCH_MODULES.get(name) or PORT_MODULES.get(name)
    if module is None:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES + list(PORT_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{module}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE


def list_configs() -> dict:
    """``{name: get_config(name)}`` in ``ARCH_NAMES`` order."""
    return {n: get_config(n) for n in ARCH_NAMES}
