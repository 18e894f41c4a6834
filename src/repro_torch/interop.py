"""Carry weights between the reference and the port.

The reference's parameter pytree (nested dicts of arrays, as
``jax.tree.map(np.asarray, params)`` gives it) maps one to one onto the
port's parameters: same names, same shapes, same (L, ...) stacking. Arrays
travel as numpy, so this module needs neither framework's other half.
"""
from __future__ import annotations

import numpy as np
import torch


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: move the raw bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(tree: dict) -> dict:
    """Reference parameter tree of numpy arrays -> the port's parameter tree
    (nested dicts of CPU tensors) for ``models.registry.build(params=...)``."""
    return {k: params_from_jax(v) if isinstance(v, dict) else _to_torch(v)
            for k, v in tree.items()}


def params_to_jax(model: torch.nn.Module) -> dict:
    """The port's model -> the reference's parameter tree of numpy arrays
    (float32 for bf16 weights, which numpy has no native type for)."""
    tree: dict = {"head": {}}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        t = p.detach().cpu()
        node[leaf] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree
