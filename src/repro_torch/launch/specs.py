"""Shape stand-ins for every (arch x shape) dry-run cell (torch counterpart of
``repro.launch.specs``).

Nothing is allocated: parameters, optimizer moments, serving caches and
batch inputs are tensors on the ``meta`` device, which carry a shape and a
dtype and no storage. The model is built on ``meta`` without drawing
(``models.registry.build``), so kimi-k2's trillion parameters take no
memory. Cache shapes are the port's own cache trees (``kv`` for the
decoder-only attention families and the hybrid's shared block, ``ssm`` and
``conv`` for ssm and hybrid, the encoder-decoder's ``self_kv`` and
``cross_kv``), whose rows are ``decode_rows(batch)`` for the decoder-only
families.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.layers import dtype_of
from repro_torch.models.registry import build

META = torch.device("meta")


def meta_model(cfg: ModelConfig) -> torch.nn.Module:
    """The model of ``cfg`` with meta parameters."""
    return build(cfg, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Batch inputs for train/prefill; decode takes tokens only (its cache
    comes from ``cache_specs``)."""
    b, s = shape.global_batch, shape.seq_len
    act = dtype_of(cfg.activation_dtype)

    def sds(dims, dtype):
        return torch.empty(dims, dtype=dtype, device=META)

    if shape.kind == "decode":
        return {"tokens": sds((b, 1), torch.int32)}
    if cfg.family == "vlm":
        return {"tokens": sds((b, s - cfg.num_patches), torch.int32),
                "patch_embeds": sds((b, cfg.num_patches, cfg.d_model), act)}
    if cfg.is_encoder_decoder:
        return {"tokens": sds((b, s), torch.int32),
                "frames": sds((b, cfg.num_frames, cfg.d_model), act)}
    return {"tokens": sds((b, s), torch.int32)}


def param_specs(model: torch.nn.Module) -> dict:
    """{name: parameter} of a (meta) model."""
    return dict(model.named_parameters())


def cache_specs(model: torch.nn.Module, batch: int, max_len: int):
    """The model's serving cache for ``batch`` sequences of ``max_len``."""
    return model.init_cache(batch, max_len)


def opt_specs(params: dict, opt_cfg):
    """The optimizer state of ``params`` (``optimizers.init`` on their
    device)."""
    from repro_torch.optim import optimizers

    return optimizers.init(list(params.values()), opt_cfg)
