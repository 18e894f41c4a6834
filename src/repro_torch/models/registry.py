"""Model registry of the port (torch counterpart of ``repro.models.registry``):
``TransformerLM`` for the decoder-only families, ``EncDecLM`` for the
encoder-decoder (which, as in the reference, has no paged decode path)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer


class ShapesOnly:
    """The generator the init functions get on the ``meta`` device: they
    read its ``device``, and ``layers.param`` draws nothing there."""
    device = torch.device("meta")


def build(cfg: ModelConfig, *, device: torch.device, seed: int = 0,
          params: dict | None = None) -> torch.nn.Module:
    """The model for ``cfg`` on ``device``: weights drawn from a
    ``torch.Generator`` seeded with ``seed``, or the given parameter tree
    (e.g. ``repro_torch.interop.params_from_jax``), moved to ``device``. On
    the ``meta`` device the weights have shapes and dtypes only, and nothing
    is drawn (``torch.Generator`` has no meta device)."""
    if cfg.is_encoder_decoder:
        init, model = encdec.init_encdec, encdec.EncDecLM
    else:
        init, model = transformer.init_lm, transformer.TransformerLM
    if params is None and torch.device(device).type == "meta":
        params = init(cfg, ShapesOnly())
    elif params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        params = init(cfg, gen)
    else:
        params = _to_device(params, device)
    return model(cfg, params)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
