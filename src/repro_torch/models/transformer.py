"""TransformerLM for the dense family (torch port of the training path of
``repro.models.transformer``).

The parameters keep the reference's pytree layout, names and shapes: every
per-layer weight is ONE stacked ``(L, ...)`` leaf (``layers.attn.wq`` is
``(L, d, h, hd)``), and ``named_parameters()`` yields the leaves in the
reference's flatten order (sorted keys). The FPISA aggregation cuts its
blocks from each flattened leaf, so the layout decides which elements share
a block exponent: with the same leaves the aggregated bits are the same.

Remat is not applied (it has no numeric effect); the MoE, SSM, hybrid and
VLM families and the prefill/decode paths are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from repro_torch import NotPortedError
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_mlp,
    dtype_of,
    embed,
    init_embedding,
    init_mlp,
    init_rms_norm,
    param,
    rms_norm,
)


def _params(tree: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tree.items()})


def init_lm(cfg, gen: torch.Generator) -> dict:
    """The reference's parameter tree (nested dicts of tensors, sorted keys),
    drawn from ``gen`` on its device."""
    if cfg.family != "dense":
        raise NotPortedError(f"the {cfg.family!r} model family")
    dt, lead = dtype_of(cfg.param_dtype), (cfg.num_layers,)
    layers = {
        "attn": attn.init_attention(gen, cfg, lead),
        "ln1": init_rms_norm(cfg.d_model, dt, gen.device, lead),
        "ln2": init_rms_norm(cfg.d_model, dt, gen.device, lead),
        "mlp": init_mlp(gen, cfg, lead),
    }
    params = {
        "embed": init_embedding(gen, cfg),
        "final_norm": init_rms_norm(cfg.d_model, dt, gen.device),
        "head": {},
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["head"] = {"w": param(gen, (cfg.d_model, cfg.vocab_size), dt)}
    return params


def _dense_block(lp: dict, x: torch.Tensor, cfg, positions: torch.Tensor) -> torch.Tensor:
    h = attn.attention_train(lp["attn"], rms_norm(x, lp["ln1"]["w"], cfg.norm_eps), cfg, positions)
    x = x + h
    y = rms_norm(x, lp["ln2"]["w"], cfg.norm_eps)
    return x + apply_mlp(lp["mlp"], y, cfg)


def _per_layer(layers: nn.ModuleDict, num_layers: int) -> list:
    """Split the stacked leaves into per-layer views (one ``unbind`` per
    leaf, whose backward stacks the per-layer gradients back)."""
    split = {g: {k: t.unbind(0) for k, t in group.items()} for g, group in layers.items()}
    return [{g: {k: ts[i] for k, ts in group.items()} for g, group in split.items()}
            for i in range(num_layers)]


class TransformerLM(nn.Module):
    """Dense decoder LM; ``loss(tokens)`` is the training objective."""

    def __init__(self, cfg, params: dict):
        super().__init__()
        self.cfg = cfg
        # registration order = the reference's flatten order
        self.embed = _params(params["embed"])
        self.final_norm = _params(params["final_norm"])
        self.head = _params(params["head"])
        self.layers = nn.ModuleDict({g: _params(t) for g, t in params["layers"].items()})

    def forward(self, tokens: torch.Tensor):
        """tokens (B, S) int -> (logits (B, S, V), aux_loss)."""
        cfg = self.cfg
        x = embed(self.embed, tokens).to(dtype_of(cfg.activation_dtype))
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        for lp in _per_layer(self.layers, cfg.num_layers):
            x = _dense_block(lp, x, cfg, positions)
        x = rms_norm(x, self.final_norm["w"], cfg.norm_eps)
        w = self.embed["tok"].T if cfg.tie_embeddings else self.head["w"]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)  # dense: none
        return x @ w, aux

    def loss(self, tokens: torch.Tensor) -> torch.Tensor:
        """Mean next-token NLL + 0.01 * aux, from float32 log-probabilities."""
        logits, aux = self(tokens)
        lp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
        nll = -lp.gather(-1, tokens[:, 1:, None].long())[..., 0]
        return nll.mean() + 0.01 * aux
