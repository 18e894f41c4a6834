"""Causal GQA attention for training (torch port of the training path of
``repro.models.attention``).

``causal_attention`` computes what the reference's ``chunked_attention``
computes, as one full (S, S) score matrix: scores from the compute-dtype
product, upcast to float32 and scaled, the causal mask at -1e30, a float32
softmax, and the weights cast back to the compute dtype before the product
with V. The reference streams (q, kv) chunk pairs with an online softmax;
the two agree to float rounding. A fast attention kernel is later work, and
so are the decode paths (serving slice).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import apply_rope, dtype_of, param, rope_angles

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg, lead=()) -> dict:
    """Reference shapes: wq (d, h, hd), wk/wv (d, k, hd), wo (h, hd, d),
    biases (h|k, hd); sorted keys (the reference's flatten order)."""
    d, h, k, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = dtype_of(cfg.param_dtype)
    p = {}
    if cfg.qkv_bias:
        p["bk"] = param(gen, (*lead, k, hd), dt, scale=0.0)
        p["bq"] = param(gen, (*lead, h, hd), dt, scale=0.0)
        p["bv"] = param(gen, (*lead, k, hd), dt, scale=0.0)
    p["wk"] = param(gen, (*lead, d, k, hd), dt)
    p["wo"] = param(gen, (*lead, h, hd, d), dt, scale=0.02 / math.sqrt(2 * cfg.num_layers))
    p["wq"] = param(gen, (*lead, d, h, hd), dt)
    p["wv"] = param(gen, (*lead, d, k, hd), dt)
    return p


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, h, hd = w.shape
    return (x @ w.reshape(d, h * hd)).unflatten(-1, (h, hd))


def _qkv(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor | None = None):
    q, k, v = _project(x, p["wq"]), _project(x, p["wk"]), _project(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if positions is not None:
        cos, sin = rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    return q, k, v


def _repeat_kv(k: torch.Tensor, v: torch.Tensor, cfg):
    """Materialize GQA KV to the full head count (as the reference does for
    training)."""
    g = cfg.num_heads // cfg.num_kv_heads
    if g == 1:
        return k, v
    return k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (B, S, H, hd) with equal head counts -> (B, S, H, hd)."""
    s, hd = q.shape[1], q.shape[-1]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, S, hd)
    scores = (qh @ kh.transpose(-1, -2)).to(torch.float32) * (1.0 / math.sqrt(hd))
    keep = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    scores = torch.where(keep, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return (w.to(v.dtype) @ vh).transpose(1, 2)


def attention_train(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor) -> torch.Tensor:
    q, k, v = _qkv(p, x, cfg, positions)
    k, v = _repeat_kv(k, v, cfg)
    out = causal_attention(q, k, v)
    h, hd, d = p["wo"].shape
    return out.flatten(-2) @ p["wo"].reshape(h * hd, d)
