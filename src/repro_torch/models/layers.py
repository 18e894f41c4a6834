"""Basic neural-net layers as plain functions on tensors (torch port of
``repro.models.layers``).

Parameters keep the reference's shapes and names; a layer's parameters are
a dict of tensors. ``init_*`` functions draw from an explicit
``torch.Generator`` and take a ``lead`` shape so that per-layer weights can
be created stacked, ``(L, ...)``, as the reference stacks them. Weights are
stored in ``cfg.param_dtype``; compute upcasts where the reference does
(norm variance, RoPE, softmax).
"""
from __future__ import annotations

import contextvars
import math

import torch
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def param(gen: torch.Generator, shape, dtype, scale: float | None = None) -> torch.Tensor:
    """N(0, scale^2) drawn in float32 on the generator's device, then cast.
    On the ``meta`` device (``launch/specs.py``) nothing is drawn: the
    tensor has the shape and dtype alone."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    if scale is None:
        scale = 0.02
    if scale == 0.0:
        return torch.zeros(shape, dtype=dtype, device=gen.device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return x.mul_(scale).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in the reference's order: square in the compute dtype, sum in
    float32, rsqrt cast back to the compute dtype."""
    t = x * x
    var = t.sum(dim=-1, keepdim=True, dtype=torch.float32) / x.shape[-1]
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * weight.to(x.dtype)


def init_rms_norm(d: int, dtype, device, lead=()) -> dict:
    return {"w": torch.ones((*lead, d), dtype=dtype, device=device)}


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def init_mlp(gen: torch.Generator, cfg, lead=(), d_ff: int | None = None) -> dict:
    """Sorted keys: the reference's pytree flatten order. ``d_ff`` replaces
    ``cfg.d_ff`` (arctic's parallel dense MLP is ``moe_dense_ff`` wide)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = dtype_of(cfg.param_dtype)
    p = {}
    if cfg.mlp == "swiglu":
        p["wg"] = param(gen, (*lead, d, f), dt)
    p["wi"] = param(gen, (*lead, d, f), dt)
    p["wo"] = param(gen, (*lead, f, d), dt, scale=0.02 / math.sqrt(2 * cfg.num_layers))
    return p


def apply_mlp(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    h = x @ p["wi"]
    if "wg" in p:
        h = silu(x @ p["wg"]) * h
    else:
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return unread_product(h, p["wo"])


_UNREAD = contextvars.ContextVar("repro_torch_unread_product", default=False)


def unread_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a product whose output no backward reads: a down
    projection whose output only enters the residual stream's sum. The
    reference's ``remat="dots"`` saves a product only where its backward
    reads it, so it keeps no copy of these, and neither does the port's
    (``transformer.dots_policy`` reads :func:`in_unread_product`)."""
    token = _UNREAD.set(True)
    try:
        return x @ w
    finally:
        _UNREAD.reset(token)


def in_unread_product() -> bool:
    """Whether the op running now belongs to an :func:`unread_product`."""
    return _UNREAD.get()


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: int (...,) -> (cos, sin) float32 of shape (..., head_dim//2)."""
    half = head_dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(theta) * ar / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (S, hd//2) or (B, S, hd//2)."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:  # (S, half) -> broadcast over batch and heads
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:  # (B, S, half)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    xf = x.to(torch.float32)
    x1f, x2f = xf[..., :half], xf[..., half:]
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


def init_embedding(gen: torch.Generator, cfg) -> dict:
    return {"tok": param(gen, (cfg.vocab_size, cfg.d_model), dtype_of(cfg.param_dtype))}


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Row lookup. A DTensor table is gathered whole first: DTensor's own
    lookup in a vocab-sharded table leaves a masked partial sum whose
    backward it cannot take from a plain partial gradient."""
    w = p["tok"]
    if hasattr(w, "device_mesh"):
        from torch.distributed.tensor import Replicate

        w = w.redistribute(w.device_mesh, [Replicate()] * w.device_mesh.ndim)
    return F.embedding(tokens, w)


def init_lm_head(gen: torch.Generator, cfg) -> dict:
    """``{}`` for tied embeddings, else ``w`` (d_model, vocab)."""
    if cfg.tie_embeddings:
        return {}
    return {"w": param(gen, (cfg.d_model, cfg.vocab_size), dtype_of(cfg.param_dtype))}
