"""The published Zamba2 hybrid (family ``"zamba2"``): Zyphra's Zamba2-7B as
``transformers``' ``Zamba2ForCausalLM`` computes it, trained through
``TransformerLM``. The port's own family: the reference's ``hybrid``
family (one shared block after every ``hybrid_attn_every`` mamba layers) is
a simplification of it and stays as it is.

Write ``e`` for the token embedding (kept from the start) and ``x`` for the
residual stream. Every layer owns a Mamba2 block (``models/mamba2.py``,
its gated norm by B/C group and its dt floored at the published
``time_step_min``); the layers in ``cfg.hybrid_layer_ids`` apply a shared
block before it:

    mamba layer i:   x <- x + Mamba2_i(RMSNorm(x))
    hybrid layer i, application j (shared block j mod num_mem_blocks):
        u  = RMSNorm_2d(concat(x, e))
        a  = Attn(u)       q, k, v 2d -> heads x head_dim, RoPE over the whole
                           head, causal, scores x (head_dim / 2)^-0.5 (A1);
                           o: heads x head_dim -> d
        h  = RMSNorm_d(a)
        gu = h W_gu + B_j (A_j h)           the adapter of application j
        t  = (gelu(gu[:f]) * gu[f:]) W_down  exact (erf) gelu; no residual
        x <- x + Mamba2_i(RMSNorm(x + t W_lin_j))

then a final RMSNorm and the head (tied to the embedding in Zamba2).

Parameters, in ``named_parameters()`` order (sorted keys): ``embed.tok``
(V, d); ``final_norm.w``; ``hybrid.adapter_a`` (A, d, r), ``hybrid.adapter_b``
(A, r, 2f), ``hybrid.linear`` (A, d, d), one each application; ``layers.ln1.w``
(L, d) and ``layers.mamba.*`` (L, ...), every layer's; ``shared.attn.wk``,
``wq``, ``wv`` (M, 2d, H, hd), ``shared.attn.wo`` (M, H, hd, d),
``shared.ln1.w`` (M, 2d), ``shared.ln2.w`` (M, d), ``shared.mlp.down``
(M, f, d), ``shared.mlp.gate_up`` (M, d, 2f), one each shared block. A
shared block's weights get the gradients of every application they serve.

Remat "full" checkpoints each layer: a hybrid layer's shared block and its
mamba block together. Each block's forward opens a span,
``zamba2.mamba_block`` or ``zamba2.shared_block`` (``repro_torch.trace``),
which opens again where remat recomputes it in the backward. Remat "dots",
a step on a ``DeviceMesh`` and serving raise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.models import attention as attn
from repro_torch.models import mamba2
from repro_torch.models.layers import (
    apply_rope,
    dtype_of,
    init_rms_norm,
    param,
    rms_norm,
    rope_angles,
)

FAMILY = "zamba2"
REMATS = ("none", "full")


def unsupported(what: str) -> ValueError:
    return ValueError(f"the {FAMILY!r} model family has no {what}")


def check_config(cfg) -> None:
    """What the family needs of a config; raises ``ValueError``."""
    if cfg.remat not in REMATS:
        raise unsupported(f'remat={cfg.remat!r} (it takes "none" or "full")')
    if cfg.mlp != "gelu_erf":
        raise ValueError(f"the {FAMILY!r} family's MLP is the exact gated gelu, "
                         f'mlp="gelu_erf"; got {cfg.mlp!r}')
    if cfg.num_mem_blocks < 1 or cfg.adapter_rank < 1 or not cfg.hybrid_layer_ids:
        raise ValueError(f"the {FAMILY!r} family needs hybrid_layer_ids, num_mem_blocks and "
                         f"adapter_rank; got {cfg.hybrid_layer_ids}, {cfg.num_mem_blocks}, "
                         f"{cfg.adapter_rank}")
    ids = cfg.hybrid_layer_ids
    if list(ids) != sorted(set(ids)) or ids[0] < 0 or ids[-1] >= cfg.num_layers:
        raise ValueError(f"hybrid_layer_ids must be distinct increasing layers below "
                         f"{cfg.num_layers}; got {ids}")
    if cfg.ssm_d_inner % cfg.ssm_groups or cfg.ssm_heads % cfg.ssm_groups:
        raise ValueError(f"ssm_groups={cfg.ssm_groups} must divide the inner width and heads")


def scale(cfg) -> float:
    """The attention scores' scale, (head_dim / 2)^-0.5: the shared block
    attends over the concatenation of two d-wide streams."""
    return (cfg.resolved_head_dim / 2) ** -0.5


def init_zamba2(cfg, gen: torch.Generator) -> dict:
    """``layers``, ``shared`` and ``hybrid`` of the parameter tree (the
    embedding, final norm and head are ``TransformerLM``'s)."""
    dt, dev = dtype_of(cfg.param_dtype), gen.device
    d, h, hd, f = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim, cfg.d_ff
    m, apps, r = cfg.num_mem_blocks, len(cfg.hybrid_layer_ids), cfg.adapter_rank
    layers = {"ln1": init_rms_norm(d, dt, dev, (cfg.num_layers,)),
              "mamba": mamba2.init_mamba2(gen, cfg, (cfg.num_layers,))}
    out_scale = 0.02 / (2 * cfg.num_layers) ** 0.5
    shared = {
        "attn": {"wk": param(gen, (m, 2 * d, h, hd), dt),
                 "wo": param(gen, (m, h, hd, d), dt, scale=out_scale),
                 "wq": param(gen, (m, 2 * d, h, hd), dt),
                 "wv": param(gen, (m, 2 * d, h, hd), dt)},
        "ln1": init_rms_norm(2 * d, dt, dev, (m,)),
        "ln2": init_rms_norm(d, dt, dev, (m,)),
        "mlp": {"down": param(gen, (m, f, d), dt, scale=out_scale),
                "gate_up": param(gen, (m, d, 2 * f), dt)},
    }
    hybrid = {"adapter_a": param(gen, (apps, d, r), dt),
              "adapter_b": param(gen, (apps, r, 2 * f), dt),
              "linear": param(gen, (apps, d, d), dt, scale=out_scale)}
    return {"layers": layers, "shared": shared, "hybrid": hybrid}


def _mamba(lp: dict, x: torch.Tensor, cfg, added=None) -> torch.Tensor:
    """x + Mamba2(RMSNorm(x [+ added]))."""
    with trace.span("zamba2.mamba_block"):
        y = x if added is None else x + added
        h, _, _ = mamba2.apply_mamba2(lp["mamba"], rms_norm(y, lp["ln1"]["w"], cfg.norm_eps), cfg)
        return x + h


def _shared(sp: dict, hp: dict, x: torch.Tensor, e: torch.Tensor, cfg, angles) -> torch.Tensor:
    """t W_lin_j: the shared block's output for the mamba block after it."""
    with trace.span("zamba2.shared_block"):
        eps, f = cfg.norm_eps, cfg.d_ff
        u = rms_norm(torch.cat([x, e], dim=-1), sp["ln1"]["w"], eps)
        p = sp["attn"]
        q, k, v = (attn._project(u, p[w]) for w in ("wq", "wk", "wv"))
        cos, sin = angles
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        k, v = attn._repeat_kv(k, v, cfg)
        a = attn.chunked_attention(q, k, v, causal=True, q_chunk=cfg.attn_q_chunk,
                                   num_kv_heads=cfg.num_heads, remat_step=cfg.flash_remat,
                                   scale=scale(cfg))
        h = rms_norm(attn._out_proj(a, p["wo"]), sp["ln2"]["w"], eps)
        gu = h @ sp["mlp"]["gate_up"] + (h @ hp["adapter_a"]) @ hp["adapter_b"]
        t = (F.gelu(gu[..., :f]) * gu[..., f:]) @ sp["mlp"]["down"]
        return t @ hp["linear"]


def run_layers(model, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Every layer over the embedded tokens ``x`` (B, S, d), each under the
    model's remat."""
    from repro_torch.models.transformer import unstack

    cfg = model.cfg
    e = x
    angles = rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
    shared, hybrid = unstack(model.shared), unstack(model.hybrid)
    app = {layer: j for j, layer in enumerate(cfg.hybrid_layer_ids)}

    def hybrid_layer(y, emb, lp, sp, hp):
        return _mamba(lp, y, cfg, _shared(sp, hp, y, emb, cfg, angles))

    for i, lp in enumerate(unstack(model.layers)):
        if i in app:
            j = app[i]
            x = model._remat(hybrid_layer, x, e, lp, shared[j % cfg.num_mem_blocks], hybrid[j])
        else:
            x = model._remat(lambda y, lp=lp: _mamba(lp, y, cfg), x)
    return x
