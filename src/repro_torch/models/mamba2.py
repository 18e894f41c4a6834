"""Mamba2 (SSD, state-space duality) block: the chunked training scan and the
recurrent decode (torch port of ``repro.models.mamba2``).

Discrete SSD (Dao & Gu, 2024):
    h_t = exp(dt_t * A) h_{t-1} + dt_t * (B_t x_t)
    y_t = C_t . h_t + D * x_t
Training and prefill use the chunked decomposition: the exact quadratic
term within a chunk, the chunk-final states, the recurrence over chunks
(the reference's ``lax.scan``) and the inter-chunk term, in S1 on the card
and in its plain version ``kernels/ssd.py::ssd_chunked_ref`` on the CPU.
All state math is float32 (dt * A <= 0, so every exp is at most 1).
``_segsum`` masks with -inf BEFORE the exp, so the backward never sees
inf * 0.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.ssd import SSDChunked, _segsum, chunk_len, ssd_chunked_ref  # noqa: F401
from repro_torch.models.layers import dtype_of, param, rms_norm, silu, unread_product


ZAMBA2_DT_MIN = 1e-3  # Zamba2-7B's time_step_min: the floor of its softplus(dt)


def init_mamba2(gen: torch.Generator, cfg, lead=()) -> dict:
    """in_proj emits [z (di), x (di), B (g*n), C (g*n), dt (h)]. Float32
    leaves ``a_log``, ``d_skip``, ``dt_bias`` in a model of any dtype;
    sorted keys."""
    d, di, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_heads
    g, n, w = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv_width
    dt = dtype_of(cfg.param_dtype)
    dev = gen.device
    conv_ch = di + 2 * g * n
    in_proj = param(gen, (*lead, d, 2 * di + 2 * g * n + h), dt)
    conv_w = param(gen, (*lead, w, conv_ch), dt, scale=0.1)
    out_proj = param(gen, (*lead, di, d), dt, scale=0.02 / math.sqrt(2 * cfg.num_layers))
    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32, device=dev))
    return {
        "a_log": a_log.expand(*lead, h).clone(),
        "conv_b": torch.zeros((*lead, conv_ch), dtype=dt, device=dev),
        "conv_w": conv_w,
        "d_skip": torch.ones((*lead, h), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((*lead, h), dtype=torch.float32, device=dev),
        "in_proj": in_proj,
        "norm_w": torch.ones((*lead, di), dtype=dt, device=dev),
        "out_proj": out_proj,
    }


def _split_proj(cfg, proj: torch.Tensor):
    di, g, n = cfg.ssm_d_inner, cfg.ssm_groups, cfg.ssm_state
    return proj[..., :di], proj[..., di:2 * di + 2 * g * n], proj[..., 2 * di + 2 * g * n:]


def _causal_conv_train(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """xbc: (B, S, C); depthwise causal conv of width ``w.shape[0]``."""
    width, s = w.shape[0], xbc.shape[1]
    pad = torch.nn.functional.pad(xbc, (0, 0, width - 1, 0))
    out = sum(pad[:, i:i + s] * w[i] for i in range(width))
    return silu(out + b)


def ssd_chunked(x, dt, a, bmat, cmat, d_skip, chunk: int):
    """SSD forward (the reference's ``ssd_chunked``).

    x: (B, S, H, P); dt: (B, S, H) float32 (> 0, after softplus); a: (H,)
    (< 0); bmat/cmat: (B, S, G, N); d_skip: (H,). Returns y (B, S, H, P) in
    x's dtype and the final state (B, H, P, N) float32. CUDA tensors run S1
    (``kernels/ssd.py``, or raise); CPU tensors the plain version
    ``ssd_chunked_ref``."""
    if x.is_cuda:
        return SSDChunked.apply(x, dt, a, bmat, cmat, d_skip, chunk)
    return ssd_chunked_ref(x, dt, a, bmat, cmat, d_skip, chunk)


def apply_mamba2(p: dict, x: torch.Tensor, cfg, ssm_state=None, conv_state=None,
                 decode: bool = False):
    """The whole block. Train / prefill (``decode=False``): x (B, S, d).
    Decode: x (B, 1, d) with ``ssm_state`` (B, H, P, N) and ``conv_state``
    (B, w - 1, C) carried. Returns (y, new ssm state, new conv state); the
    conv state of a prompt shorter than w - 1 tokens is None, as in the
    reference.

    A DTensor ``x`` (a step on a mesh) runs the block whole on every rank
    of the mesh's non-batch axes: the weights are gathered and the block
    runs on local tensors (its projection splits and scan have no DTensor
    rules that keep them sharded), so the mamba blocks are not tensor
    parallel in the port."""
    if hasattr(x, "device_mesh"):
        from torch.distributed.tensor import DTensor, Replicate

        mesh = x.device_mesh
        rows = [p_ if getattr(p_, "dim", None) == 0 else Replicate() for p_ in x.placements]

        def whole(t):  # a weight or carried state, gathered whole
            return t.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()

        local = {k: whole(v) for k, v in p.items()}
        carried = [whole(t) if hasattr(t, "device_mesh") else t for t in (ssm_state, conv_state)]
        y, state, conv = apply_mamba2(local, x.redistribute(mesh, rows).to_local(), cfg,
                                      *carried, decode)
        # new states in the carried states' layout (a sharded serving cache)
        state, conv = (t if t is None or not hasattr(c, "device_mesh") else
                       DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
                       .redistribute(mesh, c.placements)
                       for t, c in ((state, ssm_state), (conv, conv_state)))
        return DTensor.from_local(y, mesh, rows, run_check=False), state, conv
    di, g, n, h = cfg.ssm_d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    pdim, width = cfg.ssm_head_dim, cfg.ssm_conv_width

    proj = x @ p["in_proj"]
    z, xbc_in, dt_raw = _split_proj(cfg, proj)
    a = -torch.exp(p["a_log"])
    dt_in = dt_raw.to(torch.float32) + p["dt_bias"]
    dt = torch.logaddexp(dt_in, torch.zeros_like(dt_in))           # jax.nn.softplus
    if cfg.family == "zamba2":  # the published Zamba2's time_step_min
        dt = torch.clamp(dt, min=ZAMBA2_DT_MIN)

    if not decode:
        xbc = _causal_conv_train(xbc_in, p["conv_w"], p["conv_b"])
        new_conv = xbc_in[:, -(width - 1):] if xbc_in.shape[1] >= width - 1 else None
        bsz, s = xbc.shape[:2]
        xs = xbc[..., :di]
        bmat = xbc[..., di:di + g * n].reshape(bsz, s, g, n)
        cmat = xbc[..., di + g * n:].reshape(bsz, s, g, n)
        y, final_state = ssd_chunked(xs.reshape(bsz, s, h, pdim), dt, a, bmat, cmat,
                                     p["d_skip"], cfg.ssm_chunk)
        y = y.reshape(bsz, s, di)
    else:
        # one step of the recurrence
        cs = torch.cat([conv_state, xbc_in], dim=1)                 # (B, w, C)
        xbc = silu(torch.einsum("bwc,wc->bc", cs, p["conv_w"]) + p["conv_b"])[:, None]
        new_conv = cs[:, 1:]
        bsz = xbc.shape[0]
        xs = xbc[..., :di]
        bmat = xbc[..., di:di + g * n].reshape(bsz, g, n).to(torch.float32)
        cmat = xbc[..., di + g * n:].reshape(bsz, g, n).to(torch.float32)
        xh = xs.reshape(bsz, h, pdim).to(torch.float32)
        dt1 = dt[:, 0]                                               # (B, H)
        da = torch.exp(dt1 * a)
        hg = h // g
        bfull = bmat.repeat_interleave(hg, dim=1)                    # (B, H, N)
        cfull = cmat.repeat_interleave(hg, dim=1)
        upd = torch.einsum("bh,bhp,bhs->bhps", dt1, xh, bfull)
        final_state = ssm_state * da[:, :, None, None] + upd
        yh = torch.einsum("bhs,bhps->bhp", cfull, final_state) + xh * p["d_skip"][None, :, None]
        y = yh.reshape(bsz, 1, di).to(x.dtype)

    # gated RMSNorm, then the output projection
    y = gated_norm(y, z, p["norm_w"], cfg)
    return unread_product(y, p["out_proj"]), final_state, new_conv


def gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor, cfg) -> torch.Tensor:
    """RMSNorm of ``y * silu(z)`` over the whole inner width, as the
    reference's mamba2; the zamba2 family normalises each B/C group's
    ``d_inner / ssm_groups`` channels on its own, as the published Zamba2
    (``Zamba2RMSNormGated``, ``group_size = d_inner / n_groups``)."""
    g = y * silu(z)
    groups = cfg.ssm_groups if cfg.family == "zamba2" else 1
    if groups == 1:
        return rms_norm(g, w, cfg.norm_eps)
    return rms_norm(g.unflatten(-1, (groups, -1)), w.unflatten(-1, (groups, -1)),
                    cfg.norm_eps).flatten(-2)


def init_ssm_state(batch: int, cfg, device=None):
    """Zeroed (ssm (B, H, P, N) float32, conv (B, w - 1, C) activation
    dtype)."""
    conv_ch = cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return (torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                        dtype=torch.float32, device=device),
            torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch),
                        dtype=dtype_of(cfg.activation_dtype), device=device))
