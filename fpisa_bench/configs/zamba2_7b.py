"""Plain reference of Zamba2-7B (Zyphra's published hybrid, ``transformers``'
``Zamba2ForCausalLM``): Mamba2 layers, and before the layers of
``hybrid_layer_ids`` one of ``num_mem_blocks`` shared attention + MLP blocks
over the concatenation of the residual stream and the token embedding; a
final RMSNorm and the head tied to the embedding; the loss is the mean
next-token negative log-likelihood.

With ``e`` the token embedding and ``x`` the residual stream:

    mamba layer i:   x <- x + Mamba2_i(RMSNorm(x))
    hybrid layer i, application j (shared block j mod num_mem_blocks):
        u  = RMSNorm(concat(x, e)); a = Attn(u); h = RMSNorm(a)
        gu = h W_gu + B_j (A_j h); t = (gelu(gu[:f]) * gu[f:]) W_down
        x <- x + Mamba2_i(RMSNorm(x + t W_lin_j))

Attention: q, k, v from the 2d-wide ``u``, RoPE over the whole head (theta
``rope_theta``), causal softmax of the scores times (head_dim / 2)^-0.5.
Mamba2: ``in_proj`` gives z, xBC and dt; xBC through a causal depthwise
convolution and silu; dt = max(softplus(dt + dt_bias), time_step_min);
A = -exp(a_log); the chunked SSD equations, one chunk of ``chunk_size``
tokens after another with the state carried between them (within a chunk
the exact quadratic form, then the entering state's contribution and the
state leaving it); y + D x; the gated RMSNorm by B/C group
(``d_inner / mamba_ngroups`` channels each); ``out_proj``.

Plain torch in float32 (matrix products with TF32 off), written from the
published architecture and independent of the program. It takes the
parameters by the program's leaf names and layouts (every layer's Mamba2
weights stacked over the layers, ``shared.*`` over the shared blocks,
``hybrid.*`` over the applications; ``wq`` is (M, 2d, H, hd)), which is how
the benchmark hands the same weights to both. ``mm`` computes every matrix
product, the SSD's contractions among them, so the control can run the same
function at a lower precision.

To fit one card at 4 x 4,096 tokens, each layer is checkpointed, attention
runs over 512 query rows at a time against the keys up to them, each
query block and each SSD chunk is checkpointed again inside its layer, and
the head and loss run over 4,096 rows at a time: the order of the work, not
its arithmetic. Departures from the published model: none in what is
computed; its weight initialisation is the benchmark's (``param_spec``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Q_BLOCK = 512
HEAD_ROWS = 4096

MAMBA_LEAVES = ("a_log", "conv_b", "conv_w", "d_skip", "dt_bias", "in_proj", "norm_w",
                "out_proj")
SHARED_LEAVES = ("attn.wk", "attn.wo", "attn.wq", "attn.wv", "ln1.w", "ln2.w", "mlp.down",
                 "mlp.gate_up")
HYBRID_LEAVES = ("adapter_a", "adapter_b", "linear")


def dims(cfg: dict) -> dict:
    """The sizes the reference reads from the published configuration."""
    d = cfg["hidden_size"]
    di = cfg["mamba_expand"] * d
    p, g, n = cfg["mamba_headdim"], cfg["mamba_ngroups"], cfg["mamba_d_state"]
    return {"d": d, "heads": cfg["num_attention_heads"], "hd": cfg["attention_head_dim"],
            "f": cfg["ffn_hidden_size"], "vocab": cfg["vocab_size"],
            "layers": cfg["num_hidden_layers"], "apps": len(cfg["hybrid_layer_ids"]),
            "blocks": cfg["num_mem_blocks"], "rank": cfg["adapter_rank"], "di": di,
            "ssm_heads": di // p, "p": p, "g": g, "n": n, "conv": cfg["mamba_d_conv"],
            "chunk": cfg["chunk_size"], "conv_ch": di + 2 * g * n}


def param_spec(cfg: dict) -> list:
    """[(leaf name, shape, init)] in the program's leaf order; init is
    ("normal", std), ("ones",) or ("zeros",). Matrices draw from
    ``initializer_range``; norms and ``d_skip`` are ones; ``a_log``,
    ``dt_bias`` and ``conv_b`` zeros (so A = -1 and dt = softplus of the
    projection)."""
    z = dims(cfg)
    d, h, hd, f, r = z["d"], z["heads"], z["hd"], z["f"], z["rank"]
    L, M, A = z["layers"], z["blocks"], z["apps"]
    std = ("normal", cfg["initializer_range"])
    mamba = {"a_log": ((z["ssm_heads"],), ("zeros",)), "conv_b": ((z["conv_ch"],), ("zeros",)),
             "conv_w": ((z["conv"], z["conv_ch"]), std), "d_skip": ((z["ssm_heads"],), ("ones",)),
             "dt_bias": ((z["ssm_heads"],), ("zeros",)),
             "in_proj": ((d, 2 * z["di"] + 2 * z["g"] * z["n"] + z["ssm_heads"]), std),
             "norm_w": ((z["di"],), ("ones",)), "out_proj": ((z["di"], d), std)}
    shared = {"attn.wk": ((2 * d, h, hd), std), "attn.wo": ((h, hd, d), std),
              "attn.wq": ((2 * d, h, hd), std), "attn.wv": ((2 * d, h, hd), std),
              "ln1.w": ((2 * d,), ("ones",)), "ln2.w": ((d,), ("ones",)),
              "mlp.down": ((f, d), std), "mlp.gate_up": ((d, 2 * f), std)}
    hybrid = {"adapter_a": ((d, r), std), "adapter_b": ((r, 2 * f), std), "linear": ((d, d), std)}
    spec = [("embed.tok", (z["vocab"], d), std), ("final_norm.w", (d,), ("ones",))]
    spec += [(f"hybrid.{k}", (A, *hybrid[k][0]), hybrid[k][1]) for k in HYBRID_LEAVES]
    spec += [("layers.ln1.w", (L, d), ("ones",))]
    spec += [(f"layers.mamba.{k}", (L, *mamba[k][0]), mamba[k][1]) for k in MAMBA_LEAVES]
    spec += [(f"shared.{k}", (M, *shared[k][0]), shared[k][1]) for k in SHARED_LEAVES]
    return spec


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _rope(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attn_block(q, k, v, s0, scale, mm):
    """Rows s0 .. s0 + len(q) of causal attention, (B, H, rows, hd) against
    the keys up to the last row."""
    e = s0 + q.shape[2]
    scores = mm(q, k[:, :, :e].transpose(-1, -2)) * scale
    pos = torch.arange(e, device=q.device)
    masked = pos[None, :] > pos[s0:e, None]
    p = torch.softmax(scores.masked_fill(masked, float("-inf")), dim=-1)
    return mm(p, v[:, :, :e])


def _attention(q, k, v, scale, mm):
    """(B, S, H, hd) each -> (B, S, H, hd), 512 query rows at a time."""
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    outs = [checkpoint(_attn_block, q[:, :, s0:s0 + Q_BLOCK], k, v, s0, scale, mm,
                       use_reentrant=False) for s0 in range(0, q.shape[2], Q_BLOCK)]
    return torch.cat(outs, dim=2).transpose(1, 2)


def _ssd_chunk(x, dt, a, bm, cm, state, mm):
    """One chunk: x (B, Q, H, P), dt (B, Q, H), a (H,), bm and cm (B, Q, H,
    N) (each head its group's), state (B, H, N, P) entering -> (y (B, Q, H,
    P) without the skip, the state leaving)."""
    da = (dt * a).transpose(1, 2)                          # (B, H, Q), <= 0
    cs = torch.cumsum(da, dim=-1)
    q = x.shape[1]
    keep = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp((cs[..., :, None] - cs[..., None, :]).masked_fill(~keep, float("-inf")))
    b_, c_ = bm.transpose(1, 2), cm.transpose(1, 2)        # (B, H, Q, N)
    xdt = (x * dt[..., None]).transpose(1, 2)              # (B, H, Q, P)
    y = mm(decay * mm(c_, b_.transpose(-1, -2)), xdt)      # within the chunk
    y = y + torch.exp(cs)[..., None] * mm(c_, state)       # from the entering state
    to_end = torch.exp(cs[..., -1:] - cs)                  # (B, H, Q)
    state = state * torch.exp(cs[..., -1])[..., None, None] + mm(
        (b_ * to_end[..., None]).transpose(-1, -2), xdt)
    return y.transpose(1, 2), state


def _mamba2(cfg, mm, u, w):
    """The Mamba2 mixer on normed ``u`` (B, S, d)."""
    z = dims(cfg)
    di, g, n, h, p = z["di"], z["g"], z["n"], z["ssm_heads"], z["p"]
    b, s, _ = u.shape
    proj = mm(u, w["in_proj"])
    gate, xbc, dt = proj[..., :di], proj[..., di:2 * di + 2 * g * n], proj[..., 2 * di + 2 * g * n:]
    width = w["conv_w"].shape[0]
    padded = F.pad(xbc, (0, 0, width - 1, 0))
    xbc = F.silu(sum(padded[:, i:i + s] * w["conv_w"][i] for i in range(width)) + w["conv_b"])
    xs = xbc[..., :di].reshape(b, s, h, p)
    bm = xbc[..., di:di + g * n].reshape(b, s, g, n).repeat_interleave(h // g, dim=2)
    cm = xbc[..., di + g * n:].reshape(b, s, g, n).repeat_interleave(h // g, dim=2)
    dt = torch.clamp(F.softplus(dt + w["dt_bias"]), min=cfg["time_step_min"])
    a = -torch.exp(w["a_log"])
    state = u.new_zeros((b, h, n, p))
    ys = []
    for c0 in range(0, s, z["chunk"]):
        c = slice(c0, c0 + z["chunk"])
        y, state = checkpoint(_ssd_chunk, xs[:, c], dt[:, c], a, bm[:, c], cm[:, c], state, mm,
                              use_reentrant=False)
        ys.append(y)
    y = torch.cat(ys, dim=1) + xs * w["d_skip"][:, None]
    gated = (y.reshape(b, s, di) * F.silu(gate)).unflatten(-1, (g, di // g))
    gated = gated * torch.rsqrt(gated.square().mean(-1, keepdim=True) + cfg["rms_norm_eps"])
    return mm(gated.flatten(-2) * w["norm_w"], w["out_proj"])


def _mamba_layer(cfg, mm, x, w, added=None):
    y = x if added is None else x + added
    return x + _mamba2(cfg, mm, _rms(y, w["ln1.w"], cfg["rms_norm_eps"]), w)


def _shared_block(cfg, mm, cos, sin, x, e, sw, hw):
    """t W_lin_j of application j (shared weights ``sw``, its own ``hw``)."""
    z = dims(cfg)
    d, h, hd, f = z["d"], z["heads"], z["hd"], z["f"]
    eps = cfg["rms_norm_eps"]
    b, s, _ = x.shape
    u = _rms(torch.cat([x, e], dim=-1), sw["ln1.w"], eps)
    q, k, v = (mm(u, sw[f"attn.{n}"].reshape(2 * d, h * hd)).view(b, s, h, hd)
               for n in ("wq", "wk", "wv"))
    q, k = _rope(q, cos, sin), _rope(k, cos, sin)
    a = _attention(q, k, v, (hd / 2) ** -0.5, mm)
    hn = _rms(mm(a.reshape(b, s, h * hd), sw["attn.wo"].reshape(h * hd, d)), sw["ln2.w"], eps)
    gu = mm(hn, sw["mlp.gate_up"]) + mm(mm(hn, hw["adapter_a"]), hw["adapter_b"])
    t = mm(F.gelu(gu[..., :f]) * gu[..., f:], sw["mlp.down"])
    return mm(t, hw["linear"])


def _hybrid_layer(cfg, mm, cos, sin, x, e, w, sw, hw):
    return _mamba_layer(cfg, mm, x, w, _shared_block(cfg, mm, cos, sin, x, e, sw, hw))


def _nll_sum(mm, x, w, targets):
    logits = mm(x, w.T)
    return -torch.log_softmax(logits, dim=-1).gather(-1, targets[:, None]).sum()


def loss(params: dict, tokens: torch.Tensor, cfg: dict, mm=torch.matmul) -> torch.Tensor:
    """Mean next-token NLL of ``tokens`` (B, S); ``params`` float32 leaves
    by name. Sets TF32 off: float32 products in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    z = dims(cfg)
    b, s = tokens.shape
    tok = params["embed.tok"]
    x = tok[tokens.long()]
    e = x
    half = z["hd"] // 2
    freqs = torch.exp(-math.log(cfg["rope_theta"]) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]

    def per(prefix, names):
        return [dict(zip(names, ws)) for ws in zip(*(params[f"{prefix}.{n}"].unbind(0)
                                                      for n in names))]

    layers = per("layers", ("ln1.w",) + tuple(f"mamba.{n}" for n in MAMBA_LEAVES))
    layers = [{k.removeprefix("mamba."): v for k, v in w.items()} for w in layers]
    shared, hybrid = per("shared", SHARED_LEAVES), per("hybrid", HYBRID_LEAVES)
    app = {layer: j for j, layer in enumerate(cfg["hybrid_layer_ids"])}
    for i, w in enumerate(layers):
        if i in app:
            j = app[i]
            x = checkpoint(_hybrid_layer, cfg, mm, cos, sin, x, e, w, shared[j % z["blocks"]],
                           hybrid[j], use_reentrant=False)
        else:
            x = checkpoint(_mamba_layer, cfg, mm, x, w, use_reentrant=False)
    x = _rms(x, params["final_norm.w"], cfg["rms_norm_eps"])
    rows = x[:, :-1].reshape(-1, z["d"])
    targets = tokens[:, 1:].reshape(-1).long()
    total = rows.new_zeros(())
    for r0 in range(0, rows.shape[0], HEAD_ROWS):
        total = total + checkpoint(_nll_sum, mm, rows[r0:r0 + HEAD_ROWS], tok,
                                   targets[r0:r0 + HEAD_ROWS], use_reentrant=False)
    return total / rows.shape[0]
