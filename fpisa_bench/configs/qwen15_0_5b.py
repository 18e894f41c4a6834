"""Plain reference of qwen1.5-0.5b (the qwen2 architecture): a decoder of
RMSNorm, self-attention with q/k/v biases and rotary positions, and a
SwiGLU MLP, with the output head tied to the token embedding; the loss is
the mean next-token negative log-likelihood.

Plain torch in float32 (matrix products with TF32 off), written from the
published architecture and independent of the program. It takes the
parameters by the program's leaf names and layouts (every per-layer weight
stacked over the layers; ``wq`` is (L, d, H, hd)), which is how the
benchmark hands the same weights to both. ``mm`` computes every matrix
product, so the control can run the same function at a lower precision.

To fit one card at 4 x 4,096 tokens, each layer is checkpointed, attention
runs over 512 query rows at a time against the keys up to them, and the
head and loss over 4,096 rows at a time: the order of the work, not its
arithmetic.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Q_BLOCK = 512
HEAD_ROWS = 4096

LAYER_LEAVES = ("attn.bk", "attn.bq", "attn.bv", "attn.wk", "attn.wo", "attn.wq", "attn.wv",
                "ln1.w", "ln2.w", "mlp.wg", "mlp.wi", "mlp.wo")


def dims(cfg: dict):
    d, h, k = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    return d, h, k, d // h, cfg["intermediate_size"], cfg["num_hidden_layers"], cfg["vocab_size"]


def param_spec(cfg: dict) -> list:
    """[(leaf name, shape, init)] in the program's leaf order; init is
    ("normal", std), ("ones",) or ("zeros",), as the published checkpoint
    is initialised (``initializer_range``)."""
    d, h, k, hd, f, layers, vocab = dims(cfg)
    std = ("normal", cfg["initializer_range"])
    shapes = {"attn.bk": ((k, hd), ("zeros",)), "attn.bq": ((h, hd), ("zeros",)),
              "attn.bv": ((k, hd), ("zeros",)), "attn.wk": ((d, k, hd), std),
              "attn.wo": ((h, hd, d), std), "attn.wq": ((d, h, hd), std),
              "attn.wv": ((d, k, hd), std), "ln1.w": ((d,), ("ones",)),
              "ln2.w": ((d,), ("ones",)), "mlp.wg": ((d, f), std), "mlp.wi": ((d, f), std),
              "mlp.wo": ((f, d), std)}
    spec = [("embed.tok", (vocab, d), std), ("final_norm.w", (d,), ("ones",))]
    spec += [(f"layers.{n}", (layers, *shapes[n][0]), shapes[n][1]) for n in LAYER_LEAVES]
    return spec


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _rope(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, mm):
    """Causal softmax attention, (B, S, H, hd) each; 512 query rows at a
    time against the keys up to their last row."""
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    s, hd = q.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(hd)
    pos = torch.arange(s, device=q.device)
    outs = []
    for s0 in range(0, s, Q_BLOCK):
        e = min(s, s0 + Q_BLOCK)
        scores = mm(q[:, :, s0:e], k[:, :, :e].transpose(-1, -2)) * scale
        masked = pos[None, :e] > pos[s0:e, None]
        p = torch.softmax(scores.masked_fill(masked, float("-inf")), dim=-1)
        outs.append(mm(p, v[:, :, :e]))
    return torch.cat(outs, dim=2).transpose(1, 2)


def _block(cfg, mm, cos, sin, x, *ws):
    d, h, kh, hd, f, _, _ = dims(cfg)
    eps = cfg["rms_norm_eps"]
    p = dict(zip(LAYER_LEAVES, ws))
    b, s, _ = x.shape
    y = _rms(x, p["ln1.w"], eps)
    q = mm(y, p["attn.wq"].reshape(d, h * hd)).view(b, s, h, hd) + p["attn.bq"]
    k = mm(y, p["attn.wk"].reshape(d, kh * hd)).view(b, s, kh, hd) + p["attn.bk"]
    v = mm(y, p["attn.wv"].reshape(d, kh * hd)).view(b, s, kh, hd) + p["attn.bv"]
    q, k = _rope(q, cos, sin), _rope(k, cos, sin)
    if kh != h:
        k, v = k.repeat_interleave(h // kh, dim=2), v.repeat_interleave(h // kh, dim=2)
    a = _attention(q, k, v, mm)
    x = x + mm(a.reshape(b, s, h * hd), p["attn.wo"].reshape(h * hd, d))
    y = _rms(x, p["ln2.w"], eps)
    return x + mm(F.silu(mm(y, p["mlp.wg"])) * mm(y, p["mlp.wi"]), p["mlp.wo"])


def _nll_sum(mm, x, w, targets):
    logits = mm(x, w.T)
    return -torch.log_softmax(logits, dim=-1).gather(-1, targets[:, None]).sum()


def loss(params: dict, tokens: torch.Tensor, cfg: dict, mm=torch.matmul) -> torch.Tensor:
    """Mean next-token NLL of ``tokens`` (B, S); ``params`` float32 leaves
    by name."""
    d, h, _, hd, _, _, _ = dims(cfg)
    b, s = tokens.shape
    tok = params["embed.tok"]
    x = tok[tokens.long()]
    half = hd // 2
    freqs = torch.exp(-math.log(cfg["rope_theta"]) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    per_layer = zip(*(params[f"layers.{n}"].unbind(0) for n in LAYER_LEAVES))
    for ws in per_layer:
        x = checkpoint(_block, cfg, mm, cos, sin, x, *ws, use_reentrant=False)
    x = _rms(x, params["final_norm.w"], cfg["rms_norm_eps"])
    rows = x[:, :-1].reshape(-1, d)
    targets = tokens[:, 1:].reshape(-1).long()
    total = rows.new_zeros(())
    for r0 in range(0, rows.shape[0], HEAD_ROWS):
        total = total + checkpoint(_nll_sum, mm, rows[r0:r0 + HEAD_ROWS], tok,
                                   targets[r0:r0 + HEAD_ROWS], use_reentrant=False)
    return total / rows.shape[0]
