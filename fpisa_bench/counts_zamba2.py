"""The yardstick's training flop count of the Zamba2 hybrid (the
``zamba2_7b`` configuration's published keys): what a token costs in
forward and backward, recompute not counted.

Frozen: it says what the work is, not how a kernel does it.
- 6 flops per matrix-product parameter per token: every layer's Mamba2
  ``in_proj`` and ``out_proj``; each shared-block application counted
  again (q, k, v over the 2d-wide concatenation, o, gate/up, down), with its
  own adapter (A_j, B_j) and ``W_lin_j``; the head tied to the embedding
  (a product all the same). The embedding lookup, the norms, the
  convolution, biases and per-head scalars are not products.
- Attention: 12 hd per kept (query, key) pair per head per application
  (4 hd forward, 3 x that with the backward), (S + 1) / 2 pairs a token.
- The SSD's chunked contractions per layer, 3 x the forward's: within a
  chunk of Q tokens, C B^T per group (2 N) and the decay-weighted sum of
  x per head (2 P) over the (Q + 1) / 2 kept pairs a token; the state
  leaving the chunk and the entering state's contribution, 2 N P per head
  each a token.
"""
from __future__ import annotations


def matmul_params(cfg: dict) -> int:
    """Matrix-product parameters a token passes through (shared blocks once
    per application)."""
    d, f = cfg["hidden_size"], cfg["ffn_hidden_size"]
    heads, hd, r = cfg["num_attention_heads"], cfg["attention_head_dim"], cfg["adapter_rank"]
    di = cfg["mamba_expand"] * d
    g, n = cfg["mamba_ngroups"], cfg["mamba_d_state"]
    ssm_heads = di // cfg["mamba_headdim"]
    mamba = d * (2 * di + 2 * g * n + ssm_heads) + di * d
    shared = 3 * (2 * d) * heads * hd + heads * hd * d + d * 2 * f + f * d
    application = shared + d * r + r * 2 * f + d * d
    return (cfg["num_hidden_layers"] * mamba + len(cfg["hybrid_layer_ids"]) * application
            + d * cfg["vocab_size"])


def ssd_flops_per_token(cfg: dict) -> float:
    """One layer's SSD contractions, forward, a token."""
    d = cfg["hidden_size"]
    di = cfg["mamba_expand"] * d
    p, g, n, q = cfg["mamba_headdim"], cfg["mamba_ngroups"], cfg["mamba_d_state"], cfg["chunk_size"]
    h = di // p
    pairs = (q + 1) / 2
    return 2 * n * g * pairs + 2 * p * h * pairs + 2 * (2 * n * p * h)


def train_flops_per_token(cfg: dict, seq: int) -> float:
    """Forward and backward flops a token costs in training at sequence
    length ``seq``."""
    attention = (12 * cfg["attention_head_dim"] * cfg["num_attention_heads"]
                 * len(cfg["hybrid_layer_ids"]) * (seq + 1) / 2)
    ssd = 3 * cfg["num_hidden_layers"] * ssd_flops_per_token(cfg)
    return 6 * matmul_params(cfg) + attention + ssd
