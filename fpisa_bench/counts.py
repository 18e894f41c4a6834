"""The yardstick's arithmetic: the chip's peaks, and the operations and bytes
that each kernel and each step must do at a cell's shapes.

Frozen copies. ``a1_work`` and the K1/K2/K6 bytes per element are taken
from ``chip_smoke.py`` (``a1_work``, the ``[time]`` lines' bytes per
element of each mode) as of commit e482e26; the training flop count is the
benchmark's own. A later change to the kernels does not change these
counts: they say what the work is, not how a kernel does it.
"""
from __future__ import annotations

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}

# NVIDIA H100 SXM (80 GB HBM3) data sheet
PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12  # B/s


def a1_work(b: int, s: int, sk: int, h: int, hd: int, causal: bool, itemsize: int):
    """What one A1 call must do: (forward flops, forward bytes, backward
    flops, backward bytes). Flops count the (query, key) pairs the mask
    keeps (causal: S (S + 1) / 2), 4 hd per pair forward (QK^T and PV), 10 hd
    backward (the scores again, dP, dV, dQ, dK); bytes read each input once
    and write each output once (forward: q, k, v in, out and the per-row m
    and l out; backward: q, k, v, out, dout, m, l in, dq, dk, dv out)."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * sk)
    q_bytes, kv_bytes, stats = b * s * h * hd * itemsize, b * sk * h * hd * itemsize, b * h * s * 4
    fwd_bytes = 2 * q_bytes + 2 * kv_bytes + 2 * stats
    bwd_bytes = 3 * q_bytes + 2 * kv_bytes + 2 * stats + q_bytes + 2 * kv_bytes
    return 4 * hd * pairs, fwd_bytes, 10 * hd * pairs, bwd_bytes


def a1_bound_s(b: int, s: int, h: int, hd: int, itemsize: int, fwd: int, bwd: int) -> float:
    """The least time ``fwd`` forward and ``bwd`` backward causal self-
    attention calls at one shape can take: each call's flops at the bf16
    peak or its bytes at the memory rate, whichever is larger."""
    ff, fb, bf, bb = a1_work(b, s, s, h, hd, True, itemsize)
    return (fwd * max(ff / PEAK_FLOPS_BF16, fb / HBM_BYTES_PER_S)
            + bwd * max(bf / PEAK_FLOPS_BF16, bb / HBM_BYTES_PER_S))


def fpisa_bytes_per_elem(workers: int, itemsize: int, wire_bytes: int = 4) -> int:
    """Bytes per element of the FPISA aggregation's kernels on a stack of
    ``workers`` leaves of ``itemsize`` bytes, decoded into the leaf's dtype:
    K1's exponent mode reads the stack (2 k at bf16), its wire mode reads it
    again and writes the int32 wire plane (2 k + 4), K2 reads the plane and
    writes the leaf (6 into bf16). The per-block exponents (one int32 per
    256 elements) are left out, as ``chip_smoke.py`` leaves them out."""
    exponent = workers * itemsize
    wire = workers * itemsize + wire_bytes
    decode = wire_bytes + itemsize
    return exponent + wire + decode


def k6_leaf_bytes_per_elem(workers: int, itemsize: int) -> int:
    """K6's leaf mode: the (W, ...) stack in, the leaf out, in the leaf's
    dtype (2 W + 2 at bf16)."""
    return workers * itemsize + itemsize


def dense_matmul_params(d: int, heads: int, kv_heads: int, hd: int, d_ff: int, layers: int,
                        vocab: int, gated: bool = True) -> int:
    """Parameters that enter a matrix product in a dense decoder: the
    q, k, v, o projections, the MLP (three matrices when gated), and the
    output head (tied or not, it is a product). The embedding lookup, the
    norms and the biases are not products."""
    attn = d * heads * hd * 2 + d * kv_heads * hd * 2
    mlp = d * d_ff * (3 if gated else 2)
    return layers * (attn + mlp) + d * vocab


def dense_train_flops_per_token(d: int, heads: int, kv_heads: int, hd: int, d_ff: int,
                                layers: int, vocab: int, seq: int, gated: bool = True) -> float:
    """Forward and backward flops a token costs in training (recompute not
    counted): 6 per matrix-product parameter, and causal attention's
    4 hd per kept (query, key) pair forward, 3 x that with the backward, per
    head and layer, spread over the sequence's tokens."""
    params = dense_matmul_params(d, heads, kv_heads, hd, d_ff, layers, vocab, gated)
    pairs_per_token = (seq + 1) / 2
    attention = 3 * 4 * hd * heads * layers * pairs_per_token
    return 6 * params + attention
