"""Plain FPISA aggregation in the fp32 format, the semantics the benchmark
holds the program's aggregation to.

A frozen copy of the plain path of ``src/repro_torch/core/fpisa.py``
(``encode``, ``renormalize``, ``block_decode``) and ``core/allreduce.py``
(``stacked_fpisa_allreduce`` with a 32-bit wire) as of commit e482e26,
rewritten on int64 tensors: each element's mantissa, with its implied 1
and its sign, is aligned to its block's exponent maxed over the workers
(a right shift that rounds toward -inf, after the worker-count preshift),
the workers' integers are summed, and the sum is renormalized once to
float32 (arithmetic shifts, so toward -inf; exponent overflow to inf,
underflow to zero). Denormals flush to zero and NaN/inf clamp to the
largest finite value. The caller casts the float32 result to the leaf's
dtype (round to nearest even).
"""
from __future__ import annotations

import math

import torch

MAN_BITS = 23
EXP_MAX = 255
HEADROOM = 31 - (MAN_BITS + 1)
BLOCK = 256
CHUNK = 1 << 24  # elements of one worker handled at a time


def preshift(workers: int) -> int:
    """Right shift that keeps a ``workers``-way int32 sum from overflowing."""
    return max(0, math.ceil(math.log2(max(workers, 1))) - HEADROOM)


def _encode(x: torch.Tensor):
    """float32 values -> (biased exponent, signed mantissa), both int64."""
    bits = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    sign = (bits >> 31) & 1
    exp = (bits >> MAN_BITS) & EXP_MAX
    man = bits & ((1 << MAN_BITS) - 1)
    special = exp == EXP_MAX
    exp = torch.where(special, EXP_MAX - 1, exp)
    man = torch.where(special, (1 << MAN_BITS) - 1, man)
    denorm = exp == 0
    mag = torch.where(denorm, 0, man | (1 << MAN_BITS))
    return exp, torch.where(sign == 1, -mag, mag)


def _floor_log2(a: torch.Tensor) -> torch.Tensor:
    """floor(log2(a)) of non-negative int64 values below 2^53; -1 for 0."""
    return torch.frexp(a.to(torch.float64)).exponent.to(torch.int64) - 1


def renormalize(exp: torch.Tensor, man: torch.Tensor) -> torch.Tensor:
    """(exponent, integer mantissa sum) -> float32, the delayed
    renormalization."""
    neg = man < 0
    shift = _floor_log2(man.abs()) - MAN_BITS
    m = torch.where(shift >= 0, man >> shift.clamp(0, 31), man << (-shift).clamp(0, 31))
    carry = (m.abs() >> (MAN_BITS + 1)) != 0  # a negative value rounded up to 2^24
    m = torch.where(carry, m >> 1, m)
    new_e = exp + shift + carry.to(torch.int64)
    zero, under, over = man == 0, new_e <= 0, new_e >= EXP_MAX
    e_out = torch.where(zero | under, 0, new_e.clamp(0, EXP_MAX))
    e_out = torch.where(over, EXP_MAX, e_out)
    m_out = torch.where(zero | under | over, 0, m.abs() & ((1 << MAN_BITS) - 1))
    bits = torch.where(neg, 1 << 31, 0) | (e_out << MAN_BITS) | m_out
    bits = torch.where(zero, 0, bits)
    return (((bits + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32).view(torch.float32)


def _sum_rows(rows: torch.Tensor, shift: int) -> torch.Tensor:
    """(W, n) with n a multiple of BLOCK -> (n,) float32."""
    w, n = rows.shape
    exp, man = _encode(rows)
    bmax = exp.reshape(w, n // BLOCK, BLOCK).amax(dim=(0, 2))
    be = bmax.repeat_interleave(BLOCK)
    aligned = man >> (be[None] - exp + shift).clamp(0, 31)
    return renormalize(be + shift, aligned.sum(0))


def aggregate(stack: torch.Tensor) -> torch.Tensor:
    """FPISA sum over the leading worker axis of ``stack`` (W, ...), in
    float32, with the blocks cut from the flattened leaf (zero-padded to a
    whole block, as the program pads it)."""
    w = stack.shape[0]
    rows = stack.reshape(w, -1)
    n = rows.shape[1]
    shift = preshift(w)
    out = torch.empty(n, dtype=torch.float32, device=stack.device)
    for start in range(0, n, CHUNK):
        part = rows[:, start:start + CHUNK]
        pad = (-part.shape[1]) % BLOCK
        if pad:
            part = torch.cat([part, part.new_zeros(w, pad)], dim=1)
        out[start:start + CHUNK] = _sum_rows(part, shift)[:part.shape[1] - pad]
    return out.reshape(stack.shape[1:])
