"""Shared bit-level numerics for FPISA, on torch integer tensors.

Port of ``repro.core.numerics``. FP32 layout reminder: [sign:1][exp:8 bias
127][mantissa:23 implied-1]. FPISA stores a value as (exp: int32 in [0,255],
man: int32 two's-complement, 24-bit magnitude right-aligned => 7 headroom
bits + sign bit).

torch on the CPU has no ``>>`` on uint32, so every unsigned view of an int32
is taken in int64 (``as_u32``): the same 32 bits, read as a non-negative
number.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class FpFormat:
    """A packed IEEE-like floating point format handled by FPISA."""

    name: str
    exp_bits: int
    man_bits: int
    # register width used for the signed mantissa plane
    reg_bits: int = 32

    @property
    def bias(self) -> int:
        return (1 << (self.exp_bits - 1)) - 1

    @property
    def exp_mask(self) -> int:
        return (1 << self.exp_bits) - 1

    @property
    def man_mask(self) -> int:
        return (1 << self.man_bits) - 1

    @property
    def implied_one(self) -> int:
        return 1 << self.man_bits

    @property
    def headroom(self) -> int:
        # sign bit occupies the top of the register
        return self.reg_bits - 1 - (self.man_bits + 1)

    @property
    def total_bits(self) -> int:
        return 1 + self.exp_bits + self.man_bits


FP32 = FpFormat("fp32", exp_bits=8, man_bits=23)
FP16 = FpFormat("fp16", exp_bits=5, man_bits=10)
BF16 = FpFormat("bf16", exp_bits=8, man_bits=7)

FORMATS = {f.name: f for f in (FP32, FP16, BF16)}


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """The 32 bits of an int32 tensor as a non-negative int64 (uint32 view)."""
    return x.to(torch.int64) & 0xFFFFFFFF


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Branchless count-leading-zeros of the 32-bit pattern (vectorized).

    The software analogue of the paper's TCAM longest-prefix-match table
    (Fig. 5): a 5-step binary search over the bit positions. Returns 32 for
    x == 0."""
    u = as_u32(x)
    n = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
    for shift in (16, 8, 4, 2, 1):
        big = (u >> shift) != 0
        n = torch.where(big, n + shift, n)
        u = torch.where(big, u >> shift, u)
    # u now holds the top set bit (0 or 1)
    n = torch.where(u != 0, n, -1)  # n = floor(log2(x)); -1 for zero
    return 31 - n  # clz; 32 when x == 0


def floor_log2_u32(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) of the 32-bit pattern (int32 result); -1 for x == 0."""
    return 31 - clz32(x)


def _distance(s, like: torch.Tensor) -> torch.Tensor:
    """Shift distance clamped to [0, 31]: shifting an int32 by 32 or more is
    undefined (in CUDA as in XLA); 31 keeps round-toward-negative-infinity
    (positive -> 0, negative -> -1)."""
    return torch.as_tensor(s, dtype=torch.int32, device=like.device).clamp(0, 31)


def arshift(x: torch.Tensor, s) -> torch.Tensor:
    """Arithmetic right shift of int32 ``x`` by a clamped, possibly-vector
    distance ``s``."""
    return torch.bitwise_right_shift(x.to(torch.int32), _distance(s, x))


def lshift(x: torch.Tensor, s) -> torch.Tensor:
    """Left shift of int32 ``x`` by a clamped distance, wrapping like the
    two's-complement register (taken on the 64-bit value, then wrapped)."""
    wide = torch.bitwise_left_shift(x.to(torch.int64), _distance(s, x).to(torch.int64))
    return wrap_int32(wide)


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an int64 tensor as a two's-complement int32 (explicit
    modular wrap: an out-of-range int64 -> int32 cast is not defined)."""
    return (((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)


def f32_to_int32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as XLA's convert does: NaN -> 0, values at or past
    +-2^31 (infinities included) saturate to INT32_MAX / INT32_MIN, the rest
    truncate toward zero. Torch's ``.to(torch.int32)`` gives INT32_MIN for
    all of those on the CPU, and CUDA saturates: this cast gives the same
    bits on both. Clamping in float first cannot work, because 2^31 - 1 is
    not a float32; only the values in range are cast."""
    nan = torch.isnan(x)
    hi = x >= 2.0**31
    lo = x < -(2.0**31)
    out = torch.where(nan | hi | lo, 0.0, x).to(torch.int32)
    out = torch.where(hi, 2**31 - 1, out)
    return torch.where(lo, -(2**31), out)


def required_preshift(num_workers: int, fmt: FpFormat = FP32) -> int:
    """Right-shift applied to every aligned mantissa before an integer
    reduction over `num_workers` contributions so the int32 accumulator can
    never overflow: |m| < 2^(man_bits+1), sum < W * 2^(man_bits+1-s) must be
    < 2^(reg_bits-1)."""
    return max(0, math.ceil(math.log2(max(num_workers, 1))) - fmt.headroom)
