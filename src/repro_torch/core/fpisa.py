"""FPISA: floating-point arithmetic on integer registers (paper core), torch.

Port of the parts of ``repro.core.fpisa`` that the data-parallel
aggregation runs:

* ``encode``          — FP -> (exponent, signed two's-complement mantissa)
                        "integer plane" representation (Fig. 3).
* ``renormalize``     — delayed renormalization: CLZ + shift + exponent fixup
                        + pack (Sec. 3.2 "Renormalize and Assemble").
* ``fpisa_add_full`` / ``fpisa_a_add`` — one accumulator update, with the
                        full (RSAW) or the Tofino-deployable FPISA-A shift
                        rule (Sec. 3.2, 4.3), and their ``AddStats``.
* ``fpisa_sum_sequential`` — switch-arrival accumulation over a worker axis
                        (worker 0 first), the ``fpisa_seq`` strategy's sum.
* ``block_encode`` / ``block_decode`` / ``block_max_exponent`` — the
                        block-floating-point planes of the integer-domain
                        all-reduce (core/allreduce.py).

The register adds wrap like int32 registers: they are taken on int64 and
wrapped back (``numerics.wrap_int32``), since the reference relies on the
wrap and ``_overflowed`` only detects it. Every result is bit-identical to
the reference (tests/test_torch_numerics.py, tests/test_torch_switch.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import numerics as nx
from repro_torch.core.numerics import BF16, FORMATS, FP16, FP32, FpFormat

__all__ = [
    "FP32", "FP16", "BF16", "FORMATS", "FpFormat", "Planes", "PACKED_DTYPE", "FMT_OF_DTYPE",
    "to_packed", "encode", "renormalize", "decode", "AddStats", "fpisa_add_full", "fpisa_a_add",
    "fpisa_sum_sequential",
    "block_encode", "block_decode", "block_max_exponent",
]


class Planes(NamedTuple):
    """Decoupled integer representation of an FP tensor (Fig. 3)."""

    exp: torch.Tensor  # int32, biased exponent in [0, 2^exp_bits - 1]
    man: torch.Tensor  # int32, two's-complement signed mantissa (implied 1 explicit)


# ---------------------------------------------------------------------------
# Packed-bits extraction per format
# ---------------------------------------------------------------------------

PACKED_DTYPE = {"fp32": torch.float32, "fp16": torch.float16, "bf16": torch.bfloat16}
FMT_OF_DTYPE = {dtype: name for name, dtype in PACKED_DTYPE.items()}


def to_packed(x: torch.Tensor, fmt_name: str) -> torch.Tensor:
    """Cast ``x`` to the format's packed dtype, as XLA casts.

    Torch's cast rounds to nearest even as XLA does, but its CPU cast to
    bf16 writes 0xFFFF for every float32 NaN, where XLA keeps the sign
    (0x7FC0 / 0xFFC0), and its CUDA cast of an fp16 NaN to float32 makes
    it positive. FPISA encode clamps a NaN to +-max by its sign bit, so the
    sign decides the bits: NaN lanes take the quiet NaN of their own sign
    (XLA's word for bf16), the same bits on the CPU and the card by
    construction."""
    dtype = PACKED_DTYPE[fmt_name]
    y = x.to(dtype)
    if dtype is torch.float32 and x.dtype == torch.float16:
        quiet = torch.where(x.view(torch.int16) < 0, -0x400000, 0x7FC00000)  # 0xFFC00000
        bits = torch.where(torch.isnan(x), quiet, y.view(torch.int32))
        return bits.to(torch.int32).view(torch.float32)
    if dtype is not torch.bfloat16 or x.dtype == torch.bfloat16:
        return y
    quiet = torch.where(torch.signbit(x), -0x40, 0x7FC0)  # 0xFFC0 / 0x7FC0 as int16
    bits = torch.where(torch.isnan(x), quiet, y.view(torch.int16))
    return bits.to(torch.int16).view(torch.bfloat16)


def _to_bits(x: torch.Tensor, fmt: FpFormat) -> torch.Tensor:
    """Bitcast packed FP values to an int32 tensor holding the raw bits."""
    packed = to_packed(x, fmt.name)
    if fmt.name == "fp32":
        return packed.view(torch.int32)
    return packed.view(torch.int16).to(torch.int32) & 0xFFFF


def _from_bits(bits: torch.Tensor, fmt: FpFormat) -> torch.Tensor:
    """Inverse of ``_to_bits``: int32 raw bits -> packed FP. The 16-bit
    pattern is wrapped explicitly into int16 range before the view (an int32
    of 2^15 or more has no defined cast to int16)."""
    if fmt.name == "fp32":
        return bits.to(torch.int32).view(torch.float32)
    b16 = (((bits + 0x8000) & 0xFFFF) - 0x8000).to(torch.int16)
    return b16.view(PACKED_DTYPE[fmt.name])


def encode(x: torch.Tensor, fmt: FpFormat = FP32) -> Planes:
    """Extract (exp, signed mantissa) planes from packed FP values.

    The implied leading 1 is made explicit; the sign is folded into the
    mantissa as two's complement (paper Sec. 3.1). Denormals flush to zero;
    NaN/Inf are clamped to the largest finite value of the format (the
    reference's documented deviation)."""
    bits = _to_bits(x, fmt)
    sign = (bits >> (fmt.total_bits - 1)) & 1
    exp = (bits >> fmt.man_bits) & fmt.exp_mask
    man = bits & fmt.man_mask

    is_denorm = exp == 0
    is_special = exp == fmt.exp_mask  # inf / nan
    exp = torch.where(is_special, fmt.exp_mask - 1, exp)
    man = torch.where(is_special, fmt.man_mask, man)

    mag = torch.where(is_denorm, 0, man | fmt.implied_one)
    exp = torch.where(is_denorm, 0, exp)
    signed = torch.where(sign == 1, -mag, mag)
    return Planes(exp=exp.to(torch.int32), man=signed.to(torch.int32))


def renormalize(planes: Planes, fmt: FpFormat = FP32) -> torch.Tensor:
    """Delayed renormalization + assembly back to the packed format.

    Two's-complement arithmetic shifts, i.e. round-toward-negative-infinity
    (Appendix A.1); exponent overflow clamps to +/-inf; underflow flushes to
    zero; zero is packed as +0."""
    e = planes.exp.to(torch.int32)
    m = planes.man.to(torch.int32)
    neg = m < 0
    # |m| as uint32: abs(INT32_MIN) stays INT32_MIN, i.e. 2^31 unsigned
    k = nx.floor_log2_u32(torch.abs(m))  # position of leading 1; -1 when zero
    shift = k - fmt.man_bits  # >0: too big, shift right; <0: shift left
    m_shifted = torch.where(shift >= 0, nx.arshift(m, shift), nx.lshift(m, -shift))
    # Rounding toward -inf can carry the magnitude up to exactly
    # 2^(man_bits+1) (negative inputs only); fix up with one exact shift.
    carry = (nx.as_u32(torch.abs(m_shifted)) >> (fmt.man_bits + 1)) != 0
    m_shifted = torch.where(carry, nx.arshift(m_shifted, 1), m_shifted)
    shift = shift + carry.to(torch.int32)

    new_e = e + shift
    man_bits_out = torch.abs(m_shifted) & fmt.man_mask

    zero = m == 0
    underflow = new_e <= 0
    overflow = new_e >= fmt.exp_mask

    exp_out = new_e.clamp(0, fmt.exp_mask)
    exp_out = torch.where(zero | underflow, 0, exp_out)
    exp_out = torch.where(overflow, fmt.exp_mask, exp_out)
    man_out = torch.where(zero | underflow | overflow, 0, man_bits_out)

    # the sign bit of an fp32 pattern is int32's own sign bit
    sign_bit = -(1 << 31) if fmt.total_bits == 32 else 1 << (fmt.total_bits - 1)
    bits = torch.where(neg, sign_bit, 0) | (exp_out << fmt.man_bits) | man_out
    bits = torch.where(zero, 0, bits).to(torch.int32)
    return _from_bits(bits, fmt)


def decode(planes: Planes, fmt: FpFormat = FP32) -> torch.Tensor:
    """Alias for renormalize — kept for symmetry with encode."""
    return renormalize(planes, fmt)


# ---------------------------------------------------------------------------
# Accumulator updates
# ---------------------------------------------------------------------------


class AddStats(NamedTuple):
    overwrite: torch.Tensor  # bool: FPISA-A dropped the old accumulator value
    overflow: torch.Tensor  # bool: int32 register overflow (headroom exceeded)


def _add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 register add with two's-complement wrap."""
    return nx.wrap_int32(a.to(torch.int64) + b.to(torch.int64))


def _overflowed(a: torch.Tensor, b: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Signed-add overflow detect for s = a + b (int32, two's complement)."""
    return ((a ^ s) & (b ^ s)) < 0


def fpisa_add_full(acc: Planes, inp: Planes, fmt: FpFormat = FP32):
    """Full FPISA addition (needs the RSAW extension on a switch).

    Whichever operand has the smaller exponent gets right-shifted; the result
    keeps the larger exponent (paper Sec. 3.2, Fig. 4). Returns (Planes,
    AddStats)."""
    d = inp.exp - acc.exp
    le = d <= 0
    # d <= 0: shift the incoming mantissa right; d > 0: the stored one (RSAW)
    shifted_in = torch.where(le, nx.arshift(inp.man, -d), inp.man)
    shifted_acc = torch.where(le, acc.man, nx.arshift(acc.man, d))
    new_m = _add(shifted_acc, shifted_in)
    new_e = torch.where(le, acc.exp, inp.exp)
    overflow = _overflowed(shifted_acc, shifted_in, new_m)
    stats = AddStats(overwrite=torch.zeros_like(overflow), overflow=overflow)
    return Planes(exp=new_e, man=new_m), stats


def fpisa_a_add(acc: Planes, inp: Planes, fmt: FpFormat = FP32):
    """FPISA-A addition: deployable on unmodified Tofino (paper Sec. 4.3).

    Only the incoming mantissa is ever shifted:
      * d <= 0            : right-shift incoming (identical to full FPISA);
      * 0 < d <= headroom : left-shift incoming into the headroom bits (a
                            register shift: it wraps), accumulator exponent
                            unchanged (denormalized);
      * d > headroom      : overwrite the accumulator with the incoming value
                            ("overwrite" error, bounded; rare for gradients).
    """
    d = inp.exp - acc.exp
    h = fmt.headroom
    use_right = d <= 0
    use_over = d > h
    shifted_in = torch.where(use_right, nx.arshift(inp.man, -d), nx.lshift(inp.man, d))
    summed = _add(acc.man, shifted_in)
    new_m = torch.where(use_over, inp.man, summed)
    new_e = torch.where(use_over, inp.exp, acc.exp)
    overflow = ~use_over & _overflowed(acc.man, shifted_in, summed)
    # Overwriting a zero accumulator is the normal "first write", not an error.
    overwrite = use_over & (acc.man != 0)
    return Planes(exp=new_e, man=new_m), AddStats(overwrite=overwrite, overflow=overflow)


def fpisa_sum_sequential(values: torch.Tensor, fmt: FpFormat = FP32,
                         variant: str = "fpisa_a", return_stats: bool = False):
    """Aggregate ``values`` along axis 0 with switch-arrival semantics.

    ``values``: (num_workers, ...) packed FP tensor. Worker 0 arrives first.
    This is the paper's software-library equivalent used for its accuracy /
    convergence experiments (Sec. 5.2.1-5.2.2). Returns the packed FP result
    in the format's dtype (and the summed event counts, as int64 scalar
    tensors, when ``return_stats``)."""
    add = fpisa_a_add if variant == "fpisa_a" else fpisa_add_full
    zero = torch.zeros(values.shape[1:], dtype=torch.int32, device=values.device)
    acc = Planes(exp=zero, man=zero)
    n_over = n_ovf = torch.zeros((), dtype=torch.int64, device=values.device)
    for w in range(values.shape[0]):  # one worker's planes at a time
        acc, st = add(acc, encode(values[w], fmt), fmt)
        n_over = n_over + st.overwrite.sum()
        n_ovf = n_ovf + st.overflow.sum()
    out = renormalize(acc, fmt)
    if return_stats:
        return out, {"overwrite": n_over, "overflow": n_ovf}
    return out


# ---------------------------------------------------------------------------
# Block planes for the integer-domain all-reduce
# ---------------------------------------------------------------------------


def block_max_exponent(exp: torch.Tensor, block: int) -> torch.Tensor:
    """Per-block max of the exponent plane. exp: (..., N) with N % block == 0."""
    return exp.reshape(*exp.shape[:-1], exp.shape[-1] // block, block).amax(dim=-1)


def block_encode(x: torch.Tensor, block_exp: torch.Tensor, block: int,
                 preshift: int, fmt: FpFormat = FP32) -> torch.Tensor:
    """Align mantissas of ``x`` to the (globally-maxed) block exponent.

    ``block_exp``: (..., N // block) int32, already maxed across workers.
    Each element's value is man * 2^(block_exp - bias - man_bits + preshift);
    the right-shift truncation is the switch registers' round toward -inf."""
    planes = encode(x, fmt)
    be = block_exp.repeat_interleave(block, dim=-1)
    return nx.arshift(planes.man, (be - planes.exp) + preshift)


def block_decode(man_sum: torch.Tensor, block_exp: torch.Tensor, block: int,
                 preshift: int, fmt: FpFormat = FP32) -> torch.Tensor:
    """Renormalize summed block mantissas back to packed FP (delayed renorm)."""
    be = block_exp.repeat_interleave(block, dim=-1)
    return renormalize(Planes(exp=be + preshift, man=man_sum), fmt)
