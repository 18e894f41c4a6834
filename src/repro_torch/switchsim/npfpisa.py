"""Pure-numpy mirrors of the FPISA primitives (fp32 only).

The port's own copy of the reference's numpy module of the same name. The
``switch_emu`` strategy runs the numpy dataplane (``switchsim/dataplane.py``)
on the host, as the reference does inside its host callback; these are its
per-packet primitives, an implementation independent of the torch ones in
``core/fpisa.py``.

Every function here must stay bit-exact vs its twin in
``repro_torch/core/fpisa.py`` (same two's-complement arithmetic shifts, same
>=31 clamp, same wrap-around int32 adds); ``tests/test_torch_switch.py``
pins that, and pins the dataplane against the reference's.
"""
from __future__ import annotations

import numpy as np

EXP_BITS, MAN_BITS, BIAS = 8, 23, 127
EXP_MASK = (1 << EXP_BITS) - 1
MAN_MASK = (1 << MAN_BITS) - 1
IMPLIED_ONE = 1 << MAN_BITS
HEADROOM = 31 - (MAN_BITS + 1)  # 7


def arshift(x, s):
    s = np.clip(np.asarray(s, np.int32), 0, 31)
    return np.right_shift(np.asarray(x, np.int32), s)  # arithmetic on int32


def lshift(x, s):
    s = np.clip(np.asarray(s, np.int32), 0, 31)
    return np.left_shift(np.asarray(x, np.int32), s)


def _floor_log2_u32(x):
    """floor(log2(x)) for uint32 x > 0; -1 for 0 (binary-search port of
    numerics.clz32)."""
    x = np.asarray(x, np.uint32)
    n = np.zeros(x.shape, np.int32)
    for shift in (16, 8, 4, 2, 1):
        big = (x >> np.uint32(shift)) != 0
        n = np.where(big, n + shift, n)
        x = np.where(big, x >> np.uint32(shift), x)
    return np.where(x != 0, n, -1).astype(np.int32)


def encode(x):
    """float32 -> (exp, man) int32 planes; see fpisa.encode."""
    bits = np.asarray(x, np.float32).view(np.int32)
    sign = (bits >> 31) & 1
    exp = (bits >> MAN_BITS) & EXP_MASK
    man = bits & MAN_MASK
    is_denorm = exp == 0
    is_special = exp == EXP_MASK
    exp = np.where(is_special, EXP_MASK - 1, exp)
    man = np.where(is_special, MAN_MASK, man)
    mag = np.where(is_denorm, 0, man | IMPLIED_ONE).astype(np.int32)
    exp = np.where(is_denorm, 0, exp).astype(np.int32)
    signed = np.where(sign == 1, -mag, mag).astype(np.int32)
    return exp, signed


def renormalize(exp, man):
    """(exp, man) planes -> packed float32; see fpisa.renormalize."""
    e = np.asarray(exp, np.int32)
    m = np.asarray(man, np.int32)
    neg = m < 0
    with np.errstate(over="ignore"):
        mag = np.abs(m).astype(np.uint32)  # INT32_MIN wraps, same as jnp
        k = _floor_log2_u32(mag)
        shift = k - MAN_BITS
        m_shifted = np.where(shift >= 0, arshift(m, shift), lshift(m, -shift))
        mag2 = np.abs(m_shifted).astype(np.uint32)
        carry = (mag2 >> np.uint32(MAN_BITS + 1)) != 0
        m_shifted = np.where(carry, arshift(m_shifted, 1), m_shifted)
        shift = shift + carry.astype(np.int32)

        new_e = e + shift
        man_bits_out = np.abs(m_shifted).astype(np.int32) & MAN_MASK

    zero = m == 0
    underflow = new_e <= 0
    overflow = new_e >= EXP_MASK
    exp_out = np.clip(new_e, 0, EXP_MASK)
    exp_out = np.where(zero | underflow, 0, exp_out)
    exp_out = np.where(overflow, EXP_MASK, exp_out)
    man_out = np.where(zero | underflow | overflow, 0, man_bits_out)
    bits = (neg.astype(np.int32) << 31) | (exp_out << MAN_BITS) | man_out
    bits = np.where(zero, 0, bits)
    return bits.astype(np.int32).view(np.float32)


def _overflowed(a, b, s):
    return ((a ^ s) & (b ^ s)) < 0


def fpisa_add_full(acc_exp, acc_man, in_exp, in_man):
    """Full FPISA add (RSAW); see fpisa.fpisa_add_full. Returns
    (exp, man, overwrite, overflow)."""
    d = in_exp - acc_exp
    with np.errstate(over="ignore"):
        m_le = acc_man + arshift(in_man, -d)
        m_gt = arshift(acc_man, d) + in_man
    le = d <= 0
    shifted_in = np.where(le, arshift(in_man, -d), in_man)
    shifted_acc = np.where(le, acc_man, arshift(acc_man, d))
    new_m = np.where(le, m_le, m_gt)
    new_e = np.where(le, acc_exp, in_exp)
    overflow = _overflowed(shifted_acc, shifted_in, new_m)
    return new_e, new_m, np.zeros_like(overflow), overflow


def fpisa_a_add(acc_exp, acc_man, in_exp, in_man):
    """FPISA-A add; see fpisa.fpisa_a_add. Returns
    (exp, man, overwrite, overflow)."""
    d = in_exp - acc_exp
    with np.errstate(over="ignore"):
        right = acc_man + arshift(in_man, -d)
        left = acc_man + lshift(in_man, d)
    use_right = d <= 0
    use_left = (d > 0) & (d <= HEADROOM)
    use_over = d > HEADROOM
    new_m = np.where(use_right, right, np.where(use_left, left, in_man))
    new_e = np.where(use_over, in_exp, acc_exp)
    shifted_in = np.where(use_right, arshift(in_man, -d), lshift(in_man, d))
    overflow = np.where(use_over, False, _overflowed(acc_man, shifted_in, new_m))
    overwrite = use_over & (acc_man != 0)
    return new_e, new_m, overwrite, overflow
