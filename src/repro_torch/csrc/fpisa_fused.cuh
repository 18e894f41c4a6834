// Per-element FPISA arithmetic shared by the kernels of csrc/*.cu.
//
// Plain C++ on 32-bit integers, callable from device code (and from host
// code, so the arithmetic can be checked without a card). Every function is
// the bit-exact counterpart of one function of repro_torch/core/fpisa.py and
// repro_torch/core/numerics.py.
//
// Shift distances are clamped to [0, 31] everywhere: shifting a 32-bit
// integer by 32 or more is undefined behaviour in C++ and CUDA. Left shifts
// and the register adds are done on uint32_t and cast back, so they wrap like
// a two's-complement register (the reference relies on the wrap; signed
// overflow would be undefined behaviour).
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define FPISA_HD __host__ __device__ __forceinline__
#else
#define FPISA_HD inline
#endif

namespace fpisa {

// Packed format: [sign:1][exp:EXP_BITS][mantissa:MAN_BITS].
template <int EXP_BITS, int MAN_BITS>
struct Format {
  static constexpr int man_bits = MAN_BITS;
  static constexpr int total_bits = 1 + EXP_BITS + MAN_BITS;
  static constexpr int32_t exp_mask = (1 << EXP_BITS) - 1;
  static constexpr int32_t man_mask = (1 << MAN_BITS) - 1;
  static constexpr int32_t implied_one = 1 << MAN_BITS;
  static constexpr int32_t bias = (1 << (EXP_BITS - 1)) - 1;
  // bits above the mantissa magnitude, below the sign (FpFormat.headroom)
  static constexpr int32_t headroom = 31 - (MAN_BITS + 1);
};
using Fp32 = Format<8, 23>;
using Fp16 = Format<5, 10>;
using Bf16 = Format<8, 7>;

FPISA_HD int32_t clamp_shift(int32_t s) { return s < 0 ? 0 : (s > 31 ? 31 : s); }

// numerics.arshift: arithmetic (sign-filling) right shift, round toward -inf.
FPISA_HD int32_t arshift(int32_t x, int32_t s) { return x >> clamp_shift(s); }

// numerics.lshift: two's-complement wrap, computed on the unsigned pattern.
FPISA_HD int32_t lshift(int32_t x, int32_t s) {
  return (int32_t)((uint32_t)x << clamp_shift(s));
}

// numerics.clz32: count of leading zeros, 32 for 0.
FPISA_HD int32_t clz32(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __clz((int)x);
#else
  return x == 0u ? 32 : __builtin_clz(x);
#endif
}

// |x| as uint32: |INT32_MIN| is 2^31, as jnp.abs(x).astype(uint32) gives.
FPISA_HD uint32_t abs_u32(int32_t x) { return x < 0 ? 0u - (uint32_t)x : (uint32_t)x; }

struct Plane {
  int32_t exp;  // biased exponent
  int32_t man;  // signed mantissa, implied one explicit
};

// fpisa.encode on one raw bit pattern: denormals flush to 0, inf/NaN clamp
// to the largest finite value.
template <class F>
FPISA_HD Plane encode(uint32_t bits) {
  const uint32_t sign = (bits >> (F::total_bits - 1)) & 1u;
  int32_t exp = (int32_t)((bits >> F::man_bits) & (uint32_t)F::exp_mask);
  int32_t man = (int32_t)(bits & (uint32_t)F::man_mask);
  if (exp == F::exp_mask) {  // inf / nan
    exp = F::exp_mask - 1;
    man = F::man_mask;
  }
  const int32_t mag = exp == 0 ? 0 : (man | F::implied_one);
  return Plane{exp, sign ? -mag : mag};
}

// fpisa.renormalize on one (exponent, summed mantissa) pair -> raw bits of
// the packed format (low total_bits bits of the result).
template <class F>
FPISA_HD uint32_t renormalize(int32_t e, int32_t m) {
  const bool neg = m < 0;
  int32_t shift = (31 - clz32(abs_u32(m))) - F::man_bits;
  int32_t ms = shift >= 0 ? arshift(m, shift) : lshift(m, -shift);
  // rounding toward -inf can carry the magnitude to 2^(man_bits+1)
  if ((abs_u32(ms) >> (F::man_bits + 1)) != 0u) {
    ms = arshift(ms, 1);
    shift += 1;
  }
  const int32_t new_e = e + shift;
  int32_t man_out = (int32_t)abs_u32(ms) & F::man_mask;
  const bool zero = m == 0;
  const bool underflow = new_e <= 0;
  const bool overflow = new_e >= F::exp_mask;
  int32_t exp_out = new_e < 0 ? 0 : (new_e > F::exp_mask ? F::exp_mask : new_e);
  if (zero || underflow) exp_out = 0;
  if (overflow) exp_out = F::exp_mask;
  if (zero || underflow || overflow) man_out = 0;
  const uint32_t bits = ((uint32_t)neg << (F::total_bits - 1)) |
                        ((uint32_t)exp_out << F::man_bits) | (uint32_t)man_out;
  return zero ? 0u : bits;  // zero packs as +0
}

// Exact float32 bit pattern of a renormalize<F> result (zero, a normal
// value or inf: renormalize flushes underflow and never makes a NaN, so the
// denormal and NaN cases do not arise).
template <class F>
FPISA_HD uint32_t to_f32_bits(uint32_t bits) {
  if constexpr (F::total_bits == 32) return bits;
  const uint32_t sign = (bits >> (F::total_bits - 1)) & 1u;
  const uint32_t exp = (bits >> F::man_bits) & (uint32_t)F::exp_mask;
  const uint32_t man = bits & (uint32_t)F::man_mask;
  const uint32_t e32 = exp == 0u ? 0u
                       : (exp == (uint32_t)F::exp_mask ? 255u : exp - F::bias + 127u);
  return (sign << 31) | (e32 << 23) | (man << (23 - F::man_bits));
}

// int32 register add, wrapping (fpisa._add).
FPISA_HD int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

// fpisa._overflowed: did s = a + b wrap?
FPISA_HD bool overflowed(int32_t a, int32_t b, int32_t s) { return ((a ^ s) & (b ^ s)) < 0; }

struct AddStats {
  bool overwrite;  // FPISA-A dropped a non-zero accumulator
  bool overflow;   // the int32 register add wrapped
};

// fpisa.fpisa_a_add: only the incoming mantissa is shifted; right when its
// exponent is not larger, left into the headroom when it is larger by at most
// the headroom, else it overwrites the accumulator.
template <class F>
FPISA_HD Plane fpisa_a_add(Plane acc, Plane in, AddStats* st) {
  const int32_t d = in.exp - acc.exp;  // exponents are in [0, 255]
  if (d > F::headroom) {
    st->overwrite = acc.man != 0;
    st->overflow = false;
    return in;
  }
  const int32_t shifted = d <= 0 ? arshift(in.man, -d) : lshift(in.man, d);
  const int32_t sum = wrap_add(acc.man, shifted);
  st->overwrite = false;
  st->overflow = overflowed(acc.man, shifted, sum);
  return Plane{acc.exp, sum};
}

// fpisa.fpisa_add_full: the operand with the smaller exponent is shifted
// right; the result keeps the larger exponent (RSAW).
template <class F>
FPISA_HD Plane fpisa_add_full(Plane acc, Plane in, AddStats* st) {
  const int32_t d = in.exp - acc.exp;
  const bool le = d <= 0;
  const int32_t s_in = le ? arshift(in.man, -d) : in.man;
  const int32_t s_acc = le ? acc.man : arshift(acc.man, d);
  const int32_t sum = wrap_add(s_acc, s_in);
  st->overwrite = false;
  st->overflow = overflowed(s_acc, s_in, sum);
  return Plane{le ? acc.exp : in.exp, sum};
}

#if defined(__CUDACC__)
// Launch shape of the warp-per-row kernels (one row, one FPISA block, per
// warp): 8 warps, so 8 rows, per thread block.
constexpr int kWarpsPerBlock = 8;
constexpr int kRowThreads = kWarpsPerBlock * 32;

inline dim3 row_grid(int64_t rows) {
  return dim3((unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
}

// This warp's row; warp-uniform, so whole warps leave past the last row.
__device__ __forceinline__ int64_t warp_row() {
  return (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
}
#endif

}  // namespace fpisa
