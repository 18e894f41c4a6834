// Per-element FPISA arithmetic shared by the kernels in fpisa_fused.cu.
//
// Plain C++ on 32-bit integers, callable from device code (and from host
// code, so the arithmetic can be checked without a card). Every function is
// the bit-exact counterpart of one function of repro_torch/core/fpisa.py and
// repro_torch/core/numerics.py.
//
// Shift distances are clamped to [0, 31] everywhere: shifting a 32-bit
// integer by 32 or more is undefined behaviour in C++ and CUDA. Left shifts
// are done on uint32_t and cast back, so negative mantissas wrap like a
// two's-complement register instead of invoking undefined behaviour.
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

}  // namespace fpisa
