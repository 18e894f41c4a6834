// Per-element FPISA arithmetic shared by the kernels of csrc/*.cu.
//
// Plain C++ on 32-bit integers, callable from device code (and from host
// code, so the arithmetic can be checked without a card). Every function is
// the bit-exact counterpart of one function of repro_torch/core/fpisa.py and
// repro_torch/core/numerics.py, or, for the casts between dtypes (widen,
// cast_to), of the leaf's cast ``Tensor.to`` (exact, or rounding to nearest
// even).
//
// Shift distances are clamped to [0, 31] everywhere: shifting a 32-bit
// integer by 32 or more is undefined behaviour in C++ and CUDA. Left shifts
// and the register adds are done on uint32_t and cast back, so they wrap like
// a two's-complement register (the reference relies on the wrap; signed
// overflow would be undefined behaviour).
#pragma once

#include <stdint.h>
#include <string.h>

#if !defined(__CUDA_ARCH__)
#include <cfenv>
#endif

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

// The exponent field of raw bits. encode<F>(bits).exp is the field with
// inf/NaN (the all-ones field) clamped to exp_mask - 1; max commutes with
// that clamp, so a block's max exponent is block_exp<F>(the max field).
template <class F>
FPISA_HD int32_t exp_field(uint32_t bits) {
  return (int32_t)((bits >> F::man_bits) & (uint32_t)F::exp_mask);
}
template <class F>
FPISA_HD int32_t block_exp(int32_t max_field) {
  return max_field < F::exp_mask - 1 ? max_field : F::exp_mask - 1;
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

// Dtype codes of the entry points' fmt / dtype arguments: 0 = fp32, 1 =
// fp16, 2 = bf16 (kernels/fpisa_fused.py FMT_CODES). Bits<D> holds one raw
// element of dtype D.
template <class F> struct FmtCode;
template <> struct FmtCode<Fp32> { static constexpr int value = 0; };
template <> struct FmtCode<Fp16> { static constexpr int value = 1; };
template <> struct FmtCode<Bf16> { static constexpr int value = 2; };
template <int D> struct Bits { using T = uint16_t; };
template <> struct Bits<0> { using T = uint32_t; };

// fp16 bits -> the float32 bits of the same value. Exact: every fp16 value,
// denormals included, is a float32 normal or zero; inf and NaN keep their
// sign and stay inf and NaN.
FPISA_HD uint32_t f16_to_f32_bits(uint32_t h) {
  const uint32_t sign = (h & 0x8000u) << 16;
  const uint32_t exp = (h >> 10) & 0x1Fu;
  const uint32_t man = h & 0x3FFu;
  if (exp == 0x1Fu) return sign | 0x7F800000u | (man << 13);
  if (exp != 0u) return sign | ((exp + 112u) << 23) | (man << 13);
  if (man == 0u) return sign;
  const int32_t p = 31 - clz32(man);  // the denormal's leading bit, 0..9
  return sign | ((uint32_t)(p + 103) << 23) | ((man << (23 - p)) & 0x7FFFFFu);
}

// float32 bits (not a NaN) -> bf16 bits, rounding to nearest even.
FPISA_HD uint32_t f32_to_bf16_rne(uint32_t f) {
  return (f + 0x7FFFu + ((f >> 16) & 1u)) >> 16;
}

// float32 bits (not a NaN) -> fp16 bits, rounding to nearest even: from
// 65520 up to inf, and below 2^-14 to a denormal or zero.
FPISA_HD uint32_t f32_to_f16_rne(uint32_t f) {
  const uint32_t sign = (f >> 16) & 0x8000u;
  const uint32_t a = f & 0x7FFFFFFFu;
  if (a >= 0x47800000u) return sign | 0x7C00u;  // 2^16 and up
  if (a >= 0x38800000u) {                       // 2^-14 and up: a normal
    const uint32_t r = a - 0x38000000u;         // exponent bias 127 -> 15
    return sign | ((r + 0xFFFu + ((r >> 13) & 1u)) >> 13);
  }
  // a = m x 2^(e - 150); in units of fp16's smallest denormal, 2^-24, that
  // is m >> (126 - e), which rounds to 0 below 2^-25
  const uint32_t s = 126u - (a >> 23);
  if (s > 24u) return sign;
  const uint32_t m = (a & 0x7FFFFFu) | 0x800000u;
  const uint32_t q = m >> s, rem = m & ((1u << s) - 1u), half = 1u << (s - 1u);
  return sign | (q + ((rem > half || (rem == half && (q & 1u))) ? 1u : 0u));
}

// A leaf element's raw bits (dtype D) -> the raw bits format F reads. The
// cast is exact: D is F's own dtype, or F is fp32 and D is fp16 or bf16.
template <class F, int D>
FPISA_HD uint32_t widen(uint32_t raw) {
  if constexpr (FmtCode<F>::value == D) {
    return raw;
  } else {
    static_assert(FmtCode<F>::value == 0, "only fp32 holds fp16 and bf16 exactly");
    return D == 2 ? raw << 16 : f16_to_f32_bits(raw);
  }
}

// A renormalize<F> result -> the raw bits of dtype D holding its value,
// rounded to nearest even as a cast does (renormalize makes no NaN).
template <class F, int D>
FPISA_HD uint32_t cast_to(uint32_t bits) {
  if constexpr (FmtCode<F>::value == D) {
    return bits;
  } else {
    const uint32_t f = to_f32_bits<F>(bits);
    if constexpr (D == 0) return f;
    else if constexpr (D == 1) return f32_to_f16_rne(f);
    else return f32_to_bf16_rne(f);
  }
}

// A value on a WIRE_BITS-bit wire: cast to the wire's integer and back,
// wrapping as the reference's astype does (the wire shift keeps every value
// and every partial sum in range).
template <int WIRE_BITS>
FPISA_HD int32_t to_wire(int32_t v) {
  if constexpr (WIRE_BITS == 16) return (int32_t)(int16_t)v;
  else if constexpr (WIRE_BITS == 8) return (int32_t)(int8_t)v;
  else return v;
}

// int32 register add, wrapping (fpisa._add).
FPISA_HD int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

// K6's add, without the event flags (overwrite, overflow) that nothing on
// the card reads, and without branches. FPISA-A (fpisa.fpisa_a_add): only
// the incoming mantissa is shifted, right when its exponent is not larger,
// left into the headroom when it is larger by at most the headroom (a
// register shift: it wraps), else it overwrites the accumulator. Full
// (fpisa.fpisa_add_full, kFull): the operand with the smaller exponent is
// shifted right, the result keeps the larger exponent (RSAW). Each shift
// distance is clamped once: right = clamp(-d) shifts the incoming mantissa
// right where d <= 0, left = clamp(d) shifts it left (FPISA-A) or the
// accumulator right (full) where d > 0; the other distance is then 0. A
// zero accumulator is not special: a first value whose exponent is at most
// the headroom is shifted left into exponent 0.
template <class F, bool kFull>
FPISA_HD Plane accum_add(Plane acc, Plane in) {
  const int32_t d = in.exp - acc.exp;
  const int32_t right = clamp_shift(-d);
  const int32_t left = clamp_shift(d);
  if constexpr (kFull) {
    return Plane{acc.exp > in.exp ? acc.exp : in.exp,
                 wrap_add(acc.man >> left, in.man >> right)};
  } else {
    const int32_t sum = wrap_add(acc.man, (int32_t)((uint32_t)(in.man >> right) << left));
    const bool over = d > F::headroom;
    return Plane{over ? in.exp : acc.exp, over ? in.man : sum};
  }
}

// The bits of the float32 nearest m from below (a conversion rounding toward
// -inf): the int32 register floored to 24 significant bits, as renormalize
// floors it in the fp32 format, with the carry of a negative sum's floor to
// the next power of two included. On the host the conversion runs under the
// downward rounding mode: the host harness of tests/test_torch_accum_leaf.py
// checks that emulation, not __int2float_rd. The card's conversion is held to
// the plain versions by tests/test_torch_cuda.py's K6 parity cases (W 1, 2,
// 3, 4, 8, the non-finite words) and by chip_smoke.py's.
FPISA_HD uint32_t i2f_rd_bits(int32_t m) {
#if defined(__CUDA_ARCH__)
  return __float_as_uint(__int2float_rd(m));
#else
  const int mode = std::fegetround();
  std::fesetround(FE_DOWNWARD);
  volatile float f = (float)m;  // converted at run time, under the mode
  std::fesetround(mode);
  const float g = f;
  uint32_t u;
  memcpy(&u, &g, sizeof u);
  return u;
#endif
}

// renormalize's bits without a branch, for K6, where the renormalization
// is most of an element's instructions at W = 1. In the fp32 format one
// conversion (i2f_rd_bits: the floor to 24 bits on the card's conversion
// unit, beside the integer pipe) gives sign, mantissa and the leading bit's
// position; the exponent is moved by e - 150 where it stays in [1, 254], and
// zero, underflow (to a zero of the sum's sign) and overflow (to an inf)
// are two selects. In the 16-bit formats: one normalizing shift pair (right
// for a wide sum, left for a narrow one, the other distance 0), the carry of
// a negative sum's round toward -inf as a shift by 0 or 1 (the magnitude
// reaches at most 2^(man_bits + 1)), and zero, underflow and overflow as one
// clamp and two selects. The host harness of tests/test_torch_accum_leaf.py
// holds it to renormalize.
template <class F>
FPISA_HD uint32_t renormalize_lean(int32_t e, int32_t m) {
  if constexpr (F::total_bits == 32) {
    const uint32_t u = i2f_rd_bits(m);  // sign | (127 + leading bit) << 23 | mantissa
    const int32_t new_e = e + (int32_t)((u >> 23) & 0xFFu) - 150;
    const bool live = m != 0 && (uint32_t)(new_e - 1) < 254u;
    const uint32_t edge = (u & 0x80000000u) | (m != 0 && new_e >= 255 ? 0x7F800000u : 0u);
    return live ? u + ((uint32_t)(e - 150) << 23) : edge;
  } else {
    const int32_t shift = (31 - clz32(abs_u32(m))) - F::man_bits;  // -1 - man_bits at 0
    const int32_t right = shift > 0 ? shift : 0;
    const int32_t left = shift < 0 ? -shift : 0;
    uint32_t q = abs_u32((int32_t)((uint32_t)(m >> right) << left));
    const uint32_t carry = q >> (F::man_bits + 1);
    q >>= carry;
    const int32_t new_e = e + shift + (int32_t)carry;
    const bool live = (uint32_t)(new_e - 1) < (uint32_t)(F::exp_mask - 1);
    const int32_t exp_out =
        m == 0 ? 0 : (new_e < 0 ? 0 : (new_e > F::exp_mask ? F::exp_mask : new_e));
    const uint32_t man_out = live ? (q & (uint32_t)F::man_mask) : 0u;
    return ((uint32_t)(m < 0) << (F::total_bits - 1)) | ((uint32_t)exp_out << F::man_bits) |
           man_out;
  }
}

// K6's result: the accumulator renormalized in the format, as dtype D (the
// float32 the TPU kernel emits, exactly, or the leaf's dtype, rounded to
// nearest even).
template <class F, int D>
FPISA_HD uint32_t accum_out(Plane acc) {
  return cast_to<F, D>(renormalize_lean<F>(acc.exp, acc.man));
}

#if defined(__CUDACC__)
// The unsigned word of BYTES bytes.
template <int BYTES> struct Word;
template <> struct Word<16> { using T = uint4; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<4> { using T = uint32_t; };
template <> struct Word<2> { using T = uint16_t; };
template <> struct Word<1> { using T = uint8_t; };

// N elements of T in registers, moved to and from global memory in words of
// at most 16 bytes (global addresses aligned to the fragment's size).
template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Frag {
  static constexpr int kBytes = sizeof(T) * N;
  static constexpr int kWordBytes = kBytes < 16 ? kBytes : 16;
  using W = typename Word<kWordBytes>::T;
  T v[N];

  __device__ __forceinline__ void load(const T* __restrict__ src) {
    const W* s = reinterpret_cast<const W*>(src);
    W* d = reinterpret_cast<W*>(v);
#pragma unroll
    for (int i = 0; i < kBytes / kWordBytes; ++i) d[i] = s[i];
  }
  __device__ __forceinline__ void store(T* __restrict__ dst) const {
    const W* s = reinterpret_cast<const W*>(v);
    W* d = reinterpret_cast<W*>(dst);
#pragma unroll
    for (int i = 0; i < kBytes / kWordBytes; ++i) d[i] = s[i];
  }
};

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
