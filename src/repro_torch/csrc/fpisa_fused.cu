// Hopper (sm_90a) kernels for the FPISA aggregation: the encode before the
// collectives and the decode after them, plus the two-pass pipeline's
// decode, which is the fused decode at an int32 wire.
//
// Replaces
//   fpisa_encode_align  <- repro/kernels/fpisa_fused.py::fused_encode_align (K1)
//   fpisa_decode_fused  <- repro/kernels/fpisa_fused.py::fused_decode       (K2)
//   fpisa_decode        <- repro/kernels/fpisa_decode.py::fpisa_decode      (K5)
// and computes exactly what they compute (plain versions:
// repro_torch/kernels/ref.py; arithmetic: fpisa_fused.cuh). K5 runs K2's
// kernel body at int32 input, the only input the TPU kernel takes; it has
// its own entry point so that its launches and times stand on their own.
//
// K1 has three modes. The local mode (fpisa_encode_align) is the TPU
// kernel's function: mantissas aligned to the row's own max exponent. The
// aggregation runs the other two, which take in the passes the reference
// leaves to XLA's fusion around it (the residual shift to the agreed
// exponent, the wire cast, the staging cast and the fold over a rank's
// logical workers):
//   exponent mode (fpisa_block_max): x (k, R, B) -> the block max exponent
//     over the k workers, (R,) int32; the MAX all-reduce follows;
//   wire mode (fpisa_encode_wire): x (k, R, B) + the agreed bmax (R,) ->
//     each element aligned in one shift, arshift(man, bmax - exp +
//     preshift), cast to the wire, summed over the k workers in int32
//     (worker 0 first), one (R, B) plane: int32 for 32- and 16-bit wires
//     (a 16-bit wire travels as int32, F1), int8 for the 8-bit wire.
// Arithmetic right shifts compose under the [0, 31] clamp, so one shift to
// the agreed exponent gives the bits of the local alignment followed by the
// residual shift; integer addition is exact, so the fold is too. Both modes
// read the leaf in its own dtype where the cast to the format is exact (the
// format's dtype, or fp16/bf16 into fp32) and widen it in registers.
// K2 (fpisa_decode_fused) writes fp32, fp16 or bf16: the format's value
// rounded to nearest even, as the leaf's cast does.
//
// What bounds them: device-memory bytes. Per element a few dozen 32-bit
// integer operations meet 2-8 bytes of traffic (bf16 in and int32 out: 6 B
// in wire mode, 2 B in exponent mode; int32 in and bf16 out: 6 B in K2), so
// the card's 3.35 TB/s, not its ALUs, sets the floor.
//
// The design: a warp owns whole rows of B = 128/256/512 elements (FPISA
// blocks), so a row's max stays in registers (__shfl_xor_sync). The new
// modes and K2 feed the warp with words of up to 16 bytes: each lane moves
// kVec = min(16 / sizeof(input), B / 32) contiguous elements per word, and
// word i of lane l is the row's word i * 32 + l, so every warp access is one
// contiguous segment. A warp takes kRows = 1-4 rows at once (Tile), so that
// each lane has four 16-byte words in flight before it computes; wire mode
// reads every worker's rows of a block before it stores. The local mode
// keeps one row a warp and one element a lane per access (l, l+32, ...).
// The TPU kernels' (256, B) VMEM tiles are not copied: rows are
// independent, so no shared memory is needed.
//
// Binding: plain C entry points loaded with ctypes. Each launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "fpisa_fused.cuh"

namespace {

using fpisa::Bits;
using fpisa::Frag;
using fpisa::kRowThreads;
using fpisa::row_grid;
using fpisa::warp_row;

template <int V>
using Int = std::integral_constant<int, V>;

// Elements a lane moves per word for input T at block B.
template <typename T, int B>
constexpr int kVecElems = (16 / (int)sizeof(T)) < B / 32 ? 16 / (int)sizeof(T) : B / 32;

// K1, local mode: x (rows, B) raw FP bits -> man (rows, B) int32 aligned to
// the row's own max exponent, bmax (rows,) int32.
template <class F, typename BitsT, int B>
__global__ void __launch_bounds__(kRowThreads)
encode_align_kernel(const BitsT* __restrict__ x, int32_t* __restrict__ man,
                    int32_t* __restrict__ bmax, int64_t rows) {
  constexpr int kPerLane = B / 32;
  const int lane = threadIdx.x & 31;
  const int64_t row = warp_row();
  if (row >= rows) return;
  const BitsT* xr = x + row * B;
  int32_t* mr = man + row * B;

  fpisa::Plane p[kPerLane];
  int32_t emax = 0;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    p[i] = fpisa::encode<F>((uint32_t)xr[i * 32 + lane]);
    emax = max(emax, p[i].exp);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    emax = max(emax, __shfl_xor_sync(0xffffffffu, emax, off));
#pragma unroll
  for (int i = 0; i < kPerLane; ++i)
    mr[i * 32 + lane] = fpisa::arshift(p[i].man, emax - p[i].exp);
  if (lane == 0) bmax[row] = emax;
}

// How a warp covers its rows with words of T: kVec elements per word, kWords
// words per row per lane, kRows rows at once, so that each lane has about
// four 16-byte words in flight before it computes.
template <typename T, int B>
struct Tile {
  static constexpr int kVec = kVecElems<T, B>;
  static constexpr int kWords = B / (32 * kVec);
  static constexpr int kRows = kWords >= 4 ? 1 : 4 / kWords;
  static dim3 grid(int64_t rows) {
    constexpr int64_t per_block = (int64_t)fpisa::kWarpsPerBlock * kRows;
    return dim3((unsigned)((rows + per_block - 1) / per_block));
  }
};

// K1, exponent mode: x (workers, rows, B) leaf elements of dtype D -> bmax
// (rows,) int32, the max exponent over the row's elements of every worker:
// the max of the exponent fields, clamped once (block_exp), which is the max
// of encode's exponents at a shift, a mask and a max an element.
template <class F, int D, int B>
__global__ void __launch_bounds__(kRowThreads)
block_max_kernel(const typename Bits<D>::T* __restrict__ x, int32_t* __restrict__ bmax,
                 int workers, int64_t rows) {
  using T = typename Bits<D>::T;
  using Tl = Tile<T, B>;
  const int lane = threadIdx.x & 31;
  const int64_t row0 = warp_row() * Tl::kRows;
  if (row0 >= rows) return;
  int32_t emax[Tl::kRows];
#pragma unroll
  for (int r = 0; r < Tl::kRows; ++r) emax[r] = 0;
  for (int w = 0; w < workers; ++w) {
    Frag<T, Tl::kVec> f[Tl::kRows][Tl::kWords];
#pragma unroll
    for (int r = 0; r < Tl::kRows; ++r) {
      if (row0 + r < rows) {
        const T* xr = x + ((int64_t)w * rows + row0 + r) * B;
#pragma unroll
        for (int i = 0; i < Tl::kWords; ++i) f[r][i].load(xr + (i * 32 + lane) * Tl::kVec);
      }
    }
#pragma unroll
    for (int r = 0; r < Tl::kRows; ++r) {
      if (row0 + r < rows) {
#pragma unroll
        for (int i = 0; i < Tl::kWords; ++i)
#pragma unroll
          for (int j = 0; j < Tl::kVec; ++j)
            emax[r] = max(emax[r], fpisa::exp_field<F>(fpisa::widen<F, D>(f[r][i].v[j])));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < Tl::kRows; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      emax[r] = max(emax[r], __shfl_xor_sync(0xffffffffu, emax[r], off));
    if (lane == 0 && row0 + r < rows) bmax[row0 + r] = fpisa::block_exp<F>(emax[r]);
  }
}

// K1, wire mode: x (workers, rows, B) leaf elements of dtype D + the agreed
// bmax (rows,) -> out (rows, B): sum over the workers of
// to_wire(arshift(man, bmax - exp + preshift)), cast to the wire; OutT is
// int8_t for the 8-bit wire, int32_t otherwise. Every worker's rows are read
// before the stores.
template <class F, int D, int WIRE_BITS, int B>
__global__ void __launch_bounds__(kRowThreads)
encode_wire_kernel(const typename Bits<D>::T* __restrict__ x,
                   const int32_t* __restrict__ bmax,
                   std::conditional_t<WIRE_BITS == 8, int8_t, int32_t>* __restrict__ out,
                   int workers, int64_t rows, int preshift) {
  using T = typename Bits<D>::T;
  using OutT = std::conditional_t<WIRE_BITS == 8, int8_t, int32_t>;
  using Tl = Tile<T, B>;
  const int lane = threadIdx.x & 31;
  const int64_t row0 = warp_row() * Tl::kRows;
  if (row0 >= rows) return;
  int32_t e[Tl::kRows];
  int32_t acc[Tl::kRows][Tl::kWords][Tl::kVec];
#pragma unroll
  for (int r = 0; r < Tl::kRows; ++r) {
    e[r] = row0 + r < rows ? bmax[row0 + r] + preshift : 0;
#pragma unroll
    for (int i = 0; i < Tl::kWords; ++i)
#pragma unroll
      for (int j = 0; j < Tl::kVec; ++j) acc[r][i][j] = 0;
  }
  for (int w = 0; w < workers; ++w) {
    Frag<T, Tl::kVec> f[Tl::kRows][Tl::kWords];
#pragma unroll
    for (int r = 0; r < Tl::kRows; ++r) {
      if (row0 + r < rows) {
        const T* xr = x + ((int64_t)w * rows + row0 + r) * B;
#pragma unroll
        for (int i = 0; i < Tl::kWords; ++i) f[r][i].load(xr + (i * 32 + lane) * Tl::kVec);
      }
    }
#pragma unroll
    for (int r = 0; r < Tl::kRows; ++r) {
      if (row0 + r < rows) {
#pragma unroll
        for (int i = 0; i < Tl::kWords; ++i)
#pragma unroll
          for (int j = 0; j < Tl::kVec; ++j) {
            const fpisa::Plane p = fpisa::encode<F>(fpisa::widen<F, D>(f[r][i].v[j]));
            acc[r][i][j] = fpisa::wrap_add(
                acc[r][i][j], fpisa::to_wire<WIRE_BITS>(fpisa::arshift(p.man, e[r] - p.exp)));
          }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < Tl::kRows; ++r) {
    if (row0 + r < rows) {
      OutT* orow = out + (row0 + r) * B;
#pragma unroll
      for (int i = 0; i < Tl::kWords; ++i) {
        Frag<OutT, Tl::kVec> o;
#pragma unroll
        for (int j = 0; j < Tl::kVec; ++j)
          o.v[j] = (OutT)fpisa::to_wire<WIRE_BITS>(acc[r][i][j]);
        o.store(orow + (i * 32 + lane) * Tl::kVec);
      }
    }
  }
}

// K2 (and K5 at WireT = int32_t, D = the format's dtype): man_sum (rows, B)
// of any wire width + bmax (rows,) -> raw bits of dtype D.
template <class F, typename WireT, int D, int B>
__global__ void __launch_bounds__(kRowThreads)
decode_kernel(const WireT* __restrict__ man, const int32_t* __restrict__ bmax,
              typename Bits<D>::T* __restrict__ out, int64_t rows, int preshift) {
  using OutT = typename Bits<D>::T;
  using Tl = Tile<WireT, B>;
  const int lane = threadIdx.x & 31;
  const int64_t row0 = warp_row() * Tl::kRows;
  if (row0 >= rows) return;
  Frag<WireT, Tl::kVec> m[Tl::kRows][Tl::kWords];
  int32_t e[Tl::kRows];
#pragma unroll
  for (int r = 0; r < Tl::kRows; ++r) {
    if (row0 + r < rows) {
      e[r] = bmax[row0 + r] + preshift;
      const WireT* mr = man + (row0 + r) * B;
#pragma unroll
      for (int i = 0; i < Tl::kWords; ++i) m[r][i].load(mr + (i * 32 + lane) * Tl::kVec);
    }
  }
#pragma unroll
  for (int r = 0; r < Tl::kRows; ++r) {
    if (row0 + r < rows) {
      OutT* orow = out + (row0 + r) * B;
#pragma unroll
      for (int i = 0; i < Tl::kWords; ++i) {
        Frag<OutT, Tl::kVec> o;
#pragma unroll
        for (int j = 0; j < Tl::kVec; ++j)  // the wire value widens to int32
          o.v[j] = (OutT)fpisa::cast_to<F, D>(
              fpisa::renormalize<F>(e[r], (int32_t)m[r][i].v[j]));
        o.store(orow + (i * 32 + lane) * Tl::kVec);
      }
    }
  }
}

// fn(Int<B>{}) for the block size; cudaErrorInvalidValue for any other.
template <typename Fn>
int with_block(int block, Fn&& fn) {
  switch (block) {
    case 128: return fn(Int<128>{});
    case 256: return fn(Int<256>{});
    case 512: return fn(Int<512>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// fn(format, Int<D>{}) for a (format, leaf dtype) pair the new K1 modes
// read: the format's own dtype, or fp16/bf16 leaves of the fp32 format.
template <typename Fn>
int with_format_and_leaf(int fmt, int dtype, Fn&& fn) {
  if (fmt == 0 && dtype == 0) return fn(fpisa::Fp32{}, Int<0>{});
  if (fmt == 0 && dtype == 1) return fn(fpisa::Fp32{}, Int<1>{});
  if (fmt == 0 && dtype == 2) return fn(fpisa::Fp32{}, Int<2>{});
  if (fmt == 1 && dtype == 1) return fn(fpisa::Fp16{}, Int<1>{});
  if (fmt == 2 && dtype == 2) return fn(fpisa::Bf16{}, Int<2>{});
  return (int)cudaErrorInvalidValue;
}

template <typename Fn>
int with_format(int fmt, Fn&& fn) {
  switch (fmt) {
    case 0: return fn(fpisa::Fp32{});
    case 1: return fn(fpisa::Fp16{});
    case 2: return fn(fpisa::Bf16{});
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename Fn>
int with_dtype(int dtype, Fn&& fn) {
  switch (dtype) {
    case 0: return fn(Int<0>{});
    case 1: return fn(Int<1>{});
    case 2: return fn(Int<2>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename Fn>
int with_wire_bits(int wire_bits, Fn&& fn) {
  switch (wire_bits) {
    case 8: return fn(Int<8>{});
    case 16: return fn(Int<16>{});
    case 32: return fn(Int<32>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// fmt, dtype: 0 = fp32, 1 = fp16, 2 = bf16 (order of kernels/fpisa_fused.py FMT_CODES).
extern "C" int fpisa_encode_align(int fmt, const void* x, void* man, void* bmax,
                                  long long rows, int block, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* mp = static_cast<int32_t*>(man);
  int32_t* bp = static_cast<int32_t*>(bmax);
  return with_format(fmt, [&](auto f) {
    using F = decltype(f);
    using BitsT = typename Bits<fpisa::FmtCode<F>::value>::T;
    const BitsT* xp = static_cast<const BitsT*>(x);
    return with_block(block, [&](auto b) {
      encode_align_kernel<F, BitsT, decltype(b)::value>
          <<<row_grid(rows), kRowThreads, 0, s>>>(xp, mp, bp, rows);
      return (int)cudaGetLastError();
    });
  });
}

extern "C" int fpisa_block_max(int fmt, int dtype, const void* x, void* bmax, int workers,
                               long long rows, int block, void* stream) {
  if (rows <= 0) return 0;
  if (workers <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* bp = static_cast<int32_t*>(bmax);
  return with_format_and_leaf(fmt, dtype, [&](auto f, auto d) {
    using F = decltype(f);
    constexpr int D = decltype(d)::value;
    const auto* xp = static_cast<const typename Bits<D>::T*>(x);
    return with_block(block, [&](auto b) {
      constexpr int B = decltype(b)::value;
      const dim3 grid = Tile<typename Bits<D>::T, B>::grid(rows);
      block_max_kernel<F, D, B><<<grid, kRowThreads, 0, s>>>(xp, bp, workers, rows);
      return (int)cudaGetLastError();
    });
  });
}

extern "C" int fpisa_encode_wire(int fmt, int dtype, const void* x, const void* bmax,
                                 void* out, int workers, long long rows, int block,
                                 int preshift, int wire_bits, void* stream) {
  if (rows <= 0) return 0;
  if (workers <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* bp = static_cast<const int32_t*>(bmax);
  return with_format_and_leaf(fmt, dtype, [&](auto f, auto d) {
    using F = decltype(f);
    constexpr int D = decltype(d)::value;
    const auto* xp = static_cast<const typename Bits<D>::T*>(x);
    return with_wire_bits(wire_bits, [&](auto w) {
      constexpr int WB = decltype(w)::value;
      auto* op = static_cast<std::conditional_t<WB == 8, int8_t, int32_t>*>(out);
      return with_block(block, [&](auto b) {
        constexpr int B = decltype(b)::value;
        const dim3 grid = Tile<typename Bits<D>::T, B>::grid(rows);
        encode_wire_kernel<F, D, WB, B><<<grid, kRowThreads, 0, s>>>(xp, bp, op, workers, rows,
                                                                     preshift);
        return (int)cudaGetLastError();
      });
    });
  });
}

// wire_bytes: the summed plane's element size (1, 2 or 4); out_dtype: the
// output's dtype code (the format's own, or any other: the value is cast).
extern "C" int fpisa_decode_fused(int fmt, int wire_bytes, const void* man,
                                  const void* bmax, void* out, long long rows,
                                  int block, int preshift, int out_dtype, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* bp = static_cast<const int32_t*>(bmax);
  return with_format(fmt, [&](auto f) {
    using F = decltype(f);
    return with_dtype(out_dtype, [&](auto d) {
      constexpr int D = decltype(d)::value;
      auto* op = static_cast<typename Bits<D>::T*>(out);
      auto launch = [&](auto wire) {
        using WireT = decltype(wire);
        const WireT* mp = static_cast<const WireT*>(man);
        return with_block(block, [&](auto b) {
          constexpr int B = decltype(b)::value;
          const dim3 grid = Tile<WireT, B>::grid(rows);
          decode_kernel<F, WireT, D, B><<<grid, kRowThreads, 0, s>>>(mp, bp, op, rows, preshift);
          return (int)cudaGetLastError();
        });
      };
      switch (wire_bytes) {
        case 1: return launch(int8_t{});
        case 2: return launch(int16_t{});
        case 4: return launch(int32_t{});
        default: return (int)cudaErrorInvalidValue;
      }
    });
  });
}

// K5: the two-pass decode, int32 summed mantissas only, the format's dtype out.
extern "C" int fpisa_decode(int fmt, const void* man, const void* bmax, void* out,
                            long long rows, int block, int preshift, void* stream) {
  return fpisa_decode_fused(fmt, 4, man, bmax, out, rows, block, preshift, fmt, stream);
}
