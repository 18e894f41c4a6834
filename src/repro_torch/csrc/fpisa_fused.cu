// Hopper (sm_90a) kernels for the FPISA aggregation: fused encode->align
// before the collective and fused decode after it, plus the two-pass
// pipeline's decode, which is the fused decode at an int32 wire.
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
// What bounds them: device-memory bytes. Both are integer work plus a
// per-row max, a few dozen 32-bit operations per element against 8 bytes of
// traffic per element for fp32 in / int32 out (K1 reads 4 B of x and writes
// 4 B of mantissa; K2 and K5 read 4 B of int32 sum and write 4 B of fp32), so the
// card's 3.35 TB/s, not its ALUs, sets the floor.
//
// The design is the simple one: one warp per row of B = 128/256/512
// elements (one FPISA block), each lane holding B/32 elements in registers.
// Lane l touches elements l, l+32, ..., so every load and store of the warp
// is one contiguous segment (coalesced). K1 reduces the row's max exponent
// with __shfl_xor_sync and never writes the (exp, man) planes; K2 and K5
// read the row's exponent once per lane. The TPU kernels' (256, B) VMEM tiles are not
// copied: a row is independent of every other row, so no shared memory is
// needed. Left for later work: 16-byte vector loads, a persistent grid, and
// folding the residual shift + wire cast (now plain torch) into a kernel.
//
// Binding: plain C entry points loaded with ctypes. Each launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "fpisa_fused.cuh"

namespace {

using fpisa::kRowThreads;
using fpisa::row_grid;
using fpisa::warp_row;

// K1: x (rows, B) raw FP bits -> man (rows, B) int32 aligned to the row's
// own max exponent, bmax (rows,) int32.
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

// K2 (and K5 at WireT = int32_t): man_sum (rows, B) of any wire width +
// bmax (rows,) -> raw bits of the packed format (uint32_t for fp32,
// uint16_t for fp16/bf16).
template <class F, typename WireT, typename OutT, int B>
__global__ void __launch_bounds__(kRowThreads)
decode_kernel(const WireT* __restrict__ man, const int32_t* __restrict__ bmax,
              OutT* __restrict__ out, int64_t rows, int preshift) {
  constexpr int kPerLane = B / 32;
  const int lane = threadIdx.x & 31;
  const int64_t row = warp_row();
  if (row >= rows) return;
  const int32_t e = bmax[row] + preshift;
  const WireT* mr = man + row * B;
  OutT* orow = out + row * B;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int32_t m = (int32_t)mr[i * 32 + lane];  // wire upcast
    orow[i * 32 + lane] = (OutT)fpisa::renormalize<F>(e, m);
  }
}

template <class F, typename BitsT>
int launch_encode(const void* x, void* man, void* bmax, int64_t rows, int block,
                  cudaStream_t s) {
  const BitsT* xp = static_cast<const BitsT*>(x);
  int32_t* mp = static_cast<int32_t*>(man);
  int32_t* bp = static_cast<int32_t*>(bmax);
  switch (block) {
    case 128: encode_align_kernel<F, BitsT, 128><<<row_grid(rows), kRowThreads, 0, s>>>(xp, mp, bp, rows); break;
    case 256: encode_align_kernel<F, BitsT, 256><<<row_grid(rows), kRowThreads, 0, s>>>(xp, mp, bp, rows); break;
    case 512: encode_align_kernel<F, BitsT, 512><<<row_grid(rows), kRowThreads, 0, s>>>(xp, mp, bp, rows); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <class F, typename WireT, typename OutT>
int launch_decode(const void* man, const void* bmax, void* out, int64_t rows,
                  int block, int preshift, cudaStream_t s) {
  const WireT* mp = static_cast<const WireT*>(man);
  const int32_t* bp = static_cast<const int32_t*>(bmax);
  OutT* op = static_cast<OutT*>(out);
  switch (block) {
    case 128: decode_kernel<F, WireT, OutT, 128><<<row_grid(rows), kRowThreads, 0, s>>>(mp, bp, op, rows, preshift); break;
    case 256: decode_kernel<F, WireT, OutT, 256><<<row_grid(rows), kRowThreads, 0, s>>>(mp, bp, op, rows, preshift); break;
    case 512: decode_kernel<F, WireT, OutT, 512><<<row_grid(rows), kRowThreads, 0, s>>>(mp, bp, op, rows, preshift); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <class F, typename OutT>
int launch_decode_wire(int wire_bytes, const void* man, const void* bmax, void* out,
                       int64_t rows, int block, int preshift, cudaStream_t s) {
  switch (wire_bytes) {
    case 1: return launch_decode<F, int8_t, OutT>(man, bmax, out, rows, block, preshift, s);
    case 2: return launch_decode<F, int16_t, OutT>(man, bmax, out, rows, block, preshift, s);
    case 4: return launch_decode<F, int32_t, OutT>(man, bmax, out, rows, block, preshift, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// fmt: 0 = fp32, 1 = fp16, 2 = bf16 (order of kernels/fpisa_fused.py FMT_CODES).
extern "C" int fpisa_encode_align(int fmt, const void* x, void* man, void* bmax,
                                  long long rows, int block, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case 0: return launch_encode<fpisa::Fp32, uint32_t>(x, man, bmax, rows, block, s);
    case 1: return launch_encode<fpisa::Fp16, uint16_t>(x, man, bmax, rows, block, s);
    case 2: return launch_encode<fpisa::Bf16, uint16_t>(x, man, bmax, rows, block, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int fpisa_decode_fused(int fmt, int wire_bytes, const void* man,
                                  const void* bmax, void* out, long long rows,
                                  int block, int preshift, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case 0: return launch_decode_wire<fpisa::Fp32, uint32_t>(wire_bytes, man, bmax, out, rows, block, preshift, s);
    case 1: return launch_decode_wire<fpisa::Fp16, uint16_t>(wire_bytes, man, bmax, out, rows, block, preshift, s);
    case 2: return launch_decode_wire<fpisa::Bf16, uint16_t>(wire_bytes, man, bmax, out, rows, block, preshift, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K5: the two-pass decode, int32 summed mantissas only.
extern "C" int fpisa_decode(int fmt, const void* man, const void* bmax, void* out,
                            long long rows, int block, int preshift, void* stream) {
  return fpisa_decode_fused(fmt, 4, man, bmax, out, rows, block, preshift, stream);
}
