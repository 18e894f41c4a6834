// Hopper (sm_90a) kernels for the two-pass FPISA encode: extract, then
// align.
//
// Replaces
//   fpisa_extract  <- repro/kernels/fpisa_encode.py::fpisa_extract (K3)
//   fpisa_align    <- repro/kernels/fpisa_encode.py::fpisa_align   (K4)
// and computes exactly what they compute (plain versions: extract_ref and
// align_ref in repro_torch/kernels/ref.py; arithmetic: fpisa_fused.cuh).
// K1 (fpisa_fused.cu) is the fused form of the two; these kernels keep the
// pipeline in two passes because that is what they compute: K3 writes the
// (exp, man) planes, K4 reads them back.
//
// What bounds them: device-memory bytes. Per element, K3 reads 4 B of fp32
// and writes 8 B (exp and man planes; plus 4 B of bmax per row); K4 reads 8
// B (plus 4 B per row) and writes 4 B. A dozen 32-bit integer operations
// per element are far below the ALUs' rate, so 3.35 TB/s sets the floor.
//
// The design is K1's: one warp per row of B = 128/256/512 elements (one
// FPISA block), each lane holding B/32 elements, lane l touching elements
// l, l+32, ... so every load and store of the warp is one contiguous,
// coalesced segment. K3 reduces the row's max exponent with __shfl_xor_sync;
// K4 reads the row's block exponent once per lane. No shared memory: rows
// are independent. The TPU kernels' (256, B) VMEM tiles are not copied.
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

// K3: x (rows, B) raw FP bits -> exp, man (rows, B) int32, bmax (rows,).
template <class F, typename BitsT, int B>
__global__ void __launch_bounds__(kRowThreads)
extract_kernel(const BitsT* __restrict__ x, int32_t* __restrict__ exp,
               int32_t* __restrict__ man, int32_t* __restrict__ bmax, int64_t rows) {
  constexpr int kPerLane = B / 32;
  const int lane = threadIdx.x & 31;
  const int64_t row = warp_row();
  if (row >= rows) return;
  const BitsT* xr = x + row * B;
  int32_t* er = exp + row * B;
  int32_t* mr = man + row * B;
  int32_t emax = 0;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const fpisa::Plane p = fpisa::encode<F>((uint32_t)xr[i * 32 + lane]);
    er[i * 32 + lane] = p.exp;
    mr[i * 32 + lane] = p.man;
    emax = max(emax, p.exp);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    emax = max(emax, __shfl_xor_sync(0xffffffffu, emax, off));
  if (lane == 0) bmax[row] = emax;
}

// K4: out = arshift(man, (bmax[row] - exp) + preshift), all int32.
template <int B>
__global__ void __launch_bounds__(kRowThreads)
align_kernel(const int32_t* __restrict__ exp, const int32_t* __restrict__ man,
             const int32_t* __restrict__ bmax, int32_t* __restrict__ out, int64_t rows,
             int preshift) {
  constexpr int kPerLane = B / 32;
  const int lane = threadIdx.x & 31;
  const int64_t row = warp_row();
  if (row >= rows) return;
  const int32_t b = bmax[row];
  const int64_t base = row * B + lane;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int64_t k = base + i * 32;
    out[k] = fpisa::arshift(man[k], (b - exp[k]) + preshift);
  }
}

template <class F, typename BitsT>
int launch_extract(const void* x, void* exp, void* man, void* bmax, int64_t rows, int block,
                   cudaStream_t s) {
  const BitsT* xp = static_cast<const BitsT*>(x);
  int32_t* ep = static_cast<int32_t*>(exp);
  int32_t* mp = static_cast<int32_t*>(man);
  int32_t* bp = static_cast<int32_t*>(bmax);
  switch (block) {
    case 128: extract_kernel<F, BitsT, 128><<<row_grid(rows), kRowThreads, 0, s>>>(xp, ep, mp, bp, rows); break;
    case 256: extract_kernel<F, BitsT, 256><<<row_grid(rows), kRowThreads, 0, s>>>(xp, ep, mp, bp, rows); break;
    case 512: extract_kernel<F, BitsT, 512><<<row_grid(rows), kRowThreads, 0, s>>>(xp, ep, mp, bp, rows); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// fmt: 0 = fp32, 1 = fp16, 2 = bf16 (order of kernels/fpisa_fused.py FMT_CODES).
extern "C" int fpisa_extract(int fmt, const void* x, void* exp, void* man, void* bmax,
                             long long rows, int block, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case 0: return launch_extract<fpisa::Fp32, uint32_t>(x, exp, man, bmax, rows, block, s);
    case 1: return launch_extract<fpisa::Fp16, uint16_t>(x, exp, man, bmax, rows, block, s);
    case 2: return launch_extract<fpisa::Bf16, uint16_t>(x, exp, man, bmax, rows, block, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int fpisa_align(const void* exp, const void* man, const void* bmax, void* out,
                           long long rows, int block, int preshift, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ep = static_cast<const int32_t*>(exp);
  const int32_t* mp = static_cast<const int32_t*>(man);
  const int32_t* bp = static_cast<const int32_t*>(bmax);
  int32_t* op = static_cast<int32_t*>(out);
  switch (block) {
    case 128: align_kernel<128><<<row_grid(rows), kRowThreads, 0, s>>>(ep, mp, bp, op, rows, preshift); break;
    case 256: align_kernel<256><<<row_grid(rows), kRowThreads, 0, s>>>(ep, mp, bp, op, rows, preshift); break;
    case 512: align_kernel<512><<<row_grid(rows), kRowThreads, 0, s>>>(ep, mp, bp, op, rows, preshift); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
