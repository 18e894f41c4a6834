// Hopper (sm_90a) kernel for the switch-arrival FPISA accumulation over a
// worker axis (the fpisa_seq strategy's sum).
//
// Replaces
//   fpisa_accum  <- repro/kernels/fpisa_accum.py::fpisa_accum (K6)
// and computes exactly what it computes (plain version: accum_ref in
// repro_torch/kernels/ref.py, i.e. core/fpisa.py::fpisa_sum_sequential):
// worker 0 first, FPISA-A (fpisa_a_add) or full (fpisa_add_full) adds into
// a zero accumulator, one delayed renormalization at the end, float32 out
// (the format's value, upcast exactly), as the TPU kernel emits.
//
// What bounds it: device-memory bytes, (W + 1) x 4 B per element for fp32
// (each worker's value read once, the float32 result written once). Each
// add is about 10 integer operations and the final renormalize about 34, so
// at W = 8 the operations come within reach of the byte time at the card's
// int32 rate; chip_smoke.py counts both.
//
// Design: the TPU kernel holds the whole (W, TILE_R, B) payload in VMEM and
// loops over the workers there. Here nothing is staged in shared memory:
// one thread owns one element column, keeps the (exp, man) accumulator in
// registers and loops over the W workers in arrival order. Worker w's loads
// are coalesced across the warp (consecutive threads, consecutive
// elements), at stride n = R * B between workers. The row structure does
// not matter to the arithmetic, so the grid is flat over the R * B columns.
//
// Binding: a plain C entry point loaded with ctypes; launches on the given
// stream, allocates nothing, returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "fpisa_fused.cuh"

namespace {

constexpr int kThreads = 256;

// K6: x (workers, n) raw FP bits -> out (n,) float32 bits.
template <class F, typename BitsT, bool kFull>
__global__ void __launch_bounds__(kThreads)
accum_kernel(const BitsT* __restrict__ x, uint32_t* __restrict__ out, int64_t n,
             int workers) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  fpisa::Plane acc{0, 0};
  fpisa::AddStats st;
  for (int w = 0; w < workers; ++w) {
    const fpisa::Plane in = fpisa::encode<F>((uint32_t)x[(int64_t)w * n + i]);
    acc = kFull ? fpisa::fpisa_add_full<F>(acc, in, &st) : fpisa::fpisa_a_add<F>(acc, in, &st);
  }
  out[i] = fpisa::to_f32_bits<F>(fpisa::renormalize<F>(acc.exp, acc.man));
}

template <class F, typename BitsT>
int launch_accum(int variant, const void* x, void* out, int64_t n, int workers,
                 cudaStream_t s) {
  const BitsT* xp = static_cast<const BitsT*>(x);
  uint32_t* op = static_cast<uint32_t*>(out);
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  switch (variant) {
    case 0: accum_kernel<F, BitsT, false><<<grid, kThreads, 0, s>>>(xp, op, n, workers); break;
    case 1: accum_kernel<F, BitsT, true><<<grid, kThreads, 0, s>>>(xp, op, n, workers); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// fmt: 0 = fp32, 1 = fp16, 2 = bf16 (order of kernels/fpisa_fused.py FMT_CODES);
// variant: 0 = fpisa_a, 1 = full.
extern "C" int fpisa_accum(int fmt, int variant, const void* x, void* out, long long n,
                           int workers, void* stream) {
  if (n <= 0) return 0;
  if (workers <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case 0: return launch_accum<fpisa::Fp32, uint32_t>(variant, x, out, n, workers, s);
    case 1: return launch_accum<fpisa::Fp16, uint16_t>(variant, x, out, n, workers, s);
    case 2: return launch_accum<fpisa::Bf16, uint16_t>(variant, x, out, n, workers, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
