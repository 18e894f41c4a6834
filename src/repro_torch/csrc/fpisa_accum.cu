// Hopper (sm_90a) kernel for the switch-arrival FPISA accumulation over a
// worker axis (the fpisa_seq strategy's sum).
//
// Replaces
//   fpisa_accum  <- repro/kernels/fpisa_accum.py::fpisa_accum (K6)
// and computes what it computes (plain versions: accum_ref and
// accum_leaf_ref in repro_torch/kernels/ref.py, i.e.
// core/fpisa.py::fpisa_sum_sequential): worker 0 first, FPISA-A
// (fpisa_a_add) or full (fpisa_add_full) adds into a zero accumulator, one
// delayed renormalization at the end. Two modes, one kernel template:
//   local mode (fpisa_accum): the TPU kernel's function. x (W, n) in the
//     format's dtype -> (n,) float32, the format's value upcast exactly, as
//     the TPU kernel emits;
//   leaf mode (fpisa_accum_leaf): x (W, n) in the leaf's dtype D, where the
//     cast to the format is exact (D the format's dtype, or fp16/bf16 under
//     fp32) -> (n,) in D, rounded to nearest even as the leaf's cast
//     rounds. It takes in the passes around the sum that the reference
//     leaves to XLA's fusion (the float32 upcast before the all-gather, the
//     cast to the format, the cast back to the leaf's dtype), so the
//     fpisa_seq paths read and write each element once, in its own dtype.
//
// What bounds it: device-memory bytes, W x sizeof(D) + sizeof(out) per
// element (each worker's value read once, the result written once): 8 B
// at W = 1 in fp32, 4 B for a bf16 leaf; and the integer pipe. Per element
// the arithmetic is about 12 integer operations to encode and 11 to add per
// worker, and about 10 and one conversion to renormalize in the fp32 format
// (22 in the 16-bit ones); a bf16 leaf's 4 bytes meet 40-odd instructions,
// most of them on the integer pipe, which issues half as many per clock as
// the card's issue rate. The kernel's first version (one element a thread,
// one 4-byte load per worker, each load issued after the previous worker's
// add, a branching add and renormalize) read 51 % of its byte bound at W = 1
// and tracked its instruction count at W = 8.
//
// Design: the elements are independent, so no shared memory. A thread owns
// kWords 16-byte words (4 fp32 or 8 fp16/bf16 elements each) of every
// worker; word i of thread t in block b is word (b * kWords + i) * kThreads
// + t, so each warp-wide load is one contiguous 512-byte segment. At W = 1,
// 2, 4 and 8 (templated) the thread loads every worker's words before its
// first add, which keeps at least four 16-byte loads in flight per thread
// (kWords = 4 / W, at least 1); any other W runs a loop over the workers,
// kWords = 2 at a time. The add selects without branches, clamps each shift
// once and keeps no event flags (fpisa::accum_add); the renormalization
// takes no branch either, and in the fp32 format floors the sum to 24 bits
// in one conversion rounding toward -inf (fpisa::renormalize_lean). Results
// leave as 16-byte words. That body needs 16-byte-aligned input and output
// bases and workers' rows of one alignment (W = 1, or rows a multiple of 16
// bytes); the elements after the last whole word, or the whole input where
// those do not hold, go to a one-element-a-thread kernel
// (accum_edge_kernel).
//
// Binding: plain C entry points loaded with ctypes; each launches on the
// given stream, allocates nothing, returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "fpisa_fused.cuh"

namespace {

using fpisa::Bits;
using fpisa::Frag;

constexpr int kThreads = 256;

// 16-byte words a thread loads per worker: four in flight at W = 1, 2, 4
// and 8 (W = 0: the runtime loop over the workers).
template <int W>
constexpr int kWordsFor = W == 0 ? 2 : (W >= 4 ? 1 : 4 / W);

template <class F, int Din, bool kFull>
__device__ __forceinline__ fpisa::Plane add_raw(fpisa::Plane acc, uint32_t raw) {
  return fpisa::accum_add<F, kFull>(acc, fpisa::encode<F>(fpisa::widen<F, Din>(raw)));
}

// K6: x (workers, n) raw bits of dtype Din -> out (n,) raw bits of dtype
// Dout, over the first `words` 16-byte words of each worker's row.
template <class F, int Din, int Dout, bool kFull, int W>
__global__ void __launch_bounds__(kThreads, 2)
accum_kernel(const typename Bits<Din>::T* __restrict__ x,
             typename Bits<Dout>::T* __restrict__ out, int64_t n, int64_t words,
             int workers) {
  using In = typename Bits<Din>::T;
  using Out = typename Bits<Dout>::T;
  constexpr int kVec = 16 / (int)sizeof(In);
  constexpr int kWords = kWordsFor<W>;
  int64_t word[kWords], at[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    word[i] = ((int64_t)blockIdx.x * kWords + i) * kThreads + threadIdx.x;
    at[i] = (word[i] < words ? word[i] : words - 1) * kVec;  // the last block reloads
  }
  fpisa::Plane acc[kWords][kVec];
#pragma unroll
  for (int i = 0; i < kWords; ++i)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[i][e] = fpisa::Plane{0, 0};
  if constexpr (W > 0) {
    Frag<In, kVec> f[W][kWords];
#pragma unroll
    for (int w = 0; w < W; ++w)
#pragma unroll
      for (int i = 0; i < kWords; ++i) f[w][i].load(x + w * n + at[i]);
#pragma unroll
    for (int w = 0; w < W; ++w)
#pragma unroll
      for (int i = 0; i < kWords; ++i)
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          acc[i][e] = add_raw<F, Din, kFull>(acc[i][e], f[w][i].v[e]);
  } else {
    for (int w = 0; w < workers; ++w) {
      Frag<In, kVec> f[kWords];
#pragma unroll
      for (int i = 0; i < kWords; ++i) f[i].load(x + w * n + at[i]);
#pragma unroll
      for (int i = 0; i < kWords; ++i)
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          acc[i][e] = add_raw<F, Din, kFull>(acc[i][e], f[i].v[e]);
    }
  }
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    if (word[i] < words) {
      Frag<Out, kVec> o;
#pragma unroll
      for (int e = 0; e < kVec; ++e) o.v[e] = (Out)fpisa::accum_out<F, Dout>(acc[i][e]);
      o.store(out + at[i]);
    }
  }
}

// K6 on elements [lo, n), one a thread, each worker's value read on its own.
template <class F, int Din, int Dout, bool kFull>
__global__ void __launch_bounds__(kThreads)
accum_edge_kernel(const typename Bits<Din>::T* __restrict__ x,
                  typename Bits<Dout>::T* __restrict__ out, int64_t n, int64_t lo,
                  int workers) {
  const int64_t i = lo + (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  fpisa::Plane acc{0, 0};
  for (int w = 0; w < workers; ++w) acc = add_raw<F, Din, kFull>(acc, x[(int64_t)w * n + i]);
  out[i] = (typename Bits<Dout>::T)fpisa::accum_out<F, Dout>(acc);
}

inline unsigned blocks(int64_t units, int64_t per_block) {
  return (unsigned)((units + per_block - 1) / per_block);
}

template <class F, int Din, int Dout, bool kFull, int W>
int launch_body(const typename Bits<Din>::T* x, typename Bits<Dout>::T* out, int64_t n,
                int64_t words, int workers, cudaStream_t s) {
  accum_kernel<F, Din, Dout, kFull, W>
      <<<blocks(words, (int64_t)kThreads * kWordsFor<W>), kThreads, 0, s>>>(x, out, n, words,
                                                                          workers);
  return (int)cudaGetLastError();
}

template <class F, int Din, int Dout, bool kFull>
int launch(const void* xv, void* outv, int64_t n, int workers, cudaStream_t s) {
  using In = typename Bits<Din>::T;
  using Out = typename Bits<Dout>::T;
  const In* x = static_cast<const In*>(xv);
  Out* out = static_cast<Out*>(outv);
  constexpr int kVec = 16 / (int)sizeof(In);
  const bool body = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                    (workers == 1 || n * (int64_t)sizeof(In) % 16 == 0);
  const int64_t words = body ? n / kVec : 0;
  int err = 0;
  if (words > 0) {
    switch (workers) {
      case 1: err = launch_body<F, Din, Dout, kFull, 1>(x, out, n, words, workers, s); break;
      case 2: err = launch_body<F, Din, Dout, kFull, 2>(x, out, n, words, workers, s); break;
      case 4: err = launch_body<F, Din, Dout, kFull, 4>(x, out, n, words, workers, s); break;
      case 8: err = launch_body<F, Din, Dout, kFull, 8>(x, out, n, words, workers, s); break;
      default: err = launch_body<F, Din, Dout, kFull, 0>(x, out, n, words, workers, s);
    }
    if (err) return err;
  }
  const int64_t lo = words * kVec;
  if (lo < n) {
    accum_edge_kernel<F, Din, Dout, kFull>
        <<<blocks(n - lo, kThreads), kThreads, 0, s>>>(x, out, n, lo, workers);
    err = (int)cudaGetLastError();
  }
  return err;
}

template <class F, int Din, int Dout>
int by_variant(int variant, const void* x, void* out, int64_t n, int workers,
               cudaStream_t s) {
  switch (variant) {
    case 0: return launch<F, Din, Dout, false>(x, out, n, workers, s);
    case 1: return launch<F, Din, Dout, true>(x, out, n, workers, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// fmt and dtype: 0 = fp32, 1 = fp16, 2 = bf16 (kernels/fpisa_fused.py
// FMT_CODES); variant: 0 = fpisa_a, 1 = full.
//
// Local mode: x (workers, n) raw bits of the format's dtype -> out (n,)
// float32 bits.
extern "C" int fpisa_accum(int fmt, int variant, const void* x, void* out, long long n,
                           int workers, void* stream) {
  if (n <= 0) return 0;
  if (workers <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case 0: return by_variant<fpisa::Fp32, 0, 0>(variant, x, out, n, workers, s);
    case 1: return by_variant<fpisa::Fp16, 1, 0>(variant, x, out, n, workers, s);
    case 2: return by_variant<fpisa::Bf16, 2, 0>(variant, x, out, n, workers, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Leaf mode: x (workers, n) raw bits of dtype `dtype` -> out (n,) raw bits
// of dtype `dtype`; the format widens the dtype exactly (its own dtype, or
// fp16/bf16 under fp32).
extern "C" int fpisa_accum_leaf(int fmt, int dtype, int variant, const void* x, void* out,
                                long long n, int workers, void* stream) {
  if (n <= 0) return 0;
  if (workers <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt * 3 + dtype) {
    case 0: return by_variant<fpisa::Fp32, 0, 0>(variant, x, out, n, workers, s);
    case 1: return by_variant<fpisa::Fp32, 1, 1>(variant, x, out, n, workers, s);
    case 2: return by_variant<fpisa::Fp32, 2, 2>(variant, x, out, n, workers, s);
    case 4: return by_variant<fpisa::Fp16, 1, 1>(variant, x, out, n, workers, s);
    case 8: return by_variant<fpisa::Bf16, 2, 2>(variant, x, out, n, workers, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
