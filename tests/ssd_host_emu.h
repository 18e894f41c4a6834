// Host emulation of the CUDA subset that src/repro_torch/csrc/ssd_chunked.cu
// uses, so that its kernels build with the host's C++ compiler (C++20,
// -DSSD_HOST_EMU -include this file) and run on CPU memory. A CTA's 256
// threads run as fibers (ucontext) on the calling thread, one at a time: a
// fiber runs until it waits at __syncthreads or at a warp's shuffle, so the
// emulation needs no OS threads and its order is fixed. Dynamic shared
// memory starts as NaNs, so a read of a slot no thread wrote shows in the
// results. Launches run the CTAs one after another; bf16 casts round to
// nearest even, as the card's.
#pragma once
#include <ucontext.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <limits>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct emu_idx { unsigned x, y, z; };
inline emu_idx threadIdx, blockIdx;  // the running fiber's, set at every switch
struct float4 { float x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline uint4 __ldg(const uint4* p) { return *p; }
struct __nv_bfloat16 { uint16_t bits; };
inline float __bfloat162float(__nv_bfloat16 v) {
  uint32_t u = uint32_t(v.bits) << 16; float f; std::memcpy(&f, &u, 4); return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u; std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {uint16_t((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
inline cudaError_t cudaGetLastError() { return 0; }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class K> cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }
using std::max;
using std::min;

namespace emu {
constexpr int THREADS = 256, WARPS = THREADS / 32, STACK = 1 << 16;

struct Barrier {  // count and generation; the last to arrive opens it
  int count = 0;
  unsigned gen = 0;
};

struct Block {
  ucontext_t sched;
  ucontext_t ctx[THREADS];
  bool done[THREADS];
  Barrier block, warp[WARPS];
  double slots[WARPS][32];
  std::vector<char> stacks = std::vector<char>(size_t(THREADS) * STACK);
  std::function<void()> body;
};
inline Block* cur;
inline float4* smem_ptr;

inline void yield() {
  const unsigned me = threadIdx.x;
  swapcontext(&cur->ctx[me], &cur->sched);
  threadIdx.x = me;
}

inline void wait(Barrier& b, int n) {
  const unsigned gen = b.gen;
  if (++b.count == n) {
    b.count = 0;
    ++b.gen;
    return;
  }
  while (b.gen == gen) yield();
}

template <class T> T shfl(T v, int src) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  cur->slots[w][lane] = static_cast<double>(v);
  wait(cur->warp[w], 32);
  const double r = cur->slots[w][src];
  wait(cur->warp[w], 32);
  return static_cast<T>(r);
}

inline void entry() {
  cur->body();
  cur->done[threadIdx.x] = true;
}

template <class K> struct Launcher {
  K k; dim3 grid; size_t smem;
  template <class... A> void operator()(A... args) {
    std::vector<float4> buf(smem / 16 + 2);
    Block blk;
    cur = &blk;
    smem_ptr = buf.data();
    blk.body = [&] { k(args...); };
    for (unsigned z = 0; z < grid.z; ++z)
      for (unsigned y = 0; y < grid.y; ++y)
        for (unsigned x = 0; x < grid.x; ++x) {
          const float nan = std::numeric_limits<float>::quiet_NaN();
          std::fill(buf.begin(), buf.end(), float4{nan, nan, nan, nan});
          blockIdx = {x, y, z};
          for (int t = 0; t < THREADS; ++t) {
            getcontext(&blk.ctx[t]);
            blk.ctx[t].uc_stack.ss_sp = blk.stacks.data() + size_t(t) * STACK;
            blk.ctx[t].uc_stack.ss_size = STACK;
            blk.ctx[t].uc_link = &blk.sched;
            makecontext(&blk.ctx[t], entry, 0);
            blk.done[t] = false;
          }
          for (bool running = true; running;) {
            running = false;
            for (int t = 0; t < THREADS; ++t)
              if (!blk.done[t]) {
                running = true;
                threadIdx = {unsigned(t), 0, 0};
                swapcontext(&blk.sched, &blk.ctx[t]);
              }
          }
        }
    cur = nullptr;
  }
};
template <class K> Launcher<K> launch(K k, dim3 g, size_t s) { return {k, g, s}; }
}  // namespace emu

inline void __syncthreads() { emu::wait(emu::cur->block, emu::THREADS); }
template <class T> T __shfl_xor_sync(unsigned, T v, int m) {
  return emu::shfl(v, int(threadIdx.x % 32) ^ m);
}
template <class T> T __shfl_up_sync(unsigned, T v, int d) {
  const int l = threadIdx.x % 32; return emu::shfl(v, l >= d ? l - d : l);
}
template <class T> T __shfl_down_sync(unsigned, T v, int d) {
  const int l = threadIdx.x % 32; return emu::shfl(v, l + d < 32 ? l + d : l);
}
#define SSD_SMEM(name) float4* name = emu::smem_ptr
#define SSD_LAUNCH(kern, grid, smem, stream) emu::launch(kern, grid, smem)
