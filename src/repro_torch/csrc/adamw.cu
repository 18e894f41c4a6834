// O1: AdamW's global-norm clip and update over a whole parameter tree, for
// sm_90a: one norm launch and one update launch a step.
//
// Replaces no TPU kernel: the reference's src/repro/optim/optimizers.py is
// plain jnp (adamw_update, clip_by_global_norm), which XLA fuses. Its port's
// eager route (optim/optimizers.py: _clip and the AdamW loop of update) runs
// about 22 kernels a leaf, each a full pass over float32 temporaries: about
// 204 bytes a parameter a step, and three blocking host-to-device copies of
// the step's scalars.
//
// What bounds it: device-memory bytes. A parameter needs its gradient read
// twice (the norm, then the update), p read and written, m and v read and
// written: 24 B for a bf16 parameter, 11.1 GB a step for qwen1.5-0.5b's
// 463,987,712 parameters (3.3 ms at 3.35 TB/s) and 42.2 GB for Zamba2-7B's
// first 12 layers (12.6 ms). Design:
//   * the leaves' pointers and sizes travel by value, as a table in the
//     kernels' parameters (kMaxLeaves a launch; a larger tree is launched
//     in groups, all norm launches before the first update launch), so a
//     step copies nothing from the host and synchronizes nothing;
//   * both kernels walk the group's tiles of kTile elements in a
//     grid-stride loop, kUnroll vectors of 4 elements a thread, each
//     tensor's vector one 8-byte (bf16) or 16-byte (float32) access with
//     neighbouring threads on neighbouring addresses; every vector of a
//     tile is loaded before the first is computed. A ragged tail, or a leaf
//     whose tensors do not all start on 16 bytes, goes element by element;
//   * a leaf's p is bf16 or float32 and its gradient either, each read in
//     its own dtype (a gradient accumulated in float32 over microbatches
//     updates a bf16 p as the eager route's g.to(float32) would);
//   * the norm kernel reads each gradient in its own dtype, squares in
//     float32 and keeps a thread's sum compensated (Kahan), so the sum over
//     a Zamba2 leaf loses nothing to a long float32 accumulation; each CTA
//     writes one float64 partial (a fixed tree over its threads), and every
//     CTA of the update kernel sums all of them in one fixed order. No
//     atomics: a step repeats its bits;
//   * the update kernel derives the clip's scale, lr and the bias
//     corrections from the partials and the integer step on the card, with
//     the float32 operations of the eager route (optimizers.py _schedule,
//     _clip and the c1/c2 lines, as PyTorch's CUDA kernels compute them),
//     then runs the eager update's operations element by element in its
//     order, each rounded once as PyTorch's kernels round it (__fmul_rn,
//     __fadd_rn, __fdiv_rn, __fsqrt_rn: nvcc contracts nothing into an
//     FMA), and rounds p to its dtype as copy_ does. With the same scale it
//     writes the eager update's bits; only the norm's order of summation
//     differs from torch.sum's.
//
// Binding: plain C entry points loaded with ctypes (kernels/adamw.py); each
// launches on the given stream, allocates nothing and returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                        // threads a CTA
constexpr int kVec = 4;                              // elements a vector
constexpr int kUnroll = 2;                           // vectors a thread a tile
constexpr int kTile = kThreads * kVec * kUnroll;     // elements a tile
// kernels/adamw.py repeats these six (tests/test_torch_adamw.py holds them equal)
constexpr int kMaxLeaves = 64;                       // leaves a launch's table holds
constexpr int kNormCtas = 1024;                      // the norm's CTAs, partials a group
constexpr int kFields = 6;  // the host table's int64s a leaf: numel, p, g, m, v, flags
constexpr int kParamF32 = 1;  // flag: p is float32 (else bfloat16)
constexpr int kAligned = 2;   // flag: p, g, m and v all start on 16 bytes
constexpr int kGradF32 = 4;   // flag: g is float32 (else bfloat16)

struct Table {
  long long tile_start[kMaxLeaves + 1];  // the group's first tile of each leaf, then the total
  long long n[kMaxLeaves];
  void* p[kMaxLeaves];
  const void* g[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  unsigned char flags[kMaxLeaves];
  int count;
};
// a launch's parameters may hold 4 KB on every CUDA version
static_assert(sizeof(Table) + 128 <= 4096, "the leaf table outgrows a launch's parameters");

struct Hyper {  // every Python float rounded to float32, as torch rounds a scalar
  float max_norm, b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay, lr, warmup;
  int step;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);  // round to nearest even, as c10::BFloat16(float) on sm_80+
}

__device__ __forceinline__ void load_vec(const float* src, float (&x)[kVec]) {
  const float4 w = *reinterpret_cast<const float4*>(src);
  x[0] = w.x; x[1] = w.y; x[2] = w.z; x[3] = w.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* src, float (&x)[kVec]) {
  const uint2 w = *reinterpret_cast<const uint2*>(src);
  x[0] = __uint_as_float(w.x << 16); x[1] = __uint_as_float(w.x & 0xffff0000u);
  x[2] = __uint_as_float(w.y << 16); x[3] = __uint_as_float(w.y & 0xffff0000u);
}
__device__ __forceinline__ void store_vec(float* dst, const float (&x)[kVec]) {
  *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* dst, const float (&x)[kVec]) {
  uint32_t h[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) h[k] = __bfloat16_as_ushort(__float2bfloat16(x[k]));
  *reinterpret_cast<uint2*>(dst) = make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
}

// Vector ``off`` of a leaf of n elements: whole (``vec``: the leaf is
// aligned) or element by element, zeros past the end.
template <typename T>
__device__ __forceinline__ void load(const T* src, long long off, long long n, bool vec,
                                     float (&x)[kVec]) {
  if (vec && off + kVec <= n) {
    load_vec(src + off, x);
    return;
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) x[k] = off + k < n ? to_f32(src[off + k]) : 0.0f;
}
template <typename T>
__device__ __forceinline__ void store(T* dst, long long off, long long n, bool vec,
                                      const float (&x)[kVec]) {
  if (vec && off + kVec <= n) {
    store_vec(dst + off, x);
    return;
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k)
    if (off + k < n) from_f32(x[k], dst + off + k);
}

// The sum of a CTA's values in a fixed tree over its threads; every thread
// gets it.
__device__ double cta_sum(double x, double* sh) {
  sh[threadIdx.x] = x;
  __syncthreads();
#pragma unroll
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  const double total = sh[0];
  __syncthreads();
  return total;
}

// Adds ``x`` to the compensated sum (sum, c): sum - c carries what the
// float32 additions dropped. A non-finite sum stays as the plain sum would
// (an infinite square makes it inf, a NaN NaN).
__device__ __forceinline__ void kahan_add(float& sum, float& c, float x) {
  const float y = __fsub_rn(x, c);
  const float t = __fadd_rn(sum, y);
  c = isfinite(t) ? __fsub_rn(__fsub_rn(t, sum), y) : 0.0f;
  sum = t;
}

template <typename T>
__device__ __forceinline__ void norm_tile(const T* g, long long n, long long base, bool vec,
                                          float& sum, float& c) {
  float x[kUnroll][kVec];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    load(g, base + static_cast<long long>(u * kThreads + threadIdx.x) * kVec, n, vec, x[u]);
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    // torch.square(g.to(torch.float32)), summed
    const float s = __fadd_rn(__fadd_rn(__fmul_rn(x[u][0], x[u][0]), __fmul_rn(x[u][1], x[u][1])),
                              __fadd_rn(__fmul_rn(x[u][2], x[u][2]), __fmul_rn(x[u][3], x[u][3])));
    kahan_add(sum, c, s);
  }
}

// The leaf that holds tile ``tile`` of the group, from ``leaf`` on (a CTA's
// tiles only grow).
__device__ __forceinline__ int find_leaf(const Table& t, long long tile, int leaf) {
  while (t.tile_start[leaf + 1] <= tile) ++leaf;
  return leaf;
}

// One CTA's float64 partial sum of the squares of the group's gradients.
__global__ void __launch_bounds__(kThreads) adamw_norm_kernel(const Table t, double* partials) {
  __shared__ double sh[kThreads];
  float sum = 0.0f, c = 0.0f;
  const long long tiles = t.tile_start[t.count];
  int leaf = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    leaf = find_leaf(t, tile, leaf);
    const long long base = (tile - t.tile_start[leaf]) * kTile;
    const bool vec = t.flags[leaf] & kAligned;
    if (t.flags[leaf] & kGradF32)
      norm_tile(static_cast<const float*>(t.g[leaf]), t.n[leaf], base, vec, sum, c);
    else
      norm_tile(static_cast<const __nv_bfloat16*>(t.g[leaf]), t.n[leaf], base, vec, sum, c);
  }
  const double total = cta_sum(static_cast<double>(sum) - static_cast<double>(c), sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

struct Step {  // the scalars one element's update takes
  float scale, b1, one_minus_b1, b2, one_minus_b2, c1, c2, eps, weight_decay, lr;
};

// One element, the eager route's operations in its order:
//   g = g.to(float32) * scale
//   m.mul_(b1).add_((1 - b1) * g)
//   v.mul_(b2).add_((1 - b2) * g * g)
//   u = (m / c1) / (sqrt(v / c2) + eps)
//   p.copy_(pf - lr * (u + weight_decay * pf))   (the cast to p's dtype by the caller)
__device__ __forceinline__ void adamw_element(float& p, float g, float& m, float& v,
                                              const Step& s) {
  g = __fmul_rn(g, s.scale);
  m = __fadd_rn(__fmul_rn(m, s.b1), __fmul_rn(s.one_minus_b1, g));
  v = __fadd_rn(__fmul_rn(v, s.b2), __fmul_rn(__fmul_rn(s.one_minus_b2, g), g));
  const float u = __fdiv_rn(__fdiv_rn(m, s.c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.c2)), s.eps));
  p = __fsub_rn(p, __fmul_rn(s.lr, __fadd_rn(u, __fmul_rn(s.weight_decay, p))));
}

template <typename TP, typename TG>
__device__ __forceinline__ void update_tile(TP* p, const TG* g, float* m, float* v, long long n,
                                            long long base, bool vec, const Step& s) {
  float pv[kUnroll][kVec], gv[kUnroll][kVec], mv[kUnroll][kVec], vv[kUnroll][kVec];
  long long off[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    off[u] = base + static_cast<long long>(u * kThreads + threadIdx.x) * kVec;
    load(g, off[u], n, vec, gv[u]);
    load(p, off[u], n, vec, pv[u]);
    load(m, off[u], n, vec, mv[u]);
    load(v, off[u], n, vec, vv[u]);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) adamw_element(pv[u][k], gv[u][k], mv[u][k], vv[u][k], s);
    store(m, off[u], n, vec, mv[u]);
    store(v, off[u], n, vec, vv[u]);
    store(p, off[u], n, vec, pv[u]);
  }
}

// torch.clamp's NaN rule: a NaN passes, whatever the bound
__device__ __forceinline__ float clamp_min(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }
__device__ __forceinline__ float clamp_max(float x, float hi) { return isnan(x) ? x : fminf(x, hi); }

// Every CTA finishes the norm from all ``n_partials`` partials (one fixed
// order, so every CTA gets the same bits), derives the step's scalars, and
// updates its tiles of the group. CTA 0 writes grad_norm and lr where
// their pointers are given.
__global__ void __launch_bounds__(kThreads) adamw_update_kernel(
    const Table t, const double* partials, int n_partials, const Hyper h, float* gnorm_out,
    float* lr_out) {
  __shared__ double sh[kThreads];
  double part = 0.0;
  for (int i = threadIdx.x; i < n_partials; i += kThreads) part += partials[i];
  // _clip: gnorm = sqrt(total); scale = clamp(max_norm / clamp(gnorm, min=1e-9), max=1),
  // where max_norm / x is Tensor.__rtruediv__, x.reciprocal() * max_norm
  const float gnorm = __fsqrt_rn(static_cast<float>(cta_sum(part, sh)));
  const float scale =
      clamp_max(__fmul_rn(__fdiv_rn(1.0f, clamp_min(gnorm, 1e-9f)), h.max_norm), 1.0f);
  // _schedule: clamp((step + 1) / warmup, max=1) * lr, on step's float32 tensor; a float32
  // tensor divided by a host scalar is a product with the scalar's reciprocal on the card
  const float step = __int2float_rn(h.step);
  const float warm = clamp_max(__fmul_rn(__fadd_rn(step, 1.0f), __fdiv_rn(1.0f, h.warmup)), 1.0f);
  Step s;
  s.lr = __fmul_rn(h.lr, warm);
  // c1 = 1 - b1 ** step, c2 = 1 - b2 ** step (pow of two float32 tensors: powf)
  s.c1 = __fsub_rn(1.0f, powf(h.b1, step));
  s.c2 = __fsub_rn(1.0f, powf(h.b2, step));
  s.scale = scale;
  s.b1 = h.b1;
  s.one_minus_b1 = h.one_minus_b1;
  s.b2 = h.b2;
  s.one_minus_b2 = h.one_minus_b2;
  s.eps = h.eps;
  s.weight_decay = h.weight_decay;
  if (blockIdx.x == 0 && threadIdx.x == 0 && gnorm_out != nullptr) {
    *gnorm_out = gnorm;
    *lr_out = s.lr;
  }
  const long long tiles = t.tile_start[t.count];
  int leaf = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    leaf = find_leaf(t, tile, leaf);
    const long long base = (tile - t.tile_start[leaf]) * kTile;
    const bool vec = t.flags[leaf] & kAligned;
    float* m = t.m[leaf];
    float* v = t.v[leaf];
    const long long n = t.n[leaf];
    switch (t.flags[leaf] & (kParamF32 | kGradF32)) {
      case 0:
        update_tile(static_cast<__nv_bfloat16*>(t.p[leaf]),
                    static_cast<const __nv_bfloat16*>(t.g[leaf]), m, v, n, base, vec, s);
        break;
      case kGradF32:
        update_tile(static_cast<__nv_bfloat16*>(t.p[leaf]), static_cast<const float*>(t.g[leaf]),
                    m, v, n, base, vec, s);
        break;
      case kParamF32:
        update_tile(static_cast<float*>(t.p[leaf]),
                    static_cast<const __nv_bfloat16*>(t.g[leaf]), m, v, n, base, vec, s);
        break;
      default:
        update_tile(static_cast<float*>(t.p[leaf]), static_cast<const float*>(t.g[leaf]), m, v,
                    n, base, vec, s);
    }
  }
}

// The table of ``count`` leaves from the host's kFields int64s a leaf.
int make_table(int count, const long long* host, Table* t) {
  if (count < 1 || count > kMaxLeaves) return static_cast<int>(cudaErrorInvalidValue);
  long long tiles = 0;
  for (int i = 0; i < count; ++i) {
    const long long* f = host + static_cast<long long>(i) * kFields;
    if (f[0] < 0) return static_cast<int>(cudaErrorInvalidValue);
    t->tile_start[i] = tiles;
    tiles += (f[0] + kTile - 1) / kTile;
    t->n[i] = f[0];
    t->p[i] = reinterpret_cast<void*>(f[1]);
    t->g[i] = reinterpret_cast<const void*>(f[2]);
    t->m[i] = reinterpret_cast<float*>(f[3]);
    t->v[i] = reinterpret_cast<float*>(f[4]);
    t->flags[i] = static_cast<unsigned char>(f[5]);
  }
  t->tile_start[count] = tiles;
  t->count = count;
  return 0;
}

// CTAs of the update kernel: as many as the card holds at once, at most
// one a tile, at least one (which writes the metrics of an empty group)
int update_grid(long long tiles, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adamw_update_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long full = static_cast<long long>(sms) * per_sm;
  *grid = static_cast<int>(tiles < full ? (tiles > 0 ? tiles : 1) : full);
  return 0;
}

}  // namespace

extern "C" {

// The norm's partial sums of one group of ``count`` leaves into
// partials[0 .. kNormCtas).
int adamw_norm(int count, const long long* table, double* partials, void* stream) {
  Table t;
  const int bad = make_table(count, table, &t);
  if (bad) return bad;
  adamw_norm_kernel<<<kNormCtas, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t, partials);
  return static_cast<int>(cudaGetLastError());
}

// The update of one group of ``count`` leaves, after every group's norm
// launch: the scale from all ``n_partials`` partials; grad_norm and lr
// written where ``gnorm``/``lr_out`` are not null.
int adamw_update(int count, const long long* table, const double* partials, int n_partials,
                 float* gnorm, float* lr_out, int step, float max_norm, float b1,
                 float one_minus_b1, float b2, float one_minus_b2, float eps,
                 float weight_decay, float lr, float warmup, void* stream) {
  Table t;
  int bad = make_table(count, table, &t);
  if (bad) return bad;
  int grid = 0;
  bad = update_grid(t.tile_start[count], &grid);
  if (bad) return bad;
  const Hyper h{max_norm, b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay, lr, warmup,
                step};
  adamw_update_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, partials, n_partials, h, gnorm, lr_out);
  return static_cast<int>(cudaGetLastError());
}

// {registers, CTAs an SM, threads, local bytes} of kernel ``which`` (0 the
// norm, 1 the update)
int adamw_kernel_info(int which, int* out) {
  const void* fns[] = {reinterpret_cast<const void*>(adamw_norm_kernel),
                       reinterpret_cast<const void*>(adamw_update_kernel)};
  if (which < 0 || which > 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fns[which]);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fns[which], kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = ctas;
  out[2] = kThreads;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // extern "C"
