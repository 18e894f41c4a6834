// S1: Mamba2's chunked SSD scan (state-space duality), forward and
// backward, for sm_90a.
//
// Replaces the reference's plain-jnp src/repro/models/mamba2.py
// ssd_chunked (no Pallas kernel computes it) and the eager einsum chain of
// its port (kernels/ssd.py::ssd_chunked_ref), which writes several
// (B, chunks, H, Q, Q) float32 tensors to device memory a call (about 19 GB
// a forward at Zamba2-7B's B 4, S 4,096, H 112, Q 256).
//
// What bounds it: the work a forward needs at those shapes is 60.8 GFLOP
// and about 0.49 GB of inputs and outputs, so on the tensor cores it would
// be bound by bytes (0.15 ms). The float32 rule (every product with a
// float32 operand keeps float32 accuracy, no TF32) puts the products on the
// CUDA cores' float32 FMA (67 TFLOP/s), where the operations bound it. The
// design therefore keeps the bytes at the inputs and outputs and spends the
// CUDA cores only on the contractions:
//   * every Q x Q tile lives in shared memory or registers, in 64 x 64
//     tiles; a CTA computes C B^T once for its (batch row, chunk, group,
//     64 rows) and walks up to 8 heads of the group over it;
//   * off-diagonal tiles of the decay mask exp(cs[q] - cs[k]) factor about
//     a row r between them into exp(cs[q] - cs[r]) * exp(cs[r] - cs[k])
//     (both exponents <= 0), which scale a product's rows and its operand's
//     rows, so only the diagonal tiles take an exp an element;
//   * the within-chunk cumulative sums cs of dt * A are taken in float64 (Q
//     values a head), so the exponents' differences lose nothing to
//     cancellation; all other arithmetic is float32;
//   * the products are 64 x 64 output tiles, 256 threads of 4 x 4 outputs
//     each, operands as float4 rows of shared memory (k-major, row stride
//     68 floats);
//   * the recurrence over chunks is one CTA a (batch row, head, 64 state
//     columns) walking the chunks in order with its (P, 64) carry in
//     registers; the forward saves the chunk-entering states (B, nc, H, P,
//     N) float32 for the backward, which recomputes every Q x Q tile.
//
// Forward: ssd_state_fwd_kernel (states entering each chunk, the final
// state), then ssd_fwd_kernel (y). Backward: ssd_state_bwd_kernel (the
// reverse recurrence: each chunk's state gradient G), ssd_bwd_kernel (dx,
// by 64 key rows), ssd_dbc_kernel (dC and dB partial sums, by 64 query
// rows), ssd_ddt_kernel (the cumulative sum's gradient: ddt and dA's
// partial sums), ssd_reduce_kernel (dB, dC, dA, dD). The partial sums go
// to a workspace of ssd_chunked_workspace floats (the cumulative sum's
// gradient, dA's and dD's as float64) and are summed in a fixed order, so
// a call repeats its bits.
//
// Shapes: x (B, S, H, P) and B, C (B, S, G, N) in float32 or bfloat16,
// their last two dims packed, any batch and sequence strides; dt (B, S, H),
// A (H,), D (H,) float32; P <= 64, N <= 128, chunk q <= 256 (the wrapper
// checks; a chunk that is not a multiple of 64 is masked).

#ifndef SSD_HOST_EMU
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#define SSD_SMEM(name) extern __shared__ float4 name[]
#define SSD_LAUNCH(kern, grid, smem, stream) kern<<<(grid), NT, (smem), (stream)>>>
#endif

#include <stdint.h>

constexpr int NT = 256;    // threads a CTA
constexpr int TILE = 64;   // a product's output tile is TILE x TILE
constexpr int LD = 68;     // a shared tile's row stride in floats
constexpr int MAX_HB = 8;  // heads a CTA walks over one C B^T

struct Dims {
  int b, s, h, p, g, n, q;  // batch, sequence, heads, head dim, groups, state, chunk
  int nc, nqt, qp, hg, hb, nhb, np, ntn, ldn;
  // chunks, 64-row tiles a chunk, nqt * 64, heads a group, heads a CTA,
  // head blocks a group, N padded to 64 or 128, np / 64, np + 4
};

static Dims make_dims(int b, int s, int h, int p, int g, int n, int q, int hb) {
  Dims d;
  d.b = b; d.s = s; d.h = h; d.p = p; d.g = g; d.n = n; d.q = q;
  d.nc = s / q;
  d.nqt = (q + TILE - 1) / TILE;
  d.qp = d.nqt * TILE;
  d.hg = h / g;
  d.hb = hb;
  d.nhb = d.hg / hb;
  d.np = n <= TILE ? TILE : 2 * TILE;
  d.ntn = d.np / TILE;
  d.ldn = d.np + 4;
  return d;
}

// ---------------------------------------------------------------------------
// shared-memory layouts, one per kernel (offsets in floats; doubles last)
// ---------------------------------------------------------------------------

struct StateLayout {  // ssd_state_fwd_kernel, ssd_state_bwd_kernel
  int ta, tb, vec, cs, red, floats;
  __host__ __device__ StateLayout(const Dims& d) {
    ta = 0;
    tb = ta + TILE * LD;
    vec = tb + TILE * LD;
    cs = vec + d.qp;          // qp doubles
    red = cs + 2 * d.qp;      // NT / 32 doubles
    floats = red + 2 * (NT / 32);
  }
};

struct FwdLayout {  // ssd_fwd_kernel
  int ct, st, w1, w2, rowv, colv, dts, dth, cs, floats;
  __host__ __device__ FwdLayout(const Dims& d) {
    ct = 0;
    st = ct + d.np * LD;
    w1 = st + d.nqt * TILE * LD;
    w2 = w1 + d.np * LD;
    rowv = w2 + TILE * LD;
    colv = rowv + TILE;
    dts = colv + d.qp;
    dth = dts + TILE;             // hb x qp: the heads' dt
    cs = dth + d.hb * d.qp;       // hb x qp doubles
    floats = cs + 2 * d.hb * d.qp;
  }
};

struct BwdLayout {  // ssd_bwd_kernel
  int bt, st, w1, w2, w3, w4, vu, vv, vde, vdt, dth, cs, red, floats;
  __host__ __device__ BwdLayout(const Dims& d) {
    bt = 0;
    st = bt + d.np * LD;
    w1 = st + d.nqt * TILE * LD;
    w2 = w1 + d.np * LD;
    w3 = w2 + TILE * LD;
    w4 = w3 + TILE * LD;
    vu = w4 + TILE * LD;
    vv = vu + d.qp;
    vde = vv + TILE;
    vdt = vde + TILE;
    dth = vdt + TILE;             // hb x qp: the heads' dt
    cs = dth + d.hb * d.qp;       // hb x qp doubles
    red = cs + 2 * d.hb * d.qp;
    floats = red + 2 * (NT / 32);
  }
};

struct DbcLayout {  // ssd_dbc_kernel
  int ct, cn, x1, x2, x3, colred, rows, vq, vk, vdin, vde, dth, cs, floats;  // colred, rows: doubles
  __host__ __device__ DbcLayout(const Dims& d) {
    const int wide = TILE * d.ldn;
    ct = 0;
    cn = ct + d.np * LD;
    x1 = cn + wide;
    x2 = x1 + (d.np * LD > wide ? d.np * LD : wide);
    x3 = x2 + TILE * LD;
    colred = x3 + wide;
    rows = colred + 2 * (NT / 32) * TILE;  // doubles
    vq = rows + 2 * MAX_HB * TILE;        // doubles
    vk = vq + d.hb * TILE;                // hb x 64
    vdin = vk + d.hb * d.qp;              // hb x qp
    vde = vdin + TILE;
    dth = vde + TILE;             // hb x qp: the heads' dt
    cs = dth + d.hb * d.qp;       // hb x qp doubles
    floats = cs + 2 * d.hb * d.qp;
  }
};

// ---------------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------------

namespace ssd {

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// exp of a float64 exponent difference (<= 0), rounded to float32 first
__device__ __forceinline__ float dexp(double e) { return expf(static_cast<float>(e)); }

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_{k < kdim} at[k][4 ty + i] * bk[k][4 tx + j]: a 64 x 64
// output tile, thread (ty, tx) = (tid / 16, tid % 16); at and bk k-major in
// shared memory, row strides lda and ldb (multiples of 4)
__device__ __forceinline__ void mma(float (&acc)[4][4], const float* __restrict__ at, int lda,
                                    const float* __restrict__ bk, int ldb, int kdim) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  at += 4 * ty;
  bk += 4 * tx;
#pragma unroll 4
  for (int k = 0; k < kdim; ++k) {
    const float4 a4 = *reinterpret_cast<const float4*>(at + k * lda);
    const float4 b4 = *reinterpret_cast<const float4*>(bk + k * ldb);
    const float av[4] = {a4.x, a4.y, a4.z, a4.w};
    const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// 16 bytes of T as floats
__device__ __forceinline__ void unpack(const uint4& u, const float*, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, const __nv_bfloat16*, float (&f)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <typename T> struct Per16 { static constexpr int n = 16 / sizeof(T); };

// An R x C block of shared memory from rows of global memory: natural,
// dst[r][c] (row stride ldd), or transposed, dst[c][r]; the value is
// src[r * rs + c] * mul * rowscale[r] for r < rows, c < cols, else 0. Rows
// whose 16-byte pieces are aligned move 16 bytes a load (natural: a warp
// reads whole rows; transposed: 32 rows a warp, so the scattered stores to
// shared memory fall on 32 banks); other rows an element a load.
template <bool Transposed, typename T>
__device__ void load_tile(float* dst, int ldd, const T* src, long long rs, int rows, int cols,
                          int R, int C, const float* rowscale = nullptr, float mul = 1.f) {
  constexpr int V = Per16<T>::n;
  const bool vec = ((reinterpret_cast<uintptr_t>(src) | static_cast<uintptr_t>(rs * sizeof(T))) &
                    15) == 0 && cols % V == 0 && C % V == 0;
  if (!vec) {
    for (int e = threadIdx.x; e < R * C; e += NT) {
      const int r = Transposed ? e % R : e / C, c = Transposed ? e / R : e % C;
      float v = 0.f;
      if (r < rows && c < cols) {
        v = ld(src + r * rs + c) * mul;
        if (rowscale) v *= rowscale[r];
      }
      dst[Transposed ? c * ldd + r : r * ldd + c] = v;
    }
    return;
  }
  const int per = C / V;  // 16-byte pieces a row
  for (int e = threadIdx.x; e < R * per; e += NT) {
    const int r = Transposed ? e % R : e / per, c = (Transposed ? e / R : e % per) * V;
    float f[V];
    if (r < rows && c < cols) {
      unpack(__ldg(reinterpret_cast<const uint4*>(src + r * rs + c)), src, f);
      const float k = rowscale ? mul * rowscale[r] : mul;
#pragma unroll
      for (int u = 0; u < V; ++u) f[u] *= k;
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) f[u] = 0.f;
    }
    if (Transposed) {
#pragma unroll
      for (int u = 0; u < V; ++u) dst[(c + u) * ldd + r] = f[u];
    } else {
#pragma unroll
      for (int u = 0; u < V; u += 4)
        *reinterpret_cast<float4*>(dst + r * ldd + c + u) = make_float4(f[u], f[u + 1], f[u + 2], f[u + 3]);
    }
  }
}

template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ldd, const T* src, long long rs, int rows,
                                          int cols, int R, int C, const float* rowscale = nullptr,
                                          float mul = 1.f) {
  load_tile<false>(dst, ldd, src, rs, rows, cols, R, C, rowscale, mul);
}
template <typename T>
__device__ __forceinline__ void load_cols(float* dst, int ldd, const T* src, long long rs, int rows,
                                          int cols, int R, int C, const float* rowscale = nullptr,
                                          float mul = 1.f) {
  load_tile<true>(dst, ldd, src, rs, rows, cols, R, C, rowscale, mul);
}

// A thread's share of a 64 x 64 tile of T, fetched into registers ahead of
// the product that comes before its use, so its loads are in flight during
// that product; put() converts, scales and stores it as load_tile would
// (rows whose 16-byte pieces are not aligned are loaded by put itself).
template <bool Transposed, typename T>
struct TileFetch {
  static constexpr int V = Per16<T>::n, PER = TILE / V, K = TILE * PER / NT;
  uint4 v[K];
  bool vec;

  __device__ __forceinline__ void fetch(const T* src, long long rs, int rows, int cols) {
    vec = ((reinterpret_cast<uintptr_t>(src) | static_cast<uintptr_t>(rs * sizeof(T))) & 15) == 0 &&
          cols % V == 0;
    if (!vec) return;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int e = threadIdx.x + k * NT;
      const int r = Transposed ? e % TILE : e / PER, c = (Transposed ? e / TILE : e % PER) * V;
      v[k] = (r < rows && c < cols) ? __ldg(reinterpret_cast<const uint4*>(src + r * rs + c))
                                    : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ void put(float* dst, int ldd, const T* src, long long rs, int rows,
                                      int cols, const float* rowscale = nullptr, float mul = 1.f) {
    if (!vec) {
      load_tile<Transposed>(dst, ldd, src, rs, rows, cols, TILE, TILE, rowscale, mul);
      return;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int e = threadIdx.x + k * NT;
      const int r = Transposed ? e % TILE : e / PER, c = (Transposed ? e / TILE : e % PER) * V;
      float f[V];
      unpack(v[k], src, f);
      if (r < rows && c < cols) {
        const float sc = rowscale ? mul * rowscale[r] : mul;
#pragma unroll
        for (int u = 0; u < V; ++u) f[u] *= sc;
      }
      if (Transposed) {
#pragma unroll
        for (int u = 0; u < V; ++u) dst[(c + u) * ldd + r] = f[u];
      } else {
#pragma unroll
        for (int u = 0; u < V; u += 4)
          *reinterpret_cast<float4*>(dst + r * ldd + c + u) =
              make_float4(f[u], f[u + 1], f[u + 2], f[u + 3]);
      }
    }
  }
};

// dst[hh * ld + t] = dt[t * h + hh], t < q, hh < heads: a chunk's dt of
// ``heads`` neighbouring heads into shared memory, a token's heads by
// neighbouring threads
__device__ void stage_dt(float* dst, int ld, const float* dt, int h, int q, int heads) {
  for (int e = threadIdx.x; e < q * heads; e += NT) {
    const int t = e / heads, hh = e - t * heads;
    dst[hh * ld + t] = dt[static_cast<long long>(t) * h + hh];
  }
}

// the acc tile into shared memory: natural (dst[4 ty + i][4 tx + j]) or
// transposed (dst[4 tx + j][4 ty + i])
__device__ __forceinline__ void store_tile(float* dst, const float (&acc)[4][4], bool transposed) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (transposed)
      *reinterpret_cast<float4*>(dst + (4 * tx + u) * LD + 4 * ty) =
          make_float4(acc[0][u], acc[1][u], acc[2][u], acc[3][u]);
    else
      *reinterpret_cast<float4*>(dst + (4 * ty + u) * LD + 4 * tx) =
          make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
  }
}

// cs[t] = sum_{u <= t} (dts[u] * a), t < q (dts in shared memory): each
// term rounded to float32 as the reference's dt * a, the sum in float64.
// One whole warp.
__device__ void warp_cumsum(double* cs, const float* dts, float a, int q, int lane) {
  const int per = (q + 31) >> 5, lo = lane * per, hi = min(lo + per, q);
  double run = 0.0;
  for (int t = lo; t < hi; ++t) {
    run += static_cast<double>(dts[t] * a);
    cs[t] = run;
  }
  double inc = run;
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += v;
  }
  const double off = inc - run;
  for (int t = lo; t < hi; ++t) cs[t] += off;
}

// v[t] <- sum_{t <= u < q} v[u]. One whole warp.
__device__ void warp_rev_cumsum(double* v, int q, int lane) {
  const int per = (q + 31) >> 5, lo = lane * per, hi = min(lo + per, q);
  double run = 0.0;
  for (int t = hi - 1; t >= lo; --t) {
    run += v[t];
    v[t] = run;
  }
  double inc = run;
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_down_sync(0xffffffffu, inc, o);
    if (lane + o < 32) inc += u;
  }
  const double off = inc - run;
  for (int t = lo; t < hi; ++t) v[t] += off;
}

// the sum over the CTA of every thread's v (all threads call; red holds
// NT / 32 doubles), in a fixed order
__device__ double block_sum(double v, double* red) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double t = 0.0;
  for (int w = 0; w < NT / 32; ++w) t += red[w];
  return t;
}

// the sum over the 16 threads of a row of the output tile (same ty)
template <typename F>
__device__ __forceinline__ F row_sum(F v) {
  for (int o = 8; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace ssd

using namespace ssd;

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// The chunk-final states and the recurrence over chunks. CTA (64 state
// columns, head, batch row) walks the chunks in order; thread (ty, tx) owns
// the carry's rows p = 4 ty + i and columns n0 + 4 tx + j. Writes the state
// entering each chunk, ent (B, nc, H, P, N), and the final state (B, H, P, N).
template <typename T>
__global__ void __launch_bounds__(NT, 2)
ssd_state_fwd_kernel(const T* x, long long xsb, long long xss, const float* dt, const float* a,
                     const T* bm, long long bsb, long long bss, float* ent, float* fin, Dims d) {
  SSD_SMEM(smem4);
  float* sm = reinterpret_cast<float*>(smem4);
  const StateLayout L(d);
  float* ta = sm + L.ta;  // x * dt * exp(cs[q-1] - cs) rows (token x p)
  float* tb = sm + L.tb;  // B rows (token x 64 state columns)
  float* vec = sm + L.vec;
  double* cs = reinterpret_cast<double*>(sm + L.cs);
  const int n0 = blockIdx.x * TILE, hi = blockIdx.y, bb = blockIdx.z;
  const int gi = hi / d.hg, tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int ncols = min(TILE, d.n - n0);
  const float av = a[hi];
  float carry[4][4];
  zero(carry);
  TileFetch<false, T> fa, fb;
  for (int c = 0; c < d.nc; ++c) {
    const long long t0 = static_cast<long long>(c) * d.q;
    const float* dtc = dt + (static_cast<long long>(bb) * d.s + t0) * d.h + hi;
    const T* xc = x + bb * xsb + t0 * xss + static_cast<long long>(hi) * d.p;
    const T* bc = bm + bb * bsb + t0 * bss + static_cast<long long>(gi) * d.n + n0;
    fa.fetch(xc, xss, min(TILE, d.q), d.p);
    fb.fetch(bc, bss, min(TILE, d.q), ncols);
    __syncthreads();
    stage_dt(vec, 0, dtc, d.h, d.q, 1);
    __syncthreads();
    if (threadIdx.x < 32) warp_cumsum(cs, vec, av, d.q, threadIdx.x);
    __syncthreads();
    const double last = cs[d.q - 1];
    for (int t = threadIdx.x; t < d.q; t += NT) vec[t] *= dexp(last - cs[t]);
    float acc[4][4];
    zero(acc);
    for (int i = 0; i < d.nqt; ++i) {
      const int r0 = i * TILE, rows = min(TILE, d.q - r0);
      __syncthreads();
      fa.put(ta, LD, xc + r0 * xss, xss, rows, d.p, vec + r0);
      fb.put(tb, LD, bc + r0 * bss, bss, rows, ncols);
      if (i + 1 < d.nqt) {
        fa.fetch(xc + (r0 + TILE) * xss, xss, min(TILE, d.q - r0 - TILE), d.p);
        fb.fetch(bc + (r0 + TILE) * bss, bss, min(TILE, d.q - r0 - TILE), ncols);
      }
      __syncthreads();
      mma(acc, ta, LD, tb, LD, rows);
    }
    const float cd = dexp(last);
    float* e = ent + ((static_cast<long long>(bb) * d.nc + c) * d.h + hi) * d.p * d.n;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = 4 * ty + i, nn = n0 + 4 * tx + j;
        if (p < d.p && nn < d.n) e[p * d.n + nn] = carry[i][j];
        carry[i][j] = fmaf(carry[i][j], cd, acc[i][j]);
      }
  }
  float* f = fin + (static_cast<long long>(bb) * d.h + hi) * d.p * d.n;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = 4 * ty + i, nn = n0 + 4 * tx + j;
      if (p < d.p && nn < d.n) f[p * d.n + nn] = carry[i][j];
    }
}

// y for 64 rows of a chunk and a block of hb heads of one group: CTA
// (row tile i + nqt * (head block + nhb * group), chunk, batch row).
// S_ij = C_i B_j^T (j <= i) is computed once into shared memory; each head
// then sums, into one 64 x P tile,
//   sum_{j < i} S_ij (x dt exp(cs[r] - cs))_j + C_i (exp(cs[r]) E)^T,
// scales its rows by exp(cs[q] - cs[r]) (r = 64 i - 1, cs[-1] = 0), adds
// the diagonal tile's (S_ii * exp(cs[q] - cs[k])) (x dt)_i and D x.
template <typename T>
__global__ void __launch_bounds__(NT, 1)
ssd_fwd_kernel(const T* x, long long xsb, long long xss, const float* dt, const float* a,
               const T* bm, long long bsb, long long bss, const T* cm, long long csb,
               long long css, const float* dskip, const float* ent, T* y, Dims d) {
  SSD_SMEM(smem4);
  float* sm = reinterpret_cast<float*>(smem4);
  const FwdLayout L(d);
  float* ct = sm + L.ct;  // C_i^T [n][q]
  float* sts = sm + L.st; // S_ij^T [k][q], j <= i
  float* w1 = sm + L.w1;
  float* w2 = sm + L.w2;
  float* rowv = sm + L.rowv;
  float* colv = sm + L.colv;
  float* dts = sm + L.dts;
  float* dth = sm + L.dth;
  double* csall = reinterpret_cast<double*>(sm + L.cs);
  const int i = blockIdx.x % d.nqt, rest = blockIdx.x / d.nqt;
  const int hbi = rest % d.nhb, gi = rest / d.nhb, c = blockIdx.y, bb = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long t0 = static_cast<long long>(c) * d.q;
  const int r0 = i * TILE, rows = min(TILE, d.q - r0);
  const T* cb = cm + bb * csb + t0 * css + static_cast<long long>(gi) * d.n;
  const T* bbase = bm + bb * bsb + t0 * bss + static_cast<long long>(gi) * d.n;
  const int h0 = gi * d.hg + hbi * d.hb;

  stage_dt(dth, d.qp, dt + (static_cast<long long>(bb) * d.s + t0) * d.h + h0, d.h, r0 + rows,
           d.hb);
  __syncthreads();
  if (static_cast<int>(threadIdx.x >> 5) < d.hb)
    warp_cumsum(csall + (threadIdx.x >> 5) * d.qp, dth + (threadIdx.x >> 5) * d.qp,
                a[h0 + (threadIdx.x >> 5)], r0 + rows, threadIdx.x & 31);
  load_cols(ct, LD, cb + r0 * css, css, rows, d.n, TILE, d.np);
  for (int j = 0; j <= i; ++j) {
    __syncthreads();
    load_cols(w1, LD, bbase + j * TILE * bss, bss, min(TILE, d.q - j * TILE), d.n, TILE, d.np);
    __syncthreads();
    float s[4][4];
    zero(s);
    mma(s, ct, LD, w1, LD, d.n);
    store_tile(sts + j * TILE * LD, s, true);
  }

  for (int hh = 0; hh < d.hb; ++hh) {
    const int hi = h0 + hh;
    const double* cs = csall + hh * d.qp;
    const float* dtc = dth + hh * d.qp;
    const T* xh = x + bb * xsb + t0 * xss + static_cast<long long>(hi) * d.p;
    __syncthreads();
    const double csr = i ? cs[r0 - 1] : 0.0;
    for (int t = threadIdx.x; t < r0; t += NT) colv[t] = dtc[t] * dexp(csr - cs[t]);
    for (int t = threadIdx.x; t < TILE; t += NT) {
      rowv[t] = t < rows ? dexp(cs[r0 + t] - csr) : 0.f;
      dts[t] = t < rows ? dtc[r0 + t] : 0.f;
    }
    float acc[4][4];
    zero(acc);
    TileFetch<false, T> fx, fd;
    fd.fetch(xh + r0 * xss, xss, rows, d.p);
    if (i) fx.fetch(xh, xss, TILE, d.p);
    for (int j = 0; j < i; ++j) {
      __syncthreads();
      fx.put(w1, LD, xh + j * TILE * xss, xss, TILE, d.p, colv + j * TILE);
      if (j + 1 < i) fx.fetch(xh + (j + 1) * TILE * xss, xss, TILE, d.p);
      __syncthreads();
      mma(acc, sts + j * TILE * LD, LD, w1, LD, TILE);
    }
    // the entering state, exp(cs[r]) E as [n][p]
    __syncthreads();
    load_cols(w1, LD, ent + ((static_cast<long long>(bb) * d.nc + c) * d.h + hi) * d.p * d.n,
              d.n, d.p, d.n, TILE, d.np, nullptr, dexp(csr));
    __syncthreads();
    mma(acc, ct, LD, w1, LD, d.n);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] *= rowv[4 * ty + u];
    // the diagonal tile: M_ii^T [k][q]
    __syncthreads();
    const float* si = sts + i * TILE * LD;
    for (int e = threadIdx.x; e < TILE * TILE; e += NT) {
      const int k = e >> 6, qq = e & 63;
      w2[k * LD + qq] = (qq >= k && qq < rows) ? si[k * LD + qq] * dexp(cs[r0 + qq] - cs[r0 + k])
                                               : 0.f;
    }
    fd.put(w1, LD, xh + r0 * xss, xss, rows, d.p, dts);
    __syncthreads();
    // M_ii is lower triangular: a warp's rows (8 of them) need k < 8 (warp + 1)
    mma(acc, w2, LD, w1, LD, min(rows, 8 * static_cast<int>(threadIdx.x / 32 + 1)));
    const float dv = dskip[hi];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int qq = 4 * ty + u, pp = 4 * tx + v;
        if (qq < rows && pp < d.p) {
          const long long tok = t0 + r0 + qq;
          const float xv = ld(x + bb * xsb + tok * xss + static_cast<long long>(hi) * d.p + pp);
          st(y + ((static_cast<long long>(bb) * d.s + tok) * d.h + hi) * d.p + pp,
             acc[u][v] + xv * dv);
        }
      }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// The reverse recurrence over chunks: CTA (64 state columns, head, batch
// row) walks the chunks from the last, g = dfin (or 0) in registers. At
// chunk c: G_c = g, dcdp = <g, E_c> exp(cs[q-1]) (this CTA's columns),
// g <- (exp(cs) C)^T dy + exp(cs[q-1]) g.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
ssd_state_bwd_kernel(const T* dy, long long dysb, long long dyss, const float* dt, const float* a,
                     const T* cm, long long csb, long long css, const float* dfin,
                     const float* ent, float* gst, double* dcdp, Dims d) {
  SSD_SMEM(smem4);
  float* sm = reinterpret_cast<float*>(smem4);
  const StateLayout L(d);
  float* ta = sm + L.ta;  // dy * exp(cs) rows (token x p)
  float* tb = sm + L.tb;  // C rows (token x 64 state columns)
  float* vec = sm + L.vec;
  double* cs = reinterpret_cast<double*>(sm + L.cs);
  double* red = reinterpret_cast<double*>(sm + L.red);
  const int n0 = blockIdx.x * TILE, hi = blockIdx.y, bb = blockIdx.z;
  const int gi = hi / d.hg, tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int ncols = min(TILE, d.n - n0);
  const float av = a[hi];
  float g[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = 4 * ty + i, nn = n0 + 4 * tx + j;
      g[i][j] = (dfin && p < d.p && nn < d.n)
                    ? dfin[(static_cast<long long>(bb) * d.h + hi) * d.p * d.n + p * d.n + nn]
                    : 0.f;
    }
  TileFetch<false, T> fa, fb;
  for (int c = d.nc - 1; c >= 0; --c) {
    const long long t0 = static_cast<long long>(c) * d.q;
    const float* dtc = dt + (static_cast<long long>(bb) * d.s + t0) * d.h + hi;
    const T* dyc = dy + bb * dysb + t0 * dyss + static_cast<long long>(hi) * d.p;
    const T* cc = cm + bb * csb + t0 * css + static_cast<long long>(gi) * d.n + n0;
    fa.fetch(dyc, dyss, min(TILE, d.q), d.p);
    fb.fetch(cc, css, min(TILE, d.q), ncols);
    __syncthreads();
    stage_dt(vec, 0, dtc, d.h, d.q, 1);
    __syncthreads();
    if (threadIdx.x < 32) warp_cumsum(cs, vec, av, d.q, threadIdx.x);
    __syncthreads();
    const double last = cs[d.q - 1];
    for (int t = threadIdx.x; t < d.q; t += NT) vec[t] = dexp(cs[t]);
    const float cd = dexp(last);
    const long long base = ((static_cast<long long>(bb) * d.nc + c) * d.h + hi) * d.p * d.n;
    double part = 0.0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = 4 * ty + i, nn = n0 + 4 * tx + j;
        if (p < d.p && nn < d.n) {
          gst[base + p * d.n + nn] = g[i][j];
          part += static_cast<double>(g[i][j]) * ent[base + p * d.n + nn];
        }
      }
    const double dcd = block_sum(part, red);
    if (threadIdx.x == 0)
      dcdp[((static_cast<long long>(bb) * d.nc + c) * d.h + hi) * d.ntn + blockIdx.x] = dcd * cd;
    float acc[4][4];
    zero(acc);
    for (int i = 0; i < d.nqt; ++i) {
      const int r0 = i * TILE, rows = min(TILE, d.q - r0);
      __syncthreads();
      fa.put(ta, LD, dyc + r0 * dyss, dyss, rows, d.p, vec + r0);
      fb.put(tb, LD, cc + r0 * css, css, rows, ncols);
      if (i + 1 < d.nqt) {
        fa.fetch(dyc + (r0 + TILE) * dyss, dyss, min(TILE, d.q - r0 - TILE), d.p);
        fb.fetch(cc + (r0 + TILE) * css, css, min(TILE, d.q - r0 - TILE), ncols);
      }
      __syncthreads();
      mma(acc, ta, LD, tb, LD, rows);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) g[i][j] = fmaf(g[i][j], cd, acc[i][j]);
  }
}

// dx for 64 key rows k of a chunk (tile j) and hb heads of one group: CTA
// (j + nqt * (head block + nhb * group), chunk, batch row). With S_ij
// computed once (i >= j), each head sums
//   dxd = exp(cs[t] - cs) * sum_{i > j} S_ij^T (dy exp(cs - cs[t]))_i
//         + (S_jj * exp(cs[q] - cs[k]))^T dy_j + exp(cs[q-1] - cs) (B_j G^T)
// (t = 64 j + 63), writes dx = dxd dt + dy D, dxdt = rowsum(dxd x), stcs =
// -exp(cs[q-1] - cs) rowsum(x dt (B G^T)), and the tile's partial sums of
// that last term (lastp, for dcs[q-1]) and of dy x (ddp, for dD).
template <typename T>
__global__ void __launch_bounds__(NT, 1)
ssd_bwd_kernel(const T* x, long long xsb, long long xss, const float* dt, const float* a,
               const T* bm, long long bsb, long long bss, const T* cm, long long csb,
               long long css, const float* dskip, const T* dy, long long dysb, long long dyss,
               const float* gst, T* dx, double* dxdt, double* stcs, double* lastp, double* ddp,
               Dims d) {
  SSD_SMEM(smem4);
  float* sm = reinterpret_cast<float*>(smem4);
  const BwdLayout L(d);
  float* bt = sm + L.bt;   // B_j^T [n][k]
  float* sts = sm + L.st;  // S_ij [q][k], i >= j
  float* w1 = sm + L.w1;
  float* w2 = sm + L.w2;
  float* w3 = sm + L.w3;
  float* w4 = sm + L.w4;
  float* vu = sm + L.vu;
  float* vv = sm + L.vv;
  float* vde = sm + L.vde;
  float* vdt = sm + L.vdt;
  float* dth = sm + L.dth;
  double* csall = reinterpret_cast<double*>(sm + L.cs);
  double* red = reinterpret_cast<double*>(sm + L.red);
  const int j = blockIdx.x % d.nqt, rest = blockIdx.x / d.nqt;
  const int hbi = rest % d.nhb, gi = rest / d.nhb, c = blockIdx.y, bb = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long t0 = static_cast<long long>(c) * d.q;
  const int k0 = j * TILE, kv = min(TILE, d.q - k0);
  const bool off = j + 1 < d.nqt;
  const T* cb = cm + bb * csb + t0 * css + static_cast<long long>(gi) * d.n;
  const T* bbase = bm + bb * bsb + t0 * bss + static_cast<long long>(gi) * d.n;
  const int h0 = gi * d.hg + hbi * d.hb;

  stage_dt(dth, d.qp, dt + (static_cast<long long>(bb) * d.s + t0) * d.h + h0, d.h, d.q, d.hb);
  __syncthreads();
  if (static_cast<int>(threadIdx.x >> 5) < d.hb)
    warp_cumsum(csall + (threadIdx.x >> 5) * d.qp, dth + (threadIdx.x >> 5) * d.qp,
                a[h0 + (threadIdx.x >> 5)], d.q, threadIdx.x & 31);
  load_cols(bt, LD, bbase + k0 * bss, bss, kv, d.n, TILE, d.np);
  for (int i = j; i < d.nqt; ++i) {
    __syncthreads();
    load_cols(w1, LD, cb + i * TILE * css, css, min(TILE, d.q - i * TILE), d.n, TILE, d.np);
    __syncthreads();
    float s[4][4];
    zero(s);
    mma(s, w1, LD, bt, LD, d.n);
    store_tile(sts + i * TILE * LD, s, false);
  }

  for (int hh = 0; hh < d.hb; ++hh) {
    const int hi = h0 + hh;
    const double* cs = csall + hh * d.qp;
    const float* dtc = dth + hh * d.qp;
    const T* xh = x + bb * xsb + t0 * xss + static_cast<long long>(hi) * d.p;
    const T* dyh = dy + bb * dysb + t0 * dyss + static_cast<long long>(hi) * d.p;
    const long long sbase = (static_cast<long long>(bb) * d.nc + c) * d.h + hi;
    __syncthreads();
    const double cst = off ? cs[k0 + TILE - 1] : 0.0, last = cs[d.q - 1];
    for (int t = threadIdx.x; t < TILE; t += NT) {
      vv[t] = off ? dexp(cst - cs[k0 + t]) : 0.f;
      vde[t] = t < kv ? dexp(last - cs[k0 + t]) : 0.f;
      vdt[t] = t < kv ? dtc[k0 + t] : 0.f;
    }
    for (int t = threadIdx.x; t < d.q - k0 - TILE; t += NT) vu[t] = dexp(cs[k0 + TILE + t] - cst);
    __syncthreads();
    float acc[4][4];
    zero(acc);
    TileFetch<false, T> fy, fdy, fxj;
    fdy.fetch(dyh + k0 * dyss, dyss, kv, d.p);
    fxj.fetch(xh + k0 * xss, xss, kv, d.p);
    if (off) fy.fetch(dyh + (k0 + TILE) * dyss, dyss, min(TILE, d.q - k0 - TILE), d.p);
    for (int i = j + 1; i < d.nqt; ++i) {
      const int rows = min(TILE, d.q - i * TILE);
      __syncthreads();
      fy.put(w2, LD, dyh + i * TILE * dyss, dyss, rows, d.p, vu + (i - j - 1) * TILE);
      if (i + 1 < d.nqt)
        fy.fetch(dyh + (i + 1) * TILE * dyss, dyss, min(TILE, d.q - (i + 1) * TILE), d.p);
      __syncthreads();
      mma(acc, sts + i * TILE * LD, LD, w2, LD, rows);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] *= vv[4 * ty + u];
    // the diagonal tile M_jj [q][k], dy_j, G^T [n][p], x dt
    __syncthreads();
    const float* sj = sts + j * TILE * LD;
    for (int e = threadIdx.x; e < TILE * TILE; e += NT) {
      const int qq = e >> 6, k = e & 63;
      w3[qq * LD + k] = (qq >= k && qq < kv) ? sj[qq * LD + k] * dexp(cs[k0 + qq] - cs[k0 + k])
                                             : 0.f;
    }
    fdy.put(w2, LD, dyh + k0 * dyss, dyss, kv, d.p);
    load_cols(w1, LD, gst + sbase * d.p * d.n, d.n, d.p, d.n, TILE, d.np);
    fxj.put(w4, LD, xh + k0 * xss, xss, kv, d.p, vdt);
    __syncthreads();
    // M_jj is lower triangular: a warp's keys (8 of them) need q >= 8 warp
    const int q0 = min(kv, 8 * static_cast<int>(threadIdx.x / 32));
    mma(acc, w3 + q0 * LD, LD, w2 + q0 * LD, LD, kv - q0);
    float uu[4][4];
    zero(uu);
    mma(uu, bt, LD, w1, LD, d.n);
    const float dv = dskip[hi];
    double ddpart = 0.0, lastpart = 0.0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = 4 * ty + u;
      double dde = 0.0, dxx = 0.0;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int pp = 4 * tx + v;
        dde += static_cast<double>(w4[k * LD + pp] * uu[u][v]);
        const float gx = fmaf(vde[k], uu[u][v], acc[u][v]);
        if (k < kv && pp < d.p) {
          const long long tok = t0 + k0 + k;
          const float xv = ld(x + bb * xsb + tok * xss + static_cast<long long>(hi) * d.p + pp);
          const float dyv = w2[k * LD + pp];
          dxx += static_cast<double>(gx * xv);
          ddpart += static_cast<double>(dyv) * xv;
          st(dx + ((static_cast<long long>(bb) * d.s + tok) * d.h + hi) * d.p + pp,
             gx * vdt[k] + dyv * dv);
        }
      }
      dde = row_sum(dde);
      dxx = row_sum(dxx);
      if (tx == 0 && k < kv) {
        const long long si = (static_cast<long long>(bb) * d.s + t0 + k0 + k) * d.h + hi;
        dxdt[si] = dxx;
        stcs[si] = -vde[k] * dde;
        lastpart += vde[k] * dde;
      }
    }
    const double ddsum = block_sum(ddpart, red);
    const double lsum = block_sum(lastpart, red);
    if (threadIdx.x == 0) {
      ddp[sbase * d.nqt + j] = ddsum;
      lastp[sbase * d.nqt + j] = lsum;
    }
  }
}

// dC and dB's partial sums for 64 query rows q (tile i) and hb heads of one
// group: CTA (i + nqt * (head block + nhb * group), chunk, batch row).
// Per head: dC += exp(cs) (dy E), rows += exp(cs) rowsum(C (dy E)), and the
// state path's dB for these rows, exp(cs[q-1] - cs) (x dt) G. Then for each
// key tile j <= i: S_ij = C_i B_j^T, and per head dS = (dy_i (x dt)_j^T) * L
// (L the decay mask), T = dS * S off the diagonal (rows += rowsum(T), colt =
// colsum(T)), summed over the heads into dS; dC += dS B_j, and dBp[i][j] =
// dS^T C_i (plus the state path's term when j == i).
template <typename T>
__global__ void __launch_bounds__(NT, 1)
ssd_dbc_kernel(const T* x, long long xsb, long long xss, const float* dt, const float* a,
               const T* bm, long long bsb, long long bss, const T* cm, long long csb,
               long long css, const T* dy, long long dysb, long long dyss, const float* ent,
               const float* gst, double* rowt, double* colt, float* dcp, float* dbp, Dims d) {
  SSD_SMEM(smem4);
  float* sm = reinterpret_cast<float*>(smem4);
  const DbcLayout L(d);
  float* ct = sm + L.ct;  // C_i^T [n][q]
  float* cn = sm + L.cn;  // C_i [q][n], row stride ldn
  float* x1 = sm + L.x1;
  float* x2 = sm + L.x2;
  float* x3 = sm + L.x3;
  double* colred = reinterpret_cast<double*>(sm + L.colred);
  double* rows_ = reinterpret_cast<double*>(sm + L.rows);
  float* vq = sm + L.vq;  // per head: exp(cs[q] - cs[r0 - 1]), the tile's rows
  float* vk = sm + L.vk;  // per head: exp(cs[r0 - 1] - cs[k]), k < r0
  float* vdin = sm + L.vdin;
  float* vde = sm + L.vde;
  float* dth = sm + L.dth;
  double* csall = reinterpret_cast<double*>(sm + L.cs);
  const int i = blockIdx.x % d.nqt, rest = blockIdx.x / d.nqt;
  const int hbi = rest % d.nhb, gi = rest / d.nhb, c = blockIdx.y, bb = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4, warp = threadIdx.x >> 5;
  const long long t0 = static_cast<long long>(c) * d.q;
  const int r0 = i * TILE, rv = min(TILE, d.q - r0), ldn = d.ldn;
  const T* cb = cm + bb * csb + t0 * css + static_cast<long long>(gi) * d.n;
  const T* bbase = bm + bb * bsb + t0 * bss + static_cast<long long>(gi) * d.n;
  const int h0 = gi * d.hg + hbi * d.hb;
  const long long blk = ((static_cast<long long>(bb) * d.nc + c) * d.g + gi) * d.nhb + hbi;
  float* dbi = dbp + (blk * d.nqt + i) * d.qp * d.n;  // dB's partial sums of pairs (i, j)

  stage_dt(dth, d.qp, dt + (static_cast<long long>(bb) * d.s + t0) * d.h + h0, d.h, d.q, d.hb);
  load_cols(ct, LD, cb + r0 * css, css, rv, d.n, TILE, d.np);
  load_rows(cn, ldn, cb + r0 * css, css, rv, d.n, TILE, d.np);
  __syncthreads();
  if (warp < d.hb)
    warp_cumsum(csall + warp * d.qp, dth + warp * d.qp, a[h0 + warp], d.q, threadIdx.x & 31);
  for (int t = threadIdx.x; t < MAX_HB * TILE; t += NT) rows_[t] = 0.0;
  __syncthreads();
  for (int e = threadIdx.x; i && e < d.hb * TILE; e += NT) {
    const int hh = e / TILE, t = e - hh * TILE;
    const double* cs = csall + hh * d.qp;
    vq[e] = t < rv ? dexp(cs[r0 + t] - cs[r0 - 1]) : 0.f;
  }
  for (int e = threadIdx.x; e < d.hb * r0; e += NT) {
    const int hh = e / r0, k = e - hh * r0;
    const double* cs = csall + hh * d.qp;
    vk[hh * d.qp + k] = dexp(cs[r0 - 1] - cs[k]);
  }

  float accc[2][4][4];
  zero(accc[0]);
  zero(accc[1]);

  // the inter-chunk term and the state path, per head
  const T* dyr = dy + bb * dysb + (t0 + r0) * dyss + static_cast<long long>(h0) * d.p;
  const T* xr = x + bb * xsb + (t0 + r0) * xss + static_cast<long long>(h0) * d.p;
  const bool small_n = d.n <= TILE;  // E, G fit one fetched tile (then ldn == LD)
  const float* eg = ent + (static_cast<long long>(bb) * d.nc + c) * d.h * d.p * d.n;
  const float* gg = gst + (static_cast<long long>(bb) * d.nc + c) * d.h * d.p * d.n;
  const long long pn = static_cast<long long>(d.p) * d.n;
  TileFetch<true, T> fdy, fxr;
  TileFetch<false, float> fe, fg;
  fdy.fetch(dyr, dyss, rv, d.p);
  fxr.fetch(xr, xss, rv, d.p);
  if (small_n) {
    fe.fetch(eg + h0 * pn, d.n, d.p, d.n);
    fg.fetch(gg + h0 * pn, d.n, d.p, d.n);
  }
  for (int hh = 0; hh < d.hb; ++hh) {
    const int hi = h0 + hh;
    const double* cs = csall + hh * d.qp;
    const float* dtc = dth + hh * d.qp;
    const long long sbase = ((static_cast<long long>(bb) * d.nc + c) * d.h + hi) * d.p * d.n;
    __syncthreads();
    for (int t = threadIdx.x; t < TILE; t += NT) {
      vdin[t] = t < rv ? dexp(cs[r0 + t]) : 0.f;
      vde[t] = t < rv ? dexp(cs[d.q - 1] - cs[r0 + t]) : 0.f;
    }
    fdy.put(x2, LD, dyr + hh * d.p, dyss, rv, d.p);
    if (hh + 1 < d.hb) fdy.fetch(dyr + (hh + 1) * d.p, dyss, rv, d.p);
    if (small_n) {
      fe.put(x1, ldn, ent + sbase, d.n, d.p, d.n);
      if (hh + 1 < d.hb) fe.fetch(ent + sbase + pn, d.n, d.p, d.n);
    } else {
      load_rows(x1, ldn, ent + sbase, d.n, d.p, d.n, TILE, d.np);
    }
    __syncthreads();
    double ddin[4] = {0.0, 0.0, 0.0, 0.0};
    #pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      if (nt >= d.ntn) break;
      float w[4][4];
      zero(w);
      mma(w, x2, LD, x1 + nt * TILE, ldn, d.p);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int qq = 4 * ty + u, nn = nt * TILE + 4 * tx + v;
          accc[nt][u][v] = fmaf(vdin[qq], w[u][v], accc[nt][u][v]);
          ddin[u] += static_cast<double>(cn[qq * ldn + nn] * w[u][v]);
        }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const double s = row_sum(ddin[u]);
      if (tx == 0) rows_[hh * TILE + 4 * ty + u] += vdin[4 * ty + u] * s;
    }
    __syncthreads();
    fxr.put(x2, LD, xr + hh * d.p, xss, rv, d.p, dtc + r0);
    if (hh + 1 < d.hb) fxr.fetch(xr + (hh + 1) * d.p, xss, rv, d.p);
    if (small_n) {
      fg.put(x1, ldn, gst + sbase, d.n, d.p, d.n);
      if (hh + 1 < d.hb) fg.fetch(gst + sbase + pn, d.n, d.p, d.n);
    } else {
      load_rows(x1, ldn, gst + sbase, d.n, d.p, d.n, TILE, d.np);
    }
    __syncthreads();
    #pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      if (nt >= d.ntn) break;
      float w[4][4];
      zero(w);
      mma(w, x2, LD, x1 + nt * TILE, ldn, d.p);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int k = 4 * ty + u, nn = nt * TILE + 4 * tx + v;
          if (k < rv && nn < d.n) {
            float* o = dbi + static_cast<long long>(r0 + k) * d.n + nn;
            const float val = vde[k] * w[u][v];
            *o = hh ? *o + val : val;
          }
        }
    }
  }

  // the quadratic term, key tile by key tile
  for (int j = 0; j <= i; ++j) {
    const int k0 = j * TILE, kvj = min(TILE, d.q - k0);
    const bool offd = j < i;
    __syncthreads();
    load_cols(x1, LD, bbase + k0 * bss, bss, kvj, d.n, TILE, d.np);
    __syncthreads();
    const T* dyi = dy + bb * dysb + (t0 + r0) * dyss + static_cast<long long>(h0) * d.p;
    const T* xk = x + bb * xsb + (t0 + k0) * xss + static_cast<long long>(h0) * d.p;
    TileFetch<true, T> fdq, fxk;
    fdq.fetch(dyi, dyss, rv, d.p);
    fxk.fetch(xk, xss, kvj, d.p);
    float s[4][4], dss[4][4];
    zero(s);
    zero(dss);
    mma(s, ct, LD, x1, LD, d.n);
    for (int hh = 0; hh < d.hb; ++hh) {
      const int hi = h0 + hh;
      const double* cs = csall + hh * d.qp;
      const float* lq = vq + hh * TILE;
      const float* lk = vk + hh * d.qp + k0;
      __syncthreads();
      fdq.put(x2, LD, dyi + hh * d.p, dyss, rv, d.p);
      fxk.put(x3, LD, xk + hh * d.p, xss, kvj, d.p, dth + hh * d.qp + k0);
      if (hh + 1 < d.hb) {
        fdq.fetch(dyi + (hh + 1) * d.p, dyss, rv, d.p);
        fxk.fetch(xk + (hh + 1) * d.p, xss, kvj, d.p);
      }
      __syncthreads();
      float m[4][4];
      zero(m);
      mma(m, x2, LD, x3, LD, d.p);
      double rp[4] = {0.0, 0.0, 0.0, 0.0}, cp[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int qq = 4 * ty + u, k = 4 * tx + v;
          float l;
          if (offd)
            l = lq[qq] * lk[k];
          else
            l = (qq >= k && qq < rv) ? dexp(cs[r0 + qq] - cs[r0 + k]) : 0.f;
          const float ds = m[u][v] * l;
          dss[u][v] += ds;
          const double tt = (offd || qq != k) ? static_cast<double>(ds * s[u][v]) : 0.0;
          rp[u] += tt;
          cp[v] += tt;
        }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const double r = row_sum(rp[u]);
        if (tx == 0) rows_[hh * TILE + 4 * ty + u] += r;
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        cp[v] += __shfl_xor_sync(0xffffffffu, cp[v], 16);  // the warp's two rows of threads
        if (!(threadIdx.x & 16)) colred[warp * TILE + 4 * tx + v] = cp[v];
      }
      __syncthreads();
      if (static_cast<int>(threadIdx.x) < kvj) {
        double sum = 0.0;
        for (int w = 0; w < NT / 32; ++w) sum += colred[w * TILE + threadIdx.x];
        colt[(((static_cast<long long>(bb) * d.nc + c) * d.h + hi) * d.nqt + i) * d.qp + k0 +
             threadIdx.x] = sum;
      }
    }
    __syncthreads();
    store_tile(x1, dss, true);   // dS^T [k][q]
    store_tile(x2, dss, false);  // dS [q][k]
    load_rows(x3, ldn, bbase + k0 * bss, bss, kvj, d.n, TILE, d.np);
    __syncthreads();
    #pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      if (nt >= d.ntn) break;
      float w[4][4];
      zero(w);
      mma(w, x1, LD, x3 + nt * TILE, ldn, kvj);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) accc[nt][u][v] += w[u][v];
    }
    #pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      if (nt >= d.ntn) break;
      float w[4][4];
      zero(w);
      mma(w, x2, LD, cn + nt * TILE, ldn, rv);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int k = 4 * ty + u, nn = nt * TILE + 4 * tx + v;
          if (k < kvj && nn < d.n) {
            float* o = dbi + static_cast<long long>(k0 + k) * d.n + nn;
            *o = offd ? w[u][v] : *o + w[u][v];
          }
        }
    }
  }

  float* dco = dcp + blk * d.qp * d.n;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    if (nt >= d.ntn) break;
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int qq = 4 * ty + u, nn = nt * TILE + 4 * tx + v;
        if (qq < rv && nn < d.n) dco[static_cast<long long>(r0 + qq) * d.n + nn] = accc[nt][u][v];
      }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < d.hb * TILE; e += NT) {
    const int hh = e / TILE, t = e - hh * TILE;
    if (t < rv) rowt[(static_cast<long long>(bb) * d.s + t0 + r0 + t) * d.h + h0 + hh] = rows_[e];
  }
}

// dcs (the gradient of the within-chunk cumulative sum) from its parts, its
// reverse cumulative sum dda (float64), ddt = dda a + dxdt, and dA's partial
// sum of dda dt: CTA (chunk, head, batch row), a thread a token.
__global__ void __launch_bounds__(NT, 1)
ssd_ddt_kernel(const float* dt, const float* a, const double* rowt, const double* stcs,
               const double* colt, const double* lastp, const double* dcdp, const double* dxdt,
               float* ddt, double* dap, Dims d) {
  SSD_SMEM(smem4);
  double* v = reinterpret_cast<double*>(smem4);  // qp + NT / 32 doubles
  double* red = v + d.qp;
  const int c = blockIdx.x, hi = blockIdx.y, bb = blockIdx.z, t = threadIdx.x;
  const long long t0 = static_cast<long long>(c) * d.q;
  const long long sb = (static_cast<long long>(bb) * d.nc + c) * d.h + hi;
  const long long si = (static_cast<long long>(bb) * d.s + t0 + t) * d.h + hi;
  if (t < d.q) {
    double s = rowt[si] + stcs[si];
    for (int i = t / TILE; i < d.nqt; ++i) s -= colt[(sb * d.nqt + i) * d.qp + t];
    if (t == d.q - 1) {
      for (int j = 0; j < d.nqt; ++j) s += lastp[sb * d.nqt + j];
      for (int nt = 0; nt < d.ntn; ++nt) s += dcdp[sb * d.ntn + nt];
    }
    v[t] = s;
  }
  __syncthreads();
  if (t < 32) warp_rev_cumsum(v, d.q, t);
  __syncthreads();
  double part = 0.0;
  if (t < d.q) {
    ddt[si] = static_cast<float>(v[t] * a[hi] + dxdt[si]);
    part = v[t] * dt[si];
  }
  const double sum = block_sum(part, red);
  if (t == 0) dap[sb] = sum;
}

// dB and dC from their partial sums (over head blocks, and for dB over the
// query tiles i >= the row's tile), in B's dtype; dA and dD (block 0).
template <typename T>
__global__ void __launch_bounds__(NT, 1)
ssd_reduce_kernel(const float* dcp, const float* dbp, const double* dap, const double* ddp, T* db,
                  T* dc, float* da, float* dd, Dims d) {
  const long long e = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  const long long total = static_cast<long long>(d.b) * d.s * d.g * d.n;
  if (e < total) {
    const int nn = static_cast<int>(e % d.n);
    long long r = e / d.n;
    const int gi = static_cast<int>(r % d.g);
    r /= d.g;
    const long long tok = r % d.s, bb = r / d.s;
    const int c = static_cast<int>(tok / d.q), row = static_cast<int>(tok % d.q);
    const long long blk0 = ((bb * d.nc + c) * d.g + gi) * d.nhb;
    float vc = 0.f, vb = 0.f;
    for (int hbi = 0; hbi < d.nhb; ++hbi) {
      const long long blk = blk0 + hbi;
      vc += dcp[(blk * d.qp + row) * d.n + nn];
      for (int i = row / TILE; i < d.nqt; ++i) vb += dbp[((blk * d.nqt + i) * d.qp + row) * d.n + nn];
    }
    st(dc + e, vc);
    st(db + e, vb);
  }
  for (int hi = threadIdx.x; blockIdx.x == 0 && hi < d.h; hi += NT) {
    double sa = 0.0, sd = 0.0;
    for (int bc = 0; bc < d.b * d.nc; ++bc) {
      const long long sb = static_cast<long long>(bc) * d.h + hi;
      sa += dap[sb];
      for (int j = 0; j < d.nqt; ++j) sd += ddp[sb * d.nqt + j];
    }
    da[hi] = static_cast<float>(sa);
    dd[hi] = static_cast<float>(sd);
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

namespace {

struct Work {  // the backward's workspace, in floats (dcdp ... dap hold doubles)
  long long gst, dcp, dbp, dcdp, rowt, stcs, dxdt, colt, lastp, ddp, dap, total;
  explicit Work(const Dims& d) {
    const long long bnh = static_cast<long long>(d.b) * d.nc * d.h;
    const long long bsh = static_cast<long long>(d.b) * d.s * d.h;
    const long long blocks = static_cast<long long>(d.b) * d.nc * d.g * d.nhb;
    long long o = 0;
    auto take = [&o](long long n) { const long long at = o; o += (n + 3) / 4 * 4; return at; };
    gst = take(bnh * d.p * d.n);
    dcp = take(blocks * d.qp * d.n);
    dbp = take(blocks * d.nqt * d.qp * d.n);
    dcdp = take(2 * bnh * d.ntn);
    rowt = take(2 * bsh);
    stcs = take(2 * bsh);
    dxdt = take(2 * bsh);
    colt = take(2 * bnh * d.nqt * d.qp);
    lastp = take(2 * bnh * d.nqt);
    ddp = take(2 * bnh * d.nqt);
    dap = take(2 * bnh);
    total = o;
  }
};

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

#define SSD_CHECK(expr)                  \
  do {                                   \
    const cudaError_t e_ = (expr);       \
    if (e_ != cudaSuccess) return e_;    \
  } while (0)

template <typename T>
int fwd(const T* x, long long xsb, long long xss, const float* dt, const float* a, const T* bm,
        long long bsb, long long bss, const T* cm, long long csb, long long css,
        const float* dskip, T* y, float* fin, float* ent, const Dims& d, cudaStream_t stream) {
  const size_t s1 = sizeof(float) * StateLayout(d).floats;
  const size_t s2 = sizeof(float) * FwdLayout(d).floats;
  SSD_CHECK(allow_smem(ssd_state_fwd_kernel<T>, s1));
  SSD_LAUNCH(ssd_state_fwd_kernel<T>, dim3(d.ntn, d.h, d.b), s1, stream)(
      x, xsb, xss, dt, a, bm, bsb, bss, ent, fin, d);
  SSD_CHECK(cudaGetLastError());
  SSD_CHECK(allow_smem(ssd_fwd_kernel<T>, s2));
  SSD_LAUNCH(ssd_fwd_kernel<T>, dim3(d.nqt * d.nhb * d.g, d.nc, d.b), s2, stream)(
      x, xsb, xss, dt, a, bm, bsb, bss, cm, csb, css, dskip, ent, y, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const T* x, long long xsb, long long xss, const float* dt, const float* a, const T* bm,
        long long bsb, long long bss, const T* cm, long long csb, long long css,
        const float* dskip, const T* dy, long long dysb, long long dyss, const float* dfin,
        const float* ent, T* dx, float* ddt, float* da, T* db, T* dc, float* dd, float* work,
        const Dims& d, cudaStream_t stream) {
  const Work w(d);
  float *gst = work + w.gst, *dcp = work + w.dcp, *dbp = work + w.dbp;
  auto dbl = [work](long long at) { return reinterpret_cast<double*>(work + at); };
  double *dcdp = dbl(w.dcdp), *rowt = dbl(w.rowt), *stcs = dbl(w.stcs), *dxdt = dbl(w.dxdt),
         *colt = dbl(w.colt), *lastp = dbl(w.lastp), *ddp = dbl(w.ddp), *dap = dbl(w.dap);
  const size_t s0 = sizeof(float) * StateLayout(d).floats;
  const size_t s1 = sizeof(float) * BwdLayout(d).floats;
  const size_t s2 = sizeof(float) * DbcLayout(d).floats;
  const size_t s3 = sizeof(double) * (d.qp + NT / 32);
  const dim3 tiles(d.nqt * d.nhb * d.g, d.nc, d.b);
  SSD_CHECK(allow_smem(ssd_state_bwd_kernel<T>, s0));
  SSD_LAUNCH(ssd_state_bwd_kernel<T>, dim3(d.ntn, d.h, d.b), s0, stream)(
      dy, dysb, dyss, dt, a, cm, csb, css, dfin, ent, gst, dcdp, d);
  SSD_CHECK(cudaGetLastError());
  SSD_CHECK(allow_smem(ssd_bwd_kernel<T>, s1));
  SSD_LAUNCH(ssd_bwd_kernel<T>, tiles, s1, stream)(
      x, xsb, xss, dt, a, bm, bsb, bss, cm, csb, css, dskip, dy, dysb, dyss, gst, dx, dxdt,
      stcs, lastp, ddp, d);
  SSD_CHECK(cudaGetLastError());
  SSD_CHECK(allow_smem(ssd_dbc_kernel<T>, s2));
  SSD_LAUNCH(ssd_dbc_kernel<T>, tiles, s2, stream)(
      x, xsb, xss, dt, a, bm, bsb, bss, cm, csb, css, dy, dysb, dyss, ent, gst, rowt, colt, dcp,
      dbp, d);
  SSD_CHECK(cudaGetLastError());
  SSD_LAUNCH(ssd_ddt_kernel, dim3(d.nc, d.h, d.b), s3, stream)(
      dt, a, rowt, stcs, colt, lastp, dcdp, dxdt, ddt, dap, d);
  SSD_CHECK(cudaGetLastError());
  const long long total = static_cast<long long>(d.b) * d.s * d.g * d.n;
  SSD_LAUNCH(ssd_reduce_kernel<T>, dim3(static_cast<unsigned>((total + NT - 1) / NT)), 0,
             stream)(dcp, dbp, dap, ddp, db, dc, da, dd, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

long long ssd_chunked_workspace(int b, int s, int h, int p, int g, int n, int q, int hb) {
  return Work(make_dims(b, s, h, p, g, n, q, hb)).total;
}

int ssd_chunked_fwd(int dtype, const void* x, long long xsb, long long xss, const float* dt,
                    const float* a, const void* bm, long long bsb, long long bss, const void* cm,
                    long long csb, long long css, const float* dskip, void* y, float* fin,
                    float* ent, int b, int s, int h, int p, int g, int n, int q, int hb,
                    void* stream) {
  const Dims d = make_dims(b, s, h, p, g, n, q, hb);
  const cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd(static_cast<const float*>(x), xsb, xss, dt, a, static_cast<const float*>(bm), bsb,
               bss, static_cast<const float*>(cm), csb, css, dskip, static_cast<float*>(y), fin,
               ent, d, st_);
  return fwd(static_cast<const __nv_bfloat16*>(x), xsb, xss, dt, a,
             static_cast<const __nv_bfloat16*>(bm), bsb, bss,
             static_cast<const __nv_bfloat16*>(cm), csb, css, dskip,
             static_cast<__nv_bfloat16*>(y), fin, ent, d, st_);
}

int ssd_chunked_bwd(int dtype, const void* x, long long xsb, long long xss, const float* dt,
                    const float* a, const void* bm, long long bsb, long long bss, const void* cm,
                    long long csb, long long css, const float* dskip, const void* dy,
                    long long dysb, long long dyss, const float* dfin, const float* ent,
                    void* dx, float* ddt, float* da, void* db, void* dc, float* dd, float* work,
                    int b, int s, int h, int p, int g, int n, int q, int hb, void* stream) {
  const Dims d = make_dims(b, s, h, p, g, n, q, hb);
  const cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd(static_cast<const float*>(x), xsb, xss, dt, a, static_cast<const float*>(bm), bsb,
               bss, static_cast<const float*>(cm), csb, css, dskip,
               static_cast<const float*>(dy), dysb, dyss, dfin, ent, static_cast<float*>(dx), ddt,
               da, static_cast<float*>(db), static_cast<float*>(dc), dd, work, d, st_);
  using B16 = __nv_bfloat16;
  return bwd(static_cast<const B16*>(x), xsb, xss, dt, a, static_cast<const B16*>(bm), bsb, bss,
             static_cast<const B16*>(cm), csb, css, dskip, static_cast<const B16*>(dy), dysb,
             dyss, dfin, ent, static_cast<B16*>(dx), ddt, da, static_cast<B16*>(db),
             static_cast<B16*>(dc), dd, work, d, st_);
}

#ifndef SSD_HOST_EMU
// {registers, CTAs an SM, dynamic shared memory bytes, threads, local bytes}
// of kernel ``which`` (the bfloat16 instantiations, in kernels/ssd.py's
// KERNELS order) at state size n and chunk q, 8 heads a CTA
int ssd_chunked_kernel_info(int which, int n, int q, int* out) {
  const Dims d = make_dims(1, q, 8, 64, 1, n, q, 8);
  using B16 = __nv_bfloat16;
  const void* fns[] = {
      reinterpret_cast<const void*>(ssd_state_fwd_kernel<B16>),
      reinterpret_cast<const void*>(ssd_fwd_kernel<B16>),
      reinterpret_cast<const void*>(ssd_state_bwd_kernel<B16>),
      reinterpret_cast<const void*>(ssd_bwd_kernel<B16>),
      reinterpret_cast<const void*>(ssd_dbc_kernel<B16>),
      reinterpret_cast<const void*>(ssd_ddt_kernel),
      reinterpret_cast<const void*>(ssd_reduce_kernel<B16>)};
  const size_t smem[] = {sizeof(float) * StateLayout(d).floats,
                         sizeof(float) * FwdLayout(d).floats,
                         sizeof(float) * StateLayout(d).floats,
                         sizeof(float) * BwdLayout(d).floats,
                         sizeof(float) * DbcLayout(d).floats,
                         sizeof(double) * (d.qp + NT / 32), 0};
  if (which < 0 || which >= 7) return static_cast<int>(cudaErrorInvalidValue);
  SSD_CHECK(cudaFuncSetAttribute(fns[which], cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem[which])));
  cudaFuncAttributes attr;
  SSD_CHECK(cudaFuncGetAttributes(&attr, fns[which]));
  int ctas = 0;
  SSD_CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fns[which], NT, smem[which]));
  out[0] = attr.numRegs;
  out[1] = ctas;
  out[2] = static_cast<int>(smem[which]);
  out[3] = NT;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
#endif

}  // extern "C"
