// Hopper (sm_90a) kernels for the reference's chunked (online-softmax)
// attention, forward and backward (A1).
//
// Replaces
//   chunked_attention <- repro/models/attention.py::chunked_attention
// a plain jnp function (no Pallas kernel) that streams (q-chunk, kv-chunk)
// pairs through an online softmax, so no (S, Sk) score matrix is ever held.
// Plain version: kernels/attention.py::chunked_attention_ref (the port's
// copy of the reference's loop, batched over q-chunks).
//
// What it computes, per (batch row, head, query row), with the reference's
// dtype steps: for each kv-chunk j of ck keys, in ascending order,
//   s      = f32(T(q . k)) * scale            (the product rounded to T, as
//                                             the reference's T einsum is)
//   s      = -1e30 where key > query          (causal, by global position)
//   m_new  = max(m, max_chunk s)
//   p      = exp(s - m_new)                    (float32)
//   l      = l * exp(m - m_new) + sum_chunk p
//   o      = o * exp(m - m_new) + f32(T(sum_chunk T(p) v))
// then out = T(o / max(l, 1e-30)). The chunk's p.v is rounded to T once,
// so the rounding points and the chunk order are the reference's. A chunk
// of 64 keys or fewer is one tile, and its p is the reference's; a wider
// chunk is walked one 64-key tile at a time with the online update inside
// it (the chunk's running max, its sum and p.v rescaled when the max
// grows), so its p is rounded to T relative to the running max rather than
// the chunk's. Beyond that only the order of the float32 additions inside
// a dot product or a chunk's sum differs. Rows of a 64-row tile that lie in
// earlier q-chunks than the tile's last see later kv-chunks fully masked:
// such a chunk leaves m, l and o exactly as they were (exp(-1e30 - m) = 0),
// so visiting it is the reference's pair list.
//
// Heads: k and v carry every query head (the models repeat grouped K/V
// before attending, as the reference does); kernels/ops.py repeats a
// grouped call's K/V before the launch.
//
// Backward (a torch.autograd.Function around these): the softmax weights
// are recomputed tile by tile from the saved per-row m and l,
// P = exp(s - m) / l, as flash_remat recomputes the pair step; nothing of
// size (S, Sk) is saved. dQ kernel: one CTA per (b, h, 64 query rows),
// D = rowsum(dO * O) first (written for the dK/dV kernel), then over the
// key tiles dP = dO V^T, dS = P (dP - D), dQ += dS K. dK/dV kernel: one CTA
// per (b, h, 64 keys), over the query tiles at or below the diagonal:
// dV += P^T dO, dK += dS^T Q. No atomics: every output element has one
// owner, so the result repeats its bits.
//
// What bounds it: operations. Forward 4 S Sk hd flops per (b, h) (halved
// when causal) against 2 (S + 2 Sk) hd elements moved; at qwen's hd = 64
// and S = 4,096 that is about 1,000 flops per byte, far above the card's
// ridge. This first version runs the products as float32 FMAs on the CUDA
// cores (67 TFLOP/s peak) over float32 tiles in shared memory; the bound
// chip_smoke.py states is the bf16 tensor-core rate (989 TFLOP/s dense), so
// the distance to it is what wgmma/TMA and larger tiles would win.
//
// Design: 256 threads as 16 x 16, each owning a 4 x 4 block of a 64 x 64
// score tile and a 4 x (4 NG) block of a 64 x hd output (hd <= 64 NG,
// NG = 1 or 2, columns beyond hd zero). Operands of a product over k are
// stored k-major in shared memory ([k][m] and [k][n]), so one float4 load
// of each feeds 16 FMAs; transposed tiles have a row pitch of 68 floats
// (16-byte aligned, stores 4-way instead of 32-way bank conflicted).
// Row reductions (max, sum) run over the 16 lanes of a half-warp with
// xor shuffles, which leave every lane the same value.
//
// Binding: plain C entry points loaded with ctypes; launch on the given
// stream, allocate nothing, return cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // query rows and keys of one tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPitch = 68;     // row pitch of a k-major (transposed) tile
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// A value rounded to the compute dtype T and read back as float32: what the
// plain version's products in T do to their float32-accumulated results.
template <typename T> __device__ __forceinline__ float round_t(float x) {
  return to_f<T>(from_f<T>(x));
}

// dst[d * kPitch + r] = src[r * stride + d] (k-major: d is the product's k)
// for r < kTile, d < HDP; zero where r >= nrows or d >= hd.
template <typename T, int HDP>
__device__ void load_kmajor(float* dst, const T* __restrict__ src, int64_t stride, int nrows,
                            int hd) {
  for (int e = threadIdx.x; e < kTile * HDP; e += kThreads) {
    const int r = e / HDP, d = e % HDP;
    dst[d * kPitch + r] = (r < nrows && d < hd) ? to_f<T>(src[r * stride + d]) : 0.f;
  }
}

// dst[r * HDP + d] = src[r * stride + d] (row-major: r is the product's k).
template <typename T, int HDP>
__device__ void load_rows(float* dst, const T* __restrict__ src, int64_t stride, int nrows,
                          int hd) {
  for (int e = threadIdx.x; e < kTile * HDP; e += kThreads) {
    const int r = e / HDP, d = e % HDP;
    dst[e] = (r < nrows && d < hd) ? to_f<T>(src[r * stride + d]) : 0.f;
  }
}

// acc[i][g * 4 + j] += sum_{kk < kdim} A[kk][m0 + i] * B[kk][g * 64 + n0 + j]
template <int NG>
__device__ __forceinline__ void mma_tile(float (&acc)[4][4 * NG], const float* A, int lda,
                                         const float* B, int ldb, int kdim, int m0, int n0) {
#pragma unroll 4
  for (int kk = 0; kk < kdim; ++kk) {
    const float4 a = *reinterpret_cast<const float4*>(A + kk * lda + m0);
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float4 b = *reinterpret_cast<const float4*>(B + kk * ldb + g * 64 + n0);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][g * 4 + j] = fmaf(av[i], bv[j], acc[i][g * 4 + j]);
    }
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// A 4 x 4 block of a 64 x 64 score tile: s = T(dot) * scale, the causal
// mask at -1e30 by global position (col > row masked), -inf where the
// column or the row lies outside the tile's valid range.
template <typename T>
__device__ __forceinline__ void finish_scores(float (&s)[4][4], float scale, int row0, int col0,
                                             int nrows, int ncols, bool causal, int m0,
                                             int n0) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x = round_t<T>(s[i][j]) * scale;
      if (causal && col0 + n0 + j > row0 + m0 + i) x = kNegInf;
      if (n0 + j >= ncols || m0 + i >= nrows) x = -INFINITY;
      s[i][j] = x;
    }
}

template <int HDP>
constexpr int fwd_smem_floats() { return 2 * HDP * kPitch + kTile * HDP + kTile * kPitch; }
template <int HDP>
constexpr int dq_smem_floats() {
  return 4 * HDP * kPitch + kTile * HDP + kTile * kPitch + kTile;
}
template <int HDP>
constexpr int dkv_smem_floats() {
  return 4 * HDP * kPitch + 2 * kTile * HDP + kTile * kPitch + 3 * kTile;
}

// Forward. grid (ceil(S / 64), H, B). q, out (B, S, H, hd); k, v (B, Sk, H, hd);
// m, l (B, H, S) float32, the final running max and sum of each row.
template <typename T, int NG>
__global__ void __launch_bounds__(kThreads)
attn_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         T* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out, int S,
         int Sk, int H, int hd, int ck, int causal, float scale) {
  constexpr int HDP = 64 * NG;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [HDP][kPitch]
  float* Kt = Qt + HDP * kPitch;                  // [HDP][kPitch]
  float* Vs = Kt + HDP * kPitch;                  // [kTile][HDP]
  float* Pt = Vs + kTile * HDP;                   // [kTile][kPitch], p as [key][row]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = ty * 4, n0 = tx * 4;
  const int nrows = min(kTile, S - q0);
  const int64_t stride = (int64_t)H * hd;
  const T* kb = k + ((int64_t)b * Sk * H + h) * hd;
  const T* vb = v + ((int64_t)b * Sk * H + h) * hd;

  load_kmajor<T, HDP>(Qt, q + (((int64_t)b * S + q0) * H + h) * hd, stride, nrows, hd);

  float o[4][4 * NG], pv[4][4 * NG], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) o[i][c] = 0.f;
  }
  const int last_row = q0 + nrows - 1;
  const int nk = causal ? last_row / ck + 1 : Sk / ck;
  for (int j = 0; j < nk; ++j) {
    const int c0 = j * ck;
    // keys past the tile's last row are masked for every row of it
    const int c_end = causal ? min(c0 + ck, last_row + 1) : c0 + ck;
    // the chunk's running max, and its sum and p.v relative to it
    float m_run[4], lsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m_run[i] = m[i];
#pragma unroll
      for (int c = 0; c < 4 * NG; ++c) pv[i][c] = 0.f;
    }
    for (int t0 = c0; t0 < c_end; t0 += kTile) {
      const int ncols = min(kTile, c_end - t0);
      __syncthreads();
      load_kmajor<T, HDP>(Kt, kb + (int64_t)t0 * stride, stride, ncols, hd);
      load_rows<T, HDP>(Vs, vb + (int64_t)t0 * stride, stride, ncols, hd);
      __syncthreads();
      float s[4][4] = {};
      mma_tile<1>(s, Qt, kPitch, Kt, kPitch, hd, m0, n0);
      finish_scores<T>(s, scale, q0, t0, kTile, ncols, causal, m0, n0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
        const float m_t = fmaxf(m_run[i], half_warp_max(x));
        const float alpha = expf(m_run[i] - m_t);
        lsum[i] *= alpha;
#pragma unroll
        for (int c = 0; c < 4 * NG; ++c) pv[i][c] *= alpha;
        m_run[i] = m_t;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float p4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = expf(s[i][jj] - m_run[i]);
          lsum[i] += p;
          p4[i] = round_t<T>(p);
        }
        *reinterpret_cast<float4*>(Pt + (n0 + jj) * kPitch + m0) =
            make_float4(p4[0], p4[1], p4[2], p4[3]);
      }
      __syncthreads();
      mma_tile<NG>(pv, Pt, kPitch, Vs, HDP, ncols, m0, n0);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = expf(m[i] - m_run[i]);
      l[i] = l[i] * corr + half_warp_sum(lsum[i]);
#pragma unroll
      for (int c = 0; c < 4 * NG; ++c) o[i][c] = o[i][c] * corr + round_t<T>(pv[i][c]);
      m[i] = m_run[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + m0 + i;
    if (m0 + i >= nrows) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = out + (((int64_t)b * S + r) * H + h) * hd;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int d = g * 64 + n0 + jj;
        if (d < hd) orow[d] = from_f<T>(o[i][g * 4 + jj] / den);
      }
    if (tx == 0) {
      const int64_t idx = ((int64_t)b * H + h) * S + r;
      m_out[idx] = m[i];
      l_out[idx] = l[i];
    }
  }
}

// Backward, dQ. grid (ceil(S / 64), H, B). Also writes D = rowsum(dO * O)
// (B, H, S) float32 for the dK/dV kernel.
template <typename T, int NG>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ out, const T* __restrict__ dout,
            const float* __restrict__ m_in, const float* __restrict__ l_in,
            T* __restrict__ dq, float* __restrict__ d_out, int S, int Sk, int H, int hd,
            int causal, float scale) {
  constexpr int HDP = 64 * NG;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [HDP][kPitch]
  float* dOt = Qt + HDP * kPitch;                 // [HDP][kPitch]
  float* Kt = dOt + HDP * kPitch;                 // [HDP][kPitch]
  float* Vt = Kt + HDP * kPitch;                  // [HDP][kPitch]
  float* Ks = Vt + HDP * kPitch;                  // [kTile][HDP]
  float* dSt = Ks + kTile * HDP;                  // [kTile][kPitch], dS as [key][row]
  float* Ds = dSt + kTile * kPitch;               // [kTile]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = ty * 4, n0 = tx * 4;
  const int nrows = min(kTile, S - q0);
  const int64_t stride = (int64_t)H * hd;
  const int64_t qoff = (((int64_t)b * S + q0) * H + h) * hd;
  const T* kb = k + ((int64_t)b * Sk * H + h) * hd;
  const T* vb = v + ((int64_t)b * Sk * H + h) * hd;
  const int64_t stat0 = ((int64_t)b * H + h) * S + q0;

  load_kmajor<T, HDP>(Qt, q + qoff, stride, nrows, hd);
  load_kmajor<T, HDP>(dOt, dout + qoff, stride, nrows, hd);
  {  // D: four threads per row
    const int r = threadIdx.x / 4, part = threadIdx.x % 4;
    float acc = 0.f;
    if (r < nrows)
      for (int d = part; d < hd; d += 4)
        acc += to_f<T>(dout[qoff + r * stride + d]) * to_f<T>(out[qoff + r * stride + d]);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      Ds[r] = acc;
      if (r < nrows) d_out[stat0 + r] = acc;
    }
  }
  __syncthreads();
  float mrow[4], inv_l[4], drow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool ok = m0 + i < nrows;
    mrow[i] = ok ? m_in[stat0 + m0 + i] : 0.f;
    inv_l[i] = ok ? 1.f / fmaxf(l_in[stat0 + m0 + i], 1e-30f) : 0.f;
    drow[i] = Ds[m0 + i];
  }
  float acc[4][4 * NG] = {};
  const int kend = causal ? min(Sk, q0 + nrows) : Sk;
  for (int t0 = 0; t0 < kend; t0 += kTile) {
    const int ncols = min(kTile, kend - t0);
    __syncthreads();
    load_kmajor<T, HDP>(Kt, kb + (int64_t)t0 * stride, stride, ncols, hd);
    load_kmajor<T, HDP>(Vt, vb + (int64_t)t0 * stride, stride, ncols, hd);
    load_rows<T, HDP>(Ks, kb + (int64_t)t0 * stride, stride, ncols, hd);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    mma_tile<1>(s, Qt, kPitch, Kt, kPitch, hd, m0, n0);
    mma_tile<1>(dp, dOt, kPitch, Vt, kPitch, hd, m0, n0);
    finish_scores<T>(s, scale, q0, t0, nrows, ncols, causal, m0, n0);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float d4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[i][jj] - mrow[i]) * inv_l[i];
        d4[i] = p * (dp[i][jj] - drow[i]);
      }
      *reinterpret_cast<float4*>(dSt + (n0 + jj) * kPitch + m0) =
          make_float4(d4[0], d4[1], d4[2], d4[3]);
    }
    __syncthreads();
    mma_tile<NG>(acc, dSt, kPitch, Ks, HDP, ncols, m0, n0);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (m0 + i >= nrows) continue;
    T* row = dq + qoff + (m0 + i) * stride;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int d = g * 64 + n0 + jj;
        if (d < hd) row[d] = from_f<T>(acc[i][g * 4 + jj] * scale);
      }
  }
}

// Backward, dK and dV. grid (ceil(Sk / 64), H, B).
template <typename T, int NG>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const float* __restrict__ m_in,
             const float* __restrict__ l_in, const float* __restrict__ d_in,
             T* __restrict__ dk, T* __restrict__ dv, int S, int Sk, int H, int hd, int causal,
             float scale) {
  constexpr int HDP = 64 * NG;
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);  // [HDP][kPitch], this CTA's keys
  float* Vt = Kt + HDP * kPitch;                  // [HDP][kPitch]
  float* Qt = Vt + HDP * kPitch;                  // [HDP][kPitch]
  float* dOt = Qt + HDP * kPitch;                 // [HDP][kPitch]
  float* Qs = dOt + HDP * kPitch;                 // [kTile][HDP]
  float* dOs = Qs + kTile * HDP;                  // [kTile][HDP]
  float* Buf = dOs + kTile * HDP;                 // [kTile][kPitch], P then dS as [row][key]
  float* ms = Buf + kTile * kPitch;               // [kTile] each
  float* ils = ms + kTile;
  float* Ds = ils + kTile;

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = ty * 4, n0 = tx * 4;  // m: keys, n: query rows (scores), head dims (dK, dV)
  const int ncols = min(kTile, Sk - k0);
  const int64_t stride = (int64_t)H * hd;
  const int64_t koff = (((int64_t)b * Sk + k0) * H + h) * hd;
  const int64_t stat = ((int64_t)b * H + h) * S;

  load_kmajor<T, HDP>(Kt, k + koff, stride, ncols, hd);
  load_kmajor<T, HDP>(Vt, v + koff, stride, ncols, hd);
  float dk_acc[4][4 * NG] = {}, dv_acc[4][4 * NG] = {};
  const int qstart = causal ? (k0 / kTile) * kTile : 0;
  for (int r0 = qstart; r0 < S; r0 += kTile) {
    const int nrows = min(kTile, S - r0);
    const int64_t qoff = (((int64_t)b * S + r0) * H + h) * hd;
    __syncthreads();
    load_kmajor<T, HDP>(Qt, q + qoff, stride, nrows, hd);
    load_kmajor<T, HDP>(dOt, dout + qoff, stride, nrows, hd);
    load_rows<T, HDP>(Qs, q + qoff, stride, nrows, hd);
    load_rows<T, HDP>(dOs, dout + qoff, stride, nrows, hd);
    if (threadIdx.x < kTile) {
      const int r = threadIdx.x;
      const bool ok = r < nrows;
      ms[r] = ok ? m_in[stat + r0 + r] : 0.f;
      ils[r] = ok ? 1.f / fmaxf(l_in[stat + r0 + r], 1e-30f) : 0.f;
      Ds[r] = ok ? d_in[stat + r0 + r] : 0.f;
    }
    __syncthreads();
    float st[4][4] = {}, dpt[4][4] = {};  // [key][row]
    mma_tile<1>(st, Kt, kPitch, Qt, kPitch, hd, m0, n0);
    mma_tile<1>(dpt, Vt, kPitch, dOt, kPitch, hd, m0, n0);
    float pt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int key = k0 + m0 + i, row = r0 + n0 + jj;
        float x = round_t<T>(st[i][jj]) * scale;
        if (causal && key > row) x = kNegInf;
        const bool valid = m0 + i < ncols && n0 + jj < nrows;
        const float p = valid ? expf(x - ms[n0 + jj]) * ils[n0 + jj] : 0.f;
        pt[i][jj] = p;
        st[i][jj] = p * (dpt[i][jj] - Ds[n0 + jj]);  // dS^T
      }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      *reinterpret_cast<float4*>(Buf + (n0 + jj) * kPitch + m0) =
          make_float4(pt[0][jj], pt[1][jj], pt[2][jj], pt[3][jj]);
    __syncthreads();
    mma_tile<NG>(dv_acc, Buf, kPitch, dOs, HDP, nrows, m0, n0);
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      *reinterpret_cast<float4*>(Buf + (n0 + jj) * kPitch + m0) =
          make_float4(st[0][jj], st[1][jj], st[2][jj], st[3][jj]);
    __syncthreads();
    mma_tile<NG>(dk_acc, Buf, kPitch, Qs, HDP, nrows, m0, n0);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (m0 + i >= ncols) continue;
    const int64_t off = koff + (m0 + i) * stride;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int d = g * 64 + n0 + jj;
        if (d < hd) {
          dk[off + d] = from_f<T>(dk_acc[i][g * 4 + jj] * scale);
          dv[off + d] = from_f<T>(dv_acc[i][g * 4 + jj]);
        }
      }
  }
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int NG>
int launch_fwd(const void* q, const void* k, const void* v, void* out, void* m, void* l, int B,
               int S, int Sk, int H, int hd, int ck, int causal, float scale, cudaStream_t st) {
  const int bytes = fwd_smem_floats<64 * NG>() * 4;
  if (int err = set_smem(attn_fwd<T, NG>, bytes)) return err;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  attn_fwd<T, NG><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(m), static_cast<float*>(l), S, Sk, H, hd, ck,
      causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int NG>
int launch_bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const void* m, const void* l, void* dq, void* dk, void* dv, void* dbuf, int B,
               int S, int Sk, int H, int hd, int causal, float scale, cudaStream_t st) {
  const int dq_bytes = dq_smem_floats<64 * NG>() * 4;
  const int dkv_bytes = dkv_smem_floats<64 * NG>() * 4;
  if (int err = set_smem(attn_bwd_dq<T, NG>, dq_bytes)) return err;
  if (int err = set_smem(attn_bwd_dkv<T, NG>, dkv_bytes)) return err;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float* mp = static_cast<const float*>(m);
  const float* lp = static_cast<const float*>(l);
  float* dbp = static_cast<float*>(dbuf);
  attn_bwd_dq<T, NG><<<dim3((S + kTile - 1) / kTile, H, B), kThreads, dq_bytes, st>>>(
      qp, kp, vp, static_cast<const T*>(out), dop, mp, lp, static_cast<T*>(dq), dbp, S, Sk, H,
      hd, causal, scale);
  if (int err = (int)cudaGetLastError()) return err;
  attn_bwd_dkv<T, NG><<<dim3((Sk + kTile - 1) / kTile, H, B), kThreads, dkv_bytes, st>>>(
      qp, kp, vp, dop, mp, lp, dbp, static_cast<T*>(dk), static_cast<T*>(dv), S, Sk, H, hd,
      causal, scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int S, int Sk, int H, int hd, int causal) {
  return B <= 0 || S <= 0 || Sk <= 0 || H <= 0 || hd <= 0 || hd > 128 || (causal && S != Sk);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (kernels/attention.py DTYPE_CODES).
// q, out (B, S, H, hd); k, v (B, Sk, H, hd), contiguous; m, l (B, H, S) float32.
extern "C" int chunked_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                     void* out, void* m, void* l, int B, int S, int Sk, int H,
                                     int hd, int ck, int causal, float scale, void* stream) {
  if (bad_shape(B, S, Sk, H, hd, causal) || ck <= 0 || Sk % ck != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = hd > 64;
  switch (dtype) {
    case 0:
      return wide ? launch_fwd<float, 2>(q, k, v, out, m, l, B, S, Sk, H, hd, ck, causal,
                                         scale, st)
                  : launch_fwd<float, 1>(q, k, v, out, m, l, B, S, Sk, H, hd, ck, causal,
                                         scale, st);
    case 1:
      return wide ? launch_fwd<__nv_bfloat16, 2>(q, k, v, out, m, l, B, S, Sk, H, hd, ck,
                                                 causal, scale, st)
                  : launch_fwd<__nv_bfloat16, 1>(q, k, v, out, m, l, B, S, Sk, H, hd, ck,
                                                 causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dq like q, dk and dv like k; dbuf (B, H, S) float32 scratch (D).
extern "C" int chunked_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                     const void* out, const void* dout, const void* m,
                                     const void* l, void* dq, void* dk, void* dv, void* dbuf,
                                     int B, int S, int Sk, int H, int hd, int causal,
                                     float scale, void* stream) {
  if (bad_shape(B, S, Sk, H, hd, causal)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = hd > 64;
  switch (dtype) {
    case 0:
      return wide ? launch_bwd<float, 2>(q, k, v, out, dout, m, l, dq, dk, dv, dbuf, B, S, Sk,
                                         H, hd, causal, scale, st)
                  : launch_bwd<float, 1>(q, k, v, out, dout, m, l, dq, dk, dv, dbuf, B, S, Sk,
                                         H, hd, causal, scale, st);
    case 1:
      return wide ? launch_bwd<__nv_bfloat16, 2>(q, k, v, out, dout, m, l, dq, dk, dv, dbuf, B,
                                                 S, Sk, H, hd, causal, scale, st)
                  : launch_bwd<__nv_bfloat16, 1>(q, k, v, out, dout, m, l, dq, dk, dv, dbuf, B,
                                                 S, Sk, H, hd, causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
