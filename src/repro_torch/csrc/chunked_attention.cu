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
// a dot product or a chunk's sum differs. Key tiles start at each chunk's
// first key; a chunk narrower than 64 keys masks the rest of its tile
// (-inf). Rows of a query tile that lie in earlier q-chunks than the tile's
// last see later kv-chunks fully masked: such a chunk leaves m, l and o
// exactly as they were (exp(-1e30 - m) = 0, and a max that does not grow
// rescales by exactly 1), so visiting it is the reference's pair list, and
// a row's result depends only on its own q row, the K/V and (causal, ck):
// not on the batch, nor on which rows share its tile.
//
// Heads: k and v carry every query head (the models repeat grouped K/V
// before attending, as the reference does); kernels/ops.py repeats a
// grouped call's K/V before the launch.
//
// Backward (a torch.autograd.Function around these): the softmax weights
// are recomputed tile by tile from the saved per-row m and l,
// P = exp(s - m) / l, as flash_remat recomputes the pair step; nothing of
// size (S, Sk) is saved. dQ kernel: D = rowsum(dO * O) first (written for
// the dK/dV kernel), then over the key tiles dP = dO V^T, dS = P (dP - D),
// dQ += dS K. dK/dV kernel: over the query tiles at or below the diagonal,
// dV += P^T dO, dK += dS^T Q. No atomics on any output: every output element
// has one owner, so the result repeats its bits.
//
// Two routes, chosen by dtype in the entry points (not a fallback: each
// dtype has exactly one, and a failure of either is returned):
//
// bfloat16, the tensor-core kernels (attn_*_tc). Every product is a wgmma
// (m64n64k16, bf16 in, float32 accumulators in registers); every operand
// tile arrives by TMA, 64 rows x 64 head dims of one head a box, 128-byte
// swizzled (a 4-d tensor map (hd, H, L, B), so TMA fills zeros past hd and
// past L and never reads the next head). Head dims are padded to 64 or 128
// in shared memory (NP = 1 or 2 panels), so hd 64, 80, 112 and 128 (and
// any multiple of 8 up to 128) take one of two instantiations.
//   Forward: one CTA per (b, h, 128 query rows), the longest causal tiles
//   first. Warpgroups 0 and 1 consume 64 rows each; warp 8 produces (its
//   warpgroup gives its registers up, setmaxnreg 24, the consumers take
//   240). The Q tile arrives once; K and V tiles of 64 keys stream through
//   a ring of 2 stages, each with a full/empty mbarrier pair, in the
//   chunks' order. S = Q K^T is a wgmma chain with both operands in shared
//   memory; the bf16 round, the scale, the masks and the online update run
//   on the accumulator fragment; p, rounded to bf16 in registers, is the A
//   operand of p.v, with V an MN-major B operand (the transpose bit), so
//   no transpose is stored.
//   Backward, both kernels: 256 threads, two consumer warpgroups and no
//   producer warp (384 threads would cap every thread at 168 registers,
//   and ptxas allots registers to warps in fours). Thread 0 loads the first
//   tiles of a 4-stage ring by TMA; a stage is refilled by whichever
//   warpgroup frees it second (a count in shared memory: it decides who
//   loads, never what is summed), so neither warpgroup waits for the other.
//   Each warpgroup issues a tile's two score products as two committed
//   groups and waits only for the one it needs (wgmma.wait_group 1), and
//   frees the previous tile's stage once its last product has retired.
//   The causal compare runs only on the diagonal tile (and dQ's ragged
//   last key tile); every other tile skips the per-element masks. Softmax
//   weights are exp2 of log2(e)-scaled operands (m log2(e) per row).
//   dQ: one CTA per (b, h, 128 query rows), the longest causal rows first,
//   64 rows a warpgroup, two CTAs an SM at NP = 1; Q and dO once, K/V
//   64-key tiles through the ring. S = Q K^T and dP = dO V^T from shared
//   memory; P is computed while dP is in flight; dS, rounded to bf16 in
//   registers, is the A operand of dQ += dS K (K MN-major), left in flight
//   while the next tile's S and dP are issued.
//   dK/dV: one CTA per (b, h, 128 keys), the longest causal key ranges
//   first, 64 keys a warpgroup with K and V resident; each streamed query
//   tile (q, dO and the rows' m log2(e), 1/l, D, all by TMA) feeds both
//   warpgroups, which halves the q and dO traffic a key against one
//   warpgroup a CTA.
//   S^T = K Q^T and dP^T = V dO^T from shared memory; P^T is computed while
//   dP^T is in flight, dS^T while dV += P^T dO is; P^T and dS^T rounded to
//   bf16 in registers are the A operands of dV and dK += dS^T Q (dO and Q
//   MN-major). Rows past S and keys past Sk need no mask there: their q
//   and dO are TMA's zeros and 1/l is 0, and no key row past Sk is stored.
//   The backward's bf16 rounding points: the scores (as the forward), and
//   P and dS where each is an operand of a product, as the plain loop's
//   autograd rounds them at its bf16 products; dP, D and the softmax's
//   arithmetic stay float32; dQ, dK, dV are rounded once at the end.
//   Head dims past 128 (up to 256; Zamba2's 224) take the wide kernels
//   (attn_*_tc_wide, below): four panels, and both warpgroups of a CTA on
//   the same 64 rows or keys, each owning half of the output's head dims.
//
// The scale of the scores is an argument (the models pass 1/sqrt(hd), the
// reference's; Zamba2's shared blocks (hd/2)^-0.5).
//
// float32, the CUDA-core kernels (attn_fwd, attn_bwd_dq, attn_bwd_dkv):
// the tensor cores' float32 path is TF32, whose 10-bit mantissa would
// break the float32 tolerance the checks hold A1 to (1e-5 of the output),
// and the float32 callers are those checks, not hot paths. Every round to
// T above is the identity there, so these are plain float32 code. 256
// threads as 16 x 16, each owning a 4 x 4 block of a 64 x 64 score tile and
// a 4 x (4 NG) block of a 64 x hd output (hd <= 64 NG, NG = 1 or 2, columns
// beyond hd zero). Operands of a product over k are stored k-major in
// shared memory ([k][m] and [k][n]), so one float4 load of each feeds 16
// FMAs; transposed tiles have a row pitch of 68 floats (16-byte aligned,
// stores 4-way instead of 32-way bank conflicted). Row reductions (max,
// sum) run over the 16 lanes of a half-warp with xor shuffles. Past 128
// head dims (NG = 4): the forward is attn_fwd<4>, the backward
// attn_bwd_*_wide, which load the score products' operands 64 dims at a time.
//
// What bounds it: operations. Forward 4 S Sk hd flops per (b, h) (halved
// when causal) against 2 (S + 2 Sk) hd elements moved; at qwen's hd = 64
// and S = 4,096 that is about 1,000 flops per byte, far above the card's
// ridge, so the bound is the bf16 tensor-core rate, 989 TFLOP/s dense. The
// backward's bound counts 10 hd flops a kept pair (5 hd-products: S, dP,
// dV, dQ, dK); the two backward kernels compute 7 (S and dP in each), so
// their best case is about 71 % of that bound. The forward issues each
// warpgroup's products and its softmax in turn (the other consumer
// warpgroup fills the gaps); the backward overlaps them as above. The
// float32 kernels run on the CUDA cores (67 TFLOP/s peak).
//
// Binding: plain C entry points loaded with ctypes; launch on the given
// stream, allocate nothing, return cudaGetLastError(). The TMA descriptors
// are encoded on the host for each call (cuTensorMapEncodeTiled, fetched
// with cudaGetDriverEntryPoint: no link against libcuda) and passed as
// __grid_constant__ kernel parameters.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <initializer_list>

namespace {

constexpr int kTile = 64;      // query rows and keys of one tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPitch = 68;     // row pitch of a k-major (transposed) tile
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

// dst[d * kPitch + r] = src[r * stride + d] (k-major: d is the product's k)
// for r < kTile, d < HDP; zero where r >= nrows or d >= hd.
template <int HDP>
__device__ void load_kmajor(float* dst, const float* __restrict__ src, int64_t stride, int nrows,
                            int hd) {
  for (int e = threadIdx.x; e < kTile * HDP; e += kThreads) {
    const int r = e / HDP, d = e % HDP;
    dst[d * kPitch + r] = (r < nrows && d < hd) ? src[r * stride + d] : 0.f;
  }
}

// dst[r * HDP + d] = src[r * stride + d] (row-major: r is the product's k).
template <int HDP>
__device__ void load_rows(float* dst, const float* __restrict__ src, int64_t stride, int nrows,
                          int hd) {
  for (int e = threadIdx.x; e < kTile * HDP; e += kThreads) {
    const int r = e / HDP, d = e % HDP;
    dst[e] = (r < nrows && d < hd) ? src[r * stride + d] : 0.f;
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

// A 4 x 4 block of a 64 x 64 score tile: s = dot * scale, the causal
// mask at -1e30 by global position (col > row masked), -inf where the
// column or the row lies outside the tile's valid range.
__device__ __forceinline__ void finish_scores(float (&s)[4][4], float scale, int row0, int col0,
                                             int nrows, int ncols, bool causal, int m0,
                                             int n0) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x = s[i][j] * scale;
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
template <int NG>
__global__ void __launch_bounds__(kThreads)
attn_fwd(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
         float* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out, int S,
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
  const float* kb = k + ((int64_t)b * Sk * H + h) * hd;
  const float* vb = v + ((int64_t)b * Sk * H + h) * hd;

  load_kmajor<HDP>(Qt, q + (((int64_t)b * S + q0) * H + h) * hd, stride, nrows, hd);

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
      load_kmajor<HDP>(Kt, kb + (int64_t)t0 * stride, stride, ncols, hd);
      load_rows<HDP>(Vs, vb + (int64_t)t0 * stride, stride, ncols, hd);
      __syncthreads();
      float s[4][4] = {};
      mma_tile<1>(s, Qt, kPitch, Kt, kPitch, hd, m0, n0);
      finish_scores(s, scale, q0, t0, kTile, ncols, causal, m0, n0);
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
          p4[i] = p;
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
      for (int c = 0; c < 4 * NG; ++c) o[i][c] = o[i][c] * corr + pv[i][c];
      m[i] = m_run[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + m0 + i;
    if (m0 + i >= nrows) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = out + (((int64_t)b * S + r) * H + h) * hd;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int d = g * 64 + n0 + jj;
        if (d < hd) orow[d] = o[i][g * 4 + jj] / den;
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
template <int NG>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
            const float* __restrict__ out, const float* __restrict__ dout,
            const float* __restrict__ m_in, const float* __restrict__ l_in,
            float* __restrict__ dq, float* __restrict__ d_out, int S, int Sk, int H, int hd,
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
  const float* kb = k + ((int64_t)b * Sk * H + h) * hd;
  const float* vb = v + ((int64_t)b * Sk * H + h) * hd;
  const int64_t stat0 = ((int64_t)b * H + h) * S + q0;

  load_kmajor<HDP>(Qt, q + qoff, stride, nrows, hd);
  load_kmajor<HDP>(dOt, dout + qoff, stride, nrows, hd);
  {  // D: four threads per row
    const int r = threadIdx.x / 4, part = threadIdx.x % 4;
    float acc = 0.f;
    if (r < nrows)
      for (int d = part; d < hd; d += 4)
        acc += dout[qoff + r * stride + d] * out[qoff + r * stride + d];
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
    load_kmajor<HDP>(Kt, kb + (int64_t)t0 * stride, stride, ncols, hd);
    load_kmajor<HDP>(Vt, vb + (int64_t)t0 * stride, stride, ncols, hd);
    load_rows<HDP>(Ks, kb + (int64_t)t0 * stride, stride, ncols, hd);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    mma_tile<1>(s, Qt, kPitch, Kt, kPitch, hd, m0, n0);
    mma_tile<1>(dp, dOt, kPitch, Vt, kPitch, hd, m0, n0);
    finish_scores(s, scale, q0, t0, nrows, ncols, causal, m0, n0);
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
    float* row = dq + qoff + (m0 + i) * stride;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int d = g * 64 + n0 + jj;
        if (d < hd) row[d] = acc[i][g * 4 + jj] * scale;
      }
  }
}

// Backward, dK and dV. grid (ceil(Sk / 64), H, B).
template <int NG>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkv(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
             const float* __restrict__ dout, const float* __restrict__ m_in,
             const float* __restrict__ l_in, const float* __restrict__ d_in,
             float* __restrict__ dk, float* __restrict__ dv, int S, int Sk, int H, int hd,
             int causal, float scale) {
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

  load_kmajor<HDP>(Kt, k + koff, stride, ncols, hd);
  load_kmajor<HDP>(Vt, v + koff, stride, ncols, hd);
  float dk_acc[4][4 * NG] = {}, dv_acc[4][4 * NG] = {};
  const int qstart = causal ? (k0 / kTile) * kTile : 0;
  for (int r0 = qstart; r0 < S; r0 += kTile) {
    const int nrows = min(kTile, S - r0);
    const int64_t qoff = (((int64_t)b * S + r0) * H + h) * hd;
    __syncthreads();
    load_kmajor<HDP>(Qt, q + qoff, stride, nrows, hd);
    load_kmajor<HDP>(dOt, dout + qoff, stride, nrows, hd);
    load_rows<HDP>(Qs, q + qoff, stride, nrows, hd);
    load_rows<HDP>(dOs, dout + qoff, stride, nrows, hd);
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
        float x = st[i][jj] * scale;
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
          dk[off + d] = dk_acc[i][g * 4 + jj] * scale;
          dv[off + d] = dv_acc[i][g * 4 + jj];
        }
      }
  }
}

// Head dims past 128 (float32): the forward is attn_fwd<4> (head dims padded
// to 256, 217 KB of shared memory a CTA). The backward kernels below hold
// only 64-dim slices of the score products' operands: S = Q K^T and
// dP = dO V^T (S^T, dP^T) add up over the slices loaded in turn, and only
// the product over keys or rows (dS K; P^T dO, dS^T Q) reads a whole
// 64 x 256 tile. Otherwise each is attn_bwd_dq / attn_bwd_dkv.
constexpr int kWideHd = 256;

template <int HDP>
constexpr int dq_wide_smem_floats() { return 4 * kTile * kPitch + kTile * HDP + kTile * kPitch + kTile; }
template <int HDP>
constexpr int dkv_wide_smem_floats() {
  return 4 * kTile * kPitch + 2 * kTile * HDP + kTile * kPitch + 3 * kTile;
}

// acc (4 x 4 of a 64 x 64 tile) += A B^T over the head dims, one 64-dim slice
// of each operand at a time: a, b the tiles' first rows (row stride
// `stride`), na, nb their valid rows.
__device__ __forceinline__ void mma_sliced(float (&acc)[4][4], float* At, float* Bt,
                                           const float* __restrict__ a,
                                           const float* __restrict__ b, int64_t stride, int na,
                                           int nb, int hd, int m0, int n0) {
  for (int d0 = 0; d0 < hd; d0 += 64) {
    const int w = min(64, hd - d0);
    __syncthreads();
    load_kmajor<64>(At, a + d0, stride, na, w);
    load_kmajor<64>(Bt, b + d0, stride, nb, w);
    __syncthreads();
    mma_tile<1>(acc, At, kPitch, Bt, kPitch, w, m0, n0);
  }
}

// Backward, dQ, hd > 128. grid (ceil(S / 64), H, B); writes D as attn_bwd_dq.
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_wide(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ out,
                 const float* __restrict__ dout, const float* __restrict__ m_in,
                 const float* __restrict__ l_in, float* __restrict__ dq,
                 float* __restrict__ d_out, int S, int Sk, int H, int hd, int causal,
                 float scale) {
  constexpr int HDP = kWideHd, NG = HDP / 64;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [64][kPitch], a slice
  float* dOt = Qt + kTile * kPitch;               // [64][kPitch]
  float* Kt = dOt + kTile * kPitch;               // [64][kPitch]
  float* Vt = Kt + kTile * kPitch;                // [64][kPitch]
  float* Ks = Vt + kTile * kPitch;                // [kTile][HDP]
  float* dSt = Ks + kTile * HDP;                  // [kTile][kPitch], dS as [key][row]
  float* Ds = dSt + kTile * kPitch;               // [kTile]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = ty * 4, n0 = tx * 4;
  const int nrows = min(kTile, S - q0);
  const int64_t stride = (int64_t)H * hd;
  const int64_t qoff = (((int64_t)b * S + q0) * H + h) * hd;
  const float* kb = k + ((int64_t)b * Sk * H + h) * hd;
  const float* vb = v + ((int64_t)b * Sk * H + h) * hd;
  const int64_t stat0 = ((int64_t)b * H + h) * S + q0;

  {  // D: four threads per row
    const int r = threadIdx.x / 4, part = threadIdx.x % 4;
    float acc = 0.f;
    if (r < nrows)
      for (int d = part; d < hd; d += 4)
        acc += dout[qoff + r * stride + d] * out[qoff + r * stride + d];
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
    float s[4][4] = {}, dp[4][4] = {};
    mma_sliced(s, Qt, Kt, q + qoff, kb + (int64_t)t0 * stride, stride, nrows, ncols, hd, m0, n0);
    mma_sliced(dp, dOt, Vt, dout + qoff, vb + (int64_t)t0 * stride, stride, nrows, ncols, hd,
               m0, n0);
    load_rows<HDP>(Ks, kb + (int64_t)t0 * stride, stride, ncols, hd);
    finish_scores(s, scale, q0, t0, nrows, ncols, causal, m0, n0);
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
    float* row = dq + qoff + (m0 + i) * stride;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int d = g * 64 + n0 + jj;
        if (d < hd) row[d] = acc[i][g * 4 + jj] * scale;
      }
  }
}

// Backward, dK and dV, hd > 128. grid (ceil(Sk / 64), H, B).
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkv_wide(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ m_in, const float* __restrict__ l_in,
                  const float* __restrict__ d_in, float* __restrict__ dk,
                  float* __restrict__ dv, int S, int Sk, int H, int hd, int causal,
                  float scale) {
  constexpr int HDP = kWideHd, NG = HDP / 64;
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);  // [64][kPitch], a slice
  float* Vt = Kt + kTile * kPitch;                // [64][kPitch]
  float* Qt = Vt + kTile * kPitch;                // [64][kPitch]
  float* dOt = Qt + kTile * kPitch;               // [64][kPitch]
  float* Qs = dOt + kTile * kPitch;               // [kTile][HDP]
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

  float dk_acc[4][4 * NG] = {}, dv_acc[4][4 * NG] = {};
  const int qstart = causal ? (k0 / kTile) * kTile : 0;
  for (int r0 = qstart; r0 < S; r0 += kTile) {
    const int nrows = min(kTile, S - r0);
    const int64_t qoff = (((int64_t)b * S + r0) * H + h) * hd;
    float st[4][4] = {}, dpt[4][4] = {};  // [key][row]
    mma_sliced(st, Kt, Qt, k + koff, q + qoff, stride, ncols, nrows, hd, m0, n0);
    mma_sliced(dpt, Vt, dOt, v + koff, dout + qoff, stride, ncols, nrows, hd, m0, n0);
    load_rows<HDP>(Qs, q + qoff, stride, nrows, hd);
    load_rows<HDP>(dOs, dout + qoff, stride, nrows, hd);
    if (threadIdx.x < kTile) {
      const int r = threadIdx.x;
      const bool ok = r < nrows;
      ms[r] = ok ? m_in[stat + r0 + r] : 0.f;
      ils[r] = ok ? 1.f / fmaxf(l_in[stat + r0 + r], 1e-30f) : 0.f;
      Ds[r] = ok ? d_in[stat + r0 + r] : 0.f;
    }
    __syncthreads();
    float pt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int key = k0 + m0 + i, row = r0 + n0 + jj;
        float x = st[i][jj] * scale;
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
          dk[off + d] = dk_acc[i][g * 4 + jj] * scale;
          dv[off + d] = dv_acc[i][g * 4 + jj];
        }
      }
  }
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int NG>
int launch_fwd(const void* q, const void* k, const void* v, void* out, void* m, void* l, int B,
               int S, int Sk, int H, int hd, int ck, int causal, float scale, cudaStream_t st) {
  const int bytes = fwd_smem_floats<64 * NG>() * 4;
  if (int err = set_smem(attn_fwd<NG>, bytes)) return err;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  attn_fwd<NG><<<grid, kThreads, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(m), static_cast<float*>(l), S, Sk, H, hd, ck,
      causal, scale);
  return (int)cudaGetLastError();
}

template <int NG>
int launch_bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const void* m, const void* l, void* dq, void* dk, void* dv, void* dbuf, int B,
               int S, int Sk, int H, int hd, int causal, float scale, cudaStream_t st) {
  const int dq_bytes = dq_smem_floats<64 * NG>() * 4;
  const int dkv_bytes = dkv_smem_floats<64 * NG>() * 4;
  if (int err = set_smem(attn_bwd_dq<NG>, dq_bytes)) return err;
  if (int err = set_smem(attn_bwd_dkv<NG>, dkv_bytes)) return err;
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(dout);
  const float* mp = static_cast<const float*>(m);
  const float* lp = static_cast<const float*>(l);
  float* dbp = static_cast<float*>(dbuf);
  attn_bwd_dq<NG><<<dim3((S + kTile - 1) / kTile, H, B), kThreads, dq_bytes, st>>>(
      qp, kp, vp, static_cast<const float*>(out), dop, mp, lp, static_cast<float*>(dq), dbp, S,
      Sk, H, hd, causal, scale);
  if (int err = (int)cudaGetLastError()) return err;
  attn_bwd_dkv<NG><<<dim3((Sk + kTile - 1) / kTile, H, B), kThreads, dkv_bytes, st>>>(
      qp, kp, vp, dop, mp, lp, dbp, static_cast<float*>(dk), static_cast<float*>(dv), S, Sk, H, hd,
      causal, scale);
  return (int)cudaGetLastError();
}

int launch_bwd_wide(const void* q, const void* k, const void* v, const void* out,
                    const void* dout, const void* m, const void* l, void* dq, void* dk, void* dv,
                    void* dbuf, int B, int S, int Sk, int H, int hd, int causal, float scale,
                    cudaStream_t st) {
  const int dq_bytes = dq_wide_smem_floats<kWideHd>() * 4;
  const int dkv_bytes = dkv_wide_smem_floats<kWideHd>() * 4;
  if (int err = set_smem(attn_bwd_dq_wide, dq_bytes)) return err;
  if (int err = set_smem(attn_bwd_dkv_wide, dkv_bytes)) return err;
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(dout);
  const float* mp = static_cast<const float*>(m);
  const float* lp = static_cast<const float*>(l);
  float* dbp = static_cast<float*>(dbuf);
  attn_bwd_dq_wide<<<dim3((S + kTile - 1) / kTile, H, B), kThreads, dq_bytes, st>>>(
      qp, kp, vp, static_cast<const float*>(out), dop, mp, lp, static_cast<float*>(dq), dbp, S,
      Sk, H, hd, causal, scale);
  if (int err = (int)cudaGetLastError()) return err;
  attn_bwd_dkv_wide<<<dim3((Sk + kTile - 1) / kTile, H, B), kThreads, dkv_bytes, st>>>(
      qp, kp, vp, dop, mp, lp, dbp, static_cast<float*>(dk), static_cast<float*>(dv), S, Sk, H, hd,
      causal, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernels (wgmma, operands fed by TMA)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kPanel = 64 * 128;  // bytes of one 128-byte-swizzled panel: 64 rows x 64 bf16
constexpr int kStages = 2;        // depth of the forward's ring of streamed tiles
constexpr int kBwdStages = 4;     // the backward's: a consumer frees a stage one tile late
// The backward's CTA: two warpgroups and no producer warp, so ptxas may give
// each thread 255 registers (384 threads cap every thread at 168, and ptxas
// allots registers to warps in fours, so 288 do too).
constexpr int kBwdThreads = 256;
constexpr int kConsumers = 256;   // threads of the forward's two consumer warpgroups

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to 1,024 bytes, where the 128-byte
// swizzle's 8-row pattern starts (the wgmma descriptors' base offset 0).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait for the phase of parity `parity` to complete. A wait that lasts 10 s
// traps: a fault in the pipeline then ends the launch with an error rather
// than holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done, spins = 0;
  uint64_t start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (++spins % 4096 == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (!start) start = now;
      else if (now - start > 10000000000ull) __trap();
    }
  }
}

// One box of a (B, L, H, hd) tensor map: 64 head dims from c0, head c1, 64
// rows from c2, batch row c3.
__device__ __forceinline__ void tma_rows(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// 64 consecutive float32 of a flat (B H S) tensor map from element c0.
__device__ __forceinline__ void tma_stats(void* dst, const CUtensorMap* map, uint64_t* bar,
                                          int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0)
      : "memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Registers that an asynchronous wgmma reads or writes stay put (and live)
// across the wait: the compiler sees them change here.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A wgmma shared-memory descriptor of a tile in 128-byte swizzled rows (what
// TMA's SWIZZLE_128B writes): start address, leading offset 16 bytes (not
// read: every operand is one 64-element swizzle atom wide), stride 1,024
// bytes from one 8-row group to the next, layout SWIZZLE_128B. A K-major
// operand steps 32 bytes a k-step inside its atom; an MN-major one (the
// transpose bit) 16 rows, 2,048 bytes.
__device__ __forceinline__ uint64_t desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFFu) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// D (64 x 64, float32) (+)= A B^T, A and B K-major in shared memory.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// D (64 x 64, float32) (+)= A B, A (64 x 16 bf16) in registers as the
// accumulator's layout packs it, B MN-major in shared memory.
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// 2^x, one MUFU instruction (ex2.approx.ftz: a result below 2^-126 flushes
// to 0; exp2f adds the range handling around it)
__device__ __forceinline__ float pow2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The accumulator of a 64 x N wgmma: thread t of the warpgroup holds, at
// register e, row 16 (t / 32) + (t % 32) / 4 + 8 half(e) and column
// 8 (e / 4) + 2 (t % 4) + (e % 2).
__device__ __forceinline__ int acc_half(int e) { return (e >> 1) & 1; }
__device__ __forceinline__ int acc_col(int e, int lane) { return 8 * (e >> 2) + 2 * (lane & 3) + (e & 1); }

// Forward. grid (ceil(S / 128), H, B); 384 threads: warpgroups 0 and 1
// consume (64 query rows each), warp 8 of warpgroup 2 produces. q, k, v
// arrive by TMA: q once, K/V 64-key tiles through a ring of kStages stages
// in the order the reference's chunks visit them.
template <int NP>
__global__ void __launch_bounds__(384, 1)
attn_fwd_tc(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
            const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ out,
            float* __restrict__ m_out, float* __restrict__ l_out, int S, int Sk, int H, int hd,
            int ck, int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[kStages], empty[kStages];
  uint8_t* Qs = align1024(smem_raw);           // [warpgroup][panel]
  uint8_t* ring = Qs + 2 * NP * kPanel;        // [stage][K panels, V panels]
  constexpr int kStage = 2 * NP * kPanel;

  const int b = blockIdx.z, h = blockIdx.y;
  // causal: the longest query tiles first
  const int q0 = 128 * (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  const int last_row = min(q0 + 128, S) - 1;
  const int nk = causal ? last_row / ck + 1 : Sk / ck;
  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer
    regs_dec<24>();
    if (threadIdx.x != kConsumers) return;
    mbar_expect_tx(&q_full, 2 * NP * kPanel);
    for (int g = 0; g < 2; ++g)
      for (int p = 0; p < NP; ++p)
        tma_rows(Qs + (g * NP + p) * kPanel, &q_map, &q_full, 64 * p, h, q0 + 64 * g, b);
    int stage = 0;
    uint32_t phase = 0;
    for (int j = 0; j < nk; ++j) {
      const int c0 = j * ck, c_end = causal ? min(c0 + ck, last_row + 1) : c0 + ck;
      for (int t0 = c0; t0 < c_end; t0 += 64) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], kStage);
        uint8_t* st = ring + stage * kStage;
        for (int p = 0; p < NP; ++p) {
          tma_rows(st + p * kPanel, &k_map, &full[stage], 64 * p, h, t0, b);
          tma_rows(st + (NP + p) * kPanel, &v_map, &full[stage], 64 * p, h, t0, b);
        }
        if (++stage == kStages) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  regs_inc<240>();
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int r_lo = 16 * ((threadIdx.x % 128) / 32) + lane / 4;  // rows r_lo and r_lo + 8
  const int row0 = q0 + 64 * wg;
  const uint8_t* Qw = Qs + wg * NP * kPanel;
  float o[NP][32], pv[NP][32], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[p][e] = 0.f;
  mbar_wait(&q_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int j = 0; j < nk; ++j) {
    const int c0 = j * ck, c_end = causal ? min(c0 + ck, last_row + 1) : c0 + ck;
    // the chunk's running max, and its sum and p.v relative to it
    float m_run[2] = {m[0], m[1]}, lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int e = 0; e < 32; ++e) pv[p][e] = 0.f;
    for (int t0 = c0; t0 < c_end; t0 += 64) {
      const int ncols = min(64, c_end - t0);
      const uint8_t* st = ring + stage * kStage;
      mbar_wait(&full[stage], phase);
      float s[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NP; ++kk)
        mma_ss(s, desc(Qw + (kk / 4) * kPanel + (kk % 4) * 32),
               desc(st + (kk / 4) * kPanel + (kk % 4) * 32), kk > 0);
      wg_commit();
      wg_wait<0>();
      keep(s);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int col = acc_col(e, lane), row = row0 + r_lo + 8 * acc_half(e);
        float x = round_bf16(s[e]) * scale;
        if (causal && t0 + col > row) x = kNegInf;
        if (col >= ncols) x = -INFINITY;
        s[e] = x;
        mx[acc_half(e)] = fmaxf(mx[acc_half(e)], x);
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_t = fmaxf(m_run[i], quad_max(mx[i]));
        alpha[i] = expf(m_run[i] - m_t);
        lsum[i] *= alpha[i];
        m_run[i] = m_t;
      }
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int e = 0; e < 32; ++e) pv[p][e] *= alpha[acc_half(e)];
      uint32_t pk[16];  // p in bf16, the A operand of p.v
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int i = acc_half(e);
        const float p0 = expf(s[e] - m_run[i]), p1 = expf(s[e + 1] - m_run[i]);
        lsum[i] += p0;
        lsum[i] += p1;
        pk[e / 2] = pack_bf16(p0, p1);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < NP; ++p)
          mma_rs(pv[p], pk + 4 * kk, desc(st + (NP + p) * kPanel + kk * 2048), 1);
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int p = 0; p < NP; ++p) keep(pv[p]);
      keep(pk);
      mbar_arrive(&empty[stage]);
      if (++stage == kStages) stage = 0, phase ^= 1;
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      corr[i] = expf(m[i] - m_run[i]);
      l[i] = l[i] * corr[i] + quad_sum(lsum[i]);
      m[i] = m_run[i];
    }
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int e = 0; e < 32; ++e)
        o[p][e] = o[p][e] * corr[acc_half(e)] + round_bf16(pv[p][e]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r_lo + 8 * i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    bf16* orow = out + (((int64_t)b * S + row) * H + h) * hd;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int e = 2 * i; e < 32; e += 4) {
        const int d = 64 * p + acc_col(e, lane);
        if (d < hd)
          *reinterpret_cast<__nv_bfloat162*>(orow + d) =
              __floats2bfloat162_rn(o[p][e] / den, o[p][e + 1] / den);
      }
    if (lane % 4 == 0) {
      const int64_t idx = ((int64_t)b * H + h) * S + row;
      m_out[idx] = m[i];
      l_out[idx] = l[i];
    }
  }
}

// S (or S^T) = A B^T over the head dims, both operands' NP panels K-major
// in shared memory.
template <int NP>
__device__ __forceinline__ void mma_hd(float (&d)[32], const uint8_t* a, const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4 * NP; ++kk)
    mma_ss(d, desc(a + (kk / 4) * kPanel + (kk % 4) * 32),
           desc(b + (kk / 4) * kPanel + (kk % 4) * 32), kk > 0);
}

template <int NP>
constexpr int dq_tc_smem() { return 1024 + (4 + 2 * kBwdStages) * NP * kPanel; }
template <int NP>
constexpr int dkv_tc_smem() { return 1024 + 4 * NP * kPanel + kBwdStages * (2 * NP * kPanel + 1024); }

// The backward's rings have no producer warp: thread 0 loads the first
// kBwdStages tiles, and a stage is refilled by whichever warpgroup frees it
// second (a running count in shared memory: the second of each round finds
// it odd), so neither ever waits for the other. `refill` loads the tile
// kBwdStages after the one the stage held.
template <typename Refill>
__device__ __forceinline__ void free_stage(int* freed, int wg, int t, Refill refill) {
  bar_sync(1 + wg, 128);  // every thread of this warpgroup is done with the stage
  if (t == 0) {
    __threadfence_block();
    if (atomicAdd(freed, 1) & 1) refill();
  }
}

// CTAs of the dQ kernel resident on an SM: at NP = 1 two fit (128 registers
// a thread, 2 x 98 KB of shared memory), and the four warpgroups hide each
// other's waits (0.71 -> 0.59 ms at 4 x 4,096, 16 heads of 64, on an H100,
// where ptxas serializes the warpgroup's products within the 128 registers).
template <int NP>
constexpr int kDqCtas = NP == 1 ? 2 : 1;

// Backward, dQ. grid (H, B, ceil(S / 128)), the longest causal tiles first;
// kBwdThreads: warpgroups 0 and 1 take 64 query rows each. Also writes, for
// the dK/dV kernel, each row's m log2(e), 1 / max(l, 1e-30) and D =
// rowsum(dO * O) into `rows` (B H, 3, S64) float32, S64 = S rounded up to 64
// (zeros past S), so that kernel's TMA boxes of 64 rows start on 256-byte
// boundaries. q and dO arrive by TMA once, K/V 64-key tiles through a ring
// of kBwdStages.
template <int NP>
__global__ void __launch_bounds__(kBwdThreads, kDqCtas<NP>)
attn_bwd_dq_tc(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               const __grid_constant__ CUtensorMap do_map, const bf16* __restrict__ out,
               const bf16* __restrict__ dout, const float* __restrict__ m_in,
               const float* __restrict__ l_in, bf16* __restrict__ dq, float* __restrict__ rows,
               int S, int Sk, int H, int hd, int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[kBwdStages];
  __shared__ int freed[kBwdStages];
  __shared__ float Dsm[2][64];
  uint8_t* Qs = align1024(smem_raw);       // [warpgroup][panel]
  uint8_t* dOs = Qs + 2 * NP * kPanel;     // [warpgroup][panel]
  uint8_t* ring = dOs + 2 * NP * kPanel;   // [stage][K panels, V panels]
  constexpr int kStage = 2 * NP * kPanel;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = 128 * (causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z);
  const int kend = causal ? min(Sk, min(q0 + 128, S)) : Sk;
  const int ntiles = (kend + 63) / 64;
  auto load = [&](int it) {  // key tile it into its stage
    const int s = it % kBwdStages;
    mbar_expect_tx(&full[s], kStage);
    for (int p = 0; p < NP; ++p) {
      tma_rows(ring + s * kStage + p * kPanel, &k_map, &full[s], 64 * p, h, 64 * it, b);
      tma_rows(ring + s * kStage + (NP + p) * kPanel, &v_map, &full[s], 64 * p, h, 64 * it, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], 1);
      freed[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&q_full, 4 * NP * kPanel);
    for (int g = 0; g < 2; ++g)
      for (int p = 0; p < NP; ++p) {
        tma_rows(Qs + (g * NP + p) * kPanel, &q_map, &q_full, 64 * p, h, q0 + 64 * g, b);
        tma_rows(dOs + (g * NP + p) * kPanel, &do_map, &q_full, 64 * p, h, q0 + 64 * g, b);
      }
    for (int it = 0; it < min(ntiles, kBwdStages); ++it) load(it);
  }

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = threadIdx.x % 32;
  const int r_lo = 16 * (t / 32) + lane / 4;
  const int row0 = q0 + 64 * wg;
  const int64_t stat = ((int64_t)b * H + h) * S;
  {  // D: two threads a row
    const int r = t / 2, part = t % 2, row = row0 + r, s64 = (S + 63) / 64 * 64;
    float acc = 0.f;
    if (row < S) {  // 16-byte loads: hd is a multiple of 8, the rows 16-byte aligned
      const int64_t off = (((int64_t)b * S + row) * H + h) * hd;
      for (int d = 8 * part; d < hd; d += 16) {
        const uint4 g4 = *reinterpret_cast<const uint4*>(dout + off + d);
        const uint4 y4 = *reinterpret_cast<const uint4*>(out + off + d);
        const uint32_t gw[4] = {g4.x, g4.y, g4.z, g4.w}, yw[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gw[c]));
          const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&yw[c]));
          acc += g.x * y.x;
          acc += g.y * y.y;
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (part == 0) {
      Dsm[wg][r] = acc;
      if (row < s64) {
        float* plane = rows + ((int64_t)b * H + h) * 3 * s64 + row;
        plane[0] = row < S ? m_in[stat + row] * kLog2e : 0.f;
        plane[s64] = row < S ? 1.f / fmaxf(l_in[stat + row], 1e-30f) : 0.f;
        plane[2 * s64] = acc;
      }
    }
    bar_sync(1 + wg, 128);
  }
  float m2[2], inv_l[2], drow[2];  // m2: m log2(e), so p = exp2(x log2(e) - m2) / l
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r_lo + 8 * i;
    const bool ok = row < S;
    m2[i] = ok ? m_in[stat + row] * kLog2e : 0.f;
    inv_l[i] = ok ? 1.f / fmaxf(l_in[stat + row], 1e-30f) : 0.f;
    drow[i] = Dsm[wg][r_lo + 8 * i];
  }
  const float scale2 = scale * kLog2e;
  // the key tiles this warpgroup's rows see: causal, up to its diagonal tile
  const int it_end = row0 >= S ? 0 : causal ? min(ntiles, row0 / 64 + 1) : ntiles;
  auto release = [&](int it) {  // this warpgroup is done with tile it
    free_stage(&freed[it % kBwdStages], wg, t, [&] {
      if (it + kBwdStages < ntiles) load(it + kBwdStages);
    });
  };
  const uint8_t* Qw = Qs + wg * NP * kPanel;
  const uint8_t* dOw = dOs + wg * NP * kPanel;
  float acc[NP][32], s[32], dp[32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[p][e] = 0.f;
  uint32_t ds16[16];
  mbar_wait(&q_full, 0);
  for (int it = 0; it < it_end; ++it) {
    const int t0 = 64 * it;
    const uint8_t* st = ring + (it % kBwdStages) * kStage;
    mbar_wait(&full[it % kBwdStages], (it / kBwdStages) & 1);
    wg_fence();
    mma_hd<NP>(s, Qw, st);
    wg_commit();
    mma_hd<NP>(dp, dOw, st + NP * kPanel);
    wg_commit();
    wg_wait<1>();  // S, and the previous tile's dQ product: its stage is free
    keep(s);
    keep(ds16);
    if (it > 0) release(it - 1);
    // P, float32, in place of S while dP is in flight; the masks only on
    // the diagonal tile (causal) or the ragged last one
    const bool edge = causal ? t0 + 63 > row0 : t0 + 64 > Sk;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = acc_half(e);
      float p = pow2(fmaf(round_bf16(s[e]), scale2, -m2[i])) * inv_l[i];
      if (edge) {
        const int col = t0 + acc_col(e, lane), row = row0 + r_lo + 8 * i;
        if (causal ? col > row : col >= Sk) p = 0.f;
      }
      s[e] = p;
    }
    wg_wait<0>();
    keep(dp);
#pragma unroll
    for (int e = 0; e < 32; e += 2)  // dS in bf16, the A operand of dS K
      ds16[e / 2] = pack_bf16(s[e] * (dp[e] - drow[acc_half(e)]),
                              s[e + 1] * (dp[e + 1] - drow[acc_half(e)]));
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        mma_rs(acc[p], ds16 + 4 * kk, desc(st + p * kPanel + kk * 2048), 1);
    wg_commit();
  }
  wg_wait<0>();
#pragma unroll
  for (int p = 0; p < NP; ++p) keep(acc[p]);
  keep(ds16);
  if (it_end > 0) release(it_end - 1);
  for (int it = it_end; it < ntiles; ++it) {  // tiles wholly masked for these rows
    mbar_wait(&full[it % kBwdStages], (it / kBwdStages) & 1);
    release(it);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r_lo + 8 * i;
    if (row >= S) continue;
    bf16* drow_out = dq + (((int64_t)b * S + row) * H + h) * hd;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int e = 2 * i; e < 32; e += 4) {
        const int d = 64 * p + acc_col(e, lane);
        if (d < hd)
          *reinterpret_cast<__nv_bfloat162*>(drow_out + d) =
              __floats2bfloat162_rn(acc[p][e] * scale, acc[p][e + 1] * scale);
      }
  }
}

// Backward, dK and dV. grid (H, B, ceil(Sk / 128)), the longest causal key
// ranges first; kBwdThreads: warpgroups 0 and 1 take 64 keys each (K and V
// resident).
// The query tiles at or below the CTA's diagonal stream through a ring of
// kBwdStages, each tile feeding both warpgroups: q, dO and the rows' m
// log2(e), 1/l, D (the dQ kernel's `rows`), all by TMA.
template <int NP>
__global__ void __launch_bounds__(kBwdThreads, 1)
attn_bwd_dkv_tc(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap do_map,
                const __grid_constant__ CUtensorMap rows_map, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int S, int Sk, int H, int hd, int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_full, full[kBwdStages];
  __shared__ int freed[kBwdStages];
  uint8_t* Ks = align1024(smem_raw);       // [warpgroup][panel]
  uint8_t* Vs = Ks + 2 * NP * kPanel;      // [warpgroup][panel]
  uint8_t* ring = Vs + 2 * NP * kPanel;    // [stage][q panels, dO panels, m log2(e) 1/l D]
  constexpr int kStage = 2 * NP * kPanel + 1024;

  const int h = blockIdx.x, b = blockIdx.y, k0 = 128 * blockIdx.z;
  const int qstart = causal ? k0 : 0;
  const int ntiles = (S - qstart + 63) / 64;
  const int s64 = (S + 63) / 64 * 64, plane = (b * H + h) * 3 * s64;
  auto load = [&](int it) {  // query tile it into its stage
    const int s = it % kBwdStages, r0 = qstart + 64 * it;
    uint8_t* st = ring + s * kStage;
    mbar_expect_tx(&full[s], 2 * NP * kPanel + 3 * 256);
    for (int p = 0; p < NP; ++p) {
      tma_rows(st + p * kPanel, &q_map, &full[s], 64 * p, h, r0, b);
      tma_rows(st + (NP + p) * kPanel, &do_map, &full[s], 64 * p, h, r0, b);
    }
    for (int c = 0; c < 3; ++c)
      tma_stats(st + 2 * NP * kPanel + 256 * c, &rows_map, &full[s], plane + c * s64 + r0);
  };
  if (threadIdx.x == 0) {
    mbar_init(&kv_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], 1);
      freed[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&kv_full, 4 * NP * kPanel);
    for (int g = 0; g < 2; ++g)
      for (int p = 0; p < NP; ++p) {
        tma_rows(Ks + (g * NP + p) * kPanel, &k_map, &kv_full, 64 * p, h, k0 + 64 * g, b);
        tma_rows(Vs + (g * NP + p) * kPanel, &v_map, &kv_full, 64 * p, h, k0 + 64 * g, b);
      }
    for (int it = 0; it < min(ntiles, kBwdStages); ++it) load(it);
  }

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = threadIdx.x % 32;
  const int r_lo = 16 * (t / 32) + lane / 4;  // keys kw0 + r_lo, kw0 + r_lo + 8
  const int kw0 = k0 + 64 * wg;
  // the query tiles this warpgroup's keys see: causal, from its diagonal tile
  const int it_begin = kw0 >= Sk ? ntiles : causal ? wg : 0;
  auto release = [&](int it) {  // this warpgroup is done with tile it
    free_stage(&freed[it % kBwdStages], wg, t, [&] {
      if (it + kBwdStages < ntiles) load(it + kBwdStages);
    });
  };
  const float scale2 = scale * kLog2e;
  const uint8_t* Kw = Ks + wg * NP * kPanel;
  const uint8_t* Vw = Vs + wg * NP * kPanel;
  float acc_k[NP][32], acc_v[NP][32], s[32], dp[32];  // S^T, dP^T: [key][query row]
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc_k[p][e] = acc_v[p][e] = 0.f;
  uint32_t pk[16], ds16[16];
  mbar_wait(&kv_full, 0);
  for (int it = 0; it < it_begin; ++it) {  // tiles wholly masked for these keys
    mbar_wait(&full[it % kBwdStages], (it / kBwdStages) & 1);
    release(it);
  }
  for (int it = it_begin; it < ntiles; ++it) {
    const int r0 = qstart + 64 * it;
    const uint8_t* st = ring + (it % kBwdStages) * kStage;
    const float* m2 = reinterpret_cast<const float*>(st + 2 * NP * kPanel);  // m log2(e)
    const float* inv_l = m2 + 64;
    const float* Ds = m2 + 128;
    mbar_wait(&full[it % kBwdStages], (it / kBwdStages) & 1);
    wg_fence();
    mma_hd<NP>(s, Kw, st);
    wg_commit();
    mma_hd<NP>(dp, Vw, st + NP * kPanel);
    wg_commit();
    wg_wait<1>();  // S^T, and the previous tile's dV and dK products: its stage is free
    keep(s);
    keep(pk);
    keep(ds16);
    if (it > it_begin) release(it - 1);
    // P^T, float32, in place of S^T while dP^T is in flight; the causal mask
    // only on the diagonal tile (rows and keys past S and Sk need none: their
    // q and dO are zeros and 1/l is 0, and no key's row is stored)
    const bool diag = causal && r0 == kw0;
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = acc_col(e + c, lane);
        float p = pow2(fmaf(round_bf16(s[e + c]), scale2, -m2[col])) * inv_l[col];
        if (diag && r_lo + 8 * acc_half(e) > col) p = 0.f;
        s[e + c] = p;
      }
      pk[e / 2] = pack_bf16(s[e], s[e + 1]);  // P^T in bf16, the A operand of dV
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        mma_rs(acc_v[p], pk + 4 * kk, desc(st + (NP + p) * kPanel + kk * 2048), 1);
    wg_commit();
    wg_wait<1>();  // dP^T (dV's product stays in flight)
    keep(dp);
#pragma unroll
    for (int e = 0; e < 32; e += 2) {  // dS^T in bf16, the A operand of dK
      const int col = acc_col(e, lane);
      ds16[e / 2] = pack_bf16(s[e] * (dp[e] - Ds[col]), s[e + 1] * (dp[e + 1] - Ds[col + 1]));
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        mma_rs(acc_k[p], ds16 + 4 * kk, desc(st + p * kPanel + kk * 2048), 1);
    wg_commit();
  }
  wg_wait<0>();
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    keep(acc_k[p]);
    keep(acc_v[p]);
  }
  keep(pk);
  keep(ds16);
  if (ntiles > it_begin) release(ntiles - 1);
  const int ncols = min(64, Sk - kw0);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kl = r_lo + 8 * i;
    if (kl >= ncols) continue;
    const int64_t off = (((int64_t)b * Sk + kw0 + kl) * H + h) * hd;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int e = 2 * i; e < 32; e += 4) {
        const int d = 64 * p + acc_col(e, lane);
        if (d < hd) {
          *reinterpret_cast<__nv_bfloat162*>(dk + off + d) =
              __floats2bfloat162_rn(acc_k[p][e] * scale, acc_k[p][e + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + off + d) =
              __floats2bfloat162_rn(acc_v[p][e], acc_v[p][e + 1]);
        }
      }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 at head dims past 128 (Zamba2's 224): the "wide" kernels
// ---------------------------------------------------------------------------
//
// Head dims are padded to 256 in shared memory (kWideNP = 4 panels; TMA
// fills zeros past hd), and the score products stop at the last 16-dim step
// that holds a head dim (14 of 16 at hd 224). A warpgroup cannot hold a
// 64 x 224 float32 accumulator twice (the forward's o and the chunk's p.v,
// or dK and dV: 224 registers a thread), so both warpgroups of a CTA take
// the same 64 rows (forward, dQ) or keys (dK/dV), each computes the score
// products whole, and each owns the output's head dims of two panels:
// warpgroup w panels 2w and 2w + 1 (dims 0-127 and 128-223). The score
// products are done twice a CTA; the flops of the output products are not.
// 256 threads and no producer warp, so ptxas may give a thread 255
// registers; the rings are refilled as the backward's (free_stage).
constexpr int kWideNP = 4;
constexpr int kWideFwdStages = 3;  // K and V of a 64-key tile: 64 KB a stage
constexpr int kWideBwdStages = 2;

constexpr int fwd_tc_wide_smem() { return 1024 + (1 + 2 * kWideFwdStages) * kWideNP * kPanel; }
constexpr int dq_tc_wide_smem() { return 1024 + (2 + 2 * kWideBwdStages) * kWideNP * kPanel; }
constexpr int dkv_tc_wide_smem() {
  return 1024 + 2 * kWideNP * kPanel + kWideBwdStages * (2 * kWideNP * kPanel + 1024);
}

// S (or S^T) = A B^T over the first `ksteps` 16-dim steps of the head dims,
// both operands' kWideNP panels K-major in shared memory.
__device__ __forceinline__ void mma_hd_wide(float (&d)[32], const uint8_t* a, const uint8_t* b,
                                            int ksteps) {
#pragma unroll
  for (int kk = 0; kk < 4 * kWideNP; ++kk)
    if (kk < ksteps)
      mma_ss(d, desc(a + (kk / 4) * kPanel + (kk % 4) * 32),
             desc(b + (kk / 4) * kPanel + (kk % 4) * 32), kk > 0);
}

// Forward, hd > 128. grid (ceil(S / 64), H, B), the longest causal tiles
// first; kBwdThreads. q arrives once; K/V 64-key tiles through a ring of
// kWideFwdStages in the chunks' order (tile it of the CTA: chunk it / tpc,
// tpc = ceil(ck / 64) tiles a chunk, only the last chunk cut short). The
// arithmetic a row sees is attn_fwd_tc's.
__global__ void __launch_bounds__(kBwdThreads, 1)
attn_fwd_tc_wide(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ out,
                 float* __restrict__ m_out, float* __restrict__ l_out, int S, int Sk, int H,
                 int hd, int ck, int causal, float scale) {
  constexpr int NP = kWideNP, kStage = 2 * NP * kPanel;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[kWideFwdStages];
  __shared__ int freed[kWideFwdStages];
  uint8_t* Qs = align1024(smem_raw);  // [panel]
  uint8_t* ring = Qs + NP * kPanel;   // [stage][K panels, V panels]

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = 64 * (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  const int last_row = min(q0 + 64, S) - 1;
  const int nk = causal ? last_row / ck + 1 : Sk / ck;
  const int tpc = (ck + 63) / 64;
  const int last_c0 = (nk - 1) * ck;
  const int last_end = causal ? min(last_c0 + ck, last_row + 1) : last_c0 + ck;
  const int ntiles = (nk - 1) * tpc + (last_end - last_c0 + 63) / 64;
  auto load = [&](int it) {  // key tile it into its stage
    const int s = it % kWideFwdStages, t0 = (it / tpc) * ck + 64 * (it % tpc);
    mbar_expect_tx(&full[s], kStage);
    for (int p = 0; p < NP; ++p) {
      tma_rows(ring + s * kStage + p * kPanel, &k_map, &full[s], 64 * p, h, t0, b);
      tma_rows(ring + s * kStage + (NP + p) * kPanel, &v_map, &full[s], 64 * p, h, t0, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < kWideFwdStages; ++s) {
      mbar_init(&full[s], 1);
      freed[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&q_full, NP * kPanel);
    for (int p = 0; p < NP; ++p) tma_rows(Qs + p * kPanel, &q_map, &q_full, 64 * p, h, q0, b);
    for (int it = 0; it < min(ntiles, kWideFwdStages); ++it) load(it);
  }

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = threadIdx.x % 32;
  const int r_lo = 16 * (t / 32) + lane / 4;  // rows r_lo and r_lo + 8
  const int ksteps = (hd + 15) / 16;
  float o[2][32], pv[2][32], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[p][e] = 0.f;
  mbar_wait(&q_full, 0);
  int it = 0;
  for (int j = 0; j < nk; ++j) {
    const int c0 = j * ck, c_end = causal ? min(c0 + ck, last_row + 1) : c0 + ck;
    float m_run[2] = {m[0], m[1]}, lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int e = 0; e < 32; ++e) pv[p][e] = 0.f;
    for (int t0 = c0; t0 < c_end; t0 += 64, ++it) {
      const int ncols = min(64, c_end - t0);
      const uint8_t* st = ring + (it % kWideFwdStages) * kStage;
      mbar_wait(&full[it % kWideFwdStages], (it / kWideFwdStages) & 1);
      float s[32];
      wg_fence();
      mma_hd_wide(s, Qs, st, ksteps);
      wg_commit();
      wg_wait<0>();
      keep(s);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int col = acc_col(e, lane), row = q0 + r_lo + 8 * acc_half(e);
        float x = round_bf16(s[e]) * scale;
        if (causal && t0 + col > row) x = kNegInf;
        if (col >= ncols) x = -INFINITY;
        s[e] = x;
        mx[acc_half(e)] = fmaxf(mx[acc_half(e)], x);
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_t = fmaxf(m_run[i], quad_max(mx[i]));
        alpha[i] = expf(m_run[i] - m_t);
        lsum[i] *= alpha[i];
        m_run[i] = m_t;
      }
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int e = 0; e < 32; ++e) pv[p][e] *= alpha[acc_half(e)];
      uint32_t pk[16];  // p in bf16, the A operand of p.v
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int i = acc_half(e);
        const float p0 = expf(s[e] - m_run[i]), p1 = expf(s[e + 1] - m_run[i]);
        lsum[i] += p0;
        lsum[i] += p1;
        pk[e / 2] = pack_bf16(p0, p1);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          mma_rs(pv[p], pk + 4 * kk, desc(st + (NP + 2 * wg + p) * kPanel + kk * 2048), 1);
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int p = 0; p < 2; ++p) keep(pv[p]);
      keep(pk);
      const int done = it;
      free_stage(&freed[done % kWideFwdStages], wg, t, [&] {
        if (done + kWideFwdStages < ntiles) load(done + kWideFwdStages);
      });
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      corr[i] = expf(m[i] - m_run[i]);
      l[i] = l[i] * corr[i] + quad_sum(lsum[i]);
      m[i] = m_run[i];
    }
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int e = 0; e < 32; ++e)
        o[p][e] = o[p][e] * corr[acc_half(e)] + round_bf16(pv[p][e]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r_lo + 8 * i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    bf16* orow = out + (((int64_t)b * S + row) * H + h) * hd;
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int e = 2 * i; e < 32; e += 4) {
        const int d = 64 * (2 * wg + p) + acc_col(e, lane);
        if (d < hd)
          *reinterpret_cast<__nv_bfloat162*>(orow + d) =
              __floats2bfloat162_rn(o[p][e] / den, o[p][e + 1] / den);
      }
    if (wg == 0 && lane % 4 == 0) {
      const int64_t idx = ((int64_t)b * H + h) * S + row;
      m_out[idx] = m[i];
      l_out[idx] = l[i];
    }
  }
}

// Backward, dQ, hd > 128. grid (H, B, ceil(S / 64)), the longest causal
// tiles first; kBwdThreads, both warpgroups on the CTA's 64 query rows.
// Writes `rows` as attn_bwd_dq_tc does (warpgroup 0). q and dO arrive once,
// K/V 64-key tiles through a ring of kWideBwdStages.
__global__ void __launch_bounds__(kBwdThreads, 1)
attn_bwd_dq_tc_wide(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map, const bf16* __restrict__ out,
                    const bf16* __restrict__ dout, const float* __restrict__ m_in,
                    const float* __restrict__ l_in, bf16* __restrict__ dq,
                    float* __restrict__ rows, int S, int Sk, int H, int hd, int causal,
                    float scale) {
  constexpr int NP = kWideNP, kStage = 2 * NP * kPanel;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[kWideBwdStages];
  __shared__ int freed[kWideBwdStages];
  __shared__ float Dsm[64];
  uint8_t* Qs = align1024(smem_raw);  // [panel]
  uint8_t* dOs = Qs + NP * kPanel;    // [panel]
  uint8_t* ring = dOs + NP * kPanel;  // [stage][K panels, V panels]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = 64 * (causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z);
  const int kend = causal ? min(Sk, min(q0 + 64, S)) : Sk;
  const int ntiles = (kend + 63) / 64;
  auto load = [&](int it) {  // key tile it into its stage
    const int s = it % kWideBwdStages;
    mbar_expect_tx(&full[s], kStage);
    for (int p = 0; p < NP; ++p) {
      tma_rows(ring + s * kStage + p * kPanel, &k_map, &full[s], 64 * p, h, 64 * it, b);
      tma_rows(ring + s * kStage + (NP + p) * kPanel, &v_map, &full[s], 64 * p, h, 64 * it, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < kWideBwdStages; ++s) {
      mbar_init(&full[s], 1);
      freed[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&q_full, 2 * NP * kPanel);
    for (int p = 0; p < NP; ++p) {
      tma_rows(Qs + p * kPanel, &q_map, &q_full, 64 * p, h, q0, b);
      tma_rows(dOs + p * kPanel, &do_map, &q_full, 64 * p, h, q0, b);
    }
    for (int it = 0; it < min(ntiles, kWideBwdStages); ++it) load(it);
  }

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = threadIdx.x % 32;
  const int r_lo = 16 * (t / 32) + lane / 4;
  const int64_t stat = ((int64_t)b * H + h) * S;
  if (wg == 0) {  // D: two threads a row
    const int r = t / 2, part = t % 2, row = q0 + r, s64 = (S + 63) / 64 * 64;
    float acc = 0.f;
    if (row < S) {  // 16-byte loads: hd is a multiple of 8, the rows 16-byte aligned
      const int64_t off = (((int64_t)b * S + row) * H + h) * hd;
      for (int d = 8 * part; d < hd; d += 16) {
        const uint4 g4 = *reinterpret_cast<const uint4*>(dout + off + d);
        const uint4 y4 = *reinterpret_cast<const uint4*>(out + off + d);
        const uint32_t gw[4] = {g4.x, g4.y, g4.z, g4.w}, yw[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gw[c]));
          const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&yw[c]));
          acc += g.x * y.x;
          acc += g.y * y.y;
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (part == 0) {
      Dsm[r] = acc;
      if (row < s64) {
        float* plane = rows + ((int64_t)b * H + h) * 3 * s64 + row;
        plane[0] = row < S ? m_in[stat + row] * kLog2e : 0.f;
        plane[s64] = row < S ? 1.f / fmaxf(l_in[stat + row], 1e-30f) : 0.f;
        plane[2 * s64] = acc;
      }
    }
  }
  __syncthreads();
  float m2[2], inv_l[2], drow[2];  // m2: m log2(e), so p = exp2(x log2(e) - m2) / l
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r_lo + 8 * i;
    const bool ok = row < S;
    m2[i] = ok ? m_in[stat + row] * kLog2e : 0.f;
    inv_l[i] = ok ? 1.f / fmaxf(l_in[stat + row], 1e-30f) : 0.f;
    drow[i] = Dsm[r_lo + 8 * i];
  }
  const float scale2 = scale * kLog2e;
  const int ksteps = (hd + 15) / 16;
  const int it_end = q0 >= S ? 0 : ntiles;
  auto release = [&](int it) {  // this warpgroup is done with tile it
    free_stage(&freed[it % kWideBwdStages], wg, t, [&] {
      if (it + kWideBwdStages < ntiles) load(it + kWideBwdStages);
    });
  };
  float acc[2][32], s[32], dp[32];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[p][e] = 0.f;
  uint32_t ds16[16];
  mbar_wait(&q_full, 0);
  for (int it = 0; it < it_end; ++it) {
    const int t0 = 64 * it;
    const uint8_t* st = ring + (it % kWideBwdStages) * kStage;
    mbar_wait(&full[it % kWideBwdStages], (it / kWideBwdStages) & 1);
    wg_fence();
    mma_hd_wide(s, Qs, st, ksteps);
    wg_commit();
    mma_hd_wide(dp, dOs, st + NP * kPanel, ksteps);
    wg_commit();
    wg_wait<1>();  // S, and the previous tile's dQ product: its stage is free
    keep(s);
    keep(ds16);
    if (it > 0) release(it - 1);
    const bool edge = causal ? t0 + 63 > q0 : t0 + 64 > Sk;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = acc_half(e);
      float p = pow2(fmaf(round_bf16(s[e]), scale2, -m2[i])) * inv_l[i];
      if (edge) {
        const int col = t0 + acc_col(e, lane), row = q0 + r_lo + 8 * i;
        if (causal ? col > row : col >= Sk) p = 0.f;
      }
      s[e] = p;
    }
    wg_wait<0>();
    keep(dp);
#pragma unroll
    for (int e = 0; e < 32; e += 2)  // dS in bf16, the A operand of dS K
      ds16[e / 2] = pack_bf16(s[e] * (dp[e] - drow[acc_half(e)]),
                              s[e + 1] * (dp[e + 1] - drow[acc_half(e)]));
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < 2; ++p)
        mma_rs(acc[p], ds16 + 4 * kk, desc(st + (2 * wg + p) * kPanel + kk * 2048), 1);
    wg_commit();
  }
  wg_wait<0>();
#pragma unroll
  for (int p = 0; p < 2; ++p) keep(acc[p]);
  keep(ds16);
  if (it_end > 0) release(it_end - 1);
  for (int it = it_end; it < ntiles; ++it) {  // rows past S: the tiles unread
    mbar_wait(&full[it % kWideBwdStages], (it / kWideBwdStages) & 1);
    release(it);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r_lo + 8 * i;
    if (row >= S) continue;
    bf16* drow_out = dq + (((int64_t)b * S + row) * H + h) * hd;
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int e = 2 * i; e < 32; e += 4) {
        const int d = 64 * (2 * wg + p) + acc_col(e, lane);
        if (d < hd)
          *reinterpret_cast<__nv_bfloat162*>(drow_out + d) =
              __floats2bfloat162_rn(acc[p][e] * scale, acc[p][e + 1] * scale);
      }
  }
}

// Backward, dK and dV, hd > 128. grid (H, B, ceil(Sk / 64)), the longest
// causal key ranges first; kBwdThreads, both warpgroups on the CTA's 64 keys
// (K and V resident). The query tiles at or below the CTA's diagonal stream
// through a ring of kWideBwdStages as in attn_bwd_dkv_tc.
__global__ void __launch_bounds__(kBwdThreads, 1)
attn_bwd_dkv_tc_wide(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const __grid_constant__ CUtensorMap rows_map, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int S, int Sk, int H, int hd, int causal,
                     float scale) {
  constexpr int NP = kWideNP, kStage = 2 * NP * kPanel + 1024;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_full, full[kWideBwdStages];
  __shared__ int freed[kWideBwdStages];
  uint8_t* Ks = align1024(smem_raw);  // [panel]
  uint8_t* Vs = Ks + NP * kPanel;     // [panel]
  uint8_t* ring = Vs + NP * kPanel;   // [stage][q panels, dO panels, m log2(e) 1/l D]

  const int h = blockIdx.x, b = blockIdx.y, k0 = 64 * blockIdx.z;
  const int qstart = causal ? k0 : 0;
  const int ntiles = (S - qstart + 63) / 64;
  const int s64 = (S + 63) / 64 * 64, plane = (b * H + h) * 3 * s64;
  auto load = [&](int it) {  // query tile it into its stage
    const int s = it % kWideBwdStages, r0 = qstart + 64 * it;
    uint8_t* st = ring + s * kStage;
    mbar_expect_tx(&full[s], 2 * NP * kPanel + 3 * 256);
    for (int p = 0; p < NP; ++p) {
      tma_rows(st + p * kPanel, &q_map, &full[s], 64 * p, h, r0, b);
      tma_rows(st + (NP + p) * kPanel, &do_map, &full[s], 64 * p, h, r0, b);
    }
    for (int c = 0; c < 3; ++c)
      tma_stats(st + 2 * NP * kPanel + 256 * c, &rows_map, &full[s], plane + c * s64 + r0);
  };
  if (threadIdx.x == 0) {
    mbar_init(&kv_full, 1);
    for (int s = 0; s < kWideBwdStages; ++s) {
      mbar_init(&full[s], 1);
      freed[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&kv_full, 2 * NP * kPanel);
    for (int p = 0; p < NP; ++p) {
      tma_rows(Ks + p * kPanel, &k_map, &kv_full, 64 * p, h, k0, b);
      tma_rows(Vs + p * kPanel, &v_map, &kv_full, 64 * p, h, k0, b);
    }
    for (int it = 0; it < min(ntiles, kWideBwdStages); ++it) load(it);
  }

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = threadIdx.x % 32;
  const int r_lo = 16 * (t / 32) + lane / 4;  // keys k0 + r_lo, k0 + r_lo + 8
  const int it_begin = k0 >= Sk ? ntiles : 0;
  auto release = [&](int it) {  // this warpgroup is done with tile it
    free_stage(&freed[it % kWideBwdStages], wg, t, [&] {
      if (it + kWideBwdStages < ntiles) load(it + kWideBwdStages);
    });
  };
  const float scale2 = scale * kLog2e;
  const int ksteps = (hd + 15) / 16;
  float acc_k[2][32], acc_v[2][32], s[32], dp[32];  // S^T, dP^T: [key][query row]
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc_k[p][e] = acc_v[p][e] = 0.f;
  uint32_t pk[16], ds16[16];
  mbar_wait(&kv_full, 0);
  for (int it = 0; it < it_begin; ++it) {  // keys past Sk: the tiles unread
    mbar_wait(&full[it % kWideBwdStages], (it / kWideBwdStages) & 1);
    release(it);
  }
  for (int it = it_begin; it < ntiles; ++it) {
    const int r0 = qstart + 64 * it;
    const uint8_t* st = ring + (it % kWideBwdStages) * kStage;
    const float* m2 = reinterpret_cast<const float*>(st + 2 * NP * kPanel);  // m log2(e)
    const float* inv_l = m2 + 64;
    const float* Ds = m2 + 128;
    mbar_wait(&full[it % kWideBwdStages], (it / kWideBwdStages) & 1);
    wg_fence();
    mma_hd_wide(s, Ks, st, ksteps);
    wg_commit();
    mma_hd_wide(dp, Vs, st + NP * kPanel, ksteps);
    wg_commit();
    wg_wait<1>();  // S^T, and the previous tile's dV and dK products: its stage is free
    keep(s);
    keep(pk);
    keep(ds16);
    if (it > it_begin) release(it - 1);
    const bool diag = causal && r0 == k0;
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = acc_col(e + c, lane);
        float p = pow2(fmaf(round_bf16(s[e + c]), scale2, -m2[col])) * inv_l[col];
        if (diag && r_lo + 8 * acc_half(e) > col) p = 0.f;
        s[e + c] = p;
      }
      pk[e / 2] = pack_bf16(s[e], s[e + 1]);  // P^T in bf16, the A operand of dV
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < 2; ++p)
        mma_rs(acc_v[p], pk + 4 * kk, desc(st + (NP + 2 * wg + p) * kPanel + kk * 2048), 1);
    wg_commit();
    wg_wait<1>();  // dP^T (dV's product stays in flight)
    keep(dp);
#pragma unroll
    for (int e = 0; e < 32; e += 2) {  // dS^T in bf16, the A operand of dK
      const int col = acc_col(e, lane);
      ds16[e / 2] = pack_bf16(s[e] * (dp[e] - Ds[col]), s[e + 1] * (dp[e + 1] - Ds[col + 1]));
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < 2; ++p)
        mma_rs(acc_k[p], ds16 + 4 * kk, desc(st + (2 * wg + p) * kPanel + kk * 2048), 1);
    wg_commit();
  }
  wg_wait<0>();
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    keep(acc_k[p]);
    keep(acc_v[p]);
  }
  keep(pk);
  keep(ds16);
  if (ntiles > it_begin) release(ntiles - 1);
  const int ncols = min(64, Sk - k0);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kl = r_lo + 8 * i;
    if (kl >= ncols) continue;
    const int64_t off = (((int64_t)b * Sk + k0 + kl) * H + h) * hd;
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int e = 2 * i; e < 32; e += 4) {
        const int d = 64 * (2 * wg + p) + acc_col(e, lane);
        if (d < hd) {
          *reinterpret_cast<__nv_bfloat162*>(dk + off + d) =
              __floats2bfloat162_rn(acc_k[p][e] * scale, acc_k[p][e + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + off + d) =
              __floats2bfloat162_rn(acc_v[p][e], acc_v[p][e + 1]);
        }
      }
  }
}

// The driver's cuTensorMapEncodeTiled, fetched through the runtime, so the
// library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// (B, L, H, hd) bf16, contiguous: boxes of 64 head dims x 64 rows of one
// head, 128-byte swizzled; TMA fills zeros past hd and past L.
int rows_map(CUtensorMap* map, const void* base, int B, int L, int H, int hd) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)H * hd * 2,
                                 (cuuint64_t)L * H * hd * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1}, step[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
             box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : (int)cudaErrorInvalidValue;
}

// n float32 in a row: boxes of 64, each starting on a 256-byte boundary.
int stats_map(CUtensorMap* map, const void* base, int64_t n) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[1] = {(cuuint64_t)n}, strides[1] = {4};
  const cuuint32_t box[1] = {64}, step[1] = {1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(base), dims, strides,
             box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : (int)cudaErrorInvalidValue;
}

// The consumers' setmaxnreg.inc takes what the producer's .dec gives back:
// 384 threads must start with at least 168 registers each, or it would wait
// for registers that never come. Refuse the launch rather than hang.
template <typename K>
int check_ws_regs(K kernel) {
  cudaFuncAttributes attr;
  if (int err = (int)cudaFuncGetAttributes(&attr, kernel)) return err;
  return attr.numRegs * 384 >= 128 * 24 + kConsumers * 240 ? 0 : (int)cudaErrorInvalidConfiguration;
}

// Runs setup() (host calls whose answer never changes: the register check,
// the shared-memory limit) once per device; bit d of `ready` records device d.
template <typename F>
int once_per_device(std::atomic<uint64_t>& ready, int dev, F setup) {
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (ready.load(std::memory_order_acquire) & bit) return 0;
  if (int err = setup()) return err;
  ready.fetch_or(bit, std::memory_order_release);
  return 0;
}

template <int NP>
constexpr int fwd_tc_smem() { return 1024 + (2 + 2 * kStages) * NP * kPanel; }

template <int NP>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* out, void* m, void* l, int B,
                  int S, int Sk, int H, int hd, int ck, int causal, float scale, int dev,
                  cudaStream_t st) {
  CUtensorMap qm, km, vm;
  if (int err = rows_map(&qm, q, B, S, H, hd)) return err;
  if (int err = rows_map(&km, k, B, Sk, H, hd)) return err;
  if (int err = rows_map(&vm, v, B, Sk, H, hd)) return err;
  const int bytes = fwd_tc_smem<NP>();
  static std::atomic<uint64_t> ready{0};
  if (int err = once_per_device(ready, dev, [&] {
        if (int err = check_ws_regs(attn_fwd_tc<NP>)) return err;
        return set_smem(attn_fwd_tc<NP>, bytes);
      }))
    return err;
  attn_fwd_tc<NP><<<dim3((S + 127) / 128, H, B), 384, bytes, st>>>(
      qm, km, vm, static_cast<bf16*>(out), static_cast<float*>(m), static_cast<float*>(l), S, Sk,
      H, hd, ck, causal, scale);
  return (int)cudaGetLastError();
}

template <int NP>
int launch_bwd_tc(const void* q, const void* k, const void* v, const void* out, const void* dout,
                  const void* m, const void* l, void* dq, void* dk, void* dv, void* dbuf, int B,
                  int S, int Sk, int H, int hd, int causal, float scale, int dev,
                  cudaStream_t st) {
  CUtensorMap qm, km, vm, dom, rm;
  if (int err = rows_map(&qm, q, B, S, H, hd)) return err;
  if (int err = rows_map(&km, k, B, Sk, H, hd)) return err;
  if (int err = rows_map(&vm, v, B, Sk, H, hd)) return err;
  if (int err = rows_map(&dom, dout, B, S, H, hd)) return err;
  if (int err = stats_map(&rm, dbuf, (int64_t)B * H * 3 * ((S + 63) / 64 * 64))) return err;
  static std::atomic<uint64_t> ready{0};
  if (int err = once_per_device(ready, dev, [&] {
        if (int err = set_smem(attn_bwd_dq_tc<NP>, dq_tc_smem<NP>())) return err;
        return set_smem(attn_bwd_dkv_tc<NP>, dkv_tc_smem<NP>());
      }))
    return err;
  attn_bwd_dq_tc<NP><<<dim3(H, B, (S + 127) / 128), kBwdThreads, dq_tc_smem<NP>(), st>>>(
      qm, km, vm, dom, static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<const float*>(m), static_cast<const float*>(l), static_cast<bf16*>(dq),
      static_cast<float*>(dbuf), S, Sk, H, hd, causal, scale);
  if (int err = (int)cudaGetLastError()) return err;
  attn_bwd_dkv_tc<NP><<<dim3(H, B, (Sk + 127) / 128), kBwdThreads, dkv_tc_smem<NP>(), st>>>(
      qm, km, vm, dom, rm, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, Sk, H, hd,
      causal, scale);
  return (int)cudaGetLastError();
}

int launch_fwd_tc_wide(const void* q, const void* k, const void* v, void* out, void* m, void* l,
                       int B, int S, int Sk, int H, int hd, int ck, int causal, float scale,
                       int dev, cudaStream_t st) {
  CUtensorMap qm, km, vm;
  if (int err = rows_map(&qm, q, B, S, H, hd)) return err;
  if (int err = rows_map(&km, k, B, Sk, H, hd)) return err;
  if (int err = rows_map(&vm, v, B, Sk, H, hd)) return err;
  static std::atomic<uint64_t> ready{0};
  if (int err = once_per_device(ready, dev,
                                [&] { return set_smem(attn_fwd_tc_wide, fwd_tc_wide_smem()); }))
    return err;
  attn_fwd_tc_wide<<<dim3((S + 63) / 64, H, B), kBwdThreads, fwd_tc_wide_smem(), st>>>(
      qm, km, vm, static_cast<bf16*>(out), static_cast<float*>(m), static_cast<float*>(l), S, Sk,
      H, hd, ck, causal, scale);
  return (int)cudaGetLastError();
}

int launch_bwd_tc_wide(const void* q, const void* k, const void* v, const void* out,
                       const void* dout, const void* m, const void* l, void* dq, void* dk,
                       void* dv, void* dbuf, int B, int S, int Sk, int H, int hd, int causal,
                       float scale, int dev, cudaStream_t st) {
  CUtensorMap qm, km, vm, dom, rm;
  if (int err = rows_map(&qm, q, B, S, H, hd)) return err;
  if (int err = rows_map(&km, k, B, Sk, H, hd)) return err;
  if (int err = rows_map(&vm, v, B, Sk, H, hd)) return err;
  if (int err = rows_map(&dom, dout, B, S, H, hd)) return err;
  if (int err = stats_map(&rm, dbuf, (int64_t)B * H * 3 * ((S + 63) / 64 * 64))) return err;
  static std::atomic<uint64_t> ready{0};
  if (int err = once_per_device(ready, dev, [&] {
        if (int err = set_smem(attn_bwd_dq_tc_wide, dq_tc_wide_smem())) return err;
        return set_smem(attn_bwd_dkv_tc_wide, dkv_tc_wide_smem());
      }))
    return err;
  attn_bwd_dq_tc_wide<<<dim3(H, B, (S + 63) / 64), kBwdThreads, dq_tc_wide_smem(), st>>>(
      qm, km, vm, dom, static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<const float*>(m), static_cast<const float*>(l), static_cast<bf16*>(dq),
      static_cast<float*>(dbuf), S, Sk, H, hd, causal, scale);
  if (int err = (int)cudaGetLastError()) return err;
  attn_bwd_dkv_tc_wide<<<dim3(H, B, (Sk + 63) / 64), kBwdThreads, dkv_tc_wide_smem(), st>>>(
      qm, km, vm, dom, rm, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, Sk, H, hd, causal,
      scale);
  return (int)cudaGetLastError();
}

// One bf16 kernel's resources: out[0] registers a thread (at launch, before
// setmaxnreg), out[1] CTAs resident on an SM, out[2] shared memory bytes a
// CTA (dynamic and static), out[3] threads a CTA, out[4] local memory bytes
// a thread (register spills).
template <typename K>
int kernel_info(K kernel, int threads, int smem, int* out) {
  cudaFuncAttributes attr;
  if (int err = (int)cudaFuncGetAttributes(&attr, kernel)) return err;
  if (int err = set_smem(kernel, smem)) return err;
  int ctas = 0;
  if (int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads, smem))
    return err;
  out[0] = attr.numRegs;
  out[1] = ctas;
  out[2] = smem + (int)attr.sharedSizeBytes;
  out[3] = threads;
  out[4] = (int)attr.localSizeBytes;
  return 0;
}

// Makes the device that holds p current in the calling thread for the
// guard's lifetime, then gives the thread its former device back. (An
// autograd backward runs on a thread of its own, where the driver's
// cuTensorMapEncodeTiled finds no current context otherwise.)
struct DeviceOf {
  int dev = -1, prev = -1, err = 0;
  explicit DeviceOf(const void* p) {
    cudaPointerAttributes attr;
    if ((err = (int)cudaGetDevice(&prev))) return;
    if ((err = (int)cudaPointerGetAttributes(&attr, p))) return;
    dev = attr.device;
    err = (int)cudaSetDevice(dev);
  }
  ~DeviceOf() {
    if (dev >= 0 && prev >= 0 && prev != dev) cudaSetDevice(prev);
  }
};

// What TMA takes: 16-byte aligned bases; rows of hd bf16 a multiple of 16 bytes.
bool tma_ok(int hd, std::initializer_list<const void*> ptrs) {
  if (hd % 8) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

bool bad_shape(int B, int S, int Sk, int H, int hd, int causal) {
  return B <= 0 || S <= 0 || Sk <= 0 || H <= 0 || hd <= 0 || hd > kWideHd ||
         (causal && S != Sk);
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernels), 1 = bfloat16 (the tensor-core
// kernels; hd a multiple of 8, 16-byte aligned tensors) (kernels/attention.py
// DTYPE_CODES). q, out (B, S, H, hd); k, v (B, Sk, H, hd), contiguous; m, l
// (B, H, S) float32.
extern "C" int chunked_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                     void* out, void* m, void* l, int B, int S, int Sk, int H,
                                     int hd, int ck, int causal, float scale, void* stream) {
  if (bad_shape(B, S, Sk, H, hd, causal) || ck <= 0 || Sk % ck != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = hd > 64, wider = hd > 128;
  switch (dtype) {
    case 0:
      if (wider) return launch_fwd<4>(q, k, v, out, m, l, B, S, Sk, H, hd, ck, causal, scale, st);
      return wide ? launch_fwd<2>(q, k, v, out, m, l, B, S, Sk, H, hd, ck, causal, scale, st)
                  : launch_fwd<1>(q, k, v, out, m, l, B, S, Sk, H, hd, ck, causal, scale, st);
    case 1: {
      if (!tma_ok(hd, {q, k, v})) return (int)cudaErrorInvalidValue;
      DeviceOf on(q);
      if (on.err) return on.err;
      if (wider)
        return launch_fwd_tc_wide(q, k, v, out, m, l, B, S, Sk, H, hd, ck, causal, scale, on.dev,
                                  st);
      return wide ? launch_fwd_tc<2>(q, k, v, out, m, l, B, S, Sk, H, hd, ck, causal, scale,
                                     on.dev, st)
                  : launch_fwd_tc<1>(q, k, v, out, m, l, B, S, Sk, H, hd, ck, causal, scale,
                                     on.dev, st);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The resources of bf16 kernel `which` (kernels/attention.py TC_KERNELS:
// 0, 1 attn_fwd_tc<1, 2>; 2, 3 attn_bwd_dq_tc<1, 2>; 4, 5 attn_bwd_dkv_tc<1,
// 2>; 6, 7, 8 attn_fwd_tc_wide, attn_bwd_dq_tc_wide, attn_bwd_dkv_tc_wide) on
// the current device, into out[5] as kernel_info above.
extern "C" int chunked_attention_kernel_info(int which, int* out) {
  switch (which) {
    case 0: return kernel_info(attn_fwd_tc<1>, 384, fwd_tc_smem<1>(), out);
    case 1: return kernel_info(attn_fwd_tc<2>, 384, fwd_tc_smem<2>(), out);
    case 2: return kernel_info(attn_bwd_dq_tc<1>, kBwdThreads, dq_tc_smem<1>(), out);
    case 3: return kernel_info(attn_bwd_dq_tc<2>, kBwdThreads, dq_tc_smem<2>(), out);
    case 4: return kernel_info(attn_bwd_dkv_tc<1>, kBwdThreads, dkv_tc_smem<1>(), out);
    case 5: return kernel_info(attn_bwd_dkv_tc<2>, kBwdThreads, dkv_tc_smem<2>(), out);
    case 6: return kernel_info(attn_fwd_tc_wide, kBwdThreads, fwd_tc_wide_smem(), out);
    case 7: return kernel_info(attn_bwd_dq_tc_wide, kBwdThreads, dq_tc_wide_smem(), out);
    case 8: return kernel_info(attn_bwd_dkv_tc_wide, kBwdThreads, dkv_tc_wide_smem(), out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dq like q, dk and dv like k; dbuf (B H 3 S64) float32 scratch, S64 = S
// rounded up to 64: float32 keeps D (B, H, S) in it, bfloat16 the rows'
// m log2(e), 1/l and D (the dQ kernel's `rows`).
extern "C" int chunked_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                     const void* out, const void* dout, const void* m,
                                     const void* l, void* dq, void* dk, void* dv, void* dbuf,
                                     int B, int S, int Sk, int H, int hd, int causal,
                                     float scale, void* stream) {
  if (bad_shape(B, S, Sk, H, hd, causal)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = hd > 64, wider = hd > 128;
  switch (dtype) {
    case 0:
      if (wider)
        return launch_bwd_wide(q, k, v, out, dout, m, l, dq, dk, dv, dbuf, B, S, Sk, H, hd,
                               causal, scale, st);
      return wide ? launch_bwd<2>(q, k, v, out, dout, m, l, dq, dk, dv, dbuf, B, S, Sk, H, hd,
                                  causal, scale, st)
                  : launch_bwd<1>(q, k, v, out, dout, m, l, dq, dk, dv, dbuf, B, S, Sk, H, hd,
                                  causal, scale, st);
    case 1: {
      if (!tma_ok(hd, {q, k, v, out, dout, m, l, dbuf})) return (int)cudaErrorInvalidValue;
      DeviceOf on(q);
      if (on.err) return on.err;
      if (wider)
        return launch_bwd_tc_wide(q, k, v, out, dout, m, l, dq, dk, dv, dbuf, B, S, Sk, H, hd,
                                  causal, scale, on.dev, st);
      return wide ? launch_bwd_tc<2>(q, k, v, out, dout, m, l, dq, dk, dv, dbuf, B, S, Sk, H, hd,
                                     causal, scale, on.dev, st)
                  : launch_bwd_tc<1>(q, k, v, out, dout, m, l, dq, dk, dv, dbuf, B, S, Sk, H, hd,
                                     causal, scale, on.dev, st);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
