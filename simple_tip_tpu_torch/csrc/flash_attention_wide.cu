// Flash attention at head_dim > 128 for Hopper (sm_90a): the wide-head
// launch variants of kernels B4 (forward), B5 (dq) and B6 (dk, dv).
//
// Same functions as flash_attention_fwd.cu and flash_attention_bwd.cu (which
// call these entry points for dh > 128): the Pallas TPU kernels
// simple_tip_tpu/ops/flash_attention.py `_flash_kernel`,
// `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel`, which take any
// head_dim. Layouts as there: q, dO [B,Tq,H,dh], k, v [B,Tkv,H,dh], lse and
// D [B,H,Tq]; any dh >= 1, Tq >= 1, Tkv >= 1.
//
// What the design does: the narrow kernels hold a row's whole head dim in
// registers, which at dh > 128 no longer fits 255 of them. Here a block owns
// 64 own rows (4 warps of 16) and one <= 128-wide slice of the output
// columns (o; dq; dk and dv), the slice an extra grid dimension. The score
// products (q k^T and dO v^T; B6 k q^T and v dO^T) contract over the whole
// dh in chunks of 32 columns read from shared memory, each chunk's k-steps
// added to the scores in order; then the slice's columns of v (B4), k (B5),
// dO and q (B6) come through shared memory for the second product. So every
// slice recomputes the scores, and the lse (B4) is written by slice 0 only.
// Products are mma.sync.m16n8k8 in 3xTF32 (tf32_mma.cuh; each 8-deep k-step
// summed from zero), B operands split into TF32 parts once per tile in
// shared memory. Loads are plain cp.async with a wait: this path is rare
// (no case study reaches it) and has to be right, not fast. No atomics:
// every sum runs in one order, the same on every run.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps, a 16-row m-tile each
constexpr int kRows = 64;      // own rows a block
constexpr int kDc = 32;        // head-dim columns a score chunk
constexpr int kSc = kDc + 4;   // floats a chunk row
constexpr int kSw = 128;       // output columns a slice
constexpr int kSs = kSw + 4;   // floats a slice row
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Rows [0, n) x columns [col0, col0 + width) of a [B, T, H, dh] tile (src at
// its first row, `row` floats between rows) into shared rows of `stride`
// floats: rows at or past `valid` and columns at or past dh zero-filled.
__device__ __forceinline__ void load_tile(float* dst, int stride, const float* src, size_t row,
                                          int n, int valid, int col0, int width, int dh,
                                          bool vec, int tid) {
  if (vec) {
    const int p = width / 4;
    for (int l = tid; l < n * p; l += kThreads) {
      const int r = l / p, c = (l % p) * 4;
      const bool ok = r < valid && col0 + c < dh;
      cp_async16(dst + r * stride + c, ok ? src + r * row + col0 + c : src, ok);
    }
  } else {
    for (int l = tid; l < n * width; l += kThreads) {
      const int r = l / width, c = l % width;
      const bool ok = r < valid && col0 + c < dh;
      cp_async4(dst + r * stride + c, ok ? src + r * row + col0 + c : src, ok);
    }
  }
}

__device__ __forceinline__ void land() {
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// Splits n rows of `width` floats (stride `stride`) into TF32 parts: high
// parts in place, low parts `lo` floats further.
__device__ __forceinline__ void split_tile(float* t, int lo, int n, int stride, int width,
                                           int tid) {
  for (int e = tid; e < n * width; e += kThreads) {
    const int at = (e / width) * stride + e % width;
    uint32_t hi, low;
    split_tf32(t[at], hi, low);
    t[at] = __uint_as_float(hi);
    t[at + lo] = __uint_as_float(low);
  }
  __syncthreads();
}

// The accumulator layout x (16 x 8) as the A operand of acc[dn] += x.B, B's
// rows 8j + 2t and 8j + 2t + 1 of a slice at bh (high parts; low parts `lo`
// floats further) as k-indices t and t + 4.
__device__ __forceinline__ void slice_product(float (*acc)[4], const float* x, const float* bh,
                                              int lo, int g, int t4) {
  uint32_t a_hi[4], a_lo[4];
  split_tf32(x[0], a_hi[0], a_lo[0]);
  split_tf32(x[2], a_hi[1], a_lo[1]);
  split_tf32(x[1], a_hi[2], a_lo[2]);
  split_tf32(x[3], a_hi[3], a_lo[3]);
  const float* bp = bh + 2 * t4 * kSs + g;
#pragma unroll
  for (int dn = 0; dn < kSw / 8; ++dn)
    mma_3xtf32(acc[dn], a_hi, a_lo, bp + 8 * dn, bp + lo + 8 * dn, kSs);
}

// A warp's 16 x 128 sums times `mult` into columns col0 + .. (< dh) of rows
// [0, rows) at `out` (its first row; `row` floats between rows).
__device__ __forceinline__ void store_slice(float (*acc)[4], float mult, float* out, size_t row,
                                            int rows, int col0, int dh, int g, int t4) {
#pragma unroll
  for (int dn = 0; dn < kSw / 8; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e / 2), c = col0 + 8 * dn + 2 * t4 + (e & 1);
      if (r < rows && c < dh) out[r * row + c] = acc[dn][e] * mult;
    }
  }
}

// B4: out (slice blockIdx.y) and, from slice 0, lse.
__global__ void __launch_bounds__(kThreads)
flash_wide_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ lse, int blocks, int t_q, int t_kv, int heads, int dh,
                      float scale, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* const qc = smem;                    // [64][kSc]
  float* const kc = qc + kRows * kSc;        // [64][kSc], then its low parts
  float* const vs = kc + 2 * kRows * kSc;    // [64][kSs], then its low parts
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.x / blocks, b = bh / heads, h = bh % heads;
  const int q0 = (blockIdx.x % blocks) * kRows, col0 = blockIdx.y * kSw;
  const size_t row = static_cast<size_t>(heads) * dh;
  const float* qg = q + ((static_cast<size_t>(b) * t_q + q0) * heads + h) * dh;
  const float* kg = k + (static_cast<size_t>(b) * t_kv * heads + h) * dh;
  const float* vg = v + (static_cast<size_t>(b) * t_kv * heads + h) * dh;
  const float scale2 = scale * kLog2e;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, o[kSw / 8][4];
#pragma unroll
  for (int dn = 0; dn < kSw / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;

  for (int k0 = 0; k0 < t_kv; k0 += kRows) {
    const int keys = min(kRows, t_kv - k0), nt = (keys + 7) / 8;
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int d0 = 0; d0 < dh; d0 += kDc) {
      load_tile(qc, kSc, qg, row, kRows, t_q - q0, d0, kDc, dh, vec, tid);
      load_tile(kc, kSc, kg + k0 * row, row, nt * 8, keys, d0, kDc, dh, vec, tid);
      land();
      split_tile(kc, kRows * kSc, nt * 8, kSc, kDc, tid);
#pragma unroll
      for (int kk = 0; kk < kDc / 8; ++kk) {
        uint32_t a_hi[4], a_lo[4];
        a_frag<kDc>(qc + warp * 16 * kSc, kk, g, t4, a_hi, a_lo);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < nt) {
            const float* bp = kc + (8 * j + g) * kSc + 8 * kk + t4;
            mma_3xtf32(s[j], a_hi, a_lo, bp, bp + kRows * kSc, 4);
          }
        }
      }
      __syncthreads();  // the chunk is consumed
    }
    // Scale, mask keys past Tkv, fold the block into (m, l, o) in base 2.
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = j < nt && k0 + 8 * j + 2 * t4 + (e & 1) < t_kv;
        s[j][e] = valid ? s[j][e] * scale2 : kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float m0 = fmaxf(m[0], mx0), m1 = fmaxf(m[1], mx1);
    const float alpha0 = exp2f(m[0] - m0), alpha1 = exp2f(m[1] - m1);
    m[0] = m0;
    m[1] = m1;
    l[0] *= alpha0;
    l[1] *= alpha1;
#pragma unroll
    for (int dn = 0; dn < kSw / 8; ++dn) {
      o[dn][0] *= alpha0;
      o[dn][1] *= alpha0;
      o[dn][2] *= alpha1;
      o[dn][3] *= alpha1;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = exp2f(s[j][0] - m0);
      s[j][1] = exp2f(s[j][1] - m0);
      s[j][2] = exp2f(s[j][2] - m1);
      s[j][3] = exp2f(s[j][3] - m1);
      l[0] += s[j][0] + s[j][1];
      l[1] += s[j][2] + s[j][3];
    }
    // o += p v over the slice's columns of this block's keys.
    load_tile(vs, kSs, vg + k0 * row, row, nt * 8, keys, col0, kSw, dh, vec, tid);
    land();
    split_tile(vs, kRows * kSs, nt * 8, kSs, kSw, tid);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < nt) slice_product(o, s[j], vs + 8 * j * kSs, kRows * kSs, g, t4);
    __syncthreads();  // v is consumed
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l[0] += __shfl_xor_sync(0xffffffffu, l[0], off);
    l[1] += __shfl_xor_sync(0xffffffffu, l[1], off);
  }
  const int r0 = q0 + warp * 16, rows = min(16, t_q - r0);
  if (rows <= 0) return;
#pragma unroll
  for (int dn = 0; dn < kSw / 8; ++dn) {
    o[dn][0] /= l[0];
    o[dn][1] /= l[0];
    o[dn][2] /= l[1];
    o[dn][3] /= l[1];
  }
  store_slice(o, 1.f, out + ((static_cast<size_t>(b) * t_q + r0) * heads + h) * dh, row, rows,
              col0, dh, g, t4);
  if (blockIdx.y == 0 && t4 == 0) {
    float* lg = lse + static_cast<size_t>(bh) * t_q + r0;
    constexpr float kLn2 = 0.6931471805599453f;
    if (g < rows) lg[g] = m[0] * kLn2 + logf(l[0]);
    if (g + 8 < rows) lg[g + 8] = m[1] * kLn2 + logf(l[1]);
  }
}

// B5: dq (slice blockIdx.y). Own rows are queries; keys are streamed.
__global__ void __launch_bounds__(kThreads)
flash_wide_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dvec,
                     float* __restrict__ dq, int blocks, int t_q, int t_kv, int heads, int dh,
                     float scale, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* const qc = smem;                    // [64][kSc]
  float* const doc = qc + kRows * kSc;       // [64][kSc]
  float* const kc = doc + kRows * kSc;       // [64][kSc], then its low parts
  float* const vc = kc + 2 * kRows * kSc;    // [64][kSc], then its low parts
  float* const ks = vc + 2 * kRows * kSc;    // [64][kSs], then its low parts
  float* const rowv = ks + 2 * kRows * kSs;  // lse and D of the own rows
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.x / blocks, b = bh / heads, h = bh % heads;
  const int q0 = (blockIdx.x % blocks) * kRows, col0 = blockIdx.y * kSw;
  const size_t row = static_cast<size_t>(heads) * dh;
  const size_t own = ((static_cast<size_t>(b) * t_q + q0) * heads + h) * dh;
  const float* kg = k + (static_cast<size_t>(b) * t_kv * heads + h) * dh;
  const float* vg = v + (static_cast<size_t>(b) * t_kv * heads + h) * dh;
  const float scale2 = scale * kLog2e;

  for (int r = tid; r < kRows; r += kThreads) {
    const bool ok = q0 + r < t_q;
    // rows past Tq get lse = inf, so p = 0
    rowv[r] = ok ? lse[static_cast<size_t>(bh) * t_q + q0 + r] * kLog2e : INFINITY;
    rowv[kRows + r] = ok ? dvec[static_cast<size_t>(bh) * t_q + q0 + r] : 0.f;
  }
  __syncthreads();
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = rowv[warp * 16 + g + 8 * r];
    dd[r] = rowv[kRows + warp * 16 + g + 8 * r];
  }

  float acc[kSw / 8][4];
#pragma unroll
  for (int dn = 0; dn < kSw / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  for (int k0 = 0; k0 < t_kv; k0 += kRows) {
    const int keys = min(kRows, t_kv - k0), nt = (keys + 7) / 8;
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    for (int d0 = 0; d0 < dh; d0 += kDc) {
      load_tile(qc, kSc, q + own, row, kRows, t_q - q0, d0, kDc, dh, vec, tid);
      load_tile(doc, kSc, dout + own, row, kRows, t_q - q0, d0, kDc, dh, vec, tid);
      load_tile(kc, kSc, kg + k0 * row, row, nt * 8, keys, d0, kDc, dh, vec, tid);
      load_tile(vc, kSc, vg + k0 * row, row, nt * 8, keys, d0, kDc, dh, vec, tid);
      land();
      split_tile(kc, kRows * kSc, nt * 8, kSc, kDc, tid);
      split_tile(vc, kRows * kSc, nt * 8, kSc, kDc, tid);
#pragma unroll
      for (int kk = 0; kk < kDc / 8; ++kk) {
        uint32_t a_hi[4], a_lo[4];
        a_frag<kDc>(qc + warp * 16 * kSc, kk, g, t4, a_hi, a_lo);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < nt) {
            const float* bp = kc + (8 * j + g) * kSc + 8 * kk + t4;
            mma_3xtf32(sc[j], a_hi, a_lo, bp, bp + kRows * kSc, 4);
          }
        }
        a_frag<kDc>(doc + warp * 16 * kSc, kk, g, t4, a_hi, a_lo);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < nt) {
            const float* bp = vc + (8 * j + g) * kSc + 8 * kk + t4;
            mma_3xtf32(dp[j], a_hi, a_lo, bp, bp + kRows * kSc, 4);
          }
        }
      }
      __syncthreads();
    }
    // ds = p (dP - D) in place of s; keys past Tkv get p = 0.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const bool valid = j < nt && k0 + 8 * j + 2 * t4 + (e & 1) < t_kv;
        const float p = valid ? exp2f(fmaf(sc[j][e], scale2, -lse2[r])) : 0.f;
        sc[j][e] = p * (dp[j][e] - dd[r]);
      }
    }
    load_tile(ks, kSs, kg + k0 * row, row, nt * 8, keys, col0, kSw, dh, vec, tid);
    land();
    split_tile(ks, kRows * kSs, nt * 8, kSs, kSw, tid);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < nt) slice_product(acc, sc[j], ks + 8 * j * kSs, kRows * kSs, g, t4);
    __syncthreads();
  }
  const int r0 = q0 + warp * 16, rows = min(16, t_q - r0);
  if (rows > 0)
    store_slice(acc, scale, dq + ((static_cast<size_t>(b) * t_q + r0) * heads + h) * dh, row,
                rows, col0, dh, g, t4);
}

constexpr int kStreamQ = 32;  // queries a step of B6

// B6: dk and dv (slice blockIdx.y). Own rows are keys; queries are streamed.
__global__ void __launch_bounds__(kThreads)
flash_wide_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dvec,
                      float* __restrict__ dk, float* __restrict__ dv, int blocks, int t_q,
                      int t_kv, int heads, int dh, float scale, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* const kc = smem;                      // [64][kSc]
  float* const vc = kc + kRows * kSc;          // [64][kSc]
  float* const qc = vc + kRows * kSc;          // [32][kSc], then its low parts
  float* const doc = qc + 2 * kStreamQ * kSc;  // [32][kSc], then its low parts
  float* const sl = doc + 2 * kStreamQ * kSc;  // [32][kSs] of dO, then of q; low parts after
  float* const colv = sl + 2 * kStreamQ * kSs; // lse (base 2) and D of the streamed queries
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.x / blocks, b = bh / heads, h = bh % heads;
  const int r0 = (blockIdx.x % blocks) * kRows, col0 = blockIdx.y * kSw;
  const size_t row = static_cast<size_t>(heads) * dh;
  const size_t own = ((static_cast<size_t>(b) * t_kv + r0) * heads + h) * dh;
  const size_t qbase = (static_cast<size_t>(b) * t_q * heads + h) * dh;
  const float scale2 = scale * kLog2e;
  constexpr int kNt = kStreamQ / 8;

  float acc_k[kSw / 8][4], acc_v[kSw / 8][4];
#pragma unroll
  for (int dn = 0; dn < kSw / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[dn][e] = acc_v[dn][e] = 0.f;

  for (int q0 = 0; q0 < t_q; q0 += kStreamQ) {
    const int nq = min(kStreamQ, t_q - q0);
    for (int r = tid; r < kStreamQ; r += kThreads) {
      const bool ok = r < nq;
      colv[r] = ok ? lse[static_cast<size_t>(bh) * t_q + q0 + r] * kLog2e : 0.f;
      colv[kStreamQ + r] = ok ? dvec[static_cast<size_t>(bh) * t_q + q0 + r] : 0.f;
    }
    float st[kNt][4], dpt[kNt][4];  // s^T and dP^T: rows keys, columns queries
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    for (int d0 = 0; d0 < dh; d0 += kDc) {
      load_tile(kc, kSc, k + own, row, kRows, t_kv - r0, d0, kDc, dh, vec, tid);
      load_tile(vc, kSc, v + own, row, kRows, t_kv - r0, d0, kDc, dh, vec, tid);
      load_tile(qc, kSc, q + qbase + q0 * row, row, kStreamQ, nq, d0, kDc, dh, vec, tid);
      load_tile(doc, kSc, dout + qbase + q0 * row, row, kStreamQ, nq, d0, kDc, dh, vec, tid);
      land();
      split_tile(qc, kStreamQ * kSc, kStreamQ, kSc, kDc, tid);
      split_tile(doc, kStreamQ * kSc, kStreamQ, kSc, kDc, tid);
#pragma unroll
      for (int kk = 0; kk < kDc / 8; ++kk) {
        uint32_t a_hi[4], a_lo[4];
        a_frag<kDc>(kc + warp * 16 * kSc, kk, g, t4, a_hi, a_lo);
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
          const float* bp = qc + (8 * j + g) * kSc + 8 * kk + t4;
          mma_3xtf32(st[j], a_hi, a_lo, bp, bp + kStreamQ * kSc, 4);
        }
        a_frag<kDc>(vc + warp * 16 * kSc, kk, g, t4, a_hi, a_lo);
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
          const float* bp = doc + (8 * j + g) * kSc + 8 * kk + t4;
          mma_3xtf32(dpt[j], a_hi, a_lo, bp, bp + kStreamQ * kSc, 4);
        }
      }
      __syncthreads();
    }
    // p^T in place of s^T, ds^T in place of dP^T; queries past Tq get p = 0.
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t4 + (e & 1);
        const float p = c < nq ? exp2f(fmaf(st[j][e], scale2, -colv[c])) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - colv[kStreamQ + c]);
      }
    }
    load_tile(sl, kSs, dout + qbase + q0 * row, row, kStreamQ, nq, col0, kSw, dh, vec, tid);
    land();
    split_tile(sl, kStreamQ * kSs, kStreamQ, kSs, kSw, tid);
#pragma unroll
    for (int j = 0; j < kNt; ++j)
      slice_product(acc_v, st[j], sl + 8 * j * kSs, kStreamQ * kSs, g, t4);
    __syncthreads();
    load_tile(sl, kSs, q + qbase + q0 * row, row, kStreamQ, nq, col0, kSw, dh, vec, tid);
    land();
    split_tile(sl, kStreamQ * kSs, kStreamQ, kSs, kSw, tid);
#pragma unroll
    for (int j = 0; j < kNt; ++j)
      slice_product(acc_k, dpt[j], sl + 8 * j * kSs, kStreamQ * kSs, g, t4);
    __syncthreads();
  }
  const int k0 = r0 + warp * 16, rows = min(16, t_kv - k0);
  if (rows <= 0) return;
  const size_t at = ((static_cast<size_t>(b) * t_kv + k0) * heads + h) * dh;
  store_slice(acc_k, scale, dk + at, row, rows, col0, dh, g, t4);
  store_slice(acc_v, 1.f, dv + at, row, rows, col0, dh, g, t4);
}

constexpr int kFwdSmem = 4 * (kRows * kSc * 3 + 2 * kRows * kSs);
constexpr int kDqSmem = 4 * (kRows * kSc * 6 + 2 * kRows * kSs + 2 * kRows);
constexpr int kDkvSmem =
    4 * (2 * kRows * kSc + 4 * kStreamQ * kSc + 2 * kStreamQ * kSs + 2 * kStreamQ);
static_assert(kDqSmem <= 232448 && kFwdSmem <= 232448 && kDkvSmem <= 232448, "shared memory");

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

extern "C" int tip_flash_wide_fwd(const float* q, const float* k, const float* v, float* out,
                                  float* lse, int batch, int t_q, int t_kv, int heads, int dh,
                                  float scale, void* stream) {
  const void* ptrs[] = {q, k, v, out};
  const int blocks = (t_q + kRows - 1) / kRows;
  const dim3 grid(batch * heads * blocks, (dh + kSw - 1) / kSw);
  cudaError_t err = opt_in(flash_wide_fwd_kernel, kFwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_wide_fwd_kernel<<<grid, kThreads, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, lse, blocks, t_q, t_kv, heads, dh, scale, vec_rows(dh, ptrs, 4));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tip_flash_wide_bwd_dq(const float* q, const float* k, const float* v,
                                     const float* dout, const float* lse, const float* dvec,
                                     float* dq, int batch, int t_q, int t_kv, int heads, int dh,
                                     float scale, void* stream) {
  const void* ptrs[] = {q, k, v, dout, dq};
  const int blocks = (t_q + kRows - 1) / kRows;
  const dim3 grid(batch * heads * blocks, (dh + kSw - 1) / kSw);
  cudaError_t err = opt_in(flash_wide_dq_kernel, kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_wide_dq_kernel<<<grid, kThreads, kDqSmem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, dout, lse, dvec, dq, blocks, t_q, t_kv, heads, dh, scale, vec_rows(dh, ptrs, 5));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tip_flash_wide_bwd_dkv(const float* q, const float* k, const float* v,
                                      const float* dout, const float* lse, const float* dvec,
                                      float* dk, float* dv, int batch, int t_q, int t_kv,
                                      int heads, int dh, float scale, void* stream) {
  const void* ptrs[] = {q, k, v, dout, dk, dv};
  const int blocks = (t_kv + kRows - 1) / kRows;
  const dim3 grid(batch * heads * blocks, (dh + kSw - 1) / kSw);
  cudaError_t err = opt_in(flash_wide_dkv_kernel, kDkvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_wide_dkv_kernel<<<grid, kThreads, kDkvSmem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, dout, lse, dvec, dk, dv, blocks, t_q, t_kv, heads, dh, scale,
      vec_rows(dh, ptrs, 6));
  return static_cast<int>(cudaGetLastError());
}
