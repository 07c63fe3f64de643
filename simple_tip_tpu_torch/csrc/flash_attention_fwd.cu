// Flash-attention forward for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel simple_tip_tpu/ops/flash_attention.py
// `_flash_kernel` (launched by `_flash_fwd_call`): exact attention
// softmax(q k^T * scale) v with a streaming softmax over key tiles, writing
// the output and the log-sum-exp of every query row. q [B,Tq,H,dh], k and v
// [B,Tkv,H,dh], out [B,Tq,H,dh], lse [B,H,Tq]; dh <= 128, any Tq, Tkv >= 1.
//
// What bounds it on this card: at the IMDB shapes (T=100, H=2, dh=32) a
// sequence needs 2 heads x 2 products x 2*100*100*32 = 2.56 MFLOP against
// 102 KB of q, k, v and out, so float32 operations bound it, narrowly
// (0.96 ms against 0.76 ms of bytes for 25,000 sequences).
//
// What the design does: the TPU kernel carried (max, normaliser,
// accumulator) in VMEM scratch across a sequential grid axis over key
// tiles. Blocks run in parallel here, so the key loop runs inside the block:
// one block per (sequence*head, tile of 64 queries), 8 warps of 8 query rows
// each. Every key tile (64 rows) is staged in shared memory, K with a
// padded row stride so that lanes reading different keys hit different
// banks; each lane scores two keys for all 8 rows of its warp (the q rows
// are warp-wide broadcasts from shared memory), the running max and
// normaliser are warp-uniform registers, p goes through a small per-warp
// buffer, and each lane accumulates up to 4 of the dh output columns for
// the 8 rows. The TPU's 128-lane padding of T is not needed: keys past Tkv
// are masked to -1e30 as there, and query rows past Tq are not stored. The
// layout [B,T,H,dh] is read in place (no fold copies).
//
// This is the simple, exact version; mma.sync/wgmma products are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 8;                    // query rows per warp
constexpr int kBlockQ = kWarps * kRows;     // 64
constexpr int kBlockKV = 64;                // key rows per tile (two per lane)
constexpr int kMaxDh = 128;                 // four output columns per lane
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int t_q, int t_kv, int heads, int dh,
                 float scale) {
  extern __shared__ float smem[];
  const int ks = dh + 1;  // padded K row stride
  float* qs = smem;                       // [kBlockQ][dh]
  float* kt = qs + kBlockQ * dh;          // [kBlockKV][dh + 1]
  float* vt = kt + kBlockKV * ks;         // [kBlockKV][dh]
  float* ps = vt + kBlockKV * dh;         // [kWarps][kRows][kBlockKV]

  const int g = blockIdx.x;  // b * heads + h
  const int b = g / heads, h = g % heads;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t row = static_cast<size_t>(heads) * dh;  // stride between positions
  const float* qg = q + (static_cast<size_t>(b) * t_q * heads + h) * dh;
  const float* kg = k + (static_cast<size_t>(b) * t_kv * heads + h) * dh;
  const float* vg = v + (static_cast<size_t>(b) * t_kv * heads + h) * dh;

  for (int i = tid; i < kBlockQ * dh; i += kThreads) {
    const int r = i / dh, d = i % dh;
    qs[i] = q0 + r < t_q ? qg[(q0 + r) * row + d] : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  }
  const float* qw = qs + warp * kRows * dh;
  float* pw = ps + warp * kRows * kBlockKV;

  for (int j0 = 0; j0 < t_kv; j0 += kBlockKV) {
    __syncthreads();  // the previous tile is consumed (and q is staged)
    for (int i = tid; i < kBlockKV * dh; i += kThreads) {
      const int r = i / dh, d = i % dh;
      const bool ok = j0 + r < t_kv;
      const size_t off = (j0 + r) * row + d;
      kt[r * ks + d] = ok ? kg[off] : 0.f;
      vt[r * dh + d] = ok ? vg[off] : 0.f;
    }
    __syncthreads();

    // Scores of this lane's two keys for the warp's 8 rows.
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
    const float* k0 = kt + lane * ks;
    const float* k1 = kt + (lane + 32) * ks;
#pragma unroll 4
    for (int d = 0; d < dh; ++d) {
      const float a = k0[d], c = k1[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qv = qw[r * dh + d];
        s[r][0] = fmaf(qv, a, s[r][0]);
        s[r][1] = fmaf(qv, c, s[r][1]);
      }
    }
    const bool valid0 = j0 + lane < t_kv, valid1 = j0 + lane + 32 < t_kv;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float s0 = valid0 ? s[r][0] * scale : kNegInf;
      const float s1 = valid1 ? s[r][1] * scale : kNegInf;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
      pw[r * kBlockKV + lane] = p0;
      pw[r * kBlockKV + lane + 32] = p1;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();

    // acc[r][c] += sum_j p[r][j] * v[j][lane + 32c]
    const int n = min(kBlockKV, t_kv - j0);
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = lane + 32 * c;
        if (d < dh) {
          const float vv = vt[j * dh + d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r][c] = fmaf(pw[r * kBlockKV + j], vv, acc[r][c]);
        }
      }
    }
    __syncwarp();  // p is read before the next tile overwrites it
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = q0 + warp * kRows + r;
    if (t < t_q) {
      float* o = out + ((static_cast<size_t>(b) * t_q + t) * heads + h) * dh;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = lane + 32 * c;
        if (d < dh) o[d] = acc[r][c] / l[r];
      }
      if (lane == 0) lse[static_cast<size_t>(g) * t_q + t] = m[r] + logf(l[r]);
    }
  }
}

}  // namespace

extern "C" int tip_flash_attention_fwd(const float* q, const float* k, const float* v,
                                       float* out, float* lse, int batch, int t_q,
                                       int t_kv, int heads, int dh, float scale,
                                       void* stream) {
  if (dh < 1 || dh > kMaxDh || t_kv < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem_bytes =
      static_cast<int>(sizeof(float)) *
      (kBlockQ * dh + kBlockKV * (dh + 1) + kBlockKV * dh + kWarps * kRows * kBlockKV);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * heads, (t_q + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, lse, t_q, t_kv, heads, dh, scale);
  return static_cast<int>(cudaGetLastError());
}
