// Flash-attention backward for Hopper (sm_90a), float32: kernels B5 (dq)
// and B6 (dk, dv).
//
// Replace the Pallas TPU kernels simple_tip_tpu/ops/flash_attention.py
// `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel` (launched by
// `_flash_bwd_call`): the standard flash backward over the forward's
// log-sum-exp. For every (query i, key j) pair both recompute
//   p[i][j]  = exp(scale * q_i.k_j - lse_i)   (0 for keys at or past Tkv)
//   ds[i][j] = p[i][j] * (dO_i.v_j - D_i),    D_i = rowsum(dO_i * out_i)
// and then
//   B5: dq_i = scale * sum_j ds[i][j] k_j
//   B6: dv_j = sum_i p[i][j] dO_i,  dk_j = scale * sum_i ds[i][j] q_i.
// q and dO [B,Tq,H,dh], k and v [B,Tkv,H,dh], lse and D [B,H,Tq]; dq
// [B,Tq,H,dh], dk and dv [B,Tkv,H,dh]. dh <= 128, any Tq >= 1, Tkv >= 1.
//
// What bounds them on this card: per sequence-head B5 does three products
// of 2*Tq*Tkv*dh FLOPs (scores, dO.v^T, ds.k) and B6 four (scores, dO.v^T,
// p^T.dO, ds^T.q), against reading q, k, v and dO once and writing one or
// two gradients; at the IMDB shape (T=100, dh=32) that is 6.4 and 8.5
// FLOPs a byte, so float32 operations bound both (67 TFLOP/s against
// 3.35 TB/s).
//
// What the design does: the TPU kernels carried their accumulators in VMEM
// scratch across a sequential grid axis. Blocks run in parallel here, so
// each kernel walks the other side's tiles inside the block and keeps its
// accumulators in registers, and neither needs atomics:
// - B5: one block per (sequence*head, tile of 64 queries), 8 warps of 8
//   query rows. q, dO, lse and D of the tile are staged once; every tile
//   of 64 keys is staged in shared memory (K and V with a padded row stride,
//   so lanes reading different keys hit different banks). Each lane scores
//   two keys for the warp's 8 rows (q and dO rows are warp-wide broadcasts),
//   writes ds to a per-warp buffer, and accumulates up to 4 of the dh
//   columns of dq for the 8 rows.
// - B6: one block per (sequence*head, tile of 64 keys), 8 warps of 8 keys.
//   K and V of the tile are staged once; every tile of 64 queries (q and dO
//   with a padded stride, lse, D) is staged in turn. Each lane takes two
//   queries for the warp's 8 keys, writes p and ds to per-warp buffers, and
//   accumulates up to 4 columns of dk and of dv for the 8 keys.
// The layout [B,T,H,dh] is read in place (no fold copies). Query rows past
// Tq get p = 0 explicitly (their lse is not defined), so they add nothing
// to dk or dv; keys past Tkv get p = 0 as the forward's -1e30 mask gives.
//
// This is the simple, exact version; mma.sync/wgmma products are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 8;                 // rows (B5: queries, B6: keys) per warp
constexpr int kTile = kWarps * kRows;    // 64 rows owned by a block
constexpr int kStream = 64;              // rows per streamed tile (two per lane)
constexpr int kMaxDh = 128;              // four columns per lane
constexpr int kThreads = kWarps * 32;

// B5: dq for one tile of queries, walking every tile of keys.
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dvec,
                    float* __restrict__ dq, int t_q, int t_kv, int heads, int dh,
                    float scale) {
  extern __shared__ float smem[];
  const int ks = dh + 1;                    // padded K / V row stride
  float* qs = smem;                         // [kTile][dh]
  float* dos = qs + kTile * dh;             // [kTile][dh]
  float* kt = dos + kTile * dh;             // [kStream][dh + 1]
  float* vt = kt + kStream * ks;            // [kStream][dh + 1]
  float* dsb = vt + kStream * ks;           // [kWarps][kRows][kStream]
  float* lse_s = dsb + kWarps * kRows * kStream;  // [kTile]
  float* d_s = lse_s + kTile;               // [kTile]

  const int g = blockIdx.x;  // b * heads + h
  const int b = g / heads, h = g % heads;
  const int q0 = blockIdx.y * kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t row = static_cast<size_t>(heads) * dh;  // stride between positions
  const size_t q_base = (static_cast<size_t>(b) * t_q * heads + h) * dh;
  const size_t kv_base = (static_cast<size_t>(b) * t_kv * heads + h) * dh;

  for (int i = tid; i < kTile * dh; i += kThreads) {
    const int r = i / dh, d = i % dh;
    const bool ok = q0 + r < t_q;
    const size_t off = q_base + (q0 + r) * row + d;
    qs[i] = ok ? q[off] : 0.f;
    dos[i] = ok ? dout[off] : 0.f;
  }
  for (int r = tid; r < kTile; r += kThreads) {
    const bool ok = q0 + r < t_q;
    lse_s[r] = ok ? lse[static_cast<size_t>(g) * t_q + q0 + r] : 0.f;
    d_s[r] = ok ? dvec[static_cast<size_t>(g) * t_q + q0 + r] : 0.f;
  }

  float acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  const float* qw = qs + warp * kRows * dh;
  const float* dow = dos + warp * kRows * dh;
  float* dsw = dsb + warp * kRows * kStream;

  for (int j0 = 0; j0 < t_kv; j0 += kStream) {
    __syncthreads();  // the previous tile is consumed (and the q tile is staged)
    for (int i = tid; i < kStream * dh; i += kThreads) {
      const int r = i / dh, d = i % dh;
      const bool ok = j0 + r < t_kv;
      const size_t off = kv_base + (j0 + r) * row + d;
      kt[r * ks + d] = ok ? k[off] : 0.f;
      vt[r * ks + d] = ok ? v[off] : 0.f;
    }
    __syncthreads();

    // Scores and dO.v^T of this lane's two keys for the warp's 8 rows.
    float s[kRows][2], dp[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
    const float* k0 = kt + lane * ks;
    const float* k1 = kt + (lane + 32) * ks;
    const float* v0 = vt + lane * ks;
    const float* v1 = vt + (lane + 32) * ks;
#pragma unroll 2
    for (int d = 0; d < dh; ++d) {
      const float ka = k0[d], kb = k1[d], va = v0[d], vb = v1[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qv = qw[r * dh + d], ov = dow[r * dh + d];
        s[r][0] = fmaf(qv, ka, s[r][0]);
        s[r][1] = fmaf(qv, kb, s[r][1]);
        dp[r][0] = fmaf(ov, va, dp[r][0]);
        dp[r][1] = fmaf(ov, vb, dp[r][1]);
      }
    }
    const bool valid0 = j0 + lane < t_kv, valid1 = j0 + lane + 32 < t_kv;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float l = lse_s[warp * kRows + r], dr = d_s[warp * kRows + r];
      const float p0 = valid0 ? expf(s[r][0] * scale - l) : 0.f;
      const float p1 = valid1 ? expf(s[r][1] * scale - l) : 0.f;
      dsw[r * kStream + lane] = p0 * (dp[r][0] - dr);
      dsw[r * kStream + lane + 32] = p1 * (dp[r][1] - dr);
    }
    __syncwarp();

    // acc[r][c] += sum_j ds[r][j] * k[j][lane + 32c]
    const int n = min(kStream, t_kv - j0);
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = lane + 32 * c;
        if (d < dh) {
          const float kv = kt[j * ks + d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r][c] = fmaf(dsw[r * kStream + j], kv, acc[r][c]);
        }
      }
    }
    __syncwarp();  // ds is read before the next tile overwrites it
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = q0 + warp * kRows + r;
    if (t < t_q) {
      float* o = dq + q_base + t * row;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = lane + 32 * c;
        if (d < dh) o[d] = scale * acc[r][c];
      }
    }
  }
}

// B6: dk and dv for one tile of keys, walking every tile of queries.
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dvec,
                     float* __restrict__ dk, float* __restrict__ dv, int t_q, int t_kv,
                     int heads, int dh, float scale) {
  extern __shared__ float smem[];
  const int qs_stride = dh + 1;            // padded q / dO row stride
  float* ks = smem;                        // [kTile][dh]
  float* vs = ks + kTile * dh;             // [kTile][dh]
  float* qt = vs + kTile * dh;             // [kStream][dh + 1]
  float* dots = qt + kStream * qs_stride;   // [kStream][dh + 1]
  float* pb = dots + kStream * qs_stride;   // [kWarps][kRows][kStream]
  float* dsb = pb + kWarps * kRows * kStream;  // [kWarps][kRows][kStream]
  float* lse_s = dsb + kWarps * kRows * kStream;  // [kStream]
  float* d_s = lse_s + kStream;            // [kStream]

  const int g = blockIdx.x;  // b * heads + h
  const int b = g / heads, h = g % heads;
  const int j0 = blockIdx.y * kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t row = static_cast<size_t>(heads) * dh;
  const size_t q_base = (static_cast<size_t>(b) * t_q * heads + h) * dh;
  const size_t kv_base = (static_cast<size_t>(b) * t_kv * heads + h) * dh;

  for (int i = tid; i < kTile * dh; i += kThreads) {
    const int r = i / dh, d = i % dh;
    const bool ok = j0 + r < t_kv;
    const size_t off = kv_base + (j0 + r) * row + d;
    ks[i] = ok ? k[off] : 0.f;
    vs[i] = ok ? v[off] : 0.f;
  }

  float acc_k[kRows][4], acc_v[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;
  const float* kw = ks + warp * kRows * dh;
  const float* vw = vs + warp * kRows * dh;
  float* pw = pb + warp * kRows * kStream;
  float* dsw = dsb + warp * kRows * kStream;

  for (int i0 = 0; i0 < t_q; i0 += kStream) {
    __syncthreads();  // the previous tile is consumed (and the key tile is staged)
    for (int i = tid; i < kStream * dh; i += kThreads) {
      const int r = i / dh, d = i % dh;
      const bool ok = i0 + r < t_q;
      const size_t off = q_base + (i0 + r) * row + d;
      qt[r * qs_stride + d] = ok ? q[off] : 0.f;
      dots[r * qs_stride + d] = ok ? dout[off] : 0.f;
    }
    for (int r = tid; r < kStream; r += kThreads) {
      const bool ok = i0 + r < t_q;
      lse_s[r] = ok ? lse[static_cast<size_t>(g) * t_q + i0 + r] : 0.f;
      d_s[r] = ok ? dvec[static_cast<size_t>(g) * t_q + i0 + r] : 0.f;
    }
    __syncthreads();

    // Scores and dO.v^T of this lane's two queries for the warp's 8 keys.
    float s[kRows][2], dp[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
    const float* q0p = qt + lane * qs_stride;
    const float* q1p = qt + (lane + 32) * qs_stride;
    const float* o0p = dots + lane * qs_stride;
    const float* o1p = dots + (lane + 32) * qs_stride;
#pragma unroll 2
    for (int d = 0; d < dh; ++d) {
      const float qa = q0p[d], qb = q1p[d], oa = o0p[d], ob = o1p[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float kv = kw[r * dh + d], vv = vw[r * dh + d];
        s[r][0] = fmaf(kv, qa, s[r][0]);
        s[r][1] = fmaf(kv, qb, s[r][1]);
        dp[r][0] = fmaf(vv, oa, dp[r][0]);
        dp[r][1] = fmaf(vv, ob, dp[r][1]);
      }
    }
    const bool valid0 = i0 + lane < t_q, valid1 = i0 + lane + 32 < t_q;
    const float l0 = lse_s[lane], l1 = lse_s[lane + 32];
    const float d0 = d_s[lane], d1 = d_s[lane + 32];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float p0 = valid0 ? expf(s[r][0] * scale - l0) : 0.f;
      const float p1 = valid1 ? expf(s[r][1] * scale - l1) : 0.f;
      pw[r * kStream + lane] = p0;
      pw[r * kStream + lane + 32] = p1;
      dsw[r * kStream + lane] = p0 * (dp[r][0] - d0);
      dsw[r * kStream + lane + 32] = p1 * (dp[r][1] - d1);
    }
    __syncwarp();

    // acc_v[r][c] += sum_i p[r][i] * dO[i][col]; acc_k[r][c] += sum_i ds[r][i] * q[i][col]
    const int n = min(kStream, t_q - i0);
#pragma unroll 2
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = lane + 32 * c;
        if (d < dh) {
          const float ov = dots[i * qs_stride + d], qv = qt[i * qs_stride + d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            acc_v[r][c] = fmaf(pw[r * kStream + i], ov, acc_v[r][c]);
            acc_k[r][c] = fmaf(dsw[r * kStream + i], qv, acc_k[r][c]);
          }
        }
      }
    }
    __syncwarp();  // p and ds are read before the next tile overwrites them
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = j0 + warp * kRows + r;
    if (t < t_kv) {
      float* gk = dk + kv_base + t * row;
      float* gv = dv + kv_base + t * row;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = lane + 32 * c;
        if (d < dh) {
          gk[d] = scale * acc_k[r][c];
          gv[d] = acc_v[r][c];
        }
      }
    }
  }
}

int dq_smem_bytes(int dh) {
  return static_cast<int>(sizeof(float)) *
         (2 * kTile * dh + 2 * kStream * (dh + 1) + kWarps * kRows * kStream + 2 * kTile);
}

int dkv_smem_bytes(int dh) {
  return static_cast<int>(sizeof(float)) *
         (2 * kTile * dh + 2 * kStream * (dh + 1) + 2 * kWarps * kRows * kStream +
          2 * kStream);
}

}  // namespace

extern "C" int tip_flash_attention_bwd_dq(const float* q, const float* k, const float* v,
                                          const float* dout, const float* lse,
                                          const float* dvec, float* dq, int batch,
                                          int t_q, int t_kv, int heads, int dh,
                                          float scale, void* stream) {
  if (dh < 1 || dh > kMaxDh || t_kv < 1 || t_q < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = dq_smem_bytes(dh);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * heads, (t_q + kTile - 1) / kTile);
  flash_bwd_dq_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, dout, lse, dvec, dq, t_q, t_kv, heads, dh, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tip_flash_attention_bwd_dkv(const float* q, const float* k, const float* v,
                                           const float* dout, const float* lse,
                                           const float* dvec, float* dk, float* dv,
                                           int batch, int t_q, int t_kv, int heads,
                                           int dh, float scale, void* stream) {
  if (dh < 1 || dh > kMaxDh || t_kv < 1 || t_q < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = dkv_smem_bytes(dh);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * heads, (t_kv + kTile - 1) / kTile);
  flash_bwd_dkv_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, dout, lse, dvec, dk, dv, t_q, t_kv, heads, dh, scale);
  return static_cast<int>(cudaGetLastError());
}
