// Flash attention forward in the bf16 scoring mode, for Hopper (sm_90a):
// bfloat16 q, k, v on the tensor cores, float32 softmax state.
//
// Replaces the Pallas TPU kernel simple_tip_tpu/ops/flash_attention.py
// `_flash_kernel` fed bfloat16 operands (compute_dtype=bfloat16, or bf16
// q/k/v inherited): q, k, v [B, T, H, dh] bfloat16 in, out [B, Tq, H, dh]
// bfloat16 and lse [B, H, Tq] float32.
//
// The TPU kernel's steps, kept here:
// - s = q.k^T from bfloat16 operands summed in float32, then times the
//   scale; keys at or past Tkv masked to -1e30;
// - the keys are folded in the TPU kernel's tiles of `block_kv` keys
//   (ops.flash_attention.jax_kv_block: Tkv padded to 128 lanes, tiles of at
//   most 1024): per tile the running max m_new = max(m, max_j s), alpha =
//   exp(m - m_new), p = exp(s - m_new), l = l alpha + sum_j p, all float32;
// - p rounded to bfloat16 (to nearest even) for p.v, which sums in float32;
// - out = acc / l rounded to bfloat16, lse = m + log(l).
// Where p is rounded depends on m_new, so each tile's max is taken over the
// whole tile before any of its p: a tile is walked twice in sub-tiles of 64
// keys, the first pass for the max, the second for p, l and p.v.
//
// The design, simple on purpose: a block of 4 warps owns 64 queries of one
// (batch, head); each warp 16 query rows, their q fragments in registers.
// Sub-tiles of 64 keys (and values) are staged in shared memory, rows of
// dh + 8 bf16 so that the 8 rows of an ldmatrix phase fall in different
// 16-byte bank groups. Scores come from mma.sync.m16n8k16 with k^T's
// fragments by ldmatrix; p's accumulator tiles become the A operand of p.v
// in registers (bf16_mma.cuh) and v's fragments come by ldmatrix.trans.
// head_dim a multiple of 16 up to 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBq = 16 * kWarps;  // queries a block
constexpr int kBk = 64;           // keys a sub-tile
constexpr float kNegInf = -1e30f;

// Rows [r0, r0 + 64) of one (batch, head) of a [B, T, H, DH] bf16 array
// into `dst` (DH + 8 bf16 a row), zeros at and past T.
template <int DH>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int b,
                                          int h, int r0, int T, int H, int tid) {
  constexpr int kChunks = DH / 8;  // 16-byte pieces a row
  for (int i = tid; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < T)
      v = *reinterpret_cast<const uint4*>(
          src + ((static_cast<size_t>(b) * T + r0 + r) * H + h) * DH + c * 8);
    *reinterpret_cast<uint4*>(dst + r * (DH + 8) + c * 8) = v;
  }
}

// This warp's scores s[8][4] = q.k^T * scale for the 64 keys in ks_tile
// (first key index key0), keys at or past t_kv masked to -1e30.
template <int DH>
__device__ __forceinline__ void scores(float (&s)[8][4], const uint32_t (&qa)[DH / 16][4],
                                       const __nv_bfloat16* ks_tile, int key0, int t_kv,
                                       float scale, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  // lane L addresses key (L % 8) + 8 (L / 16) of a pair of n-tiles, dh
  // columns 8 ((L / 8) % 2): r0, r1 are the B registers of the pair's first
  // n-tile, r2, r3 of its second
  const int krow = (lane % 8) + 8 * (lane / 16), kcol = 8 * ((lane / 8) % 2);
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t b[4];
      ldmatrix_x4(b, ks_tile + (16 * jp + krow) * (DH + 8) + 16 * kk + kcol);
      mma_bf16(s[2 * jp], qa[kk], b[0], b[1]);
      mma_bf16(s[2 * jp + 1], qa[kk], b[2], b[3]);
    }
  }
  const int t4 = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = key0 + 8 * j + 2 * t4 + (e % 2);
      s[j][e] = col < t_kv ? s[j][e] * scale : kNegInf;
    }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int H, int t_q, int t_kv, int block_kv,
                      float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + kBq * (DH + 8);
  __nv_bfloat16* vs = ks + kBk * (DH + 8);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBq;

  load_rows<DH>(qs, q, b, h, q0, t_q, H, tid);
  __syncthreads();
  uint32_t qa[DH / 16][4];
  {
    const int row = 16 * warp + (lane % 8) + 8 * ((lane / 8) % 2), col = 8 * (lane / 16);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) ldmatrix_x4(qa[kk], qs + row * (DH + 8) + 16 * kk + col);
  }

  float m[2] = {kNegInf, kNegInf};  // rows g and g + 8
  float l[2] = {0.f, 0.f};          // this lane's share of the rows' sums
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int j0 = 0; j0 < t_kv; j0 += block_kv) {
    const int j1 = min(j0 + block_kv, t_kv);  // keys past t_kv have p = 0 exactly
    // pass 1: the tile's max
    float mt[2] = {kNegInf, kNegInf};
    for (int s0 = j0; s0 < j1; s0 += kBk) {
      __syncthreads();
      load_rows<DH>(ks, k, b, h, s0, t_kv, H, tid);
      __syncthreads();
      float s[8][4];
      scores<DH>(s, qa, ks, s0, t_kv, scale, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mt[0] = fmaxf(mt[0], fmaxf(s[j][0], s[j][1]));
        mt[1] = fmaxf(mt[1], fmaxf(s[j][2], s[j][3]));
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // pass 2: p, l and p.v
    for (int s0 = j0; s0 < j1; s0 += kBk) {
      __syncthreads();
      load_rows<DH>(ks, k, b, h, s0, t_kv, H, tid);
      load_rows<DH>(vs, v, b, h, s0, t_kv, H, tid);
      __syncthreads();
      float s[8][4];
      scores<DH>(s, qa, ks, s0, t_kv, scale, lane);
      uint32_t pa[4][4];  // p as the A operand of 4 k-steps of 16 keys
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = expf(s[j][0] - m[0]), p1 = expf(s[j][1] - m[0]);
        const float p2 = expf(s[j][2] - m[1]), p3 = expf(s[j][3] - m[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        pa[j / 2][2 * (j % 2)] = pack_bf16(p0, p1);
        pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p2, p3);
      }
      // lane L addresses value row (L % 8) + 8 ((L / 8) % 2) of a 16-key
      // step, dh columns 8 (L / 16) of a pair of n-tiles
      const int vrow = (lane % 8) + 8 * ((lane / 8) % 2), vcol = 8 * (lane / 16);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int np = 0; np < DH / 16; ++np) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vs + (16 * kk + vrow) * (DH + 8) + 16 * np + vcol);
          mma_bf16(o[2 * np], pa[kk], bv[0], bv[1]);
          mma_bf16(o[2 * np + 1], pa[kk], bv[2], bv[3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + 16 * warp + g + 8 * r;
    if (qi >= t_q) continue;
    __nv_bfloat16* orow = out + ((static_cast<size_t>(b) * t_q + qi) * H + h) * DH;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t4) =
          pack_bf16(o[n][2 * r] / l[r], o[n][2 * r + 1] / l[r]);
    if (t4 == 0) lse[static_cast<size_t>(bh) * t_q + qi] = m[r] + logf(l[r]);
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int batch,
           int t_q, int t_kv, int heads, int block_kv, float scale, cudaStream_t stream) {
  constexpr int kSmemBytes = (kBq + 2 * kBk) * (DH + 8) * 2;  // 52 KB at dh 128
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_q + kBq - 1) / kBq, batch * heads);
  flash_fwd_bf16_kernel<DH><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, heads, t_q,
      t_kv, block_kv, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tip_flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                            void* out, float* lse, int batch, int t_q,
                                            int t_kv, int heads, int dh, int block_kv,
                                            float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch<16>(q, k, v, out, lse, batch, t_q, t_kv, heads, block_kv, scale, s);
    case 32: return launch<32>(q, k, v, out, lse, batch, t_q, t_kv, heads, block_kv, scale, s);
    case 48: return launch<48>(q, k, v, out, lse, batch, t_q, t_kv, heads, block_kv, scale, s);
    case 64: return launch<64>(q, k, v, out, lse, batch, t_q, t_kv, heads, block_kv, scale, s);
    case 80: return launch<80>(q, k, v, out, lse, batch, t_q, t_kv, heads, block_kv, scale, s);
    case 96: return launch<96>(q, k, v, out, lse, batch, t_q, t_kv, heads, block_kv, scale, s);
    case 112: return launch<112>(q, k, v, out, lse, batch, t_q, t_kv, heads, block_kv, scale, s);
    case 128: return launch<128>(q, k, v, out, lse, batch, t_q, t_kv, heads, block_kv, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
