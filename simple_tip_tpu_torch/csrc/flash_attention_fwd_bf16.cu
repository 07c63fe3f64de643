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
// whole tile before any of its p.
//
// Two routes, picked by the wrapper (ops.flash_attention.bf16_route) from
// (Tq, Tkv, head_dim):
//
// The one-tile route (flash_fwd_bf16_tile_kernel): Tq and Tkv <= 128 (the
// TPU kernel folds every key in one tile) at head_dim 16, 32 or 64 (IMDB's
// 32 among them). The bound is bytes (IMDB's [8192, 100, 2, 32] moves
// 419 MB, 0.127 ms at 3.35 TB/s, against
// 0.7 GFLOP), but what the card spends its time on is issue: per score an
// exp (expf, kept for the TPU kernel's numbers), a scale, a max, a sum and
// a rounding. The design:
// - A persistent block (4 warps; as many blocks an SM as fit, registers
//   capped at 128 so that 4 do) walks items of one (batch, head): that
//   head's rows of q, k and v, each read once. A two-stage ring of cp.async copies loads the next item while this one
//   computes.
// - A warp's task is 16 queries. Scores for every key (NP = ceil(Tkv / 16)
//   steps of 16 keys, a template parameter, so that no loop has a runtime
//   bound) stay in registers: the row max over them, then p, l and
//   p.v with no second pass and no rescale. p's accumulator tiles become
//   the A operand of p.v in registers.
// - Rows in shared memory are swizzled (16-byte chunks XOR'd within their
//   128-byte line, at<DH>), so the 8 rows of an ldmatrix phase hit 8
//   different bank groups with no padding; all offsets are compile-time but
//   the row.
// - The output goes through shared memory (over the task's own q rows) and
//   out in 16-byte stores.
//
// The two-pass route (flash_fwd_bf16_kernel): the other shapes (a one-tile
// route at other head dims waits for a path that runs them and a
// measurement that it is faster), head_dim a multiple of 16 up to 128. A
// block of 4 warps owns 64 queries of one (batch, head), each warp 16 query rows
// with their q fragments in registers. Sub-tiles of 64 keys (and values)
// are staged in shared memory, rows of dh + 8 bf16 so that the 8 rows of
// an ldmatrix phase fall in different 16-byte bank groups; each TPU tile is
// walked twice, the first pass for the max, the second for p, l and p.v.
//
// Both: scores from mma.sync.m16n8k16 with k^T's fragments by ldmatrix,
// v's fragments by ldmatrix.trans (bf16_mma.cuh); the shared-memory
// attribute set once a device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

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
  static std::atomic<unsigned long long> attribute_set{0};
  cudaError_t err = max_dynamic_smem_once(flash_fwd_bf16_kernel<DH>, kSmemBytes, attribute_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_q + kBq - 1) / kBq, batch * heads);
  flash_fwd_bf16_kernel<DH><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, heads, t_q,
      t_kv, block_kv, scale);
  return static_cast<int>(cudaGetLastError());
}

// -- the one-tile route -------------------------------------------------------------

// Tq and Tkv at most (the TPU kernel folds Tkv <= 128 in one tile) and the
// head dims of the route (ops.flash_attention.TILE_KEYS, TILE_HEAD_DIMS)
constexpr int kTileKeys = 128;
constexpr int kTileMaxDh = 64;
// bytes of a ring stage at most: 128 rows of q, k and v at head_dim 64
constexpr int kStageMax = 3 * kTileKeys * kTileMaxDh * 2;
constexpr int kTileWarps = 4;
constexpr int kTileThreads = 32 * kTileWarps;
constexpr int kTileMinBlocks = 4;  // blocks an SM the registers must allow: 128 a thread

// Where an item's rows live in a stage: regions q, k, v of [rows padded to
// 16][dh] bf16, each padded to 128 bytes.
struct TileLayout {
  int t_q, t_kv, heads;
  int k_off, v_off, stage_bytes;
};

// Byte offset of (row, byte column) in a region of rows of DH bf16. A row's
// 16-byte chunks are XOR'd within their 128-byte line: by row % 8 where a
// row is one line (dh 64), by the line's index where 2 or 4 rows share it
// (dh 32, 16). Either way the 8 rows of an ldmatrix phase land in 8
// different bank groups, and rows 16 apart get the same XOR.
template <int DH>
__device__ __forceinline__ uint32_t at(int row, int col_bytes) {
  constexpr int kShift = DH == 32 ? 1 : DH == 16 ? 2 : 0;
  constexpr int kMask = DH == 64 ? 7 : 3;
  return static_cast<uint32_t>(row * DH * 2 + col_bytes) ^
         (static_cast<uint32_t>((row >> kShift) & kMask) << 4);
}

// Rows [0, rows) of head h of batch b of a [B, rows, H, DH] bf16 array into
// a region by cp.async, one 16-byte column a thread (the block covers
// whole rows).
template <int DH>
__device__ __forceinline__ void copy_rows(unsigned char* region, const __nv_bfloat16* src, int b,
                                          int h, int rows, int heads, int tid) {
  constexpr int kChunks = DH / 8;
  const int c = tid % kChunks;
  for (int r = tid / kChunks; r < rows; r += kTileThreads / kChunks)
    async_copy16(region + at<DH>(r, 16 * c),
                 src + (static_cast<size_t>(b * rows + r) * heads + h) * DH + 8 * c, true);
}

template <int DH>
__device__ __forceinline__ void load_item(unsigned char* stage, const __nv_bfloat16* q,
                                          const __nv_bfloat16* k, const __nv_bfloat16* v,
                                          int item, const TileLayout& L, int tid) {
  const int b = item / L.heads, h = item % L.heads;
  copy_rows<DH>(stage, q, b, h, L.t_q, L.heads, tid);
  copy_rows<DH>(stage + L.k_off, k, b, h, L.t_kv, L.heads, tid);
  copy_rows<DH>(stage + L.v_off, v, b, h, L.t_kv, L.heads, tid);
}

// One task of the one-tile route, 16 queries (tile mt) of one head: NP =
// ceil(Tkv / 16) 16-key steps cover every key, so every loop has a fixed
// trip count. q, k, v
// are this item's regions; the output goes over the task's own q rows.
template <int DH, int NP>
__device__ __forceinline__ void tile_task(unsigned char* qs, const unsigned char* ks,
                                          const unsigned char* vs, float* lse_row, int mt,
                                          int t_q, int t_kv, float scale, int lane) {
  constexpr uint32_t kStep = 16 * DH * 2;  // 16 rows: adds past the XOR
  const int g = lane / 4, t4 = lane % 4;
  uint32_t qa[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    ldmatrix_x4(qa[kk], qs + mt * kStep +
                            at<DH>((lane % 8) + 8 * ((lane / 8) % 2), 32 * kk + 16 * (lane / 16)));
  // s = q.k^T over every key: lane L addresses key (L % 8) + 8 (L / 16) of a
  // pair of n-tiles, dh columns 8 ((L / 8) % 2)
  float s[2 * NP][4];
#pragma unroll
  for (int jp = 0; jp < NP; ++jp) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[2 * jp][e] = s[2 * jp + 1][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t bk[4];
      ldmatrix_x4(bk, ks + jp * kStep +
                          at<DH>((lane % 8) + 8 * (lane / 16), 32 * kk + 16 * ((lane / 8) % 2)));
      mma_bf16(s[2 * jp], qa[kk], bk[0], bk[1]);
      mma_bf16(s[2 * jp + 1], qa[kk], bk[2], bk[3]);
    }
  }
  // times the scale, keys at or past t_kv masked to -1e30 (only the last
  // step can hold them); the max from -1e30 (the
  // TPU kernel's initial m) in 4 chains
  float m4[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) m4[r][c] = kNegInf;
#pragma unroll
  for (int j = 0; j < 2 * NP; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] *= scale;
      if (j >= 2 * NP - 2 && 8 * j + 2 * t4 + (e % 2) >= t_kv)
        s[j][e] = kNegInf;
      m4[e / 2][(2 * j + e) % 4] = fmaxf(m4[e / 2][(2 * j + e) % 4], s[j][e]);
    }
  }
  float m[2];  // rows g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(fmaxf(m4[r][0], m4[r][1]), fmaxf(m4[r][2], m4[r][3]));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }
  // p = exp(s - m) in float32 for l (4 chains a row), rounded to bf16 as
  // p.v's A operand; masked keys give p = 0 exactly
  float l4[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  uint32_t pa[NP][4];
#pragma unroll
  for (int j = 0; j < 2 * NP; ++j) {
    const float p0 = expf(s[j][0] - m[0]), p1 = expf(s[j][1] - m[0]);
    const float p2 = expf(s[j][2] - m[1]), p3 = expf(s[j][3] - m[1]);
    l4[0][j % 4] += p0 + p1;
    l4[1][j % 4] += p2 + p3;
    pa[j / 2][2 * (j % 2)] = pack_bf16(p0, p1);
    pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p2, p3);
  }
  // o = p.v: lane L addresses value row (L % 8) + 8 ((L / 8) % 2) of a
  // 16-key step, dh columns 8 (L / 16) of a pair of n-tiles
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NP; ++kk) {
#pragma unroll
    for (int np = 0; np < DH / 16; ++np) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, vs + kk * kStep + at<DH>((lane % 8) + 8 * ((lane / 8) % 2),
                                                     32 * np + 16 * (lane / 16)));
      mma_bf16(o[2 * np], pa[kk], bv[0], bv[1]);
      mma_bf16(o[2 * np + 1], pa[kk], bv[2], bv[3]);
    }
  }
  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = (l4[r][0] + l4[r][1]) + (l4[r][2] + l4[r][3]);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // out = o / l over this task's own q rows (their fragments are in
  // registers); lse straight to global memory
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * mt + g + 8 * r;
    if (row >= t_q) continue;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<uint32_t*>(qs + mt * kStep + at<DH>(g + 8 * r, 2 * (8 * n + 2 * t4))) =
          pack_bf16(o[n][2 * r] / l[r], o[n][2 * r + 1] / l[r]);
    if (t4 == 0) lse_row[row] = m[r] + logf(l[r]);
  }
}

// The one-tile route's kernel: a block walks its items (blockIdx.x + j
// gridDim.x) with all its threads, item j in stage j % 2 while item j + 1's
// copies land in the other; its warps take the item's tasks (16 queries
// each) in turn.
template <int DH, int NP>
__global__ void __launch_bounds__(kTileThreads, kTileMinBlocks)
flash_fwd_bf16_tile_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, TileLayout L, int n_items, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kChunks = DH / 8;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ntq = (L.t_q + 15) / 16;

  // Pad rows stay zero for good: copies write only live rows (v's pad rows
  // meet p = 0, and 0 * v must be 0).
  for (int i = tid; i < 2 * L.stage_bytes / 16; i += kTileThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  int item = blockIdx.x;
  if (item < n_items) load_item<DH>(smem, q, k, v, item, L, tid);
  async_commit();
  for (int it = 0; item < n_items; ++it, item += gridDim.x) {
    unsigned char* qs = smem + (it & 1) * L.stage_bytes;
    const int next = item + gridDim.x;
    if (next < n_items)
      load_item<DH>(smem + ((it + 1) & 1) * L.stage_bytes, q, k, v, next, L, tid);
    async_commit();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this item's copies landed
    __syncthreads();
    for (int mt = warp; mt < ntq; mt += kTileWarps)
      tile_task<DH, NP>(qs, qs + L.k_off, qs + L.v_off, lse + static_cast<size_t>(item) * L.t_q,
                        mt, L.t_q, L.t_kv, scale, lane);
    __syncthreads();
    // the item's output rows (over its q rows), 16 bytes a thread
    const int b = item / L.heads, h = item % L.heads, c = tid % kChunks;
    for (int r = tid / kChunks; r < L.t_q; r += kTileThreads / kChunks)
      *reinterpret_cast<uint4*>(out + (static_cast<size_t>(b * L.t_q + r) * L.heads + h) * DH +
                                8 * c) = *reinterpret_cast<const uint4*>(qs + at<DH>(r, 16 * c));
    __syncthreads();  // this stage is free for the item after next
  }
}

int region_bytes(int rows, int row_bytes) {
  return ((rows + 15) / 16 * 16 * row_bytes + 127) / 128 * 128;
}

template <int DH, int NP>
int launch_tile_np(const void* q, const void* k, const void* v, void* out, float* lse,
                   const TileLayout& L, int batch, float scale, cudaStream_t stream) {
  static std::atomic<unsigned long long> attribute_set{0};
  cudaError_t err =
      max_dynamic_smem_once(flash_fwd_bf16_tile_kernel<DH, NP>, 2 * kStageMax, attribute_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = 2 * L.stage_bytes;
  // the persistent grid (SMs x blocks an SM at this smem), kept for the
  // last (device, smem) this thread launched with: the queries cost host
  // microseconds that a small launch feels
  thread_local int last_dev = -1, last_smem = -1, last_cap = 0;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if (dev != last_dev || smem != last_smem) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, flash_fwd_bf16_tile_kernel<DH, NP>, kTileThreads, smem)) != cudaSuccess)
      return static_cast<int>(err);
    last_dev = dev;
    last_smem = smem;
    last_cap = sms * std::max(per_sm, 1);
  }
  const int n_items = batch * L.heads;
  const int grid = std::min(n_items, last_cap);
  flash_fwd_bf16_tile_kernel<DH, NP><<<grid, kTileThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, L, n_items,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_tile(const void* q, const void* k, const void* v, void* out, float* lse, int batch,
                int t_q, int t_kv, int heads, float scale, cudaStream_t stream) {
  if (t_q < 1 || t_q > kTileKeys || t_kv < 1 || t_kv > kTileKeys || heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  TileLayout L;
  L.t_q = t_q;
  L.t_kv = t_kv;
  L.heads = heads;
  L.k_off = region_bytes(t_q, DH * 2);
  L.v_off = L.k_off + region_bytes(t_kv, DH * 2);
  L.stage_bytes = L.v_off + region_bytes(t_kv, DH * 2);
  switch ((t_kv + 15) / 16) {
    case 1: return launch_tile_np<DH, 1>(q, k, v, out, lse, L, batch, scale, stream);
    case 2: return launch_tile_np<DH, 2>(q, k, v, out, lse, L, batch, scale, stream);
    case 3: return launch_tile_np<DH, 3>(q, k, v, out, lse, L, batch, scale, stream);
    case 4: return launch_tile_np<DH, 4>(q, k, v, out, lse, L, batch, scale, stream);
    case 5: return launch_tile_np<DH, 5>(q, k, v, out, lse, L, batch, scale, stream);
    case 6: return launch_tile_np<DH, 6>(q, k, v, out, lse, L, batch, scale, stream);
    case 7: return launch_tile_np<DH, 7>(q, k, v, out, lse, L, batch, scale, stream);
    default: return launch_tile_np<DH, 8>(q, k, v, out, lse, L, batch, scale, stream);
  }
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

extern "C" int tip_flash_attention_fwd_bf16_tile(const void* q, const void* k, const void* v,
                                                 void* out, float* lse, int batch, int t_q,
                                                 int t_kv, int heads, int dh, float scale,
                                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch_tile<16>(q, k, v, out, lse, batch, t_q, t_kv, heads, scale, s);
    case 32: return launch_tile<32>(q, k, v, out, lse, batch, t_q, t_kv, heads, scale, s);
    case 64: return launch_tile<64>(q, k, v, out, lse, batch, t_q, t_kv, heads, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
