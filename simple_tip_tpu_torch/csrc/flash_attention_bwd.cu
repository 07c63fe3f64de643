// Flash-attention backward for Hopper (sm_90a), float32-accurate products on
// the tensor cores: kernels B5 (dq) and B6 (dk, dv).
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
// [B,Tq,H,dh], dk and dv [B,Tkv,H,dh]. Any dh >= 1, Tq >= 1, Tkv >= 1: this
// file's kernels take dh <= 128; wider heads go to the wide-head variants in
// flash_attention_wide.cu.
//
// What bounds them on this card: per sequence-head B5 does three products
// of 2*Tq*Tkv*dh FLOPs (q.k^T, dO.v^T, ds.k) and B6 four (k.q^T, v.dO^T,
// p^T.dO, ds^T.q). On the tensor cores in 3xTF32 (three TF32 products at
// 495 TF/s) that is below the ridge point at the IMDB shape (T=100,
// dh=32), so bytes bound both: q, k, v, dO, lse and D read once, dq (B5)
// or dk and dv (B6) written once.
//
// What the design does:
// - Work items are (sequence-head, block of own rows): B5 owns queries and
//   streams keys, B6 owns keys and streams queries. A persistent block walks
//   its items; each item is one or more chunks of streamed rows. The block
//   loads the next chunk (and, at an item's first chunk, the next item's own
//   rows) with cp.async into the other half of a two-stage ring while it
//   computes this one. Own rows are double-buffered by item, streamed rows
//   by step. Where the whole streamed side fits a chunk (T=100 at dh=32) it
//   is loaded once per sequence-head.
// - A warp owns a 16-row m-tile of own rows and walks the chunk's 8-row
//   n-tiles of streamed rows, keeping its gradient rows in registers (up to
//   255 a thread; 8 warps for 128 own rows, 4 for 64 at dh 128; one block
//   an SM). T=100 computes 112 own rows (7 of 8 warps busy) against 104
//   streamed rows (13 n-tiles), not 128 x 128. The n-tiles run in sub-tiles
//   of up to SUB, each sub-tile length compiled without a branch, so the
//   warp's independent products interleave. (Two warps a tile, each with
//   half the n-tiles and 128 registers, measured 12-13% slower.)
// - Every product runs as mma.sync.m16n8k8 TF32 with each f32 operand split
//   into TF32 high and low parts (3xTF32): float32-level error. Each 8-deep
//   k-step is summed from zero and added to the running f32 sum (the tensor
//   cores round toward zero). The streamed operands (B operands of every
//   product) are split once per chunk in shared memory for all warps; the
//   own rows (A operands of the score products) belong to one warp and are
//   split in registers as it reads them.
// - B5: s = q.k^T and dP = dO.v^T come out in the accumulator layout (rows
//   = queries g and g + 8 of each lane); ds is built there from lse and D of
//   those rows and feeds dq += ds.k as the A operand, K's rows read in the
//   matching order (keys 2t and 2t + 1 of each 8-key step).
// - B6: the scores are computed transposed, s^T = k.q^T and dP^T = v.dO^T,
//   so p^T and ds^T are in the accumulator layout with keys as rows (lse and
//   D read per column, the query pair 2t, 2t + 1) and feed dv += p^T.dO and
//   dk += ds^T.q as A operands in the same way.
// - Keys past Tkv get p = 0 (the forward's -1e30 mask), query rows past Tq
//   get p = 0 (their lse is not defined). Rows past T and the head-dim tail
//   are zero-filled by cp.async in shared memory. Rows are padded to
//   dh_pad + 4 floats, so every fragment load is conflict-free.
// - Gradients go back through shared memory in coalesced (16-byte where
//   dh % 4 == 0 and the pointers allow) row stores. No atomics: every
//   result is summed in one order, the same on every run.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"

namespace {

constexpr int kNarrowDh = 128;  // the widest head dim these kernels hold in registers
constexpr float kLog2e = 1.4426950408889634f;

template <int DHP>
struct Cfg {
  static constexpr int kStride = DHP + 4;  // floats a padded row
  static constexpr int kRows = DHP <= 64 ? 128 : 64;  // own rows an item
  static constexpr int kThreads = kRows / 16 * 32;    // a warp per m16 tile
  static constexpr int kChunk = DHP <= 8 ? 512 : DHP <= 16 ? 256 : DHP <= 32 ? 128
                              : DHP <= 64 ? 32 : 16;  // streamed rows a step
  // Own part, one per item parity: two arrays of kRows rows, then (B5) lse
  // and D of the rows. Streamed part, one per step parity: two arrays of
  // kChunk rows (their TF32 high parts once split), then (B6) lse and D of
  // the rows. One low-part buffer for the streamed arrays of this step.
  static constexpr int kOwnFloats = 2 * kRows * kStride + 2 * kRows;
  static constexpr int kStreamFloats = 2 * kChunk * kStride + 2 * kChunk;
  static constexpr int kLoFloats = 2 * kChunk * kStride;
  static constexpr int kSmemBytes =
      static_cast<int>(sizeof(float)) * (2 * kOwnFloats + 2 * kStreamFloats + kLoFloats);
  static_assert(kSmemBytes <= 232448, "shared memory");
};

// Rows [0, n) of a tile (src at its first row, `row` floats between rows)
// into shared rows of kStride floats: rows at or past `valid` and columns at
// or past dh are zero-filled.
template <int DHP, int kThreads>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int n, int valid,
                                          size_t row, int dh, bool vec, int tid) {
  constexpr int S = DHP + 4;
  if (vec) {
    constexpr int P = DHP / 4;  // 16-byte pieces a padded row
    for (int l = tid; l < n * P; l += kThreads) {
      const int r = l / P, c = (l % P) * 4;
      const bool ok = r < valid && c < dh;
      cp_async16(dst + r * S + c, ok ? src + static_cast<size_t>(r) * row + c : src, ok);
    }
  } else {
    for (int l = tid; l < n * DHP; l += kThreads) {
      const int r = l / DHP, c = l % DHP;
      const bool ok = r < valid && c < dh;
      cp_async4(dst + r * S + c, ok ? src + static_cast<size_t>(r) * row + c : src, ok);
    }
  }
}

// Values [0, n) of a [B*H, T] row vector, zero past `valid`.
template <int kThreads>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int n, int valid, int tid) {
  for (int r = tid; r < n; r += kThreads) cp_async4(dst + r, r < valid ? src + r : src, r < valid);
}

// Splits rows [0, rows) of the two streamed arrays (high parts in place,
// low parts to lo), and scales the row vector lse (if any) to base 2.
template <int DHP, int kThreads>
__device__ __forceinline__ void split_chunk(float* st, float* lo, int rows, float* lse2, int tid) {
  constexpr int S = DHP + 4, CK = Cfg<DHP>::kChunk;
  const int used = rows * S;
  for (int e = tid; e < 2 * used; e += kThreads) {
    const int at = e < used ? e : e - used + CK * S;
    uint32_t hi, low;
    split_tf32(st[at], hi, low);
    st[at] = __uint_as_float(hi);
    lo[at] = __uint_as_float(low);
  }
  if (lse2 != nullptr)
    for (int r = tid; r < rows; r += kThreads) lse2[r] *= kLog2e;
}

// f(std::integral_constant<int, n>) for the runtime n in [1, N]: a sub-tile
// of every length gets its own unrolled code without a branch inside, so
// the compiler can interleave its independent products.
template <int N, class F>
__device__ __forceinline__ void with_count(int n, F&& f) {
  if constexpr (N > 1) {
    if (n < N) {
      with_count<N - 1>(n, f);
      return;
    }
  }
  f(std::integral_constant<int, N>{});
}

// The two score products of n-tiles j0 .. j0 + N - 1: x[i] = A1.B1^T and
// y[i] = A2.B2^T, A1 and A2 the warp's 16 own rows (split here), B1 and B2
// the streamed rows (split in shared memory, low parts `lo` floats on).
template <int DHP, int N>
__device__ __forceinline__ void score_tiles(float (*x)[4], float (*y)[4], const float* a1,
                                            const float* a2, const float* b1, const float* b2,
                                            int lo, int j0, int g, int t4) {
  constexpr int S = DHP + 4, NT = DHP / 8;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = y[i][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    uint32_t a_hi[4], a_lo[4];
    a_frag<DHP>(a1, kk, g, t4, a_hi, a_lo);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float* bp = b1 + (8 * (j0 + i) + g) * S + 8 * kk + t4;
      mma_3xtf32(x[i], a_hi, a_lo, bp, bp + lo, 4);
    }
    a_frag<DHP>(a2, kk, g, t4, a_hi, a_lo);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float* bp = b2 + (8 * (j0 + i) + g) * S + 8 * kk + t4;
      mma_3xtf32(y[i], a_hi, a_lo, bp, bp + lo, 4);
    }
  }
}

// acc[dn] += x.B over one 8-row k-step: x (16 x 8) in accumulator layout,
// B's rows at bh (high parts; low parts `lo` floats further), its 8-row step
// starting at the row of the k-step.
template <int DHP>
__device__ __forceinline__ void acc_product(float (*acc)[4], const float* x, const float* bh,
                                            int lo, int g, int t4) {
  constexpr int S = DHP + 4, NT = DHP / 8;
  uint32_t a_hi[4], a_lo[4];
  split_tf32(x[0], a_hi[0], a_lo[0]);
  split_tf32(x[2], a_hi[1], a_lo[1]);
  split_tf32(x[1], a_hi[2], a_lo[2]);
  split_tf32(x[3], a_hi[3], a_lo[3]);
  const float* bp = bh + 2 * t4 * S + g;
#pragma unroll
  for (int dn = 0; dn < NT; ++dn) mma_3xtf32(acc[dn], a_hi, a_lo, bp + 8 * dn, bp + lo + 8 * dn, S);
}

// The item's end: a warp writes its tile's sums times `mult` to rows
// [0, rows) at `out`, staged through `stage` (the tile's own rows in shared
// memory, which only this warp reads and has consumed) for coalesced stores.
template <int DHP>
__device__ __forceinline__ void store_tile(float (*acc)[4], float* stage, int lane, float mult,
                                           float* out, int rows, size_t row, int dh, bool vec) {
  constexpr int S = DHP + 4, NT = DHP / 8;
  const int g = lane / 4, t4 = lane % 4;
  __syncwarp();  // every lane has read the tile's own rows
#pragma unroll
  for (int dn = 0; dn < NT; ++dn) {
    float* op = stage + g * S + 8 * dn + 2 * t4;
    op[0] = acc[dn][0] * mult;
    op[1] = acc[dn][1] * mult;
    op[8 * S] = acc[dn][2] * mult;
    op[8 * S + 1] = acc[dn][3] * mult;
  }
  __syncwarp();
  if (vec) {
    const int P = dh / 4;
    for (int e = lane; e < rows * P; e += 32) {
      const int r = e / P, c = (e % P) * 4;
      *reinterpret_cast<float4*>(out + static_cast<size_t>(r) * row + c) =
          *reinterpret_cast<const float4*>(stage + r * S + c);
    }
  } else {
    for (int e = lane; e < rows * dh; e += 32) {
      const int r = e / dh, c = e % dh;
      out[static_cast<size_t>(r) * row + c] = stage[r * S + c];
    }
  }
}

// B5: dq. Items are (sequence-head, kRows queries); keys are streamed.
template <int DHP, int SUB>
__global__ void __launch_bounds__(Cfg<DHP>::kThreads, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dvec,
                    float* __restrict__ dq, int n_items, int blocks, int t_q, int t_kv,
                    int heads, int dh, float scale, bool vec) {
  using C = Cfg<DHP>;
  constexpr int S = C::kStride, CK = C::kChunk, R = C::kRows, NT = DHP / 8;
  constexpr int kThreads = C::kThreads;
  const float scale2 = scale * kLog2e;  // scores in base 2: exp2 is one MUFU op
  extern __shared__ __align__(16) float smem[];
  float* const own_base = smem;
  float* const stream_base = smem + 2 * C::kOwnFloats;
  float* const lo_base = stream_base + 2 * C::kStreamFloats;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int tile = warp;  // the warp's m16 tile of own rows
  const int n_chunks = (t_kv + CK - 1) / CK;
  const int my_items =
      n_items > static_cast<int>(blockIdx.x) ? (n_items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int n_steps = my_items * n_chunks;
  const size_t row = static_cast<size_t>(heads) * dh;  // floats between positions

  // Step f of this block: its item f / n_chunks, chunk f % n_chunks.
  auto load = [&](int f) {
    if (f < n_steps) {
      const int mine = f / n_chunks, chunk = f % n_chunks;
      const int item = blockIdx.x + mine * gridDim.x;
      const int bh = item / blocks, b = bh / heads, h = bh % heads;
      const int r0 = (item % blocks) * R, k0 = chunk * CK;
      if (chunk == 0) {
        float* own = own_base + (mine % 2) * C::kOwnFloats;
        const int rows = min(R, (t_q - r0 + 15) / 16 * 16);
        const size_t at = ((static_cast<size_t>(b) * t_q + r0) * heads + h) * dh;
        load_rows<DHP, kThreads>(own, q + at, rows, t_q - r0, row, dh, vec, tid);
        load_rows<DHP, kThreads>(own + R * S, dout + at, rows, t_q - r0, row, dh, vec, tid);
        const size_t vat = static_cast<size_t>(bh) * t_q + r0;
        load_vec<kThreads>(own + 2 * R * S, lse + vat, rows, t_q - r0, tid);
        load_vec<kThreads>(own + 2 * R * S + R, dvec + vat, rows, t_q - r0, tid);
      }
      float* st = stream_base + (f % 2) * C::kStreamFloats;
      const int rows = min(CK, (t_kv - k0 + 7) / 8 * 8);
      const size_t at = ((static_cast<size_t>(b) * t_kv + k0) * heads + h) * dh;
      load_rows<DHP, kThreads>(st, k + at, rows, t_kv - k0, row, dh, vec, tid);
      load_rows<DHP, kThreads>(st + CK * S, v + at, rows, t_kv - k0, row, dh, vec, tid);
    }
    cp_async_commit();
  };

  float acc[NT][4];
  float lse2[2], dd[2];
  load(0);
  for (int f = 0; f < n_steps; ++f) {
    load(f + 1);  // the other stage was released by the barrier that ended step f - 1
    cp_async_wait<1>();
    __syncthreads();  // step f landed for every thread

    const int mine = f / n_chunks, chunk = f % n_chunks;
    const int item = blockIdx.x + mine * gridDim.x;
    const int bh = item / blocks, b = bh / heads, h = bh % heads;
    const int r0 = (item % blocks) * R, k0 = chunk * CK;
    const int nt = (min(CK, t_kv - k0) + 7) / 8;  // n8 tiles of keys in this chunk
    float* own = own_base + (mine % 2) * C::kOwnFloats;
    float* ks = stream_base + (f % 2) * C::kStreamFloats;
    const float* vs = ks + CK * S;
    const int lo = static_cast<int>(lo_base - ks);  // from a high part to its low part
    split_chunk<DHP, kThreads>(ks, lo_base, nt * 8, nullptr, tid);
    __syncthreads();
    const bool active = tile * 16 < t_q - r0;
    if (chunk == 0) {
#pragma unroll
      for (int dn = 0; dn < NT; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = tile * 16 + g + 8 * r;  // row of the item
        const bool valid = r0 + i < t_q;      // rows past Tq get p = 0
        lse2[r] = valid ? own[2 * R * S + i] * kLog2e : INFINITY;
        dd[r] = own[2 * R * S + R + i];
      }
    }

    if (active) {
      const float* qw = own + tile * 16 * S;
      const float* dow = qw + R * S;
      for (int j0 = 0; j0 < nt; j0 += SUB) {  // sub-tiles of SUB n-tiles, the last shorter
        with_count<SUB>(nt - j0, [&](auto count) {
          constexpr int N = decltype(count)::value;
          float sc[N][4], dp[N][4];
          score_tiles<DHP, N>(sc, dp, qw, dow, ks, vs, lo, j0, g, t4);
          // ds = p (dP - D) in place of s, then dq += ds k over each n-tile's keys.
#pragma unroll
          for (int i = 0; i < N; ++i) {
            const int j = j0 + i;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e / 2;
              const bool valid = k0 + 8 * j + 2 * t4 + (e & 1) < t_kv;
              const float p = valid ? exp2f(fmaf(sc[i][e], scale2, -lse2[r])) : 0.f;
              sc[i][e] = p * (dp[i][e] - dd[r]);
            }
            acc_product<DHP>(acc, sc[i], ks + 8 * j * S, lo, g, t4);
          }
        });
      }
    }

    if (chunk == n_chunks - 1 && active) {
      const int rows = min(16, t_q - r0 - tile * 16);
      float* out = dq + ((static_cast<size_t>(b) * t_q + r0 + tile * 16) * heads + h) * dh;
      store_tile<DHP>(acc, own + tile * 16 * S, lane, scale, out, rows, row, dh, vec);
    }
    __syncthreads();  // every warp is done with stage f % 2 before it is reloaded
  }
  cp_async_wait<0>();
}

// B6: dk and dv. Items are (sequence-head, kRows keys); queries are streamed.
template <int DHP, int SUB>
__global__ void __launch_bounds__(Cfg<DHP>::kThreads, 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dvec,
                     float* __restrict__ dk, float* __restrict__ dv, int n_items, int blocks,
                     int t_q, int t_kv, int heads, int dh, float scale, bool vec) {
  using C = Cfg<DHP>;
  constexpr int S = C::kStride, CK = C::kChunk, R = C::kRows, NT = DHP / 8;
  constexpr int kThreads = C::kThreads;
  const float scale2 = scale * kLog2e;
  extern __shared__ __align__(16) float smem[];
  float* const own_base = smem;
  float* const stream_base = smem + 2 * C::kOwnFloats;
  float* const lo_base = stream_base + 2 * C::kStreamFloats;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int tile = warp;  // the warp's m16 tile of own rows
  const int n_chunks = (t_q + CK - 1) / CK;
  const int my_items =
      n_items > static_cast<int>(blockIdx.x) ? (n_items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int n_steps = my_items * n_chunks;
  const size_t row = static_cast<size_t>(heads) * dh;

  auto load = [&](int f) {
    if (f < n_steps) {
      const int mine = f / n_chunks, chunk = f % n_chunks;
      const int item = blockIdx.x + mine * gridDim.x;
      const int bh = item / blocks, b = bh / heads, h = bh % heads;
      const int r0 = (item % blocks) * R, q0 = chunk * CK;
      if (chunk == 0) {
        float* own = own_base + (mine % 2) * C::kOwnFloats;
        const int rows = min(R, (t_kv - r0 + 15) / 16 * 16);
        const size_t at = ((static_cast<size_t>(b) * t_kv + r0) * heads + h) * dh;
        load_rows<DHP, kThreads>(own, k + at, rows, t_kv - r0, row, dh, vec, tid);
        load_rows<DHP, kThreads>(own + R * S, v + at, rows, t_kv - r0, row, dh, vec, tid);
      }
      float* st = stream_base + (f % 2) * C::kStreamFloats;
      const int rows = min(CK, (t_q - q0 + 7) / 8 * 8);
      const size_t at = ((static_cast<size_t>(b) * t_q + q0) * heads + h) * dh;
      load_rows<DHP, kThreads>(st, q + at, rows, t_q - q0, row, dh, vec, tid);
      load_rows<DHP, kThreads>(st + CK * S, dout + at, rows, t_q - q0, row, dh, vec, tid);
      const size_t vat = static_cast<size_t>(bh) * t_q + q0;
      load_vec<kThreads>(st + 2 * CK * S, lse + vat, rows, t_q - q0, tid);
      load_vec<kThreads>(st + 2 * CK * S + CK, dvec + vat, rows, t_q - q0, tid);
    }
    cp_async_commit();
  };

  float acc_k[NT][4], acc_v[NT][4];
  load(0);
  for (int f = 0; f < n_steps; ++f) {
    load(f + 1);
    cp_async_wait<1>();
    __syncthreads();

    const int mine = f / n_chunks, chunk = f % n_chunks;
    const int item = blockIdx.x + mine * gridDim.x;
    const int bh = item / blocks, b = bh / heads, h = bh % heads;
    const int r0 = (item % blocks) * R, q0 = chunk * CK;
    const int nt = (min(CK, t_q - q0) + 7) / 8;  // n8 tiles of queries in this chunk
    float* own = own_base + (mine % 2) * C::kOwnFloats;
    float* qs = stream_base + (f % 2) * C::kStreamFloats;
    const float* dos = qs + CK * S;
    const float* lse2 = qs + 2 * CK * S;  // base 2 once split
    const float* dvals = lse2 + CK;  // D of the chunk's queries
    const int lo = static_cast<int>(lo_base - qs);
    split_chunk<DHP, kThreads>(qs, lo_base, nt * 8, qs + 2 * CK * S, tid);
    __syncthreads();
    const bool active = tile * 16 < t_kv - r0;
    if (chunk == 0) {
#pragma unroll
      for (int dn = 0; dn < NT; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_k[dn][e] = acc_v[dn][e] = 0.f;
    }

    if (active) {
      const float* kw = own + tile * 16 * S;
      const float* vw = kw + R * S;
      for (int j0 = 0; j0 < nt; j0 += SUB) {
        with_count<SUB>(nt - j0, [&](auto count) {
          constexpr int N = decltype(count)::value;
          float sc[N][4], dp[N][4];  // s^T and dP^T: rows keys, columns queries
          score_tiles<DHP, N>(sc, dp, kw, vw, qs, dos, lo, j0, g, t4);
          // p^T in place of s, ds^T in place of dP; then dv += p^T dO and
          // dk += ds^T q over each n-tile's queries.
#pragma unroll
          for (int i = 0; i < N; ++i) {
            const int j = j0 + i;
            const int c = 8 * j + 2 * t4;  // this lane's query columns c, c + 1
            const float2 l2 = *reinterpret_cast<const float2*>(lse2 + c);
            const float2 d2 = *reinterpret_cast<const float2*>(dvals + c);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const bool odd = e & 1;
              const bool valid = q0 + c + odd < t_q;  // query rows past Tq get p = 0
              const float p = valid ? exp2f(fmaf(sc[i][e], scale2, -(odd ? l2.y : l2.x))) : 0.f;
              sc[i][e] = p;
              dp[i][e] = p * (dp[i][e] - (odd ? d2.y : d2.x));
            }
            acc_product<DHP>(acc_v, sc[i], dos + 8 * j * S, lo, g, t4);
            acc_product<DHP>(acc_k, dp[i], qs + 8 * j * S, lo, g, t4);
          }
        });
      }
    }

    if (chunk == n_chunks - 1 && active) {
      const int rows = min(16, t_kv - r0 - tile * 16);
      const size_t at = ((static_cast<size_t>(b) * t_kv + r0 + tile * 16) * heads + h) * dh;
      store_tile<DHP>(acc_k, own + tile * 16 * S, lane, scale, dk + at, rows, row, dh, vec);
      store_tile<DHP>(acc_v, own + R * S + tile * 16 * S, lane, 1.f, dv + at, rows, row, dh, vec);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

// The shared-memory opt-in of `kernel` and the persistent grid's size
// (blocks resident on the current device).
template <typename Kernel>
cudaError_t configure(Kernel kernel, int threads, int smem, int& resident) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0, device = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  resident = per_sm * sms;
  return cudaSuccess;
}

// Streamed n-tiles a warp holds at once: as many as fit its 255 registers
// without spilling (the -Xptxas -v report in build.log).
template <int DHP>
constexpr int dq_sub() { return DHP <= 32 ? 8 : DHP <= 64 ? 4 : 2; }
template <int DHP>
constexpr int dkv_sub() { return DHP <= 64 ? 4 : 2; }

template <int DHP>
int launch_dq(const float* q, const float* k, const float* v, const float* dout, const float* lse,
              const float* dvec, float* dq, int batch, int t_q, int t_kv, int heads, int dh,
              float scale, bool vec, cudaStream_t stream) {
  using C = Cfg<DHP>;
  auto kernel = flash_bwd_dq_kernel<DHP, dq_sub<DHP>()>;
  const int blocks = (t_q + C::kRows - 1) / C::kRows;
  const int n_items = batch * heads * blocks;
  static int configured_device = -1, resident = 0;  // per device, as in configure()
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device != configured_device) {
    err = configure(kernel, C::kThreads, C::kSmemBytes, resident);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured_device = device;
  }
  const int grid = n_items < resident ? n_items : resident;
  kernel<<<grid, C::kThreads, C::kSmemBytes, stream>>>(q, k, v, dout, lse, dvec, dq, n_items,
                                                       blocks, t_q, t_kv, heads, dh, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int DHP>
int launch_dkv(const float* q, const float* k, const float* v, const float* dout,
               const float* lse, const float* dvec, float* dk, float* dv, int batch, int t_q,
               int t_kv, int heads, int dh, float scale, bool vec, cudaStream_t stream) {
  using C = Cfg<DHP>;
  auto kernel = flash_bwd_dkv_kernel<DHP, dkv_sub<DHP>()>;
  const int blocks = (t_kv + C::kRows - 1) / C::kRows;
  const int n_items = batch * heads * blocks;
  static int configured_device = -1, resident = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device != configured_device) {
    err = configure(kernel, C::kThreads, C::kSmemBytes, resident);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured_device = device;
  }
  const int grid = n_items < resident ? n_items : resident;
  kernel<<<grid, C::kThreads, C::kSmemBytes, stream>>>(
      q, k, v, dout, lse, dvec, dk, dv, n_items, blocks, t_q, t_kv, heads, dh, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tip_flash_wide_bwd_dq(const float* q, const float* k, const float* v,
                                     const float* dout, const float* lse, const float* dvec,
                                     float* dq, int batch, int t_q, int t_kv, int heads, int dh,
                                     float scale, void* stream);
extern "C" int tip_flash_wide_bwd_dkv(const float* q, const float* k, const float* v,
                                      const float* dout, const float* lse, const float* dvec,
                                      float* dk, float* dv, int batch, int t_q, int t_kv,
                                      int heads, int dh, float scale, void* stream);

extern "C" int tip_flash_attention_bwd_dq(const float* q, const float* k, const float* v,
                                          const float* dout, const float* lse,
                                          const float* dvec, float* dq, int batch,
                                          int t_q, int t_kv, int heads, int dh,
                                          float scale, void* stream) {
  if (dh < 1 || t_kv < 1 || t_q < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (batch * heads == 0) return 0;
  if (dh > kNarrowDh)
    return tip_flash_wide_bwd_dq(q, k, v, dout, lse, dvec, dq, batch, t_q, t_kv, heads, dh,
                                 scale, stream);
  const void* ptrs[] = {q, k, v, dout, dq};
  const bool vec = vec_rows(dh, ptrs, 5);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh <= 8) return launch_dq<8>(q, k, v, dout, lse, dvec, dq, batch, t_q, t_kv, heads, dh, scale, vec, s);
  if (dh <= 16) return launch_dq<16>(q, k, v, dout, lse, dvec, dq, batch, t_q, t_kv, heads, dh, scale, vec, s);
  if (dh <= 32) return launch_dq<32>(q, k, v, dout, lse, dvec, dq, batch, t_q, t_kv, heads, dh, scale, vec, s);
  if (dh <= 64) return launch_dq<64>(q, k, v, dout, lse, dvec, dq, batch, t_q, t_kv, heads, dh, scale, vec, s);
  return launch_dq<128>(q, k, v, dout, lse, dvec, dq, batch, t_q, t_kv, heads, dh, scale, vec, s);
}

extern "C" int tip_flash_attention_bwd_dkv(const float* q, const float* k, const float* v,
                                           const float* dout, const float* lse,
                                           const float* dvec, float* dk, float* dv,
                                           int batch, int t_q, int t_kv, int heads,
                                           int dh, float scale, void* stream) {
  if (dh < 1 || t_kv < 1 || t_q < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (batch * heads == 0) return 0;
  if (dh > kNarrowDh)
    return tip_flash_wide_bwd_dkv(q, k, v, dout, lse, dvec, dk, dv, batch, t_q, t_kv, heads,
                                  dh, scale, stream);
  const void* ptrs[] = {q, k, v, dout, dk, dv};
  const bool vec = vec_rows(dh, ptrs, 6);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh <= 8) return launch_dkv<8>(q, k, v, dout, lse, dvec, dk, dv, batch, t_q, t_kv, heads, dh, scale, vec, s);
  if (dh <= 16) return launch_dkv<16>(q, k, v, dout, lse, dvec, dk, dv, batch, t_q, t_kv, heads, dh, scale, vec, s);
  if (dh <= 32) return launch_dkv<32>(q, k, v, dout, lse, dvec, dk, dv, batch, t_q, t_kv, heads, dh, scale, vec, s);
  if (dh <= 64) return launch_dkv<64>(q, k, v, dout, lse, dvec, dk, dv, batch, t_q, t_kv, heads, dh, scale, vec, s);
  return launch_dkv<128>(q, k, v, dout, lse, dvec, dk, dv, batch, t_q, t_kv, heads, dh, scale, vec, s);
}
