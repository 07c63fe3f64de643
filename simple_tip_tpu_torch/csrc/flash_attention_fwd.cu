// Flash-attention forward for Hopper (sm_90a), float32-accurate products on
// the tensor cores.
//
// Replaces the Pallas TPU kernel simple_tip_tpu/ops/flash_attention.py
// `_flash_kernel` (launched by `_flash_fwd_call`): exact attention
// softmax(q k^T * scale) v with a streaming softmax over key tiles, writing
// the output and the log-sum-exp of every query row. q [B,Tq,H,dh], k and v
// [B,Tkv,H,dh], out [B,Tq,H,dh], lse [B,H,Tq]; any dh >= 1, Tq, Tkv >= 1.
// This file's kernel takes dh <= 128; wider heads go to the wide-head
// variant in flash_attention_wide.cu.
//
// What bounds it on this card: at the IMDB shapes (T=100, H=2, dh=32) a
// sequence-head needs 2 products x 2*100*100*32 = 1.28 MFLOP against 51 KB
// of q, k, v, out and lse. With the products on the tensor cores (3xTF32:
// three TF32 products at 495 TF/s) that is below the ridge point, so bytes
// bound it: q, k and v are read once and out written once.
//
// What the design does:
// - Work items are (sequence-head, 128 queries). A persistent block walks
//   its items in turn; each item is one or more chunks of keys, and the
//   block loads the next chunk (of this item or the next) with cp.async
//   into the other half of a two-stage ring while it computes this one.
//   Where the whole key range fits a chunk (T=100 at dh=32: one chunk), K
//   and V are loaded once for all the queries of the sequence-head.
// - Warps own 16-row query tiles, so T=100 computes 112 query rows (7 of
//   8 tiles busy) against 104 keys (13 n8 tiles), not 128 x 128. Up to
//   dh = 32 each tile has two warps, one per half of the keys (alternate
//   64-key sub-tiles), whose softmax states merge at the item's end: at
//   T=100 a warp's chain is one sub-tile, not two.
// - s = q k^T and o = p v run as mma.sync.m16n8k8 TF32 with each f32
//   operand split into TF32 high and low parts (a.b = a_hi.b_hi + a_hi.b_lo
//   + a_lo.b_hi, f32 accumulation): float32-level error. K and V are split
//   once per chunk in shared memory for all warps. The running max and
//   normaliser live in the accumulator layout (row g and g + 8 of each
//   lane, max by quad shuffles), in base 2 (scores times log2 e, exp2).
//   p stays in registers: its accumulator layout becomes the A operand of
//   p v by reading V's rows in the matching order (keys 2t and 2t+1 of each
//   8-key step), so nothing is shuffled.
// - Keys past Tkv are masked to -1e30 as on the TPU; rows past Tq and the
//   head-dim tail are zero-filled by cp.async in shared memory. Rows are
//   padded to dh_pad + 4 floats, so every fragment load is conflict-free.
// - out goes back through shared memory in coalesced (16-byte where dh % 4
//   == 0) row stores; lse is written once per row.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kBlockQ = 128;  // query rows an item: 8 m16 tiles
constexpr int kNarrowDh = 128;  // the widest head dim this kernel holds in registers
constexpr float kNegInf = -1e30f;

template <int DHP>
struct Cfg {
  static constexpr int kStride = DHP + 4;  // floats a padded row
  // keys a chunk; a stage holds Q, then K and V (their TF32 high parts),
  // then their low parts
  static constexpr int kChunk = DHP <= 8 ? 512 : DHP <= 16 ? 256 : DHP <= 32 ? 128
                              : DHP <= 64 ? 64 : 16;
  static constexpr int kStageFloats = (kBlockQ + 4 * kChunk) * kStride;
  static constexpr int kSmemBytes = 2 * kStageFloats * static_cast<int>(sizeof(float));
  // Up to dh 32 two warps share each query tile, one per half of the keys
  // (alternate 64-key sub-tiles), and merge their softmax states at the end.
  static constexpr int kHalves = DHP <= 32 ? 2 : 1;
  static constexpr int kThreads = 8 * 32 * kHalves;
  // the merge's exchange: m, l (2 rows each) and o per lane, in K and V's space
  static constexpr int kExchange = 4 + 4 * (DHP / 8);
  static_assert(kHalves == 1 || 256 * kExchange <= 4 * kChunk * kStride, "exchange space");
};

template <int DHP>
__global__ void __launch_bounds__(Cfg<DHP>::kThreads, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int n_items, int q_blocks, int t_q, int t_kv,
                 int heads, int dh, float scale) {
  using C = Cfg<DHP>;
  const float scale2 = scale * 1.4426950408889634f;  // scores in base 2: exp2 is one MUFU op
  constexpr int S = C::kStride, CK = C::kChunk, NT = DHP / 8, kThreads = C::kThreads;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int tile = warp % 8, half = warp / 8;  // query tile, half of the keys
  const int n_chunks = (t_kv + CK - 1) / CK;
  const int my_items =
      n_items > static_cast<int>(blockIdx.x) ? (n_items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int n_steps = my_items * n_chunks;
  const size_t row = static_cast<size_t>(heads) * dh;  // stride between positions
  const bool vec = dh % 4 == 0;

  // Step f of this block: item blockIdx.x + (f / n_chunks) * gridDim.x, chunk f % n_chunks.
  auto load = [&](int f) {
    if (f < n_steps) {
      const int item = blockIdx.x + (f / n_chunks) * gridDim.x, chunk = f % n_chunks;
      const int bh = item / q_blocks, b = bh / heads, h = bh % heads;
      const int q0 = (item % q_blocks) * kBlockQ, k0 = chunk * CK;
      const int q_rows = min(kBlockQ, (t_q - q0 + 15) / 16 * 16);
      const int k_rows = min(CK, (t_kv - k0 + 7) / 8 * 8);
      float* qs = smem + (f % 2) * C::kStageFloats;
      float* ks = qs + kBlockQ * S;
      float* vs = ks + CK * S;
      const float* qg = q + (static_cast<size_t>(b) * t_q * heads + h) * dh;
      const float* kg = k + (static_cast<size_t>(b) * t_kv * heads + h) * dh;
      const float* vg = v + (static_cast<size_t>(b) * t_kv * heads + h) * dh;
      if (vec) {
        constexpr int P = DHP / 4;  // 16-byte pieces a padded row
        for (int l = tid; l < q_rows * P; l += kThreads) {
          const int r = l / P, c = (l % P) * 4;
          const bool ok = q0 + r < t_q && c < dh;
          cp_async16(qs + r * S + c, ok ? qg + static_cast<size_t>(q0 + r) * row + c : qg, ok);
        }
        for (int l = tid; l < k_rows * P; l += kThreads) {
          const int r = l / P, c = (l % P) * 4;
          const bool ok = k0 + r < t_kv && c < dh;
          const size_t off = static_cast<size_t>(k0 + r) * row + c;
          cp_async16(ks + r * S + c, ok ? kg + off : kg, ok);
          cp_async16(vs + r * S + c, ok ? vg + off : vg, ok);
        }
      } else {
        for (int l = tid; l < q_rows * DHP; l += kThreads) {
          const int r = l / DHP, c = l % DHP;
          const bool ok = q0 + r < t_q && c < dh;
          cp_async4(qs + r * S + c, ok ? qg + static_cast<size_t>(q0 + r) * row + c : qg, ok);
        }
        for (int l = tid; l < k_rows * DHP; l += kThreads) {
          const int r = l / DHP, c = l % DHP;
          const bool ok = k0 + r < t_kv && c < dh;
          const size_t off = static_cast<size_t>(k0 + r) * row + c;
          cp_async4(ks + r * S + c, ok ? kg + off : kg, ok);
          cp_async4(vs + r * S + c, ok ? vg + off : vg, ok);
        }
      }
    }
    cp_async_commit();
  };

  float m[2], l[2], o[NT][4];
  load(0);
  for (int f = 0; f < n_steps; ++f) {
    load(f + 1);  // the other stage was released by the barrier that ended step f - 1
    cp_async_wait<1>();
    __syncthreads();  // step f landed for every thread

    const int item = blockIdx.x + (f / n_chunks) * gridDim.x, chunk = f % n_chunks;
    const int bh = item / q_blocks, b = bh / heads, h = bh % heads;
    const int q0 = (item % q_blocks) * kBlockQ, k0 = chunk * CK;
    const int keys = min(CK, t_kv - k0);
    float* qw = smem + (f % 2) * C::kStageFloats + tile * 16 * S;
    float* ks = smem + (f % 2) * C::kStageFloats + kBlockQ * S;
    const float* vs = ks + CK * S;
    const int lo = 2 * CK * S;  // from a high part to its low part
    const bool active = tile * 16 < t_q - q0;
    // Split the chunk's K and V rows into TF32 parts once for all warps.
    const int kv = (keys + 7) / 8 * 8 * S;  // floats of the rows in use
    for (int e = tid; e < 2 * kv; e += kThreads) {
      const int at = e < kv ? e : e - kv + CK * S;
      uint32_t hi, low;
      split_tf32(ks[at], hi, low);
      ks[at] = __uint_as_float(hi);
      ks[at + lo] = __uint_as_float(low);
    }
    __syncthreads();
    if (chunk == 0) {
      m[0] = m[1] = kNegInf;
      l[0] = l[1] = 0.f;
#pragma unroll
      for (int dn = 0; dn < NT; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
    }

    if (active) {
      for (int kt0 = half * 64; kt0 < keys; kt0 += 64 * C::kHalves) {
        const int nt = min(8, (keys - kt0 + 7) / 8);  // n8 tiles of keys in this sub-tile
        float s[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NT; ++kk) {
          uint32_t a_hi[4], a_lo[4];
          const float* ap = qw + g * S + 8 * kk + t4;
          split_tf32(ap[0], a_hi[0], a_lo[0]);
          split_tf32(ap[8 * S], a_hi[1], a_lo[1]);
          split_tf32(ap[4], a_hi[2], a_lo[2]);
          split_tf32(ap[8 * S + 4], a_hi[3], a_lo[3]);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (j < nt) {
              const float* bp = ks + (kt0 + 8 * j + g) * S + 8 * kk + t4;
              mma_3xtf32(s[j], a_hi, a_lo, bp, bp + lo, 4);
            }
          }
        }
        // Scale, mask keys past Tkv, and fold this sub-tile into (m, l, o).
        float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool valid = k0 + kt0 + 8 * j + 2 * t4 + e < t_kv;
              s[j][e] = valid ? s[j][e] * scale2 : kNegInf;
              s[j][2 + e] = valid ? s[j][2 + e] * scale2 : kNegInf;
              mx0 = fmaxf(mx0, s[j][e]);
              mx1 = fmaxf(mx1, s[j][2 + e]);
            }
          }
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
        for (int dn = 0; dn < NT; ++dn) {
          o[dn][0] *= alpha0;
          o[dn][1] *= alpha0;
          o[dn][2] *= alpha1;
          o[dn][3] *= alpha1;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < nt) {
            s[j][0] = exp2f(s[j][0] - m0);
            s[j][1] = exp2f(s[j][1] - m0);
            s[j][2] = exp2f(s[j][2] - m1);
            s[j][3] = exp2f(s[j][3] - m1);
            l[0] += s[j][0] + s[j][1];
            l[1] += s[j][2] + s[j][3];
          }
        }
        // o += p v: k-step j takes keys 8j + 2t and 8j + 2t + 1 as its k-indices
        // t and t + 4, which is where p's accumulator layout already holds them.
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < nt) {
            uint32_t a_hi[4], a_lo[4];
            split_tf32(s[j][0], a_hi[0], a_lo[0]);
            split_tf32(s[j][2], a_hi[1], a_lo[1]);
            split_tf32(s[j][1], a_hi[2], a_lo[2]);
            split_tf32(s[j][3], a_hi[3], a_lo[3]);
            const float* vp = vs + (kt0 + 8 * j + 2 * t4) * S + g;
#pragma unroll
            for (int dn = 0; dn < NT; ++dn) mma_3xtf32(o[dn], a_hi, a_lo, vp + 8 * dn, vp + lo + 8 * dn, S);
          }
        }
      }
    }

    if (chunk == n_chunks - 1) {
      if (C::kHalves == 2) {
        __syncthreads();  // K and V of this stage are consumed: exchange there
        float* xch = ks + (tile * 32 + lane) * C::kExchange;
        if (half == 1 && active) {
          xch[0] = m[0];
          xch[1] = m[1];
          xch[2] = l[0];
          xch[3] = l[1];
#pragma unroll
          for (int dn = 0; dn < NT; ++dn)
#pragma unroll
            for (int e = 0; e < 4; ++e) xch[4 + 4 * dn + e] = o[dn][e];
        }
        __syncthreads();
        if (half == 0 && active) {
          const float m0 = fmaxf(m[0], xch[0]), m1 = fmaxf(m[1], xch[1]);
          const float a0 = exp2f(m[0] - m0), b0 = exp2f(xch[0] - m0);
          const float a1 = exp2f(m[1] - m1), b1 = exp2f(xch[1] - m1);
          m[0] = m0;
          m[1] = m1;
          l[0] = l[0] * a0 + xch[2] * b0;
          l[1] = l[1] * a1 + xch[3] * b1;
#pragma unroll
          for (int dn = 0; dn < NT; ++dn) {
            o[dn][0] = o[dn][0] * a0 + xch[4 + 4 * dn] * b0;
            o[dn][1] = o[dn][1] * a0 + xch[5 + 4 * dn] * b0;
            o[dn][2] = o[dn][2] * a1 + xch[6 + 4 * dn] * b1;
            o[dn][3] = o[dn][3] * a1 + xch[7 + 4 * dn] * b1;
          }
        }
      }
      if (half == 0 && active) {
        // The quad's lanes hold parts of each row's normaliser.
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          l[0] += __shfl_xor_sync(0xffffffffu, l[0], off);
          l[1] += __shfl_xor_sync(0xffffffffu, l[1], off);
        }
        // This warp's q rows are consumed: stage its output rows there.
#pragma unroll
        for (int dn = 0; dn < NT; ++dn) {
          float* op = qw + g * S + 8 * dn + 2 * t4;
          op[0] = o[dn][0] / l[0];
          op[1] = o[dn][1] / l[0];
          op[8 * S] = o[dn][2] / l[1];
          op[8 * S + 1] = o[dn][3] / l[1];
        }
        __syncwarp();
        const int r0 = q0 + tile * 16;
        const int rows = min(16, t_q - r0);
        float* og = out + (static_cast<size_t>(b) * t_q * heads + h) * dh;
        if (vec) {
          const int P = dh / 4;
          for (int e = lane; e < rows * P; e += 32) {
            const int r = e / P, c = (e % P) * 4;
            *reinterpret_cast<float4*>(og + static_cast<size_t>(r0 + r) * row + c) =
                *reinterpret_cast<const float4*>(qw + r * S + c);
          }
        } else {
          for (int e = lane; e < rows * dh; e += 32) {
            const int r = e / dh, c = e % dh;
            og[static_cast<size_t>(r0 + r) * row + c] = qw[r * S + c];
          }
        }
        if (t4 == 0) {
          float* lg = lse + static_cast<size_t>(bh) * t_q + r0;
          constexpr float kLn2 = 0.6931471805599453f;
          if (g < rows) lg[g] = m[0] * kLn2 + logf(l[0]);
          if (g + 8 < rows) lg[g + 8] = m[1] * kLn2 + logf(l[1]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage f % 2 before it is reloaded
  }
  cp_async_wait<0>();
}

template <int DHP>
int launch(const float* q, const float* k, const float* v, float* out, float* lse, int batch,
           int t_q, int t_kv, int heads, int dh, float scale, cudaStream_t stream) {
  using C = Cfg<DHP>;
  // Per device: the shared-memory opt-in and the persistent grid's size.
  static int configured_device = -1, resident = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device != configured_device) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<DHP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flash_fwd_kernel<DHP>,
                                                        C::kThreads, C::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident = per_sm * sms;
    configured_device = device;
  }
  const int q_blocks = (t_q + kBlockQ - 1) / kBlockQ;
  const int n_items = batch * heads * q_blocks;
  const int grid = n_items < resident ? n_items : resident;
  flash_fwd_kernel<DHP><<<grid, C::kThreads, C::kSmemBytes, stream>>>(
      q, k, v, out, lse, n_items, q_blocks, t_q, t_kv, heads, dh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tip_flash_wide_fwd(const float* q, const float* k, const float* v, float* out,
                                  float* lse, int batch, int t_q, int t_kv, int heads, int dh,
                                  float scale, void* stream);

extern "C" int tip_flash_attention_fwd(const float* q, const float* k, const float* v,
                                       float* out, float* lse, int batch, int t_q,
                                       int t_kv, int heads, int dh, float scale,
                                       void* stream) {
  if (dh < 1 || t_kv < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (batch * heads * t_q == 0) return 0;
  if (dh > kNarrowDh)
    return tip_flash_wide_fwd(q, k, v, out, lse, batch, t_q, t_kv, heads, dh, scale, stream);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh <= 8) return launch<8>(q, k, v, out, lse, batch, t_q, t_kv, heads, dh, scale, s);
  if (dh <= 16) return launch<16>(q, k, v, out, lse, batch, t_q, t_kv, heads, dh, scale, s);
  if (dh <= 32) return launch<32>(q, k, v, out, lse, batch, t_q, t_kv, heads, dh, scale, s);
  if (dh <= 64) return launch<64>(q, k, v, out, lse, batch, t_q, t_kv, heads, dh, scale, s);
  return launch<128>(q, k, v, out, lse, batch, t_q, t_kv, heads, dh, scale, s);
}
