// Fused MNIST/FMNIST inference forward in the bf16 scoring mode, for Hopper
// (sm_90a): bfloat16 operands on the tensor cores, float32 sums.
//
// Replaces the Pallas TPU kernel simple_tip_tpu/ops/fused_forward.py
// `_mnist_kernel` with cdt = bfloat16 (entry `fused_mnist_probs` with
// compute_dtype=bfloat16): conv1 3x3 1->32 + relu, max-pool 26->13, conv2
// 3x3 32->64 + relu, floor max-pool 11->5, dense [1600,10] + bias, softmax.
// NHWC float32 input [B,28,28,1], float32 probabilities out [B,10].
//
// The TPU kernel's rounding points, kept here:
// - x and w1 are rounded to bfloat16 (to nearest even, as every rounding
//   here); each conv1 product x * w1 is formed in bfloat16 (the product of
//   two bfloat16 values rounded to bfloat16) and summed in float32 in
//   (dy, dx) order, the TPU kernel's order; bias, relu and pool in float32;
// - the pooled maps are rounded to bfloat16 for conv2's im2col product,
//   whose sums are float32; bias, relu and the floor pool in float32;
// - the pooled [5,5,64] maps are rounded to bfloat16 for the dense product
//   (float32 sums) with wd rounded to bfloat16; float32 bias and softmax.
//
// What bounds it: issue slots. An image costs 2.07 M multiply-adds at the
// positions the pools keep (conv2 1.84 M on the tensor cores, dense 0.016 M)
// against 3.1 KB read and 40 B written, but conv1's 0.17 M products must
// each be rounded to bfloat16 before their float32 sum, which the tensor
// cores cannot do: on the FMA pipe that is a multiply, a rounding and an
// add a product. The design:
// - conv1's product is one mul.rn.bf16x2 (bf16_product): x and w1 are kept
//   as floats already rounded to bfloat16, so their low halves are 0 and
//   the high half of the result is the correctly rounded product, already
//   the float32 value (the float32 product of two bfloat16 values is exact
//   wherever it is a normal float32, so this equals the rounding of it).
//   A product costs that and its float32 add. conv1 runs only at the 12x12
//   pooled positions conv2 reads (the 13th row and column feed only the
//   conv2 row and column the floor pool drops).
// - Warp specialisation in one persistent block an SM: 8 producer warps run
//   conv1 on the FMA pipe while 4 consumer warps run conv2 (mma.sync.m16n8k16
//   at the 10x10 positions the floor pool keeps, a warp's unit two m16
//   tiles times all 64 channels, so that each weight fragment read from
//   shared memory feeds two products, its fragments fetched a k-step ahead) and
//   the dense layer on the tensor cores for the tile before, through a
//   two-slot ring of pooled conv1 maps handed over by named barriers (FULL,
//   EMPTY).
//   Tiles are kTile = 4 images; the producers fetch the next tile's images
//   with cp.async while they compute this one.
// - conv2's weights (36 KB of bf16 fragments from fused_forward.
//   bf16_fragments) stay in shared memory, and so do the dense weights,
//   rounded to bfloat16 once a block as the tensor cores' B fragments (N =
//   10 padded to 16).
// - relu(max(a) + b) equals max(relu(a + b)) exactly (rounding is
//   monotone), so bias and relu are applied once per pooled value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "bf16_mma.cuh"

namespace {

constexpr int kProducerWarps = 8;
constexpr int kConsumerWarps = 4;
constexpr int kDenseWarps = 4;  // consumer warps that share the dense product's k-steps
constexpr int kProducers = 32 * kProducerWarps;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kProducers + kConsumers;
constexpr int kTile = 4;               // images a tile (one a consumer warp's softmax)
constexpr int kSide = 12;              // pooled conv1 rows and columns that conv2 reads
constexpr int kPos1 = kSide * kSide;   // 144 pooled conv1 positions an image
constexpr int kPixH = 40;              // bf16 a pixel of the pooled conv1 maps
constexpr int kH1Img = kPos1 * kPixH;  // bf16 an image: [12*12 px][40]
constexpr int kXImg = 784;             // floats an image
constexpr int kH2Img = 1608;           // bf16 an image: [5][5][64] and 8 of padding
constexpr int kPooled2 = kTile * 25;
constexpr int kUnits2 = kPooled2 / 4;          // conv2's m16 tiles
constexpr int kW2Frags = 18 * 8 * 32;         // uint2: [18 k-steps][8 n-tiles][32 lanes]
constexpr int kWdSteps = 100;                 // dense k-steps of 16
constexpr int kWdFrags = kWdSteps * 2 * 32;   // uint2: [100][2 n-tiles][32 lanes]
constexpr int kItems1 = kTile * kPos1 * 4;    // conv1 items: (position, 8 channels)
static_assert(kItems1 % kProducers == 0, "conv1 items fill the producers");
static_assert(kWdSteps % kDenseWarps == 0 && kDenseWarps <= kConsumerWarps &&
                  kTile <= kConsumerWarps,
              "dense k-steps and softmax warps");

// Shared-memory layout in bytes.
constexpr int kW2 = 0;
constexpr int kWd = kW2 + kW2Frags * 8;
constexpr int kH1 = kWd + kWdFrags * 8;                 // 2 slots
constexpr int kX = kH1 + 2 * kTile * kH1Img * 2;        // 2 slots
constexpr int kH2 = kX + 2 * kTile * kXImg * 4;
constexpr int kW1 = kH2 + kTile * kH2Img * 2;           // [9][32] floats, bf16-rounded
constexpr int kB1 = kW1 + 288 * 4;
constexpr int kB2 = kB1 + 32 * 4;
constexpr int kBd = kB2 + 64 * 4;
constexpr int kPart = kBd + 16 * 4;                     // dense partials [warps][kTile][10]
constexpr int kLogit = kPart + kDenseWarps * kTile * 10 * 4;
constexpr int kSmemBytes = kLogit + kTile * 10 * 4;
static_assert(kSmemBytes <= 232448, "a block's shared memory");
static_assert(kWd % 16 == 0 && kH1 % 16 == 0 && kX % 16 == 0 && kH2 % 16 == 0 &&
              kW1 % 16 == 0, "alignment");

// Named barriers (0 is __syncthreads).
constexpr int kProducerBar = 1;  // the producers alone
constexpr int kConsumerBar = 2;  // the consumers alone
constexpr int kFull = 3;         // + slot: slot's maps written (producers arrive)
constexpr int kEmpty = 5;        // + slot: slot's maps read (consumers arrive)

// Images of tile `tile` into an x slot by cp.async, zeros past the batch.
__device__ __forceinline__ void fetch_images(float* xs, const float* x, int tile, int batch,
                                             int tid) {
  const int n_img = min(kTile, batch - tile * kTile);
  const float* src = x + static_cast<size_t>(tile) * kTile * kXImg;
  for (int i = tid; i < kTile * kXImg / 4; i += kProducers) {
    const bool live = i < n_img * kXImg / 4;
    async_copy16(xs + 4 * i, live ? src + 4 * i : x, live);
  }
  async_commit();
}

// conv1 + relu + pool 26->13 of one tile into an h1 slot: a thread owns
// 8 channels (tid % 4) of 9 pooled positions.
__device__ __forceinline__ void conv1_tile(__nv_bfloat16* h1, const float* xs, const float* w1s,
                                           const float* b1s, int tid) {
  const int cg = tid % 4;
  float w[9][8], bias[8];
#pragma unroll
  for (int e = 0; e < 9; ++e)
#pragma unroll
    for (int c = 0; c < 8; ++c) w[e][c] = w1s[e * 32 + cg * 8 + c];
#pragma unroll
  for (int c = 0; c < 8; ++c) bias[c] = b1s[cg * 8 + c];
#pragma unroll 1
  for (int p = tid / 4; p < kTile * kPos1; p += kProducers / 4) {
    const int im = p / kPos1, pp = p % kPos1;
    const int py = pp / kSide, px = pp % kSide;
    const float* xi = xs + im * kXImg + (2 * py) * 28 + 2 * px;
    float patch[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float2 lo = *reinterpret_cast<const float2*>(xi + a * 28);
      const float2 hi = *reinterpret_cast<const float2*>(xi + a * 28 + 2);
      patch[a][0] = lo.x;
      patch[a][1] = lo.y;
      patch[a][2] = hi.x;
      patch[a][3] = hi.y;
    }
    float best[8];
#pragma unroll
    for (int tap = 0; tap < 4; ++tap) {
      const int ty = tap / 2, tx = tap % 2;
      float acc[8];
#pragma unroll
      for (int e = 0; e < 9; ++e) {
        // the bfloat16 product, then the float32 sum, in (dy, dx) order
        const float v = patch[ty + e / 3][tx + e % 3];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float prod = bf16_product(v, w[e][c]);
          acc[c] = e == 0 ? prod : __fadd_rn(acc[c], prod);
        }
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) best[c] = tap == 0 ? acc[c] : fmaxf(best[c], acc[c]);
    }
    uint32_t packed[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      packed[c] = pack_bf16(fmaxf(best[2 * c] + bias[2 * c], 0.f),
                              fmaxf(best[2 * c + 1] + bias[2 * c + 1], 0.f));
    *reinterpret_cast<uint4*>(h1 + im * kH1Img + pp * kPixH + cg * 8) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

// conv2 of m16 tiles u and u + 1 (each 4 pooled positions x 4 pool taps,
// pool_row_bf16) over all 64 channels: 18 k-steps of 16 (tap, 16 channels).
// Each B fragment read from shared memory feeds both tiles (the weights'
// reads bound conv2 by shared-memory bandwidth), and each step's fragments
// are fetched one step ahead of its 16 products.
__device__ __forceinline__ void conv2_pair(float (&acc)[2][8][4], const __nv_bfloat16* row0,
                                           const __nv_bfloat16* row1, const uint4* w2s,
                                           int lane) {
  uint32_t a[2][2][4];
  uint4 b[2][4];  // n-tiles 2 jp and 2 jp + 1
  auto fetch = [&](int ks, int buf) {
    const int at = ((ks / 2) / 3 * kSide + (ks / 2) % 3) * kPixH + 16 * (ks % 2);
    ldmatrix_x4(a[buf][0], row0 + at);
    ldmatrix_x4(a[buf][1], row1 + at);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) b[buf][jp] = w2s[(ks * 4 + jp) * 32 + lane];
  };
  fetch(0, 0);
#pragma unroll
  for (int ks = 0; ks < 18; ++ks) {
    if (ks + 1 < 18) fetch(ks + 1, (ks + 1) % 2);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      const uint4 w = b[ks % 2][jp];
      mma_bf16(acc[0][2 * jp], a[ks % 2][0], w.x, w.y);
      mma_bf16(acc[1][2 * jp], a[ks % 2][1], w.x, w.y);
      mma_bf16(acc[0][2 * jp + 1], a[ks % 2][0], w.z, w.w);
      mma_bf16(acc[1][2 * jp + 1], a[ks % 2][1], w.z, w.w);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
mnist_forward_bf16_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                          const float* __restrict__ b1, const uint2* __restrict__ w2f,
                          const float* __restrict__ b2, const float* __restrict__ wd,
                          const float* __restrict__ bd, float* __restrict__ out, int batch) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* w2s = reinterpret_cast<uint4*>(smem + kW2);
  uint2* wds = reinterpret_cast<uint2*>(smem + kWd);
  __nv_bfloat16* h1 = reinterpret_cast<__nv_bfloat16*>(smem + kH1);
  float* xs = reinterpret_cast<float*>(smem + kX);
  __nv_bfloat16* h2 = reinterpret_cast<__nv_bfloat16*>(smem + kH2);
  float* w1s = reinterpret_cast<float*>(smem + kW1);
  float* b1s = reinterpret_cast<float*>(smem + kB1);
  float* b2s = reinterpret_cast<float*>(smem + kB2);
  float* bds = reinterpret_cast<float*>(smem + kBd);
  float* part = reinterpret_cast<float*>(smem + kPart);
  float* logit = reinterpret_cast<float*>(smem + kLogit);
  const int tid = threadIdx.x;
  const int n_tiles = (batch + kTile - 1) / kTile;

  // conv2's fragments with n-tiles 2 jp and 2 jp + 1 side by side: one
  // 16-byte load a lane for two products
  for (int i = tid; i < kW2Frags / 2; i += kThreads) {
    const int lane = i % 32, jp = (i / 32) % 4, ks = i / 128;
    const uint2 lo = w2f[(ks * 8 + 2 * jp) * 32 + lane];
    const uint2 hi = w2f[(ks * 8 + 2 * jp + 1) * 32 + lane];
    w2s[i] = make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
  // wd [1600, 10] rounded to bfloat16 as the B operand of m16n8k16: lane
  // (g, t) of k-step ks and n-tile nt holds wd[16 ks + r][8 nt + g] for
  // r = 2t, 2t + 1, 2t + 8, 2t + 9 (zeros at n >= 10)
  for (int i = tid; i < kWdFrags; i += kThreads) {
    const int lane = i % 32, nt = (i / 32) % 2, ks = i / 64;
    const int n = 8 * nt + lane / 4, k0 = 16 * ks + 2 * (lane % 4);
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (n < 10) {
      f[0] = wd[k0 * 10 + n];
      f[1] = wd[(k0 + 1) * 10 + n];
      f[2] = wd[(k0 + 8) * 10 + n];
      f[3] = wd[(k0 + 9) * 10 + n];
    }
    wds[i] = make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
  }
  for (int i = tid; i < 288; i += kThreads) w1s[i] = bf16_round(w1[i]);
  for (int i = tid; i < 32; i += kThreads) b1s[i] = b1[i];
  for (int i = tid; i < 64; i += kThreads) b2s[i] = b2[i];
  for (int i = tid; i < 10; i += kThreads) bds[i] = bd[i];
  __syncthreads();

  if (tid < kProducers) {
    // -- producers: images in, conv1 out --------------------------------------------
    if (blockIdx.x < n_tiles) fetch_images(xs, x, blockIdx.x, batch, tid);
    for (int it = 0, tile = blockIdx.x; tile < n_tiles; ++it, tile += gridDim.x) {
      const int slot = it & 1;
      float* xt = xs + slot * kTile * kXImg;
      async_wait_all();
      // this tile's images landed, and every producer is done with the other slot
      bar_sync(kProducerBar, kProducers);
      if (tile + gridDim.x < n_tiles)
        fetch_images(xs + (slot ^ 1) * kTile * kXImg, x, tile + gridDim.x, batch, tid);
      for (int i = tid; i < kTile * kXImg; i += kProducers) xt[i] = bf16_round(xt[i]);
      bar_sync(kProducerBar, kProducers);
      if (it >= 2) bar_sync(kEmpty + slot, kThreads);  // the consumers are done with the slot
      conv1_tile(h1 + slot * kTile * kH1Img, xt, w1s, b1s, tid);
      bar_arrive(kFull + slot, kThreads);
    }
  } else {
    // -- consumers: conv2, dense and softmax of the tile before ---------------------
    const int ct = tid - kProducers, warp = ct / 32, lane = ct % 32;
    const int g = lane / 4, t4 = lane % 4;
    for (int it = 0, tile = blockIdx.x; tile < n_tiles; ++it, tile += gridDim.x) {
      const int slot = it & 1;
      const int n_img = min(kTile, batch - tile * kTile);
      bar_sync(kFull + slot, kThreads);
      // conv2 + relu + floor pool 11->5 into h2 (bf16, NHWC flatten order)
      const __nv_bfloat16* maps = h1 + slot * kTile * kH1Img;
      // pairs of m16 tiles (a last tile past kUnits2 reads clamped rows
      // and stores nothing)
      for (int u = 2 * warp; u < kUnits2; u += 2 * kConsumerWarps) {
        float acc[2][8][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
        conv2_pair(acc, pool_row_bf16<kSide, 5, kPixH, kH1Img>(maps, u, lane, kPooled2),
                   pool_row_bf16<kSide, 5, kPixH, kH1Img>(maps, u + 1, lane, kPooled2), w2s,
                   lane);
        pool_store_bf16<5, 8, 64, kH2Img>(acc[0], h2, b2s, u, lane, kPooled2);
        pool_store_bf16<5, 8, 64, kH2Img>(acc[1], h2, b2s, u + 1, lane, kPooled2);
      }
      if (tile + 2 * gridDim.x < n_tiles) bar_arrive(kEmpty + slot, kThreads);
      bar_sync(kConsumerBar, kConsumers);
      // dense 1600->10 on the tensor cores: rows are the tile's images
      // (rows past kTile repeat the last), warp w takes k-steps 25 w ..
      float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const int arow = min((lane % 8) + 8 * ((lane / 8) % 2), kTile - 1);
      const __nv_bfloat16* a0 = h2 + arow * kH2Img + 8 * (lane / 16);
      constexpr int kSteps = kWdSteps / kDenseWarps;
      for (int ks = warp * kSteps; warp < kDenseWarps && ks < (warp + 1) * kSteps; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, a0 + 16 * ks);
        const uint2 b0 = wds[(ks * 2) * 32 + lane], b1v = wds[(ks * 2 + 1) * 32 + lane];
        mma_bf16(d[0], a, b0.x, b0.y);
        mma_bf16(d[1], a, b1v.x, b1v.y);
      }
      if (warp < kDenseWarps && g < kTile) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = 8 * nt + 2 * t4 + e;
            if (n < 10) part[(warp * kTile + g) * 10 + n] = d[nt][e];
          }
      }
      bar_sync(kConsumerBar, kConsumers);
      if (ct < kTile * 10) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kDenseWarps; ++w) s += part[w * kTile * 10 + ct];
        logit[ct] = s + bds[ct % 10];
      }
      bar_sync(kConsumerBar, kConsumers);
      if (warp < n_img) {
        const float v = lane < 10 ? logit[warp * 10 + lane] : -INFINITY;
        float m = v;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        const float e = lane < 10 ? expf(v - m) : 0.f;
        float s = e;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane < 10) out[static_cast<size_t>(tile * kTile + warp) * 10 + lane] = e / s;
      }
    }
  }
}

// out[i] = bf16_product(bf16(a[i]), bf16(b[i])): the conv1 product alone,
// for the tests that hold it to the correctly rounded product.
__global__ void bf16_products_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                     float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = bf16_product(bf16_round(a[i]), bf16_round(b[i]));
}

}  // namespace

extern "C" int tip_mnist_forward_bf16(const float* x, const float* w1, const float* b1,
                                      const void* w2f, const float* b2, const float* wd,
                                      const float* bd, float* out, int batch, int grid,
                                      void* stream) {
  static std::atomic<unsigned long long> attribute_set{0};
  cudaError_t err = max_dynamic_smem_once(mnist_forward_bf16_kernel, kSmemBytes, attribute_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  mnist_forward_bf16_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x, w1, b1, static_cast<const uint2*>(w2f), b2, wd, bd, out, batch);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tip_bf16_products(const float* a, const float* b, float* out, int n,
                                 void* stream) {
  bf16_products_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(a, b,
                                                                                        out, n);
  return static_cast<int>(cudaGetLastError());
}
