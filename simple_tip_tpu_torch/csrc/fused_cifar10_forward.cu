// Fused CIFAR-10 inference forward for Hopper (sm_90a), float32-accurate
// convolutions on the tensor cores.
//
// Replaces the Pallas TPU kernel simple_tip_tpu/ops/fused_forward.py
// `_cifar_kernel` (entry `fused_cifar10_probs`): conv1 3x3 3->32 + relu,
// max-pool 30->15, conv2 3x3 32->64 + relu, floor max-pool 13->6, conv3 3x3
// 64->64 + relu, NHWC flatten to 1024, dense [1024,64] + relu, dense
// [64,10], softmax. NHWC input [B,32,32,3], probabilities out [B,10].
//
// What bounds it on this card: operations. Counted at the positions the
// pools keep, an image costs 4.09 M FMAs (conv1 0.78 M, conv2 2.65 M, conv3
// 0.59 M, dense 0.07 M) against 12 KB read and 40 B written. 98% of them
// are the three convolutions, im2col products with K = 27, 288 and 576: on
// the tensor cores in 3xTF32 (three TF32 products at 495 TF/s), the dense
// layers on the float32 FMAs.
//
// What the design does:
// - Every convolution is an im2col product on mma.sync.m16n8k8 TF32 tiles in
//   3xTF32 (a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, each 8-deep k-step
//   summed from zero and added to the f32 accumulator: the tensor cores
//   round their sums toward zero), the products of 4-8 independent tiles
//   interleaved so that none waits on the one before it. A operands
//   (activations) are split into TF32 parts in registers as they are read;
//   B operands (weights) arrive split and in fragment order
//   (fused_forward.tf32_fragments), one 16-byte load a lane per k-step and
//   n-tile.
// - A persistent block walks tiles of kTile = 4 images: the pooled conv1
//   maps (28.8 KB an image, 32.4 KB padded) are what bounds the tile in 227
//   KB. Per tile:
//   1. conv1 (K = 27 padded to 32, N = 32, resident weights) from the images
//      straight into the pooled [15,15,32] maps; rows are (pooled position,
//      pool tap), so a pooled value is a max over a lane's own rows and one
//      shuffle;
//   2. conv2 (pool_conv_tc.cuh) at the 12x12 positions the floor pool keeps,
//      into [6,6,64] maps in the images' place;
//   3. conv3 (K = 576, N = 64) into [4,4,64] (NHWC flatten order), one m16
//      tile an image, in the conv1 maps' place;
//   4. dense1 reads wd1 from L2 (read-only path, 16-byte loads, 16 in flight
//      a thread), each weight used for the 4 images at once; dense2 and the
//      softmax run one warp per image.
//   conv2's and conv3's weights (147 KB and 295 KB as TF32 hi/lo) stream
//   through a two-stage cp.async ring in 27 chunks of 16 KB (4 k-steps x 64
//   channels), the next chunk (across layers and tiles) loading while this
//   one is multiplied; the next tile's images load during the dense layers.
// - relu(max(a) + b) equals max(relu(a + b)) exactly (rounding is
//   monotone), so bias and relu are applied once per pooled value.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pool_conv_tc.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 32 * kWarps;  // 8 warps (pool_conv_tc.cuh)
constexpr int kTile = 4;       // images a tile
constexpr int kChunk = 4096;   // floats of a weight chunk: [4 k-steps][8 n-tiles][32][4]
constexpr int kChunks2 = 9, kChunks = 27;  // conv2's chunks, then conv3's 18

// Shared-memory layout in floats.
constexpr int kXImg = 3072;              // image [32][32][3]; later h2 [36 px][68]
constexpr int kH2Pix = 68;               // 64 channels + 4 of padding
constexpr int kH1Img = 225 * kPix;       // pooled conv1 [15*15 px][36]
constexpr int kX = 0;
constexpr int kH1 = kX + kTile * kXImg;  // h1; later h3 [kTile][1024], dense scratch
constexpr int kRing = kH1 + kTile * kH1Img;
constexpr int kW1 = kRing + 2 * kChunk;  // conv1 fragments [4][4][32][4]
constexpr int kB1 = kW1 + 2048;
constexpr int kB2 = kB1 + 32;
constexpr int kB3 = kB2 + 64;
constexpr int kBd1 = kB3 + 64;
constexpr int kWd2 = kBd1 + 64;
constexpr int kBd2 = kWd2 + 640;
constexpr int kSmemFloats = kBd2 + 16;
constexpr int kSmemBytes = kSmemFloats * 4;
constexpr int kH3 = kH1;                       // conv3 out [kTile][1024]
constexpr int kPart = kH3 + kTile * 1024;      // dense1 partials [16][kTile][64]
constexpr int kHd = kPart + 16 * kTile * 64;   // dense1 out [kTile][64]
static_assert(36 * kH2Pix <= kXImg, "h2 fits an image's place");
static_assert(kHd + kTile * 64 <= kRing, "dense scratch fits the conv1 maps' place");
static_assert(kSmemBytes <= 232448, "a block's shared memory");

constexpr int kPooled1 = kTile * 225;          // conv1 pooled positions a tile
constexpr int kGroups1 = (kPooled1 + 7) / 8;   // 113 groups of 8
constexpr int kPooled2 = kTile * 36;
constexpr int kUnits2 = kPooled2 / 4;          // 36 m-tiles
constexpr int kUpw2 = (kUnits2 + kWarps - 1) / kWarps;  // 5 a warp at most

__global__ void __launch_bounds__(kThreads, 1)
cifar10_forward_kernel(const float* __restrict__ x, const float* __restrict__ w1f,
                       const float* __restrict__ b1, const float* __restrict__ w2f,
                       const float* __restrict__ b2, const float* __restrict__ w3f,
                       const float* __restrict__ b3, const float* __restrict__ wd1,
                       const float* __restrict__ bd1, const float* __restrict__ wd2,
                       const float* __restrict__ bd2, float* __restrict__ out, int batch) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;

  for (int i = tid; i < 32; i += kThreads) smem[kB1 + i] = b1[i];
  for (int i = tid; i < 64; i += kThreads) {
    smem[kB2 + i] = b2[i];
    smem[kB3 + i] = b3[i];
    smem[kBd1 + i] = bd1[i];
  }
  for (int i = tid; i < 640; i += kThreads) smem[kWd2 + i] = wd2[i];
  for (int i = tid; i < 10; i += kThreads) smem[kBd2 + i] = bd2[i];
  for (int i = tid; i < 512; i += kThreads)
    reinterpret_cast<float4*>(smem + kW1)[i] = __ldg(reinterpret_cast<const float4*>(w1f) + i);

  const int n_tiles = (batch + kTile - 1) / kTile;
  const int my_tiles =
      n_tiles > static_cast<int>(blockIdx.x) ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int n_steps = my_tiles * kChunks;

  // Weight chunk of step f (tile f / 27, chunk f % 27) into ring stage f % 2.
  auto load_chunk = [&](int f) {
    if (f < n_steps) {
      const int c = f % kChunks;
      const float* src = c < kChunks2 ? w2f + c * kChunk : w3f + (c - kChunks2) * kChunk;
      float* dst = smem + kRing + (f % 2) * kChunk;
      for (int i = tid; i < kChunk / 4; i += kThreads) cp_async16(dst + 4 * i, src + 4 * i, true);
    }
    cp_async_commit();
  };
  // The images of this block's tile number `mine` (zeros past the batch).
  auto load_x = [&](int mine) {
    if (mine < my_tiles) {
      const int img0 = (blockIdx.x + mine * gridDim.x) * kTile;
      const int n4 = min(kTile, batch - img0) * (kXImg / 4);
      const float* src = x + static_cast<size_t>(img0) * kXImg;
      for (int i = tid; i < kTile * kXImg / 4; i += kThreads)
        cp_async16(smem + kX + 4 * i, i < n4 ? src + 4 * i : x, i < n4);
    }
    cp_async_commit();
  };

  // conv1's A columns: k = 8 kk + t4 (+ 4) is (dy, dx, c) = (k / 9, k % 9 / 3,
  // k % 3), at offset dy * 96 + dx * 3 + c from the row's pixel; k >= 27
  // (zero weights) reads the pixel itself.
  int off1[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int k = 8 * (e / 2) + t4 + 4 * (e % 2);
    off1[e] = k < 27 ? (k / 9) * 96 + (k % 9 / 3) * 3 + k % 3 : 0;
  }
  int base2[kUpw2];
  pool_conv_rows<15, 6, kH1Img, kUpw2>(base2, warp, lane, kPooled2);
  // conv3: m-tile = image warp / 2, rows = its 16 positions, channel half warp % 2.
  const int im3 = warp / 2, nh3 = warp % 2;
  int base3;
  {
    const int r = lane % 8 + 8 * ((lane / 8) % 2);
    base3 = kX + im3 * kXImg + ((r / 4) * 6 + r % 4) * kH2Pix + (lane / 16) * 4;
  }

  load_x(0);
  load_chunk(0);
  for (int mine = 0; mine < my_tiles; ++mine) {
    const int img0 = (blockIdx.x + mine * gridDim.x) * kTile;
    const int n_img = min(kTile, batch - img0);
    cp_async_wait<0>();
    __syncthreads();  // the images and the tile's first chunk landed

    // 1. conv1 + relu + pool 30->15 into h1.
    for (int grp = warp; grp < kGroups1; grp += kWarps) {
      float acc[2][4][4];
      int row[2][2];  // [mt][ty]: the x offset of rows g (ty 0) and g + 8 (ty 1)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int pq = min(grp * 8 + 4 * mt + g / 2, kPooled1 - 1);
        const int im = pq / 225, q = pq % 225;
        const int y = 2 * (q / 15), xx = 2 * (q % 15) + g % 2;
        row[mt][0] = kX + im * kXImg + (y * 32 + xx) * 3;
        row[mt][1] = row[mt][0] + 96;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = *reinterpret_cast<const float4*>(smem + kW1 + ((kk * 4 + j) * 32 + lane) * 4);
        uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          split_tf32_finite(smem[row[mt][0] + off1[2 * kk]], a_hi[mt][0], a_lo[mt][0]);
          split_tf32_finite(smem[row[mt][1] + off1[2 * kk]], a_hi[mt][1], a_lo[mt][1]);
          split_tf32_finite(smem[row[mt][0] + off1[2 * kk + 1]], a_hi[mt][2], a_lo[mt][2]);
          split_tf32_finite(smem[row[mt][1] + off1[2 * kk + 1]], a_hi[mt][3], a_lo[mt][3]);
        }
        mma_3xtf32_tiles<2, 4>(acc, a_hi, a_lo, b);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int pq = grp * 8 + 4 * mt + g / 2;
        const int im = pq / 225, q = pq % 225;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v0 = fmaxf(acc[mt][j][0], acc[mt][j][2]);
          float v1 = fmaxf(acc[mt][j][1], acc[mt][j][3]);
          v0 = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, 4));
          v1 = fmaxf(v1, __shfl_xor_sync(0xffffffffu, v1, 4));
          const int n = 8 * j + 2 * t4;
          if (g % 2 == 0 && pq < kPooled1) {
            *reinterpret_cast<float2*>(smem + kH1 + im * kH1Img + q * kPix + n) =
                make_float2(fmaxf(v0 + smem[kB1 + n], 0.f), fmaxf(v1 + smem[kB1 + n + 1], 0.f));
          }
        }
      }
    }
    __syncthreads();

    // 2. conv2 + relu + floor pool 13->6 into h2 (the images' place).
    {
      float acc[kUpw2][2][4][4];
#pragma unroll
      for (int i = 0; i < kUpw2; ++i)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][mt][j][e] = 0.f;
      for (int c = 0; c < kChunks2; ++c) {
        const int f = mine * kChunks + c;
        load_chunk(f + 1);  // the other stage was released by the barrier ending step f - 1
        cp_async_wait<1>();
        __syncthreads();  // chunk f landed for every thread
        pool_conv_chunk<15, kUpw2>(acc, base2, smem + kH1, smem + kRing + (f % 2) * kChunk, c,
                                   warp, lane, kUnits2);
        if (c == kChunks2 - 1)
          pool_conv_store<6, kUpw2, kH2Pix, kXImg>(acc, smem + kX, smem + kB2, warp, lane,
                                                   kUnits2, kPooled2);
        __syncthreads();  // stage f % 2 is free again
      }
    }

    // 3. conv3 + relu into h3 (NHWC flatten order; the conv1 maps' place).
    {
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      for (int c = kChunks2; c < kChunks; ++c) {
        const int f = mine * kChunks + c;
        load_chunk(f + 1);
        cp_async_wait<1>();
        __syncthreads();
        const float* stage = smem + kRing + (f % 2) * kChunk;
        const int cc = c - kChunks2, tap = cc / 2;
        const int off = ((tap / 3) * 6 + tap % 3) * kH2Pix + (cc % 2) * 32;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t a_hi[1][4], a_lo[1][4];
          ldmatrix_split(smem + base3 + off + kk * 8, a_hi[0], a_lo[0]);
          float4 b[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            b[j] = *reinterpret_cast<const float4*>(
                stage + ((kk * 8 + nh3 * 4 + j) * 32 + lane) * 4);
          mma_3xtf32_tiles<1, 4>(&acc, a_hi, a_lo, b);
        }
        if (c == kChunks - 1) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = nh3 * 32 + 8 * j + 2 * t4;
            float* h3 = smem + kH3 + im3 * 1024 + n;
            const float bn0 = smem[kB3 + n], bn1 = smem[kB3 + n + 1];
            *reinterpret_cast<float2*>(h3 + g * 64) =
                make_float2(fmaxf(acc[j][0] + bn0, 0.f), fmaxf(acc[j][1] + bn1, 0.f));
            *reinterpret_cast<float2*>(h3 + (g + 8) * 64) =
                make_float2(fmaxf(acc[j][2] + bn0, 0.f), fmaxf(acc[j][3] + bn1, 0.f));
          }
        }
        __syncthreads();
      }
    }
    load_x(mine + 1);  // h2 is consumed: the next tile's images load during the dense layers

    // 4. dense1 (wd1 from L2): thread (slice, og) sums inputs 64 slice .. + 63
    // into outputs 4 og .. 4 og + 3 of every image, 16 loads of 16 bytes in
    // flight; then the sum of the 16 slices in order, bias and relu.
    {
      const int og = tid % 16, slice = tid / 16;
      const float* h3 = smem + kH3;
      float acc[kTile][4];
#pragma unroll
      for (int im = 0; im < kTile; ++im)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[im][e] = 0.f;
#pragma unroll 16
      for (int kk = slice * 64; kk < slice * 64 + 64; ++kk) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(wd1 + kk * 64) + og);
#pragma unroll
        for (int im = 0; im < kTile; ++im) {
          const float h = h3[im * 1024 + kk];
          acc[im][0] = fmaf(h, w.x, acc[im][0]);
          acc[im][1] = fmaf(h, w.y, acc[im][1]);
          acc[im][2] = fmaf(h, w.z, acc[im][2]);
          acc[im][3] = fmaf(h, w.w, acc[im][3]);
        }
      }
#pragma unroll
      for (int im = 0; im < kTile; ++im)
        *reinterpret_cast<float4*>(smem + kPart + (slice * kTile + im) * 64 + og * 4) =
            make_float4(acc[im][0], acc[im][1], acc[im][2], acc[im][3]);
    }
    __syncthreads();
    {
      const int im = tid / 64, o = tid % 64;  // kTile * 64 == kThreads
      float s = 0.f;
#pragma unroll
      for (int slice = 0; slice < 16; ++slice) s += smem[kPart + (slice * kTile + im) * 64 + o];
      smem[kHd + im * 64 + o] = fmaxf(s + smem[kBd1 + o], 0.f);
    }
    __syncthreads();

    // dense2 + softmax: warp im handles image im.
    if (warp < n_img) {
      float logit = -INFINITY;
      if (lane < 10) {
        float s = 0.f;
        for (int kk = 0; kk < 64; ++kk) s = fmaf(smem[kHd + warp * 64 + kk], smem[kWd2 + kk * 10 + lane], s);
        logit = s + smem[kBd2 + lane];
      }
      float mx = logit;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float e = lane < 10 ? expf(logit - mx) : 0.f;
      float sum = e;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane < 10) out[static_cast<size_t>(img0 + warp) * 10 + lane] = e / sum;
    }
    __syncthreads();  // h3 and the dense scratch are rewritten by the next tile
  }
  cp_async_wait<0>();
}

static_assert(kTile * 64 == kThreads && 2 * kTile == kWarps,
              "dense1: a thread an output; conv3: a warp an (image, channel half)");

}  // namespace

extern "C" int tip_cifar10_forward(const float* x, const float* w1f, const float* b1,
                                   const float* w2f, const float* b2, const float* w3f,
                                   const float* b3, const float* wd1, const float* bd1,
                                   const float* wd2, const float* bd2, float* out, int batch,
                                   int grid, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      cifar10_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cifar10_forward_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x, w1f, b1, w2f, b2, w3f, b3, wd1, bd1, wd2, bd2, out, batch);
  return static_cast<int>(cudaGetLastError());
}
