// Fused MNIST/FMNIST inference forward for Hopper (sm_90a), float32-accurate
// conv2 on the tensor cores.
//
// Replaces the Pallas TPU kernel simple_tip_tpu/ops/fused_forward.py
// `_mnist_kernel`: conv1 3x3 1->32 + relu, max-pool 26->13, conv2 3x3
// 32->64 + relu, floor max-pool 11->5, dense [1600,10] + bias, softmax.
// NHWC input [B,28,28,1], probabilities out [B,10].
//
// What bounds it on this card: operations. Counted at the positions the
// pools keep, an image costs 2.07 M FMAs (conv1 0.19 M, conv2 1.84 M at the
// 10x10 positions the floor pool keeps, dense 0.016 M) against 3.1 KB read
// and 40 B written. conv2, an im2col product [100 rows, 288] @ [288, 64]
// an image, runs on the tensor cores in 3xTF32 (three TF32 products at 495
// TF/s); conv1 (K = 9) and the dense layer on the float32 FMAs.
//
// What the design does:
// - A persistent block walks tiles of kTile = 5 images: the pooled conv1
//   maps (21.6 KB an image, 24.3 KB padded), the images and the pooled conv2
//   maps of 5 images, beside a 32 KB weight ring, fill the 227 KB. Per tile:
//   1. conv1 + relu + pool on the FMAs: a thread owns 4 channels (their 36
//      weights in registers) of one pooled position, reads its 4x4 input
//      patch once and keeps the 4 window taps' sums;
//   2. conv2 (pool_conv_tc.cuh) on mma.sync.m16n8k8 TF32 tiles in 3xTF32
//      (a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, each 8-deep k-step summed
//      from zero and added to the f32 accumulator: the tensor cores round
//      their sums toward zero; the products of 8 independent tiles
//      interleaved so that none waits on the one before it), evaluated only
//      at the 10x10 positions the floor pool keeps, into the pooled [5,5,64]
//      maps (NHWC flatten order);
//      its weights (147 KB as TF32 hi/lo, fragment order from
//      fused_forward.tf32_fragments) stream through a two-stage cp.async
//      ring in 9 chunks of 16 KB, the next chunk (of this tile or the next)
//      loading while this one is multiplied; the next tile's images load
//      during conv2;
//   3. dense reads wd from L2 (read-only path), once a tile: a thread sums
//      its inputs' share of all 50 (image, class) logits, a warp reduces
//      them with shuffles and the block sums the 8 warps; softmax one warp
//      an image.
// - relu(max(a) + b) equals max(relu(a + b)) exactly (rounding is
//   monotone), so bias and relu are applied once per pooled value.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pool_conv_tc.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 32 * kWarps;  // 8 warps (pool_conv_tc.cuh)
constexpr int kTile = 5;       // images a tile
constexpr int kChunk = 4096;   // floats of a weight chunk: [4 k-steps][8 n-tiles][32][4]
constexpr int kChunks = 9;

// Shared-memory layout in floats.
constexpr int kXImg = 784;          // image [28][28]
constexpr int kH1Img = 169 * kPix;  // pooled conv1 [13*13 px][36]
constexpr int kH2Img = 1600;        // pooled conv2 [5][5][64]
constexpr int kX = 0;
constexpr int kH1 = kX + kTile * kXImg;
constexpr int kH2 = kH1 + kTile * kH1Img;
constexpr int kRing = kH2 + kTile * kH2Img;
constexpr int kW1 = kRing + 2 * kChunk;  // [9][32]
constexpr int kB1 = kW1 + 288;
constexpr int kB2 = kB1 + 32;
constexpr int kBd = kB2 + 64;             // [10], padded to 16
constexpr int kPart = kBd + 16;           // dense partials [8 warps][kTile * 10]
constexpr int kLogit = kPart + 8 * kTile * 10;  // [kTile * 10], padded to 64
constexpr int kSmemFloats = kLogit + 64;
constexpr int kSmemBytes = kSmemFloats * 4;
static_assert(kSmemBytes <= 232448, "a block's shared memory");
static_assert(kH1 % 4 == 0 && kH1Img % 4 == 0 && kRing % 4 == 0, "16-byte rows");

constexpr int kPooled2 = kTile * 25;
constexpr int kUnits2 = (kPooled2 + 3) / 4;  // 32 m-tiles
constexpr int kUpw2 = (kUnits2 + kWarps - 1) / kWarps;  // 4 a warp

__global__ void __launch_bounds__(kThreads, 1)
mnist_forward_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2f,
                     const float* __restrict__ b2, const float* __restrict__ wd,
                     const float* __restrict__ bd, float* __restrict__ out, int batch) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  for (int i = tid; i < 9 * 32; i += kThreads) smem[kW1 + i] = w1[i];
  for (int i = tid; i < 32; i += kThreads) smem[kB1 + i] = b1[i];
  for (int i = tid; i < 64; i += kThreads) smem[kB2 + i] = b2[i];
  for (int i = tid; i < 10; i += kThreads) smem[kBd + i] = bd[i];
  __syncthreads();
  const int n_tiles = (batch + kTile - 1) / kTile;
  const int my_tiles =
      n_tiles > static_cast<int>(blockIdx.x) ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int n_steps = my_tiles * kChunks;

  auto load_chunk = [&](int f) {  // chunk f % 9 of w2 into ring stage f % 2
    if (f < n_steps) {
      const float* src = w2f + (f % kChunks) * kChunk;
      float* dst = smem + kRing + (f % 2) * kChunk;
      for (int i = tid; i < kChunk / 4; i += kThreads) cp_async16(dst + 4 * i, src + 4 * i, true);
    }
    cp_async_commit();
  };
  auto load_x = [&](int mine) {  // the images of tile number `mine` (zeros past the batch)
    if (mine < my_tiles) {
      const int img0 = (blockIdx.x + mine * gridDim.x) * kTile;
      const int n4 = min(kTile, batch - img0) * (kXImg / 4);
      const float* src = x + static_cast<size_t>(img0) * kXImg;
      for (int i = tid; i < kTile * kXImg / 4; i += kThreads)
        cp_async16(smem + kX + 4 * i, i < n4 ? src + 4 * i : x, i < n4);
    }
    cp_async_commit();
  };

  int base2[kUpw2];
  pool_conv_rows<13, 5, kH1Img, kUpw2>(base2, warp, lane, kPooled2);

  load_x(0);
  load_chunk(0);
  for (int mine = 0; mine < my_tiles; ++mine) {
    const int img0 = (blockIdx.x + mine * gridDim.x) * kTile;
    const int n_img = min(kTile, batch - img0);
    cp_async_wait<0>();
    __syncthreads();  // the images and the tile's first chunk landed

    // 1. conv1 + relu + pool 26->13 into h1. This thread's channels are
    // cq * 4 .. + 3 (kThreads % 8 == 0, so cq is the same for all of its
    // items), their 9 x 4 weights read into registers for conv1 alone.
    const int cq = tid % 8;
    float4 w1r[9];
#pragma unroll
    for (int e = 0; e < 9; ++e)
      w1r[e] = *reinterpret_cast<const float4*>(smem + kW1 + e * 32 + cq * 4);
    const float4 b1r = *reinterpret_cast<const float4*>(smem + kB1 + cq * 4);
    for (int item = tid; item < kTile * 169 * 8; item += kThreads) {
      const int p = item / 8;  // (image, pooled position)
      const int im = p / 169, pp = p % 169;
      const int py = pp / 13, px = pp % 13;
      const float* xi = smem + kX + im * kXImg + (2 * py) * 28 + 2 * px;
      float patch[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) patch[a][c] = xi[a * 28 + c];
      float best[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
      for (int tap = 0; tap < 4; ++tap) {
        const int ty = tap / 2, tx = tap % 2;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 9; ++e) {
          const float v = patch[ty + e / 3][tx + e % 3];
          acc[0] = fmaf(v, w1r[e].x, acc[0]);
          acc[1] = fmaf(v, w1r[e].y, acc[1]);
          acc[2] = fmaf(v, w1r[e].z, acc[2]);
          acc[3] = fmaf(v, w1r[e].w, acc[3]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) best[c] = fmaxf(best[c], acc[c]);
      }
      *reinterpret_cast<float4*>(smem + kH1 + im * kH1Img + pp * kPix + cq * 4) =
          make_float4(fmaxf(best[0] + b1r.x, 0.f), fmaxf(best[1] + b1r.y, 0.f),
                      fmaxf(best[2] + b1r.z, 0.f), fmaxf(best[3] + b1r.w, 0.f));
    }
    __syncthreads();

    // 2. conv2 + relu + floor pool 11->5 into h2.
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
      for (int c = 0; c < kChunks; ++c) {
        const int f = mine * kChunks + c;
        load_chunk(f + 1);  // the other stage was released by the barrier ending step f - 1
        cp_async_wait<1>();
        __syncthreads();  // chunk f (and, from c = 1, the next tile's images) landed
        if (c == 0) load_x(mine + 1);  // conv1 is done with the images
        pool_conv_chunk<13, kUpw2>(acc, base2, smem + kH1, smem + kRing + (f % 2) * kChunk, c,
                                   warp, lane, kUnits2);
        if (c == kChunks - 1)
          pool_conv_store<5, kUpw2, 64, kH2Img>(acc, smem + kH2, smem + kB2, warp, lane,
                                                kUnits2, kPooled2);
        __syncthreads();  // stage f % 2 is free again
      }
    }

    // 3. dense 1600->10: thread tid sums inputs tid, tid + 256, ... of every
    // (image, class), each wd row read once a tile.
    {
      float lg[kTile][10];
#pragma unroll
      for (int im = 0; im < kTile; ++im)
#pragma unroll
        for (int j = 0; j < 10; ++j) lg[im][j] = 0.f;
#pragma unroll
      for (int it = 0; it < (1600 + kThreads - 1) / kThreads; ++it) {
        const int k = tid + it * kThreads;
        if (k >= 1600) break;
        float w[10];
        const float2* wr = reinterpret_cast<const float2*>(wd + k * 10);
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          const float2 v = __ldg(wr + j);
          w[2 * j] = v.x;
          w[2 * j + 1] = v.y;
        }
#pragma unroll
        for (int im = 0; im < kTile; ++im) {
          const float h = smem[kH2 + im * kH2Img + k];
#pragma unroll
          for (int j = 0; j < 10; ++j) lg[im][j] = fmaf(h, w[j], lg[im][j]);
        }
      }
#pragma unroll
      for (int im = 0; im < kTile; ++im)
#pragma unroll
        for (int j = 0; j < 10; ++j) {
          float s = lg[im][j];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
          if (lane == 0) smem[kPart + warp * kTile * 10 + im * 10 + j] = s;
        }
    }
    __syncthreads();
    if (tid < kTile * 10) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) s += smem[kPart + w * kTile * 10 + tid];
      smem[kLogit + tid] = s + smem[kBd + tid % 10];
    }
    __syncthreads();

    // softmax over the 10 logits: warp im handles image im.
    if (warp < n_img) {
      const float v = lane < 10 ? smem[kLogit + warp * 10 + lane] : -INFINITY;
      float m = v;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const float e = lane < 10 ? expf(v - m) : 0.f;
      float s = e;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane < 10) out[static_cast<size_t>(img0 + warp) * 10 + lane] = e / s;
    }
    __syncthreads();  // the dense scratch is rewritten by the next tile
  }
  cp_async_wait<0>();
}

static_assert(kTile <= 8, "softmax: one warp an image");

}  // namespace

extern "C" int tip_mnist_forward(const float* x, const float* w1, const float* b1,
                                 const float* w2f, const float* b2, const float* wd,
                                 const float* bd, float* out, int batch, int grid,
                                 void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mnist_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  mnist_forward_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x, w1, b1, w2f, b2, wd, bd, out, batch);
  return static_cast<int>(cudaGetLastError());
}
