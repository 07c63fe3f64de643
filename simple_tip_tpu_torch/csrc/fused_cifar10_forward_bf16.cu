// Fused CIFAR-10 inference forward in the bf16 scoring mode, for Hopper
// (sm_90a): bfloat16 operands on the tensor cores, float32 sums.
//
// Replaces the Pallas TPU kernel simple_tip_tpu/ops/fused_forward.py
// `_cifar_kernel` with cdt = bfloat16 (entry `fused_cifar10_probs`): conv1
// 3x3 3->32 + relu, max-pool 30->15, conv2 3x3 32->64 + relu, floor
// max-pool 13->6, conv3 3x3 64->64 + relu, NHWC flatten to 1024, dense
// [1024,64] + relu, dense [64,10], softmax. NHWC float32 input [B,32,32,3],
// float32 probabilities out [B,10].
//
// The TPU kernel's rounding points, kept here (every rounding to nearest
// even): x rounded to bfloat16; the three convolutions as im2col products
// of bfloat16 operands with float32 sums, float32 bias and relu; each pool
// in float32, then rounded to bfloat16; the conv3 output rounded to
// bfloat16 for dense1 (float32 sums, bias, relu), whose output is rounded
// again for dense2; float32 bias and softmax.
//
// What bounds it: operations. An image costs 4.09 M multiply-adds at the
// positions the pools keep (conv1 0.78 M, conv2 2.65 M, conv3 0.59 M on the
// tensor cores in bf16; the dense layers 0.07 M on the FMAs) against 12 KB
// read and 40 B written.
//
// The design, simple on purpose: a persistent block (8 warps) walks tiles
// of kTile = 4 images, conv1's and conv2's weights (bf16 fragments from
// fused_forward.bf16_fragments, K of conv1 padded 27 -> 32) resident in
// shared memory, conv3's (74 KB) read from L2 (read-only path). Per tile:
//   1. the images, rounded to bfloat16;
//   2. conv1 on mma.sync.m16n8k16 into the pooled [15,15,32] maps: a warp's
//      unit is one m16 tile (4 pooled positions x 4 pool taps, as
//      bf16_mma.cuh's pooled convolutions), its A fragments gathered from
//      the images (K in (dy, dx, c) order: three runs of 9 contiguous values
//      a row, zeros for k >= 27);
//   3. conv2 (bf16_mma.cuh) at the 12x12 positions the floor pool keeps,
//      into [6,6,64] maps;
//   4. conv3 (K = 576, N = 64) into the [4,4,64] flatten, one m16 tile an
//      image: warp w takes image w % 4 and n-tiles 4 (w / 4) .. + 3;
//   5. dense1 on the FMAs (thread (quarter, j) sums a quarter of K for all
//      4 images, each wd1 weight read once a tile), dense2 and the softmax
//      one warp per image.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 4;               // images a tile
constexpr int kXImg = 3072;            // bf16 an image [32][32][3]
constexpr int kPix1 = 40;              // bf16 a pixel of the pooled conv1 maps (32 + 8)
constexpr int kH1Img = 225 * kPix1;    // [15*15 px][40]
constexpr int kPix2 = 72;              // bf16 a pixel of the pooled conv2 maps (64 + 8)
constexpr int kH2Img = 36 * kPix2;     // [6*6 px][72]
constexpr int kPooled1 = kTile * 225, kUnits1 = kPooled1 / 4;      // 225 m16 tiles
constexpr int kPooled2 = kTile * 36, kUnits2 = kPooled2 / 4;       // 36 m16 tiles
constexpr int kW1Frags = 2 * 4 * 32, kW2Frags = 18 * 8 * 32;      // uint2

// Shared-memory layout in bytes.
constexpr int kW2 = 0;
constexpr int kW1 = kW2 + kW2Frags * 8;
constexpr int kX = kW1 + kW1Frags * 8;
constexpr int kH1 = kX + kTile * kXImg * 2;
constexpr int kH2 = kH1 + kTile * kH1Img * 2;
constexpr int kH3 = kH2 + kTile * kH2Img * 2;      // conv3 out, bf16 [kTile][1024]
constexpr int kPart = kH3 + kTile * 1024 * 2;       // dense1 partials [4][kTile][64]
constexpr int kHd = kPart + 4 * kTile * 64 * 4;     // dense1 out, bf16-rounded floats
constexpr int kB1 = kHd + kTile * 64 * 4;
constexpr int kB2 = kB1 + 32 * 4;
constexpr int kB3 = kB2 + 64 * 4;
constexpr int kBd1 = kB3 + 64 * 4;
constexpr int kWd2 = kBd1 + 64 * 4;                 // [64][10], bf16-rounded floats
constexpr int kBd2 = kWd2 + 640 * 4;
constexpr int kSmemBytes = kBd2 + 16 * 4;
static_assert(kSmemBytes <= 232448, "a block's shared memory");
static_assert(kX % 16 == 0 && kH1 % 16 == 0 && kH2 % 16 == 0 && kH3 % 16 == 0, "alignment");
static_assert(kTile * 2 == kWarps && kThreads == kTile * 64, "conv3 and dense1 mappings");

// conv1's im2col offset (bf16) of k = (dy, dx, c) from a row's pixel, and
// whether k is a real index (k < 27) or padding.
__device__ __forceinline__ int conv1_koff(int k) { return (k / 9) * 96 + k % 9; }

__device__ __forceinline__ uint32_t pack_raw(const uint16_t* x, int base, int k) {
  const uint32_t lo = k < 27 ? x[base + conv1_koff(k)] : 0u;
  const uint32_t hi = k + 1 < 27 ? x[base + conv1_koff(k + 1)] : 0u;
  return lo | (hi << 16);
}

__global__ void __launch_bounds__(kThreads, 1)
cifar10_forward_bf16_kernel(const float* __restrict__ x, const uint2* __restrict__ w1f,
                            const float* __restrict__ b1, const uint2* __restrict__ w2f,
                            const float* __restrict__ b2, const uint2* __restrict__ w3f,
                            const float* __restrict__ b3, const float* __restrict__ wd1,
                            const float* __restrict__ bd1, const float* __restrict__ wd2,
                            const float* __restrict__ bd2, float* __restrict__ out,
                            int batch) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* w2s = reinterpret_cast<uint2*>(smem + kW2);
  uint2* w1s = reinterpret_cast<uint2*>(smem + kW1);
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem + kX);
  __nv_bfloat16* h1 = reinterpret_cast<__nv_bfloat16*>(smem + kH1);
  __nv_bfloat16* h2 = reinterpret_cast<__nv_bfloat16*>(smem + kH2);
  __nv_bfloat16* h3 = reinterpret_cast<__nv_bfloat16*>(smem + kH3);
  float* part = reinterpret_cast<float*>(smem + kPart);
  float* hd = reinterpret_cast<float*>(smem + kHd);
  float* b1s = reinterpret_cast<float*>(smem + kB1);
  float* b2s = reinterpret_cast<float*>(smem + kB2);
  float* b3s = reinterpret_cast<float*>(smem + kB3);
  float* bd1s = reinterpret_cast<float*>(smem + kBd1);
  float* wd2s = reinterpret_cast<float*>(smem + kWd2);
  float* bd2s = reinterpret_cast<float*>(smem + kBd2);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;

  {
    const uint4* src = reinterpret_cast<const uint4*>(w2f);
    uint4* dst = reinterpret_cast<uint4*>(w2s);
    for (int i = tid; i < kW2Frags / 2; i += kThreads) dst[i] = src[i];
    for (int i = tid; i < kW1Frags; i += kThreads) w1s[i] = w1f[i];
  }
  for (int i = tid; i < 32; i += kThreads) b1s[i] = b1[i];
  for (int i = tid; i < 64; i += kThreads) {
    b2s[i] = b2[i];
    b3s[i] = b3[i];
    bd1s[i] = bd1[i];
  }
  for (int i = tid; i < 640; i += kThreads) wd2s[i] = bf16_round(wd2[i]);
  for (int i = tid; i < 10; i += kThreads) bd2s[i] = bd2[i];

  const int n_tiles = (batch + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int img0 = tile * kTile;
    const int n_img = min(kTile, batch - img0);
    __syncthreads();  // the weights landed; the last tile's scratch is free
    // 1. the images as bfloat16 bits (zeros past the batch)
    for (int i = tid; i < kTile * kXImg; i += kThreads)
      xs[i] = i < n_img * kXImg
                  ? static_cast<uint16_t>(bf16_bits(x[static_cast<size_t>(img0) * kXImg + i]))
                  : static_cast<uint16_t>(0);
    __syncthreads();

    // 2. conv1 + relu + pool 30->15 into h1
    for (int u = warp; u < kUnits1; u += kWarps) {
      int base[2];  // rows g and g + 8: this pooled position at pool taps (0|1, g % 2)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int pq = u * 4 + g / 2;
        const int im = pq / 225, q = pq % 225;
        const int y = 2 * (q / 15) + half, xx = 2 * (q % 15) + g % 2;
        base[half] = im * kXImg + (y * 32 + xx) * 3;
      }
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int k0 = 16 * ks + 2 * t4;
        const uint32_t a[4] = {pack_raw(xs, base[0], k0), pack_raw(xs, base[1], k0),
                               pack_raw(xs, base[0], k0 + 8), pack_raw(xs, base[1], k0 + 8)};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint2 b = w1s[(ks * 4 + j) * 32 + lane];
          mma_bf16(acc[j], a, b.x, b.y);
        }
      }
      pool_store_bf16<15, 4, kPix1, kH1Img>(acc, h1, b1s, u, lane, kPooled1);
    }
    __syncthreads();

    // 3. conv2 + relu + floor pool 13->6 into h2
    for (int u = warp; u < kUnits2; u += kWarps) {
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      const __nv_bfloat16* row = pool_row_bf16<15, 6, kPix1, kH1Img>(h1, u, lane, kPooled2);
      conv_tile_bf16<15, kPix1, 32, 8, 8>(acc, row, w2s, 0, lane);
      pool_store_bf16<6, 8, kPix2, kH2Img>(acc, h2, b2s, u, lane, kPooled2);
    }
    __syncthreads();

    // 4. conv3 + relu into h3 (bf16, NHWC flatten order): image warp % 4,
    // n-tiles 4 (warp / 4) .. + 3
    {
      const int im = warp % kTile, nt0 = 4 * (warp / kTile);
      const int r = (lane % 8) + 8 * ((lane / 8) % 2);  // this lane's ldmatrix row: position r
      const __nv_bfloat16* row = h2 + im * kH2Img + ((r / 4) * 6 + r % 4) * kPix2 + (lane / 16) * 8;
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      conv_tile_bf16<6, kPix2, 64, 4, 8>(acc, row, w3f, nt0, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 8 * (nt0 + j) + 2 * t4;
        *reinterpret_cast<uint32_t*>(h3 + im * 1024 + g * 64 + n) =
            pack_bf16(fmaxf(acc[j][0] + b3s[n], 0.f), fmaxf(acc[j][1] + b3s[n + 1], 0.f));
        *reinterpret_cast<uint32_t*>(h3 + im * 1024 + (g + 8) * 64 + n) =
            pack_bf16(fmaxf(acc[j][2] + b3s[n], 0.f), fmaxf(acc[j][3] + b3s[n + 1], 0.f));
      }
    }
    __syncthreads();

    // 5. dense1 1024->64: thread (kq, j) sums k in [256 kq, 256 kq + 256)
    {
      const int kq = tid / 64, j = tid % 64;
      float s[kTile] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 256 * kq; k < 256 * kq + 256; ++k) {
        const float w = bf16_round(__ldg(wd1 + k * 64 + j));
#pragma unroll
        for (int im = 0; im < kTile; ++im)
          s[im] = fmaf(__bfloat162float(h3[im * 1024 + k]), w, s[im]);
      }
#pragma unroll
      for (int im = 0; im < kTile; ++im) part[(kq * kTile + im) * 64 + j] = s[im];
    }
    __syncthreads();
    {
      const int im = tid / 64, j = tid % 64;
      float s = 0.f;
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) s += part[(kq * kTile + im) * 64 + j];
      hd[im * 64 + j] = bf16_round(fmaxf(s + bd1s[j], 0.f));
    }
    __syncthreads();

    // 6. dense2 64->10 and softmax: warp im handles image im
    if (warp < n_img) {
      float v = -INFINITY;
      if (lane < 10) {
        float s = 0.f;
        for (int k = 0; k < 64; ++k) s = fmaf(hd[warp * 64 + k], wd2s[k * 10 + lane], s);
        v = s + bd2s[lane];
      }
      float m = v;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const float e = lane < 10 ? expf(v - m) : 0.f;
      float sum = e;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane < 10) out[static_cast<size_t>(img0 + warp) * 10 + lane] = e / sum;
    }
  }
}

}  // namespace

extern "C" int tip_cifar10_forward_bf16(const float* x, const void* w1f, const float* b1,
                                        const void* w2f, const float* b2, const void* w3f,
                                        const float* b3, const float* wd1, const float* bd1,
                                        const float* wd2, const float* bd2, float* out,
                                        int batch, int grid, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      cifar10_forward_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cifar10_forward_bf16_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const uint2*>(w1f), b1, static_cast<const uint2*>(w2f), b2,
      static_cast<const uint2*>(w3f), b3, wd1, bd1, wd2, bd2, out, batch);
  return static_cast<int>(cudaGetLastError());
}
