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
// What bounds it: operations. An image costs 2.07 M multiply-adds at the
// positions the pools keep (conv1 0.19 M on the FMAs, conv2 1.84 M on the
// tensor cores in bf16, dense 0.016 M on the FMAs) against 3.1 KB read and
// 40 B written.
//
// The design, simple on purpose:
// - A persistent block (8 warps) walks tiles of kTile = 8 images. conv2's
//   weights (36 KB of bf16 fragments from fused_forward.bf16_fragments)
//   and conv1's are loaded into shared memory once a block.
// - Per tile: (1) the images, rounded to bfloat16 as they are read;
//   (2) conv1 + relu + pool on the FMAs, a thread owning 4 channels of one
//   pooled position, stored as bf16 maps [13*13 px][40] (32 channels and 8
//   of padding, so that the 8 rows of an ldmatrix phase fall in different
//   16-byte bank groups); (3) conv2 on mma.sync.m16n8k16 at the 10x10
//   positions the floor pool keeps, a warp's unit one m16 tile (4 pooled
//   positions x 4 pool taps, bf16_mma.cuh) times all 64 channels, the pool
//   a max over a lane's rows and one shuffle, stored as bf16 [5][5][64]
//   (NHWC flatten order); (4) dense on the FMAs (thread tid sums inputs
//   tid, tid + 256, ...; warp and block reductions) and the softmax, one
//   warp an image.
// - relu(max(a) + b) equals max(relu(a + b)) exactly (rounding is
//   monotone), so bias and relu are applied once per pooled value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 8;              // images a tile
constexpr int kPixH = 40;             // bf16 a pixel of the pooled conv1 maps
constexpr int kH1Img = 169 * kPixH;   // bf16 an image: [13*13 px][40]
constexpr int kXImg = 784;            // floats an image
constexpr int kH2Img = 1600;          // bf16 an image: [5][5][64]
constexpr int kPooled2 = kTile * 25;
constexpr int kUnits2 = kPooled2 / 4;  // 50 m16 tiles
constexpr int kW2Frags = 18 * 8 * 32;  // uint2: [18 k-steps][8 n-tiles][32 lanes]

// Shared-memory layout in bytes.
constexpr int kW2 = 0;
constexpr int kH1 = kW2 + kW2Frags * 8;
constexpr int kX = kH1 + kTile * kH1Img * 2;
constexpr int kH2 = kX + kTile * kXImg * 4;
constexpr int kW1 = kH2 + kTile * kH2Img * 2;  // [9][32] floats, bf16-rounded
constexpr int kB1 = kW1 + 288 * 4;
constexpr int kB2 = kB1 + 32 * 4;
constexpr int kBd = kB2 + 64 * 4;
constexpr int kPart = kBd + 16 * 4;             // dense partials [8 warps][kTile * 10]
constexpr int kLogit = kPart + kWarps * kTile * 10 * 4;
constexpr int kSmemBytes = kLogit + kTile * 10 * 4;
static_assert(kSmemBytes <= 232448, "a block's shared memory");
static_assert(kH1 % 16 == 0 && kX % 16 == 0 && kH2 % 16 == 0 && kW1 % 16 == 0, "alignment");
static_assert(kTile <= kWarps && kPooled2 % 4 == 0, "softmax: one warp an image");

__global__ void __launch_bounds__(kThreads, 1)
mnist_forward_bf16_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                          const float* __restrict__ b1, const uint2* __restrict__ w2f,
                          const float* __restrict__ b2, const float* __restrict__ wd,
                          const float* __restrict__ bd, float* __restrict__ out, int batch) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* w2s = reinterpret_cast<uint2*>(smem + kW2);
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
  const int warp = tid / 32, lane = tid % 32;

  {
    const uint4* src = reinterpret_cast<const uint4*>(w2f);
    uint4* dst = reinterpret_cast<uint4*>(w2s);
    for (int i = tid; i < kW2Frags / 2; i += kThreads) dst[i] = src[i];
  }
  for (int i = tid; i < 288; i += kThreads) w1s[i] = bf16_round(w1[i]);
  for (int i = tid; i < 32; i += kThreads) b1s[i] = b1[i];
  for (int i = tid; i < 64; i += kThreads) b2s[i] = b2[i];
  for (int i = tid; i < 10; i += kThreads) bds[i] = bd[i];

  const int n_tiles = (batch + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int img0 = tile * kTile;
    const int n_img = min(kTile, batch - img0);
    __syncthreads();  // the weights landed; the last tile's scratch is free
    // 1. the images, rounded to bfloat16 (zeros past the batch)
    for (int i = tid; i < kTile * kXImg; i += kThreads)
      xs[i] = i < n_img * kXImg ? bf16_round(x[static_cast<size_t>(img0) * kXImg + i]) : 0.f;
    __syncthreads();

    // 2. conv1 + relu + pool 26->13: this thread's channels are cq * 4 .. + 3
    {
      const int cq = tid % 8;
      float4 w1r[9];
#pragma unroll
      for (int e = 0; e < 9; ++e) w1r[e] = *reinterpret_cast<const float4*>(w1s + e * 32 + cq * 4);
      const float4 b1r = *reinterpret_cast<const float4*>(b1s + cq * 4);
      for (int item = tid; item < kTile * 169 * 8; item += kThreads) {
        const int p = item / 8;
        const int im = p / 169, pp = p % 169;
        const int py = pp / 13, px = pp % 13;
        const float* xi = xs + im * kXImg + (2 * py) * 28 + 2 * px;
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
            // the bfloat16 product, then the float32 sum, in (dy, dx) order
            const float v = patch[ty + e / 3][tx + e % 3];
            acc[0] = __fadd_rn(acc[0], bf16_round(__fmul_rn(v, w1r[e].x)));
            acc[1] = __fadd_rn(acc[1], bf16_round(__fmul_rn(v, w1r[e].y)));
            acc[2] = __fadd_rn(acc[2], bf16_round(__fmul_rn(v, w1r[e].z)));
            acc[3] = __fadd_rn(acc[3], bf16_round(__fmul_rn(v, w1r[e].w)));
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) best[c] = fmaxf(best[c], acc[c]);
        }
        *reinterpret_cast<uint2*>(h1 + im * kH1Img + pp * kPixH + cq * 4) =
            make_uint2(pack_bf16(fmaxf(best[0] + b1r.x, 0.f), fmaxf(best[1] + b1r.y, 0.f)),
                       pack_bf16(fmaxf(best[2] + b1r.z, 0.f), fmaxf(best[3] + b1r.w, 0.f)));
      }
    }
    __syncthreads();

    // 3. conv2 + relu + floor pool 11->5 into h2 (bf16, NHWC flatten order)
    for (int u = warp; u < kUnits2; u += kWarps) {
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      const __nv_bfloat16* row = pool_row_bf16<13, 5, kPixH, kH1Img>(h1, u, lane, kPooled2);
      conv_tile_bf16<13, kPixH, 32, 8, 8>(acc, row, w2s, 0, lane);
      pool_store_bf16<5, 8, 64, kH2Img>(acc, h2, b2s, u, lane, kPooled2);
    }
    __syncthreads();

    // 4. dense 1600->10 (bf16 operands, float32 sums) and softmax
    {
      float lg[kTile][10];
#pragma unroll
      for (int im = 0; im < kTile; ++im)
#pragma unroll
        for (int j = 0; j < 10; ++j) lg[im][j] = 0.f;
      for (int k = tid; k < 1600; k += kThreads) {
        float w[10];
#pragma unroll
        for (int j = 0; j < 10; ++j) w[j] = bf16_round(__ldg(wd + k * 10 + j));
#pragma unroll
        for (int im = 0; im < kTile; ++im) {
          const float h = __bfloat162float(h2[im * kH2Img + k]);
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
          if (lane == 0) part[warp * kTile * 10 + im * 10 + j] = s;
        }
    }
    __syncthreads();
    if (tid < kTile * 10) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += part[w * kTile * 10 + tid];
      logit[tid] = s + bds[tid % 10];
    }
    __syncthreads();
    if (warp < n_img) {
      const float v = lane < 10 ? logit[warp * 10 + lane] : -INFINITY;
      float m = v;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const float e = lane < 10 ? expf(v - m) : 0.f;
      float s = e;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane < 10) out[static_cast<size_t>(img0 + warp) * 10 + lane] = e / s;
    }
  }
}

}  // namespace

extern "C" int tip_mnist_forward_bf16(const float* x, const float* w1, const float* b1,
                                      const void* w2f, const float* b2, const float* wd,
                                      const float* bd, float* out, int batch, int grid,
                                      void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mnist_forward_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  mnist_forward_bf16_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x, w1, b1, static_cast<const uint2*>(w2f), b2, wd, bd, out, batch);
  return static_cast<int>(cudaGetLastError());
}
