// Fused MNIST/FMNIST inference forward for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel simple_tip_tpu/ops/fused_forward.py
// `_mnist_kernel`: conv1 3x3 1->32 + relu, max-pool 26->13, conv2 3x3
// 32->64 + relu, floor max-pool 11->5, dense [1600,10] + bias, softmax.
// NHWC input [B,28,28,1], probabilities out [B,10].
//
// What bounds it on this card: operations. One image costs ~2.4 M FMAs
// (conv2 is 90% of them) against 3.1 KB read and 40 B written, so the
// input stream is far below the memory roofline; the float32 FMA rate of
// the SMs is the limit.
//
// What the design does about it: every intermediate stays in shared memory
// (the 28x28 image, the pooled 13x13x32 map and the pooled 5x5x64 map,
// ~31 KB an image), so device memory sees only the input and the
// probabilities. All weights (~139 KB, the dense kernel transposed) are
// loaded into shared memory once per block, and each block then walks over
// images with a grid stride, so weight traffic is paid once per SM rather
// than once per image. conv2 is evaluated only at the 10x10 positions that
// the floor pool keeps, with each thread holding 4 pool windows x 4 taps of
// accumulators for one output channel; the shared-memory reads of the
// pooled map are warp-wide broadcasts and the weight reads are consecutive.
// relu(max(a_i) + b) equals max(relu(a_i + b)) exactly (rounding is
// monotone), so bias and relu are applied once per pooled value.
//
// This is the simple, exact version; conv2 and dense on tensor cores
// (bf16 wgmma) are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;

// Shared-memory layout in floats.
constexpr int kW1 = 0;               // conv1 [9][32]
constexpr int kB1 = kW1 + 9 * 32;    // [32]
constexpr int kW2 = kB1 + 32;        // conv2 im2col [288][64]
constexpr int kB2 = kW2 + 288 * 64;  // [64]
constexpr int kWd = kB2 + 64;        // dense transposed [10][1600]
constexpr int kBd = kWd + 10 * 1600; // [10], padded to 16
constexpr int kX = kBd + 16;         // image [28][28]
constexpr int kH1 = kX + 28 * 28;    // pooled conv1 [13][13][32]
constexpr int kH2 = kH1 + 13 * 13 * 32;  // pooled conv2 [5][5][64] (NHWC flatten)
constexpr int kLogit = kH2 + 1600;   // [10], padded to 16
constexpr int kSmemFloats = kLogit + 16;
constexpr int kSmemBytes = kSmemFloats * 4;

__global__ void __launch_bounds__(kThreads)
mnist_forward_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     const float* __restrict__ b2, const float* __restrict__ wd,
                     const float* __restrict__ bd, float* __restrict__ out,
                     int batch) {
  extern __shared__ float smem[];
  float* sw1 = smem + kW1;
  float* sb1 = smem + kB1;
  float* sw2 = smem + kW2;
  float* sb2 = smem + kB2;
  float* swd = smem + kWd;
  float* sbd = smem + kBd;
  float* sx = smem + kX;
  float* sh1 = smem + kH1;
  float* sh2 = smem + kH2;
  float* slogit = smem + kLogit;
  const int tid = threadIdx.x;

  for (int i = tid; i < 9 * 32; i += kThreads) sw1[i] = w1[i];
  for (int i = tid; i < 32; i += kThreads) sb1[i] = b1[i];
  for (int i = tid; i < 288 * 64; i += kThreads) sw2[i] = w2[i];
  for (int i = tid; i < 64; i += kThreads) sb2[i] = b2[i];
  for (int i = tid; i < 1600 * 10; i += kThreads) {
    swd[(i % 10) * 1600 + i / 10] = wd[i];
  }
  for (int i = tid; i < 10; i += kThreads) sbd[i] = bd[i];
  __syncthreads();

  for (int img = blockIdx.x; img < batch; img += gridDim.x) {
    const float* xi = x + static_cast<size_t>(img) * 784;
    for (int i = tid; i < 784; i += kThreads) sx[i] = xi[i];
    __syncthreads();

    // conv1 + relu + 2x2 pool: output o = (py*13 + px)*32 + c.
    for (int o = tid; o < 13 * 13 * 32; o += kThreads) {
      const int c = o % 32;
      const int p = o / 32;
      const int py = p / 13, px = p % 13;
      float best = -INFINITY;
#pragma unroll
      for (int wy = 0; wy < 2; ++wy) {
#pragma unroll
        for (int wx = 0; wx < 2; ++wx) {
          const int y = 2 * py + wy, xx = 2 * px + wx;
          float acc = 0.f;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              acc = fmaf(sx[(y + dy) * 28 + xx + dx], sw1[(dy * 3 + dx) * 32 + c], acc);
            }
          }
          best = fmaxf(best, acc);
        }
      }
      sh1[o] = fmaxf(best + sb1[c], 0.f);
    }
    __syncthreads();

    // conv2 + relu + floor 2x2 pool. Thread: channel oc, pooled outputs
    // q = g, g+8, g+16, g+24 (< 25), four window taps each.
    {
      const int oc = tid % 64;
      const int g = tid / 64;
      float acc[4][4];
      int base[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int q = min(g + 8 * r, 24);
        const int py = q / 5, px = q % 5;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          base[r][w] = ((2 * py + w / 2) * 13 + 2 * px + w % 2) * 32;
          acc[r][w] = 0.f;
        }
      }
#pragma unroll 1
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll 1
        for (int dx = 0; dx < 3; ++dx) {
          const int off = (dy * 13 + dx) * 32;
          const float* wrow = sw2 + (dy * 3 + dx) * 32 * 64 + oc;
#pragma unroll 4
          for (int c = 0; c < 32; ++c) {
            const float wv = wrow[c * 64];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
#pragma unroll
              for (int w = 0; w < 4; ++w) {
                acc[r][w] = fmaf(sh1[base[r][w] + off + c], wv, acc[r][w]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int q = g + 8 * r;
        if (q < 25) {
          const float m = fmaxf(fmaxf(acc[r][0], acc[r][1]), fmaxf(acc[r][2], acc[r][3]));
          sh2[q * 64 + oc] = fmaxf(m + sb2[oc], 0.f);
        }
      }
    }
    __syncthreads();

    // dense: warp j < 10 computes logit j.
    const int warp = tid / 32, lane = tid % 32;
    if (warp < 10) {
      float s = 0.f;
      for (int k = lane; k < 1600; k += 32) s = fmaf(sh2[k], swd[warp * 1600 + k], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) slogit[warp] = s + sbd[warp];
    }
    __syncthreads();

    // softmax over the 10 logits in warp 0.
    if (warp == 0) {
      const float v = lane < 10 ? slogit[lane] : -INFINITY;
      float m = v;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const float e = lane < 10 ? expf(v - m) : 0.f;
      float s = e;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane < 10) out[static_cast<size_t>(img) * 10 + lane] = e / s;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int tip_mnist_forward(const float* x, const float* w1, const float* b1,
                                 const float* w2, const float* b2, const float* wd,
                                 const float* bd, float* out, int batch, int grid,
                                 void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mnist_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  mnist_forward_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x, w1, b1, w2, b2, wd, bd, out, batch);
  return static_cast<int>(cudaGetLastError());
}
