// Fused CIFAR-10 inference forward for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel simple_tip_tpu/ops/fused_forward.py
// `_cifar_kernel` (entry `fused_cifar10_probs`): conv1 3x3 3->32 + relu,
// max-pool 30->15, conv2 3x3 32->64 + relu, floor max-pool 13->6, conv3 3x3
// 64->64 + relu, NHWC flatten to 1024, dense [1024,64] + relu, dense
// [64,10], softmax. NHWC input [B,32,32,3], probabilities out [B,10].
//
// What bounds it on this card: operations. Counted at the positions the
// pools keep, an image costs 4.09 M FMAs (conv1 0.78 M, conv2 2.65 M, conv3
// 0.59 M, dense 0.07 M) against 12 KB read and 40 B written; the float32
// FMA rate of the SMs is the limit.
//
// What the design does: the TPU kernel held a 32-image tile's whole
// forward in VMEM (the [32,30,30,32] conv1 block alone is 3.7 MB). A block
// here has 227 KB of shared memory and the weights alone are 489 KB, so the
// kernel walks tiles of 4 images (grid stride, one block per SM) and stages
// one layer's weights at a time through shared memory:
//   1. the 4 images (48 KB) and w1 in region B; conv1 is evaluated straight
//      into the pooled [15,15,32] map (relu and max commute), region A;
//   2. w2 (72 KB) replaces the images in region B; conv2 is evaluated only
//      at the 12x12 positions that the floor pool keeps, into [6,6,64],
//      region C;
//   3. w3 (144 KB) replaces h1 and w2 in regions A and B; conv3 into
//      [4,4,64] (NHWC flatten order) after it;
//   4. dense1 reads wd1 (256 KB) from global memory through the read-only
//      path (it stays in L2), each weight used for the 4 images at once;
//      dense2 and the softmax run one warp per image.
// Threads own output-channel groups: conv1 4 channels (one float4 of
// weights), conv2 and conv3 8 channels (channels 4g..4g+3 and 32+4g..,
// so that 8 lanes read 32 consecutive floats) for one pooled position and
// its 4 window taps, reading the input map as float4 over channels; so each
// shared-memory load feeds 4-16 FMAs. relu(max(a_i) + b) equals
// max(relu(a_i + b)) exactly (rounding is monotone), so bias and relu are
// applied once per pooled value.
//
// This is the simple, exact version; tensor-core convolutions (bf16
// wgmma) and overlapping the weight staging with compute are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 576;  // 18 warps: 1152 conv2 items in 2 passes
constexpr int kTile = 4;       // images per pass

// Shared-memory layout in floats.
constexpr int kA = 0;                         // h1 [kTile][15*15][32]; later w3, h3
constexpr int kB = kA + kTile * 225 * 32;     // x [kTile][32*32*3] + w1 [27][32]; later w2 [288][64]
constexpr int kC = kB + 288 * 64;             // h2 [kTile][36][64]; later dense partials
constexpr int kS = kC + kTile * 36 * 64;      // biases and wd2, loaded once
constexpr int kB1 = kS;
constexpr int kB2 = kB1 + 32;
constexpr int kB3 = kB2 + 64;
constexpr int kBd1 = kB3 + 64;
constexpr int kWd2 = kBd1 + 64;
constexpr int kBd2 = kWd2 + 64 * 10;
constexpr int kSmemFloats = kBd2 + 16;
constexpr int kSmemBytes = kSmemFloats * 4;
constexpr int kX = kB;                        // images
constexpr int kW1 = kB + kTile * 3072;        // conv1 [27][32]
constexpr int kH3 = kA + 576 * 64;            // conv3 out [kTile][1024], after w3
constexpr int kPart = kC;                     // dense1 partials [8][kTile][64]
constexpr int kHd = kC + 8 * kTile * 64;      // dense1 out [kTile][64]
static_assert(kW1 + 27 * 32 <= kC, "images and w1 fit region B");
static_assert(kH3 + kTile * 1024 <= kC, "w3 and h3 fit regions A and B");
static_assert(kHd + kTile * 64 <= kS, "dense scratch fits region C");
static_assert(kSmemBytes <= 232448, "a block's shared memory");

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void copy4(float* dst, const float* src, int n4, int tid) {
  float4* d = reinterpret_cast<float4*>(dst);
  const float4* s = reinterpret_cast<const float4*>(src);
  for (int i = tid; i < n4; i += kThreads) d[i] = __ldg(s + i);
}

// Eight output channels of one position: og*4 .. og*4+3 and 32+og*4 .. +3.
__device__ __forceinline__ void fma8(float (&acc)[8], float h, const float* wrow, int og) {
  const float4 wa = *reinterpret_cast<const float4*>(wrow + og * 4);
  const float4 wb = *reinterpret_cast<const float4*>(wrow + 32 + og * 4);
  acc[0] = fmaf(h, wa.x, acc[0]);
  acc[1] = fmaf(h, wa.y, acc[1]);
  acc[2] = fmaf(h, wa.z, acc[2]);
  acc[3] = fmaf(h, wa.w, acc[3]);
  acc[4] = fmaf(h, wb.x, acc[4]);
  acc[5] = fmaf(h, wb.y, acc[5]);
  acc[6] = fmaf(h, wb.z, acc[6]);
  acc[7] = fmaf(h, wb.w, acc[7]);
}

__device__ __forceinline__ int oc8(int og, int k) { return k < 4 ? og * 4 + k : 32 + og * 4 + (k - 4); }

__global__ void __launch_bounds__(kThreads, 1)
cifar10_forward_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                       const float* __restrict__ b1, const float* __restrict__ w2,
                       const float* __restrict__ b2, const float* __restrict__ w3,
                       const float* __restrict__ b3, const float* __restrict__ wd1,
                       const float* __restrict__ bd1, const float* __restrict__ wd2,
                       const float* __restrict__ bd2, float* __restrict__ out, int batch) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  for (int i = tid; i < 32; i += kThreads) smem[kB1 + i] = b1[i];
  for (int i = tid; i < 64; i += kThreads) {
    smem[kB2 + i] = b2[i];
    smem[kB3 + i] = b3[i];
    smem[kBd1 + i] = bd1[i];
  }
  for (int i = tid; i < 640; i += kThreads) smem[kWd2 + i] = wd2[i];
  for (int i = tid; i < 10; i += kThreads) smem[kBd2 + i] = bd2[i];

  const int n_tiles = (batch + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int img0 = tile * kTile;
    const int n_img = min(kTile, batch - img0);

    // 1. images and w1 into region B; conv1 + relu + pool into h1.
    {
      float4* xs = reinterpret_cast<float4*>(smem + kX);
      const float4* xg = reinterpret_cast<const float4*>(x + static_cast<size_t>(img0) * 3072);
      for (int i = tid; i < kTile * 768; i += kThreads) {
        xs[i] = i < n_img * 768 ? __ldg(xg + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      copy4(smem + kW1, w1, 27 * 32 / 4, tid);
    }
    __syncthreads();
    {
      const float* xs = smem + kX;
      const float* w1s = smem + kW1;
      const int cg = tid % 8;  // channels cg*4 .. cg*4+3 (kThreads % 8 == 0)
      for (int item = tid; item < kTile * 225 * 8; item += kThreads) {
        const int pidx = item / 8;
        const int im = pidx / 225, pp = pidx % 225;
        const int py = pp / 15, px = pp % 15;
        const float* xi = xs + im * 3072;
        float acc[4][4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[t][c] = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
            for (int ci = 0; ci < 3; ++ci) {
              const float4 w = *reinterpret_cast<const float4*>(w1s + ((dy * 3 + dx) * 3 + ci) * 32 + cg * 4);
#pragma unroll
              for (int t = 0; t < 4; ++t) {
                const int y = 2 * py + t / 2 + dy, xx = 2 * px + t % 2 + dx;
                const float xv = xi[(y * 32 + xx) * 3 + ci];
                acc[t][0] = fmaf(xv, w.x, acc[t][0]);
                acc[t][1] = fmaf(xv, w.y, acc[t][1]);
                acc[t][2] = fmaf(xv, w.z, acc[t][2]);
                acc[t][3] = fmaf(xv, w.w, acc[t][3]);
              }
            }
          }
        }
        float r[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float mx = fmaxf(fmaxf(acc[0][c], acc[1][c]), fmaxf(acc[2][c], acc[3][c]));
          r[c] = fmaxf(mx + smem[kB1 + cg * 4 + c], 0.f);
        }
        *reinterpret_cast<float4*>(smem + kA + pidx * 32 + cg * 4) = make_float4(r[0], r[1], r[2], r[3]);
      }
    }
    __syncthreads();

    // 2. w2 into region B; conv2 + relu + floor pool 13->6 into h2.
    copy4(smem + kB, w2, 288 * 64 / 4, tid);
    __syncthreads();
    {
      const float* h1 = smem + kA;
      const float* w2s = smem + kB;
      const int og = tid % 8;
      for (int item = tid; item < kTile * 36 * 8; item += kThreads) {
        const int qidx = item / 8;
        const int im = qidx / 36, qq = qidx % 36;
        const int py = qq / 6, px = qq % 6;
        const float* hin = h1 + im * 225 * 32;
        float acc[4][8];
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[t][c] = 0.f;
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap) {
          const int dy = tap / 3, dx = tap % 3;
          int base[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            base[t] = ((2 * py + t / 2 + dy) * 15 + 2 * px + t % 2 + dx) * 32;
          }
#pragma unroll 2
          for (int c4 = 0; c4 < 8; ++c4) {
            float4 hv[4];
#pragma unroll
            for (int t = 0; t < 4; ++t) hv[t] = *reinterpret_cast<const float4*>(hin + base[t] + c4 * 4);
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              const float* wrow = w2s + (tap * 32 + c4 * 4 + cc) * 64;
#pragma unroll
              for (int t = 0; t < 4; ++t) fma8(acc[t], comp(hv[t], cc), wrow, og);
            }
          }
        }
        float* hout = smem + kC + qidx * 64;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int oc = oc8(og, k);
          const float mx = fmaxf(fmaxf(acc[0][k], acc[1][k]), fmaxf(acc[2][k], acc[3][k]));
          hout[oc] = fmaxf(mx + smem[kB2 + oc], 0.f);
        }
      }
    }
    __syncthreads();

    // 3. w3 into regions A and B; conv3 + relu into h3 (NHWC flatten order).
    copy4(smem + kA, w3, 576 * 64 / 4, tid);
    __syncthreads();
    {
      const float* h2 = smem + kC;
      const float* w3s = smem + kA;
      const int og = tid % 8;
      for (int item = tid; item < kTile * 16 * 8; item += kThreads) {
        const int pidx = item / 8;
        const int im = pidx / 16, p = pidx % 16;
        const int y = p / 4, xx = p % 4;
        const float* hin = h2 + im * 36 * 64;
        float acc[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[c] = 0.f;
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap) {
          const int base = ((y + tap / 3) * 6 + xx + tap % 3) * 64;
#pragma unroll 4
          for (int c4 = 0; c4 < 16; ++c4) {
            const float4 hv = *reinterpret_cast<const float4*>(hin + base + c4 * 4);
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              fma8(acc, comp(hv, cc), w3s + (tap * 64 + c4 * 4 + cc) * 64, og);
            }
          }
        }
        float* hout = smem + kH3 + pidx * 64;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int oc = oc8(og, k);
          hout[oc] = fmaxf(acc[k] + smem[kB3 + oc], 0.f);
        }
      }
    }
    __syncthreads();

    // 4. dense1 (wd1 from global memory) in 8 slices of 128 inputs, then
    // the sum of the slices, bias and relu.
    if (tid < 512) {
      const int o = tid % 64, slice = tid / 64;
      const float* h3 = smem + kH3;
      float acc[kTile];
#pragma unroll
      for (int im = 0; im < kTile; ++im) acc[im] = 0.f;
#pragma unroll 4
      for (int kk = slice * 128; kk < slice * 128 + 128; ++kk) {
        const float w = __ldg(wd1 + kk * 64 + o);
#pragma unroll
        for (int im = 0; im < kTile; ++im) acc[im] = fmaf(h3[im * 1024 + kk], w, acc[im]);
      }
#pragma unroll
      for (int im = 0; im < kTile; ++im) smem[kPart + (slice * kTile + im) * 64 + o] = acc[im];
    }
    __syncthreads();
    if (tid < kTile * 64) {
      const int im = tid / 64, o = tid % 64;
      float s = 0.f;
#pragma unroll
      for (int slice = 0; slice < 8; ++slice) s += smem[kPart + (slice * kTile + im) * 64 + o];
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
    __syncthreads();  // regions B and C are rewritten by the next tile
  }
}

}  // namespace

extern "C" int tip_cifar10_forward(const float* x, const float* w1, const float* b1,
                                   const float* w2, const float* b2, const float* w3,
                                   const float* b3, const float* wd1, const float* bd1,
                                   const float* wd2, const float* bd2, float* out, int batch,
                                   int grid, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      cifar10_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cifar10_forward_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x, w1, b1, w2, b2, w3, b3, wd1, bd1, wd2, bd2, out, batch);
  return static_cast<int>(cudaGetLastError());
}
