// The pooled 3x3 convolution 32 -> 64 channels shared by the fused convnet
// forwards (B1 MNIST conv2, B3 CIFAR-10 conv2), as an im2col product on the
// tensor cores in 3xTF32.
//
// The input is a block's tile of pooled conv1 maps in shared memory, IN x IN
// pixels of 32 channels an image (kPix = 36 floats a pixel: 32 channels and
// 4 of padding, so that the 8 rows an ldmatrix phase reads fall in 8
// different 16-byte bank groups; IMG floats an image). The convolution is
// evaluated only at the 2P x 2P positions that the floor 2x2 pool keeps.
//
// Rows of the im2col product are (pooled position, pool tap). A warp's unit
// is one m16 tile, 4 pooled positions x 4 taps, times all 64 output channels
// (eight n8 tiles): each A fragment it splits feeds 8 tiles. In m-tile u,
// row g (g = 0..7) is pooled position 4 u + g / 2 at pool tap (0, g % 2) and
// row g + 8 the same position at tap (1, g % 2): so the 8 rows of one
// ldmatrix phase are 8 neighbouring pixels, and a pooled value is the max of
// the lane's own rows g and g + 8 and of lane g ^ 1's (one shuffle, lane ^ 4).
//
// K = 288 in (dy, dx, c) order (the bridge's w2.reshape(288, 64) rows) runs
// in 9 chunks, one per tap (dy, dx), of 4 k-steps (8 channels each). A chunk
// of weights is the fragment-ordered TF32 hi/lo array that
// fused_forward.tf32_fragments builds: [4 k-steps][8 n-tiles][32 lanes][4].
// Units u = warp + 8 i (i < UPW) of n_units m-tiles: a block has kWarps = 8.

#pragma once

#include "tf32_mma.cuh"

namespace {

constexpr int kWarps = 8;  // a block's warps in both fused forwards
constexpr int kPix = 36;   // floats a pixel of a 32-channel map in shared memory

// Per unit i: the offset (floats) of the pixel row this lane gives ldmatrix,
// at tap (0, 0) and channel 4 (lane / 16). Pooled positions at or past
// n_pooled read position n_pooled - 1 (their results are not kept).
template <int IN, int P, int IMG, int UPW>
__device__ __forceinline__ void pool_conv_rows(int (&base)[UPW], int warp, int lane,
                                               int n_pooled) {
  const int r = lane % 8, ty = (lane / 8) % 2, ch = lane / 16;
#pragma unroll
  for (int i = 0; i < UPW; ++i) {
    const int pq = min((warp + kWarps * i) * 4 + r / 2, n_pooled - 1);
    const int im = pq / (P * P), q = pq % (P * P);
    const int y = 2 * (q / P) + ty, x = 2 * (q % P) + r % 2;
    base[i] = im * IMG + (y * IN + x) * kPix + ch * 4;
  }
}

// One chunk (tap (dy, dx)) of the product: acc[i][j] += A.B over its 4
// k-steps, A read from `map` by ldmatrix, B from the chunk in `stage`.
template <int IN, int UPW>
__device__ __forceinline__ void pool_conv_chunk(float (&acc)[UPW][2][4][4],
                                                const int (&base)[UPW], const float* map,
                                                const float* stage, int tap, int warp,
                                                int lane, int n_units) {
  const int off = ((tap / 3) * IN + tap % 3) * kPix;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    float4 b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      b[j] = *reinterpret_cast<const float4*>(stage + ((kk * 8 + j) * 32 + lane) * 4);
#pragma unroll
    for (int i = 0; i < UPW; ++i) {
      if (warp + kWarps * i < n_units) {
        uint32_t a_hi[1][4], a_lo[1][4];
        ldmatrix_split(map + base[i] + off + kk * 8, a_hi[0], a_lo[0]);
        mma_3xtf32_tiles<1, 4>(&acc[i][0], a_hi, a_lo, b);
        mma_3xtf32_tiles<1, 4>(&acc[i][1], a_hi, a_lo, b + 4);
      }
    }
  }
}

// The epilogue: max over the 4 pool taps, then bias and relu once per pooled
// value (relu(max(a) + b) = max(relu(a + b)): rounding is monotone), stored
// to `out` at pixel py * P + px of image im, OUT_PIX floats a pixel, OUT_IMG
// floats an image.
template <int P, int UPW, int OUT_PIX, int OUT_IMG>
__device__ __forceinline__ void pool_conv_store(float (&acc)[UPW][2][4][4], float* out,
                                                const float* bias, int warp, int lane,
                                                int n_units, int n_pooled) {
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int i = 0; i < UPW; ++i) {
    if (warp + kWarps * i < n_units) {
      const int pq = (warp + kWarps * i) * 4 + g / 2;
      const int im = pq / (P * P), q = pq % (P * P);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* a = acc[i][j / 4][j % 4];
        float v0 = fmaxf(a[0], a[2]);
        float v1 = fmaxf(a[1], a[3]);
        v0 = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, 4));
        v1 = fmaxf(v1, __shfl_xor_sync(0xffffffffu, v1, 4));
        const int n = 8 * j + 2 * t4;
        if (g % 2 == 0 && pq < n_pooled) {
          *reinterpret_cast<float2*>(out + im * OUT_IMG + q * OUT_PIX + n) =
              make_float2(fmaxf(v0 + bias[n], 0.f), fmaxf(v1 + bias[n + 1], 0.f));
        }
      }
    }
  }
}

}  // namespace
