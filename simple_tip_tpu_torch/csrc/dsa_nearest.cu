// DSA's masked nearest neighbour for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel simple_tip_tpu/ops/dsa_pallas.py
// `_nearest_kernel` (launched by `_masked_nearest_call`): for every query
// row, the minimum over training rows of
//   d2 = max(|x|^2 + |t|^2 - 2 x.t, 0), +inf where the class mask excludes
//   the pair (want_same: labels equal; else: labels differ),
// and the index of that minimum, the lowest index on ties (an all-masked
// row gives (+inf, 0), as the TPU kernel and jnp.argmin do).
//
// What bounds it on this card: operations. It is a [C, D] x [D, N] product
// (C = 10,000 queries, N = 18,000 training rows, D = 1,600 for MNIST) with
// a row-min epilogue: 2*C*N*D FLOPs against (C + N)*D*4 bytes read, far
// above the float32 ridge point.
//
// What the design does about it: the distance matrix never reaches device
// memory. Each block computes 64 x 64 tiles of x.t from shared-memory
// tiles (16-deep k slices, 4 x 4 register outputs a thread, f32 FMAs), and
// folds each tile into a running (min, argmin) per query row in the
// epilogue. The TPU grid carried that running minimum across sequential
// steps; Hopper's blocks run in parallel, so the training rows are split
// into ranges over grid.y, each block keeps its own partial minimum, and a
// second small kernel reduces the partials per row. Every comparison is
// lexicographic on (d2, index), so the result does not depend on the split
// or on the order of the reduction. D is tiled, so there is no feature cap.
//
// This is the simple float32 version; TF32/bf16 tensor-core products with
// an exact re-check of near ties are later work.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBM = 64;  // query rows a block
constexpr int kBN = 64;  // training rows a tile
constexpr int kBK = 16;  // depth of a k slice
constexpr int kThreads = 256;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
nearest_partial_kernel(const float* __restrict__ x, const float* __restrict__ x_sq,
                       const int* __restrict__ x_lab, int n_query,
                       const float* __restrict__ t, const float* __restrict__ t_sq,
                       const int* __restrict__ t_lab, int n_train, int dim,
                       int want_same, int tiles_per_split,
                       float* __restrict__ part_min, int* __restrict__ part_arg) {
  __shared__ float as[kBK][kBM + 1];
  __shared__ float bs[kBK][kBN + 1];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = blockIdx.x * kBM;
  const int n_tiles = (n_train + kBN - 1) / kBN;
  const int tile_begin = blockIdx.y * tiles_per_split;
  const int tile_end = min(tile_begin + tiles_per_split, n_tiles);

  float xs[4];
  int xl[4];
  float best[4];
  int best_idx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    xs[i] = r < n_query ? x_sq[r] : 0.f;
    xl[i] = r < n_query ? x_lab[r] : 0;
    best[i] = INFINITY;
    best_idx[i] = INT_MAX;
  }

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int col0 = tile * kBN;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < dim; k0 += kBK) {
      for (int l = threadIdx.x; l < kBM * kBK; l += kThreads) {
        const int m = l / kBK, k = l % kBK;
        const int r = row0 + m, kk = k0 + k;
        as[k][m] = (r < n_query && kk < dim) ? x[static_cast<size_t>(r) * dim + kk] : 0.f;
        const int c = col0 + m;
        bs[k][m] = (c < n_train && kk < dim) ? t[static_cast<size_t>(c) * dim + kk] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = as[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = bs[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    float ts[4];
    int tl[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      ts[j] = c < n_train ? t_sq[c] : 0.f;
      tl[j] = c < n_train ? t_lab[c] : 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = INFINITY;
      int vi = INT_MAX;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + tx + 16 * j;
        if (c < n_train) {
          float d2 = fmaxf((xs[i] + ts[j]) - 2.f * acc[i][j], 0.f);
          const bool same = xl[i] == tl[j];
          if (same != static_cast<bool>(want_same)) d2 = INFINITY;
          if (better(d2, c, v, vi)) {
            v = d2;
            vi = c;
          }
        }
      }
      // the 16 lanes sharing a row sit in one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, vi, off);
        if (better(ov, oi, v, vi)) {
          v = ov;
          vi = oi;
        }
      }
      if (better(v, vi, best[i], best_idx[i])) {
        best[i] = v;
        best_idx[i] = vi;
      }
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty + 16 * i;
      if (r < n_query) {
        part_min[static_cast<size_t>(blockIdx.y) * n_query + r] = best[i];
        part_arg[static_cast<size_t>(blockIdx.y) * n_query + r] = best_idx[i];
      }
    }
  }
}

__global__ void nearest_reduce_kernel(const float* __restrict__ part_min,
                                      const int* __restrict__ part_arg, int n_query,
                                      int n_split, float* __restrict__ out_min,
                                      int* __restrict__ out_arg) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_query) return;
  float v = INFINITY;
  int vi = INT_MAX;
  for (int s = 0; s < n_split; ++s) {
    const float ov = part_min[static_cast<size_t>(s) * n_query + r];
    const int oi = part_arg[static_cast<size_t>(s) * n_query + r];
    if (better(ov, oi, v, vi)) {
      v = ov;
      vi = oi;
    }
  }
  out_min[r] = v;
  out_arg[r] = vi;
}

}  // namespace

extern "C" int tip_dsa_nearest(const float* x, const float* x_sq, const int* x_lab,
                               int n_query, const float* t, const float* t_sq,
                               const int* t_lab, int n_train, int dim, int want_same,
                               int n_split, float* part_min, int* part_arg,
                               float* out_min, int* out_arg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (n_train + kBN - 1) / kBN;
  const int tiles_per_split = (n_tiles + n_split - 1) / n_split;
  dim3 grid((n_query + kBM - 1) / kBM, n_split);
  nearest_partial_kernel<<<grid, kThreads, 0, s>>>(x, x_sq, x_lab, n_query, t, t_sq, t_lab,
                                                    n_train, dim, want_same, tiles_per_split,
                                                    part_min, part_arg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nearest_reduce_kernel<<<(n_query + 255) / 256, 256, 0, s>>>(part_min, part_arg, n_query,
                                                              n_split, out_min, out_arg);
  return static_cast<int>(cudaGetLastError());
}
