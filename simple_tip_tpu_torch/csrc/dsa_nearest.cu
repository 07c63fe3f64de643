// DSA's masked nearest neighbour for Hopper (sm_90a), float32-accurate
// products on the tensor cores.
//
// Replaces the Pallas TPU kernel simple_tip_tpu/ops/dsa_pallas.py
// `_nearest_kernel` (launched by `_masked_nearest_call`): for every query
// row, the minimum over training rows of
//   d2 = max(|x|^2 + |t|^2 - 2 x.t, 0), +inf where the class mask excludes
//   the pair (want_same: labels equal; else: labels differ),
// and the ORIGINAL index of that minimum, the lowest index on ties (a row
// with no allowed training row gives (+inf, 0), as jnp.argmin does).
//
// What bounds it on this card: operations. It is a [C, D] x [D, N] product
// (C = 10,000 queries, N = 18,000 training rows, D = 1,600 for MNIST) with
// a row-min epilogue, far above the ridge point. Float32-accurate products
// run fastest as 3xTF32 on the tensor cores: each operand is split into a
// TF32 high part and a TF32 low part, and a.b = a_hi.b_hi + a_hi.b_lo +
// a_lo.b_hi (the dropped a_lo.b_lo is ~2^-22 of each term), accumulated in
// f32 by mma.sync.m16n8k8: three TF32 products at 495 TF/s. The tensor
// cores round their sums toward zero, so each 8-deep k-step is summed from
// zero and added to the running sum by a rounded f32 add, which keeps the
// bias of that rounding at the size of one 8-term partial.
//
// What the design does about it:
// - Class-sorted operands. The wrapper passes the training rows sorted by
//   label (with each row's original index), the order that sorts the queries
//   by label (the kernel gathers their rows through it), and a tile plan: per 128-query tile, at most two ranges of 128-row
//   training tiles to visit. The same-class search visits only the tiles of
//   the classes in the query tile; the other-class search skips the tiles
//   that hold only the query tile's one class. The two searches of a score
//   call then compute each (query, training row) pair about once, instead of
//   twice with half of it masked away.
// - The planned tiles of one query tile are split over grid.y so a few
//   query tiles still fill the card; each block keeps its partial (min, arg)
//   and a second small kernel reduces the partials per row and scatters the
//   results back to the queries' original order.
// - A 128 x 128 block tile, 8 warps of 32 x 64, 8-deep mma k-steps; the
//   operands move with 16-byte cp.async into a 3-stage ring of 32-deep k
//   slices in shared memory, so the next slices load while this one
//   multiplies. Rows are padded to 36 floats, so every fragment load is
//   free of bank conflicts. The feature tail is zero-filled in shared
//   memory (D is padded to a multiple of 4 by the wrapper); no feature cap.
// - The masked row-min is fused: the distance matrix never reaches device
//   memory. Every comparison is lexicographic on (d2, original index), so
//   the result does not depend on the sort, the split or the reduction order.
// - For few features (IMDB's 20; the wrapper, ops/dsa_cuda.py
//   `tensor_cores`, decides and passes the choice) the tile products are
//   float32 FMA chains over the features in order instead: there the work is
//   bound by bytes, and the traces lie so close together (nearest d2 ~1e-3
//   of |x|^2) that only the plain version's own arithmetic picks its rows.
// - The reduction re-scores each row's winner with one float32 FMA chain
//   (the plain version's arithmetic), so the returned d2 is the float32
//   expansion's; only the choice of row rests on the 3xTF32 products.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;     // query rows a block (the tile plan's query tile)
constexpr int kBN = 128;     // training rows a tile (the tile plan's training tile)
constexpr int kBK = 32;      // depth of a k slice in shared memory
constexpr int kStride = kBK + 4;  // padded row stride (floats), conflict-free fragments
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kStageFloats = (kBM + kBN) * kStride;
constexpr int kSmemBytes = kStages * kStageFloats * static_cast<int>(sizeof(float));

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo with hi and lo TF32 (lo is rounded to TF32 too).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(x));
  const float r = x - __uint_as_float(h);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(l) : "f"(r));
  hi = h;
  lo = l;
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// plan[qt] = (s0, e0, s1, e1): the training tiles [s0, e0) then [s1, e1).
template <bool kTensorCores>
__global__ void __launch_bounds__(kThreads, 2)
nearest_partial_kernel(const float* __restrict__ x, const float* __restrict__ x_sq,
                       const int* __restrict__ x_lab, const int* __restrict__ order, int n_query,
                       const float* __restrict__ t, const float* __restrict__ t_sq,
                       const int* __restrict__ t_lab, const int* __restrict__ t_idx,
                       int n_train, int dim, int want_same, const int* __restrict__ plan,
                       int tiles_per_block, float* __restrict__ part_min,
                       int* __restrict__ part_arg) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int src[kBM];  // the original query row of each sorted row of the tile
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q4 = lane % 4;
  const int warp_m = warp % 4, warp_n = warp / 4;  // 4 x 2 warps of 32 x 64
  const int row0 = blockIdx.x * kBM;

  const int s0 = plan[4 * blockIdx.x], e0 = plan[4 * blockIdx.x + 1];
  const int s1 = plan[4 * blockIdx.x + 2], e1 = plan[4 * blockIdx.x + 3];
  const int len0 = e0 - s0, total = len0 + (e1 - s1);
  const int v_begin = blockIdx.y * tiles_per_block;
  const int v_end = min(v_begin + tiles_per_block, total);
  const int n_tiles = max(v_end - v_begin, 0);
  const int k_slices = (dim + kBK - 1) / kBK;
  const int n_iters = n_tiles * k_slices;

  for (int m = tid; m < kBM; m += kThreads) src[m] = row0 + m < n_query ? order[row0 + m] : -1;
  __syncthreads();

  // This thread's rows are warp_m * 32 + row_of(i): m-tile i / 2, half i % 2.
  auto row_of = [&](int i) { return warp_m * 32 + (i / 2) * 16 + (i % 2) * 8 + g; };
  float best[4];
  int best_idx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i] = INFINITY;
    best_idx[i] = INT_MAX;
  }

  auto tile_of = [&](int v) { return v < len0 ? s0 + v : s1 + (v - len0); };

  // Stage `it` of the flattened (tile, k slice) walk into ring slot it % kStages.
  auto load = [&](int it) {
    if (it < n_iters) {
      const int tile = tile_of(v_begin + it / k_slices);
      const int k0 = (it % k_slices) * kBK;
      float* as = smem + (it % kStages) * kStageFloats;
      float* bs = as + kBM * kStride;
#pragma unroll
      for (int l = tid; l < kBM * kBK / 4; l += kThreads) {
        const int m = l / (kBK / 4), kc = (l % (kBK / 4)) * 4;
        const int r = src[m], c = tile * kBN + m, kk = k0 + kc;
        const bool kin = kk < dim;
        const bool ra = r >= 0 && kin, rb = c < n_train && kin;
        cp_async16(as + m * kStride + kc, ra ? x + static_cast<size_t>(r) * dim + kk : x, ra);
        cp_async16(bs + m * kStride + kc, rb ? t + static_cast<size_t>(c) * dim + kk : t, rb);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load(s);

  float acc[2][8][4];
  for (int it = 0; it < n_iters; ++it) {
    if (it % k_slices == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice `it` landed for all; slot (it - 1) % kStages is free
    load(it + kStages - 1);

    const float* as = smem + (it % kStages) * kStageFloats + warp_m * 32 * kStride;
    const float* bs = smem + (it % kStages) * kStageFloats + (kBM + warp_n * 64) * kStride;
    if constexpr (kTensorCores) {
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 8) {
        uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float* ap = as + (i * 16 + g) * kStride + kk + q4;
          split_tf32(ap[0], a_hi[i][0], a_lo[i][0]);
          split_tf32(ap[8 * kStride], a_hi[i][1], a_lo[i][1]);
          split_tf32(ap[4], a_hi[i][2], a_lo[i][2]);
          split_tf32(ap[8 * kStride + 4], a_hi[i][3], a_lo[i][3]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float* bp = bs + (j * 8 + g) * kStride + kk + q4;
          uint32_t b0h, b0l, b1h, b1l;
          split_tf32(bp[0], b0h, b0l);
          split_tf32(bp[4], b1h, b1l);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            // each k-step from zero, then a rounded add (see the header)
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(part, a_lo[i], b0h, b1h);
            mma_tf32(part, a_hi[i], b0l, b1l);
            mma_tf32(part, a_hi[i], b0h, b1h);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] += part[e];
          }
        }
      }
    } else {
      // Few features: one float32 FMA chain per pair, features in order (the
      // plain version's arithmetic, so near ties resolve as it resolves them).
#pragma unroll 4
      for (int k = 0; k < kBK; ++k) {
        float a[4], b[16];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = as[((i / 2) * 16 + (i % 2) * 8 + g) * kStride + k];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          b[2 * j] = bs[(j * 8 + 2 * q4) * kStride + k];
          b[2 * j + 1] = bs[(j * 8 + 2 * q4 + 1) * kStride + k];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              acc[i / 2][j][(i % 2) * 2 + e] =
                  fmaf(a[i], b[2 * j + e], acc[i / 2][j][(i % 2) * 2 + e]);
      }
    }

    if (it % k_slices == k_slices - 1) {  // the tile's products are complete
      const int col0 = tile_of(v_begin + it / k_slices) * kBN + warp_n * 64;
      float xs[4];
      int xl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = src[row_of(i)];
        xs[i] = r >= 0 ? __ldg(x_sq + r) : 0.f;
        xl[i] = r >= 0 ? __ldg(x_lab + r) : INT_MIN;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = col0 + j * 8 + 2 * q4 + e;
          if (c < n_train) {
            const float ts = __ldg(t_sq + c);
            const int tl = __ldg(t_lab + c), ti = __ldg(t_idx + c);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if ((xl[i] == tl) == static_cast<bool>(want_same)) {
                const float d2 =
                    fmaxf((xs[i] + ts) - 2.f * acc[i / 2][j][(i % 2) * 2 + e], 0.f);
                if (better(d2, ti, best[i], best_idx[i])) {
                  best[i] = d2;
                  best_idx[i] = ti;
                }
              }
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is idle: reuse it for the cross-warp reduction

  // The four lanes of a quad share rows; then the two warps of a row range.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_idx[i], off);
      if (better(ov, oi, best[i], best_idx[i])) {
        best[i] = ov;
        best_idx[i] = oi;
      }
    }
  }
  float* red_v = smem;
  int* red_i = reinterpret_cast<int*>(smem + kBM);
  if (warp_n == 1 && q4 == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = row_of(i);
      red_v[m] = best[i];
      red_i[m] = best_idx[i];
    }
  }
  __syncthreads();
  if (warp_n == 0 && q4 == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = row_of(i);
      float v = best[i];
      int vi = best_idx[i];
      if (better(red_v[m], red_i[m], v, vi)) {
        v = red_v[m];
        vi = red_i[m];
      }
      const int r = row0 + m;
      if (r < n_query) {
        part_min[static_cast<size_t>(blockIdx.y) * n_query + r] = v;
        part_arg[static_cast<size_t>(blockIdx.y) * n_query + r] = vi;
      }
    }
  }
}

// Reduce the partials of sorted query r, re-score the winner in the plain
// version's arithmetic (one float32 FMA chain over the features in order,
// then max(|x|^2 + |t|^2 - 2 x.t, 0)), and write both to the query's
// original row. The 3xTF32 products pick the row; the value returned is the
// float32 expansion's, as the plain version and the TPU kernel give it.
__global__ void nearest_reduce_kernel(const float* __restrict__ part_min,
                                      const int* __restrict__ part_arg, int n_query,
                                      int n_split, const int* __restrict__ order,
                                      const float* __restrict__ x, const float* __restrict__ x_sq,
                                      const float* __restrict__ t_orig,
                                      const float* __restrict__ t_sq_orig, int dim,
                                      float* __restrict__ out_min, int* __restrict__ out_arg) {
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
  const int dst = order[r];
  if (isinf(v)) {  // no allowed row (or +inf only): index 0
    out_min[dst] = v;
    out_arg[dst] = 0;
    return;
  }
  const float* xr = x + static_cast<size_t>(dst) * dim;
  const float* tr = t_orig + static_cast<size_t>(vi) * dim;
  float acc = 0.f;
#pragma unroll 8
  for (int k = 0; k < dim; ++k) acc = fmaf(__ldg(xr + k), __ldg(tr + k), acc);
  out_min[dst] = fmaxf((x_sq[dst] + t_sq_orig[vi]) - 2.f * acc, 0.f);
  out_arg[dst] = vi;
}

}  // namespace

// x [n_query, dim] (with x_sq and x_lab) in the caller's order, and order the
// original row of each label-sorted query; t [n_train, dim] sorted by label
// with t_idx the original index of each row; dim a multiple of 4;
// tensor_cores 1 for 3xTF32 products, 0 for float32 FMA chains; plan
// [ceil(n_query / 128), 4] int32 tile ranges, made for plan_block_queries x
// plan_block_train tiles (anything but kBM x kBN is refused); part_* [n_split, n_query]
// scratch (in sorted order); x_orig [n_query, dim_orig] and t_orig, t_sq_orig
// [n_train, ...] the unpadded rows in the caller's order, for the re-score;
// out_* in the caller's order.
extern "C" int tip_dsa_nearest(const float* x, const float* x_sq, const int* x_lab,
                               int n_query, const float* t, const float* t_sq,
                               const int* t_lab, const int* t_idx, int n_train, int dim,
                               int want_same, int tensor_cores, const int* plan,
                               int plan_block_queries, int plan_block_train,
                               int tiles_per_block, int n_split, const int* order,
                               const float* x_orig, const float* t_orig,
                               const float* t_sq_orig, int dim_orig, float* part_min,
                               int* part_arg, float* out_min, int* out_arg, void* stream) {
  if (dim % 4 != 0 || tiles_per_block < 1 || n_split < 1 || plan_block_queries != kBM ||
      plan_block_train != kBN)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static int configured_device = -1;  // the shared-memory opt-in, once per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device != configured_device) {
    err = cudaFuncSetAttribute(nearest_partial_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(nearest_partial_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured_device = device;
  }
  const dim3 grid((n_query + kBM - 1) / kBM, n_split);
  auto kernel = tensor_cores ? nearest_partial_kernel<true> : nearest_partial_kernel<false>;
  kernel<<<grid, kThreads, kSmemBytes, s>>>(
      x, x_sq, x_lab, order, n_query, t, t_sq, t_lab, t_idx, n_train, dim, want_same, plan,
      tiles_per_block, part_min, part_arg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nearest_reduce_kernel<<<(n_query + 127) / 128, 128, 0, s>>>(
      part_min, part_arg, n_query, n_split, order, x_orig, x_sq, t_orig, t_sq_orig, dim_orig,
      out_min, out_arg);
  return static_cast<int>(cudaGetLastError());
}
