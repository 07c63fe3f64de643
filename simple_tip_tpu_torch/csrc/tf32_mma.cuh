// Helpers shared by the tensor-core kernels (B1, B3 fused forwards; B4
// forward, B5/B6 backward): cp.async copies into shared memory, the TF32
// high/low split of a float32, ldmatrix of a 16 x 8 float32 A tile, and the
// float32-accurate 3xTF32 product on the tensor cores (mma.sync.m16n8k8,
// a.b = a_hi.b_hi + a_hi.b_lo + a_lo.b_hi, f32 sums).
//
// Fragment layouts of m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// So an accumulator tile becomes the A operand of the next product as
// {c0, c2, c1, c3} when that product's k-step takes column 2t as k-index t
// and column 2t + 1 as k-index t + 4: the B operand's rows are then read in
// that order (rows 2t and 2t + 1 of the 8-row step), and nothing moves
// between lanes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 16 or 4 bytes from global to shared memory; pred false zero-fills them
// (src-size 0: nothing is read).
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 4 : 0));
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

// split_tf32's result for finite x in integer arithmetic: add half of the
// dropped bits' weight to the magnitude and clear them (ties away from zero,
// as cvt.rna). 5 instructions where cvt.rna's inf/NaN guard makes split_tf32
// 9; the convolutions split every A element they read.
__device__ __forceinline__ void split_tf32_finite(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a.b + 0 into fresh registers: a zero C operand instead of a zeroed
// accumulator.
__device__ __forceinline__ void mma_tf32_zero(float* d, const uint32_t* a, uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// c += a.b in 3xTF32 (small products first), b's parts split beforehand
// (hi at bh, lo at bl; rows b0 and b1 = b0 + 4 k-steps apart by `step`).
// The tensor cores round their sums toward zero, so the k-step is summed
// from zero and added to c by a rounded f32 add: the bias stays that of one
// 8-term partial.
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* a_hi, const uint32_t* a_lo,
                                           const float* bh, const float* bl, int step) {
  const uint32_t b0h = __float_as_uint(bh[0]), b1h = __float_as_uint(bh[step]);
  const uint32_t b0l = __float_as_uint(bl[0]), b1l = __float_as_uint(bl[step]);
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(part, a_lo, b0h, b1h);
  mma_tf32(part, a_hi, b0l, b1l);
  mma_tf32(part, a_hi, b0h, b1h);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += part[e];
}

// c[m][n] += a[m].b[n] in 3xTF32 for M A fragments and N B fragments
// pre-split as b[n] = (b0 hi, b1 hi, b0 lo, b1 lo), one 16-byte load of a
// lane's part of a fragment-ordered weight array (see
// fused_forward.tf32_fragments). Same order and rounding as mma_3xtf32 for
// each tile, but the 3 M N products are interleaved, so that no product
// waits on the one issued just before it (the mma asm is volatile: the
// products issue in program order).
template <int M, int N>
__device__ __forceinline__ void mma_3xtf32_tiles(float (*c)[N][4], const uint32_t (*a_hi)[4],
                                                 const uint32_t (*a_lo)[4], const float4* b) {
  float part[M][N][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n)
      mma_tf32_zero(part[m][n], a_lo[m], __float_as_uint(b[n].x), __float_as_uint(b[n].y));
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n)
      mma_tf32(part[m][n], a_hi[m], __float_as_uint(b[n].z), __float_as_uint(b[n].w));
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n)
      mma_tf32(part[m][n], a_hi[m], __float_as_uint(b[n].x), __float_as_uint(b[n].y));
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[m][n][e] += part[m][n][e];
}

// The A fragment (hi, lo) of rows g and g + 8, k-step kk, of a 16-row tile
// at w (DHP + 4 floats a row), split in registers.
template <int DHP>
__device__ __forceinline__ void a_frag(const float* w, int kk, int g, int t4, uint32_t* hi,
                                       uint32_t* lo) {
  constexpr int S = DHP + 4;
  const float* ap = w + g * S + 8 * kk + t4;
  split_tf32(ap[0], hi[0], lo[0]);
  split_tf32(ap[8 * S], hi[1], lo[1]);
  split_tf32(ap[4], hi[2], lo[2]);
  split_tf32(ap[8 * S + 4], hi[3], lo[3]);
}

// 16-byte row pieces where dh % 4 == 0 and every pointer is 16-byte aligned.
inline bool vec_rows(int dh, const void* const* ptrs, int n) {
  if (dh % 4 != 0) return false;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  return true;
}

// The A fragment of a 16 x 8 float32 tile whose rows lie anywhere in shared
// memory: lane L gives the address of row (L % 8) + 8 ((L / 8) % 2), columns
// 4 (L / 16) .. + 3 (16 bytes, 16-byte aligned). ldmatrix's 8 x 8 b16
// matrices are 8 x 4 float32, so lane (g, t) receives a0 (g, t), a1 (g + 8,
// t), a2 (g, t + 4), a3 (g + 8, t + 4). Split into TF32 parts here (finite values).
__device__ __forceinline__ void ldmatrix_split(const float* row, uint32_t* hi, uint32_t* lo) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  uint32_t r[4];
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32_finite(__uint_as_float(r[e]), hi[e], lo[e]);
}

}  // namespace
