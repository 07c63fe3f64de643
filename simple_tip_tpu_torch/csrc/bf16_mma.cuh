// Helpers shared by the bf16 scoring mode's kernels (B1 and B3 bf16 fused
// forwards, B4 bf16 forward): rounding to bfloat16, the correctly rounded
// bf16 product, ldmatrix of bf16 tiles, the product on the tensor cores
// (mma.sync.m16n8k16 with bfloat16 operands and float32 accumulators),
// cp.async copies, named barriers, and the shared-memory attribute set once
// a device.
//
// Fragment layouts of m16n8k16 bf16 (g = lane / 4, t = lane % 4; a register
// holds two bf16, the lower k index in its low half):
//   A (16 x 16, row): r0 (g, 2t..2t+1), r1 (g + 8, 2t..), r2 (g, 2t+8..),
//                     r3 (g + 8, 2t+8..)
//   B (16 x 8, col):  r0 (k = 2t..2t+1, n = g), r1 (k = 2t+8.., n = g)
//   C (16 x 8):       c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// So ldmatrix.x4 of a 16 x 16 bf16 A tile takes from lane L the address of
// row (L % 8) + 8 ((L / 8) % 2), columns 8 (L / 16) .. + 7 (16 bytes); and
// an accumulator pair of n-tiles (2j, 2j + 1) becomes the A operand of a
// product over those 16 columns as {pack(c0, c1) of 2j, pack(c2, c3) of 2j,
// pack(c0, c1) of 2j + 1, pack(c2, c3) of 2j + 1}.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// x rounded to bfloat16 to nearest even, as its 16 bits / as a float.
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}
__device__ __forceinline__ float bf16_round(float x) {
  return __uint_as_float(bf16_bits(x) << 16);
}
// Two floats rounded to bfloat16 (to nearest even) in one register, lo in
// the low half: one cvt.rn.bf16x2.f32.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The product of two bfloat16 values held as floats (their low 16 bits
// zero), rounded once to bfloat16 and returned as a float: one
// mul.rn.bf16x2 whose low halves multiply 0 by 0. The float32 product of two
// bfloat16 values is exact wherever it is a normal float32, so there this is
// bf16_round(a * b) in one instruction and no conversion.
__device__ __forceinline__ float bf16_product(float a, float b) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(__float_as_uint(a)), "r"(__float_as_uint(b)));
  return __uint_as_float(r);
}

// 16 bytes from global to shared memory without passing through registers;
// pred false zero-fills them (src-size 0: nothing is read).
__device__ __forceinline__ void async_copy16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void async_wait_all() { asm volatile("cp.async.wait_all;\n"); }

// Named barrier `id` (1-15) over `count` threads: bar_sync waits, bar_arrive
// counts this thread in and goes on (a producer's signal; its earlier
// writes are visible to the threads that wait).
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// cudaFuncSetAttribute(kernel, MaxDynamicSharedMemorySize, bytes) on the
// current device unless `done` says it was set there already (one bit a
// device; a launch's own smem may be anything up to `bytes`).
template <typename Kernel>
cudaError_t max_dynamic_smem_once(Kernel kernel, int bytes, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_acq_rel);
  return err;
}

// c += a.b on the tensor cores: bf16 operands, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 b16 matrices from shared memory, each lane giving one row
// address (16 bytes, 16-byte aligned).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// The same, each matrix transposed: lanes 8 i .. 8 i + 7 give the rows of
// matrix i of a row-major [k][n] tile, and each lane receives two
// consecutive k of one n (the B operand of a row-major K x N matrix).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// One m16 tile of a 3x3 convolution's im2col product over K = 9 CIN in
// (dy, dx, c) order, all NT n-tiles: acc[j] += A.B over its 9 CIN / 16
// k-steps. A comes from a bf16 map in shared memory (IN pixels a row, PIX
// bf16 a pixel) by ldmatrix: `row` is this lane's row address at tap
// (0, 0), channel 8 (lane / 16). B comes from fragment-ordered weights
// (fused_forward.bf16_fragments: [k-step][NTILES][32 lanes] of 2 registers),
// n-tiles nt0 .. nt0 + NT - 1, in shared or global memory.
template <int IN, int PIX, int CIN, int NT, int NTILES>
__device__ __forceinline__ void conv_tile_bf16(float (&acc)[NT][4], const __nv_bfloat16* row,
                                               const uint2* wfrag, int nt0, int lane) {
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const __nv_bfloat16* at = row + ((tap / 3) * IN + tap % 3) * PIX;
#pragma unroll
    for (int c16 = 0; c16 < CIN / 16; ++c16) {
      uint32_t a[4];
      ldmatrix_x4(a, at + c16 * 16);
      const uint2* w = wfrag + ((tap * (CIN / 16) + c16) * NTILES + nt0) * 32 + lane;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint2 b = w[j * 32];
        mma_bf16(acc[j], a, b.x, b.y);
      }
    }
  }
}

// This lane's ldmatrix row address for unit (m16 tile) u of a pooled 3x3
// convolution evaluated at the 2P x 2P positions a floor 2x2 pool keeps:
// row g (g = 0..7) of the tile is pooled position 4 u + g / 2 at pool tap
// (0, g % 2), row g + 8 the same position at tap (1, g % 2), so the pool is
// a max of a lane's rows g and g + 8 and of lane g ^ 1's. Pooled positions
// at or past n_pooled read position n_pooled - 1 (their results are not
// kept). IMG bf16 an image of the map.
template <int IN, int P, int PIX, int IMG>
__device__ __forceinline__ const __nv_bfloat16* pool_row_bf16(const __nv_bfloat16* map, int u,
                                                              int lane, int n_pooled) {
  const int r = lane % 8, ty = (lane / 8) % 2, ch = lane / 16;
  const int pq = min(u * 4 + r / 2, n_pooled - 1);
  const int im = pq / (P * P), q = pq % (P * P);
  const int y = 2 * (q / P) + ty, x = 2 * (q % P) + r % 2;
  return map + im * IMG + (y * IN + x) * PIX + ch * 8;
}

// The pooled epilogue of unit u (NT n-tiles, 8 NT channels): the max over
// the 4 pool taps, then bias and relu once per pooled value (relu(max(a) + b)
// = max(relu(a + b)): rounding is monotone), rounded to bfloat16 and stored
// at pixel q of image im of `out` (OUT_PIX bf16 a pixel, OUT_IMG an image).
template <int P, int NT, int OUT_PIX, int OUT_IMG>
__device__ __forceinline__ void pool_store_bf16(float (&acc)[NT][4], __nv_bfloat16* out,
                                                const float* bias, int u, int lane,
                                                int n_pooled) {
  const int g = lane / 4, t4 = lane % 4;
  const int pq = u * 4 + g / 2;
  const int im = pq / (P * P), q = pq % (P * P);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float v0 = fmaxf(acc[j][0], acc[j][2]);
    float v1 = fmaxf(acc[j][1], acc[j][3]);
    v0 = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, 4));
    v1 = fmaxf(v1, __shfl_xor_sync(0xffffffffu, v1, 4));
    const int n = 8 * j + 2 * t4;
    if (g % 2 == 0 && pq < n_pooled) {
      *reinterpret_cast<uint32_t*>(out + im * OUT_IMG + q * OUT_PIX + n) =
          pack_bf16(fmaxf(v0 + bias[n], 0.f), fmaxf(v1 + bias[n + 1], 0.f));
    }
  }
}

}  // namespace
