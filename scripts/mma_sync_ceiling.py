"""Measure what ``mma.sync.m16n8k8`` TF32 products reach on one card: the
ceiling of the port's 3xTF32 kernels (B1-B6), which multiply that way.

    python scripts/mma_sync_ceiling.py [--out mma_ceiling.json]

Builds one small CUDA source with ``nvcc`` (sm_90a) into ``.torch_kernels/``
at the root of the checkout and runs, on one block per SM, warps that each
issue a long loop of products with operands in registers and nothing else:

- ``tf32``: 8 independent accumulator tiles, one TF32 product each a step;
- ``3xtf32``: 8 tiles in the kernels' 3xTF32 form (three products summed
  from a zeroed partial, interleaved across the tiles, then one float32
  add per element into the accumulator), as ``mma_3xtf32_tiles`` does;
- ``3xtf32_zero_c``: the same with the first product written to fresh
  registers (a zero C operand) instead of a zeroed partial;
- ``3xtf32_zero_c_split_*``: that plus the TF32 split of two A fragments
  a step, as the convolutions split theirs: both parts by
  ``cvt.rna.tf32.f32`` (``cvt``); the high part rounded to nearest in
  integer arithmetic and the low part left for the tensor core to truncate
  (``int_lo_truncated``); both parts rounded in integer arithmetic
  (``int``).

Tile n takes A fragment n / 4 and B fragment n % 4 (a warp's 2 m-tiles x
4 n-tiles in the convolutions), and the operands change every step, so
that no two products are the same and none is loop-invariant.

Each is timed at 8 and 16 warps a block with ``clock64`` inside the
kernel (SM cycles) and CUDA events (wall time). It prints one JSON line per
case: TF32 products a cycle an SM, and the effective float32-accurate rate
in TF/s at the measured clock. Needs a CUDA card and ``nvcc``.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a.b + 0: the product into fresh registers, no zeroed accumulator.
__device__ __forceinline__ void mma_zero(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// The TF32 split x = hi + lo in three ways:
// SPLIT 0: both parts by cvt.rna.tf32.f32;
// SPLIT 1: hi rounded to nearest in integer arithmetic (add half of the
//          dropped bits' weight, clear them), lo = x - hi left for the tensor
//          core, which reads only its TF32 bits (truncation);
// SPLIT 2: both parts rounded to nearest in integer arithmetic.
template <int SPLIT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (SPLIT == 0) {
    uint32_t h, l;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(x));
    const float r = x - __uint_as_float(h);
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(l) : "f"(r));
    hi = h;
    lo = l;
  } else {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    const uint32_t r = __float_as_uint(x - __uint_as_float(hi));
    lo = SPLIT == 1 ? r : (r + 0x1000u) & 0xffffe000u;
  }
}

// FORM 0: one TF32 product a tile a step (8 tiles chained across steps).
// FORM 1: 3xTF32 a tile a step: three products summed from a zeroed partial,
//         interleaved over the 8 tiles, then 4 float32 adds a tile.
// FORM 2: FORM 1 with the first product into fresh registers (no zeroing).
// FORM 3, 4, 5: FORM 2 plus the TF32 split of two A fragments a step, by
//         SPLIT 0, 1 and 2.
// Operands change every step, so that nothing is loop-invariant.
template <int FORM>
__global__ void ceiling(float* out, long long* cycles, int steps, uint32_t seed) {
  uint32_t a_hi[2][4], a_lo[2][4], b[4];
  float a_raw[2][4];
  for (int m = 0; m < 2; ++m)
    for (int e = 0; e < 4; ++e) {
      a_hi[m][e] = (seed + threadIdx.x * 7 + e + m) & 0x3f800000u;
      a_lo[m][e] = (seed + threadIdx.x * 3 + e + m) & 0x30000000u;
      a_raw[m][e] = 1.f + 1e-3f * (threadIdx.x + e + m);
    }
  for (int e = 0; e < 4; ++e) b[e] = (seed ^ (threadIdx.x + e)) & 0x3f800000u;
  float c[8][4];
  for (int n = 0; n < 8; ++n)
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
  __syncthreads();
  const long long t0 = clock64();
  for (int s = 0; s < steps; ++s) {
    // tile n = (m, j): A fragment m = n / 4, B fragment j = n % 4, as a warp's
    // 2 m-tiles x 4 n-tiles in the convolutions; all 8 products distinct
    uint32_t bj[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) bj[j][e] = b[e] + s + 16 * j;
    if (FORM == 0) {
#pragma unroll
      for (int n = 0; n < 8; ++n) mma(c[n], a_hi[n / 4], bj[n % 4][0], bj[n % 4][1]);
    } else {
      if (FORM >= 3) {
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) split<FORM - 3>(a_raw[m][e] + s, a_hi[m][e], a_lo[m][e]);
      }
      float part[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (FORM == 1) {
#pragma unroll
          for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
          mma(part[n], a_lo[n / 4], bj[n % 4][0], bj[n % 4][1]);
        } else {
          mma_zero(part[n], a_lo[n / 4], bj[n % 4][0], bj[n % 4][1]);
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) mma(part[n], a_hi[n / 4], bj[n % 4][2], bj[n % 4][3]);
#pragma unroll
      for (int n = 0; n < 8; ++n) mma(part[n], a_hi[n / 4], bj[n % 4][0], bj[n % 4][1]);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[n][e] += part[n][e];
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  float sum = 0.f;
  for (int n = 0; n < 8; ++n)
    for (int e = 0; e < 4; ++e) sum += c[n][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

extern "C" int run(int form, int blocks, int threads, int steps, float* out, long long* cycles) {
  switch (form) {
    case 0: ceiling<0><<<blocks, threads>>>(out, cycles, steps, 12345u); break;
    case 1: ceiling<1><<<blocks, threads>>>(out, cycles, steps, 12345u); break;
    case 2: ceiling<2><<<blocks, threads>>>(out, cycles, steps, 12345u); break;
    case 3: ceiling<3><<<blocks, threads>>>(out, cycles, steps, 12345u); break;
    case 4: ceiling<4><<<blocks, threads>>>(out, cycles, steps, 12345u); break;
    default: ceiling<5><<<blocks, threads>>>(out, cycles, steps, 12345u); break;
  }
  return static_cast<int>(cudaGetLastError());
}
"""
FORMS = ("tf32", "3xtf32", "3xtf32_zero_c", "3xtf32_zero_c_split_cvt",
         "3xtf32_zero_c_split_int_lo_truncated", "3xtf32_zero_c_split_int")


def build(root: str) -> ctypes.CDLL:
    """Compile SOURCE into ``root/.torch_kernels/mma_ceiling/`` and load it."""
    out_dir = os.path.join(root, ".torch_kernels", "mma_ceiling")
    os.makedirs(out_dir, exist_ok=True)
    src, lib = os.path.join(out_dir, "ceiling.cu"), os.path.join(out_dir, "libceiling.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", lib, src], check=True)
    dll = ctypes.CDLL(lib)
    dll.run.restype = ctypes.c_int
    dll.run.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    return dll


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None)
    parser.add_argument("--steps", type=int, default=20_000)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("mma_sync_ceiling: no CUDA device is visible", file=sys.stderr)
        return 2
    dll = build(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    records = []
    for form, name in enumerate(FORMS):
        for warps in (8, 16):
            threads = 32 * warps
            out = torch.empty(sms * threads, device="cuda")
            cycles = torch.empty(sms, dtype=torch.int64, device="cuda")
            dll.run(form, sms, threads, 10, out.data_ptr(), cycles.data_ptr())  # warm-up
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            err = dll.run(form, sms, threads, args.steps, out.data_ptr(), cycles.data_ptr())
            end.record()
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
            ms = start.elapsed_time(end)
            per_tile = 1 if form == 0 else 3  # TF32 products a tile step
            products = warps * args.steps * 8 * per_tile  # per block (one an SM)
            per_cycle = products / float(cycles.double().mean())
            clock_ghz = float(cycles.double().mean()) / (ms * 1e6)
            # float32-accurate FLOPs (3xTF32) or TF32 FLOPs: a tile step is 2*16*8*8
            flops = sms * products / per_tile * 2 * 16 * 8 * 8
            records.append({
                "gpu": torch.cuda.get_device_name(0), "form": name, "warps_per_sm": warps,
                "tf32_products_per_cycle_per_sm": per_cycle, "sm_clock_ghz": clock_ghz,
                "ms": ms, "effective_tflops": flops / (ms * 1e-3) / 1e12,
            })
            print(json.dumps(records[-1]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
