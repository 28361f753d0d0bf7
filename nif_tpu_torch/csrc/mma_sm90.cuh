// Warp-level tensor-core helpers for Hopper (sm_90a), as inline PTX:
// ldmatrix (plain and transposed) and the bf16 mma.sync.m16n8k16 with f32
// accumulation. A source that includes this header builds against it alone;
// ops/_build.py hashes it only with the sources that include it.
//
// Fragment layout of mma.m16n8k16 (lane l, g = l / 4, q = l % 4):
//   A (16 x 16, row-major): a[0] = rows g, cols 2q..2q+1; a[1] = rows g+8;
//     a[2] = rows g, cols 2q+8..2q+9; a[3] = rows g+8, cols 2q+8..2q+9.
//   B (16 x 8, k x n): b[0] = k 2q..2q+1, col g; b[1] = k 2q+8..2q+9, col g.
//   C (16 x 8, f32): c[0..1] = row g, cols 2q..2q+1; c[2..3] = row g+8.
// ldmatrix.x4 loads four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row
// addresses of matrix i (16-byte aligned), and register i holds matrix i.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 matrices; lane l holds row l / 4, cols 2 (l % 4), +1 of each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row_addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row_addr)));
}

// The same, transposed: lane l holds rows 2 (l % 4), +1 of col l / 4.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* row_addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row_addr)));
}

// An asynchronous 16-byte copy from global to shared memory (cp.async);
// with valid = false it writes 16 zero bytes and reads nothing. Both
// addresses are 16-byte aligned. cp_async_wait_all() waits for the
// thread's copies; a barrier after it shows them to the block.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(smem_dst)), "l"(gmem_src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// c += A (16 x 16 bf16) @ B (16 x 8 bf16), f32 accumulation. A bf16 x bf16
// product is exact in f32; only the order of the f32 sums is the unit's.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
