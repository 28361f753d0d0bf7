// Hopper's own tensor-core path (sm_90a), as inline PTX: the warpgroup
// product wgmma.mma_async (bf16 in, f32 accumulation; A from shared memory
// or from registers, B from shared memory) with its fence, commit and
// wait; the shared-memory matrix descriptor of the 128-byte swizzled
// layout and the descriptors of a staged W_m [n, n]; mbarriers (init,
// arrive, arrive with an expected byte count, parity wait); the TMA tiled
// copy (cp.async.bulk.tensor) that completes on an mbarrier, and the host
// side's tensor map of every group's W_m; the proxy fence between generic
// stores and the async proxy; named barriers; setmaxnreg; and the
// transposing matrix store (stmatrix). The wgmma bodies
// (shapenet_bwd_wgmma.cu, shapenet_fwd_wgmma.cu, shapenet_hess_wgmma.cu)
// include it;
// ops/_build.py hashes it only with the sources that include it.
//
// Layout (the "128B swizzle" atom of the PTX ISA's wgmma section): a bf16
// matrix is kept in chunks of 64 columns, each chunk rows of 128 bytes,
// eight rows (1024 bytes, 1024-byte aligned) a swizzle atom, in which the
// 16-byte unit u of row r sits at unit u ^ (r % 8). Element (r, c) of a
// chunk lies at r * 128 + (((c / 8) ^ (r % 8)) * 16) + (c % 8) * 2. A chunk
// read with its rows as the product's K dimension is "MN-major" (trans 1),
// with its columns as K "K-major" (trans 0):
// - K-major: rows of M (or N) 128 bytes apart, eight-row groups SBO = 1024
//   apart; a K step of 16 columns is +32 bytes inside a chunk, the next 64
//   columns the next chunk; LBO unused (1).
// - MN-major: 64 M (or N) values contiguous in a row, the next 64 in the
//   next chunk (LBO = the chunk stride); the K rows 128 bytes apart,
//   eight-row groups SBO = 1024 apart; a K step of 16 rows is +2048 bytes.
// The accumulator of m64nNk16 (warp w of the warpgroup, lane l, g = l / 4,
// q = l % 4): d[4 i + e] is row 16 w + g + 8 (e / 2), column 8 i + 2 q +
// (e % 2), the layout of mma.m16n8k16's C fragment per 8 columns. With A
// in registers (m64nNk16, K step kk) warp w holds rows 16 w .. 16 w + 15 as
// mma.m16n8k16's A fragment: a[0] rows g, a[1] rows g + 8 of columns 16 kk +
// 2 q, +1, a[2] and a[3] the same eight columns on, each two bf16 packed.
// So an accumulator d packed pairwise (u[j] = bf16x2(d[2 j], d[2 j + 1]))
// is the A operand of the next product as it stands: K step kk takes
// u[4 kk .. 4 kk + 3].
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The 64-bit wgmma descriptor of a 128-byte swizzled operand at shared
// address `addr` (1024-byte aligned atoms; lbo and sbo in bytes).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of the warpgroup's committed product groups are in
// flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin an accumulator's registers across an asynchronous product: the
// compiler may not move a read or write of them over this point.
template <int K>
__device__ __forceinline__ void fence_acc(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A (64 x 16) B (16 x N), both from shared memory by descriptor;
// TA / TB: 0 K-major, 1 MN-major; scale_d = 0 ignores d's old value.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (+)= A (64 x 16) B (16 x 80), both from shared memory by descriptor:
// the Hessian bodies' products over a stacked plane of 80 rows (eight
// points of ten streams) as the product's N; TA / TB as above.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n80k16(float (&d)[40], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, %43, %44;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (+)= A (64 x 16, from registers: four bf16x2 a thread, the layout
// above) B (16 x N, from shared memory by descriptor); TB: 0 K-major, 1
// MN-major; scale_d = 0 ignores d's old value.
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t* a, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t* a, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

// ... and N = 80 (the Hessian bodies' last layer over a stacked plane).
template <int TB>
__device__ __forceinline__ void wgmma_m64n80k16_rs(float (&d)[40], const uint32_t* a, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

// The narrow products (N = 8, 16) with A from registers: d[4 i + e] as
// above (i < N / 8).
template <int TB>
__device__ __forceinline__ void wgmma_m64n8k16_rs(float (&d)[4], const uint32_t* a, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, %10;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[8], const uint32_t* a, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

// Two f32 values rounded to one bf16x2 (lo in the low half).
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four 8 x 8 bf16 matrices from the accumulator layout (a thread's r[k]:
// row g, columns 2q, 2q + 1 of matrix k, packed) stored transposed: lane
// 8 k + i gives the shared address of row i of matrix k, which receives
// column i (eight bf16, 16 bytes).
__device__ __forceinline__ void stsm_x4_trans(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                              uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// Descriptors of a bf16 matrix staged in 64-column chunks (128-byte
// swizzle; a chunk holds the matrix's rows, `cs` bytes apart chunk to
// chunk) at shared address m: read MN-major (its rows the product's K, K
// step kk of 16 rows) or K-major (its columns the product's K, K step kk of
// 16 columns).
__device__ __forceinline__ uint64_t chunk_mn(uint32_t m, uint32_t cs, int kk) {
  return sw128_desc(m + kk * 2048, cs, 1024);
}
__device__ __forceinline__ uint64_t chunk_k(uint32_t m, uint32_t cs, int kk) {
  return sw128_desc(m + (kk >> 2) * cs + (kk & 3) * 32, 16, 1024);
}

// A staged W_m [n, n] (TMA's chunks of n rows, 128 n bytes each) read
// MN-major (Z = S W) or K-major (du = dz W^T).
template <int N>
__device__ __forceinline__ uint64_t w_mn(uint32_t w, int kk) {
  return chunk_mn(w, 128 * N, kk);
}
template <int N>
__device__ __forceinline__ uint64_t w_k(uint32_t w, int kk) {
  return chunk_k(w, 128 * N, kk);
}

// The byte offset of element (r, c) of a 64-column swizzled chunk with
// 128-byte rows.
__device__ __forceinline__ unsigned sw_off(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1));
}

// The tiles [t_begin, t_end) of split s of a group's n_tiles.
__device__ __forceinline__ void split_tiles(int n_tiles, int S, int s, int* t_begin, int* t_end) {
  *t_begin = (int)((long long)s * n_tiles / S);
  *t_end = (int)((long long)(s + 1) * n_tiles / S);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(bar))),
               "r"(count)
               : "memory");
}

// Makes the initialised mbarriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(bar)))
               : "memory");
}

// Arrive and add `bytes` to the phase's expected transaction count.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(bar))),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed (a fresh barrier
// counts the phase before its first as complete: parity 1 passes at once).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(bar))),
      "r"(parity)
      : "memory");
}

// A 4-D TMA tile copy from global memory (the tensor map, a __grid_constant__
// kernel parameter) into shared memory, completing `bytes` of `bar`'s
// transaction count.
__device__ __forceinline__ void tma_load_4d(void* dst, const void* tmap, uint64_t* bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(static_cast<uint32_t>(__cvta_generic_to_shared(bar)))
      : "memory");
}

// Orders this thread's generic shared-memory stores before later reads by
// the async proxy (wgmma operands).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A named barrier over `count` threads (a multiple of 32); id 0 is
// __syncthreads()'s.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Hand registers between warpgroups: every warp of a warpgroup runs the
// same one.
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// The driver's cuTensorMapEncodeTiled, reached through the runtime (no
// link against libcuda); null when it is not there.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
    cudaGetLastError();
  }
  return fn;
}

// The tensor map of W_m of every group of wb' [G, wb_ld] (bf16; W_m at
// element si n + m n n of a row): one 4-D tensor (column, row, m, group)
// whose TMA boxes are 64-column chunks of n rows, 128-byte swizzled.
// Returns 0, cudaErrorNotSupported without the driver's entry, or
// cudaErrorInvalidValue where the driver refuses the map (wb' or its rows
// not 16-byte aligned).
inline int encode_w_map(CUtensorMap* map, const __nv_bfloat16* wb, int n, int si, int n_mats, int G,
                        long long wb_ld) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)n, (cuuint64_t)n, (cuuint64_t)n_mats, (cuuint64_t)G};
  const cuuint64_t strides[3] = {(cuuint64_t)n * 2, (cuuint64_t)n * n * 2, (cuuint64_t)wb_ld * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)n, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                            const_cast<__nv_bfloat16*>(wb) + (long long)si * n, dims, strides, box,
                            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace
