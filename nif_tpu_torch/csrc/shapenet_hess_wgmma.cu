// K8's and K7's bf16 paths on Hopper's own tensor-core path: the fused
// Hessian train pass of the grouped ShapeNet chain (forward over the value,
// tangent and second-order streams, the masked weighted value, Jacobian and
// Hessian MSE, and the backward through the second-order chain) and the
// fused Hessian evaluation (its forward half), one body template with the
// compile-time TRAIN flag, every hidden product a warpgroup
// wgmma.mma_async (bf16 in, f32 accumulation, both operands in shared
// memory), fed by a producer warp through mbarriers and TMA.
//
// It replaces the same TPU kernels as shapenet_hess_tc.cu (the mma.sync body,
// which stays for the chains this one refuses):
// nif_tpu/ops/pallas_shapenet.py::_hessian_kernel (shapenet_hessian_grads;
// its backward _hessian_backward_chain) and _fwd_hess_kernel
// (shapenet_fwd_hess), for bfloat16 sine chains (plain or resblock SIREN) at
// widths 64 and 128, si = 3 (ten streams a point), so <= 4. Its arguments,
// outputs and rounding points are the mma.sync body's (see its header): S
// stored in bf16; the raw products Z in f32 and every epilogue in f32; D
// rows rounded before their products, the value-row dz unrounded where the
// bias grads sum it; dW0 from the unrounded tangent seed rows; dW_last and
// dS on the rounded D_out; an off-diagonal pair counted twice; the bf16
// polynomial sine with its f'' and f''' in the backward. Z_m is recomputed in
// the backward by the forward's own products (the same bits), not kept.
//
// What bounds it on an H100 SXM: operations. At the flagship train shape
// (G=32, P=32768, width 128, two hidden layers, si=3, so=1) the products
// are 2071.2 GFLOP (K8), ~2.1 ms at the 989 TFLOP/s bf16 peak, and 690.7
// GFLOP (K7), ~0.70 ms. The mma.sync body reaches a tenth of that: its
// eight warps each read the whole stacked plane through ldmatrix for their
// own 16 columns (the plane's shared-memory traffic twice its products'
// time), and latency, not issue, sets its pace.
//
// Design:
// - The products are taken transposed, Z^T = W_m^T S^T: the width's 64-column
//   slabs are the wgmma M, and the N of every product is a consumer's whole
//   stacked tile, 8 points of all ten streams (N = 80, stream-major: row
//   8 s + p). The accumulator then gives a thread columns 16 w + g (+ 8) of
//   each slab and points 2q, 2q + 1 of every stream, so each thread holds
//   all ten streams of its (point, column) elements: the forward's tangent
//   and pair rules, the backward's product rules and the bias and first-layer
//   sums run in registers, with no exchange between warps. Per slab a
//   thread keeps 40 f32 accumulators (80 at width 128); 64-point slabs of
//   one stream (the other layout the stream count allows) would need 160 KB
//   of planes a consumer.
// - Planes [80 rows, width] in bf16, 128-byte swizzled 64-column chunks:
//   stmatrix.trans stores the accumulator transposed into them, eight bf16
//   of a row a lane. The forward reads a plane as B K-major; the backward's
//   dS^T = W_m D^T reads W_m K-major as A and the D plane as B K-major; dW_m =
//   S_m^T D reads the S plane's chunk as A and the D plane as B, both
//   MN-major (K = the stacked rows).
// - A block is three warpgroups: warp 0 of the first is the producer, the
//   other two are consumers (setmaxnreg 40/232). The producer stages every
//   W_m of a group once a run by TMA (64-column chunks) and the f32 W0,
//   biases and W_last, under one mbarrier; then each 16-point tile's x and
//   (K8) its value, Jacobian and pair targets and point weights, as f32,
//   into a two-stage ring. Consumer c takes points 8c .. 8c + 7 of a tile.
// - dW_m: consumer c owns its 64-row chunk (width 64: consumer 0 the one
//   chunk) over both consumers' stacked rows (K = 160), its accumulator
//   preloaded with its own f32 partial ([G, 2S, ps], tile order), so a tile
//   flushes each dW element once, as the mma.sync body's 16-point tile does;
//   a named barrier over both consumers holds each D plane until the other's
//   dW product has read it. The other sums (W0, W_last, the biases) and the
//   three losses accumulate a run in shared memory, per consumer, and are
//   written to its partial once; stack_tc.cuh's ordered split reduce sums
//   the 2S partials. No float atomics: two runs give the same bits.
// - The last layer (so <= 4 outputs) runs on the tensor cores too: O^T =
//   W_last^T S_last^T and dW_last^T = lift(D_out)^T S_last are wgmma with A
//   from registers, the so outputs as warp 0's M rows (every other row
//   zero), B the last plane; dS of the last layer lands in the registers of
//   the elements' owners. A resblock's running state and its block
//   cotangent live in a per-thread f32 carry in the global scratch.
// - Registers: ptxas fits the kernel into the 168 a thread of its
//   384-thread launch bound (and spills past them), so the backward
//   recomputes Z one 64-column slab at a time beside the incoming
//   cotangent of both slabs (40 + 80 accumulators), and a forward layer
//   issues both slabs' products and runs slab 0's epilogue under slab 1's.
// - Shared memory (flagship, K8): both W_m 64 KB, each consumer's S_0, S_1
//   and D (S_last in the forward) planes 60 KB, the ring 6 KB, the f32
//   parameters, last product and sums 18 KB: 209 KB. K7 keeps two working
//   planes a consumer (144 KB). A layout past the 227 KB a block may use
//   (width 128 past two hidden matrices for K8, four for K7) is refused
//   (status 2) and runs the mma.sync body; so is (status 3) every chain the
//   instances do not cover: si other than 3, so above 4, other widths.
// The sine's coefficients are a launch argument (SinePoly), so the
// epilogues read them from the parameter bank, not from registers.
#include "stack_tc.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr int kHwSi = 3;              // the si of the instances
constexpr int kHwPts = 8;             // a consumer's points of a tile
constexpr int kHwTile = 2 * kHwPts;   // points of a tile
constexpr int kHwThreads = 384;       // the producer warpgroup and two consumers
constexpr int kHwStages = 2;          // the input ring
constexpr int kHwMaxSo = 4;
constexpr int kHwBarPair = 3;         // named barriers: 1 + c a consumer's own, kHwBarPair both

// The stacked streams of si inputs: the value, si tangents and np unique
// pairs; a consumer's tile stacks them stream-major over its 8 points.
template <int SI>
struct Streams {
  static constexpr int NP = SI * (SI + 1) / 2;
  static constexpr int NVT = 1 + SI;
  static constexpr int NS = NVT + NP;
  static constexpr int NR = kHwPts * NS;  // stacked rows: every product's N
  static constexpr int NA = NR / 2;        // accumulator floats a thread a 64-column slab
};

struct HwArgs {
  const bf16* wb;          // wb' [G, wb_ld]
  const bf16* x;           // [G, P, si]
  const bf16* target;      // K8: [G, P, so]
  const bf16* jt;          // K8: [G, P, si*so]
  const bf16* ht;          // K8: [G, P, np*so]
  const float* y_mask;     // K8: [so] 0/1, or null
  const float* jac_mask;   // K8: [si*so] 0/1, or null
  const float* hess_mask;  // K8: [np*so] 0/1, or null
  const bf16* weight;      // K8: [G, P], or null
  bf16* y;                 // K7: [G, P, so]
  bf16* jac;               // K7: [G, P, so, si]
  bf16* hp;                // K7: [G, P, so, np]
  float* partials;         // K8: [G, 2S, ps] weight-grad partials, then [G, 2S, 3] losses
  float* carry;            // resblock: [blocks, 2, N/64 * NA, 128] per-thread f32 carry
  SinePoly sp;             // the bf16 sine's coefficients
  float ky, kj, kh;        // K8: 2 w_value / n_y, 2 w_jac / n_j, 2 w_hess / n_h
  int G, P, so, n_mats, n_tiles;
  long long ps, wb_ld;
};

// Byte offsets of the dynamic shared memory (its base aligned to 1024).
struct HwLayout {
  unsigned ws, planes, plane_bytes, n_planes, ring, stage_bytes, xs, tt, tw, params, obuf, eacc,
      eacc_stride, red, bars, total;
};

template <int N, int SI>
__host__ __device__ inline HwLayout hw_layout(bool train, int n_mats) {
  constexpr int NR = Streams<SI>::NR;
  HwLayout L;
  L.ws = 0;                                      // every W_m, 64-column chunks
  L.plane_bytes = (N / 64) * NR * 128;
  L.n_planes = train ? n_mats + 1 : 2;           // per consumer: S_0 .. S_{M-1}, D; or two
  L.planes = (unsigned)n_mats * 2 * N * N;
  L.ring = L.planes + 2 * L.n_planes * L.plane_bytes;
  // a stage: x [16][4] f32, then (K8) each consumer's targets [NR][4] and
  // the tile's 16 point weights, f32
  L.xs = 0;
  L.tt = kHwTile * 16;
  L.tw = L.tt + (train ? 2 * NR * 16 : 0);
  L.stage_bytes = L.tw + (train ? kHwTile * 4 : 0);
  // W0 [n][4], b0 [n], b_m [n_mats][n], W_last [n][4], b_last [4] (f32)
  L.params = L.ring + kHwStages * L.stage_bytes;
  L.obuf = L.params + 4u * (9 * N + n_mats * N + 4);
  // per consumer: the last product [NR][4] f32 (K8: then D_out), and (K8)
  // the f32 sums of every grad but the hidden dW (a partial's row without
  // its hidden block)
  L.eacc = L.obuf + 2 * NR * 16;
  L.eacc_stride = train ? ((SI + kHwMaxSo + 1 + n_mats) * N + kHwMaxSo + 3) / 4 * 4 : 0;
  L.red = L.eacc + 2 * 4 * L.eacc_stride;
  L.bars = (L.red + 2 * 4 * 4 * 4 + 7) / 8 * 8;  // [2][4 warps][4] f32 loss sums
  L.total = L.bars + 8 * (2 * kHwStages + 2);
  return L;
}

// Descriptors (see wgmma_sm90.cuh): W_m's columns 64 j .. 64 j + 63 as A read
// MN-major (the forward's W_m^T, K step kk over W's rows); W_m's rows
// 64 j .. 64 j + 63 as A read K-major (dS^T = W_m D^T, K step kk over W's
// columns); a stacked plane of NR rows as B K-major (its rows the N, K step
// kk over the width), and its chunk j (A) or its width (B) read MN-major, K
// step kp over its rows.
template <int N>
__device__ __forceinline__ uint64_t wt_mn(uint32_t w, int j, int kk) {
  return chunk_mn(w + j * 128 * N, 128 * N, kk);
}
template <int N>
__device__ __forceinline__ uint64_t w_rows_k(uint32_t w, int j, int kk) {
  return chunk_k(w + j * 8192, 128 * N, kk);
}
template <int NR>
__device__ __forceinline__ uint64_t stack_k(uint32_t p, int kk) {
  return sw128_desc(p + (kk >> 2) * (NR * 128) + (kk & 3) * 32, 16, 1024);
}
template <int NR>
__device__ __forceinline__ uint64_t stack_mn(uint32_t p, int j, int kp) {
  return sw128_desc(p + j * (NR * 128) + kp * 2048, NR * 128, 1024);
}

template <int N, int TA, int TB>
__device__ __forceinline__ void prod(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 64)
    wgmma_m64n64k16<TA, TB>(d, da, db, scale_d);
  else
    wgmma_m64n128k16<TA, TB>(d, da, db, scale_d);
}

// Built with -DHWG_PHASE_CLOCKS (by scripts/port_phase_probe.py only),
// thread 0 of each consumer warpgroup adds the clock64() cycles between its
// marks into ten phase counters, which split a consumer's time (K7 marks
// 0-5).
#ifdef HWG_PHASE_CLOCKS
constexpr int kHwPhases = 10;
__device__ unsigned long long hwg_phase_cycles[kHwPhases];
#define HWG_PHASE(i)                                       \
  do {                                                     \
    if (th.t == 0) {                                       \
      const long long now = clock64();                     \
      phase_sum[i] += (unsigned long long)(now - phase_t); \
      phase_t = now;                                       \
    }                                                      \
  } while (0)
#else
#define HWG_PHASE(i) \
  do {               \
  } while (0)
#endif

template <int N, int SI, bool TRAIN>
__device__ __forceinline__ void hw_producer(const HwArgs& a, const CUtensorMap* wmap,
                                            unsigned char* sm, const HwLayout& L) {
  using St = Streams<SI>;
  constexpr int NCH = N / 64;
  const int lane = threadIdx.x & 31;
  const int so = a.so, n_mats = a.n_mats;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* full = bars;
  uint64_t* empty = bars + kHwStages;
  uint64_t* wfull = bars + 2 * kHwStages;
  uint64_t* wempty = wfull + 1;
  float* W0f = reinterpret_cast<float*>(sm + L.params);
  float* B0f = W0f + 4 * N;
  float* BHf = B0f + N;
  float* WLf = BHf + n_mats * N;
  float* BLf = WLf + 4 * N;
  const long long o_wl = (long long)SI * N + (long long)n_mats * N * N;
  const long long o_b0 = o_wl + (long long)N * so;
  const long long o_bh = o_b0 + N;
  const long long o_bl = o_bh + (long long)n_mats * N;
  int base = 0, run = 0;
  for (int gi = blockIdx.y; gi < a.G; gi += gridDim.y, ++run) {
    const bf16* wg = a.wb + gi * a.wb_ld;
    int t_begin, t_end;
    split_tiles(a.n_tiles, gridDim.x, blockIdx.x, &t_begin, &t_end);
    mbar_wait(wempty, (run & 1) ^ 1);  // both consumers are done with the last group
    if (lane == 0) {
      mbar_arrive_expect_tx(wfull, (uint32_t)(n_mats * 2 * N * N));
      for (int m = 0; m < n_mats; ++m)
        for (int j = 0; j < NCH; ++j)
          tma_load_4d(sm + L.ws + (m * NCH + j) * 128 * N, wmap, wfull, 64 * j, 0, m, gi);
    }
    for (int i = lane; i < 4 * N; i += 32) {
      const int c = i >> 2, k = i & 3;
      W0f[i] = k < SI ? __bfloat162float(wg[k * N + c]) : 0.f;
      WLf[i] = k < so ? __bfloat162float(wg[o_wl + c * so + k]) : 0.f;
    }
    for (int i = lane; i < N; i += 32) B0f[i] = __bfloat162float(wg[o_b0 + i]);
    for (int i = lane; i < n_mats * N; i += 32) BHf[i] = __bfloat162float(wg[o_bh + i]);
    if (lane < 4) BLf[lane] = lane < so ? __bfloat162float(wg[o_bl + lane]) : 0.f;
    mbar_arrive(wfull);
    for (int kt = 0; kt < t_end - t_begin; ++kt) {
      const int u = base + kt, stage = u % kHwStages;
      mbar_wait(empty + stage, ((u / kHwStages) & 1) ^ 1);
      const int p0 = (t_begin + kt) * kHwTile;
      const int rows = min(kHwTile, a.P - p0);
      const long long row0 = (long long)gi * a.P + p0;
      unsigned char* st = sm + L.ring + stage * L.stage_bytes;
      float* xs = reinterpret_cast<float*>(st + L.xs);
      if (lane < kHwTile) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          xs[lane * 4 + k] =
              lane < rows && k < SI ? __bfloat162float(a.x[(row0 + lane) * SI + k]) : 0.f;
      }
      if constexpr (TRAIN) {
        // the targets of each stacked row (r, stream s, output jo), eight
        // loads in flight a lane, then their stores: tt[c][8 s + p][jo]
        float* tt = reinterpret_cast<float*>(st + L.tt);
        float* tw = reinterpret_cast<float*>(st + L.tw);
        const int per_r = St::NS * so;
        const int total = kHwTile * per_r;
        for (int i0 = 0; i0 < total; i0 += 32 * 8) {
          float v[8];
          int dst[8];
#pragma unroll
          for (int uu = 0; uu < 8; ++uu) {
            const int idx = i0 + 32 * uu + lane;
            dst[uu] = -1;
            v[uu] = 0.f;
            if (idx < total) {
              const int r = idx / per_r;
              const int rem = idx - r * per_r;
              const int s = rem / so;
              const int jo = rem - s * so;
              dst[uu] = ((r >> 3) * St::NR + s * kHwPts + (r & 7)) * 4 + jo;
              if (r < rows) {
                const long long p = row0 + r;
                const bf16* src = s == 0        ? a.target + p * so + jo
                                  : s < St::NVT ? a.jt + (p * SI + s - 1) * so + jo
                                                : a.ht + (p * St::NP + s - St::NVT) * so + jo;
                v[uu] = __bfloat162float(*src);
              }
            }
          }
#pragma unroll
          for (int uu = 0; uu < 8; ++uu)
            if (dst[uu] >= 0) tt[dst[uu]] = v[uu];
        }
        if (lane < kHwTile)
          tw[lane] = lane < rows ? (a.weight ? __bfloat162float(a.weight[row0 + lane]) : 1.f) : 0.f;
      }
      mbar_arrive(full + stage);
    }
    base += t_end - t_begin;
  }
}

// A consumer's thread: its thread t of the warpgroup, warp w, lane, lane
// quad g and position q in it. It holds columns 64 j + 16 w + g + 8 h of
// slab j and points 2q + e of every stream.
struct HwThread {
  int t, w, lane, g, q;
};

__device__ __forceinline__ int hw_col(int j, int h, const HwThread& th) {
  return 64 * j + 16 * th.w + th.g + 8 * h;
}

// Consumer c's barrier over its own 128 threads, and both consumers'.
__device__ __forceinline__ void hw_sync(int c) { named_sync(1 + c, 128); }
__device__ __forceinline__ void hw_pair_sync() { named_sync(kHwBarPair, 256); }

// Slab j of the thread's accumulator (stream s, element 2h + e at 4s + 2h +
// e) into a stacked plane: rows 8 s + p, columns 64 j + ..., by stmatrix.trans,
// two streams an instruction.
template <int NR, int NA>
__device__ __forceinline__ void store_slab(uint32_t plane, int j, const float (&v)[NA],
                                           const HwThread& th) {
  static_assert((NA / 4) % 2 == 0, "streams go two a store");
  const int mk = th.lane >> 3, i = th.lane & 7;
  const unsigned unit = 2 * th.w + (mk & 1);
#pragma unroll
  for (int s = 0; s < NA / 4; s += 2) {
    const int row = kHwPts * (s + (mk >> 1)) + i;
    stsm_x4_trans(plane + j * (NR * 128) + row * 128 + ((unit ^ i) << 4),
                  pack2(v[4 * s], v[4 * s + 1]), pack2(v[4 * s + 2], v[4 * s + 3]),
                  pack2(v[4 * s + 4], v[4 * s + 5]), pack2(v[4 * s + 6], v[4 * s + 7]));
  }
}

// Slab j of Z^T = W_m^T S_m^T into acc, one commit group (the same products
// in the same order in the forward and the backward's recompute, so the
// same bits); the caller fences before and waits after.
template <int N, int NR, int NA>
__device__ __forceinline__ void z_issue(float (&acc)[NA], uint32_t w, uint32_t s, int j) {
  static_assert(NR == 80, "the products' N is the stacked tile of ten streams");
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    wgmma_m64n80k16<1, 0>(acc, wt_mn<N>(w, j, kk), stack_k<NR>(s, kk), kk > 0);
  wgmma_commit();
}

// The thread's f32 carry (its NJ * NA values, element-major over the
// consumer's threads).
template <int NJ, int NA>
__device__ __forceinline__ void carry_put(float* carry, const float (&v)[NJ][NA], float scale) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < NA; ++i) carry[(j * NA + i) * 128] = scale * v[j][i];
}
template <int NJ, int NA>
__device__ __forceinline__ void carry_get(const float* carry, float (&v)[NJ][NA]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < NA; ++i) v[j][i] = carry[(j * NA + i) * 128];
}

// A 64-row chunk of dW_m in the partial (chunk: its first row, row-major
// [64, n]), the thread's rows and columns: preloaded into the accumulator,
// and stored from it.
template <int N>
__device__ __forceinline__ void dw_load(float (&d)[N / 2], const float* chunk, const HwThread& th) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 v = *reinterpret_cast<const float2*>(chunk + (16 * th.w + th.g + 8 * h) * N +
                                                        8 * i + 2 * th.q);
      d[4 * i + 2 * h] = v.x;
      d[4 * i + 2 * h + 1] = v.y;
    }
}

template <int N>
__device__ __forceinline__ void dw_store(const float (&d)[N / 2], float* chunk,
                                         const HwThread& th) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(chunk + (16 * th.w + th.g + 8 * h) * N + 8 * i + 2 * th.q) =
          make_float2(d[4 * i + 2 * h], d[4 * i + 2 * h + 1]);
}

template <int N, int TB>
__device__ __forceinline__ void prod_rs(float (&d)[N / 2], const uint32_t* a, uint64_t db,
                                        int scale_d) {
  if constexpr (N == 64)
    wgmma_m64n64k16_rs<TB>(d, a, db, scale_d);
  else
    wgmma_m64n128k16_rs<TB>(d, a, db, scale_d);
}

// The last layer's narrow products on the tensor cores, the so (<= 4)
// outputs as the M rows g of warp 0 (every other row's A fragment zero),
// the A operand from registers: O^T = W_last^T S_last^T (A: W_last's bf16
// values, B: the last plane K-major) into O [NR][4] f32, and the consumer's
// dW_last^T = lift(D_out)^T S_last over its NR rows (A: D_out rounded, B:
// the last plane MN-major) added into its sums (ewl: the W_last block, [n,
// so]).
template <int N, int NR>
__device__ __forceinline__ void last_product_wg(uint32_t sl, const float* WLs, int so, float* O,
                                                const HwThread& th) {
  constexpr int KS = N / 16;
  const int jo = th.g;
  const bool live = th.w == 0 && jo < so;
  uint32_t a[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int k0 = 16 * kk + 2 * th.q;
    a[kk][0] = live ? pack2(WLs[k0 * 4 + jo], WLs[(k0 + 1) * 4 + jo]) : 0u;
    a[kk][1] = 0u;
    a[kk][2] = live ? pack2(WLs[(k0 + 8) * 4 + jo], WLs[(k0 + 9) * 4 + jo]) : 0u;
    a[kk][3] = 0u;
  }
  float d[NR / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) wgmma_m64n80k16_rs<0>(d, a[kk], stack_k<NR>(sl, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(d);
  if (live) {
#pragma unroll
    for (int i = 0; i < NR / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) O[(8 * i + 2 * th.q + e) * 4 + jo] = d[4 * i + e];
  }
}

template <int N, int NR>
__device__ __forceinline__ void last_dw_wg(uint32_t sl, const float* D, int so, float* ewl,
                                           const HwThread& th) {
  constexpr int KP = NR / 16;
  const int jo = th.g;
  const bool live = th.w == 0 && jo < so;
  uint32_t a[KP][4];
#pragma unroll
  for (int kp = 0; kp < KP; ++kp) {
    const int r0 = 16 * kp + 2 * th.q;
    a[kp][0] = live ? pack2(D[r0 * 4 + jo], D[(r0 + 1) * 4 + jo]) : 0u;
    a[kp][1] = 0u;
    a[kp][2] = live ? pack2(D[(r0 + 8) * 4 + jo], D[(r0 + 9) * 4 + jo]) : 0u;
    a[kp][3] = 0u;
  }
  float d[N / 2];
  wgmma_fence();
#pragma unroll
  for (int kp = 0; kp < KP; ++kp) prod_rs<N, 1>(d, a[kp], stack_mn<NR>(sl, 0, kp), kp > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(d);
  if (live) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) ewl[(8 * i + 2 * th.q + e) * so + jo] += d[4 * i + e];
  }
}

// v summed over the thread's quad positions q (the tile's points of one
// column, with the thread's own two already added); every lane gets it.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

template <int N, int SI, bool RES, bool TRAIN>
__device__ __forceinline__ void hw_consumer(const HwArgs& a, unsigned char* sm, const HwLayout& L,
                                            int c) {
  using St = Streams<SI>;
  constexpr int NVT = St::NVT, NP = St::NP, NS = St::NS, NR = St::NR, NA = St::NA;
  constexpr int NJ = N / 64;           // 64-column slabs of the width
  const int t = threadIdx.x - 128 * (c + 1);
  const HwThread th{t, t >> 5, t & 31, (t & 31) >> 2, t & 3};
  const int so = a.so, n_mats = a.n_mats;
  const SinePoly& sp = a.sp;
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(sm));
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* full = bars;
  uint64_t* empty = bars + kHwStages;
  uint64_t* wfull = bars + 2 * kHwStages;
  uint64_t* wempty = wfull + 1;
  const float4* W0f = reinterpret_cast<const float4*>(sm + L.params);
  const float* B0f = reinterpret_cast<const float*>(W0f + N);
  const float* BHf = B0f + N;
  const float4* WLf = reinterpret_cast<const float4*>(BHf + n_mats * N);
  const float* WLs = reinterpret_cast<const float*>(WLf);
  const float* BLf = reinterpret_cast<const float*>(WLf + N);
  float* O = reinterpret_cast<float*>(sm + L.obuf) + c * NR * 4;  // [NR][4]
  float* red = reinterpret_cast<float*>(sm + L.red) + c * 16;     // [4 warps][4]
  const unsigned pset = L.n_planes * L.plane_bytes;  // a consumer's planes
  const uint32_t planes_u = sbase + L.planes + c * pset;
  // the input plane of app m (m = n_mats: the last product's) in the
  // forward: K8 keeps S_0 .. S_{M-1} and writes S_last into the D plane; K7
  // ping-pongs two planes
  auto fwd_plane = [&](int m) -> unsigned { return (TRAIN ? m : (m & 1)) * L.plane_bytes; };
  const unsigned d_off = n_mats * L.plane_bytes;
  const long long o_wh = (long long)SI * N;
  const long long hid = (long long)n_mats * N * N;  // the hidden dW block of a partial row
  const long long o_wl = o_wh + hid;
  const long long o_b0 = o_wl + (long long)N * so;
  const long long o_bh = o_b0 + N;
  const long long o_bl = o_bh + (long long)n_mats * N;
  const long long n_e = (long long)(SI + so + 1 + n_mats) * N + so;  // the rest of the row
  // the consumer's sums of W0, W_last and the biases: partial offset p at
  // eacc[p < o_wh ? p : p - hid]
  float* eacc = reinterpret_cast<float*>(sm + L.eacc) + c * L.eacc_stride;
  const int S2 = 2 * gridDim.x;
  const bool owns = c < NJ;  // the hidden dW chunk this consumer owns
  float* carry = a.carry + ((size_t)(blockIdx.y * gridDim.x + blockIdx.x) * 2 + c) * (NJ * NA) * 128 + t;
#ifdef HWG_PHASE_CLOCKS
  unsigned long long phase_sum[kHwPhases] = {};
  long long phase_t = clock64();
#endif

  int base = 0, run = 0;
  for (int gi = blockIdx.y; gi < a.G; gi += gridDim.y, ++run) {
    int t_begin, t_end;
    split_tiles(a.n_tiles, gridDim.x, blockIdx.x, &t_begin, &t_end);
    const int nbt = t_end - t_begin;
    float* part = TRAIN ? a.partials + ((long long)gi * S2 + 2 * blockIdx.x + c) * a.ps : nullptr;
    float loss[3] = {0.f, 0.f, 0.f};  // value, Jacobian, Hessian
    bool first = true;
    if constexpr (TRAIN) {
      // the run's sums start at 0; the hidden dW rows the other consumer owns
      // stay 0 in this partial
      for (long long i = t; i < n_e; i += 128) eacc[i] = 0.f;
      for (long long i = t; i < hid; i += 128)
        if ((int)((i % (N * N)) / N) / 64 != c) part[o_wh + i] = 0.f;
    }
    mbar_wait(wfull, run & 1);
    for (int kt = 0; kt < nbt; ++kt) {
      const int u = base + kt, stage = u % kHwStages;
      const int p0 = (t_begin + kt) * kHwTile + kHwPts * c;  // the consumer's first point
      const int rows = max(0, min(kHwPts, a.P - p0));
      const long long row0 = (long long)gi * a.P + p0;
      const unsigned char* st = sm + L.ring + stage * L.stage_bytes;
      const float4* xs = reinterpret_cast<const float4*>(st + L.xs) + kHwPts * c;
      const float* tt = reinterpret_cast<const float*>(st + L.tt) + c * NR * 4;
      const float* tw = reinterpret_cast<const float*>(st + L.tw) + kHwPts * c;
      mbar_wait(full + stage, (u / kHwStages) & 1);
      HWG_PHASE(0);  // waiting for the tile's inputs

      // ---- first layer: z0 = x W0' + b0; values f(z0), tangent seeds
      // f'(z0) W0'[k], pair seeds f''(z0) (W0'[j] W0'[k]) (RES: the carry
      // holds them, the block's input)
      float acc[NJ][NA];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = hw_col(j, h, th);
          const float4 w4 = W0f[col];
          const float w0[4] = {w4.x, w4.y, w4.z, w4.w};
          const float b0 = B0f[col];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4 x4 = xs[2 * th.q + e];
            const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
            float z = 0.f;
#pragma unroll
            for (int k = 0; k < SI; ++k) z = fmaf(xv[k], w0[k], z);
            z += b0;
            const int o = 2 * h + e;
            float d1, d2;
            acc[j][o] = sine3(z, sp, &d1, &d2);
#pragma unroll
            for (int k = 0; k < SI; ++k) acc[j][4 * (1 + k) + o] = d1 * w0[k];
            static_for<0, NP>([&](auto pc) {
              constexpr int pa = decltype(pc)::value;
              acc[j][4 * (NVT + pa) + o] = d2 * (w0[pair_j(pa, SI)] * w0[pair_k(pa, SI)]);
            });
          }
        }
      if constexpr (RES) carry_put<NJ, NA>(carry, acc, 1.f);
#pragma unroll
      for (int j = 0; j < NJ; ++j) store_slab<NR, NA>(planes_u + fwd_plane(0), j, acc[j], th);
      fence_proxy_async();
      hw_sync(c);
      HWG_PHASE(1);

      // ---- hidden apps: Z = S_m W_m on the tensor cores (transposed), then
      // the epilogue in registers: value f(z + b), tangent f' Z_k, pair f'
      // Z_a + f'' Z_j Z_k (a resblock's second app averages with the
      // block's input)
      for (int m = 0; m < n_mats; ++m) {
        // both slabs' products in flight, one commit group each: slab 1's run
        // under slab 0's epilogue
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          z_issue<N, NR, NA>(acc[j], sbase + L.ws + m * 2 * N * N, planes_u + fwd_plane(m), j);
        HWG_PHASE(2);
        const float* bm = BHf + m * N;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (j + 1 < NJ)
            wgmma_wait<1>();
          else
            wgmma_wait<0>();
          fence_acc(acc[j]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float b = bm[hw_col(j, h, th)];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int o = 2 * h + e;
              float gd, hd;
              const float av = sine3(acc[j][o] + b, sp, &gd, &hd);
              static_for<0, NP>([&](auto pc) {
                constexpr int pa = decltype(pc)::value;
                acc[j][4 * (NVT + pa) + o] =
                    gd * acc[j][4 * (NVT + pa) + o] +
                    hd * acc[j][4 * (1 + pair_j(pa, SI)) + o] * acc[j][4 * (1 + pair_k(pa, SI)) + o];
              });
#pragma unroll
              for (int k = 0; k < SI; ++k) acc[j][4 * (1 + k) + o] = gd * acc[j][4 * (1 + k) + o];
              acc[j][o] = av;
            }
          }
          if (RES && (m & 1)) {
#pragma unroll
            for (int i = 0; i < NA; ++i) {
              const float v = 0.5f * (carry[(j * NA + i) * 128] + acc[j][i]);
              acc[j][i] = v;
              carry[(j * NA + i) * 128] = v;
            }
          }
          store_slab<NR, NA>(planes_u + fwd_plane(m + 1), j, acc[j], th);
        }
        fence_proxy_async();
        hw_sync(c);
        HWG_PHASE(3);
      }

      // ---- last product O = S_last @ W_last on the tensor cores (warp 0's
      // rows the so outputs)
      const uint32_t sl_u = planes_u + fwd_plane(n_mats);
      last_product_wg<N, NR>(sl_u, WLs, so, O, th);
      hw_sync(c);  // O is complete
      HWG_PHASE(4);

      if constexpr (!TRAIN) {
        // ---- y = O[values] + b_last; jac[r][j][k] = O[tangent k][r][j];
        // hp[r][j][a] = O[pair a][r][j], each rounded once
        bf16* yg = a.y + row0 * so;
        for (int idx = t; idx < rows * so; idx += 128) {
          const int r = idx / so;
          const int jo = idx - r * so;
          yg[idx] = __float2bfloat16_rn(O[r * 4 + jo] + BLf[jo]);
        }
        bf16* jg = a.jac + row0 * so * SI;
        for (int idx = t; idx < rows * so * SI; idx += 128) {
          const int r = idx / (so * SI);
          const int rem = idx - r * so * SI;
          const int jo = rem / SI;
          const int k = rem - jo * SI;
          jg[idx] = __float2bfloat16_rn(O[((1 + k) * kHwPts + r) * 4 + jo]);
        }
        bf16* hg = a.hp + row0 * so * NP;
        for (int idx = t; idx < rows * so * NP; idx += 128) {
          const int r = idx / (so * NP);
          const int rem = idx - r * so * NP;
          const int jo = rem / NP;
          const int pa = rem - jo * NP;
          hg[idx] = __float2bfloat16_rn(O[((NVT + pa) * kHwPts + r) * 4 + jo]);
        }
        mbar_arrive(empty + stage);  // every read of the stage is done
        HWG_PHASE(5);
      } else {
        // ---- loss: err = mask (out - t), e = mask (O_stream - target); sums
        // w err^2 (a pair's times its multiplicity); D_out = [ky w err; kj w
        // e_k; kh mult w e_a] in place of O (w is 0 past the ragged edge)
        for (int idx = t; idx < kHwPts * so; idx += 128) {
          const int p = idx / so;
          const int jo = idx - p * so;
          const float w = tw[p];
          {
            float err = O[p * 4 + jo] + BLf[jo] - tt[p * 4 + jo];
            if (a.y_mask) err = err * a.y_mask[jo];
            loss[0] += err * err * w;
            O[p * 4 + jo] = a.ky * err * w;
          }
#pragma unroll
          for (int k = 0; k < SI; ++k) {
            const int o = ((1 + k) * kHwPts + p) * 4 + jo;
            float e = O[o] - tt[o];
            if (a.jac_mask) e = e * a.jac_mask[k * so + jo];
            loss[1] += e * e * w;
            O[o] = a.kj * e * w;
          }
#pragma unroll
          for (int pa = 0; pa < NP; ++pa) {
            const int o = ((NVT + pa) * kHwPts + p) * 4 + jo;
            const float mult = pair_j(pa, SI) == pair_k(pa, SI) ? 1.f : 2.f;
            float e = O[o] - tt[o];
            if (a.hess_mask) e = e * a.hess_mask[pa * so + jo];
            loss[2] += mult * (e * e * w);
            O[o] = (a.kh * mult) * e * w;
          }
        }
        hw_sync(c);  // D_out is complete
        HWG_PHASE(8);

        // ---- last layer: dW_l = S_last^T lift(D_out) on the tensor cores,
        // db_l = the value rows' sum of D_out, and dS = lift(D_out) @ W_l^T
        // into the registers
        last_dw_wg<N, NR>(sl_u, O, so, eacc + (o_wl - hid), th);
        if (t < so) {
          float sum = 0.f;
          for (int p = 0; p < kHwPts; ++p) sum += O[p * 4 + t];
          eacc[o_bl - hid + t] += sum;
        }
        float ds[NJ][NA];  // the cotangent of the current app's output streams
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 w4 = WLf[hw_col(j, h, th)];
            const float wl[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int p = 2 * th.q + e;
#pragma unroll
              for (int s = 0; s < NS; ++s) {
                float d = 0.f;
#pragma unroll
                for (int jo = 0; jo < kHwMaxSo; ++jo)
                  if (jo < so) d = fmaf(lift<bf16>(O[(s * kHwPts + p) * 4 + jo]), wl[jo], d);
                ds[j][4 * s + 2 * h + e] = d;
              }
            }
          }
        hw_sync(c);  // every read of S_last (in the D plane) is done
        HWG_PHASE(9);

        // ---- hidden apps, last to first: Z recomputed; with du, dt_k, dh_a
        // the scaled cotangents of the app's output streams: dz = du f' + sum_k
        // dt_k Z_k f'' + sum_a dh_a (Z_a f'' + Z_j Z_k f'''); D = [dz; dt_k f'
        // + the pairs' product-rule terms; dh_a f'], each rounded to bf16;
        // then dS = D W_m^T and the owned chunk of dW_m = S_m^T D over both
        // consumers' rows (the accumulator preloaded with the partial)
        for (int m = n_mats - 1; m >= 0; --m) {
          const uint32_t w_u = sbase + L.ws + m * 2 * N * N;
          const uint32_t d_u = planes_u + d_off;
          const bool second = RES && (m & 1);
          const float scale = second ? 0.5f : 1.f;
          if (second) carry_put<NJ, NA>(carry, ds, 0.5f);  // the skip path's half
          const float* bm = BHf + m * N;
          // slab by slab: Z recomputed, then its epilogue beside the slab's
          // incoming cotangent (one slab's Z at a time bounds the registers)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            float z[NA];
            wgmma_fence();
            z_issue<N, NR, NA>(z, w_u, planes_u + fwd_plane(m), j);
            wgmma_wait<0>();
            fence_acc(z);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int col = hw_col(j, h, th);
              const float b = bm[col];
              float dzs = 0.f;  // the unrounded value-row dz of the thread's two points
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int o = 2 * h + e;
                float gd, hd, qd;
                sine_d123(z[o] + b, sp, &gd, &hd, &qd);
                float d = (scale * ds[j][o]) * gd;
#pragma unroll
                for (int k = 0; k < SI; ++k) {
                  const float dt = scale * ds[j][4 * (1 + k) + o];
                  d = d + dt * z[4 * (1 + k) + o] * hd;
                  ds[j][4 * (1 + k) + o] = dt * gd;
                }
                static_for<0, NP>([&](auto pc) {
                  constexpr int pa = decltype(pc)::value;
                  constexpr int pj = pair_j(pa, SI), pk = pair_k(pa, SI);
                  const float dh = scale * ds[j][4 * (NVT + pa) + o];
                  d = d + dh * (z[4 * (NVT + pa) + o] * hd +
                                z[4 * (1 + pj) + o] * z[4 * (1 + pk) + o] * qd);
                  ds[j][4 * (NVT + pa) + o] = lift<bf16>(dh * gd);
                  if constexpr (pj == pk) {
                    ds[j][4 * (1 + pj) + o] =
                        ds[j][4 * (1 + pj) + o] + 2.f * dh * hd * z[4 * (1 + pj) + o];
                  } else {
                    ds[j][4 * (1 + pj) + o] = ds[j][4 * (1 + pj) + o] + dh * hd * z[4 * (1 + pk) + o];
                    ds[j][4 * (1 + pk) + o] = ds[j][4 * (1 + pk) + o] + dh * hd * z[4 * (1 + pj) + o];
                  }
                });
#pragma unroll
                for (int k = 0; k < SI; ++k) ds[j][4 * (1 + k) + o] = lift<bf16>(ds[j][4 * (1 + k) + o]);
                ds[j][o] = lift<bf16>(d);
                dzs += d;
              }
              dzs = quad_sum(dzs);
              if (th.q == 0) eacc[o_bh - hid + (long long)m * N + col] += dzs;
            }
            store_slab<NR, NA>(d_u, j, ds[j], th);
          }
          fence_proxy_async();
          float dw[N / 2];
          float* dw_c = part + o_wh + (long long)m * N * N + 64LL * c * N;
          if (owns && !first) dw_load<N>(dw, dw_c, th);
          const bool block_first = RES && !(m & 1);  // dS starts from the carry
          if (block_first) carry_get<NJ, NA>(carry, ds);
          HWG_PHASE(5);
          hw_pair_sync();  // both consumers' D are complete
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int kk = 0; kk < N / 16; ++kk)
              wgmma_m64n80k16<0, 0>(ds[j], w_rows_k<N>(w_u, j, kk), stack_k<NR>(d_u, kk),
                                    kk > 0 || block_first);
          if (owns) {
            wgmma_fence();  // the partial's loads into dw land here, after dS is issued
#pragma unroll
            for (int k2 = 0; k2 < 2; ++k2) {  // consumer k2's rows
              const uint32_t pk = sbase + L.planes + k2 * pset;
#pragma unroll
              for (int kp = 0; kp < NR / 16; ++kp)
                prod<N, 1, 1>(dw, stack_mn<NR>(pk + fwd_plane(m), c, kp),
                              stack_mn<NR>(pk + d_off, 0, kp), k2 > 0 || kp > 0 || !first);
            }
          }
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int j = 0; j < NJ; ++j) fence_acc(ds[j]);
          fence_acc(dw);
          if (owns) dw_store<N>(dw, dw_c, th);
          hw_pair_sync();  // both dW products are done with the other consumer's planes
          HWG_PHASE(6);
        }

        // ---- first layer: dz0 = du f'(z0) + sum_k dt_k W0'[k] f''(z0) + sum_a
        // dh_a (W0'[j] W0'[k]) f'''(z0); dW0 collects x^T lift(dz0) and the
        // seed rows' dt_k f'(z0) and the pairs' dh_a f''(z0) W0'[the other
        // index], unrounded; db0 the unrounded dz0
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = hw_col(j, h, th);
            const float4 w4 = W0f[col];
            const float w0[4] = {w4.x, w4.y, w4.z, w4.w};
            const float b0 = B0f[col];
            float dzh[2], dkh[2][SI], xh[2][4];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float4 x4 = xs[2 * th.q + e];
              xh[e][0] = x4.x;
              xh[e][1] = x4.y;
              xh[e][2] = x4.z;
              xh[e][3] = x4.w;
              float z = 0.f;
#pragma unroll
              for (int k = 0; k < SI; ++k) z = fmaf(xh[e][k], w0[k], z);
              z += b0;
              float gd, hd, qd;
              sine_d123(z, sp, &gd, &hd, &qd);
              const int o = 2 * h + e;
              float d = ds[j][o] * gd;
#pragma unroll
              for (int k = 0; k < SI; ++k) {
                const float dt = ds[j][4 * (1 + k) + o];
                d = d + dt * w0[k] * hd;
                dkh[e][k] = dt * gd;
              }
              static_for<0, NP>([&](auto pc) {
                constexpr int pa = decltype(pc)::value;
                constexpr int pj = pair_j(pa, SI), pk = pair_k(pa, SI);
                const float dh = ds[j][4 * (NVT + pa) + o];
                d = d + dh * (w0[pj] * w0[pk]) * qd;
                if constexpr (pj == pk) {
                  dkh[e][pj] = dkh[e][pj] + 2.f * (dh * hd * w0[pj]);
                } else {
                  dkh[e][pj] = dkh[e][pj] + dh * hd * w0[pk];
                  dkh[e][pk] = dkh[e][pk] + dh * hd * w0[pj];
                }
              });
              dzh[e] = d;
            }
            const float dz0 = lift<bf16>(dzh[0]), dz1 = lift<bf16>(dzh[1]);
#pragma unroll
            for (int k = 0; k < SI; ++k) {
              const float s = quad_sum(fmaf(xh[0][k], dz0, dkh[0][k]) + fmaf(xh[1][k], dz1, dkh[1][k]));
              if (th.q == 0) eacc[k * N + col] += s;
            }
            const float s = quad_sum(dzh[0] + dzh[1]);
            if (th.q == 0) eacc[o_b0 - hid + col] += s;
          }
        mbar_arrive(empty + stage);  // every read of the stage is done
        first = false;
        HWG_PHASE(7);
      }
    }
    if constexpr (TRAIN) {
      hw_sync(c);  // every sum of the run is in eacc
      for (long long i = t; i < n_e; i += 128) part[i < o_wh ? i : i + hid] = eacc[i];
      float s[3];
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        s[l] = loss[l];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s[l] += __shfl_xor_sync(0xffffffffu, s[l], off);
      }
      if (th.lane == 0)
#pragma unroll
        for (int l = 0; l < 3; ++l) red[th.w * 4 + l] = s[l];
      hw_sync(c);
      if (t == 0)
        for (int l = 0; l < 3; ++l)
          a.partials[(long long)a.G * S2 * a.ps + ((long long)gi * S2 + 2 * blockIdx.x + c) * 3 + l] =
              red[l] + red[4 + l] + red[8 + l] + red[12 + l];
    }
    mbar_arrive(wempty);  // every read of the group's W and parameters is done
    base += nbt;
  }
#ifdef HWG_PHASE_CLOCKS
  if (t == 0)
    for (int i = 0; i < kHwPhases; ++i) atomicAdd(&hwg_phase_cycles[i], phase_sum[i]);
#endif
}

// The body of both kernels: the block's roles, after the mbarriers are set.
template <int N, bool RES, bool TRAIN>
__device__ __forceinline__ void hw_body(const CUtensorMap* wmap, const HwArgs& a) {
  extern __shared__ unsigned char smem_raw[];
  // the base aligned to 1024 as an offset into the shared array, so every
  // pointer derived from it stays in the shared window (32-bit addresses)
  const uint32_t raw_u = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* sm = smem_raw + ((1024u - (raw_u & 1023u)) & 1023u);
  const HwLayout L = hw_layout<N, kHwSi>(TRAIN, a.n_mats);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L.bars);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kHwStages; ++i) {
      mbar_init(bars + i, 32);               // full: the producer's lanes
      mbar_init(bars + kHwStages + i, 256);  // empty: both consumers' threads
    }
    mbar_init(bars + 2 * kHwStages, 33);       // W and parameters: the lanes and the TMA bytes
    mbar_init(bars + 2 * kHwStages + 1, 256);  // both consumers are done with them
    mbar_init_fence();
  }
  __syncthreads();
  const int role = threadIdx.x / 128;
  if (role == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x < 32) hw_producer<N, kHwSi, TRAIN>(a, wmap, sm, L);
  } else {
    setmaxnreg_inc<232>();
    hw_consumer<N, kHwSi, RES, TRAIN>(a, sm, L, role - 1);
  }
}

template <int N, bool RES>
__global__ void __launch_bounds__(kHwThreads, 1)
    hess_wg_kernel(const __grid_constant__ CUtensorMap wmap, const HwArgs a) {
  hw_body<N, RES, true>(&wmap, a);
}

template <int N, bool RES>
__global__ void __launch_bounds__(kHwThreads, 1)
    fwd_hess_wg_kernel(const __grid_constant__ CUtensorMap wmap, const HwArgs a) {
  hw_body<N, RES, false>(&wmap, a);
}

struct HwGeometry {
  int splits, grid_g;
  size_t smem, scratch;
};

// Status of a shape: 0 = ok, 2 = its shared-memory layout exceeds a block's
// (K8: width 128 past two hidden matrices; K7: past four), 3 = a chain,
// width, si or so the body has no instance for (widths other than 64 and
// 128, si other than 3, so above 4, no hidden matrix, a vanilla chain).
int hw_geometry(bool train, int n, int si, int so, int n_mats, int chain, int G, int P,
                HwGeometry* g) {
  if ((n != 64 && n != 128) || si != kHwSi || so < 1 || so > kHwMaxSo || n_mats < 1 || G < 1 ||
      P < 1 || (chain != kSirenPlain && chain != kSirenResblock) ||
      (chain == kSirenResblock && n_mats % 2))
    return 3;
  const HwLayout L = n == 64 ? hw_layout<64, kHwSi>(train, n_mats)
                             : hw_layout<128, kHwSi>(train, n_mats);
  g->smem = L.total + 1024;  // + the base's alignment
  const int n_tiles = (P + kHwTile - 1) / kHwTile;
  int sms = sm_count();
  sms = sms > 0 ? sms : 1;
  int S = G < sms ? sms / G : 1;
  S = S < kMaxStackSplits ? S : kMaxStackSplits;
  g->splits = S < n_tiles ? S : n_tiles;  // a tile a block at least
  const int per = sms / g->splits > 1 ? sms / g->splits : 1;
  g->grid_g = G < per ? G : per;
  g->scratch = chain == kSirenResblock
                   ? (size_t)g->splits * g->grid_g * 2 * (n / 64) * Streams<kHwSi>::NA * 128 *
                         sizeof(float)
                   : 0;
  return g->smem > kMaxSmem ? 2 : 0;
}

int hw_workspace(bool train, int n, int si, int so, int n_mats, int chain, int G, int P,
                 int* tile, int* splits, long long* smem_bytes, int* resident, int* staged_w,
                 long long* partial_floats, long long* scratch_bytes) {
  HwGeometry g{};
  const int status = hw_geometry(train, n, si, so, n_mats, chain, G, P, &g);
  if (status == 3) return status;
  const long long po = (long long)n_mats * n * n + (long long)(si + so + 1 + n_mats) * n + so;
  const long long ps = po + (po & 1);
  *tile = kHwTile;
  *splits = g.splits;
  *smem_bytes = (long long)g.smem;
  *resident = 1;
  *staged_w = 1;
  *partial_floats = train ? (long long)G * 2 * g.splits * (ps + 3) : 0;
  *scratch_bytes = (long long)g.scratch;
  return status;
}

template <int N, bool RES, bool TRAIN>
int launch_hw(const HwGeometry& geo, const CUtensorMap& map, const HwArgs& a, cudaStream_t s) {
  auto kernel = TRAIN ? hess_wg_kernel<N, RES> : fwd_hess_wg_kernel<N, RES>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(geo.splits, geo.grid_g), kHwThreads, geo.smem, s>>>(map, a);
  return (int)cudaGetLastError();
}

// Fills the arguments both modes share, encodes W's tensor map and
// launches the instance of the width and chain; returns the CUDA error of
// the launch, or cudaErrorInvalidValue for a shape or an activation the body
// does not take.
template <bool TRAIN>
int launch_body(HwArgs& a, int G, int P, int si, int so, int n, int n_mats, int chain, int act,
                long long po, long long wb_ld, HwGeometry* geo, cudaStream_t s) {
  if ((act != kSinePoly7 && act != kSinePoly9) || wb_ld < po || wb_ld % 8 ||
      hw_geometry(TRAIN, n, si, so, n_mats, chain, G, P, geo) != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int map_err = encode_w_map(&map, a.wb, n, si, n_mats, G, wb_ld);
  if (map_err != 0) return map_err;
  a.sp = sine_poly(act == kSinePoly9);
  a.G = G; a.P = P; a.so = so; a.n_mats = n_mats;
  a.n_tiles = (P + kHwTile - 1) / kHwTile;
  a.ps = po + (po & 1);
  a.wb_ld = wb_ld;
  const bool res = chain == kSirenResblock;
  if (n == 64)
    return res ? launch_hw<64, true, TRAIN>(*geo, map, a, s) : launch_hw<64, false, TRAIN>(*geo, map, a, s);
  return res ? launch_hw<128, true, TRAIN>(*geo, map, a, s) : launch_hw<128, false, TRAIN>(*geo, map, a, s);
}

}  // namespace

extern "C" {

// The geometry of the wgmma K8 at [G, P] (a status as hw_geometry() returns;
// on 0 and 2 the outputs are written), in the layout of the mma.sync body's
// entry: points per tile, P splits per group (blocks; each block's two
// consumers keep a partial of their own), dynamic shared memory per block, 1
// and 1 (the S planes and every W_m stay in shared memory), the f32
// partials the caller allocates (G*2S*ps weight grads, ps = po rounded up to
// even, then G*2S*3 losses) and the bytes of the global scratch (a
// resblock's per-thread carry).
int nif_shapenet_hess_wg_workspace(int n, int si, int so, int n_mats, int chain, int G, int P,
                                   int* tile, int* splits, long long* smem_bytes, int* resident,
                                   int* staged_w, long long* partial_floats,
                                   long long* scratch_bytes) {
  return hw_workspace(true, n, si, so, n_mats, chain, G, P, tile, splits, smem_bytes, resident,
                      staged_w, partial_floats, scratch_bytes);
}

// The geometry of the wgmma K7, as nif_shapenet_hess_wg_workspace's (no
// partials: K7 reduces nothing).
int nif_shapenet_fwd_hess_wg_workspace(int n, int si, int so, int n_mats, int chain, int G,
                                       int P, int* tile, int* splits, long long* smem_bytes,
                                       int* resident, int* staged_w, long long* partial_floats,
                                       long long* scratch_bytes) {
  return hw_workspace(false, n, si, so, n_mats, chain, G, P, tile, splits, smem_bytes, resident,
                      staged_w, partial_floats, scratch_bytes);
}

// K8 in bf16 on wgmma: the arguments of nif_shapenet_hessian_grads_tc (wb'
// rows of wb_ld >= po elements, a multiple of 8). Returns the CUDA error of
// the launches (0 on success); the kernels run asynchronously on `stream`.
int nif_shapenet_hessian_grads_wg(const void* wb, const void* x, const void* target,
                                  const void* jt, const void* ht, const void* y_mask,
                                  const void* jac_mask, const void* hess_mask, const void* weight,
                                  void* losses, void* d_wb, void* partials, void* scratch, int G,
                                  int P, int si, int so, int n, int n_mats, int chain, int act,
                                  long long po, long long wb_ld, long long n_scaled, float omega,
                                  float ky, float kj, float kh, float n_y, float n_j, float n_h,
                                  void* stream) {
  HwArgs a{};
  a.wb = static_cast<const bf16*>(wb);
  a.x = static_cast<const bf16*>(x);
  a.target = static_cast<const bf16*>(target);
  a.jt = static_cast<const bf16*>(jt);
  a.ht = static_cast<const bf16*>(ht);
  a.y_mask = static_cast<const float*>(y_mask);
  a.jac_mask = static_cast<const float*>(jac_mask);
  a.hess_mask = static_cast<const float*>(hess_mask);
  a.weight = static_cast<const bf16*>(weight);
  a.partials = static_cast<float*>(partials);
  a.carry = static_cast<float*>(scratch);
  a.ky = ky;
  a.kj = kj;
  a.kh = kh;
  HwGeometry geo{};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_body<true>(a, G, P, si, so, n, n_mats, chain, act, po, wb_ld, &geo, s);
  if (err != 0) return err;
  const LossNorms norms{{n_y, n_j, n_h}};
  return launch_stack_reduce<3>(a.partials, G, 2 * geo.splits, po, n_scaled, omega, 1.f, norms,
                                static_cast<bf16*>(d_wb), static_cast<float*>(losses), s);
}

// K7 in bf16 on wgmma: the arguments of nif_shapenet_fwd_hess_tc. Returns
// the CUDA error of the launch (0 on success); the kernel runs
// asynchronously on `stream`.
int nif_shapenet_fwd_hess_wg(const void* wb, const void* x, void* y, void* jac, void* hp,
                             void* scratch, int G, int P, int si, int so, int n, int n_mats,
                             int chain, int act, long long po, long long wb_ld, void* stream) {
  HwArgs a{};
  a.wb = static_cast<const bf16*>(wb);
  a.x = static_cast<const bf16*>(x);
  a.y = static_cast<bf16*>(y);
  a.jac = static_cast<bf16*>(jac);
  a.hp = static_cast<bf16*>(hp);
  a.carry = static_cast<float*>(scratch);
  HwGeometry geo{};
  return launch_body<false>(a, G, P, si, so, n, n_mats, chain, act, po, wb_ld, &geo,
                            static_cast<cudaStream_t>(stream));
}

#ifdef HWG_PHASE_CLOCKS
// The phase counters summed over every consumer warpgroup since the last
// call, then zeroed (the probe build only).
int nif_hwg_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, hwg_phase_cycles, sizeof(hwg_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[kHwPhases] = {};
  return (int)cudaMemcpyToSymbol(hwg_phase_cycles, zero, sizeof(zero));
}
#endif

const char* nif_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
