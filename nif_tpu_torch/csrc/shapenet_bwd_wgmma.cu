// K2's and K3's bf16 paths on Hopper's own tensor-core path: the fused MSE
// train pass of the grouped ShapeNet chain (forward, weighted MSE and
// backward in one pass, no dx) and the backward of the fused chain (the
// forward recomputed, then g_out back to d_wb and dx), one body template
// with the compile-time TRAIN flag, every hidden product a warpgroup
// wgmma.mma_async (bf16 in, f32 accumulation, both operands in shared
// memory), fed by a producer warp through mbarriers and TMA.
//
// It replaces the same TPU kernels as shapenet_bwd_tc.cu (the mma.sync body,
// which stays for the chains this one refuses): nif_tpu/ops/
// pallas_shapenet.py::_train_kernel (shapenet_mse_grads) and _bwd_kernel
// (_fused_bwd), for bfloat16 sine chains (plain or resblock SIREN) at widths
// 64 and 128, si <= 4, so <= 4. The arguments, outputs and rounding points
// are the mma.sync body's (see its header): S stored in bf16, act' rounded
// to bf16, du carried in f32, dz rounded to bf16 before its weight product
// and its bias sum, dW_last and db_last on the rounded dL/dout (for so == 1
// du starts as the f32 dL/dout times the last weight column), d_wb's
// omega_0 scaling in f32 in the split reduce. Z_m is recomputed in the
// backward (S_m @ W_m, the same products in the same order, so the same
// bits), not kept: a bf16 act' plane a layer would not fit beside the S
// planes of two warpgroups.
//
// What bounds it on an H100 SXM: operations. At the flagship train shape
// (G=32, P=32768, width 128, two hidden layers, si=3, so=1) the products are
// 208.6 GFLOP, ~0.21 ms at the 989 TFLOP/s bf16 peak; the Z recompute, the
// bias sums and the first and last layers' sums on the tensor cores add
// ~90 GFLOP the bound does not count. The element-wise work (a polynomial
// sine in the forward, its derivative, two roundings and dz in the
// backward, ~4e8 activated elements) is of the same order on the CUDA
// cores, so the design overlaps the two.
//
// Design:
// - A block is three warpgroups: warp 0 of the first is the producer, the
//   other two are consumers (setmaxnreg moves registers from the producer
//   group to them). Persistent grid (S, G'): S splits of a group's 128-point
//   tiles, at most one block per SM; a block stays on one group for its run
//   of tiles. Consumer c takes rows 64c .. 64c+63 of every tile (the
//   product's M = 64) through its own S planes and dz plane.
// - The producer stages each group once a run: every W_m by TMA
//   (cp.async.bulk.tensor, 128-byte swizzle, 64-column chunks) and the f32
//   W0, biases and W_last, under one mbarrier; then each tile's inputs into
//   a ring of two stages, each with a full and an empty mbarrier: x (f32,
//   and as bf16 into each half's E plane), the targets and point weights
//   (K3: g_out), zero past the ragged edge.
// - E plane (a half's 64 points x 64 columns, bf16): x in columns 0 ..
//   si-1, ones in column si, the rounded dL/dout in si+1 .. si+so. Every sum
//   over a half's points that is not a hidden dW is one product E^T @ B on
//   the tensor cores: with B the last S plane, rows si+1.. are dW_last; with
//   B a dz plane, row si is the bias grad and (first layer) rows 0 .. si-1
//   dW0. A consumer adds them, and db_last, into f32 sums in shared memory,
//   written to its partial once a run.
// - Products (m64nNk16, N = the width): Z_m = S_m @ W_m (A K-major from the
//   S plane, B = W_m MN-major) in the forward and the recompute; du = dz @
//   W_m^T (the same staged W_m read K-major); dW_m = S_m^T @ dz in 64-row
//   chunks (both MN-major), consumer c owning chunk c (width 64: consumer
//   0 the one chunk) over both halves' points (K = 128: its own planes,
//   then the other consumer's), the accumulator preloaded with its f32
//   partial, so a tile costs one read and one write of each chunk; a
//   resblock's first app preloads du's accumulator with half the block's
//   cotangent (a per-thread f32 carry in the global scratch). Measured
//   (PERF.md): with 64-point tiles a consumer each, two chunks a consumer a
//   tile, that partial traffic took more than half of K2's time.
// - Overlap: each consumer issues its products and waits for them on its
//   own, so one warpgroup's epilogues (sine, act', dz, the partial
//   flushes) run on the CUDA cores while the other's products are in
//   flight; a named barrier over both holds each dz plane until the other
//   consumer's dW product has read it. Strict turns (two more named
//   barriers ordering the two consumers' issues, ping-pong) were measured
//   4-8% slower and are not used (PERF.md).
// - Determinism: each consumer adds its tiles in order into its own f32
//   partial ([G, 2S, ps], the rows of the chunk it does not own 0);
//   stack_tc.cuh's ordered split reduce sums the 2S partials (K2 divides by
//   G*P*so and sums the 2S loss partials). No float atomics: two runs on the
//   same inputs give the same bits.
// - Shared memory (flagship): both W_m 64 KB, each consumer's S planes and
//   dz plane 48 KB, the ring 37 KB, the sums 11 KB: 218 KB. A chain whose
//   layout exceeds the 227 KB a block may use (width 128 past two hidden
//   matrices, width 256) is refused (status 2) and runs the mma.sync body.
#include "stack_tc.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr int kWgTile = 128;    // points of a tile: 64 rows (the product's M) a consumer
constexpr int kWgThreads = 384; // the producer warpgroup and two consumers
constexpr int kStages = 2;      // the input ring
constexpr int kEPlane = 8192;   // a 64 x 64 bf16 swizzled plane
constexpr int kBarPair = 3;     // named barriers: 1 + c a consumer's own, kBarPair both

struct WgArgs {
  const bf16* wb;       // wb' [G, wb_ld]
  const bf16* x;        // [G, P, si]
  const bf16* target;   // K2: [G, P, so]
  const bf16* weight;   // K2: [G, P], or null
  const bf16* g_out;    // K3: [G, P, so]
  bf16* dx;             // K3: [G, P, si]
  float* partials;      // [G, 2S, ps] weight-grad partials, then (K2) [G, 2S] losses
  float* carry;         // resblock: [blocks, 2, N/2, 128] per-thread f32 carry
  int G, P, si, so, n_mats, n_tiles;
  long long ps, wb_ld;
};

// Byte offsets of the dynamic shared memory (its base aligned to 1024).
struct WgLayout {
  unsigned ws, planes, ering, xs, ts, tw, params, eacc, eacc_stride, red, bars, total;
};

__host__ __device__ inline WgLayout wg_layout(int n, int n_mats) {
  WgLayout L;
  L.ws = 0;
  L.planes = L.ws + (unsigned)n_mats * 2 * n * n;          // every W_m, 64-column chunks
  L.ering = L.planes + 2u * (n_mats + 1) * 128 * n;       // per consumer: S_0 .. S_{M-1}, D
  L.xs = L.ering + kStages * 2 * kEPlane;   // a stage's two E planes (a consumer's each), then:
  L.ts = L.xs + kStages * kWgTile * 4 * 4;  // [128][4] f32 x
  L.tw = L.ts + kStages * kWgTile * 4 * 4;  // [128][4] f32 targets (K3: g_out)
  L.params = L.tw + kStages * kWgTile * 4;  // [128] f32 point weights
  // W0 [n][4], b0 [n], b_m [n_mats][n], W_last [n][4], b_last [4] (f32)
  L.eacc = L.params + 4u * (4 * n + n + n_mats * n + 4 * n + 4);
  // per consumer, the f32 sums of every grad but the hidden dW (W0, W_last,
  // the biases: the partial's row without its hidden block; si, so <= 4)
  L.eacc_stride = ((9 + n_mats) * n + 4 + 3) / 4 * 4;
  L.red = L.eacc + 2 * 4 * L.eacc_stride;
  L.bars = (L.red + 2 * 4 * 4 * 4 + 7) / 8 * 8;           // [2][4 warps][4] f32
  L.total = L.bars + 8 * (2 * kStages + 2);
  return L;
}

// Descriptors (see wgmma_sm90.cuh, which has those of a staged W_m): a
// plane [64 points, width] read K-major (the points as M, K step kk over the
// width) or read MN-major (its 64-column chunk j as M or its width as N, K
// step kp over the points).
__device__ __forceinline__ uint64_t plane_k(uint32_t plane, int kk) {
  return sw128_desc(plane + (kk >> 2) * 8192 + (kk & 3) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t plane_mn(uint32_t plane, int j, int kp) {
  return sw128_desc(plane + j * 8192 + kp * 2048, 8192, 1024);
}

template <int N, int TA, int TB>
__device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 64)
    wgmma_m64n64k16<TA, TB>(d, da, db, scale_d);
  else
    wgmma_m64n128k16<TA, TB>(d, da, db, scale_d);
}

// Built with -DWG_PHASE_CLOCKS (by scripts/port_phase_probe.py only), thread
// 0 of each consumer warpgroup adds the clock64() cycles between its marks
// into eight phase counters, which split a consumer's time.
#ifdef WG_PHASE_CLOCKS
constexpr int kWgPhases = 8;
__device__ unsigned long long wg_phase_cycles[kWgPhases];
#define WG_PHASE(i)                                        \
  do {                                                     \
    if (t == 0) {                                          \
      const long long now = clock64();                     \
      phase_sum[i] += (unsigned long long)(now - phase_t); \
      phase_t = now;                                       \
    }                                                      \
  } while (0)
#else
#define WG_PHASE(i) \
  do {              \
  } while (0)
#endif

template <int N, bool TRAIN>
__device__ __forceinline__ void producer(const WgArgs& a, const CUtensorMap* wmap,
                                         unsigned char* sm, const WgLayout& L) {
  constexpr int NCH = N / 64;
  const int lane = threadIdx.x & 31;
  const int si = a.si, so = a.so, n_mats = a.n_mats;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* full = bars;
  uint64_t* empty = bars + kStages;
  uint64_t* wfull = bars + 2 * kStages;
  uint64_t* wempty = wfull + 1;
  float* W0f = reinterpret_cast<float*>(sm + L.params);
  float* B0f = W0f + 4 * N;
  float* BHf = B0f + N;
  float* WLf = BHf + n_mats * N;
  float* BLf = WLf + 4 * N;
  const long long o_wl = (long long)si * N + (long long)n_mats * N * N;
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
      W0f[i] = k < si ? __bfloat162float(wg[k * N + c]) : 0.f;
      WLf[i] = k < so ? __bfloat162float(wg[o_wl + c * so + k]) : 0.f;
    }
    for (int i = lane; i < N; i += 32) B0f[i] = __bfloat162float(wg[o_b0 + i]);
    for (int i = lane; i < n_mats * N; i += 32) BHf[i] = __bfloat162float(wg[o_bh + i]);
    if (lane < 4) BLf[lane] = lane < so ? __bfloat162float(wg[o_bl + lane]) : 0.f;
    mbar_arrive(wfull);
    for (int kt = 0; kt < t_end - t_begin; ++kt) {
      const int u = base + kt, stage = u % kStages;
      mbar_wait(empty + stage, ((u / kStages) & 1) ^ 1);
      const int p0 = (t_begin + kt) * kWgTile;
      const int rows = min(kWgTile, a.P - p0);
      const long long row0 = (long long)gi * a.P + p0;
      unsigned char* E = sm + L.ering + stage * 2 * kEPlane;
      float* xs = reinterpret_cast<float*>(sm + L.xs) + stage * kWgTile * 4;
      float* ts = reinterpret_cast<float*>(sm + L.ts) + stage * kWgTile * 4;
      float* tw = reinterpret_cast<float*>(sm + L.tw) + stage * kWgTile;
      for (int r = lane; r < kWgTile; r += 32) {
        const bool live = r < rows;
        unsigned char* Eh = E + (r >> 6) * kEPlane;  // the E plane of the row's consumer
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bf16 v = live && k < si ? a.x[(row0 + r) * si + k] : __float2bfloat16_rn(0.f);
          xs[r * 4 + k] = __bfloat162float(v);
          if (k < si) *reinterpret_cast<bf16*>(Eh + sw_off(r & 63, k)) = v;
          const bf16* src = TRAIN ? a.target : a.g_out;
          ts[r * 4 + k] = live && k < so ? __bfloat162float(src[(row0 + r) * so + k]) : 0.f;
        }
        *reinterpret_cast<bf16*>(Eh + sw_off(r & 63, si)) = __float2bfloat16_rn(1.f);
        if (TRAIN) tw[r] = live ? (a.weight ? __bfloat162float(a.weight[row0 + r]) : 1.f) : 0.f;
      }
      fence_proxy_async();
      mbar_arrive(full + stage);
    }
    base += t_end - t_begin;
  }
}

// A consumer's thread: its warp w of the warpgroup, lane quad g and
// position q in it, and its rows r0 and r0 + 8 of the tile.
struct Thread {
  int t, w, lane, g, q, r0;
};

// Consumer c's barrier over its own 128 threads.
__device__ __forceinline__ void wg_sync(int c) { named_sync(1 + c, 128); }

// The thread's values (accumulator layout) into a bf16 plane.
template <int N>
__device__ __forceinline__ void store_plane(unsigned char* plane, const float (&v)[N / 2],
                                            const Thread& th) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(plane + (i >> 3) * 8192 + (th.r0 + 8 * h) * 128 +
                                   (((i & 7) ^ th.g) << 4) + 4 * th.q) =
          pack2(v[4 * i + 2 * h], v[4 * i + 2 * h + 1]);
}

// z0 = x W0' + b0 of the thread's elements (f32, before the activation):
// xs [64][4] f32, W0f [n][4] (k past si zero), B0f [n].
template <int N>
__device__ __forceinline__ void first_layer(const float* xs, const float4* W0f, const float* B0f,
                                            const Thread& th, float (&v)[N / 2]) {
  const float4 x0 = reinterpret_cast<const float4*>(xs)[th.r0];
  const float4 x1 = reinterpret_cast<const float4*>(xs)[th.r0 + 8];
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * i + 2 * th.q + e;
      const float4 w0 = W0f[col];
      const float b0 = B0f[col];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 xr = h ? x1 : x0;
        float z = 0.f;
        z = fmaf(xr.x, w0.x, z);
        z = fmaf(xr.y, w0.y, z);
        z = fmaf(xr.z, w0.z, z);
        z = fmaf(xr.w, w0.w, z);
        v[4 * i + 2 * h + e] = z + b0;
      }
    }
}

// Rows [lo, hi) (< 16: warp 0's) of an E-product's accumulator added into a
// consumer's shared-memory sums: element (row, col) at base[(row - lo) *
// row_stride + col * col_stride] (one thread adds to each element, in tile
// order).
template <int N>
__device__ __forceinline__ void add_rows(const float (&d)[N / 2], float* base, int lo, int hi,
                                         int row_stride, int col_stride, const Thread& th) {
  if (th.w != 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = th.g + 8 * h;
    if (row < lo || row >= hi) continue;
    float* p = base + (row - lo) * row_stride;
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) p[(8 * i + 2 * th.q + e) * col_stride] += d[4 * i + 2 * h + e];
  }
}

// A 64-row chunk of dW_m in the partial (chunk: its first row, row-major
// [64, n]), the thread's rows and columns: preloaded into the accumulator,
// and stored from it.
template <int N>
__device__ __forceinline__ void dw_load(float (&d)[N / 2], const float* chunk, const Thread& th) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 v =
          *reinterpret_cast<const float2*>(chunk + (th.r0 + 8 * h) * N + 8 * i + 2 * th.q);
      d[4 * i + 2 * h] = v.x;
      d[4 * i + 2 * h + 1] = v.y;
    }
}

template <int N>
__device__ __forceinline__ void dw_store(const float (&d)[N / 2], float* chunk, const Thread& th) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(chunk + (th.r0 + 8 * h) * N + 8 * i + 2 * th.q) =
          make_float2(d[4 * i + 2 * h], d[4 * i + 2 * h + 1]);
}

// The barrier of both consumers, over each other's planes.
__device__ __forceinline__ void pair_sync() { named_sync(kBarPair, 256); }

// DEG9: the degree-9 sine (else 7), a compile-time choice, so its
// coefficients are the products' immediates and take no registers.
template <int N, bool RES, bool TRAIN, bool DEG9>
__device__ __forceinline__ void consumer(const WgArgs& a, unsigned char* sm, const WgLayout& L,
                                         int c) {
  constexpr int NA = N / 2;   // accumulator floats a thread
  constexpr int NB = N / 8;   // its 8-column blocks
  constexpr int KS = N / 16;  // K steps over the width
  const int t = threadIdx.x - 128 * (c + 1);
  const int w = t >> 5, lane = t & 31, q = lane & 3;
  const int r0 = 16 * w + (lane >> 2);  // the thread's rows r0 and r0 + 8 of its half
  const Thread th{t, w, lane, lane >> 2, q, r0};
  const int si = a.si, so = a.so, n_mats = a.n_mats;
  const SinePoly sp = sine_poly(DEG9);
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(sm));
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* full = bars;
  uint64_t* empty = bars + kStages;
  uint64_t* wfull = bars + 2 * kStages;
  uint64_t* wempty = wfull + 1;
  const float4* W0f = reinterpret_cast<const float4*>(sm + L.params);
  const float* B0f = reinterpret_cast<const float*>(W0f + N);
  const float* BHf = B0f + N;
  const float4* WLf = reinterpret_cast<const float4*>(BHf + n_mats * N);
  const float* BLf = reinterpret_cast<const float*>(WLf + N);
  float* red = reinterpret_cast<float*>(sm + L.red) + c * 16;  // [4 warps][4]
  const unsigned plane_bytes = 128u * N;
  // consumer k's planes S_0 .. S_{M-1}, then D (S_last, then each dz), at
  // L.planes + k * plane_set
  const unsigned plane_set = (n_mats + 1) * plane_bytes;
  unsigned char* plane_ptr = sm + L.planes + c * plane_set;
  const uint32_t plane_u = sbase + L.planes + c * plane_set;
  const uint32_t dplane_u = plane_u + n_mats * plane_bytes;
  unsigned char* dplane = plane_ptr + n_mats * plane_bytes;
  const long long o_wh = (long long)si * N;
  const long long hid = (long long)n_mats * N * N;  // the hidden dW block of a partial row
  const long long o_wl = o_wh + hid;
  const long long o_b0 = o_wl + (long long)N * so;
  const long long o_bh = o_b0 + N;
  const long long o_bl = o_bh + (long long)n_mats * N;
  const long long n_e = (long long)(si + so + 1 + n_mats) * N + so;  // the rest of the row
  // the consumer's sums of W0, W_last and the biases: partial offset p at
  // eacc[p < o_wh ? p : p - hid]
  float* eacc = reinterpret_cast<float*>(sm + L.eacc) + c * L.eacc_stride;
  const int S2 = 2 * gridDim.x;
  // the hidden dW chunk this consumer owns: its 64 rows over both halves'
  // points (width 64 has one chunk, consumer 0's)
  const bool owns = c < N / 64;
  float* carry = a.carry + ((size_t)(blockIdx.y * gridDim.x + blockIdx.x) * 2 + c) * NA * 128 + t;
#ifdef WG_PHASE_CLOCKS
  unsigned long long phase_sum[kWgPhases] = {};
  long long phase_t = clock64();
#endif

  int base = 0, run = 0;
  for (int gi = blockIdx.y; gi < a.G; gi += gridDim.y, ++run) {
    int t_begin, t_end;
    split_tiles(a.n_tiles, gridDim.x, blockIdx.x, &t_begin, &t_end);
    const int nbt = t_end - t_begin;
    float* part = a.partials + ((long long)gi * S2 + 2 * blockIdx.x + c) * a.ps;
    float loss = 0.f;
    bool first = true;
    // the run's sums start at 0; the hidden dW rows the other consumer owns
    // stay 0 in this partial
    for (long long i = t; i < n_e; i += 128) eacc[i] = 0.f;
    for (long long i = t; i < hid; i += 128)
      if ((int)((i % (N * N)) / N) / 64 != c) part[o_wh + i] = 0.f;
    mbar_wait(wfull, run & 1);
    for (int kt = 0; kt < nbt; ++kt) {
      const int u = base + kt, stage = u % kStages;
      const int p0 = (t_begin + kt) * kWgTile + 64 * c;  // the first point of this half
      const int rows = max(0, min(64, a.P - p0));
      const long long row0 = (long long)gi * a.P + p0;
      const float* xs = reinterpret_cast<const float*>(sm + L.xs) + (stage * kWgTile + 64 * c) * 4;
      const float4* ts = reinterpret_cast<const float4*>(sm + L.ts) + stage * kWgTile + 64 * c;
      const float* tw = reinterpret_cast<const float*>(sm + L.tw) + stage * kWgTile + 64 * c;
      unsigned char* E = sm + L.ering + (stage * 2 + c) * kEPlane;
      const uint32_t e_u = sbase + L.ering + (stage * 2 + c) * kEPlane;
      mbar_wait(full + stage, (u / kStages) & 1);
      WG_PHASE(0);  // waiting for the tile's inputs

      // ---- first layer: S_0 = f(x W0' + b0) (RES: U = S_0 in f32)
      float acc[NA], U[RES ? NA : 1];
      first_layer<N>(xs, W0f, B0f, th, acc);
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = sine_of(acc[i], sp);
      if constexpr (RES) {
#pragma unroll
        for (int i = 0; i < NA; ++i) U[i] = acc[i];
      }
      store_plane<N>(plane_ptr, acc, th);
      fence_proxy_async();
      wg_sync(c);
      WG_PHASE(1);

      // ---- hidden apps: Z = S_m W_m on the tensor cores, S_{m+1} = f(Z +
      // b_m) (a resblock's second app averages with the block's input in
      // f32); the last one's output goes to the D plane
      for (int m = 0; m < n_mats; ++m) {
          wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          mma<N, 0, 1>(acc, plane_k(plane_u + m * plane_bytes, kk),
                       w_mn<N>(sbase + L.ws + m * 2 * N * N, kk), kk > 0);
        wgmma_commit();
          wgmma_wait<0>();
        fence_acc(acc);
        WG_PHASE(2);
        const float* bm = BHf + m * N;
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const float2 b = *reinterpret_cast<const float2*>(bm + 8 * i + 2 * q);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = sine_of(acc[4 * i + e] + ((e & 1) ? b.y : b.x), sp);
            if constexpr (RES) {
              if (m & 1) {
                v = 0.5f * (U[4 * i + e] + v);
                U[4 * i + e] = v;
              }
            }
            acc[4 * i + e] = v;
          }
        }
        store_plane<N>(m + 1 < n_mats ? plane_ptr + (m + 1) * plane_bytes : dplane, acc, th);
        if (m + 1 < n_mats) {
          fence_proxy_async();
          wg_sync(c);
        }
        WG_PHASE(3);
      }

      // ---- last layer: out = S_last W_last + b_last in f32 (the quad's
      // four lanes hold a row's columns), the loss and dL/dout (K3: g_out)
      float go[2][4];
      {
        float o[2][4] = {};
#pragma unroll
        for (int i = 0; i < NB; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4 wl = WLf[8 * i + 2 * q + e];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float s = lift<bf16>(acc[4 * i + 2 * h + e]);
              o[h][0] = fmaf(s, wl.x, o[h][0]);
              o[h][1] = fmaf(s, wl.y, o[h][1]);
              o[h][2] = fmaf(s, wl.z, o[h][2]);
              o[h][3] = fmaf(s, wl.w, o[h][3]);
            }
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * h;
          const float4 tv = ts[row];
          const float tj[4] = {tv.x, tv.y, tv.z, tv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float v = o[h][j];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            if constexpr (TRAIN) {  // past the ragged edge and past so: weight or err 0
              const float err = v + BLf[j] - tj[j];
              const float wt = tw[row];
              if (q == 0) loss += err * err * wt;
              go[h][j] = 2.f * err * wt;
            } else {
              go[h][j] = tj[j];
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (q == 0 && j < so)
              *reinterpret_cast<bf16*>(E + sw_off(row, si + 1 + j)) = __float2bfloat16_rn(go[h][j]);
        }
        // db_last: the half's sum of the rounded dL/dout, warp by warp
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float s = lift<bf16>(go[0][j]) + lift<bf16>(go[1][j]);
          s += __shfl_xor_sync(0xffffffffu, s, 4);
          s += __shfl_xor_sync(0xffffffffu, s, 8);
          s += __shfl_xor_sync(0xffffffffu, s, 16);
          if (lane == 0) red[w * 4 + j] = s;
        }
      }
      fence_proxy_async();
      wg_sync(c);  // S_last in D, dL/dout in E, the warps' db_last sums
      // dW_last^T = rows si+1 .. si+so of E^T S_last, on the tensor cores
      // while du = dL/dout W_last^T (so == 1: the f32 dL/dout times the
      // column) runs in registers
      float du[NA];
      {
        float d2[NA];
          wgmma_fence();
#pragma unroll
        for (int kp = 0; kp < 4; ++kp)
          mma<N, 1, 1>(d2, plane_mn(e_u, 0, kp), plane_mn(dplane_u, 0, kp), kp > 0);
        wgmma_commit();
          if (t == 0)
          for (int j = 0; j < so; ++j)
            eacc[o_bl - hid + j] += red[j] + red[4 + j] + red[8 + j] + red[12 + j];
#pragma unroll
        for (int i = 0; i < NB; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4 wl = WLf[8 * i + 2 * q + e];
#pragma unroll
            for (int h = 0; h < 2; ++h)
              du[4 * i + 2 * h + e] =
                  so == 1 ? go[h][0] * wl.x
                          : fmaf(lift<bf16>(go[h][3]), wl.w,
                                 fmaf(lift<bf16>(go[h][2]), wl.z,
                                      fmaf(lift<bf16>(go[h][1]), wl.y, lift<bf16>(go[h][0]) * wl.x)));
          }
        wgmma_wait<0>();
        fence_acc(d2);
        add_rows<N>(d2, eacc + o_wl - hid, si + 1, si + 1 + so, 1, so, th);
      }
      WG_PHASE(4);

      // ---- hidden apps, last to first: Z recomputed, dz = lift((scale du)
      // lift(act'(Z + b))) into the D plane, then du = dz W_m^T, the owned
      // 64-row chunk of dW_m = S_m^T dz over both halves' points (the
      // accumulator preloaded with the partial) and db_m = row si of E^T dz
      for (int m = n_mats - 1; m >= 0; --m) {
        const uint32_t w_u = sbase + L.ws + m * 2 * N * N;
        const bool second = RES && (m & 1);
        if (second) {  // half the block's cotangent, for its first app's du
#pragma unroll
          for (int i = 0; i < NA; ++i) carry[i * 128] = 0.5f * du[i];
        }
          wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          mma<N, 0, 1>(acc, plane_k(plane_u + m * plane_bytes, kk), w_mn<N>(w_u, kk), kk > 0);
        wgmma_commit();
          wgmma_wait<0>();
        fence_acc(acc);
        WG_PHASE(5);
        // the owned chunk's partial, loaded while the epilogue runs
        float dw[NA];
        float* dw_c = part + o_wh + (long long)m * N * N + 64LL * c * N;
        if (owns && !first) dw_load<N>(dw, dw_c, th);
        const float* bm = BHf + m * N;
        const float scale = second ? 0.5f : 1.f;
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const float2 b = *reinterpret_cast<const float2*>(bm + 8 * i + 2 * q);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float d = lift<bf16>(sine_slope(acc[4 * i + e] + ((e & 1) ? b.y : b.x), sp));
            acc[4 * i + e] = lift<bf16>(scale * du[4 * i + e] * d);
          }
        }
        store_plane<N>(dplane, acc, th);
        const bool block_first = RES && !(m & 1);  // du starts from the carry
        if (block_first) {
#pragma unroll
          for (int i = 0; i < NA; ++i) du[i] = carry[i * 128];
        }
        fence_proxy_async();
        pair_sync();  // both halves' dz are complete
        WG_PHASE(6);
          wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          mma<N, 0, 0>(du, plane_k(dplane_u, kk), w_k<N>(w_u, kk), kk > 0 || block_first);
        if (owns) {
#pragma unroll
          for (int k = 0; k < 2; ++k) {  // consumer k's half of the tile's points
            const uint32_t pk = sbase + L.planes + k * plane_set;
#pragma unroll
            for (int kp = 0; kp < 4; ++kp)
              mma<N, 1, 1>(dw, plane_mn(pk + m * plane_bytes, c, kp),
                           plane_mn(pk + n_mats * plane_bytes, 0, kp), k > 0 || kp > 0 || !first);
          }
        }
        wgmma_commit();
          wgmma_wait<0>();
        fence_acc(du);
        fence_acc(dw);
        WG_PHASE(5);
        if (owns) dw_store<N>(dw, dw_c, th);
          wgmma_fence();
#pragma unroll
        for (int kp = 0; kp < 4; ++kp)
          mma<N, 1, 1>(dw, plane_mn(e_u, 0, kp), plane_mn(dplane_u, 0, kp), kp > 0);
        wgmma_commit();
          wgmma_wait<0>();
        fence_acc(dw);
        add_rows<N>(dw, eacc + o_bh - hid + (long long)m * N, si, si + 1, 0, 1, th);
        pair_sync();  // both dW products are done with the other half's planes
        WG_PHASE(7);
      }

      // ---- first layer: dz0 = lift(du lift(f'(z0))) (K3: dx = dz0 W0'^T,
      // summed in f32 and rounded), then dW0 and db0 = rows 0 .. si of E^T dz0
      first_layer<N>(xs, W0f, B0f, th, acc);
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = lift<bf16>(du[i] * lift<bf16>(sine_slope(acc[i], sp)));
      if constexpr (!TRAIN) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float s[4] = {};
#pragma unroll
          for (int i = 0; i < NB; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float4 w0 = W0f[8 * i + 2 * q + e];
              const float v = acc[4 * i + 2 * h + e];
              s[0] = fmaf(v, w0.x, s[0]);
              s[1] = fmaf(v, w0.y, s[1]);
              s[2] = fmaf(v, w0.z, s[2]);
              s[3] = fmaf(v, w0.w, s[3]);
            }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            s[k] += __shfl_xor_sync(0xffffffffu, s[k], 1);
            s[k] += __shfl_xor_sync(0xffffffffu, s[k], 2);
          }
          const int row = r0 + 8 * h;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (q == 0 && row < rows && k < si)
              a.dx[(row0 + row) * si + k] = __float2bfloat16_rn(s[k]);
        }
      }
      store_plane<N>(dplane, acc, th);
      fence_proxy_async();
      wg_sync(c);
      wgmma_fence();
#pragma unroll
      for (int kp = 0; kp < 4; ++kp)
        mma<N, 1, 1>(acc, plane_mn(e_u, 0, kp), plane_mn(dplane_u, 0, kp), kp > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      add_rows<N>(acc, eacc, 0, si, N, 1, th);
      add_rows<N>(acc, eacc + o_b0 - hid, si, si + 1, 0, 1, th);
      mbar_arrive(empty + stage);  // every read of the stage is done
      first = false;
      WG_PHASE(7);
    }
    wg_sync(c);  // every sum of the run is in eacc
    for (long long i = t; i < n_e; i += 128) part[i < o_wh ? i : i + hid] = eacc[i];
    if constexpr (TRAIN) {
      float s = loss;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      wg_sync(c);  // every read of red is done
      if (lane == 0) red[w * 4] = s;
      wg_sync(c);
      if (t == 0)
        a.partials[(long long)a.G * S2 * a.ps + (long long)gi * S2 + 2 * blockIdx.x + c] =
            red[0] + red[4] + red[8] + red[12];
    }
    mbar_arrive(wempty);  // every read of the group's W and parameters is done
    base += nbt;
  }
#ifdef WG_PHASE_CLOCKS
  if (t == 0)
    for (int i = 0; i < kWgPhases; ++i) atomicAdd(&wg_phase_cycles[i], phase_sum[i]);
#endif
}

// The body of both kernels: the block's roles, after the mbarriers are set.
template <int N, bool RES, bool TRAIN, bool DEG9>
__device__ __forceinline__ void wg_body(const CUtensorMap* wmap, const WgArgs& a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const WgLayout L = wg_layout(N, a.n_mats);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L.bars);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(bars + i, 32);               // full: the producer's lanes
      mbar_init(bars + kStages + i, 256);    // empty: both consumers' threads
    }
    mbar_init(bars + 2 * kStages, 33);       // W and parameters: the lanes and the TMA bytes
    mbar_init(bars + 2 * kStages + 1, 256);  // both consumers are done with them
    mbar_init_fence();
  }
  __syncthreads();
  const int role = threadIdx.x / 128;
  if (role == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x < 32) producer<N, TRAIN>(a, wmap, sm, L);
  } else {
    setmaxnreg_inc<232>();
    consumer<N, RES, TRAIN, DEG9>(a, sm, L, role - 1);
  }
}

template <int N, bool RES, bool DEG9>
__global__ void __launch_bounds__(kWgThreads, 1)
    mse_wg_kernel(const __grid_constant__ CUtensorMap wmap, const WgArgs a) {
  wg_body<N, RES, true, DEG9>(&wmap, a);
}

template <int N, bool RES, bool DEG9>
__global__ void __launch_bounds__(kWgThreads, 1)
    bwd_wg_kernel(const __grid_constant__ CUtensorMap wmap, const WgArgs a) {
  wg_body<N, RES, false, DEG9>(&wmap, a);
}

struct WgGeometry {
  int splits, grid_g;
  size_t smem, scratch;
};

// Status of a shape: 0 = ok, 2 = its shared-memory layout exceeds a block's
// (widths 128 past two hidden matrices), 3 = a chain, width, si or so the
// body does not take (widths other than 64 and 128, si or so above 4, no
// hidden matrix, a vanilla chain).
int wg_geometry(int n, int si, int so, int n_mats, int chain, int G, int P, WgGeometry* g) {
  if ((n != 64 && n != 128) || si < 1 || si > 4 || so < 1 || so > 4 || n_mats < 1 || G < 1 ||
      P < 1 || (chain != kSirenPlain && chain != kSirenResblock) ||
      (chain == kSirenResblock && n_mats % 2))
    return 3;
  g->smem = wg_layout(n, n_mats).total + 1024;  // + the base's alignment
  const int n_tiles = (P + kWgTile - 1) / kWgTile;
  int sms = sm_count();
  sms = sms > 0 ? sms : 1;
  int S = G < sms ? sms / G : 1;
  S = S < kMaxStackSplits ? S : kMaxStackSplits;
  g->splits = S < n_tiles ? S : n_tiles;  // a tile a block at least
  const int per = sms / g->splits > 1 ? sms / g->splits : 1;
  g->grid_g = G < per ? G : per;
  g->scratch = chain == kSirenResblock
                   ? (size_t)g->splits * g->grid_g * 2 * (n / 2) * 128 * sizeof(float)
                   : 0;
  return g->smem > kMaxSmem ? 2 : 0;
}

int workspace(bool train, int n, int si, int so, int n_mats, int chain, int G, int P, int* tile,
              int* splits, long long* smem_bytes, int* resident, int* staged_w,
              long long* partial_floats, long long* scratch_bytes) {
  WgGeometry g{};
  const int status = wg_geometry(n, si, so, n_mats, chain, G, P, &g);
  if (status == 3) return status;
  const long long po = (long long)n_mats * n * n + (long long)(si + so + 1 + n_mats) * n + so;
  const long long ps = po + (po & 1);
  *tile = kWgTile;
  *splits = g.splits;
  *smem_bytes = (long long)g.smem;
  *resident = 1;
  *staged_w = 1;
  *partial_floats = (long long)G * 2 * g.splits * (ps + (train ? 1 : 0));
  *scratch_bytes = (long long)g.scratch;
  return status;
}

template <int N, bool RES, bool TRAIN, bool DEG9>
int launch_wg(const WgGeometry& geo, const CUtensorMap& map, const WgArgs& a, cudaStream_t s) {
  auto kernel = TRAIN ? mse_wg_kernel<N, RES, DEG9> : bwd_wg_kernel<N, RES, DEG9>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(geo.splits, geo.grid_g), kWgThreads, geo.smem, s>>>(map, a);
  return (int)cudaGetLastError();
}

// The instance of a width, chain and sine degree.
template <bool TRAIN, int N>
int launch_chain(bool res, bool deg9, const WgGeometry& geo, const CUtensorMap& map,
                 const WgArgs& a, cudaStream_t s) {
  if (res)
    return deg9 ? launch_wg<N, true, TRAIN, true>(geo, map, a, s)
                : launch_wg<N, true, TRAIN, false>(geo, map, a, s);
  return deg9 ? launch_wg<N, false, TRAIN, true>(geo, map, a, s)
              : launch_wg<N, false, TRAIN, false>(geo, map, a, s);
}

template <bool TRAIN>
int launch_width(int n, bool res, bool deg9, const WgGeometry& geo, const CUtensorMap& map,
                 const WgArgs& a, cudaStream_t s) {
  return n == 64 ? launch_chain<TRAIN, 64>(res, deg9, geo, map, a, s)
                 : launch_chain<TRAIN, 128>(res, deg9, geo, map, a, s);
}

// Fills the arguments both modes share, encodes W's tensor map and
// launches the body of a mode; returns the CUDA error of the launch, or
// cudaErrorInvalidValue for a shape or an activation the body does not take.
template <bool TRAIN>
int launch_body(WgArgs& a, int G, int P, int si, int so, int n, int n_mats, int chain, int act,
                long long po, long long wb_ld, WgGeometry* geo, cudaStream_t s) {
  if ((act != kSinePoly7 && act != kSinePoly9) || wb_ld < po || wb_ld % 8 ||
      wg_geometry(n, si, so, n_mats, chain, G, P, geo) != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int map_err = encode_w_map(&map, a.wb, n, si, n_mats, G, wb_ld);
  if (map_err != 0) return map_err;
  a.G = G; a.P = P; a.si = si; a.so = so; a.n_mats = n_mats;
  a.n_tiles = (P + kWgTile - 1) / kWgTile;
  a.ps = po + (po & 1);
  a.wb_ld = wb_ld;
  return launch_width<TRAIN>(n, chain == kSirenResblock, act == kSinePoly9, *geo, map, a, s);
}

}  // namespace

extern "C" {

// The geometry of the wgmma K2 at [G, P] (a status as wg_geometry() returns;
// on 0 and 2 the outputs are written): points per tile, P splits per group
// (blocks; each block's two consumers keep a partial of their own), dynamic
// shared memory per block, 1 and 1 (the S planes and every W_m stay in
// shared memory), the f32 partials the caller allocates (G*2S*ps weight
// grads, ps = po rounded up to even, then G*2S losses) and the bytes of the
// global scratch (a resblock's per-thread carry).
int nif_shapenet_mse_wg_workspace(int n, int si, int so, int n_mats, int chain, int G, int P,
                                  int* tile, int* splits, long long* smem_bytes, int* resident,
                                  int* staged_w, long long* partial_floats,
                                  long long* scratch_bytes) {
  return workspace(true, n, si, so, n_mats, chain, G, P, tile, splits, smem_bytes, resident,
                   staged_w, partial_floats, scratch_bytes);
}

// The geometry of the wgmma K3, as nif_shapenet_mse_wg_workspace's (its
// partials hold no losses: G*2S*ps floats).
int nif_shapenet_bwd_wg_workspace(int n, int si, int so, int n_mats, int chain, int G, int P,
                                  int* tile, int* splits, long long* smem_bytes, int* resident,
                                  int* staged_w, long long* partial_floats,
                                  long long* scratch_bytes) {
  return workspace(false, n, si, so, n_mats, chain, G, P, tile, splits, smem_bytes, resident,
                   staged_w, partial_floats, scratch_bytes);
}

// K2 in bf16 on wgmma: the arguments of nif_shapenet_mse_grads_tc (wb' rows
// of wb_ld >= po elements, a multiple of 8; weight may be null). Returns
// the CUDA error of the launches (0 on success); the kernels run
// asynchronously on `stream`.
int nif_shapenet_mse_grads_wg(const void* wb, const void* x, const void* target,
                              const void* weight, void* loss, void* d_wb, void* partials,
                              void* scratch, int G, int P, int si, int so, int n, int n_mats,
                              int chain, int act, long long po, long long wb_ld,
                              long long n_scaled, float omega, void* stream) {
  WgArgs a{};
  a.wb = static_cast<const bf16*>(wb);
  a.x = static_cast<const bf16*>(x);
  a.target = static_cast<const bf16*>(target);
  a.weight = static_cast<const bf16*>(weight);
  a.partials = static_cast<float*>(partials);
  a.carry = static_cast<float*>(scratch);
  WgGeometry geo{};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_body<true>(a, G, P, si, so, n, n_mats, chain, act, po, wb_ld, &geo, s);
  if (err != 0) return err;
  const float n_elem = (float)((long long)G * P * so);
  const LossNorms norms{{n_elem}};
  return launch_stack_reduce<1>(a.partials, G, 2 * geo.splits, po, n_scaled, omega, n_elem,
                                norms, static_cast<bf16*>(d_wb), static_cast<float*>(loss), s);
}

// K3 in bf16 on wgmma: the arguments of nif_shapenet_bwd_tc. Returns the
// CUDA error of the launches (0 on success); the kernels run asynchronously
// on `stream`.
int nif_shapenet_bwd_wg(const void* wb, const void* x, const void* g_out, void* d_wb, void* dx,
                        void* partials, void* scratch, int G, int P, int si, int so, int n,
                        int n_mats, int chain, int act, long long po, long long wb_ld,
                        long long n_scaled, float omega, void* stream) {
  WgArgs a{};
  a.wb = static_cast<const bf16*>(wb);
  a.x = static_cast<const bf16*>(x);
  a.g_out = static_cast<const bf16*>(g_out);
  a.dx = static_cast<bf16*>(dx);
  a.partials = static_cast<float*>(partials);
  a.carry = static_cast<float*>(scratch);
  WgGeometry geo{};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_body<false>(a, G, P, si, so, n, n_mats, chain, act, po, wb_ld, &geo, s);
  if (err != 0) return err;
  return launch_stack_reduce<0>(a.partials, G, 2 * geo.splits, po, n_scaled, omega, 1.f,
                                LossNorms{}, static_cast<bf16*>(d_wb), nullptr, s);
}

#ifdef WG_PHASE_CLOCKS
// The phase counters summed over every consumer warpgroup since the last
// call, then zeroed (the probe build only).
int nif_wg_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, wg_phase_cycles, sizeof(wg_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[kWgPhases] = {};
  return (int)cudaMemcpyToSymbol(wg_phase_cycles, zero, sizeof(zero));
}
#endif

const char* nif_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
