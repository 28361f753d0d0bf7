// K1's and K5's reverse bf16 paths on Hopper's own tensor-core path: the
// forward of the grouped ShapeNet chain (the serving kernel) and the fused
// Jacobian by reverse cotangent sweeps, one body template with the
// compile-time JAC flag, every hidden product a warpgroup wgmma.mma_async
// (bf16 in, f32 accumulation) whose A operand is the previous layer's
// activations in registers and whose B operand is W_m in shared memory,
// staged by TMA from a producer warp. Both are forward-only: no weight
// grads, no partials, no reduce.
//
// It replaces the same TPU kernels as shapenet_fwd_tc.cu (the mma.sync
// body, which stays for the chains this one refuses): nif_tpu/ops/
// pallas_shapenet.py::_fwd_kernel (shapenet_grouped_fused -> _fwd_pallas)
// and _fwd_jac_rev_kernel (shapenet_fwd_jac with so < si), for bfloat16
// sine chains (plain or resblock SIREN) at widths 64 and 128, si <= 4 and
// so <= 4 (K5: so < si). The arguments, outputs and rounding points are
// the mma.sync body's (see its header): each hidden layer's input rounded
// to bf16, z + b and every sum in f32, a resblock's running state and
// average in f32, the last product summed in f32 and rounded once at its
// store; K5's act' rounded to bf16, du carried in f32, each dz rounded to
// bf16, dz0 = lift(du lift(act'(z0))) (act'(z0) kept from the forward
// here, recomputed there), jac summed in f32.
// Every product takes bf16 values and sums exactly in f32 on both bodies;
// only the order of the f32 sums differs, so the bits may differ from the
// mma.sync body's.
//
// Refused (status 3; the wrappers route them to the mma.sync body, then to
// the CUDA-core one): widths other than 64 and 128 (width 256 among them),
// vanilla chains, si > 4, so > 4 (NIF-linear's so = 128 trunk), chains
// without a hidden matrix, and K5 with so >= si (its tangent body). Status
// 2: a layout past the 227 KB a block may use (width 128 past six hidden
// matrices for K1, past two for K5).
//
// What bounds them on an H100 SXM: operations. At the flagship shape (G=32,
// P=32768, width 128, two hidden layers, si=3, so=1) K1's products are 69.8
// GFLOP and its ~403 M sine evaluations ~0.084 ms on the f32 cores (the
// larger of the two; utils/roofline.py::kernel_cost); K5's reverse body adds
// the sweep's products, 139.3 GFLOP in all, 0.141 ms at the 989 TFLOP/s
// bf16 peak. The element-wise work (a polynomial sine a hidden element, its
// slope and a dz for K5) runs on the CUDA cores at the same order of time,
// so the design gives the CUDA cores nothing but that work and overlaps it
// with the products.
//
// Design:
// - A block is three warpgroups: warp 0 of the first is the producer, the
//   other two are consumers (setmaxnreg moves registers to them).
//   Persistent grid (S, G'): S splits of a group's 128-point tiles, at most
//   one block per SM; a block stays on one group for its run of tiles.
//   Consumer c takes rows 64c .. 64c+63 of every tile (the product's M).
// - The producer stages each group once a run: every W_m by TMA (128-byte
//   swizzle, 64-column chunks); W0' as a bf16 operand of 16 rows (rows past
//   si zero), W_last^T as one of 8 rows (rows past so zero), both swizzled
//   by its own stores; the f32 biases (and, for K5's sweeps, W_last) under
//   one mbarrier; then each tile's x (bf16, zero past the ragged edge and
//   past si) into a ring of four stages, each with a full and an empty
//   mbarrier.
// - Every product is a wgmma whose A operand comes from registers: after
//   + b, the sine and the bf16 rounding, the f32 accumulator of a product
//   (m64nNk16) is packed pairwise in place into the A operand of the next
//   (the layout of wgmma_sm90.cuh), so no layer stores a plane, waits at a
//   block barrier or reloads one. The first layer is one m64nNk16 step with
//   the thread's x pairs as A (x is bf16, so its products are exact); the
//   last product is m64n8k16 over the packed S_last, its four lanes' output
//   columns stored as they come.
// - K5 keeps each app's act' (the first layer's and every hidden one's) as
//   packed bf16 in a per-consumer, per-thread slot of shared memory (16-byte
//   stores, no bank conflict): 128 n bytes an app a consumer. Then one sweep
//   per output column j: du starts as the f32 column W_last[:, j]; for each
//   hidden app, last to first, dz = lift(scale du act') (scale 0.5 on a
//   resblock's second app) packed into the A operand and du = dz W_m^T on
//   wgmma over the same staged W_m read K-major (a resblock's first app
//   preloads du's accumulator with half the block's cotangent, kept in
//   registers); last, dz0 = lift(du act'(z0)) packed, and jac[:, j, :] =
//   dz0 W0'^T by m64n16k16 over the staged W0' read K-major.
// - Overlap: each consumer issues its products and waits for them on its
//   own, so one warpgroup's epilogues run on the CUDA cores while the
//   other's products are in flight; the consumers share no barrier.
// - Determinism: nothing is summed across blocks or threads other than in
//   a fixed order, so two runs on the same inputs give the same bits.
// - Shared memory (flagship): both W_m 64 KB and the rest 14 KB for K1; K5
//   adds its act' slots, 96 KB.
#include "stack_tc.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr int kFwTile = 128;     // points of a tile: 64 rows (the product's M) a consumer
constexpr int kFwThreads = 384;  // the producer warpgroup and two consumers
constexpr int kFwStages = 4;     // the x ring

struct FwArgs {
  const bf16* wb;  // wb' [G, wb_ld]
  const bf16* x;   // [G, P, si]
  bf16* y;         // [G, P, so]
  bf16* jac;       // K5: [G, P, so, si]
  int G, P, si, so, n_mats, n_tiles;
  long long wb_ld;
};

// Byte offsets of the dynamic shared memory (its base aligned to 1024).
struct FwLayout {
  unsigned ws, w0, wl, acts, xs, params, bars, total;
};

__host__ __device__ inline FwLayout fw_layout(int n, int n_mats, bool jac) {
  FwLayout L;
  L.ws = 0;
  L.w0 = L.ws + (unsigned)n_mats * 2 * n * n;   // every W_m, 64-column chunks of n rows
  L.wl = L.w0 + 32u * n;                          // W0' [16, n], chunks of 16 rows
  L.acts = L.wl + 16u * n;                        // W_last^T [8, n], chunks of 8 rows
  L.xs = L.acts + (jac ? 2u * (n_mats + 1) * 128 * n : 0u);  // K5: each consumer's act'
  L.params = L.xs + kFwStages * kFwTile * 8;      // [128][4] bf16 x a stage
  // b0 [n], b_m [n_mats][n], W_last [n][4] (K5's du), b_last [4] (f32)
  L.bars = (L.params + 4u * (5 * n + n_mats * n + 4) + 7) / 8 * 8;
  L.total = L.bars + 8 * (2 * kFwStages + 2);
  return L;
}

// d (+)= A B with A from registers (K step: four of them) and B by
// descriptor; TB: 0 K-major, 1 MN-major.
template <int N, int TB>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t* a, uint64_t db,
                                       int scale_d) {
  if constexpr (N == 64)
    wgmma_m64n64k16_rs<TB>(d, a, db, scale_d);
  else
    wgmma_m64n128k16_rs<TB>(d, a, db, scale_d);
}

// The f32 values of the low and high bf16 of a packed pair.
__device__ __forceinline__ float lo_of(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_of(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// The bf16 sine's polynomial in t (s = t t) and its derivative in t: the
// degree-9 form of stack_tc.cuh, or for degree 7 the same without its zero
// top coefficient (its innermost step s * 0 + c7 is c7, so the bits are
// the same and each evaluation saves an FMA).
template <bool DEG9>
__device__ __forceinline__ float poly_value(float t, float s, const SinePoly& k) {
  if constexpr (DEG9)
    return sine_value(t, s, k);
  else
    return t * (k.c1 + s * (k.c3 + s * (k.c5 + s * k.c7)));
}
template <bool DEG9>
__device__ __forceinline__ float poly_dt(float s, const SinePoly& k) {
  if constexpr (DEG9)
    return sine_dt(s, k);
  else
    return k.d0 + s * (k.d2 + s * (k.d4 + s * k.d6));
}

// The bf16 sine of z (the bits of sine_of), and with its slope from one
// range reduction (the bits of sine_slope).
template <bool DEG9>
__device__ __forceinline__ float sine_at(float z, const SinePoly& k) {
  const float t = sin_turns(z);
  return poly_value<DEG9>(t, t * t, k);
}
template <bool DEG9>
__device__ __forceinline__ float sine_and_slope(float z, const SinePoly& k, float* d1) {
  const float t = sin_turns(z);
  const float s = t * t;
  *d1 = poly_dt<DEG9>(s, k) * kInv2Pi;
  return poly_value<DEG9>(t, s, k);
}

// Built with -DFWG_PHASE_CLOCKS (by scripts/port_phase_probe.py only),
// thread 0 of each consumer warpgroup adds the clock64() cycles between its
// marks into eight phase counters, which split a consumer's time.
#ifdef FWG_PHASE_CLOCKS
constexpr int kFwPhases = 8;
__device__ unsigned long long fwg_phase_cycles[kFwPhases];
#define FW_PHASE(i)                                        \
  do {                                                     \
    if (t == 0) {                                          \
      const long long now = clock64();                     \
      phase_sum[i] += (unsigned long long)(now - phase_t); \
      phase_t = now;                                       \
    }                                                      \
  } while (0)
#else
#define FW_PHASE(i) \
  do {              \
  } while (0)
#endif

template <int N>
__device__ __forceinline__ void fw_producer(const FwArgs& a, const CUtensorMap* wmap,
                                            unsigned char* sm, const FwLayout& L) {
  constexpr int NCH = N / 64;
  const int lane = threadIdx.x & 31;
  const int si = a.si, so = a.so, n_mats = a.n_mats;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* full = bars;
  uint64_t* empty = bars + kFwStages;
  uint64_t* wfull = bars + 2 * kFwStages;
  uint64_t* wempty = wfull + 1;
  float* B0f = reinterpret_cast<float*>(sm + L.params);
  float* BHf = B0f + N;
  float* WLf = BHf + n_mats * N;
  float* BLf = WLf + 4 * N;
  const long long o_wl = (long long)si * N + (long long)n_mats * N * N;
  const long long o_b0 = o_wl + (long long)N * so;
  const long long o_bh = o_b0 + N;
  const long long o_bl = o_bh + (long long)n_mats * N;
  const bf16 zero = __float2bfloat16_rn(0.f);
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
    // W0' [16, N] and W_last^T [8, N] as swizzled bf16 operands
    for (int i = lane; i < 16 * N; i += 32) {
      const int r = i / N, c = i - r * N;
      *reinterpret_cast<bf16*>(sm + L.w0 + (c >> 6) * 2048 + sw_off(r, c & 63)) =
          r < si ? wg[r * N + c] : zero;
      if (r < 8)
        *reinterpret_cast<bf16*>(sm + L.wl + (c >> 6) * 1024 + sw_off(r, c & 63)) =
            r < so ? wg[o_wl + c * so + r] : zero;
    }
    for (int i = lane; i < 4 * N; i += 32) {
      const int c = i >> 2, k = i & 3;
      WLf[i] = k < so ? __bfloat162float(wg[o_wl + c * so + k]) : 0.f;
    }
    for (int i = lane; i < N; i += 32) B0f[i] = __bfloat162float(wg[o_b0 + i]);
    for (int i = lane; i < n_mats * N; i += 32) BHf[i] = __bfloat162float(wg[o_bh + i]);
    if (lane < 4) BLf[lane] = lane < so ? __bfloat162float(wg[o_bl + lane]) : 0.f;
    fence_proxy_async();  // the operands' generic stores, before the products read them
    mbar_arrive(wfull);
    for (int kt = 0; kt < t_end - t_begin; ++kt) {
      const int u = base + kt, stage = u % kFwStages;
      mbar_wait(empty + stage, ((u / kFwStages) & 1) ^ 1);
      const int p0 = (t_begin + kt) * kFwTile;
      const int rows = min(kFwTile, a.P - p0);
      // a row's four bf16 (their bits; zero is 0) in two pairs
      const unsigned short* xg =
          reinterpret_cast<const unsigned short*>(a.x) + ((long long)gi * a.P + p0) * si;
      uint2* xs = reinterpret_cast<uint2*>(sm + L.xs) + stage * kFwTile;
      for (int r = lane; r < kFwTile; r += 32) {
        uint32_t lo = 0, hi = 0;
        if (r < rows) {
          const unsigned short* xr = xg + r * si;
          lo = xr[0] | (si > 1 ? (uint32_t)xr[1] << 16 : 0u);
          hi = (si > 2 ? (uint32_t)xr[2] : 0u) | (si > 3 ? (uint32_t)xr[3] << 16 : 0u);
        }
        xs[r] = make_uint2(lo, hi);
      }
      mbar_arrive(full + stage);
    }
    base += t_end - t_begin;
  }
}

// The epilogue of a product's accumulator: + b (f32), the sine (K5: and its
// slope, packed into the thread's act' slot), for a resblock the block's
// input U (f32: the first layer sets it, a block's second app averages with
// it and sets it), then the values packed pairwise into the A operand of
// the next product.
template <int N, bool RES, bool JAC, bool DEG9>
__device__ __forceinline__ void epilogue(float (&acc)[N / 2], float (&U)[RES ? N / 2 : 1],
                                         uint32_t (&A)[N / 4], const float* bias, bool first,
                                         bool average, uint4* act, int q, const SinePoly& sp) {
  constexpr int NB = N / 8;
  uint32_t dp[4];  // K5: four pairs of act', one 16-byte store
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * i + 2 * q);
    float d[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float z = acc[4 * i + e] + ((e & 1) ? b.y : b.x);
      float v;
      if constexpr (JAC)
        v = sine_and_slope<DEG9>(z, sp, &d[e]);
      else
        v = sine_at<DEG9>(z, sp);
      if constexpr (RES) {
        if (average) v = 0.5f * (U[4 * i + e] + v);
        if (first || average) U[4 * i + e] = v;
      }
      acc[4 * i + e] = v;
    }
    if constexpr (JAC) {
      dp[2 * (i & 1)] = pack2(d[0], d[1]);
      dp[2 * (i & 1) + 1] = pack2(d[2], d[3]);
      if (i & 1) act[(i >> 1) * 128] = make_uint4(dp[0], dp[1], dp[2], dp[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < N / 4; ++j) A[j] = pack2(acc[2 * j], acc[2 * j + 1]);
}

// DEG9: the degree-9 sine (else 7), a compile-time choice, so its
// coefficients are the products' immediates and take no registers.
template <int N, bool RES, bool JAC, bool DEG9>
__device__ __forceinline__ void fw_consumer(const FwArgs& a, unsigned char* sm, const FwLayout& L,
                                            int c) {
  constexpr int NA = N / 2;   // accumulator floats a thread
  constexpr int NU = N / 4;   // its bf16 pairs: the A operand
  constexpr int KS = N / 16;  // K steps over the width
  const int t = threadIdx.x - 128 * (c + 1);
  const int w = t >> 5, lane = t & 31, q = lane & 3;
  const int r0 = 16 * w + (lane >> 2);  // the thread's rows r0 and r0 + 8 of its half
  const int si = a.si, so = a.so, n_mats = a.n_mats;
  const SinePoly sp = sine_poly(DEG9);
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(sm));
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* full = bars;
  uint64_t* empty = bars + kFwStages;
  uint64_t* wfull = bars + 2 * kFwStages;
  uint64_t* wempty = wfull + 1;
  const float* B0f = reinterpret_cast<const float*>(sm + L.params);
  const float* BHf = B0f + N;
  const float* WLf = BHf + n_mats * N;
  const float* BLf = WLf + 4 * N;
  const uint32_t w0_u = sbase + L.w0, wl_u = sbase + L.wl;
  // K5: app a's act' (a = 0 the first layer, 1 + m hidden app m), the
  // thread's 16-byte block j at acts[(a * NU / 4 + j) * 128]
  uint4* acts = reinterpret_cast<uint4*>(sm + L.acts) + (size_t)c * (n_mats + 1) * (NU / 4) * 128 + t;
#ifdef FWG_PHASE_CLOCKS
  unsigned long long phase_sum[kFwPhases] = {};
  long long phase_t = clock64();
#endif

  int base = 0, run = 0;
  for (int gi = blockIdx.y; gi < a.G; gi += gridDim.y, ++run) {
    int t_begin, t_end;
    split_tiles(a.n_tiles, gridDim.x, blockIdx.x, &t_begin, &t_end);
    const int nbt = t_end - t_begin;
    mbar_wait(wfull, run & 1);
    for (int kt = 0; kt < nbt; ++kt) {
      const int u = base + kt, stage = u % kFwStages;
      const int p0 = (t_begin + kt) * kFwTile + 64 * c;  // the first point of this half
      const int rows = max(0, min(64, a.P - p0));
      const long long row0 = (long long)gi * a.P + p0;
      const uint32_t* xs = reinterpret_cast<const uint32_t*>(sm + L.xs) +
                           (stage * kFwTile + 64 * c) * 2;  // two bf16 pairs a row
      mbar_wait(full + stage, (u / kFwStages) & 1);
      FW_PHASE(0);  // waiting for the tile's x
      // the first layer's A: x columns 2q, 2q + 1 of rows r0 and r0 + 8
      // (columns 4 .. 15 zero)
      const uint32_t X[4] = {q < 2 ? xs[r0 * 2 + q] : 0u, q < 2 ? xs[(r0 + 8) * 2 + q] : 0u, 0u,
                             0u};
      mbar_arrive(empty + stage);  // the x pairs are in registers

      // ---- first layer: z0 = x W0' on the tensor cores, S_0 = f(z0 + b0)
      // (RES: U = S_0 in f32; K5: act'(z0) into its slot), packed
      float acc[NA], U[RES ? NA : 1];
      uint32_t A[NU];
      wgmma_fence();
      mma_rs<N, 1>(acc, X, chunk_mn(w0_u, 2048, 0), 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      epilogue<N, RES, JAC, DEG9>(acc, U, A, B0f, true, false, acts, q, sp);
      FW_PHASE(1);

      // ---- hidden apps: Z = S_m W_m, A from registers; S_{m+1} = f(Z +
      // b_m) (a resblock's second app averages with the block's input in
      // f32), packed in place as the next A (K5: and act'(Z + b_m))
      for (int m = 0; m < n_mats; ++m) {
        const uint32_t w_u = sbase + L.ws + m * 2 * N * N;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) mma_rs<N, 1>(acc, A + 4 * kk, w_mn<N>(w_u, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
        FW_PHASE(2);
        epilogue<N, RES, JAC, DEG9>(acc, U, A, BHf + m * N, false, RES && (m & 1),
                                    acts + (m + 1) * (NU / 4) * 128, q, sp);
        FW_PHASE(3);
      }

      // ---- last product: out = S_last W_last (m64n8k16 over W_last^T,
      // summed in f32), + b_last, rounded once at the store; lane q holds
      // columns 2q, 2q + 1 of rows r0 and r0 + 8
      {
        float o[4];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) wgmma_m64n8k16_rs<0>(o, A + 4 * kk, chunk_k(wl_u, 1024, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(o);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = r0 + 8 * h, j = 2 * q + e;
            if (row < rows && j < so)
              a.y[(row0 + row) * so + j] = __float2bfloat16_rn(o[2 * h + e] + BLf[j]);
          }
      }
      FW_PHASE(4);

      if constexpr (JAC) {
        // ---- one cotangent sweep per output column j
        for (int j = 0; j < so; ++j) {
          float du[NA], C[RES ? NA : 1];  // du; a resblock's half block cotangent
#pragma unroll
          for (int i = 0; i < NA; ++i) du[i] = WLf[(8 * (i >> 2) + 2 * q + (i & 1)) * 4 + j];
          for (int m = n_mats - 1; m >= 0; --m) {
            const uint32_t w_u = sbase + L.ws + m * 2 * N * N;
            const bool second = RES && (m & 1);
            const float scale = second ? 0.5f : 1.f;
            if constexpr (RES) {
              if (second) {
#pragma unroll
                for (int i = 0; i < NA; ++i) C[i] = 0.5f * du[i];
              }
            }
            // dz = lift((scale du) act'), act' as the forward rounded it
            const uint4* am = acts + (m + 1) * (NU / 4) * 128;
#pragma unroll
            for (int jb = 0; jb < NU / 4; ++jb) {
              const uint4 d4 = am[jb * 128];
              const uint32_t dd[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const int jj = 4 * jb + r;
                A[jj] = pack2(scale * du[2 * jj] * lo_of(dd[r]), scale * du[2 * jj + 1] * hi_of(dd[r]));
              }
            }
            const bool block_first = RES && !(m & 1);  // du starts from the carry
            if constexpr (RES) {
              if (block_first) {
#pragma unroll
                for (int i = 0; i < NA; ++i) du[i] = C[i];
              }
            }
            FW_PHASE(5);
            // du = dz W_m^T: the cotangent of the app's input
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < KS; ++kk)
              mma_rs<N, 0>(du, A + 4 * kk, w_k<N>(w_u, kk), kk > 0 || block_first);
            wgmma_commit();
            wgmma_wait<0>();
            fence_acc(du);
            FW_PHASE(6);
          }
          // ---- first layer: dz0 = lift(du lift(f'(z0))) packed, then
          // jac[:, j, :] = dz0 W0'^T (m64n16k16 over W0' read K-major,
          // summed in f32); lane q holds columns 2q, 2q + 1
#pragma unroll
          for (int jb = 0; jb < NU / 4; ++jb) {
            const uint4 d4 = acts[jb * 128];
            const uint32_t dd[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int jj = 4 * jb + r;
              A[jj] = pack2(du[2 * jj] * lo_of(dd[r]), du[2 * jj + 1] * hi_of(dd[r]));
            }
          }
          float jd[8];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
            wgmma_m64n16k16_rs<0>(jd, A + 4 * kk, chunk_k(w0_u, 2048, kk), kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(jd);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int row = r0 + 8 * h, k = 2 * q + e;
              if (row < rows && k < si)
                a.jac[((row0 + row) * so + j) * si + k] = __float2bfloat16_rn(jd[2 * h + e]);
            }
          FW_PHASE(7);
        }
      }
    }
    mbar_arrive(wempty);  // every read of the group's W and parameters is done
    base += nbt;
  }
#ifdef FWG_PHASE_CLOCKS
  if (t == 0)
    for (int i = 0; i < kFwPhases; ++i) atomicAdd(&fwg_phase_cycles[i], phase_sum[i]);
#endif
}

// The body of both kernels: the block's roles, after the mbarriers are set.
template <int N, bool RES, bool JAC, bool DEG9>
__device__ __forceinline__ void fw_body(const CUtensorMap* wmap, const FwArgs& a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const FwLayout L = fw_layout(N, a.n_mats, JAC);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L.bars);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kFwStages; ++i) {
      mbar_init(bars + i, 32);              // full: the producer's lanes
      mbar_init(bars + kFwStages + i, 256);  // empty: both consumers' threads
    }
    mbar_init(bars + 2 * kFwStages, 33);       // W and parameters: the lanes and the TMA bytes
    mbar_init(bars + 2 * kFwStages + 1, 256);  // both consumers are done with them
    mbar_init_fence();
  }
  __syncthreads();
  const int role = threadIdx.x / 128;
  if (role == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x < 32) fw_producer<N>(a, wmap, sm, L);
  } else {
    setmaxnreg_inc<232>();
    fw_consumer<N, RES, JAC, DEG9>(a, sm, L, role - 1);
  }
}

template <int N, bool RES, bool DEG9>
__global__ void __launch_bounds__(kFwThreads, 1)
    fwd_wg_kernel(const __grid_constant__ CUtensorMap wmap, const FwArgs a) {
  fw_body<N, RES, false, DEG9>(&wmap, a);
}

template <int N, bool RES, bool DEG9>
__global__ void __launch_bounds__(kFwThreads, 1)
    fwd_jac_wg_kernel(const __grid_constant__ CUtensorMap wmap, const FwArgs a) {
  fw_body<N, RES, true, DEG9>(&wmap, a);
}

struct FwGeometry {
  int splits, grid_g;
  size_t smem;
};

// Status of a shape: 0 = ok, 2 = its shared-memory layout exceeds a
// block's, 3 = a chain, width, si or so the body does not take (see the
// header; K5 with so >= si among them).
int fw_geometry(bool jac, int n, int si, int so, int n_mats, int chain, int G, int P,
                FwGeometry* g) {
  if ((n != 64 && n != 128) || si < 1 || si > 4 || so < 1 || so > 4 || n_mats < 1 || G < 1 ||
      P < 1 || (chain != kSirenPlain && chain != kSirenResblock) ||
      (chain == kSirenResblock && n_mats % 2) || (jac && so >= si))
    return 3;
  g->smem = fw_layout(n, n_mats, jac).total + 1024;  // + the base's alignment
  const int n_tiles = (P + kFwTile - 1) / kFwTile;
  int sms = sm_count();
  sms = sms > 0 ? sms : 1;
  const int S = G < sms ? sms / G : 1;
  g->splits = S < n_tiles ? S : n_tiles;  // a tile a block at least
  const int per = sms / g->splits > 1 ? sms / g->splits : 1;
  g->grid_g = G < per ? G : per;
  return g->smem > kMaxSmem ? 2 : 0;
}

// The workspace entries' report, in the layout of the mma.sync body's
// (shapenet_fwd_tc.cu): points per tile, P splits per group, dynamic shared
// memory per block, 1 and 1 (the activations never leave the block, every
// W_m is staged), 0 partials and 0 bytes of scratch (a resblock's carry
// stays in registers).
int workspace(bool jac, int n, int si, int so, int n_mats, int chain, int G, int P, int* tile,
              int* splits, long long* smem_bytes, int* resident, int* staged_w,
              long long* partial_floats, long long* scratch_bytes) {
  FwGeometry g{};
  const int status = fw_geometry(jac, n, si, so, n_mats, chain, G, P, &g);
  if (status == 3) return status;
  *tile = kFwTile;
  *splits = g.splits;
  *smem_bytes = (long long)g.smem;
  *resident = 1;
  *staged_w = 1;
  *partial_floats = 0;
  *scratch_bytes = 0;
  return status;
}

template <int N, bool RES, bool JAC, bool DEG9>
int launch_fw(const FwGeometry& geo, const CUtensorMap& map, const FwArgs& a, cudaStream_t s) {
  auto kernel = JAC ? fwd_jac_wg_kernel<N, RES, DEG9> : fwd_wg_kernel<N, RES, DEG9>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(geo.splits, geo.grid_g), kFwThreads, geo.smem, s>>>(map, a);
  return (int)cudaGetLastError();
}

// The instance of a width, chain and sine degree.
template <bool JAC, int N>
int launch_chain(bool res, bool deg9, const FwGeometry& geo, const CUtensorMap& map,
                 const FwArgs& a, cudaStream_t s) {
  if (res)
    return deg9 ? launch_fw<N, true, JAC, true>(geo, map, a, s)
                : launch_fw<N, true, JAC, false>(geo, map, a, s);
  return deg9 ? launch_fw<N, false, JAC, true>(geo, map, a, s)
              : launch_fw<N, false, JAC, false>(geo, map, a, s);
}

// Both kernels' C entries: the geometry and W's tensor map, then the
// launch; cudaErrorInvalidValue for a shape or an activation the body does
// not take.
template <bool JAC>
int launch_entry(const void* wb, const void* x, void* y, void* jac, int G, int P, int si, int so,
                 int n, int n_mats, int chain, int act, long long po, long long wb_ld,
                 void* stream) {
  FwGeometry geo{};
  if ((act != kSinePoly7 && act != kSinePoly9) || wb_ld < po || wb_ld % 8 ||
      fw_geometry(JAC, n, si, so, n_mats, chain, G, P, &geo) != 0)
    return (int)cudaErrorInvalidValue;
  FwArgs a{};
  a.wb = static_cast<const bf16*>(wb);
  a.x = static_cast<const bf16*>(x);
  a.y = static_cast<bf16*>(y);
  a.jac = static_cast<bf16*>(jac);
  CUtensorMap map;
  const int map_err = encode_w_map(&map, a.wb, n, si, n_mats, G, wb_ld);
  if (map_err != 0) return map_err;
  a.G = G; a.P = P; a.si = si; a.so = so; a.n_mats = n_mats;
  a.n_tiles = (P + kFwTile - 1) / kFwTile;
  a.wb_ld = wb_ld;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool res = chain == kSirenResblock, deg9 = act == kSinePoly9;
  return n == 64 ? launch_chain<JAC, 64>(res, deg9, geo, map, a, s)
                 : launch_chain<JAC, 128>(res, deg9, geo, map, a, s);
}

}  // namespace

extern "C" {

// The geometry of the wgmma K1 at [G, P] (a status as fw_geometry() returns;
// on 0 and 2 the outputs are written; see workspace()), in the layout of
// nif_shapenet_fwd_tc_workspace.
int nif_shapenet_fwd_wg_workspace(int n, int si, int so, int n_mats, int chain, int G, int P,
                                  int* tile, int* splits, long long* smem_bytes, int* resident,
                                  int* staged_w, long long* partial_floats,
                                  long long* scratch_bytes) {
  return workspace(false, n, si, so, n_mats, chain, G, P, tile, splits, smem_bytes, resident,
                   staged_w, partial_floats, scratch_bytes);
}

// The same for the wgmma K5 reverse body (status 3 where so >= si).
int nif_shapenet_fwd_jac_wg_workspace(int n, int si, int so, int n_mats, int chain, int G,
                                      int P, int* tile, int* splits, long long* smem_bytes,
                                      int* resident, int* staged_w, long long* partial_floats,
                                      long long* scratch_bytes) {
  return workspace(true, n, si, so, n_mats, chain, G, P, tile, splits, smem_bytes, resident,
                   staged_w, partial_floats, scratch_bytes);
}

// K1 in bf16 on wgmma: the arguments of nif_shapenet_fwd_tc (wb' rows of
// wb_ld >= po elements, a multiple of 8; the scratch is not read). Returns
// the CUDA error of the launch (0 on success); the kernel runs
// asynchronously on `stream`.
int nif_shapenet_fwd_wg(const void* wb, const void* x, void* out, void* scratch, int G, int P,
                        int si, int so, int n, int n_mats, int chain, int act, long long po,
                        long long wb_ld, void* stream) {
  (void)scratch;
  return launch_entry<false>(wb, x, out, nullptr, G, P, si, so, n, n_mats, chain, act, po, wb_ld,
                             stream);
}

// K5's reverse body in bf16 on wgmma: the arguments of
// nif_shapenet_fwd_jac_tc. Returns the CUDA error of the launch.
int nif_shapenet_fwd_jac_wg(const void* wb, const void* x, void* y, void* jac, void* scratch,
                            int G, int P, int si, int so, int n, int n_mats, int chain, int act,
                            long long po, long long wb_ld, void* stream) {
  (void)scratch;
  return launch_entry<true>(wb, x, y, jac, G, P, si, so, n, n_mats, chain, act, po, wb_ld,
                            stream);
}

#ifdef FWG_PHASE_CLOCKS
// The phase counters summed over every consumer warpgroup since the last
// call, then zeroed (the probe build only).
int nif_fwg_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, fwg_phase_cycles, sizeof(fwg_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[kFwPhases] = {};
  return (int)cudaMemcpyToSymbol(fwg_phase_cycles, zero, sizeof(zero));
}
#endif

const char* nif_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
