// K1's bf16 path and K5's reverse body on Hopper's tensor cores: the forward
// of the grouped ShapeNet chain (the serving kernel) and the fused Jacobian
// by reverse cotangent sweeps, with every hidden product a warp-level
// mma.sync.m16n8k16 (bf16 in, f32 accumulation). Both are forward-only: no
// weight grads, no partials, no reduce.
//
// K1 (fwd_tc_kernel) replaces nif_tpu/ops/pallas_shapenet.py::_fwd_kernel
// (reached through shapenet_grouped_fused -> _fwd_pallas) for bfloat16
// inputs on sine chains (plain or resblock SIREN, si <= 4): wb' [G, po]
// (omega_0 folded into the sine-fed weights by the wrapper), x [G, P, si]
// -> out [G, P, so] in bf16. Its rounding points are the plain K1's
// (ops/fused_shapenet.py::shapenet_grouped_fused_reference): each layer's
// input is stored in bf16 (the planes), z + b and every sum are f32, a
// resblock's running state and average stay f32 (a per-thread carry), and
// the last product is summed in f32 and rounded once, at its store. A
// hidden product's k16 blocks are each taken on a zero accumulator and
// summed by f32 adds, which round to nearest (stack_mma's RN_BLOCKS), as
// the plain K1's and the reference's sums do: the tensor core's own add
// into a running accumulator truncates, and on the deep plain chain (seven
// hidden matrices at omega_0 = 30) that bias doubled the bf16 output's
// distance from plain K1 against the reference's own distance
// (tests/test_torch_k1_deep_chain.py models both adds).
//
// K5's reverse body (fwd_jac_rev_tc_kernel) replaces _fwd_jac_rev_kernel
// (reached through shapenet_fwd_jac; the chain is _jac_rev_layers) for
// bfloat16 sine chains with so < si: -> y [G, P, so], jac [G, P, so, si] in
// bf16. The forward is K1's and keeps every hidden layer's act' rounded to
// bf16 (the reference's dacts) in a plane of its own; then one sweep per
// output column j: du starts as the f32 column W_last[:, j]; for each hidden
// app, last to first, dz = lift(scale du act') (scale 0.5 on a resblock's
// second app) and du = dz @ W_m^T summed in f32 (a resblock's first app adds
// half the block's cotangent, kept in the carry); last, dz0 = lift(du
// lift(act'(z0))), with act'(z0) recomputed from the x tile (si FMAs and one
// sine slope), and jac[:, j, :] = dz0 @ W0'^T, summed in f32. The du chain
// is the tensor-core K2's (shapenet_bwd_tc.cu) without dW, bias grads,
// scale or loss.
//
// float32, K5's tangent body (so >= si), vanilla chains, si > 4 and widths
// whose planes exceed shared memory stay on shapenet_fwd.cu and
// shapenet_jac.cu (the wrappers route by k1_variant and k5_variant), whose
// f32 products must not round to TF32. Every operand of a product here is
// a bf16 value already, so each product is exact and only the order of the
// f32 sums differs from those kernels.
//
// What bounds them on an H100 SXM: operations. At the flagship shape (G=32,
// P=32768, width 128, two hidden layers, si=3, so=1) K1's products are 69.8
// GFLOP (~0.071 ms at the 989 TFLOP/s bf16 tensor-core peak) and its ~403 M
// sine evaluations ~0.084 ms on the f32 cores; K5's reverse body adds the
// sweep's products, 139.3 GFLOP in all (~0.14 ms).
//
// Design: the forward half of the tensor-core K2, on stack_tc.cuh.
// - A tile is 64 points of the value stream for K1: four 16-row mma slabs
//   at 128 registers a thread, so two blocks share an SM wherever a block's
//   shared memory fits half of it, the flagship's 109 KB among them (0.57
//   ms on an H100 against 0.61-0.63 for 128-point tiles at one block per
//   SM; scripts/port_phase_probe.py --one-block times both). K5's tile is
//   128 points, eight slabs, one block per SM: its act' planes fill the SM.
//   Warp w owns the 16-column blocks w, w + 8, ... of every product over
//   all slabs, so the sine epilogues (and K5's dz) run in registers. The
//   first layer (si <= 4 columns) is f32 FMAs from the group's W0' and b0
//   in shared memory; the hidden products ping-pong between two working
//   bf16 planes;
//   the last product (so columns; jac's dx product: si columns) runs on the
//   tensor cores a slab a warp (last_product_mma), over W_last or W0'^T in
//   f32 in shared memory, whose values are bf16 ones.
// - Every hidden W_m is staged once a group with cp.async where all of them
//   fit beside the planes (the flagship), else one at a time, else W is read
//   from global memory. The last product's f32 output is budgeted in the
//   same shared memory, so NIF-linear's trunk (so = 128 bottleneck columns)
//   fits at width 128 too.
// - K5 keeps n_mats act' planes besides the two working planes, which its
//   sweeps reuse for dz; at the flagship that is four planes of 128 x 136
//   bf16 (139 KB) and both W (70 KB), 216 KB with the rest; act'(z0) is
//   recomputed rather than kept (a fifth plane would not fit).
// - Ragged P: the x tile is zero-padded and rows past P are not stored; the
//   shared products stay unguarded.
// - Nothing is summed across blocks, so two runs give the same bits.
// The grid is (S, G) with S = (blocks per SM) SMs / G splits of the group's
// tiles: one wave.
#include "stack_tc.cuh"

namespace {

constexpr int kFwdTp = 64;          // points of a K1 tile
constexpr int kFwdBlocksPerSm = 2;  // blocks per SM its registers allow
constexpr int kJacTp = 128;         // points of a K5 tile
constexpr int kMaxSiTc = 4;

struct FwdArgs {
  const bf16* wb;          // wb' [G, wb_ld] (rows of po, padded to 16 bytes)
  const bf16* x;           // [G, P, si]
  bf16* y;                 // [G, P, so]
  bf16* jac;               // K5: [G, P, so, si]
  unsigned char* scratch;  // per block: the f32 carry
  int G, P, so, n, n_mats, n16, ld, n_cb, stage_w, stage_all;
  bool deg9;
  long long wb_ld, block_bytes;
};

// The first layer's f32 weights W0'[k][c] and bias b0[c] of the thread's
// four columns of block cb (column (t, e) at 2t + e; zero from n on): a
// copy of the tensor-core K2's (shapenet_bwd_tc.cu), kept here so that a
// change to it rebuilds no other tensor-core kernel.
template <int SI>
__device__ __forceinline__ void first_layer_columns(const float* W0f, const float* B0f, int n,
                                                    int cb, const Lane& l, float (&w0)[4][SI],
                                                    float (&b0)[4]) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = frag_col(cb, t, e, l);
#pragma unroll
      for (int k = 0; k < SI; ++k) w0[2 * t + e][k] = c < n ? W0f[k * n + c] : 0.f;
      b0[2 * t + e] = c < n ? B0f[c] : 0.f;
    }
}

// Row r of the x tile [tp, si] in f32.
template <int SI>
__device__ __forceinline__ void x_row(const bf16* X, int r, float (&xr)[SI]) {
#pragma unroll
  for (int k = 0; k < SI; ++k) xr[k] = __bfloat162float(X[r * SI + k]);
}

// The bf16 sine of z and its slope from one range reduction: the bits of
// sine_of and sine_slope.
__device__ __forceinline__ float sine_and_slope(float z, const SinePoly& k, float* d1) {
  const float t = sin_turns(z);
  const float s = t * t;
  *d1 = sine_dt(s, k) * kInv2Pi;
  return sine_value(t, s, k);
}

// Built with -DK1_PHASE_CLOCKS or -DK5_PHASE_CLOCKS (by
// scripts/port_phase_probe.py only), thread 0 of every block of that kernel
// adds the clock64() cycles from one barrier to the next into eight phase
// counters, which split the block's critical path.
constexpr int kPhases = 8;
#ifdef K1_PHASE_CLOCKS
constexpr bool kK1Clocks = true;
__device__ unsigned long long k1_phase_cycles[kPhases];
#else
constexpr bool kK1Clocks = false;
#endif
#ifdef K5_PHASE_CLOCKS
constexpr bool kK5Clocks = true;
__device__ unsigned long long k5_phase_cycles[kPhases];
#else
constexpr bool kK5Clocks = false;
#endif
#define FWD_PHASE(i)                                         \
  do {                                                       \
    if (kClocks && threadIdx.x == 0) {                       \
      const long long now = clock64();                       \
      phase_sum[i] += (unsigned long long)(now - phase_t);   \
      phase_t = now;                                         \
    }                                                        \
  } while (0)

// One block's work: K1 (JAC false) or K5's reverse body (JAC true) over its
// run of TP-point tiles of each of its groups.
template <int SI, bool RES, bool JAC, int TP>
__device__ __forceinline__ void fwd_body(const FwdArgs& a) {
  constexpr int NSL = TP / 16;  // slab h holds points 16h .. 16h+15
  constexpr int TR = TP;        // stacked rows: the one stream
  constexpr bool kClocks = JAC ? kK5Clocks : kK1Clocks;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, so = a.so, n_mats = a.n_mats, ld = a.ld, n16 = a.n16, n_cb = a.n_cb;
  const SinePoly sp = sine_poly(a.deg9);
  const size_t plane = (size_t)TR * ld;
  const size_t wsz = (size_t)n16 * 16 * ld;  // one staged matrix
  bf16* planes = reinterpret_cast<bf16*>(smem_raw);  // two working planes
  bf16* DS = planes + 2 * plane;  // K5: [n_mats][TR, ld] each hidden app's act', bf16
  bf16* WS = DS + (JAC ? (size_t)n_mats * plane : 0);  // the staged W_m, or every W_m
  // [TR, so] the last product (K5: [TR, si], then the dx product)
  float* O = reinterpret_cast<float*>(WS + (a.stage_w ? (a.stage_all ? n_mats : 1) * wsz : 0));
  float* W0f = O + TR * (JAC ? SI : so);  // [si, n] the group's first layer, f32
  float* B0f = W0f + SI * n;              // [n]
  float* BHf = B0f + n;                   // [n_mats, n] hidden biases
  float* WLf = BHf + n_mats * n;          // [n, so] last layer
  float* BLf = WLf + n * so;              // [so]
  float* W0T = BLf + so;                  // K5: [n, si] W0'^T, the dx product's operand
  bf16* X = reinterpret_cast<bf16*>(W0T + (JAC ? n * SI : 0));  // [TP, si]
  // the weight operand's source in stack_mma for app m
  auto ws = [&](int m) -> const bf16* {
    return a.stage_all ? WS + m * wsz : (a.stage_w ? WS : nullptr);
  };
  // the input plane of app m (m = n_mats: the last product's) in the forward
  auto fwd_plane = [&](int m) { return planes + (m & 1) * plane; };
  const Lane l = lane_of_thread();

  const int S = gridDim.x, s = blockIdx.x;
  const int n_tiles = (a.P + TP - 1) / TP;
  const int t_begin = (int)((long long)s * n_tiles / S);
  const int t_end = (int)((long long)(s + 1) * n_tiles / S);
  const long long o_wh = (long long)SI * n;
  const long long o_wl = o_wh + (long long)n_mats * n * n;
  const long long o_b0 = o_wl + (long long)n * so;
  const long long o_bh = o_b0 + n;
  const long long o_bl = o_bh + (long long)n_mats * n;
  float* carry = reinterpret_cast<float*>(
      a.scratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * a.block_bytes);
  unsigned long long phase_sum[kPhases] = {};
  long long phase_t = kClocks ? clock64() : 0;

  for (int gi = blockIdx.y; gi < a.G; gi += gridDim.y) {
    const bf16* wg = a.wb + (long long)gi * a.wb_ld;
    __syncthreads();  // the previous group is done with the staged parameters and W
    for (int i = threadIdx.x; i < SI * n; i += kThreads) W0f[i] = __bfloat162float(wg[i]);
    for (int i = threadIdx.x; i < n; i += kThreads) B0f[i] = __bfloat162float(wg[o_b0 + i]);
    for (int i = threadIdx.x; i < n_mats * n; i += kThreads) BHf[i] = __bfloat162float(wg[o_bh + i]);
    for (int i = threadIdx.x; i < n * so; i += kThreads) WLf[i] = __bfloat162float(wg[o_wl + i]);
    for (int i = threadIdx.x; i < so; i += kThreads) BLf[i] = __bfloat162float(wg[o_bl + i]);
    if (JAC)
      for (int i = threadIdx.x; i < n * SI; i += kThreads) {
        const int k = i / SI;
        W0T[i] = __bfloat162float(wg[(i - k * SI) * n + k]);
      }
    if (a.stage_all) {  // every hidden matrix, once a group (shown by the first tile's barrier)
      for (int m = 0; m < n_mats; ++m)
        stage_matrix(WS + m * wsz, ld, wg + o_wh + (long long)m * n * n, n, n, n16 * 16, n16 * 16);
      cp_async_wait_all();
    }
    int staged = -1;  // the hidden matrix in WS (one staged at a time)
    for (int tile = t_begin; tile < t_end; ++tile) {
      const int p0 = tile * TP;
      const int rows = min(TP, a.P - p0);
      const long long row0 = (long long)gi * a.P + p0;
      __syncthreads();  // the previous tile is done with X, O and the planes
      FWD_PHASE(JAC ? 7 : 3);  // the previous tile's stores (and the group's set-up)
      const bf16* xg = a.x + row0 * SI;
      for (int idx = threadIdx.x; idx < TP * SI; idx += kThreads)
        X[idx] = idx < rows * SI ? xg[idx] : __float2bfloat16_rn(0.f);
      __syncthreads();

      // ---- first layer: z0 = x @ W0' + b0, S_0 = f(z0); a thread's four
      // columns' weights and each of its x rows loaded once
      for (int cbl = 0; cbl < n_cb; ++cbl) {
        const int cb = l.warp + kWarps * cbl;
        if (cb >= n16) break;
        float w0[4][SI], b0[4];  // column (t, e) of the thread at 2t + e
        first_layer_columns<SI>(W0f, B0f, n, cb, l, w0, b0);
        float v[NSL][2][4];
#pragma unroll
        for (int h = 0; h < NSL; ++h)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float xr[SI];
            x_row<SI>(X, 16 * h + l.g + 8 * hh, xr);
#pragma unroll
            for (int t = 0; t < 2; ++t)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float z = 0.f;
#pragma unroll
                for (int k = 0; k < SI; ++k) z = fmaf(xr[k], w0[2 * t + e][k], z);
                v[h][t][2 * hh + e] = sine_of(z + b0[2 * t + e], sp);
              }
          }
        store_stack<NSL>(fwd_plane(0), nullptr, ld, n, cb, l, v);
        if (RES) carry_store<NSL>(carry_slot<NSL>(carry, 0, cbl, n_cb), v);
      }
      __syncthreads();  // S_0 is complete
      FWD_PHASE(0);     // the x tile and the first layer

      // ---- hidden apps: Z = S_m @ W_m on the tensor cores, S_{m+1} = f(Z +
      // b_m) in registers (K5: and act'(Z + b_m) into its plane; a
      // resblock's h feeds its second matrix as it is, the second app
      // averages with the block's input in f32)
      for (int m = 0; m < n_mats; ++m) {
        const bool res_second = RES && m % 2 == 1;
        const bf16* Wm = wg + o_wh + (long long)m * n * n;
        const float* bm = BHf + m * n;
        bf16* dm = DS + m * plane;
        if (a.stage_w && !a.stage_all && staged != m) {  // every read of the previous W is done
          stage_matrix(WS, ld, Wm, n, n, n16 * 16, n16 * 16);
          staged = m;
          cp_async_wait_all();
          __syncthreads();
        }
        for (int cbl = 0; cbl < n_cb; ++cbl) {
          const int cb = l.warp + kWarps * cbl;
          if (cb >= n16) break;
          float z[NSL][2][4];
          stack_mma<NSL, false, true>(fwd_plane(m), ld, 0, ws(m), Wm, n, n16, cb, l, z);
#pragma unroll
          for (int h = 0; h < NSL; ++h)
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              const int c0 = cb * 16 + 8 * t + 2 * l.q;
              const float b_0 = c0 < n ? bm[c0] : 0.f, b_1 = c0 + 1 < n ? bm[c0 + 1] : 0.f;
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                float* zz = &z[h][t][2 * hh];
                if (JAC) {
                  float d0, d1;
                  zz[0] = sine_and_slope(zz[0] + b_0, sp, &d0);
                  zz[1] = sine_and_slope(zz[1] + b_1, sp, &d1);
                  store_pair(dm + (h * 16 + l.g + 8 * hh) * ld + c0, c0 < n ? d0 : 0.f,
                             c0 + 1 < n ? d1 : 0.f);
                } else {
                  zz[0] = sine_of(zz[0] + b_0, sp);
                  zz[1] = sine_of(zz[1] + b_1, sp);
                }
              }
            }
          if (res_second) {
            float* cs = carry_slot<NSL>(carry, 0, cbl, n_cb);
#pragma unroll
            for (int h = 0; h < NSL; ++h)
#pragma unroll
              for (int t = 0; t < 2; ++t)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  float* u = cs + ((h * 2 + t) * 4 + i) * kThreads;
                  z[h][t][i] = 0.5f * (*u + z[h][t][i]);
                  *u = z[h][t][i];
                }
          }
          store_stack<NSL>(fwd_plane(m + 1), nullptr, ld, n, cb, l, z);
        }
        __syncthreads();  // S_{m+1} is complete; every read of S_m is done
      }
      FWD_PHASE(1);  // the hidden forward

      // ---- last product O = S_last @ W_last on the tensor cores, a slab a
      // warp; y = O + b_last, rounded once
      last_product_mma(fwd_plane(n_mats), ld, TR, n, n16, WLf, so, O, l);
      __syncthreads();  // O is complete
      bf16* yg = a.y + row0 * so;
      for (int idx = threadIdx.x; idx < rows * so; idx += kThreads)
        yg[idx] = __float2bfloat16_rn(O[idx] + BLf[idx % so]);
      FWD_PHASE(2);  // the last product (and K1's stores: the next tile's barrier waits for them)
      if (!JAC) continue;

      // ---- K5: one cotangent sweep per output column j (the barriers
      // below order every read of O above before the dx product's writes)
      bf16* zp = planes + plane;  // dz0, the dx product's operand
      for (int j = 0; j < so; ++j) {
        float ds[NSL][2][4];  // du (or a resblock's dh): the cotangent of the current app's output
        for (int cbl = 0; cbl < n_cb; ++cbl) {
          const int cb = l.warp + kWarps * cbl;
          if (cb >= n16) break;
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int c = frag_col(cb, t, i, l);
              const float w = c < n ? WLf[c * so + j] : 0.f;
#pragma unroll
              for (int h = 0; h < NSL; ++h) ds[h][t][i] = w;
            }
          if (n_cb > 1) carry_store<NSL>(carry_slot<NSL>(carry, 1, cbl, n_cb), ds);
        }
        for (int m = n_mats - 1; m >= 0; --m) {
          const bool res_second = RES && m % 2 == 1;
          const float scale = res_second ? 0.5f : 1.f;
          const bf16* Wm = wg + o_wh + (long long)m * n * n;
          const bf16* dm = DS + m * plane;
          bf16* dp = planes + (m & 1) * plane;  // D, this app's dz
          if (a.stage_w && !a.stage_all && staged != m) {  // every read of the previous W is done
            stage_matrix(WS, ld, Wm, n, n, n16 * 16, n16 * 16);
            staged = m;
            cp_async_wait_all();
            __syncthreads();
          }
          // dz = lift((scale du) act'), act' as the forward rounded it
          for (int cbl = 0; cbl < n_cb; ++cbl) {
            const int cb = l.warp + kWarps * cbl;
            if (cb >= n16) break;
            if (n_cb > 1) carry_load<NSL>(carry_slot<NSL>(carry, 1, cbl, n_cb), ds);
            if (res_second) carry_store<NSL>(carry_slot<NSL>(carry, 0, cbl, n_cb), ds);
#pragma unroll
            for (int h = 0; h < NSL; ++h)
#pragma unroll
              for (int t = 0; t < 2; ++t)
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                  const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                      dm + (h * 16 + l.g + 8 * hh) * ld + cb * 16 + 8 * t + 2 * l.q));
                  float* dd = &ds[h][t][2 * hh];
                  dd[0] = lift<bf16>(scale * dd[0] * d.x);
                  dd[1] = lift<bf16>(scale * dd[1] * d.y);
                }
            store_stack<NSL>(dp, nullptr, ld, n, cb, l, ds);
          }
          __syncthreads();  // D is complete
          FWD_PHASE(3);     // the sweep's epilogues
          // du = D @ W_m^T: the cotangent of the app's input (a resblock's
          // second app: of its h; its first app adds the skip path's half of
          // the block's cotangent)
          for (int cbl = 0; cbl < n_cb; ++cbl) {
            const int cb = l.warp + kWarps * cbl;
            if (cb >= n16) break;
            stack_mma<NSL, true>(dp, ld, 0, ws(m), Wm, n, n16, cb, l, ds);
            if (RES && m % 2 == 0) {
              const float* cs = carry_slot<NSL>(carry, 0, cbl, n_cb);
#pragma unroll
              for (int h = 0; h < NSL; ++h)
#pragma unroll
                for (int t = 0; t < 2; ++t)
#pragma unroll
                  for (int i = 0; i < 4; ++i)
                    ds[h][t][i] = ds[h][t][i] + 0.5f * cs[((h * 2 + t) * 4 + i) * kThreads];
            }
            if (n_cb > 1) carry_store<NSL>(carry_slot<NSL>(carry, 1, cbl, n_cb), ds);
          }
          __syncthreads();  // every read of D is done
          FWD_PHASE(4);     // the sweep's products
        }

        // ---- first layer: dz0 = lift(du lift(f'(z0))), z0 recomputed from
        // the x tile as the forward summed it
        for (int cbl = 0; cbl < n_cb; ++cbl) {
          const int cb = l.warp + kWarps * cbl;
          if (cb >= n16) break;
          if (n_cb > 1) carry_load<NSL>(carry_slot<NSL>(carry, 1, cbl, n_cb), ds);
          float w0[4][SI], b0[4];
          first_layer_columns<SI>(W0f, B0f, n, cb, l, w0, b0);
#pragma unroll
          for (int h = 0; h < NSL; ++h)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float xr[SI];
              x_row<SI>(X, 16 * h + l.g + 8 * hh, xr);
#pragma unroll
              for (int t = 0; t < 2; ++t)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  float z = 0.f;
#pragma unroll
                  for (int k = 0; k < SI; ++k) z = fmaf(xr[k], w0[2 * t + e][k], z);
                  float& dd = ds[h][t][2 * hh + e];
                  dd = lift<bf16>(dd * lift<bf16>(sine_slope(z + b0[2 * t + e], sp)));
                }
            }
          store_stack<NSL>(zp, nullptr, ld, n, cb, l, ds);
        }
        __syncthreads();  // dz0 is complete
        FWD_PHASE(5);     // the first layer's backward
        // ---- jac[:, j, :] = dz0 @ W0'^T on the tensor cores, a slab a warp
        last_product_mma(zp, ld, TR, n, n16, W0T, SI, O, l);
        __syncthreads();  // O is complete; every read of dz0 is done
        bf16* jg = a.jac + row0 * so * SI;
        for (int idx = threadIdx.x; idx < rows * SI; idx += kThreads) {
          const int r = idx / SI;
          jg[(r * so + j) * SI + idx - r * SI] = __float2bfloat16_rn(O[idx]);
        }
        FWD_PHASE(6);  // the dx product and the jac stores (the next sweep's barriers wait)
      }
    }
  }
#if defined(K1_PHASE_CLOCKS) || defined(K5_PHASE_CLOCKS)
  if (kClocks && threadIdx.x == 0) {
    unsigned long long* counters = nullptr;
#ifdef K1_PHASE_CLOCKS
    if (!JAC) counters = k1_phase_cycles;
#endif
#ifdef K5_PHASE_CLOCKS
    if (JAC) counters = k5_phase_cycles;
#endif
    for (int i = 0; i < kPhases; ++i) atomicAdd(&counters[i], phase_sum[i]);
  }
#endif
}

template <int SI, bool RES>
__global__ void __launch_bounds__(kThreads, kFwdBlocksPerSm) fwd_tc_kernel(const FwdArgs a) {
  fwd_body<SI, RES, false, kFwdTp>(a);
}

template <int SI, bool RES>
__global__ void __launch_bounds__(kThreads, 1) fwd_jac_rev_tc_kernel(const FwdArgs a) {
  fwd_body<SI, RES, true, kJacTp>(a);
}

struct FwdGeometry {
  int tile, n16, ld, n_cb, splits, grid_g, stage_w, stage_all;
  size_t smem, block_bytes;
};

// The layout of K1 (jac false) or K5's reverse body (jac true) at [G, P]
// (status: 0 = it fits, 2 = its planes exceed a block's shared memory, 3 =
// a shape, chain or si it does not take, or K5 with so >= si). K1: two
// working planes of its tiles; K5: those and n_mats act' planes. Then
// every hidden W_m where they all fit beside them (staged once a group),
// else one at a time, else none (W from global memory); the last product's
// f32 output ([tile, so]; K5: [tile, si]), W0', the biases, W_last (K5: and
// W0'^T) in f32 and the x tile. K1 runs two blocks per SM where that fits
// half of the SM's shared memory (its registers allow two), else one. The
// carry: a resblock's f32 running state (K1 and K5) and, K5 only, every
// column block's cotangent where a warp owns several (widths above 128):
// per thread, in a per-block global scratch. The grid is (S, G) with S =
// the card's block slots / G splits of a group's tiles (at least 1, at
// most its tiles).
int fwd_geometry(bool jac, int n, int si, int so, int n_mats, int chain, int G, int P,
                 FwdGeometry* g) {
  if (n < 1 || si < 1 || si > kMaxSiTc || so < 1 || n_mats < 0 || G < 1 || P < 1 ||
      (chain != kSirenPlain && chain != kSirenResblock) ||
      (chain == kSirenResblock && n_mats % 2) || (jac && so >= si))
    return 3;
  const int tp = jac ? kJacTp : kFwdTp;
  g->tile = tp;
  g->n16 = round16(n) / 16;
  g->ld = round16(n) + 8;
  g->n_cb = (g->n16 + kWarps - 1) / kWarps;
  const size_t plane = 2 * (size_t)tp * g->ld;
  const size_t wsz = 2 * (size_t)g->n16 * 16 * g->ld;
  const size_t params = (size_t)(si + 1 + n_mats + so) * n + so + (jac ? (size_t)n * si : 0);
  const size_t base = (2 + (jac ? n_mats : 0)) * plane +
                      4 * ((size_t)tp * (jac ? si : so) + params) + 2 * (size_t)tp * si;
  g->stage_all = n_mats > 0 && base + (size_t)n_mats * wsz <= kMaxSmem;
  g->stage_w = g->stage_all || (n_mats > 0 && base + wsz <= kMaxSmem);
  g->smem = base + (g->stage_all ? n_mats : (g->stage_w ? 1 : 0)) * wsz;
  const bool res = chain == kSirenResblock;
  const int slots = jac ? (res || g->n_cb > 1 ? 2 : 0) : (res ? 1 : 0);
  const size_t carry = 4 * (size_t)slots * g->n_cb * (tp / 16) * 8 * kThreads;
  g->block_bytes = (carry + 15) / 16 * 16;
  const int n_tiles = (P + tp - 1) / tp;
  const int per_sm = !jac && kFwdBlocksPerSm == 2 && g->smem <= kHalfSmSmem ? 2 : 1;
  const int slots_on_card = sm_count() * per_sm;
  const int splits = slots_on_card > G ? slots_on_card / G : 1;
  g->splits = splits < n_tiles ? splits : n_tiles;
  g->grid_g = G < 65535 ? G : 65535;
  return g->smem > kMaxSmem ? 2 : 0;
}

template <int SI, bool RES, bool JAC>
int launch_fwd(const FwdGeometry& geo, const FwdArgs& a, cudaStream_t stream) {
  void (*kernel)(FwdArgs);
  if constexpr (JAC)
    kernel = fwd_jac_rev_tc_kernel<SI, RES>;
  else
    kernel = fwd_tc_kernel<SI, RES>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(geo.splits, geo.grid_g), kThreads, geo.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// K5's reverse body needs si >= 2 (so < si), so it has no si = 1 instance.
template <bool RES, bool JAC>
int launch_si(int si, const FwdGeometry& geo, const FwdArgs& a, cudaStream_t stream) {
  switch (si) {
    case 1:
      if constexpr (JAC) return (int)cudaErrorInvalidValue;
      else return launch_fwd<1, RES, JAC>(geo, a, stream);
    case 2: return launch_fwd<2, RES, JAC>(geo, a, stream);
    case 3: return launch_fwd<3, RES, JAC>(geo, a, stream);
    case 4: return launch_fwd<4, RES, JAC>(geo, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Both kernels' C entries: the arguments from the geometry, then the launch.
int launch_entry(bool jac, const void* wb, const void* x, void* y, void* jac_out, void* scratch, int G,
           int P, int si, int so, int n, int n_mats, int chain, int act, long long po,
           long long wb_ld, void* stream) {
  FwdGeometry geo{};
  if ((act != kSinePoly7 && act != kSinePoly9) || wb_ld < po ||
      fwd_geometry(jac, n, si, so, n_mats, chain, G, P, &geo) != 0)
    return (int)cudaErrorInvalidValue;
  FwdArgs a{};
  a.wb = static_cast<const bf16*>(wb);
  a.x = static_cast<const bf16*>(x);
  a.y = static_cast<bf16*>(y);
  a.jac = static_cast<bf16*>(jac_out);
  a.scratch = static_cast<unsigned char*>(scratch);
  a.G = G; a.P = P; a.so = so; a.n = n; a.n_mats = n_mats;
  a.n16 = geo.n16; a.ld = geo.ld; a.n_cb = geo.n_cb;
  a.stage_w = geo.stage_w;
  a.stage_all = geo.stage_all;
  a.deg9 = act == kSinePoly9;
  a.wb_ld = wb_ld;
  a.block_bytes = (long long)geo.block_bytes;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool res = chain == kSirenResblock;
  if (jac) return res ? launch_si<true, true>(si, geo, a, s) : launch_si<false, true>(si, geo, a, s);
  return res ? launch_si<true, false>(si, geo, a, s) : launch_si<false, false>(si, geo, a, s);
}

// The workspace entries' report, in the layout of the other tensor-core
// kernels' (shapenet_bwd_tc.cu's nif_shapenet_mse_tc_workspace): points per
// tile, P splits per group, dynamic shared memory per block, 1 (the planes
// are always in shared memory), whether W_m is staged there, 0 partials
// (nothing is reduced) and the bytes of the per-block global scratch (the
// f32 carry).
int workspace_entry(bool jac, int n, int si, int so, int n_mats, int chain, int G, int P, int* tile,
              int* splits, long long* smem_bytes, int* resident, int* staged_w,
              long long* partial_floats, long long* scratch_bytes) {
  FwdGeometry g{};
  const int status = fwd_geometry(jac, n, si, so, n_mats, chain, G, P, &g);
  if (status == 3) return status;
  *tile = g.tile;
  *splits = g.splits;
  *smem_bytes = (long long)g.smem;
  *resident = 1;
  *staged_w = g.stage_w;
  *partial_floats = 0;
  *scratch_bytes = (long long)g.grid_g * g.splits * (long long)g.block_bytes;
  return status;
}

}  // namespace

extern "C" {

// The geometry of the tensor-core K1 at [G, P] (a status as fwd_geometry()
// returns; on 0 and 2 the outputs are written; see workspace_entry()).
int nif_shapenet_fwd_tc_workspace(int n, int si, int so, int n_mats, int chain, int G, int P,
                                  int* tile, int* splits, long long* smem_bytes, int* resident,
                                  int* staged_w, long long* partial_floats,
                                  long long* scratch_bytes) {
  return workspace_entry(false, n, si, so, n_mats, chain, G, P, tile, splits, smem_bytes, resident,
                   staged_w, partial_floats, scratch_bytes);
}

// The same for the tensor-core K5 (reverse body; status 3 where so >= si).
int nif_shapenet_fwd_jac_tc_workspace(int n, int si, int so, int n_mats, int chain, int G,
                                      int P, int* tile, int* splits, long long* smem_bytes,
                                      int* resident, int* staged_w, long long* partial_floats,
                                      long long* scratch_bytes) {
  return workspace_entry(true, n, si, so, n_mats, chain, G, P, tile, splits, smem_bytes, resident,
                   staged_w, partial_floats, scratch_bytes);
}

// K1 in bf16 on the tensor cores (wb', x and out are bf16; wb' has rows of
// wb_ld >= po elements). chain: kSirenPlain or kSirenResblock; act:
// kSinePoly7 or kSinePoly9 (the bf16 sine). Returns the CUDA error of the
// launch (0 on success); the kernel runs asynchronously on `stream`.
int nif_shapenet_fwd_tc(const void* wb, const void* x, void* out, void* scratch, int G, int P,
                        int si, int so, int n, int n_mats, int chain, int act, long long po,
                        long long wb_ld, void* stream) {
  return launch_entry(false, wb, x, out, nullptr, scratch, G, P, si, so, n, n_mats, chain, act, po,
                wb_ld, stream);
}

// K5's reverse body in bf16 on the tensor cores (so < si; wb', x, y and jac
// are bf16, as for K1). Returns the CUDA error of the launch.
int nif_shapenet_fwd_jac_tc(const void* wb, const void* x, void* y, void* jac, void* scratch,
                            int G, int P, int si, int so, int n, int n_mats, int chain, int act,
                            long long po, long long wb_ld, void* stream) {
  return launch_entry(true, wb, x, y, jac, scratch, G, P, si, so, n, n_mats, chain, act, po, wb_ld,
                stream);
}

#ifdef K1_PHASE_CLOCKS
// K1's phase counters (the probe build only).
int nif_fwd_tc_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k1_phase_cycles, sizeof(k1_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[kPhases] = {};
  return (int)cudaMemcpyToSymbol(k1_phase_cycles, zero, sizeof(zero));
}
#endif

#ifdef K5_PHASE_CLOCKS
// K5's phase counters (the probe build only).
int nif_fwd_jac_tc_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k5_phase_cycles, sizeof(k5_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[kPhases] = {};
  return (int)cudaMemcpyToSymbol(k5_phase_cycles, zero, sizeof(zero));
}
#endif

const char* nif_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
