// K2's and K3's bf16 paths on Hopper's tensor cores: the fused MSE train
// pass of the grouped ShapeNet chain (forward, weighted MSE and backward in
// one pass, no dx) and the backward of the fused chain (the forward
// recomputed with its residuals, then g_out back to d_wb and dx), one body
// template, with every hidden product a warp-level mma.sync.m16n8k16 (bf16
// in, f32 accumulation).
//
// K2 replaces nif_tpu/ops/pallas_shapenet.py::_train_kernel (reached through
// shapenet_mse_grads) for bfloat16 inputs on sine chains (plain or resblock
// SIREN, si <= 4): wb' [G, po] (omega_0 folded into the sine-fed weights by
// the wrapper), x [G, P, si], target [G, P, so], weight [G, P] (optional)
// -> loss (f32) and d_wb [G, po] in bf16, both / G*P*so, the sine-fed
// weight grads multiplied back by omega_0 in f32.
// K3 replaces _bwd_kernel (the backward of shapenet_grouped_fused, reached
// through _fused_bwd) for the same inputs and chains: wb', x and g_out
// [G, P, so] -> d_wb [G, po] (not divided; the sine-fed grads times omega_0
// in f32, _unscale_grads) and dx [G, P, si], both bf16.
// The mode is the body's compile-time TRAIN flag, so no epilogue branches on
// it. float32, vanilla chains and si > 4 stay on shapenet_bwd.cu, whose f32
// products must not round to TF32.
//
// Its rounding points are K2's, not the tensor-core K6's (see the header of
// shapenet_bwd.cu; the reference's _forward_layers(save=True) and
// _backward_chain): each layer's input S is stored in bf16 and its
// activation DERIVATIVE is rounded to bf16 as the reference saves it; the
// backward carries du in f32 and rounds dz = (scale du) act' to bf16 before
// both its weight product and its bias sum; for so == 1 du starts as the
// f32 dL/dout times the last weight column, otherwise as the rounded dL/dout
// times W_last^T; dW_last and db_last use the rounded dL/dout (K3: g_out,
// a bf16 value, in its place; the first layer's dz0 is rounded too, and
// dx = dz0 @ W0'^T sums in f32 and rounds to bf16). The
// derivative is not kept from the forward: the backward recomputes Z_m =
// S_m @ W_m with the same mma sequence (the same bits) and rounds act'(Z_m
// + b_m) there. Every operand of a product is a bf16 value already, so each
// product is exact and only the order of the f32 sums differs from the
// CUDA-core kernel.
//
// What bounds it on an H100 SXM: operations. At the flagship train shape
// (G=32, P=32768, width 128, two hidden layers, si=3, so=1) K2's products
// are 208.6 GFLOP (forward, dW and du), ~0.21 ms at the 989 TFLOP/s bf16
// tensor-core peak; the Z recompute adds 69.8 GFLOP that the bound does not
// count. K3's are 209.4 GFLOP (its dx 0.8 more), ~0.21 ms.
//
// Design: K6's (shapenet_jac_tc.cu) with one stream, on the machinery of
// stack_tc.cuh.
// - A tile is 128 points of the value stream, eight 16-row mma slabs: the
//   registers and shared memory of K6's 32-point tiles of four streams.
//   Warp w owns the 16-column blocks w, w + 8, ... of every product over all
//   slabs, so the epilogues (the sine, act' and its rounding, dz and the
//   resblock averages), the bias grads and the whole first layer run in
//   registers. Both operands come through ldmatrix: the stacked plane and W
//   staged whole (cp.async): every hidden W_m once a group where they fit
//   beside the planes (the flagship), else each W_m before its products,
//   else W from global memory. The group's W0, biases and W_last (f32) and
//   the tile's targets and point weights (K3: its g_out, in the last
//   product's place: K3 skips the last product and the loss) are staged too.
// - Residuals: every S plane and D in shared memory where they fit (the
//   flagship: four planes of 128 x 136 bf16, 139 KB, beside both W_m, 70
//   KB), otherwise two working planes with the S planes in a per-block
//   global scratch; a resblock's f32 running state and block cotangent, and
//   the cotangents of a warp's further column blocks (widths above 128), in
//   a per-thread f32 carry in that scratch.
// - dW_m = S_m^T D_m over the tile's rows (weight_grad_stack), added into
//   the block's even-stride f32 partial in tile order; the partials of the
//   bias, first- and last-layer grads are read before the work that
//   produces their sums. stack_tc.cuh's ordered split reduce, with K2's
//   division by G*P*so (K3: none, and no loss), sums each group's partials.
//   No float atomics: two runs on the same inputs give the same bits.
// - The first layer (si <= 4 columns) and the last layer's grads (so <= a
//   few columns) stay f32 FMAs from shared memory; the last product runs on
//   the tensor cores, a slab a warp (last_product_mma). K3's dz0 goes into
//   the D plane, which is free by then, and dx = dz0 @ W0'^T runs on the
//   tensor cores a slab a warp over K = n (slab_product_mma, W0' the B
//   operand, its si <= 4 columns padded to 8), rounded and stored from the
//   accumulators: no plane, no cross-warp sum. The epilogues'
//   sine takes its coefficients from registers, chosen once, so no
//   evaluation branches on the polynomial's degree.
// The grid is (S, G) with S = SMs / G splits: one wave of one block per SM.
#include "stack_tc.cuh"

namespace {

constexpr int kTp = 128;        // points of a tile
constexpr int kNsl = kTp / 16;  // its 16-row slabs
constexpr int kMaxSiTc = 4;

struct TcArgs {
  const bf16* wb;          // wb' [G, wb_ld] (rows of po, padded to 16 bytes)
  const bf16* x;           // [G, P, si]
  const bf16* target;      // K2: [G, P, so]
  const bf16* weight;      // K2: [G, P], or null
  const bf16* g_out;       // K3: [G, P, so]
  bf16* dx;                // K3: [G, P, si]
  float* partials;         // [G, S, ps] weight-grad partials, then (K2) [G, S] loss partials
  unsigned char* scratch;  // per block: the S planes (when not resident), then the carry
  int G, P, so, n, n_mats, n16, ld, n_cb, resident, stage_w, stage_all;
  bool deg9;
  long long ps, wb_ld, block_bytes, carry_offset;  // ps: po rounded up to even
};

// A block partial's value at p before this tile's sum is added (0 on the
// block's first tile, or where the lane writes nothing), read early so its
// L2 latency overlaps the work that produces the sum; add_partial() then
// writes what accumulate() would: v on the first tile, old + v after it.
__device__ __forceinline__ float partial_before(const float* p, bool first, bool live) {
  return first || !live ? 0.f : *p;
}

__device__ __forceinline__ void add_partial(float* p, float old, float v, bool first) {
  *p = first ? v : old + v;
}

// The first layer's f32 weights W0'[k][c] and bias b0[c] of the thread's
// four columns of block cb (column (t, e) at 2t + e; zero from n on).
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

// Row r of the x tile [kTp, si] in f32.
template <int SI>
__device__ __forceinline__ void x_row(const bf16* X, int r, float (&xr)[SI]) {
#pragma unroll
  for (int k = 0; k < SI; ++k) xr[k] = __bfloat162float(X[r * SI + k]);
}

// Built with -DK2_PHASE_CLOCKS (by scripts/port_phase_probe.py only), thread
// 0 of every block adds the clock64() cycles from one barrier to the next
// into eight phase counters, which split the block's critical path.
#ifdef K2_PHASE_CLOCKS
constexpr int kPhases = 8;
__device__ unsigned long long k2_phase_cycles[kPhases];
#define K2_PHASE(i)                                        \
  do {                                                     \
    if (threadIdx.x == 0) {                                \
      const long long now = clock64();                     \
      phase_sum[i] += (unsigned long long)(now - phase_t); \
      phase_t = now;                                       \
    }                                                      \
  } while (0)
#else
#define K2_PHASE(i) \
  do {              \
  } while (0)
#endif

// The body of both kernels: TRAIN is K2 (targets, loss, the mean), else K3
// (g_out, dx).
template <int SI, bool RES, bool TRAIN>
__device__ __forceinline__ void chain_tc_body(const TcArgs& a) {
  constexpr int NSL = kNsl;  // slab h holds points 16h .. 16h+15
  constexpr int TR = kTp;    // stacked rows: the one stream
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, so = a.so, n_mats = a.n_mats, ld = a.ld, n16 = a.n16, n_cb = a.n_cb;
  const SinePoly sp = sine_poly(a.deg9);
  const size_t plane = (size_t)TR * ld;
  bf16* planes = reinterpret_cast<bf16*>(smem_raw);  // S planes, then D (resident); 2 working planes otherwise
  const int n_planes = a.resident ? n_mats + 2 : 2;
  const size_t wsz = (size_t)n16 * 16 * ld;  // one staged matrix
  bf16* WS = planes + n_planes * plane;  // [16 n16, ld] the staged W_m, or every W_m (stage_all)
  // [TR, so] last product, then dL/dout (K3: the tile's g_out)
  float* O = reinterpret_cast<float*>(WS + (a.stage_w ? (a.stage_all ? n_mats : 1) * wsz : 0));
  float* TT = O + TR * so;                   // K2: [TR, so] the tile's targets
  float* TW = TT + (TRAIN ? TR * so : 0);    // K2: [kTp] the tile's point weights
  float* LS = TW + (TRAIN ? kTp : 0);        // K2: [kWarps] loss sums
  float* W0f = LS + (TRAIN ? kWarps : 0);    // [si, n] the group's first layer, f32
  float* B0f = W0f + SI * n;      // [n]
  float* BHf = B0f + n;           // [n_mats, n] hidden biases
  float* WLf = BHf + n_mats * n;  // [n, so] last layer
  float* BLf = WLf + n * so;      // [so]
  bf16* X = reinterpret_cast<bf16*>(BLf + so);  // [kTp, si]
  bf16* Dp = planes + (a.resident ? (size_t)(n_mats + 1) * plane : plane);
  // the weight operand's source in stack_mma for app m
  auto ws = [&](int m) -> const bf16* {
    return a.stage_all ? WS + m * wsz : (a.stage_w ? WS : nullptr);
  };
  // the input plane of app m (m = n_mats: the last product's) in the forward
  auto fwd_plane = [&](int m) { return planes + (a.resident ? m : (m & 1)) * plane; };
  // ... and in the backward (scratch mode: copied back into plane 0 first)
  auto bwd_plane = [&](int m) { return a.resident ? planes + m * plane : planes; };
  const Lane l = lane_of_thread();

  const int S = gridDim.x, s = blockIdx.x;
  const int n_tiles = (a.P + kTp - 1) / kTp;
  const int t_begin = (int)((long long)s * n_tiles / S);
  const int t_end = (int)((long long)(s + 1) * n_tiles / S);
  const long long o_wh = (long long)SI * n;
  const long long o_wl = o_wh + (long long)n_mats * n * n;
  const long long o_b0 = o_wl + (long long)n * so;
  const long long o_bh = o_b0 + n;
  const long long o_bl = o_bh + (long long)n_mats * n;
  unsigned char* mine = a.scratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * a.block_bytes;
  bf16* gplanes = a.resident ? nullptr : reinterpret_cast<bf16*>(mine);  // [n_mats][TR, ld]
  float* carry = reinterpret_cast<float*>(mine + a.carry_offset);
#ifdef K2_PHASE_CLOCKS
  unsigned long long phase_sum[kPhases] = {};
  long long phase_t = clock64();
#endif

  for (int gi = blockIdx.y; gi < a.G; gi += gridDim.y) {
    const bf16* wg = a.wb + (long long)gi * a.wb_ld;
    float* part = a.partials + ((long long)gi * S + s) * a.ps;
    float loss[1] = {0.f};
    __syncthreads();  // the previous group is done with the staged parameters and W
    for (int i = threadIdx.x; i < SI * n; i += kThreads) W0f[i] = __bfloat162float(wg[i]);
    for (int i = threadIdx.x; i < n; i += kThreads) B0f[i] = __bfloat162float(wg[o_b0 + i]);
    for (int i = threadIdx.x; i < n_mats * n; i += kThreads) BHf[i] = __bfloat162float(wg[o_bh + i]);
    for (int i = threadIdx.x; i < n * so; i += kThreads) WLf[i] = __bfloat162float(wg[o_wl + i]);
    for (int i = threadIdx.x; i < so; i += kThreads) BLf[i] = __bfloat162float(wg[o_bl + i]);
    if (a.stage_all) {  // every hidden matrix, once a group (shown by the first tile's barrier)
      for (int m = 0; m < n_mats; ++m)
        stage_matrix(WS + m * wsz, ld, wg + o_wh + (long long)m * n * n, n, n, n16 * 16, n16 * 16);
      cp_async_wait_all();
    }
    int staged = -1;  // the hidden matrix in WS (one staged at a time)
    for (int tile = t_begin; tile < t_end; ++tile) {
      const bool first = tile == t_begin;
      const int p0 = tile * kTp;
      const int rows = min(kTp, a.P - p0);
      const long long row0 = (long long)gi * a.P + p0;
      __syncthreads();  // the previous tile is done with every buffer
      K2_PHASE(7);      // the first layer's backward (and the group's set-up)
      // the x tile, and the targets and weights its loss will read (K3: its
      // g_out), all loads in flight at once (zero past the ragged edge)
      const bf16* xg = a.x + row0 * SI;
      for (int idx = threadIdx.x; idx < kTp * SI; idx += kThreads)
        X[idx] = idx < rows * SI ? xg[idx] : __float2bfloat16_rn(0.f);
      if constexpr (TRAIN) {
        const bf16* tg = a.target + row0 * so;
        for (int idx = threadIdx.x; idx < TR * so; idx += kThreads)
          TT[idx] = idx < rows * so ? __bfloat162float(tg[idx]) : 0.f;
        for (int r = threadIdx.x; r < kTp; r += kThreads)
          TW[r] = r < rows && a.weight ? __bfloat162float(a.weight[row0 + r]) : 1.f;
      } else {
        const bf16* gg = a.g_out + row0 * so;
        for (int idx = threadIdx.x; idx < TR * so; idx += kThreads)
          O[idx] = idx < rows * so ? __bfloat162float(gg[idx]) : 0.f;
      }
      __syncthreads();

      // ---- first layer: z0 = x @ W0' + b0, S_0 = f(z0); a thread's four
      // columns' weights and each of its sixteen x rows loaded once
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
        store_stack<NSL>(fwd_plane(0), n_mats > 0 ? gplanes : nullptr, ld, n, cb, l, v);
        if (RES) carry_store<NSL>(carry_slot<NSL>(carry, 0, cbl, n_cb), v);
      }
      __syncthreads();  // S_0 is complete
      K2_PHASE(0);      // the x tile and the first layer

      // ---- hidden apps: Z = S_m @ W_m on the tensor cores, S_{m+1} = f(Z +
      // b_m) in registers (a resblock's h feeds its second matrix as it is;
      // the second app averages with the block's input in f32)
      for (int m = 0; m < n_mats; ++m) {
        const bool res_second = RES && m % 2 == 1;
        const bf16* Wm = wg + o_wh + (long long)m * n * n;
        const float* bm = BHf + m * n;
        if (a.stage_w && !a.stage_all && staged != m) {  // every read of the previous W is done
          stage_matrix(WS, ld, Wm, n, n, n16 * 16, n16 * 16);
          staged = m;
          cp_async_wait_all();
          __syncthreads();
        }
        bf16* copy = !a.resident && m + 1 < n_mats ? gplanes + (size_t)(m + 1) * plane : nullptr;
        for (int cbl = 0; cbl < n_cb; ++cbl) {
          const int cb = l.warp + kWarps * cbl;
          if (cb >= n16) break;
          float z[NSL][2][4];
          stack_mma<NSL, false>(fwd_plane(m), ld, 0, ws(m), Wm, n, n16, cb, l, z);
#pragma unroll
          for (int h = 0; h < NSL; ++h)
#pragma unroll
            for (int t = 0; t < 2; ++t)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int c = frag_col(cb, t, i, l);
                z[h][t][i] = sine_of(z[h][t][i] + (c < n ? bm[c] : 0.f), sp);
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
          store_stack<NSL>(fwd_plane(m + 1), copy, ld, n, cb, l, z);
        }
        __syncthreads();  // S_{m+1} is complete; every read of S_m is done
      }
      K2_PHASE(1);  // the hidden forward

      const bf16* Sl = fwd_plane(n_mats);
      if constexpr (TRAIN) {
        // ---- last product O = S_last @ W_last on the tensor cores, a slab a
        // warp
        last_product_mma(Sl, ld, TR, n, n16, WLf, so, O, l);
        __syncthreads();  // O is complete

        // ---- loss: err = out - t; sums w err^2; dL/dout = 2 w err (f32, 0
        // past the ragged edge) in place of O
        for (int idx = threadIdx.x; idx < TR * so; idx += kThreads) {
          const int r = idx / so;
          float go = 0.f;
          if (r < rows) {
            const float err = O[idx] + BLf[idx - r * so] - TT[idx];
            const float w = TW[r];
            loss[0] += err * err * w;
            go = 2.f * err * w;
          }
          O[idx] = go;
        }
        __syncthreads();  // dL/dout is complete
      }
      K2_PHASE(2);  // the last product and the loss

      // ---- last layer: dW_l = S_last^T lift(go), db_l = the sum of
      // lift(go), and du = go W_l^T (so == 1: the f32 go times the column)
      // into the registers of the column blocks' owners
      for (int idx = threadIdx.x; idx < n * so; idx += kThreads) {
        const int k = idx / so;
        const int j = idx - k * so;
        const float old = partial_before(part + o_wl + idx, first, true);
        float sum = 0.f;
        for (int rr = 0; rr < TR; ++rr)
          sum = fmaf(__bfloat162float(Sl[rr * ld + k]), lift<bf16>(O[rr * so + j]), sum);
        add_partial(part + o_wl + idx, old, sum, first);
      }
      for (int j = threadIdx.x; j < so; j += kThreads) {
        const float old = partial_before(part + o_bl + j, first, true);
        float sum = 0.f;
        for (int r = 0; r < kTp; ++r) sum += lift<bf16>(O[r * so + j]);
        add_partial(part + o_bl + j, old, sum, first);
      }
      float ds[NSL][2][4];  // du (or a resblock's dh): the cotangent of the current app's output
      for (int cbl = 0; cbl < n_cb; ++cbl) {
        const int cb = l.warp + kWarps * cbl;
        if (cb >= n16) break;
#pragma unroll
        for (int h = 0; h < NSL; ++h)
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int i = 0; i < 4; ++i) ds[h][t][i] = 0.f;
        for (int j = 0; j < so; ++j) {
          float wlj[2][2];
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = frag_col(cb, t, e, l);
              wlj[t][e] = c < n ? WLf[c * so + j] : 0.f;
            }
#pragma unroll
          for (int h = 0; h < NSL; ++h)
#pragma unroll
            for (int t = 0; t < 2; ++t)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float go = O[(16 * h + l.g + 8 * (i >> 1)) * so + j];
                ds[h][t][i] = so == 1 ? go * wlj[t][i & 1]
                                      : fmaf(lift<bf16>(go), wlj[t][i & 1], ds[h][t][i]);
              }
        }
        if (n_cb > 1) carry_store<NSL>(carry_slot<NSL>(carry, 1, cbl, n_cb), ds);
      }
      __syncthreads();  // every read of S_last is done
      K2_PHASE(3);      // the last layer's backward

      // ---- hidden apps, last to first
      for (int m = n_mats - 1; m >= 0; --m) {
        const bool res_second = RES && m % 2 == 1;
        const float scale = res_second ? 0.5f : 1.f;
        const bf16* Wm = wg + o_wh + (long long)m * n * n;
        const float* bm = BHf + m * n;
        bf16* Sm = bwd_plane(m);
        const bool stage = a.stage_w && !a.stage_all && staged != m;
        if (!a.resident || stage) {  // every read of the previous S and W is done
          if (!a.resident) {  // S_m back from the global scratch
            const bf16* src = gplanes + (size_t)m * plane;
            for (size_t idx = threadIdx.x; idx < plane / 8; idx += kThreads)
              cp_async16(Sm + idx * 8, src + idx * 8, true);
          }
          if (stage) {
            stage_matrix(WS, ld, Wm, n, n, n16 * 16, n16 * 16);
            staged = m;
          }
          cp_async_wait_all();
          __syncthreads();
        }
        // dz = lift((scale du) lift(act'(Z + b))): the rounded derivative
        // the reference saves, and dz rounded before both its weight
        // product and its bias sum
        for (int cbl = 0; cbl < n_cb; ++cbl) {
          const int cb = l.warp + kWarps * cbl;
          if (cb >= n16) break;
          if (n_cb > 1) carry_load<NSL>(carry_slot<NSL>(carry, 1, cbl, n_cb), ds);
          if (res_second) carry_store<NSL>(carry_slot<NSL>(carry, 0, cbl, n_cb), ds);
          float z[NSL][2][4];
          stack_mma<NSL, false>(Sm, ld, 0, ws(m), Wm, n, n16, cb, l, z);
          float old_b[2][2];  // the bias grads' partials, read while the epilogue runs
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              old_b[t][e] = partial_before(part + o_bh + (long long)m * n + frag_col(cb, t, e, l),
                                           first, l.g == 0 && frag_col(cb, t, e, l) < n);
#pragma unroll
          for (int h = 0; h < NSL; ++h)
#pragma unroll
            for (int t = 0; t < 2; ++t)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int c = frag_col(cb, t, i, l);
                const float d = lift<bf16>(sine_slope(z[h][t][i] + (c < n ? bm[c] : 0.f), sp));
                ds[h][t][i] = lift<bf16>(scale * ds[h][t][i] * d);
              }
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float v = 0.f;
#pragma unroll
              for (int h = 0; h < NSL; ++h) v += ds[h][t][e] + ds[h][t][2 + e];
              const float sum = quad_column_sum(v);
              const int c = frag_col(cb, t, e, l);
              if (l.g == 0 && c < n)
                add_partial(part + o_bh + (long long)m * n + c, old_b[t][e], sum, first);
            }
          store_stack<NSL>(Dp, nullptr, ld, n, cb, l, ds);
        }
        __syncthreads();  // D is complete
        K2_PHASE(4);      // the Z recompute and the backward epilogue
        weight_grad_stack(Sm, Dp, ld, n, n16, TR, part + o_wh + (long long)m * n * n, first, l);
        K2_PHASE(5);  // dW (no barrier: thread 0's own tasks)
        // du = D @ W_m^T: the cotangent of the app's input (a resblock's
        // second app: of its h; its first app adds the skip path's half of
        // the block's cotangent)
        for (int cbl = 0; cbl < n_cb; ++cbl) {
          const int cb = l.warp + kWarps * cbl;
          if (cb >= n16) break;
          stack_mma<NSL, true>(Dp, ld, 0, ws(m), Wm, n, n16, cb, l, ds);
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
        __syncthreads();  // every read of D and S_m is done
        K2_PHASE(6);      // du
      }

      // ---- first layer: dz0 = lift(du lift(f'(z0))); dW0 = x^T dz0, db0 the
      // sum of dz0; each x row loaded once for the thread's four columns (K3:
      // dz0 in place of du, then into the D plane, every read of it done)
      for (int cbl = 0; cbl < n_cb; ++cbl) {
        const int cb = l.warp + kWarps * cbl;
        if (cb >= n16) break;
        if (n_cb > 1) carry_load<NSL>(carry_slot<NSL>(carry, 1, cbl, n_cb), ds);
        // the partials of this thread's columns, all reads in flight at once
        float old_w0[4][SI], old_b0[4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = frag_col(cb, t, e, l);
            const bool live = l.g == 0 && c < n;
#pragma unroll
            for (int k = 0; k < SI; ++k)
              old_w0[2 * t + e][k] = partial_before(part + k * n + c, first, live);
            old_b0[2 * t + e] = partial_before(part + o_b0 + c, first, live);
          }
        float w0[4][SI], b0[4];
        first_layer_columns<SI>(W0f, B0f, n, cb, l, w0, b0);
        float dw0[4][SI], db0[4];  // the thread's points' sums
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          db0[j] = 0.f;
#pragma unroll
          for (int k = 0; k < SI; ++k) dw0[j][k] = 0.f;
        }
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
                const int j = 2 * t + e;
                float z = 0.f;
#pragma unroll
                for (int k = 0; k < SI; ++k) z = fmaf(xr[k], w0[j][k], z);
                const float dz =
                    lift<bf16>(ds[h][t][2 * hh + e] * lift<bf16>(sine_slope(z + b0[j], sp)));
#pragma unroll
                for (int k = 0; k < SI; ++k) dw0[j][k] = fmaf(xr[k], dz, dw0[j][k]);
                db0[j] += dz;
                if constexpr (!TRAIN) ds[h][t][2 * hh + e] = dz;
              }
          }
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 2 * t + e;
            const int c = frag_col(cb, t, e, l);
#pragma unroll
            for (int k = 0; k < SI; ++k) {
              const float sum = quad_column_sum(dw0[j][k]);
              if (l.g == 0 && c < n) add_partial(part + k * n + c, old_w0[j][k], sum, first);
            }
            const float sum = quad_column_sum(db0[j]);
            if (l.g == 0 && c < n) add_partial(part + o_b0 + c, old_b0[j], sum, first);
          }
        if constexpr (!TRAIN) store_stack<NSL>(Dp, nullptr, ld, n, cb, l, ds);
      }
      if constexpr (!TRAIN) {
        // ---- dx = dz0 @ W0'^T on the tensor cores, a slab a warp, rounded
        // to bf16 (rows past the ragged edge not stored)
        __syncthreads();  // dz0 is complete
        bf16* dxg = a.dx + row0 * SI;
        slab_product_mma(
            Dp, ld, TR, n16, SI,
            [&](int k, int c) { return __float2bfloat16_rn(k < n && c < SI ? W0f[c * n + k] : 0.f); },
            [&](int r, int c, float v) {
              if (r < rows) dxg[r * SI + c] = __float2bfloat16_rn(v);
            },
            l);
      }
    }

    // the block's loss partial, after its [G, S, ps] weight grads
    if constexpr (TRAIN)
      store_loss_partials(loss, LS, a.partials + (long long)a.G * S * a.ps + (long long)gi * S + s);
  }
#ifdef K2_PHASE_CLOCKS
  if (threadIdx.x == 0)
    for (int i = 0; i < kPhases; ++i) atomicAdd(&k2_phase_cycles[i], phase_sum[i]);
#endif
}

template <int SI, bool RES>
__global__ void __launch_bounds__(kThreads, 1) mse_tc_kernel(const TcArgs a) {
  chain_tc_body<SI, RES, true>(a);
}

template <int SI, bool RES>
__global__ void __launch_bounds__(kThreads, 1) bwd_tc_kernel(const TcArgs a) {
  chain_tc_body<SI, RES, false>(a);
}

// Status of a shape: 0 = ok, 2 = even two working planes exceed a block's
// shared memory, 3 = bad shape (or a chain or si the kernel does not take);
// the layout is stack_geometry()'s, over 128-point tiles of one stream (K3
// stages no targets, point weights or loss sums: train = false).
// Where the planes are resident and every hidden matrix fits beside them too
// (the flagship: 139 KB of planes and two W of 35 KB), each group's W_m are
// staged once (stage_all) instead of one at a time, twice a tile.
int tc_geometry(bool train, int n, int si, int so, int n_mats, int chain, int G, int P,
                StackGeometry* g, int* stage_all) {
  if (n < 1 || si < 1 || si > kMaxSiTc || so < 1 || n_mats < 0 || G < 1 || P < 1 ||
      (chain != kSirenPlain && chain != kSirenResblock) || (chain == kSirenResblock && n_mats % 2))
    return 3;
  const int status = stack_geometry(n, si, so, n_mats, chain, G, P, kTp, kTp, train ? 1 : 0, g,
                                    train);
  const size_t all = g->smem + (size_t)(n_mats - 1) * 2 * g->n16 * 16 * g->ld;
  *stage_all = g->resident && n_mats > 1 && all <= kMaxSmem;
  if (*stage_all) g->smem = all;
  return status;
}

template <int SI, bool RES, bool TRAIN>
int launch_tc(const StackGeometry& geo, const TcArgs& a, cudaStream_t stream) {
  auto kernel = TRAIN ? mse_tc_kernel<SI, RES> : bwd_tc_kernel<SI, RES>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(geo.splits, geo.grid_g), kThreads, geo.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool TRAIN, bool RES>
int launch_si(int si, const StackGeometry& geo, const TcArgs& a, cudaStream_t stream) {
  switch (si) {
    case 1: return launch_tc<1, RES, TRAIN>(geo, a, stream);
    case 2: return launch_tc<2, RES, TRAIN>(geo, a, stream);
    case 3: return launch_tc<3, RES, TRAIN>(geo, a, stream);
    case 4: return launch_tc<4, RES, TRAIN>(geo, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The geometry of a mode at [G, P] (a status as tc_geometry() returns; on 0
// and 2 the outputs are written): see nif_shapenet_mse_tc_workspace.
int workspace(bool train, int n, int si, int so, int n_mats, int chain, int G, int P, int* tile,
              int* splits, long long* smem_bytes, int* resident, int* staged_w,
              long long* partial_floats, long long* scratch_bytes) {
  StackGeometry g{};
  int stage_all = 0;
  const int status = tc_geometry(train, n, si, so, n_mats, chain, G, P, &g, &stage_all);
  if (status == 3) return status;
  const long long po = (long long)n_mats * n * n + (long long)(si + so + 1 + n_mats) * n + so;
  const long long ps = po + (po & 1);
  *tile = kTp;
  *splits = g.splits;
  *smem_bytes = (long long)g.smem;
  *resident = g.resident;
  *staged_w = g.stage_w;
  *partial_floats = (long long)G * g.splits * (ps + (train ? 1 : 0));
  *scratch_bytes = (long long)g.grid_g * g.splits * (long long)g.block_bytes;
  return status;
}

// Fills the arguments both modes share and launches the body of a mode;
// returns the CUDA error of the launch, or cudaErrorInvalidValue for a shape
// or an activation the kernel does not take.
template <bool TRAIN>
int launch_body(TcArgs& a, int G, int P, int si, int so, int n, int n_mats, int chain, int act,
                long long po, long long wb_ld, StackGeometry* geo, cudaStream_t s) {
  int stage_all = 0;
  if ((act != kSinePoly7 && act != kSinePoly9) || wb_ld < po ||
      tc_geometry(TRAIN, n, si, so, n_mats, chain, G, P, geo, &stage_all) != 0)
    return (int)cudaErrorInvalidValue;
  a.G = G; a.P = P; a.so = so; a.n = n; a.n_mats = n_mats;
  a.n16 = geo->n16; a.ld = geo->ld; a.n_cb = geo->n_cb; a.resident = geo->resident;
  a.stage_w = geo->stage_w;
  a.stage_all = stage_all;
  a.deg9 = act == kSinePoly9;
  a.ps = po + (po & 1);
  a.wb_ld = wb_ld;
  a.block_bytes = (long long)geo->block_bytes;
  a.carry_offset = (long long)geo->carry_offset;
  return chain == kSirenResblock ? launch_si<TRAIN, true>(si, *geo, a, s)
                                 : launch_si<TRAIN, false>(si, *geo, a, s);
}

}  // namespace

extern "C" {

// The geometry of the tensor-core K2 at [G, P] (a status as tc_geometry()
// returns; on 0 and 2 the outputs are written): points per tile, P splits
// per group, dynamic shared memory per block, whether the S planes are
// resident in shared memory, whether W_m is staged there, the f32 partials
// the caller allocates (G*S*ps, ps = po rounded up to even, weight grads,
// then G*S losses) and the bytes of the per-block global scratch (S planes
// when not resident, and the f32 carry).
int nif_shapenet_mse_tc_workspace(int n, int si, int so, int n_mats, int chain, int G, int P,
                                  int* tile, int* splits, long long* smem_bytes, int* resident,
                                  int* staged_w, long long* partial_floats,
                                  long long* scratch_bytes) {
  return workspace(true, n, si, so, n_mats, chain, G, P, tile, splits, smem_bytes, resident,
                   staged_w, partial_floats, scratch_bytes);
}

// The geometry of the tensor-core K3, as nif_shapenet_mse_tc_workspace's:
// its shared memory holds no targets, point weights or loss sums, and its
// partials no losses (G*S*ps floats).
int nif_shapenet_bwd_tc_workspace(int n, int si, int so, int n_mats, int chain, int G, int P,
                                  int* tile, int* splits, long long* smem_bytes, int* resident,
                                  int* staged_w, long long* partial_floats,
                                  long long* scratch_bytes) {
  return workspace(false, n, si, so, n_mats, chain, G, P, tile, splits, smem_bytes, resident,
                   staged_w, partial_floats, scratch_bytes);
}

// K2 in bf16 on the tensor cores (wb', x, target, weight and d_wb are bf16;
// wb' has rows of wb_ld >= po elements, d_wb of po); weight may be null.
// chain: kSirenPlain or kSirenResblock; act: kSinePoly7 or kSinePoly9 (the
// bf16 sine). loss receives the weighted mean. Returns the CUDA error of the
// launches (0 on success); the kernels run asynchronously on `stream`.
int nif_shapenet_mse_grads_tc(const void* wb, const void* x, const void* target,
                              const void* weight, void* loss, void* d_wb, void* partials,
                              void* scratch, int G, int P, int si, int so, int n, int n_mats,
                              int chain, int act, long long po, long long wb_ld,
                              long long n_scaled, float omega, void* stream) {
  TcArgs a{};
  a.wb = static_cast<const bf16*>(wb);
  a.x = static_cast<const bf16*>(x);
  a.target = static_cast<const bf16*>(target);
  a.weight = static_cast<const bf16*>(weight);
  a.partials = static_cast<float*>(partials);
  a.scratch = static_cast<unsigned char*>(scratch);
  StackGeometry geo{};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_body<true>(a, G, P, si, so, n, n_mats, chain, act, po, wb_ld, &geo, s);
  if (err != 0) return err;
  const float n_elem = (float)((long long)G * P * so);
  const LossNorms norms{{n_elem}};
  return launch_stack_reduce<1>(a.partials, G, geo.splits, po, n_scaled, omega, n_elem, norms,
                                static_cast<bf16*>(d_wb), static_cast<float*>(loss), s);
}

// K3 in bf16 on the tensor cores (wb', x, g_out, d_wb and dx are bf16; wb'
// has rows of wb_ld >= po elements, d_wb of po): d_wb not divided, the
// n_scaled sine-fed weight grads times omega in f32; dx [G, P, si]. chain
// and act as K2's. Returns the CUDA error of the launches (0 on success);
// the kernels run asynchronously on `stream`.
int nif_shapenet_bwd_tc(const void* wb, const void* x, const void* g_out, void* d_wb, void* dx,
                        void* partials, void* scratch, int G, int P, int si, int so, int n,
                        int n_mats, int chain, int act, long long po, long long wb_ld,
                        long long n_scaled, float omega, void* stream) {
  TcArgs a{};
  a.wb = static_cast<const bf16*>(wb);
  a.x = static_cast<const bf16*>(x);
  a.g_out = static_cast<const bf16*>(g_out);
  a.dx = static_cast<bf16*>(dx);
  a.partials = static_cast<float*>(partials);
  a.scratch = static_cast<unsigned char*>(scratch);
  StackGeometry geo{};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_body<false>(a, G, P, si, so, n, n_mats, chain, act, po, wb_ld, &geo, s);
  if (err != 0) return err;
  return launch_stack_reduce<0>(a.partials, G, geo.splits, po, n_scaled, omega, 1.f, LossNorms{},
                                static_cast<bf16*>(d_wb), nullptr, s);
}

#ifdef K2_PHASE_CLOCKS
// The phase counters summed over every block since the last call, then
// zeroed (the probe build only).
int nif_mse_tc_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k2_phase_cycles, sizeof(k2_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[kPhases] = {};
  return (int)cudaMemcpyToSymbol(k2_phase_cycles, zero, sizeof(zero));
}
#endif

const char* nif_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
