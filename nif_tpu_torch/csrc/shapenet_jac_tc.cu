// K6's bf16 path on Hopper's tensor cores: the fused Sobolev train pass of
// the grouped ShapeNet chain, with every stacked product a warp-level
// mma.sync.m16n8k16 (bf16 in, f32 accumulation).
//
// Replaces nif_tpu/ops/pallas_shapenet.py::_sobolev_kernel (reached through
// shapenet_sobolev_grads; its backward is _sobolev_backward_chain) for
// bfloat16 inputs; float32 stays on shapenet_jac.cu's stacked_kernel, whose
// f32 products must not round to TF32. What it computes, and where it
// rounds, is that kernel's (see shapenet_jac.cu): S, the input of each
// product, is stored in bf16; the running state U and the raw products Z
// stay f32 and every epilogue runs in f32 from Z; the backward's D rows are
// rounded before their products, but the value-row dz that the bias grads
// sum is not; the first layer's dW0 sums the unrounded tangent seed rows;
// dW_last and dS use the rounded D_out; the sine is the bf16 polynomial.
// Every operand of a product is a bf16 value already, so each product is
// exact and only the order of the f32 sums differs from the CUDA-core
// kernel.
//
// What bounds it on an H100 SXM: operations. At the flagship train shape
// (G=32, P=32768, width 128, two hidden layers, si=3, so=1) its products
// are 829.5 GFLOP (forward, dW and dS over the 1 + si streams), ~0.84 ms at
// the 989 TFLOP/s bf16 tensor-core peak; the Z recompute below adds 275
// GFLOP that the bound does not count.
//
// Design: K8's (shapenet_hess_tc.cu), on the machinery both share in
// stack_tc.cuh.
// - A tile is 32 points, stacked stream-major: row st*32 + r holds stream st
//   (0 the values, 1 + k the tangents d/dx_k) of point r, so each stream is
//   two 16-row mma slabs; at si = 3 that is 128 rows, eight slabs. K8's ten
//   streams give ten independent slabs a k-step at 16 points, K6's four
//   only four, and the time of these kernels is latency, not mma issue; 32
//   points also halve the per-point cost of the dW partials' read-modify-
//   write, which runs once a tile. (At 64 points a thread would hold 16
//   slabs of accumulators beside 16 of cotangents: more than 255 registers.)
// - Warp w owns the 16-column blocks w, w + 8, ... over all slabs: a thread
//   holds one (point, column) of every stream, so the tangent product rule
//   (S_tan' = act'(z) Z_tan), the backward's curvature term (dz = D_val
//   act'(z) + sum_k D_tan_k act''(z) Z_tan_k), the bias grads and the whole
//   first layer run in registers. Both operands come through ldmatrix: the
//   stacked plane, and W staged whole (cp.async): every hidden W_m once a
//   group where they fit beside the planes (the flagship), else each W_m
//   before its products. The group's W0, biases and W_last (f32) and the
//   tile's targets are staged too.
// - Z is not kept: the backward recomputes Z_m = S_m @ W_m with the same
//   mma sequence (the same bits), all slabs at once.
// - Residuals: every S plane and D in shared memory where they fit (the
//   flagship: four planes of 128 x 136 bf16, 139 KB, beside both W_m, 70 KB),
//   otherwise two working planes with the S planes in a per-block global
//   scratch, and W_m from global memory where even it does not fit; a
//   resblock's f32 running state and block cotangent, and the cotangents of
//   a warp's further column blocks (widths above 128), in a per-thread f32
//   carry in that scratch.
// - dW_m = S_m^T D_m over all stacked rows, added into the block's
//   even-stride f32 partial in tile order (float2 pairs); the partials of
//   the bias, first- and last-layer grads are read before the work that
//   produces their sums, so no add waits on L2. An ordered split reduce sums
//   each group's partials. No float atomics: two runs on the same inputs
//   give the same bits.
// - The last product and the last layer's grads (so <= a few columns) stay
//   f32 FMAs from shared memory.
// The grid is (S, G) with S = SMs / G splits: one wave of one block per SM.
#include "stack_tc.cuh"

namespace {

constexpr int kTp = 32;          // points of a tile
constexpr int kPh = kTp / 16;    // 16-row slabs a stream
constexpr int kMaxSiTc = 4;

struct SobArgs {
  const bf16* wb;          // wb' [G, wb_ld] (rows of po, padded to 16 bytes)
  const bf16* x;           // [G, P, si]
  const bf16* target;      // [G, P, so]
  const bf16* jt;          // [G, P, si*so], column k*so + j = d y_j / d x_k
  const float* y_mask;     // [so] 0/1, or null
  const float* jac_mask;   // [si*so] 0/1, or null
  const bf16* weight;      // [G, P], or null
  float* partials;         // [G, S, ps] weight-grad partials, then [G, S, 2] loss partials
  unsigned char* scratch;  // per block: the S planes (when not resident), then the carry
  float ky, kj;            // 2 w_value / n_y, 2 w_jac / n_j
  int G, P, so, n, n_mats, n16, ld, n_cb, resident, stage_w, stage_all;
  bool deg9;
  long long po, ps, wb_ld, block_bytes, carry_offset;  // ps: po rounded up to even
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

// Built with -DK6_PHASE_CLOCKS (by scripts/port_phase_probe.py only), thread
// 0 of every block adds the clock64() cycles from one barrier to the next
// into eight phase counters, which split the block's critical path.
#ifdef K6_PHASE_CLOCKS
constexpr int kPhases = 8;
__device__ unsigned long long k6_phase_cycles[kPhases];
#define K6_PHASE(i)                                        \
  do {                                                     \
    if (threadIdx.x == 0) {                                \
      const long long now = clock64();                     \
      phase_sum[i] += (unsigned long long)(now - phase_t); \
      phase_t = now;                                       \
    }                                                      \
  } while (0)
#else
#define K6_PHASE(i) \
  do {              \
  } while (0)
#endif

template <int SI, bool RES>
__global__ void __launch_bounds__(kThreads, 1) sob_tc_kernel(const SobArgs a) {
  constexpr int NS = 1 + SI;       // streams
  constexpr int NSL = NS * kPh;    // 16-row slabs; slab st*kPh + h holds points 16h .. 16h+15
  constexpr int TR = NS * kTp;     // stacked rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, so = a.so, n_mats = a.n_mats, ld = a.ld, n16 = a.n16, n_cb = a.n_cb;
  const SinePoly sp = sine_poly(a.deg9);
  const size_t plane = (size_t)TR * ld;
  bf16* planes = reinterpret_cast<bf16*>(smem_raw);  // S planes, then D (resident); 2 working planes otherwise
  const int n_planes = a.resident ? n_mats + 2 : 2;
  const size_t wsz = (size_t)n16 * 16 * ld;  // one staged matrix
  bf16* WS = planes + n_planes * plane;  // [16 n16, ld] the staged W_m, or every W_m (stage_all)
  // [TR, so] last product, then D_out
  float* O = reinterpret_cast<float*>(WS + (a.stage_w ? (a.stage_all ? n_mats : 1) * wsz : 0));
  float* TT = O + TR * so;        // [TR, so] the tile's value and Jacobian targets
  float* TW = TT + TR * so;       // [kTp] the tile's point weights
  float* LS = TW + kTp;           // [2, kWarps] loss sums
  float* W0f = LS + 2 * kWarps;   // [si, n] the group's first layer, f32
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
#ifdef K6_PHASE_CLOCKS
  unsigned long long phase_sum[kPhases] = {};
  long long phase_t = clock64();
#endif

  for (int gi = blockIdx.y; gi < a.G; gi += gridDim.y) {
    const bf16* wg = a.wb + (long long)gi * a.wb_ld;
    float* part = a.partials + ((long long)gi * S + s) * a.ps;
    float loss[2] = {0.f, 0.f};  // value, Jacobian
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
      K6_PHASE(7);      // the first layer's backward (and the group's set-up)
      // the x tile, and the targets and weights its loss will read, all
      // loads in flight at once (zero past the ragged edge)
      const bf16* xg = a.x + row0 * SI;
      for (int idx = threadIdx.x; idx < kTp * SI; idx += kThreads)
        X[idx] = idx < rows * SI ? xg[idx] : __float2bfloat16_rn(0.f);
      for (int idx = threadIdx.x; idx < TR * so; idx += kThreads) {
        const int st = idx / (kTp * so);
        const int rem = idx - st * kTp * so;
        const int r = rem / so;
        const int jo = rem - r * so;
        const long long p = row0 + r;
        const bf16* src = st == 0 ? a.target + p * so + jo : a.jt + (p * SI + st - 1) * so + jo;
        TT[idx] = r < rows ? __bfloat162float(*src) : 0.f;
      }
      for (int r = threadIdx.x; r < kTp; r += kThreads)
        TW[r] = r < rows && a.weight ? __bfloat162float(a.weight[row0 + r]) : 1.f;
      __syncthreads();

      // ---- first layer: z0 = x @ W0' + b0; values f(z0), tangent seeds
      // f'(z0) W0'[k]
      for (int cbl = 0; cbl < n_cb; ++cbl) {
        const int cb = l.warp + kWarps * cbl;
        if (cb >= n16) break;
        float v[NSL][2][4];
#pragma unroll
        for (int h = 0; h < kPh; ++h)
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int c = frag_col(cb, t, i, l);
              const int r = 16 * h + l.g + 8 * (i >> 1);
              float w0[SI];
              float z = 0.f;
#pragma unroll
              for (int k = 0; k < SI; ++k) {
                w0[k] = c < n ? W0f[k * n + c] : 0.f;
                z = fmaf(__bfloat162float(X[r * SI + k]), w0[k], z);
              }
              z += c < n ? B0f[c] : 0.f;
              float d1, d2;
              v[h][t][i] = sine3(z, sp, &d1, &d2);
#pragma unroll
              for (int k = 0; k < SI; ++k) v[(1 + k) * kPh + h][t][i] = d1 * w0[k];
            }
        store_stack<NSL>(fwd_plane(0), n_mats > 0 ? gplanes : nullptr, ld, n, cb, l, v);
        if (RES) carry_store<NSL>(carry_slot<NSL>(carry, 0, cbl, n_cb), v);
      }
      __syncthreads();  // S_0 is complete
      K6_PHASE(0);      // the x tile and the first layer

      // ---- hidden apps: Z = S_m @ W_m on the tensor cores, then the
      // epilogue in registers: new value f(z), tangent f' Z_k (a resblock's
      // h feeds its second matrix as it is; the second app averages with the
      // block's input)
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
          for (int h = 0; h < kPh; ++h)
#pragma unroll
            for (int t = 0; t < 2; ++t)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int c = frag_col(cb, t, i, l);
                float gd, hd;
                const float av = sine3(z[h][t][i] + (c < n ? bm[c] : 0.f), sp, &gd, &hd);
#pragma unroll
                for (int k = 0; k < SI; ++k)
                  z[(1 + k) * kPh + h][t][i] = gd * z[(1 + k) * kPh + h][t][i];
                z[h][t][i] = av;
              }
          if (res_second) {
            float u[NSL][2][4];
            float* cs = carry_slot<NSL>(carry, 0, cbl, n_cb);
            carry_load<NSL>(cs, u);
#pragma unroll
            for (int sl = 0; sl < NSL; ++sl)
#pragma unroll
              for (int t = 0; t < 2; ++t)
#pragma unroll
                for (int i = 0; i < 4; ++i) z[sl][t][i] = 0.5f * (u[sl][t][i] + z[sl][t][i]);
            carry_store<NSL>(cs, z);
          }
          store_stack<NSL>(fwd_plane(m + 1), copy, ld, n, cb, l, z);
        }
        __syncthreads();  // S_{m+1} is complete; every read of S_m is done
      }
      K6_PHASE(1);  // the hidden forward

      // ---- last product O = S_last @ W_last over all TR rows (f32 FMAs, a
      // thread per output, four partial sums)
      const bf16* Sl = fwd_plane(n_mats);
      for (int pr = threadIdx.x; pr < TR * so; pr += kThreads) {
        const int rr = pr / so;
        const int j = pr - rr * so;
        const bf16* srow = Sl + rr * ld;
        float sum[4] = {0.f, 0.f, 0.f, 0.f};
        int k = 0;
        for (; k + 4 <= n; k += 4)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            sum[u] = fmaf(__bfloat162float(srow[k + u]), WLf[(k + u) * so + j], sum[u]);
        for (; k < n; ++k) sum[0] = fmaf(__bfloat162float(srow[k]), WLf[k * so + j], sum[0]);
        O[pr] = (sum[0] + sum[1]) + (sum[2] + sum[3]);
      }
      __syncthreads();  // O is complete

      // ---- loss: err = mask (out - t), e_k = mask (O_k - jt_k); sums
      // w err^2, w e^2; D_out = [ky w err; kj w e_k] in place of O
      for (int idx = threadIdx.x; idx < kTp * so; idx += kThreads) {
        const int r = idx / so;
        const int jo = idx - r * so;
        const bool live = r < rows;
        const float w = TW[r];
        float dv = 0.f;
        if (live) {
          float err = O[idx] + BLf[jo] - TT[idx];
          if (a.y_mask) err = err * a.y_mask[jo];
          loss[0] += err * err * w;
          dv = a.ky * err * w;
        }
        O[idx] = dv;
        for (int k = 0; k < SI; ++k) {
          const int o = ((1 + k) * kTp + r) * so + jo;
          float dj = 0.f;
          if (live) {
            float e = O[o] - TT[o];
            if (a.jac_mask) e = e * a.jac_mask[k * so + jo];
            loss[1] += e * e * w;
            dj = a.kj * e * w;
          }
          O[o] = dj;
        }
      }
      __syncthreads();  // D_out is complete
      K6_PHASE(2);      // the last product and the loss

      // ---- last layer: dW_l = S_last^T lift(D_out), db_l = the value rows'
      // sum of D_out, and dS = lift(D_out) @ W_l^T into the registers of the
      // column blocks' owners
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
        for (int r = 0; r < kTp; ++r) sum += O[r * so + j];
        add_partial(part + o_bl + j, old, sum, first);
      }
      float ds[NSL][2][4];  // the cotangent of the current app's output streams
      for (int cbl = 0; cbl < n_cb; ++cbl) {
        const int cb = l.warp + kWarps * cbl;
        if (cb >= n16) break;
#pragma unroll
        for (int sl = 0; sl < NSL; ++sl)
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int i = 0; i < 4; ++i) ds[sl][t][i] = 0.f;
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
          for (int sl = 0; sl < NSL; ++sl)
#pragma unroll
            for (int t = 0; t < 2; ++t)
#pragma unroll
              for (int i = 0; i < 4; ++i)
                ds[sl][t][i] = fmaf(lift<bf16>(O[(sl * 16 + l.g + 8 * (i >> 1)) * so + j]),
                                    wlj[t][i & 1], ds[sl][t][i]);
        }
        if (n_cb > 1) carry_store<NSL>(carry_slot<NSL>(carry, 1, cbl, n_cb), ds);
      }
      __syncthreads();  // every read of S_last is done
      K6_PHASE(3);      // the last layer's backward

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
        // with du, dt_k the scaled cotangents of the app's output streams:
        // dz = du f' + sum_k dt_k Z_k f''; D = [dz; dt_k f'], each rounded
        // to bf16
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
          float dz[kPh][2][4];
#pragma unroll
          for (int h = 0; h < kPh; ++h)
#pragma unroll
            for (int t = 0; t < 2; ++t)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int c = frag_col(cb, t, i, l);
                float gd, hd;
                sine3(z[h][t][i] + (c < n ? bm[c] : 0.f), sp, &gd, &hd);
                float d = (scale * ds[h][t][i]) * gd;
#pragma unroll
                for (int k = 0; k < SI; ++k) {
                  const int sl = (1 + k) * kPh + h;
                  const float dt = scale * ds[sl][t][i];
                  d = d + dt * z[sl][t][i] * hd;
                  ds[sl][t][i] = lift<bf16>(dt * gd);
                }
                dz[h][t][i] = d;
                ds[h][t][i] = lift<bf16>(d);
              }
          // the bias grad sums the unrounded value-row dz over the tile's
          // points
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float v = 0.f;
#pragma unroll
              for (int h = 0; h < kPh; ++h) v += dz[h][t][e] + dz[h][t][2 + e];
              const float sum = quad_column_sum(v);
              const int c = frag_col(cb, t, e, l);
              if (l.g == 0 && c < n)
                add_partial(part + o_bh + (long long)m * n + c, old_b[t][e], sum, first);
            }
          store_stack<NSL>(Dp, nullptr, ld, n, cb, l, ds);
        }
        __syncthreads();  // D is complete
        K6_PHASE(4);      // the Z recompute and the backward epilogue
        weight_grad_stack(Sm, Dp, ld, n, n16, TR, part + o_wh + (long long)m * n * n, first, l);
        K6_PHASE(5);  // dW (no barrier: thread 0's own tasks)
        // dS = D @ W_m^T: the cotangent of the app's input streams (a
        // resblock's second app: of its h; its first app adds the skip
        // path's half of the block's cotangent)
        for (int cbl = 0; cbl < n_cb; ++cbl) {
          const int cb = l.warp + kWarps * cbl;
          if (cb >= n16) break;
          stack_mma<NSL, true>(Dp, ld, 0, ws(m), Wm, n, n16, cb, l, ds);
          if (RES && m % 2 == 0) {
            float u[NSL][2][4];
            carry_load<NSL>(carry_slot<NSL>(carry, 0, cbl, n_cb), u);
#pragma unroll
            for (int sl = 0; sl < NSL; ++sl)
#pragma unroll
              for (int t = 0; t < 2; ++t)
#pragma unroll
                for (int i = 0; i < 4; ++i) ds[sl][t][i] = ds[sl][t][i] + 0.5f * u[sl][t][i];
          }
          if (n_cb > 1) carry_store<NSL>(carry_slot<NSL>(carry, 1, cbl, n_cb), ds);
        }
        __syncthreads();  // every read of D and S_m is done
        K6_PHASE(6);      // dS
      }

      // ---- first layer: dz0 = du f'(z0) + sum_k dt_k W0'[k] f''(z0); dW0
      // collects x^T lift(dz0) and the seed rows' dt_k f'(z0), unrounded;
      // db0 the unrounded dz0
      for (int cbl = 0; cbl < n_cb; ++cbl) {
        const int cb = l.warp + kWarps * cbl;
        if (cb >= n16) break;
        if (n_cb > 1) carry_load<NSL>(carry_slot<NSL>(carry, 1, cbl, n_cb), ds);
        // the partials of this thread's columns, all reads in flight at once
        float old_w0[2][2][SI], old_b0[2][2];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = frag_col(cb, t, e, l);
            const bool live = l.g == 0 && c < n;
#pragma unroll
            for (int k = 0; k < SI; ++k)
              old_w0[t][e][k] = partial_before(part + k * n + c, first, live);
            old_b0[t][e] = partial_before(part + o_b0 + c, first, live);
          }
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = frag_col(cb, t, e, l);
            float w0[SI];
#pragma unroll
            for (int k = 0; k < SI; ++k) w0[k] = c < n ? W0f[k * n + c] : 0.f;
            const float b0 = c < n ? B0f[c] : 0.f;
            float dw0[SI], db0 = 0.f;  // the thread's points' sums
#pragma unroll
            for (int k = 0; k < SI; ++k) dw0[k] = 0.f;
#pragma unroll
            for (int h = 0; h < kPh; ++h)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int i = 2 * hh + e;
                const int r = 16 * h + l.g + 8 * hh;
                float xr[SI];
                float z = 0.f;
#pragma unroll
                for (int k = 0; k < SI; ++k) {
                  xr[k] = __bfloat162float(X[r * SI + k]);
                  z = fmaf(xr[k], w0[k], z);
                }
                z += b0;
                float gd, hd;
                sine3(z, sp, &gd, &hd);
                float d = ds[h][t][i] * gd;
                float dk[SI];
#pragma unroll
                for (int k = 0; k < SI; ++k) {
                  const float dt = ds[(1 + k) * kPh + h][t][i];
                  d = d + dt * w0[k] * hd;
                  dk[k] = dt * gd;
                }
                const float dzr = lift<bf16>(d);
#pragma unroll
                for (int k = 0; k < SI; ++k) dw0[k] += fmaf(xr[k], dzr, dk[k]);
                db0 += d;
              }
#pragma unroll
            for (int k = 0; k < SI; ++k) {
              const float sum = quad_column_sum(dw0[k]);
              if (l.g == 0 && c < n) add_partial(part + k * n + c, old_w0[t][e][k], sum, first);
            }
            const float sum = quad_column_sum(db0);
            if (l.g == 0 && c < n) add_partial(part + o_b0 + c, old_b0[t][e], sum, first);
          }
      }
    }

    // the block's two loss partials, after its [G, S, ps] weight grads
    store_loss_partials(loss, LS,
                        a.partials + (long long)a.G * S * a.ps + ((long long)gi * S + s) * 2);
  }
#ifdef K6_PHASE_CLOCKS
  if (threadIdx.x == 0)
    for (int i = 0; i < kPhases; ++i) atomicAdd(&k6_phase_cycles[i], phase_sum[i]);
#endif
}

// Status of a shape: 0 = ok, 2 = even two working planes exceed a block's
// shared memory, 3 = bad shape (or a chain or si the kernel does not take);
// the layout is stack_geometry()'s, over 32-point tiles of 1 + si streams.
// Where the planes are resident and every hidden matrix fits beside them too
// (the flagship: 139 KB of planes and two W of 35 KB), each group's W_m are
// staged once (stage_all) instead of one at a time, twice a tile.
int tc_geometry(int n, int si, int so, int n_mats, int chain, int G, int P, StackGeometry* g,
                int* stage_all) {
  if (n < 1 || si < 1 || si > kMaxSiTc || so < 1 || n_mats < 0 || G < 1 || P < 1 ||
      (chain != kSirenPlain && chain != kSirenResblock) || (chain == kSirenResblock && n_mats % 2))
    return 3;
  const int status = stack_geometry(n, si, so, n_mats, chain, G, P, kTp, (1 + si) * kTp, 2, g);
  const size_t all = g->smem + (size_t)(n_mats - 1) * 2 * g->n16 * 16 * g->ld;
  *stage_all = g->resident && n_mats > 1 && all <= kMaxSmem;
  if (*stage_all) g->smem = all;
  return status;
}

template <int SI, bool RES>
int launch_tc(const StackGeometry& geo, const SobArgs& a, cudaStream_t stream) {
  auto kernel = sob_tc_kernel<SI, RES>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(geo.splits, geo.grid_g), kThreads, geo.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool RES>
int launch_si(int si, const StackGeometry& geo, const SobArgs& a, cudaStream_t stream) {
  switch (si) {
    case 1: return launch_tc<1, RES>(geo, a, stream);
    case 2: return launch_tc<2, RES>(geo, a, stream);
    case 3: return launch_tc<3, RES>(geo, a, stream);
    case 4: return launch_tc<4, RES>(geo, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}


// ---- K5's tangent body in bf16 (fwd_jac_tan_tc_kernel): K6's stacked
// forward without what only its backward needs.
//
// Replaces nif_tpu/ops/pallas_shapenet.py::_fwd_jac_kernel :1375 (reached
// through shapenet_fwd_jac :1459, call :1524, when so >= si; the chain is
// _fwd_jac_layers :1279) for bfloat16 sine chains (plain or resblock) with
// si <= 4 at the widths its geometry takes; float32, vanilla chains and the
// widths it refuses run shapenet_jac.cu's CUDA-core bodies:
//   wb' [G, wb_ld] bf16 (omega_0 folded in by the wrapper; rows padded to 16
//   bytes), x [G, P, si]  ->  y [G, P, so], jac [G, P, so, si] in bf16.
// Its rounding points are K6's forward's: S, the input of each product, is
// stored in bf16; the raw products stay f32 and every epilogue runs in f32
// (act and act' of the bf16 polynomial sine from one range reduction; no
// act''); a resblock's running state stays f32; each output is rounded to
// bf16 once, at its store.
//
// What bounds it on an H100 SXM: operations. At si = so = 3, width 128, two
// hidden layers, G=32, P=32768 its products are 278.9 GFLOP (the value
// stream's x @ W0' and the hidden and last products over all four
// streams), ~0.28 ms at the 989 TFLOP/s bf16 tensor-core peak.
//
// Design (K6's forward, as the tensor-core K7 is K8's):
// - Tiles of kTanTp = 32 points stacked stream-major: row st*32 + r holds
//   stream st of point r, two 16-row mma slabs a stream (eight at si = 3).
//   Warp w owns the 16-column blocks w, w + 8, ... of every product over all
//   slabs, so the tangent product rule (S_tan' = act'(z) Z_tan) runs in
//   registers; every operand comes through ldmatrix from shared memory.
// - Two working planes, ping-ponged: no S residual planes, no Z recompute,
//   no targets, partials or reduce. The registers a thread needs are the
//   accumulators of every slab, 8 (1 + si) 2 f32 (64 at si = 3, 80 at
//   si = 4), beside the epilogue's and the addresses: under the 128 a thread
//   may hold at two 8-warp blocks an SM (kTanBlocksPerSm), so two blocks
//   share an SM where their shared memory fits in half of it. At 64-point
//   tiles the accumulators alone would be 128 at si = 3.
// - Shared memory holds the two planes, the group's hidden W_m (all of them
//   where they fit, staged once a group; else one at a time before its
//   products; else none, read from global memory), W0, the biases and W_last
//   in f32 and the last product. At si = so = 3, width 128, two blocks an SM
//   take 108 KB each: the planes (68 KB), one W_m (34 KB) at a time.
// - The last product (so <= a few columns) runs on the tensor cores too, a
//   slab a warp (last_product_mma).
// - One wave of blocks walks every group's tiles, each block a contiguous
//   run, re-staging the parameters where its run enters a new group. A
//   resblock's f32 running state lives in a per-thread carry in a per-block
//   global scratch. Outputs are per point: two runs give the same bits.

constexpr int kTanTp = 32;          // points of a tile
constexpr int kTanPh = kTanTp / 16;  // 16-row slabs a stream
constexpr int kTanBlocksPerSm = 2;  // blocks per SM where their shared memory allows

struct TanArgs {
  const bf16* wb;          // wb' [G, wb_ld] (rows of po, padded to 16 bytes)
  const bf16* x;           // [G, P, si]
  bf16* y;                 // [G, P, so]
  bf16* jac;               // [G, P, so, si]
  unsigned char* scratch;  // per block: a resblock's f32 running state (the carry)
  int G, P, so, n, n_mats, n16, ld, n_cb, stage_w, stage_all;
  bool deg9;
  long long wb_ld, block_bytes;
};

// Built with -DK5T_PHASE_CLOCKS (by scripts/port_phase_probe.py only), thread
// 0 of every block adds the clock64() cycles from one barrier to the next
// into four phase counters, which split the block's critical path.
#ifdef K5T_PHASE_CLOCKS
constexpr int kTanPhases = 4;
__device__ unsigned long long k5t_phase_cycles[kTanPhases];
#define K5T_PHASE(i)                                       \
  do {                                                     \
    if (threadIdx.x == 0) {                                \
      const long long now = clock64();                     \
      phase_sum[i] += (unsigned long long)(now - phase_t); \
      phase_t = now;                                       \
    }                                                      \
  } while (0)
#else
#define K5T_PHASE(i) \
  do {               \
  } while (0)
#endif

template <int SI, bool RES>
__global__ void __launch_bounds__(kThreads, kTanBlocksPerSm)
    fwd_jac_tan_tc_kernel(const TanArgs a) {
  constexpr int NS = 1 + SI;          // streams
  constexpr int NSL = NS * kTanPh;    // 16-row slabs; slab st*kTanPh + h holds points 16h ..
  constexpr int TR = NS * kTanTp;     // stacked rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, so = a.so, n_mats = a.n_mats, ld = a.ld, n16 = a.n16, n_cb = a.n_cb;
  const SinePoly sp = sine_poly(a.deg9);
  const size_t plane = (size_t)TR * ld;
  const size_t wsz = (size_t)n16 * 16 * ld;  // one staged matrix
  bf16* planes = reinterpret_cast<bf16*>(smem_raw);  // two working planes
  bf16* WS = planes + 2 * plane;  // [16 n16, ld] the staged W_m, or every W_m (stage_all)
  // [TR, so] the last product
  float* O = reinterpret_cast<float*>(WS + (a.stage_w ? (a.stage_all ? n_mats : 1) * wsz : 0));
  float* W0f = O + TR * so;       // [si, n] the group's first layer, f32
  float* B0f = W0f + SI * n;      // [n]
  float* BHf = B0f + n;           // [n_mats, n] hidden biases
  float* WLf = BHf + n_mats * n;  // [n, so] last layer
  float* BLf = WLf + n * so;      // [so]
  bf16* X = reinterpret_cast<bf16*>(BLf + so);  // [kTanTp, si]
  // the weight operand's source in stack_mma for app m
  auto ws = [&](int m) -> const bf16* {
    return a.stage_all ? WS + m * wsz : (a.stage_w ? WS : nullptr);
  };
  // the input plane of app m (m = n_mats: the last product's)
  auto fwd_plane = [&](int m) { return planes + (m & 1) * plane; };
  const Lane l = lane_of_thread();

  const int tpg = (a.P + kTanTp - 1) / kTanTp;  // tiles a group
  const long long total = (long long)a.G * tpg;
  const long long t_begin = blockIdx.x * total / gridDim.x;
  const long long t_end = (blockIdx.x + 1) * total / gridDim.x;
  const long long o_wh = (long long)SI * n;
  const long long o_wl = o_wh + (long long)n_mats * n * n;
  const long long o_b0 = o_wl + (long long)n * so;
  const long long o_bh = o_b0 + n;
  const long long o_bl = o_bh + (long long)n_mats * n;
  float* carry = reinterpret_cast<float*>(a.scratch + (size_t)blockIdx.x * a.block_bytes);
#ifdef K5T_PHASE_CLOCKS
  unsigned long long phase_sum[kTanPhases] = {};
  long long phase_t = clock64();
#endif

  int g_staged = -1;  // the group whose parameters sit in shared memory
  int staged = -1;    // the hidden matrix in WS (one staged at a time)
  for (long long t = t_begin; t < t_end; ++t) {
    const int gi = (int)(t / tpg);
    const int p0 = (int)(t - (long long)gi * tpg) * kTanTp;
    const int rows = min(kTanTp, a.P - p0);
    const long long row0 = (long long)gi * a.P + p0;
    const bf16* wg = a.wb + (long long)gi * a.wb_ld;
    __syncthreads();  // the previous tile is done with X, O, the parameters and W
    K5T_PHASE(3);     // the previous tile's stores (and the group's set-up)
    if (gi != g_staged) {
      for (int i = threadIdx.x; i < SI * n; i += kThreads) W0f[i] = __bfloat162float(wg[i]);
      for (int i = threadIdx.x; i < n; i += kThreads) B0f[i] = __bfloat162float(wg[o_b0 + i]);
      for (int i = threadIdx.x; i < n_mats * n; i += kThreads)
        BHf[i] = __bfloat162float(wg[o_bh + i]);
      for (int i = threadIdx.x; i < n * so; i += kThreads) WLf[i] = __bfloat162float(wg[o_wl + i]);
      for (int i = threadIdx.x; i < so; i += kThreads) BLf[i] = __bfloat162float(wg[o_bl + i]);
      if (a.stage_all)  // every hidden matrix, once a group
        for (int m = 0; m < n_mats; ++m)
          stage_matrix(WS + m * wsz, ld, wg + o_wh + (long long)m * n * n, n, n, n16 * 16,
                       n16 * 16);
      g_staged = gi;
      staged = -1;
    }
    const bf16* xg = a.x + row0 * SI;
    for (int idx = threadIdx.x; idx < kTanTp * SI; idx += kThreads)
      X[idx] = idx < rows * SI ? xg[idx] : __float2bfloat16_rn(0.f);
    cp_async_wait_all();
    __syncthreads();  // X, the parameters and the staged W are in

    // ---- first layer: z0 = x @ W0' + b0; values f(z0), tangent seeds
    // f'(z0) W0'[k]
    for (int cbl = 0; cbl < n_cb; ++cbl) {
      const int cb = l.warp + kWarps * cbl;
      if (cb >= n16) break;
      float v[NSL][2][4];
#pragma unroll
      for (int h = 0; h < kTanPh; ++h)
#pragma unroll
        for (int t2 = 0; t2 < 2; ++t2)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = frag_col(cb, t2, i, l);
            const int r = 16 * h + l.g + 8 * (i >> 1);
            float w0[SI];
            float z = 0.f;
#pragma unroll
            for (int k = 0; k < SI; ++k) {
              w0[k] = c < n ? W0f[k * n + c] : 0.f;
              z = fmaf(__bfloat162float(X[r * SI + k]), w0[k], z);
            }
            z += c < n ? B0f[c] : 0.f;
            float d1, d2;
            v[h][t2][i] = sine3(z, sp, &d1, &d2);
#pragma unroll
            for (int k = 0; k < SI; ++k) v[(1 + k) * kTanPh + h][t2][i] = d1 * w0[k];
          }
      store_stack<NSL>(fwd_plane(0), nullptr, ld, n, cb, l, v);
      if (RES) carry_store<NSL>(carry_slot<NSL>(carry, 0, cbl, n_cb), v);
    }
    __syncthreads();  // S_0 is complete
    K5T_PHASE(0);     // the x tile and the first layer

    // ---- hidden apps: Z = S_m @ W_m on the tensor cores, then the
    // epilogue in registers: new value f(z), tangent f' Z_k (a resblock's h
    // feeds its second matrix as it is; the second app averages with the
    // block's input)
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
      for (int cbl = 0; cbl < n_cb; ++cbl) {
        const int cb = l.warp + kWarps * cbl;
        if (cb >= n16) break;
        float z[NSL][2][4];
        stack_mma<NSL, false>(fwd_plane(m), ld, 0, ws(m), Wm, n, n16, cb, l, z);
#pragma unroll
        for (int h = 0; h < kTanPh; ++h)
#pragma unroll
          for (int t2 = 0; t2 < 2; ++t2)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int c = frag_col(cb, t2, i, l);
              float gd, hd;
              const float av = sine3(z[h][t2][i] + (c < n ? bm[c] : 0.f), sp, &gd, &hd);
#pragma unroll
              for (int k = 0; k < SI; ++k)
                z[(1 + k) * kTanPh + h][t2][i] = gd * z[(1 + k) * kTanPh + h][t2][i];
              z[h][t2][i] = av;
            }
        if (res_second) {
          float u[NSL][2][4];
          float* cs = carry_slot<NSL>(carry, 0, cbl, n_cb);
          carry_load<NSL>(cs, u);
#pragma unroll
          for (int sl = 0; sl < NSL; ++sl)
#pragma unroll
            for (int t2 = 0; t2 < 2; ++t2)
#pragma unroll
              for (int i = 0; i < 4; ++i) z[sl][t2][i] = 0.5f * (u[sl][t2][i] + z[sl][t2][i]);
          carry_store<NSL>(cs, z);
        }
        store_stack<NSL>(fwd_plane(m + 1), nullptr, ld, n, cb, l, z);
      }
      __syncthreads();  // S_{m+1} is complete; every read of S_m is done
    }
    K5T_PHASE(1);  // the hidden forward

    // ---- last product O = S_last @ W_last over all TR rows on the tensor
    // cores, a slab a warp
    last_product_mma(fwd_plane(n_mats), ld, TR, n, n16, WLf, so, O, l);
    __syncthreads();  // O is complete
    K5T_PHASE(2);     // the last product

    // ---- y = O[values] + b_last; jac[r][j][k] = O[tangent k][r][j], each
    // rounded once
    bf16* yg = a.y + row0 * so;
    for (int idx = threadIdx.x; idx < rows * so; idx += kThreads)
      yg[idx] = __float2bfloat16_rn(O[idx] + BLf[idx % so]);
    bf16* jg = a.jac + row0 * so * SI;
    for (int idx = threadIdx.x; idx < rows * so * SI; idx += kThreads) {
      const int r = idx / (so * SI);
      const int rem = idx - r * so * SI;
      const int j = rem / SI;
      const int k = rem - j * SI;
      jg[idx] = __float2bfloat16_rn(O[((1 + k) * kTanTp + r) * so + j]);
    }
  }
#ifdef K5T_PHASE_CLOCKS
  if (threadIdx.x == 0)
    for (int i = 0; i < kTanPhases; ++i) atomicAdd(&k5t_phase_cycles[i], phase_sum[i]);
#endif
}

struct TanGeometry {
  int n16, ld, n_cb, blocks, per_sm, stage_w, stage_all;
  size_t smem, block_bytes;
};

// The layout of K5's tangent body at [G, P] (status: 0 = it fits, 2 = even
// the two working planes exceed a block's shared memory, 3 = a shape, chain
// or si it does not take): two working planes of 32-point tiles; two blocks
// per SM where the planes and one staged W_m fit in half an SM's shared
// memory (kTanBlocksPerSm), else one; then every hidden W_m where they all
// fit (staged once a group), else one at a time, else none (W from global
// memory); W0, the biases, W_last and the last product in f32. A resblock's
// running state is a per-thread f32 carry of every slab's fragment for each
// of a warp's column blocks, in a per-block global scratch. One wave of
// blocks over every group's tiles.
int tan_geometry(int n, int si, int so, int n_mats, int chain, int G, int P, TanGeometry* g) {
  if (n < 1 || si < 1 || si > kMaxSiTc || so < si || n_mats < 0 || G < 1 || P < 1 ||
      (chain != kSirenPlain && chain != kSirenResblock) || (chain == kSirenResblock && n_mats % 2))
    return 3;
  const int tr = (1 + si) * kTanTp;
  g->n16 = round16(n) / 16;
  g->ld = round16(n) + 8;
  g->n_cb = (g->n16 + kWarps - 1) / kWarps;
  const size_t plane = 2 * (size_t)tr * g->ld;
  const size_t wsz = 2 * (size_t)g->n16 * 16 * g->ld;
  const size_t params = (size_t)(si + 1 + n_mats + so) * n + so;
  const size_t base = 2 * plane + 4 * ((size_t)tr * so + params) + 2 * (size_t)kTanTp * si;
  g->per_sm = kTanBlocksPerSm == 2 && base + (n_mats > 0 ? wsz : 0) <= kHalfSmSmem ? 2 : 1;
  const size_t limit = g->per_sm == 2 ? kHalfSmSmem : kMaxSmem;
  g->stage_all = n_mats > 0 && base + (size_t)n_mats * wsz <= limit;
  g->stage_w = g->stage_all || (n_mats > 0 && base + wsz <= limit);
  g->smem = base + (g->stage_all ? n_mats : (g->stage_w ? 1 : 0)) * wsz;
  const size_t carry = chain == kSirenResblock ? 4 * (size_t)g->n_cb * (tr / 16) * 8 * kThreads : 0;
  g->block_bytes = (carry + 15) / 16 * 16;
  const long long tiles = (long long)G * ((P + kTanTp - 1) / kTanTp);
  const long long want = (long long)sm_count() * g->per_sm;
  g->blocks = (int)(tiles < want ? tiles : want);
  return g->smem > kMaxSmem ? 2 : 0;
}

template <int SI, bool RES>
int launch_tan(const TanGeometry& geo, const TanArgs& a, cudaStream_t stream) {
  auto kernel = fwd_jac_tan_tc_kernel<SI, RES>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<geo.blocks, kThreads, geo.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool RES>
int launch_tan_si(int si, const TanGeometry& geo, const TanArgs& a, cudaStream_t stream) {
  switch (si) {
    case 1: return launch_tan<1, RES>(geo, a, stream);
    case 2: return launch_tan<2, RES>(geo, a, stream);
    case 3: return launch_tan<3, RES>(geo, a, stream);
    case 4: return launch_tan<4, RES>(geo, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The geometry of the tensor-core K6 at [G, P] (a status as tc_geometry()
// returns; on 0 and 2 the outputs are written): points per tile, P splits
// per group, dynamic shared memory per block, whether the S planes are
// resident in shared memory, whether W_m is staged there, the f32 partials
// the caller allocates (G*S*ps, ps = po rounded up to even, weight grads,
// then G*S*2 losses) and the bytes of the per-block global scratch (S
// planes when not resident, and the f32 carry).
int nif_shapenet_sobolev_tc_workspace(int n, int si, int so, int n_mats, int chain, int G, int P,
                                      int* tile, int* splits, long long* smem_bytes,
                                      int* resident, int* staged_w, long long* partial_floats,
                                      long long* scratch_bytes) {
  StackGeometry g{};
  int stage_all = 0;
  const int status = tc_geometry(n, si, so, n_mats, chain, G, P, &g, &stage_all);
  if (status == 3) return status;
  const long long po = (long long)n_mats * n * n + (long long)(si + so + 1 + n_mats) * n + so;
  const long long ps = po + (po & 1);
  *tile = kTp;
  *splits = g.splits;
  *smem_bytes = (long long)g.smem;
  *resident = g.resident;
  *staged_w = g.stage_w;
  *partial_floats = (long long)G * g.splits * (ps + 2);
  *scratch_bytes = (long long)g.grid_g * g.splits * (long long)g.block_bytes;
  return status;
}

// K6 in bf16 on the tensor cores (wb', x, target, jt, weight and d_wb are
// bf16; wb' has rows of wb_ld >= po elements, d_wb of po); y_mask, jac_mask
// and weight may be null. chain: kSirenPlain or kSirenResblock; act:
// kSinePoly7 or kSinePoly9 (the bf16 sine). losses receives [value_mse,
// jac_mse]. Returns the CUDA error of the launches (0 on success); the
// kernels run asynchronously on `stream`.
int nif_shapenet_sobolev_grads_tc(const void* wb, const void* x, const void* target,
                                  const void* jt, const void* y_mask, const void* jac_mask,
                                  const void* weight, void* losses, void* d_wb, void* partials,
                                  void* scratch, int G, int P, int si, int so, int n, int n_mats,
                                  int chain, int act, long long po, long long wb_ld,
                                  long long n_scaled, float omega, float ky, float kj, float n_y,
                                  float n_j, void* stream) {
  StackGeometry geo{};
  int stage_all = 0;
  if ((act != kSinePoly7 && act != kSinePoly9) || wb_ld < po ||
      tc_geometry(n, si, so, n_mats, chain, G, P, &geo, &stage_all) != 0)
    return (int)cudaErrorInvalidValue;
  SobArgs a{};
  a.wb = static_cast<const bf16*>(wb);
  a.x = static_cast<const bf16*>(x);
  a.target = static_cast<const bf16*>(target);
  a.jt = static_cast<const bf16*>(jt);
  a.y_mask = static_cast<const float*>(y_mask);
  a.jac_mask = static_cast<const float*>(jac_mask);
  a.weight = static_cast<const bf16*>(weight);
  a.partials = static_cast<float*>(partials);
  a.scratch = static_cast<unsigned char*>(scratch);
  a.ky = ky;
  a.kj = kj;
  a.G = G; a.P = P; a.so = so; a.n = n; a.n_mats = n_mats;
  a.n16 = geo.n16; a.ld = geo.ld; a.n_cb = geo.n_cb; a.resident = geo.resident;
  a.stage_w = geo.stage_w;
  a.stage_all = stage_all;
  a.deg9 = act == kSinePoly9;
  a.po = po;
  a.ps = po + (po & 1);
  a.wb_ld = wb_ld;
  a.block_bytes = (long long)geo.block_bytes;
  a.carry_offset = (long long)geo.carry_offset;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = chain == kSirenResblock ? launch_si<true>(si, geo, a, s)
                                          : launch_si<false>(si, geo, a, s);
  if (err != 0) return err;
  const LossNorms norms{{n_y, n_j}};
  return launch_stack_reduce<2>(a.partials, G, geo.splits, po, n_scaled, omega, 1.f, norms,
                                static_cast<bf16*>(d_wb), static_cast<float*>(losses), s);
}

// The geometry of K5's tensor-core tangent body at [G, P] (a status as
// tan_geometry() returns; on 0 and 2 the outputs are written): points per
// tile, the blocks of its one wave over every group's tiles, blocks per SM,
// dynamic shared memory per block, whether W_m is staged there and the
// bytes of the per-block global scratch (a resblock's f32 carry).
int nif_shapenet_fwd_jac_tan_tc_workspace(int n, int si, int so, int n_mats, int chain, int G,
                                          int P, int* tile, int* blocks, int* blocks_per_sm,
                                          long long* smem_bytes, int* staged_w,
                                          long long* scratch_bytes) {
  TanGeometry g{};
  const int status = tan_geometry(n, si, so, n_mats, chain, G, P, &g);
  if (status == 3) return status;
  *tile = kTanTp;
  *blocks = g.blocks;
  *blocks_per_sm = g.per_sm;
  *smem_bytes = (long long)g.smem;
  *staged_w = g.stage_w;
  *scratch_bytes = (long long)g.blocks * (long long)g.block_bytes;
  return status;
}

// K5's tangent body in bf16 on the tensor cores (so >= si; wb', x, y and
// jac are bf16; wb' has rows of wb_ld >= po elements). chain: kSirenPlain or
// kSirenResblock; act: kSinePoly7 or kSinePoly9 (the bf16 sine). Returns the
// CUDA error of the launch (0 on success); the kernel runs asynchronously
// on `stream`.
int nif_shapenet_fwd_jac_tan_tc(const void* wb, const void* x, void* y, void* jac, void* scratch,
                                int G, int P, int si, int so, int n, int n_mats, int chain,
                                int act, long long po, long long wb_ld, void* stream) {
  TanGeometry geo{};
  if ((act != kSinePoly7 && act != kSinePoly9) || wb_ld < po ||
      tan_geometry(n, si, so, n_mats, chain, G, P, &geo) != 0)
    return (int)cudaErrorInvalidValue;
  TanArgs a{};
  a.wb = static_cast<const bf16*>(wb);
  a.x = static_cast<const bf16*>(x);
  a.y = static_cast<bf16*>(y);
  a.jac = static_cast<bf16*>(jac);
  a.scratch = static_cast<unsigned char*>(scratch);
  a.G = G; a.P = P; a.so = so; a.n = n; a.n_mats = n_mats;
  a.n16 = geo.n16; a.ld = geo.ld; a.n_cb = geo.n_cb;
  a.stage_w = geo.stage_w;
  a.stage_all = geo.stage_all;
  a.deg9 = act == kSinePoly9;
  a.wb_ld = wb_ld;
  a.block_bytes = (long long)geo.block_bytes;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return chain == kSirenResblock ? launch_tan_si<true>(si, geo, a, s)
                                 : launch_tan_si<false>(si, geo, a, s);
}

#ifdef K6_PHASE_CLOCKS
// The phase counters summed over every block since the last call, then
// zeroed (the probe build only).
int nif_sob_tc_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k6_phase_cycles, sizeof(k6_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[kPhases] = {};
  return (int)cudaMemcpyToSymbol(k6_phase_cycles, zero, sizeof(zero));
}
#endif

#ifdef K5T_PHASE_CLOCKS
// K5's tangent-body phase counters summed over every block since the last
// call, then zeroed (the probe build only).
int nif_fwd_jac_tan_tc_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k5t_phase_cycles, sizeof(k5t_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[kTanPhases] = {};
  return (int)cudaMemcpyToSymbol(k5t_phase_cycles, zero, sizeof(zero));
}
#endif

const char* nif_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
