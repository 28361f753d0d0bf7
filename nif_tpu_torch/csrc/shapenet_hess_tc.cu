// K8's and K7's bf16 paths on Hopper's tensor cores: the fused Hessian
// train pass and the fused Hessian evaluation of the grouped ShapeNet chain,
// with every stacked product a warp-level mma.sync.m16n8k16 (bf16 in, f32
// accumulation). K7's kernel (fwd_hess_tc_kernel, below K8's) is K8's
// forward half; its own note follows K8's code.
//
// The bf16 route takes shapenet_hess_wgmma.cu (warpgroup wgmma products fed
// by TMA) wherever that body's geometry takes the chain: si = 3 at widths 64
// and 128, so <= 4, every W_m and both consumers' planes in shared memory
// (the flagship among them). This body keeps the chains it refuses: si 1, 2
// and 4, other widths (24 to 336 at si = 3 with two hidden layers), so
// above 4, and width 128 past two hidden matrices (K8) or four (K7).
//
// K8 replaces nif_tpu/ops/pallas_shapenet.py::_hessian_kernel (reached through
// shapenet_hessian_grads; its backward is _hessian_backward_chain) for
// bfloat16 inputs; float32 stays on shapenet_hess.cu, whose f32 products
// must not round to TF32. What it computes, and where it
// rounds, is shapenet_hess.cu's (see its header): S, the input of each
// product, is stored in bf16; the raw products Z stay f32 and every epilogue
// runs in f32 from Z; the backward's D rows are rounded before their
// products, but the value-row dz that the bias grads sum is not; the first
// layer's dW0 sums the unrounded tangent seed rows; dW_last and dS use the
// rounded D_out; an off-diagonal pair counts twice; the sine is the bf16
// polynomial. Every operand of a product is a bf16 value already, so each
// product is exact and only the order of the f32 sums differs from the
// CUDA-core kernel.
//
// What bounds it on an H100 SXM: operations. At the flagship train shape
// (G=32, P=32768, width 128, two hidden layers, si=3, so=1) its products
// are 2071.2 GFLOP, ~2.1 ms at the 989 TFLOP/s bf16 tensor-core peak.
//
// Design:
// - A tile is 16 points, stacked stream-major: row st*16 + r holds stream st
//   (0 the values, 1 + k the tangents, 1 + si + a the unique pairs) of point
//   r, so each 16-row mma slab is one stream. The flagship's ten streams give
//   160 rows; widths are zero-padded to multiples of 16 and the bf16 planes'
//   rows padded by 8 elements, so ldmatrix is free of bank conflicts.
// - Warp w owns the 16-column blocks w, w + 8, ... of every product, over all
//   slabs. The C fragment is laid out alike in every slab, so a thread holds
//   the same (point, column) of every stream: the forward's new tangents and
//   pairs, the backward's dz and product-rule terms, the bias grads and the
//   whole first layer run in registers, with no f32 plane in shared memory.
//   Both operands come from shared memory through ldmatrix: the stacked
//   plane, and W_m staged whole (cp.async) and kept while the next product
//   uses it. The group's first-layer weights, biases and last layer (f32) and
//   the tile's targets are staged too, so no epilogue waits on a global load.
//   Where W_m does not fit beside the planes, the weight operand comes from
//   global memory, two bf16 a register.
// - The f32 Z of the forward is not kept: the backward recomputes Z_m = S_m
//   @ W_m with the same mma sequence (the same bits), the value and tangent
//   slabs together, then the pairs in small groups, which bounds the
//   registers held beside the incoming cotangent.
// - Residuals: the bf16 S planes of every app and the D plane in shared
//   memory where they fit (the flagship: 174 KB beside the staged W_m's 35),
//   otherwise two working
//   planes, with each S plane written to a per-block global scratch in the
//   forward and copied back (cp.async) before its backward. A resblock's f32
//   running state and its block cotangent, and the cotangents of a warp's
//   further column blocks (widths above 128), live in a per-thread f32 carry
//   in that scratch.
// - Weight grads dW_m = S_m^T D_m: tasks of 16 x 32 outputs over the tile's
//   stacked rows, each added into the block's f32 partial in tile order (the
//   partials loaded before the products, moved in float2 pairs: a block's
//   partial has an even stride, so its dW regions are 8-byte aligned); a
//   split reduce (stack_reduce_kernel, over that stride) sums the partials
//   of each group in a fixed order. No float atomics: two runs on the same
//   inputs give the same bits.
// - The last product and the last layer's grads (so <= a few columns) stay
//   f32 FMAs from shared memory: a thread per output; the last layer's dS
//   lands in the registers of the column blocks' owners.
// The grid is (S, G) with S = SMs / G splits: one wave of one block per SM.
// The tile machinery (the sine, stack_mma, W staging, weight_grad_stack,
// the carry, the geometry and the reduce) is stack_tc.cuh's, shared with the
// tensor-core K6 (shapenet_jac_tc.cu) and K2 (shapenet_bwd_tc.cu); this file
// keeps K8's body and K7's (below), whose forwards share the first layer
// and the hidden epilogues (first_layer_stack, hidden_epilogue,
// res_average).
#include "stack_tc.cuh"

namespace {

constexpr int kTp = 16;            // points of a tile: one 16-row slab per stream
constexpr int kMaxSiTc = 4;

struct TcArgs {
  const bf16* wb;          // wb' [G, wb_ld] (rows of po, padded to 16 bytes)
  const bf16* x;           // [G, P, si]
  const bf16* target;      // [G, P, so]
  const bf16* jt;          // [G, P, si*so], column k*so + j = d y_j / d x_k
  const bf16* ht;          // [G, P, np*so], column a*so + j = d2 y_j / d x_{pair a}
  const float* y_mask;     // [so] 0/1, or null
  const float* jac_mask;   // [si*so] 0/1, or null
  const float* hess_mask;  // [np*so] 0/1, or null
  const bf16* weight;      // [G, P], or null
  float* partials;         // [G, S, ps] weight-grad partials, then [G, S, 3] loss partials
  unsigned char* scratch;  // per block: the S planes (when not resident), then the carry
  float ky, kj, kh;        // 2 w_value / n_y, 2 w_jac / n_j, 2 w_hess / n_h
  int G, P, so, n, n_mats, n16, ld, n_cb, resident, stage_w;
  bool deg9;
  long long po, ps, wb_ld, block_bytes, carry_offset;  // ps: po rounded up to even
};

// Built with -DK8_PHASE_CLOCKS (by scripts/port_phase_probe.py only), thread
// 0 of every block adds the clock64() cycles from one barrier to the next
// into eight phase counters, which split the block's critical path.
#ifdef K8_PHASE_CLOCKS
constexpr int kPhases = 8;
__device__ unsigned long long k8_phase_cycles[kPhases];
#define K8_PHASE(i)                                        \
  do {                                                     \
    if (threadIdx.x == 0) {                                \
      const long long now = clock64();                     \
      phase_sum[i] += (unsigned long long)(now - phase_t); \
      phase_t = now;                                       \
    }                                                      \
  } while (0)
#else
#define K8_PHASE(i) \
  do {              \
  } while (0)
#endif

// The first layer of column block cb in the thread's fragment of every
// stream: z0 = x @ W0' + b0 (f32 FMAs from the tile X and the group's f32
// W0' and b0 in shared memory); the value f(z0), the tangent seeds f'(z0)
// W0'[k] and the pair seeds f''(z0) (W0'[j] W0'[k]). K8's and K7's.
template <int SI, int NS>
__device__ __forceinline__ void first_layer_stack(const bf16* X, const float* W0f,
                                                  const float* B0f, int n, int cb, const Lane& l,
                                                  const SinePoly& sp, float (&v)[NS][2][4]) {
  constexpr int NP = SI * (SI + 1) / 2;
  constexpr int NVT = 1 + SI;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = frag_col(cb, t, i, l);
      const int r = l.g + 8 * (i >> 1);
      float w0[SI];
      float z = 0.f;
#pragma unroll
      for (int k = 0; k < SI; ++k) {
        w0[k] = c < n ? W0f[k * n + c] : 0.f;
        z = fmaf(__bfloat162float(X[r * SI + k]), w0[k], z);
      }
      z += c < n ? B0f[c] : 0.f;
      float d1, d2;
      v[0][t][i] = sine3(z, sp, &d1, &d2);
#pragma unroll
      for (int k = 0; k < SI; ++k) v[1 + k][t][i] = d1 * w0[k];
      static_for<0, NP>([&](auto pc) {
        constexpr int pa = decltype(pc)::value;
        v[NVT + pa][t][i] = d2 * (w0[pair_j(pa, SI)] * w0[pair_k(pa, SI)]);
      });
    }
}

// The forward's epilogue of a hidden app over column block cb, in place on
// the raw products z of every stream: the new value f(z + b), tangent f'
// Z_k, pair f' Z_a + f'' Z_j Z_k. K8's and K7's.
template <int SI, int NS>
__device__ __forceinline__ void hidden_epilogue(const float* bm, int n, int cb, const Lane& l,
                                                const SinePoly& sp, float (&z)[NS][2][4]) {
  constexpr int NP = SI * (SI + 1) / 2;
  constexpr int NVT = 1 + SI;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = frag_col(cb, t, i, l);
      float gd, hd;
      const float av = sine3(z[0][t][i] + (c < n ? bm[c] : 0.f), sp, &gd, &hd);
      static_for<0, NP>([&](auto pc) {
        constexpr int pa = decltype(pc)::value;
        z[NVT + pa][t][i] = gd * z[NVT + pa][t][i] +
                            hd * z[1 + pair_j(pa, SI)][t][i] * z[1 + pair_k(pa, SI)][t][i];
      });
#pragma unroll
      for (int k = 0; k < SI; ++k) z[1 + k][t][i] = gd * z[1 + k][t][i];
      z[0][t][i] = av;
    }
}

// A resblock's second app: z becomes the average with the block's input
// held in the carry slot cs, which then holds it.
template <int NS>
__device__ __forceinline__ void res_average(float* cs, float (&z)[NS][2][4]) {
  float u[NS][2][4];
  carry_load<NS>(cs, u);
#pragma unroll
  for (int st = 0; st < NS; ++st)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) z[st][t][i] = 0.5f * (u[st][t][i] + z[st][t][i]);
  carry_store<NS>(cs, z);
}

template <int SI, bool RES>
__global__ void __launch_bounds__(kThreads, 1) hess_tc_kernel(const TcArgs a) {
  constexpr int NP = SI * (SI + 1) / 2;
  constexpr int NS = 1 + SI + NP;
  constexpr int TR = NS * kTp;
  constexpr int NVT = 1 + SI;                   // value and tangent slabs
  constexpr int PG = NP % 3 == 0 ? 3 : (NP % 2 == 0 ? 2 : 1);  // pair slabs recomputed together
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, so = a.so, n_mats = a.n_mats, ld = a.ld, n16 = a.n16, n_cb = a.n_cb;
  const SinePoly sp = sine_poly(a.deg9);
  const size_t plane = (size_t)TR * ld;
  bf16* planes = reinterpret_cast<bf16*>(smem_raw);  // S planes, then D (resident); 2 working planes otherwise
  const int n_planes = a.resident ? n_mats + 2 : 2;
  bf16* WS = planes + n_planes * plane;  // [16 n16, ld] the staged W_m (when a.stage_w)
  float* O = reinterpret_cast<float*>(WS + (a.stage_w ? (size_t)n16 * 16 * ld : 0));  // [TR, so] last product, then D_out
  float* TT = O + TR * so;        // [TR, so] the tile's value, Jacobian and pair targets
  float* TW = TT + TR * so;       // [kTp] the tile's point weights
  float* LS = TW + kTp;           // [3, kWarps] loss sums
  float* W0f = LS + 3 * kWarps;   // [si, n] the group's first layer, f32
  float* B0f = W0f + SI * n;      // [n]
  float* BHf = B0f + n;           // [n_mats, n] hidden biases
  float* WLf = BHf + n_mats * n;  // [n, so] last layer
  float* BLf = WLf + n * so;      // [so]
  bf16* X = reinterpret_cast<bf16*>(BLf + so);  // [kTp, si]
  bf16* Dp = planes + (a.resident ? (size_t)(n_mats + 1) * plane : plane);
  const bf16* ws = a.stage_w ? WS : nullptr;  // the weight operand's source in stack_mma
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
#ifdef K8_PHASE_CLOCKS
  unsigned long long phase_sum[kPhases] = {};
  long long phase_t = clock64();
#endif

  for (int gi = blockIdx.y; gi < a.G; gi += gridDim.y) {
    const bf16* wg = a.wb + (long long)gi * a.wb_ld;
    float* part = a.partials + ((long long)gi * S + s) * a.ps;
    float loss[3] = {0.f, 0.f, 0.f};  // value, Jacobian, Hessian
    __syncthreads();  // the previous group is done with the staged parameters and W
    for (int i = threadIdx.x; i < SI * n; i += kThreads) W0f[i] = __bfloat162float(wg[i]);
    for (int i = threadIdx.x; i < n; i += kThreads) B0f[i] = __bfloat162float(wg[o_b0 + i]);
    for (int i = threadIdx.x; i < n_mats * n; i += kThreads) BHf[i] = __bfloat162float(wg[o_bh + i]);
    for (int i = threadIdx.x; i < n * so; i += kThreads) WLf[i] = __bfloat162float(wg[o_wl + i]);
    for (int i = threadIdx.x; i < so; i += kThreads) BLf[i] = __bfloat162float(wg[o_bl + i]);
    int staged = -1;  // the hidden matrix in WS
    for (int tile = t_begin; tile < t_end; ++tile) {
      const bool first = tile == t_begin;
      const int p0 = tile * kTp;
      const int rows = min(kTp, a.P - p0);
      const long long row0 = (long long)gi * a.P + p0;
      __syncthreads();  // the previous tile is done with every buffer
      K8_PHASE(7);      // the first layer's backward (and the group's set-up)
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
        const bf16* src = st == 0       ? a.target + p * so + jo
                          : st < NVT    ? a.jt + (p * SI + st - 1) * so + jo
                                        : a.ht + (p * NP + st - NVT) * so + jo;
        TT[idx] = r < rows ? __bfloat162float(*src) : 0.f;
      }
      for (int r = threadIdx.x; r < kTp; r += kThreads)
        TW[r] = r < rows && a.weight ? __bfloat162float(a.weight[row0 + r]) : 1.f;
      __syncthreads();

      // ---- first layer: z0 = x @ W0' + b0; values f(z0), tangent seeds
      // f'(z0) W0'[k], pair seeds f''(z0) (W0'[j] W0'[k])
      for (int cbl = 0; cbl < n_cb; ++cbl) {
        const int cb = l.warp + kWarps * cbl;
        if (cb >= n16) break;
        float v[NS][2][4];
        first_layer_stack<SI>(X, W0f, B0f, n, cb, l, sp, v);
        store_stack<NS>(fwd_plane(0), n_mats > 0 ? gplanes : nullptr, ld, n, cb, l, v);
        if (RES) carry_store<NS>(carry_slot<NS>(carry, 0, cbl, n_cb), v);
      }
      __syncthreads();  // S_0 is complete
      K8_PHASE(0);      // the x tile and the first layer

      // ---- hidden apps: Z = S_m @ W_m on the tensor cores, then the
      // epilogue in registers: new value f(z), tangent f' Z_k, pair f' Z_a +
      // f'' Z_j Z_k (a resblock's h feeds its second matrix as it is; the
      // second app averages with the block's input)
      for (int m = 0; m < n_mats; ++m) {
        const bool res_second = RES && m % 2 == 1;
        const bf16* Wm = wg + o_wh + (long long)m * n * n;
        const float* bm = BHf + m * n;
        if (a.stage_w && staged != m) {  // every read of the previous W is done
          stage_matrix(WS, ld, Wm, n, n, n16 * 16, n16 * 16);
          staged = m;
          cp_async_wait_all();
          __syncthreads();
        }
        bf16* copy = !a.resident && m + 1 < n_mats ? gplanes + (size_t)(m + 1) * plane : nullptr;
        for (int cbl = 0; cbl < n_cb; ++cbl) {
          const int cb = l.warp + kWarps * cbl;
          if (cb >= n16) break;
          float z[NS][2][4];
          stack_mma<NS, false>(fwd_plane(m), ld, 0, ws, Wm, n, n16, cb, l, z);
          hidden_epilogue<SI>(bm, n, cb, l, sp, z);
          if (res_second) res_average<NS>(carry_slot<NS>(carry, 0, cbl, n_cb), z);
          store_stack<NS>(fwd_plane(m + 1), copy, ld, n, cb, l, z);
        }
        __syncthreads();  // S_{m+1} is complete; every read of S_m is done
      }
      K8_PHASE(1);  // the hidden forward

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

      // ---- loss: err = mask (out - t), e = mask (O_stream - target); sums
      // w err^2 (a pair's times its multiplicity); D_out = [ky w err; kj w
      // e_k; kh mult w e_a] in place of O
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
        for (int pa = 0; pa < NP; ++pa) {
          const int o = ((NVT + pa) * kTp + r) * so + jo;
          const float mult = pair_j(pa, SI) == pair_k(pa, SI) ? 1.f : 2.f;
          float dh = 0.f;
          if (live) {
            float e = O[o] - TT[o];
            if (a.hess_mask) e = e * a.hess_mask[pa * so + jo];
            loss[2] += mult * (e * e * w);
            dh = (a.kh * mult) * e * w;
          }
          O[o] = dh;
        }
      }
      __syncthreads();  // D_out is complete
      K8_PHASE(2);      // the last product and the loss

      // ---- last layer: dW_l = S_last^T lift(D_out), db_l = the value rows'
      // sum of D_out, and dS = lift(D_out) @ W_l^T into the registers of the
      // column blocks' owners
      for (int idx = threadIdx.x; idx < n * so; idx += kThreads) {
        const int k = idx / so;
        const int j = idx - k * so;
        float sum = 0.f;
        for (int rr = 0; rr < TR; ++rr)
          sum = fmaf(__bfloat162float(Sl[rr * ld + k]), lift<bf16>(O[rr * so + j]), sum);
        accumulate(part + o_wl + idx, sum, first);
      }
      for (int j = threadIdx.x; j < so; j += kThreads) {
        float sum = 0.f;
        for (int r = 0; r < kTp; ++r) sum += O[r * so + j];
        accumulate(part + o_bl + j, sum, first);
      }
      float ds[NS][2][4];  // the cotangent of the current app's output streams
      for (int cbl = 0; cbl < n_cb; ++cbl) {
        const int cb = l.warp + kWarps * cbl;
        if (cb >= n16) break;
#pragma unroll
        for (int st = 0; st < NS; ++st)
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int i = 0; i < 4; ++i) ds[st][t][i] = 0.f;
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
          for (int st = 0; st < NS; ++st)
#pragma unroll
            for (int t = 0; t < 2; ++t)
#pragma unroll
              for (int i = 0; i < 4; ++i)
                ds[st][t][i] = fmaf(lift<bf16>(O[(st * kTp + l.g + 8 * (i >> 1)) * so + j]),
                                    wlj[t][i & 1], ds[st][t][i]);
        }
        if (n_cb > 1) carry_store<NS>(carry_slot<NS>(carry, 1, cbl, n_cb), ds);
      }
      __syncthreads();  // every read of S_last is done
      K8_PHASE(3);      // the last layer's backward

      // ---- hidden apps, last to first
      for (int m = n_mats - 1; m >= 0; --m) {
        const bool res_second = RES && m % 2 == 1;
        const float scale = res_second ? 0.5f : 1.f;
        const bf16* Wm = wg + o_wh + (long long)m * n * n;
        const float* bm = BHf + m * n;
        bf16* Sm = bwd_plane(m);
        const bool stage = a.stage_w && staged != m;
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
        // with du, dt_k, dh_a the scaled cotangents of the app's output
        // streams: dz = du f' + sum_k dt_k Z_k f'' + sum_a dh_a (Z_a f'' +
        // Z_j Z_k f'''); D = [dz; dt_k f' + the pairs' product-rule terms;
        // dh_a f'], each rounded to bf16
        for (int cbl = 0; cbl < n_cb; ++cbl) {
          const int cb = l.warp + kWarps * cbl;
          if (cb >= n16) break;
          if (n_cb > 1) carry_load<NS>(carry_slot<NS>(carry, 1, cbl, n_cb), ds);
          if (res_second) carry_store<NS>(carry_slot<NS>(carry, 0, cbl, n_cb), ds);
          float zvt[NVT][2][4];
          stack_mma<NVT, false>(Sm, ld, 0, ws, Wm, n, n16, cb, l, zvt);
          float gdv[2][4], hdv[2][4], qdv[2][4], dz[2][4];
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int c = frag_col(cb, t, i, l);
              sine_d123(zvt[0][t][i] + (c < n ? bm[c] : 0.f), sp, &gdv[t][i],
                        &hdv[t][i], &qdv[t][i]);
              float d = (scale * ds[0][t][i]) * gdv[t][i];
#pragma unroll
              for (int k = 0; k < SI; ++k) {
                const float dt = scale * ds[1 + k][t][i];
                d = d + dt * zvt[1 + k][t][i] * hdv[t][i];
                ds[1 + k][t][i] = dt * gdv[t][i];
              }
              dz[t][i] = d;
            }
          static_for<0, NP / PG>([&](auto gc) {
            float za[PG][2][4];
            stack_mma<PG, false>(Sm, ld, NVT + decltype(gc)::value * PG, ws, Wm, n, n16, cb, l,
                                 za);
            static_for<0, PG>([&](auto pc) {
              constexpr int p = decltype(pc)::value;
              constexpr int pa = decltype(gc)::value * PG + p;
              constexpr int j = pair_j(pa, SI), k = pair_k(pa, SI);
#pragma unroll
              for (int t = 0; t < 2; ++t)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const float hd = hdv[t][i];
                  const float dh = scale * ds[NVT + pa][t][i];
                  dz[t][i] = dz[t][i] + dh * (za[p][t][i] * hd +
                                              zvt[1 + j][t][i] * zvt[1 + k][t][i] * qdv[t][i]);
                  ds[NVT + pa][t][i] = lift<bf16>(dh * gdv[t][i]);
                  if constexpr (j == k) {
                    ds[1 + j][t][i] = ds[1 + j][t][i] + 2.f * dh * hd * zvt[1 + j][t][i];
                  } else {
                    ds[1 + j][t][i] = ds[1 + j][t][i] + dh * hd * zvt[1 + k][t][i];
                    ds[1 + k][t][i] = ds[1 + k][t][i] + dh * hd * zvt[1 + j][t][i];
                  }
                }
            });
          });
          // D's tangent and value rows rounded; the bias grad sums the
          // unrounded value-row dz over the tile's points
#pragma unroll
          for (int t = 0; t < 2; ++t) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
              for (int k = 0; k < SI; ++k) ds[1 + k][t][i] = lift<bf16>(ds[1 + k][t][i]);
              ds[0][t][i] = lift<bf16>(dz[t][i]);
            }
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float sum = column_sum(dz[t][e], dz[t][2 + e]);
              const int c = frag_col(cb, t, e, l);
              if (l.g == 0 && c < n) accumulate(part + o_bh + (long long)m * n + c, sum, first);
            }
          }
          store_stack<NS>(Dp, nullptr, ld, n, cb, l, ds);
        }
        __syncthreads();  // D is complete
        K8_PHASE(4);      // the Z recompute and the backward epilogue
        weight_grad_stack(Sm, Dp, ld, n, n16, TR, part + o_wh + (long long)m * n * n, first, l);
        K8_PHASE(5);  // dW (no barrier: thread 0's own tasks)
        // dS = D @ W_m^T: the cotangent of the app's input streams (a
        // resblock's second app: of its h; its first app adds the skip
        // path's half of the block's cotangent)
        for (int cbl = 0; cbl < n_cb; ++cbl) {
          const int cb = l.warp + kWarps * cbl;
          if (cb >= n16) break;
          stack_mma<NS, true>(Dp, ld, 0, ws, Wm, n, n16, cb, l, ds);
          if (RES && m % 2 == 0) {
            float u[NS][2][4];
            carry_load<NS>(carry_slot<NS>(carry, 0, cbl, n_cb), u);
#pragma unroll
            for (int st = 0; st < NS; ++st)
#pragma unroll
              for (int t = 0; t < 2; ++t)
#pragma unroll
                for (int i = 0; i < 4; ++i) ds[st][t][i] = ds[st][t][i] + 0.5f * u[st][t][i];
          }
          if (n_cb > 1) carry_store<NS>(carry_slot<NS>(carry, 1, cbl, n_cb), ds);
        }
        __syncthreads();  // every read of D and S_m is done
        K8_PHASE(6);      // dS
      }

      // ---- first layer: dz0 = du f'(z0) + sum_k dt_k W0'[k] f''(z0) + sum_a
      // dh_a (W0'[j] W0'[k]) f'''(z0); dW0 collects x^T lift(dz0) and the
      // seed rows' dt_k f'(z0) and the pairs' dh_a f''(z0) W0'[the other
      // index], unrounded; db0 the unrounded dz0
      for (int cbl = 0; cbl < n_cb; ++cbl) {
        const int cb = l.warp + kWarps * cbl;
        if (cb >= n16) break;
        if (n_cb > 1) carry_load<NS>(carry_slot<NS>(carry, 1, cbl, n_cb), ds);
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = frag_col(cb, t, e, l);
            float w0[SI];
#pragma unroll
            for (int k = 0; k < SI; ++k) w0[k] = c < n ? W0f[k * n + c] : 0.f;
            const float b0 = c < n ? B0f[c] : 0.f;
            float dzh[2], dkh[2][SI], xh[2][SI];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 2 * h + e;
              const int r = l.g + 8 * h;
              float z = 0.f;
#pragma unroll
              for (int k = 0; k < SI; ++k) {
                xh[h][k] = __bfloat162float(X[r * SI + k]);
                z = fmaf(xh[h][k], w0[k], z);
              }
              z += b0;
              float gd, hd, qd;
              sine_d123(z, sp, &gd, &hd, &qd);
              float d = ds[0][t][i] * gd;
#pragma unroll
              for (int k = 0; k < SI; ++k) {
                const float dt = ds[1 + k][t][i];
                d = d + dt * w0[k] * hd;
                dkh[h][k] = dt * gd;
              }
              static_for<0, NP>([&](auto pc) {
                constexpr int pa = decltype(pc)::value;
                constexpr int j = pair_j(pa, SI), k = pair_k(pa, SI);
                const float dh = ds[NVT + pa][t][i];
                d = d + dh * (w0[j] * w0[k]) * qd;
                if constexpr (j == k) {
                  dkh[h][j] = dkh[h][j] + 2.f * (dh * hd * w0[j]);
                } else {
                  dkh[h][j] = dkh[h][j] + dh * hd * w0[k];
                  dkh[h][k] = dkh[h][k] + dh * hd * w0[j];
                }
              });
              dzh[h] = d;
            }
            const float dz0 = lift<bf16>(dzh[0]), dz1 = lift<bf16>(dzh[1]);
#pragma unroll
            for (int k = 0; k < SI; ++k) {
              const float sum = column_sum(fmaf(xh[0][k], dz0, dkh[0][k]),
                                           fmaf(xh[1][k], dz1, dkh[1][k]));
              if (l.g == 0 && c < n) accumulate(part + k * n + c, sum, first);
            }
            const float sum = column_sum(dzh[0], dzh[1]);
            if (l.g == 0 && c < n) accumulate(part + o_b0 + c, sum, first);
          }
      }
    }

    // the block's three loss partials, after its [G, S, po] weight grads
    store_loss_partials(loss, LS, a.partials + (long long)a.G * S * a.ps + ((long long)gi * S + s) * 3);
  }
#ifdef K8_PHASE_CLOCKS
  if (threadIdx.x == 0)
    for (int i = 0; i < kPhases; ++i) atomicAdd(&k8_phase_cycles[i], phase_sum[i]);
#endif
}


// Status of a shape: 0 = ok, 2 = even two working planes exceed a block's
// shared memory, 3 = bad shape (or a chain or si the kernel does not take);
// the layout is stack_geometry()'s, over 16-point tiles of ten streams at
// si = 3.
int tc_geometry(int n, int si, int so, int n_mats, int chain, int G, int P, StackGeometry* g) {
  if (n < 1 || si < 1 || si > kMaxSiTc || so < 1 || n_mats < 0 || G < 1 || P < 1 ||
      (chain != kSirenPlain && chain != kSirenResblock) || (chain == kSirenResblock && n_mats % 2))
    return 3;
  const int ns = 1 + si + si * (si + 1) / 2;
  return stack_geometry(n, si, so, n_mats, chain, G, P, kTp, ns * kTp, 3, g);
}

template <int SI, bool RES>
int launch_tc(const StackGeometry& geo, const TcArgs& a, cudaStream_t stream) {
  auto kernel = hess_tc_kernel<SI, RES>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(geo.splits, geo.grid_g), kThreads, geo.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool RES>
int launch_si(int si, const StackGeometry& geo, const TcArgs& a, cudaStream_t stream) {
  switch (si) {
    case 1: return launch_tc<1, RES>(geo, a, stream);
    case 2: return launch_tc<2, RES>(geo, a, stream);
    case 3: return launch_tc<3, RES>(geo, a, stream);
    case 4: return launch_tc<4, RES>(geo, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// ---------------------------------------------------------------------- K7
// K7's bf16 path: replaces nif_tpu/ops/pallas_shapenet.py::_fwd_hess_kernel
// (reached through shapenet_fwd_hess; the chain is _hess_fwd_layers) for
// bfloat16 inputs: wb' [G, po] and x [G, P, si] -> y [G, P, so], jac [G, P,
// so, si] and the unique-pair columns hp [G, P, so, np], in bf16; the
// wrapper mirrors hp into the symmetric Hessian. float32 stays on
// shapenet_hess.cu, whose f32 products must not round to TF32. It rounds
// where that kernel rounds: S, the input of each product, is stored in bf16;
// the raw products Z and a resblock's running state U stay f32 and every
// epilogue runs in f32 from Z; the sine is the bf16 polynomial (act',
// act'', no act'''), its coefficients chosen once (stack_tc.cuh's
// SinePoly: no evaluation branches on the degree); each output is rounded
// once, at its store.
//
// What bounds it on an H100 SXM: operations. At the flagship evaluation
// shape (G=32, P=32768, width 128, two hidden layers, si=3, so=1) its
// products are 690.7 GFLOP, ~0.70 ms at the 989 TFLOP/s bf16 tensor-core
// peak.
//
// Design: K8's forward (hess_tc_kernel above) without what only the
// backward needs: no S residual planes (two working planes, ping-ponged),
// no Z recompute, no targets, partials or reduce. Tiles of 16 points stacked
// stream-major (ten slabs at si = 3); warp w owns the column blocks w, w +
// 8, ... of every product over all slabs, so the tangent and pair product
// rules run in registers. 16 points, not 32: at 32 the flagship's twenty
// slabs put 160 f32 accumulators in each thread beside the epilogue's and
// the addresses (a spill at 255 registers is near), and si = 4's thirty
// slabs would both spill and need two planes of 480 x 136 bf16 (261 KB, more
// than a block's 227); two blocks of 16-point tiles per SM would leave 128
// registers and ~113 KB each, too few for the ten slabs' accumulators and W.
// So one 8-warp block per SM, and 16-point tiles take every si <= 4 at the
// widths K8's do. Shared memory holds the two planes, the group's hidden
// W_m (all of them, staged once a group, where they fit: the flagship's two
// planes of 160 x 136 bf16 and two W of 35 KB are 157 KB; otherwise one at
// a time, or none, read from global memory), W0, the biases and W_last in
// f32, and the last product. A resblock's f32 running state lives in a
// per-thread carry in a per-block global scratch. The last product (so <=
// a few columns) runs on the tensor cores too, a slab a warp
// (last_product_mma). The grid is (S, G) with S = SMs / G splits: one wave
// of one block per SM.

namespace {

struct EvalArgs {
  const bf16* wb;          // wb' [G, wb_ld] (rows of po, padded to 16 bytes)
  const bf16* x;           // [G, P, si]
  bf16* y;                 // [G, P, so]
  bf16* jac;               // [G, P, so, si]
  bf16* hp;                // [G, P, so, np], the unique pairs
  unsigned char* scratch;  // per block: a resblock's f32 running state (the carry)
  int G, P, so, n, n_mats, n16, ld, n_cb, stage_w, stage_all;
  bool deg9;
  long long wb_ld, block_bytes;
};

// Built with -DK7_PHASE_CLOCKS (by scripts/port_phase_probe.py only), thread
// 0 of every block adds the clock64() cycles from one barrier to the next
// into four phase counters, which split the block's critical path.
#ifdef K7_PHASE_CLOCKS
constexpr int kEvalPhases = 4;
__device__ unsigned long long k7_phase_cycles[kEvalPhases];
#define K7_PHASE(i)                                        \
  do {                                                     \
    if (threadIdx.x == 0) {                                \
      const long long now = clock64();                     \
      phase_sum[i] += (unsigned long long)(now - phase_t); \
      phase_t = now;                                       \
    }                                                      \
  } while (0)
#else
#define K7_PHASE(i) \
  do {              \
  } while (0)
#endif

template <int SI, bool RES>
__global__ void __launch_bounds__(kThreads, 1) fwd_hess_tc_kernel(const EvalArgs a) {
  constexpr int NP = SI * (SI + 1) / 2;
  constexpr int NS = 1 + SI + NP;
  constexpr int TR = NS * kTp;
  constexpr int NVT = 1 + SI;  // value and tangent slabs
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
  bf16* X = reinterpret_cast<bf16*>(BLf + so);  // [kTp, si]
  // the weight operand's source in stack_mma for app m
  auto ws = [&](int m) -> const bf16* {
    return a.stage_all ? WS + m * wsz : (a.stage_w ? WS : nullptr);
  };
  // the input plane of app m (m = n_mats: the last product's)
  auto fwd_plane = [&](int m) { return planes + (m & 1) * plane; };
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
  float* carry = reinterpret_cast<float*>(
      a.scratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * a.block_bytes);
#ifdef K7_PHASE_CLOCKS
  unsigned long long phase_sum[kEvalPhases] = {};
  long long phase_t = clock64();
#endif

  for (int gi = blockIdx.y; gi < a.G; gi += gridDim.y) {
    const bf16* wg = a.wb + (long long)gi * a.wb_ld;
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
      const int p0 = tile * kTp;
      const int rows = min(kTp, a.P - p0);
      const long long row0 = (long long)gi * a.P + p0;
      __syncthreads();  // the previous tile is done with X and O
      K7_PHASE(3);      // the previous tile's stores (and the group's set-up)
      const bf16* xg = a.x + row0 * SI;
      for (int idx = threadIdx.x; idx < kTp * SI; idx += kThreads)
        X[idx] = idx < rows * SI ? xg[idx] : __float2bfloat16_rn(0.f);
      __syncthreads();

      // ---- first layer: z0 = x @ W0' + b0; values f(z0), tangent seeds
      // f'(z0) W0'[k], pair seeds f''(z0) (W0'[j] W0'[k])
      for (int cbl = 0; cbl < n_cb; ++cbl) {
        const int cb = l.warp + kWarps * cbl;
        if (cb >= n16) break;
        float v[NS][2][4];
        first_layer_stack<SI>(X, W0f, B0f, n, cb, l, sp, v);
        store_stack<NS>(fwd_plane(0), nullptr, ld, n, cb, l, v);
        if (RES) carry_store<NS>(carry_slot<NS>(carry, 0, cbl, n_cb), v);
      }
      __syncthreads();  // S_0 is complete
      K7_PHASE(0);      // the x tile and the first layer

      // ---- hidden apps: Z = S_m @ W_m on the tensor cores, then the
      // epilogue in registers: new value f(z), tangent f' Z_k, pair f' Z_a +
      // f'' Z_j Z_k (a resblock's h feeds its second matrix as it is; the
      // second app averages with the block's input)
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
          float z[NS][2][4];
          stack_mma<NS, false>(fwd_plane(m), ld, 0, ws(m), Wm, n, n16, cb, l, z);
          hidden_epilogue<SI>(bm, n, cb, l, sp, z);
          if (res_second) res_average<NS>(carry_slot<NS>(carry, 0, cbl, n_cb), z);
          store_stack<NS>(fwd_plane(m + 1), nullptr, ld, n, cb, l, z);
        }
        __syncthreads();  // S_{m+1} is complete; every read of S_m is done
      }
      K7_PHASE(1);  // the hidden forward

      // ---- last product O = S_last @ W_last over all TR rows on the tensor
      // cores, a slab a warp
      last_product_mma(fwd_plane(n_mats), ld, TR, n, n16, WLf, so, O, l);
      __syncthreads();  // O is complete
      K7_PHASE(2);      // the last product

      // ---- y = O[values] + b_last; jac[r][j][k] = O[tangent k][r][j];
      // hp[r][j][a] = O[pair a][r][j], each rounded once
      bf16* yg = a.y + row0 * so;
      for (int idx = threadIdx.x; idx < rows * so; idx += kThreads)
        yg[idx] = __float2bfloat16_rn(O[idx] + BLf[idx % so]);
      bf16* jg = a.jac + row0 * so * SI;
      for (int idx = threadIdx.x; idx < rows * so * SI; idx += kThreads) {
        const int r = idx / (so * SI);
        const int rem = idx - r * so * SI;
        const int j = rem / SI;
        const int k = rem - j * SI;
        jg[idx] = __float2bfloat16_rn(O[((1 + k) * kTp + r) * so + j]);
      }
      bf16* hg = a.hp + row0 * so * NP;
      for (int idx = threadIdx.x; idx < rows * so * NP; idx += kThreads) {
        const int r = idx / (so * NP);
        const int rem = idx - r * so * NP;
        const int j = rem / NP;
        const int pa = rem - j * NP;
        hg[idx] = __float2bfloat16_rn(O[((NVT + pa) * kTp + r) * so + j]);
      }
    }
  }
#ifdef K7_PHASE_CLOCKS
  if (threadIdx.x == 0)
    for (int i = 0; i < kEvalPhases; ++i) atomicAdd(&k7_phase_cycles[i], phase_sum[i]);
#endif
}

struct EvalGeometry {
  int n16, ld, n_cb, splits, grid_g, stage_w, stage_all;
  size_t smem, block_bytes;
};

// K7's layout at [G, P] (status: 0 = it fits, 2 = even the two working
// planes exceed a block's shared memory, 3 = a shape, chain or si it does
// not take): two working planes of 16-point tiles, then every hidden W_m
// where they all fit beside them (staged once a group), else one at a time,
// else none (W from global memory); W0, the biases, W_last and the last
// product in f32. A resblock's running state is a per-thread f32 carry of
// every slab's fragment for each of a warp's column blocks, in a per-block
// global scratch. The grid is (S, G) with S = SMs / G splits, as K8's.
int eval_geometry(int n, int si, int so, int n_mats, int chain, int G, int P, EvalGeometry* g) {
  if (n < 1 || si < 1 || si > kMaxSiTc || so < 1 || n_mats < 0 || G < 1 || P < 1 ||
      (chain != kSirenPlain && chain != kSirenResblock) || (chain == kSirenResblock && n_mats % 2))
    return 3;
  const int ns = 1 + si + si * (si + 1) / 2;
  const int tr = ns * kTp;
  g->n16 = round16(n) / 16;
  g->ld = round16(n) + 8;
  g->n_cb = (g->n16 + kWarps - 1) / kWarps;
  const size_t plane = 2 * (size_t)tr * g->ld;
  const size_t wsz = 2 * (size_t)g->n16 * 16 * g->ld;
  const size_t params = (size_t)(si + 1 + n_mats + so) * n + so;
  const size_t base = 2 * plane + 4 * ((size_t)tr * so + params) + 2 * (size_t)kTp * si;
  g->stage_all = n_mats > 0 && base + (size_t)n_mats * wsz <= kMaxSmem;
  g->stage_w = g->stage_all || (n_mats > 0 && base + wsz <= kMaxSmem);
  g->smem = base + (g->stage_all ? n_mats : (g->stage_w ? 1 : 0)) * wsz;
  const size_t carry = chain == kSirenResblock ? 4 * (size_t)g->n_cb * ns * 8 * kThreads : 0;
  g->block_bytes = (carry + 15) / 16 * 16;
  const int n_tiles = (P + kTp - 1) / kTp;
  const int sms = sm_count();
  int splits = sms > G ? sms / G : 1;
  splits = splits < kMaxStackSplits ? splits : kMaxStackSplits;
  g->splits = splits < n_tiles ? splits : n_tiles;
  g->grid_g = G < 65535 ? G : 65535;
  return g->smem > kMaxSmem ? 2 : 0;
}

template <int SI, bool RES>
int launch_eval(const EvalGeometry& geo, const EvalArgs& a, cudaStream_t stream) {
  auto kernel = fwd_hess_tc_kernel<SI, RES>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(geo.splits, geo.grid_g), kThreads, geo.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool RES>
int launch_eval_si(int si, const EvalGeometry& geo, const EvalArgs& a, cudaStream_t stream) {
  switch (si) {
    case 1: return launch_eval<1, RES>(geo, a, stream);
    case 2: return launch_eval<2, RES>(geo, a, stream);
    case 3: return launch_eval<3, RES>(geo, a, stream);
    case 4: return launch_eval<4, RES>(geo, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The geometry of the tensor-core K8 at [G, P] (a status as tc_geometry()
// returns; on 0 and 2 the outputs are written): points per tile, P splits
// per group, dynamic shared memory per block, whether the S planes are
// resident in shared memory, whether W_m is staged there, the f32 partials
// the caller allocates (G*S*ps, ps = po rounded up to even,
// weight grads, then G*S*3 losses) and the bytes of the per-block global
// scratch (S planes when not resident, and the f32 carry).
int nif_shapenet_hess_tc_workspace(int n, int si, int so, int n_mats, int chain, int G, int P,
                                   int* tile, int* splits, long long* smem_bytes, int* resident,
                                   int* staged_w, long long* partial_floats,
                                   long long* scratch_bytes) {
  StackGeometry g{};
  const int status = tc_geometry(n, si, so, n_mats, chain, G, P, &g);
  if (status == 3) return status;
  const long long po = (long long)n_mats * n * n + (long long)(si + so + 1 + n_mats) * n + so;
  const long long ps = po + (po & 1);
  *tile = kTp;
  *splits = g.splits;
  *smem_bytes = (long long)g.smem;
  *resident = g.resident;
  *staged_w = g.stage_w;
  *partial_floats = (long long)G * g.splits * (ps + 3);
  *scratch_bytes = (long long)g.grid_g * g.splits * (long long)g.block_bytes;
  return status;
}

// K8 in bf16 on the tensor cores (wb', x, target, jt, ht, weight and d_wb are
// bf16; wb' has rows of wb_ld >= po elements, d_wb of po); y_mask,
// jac_mask, hess_mask and weight may be null. chain:
// kSirenPlain or kSirenResblock; act: kSinePoly7 or kSinePoly9 (the bf16
// sine). losses receives [value_mse, jac_mse, hess_mse]. Returns the CUDA
// error of the launches (0 on success); the kernels run asynchronously on
// `stream`.
int nif_shapenet_hessian_grads_tc(const void* wb, const void* x, const void* target,
                                  const void* jt, const void* ht, const void* y_mask,
                                  const void* jac_mask, const void* hess_mask, const void* weight,
                                  void* losses, void* d_wb, void* partials, void* scratch, int G,
                                  int P, int si, int so, int n, int n_mats, int chain, int act,
                                  long long po, long long wb_ld, long long n_scaled, float omega,
                                  float ky, float kj, float kh, float n_y, float n_j, float n_h,
                                  void* stream) {
  StackGeometry geo{};
  if ((act != kSinePoly7 && act != kSinePoly9) || wb_ld < po ||
      tc_geometry(n, si, so, n_mats, chain, G, P, &geo) != 0)
    return (int)cudaErrorInvalidValue;
  TcArgs a{};
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
  a.scratch = static_cast<unsigned char*>(scratch);
  a.ky = ky;
  a.kj = kj;
  a.kh = kh;
  a.G = G; a.P = P; a.so = so; a.n = n; a.n_mats = n_mats;
  a.n16 = geo.n16; a.ld = geo.ld; a.n_cb = geo.n_cb; a.resident = geo.resident;
  a.stage_w = geo.stage_w;
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
  const LossNorms norms{{n_y, n_j, n_h}};
  return launch_stack_reduce<3>(a.partials, G, geo.splits, po, n_scaled, omega, 1.f, norms,
                                static_cast<bf16*>(d_wb), static_cast<float*>(losses), s);
}

#ifdef K8_PHASE_CLOCKS
// The phase counters summed over every block since the last call, then
// zeroed (the probe build only).
int nif_hess_tc_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k8_phase_cycles, sizeof(k8_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[kPhases] = {};
  return (int)cudaMemcpyToSymbol(k8_phase_cycles, zero, sizeof(zero));
}
#endif

// The geometry of the tensor-core K7 at [G, P] (a status as eval_geometry()
// returns; on 0 and 2 the outputs are written), in the layout of K8's entry:
// points per tile, P splits per group, dynamic shared memory per block, 1
// (the working planes are always in shared memory), whether W_m is staged
// there, 0 partials (K7 reduces nothing) and the bytes of the per-block
// global scratch (a resblock's f32 carry).
int nif_shapenet_fwd_hess_tc_workspace(int n, int si, int so, int n_mats, int chain, int G,
                                       int P, int* tile, int* splits, long long* smem_bytes,
                                       int* resident, int* staged_w, long long* partial_floats,
                                       long long* scratch_bytes) {
  EvalGeometry g{};
  const int status = eval_geometry(n, si, so, n_mats, chain, G, P, &g);
  if (status == 3) return status;
  *tile = kTp;
  *splits = g.splits;
  *smem_bytes = (long long)g.smem;
  *resident = 1;
  *staged_w = g.stage_w;
  *partial_floats = 0;
  *scratch_bytes = (long long)g.grid_g * g.splits * (long long)g.block_bytes;
  return status;
}

// K7 in bf16 on the tensor cores (wb', x, y, jac and hp are bf16; wb' has
// rows of wb_ld >= po elements). chain: kSirenPlain or kSirenResblock; act:
// kSinePoly7 or kSinePoly9 (the bf16 sine). Returns the CUDA error of the
// launch (0 on success); the kernel runs asynchronously on `stream`.
int nif_shapenet_fwd_hess_tc(const void* wb, const void* x, void* y, void* jac, void* hp,
                             void* scratch, int G, int P, int si, int so, int n, int n_mats,
                             int chain, int act, long long po, long long wb_ld, void* stream) {
  EvalGeometry geo{};
  if ((act != kSinePoly7 && act != kSinePoly9) || wb_ld < po ||
      eval_geometry(n, si, so, n_mats, chain, G, P, &geo) != 0)
    return (int)cudaErrorInvalidValue;
  EvalArgs a{};
  a.wb = static_cast<const bf16*>(wb);
  a.x = static_cast<const bf16*>(x);
  a.y = static_cast<bf16*>(y);
  a.jac = static_cast<bf16*>(jac);
  a.hp = static_cast<bf16*>(hp);
  a.scratch = static_cast<unsigned char*>(scratch);
  a.G = G; a.P = P; a.so = so; a.n = n; a.n_mats = n_mats;
  a.n16 = geo.n16; a.ld = geo.ld; a.n_cb = geo.n_cb;
  a.stage_w = geo.stage_w;
  a.stage_all = geo.stage_all;
  a.deg9 = act == kSinePoly9;
  a.wb_ld = wb_ld;
  a.block_bytes = (long long)geo.block_bytes;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return chain == kSirenResblock ? launch_eval_si<true>(si, geo, a, s)
                                 : launch_eval_si<false>(si, geo, a, s);
}

#ifdef K7_PHASE_CLOCKS
// K7's phase counters summed over every block since the last call, then
// zeroed (the probe build only).
int nif_fwd_hess_tc_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k7_phase_cycles, sizeof(k7_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[kEvalPhases] = {};
  return (int)cudaMemcpyToSymbol(k7_phase_cycles, zero, sizeof(zero));
}
#endif

const char* nif_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
