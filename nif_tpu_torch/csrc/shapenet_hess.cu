// K7 and K8 on Hopper's CUDA cores: the fused Hessian evaluation and the
// fused Hessian train pass of the grouped ShapeNet chain, in one body (one
// nvcc build).
//
// K7 replaces nif_tpu/ops/pallas_shapenet.py::_fwd_hess_kernel (reached
// through shapenet_fwd_hess; the chain is _hess_fwd_layers):
//   wb' [G, ldwb] f32 (omega_0 folded into the sine-fed weights by the
//   wrapper, at wb's dtype, then widened to f32), x [G, P, si]  ->  y
//   [G, P, so], jac [G, P, so, si] and the unique-pair Hessian columns hp
//   [G, P, so, np] in x's dtype T; the wrapper mirrors hp into the
//   symmetric [G, P, so, si, si].
// K8 replaces _hessian_kernel (reached through shapenet_hessian_grads; its
// backward is _hessian_backward_chain): the same stacked forward with its
// residuals, the masked and weighted value, Jacobian and Hessian squared
// errors (an off-diagonal pair counts twice), and the backward through the
// second-order chain, which multiplies by act'''.
//   -> value, Jacobian and Hessian sums / n_y, n_j, n_h (f32), d_wb [G, po]
//   in T, the sine-fed weight grads multiplied back by omega_0 in f32.
// Sine chains only (plain or resblock SIREN), si <= 4. The float32 policy's
// Hessian step and evaluation run this body; bf16 runs the tensor-core
// kernels of shapenet_hess_tc.cu where their geometry takes the chain, and
// this body on the rest (planes beyond shared memory).
//
// The stacked state: a tile of 8 points holds ns = 1 + si + np streams of 8
// rows (np = si (si + 1) / 2 unique pairs j <= k, row-major): stream 0 the
// values, 1 + k the tangents d/dx_k, 1 + si + a the second-order streams
// d2/dx_j dx_k; row st * 8 + p is stream st of point p. S (the input of
// each product) is stored rounded to T, the running state U and the raw
// products Z stay f32, and every epilogue runs in f32, as the reference
// keeps them. After a product, a value row's z gives f, f', f'' (and f'''
// in K8's backward) once for all its streams: new tangent f' Z_k; new pair
// f' Z_a + f'' Z_j Z_k. The first layer seeds the tangents with f'(z0)
// W0[k] and the pairs with f''(z0) W0[j] W0[k], elementwise: no x @ W0 on
// the stream rows, and no dx.
//
// What bounds them on an H100 SXM: operations. At the flagship train shape
// (G=32, P=32768, width 128, two hidden layers, si=3, so=1) K8 is 2071.3
// GFLOP of products: three passes (forward, dW, dS) of the hidden and last
// products over all ten streams, 3 x 689.9, and x @ W0 on the value rows in
// the forward and in dW0, 2 x 0.8; K7 is 690.7 GFLOP. Every product is an
// f32 FMA on the CUDA cores (a bf16 x bf16 product is exact in f32, and the
// f32 path must not use TF32), so the 67 TFLOP/s f32 peak bounds K8 at
// ~31 ms and K7 at ~10.6 ms.
//
// Design (the tile machinery is stack_simt.cuh's):
// - One body template, hess_simt_kernel<T, SI, TRAIN, RES>; K7 is its
//   forward half. The streams (SI) and the sine (the true one for f32, the
//   polynomial for bf16) are compile-time, so every epilogue indexes its
//   streams in registers; the chain (plain or resblock) is a flag read once
//   a layer, which halves the instances to build. RES says where the planes
//   sit: 1 = shared memory, 0 = the block's slice of a global scratch (bf16
//   always: its shapes are mostly those the tensor-core kernels refuse); no
//   instance reads through a pointer that may be either.
// - The register tile is SimtTile<ns, 32, 1>: thread (rg, cg) owns point
//   rg's ns stacked rows by 4 columns of a 128-column block, so the forward
//   epilogue runs on the product's registers and the backward one on the
//   cotangent product's (stack_simt.cuh's value and grad layouts). Wider
//   chains loop over 128-column blocks.
// - Planes [ns * 8, ld] f32 (ld = n rounded up to 32, + 4): K7 keeps two S
//   planes (ping-pong); K8 every hidden product's S input and the last one's
//   (nm + 1) and every hidden raw product Z (nm), its backward writes each
//   layer's D over that layer's Z in place, and a resblock's skip cotangent
//   waits in the S plane after the block, which that plane's dW has freed.
//   S_0 is elementwise in x, so from nm = 2 on it shares S_2's plane (dead
//   once the first product is done) and the backward recomputes it, with
//   app 0's epilogue, into S_1's plane (free once dW_1 is done). At the
//   flagship width (ld 132) a plane is 42.2 KB: K8's four fit in shared
//   memory beside two 18 KB weight buffers (32-row chunks; beside a fifth
//   plane only 16-row chunks fit).
// - The products of a tile form one stream of W chunks through cp.async:
//   the next chunk, or the next product's first, streams in while the
//   current one is multiplied, one barrier a chunk.
// - dW = S^T D sums all stacked rows of a tile in passes of 64 rows of dW (8
//   a thread) into the block's own f32 partial [po4] in global memory
//   (L2-resident), whose old values it loads before the products; a second
//   kernel sums the S partials of each group, and the three losses, in a
//   fixed order. No float atomics: two runs on the same inputs give the
//   same bits.
// - The grid is (S, G) with S = SMs / G splits of a group's tiles: one wave
//   of one block per SM.
// scripts/port_phase_probe.py --kernel k7f32 (or k8f32) splits a tile's
// time by phase; PERF.md has the split.
#include "stack_simt.cuh"

namespace {

constexpr int kMaxSplits = 64;  // point-tile runs per group
constexpr int kMaxChunk = 32;   // weight rows (or columns) per staged chunk
constexpr int kMaxSi = 4;
constexpr int kTilePoints = 8;  // points per tile: the register tile's row groups
constexpr int kSix = 4;         // the x tile's row stride

template <int SI>
using HessTile = SimtTile<1 + SI + SI * (SI + 1) / 2, 32, 1>;
constexpr int kCols = HessTile<1>::COLS;  // the columns of a block of a product
static_assert(HessTile<1>::RG == kTilePoints, "a row group is a point");

// Kernel bodies: keep in step with _MODES in ops/fused_hessian.py.
enum Mode : int { kEval = 0, kTrain = 1 };

// Built with -DK8F_PHASE_CLOCKS (by scripts/port_phase_probe.py only), thread
// 0 of every block adds the clock64() cycles from one mark to the next into
// ten phase counters, which split the block's critical path.
constexpr int kPhases = 10;
#ifdef K8F_PHASE_CLOCKS
__device__ unsigned long long k8f_phase_cycles[kPhases];
#define K8F_PHASE(i)                                       \
  do {                                                     \
    if (threadIdx.x == 0) {                                \
      const long long now = clock64();                     \
      phase_sum[i] += (unsigned long long)(now - phase_t); \
      phase_t = now;                                       \
    }                                                      \
  } while (0)
#else
#define K8F_PHASE(i) \
  do {               \
  } while (0)
#endif

__host__ __device__ constexpr long long round4(long long v) { return (v + 3) / 4 * 4; }

struct Args {
  const float* wb;         // wb' [G, ldwb], f32
  const void* x;           // [G, P, si], T
  void* y;                 // K7: [G, P, so], T
  void* jac;               // K7: [G, P, so, si], T
  void* hp;                // K7: [G, P, so, np], T, the unique pairs
  const void* target;      // K8: [G, P, so], T
  const void* jt;          // K8: [G, P, si*so], T, column k*so + j = d y_j / d x_k
  const void* ht;          // K8: [G, P, np*so], T, column a*so + j = d2 y_j / d x_{pair a}
  const float* y_mask;     // K8: [so] 0/1, or null
  const float* jac_mask;   // K8: [si*so] 0/1, or null
  const float* hess_mask;  // K8: [np*so] 0/1, or null
  const void* weight;      // K8: [G, P], T, or null
  float* partials;         // K8: [G, S, po4] weight-grad partials, then [G, S, 3] loss partials
  float* scratch;          // the planes of each block when they live in global memory
  float ky, kj, kh;        // K8: 2 w_value / n_y, 2 w_jac / n_j, 2 w_hess / n_h
  int G, P, so, n, n_mats, resblock, act, ld, kc, stage_buf;
  long long ldwb, po4, resid_floats;  // resid_floats per block
};

// z0 = x @ W0' + b0 at one column: the forward and the first layer's
// backward evaluate it alike, so they agree to the bit.
template <int SI>
__device__ __forceinline__ float first_z(const float* x, const float (&w)[SI], float b) {
  float z = 0.f;
#pragma unroll
  for (int k = 0; k < SI; ++k) z = fmaf(x[k], w[k], z);
  return z + b;
}

// The first layer's streams at one column (w = W0'[:, c], b = b0[c]):
// values f(z0), tangent seeds f'(z0) W0'[k], pair seeds f''(z0) (W0'[j]
// W0'[k]); K8's backward recomputes them to the bit.
template <int SI, int NS, class Sine>
__device__ __forceinline__ void first_layer(const Sine& sine, const float* x,
                                            const float (&w)[SI], float b, float (&v)[NS]) {
  float d1, d2;
  v[0] = sine.d012(first_z<SI>(x, w, b), &d1, &d2);
#pragma unroll
  for (int k = 0; k < SI; ++k) v[1 + k] = d1 * w[k];
  int pa = 0;
#pragma unroll
  for (int j = 0; j < SI; ++j)
#pragma unroll
    for (int k = j; k < SI; ++k, ++pa) v[1 + SI + pa] = d2 * (w[j] * w[k]);
}

// K7 (TRAIN = false): the stacked forward, then y, jac and the pair
// columns. K8 (TRAIN = true): the stacked forward with its residuals, the
// three squared-error sums and the stacked backward into the block's
// partials.
template <typename T, int SI, bool TRAIN, int RES>
__global__ void __launch_bounds__(kThreads, 1) hess_simt_kernel(const Args a) {
  using L = HessTile<SI>;
  constexpr int NP = SI * (SI + 1) / 2;
  constexpr int NS = 1 + SI + NP;
  constexpr int R = L::TP;  // a tile's stacked rows, NS * 8
  constexpr bool kF32 = std::is_same<T, float>::value;
  using Sine = std::conditional_t<kF32, ExactSineHess, PolySineHess>;
  extern __shared__ __align__(16) float smem[];
  const int n = a.n, so = a.so, nm = a.n_mats, ld = a.ld;
  const bool resblock = a.resblock;
  const int n4 = (n + 3) / 4 * 4;
  const int ncb = (n + kCols - 1) / kCols;
  const size_t plane = (size_t)R * ld;
  const int S = gridDim.x, s = blockIdx.x;
  const Sine sine(a.act);
  // the block's planes (geometry() lays them out alike)
  float* res = RES == 1 ? smem
                        : a.scratch + ((size_t)blockIdx.y * S + s) * (size_t)a.resid_floats;
  const bool share = TRAIN && nm >= 2;  // S_0 shares S_2's plane (K8)
  const int n_s = TRAIN ? (share ? nm : nm + 1) : (nm > 0 ? 2 : 1);
  float* Sp = res;                                   // the S planes
  float* Zp = Sp + (size_t)n_s * plane;              // K8: the raw products Z, then D
  float* U = Zp + (TRAIN ? (size_t)nm * plane : 0);  // bf16 resblock: the running f32 state
  float* DZV = U + (!kF32 && resblock ? plane : 0);  // bf16 K8: [8, ld] the value rows' dz
  float* X = DZV + (!kF32 && TRAIN ? kTilePoints * ld : 0);  // [8, kSix] the x tile
  float* O = X + kTilePoints * kSix;  // [R, so] the last product; D_out in K8
  float* wbuf = smem + (RES == 1 ? a.resid_floats : 0);
  float* S0 = Sp;  // S_0's plane: S_2's in K8's forward, S_1's in its backward (share)
  auto Splane = [&](int m) {
    return m == 0 ? S0 : Sp + (size_t)(TRAIN ? (share ? m - 1 : m) : (m & 1)) * plane;
  };
  auto Zplane = [&](int m) { return Zp + (size_t)m * plane; };
  const bool vec = n % 4 == 0;
  WStage st{wbuf, a.stage_buf, a.kc, vec, 0};
  const Slot<L> sl;
  const int p = sl.rg;  // the thread's point of a tile
  auto row = [&](int stream) { return (stream * kTilePoints + p) * ld; };

  const int tc = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int n_tiles = (a.P + kTilePoints - 1) / kTilePoints;
  const int t_begin = (int)((long long)s * n_tiles / S);
  const int t_end = (int)((long long)(s + 1) * n_tiles / S);

  const long long o_wh = (long long)SI * n;
  const long long o_wl = o_wh + (long long)nm * n * n;
  const long long o_b0 = o_wl + (long long)n * so;
  const long long o_bh = o_b0 + n;
  const long long o_bl = o_bh + (long long)nm * n;
  const int nsteps = (TRAIN ? 2 : 1) * nm * ncb;  // the products of a tile
#ifdef K8F_PHASE_CLOCKS
  unsigned long long phase_sum[kPhases] = {};
  long long phase_t = clock64();
#endif

  for (int g = blockIdx.y; g < a.G; g += gridDim.y) {
    const float* wg = a.wb + (long long)g * a.ldwb;
    const float* W0 = wg;
    const float* WL = wg + o_wl;
    const float* B0 = wg + o_b0;
    const float* BL = wg + o_bl;
    float* part = TRAIN ? a.partials + ((long long)g * S + s) * a.po4 : nullptr;
    // The products of a tile in order, each staging the next one's first
    // chunk of W: steps 0 .. nm ncb - 1 the forward products (matrix m,
    // column block cb), then (K8) the cotangent products of m = nm - 1 .. 0
    // (output block cb), then the next tile's step 0.
    auto stage_step = [&](int step, float* buf) {
      if (step < nm * ncb) {
        const int m = step / ncb, c0 = (step - m * ncb) * kCols;
        stage_fwd_head<L>(buf, st, wg + o_wh + (long long)m * n * n + c0, n, n4, n, n - c0);
      } else {
        const int t = step - nm * ncb;
        const int m = nm - 1 - t / ncb, c0 = (t % ncb) * kCols;
        stage_bwd_head<L>(buf, st, wg + o_wh + (long long)m * n * n + (long long)c0 * n, n - c0,
                          n);
      }
    };
    __syncthreads();  // the previous group is done with the weight buffers
    if (nsteps > 0) {
      stage_step(0, st.ws + st.parity * st.buf);
      cp_commit();
    }
    float loss[3] = {0.f, 0.f, 0.f};  // value, Jacobian, Hessian
    for (int tile = t_begin; tile < t_end; ++tile) {
      const bool first = tile == t_begin;
      int step = 0;
      const auto next = [&](float* buf) {  // stages the step after `step`
        if (step + 1 < nsteps)
          stage_step(step + 1, buf);
        else if (tile + 1 < t_end)
          stage_step(0, buf);
      };
      const int p0 = tile * kTilePoints;
      const int rows = min(kTilePoints, a.P - p0);
      const long long row0 = (long long)g * a.P + p0;
      __syncthreads();  // the previous tile has finished with every plane
      S0 = share ? Sp + plane : Sp;
      if (threadIdx.x < kTilePoints * kSix) {
        const int r = threadIdx.x / kSix, k = threadIdx.x % kSix;
        X[threadIdx.x] = r < rows && k < SI
                             ? to_f32(static_cast<const T*>(a.x)[(row0 + r) * SI + k])
                             : 0.f;
      }
      __syncthreads();

      // ---- first layer: z0 = x @ W0' + b0; values f(z0), tangent seeds
      // f'(z0) W0'[k], pair seeds f''(z0) (W0'[j] W0'[k])
      for (int c0 = 0; c0 < n; c0 += kCols) {
        const int c = c0 + sl.vcol(0, 0);
        if (c >= n) continue;
        float v[NS][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live = c + e < n;
          float w[SI], ve[NS];
#pragma unroll
          for (int k = 0; k < SI; ++k) w[k] = live ? W0[k * n + c + e] : 0.f;
          first_layer<SI, NS>(sine, X + p * kSix, w, live ? B0[c + e] : 0.f, ve);
#pragma unroll
          for (int q = 0; q < NS; ++q) v[q][e] = ve[q];
        }
#pragma unroll
        for (int q = 0; q < NS; ++q) {
          *reinterpret_cast<float4*>(Splane(0) + row(q) + c) =
              make_float4(lift<T>(v[q][0]), lift<T>(v[q][1]), lift<T>(v[q][2]), lift<T>(v[q][3]));
          if (!kF32 && resblock)
            *reinterpret_cast<float4*>(U + row(q) + c) =
                make_float4(v[q][0], v[q][1], v[q][2], v[q][3]);
        }
      }
      K8F_PHASE(0);  // the x tile and the first layer

      // ---- hidden products, then their epilogues on the product's
      // registers (the value layout): a resblock's first matrix feeds its
      // output on, the second averages it with the block's input
      for (int m = 0; m < nm; ++m) {
        const bool res_second = resblock && m % 2 == 1;
        const float* Wm = wg + o_wh + (long long)m * n * n;
        const float* bm = wg + o_bh + (long long)m * n;
        float* Sn = Splane(m + 1);
        for (int c0 = 0; c0 < n; c0 += kCols) {
          Acc<L> acc;
          product_fwd<L>(Splane(m), ld, n4, Wm + c0, n, n, n - c0, st, sl, acc, next);
          ++step;
          K8F_PHASE(1);  // a hidden forward product
          const int c = c0 + sl.vcol(0, 0);
          if (c < n) {
            if (TRAIN) {
#pragma unroll
              for (int q = 0; q < NS; ++q)
                *reinterpret_cast<float4*>(Zplane(m) + row(q) + c) =
                    make_float4(acc[q][0][0], acc[q][0][1], acc[q][0][2], acc[q][0][3]);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float d1, d2;
              const float f = sine.d012(acc[0][0][e] + (c + e < n ? bm[c + e] : 0.f), &d1, &d2);
              // the pairs first: they read the tangents' Z
              int pa = 0;
#pragma unroll
              for (int j = 0; j < SI; ++j)
#pragma unroll
                for (int k = j; k < SI; ++k, ++pa)
                  acc[1 + SI + pa][0][e] =
                      d1 * acc[1 + SI + pa][0][e] + d2 * acc[1 + j][0][e] * acc[1 + k][0][e];
#pragma unroll
              for (int k = 0; k < SI; ++k) acc[1 + k][0][e] = d1 * acc[1 + k][0][e];
              acc[0][0][e] = f;
            }
            // the block's input: f32 chains keep it as their S plane (in K7
            // the plane this output overwrites, element by element)
            const float* u_in = kF32 ? Splane(res_second ? m - 1 : m) : U;
#pragma unroll
            for (int q = 0; q < NS; ++q) {
              float4 v = make_float4(acc[q][0][0], acc[q][0][1], acc[q][0][2], acc[q][0][3]);
              if (res_second) {
                const float4 u = *reinterpret_cast<const float4*>(u_in + row(q) + c);
                v = make_float4(0.5f * (u.x + v.x), 0.5f * (u.y + v.y), 0.5f * (u.z + v.z),
                                0.5f * (u.w + v.w));
                if (!kF32) *reinterpret_cast<float4*>(U + row(q) + c) = v;
              }
              *reinterpret_cast<float4*>(Sn + row(q) + c) =
                  make_float4(lift<T>(v.x), lift<T>(v.y), lift<T>(v.z), lift<T>(v.w));
            }
          }
          K8F_PHASE(2);  // thread 0's hidden forward epilogue
        }
      }
      __syncthreads();  // the last S plane is complete

      // ---- last product O = lift(S) @ W_last over all R rows, one warp per
      // (row, output)
      const float* Sl = Splane(nm);
      for (int pr = warp; pr < R * so; pr += kWarps) {
        const int rr = pr / so;
        const int j = pr - rr * so;
        float sum = 0.f;
        for (int k = tc; k < n; k += kLanes) sum = fmaf(Sl[rr * ld + k], WL[(long long)k * so + j], sum);
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (tc == 0) O[pr] = sum;
      }
      __syncthreads();  // O is complete

      if (!TRAIN) {
        // ---- K7: y = O[values] + b_last; jac[r][j][k] = O[tangent k][r][j];
        // hp[r][j][a] = O[pair a][r][j]
        T* yg = static_cast<T*>(a.y) + row0 * so;
        for (int idx = threadIdx.x; idx < rows * so; idx += kThreads)
          yg[idx] = from_f32<T>(O[idx] + BL[idx % so]);
        T* jg = static_cast<T*>(a.jac) + row0 * so * SI;
        for (int idx = threadIdx.x; idx < rows * so * SI; idx += kThreads) {
          const int r = idx / (so * SI);
          const int rem = idx - r * so * SI;
          const int j = rem / SI;
          const int k = rem - j * SI;
          jg[idx] = from_f32<T>(O[((1 + k) * kTilePoints + r) * so + j]);
        }
        T* hg = static_cast<T*>(a.hp) + row0 * so * NP;
        for (int idx = threadIdx.x; idx < rows * so * NP; idx += kThreads) {
          const int r = idx / (so * NP);
          const int rem = idx - r * so * NP;
          const int j = rem / NP;
          const int pa = rem - j * NP;
          hg[idx] = from_f32<T>(O[((1 + SI + pa) * kTilePoints + r) * so + j]);
        }
        K8F_PHASE(3);  // the last product and thread 0's y, jac, hp stores
        continue;
      }

      // ---- K8 loss: err = mask (out - t), e = mask (O_stream - target);
      // sums w err^2 (a pair's times its multiplicity); D_out = [ky w err;
      // kj w e_k; kh mult w e_a] in place of O (zero past the ragged edge)
      {
        const T* tg = static_cast<const T*>(a.target) + row0 * so;
        const T* jtg = static_cast<const T*>(a.jt) + row0 * SI * so;
        const T* htg = static_cast<const T*>(a.ht) + row0 * NP * so;
        const T* wt = a.weight ? static_cast<const T*>(a.weight) + row0 : nullptr;
        for (int idx = threadIdx.x; idx < kTilePoints * so; idx += kThreads) {
          const int r = idx / so;
          const int jo = idx - r * so;
          const bool live = r < rows;
          const float w = live && wt ? to_f32(wt[r]) : 1.f;
          float dv = 0.f;
          if (live) {
            float err = O[idx] + BL[jo] - to_f32(tg[idx]);
            if (a.y_mask) err = err * a.y_mask[jo];
            loss[0] += err * err * w;
            dv = a.ky * err * w;
          }
          O[idx] = dv;
          for (int k = 0; k < SI; ++k) {
            const int o = ((1 + k) * kTilePoints + r) * so + jo;
            float dj = 0.f;
            if (live) {
              float e = O[o] - to_f32(jtg[(long long)r * SI * so + k * so + jo]);
              if (a.jac_mask) e = e * a.jac_mask[k * so + jo];
              loss[1] += e * e * w;
              dj = a.kj * e * w;
            }
            O[o] = dj;
          }
          int pa = 0;
          for (int j = 0; j < SI; ++j)
            for (int k = j; k < SI; ++k, ++pa) {
              const int o = ((1 + SI + pa) * kTilePoints + r) * so + jo;
              const float mult = j == k ? 1.f : 2.f;
              float dh = 0.f;
              if (live) {
                float e = O[o] - to_f32(htg[(long long)r * NP * so + pa * so + jo]);
                if (a.hess_mask) e = e * a.hess_mask[pa * so + jo];
                loss[2] += mult * (e * e * w);
                dh = (a.kh * mult) * e * w;
              }
              O[o] = dh;
            }
        }
      }
      __syncthreads();  // D_out is complete
      K8F_PHASE(3);     // the last product and the loss

      // ---- last layer: dW_l = lift(S)^T lift(D_out), db_l = the sum of
      // D_out's value rows
      for (int idx = threadIdx.x; idx < n * so; idx += kThreads) {
        const int k = idx / so;
        const int j = idx - k * so;
        tile_sum<R>(part + o_wl + idx, first, [&](int r, float sum) {
          return fmaf(Sl[r * ld + k], lift<T>(O[r * so + j]), sum);
        });
      }
      for (int j = kThreads - 1 - threadIdx.x; j < so; j += kThreads)  // the last threads
        tile_sum<kTilePoints>(part + o_bl + j, first,
                              [&](int r, float sum) { return sum + O[r * so + j]; });
      __syncthreads();  // the last S plane is free (a resblock's skip cotangent goes there)
      K8F_PHASE(4);     // the last layer's backward

      // ---- backward, last app to first: the cotangent cot of app m's output
      // (the input of app m + 1, or of the last layer) column block by
      // column block in the grad layout, then app m's epilogue on it (m = -1:
      // the first layer's), then app m's dW and db over the whole tile
      for (int m = nm - 1; m >= -1; --m) {
        if (m == 0) S0 = Sp;  // app 0's epilogue recomputes S_0 there
        for (int c0 = 0; c0 < n; c0 += kCols) {
          Acc<L> cot;
          if (m == nm - 1) {  // dS = lift(D_out) @ W_l^T
#pragma unroll
            for (int q = 0; q < NS; ++q)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int k = c0 + sl.gcol(0, j);
                float v = 0.f;
                if (k < n)
                  for (int jo = 0; jo < so; ++jo)
                    v = fmaf(lift<T>(O[(q * kTilePoints + p) * so + jo]), WL[(long long)k * so + jo],
                             v);
                cot[q][0][j] = v;
              }
          } else {  // dS = D_{m+1} @ W_{m+1}^T
            product_bwd<L>(Zplane(m + 1), ld, wg + o_wh + (long long)(m + 1) * n * n +
                                                   (long long)c0 * n,
                           n - c0, n, st, sl, cot, next);
            ++step;
            K8F_PHASE(7);  // a dS product
            if (resblock && (m + 1) % 2 == 0) {
              // the skip path: + 0.5 the cotangent of the block's output
              const float* dv = Splane(m + 3);
#pragma unroll
              for (int q = 0; q < NS; ++q)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  const int c = c0 + sl.gcol(0, j);
                  if (c < n) cot[q][0][j] = cot[q][0][j] + 0.5f * dv[row(q) + c];
                }
            }
          }
          if (m >= 0) {
            // with du, dt_k, dh_a the scaled cotangents of the app's output
            // streams: dz = du f' + sum_k dt_k Z_k f'' + sum_a dh_a (Z_a f''
            // + Z_j Z_k f'''); D = [dz; dt_k f' + the pairs' product-rule
            // terms; dh_a f'], each rounded to T, over Z
            const bool res_second = resblock && m % 2 == 1;
            const float scale = res_second ? 0.5f : 1.f;
            float* Z = Zplane(m);
            const float* bm = wg + o_bh + (long long)m * n;
            float* dv = Splane(m + 1);  // res_second: the block output's cotangent waits here
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c = c0 + sl.gcol(0, j);
              if (c >= n) continue;
              float zr[NS], ds[NS];
#pragma unroll
              for (int q = 0; q < NS; ++q) {
                zr[q] = Z[row(q) + c];
                ds[q] = scale * cot[q][0][j];
              }
              float f1, f2, f3;
              sine.d123(zr[0] + bm[c], &f1, &f2, &f3);
              float dz = ds[0] * f1;
              float dt[SI];
#pragma unroll
              for (int k = 0; k < SI; ++k) {
                dz = dz + ds[1 + k] * zr[1 + k] * f2;
                dt[k] = ds[1 + k] * f1;
              }
              int pa = 0;
#pragma unroll
              for (int jj = 0; jj < SI; ++jj)
#pragma unroll
                for (int k = jj; k < SI; ++k, ++pa) {
                  const float dh = ds[1 + SI + pa];
                  dz = dz + dh * (zr[1 + SI + pa] * f2 + zr[1 + jj] * zr[1 + k] * f3);
                  Z[row(1 + SI + pa) + c] = lift<T>(dh * f1);
                  if (jj == k) {
                    dt[jj] = dt[jj] + 2.f * dh * f2 * zr[1 + jj];
                  } else {
                    dt[jj] = dt[jj] + dh * f2 * zr[1 + k];
                    dt[k] = dt[k] + dh * f2 * zr[1 + jj];
                  }
                }
#pragma unroll
              for (int k = 0; k < SI; ++k) Z[row(1 + k) + c] = lift<T>(dt[k]);
              Z[row(0) + c] = lift<T>(dz);
              if (!kF32) DZV[p * ld + c] = dz;
              if (res_second) {
#pragma unroll
                for (int q = 0; q < NS; ++q) dv[row(q) + c] = cot[q][0][j];
              }
              if (m == 0) {  // S_0 for dW_0, as the forward made it
                float w[SI], v[NS];
#pragma unroll
                for (int k = 0; k < SI; ++k) w[k] = W0[k * n + c];
                first_layer<SI, NS>(sine, X + p * kSix, w, B0[c], v);
#pragma unroll
                for (int q = 0; q < NS; ++q) S0[row(q) + c] = lift<T>(v[q]);
              }
            }
            K8F_PHASE(5);  // a backward epilogue
          } else {
            // the first layer: dz0 = du f'(z0) + sum_k dt_k W0'[k] f''(z0) +
            // sum_a dh_a (W0'[j] W0'[k]) f'''(z0); the seed rows of dW0
            // collect dt_k f'(z0) and the pairs' dh_a f''(z0) W0'[the other
            // index]; both into the first S plane, for the sums below
            float* SC = Splane(0);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c = c0 + sl.gcol(0, j);
              if (c >= n) continue;
              float w[SI];
#pragma unroll
              for (int k = 0; k < SI; ++k) w[k] = W0[k * n + c];
              float f1, f2, f3;
              sine.d123(first_z<SI>(X + p * kSix, w, B0[c]), &f1, &f2, &f3);
              float dz = cot[0][0][j] * f1;
              float seed[SI];
#pragma unroll
              for (int k = 0; k < SI; ++k) {
                dz = dz + cot[1 + k][0][j] * w[k] * f2;
                seed[k] = cot[1 + k][0][j] * f1;
              }
              int pa = 0;
#pragma unroll
              for (int jj = 0; jj < SI; ++jj)
#pragma unroll
                for (int k = jj; k < SI; ++k, ++pa) {
                  const float dh = cot[1 + SI + pa][0][j];
                  dz = dz + dh * (w[jj] * w[k]) * f3;
                  if (jj == k) {
                    seed[jj] = seed[jj] + 2.f * (dh * f2 * w[jj]);
                  } else {
                    seed[jj] = seed[jj] + dh * f2 * w[k];
                    seed[k] = seed[k] + dh * f2 * w[jj];
                  }
                }
              SC[row(0) + c] = dz;
#pragma unroll
              for (int k = 0; k < SI; ++k) SC[row(1 + k) + c] = seed[k];
            }
          }
        }
        __syncthreads();  // app m's D (or the first layer's rows) is complete
        if (m >= 0) {
          weight_grad_rows<8, L>(Splane(m), ld, n, Zplane(m), ld, n,
                                 part + o_wh + (long long)m * n * n, first, vec, sl);
          const float* dzv = kF32 ? Zplane(m) : DZV;  // the value rows' unrounded dz
          for (int c = kThreads - 1 - threadIdx.x; c < n; c += kThreads)
            tile_sum<kTilePoints>(part + o_bh + (long long)m * n + c, first,
                                  [&](int r, float sum) { return sum + dzv[r * ld + c]; });
          K8F_PHASE(6);  // a hidden dW and db, partial updates included
        } else {
          // dW0 = lift(x)^T lift(dz0) + the seed rows, db0 = the sum of dz0
          const float* SC = Splane(0);
          for (int idx = threadIdx.x; idx < SI * n; idx += kThreads) {
            const int k = idx / n;
            const int c = idx - k * n;
            float s1 = 0.f, s2 = 0.f;
#pragma unroll
            for (int r = 0; r < kTilePoints; ++r) {
              s1 = fmaf(X[r * kSix + k], lift<T>(SC[r * ld + c]), s1);
              s2 += SC[((1 + k) * kTilePoints + r) * ld + c];
            }
            part[idx] = first ? s1 + s2 : part[idx] + (s1 + s2);
          }
          for (int c = kThreads - 1 - threadIdx.x; c < n; c += kThreads)
            tile_sum<kTilePoints>(part + o_b0 + c, first,
                                  [&](int r, float sum) { return sum + SC[r * ld + c]; });
          K8F_PHASE(8);  // the first layer's backward
        }
      }
    }

    if (TRAIN)  // the block's three loss partials, after the [G, S, po4] weight grads
      store_loss_partials(loss, wbuf,
                          a.partials + (long long)a.G * S * a.po4 + ((long long)g * S + s) * 3);
    K8F_PHASE(9);  // the group's loss partials
  }
#ifdef K8F_PHASE_CLOCKS
  if (threadIdx.x == 0)
    for (int i = 0; i < kPhases; ++i) atomicAdd(&k8f_phase_cycles[i], phase_sum[i]);
#endif
}

// d_wb[g][p] = T((sum_s partial[g][s][p]) * (p < n_scaled ? omega : 1)), the
// S splits summed in order; then one thread per loss sums its G*S partials
// (laid out [G, S, 3] after the [G, S, po4] weight grads) in order and
// divides by its norm. No float atomics: two runs give the same bits.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    hess_reduce_kernel(const float* __restrict__ partials, int G, int S, long long po,
                       long long po4, long long n_scaled, float omega, LossNorms norms,
                       T* __restrict__ d_wb, float* __restrict__ losses) {
  const long long total = (long long)G * po;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * kThreads) {
    const long long g = idx / po;
    const long long p = idx - g * po;
    const float* src = partials + g * S * po4 + p;
    float sum = 0.f;
    for (int s = 0; s < S; ++s) sum += src[s * po4];
    if (p < n_scaled) sum = sum * omega;
    d_wb[idx] = from_f32<T>(sum);
  }
  if (blockIdx.x == 0 && threadIdx.x < 3) {
    const float* lp = partials + (long long)G * S * po4 + threadIdx.x;
    float sum = 0.f;
    for (long long i = 0; i < (long long)G * S; ++i) sum += lp[3 * i];
    losses[threadIdx.x] = sum / norms.n[threadIdx.x];
  }
}

struct Geometry {
  int tile, ld, kc, stage_buf, splits, grid_g, resid_in_smem;
  size_t smem, resid_floats;
};

// The geometry of one body (mode kEval = K7, kTrain = K8): the planes of a
// block (floats, laid out as the kernel reads them: the S planes (K8's S_0
// in S_2's from nm = 2 on), K8's Z planes, a bf16 resblock's U plane, bf16
// K8's value-row dz, the x tile and the last product), in shared memory
// beside the two weight buffers where
// they fit (f32 only), else in a per-block slice of a global scratch; the
// chunk is the largest of 32, 24, 16, 8 rows that fits. Status: 0 = ok, 1 =
// too wide (above 1024 columns, as the port's other CUDA-core kernels), 2 =
// even the weight buffers exceed a block's shared memory, 3 = bad shape (or
// a chain or si the kernels do not take).
int geometry(int mode, int n, int si, int so, int n_mats, int chain, int elem, int G, int P,
             Geometry* g) {
  if (n < 1 || si < 1 || si > kMaxSi || so < 1 || n_mats < 0 || G < 1 || P < 1 || mode < 0 ||
      mode > 1 || (chain != kSirenPlain && chain != kSirenResblock) ||
      (chain == kSirenResblock && n_mats % 2))
    return 3;
  if (n > kMaxRn * kLanes) return 1;
  const bool train = mode == kTrain, f32 = elem == 4, resblock = chain == kSirenResblock;
  const size_t rows = (size_t)(1 + si + si * (si + 1) / 2) * kTilePoints;
  g->tile = kTilePoints;
  g->ld = (n + 31) / 32 * 32 + 4;
  const size_t plane = rows * g->ld;
  const size_t n_s = train ? (n_mats >= 2 ? n_mats : n_mats + 1) : (n_mats > 0 ? 2 : 1);
  g->resid_floats = (n_s + (train ? n_mats : 0) + (!f32 && resblock ? 1 : 0)) * plane +
                    (!f32 && train ? (size_t)kTilePoints * g->ld : 0) + kTilePoints * kSix +
                    round4((long long)rows * so);
  auto bytes = [&](bool resid, int kc) {
    return sizeof(float) * ((resid ? g->resid_floats : 0) + 2 * (size_t)stage_floats(kCols, kc));
  };
  g->resid_in_smem = f32 && bytes(true, 8) <= kMaxSmem;
  const int widest = (n + 7) / 8 * 8;
  g->kc = 0;
  for (int kc = kMaxChunk; kc >= 8; kc -= 8)
    if ((kc <= widest || kc == 8) && bytes(g->resid_in_smem, kc) <= kMaxSmem) {
      g->kc = kc;
      break;
    }
  if (g->kc == 0) return 2;
  g->stage_buf = stage_floats(kCols, g->kc);
  g->smem = bytes(g->resid_in_smem, g->kc);
  const int n_tiles = (P + kTilePoints - 1) / kTilePoints;
  const int sms = sm_count();
  int splits = sms > G ? sms / G : 1;
  splits = splits < kMaxSplits ? splits : kMaxSplits;
  g->splits = splits < n_tiles ? splits : n_tiles;
  g->grid_g = G < 65535 ? G : 65535;
  return 0;
}

template <typename T, int SI, bool TRAIN>
int launch(const Geometry& geo, Args a, T* d_wb, float* losses, long long po, long long n_scaled,
           float omega, LossNorms norms, cudaStream_t stream) {
  void (*kernel)(Args) = hess_simt_kernel<T, SI, TRAIN, 0>;
  if constexpr (std::is_same<T, float>::value)
    if (geo.resid_in_smem) kernel = hess_simt_kernel<T, SI, TRAIN, 1>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
  if (err != cudaSuccess) return (int)err;
  a.ld = geo.ld;
  a.kc = geo.kc;
  a.stage_buf = geo.stage_buf;
  a.resid_floats = (long long)geo.resid_floats;
  a.po4 = round4(po);
  kernel<<<dim3(geo.splits, geo.grid_g), kThreads, geo.smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || !TRAIN) return (int)err;
  hess_reduce_kernel<T><<<stride_blocks((long long)a.G * po), kThreads, 0, stream>>>(
      a.partials, a.G, geo.splits, po, a.po4, n_scaled, omega, norms, d_wb, losses);
  return (int)cudaGetLastError();
}

// The instance of a shape: f32 chains take the true sine, bf16 ones the
// polynomial (its degree chosen once a kernel); the streams are si's.
template <bool TRAIN>
int run(const Geometry& geo, const Args& a, int si, int dtype, void* d_wb, float* losses,
        long long po, long long n_scaled, float omega, LossNorms norms, cudaStream_t s) {
  if (dtype == 0 ? a.act != kSineExact : a.act != kSinePoly7 && a.act != kSinePoly9)
    return (int)cudaErrorInvalidValue;
  auto go = [&](auto t, auto si_c) {
    using T = decltype(t);
    return launch<T, decltype(si_c)::value, TRAIN>(geo, a, static_cast<T*>(d_wb), losses, po,
                                                   n_scaled, omega, norms, s);
  };
  auto by_si = [&](auto t) {
    switch (si) {
      case 1: return go(t, std::integral_constant<int, 1>{});
      case 2: return go(t, std::integral_constant<int, 2>{});
      case 3: return go(t, std::integral_constant<int, 3>{});
      case 4: return go(t, std::integral_constant<int, 4>{});
      default: return (int)cudaErrorInvalidValue;
    }
  };
  return dtype == 0 ? by_si(float{}) : by_si(__nv_bfloat16{});
}

// The checks both entries share: a dtype code, a shape the geometry takes,
// W rows that stage with 16-byte copies (ldwb a multiple of 4, at least po).
bool valid(int mode, int n, int si, int so, int n_mats, int chain, int G, int P, int dtype,
           long long po, long long ldwb, Geometry* g) {
  return dtype >= 0 && dtype <= 1 && ldwb >= po && ldwb % 4 == 0 &&
         geometry(mode, n, si, so, n_mats, chain, dtype == 0 ? 4 : 2, G, P, g) == 0;
}

}  // namespace

extern "C" {

// The geometry of one body (mode 0 = K7, 1 = K8) at [G, P] (a status as
// geometry() returns; on 0 and 2 the outputs are written): points per tile,
// P splits per group, dynamic shared memory per block, the f32 partials the
// caller allocates for K8 (G*S*po4 weight grads, po rounded up to 4, then
// G*S*3 losses; 0 for K7) and the bytes of plane scratch (0 when the planes
// sit in shared memory).
int nif_shapenet_hess_workspace(int mode, int n, int si, int so, int n_mats, int chain, int G,
                                int P, int dtype, int* tile, int* splits, long long* smem_bytes,
                                long long* partial_floats, long long* scratch_bytes) {
  Geometry g{};
  const int status = geometry(mode, n, si, so, n_mats, chain, dtype == 0 ? 4 : 2, G, P, &g);
  if (status != 0 && status != 2) return status;
  const long long po = (long long)n_mats * n * n + (long long)(si + so + 1 + n_mats) * n + so;
  *tile = g.tile;
  *splits = g.splits;
  *smem_bytes = (long long)g.smem;
  *partial_floats = mode == kTrain ? (long long)G * g.splits * (round4(po) + 3) : 0;
  *scratch_bytes = g.resid_in_smem ? 0
                                   : (long long)g.grid_g * g.splits *
                                         (long long)g.resid_floats * (long long)sizeof(float);
  return status;
}

// K7. wb is f32 with row stride ldwb (a multiple of 4, >= po); dtype: 0 =
// float, 1 = bf16 (x, y, jac and hp share it). Returns the CUDA error of the
// launch (0 on success); the kernel runs asynchronously on `stream`.
int nif_shapenet_fwd_hess(const void* wb, const void* x, void* y, void* jac, void* hp,
                          void* scratch, int G, int P, int si, int so, int n, int n_mats,
                          int chain, int act, long long po, long long ldwb, int dtype,
                          void* stream) {
  Geometry g{};
  if (!valid(kEval, n, si, so, n_mats, chain, G, P, dtype, po, ldwb, &g))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.wb = static_cast<const float*>(wb);
  a.x = x;
  a.y = y;
  a.jac = jac;
  a.hp = hp;
  a.scratch = static_cast<float*>(scratch);
  a.G = G; a.P = P; a.so = so; a.n = n; a.n_mats = n_mats;
  a.resblock = chain == kSirenResblock; a.act = act; a.ldwb = ldwb;
  return run<false>(g, a, si, dtype, nullptr, nullptr, po, 0, 1.f, LossNorms{},
                    static_cast<cudaStream_t>(stream));
}

// K8. wb as K7's; dtype as K7's (x, target, jt, ht, weight and d_wb share
// it); y_mask, jac_mask, hess_mask and weight may be null. losses receives
// [value_mse, jac_mse, hess_mse].
int nif_shapenet_hessian_grads(const void* wb, const void* x, const void* target, const void* jt,
                               const void* ht, const void* y_mask, const void* jac_mask,
                               const void* hess_mask, const void* weight, void* losses,
                               void* d_wb, void* partials, void* scratch, int G, int P, int si,
                               int so, int n, int n_mats, int chain, int act, long long po,
                               long long ldwb, long long n_scaled, float omega, float ky,
                               float kj, float kh, float n_y, float n_j, float n_h, int dtype,
                               void* stream) {
  Geometry g{};
  if (!valid(kTrain, n, si, so, n_mats, chain, G, P, dtype, po, ldwb, &g))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.wb = static_cast<const float*>(wb);
  a.x = x;
  a.target = target;
  a.jt = jt;
  a.ht = ht;
  a.y_mask = static_cast<const float*>(y_mask);
  a.jac_mask = static_cast<const float*>(jac_mask);
  a.hess_mask = static_cast<const float*>(hess_mask);
  a.weight = weight;
  a.partials = static_cast<float*>(partials);
  a.scratch = static_cast<float*>(scratch);
  a.ky = ky;
  a.kj = kj;
  a.kh = kh;
  a.G = G; a.P = P; a.so = so; a.n = n; a.n_mats = n_mats;
  a.resblock = chain == kSirenResblock; a.act = act; a.ldwb = ldwb;
  return run<true>(g, a, si, dtype, d_wb, static_cast<float*>(losses), po, n_scaled, omega,
                   LossNorms{{n_y, n_j, n_h}}, static_cast<cudaStream_t>(stream));
}

#ifdef K8F_PHASE_CLOCKS
// The phase counters summed over every block since the last call, then
// zeroed (the probe build only).
int nif_hess_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k8f_phase_cycles, sizeof(k8f_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[kPhases] = {};
  return (int)cudaMemcpyToSymbol(k8f_phase_cycles, zero, sizeof(zero));
}
#endif

const char* nif_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
