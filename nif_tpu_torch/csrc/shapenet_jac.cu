// K5's tangent body and K6 on Hopper's CUDA cores: the fused Jacobian for
// so >= si and the fused Sobolev train pass of the grouped ShapeNet chain, in
// one source (one nvcc build) and, for si <= 4, one body template.
//
// K5's tangent body replaces nif_tpu/ops/pallas_shapenet.py::_fwd_jac_kernel
// :1375 (reached through shapenet_fwd_jac :1459, call :1524, when so >= si;
// the chain is _fwd_jac_layers :1279):
//   wb' [G, ldwb] f32 (omega_0 folded into the sine-fed weights by the
//   wrapper, at wb's dtype, then widened to f32 and its rows padded to 4
//   floats, as K1 and K7 read it), x [G, P, si]  ->  y [G, P, so],
//   jac [G, P, so, si] in x's dtype T,
// the si forward tangent streams stacked under the value rows of every
// product. K5's reverse body (so < si, the flagship's 1 < 3) is
// shapenet_fwd.cu's, beside K1; nif_shapenet_fwd_jac refuses it. The float32
// policy's Jacobian evaluation of every so >= si model runs this body;
// bf16 runs the tensor-core one of shapenet_jac_tc.cu where its geometry
// takes the chain, and this one on the rest (vanilla chains, wide planes).
// K6 replaces _sobolev_kernel (reached through shapenet_sobolev_grads): the
// stacked forward with its residuals, the masked and weighted value and
// Jacobian squared errors, and the backward through the tangent chain
// (_sobolev_backward_chain), whose curvature term multiplies by act''.
//   wb' [G, ldwb] f32 (at wb's dtype, then widened)  ->  value and Jacobian
//   sums / n_y, n_j (f32), d_wb [G, po] in T, the sine-fed weight grads
//   multiplied back by omega_0 in f32.
// The float32 policy's Sobolev step runs K6 here; bf16 runs the tensor-core
// K6 of shapenet_jac_tc.cu where its geometry takes the chain, and this
// source on the rest (vanilla chains, si > 4, wide planes).
//
// The stacked state: a tile holds (1 + si) streams, stream 0 the values and
// stream 1 + k the tangents d/dx_k; every hidden product runs over all the
// tile's stacked rows at once. S (the input of each product) is stored
// rounded to T, since every use rounds it; the running state U (resblock
// and shortcut sums) and the raw products Z stay f32, as the reference
// keeps them.
//
// What bounds them on an H100 SXM: operations. At the flagship train shape
// (G=32, P=32768, width 128, two hidden layers, si=3, so=1) K6 is 829.5
// GFLOP of products: three passes (forward, dW, dS) of the hidden and last
// products over all 1 + si streams, 3 x 276.0, and the first layer's x @ W0
// on the value rows in the forward and in dW0, 2 x 0.8 (the tangent seeds are
// elementwise, and no dx is formed); K5's tangent body at si = so = 3 is
// 278.9 GFLOP. Every product is an f32 FMA on the CUDA cores (a bf16 x bf16
// product is exact in f32, and the f32 path must not use TF32), so the
// 67 TFLOP/s f32 peak bounds K6 at ~12.8 ms and K5's tangent body at ~4.3.
//
// K6 and K5's tangent body for si <= 4: one body template,
// sob_simt_kernel<T, SI, ACT, TRAIN, RES>, on the f32 tile machinery of
// stack_simt.cuh (K8's design in shapenet_hess.cu without the pair streams);
// K5's tangent body is its forward half (TRAIN = false), as K7 is K8's.
// - A tile is 16 points (32 at si = 1) of 1 + si stacked streams, row
//   q * NPT + p stream q of point p; thread (rg, cg) of SimtTile<(1 + si)
//   PPT, 32, 1> owns PPT points' streams by 4 columns of a 128-column block,
//   so the forward epilogue (act, act' from one call) and the backward one
//   (act', act'') run on the product's registers. The streams and the
//   activation (the true sine from one non-inlined exact sincosf for f32,
//   the polynomial for bf16, act3's switch for vanilla chains) are
//   compile-time; plain or resblock is a flag read once a layer. Wider
//   chains loop over 128-column blocks. The forward half takes no act'':
//   its d2 is dead code.
// - K6's planes [R, ld] f32: every hidden product's S input and the last
//   one's and every hidden Z; the backward writes each layer's D over its Z
//   in place; S_0 is elementwise in x, so from nm = 2 on it shares S_2's
//   plane and app 0's epilogue recomputes it into S_1's (not for vanilla
//   chains, whose shortcut cotangents, like a resblock's skip cotangents,
//   wait in the S plane of the output they belong to once its dW has freed
//   it). At the flagship four planes (135 KB) sit in shared memory beside
//   two 18 KB weight buffers (32-row chunks); wider or deeper chains, and
//   bf16 (its shapes are those the tensor-core K6 refuses), keep them in a
//   per-block slice of a global scratch (RES = 0).
// - K5's planes: two S planes, ping-ponged (a resblock's second app reads
//   the block's input from the plane its output overwrites, element by
//   element), and U for bf16 resblock and vanilla chains; no Z, D, partials
//   or reduce. Its last product and the y and jac
//   stores read the thread's own rows of the last S plane (its own writes:
//   no barrier): per-thread column sums, three xor shuffles and a
//   fixed-order sum over the four warps along a row (stack_simt.cuh's
//   row_sums, over stacked rows). At si = so = 3, width 128, its two planes
//   (68 KB), two 18 KB weight buffers and the row sums fit two blocks an SM.
// - The products of a tile form one stream of W chunks through cp.async,
//   one barrier a chunk; dW = S^T D sums all stacked rows into the block's
//   own f32 partial [po4], whose old values it loads before the products.
// - K6's grid is (S, G) with S = SMs / G splits of a group's tiles: one wave
//   of one block per SM; a second kernel sums the S partials of each group,
//   and the two losses, in a fixed order. No float atomics: two runs on the
//   same inputs give the same bits. K5's is one wave of blocks (two an SM
//   where their shared memory fits) over every group's tiles, each block a
//   contiguous run; its outputs are per point, so two runs give the same
//   bits whatever the split.
// K6 and K5's tangent body for si > 4 keep the first port's design
// (stacked_kernel; the register tile holds at most ten streams): the tile
// products of shapenet_common.cuh, a thread rows tr*RM .. by columns tc,
// tc+32, ..., element-wise passes over the tile, residuals in shared memory
// where they fit, K6's partials per block and the ordered split reduce.
// scripts/port_phase_probe.py --kernel k6f32 (or k5tanf32) splits the f32
// K6 (or K5 tangent) tile's time by phase; PERF.md has the split.
#include "stack_simt.cuh"

namespace {

constexpr int kMaxSplits = 8;        // K6 point-tile runs per group
constexpr int kMaxJacSplits = 64;    // K5 tangent-body point-tile runs per group (no reduction)
constexpr int kWChunkFloats = 4096;  // staged weight floats per chunk

// Kernel bodies: keep in step with _MODES in ops/fused_derivatives.py
// (kReverse runs in shapenet_fwd.cu; this source refuses it).
enum Mode : int { kReverse = 0, kTangent = 1, kSobolev = 2 };

struct Args {
  const float* wb;       // wb' [G, ldwb], f32
  const void* x;         // [G, P, si], T
  void* y;               // K5: [G, P, so], T
  void* jac;             // K5: [G, P, so, si], T
  const void* target;    // K6: [G, P, so], T
  const void* jt;        // K6: [G, P, si*so], T, column k*so + j = d y_j / d x_k
  const float* y_mask;   // K6: [so] 0/1, or null
  const float* jac_mask; // K6: [si*so] 0/1, or null
  const void* weight;    // K6: [G, P], T, or null
  float* partials;       // K6: [G, S, po] weight-grad partials, then [G, S, 2] loss partials
  void* scratch;         // residuals of each block when they live in global memory
  float ky, kj;          // K6: 2 w_value / n_y, 2 w_jac / n_j
  int G, P, si, so, n, n_mats, chain, act, kc, tile;
  long long po, ldwb, resid_bytes;  // resid_bytes per block
  int resid_in_smem;
};

// K5's tangent body (SOB = false) and K6 (SOB = true): the stacked forward;
// then K5 writes y and jac, and K6 forms the two squared-error sums and runs
// the stacked backward into the block's partials.
template <typename T, int RM, int RN, bool SOB>
__global__ void __launch_bounds__(kThreads) stacked_kernel(const Args a) {
  using TW = float;  // the weights are f32 (exact for bf16 ones)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, si = a.si, so = a.so, n_mats = a.n_mats;
  const int tp = a.tile, ns = si + 1, tr = ns * tp;
  const bool resblock = a.chain == kSirenResblock;
  const size_t plane = (size_t)tr * n;
  float* ws = reinterpret_cast<float*>(smem_raw);  // [kc, n + 1] staged weights
  float* U = ws + a.kc * (n + 1);                   // [tr, n] running state; dS in the backward
  float* O = U + plane;                             // [tr, so] last product; D_out in K6
  float* D = O + tr * so;                           // K6: [tr, n] lift(D) of an app
  float* DH = D + (SOB ? plane : 0);                // K6 resblock: [tr, n] dS of the block's h
  float* DZV = DH + (SOB && resblock ? plane : 0);  // K6: [tp, n] the unrounded value-row dz
  float* work_end = DZV + (SOB ? tp * n : 0);
  unsigned char* work_end_b = reinterpret_cast<unsigned char*>(work_end);
  const size_t work_bytes = (size_t)(work_end_b - smem_raw);
  float* Z0 = reinterpret_cast<float*>(residuals(a, smem_raw + ((work_bytes + 15) / 16) * 16));
  float* Zr = Z0 + (SOB ? tp * n : 0);               // [n_mats or 1][tr, n] raw products, f32
  T* X = reinterpret_cast<T*>(Zr + (SOB ? n_mats : 1) * plane);  // [tp, si]
  T* Sr = X + tp * si;                               // [n_mats + 1 or 2][tr, n] lift(S)
  auto Splane = [&](int m) { return Sr + (SOB ? m : (m & 1)) * plane; };
  auto Zplane = [&](int m) { return Zr + (SOB ? m : 0) * plane; };

  const int tc = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int r0 = warp * RM;
  const int S = gridDim.x, s = blockIdx.x;
  const int n_tiles = (a.P + tp - 1) / tp;
  const int t_begin = (int)((long long)s * n_tiles / S);
  const int t_end = (int)((long long)(s + 1) * n_tiles / S);

  const long long o_wh = (long long)si * n;
  const long long o_wl = o_wh + (long long)n_mats * n * n;
  const long long o_b0 = o_wl + (long long)n * so;
  const long long o_bh = o_b0 + n;
  const long long o_bl = o_bh + (long long)n_mats * n;

  for (int g = blockIdx.y; g < a.G; g += gridDim.y) {
    const TW* wg = a.wb + (long long)g * a.ldwb;
    const TW* wl = wg + o_wl;
    float* part = SOB ? a.partials + ((long long)g * S + s) * a.po : nullptr;
    float loss[2] = {0.f, 0.f};  // value, Jacobian
    for (int tile = t_begin; tile < t_end; ++tile) {
      const bool first = tile == t_begin;
      const int p0 = tile * tp;
      const int rows = min(tp, a.P - p0);
      const long long row0 = (long long)g * a.P + p0;
      __syncthreads();  // the previous tile has finished with every buffer
      const T* xg = static_cast<const T*>(a.x) + row0 * si;
      for (int idx = threadIdx.x; idx < tp * si; idx += kThreads)
        X[idx] = idx < rows * si ? xg[idx] : from_f32<T>(0.f);
      __syncthreads();

      // ---- first layer: z0 = x @ W0' + b0; values act(z0), seeds act'(z0) W0'[k]
      {
        T* S0 = Splane(0);
        for (int e = threadIdx.x; e < tp * n; e += kThreads) {
          const int r = e / n;
          const int c = e - r * n;
          float z = 0.f;
          for (int k = 0; k < si; ++k) z = fmaf(to_f32(X[r * si + k]), to_f32(wg[k * n + c]), z);
          z += to_f32(wg[o_b0 + c]);
          float d1, d2;
          const float v = act3(z, a.act, &d1, &d2);
          if (SOB) Z0[e] = z;
          U[e] = v;
          S0[e] = from_f32<T>(v);
          for (int k = 0; k < si; ++k) {
            const int o = ((k + 1) * tp + r) * n + c;
            const float t = d1 * to_f32(wg[k * n + c]);
            U[o] = t;
            S0[o] = from_f32<T>(t);
          }
        }
      }

      // ---- hidden products over all tr stacked rows
      for (int m = 0; m < n_mats; ++m) {
        float acc[RM][RN];
        matmul_fwd<T, TW, RM, RN>(Splane(m), n, n, tr, wg + o_wh + (long long)m * n * n, n, ws,
                                  a.kc, r0, tc, acc);
        float* Z = Zplane(m);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            const int c = tc + j * kLanes;
            if (r0 + i < tr && c < n) Z[(r0 + i) * n + c] = acc[i][j];
          }
        __syncthreads();  // Z is complete
        const bool res_first = resblock && m % 2 == 0;
        const bool res_second = resblock && m % 2 == 1;
        T* Sn = Splane(m + 1);
        const TW* bm = wg + o_bh + (long long)m * n;
        for (int e = threadIdx.x; e < tp * n; e += kThreads) {
          const int r = e / n;
          const int c = e - r * n;
          float gd, hd;
          const float av = act3(Z[e] + to_f32(bm[c]), a.act, &gd, &hd);
          for (int st = 0; st < ns; ++st) {
            const int o = (st * tp + r) * n + c;
            float v = st == 0 ? av : gd * Z[o];
            if (res_first) {  // h = [act(z1); act'(z1) Z1_k] feeds the second matrix
              Sn[o] = from_f32<T>(v);
              continue;
            }
            if (res_second) {
              v = 0.5f * (U[o] + v);
            } else if (a.chain == kVanilla) {
              v = v + U[o];
            }
            U[o] = v;
            Sn[o] = from_f32<T>(v);
          }
        }
      }
      __syncthreads();  // the last stacked input is complete

      // ---- last product O = lift(S) @ W_last over all tr rows
      const T* Sl = Splane(n_mats);
      for (int pr = warp; pr < tr * so; pr += kWarps) {
        const int row = pr / so;
        const int j = pr - row * so;
        float sum = 0.f;
        for (int k = tc; k < n; k += kLanes)
          sum = fmaf(to_f32(Sl[row * n + k]), to_f32(wl[(long long)k * so + j]), sum);
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (tc == 0) O[pr] = sum;
      }
      __syncthreads();  // O is complete

      if (!SOB) {
        // ---- K5: y = O[values] + b_last; jac[r][j][k] = O[tangent k][r][j]
        T* yg = static_cast<T*>(a.y) + row0 * so;
        for (int idx = threadIdx.x; idx < rows * so; idx += kThreads)
          yg[idx] = from_f32<T>(O[idx] + to_f32(wg[o_bl + idx % so]));
        T* jg = static_cast<T*>(a.jac) + row0 * so * si;
        for (int idx = threadIdx.x; idx < rows * so * si; idx += kThreads) {
          const int r = idx / (so * si);
          const int rem = idx - r * so * si;
          const int j = rem / si;
          const int k = rem - j * si;
          jg[idx] = from_f32<T>(O[((k + 1) * tp + r) * so + j]);
        }
        continue;
      }

      // ---- K6 loss: err = mask (out - target), e_k = mask (O_k - jt_k);
      // sums w err^2, w e^2; D_out = [ky w err; kj w e_k] in place of O
      {
        const T* tg = static_cast<const T*>(a.target) + row0 * so;
        const T* jtg = static_cast<const T*>(a.jt) + row0 * si * so;
        const T* wt = a.weight ? static_cast<const T*>(a.weight) + row0 : nullptr;
        for (int idx = threadIdx.x; idx < tp * so; idx += kThreads) {
          const int r = idx / so;
          const int j = idx - r * so;
          const bool live = r < rows;
          const float w = live && wt ? to_f32(wt[r]) : 1.f;
          float dv = 0.f;
          if (live) {
            float err = O[idx] + to_f32(wg[o_bl + j]) - to_f32(tg[idx]);
            if (a.y_mask) err = err * a.y_mask[j];
            loss[0] += err * err * w;
            dv = a.ky * err * w;
          }
          O[idx] = dv;
          for (int k = 0; k < si; ++k) {
            const int o = ((k + 1) * tp + r) * so + j;
            float dj = 0.f;
            if (live) {
              float e = O[o] - to_f32(jtg[(long long)r * si * so + k * so + j]);
              if (a.jac_mask) e = e * a.jac_mask[k * so + j];
              loss[1] += e * e * w;
              dj = a.kj * e * w;
            }
            O[o] = dj;
          }
        }
      }
      __syncthreads();  // D_out is complete

      // ---- last layer: dW_l = lift(S)^T lift(D_out), db_l = sum of the
      // value rows of D_out, dS = lift(D_out) @ W_l^T
      for (int idx = threadIdx.x; idx < n * so; idx += kThreads) {
        const int k = idx / so;
        const int j = idx - k * so;
        float sum = 0.f;
        for (int row = 0; row < tr; ++row)
          sum = fmaf(to_f32(Sl[row * n + k]), lift<T>(O[row * so + j]), sum);
        accumulate(part + o_wl + idx, sum, first);
      }
      for (int j = threadIdx.x; j < so; j += kThreads) {
        float sum = 0.f;
        for (int r = 0; r < tp; ++r) sum += O[r * so + j];
        accumulate(part + o_bl + j, sum, first);
      }
      for (int e = threadIdx.x; e < tr * n; e += kThreads) {
        const int row = e / n;
        const int c = e - row * n;
        float v = 0.f;
        for (int j = 0; j < so; ++j)
          v = fmaf(lift<T>(O[row * so + j]), to_f32(wl[(long long)c * so + j]), v);
        U[e] = v;
      }
      __syncthreads();  // dS is complete

      // ---- hidden apps, last to first
      for (int m = n_mats - 1; m >= 0; --m) {
        const bool res_second = resblock && m % 2 == 1;
        const bool res_first = resblock && m % 2 == 0;
        const float* src = res_first ? DH : U;
        const float scale = res_second ? 0.5f : 1.f;
        const float* Z = Zplane(m);
        const TW* bm = wg + o_bh + (long long)m * n;
        // dz = scale du act'(z) + sum_k (scale dt_k) Z_k act''(z);
        // D = [dz; (scale dt_k) act'(z)]
        for (int e = threadIdx.x; e < tp * n; e += kThreads) {
          const int r = e / n;
          const int c = e - r * n;
          float gd, hd;
          act3(Z[e] + to_f32(bm[c]), a.act, &gd, &hd);
          float dz = (scale * src[e]) * gd;
          for (int k = 0; k < si; ++k) {
            const int o = ((k + 1) * tp + r) * n + c;
            const float dt = scale * src[o];
            dz = dz + dt * Z[o] * hd;
            D[o] = lift<T>(dt * gd);
          }
          D[e] = lift<T>(dz);
          DZV[e] = dz;
        }
        __syncthreads();  // D and DZV are complete
        weight_grad<T, RM, RN>(Splane(m), n, n, D, n, tr, part + o_wh + (long long)m * n * n,
                               first, warp, tc);
        bias_grad(DZV, n, tp, part + o_bh + (long long)m * n, first);
        float acc[RM][RN];
        matmul_bwd<TW, RM, RN>(D, n, wg + o_wh + (long long)m * n * n, n, tr, ws, a.kc, r0, tc,
                               acc);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            const int c = tc + j * kLanes;
            if (r0 + i >= tr || c >= n) continue;
            const int o = (r0 + i) * n + c;
            if (res_second) {
              DH[o] = acc[i][j];
            } else if (res_first) {
              U[o] = acc[i][j] + 0.5f * U[o];  // the skip path
            } else if (a.chain == kVanilla) {
              U[o] = acc[i][j] + U[o];  // the shortcut passes dS straight through
            } else {
              U[o] = acc[i][j];
            }
          }
        __syncthreads();  // dS (or the block's dh) is complete
      }

      // ---- first layer: dz0 = du act'(z0) + sum_k dt_k W0'[k] act''(z0);
      // dW0[k] = x[:, k]^T lift(dz0) + sum_r dt_k act'(z0) (the seeds)
      for (int e = threadIdx.x; e < tp * n; e += kThreads) {
        const int r = e / n;
        const int c = e - r * n;
        float gd, hd;
        act3(Z0[e], a.act, &gd, &hd);
        float dz = U[e] * gd;
        for (int k = 0; k < si; ++k) {
          const int o = ((k + 1) * tp + r) * n + c;
          const float dt = U[o];
          dz = dz + dt * to_f32(wg[k * n + c]) * hd;
          D[o] = dt * gd;
        }
        D[e] = lift<T>(dz);
        DZV[e] = dz;
      }
      __syncthreads();
      for (int idx = threadIdx.x; idx < si * n; idx += kThreads) {
        const int k = idx / n;
        const int c = idx - k * n;
        float s1 = 0.f, s2 = 0.f;
        for (int r = 0; r < tp; ++r) {
          s1 = fmaf(to_f32(X[r * si + k]), D[r * n + c], s1);
          s2 += D[((k + 1) * tp + r) * n + c];
        }
        accumulate(part + idx, s1 + s2, first);
      }
      bias_grad(DZV, n, tp, part + o_b0, first);
    }

    if (SOB)  // the block's two loss partials, after its [G, S, po] weight grads
      store_loss_partials(loss, ws,
                          a.partials + (long long)a.G * S * a.po + ((long long)g * S + s) * 2);
  }
}

// ---- K6 and K5's tangent body for si <= 4 on the f32 tile machinery of
// stack_simt.cuh

constexpr int kSobMaxSi = 4;      // the stacked tile's streams, 1 + si, in registers
constexpr int kSobMaxSplits = 64;  // K6's point-tile runs per group
constexpr int kSobMaxChunk = 32;   // weight rows (or columns) per staged chunk
constexpr int kSix = 4;            // the x tile's row stride
constexpr int kTanBlocksPerSm = 2;  // K5's blocks per SM where their shared memory allows

__host__ __device__ constexpr long long round4(long long v) { return (v + 3) / 4 * 4; }

// A tile of NPT points: thread (rg, cg) owns PPT points (rg + RG pp) by 4
// columns of a 128-column block, each point's 1 + SI streams, so every
// epilogue runs in its registers; row q * NPT + p of the tile is stream q of
// point p (accumulator q * PPT + pp of the register tile).
template <int SI>
struct SobTile {
  static constexpr int NS = 1 + SI;
  static constexpr int PPT = SI == 1 ? 4 : 2;  // a thread's points: RM = NS * PPT <= 10
  using L = SimtTile<NS * PPT, 32, 1>;
  static constexpr int NPT = PPT * L::RG;
};
constexpr int kCols = SobTile<1>::L::COLS;  // the columns of a block of a product
constexpr int kWarpsAlong = SobTile<1>::L::CW / 8;  // the warps along a row of a tile

inline int sob_tile_points(int si) { return (si == 1 ? 4 : 2) * (kThreads / kLanes); }

// Built with -DK6F_PHASE_CLOCKS (by scripts/port_phase_probe.py only), thread
// 0 of every block adds the clock64() cycles from one mark to the next into
// ten phase counters (K5's tangent body the first four), which split the
// block's critical path.
constexpr int kPhases = 10;
#ifdef K6F_PHASE_CLOCKS
__device__ unsigned long long k6f_phase_cycles[kPhases];
#define K6F_PHASE(i)                                       \
  do {                                                     \
    if (threadIdx.x == 0) {                                \
      const long long now = clock64();                     \
      phase_sum[i] += (unsigned long long)(now - phase_t); \
      phase_t = now;                                       \
    }                                                      \
  } while (0)
#else
#define K6F_PHASE(i) \
  do {               \
  } while (0)
#endif

// The vanilla chain's activation with its first two derivatives (act3's
// switch); the sine chains take stack_simt.cuh's ExactSineHess (f32) or
// PolySineHess (bf16), whose d012 gives the same three.
struct AnyAct3 {
  int act;
  __device__ explicit AnyAct3(int code) : act(code) {}
  __device__ __forceinline__ float d012(float z, float* d1, float* d2) const {
    return act3(z, act, d1, d2);
  }
};

struct SobArgs {
  const float* wb;        // wb' [G, ldwb], f32
  const void* x;          // [G, P, si], T
  void* y;                // K5: [G, P, so], T
  void* jac;              // K5: [G, P, so, si], T
  const void* target;     // K6: [G, P, so], T
  const void* jt;         // K6: [G, P, si*so], T, column k*so + j = d y_j / d x_k
  const float* y_mask;    // K6: [so] 0/1, or null
  const float* jac_mask;  // K6: [si*so] 0/1, or null
  const void* weight;     // K6: [G, P], T, or null
  float* partials;        // K6: [G, S, po4] weight-grad partials, then [G, S, 2] loss partials
  float* scratch;         // the planes of each block when they live in global memory
  float ky, kj;           // K6: 2 w_value / n_y, 2 w_jac / n_j
  int G, P, so, n, n_mats, chain, act, ld, kc, stage_buf;
  long long ldwb, po4, resid_floats;  // resid_floats per block
};

// z0 = x @ W0' + b0 at one column; the forward and the first layer's
// backward evaluate it alike, so they agree to the bit.
template <int SI>
__device__ __forceinline__ float sob_first_z(const float* x, const float (&w)[SI], float b) {
  float z = 0.f;
#pragma unroll
  for (int k = 0; k < SI; ++k) z = fmaf(x[k], w[k], z);
  return z + b;
}

// The first layer's streams at one column: the value act(z0), the tangent
// seeds act'(z0) W0'[k].
template <int SI, class ACT>
__device__ __forceinline__ void sob_first_layer(const ACT& act, const float* x,
                                                const float (&w)[SI], float b,
                                                float (&v)[1 + SI]) {
  float d1, d2;
  v[0] = act.d012(sob_first_z<SI>(x, w, b), &d1, &d2);
#pragma unroll
  for (int k = 0; k < SI; ++k) v[1 + k] = d1 * w[k];
}

// K6 (TRAIN = true): the stacked forward with its residuals, the two
// squared-error sums and the stacked backward into the block's partials.
// K5's tangent body (TRAIN = false): the stacked forward on two ping-ponged
// S planes, then y and jac from the row sums of the last product.
// ACT: the sine (the true one for f32, the polynomial for bf16) of a plain
// or resblock SIREN chain (a flag read once a layer), or AnyAct3, the
// vanilla chain. RES: 1 = the planes in shared memory, 0 = in the block's
// slice of a global scratch.
template <typename T, int SI, class ACT, bool TRAIN, int RES>
__global__ void __launch_bounds__(kThreads, TRAIN ? 1 : kTanBlocksPerSm)
    sob_simt_kernel(const SobArgs a) {
  using Tile = SobTile<SI>;
  using L = typename Tile::L;
  constexpr int NS = Tile::NS, PPT = Tile::PPT, NPT = Tile::NPT;
  constexpr int R = L::TP;  // a tile's stacked rows, NS * NPT
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr bool kVan = std::is_same<ACT, AnyAct3>::value;
  extern __shared__ __align__(16) float smem[];
  const int n = a.n, so = a.so, nm = a.n_mats, ld = a.ld;
  const bool resblock = !kVan && a.chain == kSirenResblock;
  const bool carry_u = !kF32 && (kVan || resblock);  // bf16: the running state in U
  const int n4 = (n + 3) / 4 * 4;
  const int ncb = (n + kCols - 1) / kCols;
  const size_t plane = (size_t)R * ld;
  const ACT act(a.act);
  // the block's planes (sob_geometry() and tan_geometry() lay them out alike)
  float* res = RES == 1 ? smem
                        : a.scratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                                          (size_t)a.resid_floats;
  const bool share = TRAIN && !kVan && nm >= 2;  // S_0 shares S_2's plane (K6)
  const int n_s = TRAIN ? (share ? nm : nm + 1) : (nm > 0 ? 2 : 1);
  float* Sp = res;                                   // the S planes
  float* Zp = Sp + (size_t)n_s * plane;              // K6: the raw products Z, then D
  float* U = Zp + (TRAIN ? (size_t)nm * plane : 0);  // bf16 resblock and vanilla: the f32 state
  float* DZV = U + (carry_u ? plane : 0);            // bf16 K6: [NPT, ld] the value rows' dz
  float* X = DZV + (!kF32 && TRAIN ? (size_t)NPT * ld : 0);  // [NPT, kSix] the x tile
  float* O = X + NPT * kSix;  // K6: [R, so] the last product, then D_out
  float* wbuf = smem + (RES == 1 ? a.resid_floats : 0);
  float* red = wbuf + 2 * a.stage_buf;  // K5: [kRed][CW / 8][R] the row sums
  float* S0 = Sp;  // S_0's plane: S_2's in K6's forward, S_1's in its backward (share)
  auto Splane = [&](int m) {
    return m == 0 ? S0 : Sp + (size_t)(TRAIN ? (share ? m - 1 : m) : (m & 1)) * plane;
  };
  auto Zplane = [&](int m) { return Zp + (size_t)m * plane; };
  const bool vec = n % 4 == 0;
  WStage st{wbuf, a.stage_buf, a.kc, vec, 0};
  const Slot<L> sl;
  // the offset of stream q of the thread's point pp in a plane of row stride ld
  auto row = [&](int q, int pp) { return (q * NPT + pp * L::RG + sl.rg) * ld; };

  const int tc = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int tpg = (a.P + NPT - 1) / NPT;  // tiles a group

  const long long o_wh = (long long)SI * n;
  const long long o_wl = o_wh + (long long)nm * n * n;
  const long long o_b0 = o_wl + (long long)n * so;
  const long long o_bh = o_b0 + n;
  const long long o_bl = o_bh + (long long)nm * n;
  const int nsteps = (TRAIN ? 2 : 1) * nm * ncb;  // the products of a tile
#ifdef K6F_PHASE_CLOCKS
  unsigned long long phase_sum[kPhases] = {};
  long long phase_t = clock64();
#endif
  // The products of a tile in order, each staging the next one's first
  // chunk of W: steps 0 .. nm ncb - 1 the forward products (matrix m,
  // column block cb), then (K6) the cotangent products of m = nm - 1 .. 0
  // (output block cb), then the next tile's step 0 (of its own group).
  auto stage_step = [&](const float* wg, int step, float* buf) {
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

  // K6: a run of tiles of each group gr = blockIdx.y, + gridDim.y, ...
  // (split blockIdx.x of gridDim.x), t indexing the group's tiles; K5: one
  // run over every group's tiles, t indexing them all
  using TileIndex = std::conditional_t<TRAIN, int, long long>;
  for (int gr = TRAIN ? blockIdx.y : 0; gr < (TRAIN ? a.G : 1); gr += TRAIN ? gridDim.y : 1) {
    const long long total = TRAIN ? tpg : (long long)a.G * tpg;
    const TileIndex t_begin = (TileIndex)(blockIdx.x * total / gridDim.x);
    const TileIndex t_end = (TileIndex)((blockIdx.x + 1) * total / gridDim.x);
    // the group of tile t, and the weights of a group
    auto group = [&](TileIndex t) { return TRAIN ? gr : (int)(t / tpg); };
    auto weights = [&](int g) { return a.wb + (long long)g * a.ldwb; };
    float* part = TRAIN ? a.partials + ((long long)gr * gridDim.x + blockIdx.x) * a.po4 : nullptr;
    const float* wg_run = weights(group(t_begin));  // K6: every tile's (its group's)
    __syncthreads();  // the previous group is done with the weight buffers
    if (nsteps > 0 && t_begin < t_end) {
      stage_step(wg_run, 0, st.ws + st.parity * st.buf);
      cp_commit();
    }
    float loss[2] = {0.f, 0.f};  // K6: value, Jacobian
    for (TileIndex t = t_begin; t < t_end; ++t) {
      const bool first = t == t_begin;
      const int g = group(t);
      const float* wg = TRAIN ? wg_run : weights(g);
      const float* W0 = wg;
      const float* WL = wg + o_wl;
      const float* B0 = wg + o_b0;
      const float* BL = wg + o_bl;
      int step = 0;
      const auto next = [&](float* buf) {  // stages the step after `step`
        if (step + 1 < nsteps)
          stage_step(wg, step + 1, buf);
        else if (t + 1 < t_end)
          stage_step(TRAIN ? wg : weights(group(t + 1)), 0, buf);
      };
      const int p0 = (int)(TRAIN ? t : t - (long long)g * tpg) * NPT;
      const int rows = min(NPT, a.P - p0);
      const long long row0 = (long long)g * a.P + p0;
      __syncthreads();  // the previous tile has finished with every plane
      S0 = share ? Sp + plane : Sp;
      for (int idx = threadIdx.x; idx < NPT * kSix; idx += kThreads) {
        const int r = idx / kSix, k = idx % kSix;
        X[idx] = r < rows && k < SI ? to_f32(static_cast<const T*>(a.x)[(row0 + r) * SI + k])
                                    : 0.f;
      }
      __syncthreads();

      // ---- first layer: z0 = x @ W0' + b0; values act(z0), tangent seeds
      // act'(z0) W0'[k]
      for (int c0 = 0; c0 < n; c0 += kCols) {
        const int c = c0 + sl.vcol(0, 0);
        if (c >= n) continue;
        float w[4][SI], b[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live = c + e < n;
#pragma unroll
          for (int k = 0; k < SI; ++k) w[e][k] = live ? W0[k * n + c + e] : 0.f;
          b[e] = live ? B0[c + e] : 0.f;
        }
#pragma unroll
        for (int pp = 0; pp < PPT; ++pp) {
          float v[NS][4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float ve[NS];
            sob_first_layer<SI>(act, X + (pp * L::RG + sl.rg) * kSix, w[e], b[e], ve);
#pragma unroll
            for (int q = 0; q < NS; ++q) v[q][e] = ve[q];
          }
#pragma unroll
          for (int q = 0; q < NS; ++q) {
            *reinterpret_cast<float4*>(Splane(0) + row(q, pp) + c) =
                make_float4(lift<T>(v[q][0]), lift<T>(v[q][1]), lift<T>(v[q][2]), lift<T>(v[q][3]));
            if (carry_u)
              *reinterpret_cast<float4*>(U + row(q, pp) + c) =
                  make_float4(v[q][0], v[q][1], v[q][2], v[q][3]);
          }
        }
      }
      K6F_PHASE(0);  // the x tile and the first layer

      // ---- hidden products, then their epilogues on the product's
      // registers (the value layout): new value act(z), new tangents act'(z)
      // Z_k; a resblock's first matrix feeds its output on, the second
      // averages it with the block's input, the vanilla chain adds its input
      for (int m = 0; m < nm; ++m) {
        const bool carry = kVan || (resblock && m % 2 == 1);
        const float* Wm = wg + o_wh + (long long)m * n * n;
        const float* bm = wg + o_bh + (long long)m * n;
        float* Sn = Splane(m + 1);
        // the chain's state before this app: f32 chains keep it as their S
        // plane (with share, or K5's two planes, a resblock's block input lies
        // in the plane this output overwrites, element by element)
        const float* u_in = carry_u ? U : Splane(kVan || m == 0 ? m : m - 1);
        for (int c0 = 0; c0 < n; c0 += kCols) {
          Acc<L> acc;
          product_fwd<L>(Splane(m), ld, n4, Wm + c0, n, n, n - c0, st, sl, acc, next);
          ++step;
          K6F_PHASE(1);  // a hidden forward product
          const int c = c0 + sl.vcol(0, 0);
          if (c < n) {
            if (TRAIN) {
#pragma unroll
              for (int i = 0; i < L::RM; ++i)
                *reinterpret_cast<float4*>(Zplane(m) + (size_t)sl.row(i) * ld + c) =
                    make_float4(acc[i][0][0], acc[i][0][1], acc[i][0][2], acc[i][0][3]);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float bias = c + e < n ? bm[c + e] : 0.f;
#pragma unroll
              for (int pp = 0; pp < PPT; ++pp) {
                float d1, d2;
                const float f = act.d012(acc[pp][0][e] + bias, &d1, &d2);
#pragma unroll
                for (int k = 0; k < SI; ++k)
                  acc[(1 + k) * PPT + pp][0][e] = d1 * acc[(1 + k) * PPT + pp][0][e];
                acc[pp][0][e] = f;
              }
            }
#pragma unroll
            for (int i = 0; i < L::RM; ++i) {
              const size_t o = (size_t)sl.row(i) * ld + c;
              float4 v = make_float4(acc[i][0][0], acc[i][0][1], acc[i][0][2], acc[i][0][3]);
              if (carry) {
                const float4 u = *reinterpret_cast<const float4*>(u_in + o);
                v = kVan ? make_float4(v.x + u.x, v.y + u.y, v.z + u.z, v.w + u.w)
                         : make_float4(0.5f * (u.x + v.x), 0.5f * (u.y + v.y),
                                       0.5f * (u.z + v.z), 0.5f * (u.w + v.w));
                if (carry_u) *reinterpret_cast<float4*>(U + o) = v;
              }
              *reinterpret_cast<float4*>(Sn + o) =
                  make_float4(lift<T>(v.x), lift<T>(v.y), lift<T>(v.z), lift<T>(v.w));
            }
          }
          K6F_PHASE(2);  // thread 0's hidden forward epilogue
        }
      }
      const float* Sl = Splane(nm);

      if constexpr (!TRAIN) {
        // ---- K5: O = lift(S) @ W_last from the thread's own rows of the
        // last S plane (its own writes), summed across the row; y = O[values]
        // + b_last, jac[r][j][k] = O[tangent k][r][j]
        T* yg = static_cast<T*>(a.y) + row0 * so;
        T* jg = static_cast<T*>(a.jac) + row0 * so * SI;
        for (int j0 = 0; j0 < so; j0 += kRed) {
          const int nq = min(kRed, so - j0);
          float sums[kRed][L::RM];
#pragma unroll
          for (int q = 0; q < kRed; ++q)
#pragma unroll
            for (int i = 0; i < L::RM; ++i) sums[q][i] = 0.f;
          for (int c0 = 0; c0 < n; c0 += kCols) {
            const int c = c0 + sl.vcol(0, 0);
            if (c >= n) continue;
            float w[kRed][4];
#pragma unroll
            for (int q = 0; q < kRed; ++q)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                w[q][e] = q < nq && c + e < n ? WL[(long long)(c + e) * so + j0 + q] : 0.f;
#pragma unroll
            for (int i = 0; i < L::RM; ++i) {
              const float4 s = *reinterpret_cast<const float4*>(Sl + (size_t)sl.row(i) * ld + c);
#pragma unroll
              for (int q = 0; q < kRed; ++q) {
                float v = fmaf(s.x, w[q][0], sums[q][i]);
                v = fmaf(s.y, w[q][1], v);
                v = fmaf(s.z, w[q][2], v);
                sums[q][i] = fmaf(s.w, w[q][3], v);
              }
            }
          }
          row_sums<L>(sums, nq, R, red, sl, [&](int r, int q, float v) {
            const int stream = r / NPT, p = r - stream * NPT;
            if (p >= rows) return;
            if (stream == 0)
              yg[(long long)p * so + j0 + q] = from_f32<T>(v + BL[j0 + q]);
            else
              jg[((long long)p * so + j0 + q) * SI + stream - 1] = from_f32<T>(v);
          });
        }
        K6F_PHASE(3);  // the last product and the y and jac stores
        continue;
      }
      __syncthreads();  // the last S plane is complete

      // ---- last product O = lift(S) @ W_last over all R rows, one warp per
      // (row, output)
      for (int pr = warp; pr < R * so; pr += kWarps) {
        const int rr = pr / so;
        const int j = pr - rr * so;
        float sum = 0.f;
        for (int k = tc; k < n; k += kLanes)
          sum = fmaf(Sl[(size_t)rr * ld + k], WL[(long long)k * so + j], sum);
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (tc == 0) O[pr] = sum;
      }
      __syncthreads();  // O is complete

      // ---- loss: err = mask (out - target), e_k = mask (O_k - jt_k); sums
      // w err^2, w e^2; D_out = [ky w err; kj w e_k] in place of O (zero past
      // the ragged edge)
      {
        const T* tg = static_cast<const T*>(a.target) + row0 * so;
        const T* jtg = static_cast<const T*>(a.jt) + row0 * SI * so;
        const T* wt = a.weight ? static_cast<const T*>(a.weight) + row0 : nullptr;
        for (int idx = threadIdx.x; idx < NPT * so; idx += kThreads) {
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
#pragma unroll
          for (int k = 0; k < SI; ++k) {
            const int o = ((1 + k) * NPT + r) * so + jo;
            float dj = 0.f;
            if (live) {
              float e = O[o] - to_f32(jtg[(long long)r * SI * so + k * so + jo]);
              if (a.jac_mask) e = e * a.jac_mask[k * so + jo];
              loss[1] += e * e * w;
              dj = a.kj * e * w;
            }
            O[o] = dj;
          }
        }
      }
      __syncthreads();  // D_out is complete
      K6F_PHASE(3);     // the last product and the loss

      // ---- last layer: dW_l = lift(S)^T lift(D_out), db_l = the sum of
      // D_out's value rows
      for (int idx = threadIdx.x; idx < n * so; idx += kThreads) {
        const int k = idx / so;
        const int j = idx - k * so;
        tile_sum<R>(part + o_wl + idx, first, [&](int r, float sum) {
          return fmaf(Sl[(size_t)r * ld + k], lift<T>(O[r * so + j]), sum);
        });
      }
      for (int j = kThreads - 1 - threadIdx.x; j < so; j += kThreads)  // the last threads
        tile_sum<NPT>(part + o_bl + j, first,
                      [&](int r, float sum) { return sum + O[r * so + j]; });
      __syncthreads();  // the last S plane is free (a skip cotangent may go there)
      K6F_PHASE(4);     // the last layer's backward

      // ---- backward, last app to first: the cotangent cot of app m's output
      // (the input of app m + 1, or of the last layer) column block by
      // column block in the grad layout, then app m's epilogue on it (m = -1:
      // the first layer's), then app m's dW and db over the whole tile. A
      // cotangent that a later app adds to (a resblock's skip path, the
      // vanilla shortcut) waits in the S plane of the output it belongs to,
      // which that plane's dW has freed.
      for (int m = nm - 1; m >= -1; --m) {
        if (share && m == 0) S0 = Sp;  // app 0's epilogue recomputes S_0 there
        for (int c0 = 0; c0 < n; c0 += kCols) {
          Acc<L> cot;
          if (m == nm - 1) {  // dS = lift(D_out) @ W_l^T
#pragma unroll
            for (int i = 0; i < L::RM; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int k = c0 + sl.gcol(0, j);
                float v = 0.f;
                if (k < n)
                  for (int jo = 0; jo < so; ++jo)
                    v = fmaf(lift<T>(O[sl.row(i) * so + jo]), WL[(long long)k * so + jo], v);
                cot[i][0][j] = v;
              }
          } else {  // dS = D_{m+1} @ W_{m+1}^T
            product_bwd<L>(Zplane(m + 1), ld, wg + o_wh + (long long)(m + 1) * n * n +
                                                   (long long)c0 * n,
                           n - c0, n, st, sl, cot, next);
            ++step;
            K6F_PHASE(7);  // a dS product
            // + 0.5 the cotangent of the resblock's output (the skip path),
            // or + the cotangent of the vanilla app's output (its shortcut)
            const bool skip = resblock && (m + 1) % 2 == 0;
            if (skip || kVan) {
              const float* dv = Splane(kVan ? m + 2 : m + 3);
              const float f = kVan ? 1.f : 0.5f;
#pragma unroll
              for (int i = 0; i < L::RM; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  const int c = c0 + sl.gcol(0, j);
                  if (c < n) cot[i][0][j] = cot[i][0][j] + f * dv[(size_t)sl.row(i) * ld + c];
                }
            }
          }
          if (m >= 0) {
            // with du, dt_k the scaled cotangents of the app's output streams:
            // dz = du act' + sum_k dt_k Z_k act''; D = [dz; dt_k act'], each
            // rounded to T, over Z
            const bool keep = kVan || (resblock && m % 2 == 1);  // a later app adds to cot
            const float scale = resblock && m % 2 == 1 ? 0.5f : 1.f;
            float* Z = Zplane(m);
            const float* bm = wg + o_bh + (long long)m * n;
            float* dv = Splane(m + 1);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c = c0 + sl.gcol(0, j);
              if (c >= n) continue;
              const float bias = bm[c];
#pragma unroll
              for (int pp = 0; pp < PPT; ++pp) {
                float d1, d2;
                act.d012(Z[row(0, pp) + c] + bias, &d1, &d2);
                float dz = (scale * cot[pp][0][j]) * d1;
#pragma unroll
                for (int k = 0; k < SI; ++k) {
                  float* zk = Z + row(1 + k, pp) + c;
                  const float dt = scale * cot[(1 + k) * PPT + pp][0][j];
                  dz = dz + dt * *zk * d2;
                  *zk = lift<T>(dt * d1);
                }
                Z[row(0, pp) + c] = lift<T>(dz);
                if (!kF32) DZV[(pp * L::RG + sl.rg) * ld + c] = dz;
                if (keep) {
#pragma unroll
                  for (int q = 0; q < NS; ++q) dv[row(q, pp) + c] = cot[q * PPT + pp][0][j];
                }
              }
              if (share && m == 0) {  // S_0 for dW_0, as the forward made it
                float w[SI];
#pragma unroll
                for (int k = 0; k < SI; ++k) w[k] = W0[k * n + c];
#pragma unroll
                for (int pp = 0; pp < PPT; ++pp) {
                  float v[NS];
                  sob_first_layer<SI>(act, X + (pp * L::RG + sl.rg) * kSix, w, B0[c], v);
#pragma unroll
                  for (int q = 0; q < NS; ++q) S0[row(q, pp) + c] = lift<T>(v[q]);
                }
              }
            }
            K6F_PHASE(5);  // a backward epilogue
          } else {
            // the first layer: dz0 = du act'(z0) + sum_k dt_k W0'[k]
            // act''(z0); the seed rows of dW0 collect dt_k act'(z0); both
            // into the first S plane, for the sums below
            float* SC = Splane(0);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c = c0 + sl.gcol(0, j);
              if (c >= n) continue;
              float w[SI];
#pragma unroll
              for (int k = 0; k < SI; ++k) w[k] = W0[k * n + c];
              const float b = B0[c];
#pragma unroll
              for (int pp = 0; pp < PPT; ++pp) {
                float d1, d2;
                act.d012(sob_first_z<SI>(X + (pp * L::RG + sl.rg) * kSix, w, b), &d1, &d2);
                float dz = cot[pp][0][j] * d1;
#pragma unroll
                for (int k = 0; k < SI; ++k) {
                  const float dt = cot[(1 + k) * PPT + pp][0][j];
                  dz = dz + dt * w[k] * d2;
                  SC[row(1 + k, pp) + c] = dt * d1;
                }
                SC[row(0, pp) + c] = dz;
              }
            }
          }
        }
        __syncthreads();  // app m's D (or the first layer's rows) is complete
        if (m >= 0) {
          weight_grad_rows<8, L>(Splane(m), ld, n, Zplane(m), ld, n,
                                 part + o_wh + (long long)m * n * n, first, vec, sl);
          const float* dzv = kF32 ? Zplane(m) : DZV;  // the value rows' unrounded dz
          for (int c = kThreads - 1 - threadIdx.x; c < n; c += kThreads)
            tile_sum<NPT>(part + o_bh + (long long)m * n + c, first,
                          [&](int r, float sum) { return sum + dzv[(size_t)r * ld + c]; });
          K6F_PHASE(6);  // a hidden dW and db, partial updates included
        } else {
          // dW0 = lift(x)^T lift(dz0) + the seed rows, db0 = the sum of dz0
          const float* SC = Splane(0);
          for (int idx = threadIdx.x; idx < SI * n; idx += kThreads) {
            const int k = idx / n;
            const int c = idx - k * n;
            float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
            for (int r = 0; r < NPT; ++r) {
              s1 = fmaf(X[r * kSix + k], lift<T>(SC[(size_t)r * ld + c]), s1);
              s2 += SC[(size_t)((1 + k) * NPT + r) * ld + c];
            }
            part[idx] = first ? s1 + s2 : part[idx] + (s1 + s2);
          }
          for (int c = kThreads - 1 - threadIdx.x; c < n; c += kThreads)
            tile_sum<NPT>(part + o_b0 + c, first,
                          [&](int r, float sum) { return sum + SC[(size_t)r * ld + c]; });
          K6F_PHASE(8);  // the first layer's backward
        }
      }
    }

    if (TRAIN) {  // the block's two loss partials, after the [G, S, po4] weight grads
      store_loss_partials(loss, wbuf,
                          a.partials + (long long)a.G * gridDim.x * a.po4 +
                              ((long long)gr * gridDim.x + blockIdx.x) * 2);
      K6F_PHASE(9);  // the group's loss partials
    }
  }
#ifdef K6F_PHASE_CLOCKS
  if (threadIdx.x == 0)
    for (int i = 0; i < kPhases; ++i) atomicAdd(&k6f_phase_cycles[i], phase_sum[i]);
#endif
}


// d_wb[g][p] = T((sum_s partial[g][s][p]) * (p < n_scaled ? omega : 1)), the
// S splits summed in order; then one thread per loss sums its G*S partials
// (laid out [G, S, 2] after the [G, S, po4] weight grads) in order and
// divides by its norm. No float atomics: two runs give the same bits.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sob_reduce_kernel(const float* __restrict__ partials, int G, int S, long long po,
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
  if (blockIdx.x == 0 && threadIdx.x < 2) {
    const float* lp = partials + (long long)G * S * po4 + threadIdx.x;
    float sum = 0.f;
    for (long long i = 0; i < (long long)G * S; ++i) sum += lp[2 * i];
    losses[threadIdx.x] = sum / norms.n[threadIdx.x];
  }
}

struct SobGeometry {
  int tile, ld, kc, stage_buf, splits, grid_g, resid_in_smem;
  size_t smem, resid_floats;
};

// The geometry of K6 for si <= 4: the planes of a block (floats, laid out as
// the kernel reads them: the S planes (S_0 in S_2's from nm = 2 on, but for
// the vanilla chain), the Z planes, the f32 state of bf16 resblock and
// vanilla chains, bf16's value-row dz, the x tile and the last product), in
// shared memory beside the two weight buffers where they fit (f32 only),
// else in a per-block slice of a global scratch; the chunk is the largest of
// 32, 24, 16, 8 rows that fits. Status: 0 = ok, 1 = too wide (above 1024
// columns), 2 = even the weight buffers exceed a block's shared memory, 3 =
// bad shape.
int sob_geometry(int n, int si, int so, int n_mats, int chain, int elem, int G, int P,
                 SobGeometry* g) {
  if (n < 1 || si < 1 || si > kSobMaxSi || so < 1 || n_mats < 0 || G < 1 || P < 1 ||
      (chain != kSirenPlain && chain != kSirenResblock && chain != kVanilla) ||
      (chain == kSirenResblock && n_mats % 2))
    return 3;
  if (n > kMaxRn * kLanes) return 1;
  const bool f32 = elem == 4, vanilla = chain == kVanilla;
  const int npt = sob_tile_points(si);
  const size_t rows = (size_t)(1 + si) * npt;
  g->tile = npt;
  g->ld = (n + 31) / 32 * 32 + 4;
  const size_t plane = rows * g->ld;
  const size_t n_s = !vanilla && n_mats >= 2 ? n_mats : n_mats + 1;
  g->resid_floats = (n_s + n_mats + (!f32 && chain != kSirenPlain ? 1 : 0)) * plane +
                    (f32 ? 0 : (size_t)npt * g->ld) + (size_t)npt * kSix +
                    round4((long long)rows * so);
  auto bytes = [&](bool resid, int kc) {
    return sizeof(float) * ((resid ? g->resid_floats : 0) + 2 * (size_t)stage_floats(kCols, kc));
  };
  g->resid_in_smem = f32 && bytes(true, 8) <= kMaxSmem;
  const int widest = (n + 7) / 8 * 8;
  g->kc = 0;
  for (int kc = kSobMaxChunk; kc >= 8; kc -= 8)
    if ((kc <= widest || kc == 8) && bytes(g->resid_in_smem, kc) <= kMaxSmem) {
      g->kc = kc;
      break;
    }
  if (g->kc == 0) return 2;
  g->stage_buf = stage_floats(kCols, g->kc);
  g->smem = bytes(g->resid_in_smem, g->kc);
  const int n_tiles = (P + npt - 1) / npt;
  const int sms = sm_count();
  int splits = sms > G ? sms / G : 1;
  splits = splits < kSobMaxSplits ? splits : kSobMaxSplits;
  g->splits = splits < n_tiles ? splits : n_tiles;
  g->grid_g = G < 65535 ? G : 65535;
  return 0;
}

template <typename T, int SI, class ACT>
int launch_sob(const SobGeometry& geo, SobArgs a, T* d_wb, float* losses, long long po,
               long long n_scaled, float omega, LossNorms norms, cudaStream_t stream) {
  void (*kernel)(SobArgs) = sob_simt_kernel<T, SI, ACT, true, 0>;
  if constexpr (std::is_same<T, float>::value)
    if (geo.resid_in_smem) kernel = sob_simt_kernel<T, SI, ACT, true, 1>;
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
  if (err != cudaSuccess) return (int)err;
  sob_reduce_kernel<T><<<stride_blocks((long long)a.G * po), kThreads, 0, stream>>>(
      a.partials, a.G, geo.splits, po, a.po4, n_scaled, omega, norms, d_wb, losses);
  return (int)cudaGetLastError();
}

struct TanGeometry {
  int tile, ld, kc, stage_buf, blocks, per_sm, resid_in_smem;
  size_t smem, resid_floats;
};

// The geometry of K5's tangent body for si <= 4: the block's planes (floats,
// laid out as the kernel reads them: two S planes, or one without hidden
// layers, U for bf16 resblock and vanilla chains, and the x tile), in
// shared memory beside the two weight buffers and the row sums where they
// fit (f32 only; bf16's shapes are those the tensor-core body refuses), else
// in a per-block slice of a global scratch; two blocks per SM where both fit
// in an SM's shared memory, else one; the chunk is the largest of 32, 24,
// 16, 8 rows that fits. One wave of blocks covers every group's tiles.
// Status: 0 = ok, 1 = too wide (above 1024 columns), 2 = even the weight
// buffers and the row sums exceed a block's shared memory, 3 = bad shape.
int tan_geometry(int n, int si, int so, int n_mats, int chain, int elem, int G, int P,
                 TanGeometry* g) {
  if (n < 1 || si < 1 || si > kSobMaxSi || so < si || n_mats < 0 || G < 1 || P < 1 ||
      (chain != kSirenPlain && chain != kSirenResblock && chain != kVanilla) ||
      (chain == kSirenResblock && n_mats % 2))
    return 3;
  if (n > kMaxRn * kLanes) return 1;
  const bool f32 = elem == 4;
  const int npt = sob_tile_points(si);
  const size_t rows = (size_t)(1 + si) * npt;
  g->tile = npt;
  g->ld = (n + 31) / 32 * 32 + 4;
  const size_t plane = rows * g->ld;
  g->resid_floats = ((n_mats > 0 ? 2 : 1) + (!f32 && chain != kSirenPlain ? 1 : 0)) * plane +
                    (size_t)npt * kSix;
  const size_t red = (size_t)kRed * kWarpsAlong * rows;
  auto bytes = [&](bool resid, int kc) {
    return sizeof(float) *
           ((resid ? g->resid_floats : 0) + 2 * (size_t)stage_floats(kCols, kc) + red);
  };
  g->per_sm = kTanBlocksPerSm == 2 && bytes(f32, 8) <= kHalfSmSmem ? 2 : 1;
  const size_t limit = g->per_sm == 2 ? kHalfSmSmem : kMaxSmem;
  g->resid_in_smem = f32 && bytes(true, 8) <= limit;
  const int widest = (n + 7) / 8 * 8;
  g->kc = 0;
  for (int kc = kSobMaxChunk; kc >= 8; kc -= 8)
    if ((kc <= widest || kc == 8) && bytes(g->resid_in_smem, kc) <= limit) {
      g->kc = kc;
      break;
    }
  if (g->kc == 0) {
    g->smem = bytes(false, 8);
    return 2;
  }
  g->stage_buf = stage_floats(kCols, g->kc);
  g->smem = bytes(g->resid_in_smem, g->kc);
  const long long tiles = (long long)G * ((P + npt - 1) / npt);
  const long long want = (long long)sm_count() * g->per_sm;
  g->blocks = (int)(tiles < want ? tiles : want);
  return 0;
}

template <typename T, int SI, class ACT>
int launch_tan(const TanGeometry& geo, SobArgs a, cudaStream_t stream) {
  void (*kernel)(SobArgs) = sob_simt_kernel<T, SI, ACT, false, 0>;
  if constexpr (std::is_same<T, float>::value)  // bf16's planes sit in the scratch
    if (geo.resid_in_smem) kernel = sob_simt_kernel<T, SI, ACT, false, 1>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
  if (err != cudaSuccess) return (int)err;
  a.ld = geo.ld;
  a.kc = geo.kc;
  a.stage_buf = geo.stage_buf;
  a.resid_floats = (long long)geo.resid_floats;
  kernel<<<geo.blocks, kThreads, geo.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <class A>
struct ActTag {
  using type = A;
};

// go(T{}, integral_constant<si>, ActTag<ACT>{}) for the instance of a chain:
// f32 sine chains take the true sine, bf16 ones the polynomial (its degree
// chosen once a kernel), the vanilla chain its activation code; the streams
// are si's.
template <typename GO>
int with_instance(int si, int dtype, int chain, int act, GO&& go) {
  const bool vanilla = chain == kVanilla;
  if (!vanilla && (dtype == 0 ? act != kSineExact : act != kSinePoly7 && act != kSinePoly9))
    return (int)cudaErrorInvalidValue;
  auto by_act = [&](auto t, auto si_c) {
    using Sine = std::conditional_t<std::is_same<decltype(t), float>::value, ExactSineHess,
                                    PolySineHess>;
    return vanilla ? go(t, si_c, ActTag<AnyAct3>{}) : go(t, si_c, ActTag<Sine>{});
  };
  auto by_si = [&](auto t) {
    switch (si) {
      case 1: return by_act(t, std::integral_constant<int, 1>{});
      case 2: return by_act(t, std::integral_constant<int, 2>{});
      case 3: return by_act(t, std::integral_constant<int, 3>{});
      case 4: return by_act(t, std::integral_constant<int, 4>{});
      default: return (int)cudaErrorInvalidValue;
    }
  };
  return dtype == 0 ? by_si(float{}) : by_si(__nv_bfloat16{});
}

int run_sob(const SobGeometry& geo, const SobArgs& a, int si, int dtype, void* d_wb,
            float* losses, long long po, long long n_scaled, float omega, LossNorms norms,
            cudaStream_t s) {
  return with_instance(si, dtype, a.chain, a.act, [&](auto t, auto si_c, auto act) {
    using T = decltype(t);
    return launch_sob<T, decltype(si_c)::value, typename decltype(act)::type>(
        geo, a, static_cast<T*>(d_wb), losses, po, n_scaled, omega, norms, s);
  });
}

int run_tan(const TanGeometry& geo, const SobArgs& a, int si, int dtype, cudaStream_t s) {
  return with_instance(si, dtype, a.chain, a.act, [&](auto t, auto si_c, auto act) {
    return launch_tan<decltype(t), decltype(si_c)::value, typename decltype(act)::type>(geo, a,
                                                                                        s);
  });
}

struct Geometry {
  int rn, tile, kc, splits, grid_g, resid_in_smem;
  size_t smem, resid_bytes;
};

// Status of a shape: 0 = ok, 1 = too wide, 2 = the working buffers exceed a
// block's shared memory, 3 = bad shape (the reverse body among them), 4 = the
// 1 + si stacked streams do not fit the tile's rows.
int geometry(int mode, int n, int si, int so, int n_mats, int chain, int G, int P, int elem,
             Geometry* g) {
  if (n < 1 || si < 1 || so < 1 || n_mats < 0 || G < 1 || P < 1 || mode < kTangent ||
      mode > kSobolev || (chain == kSirenResblock && n_mats % 2))
    return 3;
  const int rn = columns_per_thread(n);
  if (rn == 0) return 1;
  g->rn = rn;
  const int rows = rows_per_thread(rn) * kWarps;
  g->kc = kWChunkFloats / n > 1 ? kWChunkFloats / n : 1;
  const bool sob = mode == kSobolev;
  g->tile = rows / (si + 1);
  if (g->tile < 1) return 4;
  const size_t tp = g->tile, tr = (size_t)(si + 1) * g->tile;
  size_t work = sizeof(float) * ((size_t)g->kc * (n + 1) + tr * n + tr * so +
                                 (sob ? tr * n + (chain == kSirenResblock ? tr * n : 0) + tp * n
                                      : 0));
  size_t resid = sizeof(float) * ((sob ? tp * n : 0) + (sob ? (size_t)n_mats : 1) * tr * n) +
                 (size_t)elem * (tp * si + (sob ? (size_t)n_mats + 1 : 2) * tr * n);
  work = (work + 15) / 16 * 16;
  resid = (resid + 15) / 16 * 16;
  const int n_tiles = (P + g->tile - 1) / g->tile;
  int want = kMaxSplits;
  if (mode != kSobolev) {
    want = (2 * sm_count() + G - 1) / G;  // about two blocks per SM when G is small
    want = want < kMaxSplits ? kMaxSplits : (want > kMaxJacSplits ? kMaxJacSplits : want);
  }
  g->splits = n_tiles < want ? n_tiles : want;
  g->grid_g = G < 65535 ? G : 65535;
  g->resid_bytes = resid;
  g->resid_in_smem = work + resid <= kMaxSmem;
  g->smem = g->resid_in_smem ? work + resid : work;
  return g->smem > kMaxSmem ? 2 : 0;
}

template <typename T, int RN>
int launch_jac(const Geometry& geo, Args a, cudaStream_t stream) {
  constexpr int RM = rows_per_thread(RN);
  auto kernel = stacked_kernel<T, RM, RN, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(geo.splits, geo.grid_g), kThreads, geo.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int RN>
int launch_sobolev(const Geometry& geo, Args a, T* d_wb, float* losses, long long n_scaled,
                   float omega, float n_y, float n_j, cudaStream_t stream) {
  constexpr int RM = rows_per_thread(RN);
  auto kernel = stacked_kernel<T, RM, RN, true>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(geo.splits, geo.grid_g), kThreads, geo.smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_split_reduce<T, 2>(a.partials, a.G, geo.splits, a.po, n_scaled, omega,
                                   LossNorms{{n_y, n_j}}, d_wb, losses, stream);
}

Args prepared(Args a, const Geometry& g) {
  a.kc = g.kc;
  a.tile = g.tile;
  a.resid_bytes = (long long)g.resid_bytes;
  a.resid_in_smem = g.resid_in_smem;
  return a;
}

template <typename T>
int dispatch_jac(const Geometry& g, const Args& a, cudaStream_t s) {
  return with_rn(g.rn, [&](auto rn) { return launch_jac<T, decltype(rn)::value>(g, a, s); });
}

template <typename T>
int dispatch_sobolev(const Geometry& g, const Args& a, void* d_wb, float* losses,
                     long long n_scaled, float omega, float n_y, float n_j, cudaStream_t s) {
  T* out = static_cast<T*>(d_wb);
  return with_rn(g.rn, [&](auto rn) {
    return launch_sobolev<T, decltype(rn)::value>(g, a, out, losses, n_scaled, omega, n_y, n_j,
                                                       s);
  });
}

}  // namespace

extern "C" {

// The geometry of one body (mode 1 = K5 tangent, 2 = K6; 0, K5's reverse
// body, is shapenet_fwd.cu's and gets status 3) at [G, P] in dtype (0 =
// float, 1 = bf16) (a status as the body's geometry returns; on 0, 2 and 4
// the outputs are written): the body (1 = sob_simt_kernel, si <= 4; 0 =
// stacked_kernel), points per tile, P splits per group (K5's si <= 4 body:
// the blocks of its one wave over every group's tiles), blocks per SM,
// dynamic shared memory per block, the f32 partials the caller allocates
// for K6 (G*S*po weight grads, then G*S*2 losses; 0 for K5) and the bytes of
// residual scratch (0 when the residuals fit in shared memory).
int nif_shapenet_jac_workspace(int mode, int n, int si, int so, int n_mats, int chain, int G,
                               int P, int dtype, int* body, int* tile, int* splits,
                               int* blocks_per_sm, long long* smem_bytes,
                               long long* partial_floats, long long* scratch_bytes) {
  const long long po = (long long)n_mats * n * n + (long long)(si + so + 1 + n_mats) * n + so;
  const int elem = dtype == 0 ? 4 : 2;
  *body = si <= kSobMaxSi;
  *blocks_per_sm = 1;
  if (mode == kTangent && si <= kSobMaxSi) {
    TanGeometry g{};
    const int status = tan_geometry(n, si, so, n_mats, chain, elem, G, P, &g);
    if (status != 0 && status != 2) return status;
    *tile = g.tile;
    *splits = status == 0 ? g.blocks : 0;
    *blocks_per_sm = g.per_sm;
    *smem_bytes = (long long)g.smem;
    *partial_floats = 0;
    *scratch_bytes = status != 0 || g.resid_in_smem
                         ? 0
                         : (long long)g.blocks * (long long)g.resid_floats *
                               (long long)sizeof(float);
    return status;
  }
  if (mode == kSobolev && si <= kSobMaxSi) {
    SobGeometry g{};
    const int status = sob_geometry(n, si, so, n_mats, chain, elem, G, P, &g);
    if (status != 0 && status != 2) return status;
    *tile = g.tile;
    *splits = g.splits;
    *smem_bytes = (long long)g.smem;
    *partial_floats = (long long)G * g.splits * (round4(po) + 2);
    *scratch_bytes = g.resid_in_smem ? 0
                                     : (long long)g.grid_g * g.splits *
                                           (long long)g.resid_floats * (long long)sizeof(float);
    return status;
  }
  Geometry g{};
  const int status = geometry(mode, n, si, so, n_mats, chain, G, P, elem, &g);
  if (status == 1 || status == 3) return status;
  *tile = g.tile;
  *splits = g.splits;
  *smem_bytes = (long long)g.smem;
  *partial_floats = mode == kSobolev ? (long long)G * g.splits * (po + 2) : 0;
  *scratch_bytes = g.resid_in_smem ? 0 : (long long)g.grid_g * g.splits * (long long)g.resid_bytes;
  return status;
}

// K5's tangent body (so >= si; so < si, the reverse body, is refused: it
// runs in shapenet_fwd.cu). wb' is f32 with row stride ldwb (a multiple of
// 4, >= po); dtype: 0 = float, 1 = bf16 (x, y and jac share it). si <= 4
// runs sob_simt_kernel's forward half, wider inputs stacked_kernel. Returns
// the CUDA error of the launch (0 on success); the kernel runs
// asynchronously on `stream`.
int nif_shapenet_fwd_jac(const void* wb, const void* x, void* y, void* jac, void* scratch, int G,
                         int P, int si, int so, int n, int n_mats, int chain, int act,
                         long long po, long long ldwb, int dtype, void* stream) {
  if (dtype < 0 || dtype > 1 || so < si || ldwb < po || ldwb % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (si <= kSobMaxSi) {
    TanGeometry tg{};
    if (tan_geometry(n, si, so, n_mats, chain, dtype == 0 ? 4 : 2, G, P, &tg) != 0)
      return (int)cudaErrorInvalidValue;
    SobArgs a{};
    a.wb = static_cast<const float*>(wb);
    a.x = x;
    a.y = y;
    a.jac = jac;
    a.scratch = static_cast<float*>(scratch);
    a.G = G; a.P = P; a.so = so; a.n = n; a.n_mats = n_mats;
    a.chain = chain; a.act = act; a.ldwb = ldwb;
    return run_tan(tg, a, si, dtype, s);
  }
  Geometry g{};
  if (geometry(kTangent, n, si, so, n_mats, chain, G, P, dtype == 0 ? 4 : 2, &g) != 0)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.wb = static_cast<const float*>(wb);
  a.x = x;
  a.y = y;
  a.jac = jac;
  a.scratch = scratch;
  a.G = G; a.P = P; a.si = si; a.so = so; a.n = n; a.n_mats = n_mats;
  a.chain = chain; a.act = act; a.po = po; a.ldwb = ldwb;
  a = prepared(a, g);
  if (dtype == 0) return dispatch_jac<float>(g, a, s);
  return dispatch_jac<__nv_bfloat16>(g, a, s);
}

// K6. wb' is f32 with row stride ldwb (a multiple of 4, >= po); dtype: 0 =
// float, 1 = bf16 (x, target, jt, weight and d_wb share it); y_mask,
// jac_mask and weight may be null. losses receives [value_mse, jac_mse].
// si <= 4 runs sob_simt_kernel, wider inputs stacked_kernel.
int nif_shapenet_sobolev_grads(const void* wb, const void* x, const void* target, const void* jt,
                               const void* y_mask, const void* jac_mask, const void* weight,
                               void* losses, void* d_wb, void* partials, void* scratch, int G,
                               int P, int si, int so, int n, int n_mats, int chain, int act,
                               long long po, long long ldwb, long long n_scaled, float omega,
                               float ky, float kj, float n_y, float n_j, int dtype,
                               void* stream) {
  if (dtype < 0 || dtype > 1 || ldwb < po || ldwb % 4 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(losses);
  if (si <= kSobMaxSi) {
    SobGeometry sg{};
    if (sob_geometry(n, si, so, n_mats, chain, dtype == 0 ? 4 : 2, G, P, &sg) != 0)
      return (int)cudaErrorInvalidValue;
    SobArgs a{};
    a.wb = static_cast<const float*>(wb);
    a.x = x;
    a.target = target;
    a.jt = jt;
    a.y_mask = static_cast<const float*>(y_mask);
    a.jac_mask = static_cast<const float*>(jac_mask);
    a.weight = weight;
    a.partials = static_cast<float*>(partials);
    a.scratch = static_cast<float*>(scratch);
    a.ky = ky;
    a.kj = kj;
    a.G = G; a.P = P; a.so = so; a.n = n; a.n_mats = n_mats;
    a.chain = chain; a.act = act; a.ldwb = ldwb;
    return run_sob(sg, a, si, dtype, d_wb, l, po, n_scaled, omega, LossNorms{{n_y, n_j}}, s);
  }
  Geometry g{};
  if (dtype < 0 || dtype > 1 ||
      geometry(kSobolev, n, si, so, n_mats, chain, G, P, dtype == 0 ? 4 : 2, &g) != 0)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.wb = static_cast<const float*>(wb);
  a.x = x;
  a.target = target;
  a.jt = jt;
  a.y_mask = static_cast<const float*>(y_mask);
  a.jac_mask = static_cast<const float*>(jac_mask);
  a.weight = weight;
  a.partials = static_cast<float*>(partials);
  a.scratch = scratch;
  a.ky = ky;
  a.kj = kj;
  a.G = G; a.P = P; a.si = si; a.so = so; a.n = n; a.n_mats = n_mats;
  a.chain = chain; a.act = act; a.po = po; a.ldwb = ldwb;
  a = prepared(a, g);
  if (dtype == 0) return dispatch_sobolev<float>(g, a, d_wb, l, n_scaled, omega, n_y, n_j, s);
  return dispatch_sobolev<__nv_bfloat16>(g, a, d_wb, l, n_scaled, omega, n_y, n_j, s);
}

#ifdef K6F_PHASE_CLOCKS
// The phase counters summed over every block since the last call, then
// zeroed (the probe build only).
int nif_jac_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k6f_phase_cycles, sizeof(k6f_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[kPhases] = {};
  return (int)cudaMemcpyToSymbol(k6f_phase_cycles, zero, sizeof(zero));
}
#endif

const char* nif_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
