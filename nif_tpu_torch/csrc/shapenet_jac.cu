// K5 and K6 on Hopper: the fused Jacobian and the fused Sobolev train pass of
// the grouped ShapeNet chain, in one source (one nvcc build).
//
// K5 replaces nif_tpu/ops/pallas_shapenet.py::_fwd_jac_rev_kernel and
// _fwd_jac_kernel (reached through shapenet_fwd_jac):
//   wb' [G, po] (omega_0 folded into the sine-fed weights by the wrapper),
//   x [G, P, si]  ->  y [G, P, so], jac [G, P, so, si] in x's dtype T.
// With so < si (the flagship's 1 < 3) the reverse body runs: the
// residual-saving forward of K2 (keeping only the activation derivatives),
// then so dx-only cotangent sweeps from the one-hot last-layer column, with
// du in f32 and each dz rounded to T before its product (_jac_rev_layers).
// Otherwise the tangent body runs the si forward tangent streams stacked
// under the value rows of every product (_fwd_jac_layers).
// K6 replaces _sobolev_kernel (reached through shapenet_sobolev_grads): the
// stacked forward with its residuals, the masked and weighted value and
// Jacobian squared errors, and the backward through the tangent chain
// (_sobolev_backward_chain), whose curvature term multiplies by act''.
//   -> value and Jacobian sums / n_y, n_j (f32), d_wb [G, po] in T, the
//   sine-fed weight grads multiplied back by omega_0 in f32.
//
// The stacked state: a tile of TP points holds (1 + si) streams of TP rows,
// stream 0 the values and stream 1 + k the tangents d/dx_k, TR = (1 + si) TP
// rows in all; every hidden product runs over all TR rows at once. S (the
// input of each product) is stored rounded to T, since every use rounds it;
// the running state U (resblock and shortcut sums) and the raw products Z
// stay f32, as the reference keeps them.
//
// What bounds them on an H100 SXM: operations. At the flagship train shape
// (G=32, P=32768, width 128, two hidden layers, si=3, so=1) K6 is 829.5
// GFLOP of products: three passes (forward, dW, dS) of the hidden and last
// products over all 1 + si streams, 3 x 276.0, and the first layer's x @ W0
// on the value rows in the forward and in dW0, 2 x 0.8 (the tangent seeds are
// elementwise, and no dx is formed). That is ~0.84 ms at the 989 TFLOP/s
// bf16 tensor-core peak; the K5 reverse body is 139.3 GFLOP (~0.14 ms). As
// in K1-K3 every product here is an f32 FMA on the CUDA cores (a bf16 x bf16
// product is exact in f32, and the f32 path must not use TF32), so the f32
// FMA rate bounds this design far above those numbers; tensor cores are
// later work. The shared helpers (activations, tile products, partials) are
// in shapenet_common.cuh.
//
// Layout of the work: the grid is (S, G); block (s, g) takes group g and
// the s-th of S contiguous runs of point tiles. Thread (warp tr, lane tc)
// owns rows tr*RM .. tr*RM+RM-1 of a tile and columns tc, tc+32, ... of
// each product (as in K1-K3); element-wise passes (activations, tangents,
// the curvature term) stride over the tile's points and walk the streams of
// each. A tile's residuals sit in shared memory when they fit (the flagship
// in bf16: 123 KB of 213 KB) and otherwise in a per-block slice of a global
// scratch. K6 adds each tile's weight and bias grads, and its two loss sums,
// into the block's own f32 partials in tile order; a second kernel sums the
// S partials of each group in a fixed order. No float atomics: two runs on
// the same inputs give the same bits.
#include "shapenet_common.cuh"

namespace {

constexpr int kMaxSplits = 8;        // K6 point-tile runs per group
constexpr int kMaxJacSplits = 64;    // K5 point-tile runs per group (no reduction)
constexpr int kWChunkFloats = 4096;  // staged weight floats per chunk

// Kernel bodies: keep in step with _MODES in ops/fused_derivatives.py.
enum Mode : int { kReverse = 0, kTangent = 1, kSobolev = 2 };

struct Args {
  const void* wb;        // wb' [G, po], T
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
  long long po, resid_bytes;  // resid_bytes per block
  int resid_in_smem;
};

// K5, reverse body. Per tile: the forward of K2, keeping the layer input H
// (one buffer) and each activated layer's derivative D[m] rounded to T; y
// from the last layer; then for each output j a dx-only sweep from du =
// W_last[:, j] down to jac[:, j, :] = lift(du * D[0]) @ W0'^T.
template <typename T, int RM, int RN>
__global__ void __launch_bounds__(kThreads) jac_reverse_kernel(const Args a) {
  constexpr int TP = RM * kWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, si = a.si, so = a.so, n_mats = a.n_mats;
  float* DZ = reinterpret_cast<float*>(smem_raw);  // [TP, n] lifted dz, f32
  float* ws = DZ + TP * n;                          // [kc, n + 1] staged weights
  T* X = reinterpret_cast<T*>(residuals(a, reinterpret_cast<unsigned char*>(ws + a.kc * (n + 1))));
  T* H = X + TP * si;  // [TP, n] the current layer input
  T* D = H + TP * n;   // [n_mats + 1][TP, n] activation derivatives
  const size_t plane = (size_t)TP * n;

  const int tc = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int r0 = warp * RM;
  const int S = gridDim.x, s = blockIdx.x;
  const int n_tiles = (a.P + TP - 1) / TP;
  const int t_begin = (int)((long long)s * n_tiles / S);
  const int t_end = (int)((long long)(s + 1) * n_tiles / S);

  const long long o_wh = (long long)si * n;
  const long long o_wl = o_wh + (long long)n_mats * n * n;
  const long long o_b0 = o_wl + (long long)n * so;
  const long long o_bh = o_b0 + n;
  const long long o_bl = o_bh + (long long)n_mats * n;

  for (int g = blockIdx.y; g < a.G; g += gridDim.y) {
    const T* wg = static_cast<const T*>(a.wb) + (long long)g * a.po;
    const T* wl = wg + o_wl;
    for (int tile = t_begin; tile < t_end; ++tile) {
      const int p0 = tile * TP;
      const int rows = min(TP, a.P - p0);
      const long long row0 = (long long)g * a.P + p0;
      __syncthreads();  // the previous tile has finished with every buffer
      const T* xg = static_cast<const T*>(a.x) + row0 * si;
      for (int idx = threadIdx.x; idx < TP * si; idx += kThreads)
        X[idx] = idx < rows * si ? xg[idx] : from_f32<T>(0.f);

      // ---- forward, saving D[m] and the current input H
      float acc[RM][RN], u[RM][RN], bias[RN];
      matmul_fwd<T, T, RM, RN>(X, si, si, TP, wg, n, ws, a.kc, r0, tc, acc);
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int c = tc + j * kLanes;
        bias[j] = c < n ? to_f32(wg[o_b0 + c]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int c = tc + j * kLanes;
          float d, d2;
          u[i][j] = act3(acc[i][j] + bias[j], a.act, &d, &d2);
          if (c < n) {
            D[(r0 + i) * n + c] = from_f32<T>(d);
            H[(r0 + i) * n + c] = from_f32<T>(u[i][j]);
          }
        }
      for (int m = 0; m < n_mats; ++m) {
        // ends with a barrier: H may be overwritten below
        matmul_fwd<T, T, RM, RN>(H, n, n, TP, wg + o_wh + (long long)m * n * n, n, ws, a.kc, r0,
                                 tc, acc);
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int c = tc + j * kLanes;
          bias[j] = c < n ? to_f32(wg[o_bh + (long long)m * n + c]) : 0.f;
        }
        T* Dm = D + (m + 1) * plane;
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            const int c = tc + j * kLanes;
            float d, d2;
            const float y = act3(acc[i][j] + bias[j], a.act, &d, &d2);
            float next;
            if (a.chain == kSirenResblock && m % 2 == 0) {
              next = y;  // h feeds the block's second matrix; u waits
            } else if (a.chain == kSirenResblock) {
              u[i][j] = 0.5f * (u[i][j] + y);
              next = u[i][j];
            } else if (a.chain == kVanilla) {
              u[i][j] = y + u[i][j];
              next = u[i][j];
            } else {
              u[i][j] = y;
              next = y;
            }
            if (c < n) {
              Dm[(r0 + i) * n + c] = from_f32<T>(d);
              H[(r0 + i) * n + c] = from_f32<T>(next);
            }
          }
      }
      __syncthreads();  // H holds lift(u), the last layer's input

      // ---- y = lift(u) @ W_last + b_last, one warp per (row, output)
      T* yg = static_cast<T*>(a.y) + row0 * so;
      for (int pr = warp; pr < rows * so; pr += kWarps) {
        const int r = pr / so;
        const int j = pr - r * so;
        float sum = 0.f;
        for (int k = tc; k < n; k += kLanes)
          sum = fmaf(to_f32(H[r * n + k]), to_f32(wl[(long long)k * so + j]), sum);
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (tc == 0) yg[pr] = from_f32<T>(sum + to_f32(wg[o_bl + j]));
      }

      // ---- one dx-only cotangent sweep per output
      T* jg = static_cast<T*>(a.jac) + row0 * so * si;
      for (int jo = 0; jo < so; ++jo) {
        __syncthreads();  // the previous sweep has finished reading DZ
        float du[RM][RN], dh[RM][RN];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            const int c = tc + j * kLanes;
            du[i][j] = c < n ? to_f32(wl[(long long)c * so + jo]) : 0.f;
            dh[i][j] = 0.f;
          }
        for (int m = n_mats - 1; m >= 0; --m) {
          const T* Dm = D + (m + 1) * plane;
          const bool res_second = a.chain == kSirenResblock && m % 2 == 1;
          const bool res_first = a.chain == kSirenResblock && m % 2 == 0;
          if (res_first) {
            store_dz<T, RM, RN>(DZ, Dm, n, r0, tc, dh, 1.f);
          } else {
            store_dz<T, RM, RN>(DZ, Dm, n, r0, tc, du, res_second ? 0.5f : 1.f);
          }
          matmul_bwd<T, RM, RN>(DZ, n, wg + o_wh + (long long)m * n * n, n, TP, ws, a.kc, r0, tc,
                                acc);
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < RN; ++j) {
              if (res_second) {
                dh[i][j] = acc[i][j];
              } else if (res_first) {
                du[i][j] = 0.5f * du[i][j] + acc[i][j];
              } else if (a.chain == kVanilla) {
                du[i][j] = du[i][j] + acc[i][j];
              } else {
                du[i][j] = acc[i][j];
              }
            }
        }
        store_dz<T, RM, RN>(DZ, D, n, r0, tc, du, 1.f);
        __syncthreads();
        // jac[r][jo][k] = dz0[r] . W0'[k], one warp per (row, input)
        for (int pr = warp; pr < rows * si; pr += kWarps) {
          const int r = pr / si;
          const int k = pr - r * si;
          float sum = 0.f;
          for (int c = tc; c < n; c += kLanes)
            sum = fmaf(DZ[r * n + c], to_f32(wg[(long long)k * n + c]), sum);
#pragma unroll
          for (int off = kLanes / 2; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          if (tc == 0) jg[((long long)r * so + jo) * si + k] = from_f32<T>(sum);
        }
      }
    }
  }
}

// K5's tangent body (SOB = false) and K6 (SOB = true): the stacked forward;
// then K5 writes y and jac, and K6 forms the two squared-error sums and runs
// the stacked backward into the block's partials.
template <typename T, int RM, int RN, bool SOB>
__global__ void __launch_bounds__(kThreads) stacked_kernel(const Args a) {
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
    const T* wg = static_cast<const T*>(a.wb) + (long long)g * a.po;
    const T* wl = wg + o_wl;
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
        matmul_fwd<T, T, RM, RN>(Splane(m), n, n, tr, wg + o_wh + (long long)m * n * n, n, ws,
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
        const T* bm = wg + o_bh + (long long)m * n;
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
        const T* bm = wg + o_bh + (long long)m * n;
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
        matmul_bwd<T, RM, RN>(D, n, wg + o_wh + (long long)m * n * n, n, tr, ws, a.kc, r0, tc,
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

struct Geometry {
  int rn, tile, kc, splits, grid_g, resid_in_smem;
  size_t smem, resid_bytes;
};

// Status of a shape: 0 = ok, 1 = too wide, 2 = the working buffers exceed a
// block's shared memory, 3 = bad shape, 4 = the 1 + si stacked streams do
// not fit the tile's rows.
int geometry(int mode, int n, int si, int so, int n_mats, int chain, int G, int P, int elem,
             Geometry* g) {
  if (n < 1 || si < 1 || so < 1 || n_mats < 0 || G < 1 || P < 1 || mode < 0 || mode > 2 ||
      (chain == kSirenResblock && n_mats % 2))
    return 3;
  const int rn = columns_per_thread(n);
  if (rn == 0) return 1;
  g->rn = rn;
  const int rows = rows_per_thread(rn) * kWarps;
  g->kc = kWChunkFloats / n > 1 ? kWChunkFloats / n : 1;
  size_t work, resid;
  if (mode == kReverse) {
    g->tile = rows;
    work = sizeof(float) * ((size_t)rows * n + (size_t)g->kc * (n + 1));
    resid = (size_t)elem * ((size_t)rows * si + (size_t)(n_mats + 2) * rows * n);
  } else {
    const bool sob = mode == kSobolev;
    g->tile = rows / (si + 1);
    if (g->tile < 1) return 4;
    const size_t tp = g->tile, tr = (size_t)(si + 1) * g->tile;
    work = sizeof(float) * ((size_t)g->kc * (n + 1) + tr * n + tr * so +
                            (sob ? tr * n + (chain == kSirenResblock ? tr * n : 0) + tp * n : 0));
    resid = sizeof(float) * ((sob ? tp * n : 0) + (sob ? (size_t)n_mats : 1) * tr * n) +
            (size_t)elem * (tp * si + (sob ? (size_t)n_mats + 1 : 2) * tr * n);
  }
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
int launch_jac(const Geometry& geo, Args a, int mode, cudaStream_t stream) {
  constexpr int RM = rows_per_thread(RN);
  auto kernel = mode == kReverse ? jac_reverse_kernel<T, RM, RN> : stacked_kernel<T, RM, RN, false>;
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
int dispatch_jac(const Geometry& g, const Args& a, int mode, cudaStream_t s) {
  return with_rn(g.rn, [&](auto rn) {
    return launch_jac<T, decltype(rn)::value>(g, a, mode, s);
  });
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

// The geometry of one body (mode 0 = K5 reverse, 1 = K5 tangent, 2 = K6) at
// [G, P] (a status as geometry() returns; on 0, 2 and 4 the outputs are
// written): points per tile, P splits per group, dynamic shared memory per
// block, the f32 partials the caller allocates for K6 (G*S*po weight grads,
// then G*S*2 losses; 0 for K5) and the bytes of residual scratch (0 when
// the residuals fit in shared memory).
int nif_shapenet_jac_workspace(int mode, int n, int si, int so, int n_mats, int chain, int G,
                               int P, int dtype, int* tile, int* splits, long long* smem_bytes,
                               long long* partial_floats, long long* scratch_bytes) {
  Geometry g{};
  const int status = geometry(mode, n, si, so, n_mats, chain, G, P, dtype == 0 ? 4 : 2, &g);
  if (status == 1 || status == 3) return status;
  const long long po = (long long)n_mats * n * n + (long long)(si + so + 1 + n_mats) * n + so;
  *tile = g.tile;
  *splits = g.splits;
  *smem_bytes = (long long)g.smem;
  *partial_floats = mode == kSobolev ? (long long)G * g.splits * (po + 2) : 0;
  *scratch_bytes = g.resid_in_smem ? 0 : (long long)g.grid_g * g.splits * (long long)g.resid_bytes;
  return status;
}

// K5. dtype: 0 = float, 1 = bf16 (wb', x, y and jac share it). The body is
// the reverse one when so < si. Returns the CUDA error of the launch (0 on
// success); the kernel runs asynchronously on `stream`.
int nif_shapenet_fwd_jac(const void* wb, const void* x, void* y, void* jac, void* scratch, int G,
                         int P, int si, int so, int n, int n_mats, int chain, int act,
                         long long po, int dtype, void* stream) {
  const int mode = so < si ? kReverse : kTangent;
  Geometry g{};
  if (dtype < 0 || dtype > 1 ||
      geometry(mode, n, si, so, n_mats, chain, G, P, dtype == 0 ? 4 : 2, &g) != 0)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.wb = wb;
  a.x = x;
  a.y = y;
  a.jac = jac;
  a.scratch = scratch;
  a.G = G; a.P = P; a.si = si; a.so = so; a.n = n; a.n_mats = n_mats;
  a.chain = chain; a.act = act; a.po = po;
  a = prepared(a, g);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_jac<float>(g, a, mode, s);
  return dispatch_jac<__nv_bfloat16>(g, a, mode, s);
}

// K6. dtype as K5 (wb', x, target, jt, weight and d_wb share it); y_mask,
// jac_mask and weight may be null. losses receives [value_mse, jac_mse].
int nif_shapenet_sobolev_grads(const void* wb, const void* x, const void* target, const void* jt,
                               const void* y_mask, const void* jac_mask, const void* weight,
                               void* losses, void* d_wb, void* partials, void* scratch, int G,
                               int P, int si, int so, int n, int n_mats, int chain, int act,
                               long long po, long long n_scaled, float omega, float ky, float kj,
                               float n_y, float n_j, int dtype, void* stream) {
  Geometry g{};
  if (dtype < 0 || dtype > 1 ||
      geometry(kSobolev, n, si, so, n_mats, chain, G, P, dtype == 0 ? 4 : 2, &g) != 0)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.wb = wb;
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
  a.chain = chain; a.act = act; a.po = po;
  a = prepared(a, g);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(losses);
  if (dtype == 0) return dispatch_sobolev<float>(g, a, d_wb, l, n_scaled, omega, n_y, n_j, s);
  return dispatch_sobolev<__nv_bfloat16>(g, a, d_wb, l, n_scaled, omega, n_y, n_j, s);
}

const char* nif_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
