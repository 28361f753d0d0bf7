// K7 and K8 on Hopper: the fused Hessian evaluation and the fused Hessian
// train pass of the grouped ShapeNet chain, in one source (one nvcc build).
//
// K7 replaces nif_tpu/ops/pallas_shapenet.py::_fwd_hess_kernel (reached
// through shapenet_fwd_hess; the chain is _hess_fwd_layers):
//   wb' [G, po] (omega_0 folded into the sine-fed weights by the wrapper),
//   x [G, P, si]  ->  y [G, P, so], jac [G, P, so, si] and the unique-pair
//   Hessian columns hp [G, P, so, np] in x's dtype T; the wrapper mirrors
//   hp into the symmetric [G, P, so, si, si].
// K8 replaces _hessian_kernel (reached through shapenet_hessian_grads; its
// backward is _hessian_backward_chain): the same stacked forward with its
// residuals, the masked and weighted value, Jacobian and Hessian squared
// errors (an off-diagonal pair counts twice), and the backward through the
// second-order chain, which multiplies by act'''.
//   -> value, Jacobian and Hessian sums / n_y, n_j, n_h (f32), d_wb [G, po]
//   in T, the sine-fed weight grads multiplied back by omega_0 in f32.
// Sine chains only (plain or resblock SIREN), si <= 4.
//
// The stacked state: a tile of TP points holds ns = 1 + si + np streams of
// TP rows (np = si (si + 1) / 2 unique pairs j <= k, row-major): stream 0
// the values, 1 + k the tangents d/dx_k, 1 + si + a the second-order
// streams d2/dx_j dx_k. A product runs over the tile's TR = ns TP rows,
// padded to the RM * 8 rows the threads own; the pad rows of every product
// input are zero, so the tile products take no row guard in their inner
// loops (a row guard there cost K1 +76% on the H100). The flagship (si =
// 3) has ten streams: six points fill 60 of 64 rows. S (the input of each product) is
// stored rounded to T, the running state U and the raw products Z stay f32,
// and every epilogue runs in f32 from Z, as the reference keeps them.
// After a product, a value row's z gives f, f', f'' (and f''' in K8's
// backward) once for all its streams: new tangent f' Z_k; new pair f' Z_a +
// f'' Z_j Z_k. The first layer seeds the tangents with f'(z0) W0[k] and the
// pairs with f''(z0) W0[j] W0[k], elementwise: no x @ W0 on the stream
// rows, and no dx.
//
// What bounds them on an H100 SXM: operations. At the flagship train shape
// (G=32, P=32768, width 128, two hidden layers, si=3, so=1) K8 is 2071.3
// GFLOP of products: three passes (forward, dW, dS) of the hidden and last
// products over all ten streams, 3 x 689.9, and x @ W0 on the value rows in
// the forward and in dW0, 2 x 0.8. That is ~2.1 ms at the 989 TFLOP/s bf16
// tensor-core peak; K7 is 690.7 GFLOP (~0.70 ms). As in K1-K6 every
// product here is an f32 FMA on the CUDA cores (a bf16 x bf16 product is
// exact in f32, and the f32 path must not use TF32), so the f32 FMA rate
// bounds this design far above those numbers; tensor cores are later work.
//
// Layout of the work (K5/K6's): the grid is (S, G); block (s, g) takes group
// g and the s-th of S contiguous runs of point tiles. Thread (warp tr, lane
// tc) owns rows tr*RM .. tr*RM+RM-1 of a tile and columns tc, tc+32, ... of
// each product; element-wise passes (epilogues and their reverse) stride
// over the tile's points and walk the streams of each. A tile's residuals
// sit in shared memory when they fit (the flagship in bf16: 118 KB beside
// 85 KB of working buffers) and otherwise in a per-block slice of a global
// scratch. K8 adds each tile's weight and bias grads, and its three loss
// sums, into the block's own f32 partials in tile order; the split reduce of
// shapenet_common.cuh sums the S partials of each group in a fixed order. No
// float atomics: two runs on the same inputs give the same bits.
#include "shapenet_common.cuh"

namespace {

constexpr int kMaxSplits = 8;       // K8 point-tile runs per group
constexpr int kMaxEvalSplits = 64;  // K7 point-tile runs per group (no reduction)
constexpr int kWChunkFloats = 4096;  // staged weight floats per chunk
constexpr int kMaxSi = 4;

// Kernel bodies: keep in step with _MODES in ops/fused_hessian.py.
enum Mode : int { kEval = 0, kTrain = 1 };

struct Args {
  const void* wb;         // wb' [G, po], T
  const void* x;          // [G, P, si], T
  void* y;                // K7: [G, P, so], T
  void* jac;              // K7: [G, P, so, si], T
  void* hp;               // K7: [G, P, so, np], T, the unique pairs
  const void* target;     // K8: [G, P, so], T
  const void* jt;         // K8: [G, P, si*so], T, column k*so + j = d y_j / d x_k
  const void* ht;         // K8: [G, P, np*so], T, column a*so + j = d2 y_j / d x_{pair a}
  const float* y_mask;    // K8: [so] 0/1, or null
  const float* jac_mask;  // K8: [si*so] 0/1, or null
  const float* hess_mask; // K8: [np*so] 0/1, or null
  const void* weight;     // K8: [G, P], T, or null
  float* partials;        // K8: [G, S, po] weight-grad partials, then [G, S, 3] loss partials
  void* scratch;          // residuals of each block when they live in global memory
  float ky, kj, kh;       // K8: 2 w_value / n_y, 2 w_jac / n_j, 2 w_hess / n_h
  int G, P, si, so, n, n_mats, chain, act, kc, tile;
  long long po, resid_bytes;  // resid_bytes per block
  int resid_in_smem;
};

// K7 (TRAIN = false): the stacked forward, then y, jac and the pair
// columns. K8 (TRAIN = true): the stacked forward with its residuals, the
// three squared-error sums and the stacked backward into the block's
// partials.
template <typename T, int RM, int RN, bool TRAIN>
__global__ void __launch_bounds__(kThreads) hess_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int trp = RM * kWarps;  // rows of a product: tr live, then zero pad rows
  const int n = a.n, si = a.si, so = a.so, n_mats = a.n_mats;
  const int np = si * (si + 1) / 2;
  const int tp = a.tile, ns = 1 + si + np, tr = ns * tp;
  const bool resblock = a.chain == kSirenResblock;
  const size_t plane = (size_t)trp * n;
  float* ws = reinterpret_cast<float*>(smem_raw);  // [kc, n + 1] staged weights
  float* U = ws + a.kc * (n + 1);                   // [trp, n] running state; dS in the backward
  float* O = U + plane;                             // [tr, so] last product; D_out in K8
  float* D = O + tr * so;                           // K8: [trp, n] lift(D) of an app
  float* DH = D + (TRAIN ? plane : 0);              // K8 resblock: [trp, n] dS of the block's h
  float* DZV = DH + (TRAIN && resblock ? plane : 0);  // K8: [tp, n] the unrounded value-row dz
  float* work_end = DZV + (TRAIN ? tp * n : 0);
  unsigned char* work_end_b = reinterpret_cast<unsigned char*>(work_end);
  const size_t work_bytes = (size_t)(work_end_b - smem_raw);
  float* Z0 = reinterpret_cast<float*>(residuals(a, smem_raw + ((work_bytes + 15) / 16) * 16));
  float* Zr = Z0 + (TRAIN ? tp * n : 0);               // [n_mats or 1][trp, n] raw products
  T* X = reinterpret_cast<T*>(Zr + (TRAIN ? n_mats : 1) * plane);  // [tp, si]
  T* Sr = X + tp * si;                                 // [n_mats + 1 or 2][trp, n] lift(S)
  const int n_splanes = TRAIN ? n_mats + 1 : 2;
  auto Splane = [&](int m) { return Sr + (TRAIN ? m : (m & 1)) * plane; };
  auto Zplane = [&](int m) { return Zr + (TRAIN ? m : 0) * plane; };
  // row of stream st at point r
  auto row = [&](int st, int r) { return st * tp + r; };

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

  // the pad rows of every product input stay zero for the whole kernel
  for (int m = 0; m < n_splanes; ++m)
    for (int e = tr * n + threadIdx.x; e < trp * n; e += kThreads)
      Splane(m)[e] = from_f32<T>(0.f);
  if (TRAIN)
    for (int e = tr * n + threadIdx.x; e < trp * n; e += kThreads) D[e] = 0.f;

  for (int g = blockIdx.y; g < a.G; g += gridDim.y) {
    const T* wg = static_cast<const T*>(a.wb) + (long long)g * a.po;
    const T* wl = wg + o_wl;
    float* part = TRAIN ? a.partials + ((long long)g * S + s) * a.po : nullptr;
    float loss[3] = {0.f, 0.f, 0.f};  // value, Jacobian, Hessian
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

      // ---- first layer: z0 = x @ W0' + b0; values f(z0), tangent seeds
      // f'(z0) W0'[k], pair seeds f''(z0) (W0'[j] W0'[k])
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
          if (TRAIN) Z0[e] = z;
          U[e] = v;
          S0[e] = from_f32<T>(v);
          for (int k = 0; k < si; ++k) {
            const int o = row(1 + k, r) * n + c;
            const float t = d1 * to_f32(wg[k * n + c]);
            U[o] = t;
            S0[o] = from_f32<T>(t);
          }
          int pa = 0;
          for (int j = 0; j < si; ++j)
            for (int k = j; k < si; ++k, ++pa) {
              const int o = row(1 + si + pa, r) * n + c;
              const float h = d2 * (to_f32(wg[j * n + c]) * to_f32(wg[k * n + c]));
              U[o] = h;
              S0[o] = from_f32<T>(h);
            }
        }
      }

      // ---- hidden products over all trp stacked rows, then the epilogues
      for (int m = 0; m < n_mats; ++m) {
        float acc[RM][RN];
        matmul_fwd<T, T, RM, RN, false>(Splane(m), n, n, trp, wg + o_wh + (long long)m * n * n,
                                        n, ws, a.kc, r0, tc, acc);
        float* Z = Zplane(m);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            const int c = tc + j * kLanes;
            if (c < n) Z[(r0 + i) * n + c] = acc[i][j];
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
          // the new stream value v at offset o: the block's h feeds the
          // second matrix as it is; the second app averages with the input
          auto put = [&](int o, float v) {
            if (!res_first) {
              if (res_second) v = 0.5f * (U[o] + v);
              U[o] = v;
            }
            Sn[o] = from_f32<T>(v);
          };
          put(e, av);
          for (int k = 0; k < si; ++k) {
            const int o = row(1 + k, r) * n + c;
            put(o, gd * Z[o]);
          }
          int pa = 0;
          for (int j = 0; j < si; ++j)
            for (int k = j; k < si; ++k, ++pa) {
              const int o = row(1 + si + pa, r) * n + c;
              put(o, gd * Z[o] + hd * Z[row(1 + j, r) * n + c] * Z[row(1 + k, r) * n + c]);
            }
        }
      }
      __syncthreads();  // the last stacked input is complete

      // ---- last product O = lift(S) @ W_last over all tr rows
      const T* Sl = Splane(n_mats);
      for (int pr = warp; pr < tr * so; pr += kWarps) {
        const int rr = pr / so;
        const int j = pr - rr * so;
        float sum = 0.f;
        for (int k = tc; k < n; k += kLanes)
          sum = fmaf(to_f32(Sl[rr * n + k]), to_f32(wl[(long long)k * so + j]), sum);
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
          yg[idx] = from_f32<T>(O[idx] + to_f32(wg[o_bl + idx % so]));
        T* jg = static_cast<T*>(a.jac) + row0 * so * si;
        for (int idx = threadIdx.x; idx < rows * so * si; idx += kThreads) {
          const int r = idx / (so * si);
          const int rem = idx - r * so * si;
          const int j = rem / si;
          const int k = rem - j * si;
          jg[idx] = from_f32<T>(O[row(1 + k, r) * so + j]);
        }
        T* hg = static_cast<T*>(a.hp) + row0 * so * np;
        for (int idx = threadIdx.x; idx < rows * so * np; idx += kThreads) {
          const int r = idx / (so * np);
          const int rem = idx - r * so * np;
          const int j = rem / np;
          const int pa = rem - j * np;
          hg[idx] = from_f32<T>(O[row(1 + si + pa, r) * so + j]);
        }
        continue;
      }

      // ---- K8 loss: err = mask (out - t), e = mask (O_stream - target);
      // sums w err^2 (a pair's times its multiplicity); D_out = [ky w err;
      // kj w e_k; kh mult w e_a] in place of O
      {
        const T* tg = static_cast<const T*>(a.target) + row0 * so;
        const T* jtg = static_cast<const T*>(a.jt) + row0 * si * so;
        const T* htg = static_cast<const T*>(a.ht) + row0 * np * so;
        const T* wt = a.weight ? static_cast<const T*>(a.weight) + row0 : nullptr;
        for (int idx = threadIdx.x; idx < tp * so; idx += kThreads) {
          const int r = idx / so;
          const int jo = idx - r * so;
          const bool live = r < rows;
          const float w = live && wt ? to_f32(wt[r]) : 1.f;
          float dv = 0.f;
          if (live) {
            float err = O[idx] + to_f32(wg[o_bl + jo]) - to_f32(tg[idx]);
            if (a.y_mask) err = err * a.y_mask[jo];
            loss[0] += err * err * w;
            dv = a.ky * err * w;
          }
          O[idx] = dv;
          for (int k = 0; k < si; ++k) {
            const int o = row(1 + k, r) * so + jo;
            float dj = 0.f;
            if (live) {
              float e = O[o] - to_f32(jtg[(long long)r * si * so + k * so + jo]);
              if (a.jac_mask) e = e * a.jac_mask[k * so + jo];
              loss[1] += e * e * w;
              dj = a.kj * e * w;
            }
            O[o] = dj;
          }
          int pa = 0;
          for (int j = 0; j < si; ++j)
            for (int k = j; k < si; ++k, ++pa) {
              const int o = row(1 + si + pa, r) * so + jo;
              const float mult = j == k ? 1.f : 2.f;
              float dh = 0.f;
              if (live) {
                float e = O[o] - to_f32(htg[(long long)r * np * so + pa * so + jo]);
                if (a.hess_mask) e = e * a.hess_mask[pa * so + jo];
                loss[2] += mult * (e * e * w);
                dh = (a.kh * mult) * e * w;
              }
              O[o] = dh;
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
        for (int rr = 0; rr < tr; ++rr)
          sum = fmaf(to_f32(Sl[rr * n + k]), lift<T>(O[rr * so + j]), sum);
        accumulate(part + o_wl + idx, sum, first);
      }
      for (int j = threadIdx.x; j < so; j += kThreads) {
        float sum = 0.f;
        for (int r = 0; r < tp; ++r) sum += O[r * so + j];
        accumulate(part + o_bl + j, sum, first);
      }
      for (int e = threadIdx.x; e < tr * n; e += kThreads) {
        const int rr = e / n;
        const int c = e - rr * n;
        float v = 0.f;
        for (int j = 0; j < so; ++j)
          v = fmaf(lift<T>(O[rr * so + j]), to_f32(wl[(long long)c * so + j]), v);
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
        // with du, dt_k, dh_a the scaled cotangents of the app's output
        // streams: dz = du f' + sum_k dt_k Z_k f'' + sum_a dh_a (Z_a f'' +
        // Z_j Z_k f'''); D = [dz; dt_k f' + the pairs' product-rule terms;
        // dh_a f'], each rounded to T
        for (int e = threadIdx.x; e < tp * n; e += kThreads) {
          const int r = e / n;
          const int c = e - r * n;
          float gd, hd, qd;
          sine4(Z[e] + to_f32(bm[c]), a.act, &gd, &hd, &qd);
          float dz = (scale * src[e]) * gd;
          for (int k = 0; k < si; ++k) {
            const int o = row(1 + k, r) * n + c;
            const float dt = scale * src[o];
            dz = dz + dt * Z[o] * hd;
            D[o] = dt * gd;
          }
          int pa = 0;
          for (int j = 0; j < si; ++j)
            for (int k = j; k < si; ++k, ++pa) {
              const int o = row(1 + si + pa, r) * n + c;
              const int oj = row(1 + j, r) * n + c;
              const int ok = row(1 + k, r) * n + c;
              const float dh = scale * src[o];
              dz = dz + dh * (Z[o] * hd + Z[oj] * Z[ok] * qd);
              D[o] = lift<T>(dh * gd);
              if (j == k) {
                D[oj] = D[oj] + 2.f * dh * hd * Z[oj];
              } else {
                D[oj] = D[oj] + dh * hd * Z[ok];
                D[ok] = D[ok] + dh * hd * Z[oj];
              }
            }
          for (int k = 0; k < si; ++k) {
            const int o = row(1 + k, r) * n + c;
            D[o] = lift<T>(D[o]);
          }
          D[e] = lift<T>(dz);
          DZV[e] = dz;
        }
        __syncthreads();  // D and DZV are complete
        weight_grad<T, RM, RN>(Splane(m), n, n, D, n, tr, part + o_wh + (long long)m * n * n,
                               first, warp, tc);
        bias_grad(DZV, n, tp, part + o_bh + (long long)m * n, first);
        float acc[RM][RN];
        matmul_bwd<T, RM, RN, false>(D, n, wg + o_wh + (long long)m * n * n, n, trp, ws, a.kc,
                                     r0, tc, acc);
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
              U[o] = acc[i][j] + 0.5f * U[o];  // the skip path, on every stream
            } else {
              U[o] = acc[i][j];
            }
          }
        __syncthreads();  // dS (or the block's dh) is complete
      }

      // ---- first layer: dz0 = du f'(z0) + sum_k dt_k W0'[k] f''(z0) +
      // sum_a dh_a (W0'[j] W0'[k]) f'''(z0); the seed rows of dW0 collect
      // dt_k f'(z0) and the pairs' dh_a f''(z0) W0'[the other index]
      for (int e = threadIdx.x; e < tp * n; e += kThreads) {
        const int r = e / n;
        const int c = e - r * n;
        float gd, hd, qd;
        sine4(Z0[e], a.act, &gd, &hd, &qd);
        float dz = U[e] * gd;
        for (int k = 0; k < si; ++k) {
          const int o = row(1 + k, r) * n + c;
          const float dt = U[o];
          dz = dz + dt * to_f32(wg[k * n + c]) * hd;
          D[o] = dt * gd;
        }
        int pa = 0;
        for (int j = 0; j < si; ++j)
          for (int k = j; k < si; ++k, ++pa) {
            const float wj = to_f32(wg[j * n + c]);
            const float wk = to_f32(wg[k * n + c]);
            const int oj = row(1 + j, r) * n + c;
            const int ok = row(1 + k, r) * n + c;
            const float dh = U[row(1 + si + pa, r) * n + c];
            dz = dz + dh * (wj * wk) * qd;
            if (j == k) {
              D[oj] = D[oj] + 2.f * (dh * hd * wj);
            } else {
              D[oj] = D[oj] + dh * hd * wk;
              D[ok] = D[ok] + dh * hd * wj;
            }
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
          s2 += D[row(1 + k, r) * n + c];
        }
        accumulate(part + idx, s1 + s2, first);
      }
      bias_grad(DZV, n, tp, part + o_b0, first);
    }

    if (TRAIN)  // the block's three loss partials, after its [G, S, po] weight grads
      store_loss_partials(loss, ws,
                          a.partials + (long long)a.G * S * a.po + ((long long)g * S + s) * 3);
  }
}

struct Geometry {
  int rn, tile, kc, splits, grid_g, resid_in_smem;
  size_t smem, resid_bytes;
};

// Status of a shape: 0 = ok, 1 = too wide, 2 = the working buffers exceed a
// block's shared memory, 3 = bad shape (or a chain or si the kernels do not
// take), 4 = the 1 + si + np stacked streams do not fit the tile's rows.
int geometry(int mode, int n, int si, int so, int n_mats, int chain, int G, int P, int elem,
             Geometry* g) {
  if (n < 1 || si < 1 || si > kMaxSi || so < 1 || n_mats < 0 || G < 1 || P < 1 || mode < 0 ||
      mode > 1 || (chain != kSirenPlain && chain != kSirenResblock) ||
      (chain == kSirenResblock && n_mats % 2))
    return 3;
  const int rn = columns_per_thread(n);
  if (rn == 0) return 1;
  g->rn = rn;
  const size_t trp = (size_t)rows_per_thread(rn) * kWarps;
  g->kc = kWChunkFloats / n > 1 ? kWChunkFloats / n : 1;
  const int ns = 1 + si + si * (si + 1) / 2;
  g->tile = (int)trp / ns;
  if (g->tile < 1) return 4;
  const bool train = mode == kTrain;
  const size_t tp = g->tile, tr = (size_t)ns * g->tile;
  size_t work = sizeof(float) * ((size_t)g->kc * (n + 1) + trp * n + tr * so +
                                 (train ? trp * n + (chain == kSirenResblock ? trp * n : 0) +
                                              tp * n
                                        : 0));
  size_t resid = sizeof(float) * ((train ? tp * n : 0) + (train ? (size_t)n_mats : 1) * trp * n) +
                 (size_t)elem * (tp * si + (train ? (size_t)n_mats + 1 : 2) * trp * n);
  work = (work + 15) / 16 * 16;
  resid = (resid + 15) / 16 * 16;
  const int n_tiles = (P + g->tile - 1) / g->tile;
  int want = kMaxSplits;
  if (!train) {
    want = (2 * sm_count() + G - 1) / G;  // about two blocks per SM when G is small
    want = want < kMaxSplits ? kMaxSplits : (want > kMaxEvalSplits ? kMaxEvalSplits : want);
  }
  g->splits = n_tiles < want ? n_tiles : want;
  g->grid_g = G < 65535 ? G : 65535;
  g->resid_bytes = resid;
  g->resid_in_smem = work + resid <= kMaxSmem;
  g->smem = g->resid_in_smem ? work + resid : work;
  return g->smem > kMaxSmem ? 2 : 0;
}

template <typename T, int RN>
int launch_eval(const Geometry& geo, Args a, cudaStream_t stream) {
  constexpr int RM = rows_per_thread(RN);
  auto kernel = hess_kernel<T, RM, RN, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(geo.splits, geo.grid_g), kThreads, geo.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int RN>
int launch_train(const Geometry& geo, Args a, T* d_wb, float* losses, long long n_scaled,
                 float omega, LossNorms norms, cudaStream_t stream) {
  constexpr int RM = rows_per_thread(RN);
  auto kernel = hess_kernel<T, RM, RN, true>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(geo.splits, geo.grid_g), kThreads, geo.smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_split_reduce<T, 3>(a.partials, a.G, geo.splits, a.po, n_scaled, omega, norms,
                                   d_wb, losses, stream);
}

Args prepared(Args a, const Geometry& g) {
  a.kc = g.kc;
  a.tile = g.tile;
  a.resid_bytes = (long long)g.resid_bytes;
  a.resid_in_smem = g.resid_in_smem;
  return a;
}

// The checks both entries share: a dtype code, a sine activation, a shape
// the geometry takes.
bool valid(int mode, int n, int si, int so, int n_mats, int chain, int act, int G, int P,
           int dtype, Geometry* g) {
  return dtype >= 0 && dtype <= 1 && (act == kSinePoly7 || act == kSinePoly9 || act == kSineExact) &&
         geometry(mode, n, si, so, n_mats, chain, G, P, dtype == 0 ? 4 : 2, g) == 0;
}

}  // namespace

extern "C" {

// The geometry of one body (mode 0 = K7, 1 = K8) at [G, P] (a status as
// geometry() returns; on 0, 2 and 4 the outputs are written): points per
// tile, P splits per group, dynamic shared memory per block, the f32
// partials the caller allocates for K8 (G*S*po weight grads, then G*S*3
// losses; 0 for K7) and the bytes of residual scratch (0 when the residuals
// fit in shared memory).
int nif_shapenet_hess_workspace(int mode, int n, int si, int so, int n_mats, int chain, int G,
                                int P, int dtype, int* tile, int* splits, long long* smem_bytes,
                                long long* partial_floats, long long* scratch_bytes) {
  Geometry g{};
  const int status = geometry(mode, n, si, so, n_mats, chain, G, P, dtype == 0 ? 4 : 2, &g);
  if (status == 1 || status == 3) return status;
  const long long po = (long long)n_mats * n * n + (long long)(si + so + 1 + n_mats) * n + so;
  *tile = g.tile;
  *splits = g.splits;
  *smem_bytes = (long long)g.smem;
  *partial_floats = mode == kTrain ? (long long)G * g.splits * (po + 3) : 0;
  *scratch_bytes = g.resid_in_smem ? 0 : (long long)g.grid_g * g.splits * (long long)g.resid_bytes;
  return status;
}

// K7. dtype: 0 = float, 1 = bf16 (wb', x, y, jac and hp share it). Returns
// the CUDA error of the launch (0 on success); the kernel runs
// asynchronously on `stream`.
int nif_shapenet_fwd_hess(const void* wb, const void* x, void* y, void* jac, void* hp,
                          void* scratch, int G, int P, int si, int so, int n, int n_mats,
                          int chain, int act, long long po, int dtype, void* stream) {
  Geometry g{};
  if (!valid(kEval, n, si, so, n_mats, chain, act, G, P, dtype, &g))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.wb = wb;
  a.x = x;
  a.y = y;
  a.jac = jac;
  a.hp = hp;
  a.scratch = scratch;
  a.G = G; a.P = P; a.si = si; a.so = so; a.n = n; a.n_mats = n_mats;
  a.chain = chain; a.act = act; a.po = po;
  a = prepared(a, g);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_rn(g.rn, [&](auto rn) {
    constexpr int RN = decltype(rn)::value;
    return dtype == 0 ? launch_eval<float, RN>(g, a, s) : launch_eval<__nv_bfloat16, RN>(g, a, s);
  });
}

// K8. dtype as K7 (wb', x, target, jt, ht, weight and d_wb share it);
// y_mask, jac_mask, hess_mask and weight may be null. losses receives
// [value_mse, jac_mse, hess_mse].
int nif_shapenet_hessian_grads(const void* wb, const void* x, const void* target, const void* jt,
                               const void* ht, const void* y_mask, const void* jac_mask,
                               const void* hess_mask, const void* weight, void* losses,
                               void* d_wb, void* partials, void* scratch, int G, int P, int si,
                               int so, int n, int n_mats, int chain, int act, long long po,
                               long long n_scaled, float omega, float ky, float kj, float kh,
                               float n_y, float n_j, float n_h, int dtype, void* stream) {
  Geometry g{};
  if (!valid(kTrain, n, si, so, n_mats, chain, act, G, P, dtype, &g))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.wb = wb;
  a.x = x;
  a.target = target;
  a.jt = jt;
  a.ht = ht;
  a.y_mask = static_cast<const float*>(y_mask);
  a.jac_mask = static_cast<const float*>(jac_mask);
  a.hess_mask = static_cast<const float*>(hess_mask);
  a.weight = weight;
  a.partials = static_cast<float*>(partials);
  a.scratch = scratch;
  a.ky = ky;
  a.kj = kj;
  a.kh = kh;
  a.G = G; a.P = P; a.si = si; a.so = so; a.n = n; a.n_mats = n_mats;
  a.chain = chain; a.act = act; a.po = po;
  a = prepared(a, g);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(losses);
  const LossNorms norms{{n_y, n_j, n_h}};
  return with_rn(g.rn, [&](auto rn) {
    constexpr int RN = decltype(rn)::value;
    return dtype == 0
               ? launch_train<float, RN>(g, a, static_cast<float*>(d_wb), l, n_scaled, omega,
                                         norms, s)
               : launch_train<__nv_bfloat16, RN>(g, a, static_cast<__nv_bfloat16*>(d_wb), l,
                                                 n_scaled, omega, norms, s);
  });
}

const char* nif_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
