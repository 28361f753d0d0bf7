// K4 on Hopper: the fused NIF-linear train pass, u = phi(x) . a(t) + bias.
//
// Replaces nif_tpu/ops/pallas_shapenet.py::_linear_train_kernel (reached
// through niflinear_mse_grads): the shared-weight SIREN trunk x -> phi(x),
// whose last (linear) layer is the bottleneck of width nk = so * K, its
// contraction with the per-group latent a(t), the weighted MSE and the whole
// backward, in one pass, no dx:
//   trunk wb' [po] (one vector for every group, in the chain layout
//   [W_first | W_hidden... | W_bot | b_first | b_hidden... | b_bot], omega_0
//   folded into the sine-fed weights by the wrapper), a [G, K], bias [so],
//   x [G, P, si], target [G, P, so], weight [G, P] (optional; all in x's
//   dtype T)  ->  loss, d_trunk [po], d_a [G, K], d_bias [so], all f32 sums
//   divided by G*P*so, the sine-fed trunk grads multiplied back by omega_0
//   in f32 (_unscale_grads).
//
// The rounding points are the reference's: the forward of K2
// (_forward_layers(save=True): each layer saves its input and its activation
// derivative, rounded to T); phi = lift(u_last) @ W_bot + b_bot stays f32 and
// is not rounded before the contraction u[p, o] = sum_k phi[p, o*K + k] a[k]
// + bias[o] (a and bias are T values, taken in f32); err = u - target, the
// loss sums err^2 w and go = 2 err w, in f32; d_bias = sum_p go, d_a[g] =
// sum_p sum_o phi_o go_o (a separate sum per group), d_phi = go_o a in f32.
// The backward is K2's (_backward_chain, need_dx=False) from go_c =
// lift(d_phi): dW_bot = lift(u_last)^T go_c, db_bot = colsum(go_c) and du =
// go_c @ W_bot^T (or, for nk == 1, the f32 d_phi times the bottleneck
// column), then the hidden and first layers with du in f32 and each dz
// rounded to T.
//
// What bounds it on an H100 SXM: operations. At the flagship NIF-linear
// train shape (G=32, P=32768, width 128, two hidden layers, si=3, so=1,
// K=128) the products are 49,536 MACs a point forward and 98,688 backward,
// 310.8 GFLOP in all: ~0.31 ms at the 989 TFLOP/s bf16 tensor-core peak,
// against ~10 MB of compulsory traffic. As in K1-K3, K5-K8, every product
// here is an f32 FMA on the CUDA cores (a bf16 x bf16 product is exact in
// f32, and the f32 path must not use TF32 anywhere), so the f32 FMA rate
// bounds this design far above that; tensor cores are later work.
//
// Layout of the work: the grid is (S, G), as in K2; block (s, g) takes group
// g and the s-th of S contiguous runs of point tiles, and its 256 threads
// walk their tiles of TP points in order. Thread (warp tr, lane tc) owns rows
// tr*RM .. tr*RM+RM-1 and columns tc, tc+32, ... of a tile, with RN columns
// a thread covering the wider of the trunk width n and the bottleneck nk.
// The bottleneck runs through the same tile product as the hidden layers
// (K2's one-warp-per-output last layer would cost nk times more at nk =
// 128), so phi stays in registers; the contraction with a is a row sum over
// the columns a warp owns (multiply, then a shuffle reduction). A tile's
// residuals (x, every layer input and activation derivative) sit in shared
// memory when they fit (the flagship in bf16) and otherwise in a per-block
// slice of a global scratch. The trunk is one vector for every group, so
// each block adds its tiles' trunk grads, loss and d_bias, in tile order,
// into its own f32 partial, and its d_a into the same partial; a second
// kernel sums the trunk grads, the loss and d_bias over all G*S blocks and
// d_a over the S blocks of each group, each in a fixed order. No float
// atomics: two runs on the same inputs give the same bits.
#include "shapenet_common.cuh"

namespace {

constexpr int kMaxSplits = 8;        // point-tile runs per group
constexpr int kWChunkFloats = 4096;  // staged weight floats per chunk

struct Args {
  const void* wb;      // trunk wb' [po], T
  const void* a;       // [G, K], T
  const void* bias;    // [so], T
  const void* x;       // [G, P, si], T
  const void* target;  // [G, P, so], T
  const void* weight;  // [G, P], T, or null
  float* partials;     // [G, S, pb]: trunk grads [po], d_a [K], d_bias [so], loss
  void* scratch;       // residuals of each block when they live in global memory
  int G, P, si, so, K, nk, n, n_mats, chain, act, kc;
  long long po, pb, resid_bytes;  // resid_bytes per block
  int ws_floats, resid_in_smem;
};

template <typename T, int RM, int RN>
__global__ void __launch_bounds__(kThreads) niflinear_train_kernel(const Args a) {
  constexpr int TP = RM * kWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, si = a.si, so = a.so, K = a.K, nk = a.nk, n_mats = a.n_mats;
  const int wmax = n > nk ? n : nk;
  float* DZ = reinterpret_cast<float*>(smem_raw);  // [TP, wmax] lifted dz (or d_phi), f32
  float* ws = DZ + TP * wmax;                       // staged weights; the d_a warp sums
  float* AK = ws + a.ws_floats;                     // [nk] a[c % K] of the group, f32
  unsigned char* res = a.resid_in_smem
                           ? reinterpret_cast<unsigned char*>(AK + nk)
                           : static_cast<unsigned char*>(a.scratch) +
                                 ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * a.resid_bytes;
  float* GO = reinterpret_cast<float*>(res);  // [TP, so] dL/du, f32
  T* X = reinterpret_cast<T*>(GO + TP * so);  // [TP, si] the x tile
  T* H = X + TP * si;                         // [n_mats + 1][TP, n] layer inputs
  T* D = H + (size_t)(n_mats + 1) * TP * n;   // [n_mats + 1][TP, n] act derivatives
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
  const long long o_b0 = o_wl + (long long)n * nk;
  const long long o_bh = o_b0 + n;
  const long long o_bl = o_bh + (long long)n_mats * n;
  const long long o_da = a.po;  // offsets in a block's partial
  const long long o_dbias = o_da + K;
  const long long o_loss = o_dbias + so;
  const T* wg = static_cast<const T*>(a.wb);
  const T* bias_g = static_cast<const T*>(a.bias);

  for (int g = blockIdx.y; g < a.G; g += gridDim.y) {
    float* part = a.partials + ((long long)g * S + s) * a.pb;
    const T* ag = static_cast<const T*>(a.a) + (long long)g * K;
    for (int c = threadIdx.x; c < nk; c += kThreads) AK[c] = to_f32(ag[c % K]);
    float loss_acc = 0.f;
    for (int tile = t_begin; tile < t_end; ++tile) {
      const bool first = tile == t_begin;
      const int p0 = tile * TP;
      const int rows = min(TP, a.P - p0);
      const long long row0 = (long long)g * a.P + p0;
      __syncthreads();  // the previous tile has finished with every buffer; AK is written
      const T* xg = static_cast<const T*>(a.x) + row0 * si;
      for (int idx = threadIdx.x; idx < TP * si; idx += kThreads)
        X[idx] = idx < rows * si ? xg[idx] : from_f32<T>(0.f);

      // ---- trunk forward, saving H[m] (input of hidden matrix m, or of the
      // bottleneck for m = n_mats) and D[m] (derivative of activated layer m)
      float acc[RM][RN], u[RM][RN], bias[RN];
      matmul_fwd<T, T, RM, RN, false>(X, si, si, TP, wg, n, ws, a.kc, r0, tc, acc);
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
          float d;
          u[i][j] = act_grad(acc[i][j] + bias[j], a.act, &d);
          if (c < n) {
            D[(r0 + i) * n + c] = from_f32<T>(d);
            H[(r0 + i) * n + c] = from_f32<T>(u[i][j]);
          }
        }
      for (int m = 0; m < n_mats; ++m) {
        matmul_fwd<T, T, RM, RN, false>(H + m * plane, n, n, TP, wg + o_wh + (long long)m * n * n,
                                        n, ws, a.kc, r0, tc, acc);
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int c = tc + j * kLanes;
          bias[j] = c < n ? to_f32(wg[o_bh + (long long)m * n + c]) : 0.f;
        }
        T* Dm = D + (m + 1) * plane;
        T* Hn = H + (m + 1) * plane;
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            const int c = tc + j * kLanes;
            float d;
            const float y = act_grad(acc[i][j] + bias[j], a.act, &d);
            float next;
            if (a.chain == kSirenResblock && m % 2 == 0) {
              next = y;  // h feeds the block's second matrix; u waits
            } else if (a.chain == kSirenResblock) {
              u[i][j] = 0.5f * (u[i][j] + y);
              next = u[i][j];
            } else {
              u[i][j] = y;
              next = y;
            }
            if (c < n) {
              Dm[(r0 + i) * n + c] = from_f32<T>(d);
              Hn[(r0 + i) * n + c] = from_f32<T>(next);
            }
          }
      }
      const T* Hl = H + n_mats * plane;
      const T* wl = wg + o_wl;

      // ---- bottleneck: phi = lift(u_last) @ W_bot + b_bot, f32, in acc
      float (&phi)[RM][RN] = acc;
      matmul_fwd<T, T, RM, RN, false>(Hl, n, n, TP, wl, nk, ws, a.kc, r0, tc, phi);
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int c = tc + j * kLanes;
        bias[j] = c < nk ? to_f32(wg[o_bl + c]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) phi[i][j] += bias[j];

      // ---- contraction, loss and dL/du into GO (zero past the ragged edge):
      // u[r, o] = sum of phi[r, c] a[c % K] over the columns c of block o
      const T* tg = static_cast<const T*>(a.target) + row0 * so;
      const T* wt = a.weight ? static_cast<const T*>(a.weight) + row0 : nullptr;
      for (int o = 0; o < so; ++o) {
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            const int c = tc + j * kLanes;
            if (c < nk && c / K == o) sum = fmaf(phi[i][j], AK[c], sum);
          }
#pragma unroll
          for (int off = kLanes / 2; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          if (tc == 0) {
            const int r = r0 + i;
            float go = 0.f;
            if (r < rows) {
              const float err = sum + to_f32(bias_g[o]) - to_f32(tg[r * so + o]);
              const float w = wt ? to_f32(wt[r]) : 1.f;
              loss_acc += err * err * w;
              go = 2.f * err * w;
            }
            GO[r * so + o] = go;
          }
        }
      }
      __syncthreads();  // GO is complete

      // ---- d_bias; d_a's warp sums into ws; d_phi = lift(go_o a) into DZ
      for (int o = threadIdx.x; o < so; o += kThreads) {
        float sum = 0.f;
        for (int r = 0; r < rows; ++r) sum += GO[r * so + o];
        accumulate(part + o_dbias + o, sum, first);
      }
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int c = tc + j * kLanes;
        if (c < nk) {
          const int o = c / K;
          float da = 0.f;
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float go = GO[(r0 + i) * so + o];
            da = fmaf(phi[i][j], go, da);
            DZ[(r0 + i) * nk + c] = lift<T>(go * AK[c]);
          }
          ws[warp * nk + c] = da;
        }
      }
      __syncthreads();  // DZ and the d_a warp sums are complete
      for (int k = threadIdx.x; k < K; k += kThreads) {
        float sum = 0.f;
        for (int o = 0; o < so; ++o)
          for (int w = 0; w < kWarps; ++w) sum += ws[w * nk + o * K + k];
        accumulate(part + o_da + k, sum, first);
      }

      // ---- bottleneck grads: dW_bot = lift(u_last)^T go_c, db_bot = colsum(go_c)
      weight_grad<T, RM, RN>(Hl, n, n, DZ, nk, rows, part + o_wl, first, warp, tc);
      bias_grad(DZ, nk, rows, part + o_bl, first);
      __syncthreads();  // every read of DZ and of the d_a sums in ws is done

      // du = go_c @ W_bot^T, or for nk == 1 the f32 d_phi times the column
      float du[RM][RN], dh[RM][RN];
      if (nk == 1) {
        const float a0 = AK[0];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            const int c = tc + j * kLanes;
            du[i][j] = c < n ? GO[(r0 + i) * so] * a0 * to_f32(wl[c]) : 0.f;
          }
      } else {
        matmul_bwd<T, RM, RN, false>(DZ, nk, wl, n, TP, ws, a.kc, r0, tc, du);
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) dh[i][j] = 0.f;

      // ---- hidden layers, last to first (K2's backward)
      for (int m = n_mats - 1; m >= 0; --m) {
        const T* Dm = D + (m + 1) * plane;
        const bool res_second = a.chain == kSirenResblock && m % 2 == 1;
        const bool res_first = a.chain == kSirenResblock && m % 2 == 0;
        if (res_first) {
          store_dz<T, RM, RN>(DZ, Dm, n, r0, tc, dh, 1.f);
        } else {
          store_dz<T, RM, RN>(DZ, Dm, n, r0, tc, du, res_second ? 0.5f : 1.f);
        }
        __syncthreads();  // DZ is complete
        weight_grad<T, RM, RN>(H + m * plane, n, n, DZ, n, rows, part + o_wh + (long long)m * n * n,
                               first, warp, tc);
        bias_grad(DZ, n, rows, part + o_bh + (long long)m * n, first);
        matmul_bwd<T, RM, RN, false>(DZ, n, wg + o_wh + (long long)m * n * n, n, TP, ws, a.kc, r0,
                                     tc, acc);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            if (res_second) {
              dh[i][j] = acc[i][j];
            } else if (res_first) {
              du[i][j] = 0.5f * du[i][j] + acc[i][j];
            } else {
              du[i][j] = acc[i][j];
            }
          }
      }

      // ---- first layer: dz0 = lift(du * D[0]); dW_0 = x^T dz0, db_0
      store_dz<T, RM, RN>(DZ, D, n, r0, tc, du, 1.f);
      __syncthreads();
      weight_grad<T, RM, RN>(X, si, si, DZ, n, rows, part, first, warp, tc);
      bias_grad(DZ, n, rows, part + o_b0, first);
    }

    // the block's loss partial: warps in order, then their sums in order
    __syncthreads();  // every thread is done with ws
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
      loss_acc += __shfl_xor_sync(0xffffffffu, loss_acc, off);
    if (tc == 0) ws[warp] = loss_acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = 0.f;
      for (int w = 0; w < kWarps; ++w) total += ws[w];
      part[o_loss] = total;
    }
  }
}

// The reduce over the [G, S, pb] partials, one thread per output: trunk
// grads, d_bias and the loss sum all G*S blocks in (g, s) order, d_a[g]
// the S blocks of group g in order; the sine-fed trunk grads are multiplied
// by omega, and every output is divided by n_elem.
__global__ void __launch_bounds__(kThreads)
    linear_reduce_kernel(const float* __restrict__ partials, int G, int S, long long po,
                         long long pb, int K, int so, long long n_scaled, float omega,
                         float n_elem, float* __restrict__ d_trunk, float* __restrict__ d_a,
                         float* __restrict__ d_bias, float* __restrict__ loss) {
  const long long n_da = (long long)G * K;
  const long long total = po + n_da + so + 1;
  const long long blocks = (long long)G * S;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * kThreads) {
    float sum = 0.f;
    if (idx < po) {
      for (long long b = 0; b < blocks; ++b) sum += partials[b * pb + idx];
      if (idx < n_scaled) sum = sum * omega;
      d_trunk[idx] = sum / n_elem;
    } else if (idx < po + n_da) {
      const long long g = (idx - po) / K;
      const long long k = idx - po - g * K;
      for (int s = 0; s < S; ++s) sum += partials[(g * S + s) * pb + po + k];
      d_a[idx - po] = sum / n_elem;
    } else {
      const long long e = idx - po - n_da;  // d_bias[e] for e < so, then the loss
      for (long long b = 0; b < blocks; ++b) sum += partials[b * pb + po + K + e];
      if (e < so)
        d_bias[e] = sum / n_elem;
      else
        *loss = sum / n_elem;
    }
  }
}

struct Geometry {
  int rn, tile, kc, splits, grid_g, ws_floats, resid_in_smem;
  size_t smem, resid_bytes;
};

// K2's width rule over the wider of the trunk width n and the bottleneck
// nk (columns per thread rn = ceil(w / 32) rounded up to a power of two, at
// most 32). Shared memory holds the dz tile, a weight chunk (also the d_a
// warp sums) and the group's a; the residuals join them when they fit and
// otherwise live in global scratch. Status 0 = ok, 1 = too wide, 2 = the
// working buffers alone exceed a block's shared memory, 3 = bad shape.
int geometry(int n, int si, int so, int K, int n_mats, int G, int P, int elem, Geometry* g) {
  if (n < 1 || si < 1 || so < 1 || K < 1 || n_mats < 0 || G < 1 || P < 1) return 3;
  const int nk = so * K;
  const int wmax = n > nk ? n : nk;
  const int rn = columns_per_thread(wmax);
  if (rn == 0) return 1;
  g->rn = rn;
  g->tile = rows_per_thread(rn) * kWarps;
  g->kc = kWChunkFloats / wmax > 1 ? kWChunkFloats / wmax : 1;
  const int stage = g->kc * (wmax + 1);
  g->ws_floats = stage > kWarps * nk ? stage : kWarps * nk;
  const int n_tiles = (P + g->tile - 1) / g->tile;
  g->splits = n_tiles < kMaxSplits ? n_tiles : kMaxSplits;
  g->grid_g = G < 65535 ? G : 65535;
  size_t work = sizeof(float) * ((size_t)g->tile * wmax + (size_t)g->ws_floats + (size_t)nk);
  work = (work + 15) / 16 * 16;
  size_t resid = sizeof(float) * (size_t)g->tile * so +
                 (size_t)elem * ((size_t)g->tile * si + 2 * (size_t)(n_mats + 1) * g->tile * n);
  resid = (resid + 15) / 16 * 16;
  g->resid_bytes = resid;
  g->resid_in_smem = work + resid <= kMaxSmem;
  g->smem = g->resid_in_smem ? work + resid : work;
  return g->smem > kMaxSmem ? 2 : 0;
}

long long trunk_params(int n, int si, int nk, int n_mats) {
  return (long long)n_mats * n * n + (long long)(si + 1 + n_mats) * n + (long long)n * nk + nk;
}

template <typename T, int RN>
int launch(const Geometry& geo, Args a, float* loss, float* d_trunk, float* d_a, float* d_bias,
           long long n_scaled, float omega, cudaStream_t stream) {
  constexpr int RM = rows_per_thread(RN);
  auto kernel = niflinear_train_kernel<T, RM, RN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
  if (err != cudaSuccess) return (int)err;
  a.kc = geo.kc;
  a.ws_floats = geo.ws_floats;
  a.resid_bytes = (long long)geo.resid_bytes;
  a.resid_in_smem = geo.resid_in_smem;
  kernel<<<dim3(geo.splits, geo.grid_g), kThreads, geo.smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = a.po + (long long)a.G * a.K + a.so + 1;
  const float n_elem = (float)((long long)a.G * a.P * a.so);
  linear_reduce_kernel<<<stride_blocks(total), kThreads, 0, stream>>>(
      a.partials, a.G, geo.splits, a.po, a.pb, a.K, a.so, n_scaled, omega, n_elem, d_trunk, d_a,
      d_bias, loss);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The geometry K4 takes (a status as geometry() returns): points per tile,
// P splits per group, dynamic shared memory per block, the f32 partials the
// caller allocates (G*S blocks of po trunk grads, K d_a, so d_bias and one
// loss) and the bytes of residual scratch (0 when the residuals fit in
// shared memory).
int nif_linear_workspace(int n, int si, int so, int K, int n_mats, int G, int P, int dtype,
                         int* tile, int* splits, long long* smem_bytes, long long* partial_floats,
                         long long* scratch_bytes) {
  Geometry g{};
  const int status = geometry(n, si, so, K, n_mats, G, P, dtype == 0 ? 4 : 2, &g);
  *tile = g.tile;
  *splits = g.splits;
  *smem_bytes = (long long)g.smem;
  if (status != 0) return status;
  const long long pb = trunk_params(n, si, so * K, n_mats) + K + so + 1;
  *partial_floats = (long long)G * g.splits * pb;
  *scratch_bytes = g.resid_in_smem ? 0 : (long long)g.grid_g * g.splits * (long long)g.resid_bytes;
  return 0;
}

// K4. dtype: 0 = float, 1 = bf16 (wb', a, bias, x, target and weight share
// it; every output is f32). chain: kSirenPlain or kSirenResblock. weight may
// be null. Returns the CUDA error of the launches (0 on success); the
// kernels run asynchronously on `stream`.
int nif_linear_mse_grads(const void* wb, const void* a, const void* bias, const void* x,
                         const void* target, const void* weight, void* loss, void* d_trunk,
                         void* d_a, void* d_bias, void* partials, void* scratch, int G, int P,
                         int si, int so, int K, int n, int n_mats, int chain, int act,
                         long long n_scaled, float omega, int dtype, void* stream) {
  Geometry g{};
  if (dtype < 0 || dtype > 1 || (chain != kSirenPlain && chain != kSirenResblock) ||
      geometry(n, si, so, K, n_mats, G, P, dtype == 0 ? 4 : 2, &g) != 0)
    return (int)cudaErrorInvalidValue;
  Args args{};
  args.wb = wb;
  args.a = a;
  args.bias = bias;
  args.x = x;
  args.target = target;
  args.weight = weight;
  args.partials = static_cast<float*>(partials);
  args.scratch = scratch;
  args.G = G; args.P = P; args.si = si; args.so = so; args.K = K; args.nk = so * K;
  args.n = n; args.n_mats = n_mats; args.chain = chain; args.act = act;
  args.po = trunk_params(n, si, so * K, n_mats);
  args.pb = args.po + K + so + 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out[4] = {static_cast<float*>(loss), static_cast<float*>(d_trunk),
                   static_cast<float*>(d_a), static_cast<float*>(d_bias)};
  return with_rn(g.rn, [&](auto rn) {
    constexpr int RN = decltype(rn)::value;
    if (dtype == 0)
      return launch<float, RN>(g, args, out[0], out[1], out[2], out[3], n_scaled, omega, s);
    return launch<__nv_bfloat16, RN>(g, args, out[0], out[1], out[2], out[3], n_scaled, omega, s);
  });
}

const char* nif_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
