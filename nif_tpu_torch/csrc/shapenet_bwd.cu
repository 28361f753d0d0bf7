// K2 and K3 on Hopper: the residual-saving forward and the backward of the
// grouped ShapeNet chain, in one source (one nvcc build).
//
// K2 replaces nif_tpu/ops/pallas_shapenet.py::_train_kernel (reached through
// shapenet_mse_grads): forward, weighted MSE and backward in one pass, no dx:
//   wb' [G, po] (omega_0 folded into the sine-fed weights by the wrapper),
//   x [G, P, si], target [G, P, so], weight [G, P] (optional; both in x's
//   dtype)  ->  loss (f32 scalar), d_wb [G, po] in wb's dtype, both / G*P*so.
// K3 replaces _bwd_kernel (the backward of shapenet_grouped_fused, reached
// through _fused_bwd): recompute the forward with its residuals, then take
//   g_out [G, P, so] (x's dtype)  ->  d_wb [G, po] (not divided), dx [G, P, si].
// In both, the sine-fed weight grads are multiplied back by omega_0 in f32
// (_unscale_grads) before the cast to wb's dtype.
//
// The rounding points are the reference's (_forward_layers(save=True),
// _backward_chain): each layer saves its input and its activation
// DERIVATIVE, both rounded to the compute dtype T; the backward carries du in
// f32, rounds dz = du * act' to T before its weight product and bias sum,
// takes 0.5 on both resblock branches and adds the vanilla shortcut straight
// through. For so == 1, du starts as the f32 go times the last weight column.
//
// What bounds them on an H100 SXM: operations. At the flagship train shape
// (G=32, P=32768, width 128, two hidden layers, si=3, so=1) K2 is ~208.6
// GFLOP of products (forward 69.8, dW 69.8, du 69.0): ~0.21 ms at the 989
// TFLOP/s bf16 tensor-core peak, against ~17 MB of compulsory traffic. As in
// K1, every product here is an f32 FMA on the CUDA cores (a bf16 x bf16
// product is exact in f32, and the f32 path must not use TF32), so the f32
// FMA rate bounds this design at >= 3.1 ms; tensor cores are later work.
//
// Layout of the work: the grid is (S, G): block (s, g) takes group g and
// the s-th of S contiguous runs of point tiles (S = min(8, tiles), fixed by
// the shapes alone). Its 256 threads walk their tiles of TP points in order.
// Per tile the forward keeps every layer input H and derivative D of its TP
// points (the residuals); at the flagship width in bf16 they fit in shared
// memory, and otherwise (f32 at width 128, wider or deeper chains) they live
// in a per-block slice of a global scratch, which the geometry reports. The
// weight and bias grads of a tile are added, in tile order, into the
// block's own f32 partial [po] in global memory (L2-resident at the
// flagship); a second kernel sums the S partials of each group in a fixed
// order. No float atomics: two runs on the same inputs give the same bits.
//
// Thread (warp tr, lane tc) owns the rows tr*RM .. tr*RM+RM-1 and the
// columns tc, tc+32, ... of a [TP, n] tile (as in K1), which keeps the
// forward activations, du and the resblock's dh in registers. The two
// transposed products take their own mappings: dW = H^T dz (a sum over the
// tile's points) gives thread (tr, tc) rows k of dW and the same columns;
// du = dz W^T stages W^T through shared memory (rows padded to n+1 floats
// to keep the transposing store free of bank conflicts).
#include "shapenet_common.cuh"

namespace {

constexpr int kMaxSplits = 8;        // point-tile runs per group
constexpr int kWChunkFloats = 4096;  // staged weight floats per chunk

struct Args {
  const void* wb;      // wb' [G, po], T
  const void* x;       // [G, P, si], T
  const void* target;  // K2: [G, P, so], T
  const void* weight;  // K2: [G, P], T, or null
  const void* g_out;   // K3: [G, P, so], T
  void* dx;            // K3: [G, P, si], T
  float* partials;     // [G, S, po] weight-grad partials, then [G, S] loss partials
  void* scratch;       // residuals of each block when they live in global memory
  int G, P, si, so, n, n_mats, chain, act, train, kc;
  long long po, resid_bytes;  // per block
  int resid_in_smem;
};

template <typename T, int RM, int RN>
__global__ void __launch_bounds__(kThreads) shapenet_bwd_kernel(const Args a) {
  constexpr int TP = RM * kWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, si = a.si, so = a.so, n_mats = a.n_mats;
  float* DZ = reinterpret_cast<float*>(smem_raw);  // [TP, n] lifted dz, f32
  float* ws = DZ + TP * n;                          // [kc, n + 1] staged weights
  unsigned char* res = a.resid_in_smem
                           ? reinterpret_cast<unsigned char*>(ws + (size_t)a.kc * (n + 1))
                           : static_cast<unsigned char*>(a.scratch) +
                                 ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * a.resid_bytes;
  float* GO = reinterpret_cast<float*>(res);  // [TP, so] dL/dout, f32
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
  const long long o_b0 = o_wl + (long long)n * so;
  const long long o_bh = o_b0 + n;
  const long long o_bl = o_bh + (long long)n_mats * n;
  const T* wbase = static_cast<const T*>(a.wb);

  for (int g = blockIdx.y; g < a.G; g += gridDim.y) {
    const T* wg = wbase + (long long)g * a.po;
    float* part = a.partials + ((long long)g * S + s) * a.po;
    float loss_acc = 0.f;
    for (int tile = t_begin; tile < t_end; ++tile) {
      const bool first = tile == t_begin;
      const int p0 = tile * TP;
      const int rows = min(TP, a.P - p0);
      const long long row0 = (long long)g * a.P + p0;
      __syncthreads();  // the previous tile has finished with every buffer
      const T* xg = static_cast<const T*>(a.x) + row0 * si;
      for (int idx = threadIdx.x; idx < TP * si; idx += kThreads)
        X[idx] = idx < rows * si ? xg[idx] : from_f32<T>(0.f);

      // ---- forward, saving H[m] (input of hidden matrix m, or of the last
      // layer for m = n_mats) and D[m] (derivative of activated layer m)
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
            } else if (a.chain == kVanilla) {
              u[i][j] = y + u[i][j];
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
      __syncthreads();  // H[n_mats] is complete

      // ---- dL/dout of the tile into GO (zero past the ragged edge)
      if (a.train) {
        // out = lift(u) @ W_last + b_last in f32, one warp per (row, output)
        const T* tg = static_cast<const T*>(a.target) + row0 * so;
        const T* wt = a.weight ? static_cast<const T*>(a.weight) + row0 : nullptr;
        for (int pr = warp; pr < TP * so; pr += kWarps) {
          const int r = pr / so;
          const int j = pr - r * so;
          if (r >= rows) {
            if (tc == 0) GO[pr] = 0.f;
            continue;
          }
          float sum = 0.f;
          for (int k = tc; k < n; k += kLanes)
            sum = fmaf(to_f32(Hl[r * n + k]), to_f32(wl[(long long)k * so + j]), sum);
#pragma unroll
          for (int off = kLanes / 2; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          if (tc == 0) {
            const float out = sum + to_f32(wg[o_bl + j]);
            const float err = out - to_f32(tg[pr]);
            const float w = wt ? to_f32(wt[r]) : 1.f;
            loss_acc += err * err * w;
            GO[pr] = 2.f * err * w;
          }
        }
      } else {
        const T* gg = static_cast<const T*>(a.g_out) + row0 * so;
        for (int idx = threadIdx.x; idx < TP * so; idx += kThreads)
          GO[idx] = idx < rows * so ? to_f32(gg[idx]) : 0.f;
      }
      __syncthreads();  // GO is complete

      // ---- last layer: dW_l = lift(u)^T lift(go), db_l = sum lift(go)
      for (int idx = threadIdx.x; idx < n * so; idx += kThreads) {
        const int k = idx / so;
        const int j = idx - k * so;
        float sum = 0.f;
        for (int r = 0; r < rows; ++r)
          sum = fmaf(to_f32(Hl[r * n + k]), lift<T>(GO[r * so + j]), sum);
        accumulate(part + o_wl + idx, sum, first);
      }
      for (int j = threadIdx.x; j < so; j += kThreads) {
        float sum = 0.f;
        for (int r = 0; r < rows; ++r) sum += lift<T>(GO[r * so + j]);
        accumulate(part + o_bl + j, sum, first);
      }
      // du = go * w_last (so == 1, on the f32 go) or lift(go) @ W_last^T
      float du[RM][RN], dh[RM][RN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int c = tc + j * kLanes;
          float v = 0.f;
          if (c < n) {
            if (so == 1) {
              v = GO[r0 + i] * to_f32(wl[c]);
            } else {
              for (int jj = 0; jj < so; ++jj)
                v = fmaf(lift<T>(GO[(r0 + i) * so + jj]), to_f32(wl[(long long)c * so + jj]), v);
            }
          }
          du[i][j] = v;
          dh[i][j] = 0.f;
        }

      // ---- hidden layers, last to first
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
            } else if (a.chain == kVanilla) {
              du[i][j] = du[i][j] + acc[i][j];
            } else {
              du[i][j] = acc[i][j];
            }
          }
      }

      // ---- first layer: dz0 = lift(du * D[0]); dW_0 = x^T dz0, db_0, dx
      store_dz<T, RM, RN>(DZ, D, n, r0, tc, du, 1.f);
      __syncthreads();
      weight_grad<T, RM, RN>(X, si, si, DZ, n, rows, part, first, warp, tc);
      bias_grad(DZ, n, rows, part + o_b0, first);
      if (!a.train) {
        // dx = dz0 @ W0'^T, one warp per (row, input)
        T* dxg = static_cast<T*>(a.dx) + row0 * si;
        for (int pr = warp; pr < rows * si; pr += kWarps) {
          const int r = pr / si;
          const int i = pr - r * si;
          float sum = 0.f;
          for (int c = tc; c < n; c += kLanes)
            sum = fmaf(DZ[r * n + c], to_f32(wg[(long long)i * n + c]), sum);
#pragma unroll
          for (int off = kLanes / 2; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          if (tc == 0) dxg[pr] = from_f32<T>(sum);
        }
      }
    }

    if (a.train) {
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
        a.partials[(long long)a.G * S * a.po + (long long)g * S + s] = total;
      }
    }
  }
}

// d_wb[g][p] = T((sum_s partial[g][s][p]) * (p < n_scaled ? omega : 1) / div),
// the S splits summed in order; with a loss, one thread sums the G*S loss
// partials in order and divides by n_elem.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const float* __restrict__ partials, int G, int S, long long po,
                  long long n_scaled, float omega, int divide, float n_elem, T* __restrict__ d_wb,
                  float* __restrict__ loss) {
  const long long total = (long long)G * po;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * kThreads) {
    const long long g = idx / po;
    const long long p = idx - g * po;
    const float* src = partials + g * S * po + p;
    float sum = 0.f;
    for (int s = 0; s < S; ++s) sum += src[s * po];
    if (p < n_scaled) sum = sum * omega;
    if (divide) sum = sum / n_elem;
    d_wb[idx] = from_f32<T>(sum);
  }
  if (loss != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    const float* lp = partials + (long long)G * S * po;
    float sum = 0.f;
    for (long long i = 0; i < (long long)G * S; ++i) sum += lp[i];
    *loss = sum / n_elem;
  }
}

struct Geometry {
  int rn, tile, kc, splits, grid_g, resid_in_smem;
  size_t smem, resid_bytes;
};

// K1's width rule (columns per thread rn = ceil(n / 32) rounded up to a
// power of two, at most 32; rows per thread and tile as K1), so K2 and K3
// take every width K1 takes. Shared memory holds the dz tile and a weight
// chunk; the residuals join them when they fit and otherwise live in global
// scratch, so no input width is refused here.
int geometry(int n, int si, int so, int n_mats, int G, int P, int elem, Geometry* g) {
  if (n < 1 || si < 1 || so < 1 || n_mats < 0 || G < 1 || P < 1) return 3;
  const int rn = columns_per_thread(n);
  if (rn == 0) return 1;
  g->rn = rn;
  g->tile = rows_per_thread(rn) * kWarps;
  g->kc = kWChunkFloats / n > 1 ? kWChunkFloats / n : 1;
  const int n_tiles = (P + g->tile - 1) / g->tile;
  g->splits = n_tiles < kMaxSplits ? n_tiles : kMaxSplits;
  g->grid_g = G < 65535 ? G : 65535;
  const size_t work = sizeof(float) * ((size_t)g->tile * n + (size_t)g->kc * (n + 1));
  size_t resid = sizeof(float) * (size_t)g->tile * so +
                 (size_t)elem * ((size_t)g->tile * si + 2 * (size_t)(n_mats + 1) * g->tile * n);
  resid = (resid + 15) / 16 * 16;
  g->resid_bytes = resid;
  g->resid_in_smem = work + resid <= kMaxSmem;
  g->smem = g->resid_in_smem ? work + resid : work;
  return g->smem > kMaxSmem ? 2 : 0;
}

template <typename T, int RN>
int launch(const Geometry& geo, Args a, T* d_wb, float* loss, long long n_scaled, float omega,
           cudaStream_t stream) {
  constexpr int RM = rows_per_thread(RN);
  auto kernel = shapenet_bwd_kernel<T, RM, RN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
  if (err != cudaSuccess) return (int)err;
  a.kc = geo.kc;
  a.resid_bytes = (long long)geo.resid_bytes;
  a.resid_in_smem = geo.resid_in_smem;
  kernel<<<dim3(geo.splits, geo.grid_g), kThreads, geo.smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks = stride_blocks((long long)a.G * a.po);
  const float n_elem = (float)((long long)a.G * a.P * a.so);
  reduce_kernel<T><<<blocks, kThreads, 0, stream>>>(a.partials, a.G, geo.splits, a.po, n_scaled,
                                                    omega, a.train, n_elem, d_wb, loss);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Geometry& g, const Args& a, void* d_wb, float* loss, long long n_scaled,
             float omega, cudaStream_t s) {
  T* out = static_cast<T*>(d_wb);
  return with_rn(g.rn, [&](auto rn) {
    return launch<T, decltype(rn)::value>(g, a, out, loss, n_scaled, omega, s);
  });
}

int run(Args a, void* d_wb, float* loss, long long n_scaled, float omega, int dtype, void* stream) {
  Geometry g{};
  const int elem = dtype == 0 ? 4 : 2;
  if (dtype < 0 || dtype > 1 ||
      geometry(a.n, a.si, a.so, a.n_mats, a.G, a.P, elem, &g) != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(g, a, d_wb, loss, n_scaled, omega, s);
  return dispatch<__nv_bfloat16>(g, a, d_wb, loss, n_scaled, omega, s);
}

}  // namespace

extern "C" {

// The geometry K2 and K3 take (0 = ok; 1 = too wide; 3 = bad shape): points
// per tile, P splits per group, dynamic shared memory per block, the f32
// partials the caller allocates (G*S*po weight grads, then G*S losses) and
// the bytes of residual scratch (0 when the residuals fit in shared memory).
int nif_shapenet_bwd_workspace(int n, int si, int so, int n_mats, int G, int P, int dtype,
                               int* tile, int* splits, long long* smem_bytes,
                               long long* partial_floats, long long* scratch_bytes) {
  Geometry g{};
  const int status = geometry(n, si, so, n_mats, G, P, dtype == 0 ? 4 : 2, &g);
  if (status != 0) return status;
  const long long po = (long long)n_mats * n * n + (long long)(si + so + 1 + n_mats) * n + so;
  *tile = g.tile;
  *splits = g.splits;
  *smem_bytes = (long long)g.smem;
  *partial_floats = (long long)G * g.splits * po + (long long)G * g.splits;
  *scratch_bytes = g.resid_in_smem ? 0 : (long long)g.grid_g * g.splits * (long long)g.resid_bytes;
  return 0;
}

// K2. dtype: 0 = float, 1 = bf16 (wb', x, target, weight and d_wb share it).
// weight may be null. Returns the CUDA error of the launches (0 on success);
// the kernels run asynchronously on `stream`.
int nif_shapenet_mse_grads(const void* wb, const void* x, const void* target, const void* weight,
                           void* loss, void* d_wb, void* partials, void* scratch, int G, int P,
                           int si, int so, int n, int n_mats, int chain, int act, long long po,
                           long long n_scaled, float omega, int dtype, void* stream) {
  Args a{};
  a.wb = wb;
  a.x = x;
  a.target = target;
  a.weight = weight;
  a.partials = static_cast<float*>(partials);
  a.scratch = scratch;
  a.G = G; a.P = P; a.si = si; a.so = so; a.n = n; a.n_mats = n_mats;
  a.chain = chain; a.act = act; a.train = 1; a.po = po;
  return run(a, d_wb, static_cast<float*>(loss), n_scaled, omega, dtype, stream);
}

// K3: g_out [G, P, so] -> d_wb [G, po] (not divided), dx [G, P, si].
int nif_shapenet_bwd(const void* wb, const void* x, const void* g_out, void* d_wb, void* dx,
                     void* partials, void* scratch, int G, int P, int si, int so, int n,
                     int n_mats, int chain, int act, long long po, long long n_scaled,
                     float omega, int dtype, void* stream) {
  Args a{};
  a.wb = wb;
  a.x = x;
  a.g_out = g_out;
  a.dx = dx;
  a.partials = static_cast<float*>(partials);
  a.scratch = scratch;
  a.G = G; a.P = P; a.si = si; a.so = so; a.n = n; a.n_mats = n_mats;
  a.chain = chain; a.act = act; a.train = 0; a.po = po;
  return run(a, d_wb, nullptr, n_scaled, omega, dtype, stream);
}

const char* nif_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
