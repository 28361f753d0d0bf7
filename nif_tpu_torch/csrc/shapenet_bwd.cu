// K2 and K3 on Hopper's CUDA cores: the residual-saving forward and the
// backward of the grouped ShapeNet chain, in one body (one nvcc build).
//
// K2 replaces nif_tpu/ops/pallas_shapenet.py::_train_kernel (reached through
// shapenet_mse_grads): forward, weighted MSE and backward in one pass, no dx:
//   wb' [G, ldwb] f32 (omega_0 folded into the sine-fed weights by the
//   wrapper, at wb's dtype, then widened to f32), x [G, P, si], target
//   [G, P, so], weight [G, P] (optional; all three in x's dtype T)  ->  loss
//   (f32 scalar), d_wb [G, po] in T, both / G*P*so.
// K3 replaces _bwd_kernel (the backward of shapenet_grouped_fused, reached
// through _fused_bwd): recompute the forward with its residuals, then take
//   g_out [G, P, so] (T)  ->  d_wb [G, po] (not divided), dx [G, P, si].
// In both, the sine-fed weight grads are multiplied back by omega_0 in f32
// (_unscale_grads) before the cast to T. The float32 policy's train step
// runs this K2 (the tensor-core K2 of shapenet_bwd_tc.cu takes bf16 sine
// chains); K3 runs for every dtype.
//
// The rounding points are the reference's (_forward_layers(save=True),
// _backward_chain): each layer saves its input and its activation
// DERIVATIVE, both rounded to the compute dtype T; the backward carries du in
// f32, rounds dz = du * act' to T before its weight product and bias sum,
// takes 0.5 on both resblock branches and adds the vanilla shortcut straight
// through. For so == 1, du starts as the f32 go times the last weight column.
// Every product is an f32 FMA on the CUDA cores (a bf16 x bf16 product is
// exact in f32; the f32 path must not use TF32). f32 sine chains take the
// true sine, bf16 ones the polynomial.
//
// What bounds them on an H100 SXM: operations. At the flagship train shape
// (G=32, P=32768, width 128, two hidden layers, si=3, so=1) K2 is ~208.6
// GFLOP of products (forward 69.8, dW 69.8, du 69.0) against ~17 MB of
// compulsory traffic, so the 67 TFLOP/s f32 FMA peak bounds it at ~3.2 ms.
//
// Design (the tile machinery is stack_simt.cuh's):
// - One body template, simt_train_kernel<T, CHAIN, L, ACT, RES>: the chain,
//   the activation (true sine, polynomial sine, or the vanilla chain's
//   code) and the register tile are compile-time, so no epilogue branches
//   on them; RES says where the residuals sit.
// - A tile is TP points (64 at the flagship width: 8 rows a thread in
//   register tiles of 8 x 4, a warp 4 row groups by 8 column groups). Its
//   residuals are f32 planes [TP, COLS + 4]: each layer's input H, its act'
//   D (dz overwrites D in place), for bf16 resblock and vanilla chains the
//   running f32 u (for f32 chains H is u), the x tile, the target (then
//   dL/dout) and the point weights. At the flagship all of them, 204 KB, sit
//   in shared memory beside two 10 KB weight buffers and W_last with the
//   biases; wider or deeper chains keep them in a per-block slice of a
//   global scratch.
// - The products of a tile form one stream of W chunks through cp.async
//   (kc = 16 rows of W for the forward, 16 columns for du = dz W^T at the
//   flagship): the next chunk, or the next product's first, streams in
//   while the current one is multiplied, one barrier a chunk.
// - dW = H^T dz takes passes of TP rows of dW, each thread an 8 x 4 block,
//   and adds them, in tile order, into the block's own f32 partial [po4] in
//   global memory (L2-resident), whose old values it loads before the
//   products. A second kernel sums the S partials of each group in a fixed
//   order. No float atomics: two runs on the same inputs give the same bits.
// - The grid is (S, G) with S = SMs / G splits of a group's tiles: one
//   wave of one block per SM (shared memory allows no second at the
//   flagship).
// scripts/port_phase_probe.py --kernel k2f32 (or k3f32) splits a tile's
// time by phase; PERF.md has the split.
#include "stack_simt.cuh"

namespace {

constexpr int kMaxSplits = 64;  // point-tile runs per group
constexpr int kMaxChunk = 32;   // weight rows (or columns) per staged chunk

__host__ __device__ constexpr long long round4(long long v) { return (v + 3) / 4 * 4; }

// Built with -DK2F_PHASE_CLOCKS (by scripts/port_phase_probe.py only), thread
// 0 of every block adds the clock64() cycles from one mark to the next into
// ten phase counters, which split the block's critical path.
#ifdef K2F_PHASE_CLOCKS
constexpr int kPhases = 10;
__device__ unsigned long long k2f_phase_cycles[kPhases];
#define K2F_PHASE(i)                                       \
  do {                                                     \
    if (threadIdx.x == 0) {                                \
      const long long now = clock64();                     \
      phase_sum[i] += (unsigned long long)(now - phase_t); \
      phase_t = now;                                       \
    }                                                      \
  } while (0)
#else
#define K2F_PHASE(i) \
  do {               \
  } while (0)
#endif

struct Args {
  const float* wb;     // wb' [G, ldwb], f32
  const void* x;       // [G, P, si], T
  const void* target;  // K2: [G, P, so], T
  const void* weight;  // K2: [G, P], T, or null
  const void* g_out;   // K3: [G, P, so], T
  void* dx;            // K3: [G, P, si], T
  float* partials;     // [G, S, po4] weight-grad partials, then [G, S] loss partials
  float* scratch;      // the residuals of each block when they live in global memory
  int G, P, si, so, n, n_mats, act, train;
  int six, kc, stage_buf, params_in_smem;
  long long po4, ldwb, resid_floats;
};

// RES: where the residuals sit: 1 = shared memory (the planes derive from
// the dynamic shared array alone, so their loads compile to shared-memory
// loads, not generic ones, which were slower on an H100), 0 = the block's
// slice of the global scratch. ACT is made from a.act once a kernel.
template <typename T, int CHAIN, class L, class ACT, int RES>
__global__ void __launch_bounds__(kThreads, 1) simt_train_kernel(const Args a) {
  constexpr int TP = L::TP, LD = L::LD;
  // bf16 resblock and vanilla chains carry the running u in an f32 plane of
  // its own; in f32 the saved layer input is u itself
  constexpr bool kU = !std::is_same<T, float>::value && CHAIN != kSirenPlain;
  extern __shared__ __align__(16) float smem[];
  const int n = a.n, si = a.si, so = a.so, nm = a.n_mats;
  const size_t plane = (size_t)TP * LD;
  const int S = gridDim.x, s = blockIdx.x;
  const ACT act(a.act);
  float* res = RES == 1 ? smem
                        : a.scratch + ((size_t)blockIdx.y * S + s) * (size_t)a.resid_floats;
  float* H = res;                           // [nm + 1][TP, LD] layer inputs
  float* D = H + (size_t)(nm + 1) * plane;  // [nm + 1][TP, LD] act', then dz
  float* U = D + (size_t)(nm + 1) * plane;  // [TP, LD] the running u (kU only)
  float* X = U + (kU ? plane : 0);          // [TP, six] the x tile
  float* GO = X + (size_t)TP * a.six;       // [TP, so] the target (K2), then dL/dout
  float* WT = GO + (size_t)TP * so;         // [TP] the point weights (K2)
  float* wbuf = smem + (RES == 1 ? a.resid_floats : 0);
  const bool vec = n % 4 == 0;
  WStage st{wbuf, a.stage_buf, a.kc, vec, 0};
  const Slot<L> sl;

  const int tc = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int n_tiles = (a.P + TP - 1) / TP;
  const int t_begin = (int)((long long)s * n_tiles / S);
  const int t_end = (int)((long long)(s + 1) * n_tiles / S);
  const int n4 = (n + 3) / 4 * 4;

  const long long o_wh = (long long)si * n;
  const long long o_wl = o_wh + (long long)nm * n * n;
  const long long o_b0 = o_wl + (long long)n * so;
  const long long o_bh = o_b0 + n;
  const long long o_bl = o_bh + (long long)nm * n;
#ifdef K2F_PHASE_CLOCKS
  unsigned long long phase_sum[kPhases] = {};
  long long phase_t = clock64();
#endif

  for (int g = blockIdx.y; g < a.G; g += gridDim.y) {
    const float* wg = a.wb + (long long)g * a.ldwb;
    float* part = a.partials + ((long long)g * S + s) * a.po4;
    // W_last [n, so], then the biases b0, b_h and b_last, then W0' [si, n]
    // (K3's dx): in shared memory where they fit (shown to the block by the
    // first product's barrier)
    const float* WL = wg + o_wl;
    const float* W0 = wg;
    if (a.params_in_smem) {
      float* params = wbuf + 2 * a.stage_buf;
      const int tail = (so + 1 + nm) * n + so;
      float* w0 = params + round4(tail);
      __syncthreads();  // the previous group is done with them
      for (int idx = threadIdx.x; idx < tail; idx += kThreads) params[idx] = WL[idx];
      for (int idx = threadIdx.x; idx < si * n; idx += kThreads) w0[idx] = W0[idx];
      WL = params;
      W0 = w0;
    }
    const float* B0 = WL + (o_b0 - o_wl);
    const float* BL = WL + (o_bl - o_wl);
    // The products of a tile in order, each staging the next one's first
    // chunk of W: step 0 the first layer, 1 .. nm the hidden forward
    // products, nm + 1 .. 2 nm the du products of m = 2 nm - step, then the
    // next tile's step 0.
    auto stage_step = [&](int step, float* buf) {
      if (step == 0)
        stage_fwd_head<L>(buf, st, wg, n, a.six, si, n);
      else if (step <= nm)
        stage_fwd_head<L>(buf, st, wg + o_wh + (long long)(step - 1) * n * n, n, n4, n, n);
      else
        stage_bwd_head<L>(buf, st, wg + o_wh + (long long)(2 * nm - step) * n * n, n, n);
    };
    __syncthreads();  // the previous group is done with the weight buffers
    stage_step(0, st.ws + st.parity * st.buf);
    cp_commit();
    float loss_acc = 0.f;
    for (int tile = t_begin; tile < t_end; ++tile) {
      const bool first = tile == t_begin;
      const auto after = [&](int step) {
        return [&, step](float* buf) {
          if (step < 2 * nm)
            stage_step(step + 1, buf);
          else if (tile + 1 < t_end)
            stage_step(0, buf);
        };
      };
      const int p0 = tile * TP;
      const int rows = min(TP, a.P - p0);
      const long long row0 = (long long)g * a.P + p0;
      __syncthreads();  // the previous tile has finished with every plane
      // the tile's inputs, f32, zero past the ragged edge: x, and the target
      // and point weights (K2) or g_out (K3), read by the last layer
      const T* xg = static_cast<const T*>(a.x) + row0 * si;
      for (int idx = threadIdx.x; idx < TP * a.six; idx += kThreads) {
        const int r = idx / a.six;
        const int c = idx - r * a.six;
        X[idx] = r < rows && c < si ? to_f32(xg[r * si + c]) : 0.f;
      }
      const T* og = static_cast<const T*>(a.train ? a.target : a.g_out) + row0 * so;
      for (int idx = threadIdx.x; idx < TP * so; idx += kThreads)
        GO[idx] = idx < rows * so ? to_f32(og[idx]) : 0.f;
      if (a.train) {
        const T* wt = static_cast<const T*>(a.weight) + row0;
        for (int r = threadIdx.x; r < TP; r += kThreads)
          WT[r] = a.weight && r < rows ? to_f32(wt[r]) : 1.f;
      }

      // ---- forward: H[m + 1] (input of hidden matrix m + 1, or of the last
      // layer) and D[m + 1] (act' of hidden matrix m; D[0] the first layer's)
      Acc<L> acc;
      for (int m = -1; m < nm; ++m) {
        // one call for the first layer (A the x tile, W0' [si, n]) and the
        // hidden ones (A the plane H[m], W_m [n, n]), so its code is inlined once
        const bool x_in = m < 0;
        product_fwd<L>(x_in ? X : H + m * plane, x_in ? a.six : LD, x_in ? a.six : n4,
                       x_in ? wg : wg + o_wh + (long long)m * n * n, n, x_in ? si : n, n, st,
                       sl, acc, after(m + 1));
        if (!x_in) K2F_PHASE(1);  // a hidden forward product
        const float* bg = B0 + (m < 0 ? 0 : n + (long long)m * n);
        float* Dm = D + (m + 1) * plane;
        float* Hn = H + (m + 1) * plane;
        // the running u continues from matrix m - 1 (resblock: the block's
        // second matrix) or m (vanilla); a resblock's first matrix feeds h on
        const bool carry = m >= 0 && (CHAIN == kVanilla || (CHAIN == kSirenResblock && m % 2));
        const float* u_in = kU || !carry ? U : H + (CHAIN == kVanilla ? m : m - 1) * plane;
#pragma unroll
        for (int b = 0; b < L::NB; ++b) {
          float bias[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = sl.vcol(b, e);
            bias[e] = c < n ? bg[c] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < L::RM; ++i) {
            const int o = sl.row(i) * LD + sl.vcol(b, 0);
            float y[4], d[4], nx[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) y[e] = act(acc[i][b][e] + bias[e], &d[e]);
            if (carry) {
              const float4 u = *reinterpret_cast<const float4*>(u_in + o);
              const float uo[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
              for (int e = 0; e < 4; ++e)
                nx[e] = CHAIN == kVanilla ? y[e] + uo[e] : 0.5f * (uo[e] + y[e]);
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) nx[e] = y[e];
            }
            if (kU && (m < 0 || carry))
              *reinterpret_cast<float4*>(U + o) = make_float4(nx[0], nx[1], nx[2], nx[3]);
            *reinterpret_cast<float4*>(Dm + o) =
                make_float4(lift<T>(d[0]), lift<T>(d[1]), lift<T>(d[2]), lift<T>(d[3]));
            *reinterpret_cast<float4*>(Hn + o) =
                make_float4(lift<T>(nx[0]), lift<T>(nx[1]), lift<T>(nx[2]), lift<T>(nx[3]));
          }
        }
        if (m < 0) {
          K2F_PHASE(0);  // the x tile and the first layer
        } else {
          K2F_PHASE(2);  // thread 0's hidden forward epilogue
        }
      }
      const float* Hl = H + nm * plane;
      __syncthreads();  // H[nm] is complete

      // ---- K2: dL/dout of the tile over its target in GO (zero past the
      // ragged edge); K3's g_out is in GO already
      if (a.train) {
        // out = lift(u) @ W_last + b_last in f32, one warp per (row, output)
        for (int pr = warp; pr < rows * so; pr += kWarps) {
          const int r = pr / so;
          const int j = pr - r * so;
          float sum = 0.f;
          for (int k = tc; k < n; k += kLanes) sum = fmaf(Hl[r * LD + k], WL[k * so + j], sum);
#pragma unroll
          for (int off = kLanes / 2; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          if (tc == 0) {
            const float out = sum + BL[j];
            const float err = out - GO[pr];
            const float w = WT[r];
            loss_acc += err * err * w;
            GO[pr] = 2.f * err * w;
          }
        }
      }
      __syncthreads();  // GO is complete
      K2F_PHASE(3);     // the last product and the loss

      // ---- last layer: dW_l = lift(u)^T lift(go), db_l = sum lift(go) (go
      // is zero past the ragged edge)
      for (int idx = threadIdx.x; idx < n * so; idx += kThreads) {
        const int k = idx / so;
        const int j = idx - k * so;
        tile_sum<TP>(part + o_wl + idx, first, [&](int r, float sum) {
          return fmaf(Hl[r * LD + k], lift<T>(GO[r * so + j]), sum);
        });
      }
      for (int j = kThreads - 1 - threadIdx.x; j < so; j += kThreads)  // the last threads
        tile_sum<TP>(part + o_bl + j, first,
                     [&](int r, float sum) { return sum + lift<T>(GO[r * so + j]); });
      // du = go * w_last (so == 1, on the f32 go) or lift(go) @ W_last^T, in
      // the grad layout; dh (resblock) likewise
      Acc<L> du, dh;
#pragma unroll
      for (int i = 0; i < L::RM; ++i)
#pragma unroll
        for (int b = 0; b < L::NB; ++b)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = sl.gcol(b, j);
            const int r = sl.row(i);
            float v = 0.f;
            if (k < n) {
              if (so == 1) {
                v = GO[r] * WL[k];
              } else {
                for (int jj = 0; jj < so; ++jj)
                  v = fmaf(lift<T>(GO[r * so + jj]), WL[k * so + jj], v);
              }
            }
            du[i][b][j] = v;
            dh[i][b][j] = 0.f;
          }
      K2F_PHASE(4);  // the last layer's backward

      // ---- hidden layers, last to first
      for (int m = nm - 1; m >= 0; --m) {
        float* Dm = D + (m + 1) * plane;
        const bool res_second = CHAIN == kSirenResblock && m % 2 == 1;
        const bool res_first = CHAIN == kSirenResblock && m % 2 == 0;
        const float scale = res_second ? 0.5f : 1.f;
        // dz = lift(scale * g * act') over act' in place (g is du or dh)
#pragma unroll
        for (int i = 0; i < L::RM; ++i)
#pragma unroll
          for (int b = 0; b < L::NB; ++b)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int o = sl.row(i) * LD + sl.gcol(b, j);
              const float gv = res_first ? dh[i][b][j] : du[i][b][j];
              Dm[o] = lift<T>(scale * gv * Dm[o]);
            }
        __syncthreads();  // dz is complete
        K2F_PHASE(5);     // a dz epilogue
        weight_grad<L>(H + m * plane, LD, n, Dm, LD, n, part + o_wh + (long long)m * n * n, first,
                       vec, sl);
        for (int c = threadIdx.x; c < n; c += kThreads)
          tile_sum<TP>(part + o_bh + (long long)m * n + c, first,
                       [&](int r, float sum) { return sum + Dm[r * LD + c]; });
        K2F_PHASE(6);  // a hidden dW and db, partial updates included
        product_bwd<L>(Dm, LD, wg + o_wh + (long long)m * n * n, n, n, st, sl, acc,
                       after(2 * nm - m));
#pragma unroll
        for (int i = 0; i < L::RM; ++i)
#pragma unroll
          for (int b = 0; b < L::NB; ++b)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (res_second) {
                dh[i][b][j] = acc[i][b][j];
              } else if (res_first) {
                du[i][b][j] = 0.5f * du[i][b][j] + acc[i][b][j];
              } else if (CHAIN == kVanilla) {
                du[i][b][j] = du[i][b][j] + acc[i][b][j];
              } else {
                du[i][b][j] = acc[i][b][j];
              }
            }
        K2F_PHASE(7);  // a du product
      }

      // ---- first layer: dz0 = lift(du * D[0]); dW_0 = x^T dz0, db_0, dx
#pragma unroll
      for (int i = 0; i < L::RM; ++i)
#pragma unroll
        for (int b = 0; b < L::NB; ++b)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int o = sl.row(i) * LD + sl.gcol(b, j);
            D[o] = lift<T>(du[i][b][j] * D[o]);
          }
      __syncthreads();
      for (int idx = threadIdx.x; idx < si * n; idx += kThreads) {
        const int i = idx / n;
        const int c = idx - i * n;
        tile_sum<TP>(part + idx, first, [&](int r, float sum) {
          return fmaf(X[r * a.six + i], D[r * LD + c], sum);
        });
      }
      for (int c = kThreads - 1 - threadIdx.x; c < n; c += kThreads)  // the last threads first
        tile_sum<TP>(part + o_b0 + c, first, [&](int r, float sum) { return sum + D[r * LD + c]; });
      if (!a.train) {
        // dx = dz0 @ W0'^T, one thread per (row, input), summed in order of c
        T* dxg = static_cast<T*>(a.dx) + row0 * si;
        for (int pr = threadIdx.x; pr < rows * si; pr += kThreads) {
          const int r = pr / si;
          const int i = pr - r * si;
          float sum = 0.f;
#pragma unroll 8
          for (int c = 0; c < n; ++c) sum = fmaf(D[r * LD + c], W0[i * n + c], sum);
          dxg[pr] = from_f32<T>(sum);
        }
      }
      K2F_PHASE(8);  // the first layer's backward
    }

    if (a.train) {
      // the block's loss partial: warps in order, then their sums in order
      __syncthreads();  // every thread is done with the weight buffers
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        loss_acc += __shfl_xor_sync(0xffffffffu, loss_acc, off);
      if (tc == 0) wbuf[warp] = loss_acc;
      __syncthreads();
      if (threadIdx.x == 0) {
        float total = 0.f;
        for (int w = 0; w < kWarps; ++w) total += wbuf[w];
        a.partials[(long long)a.G * S * a.po4 + (long long)g * S + s] = total;
      }
    }
    K2F_PHASE(9);  // the group's loss partial
  }
#ifdef K2F_PHASE_CLOCKS
  if (threadIdx.x == 0)
    for (int i = 0; i < kPhases; ++i) atomicAdd(&k2f_phase_cycles[i], phase_sum[i]);
#endif
}

// d_wb[g][p] = T((sum_s partial[g][s][p]) * (p < n_scaled ? omega : 1) / div),
// the S splits summed in order; with a loss, one thread sums the G*S loss
// partials in order and divides by n_elem.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const float* __restrict__ partials, int G, int S, long long po, long long po4,
                  long long n_scaled, float omega, int divide, float n_elem, T* __restrict__ d_wb,
                  float* __restrict__ loss) {
  const long long total = (long long)G * po;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * kThreads) {
    const long long g = idx / po;
    const long long p = idx - g * po;
    const float* src = partials + g * S * po4 + p;
    float sum = 0.f;
    for (int s = 0; s < S; ++s) sum += src[s * po4];
    if (p < n_scaled) sum = sum * omega;
    if (divide) sum = sum / n_elem;
    d_wb[idx] = from_f32<T>(sum);
  }
  if (loss != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    const float* lp = partials + (long long)G * S * po4;
    float sum = 0.f;
    for (long long i = 0; i < (long long)G * S; ++i) sum += lp[i];
    *loss = sum / n_elem;
  }
}

struct Geometry {
  int layout, tile, six, kc, stage_buf, splits, grid_g, resid_in_smem, params_in_smem;
  size_t smem, resid_floats;
};

// The tile layout for width n (stack_simt.cuh's simt_layout: every width up
// to kMaxRn * 32 = 1024), the residual region of a block (floats: the H and
// D planes, the u plane of bf16 resblock and vanilla chains, the x tile,
// dL/dout and the point weights), and shared memory for the two weight buffers, the residuals where
// they fit beside them (else a global scratch), and W_last with the biases
// where they fit too. The chunk is the largest of 32, 24, 16, 8 rows that fits.
// 0 = ok; 1 = too wide; 2 = even the weight buffers exceed shared memory;
// 3 = bad shape.
int geometry(int n, int si, int so, int n_mats, int chain, int elem, int G, int P, Geometry* g) {
  if (n < 1 || si < 1 || so < 1 || n_mats < 0 || G < 1 || P < 1) return 3;
  g->layout = simt_layout(n);
  if (g->layout < 0) return 1;
  g->tile = simt_tile_points(g->layout);
  const int cols = simt_tile_cols(g->layout);
  g->six = (int)round4(si);
  const bool uplane = elem == 2 && chain != kSirenPlain;
  g->resid_floats = ((size_t)2 * (n_mats + 1) + (uplane ? 1 : 0)) * g->tile * (cols + 4) +
                    (size_t)g->tile * g->six + round4((long long)g->tile * (so + 1));
  // W_last, the biases and W0'
  const size_t params = round4((long long)(so + 1 + n_mats) * n + so) + round4((long long)si * n);
  auto bytes = [&](bool resid, int kc, bool with_params) {
    return sizeof(float) * ((resid ? g->resid_floats : 0) + 2 * (size_t)stage_floats(cols, kc) +
                            (with_params ? params : 0));
  };
  g->resid_in_smem = bytes(true, 8, false) <= kMaxSmem;
  const int widest = ((n > g->six ? n : g->six) + 7) / 8 * 8;
  g->kc = 0;
  for (int kc = kMaxChunk; kc >= 8; kc -= 8)
    if ((kc <= widest || kc == 8) && bytes(g->resid_in_smem, kc, false) <= kMaxSmem) {
      g->kc = kc;
      break;
    }
  if (g->kc == 0) return 2;
  g->stage_buf = stage_floats(cols, g->kc);
  g->params_in_smem = bytes(g->resid_in_smem, g->kc, true) <= kMaxSmem;
  g->smem = bytes(g->resid_in_smem, g->kc, g->params_in_smem);
  const int n_tiles = (P + g->tile - 1) / g->tile;
  const int sms = sm_count();
  int splits = sms > G ? sms / G : 1;
  splits = splits < kMaxSplits ? splits : kMaxSplits;
  g->splits = splits < n_tiles ? splits : n_tiles;
  g->grid_g = G < 65535 ? G : 65535;
  return 0;
}

template <typename T, int CHAIN, class L, class ACT>
int launch(const Geometry& geo, Args a, T* d_wb, float* loss, long long po, long long n_scaled,
           float omega, cudaStream_t stream) {
  void (*kernel)(Args) = geo.resid_in_smem ? simt_train_kernel<T, CHAIN, L, ACT, 1>
                                           : simt_train_kernel<T, CHAIN, L, ACT, 0>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
  if (err != cudaSuccess) return (int)err;
  a.six = geo.six;
  a.kc = geo.kc;
  a.stage_buf = geo.stage_buf;
  a.params_in_smem = geo.params_in_smem;
  a.resid_floats = (long long)geo.resid_floats;
  kernel<<<dim3(geo.splits, geo.grid_g), kThreads, geo.smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks = stride_blocks((long long)a.G * po);
  const float n_elem = (float)((long long)a.G * a.P * a.so);
  reduce_kernel<T><<<blocks, kThreads, 0, stream>>>(a.partials, a.G, geo.splits, po, a.po4,
                                                    n_scaled, omega, a.train, n_elem, d_wb, loss);
  return (int)cudaGetLastError();
}

// The instance of a chain: f32 sine chains take the true sine, bf16 ones the
// polynomial (its degree chosen once a kernel), vanilla chains their
// activation code.
template <typename T>
int dispatch(const Geometry& geo, const Args& a, int chain, void* d_wb, float* loss, long long po,
             long long n_scaled, float omega, cudaStream_t s) {
  T* out = static_cast<T*>(d_wb);
  return with_simt_tile(geo.layout, [&](auto l) {
    using L = decltype(l);
    if (chain == kVanilla)
      return launch<T, kVanilla, L, AnyAct>(geo, a, out, loss, po, n_scaled, omega, s);
    if (chain != kSirenPlain && chain != kSirenResblock) return (int)cudaErrorInvalidValue;
    constexpr bool f32 = std::is_same<T, float>::value;
    using Sine = std::conditional_t<f32, ExactSine, PolySine>;
    if (f32 ? a.act != kSineExact : a.act != kSinePoly7 && a.act != kSinePoly9)
      return (int)cudaErrorInvalidValue;
    return chain == kSirenResblock
               ? launch<T, kSirenResblock, L, Sine>(geo, a, out, loss, po, n_scaled, omega, s)
               : launch<T, kSirenPlain, L, Sine>(geo, a, out, loss, po, n_scaled, omega, s);
  });
}

int run(Args a, int chain, void* d_wb, float* loss, long long po, long long n_scaled, float omega,
        int dtype, void* stream) {
  Geometry g{};
  if (dtype < 0 || dtype > 1 ||
      geometry(a.n, a.si, a.so, a.n_mats, chain, dtype == 0 ? 4 : 2, a.G, a.P, &g) != 0 ||
      a.ldwb < po || a.ldwb % 4 != 0)
    return (int)cudaErrorInvalidValue;
  a.po4 = round4(po);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(g, a, chain, d_wb, loss, po, n_scaled, omega, s);
  return dispatch<__nv_bfloat16>(g, a, chain, d_wb, loss, po, n_scaled, omega, s);
}

}  // namespace

extern "C" {

// The geometry K2 and K3 take (0 = ok; 1 = too wide; 2 = beyond shared
// memory; 3 = bad shape): points per tile, P splits per group, dynamic
// shared memory per block, the f32 partials the caller allocates (G*S*po4
// weight grads, po rounded up to 4, then G*S losses) and the bytes of
// residual scratch (0 when the residuals fit in shared memory).
int nif_shapenet_bwd_workspace(int n, int si, int so, int n_mats, int chain, int G, int P,
                               int dtype, int* tile, int* splits, long long* smem_bytes,
                               long long* partial_floats, long long* scratch_bytes) {
  Geometry g{};
  const int status = geometry(n, si, so, n_mats, chain, dtype == 0 ? 4 : 2, G, P, &g);
  if (status != 0) return status;
  const long long po = (long long)n_mats * n * n + (long long)(si + so + 1 + n_mats) * n + so;
  *tile = g.tile;
  *splits = g.splits;
  *smem_bytes = (long long)g.smem;
  *partial_floats = (long long)G * g.splits * round4(po) + (long long)G * g.splits;
  *scratch_bytes = g.resid_in_smem ? 0
                                   : (long long)g.grid_g * g.splits * (long long)g.resid_floats *
                                         (long long)sizeof(float);
  return 0;
}

// K2. wb is f32 with row stride ldwb (a multiple of 4, >= po); dtype: 0 =
// float, 1 = bf16 (x, target, weight and d_wb share it). weight may be
// null. Returns the CUDA error of the launches (0 on success); the kernels
// run asynchronously on `stream`.
int nif_shapenet_mse_grads(const void* wb, const void* x, const void* target, const void* weight,
                           void* loss, void* d_wb, void* partials, void* scratch, int G, int P,
                           int si, int so, int n, int n_mats, int chain, int act, long long po,
                           long long ldwb, long long n_scaled, float omega, int dtype,
                           void* stream) {
  Args a{};
  a.wb = static_cast<const float*>(wb);
  a.x = x;
  a.target = target;
  a.weight = weight;
  a.partials = static_cast<float*>(partials);
  a.scratch = static_cast<float*>(scratch);
  a.G = G; a.P = P; a.si = si; a.so = so; a.n = n; a.n_mats = n_mats;
  a.act = act; a.train = 1; a.ldwb = ldwb;
  return run(a, chain, d_wb, static_cast<float*>(loss), po, n_scaled, omega, dtype, stream);
}

// K3: g_out [G, P, so] -> d_wb [G, po] (not divided), dx [G, P, si].
int nif_shapenet_bwd(const void* wb, const void* x, const void* g_out, void* d_wb, void* dx,
                     void* partials, void* scratch, int G, int P, int si, int so, int n,
                     int n_mats, int chain, int act, long long po, long long ldwb,
                     long long n_scaled, float omega, int dtype, void* stream) {
  Args a{};
  a.wb = static_cast<const float*>(wb);
  a.x = x;
  a.g_out = g_out;
  a.dx = dx;
  a.partials = static_cast<float*>(partials);
  a.scratch = static_cast<float*>(scratch);
  a.G = G; a.P = P; a.si = si; a.so = so; a.n = n; a.n_mats = n_mats;
  a.act = act; a.train = 0; a.ldwb = ldwb;
  return run(a, chain, d_wb, nullptr, po, n_scaled, omega, dtype, stream);
}

#ifdef K2F_PHASE_CLOCKS
// The phase counters summed over every block since the last call, then
// zeroed (the probe build only).
int nif_bwd_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k2f_phase_cycles, sizeof(k2f_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[kPhases] = {};
  return (int)cudaMemcpyToSymbol(k2f_phase_cycles, zero, sizeof(zero));
}
#endif

const char* nif_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
