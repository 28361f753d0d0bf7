// K4 on Hopper's CUDA cores: the fused NIF-linear train pass,
// u = phi(x) . a(t) + bias.
//
// Replaces nif_tpu/ops/pallas_shapenet.py::_linear_train_kernel (reached
// through niflinear_mse_grads): the shared-weight SIREN trunk x -> phi(x),
// whose last (linear) layer is the bottleneck of width nk = so * K, its
// contraction with the per-group latent a(t), the weighted MSE and the whole
// backward, in one pass, no dx:
//   trunk wb' [po] f32 (one vector for every group, in the chain layout
//   [W_first | W_hidden... | W_bot | b_first | b_hidden... | b_bot], omega_0
//   folded into the sine-fed weights by the wrapper at the compute dtype,
//   then widened to f32), a [G, K], bias [so], x [G, P, si], target
//   [G, P, so], weight [G, P] (optional; all in x's dtype T)  ->  loss,
//   d_trunk [po], d_a [G, K], d_bias [so], all f32 sums divided by G*P*so,
//   the sine-fed trunk grads multiplied back by omega_0 in f32
//   (_unscale_grads). The float32 policy's NIF-linear step runs this body;
//   bf16 runs the tensor-core kernel of shapenet_linear_tc.cu where its
//   geometry takes the trunk, and this body on the rest.
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
// 310.8 GFLOP in all, against ~10 MB of compulsory traffic; in f32 the
// bottleneck's backward is matrix-vector work (below), 66,176 MACs a point
// backward, 242.7 GFLOP in all. Every product is an f32 FMA on the CUDA
// cores (a bf16 x bf16 product is exact in f32, and the f32 path must not
// use TF32), so the 67 TFLOP/s f32 peak bounds f32 at ~3.8 ms.
//
// Design (the tile machinery is stack_simt.cuh's, K2's body around it):
// - One body template, linear_simt_kernel<T, L, ACT, RES>: the register tile
//   L (stack_simt.cuh's layout for the wider of n and nk) and the sine (the
//   true one for f32, the polynomial for bf16) are compile-time; the chain
//   (plain or resblock) is a flag read once a layer. RES says where the
//   planes sit: 1 = shared memory, 0 = the block's slice of a global
//   scratch (bf16 always: its trunks are those the tensor-core K4 refuses).
// - The trunk is one weight set for every group, so the grid is one wave of
//   one block per SM over the G x ceil(P / TP) point tiles in a row: block b
//   takes a contiguous run of them, across groups, and its W chunks form one
//   stream from its first tile to its last. Only a(t) changes between
//   groups (a [COLS] row of the group's a, read once a group).
// - A tile is TP points (64 at the flagship width). Its planes [TP, COLS +
//   4] f32: each hidden and the bottleneck's input H, each hidden layer's
//   act' D (dz overwrites it in place), lift(d_phi), which the first layer's
//   dz0 then overwrites (its act' is recomputed from the x tile, as the
//   forward's product made it, so it needs no plane), bf16 resblocks' f32
//   running u; the x tile, the target (then dL/du), the point weights, the
//   group's a row, the contraction's partial sums, each bottleneck column's
//   output and the output bias. At the flagship the
//   six planes, 206 KB with the rest, sit in shared memory beside two 10 KB
//   weight buffers (16-row chunks).
// - phi stays in the bottleneck product's registers: the contraction is a
//   row sum over a warp's column groups (shuffles) and the warps along a row
//   (shared memory, in order); d_a a column sum over a warp's row groups
//   (shuffles) and the two halves of the block (in order).
// - In f32 (lift is the identity) d_phi = go_o a is an outer product for
//   each output o, so the bottleneck's backward takes matrix-vector work in
//   place of two of a tile's nine products: dW_bot[k][c] = a[c % K] (u_last^T
//   go_o)[k] and du[p][k] = sum_o go_o[p] (W_bot a)_o[k], W_bot a made once
//   a group. The same sums in another order: plain K4 is held to them. bf16
//   keeps the products on lift(d_phi), the reference's rounding point.
// - The products of a tile form one stream of W chunks through cp.async: the
//   next chunk, or the next product's first, streams in while the current
//   one is multiplied, one barrier a chunk.
// - dW = H^T dz takes passes of TP rows of dW and adds them, in tile order,
//   into the block's own f32 partial of the trunk grads [po4] (with d_bias
//   and the loss), whose old values it loads before the products; d_a goes
//   to one slot per (group, block of the group's run). A second kernel sums
//   the trunk grads, d_bias and the loss over the blocks and each group's
//   d_a over its slots, in a fixed order. No float atomics: two runs on the
//   same inputs give the same bits.
// scripts/port_phase_probe.py --kernel k4f32 splits a tile's time by phase;
// PERF.md has the split.
#include "stack_simt.cuh"

namespace {

constexpr int kMaxChunk = 32;  // weight rows (or columns) per staged chunk

__host__ __device__ constexpr long long round4(long long v) { return (v + 3) / 4 * 4; }

// Built with -DK4F_PHASE_CLOCKS (by scripts/port_phase_probe.py only), thread
// 0 of every block adds the clock64() cycles from one mark to the next into
// ten phase counters, which split the block's critical path.
constexpr int kPhases = 10;
#ifdef K4F_PHASE_CLOCKS
__device__ unsigned long long k4f_phase_cycles[kPhases];
#define K4F_PHASE(i)                                       \
  do {                                                     \
    if (threadIdx.x == 0) {                                \
      const long long now = clock64();                     \
      phase_sum[i] += (unsigned long long)(now - phase_t); \
      phase_t = now;                                       \
    }                                                      \
  } while (0)
#else
#define K4F_PHASE(i) \
  do {               \
  } while (0)
#endif

struct Args {
  const float* wb;      // trunk wb' [po], f32
  const void* a;        // [G, K], T
  const void* bias;     // [so], T
  const void* x;        // [G, P, si], T
  const void* target;   // [G, P, so], T
  const void* weight;   // [G, P], T, or null
  float* partials;      // [B, pb4]: trunk grads [po4], d_bias [so], loss; then d_a [G, J, K]
  float* scratch;       // the planes of each block when they live in global memory
  int G, P, si, so, K, nk, n, n_mats, resblock, act, six, kc, stage_buf, slots;
  long long po4, pb4, red_floats, resid_floats;  // resid_floats per block
};

// The block whose run of the T tiles (block b takes [b T / B, (b + 1) T / B))
// holds tile t.
__host__ __device__ __forceinline__ int block_of(long long t, long long T, int B) {
  return (int)(((t + 1) * B - 1) / T);
}

// The contraction's and d_a's shared sums: TP * so * (CW / 8) floats (the
// warps along a row), then (RG / 4) * COLS (the row-group quads).
template <class L>
constexpr long long red_floats(int so) {
  const long long row = (long long)L::TP * so * (L::CW / 8);
  const long long col = (long long)(L::RG / 4) * L::COLS;
  return round4(row > col ? row : col);
}

template <typename T, class L, class ACT, int RES>
__global__ void __launch_bounds__(kThreads, 1) linear_simt_kernel(const Args a) {
  constexpr int TP = L::TP, LD = L::LD, COLS = L::COLS;
  constexpr int CWW = L::CW / 8;  // the warps along a row
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) float smem[];
  const int n = a.n, si = a.si, so = a.so, K = a.K, nk = a.nk, nm = a.n_mats;
  const bool resblock = a.resblock;
  const size_t plane = (size_t)TP * LD;
  const int B = gridDim.x, blk = blockIdx.x;
  const ACT act(a.act);
  float* res = RES == 1 ? smem : a.scratch + (size_t)blk * (size_t)a.resid_floats;
  float* H = res;                                  // [nm + 1][TP, LD] layer inputs
  float* D = H + (size_t)(nm + 1) * plane;         // [nm][TP, LD] act' of hidden m, then dz
  float* DP = D + (size_t)nm * plane;              // [TP, LD] lift(d_phi), then dz0
  float* U = DP + plane;                           // [TP, LD] bf16: the running f32 u
  float* X = U + (kF32 ? 0 : plane);               // [TP, six] the x tile
  float* GO = X + (size_t)TP * a.six;              // [TP, so] the target, then dL/du
  float* WT = GO + round4((long long)TP * so);     // [TP] the point weights
  float* AK = WT + TP;                             // [COLS] a[g][c % K], zero from nk
  float* RED = AK + COLS;                          // the contraction's and d_a's sums
  int* OC = reinterpret_cast<int*>(RED + a.red_floats);  // [COLS] c / K, -1 from nk
  float* OB = RED + a.red_floats + COLS;           // [so] the output bias
  float* VB = OB + round4(so);                     // f32: [COLS, so] W_bot a of the group
  float* UB = VB + (kF32 ? round4((long long)COLS * so) : 0);  // f32: [COLS, so] H_l^T go
  float* wbuf = smem + (RES == 1 ? a.resid_floats : 0);
  const bool vec = n % 4 == 0 && nk % 4 == 0;
  WStage st{wbuf, a.stage_buf, a.kc, vec, 0};
  const Slot<L> sl;

  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int n4 = (n + 3) / 4 * 4;
  const int n_tiles = (a.P + TP - 1) / TP;
  const long long T_all = (long long)a.G * n_tiles;
  const long long t_begin = (long long)blk * T_all / B;
  const long long t_end = (long long)(blk + 1) * T_all / B;

  const long long o_wh = (long long)si * n;
  const long long o_wl = o_wh + (long long)nm * n * n;  // W_bot [n, nk]
  const long long o_b0 = o_wl + (long long)n * nk;
  const long long o_bh = o_b0 + n;
  const long long o_bl = o_bh + (long long)nm * n;
  const float* wg = a.wb;
  const float* W0 = wg;
  const float* WL = wg + o_wl;
  const float* B0 = wg + o_b0;
  const float* BL = wg + o_bl;
  float* part = a.partials + (long long)blk * a.pb4;
  float* da_part = a.partials + (long long)B * a.pb4;
  const T* bias_g = static_cast<const T*>(a.bias);
#ifdef K4F_PHASE_CLOCKS
  unsigned long long phase_sum[kPhases] = {};
  long long phase_t = clock64();
#endif

  // The products of a tile in order, each staging the next one's first
  // chunk of W: step 0 the first layer, 1 .. nm the hidden forward
  // products, nm + 1 the bottleneck's, nm + 2 its du product (bf16 with nk
  // > 1 only), nm + 3 .. 2 nm + 2 the du products of m = 2 nm + 2 - step,
  // then the next tile's step 0.
  const int last_step = 2 * nm + 2;
  // f32: d_phi = go_o a is an outer product per output o, so dW_bot and du
  // take two matrix-vector products in place of two of the tile's products
  const bool rank1 = kF32 || nk == 1;
  auto stage_step = [&](int step, float* buf) {
    if (step == 0)
      stage_fwd_head<L>(buf, st, W0, n, a.six, si, n);
    else if (step <= nm)
      stage_fwd_head<L>(buf, st, wg + o_wh + (long long)(step - 1) * n * n, n, n4, n, n);
    else if (step == nm + 1)
      stage_fwd_head<L>(buf, st, WL, nk, n4, n, nk);
    else if (step == nm + 2)
      stage_bwd_head<L>(buf, st, WL, n, nk);
    else
      stage_bwd_head<L>(buf, st, wg + o_wh + (long long)(last_step - step) * n * n, n, n);
  };
  if (t_begin < t_end) {
    stage_step(0, st.ws + st.parity * st.buf);
    cp_commit();
  }
  // the output column of each bottleneck column and the output bias, shown
  // to the block by the first tile's barrier
  for (int c = threadIdx.x; c < COLS; c += kThreads) OC[c] = c < nk ? c / K : -1;
  for (int o = threadIdx.x; o < so; o += kThreads) OB[o] = to_f32(bias_g[o]);
  float loss_acc = 0.f;
  int cur_g = -1;
  for (long long t = t_begin; t < t_end; ++t) {
    const int g = (int)(t / n_tiles);
    const int tile = (int)(t - (long long)g * n_tiles);
    const bool first = t == t_begin;             // the block's own partial
    const bool first_g = first || tile == 0;     // the block's d_a slot of group g
    const auto after = [&](int step) {
      return [&, step](float* buf) {
        const int nx = step + 1 == nm + 2 && rank1 ? step + 2 : step + 1;
        if (nx <= last_step)
          stage_step(nx, buf);
        else if (t + 1 < t_end)
          stage_step(0, buf);
      };
    };
    const int p0 = tile * TP;
    const int rows = min(TP, a.P - p0);
    const long long row0 = (long long)g * a.P + p0;
    __syncthreads();  // the previous tile has finished with every plane
    if (g != cur_g) {  // the group's a, read by the contraction after the products' barriers
      const T* ag = static_cast<const T*>(a.a) + (long long)g * K;
      for (int c = threadIdx.x; c < COLS; c += kThreads) AK[c] = c < nk ? to_f32(ag[c % K]) : 0.f;
      if (kF32) {  // VB[k][o] = sum over the columns c of output o of W_bot[k][c] a[c % K]
        __syncthreads();
        for (int idx = threadIdx.x; idx < n * so; idx += kThreads) {
          const int k = idx / so;
          const int o = idx - k * so;
          float v = 0.f;
          for (int c = o * K; c < (o + 1) * K; ++c) v = fmaf(WL[(long long)k * nk + c], AK[c], v);
          VB[idx] = v;
        }
      }
      cur_g = g;
    }
    // the tile's inputs, f32, zero past the ragged edge: x, the target and
    // the point weights
    const T* xg = static_cast<const T*>(a.x) + row0 * si;
    for (int idx = threadIdx.x; idx < TP * a.six; idx += kThreads) {
      const int r = idx / a.six;
      const int c = idx - r * a.six;
      X[idx] = r < rows && c < si ? to_f32(xg[r * si + c]) : 0.f;
    }
    const T* tg = static_cast<const T*>(a.target) + row0 * so;
    for (int idx = threadIdx.x; idx < TP * so; idx += kThreads)
      GO[idx] = idx < rows * so ? to_f32(tg[idx]) : 0.f;
    const T* wt = static_cast<const T*>(a.weight) + row0;
    for (int r = threadIdx.x; r < TP; r += kThreads)
      WT[r] = a.weight && r < rows ? to_f32(wt[r]) : 1.f;

    // ---- trunk forward: H[m + 1] (input of hidden matrix m + 1, or of the
    // bottleneck) and D[m] (act' of hidden matrix m; the first layer's is
    // recomputed in the backward)
    Acc<L> acc;
    for (int m = -1; m < nm; ++m) {
      // one call for the first layer (A the x tile, W0' [si, n]) and the
      // hidden ones (A the plane H[m], W_m [n, n]), so its code is inlined once
      const bool x_in = m < 0;
      product_fwd<L>(x_in ? X : H + m * plane, x_in ? a.six : LD, x_in ? a.six : n4,
                     x_in ? W0 : wg + o_wh + (long long)m * n * n, n, x_in ? si : n, n, st, sl,
                     acc, after(m + 1));
      if (!x_in) K4F_PHASE(1);  // a hidden forward product
      const float* bg = B0 + (m < 0 ? 0 : n + (long long)m * n);
      float* Dm = D + (m < 0 ? 0 : m) * plane;
      float* Hn = H + (m + 1) * plane;
      // a resblock's second matrix averages its output with the block's
      // input; its first feeds its output on
      const bool carry = resblock && m >= 0 && m % 2 == 1;
      const float* u_in = kF32 ? H + (m > 0 ? m - 1 : 0) * plane : U;
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
            for (int e = 0; e < 4; ++e) nx[e] = 0.5f * (uo[e] + y[e]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) nx[e] = y[e];
          }
          if (!kF32 && resblock && (m < 0 || carry))
            *reinterpret_cast<float4*>(U + o) = make_float4(nx[0], nx[1], nx[2], nx[3]);
          if (m >= 0)
            *reinterpret_cast<float4*>(Dm + o) =
                make_float4(lift<T>(d[0]), lift<T>(d[1]), lift<T>(d[2]), lift<T>(d[3]));
          *reinterpret_cast<float4*>(Hn + o) =
              make_float4(lift<T>(nx[0]), lift<T>(nx[1]), lift<T>(nx[2]), lift<T>(nx[3]));
        }
      }
      if (m < 0) {
        K4F_PHASE(0);  // the x tile and the first layer
      } else {
        K4F_PHASE(2);  // thread 0's hidden forward epilogue
      }
    }

    // ---- bottleneck: phi = lift(u_last) @ W_bot + b_bot, f32, in acc
    const float* Hl = H + (size_t)nm * plane;
    product_fwd<L>(Hl, LD, n4, WL, nk, n, nk, st, sl, acc, after(nm + 1));
#pragma unroll
    for (int b = 0; b < L::NB; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = sl.vcol(b, e);
        const float bb = c < nk ? BL[c] : 0.f;
#pragma unroll
        for (int i = 0; i < L::RM; ++i) acc[i][b][e] += bb;
      }
    // the contraction u[r, o] = sum of phi[r, c] a[c % K] over the columns c
    // of output o: a thread's columns, the warp's column groups (lanes xor
    // 1, 2, 4), then the warps along the row in order
    for (int o = 0; o < so; ++o)
#pragma unroll
      for (int i = 0; i < L::RM; ++i) {
        float sum = 0.f;
#pragma unroll
        for (int b = 0; b < L::NB; ++b)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = sl.vcol(b, e);
            if (OC[c] == o) sum = fmaf(acc[i][b][e], AK[c], sum);
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        sum += __shfl_xor_sync(0xffffffffu, sum, 4);
        if (lane % 8 == 0) RED[((long long)sl.row(i) * so + o) * CWW + warp % CWW] = sum;
      }
    __syncthreads();  // the contraction's partial sums are complete
    // the loss and dL/du = 2 err w into GO (zero past the ragged edge)
    for (int idx = threadIdx.x; idx < TP * so; idx += kThreads) {
      const int r = idx / so;
      const int o = idx - r * so;
      float u = 0.f;
#pragma unroll
      for (int w = 0; w < CWW; ++w) u += RED[(long long)idx * CWW + w];
      float go = 0.f;
      if (r < rows) {
        const float err = u + OB[o] - GO[idx];
        const float w = WT[r];
        loss_acc += err * err * w;
        go = 2.f * err * w;
      }
      GO[idx] = go;
    }
    __syncthreads();  // GO is complete
    K4F_PHASE(3);     // the bottleneck, the contraction and the loss

    // ---- d_phi = lift(go_o a[c]) into DP; d_a's column sums of phi go_o
    // over the tile: a thread's rows, the warp's row groups (lanes xor 8,
    // 16), then the row-group quads in order
#pragma unroll
    for (int b = 0; b < L::NB; ++b) {
      float da[4] = {0.f, 0.f, 0.f, 0.f};
      int oc[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) oc[e] = OC[sl.vcol(b, e)];
#pragma unroll
      for (int i = 0; i < L::RM; ++i) {
        float dp[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float go = oc[e] >= 0 ? GO[sl.row(i) * so + oc[e]] : 0.f;
          da[e] = fmaf(acc[i][b][e], go, da[e]);
          dp[e] = lift<T>(go * AK[sl.vcol(b, e)]);
        }
        *reinterpret_cast<float4*>(DP + sl.row(i) * LD + sl.vcol(b, 0)) =
            make_float4(dp[0], dp[1], dp[2], dp[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        da[e] += __shfl_xor_sync(0xffffffffu, da[e], 8);
        da[e] += __shfl_xor_sync(0xffffffffu, da[e], 16);
      }
      if (lane < 8)
        *reinterpret_cast<float4*>(RED + (warp / CWW) * COLS + sl.vcol(b, 0)) =
            make_float4(da[0], da[1], da[2], da[3]);
    }
    __syncthreads();  // DP and the d_a sums are complete
    {
      float* slot = da_part + ((long long)g * a.slots + blk - block_of((long long)g * n_tiles,
                                                                      T_all, B)) * K;
      for (int k = threadIdx.x; k < K; k += kThreads) {
        float sum = 0.f;
        for (int o = 0; o < so; ++o)
          for (int q = 0; q < L::RG / 4; ++q) sum += RED[q * COLS + o * K + k];
        slot[k] = first_g ? sum : slot[k] + sum;
      }
    }
    for (int o = kThreads - 1 - threadIdx.x; o < so; o += kThreads)  // the last threads
      tile_sum<TP>(part + a.po4 + o, first, [&](int r, float sum) { return sum + GO[r * so + o]; });
    // ---- bottleneck grads: dW_bot = lift(u_last)^T go_c, db_bot = colsum(go_c)
    if (kF32) {
      // dW_bot[k][c] = a[c % K] UB[k][o], UB = u_last^T go over the tile
      for (int idx = threadIdx.x; idx < n * so; idx += kThreads) {
        const int k = idx / so;
        const int o = idx - k * so;
        float v = 0.f;
#pragma unroll 8
        for (int r = 0; r < TP; ++r) v = fmaf(Hl[r * LD + k], GO[r * so + o], v);
        UB[idx] = v;
      }
      __syncthreads();  // UB is complete
      float* out = part + o_wl;
#pragma unroll 4
      for (int idx = threadIdx.x; idx < n * nk; idx += kThreads) {
        const int k = idx / nk;
        const int c = idx - k * nk;
        const float v = AK[c] * UB[k * so + OC[c]];
        out[idx] = first ? v : out[idx] + v;
      }
    } else {
      weight_grad<L>(Hl, LD, n, DP, LD, nk, part + o_wl, first, vec, sl);
    }
    for (int c = threadIdx.x; c < nk; c += kThreads)
      tile_sum<TP>(part + o_bl + c, first, [&](int r, float sum) { return sum + DP[r * LD + c]; });
    // du = go_c @ W_bot^T in the grad layout: f32 sum_o go_o VB[k][o]; bf16
    // with nk == 1 the f32 d_phi times the column (a resblock's dh is the
    // last product, in acc)
    Acc<L> du;
    if (rank1) {
#pragma unroll
      for (int i = 0; i < L::RM; ++i)
#pragma unroll
        for (int b = 0; b < L::NB; ++b)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = sl.gcol(b, j);
            float v = 0.f;
            if (k < n) {
              if (kF32) {
                for (int o = 0; o < so; ++o) v = fmaf(GO[sl.row(i) * so + o], VB[k * so + o], v);
              } else {
                v = GO[sl.row(i) * so] * AK[0] * WL[k];
              }
            }
            du[i][b][j] = v;
          }
    } else {
      product_bwd<L>(DP, LD, WL, n, nk, st, sl, du, after(nm + 2));
    }
    K4F_PHASE(4);  // d_bias, d_a, d_phi and the bottleneck's backward

    // ---- hidden layers, last to first
    for (int m = nm - 1; m >= 0; --m) {
      float* Dm = D + m * plane;
      const bool res_second = resblock && m % 2 == 1;
      const bool res_first = resblock && m % 2 == 0;
      const float scale = res_second ? 0.5f : 1.f;
      // dz = lift(scale * g * act') over act' in place (g is du, or dh: a
      // resblock's first matrix takes the cotangent the second's du product
      // left in acc)
#pragma unroll
      for (int i = 0; i < L::RM; ++i)
#pragma unroll
        for (int b = 0; b < L::NB; ++b)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int o = sl.row(i) * LD + sl.gcol(b, j);
            const float gv = res_first ? acc[i][b][j] : du[i][b][j];
            Dm[o] = lift<T>(scale * gv * Dm[o]);
          }
      __syncthreads();  // dz is complete
      K4F_PHASE(5);     // a dz epilogue
      weight_grad<L>(H + m * plane, LD, n, Dm, LD, n, part + o_wh + (long long)m * n * n, first,
                     vec, sl);
      for (int c = threadIdx.x; c < n; c += kThreads)
        tile_sum<TP>(part + o_bh + (long long)m * n + c, first,
                     [&](int r, float sum) { return sum + Dm[r * LD + c]; });
      K4F_PHASE(6);  // a hidden dW and db, partial updates included
      product_bwd<L>(Dm, LD, wg + o_wh + (long long)m * n * n, n, n, st, sl, acc,
                     after(last_step - m));
#pragma unroll
      for (int i = 0; i < L::RM; ++i)
#pragma unroll
        for (int b = 0; b < L::NB; ++b)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (res_first) {
              du[i][b][j] = 0.5f * du[i][b][j] + acc[i][b][j];
            } else if (!res_second) {
              du[i][b][j] = acc[i][b][j];
            }
          }
      K4F_PHASE(7);  // a du product
    }

    // ---- first layer: dz0 = lift(du * lift(act'(z0))) into DP, z0 = x @
    // W0' + b0 recomputed as the forward's product summed it; dW_0 = x^T dz0,
    // db_0
#pragma unroll
    for (int b = 0; b < L::NB; ++b)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = sl.gcol(b, j);
        if (c >= n) continue;
        float z[L::RM];
#pragma unroll
        for (int i = 0; i < L::RM; ++i) z[i] = 0.f;
        for (int k = 0; k < a.six; ++k) {
          const float wk = k < si ? W0[k * n + c] : 0.f;
#pragma unroll
          for (int i = 0; i < L::RM; ++i) z[i] = fmaf(X[sl.row(i) * a.six + k], wk, z[i]);
        }
        const float bc = B0[c];
#pragma unroll
        for (int i = 0; i < L::RM; ++i) {
          float d;
          act(z[i] + bc, &d);
          DP[sl.row(i) * LD + c] = lift<T>(du[i][b][j] * lift<T>(d));
        }
      }
    __syncthreads();
    for (int idx = threadIdx.x; idx < si * n; idx += kThreads) {
      const int i = idx / n;
      const int c = idx - i * n;
      tile_sum<TP>(part + idx, first, [&](int r, float sum) {
        return fmaf(X[r * a.six + i], DP[r * LD + c], sum);
      });
    }
    for (int c = kThreads - 1 - threadIdx.x; c < n; c += kThreads)  // the last threads first
      tile_sum<TP>(part + o_b0 + c, first, [&](int r, float sum) { return sum + DP[r * LD + c]; });
    K4F_PHASE(8);  // the first layer's backward
  }

  // the block's loss partial: warps in order, then their sums in order
  __syncthreads();  // every thread is done with the weight buffers
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    loss_acc += __shfl_xor_sync(0xffffffffu, loss_acc, off);
  if (lane == 0) wbuf[warp] = loss_acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < kWarps; ++w) total += wbuf[w];
    part[a.po4 + so] = total;
  }
  K4F_PHASE(9);  // the loss partial
#ifdef K4F_PHASE_CLOCKS
  if (threadIdx.x == 0)
    for (int i = 0; i < kPhases; ++i) atomicAdd(&k4f_phase_cycles[i], phase_sum[i]);
#endif
}

// The reduce over the partials, one thread per output: the trunk grads,
// d_bias and the loss sum the B blocks' partials in block order, d_a[g] the
// slots of the blocks over group g's run in order; the sine-fed trunk grads
// are multiplied by omega, and every output is divided by n_elem.
__global__ void __launch_bounds__(kThreads)
    linear_reduce_kernel(const float* __restrict__ partials, int B, int G, int slots, int K,
                         int so, int n_tiles, long long po, long long po4, long long pb4,
                         long long n_scaled, float omega, float n_elem,
                         float* __restrict__ d_trunk, float* __restrict__ d_a,
                         float* __restrict__ d_bias, float* __restrict__ loss) {
  const long long n_da = (long long)G * K;
  const long long total = po + n_da + so + 1;
  const long long T_all = (long long)G * n_tiles;
  const float* da_part = partials + (long long)B * pb4;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * kThreads) {
    float sum = 0.f;
    if (idx < po) {
      for (int b = 0; b < B; ++b) sum += partials[b * pb4 + idx];
      if (idx < n_scaled) sum = sum * omega;
      d_trunk[idx] = sum / n_elem;
    } else if (idx < po + n_da) {
      const long long g = (idx - po) / K;
      const long long k = idx - po - g * K;
      const int used = block_of(g * n_tiles + n_tiles - 1, T_all, B) -
                       block_of(g * n_tiles, T_all, B) + 1;
      for (int j = 0; j < used; ++j) sum += da_part[(g * slots + j) * K + k];
      d_a[idx - po] = sum / n_elem;
    } else {
      const long long e = idx - po - n_da;  // d_bias[e] for e < so, then the loss
      for (int b = 0; b < B; ++b) sum += partials[b * pb4 + po4 + e];
      if (e < so)
        d_bias[e] = sum / n_elem;
      else
        *loss = sum / n_elem;
    }
  }
}

struct Geometry {
  int layout, tile, six, kc, stage_buf, blocks, slots, resid_in_smem;
  long long red_floats;
  size_t smem, resid_floats;
};

long long trunk_params(int n, int si, int nk, int n_mats) {
  return (long long)n_mats * n * n + (long long)(si + 1 + n_mats) * n + (long long)n * nk + nk;
}

// The tile layout for the wider of the trunk width n and the bottleneck nk
// (stack_simt.cuh's simt_layout: every width up to 1024), the planes of a
// block (floats, laid out as the kernel reads them: the H planes, the D
// planes of the hidden layers, d_phi's, bf16's f32 u, the x tile, dL/du,
// the point weights, the group's a, the shared sums, the column-to-output
// map and the output bias), in shared memory
// beside the two weight buffers where they fit (f32 only), else in a
// per-block slice of a global scratch; the chunk is the largest of 32, 24,
// 16, 8 rows that fits. The grid is min(SMs, tiles) blocks; each group's
// run of tiles spans at most slots blocks. 0 = ok; 1 = too wide; 2 = even
// the weight buffers exceed shared memory; 3 = bad shape.
int geometry(int n, int si, int so, int K, int n_mats, int elem, int G, int P, Geometry* g) {
  if (n < 1 || si < 1 || so < 1 || K < 1 || n_mats < 0 || G < 1 || P < 1) return 3;
  const int nk = so * K;
  const int wide = n > nk ? n : nk;
  g->layout = simt_layout(wide);
  if (g->layout < 0) return 1;
  g->tile = simt_tile_points(g->layout);
  const int cols = simt_tile_cols(g->layout);
  const long long red = with_simt_tile(g->layout, [&](auto l) {
    return (int)red_floats<decltype(l)>(so);
  });
  g->six = (int)round4(si);
  const bool f32 = elem == 4;
  g->red_floats = red;
  g->resid_floats = ((size_t)2 * (n_mats + 1) + (f32 ? 0 : 1)) * g->tile * (cols + 4) +
                    (size_t)g->tile * g->six + round4((long long)g->tile * so) + g->tile +
                    2 * (size_t)cols + red + round4(so) +
                    (f32 ? 2 * round4((long long)cols * so) : 0);
  auto bytes = [&](bool resid, int kc) {
    return sizeof(float) * ((resid ? g->resid_floats : 0) + 2 * (size_t)stage_floats(cols, kc));
  };
  g->resid_in_smem = f32 && bytes(true, 8) <= kMaxSmem;
  const int widest = ((wide > g->six ? wide : g->six) + 7) / 8 * 8;
  g->kc = 0;
  for (int kc = kMaxChunk; kc >= 8; kc -= 8)
    if ((kc <= widest || kc == 8) && bytes(g->resid_in_smem, kc) <= kMaxSmem) {
      g->kc = kc;
      break;
    }
  if (g->kc == 0) return 2;
  g->stage_buf = stage_floats(cols, g->kc);
  g->smem = bytes(g->resid_in_smem, g->kc);
  const long long tiles = (long long)G * ((P + g->tile - 1) / g->tile);
  const int sms = sm_count();
  g->blocks = (int)(tiles < (sms > 0 ? sms : 1) ? tiles : (sms > 0 ? sms : 1));
  g->slots = (g->blocks + G - 1) / G + 1;
  return 0;
}

template <typename T, class L, class ACT>
int launch(const Geometry& geo, Args a, long long po, float* loss, float* d_trunk, float* d_a,
           float* d_bias, long long n_scaled, float omega, cudaStream_t stream) {
  void (*kernel)(Args) = linear_simt_kernel<T, L, ACT, 0>;
  if constexpr (std::is_same<T, float>::value)
    if (geo.resid_in_smem) kernel = linear_simt_kernel<T, L, ACT, 1>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
  if (err != cudaSuccess) return (int)err;
  a.six = geo.six;
  a.kc = geo.kc;
  a.stage_buf = geo.stage_buf;
  a.slots = geo.slots;
  a.red_floats = geo.red_floats;
  a.resid_floats = (long long)geo.resid_floats;
  kernel<<<geo.blocks, kThreads, geo.smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = po + (long long)a.G * a.K + a.so + 1;
  const float n_elem = (float)((long long)a.G * a.P * a.so);
  linear_reduce_kernel<<<stride_blocks(total), kThreads, 0, stream>>>(
      a.partials, geo.blocks, a.G, geo.slots, a.K, a.so, (a.P + geo.tile - 1) / geo.tile, po,
      a.po4, a.pb4, n_scaled, omega, n_elem, d_trunk, d_a, d_bias, loss);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The geometry K4 takes (a status as geometry() returns): points per tile,
// blocks (one wave over the G x ceil(P / tile) tiles), dynamic shared memory
// per block, the f32 partials the caller allocates (blocks x (po4 trunk
// grads, so d_bias, one loss; rounded up to 4), then G x slots x K d_a) and
// the bytes of plane scratch (0 when the planes sit in shared memory).
int nif_linear_workspace(int n, int si, int so, int K, int n_mats, int G, int P, int dtype,
                         int* tile, int* splits, long long* smem_bytes, long long* partial_floats,
                         long long* scratch_bytes) {
  Geometry g{};
  const int status = geometry(n, si, so, K, n_mats, dtype == 0 ? 4 : 2, G, P, &g);
  *tile = g.tile;
  *splits = g.blocks;
  *smem_bytes = (long long)g.smem;
  if (status != 0) return status;
  const long long pb4 = round4(round4(trunk_params(n, si, so * K, n_mats)) + so + 1);
  *partial_floats = (long long)g.blocks * pb4 + (long long)G * g.slots * K;
  *scratch_bytes = g.resid_in_smem ? 0
                                   : (long long)g.blocks * (long long)g.resid_floats *
                                         (long long)sizeof(float);
  return 0;
}

// K4. wb' is the f32 trunk [po] (16-byte aligned); dtype: 0 = float, 1 =
// bf16 (a, bias, x, target and weight share it; every output is f32).
// chain: kSirenPlain or kSirenResblock. weight may be null. Returns the CUDA
// error of the launches (0 on success); the kernels run asynchronously on
// `stream`.
int nif_linear_mse_grads(const void* wb, const void* a, const void* bias, const void* x,
                         const void* target, const void* weight, void* loss, void* d_trunk,
                         void* d_a, void* d_bias, void* partials, void* scratch, int G, int P,
                         int si, int so, int K, int n, int n_mats, int chain, int act,
                         long long n_scaled, float omega, int dtype, void* stream) {
  Geometry g{};
  if (dtype < 0 || dtype > 1 || (chain != kSirenPlain && chain != kSirenResblock) ||
      (chain == kSirenResblock && n_mats % 2) ||
      geometry(n, si, so, K, n_mats, dtype == 0 ? 4 : 2, G, P, &g) != 0 ||
      (dtype == 0 ? act != kSineExact : act != kSinePoly7 && act != kSinePoly9))
    return (int)cudaErrorInvalidValue;
  Args args{};
  args.wb = static_cast<const float*>(wb);
  args.a = a;
  args.bias = bias;
  args.x = x;
  args.target = target;
  args.weight = weight;
  args.partials = static_cast<float*>(partials);
  args.scratch = static_cast<float*>(scratch);
  args.G = G; args.P = P; args.si = si; args.so = so; args.K = K; args.nk = so * K;
  args.n = n; args.n_mats = n_mats; args.resblock = chain == kSirenResblock; args.act = act;
  const long long po = trunk_params(n, si, so * K, n_mats);
  args.po4 = round4(po);
  args.pb4 = round4(args.po4 + so + 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out[4] = {static_cast<float*>(loss), static_cast<float*>(d_trunk),
                   static_cast<float*>(d_a), static_cast<float*>(d_bias)};
  return with_simt_tile(g.layout, [&](auto l) {
    using L = decltype(l);
    if (dtype == 0)
      return launch<float, L, ExactSine>(g, args, po, out[0], out[1], out[2], out[3], n_scaled,
                                         omega, s);
    return launch<__nv_bfloat16, L, PolySine>(g, args, po, out[0], out[1], out[2], out[3],
                                              n_scaled, omega, s);
  });
}

#ifdef K4F_PHASE_CLOCKS
// The phase counters summed over every block since the last call, then
// zeroed (the probe build only).
int nif_linear_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k4f_phase_cycles, sizeof(k4f_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[kPhases] = {};
  return (int)cudaMemcpyToSymbol(k4f_phase_cycles, zero, sizeof(zero));
}
#endif

const char* nif_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
