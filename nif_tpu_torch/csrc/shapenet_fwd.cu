// K1 and K5's reverse body on Hopper's CUDA cores: the forward of the grouped
// ShapeNet chain, alone or with its dx-only cotangent sweeps, in one body
// template (one nvcc build).
//
// K1 replaces nif_tpu/ops/pallas_shapenet.py::_fwd_kernel :489 (reached
// through shapenet_grouped_fused -> _fwd_pallas -> _forward_layers(save=False)):
//   wb' [G, ldwb] f32 (omega_0 folded into every sine-fed weight matrix by the
//   wrapper, at wb's dtype, then widened to f32), x [G, P, si] in T
//   ->  out [G, P, so] in T (float or bf16).
// K5's reverse body replaces _fwd_jac_rev_kernel :1445 (reached through
// shapenet_fwd_jac when so < si; _jac_rev_layers :1392): the same forward,
// keeping each activated layer's act', then one dx-only cotangent sweep per
// output from the f32 column W_last[:, j]:
//   wb', x  ->  y [G, P, so], jac [G, P, so, si] in T.
// The float32 policy's serving, evaluation and Jacobian evaluation run these;
// bf16 sine chains run the tensor-core K1 and K5 of shapenet_fwd_tc.cu where
// its geometry takes the chain, and this body on the rest (vanilla chains,
// si > 4, K1 above width 800, K5 above 208). K5's tangent body (so >= si)
// stays in shapenet_jac.cu.
//
// The rounding points are the reference's: each product's input S is stored
// rounded to T (the reference's `lift`), the running u of resblock and
// vanilla chains stays f32; the sweeps carry du in f32, round each dz = du *
// act' to T before its product, take 0.5 on both resblock branches and add
// the vanilla shortcut straight through; act' is saved rounded to T. Every
// product is an f32 FMA on the CUDA cores (a bf16 x bf16 product is exact in
// f32, and the f32 path must not use TF32). f32 sine chains take the true
// sine, bf16 ones the polynomial.
//
// What bounds them on an H100 SXM: operations. At the flagship shape (G=32,
// P=32768, width 128, two hidden layers, si=3, so=1) K1 is 69.8 GFLOP of
// products and K5's reverse body 139.3 (the forward and one sweep of du @
// W^T), against ~13 MB of compulsory traffic, so the 67 TFLOP/s f32 FMA peak
// bounds them at ~1.1 and ~2.2 ms.
//
// Design (the tile machinery is stack_simt.cuh's, as in K2/K3, K4, K6-K8):
// - One body template, fwd_simt_kernel<T, CHAIN, L, ACT, JAC, RES>: the chain,
//   the activation (true sine, polynomial sine, or the vanilla chain's code),
//   the register tile (simt_layout: 64-point tiles at width 128, a thread 8
//   rows by 4 columns), the mode and where the planes sit are compile-time,
//   so no epilogue branches on them.
// - The first layer (si columns) and the last (so columns) are f32 FMAs on
//   the registers, from a staged x tile and W0', W_last and the biases staged
//   per group; the last layer's and the jac's row sums meet in three xor
//   shuffles and a fixed-order sum over the warps along a row.
// - The hidden products read one f32 plane S [TP, COLS + 4] (product_fwd)
//   and write the next layer's input over it in place, a barrier after the
//   product; the running u stays in the registers of the thread that owns
//   its elements. K1 saves nothing more: one plane, two blocks per SM.
// - K5 also writes each activated layer's act' into a plane D[m] (nm + 1 of
//   them), so the sweeps can run so times; each sweep writes dz into the S
//   plane (a barrier before) and runs product_bwd against W_m; dz0 stays in
//   registers for jac = dz0 @ W0'^T. At the flagship its four planes (135 KB)
//   sit in shared memory beside two 18 KB weight buffers; wider or deeper
//   chains keep them in a per-block slice of a global scratch (RES = 0), and
//   so does bf16 (its shapes are those the tensor-core kernels refuse), so
//   the build holds 90 instances, not 120.
// - The products of a tile form one stream of W chunks through cp.async,
//   one barrier a chunk; the next tile's first chunk streams in during the
//   current tile's last product.
// - One wave of blocks (one per SM for K5, two for K1 where their shared
//   memory fits) walks every group's tiles in order, each a contiguous run.
//   Outputs are per point, so two runs give the same bits whatever the split.
// scripts/port_phase_probe.py --kernel k1f32 (or k5f32) splits a tile's time
// by phase; PERF.md has the split.
#include "stack_simt.cuh"

namespace {

constexpr int kMaxChunk = 32;      // weight rows (or columns) per staged chunk
constexpr int kK1BlocksPerSm = 2;  // K1's blocks per SM where shared memory allows

__host__ __device__ constexpr long long round4(long long v) { return (v + 3) / 4 * 4; }

// Built with -DK1F_PHASE_CLOCKS (by scripts/port_phase_probe.py only), thread
// 0 of every block adds the clock64() cycles from one mark to the next into
// seven phase counters, which split the block's critical path.
constexpr int kPhases = 7;
#ifdef K1F_PHASE_CLOCKS
__device__ unsigned long long k1f_phase_cycles[kPhases];
#define K1F_PHASE(i)                                       \
  do {                                                     \
    if (threadIdx.x == 0) {                                \
      const long long now = clock64();                     \
      phase_sum[i] += (unsigned long long)(now - phase_t); \
      phase_t = now;                                       \
    }                                                      \
  } while (0)
#else
#define K1F_PHASE(i) \
  do {               \
  } while (0)
#endif

struct Args {
  const float* wb;  // wb' [G, ldwb], f32
  const void* x;    // [G, P, si], T
  void* y;          // [G, P, so], T
  void* jac;        // K5: [G, P, so, si], T
  float* scratch;   // the planes of each block when they live in global memory
  int G, P, si, so, n, n_mats, act;
  int six, kc, stage_buf, params_in_smem;
  long long ldwb, resid_floats;
};

// A forward epilogue on the product's registers (the value layout): z = acc
// + bias, y = act(z) with act'(z); the first layer (m < 0) starts the running
// u, a resblock's first matrix feeds h on and its second averages u with y,
// the vanilla chain adds y to u. S receives lift(next layer's input) where
// write_s, Dp (K5) lift(act').
template <typename T, int CHAIN, class L, class ACT, bool JAC>
__device__ __forceinline__ void fwd_epilogue(const ACT& act, const Acc<L>& acc, Acc<L>& u,
                                             const float* bias, int n, int m, bool write_s,
                                             float* S, float* Dp, const Slot<L>& sl) {
#pragma unroll
  for (int b = 0; b < L::NB; ++b) {
    float bv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = sl.vcol(b, e);
      bv[e] = c < n ? bias[c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < L::RM; ++i) {
      const int o = sl.row(i) * L::LD + sl.vcol(b, 0);
      float y[4], d[4], nx[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        y[e] = act(acc[i][b][e] + bv[e], &d[e]);
        if (m >= 0 && CHAIN == kVanilla) {
          u[i][b][e] += y[e];
          nx[e] = u[i][b][e];
        } else if (m >= 0 && CHAIN == kSirenResblock) {
          if (m % 2) u[i][b][e] = 0.5f * (u[i][b][e] + y[e]);
          nx[e] = m % 2 ? u[i][b][e] : y[e];
        } else {
          u[i][b][e] = y[e];
          nx[e] = y[e];
        }
      }
      if (write_s)
        *reinterpret_cast<float4*>(S + o) =
            make_float4(lift<T>(nx[0]), lift<T>(nx[1]), lift<T>(nx[2]), lift<T>(nx[3]));
      if (JAC)
        *reinterpret_cast<float4*>(Dp + o) =
            make_float4(lift<T>(d[0]), lift<T>(d[1]), lift<T>(d[2]), lift<T>(d[3]));
    }
  }
}

// K1 (JAC = false) and K5's reverse body (JAC = true). RES: where the planes
// sit: 1 = shared memory (derived from the dynamic shared array alone, so
// their loads compile to shared-memory loads; float only), 0 = the block's
// slice of the global scratch. ACT is made from a.act once a kernel.
template <typename T, int CHAIN, class L, class ACT, bool JAC, int RES>
__global__ void __launch_bounds__(kThreads, JAC ? 1 : kK1BlocksPerSm)
    fwd_simt_kernel(const Args a) {
  constexpr int TP = L::TP, LD = L::LD;
  extern __shared__ __align__(16) float smem[];
  const int n = a.n, si = a.si, so = a.so, nm = a.n_mats, six = a.six;
  const size_t plane = (size_t)TP * LD;
  const ACT act(a.act);
  float* res = RES == 1 ? smem : a.scratch + (size_t)blockIdx.x * (size_t)a.resid_floats;
  float* S = res;          // [TP, LD] the layer input; K5's sweeps: dz
  float* D = res + plane;  // K5: [nm + 1][TP, LD] act' of each activated layer
  float* wbuf = smem + (RES == 1 ? a.resid_floats : 0);
  float* X = wbuf + 2 * a.stage_buf;              // [TP, six] the x tile
  float* red = X + (size_t)TP * six;              // [kRed][CW / 8][TP] row sums
  float* params = red + kRed * TP * (L::CW / 8);  // W_last, the biases, then W0'
  const bool vec = n % 4 == 0;
  WStage st{wbuf, a.stage_buf, a.kc, vec, 0};
  const Slot<L> sl;
  const int n4 = (n + 3) / 4 * 4;

  const long long o_wh = (long long)si * n;
  const long long o_wl = o_wh + (long long)nm * n * n;
  const long long o_b0 = o_wl + (long long)n * so;
  const long long o_bl = o_b0 + n + (long long)nm * n;
  const int tail = (so + 1 + nm) * n + so;      // W_last and the biases
  const int nsteps = JAC ? nm * (1 + so) : nm;  // the products of a tile
  const int tpg = (a.P + TP - 1) / TP;          // tiles a group
  const long long total = (long long)a.G * tpg;
  const long long t_begin = blockIdx.x * total / gridDim.x;
  const long long t_end = (blockIdx.x + 1) * total / gridDim.x;
#ifdef K1F_PHASE_CLOCKS
  unsigned long long phase_sum[kPhases] = {};
  long long phase_t = clock64();
#endif

  // The products of a tile in order, each staging the next one's first
  // chunk of W: steps 0 .. nm - 1 the forward products, then (K5) sweep jo's
  // products of m = nm - 1 .. 0 at nm + jo nm + nm - 1 - m, then the next
  // tile's step 0 (of its own group).
  auto stage_step = [&](const float* wg, int step, float* buf) {
    if (step < nm) {
      stage_fwd_head<L>(buf, st, wg + o_wh + (long long)step * n * n, n, n4, n, n);
    } else {
      const int m = nm - 1 - (step - nm) % nm;
      stage_bwd_head<L>(buf, st, wg + o_wh + (long long)m * n * n, n, n);
    }
  };
  if (nsteps > 0 && t_begin < t_end) {
    stage_step(a.wb + (t_begin / tpg) * a.ldwb, 0, st.ws + st.parity * st.buf);
    cp_commit();
  }
  int g_params = -1;  // the group whose parameters sit in shared memory
  for (long long t = t_begin; t < t_end; ++t) {
    const int g = (int)(t / tpg);
    const int p0 = (int)(t - (long long)g * tpg) * TP;
    const int rows = min(TP, a.P - p0);
    const long long row0 = (long long)g * a.P + p0;
    const float* wg = a.wb + (long long)g * a.ldwb;
    const float* wg_next = t + 1 < t_end ? a.wb + ((t + 1) / tpg) * a.ldwb : nullptr;
    const auto after = [&](int step) {
      return [&, step](float* buf) {
        if (step + 1 < nsteps)
          stage_step(wg, step + 1, buf);
        else if (wg_next != nullptr)
          stage_step(wg_next, 0, buf);
      };
    };
    __syncthreads();  // the previous tile is done with X, red, the parameters and the planes
    const float* WL = wg + o_wl;
    const float* W0 = wg;
    if (a.params_in_smem) {
      if (g != g_params) {
        for (int idx = threadIdx.x; idx < tail; idx += kThreads) params[idx] = WL[idx];
        for (int idx = threadIdx.x; idx < si * n; idx += kThreads)
          params[round4(tail) + idx] = W0[idx];
        g_params = g;
      }
      WL = params;
      W0 = params + round4(tail);
    }
    const float* B0 = WL + (o_b0 - o_wl);
    const float* BL = WL + (o_bl - o_wl);
    const T* xg = static_cast<const T*>(a.x) + row0 * si;
    for (int idx = threadIdx.x; idx < TP * six; idx += kThreads) {
      const int r = idx / six;
      const int c = idx - r * six;
      X[idx] = r < rows && c < si ? to_f32(xg[r * si + c]) : 0.f;
    }
    __syncthreads();
    K1F_PHASE(0);  // the x tile (and the group's parameters)

    // ---- first layer: z0 = x @ W0' + b0 on the registers (value layout)
    Acc<L> acc, u;
    zero<L>(acc);
    for (int k = 0; k < si; ++k) {
      float w[L::NB][4];
#pragma unroll
      for (int b = 0; b < L::NB; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = sl.vcol(b, e);
          w[b][e] = c < n ? W0[k * n + c] : 0.f;
        }
#pragma unroll
      for (int i = 0; i < L::RM; ++i) {
        const float xv = X[sl.row(i) * six + k];
#pragma unroll
        for (int b = 0; b < L::NB; ++b)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][b][e] = fmaf(xv, w[b][e], acc[i][b][e]);
      }
    }
    K1F_PHASE(1);  // the first layer's products
    fwd_epilogue<T, CHAIN, L, ACT, JAC>(act, acc, u, B0, n, -1, nm > 0, S, D, sl);
    K1F_PHASE(2);  // the first layer's epilogue

    // ---- hidden layers: products over S, epilogues over S in place
    for (int m = 0; m < nm; ++m) {
      product_fwd<L>(S, LD, n4, wg + o_wh + (long long)m * n * n, n, n, n, st, sl, acc, after(m));
      const bool write_s = m + 1 < nm;
      if (write_s) __syncthreads();  // every thread is done reading S
      K1F_PHASE(1);                  // a hidden forward product
      fwd_epilogue<T, CHAIN, L, ACT, JAC>(act, acc, u, B0 + n + (long long)m * n, n, m, write_s,
                                          S, D + (m + 1) * plane, sl);
      K1F_PHASE(2);  // a hidden forward epilogue
    }

    // ---- last layer: y = lift(u) @ W_last + b_last
    T* yg = static_cast<T*>(a.y) + row0 * so;
    for (int j0 = 0; j0 < so; j0 += kRed) {
      const int nq = min(kRed, so - j0);
      float part[kRed][L::RM];
#pragma unroll
      for (int q = 0; q < kRed; ++q)
#pragma unroll
        for (int i = 0; i < L::RM; ++i) part[q][i] = 0.f;
#pragma unroll
      for (int b = 0; b < L::NB; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = sl.vcol(b, e);
          if (c >= n) continue;
#pragma unroll
          for (int q = 0; q < kRed; ++q) {
            const float w = q < nq ? WL[c * so + j0 + q] : 0.f;
#pragma unroll
            for (int i = 0; i < L::RM; ++i) part[q][i] = fmaf(lift<T>(u[i][b][e]), w, part[q][i]);
          }
        }
      row_sums<L>(part, nq, rows, red, sl, [&](int r, int q, float s) {
        yg[(long long)r * so + j0 + q] = from_f32<T>(s + BL[j0 + q]);
      });
    }
    K1F_PHASE(3);  // the last layer

    // ---- K5: one dx-only cotangent sweep per output
    if constexpr (JAC) {
      T* jg = static_cast<T*>(a.jac) + row0 * so * si;
      for (int jo = 0; jo < so; ++jo) {
        // du starts as the f32 column W_last[:, jo], in the grad layout
        Acc<L> du, dh;
#pragma unroll
        for (int i = 0; i < L::RM; ++i)
#pragma unroll
          for (int b = 0; b < L::NB; ++b)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int k = sl.gcol(b, j);
              du[i][b][j] = k < n ? WL[k * so + jo] : 0.f;
              dh[i][b][j] = 0.f;
            }
        for (int m = nm - 1; m >= 0; --m) {
          const float* Dm = D + (m + 1) * plane;
          const bool res_second = CHAIN == kSirenResblock && m % 2 == 1;
          const bool res_first = CHAIN == kSirenResblock && m % 2 == 0;
          const float scale = res_second ? 0.5f : 1.f;
          // every thread is done reading S (the last forward product's input
          // or the previous sweep product's dz)
          __syncthreads();
          // dz = lift(scale * g * act') into S (g is du, or a resblock's dh)
#pragma unroll
          for (int i = 0; i < L::RM; ++i)
#pragma unroll
            for (int b = 0; b < L::NB; ++b)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int o = sl.row(i) * LD + sl.gcol(b, j);
                const float gv = res_first ? dh[i][b][j] : du[i][b][j];
                S[o] = lift<T>(scale * gv * Dm[o]);
              }
          K1F_PHASE(5);  // a sweep's dz epilogue
          product_bwd<L>(S, LD, wg + o_wh + (long long)m * n * n, n, n, st, sl, acc,
                         after(nm + jo * nm + nm - 1 - m));
          K1F_PHASE(4);  // a sweep product
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
          K1F_PHASE(5);  // a sweep's du update
        }
        // dz0 = lift(du * act'(z0)) on the registers; jac[:, jo, :] = dz0 @ W0'^T
#pragma unroll
        for (int i = 0; i < L::RM; ++i)
#pragma unroll
          for (int b = 0; b < L::NB; ++b)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              du[i][b][j] = lift<T>(du[i][b][j] * D[sl.row(i) * LD + sl.gcol(b, j)]);
        for (int k0 = 0; k0 < si; k0 += kRed) {
          const int nq = min(kRed, si - k0);
          float part[kRed][L::RM];
#pragma unroll
          for (int q = 0; q < kRed; ++q)
#pragma unroll
            for (int i = 0; i < L::RM; ++i) part[q][i] = 0.f;
#pragma unroll
          for (int b = 0; b < L::NB; ++b)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c = sl.gcol(b, j);
              if (c >= n) continue;
#pragma unroll
              for (int q = 0; q < kRed; ++q) {
                const float w = q < nq ? W0[(k0 + q) * n + c] : 0.f;
#pragma unroll
                for (int i = 0; i < L::RM; ++i) part[q][i] = fmaf(du[i][b][j], w, part[q][i]);
              }
            }
          row_sums<L>(part, nq, rows, red, sl, [&](int r, int q, float s) {
            jg[((long long)r * so + jo) * si + k0 + q] = from_f32<T>(s);
          });
        }
        K1F_PHASE(6);  // the jac tail
      }
    }
  }
#ifdef K1F_PHASE_CLOCKS
  if (threadIdx.x == 0)
    for (int i = 0; i < kPhases; ++i) atomicAdd(&k1f_phase_cycles[i], phase_sum[i]);
#endif
}

struct Geometry {
  int layout, tile, six, kc, stage_buf, blocks, per_sm, resid_in_smem, params_in_smem;
  size_t smem, resid_floats;
};

// The tile layout for width n (stack_simt.cuh's simt_layout: every width up
// to kMaxRn * 32 = 1024) and a block's buffers: the planes (one S for K1;
// S and nm + 1 act' planes for K5), the two weight buffers, the x tile
// (round4(si) columns) and the row sums, and W_last, the biases and W0'
// where they fit. K1 takes two blocks per SM where both fit in an SM's
// shared memory, K5 one; the planes go to a global scratch where they do not
// fit beside the weight buffers, and the chunk is the largest of 32, 24, 16,
// 8 rows that fits (bf16, dtype 1, keeps its planes in the scratch). One
// wave of blocks covers every group's tiles.
// 0 = ok; 1 = too wide; 2 = even the weight buffers, the x tile and the row
// sums exceed shared memory; 3 = bad shape (K5: so < si only).
int geometry(bool jac, int n, int si, int so, int n_mats, int chain, int G, int P, int dtype,
             Geometry* g) {
  if (n < 1 || si < 1 || so < 1 || n_mats < 0 || G < 1 || P < 1 || chain < kSirenPlain ||
      chain > kVanilla || (chain == kSirenResblock && n_mats % 2) || (jac && so >= si) ||
      dtype < 0 || dtype > 1)
    return 3;
  g->layout = simt_layout(n);
  if (g->layout < 0) return 1;
  g->tile = simt_tile_points(g->layout);
  const int cols = simt_tile_cols(g->layout);
  const int warps_along = with_simt_tile(g->layout, [](auto l) { return decltype(l)::CW / 8; });
  g->six = (int)round4(si);
  g->resid_floats = (size_t)(jac ? n_mats + 2 : 1) * g->tile * (cols + 4);
  const size_t small = (size_t)g->tile * g->six + (size_t)kRed * g->tile * warps_along;
  const size_t params = round4((long long)(so + 1 + n_mats) * n + so) + round4((long long)si * n);
  auto bytes = [&](bool resid, int kc, bool with_params) {
    return sizeof(float) * ((resid ? g->resid_floats : 0) + 2 * (size_t)stage_floats(cols, kc) +
                            small + (with_params ? params : 0));
  };
  const bool f32 = dtype == 0;
  g->per_sm = !jac && kK1BlocksPerSm == 2 && bytes(f32, 8, false) <= kHalfSmSmem ? 2 : 1;
  const size_t limit = g->per_sm == 2 ? kHalfSmSmem : kMaxSmem;
  g->resid_in_smem = f32 && bytes(true, 8, false) <= limit;
  const int widest = (n + 7) / 8 * 8;
  g->kc = 0;
  for (int kc = kMaxChunk; kc >= 8; kc -= 8)
    if ((kc <= widest || kc == 8) && bytes(g->resid_in_smem, kc, false) <= limit) {
      g->kc = kc;
      break;
    }
  if (g->kc == 0) {
    g->smem = bytes(false, 8, false);
    return 2;
  }
  g->stage_buf = stage_floats(cols, g->kc);
  g->params_in_smem = bytes(g->resid_in_smem, g->kc, true) <= limit;
  g->smem = bytes(g->resid_in_smem, g->kc, g->params_in_smem);
  const long long tiles = (long long)G * ((P + g->tile - 1) / g->tile);
  const int sms = sm_count();
  const long long want = (long long)(sms > 0 ? sms : 1) * g->per_sm;
  g->blocks = (int)(tiles < want ? tiles : want);
  return 0;
}

template <typename T, int CHAIN, class L, class ACT, bool JAC>
int launch(const Geometry& geo, Args a, cudaStream_t stream) {
  void (*kernel)(Args) = fwd_simt_kernel<T, CHAIN, L, ACT, JAC, 0>;
  if constexpr (std::is_same<T, float>::value)  // bf16's planes sit in the scratch
    if (geo.resid_in_smem) kernel = fwd_simt_kernel<T, CHAIN, L, ACT, JAC, 1>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
  if (err != cudaSuccess) return (int)err;
  a.six = geo.six;
  a.kc = geo.kc;
  a.stage_buf = geo.stage_buf;
  a.params_in_smem = geo.params_in_smem;
  a.resid_floats = (long long)geo.resid_floats;
  kernel<<<geo.blocks, kThreads, geo.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The instance of a chain: f32 sine chains take the true sine, bf16 ones the
// polynomial (its degree chosen once a kernel), vanilla chains their
// activation code.
template <typename T, bool JAC>
int dispatch(const Geometry& geo, const Args& a, int chain, cudaStream_t s) {
  return with_simt_tile(geo.layout, [&](auto l) {
    using L = decltype(l);
    if (chain == kVanilla) return launch<T, kVanilla, L, AnyAct, JAC>(geo, a, s);
    constexpr bool f32 = std::is_same<T, float>::value;
    using Sine = std::conditional_t<f32, ExactSine, PolySine>;
    if (f32 ? a.act != kSineExact : a.act != kSinePoly7 && a.act != kSinePoly9)
      return (int)cudaErrorInvalidValue;
    return chain == kSirenResblock ? launch<T, kSirenResblock, L, Sine, JAC>(geo, a, s)
                                   : launch<T, kSirenPlain, L, Sine, JAC>(geo, a, s);
  });
}

int run(bool jac, const Args& a, int chain, long long po, int dtype, void* stream) {
  Geometry g{};
  if (dtype < 0 || dtype > 1 || a.ldwb < po || a.ldwb % 4 != 0 ||
      geometry(jac, a.n, a.si, a.so, a.n_mats, chain, a.G, a.P, dtype, &g) != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return jac ? dispatch<float, true>(g, a, chain, s) : dispatch<float, false>(g, a, chain, s);
  return jac ? dispatch<__nv_bfloat16, true>(g, a, chain, s)
             : dispatch<__nv_bfloat16, false>(g, a, chain, s);
}

int workspace(bool jac, int n, int si, int so, int n_mats, int chain, int G, int P, int dtype,
              int* tile, int* blocks, int* blocks_per_sm, long long* smem_bytes,
              long long* scratch_bytes) {
  Geometry g{};
  const int status = geometry(jac, n, si, so, n_mats, chain, G, P, dtype, &g);
  if (status != 0 && status != 2) return status;
  *tile = g.tile;
  *blocks = g.blocks;
  *blocks_per_sm = g.per_sm;
  *smem_bytes = (long long)g.smem;
  *scratch_bytes = status != 0 || g.resid_in_smem
                       ? 0
                       : (long long)g.blocks * (long long)g.resid_floats * (long long)sizeof(float);
  return status;
}

Args make_args(const void* wb, const void* x, void* y, void* jac, void* scratch, int G, int P,
               int si, int so, int n, int n_mats, int act, long long ldwb) {
  Args a{};
  a.wb = static_cast<const float*>(wb);
  a.x = x;
  a.y = y;
  a.jac = jac;
  a.scratch = static_cast<float*>(scratch);
  a.G = G; a.P = P; a.si = si; a.so = so; a.n = n; a.n_mats = n_mats;
  a.act = act; a.ldwb = ldwb;
  return a;
}

}  // namespace

extern "C" {

// The geometry K1 takes at [G, P] in dtype (0 = float, 1 = bf16) (0 = ok;
// 1 = too wide; 2 = beyond shared memory; 3 = bad shape; on 0 and 2 the
// outputs are written): points per tile, blocks of the one wave, blocks per
// SM, dynamic shared memory per block and the bytes of the planes' global
// scratch (0 when they sit in shared memory).
int nif_shapenet_fwd_geometry(int n, int si, int so, int n_mats, int chain, int G, int P,
                              int dtype, int* tile, int* blocks, int* blocks_per_sm,
                              long long* smem_bytes, long long* scratch_bytes) {
  return workspace(false, n, si, so, n_mats, chain, G, P, dtype, tile, blocks, blocks_per_sm,
                   smem_bytes, scratch_bytes);
}

// The same for K5's reverse body (so < si).
int nif_shapenet_fwd_jac_rev_workspace(int n, int si, int so, int n_mats, int chain, int G,
                                       int P, int dtype, int* tile, int* blocks,
                                       int* blocks_per_sm, long long* smem_bytes,
                                       long long* scratch_bytes) {
  return workspace(true, n, si, so, n_mats, chain, G, P, dtype, tile, blocks, blocks_per_sm,
                   smem_bytes, scratch_bytes);
}

// K1. wb' is f32 with row stride ldwb (a multiple of 4, >= po); dtype: 0 =
// float, 1 = bf16 (x and out share it). Returns the CUDA error of the launch
// (0 on success); the kernel runs asynchronously on `stream`.
int nif_shapenet_fwd(const void* wb, const void* x, void* out, void* scratch, int G, int P, int si,
                     int so, int n, int n_mats, int chain, int act, long long po, long long ldwb,
                     int dtype, void* stream) {
  const Args a = make_args(wb, x, out, nullptr, scratch, G, P, si, so, n, n_mats, act, ldwb);
  return run(false, a, chain, po, dtype, stream);
}

// K5's reverse body (so < si): y [G, P, so] and jac [G, P, so, si] in x's
// dtype, as K1's out.
int nif_shapenet_fwd_jac_rev(const void* wb, const void* x, void* y, void* jac, void* scratch,
                             int G, int P, int si, int so, int n, int n_mats, int chain, int act,
                             long long po, long long ldwb, int dtype, void* stream) {
  const Args a = make_args(wb, x, y, jac, scratch, G, P, si, so, n, n_mats, act, ldwb);
  return run(true, a, chain, po, dtype, stream);
}

#ifdef K1F_PHASE_CLOCKS
// The phase counters summed over every block since the last call, then
// zeroed (the probe build only).
int nif_fwd_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k1f_phase_cycles, sizeof(k1f_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[kPhases] = {};
  return (int)cudaMemcpyToSymbol(k1f_phase_cycles, zero, sizeof(zero));
}
#endif

const char* nif_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
