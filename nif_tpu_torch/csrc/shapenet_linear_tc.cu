// K4's bf16 path on Hopper's tensor cores: the fused NIF-linear train pass,
// u = phi(x) . a(t) + bias, with every trunk product a warp-level
// mma.sync.m16n8k16 (bf16 in, f32 accumulation) fed by ldmatrix.
//
// Replaces nif_tpu/ops/pallas_shapenet.py::_linear_train_kernel (reached
// through niflinear_mse_grads) for bfloat16 inputs; float32 stays on
// shapenet_linear.cu, whose f32 products must not round to TF32. What it
// computes, and where it rounds, is shapenet_linear.cu's (see its header):
// H and D are rounded to bf16, phi stays f32 until the contraction with a,
// go = 2 err w is f32, each dz is rounded to bf16, nk == 1 keeps its f32 du,
// and the sine is the degree-7 polynomial. Every operand of a product is a
// bf16 value already, so each product is exact and only the order of the
// f32 sums differs from the CUDA-core kernel.
//
// What bounds it on an H100 SXM: operations. At the flagship NIF-linear
// train shape (G=32, P=32768, width 128, two hidden layers, si=3, so=1,
// K=128) the trunk's products are 310.8 GFLOP, ~0.31 ms at the 989 TFLOP/s
// bf16 tensor-core peak, against ~10 MB of compulsory traffic.
//
// Design, against what held the CUDA-core kernel back:
// - Products on tensor cores: the hidden and bottleneck forward (H @ W), the
//   backward du = dz @ W^T and the weight grads dW = H^T dz over a tile's
//   points run as mma.sync on bf16 tiles in shared memory (ldmatrix, .trans
//   where the operand is stored the other way round). The first layer
//   (depth si), its dW0 = x^T dz0 and the nk == 1 du stay f32 FMAs.
// - bf16 operands in shared memory: H, D and DZ are bf16 planes whose rows
//   are padded by 8 elements (16 bytes), so ldmatrix and the fragment-wise
//   stores are free of bank conflicts; widths are zero-padded to multiples of
//   16. One weight matrix is staged whole (bf16) and kept while the next
//   product uses it: the bottleneck serves its forward and its du, and the
//   first hidden matrix of the backward serves the next tile's forward.
// - Warp layout: a tile of TP points (64, or 32 or 16 where shared memory
//   is short) is cut into TP/16 row slabs; the 8 warps are TP/16 slabs by
//   WN = 128/TP column groups, and a warp owns the 16-column blocks wn,
//   wn + WN, ... (at most 4, 8 accumulator tiles of 16 x 8). phi stays in
//   the accumulators: its contraction with a is a per-thread sum over the
//   thread's columns, a quad shuffle, then a sum over the WN warps of a row
//   slab in a fixed order.
// - Weight grads: tasks of 16 x 32 outputs over the tile's points, and the
//   bias grads as one more row block whose A operand is all ones, each
//   result added into the block's f32 partial in tile order. A second
//   kernel sums the partials in a fixed order: no float atomics, and two
//   runs on the same inputs give the same bits.
// The grid is (S, G): block (s, g) walks the s-th run of group g's point
// tiles, with S = SMs / G splits (one wave of one block per SM).
#include "mma_sm90.cuh"
#include "shapenet_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// 16 x 8 accumulator tiles a warp of the 8 owns in a tile product. 16 warps
// of 4 tiles measured no faster and spilled at the 128 registers a thread of
// 512 may have (PERF.md).
constexpr int kNT = 8;
constexpr int kMaxSplitsTc = 64;  // point-tile runs per group

struct TcArgs {
  const bf16* wb;      // trunk wb' [po]
  const bf16* a;       // [G, K]
  const bf16* bias;    // [so]
  const bf16* x;       // [G, P, si]
  const bf16* target;  // [G, P, so]
  const bf16* weight;  // [G, P], or null
  float* partials;     // [G, S, pb]: trunk grads [po], d_a [K], d_bias [so], loss
  int G, P, si, so, K, nk, n, n_mats, chain, act;
  int tp, n_p, nk_p, ldh, ldw;
  long long po, pb;
};

struct Warp {
  int lane, g, q, wm, wn, WN, row0;
};

// Built with -DK4_PHASE_CLOCKS (by scripts/port_phase_probe.py only),
// thread 0 of every block adds the clock64() cycles from one barrier to the
// next into eight phase counters, which split the block's critical path.
#ifdef K4_PHASE_CLOCKS
constexpr int kPhases = 8;
__device__ unsigned long long k4_phase_cycles[kPhases];
#define K4_PHASE(i)                                    \
  do {                                                 \
    if (threadIdx.x == 0) {                            \
      const long long now = clock64();                 \
      phase_sum[i] += (unsigned long long)(now - phase_t); \
      phase_t = now;                                   \
    }                                                  \
  } while (0)
#else
#define K4_PHASE(i) \
  do {              \
  } while (0)
#endif

// (act(z), act'(z)) of the bf16 sine, the polynomial of degree 7 or 9: act3's
// kSinePoly7/9 case, the only activations this kernel takes. Inlined at 64
// places, the whole act3 switch (sincosf, tanhf, expf) would swell the code.
__device__ __forceinline__ float sine_grad(float z, bool deg9, float* d) {
  const float t = sin_turns(z);
  const float s = t * t;
  *d = sin_poly_dt(s, deg9) * kInv2Pi;
  return sin_poly(t, s, deg9);
}

// Stage W [rows, cols] (row-major, global) into S [rows_p, ld], zero-padded
// to rows_p x cols_p: 16-byte cp.async copies, all in flight at once, where
// the rows allow them. The caller waits for them (cp_async_wait_all) before
// its next barrier, which shows S to the block.
__device__ __forceinline__ void stage_matrix(bf16* S, int ld, const bf16* __restrict__ W, int rows,
                                             int cols, int rows_p, int cols_p) {
  if (cols % 8 == 0 && (reinterpret_cast<uintptr_t>(W) & 15) == 0) {
    const int cpr = cols_p / 8;
    for (int idx = threadIdx.x; idx < rows_p * cpr; idx += kThreads) {
      const int r = idx / cpr;
      const int c = (idx - r * cpr) * 8;
      const bool valid = r < rows && c < cols;
      cp_async16(S + r * ld + c, valid ? W + (size_t)r * cols + c : W, valid);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows_p * cols_p; idx += kThreads) {
      const int r = idx / cols_p;
      const int c = idx - r * cols_p;
      S[r * ld + c] = r < rows && c < cols ? W[(size_t)r * cols + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// The warp's part of C [TP, 16 n16] = A [TP, 16 k16] @ B, A row-major bf16
// (lda). B_KN: B stored [K][N] (ldb), read transposed (the forward's W);
// otherwise B stored [N][K], i.e. C = A @ W^T for W [N][K] (the backward).
// Accumulator tile t covers rows row0 + g (+8) and columns
// 16 (wn + WN (t / 2)) + 8 (t % 2) + 2q (+1).
template <bool B_KN>
__device__ __forceinline__ void tile_mma(const bf16* A, int lda, const bf16* B, int ldb, int k16,
                                         int n16, const Warp& w, float (&c)[kNT][4]) {
#pragma unroll
  for (int t = 0; t < kNT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[t][e] = 0.f;
  const bf16* a_row = A + (w.row0 + (w.lane & 15)) * lda + 8 * (w.lane >> 4);
  for (int k = 0; k < k16; ++k) {
    uint32_t af[4];
    ldsm_x4(af, a_row + k * 16);
#pragma unroll
    for (int t2 = 0; t2 < kNT / 2; ++t2) {
      const int nb = w.wn + w.WN * t2;
      if (nb < n16) {
        uint32_t bf[4];
        if (B_KN)
          ldsm_x4_trans(bf, B + (k * 16 + (w.lane & 7) + 8 * ((w.lane >> 3) & 1)) * ldb + nb * 16 +
                                8 * (w.lane >> 4));
        else
          ldsm_x4(bf, B + (nb * 16 + (w.lane & 7) + 8 * (w.lane >> 4)) * ldb + k * 16 +
                          8 * ((w.lane >> 3) & 1));
        mma_bf16_16816(c[2 * t2], af, bf[0], bf[1]);
        mma_bf16_16816(c[2 * t2 + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// out[i][c] (+)= sum over the tile's tp points p of A[p][i] DZ[p][c], for
// i < M, c < N (row-major [M, N] in the block's partial; written on its
// first tile), and the bias grad db[c] (+)= sum_p DZ[p][c] into db: one more
// row block whose A fragment is all ones. A's and DZ's columns are zero
// from M and N up to the next multiple of 16. Tasks of 16 x 32 outputs, the
// warps in turn. M = 0 (A unused) gives db alone. A task loads its 16
// partial values before its products, so their L2 latency overlaps the
// products instead of following each store.
__device__ __forceinline__ void weight_grad_tc(const bf16* A, int lda, int M, const bf16* DZ,
                                               int ldz, int N, int tp, float* out, float* db,
                                               bool first, const Warp& w, int warp) {
  const int m16 = (M + 15) / 16;
  const int n16 = (N + 15) / 16;
  const int n32 = (n16 + 1) / 2;
  constexpr uint32_t kOnes = 0x3F803F80u;  // two bf16 1.0
  for (int task = warp; task < (m16 + 1) * n32; task += kWarps) {
    const int mb = task / n32;
    const int nb2 = task - mb * n32;
    const bool ones = mb == m16;  // the bias row block
    float* base = ones ? db : out;
    int at[4][4];  // offset of each output in base, -1 where there is none
    float d[4][4], old[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nb2 * 32 + t * 8 + 2 * w.q + (e & 1);
        const int i = mb * 16 + w.g + 8 * (e >> 1);
        at[t][e] = ones ? (w.g == 0 && e < 2 && c < N ? c : -1) : (i < M && c < N ? i * N + c : -1);
        old[t][e] = !first && at[t][e] >= 0 ? base[at[t][e]] : 0.f;
        d[t][e] = 0.f;
      }
    for (int p = 0; p < tp; p += 16) {
      uint32_t af[4] = {kOnes, kOnes, kOnes, kOnes};
      if (!ones)
        ldsm_x4_trans(af, A + (p + (w.lane & 7) + 8 * (w.lane >> 4)) * lda + mb * 16 +
                              8 * ((w.lane >> 3) & 1));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int nb = nb2 * 2 + h;
        if (nb < n16) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, DZ + (p + (w.lane & 7) + 8 * ((w.lane >> 3) & 1)) * ldz + nb * 16 +
                                8 * (w.lane >> 4));
          mma_bf16_16816(d[2 * h], af, bf[0], bf[1]);
          mma_bf16_16816(d[2 * h + 1], af, bf[2], bf[3]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (at[t][e] >= 0) base[at[t][e]] = first ? d[t][e] : old[t][e] + d[t][e];
  }
}

__device__ __forceinline__ void store_pair(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// dz = lift(scale * g * D) of the warp's fragment (g = du or dh) into DZ,
// zero from column n on.
__device__ __forceinline__ void store_dz_tc(bf16* DZ, int ldz, const bf16* Dm, int ldh, int n,
                                            int n16, const Warp& w, const float (&g)[kNT][4],
                                            float scale) {
#pragma unroll
  for (int t = 0; t < kNT; ++t) {
    const int nb = w.wn + w.WN * (t >> 1);
    if (nb >= n16) continue;
    const int c0 = nb * 16 + 8 * (t & 1) + 2 * w.q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = w.row0 + w.g + 8 * h;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        v[e] = c0 + e < n ? scale * g[t][2 * h + e] * __bfloat162float(Dm[r * ldh + c0 + e]) : 0.f;
      store_pair(DZ + r * ldz + c0, v[0], v[1]);
    }
  }
}

// RES: the resblock chain (its backward keeps dh beside du); a plain chain
// runs the instance without it.
template <bool RES>
__global__ void __launch_bounds__(kThreads, 1) niflinear_tc_kernel(const TcArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, si = a.si, so = a.so, K = a.K, nk = a.nk, n_mats = a.n_mats, tp = a.tp;
  const int ldh = a.ldh, ldw = a.ldw;
  const int n16 = a.n_p / 16, nk16 = a.nk_p / 16;
  const size_t plane = (size_t)tp * ldh;
  bf16* WS = reinterpret_cast<bf16*>(smem_raw);  // [n_p, ldw] the staged weight matrix
  bf16* DZ = WS + (size_t)a.n_p * ldw;            // [tp, ldw] dz (or d_phi), bf16
  bf16* H = DZ + (size_t)tp * ldw;                // [n_mats + 1][tp, ldh] layer inputs
  bf16* D = H + (size_t)(n_mats + 1) * plane;     // [n_mats + 1][tp, ldh] act derivatives
  bf16* X = D + (size_t)(n_mats + 1) * plane;     // [tp, si]
  float* GO = reinterpret_cast<float*>(X + tp * si);  // [tp, so] dL/du
  float* US = GO + tp * so;                       // [WN, tp, so] row sums; the loss warp sums
  float* DAS = US + kWarps * 16 * so;             // [tp / 16, nk] d_a sums of the row slabs
  float* W0 = DAS + (tp / 16) * nk;               // [si, n] first layer, f32
  float* B0 = W0 + si * n;                        // [n]
  float* BH = B0 + n;                             // [n_mats, n]
  float* BL = BH + n_mats * n;                    // [nk]
  float* AK = BL + nk;                            // [nk] a[c % K] of the group

  Warp w;
  w.lane = threadIdx.x % kLanes;
  w.g = w.lane >> 2;
  w.q = w.lane & 3;
  const int warp = threadIdx.x / kLanes;
  const int WM = tp / 16;
  w.WN = kWarps / WM;
  w.wm = warp % WM;
  w.wn = warp / WM;
  w.row0 = w.wm * 16;

  const int S = gridDim.x, s = blockIdx.x;
  const int n_tiles = (a.P + tp - 1) / tp;
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
  const bf16* wg = a.wb;
  const bool deg9 = a.act == kSinePoly9;

  for (int i = threadIdx.x; i < si * n; i += kThreads) W0[i] = __bfloat162float(wg[i]);
  for (int i = threadIdx.x; i < n; i += kThreads) B0[i] = __bfloat162float(wg[o_b0 + i]);
  for (int i = threadIdx.x; i < n_mats * n; i += kThreads) BH[i] = __bfloat162float(wg[o_bh + i]);
  for (int i = threadIdx.x; i < nk; i += kThreads) BL[i] = __bfloat162float(wg[o_bl + i]);
  int staged = -1;  // the matrix in WS: m < n_mats a hidden one, n_mats the bottleneck
#ifdef K4_PHASE_CLOCKS
  unsigned long long phase_sum[kPhases] = {};
  long long phase_t = clock64();
#endif

  for (int g = blockIdx.y; g < a.G; g += gridDim.y) {
    float* part = a.partials + ((long long)g * S + s) * a.pb;
    const bf16* ag = a.a + (long long)g * K;
    __syncthreads();  // the previous group is done with AK
    for (int c = threadIdx.x; c < nk; c += kThreads) AK[c] = __bfloat162float(ag[c % K]);
    float loss_acc = 0.f;
    for (int tile = t_begin; tile < t_end; ++tile) {
      const bool first = tile == t_begin;
      const int p0 = tile * tp;
      const int rows = min(tp, a.P - p0);
      const long long row0 = (long long)g * a.P + p0;
      __syncthreads();  // the previous tile is done with every buffer; AK is written
      K4_PHASE(7);      // the first layer's backward (and the group's set-up)
      const bf16* xg = a.x + row0 * si;
      for (int idx = threadIdx.x; idx < tp * si; idx += kThreads)
        X[idx] = idx < rows * si ? xg[idx] : __float2bfloat16_rn(0.f);
      __syncthreads();
      K4_PHASE(0);  // the x tile

      // ---- first layer (f32 FMAs over si): u = act(x @ W0 + b0), H[0], D[0]
      float acc[kNT][4], u[kNT][4];
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        const int nb = w.wn + w.WN * (t >> 1);
        if (nb >= n16) continue;
        const int c0 = nb * 16 + 8 * (t & 1) + 2 * w.q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = w.row0 + w.g + 8 * h;
          float hv[2], dv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = c0 + e;
            float y = 0.f, d = 0.f;
            if (c < n) {
              float z = 0.f;
              for (int k = 0; k < si; ++k) z = fmaf(__bfloat162float(X[r * si + k]), W0[k * n + c], z);
              y = sine_grad(z + B0[c], deg9, &d);
            }
            u[t][2 * h + e] = y;
            hv[e] = y;
            dv[e] = d;
          }
          store_pair(H + r * ldh + c0, hv[0], hv[1]);
          store_pair(D + r * ldh + c0, dv[0], dv[1]);
        }
      }

      // ---- hidden layers: H[m] @ W_m on the tensor cores
      for (int m = 0; m < n_mats; ++m) {
        __syncthreads();  // H[m] is complete; every warp is done with WS
        if (staged != m) {
          stage_matrix(WS, ldw, wg + o_wh + (long long)m * n * n, n, n, a.n_p, a.n_p);
          staged = m;
          cp_async_wait_all();
          __syncthreads();
        }
        tile_mma<true>(H + m * plane, ldh, WS, ldw, n16, n16, w, acc);
        bf16* Dm = D + (m + 1) * plane;
        bf16* Hn = H + (m + 1) * plane;
#pragma unroll
        for (int t = 0; t < kNT; ++t) {
          const int nb = w.wn + w.WN * (t >> 1);
          if (nb >= n16) continue;
          const int c0 = nb * 16 + 8 * (t & 1) + 2 * w.q;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = w.row0 + w.g + 8 * h;
            float hv[2], dv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = c0 + e;
              const int i = 2 * h + e;
              float next = 0.f, d = 0.f;
              if (c < n) {
                const float y = sine_grad(acc[t][i] + BH[m * n + c], deg9, &d);
                if (RES && m % 2 == 0) {
                  next = y;  // h feeds the block's second matrix; u waits
                } else if (RES) {
                  u[t][i] = 0.5f * (u[t][i] + y);
                  next = u[t][i];
                } else {
                  u[t][i] = y;
                  next = y;
                }
              }
              hv[e] = next;
              dv[e] = d;
            }
            store_pair(Hn + r * ldh + c0, hv[0], hv[1]);
            store_pair(Dm + r * ldh + c0, dv[0], dv[1]);
          }
        }
      }

      // ---- bottleneck: phi = lift(u_last) @ W_bot + b_bot, f32, in acc
      __syncthreads();  // H[n_mats] is complete; every warp is done with WS
      K4_PHASE(1);      // the first layer and the hidden forward
      if (staged != n_mats) {
        stage_matrix(WS, ldw, wg + o_wl, n, nk, a.n_p, a.nk_p);
        staged = n_mats;
        cp_async_wait_all();
        __syncthreads();
      }
      float (&phi)[kNT][4] = acc;
      tile_mma<true>(H + n_mats * plane, ldh, WS, ldw, n16, nk16, w, phi);
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        const int nb = w.wn + w.WN * (t >> 1);
        if (nb >= nk16) continue;
        const int c0 = nb * 16 + 8 * (t & 1) + 2 * w.q;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = c0 + (i & 1);
          phi[t][i] += c < nk ? BL[c] : 0.f;
        }
      }

      // ---- contraction, loss and dL/du into GO (zero past the ragged
      // edge): u[r, o] = sum of phi[r, c] a[c % K] over the columns c of
      // block o; the thread's columns, its quad, then the WN warps in order
      const bf16* tg = a.target + row0 * so;
      const bf16* wt = a.weight ? a.weight + row0 : nullptr;
      for (int o = 0; o < so; ++o) {
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int t = 0; t < kNT; ++t) {
          const int nb = w.wn + w.WN * (t >> 1);
          if (nb >= nk16) continue;
          const int c0 = nb * 16 + 8 * (t & 1) + 2 * w.q;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = c0 + e;
            if (c < nk && c / K == o) {
              s0 = fmaf(phi[t][e], AK[c], s0);
              s1 = fmaf(phi[t][2 + e], AK[c], s1);
            }
          }
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, off);
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        }
        if (w.q == 0) {
          US[(w.wn * tp + w.row0 + w.g) * so + o] = s0;
          US[(w.wn * tp + w.row0 + w.g + 8) * so + o] = s1;
        }
      }
      __syncthreads();  // the row sums are complete
      K4_PHASE(2);      // the bottleneck forward and the contraction
      for (int idx = threadIdx.x; idx < tp * so; idx += kThreads) {
        const int r = idx / so;
        const int o = idx - r * so;
        float sum = 0.f;
        for (int v = 0; v < w.WN; ++v) sum += US[(v * tp + r) * so + o];
        float go = 0.f;
        if (r < rows) {
          const float err = sum + __bfloat162float(a.bias[o]) - __bfloat162float(tg[r * so + o]);
          const float wv = wt ? __bfloat162float(wt[r]) : 1.f;
          loss_acc += err * err * wv;
          go = 2.f * err * wv;
        }
        GO[idx] = go;
      }
      __syncthreads();  // GO is complete
      K4_PHASE(3);      // the loss and dL/du

      // ---- d_bias; d_a's row-slab sums into DAS; d_phi = lift(go_o a) into DZ
      for (int o = threadIdx.x; o < so; o += kThreads) {
        float sum = 0.f;
        for (int r = 0; r < rows; ++r) sum += GO[r * so + o];
        accumulate(part + o_dbias + o, sum, first);
      }
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        const int nb = w.wn + w.WN * (t >> 1);
        if (nb >= nk16) continue;
        const int c0 = nb * 16 + 8 * (t & 1) + 2 * w.q;
        float dz[2][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + e;
          const bool live = c < nk;
          const int o = live ? c / K : 0;
          const float go0 = GO[(w.row0 + w.g) * so + o];
          const float go1 = GO[(w.row0 + w.g + 8) * so + o];
          float da = fmaf(phi[t][e], go0, 0.f);
          da = fmaf(phi[t][2 + e], go1, da);
#pragma unroll
          for (int off = 4; off < kLanes; off <<= 1) da += __shfl_xor_sync(0xffffffffu, da, off);
          if (w.g == 0 && live) DAS[w.wm * nk + c] = da;
          dz[0][e] = live ? go0 * AK[c] : 0.f;
          dz[1][e] = live ? go1 * AK[c] : 0.f;
        }
        store_pair(DZ + (w.row0 + w.g) * ldw + c0, dz[0][0], dz[0][1]);
        store_pair(DZ + (w.row0 + w.g + 8) * ldw + c0, dz[1][0], dz[1][1]);
      }
      __syncthreads();  // DZ and the d_a sums are complete
      K4_PHASE(4);      // d_bias, the d_a sums, d_phi
      for (int k = threadIdx.x; k < K; k += kThreads) {
        float sum = 0.f;
        for (int o = 0; o < so; ++o)
          for (int v = 0; v < WM; ++v) sum += DAS[v * nk + o * K + k];
        accumulate(part + o_da + k, sum, first);
      }

      // ---- bottleneck grads: dW_bot = lift(u_last)^T d_phi, db_bot; then
      // du = d_phi @ W_bot^T (W_bot is still staged), or for nk == 1 the
      // f32 d_phi times the column
      weight_grad_tc(H + n_mats * plane, ldh, n, DZ, ldw, nk, tp, part + o_wl, part + o_bl, first,
                     w, warp);
      float du[kNT][4], dh[RES ? kNT : 1][4];
      if (nk == 1) {
        const float a0 = AK[0];
#pragma unroll
        for (int t = 0; t < kNT; ++t) {
          const int nb = w.wn + w.WN * (t >> 1);
          if (nb >= n16) continue;
          const int c0 = nb * 16 + 8 * (t & 1) + 2 * w.q;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = c0 + (i & 1);
            const int r = w.row0 + w.g + 8 * (i >> 1);
            du[t][i] = c < n ? GO[r * so] * a0 * __bfloat162float(wg[o_wl + c]) : 0.f;
          }
        }
      } else {
        tile_mma<false>(DZ, ldw, WS, ldw, nk16, n16, w, du);
      }
#pragma unroll
      for (int t = 0; t < (RES ? kNT : 1); ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) dh[t][i] = 0.f;
      __syncthreads();  // every read of DZ and WS is done
      K4_PHASE(5);      // d_a, the bottleneck's dW, db and du

      // ---- hidden layers, last to first (K2's backward)
      for (int m = n_mats - 1; m >= 0; --m) {
        if (staged != m) {
          stage_matrix(WS, ldw, wg + o_wh + (long long)m * n * n, n, n, a.n_p, a.n_p);
          staged = m;
        }
        const bf16* Dm = D + (m + 1) * plane;
        const bool res_second = RES && m % 2 == 1;
        const bool res_first = RES && m % 2 == 0;
        if constexpr (RES) {
          if (res_first)
            store_dz_tc(DZ, ldw, Dm, ldh, n, n16, w, dh, 1.f);
          else
            store_dz_tc(DZ, ldw, Dm, ldh, n, n16, w, du, 0.5f);
        } else {
          store_dz_tc(DZ, ldw, Dm, ldh, n, n16, w, du, 1.f);
        }
        cp_async_wait_all();
        __syncthreads();  // DZ is complete; W_m is staged
        weight_grad_tc(H + m * plane, ldh, n, DZ, ldw, n, tp, part + o_wh + (long long)m * n * n,
                       part + o_bh + (long long)m * n, first, w, warp);
        tile_mma<false>(DZ, ldw, WS, ldw, n16, n16, w, acc);
#pragma unroll
        for (int t = 0; t < kNT; ++t)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if constexpr (RES) {
              if (res_second)
                dh[t][i] = acc[t][i];
              else
                du[t][i] = 0.5f * du[t][i] + acc[t][i];
            } else {
              du[t][i] = acc[t][i];
            }
          }
        __syncthreads();  // every read of DZ and WS is done
        K4_PHASE(6);      // the hidden layers' backward
      }

      // ---- first layer: dz0 = lift(du * D[0]); dW_0 = x^T dz0 (FMAs), db_0
      store_dz_tc(DZ, ldw, D, ldh, n, n16, w, du, 1.f);
      __syncthreads();
      for (int idx = threadIdx.x; idx < si * n; idx += kThreads) {
        const int k = idx / n;
        const int c = idx - k * n;
        float sum = 0.f;
        for (int r = 0; r < tp; ++r)
          sum = fmaf(__bfloat162float(X[r * si + k]), __bfloat162float(DZ[r * ldw + c]), sum);
        accumulate(part + idx, sum, first);
      }
      weight_grad_tc(nullptr, 0, 0, DZ, ldw, n, tp, nullptr, part + o_b0, first, w, warp);
    }

    // the block's loss partial: warps in order, then their sums in order
    __syncthreads();  // every thread is done with US
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
      loss_acc += __shfl_xor_sync(0xffffffffu, loss_acc, off);
    if (w.lane == 0) US[warp] = loss_acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = 0.f;
      for (int v = 0; v < kWarps; ++v) total += US[v];
      part[o_loss] = total;
    }
  }
#ifdef K4_PHASE_CLOCKS
  if (threadIdx.x == 0)
    for (int i = 0; i < kPhases; ++i) atomicAdd(&k4_phase_cycles[i], phase_sum[i]);
#endif
}

// The reduce over the [G, S, pb] partials, one thread per output (as
// shapenet_linear.cu's): trunk grads, d_bias and the loss sum all G*S
// blocks in (g, s) order, d_a[g] the S blocks of group g in order; the
// sine-fed trunk grads are multiplied by omega, every output divided by
// n_elem.
__global__ void __launch_bounds__(kThreads)
    linear_tc_reduce_kernel(const float* __restrict__ partials, int G, int S, long long po,
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

struct TcGeometry {
  int tile, splits, grid_g, n_p, nk_p, ldh, ldw;
  size_t smem;
};

constexpr int round16(int v) { return (v + 15) / 16 * 16; }

size_t tc_smem(int tp, int n_p, int ldh, int ldw, int si, int so, int nk, int n, int n_mats) {
  const size_t halves = (size_t)n_p * ldw + (size_t)tp * ldw +
                        2 * (size_t)(n_mats + 1) * tp * ldh + (size_t)tp * si;
  const size_t floats = (size_t)tp * so + (size_t)kWarps * 16 * so + (size_t)(tp / 16) * nk +
                        (size_t)si * n + (size_t)(1 + n_mats) * n + 2 * (size_t)nk;
  return 2 * halves + 4 * floats;
}

// The largest point tile of 64, 32 or 16 whose buffers fit in a block's
// shared memory and whose widest product a warp can hold (at most 4
// 16-column blocks of the zero-padded width per warp). S = SMs / G splits
// per group (at least 1, at most the tiles and kMaxSplitsTc). Status 0 = ok,
// 1 = too wide, 2 = the buffers exceed a block's shared memory, 3 = bad shape.
int tc_geometry(int n, int si, int so, int K, int n_mats, int G, int P, TcGeometry* g) {
  if (n < 1 || si < 1 || so < 1 || K < 1 || n_mats < 0 || G < 1 || P < 1) return 3;
  const int nk = so * K;
  g->n_p = round16(n);
  g->nk_p = round16(nk);
  const int w_p = g->n_p > g->nk_p ? g->n_p : g->nk_p;
  g->ldh = g->n_p + 8;
  g->ldw = w_p + 8;
  if (w_p / 16 > kWarps * (kNT / 2)) return 1;
  for (int tp = 64; tp >= 16; tp /= 2) {
    const int wn = kWarps / (tp / 16);
    if ((w_p / 16 + wn - 1) / wn > kNT / 2) continue;
    g->tile = tp;
    g->smem = tc_smem(tp, g->n_p, g->ldh, g->ldw, si, so, nk, n, n_mats);
    if (g->smem <= kMaxSmem) break;
  }
  if (g->smem > kMaxSmem) return 2;
  const int n_tiles = (P + g->tile - 1) / g->tile;
  const int sms = sm_count();
  int splits = sms > G ? sms / G : 1;
  splits = splits < kMaxSplitsTc ? splits : kMaxSplitsTc;
  g->splits = splits < n_tiles ? splits : n_tiles;
  g->grid_g = G < 65535 ? G : 65535;
  return 0;
}

long long tc_trunk_params(int n, int si, int nk, int n_mats) {
  return (long long)n_mats * n * n + (long long)(si + 1 + n_mats) * n + (long long)n * nk + nk;
}

}  // namespace

extern "C" {

// The geometry of the tensor-core K4 (a status as tc_geometry() returns):
// points per tile, P splits per group, dynamic shared memory per block and
// the f32 partials the caller allocates (G*S blocks of po trunk grads, K
// d_a, so d_bias and one loss).
int nif_linear_tc_workspace(int n, int si, int so, int K, int n_mats, int G, int P, int* tile,
                            int* splits, long long* smem_bytes, long long* partial_floats) {
  TcGeometry g{};
  const int status = tc_geometry(n, si, so, K, n_mats, G, P, &g);
  *tile = g.tile;
  *splits = g.splits;
  *smem_bytes = (long long)g.smem;
  if (status != 0) return status;
  const long long pb = tc_trunk_params(n, si, so * K, n_mats) + K + so + 1;
  *partial_floats = (long long)G * g.splits * pb;
  return 0;
}

// K4 in bf16 on the tensor cores (wb', a, bias, x, target and weight are
// bf16; every output is f32). chain: kSirenPlain or kSirenResblock; act:
// kSinePoly7 or kSinePoly9 (the bf16 sine). weight may be null. Returns the CUDA error of the launches (0 on success); the
// kernels run asynchronously on `stream`.
int nif_linear_mse_grads_tc(const void* wb, const void* a, const void* bias, const void* x,
                            const void* target, const void* weight, void* loss, void* d_trunk,
                            void* d_a, void* d_bias, void* partials, int G, int P, int si, int so,
                            int K, int n, int n_mats, int chain, int act, long long n_scaled,
                            float omega, void* stream) {
  TcGeometry geo{};
  if ((chain != kSirenPlain && chain != kSirenResblock) ||
      (act != kSinePoly7 && act != kSinePoly9) || tc_geometry(n, si, so, K, n_mats, G, P, &geo) != 0)
    return (int)cudaErrorInvalidValue;
  TcArgs args{};
  args.wb = static_cast<const bf16*>(wb);
  args.a = static_cast<const bf16*>(a);
  args.bias = static_cast<const bf16*>(bias);
  args.x = static_cast<const bf16*>(x);
  args.target = static_cast<const bf16*>(target);
  args.weight = static_cast<const bf16*>(weight);
  args.partials = static_cast<float*>(partials);
  args.G = G; args.P = P; args.si = si; args.so = so; args.K = K; args.nk = so * K;
  args.n = n; args.n_mats = n_mats; args.chain = chain; args.act = act;
  args.tp = geo.tile; args.n_p = geo.n_p; args.nk_p = geo.nk_p;
  args.ldh = geo.ldh; args.ldw = geo.ldw;
  args.po = tc_trunk_params(n, si, so * K, n_mats);
  args.pb = args.po + K + so + 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = chain == kSirenResblock ? niflinear_tc_kernel<true> : niflinear_tc_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(geo.splits, geo.grid_g), kThreads, geo.smem, s>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = args.po + (long long)G * K + so + 1;
  const float n_elem = (float)((long long)G * P * so);
  linear_tc_reduce_kernel<<<stride_blocks(total), kThreads, 0, s>>>(
      args.partials, G, geo.splits, args.po, args.pb, K, so, n_scaled, omega, n_elem,
      static_cast<float*>(d_trunk), static_cast<float*>(d_a), static_cast<float*>(d_bias),
      static_cast<float*>(loss));
  return (int)cudaGetLastError();
}

#ifdef K4_PHASE_CLOCKS
// The phase counters summed over every block since the last call, then
// zeroed (the probe build only).
int nif_linear_tc_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k4_phase_cycles, sizeof(k4_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[kPhases] = {};
  return (int)cudaMemcpyToSymbol(k4_phase_cycles, zero, sizeof(zero));
}
#endif

const char* nif_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
