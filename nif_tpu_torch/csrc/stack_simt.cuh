// The f32 tile machinery of the CUDA-core kernels on Hopper (full f32 FMAs,
// no TF32): a [TP, COLS] point tile spread over a 256-thread block in
// register tiles of RM rows by 4 columns, the three products of a chain's
// train pass on f32 planes in shared memory (forward, the weight grads and
// the cotangent product), the weights staged ahead of their use through
// cp.async into two buffers, the activations as functors (the bf16 sine is
// stack_tc.cuh's, so every fused kernel on Hopper evaluates one polynomial
// with the same bits), and the tile layout each width takes.
// The Hessian kernels (K7, K8) stack the streams of a point on the rows of
// one register tile (SimtTile<ns, 32, 1>: row st * 8 + p of a tile of 8
// points is stream st of point p, and thread (rg, cg) owns point rg's ns
// rows), so each of their epilogues runs in a thread's registers; here also
// their sine with two or three derivatives and their weight grads over a
// tile's stacked rows (weight_grad_rows); and the row sums of a tile's
// narrow tails (row_sums: the last layer of K1 and K5, K5's jac tails).
// shapenet_fwd.cu (K1, K5's reverse body), shapenet_bwd.cu (K2, K3),
// shapenet_hess.cu (K7, K8), shapenet_jac.cu (K5's tangent body, K6) and
// shapenet_linear.cu (K4) include it; ops/_build.py hashes it with those
// sources, so an edit here rebuilds those libraries and no other (an edit of
// stack_tc.cuh rebuilds them too).
//
// A thread (row group rg, column group cg) of a tile layout owns the rows
// rg + RG i (i < RM) and, in the VALUE layout (the forward's outputs), the
// columns 4 cg + 4 CW b + e (b < NB, e < 4), so each of its products reads
// one float4 of W a step and writes its activations as float4 rows; in the
// GRAD layout (the cotangent product's outputs) the columns cg + CW j +
// 4 CW b (j < 4), so that the rows of W it reads lie on distinct banks. A
// warp is 4 row groups by 8 column groups: every product reads A from a
// plane as a float4 along its sum index, shared by the 8 threads of a row
// group, and W (or dz) as 8 distinct float4, so each of its loads is one
// 128-byte wavefront (plane rows padded to COLS + 4 floats put a warp's 4
// rows on distinct banks): at RM = 8 a step of four sums costs 8 + 4 such
// loads for 128 FMAs.
#pragma once

#include <tuple>
#include <type_traits>

#include "shapenet_common.cuh"
#include "stack_tc.cuh"

namespace {

// The register tile: RM rows by 4 columns in each of NB column blocks of
// 4 CW columns, CW threads along a row, kThreads / CW row groups.
template <int RM_, int CW_, int NB_>
struct SimtTile {
  static constexpr int RM = RM_;
  static constexpr int CW = CW_;
  static constexpr int NB = NB_;
  static constexpr int RG = kThreads / CW;  // row groups
  static constexpr int TP = RM * RG;        // points per tile
  static constexpr int COLS = 4 * CW * NB;  // the widest chain it takes
  static constexpr int LD = COLS + 4;       // a plane's row stride
  static_assert(CW % 8 == 0 && RG % 4 == 0, "a warp is 4 row groups by 8 column groups");
};

template <class L>
struct Slot {
  int rg, cg;
  __device__ __forceinline__ Slot()
      : rg(threadIdx.x / kLanes / (L::CW / 8) * 4 + threadIdx.x % kLanes / 8),
        cg(threadIdx.x / kLanes % (L::CW / 8) * 8 + threadIdx.x % 8) {}
  // the thread's i-th point of a tile
  __device__ __forceinline__ int row(int i) const { return rg + L::RG * i; }
  // column (b, e) of the value layout and (b, j) of the grad layout
  __device__ __forceinline__ int vcol(int b, int e) const { return 4 * cg + 4 * L::CW * b + e; }
  __device__ __forceinline__ int gcol(int b, int j) const { return cg + L::CW * j + 4 * L::CW * b; }
};

template <class L>
using Acc = float[L::RM][L::NB][4];

template <class L>
__device__ __forceinline__ void zero(Acc<L>& acc) {
#pragma unroll
  for (int i = 0; i < L::RM; ++i)
#pragma unroll
    for (int b = 0; b < L::NB; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][b][e] = 0.f;
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Asynchronous 16- or 4-byte copies from global to shared memory; with
// valid = false they write zeros and read nothing. The thread waits for
// its copies with cp_wait_all(); a barrier after it shows them to the block.
__device__ __forceinline__ void cp16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Stage rows r0 .. r0+nr-1 (nr a multiple of 4) of W [Kw, n] (row-major f32
// in global, row stride wld >= n: a block of columns of a wider matrix) into
// ws [nr, COLS] with row stride ldw: rows from Kw and columns from n zero.
// vec: n % 4 == 0, wld % 4 == 0 and W 16-byte aligned.
template <class L>
__device__ __forceinline__ void stage_rows(float* ws, int ldw, const float* __restrict__ W,
                                           int wld, int r0, int nr, int Kw, int n, bool vec) {
  if (vec) {
    constexpr int segs = L::COLS / 4;
    for (int idx = threadIdx.x; idx < nr * segs; idx += kThreads) {
      const int r = idx / segs;
      const int c = (idx - r * segs) * 4;
      const bool valid = r0 + r < Kw && c < n;
      cp16(ws + r * ldw + c, valid ? W + (size_t)(r0 + r) * wld + c : W, valid);
    }
  } else {
    for (int idx = threadIdx.x; idx < nr * L::COLS; idx += kThreads) {
      const int r = idx / L::COLS;
      const int c = idx - r * L::COLS;
      const bool valid = r0 + r < Kw && c < n;
      cp4(ws + r * ldw + c, valid ? W + (size_t)(r0 + r) * wld + c : W, valid);
    }
  }
}

// Stage columns c0 .. c0+nc-1 (nc a multiple of 4) of W [Kin, n] into
// ws [COLS, nc] with row stride ldc, every row k < COLS: rows from Kin and
// columns from n zero.
template <class L>
__device__ __forceinline__ void stage_cols(float* ws, int ldc, const float* __restrict__ W, int c0,
                                           int nc, int Kin, int n, bool vec) {
  if (vec) {
    const int segs = nc / 4;
    for (int idx = threadIdx.x; idx < L::COLS * segs; idx += kThreads) {
      const int k = idx / segs;
      const int c = (idx - k * segs) * 4;
      const bool valid = k < Kin && c0 + c < n;
      cp16(ws + k * ldc + c, valid ? W + (size_t)k * n + c0 + c : W, valid);
    }
  } else {
    for (int idx = threadIdx.x; idx < L::COLS * nc; idx += kThreads) {
      const int k = idx / nc;
      const int c = idx - k * nc;
      const bool valid = k < Kin && c0 + c < n;
      cp4(ws + k * ldc + c, valid ? W + (size_t)k * n + c0 + c : W, valid);
    }
  }
}

// Where the products' weights go: two buffers of `buf` floats in shared
// memory, chunks of kc rows (or columns; kc a multiple of 8, so the
// transposed reads of a chunk of columns, row stride kc + 4, hit distinct
// banks, as do the forward's reads, row stride COLS + 4). The products of a
// tile form one stream through them: each finds its first chunk in flight
// in buffer `parity` and stages the next product's first chunk while it
// multiplies its own last.
struct WStage {
  float* ws;
  int buf, kc;
  bool vec;
  int parity;
};

// Stage the first chunk of a forward product (A @ W, W [Kw, n] with row
// stride wld, K sums) or of a cotangent product (A @ W^T, W [Kin, n]) into
// buf; the caller commits.
template <class L>
__device__ __forceinline__ void stage_fwd_head(float* buf, const WStage& st,
                                               const float* __restrict__ W, int wld, int K,
                                               int Kw, int n) {
  stage_rows<L>(buf, L::COLS + 4, W, wld, 0, min(st.kc, K), Kw, n, st.vec);
}

template <class L>
__device__ __forceinline__ void stage_bwd_head(float* buf, const WStage& st,
                                               const float* __restrict__ W, int Kin, int n) {
  stage_cols<L>(buf, st.kc + 4, W, 0, min(st.kc, (n + 3) / 4 * 4), Kin, n, st.vec);
}

// acc (value layout) = A @ W: A an f32 plane (row stride lda, its K columns
// a multiple of 4, rows 16-byte aligned), W [Kw, n] row-major f32 in global
// (row stride wld), read as zero from row Kw and column n. Its first chunk
// is in flight in buffer st.parity (stage_fwd_head); chunk c + 1 streams in
// while chunk c is multiplied, and next(buf) stages the following product's
// first chunk during the last: one barrier a chunk, whose first also shows
// A to the block.
template <class L, class NEXT>
__device__ __forceinline__ void product_fwd(const float* A, int lda, int K,
                                            const float* __restrict__ W, int wld, int Kw, int n,
                                            WStage& st, const Slot<L>& sl, Acc<L>& acc,
                                            NEXT&& next) {
  constexpr int ldw = L::COLS + 4;
  zero<L>(acc);
  const int nch = (K + st.kc - 1) / st.kc;
  for (int ch = 0; ch < nch; ++ch) {
    cp_wait_all();
    __syncthreads();  // chunk ch is in; every thread is done with chunk ch - 1
    const int k0 = ch * st.kc;
    float* nb = st.ws + ((st.parity + ch + 1) & 1) * st.buf;
    if (ch + 1 < nch)
      stage_rows<L>(nb, ldw, W, wld, k0 + st.kc, min(st.kc, K - k0 - st.kc), Kw, n, st.vec);
    else
      next(nb);
    cp_commit();
    const float* ws = st.ws + ((st.parity + ch) & 1) * st.buf + 4 * sl.cg;
    const float* a_row = A + sl.rg * lda + k0;
    const int kn = min(st.kc, K - k0);
#pragma unroll 1
    for (int k4 = 0; k4 < kn; k4 += 4) {
      float4 a[L::RM];
#pragma unroll
      for (int i = 0; i < L::RM; ++i)
        a[i] = *reinterpret_cast<const float4*>(a_row + i * L::RG * lda + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 w[L::NB];
#pragma unroll
        for (int b = 0; b < L::NB; ++b)
          w[b] = *reinterpret_cast<const float4*>(ws + (k4 + kk) * ldw + 4 * L::CW * b);
#pragma unroll
        for (int i = 0; i < L::RM; ++i) {
          const float av = comp(a[i], kk);
#pragma unroll
          for (int b = 0; b < L::NB; ++b) {
            acc[i][b][0] = fmaf(av, w[b].x, acc[i][b][0]);
            acc[i][b][1] = fmaf(av, w[b].y, acc[i][b][1]);
            acc[i][b][2] = fmaf(av, w[b].z, acc[i][b][2]);
            acc[i][b][3] = fmaf(av, w[b].w, acc[i][b][3]);
          }
        }
      }
    }
  }
  st.parity = (st.parity + nch) & 1;
}

// acc (grad layout) = A @ W^T: acc[i][b][j] = sum over c < n of A[p][c]
// W[k][c] at k = gcol(b, j), A an f32 plane (row stride lda, columns from n
// to the next multiple of 4 zero), W [Kin, n] row-major f32 in global (rows
// from Kin read as zero), staged in chunks of kc columns (stage_bwd_head
// stages the first). The stream and barriers are product_fwd's.
template <class L, class NEXT>
__device__ __forceinline__ void product_bwd(const float* A, int lda, const float* __restrict__ W,
                                            int Kin, int n, WStage& st, const Slot<L>& sl,
                                            Acc<L>& acc, NEXT&& next) {
  const int ldc = st.kc + 4;
  const int n4 = (n + 3) / 4 * 4;
  zero<L>(acc);
  const int nch = (n4 + st.kc - 1) / st.kc;
  for (int ch = 0; ch < nch; ++ch) {
    cp_wait_all();
    __syncthreads();
    const int c0 = ch * st.kc;
    float* nb = st.ws + ((st.parity + ch + 1) & 1) * st.buf;
    if (ch + 1 < nch)
      stage_cols<L>(nb, ldc, W, c0 + st.kc, min(st.kc, n4 - c0 - st.kc), Kin, n, st.vec);
    else
      next(nb);
    cp_commit();
    const float* ws = st.ws + ((st.parity + ch) & 1) * st.buf + sl.cg * ldc;
    const float* a_row = A + sl.rg * lda + c0;
    const int cn = min(st.kc, n4 - c0);
#pragma unroll 1
    for (int c4 = 0; c4 < cn; c4 += 4) {
      float4 a[L::RM];
#pragma unroll
      for (int i = 0; i < L::RM; ++i)
        a[i] = *reinterpret_cast<const float4*>(a_row + i * L::RG * lda + c4);
#pragma unroll
      for (int b = 0; b < L::NB; ++b)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 w =
              *reinterpret_cast<const float4*>(ws + (L::CW * j + 4 * L::CW * b) * ldc + c4);
#pragma unroll
          for (int i = 0; i < L::RM; ++i) {
            float v = fmaf(a[i].x, w.x, acc[i][b][j]);
            v = fmaf(a[i].y, w.y, v);
            v = fmaf(a[i].z, w.z, v);
            acc[i][b][j] = fmaf(a[i].w, w.w, v);
          }
        }
    }
  }
  st.parity = (st.parity + nch) & 1;
}

// out (+)= the sum over a tile's points p < TP of step (sum = step(p, sum),
// in order of p) into a block partial, written on the block's first tile:
// the partial's old value is loaded before the sum, so its latency overlaps
// the sum, and the sum's loads are unrolled ahead of its chain.
template <int TP, class STEP>
__device__ __forceinline__ void tile_sum(float* out, bool first, STEP&& step) {
  const float old = first ? 0.f : *out;
  float sum = 0.f;
#pragma unroll 8
  for (int p = 0; p < TP; ++p) sum = step(p, sum);
  *out = first ? sum : old + sum;
}

// Add one tile's contribution to a block partial: write on the block's
// first tile, accumulate after it (the block owns the partial).
__device__ __forceinline__ float4 added(const float4& old, const float4& v, bool first) {
  return first ? v : make_float4(old.x + v.x, old.y + v.y, old.z + v.z, old.w + v.w);
}

// out[k][c] (+)= sum over the tile's points p < TP of A[p][k] B[p][c] for
// k < K, c < n (row-major [K, n] in global, the block's partial; written on
// its first tile): A and B f32 planes (row strides lda, ldb; K <= COLS <=
// lda). Passes of TP rows k: thread (rg, cg) takes k = kb + rg RM + i and
// the value-layout columns, loads its partial values before the products
// (their L2 latency overlaps the products), then adds and stores them.
// vec: n % 4 == 0 and out 16-byte aligned. The caller has synchronized B.
template <class L>
__device__ __forceinline__ void weight_grad(const float* A, int lda, int K, const float* B,
                                            int ldb, int n, float* __restrict__ out, bool first,
                                            bool vec, const Slot<L>& sl) {
  for (int kb = 0; kb < K; kb += L::TP) {
    const int k0 = kb + sl.rg * L::RM;
    if (k0 >= K) continue;
    float4 old[L::RM][L::NB];
    if (!first) {
#pragma unroll
      for (int i = 0; i < L::RM; ++i)
#pragma unroll
        for (int b = 0; b < L::NB; ++b) {
          const int c = sl.vcol(b, 0);
          const float* o = out + (size_t)(k0 + i) * n + c;
          if (k0 + i >= K || c >= n) {
            old[i][b] = make_float4(0.f, 0.f, 0.f, 0.f);
          } else if (vec) {
            old[i][b] = *reinterpret_cast<const float4*>(o);
          } else {
            old[i][b] = make_float4(o[0], c + 1 < n ? o[1] : 0.f, c + 2 < n ? o[2] : 0.f,
                                    c + 3 < n ? o[3] : 0.f);
          }
        }
    }
    Acc<L> acc;
    zero<L>(acc);
    const float* a_col = A + k0;
    const float* b_col = B + 4 * sl.cg;
#pragma unroll 2
    for (int p = 0; p < L::TP; ++p) {
      float a[L::RM];
      if constexpr (L::RM % 4 == 0) {
#pragma unroll
        for (int i = 0; i < L::RM; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(a_col + p * lda + i);
          a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < L::RM; ++i) a[i] = a_col[p * lda + i];
      }
#pragma unroll
      for (int b = 0; b < L::NB; ++b) {
        const float4 d = *reinterpret_cast<const float4*>(b_col + p * ldb + 4 * L::CW * b);
#pragma unroll
        for (int i = 0; i < L::RM; ++i) {
          acc[i][b][0] = fmaf(a[i], d.x, acc[i][b][0]);
          acc[i][b][1] = fmaf(a[i], d.y, acc[i][b][1]);
          acc[i][b][2] = fmaf(a[i], d.z, acc[i][b][2]);
          acc[i][b][3] = fmaf(a[i], d.w, acc[i][b][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < L::RM; ++i)
#pragma unroll
      for (int b = 0; b < L::NB; ++b) {
        const int c = sl.vcol(b, 0);
        if (k0 + i >= K || c >= n) continue;
        float* o = out + (size_t)(k0 + i) * n + c;
        const float4 v =
            added(old[i][b], make_float4(acc[i][b][0], acc[i][b][1], acc[i][b][2], acc[i][b][3]),
                  first);
        if (vec) {
          *reinterpret_cast<float4*>(o) = v;
        } else {
          o[0] = v.x;
          if (c + 1 < n) o[1] = v.y;
          if (c + 2 < n) o[2] = v.z;
          if (c + 3 < n) o[3] = v.w;
        }
      }
  }
}

// weight_grad over all a tile's stacked rows (the Hessian kernels): out[k][c]
// (+)= the sum over rows r < L::TP of A[r][k] B[r][c], in passes of KM * RG
// rows k (KM a thread, a multiple of 4: its A loads are float4 along k) by
// COLS columns, column block by column block. A separate function: taking
// K2/K3's weight_grad through it (KM = RM, one column block) kept their bits
// but cost the f32 K2 and K3 7% on an H100 (PERF.md).
template <int KM, class L>
__device__ __forceinline__ void weight_grad_rows(const float* A, int lda, int K, const float* B,
                                                 int ldb, int n, float* __restrict__ out,
                                                 bool first, bool vec, const Slot<L>& sl) {
  static_assert(KM % 4 == 0, "A is read as float4 along k");
  for (int c0 = 0; c0 < n; c0 += L::COLS)
    for (int kb = 0; kb < K; kb += KM * L::RG) {
      const int k0 = kb + sl.rg * KM;
      if (k0 >= K) continue;
      float4 old[KM][L::NB];
      if (!first) {
#pragma unroll
        for (int i = 0; i < KM; ++i)
#pragma unroll
          for (int b = 0; b < L::NB; ++b) {
            const int c = c0 + sl.vcol(b, 0);
            const float* o = out + (size_t)(k0 + i) * n + c;
            if (k0 + i >= K || c >= n) {
              old[i][b] = make_float4(0.f, 0.f, 0.f, 0.f);
            } else if (vec) {
              old[i][b] = *reinterpret_cast<const float4*>(o);
            } else {
              old[i][b] = make_float4(o[0], c + 1 < n ? o[1] : 0.f, c + 2 < n ? o[2] : 0.f,
                                      c + 3 < n ? o[3] : 0.f);
            }
          }
      }
      float acc[KM][L::NB][4];
#pragma unroll
      for (int i = 0; i < KM; ++i)
#pragma unroll
        for (int b = 0; b < L::NB; ++b)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][b][e] = 0.f;
      const float* a_col = A + k0;
      const float* b_col = B + c0 + 4 * sl.cg;
#pragma unroll 2
      for (int p = 0; p < L::TP; ++p) {
        float a[KM];
#pragma unroll
        for (int i = 0; i < KM; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(a_col + p * lda + i);
          a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
        }
#pragma unroll
        for (int b = 0; b < L::NB; ++b) {
          const float4 d = *reinterpret_cast<const float4*>(b_col + p * ldb + 4 * L::CW * b);
#pragma unroll
          for (int i = 0; i < KM; ++i) {
            acc[i][b][0] = fmaf(a[i], d.x, acc[i][b][0]);
            acc[i][b][1] = fmaf(a[i], d.y, acc[i][b][1]);
            acc[i][b][2] = fmaf(a[i], d.z, acc[i][b][2]);
            acc[i][b][3] = fmaf(a[i], d.w, acc[i][b][3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < KM; ++i)
#pragma unroll
        for (int b = 0; b < L::NB; ++b) {
          const int c = c0 + sl.vcol(b, 0);
          if (k0 + i >= K || c >= n) continue;
          float* o = out + (size_t)(k0 + i) * n + c;
          const float4 v = added(
              old[i][b], make_float4(acc[i][b][0], acc[i][b][1], acc[i][b][2], acc[i][b][3]),
              first);
          if (vec) {
            *reinterpret_cast<float4*>(o) = v;
          } else {
            o[0] = v.x;
            if (c + 1 < n) o[1] = v.y;
            if (c + 2 < n) o[2] = v.z;
            if (c + 3 < n) o[3] = v.w;
          }
        }
    }
}

constexpr int kRed = 4;  // outputs a pass of row sums takes

// The sums over a tile's rows of the threads' partials part[q][i] (output q
// of the pass, the thread's row sl.row(i)): across the 8 lanes of a warp
// that share a row (xor shuffles), then over the CW / 8 warps along the row
// in order, through red [kRed][CW / 8][TP]; emit(r, q, sum) then runs for
// the tile's rows r < rows and q < nq, a thread each. A fixed order: two runs
// give the same bits. The last layers and jac tails of K1 and K5's reverse
// body (shapenet_fwd.cu) and of K5's tangent body (shapenet_jac.cu, over a
// tile's stacked rows).
template <class L, class EMIT>
__device__ __forceinline__ void row_sums(float (&part)[kRed][L::RM], int nq, int rows, float* red,
                                         const Slot<L>& sl, EMIT&& emit) {
  constexpr int WR = L::CW / 8;
  const int wr = threadIdx.x / kLanes % WR;
  __syncthreads();  // every thread is done with red
#pragma unroll
  for (int q = 0; q < kRed; ++q)
    if (q < nq) {
#pragma unroll
      for (int i = 0; i < L::RM; ++i) {
        float v = part[q][i];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        if (threadIdx.x % 8 == 0) red[(q * WR + wr) * L::TP + sl.row(i)] = v;
      }
    }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nq * L::TP; idx += kThreads) {
    const int q = idx / L::TP;
    const int r = idx - q * L::TP;
    if (r >= rows) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WR; ++w) s += red[(q * WR + w) * L::TP + r];
    emit(r, q, s);
  }
}

// The activations of the residual-saving forward, (act(z), act'(z)) on f32 z,
// each made once a kernel from the chain's activation code: the true sine
// (f32 sine chains), the polynomial (bf16 sine chains: stack_tc.cuh's
// SinePoly, its coefficients chosen once, the tensor-core kernels' bits) or
// any activation through act3's switch (vanilla chains).
// The true sine and cosine as a call: sincosf inlined at each of an
// epilogue's 32 elements (its slow path included) swells the kernel past
// the instruction cache; the call is faster on an H100 (PERF.md).
__device__ __noinline__ float2 exact_sincos(float z) {
  float s, c;
  sincosf(z, &s, &c);
  return make_float2(s, c);
}

struct ExactSine {
  __device__ explicit ExactSine(int) {}
  __device__ __forceinline__ float operator()(float z, float* d) const {
    const float2 sc = exact_sincos(z);
    *d = sc.y;
    return sc.x;
  }
};

struct PolySine {
  SinePoly k;
  __device__ explicit PolySine(int act) : k(sine_poly(act == kSinePoly9)) {}
  __device__ __forceinline__ float operator()(float z, float* d) const {
    const float t = sin_turns(z);
    const float s = t * t;
    *d = sine_dt(s, k) * kInv2Pi;
    return sine_value(t, s, k);
  }
};

struct AnyAct {
  int act;
  __device__ explicit AnyAct(int code) : act(code) {}
  __device__ __forceinline__ float operator()(float z, float* d) const {
    return act_grad(z, act, d);
  }
};

// The Hessian kernels' sine: d012 gives (f, f', f'') of f32 z (their
// forward epilogues), d123 (f', f'', f''') (their backward). The true sine
// from one non-inlined exact_sincos (f32 chains: f'' = -f, f''' = -f'), or
// stack_tc.cuh's polynomial with its derivatives from one range reduction
// (bf16 chains: the tensor-core K7's and K8's bits).
struct ExactSineHess {
  __device__ explicit ExactSineHess(int) {}
  __device__ __forceinline__ float d012(float z, float* d1, float* d2) const {
    const float2 sc = exact_sincos(z);
    *d1 = sc.y;
    *d2 = -sc.x;
    return sc.x;
  }
  __device__ __forceinline__ void d123(float z, float* d1, float* d2, float* d3) const {
    const float2 sc = exact_sincos(z);
    *d1 = sc.y;
    *d2 = -sc.x;
    *d3 = -sc.y;
  }
};

struct PolySineHess {
  SinePoly k;
  __device__ explicit PolySineHess(int act) : k(sine_poly(act == kSinePoly9)) {}
  __device__ __forceinline__ float d012(float z, float* d1, float* d2) const {
    return sine3(z, k, d1, d2);
  }
  __device__ __forceinline__ void d123(float z, float* d1, float* d2, float* d3) const {
    sine_d123(z, k, d1, d2, d3);
  }
};


// The tile layout for width n: 8 rows a thread up to width 128 (64-point
// tiles at 128, 128 up to 64), then fewer rows and more column blocks, so a
// thread's register tile stays 32 values: 0..4, or -1 past kMaxRn * 32
// columns.
inline int simt_layout(int n) {
  if (n <= 64) return 0;
  if (n <= 128) return 1;
  if (n <= 256) return 2;
  if (n <= 512) return 3;
  if (n <= kMaxRn * kLanes) return 4;
  return -1;
}

using SimtTiles = std::tuple<SimtTile<8, 16, 1>, SimtTile<8, 32, 1>, SimtTile<4, 32, 2>,
                             SimtTile<2, 32, 4>, SimtTile<1, 32, 8>>;

// f(L{}) for the layout index of simt_layout().
template <typename F>
int with_simt_tile(int layout, F&& f) {
  switch (layout) {
    case 0: return f(std::tuple_element_t<0, SimtTiles>{});
    case 1: return f(std::tuple_element_t<1, SimtTiles>{});
    case 2: return f(std::tuple_element_t<2, SimtTiles>{});
    case 3: return f(std::tuple_element_t<3, SimtTiles>{});
    case 4: return f(std::tuple_element_t<4, SimtTiles>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

inline int simt_tile_points(int layout) {
  return with_simt_tile(layout, [](auto l) { return decltype(l)::TP; });
}

inline int simt_tile_cols(int layout) {
  return with_simt_tile(layout, [](auto l) { return decltype(l)::COLS; });
}

// The two weight buffers of a layout at chunk size kc, in floats each.
inline int stage_floats(int cols, int kc) {
  const int rows = kc * (cols + 4), cols_t = cols * (kc + 4);
  return rows > cols_t ? rows : cols_t;
}

}  // namespace
