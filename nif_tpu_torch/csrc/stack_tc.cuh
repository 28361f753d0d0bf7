// The stacked-stream tensor-core machinery of the fused ShapeNet kernels on
// Hopper (sm_90a): the bf16 paths of K6 (shapenet_jac_tc.cu), K7 and K8
// (shapenet_hess_tc.cu), K2 and K3 (shapenet_bwd_tc.cu). A tile of points is
// stacked stream-major, each stream's rows forming whole 16-row mma slabs;
// warp w owns the 16-column blocks w, w + 8, ... of every product over all
// slabs, so a thread holds the same (point, column) of every stream and the
// epilogues run in registers.
// Here: the bf16 sine with its coefficients chosen once (SinePoly), the
// warp-level product over a run of slabs (stack_mma), W staging
// (stage_matrix), the weight grads over all stacked rows into a block's
// even-stride f32 partial (weight_grad_stack), the per-thread f32 carry in a
// block's global scratch, the stores of a stacked bf16 plane, the launch
// geometry (stack_geometry), the ordered split reduce over NL losses
// (stack_reduce_kernel) and a stacked plane's narrow products on the tensor
// cores (slab_product_mma: the last products of K1, K2 and K5-K7, K3's dx).
// Each kernel keeps its own body, tile and C entries. ops/_build.py hashes
// this header with the sources that include it, so an edit here rebuilds
// the libraries that include it (directly or through stack_simt.cuh) and no
// other.
#pragma once

#include "mma_sm90.cuh"
#include "shapenet_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxStackSplits = 64;  // point-tile runs per group

struct Lane {
  int lane, g, q, warp;
};

__device__ __forceinline__ Lane lane_of_thread() {
  Lane l;
  l.lane = threadIdx.x % kLanes;
  l.g = l.lane >> 2;
  l.q = l.lane & 3;
  l.warp = threadIdx.x / kLanes;
  return l;
}

// The bf16 sine (the polynomial of degree 7 or 9 of shapenet_common.cuh's
// sin_poly, sin_poly_dt and sin_poly_dt2, with its third derivative), the
// only activation these kernels take, with its coefficients chosen once a
// kernel (sine_poly): act3's kSinePoly7/9 case without its switch, which
// inlined at every epilogue would swell the code. The degree-7
// polynomial is the degree-9 one with zero top coefficients, and those give
// its bits exactly (the innermost step s * 0 + c is c), so no evaluation
// branches on the degree and a thread's independent evaluations interleave.
// sine_poly runs on the host too: a kernel may take the coefficients as a
// launch argument, where its products read them without registers.
struct SinePoly {
  float c1, c3, c5, c7, c9;  // sin(2 pi t) ~ t (c1 + s (c3 + s (c5 + s (c7 + s c9)))), s = t t
  float d0, d2, d4, d6, d8;  // its derivative in t
  float e1, e3, e5, e7;      // its second derivative in t, over t
  float f0, f2, f4, f6;      // its third derivative in t
};

__host__ __device__ __forceinline__ SinePoly sine_poly(bool deg9) {
  if (deg9)
    return {6.28308846f, -41.33324754f, 81.40008977f, -74.67588387f, 33.16809461f,
            6.28308846f, -123.99974262f, 407.00044885f, -522.73118709f, 298.51285149f,
            (float)(6.0 * -41.33324754), (float)(20.0 * 81.40008977),
            (float)(42.0 * -74.67588387), (float)(72.0 * 33.16809461),
            (float)(6.0 * -41.33324754), (float)(60.0 * 81.40008977),
            (float)(210.0 * -74.67588387), (float)(504.0 * 33.16809461)};
  return {6.27863546f, -41.09373072f, 77.93034984f, -56.08639487f, 0.f,
          6.27863546f, -123.28119216f, 389.6517492f, -392.60476409f, 0.f,
          (float)(6.0 * -41.09373072), (float)(20.0 * 77.93034984),
          (float)(42.0 * -56.08639487), 0.f,
          (float)(6.0 * -41.09373072), (float)(60.0 * 77.93034984),
          (float)(210.0 * -56.08639487), 0.f};
}

__device__ __forceinline__ float sine_value(float t, float s, const SinePoly& k) {
  return t * (k.c1 + s * (k.c3 + s * (k.c5 + s * (k.c7 + s * k.c9))));
}

__device__ __forceinline__ float sine_dt(float s, const SinePoly& k) {
  return k.d0 + s * (k.d2 + s * (k.d4 + s * (k.d6 + s * k.d8)));
}

// The bf16 sine of z.
__device__ __forceinline__ float sine_of(float z, const SinePoly& k) {
  const float t = sin_turns(z);
  return sine_value(t, t * t, k);
}

// Its derivative in z.
__device__ __forceinline__ float sine_slope(float z, const SinePoly& k) {
  const float t = sin_turns(z);
  return sine_dt(t * t, k) * kInv2Pi;
}

// The sine with its first two derivatives in z from one range reduction.
__device__ __forceinline__ float sine3(float z, const SinePoly& k, float* d1, float* d2) {
  const float t = sin_turns(z);
  const float s = t * t;
  *d1 = sine_dt(s, k) * kInv2Pi;
  *d2 = t * (k.e1 + s * (k.e3 + s * (k.e5 + s * k.e7))) * kInv2Pi2;
  return sine_value(t, s, k);
}

// Its first three derivatives in z from one range reduction (K8's backward).
__device__ __forceinline__ void sine_d123(float z, const SinePoly& k, float* d1, float* d2,
                                          float* d3) {
  const float t = sin_turns(z);
  const float s = t * t;
  *d1 = sine_dt(s, k) * kInv2Pi;
  *d2 = t * (k.e1 + s * (k.e3 + s * (k.e5 + s * k.e7))) * kInv2Pi2;
  *d3 = (k.f0 + s * (k.f2 + s * (k.f4 + s * k.f6))) * kInv2Pi3;
}

// f(std::integral_constant<int, I>{}) for I = B .. E - 1, unrolled at
// compile time: the register arrays a body indexes by I (the streams of a
// pair) stay in registers.
template <int B, int E, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(std::integral_constant<int, B>{});
    static_for<B + 1, E>(f);
  }
}

// Pair a of si inputs is (pair_j, pair_k), j <= k, row-major: the
// second-order streams of the Hessian kernels (K7, K8).
__host__ __device__ constexpr int pair_j(int a, int si) {
  int j = 0;
  while (a >= si - j) {
    a -= si - j;
    ++j;
  }
  return j;
}
__host__ __device__ constexpr int pair_k(int a, int si) {
  int j = 0;
  while (a >= si - j) {
    a -= si - j;
    ++j;
  }
  return j + a;
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ bf16 load_or_zero(const bf16* __restrict__ p, bool ok) {
  return ok ? *p : __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ void store_pair(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// acc[s][t][i] = sum over k < n of A[(s0 + s) 16 + r][k] B[k][c] for the NSL
// slabs from s0 and the warp's 16-column block cb: A is a stacked bf16 plane
// in shared memory (row stride ld, columns from n to 16 k16 zero); B is the
// group's W [n, n], B[k][c] = W[k][c] (the forward and the recompute) or,
// TRANS_W, W[c][k] (the backward's D @ W^T), read from WS (W staged
// zero-padded, row stride ld) where it is staged, else from W in global
// memory. Accumulator tile t covers column cb 16 + 8 t + 2q (+1), rows g
// (+8) of each slab: the layout of mma_sm90.cuh's C fragment. The same
// operands in the same order give the same bits. RN_BLOCKS: each k16
// block's product is taken on a zero accumulator and added to acc by f32
// adds, which round to nearest; by default the tensor core adds each block
// to acc itself, and its add truncates (rounds toward zero), which on a
// deep sine chain doubles the scatter of the bf16 output (shapenet_fwd_tc.cu).
template <int NSL, bool TRANS_W, bool RN_BLOCKS = false>
__device__ __forceinline__ void stack_mma(const bf16* A, int ld, int s0, const bf16* WS,
                                          const bf16* __restrict__ W, int n, int k16, int cb,
                                          const Lane& l, float (&acc)[NSL][2][4]) {
#pragma unroll
  for (int s = 0; s < NSL; ++s)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[s][t][i] = 0.f;
  const bf16* a_row = A + (s0 * 16 + (l.lane & 15)) * ld + 8 * (l.lane >> 4);
  auto products = [&](int kk, const uint32_t (&b)[2][2]) {
#pragma unroll
    for (int s = 0; s < NSL; ++s) {
      uint32_t af[4];
      ldsm_x4(af, a_row + s * 16 * ld + kk * 16);
      if (RN_BLOCKS) {
        float p[2][4] = {};
        mma_bf16_16816(p[0], af, b[0][0], b[0][1]);
        mma_bf16_16816(p[1], af, b[1][0], b[1][1]);
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[s][t][i] += p[t][i];
      } else {
        mma_bf16_16816(acc[s][0], af, b[0][0], b[0][1]);
        mma_bf16_16816(acc[s][1], af, b[1][0], b[1][1]);
      }
    }
  };
  if (WS) {
    const bf16* b_row =
        TRANS_W ? WS + (cb * 16 + (l.lane & 7) + 8 * (l.lane >> 4)) * ld + 8 * ((l.lane >> 3) & 1)
                : WS + ((l.lane & 7) + 8 * ((l.lane >> 3) & 1)) * ld + cb * 16 + 8 * (l.lane >> 4);
#pragma unroll 2
    for (int kk = 0; kk < k16; ++kk) {
      uint32_t bf[4];
      if (TRANS_W)
        ldsm_x4(bf, b_row + kk * 16);
      else
        ldsm_x4_trans(bf, b_row + kk * 16 * ld);
      const uint32_t b[2][2] = {{bf[0], bf[1]}, {bf[2], bf[3]}};
      products(kk, b);
    }
    return;
  }
  int col[2];
  bool cok[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    col[t] = cb * 16 + 8 * t + l.g;
    cok[t] = col[t] < n;
  }
#pragma unroll 2
  for (int kk = 0; kk < k16; ++kk) {
    const int k0 = kk * 16 + 2 * l.q;
    uint32_t b[2][2];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + 8 * h;
        const bool ok0 = cok[t] && k < n, ok1 = cok[t] && k + 1 < n;
        if (TRANS_W) {
          const bf16* p = W + (size_t)col[t] * n + k;
          b[t][h] = pack_bf16(load_or_zero(p, ok0), load_or_zero(p + 1, ok1));
        } else {
          const bf16* p = W + (size_t)k * n + col[t];
          b[t][h] = pack_bf16(load_or_zero(p, ok0), load_or_zero(p + n, ok1));
        }
      }
    products(kk, b);
  }
}

// Stage W [rows, cols] (row-major, global) into S [rows_p, ld], zero-padded
// to rows_p x cols_p: 16-byte cp.async copies, all in flight at once, where
// the rows allow them (shapenet_linear_tc.cu's). The caller waits for them
// (cp_async_wait_all) before its next barrier, which shows S to the block.
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

// out[i][c] (+)= sum over the tile's stacked rows p < tr of A[p][i] D[p][c]
// for i, c < n (row-major [n, n] in the block's partial; written on its
// first tile): A and D are bf16 planes (row stride ld) whose columns are zero
// from n up to 16 n16. Tasks of 16 x 32 outputs, the warps in turn
// (shapenet_linear_tc.cu's, without its bias row block). A task loads its
// partial values before its products, so their L2 latency overlaps the
// products instead of following each store. For even n (out 8-byte
// aligned) a thread's two neighbouring columns move as one float2, so each
// 32-byte sector of the partial is written whole by one instruction.
__device__ __forceinline__ void weight_grad_stack(const bf16* A, const bf16* D, int ld, int n,
                                                  int n16, int tr, float* out, bool first,
                                                  const Lane& l) {
  const int n32 = (n16 + 1) / 2;
  const bool pairs = n % 2 == 0;
  for (int task = l.warp; task < n16 * n32; task += kWarps) {
    const int mb = task / n32;
    const int nb2 = task - mb * n32;
    int at[4][4];  // offset of each output in out, -1 where there is none
    float d[4][4], old[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nb2 * 32 + t * 8 + 2 * l.q + (e & 1);
        const int i = mb * 16 + l.g + 8 * (e >> 1);
        at[t][e] = i < n && c < n ? i * n + c : -1;
        d[t][e] = 0.f;
      }
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int* o = &at[t][2 * h];
        float* v = &old[t][2 * h];
        if (pairs) {  // c even and n even: both columns live or neither
          const float2 w = !first && o[0] >= 0 ? *reinterpret_cast<const float2*>(out + o[0])
                                               : make_float2(0.f, 0.f);
          v[0] = w.x;
          v[1] = w.y;
        } else {
          v[0] = !first && o[0] >= 0 ? out[o[0]] : 0.f;
          v[1] = !first && o[1] >= 0 ? out[o[1]] : 0.f;
        }
      }
    for (int p = 0; p < tr; p += 16) {
      uint32_t af[4];
      ldsm_x4_trans(af, A + (p + (l.lane & 7) + 8 * (l.lane >> 4)) * ld + mb * 16 +
                            8 * ((l.lane >> 3) & 1));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int nb = nb2 * 2 + h;
        if (nb < n16) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, D + (p + (l.lane & 7) + 8 * ((l.lane >> 3) & 1)) * ld + nb * 16 +
                                8 * (l.lane >> 4));
          mma_bf16_16816(d[2 * h], af, bf[0], bf[1]);
          mma_bf16_16816(d[2 * h + 1], af, bf[2], bf[3]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 2 * h;
        const float v0 = first ? d[t][e] : old[t][e] + d[t][e];
        const float v1 = first ? d[t][e + 1] : old[t][e + 1] + d[t][e + 1];
        if (pairs) {
          if (at[t][e] >= 0) *reinterpret_cast<float2*>(out + at[t][e]) = make_float2(v0, v1);
        } else {
          if (at[t][e] >= 0) out[at[t][e]] = v0;
          if (at[t][e + 1] >= 0) out[at[t][e + 1]] = v1;
        }
      }
  }
}

// Sum s over the lanes of one quad position q (the eight rows g of a
// column); every lane gets the sum.
__device__ __forceinline__ float quad_column_sum(float s) {
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  s += __shfl_xor_sync(0xffffffffu, s, 8);
  s += __shfl_xor_sync(0xffffffffu, s, 16);
  return s;
}

// Sum v over the 16 points of a column: the thread's two rows (g, g + 8),
// then the eight lanes of its quad position q. Every lane gets the sum.
__device__ __forceinline__ float column_sum(float v_g, float v_g8) {
  return quad_column_sum(v_g + v_g8);
}

// A thread's f32 carry (NS x 8 values per column block): in the block's
// scratch, element-major over the block's threads, so a warp's accesses are
// coalesced. Slot 0: a resblock's running state U (forward) and its block
// cotangent (backward); slot 1: the cotangent of a further column block.
template <int NS>
__device__ __forceinline__ float* carry_slot(float* carry, int slot, int cbl, int n_cb) {
  return carry + ((size_t)(slot * n_cb + cbl) * NS * 8) * kThreads + threadIdx.x;
}

template <int NS>
__device__ __forceinline__ void carry_store(float* c, const float (&v)[NS][2][4]) {
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[((s * 2 + t) * 4 + i) * kThreads] = v[s][t][i];
}

template <int NS>
__device__ __forceinline__ void carry_load(const float* c, float (&v)[NS][2][4]) {
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) v[s][t][i] = c[((s * 2 + t) * 4 + i) * kThreads];
}

// The thread's values v of every slab into a stacked bf16 plane (and a copy
// in global memory when `copy` is set): rows st 16 + g (+8), columns cb 16 +
// 8 t + 2q (+1), zero from column n on.
template <int NS>
__device__ __forceinline__ void store_stack(bf16* plane, bf16* copy, int ld, int n, int cb,
                                            const Lane& l, const float (&v)[NS][2][4]) {
#pragma unroll
  for (int st = 0; st < NS; ++st)
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int c0 = cb * 16 + 8 * t + 2 * l.q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = (st * 16 + l.g + 8 * h) * ld + c0;
        const float v0 = c0 < n ? v[st][t][2 * h] : 0.f;
        const float v1 = c0 + 1 < n ? v[st][t][2 * h + 1] : 0.f;
        store_pair(plane + o, v0, v1);
        if (copy) store_pair(copy + o, v0, v1);
      }
    }
}

// The column of accumulator element (t, i) of column block cb.
__device__ __forceinline__ int frag_col(int cb, int t, int i, const Lane& l) {
  return cb * 16 + 8 * t + 2 * l.q + (i & 1);
}

// The split reduce of shapenet_common.cuh (split_reduce_kernel) over
// partials whose rows have the even stride ps >= po: d_wb[g][p] =
// bf16((sum_s partial[g][s][p]) * (p < n_scaled ? omega : 1) / grad_norm),
// the S splits in order (grad_norm is 1 for K6 and K8, whose partials are
// already divided, and exact: x / 1 is x); then one thread per loss sums its
// G*S partials (laid out [G, S, NL] after the [G, S, ps] weight grads) in
// order and divides by its norm. No float atomics: two runs give the same
// bits.
template <int NL>
__global__ void __launch_bounds__(kThreads)
    stack_reduce_kernel(const float* __restrict__ partials, int G, int S, long long po,
                        long long ps, long long n_scaled, float omega, float grad_norm,
                        LossNorms norms, bf16* __restrict__ d_wb, float* __restrict__ losses) {
  const long long total = (long long)G * po;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * kThreads) {
    const long long g = idx / po;
    const long long p = idx - g * po;
    const float* src = partials + g * S * ps + p;
    float sum = 0.f;
    for (int s = 0; s < S; ++s) sum += src[s * ps];
    if (p < n_scaled) sum = sum * omega;
    d_wb[idx] = __float2bfloat16_rn(sum / grad_norm);
  }
  if (blockIdx.x == 0 && threadIdx.x < NL) {
    const float* lp = partials + (long long)G * S * ps + threadIdx.x;
    float sum = 0.f;
    for (long long i = 0; i < (long long)G * S; ++i) sum += lp[NL * i];
    losses[threadIdx.x] = sum / norms.n[threadIdx.x];
  }
}

// Launch stack_reduce_kernel over G * po weight grads on `stream`; returns
// the CUDA error of the launch.
template <int NL>
int launch_stack_reduce(const float* partials, int G, int S, long long po, long long n_scaled,
                        float omega, float grad_norm, LossNorms norms, bf16* d_wb,
                        float* losses, cudaStream_t stream) {
  stack_reduce_kernel<NL><<<stride_blocks((long long)G * po), kThreads, 0, stream>>>(
      partials, G, S, po, po + (po & 1), n_scaled, omega, grad_norm, norms, d_wb, losses);
  return (int)cudaGetLastError();
}

struct StackGeometry {
  int n16, ld, n_cb, splits, grid_g, resident, stage_w;
  size_t smem, block_bytes, carry_offset;
};

constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// The layout of a kernel whose tiles of tp points stack into tr rows (tr / 16
// slabs) at width n, with nl loss sums, on [G, P] (a tile's f32 staging: its
// [tr, so] output and, with targets, [tr, so] targets and tp point weights;
// K3 stages no targets): 0 = it fits, 2 = even two
// working planes exceed a block's shared memory (the caller has checked the
// rest of the shape). In order of preference: every S plane, D and the
// staged W_m in shared memory (resident); two working planes and W_m, the S
// planes in the block's global scratch; two working planes alone, W_m read
// from global memory. The carry holds two slots of every slab's fragment
// for each of a warp's column blocks (resblock chains, or widths above 128).
// The grid is (S, G) with S = SMs / G splits: one wave of one block per SM.
int stack_geometry(int n, int si, int so, int n_mats, int chain, int G, int P, int tp, int tr,
                   int nl, StackGeometry* g, bool targets = true) {
  g->n16 = round16(n) / 16;
  g->ld = round16(n) + 8;
  g->n_cb = (g->n16 + kWarps - 1) / kWarps;
  const size_t plane = 2 * (size_t)tr * g->ld;
  const size_t wplane = 2 * (size_t)g->n16 * 16 * g->ld;
  const size_t params = (size_t)(si + 1 + n_mats + so) * n + so;
  const size_t staged = targets ? 2 * (size_t)tr * so + tp : (size_t)tr * so;
  const size_t small = 4 * (staged + (size_t)nl * kWarps + params) + 2 * (size_t)tp * si;
  const size_t resident = (n_mats + 2) * plane + wplane + small;
  g->resident = resident <= kMaxSmem;
  g->stage_w = g->resident || 2 * plane + wplane + small <= kMaxSmem;
  g->smem = g->resident ? resident : 2 * plane + (g->stage_w ? wplane : 0) + small;
  const size_t planes_bytes = g->resident ? 0 : (size_t)n_mats * plane;
  const bool carry = chain == kSirenResblock || g->n_cb > 1;
  const size_t carry_bytes = carry ? 4 * (size_t)2 * g->n_cb * (tr / 16) * 8 * kThreads : 0;
  g->carry_offset = (planes_bytes + 15) / 16 * 16;
  g->block_bytes = (g->carry_offset + carry_bytes + 15) / 16 * 16;
  const int n_tiles = (P + tp - 1) / tp;
  const int sms = sm_count();
  int splits = sms > G ? sms / G : 1;
  splits = splits < kMaxStackSplits ? splits : kMaxStackSplits;
  g->splits = splits < n_tiles ? splits : n_tiles;
  g->grid_g = G < 65535 ? G : 65535;
  return g->smem > kMaxSmem ? 2 : 0;
}

// out(r, j, sum over k < 16 n16 of S[r][k] B(k, j)) for the tr stacked rows
// of a bf16 plane S (row stride ld, columns from n to 16 n16 zero) and j < nc:
// warp w takes the 16-row slabs w, w + 8, ..., each an mma.m16n8k16 chain
// per 8 columns of B. b(k, j) gives B's element as a bf16 value (zero where
// B has none); out(r, j, v) takes the f32 sum.
template <typename BF, typename OUT>
__device__ __forceinline__ void slab_product_mma(const bf16* S, int ld, int tr, int n16, int nc,
                                                 BF b, OUT out, const Lane& l) {
  for (int sl = l.warp; sl < tr / 16; sl += kWarps) {
    const bf16* a_row = S + (sl * 16 + (l.lane & 15)) * ld + 8 * (l.lane >> 4);
    for (int jb = 0; jb < nc; jb += 8) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const int j = jb + l.g;  // B's column of this lane
      for (int kk = 0; kk < n16; ++kk) {
        uint32_t af[4];
        ldsm_x4(af, a_row + kk * 16);
        const int k0 = kk * 16 + 2 * l.q;
        mma_bf16_16816(acc, af, pack_bf16(b(k0, j), b(k0 + 1, j)),
                       pack_bf16(b(k0 + 8, j), b(k0 + 9, j)));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = sl * 16 + l.g + 8 * (i >> 1);
        const int c = jb + 2 * l.q + (i & 1);
        if (c < nc) out(r, c, acc[i]);
      }
    }
  }
}

// O[r][j] = sum over k < n of S[r][k] WL[k][j] for the tr stacked rows of a
// bf16 plane S (row stride ld, columns from n to 16 n16 zero) and j < so
// (slab_product_mma): WL is the group's f32 last layer in shared memory,
// [n, so], whose values are bf16 ones, so its bf16 operand is exact. O is
// f32 [tr, so]; the caller's barrier shows it to the block.
__device__ __forceinline__ void last_product_mma(const bf16* S, int ld, int tr, int n, int n16,
                                                 const float* WL, int so, float* O,
                                                 const Lane& l) {
  slab_product_mma(
      S, ld, tr, n16, so,
      [&](int k, int j) { return __float2bfloat16_rn(k < n && j < so ? WL[k * so + j] : 0.f); },
      [&](int r, int c, float v) { O[r * so + c] = v; }, l);
}

}  // namespace
