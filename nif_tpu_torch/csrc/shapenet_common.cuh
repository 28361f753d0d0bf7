// Device helpers shared by the grouped ShapeNet kernels (shapenet_fwd.cu,
// shapenet_bwd.cu, shapenet_jac.cu): the thread layout, the activation and
// chain codes, the reference's rounding (`lift`), the activations with their
// derivatives (the polynomial sine of the bf16 kernels among them), the tile
// products and the per-block gradient partials. Each source includes this
// header and builds into its own library; ops/_build.py hashes the header
// with each source, so an edit here rebuilds all three.
//
// Thread (warp tr, lane tc) of a 256-thread block owns rows tr*RM ..
// tr*RM+RM-1 and columns tc, tc+32, ... of a [TP, n] tile: RN = ceil(n / 32)
// rounded up to a power of two (at most kMaxRn) columns, RM = rows_per_thread
// rows, so a warp reads one weight row without bank conflicts and broadcasts
// each activation.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 32;
constexpr int kWarps = kThreads / kLanes;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may opt in to
// Shared memory a block may use when two share an SM: the SM's 228 KB less
// the 1 KB the card reserves for each block, halved.
constexpr size_t kHalfSmSmem = (233472 - 2 * 1024) / 2;
constexpr int kMaxRn = 32;

constexpr int rows_per_thread(int rn) { return rn <= 4 ? 8 : 32 / rn; }

// Activation codes: keep in step with _ACT_CODES in ops/fused_shapenet.py.
enum Act : int {
  kSinePoly7 = 0,
  kSinePoly9 = 1,
  kSineExact = 2,
  kTanh = 3,
  kRelu = 4,
  kSwish = 5,
  kSigmoid = 6,
  kLinear = 7,
};

// Chain codes: keep in step with _CHAIN_CODES in ops/fused_shapenet.py.
enum Chain : int { kSirenPlain = 0, kSirenResblock = 1, kVanilla = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Round to the compute dtype and back: the reference's `lift`, its cast
// before a matmul.
template <typename T> __device__ __forceinline__ float lift(float v);
template <> __device__ __forceinline__ float lift<float>(float v) { return v; }
template <> __device__ __forceinline__ float lift<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The bf16 kernels' sine (_fast_sin, _fast_sin_grad, _fast_sin_grad2): one
// range reduction t = z/2pi - rint(z/2pi) (rint rounds half to even, as
// jnp.round does), then an odd minimax polynomial in t of degree 7 (_SIN_C7)
// or 9 (_SIN_C), with s = t*t. sin_poly_dt and sin_poly_dt2 are its exact
// first and second derivatives in t; times 1/2pi and (1/2pi)^2 they are the
// derivatives in z (the third, stack_tc.cuh's sine_d123, times (1/2pi)^3).
constexpr float kInv2Pi = 0.15915494309189535f;
constexpr float kInv2Pi2 = (float)0.025330295910584444;
constexpr float kInv2Pi3 =
    (float)(0.15915494309189535 * 0.15915494309189535 * 0.15915494309189535);

__device__ __forceinline__ float sin_turns(float z) {
  const float t = z * kInv2Pi;
  return t - rintf(t);
}

__device__ __forceinline__ float sin_poly(float t, float s, bool degree9) {
  if (degree9)
    return t * (6.28308846f +
                s * (-41.33324754f + s * (81.40008977f + s * (-74.67588387f + s * 33.16809461f))));
  return t * (6.27863546f + s * (-41.09373072f + s * (77.93034984f + s * -56.08639487f)));
}

__device__ __forceinline__ float sin_poly_dt(float s, bool degree9) {
  if (degree9)
    return 6.28308846f +
           s * (-123.99974262f + s * (407.00044885f + s * (-522.73118709f + s * 298.51285149f)));
  return 6.27863546f + s * (-123.28119216f + s * (389.6517492f + s * -392.60476409f));
}

__device__ __forceinline__ float sin_poly_dt2(float t, float s, bool degree9) {
  if (degree9)
    return t * ((float)(6.0 * -41.33324754) +
                s * ((float)(20.0 * 81.40008977) +
                     s * ((float)(42.0 * -74.67588387) + s * (float)(72.0 * 33.16809461))));
  return t * ((float)(6.0 * -41.09373072) +
              s * ((float)(20.0 * 77.93034984) + s * (float)(42.0 * -56.08639487)));
}

// (act(z), act'(z), act''(z)) on f32 z: _act_triple (_act_with_grad for the
// first two). An inlined caller that ignores *d2 pays nothing for it.
__device__ __forceinline__ float act3(float z, int act, float* d1, float* d2) {
  switch (act) {
    case kSinePoly7:
    case kSinePoly9: {
      const bool deg9 = act == kSinePoly9;
      const float t = sin_turns(z);
      const float s = t * t;
      *d1 = sin_poly_dt(s, deg9) * kInv2Pi;
      *d2 = sin_poly_dt2(t, s, deg9) * kInv2Pi2;
      return sin_poly(t, s, deg9);
    }
    case kSineExact: {
      float sn, cs;
      sincosf(z, &sn, &cs);
      *d1 = cs;
      *d2 = -sn;
      return sn;
    }
    case kTanh: {
      const float a = tanhf(z);
      *d1 = 1.f - a * a;
      *d2 = -2.f * a * (1.f - a * a);
      return a;
    }
    case kRelu:
      *d1 = z > 0.f ? 1.f : 0.f;
      *d2 = 0.f;
      return fmaxf(z, 0.f);
    case kSwish: {
      const float s = 1.f / (1.f + expf(-z));
      *d1 = s * (1.f + z * (1.f - s));
      *d2 = s * (1.f - s) * (2.f + z * (1.f - 2.f * s));
      return z * s;
    }
    case kSigmoid: {
      const float s = 1.f / (1.f + expf(-z));
      *d1 = s * (1.f - s);
      *d2 = s * (1.f - s) * (1.f - 2.f * s);
      return s;
    }
    default:
      *d1 = 1.f;
      *d2 = 0.f;
      return z;
  }
}

// (act(z), act'(z)) on f32 z: _act_with_grad.
__device__ __forceinline__ float act_grad(float z, int act, float* d) {
  float unused;
  return act3(z, act, d, &unused);
}

// acc[i][j] = sum_{k<K} A[r0+i][k] * W[k][tc + 32 j] for rows r0+i < rows
// (0 past them): A is a [rows, lda] tile of TA, W row-major [K, n] in global
// memory, staged through ws in chunks of kc rows. Begins and ends with a
// barrier, so the caller may overwrite A as soon as it returns. A caller
// whose every thread row is live (rows = RM * kWarps) passes GUARD = false
// and pays for no row predicates in its inner loop.
template <typename TA, typename T, int RM, int RN, bool GUARD = true, int UNROLL = 2>
__device__ __forceinline__ void matmul_fwd(const TA* A, int lda, int K, int rows,
                                           const T* __restrict__ wg, int n, float* __restrict__ ws,
                                           int kc, int r0, int tc, float (&acc)[RM][RN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kc) {
    const int kn = min(kc, K - k0);
    __syncthreads();  // A is complete and the previous chunk of ws is consumed
    for (int idx = threadIdx.x; idx < kn * n; idx += kThreads)
      ws[idx] = to_f32(wg[(size_t)k0 * n + idx]);
    __syncthreads();
#pragma unroll (UNROLL)
    for (int k = 0; k < kn; ++k) {
      float w[RN];
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int c = tc + j * kLanes;
        w[j] = c < n ? ws[k * n + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float a = !GUARD || r0 + i < rows ? to_f32(A[(r0 + i) * lda + k0 + k]) : 0.f;
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a, w[j], acc[i][j]);
      }
    }
  }
  __syncthreads();
}

// acc[i][j] = sum_{c<n_out} DZ[r0+i][c] * W[tc + 32 j][c] for rows r0+i <
// rows: dz @ W^T, with W row-major [K_in, n_out] in global memory. Each
// chunk of kc columns of W is staged transposed, ws[cc][k] = W[k][c0 + cc]
// with rows of K_in + 1 floats, so the transposing store is free of bank
// conflicts and lanes read consecutive k. Begins and ends with a barrier.
// GUARD as in matmul_fwd.
template <typename T, int RM, int RN, bool GUARD = true>
__device__ __forceinline__ void matmul_bwd(const float* DZ, int n_out, const T* __restrict__ wg,
                                           int K_in, int rows, float* __restrict__ ws, int kc,
                                           int r0, int tc, float (&acc)[RM][RN]) {
  const int ldw = K_in + 1;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  for (int c0 = 0; c0 < n_out; c0 += kc) {
    const int cn = min(kc, n_out - c0);
    __syncthreads();  // DZ is complete and the previous chunk of ws is consumed
    for (int idx = threadIdx.x; idx < K_in * cn; idx += kThreads) {
      const int k = idx / cn;
      const int cc = idx - k * cn;
      ws[cc * ldw + k] = to_f32(wg[(size_t)k * n_out + c0 + cc]);
    }
    __syncthreads();
#pragma unroll 2
    for (int cc = 0; cc < cn; ++cc) {
      float w[RN];
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int k = tc + j * kLanes;
        w[j] = k < K_in ? ws[cc * ldw + k] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float a = !GUARD || r0 + i < rows ? DZ[(r0 + i) * n_out + c0 + cc] : 0.f;
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a, w[j], acc[i][j]);
      }
    }
  }
  __syncthreads();
}

// Add one tile's contribution to a block partial: write on the block's
// first tile, accumulate after it (the block owns the partial).
__device__ __forceinline__ void accumulate(float* p, float v, bool first) {
  *p = first ? v : *p + v;
}

// dW[k][c] = sum_{r<rows} A[r][k] * DZ[r][c] for k < K, c < n, added into
// out (row-major [K, n]). Thread (warp, tc) takes RK rows k of each chunk of
// kWarps*RK rows and the columns tc + 32 j; A is read as a broadcast, DZ
// along the lanes. The caller has synchronized DZ.
template <typename TA, int RK, int RN>
__device__ __forceinline__ void weight_grad(const TA* A, int lda, int K,
                                            const float* __restrict__ DZ, int n, int rows,
                                            float* __restrict__ out, bool first, int warp,
                                            int tc) {
  for (int kb = 0; kb < K; kb += kWarps * RK) {
    const int k0 = kb + warp * RK;
    if (k0 >= K) continue;
    float acc[RK][RN];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
    for (int r = 0; r < rows; ++r) {
      float dz[RN];
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int c = tc + j * kLanes;
        dz[j] = c < n ? DZ[r * n + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const float a = k0 + i < K ? to_f32(A[r * lda + k0 + i]) : 0.f;
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a, dz[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int c = tc + j * kLanes;
        if (k0 + i < K && c < n) accumulate(out + (size_t)(k0 + i) * n + c, acc[i][j], first);
      }
  }
}

// db[c] = sum_{r<rows} DZ[r][c], added into out.
__device__ __forceinline__ void bias_grad(const float* __restrict__ DZ, int n, int rows,
                                          float* __restrict__ out, bool first) {
  for (int c = threadIdx.x; c < n; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += DZ[r * n + c];
    accumulate(out + c, s, first);
  }
}

// A block's residual region (the stacked train kernels, K6 and K8): in
// shared memory after its working buffers, or the block's slice of a global
// scratch. A is the kernel's argument struct.
template <typename A>
__device__ __forceinline__ unsigned char* residuals(const A& a, unsigned char* after_work) {
  return a.resid_in_smem ? after_work
                         : static_cast<unsigned char*>(a.scratch) +
                               ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * a.resid_bytes;
}

// Write a block's NL loss sums to out[0..NL): each warp's lanes summed by
// shuffles, then the warps in order by thread 0, through ws (NL * kWarps
// floats, which every thread must be done with). Same bits on every run.
template <int NL>
__device__ __forceinline__ void store_loss_partials(float (&loss)[NL], float* ws, float* out) {
  const int tc = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  __syncthreads();  // every thread is done with ws
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
#pragma unroll
    for (int l = 0; l < NL; ++l) loss[l] += __shfl_xor_sync(0xffffffffu, loss[l], off);
  if (tc == 0)
#pragma unroll
    for (int l = 0; l < NL; ++l) ws[l * kWarps + warp] = loss[l];
  __syncthreads();
  if (threadIdx.x == 0)
    for (int l = 0; l < NL; ++l) {
      float total = 0.f;
      for (int w = 0; w < kWarps; ++w) total += ws[l * kWarps + w];
      out[l] = total;
    }
}

// The divisor of each loss sum (the selected entries of its term).
struct LossNorms {
  float n[4];
};

// The split reduce of the stacked train kernels (K6, K8): d_wb[g][p] =
// T((sum_s partial[g][s][p]) * (p < n_scaled ? omega : 1)), the S splits
// summed in order; then one thread per loss sums its G*S partials (laid out
// [G, S, NL] after the [G, S, po] weight grads) in order and divides by its
// norm. No float atomics: two runs give the same bits.
template <typename T, int NL>
__global__ void __launch_bounds__(kThreads)
    split_reduce_kernel(const float* __restrict__ partials, int G, int S, long long po,
                        long long n_scaled, float omega, LossNorms norms, T* __restrict__ d_wb,
                        float* __restrict__ losses) {
  const long long total = (long long)G * po;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * kThreads) {
    const long long g = idx / po;
    const long long p = idx - g * po;
    const float* src = partials + g * S * po + p;
    float sum = 0.f;
    for (int s = 0; s < S; ++s) sum += src[s * po];
    if (p < n_scaled) sum = sum * omega;
    d_wb[idx] = from_f32<T>(sum);
  }
  if (blockIdx.x == 0 && threadIdx.x < NL) {
    const float* lp = partials + (long long)G * S * po + threadIdx.x;
    float sum = 0.f;
    for (long long i = 0; i < (long long)G * S; ++i) sum += lp[NL * i];
    losses[threadIdx.x] = sum / norms.n[threadIdx.x];
  }
}

// The columns per thread of width n (0 when n is wider than kMaxRn * 32).
inline int columns_per_thread(int n) {
  int rn = 1;
  while (kLanes * rn < n) rn *= 2;
  return rn > kMaxRn ? 0 : rn;
}

// f(std::integral_constant<int, rn>{}) for the columns per thread rn of a
// geometry, so each width runs its own template instance.
template <typename F>
int with_rn(int rn, F&& f) {
  switch (rn) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// The streaming multiprocessors of the current device (132 on an H100 SXM,
// 114 on an H100 PCIe), or 0 when it cannot be read.
inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    cudaGetLastError();  // leave no error behind for the next launch's check
    return 0;
  }
  return sms;
}

// Blocks of a grid-stride pass over `total` elements: one per kThreads
// elements, at most 16 per SM.
inline int stride_blocks(long long total) {
  const long long want = (total + kThreads - 1) / kThreads;
  const int sms = sm_count();
  const long long cap = 16LL * (sms > 0 ? sms : 1);
  return (int)(want < cap ? want : cap);
}

// Launch split_reduce_kernel over G * po weight grads on `stream`; returns
// the CUDA error of the launch.
template <typename T, int NL>
int launch_split_reduce(const float* partials, int G, int S, long long po, long long n_scaled,
                        float omega, LossNorms norms, T* d_wb, float* losses,
                        cudaStream_t stream) {
  split_reduce_kernel<T, NL><<<stride_blocks((long long)G * po), kThreads, 0, stream>>>(
      partials, G, S, po, n_scaled, omega, norms, d_wb, losses);
  return (int)cudaGetLastError();
}

}  // namespace
