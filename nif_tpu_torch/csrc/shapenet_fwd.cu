// K1 on Hopper: the forward of the grouped ShapeNet chain.
//
// Replaces nif_tpu/ops/pallas_shapenet.py::_fwd_kernel (reached through
// shapenet_grouped_fused -> _fwd_pallas -> _forward_layers(save=False)):
//   wb' [G, po] (omega_0 already folded into every sine-fed weight matrix
//   by the Python wrapper), x [G, P, si]  ->  out [G, P, so] in x's dtype,
//   float or bf16, with every product summed in f32.
// wb' keeps the reference's flat order [W_first | W_hidden... | W_last |
// b_first | b_hidden... | b_last], so the kernel reads each layer by offset.
//
// What bounds it on an H100 SXM: operations, not bytes. The flagship serving
// shape (G=32, P=32768, width n=128, two hidden layers, si=3, so=1) is
// 69.8 GFLOP of products (~71 us at the 989 TFLOP/s bf16 tensor-core peak)
// plus ~403 M sine evaluations (~84 us on the f32 cores), against ~10.5 MB
// of traffic (~3 us at 3.35 TB/s).
//
// This design is a deliberate first step: simple and right, not fast. Every
// product runs as an f32 FMA on the CUDA cores. A bf16 x bf16 product is
// exact in f32, so this computes the same function as a bf16 MMA with f32
// accumulation, and the f32 path must not use TF32 in any case. It is bound
// by the f32 FMA rate, far above the bound above; tensor cores (mma/wgmma)
// and TMA staging are later work.
//
// Layout of the work: one block of 256 threads takes one group g and a tile
// of TP points. The [TP, n] activation tile lives in shared memory as f32
// values already rounded to the compute dtype (the reference's `lift` before
// every matmul). The residual state of each output element (resblock sum,
// vanilla shortcut) stays in registers of the thread that owns it, in f32.
// Each layer's weight matrix is staged from wb' into shared memory in chunks
// of kc rows, so no width needs the whole chain resident (at width 256 the
// hidden matrices alone are 256 KB in bf16). Thread (warp tr, lane tc) owns
// rows tr*RM .. tr*RM+RM-1 and columns tc, tc+32, ..., so a warp reads one
// weight row without bank conflicts and broadcasts each activation. Rows
// past P are computed on zeros and never stored.
#include "shapenet_common.cuh"

namespace {

template <typename T, int RN>
__device__ __forceinline__ void load_bias(float (&bias)[RN], const T* __restrict__ bg, int n,
                                          int tc) {
#pragma unroll
  for (int j = 0; j < RN; ++j) {
    const int c = tc + j * kLanes;
    bias[j] = c < n ? to_f32(bg[c]) : 0.f;
  }
}

template <typename T, int RM, int RN>
__device__ __forceinline__ void store_tile(float* __restrict__ A, int lda, int n, int r0, int tc,
                                           const float (&u)[RM][RN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int c = tc + j * kLanes;
      if (c < n) A[(r0 + i) * lda + c] = lift<T>(u[i][j]);
    }
}

template <typename T, int RM, int RN>
__global__ void __launch_bounds__(kThreads)
    shapenet_fwd_kernel(const T* __restrict__ wb, const T* __restrict__ x, T* __restrict__ out,
                        int G, int P, int si, int so, int n, int n_mats, int n_steps, int chain,
                        int act, long long po, int kc) {
  constexpr int TP = RM * kWarps;
  extern __shared__ float smem[];
  const int lda = max(n, si);
  float* A = smem;              // [TP, lda] activations (or x for the first layer)
  float* ws = smem + TP * lda;  // [kc, n] staged weight rows
  const int tc = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int r0 = warp * RM;
  const int p0 = blockIdx.x * TP;
  const int rows = min(TP, P - p0);

  const long long o_wh = (long long)si * n;
  const long long o_wl = o_wh + (long long)n_mats * n * n;
  const long long o_b0 = o_wl + (long long)n * so;
  const long long o_bh = o_b0 + n;
  const long long o_bl = o_bh + (long long)n_mats * n;

  for (int g = blockIdx.y; g < G; g += gridDim.y) {
    const T* wg = wb + (long long)g * po;
    const T* xg = x + ((long long)g * P + p0) * si;
    for (int idx = threadIdx.x; idx < TP * si; idx += kThreads) {
      const int r = idx / si;
      A[r * lda + idx - r * si] = r < rows ? to_f32(xg[idx]) : 0.f;
    }

    float acc[RM][RN], u[RM][RN], bias[RN];
    // First layer, K = si: z = x @ W0' + b0, u = act(z).
    matmul_fwd<float, T, RM, RN, false, 4>(A, lda, si, TP, wg, n, ws, kc, r0, tc, acc);
    load_bias<T, RN>(bias, wg + o_b0, n, tc);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) u[i][j] = activate(acc[i][j] + bias[j], act);
    store_tile<T, RM, RN>(A, lda, n, r0, tc, u);

    for (int m = 0; m < n_steps; ++m) {
      matmul_fwd<float, T, RM, RN, false, 4>(A, lda, n, TP, wg + o_wh + (long long)m * n * n, n,
                                             ws, kc, r0, tc, acc);
      load_bias<T, RN>(bias, wg + o_bh + (long long)m * n, n, tc);
      if (chain == kSirenResblock && m % 2 == 0) {
        // h = sin(z) feeds the block's second matmul; u waits in registers.
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = activate(acc[i][j] + bias[j], act);
        store_tile<T, RM, RN>(A, lda, n, r0, tc, acc);
        continue;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const float y = activate(acc[i][j] + bias[j], act);
          if (chain == kSirenResblock) {
            u[i][j] = 0.5f * (u[i][j] + y);
          } else if (chain == kVanilla) {
            u[i][j] = y + u[i][j];
          } else {
            u[i][j] = y;
          }
        }
      store_tile<T, RM, RN>(A, lda, n, r0, tc, u);
    }

    // Last layer: out = lift(u) @ W_last + b_last. One warp per (row,
    // output) pair; the lanes split k and meet in a shuffle reduction.
    __syncthreads();
    for (int pr = warp; pr < rows * so; pr += kWarps) {
      const int r = pr / so;
      const int j = pr - r * so;
      float s = 0.f;
      for (int k = tc; k < n; k += kLanes)
        s = fmaf(A[r * lda + k], to_f32(wg[o_wl + (long long)k * so + j]), s);
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (tc == 0)
        out[((long long)g * P + p0 + r) * so + j] = from_f32<T>(s + to_f32(wg[o_bl + j]));
    }
    __syncthreads();  // A is read out before the next group overwrites it
  }
}

// The launch geometry of width n with si inputs. Thread (warp tr, lane tc)
// owns RN = ceil(n / 32) (rounded up to a power of two) columns and RM rows,
// at most 32 output elements; a block takes TP = RM * 8 points. Weights are
// staged kc rows at a time, kc * n <= kWChunkFloats.
constexpr int kWChunkFloats = 8192;

struct Geometry {
  int rn, tile, kc;
  size_t smem;
};

// Status of a width: kGeomOk, or why the kernel cannot take it.
enum GeomStatus : int { kGeomOk = 0, kGeomTooWide = 1, kGeomTooMuchSmem = 2, kGeomBadShape = 3 };

int geometry(int n, int si, Geometry* g) {
  if (n < 1 || si < 1) return kGeomBadShape;
  const int rn = columns_per_thread(n);
  if (rn == 0) return kGeomTooWide;
  g->rn = rn;
  g->tile = rows_per_thread(rn) * kWarps;
  g->kc = kWChunkFloats / n > 1 ? kWChunkFloats / n : 1;
  g->smem = sizeof(float) * ((size_t)g->tile * (n > si ? n : si) + (size_t)g->kc * n);
  return g->smem > kMaxSmem ? kGeomTooMuchSmem : kGeomOk;
}

template <typename T, int RN>
int launch(const Geometry& geo, const void* wb, const void* x, void* out, int G, int P, int si,
           int so, int n, int n_mats, int n_steps, int chain, int act, long long po,
           cudaStream_t stream) {
  constexpr int RM = rows_per_thread(RN);
  auto kernel = shapenet_fwd_kernel<T, RM, RN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P + geo.tile - 1) / geo.tile, G < 65535 ? G : 65535);
  kernel<<<grid, kThreads, geo.smem, stream>>>(static_cast<const T*>(wb),
                                               static_cast<const T*>(x), static_cast<T*>(out), G,
                                               P, si, so, n, n_mats, n_steps, chain, act, po,
                                               geo.kc);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Geometry& g, const void* wb, const void* x, void* out, int G, int P, int si,
             int so, int n, int n_mats, int n_steps, int chain, int act, long long po,
             cudaStream_t s) {
  return with_rn(g.rn, [&](auto rn) {
    return launch<T, decltype(rn)::value>(g, wb, x, out, G, P, si, so, n, n_mats, n_steps, chain,
                                          act, po, s);
  });
}

}  // namespace

extern "C" {

// Whether the kernel takes width n with si inputs (a GeomStatus); on
// kGeomOk or kGeomTooMuchSmem it writes the points per block and the bytes
// of dynamic shared memory a block needs.
int nif_shapenet_fwd_geometry(int n, int si, int* tile, long long* smem_bytes) {
  Geometry g{};
  const int status = geometry(n, si, &g);
  *tile = g.tile;
  *smem_bytes = (long long)g.smem;
  return status;
}

// dtype: 0 = float, 1 = bf16 (wb', x and out share it). Returns the CUDA
// error of the launch (0 on success); the kernel runs asynchronously on
// `stream`.
int nif_shapenet_fwd(const void* wb, const void* x, void* out, int G, int P, int si, int so,
                     int n, int n_mats, int n_steps, int chain, int act, long long po, int dtype,
                     void* stream) {
  Geometry g{};
  if (geometry(n, si, &g) != kGeomOk || so < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(g, wb, x, out, G, P, si, so, n, n_mats, n_steps, chain, act, po, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(g, wb, x, out, G, P, si, so, n, n_mats, n_steps, chain, act,
                                   po, s);
  return (int)cudaErrorInvalidValue;
}

const char* nif_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
