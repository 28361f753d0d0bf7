// nifio — native data-loading kernels for nif_tpu.
//
// The reference implementation's data pipeline bottleneck is Python-level
// row handling (it resorted to one giant columnar tf.train.Example per shard
// to avoid per-point serialization; reference nif/data/tfr_dataset.py and
// tutorial 5 cell 22). Here the hot loop — shuffling multi-GB point clouds
// by gathering rows through a permutation — is a multithreaded C++ kernel
// driven via ctypes (no pybind11 in this environment).
//
// Build: g++ -O3 -march=native -shared -fPIC -pthread _nifio.cpp -o libnifio.so

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

namespace {

int resolve_threads(int n_threads) {
  if (n_threads > 0) return n_threads;
  unsigned hw = std::thread::hardware_concurrency();
  return hw ? static_cast<int>(hw) : 4;
}

// Parallel-for over [0, n) in contiguous chunks.
template <typename F>
void parallel_for(int64_t n, int n_threads, F&& fn) {
  n_threads = resolve_threads(n_threads);
  if (n_threads <= 1 || n < (1 << 14)) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    workers.emplace_back([&fn, lo, hi] { fn(lo, hi); });
  }
  for (auto& w : workers) w.join();
}

}  // namespace

extern "C" {

// out[i, :] = src[idx[i], :] — the shuffle-gather hot loop.
// Out-of-range indices zero-fill their output row (never leaving
// uninitialized memory in the batch) and are COUNTED; the return value is
// the number of bad indices so the Python wrapper can raise instead of
// training on silently-corrupted data.
int64_t nifio_gather_rows(const float* src, int64_t n_src_rows, int64_t n_cols,
                          const int64_t* idx, int64_t n_idx, float* out,
                          int n_threads) {
  const size_t row_bytes = static_cast<size_t>(n_cols) * sizeof(float);
  std::atomic<int64_t> n_bad{0};
  parallel_for(n_idx, n_threads, [&](int64_t lo, int64_t hi) {
    int64_t bad = 0;
    for (int64_t i = lo; i < hi; ++i) {
      int64_t j = idx[i];
      if (j < 0 || j >= n_src_rows) {
        std::memset(out + i * n_cols, 0, row_bytes);
        ++bad;
        continue;
      }
      std::memcpy(out + i * n_cols, src + j * n_cols, row_bytes);
    }
    if (bad) n_bad.fetch_add(bad, std::memory_order_relaxed);
  });
  return n_bad.load(std::memory_order_relaxed);
}

// out = src[perm(seed), :] — full-shard shuffle with an internal
// Fisher-Yates permutation (so Python never materializes the index array).
void nifio_permute_rows(const float* src, int64_t n_rows, int64_t n_cols,
                        uint64_t seed, float* out, int n_threads) {
  std::vector<int64_t> perm(static_cast<size_t>(n_rows));
  for (int64_t i = 0; i < n_rows; ++i) perm[static_cast<size_t>(i)] = i;
  std::mt19937_64 rng(seed);
  for (int64_t i = n_rows - 1; i > 0; --i) {
    std::uniform_int_distribution<int64_t> dist(0, i);
    std::swap(perm[static_cast<size_t>(i)],
              perm[static_cast<size_t>(dist(rng))]);
  }
  nifio_gather_rows(src, n_rows, n_cols, perm.data(), n_rows, out, n_threads);
}

// Batched conversion f32 -> bf16 (round-to-nearest-even), for feeding
// device buffers without a numpy round-trip.
void nifio_f32_to_bf16(const float* src, int64_t n, uint16_t* out,
                       int n_threads) {
  parallel_for(n, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      uint32_t bits;
      std::memcpy(&bits, src + i, sizeof(bits));
      if ((bits & 0x7fffffffu) > 0x7f800000u) {
        // NaN: the rounding carry can wrap high-payload NaNs to +/-0;
        // emit a quiet NaN preserving the sign instead.
        out[i] = static_cast<uint16_t>((bits >> 16) | 0x0040u);
        continue;
      }
      uint32_t lsb = (bits >> 16) & 1u;
      uint32_t rounded = bits + 0x7fffu + lsb;
      out[i] = static_cast<uint16_t>(rounded >> 16);
    }
  });
}

}  // extern "C"
