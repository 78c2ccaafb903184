// Native host-side data pipeline for tinynn_autograd_tpu.
//
// The device compute path is JAX/XLA/Pallas; this is the runtime AROUND it:
// the per-epoch host work of the data iterator (permutation, row gather,
// one-hot expansion) done as flat memcpy-style loops with optional
// threading, callable from Python via ctypes (no pybind11 dependency).
// The Python layer falls back to numpy when the shared object is absent.
//
// Build (done automatically on first import by native/__init__.py):
//   g++ -O3 -march=native -shared -fPIC -o libtinynn_data.so data_loader.cpp -lpthread

#include <cstdint>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

extern "C" {

// dst[i, :] = src[idx[i], :] — the BatchIterator shuffle-gather hot path.
void gather_rows_f32(const float* src, float* dst, const int64_t* idx,
                     int64_t n_rows, int64_t row_elems) {
  const unsigned hw = std::thread::hardware_concurrency();
  const int64_t bytes = row_elems * static_cast<int64_t>(sizeof(float));
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      std::memcpy(dst + i * row_elems, src + idx[i] * row_elems, bytes);
    }
  };
  if (hw <= 1 || n_rows < 4096) {
    work(0, n_rows);
    return;
  }
  const int64_t n_threads = std::min<int64_t>(hw, 8);
  std::vector<std::thread> threads;
  const int64_t chunk = (n_rows + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min(lo + chunk, n_rows);
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
}

// dst[i, labels[i]] = 1.0 over a zeroed [n, num_classes] buffer.
void one_hot_f32(const int64_t* labels, float* dst, int64_t n,
                 int64_t num_classes) {
  std::memset(dst, 0, sizeof(float) * n * num_classes);
  for (int64_t i = 0; i < n; ++i) {
    dst[i * num_classes + labels[i]] = 1.0f;
  }
}

// In-place Fisher-Yates over idx[0..n) seeded deterministically (mt19937_64).
void shuffle_indices(int64_t* idx, int64_t n, uint64_t seed) {
  std::mt19937_64 rng(seed);
  for (int64_t i = n - 1; i > 0; --i) {
    const uint64_t j = rng() % static_cast<uint64_t>(i + 1);
    const int64_t tmp = idx[i];
    idx[i] = idx[j];
    idx[j] = tmp;
  }
}

}  // extern "C"
