// Native host-side data feed engine.
//
// Reference analog: paddle/fluid/framework/data_feed.cc (MultiSlotDataFeed
// batch assembly) + data_set.cc shuffling + operators/reader/
// buffered_reader.cc host staging.  The TPU framework keeps device memory
// management inside XLA, but the host side of the input pipeline — index
// shuffling and batch gather/cast into a contiguous feed buffer — is the
// part that stays native (SURVEY §2 native-component checklist, row 9/20):
// Python-level per-row loops are GIL-bound and dominate input-bound steps.
//
// paddle_tpu_torch's copy of csrc/datafeed.cc (the same code: its results
// equal the reference build's bit for bit).  Built at first use with g++
// into paddle_tpu_torch/io/build/ and loaded via ctypes by
// paddle_tpu_torch/io/native_feed.py.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// xorshift64* — deterministic, seedable, fast enough for index permutation
inline uint64_t next_rand(uint64_t* state) {
  uint64_t x = *state;
  x ^= x >> 12;
  x ^= x << 25;
  x ^= x >> 27;
  *state = x;
  return x * 0x2545F4914F6CDD1DULL;
}

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

// Run fn(start, end) over [0, n) on up to `want` threads.
template <typename F>
void parallel_for(int64_t n, int want, F fn) {
  int threads = std::min<int64_t>(std::max(want, 1), std::max<int64_t>(n, 1));
  if (threads <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// In-place Fisher-Yates shuffle of an int64 index array (data_set.cc
// LocalShuffle analog, deterministic under `seed`).
void ptpu_shuffle_indices(int64_t* idx, int64_t n, uint64_t seed) {
  uint64_t state = seed | 1;  // xorshift state must be nonzero
  for (int64_t i = n - 1; i > 0; --i) {
    int64_t j = static_cast<int64_t>(next_rand(&state) % (i + 1));
    std::swap(idx[i], idx[j]);
  }
}

// Gather rows of a contiguous float32 array into a batch buffer:
// dst[r] = src[rows[r]] for r in [0, n_rows); row_elems elements per row.
void ptpu_gather_f32(const float* src, const int64_t* rows, int64_t n_rows,
                     int64_t row_elems, float* dst) {
  parallel_for(n_rows, hw_threads() / 2, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      std::memcpy(dst + r * row_elems, src + rows[r] * row_elems,
                  sizeof(float) * row_elems);
    }
  });
}

// Gather + cast uint8 rows to float32 with scale (image datasets stored as
// u8 feed the model as f32; the cast fuses into the gather pass).
void ptpu_gather_u8_to_f32(const uint8_t* src, const int64_t* rows,
                           int64_t n_rows, int64_t row_elems, float* dst,
                           float scale) {
  parallel_for(n_rows, hw_threads() / 2, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      const uint8_t* s = src + rows[r] * row_elems;
      float* d = dst + r * row_elems;
      for (int64_t e = 0; e < row_elems; ++e) d[e] = s[e] * scale;
    }
  });
}

// Gather int64 label rows (row_elems may be 1 for scalar labels).
void ptpu_gather_i64(const int64_t* src, const int64_t* rows, int64_t n_rows,
                     int64_t row_elems, int64_t* dst) {
  parallel_for(n_rows, hw_threads() / 2, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      std::memcpy(dst + r * row_elems, src + rows[r] * row_elems,
                  sizeof(int64_t) * row_elems);
    }
  });
}

// Hogwild scatter-accumulate: table[slots[i]] += alpha * grads[i].
// Deliberately NO locks and NO atomics — the reference HogwildWorker's
// contract (device_worker.h:240): concurrent workers race on shared rows
// and the occasional lost update is accepted for wait-free throughput.
// ctypes releases the GIL for the duration of this call, so Python
// worker THREADS genuinely update the table in parallel.
void ptpu_scatter_axpy(float* table, int64_t stride, const int64_t* slots,
                       int64_t n, int64_t dim, const float* grads,
                       float alpha) {
  for (int64_t i = 0; i < n; ++i) {
    const int64_t row = slots[i];
    if (row < 0) continue;
    float* t = table + row * stride;
    const float* g = grads + i * dim;
    for (int64_t d = 0; d < dim; ++d) t[d] += alpha * g[d];
  }
}

int ptpu_version() { return 1; }

}  // extern "C"
