// Native test-vector I/O and batch packing for srsran_ce_tpu_torch: a copy of
// srsran_ce_tpu/native/vector_io.cpp (the port imports nothing of the JAX
// package, so it keeps its own).
//
// The reference repo is pure Python (SURVEY.md §2: "no C++/Rust/CUDA/native
// components anywhere"), but its conformance harness hot-loops over millions of
// 12-byte srsRAN `resource_grid_reader_spy::expected_entry_t` records
// (validate_all.py:28-39). This library is the framework's native data-loader tier:
// record parsing and dense-grid scatter at memcpy speed, plus a batched
// complex->ri-layout converter feeding the device ingestion path (the port's
// builders take ri-layout float tensors; see models/estimator.py).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 vector_io.cpp -o libvector_io.so, at
// first use into srsran_ce_tpu_torch/_build/ (native/loader.py).
// Binding: ctypes (srsran_ce_tpu_torch/native/loader.py).

#include <cstdint>
#include <cstring>

#include <algorithm>
#include <thread>
#include <vector>

extern "C" {

// Record layout (little-endian, packed, 12 bytes):
//   uint16 packed = sym << 8 | port
//   uint16 sc
//   float  re, im
struct __attribute__((packed)) Entry {
  uint16_t packed;
  uint16_t sc;
  float re;
  float im;
};

static_assert(sizeof(Entry) == 12, "expected_entry_t must be 12 bytes");

// Parse n records into separate column arrays (int32 sym/port/sc, complex64 value
// as interleaved float pairs).
void parse_entries(const uint8_t* raw, int64_t n, int32_t* sym, int32_t* port,
                   int32_t* sc, float* value_ri) {
  const Entry* e = reinterpret_cast<const Entry*>(raw);
  for (int64_t i = 0; i < n; ++i) {
    sym[i] = e[i].packed >> 8;
    port[i] = e[i].packed & 0xFF;
    sc[i] = e[i].sc;
    value_ri[2 * i] = e[i].re;
    value_ri[2 * i + 1] = e[i].im;
  }
}

// Scatter n records straight into a dense complex64 grid laid out
// (n_sc, n_sym, n_layers), interleaved re/im. Returns the number of records that
// fell outside the grid (callers treat nonzero as a format error).
int64_t entries_to_grid(const uint8_t* raw, int64_t n, float* grid_ri, int64_t n_sc,
                        int64_t n_sym, int64_t n_layers) {
  const Entry* e = reinterpret_cast<const Entry*>(raw);
  int64_t oob = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t sym = e[i].packed >> 8;
    const int64_t port = e[i].packed & 0xFF;
    const int64_t sc = e[i].sc;
    if (sc >= n_sc || sym >= n_sym || port >= n_layers) {
      ++oob;
      continue;
    }
    const int64_t off = 2 * ((sc * n_sym + sym) * n_layers + port);
    grid_ri[off] = e[i].re;
    grid_ri[off + 1] = e[i].im;
  }
  return oob;
}

// Multithreaded batch assembler: gather B scattered per-problem interleaved-
// complex buffers into ONE contiguous (B, 2, n) planar ri batch — the host-side
// packing step of the serving front-end (srsran_ce_tpu/serving.py). Problems
// arrive as independent allocations (one per cell/UE/slot), so this is the
// copy that feeds the host-to-device transfer; threading it overlaps the per-problem
// deinterleave across cores.
void assemble_batch_ri(const float* const* srcs, float* out, int64_t b, int64_t n,
                       int32_t n_threads) {
  n_threads = std::max<int32_t>(1, std::min<int32_t>(n_threads, (int32_t)b));
  std::vector<std::thread> ts;
  ts.reserve(n_threads);
  for (int32_t t = 0; t < n_threads; ++t) {
    ts.emplace_back([=]() {
      for (int64_t i = t; i < b; i += n_threads) {
        const float* src = srcs[i];
        float* dst_re = out + 2 * i * n;
        float* dst_im = dst_re + n;
        for (int64_t j = 0; j < n; ++j) {
          dst_re[j] = src[2 * j];
          dst_im[j] = src[2 * j + 1];
        }
      }
    });
  }
  for (auto& th : ts) th.join();
}

// Batched complex64 -> ri-layout converter: (B, ...) interleaved complex in,
// (B, 2, ...) planar float out. n = elements per problem, b = batch.
void complex_to_ri(const float* interleaved, float* planar, int64_t b, int64_t n) {
  for (int64_t i = 0; i < b; ++i) {
    const float* src = interleaved + 2 * i * n;
    float* dst_re = planar + 2 * i * n;
    float* dst_im = dst_re + n;
    for (int64_t j = 0; j < n; ++j) {
      dst_re[j] = src[2 * j];
      dst_im[j] = src[2 * j + 1];
    }
  }
}

// Inverse: (B, 2, ...) planar -> (B, ...) interleaved complex64.
void ri_to_complex(const float* planar, float* interleaved, int64_t b, int64_t n) {
  for (int64_t i = 0; i < b; ++i) {
    float* dst = interleaved + 2 * i * n;
    const float* src_re = planar + 2 * i * n;
    const float* src_im = src_re + n;
    for (int64_t j = 0; j < n; ++j) {
      dst[2 * j] = src_re[j];
      dst[2 * j + 1] = src_im[j];
    }
  }
}

// Threaded ri_to_complex: the serving result-scatter path merges whole output
// batches ((B, 2, grid) -> (B, grid) complex64); splitting over problems
// parallelizes the interleave the same way assemble_batch_ri parallelizes the
// deinterleave on the input side.
void ri_to_complex_mt(const float* planar, float* interleaved, int64_t b, int64_t n,
                      int32_t n_threads) {
  n_threads = std::max<int32_t>(1, std::min<int32_t>(n_threads, (int32_t)b));
  if (n_threads == 1) return ri_to_complex(planar, interleaved, b, n);
  std::vector<std::thread> ts;
  ts.reserve(n_threads);
  for (int32_t t = 0; t < n_threads; ++t) {
    ts.emplace_back([=]() {
      for (int64_t i = t; i < b; i += n_threads) {
        float* dst = interleaved + 2 * i * n;
        const float* src_re = planar + 2 * i * n;
        const float* src_im = src_re + n;
        for (int64_t j = 0; j < n; ++j) {
          dst[2 * j] = src_re[j];
          dst[2 * j + 1] = src_im[j];
        }
      }
    });
  }
  for (auto& th : ts) th.join();
}

}  // extern "C"
