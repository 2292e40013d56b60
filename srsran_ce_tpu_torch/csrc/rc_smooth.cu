// K5: K-tap valid FIR along the pilot axis for Hopper (sm_90a), f32.
//
// Replaces srsran_ce_tpu/ops/pallas/kernels.py:rc_smooth (_rc_smooth_kernel).
// See srsran_ce_tpu_torch/ops/kernels/rc_smooth.py for the plain PyTorch
// version and the design note.
//
//   out[r, n] = sum_k taps[K-1-k] * x[r, n+k],  k = 0..K-1   (valid convolution)
//
// Layouts (row-major, contiguous): x (rows, n_ext), out (rows, n_out) with
// rows = B * C and n_out = n_ext - K + 1. One thread per output element; the
// taps travel by value in the launch's argument block, the same for every
// thread, so they sit in the constant bank.

#include <cuda_runtime.h>

constexpr int kMaxTaps = 32;

// The taps, reversed into convolution order by the host. Outside the
// anonymous namespace: the exported C entry takes it by pointer.
struct RcTaps {
  int k;
  float t[kMaxTaps];
};

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) rc_smooth_kernel(
    const float* __restrict__ x, float* __restrict__ out, long long rows,
    int n_ext, int n_out, RcTaps taps) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= rows * n_out) return;
  const long long r = i / n_out;
  const int n = static_cast<int>(i - r * n_out);
  const float* xr = x + r * n_ext + n;
  // the TPU kernel's order: acc = taps[K-1] * x[n], then += taps[K-1-k] * x[n+k]
  float acc = taps.t[0] * xr[0];
  for (int k = 1; k < taps.k; ++k) acc = fmaf(taps.t[k], xr[k], acc);
  out[i] = acc;
}

}  // namespace

extern "C" int srs_rc_smooth_f32(const float* x, float* out, long long rows,
                                 int n_ext, const RcTaps* taps, void* stream) {
  if (taps == nullptr || taps->k < 1 || taps->k > kMaxTaps || n_ext < taps->k ||
      rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_out = n_ext - taps->k + 1;
  const long long total = rows * n_out;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  rc_smooth_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, rows, n_ext, n_out, *taps);
  return static_cast<int>(cudaGetLastError());
}
