// K5: K-tap valid FIR along the pilot axis for Hopper (sm_90a), f32.
//
// Replaces srsran_ce_tpu/ops/pallas/kernels.py:rc_smooth (_rc_smooth_kernel).
// See srsran_ce_tpu_torch/ops/kernels/rc_smooth.py for the plain PyTorch
// version and the design note.
//
//   out[r, n] = sum_k taps[K-1-k] * x[r, n+k],  k = 0..K-1   (valid convolution)
//
// Layouts (row-major, contiguous): x (rows, n_ext), out (rows, n_out) with
// rows = B * C and n_out = n_ext - K + 1. One block of T threads per tile of
// 4 T outputs of a row (T a multiple of 32 chosen by the host to cover a
// c2 row in one tile): the tile's inputs plus their K - 1 halo are staged in
// shared memory by coalesced scalar loads (rows of 650 floats are not
// 16-byte aligned, the tile in shared memory is), then thread t computes the
// 4 consecutive outputs 4t .. 4t + 3 from a register window of its K + 3
// inputs, read as 16-byte vectors (consecutive threads, consecutive vectors:
// no bank conflicts), and stores them as one vector where the output row
// allows. The taps travel by value in the launch's argument block (the
// constant bank), read at compile-time indices.

#include <cuda_runtime.h>

constexpr int kMaxTaps = 32;

// The taps, reversed into convolution order by the host. Outside the
// anonymous namespace: the exported C entry takes it by pointer.
struct RcTaps {
  int k;
  float t[kMaxTaps];
};

namespace {

constexpr int kMaxThreads = 256;
constexpr int kPerThread = 4;

__global__ void __launch_bounds__(kMaxThreads) rc_smooth_kernel(
    const float* __restrict__ x, float* __restrict__ out, int tiles, int n_ext, int n_out,
    RcTaps taps) {
  constexpr int kWin = (kPerThread + kMaxTaps - 1 + 3) / 4;  // float4s of the widest window
  __shared__ float4 s4[kMaxThreads + kWin];
  float* s = reinterpret_cast<float*>(s4);
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const long long row = blockIdx.x / tiles;
  const int start = (blockIdx.x - static_cast<int>(row) * tiles) * kPerThread * T;
  const float* xr = x + row * n_ext + start;
  const int len = min(kPerThread * T + taps.k - 1, n_ext - start);
  for (int i = t; i < len; i += T) s[i] = xr[i];
  __syncthreads();
  // inputs 4t .. 4t + K + 2 (slots past the row are never used by a stored output)
  float w[4 * kWin];
#pragma unroll
  for (int q = 0; q < kWin; ++q) {
    if (4 * q < taps.k + kPerThread - 1) {
      const float4 v = s4[t + q];
      w[4 * q] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
  }
  // the TPU kernel's order: acc = taps[K-1] * x[n], then += taps[K-1-k] * x[n+k]
  float acc[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) acc[j] = taps.t[0] * w[j];
#pragma unroll
  for (int k = 1; k < kMaxTaps; ++k) {
    if (k < taps.k) {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) acc[j] = fmaf(taps.t[k], w[j + k], acc[j]);
    }
  }
  float* o = out + row * n_out + start + kPerThread * t;
  const int left = n_out - start - kPerThread * t;
  if (left >= kPerThread && (reinterpret_cast<unsigned long long>(o) & 15) == 0) {
    *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      if (j < left) o[j] = acc[j];
  }
}

}  // namespace

extern "C" int srs_rc_smooth_f32(const float* x, float* out, long long rows,
                                 int n_ext, const RcTaps* taps, void* stream) {
  if (taps == nullptr || taps->k < 1 || taps->k > kMaxTaps || n_ext < taps->k ||
      rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_out = n_ext - taps->k + 1;
  // threads: enough 4-output threads for the row, in whole warps, at most 256
  const int per_row = (n_out + kPerThread - 1) / kPerThread;
  const int threads = min(kMaxThreads, (per_row + 31) / 32 * 32);
  const int tiles = (n_out + kPerThread * threads - 1) / (kPerThread * threads);
  const long long blocks = rows * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rc_smooth_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(x, out, tiles, n_ext, n_out, *taps);
  return static_cast<int>(cudaGetLastError());
}
