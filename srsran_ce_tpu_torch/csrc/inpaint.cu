// K7: partial-convolution inpainting stack for Hopper (sm_90a), f32.
//
// Replaces srsran_ce_tpu/ops/pallas/kernels.py:inpaint_stack (_inpaint_kernel).
// See srsran_ce_tpu_torch/ops/kernels/inpaint.py for the plain PyTorch
// version and the design note.
//
// Per row (one problem's ri channel, n values):
//   transient t:  x = known ? x0 : conv3(x * m_t) * inv_t
//   steady (x `steady`): x = known ? x0 : conv3(x) * inv_c
//   low-pass:     out = known ? x0 : conv3(conv3(x))
// conv3(v)[i] = 0.25 * v[i-1] + 0.5 * v[i] + 0.25 * v[i+1], summed in that
// order, reflect-padded (v[-1] = v[1], v[n] = v[n-2]).
//
// Layouts (row-major, contiguous): x, out (rows, n); known (n,) 0/1;
// trans (n_transient, 2, n), row t holding (m_t, inv_t). One block per row;
// the row and the next pass live in shared memory (2 n floats) beside the
// known mask (n bytes), each pass one __syncthreads() apart. At known
// positions the buffer keeps x0 through every pinned pass, so x0 is not
// stored apart.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int reflect_left(int i) { return i == 0 ? 1 : i - 1; }
__device__ __forceinline__ int reflect_right(int i, int n) { return i == n - 1 ? n - 2 : i + 1; }

// 0.25 * l + 0.5 * c + 0.25 * r with every product and sum rounded apart
// (the products by powers of two are exact, so an FMA would round the same;
// the intrinsics keep the order explicit)
__device__ __forceinline__ float conv3(float l, float c, float r) {
  return __fadd_rn(__fadd_rn(__fmul_rn(0.25f, l), __fmul_rn(0.5f, c)), __fmul_rn(0.25f, r));
}

__global__ void __launch_bounds__(kThreads) inpaint_kernel(
    const float* __restrict__ x, const float* __restrict__ known,
    const float* __restrict__ trans, int n, int n_transient, int steady, float inv_c,
    float* __restrict__ out) {
  extern __shared__ float smem[];
  float* a = smem;
  float* b = smem + n;
  unsigned char* kn = reinterpret_cast<unsigned char*>(smem + 2 * n);
  const long long row = blockIdx.x;
  const float* xr = x + row * n;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    a[i] = xr[i];
    kn[i] = known[i] > 0.5f;
  }
  __syncthreads();
  for (int t = 0; t < n_transient; ++t) {
    const float* m = trans + static_cast<long long>(t) * 2 * n;
    const float* inv = m + n;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      if (kn[i]) {
        b[i] = a[i];
      } else {
        const int l = reflect_left(i), r = reflect_right(i, n);
        const float s = conv3(__fmul_rn(a[l], m[l]), __fmul_rn(a[i], m[i]), __fmul_rn(a[r], m[r]));
        b[i] = __fmul_rn(s, inv[i]);
      }
    }
    __syncthreads();
    float* tmp = a; a = b; b = tmp;
  }
  for (int t = 0; t < steady; ++t) {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      b[i] = kn[i] ? a[i]
                   : __fmul_rn(conv3(a[reflect_left(i)], a[i], a[reflect_right(i, n)]), inv_c);
    }
    __syncthreads();
    float* tmp = a; a = b; b = tmp;
  }
  // the 2-pass low-pass: the first pass unpinned, the second written out pinned
  for (int i = threadIdx.x; i < n; i += kThreads)
    b[i] = conv3(a[reflect_left(i)], a[i], a[reflect_right(i, n)]);
  __syncthreads();
  float* o = out + row * n;
  for (int i = threadIdx.x; i < n; i += kThreads)
    o[i] = kn[i] ? a[i] : conv3(b[reflect_left(i)], b[i], b[reflect_right(i, n)]);
}

}  // namespace

extern "C" int srs_inpaint_smem_bytes(int n) {
  return 2 * n * static_cast<int>(sizeof(float)) + ((n + 3) / 4) * 4;
}

extern "C" int srs_inpaint_f32(const float* x, const float* known, const float* trans,
                               long long rows, int n, int n_transient, int steady,
                               float inv_c, float* out, void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || n < 3 || n_transient < 0 || steady < 0 ||
      (n_transient > 0 && trans == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = srs_inpaint_smem_bytes(n);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        inpaint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  inpaint_kernel<<<static_cast<unsigned>(rows), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, known, trans, n, n_transient, steady, inv_c, out);
  return static_cast<int>(cudaGetLastError());
}
