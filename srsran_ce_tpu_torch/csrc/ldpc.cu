// K4: all sweeps of flooding or (grouped) layered normalized min-sum QC-LDPC
// decoding for Hopper (sm_90a), f32.
//
// Replaces srsran_ce_tpu/ops/pallas/kernels.py:ldpc_posterior (_ldpc_kernel).
// See srsran_ce_tpu_torch/ops/kernels/ldpc.py for the plain PyTorch version
// and the design note, and ldpc_common.cuh for the layout and the layered
// sweep (shared with K3).
//
// Flooding, per codeword (block), per sweep:
//   L[j*z + p] = ch[j*z + p] + sum over the column's edges e, in edge order,
//                of c2v[e][(p - s_e) mod z]     (one thread per variable bit)
//   then every check lane (i, a) folds its row from L and rewrites c2v[e][a];
// after the last sweep the same sum is the posterior. No atomics: the sum
// order is the plain version's.

#include "ldpc_common.cuh"

namespace {

using ldpc::Wiring;

// dst[p] = ch[p] + the column's messages rolled onto bit p, in edge order
__device__ __forceinline__ void accumulate(float* dst, const float* ch, const float* c2v,
                                           const Wiring& w) {
  const int z = w.z;
  const int n = w.nb * z;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const int j = p / z;
    const int a = p - j * z;
    float acc = ch[p];
    for (int k = w.col_ptr[j]; k < w.col_ptr[j + 1]; ++k) {
      const int e = w.col_edge[k];
      int src = a - w.edge_shift[e];
      if (src < 0) src += z;
      acc = __fadd_rn(acc, c2v[static_cast<size_t>(e) * z + src]);
    }
    dst[p] = acc;
  }
}

__global__ void __launch_bounds__(ldpc::kThreads) flooding_kernel(
    const float* __restrict__ ch, float* __restrict__ out, float* __restrict__ c2v_all, Wiring w,
    int n_iters, float norm) {
  extern __shared__ float L[];
  const int z = w.z;
  const size_t n = static_cast<size_t>(w.nb) * z;
  const size_t msgs = static_cast<size_t>(w.n_edges) * z;
  const size_t b = blockIdx.x;
  float* c2v = c2v_all + b * msgs;
  for (size_t k = threadIdx.x; k < msgs; k += blockDim.x) c2v[k] = 0.f;
  __syncthreads();
  for (int it = 0; it < n_iters; ++it) {
    accumulate(L, ch + b * n, c2v, w);
    __syncthreads();
    for (int lane = threadIdx.x; lane < w.mb * z; lane += blockDim.x) {
      const int i = lane / z;
      ldpc::check_lane(L, c2v, static_cast<float*>(nullptr), false, w, i, lane - i * z, norm);
    }
    __syncthreads();
  }
  accumulate(out + b * n, ch + b * n, c2v, w);
}

}  // namespace

extern "C" int srs_ldpc_posterior_f32(const float* ch, float* out, float* c2v, float* delta,
                                      const int* tbl, int batch, int n_edges, int mb, int nb,
                                      int z, int d, int n_iters, float norm, int layered,
                                      int group, void* stream) {
  const int bad = ldpc::check_launch(batch, n_edges, mb, nb, z, d, n_iters, group, tbl);
  if (bad != 0) return bad;
  const Wiring w = ldpc::make_wiring(tbl, n_edges, mb, nb, z);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layered) return ldpc::launch_layered(ch, out, c2v, delta, w, batch, d, n_iters, norm, group, s);
  const size_t smem = static_cast<size_t>(nb) * z * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      flooding_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flooding_kernel<<<batch, ldpc::kThreads, smem, s>>>(ch, out, c2v, w, n_iters, norm);
  return static_cast<int>(cudaGetLastError());
}
