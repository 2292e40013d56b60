// Shared device code of the QC-LDPC min-sum kernels for Hopper (sm_90a):
// K4 (ldpc.cu) and K3 (ldpc_stream.cu). See
// srsran_ce_tpu_torch/ops/kernels/ldpc.py for the plain PyTorch versions and
// the design note.
//
// One thread block per codeword. The posterior L (n = nb * z floats) lives in
// dynamic shared memory; the check-to-variable messages c2v (n_edges x z, of
// message type M: float, or __nv_bfloat16 for K3) in a global scratch, one
// slice per block. Edge e is slot t of check row i on variable block j with
// shift s (edges row-major, as LdpcPlan.edges): check lane a of edge e reads
// variable bit j*z + (a + s) mod z, and its message goes back to that bit.
//
// Arithmetic: every add, subtract and product is __fadd_rn / __fsub_rn /
// __fmul_rn (never contracted into an FMA), in the order of the plain
// version, so the kernels are bit-identical to it in float32. The two-min
// fold keeps argmin's first-minimum tie: strict <, m2 = less ? m1 : min(m2, m).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ldpc {

constexpr int kThreads = 512;
constexpr float kBig = 1e30f;  // the JAX package's mask value (never wins a min)
constexpr int kMaxDegree = 32;  // a row's sign bits fit one 32-bit word
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory of one block (227 KB)

// Views into one int32 table: [edge_var | edge_shift | row_ptr | col_ptr | col_edge].
struct Wiring {
  const int* edge_var;    // (n_edges) variable block of each edge
  const int* edge_shift;  // (n_edges) shift mod z
  const int* row_ptr;     // (mb + 1) edges of row i: row_ptr[i] .. row_ptr[i+1]
  const int* col_ptr;     // (nb + 1) col_edge[col_ptr[j] .. col_ptr[j+1]]
  const int* col_edge;    // (n_edges) edges of each column in edge order
  int n_edges, mb, nb, z;
};

inline Wiring make_wiring(const int* tbl, int n_edges, int mb, int nb, int z) {
  Wiring w;
  w.edge_var = tbl;
  w.edge_shift = tbl + n_edges;
  w.row_ptr = tbl + 2 * n_edges;
  w.col_ptr = w.row_ptr + mb + 1;
  w.col_edge = w.col_ptr + nb + 1;
  w.n_edges = n_edges;
  w.mb = mb;
  w.nb = nb;
  w.z = z;
  return w;
}

__device__ __forceinline__ float load_msg(const float* p) { return *p; }
__device__ __forceinline__ float load_msg(const __nv_bfloat16* p) { return __bfloat162float(*p); }
// store v as M; returns the value as stored (the bfloat16 round trip)
__device__ __forceinline__ float store_msg(float* p, float v) {
  *p = v;
  return v;
}
__device__ __forceinline__ float store_msg(__nv_bfloat16* p, float v) {
  const __nv_bfloat16 b = __float2bfloat16_rn(v);
  *p = b;
  return __bfloat162float(b);
}

// Check lane a of row i: v_t = L[bit of slot t] - c2v_old[t], the row's two
// minima and sign parity, then each slot's new message
//   upd_t = +-(norm * (t == argmin ? min2 : min1)),  sign = parity ^ sign(v_t),
// stored in place of c2v_old[t]. With `apply` (a row of its own) the change
// stored - old is added to L at once: each L element of the row is read and
// written by exactly one lane (one shift per (row, column)). Else, with
// `delta`, the change goes to delta[t * z + a] for a later apply.
template <typename M>
__device__ __forceinline__ void check_lane(float* L, M* c2v, float* delta, bool apply,
                                           const Wiring& w, int i, int a, float norm) {
  const int z = w.z;
  const int e0 = w.row_ptr[i];
  const int deg = w.row_ptr[i + 1] - e0;
  float m1 = 0.f, m2 = kBig;
  int i1 = 0;
  unsigned negs = 0u;
  for (int t = 0; t < deg; ++t) {
    const int e = e0 + t;
    int q = a + w.edge_shift[e];
    if (q >= z) q -= z;
    const float v = __fsub_rn(L[w.edge_var[e] * z + q], load_msg(c2v + static_cast<size_t>(e) * z + a));
    const float m = fabsf(v);
    negs |= static_cast<unsigned>(v < 0.f) << t;
    if (t == 0) {
      m1 = m;
    } else {
      const bool less = m < m1;
      m2 = less ? m1 : fminf(m2, m);
      i1 = less ? t : i1;
      m1 = less ? m : m1;
    }
  }
  const unsigned par = static_cast<unsigned>(__popc(negs)) & 1u;
  for (int t = 0; t < deg; ++t) {
    const int e = e0 + t;
    const float r = __fmul_rn(norm, t == i1 ? m2 : m1);
    const float upd = (((negs >> t) ^ par) & 1u) ? -r : r;
    M* slot = c2v + static_cast<size_t>(e) * z + a;
    const float old = load_msg(slot);
    const float stored = store_msg(slot, upd);
    if (apply) {
      int q = a + w.edge_shift[e];
      if (q >= z) q -= z;
      float* l = L + w.edge_var[e] * z + q;
      *l = __fadd_rn(*l, __fsub_rn(stored, old));
    } else if (delta != nullptr) {
      delta[t * z + a] = __fsub_rn(stored, old);
    }
  }
}

// All n_iters layered sweeps of one codeword (block): rows in groups of
// `group` sharing one L snapshot, each group's messages first (lanes over
// rows x z), then its rows applied in order, one __syncthreads() apart.
// A group of one row applies in the same pass. delta_all: (B, group*d*z)
// floats, needed when group > 1.
template <typename M>
__global__ void __launch_bounds__(kThreads) layered_kernel(
    const float* __restrict__ ch, float* __restrict__ out, M* __restrict__ c2v_all,
    float* __restrict__ delta_all, Wiring w, int d, int n_iters, float norm, int group) {
  extern __shared__ float L[];
  const int z = w.z;
  const int n = w.nb * z;
  const size_t b = blockIdx.x;
  const size_t msgs = static_cast<size_t>(w.n_edges) * z;
  M* c2v = c2v_all + b * msgs;
  float* delta = delta_all != nullptr ? delta_all + b * static_cast<size_t>(group) * d * z : nullptr;
  for (int p = threadIdx.x; p < n; p += blockDim.x) L[p] = ch[b * n + p];
  for (size_t k = threadIdx.x; k < msgs; k += blockDim.x) store_msg(c2v + k, 0.f);
  __syncthreads();
  for (int it = 0; it < n_iters; ++it) {
    for (int g0 = 0; g0 < w.mb; g0 += group) {
      const int rows = min(group, w.mb - g0);
      if (rows == 1) {
        for (int a = threadIdx.x; a < z; a += blockDim.x)
          check_lane(L, c2v, nullptr, true, w, g0, a, norm);
        __syncthreads();
        continue;
      }
      for (int lane = threadIdx.x; lane < rows * z; lane += blockDim.x) {
        const int gi = lane / z;
        const int a = lane - gi * z;
        check_lane(L, c2v, delta + static_cast<size_t>(gi) * d * z, false, w, g0 + gi, a, norm);
      }
      __syncthreads();
      for (int gi = 0; gi < rows; ++gi) {
        const int e0 = w.row_ptr[g0 + gi];
        const int deg = w.row_ptr[g0 + gi + 1] - e0;
        const float* dg = delta + static_cast<size_t>(gi) * d * z;
        for (int lane = threadIdx.x; lane < deg * z; lane += blockDim.x) {
          const int t = lane / z;
          const int a = lane - t * z;
          int q = a + w.edge_shift[e0 + t];
          if (q >= z) q -= z;
          float* l = L + w.edge_var[e0 + t] * z + q;
          *l = __fadd_rn(*l, dg[lane]);
        }
        __syncthreads();
      }
    }
  }
  for (int p = threadIdx.x; p < n; p += blockDim.x) out[b * n + p] = L[p];
}

// Validate the launch arguments common to both kernels; 0 or a CUDA error code.
inline int check_launch(int batch, int n_edges, int mb, int nb, int z, int d, int n_iters,
                        int group, const void* tbl) {
  if (batch < 1 || n_edges < 1 || mb < 1 || nb < 1 || z < 1 || d < 1 || d > kMaxDegree ||
      n_iters < 0 || group < 1 || group > mb || tbl == nullptr ||
      static_cast<size_t>(nb) * z * sizeof(float) > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <typename M>
int launch_layered(const float* ch, float* out, M* c2v, float* delta, const Wiring& w, int batch,
                   int d, int n_iters, float norm, int group, cudaStream_t stream) {
  if (group > 1 && delta == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(w.nb) * w.z * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      layered_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  layered_kernel<M><<<batch, kThreads, smem, stream>>>(ch, out, c2v, delta, w, d, n_iters, norm,
                                                        group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ldpc
