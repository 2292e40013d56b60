// K4: all sweeps of flooding or (grouped) layered normalized min-sum QC-LDPC
// decoding for Hopper (sm_90a), f32.
//
// Replaces srsran_ce_tpu/ops/pallas/kernels.py:ldpc_posterior (_ldpc_kernel).
// See srsran_ce_tpu_torch/ops/kernels/ldpc.py for the plain PyTorch version
// and the design note, and ldpc_common.cuh for the records, the routes and
// the layered sweep (shared with K3).
//
// Flooding, per codeword, per sweep:
//   L[j*z + p] = ch[j*z + p] + the sum over column j's edges (row i, slot t,
//                shift s), in edge order, of row i's message t at lane
//                (p - s) mod z, rebuilt from its record (one thread a bit);
//   then every check lane (i, a) folds its row from L and rewrites its record
//   in place. After the last sweep the same sum is the posterior, written to
//   out. No atomics: the sum order is the plain version's.
// On the chip route the LLRs, L and every record sit in shared memory (BG2
// Z=208: 43,264 + 43,264 + 104,832 B); on the stream route the records and
// the LLRs are read from device memory (L2).

#include "ldpc_common.cuh"

namespace {

using ldpc::Args;
using ldpc::Rec;

// For every bit of the block's codewords: ch + the column's messages rolled
// onto the bit, in edge order, into L (or, `to_out`, the posterior). `fresh`:
// no record written yet, every message +0.0 (still added: ch = -0.0 becomes
// +0.0, as in the plain version).
template <bool STREAM>
__device__ __forceinline__ void accumulate(unsigned char* smem, const Args& a, const int* col_ptr,
                                           const unsigned* colw, int ncw, int b0, long long lb,
                                           bool fresh, bool to_out) {
  const int z = a.z;
  const int n = a.nb * z;
  ldpc::Strider at(z, threadIdx.x, blockDim.x);  // (codeword * nb + column, lane)
  for (int k = threadIdx.x; k < ncw * n; k += blockDim.x, at.next()) {
    const int c = ncw == 1 ? 0 : at.row / a.nb;
    const int j = at.row - c * a.nb;
    const int lane = at.lane;
    const int p = j * z + lane;
    unsigned char* reg = ldpc::region(smem, a, c);
    float acc = STREAM ? a.ch[static_cast<size_t>(b0) * n + k]
                       : reinterpret_cast<const float*>(reg + lb)[p];
    const unsigned char* recs =
        STREAM ? a.rec + static_cast<size_t>(b0 + c) * a.p.scratch : reg + 2 * lb;
#pragma unroll 4
    for (int q = col_ptr[j]; q < col_ptr[j + 1]; ++q) {
      const unsigned cw = colw[q];
      int src = lane - static_cast<int>(cw & 0xffffu);
      if (src < 0) src += z;
      const float m =
          fresh ? 0.f
                : ldpc::msg(ldpc::load_rec<float>(recs + static_cast<size_t>(cw >> 21) * a.p.stride,
                                                  a.p.mag_bytes, src),
                            static_cast<int>((cw >> 16) & 31u));
      acc = __fadd_rn(acc, m);
    }
    if (to_out)
      a.out[static_cast<size_t>(b0) * n + k] = acc;
    else
      reinterpret_cast<float*>(reg)[p] = acc;
  }
}

// All n_iters flooding sweeps of the block's codewords, then the posterior.
template <int DMAX, bool STREAM>
__global__ void __launch_bounds__(ldpc::kMaxThreads, 1) flooding_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int z = a.z;
  const int n = a.nb * z;
  const ldpc::SmemWiring wr(smem, a.n_edges, a.mb);
  const int* col_ptr = wr.col_ptr;
  const unsigned* colw = reinterpret_cast<const unsigned*>(col_ptr + a.nb + 1);
  ldpc::load_wiring(smem, a.tbl, a.n_edges, a.mb, a.nb, z, true);
  const int b0 = blockIdx.x * a.p.cpb;
  const int ncw = min(a.p.cpb, a.batch - b0);
  const long long lb = ldpc::pad16(4LL * n);  // region: L, then (chip) the LLRs and the records
  if (!STREAM) {
    for (int k = threadIdx.x; k < ncw * n; k += blockDim.x) {
      const int c = ncw == 1 ? 0 : k / n;
      reinterpret_cast<float*>(ldpc::region(smem, a, c) + lb)[k - c * n] =
          a.ch[static_cast<size_t>(b0) * n + k];
    }
  }
  __syncthreads();
  for (int it = 0; it < a.n_iters; ++it) {
    accumulate<STREAM>(smem, a, col_ptr, colw, ncw, b0, lb, it == 0, false);
    __syncthreads();
    ldpc::Strider at(z, threadIdx.x, blockDim.x);  // (codeword * mb + row, lane)
    for (int k = threadIdx.x; k < ncw * a.mb * z; k += blockDim.x, at.next()) {
      const int c = ncw == 1 ? 0 : at.row / a.mb;
      const int i = at.row - c * a.mb;
      const int lane = at.lane;
      unsigned char* reg = ldpc::region(smem, a, c);
      unsigned char* row = (STREAM ? a.rec + static_cast<size_t>(b0 + c) * a.p.scratch : reg + 2 * lb) +
                           static_cast<size_t>(i) * a.p.stride;
      const Rec old = it == 0 ? Rec{0.f, 0.f, 0u} : ldpc::load_rec<float>(row, a.p.mag_bytes, lane);
      int deg;
      const unsigned* ew = wr.row(i, deg);
      const Rec nw = ldpc::check_lane<float, DMAX>(reinterpret_cast<float*>(reg), ew, deg, z, lane,
                                                   a.norm, old, false);
      ldpc::store_rec<float>(row, a.p.mag_bytes, lane, nw);
    }
    __syncthreads();
  }
  accumulate<STREAM>(smem, a, col_ptr, colw, ncw, b0, lb, a.n_iters == 0, true);
}

template <int DMAX>
int launch_flooding(const Args& a, cudaStream_t stream) {
  if (a.p.route == ldpc::kStream) return ldpc::launch_kernel(flooding_kernel<DMAX, true>, a, stream);
  return ldpc::launch_kernel(flooding_kernel<DMAX, false>, a, stream);
}

}  // namespace

// `c2v`: the stream route's record scratch (B x scratch bytes, see
// srs_ldpc_plan), unused on the chip route; `delta` is unused (deltas are
// rebuilt from records) and stays for the argument list.
extern "C" int srs_ldpc_posterior_f32(const float* ch, float* out, float* c2v, float* delta,
                                      const int* tbl, int batch, int n_edges, int mb, int nb,
                                      int z, int d, int n_iters, float norm, int layered,
                                      int group, void* stream) {
  (void)delta;
  Args a;
  const int bad = ldpc::make_args(&a, ch, out, c2v, tbl, batch, n_edges, mb, nb, z, d, n_iters,
                                  norm, layered != 0, group, 4);
  if (bad != 0) return bad;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layered) return ldpc::launch_layered<float>(a, d, s);
  if (d <= 8) return launch_flooding<8>(a, s);
  if (d <= 16) return launch_flooding<16>(a, s);
  return launch_flooding<ldpc::kMaxDegree>(a, s);
}

// out[0..6] = route, cpb, threads, blocks, smem, scratch, per_cw of a launch.
extern "C" int srs_ldpc_plan(long long* out, int batch, int n_edges, int mb, int nb, int z,
                             int msg_bytes, int layered, int group, int n_sm) {
  return ldpc::plan_numbers(out, batch, n_edges, mb, nb, z, msg_bytes, layered, group, n_sm);
}
