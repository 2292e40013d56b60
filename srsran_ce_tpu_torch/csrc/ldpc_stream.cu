// K3: row-streamed layered normalized min-sum QC-LDPC decoding for Hopper
// (sm_90a), f32 LLRs and posterior, messages stored in f32 or bf16.
//
// Replaces srsran_ce_tpu/ops/pallas/kernels.py:ldpc_stream_posterior
// (_ldpc_stream_kernel). See srsran_ce_tpu_torch/ops/kernels/ldpc_stream.py
// for the plain PyTorch version and the design note, and ldpc_common.cuh for
// the layout and the layered sweep. A bf16 message is
// __float2bfloat16_rn(update), and L takes the round-tripped value minus the
// old one, so it stays consistent with what is stored.

#include "ldpc_common.cuh"

extern "C" int srs_ldpc_stream_posterior(const float* ch, float* out, void* c2v, float* delta,
                                         const int* tbl, int batch, int n_edges, int mb, int nb,
                                         int z, int d, float norm, int n_iters, int group,
                                         int c2v_bf16, void* stream) {
  const int bad = ldpc::check_launch(batch, n_edges, mb, nb, z, d, n_iters, group, tbl);
  if (bad != 0) return bad;
  const ldpc::Wiring w = ldpc::make_wiring(tbl, n_edges, mb, nb, z);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c2v_bf16)
    return ldpc::launch_layered(ch, out, static_cast<__nv_bfloat16*>(c2v), delta, w, batch, d,
                                n_iters, norm, group, s);
  return ldpc::launch_layered(ch, out, static_cast<float*>(c2v), delta, w, batch, d, n_iters, norm,
                              group, s);
}
