// K3: row-streamed layered normalized min-sum QC-LDPC decoding for Hopper
// (sm_90a), f32 LLRs and posterior, messages stored in f32 or bf16.
//
// Replaces srsran_ce_tpu/ops/pallas/kernels.py:ldpc_stream_posterior
// (_ldpc_stream_kernel). See srsran_ce_tpu_torch/ops/kernels/ldpc_stream.py
// for the plain PyTorch version and the design note, and ldpc_common.cuh for
// the records, the routes and the layered sweep. A bf16 message is
// __float2bfloat16_rn(update), kept as a record's bf16 magnitudes and sign
// bits, and L takes the stored value minus the old one, so it stays
// consistent with what is stored. At NR BG1 Z=384 (the largest code block)
// L takes 104,448 B of shared memory and the records (141,312 B bf16,
// 211,968 B f32 per codeword) do not fit beside it: they stream from a
// global scratch, one 3,072 / 4,608 B row block at a time, a step ahead.

#include "ldpc_common.cuh"

// `c2v`: the stream route's record scratch (B x scratch bytes, see
// srs_ldpc_plan), unused on the chip route; `delta` is unused (deltas are
// rebuilt from records) and stays for the argument list.
extern "C" int srs_ldpc_stream_posterior(const float* ch, float* out, void* c2v, float* delta,
                                         const int* tbl, int batch, int n_edges, int mb, int nb,
                                         int z, int d, float norm, int n_iters, int group,
                                         int c2v_bf16, void* stream) {
  (void)delta;
  ldpc::Args a;
  const int bad = ldpc::make_args(&a, ch, out, c2v, tbl, batch, n_edges, mb, nb, z, d, n_iters,
                                  norm, true, group, c2v_bf16 ? 2 : 4);
  if (bad != 0) return bad;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c2v_bf16) return ldpc::launch_layered<__nv_bfloat16>(a, d, s);
  return ldpc::launch_layered<float>(a, d, s);
}

// out[0..6] = route, cpb, threads, blocks, smem, scratch, per_cw of a launch.
extern "C" int srs_ldpc_plan(long long* out, int batch, int n_edges, int mb, int nb, int z,
                             int msg_bytes, int layered, int group, int n_sm) {
  return ldpc::plan_numbers(out, batch, n_edges, mb, nb, z, msg_bytes, layered, group, n_sm);
}
