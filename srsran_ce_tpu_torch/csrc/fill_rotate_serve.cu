// K2: serve-layout grid fill for Hopper (sm_90a), f32.
//
// Replaces srsran_ce_tpu/ops/pallas/kernels.py:fused_fill_rotate_serve
// (_fill_rotate_serve_kernel3 / _fill_rotate_serve_kernel). See
// srsran_ce_tpu_torch/ops/kernels/fill_rotate_serve.py for the plain PyTorch
// version and the design note.
//
//   out[b, 0, l, y, t] = fr * rot_r[b, y] - fi * rot_i[b, y]
//   out[b, 1, l, y, t] = fr * rot_i[b, y] + fi * rot_r[b, y]
//   with (fr, fi)[b, l, t] = sum_k h[b, (0, 1), l, k] * W[c(l), k, t]
//
// Layouts (row-major, contiguous): h (B, 2, nL, n_re), W (n_cdm, n_re, n_sc),
// rot (B, 2, n_sym), out (B, 2, nL, n_sym, n_sc).
//
// One tiled product per layer chunk i (layers l0..l0+nl of CDM group c): its
// rows are (problem, layer, ri), m = (b * nl + j) * 2 + ri, so that a (re, im)
// pair never leaves a tile. Output tiles of kTM rows x kTN subcarriers, the
// product of fill_common.cuh (the ring, the 8 x 4 register tile, the K split
// over a cluster of KS blocks, the persistent tile walk). The partial tile goes
// to shared memory; block r of the cluster sums its 1/KS of the tile's pairs
// over the cluster's partials in rank order (distributed shared memory) and
// writes the n_sym rotated symbols as 16-byte streaming stores. make_plan
// (fill_rotate_serve.launch_plan mirrors it) splits K only where the tiles are
// fewer than the SMs.

#include "fill_common.cuh"

namespace {

using namespace fill;

constexpr int kSmem = 4 * (kRingFloats > kTM * kTN ? kRingFloats : kTM * kTN);

struct Plan {
  int KS, tiles, clusters, blocks, smem;
  int tile0[kMaxChunks + 1];  // first tile of each chunk
  int mt[kMaxChunks];         // row tiles of each chunk
};

// Tiles of every chunk, then split_k.
int make_plan(Plan* p, const ChunkTab& tab, int B, int n_re, int n_sc, int n_sm) {
  if (B < 1 || n_re < 1 || n_sc < 1 || n_sm < 1 || tab.n < 1 || tab.n > kMaxChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = (n_sc + kTN - 1) / kTN;
  p->tiles = 0;
  for (int i = 0; i < tab.n; ++i) {
    p->tile0[i] = p->tiles;
    p->mt[i] = static_cast<int>((2LL * B * tab.nl[i] + kTM - 1) / kTM);
    p->tiles += p->mt[i] * nt;
  }
  p->tile0[tab.n] = p->tiles;
  const Split sp = split_k(p->tiles, n_re, n_sm);
  p->KS = sp.KS;
  p->clusters = sp.clusters;
  p->blocks = sp.blocks;
  p->smem = kSmem;
  return 0;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM) fill_rotate_serve_kernel(
    const float* __restrict__ h, const float* __restrict__ w, const float* __restrict__ rot,
    float* __restrict__ out, int B, int nL, int n_re, int n_sc, int n_sym, ChunkTab tab,
    Plan p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int KS = p.KS, rank = static_cast<int>(cluster.block_rank());
  const int ncl = gridDim.x / KS;
  const int tid = threadIdx.x, ry = tid / (kTN / 4), cx = tid % (kTN / 4);
  const int nk = (n_re + kKT - 1) / kKT, kc = (nk + KS - 1) / KS;
  const int ks0 = min(rank * kc, nk), ks1 = min(ks0 + kc, nk);
  const bool vec = (n_sc & 3) == 0;
  const int pairs = (kTM / 2 + KS - 1) / KS;  // pairs of a tile this block writes
  const size_t plane = static_cast<size_t>(n_sym) * n_sc;

  for (int tile = blockIdx.x / KS; tile < p.tiles; tile += ncl) {
    int g = 0;
    while (tile >= p.tile0[g + 1]) ++g;
    const int local = tile - p.tile0[g];
    const int m0 = (local % p.mt[g]) * kTM, n0 = (local / p.mt[g]) * kTN;
    const int nl = tab.nl[g], l0 = tab.l0[g], rows_g = 2 * B * nl;

    // this thread's A row: row m0 + a_row() of the chunk
    const int arow = m0 + a_row();
    const float* hrow = nullptr;
    if (arow < rows_g) {
      const int q = arow >> 1, b = q / nl;
      hrow = h + ((static_cast<size_t>(b) * 2 + (arow & 1)) * nL + l0 + q - b * nl) * n_re;
    }
    float acc[8][4];
    tile_product(acc, smem, hrow, w + static_cast<size_t>(tab.c[g]) * n_re * n_sc, n_re, n_sc,
                 n0, ks0, ks1, m0 + ry * 8 < rows_g);

    // the partial tile (kTM, kTN) over the ring's memory (no copy is in flight)
    float* ptile = smem;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float4*>(ptile + (ry * 8 + i) * kTN + cx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    cluster.sync();

    // this block's pairs: summed over the cluster in rank order, rotated, stored
    for (int e = tid; e < pairs * (kTN / 4); e += kThreads) {
      const int q = rank * pairs + e / (kTN / 4), c4 = e % (kTN / 4);
      const int row = m0 + 2 * q, col = n0 + 4 * c4;
      if (q >= kTM / 2 || row >= rows_g || col >= n_sc) continue;
      float4 fr, fi;
      cluster_sum_pair(cluster, ptile, 2 * q * kTN + 4 * c4, kTN, KS, fr, fi);
      const int gq = row >> 1, b = gq / nl, l = l0 + gq - b * nl;
      const float* rb = rot + static_cast<size_t>(b) * 2 * n_sym;
      float* o_r = out + ((static_cast<size_t>(b) * 2 + 0) * nL + l) * plane + col;
      float* o_i = out + ((static_cast<size_t>(b) * 2 + 1) * nL + l) * plane + col;
      for (int y = 0; y < n_sym; ++y) {
        const float rr = __ldg(rb + y), ri = __ldg(rb + n_sym + y);
        const float4 vr = make_float4(fr.x * rr - fi.x * ri, fr.y * rr - fi.y * ri,
                                      fr.z * rr - fi.z * ri, fr.w * rr - fi.w * ri);
        const float4 vi = make_float4(fr.x * ri + fi.x * rr, fr.y * ri + fi.y * rr,
                                      fr.z * ri + fi.z * rr, fr.w * ri + fi.w * rr);
        float* dr = o_r + static_cast<size_t>(y) * n_sc;
        float* di = o_i + static_cast<size_t>(y) * n_sc;
        if (vec) {
          __stcs(reinterpret_cast<float4*>(dr), vr);
          __stcs(reinterpret_cast<float4*>(di), vi);
        } else {
          const float xr[4] = {vr.x, vr.y, vr.z, vr.w}, xi[4] = {vi.x, vi.y, vi.z, vi.w};
          for (int t = 0; t < 4 && col + t < n_sc; ++t) {
            __stcs(dr + t, xr[t]);
            __stcs(di + t, xi[t]);
          }
        }
      }
    }
    cluster.sync();  // every partial read before the next tile's ring overwrites it
  }
}

}  // namespace

// out[0..5] = KS, tiles, clusters, blocks, smem of a launch.
extern "C" int srs_fill_rotate_serve_plan(long long* out, int B, int nL, int n_re, int n_sc,
                                          const ChunkTab* tab, int n_sm) {
  Plan p;
  if (check_tab(tab, nL) != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bad = make_plan(&p, *tab, B, n_re, n_sc, n_sm);
  if (bad != 0) return bad;
  const long long v[5] = {p.KS, p.tiles, p.clusters, p.blocks, p.smem};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}

extern "C" int srs_fill_rotate_serve_f32(const float* h, const float* w,
                                         const float* rot, float* out, int B,
                                         int nL, int n_re, int n_sc, int n_sym,
                                         const ChunkTab* tab, void* stream) {
  if (B < 1 || n_sym < 1 || n_sym > kMaxSym || check_tab(tab, nL) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int n_sm = 0;
  int bad = sm_count(&n_sm);
  if (bad != 0) return bad;
  Plan p;
  bad = make_plan(&p, *tab, B, n_re, n_sc, n_sm);
  if (bad != 0) return bad;
  cudaError_t e = cudaFuncSetAttribute(fill_rotate_serve_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.KS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fill_rotate_serve_kernel, h, w, rot, out, B, nL, n_re, n_sc,
                         n_sym, *tab, p);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
