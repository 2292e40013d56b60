// K6: reference-layout grid fill for Hopper (sm_90a), f32.
//
// Replaces srsran_ce_tpu/ops/pallas/kernels.py:fused_fill_rotate
// (_fill_rotate_kernel). See srsran_ce_tpu_torch/ops/kernels/fill_rotate.py
// for the plain PyTorch version and the design note.
//
//   (fr, fi)[b, l, t] = sum_k h[b, (0, 1), l, k] * W[c(l), k, t]
//   out[b, 0, sc0 + t, sy0 + y, l] = fr * rot_r[b, y] - fi * rot_i[b, y]
//   out[b, 1, sc0 + t, sy0 + y, l] = fr * rot_i[b, y] + fi * rot_r[b, y]
//
// Layouts (row-major, contiguous): h (B, 2, nL, n_re), W (n_cdm, n_re, n_sc),
// rot (B, 2, n_alloc), out (B, 2, grid_sc, grid_sym, nL): the kernel writes the
// block [sc0, sc0 + n_sc) x [sy0, sy0 + n_alloc) x all layers of a grid that
// may be larger (the hop's slice of the zero grid) and leaves the rest alone.
//
// The product is K2's (fill_common.cuh). An output tile is P problems x kTN
// subcarriers x every layer: in this layout a (b, ri, sc) span is n_alloc x
// nL floats with the layer fastest, so a tile that held only one CDM group's
// layers would write every other few bytes of each span, and two tiles would
// share each 16-byte segment. So the tile runs the shared K loop once per
// chunk (a CDM group: layers l0..l0+nl of group c), over the rows (problem,
// layer of the chunk, ri), 2 P nl <= kTM of them, with the chunk's W, and
// parks each chunk's sums in shared memory (P x 2 x nL x kTN floats). After
// the last chunk, where K is split over a cluster of KS blocks, block r sums
// its share of the tile's problems over the cluster's partials in rank order
// into the ring's memory; then it writes each (b, ri, sc) span of its
// problems, rotated by rot[b, y], four floats a step (no divide in the walk;
// for nL = 4 or 8 one symbol's rotation a four): as 16-byte streaming stores
// where every span is 16-byte aligned (grid_sym * nL and sy0 * nL multiples
// of 4, as at c2), else 8- or 4-byte ones. make_plan
// (fill_rotate.launch_plan mirrors it) takes the largest P whose sums fit
// beside the ring at two blocks an SM.

#include "fill_common.cuh"

#include <cstdint>

namespace {

using namespace fill;

// Dynamic shared memory a block may take at kBlocksPerSM blocks an SM: an
// sm_90 SM has 233472 bytes, the runtime keeps 1024 of them for each block.
constexpr int kBlockSmem = 233472 / kBlocksPerSM - 1024;
constexpr int kMaxLayers = 8;

struct Plan {
  int P, ptiles, tiles, KS, clusters, blocks, smem;
};

// P = the problems of a tile: every chunk's 2 P nl rows in one product tile,
// the P x 2 x nL x kTN parked sums beside the ring within kBlockSmem, at most
// B; tiles of P problems x kTN subcarriers (problem tiles fastest), then
// K2's split_k.
int make_plan(Plan* p, const ChunkTab& tab, int B, int nL, int n_re, int n_sc, int n_sm) {
  if (B < 1 || nL < 1 || nL > kMaxLayers || n_re < 1 || n_sc < 1 || n_sm < 1 || tab.n < 1 ||
      tab.n > kMaxChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  int nl_max = 1;
  for (int i = 0; i < tab.n; ++i) nl_max = std::max(nl_max, tab.nl[i]);
  // P nL <= 65, so a cluster block's share, ceil(P / KS) <= ceil(P / 2) problems
  // of 2 nL kTN floats, fits in the ring where it is summed
  const int park_max = (kBlockSmem - 4 * kRingFloats) / (4 * 2 * nL * kTN);
  p->P = std::max(1, std::min({B, kTM / 2 / nl_max, park_max}));
  p->ptiles = (B + p->P - 1) / p->P;
  p->tiles = p->ptiles * ((n_sc + kTN - 1) / kTN);
  const Split sp = split_k(p->tiles, n_re, n_sm);
  p->KS = sp.KS;
  p->clusters = sp.clusters;
  p->blocks = sp.blocks;
  p->smem = 4 * (kRingFloats + p->P * 2 * nL * kTN);
  return 0;
}

// Four floats of a span, n of them valid, to d: one 16-byte store (a = 4),
// two 8-byte ones (a = 2) or single floats; streaming (written once).
__device__ __forceinline__ void store4(float* d, const float (&v)[4], int n, int a) {
  if (n >= 4 && a == 4) {
    __stcs(reinterpret_cast<float4*>(d), make_float4(v[0], v[1], v[2], v[3]));
  } else if (n >= 4 && a == 2) {
    __stcs(reinterpret_cast<float2*>(d), make_float2(v[0], v[1]));
    __stcs(reinterpret_cast<float2*>(d + 2), make_float2(v[2], v[3]));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n) __stcs(d + i, v[i]);
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM) fill_rotate_kernel(
    const float* __restrict__ h, const float* __restrict__ w, const float* __restrict__ rot,
    float* __restrict__ out, int B, int nL, int n_re, int n_sc, int n_alloc, int grid_sc,
    int grid_sym, int sc0, int sy0, int align, ChunkTab tab, Plan p) {
  extern __shared__ __align__(16) float smem[];
  float* parked = smem + kRingFloats;  // (P, 2, nL, kTN): this block's sums of the tile
  cg::cluster_group cluster = cg::this_cluster();
  const int KS = p.KS, rank = static_cast<int>(cluster.block_rank());
  const int ncl = gridDim.x / KS;
  const int tid = threadIdx.x, ry = tid / (kTN / 4), cx = tid % (kTN / 4);
  const int nk = (n_re + kKT - 1) / kKT, kc = (nk + KS - 1) / KS;
  const int ks0 = min(rank * kc, nk), ks1 = min(ks0 + kc, nk);
  const int pc = (p.P + KS - 1) / KS;  // problems of a tile this block writes (KS > 1)
  const size_t row = static_cast<size_t>(grid_sym) * nL;  // floats of one (b, ri, sc)
  const int per_sc = n_alloc * nL, nv = (per_sc + 3) / 4;  // a span's floats, fours

  for (int tile = blockIdx.x / KS; tile < p.tiles; tile += ncl) {
    const int b0 = (tile % p.ptiles) * p.P, n0 = (tile / p.ptiles) * kTN;
    const int pv = min(p.P, B - b0);  // problems of this tile

    for (int g = 0; g < tab.n; ++g) {
      const int nl = tab.nl[g], l0 = tab.l0[g], rows = 2 * pv * nl;
      // this thread's A row: row (pp * nl + j) * 2 + ri of the chunk's tile
      const int am = a_row();
      const float* hrow = nullptr;
      if (am < rows) {
        const int q = am >> 1, pp = q / nl;
        hrow = h + ((static_cast<size_t>(b0 + pp) * 2 + (am & 1)) * nL + l0 + q - pp * nl) * n_re;
      }
      float acc[8][4];
      tile_product(acc, smem, hrow, w + static_cast<size_t>(tab.c[g]) * n_re * n_sc, n_re, n_sc,
                   n0, ks0, ks1, ry * 8 < rows);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = ry * 8 + i, q = m >> 1, pp = q / nl;
        if (pp < p.P)
          *reinterpret_cast<float4*>(parked + ((pp * 2 + (m & 1)) * nL + l0 + q - pp * nl) * kTN +
                                     cx * 4) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
    cluster.sync();  // every block's sums of every chunk parked

    // the sums this block writes: problems [p_lo, p_hi) of the tile, problem
    // p_lo + i at sums + i * 2 * nL * kTN
    const float* sums = parked;
    int p_lo = 0, p_hi = pv;
    if (KS > 1) {
      p_lo = min(rank * pc, pv);
      p_hi = min(p_lo + pc, pv);
      float* red = smem;  // the ring, free: (p_hi - p_lo, 2, nL, kTN) (make_plan: it fits)
      const int per_p = nL * (kTN / 4);  // fours of one (problem, ri)
      for (int e = tid; e < (p_hi - p_lo) * per_p; e += kThreads) {
        const int i = e / per_p, off = (2 * i * per_p + e - i * per_p) * 4;  // re four of e
        float4 fr, fi;
        cluster_sum_pair(cluster, parked, p_lo * 2 * nL * kTN + off, nL * kTN, KS, fr, fi);
        *reinterpret_cast<float4*>(red + off) = fr;
        *reinterpret_cast<float4*>(red + off + nL * kTN) = fi;
      }
      cluster.sync();  // every partial read (and `red` written) before anyone goes on
      sums = red;
    }

    // thread tid writes the fours e = tid, tid + kThreads, ... of every problem's
    // ns spans of nv fours: (s, v) = (e / nv, e % nv), walked without a divide
    const int ns = min(kTN, n_sc - n0);
    const int s_first = tid / nv, v_first = tid - s_first * nv;
    const int s_inc = kThreads / nv, v_inc = kThreads - s_inc * nv;
    const int inv_nL = (65536 + nL - 1) / nL;  // r / nL = (r * inv_nL) >> 16 for r < 256, nL <= 8
    const bool quad = nL % 4 == 0;  // every four floats of a span share a symbol
    for (int pp = p_lo; pp < p_hi; ++pp) {
      const size_t b = b0 + pp;
      const float* rb = rot + b * 2 * n_alloc;
      float* o_r = out + ((b * 2) * grid_sc + sc0 + n0) * row + static_cast<size_t>(sy0) * nL;
      float* o_i = o_r + static_cast<size_t>(grid_sc) * row;
      const float* f_r = sums + (pp - p_lo) * 2 * nL * kTN;
      const float* f_i = f_r + nL * kTN;
      for (int s = s_first, v = v_first; s < ns;) {
        const int r0 = 4 * v, y0 = (r0 * inv_nL) >> 16;  // the four's first symbol and layer
        float vr[4], vi[4];
        if (quad) {  // one symbol, layers l..l+3
          const int l = r0 - y0 * nL;
          const float rr = __ldg(rb + y0), ri = __ldg(rb + n_alloc + y0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float fr = f_r[(l + i) * kTN + s], fi = f_i[(l + i) * kTN + s];
            vr[i] = fr * rr - fi * ri;
            vi[i] = fr * ri + fi * rr;
          }
        } else {
          int y = y0, l = r0 - y0 * nL;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            vr[i] = vi[i] = 0.f;
            if (r0 + i < per_sc) {
              const float fr = f_r[l * kTN + s], fi = f_i[l * kTN + s];
              const float rr = __ldg(rb + y), ri = __ldg(rb + n_alloc + y);
              vr[i] = fr * rr - fi * ri;
              vi[i] = fr * ri + fi * rr;
            }
            if (++l == nL) {
              l = 0;
              ++y;
            }
          }
        }
        store4(o_r + s * row + r0, vr, per_sc - r0, align);
        store4(o_i + s * row + r0, vi, per_sc - r0, align);
        v += v_inc;
        s += s_inc;
        if (v >= nv) {
          v -= nv;
          ++s;
        }
      }
    }
    __syncthreads();  // `sums` read before the next tile's ring and parking overwrite it
  }
}

// Every layer in exactly one chunk (the parked sums of a layer come from one
// chunk), at most 2 P nl = kTM rows a chunk.
int check_layers(const ChunkTab* tab, int nL) {
  if (check_tab(tab, nL) != 0) return 1;
  unsigned seen = 0;
  for (int i = 0; i < tab->n; ++i) {
    const unsigned bits = ((1u << tab->nl[i]) - 1u) << tab->l0[i];
    if (tab->nl[i] > kTM / 2 || (seen & bits) != 0) return 1;
    seen |= bits;
  }
  return seen == (1u << nL) - 1u ? 0 : 1;
}

}  // namespace

// out[0..5] = P, tiles, KS, clusters, blocks, smem of a launch.
extern "C" int srs_fill_rotate_plan(long long* out, int B, int nL, int n_re, int n_sc,
                                    int n_alloc, const ChunkTab* tab, int n_sm) {
  if (nL < 1 || nL > kMaxLayers || n_alloc < 1 || n_alloc > kMaxSym || check_layers(tab, nL) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const int bad = make_plan(&p, *tab, B, nL, n_re, n_sc, n_sm);
  if (bad != 0) return bad;
  const long long v[6] = {p.P, p.tiles, p.KS, p.clusters, p.blocks, p.smem};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

extern "C" int srs_fill_rotate_f32(const float* h, const float* w, const float* rot, float* out,
                                   int B, int nL, int n_re, int n_sc, int n_alloc, int grid_sc,
                                   int grid_sym, int sc0, int sy0, const ChunkTab* tab,
                                   void* stream) {
  if (B < 1 || nL < 1 || nL > kMaxLayers || n_re < 1 || n_sc < 1 || n_alloc < 1 ||
      n_alloc > kMaxSym || sc0 < 0 || sy0 < 0 || sc0 + n_sc > grid_sc ||
      sy0 + n_alloc > grid_sym || check_layers(tab, nL) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int n_sm = 0;
  int bad = sm_count(&n_sm);
  if (bad != 0) return bad;
  Plan p;
  bad = make_plan(&p, *tab, B, nL, n_re, n_sc, n_sm);
  if (bad != 0) return bad;
  // the widest store every span allows: its start is a multiple of `align` floats
  const int row = grid_sym * nL, off = sy0 * nL;
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  const int align = (row % 4 == 0 && off % 4 == 0 && o % 16 == 0)  ? 4
                    : (row % 2 == 0 && off % 2 == 0 && o % 8 == 0) ? 2
                                                                     : 1;
  cudaError_t e = cudaFuncSetAttribute(fill_rotate_kernel,
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
  e = cudaLaunchKernelEx(&cfg, fill_rotate_kernel, h, w, rot, out, B, nL, n_re, n_sc, n_alloc,
                         grid_sc, grid_sym, sc0, sy0, align, *tab, p);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
