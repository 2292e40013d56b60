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
// pair never leaves a tile. Output tiles of kTM rows x kTN subcarriers; a
// cluster of KS blocks takes one tile at a time, each block a 1/KS share of
// the K (n_re) steps, and the clusters walk the tiles persistently (tile +=
// number of clusters), so one tile's stores overlap the next tile's product.
// Per K step of kKT rows both operands go through a two-stage ring: h's rows
// by vector loads into registers a step ahead, stored k-major, and W by
// cp.async, 16 bytes a copy; a thread keeps an 8 x 4 register tile. The partial tile goes to shared memory; block r of the
// cluster sums its 1/KS of the tile's pairs over the cluster's partials in
// rank order (distributed shared memory) and writes the n_sym rotated symbols
// as 16-byte streaming stores. make_plan (fill_rotate_serve.launch_plan
// mirrors it) splits K only where the tiles are fewer than the SMs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace cg = cooperative_groups;

constexpr int kMaxChunks = 16;

// Layer chunks: nl[i] layers of CDM group c[i], starting at layer l0[i].
// Outside the anonymous namespace: the exported C entry takes it by pointer.
struct ChunkTab {
  int n;
  int c[kMaxChunks];
  int l0[kMaxChunks];
  int nl[kMaxChunks];
};

namespace {

constexpr int kTM = 64;     // rows of an output tile: 32 (re, im) pairs
constexpr int kTN = 128;    // subcarriers of an output tile
constexpr int kKT = 32;     // K rows a stage
constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 2;
constexpr int kMaxKS = 8;   // portable cluster size
constexpr int kMaxSym = 32;
constexpr int kStage = kKT * (kTM + kTN);  // floats of one ring stage
constexpr int kSmem = 4 * (2 * kStage > kTM * kTN ? 2 * kStage : kTM * kTN);
constexpr int kAE = kKT * kTM / kThreads;  // A values a thread loads a stage
constexpr int kParts = kAE / 4;             // ... four at a time, between FMA chunks

struct Plan {
  int KS, tiles, clusters, blocks, smem;
  int tile0[kMaxChunks + 1];  // first tile of each chunk
  int mt[kMaxChunks];         // row tiles of each chunk
};

// Tiles of every chunk; KS = ceil(n_sm / tiles) blocks a tile (1..8, at most
// the K steps), so that a launch with fewer tiles than SMs still covers them;
// kBlocksPerSM * n_sm / KS clusters (at most the tiles).
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
  const int nk = (n_re + kKT - 1) / kKT;
  p->KS = std::max(1, std::min({kMaxKS, nk, (n_sm + p->tiles - 1) / p->tiles}));
  p->clusters = std::max(1, std::min(p->tiles, kBlocksPerSM * n_sm / p->KS));
  p->blocks = p->clusters * p->KS;
  p->smem = kSmem;
  return 0;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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
  const int a_vec = (n_re & 3) == 0 ? 4 : (n_re & 1) == 0 ? 2 : 1;  // h row loads
  const int pairs = (kTM / 2 + KS - 1) / KS;  // pairs of a tile this block writes
  const size_t plane = static_cast<size_t>(n_sym) * n_sc;

  for (int tile = blockIdx.x / KS; tile < p.tiles; tile += ncl) {
    int g = 0;
    while (tile >= p.tile0[g + 1]) ++g;
    const int local = tile - p.tile0[g];
    const int m0 = (local % p.mt[g]) * kTM, n0 = (local / p.mt[g]) * kTN;
    const int nl = tab.nl[g], l0 = tab.l0[g], rows_g = 2 * B * nl;
    const float* wc = w + static_cast<size_t>(tab.c[g]) * n_re * n_sc;

    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    // A rows: thread (am, aq) holds row m0 + am's values k0 + kAE aq .. + kAE
    // of a stage, loaded into registers a step ahead four at a time (kParts
    // parts, each between two chunks of the step's FMAs), stored k-major
    const int am = tid & (kTM - 1), aq = tid / kTM, arow = m0 + am;
    const float* hrow = nullptr;
    if (arow < rows_g) {
      const int q = arow >> 1, b = q / nl;
      hrow = h + ((static_cast<size_t>(b) * 2 + (arow & 1)) * nL + l0 + q - b * nl) * n_re;
    }
    float areg[4];
    auto load_a = [&](int s, int part) {
      const int k = s * kKT + kAE * aq + 4 * part;
      if (hrow == nullptr) {
#pragma unroll
        for (int i = 0; i < 4; ++i) areg[i] = 0.f;
      } else if (k + 4 <= n_re && a_vec == 4) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(hrow + k));
        areg[0] = x.x; areg[1] = x.y; areg[2] = x.z; areg[3] = x.w;
      } else if (k + 4 <= n_re && a_vec == 2) {
        const float2 x = __ldg(reinterpret_cast<const float2*>(hrow + k));
        const float2 y = __ldg(reinterpret_cast<const float2*>(hrow + k + 2));
        areg[0] = x.x; areg[1] = x.y; areg[2] = y.x; areg[3] = y.y;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) areg[i] = k + i < n_re ? __ldg(hrow + k + i) : 0.f;
      }
    };
    auto store_a = [&](int s, int part) {
      float* As = smem + (s & 1) * kStage + (kAE * aq + 4 * part) * kTM + am;
#pragma unroll
      for (int i = 0; i < 4; ++i) As[i * kTM] = areg[i];
    };
    auto issue_b = [&](int s) {
      float* Bs = smem + (s & 1) * kStage + kKT * kTM;  // (kKT, kTN)
      const int k0 = s * kKT;
      if (vec) {
        for (int e = tid; e < kKT * kTN / 4; e += kThreads) {
          const int kk = e / (kTN / 4), col = n0 + 4 * (e - kk * (kTN / 4)), k = k0 + kk;
          const bool ok = k < n_re && col < n_sc;
          cp_async16(Bs + 4 * e, ok ? wc + static_cast<size_t>(k) * n_sc + col : w, ok);
        }
      } else {
        for (int e = tid; e < kKT * kTN; e += kThreads) {
          const int kk = e / kTN, col = n0 + e - kk * kTN, k = k0 + kk;
          const bool ok = k < n_re && col < n_sc;
          cp_async4(Bs + e, ok ? wc + static_cast<size_t>(k) * n_sc + col : w, ok);
        }
      }
      cp_async_commit();
    };

    if (ks0 < ks1) {
      for (int part = 0; part < kParts; ++part) {
        load_a(ks0, part);
        store_a(ks0, part);
      }
      issue_b(ks0);
    }
    for (int s = ks0; s < ks1; ++s) {
      const bool next = s + 1 < ks1;
      if (next) {
        issue_b(s + 1);
        load_a(s + 1, 0);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* As = smem + (s & 1) * kStage + ry * 8;
      const float* Bs = smem + (s & 1) * kStage + kKT * kTM + cx * 4;
      for (int part = 0; part < kParts; ++part) {
#pragma unroll 4
        for (int kk = part * kKT / kParts; kk < (part + 1) * kKT / kParts; ++kk) {
          const float4 a0 = *reinterpret_cast<const float4*>(As + kk * kTM);
          const float4 a1 = *reinterpret_cast<const float4*>(As + kk * kTM + 4);
          const float4 bv = *reinterpret_cast<const float4*>(Bs + kk * kTN);
          const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
        }
        if (next) {
          store_a(s + 1, part);  // the other buffer: no one reads it in this step
          if (part + 1 < kParts) load_a(s + 1, part + 1);
        }
      }
      __syncthreads();
    }

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
      float4 fr = make_float4(0.f, 0.f, 0.f, 0.f), fi = fr;
      for (int r = 0; r < KS; ++r) {
        const float* pr = cluster.map_shared_rank(ptile, r) + 2 * q * kTN + 4 * c4;
        const float4 x = *reinterpret_cast<const float4*>(pr);
        const float4 z = *reinterpret_cast<const float4*>(pr + kTN);
        fr.x += x.x; fr.y += x.y; fr.z += x.z; fr.w += x.w;
        fi.x += z.x; fi.y += z.y; fi.z += z.z; fi.w += z.w;
      }
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

int sm_count(int* n_sm) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(e);
}

int check_tab(const ChunkTab* tab, int nL) {
  if (tab == nullptr || tab->n < 1 || tab->n > kMaxChunks) return 1;
  for (int i = 0; i < tab->n; ++i)
    if (tab->nl[i] < 1 || tab->l0[i] < 0 || tab->l0[i] + tab->nl[i] > nL || tab->c[i] < 0)
      return 1;
  return 0;
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
