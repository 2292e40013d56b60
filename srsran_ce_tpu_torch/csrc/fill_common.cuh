// The tiled product shared by the grid fills for Hopper (sm_90a), f32: K2
// (fill_rotate_serve.cu, serve layout) and K6 (fill_rotate.cu, reference
// layout). Both compute (fr, fi)[b, l, t] = sum_k h[b, (0, 1), l, k] *
// W[c(l), k, t] and differ only in how they tile the rows and write the grid.
//
// A product tile is kTM rows (h rows, each a (problem, layer, re/im) row of
// n_re values) x kTN subcarriers. Per K step of kKT rows both operands go
// through a two-stage ring in shared memory: h's rows by vector loads into
// registers a step ahead (kParts parts of four values, each between two
// chunks of the step's FMAs), stored k-major, and W by cp.async, 16 bytes a
// copy where n_sc allows; thread (ry, cx) keeps an 8 x 4 register tile, rows
// ry * 8.. and subcarriers cx * 4... A tile's K steps may be split over a
// cluster of KS blocks (block r takes steps [r * kc, r * kc + kc)); the
// partials meet in distributed shared memory and are summed in rank order
// (`cluster_sum_pair`), so every launch of one plan sums in one order. The
// clusters are persistent: cluster i takes tiles i, i + clusters, ...
// `split_k` chooses KS and the clusters from the tile count (the Python
// mirrors: fill_rotate_serve.launch_plan and fill_rotate.launch_plan).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

constexpr int kMaxChunks = 16;

// Layer chunks: nl[i] layers of CDM group c[i], starting at layer l0[i].
// At file scope: the exported C entries take it by pointer.
struct ChunkTab {
  int n;
  int c[kMaxChunks];
  int l0[kMaxChunks];
  int nl[kMaxChunks];
};

namespace fill {

namespace cg = cooperative_groups;

constexpr int kTM = 64;     // rows of a product tile
constexpr int kTN = 128;    // subcarriers of a product tile
constexpr int kKT = 32;     // K rows a stage
constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 2;
constexpr int kMaxKS = 8;   // portable cluster size
constexpr int kMaxSym = 32;
constexpr int kStage = kKT * (kTM + kTN);  // floats of one ring stage
constexpr int kRingFloats = 2 * kStage;
constexpr int kAE = kKT * kTM / kThreads;  // A values a thread loads a stage
constexpr int kParts = kAE / 4;             // ... four at a time, between FMA chunks

struct Split {
  int KS, clusters, blocks;
};

// KS = ceil(n_sm / tiles) blocks a tile (1..8, at most the K steps), so that
// a launch with fewer tiles than SMs still covers them; kBlocksPerSM * n_sm /
// KS persistent clusters, at most one a tile.
inline Split split_k(int tiles, int n_re, int n_sm) {
  Split s;
  const int nk = (n_re + kKT - 1) / kKT;
  s.KS = std::max(1, std::min({kMaxKS, nk, (n_sm + tiles - 1) / tiles}));
  s.clusters = std::max(1, std::min(tiles, kBlocksPerSM * n_sm / s.KS));
  s.blocks = s.clusters * s.KS;
  return s;
}

inline int sm_count(int* n_sm) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(e);
}

inline int check_tab(const ChunkTab* tab, int nL) {
  if (tab == nullptr || tab->n < 1 || tab->n > kMaxChunks) return 1;
  for (int i = 0; i < tab->n; ++i)
    if (tab->nl[i] < 1 || tab->l0[i] < 0 || tab->l0[i] + tab->nl[i] > nL || tab->c[i] < 0)
      return 1;
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

// The h row this thread loads into the ring: row a_row() of the tile.
__device__ __forceinline__ int a_row() { return threadIdx.x & (kTM - 1); }

// acc = the thread's 8 x 4 tile of A[:, K steps ks0..ks1) @ W[.., n0 + ...]:
// rows ry * 8.. of the tile (ry = warp), subcarriers n0 + cx * 4... `hrow` is
// this thread's A row (row a_row() of the tile, n_re values) or nullptr for a
// zero row; `live` is false for a warp whose eight rows are all zero rows
// (it loads and copies but skips the FMAs). Uses the ring (kRingFloats of
// `smem`); every copy has landed and every thread has left the ring when it
// returns.
__device__ __forceinline__ void tile_product(float (&acc)[8][4], float* smem,
                                             const float* __restrict__ hrow,
                                             const float* __restrict__ wc, int n_re, int n_sc,
                                             int n0, int ks0, int ks1, bool live) {
  const int tid = threadIdx.x, ry = tid / (kTN / 4), cx = tid % (kTN / 4);
  const bool vec = (n_sc & 3) == 0;
  const int a_vec = (n_re & 3) == 0 ? 4 : (n_re & 1) == 0 ? 2 : 1;  // h row loads
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // thread (am, aq) holds its row's values k0 + kAE aq .. + kAE of a stage
  const int am = a_row(), aq = tid / kTM;
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
        cp_async16(Bs + 4 * e, ok ? wc + static_cast<size_t>(k) * n_sc + col : wc, ok);
      }
    } else {
      for (int e = tid; e < kKT * kTN; e += kThreads) {
        const int kk = e / kTN, col = n0 + e - kk * kTN, k = k0 + kk;
        const bool ok = k < n_re && col < n_sc;
        cp_async4(Bs + e, ok ? wc + static_cast<size_t>(k) * n_sc + col : wc, ok);
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
      if (live) {
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
      }
      if (next) {
        store_a(s + 1, part);  // the other buffer: no one reads it in this step
        if (part + 1 < kParts) load_a(s + 1, part + 1);
      }
    }
    __syncthreads();
  }
}

// fr, fi = the four floats at `off` and at `off + stride` of `local` (a re
// and an im row), each summed over the cluster's KS blocks in rank order from
// 0 (distributed shared memory; the caller has synchronised the cluster after
// every block wrote its partial).
__device__ __forceinline__ void cluster_sum_pair(cg::cluster_group& cluster, float* local, int off,
                                                 int stride, int KS, float4& fr, float4& fi) {
  fr = make_float4(0.f, 0.f, 0.f, 0.f);
  fi = fr;
  for (int r = 0; r < KS; ++r) {
    const float* pr = cluster.map_shared_rank(local, r) + off;
    const float4 x = *reinterpret_cast<const float4*>(pr);
    const float4 z = *reinterpret_cast<const float4*>(pr + stride);
    fr.x += x.x; fr.y += x.y; fr.z += x.z; fr.w += x.w;
    fi.x += z.x; fi.y += z.y; fi.z += z.z; fi.w += z.w;
  }
}

}  // namespace fill
