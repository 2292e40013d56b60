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
// Grid: x = 128-subcarrier tile, y = block of 8 problems, z = layer chunk
// (at most two layers of one CDM group). One subcarrier per thread.

#include <cuda_runtime.h>

constexpr int kMaxChunks = 16;

// Layer chunks: at most kLC layers of CDM group c[i], starting at layer l0[i].
// Outside the anonymous namespace: the exported C entry takes it by pointer.
struct ChunkTab {
  int n;
  int c[kMaxChunks];
  int l0[kMaxChunks];
  int nl[kMaxChunks];
};

namespace {

constexpr int kTile = 128;  // subcarriers per block == threads per block
constexpr int kBB = 8;      // problems per block
constexpr int kLC = 2;      // layers per chunk
constexpr int kRows = kBB * 2 * kLC;  // h rows per block: (problem, ri, layer)
constexpr int kKC = 32;     // n_re chunk staged in shared memory
constexpr int kMaxSym = 32;

__global__ void __launch_bounds__(kTile) fill_rotate_serve_kernel(
    const float* __restrict__ h, const float* __restrict__ w,
    const float* __restrict__ rot, float* __restrict__ out, int B, int nL,
    int n_re, int n_sc, int n_sym, ChunkTab tab) {
  // hs[kk][q]: row q = (bb * 2 + ri) * kLC + j, minor so one float4 reads 4 rows
  __shared__ __align__(16) float hs[kKC][kRows];
  __shared__ float rs[kBB][2][kMaxSym];

  const int t = blockIdx.x * kTile + threadIdx.x;
  const int b0 = blockIdx.y * kBB;
  const int nb = min(kBB, B - b0);
  const int ch = blockIdx.z;
  const int c = tab.c[ch], l0 = tab.l0[ch], nl = tab.nl[ch];
  const float* wc = w + static_cast<size_t>(c) * n_re * n_sc;

  float acc[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) acc[q] = 0.f;

  for (int k0 = 0; k0 < n_re; k0 += kKC) {
    for (int e = threadIdx.x; e < kKC * kRows; e += kTile) {
      const int kk = e / kRows, q = e % kRows;
      const int bb = q / (2 * kLC), ri = (q / kLC) % 2, j = q % kLC;
      const int k = k0 + kk;
      float v = 0.f;
      if (bb < nb && j < nl && k < n_re)
        v = h[((static_cast<size_t>(b0 + bb) * 2 + ri) * nL + l0 + j) * n_re + k];
      hs[kk][q] = v;
    }
    __syncthreads();
    if (t < n_sc) {
      const int kn = min(kKC, n_re - k0);
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        const float wv = wc[static_cast<size_t>(k0 + kk) * n_sc + t];
        const float4* hv = reinterpret_cast<const float4*>(hs[kk]);
#pragma unroll
        for (int v = 0; v < kRows / 4; ++v) {
          const float4 x = hv[v];
          acc[4 * v + 0] += x.x * wv;
          acc[4 * v + 1] += x.y * wv;
          acc[4 * v + 2] += x.z * wv;
          acc[4 * v + 3] += x.w * wv;
        }
      }
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < nb * 2 * n_sym; e += kTile) {
    const int bb = e / (2 * n_sym), r = e % (2 * n_sym);
    rs[bb][r / n_sym][r % n_sym] = rot[static_cast<size_t>(b0 + bb) * 2 * n_sym + r];
  }
  __syncthreads();
  if (t >= n_sc) return;

  const size_t plane = static_cast<size_t>(n_sym) * n_sc;
#pragma unroll
  for (int bb = 0; bb < kBB; ++bb) {
    if (bb >= nb) break;
#pragma unroll
    for (int j = 0; j < kLC; ++j) {
      if (j >= nl) break;
      const float fr = acc[(bb * 2 + 0) * kLC + j];
      const float fi = acc[(bb * 2 + 1) * kLC + j];
      const size_t l = l0 + j;
      float* o_r = out + ((static_cast<size_t>(b0 + bb) * 2 + 0) * nL + l) * plane + t;
      float* o_i = out + ((static_cast<size_t>(b0 + bb) * 2 + 1) * nL + l) * plane + t;
      for (int y = 0; y < n_sym; ++y) {
        const float rr = rs[bb][0][y], ri = rs[bb][1][y];
        o_r[static_cast<size_t>(y) * n_sc] = fr * rr - fi * ri;
        o_i[static_cast<size_t>(y) * n_sc] = fr * ri + fi * rr;
      }
    }
  }
}

}  // namespace

extern "C" int srs_fill_rotate_serve_f32(const float* h, const float* w,
                                         const float* rot, float* out, int B,
                                         int nL, int n_re, int n_sc, int n_sym,
                                         const ChunkTab* tab, void* stream) {
  if (B < 1 || n_sym < 1 || n_sym > kMaxSym || tab == nullptr || tab->n < 1 ||
      tab->n > kMaxChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < tab->n; ++i)
    if (tab->nl[i] < 1 || tab->nl[i] > kLC || tab->l0[i] + tab->nl[i] > nL)
      return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_sc + kTile - 1) / kTile, (B + kBB - 1) / kBB, tab->n);
  fill_rotate_serve_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      h, w, rot, out, B, nL, n_re, n_sc, n_sym, *tab);
  return static_cast<int>(cudaGetLastError());
}
