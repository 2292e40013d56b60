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
// Grid: x = 128-subcarrier tile, y = block of 8 problems. Each block walks the
// layer chunks (at most two layers of one CDM group) in turn, keeps the f32
// sums of one subcarrier per thread in registers, parks them in shared memory,
// and then writes the tile: for a (problem, re/im) pair the tile is
// 128 x n_alloc x nL floats that lie contiguous when the hop spans the grid's
// symbols, so consecutive threads store consecutive floats.

#include <cuda_runtime.h>

constexpr int kMaxChunks = 16;

// Layer chunks: nl[i] <= 2 layers of CDM group c[i], starting at layer l0[i].
// Outside the anonymous namespace: the exported C entry takes it by pointer.
struct FillChunks {
  int n;
  int c[kMaxChunks];
  int l0[kMaxChunks];
  int nl[kMaxChunks];
};

namespace {

constexpr int kTile = 128;  // subcarriers per block == threads per block
constexpr int kBB = 8;      // problems per block
constexpr int kLC = 2;      // layers per chunk
constexpr int kRows = kBB * 2 * kLC;  // h rows per chunk: (problem, ri, layer)
constexpr int kKC = 32;     // n_re chunk staged in shared memory
constexpr int kMaxSym = 32;
constexpr int kMaxLayers = 8;

__global__ void __launch_bounds__(kTile) fill_rotate_kernel(
    const float* __restrict__ h, const float* __restrict__ w,
    const float* __restrict__ rot, float* __restrict__ out, int B, int nL,
    int n_re, int n_sc, int n_alloc, int grid_sc, int grid_sym, int sc0,
    int sy0, FillChunks tab) {
  // f[(bb * 2 + ri) * nL + l][s]: the tile's sums, all layers
  extern __shared__ float f[];
  __shared__ __align__(16) float hs[kKC][kRows];
  __shared__ float rs[kBB][2][kMaxSym];

  const int t0 = blockIdx.x * kTile;
  const int t = t0 + threadIdx.x;
  const int b0 = blockIdx.y * kBB;
  const int nb = min(kBB, B - b0);

  for (int ch = 0; ch < tab.n; ++ch) {
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
            acc[4 * v + 0] = fmaf(x.x, wv, acc[4 * v + 0]);
            acc[4 * v + 1] = fmaf(x.y, wv, acc[4 * v + 1]);
            acc[4 * v + 2] = fmaf(x.z, wv, acc[4 * v + 2]);
            acc[4 * v + 3] = fmaf(x.w, wv, acc[4 * v + 3]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int bb = 0; bb < kBB; ++bb) {
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
#pragma unroll
        for (int j = 0; j < kLC; ++j) {
          if (bb < nb && j < nl)
            f[((bb * 2 + ri) * nL + l0 + j) * kTile + threadIdx.x] =
                acc[(bb * 2 + ri) * kLC + j];
        }
      }
    }
  }

  for (int e = threadIdx.x; e < nb * 2 * n_alloc; e += kTile) {
    const int bb = e / (2 * n_alloc), r = e % (2 * n_alloc);
    rs[bb][r / n_alloc][r % n_alloc] = rot[static_cast<size_t>(b0 + bb) * 2 * n_alloc + r];
  }
  __syncthreads();

  // Write the tile: e walks (s, y, l) with the layer fastest, so that for a
  // full-slot hop the block of one (problem, re/im) is one contiguous span.
  const int ns = min(kTile, n_sc - t0);
  const int per_sc = n_alloc * nL;
  const size_t row = static_cast<size_t>(grid_sym) * nL;  // floats per subcarrier
  for (int bb = 0; bb < nb; ++bb) {
    const size_t b = b0 + bb;
    float* o_r = out + ((b * 2 + 0) * grid_sc + sc0 + t0) * row + static_cast<size_t>(sy0) * nL;
    float* o_i = out + ((b * 2 + 1) * grid_sc + sc0 + t0) * row + static_cast<size_t>(sy0) * nL;
    const float* f_r = f + (bb * 2 + 0) * nL * kTile;
    const float* f_i = f + (bb * 2 + 1) * nL * kTile;
    for (int e = threadIdx.x; e < ns * per_sc; e += kTile) {
      const int s = e / per_sc, r = e % per_sc;
      const int y = r / nL, l = r % nL;
      const float fr = f_r[l * kTile + s], fi = f_i[l * kTile + s];
      const float rr = rs[bb][0][y], rim = rs[bb][1][y];
      const size_t off = s * row + static_cast<size_t>(y) * nL + l;
      o_r[off] = fr * rr - fi * rim;
      o_i[off] = fr * rim + fi * rr;
    }
  }
}

}  // namespace

extern "C" int srs_fill_rotate_f32(const float* h, const float* w,
                                   const float* rot, float* out, int B, int nL,
                                   int n_re, int n_sc, int n_alloc, int grid_sc,
                                   int grid_sym, int sc0, int sy0,
                                   const FillChunks* tab, void* stream) {
  if (B < 1 || nL < 1 || nL > kMaxLayers || n_re < 1 || n_sc < 1 || n_alloc < 1 ||
      n_alloc > kMaxSym || sc0 < 0 || sy0 < 0 || sc0 + n_sc > grid_sc ||
      sy0 + n_alloc > grid_sym || tab == nullptr || tab->n < 1 || tab->n > kMaxChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < tab->n; ++i)
    if (tab->nl[i] < 1 || tab->nl[i] > kLC || tab->l0[i] < 0 || tab->l0[i] + tab->nl[i] > nL)
      return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kBB) * 2 * nL * kTile * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fill_rotate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_sc + kTile - 1) / kTile, (B + kBB - 1) / kBB);
  fill_rotate_kernel<<<grid, kTile, smem, static_cast<cudaStream_t>(stream)>>>(
      h, w, rot, out, B, nL, n_re, n_sc, n_alloc, grid_sc, grid_sym, sc0, sy0, *tab);
  return static_cast<int>(cudaGetLastError());
}
