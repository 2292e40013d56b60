// K1: fused estimator front for Hopper (sm_90a), f32.
//
// Replaces srsran_ce_tpu/ops/pallas/kernels.py:fused_front (_front_kernel).
// One thread block per problem; see srsran_ce_tpu_torch/ops/kernels/front.py
// for the algorithm, the plain PyTorch version and the design note.
//
// Layouts (all row-major, contiguous):
//   rx      (B, 2, n_cdm, nd, n_re)      pil   (B, 2, nL, nd, n_re)   beta (B)
//   pair_l / pair_r (n_re, n_pils)       vp    (n_pils, n_pils), v = vp @ y
//   sm (n_re, n_re)   svb / sve (n_pils, n_re)   ta_c / ta_s (k_ta, 2*hcp)
//   two_pi_sst_d (nd): 2*pi * start time of each DM-RS symbol (symbol units)
//   h_out (B, 2, nL, n_re)               sc_out (B, 8) [cfo, ta, noise, rsrp, epre, 0, 0, 0]
// Rows of the working matrices are (ri, l): row = ri * nL + l.
//
// Semantics kept from the TPU kernel: atan2f keeps IEEE signed zeros
// (atan2(-0, x<0) = -pi); the phase unwrap uses numpy's ddmod convention (a
// wrapped -pi with positive difference maps to +pi); the TA argmax takes the
// first maximum of each window and the head window on a tie (hm >= tm);
// division order sum / beta / nd, and rsrp = (beta^2 * sum) * nd.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 16;  // 2 * nL, nL <= 8
constexpr int kMaxPils = 16;
constexpr int kMaxDsym = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

struct FrontArgs {
  const float* rx;
  const float* pil;
  const float* beta;
  const float* pair_l;
  const float* pair_r;
  const float* vp;
  const float* sm;
  const float* svb;
  const float* sve;
  const float* ta_c;
  const float* ta_s;
  const float* two_pi_sst_d;
  float* h_out;
  float* sc_out;
  int n_cdm, nL, nd, n_re, n_pils, k_ta, hcp;
  int cfo_possible, cfo_compensate;
  float two_pi_ns, fft_size, scs_hz;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Sum of v over the block; every thread gets the result.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // earlier readers of red[32] are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  return red[32];
}

// First maximum of x[0..n) over one warp: ties go to the smallest index.
__device__ void warp_first_max(const float* x, int n, float* vmax, int* imax) {
  const int lane = threadIdx.x & 31;
  float bv = -INFINITY;
  int bi = n;
  for (int j = lane; j < n; j += 32) {
    const float v = x[j];
    if (v > bv) { bv = v; bi = j; }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, bv, o);
    const int oi = __shfl_xor_sync(kFull, bi, o);
    if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
  }
  *vmax = bv;
  *imax = bi;
}

__global__ void __launch_bounds__(kThreads) front_kernel(FrontArgs a) {
  extern __shared__ float smem[];
  __shared__ float red[33];
  __shared__ float s_cos[kMaxDsym], s_sin[kMaxDsym];

  const int b = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int n_cdm = a.n_cdm, nL = a.nL, nd = a.nd, n_re = a.n_re, np = a.n_pils;
  const int rows = 2 * nL, nbins = 2 * a.hcp;

  float* H = smem;                   // (rows, n_re) time-averaged LS estimate
  float* Hs = H + rows * n_re;       // (rows, n_re) smoothed
  float* pdp = Hs + rows * n_re;     // (2*hcp)
  float* edge = pdp + nbins;         // (2 sides, rows, np): H @ pair_l, H @ pair_r
  float* virt = edge + 2 * rows * np;  // (2 sides, rows, np): vb, flip-fit ve

  const float* rx = a.rx + static_cast<size_t>(b) * 2 * n_cdm * nd * n_re;
  const float* pil = a.pil + static_cast<size_t>(b) * 2 * nL * nd * n_re;
  const float beta = a.beta[b];
  const int rx_im = n_cdm * nd * n_re;  // offset of the imaginary plane
  const int pil_im = nL * nd * n_re;
  auto rx_at = [&](int c, int d, int k) { return (c * nd + d) * n_re + k; };
  auto pil_at = [&](int l, int d, int k) { return (l * nd + d) * n_re + k; };

  // 1. EPRE: sum |rx|^2 over every gathered pilot RE
  float part = 0.f;
  for (int i = tid; i < rx_im; i += nthr) {
    const float xr = rx[i], xi = rx[rx_im + i];
    part += xr * xr + xi * xi;
  }
  const float epre = block_sum(part, red);

  // 2. first-pair CFO: per layer conj(rec_d0) . rec_d1, paired over CDM groups
  float cfo = 0.f;
  if (a.cfo_possible) {
    float acc = 0.f;
    for (int c = 0; c < n_cdm; ++c) {
      float pr = 0.f, pi = 0.f;
      for (int l = 2 * c; l < 2 * c + 2 && l < nL; ++l) {
        const int cl = min(l / 2, n_cdm - 1);
        float sr = 0.f, si = 0.f;
        for (int k = tid; k < n_re; k += nthr) {
          const float x0r = rx[rx_at(cl, 0, k)], x0i = rx[rx_im + rx_at(cl, 0, k)];
          const float x1r = rx[rx_at(cl, 1, k)], x1i = rx[rx_im + rx_at(cl, 1, k)];
          const float p0r = pil[pil_at(l, 0, k)], p0i = pil[pil_im + pil_at(l, 0, k)];
          const float p1r = pil[pil_at(l, 1, k)], p1i = pil[pil_im + pil_at(l, 1, k)];
          const float ar = x0r * p0r + x0i * p0i, ai = x0i * p0r - x0r * p0i;
          const float er = x1r * p1r + x1i * p1i, ei = x1i * p1r - x1r * p1i;
          sr += ar * er + ai * ei;
          si += ar * ei - ai * er;
        }
        const float in_r = block_sum(sr, red);
        const float in_i = block_sum(si, red);
        if (l == 2 * c) { pr = in_r; pi = in_i; } else { pr += in_r; pi += in_i; }
      }
      acc += atan2f(pi, pr);
    }
    cfo = acc / a.two_pi_ns / static_cast<float>(n_cdm);
  }
  // per-DM-RS-symbol rotation exp(i x_d), x_d = 2*pi*sst_d*cfo; compensation
  // applies exp(-i x_d), the noise reconstruction exp(+i x_d)
  const bool rotate = a.cfo_possible && a.cfo_compensate;
  for (int d = tid; d < nd; d += nthr) {
    float s = 0.f, co = 1.f;
    if (rotate) sincosf(a.two_pi_sst_d[d] * cfo, &s, &co);
    s_cos[d] = co;
    s_sin[d] = s;
  }
  __syncthreads();

  // 3. LS de-spread, compensation, time average -> H
  for (int k = tid; k < n_re; k += nthr) {
    for (int l = 0; l < nL; ++l) {
      const int cl = min(l / 2, n_cdm - 1);
      float sr = 0.f, si = 0.f;
      for (int d = 0; d < nd; ++d) {
        const float xr = rx[rx_at(cl, d, k)], xi = rx[rx_im + rx_at(cl, d, k)];
        const float pr = pil[pil_at(l, d, k)], pi = pil[pil_im + pil_at(l, d, k)];
        const float rr = xr * pr + xi * pi, ri = xi * pr - xr * pi;
        const float co = s_cos[d], s = s_sin[d];
        sr += rr * co + ri * s;
        si += ri * co - rr * s;
      }
      H[l * n_re + k] = sr / beta / static_cast<float>(nd);
      H[(nL + l) * n_re + k] = si / beta / static_cast<float>(nd);
    }
  }
  __syncthreads();

  // 4. edge products H @ pair_l and H @ pair_r, one warp per output
  for (int o = warp; o < 2 * rows * np; o += nwarps) {
    const int side = o / (rows * np), r = (o / np) % rows, j = o % np;
    const float* P = side ? a.pair_r : a.pair_l;
    float v = 0.f;
    for (int k = lane; k < n_re; k += 32) v += H[r * n_re + k] * P[k * np + j];
    v = warp_sum(v);
    if (lane == 0) edge[(side * rows + r) * np + j] = v;
  }
  __syncthreads();

  // 5. virtual pilots: one lane per (side, layer) series, serial over n_pils.
  // Side 1 fits the reversed right edge (the TPU kernel's flipped pair_r).
  if (warp == 0 && lane < rows) {
    const int side = lane / nL, l = lane % nL;
    const float* e = edge + side * rows * np;
    float* out = virt + side * rows * np;
    float vr[kMaxPils], vi[kMaxPils];
    for (int j = 0; j < np; ++j) {
      const int jj = side ? np - 1 - j : j;
      vr[j] = e[l * np + jj];
      vi[j] = e[(nL + l) * np + jj];
    }
    if (np == 1) {
      out[l * np] = vr[0];
      out[(nL + l) * np] = vi[0];
    } else {
      float amp[kMaxPils], ph[kMaxPils];
      float prev = 0.f, cum = 0.f;
      for (int j = 0; j < np; ++j) {
        amp[j] = sqrtf(vr[j] * vr[j] + vi[j] * vi[j]);
        const float raw = atan2f(vi[j], vr[j]);
        if (j > 0) {
          const float d = raw - prev;
          float dd = d - kTwoPi * floorf((d + kPi) / kTwoPi);
          if (dd == -kPi && d > 0.f) dd = kPi;
          cum += dd - d;
        }
        ph[j] = raw + cum;
        prev = raw;
      }
      for (int j = 0; j < np; ++j) {
        float va = 0.f, vph = 0.f;
        for (int i = 0; i < np; ++i) {
          const float m = a.vp[j * np + i];
          va += amp[i] * m;
          vph += ph[i] * m;
        }
        float s, co;
        sincosf(vph, &s, &co);
        out[l * np + j] = va * co;
        out[(nL + l) * np + j] = va * s;
      }
    }
  }
  __syncthreads();

  // 6. smoothing Hs = H @ sm + vb @ svb + flip(ve) @ sve, one column per thread
  const float* vb = virt;
  const float* vef = virt + rows * np;
  float* h_out = a.h_out + static_cast<size_t>(b) * rows * n_re;
  for (int kc = tid; kc < n_re; kc += nthr) {
    float acc[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int i = 0; i < n_re; ++i) {
      const float w = a.sm[static_cast<size_t>(i) * n_re + kc];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
        if (r < rows) acc[r] += H[r * n_re + i] * w;
    }
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r < rows) {
        float t2 = 0.f, t3 = 0.f;
        for (int j = 0; j < np; ++j) {
          t2 += vb[r * np + j] * a.svb[j * n_re + kc];
          t3 += vef[r * np + j] * a.sve[(np - 1 - j) * n_re + kc];
        }
        const float v = (acc[r] + t2) + t3;
        Hs[r * n_re + kc] = v;
        h_out[r * n_re + kc] = v;
      }
    }
  }
  __syncthreads();

  // 7. time alignment: PDP of the direct DFT over the +-half-CP bins
  for (int t = tid; t < nbins; t += nthr) {
    float tc[kMaxRows], ts[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) { tc[r] = 0.f; ts[r] = 0.f; }
#pragma unroll 2
    for (int k = 0; k < a.k_ta; ++k) {
      const float c = a.ta_c[static_cast<size_t>(k) * nbins + t];
      const float s = a.ta_s[static_cast<size_t>(k) * nbins + t];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < rows) {
          const float h = Hs[r * n_re + k];
          tc[r] += h * c;
          ts[r] += h * s;
        }
      }
    }
    float p = 0.f;
#pragma unroll
    for (int l = 0; l < kMaxRows / 2; ++l) {
      if (l < nL) {
        const float re = tc[l] - ts[nL + l];  // hr@C - hi@S
        const float im = ts[l] + tc[nL + l];  // hr@S + hi@C
        p += re * re + im * im;
      }
    }
    pdp[t] = p;
  }
  __syncthreads();

  float ta = 0.f;
  if (warp == 0) {
    float hm, tm;
    int i_d, i_a;
    warp_first_max(pdp, a.hcp, &hm, &i_d);
    warp_first_max(pdp + a.hcp, a.hcp, &tm, &i_a);
    const float i_max = hm >= tm ? static_cast<float>(i_d) : -static_cast<float>(a.hcp - i_a);
    ta = i_max / a.fft_size / a.scs_hz;
  }

  // 8. noise: received pilots minus the reconstruction from the smoothed estimate
  float npart = 0.f, rpart = 0.f;
  for (int k = tid; k < n_re; k += nthr) {
    for (int c = 0; c < n_cdm; ++c) {
      const int l1 = min(2 * c + 2, nL);
      for (int d = 0; d < nd; ++d) {
        const float co = s_cos[d], s = s_sin[d];
        float er = 0.f, ei = 0.f;
        for (int l = 2 * c; l < l1; ++l) {
          const float hr = Hs[l * n_re + k], hi = Hs[(nL + l) * n_re + k];
          const float hpr = hr * co - hi * s, hpi = hr * s + hi * co;
          const float pr = pil[pil_at(l, d, k)], pi = pil[pil_im + pil_at(l, d, k)];
          er += beta * (pr * hpr - pi * hpi);
          ei += beta * (pr * hpi + pi * hpr);
        }
        const float dr = rx[rx_at(c, d, k)] - er, di = rx[rx_im + rx_at(c, d, k)] - ei;
        npart += dr * dr + di * di;
      }
    }
    for (int r = 0; r < rows; ++r) {
      const float h = Hs[r * n_re + k];
      rpart += h * h;
    }
  }
  const float noise = block_sum(npart, red);
  const float hsum = block_sum(rpart, red);

  if (tid == 0) {
    float* sc = a.sc_out + static_cast<size_t>(b) * 8;
    sc[0] = cfo;
    sc[1] = ta;
    sc[2] = noise;
    sc[3] = (beta * beta) * hsum * static_cast<float>(nd);
    sc[4] = epre;
    sc[5] = 0.f;
    sc[6] = 0.f;
    sc[7] = 0.f;
  }
}

}  // namespace

extern "C" int srs_fused_front_f32(
    const float* rx, const float* pil, const float* beta, const float* pair_l,
    const float* pair_r, const float* vp, const float* sm, const float* svb,
    const float* sve, const float* ta_c, const float* ta_s, const float* two_pi_sst_d,
    float* h_out, float* sc_out, int B, int n_cdm, int nL, int nd, int n_re,
    int n_pils, int k_ta, int hcp, int cfo_possible, int cfo_compensate,
    float two_pi_ns, float fft_size, float scs_hz, int smem_bytes, void* stream) {
  const int rows = 2 * nL;
  const long need = 4L * (2L * rows * n_re + 2L * hcp + 4L * rows * n_pils);
  if (B < 1 || nL < 1 || 2 * nL > kMaxRows || n_pils < 1 || n_pils > kMaxPils ||
      nd > kMaxDsym || smem_bytes < need)
    return static_cast<int>(cudaErrorInvalidValue);
  FrontArgs a{rx, pil, beta, pair_l, pair_r, vp, sm, svb, sve, ta_c, ta_s, two_pi_sst_d,
              h_out, sc_out, n_cdm, nL, nd, n_re, n_pils, k_ta, hcp,
              cfo_possible, cfo_compensate, two_pi_ns, fft_size, scs_hz};
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        front_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  front_kernel<<<B, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
