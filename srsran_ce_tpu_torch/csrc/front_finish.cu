// front_finish: the fused-front tier's finish for Hopper (sm_90a), f32.
//
// Replaces no TPU kernel: it takes the place of the plain PyTorch tail that
// follows K1 (csrc/front.cu) on the "pallas_front" tier. See
// srsran_ce_tpu_torch/ops/kernels/front_finish.py for the plain PyTorch
// version and the design note.
//
// Layouts (row-major, contiguous), per hop h (one or two):
//   h        (B, 2, nL, n_re)        K1's smoothed profiles of the hop
//   sc       (B, 8)                  K1's scalars [cfo, ta, noise, rsrp, epre, 0, 0, 0]
//   left / right (n_cdm, n_sc_hop)   int32: the two interpolation taps of each
//                                    subcarrier of the hop, ordinals into n_re
//   w_l / w_r    (n_cdm, n_sc_hop)   their weights (the dense operator's entries)
//   sst      (n_sym)                 symbol start times (read only when rotating)
//   prof     (B, 2, n_hops, nL, n_sc) or null (the scalar route)
//   rot      (B, 2, n_sym)           (cos, sin) of the CFO rotation
//   scal     (5, B)                  noise, rsrp, epre, ta, cfo_hz
// Layer l belongs to CDM group l / 2 (the paired layout K1 takes).
//
// Work split: block (b, g) of a grid (B, n_hops * n_cdm) writes every
// subcarrier of the rows (ri, l) of problem b, hop g / n_cdm, CDM group
// g % n_cdm: it stages the group's rows of h (2 x up to 2 x n_re floats) in
// shared memory by coalesced loads, then each thread takes 4 consecutive
// subcarriers, reads their four tables once (16-byte loads), and writes the
// 4 outputs of each row as one 16-byte store, zeros outside the hop's band.
// On the profiles route n_sc, each hop's sc_start and n_sc_hop are multiples
// of 4 (every band is whole 12-subcarrier PRBs) and the tables and profiles
// are 16-byte aligned, so a group of 4 lies wholly inside a band or outside. Block (b, 0) also computes problem b's scalars and its
// rotation (a thread a symbol). On the scalar route the grid is (B, 1) of one
// warp. No atomics: every output is written by one thread, so the result does
// not depend on the run.
//
// Arithmetic as the plain version performs it: each profile value is
// w_l * h[left] + w_r * h[right], the products and the sum rounded apart
// (no FMA, so the kernel and the plain version agree bit for bit); the hop
// sums in hop order, rsrp / n_pilots / nL, epre / n_pilots, noise / noise_den
// (IEEE divisions), ta / 2 over two hops, cfo the mean of the hops that can
// estimate it, cfo_hz = cfo * scs_hz (NaN where no hop can), the rotation
// (cosf, sinf)((2 pi * cfo) * sst) in full precision.

#include <cuda_runtime.h>
#include <math.h>

constexpr int kMaxHops = 2;

// One hop's inputs. Outside the anonymous namespace: the exported C entry
// takes the arguments by pointer, as ctypes lays them out.
struct FinishHop {
  const float* h;
  const float* sc;
  const int* left;
  const int* right;
  const float* w_l;
  const float* w_r;
  int n_re;
  int n_sc_hop;
  int sc_start;
  int cfo_possible;
};

struct FinishArgs {
  FinishHop hop[kMaxHops];
  const float* sst;
  float* prof;
  float* rot;
  float* scal;
  int batch;
  int n_hops;
  int nL;
  int n_sc;
  int n_sym;
  int rotate;
  float n_pilots;
  float n_layers;
  float noise_den;
  float scs_hz;
  float two_pi;
};

namespace {

constexpr int kMaxThreads = 512;
constexpr int kSmemLimit = 48 * 1024;  // dynamic shared memory without an opt-in

// Problem b's five scalars and its rotation; thread s < n_sym writes symbol s.
__device__ __forceinline__ void finish_scalars(const FinishArgs& a, int b) {
  for (int s = threadIdx.x; s < a.n_sym; s += blockDim.x) {
    const float* sc0 = a.hop[0].sc + 8LL * b;
    float ta = sc0[1], noise = sc0[2], rsrp = sc0[3], epre = sc0[4];
    float cfo = a.hop[0].cfo_possible ? sc0[0] : 0.0f;
    bool have = a.hop[0].cfo_possible != 0;
    if (a.n_hops == 2) {
      const float* sc1 = a.hop[1].sc + 8LL * b;
      ta = __fadd_rn(ta, sc1[1]);
      noise = __fadd_rn(noise, sc1[2]);
      rsrp = __fadd_rn(rsrp, sc1[3]);
      epre = __fadd_rn(epre, sc1[4]);
      if (a.hop[1].cfo_possible) {
        cfo = have ? __fdiv_rn(__fadd_rn(cfo, sc1[0]), 2.0f) : sc1[0];
        have = true;
      }
      ta = __fdiv_rn(ta, 2.0f);
    }
    if (s == 0) {
      const long long B = a.batch;
      a.scal[b] = __fdiv_rn(noise, a.noise_den);
      a.scal[B + b] = __fdiv_rn(__fdiv_rn(rsrp, a.n_pilots), a.n_layers);
      a.scal[2 * B + b] = __fdiv_rn(epre, a.n_pilots);
      a.scal[3 * B + b] = ta;
      a.scal[4 * B + b] = have ? __fmul_rn(cfo, a.scs_hz) : __int_as_float(0x7fc00000);
    }
    float c = 1.0f, sn = 0.0f;
    if (a.rotate) {
      const float x = __fmul_rn(__fmul_rn(a.two_pi, cfo), a.sst[s]);
      c = cosf(x);
      sn = sinf(x);
    }
    float* r = a.rot + 2LL * b * a.n_sym + s;
    r[0] = c;
    r[a.n_sym] = sn;
  }
}

__global__ void __launch_bounds__(kMaxThreads) front_finish_kernel(FinishArgs a) {
  extern __shared__ float s_h[];  // (2, nlc, n_re): the group's rows of h, ri-major
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  if (g == 0) finish_scalars(a, b);
  if (a.prof == nullptr) return;

  const int n_cdm = (a.nL + 1) / 2;
  const int h = g / n_cdm;
  const int c = g - h * n_cdm;
  const FinishHop hp = h == 0 ? a.hop[0] : a.hop[1];
  const int l0 = 2 * c;
  const int nlc = min(2, a.nL - l0);
  const int n_re = hp.n_re;
  const int len = nlc * n_re;
  for (int p = 0; p < 2; ++p) {
    const float* src = hp.h + ((2LL * b + p) * a.nL + l0) * n_re;
    for (int i = threadIdx.x; i < len; i += blockDim.x) s_h[p * len + i] = src[i];
  }
  __syncthreads();

  const int nsh = hp.n_sc_hop;
  const int s0 = hp.sc_start;
  const long long tab = static_cast<long long>(c) * nsh;
  const long long row_stride = static_cast<long long>(a.n_hops) * a.nL * a.n_sc;  // one ri
  float* out = a.prof + ((2LL * b * a.n_hops + h) * a.nL + l0) * a.n_sc;
  for (int j0 = 4 * threadIdx.x; j0 < a.n_sc; j0 += 4 * blockDim.x) {
    const int jj0 = j0 - s0;
    const bool in = jj0 >= 0 && jj0 < nsh;  // all four subcarriers in the band, or none
    int4 L = make_int4(0, 0, 0, 0), R = L;
    float4 WL = make_float4(0.0f, 0.0f, 0.0f, 0.0f), WR = WL;
    if (in) {
      L = *reinterpret_cast<const int4*>(hp.left + tab + jj0);
      R = *reinterpret_cast<const int4*>(hp.right + tab + jj0);
      WL = *reinterpret_cast<const float4*>(hp.w_l + tab + jj0);
      WR = *reinterpret_cast<const float4*>(hp.w_r + tab + jj0);
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      for (int l = 0; l < nlc; ++l) {
        const float* s = s_h + (p * nlc + l) * n_re;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (in) {
          v.x = __fadd_rn(__fmul_rn(WL.x, s[L.x]), __fmul_rn(WR.x, s[R.x]));
          v.y = __fadd_rn(__fmul_rn(WL.y, s[L.y]), __fmul_rn(WR.y, s[R.y]));
          v.z = __fadd_rn(__fmul_rn(WL.z, s[L.z]), __fmul_rn(WR.z, s[R.z]));
          v.w = __fadd_rn(__fmul_rn(WL.w, s[L.w]), __fmul_rn(WR.w, s[R.w]));
        }
        *reinterpret_cast<float4*>(out + p * row_stride + static_cast<long long>(l) * a.n_sc +
                                   j0) = v;
      }
    }
  }
}

// Null is not aligned: every pointer this checks is required.
bool aligned16(const void* p) {
  return p != nullptr && (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

}  // namespace

// args: the launch's arguments; prof null is the scalar route. Returns a CUDA
// error code (cudaErrorInvalidValue for arguments the kernel does not take,
// among them, on the profiles route, an n_sc, sc_start or n_sc_hop that is
// not a multiple of 4, or a table or the profiles not 16-byte aligned).
extern "C" int srs_front_finish_f32(const FinishArgs* args, void* stream) {
  if (args == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  FinishArgs a = *args;
  if (a.batch < 1 || a.n_hops < 1 || a.n_hops > kMaxHops || a.nL < 1 || a.n_sc < 1 ||
      a.n_sym < 1 || a.rot == nullptr || a.scal == nullptr || (a.rotate && a.sst == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool prof = a.prof != nullptr;
  if (prof && (a.n_sc % 4 != 0 || !aligned16(a.prof)))
    return static_cast<int>(cudaErrorInvalidValue);
  int max_re = 0;
  for (int h = 0; h < a.n_hops; ++h) {
    const FinishHop& hp = a.hop[h];
    if (hp.sc == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (!prof) continue;
    if (hp.h == nullptr || !aligned16(hp.left) || !aligned16(hp.right) || !aligned16(hp.w_l) ||
        !aligned16(hp.w_r) || hp.n_re < 1 || hp.n_sc_hop < 1 || hp.n_sc_hop % 4 != 0 ||
        hp.sc_start < 0 || hp.sc_start % 4 != 0 || hp.sc_start + hp.n_sc_hop > a.n_sc)
      return static_cast<int>(cudaErrorInvalidValue);
    max_re = max(max_re, hp.n_re);
  }
  const long long smem = prof ? 2LL * min(2, a.nL) * max_re * static_cast<long long>(sizeof(float)) : 0;
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const int cols = a.n_sc / 4;
  const int threads = prof ? min(kMaxThreads, (cols + 31) / 32 * 32) : 32;
  const dim3 grid(static_cast<unsigned>(a.batch),
                  prof ? static_cast<unsigned>(a.n_hops * ((a.nL + 1) / 2)) : 1u);
  front_finish_kernel<<<grid, threads, static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
