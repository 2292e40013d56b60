// K1: fused estimator front for Hopper (sm_90a), f32.
//
// Replaces srsran_ce_tpu/ops/pallas/kernels.py:fused_front (_front_kernel).
// See srsran_ce_tpu_torch/ops/kernels/front.py for the algorithm, the plain
// PyTorch version and the design note.
//
// Inputs, read through element strides (srs_fused_front_strided_f32):
//   rx(b, ri, c, d, k) = rx[b*sb + ri*sri + c*sc + row(c, k)*sk + sym(d)*sd]
//     row(c, k) = re_idx[c * n_re + k], sym(d) = sym_idx[d] (int64 tables),
//     or k and d where a table is null;
//   pil(b, ri, l, d, k) = pil[b*sb + ri*sri + l*sl + d*sd + k*sk].
// Two forms take this one accessor:
//   staged    rx: the received grid (B, 2, n_sc, n_sym) as the caller staged
//             it (sc = 0, sk / sd its subcarrier / symbol strides), the hop's
//             RE table (n_cdm * n_re, group-major) and DM-RS symbol table (nd);
//             pil: the staged pilots (B, 2, n_re, nd_total, nL) from the hop's
//             first symbol d0 on (the pointer offset by d0 * sd, no copy);
//   gathered  rx (B, 2, n_cdm, nd, n_re), pil (B, 2, nL, nd, n_re), null tables.
// Other layouts (all row-major, contiguous):
//   beta (B)                             vp    (n_pils, n_pils), v = vp @ y
//   taps (n_taps, odd): the raised-cosine smoothing filter
//   ta_c / ta_s (k_ta, 2*hcp)
//   two_pi_sst_d (nd): 2*pi * start time of each DM-RS symbol (symbol units)
//   h_out (B, 2, nL, n_re)               sc_out (B, 8) [cfo, ta, noise, rsrp, epre, 0, 0, 0]
// Rows of the working matrices are (problem, ri, l): m = p * 2nL + ri * nL + l.
//
// Work split (make_plan; front.launch_plan mirrors it). A cluster of S blocks
// takes P problems; the P * 2nL rows (<= 32, padded to Mpad in {4, 8, 16, 32})
// are the M of the TA product, whose constant operand is staged once in
// shared memory for all P problems:
//   [tc | ts] = Hs[:, :k_ta] @ [ta_c | ta_s]    bins split over the cluster
//                                               (block r: bins [r*TS, (r+1)*TS))
// Block r keeps only its own columns of H and of Hs (columns [r*NS,
// (r+1)*NS)), k-major (h[k][m]); the product's A operand (KT rows of Hs) is
// read each K step from the block that owns those rows, through distributed
// shared memory, into a two-stage ring (registers in flight across the step's
// FMAs); the B operand comes through a two-stage cp.async ring, 16 bytes a
// copy where aligned. A thread (512 a block) keeps a 4 x RN register tile, one
// 16-byte broadcast giving it its 4 rows. The plan takes the split with the
// fewest FMAs a block among those whose clusters are all resident at once, one
// block an SM (the card's cluster capacities: an H100's GPCs hold 30 clusters
// of 4 blocks, not 33). What crosses the column split goes through
// distributed shared memory, summed in rank order so that every block holds
// the same bits:
//   1. EPRE and the CFO correlations over the block's columns -> cfo, epre;
//   2. H over the block's columns, its CDM pairs averaged in place; the np
//      edge columns of each side from the blocks that own them; every block
//      runs the virtual-pilot atan2 / unwrap / fit itself (identical bits);
//   3. the smoothing of the block's columns: the raised-cosine taps over the
//      extended band [vb | H | flip(ve)], the hw = (n_taps - 1) / 2 columns
//      past its share on each side read from the blocks that own them (n_taps
//      FMAs a row and column; the plan's dense operator, which holds the same
//      filter, would cost n_re + 2 np) -> h_out, the block's noise and RSRP
//      partials (pushed to rank 0);
//   4. the TA product over the block's bins -> the PDP (pushed to rank 0),
//      whose first-maximum argmax rank 0 takes with the scalars.
// The per-problem sums over the block's columns (EPRE, CFO correlations,
// noise, RSRP) run on 512 / P2 threads a problem (P2: P rounded up to a power
// of two), reduced by shuffles and, past a warp, through shared memory.
//
// Semantics kept from the TPU kernel: atan2f keeps IEEE signed zeros
// (atan2(-0, x<0) = -pi); the phase unwrap uses numpy's ddmod convention (a
// wrapped -pi with positive difference maps to +pi); the TA argmax takes the
// first maximum of each window and the head window on a tie (hm >= tm);
// division order sum / beta / nd, and rsrp = (beta^2 * sum) * nd.
//
// Reading the inputs as staged (the TPU kernel took them gathered, having no
// gather hardware): a thread takes a subcarrier column k in each of the three
// passes over the DM-RS (EPRE and CFO, H, noise). With comb 2 and two CDM
// groups its REs are the grid rows 2k and 2k+1, so a warp over 32 consecutive
// k reads one contiguous run of 32 x 2 x n_sym floats a ri plane (3.5 KB at 14
// symbols), every 32-byte sector of it touched: a pass moves the whole grid
// through L2 (18.24 MB at 128 problems of 106 PRB) for the 5.2 MB of DM-RS it
// uses, the three at most ~55 MB from L2; the pilots of one k are nd x nL
// contiguous floats (10.4 MB a pass at nd = nL = 4). What bounds it is the
// L1's requests, not the bytes: a warp's 4-byte read of the staged grid
// touches ~28 cache lines where the gathered one touched 1-2. So each pass
// reads every received value once (pass 2 symbol by symbol, every layer's
// sums still in order of d) and the pilots 16 bytes at a time where the
// layers are contiguous (`pil_vec`): ~1,790 L1 wavefronts a warp's 32 columns
// of a problem over the three passes, against ~3,520 with one 4-byte read a
// value and use. What this replaces: the gather's two index kernels, its
// transpose and the pilots' permute, 91 MB through device memory in four
// launches. FMAs keep their order: only the addresses and the loads differ
// between the two forms, so the outputs are bit-identical.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 16;  // 2 * nL, nL <= 8
constexpr int kMaxL = kMaxRows / 2;
constexpr int kMaxCdm = kMaxL / 2;
constexpr int kMaxPils = 16;
constexpr int kMaxDsym = 32;
constexpr int kMaxM = 32;       // rows of the TA product: P * 2nL
constexpr int kMaxCluster = 8;  // portable cluster size
constexpr int kMaxRN = 4;       // register columns per thread
constexpr int kStages = 2;      // depth of the operand rings
constexpr long long kSmemLimit = 232448 - 1024;  // dynamic shared memory a block may use
constexpr long long kSmemHalf = 233472 / 2 - 1024;  // the most two blocks of an SM may each use
constexpr unsigned kFull = 0xffffffffu;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

struct FrontArgs {
  const float* rx;
  const long long* re_idx;   // row(c, k), or null: k
  const long long* sym_idx;  // sym(d), or null: d
  const float* pil;
  const float* beta;
  const float* vp;
  const float* ta_c;
  const float* ta_s;
  const float* two_pi_sst_d;
  float* h_out;
  float* sc_out;
  long long rx_sb, pil_sb;                // problem strides
  int rx_sri, rx_sc, rx_sd, rx_sk;        // rx: ri, CDM group, symbol, subcarrier row
  int pil_sri, pil_sl, pil_sd, pil_sk;    // pil: ri, layer, symbol, subcarrier
  int pil_vec;  // layers contiguous, nL % 4 == 0, 16-byte aligned: 16-byte loads
  int B, n_cdm, nL, nd, n_re, n_pils, k_ta, hcp;
  int cfo_possible, cfo_compensate;
  float two_pi_ns, fft_size, scs_hz;
  const float* taps;  // the smoothing filter (n_taps, odd)
  int n_taps;
};

struct Plan {
  int P, S, Mpad, RN, KT, NS, TS, blocks;
  long long smem;
  // offsets (floats) of the shared-memory regions
  int o_hv, o_hss, o_as, o_bs, o_pdp, o_p1, o_p1s, o_p2, o_edge, o_cs, o_misc, o_red;
};

constexpr long long pad4(long long x) { return (x + 3) & ~3LL; }

// Shared-memory layout (float offsets into p) of one candidate; returns its
// floats.
long long layout(Plan* p, int P, int S, int Mpad, int NX, int RN, int NS, int TS, int KT,
                 int rows, int np, int nbins) {
  // hl: this block's H columns; once every block's smoothing is done, the
  // same memory holds tcs
  long long o = static_cast<long long>(std::max(NS, 2 * TS)) * Mpad;
  p->o_hv = static_cast<int>(o);
  o += 2LL * np * Mpad;
  p->o_hss = static_cast<int>(o);
  o += static_cast<long long>(NS) * Mpad;
  p->o_as = static_cast<int>(o);
  o += 1LL * kStages * KT * Mpad;
  p->o_bs = static_cast<int>(o);
  o += 1LL * kStages * KT * NX * RN;
  p->o_pdp = static_cast<int>(o);
  o += pad4(static_cast<long long>(P) * nbins);
  p->o_p1 = static_cast<int>(o);
  o += pad4(static_cast<long long>(P) * (rows + 1));
  p->o_p1s = static_cast<int>(o);
  o += pad4(static_cast<long long>(P) * (rows + 1));
  p->o_p2 = static_cast<int>(o);
  o += pad4(2LL * S * P);
  p->o_edge = static_cast<int>(o);
  o += pad4(2LL * Mpad * np);
  p->o_cs = static_cast<int>(o);
  o += pad4(2LL * P * kMaxDsym);
  p->o_misc = static_cast<int>(o);
  o += pad4(3LL * P);
  p->o_red = static_cast<int>(o);
  o += pad4(static_cast<long long>(kWarps) * (rows + 1));
  return o;
}

// The launch of B problems. cap[S - 1]: the clusters of S blocks the card
// holds at once with one block an SM. Among P (problems a cluster, at most 32
// rows) and S (1..8 blocks a cluster) whose clusters are all resident at once
// and whose block fits the shared memory (the largest K tile of 32, 16 or 8
// that does), the one with the fewest FMAs a block, padding included (the
// filter's n_taps a row and column of the block's share and the TA passes of
// W columns over k_ta rows); on a tie the larger P, then the smaller S. If no
// candidate is resident at once, the same search without that condition. RN,
// the register columns a thread, serves the TA product: min(kMaxRN, the TA
// columns over NX), in passes past that. Every launch asks for at least half
// an SM's shared memory, so that a block has its SM to itself. NS and TS are
// multiples of 4 (16-byte copies).
int make_plan(Plan* p, int B, int n_re, int nL, int n_pils, int hcp, int k_ta, const int* cap,
              int n_taps) {
  const int rows = 2 * nL, np = n_pils, nbins = 2 * hcp;
  if (B < 1 || nL < 1 || rows > kMaxRows || np < 1 || np > kMaxPils || n_re < np || hcp < 1 ||
      k_ta < 1 || k_ta > n_re || cap == nullptr || n_taps < 1 || n_taps % 2 == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const bool resident : {true, false}) {
    long long best = -1;
    for (int P = std::min(kMaxM / rows, B); P >= 1; --P) {
      int Mpad = 4;
      while (Mpad < P * rows) Mpad *= 2;
      const int NX = kThreads / (Mpad / 4);
      const int clusters = (B + P - 1) / P;
      for (int S = 1; S <= kMaxCluster; ++S) {
        if (resident && clusters > cap[S - 1]) continue;
        const int NS = ((n_re + S - 1) / S + 3) / 4 * 4;
        const int TS = ((nbins + S - 1) / S + 3) / 4 * 4;
        const int RN = std::min(kMaxRN, (2 * TS + NX - 1) / NX);
        const long long W = static_cast<long long>(NX) * RN;
        const long long cost = Mpad * (1LL * n_taps * NS + (2 * TS + W - 1) / W * W * k_ta);
        if (best >= 0 && cost >= best) continue;
        for (int KT = 32; KT >= 8; KT /= 2) {
          Plan q;
          const long long o = layout(&q, P, S, Mpad, NX, RN, NS, TS, KT, rows, np, nbins);
          if (4 * o > kSmemLimit) continue;
          q.P = P;
          q.S = S;
          q.Mpad = Mpad;
          q.RN = RN;
          q.KT = KT;
          q.NS = NS;
          q.TS = TS;
          q.blocks = clusters * S;
          q.smem = std::max(4 * o, kSmemHalf + 16);
          *p = q;
          best = cost;
          break;
        }
      }
    }
    if (best >= 0) return 0;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Sum of v over each group of tpp consecutive threads (tpp a power of two,
// 16..512), in every thread of the group; red holds kWarps floats.
__device__ float group_sum(float v, int tpp, float* red) {
  if (tpp < 32) {
    for (int o = tpp >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    return v;
  }
  v = warp_sum(v);
  __syncthreads();  // earlier readers of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  const int nw = tpp >> 5, w0 = (threadIdx.x >> 5) / nw * nw;
  float t = 0.f;
  for (int i = 0; i < nw; ++i) t += red[w0 + i];
  return t;
}

// a above b in jnp.argmax's order: a NaN is above every number
__device__ __forceinline__ bool above(float a, float b) {
  return a > b || (isnan(a) && !isnan(b));
}

// First maximum of x[0..n) over one warp: ties go to the smallest index, and
// the first NaN is the maximum (jnp.argmax; the plain front's mathx.argmax_last).
__device__ void warp_first_max(const float* x, int n, float* vmax, int* imax) {
  const int lane = threadIdx.x & 31;
  float bv = -INFINITY;
  int bi = n;  // n: this lane has no candidate yet
  for (int j = lane; j < n; j += 32) {
    const float v = x[j];
    if (bi == n || above(v, bv)) { bv = v; bi = j; }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, bv, o);
    const int oi = __shfl_xor_sync(kFull, bi, o);
    const bool tie = ov == bv || (isnan(ov) && isnan(bv));
    if (oi < n && (bi == n || above(ov, bv) || (tie && oi < bi))) { bv = ov; bi = oi; }
  }
  *vmax = bv;
  *imax = bi;
}

// The pilots of every layer at one symbol of one subcarrier (q: layer 0's
// real part, im: the imaginary part's offset, sl: the layer stride): 16-byte
// loads of 4 layers where `vec` (layers contiguous, nL % 4 == 0, aligned),
// else one float a layer.
__device__ __forceinline__ void load_layers(const float* q, int im, int sl, int nL, bool vec,
                                            float (&pr)[kMaxL], float (&pi)[kMaxL]) {
  if (vec) {
#pragma unroll
    for (int l = 0; l < kMaxL; l += 4) {
      if (l >= nL) break;
      const float4 r = *reinterpret_cast<const float4*>(q + l);
      const float4 i = *reinterpret_cast<const float4*>(q + im + l);
      pr[l] = r.x, pr[l + 1] = r.y, pr[l + 2] = r.z, pr[l + 3] = r.w;
      pi[l] = i.x, pi[l + 1] = i.y, pi[l + 2] = i.z, pi[l + 3] = i.w;
    }
  } else {
#pragma unroll
    for (int l = 0; l < kMaxL; ++l) {
      if (l >= nL) break;
      pr[l] = q[l * sl];
      pi[l] = q[im + l * sl];
    }
  }
}

// Asynchronous copies global -> shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async16z(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// C[m, c] = sum_{k < kpad} A[k][m] * B(k, c) for m < Mpad, c < ncols, in
// passes of W = NX * RN columns. arow(k) gives row k of A (Mpad floats, 16-byte
// aligned, in this block's or another block's shared memory) or nullptr (a
// zero row); bsrc(k, c) gives B's element or nullptr (a zero, also for
// c >= ncols); b_vec: every 4-column chunk of B is 16-byte aligned and in one
// source row (one copy and one bsrc call a chunk; else 4-byte copies where a
// chunk is not); out(m0, c, v) takes rows m0..m0+3 of column c. Both operands go
// through rings of kStages stages (as: KT x Mpad, bs: KT x W), the A
// rows of a stage loaded into registers one stage ahead of their store; a
// thread keeps a 4 x RN register tile: its columns are RN / 4 groups of four
// (4 cx + q 4 NX, one 16-byte read) and RN % 4 single ones.
template <int RN, typename ARow, typename BSrc, typename Out>
__device__ void product(int Mpad, int kpad, int KT, int ncols, bool b_vec, float* as,
                        float* bs, const float* dummy, ARow arow, BSrc bsrc, Out out) {
  const int NY = Mpad >> 2, NX = kThreads / NY;
  const int tid = threadIdx.x, rg = tid / NX, cx = tid - rg * NX;
  constexpr int kQ = RN / 4;  // column groups of 4 a thread reads as one float4
  const int W = NX * RN, nst = kpad / KT, m4 = Mpad >> 2;
  const bool a_thread = tid < KT * m4;  // one float4 of the A tile a thread
  const int a_kk = tid / m4, a_m = (tid - a_kk * m4) * 4;
  for (int p0 = 0; p0 < ncols; p0 += W) {
    const int w4 = (min(W, ncols - p0) + 3) >> 2;  // 4-column chunks of a B row
    const int dk = kThreads / w4, dc = kThreads - dk * w4;
    const int kk0 = tid / w4, cc0 = tid - kk0 * w4;
    float acc[4][RN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
    auto issue_b = [&](int s) {
      float* t = bs + (s % kStages) * KT * W;
      const int k0 = s * KT;
      for (int kk = kk0, cc = cc0; kk < KT; kk += dk, cc += dc) {
        if (cc >= w4) {
          cc -= w4;
          ++kk;
          if (kk >= KT) break;
        }
        const int c = p0 + 4 * cc;
        float* d = t + kk * W + 4 * cc;
        const float* g0 = bsrc(k0 + kk, c);
        if (b_vec) {
          cp_async16z(d, g0 ? g0 : dummy, g0 != nullptr);
          continue;
        }
        const float* g3 = bsrc(k0 + kk, c + 3);
        if (g0 != nullptr && g3 == g0 + 3 && (reinterpret_cast<size_t>(g0) & 15) == 0) {
          cp_async16(d, g0);
        } else {
          for (int i = 0; i < 4; ++i) {
            const float* g = i == 0 ? g0 : i == 3 ? g3 : bsrc(k0 + kk, c + i);
            cp_async4(d + i, g ? g : dummy, g != nullptr);
          }
        }
      }
      cp_async_commit();
    };
    auto load_a = [&](int s) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (a_thread) {
        const float* r = arow(s * KT + a_kk);
        if (r != nullptr) v = *reinterpret_cast<const float4*>(r + a_m);
      }
      return v;
    };
    auto store_a = [&](int s, float4 v) {
      if (a_thread) *reinterpret_cast<float4*>(as + (s % kStages) * KT * Mpad + a_kk * Mpad + a_m) = v;
    };
    // prologue: stages 0 .. kStages-2 in flight (a group per stage, empty
    // past the end, so that wait_group counts stages)
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nst) {
        store_a(s, load_a(s));
        issue_b(s);
      } else {
        cp_async_commit();
      }
    }
    for (int s = 0; s < nst; ++s) {
      const int sn = s + kStages - 1;
      float4 a_next = make_float4(0.f, 0.f, 0.f, 0.f);
      if (sn < nst) {
        issue_b(sn);
        a_next = load_a(sn);
      } else {
        cp_async_commit();
      }
      cp_async_wait<kStages - 1>();
      __syncthreads();
      const float* t = bs + (s % kStages) * KT * W;
      const float* h = as + (s % kStages) * KT * Mpad + rg * 4;
#pragma unroll 8
      for (int kk = 0; kk < KT; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(h + kk * Mpad);
        const float* tk = t + kk * W;
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const float4 b = *reinterpret_cast<const float4*>(tk + q * 4 * NX + 4 * cx);
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[0][4 * q + u] = fmaf(a.x, bv[u], acc[0][4 * q + u]);
            acc[1][4 * q + u] = fmaf(a.y, bv[u], acc[1][4 * q + u]);
            acc[2][4 * q + u] = fmaf(a.z, bv[u], acc[2][4 * q + u]);
            acc[3][4 * q + u] = fmaf(a.w, bv[u], acc[3][4 * q + u]);
          }
        }
#pragma unroll
        for (int j = 4 * kQ; j < RN; ++j) {
          const float b = tk[4 * kQ * NX + cx + (j - 4 * kQ) * NX];
          acc[0][j] = fmaf(a.x, b, acc[0][j]);
          acc[1][j] = fmaf(a.y, b, acc[1][j]);
          acc[2][j] = fmaf(a.z, b, acc[2][j]);
          acc[3][j] = fmaf(a.w, b, acc[3][j]);
        }
      }
      if (sn < nst) store_a(sn, a_next);
      __syncthreads();
    }
    const int w = min(W, ncols - p0);
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int c = j < 4 * kQ ? (j / 4) * 4 * NX + 4 * cx + j % 4 : 4 * kQ * NX + cx + (j - 4 * kQ) * NX;
      if (c < w) out(rg * 4, p0 + c, make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]));
    }
  }
}

// The kernel's body.
template <int RN>
__device__ __forceinline__ void front_body(FrontArgs a, Plan p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int S = p.S, rank = static_cast<int>(cluster.block_rank());
  const int P = p.P, b0 = (blockIdx.x / S) * P, pv = min(P, a.B - b0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_cdm = a.n_cdm, nL = a.nL, nd = a.nd, n_re = a.n_re, np = a.n_pils;
  const int rows = 2 * nL, Mpad = p.Mpad, nbins = 2 * a.hcp, n1 = rows + 1, NS = p.NS;
  const int c0 = min(rank * NS, n_re), ncol = min(c0 + NS, n_re) - c0;
  const int t0 = min(rank * p.TS, nbins), nb_r = min(t0 + p.TS, nbins) - t0;
  // the per-problem sums: tpp threads a problem, problem tid / tpp
  int p2 = 1;
  while (p2 < P) p2 *= 2;
  const int tpp = kThreads / p2, gp = tid / tpp, gj = tid - gp * tpp;

  float* hl = smem;                 // (NS, Mpad): this block's columns of H
  float* hv = smem + p.o_hv;        // (2 np, Mpad): vb, then the flip-fit ve
  float* hss = smem + p.o_hss;      // (NS, Mpad): this block's columns of Hs
  float* as = smem + p.o_as;        // the TA product's A-operand ring
  float* bs = smem + p.o_bs;        // its B-operand ring
  float* tcs = smem;                // (Mpad, 2 TS): this block's tc | ts, over hl
  float* pdp = smem + p.o_pdp;      // (P, nbins), filled on rank 0
  float* p1 = smem + p.o_p1;        // (P, 2nL + 1): CFO correlations, EPRE
  float* p1s = smem + p.o_p1s;      // the same, summed over the cluster
  float* p2s = smem + p.o_p2;       // (S, P, 2): noise, RSRP partials, on rank 0
  float* edge = smem + p.o_edge;    // (2, Mpad, np): the edge columns of H
  float* cs = smem + p.o_cs;        // (P, kMaxDsym, 2): cos, sin of x_d
  float* s_cfo = smem + p.o_misc;
  float* s_epre = s_cfo + P;
  float* s_beta = s_epre + P;
  float* red = smem + p.o_red;      // (kWarps, 2nL + 1): group_sum scratch
  __shared__ int s_sym[kMaxDsym];   // sym(d) * rx_sd

  // rx(ri, c, d, k) of a problem at rx_row(c, k) + s_sym[d] (+ rx_im for the
  // imaginary part); pil(ri, l, d, k) at l * pil_sl + d * pil_sd + k * pil_sk
  const int rx_im = a.rx_sri, pil_im = a.pil_sri, pil_sl = a.pil_sl, pil_sd = a.pil_sd;
  auto rx_row = [&](int c, int k) {
    return c * a.rx_sc + (a.re_idx ? static_cast<int>(__ldg(a.re_idx + c * n_re + k)) : k) * a.rx_sk;
  };

  if (tid < P) s_beta[tid] = tid < pv ? a.beta[b0 + tid] : 1.f;
  if (tid < nd) s_sym[tid] = (a.sym_idx ? static_cast<int>(__ldg(a.sym_idx + tid)) : tid) * a.rx_sd;
  __syncthreads();

  // 1. EPRE and the first-pair CFO correlations over this block's columns;
  // each received value read once (layer l reads CDM group l / 2)
  {
    float e = 0.f, sr[kMaxL], si[kMaxL];
#pragma unroll
    for (int l = 0; l < kMaxL; ++l) sr[l] = si[l] = 0.f;
    if (gp < pv) {
      const float* rx = a.rx + (b0 + gp) * a.rx_sb;
      const float* pil = a.pil + (b0 + gp) * a.pil_sb;
      for (int k = c0 + gj; k < c0 + ncol; k += tpp) {
        float x0r[kMaxCdm], x0i[kMaxCdm], x1r[kMaxCdm], x1i[kMaxCdm];
#pragma unroll
        for (int c = 0; c < kMaxCdm; ++c) {
          if (c >= n_cdm) break;
          const float* xc = rx + rx_row(c, k);
          for (int d = 0; d < nd; ++d) {
            const float xr = xc[s_sym[d]], xi = xc[rx_im + s_sym[d]];
            e += xr * xr + xi * xi;
            if (d == 0) x0r[c] = xr, x0i[c] = xi;
            if (d == 1) x1r[c] = xr, x1i[c] = xi;
          }
        }
        if (a.cfo_possible) {
          float p0r[kMaxL], p0i[kMaxL], p1r[kMaxL], p1i[kMaxL];
          const float* pk = pil + k * a.pil_sk;
          load_layers(pk, pil_im, pil_sl, nL, a.pil_vec, p0r, p0i);
          load_layers(pk + pil_sd, pil_im, pil_sl, nL, a.pil_vec, p1r, p1i);
#pragma unroll
          for (int l = 0; l < kMaxL; ++l) {
            if (l >= nL) break;
            const int cl = l / 2;
            const float ar = x0r[cl] * p0r[l] + x0i[cl] * p0i[l];
            const float ai = x0i[cl] * p0r[l] - x0r[cl] * p0i[l];
            const float er = x1r[cl] * p1r[l] + x1i[cl] * p1i[l];
            const float ei = x1i[cl] * p1r[l] - x1r[cl] * p1i[l];
            sr[l] += ar * er + ai * ei;
            si[l] += ar * ei - ai * er;
          }
        }
      }
    }
    e = group_sum(e, tpp, red);
    if (gj == 0 && gp < P) p1[gp * n1 + rows] = e;
#pragma unroll
    for (int l = 0; l < kMaxL; ++l) {
      if (l >= nL) break;
      const float r_ = group_sum(sr[l], tpp, red), i_ = group_sum(si[l], tpp, red);
      if (gj == 0 && gp < P) {
        p1[gp * n1 + 2 * l] = r_;
        p1[gp * n1 + 2 * l + 1] = i_;
      }
    }
  }
  cluster.sync();

  // cfo and epre of each problem from every block's partials, in rank order;
  // the rotation exp(i x_d), x_d = 2*pi*sst_d*cfo (compensation applies
  // exp(-i x_d), the noise reconstruction exp(+i x_d))
  for (int i = tid; i < P * n1; i += kThreads) {
    float v = 0.f;
    for (int r = 0; r < S; ++r) v += cluster.map_shared_rank(p1, r)[i];
    p1s[i] = v;
  }
  __syncthreads();
  const bool rotate = a.cfo_possible && a.cfo_compensate;
  if (tid < P) {
    const int pp = tid;
    const float* q = p1s + pp * n1;
    float cfo = 0.f;
    if (pp < pv && a.cfo_possible) {
      float acc = 0.f;
      for (int c = 0; c < n_cdm; ++c) {
        float pr = q[4 * c], pi = q[4 * c + 1];
        if (2 * c + 1 < nL) {
          pr += q[4 * c + 2];
          pi += q[4 * c + 3];
        }
        acc += atan2f(pi, pr);
      }
      cfo = acc / a.two_pi_ns / static_cast<float>(n_cdm);
    }
    s_cfo[pp] = cfo;
    s_epre[pp] = pp < pv ? q[rows] : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < P * nd; i += kThreads) {
    const int pp = i / nd, d = i - pp * nd;
    float s = 0.f, co = 1.f;
    if (rotate) sincosf(a.two_pi_sst_d[d] * s_cfo[pp], &s, &co);
    cs[(pp * kMaxDsym + d) * 2] = co;
    cs[(pp * kMaxDsym + d) * 2 + 1] = s;
  }
  __syncthreads();

  // 2. LS de-spread, compensation, time average -> H over this block's columns
  for (int i = tid; i < P * ncol; i += kThreads) {
    const int pp = i / ncol, kk = i - pp * ncol, k = c0 + kk;
    float* hcol = hl + kk * Mpad + pp * rows;
    if (pp >= pv) {
      for (int r = 0; r < rows; ++r) hcol[r] = 0.f;
      continue;
    }
    const float* rx = a.rx + (b0 + pp) * a.rx_sb;
    const float* pk = a.pil + (b0 + pp) * a.pil_sb + k * a.pil_sk;
    const float beta = s_beta[pp];
    const float* csp = cs + pp * kMaxDsym * 2;
    // symbol by symbol, each received value and pilot read once; every
    // layer's sums still run over d in order
    const float* xc[kMaxCdm];
#pragma unroll
    for (int c = 0; c < kMaxCdm; ++c) xc[c] = c < n_cdm ? rx + rx_row(c, k) : rx;
    float sr[kMaxL], si[kMaxL];
#pragma unroll
    for (int l = 0; l < kMaxL; ++l) sr[l] = si[l] = 0.f;
    for (int d = 0; d < nd; ++d) {
      float xr[kMaxCdm], xi[kMaxCdm], pr[kMaxL], pi[kMaxL];
#pragma unroll
      for (int c = 0; c < kMaxCdm; ++c) {
        if (c >= n_cdm) break;
        xr[c] = xc[c][s_sym[d]];
        xi[c] = xc[c][rx_im + s_sym[d]];
      }
      load_layers(pk + d * pil_sd, pil_im, pil_sl, nL, a.pil_vec, pr, pi);
      const float co = csp[2 * d], s = csp[2 * d + 1];
#pragma unroll
      for (int l = 0; l < kMaxL; ++l) {
        if (l >= nL) break;
        const int cl = l / 2;
        const float rr = xr[cl] * pr[l] + xi[cl] * pi[l], ri = xi[cl] * pr[l] - xr[cl] * pi[l];
        sr[l] += rr * co + ri * s;
        si[l] += ri * co - rr * s;
      }
    }
#pragma unroll
    for (int l = 0; l < kMaxL; ++l) {
      if (l >= nL) break;
      hcol[l] = sr[l] / beta / static_cast<float>(nd);
      hcol[nL + l] = si[l] / beta / static_cast<float>(nd);
    }
  }
  const int m_pad = Mpad - P * rows;
  for (int i = tid; i < m_pad * ncol; i += kThreads) {
    const int kk = i / m_pad;
    hl[kk * Mpad + P * rows + i - kk * m_pad] = 0.f;
  }
  for (int i = tid; i < 2 * np * Mpad; i += kThreads) hv[i] = 0.f;
  __syncthreads();
  // the CDM pair average of H in place, this block's pairs (c0 is even; an
  // odd band's last RE stays as it is), then the edges' np columns of it from
  // the blocks that own them
  if (nL >= 2) {
    for (int i = tid; i < (ncol / 2) * Mpad; i += kThreads) {
      const int q = i / Mpad;
      float* h0 = hl + 2 * q * Mpad + (i - q * Mpad);
      const float v = (h0[0] + h0[Mpad]) * 0.5f;
      h0[0] = v;
      h0[Mpad] = v;
    }
  }
  cluster.sync();
  for (int o = tid; o < 2 * Mpad * np; o += kThreads) {
    const int side = o / (Mpad * np), j = (o / Mpad) % np, m = o % Mpad;
    const int k = side ? n_re - np + j : j, r = k / NS;
    edge[(side * Mpad + m) * np + j] = cluster.map_shared_rank(hl, r)[(k - r * NS) * Mpad + m];
  }
  __syncthreads();

  // virtual pilots: one lane per (problem, side, layer) series, serial over
  // n_pils; side 1 fits the reversed right edge (the TPU kernel's flipped
  // pair_r). Rows j (vb) and np + j (flip-fit ve) of hv.
  if (warp == 0 && lane < P * rows) {
    const int pp = lane / rows, side = (lane / nL) % 2, l = lane % nL;
    const int mr = pp * rows + l, mi = pp * rows + nL + l;
    const float* e = edge + side * Mpad * np;
    float* out = hv + side * np * Mpad;
    float vr[kMaxPils], vi[kMaxPils];
    for (int j = 0; j < np; ++j) {
      const int jj = side ? np - 1 - j : j;
      vr[j] = e[mr * np + jj];
      vi[j] = e[mi * np + jj];
    }
    if (np == 1) {
      out[mr] = vr[0];
      out[mi] = vi[0];
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
        out[j * Mpad + mr] = va * co;
        out[j * Mpad + mi] = va * s;
      }
    }
  }
  __syncthreads();

  // 3. smoothing over this block's columns: Hs[:, j] = sum_t taps[t] x[j + np
  // + hw - t] over the extended band x = [vb | pair-averaged H | ve reversed]
  // (zero outside), what the plan's dense operator holds; a column's 2 hw
  // neighbours past this block's share come from the blocks that own them
  float* h_out = a.h_out + static_cast<size_t>(b0) * rows * n_re;
  const int m_valid = pv * rows;
  {
    const int K = a.n_taps, hw = (K - 1) / 2, m4 = Mpad >> 2, n_ext = n_re + 2 * np;
    for (int i = tid; i < ncol * m4; i += kThreads) {
      const int c = i / m4, m0 = (i - c * m4) * 4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int t = 0; t < K; ++t) {
        const int x = c0 + c + np + hw - t;
        if (x < 0 || x >= n_ext) continue;
        const float* src;
        if (x < np) {
          src = hv + x * Mpad;
        } else if (x < np + n_re) {
          const int k = x - np, r = k / NS;
          src = cluster.map_shared_rank(hl, r) + (k - r * NS) * Mpad;
        } else {
          src = hv + (3 * np + n_re - 1 - x) * Mpad;  // ve row np + (np - 1 - (x - np - n_re))
        }
        const float4 v = *reinterpret_cast<const float4*>(src + m0);
        const float w = __ldg(a.taps + t);
        acc.x = fmaf(w, v.x, acc.x);
        acc.y = fmaf(w, v.y, acc.y);
        acc.z = fmaf(w, v.z, acc.z);
        acc.w = fmaf(w, v.w, acc.w);
      }
      *reinterpret_cast<float4*>(hss + c * Mpad + m0) = acc;
      float* o = h_out + static_cast<size_t>(m0) * n_re + c0 + c;
      if (m0 < m_valid) o[0] = acc.x;
      if (m0 + 1 < m_valid) o[n_re] = acc.y;
      if (m0 + 2 < m_valid) o[2 * n_re] = acc.z;
      if (m0 + 3 < m_valid) o[3 * n_re] = acc.w;
    }
  }
  __syncthreads();

  // noise (received pilots minus the reconstruction from Hs) and RSRP over
  // this block's columns, pushed to rank 0
  {
    float npart = 0.f, rpart = 0.f;
    if (gp < pv) {
      const float* rx = a.rx + (b0 + gp) * a.rx_sb;
      const float* pil = a.pil + (b0 + gp) * a.pil_sb;
      const float beta = s_beta[gp];
      const float* csp = cs + gp * kMaxDsym * 2;
      for (int kk = gj; kk < ncol; kk += tpp) {
        const int k = c0 + kk;
        const float* hs = hss + kk * Mpad + gp * rows;
        const float* pk = pil + k * a.pil_sk;
        for (int c = 0; c < n_cdm; ++c) {
          const int l0 = 2 * c, nl = min(l0 + 2, nL) - l0;
          const float* xc = rx + rx_row(c, k);
#pragma unroll 4
          for (int d = 0; d < nd; ++d) {
            const float co = csp[2 * d], s = csp[2 * d + 1];
            // the group's two layers: one 8-byte load a part where vectorised
            const float* q = pk + l0 * pil_sl + d * pil_sd;
            float pr[2], pi[2];
            if (a.pil_vec) {
              const float2 r = *reinterpret_cast<const float2*>(q);
              const float2 i = *reinterpret_cast<const float2*>(q + pil_im);
              pr[0] = r.x, pr[1] = r.y, pi[0] = i.x, pi[1] = i.y;
            } else {
              pr[0] = q[0], pi[0] = q[pil_im];
              if (nl > 1) pr[1] = q[pil_sl], pi[1] = q[pil_im + pil_sl];
            }
            float er = 0.f, ei = 0.f;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              if (j >= nl) break;
              const float hr = hs[l0 + j], hi = hs[nL + l0 + j];
              const float hpr = hr * co - hi * s, hpi = hr * s + hi * co;
              er += beta * (pr[j] * hpr - pi[j] * hpi);
              ei += beta * (pr[j] * hpi + pi[j] * hpr);
            }
            const float dr = xc[s_sym[d]] - er, di = xc[rx_im + s_sym[d]] - ei;
            npart += dr * dr + di * di;
          }
        }
        for (int r = 0; r < rows; ++r) rpart += hs[r] * hs[r];
      }
    }
    npart = group_sum(npart, tpp, red);
    rpart = group_sum(rpart, tpp, red);
    if (gj == 0 && gp < P) {
      float* dst = cluster.map_shared_rank(p2s, 0) + (rank * P + gp) * 2;
      dst[0] = npart;
      dst[1] = rpart;
    }
  }
  cluster.sync();  // every block's Hs columns are complete

  // 4. time alignment: [tc | ts] over this block's bins, then their PDP
  const int two_ts = 2 * p.TS;
  product<RN>(
      Mpad, (a.k_ta + p.KT - 1) / p.KT * p.KT, p.KT, 2 * nb_r, (nbins & 3) == 0, as, bs, a.ta_c,
      [&](int k) -> const float* {
        if (k >= a.k_ta) return nullptr;
        const int r = k / NS;
        return cluster.map_shared_rank(hss, r) + (k - r * NS) * Mpad;
      },
      [&](int k, int c) -> const float* {
        if (k >= a.k_ta || c >= 2 * nb_r) return nullptr;
        return c < nb_r ? a.ta_c + static_cast<size_t>(k) * nbins + t0 + c
                        : a.ta_s + static_cast<size_t>(k) * nbins + t0 + c - nb_r;
      },
      [&](int m0, int c, float4 v) {
        tcs[m0 * two_ts + c] = v.x;
        tcs[(m0 + 1) * two_ts + c] = v.y;
        tcs[(m0 + 2) * two_ts + c] = v.z;
        tcs[(m0 + 3) * two_ts + c] = v.w;
      });
  __syncthreads();
  float* pdp_0 = cluster.map_shared_rank(pdp, 0);
  for (int i = tid; i < pv * nb_r; i += kThreads) {
    const int pp = i / nb_r, t = i - pp * nb_r;
    const float* tc = tcs + pp * rows * two_ts + t;  // row r: tc[r * two_ts], ts at + nb_r
    float pw = 0.f;
    for (int l = 0; l < nL; ++l) {
      const float re = tc[l * two_ts] - tc[(nL + l) * two_ts + nb_r];  // hr@C - hi@S
      const float im = tc[l * two_ts + nb_r] + tc[(nL + l) * two_ts];  // hr@S + hi@C
      pw += re * re + im * im;
    }
    pdp_0[pp * nbins + t0 + t] = pw;
  }
  cluster.sync();  // no block leaves while another may still read its memory

  if (rank != 0) return;
  for (int pp = warp; pp < pv; pp += kWarps) {
    float hm, tm;
    int i_d, i_a;
    warp_first_max(pdp + pp * nbins, a.hcp, &hm, &i_d);
    warp_first_max(pdp + pp * nbins + a.hcp, a.hcp, &tm, &i_a);
    if (lane == 0) {
      const float i_max = hm >= tm ? static_cast<float>(i_d) : -static_cast<float>(a.hcp - i_a);
      float noise = 0.f, hsum = 0.f;
      for (int r = 0; r < S; ++r) {
        noise += p2s[(r * P + pp) * 2];
        hsum += p2s[(r * P + pp) * 2 + 1];
      }
      const float beta = s_beta[pp];
      float* sc = a.sc_out + static_cast<size_t>(b0 + pp) * 8;
      sc[0] = s_cfo[pp];
      sc[1] = i_max / a.fft_size / a.scs_hz;
      sc[2] = noise;
      sc[3] = (beta * beta) * hsum * static_cast<float>(a.nd);
      sc[4] = s_epre[pp];
      sc[5] = 0.f;
      sc[6] = 0.f;
      sc[7] = 0.f;
    }
  }
}

template <int RN>
__global__ void __launch_bounds__(kThreads, 1) front_kernel_banded(FrontArgs a, Plan p) {
  front_body<RN>(a, p);
}

using FrontFn = void (*)(FrontArgs, Plan);
const FrontFn kBandedFns[kMaxRN] = {front_kernel_banded<1>, front_kernel_banded<2>,
                                    front_kernel_banded<3>, front_kernel_banded<4>};

// cap[S - 1]: the clusters of S blocks resident at once, one block an SM, on
// the current device (asked once a device).
int cluster_caps(int* cap) {
  static int cached[16][kMaxCluster];
  static bool have[16];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 16) return static_cast<int>(cudaErrorInvalidDevice);
  if (!have[dev]) {
    e = cudaFuncSetAttribute(kBandedFns[0], cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemLimit));
    for (int S = 1; S <= kMaxCluster && e == cudaSuccess; ++S) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(S);
      cfg.blockDim = dim3(kThreads);
      cfg.dynamicSmemBytes = static_cast<size_t>(kSmemLimit);
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = S;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      e = cudaOccupancyMaxActiveClusters(&cached[dev][S - 1], kBandedFns[0], &cfg);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    have[dev] = true;
  }
  for (int S = 0; S < kMaxCluster; ++S) cap[S] = cached[dev][S];
  return 0;
}

}  // namespace

// out[0..7] = the clusters of 1..8 blocks resident at once on the current
// device, one block an SM (the plan's cap).
extern "C" int srs_front_caps(int* out) { return cluster_caps(out); }

// out[0..8] = P, S, Mpad, RN, KT, NS, TS, blocks, smem of a launch.
extern "C" int srs_front_plan(long long* out, int B, int n_re, int nL, int n_pils, int hcp,
                              int k_ta, const int* cap, int n_taps) {
  Plan p;
  const int bad = make_plan(&p, B, n_re, nL, n_pils, hcp, k_ta, cap, n_taps);
  if (bad != 0) return bad;
  const long long v[9] = {p.P, p.S, p.Mpad, p.RN, p.KT, p.NS, p.TS, p.blocks, p.smem};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

// The launch of both forms. rx_st: rx's element strides (problem, ri, CDM
// group, symbol, subcarrier row), pil_st: pil's (problem, ri, layer, symbol,
// subcarrier); re_idx / sym_idx: the staged form's int64 tables, or null.
// smem_bytes: the plan's shared memory as the caller computed it
// (front.launch_plan); a launch whose caller disagrees with the kernel's own
// plan is refused, and so is a stride past 32 bits after the problem's.
// taps / n_taps: the smoothing filter (n_taps odd).
extern "C" int srs_fused_front_strided_f32(
    const float* rx, const long long* re_idx, const long long* sym_idx,
    const long long* rx_st, const float* pil, const long long* pil_st, const float* beta,
    const float* vp, const float* taps, const float* ta_c, const float* ta_s,
    const float* two_pi_sst_d, float* h_out, float* sc_out, int B, int n_cdm, int nL,
    int nd, int n_re, int n_pils, int k_ta, int hcp, int n_taps, int cfo_possible,
    int cfo_compensate, float two_pi_ns, float fft_size, float scs_hz, int smem_bytes,
    void* stream) {
  if (nd < 1 || nd > kMaxDsym || k_ta < 1 || k_ta > n_re || (cfo_possible && nd < 2) ||
      nL < 1 || nL > kMaxL || n_cdm != (nL + 1) / 2 || taps == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 1; i < 5; ++i)
    if (rx_st[i] < 0 || rx_st[i] > INT_MAX || pil_st[i] < 0 || pil_st[i] > INT_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
  int cap[kMaxCluster];
  int bad = cluster_caps(cap);
  if (bad != 0) return bad;
  Plan p;
  bad = make_plan(&p, B, n_re, nL, n_pils, hcp, k_ta, cap, n_taps);
  if (bad != 0 || smem_bytes != p.smem) return static_cast<int>(cudaErrorInvalidValue);
  const auto i32 = [](long long v) { return static_cast<int>(v); };
  bool pil_vec = pil_st[2] == 1 && nL % 4 == 0 && (reinterpret_cast<size_t>(pil) & 15) == 0;
  for (int i = 0; i < 5; ++i) pil_vec = pil_vec && (i == 2 || pil_st[i] % 4 == 0);
  FrontArgs a{rx, re_idx, sym_idx, pil, beta, vp, ta_c, ta_s, two_pi_sst_d, h_out, sc_out,
              rx_st[0], pil_st[0], i32(rx_st[1]), i32(rx_st[2]), i32(rx_st[3]), i32(rx_st[4]),
              i32(pil_st[1]), i32(pil_st[2]), i32(pil_st[3]), i32(pil_st[4]), pil_vec,
              B, n_cdm, nL, nd, n_re, n_pils, k_ta, hcp,
              cfo_possible, cfo_compensate, two_pi_ns, fft_size, scs_hz, taps, n_taps};
  const FrontFn fn = kBandedFns[p.RN - 1];
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(p.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fn, a, p);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
