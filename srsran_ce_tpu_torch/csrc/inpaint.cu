// K7: partial-convolution inpainting stack for Hopper (sm_90a), f32.
//
// Replaces srsran_ce_tpu/ops/pallas/kernels.py:inpaint_stack (_inpaint_kernel).
// See srsran_ce_tpu_torch/ops/kernels/inpaint.py for the plain PyTorch
// version, the route table and the design note.
//
// Per row (one problem's ri channel, n values):
//   transient t:  x = known ? x0 : conv3(x * m_t) * inv_t
//   steady (x `steady`): x = known ? x0 : conv3(x)
//   low-pass:     out = known ? x0 : conv3(conv3(x))
// conv3(v)[i] = 0.25 * v[i-1] + 0.5 * v[i] + 0.25 * v[i+1], summed in that
// order, reflect-padded (v[-1] = v[1], v[n] = v[n-2]). The plain version
// multiplies a steady pass by 1 / (1 + 1e-12), which rounds to 1.0f in
// float32; x * 1 is x, so the kernel leaves the product out.
//
// Layouts (row-major, contiguous): x, out (rows, n); known (n,) 0/1;
// trans (n_transient, 2, n), row t holding (m_t, inv_t).
//
// The row lives in registers: each thread owns S consecutive cells (S a
// template parameter) and a pass reaches the neighbouring threads' edge
// cells by one __shfl_up_sync and one __shfl_down_sync. Each cell's pin is an
// all-ones / all-zeros word applied by one bitwise select (a bitmask would
// need a predicate per cell, which ptxas re-derives every pass once S exceeds
// the 7 predicate registers). Two shapes of launch:
//   * kHalo == 0 (rows of up to 32 S): one row per warp, several rows per
//     block, no block barrier at all;
//   * kHalo > 0 (longer rows): one block per row, each warp's window of
//     32 S cells overlapping its neighbours' by kHalo lanes (H = kHalo S
//     cells) on each side. A window's outermost cells go stale one cell per
//     pass, so a warp runs H passes on shuffles alone, then the boundary lanes
//     swap their cells through shared memory behind one __syncthreads() (two
//     buffers in turn, so no second barrier guards the rewrite).
// The passes between two swaps are unrolled, so ptxas renames the cells'
// registers instead of copying them back at every pass. The steady passes
// come in two copies, with and without the mirror below, and a warp runs the
// one its cells need (only the warp holding cell n-1 mirrors).
// Cells outside [0, n) are pinned padding. The row's first cell sits at a
// lane's first slot and takes its right neighbour as its left one. The
// thread holding cell n-1 reads v[n-2] as its right neighbour: from its own
// slot when n-1 is its last or first slot, else from the padding slot above
// n-1, which a bitwise select keeps equal to v[n-2] after every pass.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpRowsPerBlock = 4;  // one-row-per-warp launches: 128 threads
constexpr int kMaxBlockThreads = 512;
constexpr int kWarpRound = 4;  // passes unrolled together in a one-row-per-warp launch

enum PassKind { kTransient, kSteady, kLowpass1, kLowpass2 };

// 0.25 l + 0.5 c + 0.25 r, each sum rounded apart. The products by 1/4 and
// 1/2 are exact for normal floats, so the FMAs round exactly where
// round(round(0.25 l) + 0.5 c) and the following add do.
__device__ __forceinline__ float conv3(float l, float c, float r) {
  return fmaf(0.25f, r, fmaf(0.25f, l, __fmul_rn(0.5f, c)));
}

__device__ __forceinline__ bool in_row(int g, int n) {
  return static_cast<unsigned>(g) < static_cast<unsigned>(n);
}

// mask ? a : b as one bitwise select on an all-ones / all-zeros word: exact
// for every value. Written as PTX so that ptxas keeps it one LOP3 and does
// not fold the words back into predicates.
__device__ __forceinline__ float pick(unsigned mask, float a, float b) {
  unsigned r;
  asm("lop3.b32 %0, %1, %2, %3, 0xCA;"
      : "=r"(r)
      : "r"(mask), "r"(__float_as_uint(a)), "r"(__float_as_uint(b)));
  return __uint_as_float(r);
}

// A thread's cells and what it knows of them.
template <int S>
struct Cells {
  float v[S];
  unsigned pin[S];  // all ones where the cell is pinned (known, or padding)
  unsigned mir[S];  // all ones at the padding slot above n-1 (1 <= c_hi <= S-2)
  bool has_lo;      // slot 0 holds cell 0
  bool hi_last;     // slot S-1 holds cell n-1
  bool hi_first;    // slot 0 holds cell n-1 (S >= 2)
};

// The padding slot above n-1 takes v[n-2], two slots down.
template <int S>
__device__ __forceinline__ void mirror(Cells<S>& t) {
#pragma unroll
  for (int c = 2; c < S; ++c) t.v[c] = pick(t.mir[c], t.v[c - 2], t.v[c]);
}

// One pass over the thread's S cells at global positions g0 .. g0 + S - 1.
// `keep` is the row before the low-pass (the pinned values of its second
// pass); m_row / inv_row are the transient pass's mask and reciprocal rows.
// kMirror false leaves out the mirror, for a warp that holds no such slot.
template <int S, int kKind, bool kMirror>
__device__ __forceinline__ void run_pass(Cells<S>& t, const float (&keep)[S],
                                         const float* __restrict__ m_row,
                                         const float* __restrict__ inv_row, int g0, int n) {
  float p[S];
  float inv[S];
#pragma unroll
  for (int c = 0; c < S; ++c) {
    if (kKind == kTransient) {
      // the padding slot above n-1 mirrors n-2, its mask too
      const int g = g0 + c, gm = g < n ? g : 2 * n - 2 - g;
      p[c] = __fmul_rn(t.v[c], in_row(gm, n) ? m_row[gm] : 0.0f);
      inv[c] = in_row(g, n) ? inv_row[g] : 0.0f;
    } else {
      p[c] = t.v[c];
    }
  }
  float left = __shfl_up_sync(kFull, p[S - 1], 1);
  float right = __shfl_down_sync(kFull, p[0], 1);
  if (t.has_lo) left = S >= 2 ? p[1] : right;  // reflect: v[-1] = v[1]
  if (t.hi_last) right = S >= 2 ? p[S >= 2 ? S - 2 : 0] : left;  // v[n] = v[n-2]
  float s[S];
#pragma unroll
  for (int c = 0; c < S; ++c) {
    float r = c < S - 1 ? p[c + 1] : right;
    if (c == 0 && S >= 2 && t.hi_first) r = left;  // v[n] = v[n-2]
    s[c] = conv3(c ? p[c - 1] : left, p[c], r);
  }
#pragma unroll
  for (int c = 0; c < S; ++c) {
    float e = s[c];
    if (kKind == kTransient) e = __fmul_rn(e, inv[c]);
    if (kKind == kLowpass1)
      t.v[c] = e;
    else if (kKind == kLowpass2)
      t.v[c] = pick(t.pin[c], keep[c], e);
    else
      t.v[c] = pick(t.pin[c], t.v[c], e);
  }
  if (kMirror) mirror(t);
}

// The boundary lanes' swap. The first and last kHalo core lanes write their
// cells to the block's buffer at li0 (the buffer starts H cells before the
// row's first cell); after the barrier the halo lanes read their neighbour
// warp's cells. Halo cells beyond the row's ends are padding and keep their
// pinned values.
template <int S, int kHalo>
__device__ __forceinline__ void exchange(float (&v)[S], float* buf, int lane, int warp,
                                         int warps, int li0) {
  if ((lane >= kHalo && lane < 2 * kHalo) || (lane >= 32 - 2 * kHalo && lane < 32 - kHalo)) {
#pragma unroll
    for (int c = 0; c < S; ++c) buf[li0 + c] = v[c];
  }
  __syncthreads();
  if ((lane < kHalo && warp > 0) || (lane >= 32 - kHalo && warp < warps - 1)) {
#pragma unroll
    for (int c = 0; c < S; ++c) v[c] = buf[li0 + c];
  }
}

template <int S, int kHalo>
__global__ void __launch_bounds__(kHalo ? kMaxBlockThreads : 32 * kWarpRowsPerBlock)
inpaint_kernel(const float* __restrict__ x, const float* __restrict__ known,
               const float* __restrict__ trans, long long rows, int n, int n_transient,
               int steady, float* __restrict__ out) {
  static_assert(S >= 2 || kHalo == 0, "a halo of one-cell lanes cannot hold its stale cells");
  extern __shared__ float smem[];
  constexpr int H = kHalo * S;
  constexpr int kCore = (32 - 2 * kHalo) * S;
  constexpr int kRound = kHalo ? H : kWarpRound;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  long long row;
  int g0;
  if (kHalo == 0) {
    row = static_cast<long long>(blockIdx.x) * kWarpRowsPerBlock + warp;
    if (row >= rows) return;  // whole warps only: no block barrier follows
    g0 = lane * S;
  } else {
    row = blockIdx.x;
    g0 = warp * kCore - H + lane * S;
  }
  const int li0 = g0 + H;  // the first cell's index in the block's buffer
  const float* xr = x + row * n;
  Cells<S> t;
  const int c_hi = in_row(n - 1 - g0, S) ? n - 1 - g0 : -1;
#pragma unroll
  for (int c = 0; c < S; ++c) {
    const int g = g0 + c;
    const bool real = in_row(g, n);
    t.v[c] = real ? xr[g] : 0.0f;
    t.pin[c] = !real || known[g] > 0.5f ? ~0u : 0u;
    t.mir[c] = c >= 2 && c == c_hi + 1 ? ~0u : 0u;
  }
  t.has_lo = g0 == 0;
  t.hi_last = c_hi == S - 1;
  t.hi_first = S >= 2 && c_hi == 0;
  const bool warp_mirrors = __any_sync(kFull, c_hi >= 1 && c_hi <= S - 2);
  mirror(t);

  float* buf = smem;
  float* buf_next = smem + (kHalo ? warps * kCore + 2 * H : 0);
  int since = 0;  // passes since the window was last whole
  auto swap_halos = [&]() {
    exchange<S, kHalo>(t.v, buf, lane, warp, warps, li0);
    float* tmp = buf; buf = buf_next; buf_next = tmp;
    since = 0;
  };
  auto after_pass = [&]() {
    if (kHalo > 0 && ++since == H) swap_halos();
  };
  float keep[S];
  for (int i = 0; i < n_transient; ++i) {
    const float* m_row = trans + static_cast<long long>(i) * 2 * n;
    run_pass<S, kTransient, true>(t, keep, m_row, m_row + n, g0, n);
    after_pass();
  }
  // whole rounds come in two copies, with and without the mirror; a warp
  // takes one as a whole, and both run the same barriers in the same order
  int left = steady;
  for (; left > 0 && since != 0; --left) {  // close the open round
    run_pass<S, kSteady, true>(t, keep, nullptr, nullptr, g0, n);
    after_pass();
  }
  for (; left >= kRound; left -= kRound) {  // whole rounds, unrolled
    if (warp_mirrors) {
#pragma unroll
      for (int i = 0; i < kRound; ++i) run_pass<S, kSteady, true>(t, keep, nullptr, nullptr, g0, n);
    } else {
#pragma unroll
      for (int i = 0; i < kRound; ++i) run_pass<S, kSteady, false>(t, keep, nullptr, nullptr, g0, n);
    }
    if (kHalo > 0) swap_halos();
  }
  for (; left > 0; --left) {
    run_pass<S, kSteady, true>(t, keep, nullptr, nullptr, g0, n);
    after_pass();
  }
#pragma unroll
  for (int c = 0; c < S; ++c) keep[c] = t.v[c];
  run_pass<S, kLowpass1, true>(t, keep, nullptr, nullptr, g0, n);
  after_pass();
  run_pass<S, kLowpass2, true>(t, keep, nullptr, nullptr, g0, n);
  if (lane >= kHalo && lane < 32 - kHalo) {
    float* o = out + row * n;
#pragma unroll
    for (int c = 0; c < S; ++c)
      if (in_row(g0 + c, n)) o[g0 + c] = t.v[c];
  }
}

using KernelFn = void (*)(const float*, const float*, const float*, long long, int, int, int,
                          float*);

struct Route {
  KernelFn fn;
  int s;
  int halo;
};

// The route table: ids as in ops/kernels/inpaint.py ROUTES.
const Route kRoutes[] = {
    {inpaint_kernel<1, 0>, 1, 0},   {inpaint_kernel<2, 0>, 2, 0},   {inpaint_kernel<3, 0>, 3, 0},
    {inpaint_kernel<4, 0>, 4, 0},   {inpaint_kernel<5, 0>, 5, 0},   {inpaint_kernel<6, 0>, 6, 0},
    {inpaint_kernel<8, 0>, 8, 0},   {inpaint_kernel<10, 0>, 10, 0}, {inpaint_kernel<12, 0>, 12, 0},
    {inpaint_kernel<16, 0>, 16, 0}, {inpaint_kernel<8, 1>, 8, 1},   {inpaint_kernel<16, 1>, 16, 1},
};
constexpr int kNumRoutes = static_cast<int>(sizeof(kRoutes) / sizeof(kRoutes[0]));

}  // namespace

extern "C" int srs_inpaint_num_routes() { return kNumRoutes; }

// Cells one launch of `route` covers in a row (0 for an unknown route).
extern "C" int srs_inpaint_capacity(int route) {
  if (route < 0 || route >= kNumRoutes) return 0;
  const Route& r = kRoutes[route];
  return r.halo ? (kMaxBlockThreads / 32) * (32 - 2 * r.halo) * r.s : 32 * r.s;
}

extern "C" int srs_inpaint_f32(const float* x, const float* known, const float* trans,
                               long long rows, int n, int n_transient, int steady, int route,
                               float* out, void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || n < 3 || n > srs_inpaint_capacity(route) ||
      n_transient < 0 || steady < 0 || (n_transient > 0 && trans == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Route& r = kRoutes[route];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r.halo == 0) {
    const unsigned blocks =
        static_cast<unsigned>((rows + kWarpRowsPerBlock - 1) / kWarpRowsPerBlock);
    r.fn<<<blocks, 32 * kWarpRowsPerBlock, 0, st>>>(x, known, trans, rows, n, n_transient,
                                                    steady, out);
    return static_cast<int>(cudaGetLastError());
  }
  const int core = (32 - 2 * r.halo) * r.s;
  const int warps = (n + core - 1) / core;  // at most kMaxBlockThreads / 32: n <= capacity
  const int smem = 2 * (warps * core + 2 * r.halo * r.s) * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(r.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  r.fn<<<static_cast<unsigned>(rows), 32 * warps, smem, st>>>(x, known, trans, rows, n,
                                                              n_transient, steady, out);
  return static_cast<int>(cudaGetLastError());
}
