// Shared device code of the QC-LDPC min-sum kernels for Hopper (sm_90a):
// K4 (ldpc.cu: flooding and grouped layered, float32 messages) and K3
// (ldpc_stream.cu: grouped layered, float32 or bfloat16 messages). See
// srsran_ce_tpu_torch/ops/kernels/ldpc.py for the plain PyTorch versions,
// the Python mirror of the launch plan (`launch_plan`) and the design note.
//
// Wiring. Edge e is slot t of check row i on variable block j with shift s
// (edges row-major, as LdpcPlan.edges): check lane a of edge e reads variable
// bit j*z + (a + s) mod z, and its message goes back to that bit. Each block
// copies the int32 table [edge_var | edge_shift | row_ptr | col_ptr |
// col_edge] into shared memory once, packed: per edge (j*z) << 16 | s (kPair:
// the byte offset of block j in L << 11 | 4 s, load_wiring_pair), per column
// edge (flooding) i << 21 | t << 16 | s.
//
// Messages as records. Every message that row i stores at lane a is +-r1 or
// +-r2, with r1 = stored(norm * min1) and r2 = stored(norm * min2) ("stored":
// the message type's rounding); slot i1, the first minimum, gets r2, and the
// sign is the parity's times the slot's own. So one record per (row, lane)
// replaces the row's deg messages: {r1, r2} in the message type and one word,
// i1 | message sign bits << 5 (hence kMaxDegree = 27). A negated float32 or
// bfloat16 is exact, so a rebuilt message is the stored one bit for bit, -0.0
// included. The all-zero record is the zero-initialised message set: sweep 0
// reads no record. A row's records are one block of `stride` bytes, the
// {r1, r2} plane and then the word plane, each padded to 16 bytes, so
// neighbouring lanes read neighbouring words.
//
// Routes (make_plan; ldpc.launch_plan mirrors it):
//   kChip    every record in shared memory beside L (and, flooding, the
//            LLRs): the TPU kernel's all-in-VMEM layout. Grouped layered
//            keeps the group's old records in a copy O, and each delta is
//            rebuilt at apply time from the old and the new record.
//   kStream  L in shared memory, the records in a global scratch of
//            mb * stride bytes per codeword, which L2 holds; in the layered
//            sweep each group's rows are one contiguous block there, brought
//            into a double buffer with cp.async one row step ahead (the new
//            records of a group go to the scratch and, for its apply, to a
//            shared copy N).
//   kPair    kStream's records and buffers with two threads a check lane
//            (layered_kernel_pair, check_pair): taken for groups of one row
//            at one codeword a block where 2z <= kPairThreads, at any batch,
//            so kStream's kernel runs groups of several rows (or several
//            codewords a block). A row step is a serial chain (a barrier,
//            the lane's L reads, the two-min fold through every slot, the
//            apply) that one SM's 12 warps at z = 384 do not hide: two
//            threads a lane halve each chain and double the warps, and each
//            thread's slots are unrolled for the row's own count (no branch
//            a slot), so the reads of a row step are in flight together.
//            Over one wave it still wins: kStream's thread takes 100
//            registers at DMAX 27, so its 384-thread blocks do not share an
//            SM either (512 words at 16 sweeps: PERF.md §7 #19).
// A block takes cpb codewords where z is small, so that its lanes fill warps
// while the blocks still cover the SMs where the batch allows; the ragged last
// block is masked. Codes whose state fits neither route are refused.
//
// Arithmetic: every add, subtract and product is __fadd_rn / __fsub_rn /
// __fmul_rn (never contracted into an FMA), in the order of the plain version,
// so the kernels are bit-identical to it. The two-min fold keeps argmin's
// first-minimum tie: strict <, m2 = less ? m1 : min(m2, m). The slot loops
// are unrolled over a compile-time degree bucket DMAX (8, 16 or 27), leaving
// at the row's own degree by a branch, so a row's L reads are independent
// and in flight together and a row costs its degree, not DMAX.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ldpc {

constexpr int kMaxThreads = 512;
// kPair's largest block: two threads a check lane up to z = 384, NR's largest
// lifting size; its launch bound leaves a thread 80 registers (1024 threads
// would leave 64, below what pair_row's 14 slots take)
constexpr int kPairThreads = 768;
constexpr float kBig = 1e30f;          // the JAX package's mask value (never wins a min)
constexpr int kMaxDegree = 27;         // a record word: i1 in 5 bits, one sign bit per slot
constexpr int kMaxRows = 2048;         // a packed column edge holds its row in 11 bits
constexpr long long kSmemLimit = 232448;  // dynamic shared memory of one block (227 KB)

enum Route { kChip = 0, kStream = 1, kPair = 2 };

__host__ __device__ constexpr long long pad16(long long x) { return (x + 15) & ~15LL; }

// Shared memory of the wiring: row_ptr (mb + 1 ints), the packed edge words
// (row-major, as the table's edges), and with `cols` (flooding) col_ptr
// (nb + 1 ints) and the packed column edges.
__host__ __device__ inline long long wiring_bytes(int n_edges, int mb, int nb, bool cols) {
  return pad16(4LL * (mb + 1)) + pad16(4LL * n_edges) +
         (cols ? pad16(4LL * (nb + 1 + n_edges)) : 0);
}

struct SmemWiring {
  const int* row_ptr;
  const unsigned* ew;
  const int* col_ptr;  // flooding: col_ptr (nb + 1), then the packed column edges
  __device__ SmemWiring(const unsigned char* smem, int n_edges, int mb) {
    row_ptr = reinterpret_cast<const int*>(smem);
    ew = reinterpret_cast<const unsigned*>(smem + pad16(4LL * (mb + 1)));
    col_ptr = reinterpret_cast<const int*>(ew + pad16(4LL * n_edges) / 4);
  }
  // row i's packed edges and its degree
  __device__ __forceinline__ const unsigned* row(int i, int& deg) const {
    const int r0 = row_ptr[i];
    deg = row_ptr[i + 1] - r0;
    return ew + r0;
  }
};

// The launch plan of one call; ops/kernels/ldpc.py:launch_plan mirrors it.
struct Plan {
  int route, cpb, threads, blocks;
  int stride, mag_bytes;          // one row's record block; its word plane's offset
  int wiring_bytes, per_cw;       // shared memory: the wiring, then cpb codeword regions
  long long smem, scratch;        // one block's dynamic shared memory; global records per codeword
};

// 0, or cudaErrorInvalidValue when neither route fits one block.
inline int make_plan(Plan* p, int batch, int n_edges, int mb, int nb, int z, int msg_bytes,
                     bool layered, int group, int n_sm) {
  const long long n = static_cast<long long>(nb) * z;
  const long long G = layered ? group : 1;
  p->mag_bytes = static_cast<int>(pad16(2LL * msg_bytes * z));
  p->stride = static_cast<int>(p->mag_bytes + pad16(4LL * z));
  const long long wiring = wiring_bytes(n_edges, mb, nb, !layered);
  const long long Lb = pad16(4 * n);
  const long long S = p->stride;
  const long long chip = Lb + (layered ? 0 : Lb) + mb * S + (layered && G > 1 ? G * S : 0);
  const long long stream = Lb + (layered ? (G > 1 ? 3 : 2) * G * S : 0);
  // threads of one codeword's row step: one a check lane (layered); one a
  // check lane or a bit (flooding)
  const long long lanes = layered ? G * z : (mb * static_cast<long long>(z) > n ? mb * 1LL * z : n);
  long long per;
  if (wiring + chip <= kSmemLimit) {
    p->route = kChip;
    per = chip;
  } else if (wiring + stream <= kSmemLimit) {
    p->route = kStream;
    per = stream;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int c = 1;
  while (wiring + (c + 1) * per <= kSmemLimit && (c + 1) * lanes <= kMaxThreads &&
         (batch + c) / (c + 1) >= n_sm)
    ++c;
  // kPair: the stream route's row step on two threads a check lane, where a
  // block holds one codeword
  const bool pair = layered && G == 1 && p->route == kStream && c == 1 &&
                    2LL * z <= kPairThreads;
  if (pair) p->route = kPair;
  const long long t = ((pair ? 2 : c) * lanes + 31) / 32 * 32;
  p->cpb = c;
  p->threads = static_cast<int>(pair || t < kMaxThreads ? t : kMaxThreads);
  p->blocks = (batch + c - 1) / c;
  p->wiring_bytes = static_cast<int>(wiring);
  p->per_cw = static_cast<int>(per);
  p->smem = wiring + c * per;
  p->scratch = p->route == kChip ? 0 : mb * S;
  return 0;
}

// Validate the launch arguments common to both kernels; 0 or a CUDA error code.
inline int check_launch(int batch, int n_edges, int mb, int nb, int z, int d, int n_iters,
                        int group, const void* tbl) {
  if (batch < 1 || n_edges < 1 || mb < 1 || mb >= kMaxRows || nb < 1 || z < 1 || d < 1 ||
      d > kMaxDegree || n_iters < 0 || group < 1 || group > mb || tbl == nullptr ||
      static_cast<long long>(nb) * z * 4 > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

inline int sm_count(int* n_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(err);
}

// Arguments of every kernel, by value.
struct Args {
  const float* ch;      // (B, n) channel LLRs
  float* out;           // (B, n) posterior
  unsigned char* rec;   // kStream: (B, scratch) bytes of records
  const int* tbl;       // the wiring table
  int batch, n_edges, mb, nb, z, n_iters, group;
  float norm;
  Plan p;
};

// One (row, lane) record in registers: the two stored magnitudes as float32
// and the word i1 | signs << 5.
struct Rec {
  float r1, r2;
  unsigned w;
};

// slot t's message: r2 at the first minimum, r1 elsewhere, its sign bit
// (word bit t + 5) moved onto the float's
__device__ __forceinline__ float msg(const Rec& r, int t) {
  const float m = t == static_cast<int>(r.w & 31u) ? r.r2 : r.r1;
  return __int_as_float(__float_as_int(m) ^ static_cast<int>((r.w << (26 - t)) & 0x80000000u));
}

template <typename M>
struct Store;
template <>
struct Store<float> {
  using Pair = float2;
  __device__ static __forceinline__ float round(float v) { return v; }
  __device__ static __forceinline__ Pair pack(float a, float b) { return make_float2(a, b); }
  __device__ static __forceinline__ float first(Pair p) { return p.x; }
  __device__ static __forceinline__ float second(Pair p) { return p.y; }
};
template <>
struct Store<__nv_bfloat16> {
  using Pair = __nv_bfloat162;
  __device__ static __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static __forceinline__ Pair pack(float a, float b) { return __floats2bfloat162_rn(a, b); }
  __device__ static __forceinline__ float first(Pair p) { return __low2float(p); }
  __device__ static __forceinline__ float second(Pair p) { return __high2float(p); }
};

// lane a's record in a row block (shared or global memory)
template <typename M>
__device__ __forceinline__ Rec load_rec(const unsigned char* row, int mag_bytes, int a) {
  const typename Store<M>::Pair p = reinterpret_cast<const typename Store<M>::Pair*>(row)[a];
  return Rec{Store<M>::first(p), Store<M>::second(p),
             reinterpret_cast<const unsigned*>(row + mag_bytes)[a]};
}

template <typename M>
__device__ __forceinline__ void store_rec(unsigned char* row, int mag_bytes, int a, const Rec& r) {
  reinterpret_cast<typename Store<M>::Pair*>(row)[a] = Store<M>::pack(r.r1, r.r2);
  reinterpret_cast<unsigned*>(row + mag_bytes)[a] = r.w;
}

// Copy the wiring into shared memory (the SmemWiring layout), packed: per
// edge (j*z) << 16 | s; with `cols` (flooding) per column edge
// i << 21 | t << 16 | s, in the table's edge order.
__device__ __forceinline__ void load_wiring(unsigned char* smem, const int* tbl, int n_edges,
                                            int mb, int nb, int z, bool cols) {
  const int* ev = tbl;
  const int* es = tbl + n_edges;
  const int* rp = tbl + 2 * n_edges;
  const int* cp = rp + mb + 1;
  const int* ce = cp + nb + 1;
  int* row_ptr = reinterpret_cast<int*>(smem);
  unsigned* ew = reinterpret_cast<unsigned*>(smem + pad16(4LL * (mb + 1)));
  for (int k = threadIdx.x; k <= mb; k += blockDim.x) row_ptr[k] = rp[k];
  for (int e = threadIdx.x; e < n_edges; e += blockDim.x)
    ew[e] = (static_cast<unsigned>(ev[e] * z) << 16) | static_cast<unsigned>(es[e]);
  if (!cols) return;
  int* col_ptr = reinterpret_cast<int*>(ew + pad16(4LL * n_edges) / 4);
  unsigned* cw = reinterpret_cast<unsigned*>(col_ptr + nb + 1);
  for (int k = threadIdx.x; k <= nb; k += blockDim.x) col_ptr[k] = cp[k];
  for (int k = threadIdx.x; k < n_edges; k += blockDim.x) {
    const int e = ce[k];
    int lo = 0, hi = mb;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (rp[mid] <= e) lo = mid; else hi = mid;
    }
    cw[k] = (static_cast<unsigned>(lo) << 21) | (static_cast<unsigned>(e - rp[lo]) << 16) |
            static_cast<unsigned>(es[e]);
  }
}

// Walks k = k0, k += step over a frame of rows of z lanes, keeping
// (row, lane) = divmod(k, z) with one division in all.
struct Strider {
  int row, lane, drow, dlane, z;
  __device__ __forceinline__ Strider(int z_, int k0, int step) : z(z_) {
    row = k0 / z_;
    lane = k0 - row * z_;
    drow = step / z_;
    dlane = step - drow * z_;
  }
  __device__ __forceinline__ void next() {
    row += drow;
    lane += dlane;
    if (lane >= z) {
      lane -= z;
      ++row;
    }
  }
};

// the L index lane a of an edge (packed j*z << 16 | s) reads: j*z + (a + s) mod z
__device__ __forceinline__ int edge_idx(unsigned e, int a, int z) {
  int q = a + static_cast<int>(e & 0xffffu);
  if (q >= z) q -= z;
  return static_cast<int>(e >> 16) + q;
}

// Check lane a of one row of degree deg (its packed edges `ew`), from the old
// record: v_t = L[bit of slot t] - old message t, the row's two minima and
// sign parity, and the new record. With `apply` (a group of one row) L takes
// new - old at once: each L element of a row is read and written by exactly
// one lane (one shift per (row, column)).
template <typename M, int DMAX>
__device__ __forceinline__ Rec check_lane(float* L, const unsigned* ew, int deg, int z, int a,
                                          float norm, const Rec& old, bool apply) {
  int idx[DMAX];
  float lv[DMAX];
#pragma unroll
  for (int t = 0; t < DMAX; ++t) {
    if (t >= deg) break;  // a branch, so a row costs its own degree, not DMAX
    idx[t] = edge_idx(ew[t], a, z);
    lv[t] = L[idx[t]];
  }
  float m1 = 0.f, m2 = kBig;
  int i1 = 0;
  unsigned negs = 0u;
#pragma unroll
  for (int t = 0; t < DMAX; ++t) {
    if (t >= deg) break;
    const float v = __fsub_rn(lv[t], msg(old, t));
    const float m = fabsf(v);
    negs |= static_cast<unsigned>(v < 0.f) << t;
    if (t == 0) {
      m1 = m;
    } else {
      const bool less = m < m1;
      m2 = less ? m1 : fminf(m2, m);
      i1 = less ? t : i1;
      m1 = less ? m : m1;
    }
  }
  const unsigned par = static_cast<unsigned>(__popc(negs)) & 1u;
  Rec nw;
  nw.r1 = Store<M>::round(__fmul_rn(norm, m1));
  nw.r2 = Store<M>::round(__fmul_rn(norm, m2));
  nw.w = static_cast<unsigned>(i1) | ((par ? negs ^ ((1u << deg) - 1u) : negs) << 5);
  if (apply) {
#pragma unroll
    for (int t = 0; t < DMAX; ++t) {
      if (t >= deg) break;
      L[idx[t]] = __fadd_rn(lv[t], __fsub_rn(msg(nw, t), msg(old, t)));
    }
  }
  return nw;
}

// A deferred apply (groups of several rows): L takes new - old at lane a of
// one row, slot by slot.
template <int DMAX>
__device__ __forceinline__ void apply_lane(float* L, const unsigned* ew, int deg, int z, int a,
                                           const Rec& old, const Rec& nw) {
#pragma unroll
  for (int t = 0; t < DMAX; ++t) {
    if (t >= deg) break;
    float* l = L + edge_idx(ew[t], a, z);
    *l = __fadd_rn(*l, __fsub_rn(msg(nw, t), msg(old, t)));
  }
}

// kPair's wiring: row_ptr as load_wiring writes it, and per edge the byte
// offset from `smem` of its variable block in L (L at `l_off`) << 11 | 4 s
// (offsets below 2^18 and 4 s below 2^11: z <= kPairThreads / 2).
__device__ __forceinline__ void load_wiring_pair(unsigned char* smem, const int* tbl, int n_edges,
                                                 int mb, int z, int l_off) {
  const int* ev = tbl;
  const int* es = tbl + n_edges;
  const int* rp = tbl + 2 * n_edges;
  int* row_ptr = reinterpret_cast<int*>(smem);
  unsigned* ew = reinterpret_cast<unsigned*>(smem + pad16(4LL * (mb + 1)));
  for (int k = threadIdx.x; k <= mb; k += blockDim.x) row_ptr[k] = rp[k];
  for (int e = threadIdx.x; e < n_edges; e += blockDim.x)
    ew[e] = (static_cast<unsigned>(l_off + 4 * ev[e] * z) << 11) | static_cast<unsigned>(4 * es[e]);
}

// kPair: the byte offset from `smem` of the L element that lane a (a4 = 4 a)
// of an edge (load_wiring_pair's word) reads: its block's + 4 ((a + s) mod z),
// the wrap an unsigned min (a4 + 4 s < 8 z, z4 = 4 z)
__device__ __forceinline__ int pair_addr(unsigned e, int a4, int z4) {
  const unsigned q = static_cast<unsigned>(a4) + (e & 0x7ffu);
  return static_cast<int>((e >> 11) + min(q, q - static_cast<unsigned>(z4)));
}

// kPair: slot u of a record seen from slot t0 on: r2 at ri = i1 - t0, r1
// elsewhere, its sign bit u of rs = signs >> t0 moved onto the float's (as
// msg(r, t0 + u), with u known at compile time)
__device__ __forceinline__ float msg_from(float r1, float r2, int ri, unsigned rs, int u) {
  const float m = u == ri ? r2 : r1;
  return __int_as_float(__float_as_int(m) ^ static_cast<int>((rs << (31 - u)) & 0x80000000u));
}

// kPair: check lane a of one row of degree deg (a group of one row) on two
// threads, `half` 0 and 1, partners by lane ^ 1 in one warp (`mask`: the
// warp's threads with a lane), each taking N = (deg + 1) / 2 slots: half 0
// [0, N), half 1 [deg - N, deg). With deg odd the two share slot N - 1,
// which half 1 masks (a magnitude of +inf, no sign, no apply), so that both
// threads of a warp run the same N slots, unrolled with no branch. Each
// thread reads and folds its slots, and the two folds merge by three
// shuffles into the sequential fold's record: m1 is the lower half's unless
// the upper half's is strictly less (the sequential fold keeps the first
// minimum), i1 goes with it, and m2 is the least of the other three values;
// the sign bits are the union of the halves'. Each thread then applies its
// own slots to L. The fold is taken as m1 = min(m1, m), m2 = min(m2,
// max(m1, m)), i1 = m < m1 ? u : i1 (fminf / fmaxf are exact, and a
// magnitude is never -0.0), from m2 = kBig in each half: m2 is then
// min(kBig, every magnitude but the first minimum's), the plain version's
// (check_update) for every magnitude short of NaN, +inf included. The
// sequential fold (check_lane) is the same below kBig (1e30); above it,
// with the first minimum past slot 0, it leaves kBig out. The shared
// slot's read in half 1 goes to smem's first word (row_ptr[0], read-only
// in the sweeps), not to the L element half 0 writes.
template <typename M, int N>
__device__ __forceinline__ Rec pair_row(unsigned char* smem, const unsigned* ew, int deg, int z4,
                                        int a4, int half, unsigned mask, float norm,
                                        const Rec& old) {
  const int t0 = half ? deg - N : 0;
  const bool dup = half && 2 * N != deg;  // half 1's slot 0 is half 0's last
  const unsigned* e = ew + t0;
  const int oi = static_cast<int>(old.w & 31u) - t0;
  const unsigned os = old.w >> (5 + t0);
  int at[N];
  float lv[N], om[N];
#pragma unroll
  for (int u = 0; u < N; ++u) at[u] = pair_addr(e[u], a4, z4);
  if (dup) at[0] = 0;  // masked below: no race with half 0's store
#pragma unroll
  for (int u = 0; u < N; ++u) lv[u] = *reinterpret_cast<const float*>(smem + at[u]);
  float m1 = __int_as_float(0x7f800000), m2 = kBig;
  int i1 = 0;
  unsigned negs = 0u;
#pragma unroll
  for (int u = 0; u < N; ++u) {
    om[u] = msg_from(old.r1, old.r2, oi, os, u);
    const float v = __fsub_rn(lv[u], om[u]);
    float m = fabsf(v);
    if (u == 0 && dup) {
      m = __int_as_float(0x7f800000);
    } else if (v < 0.f) {
      negs |= 1u << u;
    }
    i1 = m < m1 ? u : i1;
    m2 = fminf(m2, fmaxf(m1, m));
    m1 = fminf(m1, m);
  }
  // the partner's fold; its first-minimum slot rides above the sign bits (slots < 27)
  negs <<= t0;
  i1 += t0;
  const float p1 = __shfl_xor_sync(mask, m1, 1);
  const float p2 = __shfl_xor_sync(mask, m2, 1);
  const unsigned pw = __shfl_xor_sync(mask, negs | (static_cast<unsigned>(i1) << 27), 1);
  const float lo1 = half ? p1 : m1, lo2 = half ? p2 : m2;
  const float hi1 = half ? m1 : p1, hi2 = half ? m2 : p2;
  const int lo_i = half ? static_cast<int>(pw >> 27) : i1;
  const int hi_i = half ? i1 : static_cast<int>(pw >> 27);
  const bool less = hi1 < lo1;
  negs |= pw & 0x07ffffffu;
  const unsigned par = static_cast<unsigned>(__popc(negs)) & 1u;
  Rec nw;
  nw.r1 = Store<M>::round(__fmul_rn(norm, less ? hi1 : lo1));
  nw.r2 = Store<M>::round(__fmul_rn(norm, less ? fminf(lo1, hi2) : fminf(lo2, hi1)));
  nw.w = static_cast<unsigned>(less ? hi_i : lo_i) |
         ((par ? negs ^ ((1u << deg) - 1u) : negs) << 5);
  const int ni = static_cast<int>(nw.w & 31u) - t0;
  const unsigned ns = nw.w >> (5 + t0);
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const float l = __fadd_rn(lv[u], __fsub_rn(msg_from(nw.r1, nw.r2, ni, ns, u), om[u]));
    if (u != 0 || !dup) *reinterpret_cast<float*>(smem + at[u]) = l;
  }
  return nw;
}

// kPair's row: pair_row at N = (deg + 1) / 2 slots a thread, N <= DH, the
// half bucket (DMAX + 1) / 2.
template <typename M, int DH>
__device__ __forceinline__ Rec check_pair(unsigned char* smem, const unsigned* ew, int deg, int z4,
                                          int a4, int half, unsigned mask, float norm,
                                          const Rec& old) {
  switch ((deg + 1) >> 1) {
#define LDPC_PAIR_ROW(N)                                                                 \
  case N:                                                                                \
    if constexpr (N <= DH) return pair_row<M, N>(smem, ew, deg, z4, a4, half, mask, norm, old); \
    break;
    LDPC_PAIR_ROW(1) LDPC_PAIR_ROW(2) LDPC_PAIR_ROW(3) LDPC_PAIR_ROW(4) LDPC_PAIR_ROW(5)
    LDPC_PAIR_ROW(6) LDPC_PAIR_ROW(7) LDPC_PAIR_ROW(8) LDPC_PAIR_ROW(9) LDPC_PAIR_ROW(10)
    LDPC_PAIR_ROW(11) LDPC_PAIR_ROW(12) LDPC_PAIR_ROW(13) LDPC_PAIR_ROW(14)
#undef LDPC_PAIR_ROW
  }
  return old;  // not reached: deg <= DMAX <= 2 DH
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {  // all but the newest N groups done
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory of codeword c of a block: L (n floats), then the route's
// records (see the header note).
__device__ __forceinline__ unsigned char* region(unsigned char* smem, const Args& a, int c) {
  return smem + a.p.wiring_bytes + static_cast<size_t>(c) * a.p.per_cw;
}

// kStream: bring the records of rows g0 .. g0 + rows - 1 of the block's
// codewords into buffer `which` (each row block of every codeword is
// contiguous in the scratch and in the buffer: rows * stride bytes, 16-byte
// chunks).
__device__ __forceinline__ void prefetch(unsigned char* smem, const Args& a, int ncw, int b0,
                                         int g0, int rows, int which, long long lb) {
  const int chunks = rows * a.p.stride / 16;
  const size_t buf = lb + static_cast<size_t>(which) * a.group * a.p.stride;
  for (int k = threadIdx.x; k < ncw * chunks; k += blockDim.x) {
    const int c = ncw == 1 ? 0 : k / chunks;
    const int q = k - c * chunks;
    cp_async16(region(smem, a, c) + buf + q * 16,
               a.rec + static_cast<size_t>(b0 + c) * a.p.scratch +
                   static_cast<size_t>(g0) * a.p.stride + q * 16);
  }
}

// All n_iters layered sweeps of the block's codewords: rows in groups of
// `group` sharing one L snapshot. A group of one row applies in its check
// pass; a larger group stores every row's new record first, then applies its
// rows in order, one __syncthreads() apart, each delta rebuilt from the old
// and the new record.
template <typename M, int DMAX, bool STREAM>
__global__ void __launch_bounds__(kMaxThreads, 1) layered_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int z = a.z;
  const int n = a.nb * z;
  const int G = a.group;
  const int S = a.p.stride;
  const int MB = a.p.mag_bytes;
  const SmemWiring wr(smem, a.n_edges, a.mb);
  load_wiring(smem, a.tbl, a.n_edges, a.mb, a.nb, z, false);
  const int b0 = blockIdx.x * a.p.cpb;
  const int ncw = min(a.p.cpb, a.batch - b0);
  const long long lb = pad16(4LL * n);  // region: L, then the records
  for (int k = threadIdx.x; k < ncw * n; k += blockDim.x) {
    const int c = ncw == 1 ? 0 : k / n;
    reinterpret_cast<float*>(region(smem, a, c))[k - c * n] = a.ch[static_cast<size_t>(b0) * n + k];
  }
  __syncthreads();
  const int n_groups = (a.mb + G - 1) / G;
  int step = 0;
  for (int it = 0; it < a.n_iters; ++it) {
    const bool fresh = it == 0;  // no record written yet: all zero
    for (int g = 0; g < n_groups; ++g, ++step) {
      const int g0 = g * G;
      const int rows = min(G, a.mb - g0);
      const int cur = step & 1;  // kStream: the buffer of this step's records
      if (STREAM) {
        if (n_groups > 1) {
          cp_async_wait_group<0>();
          __syncthreads();
          int ng = g + 1, nit = it;  // the next step's group
          if (ng == n_groups) {
            ng = 0;
            ++nit;
          }
          if (nit > 0 && nit < a.n_iters)
            prefetch(smem, a, ncw, b0, ng * G, min(G, a.mb - ng * G), cur ^ 1, lb);
          cp_async_commit();
        } else {  // one group: its records are the ones the last step wrote
          __syncthreads();
          if (!fresh) {
            prefetch(smem, a, ncw, b0, 0, rows, cur, lb);
            cp_async_commit();
            cp_async_wait_group<0>();
          }
          __syncthreads();
        }
      }
      Strider at(z, threadIdx.x, blockDim.x);  // (codeword * rows + group row, lane)
      for (int k = threadIdx.x; k < ncw * rows * z; k += blockDim.x, at.next()) {
        const int c = ncw == 1 ? 0 : at.row / rows;
        const int gi = at.row - c * rows;
        const int lane = at.lane;
        const int i = g0 + gi;
        unsigned char* reg = region(smem, a, c);
        float* L = reinterpret_cast<float*>(reg);
        int deg;
        const unsigned* ew = wr.row(i, deg);
        unsigned char* rrow;  // where the old record is
        if (STREAM)
          rrow = reg + lb + (static_cast<size_t>(cur) * G + gi) * S;
        else
          rrow = reg + lb + static_cast<size_t>(i) * S;
        const Rec old = fresh ? Rec{0.f, 0.f, 0u} : load_rec<M>(rrow, MB, lane);
        const Rec nw = check_lane<M, DMAX>(L, ew, deg, z, lane, a.norm, old, rows == 1);
        if (STREAM) {
          store_rec<M>(a.rec + static_cast<size_t>(b0 + c) * a.p.scratch + static_cast<size_t>(i) * S,
                       MB, lane, nw);
          if (rows > 1) store_rec<M>(reg + lb + (static_cast<size_t>(2) * G + gi) * S, MB, lane, nw);
        } else {
          if (rows > 1) store_rec<M>(reg + lb + (static_cast<size_t>(a.mb) + gi) * S, MB, lane, old);
          store_rec<M>(rrow, MB, lane, nw);
        }
      }
      if (rows > 1) {
        __syncthreads();
        for (int gi = 0; gi < rows; ++gi) {
          const int i = g0 + gi;
          int deg;
          const unsigned* ew = wr.row(i, deg);
          Strider at(z, threadIdx.x, blockDim.x);  // (codeword, lane)
          for (int k = threadIdx.x; k < ncw * z; k += blockDim.x, at.next()) {
            const int c = at.row;
            const int lane = at.lane;
            unsigned char* reg = region(smem, a, c);
            Rec old, nw;
            if (STREAM) {
              old = fresh ? Rec{0.f, 0.f, 0u}
                          : load_rec<M>(reg + lb + (static_cast<size_t>(cur) * G + gi) * S, MB, lane);
              nw = load_rec<M>(reg + lb + (static_cast<size_t>(2) * G + gi) * S, MB, lane);
            } else {
              old = load_rec<M>(reg + lb + (static_cast<size_t>(a.mb) + gi) * S, MB, lane);
              nw = load_rec<M>(reg + lb + static_cast<size_t>(i) * S, MB, lane);
            }
            apply_lane<DMAX>(reinterpret_cast<float*>(reg), ew, deg, z, lane, old, nw);
          }
          __syncthreads();
        }
      } else if (!STREAM) {
        __syncthreads();
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < ncw * n; k += blockDim.x) {
    const int c = ncw == 1 ? 0 : k / n;
    a.out[static_cast<size_t>(b0) * n + k] = reinterpret_cast<const float*>(region(smem, a, c))[k - c * n];
  }
}

// kPair: all n_iters layered sweeps of one codeword a block, rows one at a
// time, on two threads a check lane (check_pair); the records stream through
// the double buffer as on kStream, one row ahead, each of the first S / 16
// threads bringing one 16-byte chunk of the next row's block. ptxas (sm_90a,
// -O3) gives the instantiations of DMAX 27 (pair_row up to 14 slots a
// thread) 75 (bf16) and 78 (f32) registers a thread, DMAX 16 60, DMAX 8 45,
// no spills.
template <typename M, int DMAX>
__global__ void __launch_bounds__(kPairThreads, 1) layered_kernel_pair(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int z = a.z;
  const int n = a.nb * z;
  const int mb = a.mb;
  const int S = a.p.stride;
  using Pair = typename Store<M>::Pair;
  const SmemWiring wr(smem, a.n_edges, mb);
  load_wiring_pair(smem, a.tbl, a.n_edges, mb, z, a.p.wiring_bytes);
  unsigned char* reg = region(smem, a, 0);
  float* L = reinterpret_cast<float*>(reg);
  unsigned char* buf = reg + pad16(4LL * n);  // the two row buffers
  unsigned char* rec = a.rec + static_cast<size_t>(blockIdx.x) * a.p.scratch;  // this codeword's
  for (int k = threadIdx.x; k < n; k += blockDim.x) L[k] = a.ch[static_cast<size_t>(blockIdx.x) * n + k];
  const int lane = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  const bool active = lane < z;
  const unsigned mask = __ballot_sync(0xffffffffu, active);
  const int chunk = 16 * threadIdx.x;  // this thread's chunk of a row block, if < S
  // this lane's record in a row block: its {r1, r2} and its word
  const int rec_pair = static_cast<int>(sizeof(Pair)) * lane;
  const int rec_word = a.p.mag_bytes + 4 * lane;
  unsigned char* my_rec = rec + (half ? rec_word : rec_pair);  // the plane this thread stores
  __syncthreads();
  int step = 0;
  for (int it = 0; it < a.n_iters; ++it) {
    for (int i = 0; i < mb; ++i, ++step) {
      const int cur = step & 1;
      if (mb > 1) {
        cp_async_wait_group<0>();
        __syncthreads();
        const int ni = i + 1 == mb ? 0 : i + 1;  // the next step's row and sweep
        const int nit = i + 1 == mb ? it + 1 : it;
        if (nit > 0 && nit < a.n_iters && chunk < S)
          cp_async16(buf + (cur ^ 1) * S + chunk, rec + static_cast<size_t>(ni) * S + chunk);
        cp_async_commit();
      } else {  // one row: its records are the ones the last step wrote
        __syncthreads();
        if (it > 0) {
          if (chunk < S) cp_async16(buf + cur * S + chunk, rec + chunk);
          cp_async_commit();
          cp_async_wait_group<0>();
        }
        __syncthreads();
      }
      if (active) {
        int deg;
        const unsigned* ew = wr.row(i, deg);
        Rec old{0.f, 0.f, 0u};
        if (it > 0) {
          const unsigned char* row = buf + cur * S;
          const Pair pr = *reinterpret_cast<const Pair*>(row + rec_pair);
          old = Rec{Store<M>::first(pr), Store<M>::second(pr),
                    *reinterpret_cast<const unsigned*>(row + rec_word)};
        }
        const Rec nw = check_pair<M, (DMAX + 1) / 2>(smem, ew, deg, 4 * z, 4 * lane, half, mask,
                                                     a.norm, old);
        // the record's two planes, one a thread (store_rec's two stores)
        unsigned char* dst = my_rec + static_cast<size_t>(i) * S;
        if (half == 0)
          *reinterpret_cast<Pair*>(dst) = Store<M>::pack(nw.r1, nw.r2);
        else
          *reinterpret_cast<unsigned*>(dst) = nw.w;
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += blockDim.x) a.out[static_cast<size_t>(blockIdx.x) * n + k] = L[k];
}

template <typename K>
int launch_kernel(K kernel, const Args& a, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(a.p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<a.p.blocks, a.p.threads, static_cast<size_t>(a.p.smem), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename M, int DMAX>
int launch_layered_bucket(const Args& a, cudaStream_t stream) {
  if (a.p.route == kPair) return launch_kernel(layered_kernel_pair<M, DMAX>, a, stream);
  if (a.p.route == kStream) return launch_kernel(layered_kernel<M, DMAX, true>, a, stream);
  return launch_kernel(layered_kernel<M, DMAX, false>, a, stream);
}

// The layered sweep in the degree bucket of d (the code's largest row degree).
template <typename M>
int launch_layered(const Args& a, int d, cudaStream_t stream) {
  if (d <= 8) return launch_layered_bucket<M, 8>(a, stream);
  if (d <= 16) return launch_layered_bucket<M, 16>(a, stream);
  return launch_layered_bucket<M, kMaxDegree>(a, stream);
}

// Fill Args and its plan, checking the arguments; 0 or a CUDA error code.
inline int make_args(Args* a, const float* ch, float* out, void* rec, const int* tbl, int batch,
                     int n_edges, int mb, int nb, int z, int d, int n_iters, float norm,
                     bool layered, int group, int msg_bytes) {
  int bad = check_launch(batch, n_edges, mb, nb, z, d, n_iters, group, tbl);
  if (bad != 0) return bad;
  int n_sm = 0;
  bad = sm_count(&n_sm);
  if (bad != 0) return bad;
  bad = make_plan(&a->p, batch, n_edges, mb, nb, z, msg_bytes, layered, group, n_sm);
  if (bad != 0) return bad;
  if (a->p.route != kChip && rec == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  a->ch = ch;
  a->out = out;
  a->rec = static_cast<unsigned char*>(rec);
  a->tbl = tbl;
  a->batch = batch;
  a->n_edges = n_edges;
  a->mb = mb;
  a->nb = nb;
  a->z = z;
  a->n_iters = n_iters;
  a->group = layered ? group : 1;
  a->norm = norm;
  return 0;
}

// The plan as seven numbers for the wrapper's tests: route, cpb, threads,
// blocks, smem, scratch, per_cw.
inline int plan_numbers(long long* out, int batch, int n_edges, int mb, int nb, int z,
                        int msg_bytes, int layered, int group, int n_sm) {
  Plan p;
  const int bad = make_plan(&p, batch, n_edges, mb, nb, z, msg_bytes, layered != 0, group, n_sm);
  if (bad != 0) return bad;
  const long long v[7] = {p.route, p.cpb, p.threads, p.blocks, p.smem, p.scratch, p.per_cw};
  for (int k = 0; k < 7; ++k) out[k] = v[k];
  return 0;
}

}  // namespace ldpc
