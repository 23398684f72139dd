// Batched reliability-ordered GF(2) Gauss-Jordan, and OSD-CS fused onto it,
// for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel `ops/gf2_pallas.py:54`
// `_gj_kernel` (through `ordered_gauss_jordan_pallas`) and, on the main
// path, the XLA elimination `ops/gf2_solve.py:215` `ordered_gauss_jordan_key`
// with the XLA OSD-CS sweep `ops/gf2_solve.py:522` `_osd_sweep_cs_sortless`
// that follows it. Plain versions in this package: `ops/gf2_solve.py:
// ordered_gauss_jordan_key` and `_osd_sweep_cs_sortless`.
//
// Two entry points from one kernel template: `gauss_jordan_key` stores the
// reduced state, pivots and inconsistency flag (FUSED = false);
// `osd_cs_fused` runs the OSD-CS sweep on the reduced state while it is
// still in shared memory and stores only the solution, the OSD-0 solution,
// the least path metric and the flag (FUSED = true).
//
// One block of 256 threads per shot; its packed state [m, W+1] (PCM rows
// with the syndrome word appended) lives in shared memory from load to
// store. A 256-shot bucket is 256 blocks: at ~61 KB a block, three fit an
// SM, so the bucket is one wave on 132 SMs.
//
// Elimination. The pivot of step r is the argmin over live columns of
// (key, column); a column is live iff some unused row holds its bit. A
// dead column stays dead: after row operations its unused-row entries are
// zero iff it lies in the span of the pivot columns so far, and that span
// only grows. So the block sorts its (key, column) pairs once (bitonic, in
// the state's space before the state is loaded; -0.0 is made +0.0 so that
// it ties with +0.0 as `<` and `torch.argmin` have it), and step r takes
// the first live column after step r-1's pivot in sorted order. Each round,
// warp w tests the candidate at sorted position pos + w: its lanes load
// the candidate's word of every row at once (rows lane, lane + 32, ...; KW
// words, fixed at compile time), ballots give the rows holding its bit,
// and the lowest of them that is unused is the pivot row. After one
// barrier every thread takes the first live candidate; a candidate after
// it is tested again next step (it may die). Warp v then holds the pivot
// row in registers (lanes over its W+1 words) and XORs it into the holding
// rows of row word v, and a second barrier ends the step. Two barriers a
// step, no division, and no pass over all columns or rows.
//
// OSD-CS epilogue (FUSED). With w_r = llr[piv_col_r] * (1 - 2 sol_r) on
// pivot row r: pm0 = sum of llr over the OSD-0 support in ascending
// column; a_j = sum over rows holding column j of w_row in ascending row,
// one thread per non-pivot column; pm_w1 = (pm0 + a_j) + llr_j and its
// argmin (ties to the lower column); the order_w most unreliable non-pivot
// columns are the first non-pivot columns of the sorted order; per pair
// the Gram term (rows holding both columns, ascending row) and pm_w2 =
// ((((pm0 + a_i) + a_j) - 2 g) + llr_i) + llr_j, argmin over pairs (ties
// to the lower pair); then the winner's flip of the pivot bits. Every add
// is __fadd_rn/__fsub_rn (no FMA): the plain sweep sums in the same
// orders, so the two are bit-exact. min_pm is the metric of the solution
// taken anew: its support's llr summed in float64 in ascending column
// (__dadd_rn) and rounded once to float32, which stays within rounding of
// the exact value where the float32 candidate sums drift by a few ulps.
//
// Bound. The work is 32-bit integer operations on shared memory (the
// pivot-bit tests and the XORs of the holding rows, ~25 rows of 55 words
// a step at the flagship window) at 64 a clock per SM, and the sweep's
// word tests and float32 adds of the set bits; `chip_smoke.py` counts
// them for the bound (a few hundredths of a ms for a bucket). Device
// memory sees the keys, the syndromes and the outputs once. What sets the
// time is the serial chain of `rank` steps (~230 rounds at the flagship
// window), each a test, two barriers and a few rows XORed in turn, for
// each block; the design keeps that chain short and lets the bucket's
// blocks run side by side.
//
// Cluster route (`gauss_jordan_key_cluster`, `osd_cs_fused_cluster`). A
// shape whose state does not fit one block (more than 512 rows or 127 words
// a row, or over the shared-memory limit: a [[288]] W=4 window of 576x4896,
// the [[144]] global DEM of 936x8784) runs one shot per thread-block
// cluster of C blocks (2, 4 or 8; `ops/gf2_cuda.py:gj_cluster_supported`
// picks the least that fits), each block holding about m/C rows. It
// computes the same function in the same summation orders
// (`gj_cluster_kernel`, below), so it is bit-exact against the plain
// versions as the single-block route is. Its bound is the same count of
// operations; what sets its time is the same serial chain of rounds, each
// now an exchange of posts between the blocks (st.async on mbarriers), two
// block barriers, a pivot row read through distributed shared memory and
// the XOR of the holding rows (PERF.md gives the measured split). At
// ~130-220 KB a block one block fits an SM, so a 256-shot bucket runs in
// waves of as many clusters as the card holds (16 at 936x8784).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowWords = 16;  // rows per shot <= 32 * kRowWords
constexpr int kRowChunks = 4;  // words per row W + 1 <= 32 * kRowChunks
constexpr int kMaxTop = 32;    // order_w the fused entry takes
constexpr int kSlot = kRowWords + 1;  // per warp and round: pivot row, holding rows

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

__host__ __device__ inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Byte offsets of the shared-memory arrays of one block. The first region
// holds the sort's (key, column) pairs, then the state. `ops/gf2_cuda.py:
// smem_bytes` computes the same total.
struct Layout {
  size_t st, ord, pcol, prow, test, a, wrow, masks, total;
};

__host__ __device__ inline Layout make_layout(int m, int n, int W, bool fused) {
  Layout L;
  size_t o = 0;
  const size_t state = (size_t)m * (W + 1) * 4, sort = (size_t)next_pow2(n) * 8;
  L.st = o;    o = align16(o + (state > sort ? state : sort));
  L.ord = o;   o = align16(o + (size_t)n * 2);
  L.pcol = o;  o = align16(o + (size_t)m * 2);
  L.prow = o;  o = align16(o + (size_t)m * 2);
  L.test = o;  o = align16(o + (size_t)2 * kWarps * kSlot * 4);
  L.a = L.wrow = L.masks = o;
  if (fused) {
    L.a = o;     o = align16(o + (size_t)n * 4);
    L.wrow = o;  o = align16(o + (size_t)m * 4);
    L.masks = o; o = align16(o + (size_t)W * 3 * 4);
  }
  L.total = o;
  return L;
}

struct Args {
  const uint32_t* H;     // [m, W] packed PCM rows
  const uint8_t* synd;   // [B, m]
  const float* keys;     // [B, n]
  uint8_t* incons;       // [B]
  // gauss_jordan_key
  uint32_t* state_out;   // [B, m, W+1]
  int32_t* pcol_out;     // [B, rank]
  int32_t* prow_out;     // [B, rank]
  // osd_cs_fused
  const float* llr;      // [n]
  const int32_t* pair_i; // [P]
  const int32_t* pair_j; // [P]
  uint8_t* solution;     // [B, n]
  uint8_t* osd0;         // [B, n]
  float* min_pm;         // [B]
  int m, n, W, rank, order_w, npairs;
};

// (value, index) argmin across the block, ties to the lower index. Every
// thread returns the result; contains one barrier and reuses `red_v`/`red_i`
// only after the caller's next barrier.
__device__ __forceinline__ void block_argmin(float& v, int& i, float* red_v, int* red_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = i;
  }
  __syncthreads();
  v = red_v[0];
  i = red_i[0];
  for (int w = 1; w < kWarps; ++w) {
    const float ov = red_v[w];
    const int oi = red_i[w];
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// The block's columns in (key, column) order into `ord` [n]: a bitonic sort
// of (key bits made unsigned-ordered, column) pairs in `pairs`
// [next_pow2(n)], -0.0 made +0.0 first. Ends with a barrier.
__device__ void sort_columns(const float* keys, int n, unsigned long long* pairs,
                             uint16_t* ord) {
  const int tid = threadIdx.x, np2 = next_pow2(n);
  for (int j = tid; j < np2; j += kThreads) {
    unsigned long long v = ~0ull;  // padding sorts last
    if (j < n) {
      const float k = keys[j];
      uint32_t u = __float_as_uint(k == 0.f ? 0.f : k);
      u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
      v = ((unsigned long long)u << 32) | (unsigned)j;
    }
    pairs[j] = v;
  }
  __syncthreads();
  for (int size = 2; size <= np2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = tid; p < (np2 >> 1); p += kThreads) {
        const int lo = 2 * p - (p & (stride - 1)), hi = lo + stride;
        const unsigned long long x = pairs[lo], y = pairs[hi];
        if ((x > y) == ((lo & size) == 0)) {
          pairs[lo] = y;
          pairs[hi] = x;
        }
      }
      __syncthreads();
    }
  }
  for (int j = tid; j < n; j += kThreads) ord[j] = (uint16_t)(pairs[j] & 0xffffu);
  __syncthreads();
}

// Warp 0: the `order_w` first non-pivot columns of the sorted order into
// `top` (32 positions a ballot).
__device__ void top_nonpivot(const uint16_t* ord, int n, const uint32_t* pivm, int order_w,
                             int* top) {
  const int lane = threadIdx.x & 31;
  int got = 0;
  for (int p0 = 0; p0 < n && got < order_w; p0 += 32) {
    const int p = p0 + lane;
    const int j = p < n ? ord[p] : 0;
    uint32_t x = __ballot_sync(0xffffffffu, p < n && !((pivm[j >> 5] >> (j & 31)) & 1u));
    while (x && got < order_w) {
      const int src = __ffs(x) - 1;
      x &= x - 1;
      const int jj = __shfl_sync(0xffffffffu, j, src);
      if (lane == 0) top[got] = jj;
      ++got;
    }
  }
}

// OSD-CS's winner: whether a candidate beats OSD-0, whether it is a pair,
// and its column(s).
struct Winner {
  bool use, is_pair;
  int c1, c2;
};

// The sum of `llr` over the columns set in `mask` [W], in ascending column
// from +0.0 (pm0, the OSD-0 metric). One thread.
__device__ float support_sum(const uint32_t* mask, int W, const float* llr) {
  float acc = 0.f;
  for (int w = 0; w < W; ++w)
    for (uint32_t x = mask[w]; x; x &= x - 1) acc = __fadd_rn(acc, llr[32 * w + __ffs(x) - 1]);
  return acc;
}

// The OSD-CS candidates and their winner: weight 1, every non-pivot column
// j at pm_w1 = (pm0 + a_j) + llr_j, ties to the lower column; weight 2, the
// pairs of `top` at ((((pm0 + a_i) + a_j) - 2 g) + llr_i) + llr_j with
// g = gram(p, i, j), ties to the lower pair. Sets the solution's support in
// `solm` [W] as it is before the pivot bits flip (OSD-0's if no candidate
// beats it). Every thread returns the winner; contains barriers.
template <typename Gram>
__device__ Winner pick_winner(const Args& a, int n, int W, float pm0, const uint32_t* pivm,
                              const uint32_t* osdm, const float* aj, const int* top, Gram gram,
                              uint32_t* solm, float* red_v, int* red_i) {
  const int tid = threadIdx.x;
  float best1 = INFINITY;
  int col1 = n;
  for (int j = tid; j < n; j += kThreads) {
    if ((pivm[j >> 5] >> (j & 31)) & 1u) continue;
    const float pm = __fadd_rn(__fadd_rn(pm0, aj[j]), a.llr[j]);
    if (pm < best1) {  // j grows within a thread: ties keep the lower j
      best1 = pm;
      col1 = j;
    }
  }
  block_argmin(best1, col1, red_v, red_i);
  __syncthreads();
  float best2 = INFINITY;
  int pair = a.npairs;
  for (int p = tid; p < a.npairs; p += kThreads) {
    const int ci = top[a.pair_i[p]], cj = top[a.pair_j[p]];
    float pm = __fadd_rn(__fadd_rn(pm0, aj[ci]), aj[cj]);
    pm = __fsub_rn(pm, __fmul_rn(2.f, gram(p, ci, cj)));
    pm = __fadd_rn(__fadd_rn(pm, a.llr[ci]), a.llr[cj]);
    if (pm < best2) {
      best2 = pm;
      pair = p;
    }
  }
  block_argmin(best2, pair, red_v, red_i);
  Winner win;
  win.is_pair = best2 < best1;
  win.use = (win.is_pair ? best2 : best1) < pm0;
  win.c1 = win.is_pair ? top[a.pair_i[pair]] : col1;
  win.c2 = win.is_pair ? top[a.pair_j[pair]] : -1;
  for (int w = tid; w < W; w += kThreads) {
    uint32_t x = win.use ? 0u : osdm[w];
    if (win.use && (win.c1 >> 5) == w) x |= 1u << (win.c1 & 31);
    if (win.is_pair && win.use && (win.c2 >> 5) == w) x |= 1u << (win.c2 & 31);
    solm[w] = x;
  }
  return win;
}

// The fused entry's stores for shot b: the OSD-0 and solution bytes, and
// min_pm, the solution's metric taken anew (its support's llr summed in
// float64 in ascending column, rounded once).
__device__ void store_solution(const Args& a, int b, int n, int W, const uint32_t* osdm,
                               const uint32_t* solm) {
  uint8_t* sol_out = a.solution + (long long)b * n;
  uint8_t* osd0_out = a.osd0 + (long long)b * n;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    osd0_out[j] = (uint8_t)((osdm[j >> 5] >> (j & 31)) & 1u);
    sol_out[j] = (uint8_t)((solm[j >> 5] >> (j & 31)) & 1u);
  }
  if (threadIdx.x == 0) {
    double acc = 0.0;
    for (int w = 0; w < W; ++w)
      for (uint32_t x = solm[w]; x; x &= x - 1)
        acc = __dadd_rn(acc, (double)a.llr[32 * w + __ffs(x) - 1]);
    a.min_pm[b] = __double2float_rn(acc);
  }
}

// One warp's test of column j on the block's `rows` rows of the state `st`
// (KW row words, fixed at compile time so that the warp issues all its
// loads at once): lane k gets in `mine` the rows of word k holding bit j;
// returns the lowest of them that is unused (-1: none), on every lane.
template <int KW>
__device__ int test_column(const uint32_t* st, int Wp1, int rows, const uint32_t* unused, int j,
                           uint32_t& mine) {
  const int lane = threadIdx.x & 31, jw = j >> 5, js = j & 31;
  uint32_t v[KW];
#pragma unroll
  for (int k = 0; k < KW; ++k) {
    const int i = 32 * k + lane;
    v[k] = i < rows ? st[i * Wp1 + jw] : 0u;
  }
  mine = 0;
#pragma unroll
  for (int k = 0; k < KW; ++k) {
    const uint32_t h = __ballot_sync(0xffffffffu, (v[k] >> js) & 1u);
    if (lane == k) mine = h;
  }
  const uint32_t live = lane < KW ? mine & unused[lane] : 0u;
  const uint32_t words = __ballot_sync(0xffffffffu, live != 0u);
  if (!words) return -1;
  const int k = __ffs(words) - 1;
  return 32 * k + __ffs(__shfl_sync(0xffffffffu, live, k)) - 1;
}

// KW: the row words a candidate's test covers (8 for m <= 256, else 16),
// fixed at compile time so that a warp issues all its loads at once.
template <bool FUSED, int KW>
__global__ void __launch_bounds__(kThreads) gj_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m = a.m, n = a.n, W = a.W, Wp1 = W + 1, rank = a.rank;
  const Layout L = make_layout(m, n, W, FUSED);
  uint32_t* st = (uint32_t*)(smem + L.st);                      // [m, W+1]
  unsigned long long* pairs = (unsigned long long*)(smem + L.st);  // sort only
  uint16_t* ord = (uint16_t*)(smem + L.ord);                     // [n]
  uint16_t* pcol = (uint16_t*)(smem + L.pcol);                   // [rank]
  uint16_t* prow = (uint16_t*)(smem + L.prow);
  int* test = (int*)(smem + L.test);  // [2 rounds][kWarps][kSlot]
  __shared__ uint32_t unused[kRowWords];  // the rows not yet pivot rows
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];

  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = (m + 31) >> 5;

  // 1. sort (key, column) once
  sort_columns(a.keys + (long long)b * n, n, pairs, ord);

  // 2. the packed state
  for (int e = tid; e < m * Wp1; e += kThreads) {
    const int i = e / Wp1, w = e - i * Wp1;
    st[e] = (w < W) ? a.H[i * W + w] : (uint32_t)(a.synd[(long long)b * m + i] & 1);
  }
  if (tid < kRowWords) {
    const int rows = m - 32 * tid;
    unused[tid] = rows >= 32 ? 0xffffffffu : (rows > 0 ? (1u << rows) - 1u : 0u);
  }
  __syncthreads();

  // 3. the pivot steps
  int pos = 0, r = 0, round = 0;
  while (r < rank && pos < n) {
    int* buf = test + (round & 1) * kWarps * kSlot;
    ++round;
    const int c = pos + warp;
    int first = -1;
    if (c < n) {
      uint32_t mine;  // lane k: the rows of word k that hold the column's bit
      first = test_column<KW>(st, Wp1, m, unused, ord[c], mine);
      if (lane < K) buf[warp * kSlot + 1 + lane] = (int)mine;
    }
    if (lane == 0) buf[warp * kSlot] = first;
    __syncthreads();

    int win = -1, piv = -1;
    for (int w = 0; w < kWarps; ++w) {
      const int f = buf[w * kSlot];
      if (f >= 0) {
        win = w;
        piv = f;
        break;
      }
    }
    if (win < 0) {  // every candidate of this round is dead
      pos += kWarps;
      continue;
    }
    if (warp < K) {
      uint32_t pr[kRowChunks];  // the pivot row, lanes over its words
#pragma unroll
      for (int q = 0; q < kRowChunks; ++q) {
        const int w = 32 * q + lane;
        pr[q] = w < Wp1 ? st[piv * Wp1 + w] : 0u;
      }
      for (int k = warp; k < K; k += kWarps) {
        uint32_t h = (uint32_t)buf[win * kSlot + 1 + k];
        if (k == (piv >> 5)) h &= ~(1u << (piv & 31));
        while (h) {
          uint32_t* row = st + (32 * k + __ffs(h) - 1) * Wp1;
          h &= h - 1;
#pragma unroll
          for (int q = 0; q < kRowChunks; ++q) {
            const int w = 32 * q + lane;
            if (w < Wp1) row[w] ^= pr[q];
          }
        }
      }
    }
    if (tid == 0) {
      unused[piv >> 5] &= ~(1u << (piv & 31));  // read again after the barrier
      pcol[r] = ord[pos + win];
      prow[r] = (uint16_t)piv;
    }
    ++r;
    pos += win + 1;
    __syncthreads();
  }

  // a syndrome bit left on an unused row: outside the pivot span
  int left = 0;
  for (int i = tid; i < m; i += kThreads)
    left |= (int)(((unused[i >> 5] >> (i & 31)) & 1u) && (st[i * Wp1 + W] & 1u));
  left = __syncthreads_or(left);
  if (tid == 0) a.incons[b] = (uint8_t)(left != 0);

  if (!FUSED) {
    uint32_t* out = a.state_out + (long long)b * m * Wp1;
    for (int e = tid; e < m * Wp1; e += kThreads) out[e] = st[e];
    for (int t = tid; t < rank; t += kThreads) {
      a.pcol_out[(long long)b * rank + t] = t < r ? pcol[t] : -1;
      a.prow_out[(long long)b * rank + t] = t < r ? prow[t] : -1;
    }
    return;
  }

  // 4. OSD-CS sweep on the reduced state
  float* aj = (float*)(smem + L.a);       // [n]
  float* wrow = (float*)(smem + L.wrow);  // [m], 0 on non-pivot rows
  uint32_t* pivm = (uint32_t*)(smem + L.masks);  // [W] pivot columns
  uint32_t* osdm = pivm + W;                     // [W] OSD-0 support
  uint32_t* solm = osdm + W;                     // [W] the solution's support
  __shared__ float s_pm0;
  __shared__ int s_top[kMaxTop];

  for (int w = tid; w < 2 * W; w += kThreads) pivm[w] = 0u;
  for (int i = tid; i < m; i += kThreads) wrow[i] = 0.f;
  __syncthreads();
  for (int t = tid; t < r; t += kThreads) {
    const int j = pcol[t], i = prow[t];
    const bool sol = st[i * Wp1 + W] & 1u;
    const float l = a.llr[j];
    wrow[i] = sol ? -l : l;
    atomicOr(&pivm[j >> 5], 1u << (j & 31));
    if (sol) atomicOr(&osdm[j >> 5], 1u << (j & 31));
  }
  __syncthreads();

  // pm0 (one thread, ascending column), the order_w most unreliable
  // non-pivot columns (warp 0) and a_j (a thread per column)
  if (tid == 0) s_pm0 = support_sum(osdm, W, a.llr);
  if (warp == 0) top_nonpivot(ord, n, pivm, a.order_w, s_top);
  for (int j = tid; j < n; j += kThreads) {
    const int jw = j >> 5, js = j & 31;
    if ((pivm[jw] >> js) & 1u) continue;
    float acc = 0.f;
#pragma unroll 8
    for (int i = 0; i < m; ++i)
      if ((st[i * Wp1 + jw] >> js) & 1u) acc = __fadd_rn(acc, wrow[i]);
    aj[j] = acc;
  }
  __syncthreads();

  // the winner (a pair's Gram term: its rows holding both columns, in
  // ascending row), then the flips of the pivot bits
  const auto gram = [&](int, int ci, int cj) {
    const int iw = ci >> 5, is = ci & 31, jw = cj >> 5, js = cj & 31;
    float g = 0.f;
    for (int i = 0; i < m; ++i) {
      const uint32_t* row = st + i * Wp1;
      if ((row[iw] >> is) & (row[jw] >> js) & 1u) g = __fadd_rn(g, wrow[i]);
    }
    return g;
  };
  const Winner win = pick_winner(a, n, W, s_pm0, pivm, osdm, aj, s_top, gram, solm, red_v, red_i);
  __syncthreads();
  if (win.use) {
    for (int t = tid; t < r; t += kThreads) {
      const uint32_t* row = st + prow[t] * Wp1;
      uint32_t y = (row[W] & 1u) ^ ((row[win.c1 >> 5] >> (win.c1 & 31)) & 1u);
      if (win.is_pair) y ^= (row[win.c2 >> 5] >> (win.c2 & 31)) & 1u;
      if (y) atomicOr(&solm[pcol[t] >> 5], 1u << (pcol[t] & 31));
    }
  }
  __syncthreads();
  store_solution(a, b, n, W, osdm, solm);
}

// ---------------------------------------------------------------------------
// The cluster route: one shot per thread-block cluster of C blocks
// ---------------------------------------------------------------------------

constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kMaxPairs = kMaxTop * (kMaxTop - 1) / 2;
constexpr int kCand = 2;                // candidates a warp tests each round
constexpr int kRound = kWarps * kCand;  // candidates a round
constexpr int kRowVec = 4;              // 16-byte chunks of the pivot row a lane holds
constexpr int kMaxStride = 32 * kRowVec * 4;  // words a row of a cluster block may span

// Rows of the packed state a block of a C-block cluster holds.
__host__ __device__ inline int cluster_rows(int m, int C) { return (m + C - 1) / C; }

// Words from one row of a cluster block's state to the next: W + 1 rounded
// up to a multiple of 4, so that every row starts on 16 bytes.
__host__ __device__ inline int cluster_stride(int W) { return (W + 4) & ~3; }

// Byte offsets of one cluster block's shared-memory arrays: its rows of the
// state (or the sort's pairs, which come first), the whole sorted order and
// pivot lists, the round posts its peers write (two rounds), the holding-row
// masks of its candidates and, when fused, the running column and pair
// sums, the weights of its rows and four column masks. `ops/gf2_cuda.py:
// cluster_smem_bytes` computes the same total.
struct ClusterLayout {
  size_t st, ord, pcol, prow, post, hold, a, gram, wrow, masks, total;
};

__host__ __device__ inline ClusterLayout make_cluster_layout(int m, int n, int W, int C,
                                                             bool fused) {
  ClusterLayout L;
  size_t o = 0;
  const size_t state = (size_t)cluster_rows(m, C) * cluster_stride(W) * 4,
               sort = (size_t)next_pow2(n) * 8;
  L.st = o;     o = align16(o + (state > sort ? state : sort));
  L.ord = o;    o = align16(o + (size_t)n * 2);
  L.pcol = o;   o = align16(o + (size_t)m * 2);
  L.prow = o;   o = align16(o + (size_t)m * 2);
  L.post = o;   o = align16(o + (size_t)2 * kMaxCluster * kRound * 4);
  L.hold = o;   o = align16(o + (size_t)kRound * kRowWords * 4);
  L.a = L.gram = L.wrow = L.masks = o;
  if (fused) {
    L.a = o;     o = align16(o + (size_t)n * 4);
    L.gram = o;  o = align16(o + (size_t)kMaxPairs * 4);
    L.wrow = o;  o = align16(o + (size_t)cluster_rows(m, C) * 4);
    L.masks = o; o = align16(o + (size_t)W * 4 * 4);
  }
  L.total = o;
  return L;
}

// Cluster-scope signalling: a round's posts travel as st.async stores
// into each peer's shared memory that complete bytes on the peer's
// mbarrier; the peer waits on its own barrier's phase.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ uint32_t cluster_addr(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void st_async2(uint32_t addr, int v0, int v1, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];" ::"r"(
          addr),
      "r"(v0), "r"(v1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n"
      "DONE:\n\t}" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The position of the k-th (from 0) set bit of x; x holds more than k.
__device__ __forceinline__ int nth_bit(uint32_t x, int k) {
  int p = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const int c = __popc(x & ((1u << s) - 1u));
    if (k >= c) {
      k -= c;
      x >>= s;
      p += s;
    }
  }
  return p;
}

// The elimination and sweep of `gj_kernel` for shapes beyond one block's
// shared memory. Block q of the cluster holds global rows [q R, q R + R) of
// the state (R = cluster_rows; rows cluster_stride(W) words apart), so
// ascending global row is ascending (block, local row). Each block sorts
// the same (key, column) pairs and keeps the whole order and pivot lists.
//
// A round. Warp w tests candidates pos + w and pos + w + 8 (kRound = 16 a
// round) on the block's own rows: the rows holding each candidate's bit
// go to the block's `hold` masks, and the lowest unused one (its global
// index, or -1) is sent with the warp's other candidate's as one 8-byte
// st.async into this round's `post` buffer of every block of the cluster,
// where it completes 8 bytes on that block's mbarrier for the round. Each
// block waits for its barrier's phase, which completes when all C * 16
// posts have landed (its thread 0 arms it with that many bytes), then for
// its own warps (a block barrier: the `hold` masks). Every warp then reads
// the C posts of each candidate from its own shared memory: the first
// candidate live in any block is the pivot column, and the lowest block
// that holds it live gives the pivot row; so every warp takes the same
// decision with no further exchange. A warp with holding rows to XOR loads
// the pivot row from its owner's shared memory into registers (its own
// memory if it is the owner), and the block's holding rows are dealt to its
// warps in turn, each XORed with 16-byte accesses (rows start on 16 bytes).
// A block barrier ends the round. A round whose 16 candidates are dead in
// every block costs the wait and one block barrier.
//
// Why the posts need no cluster barrier. They are double-buffered by round
// (buffer and mbarrier by round parity): a block posts round t+2 only
// after its round-t+1 wait, which needs every block's round-t+1 posts,
// which each block sends only after every one of its warps has read round
// t's (the block barriers). The owner changes the pivot row of round t (as
// a holding row) at the earliest in round t+1's XOR, after its round-t+1
// wait, which needs the posts every block sends after its pull of round t.
// After the elimination no block writes its state again; cluster barriers
// order what follows, and no block leaves while a peer may still read its
// memory (the sweep's barriers, or the last ones).
//
// Sweep (FUSED): a_j and the Gram terms are running sums passed from block
// to block: block c adds its rows, in ascending order, to block c-1's sums
// (read through distributed shared memory), so each sum takes gj_kernel's
// ascending-row order and its bits. The columns go in chunks of one per
// thread, software-pipelined: at stage s block c sums chunk s - c (the
// pair sums are the last chunk), so the C blocks work at once, with one
// cluster barrier a stage. The last block then holds the sums and picks
// the winner as gj_kernel does; each block flips the solution bits of its
// own pivot rows into the last block's solution mask (shared-memory
// atomics across the cluster), which stores the outputs.
//
// `tools/torch_probe_gj_cluster.py` places its timers at fixed lines and
// snippets of this kernel's text (its ANCHORS); an edit that moves or
// rewords one of them must update that list with it.
template <bool FUSED, int KW>
__global__ void __launch_bounds__(kThreads) gj_cluster_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), q = (int)cluster.block_rank(), last = C - 1;
  const int m = a.m, n = a.n, W = a.W, Wp1 = W + 1, Ws = cluster_stride(W), rank = a.rank;
  const ClusterLayout L = make_cluster_layout(m, n, W, C, FUSED);
  const int R = cluster_rows(m, C), r0 = q * R;
  const int mr = max(0, min(m - r0, R));  // this block's rows: r0 .. r0 + mr - 1
  uint32_t* st = (uint32_t*)(smem + L.st);                      // [mr, Ws]
  unsigned long long* pairs = (unsigned long long*)(smem + L.st);  // sort only
  uint16_t* ord = (uint16_t*)(smem + L.ord);                     // [n]
  uint16_t* pcol = (uint16_t*)(smem + L.pcol);                   // [rank]
  uint16_t* prow = (uint16_t*)(smem + L.prow);                   // global rows
  int* post = (int*)(smem + L.post);             // [2 rounds][kMaxCluster][kRound]
  uint32_t* hold = (uint32_t*)(smem + L.hold);   // [kRound][kRowWords]
  __shared__ uint32_t unused[kRowWords];  // this block's rows not yet pivot rows
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int s_left;
  __shared__ __align__(8) uint64_t mbar[2];  // a round's posts arrived, by round parity

  const int b = blockIdx.x / C, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t full = 0xffffffffu;
  if (tid == 0) {
    mbar_init(&mbar[0], 1);
    mbar_init(&mbar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  sort_columns(a.keys + (long long)b * n, n, pairs, ord);

  for (int e = tid; e < mr * Ws; e += kThreads) {
    const int i = e / Ws, w = e - i * Ws;
    st[e] = (w < W) ? a.H[(r0 + i) * W + w]
                    : (w == W ? (uint32_t)(a.synd[(long long)b * m + r0 + i] & 1) : 0u);
  }
  if (tid < kRowWords) {
    const int rows = mr - 32 * tid;
    unused[tid] = rows >= 32 ? 0xffffffffu : (rows > 0 ? (1u << rows) - 1u : 0u);
  }
  cluster.sync();  // every block has started: its shared memory may be written

  const int nch = Ws >> 2;  // 16-byte chunks a row
  int pos = 0, r = 0, round = 0;
  while (r < rank && pos < n) {
    int* pb = post + (round & 1) * kMaxCluster * kRound;
    uint64_t* bar = &mbar[round & 1];
    const int phase = (round >> 1) & 1;
    if (tid == 0) mbar_expect(bar, C * kRound * 4);  // every block's posts
    ++round;
    uint32_t v[kCand][KW];
    int col[kCand];
#pragma unroll
    for (int c = 0; c < kCand; ++c) {  // issue every load of both candidates first
      const int p = pos + warp + kWarps * c;
      col[c] = p < n ? (int)ord[p] : -1;
      const int jw = col[c] < 0 ? 0 : col[c] >> 5;
#pragma unroll
      for (int k = 0; k < KW; ++k) {
        const int i = 32 * k + lane;
        v[c][k] = (col[c] >= 0 && i < mr) ? st[i * Ws + jw] : 0u;
      }
    }
    int firsts[kCand];
#pragma unroll
    for (int c = 0; c < kCand; ++c) {
      const int js = col[c] & 31;
      uint32_t mine = 0;  // lane k: the local rows of word k that hold the bit
#pragma unroll
      for (int k = 0; k < KW; ++k) {
        if (32 * k >= mr) break;  // block-uniform
        const uint32_t h = __ballot_sync(full, (v[c][k] >> js) & 1u);
        if (lane == k) mine = h;
      }
      const uint32_t live = lane < KW ? mine & unused[lane] : 0u;
      const uint32_t words = __ballot_sync(full, live != 0u);
      firsts[c] = -1;
      if (words) {
        const int k = __ffs(words) - 1;
        firsts[c] = r0 + 32 * k + __ffs(__shfl_sync(full, live, k)) - 1;
      }
      if (lane < KW) hold[(warp + kWarps * c) * kRowWords + lane] = mine;
    }
    // both posts of this warp (slots 2 warp, 2 warp + 1 of block q's row)
    // into every block, one 8-byte store each
    static_assert(kCand == 2, "a warp posts its two candidates as one 8-byte store");
    if (lane < C)
      st_async2(cluster_addr(smem_u32(pb + q * kRound + 2 * warp), lane), firsts[0], firsts[1],
                cluster_addr(smem_u32(bar), lane));
    mbar_wait(bar, phase);  // every block's posts of this round are in every block
    __syncthreads();  // and this block's holding masks

    int f = -1;  // lane k < kRound: candidate k's lowest unused row in the cluster
    if (lane < kRound) {
      const int slot = 2 * (lane % kWarps) + lane / kWarps;  // warp k % 8 posted it
#pragma unroll
      for (int qq = kMaxCluster - 1; qq >= 0; --qq) {
        const int g = qq < C ? pb[qq * kRound + slot] : -1;
        if (g >= 0) f = g;
      }
    }
    const uint32_t any = __ballot_sync(full, f >= 0);
    if (!any) {  // every candidate of this round is dead in every block
      pos += kRound;
      __syncthreads();  // no warp posts the next round while one reads these
      continue;
    }
    const int win = __ffs(any) - 1, piv = __shfl_sync(full, f, win);
    const int owner = piv / R, li = piv - owner * R;

    // this block's rows holding the pivot column, the pivot row left out;
    // lane k's word k, and the count before it
    uint32_t hm = lane < KW ? hold[win * kRowWords + lane] : 0u;
    if (owner == q && lane == (li >> 5)) hm &= ~(1u << (li & 31));
    const int cnt = __popc(hm);
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(full, incl, off);
      if (lane >= off) incl += y;
    }
    const int total = __shfl_sync(full, incl, 31), excl = incl - cnt;
    if (warp < total) {  // holding rows warp, warp + kWarps, ... are this warp's
      const uint4* src =
          (const uint4*)((owner == q ? st : cluster.map_shared_rank(st, owner)) + li * Ws);
      uint4 pr[kRowVec];
#pragma unroll
      for (int i = 0; i < kRowVec; ++i) {
        const int c = lane + 32 * i;
        pr[i] = c < nch ? src[c] : make_uint4(0u, 0u, 0u, 0u);
      }
      for (int t = warp; t < total; t += kWarps) {
        const int who = __ffs(__ballot_sync(full, t >= excl && t < incl)) - 1;
        const uint32_t word = __shfl_sync(full, hm, who);
        const int before = __shfl_sync(full, excl, who);
        uint4* row = (uint4*)(st + (32 * who + nth_bit(word, t - before)) * Ws);
#pragma unroll
        for (int i = 0; i < kRowVec; ++i) {
          const int c = lane + 32 * i;
          if (c < nch) {
            uint4 x = row[c];
            x.x ^= pr[i].x;
            x.y ^= pr[i].y;
            x.z ^= pr[i].z;
            x.w ^= pr[i].w;
            row[c] = x;
          }
        }
      }
    }
    if (tid == 0) {
      if (owner == q) unused[li >> 5] &= ~(1u << (li & 31));
      pcol[r] = ord[pos + win];
      prow[r] = (uint16_t)piv;
    }
    ++r;
    pos += win + 1;
    __syncthreads();
  }

  // a syndrome bit left on an unused row of this block
  int left = 0;
  for (int i = tid; i < mr; i += kThreads)
    left |= (int)(((unused[i >> 5] >> (i & 31)) & 1u) && (st[i * Ws + W] & 1u));
  left = __syncthreads_or(left);
  if (tid == 0) s_left = left;

  if (!FUSED) {
    uint32_t* out = a.state_out + ((long long)b * m + r0) * Wp1;
    for (int e = tid; e < mr * Wp1; e += kThreads) {
      const int i = e / Wp1;
      out[e] = st[i * Ws + (e - i * Wp1)];
    }
    if (q == 0) {
      for (int t = tid; t < rank; t += kThreads) {
        a.pcol_out[(long long)b * rank + t] = t < r ? pcol[t] : -1;
        a.prow_out[(long long)b * rank + t] = t < r ? prow[t] : -1;
      }
    }
    cluster.sync();  // every block's s_left is set
    if (q == 0 && tid == 0) {
      int any = 0;
      for (int qq = 0; qq < C; ++qq) any |= *cluster.map_shared_rank(&s_left, qq);
      a.incons[b] = (uint8_t)(any != 0);
    }
    cluster.sync();  // no block leaves while block 0 reads it
    return;
  }

  float* aj = (float*)(smem + L.a);       // [n] running sums
  float* gsum = (float*)(smem + L.gram);  // [npairs] running Gram sums
  float* wrow = (float*)(smem + L.wrow);  // [mr], 0 on non-pivot rows
  uint32_t* pivm = (uint32_t*)(smem + L.masks);  // [W] pivot columns
  uint32_t* osdl = pivm + W;  // [W] OSD-0 bits of this block's pivot rows
  uint32_t* osdm = osdl + W;  // [W] OSD-0 support (last block)
  uint32_t* solm = osdm + W;  // [W] the solution's support (last block)
  __shared__ float s_pm0;
  __shared__ int s_top[kMaxTop];
  __shared__ Winner s_best;  // (last block)

  for (int w = tid; w < 2 * W; w += kThreads) pivm[w] = 0u;
  for (int i = tid; i < mr; i += kThreads) wrow[i] = 0.f;
  __syncthreads();
  for (int t = tid; t < r; t += kThreads) {
    const int j = pcol[t], i = prow[t] - r0;
    atomicOr(&pivm[j >> 5], 1u << (j & 31));
    if (0 <= i && i < mr) {
      const bool sol = st[i * Ws + W] & 1u;
      const float l = a.llr[j];
      wrow[i] = sol ? -l : l;
      if (sol) atomicOr(&osdl[j >> 5], 1u << (j & 31));
    }
  }
  __syncthreads();
  if (warp == 0) top_nonpivot(ord, n, pivm, a.order_w, s_top);
  cluster.sync();  // pivm, osdl, s_top, wrow and s_left set in every block

  // a_j and the Gram terms, pipelined: at stage s block q continues block
  // q-1's sums of chunk s - q (kThreads columns a chunk; the pairs last)
  const int chunks = (n + kThreads - 1) / kThreads;
  for (int s = 0; s < chunks + C; ++s) {
    const int k = s - q;
    if (0 <= k && k < chunks) {
      const int j = k * kThreads + tid;
      const int jw = j >> 5, js = j & 31;
      if (j < n && !((pivm[jw] >> js) & 1u)) {
        float acc = q ? cluster.map_shared_rank(aj, q - 1)[j] : 0.f;
#pragma unroll 8
        for (int i = 0; i < mr; ++i)
          if ((st[i * Ws + jw] >> js) & 1u) acc = __fadd_rn(acc, wrow[i]);
        aj[j] = acc;
      }
    } else if (k == chunks) {
      const float* prev_g = q ? cluster.map_shared_rank(gsum, q - 1) : nullptr;
      for (int p = tid; p < a.npairs; p += kThreads) {
        const int ci = s_top[a.pair_i[p]], cj = s_top[a.pair_j[p]];
        const int iw = ci >> 5, is = ci & 31, jw = cj >> 5, js = cj & 31;
        float g = q ? prev_g[p] : 0.f;
        for (int i = 0; i < mr; ++i) {
          const uint32_t* row = st + i * Ws;
          if ((row[iw] >> is) & (row[jw] >> js) & 1u) g = __fadd_rn(g, wrow[i]);
        }
        gsum[p] = g;
      }
    }
    cluster.sync();
  }

  if (q == last) {  // the winner, as gj_kernel picks it
    for (int w = tid; w < W; w += kThreads) {
      uint32_t x = 0u;
      for (int qq = 0; qq < C; ++qq) x |= cluster.map_shared_rank(osdl, qq)[w];
      osdm[w] = x;
    }
    if (tid == 0) {
      int any = 0;
      for (int qq = 0; qq < C; ++qq) any |= *cluster.map_shared_rank(&s_left, qq);
      a.incons[b] = (uint8_t)(any != 0);
    }
    __syncthreads();
    if (tid == 0) s_pm0 = support_sum(osdm, W, a.llr);
    __syncthreads();
    const Winner win = pick_winner(a, n, W, s_pm0, pivm, osdm, aj, s_top,
                                   [&](int p, int, int) { return gsum[p]; }, solm, red_v,
                                   red_i);
    if (tid == 0) s_best = win;
  }
  cluster.sync();  // the winner and the last block's solution mask are set

  const Winner win = *cluster.map_shared_rank(&s_best, last);
  if (win.use) {  // flip the bits of this block's pivot rows
    uint32_t* lsolm = cluster.map_shared_rank(solm, last);
    for (int t = tid; t < r; t += kThreads) {
      const int i = prow[t] - r0;
      if (i < 0 || i >= mr) continue;
      const uint32_t* row = st + i * Ws;
      uint32_t y = (row[W] & 1u) ^ ((row[win.c1 >> 5] >> (win.c1 & 31)) & 1u);
      if (win.is_pair) y ^= (row[win.c2 >> 5] >> (win.c2 & 31)) & 1u;
      if (y) atomicOr(&lsolm[pcol[t] >> 5], 1u << (pcol[t] & 31));
    }
  }
  cluster.sync();  // every flip is in; from here each block reads only its own memory
  if (q == last) store_solution(a, b, n, W, osdm, solm);
}

template <bool FUSED, int KW>
int launch_kw(const Args& a, int B, size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gj_kernel<FUSED, KW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gj_kernel<FUSED, KW><<<B, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool FUSED>
int launch(const Args& a, int B, void* stream) {
  if (B == 0) return 0;
  const Layout L = make_layout(a.m, a.n, a.W, FUSED);
  if (a.m > 32 * kRowWords || a.W + 1 > 32 * kRowChunks || a.order_w > kMaxTop ||
      L.total > 232448)
    return (int)cudaErrorInvalidValue;
  return a.m <= 256 ? launch_kw<FUSED, 8>(a, B, L.total, stream)
                    : launch_kw<FUSED, 16>(a, B, L.total, stream);
}

template <bool FUSED, int KW>
int launch_cluster_kw(const Args& a, int B, int C, size_t smem, void* stream) {
  void (*kern)(const Args) = gj_cluster_kernel<FUSED, KW>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;  // it could never run
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool FUSED>
int launch_cluster(const Args& a, int B, int C, void* stream) {
  if (B == 0) return 0;
  const ClusterLayout L = make_cluster_layout(a.m, a.n, a.W, C, FUSED);
  const int R = cluster_rows(a.m, C);
  if (C < 2 || C > kMaxCluster || R > 32 * kRowWords || a.m > 65536 || a.n > 65536 ||
      cluster_stride(a.W) > kMaxStride || a.order_w > kMaxTop || a.npairs > kMaxPairs ||
      L.total > 232448)
    return (int)cudaErrorInvalidValue;
  return R <= 128   ? launch_cluster_kw<FUSED, 4>(a, B, C, L.total, stream)
         : R <= 256 ? launch_cluster_kw<FUSED, 8>(a, B, C, L.total, stream)
                    : launch_cluster_kw<FUSED, 16>(a, B, C, L.total, stream);
}

Args base_args(const void* H, const void* synd, const void* keys, void* incons, int m,
               int n, int W, int rank) {
  Args a = {};
  a.H = (const uint32_t*)H;
  a.synd = (const uint8_t*)synd;
  a.keys = (const float*)keys;
  a.incons = (uint8_t*)incons;
  a.m = m;
  a.n = n;
  a.W = W;
  a.rank = rank;
  return a;
}

}  // namespace

extern "C" {

int gauss_jordan_key(const void* H, const void* synd, const void* keys,
                     void* state_out, void* pcol, void* prow, void* incons,
                     int m, int n, int W, int rank, int B, void* stream) {
  Args a = base_args(H, synd, keys, incons, m, n, W, rank);
  a.state_out = (uint32_t*)state_out;
  a.pcol_out = (int32_t*)pcol;
  a.prow_out = (int32_t*)prow;
  return launch<false>(a, B, stream);
}

int osd_cs_fused(const void* H, const void* synd, const void* keys, const void* llr,
                 const void* pair_i, const void* pair_j, void* solution, void* osd0,
                 void* min_pm, void* incons, int m, int n, int W, int rank, int order_w,
                 int npairs, int B, void* stream) {
  Args a = base_args(H, synd, keys, incons, m, n, W, rank);
  a.llr = (const float*)llr;
  a.pair_i = (const int32_t*)pair_i;
  a.pair_j = (const int32_t*)pair_j;
  a.solution = (uint8_t*)solution;
  a.osd0 = (uint8_t*)osd0;
  a.min_pm = (float*)min_pm;
  a.order_w = order_w;
  a.npairs = npairs;
  return launch<true>(a, B, stream);
}

// Shared memory of one block, as the launch computes it.
long long gj_smem_bytes(int m, int n, int W, int fused) {
  return (long long)make_layout(m, n, W, fused != 0).total;
}

int gauss_jordan_key_cluster(const void* H, const void* synd, const void* keys,
                             void* state_out, void* pcol, void* prow, void* incons,
                             int m, int n, int W, int rank, int B, int C, void* stream) {
  Args a = base_args(H, synd, keys, incons, m, n, W, rank);
  a.state_out = (uint32_t*)state_out;
  a.pcol_out = (int32_t*)pcol;
  a.prow_out = (int32_t*)prow;
  return launch_cluster<false>(a, B, C, stream);
}

int osd_cs_fused_cluster(const void* H, const void* synd, const void* keys, const void* llr,
                         const void* pair_i, const void* pair_j, void* solution, void* osd0,
                         void* min_pm, void* incons, int m, int n, int W, int rank,
                         int order_w, int npairs, int B, int C, void* stream) {
  Args a = base_args(H, synd, keys, incons, m, n, W, rank);
  a.llr = (const float*)llr;
  a.pair_i = (const int32_t*)pair_i;
  a.pair_j = (const int32_t*)pair_j;
  a.solution = (uint8_t*)solution;
  a.osd0 = (uint8_t*)osd0;
  a.min_pm = (float*)min_pm;
  a.order_w = order_w;
  a.npairs = npairs;
  return launch_cluster<true>(a, B, C, stream);
}

// Shared memory of one block of a C-block cluster, as the launch computes it.
long long gj_cluster_smem_bytes(int m, int n, int W, int C, int fused) {
  return (long long)make_cluster_layout(m, n, W, C, fused != 0).total;
}

const char* swd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
