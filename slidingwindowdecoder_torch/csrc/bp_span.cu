// A whole span of min-sum BP iterations in one launch, for Hopper (sm_90a).
//
// Replaces, on the decode paths, the per-iteration launch of the JAX
// package's Pallas kernel `ops/bp_pallas.py:_cn_kernel` (reached through
// `cn_update_pallas`, unmasked and `pinned=True`) together with the XLA ops
// of the rest of the iteration in its `ops/bp.py:bp_run`. Plain version:
// `ops/bp.py:bp_loop` in this package (the per-op loop, whose CN stage is
// `csrc/cn_update.cu` on the card).
//
// Design. One block owns S consecutive columns (shots, or GDG branches). It
// loads their [dc, m_pad] message slices once, runs up to `num_iter`
// iterations with every intermediate in shared memory, and stores once.
// Per iteration and column:
//   CN stage    the check-node update of `cn_update.cu`, in place (mv -> mc);
//   VN stage    posterior = prior + (mc[slot 0] + mc[slot 1] + ... ), f32,
//               slot by slot in the order of `vn_from_cn`, a degree-padding
//               slot adding an explicit +0.0 (the zero fill row); the
//               posterior rounded to the message dtype (decided VNs pinned
//               to -/+pin in masked mode) stays in shared memory, the f32
//               posterior goes to the history ring from `hist_from` on,
//               rounded once to the ring's type HT (float or bfloat16:
//               the JAX `posterior.astype(hist.dtype)`);
//   edge stage  mv = post_edge - mc (pin where |post_edge| >= thresh in
//               masked mode) and the parity of each check's non-positive
//               posteriors, compared with the syndrome;
//   bookkeeping iters += 1, done |= (every row matches).
// When the caller passes `synd_hat`, the edge stage also keeps each check's
// decoded parity (bit 1 of the syndrome byte, whose bit 0 is the target),
// and the store writes it for every column that ran, the target for a
// column done at entry (the JAX `bp_run(return_synd=True)`).
// A column that is done is skipped from then on, so its messages, errors
// and rounded posterior keep the values of its last active iteration. The
// error is written once, at the end, from that posterior. A block leaves
// the loop as soon as all its columns are done: the test reads shared flags
// after a barrier, so it is uniform across the block and no thread waits at
// a barrier alone. Nothing waits on the host.
//
// Two forms of a call. Copying (`skip_done` 0, the JAX package's functional
// contract): every column in range is loaded (pinned at its decided VNs'
// edges and invalid slots in masked mode, as the JAX loop pins every column
// at entry) and stored to the outputs. In place (`skip_done` 1, for the
// decoders that rebind their carry): the outputs are the inputs, and a
// column done at entry is neither read nor written, but for its target
// syndrome in `synd_hat`; a block whose columns are all done at entry
// leaves before it copies the tables. Messages, errors and VN states are
// addressed through the caller's strides, so the GDG carry's [n, B] states
// need no transpose, and the decoders keep their messages column-major
// (`ops/bp.py:column_major`: each column's dc*m_pad messages contiguous,
// loaded and stored in full sectors).
//
// Exactness. The arithmetic is the plain version's: f32 from exact images
// of the stored values, every constant pre-rounded to the storage dtype by
// the caller, one rounding at each store, __fadd_rn/__fsub_rn/__fmul_rn so
// that no product is contracted into an add. Invalid check slots are the
// tail of each check row (`compile_graph` fills rows from slot 0), so a row
// walks its first `deg` slots only; at the store an invalid slot of a
// column that ran gets the plain version's value (post[n - 1] - 0
// unmasked, pin masked).
//
// Bound: `utils/roofline.py:span_bound`, the larger of the operations of
// the shot-iterations run (~25 a valid edge at the float32 rate) and the
// bytes of the columns not done at entry (their message blocks read and
// written once, syndromes, sign seeds, states, errors, the ring's writes).
// What the design pays beyond it: each thread walks one check row's slots
// in turn (a chain of dependent shared-memory accesses), four barriers an
// iteration, the tables copied into every block that has a live column,
// and a block runs until its slowest column is done, its other columns'
// threads idle meanwhile. A persistent grid that refilled the slots of
// finished columns from a queue and split check rows over lanes was built
// and measured against this design in turns: equal on the GDG burst,
// ~24 % slower on the buckets whose columns are all live, faster only on
// the BPGD burst (PERF.md). `tools/torch_probe_bp_span.py` times each stage
// of a block-iteration in a `-DBP_SPAN_CLOCKS` build.
//
// Shared memory (layout below): S x [(dc*m_pad + 1) messages, n rounded
// posteriors in the message dtype, n decimation states, 2 x m_pad sign and
// syndrome bits] plus the int16 index tables and the f32 prior once. At
// the flagship windows (dc 35, m_pad 224, n <= 1728, dv 6) S = 4 fits in
// f32 and S = 8 in bf16 within the 232,448 bytes a block may use.
//
// Two table routes of one template (GT). The shared-table route (GT =
// false, entry points `bp_span_*`) copies the int16 index tables and the
// prior into each block, as above. The global-table route (GT = true,
// entry points `bp_span_wide_*`) serves graphs whose tables and message
// block do not fit beside each other: the [[144]] global DEM (dc*m_pad + 1
// = 33,601 is past int16, and its f32 messages alone take 134 KB) and the
// interior [[288]] W=4 windows in f32 (576x4896: 232,960 B with the
// tables). It reads the uint16 tables and the f32 prior through the
// read-only data cache (__ldg): every block shares them and they stay in
// L2, so shared memory holds per-shot state only: 180,272 B for one f32
// global shot, 95,504 B a bf16 one (two a block), 110,848 B an f32 [[288]]
// interior shot (two a block). Arithmetic, orders and outputs are those of
// the shared-table route.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kMaxThreads = 1024;
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The clipped value of one slot: pins (MASKED only) pass unclipped.
template <bool MASKED>
__device__ __forceinline__ float clipped(float x, float clip, float thresh) {
  if (MASKED && x >= thresh) return x;
  return fminf(fmaxf(x, -clip), clip);
}

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

#ifdef BP_SPAN_CLOCKS
// Stage timers of the probe build (tools/torch_probe_bp_span.py): the
// cycles between consecutive block barriers, as thread 0 sees them, added
// to the stage that ran between them; each warp's cycles spent waiting at
// barriers; warps, block-iterations and blocks (those that left at once,
// all their columns done at entry, counted apart). The clock reads carry a
// memory clobber, so that they stay on their side of the barrier.
constexpr int kClk = 12;
constexpr int kClkBlocks = 4096;  // blocks whose own record is kept
__device__ unsigned long long g_clocks[kClk];
// per block: start and end (globaltimer, ns), cycles, block-iterations, live columns
__device__ unsigned long long g_block[kClkBlocks][5];
__device__ __forceinline__ long long clk_now() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) : : "memory");
  return t;
}
__device__ __forceinline__ unsigned long long ns_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) : : "memory");
  return t;
}
#define CLK_DECL long long clk_last = clk_now(), clk_wait = 0, clk_first = clk_last; \
    long long clk[7] = {0, 0, 0, 0, 0, 0, 0}; \
    unsigned long long clk_iters = 0, clk_t0 = ns_now()
#define SYNC(k) do { const long long w_ = clk_now(); __syncthreads(); const long long t_ = clk_now(); \
    clk_wait += t_ - w_; clk[k] += t_ - clk_last; clk_last = t_; } while (0)
#define CLK_ITER() do { if (threadIdx.x == 0) { atomicAdd(&g_clocks[8], 1ull); ++clk_iters; } } while (0)
#define CLK_END(cols) do { const unsigned long long cols_ = (cols); \
    if ((threadIdx.x & 31) == 0) { atomicAdd(&g_clocks[7], (unsigned long long)clk_wait); \
      atomicAdd(&g_clocks[10], 1ull); } \
    if (threadIdx.x == 0) { clk[6] += clk_now() - clk_last; \
      for (int k_ = 0; k_ < 7; ++k_) atomicAdd(&g_clocks[k_], (unsigned long long)clk[k_]); \
      atomicAdd(&g_clocks[9], 1ull); \
      if (blockIdx.x < kClkBlocks) { \
        g_block[blockIdx.x][0] = clk_t0; g_block[blockIdx.x][1] = ns_now(); \
        g_block[blockIdx.x][2] = (unsigned long long)(clk_now() - clk_first); \
        g_block[blockIdx.x][3] = clk_iters; g_block[blockIdx.x][4] = cols_; } } } while (0)
#define CLK_IDLE() do { if (threadIdx.x == 0) atomicAdd(&g_clocks[11], 1ull); } while (0)
#else
#define CLK_DECL
#define SYNC(k) __syncthreads()
#define CLK_ITER()
#define CLK_END(cols)
#define CLK_IDLE()
#endif

// Byte offsets of the shared-memory arrays of one block. `ops/bp_cuda.py:
// span_smem_bytes` computes the same total.
// The global-table route (gt) places no tables and no prior there.
struct Layout {
  size_t msg, post, prior, cn_vn, vfc, deg, vst, par, syn, shot, total;
};

__host__ __device__ inline Layout make_layout(size_t tsize, int n, int m_pad, int dc,
                                              int dv, int S, bool gt = false) {
  Layout L;
  size_t o = 0;
  const size_t tab = gt ? 0 : 1;
  L.msg = o;    o = align16(o + ((size_t)dc * m_pad + 1) * S * tsize);
  L.post = o;   o = align16(o + (size_t)n * S * tsize);
  L.prior = o;  o = align16(o + tab * n * 4);
  L.cn_vn = o;  o = align16(o + tab * dc * m_pad * 2);
  L.vfc = o;    o = align16(o + tab * n * dv * 2);
  L.deg = o;    o = align16(o + tab * m_pad * 2);
  L.vst = o;    o = align16(o + (size_t)n * S);
  L.par = o;    o = align16(o + (size_t)m_pad * S);
  L.syn = o;    o = align16(o + (size_t)m_pad * S);
  L.shot = o;   o = align16(o + (size_t)S * 4 * 4);
  L.total = o;
  return L;
}

struct Args {
  const void* mv_in;            // [dc, m_pad, B], element strides below
  long long st_s, st_i, st_b;
  void* mv_out;                 // [dc, m_pad, B] at its own strides (may be mv_in)
  long long so_s, so_i, so_b;
  const float* prior;           // [n]
  const int32_t* parity;        // [m_pad, B] CN sign seed
  const int32_t* synd;          // [m_pad, B] syndrome (pad rows 0)
  const int8_t* vn_state;       // (b, v) at b * st_vb + v * st_vv, or null: all undecided
  long long st_vb, st_vv;
  void* hist;                   // [n, 4, B] of HT, written from hist_from on
  const int8_t* err_in;         // (b, v) at b * st_eb + v * st_ev, as err_out (may alias)
  int8_t* err_out;
  long long st_eb, st_ev;
  const uint8_t* done_in;       // [B] bool
  uint8_t* done_out;            // (may be done_in)
  const int32_t* iters_in;      // [B]
  int32_t* iters_out;           // (may be iters_in)
  const void* cn_vn;            // [dc*m_pad] VN per slot (clipped to n-1)
  const void* vfc;              // [n*dv] slot per VN edge, dc*m_pad = fill
  const void* deg;              // [m_pad] valid slots per check row
                                // (int16, or uint16 on the global-table route)
  int8_t* synd_hat;             // [m_pad, B] decoded syndrome, or null
  int n, m_pad, dc, dv, S, num_iter, hist_from;
  int skip_done;                // in place: columns done at entry neither read nor written
  long long B;
  float alpha, clip, big, thresh, pin;
};

// The graph's tables and prior: in shared memory (copied there at entry),
// or, with GT, read through the read-only data cache from device memory.
template <bool GT> struct Tables;

template <> struct Tables<false> {
  float* prior;
  int16_t *cn_vn, *vfc, *deg;
  __device__ __forceinline__ int cnvn(int e) const { return cn_vn[e]; }
  __device__ __forceinline__ int vf(int k) const { return vfc[k]; }
  __device__ __forceinline__ int dg(int r) const { return deg[r]; }
  __device__ __forceinline__ float pr(int v) const { return prior[v]; }
};

template <> struct Tables<true> {
  const float* __restrict__ prior;
  const uint16_t* __restrict__ cn_vn;
  const uint16_t* __restrict__ vfc;
  const uint16_t* __restrict__ deg;
  __device__ __forceinline__ int cnvn(int e) const { return __ldg(cn_vn + e); }
  __device__ __forceinline__ int vf(int k) const { return __ldg(vfc + k); }
  __device__ __forceinline__ int dg(int r) const { return __ldg(deg + r); }
  __device__ __forceinline__ float pr(int v) const { return __ldg(prior + v); }
};

template <typename T, bool MASKED, typename HT, bool GT>
__global__ void __launch_bounds__(kMaxThreads) bp_span_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  CLK_DECL;
  const int S = a.S, n = a.n, m_pad = a.m_pad, dc = a.dc, dv = a.dv;
  const int edges = dc * m_pad;
  const long long B = a.B;
  const Layout L = make_layout(sizeof(T), n, m_pad, dc, dv, S, GT);
  T* msg = (T*)(smem + L.msg);     // [(edges + 1) * S], shot fastest
  T* post = (T*)(smem + L.post);   // [n * S]
  Tables<GT> tab;
  if constexpr (GT) {
    tab.prior = a.prior;
    tab.cn_vn = (const uint16_t*)a.cn_vn;
    tab.vfc = (const uint16_t*)a.vfc;
    tab.deg = (const uint16_t*)a.deg;
  } else {
    tab.prior = (float*)(smem + L.prior);
    tab.cn_vn = (int16_t*)(smem + L.cn_vn);
    tab.vfc = (int16_t*)(smem + L.vfc);
    tab.deg = (int16_t*)(smem + L.deg);
  }
  int8_t* vst = (int8_t*)(smem + L.vst);  // [n * S]
  int8_t* par = (int8_t*)(smem + L.par);  // [m_pad * S]
  int8_t* syn = (int8_t*)(smem + L.syn);  // [m_pad * S] target, decoded parity << 1
  int* done_s = (int*)(smem + L.shot);
  int* iters_s = done_s + S;
  int* ran_s = iters_s + S;
  int* mism = ran_s + S;

  // blockDim.x is a multiple of S: each thread keeps one column and walks
  // the rows (checks, VNs, edges) r0, r0 + step, ...
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int shot = tid % S, r0 = tid / S, step = nthr / S;
  const long long b0 = (long long)blockIdx.x * S;
  const int nshots = (int)((B - b0) < S ? (B - b0) : S);
  const long long b = b0 + shot;
  // a live column is loaded, iterated and stored; in place, one done at
  // entry is not (read before any output is written: outputs may alias)
  const bool live = shot < nshots && !(a.skip_done && a.done_in[b]);
  const bool col_live = tid < nshots && !(a.skip_done && a.done_in[b0 + tid]);
  if (a.synd_hat && shot < nshots && !live) {
    for (int r = r0; r < m_pad; r += step)
      a.synd_hat[(long long)r * B + b] = (int8_t)(a.synd[(long long)r * B + b] & 1);
  }
  if (!__syncthreads_or(live)) {  // block-uniform
    CLK_IDLE();
    return;
  }

  const float alpha = a.alpha, clip = a.clip, big = a.big, thresh = a.thresh;
  const T pin = from_f<T>(a.pin), neg_pin = from_f<T>(-a.pin);

  // 1. tables and per-column state
  if constexpr (!GT) {
    const int16_t *cv = (const int16_t*)a.cn_vn, *vf = (const int16_t*)a.vfc,
                  *dg = (const int16_t*)a.deg;
    for (int k = tid; k < edges; k += nthr) tab.cn_vn[k] = cv[k];
    for (int k = tid; k < n * dv; k += nthr) tab.vfc[k] = vf[k];
    for (int k = tid; k < m_pad; k += nthr) tab.deg[k] = dg[k];
    for (int k = tid; k < n; k += nthr) tab.prior[k] = a.prior[k];
  }
  for (int r = r0; r < m_pad; r += step) {
    par[r * S + shot] = live ? (int8_t)a.parity[r * B + b] : (int8_t)0;
    syn[r * S + shot] = live ? (int8_t)a.synd[r * B + b] : (int8_t)0;
  }
  if (MASKED) {
    for (int v = r0; v < n; v += step)
      vst[v * S + shot] = (live && a.vn_state) ? a.vn_state[b * a.st_vb + v * a.st_vv]
                                               : (int8_t)-1;
  }
  if (tid < S) {
    done_s[tid] = col_live ? (int)a.done_in[b0 + tid] : 1;  // a missing column is done
    iters_s[tid] = col_live ? a.iters_in[b0 + tid] : 0;
    ran_s[tid] = 0;
    mism[tid] = 0;
    msg[edges * S + tid] = from_f<T>(0.f);  // the fill row
  }
  SYNC(0);

  // 2. messages; in masked mode the edges of decided VNs and the invalid
  // slots are pinned once, here
  const T* mv_in = (const T*)a.mv_in;
  if (live) {
    for (int e = r0; e < edges; e += step) {
      const int s = e / m_pad, r = e - s * m_pad;
      T x = mv_in[s * a.st_s + r * a.st_i + b * a.st_b];
      if (MASKED && (s >= tab.dg(r) || vst[tab.cnvn(e) * S + shot] != -1)) x = pin;
      msg[e * S + shot] = x;
    }
  }
  SYNC(1);

  const int ss = m_pad * S;  // distance between two slots of one check
  for (int it = 0; it < a.num_iter; ++it) {
    if (it > 0) SYNC(5);
    bool all_done = true;
    for (int k = 0; k < S; ++k) all_done &= done_s[k] != 0;
    if (all_done) break;  // block-uniform: every thread read the same flags
    CLK_ITER();
    const bool active = !done_s[shot];

    // CN stage, in place: mv -> mc on the valid slots
    if (active) {
      for (int r = r0; r < m_pad; r += step) {
        const int d = tab.dg(r);
        T* col = msg + r * S + shot;
        float min1 = big, min2 = big;
        int nneg = 0;
        for (int s = 0; s < d; ++s) {
          const float c = clipped<MASKED>(to_f(col[s * ss]), clip, thresh);
          const float x = fminf(fabsf(c), big);
          if (x < min1) {
            min2 = min1;
            min1 = x;
          } else {
            min2 = fminf(min2, x);
          }
          nneg += (c <= 0.f);
        }
        const int odd = (par[r * S + shot] + nneg) & 1;
        for (int s = 0; s < d; ++s) {
          const float c = clipped<MASKED>(to_f(col[s * ss]), clip, thresh);
          const float x = fminf(fabsf(c), big);
          const float mag = (x == min1) ? min2 : min1;
          const bool flip = (odd ^ (int)(c <= 0.f)) != 0;
          col[s * ss] = from_f<T>(__fmul_rn(alpha, flip ? -mag : mag));
        }
      }
    }
    SYNC(2);

    // VN stage: posterior, its rounded (and pinned) copy, history
    if (active) {
      const bool hist_on = it >= a.hist_from;
      HT* hist = (HT*)a.hist + (long long)(it & 3) * B + b;
      for (int v = r0; v < n; v += step) {
        const int vb = v * dv;
        float acc = to_f(msg[tab.vf(vb) * S + shot]);
        for (int j = 1; j < dv; ++j) acc = __fadd_rn(acc, to_f(msg[tab.vf(vb + j) * S + shot]));
        const float p = __fadd_rn(tab.pr(v), acc);
        T pf = from_f<T>(p);
        bool undecided = true;
        if (MASKED) {
          const int st = vst[v * S + shot];
          if (st != -1) {
            undecided = false;
            pf = st == 1 ? neg_pin : pin;
          }
        }
        post[v * S + shot] = pf;
        if (hist_on && undecided) hist[(long long)v * 4 * B] = from_f<HT>(p);
      }
    }
    SYNC(3);

    // edge stage: new messages and the syndrome check
    if (active) {
      const bool keep = a.synd_hat != nullptr;
      int bad = 0;
      for (int r = r0; r < m_pad; r += step) {
        const int d = tab.dg(r);
        int cnt = 0;
        for (int s = 0; s < d; ++s) {
          const int e = s * m_pad + r;
          const float pe = to_f(post[tab.cnvn(e) * S + shot]);
          T* p = msg + e * S + shot;
          const T nv = from_f<T>(__fsub_rn(pe, to_f(*p)));
          *p = (!MASKED || fabsf(pe) < thresh) ? nv : pin;
          cnt += (pe <= 0.f);
        }
        const int8_t t = syn[r * S + shot] & 1;
        bad |= (cnt & 1) != t;
        if (keep) syn[r * S + shot] = (int8_t)(t | ((cnt & 1) << 1));
      }
      if (bad) mism[shot] = 1;
    }
    SYNC(4);

    if (tid < S) {
      if (!done_s[tid]) {
        iters_s[tid] += 1;
        ran_s[tid] = 1;
        if (!mism[tid]) done_s[tid] = 1;
      }
      mism[tid] = 0;
    }
  }
  SYNC(5);

  // 3. store the live columns: messages, errors (a column's own thread
  // group walks its VNs), synd_hat, done and iterations
  T* mv_out = (T*)a.mv_out;
  if (live) {
    const bool ran = ran_s[shot] != 0;
    const T last = post[(n - 1) * S + shot];  // read only if the column ran
    for (int e = r0; e < edges; e += step) {
      const int s = e / m_pad, r = e - s * m_pad;
      T x = msg[e * S + shot];
      if (!MASKED && ran && s >= tab.dg(r)) x = last;
      mv_out[s * a.so_s + r * a.so_i + b * a.so_b] = x;
    }
    for (int v = r0; v < n; v += step) {
      const long long o = b * a.st_eb + v * a.st_ev;
      a.err_out[o] = ran ? (int8_t)(to_f(post[v * S + shot]) <= 0.f) : a.err_in[o];
    }
    if (a.synd_hat) {
      const int bit = ran ? 1 : 0;
      for (int r = r0; r < m_pad; r += step)
        a.synd_hat[(long long)r * B + b] = (int8_t)((syn[r * S + shot] >> bit) & 1);
    }
  }
  if (col_live) {
    a.done_out[b0 + tid] = (uint8_t)(done_s[tid] != 0);
    a.iters_out[b0 + tid] = iters_s[tid];
  }
  CLK_END((unsigned long long)__syncthreads_count(col_live));
}

template <typename T, bool MASKED, typename HT, bool GT>
int launch(const Args& a, int threads, void* stream) {
  if (a.B == 0) return 0;
  const Layout L = make_layout(sizeof(T), a.n, a.m_pad, a.dc, a.dv, a.S, GT);
  const long long idx_max = GT ? 65535 : 32767;  // the tables' index type
  if (a.S < 1 || threads < a.S || threads % a.S || threads > kMaxThreads ||
      L.total > kMaxSmem || (long long)a.dc * a.m_pad + 1 > idx_max || a.n > idx_max)
    return (int)cudaErrorInvalidValue;
  // the most dynamic shared memory, allowed once per device
  static std::mutex mu;
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!allowed[dev]) {
      err = cudaFuncSetAttribute(bp_span_kernel<T, MASKED, HT, GT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
      if (err != cudaSuccess) return (int)err;
      allowed[dev] = true;
    }
  }
  const long long blocks = (a.B + a.S - 1) / a.S;
  bp_span_kernel<T, MASKED, HT, GT>
      <<<(unsigned)blocks, threads, L.total, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One entry point per (table route, message dtype, mode, ring dtype). alpha,
// clip, big, thresh and pin arrive already rounded to the message dtype; the
// unmasked entry points ignore thresh, pin and vn_state. synd_hat may be
// null. The `bp_span_wide_*` entry points take uint16 tables. Messages are
// read at strides (st_s, st_i, st_b) and written at (so_s, so_i, so_b), the
// VN states read at (st_vb, st_vv), the errors read and written at (st_eb,
// st_ev); each output may be its input (in place). With `skip_done` the
// columns done at entry are neither read nor written.
#define BP_SPAN_ENTRY(NAME, T, MASKED, HT, GT)                                            \
  int NAME(const void* mv_in, long long st_s, long long st_i, long long st_b,             \
           void* mv_out, long long so_s, long long so_i, long long so_b,                  \
           const void* prior, const void* parity, const void* synd, const void* vn_state, \
           long long st_vb, long long st_vv, void* hist, const void* err_in,              \
           void* err_out, long long st_eb, long long st_ev, const void* done_in,          \
           void* done_out, const void* iters_in, void* iters_out, const void* cn_vn,      \
           const void* vfc, const void* deg, void* synd_hat, int n, int m_pad, int dc,    \
           int dv, long long B, int S, int threads, int num_iter, int hist_from,          \
           int skip_done, float alpha, float clip, float big, float thresh, float pin,    \
           void* stream) {                                                                \
    Args a;                                                                               \
    a.mv_in = mv_in; a.st_s = st_s; a.st_i = st_i; a.st_b = st_b;                         \
    a.mv_out = mv_out; a.so_s = so_s; a.so_i = so_i; a.so_b = so_b;                       \
    a.prior = (const float*)prior; a.parity = (const int32_t*)parity;                     \
    a.synd = (const int32_t*)synd; a.vn_state = (const int8_t*)vn_state;                  \
    a.st_vb = st_vb; a.st_vv = st_vv; a.hist = hist;                                      \
    a.err_in = (const int8_t*)err_in; a.err_out = (int8_t*)err_out;                       \
    a.st_eb = st_eb; a.st_ev = st_ev;                                                     \
    a.done_in = (const uint8_t*)done_in; a.done_out = (uint8_t*)done_out;                 \
    a.iters_in = (const int32_t*)iters_in; a.iters_out = (int32_t*)iters_out;             \
    a.cn_vn = cn_vn; a.vfc = vfc; a.deg = deg; a.synd_hat = (int8_t*)synd_hat;            \
    a.n = n; a.m_pad = m_pad; a.dc = dc; a.dv = dv; a.S = S; a.num_iter = num_iter;       \
    a.hist_from = hist_from; a.skip_done = skip_done; a.B = B; a.alpha = alpha;           \
    a.clip = clip; a.big = big; a.thresh = thresh; a.pin = pin;                           \
    return launch<T, MASKED, HT, GT>(a, threads, stream);                                 \
  }

BP_SPAN_ENTRY(bp_span_f32, float, false, float, false)
BP_SPAN_ENTRY(bp_span_bf16, __nv_bfloat16, false, float, false)
BP_SPAN_ENTRY(bp_span_pinned_f32, float, true, float, false)
BP_SPAN_ENTRY(bp_span_pinned_bf16, __nv_bfloat16, true, float, false)
BP_SPAN_ENTRY(bp_span_f32_ring_bf16, float, false, __nv_bfloat16, false)
BP_SPAN_ENTRY(bp_span_bf16_ring_bf16, __nv_bfloat16, false, __nv_bfloat16, false)
BP_SPAN_ENTRY(bp_span_pinned_f32_ring_bf16, float, true, __nv_bfloat16, false)
BP_SPAN_ENTRY(bp_span_pinned_bf16_ring_bf16, __nv_bfloat16, true, __nv_bfloat16, false)
BP_SPAN_ENTRY(bp_span_wide_f32, float, false, float, true)
BP_SPAN_ENTRY(bp_span_wide_bf16, __nv_bfloat16, false, float, true)
BP_SPAN_ENTRY(bp_span_wide_pinned_f32, float, true, float, true)
BP_SPAN_ENTRY(bp_span_wide_pinned_bf16, __nv_bfloat16, true, float, true)
BP_SPAN_ENTRY(bp_span_wide_f32_ring_bf16, float, false, __nv_bfloat16, true)
BP_SPAN_ENTRY(bp_span_wide_bf16_ring_bf16, __nv_bfloat16, false, __nv_bfloat16, true)
BP_SPAN_ENTRY(bp_span_wide_pinned_f32_ring_bf16, float, true, __nv_bfloat16, true)
BP_SPAN_ENTRY(bp_span_wide_pinned_bf16_ring_bf16, __nv_bfloat16, true, __nv_bfloat16, true)

// Shared memory of one block, as the launch computes it: the shared-table
// route, and the global-table route.
long long bp_span_smem_bytes(int elem_size, int n, int m_pad, int dc, int dv, int S) {
  return (long long)make_layout((size_t)elem_size, n, m_pad, dc, dv, S).total;
}

long long bp_span_wide_smem_bytes(int elem_size, int n, int m_pad, int dc, int dv, int S) {
  return (long long)make_layout((size_t)elem_size, n, m_pad, dc, dv, S, true).total;
}

#ifdef BP_SPAN_CLOCKS
const char* bp_span_clock_names() {
  return "tables and state,message load,cn,vn,edge,bookkeeping,store,barrier wait,"
         "block-iterations,blocks,warps,blocks left at once";
}

// Copy the probe build's counters into out[kClk] and zero them.
int bp_span_take_clocks(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_clocks, sizeof(g_clocks));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zero[kClk] = {};
  return (int)cudaMemcpyToSymbol(g_clocks, zero, sizeof(g_clocks));
}

// Copy the first `blocks` blocks' records (start ns, end ns, cycles,
// block-iterations, live columns) into out[blocks][5]; a block that left
// at once leaves its record as it was (zero after bp_span_clear_blocks).
int bp_span_take_blocks(unsigned long long* out, int blocks) {
  if (blocks > kClkBlocks) blocks = kClkBlocks;
  return (int)cudaMemcpyFromSymbol(out, g_block, sizeof(unsigned long long) * 5 * blocks);
}

int bp_span_clear_blocks() {
  static const unsigned long long zero[kClkBlocks][5] = {};
  return (int)cudaMemcpyToSymbol(g_block, zero, sizeof(g_block));
}
#endif

const char* swd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
