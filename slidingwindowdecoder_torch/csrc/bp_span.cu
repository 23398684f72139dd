// A whole span of min-sum BP iterations in one launch, for Hopper (sm_90a).
//
// Replaces, on the decode paths, the per-iteration launch of the JAX
// package's Pallas kernel `ops/bp_pallas.py:_cn_kernel` (reached through
// `cn_update_pallas`, unmasked and `pinned=True`) together with the XLA ops
// of the rest of the iteration in its `ops/bp.py:bp_run`. Plain version:
// `ops/bp.py:bp_loop` in this package (the per-op loop, whose CN stage is
// `csrc/cn_update.cu` on the card).
//
// Design. One block owns S consecutive shots. It loads their [dc, m_pad]
// message slices once, runs up to `num_iter` iterations with every
// intermediate in shared memory, and stores once. Per iteration and shot:
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
// and the store writes it for every shot that ran, the target for a shot
// done at entry (the JAX `bp_run(return_synd=True)`).
// A shot that is done is skipped from then on, so its messages, errors and
// rounded posterior keep the values of its last active iteration. The
// error is written once, at the end, from that posterior. A block leaves
// the loop as soon as all its shots are done: the test reads shared flags
// after a barrier, so it is uniform across the block and no thread waits at
// a barrier alone. Nothing waits on the host.
//
// Exactness. The arithmetic is the plain version's: f32 from exact images
// of the stored values, every constant pre-rounded to the storage dtype by
// the caller, one rounding at each store, __fadd_rn/__fsub_rn/__fmul_rn so
// that no product is contracted into an add. Invalid check slots are the
// tail of each check row (`compile_graph` fills rows from slot 0), so a row
// walks its first `deg` slots only; at the store an invalid slot of a shot
// that ran gets the plain version's value (post[n - 1] - 0 unmasked, pin
// masked).
//
// Bound. Per shot-iteration the block does ~25 operations per valid edge
// (counted in chip_smoke.py) out of shared memory; device memory sees one
// read and one write of the message block per call and the history ring's
// writes, so the operation count bounds it. What the design pays instead:
// each thread walks one check row's slots in turn (a chain of dependent
// shared-memory accesses), four barriers per iteration, and a block runs
// until its slowest shot is done, its other shots' threads idle meanwhile.
//
// Shared memory (layout below): S x [(dc*m_pad + 1) messages, n rounded
// posteriors in the message dtype, n decimation states, 2 x m_pad sign and
// syndrome bits] plus the int16 index tables and the f32 prior once. At
// the flagship windows (dc 35, m_pad 224, n <= 1728, dv 6) S = 4 fits in
// f32 and S = 8 in bf16 within the 232,448 bytes a block may use.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

// Byte offsets of the shared-memory arrays of one block. `ops/bp_cuda.py:
// span_smem_bytes` computes the same total.
struct Layout {
  size_t msg, post, prior, cn_vn, vfc, deg, vst, par, syn, shot, total;
};

__host__ __device__ inline Layout make_layout(size_t tsize, int n, int m_pad, int dc,
                                              int dv, int S) {
  Layout L;
  size_t o = 0;
  L.msg = o;    o = align16(o + ((size_t)dc * m_pad + 1) * S * tsize);
  L.post = o;   o = align16(o + (size_t)n * S * tsize);
  L.prior = o;  o = align16(o + (size_t)n * 4);
  L.cn_vn = o;  o = align16(o + (size_t)dc * m_pad * 2);
  L.vfc = o;    o = align16(o + (size_t)n * dv * 2);
  L.deg = o;    o = align16(o + (size_t)m_pad * 2);
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
  void* mv_out;                 // [dc, m_pad, B] contiguous
  const float* prior;           // [n]
  const int32_t* parity;        // [m_pad, B] CN sign seed
  const int32_t* synd;          // [m_pad, B] syndrome (pad rows 0)
  const int8_t* vn_state;       // [B, n] -1/0/1, or null: all undecided
  void* hist;                   // [n, 4, B] of HT, written from hist_from on
  const int8_t* err_in;         // [B, n]
  int8_t* err_out;
  const uint8_t* done_in;       // [B] bool
  uint8_t* done_out;
  const int32_t* iters_in;      // [B]
  int32_t* iters_out;
  const int16_t* cn_vn;         // [dc*m_pad] VN per slot (clipped to n-1)
  const int16_t* vfc;           // [n*dv] slot per VN edge, dc*m_pad = fill
  const int16_t* deg;           // [m_pad] valid slots per check row
  int8_t* synd_hat;             // [m_pad, B] decoded syndrome, or null
  int n, m_pad, dc, dv, S, num_iter, hist_from;
  long long B;
  float alpha, clip, big, thresh, pin;
};

template <typename T, bool MASKED, typename HT>
__global__ void __launch_bounds__(kMaxThreads) bp_span_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = a.S, n = a.n, m_pad = a.m_pad, dc = a.dc, dv = a.dv;
  const int edges = dc * m_pad;
  const long long B = a.B;
  const Layout L = make_layout(sizeof(T), n, m_pad, dc, dv, S);
  T* msg = (T*)(smem + L.msg);     // [(edges + 1) * S], shot fastest
  T* post = (T*)(smem + L.post);   // [n * S]
  float* prior = (float*)(smem + L.prior);
  int16_t* cn_vn = (int16_t*)(smem + L.cn_vn);
  int16_t* vfc = (int16_t*)(smem + L.vfc);
  int16_t* deg = (int16_t*)(smem + L.deg);
  int8_t* vst = (int8_t*)(smem + L.vst);  // [n * S]
  int8_t* par = (int8_t*)(smem + L.par);  // [m_pad * S]
  int8_t* syn = (int8_t*)(smem + L.syn);  // [m_pad * S] target, decoded parity << 1
  int* done_s = (int*)(smem + L.shot);
  int* iters_s = done_s + S;
  int* ran_s = iters_s + S;
  int* mism = ran_s + S;

  // blockDim.x is a multiple of S: each thread keeps one shot and walks the
  // rows (checks, VNs, edges) r0, r0 + step, ...
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int shot = tid % S, r0 = tid / S, step = nthr / S;
  const long long b0 = (long long)blockIdx.x * S;
  const int nshots = (int)((B - b0) < S ? (B - b0) : S);
  const long long b = b0 + shot;
  const bool live = shot < nshots;

  const float alpha = a.alpha, clip = a.clip, big = a.big, thresh = a.thresh;
  const T pin = from_f<T>(a.pin), neg_pin = from_f<T>(-a.pin);

  // 1. tables and per-shot state
  for (int k = tid; k < edges; k += nthr) cn_vn[k] = a.cn_vn[k];
  for (int k = tid; k < n * dv; k += nthr) vfc[k] = a.vfc[k];
  for (int k = tid; k < m_pad; k += nthr) deg[k] = a.deg[k];
  for (int k = tid; k < n; k += nthr) prior[k] = a.prior[k];
  for (int r = r0; r < m_pad; r += step) {
    par[r * S + shot] = live ? (int8_t)a.parity[r * B + b] : (int8_t)0;
    syn[r * S + shot] = live ? (int8_t)a.synd[r * B + b] : (int8_t)0;
  }
  if (MASKED) {
    for (int v = r0; v < n; v += step)
      vst[v * S + shot] = (live && a.vn_state) ? a.vn_state[b * n + v] : (int8_t)-1;
  }
  if (tid < S) {
    const bool l = tid < nshots;
    done_s[tid] = l ? (int)a.done_in[b0 + tid] : 1;  // a missing shot is done
    iters_s[tid] = l ? a.iters_in[b0 + tid] : 0;
    ran_s[tid] = 0;
    mism[tid] = 0;
    msg[edges * S + tid] = from_f<T>(0.f);  // the fill row
  }
  __syncthreads();

  // 2. messages; in masked mode the edges of decided VNs and the invalid
  // slots are pinned once, here
  const T* mv_in = (const T*)a.mv_in;
  if (live) {
    for (int e = r0; e < edges; e += step) {
      const int s = e / m_pad, r = e - s * m_pad;
      T x = mv_in[s * a.st_s + r * a.st_i + b * a.st_b];
      if (MASKED && (s >= deg[r] || vst[cn_vn[e] * S + shot] != -1)) x = pin;
      msg[e * S + shot] = x;
    }
  }

  const int ss = m_pad * S;  // distance between two slots of one check
  for (int it = 0; it < a.num_iter; ++it) {
    __syncthreads();
    bool all_done = true;
    for (int k = 0; k < S; ++k) all_done &= done_s[k] != 0;
    if (all_done) break;  // block-uniform: every thread read the same flags
    const bool active = !done_s[shot];

    // CN stage, in place: mv -> mc on the valid slots
    if (active) {
      for (int r = r0; r < m_pad; r += step) {
        const int d = deg[r];
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
    __syncthreads();

    // VN stage: posterior, its rounded (and pinned) copy, history
    if (active) {
      const bool hist_on = it >= a.hist_from;
      HT* hist = (HT*)a.hist + (long long)(it & 3) * B + b;
      for (int v = r0; v < n; v += step) {
        const int16_t* vf = vfc + v * dv;
        float acc = to_f(msg[vf[0] * S + shot]);
        for (int j = 1; j < dv; ++j) acc = __fadd_rn(acc, to_f(msg[vf[j] * S + shot]));
        const float p = __fadd_rn(prior[v], acc);
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
    __syncthreads();

    // edge stage: new messages and the syndrome check
    if (active) {
      const bool keep = a.synd_hat != nullptr;
      int bad = 0;
      for (int r = r0; r < m_pad; r += step) {
        const int d = deg[r];
        int cnt = 0;
        for (int s = 0; s < d; ++s) {
          const int e = s * m_pad + r;
          const float pe = to_f(post[cn_vn[e] * S + shot]);
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
    __syncthreads();

    if (tid < S) {
      if (!done_s[tid]) {
        iters_s[tid] += 1;
        ran_s[tid] = 1;
        if (!mism[tid]) done_s[tid] = 1;
      }
      mism[tid] = 0;
    }
  }
  __syncthreads();

  // 3. store
  T* mv_out = (T*)a.mv_out;
  if (live) {
    const bool ran = ran_s[shot] != 0;
    const T last = post[(n - 1) * S + shot];  // read only if the shot ran
    for (int e = r0; e < edges; e += step) {
      const int s = e / m_pad, r = e - s * m_pad;
      T x = msg[e * S + shot];
      if (!MASKED && ran && s >= deg[r]) x = last;
      mv_out[(long long)e * B + b] = x;
    }
  }
  // errors [B, n]: consecutive threads on consecutive VNs of one shot
  for (int k = tid; k < nshots * n; k += nthr) {
    const int sh = k / n, v = k - sh * n;
    const long long o = (b0 + sh) * n + v;
    a.err_out[o] = ran_s[sh] ? (int8_t)(to_f(post[v * S + sh]) <= 0.f) : a.err_in[o];
  }
  if (a.synd_hat && live) {
    const int bit = ran_s[shot] ? 1 : 0;
    for (int r = r0; r < m_pad; r += step)
      a.synd_hat[(long long)r * B + b] = (int8_t)((syn[r * S + shot] >> bit) & 1);
  }
  if (tid < nshots) {
    a.done_out[b0 + tid] = (uint8_t)(done_s[tid] != 0);
    a.iters_out[b0 + tid] = iters_s[tid];
  }
}

template <typename T, bool MASKED, typename HT>
int launch(const Args& a, int threads, void* stream) {
  if (a.B == 0) return 0;
  const Layout L = make_layout(sizeof(T), a.n, a.m_pad, a.dc, a.dv, a.S);
  if (a.S < 1 || threads < a.S || threads % a.S || threads > kMaxThreads ||
      L.total > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bp_span_kernel<T, MASKED, HT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (a.B + a.S - 1) / a.S;
  bp_span_kernel<T, MASKED, HT>
      <<<(unsigned)blocks, threads, L.total, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

Args make_args(const void* mv_in, long long st_s, long long st_i, long long st_b,
               void* mv_out, const void* prior, const void* parity, const void* synd,
               const void* vn_state, void* hist, const void* err_in, void* err_out,
               const void* done_in, void* done_out, const void* iters_in,
               void* iters_out, const void* cn_vn, const void* vfc, const void* deg,
               void* synd_hat, int n, int m_pad, int dc, int dv, long long B, int S,
               int num_iter, int hist_from, float alpha, float clip, float big,
               float thresh, float pin) {
  Args a;
  a.mv_in = mv_in;
  a.st_s = st_s;
  a.st_i = st_i;
  a.st_b = st_b;
  a.mv_out = mv_out;
  a.prior = (const float*)prior;
  a.parity = (const int32_t*)parity;
  a.synd = (const int32_t*)synd;
  a.vn_state = (const int8_t*)vn_state;
  a.hist = hist;
  a.err_in = (const int8_t*)err_in;
  a.err_out = (int8_t*)err_out;
  a.done_in = (const uint8_t*)done_in;
  a.done_out = (uint8_t*)done_out;
  a.iters_in = (const int32_t*)iters_in;
  a.iters_out = (int32_t*)iters_out;
  a.cn_vn = (const int16_t*)cn_vn;
  a.vfc = (const int16_t*)vfc;
  a.deg = (const int16_t*)deg;
  a.synd_hat = (int8_t*)synd_hat;
  a.n = n;
  a.m_pad = m_pad;
  a.dc = dc;
  a.dv = dv;
  a.S = S;
  a.num_iter = num_iter;
  a.hist_from = hist_from;
  a.B = B;
  a.alpha = alpha;
  a.clip = clip;
  a.big = big;
  a.thresh = thresh;
  a.pin = pin;
  return a;
}

}  // namespace

extern "C" {

// One entry point per (message dtype, mode, ring dtype). alpha, clip, big,
// thresh and pin arrive already rounded to the message dtype; the unmasked
// entry points ignore thresh, pin and vn_state. synd_hat may be null.
#define BP_SPAN_ENTRY(NAME, T, MASKED, HT)                                          \
  int NAME(const void* mv_in, long long st_s, long long st_i, long long st_b,       \
           void* mv_out, const void* prior, const void* parity, const void* synd,   \
           const void* vn_state, void* hist, const void* err_in, void* err_out,     \
           const void* done_in, void* done_out, const void* iters_in,               \
           void* iters_out, const void* cn_vn, const void* vfc, const void* deg,    \
           void* synd_hat, int n, int m_pad, int dc, int dv, long long B, int S,    \
           int threads, int num_iter, int hist_from, float alpha, float clip,       \
           float big, float thresh, float pin, void* stream) {                      \
    const Args a = make_args(mv_in, st_s, st_i, st_b, mv_out, prior, parity, synd,  \
                             vn_state, hist, err_in, err_out, done_in, done_out,    \
                             iters_in, iters_out, cn_vn, vfc, deg, synd_hat, n,     \
                             m_pad, dc, dv, B, S, num_iter, hist_from, alpha, clip, \
                             big, thresh, pin);                                     \
    return launch<T, MASKED, HT>(a, threads, stream);                               \
  }

BP_SPAN_ENTRY(bp_span_f32, float, false, float)
BP_SPAN_ENTRY(bp_span_bf16, __nv_bfloat16, false, float)
BP_SPAN_ENTRY(bp_span_pinned_f32, float, true, float)
BP_SPAN_ENTRY(bp_span_pinned_bf16, __nv_bfloat16, true, float)
BP_SPAN_ENTRY(bp_span_f32_ring_bf16, float, false, __nv_bfloat16)
BP_SPAN_ENTRY(bp_span_bf16_ring_bf16, __nv_bfloat16, false, __nv_bfloat16)
BP_SPAN_ENTRY(bp_span_pinned_f32_ring_bf16, float, true, __nv_bfloat16)
BP_SPAN_ENTRY(bp_span_pinned_bf16_ring_bf16, __nv_bfloat16, true, __nv_bfloat16)

// Shared memory of one block, as the launch computes it.
long long bp_span_smem_bytes(int elem_size, int n, int m_pad, int dc, int dv, int S) {
  return (long long)make_layout((size_t)elem_size, n, m_pad, dc, dv, S).total;
}

const char* swd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
