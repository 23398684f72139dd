// A whole `bp4_run` call (quaternary BP over Hx and Hz) in one launch, for
// Hopper (sm_90a).
//
// Replaces, on the BP4 paths, the per-iteration launches of the JAX
// package's Pallas kernel `ops/bp_pallas.py:_cn_kernel` (the min-sum check
// update; in JAX's BP4 the XLA `ops/bp4.py:_cn_minsum_bm`) together with
// the XLA ops of the rest of its `ops/bp4.py:bp4_run` iteration. Plain
// version: `ops/bp4.py:bp4_loop` in this package (the per-op loop, whose
// check stage is `csrc/cn_update.cu` on the card).
//
// Design. One block owns one shot (CAMEL: one branch lane). It loads the
// shot's messages on both graphs once, runs up to `num_iter` iterations
// with every intermediate in shared memory, and stores once. Per
// iteration:
//   check stage     kernel A's min-sum on every check of Hx and of Hz, in
//                   place (mv -> mc): clip, streaming (min1, min2), mag =
//                   (|x| == min1) ? min2 : min1, alpha * sign, the sign
//                   seeded by the check's parity bit (cn_x / cn_z);
//   variable stage  per variable, the sums of its incoming check messages
//                   on each graph, its valid slots added one at a time
//                   from slot 0 (the plain `_col_sums`; a variable with no
//                   edge sums to +0), walked through a CSR table (offsets,
//                   then the edges in slot order); the posteriors lprx =
//                   sum_hz + lx, lprz = sum_hx + lz, lpry = (sum_hx +
//                   sum_hz) + ly, the hard decision (decided variables keep
//                   their Pauli) and log1pexp(-lprx), log1pexp(-lprz);
//   edge stage      per check, each edge's new message num - logaddexp(
//                   -(lpr_a - mc), -(lpr_b - mc)) in place (the frozen
//                   initial value on a decided variable's edges), and the
//                   parity of the decided ez over the Hx check (ex over the
//                   Hz check) against the syndrome bit;
//   bookkeeping     iters += 1, done |= (every check matches).
// One thread walks one check row (check and edge stages) or one variable
// (variable stage). A variable's sums are chains of dependent adds as long
// as its degree: on [[362]] the last variable's 171 slots on each graph
// (two chains, interleaved), while the edge stage spreads that variable's
// 342 edges over the checks' threads. The block leaves the loop when its
// shot is done (a shared flag read after a barrier, so the test is uniform
// across the block) and retires, so a converged shot frees its SM slot at
// once. A shot done at entry keeps its incoming messages, zero posteriors
// and zero errors, as the plain version gives them; otherwise the outputs
// are those of its last active iteration. Nothing waits on the host.
//
// Exactness. The plain version's f32 arithmetic in its op order:
// __fadd_rn / __fsub_rn / __fmul_rn so that nothing contracts into an FMA;
// expf and log1pf from CUDA's math library, compiled without fast math, as
// torch's own elementwise exp and log1p kernels are; logaddexp(a, b) =
// max(a, b) + log1pf(expf(-|a - b|)) and log1pexp(x) = max(0, x) +
// log1pf(expf(-|x|)), as the plain `logaddexp` / `log1pexp` compute them
// (which of two equal arguments the max returns changes nothing: only +-0
// can tie unequal bits, and then log1pf(expf(-0)) is added). At the store
// an invalid slot of a shot that ran gets 0, and every slot of a shot that
// never ran its incoming value.
//
// Bound. Per shot-iteration the block does BP4_OPS_PER_EDGE operations per
// edge and BP4_OPS_PER_VN per variable (`utils/roofline.py`, counted from
// this source) out of shared memory; device memory sees one read of the
// messages, syndromes, sign seeds and decisions and one write of the nine
// outputs per call, so the operations bound it. What the design pays
// instead: every stage is a walk of dependent shared-memory accesses per
// thread, and four barriers an iteration.
//
// Shared memory (`make_layout`; `ops/bp4_cuda.py:bp4_span_smem_bytes`
// computes the same total), per block:
//   msg   f32 [nnz_x + nnz_z]  the messages of the valid edges, Hx's then
//                              Hz's, each check's slots in order
//   lpr   f32 [3][n]           lprx, lpry, lprz
//   num   f32 [2][n]           log1pexp(-lprx), log1pexp(-lprz)
//   vf    u8  [n]              bit 0 ex, bit 1 ez, bit 2 decided, bits 3-4
//                              the decided Pauli's x and z
//   cf    u8  [m_x + m_z]      bit 0 the syndrome, bit 1 the sign seed
//   shot  i32 [4]              done, iters, ran, mismatch
// [[882]] (441x882 twice, 2646 edges each): 40,624 B; [[362]] (171x362
// twice, 3420 edges each): 35,344 B. A block has kThreads = 256 threads;
// with at most 64 registers a thread (`__launch_bounds__`) four blocks
// share an SM. An earlier design held 5 or 6 shots a block of 1020
// threads, shot index fastest: it ran 2.3x and 1.9x slower on the bp4 and
// CAMEL batches, its converged shots' threads idling until the block's
// slowest shot was done. The tables (per graph: check offsets, the
// variable of each edge, variable offsets and the edges of each variable,
// int16) and the per-variable constants (lx, ly, lz and the two frozen
// messages, f32) are read from device memory through the read-only data
// cache (__ldg): every block shares them and they stay in L2, so shared
// memory holds the shot's state only.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// Byte offsets of the shared-memory arrays of one block.
struct Layout {
  size_t msg, lpr, num, vf, cf, shot, total;
};

__host__ __device__ inline Layout make_layout(int n, int rows, int nnz) {
  Layout L;
  size_t o = 0;
  L.msg = o;   o = align16(o + (size_t)nnz * 4);
  L.lpr = o;   o = align16(o + (size_t)3 * n * 4);
  L.num = o;   o = align16(o + (size_t)2 * n * 4);
  L.vf = o;    o = align16(o + (size_t)n);
  L.cf = o;    o = align16(o + (size_t)rows);
  L.shot = o;  o = align16(o + 4 * 4);
  L.total = o;
  return L;
}

// Graph g's tables (g = 0: Hx, 1: Hz), int16, in device memory.
struct Graph {
  const float* mv_in;      // [dc, m_pad, B] at the element strides below
  long long st_s, st_i, st_b;
  float* mv_out;           // [dc, m_pad, B] contiguous
  const uint8_t* synd;     // [B, m] 0/1 syndrome
  const uint8_t* seed;     // [B, m] 0/1 sign seed (the syndrome adjusted by decisions)
  const int16_t* row_ptr;  // [m + 1] first edge of each check
  const int16_t* row_vn;   // [nnz] variable of each edge
  const int16_t* var_ptr;  // [n + 1] first entry of each variable in var_edge
  const int16_t* var_edge; // [nnz] edges of each variable, in its slot order
  int m, m_pad, dc, nnz;
};

struct Args {
  Graph g[2];
  const int8_t* vn_state;  // [B, n] -1 undecided, else the Pauli x + 2z
  const float* vconst;     // [5, n] lx, ly, lz, frozen Hx message, frozen Hz message
  const uint8_t* done_in;  // [B] bool
  uint8_t* done_out;
  const int32_t* iters_in; // [B]
  int32_t* iters_out;
  float* lpr_out[3];       // [B, n] lprx, lpry, lprz
  int8_t* err_out[2];      // [B, n] ex, ez
  int n, num_iter;
  long long B;
  float alpha, clip, big;
};

__device__ __forceinline__ int ld(const int16_t* p) { return __ldg(p); }

// logaddexp(a, b) as the plain version computes it
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float hi = fmaxf(a, b);
  return __fadd_rn(hi, log1pf(expf(-fabsf(__fsub_rn(a, b)))));
}

#ifdef BP4_SPAN_CLOCKS
// The probe build only (`tools/torch_probe_bp4_span.py` compiles this file
// with -DBP4_SPAN_CLOCKS): the cycles between consecutive barriers on
// thread 0, that is each stage's time up to its slowest thread, summed over
// the blocks: [0] the entry's loads, [1] check, [2] variable and [3] edge
// stages, [4] bookkeeping and the done test, [5] block-iterations.
__device__ unsigned long long bp4_span_clocks[6];
#define STAGE_CLOCK(k)                 \
  if (tid == 0) {                      \
    const long long now = clock64();   \
    cyc[k] += now - t_last;            \
    t_last = now;                      \
  }
#else
#define STAGE_CLOCK(k)
#endif

__global__ void __launch_bounds__(kThreads, 4) bp4_span_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n;
  const int mx = a.g[0].m;
  const int off_z = a.g[0].nnz;  // Hz's edges follow Hx's in msg
  const Layout L = make_layout(n, mx + a.g[1].m, a.g[0].nnz + a.g[1].nnz);
  float* msg = (float*)(smem + L.msg);
  float* lpr = (float*)(smem + L.lpr);
  float* num = (float*)(smem + L.num);
  uint8_t* vf = smem + L.vf;
  uint8_t* cf = smem + L.cf;
  int& done_s = ((int*)(smem + L.shot))[0];
  int& iters_s = ((int*)(smem + L.shot))[1];
  int& ran_s = ((int*)(smem + L.shot))[2];
  int& mism_s = ((int*)(smem + L.shot))[3];

  // each thread walks the rows (checks of both graphs, variables) tid,
  // tid + kThreads, ...
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  const float alpha = a.alpha, clip = a.clip, big = a.big;
  const float* lx = a.vconst;
  const float* ly = lx + n;
  const float* lz = ly + n;
#ifdef BP4_SPAN_CLOCKS
  long long cyc[6] = {0, 0, 0, 0, 0, 0}, t_last = clock64();
#endif

  // 1. the shot's state
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const Graph& G = a.g[g];
    for (int r = tid; r < G.m; r += kThreads) {
      const long long o = b * G.m + r;
      cf[g * mx + r] = (uint8_t)((G.synd[o] & 1) | ((G.seed[o] & 1) << 1));
    }
  }
  for (int v = tid; v < n; v += kThreads) {
    const int st = a.vn_state[b * n + v];
    vf[v] = st != -1 ? (uint8_t)(4 | ((st & 1) << 3) | ((st >> 1) << 4)) : 0;
    for (int q = 0; q < 3; ++q) lpr[q * n + v] = 0.f;
  }
  if (tid == 0) {
    done_s = (int)a.done_in[b];
    iters_s = a.iters_in[b];
    ran_s = 0;
    mism_s = 0;
  }

  // 2. the messages of the valid edges
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const Graph& G = a.g[g];
    for (int r = tid; r < G.m; r += kThreads) {
      const int k0 = ld(G.row_ptr + r), d = ld(G.row_ptr + r + 1) - k0;
      const float* in = G.mv_in + r * G.st_i + b * G.st_b;
      float* col = msg + g * off_z + k0;
      for (int s = 0; s < d; ++s) col[s] = in[s * G.st_s];
    }
  }

  for (int it = 0; it < a.num_iter; ++it) {
    __syncthreads();
    STAGE_CLOCK(it == 0 ? 0 : 4)
    if (done_s) break;  // block-uniform: every thread read the same flag
#ifdef BP4_SPAN_CLOCKS
    cyc[5] += 1;
#endif

    // check stage, both graphs, in place: mv -> mc
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const Graph& G = a.g[g];
      for (int r = tid; r < G.m; r += kThreads) {
        const int k0 = ld(G.row_ptr + r), d = ld(G.row_ptr + r + 1) - k0;
        float* col = msg + g * off_z + k0;
        float min1 = big, min2 = big;
        int nneg = 0;
        for (int s = 0; s < d; ++s) {
          const float c = fminf(fmaxf(col[s], -clip), clip);
          const float x = fminf(fabsf(c), big);
          if (x < min1) {
            min2 = min1;
            min1 = x;
          } else {
            min2 = fminf(min2, x);
          }
          nneg += (c <= 0.f);
        }
        const int odd = ((cf[g * mx + r] >> 1) + nneg) & 1;
        for (int s = 0; s < d; ++s) {
          const float c = fminf(fmaxf(col[s], -clip), clip);
          const float x = fminf(fabsf(c), big);
          const float mag = (x == min1) ? min2 : min1;
          const bool flip = (odd ^ (int)(c <= 0.f)) != 0;
          col[s] = __fmul_rn(alpha, flip ? -mag : mag);
        }
      }
    }
    __syncthreads();
    STAGE_CLOCK(1)

    // variable stage: sums, posteriors, decision, log1pexp terms
    {
      const Graph& X = a.g[0];
      const Graph& Z = a.g[1];
      for (int v = tid; v < n; v += kThreads) {
        const int px = ld(X.var_ptr + v), dx = ld(X.var_ptr + v + 1) - px;
        const int pz = ld(Z.var_ptr + v), dz = ld(Z.var_ptr + v + 1) - pz;
        float sum_hx = 0.f, sum_hz = 0.f;  // +0: the zero fill row
        if (dx > 0) sum_hx = msg[ld(X.var_edge + px)];
        if (dz > 0) sum_hz = msg[off_z + ld(Z.var_edge + pz)];
        const int dmax = dx > dz ? dx : dz;
        for (int j = 1; j < dmax; ++j) {  // the two chains, interleaved
          if (j < dx) sum_hx = __fadd_rn(sum_hx, msg[ld(X.var_edge + px + j)]);
          if (j < dz) sum_hz = __fadd_rn(sum_hz, msg[off_z + ld(Z.var_edge + pz + j)]);
        }
        const float lprx = __fadd_rn(sum_hz, __ldg(lx + v));
        const float lprz = __fadd_rn(sum_hx, __ldg(lz + v));
        const float lpry = __fadd_rn(__fadd_rn(sum_hx, sum_hz), __ldg(ly + v));
        // hard decision (bp4_osd.pyx:560-573)
        int idx;
        if (lprx > 0.f && lpry > 0.f && lprz > 0.f) idx = 0;
        else if (lprx < lpry && lprx < lprz) idx = 1;
        else if (lpry > lprz) idx = 2;
        else idx = 3;
        const int f = vf[v];
        const int e = (f & 4) ? (f >> 3) & 3 : idx;  // x in bit 0, z in bit 1
        vf[v] = (uint8_t)((f & ~3) | e);
        lpr[v] = lprx;
        lpr[n + v] = lpry;
        lpr[2 * n + v] = lprz;
        num[v] = logaddexp(0.f, -lprx);
        num[n + v] = logaddexp(0.f, -lprz);
      }
    }
    __syncthreads();
    STAGE_CLOCK(2)

    // edge stage: new messages and the syndrome check
    {
      int bad = 0;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const Graph& G = a.g[g];
        // Hx: own lprx, a = lprz; Hz: own lprz, a = lprx; b = lpry
        const float* num_g = num + g * n;
        const float* lpr_a = lpr + (g ? 0 : 2) * n;
        const float* lpr_b = lpr + n;
        const float* frozen = a.vconst + (3 + g) * n;
        for (int r = tid; r < G.m; r += kThreads) {
          const int k0 = ld(G.row_ptr + r), d = ld(G.row_ptr + r + 1) - k0;
          float* col = msg + g * off_z + k0;
          int par = 0;
          for (int s = 0; s < d; ++s) {
            const int v = ld(G.row_vn + k0 + s);
            const int f = vf[v];
            float out;
            if (f & 4) {
              out = __ldg(frozen + v);
            } else {
              const float mc = col[s];
              const float ae = __fsub_rn(lpr_a[v], mc);
              const float be = __fsub_rn(lpr_b[v], mc);
              out = __fsub_rn(num_g[v], logaddexp(-ae, -be));
            }
            col[s] = out;
            par ^= (f >> (1 - g)) & 1;  // ez over Hx's checks, ex over Hz's
          }
          bad |= par != (cf[g * mx + r] & 1);
        }
      }
      if (bad) mism_s = 1;
    }
    __syncthreads();
    STAGE_CLOCK(3)

    if (tid == 0) {
      iters_s += 1;
      ran_s = 1;
      if (!mism_s) done_s = 1;
      mism_s = 0;
    }
  }
  __syncthreads();

  // 3. store: every slot of both [dc, m_pad, B] blocks
  const bool ran = ran_s != 0;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const Graph& G = a.g[g];
    for (int r = tid; r < G.m_pad; r += kThreads) {
      int k0 = 0, d = 0;
      if (r < G.m) {
        k0 = ld(G.row_ptr + r);
        d = ld(G.row_ptr + r + 1) - k0;
      }
      const float* col = msg + g * off_z + k0;
      for (int s = 0; s < G.dc; ++s) {
        float x;
        if (s < d) x = col[s];
        else x = ran ? 0.f : G.mv_in[s * G.st_s + r * G.st_i + b * G.st_b];
        G.mv_out[((long long)s * G.m_pad + r) * a.B + b] = x;
      }
    }
  }
  // posteriors and errors [B, n]
  for (int v = tid; v < n; v += kThreads) {
    const long long o = b * n + v;
    for (int q = 0; q < 3; ++q) a.lpr_out[q][o] = lpr[q * n + v];
    const int f = vf[v];
    a.err_out[0][o] = (int8_t)(f & 1);
    a.err_out[1][o] = (int8_t)((f >> 1) & 1);
  }
  if (tid == 0) {
    a.done_out[b] = (uint8_t)(done_s != 0);
    a.iters_out[b] = iters_s;
  }
#ifdef BP4_SPAN_CLOCKS
  if (tid == 0)
    for (int k = 0; k < 6; ++k) atomicAdd(bp4_span_clocks + k, (unsigned long long)cyc[k]);
#endif
}

Graph make_graph(const void* mv_in, long long st_s, long long st_i, long long st_b,
                 void* mv_out, const void* synd, const void* seed, const void* row_ptr,
                 const void* row_vn, const void* var_ptr, const void* var_edge, int m,
                 int m_pad, int dc, int nnz) {
  Graph G;
  G.mv_in = (const float*)mv_in;
  G.st_s = st_s;
  G.st_i = st_i;
  G.st_b = st_b;
  G.mv_out = (float*)mv_out;
  G.synd = (const uint8_t*)synd;
  G.seed = (const uint8_t*)seed;
  G.row_ptr = (const int16_t*)row_ptr;
  G.row_vn = (const int16_t*)row_vn;
  G.var_ptr = (const int16_t*)var_ptr;
  G.var_edge = (const int16_t*)var_edge;
  G.m = m;
  G.m_pad = m_pad;
  G.dc = dc;
  G.nnz = nnz;
  return G;
}

}  // namespace

extern "C" {

// One whole bp4_run call. Per graph (x: Hx, z: Hz): the incoming messages
// and their element strides, the output block, the [B, m] uint8 syndrome
// and sign seed, the four int16 tables, m, m_pad, dc and the valid edges.
// alpha, clip and big arrive already rounded to float32.
int bp4_span_f32(const void* mvx_in, long long sx_s, long long sx_i, long long sx_b,
                 void* mvx_out, const void* synd_x, const void* seed_x,
                 const void* row_ptr_x, const void* row_vn_x, const void* var_ptr_x,
                 const void* var_edge_x, int mx, int m_pad_x, int dc_x, int nnz_x,
                 const void* mvz_in, long long sz_s, long long sz_i, long long sz_b,
                 void* mvz_out, const void* synd_z, const void* seed_z,
                 const void* row_ptr_z, const void* row_vn_z, const void* var_ptr_z,
                 const void* var_edge_z, int mz, int m_pad_z, int dc_z, int nnz_z,
                 const void* vn_state, const void* vconst, const void* done_in,
                 void* done_out, const void* iters_in, void* iters_out, void* lprx_out,
                 void* lpry_out, void* lprz_out, void* ex_out, void* ez_out, int n,
                 long long B, int num_iter, float alpha, float clip, float big,
                 void* stream) {
  if (B == 0) return 0;
  Args a;
  a.g[0] = make_graph(mvx_in, sx_s, sx_i, sx_b, mvx_out, synd_x, seed_x, row_ptr_x, row_vn_x,
                      var_ptr_x, var_edge_x, mx, m_pad_x, dc_x, nnz_x);
  a.g[1] = make_graph(mvz_in, sz_s, sz_i, sz_b, mvz_out, synd_z, seed_z, row_ptr_z, row_vn_z,
                      var_ptr_z, var_edge_z, mz, m_pad_z, dc_z, nnz_z);
  a.vn_state = (const int8_t*)vn_state;
  a.vconst = (const float*)vconst;
  a.done_in = (const uint8_t*)done_in;
  a.done_out = (uint8_t*)done_out;
  a.iters_in = (const int32_t*)iters_in;
  a.iters_out = (int32_t*)iters_out;
  a.lpr_out[0] = (float*)lprx_out;
  a.lpr_out[1] = (float*)lpry_out;
  a.lpr_out[2] = (float*)lprz_out;
  a.err_out[0] = (int8_t*)ex_out;
  a.err_out[1] = (int8_t*)ez_out;
  a.n = n;
  a.num_iter = num_iter;
  a.B = B;
  a.alpha = alpha;
  a.clip = clip;
  a.big = big;
  const Layout L = make_layout(n, mx + mz, nnz_x + nnz_z);
  if (L.total > kMaxSmem || nnz_x + nnz_z > 32767 || n > 32767 || B >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bp4_span_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  bp4_span_kernel<<<(unsigned)B, kThreads, L.total, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one block, as the launch computes it.
long long bp4_span_smem_bytes(int n, int rows, int nnz) {
  return (long long)make_layout(n, rows, nnz).total;
}

#ifdef BP4_SPAN_CLOCKS
// The probe build's stage clocks (see `bp4_span_clocks`): read them into
// `out` [6], then set them to 0.
int bp4_span_take_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, bp4_span_clocks, sizeof(bp4_span_clocks));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(bp4_span_clocks, zero, sizeof(zero));
}
#endif

const char* swd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
