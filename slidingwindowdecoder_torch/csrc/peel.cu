// The peel: degree-1 check forcing to the batch's fixpoint, for Hopper
// (sm_90a), on the batch-major ([B, n] / [B, m]) or the transposed
// ([n, B] / [m_pad, B]) decimation state.
//
// Replaces no Pallas kernel: it is the JAX package's XLA while-loops
// `ops/decimation.py:peel` and `peel_t` (`lax.while_loop` over forcing
// sweeps), which PyTorch cannot run on the card without a host read of the
// loop condition after every sweep. Plain version: `ops/decimation.py:
// _peel_loop` in this package (one `_sweep` / `_sweep_t` of torch ops a
// sweep, one host read each).
//
// What the JAX loop computes. A sweep takes, from the state at its start,
// every undecided VN next to an active check (state != -1) of degree 1;
// forced to that check's parity, or both ways, which kills the column
// (`dead`) and sets nothing. It then decides the forced VNs at once
// (`vn_set_values`): each check's degree drops by its newly decided
// neighbours and its parity flips by the XOR of their values; a check that
// reaches degree 0 with parity 1 kills the column, with parity 0 turns
// inactive (-1). The loop runs one sweep, then another while any column
// forced a VN in its last sweep and is not dead after it, at most
// `max_sweeps` in all. Columns are independent but the stop is the
// batch's: dead columns are swept along.
//
// Design. Per column, the sweeps that force while the column stays live
// are a prefix 1..L_c (a sweep that forces nothing changes nothing, and
// death is permanent), so the batch runs S = max(1, min(max_c L_c + 1,
// max_sweeps)) sweeps. Two launches of one kernel on the stream, no host
// read:
//   pass 1  every column sweeps until a sweep forces nothing (its fixpoint:
//           later sweeps are no-ops), or it is dead after a sweep that
//           forced (it pauses there), or it reaches max_sweeps; it does
//           atomicMax of its sweeps (L_c + 1, or the cap) into S and
//           records a paused column's sweeps in `status`;
//   pass 2  each paused column sweeps on until it has run S sweeps or
//           reaches its fixpoint; blocks with no paused column return at
//           once.
// One warp owns one column and holds its whole state in shared memory for
// all its sweeps; a block holds up to kMaxCols columns, loaded and stored
// by the whole block (neighbouring threads on neighbouring bytes of the
// state's contiguous axis). A sweep has three phases, a __syncwarp between
// them, so that it acts all at once on the state at its start:
//   A  each lane walks its checks; a degree-1 active check ORs its code
//      (1: parity 0, 2: parity 1) into the force word of each undecided
//      neighbour (shared-memory atomicOr on the packed bytes);
//   B  each lane walks its force words; a VN with one code is decided and
//      adds 1 + (value << 16) into the delta of each of its checks (shared
//      atomicAdd: integer sums, so their order changes nothing); a VN with
//      both codes kills the column;
//   C  each lane applies the deltas of its checks: degree, parity, the
//      contradiction test and the deactivation, as vn_set_values does.
// Phase A walks the table row of degree-1 checks only and phase B the
// checks of forced VNs only, so a sweep costs O(m + n/4) reads a lane
// beyond the forcing itself.
//
// Bound. The state is read once and written once (vn n bytes, cn and its
// int32 degree 5 bytes a check row, dead 1 byte, a column), and the
// tables read once: bytes bound it (`utils/roofline.py:peel_bound`). What
// the design pays beyond that: a pass-2 block reloads and restores its
// tile, and a warp's sweeps are a chain of dependent shared-memory phases.
//
// Encodings. vn: -1 undecided, 0/1 decided; cn: -1 inactive, 0/1 parity;
// deg int32; dead 0/1. `cn_vn` [m, dc] int32 (the pad index n marks an
// empty slot), `vn_cn` [n, dv] int32 (the pad index m marks one: in the
// transposed layout it names the first pad row, which the layout keeps
// inert, so skipping it reads what the plain version reads). The pad rows
// m..m_pad of the transposed state are copied as they are.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCols = 8;  // columns (warps) a block
constexpr size_t kMaxSmem = 232448;

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }
__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Byte offsets of one column's arrays in shared memory.
struct Layout {
  size_t vn, force, cn, deg, delta, col;
};

__host__ __device__ inline Layout make_layout(int n, int rows) {
  Layout L;
  size_t o = 0;
  L.vn = o;     o = align16(o + (size_t)round4(n));
  L.force = o;  o = align16(o + (size_t)round4(n));  // packed bytes, read as words
  L.cn = o;     o = align16(o + (size_t)rows);
  L.deg = o;    o = align16(o + (size_t)rows * 4);
  L.delta = o;  o = align16(o + (size_t)rows * 4);
  L.col = o;
  return L;
}

struct Args {
  const int8_t* vn_in;      // [B, n] or [n, B]
  const int8_t* cn_in;      // [B, rows] or [rows, B]
  const int32_t* deg_in;
  const uint8_t* dead_in;   // [B]
  int8_t* vn;               // outputs, same layouts
  int8_t* cn;
  int32_t* deg;
  uint8_t* dead;
  const int32_t* cn_vn;     // [m, dc], pad >= n
  const int32_t* vn_cn;     // [n, dv], pad >= m
  int32_t* status;          // [B] sweeps run by a paused column after pass 1, else 0
  int32_t* S;               // the batch's sweeps (atomicMax in pass 1)
  unsigned long long* stats;  // [2] += S, += column-sweeps run
  int n, m, rows, dc, dv, cap;
  long long B;
  bool transposed;
};

// Element (r, c) of a [rows, B] (transposed) or [B, rows] array.
__device__ inline long long at(const Args& a, int r, long long c, int rows) {
  return a.transposed ? (long long)r * a.B + c : c * rows + r;
}

// Load (store) the tile's columns [c0, c0 + cols) of one array of `rows`
// rows between device memory and shared memory (column j's copy at
// smem + j * stride), skipping the columns whose `use` flag is clear.
template <typename T>
__device__ void copy_tile(const Args& a, const T* src, T* dst, unsigned char* smem,
                          size_t off, size_t stride, int rows, long long c0, int cols,
                          const int* use, bool load) {
  const int total = rows * cols;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    int r, j;
    if (a.transposed) {  // neighbouring threads: neighbouring columns of a row
      r = i / cols;
      j = i - r * cols;
    } else {  // neighbouring threads: neighbouring rows of a column
      j = i / rows;
      r = i - j * rows;
    }
    if (!use[j]) continue;
    T* s = (T*)(smem + j * stride + off) + r;
    const long long g = at(a, r, c0 + j, rows);
    if (load) *s = src[g];
    else dst[g] = *s;
  }
}

// One sweep of one column by its warp. Returns (through the flags) whether
// it forced a VN and whether it killed the column.
__device__ inline void sweep(const Args& a, int8_t* vn, unsigned* force, int8_t* cn,
                             int32_t* deg, int32_t* delta, int lane, bool* forced_any,
                             bool* killed) {
  bool forced = false, kill = false;
  // A: degree-1 active checks mark their undecided neighbours
  for (int r = lane; r < a.m; r += 32) {
    const int c = cn[r];
    if (c == -1 || deg[r] != 1) continue;
    const unsigned code = c == 1 ? 2u : 1u;
    const int32_t* row = a.cn_vn + (long long)r * a.dc;
    for (int s = 0; s < a.dc; ++s) {
      const int v = __ldg(row + s);
      if (v >= a.n || vn[v] != -1) continue;
      atomicOr(force + (v >> 2), code << ((v & 3) * 8));
    }
  }
  __syncwarp();
  // B: decide the VNs forced one way; both ways kills the column
  const int words = (a.n + 3) >> 2;
  for (int w = lane; w < words; w += 32) {
    const unsigned word = force[w];
    if (!word) continue;
    force[w] = 0;
    for (int b = 0; b < 4; ++b) {
      const unsigned f = (word >> (b * 8)) & 3u;
      if (!f) continue;
      if (f == 3u) {
        kill = true;
        continue;
      }
      const int v = w * 4 + b;
      const int val = f == 2u;
      vn[v] = (int8_t)val;
      forced = true;
      const int32_t* row = a.vn_cn + (long long)v * a.dv;
      for (int t = 0; t < a.dv; ++t) {
        const int r = __ldg(row + t);
        if (r < a.m) atomicAdd(delta + r, 1 + (val << 16));
      }
    }
  }
  __syncwarp();
  // C: apply each touched check's degree drop and parity flip
  for (int r = lane; r < a.m; r += 32) {
    const int d = delta[r];
    if (!d) continue;
    delta[r] = 0;
    const int cnt = d & 0xFFFF;
    const int flip = (d >> 16) & 1;
    const int c = cn[r];
    const bool active = c != -1;
    const int nd = deg[r] - cnt;
    const int np = active ? (c ^ flip) : c;
    const bool hit = active && nd == 0 && cnt > 0;
    if (hit && np == 1) kill = true;
    cn[r] = (int8_t)((hit && np == 0) ? -1 : np);
    deg[r] = nd;
  }
  __syncwarp();
  *forced_any = __any_sync(0xffffffffu, forced);
  *killed = __any_sync(0xffffffffu, kill);
}

__global__ void __launch_bounds__(32 * kMaxCols) peel_kernel(Args a, int pass) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int use[kMaxCols];
  __shared__ unsigned long long block_sweeps;
  const int cols = blockDim.x >> 5;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long c0 = (long long)blockIdx.x * cols;
  const long long col = c0 + w;
  const Layout L = make_layout(a.n, a.rows);
  const int S = pass == 2 ? *a.S : 0;

  if (pass == 2 && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(a.stats, (unsigned long long)S);
  if (threadIdx.x == 0) block_sweeps = 0;
  if (lane == 0) {
    bool u = col < a.B;
    if (pass == 2) u = u && a.status[col] > 0 && a.status[col] < S;
    use[w] = u;
  }
  if (!__syncthreads_or(lane == 0 && use[w])) return;

  const int8_t* vsrc = pass == 1 ? a.vn_in : a.vn;
  const int8_t* csrc = pass == 1 ? a.cn_in : a.cn;
  const int32_t* dsrc = pass == 1 ? a.deg_in : a.deg;
  copy_tile(a, vsrc, (int8_t*)nullptr, smem, L.vn, L.col, a.n, c0, cols, use, true);
  copy_tile(a, csrc, (int8_t*)nullptr, smem, L.cn, L.col, a.rows, c0, cols, use, true);
  copy_tile(a, dsrc, (int32_t*)nullptr, smem, L.deg, L.col, a.rows, c0, cols, use, true);
  const int fwords = round4(a.n) >> 2;
  for (int i = threadIdx.x; i < cols * fwords; i += blockDim.x) {
    const int j = i / fwords;
    ((unsigned*)(smem + j * L.col + L.force))[i - j * fwords] = 0;
  }
  for (int i = threadIdx.x; i < cols * a.rows; i += blockDim.x) {
    const int j = i / a.rows;
    ((int32_t*)(smem + j * L.col + L.delta))[i - j * a.rows] = 0;
  }
  __syncthreads();

  if (use[w]) {
    unsigned char* base = smem + w * L.col;
    int8_t* vn = (int8_t*)(base + L.vn);
    unsigned* force = (unsigned*)(base + L.force);
    int8_t* cn = (int8_t*)(base + L.cn);
    int32_t* deg = (int32_t*)(base + L.deg);
    int32_t* delta = (int32_t*)(base + L.delta);
    bool dead = (pass == 1 ? a.dead_in : a.dead)[col] != 0;
    int k = pass == 1 ? 0 : a.status[col];
    const int k0 = k;
    while (true) {
      bool forced, killed;
      sweep(a, vn, force, cn, deg, delta, lane, &forced, &killed);
      dead = dead || killed;
      ++k;
      if (pass == 1) {
        // stop at the fixpoint, at death after a forcing sweep (paused: it
        // may need more of the batch's sweeps), or at the cap
        if (!forced || dead || k >= a.cap) {
          if (lane == 0) {
            atomicMax(a.S, k);
            a.status[col] = (forced && dead && k < a.cap) ? k : 0;
          }
          break;
        }
      } else if (!forced || k >= S) {
        break;
      }
    }
    if (lane == 0) {
      a.dead[col] = dead;
      atomicAdd(&block_sweeps, (unsigned long long)(k - k0));
    }
  }
  __syncthreads();
  copy_tile(a, (const int8_t*)nullptr, a.vn, smem, L.vn, L.col, a.n, c0, cols, use, false);
  copy_tile(a, (const int8_t*)nullptr, a.cn, smem, L.cn, L.col, a.rows, c0, cols, use, false);
  copy_tile(a, (const int32_t*)nullptr, a.deg, smem, L.deg, L.col, a.rows, c0, cols, use,
            false);
  if (threadIdx.x == 0) atomicAdd(a.stats + 1, block_sweeps);
}

}  // namespace

extern "C" {

// The peel of B columns: inputs and outputs (int8 vn [n] and cn [rows],
// int32 degrees [rows], uint8 dead, a column each; `transposed` the
// [rows, B] layouts, else [B, rows]; all contiguous), the int32 tables,
// the cap on the batch's sweeps (at least 1), `cols` columns a
// block, scratch `status` [B] int32 and `S` [1] int32 (zeroed by the
// caller), and `stats` [2] uint64 that the call adds its sweeps and
// column-sweeps to. Launches pass 1 and pass 2 on `stream`.
int peel_run(const void* vn_in, const void* cn_in, const void* deg_in, const void* dead_in,
             void* vn_out, void* cn_out, void* deg_out, void* dead_out, const void* cn_vn,
             const void* vn_cn, int n, int m, int rows, int dc, int dv, long long B,
             int transposed, int cap, int cols, void* status, void* S, void* stats,
             void* stream) {
  if (B == 0) return 0;
  const Layout L = make_layout(n, rows);
  const size_t smem = L.col * (size_t)cols;
  if (cap < 1 || cols < 1 || cols > kMaxCols || smem > kMaxSmem || m > rows || n < 1 || dv < 1 ||
      dc < 1 || B >= (1LL << 40))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.vn_in = (const int8_t*)vn_in;
  a.cn_in = (const int8_t*)cn_in;
  a.deg_in = (const int32_t*)deg_in;
  a.dead_in = (const uint8_t*)dead_in;
  a.vn = (int8_t*)vn_out;
  a.cn = (int8_t*)cn_out;
  a.deg = (int32_t*)deg_out;
  a.dead = (uint8_t*)dead_out;
  a.cn_vn = (const int32_t*)cn_vn;
  a.vn_cn = (const int32_t*)vn_cn;
  a.status = (int32_t*)status;
  a.S = (int32_t*)S;
  a.stats = (unsigned long long*)stats;
  a.n = n;
  a.m = m;
  a.rows = rows;
  a.dc = dc;
  a.dv = dv;
  a.cap = cap;
  a.B = B;
  a.transposed = transposed != 0;
  cudaError_t err = cudaFuncSetAttribute(peel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (B + cols - 1) / cols;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  for (int pass = 1; pass <= 2; ++pass) {
    peel_kernel<<<(unsigned)blocks, 32 * cols, smem, (cudaStream_t)stream>>>(a, pass);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// One column's dynamic shared memory, as the launch lays it out.
long long peel_smem_per_column(int n, int rows) { return (long long)make_layout(n, rows).col; }

const char* swd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
