// Decide and peel: one decision applied as `vn_set_values` applies it,
// then degree-1 check forcing to the batch's fixpoint, in one launch, for
// Hopper (sm_90a), on the batch-major ([B, n] / [B, m]) or the transposed
// ([n, B] / [m_pad, B]) decimation state.
//
// Replaces no Pallas kernel: it is the JAX package's `ops/decimation.py:
// vn_set_values` / `vn_set_values_t` followed by its XLA while-loops
// `peel` / `peel_t` (`lax.while_loop` over forcing sweeps), which XLA
// fuses under `jit` and which PyTorch cannot run on the card without a
// host read of the loop condition after every sweep. Plain version:
// `ops/decimation.py` in this package, `vn_set_values(_t)` then `_peel_loop`
// (one `_sweep` / `_sweep_t` of torch ops a sweep, one host read each).
//
// The decision. Mode 0: none (the plain `peel`). Mode 1: a mask and
// values in the state's layout (values null: all 0). Mode 2: per column a
// VN index, a value and a do-set flag (the one-hot `(rows == index) &
// do_set`; an index outside [0, n) sets nothing). A set VN that is
// already decided to the other value kills the column (`dead`); a newly
// decided VN lowers the degree of each of its checks by one and flips the
// check's parity by its value; an active check (state != -1) that reaches
// degree 0 with parity 1 kills the column, with parity 0 turns inactive.
//
// The peel. A sweep takes, from the state at its start, every undecided VN
// next to an active check of degree 1, forced to that check's parity, or
// both ways, which kills the column and sets nothing; it then decides the
// forced VNs at once as above. The loop runs one sweep, then another while
// any column forced a VN in its last sweep and is not dead after it, at
// most `cap` (JAX's `max_sweeps`) in all. Columns are independent but the
// stop is the batch's: dead columns are swept along.
//
// Design. Per column, the sweeps that force while the column stays live
// are a prefix 1..L_c (a sweep that forces nothing changes nothing, and
// death is permanent), so the batch runs S = max(1, min(max_c L_c + 1,
// cap)) sweeps. One cooperative launch of a persistent grid (at most the
// blocks the card holds at once, so a grid barrier is safe):
//   phase 1  each block walks its tiles of `cols` columns: it loads the
//            tile into shared memory, applying a mode-1 decision as it
//            loads (the loading thread of a newly decided VN adds its
//            checks' deltas), a mode-2 one by the column's first lane;
//            each warp then applies its column's deltas and sweeps it until
//            a sweep forces nothing (its fixpoint), or it is dead after a
//            sweep that forced (it pauses there), or it reaches the cap;
//            `atomicMax` of its sweeps (L_c + 1, or the cap) into S; a
//            paused column goes onto a compact list with its sweep count;
//            the block stores the tile;
//   barrier  one grid barrier (a counter and a generation word);
//   phase 2  every warp of the grid takes paused columns off the list,
//            reloads each and sweeps it on until it has run S sweeps or
//            reaches its fixpoint; the last block to finish (a completion
//            counter) zeroes S, the list's length and the counters for the
//            next call on the stream.
// No host read, no second launch and no host work a call beyond the
// launch: the shared-memory attribute is set once per device and the
// occupancy is cached per size (`peel_run`).
// One warp owns one column for all its sweeps, its whole state in shared
// memory. In the transposed layout a block holds 32 columns where shared
// memory allows, so that a tile's int8 row is one whole 32-byte sector:
// with B a multiple of 4 and aligned bases a thread loads and stores 4
// columns of a row as one word (16 bytes of the degrees), 8 threads a
// row, else one byte a thread; the batch-major layout is contiguous along
// a column, and the block walks its few columns one at a time. Each
// thread issues several rows' loads before it uses any (kUnroll,
// kUnroll4), since one load at a time in flight left the tile's load
// bound by latency. A sweep has three phases, a __syncwarp between them,
// so that it acts all at once on the state at its start:
//   A  each lane walks its checks; a degree-1 active check ORs its code
//      (1: parity 0, 2: parity 1) into the 2-bit force field of each
//      undecided neighbour (shared-memory atomicOr, 16 VNs a word);
//   B  each lane walks its force words; a VN with one code is decided and
//      adds 1 + (value << 8) into the 16-bit delta of each of its checks
//      (shared atomicAdd on the word holding two checks: integer sums of
//      at most dc <= 255 terms a field, so their order changes nothing and
//      no field carries into the next); a VN with both codes kills the
//      column;
//   C  each lane applies the deltas of its checks: degree, parity, the
//      contradiction test and the deactivation. The decision ends in the
//      same step.
//
// Bound. The state is read once and written once (vn n bytes, cn and its
// int32 degree 5 bytes a check row, dead 1 byte, a column), the decision
// read once (mode 1: the mask's and the values' n bytes a column; mode 2:
// 10 bytes a column) and the tables read once: bytes bound it
// (`utils/roofline.py:decide_peel_bound`). What the design pays beyond
// that: a paused column's reload, a warp's sweeps as a chain of dependent
// shared-memory phases, and the tile's wait for its slowest column.
//
// Encodings. vn: -1 undecided, 0/1 decided; cn: -1 inactive, 0/1 parity;
// deg int32; dead 0/1; the mask, values, value and do-set bytes: nonzero
// is set / 1. `cn_vn` [m, dc] int32 (the pad index n marks an empty slot),
// `vn_cn` [n, dv] int32 (the pad index m marks one: in the transposed
// layout it names the first pad row, which the layout keeps inert, so
// skipping it reads what the plain version reads). The pad rows m..m_pad
// of the transposed state are copied as they are.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCols = 32;  // columns (warps) a block
constexpr int kMaxThreads = 32 * kMaxCols;
constexpr size_t kMaxSmem = 232448 - 1024;  // dynamic: the static arrays beside it
constexpr int kUnroll = 8;  // loads in flight a thread, per array
constexpr int kUnroll4 = 4;  // the same, of 4-column words

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// Byte offsets of one column's arrays in shared memory.
struct Layout {
  size_t vn, force, cn, deg, delta, col;
};

__host__ __device__ inline Layout make_layout(int n, int rows) {
  Layout L;
  size_t o = 0;
  L.vn = o;     o = align16(o + (size_t)n);
  L.force = o;  o = align16(o + (size_t)((n + 15) >> 4) * 4);  // 2 bits a VN
  L.cn = o;     o = align16(o + (size_t)rows);
  L.deg = o;    o = align16(o + (size_t)rows * 4);
  L.delta = o;  o = align16(o + (size_t)((rows + 1) >> 1) * 4);  // 16 bits a check
  // an odd number of words apart: the 32 columns of a transposed tile's
  // row fall in 32 distinct banks
  L.col = o + 4;
  return L;
}

// The call's scratch (int32 words, zero between calls): the batch's
// sweeps, the paused columns' count, the grid barrier's counter and
// generation, the completion counter; then the paused list, B column
// indices and B sweep counts.
enum { kS, kPaused, kBarCount, kBarGen, kDone, kHeader = 8 };

struct Args {
  const int8_t* vn_in;      // [B, n] or [n, B]
  const int8_t* cn_in;      // [B, rows] or [rows, B]
  const int32_t* deg_in;
  const uint8_t* dead_in;   // [B]
  int8_t* vn;               // outputs, same layouts
  int8_t* cn;
  int32_t* deg;
  uint8_t* dead;
  const uint8_t* mask;      // mode 1: the VN layout; nonzero decides
  const uint8_t* values;    // mode 1: the VN layout, or null (all 0)
  const long long* index;   // mode 2: [B]
  const uint8_t* value;     // mode 2: [B]
  const uint8_t* do_set;    // mode 2: [B]
  const int32_t* cn_vn;     // [m, dc], pad >= n
  const int32_t* vn_cn;     // [n, dv], pad >= m
  int* scratch;             // kHeader + 2 B words
  unsigned long long* stats;  // [2] += S, += column-sweeps run
  int n, m, rows, dc, dv, cap, mode, log_cols;
  long long B;
  bool transposed;
  bool vec4;  // transposed, 4+ columns a block, B % 4 == 0, 16-byte aligned bases
};

// Element (r, c) of a [rows, B] (transposed) or [B, rows] array.
__device__ inline long long at(const Args& a, int r, long long c, int rows) {
  return a.transposed ? (long long)r * a.B + c : c * rows + r;
}

// Decide undecided VN v of one column to val: its checks' deltas.
__device__ inline void decide(const Args& a, int8_t* vn, unsigned* delta, int v, int val) {
  vn[v] = (int8_t)val;
  const int32_t* row = a.vn_cn + (long long)v * a.dv;
  for (int t = 0; t < a.dv; ++t) {
    const int r = __ldg(row + t);
    if (r < a.m) atomicAdd(delta + (r >> 1), (1u + ((unsigned)val << 8)) << ((r & 1) * 16));
  }
}

// Phase C: apply (and clear) each check's delta. Returns whether a check
// reached degree 0 with parity 1 in this lane.
__device__ inline bool apply_deltas(const Args& a, int8_t* cn, int32_t* deg, unsigned* delta,
                                    int lane) {
  bool kill = false;
  const int words = (a.m + 1) >> 1;
  for (int w = lane; w < words; w += 32) {
    const unsigned d2 = delta[w];
    if (!d2) continue;
    delta[w] = 0;
    for (int h = 0; h < 2; ++h) {
      const unsigned d = (d2 >> (16 * h)) & 0xFFFFu;
      if (!d) continue;
      const int r = 2 * w + h;
      const int cnt = d & 0xFF;
      const int flip = (d >> 8) & 1;
      const int c = cn[r];
      const bool active = c != -1;
      const int nd = deg[r] - cnt;
      const int np = active ? (c ^ flip) : c;
      const bool hit = active && nd == 0 && cnt > 0;
      if (hit && np == 1) kill = true;
      cn[r] = (int8_t)((hit && np == 0) ? -1 : np);
      deg[r] = nd;
    }
  }
  return kill;
}

// VN r of one column arrives with state x: stored, or, where the mask m
// is set, decided to v (0/1) if undecided, a conflict if decided to 1 - v.
__device__ inline void put_vn(const Args& a, int8_t* svn, unsigned* dl, int r, int x, int m,
                              int v, int* kill) {
  if (m) {
    if (x == -1) {
      decide(a, svn, dl, r, v);
      return;
    }
    if (x != v) *kill = 1;
  }
  svn[r] = (int8_t)x;
}

// Load rows r0, r0 + step, ... of column c's VN states into shared
// `svn`; a mode-1 decision applies as they arrive (a newly decided VN's
// deltas into `dl`, a conflict into `*kill`). kUnroll rows' loads are
// issued before any is used, so that many are in flight a thread.
__device__ inline void load_vn(const Args& a, long long c, int r0, int step, int8_t* svn,
                               unsigned* dl, int* kill) {
  const bool decide_now = a.mode == 1;
  for (int rb = r0; rb < a.n; rb += step * kUnroll) {
    int x[kUnroll], msk[kUnroll], val[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = rb + u * step;
      x[u] = -1;
      msk[u] = val[u] = 0;
      if (r < a.n) {
        const long long g = at(a, r, c, a.n);
        x[u] = a.vn_in[g];
        if (decide_now) {
          msk[u] = a.mask[g];
          if (a.values) val[u] = a.values[g] != 0;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = rb + u * step;
      if (r >= a.n) break;
      put_vn(a, svn, dl, r, x[u], msk[u], val[u], kill);
    }
  }
}

// Load rows r0, r0 + step, ... of column c's check states and degrees, as
// load_vn.
__device__ inline void load_cn(const Args& a, long long c, int r0, int step, int8_t* scn,
                               int32_t* sdeg) {
  for (int rb = r0; rb < a.rows; rb += step * kUnroll) {
    int cs[kUnroll], ds[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = rb + u * step;
      cs[u] = ds[u] = 0;
      if (r < a.rows) {
        const long long g = at(a, r, c, a.rows);
        cs[u] = a.cn_in[g];
        ds[u] = a.deg_in[g];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = rb + u * step;
      if (r >= a.rows) break;
      scn[r] = (int8_t)cs[u];
      sdeg[r] = ds[u];
    }
  }
}

// The transposed tile with 4 columns a thread (B a multiple of 4, so that
// every row's 4 bytes, and 16 of the degrees, are one aligned load): a
// row of the 32-column tile is 8 threads' loads of each array, and
// kUnroll4 rows' loads are in flight a thread. Byte i of a word is column
// 4 q + i.
__device__ inline void load_tile4(const Args& a, long long c0, int cols, unsigned char* smem,
                                  const Layout& L, int* kill) {
  const int quads = cols >> 2;
  const int q = threadIdx.x & (quads - 1);
  const int r0 = threadIdx.x / quads, step = blockDim.x / quads;
  const long long c = c0 + 4 * q;
  if (c >= a.B) return;
  unsigned char* col0 = smem + (size_t)(4 * q) * L.col;
  const bool decide_now = a.mode == 1;
  for (int rb = r0; rb < a.n; rb += step * kUnroll4) {
    unsigned x[kUnroll4], msk[kUnroll4], val[kUnroll4];
#pragma unroll
    for (int u = 0; u < kUnroll4; ++u) {
      const int r = rb + u * step;
      x[u] = 0xFFFFFFFFu;
      msk[u] = val[u] = 0;
      if (r < a.n) {
        const long long g = (long long)r * a.B + c;
        x[u] = *(const unsigned*)(a.vn_in + g);
        if (decide_now) {
          msk[u] = *(const unsigned*)(a.mask + g);
          if (a.values) val[u] = *(const unsigned*)(a.values + g);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll4; ++u) {
      const int r = rb + u * step;
      if (r >= a.n) break;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        unsigned char* col = col0 + i * L.col;
        put_vn(a, (int8_t*)(col + L.vn), (unsigned*)(col + L.delta), r,
               (int8_t)(x[u] >> (8 * i)), (msk[u] >> (8 * i)) & 0xFF,
               ((val[u] >> (8 * i)) & 0xFF) != 0, &kill[4 * q + i]);
      }
    }
  }
  for (int rb = r0; rb < a.rows; rb += step * kUnroll4) {
    unsigned cs[kUnroll4];
    int4 ds[kUnroll4];
#pragma unroll
    for (int u = 0; u < kUnroll4; ++u) {
      const int r = rb + u * step;
      cs[u] = 0;
      ds[u] = make_int4(0, 0, 0, 0);
      if (r < a.rows) {
        const long long g = (long long)r * a.B + c;
        cs[u] = *(const unsigned*)(a.cn_in + g);
        ds[u] = *(const int4*)(a.deg_in + g);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll4; ++u) {
      const int r = rb + u * step;
      if (r >= a.rows) break;
      const int d[4] = {ds[u].x, ds[u].y, ds[u].z, ds[u].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        unsigned char* col = col0 + i * L.col;
        ((int8_t*)(col + L.cn))[r] = (int8_t)(cs[u] >> (8 * i));
        ((int32_t*)(col + L.deg))[r] = d[i];
      }
    }
  }
}

// Store the transposed tile, 4 columns a thread, as load_tile4 loads it.
__device__ inline void store_tile4(const Args& a, long long c0, int cols,
                                   const unsigned char* smem, const Layout& L) {
  const int quads = cols >> 2;
  const int q = threadIdx.x & (quads - 1);
  const int r0 = threadIdx.x / quads, step = blockDim.x / quads;
  const long long c = c0 + 4 * q;
  if (c >= a.B) return;
  const unsigned char* col0 = smem + (size_t)(4 * q) * L.col;
  for (int r = r0; r < a.n; r += step) {
    unsigned x = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x |= (unsigned)(uint8_t)((const int8_t*)(col0 + i * L.col + L.vn))[r] << (8 * i);
    *(unsigned*)(a.vn + (long long)r * a.B + c) = x;
  }
  for (int r = r0; r < a.rows; r += step) {
    unsigned x = 0;
    int d[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned char* col = col0 + i * L.col;
      x |= (unsigned)(uint8_t)((const int8_t*)(col + L.cn))[r] << (8 * i);
      d[i] = ((const int32_t*)(col + L.deg))[r];
    }
    const long long g = (long long)r * a.B + c;
    *(unsigned*)(a.cn + g) = x;
    *(int4*)(a.deg + g) = make_int4(d[0], d[1], d[2], d[3]);
  }
}

// One sweep of one column by its warp. Returns (through the flags) whether
// it forced a VN and whether it killed the column.
__device__ inline void sweep(const Args& a, int8_t* vn, unsigned* force, int8_t* cn,
                             int32_t* deg, unsigned* delta, int lane, bool* forced_any,
                             bool* killed) {
  bool forced = false, kill = false;
  // A: degree-1 active checks mark their undecided neighbours
  for (int r = lane; r < a.m; r += 32) {
    const int c = cn[r];
    if (c == -1 || deg[r] != 1) continue;
    const unsigned code = c == 1 ? 2u : 1u;
    const int32_t* row = a.cn_vn + (long long)r * a.dc;
#pragma unroll 8  // the table reads of 8 slots in flight at once
    for (int s = 0; s < a.dc; ++s) {
      const int v = __ldg(row + s);
      if (v >= a.n || vn[v] != -1) continue;
      atomicOr(force + (v >> 4), code << ((v & 15) * 2));
    }
  }
  __syncwarp();
  // B: decide the VNs forced one way; both ways kills the column
  const int words = (a.n + 15) >> 4;
  for (int w = lane; w < words; w += 32) {
    unsigned word = force[w];
    if (!word) continue;
    force[w] = 0;
    while (word) {
      const int f_at = (__ffs(word) - 1) >> 1;  // the lowest nonzero 2-bit field
      const unsigned f = (word >> (2 * f_at)) & 3u;
      word &= ~(3u << (2 * f_at));
      if (f == 3u) {
        kill = true;
        continue;
      }
      decide(a, vn, delta, w * 16 + f_at, f == 2u);
      forced = true;
    }
  }
  __syncwarp();
  // C: apply each touched check's degree drop and parity flip
  kill |= apply_deltas(a, cn, deg, delta, lane);
  __syncwarp();
  *forced_any = __any_sync(0xffffffffu, forced);
  *killed = __any_sync(0xffffffffu, kill);
}

// Wait until every block of the (co-resident) grid has arrived.
__device__ inline void grid_barrier(int* scratch) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile int* gen = scratch + kBarGen;
    const int g = *gen;
    __threadfence();
    if (atomicAdd(scratch + kBarCount, 1) == (int)gridDim.x - 1) {
      atomicExch(scratch + kBarCount, 0);
      __threadfence();
      atomicAdd(scratch + kBarGen, 1);
    } else {
      while (*gen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kMaxThreads, 1) peel_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int kill[kMaxCols];
  __shared__ unsigned long long block_sweeps;
  __shared__ int block_s;
  const int cols = 1 << a.log_cols;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Layout L = make_layout(a.n, a.rows);
  unsigned char* base = smem + w * L.col;
  int8_t* vn = (int8_t*)(base + L.vn);
  unsigned* force = (unsigned*)(base + L.force);
  int8_t* cn = (int8_t*)(base + L.cn);
  int32_t* deg = (int32_t*)(base + L.deg);
  unsigned* delta = (unsigned*)(base + L.delta);
  int* S = a.scratch + kS;
  int* paused = a.scratch + kPaused;
  int* list_col = a.scratch + kHeader;
  int* list_k = list_col + a.B;

  // the force and delta words start at zero and every sweep leaves them so
  for (int i = threadIdx.x; i < (int)(cols * L.col / 4); i += blockDim.x)
    ((unsigned*)smem)[i] = 0;
  if (threadIdx.x == 0) {
    block_sweeps = 0;
    block_s = 0;
  }

  // phase 1: the tiles
  const bool vec4 = a.vec4;
  const long long tiles = (a.B + cols - 1) >> a.log_cols;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long c0 = tile << a.log_cols;
    if (threadIdx.x < cols) kill[threadIdx.x] = 0;
    __syncthreads();
    // load the tile; a mode-1 decision applies as its VN bytes arrive
    if (vec4) {
      load_tile4(a, c0, cols, smem, L, kill);
    } else if (a.transposed) {  // a thread: one column, every 32nd row
      const int j = threadIdx.x & (cols - 1);
      const long long c = c0 + j;
      if (c < a.B) {
        unsigned char* col = smem + j * L.col;
        const int r0 = threadIdx.x >> a.log_cols, step = blockDim.x >> a.log_cols;
        load_vn(a, c, r0, step, (int8_t*)(col + L.vn), (unsigned*)(col + L.delta), &kill[j]);
        load_cn(a, c, r0, step, (int8_t*)(col + L.cn), (int32_t*)(col + L.deg));
      }
    } else {  // the block walks one column at a time, along its contiguous rows
      for (int j = 0; j < cols && c0 + j < a.B; ++j) {
        unsigned char* col = smem + j * L.col;
        load_vn(a, c0 + j, threadIdx.x, blockDim.x, (int8_t*)(col + L.vn),
                (unsigned*)(col + L.delta), &kill[j]);
        load_cn(a, c0 + j, threadIdx.x, blockDim.x, (int8_t*)(col + L.cn),
                (int32_t*)(col + L.deg));
      }
    }
    __syncthreads();

    const long long colx = c0 + w;
    if (colx < a.B) {
      bool dead = a.dead_in[colx] != 0;
      if (a.mode == 2) {
        if (lane == 0 && a.do_set[colx]) {
          const long long v = a.index[colx];
          if (v >= 0 && v < a.n) {
            const int val = a.value[colx] != 0;
            if (vn[v] != -1) {
              if (vn[v] != val) kill[w] = 1;
            } else {
              decide(a, vn, delta, (int)v, val);
            }
          }
        }
        __syncwarp();
      }
      if (a.mode != 0) {
        const bool contradiction = __any_sync(0xffffffffu, apply_deltas(a, cn, deg, delta, lane));
        dead = dead || kill[w] || contradiction;
        __syncwarp();
      }
      int k = 0;
      bool forced, killed;
      while (true) {
        sweep(a, vn, force, cn, deg, delta, lane, &forced, &killed);
        dead = dead || killed;
        ++k;
        // stop at the fixpoint, at death after a forcing sweep (paused: it
        // may need more of the batch's sweeps), or at the cap
        if (!forced || dead || k >= a.cap) break;
      }
      if (lane == 0) {
        a.dead[colx] = dead;
        atomicMax(&block_s, k);
        if (forced && dead && k < a.cap) {
          const int p = atomicAdd(paused, 1);
          list_col[p] = (int)colx;
          list_k[p] = k;
        }
        atomicAdd(&block_sweeps, (unsigned long long)k);
      }
    }
    __syncthreads();
    // store the tile
    if (vec4) {
      store_tile4(a, c0, cols, smem, L);
    } else if (a.transposed) {
      const int j = threadIdx.x & (cols - 1);
      const int step = blockDim.x >> a.log_cols;
      const long long c = c0 + j;
      if (c < a.B) {
        const unsigned char* col = smem + j * L.col;
        for (int r = threadIdx.x >> a.log_cols; r < a.n; r += step)
          a.vn[(long long)r * a.B + c] = ((const int8_t*)(col + L.vn))[r];
        for (int r = threadIdx.x >> a.log_cols; r < a.rows; r += step) {
          const long long g = (long long)r * a.B + c;
          a.cn[g] = ((const int8_t*)(col + L.cn))[r];
          a.deg[g] = ((const int32_t*)(col + L.deg))[r];
        }
      }
    } else {
      for (int j = 0; j < cols && c0 + j < a.B; ++j) {
        const unsigned char* col = smem + j * L.col;
        const long long cb = (c0 + j) * a.n, rb = (c0 + j) * a.rows;
        for (int r = threadIdx.x; r < a.n; r += blockDim.x)
          a.vn[cb + r] = ((const int8_t*)(col + L.vn))[r];
        for (int r = threadIdx.x; r < a.rows; r += blockDim.x) {
          a.cn[rb + r] = ((const int8_t*)(col + L.cn))[r];
          a.deg[rb + r] = ((const int32_t*)(col + L.deg))[r];
        }
      }
    }
    __syncthreads();
  }

  // the batch's sweep count is known once every column has run phase 1
  if (threadIdx.x == 0) atomicMax(S, block_s);
  grid_barrier(a.scratch);
  const int s_all = __ldcg(S);
  const int n_paused = __ldcg(paused);
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(a.stats, (unsigned long long)s_all);

  // phase 2: the paused columns, one a warp, out of the output arrays
  for (int p = blockIdx.x * cols + w; p < n_paused; p += gridDim.x * cols) {
    const long long c = __ldcg(list_col + p);
    int k = __ldcg(list_k + p);
    if (k >= s_all) continue;
    for (int r = lane; r < a.n; r += 32) vn[r] = __ldcg(a.vn + at(a, r, c, a.n));
    for (int r = lane; r < a.rows; r += 32) {
      cn[r] = __ldcg(a.cn + at(a, r, c, a.rows));
      deg[r] = __ldcg(a.deg + at(a, r, c, a.rows));
    }
    __syncwarp();
    const int k0 = k;
    while (k < s_all) {
      bool forced, killed;
      sweep(a, vn, force, cn, deg, delta, lane, &forced, &killed);
      ++k;
      if (!forced) break;
    }
    for (int r = lane; r < a.n; r += 32) a.vn[at(a, r, c, a.n)] = vn[r];
    for (int r = lane; r < a.m; r += 32) {
      a.cn[at(a, r, c, a.rows)] = cn[r];
      a.deg[at(a, r, c, a.rows)] = deg[r];
    }
    if (lane == 0) atomicAdd(&block_sweeps, (unsigned long long)(k - k0));
    __syncwarp();
  }

  // the last block out leaves the scratch zeroed for the next call
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(a.stats + 1, block_sweeps);
    __threadfence();
    if (atomicAdd(a.scratch + kDone, 1) == (int)gridDim.x - 1) {
      atomicExch(S, 0);
      atomicExch(paused, 0);
      atomicExch(a.scratch + kDone, 0);
      __threadfence();
    }
  }
}

// The blocks of `smem` bytes the card holds at once, per device and size
// (the attribute set and the occupancy asked once each).
int grid_capacity(size_t smem, int threads, int* out) {
  struct Entry {
    int dev, threads;
    size_t smem;
    int blocks;
  };
  static Entry cache[64];
  static int used = 0;
  static bool attr_set[64] = {};
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < used; ++i)
    if (cache[i].dev == dev && cache[i].threads == threads && cache[i].smem == smem) {
      *out = cache[i].blocks;
      return 0;
    }
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(peel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = true;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, peel_kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *out = per_sm * sms;
  if (used < 64) cache[used++] = {dev, threads, smem, *out};
  return 0;
}

}  // namespace

extern "C" {

// Decide and peel B columns: inputs and outputs (int8 vn [n] and cn
// [rows], int32 degrees [rows], uint8 dead, a column each; `transposed`
// the [rows, B] layouts, else [B, rows]; all contiguous); the decision
// (`mode` 0: none; 1: uint8 `mask` and `values` (null: 0) in the VN
// layout; 2: int64 `index`, uint8 `value` and `do_set` [B]); the int32
// tables; the cap on the batch's sweeps (at least 1); 2^`log_cols` columns
// a block; `scratch`, kHeader + 2 B int32 words that are zero between
// calls (the kernel leaves them so); and `stats` [2] uint64 that the call
// adds its sweeps and column-sweeps to. One cooperative launch on
// `stream`.
int peel_run(const void* vn_in, const void* cn_in, const void* deg_in, const void* dead_in,
             void* vn_out, void* cn_out, void* deg_out, void* dead_out, int mode,
             const void* mask, const void* values, const void* index, const void* value,
             const void* do_set, const void* cn_vn, const void* vn_cn, int n, int m, int rows,
             int dc, int dv, long long B, int transposed, int cap, int log_cols, void* scratch,
             void* stats, void* stream) {
  if (B == 0) return 0;
  const Layout L = make_layout(n, rows);
  const int cols = 1 << log_cols;
  const size_t smem = L.col * (size_t)cols;
  if (cap < 1 || log_cols < 0 || cols > kMaxCols || smem > kMaxSmem || m > rows || n < 1 ||
      dv < 1 || dc < 1 || dc > 255 || B >= (1LL << 31) || mode < 0 || mode > 2 ||
      (mode == 1 && !mask) || (mode == 2 && (!index || !value || !do_set)))
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
  a.mask = (const uint8_t*)mask;
  a.values = (const uint8_t*)values;
  a.index = (const long long*)index;
  a.value = (const uint8_t*)value;
  a.do_set = (const uint8_t*)do_set;
  a.cn_vn = (const int32_t*)cn_vn;
  a.vn_cn = (const int32_t*)vn_cn;
  a.scratch = (int*)scratch;
  a.stats = (unsigned long long*)stats;
  a.n = n;
  a.m = m;
  a.rows = rows;
  a.dc = dc;
  a.dv = dv;
  a.cap = cap;
  a.mode = mode;
  a.log_cols = log_cols;
  a.B = B;
  a.transposed = transposed != 0;
  const uintptr_t bases = (uintptr_t)vn_in | (uintptr_t)cn_in | (uintptr_t)deg_in |
                          (uintptr_t)vn_out | (uintptr_t)cn_out | (uintptr_t)deg_out |
                          (uintptr_t)mask | (uintptr_t)values;
  a.vec4 = a.transposed && cols >= 4 && (B & 3) == 0 && (bases & 15) == 0;
  const int threads = 32 * cols;
  int capacity = 0;
  int err = grid_capacity(smem, threads, &capacity);
  if (err) return err;
  const long long tiles = (B + cols - 1) / cols;
  const unsigned grid = (unsigned)(tiles < capacity ? tiles : capacity);
  void* params[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)peel_kernel, dim3(grid),
                                              dim3(threads), params, smem,
                                              (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// One column's dynamic shared memory, as the launch lays it out.
long long peel_smem_per_column(int n, int rows) { return (long long)make_layout(n, rows).col; }

const char* swd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
