// Batched reliability-ordered GF(2) Gauss-Jordan for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel `ops/gf2_pallas.py:_gj_kernel`
// (through `ordered_gauss_jordan_pallas`) and, on the main path, the XLA
// elimination `ops/gf2_solve.py:ordered_gauss_jordan_key` that computes the
// same elimination keyed by floats. Plain version:
// `ops/gf2_solve.py:ordered_gauss_jordan_key` in this package.
//
// One thread block per shot. The packed state [m, W+1] (PCM rows with the
// syndrome word appended) and the shot's [n] float keys stay in shared
// memory for all `rank` pivot steps; device memory is touched once to load
// and once to store. Each step:
//   1. OR of the unused rows -> the live-column words (threads split the
//      (word, row group) pairs, combined with shared-memory atomicOr);
//   2. block argmin over live columns of (key, column), ties to the lower
//      column (warp shuffles, then one warp over the warp results);
//   3. each row's bit of the pivot column into a flag array, and the block
//      min over the unused rows that hold it -> the pivot row;
//   4. XOR of the pivot row into every other row that holds the bit.
//
// Bound: integer operations on shared memory. Per shot and step the dense
// work is about (m - r) * W words ORed, n keys scanned, m bits tested and
// (rows holding the bit) * (W + 1) words XORed; at the flagship window
// (m 216, n 1728, W 54, rank 216) and B = 256 that is of order 1e9 32-bit
// operations, about 0.02 ms at 67 T/s, against ~14 MB of device-memory
// traffic (~4 us). Block-wide barriers between the four phases (five per
// step, 216 steps) and the per-block serial step chain keep the kernel far
// from that bound; more shots per block, or warp-level steps, are later work.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
gauss_jordan_key_kernel(const uint32_t* __restrict__ H,
                        const uint8_t* __restrict__ synd,
                        const float* __restrict__ keys,
                        uint32_t* __restrict__ state_out,
                        int32_t* __restrict__ pcol, int32_t* __restrict__ prow,
                        uint8_t* __restrict__ incons, int m, int n, int W,
                        int rank) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Wp1 = W + 1;
  uint32_t* st = reinterpret_cast<uint32_t*>(smem_raw);  // [m, W+1]
  float* key = reinterpret_cast<float*>(st + m * Wp1);   // [n]
  uint32_t* live = reinterpret_cast<uint32_t*>(key + n); // [W]
  uint8_t* unused = reinterpret_cast<uint8_t*>(live + W); // [m]
  uint8_t* colflag = unused + m;                          // [m]

  __shared__ float red_k[kWarps];
  __shared__ int red_j[kWarps];
  __shared__ int s_j;
  __shared__ int s_i;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int e = tid; e < m * Wp1; e += kThreads) {
    const int i = e / Wp1, w = e - i * Wp1;
    st[e] = (w < W) ? H[i * W + w] : (uint32_t)(synd[(long long)b * m + i] & 1);
  }
  for (int j = tid; j < n; j += kThreads) key[j] = keys[(long long)b * n + j];
  for (int i = tid; i < m; i += kThreads) unused[i] = 1;
  for (int w = tid; w < W; w += kThreads) live[w] = 0;
  __syncthreads();

  // (word, row group) split of the live-column OR; with W > kThreads each
  // thread takes whole words
  const int groups = W <= kThreads ? kThreads / W : 1;

  for (int r = 0; r < rank; ++r) {
    // 1. live-column words
    if (tid < groups * W) {
      const int w = tid % W, g = tid / W;
      uint32_t acc = 0;
      for (int i = g; i < m; i += groups)
        if (unused[i]) acc |= st[i * Wp1 + w];
      if (acc) atomicOr(&live[w], acc);
    }
    for (int w = kThreads + tid; w < W; w += kThreads) {
      uint32_t acc = 0;
      for (int i = 0; i < m; ++i)
        if (unused[i]) acc |= st[i * Wp1 + w];
      live[w] = acc;
    }
    if (tid == 0) s_i = 0x7fffffff;
    __syncthreads();

    // 2. pivot column: argmin of (key, column) over live columns
    float bk = INFINITY;
    int bj = 0x7fffffff;
    for (int j = tid; j < n; j += kThreads) {
      if ((live[j >> 5] >> (j & 31)) & 1u) {
        const float k = key[j];
        if (k < bk) {  // j grows within a thread: ties keep the lower j
          bk = k;
          bj = j;
        }
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ok = __shfl_down_sync(0xffffffffu, bk, off);
      const int oj = __shfl_down_sync(0xffffffffu, bj, off);
      if (ok < bk || (ok == bk && oj < bj)) {
        bk = ok;
        bj = oj;
      }
    }
    if (lane == 0) {
      red_k[warp] = bk;
      red_j[warp] = bj;
    }
    __syncthreads();
    if (warp == 0) {
      bk = lane < kWarps ? red_k[lane] : INFINITY;
      bj = lane < kWarps ? red_j[lane] : 0x7fffffff;
      for (int off = 16; off > 0; off >>= 1) {
        const float ok = __shfl_down_sync(0xffffffffu, bk, off);
        const int oj = __shfl_down_sync(0xffffffffu, bj, off);
        if (ok < bk || (ok == bk && oj < bj)) {
          bk = ok;
          bj = oj;
        }
      }
      if (lane == 0) s_j = bj;
    }
    __syncthreads();

    // 3. pivot-column bit of every row; first unused row holding it
    const int jstar = s_j;
    const int jw = jstar >> 5, js = jstar & 31;
    int cand = 0x7fffffff;
    for (int i = tid; i < m; i += kThreads) {
      const uint8_t bit = (uint8_t)((st[i * Wp1 + jw] >> js) & 1u);
      colflag[i] = bit;
      if (bit && unused[i] && i < cand) cand = i;
    }
    for (int off = 16; off > 0; off >>= 1)
      cand = min(cand, __shfl_down_sync(0xffffffffu, cand, off));
    if (lane == 0 && cand != 0x7fffffff) atomicMin(&s_i, cand);
    __syncthreads();

    // 4. clear the pivot column from every other row holding it
    const int istar = s_i;
    const uint32_t* pr = st + istar * Wp1;
    for (int e = tid; e < m * Wp1; e += kThreads) {
      const int i = e / Wp1;
      if (colflag[i] && i != istar) st[e] ^= pr[e - i * Wp1];
    }
    if (tid == 0) {
      unused[istar] = 0;
      pcol[(long long)b * rank + r] = jstar;
      prow[(long long)b * rank + r] = istar;
    }
    for (int w = tid; w < W; w += kThreads) live[w] = 0;
    __syncthreads();
  }

  // store the reduced state; a syndrome bit left on an unused row means
  // the syndrome is outside the pivot span
  uint32_t* out = state_out + (long long)b * m * Wp1;
  for (int e = tid; e < m * Wp1; e += kThreads) out[e] = st[e];
  int left = 0;
  for (int i = tid; i < m; i += kThreads)
    left |= (int)(unused[i] && (st[i * Wp1 + W] & 1u));
  left = __syncthreads_or(left);
  if (tid == 0) incons[b] = (uint8_t)(left != 0);
}

}  // namespace

extern "C" {

// shared memory per block: the packed state, the keys, the live words and
// two row flags (`smem_bytes` in ops/gf2_cuda.py says the same)
int gauss_jordan_key(const void* H, const void* synd, const void* keys,
                     void* state_out, void* pcol, void* prow, void* incons,
                     int m, int n, int W, int rank, int B, void* stream) {
  if (B == 0) return 0;
  const size_t smem =
      (size_t)m * (W + 1) * 4 + (size_t)n * 4 + (size_t)W * 4 + 2 * (size_t)m;
  cudaError_t err = cudaFuncSetAttribute(
      gauss_jordan_key_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gauss_jordan_key_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)H, (const uint8_t*)synd, (const float*)keys,
      (uint32_t*)state_out, (int32_t*)pcol, (int32_t*)prow, (uint8_t*)incons,
      m, n, W, rank);
  return (int)cudaGetLastError();
}

const char* swd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
