// Min-sum check-node update for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel `ops/bp_pallas.py:_cn_kernel`
// (reached through `cn_update_pallas`) in both of its modes: unmasked
// (`cn_update_f32` / `cn_update_bf16`) and pinned (`cn_update_pinned_f32` /
// `cn_update_pinned_bf16`, the masked BP of the decimation decoders).
// Plain version: `ops/bp.py:_cn_update_sm` in this package.
//
// Layout: messages are slot-major [dc, m_pad, B] with the shot index
// fastest. One thread owns one (check row i, shot b) pair and walks the dc
// slots twice: pass 1 keeps a streaming (min1, min2) and the count of
// non-positive messages, pass 2 emits alpha * sign * (min2 if |x| == min1
// else min1). Neighbouring threads hold neighbouring shots, so every read
// of mv[s, i, b] and every write of mc[s, i, b] is coalesced; the validity
// byte valid[s, i] is the same for a whole warp (a broadcast).
//
// Pinned mode (template flag PINNED): a message at or above `thresh` is a
// pin. It skips the clip, so fminf(|x|, big) presents exactly `big` to the
// min, and since it is positive it adds no sign. A check whose every valid
// edge is pinned emits magnitude `big`, as the plain version does. With
// PINNED false the test is removed at compile time and the unmasked
// kernels compile as before (`thresh` is their last, unused, argument).
//
// Arithmetic runs in f32 and is rounded once at the store. bf16 -> f32 is
// exact and monotone, the product of two bf16 values is exact in f32, so
// the single rounding reproduces a native bf16 multiply: the result is
// bit-identical to the plain version in both dtypes (as the Pallas kernel
// was to the XLA one).
//
// Bound: bytes. The kernel must read mv and parity once and write mc once:
// at the flagship window (dc 35, m_pad 224) and B = 16384 in bf16 that is
// about 0.53 GB, about 0.16 ms at 3.35 TB/s; it does ~10 flops per message.
// Pass 2 re-reads mv; the dc values a thread reads stay in L1/L2 between
// the passes only while the block's working set fits, so the re-read can
// cost device-memory traffic. Keeping the slots in registers, or fusing
// the whole BP iteration per shot, is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The clipped value of one slot: pins (PINNED only) pass unclipped.
template <bool PINNED>
__device__ __forceinline__ float clipped(float x, float clip, float thresh) {
  if (PINNED && x >= thresh) return x;
  return fminf(fmaxf(x, -clip), clip);
}

template <typename T, bool PINNED>
__global__ void cn_update_kernel(const T* __restrict__ mv,
                                 const uint8_t* __restrict__ valid,
                                 const int32_t* __restrict__ parity,
                                 T* __restrict__ mc, int dc, int m_pad,
                                 long long B, float alpha, float clip,
                                 float big, float thresh) {
  const long long plane = (long long)m_pad * B;  // one slot's [m_pad, B]
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= plane) return;
  const int i = (int)(t / B);

  float min1 = big, min2 = big;
  int nneg = 0;
  for (int s = 0; s < dc; ++s) {
    // an invalid slot presents `big`, which changes neither min
    if (!valid[s * m_pad + i]) continue;
    const float c = clipped<PINNED>(to_f(mv[s * plane + t]), clip, thresh);
    const float a = fminf(fabsf(c), big);
    if (a < min1) {
      min2 = min1;
      min1 = a;
    } else {
      min2 = fminf(min2, a);
    }
    nneg += (c <= 0.f);
  }
  const int odd = (parity[t] + nneg) & 1;

  for (int s = 0; s < dc; ++s) {
    if (!valid[s * m_pad + i]) {
      mc[s * plane + t] = from_f<T>(0.f);
      continue;
    }
    const float c = clipped<PINNED>(to_f(mv[s * plane + t]), clip, thresh);
    const float a = fminf(fabsf(c), big);
    const float mag = (a == min1) ? min2 : min1;
    const float sgn = ((odd ^ (int)(c <= 0.f)) != 0) ? -1.f : 1.f;
    mc[s * plane + t] = from_f<T>(alpha * (sgn * mag));
  }
}

template <typename T, bool PINNED>
int launch(const void* mv, const void* valid, const void* parity, void* mc,
           int dc, int m_pad, long long B, float alpha, float clip, float big,
           float thresh, void* stream) {
  const long long plane = (long long)m_pad * B;
  if (plane == 0) return 0;
  const int threads = 256;
  const long long blocks = (plane + threads - 1) / threads;
  cn_update_kernel<T, PINNED>
      <<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
          (const T*)mv, (const uint8_t*)valid, (const int32_t*)parity, (T*)mc,
          dc, m_pad, B, alpha, clip, big, thresh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// alpha, clip, big and thresh arrive already rounded to the storage dtype
// by the caller.
int cn_update_f32(const void* mv, const void* valid, const void* parity,
                  void* mc, int dc, int m_pad, long long B, float alpha,
                  float clip, float big, void* stream) {
  return launch<float, false>(mv, valid, parity, mc, dc, m_pad, B, alpha,
                              clip, big, 0.f, stream);
}

int cn_update_bf16(const void* mv, const void* valid, const void* parity,
                   void* mc, int dc, int m_pad, long long B, float alpha,
                   float clip, float big, void* stream) {
  return launch<__nv_bfloat16, false>(mv, valid, parity, mc, dc, m_pad, B,
                                      alpha, clip, big, 0.f, stream);
}

int cn_update_pinned_f32(const void* mv, const void* valid, const void* parity,
                         void* mc, int dc, int m_pad, long long B, float alpha,
                         float clip, float big, float thresh, void* stream) {
  return launch<float, true>(mv, valid, parity, mc, dc, m_pad, B, alpha, clip,
                             big, thresh, stream);
}

int cn_update_pinned_bf16(const void* mv, const void* valid,
                          const void* parity, void* mc, int dc, int m_pad,
                          long long B, float alpha, float clip, float big,
                          float thresh, void* stream) {
  return launch<__nv_bfloat16, true>(mv, valid, parity, mc, dc, m_pad, B,
                                     alpha, clip, big, thresh, stream);
}

const char* swd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
