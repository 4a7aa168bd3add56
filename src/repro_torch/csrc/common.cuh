// Shared helpers of the repro_torch CUDA kernels: value-type conversions,
// the type codes the Python wrappers pass across the C interface, and the
// card's size, which sets the CTAs of the row-per-thread kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace repro {

// Value type codes (kernels/_build.py: VALUE_CODES).
enum ValueCode : int { kF32 = 0, kBF16 = 1, kF16 = 2 };
// Index type codes of a plan's tile-local columns (INDEX_CODES).
enum IndexCode : int { kI8 = 0, kI16 = 1, kI32 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half(v);      // round to nearest even, as torch's .to(float16)
}

// One product added to an f32 sum, with the multiply and the add rounded
// separately (no fused multiply-add): the plain PyTorch versions run a
// multiply kernel and then an add kernel, so this keeps f32 results equal.
__device__ __forceinline__ float mul_add_rn(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

// The card's SMs and L2 bytes, read once.
struct Card {
  int sms = 132;
  int64_t l2 = 50 << 20;
  Card() {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess && n > 0)
      sms = n;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrL2CacheSize, dev) == cudaSuccess && n > 0) l2 = n;
  }
};
inline const Card& card() {
  static const Card c;
  return c;
}

// Threads per CTA of a kernel with one row a thread: 256 when the grid then
// has at least two CTAs per SM, else halved down to one warp, so that a
// small matrix spreads over the card (HPCG's 13^3 level, 2,197 rows: 69
// CTAs of one warp instead of 9 of 256).
inline int spread_threads(int64_t nrows) {
  int threads = 256;
  while (threads > 32 && (nrows + threads - 1) / threads < 2 * card().sms) threads /= 2;
  return threads;
}

}  // namespace repro
