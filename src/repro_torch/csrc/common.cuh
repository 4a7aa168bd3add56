// Shared helpers of the repro_torch CUDA kernels: value-type conversions and
// the type codes the Python wrappers pass across the C interface.
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

}  // namespace repro
