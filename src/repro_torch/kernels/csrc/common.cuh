// Shared helpers of the port's CUDA kernels: dtype codes agreed with the
// Python wrappers, and float <-> storage conversions by intrinsics.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

// dtype codes passed from Python (kernels/sfc_matmul.py, paged_attention.py)
enum DtypeCode : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// Element ``idx`` of a tensor whose dtype is only known at run time.
__device__ __forceinline__ float load_as_f32(const void* p, long idx, int dt) {
  return dt == kF32 ? static_cast<const float*>(p)[idx]
                    : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[idx]);
}

__device__ __forceinline__ void store_from_f32(void* p, long idx, int dt, float v) {
  if (dt == kF32) {
    static_cast<float*>(p)[idx] = v;
  } else {
    static_cast<__nv_bfloat16*>(p)[idx] = __float2bfloat16(v);
  }
}

}  // namespace repro_torch
