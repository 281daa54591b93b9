// Shared helpers of the port's CUDA kernels: dtype codes agreed with the
// Python wrappers, float <-> storage conversions by intrinsics, the
// mbarrier operations of the kernels that copy by TMA, and the host's
// encoder of TMA tensor maps.
#pragma once

#include <cuda.h>  // CUtensorMap; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// a wait longer than this is a broken protocol: trap instead of hanging
constexpr long long kWatchdogCycles = 20000000000ll;  // ~10 s at 1.98 GHz

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// arrive with release semantics: this thread's earlier shared-memory
// accesses happen before the phase completes
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrive, and hold the phase open until ``bytes`` more have landed by
// complete_tx
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// wait (acquire) until the phase of parity ``parity`` of ``bar`` completed;
// a copy that never lands traps after ~10 s instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  for (unsigned n = 1;; ++n) {
    if (mbar_try(bar, parity)) return;
    if ((n & 1023u) == 0 && clock64() - t0 > kWatchdogCycles) __trap();
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link
// against libcuda); null where libcuda has no such entry
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

}  // namespace repro_torch
