// Shared helpers of the hand-written kernels: element load/store between
// the storage type (float or bf16) and the float32 compute type, and the
// dtype codes the Python wrappers pass (0 = float32, 1 = bfloat16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace emsanet {

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Round a float32 value to the storage type and back (the rounding the
// unfused path applies when it writes an intermediate in that type).
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace emsanet
