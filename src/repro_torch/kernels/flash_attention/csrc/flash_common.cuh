// Shared by the flash-attention forward (B7, flash_attention.cu) and
// backward (B8, flash_attention_bwd.cu): the mask, the Pallas kernels'
// -1e30 for masked scores, and the float32 <-> input-type conversions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Query i attends key j: j inside the sequence, j <= i when causal, and
// j > i - window when a window (> 0) is given.
__device__ __forceinline__ bool attends(int i, int j, int S, int causal, int window) {
  return j < S && (!causal || j <= i) && (window <= 0 || j > i - window);
}

}  // namespace flash
