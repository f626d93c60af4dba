// Shared by the flash-attention forward (B7) and backward (B8) kernels,
// float32 and bf16: the mask and the Pallas kernels' -1e30 for masked
// scores.
#pragma once

#include <cuda_runtime.h>

namespace flash {

constexpr float kNegInf = -1e30f;

// Query i attends key j: j inside the sequence, j <= i when causal, and
// j > i - window when a window (> 0) is given.
__device__ __forceinline__ bool attends(int i, int j, int S, int causal, int window) {
  return j < S && (!causal || j <= i) && (window <= 0 || j > i - window);
}

}  // namespace flash
