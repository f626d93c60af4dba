// Shared by the SSD chunk scan's forward (ssd_chunk.cu, B10) and backward
// (ssd_chunk_bwd.cu): the shape, the model layout's offsets and the
// within-chunk cumulative sum of la.
#pragma once

#include <cuda_runtime.h>

namespace ssd {

struct Shape {
  int B, S, H, G, P, N, Q, nc;
};

// Offset of row (b, s, g) of bm or cm [B, S, G, N].
__device__ __forceinline__ long long row_bsg(const Shape& sh, int b, long long s, int g) {
  return ((static_cast<long long>(b) * sh.S + s) * sh.G + g) * sh.N;
}

// Offset of row (b, s, h) of xdt or dy [B, S, H, P].
__device__ __forceinline__ long long row_bsh(const Shape& sh, int b, long long s, int h) {
  return ((static_cast<long long>(b) * sh.S + s) * sh.H + h) * sh.P;
}

// Offset of (b, s, h) in la [B, S, H].
__device__ __forceinline__ long long at_bsh(const Shape& sh, int b, long long s, int h) {
  return (static_cast<long long>(b) * sh.S + s) * sh.H + h;
}

// la of steps [c·Q, c·Q + Q) of (b, h) into cum[0, Q), then the inclusive
// prefix sum in place, in double: warp 0, 8 consecutive steps per lane
// (Q <= 256).  At mamba2's decays (a·dt up to ~11 a step) cum reaches -10³
// within a chunk, where the difference of two float32 sums keeps only ~1e-4
// of exp(cum_i - cum_j); the differences are taken in double, then rounded.
__device__ inline void chunk_cumsum(double* cum, const float* __restrict__ la, const Shape& sh,
                                    int b, int h, int c) {
  for (int t = threadIdx.x; t < sh.Q; t += blockDim.x)
    cum[t] = la[at_bsh(sh, b, static_cast<long long>(c) * sh.Q + t, h)];
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    double v[8];
    double run = 0.0;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int t = lane * 8 + u;
      run += t < sh.Q ? cum[t] : 0.0;
      v[u] = run;
    }
    double incl = run;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const double up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    const double excl = incl - run;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int t = lane * 8 + u;
      if (t < sh.Q) cum[t] = v[u] + excl;
    }
  }
  __syncthreads();
}

}  // namespace ssd
