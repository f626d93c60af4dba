// RG-LRU linear recurrence on Hopper (sm_90a), plain FP32 CUDA cores.
//
// Replaces the Pallas TPU kernel `rglru_scan_kernel` (body `_kernel`) of
// src/repro/kernels/rglru_scan/kernel.py (B9).  For every batch b and lane w
// of the width, over t = 0 .. S-1 from h = 0:
//
//     sp    = logaddexp(0, -lam[w])                 (softplus(-lam))
//     log_a = -8 · r_t · sp,   a_t = exp(log_a)
//     b_t   = sqrt(max(-expm1(2 · log_a), 1e-12)) · (i_t · x_t)
//     h     = a_t · h + b_t,   y_t = h
//
// in the reference's operation order, all float32.  x, r, i and y are
// [B, S, W] contiguous; lam [W]; h_last [B, W].
//
// Design.  The recurrence is elementwise over (b, w) and sequential over t.
// The Pallas grid carries h in VMEM across a sequential time axis; here one
// thread owns one (b, w) lane and loops over all of S itself, with h in a
// register.  Neighbouring threads own neighbouring w, so every load and store
// of a step is coalesced.  A thread loads 16 steps of x, r and i before it
// computes them, so that 48 loads are in flight per thread instead of 3.
//
// What bounds it.  Bytes: three float32 reads and one write per element,
// ~20 FLOPs and three transcendentals.  At the hybrid's shape (B = 2,
// W = 4,096, S = 4,096) that is 537 MB, 0.16 ms at the card's memory rate.
// But only B · W = 8,192 threads run, each through a 4,096-step dependent
// loop: 128 blocks of two warps, about one per SM, too few loads in flight to
// reach the memory rate, and the dependent chain of each step is exposed.  A
// chunked parallel scan (per-chunk (Π a, h) pairs combined across chunks) is
// the first thing to try in a later PR.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kAhead = 16;  // steps loaded before they are computed

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ x, const float* __restrict__ r,
                  const float* __restrict__ gi, const float* __restrict__ lam,
                  float* __restrict__ y, float* __restrict__ h_last, long long S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const float neg = -lam[w];
  const float sp = fmaxf(neg, 0.f) + log1pf(expf(-fabsf(neg)));
  const long long base = static_cast<long long>(b) * S * W + w;
  float h = 0.f;
  for (long long t0 = 0; t0 < S; t0 += kAhead) {
    const int n = static_cast<int>(min(static_cast<long long>(kAhead), S - t0));
    float xs[kAhead], rs[kAhead], is[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (u < n) {
        const long long idx = base + (t0 + u) * W;
        xs[u] = x[idx];
        rs[u] = r[idx];
        is[u] = gi[idx];
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (u < n) {
        const float log_a = -8.f * rs[u] * sp;
        const float a = expf(log_a);
        const float bt = sqrtf(fmaxf(-expm1f(2.f * log_a), 1e-12f)) * (is[u] * xs[u]);
        h = a * h + bt;
        y[base + (t0 + u) * W] = h;
      }
    }
  }
  h_last[static_cast<long long>(b) * W + w] = h;
}

}  // namespace

// B9.  x, r, i, y [B, S, W] and lam [W], h_last [B, W], float32 contiguous.
// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int rglru_scan_f32(const float* x, const float* r, const float* i,
                              const float* lam, float* y, float* h_last, int B,
                              long long S, int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, r, i, lam, y, h_last, S, W);
  return cudaGetLastError();
}
