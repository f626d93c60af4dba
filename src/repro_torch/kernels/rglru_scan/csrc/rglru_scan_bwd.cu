// Backward of the RG-LRU linear recurrence on Hopper (sm_90a): one thread a
// (batch, lane) walking time backwards.
//
// Replaces no Pallas kernel: the reference trains the hybrid family through
// `lax.associative_scan` (src/repro/models/rglru.py, `rg_lru`), which XLA
// differentiates, and its Pallas kernel `rglru_scan_kernel` (B9) has no
// backward.  This is the backward of B9 (csrc/rglru_scan.cu), the function
// of `ref.rglru_scan_bwd_plain`.  For every batch b and lane w, with the
// forward's expressions (sp = softplus(-lam), log_a = -8 r sp, a =
// exp(log_a), u = -expm1(2 log_a), m = sqrt(max(u, 1e-12))) and g the
// gradient of h, over t = S-1 .. 0 from g = dy_{S-1} + dh_last:
//
//     g_t    = dy_t + a_{t+1} g_{t+1}
//     dx_t   = g m i,   di_t = g m x
//     dlog_a = a g h_{t-1} - [u > 1e-12] a²/m (g i x)     (h_{-1} = 0)
//     dr_t   = dlog_a (-8 sp)
//     dlam   = Σ_{b,t} dlog_a (-8 r) (-sigmoid(-lam))
//
// float32 arithmetic.  h_{t-1} is the forward's saved output y_{t-1} (y is
// h).  x, r, i are read in their own dtypes (x float32 or bf16, the gates
// both float32 or both bf16, as B9 reads them) and dx, dr, di written in
// them; y, dy, dh_last, dlam float32.  dlam is summed over b by a second
// launch in a fixed order (no atomics): repeats are bit-identical.
//
// What bounds it.  Bytes: x, r, i, y, dy read once and dx, dr, di written
// once, 32 bytes an element in float32 (537 MB at recurrentgemma-9b's
// microbatch, 2 x 2,048 x 4,096: 0.160 ms at the card's memory rate), 24
// with bf16 x.  The arithmetic, ~80 instructions an element with the
// accurate expf, expm1f and sqrtf, is ~0.1 ms of instruction slots.  The
// chain itself is one dependent FMA a step per lane.  This first version
// gives each lane one thread (8,192 threads at that shape, 128 blocks of 64
// for the 132 SMs) and hides the loads' latency by reading kBatch steps
// ahead into registers; B9's staging through shared memory (PR 21) would
// be the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // lanes a block
constexpr int kBatch = 8;     // steps loaded ahead

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename TX, typename TG>
__global__ void __launch_bounds__(kThreads)
rglru_bwd_kernel(const TX* __restrict__ x, const TG* __restrict__ r, const TG* __restrict__ gi,
                 const float* __restrict__ lam, const float* __restrict__ y,
                 const float* __restrict__ dy, const float* __restrict__ dh_last,
                 TX* __restrict__ dx, TG* __restrict__ dr, TG* __restrict__ di,
                 float* __restrict__ dlam_part, long long S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const float neg = -lam[w];
  const float sp = fmaxf(neg, 0.f) + log1pf(expf(-fabsf(neg)));  // as B9 forms it
  const long long lane = static_cast<long long>(b) * W + w;
  const long long row0 = static_cast<long long>(b) * S;
  float carry = dh_last != nullptr ? dh_last[lane] : 0.f;  // a_{t+1} g_{t+1}
  float acc = 0.f;                                          // Σ_t dlog_a · r
  for (long long t1 = S; t1 > 0; t1 -= kBatch) {
    // steps t1 - 1 down to t1 - kBatch (those >= 0), their inputs loaded first
    float xv[kBatch], rv[kBatch], iv[kBatch], dyv[kBatch], hp[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long t = t1 - 1 - u;
      const long long idx = (row0 + t) * W + w;
      const bool ok = t >= 0;
      xv[u] = ok ? widen(x[idx]) : 0.f;
      rv[u] = ok ? widen(r[idx]) : 0.f;
      iv[u] = ok ? widen(gi[idx]) : 0.f;
      dyv[u] = ok ? dy[idx] : 0.f;
      hp[u] = t > 0 ? y[idx - W] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long t = t1 - 1 - u;
      if (t >= 0) {
        const long long idx = (row0 + t) * W + w;
        const float log_a = -8.f * rv[u] * sp;
        const float a = expf(log_a);
        const float um = -expm1f(2.f * log_a);
        const float m = sqrtf(fmaxf(um, 1e-12f));
        const float g = dyv[u] + carry;
        carry = a * g;
        const float gm = g * m;
        const float dlog_a =
            a * g * hp[u] - (um > 1e-12f ? a * a / m : 0.f) * (g * iv[u] * xv[u]);
        dx[idx] = narrow<TX>(gm * iv[u]);
        di[idx] = narrow<TG>(gm * xv[u]);
        dr[idx] = narrow<TG>(dlog_a * (-8.f * sp));
        acc += dlog_a * rv[u];
      }
    }
  }
  dlam_part[lane] = acc;
}

// dlam[w] = Σ_b part[b, w] · 8 · sigmoid(-lam[w]), b in order.
__global__ void dlam_kernel(const float* __restrict__ part, const float* __restrict__ lam,
                            float* __restrict__ dlam, int B, int W) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += part[static_cast<long long>(b) * W + w];
  dlam[w] = s * (8.f / (1.f + expf(lam[w])));
}

template <typename TX, typename TG>
int launch(const void* x, const void* r, const void* i, const float* lam, const float* y,
           const float* dy, const float* dh_last, void* dx, void* dr, void* di,
           float* dlam_part, float* dlam, int B, long long S, int W, cudaStream_t st) {
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_bwd_kernel<TX, TG><<<grid, kThreads, 0, st>>>(
      static_cast<const TX*>(x), static_cast<const TG*>(r), static_cast<const TG*>(i), lam, y,
      dy, dh_last, static_cast<TX*>(dx), static_cast<TG*>(dr), static_cast<TG*>(di), dlam_part,
      S, W);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dlam_kernel<<<(W + 255) / 256, 256, 0, st>>>(dlam_part, lam, dlam, B, W);
  return cudaGetLastError();
}

}  // namespace

// The backward of B9.  x, r, i [B, S, W] contiguous: x float32 (x_bf16 = 0)
// or bf16 (1), r and i both float32 (gates_bf16 = 0) or both bf16 (1); lam
// [W], y and dy [B, S, W], dh_last [B, W] (or null: zero) float32.  dx, dr,
// di [B, S, W] in x's and the gates' dtypes; dlam [W] float32; dlam_part
// [B, W] float32 scratch.  Launches two kernels on `stream`; returns the
// first error (0 = launched).
extern "C" int rglru_scan_bwd(const void* x, const void* r, const void* i, const float* lam,
                              const float* y, const float* dy, const float* dh_last, void* dx,
                              void* dr, void* di, float* dlam_part, float* dlam, int B,
                              long long S, int W, int x_bf16, int gates_bf16, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_bf16)
    return gates_bf16
        ? launch<bf16, bf16>(x, r, i, lam, y, dy, dh_last, dx, dr, di, dlam_part, dlam, B, S, W, st)
        : launch<bf16, float>(x, r, i, lam, y, dy, dh_last, dx, dr, di, dlam_part, dlam, B, S, W,
                              st);
  return gates_bf16
      ? launch<float, bf16>(x, r, i, lam, y, dy, dh_last, dx, dr, di, dlam_part, dlam, B, S, W, st)
      : launch<float, float>(x, r, i, lam, y, dy, dh_last, dx, dr, di, dlam_part, dlam, B, S, W,
                             st);
}
