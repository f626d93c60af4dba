// B1, B2, B4 and B5 with m <= kSmallM (28) and o <= 32 on Hopper (sm_90a),
// FP32 CUDA cores: a block per (tenant, sample slice) that stages each
// step's xa once for every output.
//
// Replaces, for that shape, the Pallas TPU kernels `rolann_stats_kernel`
// (B1), `rolann_stats_kernel_acc` (B2), `rolann_stats_kernel_batched` (B4,
// body `_kernel_batched`) and `rolann_stats_kernel_acc_batched` (B5) of
// src/repro/kernels/rolann_stats/kernel.py: per tenant t and output o,
//
//     G[t, o] = xa[t] · diag(fsq[t, o]) · xa[t]ᵀ,   M[t, o] = xa[t] · fd[t, o]
//
// with xa [k, m, n], fsq and fd [k, o, n] float32, summed in float32, into
// g [k, o, m, m] and mv [k, o, m]: written by B1 (k = 1) and B4, added into
// the running values by B2 (k = 1) and B5.  `launch()` in rolann_stats.cu
// takes this route for the four entries when m <= 28 and o <= 32: every
// layer of the one-shot creditcard fit (B1) and of the fleet fit (B4),
// (m, o) = (19, 15) .. (28, 24), and the last layer (28, 29) of the
// logistic-output streamed fit (B2) and chunked fleet fit (B5).  Other
// shapes keep `partial_kernel`.
//
// What bounds it.  At the fleet's (28, 24) with 64 tenants of 3,998
// samples the function is 2.5e9 FMAs for G's upper triangle and 0.3e9 for
// M and the fsq scaling, against 64·3,998·(28 + 2·24)·4 = 78 MB read and
// 5 MB written: ~0.08 ms on the FP32 cores, ~0.025 ms for the bytes, so
// operations bound it; one creditcard tenant of 255,883 samples is the same
// work.  `partial_kernel` runs a block per (tenant, output, slice): each of
// a tenant's o blocks stages its own copy of xa's 32 rows (28 real) from
// memory, reads fsq[o] once per staged row, loads 32-byte segments (8
// samples x 4 rows a warp) and folds only 8 samples a lane between two
// barriers; the fleet ran it at 10x its bound, the one-shot fit likewise.
//
// Design.  B3's slice kernel (rolann_fused_slice.cuh) without the stage-1
// product: a block of eight warps owns tenant t's slice of the samples and
// walks it in steps of 64.  Per step it stages, by cp.async, xa's rows
// sample-major (lane r of warp v copies row r's samples 8v .. 8v + 7, so a
// warp's stores are 32 consecutive floats; rows past m and samples past the
// slice are zeros) and all o outputs' fsq and fd, rows of 64 samples; the
// next step's copies are in flight during this step's fold (two buffers,
// no registers held), and one barrier a step separates them.  The fold is
// rolann_slice_fold.cuh's `fold_step` (B3's): a warp folds four outputs at
// most, a lane one 4x4 piece of G's upper triangle and one row of M for
// each, every term (xa[i]·fsq[o])·xa[j] as the reference forms it.  Each
// slice writes its partial packed triangles and M rows.  B4 and B5
// (ops.plan_batched_slices) cut each tenant's samples into a few slices of
// at least four steps, as many as fill the card once (the fleet's
// 1,024-sample chunks of 64 tenants: 4 slices of 256), and
// `few_slice_reduce_kernel` sums the slices in order, writing g and mv from
// zero (B4) or adding onto the running values (B5).  B1 and B2 are the one-tenant grid (1, slices): ops.plan_stats_
// slices cuts the samples into as many slices of whole steps as fill the
// card twice over (hundreds), and `slice_reduce_kernel`, a block per row,
// sums them in a fixed order, from zero for B1 and onto the running values
// for B2.  The workspace does not grow with n; G is exactly symmetric,
// repeats are bit-identical, no atomics, no memset.
#pragma once

#include "rolann_slice_fold.cuh"

namespace rolann {
namespace slice {

// Floats of dynamic shared memory for o outputs: two buffers of a step's xa
// [kStep][kLdX], fsq [o][kStep] and fd [o][kStep].
inline long long stats_smem_floats(int o) { return 2LL * (kStep * kLdX + 2LL * o * kStep); }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Grid (tenant t, slice s).  The partials of (t, s) go to rows
// (s·k + t)·o .. of ws_g [slices, k·o, m (m + 1) / 2] and ws_m [slices,
// k·o, m].
template <int kOuts>
__global__ void __launch_bounds__(kThreads, 2)
stats_slice_kernel(const float* __restrict__ xa, const float* __restrict__ fsq,
                   const float* __restrict__ fd, float* __restrict__ ws_g,
                   float* __restrict__ ws_m, int m, long long n, int o, long long slice_len) {
  extern __shared__ __align__(16) float smem[];
  const int buf_floats = kStep * kLdX + 2 * o * kStep;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t = blockIdx.x;
  xa += t * m * n;
  fsq += t * o * n;
  fd += t * o * n;
  const long long k_begin = (long long)blockIdx.y * slice_len;
  const long long k_end = min(n, k_begin + slice_len);

  // A step's xa, fsq and fd into buffer `buf`: copies in flight, zeros
  // stored (rows past m, samples past the slice).
  auto stage = [&](int buf, long long k0) {
    float* const s_x = smem + buf * buf_floats;
    float* const s_f = s_x + kStep * kLdX;
    float* const s_d = s_f + o * kStep;
    const float* const row = xa + (long long)lane * n;
#pragma unroll
    for (int s = 0; s < kSamplesPerLane; ++s) {
      const int c = warp * kSamplesPerLane + s;
      float* const dst = s_x + c * kLdX + lane;
      if (lane < m && k0 + c < k_end) {
        cp_async4(dst, row + k0 + c);
      } else {
        *dst = 0.f;
      }
    }
    for (int e = tid; e < o * kStep; e += kThreads) {
      const long long k = k0 + e % kStep;
      const long long src = (long long)(e / kStep) * n + k;
      if (k < k_end) {
        cp_async4(s_f + e, fsq + src);
        cp_async4(s_d + e, fd + src);
      } else {
        s_f[e] = 0.f;
        s_d[e] = 0.f;
      }
    }
    cp_async_commit();
  };

  Fold<kOuts> f = make_fold<kOuts>(lane);
  stage(0, k_begin);
  int buf = 0;
  for (long long k0 = k_begin; k0 < k_end; k0 += kStep, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this step staged; the other buffer's last fold done
    if (k0 + kStep < k_end) stage(buf ^ 1, k0 + kStep);
    const float* const s_x = smem + buf * buf_floats;
    fold_step(f, s_x, s_x + kStep * kLdX, s_x + kStep * kLdX + o * kStep, warp, lane, o);
  }
  write_partials(f, ws_g, ws_m, ((long long)blockIdx.y * gridDim.x + blockIdx.x) * o, warp,
                 lane, o, m);
}

template <int kOuts>
int stats_launch_outputs(dim3 grid, size_t smem, cudaStream_t st, const float* xa,
                         const float* fsq, const float* fd, float* ws_g, float* ws_m, int m,
                         long long n, int o, long long slice_len) {
  auto kernel = stats_slice_kernel<kOuts>;
  const int err = allow_smem(kernel, smem);
  if (err != 0) return err;
  kernel<<<grid, kThreads, smem, st>>>(xa, fsq, fd, ws_g, ws_m, m, n, o, slice_len);
  return static_cast<int>(cudaGetLastError());
}

// Whether a launch of this shape takes this route (the rule
// ops.stats_slice_route states).
inline bool stats_takes(int m, int o) {
  return m >= 1 && m <= kSmallM && o >= 1 && o <= kWarps * kMaxOutputs;
}

// A launch on this route: `slices` slices a tenant, then their sum written
// into g and mv, or added into them (`accumulate`).  B4 and B5 (`batched`)
// sum their few slices a tenant with few_slice_reduce_kernel, B1 and B2
// (k = 1) their hundreds with slice_reduce_kernel.
inline int stats_launch(const float* xa, const float* fsq, const float* fd, float* ws_g,
                        float* ws_m, float* g, float* mv, int k, int m, long long n, int o,
                        int slices, long long slice_len, bool accumulate, bool batched,
                        cudaStream_t st) {
  const size_t smem = sizeof(float) * stats_smem_floats(o);
  const dim3 grid(k, slices);
  const int outs = (o + kWarps - 1) / kWarps;
  auto run = [&](auto fn) {
    return fn(grid, smem, st, xa, fsq, fd, ws_g, ws_m, m, n, o, slice_len);
  };
  const int err = outs == 1   ? run(stats_launch_outputs<1>)
                  : outs == 2 ? run(stats_launch_outputs<2>)
                  : outs == 3 ? run(stats_launch_outputs<3>)
                              : run(stats_launch_outputs<4>);
  if (err != 0) return err;
  if (batched) {
    return launch_few_slice_reduce(ws_g, ws_m, g, mv, m, (long long)k * o, slices, accumulate,
                                   st);
  }
  return launch_slice_reduce(ws_g, ws_m, g, mv, m, o, slices, accumulate, st);
}

}  // namespace slice
}  // namespace rolann
