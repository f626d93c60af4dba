// B3 and B6 with ma <= kSmallM (28) and m_l <= 32 on Hopper (sm_90a), FP32
// CUDA cores: each block forms its slice's activations once.
//
// Replaces, for that shape, the Pallas TPU kernels `rolann_fused_chunk_kernel`
// (B3; bodies `_kernel_fused_chunk` and `_fused_chunk_deltas`) and
// `rolann_fused_chunk_kernel_batched` (B6; body `_kernel_fused_chunk_batched`)
// of src/repro/kernels/rolann_stats/kernel.py: one streamed chunk of an
// ELM-AE decoder layer (of every tenant of a fleet, each with its own chunk,
// stage-1 encoder and mask, for B6), as rolann_fused_chunk.cu states it,
//
//     xa    = [act(wᵀ h + b); 1]                       [ma, n], ma = m_c1 + 1
//     d̄     = inv(clip(h[o])),  f' = deriv(d̄)          per output o < m_l
//     fsq   = f'² · mask,  fd = f'² · d̄ · mask
//     G[o] += xa · diag(fsq) · xaᵀ,  M[o] += xa · fd
//
// `launch()` in rolann_fused_chunk.cu takes this route for ma <= 28 and
// m_l <= 32, any number of tenants: every hidden layer of the streamed
// creditcard fit and of the chunked fleet fit, (m_l, m_c1) = (15, 18) ..
// (24, 27).  Wider layers keep `fused_partial_kernel`.
//
// What bounds it.  At (24, 27) and 32,768 samples the function is 2.1e8
// FMAs for G's upper triangle, 0.2e8 for M and the fsq scaling, and 0.2e8
// for the stage-1 product, against 3.3 MB read: ~8 µs on the FP32 cores,
// ~1 µs for the bytes, so operations bound it.  `fused_partial_kernel`
// runs a block per (output, G tile, slice), and each block formed its
// slice's stage-1 product and activations again: 24 times on this layer,
// 1.6–2.6 times the FMAs of G; and its G tile of 32 x 32 for ma <= 28
// leaves lanes idle on the 4x4 pieces past ma.
//
// Design.  A block of eight warps owns a slice of the samples and walks it
// in steps of kStep = 64 samples.  Per step it
//   1. stages the step's h, all m_l rows, and its mask weights in shared
//      memory (loaded into registers during the previous step's fold);
//   2. forms xa for the step once, sample-major in shared memory: lane i of
//      each warp owns row i (< 32) and 8 samples, w's column i and h's 8
//      samples are two broadcast float4 loads per input row, the bias row
//      is ones and rows past ma zeros;
//   3. forms fsq and fd of all m_l outputs for the step, in the reference's
//      order (clip, inv, deriv, fsq, fd, then the mask);
//   4. folds the step (rolann_slice_fold.cuh's `fold_step`, shared with
//      B4): warp v owns outputs v, v + 8, v + 16, v + 24, its lane l a 4x4
//      piece of G's upper triangle and row l of M for each of them.
// The accumulators of all outputs stay in registers over the slice (16 + 1
// per output), so xa and the targets never leave shared memory.  The block
// writes its slice's partial upper triangles and M rows to the workspace,
// and a second kernel adds them, in a fixed order, into the running
// accumulators.  Two 3xTF32 tensor-core forms of the fold (a wgmma per pair
// of outputs with xa·fsq as A; G as fsq times the pair products xa_i·xa_j)
// ran slower on the card than this one: at ma <= 28 forming and splitting
// their operands costs as much as this fold's FMAs (PERF.md).
//
// B6: the tenant axis.  The grid is (tenant, sample slice); a block takes
// tenant t's h, w, b and mask by offset and folds all m_l outputs of its
// slice, so a tenant's activations and targets are formed once per step,
// where `fused_partial_kernel` formed them again for each of the m_l
// outputs (1.6–2.6 times the FMAs of G).  The offsets are compiled into the
// batched instantiation only (kBatched): B3's keeps its registers (offsets
// kept live cost B3 4 %, PERF.md).  The fleet's chunks are short
// (1,024 samples a tenant, 16 steps): ops.plan_batched_slices cuts each
// tenant's chunk into a few slices of at least four steps so that the
// (tenant, slice) blocks fill the card once, and
// rolann_slice_fold.cuh's `few_slice_reduce_kernel`, a thread per entry
// summing its few slices in order, adds them into the running G and M.
// On the card (fleet layers, 64 tenants, 1,024 samples) 4 slices a tenant
// ran 55–90 µs a launch + 4–10 µs of reduce; 8 and 16 slices were slower
// (more partials to write and sum), 2 and 1 much slower (145–207 µs at one
// slice: 64 blocks, each walking 16 steps back to back).  A grid over
// (tenant, output group) with one slice a tenant, each block adding into
// G itself, needs no workspace and no reduce launch, but each block still
// walks all 16 steps, forms xa again per group, and with fewer outputs a
// warp its fold is bound by shared loads (PERF.md): it cannot beat the
// 16-step chain that the one-slice runs measured, so it was not built.
//
// B3's reduction.  A slice is a few hundred samples, so a chunk has a few
// hundred partials.  One thread per entry summing them in order (as
// rolann_common.cuh's `reduce_kernel` does) walks ~250 dependent loads, and
// half of them strided (the lower triangle read from the upper): B3 sums
// them with rolann_slice_fold.cuh's `slice_reduce_kernel<true>` instead, a
// block of eight warps per row of the upper triangle, warp v summing slices
// v, v + 8, ... with coalesced loads, the eight sums added in warp order to
// the running values of the entry and its mirror (B1 and B2 on
// rolann_stats_slice.cuh share it).  The order is fixed, so repeats are
// bit-identical, and a symmetric running G stays exactly symmetric.  No
// float atomics.
#pragma once

#include "rolann_slice_fold.cuh"

namespace rolann {

constexpr int kLogsig = 0;
constexpr int kTanh = 1;

template <int A>
__device__ __forceinline__ float act_fn(float z) {
  return A == kLogsig ? 1.f / (1.f + expf(-z)) : tanhf(z);
}

template <int A>
__device__ __forceinline__ float act_deriv(float z) {
  const float s = act_fn<A>(z);
  return A == kLogsig ? s * (1.f - s) : 1.f - s * s;
}

template <int A>
__device__ __forceinline__ float act_inv(float y) {
  return A == kLogsig ? logf(y) - log1pf(-y) : atanhf(y);
}

// clip_to_range: the open range shrunk by 1e-6, bounds rounded to float32
// as torch rounds a Python float; NaN passes through as in torch.clamp.
template <int A>
__device__ __forceinline__ float act_clip(float y) {
  constexpr float lo = A == kLogsig ? (float)(0.0 + 1e-6) : (float)(-1.0 + 1e-6);
  constexpr float hi = (float)(1.0 - 1e-6);
  return y < lo ? lo : (y > hi ? hi : y);
}

// d̄, fsq and fd of one target value and its mask weight.
template <int A>
__device__ __forceinline__ void targets(float hv, float mk, float* fsq, float* fd) {
  const float dbar = act_inv<A>(act_clip<A>(hv));
  const float fp = act_deriv<A>(dbar);
  float s = fp * fp;
  float d = s * dbar;
  *fsq = s * mk;
  *fd = d * mk;
}

namespace slice {

constexpr int kHPerThread = kWarps * kMaxOutputs * kStep / kThreads;  // staged h a thread loads

// Floats of dynamic shared memory for m_l outputs.
inline long long smem_floats(int m_l) {
  return (long long)m_l * kLdX + kLdX + kStep + 3LL * m_l * kStep + (long long)kStep * kLdX;
}

// B3 (kBatched false): grid x the slice.  ws_g [slices, m_l, ma (ma + 1)
// / 2] (upper triangles, packed by rows) and ws_m [slices, m_l, ma] receive
// each slice's partial sums.  B6 (kBatched): grid (tenant t, slice s) over
// h [k, m_l, n], w [k, m_l, m_c1], b [k, m_c1], mask [k, n]; the partials of
// (t, s) go to rows (s·k + t)·m_l .. of ws_g [slices, k·m_l, ..] and ws_m.
template <int kOuts, int A, bool kBatched>
__global__ void __launch_bounds__(kThreads, 2)
fused_slice_kernel(const float* __restrict__ h, const float* __restrict__ w,
                   const float* __restrict__ b, const float* __restrict__ mask,
                   float* __restrict__ ws_g, float* __restrict__ ws_m, int m_l, int m_c1,
                   long long n, long long slice_len) {
  extern __shared__ __align__(16) float smem[];
  float* const s_w = smem;                   // [m_l][kLdX] w's rows, 0 past m_c1
  float* const s_b = s_w + m_l * kLdX;       // [kLdX] b, 0 past m_c1
  float* const s_k = s_b + kLdX;             // [kStep] the step's mask weights
  float* const s_h = s_k + kStep;            // [m_l][kStep] the step's h
  float* const s_f = s_h + m_l * kStep;      // [m_l][kStep] fsq
  float* const s_d = s_f + m_l * kStep;      // [m_l][kStep] fd
  float* const s_x = s_d + m_l * kStep;      // [kStep][kLdX] xa, sample-major

  const int ma = m_c1 + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slice = kBatched ? blockIdx.y : blockIdx.x;
  if (kBatched) {                            // tenant t's chunk, encoder and mask
    const long long t = blockIdx.x;
    h += t * m_l * n;
    w += t * m_l * m_c1;
    b += t * m_c1;
    mask += t * n;
  }
  const long long k_begin = (long long)slice * slice_len;
  const long long k_end = min(n, k_begin + slice_len);

  for (int e = tid; e < m_l * kLdX; e += kThreads) {
    const int l = e / kLdX, i = e % kLdX;
    s_w[e] = i < m_c1 ? __ldg(w + (long long)l * m_c1 + i) : 0.f;
  }
  if (tid < kLdX) s_b[tid] = tid < m_c1 ? __ldg(b + tid) : 0.f;

  Fold<kOuts> f = make_fold<kOuts>(lane);
  const int c0 = warp * kSamplesPerLane;

  // 1. A step's h and mask weights (zeros past the slice), loaded into
  // registers a step ahead and stored while the fold runs.
  float h_next[kHPerThread], k_next = 0.f;
  auto load = [&](long long k0) {
#pragma unroll
    for (int u = 0; u < kHPerThread; ++u) {
      const int e = tid + kThreads * u;
      const long long k = k0 + e % kStep;
      h_next[u] = e < m_l * kStep && k < k_end ? __ldg(h + (long long)(e / kStep) * n + k) : 0.f;
    }
    if (tid < kStep) k_next = k0 + tid < k_end ? __ldg(mask + k0 + tid) : 0.f;
  };
  auto store = [&]() {
#pragma unroll
    for (int u = 0; u < kHPerThread; ++u)
      if (tid + kThreads * u < m_l * kStep) s_h[tid + kThreads * u] = h_next[u];
    if (tid < kStep) s_k[tid] = k_next;
  };
  load(k_begin);
  store();
  __syncthreads();

  for (long long k0 = k_begin; k0 < k_end; k0 += kStep) {

    // 2. xa, once for every output: row `lane`, samples c0 .. c0 + 7
    {
      float z[kSamplesPerLane];
#pragma unroll
      for (int s = 0; s < kSamplesPerLane; ++s) z[s] = 0.f;
      for (int l = 0; l < m_l; ++l) {
        const float4 h0 = *reinterpret_cast<const float4*>(s_h + l * kStep + c0);
        const float4 h1 = *reinterpret_cast<const float4*>(s_h + l * kStep + c0 + 4);
        const float hv[kSamplesPerLane] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
        const float wv = s_w[l * kLdX + lane];
#pragma unroll
        for (int s = 0; s < kSamplesPerLane; ++s) z[s] = fmaf(wv, hv[s], z[s]);
      }
      const float bv = s_b[lane];
#pragma unroll
      for (int s = 0; s < kSamplesPerLane; ++s)
        s_x[(c0 + s) * kLdX + lane] =
            lane < m_c1 ? act_fn<A>(z[s] + bv) : (lane == m_c1 ? 1.f : 0.f);
    }
    // 3. fsq and fd of every output; zeros past the slice
    for (int e = tid; e < m_l * kStep; e += kThreads) {
      float fsq = 0.f, fd = 0.f;
      if (k0 + e % kStep < k_end) targets<A>(s_h[e], s_k[e % kStep], &fsq, &fd);
      s_f[e] = fsq;
      s_d[e] = fd;
    }
    __syncthreads();
    const bool more = k0 + kStep < k_end;
    if (more) load(k0 + kStep);

    // 4. the fold
    fold_step(f, s_x, s_f, s_d, warp, lane, m_l);
    if (more) store();  // s_h and s_k are not read by the fold
    __syncthreads();
  }

  const long long row0 =
      kBatched ? ((long long)blockIdx.y * gridDim.x + blockIdx.x) * m_l
               : (long long)blockIdx.x * m_l;
  write_partials(f, ws_g, ws_m, row0, warp, lane, m_l, ma);
}

template <int kOuts, int A, bool kBatched>
int launch_outputs(dim3 grid, size_t smem, cudaStream_t st, const float* h, const float* w,
                   const float* b, const float* mask, float* ws_g, float* ws_m, int m_l,
                   int m_c1, long long n, long long slice_len) {
  auto kernel = fused_slice_kernel<kOuts, A, kBatched>;
  const int err = allow_smem(kernel, smem);
  if (err != 0) return err;
  kernel<<<grid, kThreads, smem, st>>>(h, w, b, mask, ws_g, ws_m, m_l, m_c1, n, slice_len);
  return static_cast<int>(cudaGetLastError());
}

// Whether this route takes a launch of k tenants (the rule
// ops.fused_slice_route states).
inline bool takes(int k, int m_l, int m_c1) {
  return k >= 1 && m_c1 + 1 <= kSmallM && m_l >= 1 && m_l <= kWarps * kMaxOutputs;
}

// B3 (k == 1, not `batched`) or B6 (`batched`, any k) on this route: the
// slices' partials, then their sum added into g and mv.  B3 sums its many
// slices with slice_reduce_kernel, B6 its few a tenant with
// few_slice_reduce_kernel.
template <int A>
int launch(const float* h, const float* w, const float* b, const float* mask, float* ws_g,
           float* ws_m, float* g, float* mv, int k, bool batched, int m_l, int m_c1,
           long long n, int slices, long long slice_len, cudaStream_t st) {
  const size_t smem = sizeof(float) * smem_floats(m_l);
  const int outs = (m_l + kWarps - 1) / kWarps;
  const dim3 grid = batched ? dim3(k, slices) : dim3(slices);
  auto run = [&](auto fn) {
    return fn(grid, smem, st, h, w, b, mask, ws_g, ws_m, m_l, m_c1, n, slice_len);
  };
  int err;
  if (batched) {
    err = outs == 1   ? run(launch_outputs<1, A, true>)
          : outs == 2 ? run(launch_outputs<2, A, true>)
          : outs == 3 ? run(launch_outputs<3, A, true>)
                      : run(launch_outputs<4, A, true>);
  } else {
    err = outs == 1   ? run(launch_outputs<1, A, false>)
          : outs == 2 ? run(launch_outputs<2, A, false>)
          : outs == 3 ? run(launch_outputs<3, A, false>)
                      : run(launch_outputs<4, A, false>);
  }
  if (err != 0) return err;
  const int ma = m_c1 + 1;
  if (batched) {
    return launch_few_slice_reduce(ws_g, ws_m, g, mv, ma, (long long)k * m_l, slices, true, st);
  }
  return launch_slice_reduce(ws_g, ws_m, g, mv, ma, m_l, slices, true, st);
}

}  // namespace slice
}  // namespace rolann
