// B3 for one tenant with ma <= kSmallM (28) and m_l <= 32 on Hopper
// (sm_90a), FP32 CUDA cores: each block forms its slice's activations once.
//
// Replaces, for that shape, the Pallas TPU kernel `rolann_fused_chunk_kernel`
// (bodies `_kernel_fused_chunk` and `_fused_chunk_deltas`) of
// src/repro/kernels/rolann_stats/kernel.py (B3): one streamed chunk of an
// ELM-AE decoder layer, as rolann_fused_chunk.cu states it,
//
//     xa    = [act(wᵀ h + b); 1]                       [ma, n], ma = m_c1 + 1
//     d̄     = inv(clip(h[o])),  f' = deriv(d̄)          per output o < m_l
//     fsq   = f'² · mask,  fd = f'² · d̄ · mask
//     G[o] += xa · diag(fsq) · xaᵀ,  M[o] += xa · fd
//
// `launch()` in rolann_fused_chunk.cu takes this route for one tenant
// (k == 1), ma <= 28 and m_l <= 32: every hidden layer of the streamed
// creditcard fit, (m_l, m_c1) = (15, 18) .. (24, 27).  Wider layers and B6
// keep `fused_partial_kernel`.
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
//   4. folds the step: warp v owns outputs v, v + 8, v + 16, v + 24, and
//      its lane l the l-th 4x4 piece of the upper triangle of a 28 x 28 G
//      (28 pieces) and row l of M, for each of its outputs.  Per sample a
//      lane reads its piece's 4 rows and 4 columns of xa (two float4 loads)
//      and its M row once for all its outputs; each output adds
//      (xa[i]·fsq[o])·xa[j] (the reference's order) and xa[l]·fd[o].
// The accumulators of all outputs stay in registers over the slice (16 + 1
// per output), so xa and the targets never leave shared memory.  The block
// writes its slice's partial upper triangles and M rows to the workspace,
// and `slice_reduce_kernel` adds them, in a fixed order, into the running
// accumulators.  Two 3xTF32 tensor-core forms of the fold (a wgmma per pair
// of outputs with xa·fsq as A; G as fsq times the pair products xa_i·xa_j)
// ran slower on the card than this one: at ma <= 28 forming and splitting
// their operands costs as much as this fold's FMAs (PERF.md).
//
// The reduction.  A slice is a few hundred samples, so a chunk has a few
// hundred partials.  One thread per entry summing them in order (as
// rolann_common.cuh's `reduce_kernel` does) walks ~250 dependent loads, and
// half of them strided (the lower triangle read from the upper): a block
// of eight warps takes one row of the upper triangle instead, warp v sums
// slices v, v + 8, ... with coalesced loads, and the eight sums are added
// in warp order to the running values of the entry and its mirror.
// The order is fixed, so repeats are bit-identical, and a symmetric
// running G stays exactly symmetric.  No float atomics.
#pragma once

#include "rolann_common.cuh"

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

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStep = 64;                  // samples staged per step
constexpr int kLdX = 32;                   // floats per staged sample of xa (ma <= 28)
constexpr int kSide = kSmallM / 4;         // 4x4 pieces along a side of G
constexpr int kPieces = kSide * (kSide + 1) / 2;
constexpr int kMaxOutputs = 4;             // outputs per warp: m_l <= 32
constexpr int kSamplesPerLane = kStep / kWarps;
constexpr int kHPerThread = kWarps * kMaxOutputs * kStep / kThreads;  // staged h a thread loads
static_assert(kPieces <= 32 && kSmallM <= kLdX, "a piece and an M row per lane");
static_assert(kStep <= kThreads, "a thread loads each mask weight of a step");

// Floats of dynamic shared memory for m_l outputs.
inline long long smem_floats(int m_l) {
  return (long long)m_l * kLdX + kLdX + kStep + 3LL * m_l * kStep + (long long)kStep * kLdX;
}

// Offset of row i of an upper triangle of side m packed by rows.
__host__ __device__ __forceinline__ int tri_row(int i, int m) { return i * m - i * (i - 1) / 2; }

// Grid: x the slice.  ws_g [slices, m_l, ma (ma + 1) / 2] (upper triangles,
// packed by rows) and ws_m [slices, m_l, ma] receive each slice's partial
// sums.
template <int kOuts, int A>
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
  const long long k_begin = (long long)blockIdx.x * slice_len;
  const long long k_end = min(n, k_begin + slice_len);

  for (int e = tid; e < m_l * kLdX; e += kThreads) {
    const int l = e / kLdX, i = e % kLdX;
    s_w[e] = i < m_c1 ? __ldg(w + (long long)l * m_c1 + i) : 0.f;
  }
  if (tid < kLdX) s_b[tid] = tid < m_c1 ? __ldg(b + tid) : 0.f;

  // This lane's piece (rows 4ty.., columns 4tx..) and M row `lane`.
  const bool piece = lane < kPieces;
  int ty = 0, tx = 0;
  if (piece) tri_index(lane, kSide, &ty, &tx);
  float acc[kOuts][4][4], macc[kOuts];
#pragma unroll
  for (int q = 0; q < kOuts; ++q) {
    macc[q] = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[q][u][v] = 0.f;
  }
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

    // 4. the fold, four samples at a time (each output's fsq and fd of the
    // four as one broadcast float4 each)
#pragma unroll 1
    for (int c4 = 0; c4 < kStep; c4 += 4) {
      float4 f4[kOuts], d4[kOuts];
#pragma unroll
      for (int q = 0; q < kOuts; ++q) {
        const int o = min(warp + kWarps * q, m_l - 1);
        f4[q] = *reinterpret_cast<const float4*>(s_f + o * kStep + c4);
        d4[q] = *reinterpret_cast<const float4*>(s_d + o * kStep + c4);
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int c = c4 + cc;
        const float4 a4 = *reinterpret_cast<const float4*>(s_x + c * kLdX + ty * 4);
        const float4 b4 = *reinterpret_cast<const float4*>(s_x + c * kLdX + tx * 4);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
        const float xm = s_x[c * kLdX + lane];
#pragma unroll
        for (int q = 0; q < kOuts; ++q) {
          if (warp + kWarps * q < m_l) {  // warp-uniform
            const float f = cc == 0 ? f4[q].x : cc == 1 ? f4[q].y : cc == 2 ? f4[q].z : f4[q].w;
            const float d = cc == 0 ? d4[q].x : cc == 1 ? d4[q].y : cc == 2 ? d4[q].z : d4[q].w;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float as = a[u] * f;
#pragma unroll
              for (int v = 0; v < 4; ++v) acc[q][u][v] = fmaf(as, bb[v], acc[q][u][v]);
            }
            macc[q] = fmaf(xm, d, macc[q]);
          }
        }
      }
    }
    if (more) store();  // s_h and s_k are not read by the fold
    __syncthreads();
  }

  // This slice's partial (G, M) of each of the warp's outputs: G's upper
  // triangle packed by rows (row i from the diagonal on, at tri_row(i)).
#pragma unroll
  for (int q = 0; q < kOuts; ++q) {
    const int o = warp + kWarps * q;
    if (o >= m_l) continue;
    const long long row = (long long)blockIdx.x * m_l + o;
    if (piece) {
      float* const out = ws_g + row * (ma * (ma + 1) / 2);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = ty * 4 + u, j = tx * 4 + v;
          if (i <= j && j < ma) out[tri_row(i, ma) + j - i] = acc[q][u][v];
        }
    }
    if (lane < ma) ws_m[row * ma + lane] = macc[q];
  }
}

// g [o, m, m] and mv [o, m] += the sum over `slices` partials of ws_g
// [slices, o, m (m + 1) / 2] (packed upper triangles) and ws_m [slices, o,
// m].  Block
// (o', i) takes row i of G[o'] from the diagonal on (i < m), or M[o'] (i ==
// m), a lane an entry; warp v sums slices v, v + 8, ... in order; the
// running values of (i, j) and (j, i) each add the eight sums in warp
// order.
__global__ void __launch_bounds__(kThreads)
slice_reduce_kernel(const float* __restrict__ ws_g, const float* __restrict__ ws_m,
                    float* __restrict__ g, float* __restrict__ mv, int m, int o, int slices) {
  __shared__ float s_part[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long oi = blockIdx.x / (m + 1);
  const int i = blockIdx.x % (m + 1);
  const bool is_m = i == m;
  const int j = (is_m ? 0 : i) + lane;
  const bool on = j < m;
  const long long tri = (long long)m * (m + 1) / 2;
  const long long stride = is_m ? (long long)o * m : o * tri;
  const float* const src =
      is_m ? ws_m + oi * m + j : ws_g + oi * tri + tri_row(i, m) + (j - i);
  float sum = 0.f;
  if (on) {
#pragma unroll 4
    for (int s = warp; s < slices; s += kWarps) sum += src[s * stride];
  }
  s_part[warp][lane] = sum;
  __syncthreads();
  if (warp == 0 && on) {
    auto add = [&](float* dst) {
      float total = *dst;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) total += s_part[v][lane];
      *dst = total;
    };
    add(is_m ? mv + oi * m + j : g + (oi * m + i) * m + j);
    if (!is_m && j != i) add(g + (oi * m + j) * m + i);
  }
}

template <int kOuts, int A>
int launch_outputs(int slices, size_t smem, cudaStream_t st, const float* h, const float* w,
                   const float* b, const float* mask, float* ws_g, float* ws_m, int m_l,
                   int m_c1, long long n, long long slice_len) {
  auto kernel = fused_slice_kernel<kOuts, A>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<slices, kThreads, smem, st>>>(h, w, b, mask, ws_g, ws_m, m_l, m_c1, n, slice_len);
  return static_cast<int>(cudaGetLastError());
}

// Whether this route takes a launch (the rule ops.fused_slice_route states).
inline bool takes(int k, int m_l, int m_c1) {
  return k == 1 && m_c1 + 1 <= kSmallM && m_l >= 1 && m_l <= kWarps * kMaxOutputs;
}

// B3 on this route: the slices' partials, then their sum into g and mv.
template <int A>
int launch(const float* h, const float* w, const float* b, const float* mask, float* ws_g,
           float* ws_m, float* g, float* mv, int m_l, int m_c1, long long n, int slices,
           long long slice_len, cudaStream_t st) {
  const size_t smem = sizeof(float) * smem_floats(m_l);
  const int outs = (m_l + kWarps - 1) / kWarps;
  auto run = [&](auto fn) {
    return fn(slices, smem, st, h, w, b, mask, ws_g, ws_m, m_l, m_c1, n, slice_len);
  };
  const int err = outs == 1   ? run(launch_outputs<1, A>)
                  : outs == 2 ? run(launch_outputs<2, A>)
                  : outs == 3 ? run(launch_outputs<3, A>)
                              : run(launch_outputs<4, A>);
  if (err != 0) return err;
  const int ma = m_c1 + 1;
  slice_reduce_kernel<<<static_cast<unsigned>(m_l * (ma + 1)), kThreads, 0, st>>>(
      ws_g, ws_m, g, mv, ma, m_l, slices);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slice
}  // namespace rolann
