// The fold of the block-per-sample-slice statistics kernels on Hopper
// (sm_90a), FP32 CUDA cores, shared by B3 and B6 (rolann_fused_slice.cuh)
// and B1, B2, B4 and B5 (rolann_stats_slice.cuh).  Each of those kernels stages one step of
// kStep = 64 samples in shared memory, per step:
//
//     s_x [kStep][kLdX]   xa, sample-major (rows past ma are zeros)
//     s_f [m_l][kStep]    fsq of every output
//     s_d [m_l][kStep]    fd of every output
//
// and `fold_step` adds the step into a lane's accumulators: warp v owns
// outputs v, v + 8, v + 16, v + 24, and its lane l the l-th 4x4 piece of the
// upper triangle of a 28 x 28 G (28 pieces) and row l of M, for each of its
// outputs.  Per sample a lane reads its piece's 4 rows and 4 columns of xa
// (two float4 loads) and its M row once for all its outputs; each output
// adds (xa[i]·fsq[o])·xa[j] (the reference's order) and xa[l]·fd[o].  The
// accumulators of all a warp's outputs stay in registers over the slice
// (16 + 1 per output).  `write_partials` stores a slice's sums to the
// workspace: G's upper triangle packed by rows, and M.  Two reductions sum
// a launch's partials in a fixed order: `few_slice_reduce_kernel`, a
// thread per entry, for a few slices a tenant (B4, B5, B6), and
// `slice_reduce_kernel`, a block per row, for one tenant's hundreds of
// slices (B1, B2, B3).  Each writes its sum from zero or adds it into the
// running value (kAccumulate).
#pragma once

#include "rolann_common.cuh"

namespace rolann {
namespace slice {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStep = 64;                  // samples staged per step
constexpr int kLdX = 32;                   // floats per staged sample of xa (ma <= 28)
constexpr int kSide = kSmallM / 4;         // 4x4 pieces along a side of G
constexpr int kPieces = kSide * (kSide + 1) / 2;
constexpr int kMaxOutputs = 4;             // outputs per warp: m_l <= 32
constexpr int kSamplesPerLane = kStep / kWarps;
static_assert(kPieces <= 32 && kSmallM <= kLdX, "a piece and an M row per lane");
static_assert(kStep <= kThreads, "a thread loads each mask weight of a step");

// Offset of row i of an upper triangle of side m packed by rows.
__host__ __device__ __forceinline__ int tri_row(int i, int m) { return i * m - i * (i - 1) / 2; }

// One lane's share of a slice's (G, M): its piece (rows 4ty.., columns
// 4tx..) and M row `lane`, for each of its warp's kOuts outputs.
template <int kOuts>
struct Fold {
  float acc[kOuts][4][4];
  float macc[kOuts];
  int ty, tx;
  bool piece;
};

template <int kOuts>
__device__ __forceinline__ Fold<kOuts> make_fold(int lane) {
  Fold<kOuts> f;
  f.piece = lane < kPieces;
  f.ty = f.tx = 0;
  if (f.piece) tri_index(lane, kSide, &f.ty, &f.tx);
#pragma unroll
  for (int q = 0; q < kOuts; ++q) {
    f.macc[q] = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) f.acc[q][u][v] = 0.f;
  }
  return f;
}

// Fold one staged step, four samples at a time (each output's fsq and fd
// of the four as one broadcast float4 each).  `m_l` outputs in s_f, s_d.
template <int kOuts>
__device__ __forceinline__ void fold_step(Fold<kOuts>& f, const float* s_x, const float* s_f,
                                          const float* s_d, int warp, int lane, int m_l) {
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
      const float4 a4 = *reinterpret_cast<const float4*>(s_x + c * kLdX + f.ty * 4);
      const float4 b4 = *reinterpret_cast<const float4*>(s_x + c * kLdX + f.tx * 4);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
      const float xm = s_x[c * kLdX + lane];
#pragma unroll
      for (int q = 0; q < kOuts; ++q) {
        if (warp + kWarps * q < m_l) {  // warp-uniform
          const float fq = cc == 0 ? f4[q].x : cc == 1 ? f4[q].y : cc == 2 ? f4[q].z : f4[q].w;
          const float dq = cc == 0 ? d4[q].x : cc == 1 ? d4[q].y : cc == 2 ? d4[q].z : d4[q].w;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float as = a[u] * fq;
#pragma unroll
            for (int v = 0; v < 4; ++v) f.acc[q][u][v] = fmaf(as, bb[v], f.acc[q][u][v]);
          }
          f.macc[q] = fmaf(xm, dq, f.macc[q]);
        }
      }
    }
  }
}

// This slice's partial (G, M) of each of the warp's outputs, output o at
// row `row0 + o` of ws_g [.., ma (ma + 1) / 2] (G's upper triangle packed
// by rows: row i from the diagonal on, at tri_row(i)) and ws_m [.., ma].
template <int kOuts>
__device__ __forceinline__ void write_partials(const Fold<kOuts>& f, float* __restrict__ ws_g,
                                               float* __restrict__ ws_m, long long row0,
                                               int warp, int lane, int m_l, int ma) {
#pragma unroll
  for (int q = 0; q < kOuts; ++q) {
    const int o = warp + kWarps * q;
    if (o >= m_l) continue;
    const long long row = row0 + o;
    if (f.piece) {
      float* const out = ws_g + row * (ma * (ma + 1) / 2);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = f.ty * 4 + u, j = f.tx * 4 + v;
          if (i <= j && j < ma) out[tri_row(i, ma) + j - i] = f.acc[q][u][v];
        }
    }
    if (lane < ma) ws_m[row * ma + lane] = f.macc[q];
  }
}

// g [pairs, m, m] and mv [pairs, m] receive the sum over `slices` partials
// of ws_g [slices, pairs, m (m + 1) / 2] (packed upper triangles) and ws_m
// [slices, pairs, m], one thread per entry of a pair's packed triangle and
// M row, summing its slices in order; with kAccumulate from the entry's
// running value, else from zero (the output is written whole: no memset).
// (i, j) and (j, i) get the same sum, so G is exactly symmetric (a running
// G stays so).  For launches of a few slices a tenant (B4, B5, B6): a thread
// walks its slices' coalesced partials itself.
template <bool kAccumulate>
__global__ void __launch_bounds__(256)
few_slice_reduce_kernel(const float* __restrict__ ws_g, const float* __restrict__ ws_m,
                        float* __restrict__ g, float* __restrict__ mv, int m, long long pairs,
                        int slices) {
  const int tri = m * (m + 1) / 2;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= pairs * (tri + m)) return;
  const long long p = idx / (tri + m);
  int e = static_cast<int>(idx - p * (tri + m));
  if (e < tri) {
    int i = 0;
    while (e >= m - i) {
      e -= m - i;
      ++i;
    }
    const int j = i + e;
    const float* src = ws_g + p * tri + tri_row(i, m) + e;
    float* const dst = g + (p * m + i) * m + j;
    float sum = kAccumulate ? *dst : 0.f;
    for (int s = 0; s < slices; ++s) sum += src[s * pairs * tri];
    *dst = sum;
    if (j != i) g[(p * m + j) * m + i] = sum;
  } else {
    e -= tri;
    float* const dst = mv + p * m + e;
    float sum = kAccumulate ? *dst : 0.f;
    for (int s = 0; s < slices; ++s) sum += ws_m[(s * pairs + p) * m + e];
    *dst = sum;
  }
}

// Launch few_slice_reduce_kernel on `st`; returns cudaGetLastError().
inline int launch_few_slice_reduce(const float* ws_g, const float* ws_m, float* g, float* mv,
                                   int m, long long pairs, int slices, bool accumulate,
                                   cudaStream_t st) {
  const long long total = pairs * (m * (m + 1) / 2 + m);
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  if (accumulate) {
    few_slice_reduce_kernel<true><<<blocks, 256, 0, st>>>(ws_g, ws_m, g, mv, m, pairs, slices);
  } else {
    few_slice_reduce_kernel<false><<<blocks, 256, 0, st>>>(ws_g, ws_m, g, mv, m, pairs, slices);
  }
  return static_cast<int>(cudaGetLastError());
}

// g [o, m, m] and mv [o, m] receive the sum over `slices` partials of one
// tenant's ws_g [slices, o, m (m + 1) / 2] (packed upper triangles) and
// ws_m [slices, o, m]: with kAccumulate added to the running values (B2,
// B3), else written from zero (B1; no memset).  Block (o', i) takes row i
// of G[o'] from the diagonal on (i < m), or M[o'] (i == m), a lane an
// entry; warp v sums slices v, v + 8, ... in order with coalesced loads;
// the values of (i, j) and (j, i) each add the eight sums in warp order, so
// G is exactly symmetric (a running G stays so).  For launches of hundreds
// of slices, where a thread walking them all would chain ~250 dependent
// loads.
template <bool kAccumulate>
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
    auto put = [&](float* dst) {
      float total = kAccumulate ? *dst : 0.f;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) total += s_part[v][lane];
      *dst = total;
    };
    put(is_m ? mv + oi * m + j : g + (oi * m + i) * m + j);
    if (!is_m && j != i) put(g + (oi * m + j) * m + i);
  }
}

// Launch slice_reduce_kernel on `st`; returns cudaGetLastError().
inline int launch_slice_reduce(const float* ws_g, const float* ws_m, float* g, float* mv, int m,
                               int o, int slices, bool accumulate, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>(o * (m + 1));
  if (accumulate) {
    slice_reduce_kernel<true><<<blocks, kThreads, 0, st>>>(ws_g, ws_m, g, mv, m, o, slices);
  } else {
    slice_reduce_kernel<false><<<blocks, kThreads, 0, st>>>(ws_g, ws_m, g, mv, m, o, slices);
  }
  return static_cast<int>(cudaGetLastError());
}

// Set a kernel's dynamic shared memory above the default 48 KB when it needs
// it; returns the CUDA error (0 = none).
template <typename Kernel>
inline int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem)));
}

}  // namespace slice
}  // namespace rolann
