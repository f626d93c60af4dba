// Pieces shared by the ROLANN statistics kernels (rolann_stats.cu and
// rolann_fused_chunk.cu): the geometry of a G tile, the 4x4 pieces the
// threads of a block own, the FMA loop over one staged chunk of samples, the
// write of a slice's partial (G, M) and the fixed-order reduction over
// slices.  See rolann_stats.cu for the design.
#pragma once

#include <cuda_runtime.h>

namespace rolann {

constexpr int kTile = 32;                    // rows and columns of one G tile
constexpr int kChunk = 64;                   // samples staged per iteration
constexpr int kThreads = 256;
constexpr int kLd = kTile + 4;               // sample-major row: float4-aligned,
                                             // conflict-free transposed stores
constexpr int kSmallM = 28;                  // largest m of the one-warp layout

// Linear index p of an upper-triangle tile -> its (row, column) tile.
__device__ __forceinline__ void tri_index(int p, int side, int* row, int* col) {
  int r = 0;
  while (r < side && p >= side - r) {
    p -= side - r;
    ++r;
  }
  *row = r;
  *col = r + p;
}

// How a block's threads share one G tile and one staged chunk.  With
// m <= kSmallM the tile is diagonal and its upper triangle is at most 28
// pieces: a group is ONE warp, each lane one piece, and 8 groups share a
// chunk.  Otherwise a group is two warps covering all 64 pieces of any tile.
template <int kGroupWarps>
struct Layout {
  static constexpr int kGroupThreads = 32 * kGroupWarps;
  static constexpr int kGroups = kThreads / kGroupThreads;
  static constexpr int kGroupSamples = kChunk / kGroups;
  // Floats of shared memory the groups' partials take after the sample loop.
  static constexpr int kRedFloats = kGroups * kTile * (kTile + 1) + kGroups * kTile;
};

// One thread's share of a tile: rows ty*4.., columns tx*4.. of the tile, and
// (lanes gl < kTile of a diagonal tile) row gl of M.
template <int kGroupWarps>
struct Piece {
  int grp, gl, ty, tx;
  bool active, m_lane;
  float acc[4][4];
  float macc;
};

template <int kGroupWarps>
__device__ __forceinline__ Piece<kGroupWarps> make_piece(int tid, int m, bool diag, int i0,
                                                         int j0) {
  using L = Layout<kGroupWarps>;
  Piece<kGroupWarps> p;
  p.grp = tid / L::kGroupThreads;
  p.gl = tid % L::kGroupThreads;
  if (kGroupWarps == 1) {                    // one diagonal tile, m <= 28
    const int side = (m + 3) / 4;
    tri_index(p.gl, side, &p.ty, &p.tx);
    p.active = p.ty < side;
    if (!p.active) p.ty = p.tx = 0;
  } else {
    p.ty = p.gl / 8;
    p.tx = p.gl % 8;
    p.active = !(diag && p.ty > p.tx) && i0 + p.ty * 4 < m && j0 + p.tx * 4 < m;
  }
  p.m_lane = diag && p.gl < kTile;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) p.acc[u][v] = 0.f;
  p.macc = 0.f;
  return p;
}

// Fold one staged chunk: s_xs [kChunk][kLd] holds the tile's rows of xa
// times fsq[o], s_x [kChunk][kLd] its columns of xa, s_fd [kChunk] fd[o].
// Each term is (xa[i]·fsq[o]) · xa[j], the reference's order.
template <int kGroupWarps>
__device__ __forceinline__ void fold_chunk(Piece<kGroupWarps>& p, const float* s_xs,
                                           const float* s_x, const float* s_fd) {
  using L = Layout<kGroupWarps>;
  const int c_begin = p.grp * L::kGroupSamples;
#pragma unroll
  for (int c = c_begin; c < c_begin + L::kGroupSamples; ++c) {
    const float4 a4 = *reinterpret_cast<const float4*>(s_xs + c * kLd + p.ty * 4);
    const float4 b4 = *reinterpret_cast<const float4*>(s_x + c * kLd + p.tx * 4);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) p.acc[u][v] = fmaf(a[u], b[v], p.acc[u][v]);
    if (p.m_lane) p.macc = fmaf(s_x[c * kLd + p.gl], s_fd[c], p.macc);
  }
}

// Sum the groups in a fixed order and write this slice's partial G tile
// (entries i <= j) and, on diagonal tiles, its partial M rows.  `smem` holds
// at least Layout::kRedFloats floats and is free (the caller synchronised).
template <int kGroupWarps>
__device__ __forceinline__ void write_partials(const Piece<kGroupWarps>& p, float* smem,
                                               float* __restrict__ ws_g,
                                               float* __restrict__ ws_m, int slice, int o,
                                               int oi, int m, int i0, int j0, bool diag) {
  using L = Layout<kGroupWarps>;
  const int tid = threadIdx.x;
  float (*s_red)[kTile][kTile + 1] = reinterpret_cast<float (*)[kTile][kTile + 1]>(smem);
  float (*s_redm)[kTile] =
      reinterpret_cast<float (*)[kTile]>(smem + L::kGroups * kTile * (kTile + 1));
  if (p.active) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) s_red[p.grp][p.ty * 4 + u][p.tx * 4 + v] = p.acc[u][v];
  }
  if (p.m_lane) s_redm[p.grp][p.gl] = p.macc;
  __syncthreads();

  float* ws_g_o = ws_g + ((long long)slice * o + oi) * m * m;
  for (int e = tid; e < kTile * kTile; e += kThreads) {
    const int r = e / kTile;
    const int c = e % kTile;
    const int i = i0 + r;
    const int j = j0 + c;
    if (i < m && j < m && i <= j) {
      float sum = s_red[0][r][c];
#pragma unroll
      for (int q = 1; q < L::kGroups; ++q) sum += s_red[q][r][c];
      ws_g_o[(long long)i * m + j] = sum;
    }
  }
  if (diag && tid < kTile && i0 + tid < m) {
    float sum = s_redm[0][tid];
#pragma unroll
    for (int q = 1; q < L::kGroups; ++q) sum += s_redm[q][tid];
    ws_m[((long long)slice * o + oi) * m + i0 + tid] = sum;
  }
}

// One thread per entry of G (then of M): the sum over slices, in slice
// order, mirrored from the upper triangle so G is exactly symmetric.  With
// `accumulate` the sum starts from the entry's running value (one
// read-modify-write per entry, no atomics); else from zero.
__global__ void reduce_kernel(const float* __restrict__ ws_g,
                              const float* __restrict__ ws_m, float* __restrict__ g,
                              float* __restrict__ mv, int m, int o, int slices,
                              bool accumulate) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long size_g = (long long)o * m * m;
  const long long size_m = (long long)o * m;
  if (idx < size_g) {
    const int j = (int)(idx % m);
    const int i = (int)((idx / m) % m);
    const long long oi = idx / ((long long)m * m);
    const int a = min(i, j);
    const int b = max(i, j);
    const long long off = (oi * m + a) * m + b;
    float sum = accumulate ? g[idx] : 0.f;
    for (int s = 0; s < slices; ++s) sum += ws_g[s * size_g + off];
    g[idx] = sum;
  } else if (idx < size_g + size_m) {
    const long long q = idx - size_g;
    float sum = accumulate ? mv[q] : 0.f;
    for (int s = 0; s < slices; ++s) sum += ws_m[s * size_m + q];
    mv[q] = sum;
  }
}

// Launch reduce_kernel on `st`; returns cudaGetLastError().
inline int launch_reduce(const float* ws_g, const float* ws_m, float* g, float* mv, int m,
                         int o, int slices, bool accumulate, cudaStream_t st) {
  const long long total = (long long)o * m * m + (long long)o * m;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  reduce_kernel<<<blocks, threads, 0, st>>>(ws_g, ws_m, g, mv, m, o, slices, accumulate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rolann
