// ROLANN sufficient statistics on Hopper (sm_90a), plain FP32 CUDA cores.
//
// Replaces the Pallas TPU kernel `rolann_stats_kernel` of
// src/repro/kernels/rolann_stats/kernel.py.  Per output o:
//
//     G[o] = xa · diag(fsq[o]) · xaᵀ        [o, m, m]
//     M[o] = xa · fd[o]                     [o, m]
//
// with xa [m, n], fsq and fd [o, n], all float32 and row-major, summed in
// float32.  Each term is formed as (xa[i]·fsq[o]) · xa[j], the reference's
// order.
//
// What bounds it.  Per launch the work is about o·m(m+1)/2·n FMAs (upper
// triangle of G) against (m + 2o)·n·4 bytes read.  On the DAEF main path
// (m = 19..28, o = 15..24, n ≈ 256k) that is 25 to 100 FLOP per byte, well
// above the H100's ~20 FP32 FLOP per byte of HBM, so it is bound by FP32
// compute.  This first version uses FP32 FMAs only (no tensor cores, no
// TF32), so its results hold the reference's float32 accuracy.
//
// Design.  The Pallas grid walks the sample axis in order and carries the sum
// in VMEM; Hopper's blocks run in no order, so:
//
//   * `partial_kernel` runs a grid of (output o, upper-triangle tile of G,
//     slice of the sample axis).  The path has at most 24 outputs and one
//     32x32 tile, so splitting the samples is what fills the 132 SMs.  o is
//     the fastest grid axis: the blocks of one slice run together and read
//     that slice of xa from L2, not HBM.  A block stages 64-sample chunks of
//     its tile's 32 rows of xa (times fsq[o]) and 32 columns in shared
//     memory, sample-major, so that a thread reads its 4 rows and its 4
//     columns of one sample as two float4 loads and does 16 FMAs with them.
//     A group of lanes covers the tile in 4x4 pieces and takes its share of
//     the chunk's samples; the groups sum in a fixed order at the end of the
//     slice, and the block writes its partial G tile (entries i <= j) and,
//     on diagonal tiles, its partial M rows to a workspace.
//   * With m <= 28 (every layer of the DAEF path) G is one tile whose upper
//     triangle is at most 28 pieces: a group is ONE warp, each lane one
//     piece of the triangle, and 8 groups share a chunk.  Otherwise a group
//     is two warps covering all 64 pieces of any tile.
//   * `reduce_kernel` sums the partials over the slices in slice order and
//     mirrors the upper triangle into the lower one, so G is exactly
//     symmetric.
//
// No float atomics: the result is the same from run to run.  Rows beyond m
// and samples beyond n are loaded as zeros and never written; nothing is
// padded in memory.  Making it fast (3xTF32 tensor cores, TMA) is later work.

#include <cuda_runtime.h>

namespace {

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

template <int kGroupWarps>
__global__ void __launch_bounds__(kThreads)
partial_kernel(const float* __restrict__ xa, const float* __restrict__ fsq,
               const float* __restrict__ fd, float* __restrict__ ws_g,
               float* __restrict__ ws_m, int m, long long n, int o, int tiles,
               long long slice_len) {
  constexpr int kGroupThreads = 32 * kGroupWarps;
  constexpr int kGroups = kThreads / kGroupThreads;
  constexpr int kGroupSamples = kChunk / kGroups;
  constexpr int kStage = 2 * kChunk * kLd + kChunk;
  constexpr int kRed = kGroups * kTile * (kTile + 1) + kGroups * kTile;
  // Staging buffers during the sample loop, the groups' partials after it.
  __shared__ __align__(16) float smem[kStage > kRed ? kStage : kRed];
  float* s_xs = smem;                        // [kChunk][kLd] rows of ti * fsq[o]
  float* s_x = smem + kChunk * kLd;          // [kChunk][kLd] rows of tj
  float* s_fd = smem + 2 * kChunk * kLd;     // [kChunk]

  const int oi = blockIdx.x;
  int ti, tj;
  tri_index(blockIdx.y, tiles, &ti, &tj);
  const int slice = blockIdx.z;
  const bool diag = ti == tj;
  const int i0 = ti * kTile;
  const int j0 = tj * kTile;
  const long long k_begin = (long long)slice * slice_len;
  const long long k_end = min(n, k_begin + slice_len);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = tid / kGroupThreads;
  const int gl = tid % kGroupThreads;        // lane within the group

  // This thread's 4x4 piece: rows ty*4.., columns tx*4.. of the tile.
  int ty, tx;
  bool active;
  if (kGroupWarps == 1) {                    // one diagonal tile, m <= 28
    const int side = (m + 3) / 4;
    tri_index(gl, side, &ty, &tx);
    active = ty < side;
    if (!active) ty = tx = 0;
  } else {
    ty = gl / 8;
    tx = gl % 8;
    active = !(diag && ty > tx) && i0 + ty * 4 < m && j0 + tx * 4 < m;
  }
  const bool m_lane = diag && gl < kTile;    // accumulates M of row gl

  // Loader: a warp moves 8 samples x 4 rows per step (32-byte segments of
  // xa), storing them transposed; rows 4*warp .. 4*warp+3 of the tile.
  const int lk = lane & 7;
  const int lr = (lane >> 3) + 4 * warp;
  const bool ri = i0 + lr < m;
  const bool rj = j0 + lr < m;
  const float* xi_row = xa + (long long)(ri ? i0 + lr : 0) * n;
  const float* xj_row = xa + (long long)(rj ? j0 + lr : 0) * n;
  const float* fsq_o = fsq + (long long)oi * n;
  const float* fd_o = fd + (long long)oi * n;

  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
  float macc = 0.f;

  for (long long k0 = k_begin; k0 < k_end; k0 += kChunk) {
#pragma unroll
    for (int step = 0; step < kChunk / 8; ++step) {
      const int c = lk + 8 * step;
      const long long k = k0 + c;
      const bool k_in = k < k_end;
      const float xi = (k_in && ri) ? __ldg(xi_row + k) : 0.f;
      const float f = k_in ? __ldg(fsq_o + k) : 0.f;
      s_xs[c * kLd + lr] = xi * f;
      s_x[c * kLd + lr] = diag ? xi : ((k_in && rj) ? __ldg(xj_row + k) : 0.f);
    }
    if (tid < kChunk) {
      const long long k = k0 + tid;
      s_fd[tid] = k < k_end ? __ldg(fd_o + k) : 0.f;
    }
    __syncthreads();

    const int c_begin = grp * kGroupSamples;
#pragma unroll
    for (int c = c_begin; c < c_begin + kGroupSamples; ++c) {
      const float4 a4 = *reinterpret_cast<const float4*>(s_xs + c * kLd + ty * 4);
      const float4 b4 = *reinterpret_cast<const float4*>(s_x + c * kLd + tx * 4);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
      if (m_lane) macc = fmaf(s_x[c * kLd + gl], s_fd[c], macc);
    }
    __syncthreads();
  }
  __syncthreads();  // the staging buffers become the partials' buffers

  // Sum the groups in a fixed order, then write this slice's partial.
  float (*s_red)[kTile][kTile + 1] = reinterpret_cast<float (*)[kTile][kTile + 1]>(smem);
  float (*s_redm)[kTile] =
      reinterpret_cast<float (*)[kTile]>(smem + kGroups * kTile * (kTile + 1));
  if (active) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) s_red[grp][ty * 4 + u][tx * 4 + v] = acc[u][v];
  }
  if (m_lane) s_redm[grp][gl] = macc;
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
      for (int q = 1; q < kGroups; ++q) sum += s_red[q][r][c];
      ws_g_o[(long long)i * m + j] = sum;
    }
  }
  if (diag && tid < kTile && i0 + tid < m) {
    float sum = s_redm[0][tid];
#pragma unroll
    for (int q = 1; q < kGroups; ++q) sum += s_redm[q][tid];
    ws_m[((long long)slice * o + oi) * m + i0 + tid] = sum;
  }
}

// One thread per entry of G (then of M): the sum over slices, in slice order.
__global__ void reduce_kernel(const float* __restrict__ ws_g,
                              const float* __restrict__ ws_m, float* __restrict__ g,
                              float* __restrict__ mv, int m, int o, int slices) {
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
    float sum = 0.f;
    for (int s = 0; s < slices; ++s) sum += ws_g[s * size_g + off];
    g[idx] = sum;
  } else if (idx < size_g + size_m) {
    const long long q = idx - size_g;
    float sum = 0.f;
    for (int s = 0; s < slices; ++s) sum += ws_m[s * size_m + q];
    mv[q] = sum;
  }
}

}  // namespace

// Launches both kernels on `stream`; returns cudaGetLastError() (0 = launched).
// ws_g [slices, o, m, m] and ws_m [slices, o, m] are scratch from the caller;
// slices * slice_len must cover n and every slice must start below n.
extern "C" int rolann_stats_f32(const float* xa, const float* fsq, const float* fd,
                                float* ws_g, float* ws_m, float* g, float* mv,
                                int m, long long n, int o, int slices,
                                long long slice_len, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (m + kTile - 1) / kTile;
  const dim3 grid(o, tiles * (tiles + 1) / 2, slices);
  if (m <= kSmallM) {
    partial_kernel<1><<<grid, kThreads, 0, st>>>(xa, fsq, fd, ws_g, ws_m, m, n, o,
                                                 tiles, slice_len);
  } else {
    partial_kernel<2><<<grid, kThreads, 0, st>>>(xa, fsq, fd, ws_g, ws_m, m, n, o,
                                                 tiles, slice_len);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = (long long)o * m * m + (long long)o * m;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  reduce_kernel<<<blocks, threads, 0, st>>>(ws_g, ws_m, g, mv, m, o, slices);
  return static_cast<int>(cudaGetLastError());
}
