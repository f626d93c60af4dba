// ROLANN sufficient statistics on Hopper (sm_90a), plain FP32 CUDA cores.
//
// Replaces four Pallas TPU kernels of src/repro/kernels/rolann_stats/kernel.py:
// `rolann_stats_kernel` (B1, `rolann_stats_f32`), the streaming fold
// `rolann_stats_kernel_acc` (B2, `rolann_stats_acc_f32`), which adds the same
// statistics into running accumulators, and their tenant-batched twins
// `rolann_stats_kernel_batched` (B4, `rolann_stats_batched_f32`) and
// `rolann_stats_kernel_acc_batched` (B5, `rolann_stats_acc_batched_f32`),
// which do the same for k tenants in one launch.  Per output o:
//
//     G[o] = xa · diag(fsq[o]) · xaᵀ        [o, m, m]
//     M[o] = xa · fd[o]                     [o, m]
//
// with xa [m, n], fsq and fd [o, n], all float32 and row-major, summed in
// float32 (and per tenant t of B4/B5: xa [k, m, n], fsq and fd [k, o, n],
// G [k, o, m, m], M [k, o, m]).  Each term is formed as (xa[i]·fsq[o]) ·
// xa[j], the reference's order.
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
//   * `reduce_kernel` (rolann_common.cuh) sums the partials over the slices
//     in slice order and mirrors the upper triangle into the lower one, so G
//     is exactly symmetric.  For B2 it starts each entry's sum from the
//     running accumulator: one read-modify-write per entry, where the TPU
//     kernel aliased the accumulators onto its outputs.  A symmetric running
//     G stays exactly symmetric.
//
// The tenant axis.  B1 and B2 are the k = 1 case of one template: grid axis
// x runs over the k·o (tenant, output) pairs, blockIdx.x = t·o + o', so fsq,
// fd, the workspace and the accumulators are contiguous [k·o, ...] arrays
// exactly as the one-tenant [o, ...] ones are, and `reduce_kernel` sums
// [slices, k·o, m, m] unchanged.  Only xa takes a per-tenant offset.  On the
// fleet path (k = 64, n ≈ 4k per tenant) the (tenant, output) pairs alone
// give 960–1,536 blocks, so the planner cuts the sample axis into 1–2 slices
// where one tenant of 256k samples takes ~70; the work per block, and so the
// bound, is that of B1 over the same total samples.
//
// No float atomics: the result is the same from run to run.  Rows beyond m
// and samples beyond n are loaded as zeros and never written; nothing is
// padded in memory.  Making it fast (3xTF32 tensor cores, TMA) is later work.

#include "rolann_common.cuh"

namespace {

using namespace rolann;

template <int kGroupWarps>
__global__ void __launch_bounds__(kThreads)
partial_kernel(const float* __restrict__ xa, const float* __restrict__ fsq,
               const float* __restrict__ fd, float* __restrict__ ws_g,
               float* __restrict__ ws_m, int m, long long n, int o, int tiles,
               long long slice_len) {
  constexpr int kStage = 2 * kChunk * kLd + kChunk;
  constexpr int kRed = Layout<kGroupWarps>::kRedFloats;
  // Staging buffers during the sample loop, the groups' partials after it.
  __shared__ __align__(16) float smem[kStage > kRed ? kStage : kRed];
  float* s_xs = smem;                        // [kChunk][kLd] rows of ti * fsq[o]
  float* s_x = smem + kChunk * kLd;          // [kChunk][kLd] rows of tj
  float* s_fd = smem + 2 * kChunk * kLd;     // [kChunk]

  const int pair = blockIdx.x;                // t·o + oi
  xa += (long long)(pair / o) * m * n;       // tenant t's xa
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
  Piece<kGroupWarps> p = make_piece<kGroupWarps>(tid, m, diag, i0, j0);

  // Loader: a warp moves 8 samples x 4 rows per step (32-byte segments of
  // xa), storing them transposed; rows 4*warp .. 4*warp+3 of the tile.
  const int lk = lane & 7;
  const int lr = (lane >> 3) + 4 * warp;
  const bool ri = i0 + lr < m;
  const bool rj = j0 + lr < m;
  const float* xi_row = xa + (long long)(ri ? i0 + lr : 0) * n;
  const float* xj_row = xa + (long long)(rj ? j0 + lr : 0) * n;
  const float* fsq_o = fsq + (long long)pair * n;
  const float* fd_o = fd + (long long)pair * n;

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
    fold_chunk(p, s_xs, s_x, s_fd);
    __syncthreads();
  }
  __syncthreads();  // the staging buffers become the partials' buffers
  write_partials(p, smem, ws_g, ws_m, slice, gridDim.x, pair, m, i0, j0, diag);
}

int launch(const float* xa, const float* fsq, const float* fd, float* ws_g, float* ws_m,
           float* g, float* mv, int k, int m, long long n, int o, int slices,
           long long slice_len, bool accumulate, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (m + kTile - 1) / kTile;
  const dim3 grid(k * o, tiles * (tiles + 1) / 2, slices);
  if (m <= kSmallM) {
    partial_kernel<1><<<grid, kThreads, 0, st>>>(xa, fsq, fd, ws_g, ws_m, m, n, o,
                                                 tiles, slice_len);
  } else {
    partial_kernel<2><<<grid, kThreads, 0, st>>>(xa, fsq, fd, ws_g, ws_m, m, n, o,
                                                 tiles, slice_len);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_reduce(ws_g, ws_m, g, mv, m, k * o, slices, accumulate, st);
}

}  // namespace

// B1: (G, M) of xa, fsq, fd into g [o, m, m], mv [o, m].  Launches both
// kernels on `stream`; returns cudaGetLastError() (0 = launched).
// ws_g [slices, o, m, m] and ws_m [slices, o, m] are scratch from the caller;
// slices * slice_len must cover n and every slice must start below n.
extern "C" int rolann_stats_f32(const float* xa, const float* fsq, const float* fd,
                                float* ws_g, float* ws_m, float* g, float* mv,
                                int m, long long n, int o, int slices,
                                long long slice_len, void* stream) {
  return launch(xa, fsq, fd, ws_g, ws_m, g, mv, 1, m, n, o, slices, slice_len, false, stream);
}

// B2: the same (G, M), added into the running g and mv (one read-modify-write
// per entry, slice sums in slice order).  Same arguments and scratch.
extern "C" int rolann_stats_acc_f32(const float* xa, const float* fsq, const float* fd,
                                    float* ws_g, float* ws_m, float* g, float* mv,
                                    int m, long long n, int o, int slices,
                                    long long slice_len, void* stream) {
  return launch(xa, fsq, fd, ws_g, ws_m, g, mv, 1, m, n, o, slices, slice_len, true, stream);
}

// B4: (G, M) of k tenants in one launch: xa [k, m, n], fsq and fd [k, o, n]
// into g [k, o, m, m], mv [k, o, m].  ws_g [slices, k·o, m, m] and ws_m
// [slices, k·o, m] are scratch from the caller; slices are planned for k·o
// (tenant, output) pairs.
extern "C" int rolann_stats_batched_f32(const float* xa, const float* fsq, const float* fd,
                                        float* ws_g, float* ws_m, float* g, float* mv,
                                        int k, int m, long long n, int o, int slices,
                                        long long slice_len, void* stream) {
  return launch(xa, fsq, fd, ws_g, ws_m, g, mv, k, m, n, o, slices, slice_len, false, stream);
}

// B5: B4's (G, M), added into the running g [k, o, m, m] and mv [k, o, m].
// Same arguments and scratch.
extern "C" int rolann_stats_acc_batched_f32(const float* xa, const float* fsq,
                                            const float* fd, float* ws_g, float* ws_m,
                                            float* g, float* mv, int k, int m, long long n,
                                            int o, int slices, long long slice_len,
                                            void* stream) {
  return launch(xa, fsq, fd, ws_g, ws_m, g, mv, k, m, n, o, slices, slice_len, true, stream);
}
