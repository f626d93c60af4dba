// B1 for one tenant with m > kSmallM on Hopper's tensor cores (sm_90a):
// 3xTF32 wgmma with float32 accumulators.
//
// Replaces, for that route, the Pallas TPU kernel `rolann_stats_kernel`
// (body `_kernel`) of src/repro/kernels/rolann_stats/kernel.py (B1):
// G[o] = (xa ∘ fsq[o]) · xaᵀ and M[o] = xa · fd[o] for xa [m, n], fsq and
// fd [o, n], float32.  `launch()` in rolann_stats.cu takes this route for
// one tenant (k == 1), no accumulation and m > kSmallM (28): the DAEF head's
// hidden decoder layer (m 513, o 256, n 2,048).  The m <= 28 route (every
// creditcard layer) and B2, B4, B5 keep `partial_kernel`.
//
// What bounds it.  At the head's shape the function is 1.39e11 FLOP (the
// upper triangle of G) against 8.2 MB read and 270 MB written: 2.08 ms on
// the FP32 cores (67 TFLOP/s), 0.84 ms as three TF32 products on the tensor
// cores (495 / 3 TFLOP/s), 0.083 ms for the bytes.  So it is bound by
// operations, and the FP32 route (10.2 ms) also re-read each block's 64
// rows of xa over all n for every output: ~20 GB of L2 traffic for a 4.2 MB
// xa, since only the fsq scaling depends on o.
//
// Design.  A block of two warpgroups (256 threads) owns a pair of 64-row
// tiles (ti <= tj) of G for a group of kOutputs = 4 outputs, two a
// warpgroup, over a slice of the samples.  Per step of 32 samples it stages the rows of both
// tiles once (thread loads, any n; rows past m and samples past the slice
// are zeros), splits the xa_j tile into hi and lo TF32 tiles in shared
// memory (K-major: n is contiguous in xa, and TF32 wgmma reads B only
// K-major) and keeps xa_i raw.  For each output each thread forms its A
// fragment of (xa_i · fsq[o]) in registers (the reference's order),
// splits it, and issues lo·hi, hi·lo, hi·hi (m64n64k8) into that output's
// 64 x 64 float32 accumulator: the staged tiles and their split serve all
// kOutputs outputs, which cuts the L2 traffic by kOutputs.  Each warpgroup
// waits for its wgmmas once per k8 step; with two blocks an SM (at most 128
// registers a thread) four warpgroups take turns on the tensor cores.
// (Keeping several commit groups in flight inside one warpgroup instead
// made ptxas serialise the wgmmas, at 255 registers.)  The next step's
// samples are loaded into registers while this one's wgmmas run.  M is
// 0.5 % of the work and stays on FP32 FMAs, in sample order, in the blocks
// of the diagonal (ti == tj).  A last tile of at most 8 rows (the head's
// 513 = 8·64 + 1) is a second launch whose blocks take it as an 8-wide
// column tile (m64n8k8): as a 64-row tile it would be a fifth of the work.
//
// Runs.  The tensor cores add each product into the float32 accumulator
// rounding toward zero, so a long run of adds drifts low (PERF.md: 1.2 of
// the bar at 10,007 samples in one accumulator).  A block walks its
// slice in runs of at most kRunSamples = 2,048 samples (768 adds); after
// each run but the last it adds its accumulators, in run order, into a
// float32 sum rounded to nearest on the FP32 cores, held in the block's own
// tile of its output (G, or its slice of the workspace), which no other
// block writes; then it starts the next run from zero.  At the last run the
// sum comes back into the accumulators for the epilogue.  So the slices are
// planned for occupancy only, the workspace does not grow with n, and one
// run (the head's n = 2,048) is the arithmetic of one accumulator.
//
// Epilogue.  With one slice (the head's shape: 36 tile pairs x 64 output
// groups = 2,304 blocks, and 9 x 64 narrow ones) the block writes G directly, its tile and the
// mirrored one through a shared-memory transpose (coalesced both ways); a
// diagonal tile writes its upper triangle and mirrors it.  So G is exactly
// symmetric, with no workspace and no reduce pass.  With more slices (few
// outputs or tiles) it writes partial upper triangles to the workspace and
// rolann_common.cuh's `reduce_kernel` sums them in slice order.  No float
// atomics: repeats are bit-identical.
#pragma once

#include "../../csrc/tf32x3_sm90.cuh"
#include "rolann_common.cuh"

namespace rolann {
namespace sm90 {

constexpr int kTile = 64;                  // rows of a G tile (wgmma M and N)
constexpr int kTail = 8;                   // columns of a narrow last tile (wgmma n8)
constexpr int kOutputs = 4;                // outputs per block
constexpr int kGroups = 2;                 // warpgroups per block
constexpr int kWgOutputs = kOutputs / kGroups;  // outputs per warpgroup
constexpr int kStep = tf32x3::kPanel;      // samples per staged step
constexpr int kThreads = 128 * kGroups;
constexpr int kWarps = kThreads / 32;
constexpr int kLdA = kStep + 4;            // raw xa_i rows: conflict-free fragment reads
constexpr int kRunSamples = 2048;          // most samples one accumulator sums (ops.TC_MAX_SLICE)
constexpr int kRunSteps = kRunSamples / kStep;
static_assert(kRunSamples % kStep == 0, "runs are whole steps");
static_assert(2 * kOutputs == kWarps, "one warp loads each output's fsq, one its fd");
static_assert(kOutputs * kTile == kThreads, "one (row, output) of M a thread");

// The geometry of a block whose column tile is kN rows: kTile for the tile
// pairs ti <= tj, kTail for the pairs (ti, last) when the last tile holds
// at most 8 rows (the head's m = 513 = 8·64 + 1): a 64-row tile there
// would be 1/64 useful and a fifth of the head's work.
template <int kN>
struct Geo {
  static constexpr int kLoadRowsA = kTile / kWarps;  // rows of xa_i each warp loads
  static constexpr int kLoadRowsB = kN / kWarps;     // rows of xa_j each warp loads
  static constexpr int kBTile = kN * kStep;          // floats of one swizzled xa_j tile
  // One stage: xa_j hi and lo (1,024-aligned), xa_i raw, fsq and fd of the group.
  static constexpr int kStageFloats = 2 * kBTile + kTile * kLdA + 2 * kOutputs * kStep;
  static constexpr int kSmemBytes = 2 * kStageFloats * 4 + 1024;  // two stages + alignment
  static constexpr int kLdT = kN + 1;           // the epilogue's transpose tiles
  static_assert(kStageFloats % 256 == 0, "stages must stay 1,024-byte aligned");
  static_assert(kGroups * kTile * kLdT <= 2 * kStageFloats, "epilogue tiles");
  static_assert(kN % kWarps == 0, "rows of xa_j per warp");
};

// Grid: x the tile pair (kN == kTile: the upper triangle of `tiles` tiles;
// kN == kTail: (x, last)), y the group of kOutputs outputs, z the slice.
// Warpgroup w of the block owns outputs o0 + 2w and o0 + 2w + 1.  kRuns:
// slices longer than one run (the run loop is compiled only there, so one
// run, the head's shape, runs the loop without it).
template <int kN, bool kRuns>
__global__ void __launch_bounds__(kThreads, 2)
stats_tf32x3_kernel(const float* __restrict__ xa, const float* __restrict__ fsq,
                    const float* __restrict__ fd, float* __restrict__ g, float* __restrict__ mv,
                    float* __restrict__ ws_g, float* __restrict__ ws_m, int m, long long n,
                    int o, int tiles, long long slice_len) {
  using namespace tf32x3;
  using G = Geo<kN>;
  extern __shared__ uint8_t smem_raw[];
  float* const smem = reinterpret_cast<float*>(align1024(smem_raw));

  int ti, tj;
  if (kN == kTile) {
    tri_index(blockIdx.x, tiles, &ti, &tj);
  } else {
    ti = blockIdx.x;
    tj = (m - 1) / kTile;
  }
  const bool diag = ti == tj;
  const int i0 = ti * kTile, j0 = tj * kTile;
  const int o0 = blockIdx.y * kOutputs;
  const int slice = blockIdx.z;
  const bool direct = gridDim.z == 1;
  const long long k_begin = static_cast<long long>(slice) * slice_len;
  const long long k_end = min(n, k_begin + slice_len);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = tid >> 7, wt = tid & 127, wwarp = wt >> 5;  // warpgroup, its thread, its warp
  const int g8 = lane >> 2, t4 = lane & 3;

  // Loader: lane = sample, warp w = rows w, w + 8, ... of each tile; warp
  // w < kOutputs loads fsq of output o0 + w, the others fd of o0 + w - 4
  // (coalesced 128-byte rows for any n).
  float ra[G::kLoadRowsA], rb[G::kLoadRowsB], rf;
  const int f_out = o0 + warp % kOutputs;
  const float* f_row = (warp < kOutputs ? fsq : fd) + static_cast<long long>(min(f_out, o - 1)) * n;
  const bool f_in = f_out < o;
  auto load = [&](long long k0) {
    const long long k = k0 + lane;
    const bool kin = k < k_end;
#pragma unroll
    for (int u = 0; u < G::kLoadRowsA; ++u) {
      const int r = warp + kWarps * u;
      ra[u] = (kin && i0 + r < m) ? __ldg(xa + static_cast<long long>(i0 + r) * n + k) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < G::kLoadRowsB; ++u) {
      const int r = warp + kWarps * u;
      if (!diag)
        rb[u] = (kin && j0 + r < m) ? __ldg(xa + static_cast<long long>(j0 + r) * n + k) : 0.f;
    }
    rf = (kin && f_in) ? __ldg(f_row + k) : 0.f;
  };
  auto store = [&](float* st) {
    float* b_hi = st;
    float* b_lo = st + G::kBTile;
    float* a = st + 2 * G::kBTile;
    float* sf = a + kTile * kLdA;  // fsq [kOutputs][kStep], then fd
#pragma unroll
    for (int u = 0; u < G::kLoadRowsA; ++u) a[(warp + kWarps * u) * kLdA + lane] = ra[u];
#pragma unroll
    for (int u = 0; u < G::kLoadRowsB; ++u) {
      const int r = warp + kWarps * u;  // on the diagonal xa_j's rows are xa_i's first
      uint32_t hi, lo;
      split(diag ? ra[u] : rb[u], hi, lo);
      const int e = sw128(kN, r, lane);
      b_hi[e] = __uint_as_float(hi);
      b_lo[e] = __uint_as_float(lo);
    }
    sf[warp * kStep + lane] = rf;
    fence_async_smem();
  };

  float acc[kWgOutputs][kN / 2];
#pragma unroll
  for (int q = 0; q < kWgOutputs; ++q)
#pragma unroll
    for (int e = 0; e < kN / 2; ++e) acc[q][e] = 0.f;
  float macc = 0.f;  // M: row tid % 64 of output tid / 64

  // The block's own tile of output q of this warpgroup: G itself with one
  // slice, else this slice's partial in the workspace.
  auto out_g = [&](int q) {
    const long long oq = o0 + kWgOutputs * wg + q;
    return direct ? g + oq * m * m : ws_g + (static_cast<long long>(slice) * o + oq) * m * m;
  };
  // f(accumulator value, its offset in out_g(q)) for each of this thread's
  // accumulator values of output q inside G.  The row and column bases pass
  // through an empty asm so that the compiler forms the offsets here, not
  // as invariants held in registers through the sample loop.
  auto run_tile = [&](int q, auto f) {
    if (o0 + kWgOutputs * wg + q >= o) return;
    int r0 = i0 + 16 * wwarp + g8, c0 = j0 + 2 * t4;
    asm volatile("" : "+r"(r0), "+r"(c0));
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + 8 * (e >> 1), c = c0 + 8 * j + (e & 1);
        if (r < m && c < m) f(acc[q][4 * j + e], static_cast<long long>(r) * m + c);
      }
  };
  // End of a run: add the accumulators into the running sum (the first run
  // stores them) and start the next run from zero.  Each thread reads back
  // only what it wrote.
  auto fold_run = [&](bool first) {
#pragma unroll
    for (int q = 0; q < kWgOutputs; ++q) {
      fence_regs(acc[q]);
      float* const out = out_g(q);
      run_tile(q, [&](float& a, long long e) { out[e] = first ? a : out[e] + a; });
#pragma unroll
      for (int e = 0; e < kN / 2; ++e) acc[q][e] = 0.f;
    }
  };

  const long long steps = (k_end - k_begin + kStep - 1) / kStep;
  load(k_begin);
  store(smem);
  __syncthreads();
  for (long long s = 0; s < steps; ++s) {
    const float* st = smem + (s & 1) * G::kStageFloats;
    const float* a = st + 2 * G::kBTile;
    const float* sf = a + kTile * kLdA + kWgOutputs * wg * kStep;  // this warpgroup's fsq
    const bool more = s + 1 < steps;
    if (more) load(k_begin + (s + 1) * kStep);
#pragma unroll
    for (int kk = 0; kk < kStep / 8; ++kk) {
      float x[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        x[r] = a[(16 * wwarp + g8 + 8 * (r & 1)) * kLdA + 8 * kk + t4 + 4 * (r >> 1)];
      uint32_t hi[kWgOutputs][4], lo[kWgOutputs][4];
#pragma unroll
      for (int q = 0; q < kWgOutputs; ++q) {
        float v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) v[r] = x[r] * sf[q * kStep + 8 * kk + t4 + 4 * (r >> 1)];
        split4(v, hi[q], lo[q]);
      }
      const uint64_t d_hi = desc(st, kN, kk), d_lo = desc(st + G::kBTile, kN, kk);
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < kWgOutputs; ++q) mma3<kN>(acc[q], hi[q], lo[q], d_hi, d_lo);
      wgmma_commit();
      wgmma_wait<0>();
    }
    if (diag) {
      const float* fq = a + kTile * kLdA + (kOutputs + tid / kTile) * kStep;  // fd
      const int r = tid % kTile;
#pragma unroll 8
      for (int c = 0; c < kStep; ++c) macc = fmaf(a[r * kLdA + c], fq[c], macc);
    }
    if (more) store(smem + ((s + 1) & 1) * G::kStageFloats);
    if constexpr (kRuns) {
      if ((s + 1) % kRunSteps == 0 && more) fold_run(s + 1 == kRunSteps);
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kWgOutputs; ++q) fence_regs(acc[q]);
  if constexpr (kRuns) {
    if (steps > kRunSteps) {  // the runs' sum plus the last run
#pragma unroll
      for (int q = 0; q < kWgOutputs; ++q)
        run_tile(q, [&](float& a, long long e) { a = out_g(q)[e] + a; });
    }
  }

  // Epilogue: each output's tile through a transpose in shared memory, the
  // two warpgroups' outputs side by side.
  float* const s_t = smem + wg * kTile * G::kLdT;
#pragma unroll
  for (int q = 0; q < kWgOutputs; ++q) {
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s_t[(16 * wwarp + g8 + 8 * (e >> 1)) * G::kLdT + 8 * j + 2 * t4 + (e & 1)] =
            acc[q][4 * j + e];
    __syncthreads();
    const int oq = o0 + kWgOutputs * wg + q;
    if (oq < o) {
      float* const out = direct ? g + static_cast<long long>(oq) * m * m
                                : ws_g + (static_cast<long long>(slice) * o + oq) * m * m;
      for (int e = wt; e < kTile * kN; e += 128) {
        const int r = e / kN, c = e % kN;  // G[i0 + r][j0 + c], i <= j
        if (i0 + r < m && j0 + c < m && (!diag || r <= c))
          out[static_cast<long long>(i0 + r) * m + j0 + c] = s_t[r * G::kLdT + c];
      }
      if (direct) {
        for (int e = wt; e < kTile * kN; e += 128) {
          const int c = e / kTile, r = e % kTile;  // the mirror G[j0 + c][i0 + r]
          if (i0 + r < m && j0 + c < m && (!diag || r < c))
            out[static_cast<long long>(j0 + c) * m + i0 + r] = s_t[r * G::kLdT + c];
        }
      }
    }
    __syncthreads();
  }
  const int oq = o0 + tid / kTile;
  if (diag && i0 + tid % kTile < m && oq < o) {
    const long long row = static_cast<long long>(oq) * m + i0 + tid % kTile;
    if (direct)
      mv[row] = macc;
    else
      ws_m[static_cast<long long>(slice) * o * m + row] = macc;
  }
}

template <int kN>
inline int launch_tiles(unsigned pairs, int slices, const float* xa, const float* fsq,
                        const float* fd, float* ws_g, float* ws_m, float* g, float* mv, int m,
                        long long n, int o, int tiles, long long slice_len, cudaStream_t st) {
  constexpr int bytes = Geo<kN>::kSmemBytes;
  const long long groups = (o + kOutputs - 1) / kOutputs;
  if (groups > 65535 || slices > 65535) return cudaErrorInvalidValue;
  auto kernel = slice_len > kRunSamples ? stats_tf32x3_kernel<kN, true>
                                        : stats_tf32x3_kernel<kN, false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(pairs, static_cast<unsigned>(groups), slices), kThreads, bytes, st>>>(
      xa, fsq, fd, g, mv, ws_g, ws_m, m, n, o, tiles, slice_len);
  return cudaGetLastError();
}

// (G, M) of one tenant on the tensor cores: `slices` slices of `slice_len`
// samples; one slice writes g and mv directly, more go through ws_g, ws_m
// and reduce_kernel.  A last tile of at most kTail rows is its own launch of
// narrow blocks.  Returns the first launch error (0 = launched).
inline int launch(const float* xa, const float* fsq, const float* fd, float* ws_g, float* ws_m,
                  float* g, float* mv, int m, long long n, int o, int slices,
                  long long slice_len, cudaStream_t st) {
  const int tiles = (m + kTile - 1) / kTile;
  const bool tail = m - (tiles - 1) * kTile <= kTail;
  const int wide = tail ? tiles - 1 : tiles;  // tiles of 64-wide pairs
  int err = launch_tiles<kTile>(wide * (wide + 1) / 2, slices, xa, fsq, fd, ws_g, ws_m, g, mv,
                                m, n, o, wide, slice_len, st);
  if (err == cudaSuccess && tail)
    err = launch_tiles<kTail>(tiles, slices, xa, fsq, fd, ws_g, ws_m, g, mv, m, n, o, tiles,
                              slice_len, st);
  if (err != cudaSuccess || slices == 1) return err;
  return launch_reduce(ws_g, ws_m, g, mv, m, o, slices, false, st);
}

}  // namespace sm90
}  // namespace rolann
