// Fused ROLANN chunk fold on Hopper (sm_90a), plain FP32 CUDA cores.
//
// Replaces the Pallas TPU kernels `rolann_fused_chunk_kernel` (B3) of
// src/repro/kernels/rolann_stats/kernel.py (bodies `_kernel_fused_chunk` and
// `_fused_chunk_deltas`) and its tenant-batched twin
// `rolann_fused_chunk_kernel_batched` (B6, body `_kernel_fused_chunk_batched`).
// One streamed chunk of an ELM-AE decoder layer:
//
//     xa    = [act(wᵀ h + b); 1]                       [ma, n], ma = m_c1 + 1
//     d̄     = inv(clip(h[o])),  f' = deriv(d̄)          per output o < m_l
//     fsq   = f'² · mask,  fd = f'² · d̄ · mask
//     G[o] += xa · diag(fsq) · xaᵀ,  M[o] += xa · fd    (g [m_l, ma, ma], mv [m_l, ma])
//
// with h [m_l, n], w [m_l, m_c1], b [m_c1], mask [n], all float32 and
// row-major, summed in float32.  B6 does this for k tenants in one launch,
// each with its own chunk, stage-1 encoder and mask: h [k, m_l, n],
// w [k, m_l, m_c1], b [k, m_c1], mask [k, n], g [k, m_l, ma, ma],
// mv [k, m_l, ma].  The targets are h itself (the auxiliary
// autoencoder reconstructs its input), so o == m_l.  The activation and the
// target transform never reach device memory.  The activation's device
// functions (rolann_fused_slice.cuh) are written as
// repro_torch/core/activations.py writes them (logsig as 1/(1+exp(-z)), the
// logit as log(y) - log1p(-y)), without fast math.
//
// Two kernels, chosen by shape in `launch()` (a rule between two
// hand-written kernels, not a fallback): B3 and B6 with ma <= 28 and
// m_l <= 32 (every hidden layer of the streamed creditcard fit and of the
// chunked fleet fit) run rolann_fused_slice.cuh's block per sample slice
// (per tenant and slice for B6), which forms the slice's activations once
// for all outputs; wider layers run `fused_partial_kernel` below.
//
// What bounds it.  The work is that of B1 (o·m(m+1)/2·n FMAs for G's upper
// triangle) plus one stage-1 product per sample, m_l·m_c1·n FMAs, against
// (m_l + 1)·n·4 bytes read: bound by FP32 compute on the DAEF path.
// `fused_partial_kernel` recomputes the stage-1 product for every output, as
// the Pallas kernel does (its comment at kernel.py:271-284): on the
// creditcard shapes that is 1.6 to 2.6 times the FMAs of G.
//
// Design of `fused_partial_kernel`.  B1's grid of (output o,
// upper-triangle tile of G, sample slice), its 4x4 pieces, fixed-order
// group sums and slice reduction
// (rolann_common.cuh), with a loader that computes the staged rows of xa
// instead of reading them.  Per 64-sample chunk a block:
//   1. stages the chunk of h, all m_l rows, in shared memory, and forms
//      output o's fsq and fd from row o of h and the mask (the reference's
//      order: clip, inv, deriv, fsq, fd, then the mask);
//   2. forms its tile's 32 rows (and, off the diagonal, 32 columns) of xa:
//      lane r owns row r and 8 samples, reads w's column once per input row
//      and the 8 samples of h as two broadcast float4 loads, so 8 (or 16)
//      FMAs cost 3 shared loads; the bias row is ones, rows beyond ma zeros;
//   3. folds the chunk into its pieces exactly as B1 does.
// w's tile columns are staged once per block.  Samples beyond the slice get
// fsq = fd = 0.  Shared memory is dynamic, (4736 + 128·m_l) floats or B1's
// partials' size if larger, so any m_l up to 417 fits in one block.
//
// The tenant axis, as in rolann_stats.cu: B3 is the k = 1 case of the same
// template.  Grid axis x runs over the k·m_l (tenant, output) pairs,
// blockIdx.x = t·m_l + o, so the workspace and the accumulators are
// contiguous [k·m_l, ...] arrays; h, w, b and the mask take tenant t's
// offset.  (The fleet path, k = 64 and chunks of 1,024, ran here before
// the slice route took it: 960–1,536 blocks, one slice per launch.)
// Registers bound both: the
// offsets, kept live through the sample loop, took the kernel from 57–64 to
// 80 registers a thread, 3 blocks of 256 threads per SM instead of 4, and
// made B3 4 % slower on the card.  So the offsets are compiled in only for
// B6 (kBatched), and the kernel is held to 4 blocks per SM (64 registers, a
// few bytes spilled): B6 ran 4 % faster than at 80 registers and B3 no
// slower than before the tenant axis.  (Profiler kernel times from
// chip_smoke.py; a bound of 1 block per SM let the compiler take 113
// registers and made B3 25 % slower.)
//
// No float atomics: the result is the same from run to run, and the running
// G stays exactly symmetric.

#include "rolann_common.cuh"
#include "rolann_fused_slice.cuh"

namespace {

using namespace rolann;

constexpr int kSamplesPerLane = kChunk / (kThreads / 32);   // 8
// Blocks of kThreads each SM must hold at once: at most 64 registers a
// thread (see "The tenant axis" above).
constexpr int kMinBlocksPerSm = 4;

template <int kGroupWarps, int A, bool kBatched>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
fused_partial_kernel(const float* __restrict__ h, const float* __restrict__ w,
                     const float* __restrict__ b, const float* __restrict__ mask,
                     float* __restrict__ ws_g, float* __restrict__ ws_m, int m_l, int m_c1,
                     long long n, int tiles, long long slice_len) {
  extern __shared__ __align__(16) float smem[];
  float* s_xs = smem;                        // [kChunk][kLd] rows of ti * fsq[o]
  float* s_x = s_xs + kChunk * kLd;          // [kChunk][kLd] rows of tj
  float* s_fd = s_x + kChunk * kLd;          // [kChunk]
  float* s_fsq = s_fd + kChunk;              // [kChunk]
  float* s_h = s_fsq + kChunk;               // [m_l][kChunk] the chunk of h
  float* s_wi = s_h + m_l * kChunk;          // [m_l][kTile] w's columns i0..
  float* s_wj = s_wi + m_l * kTile;          // [m_l][kTile] w's columns j0..

  const int m = m_c1 + 1;
  const int pair = blockIdx.x;               // t·m_l + oi
  const int oi = kBatched ? pair % m_l : pair;
  if (kBatched) {                            // tenant t's chunk, encoder and mask
    const long long t = pair / m_l;
    h += t * m_l * n;
    w += t * m_l * m_c1;
    b += t * m_c1;
    mask += t * n;
  }
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

  for (int e = tid; e < m_l * kTile; e += kThreads) {
    const int l = e / kTile;
    const int i = i0 + e % kTile;
    const int j = j0 + e % kTile;
    s_wi[e] = i < m_c1 ? __ldg(w + (long long)l * m_c1 + i) : 0.f;
    s_wj[e] = j < m_c1 ? __ldg(w + (long long)l * m_c1 + j) : 0.f;
  }
  // The xa rows this lane forms: row i0 + lane (and j0 + lane), samples
  // c0 .. c0 + 7 of each chunk.
  const int ri = i0 + lane;
  const int rj = j0 + lane;
  const float bi = ri < m_c1 ? __ldg(b + ri) : 0.f;
  const float bj = rj < m_c1 ? __ldg(b + rj) : 0.f;
  const int c0 = warp * kSamplesPerLane;
  const float* h_o = h + (long long)oi * n;

  for (long long k0 = k_begin; k0 < k_end; k0 += kChunk) {
    // 1. the chunk of h, and output o's targets
    for (int e = tid; e < m_l * kChunk; e += kThreads) {
      const int l = e / kChunk;
      const long long k = k0 + e % kChunk;
      s_h[e] = k < k_end ? __ldg(h + (long long)l * n + k) : 0.f;
    }
    if (tid < kChunk) {
      const long long k = k0 + tid;
      float fsq = 0.f;
      float fd = 0.f;
      if (k < k_end) {
        const float dbar = act_inv<A>(act_clip<A>(__ldg(h_o + k)));
        const float fp = act_deriv<A>(dbar);
        fsq = fp * fp;
        fd = fsq * dbar;
        const float mk = __ldg(mask + k);
        fsq = fsq * mk;
        fd = fd * mk;
      }
      s_fsq[tid] = fsq;
      s_fd[tid] = fd;
    }
    __syncthreads();

    // 2. this tile's rows (and columns) of xa for the chunk
    float zi[kSamplesPerLane];
    float zj[kSamplesPerLane];
#pragma unroll
    for (int s = 0; s < kSamplesPerLane; ++s) zi[s] = zj[s] = 0.f;
    for (int l = 0; l < m_l; ++l) {
      const float4 h0 = *reinterpret_cast<const float4*>(s_h + l * kChunk + c0);
      const float4 h1 = *reinterpret_cast<const float4*>(s_h + l * kChunk + c0 + 4);
      const float hv[kSamplesPerLane] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
      const float wi = s_wi[l * kTile + lane];
#pragma unroll
      for (int s = 0; s < kSamplesPerLane; ++s) zi[s] = fmaf(wi, hv[s], zi[s]);
      if (!diag) {
        const float wj = s_wj[l * kTile + lane];
#pragma unroll
        for (int s = 0; s < kSamplesPerLane; ++s) zj[s] = fmaf(wj, hv[s], zj[s]);
      }
    }
#pragma unroll
    for (int s = 0; s < kSamplesPerLane; ++s) {
      const int c = c0 + s;
      const float ai = ri < m_c1 ? act_fn<A>(zi[s] + bi) : (ri == m_c1 ? 1.f : 0.f);
      s_xs[c * kLd + lane] = ai * s_fsq[c];
      if (diag) {
        s_x[c * kLd + lane] = ai;
      } else {
        s_x[c * kLd + lane] = rj < m_c1 ? act_fn<A>(zj[s] + bj) : (rj == m_c1 ? 1.f : 0.f);
      }
    }
    __syncthreads();

    // 3. the fold, as B1
    fold_chunk(p, s_xs, s_x, s_fd);
    __syncthreads();
  }
  __syncthreads();  // the staging buffers become the partials' buffers
  write_partials(p, smem, ws_g, ws_m, slice, gridDim.x, pair, m, i0, j0, diag);
}

template <int kGroupWarps, int A, bool kBatched>
int launch_partial(dim3 grid, size_t smem_bytes, cudaStream_t st, const float* h,
                   const float* w, const float* b, const float* mask, float* ws_g,
                   float* ws_m, int m_l, int m_c1, long long n, int tiles,
                   long long slice_len) {
  auto kernel = fused_partial_kernel<kGroupWarps, A, kBatched>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem_bytes, st>>>(h, w, b, mask, ws_g, ws_m, m_l, m_c1, n, tiles,
                                             slice_len);
  return static_cast<int>(cudaGetLastError());
}

// The partial kernel for the tile layout of ma and the activation.
template <bool kBatched>
int launch_partial_for(int ma, int act, dim3 grid, size_t smem, cudaStream_t st,
                       const float* h, const float* w, const float* b, const float* mask,
                       float* ws_g, float* ws_m, int m_l, int m_c1, long long n, int tiles,
                       long long slice_len) {
  auto run = [&](auto fn) {
    return fn(grid, smem, st, h, w, b, mask, ws_g, ws_m, m_l, m_c1, n, tiles, slice_len);
  };
  if (ma <= kSmallM) {
    return act == kLogsig ? run(launch_partial<1, kLogsig, kBatched>)
                          : run(launch_partial<1, kTanh, kBatched>);
  }
  return act == kLogsig ? run(launch_partial<2, kLogsig, kBatched>)
                        : run(launch_partial<2, kTanh, kBatched>);
}

// Floats of dynamic shared memory the partial kernel takes for m_l and ma.
// Above the 227 KB a block may have (m_l > 417), cudaFuncSetAttribute
// refuses and the launch returns its error.
long long smem_floats(int m_l, int ma) {
  const long long stage = 2LL * kChunk * kLd + 2 * kChunk + (long long)m_l * (kChunk + 2 * kTile);
  const long long red = ma <= kSmallM ? Layout<1>::kRedFloats : Layout<2>::kRedFloats;
  return stage > red ? stage : red;
}

int launch(const float* h, const float* w, const float* b, const float* mask, float* ws_g,
           float* ws_m, float* g, float* mv, int k, bool batched, int m_l, int m_c1,
           long long n, int act, int slices, long long slice_len, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (slice::takes(k, m_l, m_c1)) {
    return act == kLogsig ? slice::launch<kLogsig>(h, w, b, mask, ws_g, ws_m, g, mv, k, batched,
                                                   m_l, m_c1, n, slices, slice_len, st)
                          : slice::launch<kTanh>(h, w, b, mask, ws_g, ws_m, g, mv, k, batched,
                                                 m_l, m_c1, n, slices, slice_len, st);
  }
  const int ma = m_c1 + 1;
  const int tiles = (ma + kTile - 1) / kTile;
  const dim3 grid(k * m_l, tiles * (tiles + 1) / 2, slices);
  const size_t smem = sizeof(float) * smem_floats(m_l, ma);
  const int err =
      k > 1 ? launch_partial_for<true>(ma, act, grid, smem, st, h, w, b, mask, ws_g, ws_m, m_l,
                                       m_c1, n, tiles, slice_len)
            : launch_partial_for<false>(ma, act, grid, smem, st, h, w, b, mask, ws_g, ws_m, m_l,
                                        m_c1, n, tiles, slice_len);
  if (err != 0) return err;
  return launch_reduce(ws_g, ws_m, g, mv, ma, k * m_l, slices, true, st);
}

}  // namespace

// B3: fold one chunk into the running g [m_l, ma, ma] and mv [m_l, ma]
// (ma = m_c1 + 1), act 0 = logsig, 1 = tanh.  Launches both kernels on
// `stream` (with ma <= 28 and m_l <= 32 those of rolann_fused_slice.cuh);
// returns cudaGetLastError() (0 = launched).  ws_g [slices, m_l, ma, ma]
// and ws_m [slices, m_l, ma] are scratch from the caller, slices planned
// for the route (ops.plan_fused); slices * slice_len must cover n and every
// slice must start below n.
extern "C" int rolann_fused_chunk_f32(const float* h, const float* w, const float* b,
                                      const float* mask, float* ws_g, float* ws_m, float* g,
                                      float* mv, int m_l, int m_c1, long long n, int act,
                                      int slices, long long slice_len, void* stream) {
  return launch(h, w, b, mask, ws_g, ws_m, g, mv, 1, false, m_l, m_c1, n, act, slices,
                slice_len, stream);
}

// B6: B3 for k tenants in one launch: h [k, m_l, n], w [k, m_l, m_c1],
// b [k, m_c1], mask [k, n] folded into g [k, m_l, ma, ma], mv [k, m_l, ma].
// ws_g and ws_m are scratch for `slices` partials of the k·m_l (tenant,
// output) pairs: with ma <= 28 and m_l <= 32, [slices, k·m_l, ma (ma + 1) / 2]
// and [slices, k·m_l, ma], slices a tenant (ops.plan_batched_slices), the
// rest [slices, k·m_l, ma, ma] and [slices, k·m_l, ma], slices planned for
// the pairs (ops.plan_slices).
extern "C" int rolann_fused_chunk_batched_f32(const float* h, const float* w, const float* b,
                                              const float* mask, float* ws_g, float* ws_m,
                                              float* g, float* mv, int k, int m_l, int m_c1,
                                              long long n, int act, int slices,
                                              long long slice_len, void* stream) {
  return launch(h, w, b, mask, ws_g, ws_m, g, mv, k, true, m_l, m_c1, n, act, slices,
                slice_len, stream);
}
