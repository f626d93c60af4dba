// Backward of the RG-LRU linear recurrence on Hopper (sm_90a): a staged
// reverse recurrence that keeps the one-thread version's per-lane order.
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
// with bf16 x (0.140 ms).  The arithmetic, ~80 instructions an element with
// the accurate expf, expm1f and sqrtf, is ~0.1 ms of instruction slots; the
// chain is one dependent FMA a step per lane.  The first version gave each
// lane one thread (8,192 threads at that shape, 128 blocks of 64 for the
// 132 SMs): too few loads in flight, the transcendentals behind the chain
// (0.70–0.80 ms, PERF.md).
//
// Design, as B9's forward.  Only the g chain is sequential, so it
// alone stays one thread per lane and the rest is made parallel over time.
// A block owns kLanes lanes of w of one batch row (32, or 64 when x and the
// gates are all bf16) and walks S backwards in tiles of kRows = 32 steps
// (tile k holds steps [32k, 32k + 32)) with three kinds of work:
//   * eight worker warps per 32 lanes stage dy, y_{t-1}, x, r and i of the
//     next tile in shared memory by 16-byte cp.async (rows that are not
//     whole 16-byte chunks are loaded at compute time instead), form each
//     step's a and u with the expressions above (`expf`, `expm1f`, no fast
//     math), and, two tiles behind, form dx, di, dr and dlog_a·r from g and
//     store them coalesced;
//   * a chain warp per 32 lanes runs g = dy + a_{t+1} g_{t+1} over the
//     tile in reverse step order and writes g over dy.  The product is
//     rounded before the add (`__fmul_rn`, never fused): the one-thread
//     version's a·g also fed dlog_a, so it was never fused either.
// One barrier a tile separates the phases: the workers form tile j while
// the chains walk tile j - 1 and the workers finish tile j - 2, so a staged
// tile lives four iterations (in flight, formed, chained, finished) and a
// and u three.  Each worker thread sums its rows' dlog_a·r; the eight
// threads of a lane are summed in order at the end.  The chain and the
// per-step expressions keep the one-thread version's order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kRows = 32;                  // time steps a tile
constexpr int kSlots = 4;                  // staged tiles: in flight, formed, chained, finished
constexpr int kRing = 3;                   // a and u buffers: formed, chained, finished
constexpr int kRowStep = 8;                // rows between a worker thread's rows
constexpr int kRowsPerWorker = kRows / kRowStep;

// kLanes lanes of w a block owns: kLanes / 32 chain warps, and 8 worker
// warps per 32 lanes, so that each worker thread forms kRowsPerWorker rows
// of a tile at one lane.
template <int kLanes>
struct Warps {
  static constexpr int kChains = kLanes / 32;
  static constexpr int kWorkers = 8 * kChains;
  static constexpr int kThreads = 32 * (kWorkers + kChains);
  static_assert(32 * kWorkers / kLanes == kRowStep, "worker rows");
};

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

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Shared memory: kSlots staged tiles, each dy (then g, float32) and, when
// kAsync, y_{t-1} (float32), x (TX), r and i (TG), kRows x kLanes; then
// the kRing buffers of a and u; then the workers' dlog_a·r sums.  A staged
// row of a tensor is 16-byte chunks (kLanes · bytes / 16); the workers'
// threads take the tile's chunks in turn, kCopies each.
template <typename TX, typename TG, bool kAsync, int kLanes>
struct Smem {
  static constexpr int kWorkers = Warps<kLanes>::kWorkers;
  static constexpr int kTileElems = kRows * kLanes;
  static constexpr int kBytesX = static_cast<int>(sizeof(TX));
  static constexpr int kBytesG = static_cast<int>(sizeof(TG));
  static constexpr int kOffY = kTileElems * 4, kOffX = kOffY + kTileElems * 4;
  static constexpr int kOffR = kOffX + kTileElems * kBytesX, kOffI = kOffR + kTileElems * kBytesG;
  static constexpr int kSlotBytes = kAsync ? kOffI + kTileElems * kBytesG : kTileElems * 4;
  // chunks a row of each staged tensor: dy and y_{t-1} (float32), x, r, i
  static constexpr int kCprF = kLanes * 4 / 16, kCprX = kLanes * kBytesX / 16;
  static constexpr int kCprG = kLanes * kBytesG / 16;
  static constexpr int kChunks = kRows * (2 * kCprF + kCprX + 2 * kCprG);
  __device__ static int cpr(int tensor) {
    return tensor < 2 ? kCprF : tensor == 2 ? kCprX : kCprG;
  }
  static constexpr int kCopies = (kChunks + 32 * kWorkers - 1) / (32 * kWorkers);
  static constexpr int kOffRing = kSlots * kSlotBytes;
  static constexpr int kOffSums = kOffRing + kRing * 2 * kTileElems * 4;
  static constexpr int kBytes = kOffSums + kRowStep * kLanes * 4;
};

template <typename TX, typename TG, bool kAsync, int kLanes>
__global__ void __launch_bounds__(Warps<kLanes>::kThreads, 64 / kLanes)
rglru_bwd_kernel(const TX* __restrict__ x, const TG* __restrict__ r, const TG* __restrict__ gi,
                 const float* __restrict__ lam, const float* __restrict__ y,
                 const float* __restrict__ dy, const float* __restrict__ dh_last,
                 TX* __restrict__ dx, TG* __restrict__ dr, TG* __restrict__ di,
                 float* __restrict__ dlam_part, long long S, int W) {
  using L = Smem<TX, TG, kAsync, kLanes>;
  constexpr int kWorkers = Warps<kLanes>::kWorkers;
  extern __shared__ __align__(16) uint8_t smem[];
  const int w0 = blockIdx.x * kLanes;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lanes = min(kLanes, W - w0);  // valid lanes of this block
  const long long row0 = static_cast<long long>(b) * S;
  const int tiles = static_cast<int>((S + kRows - 1) / kRows);
  const long long tile_stride = static_cast<long long>(kRows) * W;  // elements a tile
  // iteration j works on tile tiles - 1 - j: time backwards
  auto slot = [&](int j) { return smem + (j % kSlots) * L::kSlotBytes; };
  auto ring = [&](int j) {
    return reinterpret_cast<float*>(smem + L::kOffRing) + (j % kRing) * 2 * L::kTileElems;
  };
  auto steps = [&](int j) {  // valid steps of iteration j's tile
    return static_cast<int>(min(static_cast<long long>(kRows), S - (tiles - 1 - j) * kRows));
  };

  if (warp >= kWorkers) {
    // ---- a chain warp: lanes 32c .. 32c + 31 ----
    const int col = 32 * (warp - kWorkers) + lane;
    float carry = (dh_last != nullptr && col < lanes)
        ? dh_last[static_cast<long long>(b) * W + w0 + col] : 0.f;  // a_{t+1} g_{t+1}
    for (int j = 0; j <= tiles + 1; ++j) {
      __syncthreads();  // barrier j: tile j is formed, tile j - 1's finish reads nothing of ours
      if (j == 0 || j > tiles) continue;
      const float* const a = ring(j - 1);
      float* const g = reinterpret_cast<float*>(slot(j - 1));  // dy, then g
      const int valid = steps(j - 1);
      // g = dy + carry; carry = a·g from the tile's last step down, eight
      // steps' a and dy loaded ahead; a full tile without the bound check
      auto walk = [&](auto full) {
        for (int t8 = valid; t8 > 0; t8 -= 8) {
          float av[8], dv[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int row = max(t8 - 1 - u, 0);
            av[u] = a[row * kLanes + col];
            dv[u] = g[row * kLanes + col];
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (decltype(full)::value || t8 - 1 - u >= 0) {
              const float gv = dv[u] + carry;
              g[(t8 - 1 - u) * kLanes + col] = gv;
              carry = __fmul_rn(av[u], gv);  // rounded, as the one-thread version's
            }
          }
        }
      };
      if (valid == kRows)
        walk(std::true_type{});
      else
        walk(std::false_type{});
    }
    __syncthreads();  // the workers' sums are written
    return;
  }

  // ---- the worker warps ----
  // This thread's lane `col` and rows first_row + 8u of every tile, as
  // offsets from tile 0; and, staging, its chunks' sources and places.
  const int col = tid % kLanes, first_row = tid / kLanes;
  const bool col_ok = col < lanes;
  const float neg = col_ok ? -lam[w0 + col] : 0.f;
  const float sp = fmaxf(neg, 0.f) + log1pf(expf(-fabsf(neg)));  // as B9 forms it
  const long long at0 = (row0 + first_row) * W + w0 + col;
  const uint8_t* src[L::kCopies];
  long long step[L::kCopies];  // bytes from a tile's chunk to the next tile's
  int dst[L::kCopies], row_of[L::kCopies];
  bool lane_ok[L::kCopies], shifted[L::kCopies];
#pragma unroll
  for (int c = 0; c < L::kCopies; ++c) {
    const int e = min(tid + 32 * kWorkers * c, L::kChunks - 1);
    int tensor = 0, rem = e;
    while (rem >= kRows * L::cpr(tensor)) {
      rem -= kRows * L::cpr(tensor);
      ++tensor;
    }
    const int bytes = tensor < 2 ? 4 : tensor == 2 ? L::kBytesX : L::kBytesG;
    const int row = rem / L::cpr(tensor), first = rem % L::cpr(tensor) * (16 / bytes);
    row_of[c] = tid + 32 * kWorkers * c < L::kChunks ? row : kRows;  // kRows: no chunk
    lane_ok[c] = first < lanes;  // 16-byte rows: a chunk is all in or all out
    shifted[c] = tensor == 1;    // y_{t-1}: the row before
    const uint8_t* const base = tensor == 0   ? reinterpret_cast<const uint8_t*>(dy)
                                : tensor == 1 ? reinterpret_cast<const uint8_t*>(y)
                                : tensor == 2 ? reinterpret_cast<const uint8_t*>(x)
                                : tensor == 3 ? reinterpret_cast<const uint8_t*>(r)
                                              : reinterpret_cast<const uint8_t*>(gi);
    // (tile 0's first row of y_{t-1} is the row before the batch row's
    // first: never read, see `prefetch`)
    src[c] = base + ((row0 + row - (shifted[c] ? 1 : 0)) * W + w0 + (lane_ok[c] ? first : 0)) *
                        bytes;
    step[c] = lane_ok[c] ? tile_stride * bytes : 0;
    const int off = tensor == 0 ? 0 : tensor == 1 ? L::kOffY : tensor == 2 ? L::kOffX
                  : tensor == 3 ? L::kOffR : L::kOffI;
    dst[c] = off + (row * kLanes + first) * bytes;
  }

  // Copy tile k's rows of dy, y_{t-1}, x, r and i into iteration j's slot,
  // 16 bytes a copy; y_{-1} is zero.
  auto prefetch = [&](int j) {
    const int k = tiles - 1 - j;
    uint8_t* const st = slot(j);
#pragma unroll
    for (int c = 0; c < L::kCopies; ++c) {
      if (row_of[c] < kRows && static_cast<long long>(k) * kRows + row_of[c] < S) {
        const bool before = shifted[c] && k == 0 && row_of[c] == 0;  // y_{-1}: zeros
        cp_async16(st + dst[c], before ? static_cast<const void*>(dy) : src[c] + k * step[c],
                   lane_ok[c] && !before);
      }
    }
  };

  // a_t and u_t of iteration j's steps into its ring buffer (and, loading
  // in place, dy into its slot).  Every row is formed, past S too (from
  // stale or zero inputs; the chain stops at S).
  auto form = [&](int j) {
    const int k = tiles - 1 - j;
    float* const av = ring(j);
    float* const uv = av + L::kTileElems;
    uint8_t* const st = slot(j);
    const TG* const sr = reinterpret_cast<const TG*>(st + L::kOffR);
#pragma unroll
    for (int u = 0; u < kRowsPerWorker; ++u) {
      const int row = first_row + kRowStep * u;
      float rv = 0.f;
      if (kAsync) {
        rv = widen(sr[row * kLanes + col]);
      } else {
        const bool ok = col_ok && static_cast<long long>(k) * kRows + row < S;
        const long long idx = at0 + k * tile_stride + static_cast<long long>(kRowStep * u) * W;
        rv = ok ? widen(r[idx]) : 0.f;
        reinterpret_cast<float*>(st)[row * kLanes + col] = ok ? dy[idx] : 0.f;
      }
      const float log_a = -8.f * rv * sp;
      av[row * kLanes + col] = expf(log_a);
      uv[row * kLanes + col] = -expm1f(2.f * log_a);
    }
  };

  // dx, di, dr of iteration j's steps from g (in its slot), coalesced; the
  // rows' dlog_a·r into acc.
  float acc = 0.f;
  auto finish = [&](int j) {
    const int k = tiles - 1 - j;
    const float* const av = ring(j);
    const float* const uv = av + L::kTileElems;
    const uint8_t* const st = slot(j);
    const float* const gs = reinterpret_cast<const float*>(st);
#pragma unroll
    for (int u = 0; u < kRowsPerWorker; ++u) {
      const int row = first_row + kRowStep * u;
      const long long t = static_cast<long long>(k) * kRows + row;
      if (!col_ok || t >= S) continue;
      const long long idx = at0 + k * tile_stride + static_cast<long long>(kRowStep * u) * W;
      const int s_at = row * kLanes + col;
      float xv, rv, iv, hp;
      if (kAsync) {
        xv = widen(reinterpret_cast<const TX*>(st + L::kOffX)[s_at]);
        rv = widen(reinterpret_cast<const TG*>(st + L::kOffR)[s_at]);
        iv = widen(reinterpret_cast<const TG*>(st + L::kOffI)[s_at]);
        hp = reinterpret_cast<const float*>(st + L::kOffY)[s_at];
      } else {
        xv = widen(x[idx]);
        rv = widen(r[idx]);
        iv = widen(gi[idx]);
        hp = t > 0 ? y[idx - W] : 0.f;
      }
      const float a = av[s_at];
      const float um = uv[s_at];
      const float m = sqrtf(fmaxf(um, 1e-12f));
      const float g = gs[s_at];
      const float gm = g * m;
      const float dlog_a = a * g * hp - (um > 1e-12f ? a * a / m : 0.f) * (g * iv * xv);
      dx[idx] = narrow<TX>(gm * iv);
      di[idx] = narrow<TG>(gm * xv);
      dr[idx] = narrow<TG>(dlog_a * (-8.f * sp));
      acc += dlog_a * rv;
    }
  };

  if (kAsync) {
    prefetch(0);
    cp_async_commit();
    cp_async_wait_all();
  }
  // Iteration j, after barrier j (which also makes every worker's copies of
  // tile j visible): form tile j, start the copy of tile j + 1 into the slot
  // tile j - 3 used, finish tile j - 2; the chain walks tile j - 1
  // meanwhile.  Workers and chain both pass tiles + 2 barriers, then one.
  for (int j = 0; j <= tiles + 1; ++j) {
    __syncthreads();
    if (kAsync && j + 1 < tiles) {
      prefetch(j + 1);
      cp_async_commit();
    }
    if (j < tiles) form(j);
    if (j >= 2) finish(j - 2);
    if (kAsync) cp_async_wait_all();  // tile j + 1 has landed
  }
  float* const sums = reinterpret_cast<float*>(smem + L::kOffSums);
  sums[first_row * kLanes + col] = acc;
  __syncthreads();
  if (first_row == 0 && col_ok) {
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < kRowStep; ++u) s += sums[u * kLanes + col];
    dlam_part[static_cast<long long>(b) * W + w0 + col] = s;
  }
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

// Lanes a block owns: all-bf16 rows of 64 lanes are 128 bytes, as float32
// rows of 32 are.
template <typename TX, typename TG>
constexpr int kLanesFor = sizeof(TX) == 2 && sizeof(TG) == 2 ? 64 : 32;

template <typename TX, typename TG, bool kAsync>
int launch(const void* x, const void* r, const void* i, const float* lam, const float* y,
           const float* dy, const float* dh_last, void* dx, void* dr, void* di,
           float* dlam_part, float* dlam, int B, long long S, int W, cudaStream_t st) {
  constexpr int kLanes = kLanesFor<TX, TG>;
  constexpr int bytes = Smem<TX, TG, kAsync, kLanes>::kBytes;
  auto kernel = rglru_bwd_kernel<TX, TG, kAsync, kLanes>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kLanes - 1) / kLanes, B);
  kernel<<<grid, Warps<kLanes>::kThreads, bytes, st>>>(
      static_cast<const TX*>(x), static_cast<const TG*>(r), static_cast<const TG*>(i), lam, y,
      dy, dh_last, static_cast<TX*>(dx), static_cast<TG*>(dr), static_cast<TG*>(di), dlam_part,
      S, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dlam_kernel<<<(W + 255) / 256, 256, 0, st>>>(dlam_part, lam, dlam, B, W);
  return cudaGetLastError();
}

// Staged when every row of the five inputs is whole 16-byte chunks and they
// start on 16 bytes; else the workers load them.
template <typename TX, typename TG>
int launch_for(const void* x, const void* r, const void* i, const float* lam, const float* y,
               const float* dy, const float* dh_last, void* dx, void* dr, void* di,
               float* dlam_part, float* dlam, int B, long long S, int W, cudaStream_t st) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool staged = W * sizeof(TX) % 16 == 0 && W * sizeof(TG) % 16 == 0 && W % 4 == 0 &&
                      aligned(x) && aligned(r) && aligned(i) && aligned(y) && aligned(dy);
  return staged
      ? launch<TX, TG, true>(x, r, i, lam, y, dy, dh_last, dx, dr, di, dlam_part, dlam, B, S, W, st)
      : launch<TX, TG, false>(x, r, i, lam, y, dy, dh_last, dx, dr, di, dlam_part, dlam, B, S, W,
                              st);
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
        ? launch_for<bf16, bf16>(x, r, i, lam, y, dy, dh_last, dx, dr, di, dlam_part, dlam, B, S,
                                 W, st)
        : launch_for<bf16, float>(x, r, i, lam, y, dy, dh_last, dx, dr, di, dlam_part, dlam, B,
                                  S, W, st);
  return gates_bf16
      ? launch_for<float, bf16>(x, r, i, lam, y, dy, dh_last, dx, dr, di, dlam_part, dlam, B, S,
                                W, st)
      : launch_for<float, float>(x, r, i, lam, y, dy, dh_last, dx, dr, di, dlam_part, dlam, B,
                                 S, W, st);
}
