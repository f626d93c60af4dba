// RG-LRU linear recurrence on Hopper (sm_90a): a staged recurrence that
// keeps the exact per-lane order of operations.
//
// Replaces the Pallas TPU kernel `rglru_scan_kernel` (body `_kernel`) of
// src/repro/kernels/rglru_scan/kernel.py (B9).  For every batch b and lane w
// of the width, over t = 0 .. S-1 from h = 0:
//
//     sp    = logaddexp(0, -lam[w])                 (softplus(-lam))
//     log_a = -8 · r_t · sp,   a_t = exp(log_a)
//     b_t   = sqrt(max(-expm1(2 · log_a), 1e-12)) · (i_t · x_t)
//     h     = a_t · h + b_t,   y_t = h
//
// in the reference's operation order, float32 arithmetic.  x, r and i are
// [B, S, W] contiguous; x float32 or bf16, the gates r and i both float32
// or both bf16 (the hybrid backbone's bf16 prefill gives bf16 x and float32
// gates, whose bias is float32).  Each value is widened to float32 exactly,
// so the function is that of the float32 inputs the reference casts to.
// lam [W] float32; y [B, S, W] and h_last [B, W] float32.
//
// What bounds it.  Bytes: x, r and i read once and y written once, 16
// bytes an element in float32 (537 MB at the hybrid's B = 2, S = 4,096,
// W = 4,096: 0.160 ms at the card's memory rate), 12 with bf16 x (470 MB,
// 0.140 ms), 10 all bf16 (336 MB, 0.100 ms).  The arithmetic, about 60
// instructions an element with the accurate expf, expm1f and sqrtf, is
// ~0.07 ms of instruction slots; the recurrence itself is one dependent FMA a step per
// lane, 4,096 of them, ~10 µs.  The first port gave each (b, w) lane one
// thread that loaded, computed and chained its own steps: 8,192 threads,
// about one block of two warps an SM, too few loads in flight and the
// transcendentals serialised behind the chain (0.86 ms, PERF.md).
//
// Design.  Only the h chain is sequential, so it alone stays one thread
// per lane and the rest is made parallel over time.  A block owns kLanes
// lanes of w of one batch row (32, or 64 when x and the gates are all
// bf16, so that a staged row is 128 bytes) and walks S in tiles of
// kRows = 32 steps with three kinds of work:
//   * eight worker warps per 32 lanes stage x, r and i of the tiles two
//     ahead in shared memory by 16-byte cp.async (rows of W elements that
//     are not whole 16-byte chunks, W = 77 or a bf16 W = 100, are loaded by
//     the workers at compute time instead), compute each step's a_t and b_t
//     with the expressions above (`expf`, `expm1f`, `log1pf`, `sqrtf`, no
//     fast math: the bits of the one-thread kernel) into shared memory, and
//     store y coalesced from shared memory two tiles behind;
//   * a chain warp per 32 lanes runs h = fmaf(a, h, b) over each tile in t
//     order and writes h over b; it writes h_last at the end.
// One barrier a tile separates the phases, each on its own buffer of a
// three-buffer ring: the workers form tile k while the chains walk tile
// k - 1 and the workers store tile k - 2.  The chain is the same FMA in the
// same order as before, so y and h_last are bit-identical to it, and bf16
// inputs give the bits of their float32 widening.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kRows = 32;                  // time steps a tile
constexpr int kStages = 3;                 // staged tiles: kStages - 1 in flight
constexpr int kRowStep = 8;                // rows between a worker thread's rows
constexpr int kRowsPerWorker = kRows / kRowStep;
constexpr int kRing = 3;                   // a/b(h) buffers: form, chain, store

// kLanes lanes of w a block owns: kLanes / 32 chain warps, and 8 worker
// warps per 32 lanes, so that each worker thread forms kRowsPerWorker
// rows of a tile at one lane.
template <int kLanes>
struct Warps {
  static constexpr int kChains = kLanes / 32;
  static constexpr int kWorkers = 8 * kChains;
  static constexpr int kThreads = 32 * (kWorkers + kChains);
  static_assert(32 * kWorkers / kLanes == kRowStep, "worker rows");
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory: the ring of staged x, r, i tiles (kAsync only), then the
// kRing buffers of a (kRows x kLanes) and b, overwritten by h.  x is of
// type TX, the gates r and i of TG.  A staged row of x is kChunksX 16-byte
// chunks, one of a gate kChunksG; the workers' threads take the tile's
// kRows · (kChunksX + 2 kChunksG) chunks in turn, kCopies each.
template <typename TX, typename TG, bool kAsync, int kLanes>
struct Smem {
  static constexpr int kWorkers = Warps<kLanes>::kWorkers;
  static constexpr int kTileElems = kRows * kLanes;
  static constexpr int kBytesX = static_cast<int>(sizeof(TX)), kBytesG = static_cast<int>(sizeof(TG));
  static constexpr int kChunksX = kLanes * kBytesX / 16, kChunksG = kLanes * kBytesG / 16;
  static constexpr int kChunks = kRows * (kChunksX + 2 * kChunksG);
  static constexpr int kCopies = (kChunks + 32 * kWorkers - 1) / (32 * kWorkers);
  static constexpr int kOffR = kTileElems * kBytesX, kOffI = kOffR + kTileElems * kBytesG;
  static constexpr int kStageBytes = kAsync ? kOffI + kTileElems * kBytesG : 0;
  static constexpr int kBytes = kStages * kStageBytes + kRing * 2 * kTileElems * 4;
};

template <typename TX, typename TG, bool kAsync, int kLanes>
__global__ void __launch_bounds__(Warps<kLanes>::kThreads, 64 / kLanes)
rglru_scan_kernel(const TX* __restrict__ x, const TG* __restrict__ r, const TG* __restrict__ gi,
                  const float* __restrict__ lam, float* __restrict__ y,
                  float* __restrict__ h_last, long long S, int W) {
  using L = Smem<TX, TG, kAsync, kLanes>;
  constexpr int kWorkers = Warps<kLanes>::kWorkers;
  extern __shared__ __align__(16) uint8_t smem[];
  float* const ring = reinterpret_cast<float*>(smem + kStages * L::kStageBytes);
  const int w0 = blockIdx.x * kLanes;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lanes = min(kLanes, W - w0);  // valid lanes of this block
  const long long row0 = static_cast<long long>(b) * S;
  const int tiles = static_cast<int>((S + kRows - 1) / kRows);
  const long long tile_stride = static_cast<long long>(kRows) * W;  // elements a tile
  auto a_buf = [&](int k) { return ring + (k % kRing) * 2 * L::kTileElems; };

  if (warp >= kWorkers) {
    // ---- a chain warp: lanes 32c .. 32c + 31 ----
    const int col = 32 * (warp - kWorkers) + lane;
    float h = 0.f;
    __syncthreads();  // barrier 0: the workers form tile 0
    for (int k = 0; k < tiles; ++k) {
      __syncthreads();  // barrier k + 1: tile k's a and b are formed
      float* const ab = a_buf(k);
      float* const bh = ab + L::kTileElems;
      const int valid = static_cast<int>(min(static_cast<long long>(kRows), S - k * kRows));
      // h = a·h + b in t order, eight steps' a and b loaded ahead; a full
      // tile without the per-step bound check
      auto walk = [&](auto full) {
        for (int t8 = 0; t8 < valid; t8 += 8) {
          float a[8], bb[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            a[u] = ab[(t8 + u) * kLanes + col];
            bb[u] = bh[(t8 + u) * kLanes + col];
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (decltype(full)::value || t8 + u < valid) {
              h = fmaf(a[u], h, bb[u]);
              bh[(t8 + u) * kLanes + col] = h;
            }
          }
        }
      };
      if (valid == kRows)
        walk(std::true_type{});
      else
        walk(std::false_type{});
    }
    __syncthreads();  // barrier tiles + 1: the workers store the last tile
    if (col < lanes) h_last[static_cast<long long>(b) * W + w0 + col] = h;
    return;
  }

  // ---- the worker warps ----
  // This thread's lane `col` and rows first_row + 8u of every tile, as
  // offsets from tile 0; and, staging, its chunks' sources and places.
  const int col = tid % kLanes, first_row = tid / kLanes;
  const float neg = col < lanes ? -lam[w0 + col] : 0.f;
  const float sp = fmaxf(neg, 0.f) + log1pf(expf(-fabsf(neg)));
  const long long at0 = (row0 + first_row) * W + w0 + col;
  const uint8_t* src[L::kCopies];
  long long step[L::kCopies];  // bytes from a tile's chunk to the next tile's
  int dst[L::kCopies], row_of[L::kCopies];
  bool lane_ok[L::kCopies];
#pragma unroll
  for (int j = 0; j < L::kCopies; ++j) {
    const int e = min(tid + 32 * kWorkers * j, L::kChunks - 1);
    const bool is_x = e < kRows * L::kChunksX;
    const int eg = e - kRows * L::kChunksX;
    const int tensor = is_x ? 0 : 1 + eg / (kRows * L::kChunksG);
    const int cpr = is_x ? L::kChunksX : L::kChunksG, bytes = is_x ? L::kBytesX : L::kBytesG;
    const int rem = is_x ? e : eg % (kRows * L::kChunksG);
    const int row = rem / cpr, first = rem % cpr * (16 / bytes);
    row_of[j] = tid + 32 * kWorkers * j < L::kChunks ? row : kRows;  // kRows: no chunk
    lane_ok[j] = first < lanes;  // 16-byte rows: a chunk is all in or all out
    const uint8_t* base = tensor == 0   ? reinterpret_cast<const uint8_t*>(x)
                          : tensor == 1 ? reinterpret_cast<const uint8_t*>(r)
                                        : reinterpret_cast<const uint8_t*>(gi);
    src[j] = base + ((row0 + row) * W + w0 + (lane_ok[j] ? first : 0)) * bytes;
    step[j] = lane_ok[j] ? tile_stride * bytes : 0;
    dst[j] = (tensor == 0 ? 0 : tensor == 1 ? L::kOffR : L::kOffI) + (row * kLanes + first) * bytes;
  }

  // Copy tile k's rows of x, r and i into its stage, 16 bytes a copy.
  auto prefetch = [&](int k) {
    uint8_t* const st = smem + (k % kStages) * L::kStageBytes;
#pragma unroll
    for (int j = 0; j < L::kCopies; ++j) {
      if (row_of[j] < kRows && static_cast<long long>(k) * kRows + row_of[j] < S)
        cp_async16(st + dst[j], src[j] + k * step[j], lane_ok[j]);
    }
  };

  // a_t and b_t of tile k's steps into its ring buffer.  Every row is
  // formed, past S too (from stale or zero inputs; the chain stops at S),
  // so that the rows' independent work interleaves.
  auto form = [&](int k) {
    float* const ab = a_buf(k);
    float* const bh = ab + L::kTileElems;
    const uint8_t* const st = smem + (k % kStages) * L::kStageBytes;
    const TX* const sx = reinterpret_cast<const TX*>(st);
    const TG* const sr = reinterpret_cast<const TG*>(st + L::kOffR);
    const TG* const si = reinterpret_cast<const TG*>(st + L::kOffI);
#pragma unroll
    for (int u = 0; u < kRowsPerWorker; ++u) {
      const int row = first_row + kRowStep * u;
      float xv = 0.f, rv = 0.f, iv = 0.f;
      if (kAsync) {
        xv = widen(sx[row * kLanes + col]);
        rv = widen(sr[row * kLanes + col]);
        iv = widen(si[row * kLanes + col]);
      } else if (col < lanes && static_cast<long long>(k) * kRows + row < S) {
        const long long idx = at0 + k * tile_stride + static_cast<long long>(kRowStep * u) * W;
        xv = widen(x[idx]);
        rv = widen(r[idx]);
        iv = widen(gi[idx]);
      }
      const float log_a = -8.f * rv * sp;
      const float a = expf(log_a);
      const float bt = sqrtf(fmaxf(-expm1f(2.f * log_a), 1e-12f)) * (iv * xv);
      ab[row * kLanes + col] = a;
      bh[row * kLanes + col] = bt;
    }
  };

  // y of tile k from its ring buffer (h written over b), coalesced.
  auto store = [&](int k) {
    const float* const bh = a_buf(k) + L::kTileElems;
    float* const yk = y + at0 + k * tile_stride;
#pragma unroll
    for (int u = 0; u < kRowsPerWorker; ++u) {
      const int row = first_row + kRowStep * u;
      if (col < lanes && static_cast<long long>(k) * kRows + row < S)
        yk[static_cast<long long>(kRowStep * u) * W] = bh[row * kLanes + col];
    }
  };

  if (kAsync) {
    for (int k = 0; k < kStages - 1; ++k) {
      if (k < tiles) prefetch(k);
      cp_async_commit();
    }
    cp_async_wait<kStages - 2>();  // tile 0 has landed
  }
  // Iteration k, after barrier k (which also makes every worker's copies of
  // tile k visible): form tile k, refill the stage tile k - 1 used, store
  // tile k - 2; the chain walks tile k - 1 meanwhile.  Workers and chain
  // both pass tiles + 2 barriers.
  for (int k = 0; k <= tiles + 1; ++k) {
    __syncthreads();
    if (k < tiles) form(k);
    if (kAsync) {
      if (k + kStages - 1 < tiles) prefetch(k + kStages - 1);
      cp_async_commit();
    }
    if (k >= 2) store(k - 2);
    if (kAsync) cp_async_wait<kStages - 2>();  // tile k + 1 has landed
  }
}

// Lanes a block owns: all-bf16 rows of 64 lanes are 128 bytes, as float32
// rows of 32 are.
template <typename TX, typename TG>
constexpr int kLanesFor = sizeof(TX) == 2 && sizeof(TG) == 2 ? 64 : 32;

template <typename TX, typename TG, bool kAsync>
int launch(const void* x, const void* r, const void* i, const float* lam, float* y,
           float* h_last, int B, long long S, int W, cudaStream_t st) {
  constexpr int kLanes = kLanesFor<TX, TG>;
  constexpr int bytes = Smem<TX, TG, kAsync, kLanes>::kBytes;
  auto kernel = rglru_scan_kernel<TX, TG, kAsync, kLanes>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kLanes - 1) / kLanes, B);
  kernel<<<grid, Warps<kLanes>::kThreads, bytes, st>>>(
      static_cast<const TX*>(x), static_cast<const TG*>(r), static_cast<const TG*>(i), lam, y,
      h_last, S, W);
  return cudaGetLastError();
}

// Staged when every row of x and of the gates is whole 16-byte chunks and
// the three inputs start on 16 bytes; else the workers load them.
template <typename TX, typename TG>
int launch_for(const void* x, const void* r, const void* i, const float* lam, float* y,
               float* h_last, int B, long long S, int W, cudaStream_t st) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool staged = W * sizeof(TX) % 16 == 0 && W * sizeof(TG) % 16 == 0 && aligned(x) &&
                      aligned(r) && aligned(i);
  return staged ? launch<TX, TG, true>(x, r, i, lam, y, h_last, B, S, W, st)
                : launch<TX, TG, false>(x, r, i, lam, y, h_last, B, S, W, st);
}

}  // namespace

// B9.  x, r, i [B, S, W] contiguous: x float32 (x_bf16 = 0) or bf16 (1), r
// and i both float32 (gates_bf16 = 0) or both bf16 (1); lam [W], y
// [B, S, W] and h_last [B, W] float32.  Launches on `stream`; returns
// cudaGetLastError() (0 = launched).
extern "C" int rglru_scan(const void* x, const void* r, const void* i, const float* lam,
                          float* y, float* h_last, int B, long long S, int W, int x_bf16,
                          int gates_bf16, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_bf16)
    return gates_bf16 ? launch_for<bf16, bf16>(x, r, i, lam, y, h_last, B, S, W, st)
                      : launch_for<bf16, float>(x, r, i, lam, y, h_last, B, S, W, st);
  return gates_bf16 ? launch_for<float, bf16>(x, r, i, lam, y, h_last, B, S, W, st)
                    : launch_for<float, float>(x, r, i, lam, y, h_last, B, S, W, st);
}
