// Building blocks of the float32 flash-attention kernels (B7's forward in
// flash_attention.cu, B8's dq and dk/dv kernels in flash_attention_bwd.cu):
// 3xTF32 wgmma on tiles that the block's threads stage, split, in shared
// memory.
//
// Arithmetic (../../csrc/tf32x3_sm90.cuh): each float32 operand x enters the
// tensor cores as hi = rna(x) and lo = rna(x - hi), and each k8 step of a
// product is taken as lo·hi + hi·lo + hi·hi into a float32 accumulator,
// ~2^-22 of each term.  tests/_flash_emulation.py (`forward_tf32x3`,
// `backward_tf32x3`) models these kernels on the CPU.
//
// Each consumer warpgroup (128 threads) owns 64 rows of the products' A
// side: the query rows of B7 and of B8's dq kernel, the key rows of B8's
// dk/dv kernel.  The operands come in four kinds:
// * A from tiles (`tiles_product`, `tiles_product2`): rows that stay for the
//   whole block (Q, dO), split once by `stage` into K-major hi and lo tiles
//   that wgmma reads from shared memory; every k8 step issued back to back.
// * A from rows (`rows_product`, `rows_product2`): such rows staged raw in
//   shared memory with rows padded by 8 floats (`stage_raw`: each
//   half-warp's 64-bit loads hit 32 banks), or, where shared memory has no
//   room (D = 256), read from device memory, one k8 step at a time into
//   registers (`a_frag`) and split there, three sets of fragments in flight.
// * A from an accumulator (`acc_product`): P or dS, the previous product's
//   64 × N float32 accumulator, split in place (`acc_frag`).
// * B: a K-major tile of R rows × W depth in 128-byte swizzled panels
//   (`sw128`), hi and lo, written by threads (`stage`): rows R of a source
//   as the tile [R][W] (depth W) and/or its transpose [W][R] (depth R),
//   both from one load of each element, from device memory or from a raw
//   copy that cp.async brought in under the previous tile's products
//   (`prefetch`).  TF32 wgmma reads B only K-major, so V (B7's P·V), K
//   (B8's dS·K) and Q and dO (dK, dV) are staged transposed.
// Every depth is stored in the `kpos` order within its k8 steps, so that an
// accumulator's columns feed the next product in place and a row fragment
// loads two neighbouring columns (register q of step kk holds column
// 8kk + 2(l % 4) + q / 2).  Rows past the source's end are zeros.
//
// No wgmma is issued under a branch (ptxas serialises wgmmas that are): the
// products' loops have compile-time trip counts, the tile walk is the only
// loop with a run-time bound, and masks act on the accumulators' values.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/tf32x3_sm90.cuh"

namespace flash {
namespace tf32 {

using namespace tf32x3;

constexpr int kThreads = 128;   // one warpgroup

// Width of one wgmma over an output of W columns, at most MAX: W itself,
// MAX where it divides W, else 64 (192 = three issues of 64).
template <int W, int MAX>
struct Width {
  static constexpr int N = W <= MAX ? W : (W % MAX == 0 ? MAX : 64);
  static constexpr int kCount = W / N;
};

// ---- copies ----

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A raw tile of R rows × W floats in shared memory, rows padded by 4 floats
// (16-byte aligned rows; `stage`'s reads of 4 rows × 8 columns hit 32 banks).
template <int R, int W>
struct Raw {
  static constexpr int kLd = W + 4;
  static constexpr int kFloats = R * kLd;
};

// Issue cp.async copies of rows [0, R) of a row-major [rows][W] source (row
// r at src + r·ld) into a Raw<R, W> tile; rows at or past n are zeros,
// stored at once.  16-byte copies where the source's rows allow (address
// and stride in whole 16 bytes), else 4-byte ones.  The caller commits.
template <int R, int W, int T>
__device__ __forceinline__ void prefetch(float* raw, const float* src, long long ld, int n) {
  constexpr int kLd = Raw<R, W>::kLd;
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && ld % 4 == 0) {
#pragma unroll 4
    for (int e = threadIdx.x; e < R * W / 4; e += T) {
      const int r = e / (W / 4), c = 4 * (e % (W / 4));
      if (r < n)
        cp_async16(raw + r * kLd + c, src + r * ld + c);
      else
        *reinterpret_cast<float4*>(raw + r * kLd + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < R * W; e += T) {
      const int r = e / W, c = e % W;
      if (r < n)
        cp_async4(raw + r * kLd + c, src + r * ld + c);
      else
        raw[r * kLd + c] = 0.f;
    }
  }
}

// Rows [0, ROWS) of a row-major [rows][W] source (row r at src + r·ld, rows
// at or past n zeros) into dst, rows ld_dst floats apart.
template <int ROWS, int W, int T>
__device__ __forceinline__ void stage_raw(float* dst, int ld_dst, const float* src, long long ld,
                                          int n) {
#pragma unroll 8
  for (int e = threadIdx.x; e < ROWS * W; e += T) {
    const int r = e / W, c = e % W;
    dst[r * ld_dst + c] = r < n ? src[r * ld + c] : 0.f;
  }
}

// Loads in flight a thread when staging R × W from device memory: 16, or
// the whole tile where it is smaller.  (Whole tiles of up to 48 values a
// thread spilled hundreds of bytes in the backward kernels and took twice
// as long on an H100.)
template <int R, int W, int T>
constexpr int kDeviceBatch = R * W / T < 16 ? R * W / T : 16;

// Rows [0, R) of a row-major [rows][W] source (rows at or past n zeros; a
// Raw tile in shared memory, or device memory) as K-major tiles, each hi
// followed by lo: `rows` [R][W] (depth W) where ROWS, `cols` [W][R] (depth
// R) where COLS; T threads, BATCH loads in flight a thread.  A warp takes
// 8 neighbouring columns of the 4 rows of a k8 step that share a 16-byte
// chunk of a swizzled row (the even or the odd rows), so each store
// instruction hits 32 banks in either layout and each load of device
// memory fills whole 32-byte sectors.
template <int R, int W, bool ROWS, bool COLS, int T, int BATCH>
__device__ __forceinline__ void stage(float* rows, float* cols, const float* src, long long ld,
                                      int n) {
  constexpr int kIter = R * W / T;
  static_assert(kIter % BATCH == 0 && W % 8 == 0 && R % 8 == 0, "tile shape");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int i0 = 0; i0 < kIter; i0 += BATCH) {
    float x[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int s = (i0 + u) * (T / 32) + warp, cb = s % (W / 8), rest = s / (W / 8);
      const int c = 8 * cb + (lane & 7), r = 8 * (rest >> 1) + 2 * (lane >> 3) + (rest & 1);
      x[u] = r < n ? src[r * ld + c] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int s = (i0 + u) * (T / 32) + warp, cb = s % (W / 8), rest = s / (W / 8);
      const int c = 8 * cb + (lane & 7), r = 8 * (rest >> 1) + 2 * (lane >> 3) + (rest & 1);
      uint32_t hi, lo;
      split(x[u], hi, lo);
      if constexpr (ROWS) {
        const int i = sw128(R, r, (c & ~7) + kpos(c & 7));
        rows[i] = __uint_as_float(hi);
        rows[R * W + i] = __uint_as_float(lo);
      }
      if constexpr (COLS) {
        // kpos(r & 7) = (lane >> 3) + 4 · (r & 1)
        const int i = sw128(W, c, 8 * (rest >> 1) + (lane >> 3) + 4 * (rest & 1));
        cols[i] = __uint_as_float(hi);
        cols[R * W + i] = __uint_as_float(lo);
      }
    }
  }
}

// This thread's A values of k8 step kk from rows [0, 64) of a row-major
// matrix (row r at a + r·ld): register q is row 16w + l/4 + 8(q % 2),
// column 8kk + 2(l % 4) + q / 2.  SHARED: a padded raw tile (8-byte
// aligned pairs, every row present); else device memory, rows at or past n
// zeros, any stride.
template <bool SHARED>
__device__ __forceinline__ void a_frag(float (&x)[4], const float* a, long long ld, int n,
                                       int kk) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int r = 16 * warp + (lane >> 2), c = 8 * kk + 2 * (lane & 3);
  if constexpr (SHARED) {
    const float2 u = *reinterpret_cast<const float2*>(a + r * ld + c);
    const float2 w = *reinterpret_cast<const float2*>(a + (r + 8) * ld + c);
    x[0] = u.x;
    x[1] = w.x;
    x[2] = u.y;
    x[3] = w.y;
  } else {
    const float* p = a + r * ld + c;
    const float* p8 = a + (r + 8) * ld + c;
    x[0] = r < n ? p[0] : 0.f;
    x[1] = r + 8 < n ? p8[0] : 0.f;
    x[2] = r < n ? p[1] : 0.f;
    x[3] = r + 8 < n ? p8[1] : 0.f;
  }
}

// Sets of split A fragments in flight: a step's fragments are formed while
// the two previous steps' wgmmas run.
constexpr int kSets = 3;

// acc (64 × N) += A · Bᵀ over depth KD: A from rows (`a_frag`), B's hi and
// lo tiles [N][KD] at b (lo at b + N·KD).  One commit group per k8 step.
template <int KD, int N, bool SHARED>
__device__ __forceinline__ void rows_product(float (&acc)[N / 2], const float* a, long long ld,
                                             int n, const float* b) {
  uint32_t hi[kSets][4], lo[kSets][4];
#pragma unroll
  for (int kk = 0; kk < KD / 8; ++kk) {
    const int u = kk % kSets;
    wgmma_wait<kSets - 1>();  // the group that read set u (kSets steps back) has completed
    fence_regs(hi[u]);
    fence_regs(lo[u]);
    float x[4];
    a_frag<SHARED>(x, a, ld, n, kk);
    split4(x, hi[u], lo[u]);
    wgmma_fence();
    mma3<N>(acc, hi[u], lo[u], desc(b, N, kk), desc(b + N * KD, N, kk));
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

// acc (64 × N) += A · Bᵀ over depth KD, A's hi and lo tiles [64][KD] at a
// (lo at a + 64·KD, split once by `stage`) and B's [N][KD] at b: every
// step's wgmmas issued back to back in one commit group.
template <int KD, int N>
__device__ __forceinline__ void tiles_product(float (&acc)[N / 2], const float* a,
                                              const float* b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KD / 8; ++kk)
    mma3_ss<N>(acc, desc(a, 64, kk), desc(a + 64 * KD, 64, kk), desc(b, N, kk),
               desc(b + N * KD, N, kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// tiles_product for two products side by side in one commit group (S and
// dP, or Sᵀ and dPᵀ): acc1 over depth KD1 from A tiles a1 and B tiles b1,
// acc2 over KD2 <= KD1 from a2 and b2.
template <int KD1, int KD2, int N>
__device__ __forceinline__ void tiles_product2(float (&acc1)[N / 2], const float* a1,
                                               const float* b1, float (&acc2)[N / 2],
                                               const float* a2, const float* b2) {
  static_assert(KD2 <= KD1, "the second product is the shallower");
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KD1 / 8; ++kk) {
    mma3_ss<N>(acc1, desc(a1, 64, kk), desc(a1 + 64 * KD1, 64, kk), desc(b1, N, kk),
               desc(b1 + N * KD1, N, kk));
    if (kk < KD2 / 8)  // a compile-time condition: the loop is unrolled
      mma3_ss<N>(acc2, desc(a2, 64, kk), desc(a2 + 64 * KD2, 64, kk), desc(b2, N, kk),
                 desc(b2 + N * KD2, N, kk));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc1);
  fence_regs(acc2);
}

// Two row products of the same rows side by side, one commit group a step
// for both, so twice the tensor-core work is in flight: acc1 += A1 · B1ᵀ
// over depth KD1 and acc2 += A2 · B2ᵀ over KD2 <= KD1 (S and dP, or Sᵀ
// and dPᵀ), arguments as `rows_product`'s; SETS sets of split fragments.
template <int KD1, int KD2, int N, bool SHARED, int SETS = kSets>
__device__ __forceinline__ void rows_product2(float (&acc1)[N / 2], const float* a1,
                                              long long ld1, const float* b1,
                                              float (&acc2)[N / 2], const float* a2,
                                              long long ld2, const float* b2, int n) {
  static_assert(KD2 <= KD1, "the second product is the shallower");
  uint32_t hi[SETS][4], lo[SETS][4], hi2[SETS][4], lo2[SETS][4];
#pragma unroll
  for (int kk = 0; kk < KD1 / 8; ++kk) {
    const int u = kk % SETS;
    wgmma_wait<SETS - 1>();
    fence_regs(hi[u]);
    fence_regs(lo[u]);
    fence_regs(hi2[u]);
    fence_regs(lo2[u]);
    float x[4];
    a_frag<SHARED>(x, a1, ld1, n, kk);
    split4(x, hi[u], lo[u]);
    if (kk < KD2 / 8) {
      a_frag<SHARED>(x, a2, ld2, n, kk);
      split4(x, hi2[u], lo2[u]);
    }
    wgmma_fence();
    mma3<N>(acc1, hi[u], lo[u], desc(b1, N, kk), desc(b1 + N * KD1, N, kk));
    if (kk < KD2 / 8)  // a compile-time condition: the loop is unrolled
      mma3<N>(acc2, hi2[u], lo2[u], desc(b2, N, kk), desc(b2 + N * KD2, N, kk));
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc1);
  fence_regs(acc2);
}

// acc[c] (64 × NW each, c < W / NW) += X · Bᵀ over depth KD: X a 64 × KD
// float32 accumulator (P or dS) split in place, B's hi and lo tiles [W][KD]
// at b (lo at b + W·KD).  In place (FRESH false), the W columns are W / NW
// issues a step into acc.  FRESH: each NW-column part is taken into a
// zeroed accumulator and added to acc[c] by float32 additions.  The tensor
// cores round each addition to the accumulator toward zero; a sum over
// thousands of steps (dq, dk and dv walk every key or query of the band)
// then drifts past the per-element bar (tests/_flash_emulation.py: 1.2
// times it at S = 1,000; 1.06 on an H100), while a fresh
// accumulator takes one tile's dozen roundings and the float32 additions
// round to nearest.
template <int KD, int W, int NW, bool FRESH>
__device__ __forceinline__ void acc_product(float (&acc)[W / NW][NW / 2],
                                            const float (&x)[KD / 2], const float* b) {
  uint32_t hi[kSets][4], lo[kSets][4];
  if constexpr (!FRESH) {
#pragma unroll
    for (int kk = 0; kk < KD / 8; ++kk) {
      const int u = kk % kSets;
      wgmma_wait<kSets - 1>();
      fence_regs(hi[u]);
      fence_regs(lo[u]);
      float f[4];
      acc_frag(x, kk, f);
      split4(f, hi[u], lo[u]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < W / NW; ++c)
        mma3<NW>(acc[c], hi[u], lo[u], desc(b + c * NW * kPanel, W, kk),
                 desc(b + W * KD + c * NW * kPanel, W, kk));
      wgmma_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < W / NW; ++c) fence_regs(acc[c]);
  } else {
#pragma unroll
    for (int c = 0; c < W / NW; ++c) {
      float t[NW / 2];
#pragma unroll
      for (int e = 0; e < NW / 2; ++e) t[e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD / 8; ++kk) {
        const int u = kk % kSets;
        wgmma_wait<kSets - 1>();
        fence_regs(hi[u]);
        fence_regs(lo[u]);
        float f[4];
        acc_frag(x, kk, f);
        split4(f, hi[u], lo[u]);
        wgmma_fence();
        mma3<NW>(t, hi[u], lo[u], desc(b + c * NW * kPanel, W, kk),
                 desc(b + W * KD + c * NW * kPanel, W, kk));
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(t);
#pragma unroll
      for (int e = 0; e < NW / 2; ++e) acc[c][e] += t[e];
    }
  }
}

}  // namespace tf32
}  // namespace flash
