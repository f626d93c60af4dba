// Shared by the SSD chunk scan's forward (ssd_chunk.cu, B10) and backward
// (ssd_chunk_bwd.cu): the 3xTF32 tiles of one warpgroup over a chunk's
// 64-row tiles, built on ../../csrc/tf32x3_sm90.cuh.  A row tile's values
// come from the model's layout ([B, S, G, N] per group or [B, S, H, P] per
// head, read in place); rows past Q and columns past N or P are zeros, so
// that no wgmma is issued under a branch (ptxas serialises wgmmas that are).
// Depths that an accumulator feeds in place are permuted within each k8 step
// (`kpos`), and so are the depths of the tiles and fragments multiplied with
// them, so that a fragment loads two neighbouring columns.
#pragma once

#include <cuda_runtime.h>

#include "../../csrc/tf32x3_sm90.cuh"
#include "ssd_common.cuh"

namespace ssd {

using namespace tf32x3;

constexpr int kThreads = 128;   // one warpgroup
constexpr int kT = 64;          // rows of a tile: queries, keys, p
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxQ = 256;
constexpr int kNK = kMaxN / 8;  // k8 steps over N
constexpr int kPK = kMaxP / 8;  // k8 steps over P, or over a tile's 64 rows
constexpr int kRowTile = kT * kMaxN;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + 64) of a [rows, width] tensor (row `r` at src + r·ld) into
// a K-major tile of kDepth depth, hi and lo, the depth permuted within its
// k8 step; rows at or past `rows` and columns past `width` are zeros.
// Sixteen loads a thread are in flight at a time.
template <int kDepth = kMaxN>
__device__ __forceinline__ void stage_rows(float* t_hi, float* t_lo, const float* src,
                                           long long ld, int r0, int rows, int width) {
  constexpr int kBatch = 16;
  for (int e0 = 0; e0 < kT * kDepth; e0 += kBatch * kThreads) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads + threadIdx.x, r = e / kDepth, n = e % kDepth;
      v[u] = (r0 + r < rows && n < width) ? src[(r0 + r) * ld + n] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads + threadIdx.x, r = e / kDepth, n = e % kDepth;
      uint32_t hi, lo;
      split(v[u], hi, lo);
      const int i = sw128(kT, r, (n & ~7) + kpos(n & 7));
      t_hi[i] = __uint_as_float(hi);
      t_lo[i] = __uint_as_float(lo);
    }
  }
}

// This thread's A fragments of rows [r0, r0 + 64) of a [rows, width]
// tensor (row `r` at src + r·ld), KK k8 steps deep, in kpos order within
// each step: register r of step kk is row r0 + 16w + l/4 + 8(r % 2), column
// 8kk + 2(l % 4) + r / 2 (zeros past `rows` and `width`).  These are also
// the positions of a 64 x 8KK accumulator's values d[4kk + e] with
// e = 2(r % 2) + r / 2 (`acc_frag`'s order).
template <int KK>
__device__ __forceinline__ void load_frag(float (&f)[KK][4], const float* src, long long ld,
                                          int r0, int rows, int width) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = r0 + 16 * warp + (lane >> 2) + 8 * (r & 1);
      const int n = 8 * kk + 2 * (lane & 3) + (r >> 1);
      f[kk][r] = (i < rows && n < width) ? src[i * ld + n] : 0.f;
    }
}

// This thread's fragment of C's 64 rows from i0 (group g of batch b, chunk
// from step s0), N deep.
__device__ __forceinline__ void load_c(float (&cf)[kNK][4], const float* __restrict__ cm,
                                       const Shape& sh, int b, long long s0, int g, int i0) {
  load_frag(cf, cm + row_bsg(sh, b, s0, g), static_cast<long long>(sh.G) * sh.N, i0, sh.Q,
            sh.N);
}

// acc (64 x N) += A · B over KK k8 steps: A's four float32 values of step
// kk from `frag(kk, x)`, split here; B's hi and lo tiles (N rows, K-major,
// 8KK deep) in shared memory.  One commit group per k8 step, two sets of A
// fragments: a step's fragments are formed while the previous step's
// wgmmas run.
template <int N, int KK, typename Frag>
__device__ __forceinline__ void frag_product(float (&acc)[N / 2], Frag frag, const float* b_hi,
                                             const float* b_lo) {
  uint32_t hi[2][4], lo[2][4];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const int u = kk & 1;
    wgmma_wait<1>();  // the group that read set u (two steps back) has completed
    fence_regs(hi[u]);
    fence_regs(lo[u]);
    float x[4];
    frag(kk, x);
    split4(x, hi[u], lo[u]);
    wgmma_fence();
    mma3<N>(acc, hi[u], lo[u], desc(b_hi, N, kk), desc(b_lo, N, kk));
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

// acc (64 x 64) += C · Tᵀ over N: C's fragments cf in registers, T's hi and
// lo tiles (64 rows, K-major, kMaxN deep, zeros past N) in shared memory.
__device__ __forceinline__ void c_product(float (&acc)[kT / 2], const float (&cf)[kNK][4],
                                          const float* t_hi, const float* t_lo) {
  frag_product<kT, kNK>(acc, [&](int kk, float(&x)[4]) {
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = cf[kk][r];
  }, t_hi, t_lo);
}

// The lower-triangle tile pair p of a chunk's 64-row tiles: query tile
// *it, key tile *jt <= *it, p = it·(it + 1)/2 + jt.
__device__ __forceinline__ void tile_pair(int p, int* it, int* jt) {
  int i = 0;
  while (p > i) {
    p -= i + 1;
    ++i;
  }
  *it = i;
  *jt = p;
}

// A 64 x 64 score tile in the workspace, in the accumulator's layout: the
// four values d[4u .. 4u + 3] of thread t at float4 u·128 + t (coalesced
// both ways).  `per` score tiles per (b·g, chunk).
__device__ __forceinline__ float4* score_tile(float* ws_s, const Shape& sh, int bg, int c,
                                              int p, int per) {
  const long long tile = (static_cast<long long>(bg) * sh.nc + c) * per + p;
  return reinterpret_cast<float4*>(ws_s + tile * kT * kT);
}

// One score tile: rows [a0, a0 + 64) of `a` times rows [b0, b0 + 64) of `bsrc`
// over N (both [B, S, G, N], group g of batch b, chunk from step s0) into
// `out`; r_hi and r_lo are the block's two kRowTile tiles.
__device__ __forceinline__ void score_block(const float* __restrict__ a, int a0,
                                            const float* __restrict__ bsrc, int b0, float4* out,
                                            float* r_hi, float* r_lo, const Shape& sh, int b,
                                            long long s0, int g) {
  float cf[kNK][4];
  load_c(cf, a, sh, b, s0, g, a0);
  stage_rows(r_hi, r_lo, bsrc + row_bsg(sh, b, s0, g), static_cast<long long>(sh.G) * sh.N,
             b0, sh.Q, sh.N);
  fence_async_smem();
  __syncthreads();
  float sc[kT / 2];
#pragma unroll
  for (int e = 0; e < kT / 2; ++e) sc[e] = 0.f;
  c_product(sc, cf, r_hi, r_lo);
#pragma unroll
  for (int u = 0; u < kT / 8; ++u)
    out[u * kThreads + threadIdx.x] = make_float4(sc[4 * u], sc[4 * u + 1], sc[4 * u + 2],
                                                  sc[4 * u + 3]);
}

// A 64 x 64 tile of a head tensor [rows j][p] (xdt or dy), transposed into
// [p][j] with the rows j in kpos order: a warp takes 8 neighbouring p of the
// 4 rows that share a 16-byte chunk of the swizzled row (even or odd rows of
// an 8-row step), so its stores hit 32 banks and its loads whole 32-byte
// sectors.  `load_xdt` fills registers, `store_xdt` splits them into the hi
// and lo tiles.
constexpr int kOutX = kT * kMaxP / kThreads;  // values a thread stages per tile

__device__ __forceinline__ void xdt_slot(int u, int* p, int* jj) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  *p = (u & 3) * 16 + (warp >> 1) * 8 + (lane & 7);
  *jj = (u >> 2) * 8 + 2 * (lane >> 3) + (warp & 1);
}

__device__ __forceinline__ void load_xdt(float (&xv)[kOutX], const float* x_base, int x_ld,
                                         const Shape& sh, int j0) {
#pragma unroll
  for (int u = 0; u < kOutX; ++u) {
    int p, jj;
    xdt_slot(u, &p, &jj);
    xv[u] = (j0 + jj < sh.Q && p < sh.P) ? x_base[static_cast<long long>(j0 + jj) * x_ld + p]
                                         : 0.f;
  }
}

__device__ __forceinline__ void store_xdt(const float (&xv)[kOutX], float* x_hi, float* x_lo) {
#pragma unroll
  for (int u = 0; u < kOutX; ++u) {
    int p, jj;
    xdt_slot(u, &p, &jj);
    uint32_t hi, lo;
    split(xv[u], hi, lo);
    const int i = sw128(kMaxP, p, (jj & ~7) + kpos(jj & 7));
    x_hi[i] = __uint_as_float(hi);
    x_lo[i] = __uint_as_float(lo);
  }
  fence_async_smem();
}

}  // namespace ssd
