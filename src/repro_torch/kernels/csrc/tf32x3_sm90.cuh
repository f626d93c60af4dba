// Hopper (sm_90a) building blocks of the float32 tensor-core kernels: B1's
// one-tenant route (rolann_stats/csrc/rolann_stats_sm90.cuh), B10
// (ssd_chunk/csrc/ssd_chunk.cu) and the float32 routes of B7 and B8
// (flash_attention/csrc/flash_tf32x3_sm90.cuh), for TF32 operands.  The generic pieces
// (shared-memory addresses, wgmma fences, commits and waits) are the bf16
// kernels' in flash_attention/csrc/flash_sm90.cuh.
//
// 3xTF32.  A TF32 product keeps 11 significant bits of each operand, too
// few for the float32 bars these kernels are held to.  Each float32
// operand x is split into hi = rna(x) and lo = rna(x - hi), both TF32 values
// (`cvt.rna.tf32.f32`: rounded half away from zero; x - hi is exact in
// float32), and a product a·b is taken as lo_a·hi_b + hi_a·lo_b + hi_a·hi_b
// (the small terms first) into a float32 accumulator: ~2^-22 of each term
// where one TF32 product errs by ~2^-11.  hi must be rounded before it is
// stored: the tensor cores read a float32 bit pattern as TF32 by dropping
// its low 13 bits, and an unrounded hi would leave lo short of x - hi.
// tests/test_torch_tf32x3.py models this arithmetic on the CPU.
//
// Operands.  TF32 wgmma reads B (and A, when it comes from shared memory)
// only K-major: the depth K runs along a row.  A shared-memory tile is
// rows × 32 floats per panel, each row one 128-byte swizzle row, 8-row
// atoms of 1,024 bytes, each panel 1,024-byte aligned; a k8 step is 32
// bytes along the row (the byte geometry of the bf16 kernels' k16 steps).  The
// kernels write their tiles with threads (`sw128`), so every store is
// followed by `fence_async_smem` before a barrier and the wgmma that reads
// it.  A comes from registers (m64k8, four 32-bit registers a thread):
// thread t of the warpgroup (warp w = t / 32, lane l) holds register r at
// row 16w + l/4 + 8·(r % 2), depth position l%4 + 4·(r / 2).
//
// Accumulators.  A wgmma m64nNk8 float32 accumulator gives thread t
// N / 2 values: d[4j + e] is row 16w + l/4 + 8·(e / 2), column
// 8j + 2·(l % 4) + (e % 2), as for bf16.  So an accumulator's 8 columns
// 8j .. 8j + 7 feed the next product's A in place when the depth is
// permuted within each k8 step: depth position q holds column
// `kperm(q)` = 2·(q % 4) + q / 4 (`acc_frag`), and the B tile stores its
// depth index k at position `kpos(k)` within its k8 step.  A sum over the
// depth does not depend on its order within a step.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "../flash_attention/csrc/flash_sm90.cuh"

namespace tf32x3 {

using flash::sm90::align1024;
using flash::sm90::fence_regs;
using flash::sm90::smem_u32;
using flash::sm90::wgmma_commit;
using flash::sm90::wgmma_fence;
using flash::sm90::wgmma_wait;

constexpr int kPanel = 32;          // floats per swizzled row (128 bytes)

// ---- the split ----

// cvt.rna.tf32.f32, as a float32 whose low 13 bits are zero.
__device__ __forceinline__ uint32_t rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna(x);
  lo = rna(x - __uint_as_float(hi));
}

// Four float32 A values as the hi and lo fragments of one k8 step.
__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) split(x[r], hi[r], lo[r]);
}

// ---- depth permutation within a k8 step ----

// Depth position q (0..7) of an A fragment holds column kperm(q) of an
// accumulator's 8 columns; a B tile stores depth index k (0..7) at kpos(k).
__device__ __forceinline__ int kperm(int q) { return 2 * (q & 3) + (q >> 2); }
__device__ __forceinline__ int kpos(int k) { return (k >> 1) + 4 * (k & 1); }

// Columns 8j .. 8j + 7 of an accumulator as the A values of one k8 step
// (in the permuted depth order).
template <int NV>
__device__ __forceinline__ void acc_frag(const float (&d)[NV], int j, float (&x)[4]) {
  x[0] = d[4 * j + 0];
  x[1] = d[4 * j + 2];
  x[2] = d[4 * j + 1];
  x[3] = d[4 * j + 3];
}

// ---- shared-memory tiles ----

// Float index of (row, col) in a K-major tile of `rows` rows held as panels
// of kPanel floats: panel col / 32, then 128-byte swizzled rows.
__device__ __forceinline__ int sw128(int rows, int row, int col) {
  const int c = col & (kPanel - 1);
  return (col / kPanel) * rows * kPanel + row * kPanel +
         ((((c >> 2) ^ (row & 7)) << 2) | (c & 3));
}

// Make the threads' generic-proxy stores to shared memory visible to the
// async proxy (wgmma operand reads); then a barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The descriptor of k8 step kk of a K-major tile of `rows` rows (panel
// kk / 4, 32 bytes per step along the row; 8-row groups 1,024 bytes apart;
// 128-byte swizzle).
__device__ __forceinline__ uint64_t desc(const float* tile, int rows, int kk) {
  const uint32_t addr =
      smem_u32(tile + (kk >> 2) * rows * kPanel) + static_cast<uint32_t>((kk & 3) * 32);
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// ---- wgmma ----

// flash::sm90::fence_regs for A fragments: keep the compiler from moving
// writes of registers that an in-flight wgmma reads before its wait.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 × N, float32) += A · B, TF32 operands: A from registers (a
// fragment), B from shared memory, K-major.

__device__ __forceinline__ void wgmma_rs_n8(float (&d)[4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 × N, float32) += A · B, TF32 operands, A and B from shared memory,
// both K-major.

__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// acc += a·b for one k8 step as lo·hi + hi·lo + hi·hi, A's hi and lo tiles
// and B's given by their descriptors (A from shared memory).
template <int N>
__device__ __forceinline__ void mma3_ss(float (&d)[N / 2], uint64_t a_hi, uint64_t a_lo,
                                        uint64_t b_hi, uint64_t b_lo) {
  if constexpr (N == 32) {
    wgmma_ss_n32(d, a_lo, b_hi);
    wgmma_ss_n32(d, a_hi, b_lo);
    wgmma_ss_n32(d, a_hi, b_hi);
  } else {
    static_assert(N == 64, "wgmma width");
    wgmma_ss_n64(d, a_lo, b_hi);
    wgmma_ss_n64(d, a_hi, b_lo);
    wgmma_ss_n64(d, a_hi, b_hi);
  }
}

// acc += a·b for one k8 step as lo·hi + hi·lo + hi·hi: A's fragments split
// by `split4` (kept unchanged until the wgmmas have completed), B's hi and
// lo tiles given by their descriptors.
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N / 2], const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4], uint64_t b_hi, uint64_t b_lo) {
  if constexpr (N == 8) {
    wgmma_rs_n8(d, a_lo, b_hi);
    wgmma_rs_n8(d, a_hi, b_lo);
    wgmma_rs_n8(d, a_hi, b_hi);
  } else if constexpr (N == 32) {
    wgmma_rs_n32(d, a_lo, b_hi);
    wgmma_rs_n32(d, a_hi, b_lo);
    wgmma_rs_n32(d, a_hi, b_hi);
  } else if constexpr (N == 64) {
    wgmma_rs_n64(d, a_lo, b_hi);
    wgmma_rs_n64(d, a_hi, b_lo);
    wgmma_rs_n64(d, a_hi, b_hi);
  } else {
    static_assert(N == 128, "wgmma width");
    wgmma_rs_n128(d, a_lo, b_hi);
    wgmma_rs_n128(d, a_hi, b_lo);
    wgmma_rs_n128(d, a_hi, b_hi);
  }
}

}  // namespace tf32x3
