// Hopper (sm_90a) building blocks of the tensor-core flash-attention kernels
// (B7's forward in flash_fwd_sm90.cuh, B8's dq and dk/dv kernels in
// flash_bwd_sm90.cuh): mbarriers, TMA tile loads, wgmma shared-memory
// descriptors and instructions, the accumulator <-> operand fragment
// layout, the hi + lo bf16 split of a float32 operand, and the TMA tensor
// maps of the [B, S, heads, D] layout.
//
// Tiles.  Every bf16 tile of R rows × D is held in shared memory as D / C
// column panels of R rows × C elements, C = min(D, 64), each row one 128-byte
// (64-byte at D = 32) swizzle row, each panel 1024-byte aligned.  That is
// what a TMA load with CU_TENSOR_MAP_SWIZZLE_128B (64B) writes for a box of
// (C, R), and what a wgmma descriptor of the same swizzle reads:
//   * K-major (the product's depth along a row: Q and K in Q·Kᵀ): 8-row
//     groups 8·2C bytes apart (SBO), one 16-deep step = 32 bytes along the
//     row;
//   * MN-major (the depth down the rows: V in P·V, K in dS·K): one
//     16-deep step = 16 rows; each instruction covers one panel (N = C), so
//     only the 8-row group stride matters, and it is given as both the
//     leading and the stride byte offset.
//
// Accumulators.  A wgmma m64nNk16 float32 accumulator gives thread t of the
// warpgroup (warp w = t / 32, lane l) N / 2 values: d[4j + e] is row
// 16w + l/4 + 8·(e / 2), column 8j + 2·(l % 4) + (e % 2).  The A operand
// from registers (m64k16) has the same layout for 16 columns, four 32-bit
// registers of two bf16 each, so an accumulator becomes the next product's
// A operand in place (`to_frag`).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver entry point is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace flash {
namespace sm90 {

// ---- shared memory, mbarriers, TMA ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte aligned address at or after p (swizzled tiles need it).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed.  A wait that never
// ends is a bug in the tile walk; after ~2^24 polls (seconds; a real wait
// lasts one tile's work, microseconds) it traps, so that the launch fails
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t n = 0; !mbar_try_wait(addr, parity); ++n)
    if (n == (1u << 24)) __trap();
}

// One TMA load of the box at (c0, c1, c2, c3) of a 4-d tensor map into
// shared memory; completion is reported to `bar` as transaction bytes.
// Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// ---- tile geometry and wgmma descriptors ----

template <int D>
struct Panel {
  static constexpr int kCols = D < 64 ? D : 64;         // elements per swizzled row
  static constexpr int kCount = D / kCols;              // panels per tile
  static constexpr int kRowBytes = 2 * kCols;           // 128 (64 at D = 32)
  static constexpr int kGroupBytes = 8 * kRowBytes;     // one 8-row swizzle atom
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;  // descriptor: 128B / 64B swizzle
  static constexpr CUtensorMapSwizzle kSwizzle =
      kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  static_assert(D % 16 == 0 && D % kCols == 0, "head size");
};

template <int D>
__device__ __forceinline__ uint64_t make_desc(const uint8_t* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (Panel<D>::kLayout << 62);
}

// A tile of ROWS × D, K-major: the rows are M (or N), the depth is D; the
// descriptor of its 16-deep step kk.
template <int D, int ROWS>
__device__ __forceinline__ uint64_t desc_k(const uint8_t* tile, int kk) {
  using P = Panel<D>;
  const int e = 16 * kk;
  return make_desc<D>(tile + (e / P::kCols) * ROWS * P::kRowBytes + (e % P::kCols) * 2, 16,
                      P::kGroupBytes);
}

// A tile of ROWS × D, MN-major: the rows are the depth, panel pn gives the
// N = C columns; the descriptor of rows 16·kk .. 16·kk + 15.
template <int D, int ROWS>
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* tile, int pn, int kk) {
  using P = Panel<D>;
  return make_desc<D>(tile + pn * ROWS * P::kRowBytes + 16 * kk * P::kRowBytes, P::kGroupBytes,
                      P::kGroupBytes);
}

// ---- wgmma ----

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous window between a wgmma and its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 × N, float32) += A · B, bf16 operands.  _ss: A and B from shared
// memory, both K-major.  _rs: A from registers (a fragment), B from shared
// memory MN-major (transposed).

__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
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
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
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

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
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
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
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

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b) {
  static_assert(N == 32 || N == 64, "wgmma width");
  if constexpr (N == 32) wgmma_ss_n32(d, a, b); else wgmma_ss_n64(d, a, b);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  static_assert(N == 32 || N == 64, "wgmma width");
  if constexpr (N == 32) wgmma_rs_n32(d, a, b); else wgmma_rs_n64(d, a, b);
}

// ---- fragments ----

// x (float32) as hi + lo, hi = bf16(x), lo = bf16(x - hi): the pair carries
// x to ~2^-17 of itself, where one bf16 rounding errs by up to 2^-9.  Two
// values per 32-bit register, the lower column in the low half.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Columns 16·kk .. 16·kk + 15 of a 64 × N accumulator as the hi and lo A
// operands of one m64k16 step.
template <int NV>
__device__ __forceinline__ void to_frag(const float (&d)[NV], int kk, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) split2(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1], hi[r], lo[r]);
}

// ---- tensor maps ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded (no
// link against libcuda); null where the driver lacks it.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a bf16 [B, S, heads, D] tensor read by its batch,
// sequence and head strides (elements; the last axis contiguous), in boxes
// of one panel: (C, rows, 1, 1).  TMA needs a 16-byte aligned base and
// strides that are multiples of 16 bytes: anything else is refused with
// cudaErrorInvalidValue (the wrapper raises before that).
template <int D>
inline int make_map(CUtensorMap* map, const void* base, int B, int S, int heads, long long sb,
                    long long ss, long long sh, int rows) {
  using P = Panel<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0) return cudaErrorInvalidValue;
  for (long long st : {sb, ss, sh})
    if (st <= 0 || (2 * st) % 16 != 0) return cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(2 * ss), static_cast<cuuint64_t>(2 * sh),
                                 static_cast<cuuint64_t>(2 * sb)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(P::kCols), static_cast<cuuint32_t>(rows), 1,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, P::kSwizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace flash
