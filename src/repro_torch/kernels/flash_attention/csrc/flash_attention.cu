// Causal, optionally windowed, flash attention forward on Hopper (sm_90a):
// the entry point of B7 and its float32 kernel, 3xTF32 on the tensor cores.
//
// Replaces the Pallas TPU kernel `flash_attention_kernel` (body `_kernel`) of
// src/repro/kernels/flash_attention/kernel.py (B7).  For every batch b, query
// head h and query position i:
//
//     s_ij  = (q_i · k_j) · D^-1/2,  masked to -1e30 unless j <= i (causal)
//             and j > i - window (when a window is given) and j < S
//     out_i = Σ_j softmax(s_i)_j v_j          (in q's type)
//     lse_i = m_i + log(max(l_i, 1e-30))      (float32; the backward needs it)
//
// with an online softmax: a running row max m, row sum l and accumulator in
// float32, the Pallas kernel's `_NEG_INF = -1e30` and `max(l, 1e-30)`.
//
// A query stripe.  q may hold Sq <= Sk rows against Sk keys, query row i at
// position off + i (0 <= off <= Sk - Sq): the causal rule keeps j <= off + i
// and the window rule j > off + i - window, the reference's
// `attend_chunked(..., q_offset=)`.  The sequence-parallel attention of
// models/attention.py runs each model rank's stripe so.  With off = 0 and
// Sq = Sk every index below is the square case's, so is every result.
//
// Layout.  q [B, Sq, H, D], k [B, Sk, Hkv, D] and v [B, Sk, Hkv, DV], each with
// its own batch, sequence and head strides (the last axis contiguous): the
// model's layout, read in place.  Query head h reads KV head h / (H / Hkv),
// so GQA and MQA need no repeated copy of k and v (the reference's
// `jnp.repeat` and [N, S, D] transpose in ops.py).  out [B, Sq, H, DV]
// contiguous, lse [B, H, Sq].  DV = D but for MLA's prefill (models/mla.py),
// whose q and k carry 128 nope + 64 rope columns and v 128: the pair
// (D, DV) = (192, 128), the one other instantiation of both kernels.
//
// Dispatch by dtype, in `flash_attention_fwd` below: bf16 goes to the
// tensor-core kernel of flash_fwd_sm90.cuh (wgmma, TMA; see its note), and
// only there; float32 to the 3xTF32 kernel in this file.  Nothing falls
// back: a launch that is refused, or a stride TMA cannot take, returns an
// error.
//
// The float32 kernel.  It replaces a kernel on the FP32 CUDA cores whose
// loops were bounded by shared-memory loads (17 % of even the FP32-core
// bound at MLA's (192, 128); PERF.md).  Both products run on the tensor
// cores in 3xTF32 (flash_tf32x3_sm90.cuh, ../../csrc/tf32x3_sm90.cuh): each
// float32 operand split into TF32 hi + lo and each k8 step taken as
// lo·hi + hi·lo + hi·hi, ~2^-22 of each term, so the float32 bars hold.  The
// probabilities stay float32 for P·V, as in `flash_attention_ref` and the
// model's `attend_chunked` (the Pallas kernel rounds them to v's type
// first); they enter P·V split, as its A operand, in place.
//
// A block owns 64·NWG query rows of one (b, h), one consumer warpgroup of
// 64 rows each, and walks the key tiles of its band (the Pallas grid's
// sequential key axis; Hopper's blocks run in no order), each warpgroup
// keeping its m, l and 64 × DV accumulator in registers in the wgmma
// layout (a row lives in 4 lanes: two xor-shuffles per row max and sum).
// Per tile of BK keys the block's threads split K and V into the K-major
// tiles the products read: K [BK][D] for S = Q·Kᵀ and Vᵀ [DV][BK] for P·V
// (TF32 wgmma reads B only K-major).  Both warpgroups read each staged tile,
// so one split pass serves 128 rows, and one warpgroup's softmax runs
// under the other's wgmmas.  Grid (H, B, query tiles), the query tiles
// last-first, so the longest causal blocks start first.
//
// Configurations (FwdTile), every B tile doubled by hi + lo; BK = 64 at
// D = 32, else 32:
// * D <= 128: NWG = 2; Q split once into K-major tiles that S reads from
//   shared memory (wgmma with both operands in shared memory: every k8
//   step issued back to back); the next tile's raw K and V copied by
//   cp.async under this tile's products, then split shared to shared.
//   (128, 128): 226 KB.
// * (192, 128): NWG = 2, Q's raw rows staged once and split a k8 step at a
//   time into registers (its tiles would not fit beside two warpgroups),
//   the next tile prefetched: 222 KB.
// * (256, 256): NWG = 1, Q raw, K and V loaded from device memory 16
//   values a thread at a time (the 64 × 256 accumulator takes 128
//   registers a thread): 195 KB.
//
// Block skipping.  A block visits only the key tiles that meet its causal /
// window band: from the tile holding max(0, off + q0 - window + 1) up to its
// last query row's position; the tiles wholly outside the band are never
// loaded (a stripe at offset off visits at most off + q0 + 64·NWG keys).
// The tiles it skips would contribute exp(-1e30 - m) = 0 to every row, so
// this is the same function with less work.  The first warpgroup of a
// causal block also runs the tiles past its own rows, whose every entry it
// masks (no wgmma is issued under a branch).  Masked entries get p = 0
// explicitly; every row has at least its own key (j = i), so this equals
// the reference wherever the reference is defined.  Rows and keys past S (a
// ragged S, which the Pallas kernel refuses) are masked here.

#include "flash_common.cuh"
#include "flash_fwd_sm90.cuh"
#include "flash_tf32x3_sm90.cuh"

namespace {

using flash::attends;
using flash::kNegInf;
using namespace flash::tf32;

template <int D_, int DV_>
struct FwdTile {
  static constexpr int D = D_, DV = DV_;
  // Two consumer warpgroups share each staged K/V tile up to D = 192, one
  // at 256.  Up to D = 128 Q is split once into K-major tiles that the
  // products read from shared memory; above, its raw rows are split a k8
  // step at a time.  Up to 192 the next K/V tile is copied under this
  // one's products; at 256 K and V are staged from device memory.
  static constexpr int NWG = D <= 192 ? 2 : 1;
  static constexpr bool kQTiles = D <= 128, kPrefetch = D <= 192;
  // Up to D = 128 each tile's P·V is taken into a fresh accumulator, in
  // 64-column parts, and added to O in float32 (acc_product's FRESH: over a
  // long band the tensor cores' rounding toward zero of every accumulation
  // drifts O by up to 6e-6 at whisper's encoder, six times what fresh sums
  // leave, tests/_flash_emulation.py); above, the registers are not there.
  static constexpr bool kFresh = D <= 128;
  static constexpr int T = 128 * NWG;             // threads
  static constexpr int BK = D <= 32 ? 64 : 32;    // keys per tile
  static constexpr int kLdQ = D + 8;              // Q's raw rows (kQTiles false)
  static constexpr int kQ = kQTiles ? 2 * 64 * NWG * D : 64 * NWG * kLdQ;
  static constexpr int kTiles = 2 * BK * D + 2 * DV * BK;
  static constexpr int kRaw = kPrefetch ? Raw<BK, D>::kFloats + Raw<BK, DV>::kFloats : 0;
  static constexpr int kSmemBytes = 1024 + 4 * (kTiles + kQ + kRaw);
};

template <int D, int DV>
__global__ void __launch_bounds__(FwdTile<D, DV>::T, 1)
flash_fwd_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        float* __restrict__ lse, int Sq, int Sk, int off, int H, int Hkv,
                        long long qsb, long long qss, long long qsh,
                        long long ksb, long long kss, long long ksh,
                        long long vsb, long long vss, long long vsh,
                        int causal, int window, float scale) {
  using L = FwdTile<D, DV>;
  using WV = Width<DV, L::kFresh ? 64 : 128>;
  constexpr int BK = L::BK, NV = WV::N, T = L::T, kBQ = 64 * L::NWG;
  extern __shared__ uint8_t smem_raw[];
  float* const k_t = reinterpret_cast<float*>(align1024(smem_raw));  // K [BK][D], hi then lo
  float* const v_t = k_t + 2 * BK * D;                                 // Vᵀ [DV][BK]
  float* const qs = v_t + 2 * DV * BK;                                 // Q: tiles or raw rows
  float* const raw_k = qs + L::kQ;                                     // the next tile's K, V
  float* const raw_v = raw_k + Raw<BK, D>::kFloats;

  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / (H / Hkv);
  const float* const qb = q + b * qsb + h * qsh;
  const float* const kb = k + b * ksb + hk * ksh;
  const float* const vb = v + b * vsb + hk * vsh;
  const int p0 = off + q0;  // the block's first position
  const int k_end = causal ? min(Sk, p0 + kBQ) : Sk;
  const int k_first = window > 0 ? max(0, p0 - window + 1) : 0;
  const int k_begin = (k_first / BK) * BK;
  if constexpr (L::kPrefetch) {
    prefetch<BK, D, T>(raw_k, kb + k_begin * kss, kss, Sk - k_begin);
    prefetch<BK, DV, T>(raw_v, vb + k_begin * vss, vss, Sk - k_begin);
    cp_async_commit();
  }
  if constexpr (L::kQTiles) {
#pragma unroll
    for (int w = 0; w < L::NWG; ++w)
      stage<64, D, true, false, T, 8>(qs + w * 2 * 64 * D, nullptr, qb + (q0 + 64 * w) * qss,
                                      qss, Sq - q0 - 64 * w);
    fence_async_smem();
  } else {
    stage_raw<kBQ, D, T>(qs, L::kLdQ, qb + q0 * qss, qss, Sq - q0);
  }

  // Warpgroup wg holds rows r0 .. r0 + 63; this thread rows ra and ra + 8,
  // columns 8j + cq and 8j + cq + 1.
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, wg = threadIdx.x >> 7;
  const int r0 = q0 + 64 * wg;
  const int ra = r0 + 16 * warp + (lane >> 2);
  const int pr0 = off + r0, pa = off + ra;  // positions of rows r0 and ra
  const int cq = 2 * (lane & 3);
  const float* const my_q = qs + 64 * wg * (L::kQTiles ? 2 * D : L::kLdQ);

  float o[WV::kCount][NV / 2];
#pragma unroll
  for (int c = 0; c < WV::kCount; ++c)
#pragma unroll
    for (int e = 0; e < NV / 2; ++e) o[c][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    if constexpr (L::kPrefetch) {
      cp_async_wait_all();
      __syncthreads();  // this tile's raw K, V landed; every wgmma that read the last tiles is done
      stage<BK, D, true, false, T, BK * D / T>(k_t, nullptr, raw_k, Raw<BK, D>::kLd, BK);
      stage<BK, DV, false, true, T, BK * DV / T>(nullptr, v_t, raw_v, Raw<BK, DV>::kLd, BK);
      fence_async_smem();
      __syncthreads();  // the split tiles are visible to wgmma; the raw tiles are free
      if (k0 + BK < k_end) {  // the next tile's copies run under this tile's products
        prefetch<BK, D, T>(raw_k, kb + (k0 + BK) * kss, kss, Sk - k0 - BK);
        prefetch<BK, DV, T>(raw_v, vb + (k0 + BK) * vss, vss, Sk - k0 - BK);
      }
      cp_async_commit();
    } else {
      __syncthreads();  // Q staged; every wgmma that read the previous tiles has completed
      stage<BK, D, true, false, T, kDeviceBatch<BK, D, T>>(k_t, nullptr, kb + k0 * kss, kss,
                                                           Sk - k0);
      stage<BK, DV, false, true, T, kDeviceBatch<BK, DV, T>>(nullptr, v_t, vb + k0 * vss, vss,
                                                             Sk - k0);
      fence_async_smem();
      __syncthreads();
    }

    float sc[BK / 2];
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) sc[e] = 0.f;
    if constexpr (L::kQTiles)
      tiles_product<D, BK>(sc, my_q, k_t);
    else
      rows_product<D, BK, true>(sc, my_q, L::kLdQ, 64, k_t);

    // Online softmax over this tile, rows ra (e % 4 < 2) and ra + 8.
    const bool edge = (causal && k0 + BK - 1 > pr0) || (window > 0 && k0 <= pr0 + 63 - window) ||
                      k0 + BK > Sk;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      float x = sc[e] * scale;
      if (edge && !attends(pa + 8 * ((e / 2) % 2), k0 + 8 * (e / 4) + cq + (e % 2), Sk, causal,
                           window))
        x = kNegInf;
      sc[e] = x;
      mx[(e / 2) % 2] = fmaxf(mx[(e / 2) % 2], x);
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mx[r] = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int r = (e / 2) % 2;
      const bool in = !edge || attends(pa + 8 * r, k0 + 8 * (e / 4) + cq + (e % 2), Sk, causal,
                                       window);
      sc[e] = in ? expf(sc[e] - m[r]) : 0.f;
      rs[r] += sc[e];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * corr[r] + rs[r];
    }
#pragma unroll
    for (int c = 0; c < WV::kCount; ++c)
#pragma unroll
      for (int e = 0; e < NV / 2; ++e) o[c][e] *= corr[(e / 2) % 2];

    // O += P·V, P split in place.
    acc_product<BK, DV, NV, L::kFresh>(o, sc, v_t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    if (row < Sq) {
      const float lf = fmaxf(l[r], 1e-30f);
      float* ob = out + ((static_cast<long long>(b) * Sq + row) * H + h) * DV;
#pragma unroll
      for (int c = 0; c < WV::kCount; ++c)
#pragma unroll
        for (int j = 0; j < NV / 8; ++j)
          *reinterpret_cast<float2*>(ob + c * NV + 8 * j + cq) =
              make_float2(o[c][4 * j + 2 * r] / lf, o[c][4 * j + 2 * r + 1] / lf);
      if ((lane & 3) == 0) lse[(static_cast<long long>(b) * H + h) * Sq + row] = m[r] + logf(lf);
    }
  }
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B,
           int Sq, int Sk, int off, int H, int Hkv, const long long* st, int causal,
           int window, float scale, cudaStream_t stream) {
  using L = FwdTile<D, DV>;
  auto* fn = flash_fwd_tf32x3_kernel<D, DV>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (Sq + 64 * L::NWG - 1) / (64 * L::NWG));
  fn<<<grid, L::T, L::kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, Sq, Sk, off, H, Hkv, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], causal, window, scale);
  return cudaGetLastError();
}

// (D, DV) packed as one switch key.
constexpr int pair(int d, int dv) { return d * 1024 + dv; }

int dispatch(int d, int dv, int dtype, const void* q, const void* k, const void* v,
             void* out, float* lse, int B, int Sq, int Sk, int off, int H, int Hkv,
             const long long* st, int causal, int window, float scale, cudaStream_t stream) {
  using flash::sm90::launch_fwd;
  if (dtype == 1) {
    switch (pair(d, dv)) {
      case pair(32, 32): return launch_fwd<32, 32>(q, k, v, out, lse, B, Sq, Sk, off, H, Hkv, st, causal, window, scale, stream);
      case pair(64, 64): return launch_fwd<64, 64>(q, k, v, out, lse, B, Sq, Sk, off, H, Hkv, st, causal, window, scale, stream);
      case pair(128, 128): return launch_fwd<128, 128>(q, k, v, out, lse, B, Sq, Sk, off, H, Hkv, st, causal, window, scale, stream);
      case pair(256, 256): return launch_fwd<256, 256>(q, k, v, out, lse, B, Sq, Sk, off, H, Hkv, st, causal, window, scale, stream);
      case pair(192, 128): return launch_fwd<192, 128>(q, k, v, out, lse, B, Sq, Sk, off, H, Hkv, st, causal, window, scale, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype != 0) return cudaErrorInvalidValue;
  switch (pair(d, dv)) {
    case pair(32, 32): return launch<32, 32>(q, k, v, out, lse, B, Sq, Sk, off, H, Hkv, st, causal, window, scale, stream);
    case pair(64, 64): return launch<64, 64>(q, k, v, out, lse, B, Sq, Sk, off, H, Hkv, st, causal, window, scale, stream);
    case pair(128, 128): return launch<128, 128>(q, k, v, out, lse, B, Sq, Sk, off, H, Hkv, st, causal, window, scale, stream);
    case pair(256, 256): return launch<256, 256>(q, k, v, out, lse, B, Sq, Sk, off, H, Hkv, st, causal, window, scale, stream);
    case pair(192, 128): return launch<192, 128>(q, k, v, out, lse, B, Sq, Sk, off, H, Hkv, st, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// B7 forward.  dtype 0 = float32 (the 3xTF32 kernel above), 1 = bf16 (the
// bf16 tensor-core kernel); q, k, v and out share it.  strides: q's batch,
// sequence and head strides, then k's, then v's, in elements (bf16: base
// addresses 16-byte aligned, strides multiples of 8 elements, for TMA).
// window <= 0 means no window.  D is q's and k's head size, DV v's and
// out's.  Sq query rows (q, out, lse) at positions q_offset + i against Sk
// keys (k, v), 0 <= q_offset <= Sk - Sq.  Launches on `stream`; returns cudaGetLastError() (0 = launched),
// or cudaErrorInvalidValue for head sizes other than (32, 32), (64, 64),
// (128, 128), (256, 256) or (192, 128), H not a multiple of Hkv, a stripe
// outside the keys, another dtype, or a bf16 stride or address TMA cannot
// take.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                   void* out, float* lse, int B, int Sq, int Sk, int q_offset,
                                   int H, int Hkv, int D, int DV, const long long* strides,
                                   int causal, int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Hkv <= 0 || H % Hkv != 0 || q_offset < 0 || Sq + q_offset > Sk)
    return cudaErrorInvalidValue;
  return dispatch(D, DV, dtype, q, k, v, out, lse, B, Sq, Sk, q_offset, H, Hkv, strides, causal,
                  window, scale, static_cast<cudaStream_t>(stream));
}
