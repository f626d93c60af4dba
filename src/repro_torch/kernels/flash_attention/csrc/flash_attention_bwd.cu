// Causal, optionally windowed, flash attention backward on Hopper (sm_90a):
// the entry point of B8 and its float32 kernels, 3xTF32 on the tensor cores.
//
// Replaces the Pallas TPU kernels `flash_attention_bwd_kernels` of
// src/repro/kernels/flash_attention/kernel.py (B8: `_dq_kernel` and
// `_dkv_kernel`, two pallas_calls); this file holds its entry point and its
// float32 kernels.  Given q, k, v, the output gradient dO,
// the forward's float32 row log-sum-exp `lse` and dvec = rowsum(dO∘O), for
// every batch b and query head h (KV head hk = h / (H / Hkv)):
//
//     p_ij  = exp(s_ij - lse_i),  s_ij = (q_i · k_j) · D^-1/2, and p_ij = 0
//             unless j <= i (causal), j > i - window (a window > 0) and
//             i, j < S
//     ds_ij = p_ij · (dO_i · v_j - dvec_i)
//     dq_i  = D^-1/2 · Σ_j ds_ij k_j
//     dk_j  = D^-1/2 · Σ_{h in hk's group} Σ_i ds_ij q_i
//     dv_j  =          Σ_{h in hk's group} Σ_i p_ij dO_i
//
// A query stripe (flash_attention.cu's note): Sq query rows (q, dO, dq,
// lse, dvec) at positions off + i against Sk keys (k, v, dk, dv); i above
// is the row's position.  The dq kernel's key band and the dk/dv kernel's
// query band are the forward's, at those positions: a key block none of
// the stripe's rows attends writes zeros.  With off = 0 and Sq = Sk every
// index is the square case's.
//
// Dispatch by dtype, in `flash_attention_bwd` below: bf16 goes to the
// tensor-core kernels of flash_bwd_sm90.cuh (wgmma, TMA; see its note), and
// only there; float32 to the 3xTF32 kernels in this file.  Nothing falls
// back: a launch that is refused, or a stride TMA cannot take, returns an
// error.  dq, dk and dv are written once, in q's type.
//
// Design. It replaces kernels on the FP32 CUDA cores bounded by shared-memory
// loads (12 % of even the FP32-core bound at MLA's (192, 128), the dk/dv
// kernel spilling; PERF.md). Two kernels, as the Pallas pair and the bf16
// route: the TPU carries dq (and dk, dv) in VMEM along a sequential grid
// axis, and Hopper's blocks run in no order, so each block owns its output
// tile and loops over the other axis itself. Every product runs on the tensor
// cores in 3xTF32 (flash_tf32x3_sm90.cuh: operands split into TF32 hi + lo,
// each k8 step lo·hi + hi·lo + hi·hi, ~2^-22 of each term), one warpgroup a
// block, its threads staging each tile from device memory (any strides),
// split, as the K-major tiles that TF32 wgmma reads. P and dS enter the next
// product split, in place, as its A operand.
//
// * dq: a block per (b, h, 64 query rows), grid (H, B, query tiles) last
//   first.  Q and dO stay; per tile of BK keys of its band it stages K
//   [BK][D] and Kᵀ [D][BK] (one load of each element, both layouts) and V
//   [BK][DV]; S = Q·Kᵀ and dP = dO·Vᵀ side by side in one commit group a
//   step, ds = p∘(dp - dvec) with p = exp(s·D^-½ - lse) in the band, then
//   dQ += dS·K.  Three products.
// * dk, dv: a block per (b, KV head, 64 key rows), grid (Hkv, B, key
//   tiles).  K and V stay; it walks the G = H / Hkv query heads of its
//   group and, for each, the 32-row query tiles of the band, in a fixed
//   order, staging Q [BQ][D] and Qᵀ, dO [BQ][DV] and dOᵀ: Sᵀ = K·Qᵀ beside
//   dPᵀ = V·dOᵀ, then dV += Pᵀ·dO and dK += dSᵀ·Q.  The group sum is a
//   fixed sequence of accumulations: no float atomics, and a repeat is
//   bit-identical.  At D = 256 and at MLA's (192, 128) one launch's tiles
//   and two accumulators do not fit, so dk and dv are two launches of this
//   kernel (the dv launch recomputes Sᵀ and stages neither Qᵀ nor dO), as
//   flash_bwd_sm90.cuh splits them.
// * dQ, dK and dV sum each tile's product in a fresh accumulator, added to
//   theirs in float32: the tensor cores round each accumulation toward zero,
//   and over the thousands of steps of a band that drifts past the
//   per-element bar (flash_tf32x3_sm90.cuh, `acc_product`).
//
// Configurations (DqTile, DkvTile), every staged tile doubled by hi + lo;
// BK = 64 at D = 32, else 32; BQ = 32.  The operands that stay (Q, dO; K,
// V) are split once into K-major tiles read from shared memory where they
// fit (dq at D = 128), else staged raw and split a k8 step at a time into
// registers (`rows_product`), at D = 256 read so from device memory.  The
// next tile's raw rows are copied by cp.async under this tile's products
// where shared memory holds them without costing a block an SM
// (`prefetch_pays`: dq at 64; dv at (192, 128)); elsewhere they are loaded
// from device memory, 16 values a thread at a time.  Shared memory: dq
// (128, 128) 225 KB, (192, 128) 213 KB; dk/dv (128, 128) 197 KB, (192, 128)
// dk 213 KB and dv 173 KB.  ptxas spills at D = 256 (recurrentgemma's head
// size) and in the (128, 128) dk/dv kernel: PERF.md lists the bytes.
//
// What bounds it.  Five products over the band, seven with the
// recomputations (dq: S, dP, dQ; dk/dv: Sᵀ, dPᵀ, dV, dK), each three TF32
// products: tensor-core work at a third of the TF32 rate.  One warpgroup a
// block, mostly one block an SM: the staging (a load, two conversions and
// two shared stores per element and layout) and the softmax run between
// the products, with no other warpgroup's wgmmas under them.

#include "flash_bwd_sm90.cuh"
#include "flash_common.cuh"
#include "flash_tf32x3_sm90.cuh"

namespace {

using flash::attends;
using namespace flash::tf32;

struct Args {
  int Sq, Sk, off, H, Hkv, causal, window;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  float scale;
};

constexpr int kSmemLimit = 232448;  // a block's shared memory on an H100
constexpr int kSmemPerSm = 233472;  // an SM's, with 1,024 bytes reserved a block

// Whether the next tile's copies get their own shared memory: where they fit
// and cost no block an SM (at D = 64 two blocks an SM beat one with them).
constexpr bool prefetch_pays(int plain_bytes, int next_bytes) {
  return plain_bytes + next_bytes <= kSmemLimit &&
         kSmemPerSm / (plain_bytes + next_bytes + 1024) == kSmemPerSm / (plain_bytes + 1024);
}

template <int D_, int DV_>
struct DqTile {
  static constexpr int D = D_, DV = DV_;
  static constexpr int BK = D <= 32 ? 64 : 32;   // keys per tile
  // Q and dO split once into K-major tiles read by the products from shared
  // memory (kTiles), or their raw rows split a k8 step at a time (kRaw), or,
  // at D = 256, those rows read from device memory.
  static constexpr bool kTiles = D == 128;
  static constexpr bool kRaw = !kTiles && D < 256;
  static constexpr int kLdQ = D + 8, kLdO = DV + 8;
  static constexpr int kQO = kTiles ? 2 * 64 * (D + DV) : (kRaw ? 64 * (kLdQ + kLdO) : 0);
  static constexpr int kBase = 2 * BK * (2 * D + DV) + kQO;
  static constexpr int kNext = Raw<BK, D>::kFloats + Raw<BK, DV>::kFloats;
  // The next tile's K and V copied by cp.async under this tile's products.
  static constexpr bool kPrefetch = D < 256 && prefetch_pays(1024 + 4 * kBase, 4 * kNext);
  static constexpr int kSmemBytes = 1024 + 4 * (kBase + (kPrefetch ? kNext : 0));
};

// WITH_DK: the launch computes dk (and needs V, dO for dPᵀ and Qᵀ); WITH_DV: dv.
template <int D_, int DV_, bool WITH_DK_, bool WITH_DV_>
struct DkvTile {
  static constexpr int D = D_, DV = DV_, BQ = 32;  // query rows per tile
  static constexpr bool WITH_DK = WITH_DK_, WITH_DV = WITH_DV_;
  static constexpr bool kRaw = D < 256;            // K's and V's raw rows in shared memory
  static constexpr int kLdK = D + 8, kLdV = DV + 8;
  static constexpr int kQ = 2 * BQ * D;            // floats of Q [BQ][D], hi and lo (and of Qᵀ)
  static constexpr int kO = 2 * BQ * DV;           // of dO [BQ][DV] (and of dOᵀ)
  static constexpr int kBase = kQ + (WITH_DK ? kQ + kO : 0) + (WITH_DV ? kO : 0) +
                               (kRaw ? 64 * kLdK + (WITH_DK ? 64 * kLdV : 0) : 0) + 2 * BQ;
  static constexpr int kNext = Raw<BQ, D>::kFloats + Raw<BQ, DV>::kFloats + 2 * BQ;
  // The next query tile's Q, dO, lse and dvec copied by cp.async under this
  // tile's products.
  static constexpr bool kPrefetch = D < 256 && prefetch_pays(1024 + 4 * kBase, 4 * kNext);
  static constexpr int kSmemBytes = 1024 + 4 * (kBase + (kPrefetch ? kNext : 0));
};

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dO,
                           const float* __restrict__ lse, const float* __restrict__ dvec,
                           float* __restrict__ dq, Args a) {
  using L = DqTile<D, DV>;
  using WD = Width<D, 64>;
  constexpr int BK = L::BK, ND = WD::N;
  extern __shared__ uint8_t smem_raw[];
  float* const k_t = reinterpret_cast<float*>(align1024(smem_raw));  // K [BK][D], hi then lo
  float* const kt_t = k_t + 2 * BK * D;                                // Kᵀ [D][BK]
  float* const v_t = kt_t + 2 * D * BK;                                // V [BK][DV]
  float* const qs = v_t + 2 * BK * DV;                                 // Q, dO: tiles or raw rows
  float* const os = qs + (L::kTiles ? 2 * 64 * D : 64 * L::kLdQ);
  float* const raw_k = qs + L::kQO;                                    // the next tile's K, V
  float* const raw_v = raw_k + Raw<BK, D>::kFloats;

  const int Sq = a.Sq, Sk = a.Sk, H = a.H;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * 64;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / (H / a.Hkv);
  const float* const qb = q + b * a.qsb + h * a.qsh + q0 * a.qss;
  const float* const kb = k + b * a.ksb + hk * a.ksh;
  const float* const vb = v + b * a.vsb + hk * a.vsh;
  const long long hdv = static_cast<long long>(H) * DV;  // dO's sequence stride
  const float* const ob = dO + (static_cast<long long>(b) * Sq + q0) * hdv +
                          static_cast<long long>(h) * DV;
  const int p0 = a.off + q0;  // the block's first position
  const int k_end = a.causal ? min(Sk, p0 + 64) : Sk;
  const int k_first = a.window > 0 ? max(0, p0 - a.window + 1) : 0;
  const int k_begin = (k_first / BK) * BK;
  if constexpr (L::kPrefetch) {
    prefetch<BK, D, kThreads>(raw_k, kb + k_begin * a.kss, a.kss, Sk - k_begin);
    prefetch<BK, DV, kThreads>(raw_v, vb + k_begin * a.vss, a.vss, Sk - k_begin);
    cp_async_commit();
  }
  const float* qa = qb;
  const float* oa = ob;
  long long ldq = a.qss, ldo = hdv;
  if constexpr (L::kTiles) {
    stage<64, D, true, false, kThreads, 8>(qs, nullptr, qb, a.qss, Sq - q0);
    stage<64, DV, true, false, kThreads, 8>(os, nullptr, ob, hdv, Sq - q0);
    fence_async_smem();
  } else if constexpr (L::kRaw) {
    stage_raw<64, D, kThreads>(qs, L::kLdQ, qb, a.qss, Sq - q0);
    stage_raw<64, DV, kThreads>(os, L::kLdO, ob, hdv, Sq - q0);
    qa = qs;
    oa = os;
    ldq = L::kLdQ;
    ldo = L::kLdO;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ra = q0 + 16 * warp + (lane >> 2);  // rows ra and ra + 8
  const int pa = a.off + ra;                    // the position of row ra
  const int cq = 2 * (lane & 3);
  const long long row0 = (static_cast<long long>(b) * H + h) * Sq;
  float lse_r[2], dvec_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    lse_r[r] = row < Sq ? lse[row0 + row] : 0.f;
    dvec_r[r] = row < Sq ? dvec[row0 + row] : 0.f;
  }

  float acc[WD::kCount][ND / 2];
#pragma unroll
  for (int c = 0; c < WD::kCount; ++c)
#pragma unroll
    for (int e = 0; e < ND / 2; ++e) acc[c][e] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    if constexpr (L::kPrefetch) {
      cp_async_wait_all();
      __syncthreads();  // this tile's raw K, V landed; every wgmma that read the last tiles is done
      stage<BK, D, true, true, kThreads, 8>(k_t, kt_t, raw_k, Raw<BK, D>::kLd, BK);
      stage<BK, DV, true, false, kThreads, 8>(v_t, nullptr, raw_v,
                                                               Raw<BK, DV>::kLd, BK);
      fence_async_smem();
      __syncthreads();  // the split tiles are visible to wgmma; the raw tiles are free
      if (k0 + BK < k_end) {  // the next tile's copies run under this tile's products
        prefetch<BK, D, kThreads>(raw_k, kb + (k0 + BK) * a.kss, a.kss, Sk - k0 - BK);
        prefetch<BK, DV, kThreads>(raw_v, vb + (k0 + BK) * a.vss, a.vss, Sk - k0 - BK);
      }
      cp_async_commit();
    } else {
      __syncthreads();  // Q, dO staged; every wgmma that read the previous tiles has completed
      stage<BK, D, true, true, kThreads, kDeviceBatch<BK, D, kThreads>>(
          k_t, kt_t, kb + k0 * a.kss, a.kss, Sk - k0);
      stage<BK, DV, true, false, kThreads, kDeviceBatch<BK, DV, kThreads>>(
          v_t, nullptr, vb + k0 * a.vss, a.vss, Sk - k0);
      fence_async_smem();
      __syncthreads();
    }

    // S = Q·Kᵀ over D, dP = dO·Vᵀ over DV.
    float sc[BK / 2], dp[BK / 2];
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) sc[e] = dp[e] = 0.f;
    if constexpr (L::kTiles)
      tiles_product2<D, DV, BK>(sc, qs, k_t, dp, os, v_t);
    else
      rows_product2<D, DV, BK, L::kRaw>(sc, qa, ldq, k_t, dp, oa, ldo, v_t, Sq - q0);

    // ds = p∘(dp - dvec), p = exp(s·scale - lse) in the band, into dp.
    const bool edge = (a.causal && k0 + BK - 1 > p0) ||
                      (a.window > 0 && k0 <= p0 + 63 - a.window) || k0 + BK > Sk;
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int r = (e / 2) % 2;
      const bool in = !edge || attends(pa + 8 * r, k0 + 8 * (e / 4) + cq + (e % 2), Sk, a.causal,
                                       a.window);
      const float p = in ? expf(sc[e] * a.scale - lse_r[r]) : 0.f;
      dp[e] = p * (dp[e] - dvec_r[r]);
    }

    // dQ += dS·K, dS split in place.
    acc_product<BK, D, ND, true>(acc, dp, kt_t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    if (row < Sq) {
      float* out = dq + ((static_cast<long long>(b) * Sq + row) * H + h) * D;
#pragma unroll
      for (int c = 0; c < WD::kCount; ++c)
#pragma unroll
        for (int j = 0; j < ND / 8; ++j)
          *reinterpret_cast<float2*>(out + c * ND + 8 * j + cq) =
              make_float2(a.scale * acc[c][4 * j + 2 * r], a.scale * acc[c][4 * j + 2 * r + 1]);
    }
  }
}

template <class L>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dO,
                            const float* __restrict__ lse, const float* __restrict__ dvec,
                            float* __restrict__ dk, float* __restrict__ dv, Args a) {
  constexpr int D = L::D, DV = L::DV, BQ = L::BQ;
  constexpr bool WITH_DK = L::WITH_DK, WITH_DV = L::WITH_DV;
  using WD = Width<D, 64>;
  using WV = Width<DV, 64>;
  constexpr int ND = WD::N, NV = WV::N;
  extern __shared__ uint8_t smem_raw[];
  float* const q_t = reinterpret_cast<float*>(align1024(smem_raw));  // Q [BQ][D], hi then lo
  float* const qt_t = q_t + L::kQ;                                     // Qᵀ [D][BQ] (dk)
  float* const o_t = qt_t + (WITH_DK ? L::kQ : 0);                     // dO [BQ][DV] (dk)
  float* const ot_t = o_t + (WITH_DK ? L::kO : 0);                     // dOᵀ [DV][BQ] (dv)
  float* const ks = ot_t + (WITH_DV ? L::kO : 0);                      // raw rows of K, V
  float* const vs = ks + (L::kRaw ? 64 * L::kLdK : 0);
  float* const lse_s = vs + (L::kRaw && WITH_DK ? 64 * L::kLdV : 0);
  float* const dvec_s = lse_s + BQ;
  float* const raw_q = dvec_s + BQ;                  // the next tile's Q, dO, lse, dvec
  float* const raw_o = raw_q + Raw<BQ, D>::kFloats;
  float* const raw_l = raw_o + Raw<BQ, DV>::kFloats;

  const int Sq = a.Sq, Sk = a.Sk, H = a.H, Hkv = a.Hkv, G = H / Hkv;
  const int k0 = blockIdx.z * 64;    // the first key tiles have the longest causal bands
  const int hk = blockIdx.x, b = blockIdx.y;
  const float* const kb = k + b * a.ksb + hk * a.ksh + k0 * a.kss;
  const float* const vb = v + b * a.vsb + hk * a.vsh + k0 * a.vss;
  const float* ka = kb;
  const float* va = vb;
  long long ldk = a.kss, ldv = a.vss;
  if constexpr (L::kRaw) {
    stage_raw<64, D, kThreads>(ks, L::kLdK, kb, a.kss, Sk - k0);
    if constexpr (WITH_DK) stage_raw<64, DV, kThreads>(vs, L::kLdV, vb, a.vss, Sk - k0);
    ka = ks;
    va = vs;
    ldk = L::kLdK;
    ldv = L::kLdV;
  }
  const long long hdv = static_cast<long long>(H) * DV;  // dO's sequence stride

  // Query rows that attend a key of this block: position off + i >= k0 when
  // causal, and off + i < k0 + 63 + window when a window is given; a block
  // of keys past the stripe's last position has none.
  const int q_first = a.causal ? max(0, k0 - a.off) : 0;
  const int q_end = a.window > 0 ? min(Sq, k0 + 63 + a.window - a.off) : Sq;
  const int tq0 = q_first / BQ;
  const int nq = max(0, (q_end + BQ - 1) / BQ - tq0);
  const int n_tiles = G * nq;

  // This thread holds keys ka and ka + 8 and query columns 8j + cq, 8j + cq + 1 of a tile.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kj0 = k0 + 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);

  float acc_k[WITH_DK ? WD::kCount : 1][ND / 2];
  float acc_v[WITH_DV ? WV::kCount : 1][NV / 2];
  if constexpr (WITH_DK) {
#pragma unroll
    for (int c = 0; c < WD::kCount; ++c)
#pragma unroll
      for (int e = 0; e < ND / 2; ++e) acc_k[c][e] = 0.f;
  }
  if constexpr (WITH_DV) {
#pragma unroll
    for (int c = 0; c < WV::kCount; ++c)
#pragma unroll
      for (int e = 0; e < NV / 2; ++e) acc_v[c][e] = 0.f;
  }

  // Query tile i: head hk·G + i / nq, rows from (tq0 + i % nq)·BQ.
  auto tile_src = [&](int i, const float** qb, const float** ob, long long* row0, int* q0) {
    const int h = hk * G + i / nq;
    *q0 = (tq0 + i % nq) * BQ;
    *qb = q + b * a.qsb + h * a.qsh + *q0 * a.qss;
    *ob = dO + (static_cast<long long>(b) * Sq + *q0) * hdv + static_cast<long long>(h) * DV;
    *row0 = (static_cast<long long>(b) * H + h) * Sq;
  };
  auto prefetch_tile = [&](int i) {
    const float *qb, *ob;
    long long row0;
    int q0;
    tile_src(i, &qb, &ob, &row0, &q0);
    prefetch<BQ, D, kThreads>(raw_q, qb, a.qss, Sq - q0);
    prefetch<BQ, DV, kThreads>(raw_o, ob, hdv, Sq - q0);
    if (threadIdx.x < BQ) {
      const int qi = q0 + threadIdx.x;
      if (qi < Sq) {
        cp_async4(raw_l + threadIdx.x, lse + row0 + qi);
        if (WITH_DK) cp_async4(raw_l + BQ + threadIdx.x, dvec + row0 + qi);
      } else {
        raw_l[threadIdx.x] = raw_l[BQ + threadIdx.x] = 0.f;
      }
    }
  };
  if constexpr (L::kPrefetch) {
    if (n_tiles > 0) prefetch_tile(0);
    cp_async_commit();
  }

  for (int i = 0; i < n_tiles; ++i) {
    const float *qb, *ob;
    long long row0;
    int q0;
    tile_src(i, &qb, &ob, &row0, &q0);
    if constexpr (L::kPrefetch) {
      cp_async_wait_all();
      __syncthreads();  // this tile's raw Q, dO landed; every wgmma reading the last tiles is done
      stage<BQ, D, true, WITH_DK, kThreads, 8>(q_t, qt_t, raw_q,
                                                                Raw<BQ, D>::kLd, BQ);
      if constexpr (WITH_DK)
        stage<BQ, DV, true, WITH_DV, kThreads, 8>(o_t, ot_t, raw_o,
                                                                    Raw<BQ, DV>::kLd, BQ);
      else
        stage<BQ, DV, false, true, kThreads, 8>(nullptr, ot_t, raw_o,
                                                                  Raw<BQ, DV>::kLd, BQ);
      if (threadIdx.x < BQ) {
        lse_s[threadIdx.x] = raw_l[threadIdx.x];
        dvec_s[threadIdx.x] = raw_l[BQ + threadIdx.x];
      }
      fence_async_smem();
      __syncthreads();  // the split tiles are visible to wgmma; the raw tiles are free
      if (i + 1 < n_tiles) prefetch_tile(i + 1);  // under this tile's products
      cp_async_commit();
    } else {
      __syncthreads();  // K, V staged; every wgmma that read the previous tiles has completed
      stage<BQ, D, true, WITH_DK, kThreads, kDeviceBatch<BQ, D, kThreads>>(q_t, qt_t, qb, a.qss,
                                                                           Sq - q0);
      if constexpr (WITH_DK)
        stage<BQ, DV, true, WITH_DV, kThreads, kDeviceBatch<BQ, DV, kThreads>>(o_t, ot_t, ob, hdv,
                                                                               Sq - q0);
      else
        stage<BQ, DV, false, true, kThreads, kDeviceBatch<BQ, DV, kThreads>>(nullptr, ot_t, ob,
                                                                             hdv, Sq - q0);
      if (threadIdx.x < BQ) {
        const int qi = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qi < Sq ? lse[row0 + qi] : 0.f;
        dvec_s[threadIdx.x] = WITH_DK && qi < Sq ? dvec[row0 + qi] : 0.f;
      }
      fence_async_smem();
      __syncthreads();
    }

    // Sᵀ = K·Qᵀ over D, dPᵀ = V·dOᵀ over DV.
    float st[BQ / 2], dpt[WITH_DK ? BQ / 2 : 1];
#pragma unroll
    for (int e = 0; e < BQ / 2; ++e) {
      st[e] = 0.f;
      if constexpr (WITH_DK) dpt[e] = 0.f;
    }
    if constexpr (WITH_DK)  // two sets of fragments where dK and dV both stay in registers
      rows_product2<D, DV, BQ, L::kRaw, WITH_DV ? 2 : kSets>(st, ka, ldk, q_t, dpt, va, ldv,
                                                              o_t, Sk - k0);
    else
      rows_product<D, BQ, L::kRaw>(st, ka, ldk, Sk - k0, q_t);

    // pᵀ (into st) and dsᵀ = pᵀ∘(dpᵀ - dvec) (into dpt); the column is the
    // query i, the row the key j.
    const int pq0 = a.off + q0;  // the tile's first position
    const bool edge = (a.causal && pq0 < k0 + 63) ||
                      (a.window > 0 && pq0 + BQ - 1 >= k0 + a.window) || q0 + BQ > Sq ||
                      k0 + 64 > Sk;
#pragma unroll
    for (int e = 0; e < BQ / 2; ++e) {
      const int c = 8 * (e / 4) + cq + (e % 2), qi = q0 + c;
      const int kj = kj0 + 8 * ((e / 2) % 2);
      const bool in = !edge || (qi < Sq && attends(a.off + qi, kj, Sk, a.causal, a.window));
      st[e] = in ? expf(st[e] * a.scale - lse_s[c]) : 0.f;
      if constexpr (WITH_DK) dpt[e] = st[e] * (dpt[e] - dvec_s[c]);
    }

    if constexpr (WITH_DV) acc_product<BQ, DV, NV, true>(acc_v, st, ot_t);  // dV += Pᵀ·dO
    if constexpr (WITH_DK) acc_product<BQ, D, ND, true>(acc_k, dpt, qt_t);  // dK += dSᵀ·Q
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kj0 + 8 * r;
    if (row < Sk) {
      const long long o = (static_cast<long long>(b) * Sk + row) * Hkv + hk;
      if constexpr (WITH_DK) {
#pragma unroll
        for (int c = 0; c < WD::kCount; ++c)
#pragma unroll
          for (int j = 0; j < ND / 8; ++j)
            *reinterpret_cast<float2*>(dk + o * D + c * ND + 8 * j + cq) =
                make_float2(a.scale * acc_k[c][4 * j + 2 * r],
                            a.scale * acc_k[c][4 * j + 2 * r + 1]);
      }
      if constexpr (WITH_DV) {
#pragma unroll
        for (int c = 0; c < WV::kCount; ++c)
#pragma unroll
          for (int j = 0; j < NV / 8; ++j)
            *reinterpret_cast<float2*>(dv + o * DV + c * NV + 8 * j + cq) =
                make_float2(acc_v[c][4 * j + 2 * r], acc_v[c][4 * j + 2 * r + 1]);
      }
    }
  }
}

template <class L>
int launch_dkv(const float* q, const float* k, const float* v, const float* dO, const float* lse,
               const float* dvec, void* dk, void* dv, int B, const Args& a, cudaStream_t stream) {
  auto* fn = flash_bwd_dkv_tf32x3_kernel<L>;
  const cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes);
  if (err != cudaSuccess) return err;
  fn<<<dim3(a.Hkv, B, (a.Sk + 63) / 64), kThreads, L::kSmemBytes, stream>>>(
      q, k, v, dO, lse, dvec, static_cast<float*>(dk), static_cast<float*>(dv), a);
  return cudaGetLastError();
}

// Launch B8's float32 kernels: dq, then dk/dv, as two launches (dk, then
// dv) where one would not fit: at D = 256 and at MLA's (192, 128).
template <int D, int DV>
int launch(const void* q, const void* k, const void* v, const void* dO, const float* lse,
           const float* dvec, void* dq, void* dk, void* dv, int B, const Args& a,
           cudaStream_t stream) {
  constexpr bool kSplit = D == 256 || D != DV;
  using Q = DqTile<D, DV>;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* ot = static_cast<const float*>(dO);
  auto* dq_fn = flash_bwd_dq_tf32x3_kernel<D, DV>;
  cudaError_t err =
      cudaFuncSetAttribute(dq_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, Q::kSmemBytes);
  if (err != cudaSuccess) return err;
  dq_fn<<<dim3(a.H, B, (a.Sq + 63) / 64), kThreads, Q::kSmemBytes, stream>>>(
      qt, kt, vt, ot, lse, dvec, static_cast<float*>(dq), a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int e = launch_dkv<DkvTile<D, DV, true, !kSplit>>(qt, kt, vt, ot, lse, dvec, dk, dv, B, a,
                                                      stream);
  if constexpr (kSplit) {
    if (!e)
      e = launch_dkv<DkvTile<D, DV, false, true>>(qt, kt, vt, ot, lse, dvec, dk, dv, B, a,
                                                    stream);
  }
  return e;
}

// (D, DV) packed as one switch key.
constexpr int pair(int d, int dv) { return d * 1024 + dv; }

int dispatch(int d, int dv, int dtype, const void* q, const void* k, const void* v,
             const void* dO, const float* lse, const float* dvec, void* dq, void* dk, void* dv_out,
             int B, const Args& a, const long long* st, cudaStream_t stream) {
  using flash::sm90::launch_bwd;
  if (dtype == 1) {
#define FLASH_BWD_SM90(D, DV)                                                              \
  launch_bwd<D, DV>(q, k, v, dO, lse, dvec, dq, dk, dv_out, B, a.Sq, a.Sk, a.off, a.H, a.Hkv, \
                    st, a.causal, a.window, a.scale, stream)
    switch (pair(d, dv)) {
      case pair(32, 32): return FLASH_BWD_SM90(32, 32);
      case pair(64, 64): return FLASH_BWD_SM90(64, 64);
      case pair(128, 128): return FLASH_BWD_SM90(128, 128);
      case pair(256, 256): return FLASH_BWD_SM90(256, 256);
      case pair(192, 128): return FLASH_BWD_SM90(192, 128);
      default: return cudaErrorInvalidValue;
    }
#undef FLASH_BWD_SM90
  }
  if (dtype != 0) return cudaErrorInvalidValue;
#define FLASH_BWD_TF32X3(D, DV) launch<D, DV>(q, k, v, dO, lse, dvec, dq, dk, dv_out, B, a, stream)
  switch (pair(d, dv)) {
    case pair(32, 32): return FLASH_BWD_TF32X3(32, 32);
    case pair(64, 64): return FLASH_BWD_TF32X3(64, 64);
    case pair(128, 128): return FLASH_BWD_TF32X3(128, 128);
    case pair(256, 256): return FLASH_BWD_TF32X3(256, 256);
    case pair(192, 128): return FLASH_BWD_TF32X3(192, 128);
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_BWD_TF32X3
}

}  // namespace

// B8.  dtype 0 = float32 (the 3xTF32 kernels above), 1 = bf16 (the bf16
// tensor-core kernels); q, k, v, dO, dq, dk and dv share it.  D is q's, k's,
// dq's and dk's head size, DV v's, dO's and dv's.  strides: q's batch,
// sequence and head strides, then k's, then v's, in elements (bf16: base
// addresses 16-byte aligned, strides multiples of 8 elements, for TMA); dO,
// lse, dvec, dq, dk and dv are contiguous.  window <= 0 means no window.
// Sq query rows (q, dO, dq, lse, dvec) at positions q_offset + i against Sk
// keys (k, v, dk, dv), 0 <= q_offset <= Sk - Sq.
// Launches the dq kernel, then the dk/dv kernel(s), on `stream`; returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for head sizes
// other than (32, 32), (64, 64), (128, 128), (256, 256) or (192, 128), H not
// a multiple of Hkv, a stripe outside the keys, another dtype, or a bf16
// stride or address TMA cannot take.
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                   const void* dO, const float* lse, const float* dvec,
                                   void* dq, void* dk, void* dv, int B, int Sq, int Sk,
                                   int q_offset, int H, int Hkv, int D, int DV,
                                   const long long* strides, int causal, int window, float scale,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Hkv <= 0 || H % Hkv != 0 || q_offset < 0 || Sq + q_offset > Sk)
    return cudaErrorInvalidValue;
  const Args a{Sq, Sk, q_offset, H, Hkv, causal, window,
               strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
               strides[6], strides[7], strides[8], scale};
  return dispatch(D, DV, dtype, q, k, v, dO, lse, dvec, dq, dk, dv, B, a, strides,
                  static_cast<cudaStream_t>(stream));
}
