// B8's bf16 path: the flash-attention backward on Hopper's tensor cores
// (sm_90a): bf16 wgmma on tiles fed by TMA, in two kernels.
//
// Replaces, for bf16 inputs, the Pallas TPU kernels `flash_attention_bwd_kernels`
// (`_dq_kernel`, `_dkv_kernel`) of src/repro/kernels/flash_attention/kernel.py;
// float32 inputs go to the 3xTF32 kernels of flash_attention_bwd.cu.  The
// function is the one flash_attention_bwd.cu states: p = exp(s·D^-½ - lse)
// in the band, ds = p∘(dO·vᵀ - dvec), dq = D^-½·ds·k,
// dk = D^-½·Σ_group dsᵀ·q, dv = Σ_group pᵀ·dO, outputs in bf16.  A query
// stripe (Sq rows at positions off + i against Sk keys) maps q and dO over
// Sq rows and k and v over Sk; every band test reads positions, off + row.
//
// What bounds it.  Five products over the band, 10·D FLOPs per (query, key)
// pair: tensor-core work.  The PR 17 kernels ran seven (both kernels
// recompute what they need) on the FP32 CUDA cores from padded float32
// shared-memory tiles, with no copy overlapping compute.
//
// Design.  The two kernels of PR 17 and of the Pallas pair, each a block of
// two warpgroups of 64 rows on wgmma (256 threads: up to 255 registers a
// thread), its thread 0 feeding a ring of swizzled stages by TMA and
// mbarriers, as flash_fwd_sm90.cuh:
// * dq: a block per (b, h, 64·NWG query rows); Q and dO stay, K and V tiles
//   of the block's key band stream through the ring.  S = Q·Kᵀ and
//   dP = dO·Vᵀ from shared memory; dS in registers; dQ += dS·K with K read
//   MN-major.  Three products.
// * dk, dv: a block per (b, KV head, 64·NWG key rows); K and V stay, the Q
//   and dO tiles of the G query heads of the group and of the band stream
//   through the ring in a fixed order (head, then query tile), so the group
//   sum is a fixed sequence of wgmma accumulations: no float atomics, and a
//   repeat is bit-identical.  Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ; dV += Pᵀ·dO and
//   dK += dSᵀ·Q with dO and Q read MN-major.  Four products.  At D = 256 the
//   two 64 × 256 float32 accumulators (256 registers a thread) do not fit,
//   so dk and dv are two launches of this kernel (the dv launch recomputes
//   Sᵀ: five).  So at MLA's (192, 128): the 64 × 192 and 64 × 128
//   accumulators (160 registers) beside Sᵀ and dPᵀ (64) would not fit.
// * Head sizes.  Q, K, dq and dk take D columns, V, dO and dv DV: DV = D
//   but for MLA, (192, 128).  Q·Kᵀ (and K·Qᵀ) then run 12 k16 steps over
//   three 64-column panels, dO·Vᵀ (and V·dOᵀ) 8 over two; dQ and dK cover
//   three panels, dV two.
// * Precision.  q, k, v and dO are bf16, so S, dP, Sᵀ and dPᵀ are exact
//   products summed in float32.  P and dS are float32 values: as bf16 they
//   would err by up to 2^-9 of each term, ~6e-5 of the term magnitude over
//   10³ terms, three times the 2e-5 bar.  They enter the tensor cores as
//   hi + lo bf16 (~2^-17), two wgmmas per step: ten products in all
//   (eleven at D = 256) where the function has five.
#pragma once

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace flash {
namespace sm90 {

// Both kernels: two warpgroups, two stages, 64-wide inner tiles; 32-wide at
// D = 256, where the 64 × 256 accumulator takes 128 registers a thread and
// the tiles 192 KB of shared memory.  D is q's and k's head size (and dq's,
// dk's), DV v's and dO's (and dv's): DV = D but for MLA, (D, DV) =
// (192, 128), where Q and K are three 64-column panels and V and dO two.
template <int D_, int DV_>
struct DqConfig {
  static constexpr int D = D_, DV = DV_, NWG = 2, BK = D == 256 ? 32 : 64, STAGES = 2;
  static constexpr int kThreads = 128 * NWG;
  static constexpr int kBQ = 64 * NWG;            // query rows per block
  static constexpr int kQBytes = 64 * D * 2;      // one consumer's Q tile
  static constexpr int kdOBytes = 64 * DV * 2;    // one consumer's dO tile
  static constexpr int kKBytes = BK * D * 2;      // one K tile
  static constexpr int kVBytes = BK * DV * 2;     // one V tile
  static constexpr int kSmemBytes = 1024 + NWG * (kQBytes + kdOBytes) +
                                    STAGES * (kKBytes + kVBytes) + 8 * (1 + 2 * STAGES);
};

// WITH_DK: the launch computes dk (and needs V for dPᵀ); WITH_DV: dv.
template <int D_, int DV_, bool WITH_DK_, bool WITH_DV_>
struct DkvConfig {
  static constexpr int D = D_, DV = DV_, NWG = 2, BQ = D == 256 ? 32 : 64, STAGES = 2;
  static constexpr bool WITH_DK = WITH_DK_, WITH_DV = WITH_DV_;
  static constexpr int kThreads = 128 * NWG;
  static constexpr int kBK = 64 * NWG;            // key rows per block
  static constexpr int kKBytes = 64 * D * 2;      // one consumer's K tile
  static constexpr int kVBytes = 64 * DV * 2;     // one consumer's V tile
  static constexpr int kQBytes = BQ * D * 2;      // one Q tile
  static constexpr int kdOBytes = BQ * DV * 2;    // one dO tile
  static constexpr int kSmemBytes = 1024 + NWG * (kKBytes + kVBytes) +
                                    STAGES * (kQBytes + kdOBytes) + 8 * (1 + 2 * STAGES);
};

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse, const float* __restrict__ dvec,
                          __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int off, int H,
                          int Hkv, int causal, int window, float scale) {
  constexpr int D = C::D, DV = C::DV, NWG = C::NWG, BK = C::BK, ST = C::STAGES;
  using P = Panel<D>;
  using PV = Panel<DV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sdO = sQ + NWG * C::kQBytes;
  uint8_t* sK = sdO + NWG * C::kdOBytes;
  uint8_t* sV = sK + ST * C::kKBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + ST * C::kVBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;

  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::kBQ;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / (H / Hkv);
  const int k_first = window > 0 ? max(0, off + q0 - window + 1) : 0;
  const int k_end = causal ? min(Sk, off + q0 + C::kBQ) : Sk;
  const int t0 = k_first / BK;
  const int n_tiles = (k_end + BK - 1) / BK - t0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Thread 0 issues every TMA load: the Q and dO tiles, the first STAGES
  // K/V tiles, then each next tile as soon as its stage is released.
  auto load_tile = [&](int i) {
    const int s = i % ST, k0 = (t0 + i) * BK;
    mbar_expect_tx(&full[s], C::kKBytes + C::kVBytes);
    for (int p = 0; p < P::kCount; ++p)
      tma_load(sK + s * C::kKBytes + p * BK * P::kRowBytes, &tk, &full[s], p * P::kCols, k0, hk,
               b);
    for (int p = 0; p < PV::kCount; ++p)
      tma_load(sV + s * C::kVBytes + p * BK * PV::kRowBytes, &tv, &full[s], p * PV::kCols, k0,
               hk, b);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, NWG * (C::kQBytes + C::kdOBytes));
    for (int w = 0; w < NWG; ++w) {
      for (int p = 0; p < P::kCount; ++p)
        tma_load(sQ + w * C::kQBytes + p * 64 * P::kRowBytes, &tq, q_full, p * P::kCols,
                 q0 + 64 * w, h, b);
      for (int p = 0; p < PV::kCount; ++p)
        tma_load(sdO + w * C::kdOBytes + p * 64 * PV::kRowBytes, &tdo, q_full, p * PV::kCols,
                 q0 + 64 * w, h, b);
    }
    for (int i = 0; i < min(ST, n_tiles); ++i) load_tile(i);
  }
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int r0 = q0 + 64 * wg;
  const int ra = r0 + 16 * warp + lane / 4;     // rows ra and ra + 8
  const int p0 = off + r0, pa = off + ra;       // positions of rows r0 and ra
  const int cq = 2 * (lane % 4);
  const uint8_t* myQ = sQ + wg * C::kQBytes;
  const uint8_t* mydO = sdO + wg * C::kdOBytes;
  const long long row0 = (static_cast<long long>(b) * H + h) * Sq;
  float lse_r[2], dvec_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    lse_r[r] = row < Sq ? lse[row0 + row] : 0.f;
    dvec_r[r] = row < Sq ? dvec[row0 + row] : 0.f;
  }

  float acc[P::kCount][P::kCols / 2];
#pragma unroll
  for (int p = 0; p < P::kCount; ++p)
#pragma unroll
    for (int e = 0; e < P::kCols / 2; ++e) acc[p][e] = 0.f;

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % ST, k0 = (t0 + i) * BK;
    mbar_wait(&full[s], (i / ST) & 1);
    const bool skip = r0 >= Sq || (causal && k0 > p0 + 63) ||
                      (window > 0 && k0 + BK - 1 <= p0 - window);
    if (!skip) {
      const bool edge = (causal && k0 + BK - 1 > p0) || (window > 0 && k0 <= p0 + 63 - window) ||
                        k0 + BK > Sk;
      const uint8_t* tK = sK + s * C::kKBytes;
      const uint8_t* tV = sV + s * C::kVBytes;

      // S = Q·Kᵀ over D, dP = dO·Vᵀ over DV (<= D).
      float sc[BK / 2], dp[BK / 2];
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) sc[e] = dp[e] = 0.f;
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<BK>(sc, desc_k<D, 64>(myQ, kk), desc_k<D, BK>(tK, kk));
        if (kk < DV / 16)
          wgmma_ss<BK>(dp, desc_k<DV, 64>(mydO, kk), desc_k<DV, BK>(tV, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // ds = p∘(dp - dvec), p = exp(s·scale - lse) in the band, into dp.
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int r = (e / 2) % 2;
        const bool in = !edge || attends(pa + 8 * r, k0 + 8 * (e / 4) + cq + (e % 2), Sk, causal,
                                         window);
        const float p = in ? expf(sc[e] * scale - lse_r[r]) : 0.f;
        dp[e] = p * (dp[e] - dvec_r[r]);
      }

      // dQ += dS·K, dS as hi + lo.
      uint32_t hi[BK / 16][4], lo[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) to_frag(dp, kk, hi[kk], lo[kk]);
#pragma unroll
      for (int p = 0; p < P::kCount; ++p) fence_regs(acc[p]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int p = 0; p < P::kCount; ++p) {
          wgmma_rs<P::kCols>(acc[p], hi[kk], desc_mn<D, BK>(tK, p, kk));
          wgmma_rs<P::kCols>(acc[p], lo[kk], desc_mn<D, BK>(tK, p, kk));
        }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < P::kCount; ++p) fence_regs(acc[p]);
    }
    mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && i + ST < n_tiles) {
      mbar_wait(&empty[s], (i / ST) & 1);
      load_tile(i + ST);
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    if (row < Sq) {
      __nv_bfloat16* ob = dq + ((static_cast<long long>(b) * Sq + row) * H + h) * D;
#pragma unroll
      for (int p = 0; p < P::kCount; ++p)
#pragma unroll
        for (int j = 0; j < P::kCols / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(ob + p * P::kCols + 8 * j + cq) =
              __floats2bfloat162_rn(scale * acc[p][4 * j + 2 * r],
                                    scale * acc[p][4 * j + 2 * r + 1]);
    }
  }
}

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse, const float* __restrict__ dvec,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq,
                           int Sk, int off, int H, int Hkv, int causal, int window, float scale) {
  constexpr int D = C::D, DV = C::DV, NWG = C::NWG, BQ = C::BQ, ST = C::STAGES;
  constexpr bool WITH_DK = C::WITH_DK, WITH_DV = C::WITH_DV;
  using P = Panel<D>;
  using PV = Panel<DV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);
  uint8_t* sV = sK + NWG * C::kKBytes;
  uint8_t* sQ = sV + NWG * C::kVBytes;
  uint8_t* sdO = sQ + ST * C::kQBytes;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sdO + ST * C::kdOBytes);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + ST;

  const int G = H / Hkv;
  const int k0 = blockIdx.z * C::kBK;    // the first key tiles have the longest causal bands
  const int hk = blockIdx.x, b = blockIdx.y;
  // Query rows that attend a key of this block: position off + i >= k0 when
  // causal, and off + i < k0 + kBK - 1 + window when a window is given; a
  // block of keys past the stripe's last position has none.
  const int q_first = causal ? max(0, k0 - off) : 0;
  const int q_end = window > 0 ? min(Sq, k0 + C::kBK - 1 + window - off) : Sq;
  const int tq0 = q_first / BQ;
  const int nq = max(0, (q_end + BQ - 1) / BQ - tq0);
  const int n_tiles = G * nq;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Thread 0 issues every TMA load: the K (and V) tiles, the first STAGES
  // Q/dO tiles, then each next tile as soon as its stage is released.
  auto load_tile = [&](int i) {
    const int s = i % ST, h = hk * G + i / nq, q0 = (tq0 + i % nq) * BQ;
    mbar_expect_tx(&full[s], C::kQBytes + C::kdOBytes);
    for (int p = 0; p < P::kCount; ++p)
      tma_load(sQ + s * C::kQBytes + p * BQ * P::kRowBytes, &tq, &full[s], p * P::kCols, q0, h, b);
    for (int p = 0; p < PV::kCount; ++p)
      tma_load(sdO + s * C::kdOBytes + p * BQ * PV::kRowBytes, &tdo, &full[s], p * PV::kCols, q0,
               h, b);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(kv_full, NWG * (C::kKBytes + (WITH_DK ? C::kVBytes : 0)));
    for (int w = 0; w < NWG; ++w) {
      for (int p = 0; p < P::kCount; ++p)
        tma_load(sK + w * C::kKBytes + p * 64 * P::kRowBytes, &tk, kv_full, p * P::kCols,
                 k0 + 64 * w, hk, b);
      if (WITH_DK)
        for (int p = 0; p < PV::kCount; ++p)
          tma_load(sV + w * C::kVBytes + p * 64 * PV::kRowBytes, &tv, kv_full, p * PV::kCols,
                   k0 + 64 * w, hk, b);
    }
    for (int i = 0; i < min(ST, n_tiles); ++i) load_tile(i);
  }
  // Consumer warpgroup wg: key rows kr0 .. kr0 + 63.  This thread holds
  // keys ka and ka + 8 and query columns 8j + cq, 8j + cq + 1 of a tile.
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int kr0 = k0 + 64 * wg;
  const int ka = kr0 + 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const uint8_t* myK = sK + wg * C::kKBytes;
  const uint8_t* myV = sV + wg * C::kVBytes;

  float acc_k[WITH_DK ? P::kCount : 1][P::kCols / 2];
  float acc_v[WITH_DV ? PV::kCount : 1][PV::kCols / 2];
  if constexpr (WITH_DK) {
#pragma unroll
    for (int p = 0; p < P::kCount; ++p)
#pragma unroll
      for (int e = 0; e < P::kCols / 2; ++e) acc_k[p][e] = 0.f;
  }
  if constexpr (WITH_DV) {
#pragma unroll
    for (int p = 0; p < PV::kCount; ++p)
#pragma unroll
      for (int e = 0; e < PV::kCols / 2; ++e) acc_v[p][e] = 0.f;
  }

  mbar_wait(kv_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % ST, h = hk * G + i / nq, q0 = (tq0 + i % nq) * BQ;
    mbar_wait(&full[s], (i / ST) & 1);
    const int pq0 = off + q0;  // the tile's first position
    const bool skip = kr0 >= Sk || (causal && pq0 + BQ - 1 < kr0) ||
                      (window > 0 && pq0 >= kr0 + 63 + window);
    if (!skip) {
      const bool edge = (causal && pq0 < kr0 + 63) ||
                        (window > 0 && pq0 + BQ - 1 >= kr0 + window) || q0 + BQ > Sq ||
                        kr0 + 64 > Sk;
      const uint8_t* tQ = sQ + s * C::kQBytes;
      const uint8_t* tdO = sdO + s * C::kdOBytes;
      // The tile's lse and dvec, one column per lane (32·r + lane), read
      // while the products run; a thread takes its columns' by shuffle.
      const long long row0 = (static_cast<long long>(b) * H + h) * Sq;
      float lse_c[BQ / 32], dvec_c[BQ / 32];
#pragma unroll
      for (int r = 0; r < BQ / 32; ++r) {
        const int qi = q0 + 32 * r + lane;
        lse_c[r] = qi < Sq ? lse[row0 + qi] : 0.f;
        dvec_c[r] = WITH_DK && qi < Sq ? dvec[row0 + qi] : 0.f;
      }

      // Sᵀ = K·Qᵀ over D, dPᵀ = V·dOᵀ over DV (<= D).
      float st[BQ / 2], dpt[WITH_DK ? BQ / 2 : 1];
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) {
        st[e] = 0.f;
        if constexpr (WITH_DK) dpt[e] = 0.f;
      }
      fence_regs(st);
      if constexpr (WITH_DK) fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<BQ>(st, desc_k<D, 64>(myK, kk), desc_k<D, BQ>(tQ, kk));
        if constexpr (WITH_DK)
          if (kk < DV / 16)
            wgmma_ss<BQ>(dpt, desc_k<DV, 64>(myV, kk), desc_k<DV, BQ>(tdO, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      if constexpr (WITH_DK) fence_regs(dpt);

      // pᵀ (into st) and dsᵀ = pᵀ∘(dpᵀ - dvec) (into dpt); the column is
      // the query i, the row the key j.  Column c's lse and dvec are in
      // lane c % 32 (lse_c, dvec_c), c / 32 = e / 16.
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) {
        const int c = 8 * (e / 4) + cq + (e % 2), qi = q0 + c;
        const int kj = ka + 8 * ((e / 2) % 2);
        const bool in = !edge || (qi < Sq && attends(off + qi, kj, Sk, causal, window));
        const float lse_i = __shfl_sync(0xffffffffu, lse_c[e / 16], c % 32);
        st[e] = in ? expf(st[e] * scale - lse_i) : 0.f;
        if constexpr (WITH_DK)
          dpt[e] = st[e] * (dpt[e] - __shfl_sync(0xffffffffu, dvec_c[e / 16], c % 32));
      }

      if constexpr (WITH_DV) {
        // dV += Pᵀ·dO, Pᵀ as hi + lo.
        uint32_t hi[BQ / 16][4], lo[BQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) to_frag(st, kk, hi[kk], lo[kk]);
#pragma unroll
        for (int p = 0; p < PV::kCount; ++p) fence_regs(acc_v[p]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
          for (int p = 0; p < PV::kCount; ++p) {
            wgmma_rs<PV::kCols>(acc_v[p], hi[kk], desc_mn<DV, BQ>(tdO, p, kk));
            wgmma_rs<PV::kCols>(acc_v[p], lo[kk], desc_mn<DV, BQ>(tdO, p, kk));
          }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int p = 0; p < PV::kCount; ++p) fence_regs(acc_v[p]);
        // dS is packed after this wait, not beside the P fragments still
        // held by the dV products: 32 registers fewer at the peak.
        if constexpr (WITH_DK) fence_regs(dpt);
      }
      if constexpr (WITH_DK) {
        // dK += dSᵀ·Q, dSᵀ as hi + lo.
        uint32_t hi[BQ / 16][4], lo[BQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) to_frag(dpt, kk, hi[kk], lo[kk]);
#pragma unroll
        for (int p = 0; p < P::kCount; ++p) fence_regs(acc_k[p]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
          for (int p = 0; p < P::kCount; ++p) {
            wgmma_rs<P::kCols>(acc_k[p], hi[kk], desc_mn<D, BQ>(tQ, p, kk));
            wgmma_rs<P::kCols>(acc_k[p], lo[kk], desc_mn<D, BQ>(tQ, p, kk));
          }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int p = 0; p < P::kCount; ++p) fence_regs(acc_k[p]);
      }
    }
    mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && i + ST < n_tiles) {
      mbar_wait(&empty[s], (i / ST) & 1);
      load_tile(i + ST);
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ka + 8 * r;
    if (row < Sk) {
      const long long o = (static_cast<long long>(b) * Sk + row) * Hkv + hk;
      if constexpr (WITH_DK) {
#pragma unroll
        for (int p = 0; p < P::kCount; ++p)
#pragma unroll
          for (int j = 0; j < P::kCols / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(dk + o * D + p * P::kCols + 8 * j + cq) =
                __floats2bfloat162_rn(scale * acc_k[p][4 * j + 2 * r],
                                      scale * acc_k[p][4 * j + 2 * r + 1]);
      }
      if constexpr (WITH_DV) {
#pragma unroll
        for (int p = 0; p < PV::kCount; ++p)
#pragma unroll
          for (int j = 0; j < PV::kCols / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(dv + o * DV + p * PV::kCols + 8 * j + cq) =
                __floats2bfloat162_rn(acc_v[p][4 * j + 2 * r], acc_v[p][4 * j + 2 * r + 1]);
      }
    }
  }
}

template <class C>
int launch_dkv(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
               const CUtensorMap& tdo, const float* lse, const float* dvec, void* dk, void* dv,
               int B, int Sq, int Sk, int off, int H, int Hkv, int causal, int window,
               float scale, cudaStream_t stream) {
  auto* fn = flash_bwd_dkv_wgmma_kernel<C>;
  const cudaError_t e =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (e != cudaSuccess) return e;
  fn<<<dim3(Hkv, B, (Sk + C::kBK - 1) / C::kBK), C::kThreads, C::kSmemBytes, stream>>>(
      tq, tk, tv, tdo, lse, dvec, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Sq, Sk, off, H, Hkv, causal, window, scale);
  return cudaGetLastError();
}

// Launch B8's bf16 kernels: dq, then dk/dv, as two launches (dk, then dv)
// where one thread's two accumulators would not fit its registers: at
// D = 256 and at MLA's (192, 128).  Sq query rows at positions off + i
// against Sk keys.  st: q's, k's and v's batch, sequence and head strides
// (elements); dO [B, Sq, H, DV] contiguous.  Returns 0 or a CUDA error code.
template <int D, int DV>
int launch_bwd(const void* q, const void* k, const void* v, const void* dO, const float* lse,
               const float* dvec, void* dq, void* dk, void* dv, int B, int Sq, int Sk, int off,
               int H, int Hkv, const long long* st, int causal, int window, float scale,
               cudaStream_t stream) {
  constexpr bool kSplit = D == 256 || D != DV;
  using Q = DqConfig<D, DV>;
  using K = DkvConfig<D, DV, true, !kSplit>;
  const long long hdv = static_cast<long long>(H) * DV;
  CUtensorMap q_rows, do_rows, k_tile, v_tile, k_rows, v_rows, q_tile, do_tile;
  int err = make_map<D>(&q_rows, q, B, Sq, H, st[0], st[1], st[2], 64);
  if (!err) err = make_map<DV>(&do_rows, dO, B, Sq, H, Sq * hdv, hdv, DV, 64);
  if (!err) err = make_map<D>(&k_tile, k, B, Sk, Hkv, st[3], st[4], st[5], Q::BK);
  if (!err) err = make_map<DV>(&v_tile, v, B, Sk, Hkv, st[6], st[7], st[8], Q::BK);
  if (!err) err = make_map<D>(&k_rows, k, B, Sk, Hkv, st[3], st[4], st[5], 64);
  if (!err) err = make_map<DV>(&v_rows, v, B, Sk, Hkv, st[6], st[7], st[8], 64);
  if (!err) err = make_map<D>(&q_tile, q, B, Sq, H, st[0], st[1], st[2], K::BQ);
  if (!err) err = make_map<DV>(&do_tile, dO, B, Sq, H, Sq * hdv, hdv, DV, K::BQ);
  if (err) return err;

  auto* dq_fn = flash_bwd_dq_wgmma_kernel<Q>;
  cudaError_t e =
      cudaFuncSetAttribute(dq_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, Q::kSmemBytes);
  if (e != cudaSuccess) return e;
  dq_fn<<<dim3(H, B, (Sq + Q::kBQ - 1) / Q::kBQ), Q::kThreads, Q::kSmemBytes, stream>>>(
      q_rows, k_tile, v_tile, do_rows, lse, dvec, static_cast<__nv_bfloat16*>(dq), Sq, Sk, off, H,
      Hkv, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  err = launch_dkv<K>(q_tile, k_rows, v_rows, do_tile, lse, dvec, dk, dv, B, Sq, Sk, off, H, Hkv,
                      causal, window, scale, stream);
  if constexpr (kSplit) {
    using V = DkvConfig<D, DV, false, true>;
    if (!err)
      err = launch_dkv<V>(q_tile, k_rows, v_rows, do_tile, lse, dvec, dk, dv, B, Sq, Sk, off, H,
                          Hkv, causal, window, scale, stream);
  }
  return err;
}

}  // namespace sm90
}  // namespace flash
