// B7's bf16 path: causal, optionally windowed, flash attention forward on
// Hopper's tensor cores (sm_90a): bf16 wgmma on K/V tiles fed by TMA.
//
// Replaces, for bf16 inputs, the Pallas TPU kernel `flash_attention_kernel`
// (body `_kernel`) of src/repro/kernels/flash_attention/kernel.py; float32
// inputs go to the 3xTF32 kernel of flash_attention.cu.
// The function is the one flash_attention.cu states: s_ij = (q_i·k_j)·D^-½
// masked to -1e30 outside the causal / window band and past S, an online
// softmax (running max m, sum l, float32), out_i = Σ_j p_ij v_j / l_i in
// bf16 and lse_i = m_i + log(max(l_i, 1e-30)) in float32.  A query stripe
// (Sq rows at positions off + i against Sk keys, flash_attention.cu's note)
// takes q's TMA map over Sq rows and k's and v's over Sk; every band test
// below reads the rows' positions, off + row.
//
// What bounds it.  At the LM paths' shapes the work is two products over the
// band, 4·D FLOPs per (query, key) pair: tensor-core work (989 TFLOP/s in
// bf16) against ~0.1–0.3 GB of bytes.  The PR 15 kernel did it on the FP32
// CUDA cores (67 TFLOP/s peak) from padded float32 shared-memory tiles, its
// loops bounded by shared-memory loads, every K/V tile loaded and then
// computed with no overlap.
//
// Design.
// * A block owns 64·NWG query rows of one (b, h), NWG = 2 consumer
//   warpgroups of 64 rows each: 256 threads, two warps on each of the SM's
//   four register-file partitions, so ptxas may give a thread 255
//   registers (the 64 × D float32 accumulator alone takes 128 at D = 256).
//   A ninth warp as a producer (or a producer warpgroup) puts three warps
//   on one partition and caps every thread at 168: the first builds of
//   this kernel spilled so at D = 256 (PERF.md, PR 18).  Grid (H, B, query
//   tiles), the query tiles last-first, so the longest causal blocks start
//   first.  The block walks only the key tiles that meet its band (as
//   flash_attention.cu does); a consumer skips the tiles that miss its own
//   64 rows, and masks only the band's edge tiles and a ragged last tile.
// * Copies: thread 0 issues TMA loads (the Q tiles once, the first K and V
//   tiles into a ring of STAGES swizzled stages, and each later tile as
//   soon as both warpgroups have released its stage); mbarriers report
//   arrival (`full`) and release (`empty`), so the next tile is in flight
//   while this one computes.  Rows past S arrive as zeros.
// * Products: S = Q·Kᵀ as wgmma m64nBKk16 with Q and K from shared memory;
//   O += P·V with P from registers and V read MN-major from shared memory,
//   m64nCk16 per 64-column panel of D.  float32 accumulators; the scale
//   D^-½ is applied to S in float32 after the product.
// * Softmax in the accumulator's layout: a row lives in 4 lanes, so its max
//   and sum take two xor-shuffles; m, l and the correction of O stay float32.
// * Head sizes.  Q and K take D columns, V and the output DV: DV = D but
//   for MLA's prefill, (D, DV) = (192, 128).  Q·Kᵀ then runs 12 k16 steps
//   over three 64-column panels of Q and K; P·V covers two 64-column
//   panels of V.  Shared memory at (192, 128): 48 KB of Q tiles and two
//   stages of a 24 KB K and a 16 KB V tile: 132,136 bytes with the pad.
// * Precision.  q, k and v are bf16, so Q·Kᵀ is exact products summed in
//   float32.  P is not: rounded once to bf16 it errs by up to 2^-9 of each
//   term, which breaks the one-ulp bar on outputs near 0.  P therefore
//   enters the tensor cores as hi + lo bf16 (~2^-17 of each term), two
//   wgmmas per step: three products where the function has two.
#pragma once

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace flash {
namespace sm90 {

// 64·NWG query rows per block, BK keys per tile, STAGES K/V stages.  At
// D = DV = 256 the Q tiles and two stages take 192 KB of shared memory.
template <int D_, int DV_>
struct FwdConfig {
  static constexpr int D = D_, DV = DV_, NWG = 2, BK = 64, STAGES = 2;
  static constexpr int kThreads = 128 * NWG;
  static constexpr int kBQ = 64 * NWG;            // query rows per block
  static constexpr int kQBytes = 64 * D * 2;      // one consumer's Q tile
  static constexpr int kKBytes = BK * D * 2;      // one K tile
  static constexpr int kVBytes = BK * DV * 2;     // one V tile
  static constexpr int kStageBytes = kKBytes + kVBytes;
  static constexpr int kSmemBytes =
      1024 + NWG * kQBytes + STAGES * kStageBytes + 8 * (1 + 2 * STAGES);
};

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int Sq, int Sk, int off, int H, int Hkv,
                       int causal, int window, float scale) {
  constexpr int D = C::D, DV = C::DV, NWG = C::NWG, BK = C::BK, ST = C::STAGES;
  using P = Panel<D>;
  using PV = Panel<DV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sK = sQ + NWG * C::kQBytes;
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

  // Thread 0 issues every TMA load: the Q tiles, the first STAGES K/V tiles,
  // then each next tile as soon as all consumers have released its stage.
  auto load_tile = [&](int i) {
    const int s = i % ST, k0 = (t0 + i) * BK;
    mbar_expect_tx(&full[s], C::kStageBytes);
    for (int p = 0; p < P::kCount; ++p)
      tma_load(sK + s * C::kKBytes + p * BK * P::kRowBytes, &tk, &full[s], p * P::kCols, k0, hk,
               b);
    for (int p = 0; p < PV::kCount; ++p)
      tma_load(sV + s * C::kVBytes + p * BK * PV::kRowBytes, &tv, &full[s], p * PV::kCols, k0,
               hk, b);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, NWG * C::kQBytes);
    for (int w = 0; w < NWG; ++w)
      for (int p = 0; p < P::kCount; ++p)
        tma_load(sQ + w * C::kQBytes + p * 64 * P::kRowBytes, &tq, q_full, p * P::kCols,
                 q0 + 64 * w, h, b);
    for (int i = 0; i < min(ST, n_tiles); ++i) load_tile(i);
  }
  // Consumer warpgroup wg: query rows r0 .. r0 + 63.  This thread holds
  // rows ra and ra + 8, columns 8j + cq and 8j + cq + 1 of each tile.
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int r0 = q0 + 64 * wg;
  const int ra = r0 + 16 * warp + lane / 4;
  const int p0 = off + r0, pa = off + ra;  // positions of rows r0 and ra
  const int cq = 2 * (lane % 4);
  const uint8_t* myQ = sQ + wg * C::kQBytes;

  float o[PV::kCount][PV::kCols / 2];
#pragma unroll
  for (int p = 0; p < PV::kCount; ++p)
#pragma unroll
    for (int i = 0; i < PV::kCols / 2; ++i) o[p][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

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

      float sc[BK / 2];
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) sc[e] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(sc, desc_k<D, 64>(myQ, kk), desc_k<D, BK>(tK, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // Online softmax over this tile, rows ra (e < 2) and ra + 8.
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
      for (int p = 0; p < PV::kCount; ++p)
#pragma unroll
        for (int e = 0; e < PV::kCols / 2; ++e) o[p][e] *= corr[(e / 2) % 2];

      // O += P·V, P as hi + lo.
      uint32_t hi[BK / 16][4], lo[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) to_frag(sc, kk, hi[kk], lo[kk]);
#pragma unroll
      for (int p = 0; p < PV::kCount; ++p) fence_regs(o[p]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int p = 0; p < PV::kCount; ++p) {
          wgmma_rs<PV::kCols>(o[p], hi[kk], desc_mn<DV, BK>(tV, p, kk));
          wgmma_rs<PV::kCols>(o[p], lo[kk], desc_mn<DV, BK>(tV, p, kk));
        }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < PV::kCount; ++p) fence_regs(o[p]);
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
      const float lf = fmaxf(l[r], 1e-30f);
      __nv_bfloat16* ob = out + ((static_cast<long long>(b) * Sq + row) * H + h) * DV;
#pragma unroll
      for (int p = 0; p < PV::kCount; ++p)
#pragma unroll
        for (int j = 0; j < PV::kCols / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(ob + p * PV::kCols + 8 * j + cq) =
              __floats2bfloat162_rn(o[p][4 * j + 2 * r] / lf, o[p][4 * j + 2 * r + 1] / lf);
      if (lane % 4 == 0) lse[(static_cast<long long>(b) * H + h) * Sq + row] = m[r] + logf(lf);
    }
  }
}

// Launch B7's bf16 kernel at q/k head size D and v head size DV: Sq query
// rows at positions off + i against Sk keys.  st: q's, k's and v's batch,
// sequence and head strides (elements).  Returns 0 or a CUDA error code.
template <int D, int DV>
int launch_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int B,
               int Sq, int Sk, int off, int H, int Hkv, const long long* st, int causal,
               int window, float scale, cudaStream_t stream) {
  using C = FwdConfig<D, DV>;
  CUtensorMap tq, tk, tv;
  int err = make_map<D>(&tq, q, B, Sq, H, st[0], st[1], st[2], 64);
  if (!err) err = make_map<D>(&tk, k, B, Sk, Hkv, st[3], st[4], st[5], C::BK);
  if (!err) err = make_map<DV>(&tv, v, B, Sk, Hkv, st[6], st[7], st[8], C::BK);
  if (err) return err;
  auto* fn = flash_fwd_wgmma_kernel<C>;
  const cudaError_t e =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(H, B, (Sq + C::kBQ - 1) / C::kBQ);
  fn<<<grid, C::kThreads, C::kSmemBytes, stream>>>(tq, tk, tv,
                                                   static_cast<__nv_bfloat16*>(out), lse, Sq, Sk,
                                                   off, H, Hkv, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace flash
