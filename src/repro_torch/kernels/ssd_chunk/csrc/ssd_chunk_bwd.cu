// Backward of the Mamba-2 SSD chunked scan on Hopper (sm_90a): 3xTF32 wgmma
// with float32 accumulators, nine launches, no atomics.
//
// Replaces no Pallas kernel: the reference trains the SSM family through the
// jnp `ssd_chunked` (src/repro/models/mamba2.py), which XLA differentiates,
// and its Pallas kernel `ssd_chunk_kernel` (B10) has no backward.  This is
// the backward of B10 (csrc/ssd_chunk.cu), the function of
// `ref.ssd_chunk_bwd_plain`.  Per batch b and head h, over chunks of Q steps
// (cum the within-chunk cumulative sum of la, L[q, k] = exp(cum_q - cum_k)
// for q >= k, s[q, k] = C_q·B_k, h_prev the state entering a chunk, D the
// gradient of the state leaving it):
//
//     D_{c-1} = exp(cum_last_c) D_c + Σ_q exp(cum_q) dy_q ⊗ C_q   (D_last = dh_final)
//     dxdt_k  = Σ_{q>=k} s L dy_q + exp(cum_last - cum_k) D B_k
//     dB_k    = Σ_{q>=k} L (dy_q·xdt_k) C_q + exp(cum_last - cum_k) Dᵀ xdt_k
//     dC_q    = Σ_{k<=q} L (dy_q·xdt_k) B_k + exp(cum_q) h_prevᵀ dy_q
//     dla_t   = Σ_{q>=t, k<t} M[q, k] + Σ_{q>=t} I_q + Σ_{k<t} S_k
//               + exp(cum_last) <D, h_prev>
//
// with M[q, k] = s L (dy_q·xdt_k), I_q = exp(cum_q) C_q·(h_prevᵀ dy_q) and
// S_k = exp(cum_last - cum_k) B_k·(Dᵀ xdt_k); dB, dC summed over the H / G
// heads of each group.  dla is the reverse cumulative sum of dcum (M's row
// sums minus its column sums, plus I, minus S), taken as the pairs that
// cross t, so that the row and column sums, each as large as M's terms, do
// not cancel; and cum is summed in double, because at mamba2's initial
// decays it reaches -10³ within a chunk, where the difference of two float32
// sums keeps ~1e-4 of exp(cum_q - cum_k) (`ref.ssd_chunk_bwd_plain` does the
// same).  Layout (the model's, read in place, as B10 reads it): xdt and dy
// [B, S, H, P], la [B, S, H], bm and cm [B, S, G, N] indexed per group (head
// h reads group h / (H / G), never repeated per head); dh_final [B, H, P, N]
// or null.  P <= 64, N <= 128, Q <= 256, all float32.
//
// What bounds it.  Per (b·h, chunk) the function needs five [P, N] products
// over the chunk (the state contributions, E_c, D·B, Dᵀ·xdt, h_prevᵀ·dy:
// 5·Q·P·N multiply-adds), and per causal (q, k) pair dy·xdt, the dxdt and
// dB and dC terms (2P + 2N) and C·B once per group (N / (H / G)).  At
// mamba2-780m's training microbatch (2 x 2,048, 48 heads of P 64, N 128,
// Q 256) that is 3.6e10 FLOP against 0.16 GB moved: 0.22 ms as three TF32
// products on the tensor cores (495 / 3 TFLOP/s), 0.53 ms on the FP32 cores,
// 0.05 ms for the bytes.  Bound by operations.  The first version, on the
// FP32 cores out of padded shared memory, took 4.1 ms, 3.1 of them in its two
// pairwise kernels, which formed s per head (48 times at mamba2's H / G).
//
// Design: B10's forward (3xTF32 wgmma) turned around, one warpgroup a
// block, its tiles, fragments and score tiles shared through
// ssd_tf32x3.cuh.
//   0. `bc_image_kernel`, per (b·g, chunk, 32 steps, B or C): Bᵀ and Cᵀ
//      [kMaxN n][steps] split into hi and lo and swizzled, the steps in kpos
//      order within each k8 step: the B operand of the chunk sums and of the
//      pairwise dB and dC products, once per group, copied in by cp.async.
//   1. `score_pairs_kernel`, per (b·g, chunk, 64 x 64 tile pair on or below
//      the diagonal, S or Sᵀ): S = C·Bᵀ (query rows) and Sᵀ = B·Cᵀ (key
//      rows) over N into a workspace, once per group instead of per head.
//   2. `state_sums_kernel`, per (b·h, chunk, which): the chunk's state
//      contribution Σ_k exp(cum_last - cum_k) xdt_k ⊗ B_k (with the chunk
//      decay exp(cum_last)) or E_c = Σ_q exp(cum_q) dy_q ⊗ C_q, [P, N]:
//      wgmma m64n128k8 over the chunk's steps, the A fragments from
//      registers, 32 steps a stage with the next stage's copy in flight.
//   3. `state_passes_kernel`, one thread per (b·h, p, n): the forward pass
//      over the chunks, replacing each contribution by the state entering
//      its chunk (h_prev), and the reverse pass, replacing each E_c by D_c;
//      eight chunks' loads in flight.
//   4. `keys_dx_kernel`, per (64-key tile, b·h, chunk): for each query tile
//      at or after it, Aᵀ = Sᵀ (from L2) ∘ L in the accumulator, then
//      dxdt += Aᵀ·dy with A in place (the query depth in kpos order, dyᵀ
//      staged per tile, the next tile's loaded into registers while a
//      product runs); then B_k·Dᵀ over N for the state term.
//   5. `keys_db_kernel`, per (64-key tile, b·h, chunk): for each query tile
//      ddᵀ = xdt_k·dy_qᵀ over P, Wᵀ = L ∘ ddᵀ in place, dB += Wᵀ·C (Cᵀ
//      from the image); then xdt_k·D over P for the state term and S_k.
//   6. `queries_dc_kernel`, per (64-query tile, b·h, chunk): for each key
//      tile up to it dd = dy_q·xdt_kᵀ, W = L ∘ dd and M = (S ∘ L) ∘ dd in
//      place, dC += W·B (Bᵀ from the image), and from M the crossing sums
//      Σ_{q>=t} Σ_{k<t} M[q, k] of the tile's rows (row prefixes by quad
//      shuffles carried over the key tiles, masked column sums by warp
//      shuffles and a fixed four-warp sum); then dy_q·h_prev over P for the
//      inter term and I_q.
//      In 5 and 6 the image tile's cp.async runs under the staging of the
//      other tile's rows and the dd product.
//   7. `finish_kernel`, per (b·h, chunk): <D, h_prev> by a fixed-order tree,
//      then dla from the query tiles' crossing sums, I's suffix and S's
//      prefix sums, in order.
//   8. `group_sum_kernel`: dB and dC over the heads of each group, in order.
// Every product is 3xTF32 (lo·hi + hi·lo + hi·hi, ../../csrc/tf32x3_sm90.cuh).
// The tensor cores add each k8 step into the accumulator rounding toward
// zero, so every tile's product (and each 32-step stage of the chunk sums)
// goes into a fresh accumulator that is added to the running sum in float32
// (tests/test_torch_tf32x3.py models this arithmetic).  Every sum has a
// fixed order: repeats are bit-identical.

#include <cuda_runtime.h>

#include "ssd_tf32x3.cuh"

namespace {

using namespace ssd;
using namespace tf32x3;

constexpr int kStep = kPanel;              // chunk steps a stage of the chunk sums
constexpr int kStageTile = kMaxN * kStep;  // floats of one stage's hi or lo image
constexpr int kImgTile = 2 * kStageTile;   // floats of a 64-step tile's hi or lo image
constexpr int kXTile = kT * kMaxP;         // floats of a 64 x P tile's hi or lo
constexpr int kPassThreads = 256;
constexpr int kPassAhead = 8;              // chunks the state passes load ahead
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int row_tiles(const Shape& sh) { return (sh.Q + kT - 1) / kT; }

// Offset of the image of Bᵀ (which 0) or Cᵀ (1) of (b·g, chunk): 2·row_tiles
// stages of hi, then as many of lo, each kStageTile floats [kMaxN][kStep].
__device__ __forceinline__ long long img_at(const Shape& sh, int bg, int c, int which) {
  return ((static_cast<long long>(bg) * sh.nc + c) * 2 + which) * 2 * (2 * row_tiles(sh)) *
         kStageTile;
}

// Score tile pairs of a (b·g, chunk): S's, then Sᵀ's.
__device__ __forceinline__ int pairs(const Shape& sh) {
  const int tq = row_tiles(sh);
  return tq * (tq + 1) / 2;
}

// L[q, k] = exp(cum_q - cum_k) for k <= q < Q, else 0 (indices clamped: cum
// holds Q values).
__device__ __forceinline__ float decay(const double* cum, int q, int k, int Q) {
  const float l = expf(static_cast<float>(cum[min(q, Q - 1)] - cum[min(k, Q - 1)]));
  return (k <= q && q < Q) ? l : 0.f;
}

template <int NV>
__device__ __forceinline__ void zero(float (&d)[NV]) {
#pragma unroll
  for (int e = 0; e < NV; ++e) d[e] = 0.f;
}

template <int NV>
__device__ __forceinline__ void add(float (&total)[NV], const float (&part)[NV]) {
#pragma unroll
  for (int e = 0; e < NV; ++e) total[e] += part[e];
}

// The 64-step tile `t` of an image (two stages, hi then lo) into i_hi and
// i_lo, 16 bytes a copy.
__device__ __forceinline__ void copy_img_tile(float* i_hi, float* i_lo, const float* img_base,
                                              const Shape& sh, int t) {
  const float4* hi = reinterpret_cast<const float4*>(img_base + 2 * t * kStageTile);
  const float4* lo =
      reinterpret_cast<const float4*>(img_base + (2 * row_tiles(sh) + 2 * t) * kStageTile);
  float4* dh = reinterpret_cast<float4*>(i_hi);
  float4* dl = reinterpret_cast<float4*>(i_lo);
#pragma unroll
  for (int u = 0; u < kImgTile / 4 / kThreads; ++u) {
    cp_async16(dh + u * kThreads + threadIdx.x, hi + u * kThreads + threadIdx.x);
    cp_async16(dl + u * kThreads + threadIdx.x, lo + u * kThreads + threadIdx.x);
  }
  cp_async_commit();
}

// A [P, N] matrix (row-major) transposed into a K-major tile of kMaxN rows
// n, kMaxP deep (p in kpos order), hi and lo; zeros past P and N.
__device__ __forceinline__ void stage_cols(float* t_hi, float* t_lo, const float* src,
                                           const Shape& sh) {
  constexpr int kBatch = 16;
  for (int e0 = 0; e0 < kMaxN * kMaxP; e0 += kBatch * kThreads) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads + threadIdx.x, p = e / kMaxN, n = e % kMaxN;
      v[u] = (p < sh.P && n < sh.N) ? src[p * sh.N + n] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads + threadIdx.x, p = e / kMaxN, n = e % kMaxN;
      uint32_t hi, lo;
      split(v[u], hi, lo);
      const int i = sw128(kMaxN, n, (p & ~7) + kpos(p & 7));
      t_hi[i] = __uint_as_float(hi);
      t_lo[i] = __uint_as_float(lo);
    }
  }
}

// ---- 0. the images of Bᵀ and Cᵀ ----

// Grid (2·row tiles stages, chunk, b·g·2).  8 lanes along n and 4 along the
// steps: the loads fill whole 32-byte sectors.
__global__ void __launch_bounds__(kThreads)
bc_image_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
                float* __restrict__ img, Shape sh) {
  const int stage = blockIdx.x, c = blockIdx.y, bg = blockIdx.z >> 1, which = blockIdx.z & 1;
  const int b = bg / sh.G, g = bg % sh.G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* const src =
      (which ? cm : bm) + row_bsg(sh, b, static_cast<long long>(c) * sh.Q, g);
  float* const out = img + img_at(sh, bg, c, which) + stage * kStageTile;
  const int lo_off = 2 * row_tiles(sh) * kStageTile;
#pragma unroll 8
  for (int u = 0; u < kStageTile / kThreads; ++u) {
    const int combo = u * 4 + warp;
    const int n = (combo % 16) * 8 + (lane & 7), jj = (combo / 16) * 4 + (lane >> 3);
    const int t = stage * kStep + jj;
    const float v = (t < sh.Q && n < sh.N)
        ? src[static_cast<long long>(t) * sh.G * sh.N + n] : 0.f;
    uint32_t hi, lo;
    split(v, hi, lo);
    const int i = sw128(kMaxN, n, (jj & ~7) + kpos(jj & 7));
    out[i] = __uint_as_float(hi);
    out[lo_off + i] = __uint_as_float(lo);
  }
}

// ---- 1. the scores ----

// Grid (tile pair, chunk, b·g·2): z even S = C·Bᵀ (rows the query tile),
// z odd Sᵀ = B·Cᵀ (rows the key tile).
constexpr int kScoresSmem = 4 * 2 * kRowTile + 1024;

__global__ void __launch_bounds__(kThreads)
score_pairs_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
                   float* __restrict__ ws_sc, Shape sh) {
  extern __shared__ uint8_t smem_raw[];
  float* const r_hi = reinterpret_cast<float*>(align1024(smem_raw));
  int it, jt;
  tile_pair(blockIdx.x, &it, &jt);
  const int c = blockIdx.y, bg = blockIdx.z >> 1, which = blockIdx.z & 1;
  const int b = bg / sh.G, g = bg % sh.G;
  const int per = pairs(sh);
  float4* const out = score_tile(ws_sc, sh, bg, c, which * per + blockIdx.x, 2 * per);
  // (the operands are selected, not the call: no wgmma under a branch)
  score_block(which ? bm : cm, (which ? jt : it) * kT, which ? cm : bm, (which ? it : jt) * kT,
              out, r_hi, r_hi + kRowTile, sh, b, static_cast<long long>(c) * sh.Q, g);
}

// This thread's 32 values of score tile `p` (of 2·pairs) in the
// accumulator's layout.
__device__ __forceinline__ void load_scores(float (&sc)[kT / 2], float* ws_sc, const Shape& sh,
                                            int bg, int c, int p) {
  const float4* sp = score_tile(ws_sc, sh, bg, c, p, 2 * pairs(sh));
#pragma unroll
  for (int u = 0; u < kT / 8; ++u) {
    const float4 v = sp[u * kThreads + threadIdx.x];
    sc[4 * u] = v.x;
    sc[4 * u + 1] = v.y;
    sc[4 * u + 2] = v.z;
    sc[4 * u + 3] = v.w;
  }
}

// ---- 2. the chunk sums ----

// Shared memory: two stages of the image (hi, lo), cum (doubles), the
// steps' weights.
constexpr int kSumsSmem = 4 * (2 * 2 * kStageTile + 3 * kMaxQ) + 1024;

__global__ void __launch_bounds__(kThreads)
state_sums_kernel(const float* __restrict__ xdt, const float* __restrict__ dy,
                  const float* __restrict__ la, const float* __restrict__ img,
                  float* __restrict__ ws_s, float* __restrict__ ws_e, float* __restrict__ cd,
                  Shape sh) {
  extern __shared__ uint8_t smem_raw[];
  float* const bt = reinterpret_cast<float*>(align1024(smem_raw));  // [2 stages][hi, lo]
  double* const cum = reinterpret_cast<double*>(bt + 2 * 2 * kStageTile);
  float* const wgt = reinterpret_cast<float*>(cum + kMaxQ);
  const int bh = blockIdx.x, c = blockIdx.y, which = blockIdx.z;
  const int b = bh / sh.H, h = bh % sh.H, g = h / (sh.H / sh.G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const long long s0 = static_cast<long long>(c) * sh.Q;
  const float* const x_base = (which ? dy : xdt) + row_bsh(sh, b, s0, h);
  const long long x_ld = static_cast<long long>(sh.H) * sh.P;
  const int stages = (sh.Q + kStep - 1) / kStep;
  const float* const src = img + img_at(sh, b * sh.G + g, c, which);
  const int lo_off = 2 * row_tiles(sh) * kStageTile;
  auto copy_stage = [&](int s) {  // one stage's hi and lo, 32 KB
    const float4* hi = reinterpret_cast<const float4*>(src + s * kStageTile);
    const float4* lo = reinterpret_cast<const float4*>(src + lo_off + s * kStageTile);
    float4* dst = reinterpret_cast<float4*>(bt + (s & 1) * 2 * kStageTile);
#pragma unroll
    for (int u = 0; u < kStageTile / 4 / kThreads; ++u) {
      cp_async16(dst + u * kThreads + tid, hi + u * kThreads + tid);
      cp_async16(dst + kStageTile / 4 + u * kThreads + tid, lo + u * kThreads + tid);
    }
  };
  // This thread's A fragments of the stage from step j0: register r of k8
  // step kk is x[t][p], p = 16w + l/4 + 8(r % 2), t = j0 + 8kk + 2(l % 4) +
  // r / 2 (the image's kpos order).
  auto load_a = [&](float (&xa)[kStep / 8][4], int j0) {
#pragma unroll
    for (int kk = 0; kk < kStep / 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = 16 * warp + g8 + 8 * (r & 1), t = j0 + 8 * kk + 2 * t4 + (r >> 1);
        xa[kk][r] = (t < sh.Q && p < sh.P) ? x_base[t * x_ld + p] : 0.f;
      }
  };
  copy_stage(0);
  cp_async_commit();
  chunk_cumsum(cum, la, sh, b, h, c);
  const double last = cum[sh.Q - 1];
  for (int t = tid; t < sh.Q; t += kThreads)
    wgt[t] = expf(static_cast<float>(which ? cum[t] : last - cum[t]));
  float xa[kStep / 8][4], xn[kStep / 8][4];
  load_a(xa, 0);
  float total[kMaxN / 2], part[kMaxN / 2];  // rows p, columns n
  zero(total);
  for (int s = 0; s < stages; ++s) {
    const int j0 = s * kStep;
    if (s + 1 < stages) {
      copy_stage(s + 1);
      load_a(xn, j0 + kStep);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this stage's copy has landed
    fence_async_smem();
    __syncthreads();     // (and wgt is written)
    const float* const b_hi = bt + (s & 1) * 2 * kStageTile;
    zero(part);
    frag_product<kMaxN, kStep / 8>(
        part,
        [&](int kk, float(&x)[4]) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            x[r] = xa[kk][r] * wgt[min(j0 + 8 * kk + 2 * t4 + (r >> 1), sh.Q - 1)];
        },
        b_hi, b_hi + kStageTile);
    add(total, part);
    __syncthreads();  // this stage's buffer is refilled two stages on
#pragma unroll
    for (int kk = 0; kk < kStep / 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) xa[kk][r] = xn[kk][r];
  }
  float* const out = (which ? ws_e : ws_s) +
                     (static_cast<long long>(bh) * sh.nc + c) * sh.P * sh.N;
#pragma unroll
  for (int j = 0; j < kMaxN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = 16 * warp + g8 + 8 * (e >> 1), n = 8 * j + 2 * t4 + (e & 1);
      if (p < sh.P && n < sh.N) out[p * sh.N + n] = total[4 * j + e];
    }
  if (which == 0 && tid == 0)
    cd[static_cast<long long>(bh) * sh.nc + c] = expf(static_cast<float>(last));
}

// ---- 3. the state passes ----

// One thread per (b·h, p, n): ws_s's contributions become the states
// entering each chunk, ws_e's E_c the gradients D_c of the states leaving.
__global__ void __launch_bounds__(kPassThreads)
state_passes_kernel(float* __restrict__ ws_s, float* __restrict__ ws_e,
                    const float* __restrict__ cd, const float* __restrict__ dh_final,
                    Shape sh) {
  const int pn = sh.P * sh.N;
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= pn) return;
  const long long bh = blockIdx.y;
  float* const hs = ws_s + bh * sh.nc * pn + e;
  float* const ds = ws_e + bh * sh.nc * pn + e;
  const float* const dec = cd + bh * sh.nc;
  float h = 0.f;
  for (int c0 = 0; c0 < sh.nc; c0 += kPassAhead) {
    float v[kPassAhead], dv[kPassAhead];
#pragma unroll
    for (int u = 0; u < kPassAhead; ++u) {
      const int c = c0 + u;
      v[u] = c < sh.nc ? hs[static_cast<long long>(c) * pn] : 0.f;
      dv[u] = c < sh.nc ? dec[c] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPassAhead; ++u) {
      const int c = c0 + u;
      if (c < sh.nc) {
        hs[static_cast<long long>(c) * pn] = h;
        h = h * dv[u] + v[u];
      }
    }
  }
  float d = dh_final != nullptr ? dh_final[bh * pn + e] : 0.f;
  for (int c1 = sh.nc; c1 > 0; c1 -= kPassAhead) {  // chunks c1 - 1 down to c1 - kPassAhead
    float v[kPassAhead], dv[kPassAhead];
#pragma unroll
    for (int u = 0; u < kPassAhead; ++u) {
      const int c = c1 - 1 - u;
      v[u] = c >= 0 ? ds[static_cast<long long>(c) * pn] : 0.f;
      dv[u] = c >= 0 ? dec[c] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPassAhead; ++u) {
      const int c = c1 - 1 - u;
      if (c >= 0) {
        ds[static_cast<long long>(c) * pn] = d;
        d = d * dv[u] + v[u];
      }
    }
  }
}

// ---- 4. dxdt ----

// Shared memory: per query tile dyᵀ [p][q], hi and lo, whose space then
// holds D's tiles [p][n]; cum (doubles).
constexpr int kDxSmem = 4 * (2 * kRowTile + 2 * kMaxQ) + 1024;
static_assert(2 * kXTile <= 2 * kRowTile, "dyᵀ fits in D's tiles");

__global__ void __launch_bounds__(kThreads, 2)
keys_dx_kernel(const float* __restrict__ dy, const float* __restrict__ la,
               const float* __restrict__ bm, const float* __restrict__ ws_e,
               float* __restrict__ ws_sc, float* __restrict__ dxdt, Shape sh) {
  extern __shared__ uint8_t smem_raw[];
  float* const r_hi = reinterpret_cast<float*>(align1024(smem_raw));
  float* const r_lo = r_hi + kRowTile;
  float* const y_hi = r_hi;  // during the query tiles
  float* const y_lo = r_hi + kXTile;
  double* const cum = reinterpret_cast<double*>(r_lo + kRowTile);
  const int kt = blockIdx.x, k0 = kt * kT, bh = blockIdx.y, c = blockIdx.z;
  const int b = bh / sh.H, h = bh % sh.H, g = h / (sh.H / sh.G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int tq = gridDim.x;
  const long long s0 = static_cast<long long>(c) * sh.Q;
  const float* const dy_base = dy + row_bsh(sh, b, s0, h);
  const int x_ld = sh.H * sh.P;
  chunk_cumsum(cum, la, sh, b, h, c);
  float total[kT / 2], part[kT / 2];  // rows k, columns p
  zero(total);
  float yv[kOutX];  // the next query tile's dy, loaded while a product runs
  load_xdt(yv, dy_base, x_ld, sh, k0);
  for (int qt = kt; qt < tq; ++qt) {
    const int q0 = qt * kT;
    float sc[kT / 2];  // Sᵀ: rows k, columns q
    load_scores(sc, ws_sc, sh, b * sh.G + g, c, pairs(sh) + qt * (qt + 1) / 2 + kt);
    __syncthreads();  // every wgmma reading dyᵀ has completed
    store_xdt(yv, y_hi, y_lo);
    __syncthreads();
    if (qt + 1 < tq) load_xdt(yv, dy_base, x_ld, sh, q0 + kT);
#pragma unroll
    for (int jb = 0; jb < kT / 8; ++jb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + 16 * warp + g8 + 8 * (e >> 1), q = q0 + 8 * jb + 2 * t4 + (e & 1);
        sc[4 * jb + e] *= decay(cum, q, k, sh.Q);
      }
    zero(part);
    frag_product<kMaxP, kT / 8>(part, [&](int kk, float(&x)[4]) { acc_frag(sc, kk, x); },
                                y_hi, y_lo);
    add(total, part);
  }
  // the state term exp(cum_last - cum_k) · B_k·Dᵀ over N
  __syncthreads();
  stage_rows(r_hi, r_lo, ws_e + (static_cast<long long>(bh) * sh.nc + c) * sh.P * sh.N, sh.N,
             0, sh.P, sh.N);
  float cf[kNK][4];
  load_c(cf, bm, sh, b, s0, g, k0);
  fence_async_smem();
  __syncthreads();
  zero(part);
  c_product(part, cf, r_hi, r_lo);
  const double last = cum[sh.Q - 1];
#pragma unroll
  for (int j = 0; j < kMaxP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + 16 * warp + g8 + 8 * (e >> 1), p = 8 * j + 2 * t4 + (e & 1);
      if (k < sh.Q && p < sh.P) {
        const float w = expf(static_cast<float>(last - cum[k]));
        dxdt[row_bsh(sh, b, s0 + k, h) + p] = total[4 * j + e] + w * part[4 * j + e];
      }
    }
}

// ---- 5. dB and S_k, 6. dC, I_q and the crossing sums ----

// Shared memory: the other tile's rows [64][P] (dy for the keys, xdt for
// the queries), hi and lo; the image tile [kMaxN n][64 steps], hi and lo,
// whose space then holds the state matrix transposed [n][p]; cum
// (doubles); the four warps' column sums.
constexpr int kPairSmem = 4 * (2 * kXTile + 2 * kImgTile + 2 * kMaxQ + 4 * kT) + 1024;
static_assert(kMaxN * kMaxP <= kImgTile, "the state matrix fits in the image tile");

// The rows' sums Σ_n Y[row][n]·Z[row][n] of a 64 x kMaxN accumulator Z
// (this thread's rows 16w + l/4 and + 8) with Y [rows, N] (row r at
// y_base + r·y_ld, zeros past `rows` and N), over the quad in a fixed tree.
__device__ __forceinline__ void row_dots(float (&out)[2], const float (&z)[kMaxN / 2],
                                         const float* y_base, long long y_ld, int r0, int rows,
                                         int width) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  out[0] = out[1] = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 16 * warp + (lane >> 2) + 8 * (e >> 1);
      const int n = 8 * j + 2 * (lane & 3) + (e & 1);
      const float y = (r < rows && n < width) ? y_base[r * y_ld + n] : 0.f;
      out[e >> 1] = fmaf(y, z[4 * j + e], out[e >> 1]);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    out[i] += __shfl_xor_sync(kFull, out[i], 1);
    out[i] += __shfl_xor_sync(kFull, out[i], 2);
  }
}

// Writes row r0 + 16w + l/4 + 8i (< Q) of a per-head [.., N] gradient as
// total + w_i·part and, from lane l % 4 == 0, the row's term w_i·dot_i.
__device__ __forceinline__ void write_grad_rows(float* __restrict__ dyp, float* __restrict__ term,
                                           const float (&total)[kMaxN / 2],
                                           const float (&part)[kMaxN / 2],
                                           const float (&w)[2], const float (&dot)[2],
                                           const Shape& sh, int b, long long s0, int h, int r0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 16 * warp + (lane >> 2) + 8 * i;
    if (r >= sh.Q) continue;
    const long long at = at_bsh(sh, b, s0 + r, h);
    if ((lane & 3) == 0) term[at] = w[i] * dot[i];
    float* const dst = dyp + at * sh.N;
#pragma unroll
    for (int j = 0; j < kMaxN / 8; ++j)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int n = 8 * j + 2 * (lane & 3) + e1, e = 2 * i + e1;
        if (n < sh.N) dst[n] = total[4 * j + e] + w[i] * part[4 * j + e];
      }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
keys_db_kernel(const float* __restrict__ xdt, const float* __restrict__ dy,
               const float* __restrict__ la, const float* __restrict__ bm,
               const float* __restrict__ img, const float* __restrict__ ws_e,
               float* __restrict__ dbp, float* __restrict__ spart, Shape sh) {
  extern __shared__ uint8_t smem_raw[];
  float* const y_hi = reinterpret_cast<float*>(align1024(smem_raw));
  float* const y_lo = y_hi + kXTile;
  float* const i_hi = y_lo + kXTile;
  float* const i_lo = i_hi + kImgTile;
  double* const cum = reinterpret_cast<double*>(i_lo + kImgTile);
  const int kt = blockIdx.x, k0 = kt * kT, bh = blockIdx.y, c = blockIdx.z;
  const int b = bh / sh.H, h = bh % sh.H, g = h / (sh.H / sh.G);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int tq = gridDim.x;
  const long long s0 = static_cast<long long>(c) * sh.Q;
  const long long x_ld = static_cast<long long>(sh.H) * sh.P;
  const float* const dy_base = dy + row_bsh(sh, b, s0, h);
  const float* const c_img = img + img_at(sh, b * sh.G + g, c, 1);
  float xf[kPK][4];  // xdt_k: rows k, depth p
  load_frag(xf, xdt + row_bsh(sh, b, s0, h), x_ld, k0, sh.Q, sh.P);
  chunk_cumsum(cum, la, sh, b, h, c);
  float total[kMaxN / 2];  // rows k, columns n
  zero(total);
  for (int qt = kt; qt < tq; ++qt) {
    const int q0 = qt * kT;
    __syncthreads();  // every wgmma reading the shared tiles has completed
    copy_img_tile(i_hi, i_lo, c_img, sh, qt);  // Cᵀ [n][q]
    stage_rows<kMaxP>(y_hi, y_lo, dy_base, x_ld, q0, sh.Q, sh.P);
    fence_async_smem();
    __syncthreads();
    float dd[kT / 2];  // ddᵀ then Wᵀ: rows k, columns q
    zero(dd);
    frag_product<kT, kPK>(dd, [&](int kk, float(&x)[4]) {
#pragma unroll
      for (int r = 0; r < 4; ++r) x[r] = xf[kk][r];
    }, y_hi, y_lo);
#pragma unroll
    for (int jb = 0; jb < kT / 8; ++jb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + 16 * warp + g8 + 8 * (e >> 1), q = q0 + 8 * jb + 2 * t4 + (e & 1);
        dd[4 * jb + e] = decay(cum, q, k, sh.Q) * dd[4 * jb + e];
      }
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    float part[kMaxN / 2];
    zero(part);
    frag_product<kMaxN, kT / 8>(part, [&](int kk, float(&x)[4]) { acc_frag(dd, kk, x); },
                                i_hi, i_lo);
    add(total, part);
  }
  float part[kMaxN / 2];
  // the state terms: Dᵀ xdt_k over P, dB += w_k·it, S_k = w_k·B_k·it
  __syncthreads();
  stage_cols(i_hi, i_lo, ws_e + (static_cast<long long>(bh) * sh.nc + c) * sh.P * sh.N, sh);
  fence_async_smem();
  __syncthreads();
  zero(part);
  frag_product<kMaxN, kPK>(part, [&](int kk, float(&x)[4]) {
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = xf[kk][r];
  }, i_hi, i_lo);
  const double last = cum[sh.Q - 1];
  float w[2], dot[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    w[i] = expf(static_cast<float>(last - cum[min(k0 + 16 * warp + g8 + 8 * i, sh.Q - 1)]));
  row_dots(dot, part, bm + row_bsg(sh, b, s0, g), static_cast<long long>(sh.G) * sh.N, k0,
           sh.Q, sh.N);
  write_grad_rows(dbp, spart, total, part, w, dot, sh, b, s0, h, k0);
}

// Σ over the tile's rows q >= t (q < Q) of Σ_{k<t} M[q, k] for each key t of
// the tile from k0, into cross_out[t]: M this thread's values of the 64 x 64
// tile (rows q0 + 16w + l/4 + 8(e/2), keys k0 + 8j + 2(l % 4) + e % 2), each
// row's exclusive prefix over the keys from the quad's inclusive scan of its
// column pairs, carried over the key tiles in `carry` (the same in the
// quad's four lanes); the masked column sums over the warp's 8 row groups
// by a shuffle tree, then over the four warps in order.
__device__ __forceinline__ void crossing(const float (&m)[kT / 2], float (&carry)[2], int q0,
                                         int k0, int Q, float* __restrict__ cross_out,
                                         float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  float cs[kT / 4];  // this thread's 16 columns 8j + 2t4 + e1 at 2j + e1
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = q0 + 16 * warp + g8 + 8 * i;
    float run = carry[i];  // Σ of the row's keys before block j
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
      const float m0 = m[4 * j + 2 * i], m1 = m[4 * j + 2 * i + 1];
      float inc = m0 + m1;
      float up = __shfl_up_sync(kFull, inc, 1, 4);
      if (t4 >= 1) inc += up;
      up = __shfl_up_sync(kFull, inc, 2, 4);
      if (t4 >= 2) inc += up;
      const float excl = __shfl_up_sync(kFull, inc, 1, 4);
      const float tot = __shfl_sync(kFull, inc, 3, 4);
      const float p0 = t4 >= 1 ? run + excl : run;  // Σ_{k < 8j + 2t4}
      const float p1 = p0 + m0;
      const int t0 = k0 + 8 * j + 2 * t4;
      const float v0 = (q < Q && q >= t0) ? p0 : 0.f;
      const float v1 = (q < Q && q >= t0 + 1) ? p1 : 0.f;
      cs[2 * j] = i == 0 ? v0 : cs[2 * j] + v0;
      cs[2 * j + 1] = i == 0 ? v1 : cs[2 * j + 1] + v1;
      run += tot;
    }
    carry[i] = run;
  }
#pragma unroll
  for (int u = 0; u < kT / 4; ++u) {
    cs[u] += __shfl_xor_sync(kFull, cs[u], 4);
    cs[u] += __shfl_xor_sync(kFull, cs[u], 8);
    cs[u] += __shfl_xor_sync(kFull, cs[u], 16);
  }
  if (g8 == 0) {
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
      red[warp * kT + 8 * j + 2 * t4] = cs[2 * j];
      red[warp * kT + 8 * j + 2 * t4 + 1] = cs[2 * j + 1];
    }
  }
  __syncthreads();
  const int col = threadIdx.x;
  if (col < kT && k0 + col < Q)
    cross_out[k0 + col] = ((red[col] + red[kT + col]) + red[2 * kT + col]) + red[3 * kT + col];
}

__global__ void __launch_bounds__(kThreads, 2)
queries_dc_kernel(const float* __restrict__ xdt, const float* __restrict__ dy,
                  const float* __restrict__ la, const float* __restrict__ cm,
                  const float* __restrict__ img, const float* __restrict__ ws_s,
                  float* __restrict__ ws_sc, float* __restrict__ dcp, float* __restrict__ qpart,
                  float* __restrict__ cross, Shape sh) {
  extern __shared__ uint8_t smem_raw[];
  float* const x_hi = reinterpret_cast<float*>(align1024(smem_raw));
  float* const x_lo = x_hi + kXTile;
  float* const i_hi = x_lo + kXTile;
  float* const i_lo = i_hi + kImgTile;
  double* const cum = reinterpret_cast<double*>(i_lo + kImgTile);
  float* const red = reinterpret_cast<float*>(cum + kMaxQ);
  const int qt = blockIdx.x, q0 = qt * kT, bh = blockIdx.y, c = blockIdx.z;
  const int b = bh / sh.H, h = bh % sh.H, g = h / (sh.H / sh.G);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int tq = gridDim.x;
  const long long s0 = static_cast<long long>(c) * sh.Q;
  const long long x_ld = static_cast<long long>(sh.H) * sh.P;
  const float* const x_base = xdt + row_bsh(sh, b, s0, h);
  const float* const b_img = img + img_at(sh, b * sh.G + g, c, 0);
  float* const cross_out = cross + ((static_cast<long long>(bh) * sh.nc + c) * tq + qt) * sh.Q;
  float yf[kPK][4];  // dy_q: rows q, depth p
  load_frag(yf, dy + row_bsh(sh, b, s0, h), x_ld, q0, sh.Q, sh.P);
  chunk_cumsum(cum, la, sh, b, h, c);
  float total[kMaxN / 2];  // rows q, columns n
  zero(total);
  float carry[2] = {0.f, 0.f};
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();  // every wgmma reading the shared tiles (and every read of red) is done
    copy_img_tile(i_hi, i_lo, b_img, sh, kt);  // Bᵀ [n][k]
    float sc[kT / 2];  // S then M
    load_scores(sc, ws_sc, sh, b * sh.G + g, c, qt * (qt + 1) / 2 + kt);
    stage_rows<kMaxP>(x_hi, x_lo, x_base, x_ld, k0, sh.Q, sh.P);
    fence_async_smem();
    __syncthreads();
    float dd[kT / 2];  // dd then W: rows q, columns k
    zero(dd);
    frag_product<kT, kPK>(dd, [&](int kk, float(&x)[4]) {
#pragma unroll
      for (int r = 0; r < 4; ++r) x[r] = yf[kk][r];
    }, x_hi, x_lo);
#pragma unroll
    for (int jb = 0; jb < kT / 8; ++jb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = q0 + 16 * warp + g8 + 8 * (e >> 1), k = k0 + 8 * jb + 2 * t4 + (e & 1);
        const float l = decay(cum, q, k, sh.Q);
        sc[4 * jb + e] = (sc[4 * jb + e] * l) * dd[4 * jb + e];
        dd[4 * jb + e] = l * dd[4 * jb + e];
      }
    crossing(sc, carry, q0, k0, sh.Q, cross_out, red);
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    float part[kMaxN / 2];
    zero(part);
    frag_product<kMaxN, kT / 8>(part, [&](int kk, float(&x)[4]) { acc_frag(dd, kk, x); },
                                i_hi, i_lo);
    add(total, part);
  }
  float part[kMaxN / 2];
  // the inter term: h_prevᵀ dy_q over P, dC += w_q·it, I_q = w_q·C_q·it
  __syncthreads();
  stage_cols(i_hi, i_lo, ws_s + (static_cast<long long>(bh) * sh.nc + c) * sh.P * sh.N, sh);
  fence_async_smem();
  __syncthreads();
  zero(part);
  frag_product<kMaxN, kPK>(part, [&](int kk, float(&x)[4]) {
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = yf[kk][r];
  }, i_hi, i_lo);
  float w[2], dot[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    w[i] = expf(static_cast<float>(cum[min(q0 + 16 * warp + g8 + 8 * i, sh.Q - 1)]));
  row_dots(dot, part, cm + row_bsg(sh, b, s0, g), static_cast<long long>(sh.G) * sh.N, q0,
           sh.Q, sh.N);
  write_grad_rows(dcp, qpart, total, part, w, dot, sh, b, s0, h, q0);
}

// ---- 7. dla ----

// Per (b·h, chunk): <D, h_prev> by a fixed tree over the block; each step's
// crossing sum over the query tiles at or after its own, in order; then, in
// one thread, I's suffix and S's exclusive prefix sums and dla.
__global__ void __launch_bounds__(kPassThreads)
finish_kernel(const float* __restrict__ ws_s, const float* __restrict__ ws_e,
              const float* __restrict__ cd, const float* __restrict__ cross,
              const float* __restrict__ qpart, const float* __restrict__ spart,
              float* __restrict__ dla, Shape sh) {
  __shared__ float red[kPassThreads];
  __shared__ float xs[kMaxQ];
  __shared__ float iq[kMaxQ];
  __shared__ float sk[kMaxQ];
  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / sh.H, h = bh % sh.H;
  const int tid = threadIdx.x;
  const int pn = sh.P * sh.N;
  const int tiles = row_tiles(sh);
  const long long base = (static_cast<long long>(bh) * sh.nc + c) * pn;
  float acc = 0.f;
  for (int e = tid; e < pn; e += kPassThreads) acc = fmaf(ws_e[base + e], ws_s[base + e], acc);
  red[tid] = acc;
  const long long s0 = static_cast<long long>(c) * sh.Q;
  const float* const cross_c = cross + (static_cast<long long>(bh) * sh.nc + c) * tiles * sh.Q;
  for (int t = tid; t < sh.Q; t += kPassThreads) {
    float sum = 0.f;
    for (int rt = t / kT; rt < tiles; ++rt) sum += cross_c[rt * sh.Q + t];
    xs[t] = sum;
    const long long at = at_bsh(sh, b, s0 + t, h);
    iq[t] = qpart[at];
    sk[t] = spart[at];
  }
  __syncthreads();
  for (int half = kPassThreads / 2; half > 0; half /= 2) {
    if (tid < half) red[tid] += red[tid + half];
    __syncthreads();
  }
  if (tid == 0) {
    const float extra = cd[static_cast<long long>(bh) * sh.nc + c] * red[0];
    float pre = 0.f;
    for (int t = 0; t < sh.Q; ++t) {  // sk[t] := Σ_{k<t} S_k
      const float v = sk[t];
      sk[t] = pre;
      pre += v;
    }
    float suf = 0.f;
    for (int t = sh.Q - 1; t >= 0; --t) {
      suf += iq[t];
      dla[at_bsh(sh, b, s0 + t, h)] = xs[t] + suf + sk[t] + extra;
    }
  }
}

// ---- 8. dB and dC over the heads of a group ----

// Grid (ceil(B·S·G·N / 256), 2): z = 0 dB from dbp, z = 1 dC from dcp.
__global__ void __launch_bounds__(kPassThreads)
group_sum_kernel(const float* __restrict__ dbp, const float* __restrict__ dcp,
                 float* __restrict__ db, float* __restrict__ dc, Shape sh) {
  const long long e = static_cast<long long>(blockIdx.x) * kPassThreads + threadIdx.x;
  const long long total = static_cast<long long>(sh.B) * sh.S * sh.G * sh.N;
  if (e >= total) return;
  const int n = static_cast<int>(e % sh.N);
  const long long bsg = e / sh.N;
  const int g = static_cast<int>(bsg % sh.G);
  const long long bs = bsg / sh.G;
  const int rep = sh.H / sh.G;
  const float* const src = blockIdx.y ? dcp : dbp;
  float s = 0.f;
  for (int u = 0; u < rep; ++u) s += src[(bs * sh.H + g * rep + u) * sh.N + n];
  (blockIdx.y ? dc : db)[e] = s;
}

}  // namespace

// The backward of B10.  xdt and dy [B, S, H, P], la [B, S, H], bm and cm
// [B, S, G, N], dh_final [B, H, P, N] (or null: zero), all float32
// contiguous; dxdt [B, S, H, P], dla [B, S, H], db and dc [B, S, G, N] out;
// ws_s and ws_e [B·H, S/Q, P, N], cd [B·H, S/Q], cross [B·H, S/Q,
// ceil(Q / 64), Q], qpart and spart [B, S, H], dbp and dcp [B, S, H, N],
// ws_sc [B·G, S/Q, 2T, 64, 64] (the T = t(t + 1)/2 tile pairs of t =
// ceil(Q / 64) row tiles, S's then Sᵀ's) and img [B·G, S/Q, 2, 2, 2t,
// 128 · 32] are float32 scratch from the caller.  Q divides S.  Launches
// nine kernels on `stream`; returns the first error (0 = launched), or
// cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int ssd_chunk_bwd_f32(const float* xdt, const float* la, const float* bm,
                                 const float* cm, const float* dy, const float* dh_final,
                                 float* dxdt, float* dla, float* db, float* dc, float* ws_s,
                                 float* ws_e, float* cd, float* cross, float* qpart,
                                 float* spart, float* dbp, float* dcp, float* ws_sc, float* img,
                                 int B, int S, int H, int G, int P, int N, int Q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 || P > kMaxP ||
      N <= 0 || N > kMaxN || Q <= 0 || Q > kMaxQ || S % Q != 0)
    return cudaErrorInvalidValue;
  const Shape sh{B, S, H, G, P, N, Q, S / Q};
  if (sh.nc > 65535 || B * H > 65535 || 2 * B * G > 65535) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const struct {
    const void* fn;
    int bytes;
  } smem[] = {{reinterpret_cast<const void*>(score_pairs_kernel), kScoresSmem},
              {reinterpret_cast<const void*>(state_sums_kernel), kSumsSmem},
              {reinterpret_cast<const void*>(keys_dx_kernel), kDxSmem},
              {reinterpret_cast<const void*>(keys_db_kernel), kPairSmem},
              {reinterpret_cast<const void*>(queries_dc_kernel), kPairSmem}};
  for (const auto& k : smem) {
    const cudaError_t err =
        cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k.bytes);
    if (err != cudaSuccess) return err;
  }
  const int tq = (Q + kT - 1) / kT;
  const dim3 tiles(tq, B * H, sh.nc);
  bc_image_kernel<<<dim3(2 * tq, sh.nc, 2 * B * G), kThreads, 0, st>>>(bm, cm, img, sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  score_pairs_kernel<<<dim3(tq * (tq + 1) / 2, sh.nc, 2 * B * G), kThreads, kScoresSmem, st>>>(
      bm, cm, ws_sc, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  state_sums_kernel<<<dim3(B * H, sh.nc, 2), kThreads, kSumsSmem, st>>>(xdt, dy, la, img, ws_s,
                                                                        ws_e, cd, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  state_passes_kernel<<<dim3((P * N + kPassThreads - 1) / kPassThreads, B * H), kPassThreads, 0,
                        st>>>(ws_s, ws_e, cd, dh_final, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  keys_dx_kernel<<<tiles, kThreads, kDxSmem, st>>>(dy, la, bm, ws_e, ws_sc, dxdt, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  keys_db_kernel<<<tiles, kThreads, kPairSmem, st>>>(xdt, dy, la, bm, img, ws_e, dbp, spart, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  queries_dc_kernel<<<tiles, kThreads, kPairSmem, st>>>(xdt, dy, la, cm, img, ws_s, ws_sc, dcp,
                                                        qpart, cross, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finish_kernel<<<dim3(B * H, sh.nc), kPassThreads, 0, st>>>(ws_s, ws_e, cd, cross, qpart,
                                                             spart, dla, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(B) * S * G * N;
  group_sum_kernel<<<dim3(static_cast<unsigned>((total + kPassThreads - 1) / kPassThreads), 2),
                     kPassThreads, 0, st>>>(dbp, dcp, db, dc, sh);
  return cudaGetLastError();
}
