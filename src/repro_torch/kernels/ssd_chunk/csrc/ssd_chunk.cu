// Mamba-2 SSD chunked scan on Hopper (sm_90a): 3xTF32 wgmma with float32
// accumulators.
//
// Replaces the Pallas TPU kernel `ssd_chunk_kernel` (body `_kernel`) of
// src/repro/kernels/ssd_chunk/kernel.py (B10).  Per batch b and head h, over
// chunks of Q steps (cum = the within-chunk cumulative sum of la):
//
//     intra:  y_i  = Σ_{j<=i} (c_i · b_j) · exp(cum_i - cum_j) · xdt_j
//     inter:  y_i += exp(cum_i) · (h_prev · c_i)
//     state:  h    = exp(cum_last) · h_prev + Σ_j exp(cum_last - cum_j) · xdt_j ⊗ b_j
//
// from h = 0, float32 but for cum, which is summed in double (the
// differences cum_i - cum_j lose ~1e-4 of exp(...) in float32 at mamba2's
// decays; found by the gradient checks of training).  Layout (the model's, read in place): xdt
// [B, S, H, P], la [B, S, H], bm and cm [B, S, G, N]; head h reads group
// h / (H / G), so B and C are never repeated per head (at mamba2-780m's
// shape a per-head copy would be 805 MB against 17 MB).  y [B, S, H, P],
// h_final [B, H, P, N].  P <= 64, N <= 128, Q <= 256.
//
// What bounds it.  At mamba2-780m's prefill (4 x 4,096, 48 heads of P 64,
// N 128, Q 256) the function is 6.46e10 FLOP against ~0.45 GB moved: 0.96
// ms on the FP32 cores (67 TFLOP/s), 0.39 ms as three TF32 products on the
// tensor cores (495 / 3 TFLOP/s), 0.13 ms for the bytes.  So it is bound by
// operations; the FP32-core version took 4.9 ms, 3.5 of them in the output
// kernel.
//
// Design.  The Pallas grid carries the [P, N] state in VMEM along a
// sequential chunk axis.  Hopper's blocks run in no order, so the scan is
// split as the model's `mamba2.ssd_chunked` splits it, into five launches
// (at mamba2's shape 192 (b, h) pairs for 132 SMs, with 16 chunks each: one
// block per pair would leave the card in 1.5 uneven waves):
//
//   0. `bt_kernel`, per (b·g, chunk, 32 steps): Bᵀ split into hi and lo
//      and swizzled as the state product's B operand, once per group
//      instead of once per head.
//   1. `chunk_state_kernel`, one warpgroup per (b·h, chunk): the chunk's
//      state contribution (xdt ∘ decay_end)ᵀ · B [P, N] (wgmma m64n128k8,
//      the depth over the chunk's steps, 32 at a time, Bᵀ copied in by
//      cp.async a stage ahead) into a workspace [B·H, chunks, P, N], and
//      its decay exp(cum_last).
//   2. `state_pass_kernel`, one thread per (b·h, p, n): the short sequential
//      pass over the chunks, h_prev(c) = h; h = h · decay(c) + contribution(c),
//      writing each chunk's h_prev already split and swizzled as the inter
//      product's B operand (copied by the output kernel with cp.async) and
//      h_final.  It loads eight chunks ahead, so that each thread has eight
//      reads in flight.
//   3. `scores_kernel`, one warpgroup per (b·g, chunk, 64 x 64 tile pair on
//      or below the diagonal): S = C·Bᵀ over N into a workspace.  S depends
//      on the group, not the head, so it is formed once for the H / G heads
//      of a group (48 at mamba2's shape), as the plain version forms it;
//      it was half the output kernel's products.
//   4. `chunk_out_kernel`, one warpgroup per (64-row query tile, b·h,
//      chunk): the inter term C·h_prevᵀ over N, scaled by exp(cum_i), then
//      for each key tile up to the diagonal S (read from L2) ∘ exp(cum_i -
//      cum_j) masked, and y += (S ∘ decay) · xdt, y written once.
//
// Every product is 3xTF32 (../../csrc/tf32x3_sm90.cuh; the tiles, fragments
// and score tiles that the backward shares in ssd_tf32x3.cuh): operands split into
// hi + lo TF32 values, lo·hi + hi·lo + hi·hi into float32 accumulators.
// TF32 wgmma reads B only K-major, so each staging pass that splits an
// operand also writes it in the layout the product wants: B and h_prev are
// [rows][N] already (K = N); xdt [j][p] is written transposed, [p][j], for
// the (S ∘ decay)·xdt product, and B transposed, [n][j], for the state
// (the state's A, xdt ∘ decay_end, comes from registers).  C
// (K = N) is the A operand of S and of the inter term: each thread loads
// its fragment of the 64 x N tile into registers and splits it per step.
// N is padded to 128 with zeros, so that no wgmma is issued under a
// branch (ptxas serialises wgmmas that are).  S ∘ decay becomes the next product's A in place, so the depth of
// that product (the keys) is permuted within each k8 step, and the xdt tile
// is stored in the same order (`kpos`); C and the N-deep tiles take the same
// permutation, so that C's fragment loads two neighbouring columns.
// The grid runs the b·h pairs fastest: the heads of a group run together
// and read their chunk's B and C from L2.  Rows past Q, steps past the
// chunk, p past P and n past N are zeros and never written.

#include <cuda_runtime.h>

#include "ssd_tf32x3.cuh"

namespace {

using namespace ssd;
using namespace tf32x3;

constexpr int kStateStep = kPanel;  // chunk steps per stage of the state product
constexpr int kPassThreads = 256;
constexpr int kPassAhead = 8;       // chunks the state pass loads ahead

// ---- 1. chunk states ----

// Bᵀ of each (b·g, chunk) as the state product's B operand, split and
// swizzled: per stage of 32 steps a hi and a lo tile [kMaxN rows n][32
// steps] (K-major), exactly as shared memory holds them.  B depends on the
// group, not the head, so this is done once for the H / G heads of a group,
// which then copy it with cp.async.
constexpr int kStateTile = kMaxN * kStateStep;          // floats of one hi or lo tile
constexpr int kStateB = kStateStep * kMaxN / kThreads;  // B values a thread splits

__device__ __forceinline__ long long bt_stage(const Shape& sh, int bg, int c, int stage) {
  const int stages = (sh.Q + kStateStep - 1) / kStateStep;
  return ((static_cast<long long>(bg) * sh.nc + c) * stages + stage) * 2 * kStateTile;
}

// Grid (stage, chunk, b·g).  8 lanes along n and 4 along the steps: the
// loads fill whole 32-byte sectors.
__global__ void __launch_bounds__(kThreads)
bt_kernel(const float* __restrict__ bm, float* __restrict__ ws_bt, Shape sh) {
  const int stage = blockIdx.x, c = blockIdx.y, bg = blockIdx.z;
  const int b = bg / sh.G, g = bg % sh.G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = stage * kStateStep;
  const float* const b_base = bm + row_bsg(sh, b, static_cast<long long>(c) * sh.Q, g);
  float* const out = ws_bt + bt_stage(sh, bg, c, stage);
#pragma unroll 8
  for (int u = 0; u < kStateB; ++u) {
    const int combo = u * 4 + warp;
    const int n = (combo % 16) * 8 + (lane & 7), jj = (combo / 16) * 4 + (lane >> 3);
    const int t = j0 + jj;
    const float v = (t < sh.Q && n < sh.N)
        ? b_base[static_cast<long long>(t) * sh.G * sh.N + n] : 0.f;
    uint32_t hi, lo;
    split(v, hi, lo);
    const int i = sw128(kMaxN, n, jj);
    out[i] = __uint_as_float(hi);
    out[kStateTile + i] = __uint_as_float(lo);
  }
}

// Shared memory: two stages of Bᵀ hi and lo, then cum (doubles) and
// decay_end.
constexpr int kStateSmem = 4 * (2 * 2 * kStateTile + 3 * kMaxQ) + 1024;

// This thread's A fragments of one stage, xdt[t][p] for the steps t of
// k8 step kk: register r is p = 16w + l/4 + 8(r % 2), t = 8kk + l%4 + 4(r / 2)
// (scaled by decay_end when the stage is used).
__device__ __forceinline__ void state_a(float (&xa)[kStateStep / 8][4], const float* x_base,
                                        int x_ld, const Shape& sh, int j0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int kk = 0; kk < kStateStep / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = 16 * warp + (lane >> 2) + 8 * (r & 1);
      const int t = j0 + 8 * kk + (lane & 3) + 4 * (r >> 1);
      xa[kk][r] = (t < sh.Q && p < sh.P) ? x_base[static_cast<long long>(t) * x_ld + p] : 0.f;
    }
}

__global__ void __launch_bounds__(kThreads)
chunk_state_kernel(const float* __restrict__ xdt, const float* __restrict__ la,
                   const float* __restrict__ ws_bt, float* __restrict__ ws,
                   float* __restrict__ cd, Shape sh) {
  extern __shared__ uint8_t smem_raw[];
  float* const bt = reinterpret_cast<float*>(align1024(smem_raw));  // [2 stages][hi, lo]
  double* const cum = reinterpret_cast<double*>(bt + 2 * 2 * kStateTile);
  float* const dec = reinterpret_cast<float*>(cum + kMaxQ);
  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / sh.H, h = bh % sh.H, g = h / (sh.H / sh.G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const long long s0 = static_cast<long long>(c) * sh.Q;
  const float* const x_base = xdt + row_bsh(sh, b, s0, h);
  const int x_ld = sh.H * sh.P;
  const int stages = (sh.Q + kStateStep - 1) / kStateStep;
  const float* const bt_src = ws_bt + bt_stage(sh, b * sh.G + g, c, 0);
  auto copy_stage = [&](int s) {  // one stage's 32 KB, 16 bytes a copy
    const float4* src = reinterpret_cast<const float4*>(bt_src + s * 2 * kStateTile);
    float4* dst = reinterpret_cast<float4*>(bt + (s & 1) * 2 * kStateTile);
#pragma unroll
    for (int u = 0; u < 2 * kStateTile / 4 / kThreads; ++u)
      cp_async16(dst + u * kThreads + tid, src + u * kThreads + tid);
  };
  copy_stage(0);
  cp_async_commit();
  chunk_cumsum(cum, la, sh, b, h, c);
  const double last = cum[sh.Q - 1];
  for (int t = tid; t < sh.Q; t += kThreads) dec[t] = expf(static_cast<float>(last - cum[t]));
  // The next stage's Bᵀ (cp.async) and A fragments (registers) are loaded
  // while this stage's wgmmas run.
  float xa[kStateStep / 8][4], xn[kStateStep / 8][4];
  state_a(xa, x_base, x_ld, sh, 0);
  float acc[kMaxN / 2];  // rows p, columns n
#pragma unroll
  for (int e = 0; e < kMaxN / 2; ++e) acc[e] = 0.f;
  uint32_t hi[2][4], lo[2][4];
  for (int s = 0; s < stages; ++s) {
    const int j0 = s * kStateStep;
    if (s + 1 < stages) {
      copy_stage(s + 1);
      state_a(xn, x_base, x_ld, sh, j0 + kStateStep);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this stage's copy has landed
    fence_async_smem();
    __syncthreads();     // (and dec is written)
    const float* b_hi = bt + (s & 1) * 2 * kStateTile;
#pragma unroll
    for (int kk = 0; kk < kStateStep / 8; ++kk) {
      const int u = kk & 1;
      wgmma_wait<1>();  // the group that read set u (two steps back) has completed
      fence_regs(hi[u]);
      fence_regs(lo[u]);
      float x[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        x[r] = xa[kk][r] * dec[min(j0 + 8 * kk + t4 + 4 * (r >> 1), sh.Q - 1)];
      split4(x, hi[u], lo[u]);
      wgmma_fence();
      mma3<kMaxN>(acc, hi[u], lo[u], desc(b_hi, kMaxN, kk), desc(b_hi + kStateTile, kMaxN, kk));
      wgmma_commit();
    }
    wgmma_wait<0>();  // this stage's buffer is refilled two stages on
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kStateStep / 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) xa[kk][r] = xn[kk][r];
  }
  fence_regs(acc);

  float* out = ws + (static_cast<long long>(bh) * sh.nc + c) * sh.P * sh.N;
#pragma unroll
  for (int j = 0; j < kMaxN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = 16 * warp + g8 + 8 * (e >> 1), n = 8 * j + 2 * t4 + (e & 1);
      if (p < sh.P && n < sh.N) out[p * sh.N + n] = acc[4 * j + e];
    }
  if (tid == 0) cd[static_cast<long long>(bh) * sh.nc + c] = expf(static_cast<float>(last));
}

// ---- 2. the state pass ----

// h_prev of each (b·h, chunk) as the inter product's B operand: a K-major
// tile [64 rows p][kMaxN n], hi and lo, the depth n in kpos order within its
// k8 step, zeros past P and N; the output kernel copies it with cp.async.
constexpr int kHpTile = kT * kMaxN;

__device__ __forceinline__ long long hp_tile(const Shape& sh, long long bh, int c) {
  return (bh * sh.nc + c) * 2 * kHpTile;
}

// One thread per (b·h, p, n) of the padded 64 x 128 tile.
__global__ void __launch_bounds__(kPassThreads)
state_pass_kernel(const float* __restrict__ ws, const float* __restrict__ cd,
                  float* __restrict__ hp_img, float* __restrict__ h_final, Shape sh) {
  const int pn = sh.P * sh.N;
  const int e = blockIdx.x * kPassThreads + threadIdx.x, p = e / kMaxN, n = e % kMaxN;
  const long long bh = blockIdx.y;
  const bool valid = p < sh.P && n < sh.N;
  const int src = p * sh.N + n;
  const int dst = sw128(kT, p, (n & ~7) + kpos(n & 7));
  float h = 0.f;
  for (int c0 = 0; c0 < sh.nc; c0 += kPassAhead) {
    float v[kPassAhead], dec[kPassAhead];
#pragma unroll
    for (int u = 0; u < kPassAhead; ++u) {
      const int c = c0 + u;
      v[u] = (valid && c < sh.nc) ? ws[(bh * sh.nc + c) * pn + src] : 0.f;
      dec[u] = c < sh.nc ? cd[bh * sh.nc + c] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPassAhead; ++u) {
      const int c = c0 + u;
      if (c < sh.nc) {
        uint32_t hi, lo;
        split(h, hi, lo);
        float* const out = hp_img + hp_tile(sh, bh, c);
        out[dst] = __uint_as_float(hi);
        out[kHpTile + dst] = __uint_as_float(lo);
        h = h * dec[u] + v[u];
      }
    }
  }
  if (valid) h_final[bh * pn + src] = h;
}

// ---- 3. the scores S = C·Bᵀ of each group ----

// S depends on the group, not the head: computed once per (b, group, chunk,
// tile pair) into the workspace, read by the group's H / G heads from L2.
constexpr int kScoresSmem = 4 * 2 * kRowTile + 1024;

__global__ void __launch_bounds__(kThreads)
scores_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
              float* __restrict__ ws_s, Shape sh) {
  extern __shared__ uint8_t smem_raw[];
  float* const r_hi = reinterpret_cast<float*>(align1024(smem_raw));
  int it, jt;
  tile_pair(blockIdx.x, &it, &jt);
  const int c = blockIdx.y, bg = blockIdx.z;
  const int b = bg / sh.G, g = bg % sh.G;
  score_block(cm, it * kT, bm, jt * kT, score_tile(ws_s, sh, bg, c, blockIdx.x, gridDim.x),
              r_hi, r_hi + kRowTile, sh, b, static_cast<long long>(c) * sh.Q, g);
}

// ---- 4. the outputs ----

// Shared memory: h_prev as a K-major tile of 64 rows x N, hi and lo, whose
// space then holds each key tile's transposed xdt [p][j], hi and lo; cum
// (doubles).
constexpr int kXTile = kMaxP * kT;
constexpr int kOutSmem = 4 * (2 * kRowTile + 2 * kMaxQ) + 1024;
static_assert(2 * kXTile <= kRowTile, "the xdt tiles live in h_prev's hi tile");
static_assert(kRowTile == kHpTile, "h_prev's tiles are copied as the state pass wrote them");

// One warpgroup per (64-row query tile, b·h, chunk); the query tiles of one
// (b·h, chunk) run together and share h_prev and the xdt tiles in L2.  Its
// staging latency sets its pace, so three blocks an SM (168 registers a
// thread, a few bytes of spill) beat two (198 registers): 0.85 against
// 0.98 ms at mamba2's shape on an H100.  (One warpgroup per (b·h, chunk)
// holding the four query tiles' accumulators needed more than 255
// registers a thread, and ptxas serialised its wgmmas.)
__global__ void __launch_bounds__(kThreads, 3)
chunk_out_kernel(const float* __restrict__ xdt, const float* __restrict__ la,
                 const float* __restrict__ cm, const float* __restrict__ hp_img,
                 float* __restrict__ ws_s, float* __restrict__ y, Shape sh) {
  extern __shared__ uint8_t smem_raw[];
  float* const r_hi = reinterpret_cast<float*>(align1024(smem_raw));
  float* const r_lo = r_hi + kRowTile;
  float* const x_hi = r_hi;  // after the inter term
  float* const x_lo = r_hi + kXTile;
  double* const cum = reinterpret_cast<double*>(r_lo + kRowTile);
  const int it = blockIdx.x, i0 = it * kT, bh = blockIdx.y, c = blockIdx.z;
  const int b = bh / sh.H, h = bh % sh.H, g = h / (sh.H / sh.G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const long long s0 = static_cast<long long>(c) * sh.Q;
  const float* const x_base = xdt + row_bsh(sh, b, s0, h);
  const int x_ld = sh.H * sh.P;
  {  // h_prev's split tile (the state pass wrote it), 16 bytes a copy
    const float4* src = reinterpret_cast<const float4*>(hp_img + hp_tile(sh, bh, c));
    float4* dst = reinterpret_cast<float4*>(r_hi);  // r_lo follows r_hi
#pragma unroll
    for (int u = 0; u < 2 * kHpTile / 4 / kThreads; ++u)
      cp_async16(dst + u * kThreads + tid, src + u * kThreads + tid);
    cp_async_commit();
  }
  float cf[kNK][4];
  load_c(cf, cm, sh, b, s0, g, i0);
  chunk_cumsum(cum, la, sh, b, h, c);

  // inter: acc = exp(cum_i) · C·h_prevᵀ
  cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();
  float acc[kT / 2];
#pragma unroll
  for (int e = 0; e < kT / 2; ++e) acc[e] = 0.f;
  c_product(acc, cf, r_hi, r_lo);
#pragma unroll
  for (int e = 0; e < kT / 2; ++e) {
    const int i = i0 + 16 * warp + g8 + 8 * ((e >> 1) & 1);
    acc[e] *= i < sh.Q ? expf(static_cast<float>(cum[min(i, sh.Q - 1)])) : 0.f;
  }

  // intra: the key tiles up to the diagonal one, their scores from the
  // workspace; the next key tile's xdt is loaded into registers while this
  // one's products run.
  float xv[kOutX];
  load_xdt(xv, x_base, x_ld, sh, 0);
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kT;
    const float4* sp = score_tile(ws_s, sh, b * sh.G + g, c, it * (it + 1) / 2 + jt,
                                  gridDim.x * (gridDim.x + 1) / 2);
    float sc[kT / 2];
#pragma unroll
    for (int u = 0; u < kT / 8; ++u) {
      const float4 v = sp[u * kThreads + tid];
      sc[4 * u] = v.x;
      sc[4 * u + 1] = v.y;
      sc[4 * u + 2] = v.z;
      sc[4 * u + 3] = v.w;
    }
    __syncthreads();  // every wgmma reading the shared tiles has completed
    store_xdt(xv, x_hi, x_lo);
    __syncthreads();
    if (jt < it) load_xdt(xv, x_base, x_ld, sh, j0 + kT);
#pragma unroll
    for (int jb = 0; jb < kT / 8; ++jb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + 16 * warp + g8 + 8 * (e >> 1);
        const int j = j0 + 8 * jb + 2 * t4 + (e & 1);
        // (indices clamped: cum holds Q values)
        const float dec =
            expf(static_cast<float>(cum[min(i, sh.Q - 1)] - cum[min(j, sh.Q - 1)]));
        sc[4 * jb + e] = (j <= i && i < sh.Q) ? sc[4 * jb + e] * dec : 0.f;
      }
    // acc += (S ∘ decay) · xdt over this tile's keys, pipelined as c_product
    uint32_t hi[2][4], lo[2][4];
#pragma unroll
    for (int kk = 0; kk < kT / 8; ++kk) {
      const int u = kk & 1;
      wgmma_wait<1>();
      fence_regs(hi[u]);
      fence_regs(lo[u]);
      float x[4];
      acc_frag(sc, kk, x);
      split4(x, hi[u], lo[u]);
      wgmma_fence();
      mma3<kMaxP>(acc, hi[u], lo[u], desc(x_hi, kMaxP, kk), desc(x_lo, kMaxP, kk));
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc);
  }

  float* const y_base = y + row_bsh(sh, b, s0, h);
#pragma unroll
  for (int j = 0; j < kMaxP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + 16 * warp + g8 + 8 * (e >> 1), p = 8 * j + 2 * t4 + (e & 1);
      if (i < sh.Q && p < sh.P) y_base[static_cast<long long>(i) * x_ld + p] = acc[4 * j + e];
    }
}

}  // namespace

// B10.  xdt [B, S, H, P], la [B, S, H], bm and cm [B, S, G, N], all float32
// contiguous; y [B, S, H, P] and h_final [B, H, P, N] out; ws
// [B·H, S/Q, P, N], cd [B·H, S/Q], ws_s [B·G, S/Q, T, 64, 64] (the
// T = t(t + 1)/2 tile pairs of t = ceil(Q / 64) row tiles), ws_bt
// [B·G, S/Q, ceil(Q / 32), 2, 128 · 32] and hp_img [B·H, S/Q, 2, 64 · 128]
// are scratch from the caller.  Q divides S.  Launches five kernels on `stream`; returns the
// first error (0 = launched), or cudaErrorInvalidValue for a shape the
// kernels do not take.
extern "C" int ssd_chunk_f32(const float* xdt, const float* la, const float* bm,
                             const float* cm, float* y, float* h_final, float* ws,
                             float* cd, float* ws_s, float* ws_bt, float* hp_img, int B,
                             int S, int H, int G, int P, int N, int Q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 || P > kMaxP ||
      N <= 0 || N > kMaxN || Q <= 0 || Q > kMaxQ || S % Q != 0)
    return cudaErrorInvalidValue;
  const Shape sh{B, S, H, G, P, N, Q, S / Q};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sh.nc > 65535 || B * H > 65535) return cudaErrorInvalidValue;
  const int tq = (Q + kT - 1) / kT;
  const struct {
    const void* fn;
    int bytes;
  } smem[] = {{reinterpret_cast<const void*>(chunk_state_kernel), kStateSmem},
              {reinterpret_cast<const void*>(scores_kernel), kScoresSmem},
              {reinterpret_cast<const void*>(chunk_out_kernel), kOutSmem}};
  for (const auto& k : smem) {
    const cudaError_t err =
        cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k.bytes);
    if (err != cudaSuccess) return err;
  }
  const int stages = (Q + kStateStep - 1) / kStateStep;
  bt_kernel<<<dim3(stages, sh.nc, B * G), kThreads, 0, st>>>(bm, ws_bt, sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  chunk_state_kernel<<<dim3(B * H, sh.nc), kThreads, kStateSmem, st>>>(xdt, la, ws_bt, ws, cd,
                                                                       sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  state_pass_kernel<<<dim3(kHpTile / kPassThreads, B * H), kPassThreads, 0, st>>>(
      ws, cd, hp_img, h_final, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scores_kernel<<<dim3(tq * (tq + 1) / 2, sh.nc, B * G), kThreads, kScoresSmem, st>>>(
      bm, cm, ws_s, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  chunk_out_kernel<<<dim3(tq, B * H, sh.nc), kThreads, kOutSmem, st>>>(xdt, la, cm, hp_img,
                                                                       ws_s, y, sh);
  return cudaGetLastError();
}
