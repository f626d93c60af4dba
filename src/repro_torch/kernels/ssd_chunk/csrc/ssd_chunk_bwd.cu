// Backward of the Mamba-2 SSD chunked scan on Hopper (sm_90a): float32 on
// the CUDA cores, six launches, no atomics.
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
// same).  Layout (the
// model's, read in place, as B10 reads it): xdt and dy [B, S, H, P], la
// [B, S, H], bm and cm [B, S, G, N] indexed per group (head h reads group
// h / (H / G), never repeated per head); dh_final [B, H, P, N] or null.
// P <= 64, N <= 128, Q <= 256, all float32.
//
// What bounds it.  Per (b·h, chunk) the function needs five [P, N]
// products over the chunk (the state contributions, E_c, D·B, Dᵀ·xdt,
// h_prevᵀ·dy: 5·Q·P·N multiply-adds), and per causal (q, k) pair dy·xdt,
// the dxdt and dB and dC terms (2P + 2N) and C·B once per group (N / (H /
// G)).  At mamba2-780m's training microbatch (2 x 2,048, 48 heads of P 64,
// N 128, Q 256) that is 3.6e10 FLOP against 0.16 GB moved: 0.53 ms on the
// FP32 cores (67 TFLOP/s), 0.05 ms for the bytes.  Bound by operations.
//
// Design (a simple first version on the FP32 cores; tensor cores, as B10's
// forward uses them, are later work):
//   1. `chunk_sums_kernel`, per (b·h, chunk) and z = 0 / 1: the chunk's state
//      contribution Σ_k exp(cum_last - cum_k) xdt_k ⊗ B_k (z = 0, with the
//      chunk decay exp(cum_last)) or E_c = Σ_q exp(cum_q) dy_q ⊗ C_q (z = 1),
//      [P, N], 32 steps a stage through shared memory.
//   2. `state_passes_kernel`, one thread per (b·h, p, n): the forward pass
//      over the chunks, replacing each contribution by the state entering
//      its chunk (h_prev), and the reverse pass, replacing each E_c by D_c.
//   3. `chunk_grad_kernel<true>`, one block per (64-key tile, b·h, chunk):
//      for every query tile at or after it, the 64 x 64 tiles s and
//      dy·xdtᵀ (depths N and P), A = s∘L and W = L∘(dy·xdtᵀ) into shared
//      memory, then dxdt += Aᵀ·dy and dB += Wᵀ·C; after the queries the
//      state terms from D and S_k.  dB per head into a workspace.
//      `chunk_grad_kernel<false>`, one block per (64-query tile, b·h,
//      chunk): the same with the roles turned (W·B for dC, the inter terms
//      from h_prev and I_q), and for each key tile the sums over its own
//      rows q >= t of Σ_{k<t} M[q, k] (each row's running prefix over the
//      key tiles, then a masked column sum) into a workspace.  dC per head
//      into a workspace.
//   4. `finish_kernel`, per (b·h, chunk): <D, h_prev> by a fixed-order tree,
//      then dla from the query tiles' crossing sums, I's suffix and S's
//      prefix sums, in order.
//   5. `group_sum_kernel`: dB and dC over the heads of each group, in order.
// Every sum has a fixed order: repeats are bit-identical.

#include <cuda_runtime.h>

#include "ssd_common.cuh"

namespace {

using namespace ssd;

constexpr int kThreads = 256;  // 16 x 16 threads (ty, tx)
constexpr int kT = 64;         // rows of a tile: keys or queries
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxQ = 256;
constexpr int kLdP = kMaxP + 1;  // padded rows in shared memory: no bank conflicts
constexpr int kLdN = kMaxN + 1;
constexpr int kLdT = kT + 1;
constexpr int kStep = 32;        // chunk steps a stage of the chunk sums

// ---- 1. the chunk sums ----

// Grid (b·h, chunk, 2).  Thread (ty, tx) owns p = ty + 16i, n = tx + 16j.
__global__ void __launch_bounds__(kThreads)
chunk_sums_kernel(const float* __restrict__ xdt, const float* __restrict__ dy,
                  const float* __restrict__ la, const float* __restrict__ bm,
                  const float* __restrict__ cm, float* __restrict__ ws_s,
                  float* __restrict__ ws_e, float* __restrict__ cd, Shape sh) {
  __shared__ double cum[kMaxQ];
  __shared__ float xs[kStep][kMaxP];
  __shared__ float ys[kStep][kMaxN];
  const int bh = blockIdx.x, c = blockIdx.y, which = blockIdx.z;
  const int b = bh / sh.H, h = bh % sh.H, g = h / (sh.H / sh.G);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long s0 = static_cast<long long>(c) * sh.Q;
  const float* const xsrc = which ? dy : xdt;
  const float* const ysrc = which ? cm : bm;
  chunk_cumsum(cum, la, sh, b, h, c);
  const double last = cum[sh.Q - 1];
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int t0 = 0; t0 < sh.Q; t0 += kStep) {
    for (int e = tid; e < kStep * kMaxP; e += kThreads) {
      const int t = e / kMaxP, p = e % kMaxP, step = t0 + t;
      float v = 0.f;
      if (step < sh.Q && p < sh.P) {
        const float wgt = expf(static_cast<float>(which ? cum[step] : last - cum[step]));
        v = xsrc[row_bsh(sh, b, s0 + step, h) + p] * wgt;
      }
      xs[t][p] = v;
    }
    for (int e = tid; e < kStep * kMaxN; e += kThreads) {
      const int t = e / kMaxN, n = e % kMaxN, step = t0 + t;
      ys[t][n] = (step < sh.Q && n < sh.N) ? ysrc[row_bsg(sh, b, s0 + step, g) + n] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < kStep; ++t) {
      float xv[4], yv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[t][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) yv[j] = ys[t][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], yv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* const out = (which ? ws_e : ws_s) +
                     (static_cast<long long>(bh) * sh.nc + c) * sh.P * sh.N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = ty + 16 * i, n = tx + 16 * j;
      if (p < sh.P && n < sh.N) out[p * sh.N + n] = acc[i][j];
    }
  if (which == 0 && tid == 0)
    cd[static_cast<long long>(bh) * sh.nc + c] = expf(static_cast<float>(last));
}

// ---- 2. the state passes ----

// One thread per (b·h, p, n): ws_s's contributions become the states
// entering each chunk, ws_e's E_c the gradients D_c of the states leaving.
__global__ void __launch_bounds__(kThreads)
state_passes_kernel(float* __restrict__ ws_s, float* __restrict__ ws_e,
                    const float* __restrict__ cd, const float* __restrict__ dh_final,
                    Shape sh) {
  const int pn = sh.P * sh.N;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= pn) return;
  const long long bh = blockIdx.y;
  const long long base = bh * sh.nc * pn + e;
  float hcur = 0.f;
  for (int c = 0; c < sh.nc; ++c) {
    const float v = ws_s[base + static_cast<long long>(c) * pn];
    ws_s[base + static_cast<long long>(c) * pn] = hcur;
    hcur = hcur * cd[bh * sh.nc + c] + v;
  }
  float d = dh_final != nullptr ? dh_final[bh * pn + e] : 0.f;
  for (int c = sh.nc - 1; c >= 0; --c) {
    const float v = ws_e[base + static_cast<long long>(c) * pn];
    ws_e[base + static_cast<long long>(c) * pn] = d;
    d = d * cd[bh * sh.nc + c] + v;
  }
}

// ---- 3. the intra-chunk gradients ----

// Shared memory of chunk_grad_kernel, in floats: cum (doubles), the own
// tile's X [64][P] and Y [64][N], the other tile's X' and Y' (whose space
// then holds the state matrix Z [P][N]), W and A (for the queries M)
// [64][64].
constexpr int kOffOwnX = 2 * kMaxQ;
constexpr int kOffOwnY = kOffOwnX + kT * kLdP;
constexpr int kOffOthX = kOffOwnY + kT * kLdN;
constexpr int kOffOthY = kOffOthX + kT * kLdP;
constexpr int kOffW = kOffOthY + kT * kLdN;
constexpr int kOffA = kOffW + kT * kLdT;
constexpr int kGradSmem = 4 * (kOffA + kT * kLdT);
static_assert(kMaxP * kLdN <= kT * kLdP + kT * kLdN, "Z fits in the other tile's space");

// Rows [r0, r0 + 64) of a [rows, width] tensor (row r at src + r·ld) into
// dst[64][ld_s], zeros at rows >= Q and columns >= width.
__device__ __forceinline__ void load_rows(float* dst, int ld_s, int cols, const float* src,
                                          long long ld, int r0, int q, int width) {
  for (int e = threadIdx.x; e < kT * cols; e += kThreads) {
    const int r = e / cols, col = e % cols;
    dst[r * ld_s + col] = (r0 + r < q && col < width) ? src[(r0 + r) * ld + col] : 0.f;
  }
}

// kKeys: the own rows are keys k (X = xdt, Y = B), the other rows queries q
// (X' = dy, Y' = C), Z = D, the weight exp(cum_last - cum_k); the block
// writes dxdt, dB per head (dyp) and term = S_k.  !kKeys: the own rows are
// queries (X = dy, Y = C), the other rows keys (X' = xdt, Y' = B), Z =
// h_prev, the weight exp(cum_q); the block writes dC per head (dyp), term
// = I_q, and cross [b·h, chunk, query tile, t] = Σ over its rows q >= t of
// Σ_{k<t} M[q, k] for every t of the key tiles at or before it.
template <bool kKeys>
__global__ void __launch_bounds__(kThreads, 1)
chunk_grad_kernel(const float* __restrict__ xdt, const float* __restrict__ dy,
                  const float* __restrict__ la, const float* __restrict__ bm,
                  const float* __restrict__ cm, const float* __restrict__ zmat,
                  float* __restrict__ dxdt, float* __restrict__ dyp,
                  float* __restrict__ term_out, float* __restrict__ cross, Shape sh) {
  extern __shared__ float smem[];
  double* const cum = reinterpret_cast<double*>(smem);
  float* const own_x = smem + kOffOwnX;
  float* const own_y = smem + kOffOwnY;
  float* const oth_x = smem + kOffOthX;
  float* const oth_y = smem + kOffOthY;
  float* const zs = oth_x;  // after the other tiles
  float* const wm = smem + kOffW;
  float* const am = smem + kOffA;
  const int rt = blockIdx.x, bh = blockIdx.y, c = blockIdx.z;
  const int b = bh / sh.H, h = bh % sh.H, g = h / (sh.H / sh.G);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long s0 = static_cast<long long>(c) * sh.Q;
  const int r0 = rt * kT;
  const int tiles = (sh.Q + kT - 1) / kT;
  const long long ld_x = static_cast<long long>(sh.H) * sh.P;
  const long long ld_y = static_cast<long long>(sh.G) * sh.N;
  const float* const x_own = (kKeys ? xdt : dy) + row_bsh(sh, b, s0, h);
  const float* const x_oth = (kKeys ? dy : xdt) + row_bsh(sh, b, s0, h);
  const float* const y_own = (kKeys ? bm : cm) + row_bsg(sh, b, s0, g);
  const float* const y_oth = (kKeys ? cm : bm) + row_bsg(sh, b, s0, g);

  chunk_cumsum(cum, la, sh, b, h, c);
  load_rows(own_x, kLdP, kMaxP, x_own, ld_x, r0, sh.Q, sh.P);
  load_rows(own_y, kLdN, kMaxN, y_own, ld_y, r0, sh.Q, sh.N);

  float dyv[4][8], dxv[4][4];
  float prow = 0.f;  // queries: Σ_{k < o0} M[q, k] of row q = r0 + tid (tid < 64)
  float* const cross_out =
      cross + ((static_cast<long long>(bh) * sh.nc + c) * tiles + rt) * sh.Q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) dyv[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) dxv[i][j] = 0.f;
  }

  const int ot_first = kKeys ? rt : 0, ot_last = kKeys ? tiles - 1 : rt;
  for (int ot = ot_first; ot <= ot_last; ++ot) {
    const int o0 = ot * kT;
    load_rows(oth_x, kLdP, kMaxP, x_oth, ld_x, o0, sh.Q, sh.P);
    load_rows(oth_y, kLdN, kMaxN, y_oth, ld_y, o0, sh.Q, sh.N);
    __syncthreads();
    // s = Y·Y'ᵀ (depth N) and dd = X·X'ᵀ (depth P), rows ty + 16i, columns tx + 16j
    float sc[4][4], dd[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dd[i][j] = 0.f;
#pragma unroll 4
    for (int n = 0; n < sh.N; ++n) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = own_y[(ty + 16 * i) * kLdN + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = oth_y[(tx + 16 * j) * kLdN + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], bv[j], sc[i][j]);
    }
#pragma unroll 4
    for (int p = 0; p < sh.P; ++p) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = own_x[(ty + 16 * i) * kLdP + p];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = oth_x[(tx + 16 * j) * kLdP + p];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dd[i][j] = fmaf(a[i], bv[j], dd[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, o = tx + 16 * j;
        const int q = kKeys ? o0 + o : r0 + r, k = kKeys ? r0 + r : o0 + o;
        const float l =
            (k <= q && q < sh.Q) ? expf(static_cast<float>(cum[q] - cum[k])) : 0.f;
        const float a = sc[i][j] * l;
        wm[r * kLdT + o] = l * dd[i][j];
        am[r * kLdT + o] = kKeys ? a : a * dd[i][j];  // queries: M
      }
    __syncthreads();
    // dY += W·Y' (rows r, columns n = tx + 16j); keys: dX += A·X' (p = tx + 16j)
#pragma unroll 4
    for (int o = 0; o < kT; ++o) {
      float wv[4], yv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) wv[i] = wm[(ty + 16 * i) * kLdT + o];
#pragma unroll
      for (int j = 0; j < 8; ++j) yv[j] = oth_y[o * kLdN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) dyv[i][j] = fmaf(wv[i], yv[j], dyv[i][j]);
      if (kKeys) {
        float av[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = am[(ty + 16 * i) * kLdT + o];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = oth_x[o * kLdP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dxv[i][j] = fmaf(av[i], xv[j], dxv[i][j]);
      }
    }
    if (!kKeys) {
      // M's rows as exclusive running prefixes over k (from the earlier key
      // tiles' sums), then for each t of this key tile the sum over the own
      // rows q >= t
      if (tid < kT) {
        float* const row = am + tid * kLdT;
        for (int o = 0; o < kT; ++o) {
          const float m = row[o];
          row[o] = prow;
          prow += m;
        }
      }
      __syncthreads();
      if (tid < kT && o0 + tid < sh.Q) {
        const int t = o0 + tid;
        float sum = 0.f;
        for (int r = max(t - r0, 0); r < kT && r0 + r < sh.Q; ++r) sum += am[r * kLdT + tid];
        cross_out[t] = sum;
      }
    }
    __syncthreads();  // before the next tile overwrites X', Y', W and A
  }

  // The state terms: Z [P][N] (D_c for keys, h_prev for queries).
  const float* const zsrc = zmat + (static_cast<long long>(bh) * sh.nc + c) * sh.P * sh.N;
  for (int e = tid; e < kMaxP * kMaxN; e += kThreads) {
    const int p = e / kMaxN, n = e % kMaxN;
    zs[p * kLdN + n] = (p < sh.P && n < sh.N) ? zsrc[p * sh.N + n] : 0.f;
  }
  __syncthreads();
  const double last = cum[sh.Q - 1];
  float wgt[4], tpart[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = min(r0 + ty + 16 * i, sh.Q - 1);
    wgt[i] = expf(static_cast<float>(kKeys ? last - cum[row] : cum[row]));
    tpart[i] = 0.f;
  }
  {  // ZX[r][n] = Σ_p Z[p][n] X[r][p]: dY += wgt·ZX, tpart += Σ_n Y[r][n]·ZX[r][n]
    float zx[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) zx[i][j] = 0.f;
#pragma unroll 4
    for (int p = 0; p < sh.P; ++p) {
      float xv[4], zv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = own_x[(ty + 16 * i) * kLdP + p];
#pragma unroll
      for (int j = 0; j < 8; ++j) zv[j] = zs[p * kLdN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) zx[i][j] = fmaf(xv[i], zv[j], zx[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dyv[i][j] = fmaf(wgt[i], zx[i][j], dyv[i][j]);
        tpart[i] = fmaf(own_y[(ty + 16 * i) * kLdN + tx + 16 * j], zx[i][j], tpart[i]);
      }
  }
  if (kKeys) {  // ZY[r][p] = Σ_n Z[p][n] Y[r][n]: dX += wgt·ZY
    float zy[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) zy[i][j] = 0.f;
#pragma unroll 4
    for (int n = 0; n < sh.N; ++n) {
      float yv[4], zv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) yv[i] = own_y[(ty + 16 * i) * kLdN + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) zv[j] = zs[(tx + 16 * j) * kLdN + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) zy[i][j] = fmaf(yv[i], zv[j], zy[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dxv[i][j] = fmaf(wgt[i], zy[i][j], dxv[i][j]);
  }

  // The row sums over the 16 threads of a row (a half-warp), in a fixed tree.
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 8; off > 0; off /= 2)
      tpart[i] += __shfl_xor_sync(0xffffffffu, tpart[i], off);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= sh.Q) continue;
    const long long s = s0 + row;
    if (tx == 0) term_out[at_bsh(sh, b, s, h)] = wgt[i] * tpart[i];
    float* const dst = dyp + at_bsh(sh, b, s, h) * sh.N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = tx + 16 * j;
      if (n < sh.N) dst[n] = dyv[i][j];
    }
    if (kKeys) {
      float* const dxr = dxdt + row_bsh(sh, b, s, h);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx + 16 * j;
        if (p < sh.P) dxr[p] = dxv[i][j];
      }
    }
  }
}

// ---- 4. dla ----

// Per (b·h, chunk): <D, h_prev> by a fixed tree over the block; each step's
// crossing sum over the query tiles at or after its own, in order; then, in
// one thread, I's suffix and S's exclusive prefix sums and dla.
__global__ void __launch_bounds__(kThreads)
finish_kernel(const float* __restrict__ ws_s, const float* __restrict__ ws_e,
              const float* __restrict__ cd, const float* __restrict__ cross,
              const float* __restrict__ qpart, const float* __restrict__ spart,
              float* __restrict__ dla, Shape sh) {
  __shared__ float red[kThreads];
  __shared__ float xs[kMaxQ];
  __shared__ float iq[kMaxQ];
  __shared__ float sk[kMaxQ];
  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / sh.H, h = bh % sh.H;
  const int tid = threadIdx.x;
  const int pn = sh.P * sh.N;
  const int tiles = (sh.Q + kT - 1) / kT;
  const long long base = (static_cast<long long>(bh) * sh.nc + c) * pn;
  float acc = 0.f;
  for (int e = tid; e < pn; e += kThreads) acc = fmaf(ws_e[base + e], ws_s[base + e], acc);
  red[tid] = acc;
  const long long s0 = static_cast<long long>(c) * sh.Q;
  const float* const cross_c = cross + (static_cast<long long>(bh) * sh.nc + c) * tiles * sh.Q;
  for (int t = tid; t < sh.Q; t += kThreads) {
    float sum = 0.f;
    for (int rt = t / kT; rt < tiles; ++rt) sum += cross_c[rt * sh.Q + t];
    xs[t] = sum;
    const long long at = at_bsh(sh, b, s0 + t, h);
    iq[t] = qpart[at];
    sk[t] = spart[at];
  }
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half /= 2) {
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

// ---- 5. dB and dC over the heads of a group ----

// Grid (ceil(B·S·G·N / 256), 2): z = 0 dB from dbp, z = 1 dC from dcp.
__global__ void __launch_bounds__(kThreads)
group_sum_kernel(const float* __restrict__ dbp, const float* __restrict__ dcp,
                 float* __restrict__ db, float* __restrict__ dc, Shape sh) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
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
// ceil(Q / 64), Q], qpart and spart [B, S, H], dbp and dcp [B, S, H, N] are
// float32 scratch from the caller.
// Q divides S.  Launches six kernels on `stream`; returns the first error
// (0 = launched), or cudaErrorInvalidValue for a shape the kernels do not
// take.
extern "C" int ssd_chunk_bwd_f32(const float* xdt, const float* la, const float* bm,
                                 const float* cm, const float* dy, const float* dh_final,
                                 float* dxdt, float* dla, float* db, float* dc, float* ws_s,
                                 float* ws_e, float* cd, float* cross, float* qpart,
                                 float* spart, float* dbp, float* dcp, int B, int S, int H,
                                 int G, int P, int N, int Q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 || P > kMaxP ||
      N <= 0 || N > kMaxN || Q <= 0 || Q > kMaxQ || S % Q != 0)
    return cudaErrorInvalidValue;
  const Shape sh{B, S, H, G, P, N, Q, S / Q};
  if (sh.nc > 65535 || B * H > 65535) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* const grad_kernels[] = {reinterpret_cast<const void*>(chunk_grad_kernel<true>),
                                      reinterpret_cast<const void*>(chunk_grad_kernel<false>)};
  for (const void* fn : grad_kernels) {
    const cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kGradSmem);
    if (err != cudaSuccess) return err;
  }
  const int tiles = (Q + kT - 1) / kT;
  chunk_sums_kernel<<<dim3(B * H, sh.nc, 2), kThreads, 0, st>>>(xdt, dy, la, bm, cm, ws_s,
                                                                ws_e, cd, sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  state_passes_kernel<<<dim3((P * N + kThreads - 1) / kThreads, B * H), kThreads, 0, st>>>(
      ws_s, ws_e, cd, dh_final, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  chunk_grad_kernel<true><<<dim3(tiles, B * H, sh.nc), kThreads, kGradSmem, st>>>(
      xdt, dy, la, bm, cm, ws_e, dxdt, dbp, spart, cross, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  chunk_grad_kernel<false><<<dim3(tiles, B * H, sh.nc), kThreads, kGradSmem, st>>>(
      xdt, dy, la, bm, cm, ws_s, dxdt, dcp, qpart, cross, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finish_kernel<<<dim3(B * H, sh.nc), kThreads, 0, st>>>(ws_s, ws_e, cd, cross, qpart, spart,
                                                         dla, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(B) * S * G * N;
  group_sum_kernel<<<dim3(static_cast<unsigned>((total + kThreads - 1) / kThreads), 2), kThreads,
                     0, st>>>(dbp, dcp, db, dc, sh);
  return cudaGetLastError();
}
