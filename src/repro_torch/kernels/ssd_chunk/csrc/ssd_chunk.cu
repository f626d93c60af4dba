// Mamba-2 SSD chunked scan on Hopper (sm_90a), plain FP32 CUDA cores.
//
// Replaces the Pallas TPU kernel `ssd_chunk_kernel` (body `_kernel`) of
// src/repro/kernels/ssd_chunk/kernel.py (B10).  Per batch b and head h, over
// chunks of Q steps (cum = the within-chunk cumulative sum of la):
//
//     intra:  y_i  = Σ_{j<=i} (c_i · b_j) · exp(cum_i - cum_j) · xdt_j
//     inter:  y_i += exp(cum_i) · (h_prev · c_i)
//     state:  h    = exp(cum_last) · h_prev + Σ_j exp(cum_last - cum_j) · xdt_j ⊗ b_j
//
// from h = 0, all float32.  Layout (the model's, read in place): xdt
// [B, S, H, P], la [B, S, H], bm and cm [B, S, G, N]; head h reads group
// h / (H / G), so B and C are never repeated per head (at mamba2-780m's
// shape a per-head copy would be 805 MB against 17 MB).  y [B, S, H, P],
// h_final [B, H, P, N].  P <= 64, N <= 128, Q <= 256.
//
// Design.  The Pallas grid carries the [P, N] state in VMEM along a
// sequential chunk axis.  Hopper's blocks run in no order, so the scan is
// split as the model's `mamba2.ssd_chunked` splits it, into three launches:
//
//   1. `chunk_state_kernel`, one block per (chunk, b·h): the chunk's own
//      state contribution Σ_j exp(cum_last - cum_j) xdt_j ⊗ b_j [P, N] into a
//      workspace [B·H, chunks, P, N], and its decay exp(cum_last).
//   2. `state_pass_kernel`, one thread per (b·h, p, n): the short sequential
//      pass over the chunks, h_prev(c) = h; h = h · decay(c) + contribution(c),
//      writing each chunk's h_prev over its contribution and h_final.
//   3. `chunk_out_kernel`, one block per (64-row tile, chunk, b·h): the inter
//      term from h_prev, then the intra term over the key tiles up to the
//      diagonal, y written once.
//
// This split, rather than one block per (b, h) looping over its chunks, is
// chosen because at mamba2's shape there are only 192 (b, h) pairs for 132
// SMs, each with 16 chunks of work: one block per pair would leave the card
// in 1.5 uneven waves, while the split gives 3,072 and 12,288 blocks.  It
// costs one write and one read of the workspace (100 MB at that shape).
//
// Every product is a 64-row tile computed by 256 threads as 4 x 4 (or 4 x 8)
// register tiles from shared memory.  The [Q, Q] score tile at Q = 256 would
// need 256 KB of shared memory: it is computed 64 x 64 at a time.  The
// within-chunk cumsum is a warp scan (8 consecutive steps per lane).
//
// What bounds it.  FP32 operations: per (b·h, chunk) about Q²/2·(N + P) for
// the intra term and 2·Q·N·P for the inter term and the state, ~1e11 FLOPs
// for one mamba2 layer at B = 4, S = 4,096, against ~0.2 GB moved.  This
// first version uses FP32 FMAs only (no tensor cores) and computes whole
// 64 x 64 tiles on the diagonal; 3xTF32 mma and a fused single pass are later
// work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;      // rows per tile
constexpr int kTJ = 32;     // steps per tile of the chunk-state product
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxQ = 256;

struct Shape {
  int B, S, H, G, P, N, Q, nc;
};

// la of steps [c·Q, c·Q + Q) of (b, h) into cum[0, Q), then the inclusive
// prefix sum in place: warp 0, 8 consecutive steps per lane.
__device__ void chunk_cumsum(float* cum, const float* __restrict__ la, const Shape& sh,
                             int b, int h, int c) {
  for (int t = threadIdx.x; t < sh.Q; t += blockDim.x) {
    const long long s = static_cast<long long>(c) * sh.Q + t;
    cum[t] = la[(static_cast<long long>(b) * sh.S + s) * sh.H + h];
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float v[8];
    float run = 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int t = lane * 8 + u;
      run += t < sh.Q ? cum[t] : 0.f;
      v[u] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const float up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    const float excl = incl - run;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int t = lane * 8 + u;
      if (t < sh.Q) cum[t] = v[u] + excl;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
chunk_state_kernel(const float* __restrict__ xdt, const float* __restrict__ la,
                   const float* __restrict__ bm, float* __restrict__ ws,
                   float* __restrict__ cd, Shape sh) {
  __shared__ float cum[kMaxQ];
  __shared__ float Xs[kTJ * kMaxP];  // [j][p], scaled by exp(cum_last - cum_j)
  __shared__ float Bs[kTJ * kMaxN];  // [j][n]
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / sh.H, h = bh % sh.H, g = h / (sh.H / sh.G);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  chunk_cumsum(cum, la, sh, b, h, c);
  const float last = cum[sh.Q - 1];

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int j0 = 0; j0 < sh.Q; j0 += kTJ) {
    for (int e = tid; e < kTJ * kMaxP; e += kThreads) {
      const int j = e / kMaxP, p = e % kMaxP, t = j0 + j;
      float val = 0.f;
      if (t < sh.Q && p < sh.P) {
        const long long s = static_cast<long long>(c) * sh.Q + t;
        val = xdt[((static_cast<long long>(b) * sh.S + s) * sh.H + h) * sh.P + p] *
              expf(last - cum[t]);
      }
      Xs[e] = val;
    }
    for (int e = tid; e < kTJ * kMaxN; e += kThreads) {
      const int j = e / kMaxN, n = e % kMaxN, t = j0 + j;
      float val = 0.f;
      if (t < sh.Q && n < sh.N) {
        const long long s = static_cast<long long>(c) * sh.Q + t;
        val = bm[((static_cast<long long>(b) * sh.S + s) * sh.G + g) * sh.N + n];
      }
      Bs[e] = val;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTJ; ++j) {
      float a[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Xs[j * kMaxP + ty + 16 * i];
#pragma unroll
      for (int q = 0; q < 8; ++q) bv[q] = Bs[j * kMaxN + tx + 16 * q];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[i][q] = fmaf(a[i], bv[q], acc[i][q]);
    }
    __syncthreads();
  }

  float* out = ws + (static_cast<long long>(bh) * sh.nc + c) * sh.P * sh.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = ty + 16 * i;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int n = tx + 16 * q;
      if (p < sh.P && n < sh.N) out[p * sh.N + n] = acc[i][q];
    }
  }
  if (tid == 0) cd[static_cast<long long>(bh) * sh.nc + c] = expf(last);
}

__global__ void __launch_bounds__(kThreads)
state_pass_kernel(float* __restrict__ ws, const float* __restrict__ cd,
                  float* __restrict__ h_final, Shape sh) {
  const int pn = sh.P * sh.N;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const long long bh = blockIdx.y;
  if (e >= pn) return;
  float h = 0.f;
  for (int c = 0; c < sh.nc; ++c) {
    const long long idx = (bh * sh.nc + c) * pn + e;
    const float contrib = ws[idx];
    ws[idx] = h;
    h = h * cd[bh * sh.nc + c] + contrib;
  }
  h_final[bh * pn + e] = h;
}

constexpr int kLd = kMaxN + 1;  // padded rows of C, B and h_prev tiles

__global__ void __launch_bounds__(kThreads)
chunk_out_kernel(const float* __restrict__ xdt, const float* __restrict__ la,
                 const float* __restrict__ bm, const float* __restrict__ cm,
                 const float* __restrict__ ws, float* __restrict__ y, Shape sh) {
  extern __shared__ float smem[];
  float* cum = smem;                  // [kMaxQ]
  float* Cs = cum + kMaxQ;            // [kT][kLd]   rows i of C
  float* Ts = Cs + kT * kLd;          // [kT][kLd]   h_prev [p][n], then B rows [j][n]
  float* Xs = Ts + kT * kLd;          // [kT][kMaxP] xdt rows [j][p]
  float* Ps = Xs + kT * kMaxP;        // [kT][kT + 1] masked, decayed scores
  const int i0 = blockIdx.x * kT, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / sh.H, h = bh % sh.H, g = h / (sh.H / sh.G);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long s0 = static_cast<long long>(c) * sh.Q;
  chunk_cumsum(cum, la, sh, b, h, c);

  const float* hp = ws + (static_cast<long long>(bh) * sh.nc + c) * sh.P * sh.N;
  for (int e = tid; e < kT * kMaxN; e += kThreads) {
    const int r = e / kMaxN, n = e % kMaxN, t = i0 + r;
    float cv = 0.f, hv = 0.f;
    if (n < sh.N) {
      if (t < sh.Q) cv = cm[((static_cast<long long>(b) * sh.S + s0 + t) * sh.G + g) * sh.N + n];
      if (r < sh.P) hv = hp[r * sh.N + n];
    }
    Cs[r * kLd + n] = cv;
    Ts[r * kLd + n] = hv;
  }
  __syncthreads();

  // inter: acc[i][p] = exp(cum_i) · Σ_n C[i][n] · h_prev[p][n]
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
#pragma unroll 4
  for (int n = 0; n < kMaxN; ++n) {
    float a[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = Cs[(ty + 16 * i) * kLd + n];
#pragma unroll
    for (int q = 0; q < 4; ++q) bv[q] = Ts[(tx + 16 * q) * kLd + n];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(a[i], bv[q], acc[i][q]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = i0 + ty + 16 * i;
    const float dec = t < sh.Q ? expf(cum[t]) : 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] *= dec;
  }

  // intra: key tiles up to the diagonal one
  for (int j0 = 0; j0 <= i0; j0 += kT) {
    __syncthreads();  // Ts, Xs and Ps of the previous step are read
    for (int e = tid; e < kT * kMaxN; e += kThreads) {
      const int r = e / kMaxN, n = e % kMaxN, t = j0 + r;
      Ts[r * kLd + n] = (t < sh.Q && n < sh.N)
          ? bm[((static_cast<long long>(b) * sh.S + s0 + t) * sh.G + g) * sh.N + n] : 0.f;
    }
    for (int e = tid; e < kT * kMaxP; e += kThreads) {
      const int r = e / kMaxP, p = e % kMaxP, t = j0 + r;
      Xs[e] = (t < sh.Q && p < sh.P)
          ? xdt[((static_cast<long long>(b) * sh.S + s0 + t) * sh.H + h) * sh.P + p] : 0.f;
    }
    __syncthreads();
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) sc[i][q] = 0.f;
#pragma unroll 4
    for (int n = 0; n < kMaxN; ++n) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Cs[(ty + 16 * i) * kLd + n];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = Ts[(tx + 16 * q) * kLd + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) sc[i][q] = fmaf(a[i], bv[q], sc[i][q]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ti = i0 + ty + 16 * i;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int tj = j0 + tx + 16 * q;
        const bool ok = tj <= ti && ti < sh.Q;
        Ps[(ty + 16 * i) * (kT + 1) + tx + 16 * q] =
            ok ? sc[i][q] * expf(cum[ti] - cum[tj]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kT; ++j) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Ps[(ty + 16 * i) * (kT + 1) + j];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = Xs[j * kMaxP + tx + 16 * q];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(a[i], bv[q], acc[i][q]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = i0 + ty + 16 * i;
    if (t >= sh.Q) continue;
    float* yr = y + ((static_cast<long long>(b) * sh.S + s0 + t) * sh.H + h) * sh.P;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = tx + 16 * q;
      if (p < sh.P) yr[p] = acc[i][q];
    }
  }
}

constexpr int kOutSmemBytes = 4 * (kMaxQ + 2 * kT * kLd + kT * kMaxP + kT * (kT + 1));

}  // namespace

// B10.  xdt [B, S, H, P], la [B, S, H], bm and cm [B, S, G, N], all float32
// contiguous; y [B, S, H, P] and h_final [B, H, P, N] out; ws
// [B·H, S/Q, P, N] and cd [B·H, S/Q] are scratch from the caller.  Q divides
// S.  Launches three kernels on `stream`; returns the first error
// (0 = launched), or cudaErrorInvalidValue for a shape the kernels do not
// take.
extern "C" int ssd_chunk_f32(const float* xdt, const float* la, const float* bm,
                             const float* cm, float* y, float* h_final, float* ws,
                             float* cd, int B, int S, int H, int G, int P, int N, int Q,
                             void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 || P > kMaxP ||
      N <= 0 || N > kMaxN || Q <= 0 || Q > kMaxQ || S % Q != 0)
    return cudaErrorInvalidValue;
  const Shape sh{B, S, H, G, P, N, Q, S / Q};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sh.nc > 65535 || B * H > 65535) return cudaErrorInvalidValue;
  chunk_state_kernel<<<dim3(sh.nc, B * H), kThreads, 0, st>>>(xdt, la, bm, ws, cd, sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  state_pass_kernel<<<dim3((P * N + kThreads - 1) / kThreads, B * H), kThreads, 0, st>>>(
      ws, cd, h_final, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(chunk_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kOutSmemBytes);
  if (err != cudaSuccess) return err;
  chunk_out_kernel<<<dim3((Q + kT - 1) / kT, sh.nc, B * H), kThreads, kOutSmemBytes, st>>>(
      xdt, la, bm, cm, ws, y, sh);
  return cudaGetLastError();
}
