// Causal, optionally windowed, flash attention forward on Hopper (sm_90a):
// the entry point of B7 and its float32 kernel on the FP32 CUDA cores.
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
// only there; float32 to the kernel in this file.  Nothing falls back: a
// launch that is refused, or a stride TMA cannot take, returns an error.
//
// The float32 kernel.  Every product and sum is float32, on the FP32 CUDA
// cores (the tensor cores have no full-float32 path).  The probabilities
// stay float32 for P·V, as in `flash_attention_ref` and the model's
// `attend_chunked` (the Pallas kernel rounds them to v's type first).  The
// Pallas grid carries (m, l, acc) in VMEM along a sequential key axis;
// Hopper's blocks run in no order, so one block owns a tile of BQ query rows
// of one (b, h) and loops over the key tiles itself, keeping (m, l, acc) in
// registers.  128 threads: lane group cg = tid % 8 and row group
// rg = tid / 8.  A thread owns query rows rg + 16·i (4 rows, BQ = 64, at
// D <= 128; 2 rows, BQ = 32, at D = 192 and 256 to bound registers), key
// columns cg + 8·j of each 32-key tile and output columns cg + 8·j of DV.  The eight
// lanes that share a row are neighbours in one warp, so the row max and row
// sum are three xor-shuffles.  Q (once) and each K/V tile are staged in
// shared memory with rows padded to D + 1 floats, so that the lanes of a
// warp read distinct banks; P goes through shared memory (rows padded to 33)
// between the two products.  Its inner loops are bounded by shared-memory
// loads (8 loads per 16 FMAs in Q·Kᵀ, 20 per 64 in P·V); float32 attention
// serves the depth-cut agreement checks, not the bf16 model paths.
//
// Block skipping.  A block visits only the key tiles that meet its causal /
// window band: from the tile holding max(0, off + q0 - window + 1) up to its
// last query row's position; the tiles wholly outside the band are never
// loaded (a stripe at offset off visits at most off + q0 + BQ keys).  The tiles it skips would contribute exp(-1e30 - m) = 0 to every
// row, so this is the same function with less work.  Masked entries get
// p = 0 explicitly; every row has at least its own key (j = i), so this
// equals the reference wherever the reference is defined.  Rows and keys
// past S (a ragged S, which the Pallas kernel refuses) are masked here.

#include "flash_common.cuh"
#include "flash_fwd_sm90.cuh"

namespace {

using flash::attends;
using flash::kNegInf;

constexpr int kThreads = 128;
constexpr int kBK = 32;                 // keys per tile
constexpr int kCG = 8;                  // lanes sharing a query row
constexpr int kRG = kThreads / kCG;     // row groups
constexpr int kCols = kBK / kCG;        // keys per thread per tile

template <int D, int DV>
struct Tile {
  static constexpr int kRows = D > 128 ? 2 : 4;  // query rows per thread
  static constexpr int kBQ = kRG * kRows;        // query rows per block
  static constexpr int kDCols = DV / kCG;        // output columns per thread
  static constexpr int kLdQ = D + 1;
  static constexpr int kLdK = D + 1;
  static constexpr int kLdV = DV;
  static constexpr int kLdP = kBK + 1;
  static constexpr int kSmemBytes =
      4 * (kBQ * kLdQ + kBK * kLdK + kBK * kLdV + kBQ * kLdP);
};

__device__ __forceinline__ float row_max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int off, int H, int Hkv,
                 long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh,
                 int causal, int window, float scale) {
  using L = Tile<D, DV>;
  constexpr int R = L::kRows;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + L::kBQ * L::kLdQ;
  float* Vs = Ks + kBK * L::kLdK;
  float* Ps = Vs + kBK * L::kLdV;

  const int tid = threadIdx.x, cg = tid % kCG, rg = tid / kCG;
  const int q0 = blockIdx.x * L::kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;

  for (int e = tid; e < L::kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D, s = q0 + r;
    Qs[r * L::kLdQ + d] = s < Sq ? qb[s * qss + d] : 0.f;
  }

  float m[R], l[R], acc[R][L::kDCols];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < L::kDCols; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? min(Sk, off + q0 + L::kBQ) : Sk;
  const int k_first = window > 0 ? max(0, off + q0 - window + 1) : 0;
  for (int k0 = (k_first / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // Q staged; the previous tile's K, V and P are read
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int c = e / D, d = e % D, s = k0 + c;
      Ks[c * L::kLdK + d] = s < Sk ? kb[s * kss + d] : 0.f;
    }
    for (int e = tid; e < kBK * DV; e += kThreads) {
      const int c = e / DV, d = e % DV, s = k0 + c;
      Vs[c * L::kLdV + d] = s < Sk ? vb[s * vss + d] : 0.f;
    }
    __syncthreads();

    float sc[R][kCols];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[R], kv[kCols];
#pragma unroll
      for (int i = 0; i < R; ++i) qv[i] = Qs[(rg + kRG * i) * L::kLdQ + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(cg + kCG * j) * L::kLdK + d];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = off + q0 + rg + kRG * i;  // the row's position
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + cg + kCG * j;
        sc[i][j] = attends(qi, kj, Sk, causal, window) ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max8(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + cg + kCG * j;
        const float p = attends(qi, kj, Sk, causal, window) ? expf(sc[i][j] - m_new) : 0.f;
        Ps[(rg + kRG * i) * L::kLdP + cg + kCG * j] = p;
        rs += p;
      }
      l[i] = l[i] * corr + row_sum8(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < L::kDCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) pv[i] = Ps[(rg + kRG * i) * L::kLdP + c];
#pragma unroll
      for (int dc = 0; dc < L::kDCols; ++dc) {
        const float vv = Vs[c * L::kLdV + cg + kCG * dc];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][dc] = fmaf(pv[i], vv, acc[i][dc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int s = q0 + rg + kRG * i;
    if (s < Sq) {
      const float lf = fmaxf(l[i], 1e-30f);
      float* ob = out + ((static_cast<long long>(b) * Sq + s) * H + h) * DV;
#pragma unroll
      for (int dc = 0; dc < L::kDCols; ++dc) ob[cg + kCG * dc] = acc[i][dc] / lf;
      if (cg == 0) lse[(static_cast<long long>(b) * H + h) * Sq + s] = m[i] + logf(lf);
    }
  }
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B,
           int Sq, int Sk, int off, int H, int Hkv, const long long* st, int causal,
           int window, float scale, cudaStream_t stream) {
  using L = Tile<D, DV>;
  auto* fn = flash_fwd_kernel<D, DV>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + L::kBQ - 1) / L::kBQ, H, B);
  fn<<<grid, kThreads, L::kSmemBytes, stream>>>(
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

// B7 forward.  dtype 0 = float32 (the FP32 kernel above), 1 = bf16 (the
// tensor-core kernel); q, k, v and out share it.  strides: q's batch,
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
