// Causal, optionally windowed, flash attention backward on Hopper (sm_90a):
// the entry point of B8 and its float32 kernels on the FP32 CUDA cores.
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
// only there; float32 to the kernels in this file, where every product and
// sum is float32 on the FP32 CUDA cores.  Nothing falls back: a launch that
// is refused, or a stride TMA cannot take, returns an error.  dq, dk and dv
// are written once, in q's type.
//
// Design.  Two kernels, as the Pallas pair: the TPU carries dq (and dk, dv)
// in VMEM along a sequential grid axis, and Hopper's blocks run in no order,
// so each block owns its output tile and loops over the other axis itself.
//
// * dq: one block per (b, h, tile of BQ query rows), the thread layout of
//   B7 (lane group cg = tid % 8, row group rg = tid / 8; a thread owns rows
//   rg + 16·i and key columns cg + 8·j of each 32-key tile).  It walks only
//   the key tiles in its causal/window band, recomputes p from lse, forms
//   ds in shared memory and accumulates ds·K in registers.
// * dk, dv: one block per (b, KV head, tile of BK key rows).  It walks the
//   G = H / Hkv query heads of its group, and for each their 32-row query
//   tiles in the band, in a fixed order, accumulating pᵀ·dO and dsᵀ·Q in
//   registers.  The group sum is therefore a sequential float32 sum in one
//   thread: no float atomics, and a repeat is bit-identical.
//
// Head sizes.  q and k (and dq, dk) are D wide, v and dO (and dv) DV wide:
// DV = D but for MLA's training, (D, DV) = (192, 128).  Q·Kᵀ runs over D
// and dO·Vᵀ over DV, both in one loop along the first DV columns.
//
// Tiles are staged in shared memory as float32 with rows padded to D + 1
// (DV + 1) floats (a warp's lanes read distinct banks both along and across rows);
// at D = 256 a block uses more than 48 KB, so each kernel's dynamic shared
// memory limit is raised before its launch.  Rows and keys past S (a ragged
// S, which the Pallas kernels refuse) load as zeros and are masked.
//
// What bounds it.  About 3.5× B7's products for the same band (dq recomputes
// Q·Kᵀ and dO·Vᵀ and adds ds·K; dk, dv recompute both and add pᵀ·dO and
// dsᵀ·Q), on the FP32 CUDA cores (the tensor cores have no full-float32
// path), its inner loops bounded by shared-memory loads; float32 serves the
// gradient agreement checks, not the bf16 train step.

#include "flash_bwd_sm90.cuh"
#include "flash_common.cuh"

namespace {

using flash::attends;

constexpr int kThreads = 128;
constexpr int kBT = 32;                 // inner tile: keys (dq) or queries (dk, dv)
constexpr int kCG = 8;                  // lanes sharing an output row
constexpr int kRG = kThreads / kCG;     // row groups
constexpr int kCols = kBT / kCG;        // inner-tile columns per thread

template <int D, int DV>
struct DqTile {
  static constexpr int kRows = D > 128 ? 2 : 4;  // query rows per thread
  static constexpr int kBQ = kRG * kRows;        // query rows per block
  static constexpr int kDCols = D / kCG;         // output columns per thread
  static constexpr int kLd = D + 1;              // Q and K rows
  static constexpr int kLdV = DV + 1;            // dO and V rows
  static constexpr int kLdS = kBT + 1;
  static constexpr int kSmemBytes =
      4 * (kBQ * (kLd + kLdV) + kBT * (kLd + kLdV) + kBQ * kLdS + 2 * kBQ);
};

template <int D, int DV>
struct DkvTile {
  static constexpr int kRows = D > 128 ? 1 : (D > 64 ? 2 : 4);  // key rows per thread
  static constexpr int kBK = kRG * kRows;                       // key rows per block
  static constexpr int kDCols = D / kCG;                        // dk columns per thread
  static constexpr int kDColsV = DV / kCG;                      // dv columns per thread
  static constexpr int kLd = D + 1;                             // K and Q rows
  static constexpr int kLdV = DV + 1;                           // V and dO rows
  static constexpr int kLdS = kBT + 1;
  static constexpr int kSmemBytes =
      4 * (kBK * (kLd + kLdV) + kBT * (kLd + kLdV) + 2 * kBK * kLdS + 2 * kBT);
};

struct Args {
  int Sq, Sk, off, H, Hkv, causal, window;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  float scale;
};

template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ dvec,
                    float* __restrict__ dq, Args a) {
  using L = DqTile<D, DV>;
  constexpr int R = L::kRows;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + L::kBQ * L::kLd;
  float* Ks = dOs + L::kBQ * L::kLdV;
  float* Vs = Ks + kBT * L::kLd;
  float* dSs = Vs + kBT * L::kLdV;
  float* lse_s = dSs + L::kBQ * L::kLdS;
  float* dvec_s = lse_s + L::kBQ;

  const int Sq = a.Sq, Sk = a.Sk, H = a.H;
  const int tid = threadIdx.x, cg = tid % kCG, rg = tid / kCG;
  const int q0 = blockIdx.x * L::kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / a.Hkv);
  const float* qb = q + b * a.qsb + h * a.qsh;
  const float* kb = k + b * a.ksb + hk * a.ksh;
  const float* vb = v + b * a.vsb + hk * a.vsh;
  const long long hd = static_cast<long long>(H) * D;    // dq's sequence stride
  const long long hdv = static_cast<long long>(H) * DV;  // dO's sequence stride
  const float* ob = dO + static_cast<long long>(b) * Sq * hdv + static_cast<long long>(h) * DV;
  const long long row0 = (static_cast<long long>(b) * H + h) * Sq;

  for (int e = tid; e < L::kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D, s = q0 + r;
    Qs[r * L::kLd + d] = s < Sq ? qb[s * a.qss + d] : 0.f;
  }
  for (int e = tid; e < L::kBQ * DV; e += kThreads) {
    const int r = e / DV, d = e % DV, s = q0 + r;
    dOs[r * L::kLdV + d] = s < Sq ? ob[s * hdv + d] : 0.f;
  }
  for (int r = tid; r < L::kBQ; r += kThreads) {
    const int s = q0 + r;
    lse_s[r] = s < Sq ? lse[row0 + s] : 0.f;
    dvec_s[r] = s < Sq ? dvec[row0 + s] : 0.f;
  }

  float acc[R][L::kDCols];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < L::kDCols; ++c) acc[i][c] = 0.f;

  const int k_end = a.causal ? min(Sk, a.off + q0 + L::kBQ) : Sk;
  const int k_first = a.window > 0 ? max(0, a.off + q0 - a.window + 1) : 0;
  for (int k0 = (k_first / kBT) * kBT; k0 < k_end; k0 += kBT) {
    __syncthreads();  // Q, dO staged; the previous tile's K, V and dS are read
    for (int e = tid; e < kBT * D; e += kThreads) {
      const int c = e / D, d = e % D, s = k0 + c;
      Ks[c * L::kLd + d] = s < Sk ? kb[s * a.kss + d] : 0.f;
    }
    for (int e = tid; e < kBT * DV; e += kThreads) {
      const int c = e / DV, d = e % DV, s = k0 + c;
      Vs[c * L::kLdV + d] = s < Sk ? vb[s * a.vss + d] : 0.f;
    }
    __syncthreads();

    // s = Q·Kᵀ over D and dp = dO·Vᵀ over DV (DV <= D): both along the
    // first DV columns, then Q·Kᵀ alone.
    float sc[R][kCols], dp[R][kCols];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DV; ++d) {
      float qv[R], ov[R], kv[kCols], vv[kCols];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qv[i] = Qs[(rg + kRG * i) * L::kLd + d];
        ov[i] = dOs[(rg + kRG * i) * L::kLdV + d];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        kv[j] = Ks[(cg + kCG * j) * L::kLd + d];
        vv[j] = Vs[(cg + kCG * j) * L::kLdV + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll 4
    for (int d = DV; d < D; ++d) {
      float qv[R], kv[kCols];
#pragma unroll
      for (int i = 0; i < R; ++i) qv[i] = Qs[(rg + kRG * i) * L::kLd + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(cg + kCG * j) * L::kLd + d];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = rg + kRG * i, qi = a.off + q0 + r;  // the row's position
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + cg + kCG * j;
        const float p = attends(qi, kj, Sk, a.causal, a.window)
                            ? expf(sc[i][j] * a.scale - lse_s[r]) : 0.f;
        dSs[r * L::kLdS + cg + kCG * j] = p * (dp[i][j] - dvec_s[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBT; ++c) {
      float dsv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) dsv[i] = dSs[(rg + kRG * i) * L::kLdS + c];
#pragma unroll
      for (int dc = 0; dc < L::kDCols; ++dc) {
        const float kk = Ks[c * L::kLd + cg + kCG * dc];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][dc] = fmaf(dsv[i], kk, acc[i][dc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int s = q0 + rg + kRG * i;
    if (s < Sq) {
      float* out = dq + static_cast<long long>(b) * Sq * hd + s * hd + static_cast<long long>(h) * D;
#pragma unroll
      for (int dc = 0; dc < L::kDCols; ++dc)
        out[cg + kCG * dc] = a.scale * acc[i][dc];
    }
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dO,
                     const float* __restrict__ lse, const float* __restrict__ dvec,
                     float* __restrict__ dk, float* __restrict__ dv, Args a) {
  using L = DkvTile<D, DV>;
  constexpr int R = L::kRows;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + L::kBK * L::kLd;
  float* Qs = Vs + L::kBK * L::kLdV;
  float* dOs = Qs + kBT * L::kLd;
  float* Ps = dOs + kBT * L::kLdV;
  float* dSs = Ps + L::kBK * L::kLdS;
  float* lse_s = dSs + L::kBK * L::kLdS;
  float* dvec_s = lse_s + kBT;

  const int Sq = a.Sq, Sk = a.Sk, H = a.H, Hkv = a.Hkv, G = H / Hkv;
  const int tid = threadIdx.x, cg = tid % kCG, rg = tid / kCG;
  const int k0 = blockIdx.x * L::kBK;
  const int hk = blockIdx.y, b = blockIdx.z;
  const float* kb = k + b * a.ksb + hk * a.ksh;
  const float* vb = v + b * a.vsb + hk * a.vsh;
  const long long hdv = static_cast<long long>(H) * DV;  // dO's sequence stride

  for (int e = tid; e < L::kBK * D; e += kThreads) {
    const int r = e / D, d = e % D, s = k0 + r;
    Ks[r * L::kLd + d] = s < Sk ? kb[s * a.kss + d] : 0.f;
  }
  for (int e = tid; e < L::kBK * DV; e += kThreads) {
    const int r = e / DV, d = e % DV, s = k0 + r;
    Vs[r * L::kLdV + d] = s < Sk ? vb[s * a.vss + d] : 0.f;
  }

  float dk_acc[R][L::kDCols], dv_acc[R][L::kDColsV];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int c = 0; c < L::kDCols; ++c) dk_acc[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < L::kDColsV; ++c) dv_acc[i][c] = 0.f;
  }

  // Query rows that attend a key of this tile: position off + i >= k0 when
  // causal, and off + i < k0 + BK - 1 + window when a window is given.
  const int q_first = a.causal ? max(0, k0 - a.off) : 0;
  const int q_end = a.window > 0 ? min(Sq, k0 + L::kBK - 1 + a.window - a.off) : Sq;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const float* qb = q + b * a.qsb + h * a.qsh;
    const float* ob = dO + static_cast<long long>(b) * Sq * hdv + static_cast<long long>(h) * DV;
    const long long row0 = (static_cast<long long>(b) * H + h) * Sq;
    for (int q0 = (q_first / kBT) * kBT; q0 < q_end; q0 += kBT) {
      __syncthreads();  // K, V staged; the previous tile's Q, dO, P and dS are read
      for (int e = tid; e < kBT * D; e += kThreads) {
        const int c = e / D, d = e % D, s = q0 + c;
        Qs[c * L::kLd + d] = s < Sq ? qb[s * a.qss + d] : 0.f;
      }
      for (int e = tid; e < kBT * DV; e += kThreads) {
        const int c = e / DV, d = e % DV, s = q0 + c;
        dOs[c * L::kLdV + d] = s < Sq ? ob[s * hdv + d] : 0.f;
      }
      for (int c = tid; c < kBT; c += kThreads) {
        const int s = q0 + c;
        lse_s[c] = s < Sq ? lse[row0 + s] : 0.f;
        dvec_s[c] = s < Sq ? dvec[row0 + s] : 0.f;
      }
      __syncthreads();

      // sᵀ = K·Qᵀ over D and dpᵀ = V·dOᵀ over DV, as in the dq kernel.
      float sc[R][kCols], dp[R][kCols];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DV; ++d) {
        float kv[R], vv[R], qv[kCols], ov[kCols];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          kv[i] = Ks[(rg + kRG * i) * L::kLd + d];
          vv[i] = Vs[(rg + kRG * i) * L::kLdV + d];
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          qv[j] = Qs[(cg + kCG * j) * L::kLd + d];
          ov[j] = dOs[(cg + kCG * j) * L::kLdV + d];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            sc[i][j] = fmaf(kv[i], qv[j], sc[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }
#pragma unroll 4
      for (int d = DV; d < D; ++d) {
        float kv[R], qv[kCols];
#pragma unroll
        for (int i = 0; i < R; ++i) kv[i] = Ks[(rg + kRG * i) * L::kLd + d];
#pragma unroll
        for (int j = 0; j < kCols; ++j) qv[j] = Qs[(cg + kCG * j) * L::kLd + d];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) sc[i][j] = fmaf(kv[i], qv[j], sc[i][j]);
      }

#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = rg + kRG * i, kj = k0 + r;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = cg + kCG * j, qi = q0 + c;
          const float p = qi < Sq && attends(a.off + qi, kj, Sk, a.causal, a.window)
                              ? expf(sc[i][j] * a.scale - lse_s[c]) : 0.f;
          Ps[r * L::kLdS + c] = p;
          dSs[r * L::kLdS + c] = p * (dp[i][j] - dvec_s[c]);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int c = 0; c < kBT; ++c) {
        float pv[R], sv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pv[i] = Ps[(rg + kRG * i) * L::kLdS + c];
          sv[i] = dSs[(rg + kRG * i) * L::kLdS + c];
        }
#pragma unroll
        for (int dc = 0; dc < L::kDColsV; ++dc) {
          const float oo = dOs[c * L::kLdV + cg + kCG * dc];
          const float qq = Qs[c * L::kLd + cg + kCG * dc];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            dv_acc[i][dc] = fmaf(pv[i], oo, dv_acc[i][dc]);
            dk_acc[i][dc] = fmaf(sv[i], qq, dk_acc[i][dc]);
          }
        }
#pragma unroll
        for (int dc = L::kDColsV; dc < L::kDCols; ++dc) {
          const float qq = Qs[c * L::kLd + cg + kCG * dc];
#pragma unroll
          for (int i = 0; i < R; ++i) dk_acc[i][dc] = fmaf(sv[i], qq, dk_acc[i][dc]);
        }
      }
    }
  }

  const long long kd = static_cast<long long>(Hkv) * D, kdv = static_cast<long long>(Hkv) * DV;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int s = k0 + rg + kRG * i;
    if (s < Sk) {
      float* dko = dk + (static_cast<long long>(b) * Sk + s) * kd + static_cast<long long>(hk) * D;
      float* dvo = dv + (static_cast<long long>(b) * Sk + s) * kdv + static_cast<long long>(hk) * DV;
#pragma unroll
      for (int dc = 0; dc < L::kDCols; ++dc) dko[cg + kCG * dc] = a.scale * dk_acc[i][dc];
#pragma unroll
      for (int dc = 0; dc < L::kDColsV; ++dc) dvo[cg + kCG * dc] = dv_acc[i][dc];
    }
  }
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, const void* dO, const float* lse,
           const float* dvec, void* dq, void* dk, void* dv, int B, const Args& a,
           cudaStream_t stream) {
  using Q = DqTile<D, DV>;
  using K = DkvTile<D, DV>;
  auto* dq_fn = flash_bwd_dq_kernel<D, DV>;
  auto* dkv_fn = flash_bwd_dkv_kernel<D, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, Q::kSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkv_fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             K::kSmemBytes);
  if (err != cudaSuccess) return err;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* ot = static_cast<const float*>(dO);
  dq_fn<<<dim3((a.Sq + Q::kBQ - 1) / Q::kBQ, a.H, B), kThreads, Q::kSmemBytes, stream>>>(
      qt, kt, vt, ot, lse, dvec, static_cast<float*>(dq), a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_fn<<<dim3((a.Sk + K::kBK - 1) / K::kBK, a.Hkv, B), kThreads, K::kSmemBytes, stream>>>(
      qt, kt, vt, ot, lse, dvec, static_cast<float*>(dk), static_cast<float*>(dv), a);
  return cudaGetLastError();
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
#define FLASH_BWD_FP32(D, DV) launch<D, DV>(q, k, v, dO, lse, dvec, dq, dk, dv_out, B, a, stream)
  switch (pair(d, dv)) {
    case pair(32, 32): return FLASH_BWD_FP32(32, 32);
    case pair(64, 64): return FLASH_BWD_FP32(64, 64);
    case pair(128, 128): return FLASH_BWD_FP32(128, 128);
    case pair(256, 256): return FLASH_BWD_FP32(256, 256);
    case pair(192, 128): return FLASH_BWD_FP32(192, 128);
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_BWD_FP32
}

}  // namespace

// B8.  dtype 0 = float32 (the FP32 kernels above), 1 = bf16 (the
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
