// Band-masked attention backward kernels for Hopper (sm_90a).
//
// Five entry points, one per Pallas backward kernel of
// recommend_tpu/ops/pallas/flash_attention.py:
//
//   band_attn_blocked_bwd_dq   replaces _dq_kernel         (flash_band_attention, B2dq)
//   band_attn_blocked_bwd_dkv  replaces _dkv_kernel        (flash_band_attention, B2dkv)
//   band_attn_bh_bwd           replaces _fused_bwd_kernel  (fused_band_attention, B4b)
//   band_attn_mh_bwd           replaces _fmh_bwd_kernel    (fused_mh_band_attention, B3b)
//   band_attn_segkv_bwd        replaces _fmhseg_bwd_kernel (fused_mhseg_band_attention, B1b)
//
// What they compute, given the forward's inputs, its per-row logsumexp lse,
// the output gradient dO and delta = rowsum(out * dO) in float32: for query
// row r (position q_offset + r) and key j,
//   s    = (q . k) * sm_scale + bias[j] (+ -1e9 if causal and j > q_offset + r)
//   p    = exp(s - lse[r])                       recomputed, never stored
//   dp   = dO[r] . v[j]                          float32
//   dS   = round_k(p * (dp - delta[r]) * sm_scale)
//   dQ   = sum_j dS k[j],   dK[j] = sum_r dS q[r],   dV[j] = sum_r round_do(p) dO[r]
// with float32 accumulation and each output stored in the input dtype;
// round_do and round_k cast to dO's and k's dtype (the inputs share one), the
// rounding points of the Pallas kernels. The segmented form joins a second
// key/value segment (the NS tokens, all valid, no bias) at positions
// L1..L1+L2-1 and writes its gradients into separate tensors, so the joined
// keys are never copied; the model-layout form is the segmented one with
// L2 = 0 and no second segment (its pointers are null and never touched:
// every read and write of segment 2 sits behind key >= L1, and no key
// reaches L1 + L2 = L1). Keys past the end and rows past Lq are excluded.
//
// Design: two passes in the style of FlashAttention-2, with no atomics.
// - dq pass: one block per (batch, head, 64-row query tile); it loops over the
//   64-key tiles up to the band edge of its last row (tiles wholly above the
//   band are skipped, as _run_block does), computes dp from the V tile, then
//   p and dS from the K tile, and accumulates dQ in registers.
// - dkv pass: one block per (batch, head, 64-key tile); it holds K and V in
//   shared memory and loops over the query tiles that can see its keys (the
//   band starts at row key0 - q_offset), staging Q and dO, then P^T for dV and
//   dS^T for dK in shared memory; dK and dV accumulate in registers.
// Both recompute p tile by tile, so [Lq, Lkv] never reaches device memory.
//
// What bounds it on the H100: at the training shapes (Dh 64/128, a few
// hundred keys, hundreds of batch rows) the work is five matrix products,
// 10 * Dh flops per (row, key) pair in the band (the dq and dkv passes
// recompute s and dp, 14 * Dh together), against (3 Lq + 3 Lkv) * Dh
// elements moved. Every bfloat16 call runs the same two passes on the
// tensor cores, fed by TMA (band_attention_bwd_sm90.cuh, whose note gives
// their design), at every head width: band_attn_bh_bwd (B4b),
// band_attn_mh_bwd (B3b) and band_attn_segkv_bwd (B1b) both passes,
// band_attn_blocked_bwd_dq (B2dq) and band_attn_blocked_bwd_dkv (B2dkv) one
// pass each. Every float32 call (a full-float32 tensor-core product does not
// exist, and TF32 would miss the float32 checks) runs the passes below as
// float32 FMAs on the CUDA cores (67 TF/s peak) with 116 KB (dq) and 149 KB
// (dkv) of shared memory at Dh 128, one block per SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "band_attention_common.cuh"
#include "band_attention_bwd_sm90.cuh"

namespace {

using namespace band_attn;

struct BwdArgs {
  const void* q; long long q_bs, q_hs, q_rs;        // element strides; dO, dQ too
  const void* k; const void* v; long long kv_bs, kv_hs, kv_rs;  // dK, dV too
  const float* bias; long long bias_bs, bias_hs;    // [.., L1] additive
  const void* k2; const void* v2; long long kv2_bs, kv2_hs, kv2_rs;  // dK2, dV2 too
  const void* dout;
  const float* lse; const float* delta;             // [B, H, Lq] contiguous
  void* dq; void* dk; void* dv; void* dk2; void* dv2;
  int H, Lq, L1, L2, q_offset, causal;
  float sm_scale;
};

// s for one (row, key) pair from its raw product, in the forward's order:
// scale, + bias, + band
__device__ __forceinline__ float logit(float qk, float sm_scale,
                                       const float* bias, int l1, int causal,
                                       int key, int qpos) {
  float x = qk * sm_scale;
  if (key < l1) x = x + bias[key];
  if (causal && key > qpos) x = x + NEG_INF;
  return x;
}

// ---------------------------------------------------------------------------
// dq pass
// ---------------------------------------------------------------------------

template <int DH>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(2 * BQ * (DH + 1) + BK * (DH + 1) + BQ * (BK + 1));
}

template <int DH>
__global__ void __launch_bounds__(NT) band_attn_bwd_dq_kernel(const BwdArgs a) {
  constexpr int RS = DH + 1;        // padded smem row stride (no bank conflicts)
  constexpr int PS = BK + 1;
  constexpr int DJ = DH / 16;       // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;                 // [BQ][RS]
  float* sdo = sq + BQ * RS;        // [BQ][RS]
  float* skv = sdo + BQ * RS;       // [BK][RS]  V tile, then K tile
  float* sds = skv + BK * RS;       // [BQ][PS]  dS

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tr = tid >> 4;          // rows tr*4 .. tr*4+3 of the tile
  const int tc = tid & 15;          // keys tc + 16 j; columns tc + 16 j
  const int row0 = tile * BQ;
  const int total = a.L1 + a.L2;

  const float* q = static_cast<const float*>(a.q) + b * a.q_bs + h * a.q_hs;
  const float* dout = static_cast<const float*>(a.dout) + b * a.q_bs + h * a.q_hs;
  const float* k1 = static_cast<const float*>(a.k) + b * a.kv_bs + h * a.kv_hs;
  const float* v1 = static_cast<const float*>(a.v) + b * a.kv_bs + h * a.kv_hs;
  const float* k2 = static_cast<const float*>(a.k2) + b * a.kv2_bs + h * a.kv2_hs;
  const float* v2 = static_cast<const float*>(a.v2) + b * a.kv2_bs + h * a.kv2_hs;
  const float* bias = a.bias + b * a.bias_bs + h * a.bias_hs;
  const long long stat = ((long long)b * a.H + h) * a.Lq;

  for (int i = tid; i < BQ * DH; i += NT) {
    const int r = i / DH, d = i % DH, row = row0 + r;
    const bool in = row < a.Lq;
    sq[r * RS + d] = in ? q[row * a.q_rs + d] : 0.f;
    sdo[r * RS + d] = in ? dout[row * a.q_rs + d] : 0.f;
  }
  float lse[4], delta[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + tr * 4 + i;
    lse[i] = row < a.Lq ? a.lse[stat + row] : 0.f;
    delta[i] = row < a.Lq ? a.delta[stat + row] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  int kv_end = total;
  if (a.causal) {
    const int last_row = min(row0 + BQ, a.Lq) - 1;
    kv_end = max(0, min(total, a.q_offset + last_row + 1));
  }

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's dQ product is done with skv, sds
    for (int i = tid; i < BK * DH; i += NT) {
      const int kk = i / DH, d = i % DH, j = k0 + kk;
      float x = 0.f;
      if (j < a.L1) x = v1[j * a.kv_rs + d];
      else if (j < total) x = v2[(j - a.L1) * a.kv2_rs + d];
      skv[kk * RS + d] = x;
    }
    __syncthreads();

    float dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float da[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = sdo[(tr * 4 + i) * RS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) vb[j] = skv[(tc + 16 * j) * RS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
    }
    __syncthreads();  // done with the V tile

    for (int i = tid; i < BK * DH; i += NT) {
      const int kk = i / DH, d = i % DH, j = k0 + kk;
      float x = 0.f;
      if (j < a.L1) x = k1[j * a.kv_rs + d];
      else if (j < total) x = k2[(j - a.L1) * a.kv2_rs + d];
      skv[kk * RS + d] = x;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sq[(tr * 4 + i) * RS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = skv[(tc + 16 * j) * RS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + tr * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tc + 16 * j;
        float ds = 0.f;
        if (key < total && row < a.Lq) {
          const float p = expf(logit(s[i][j], a.sm_scale, bias, a.L1, a.causal, key,
                                    a.q_offset + row) - lse[i]);
          ds = p * (dp[i][j] - delta[i]) * a.sm_scale;
        }
        sds[(tr * 4 + i) * PS + tc + 16 * j] = ds;
      }
    }
    __syncthreads();  // dS is complete

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sds[(tr * 4 + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = skv[kk * RS + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

  float* dq = static_cast<float*>(a.dq) + b * a.q_bs + h * a.q_hs;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + tr * 4 + i;
    if (row >= a.Lq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[row * a.q_rs + tc + 16 * j] = acc[i][j];
  }
}

// ---------------------------------------------------------------------------
// dkv pass
// ---------------------------------------------------------------------------

template <int DH>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) *
         (size_t)(2 * BK * (DH + 1) + 2 * BQ * (DH + 1) + BK * (BQ + 1) + 2 * BQ);
}

template <int DH>
__global__ void __launch_bounds__(NT) band_attn_bwd_dkv_kernel(const BwdArgs a) {
  constexpr int RS = DH + 1;
  constexpr int PS = BQ + 1;
  constexpr int DJ = DH / 16;
  extern __shared__ float smem[];
  float* sk = smem;                 // [BK][RS]
  float* sv = sk + BK * RS;         // [BK][RS]
  float* sq = sv + BK * RS;         // [BQ][RS]
  float* sdo = sq + BQ * RS;        // [BQ][RS]
  float* sp = sdo + BQ * RS;        // [BK][PS]  P^T, then dS^T
  float* slse = sp + BK * PS;       // [BQ]
  float* sdelta = slse + BQ;        // [BQ]

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tr = tid >> 4;          // keys tr*4 .. tr*4+3 of the tile
  const int tc = tid & 15;          // query rows tc + 16 j; columns tc + 16 j
  const int key0 = tile * BK;
  const int total = a.L1 + a.L2;

  const float* q = static_cast<const float*>(a.q) + b * a.q_bs + h * a.q_hs;
  const float* dout = static_cast<const float*>(a.dout) + b * a.q_bs + h * a.q_hs;
  const float* k1 = static_cast<const float*>(a.k) + b * a.kv_bs + h * a.kv_hs;
  const float* v1 = static_cast<const float*>(a.v) + b * a.kv_bs + h * a.kv_hs;
  const float* k2 = static_cast<const float*>(a.k2) + b * a.kv2_bs + h * a.kv2_hs;
  const float* v2 = static_cast<const float*>(a.v2) + b * a.kv2_bs + h * a.kv2_hs;
  const float* bias = a.bias + b * a.bias_bs + h * a.bias_hs;
  const long long stat = ((long long)b * a.H + h) * a.Lq;

  for (int i = tid; i < BK * DH; i += NT) {
    const int kk = i / DH, d = i % DH, j = key0 + kk;
    float xk = 0.f, xv = 0.f;
    if (j < a.L1) {
      xk = k1[j * a.kv_rs + d];
      xv = v1[j * a.kv_rs + d];
    } else if (j < total) {
      xk = k2[(j - a.L1) * a.kv2_rs + d];
      xv = v2[(j - a.L1) * a.kv2_rs + d];
    }
    sk[kk * RS + d] = xk;
    sv[kk * RS + d] = xv;
  }
  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // under the band, row r sees key j once q_offset + r >= j: the query tiles
  // before the one holding row key0 - q_offset see none of this tile's keys
  int q_first = 0;
  if (a.causal) q_first = (max(0, key0 - a.q_offset) / BQ) * BQ;

  for (int q0 = q_first; q0 < a.Lq; q0 += BQ) {
    __syncthreads();  // the previous tile's dK product is done with sq, sp
    for (int i = tid; i < BQ * DH; i += NT) {
      const int r = i / DH, d = i % DH, row = q0 + r;
      const bool in = row < a.Lq;
      sq[r * RS + d] = in ? q[row * a.q_rs + d] : 0.f;
      sdo[r * RS + d] = in ? dout[row * a.q_rs + d] : 0.f;
    }
    for (int r = tid; r < BQ; r += NT) {
      const int row = q0 + r;
      slse[r] = row < a.Lq ? a.lse[stat + row] : 0.f;
      sdelta[r] = row < a.Lq ? a.delta[stat + row] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float ka[4], va[4], qb[4], db[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ka[i] = sk[(tr * 4 + i) * RS + d];
        va[i] = sv[(tr * 4 + i) * RS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qb[j] = sq[(tc + 16 * j) * RS + d];
        db[j] = sdo[(tc + 16 * j) * RS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(ka[i], qb[j], s[i][j]);
          dp[i][j] = fmaf(va[i], db[j], dp[i][j]);
        }
    }

    float ds[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = key0 + tr * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tc + 16 * j, row = q0 + r;
        float p = 0.f;
        ds[i][j] = 0.f;
        if (key < total && row < a.Lq) {
          p = expf(logit(s[i][j], a.sm_scale, bias, a.L1, a.causal, key,
                         a.q_offset + row) - slse[r]);
          ds[i][j] = p * (dp[i][j] - sdelta[r]) * a.sm_scale;
        }
        sp[(tr * 4 + i) * PS + r] = p;
      }
    }
    __syncthreads();  // P^T is complete

#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float pv[4], dv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sp[(tr * 4 + i) * PS + r];
#pragma unroll
      for (int j = 0; j < DJ; ++j) dv[j] = sdo[r * RS + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) dv_acc[i][j] = fmaf(pv[i], dv[j], dv_acc[i][j]);
    }
    __syncthreads();  // done reading P^T

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sp[(tr * 4 + i) * PS + tc + 16 * j] = ds[i][j];
    __syncthreads();  // dS^T is complete

#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float dsv[4], qv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sp[(tr * 4 + i) * PS + r];
#pragma unroll
      for (int j = 0; j < DJ; ++j) qv[j] = sq[r * RS + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = key0 + tr * 4 + i;
    if (key >= total) continue;
    float* dk;
    float* dv;
    if (key < a.L1) {
      const long long off = b * a.kv_bs + h * a.kv_hs + key * a.kv_rs;
      dk = static_cast<float*>(a.dk) + off;
      dv = static_cast<float*>(a.dv) + off;
    } else {
      const long long off = b * a.kv2_bs + h * a.kv2_hs + (key - a.L1) * a.kv2_rs;
      dk = static_cast<float*>(a.dk2) + off;
      dv = static_cast<float*>(a.dv2) + off;
    }
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[tc + 16 * j] = dk_acc[i][j];
      dv[tc + 16 * j] = dv_acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int DH>
cudaError_t launch_t(const BwdArgs& a, int B, int passes, cudaStream_t stream) {
  cudaError_t e;
  if (passes & DQ) {
    constexpr size_t smem = dq_smem_bytes<DH>();
    // above 48 KB of dynamic shared memory needs the opt-in, per device
    e = cudaFuncSetAttribute(band_attn_bwd_dq_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    dim3 grid((a.Lq + BQ - 1) / BQ, a.H, B);
    band_attn_bwd_dq_kernel<DH><<<grid, NT, smem, stream>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (passes & DKV) {
    constexpr size_t smem = dkv_smem_bytes<DH>();
    e = cudaFuncSetAttribute(band_attn_bwd_dkv_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    dim3 grid((a.L1 + a.L2 + BK - 1) / BK, a.H, B);
    band_attn_bwd_dkv_kernel<DH><<<grid, NT, smem, stream>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// The float32 passes on the CUDA cores. Returns the first launch error, if
// any, or cudaErrorInvalidValue for a shape they do not take.
int launch(const BwdArgs& a, int B, int dh, int passes, void* stream) {
  if (B <= 0 || a.Lq <= 0 || a.H <= 0 || a.H > 65535 || B > 65535 ||
      a.L1 + a.L2 <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BAND_ATTN_CASE(D) case D: return (int)launch_t<D>(a, B, passes, s);
  switch (dh) {
    BAND_ATTN_FOR_EACH_DH(BAND_ATTN_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef BAND_ATTN_CASE
}

// [BH, L, Dh] layout: one head per leading row, bias [BH, Lkv], lse and
// delta [BH, Lq]
BwdArgs bh_args(const void* q, const void* k, const void* v, const float* bias,
                const void* dout, const float* lse, const float* delta,
                void* dq, void* dk, void* dv, int lq, int lkv, int dh,
                int q_offset, int causal, float sm_scale) {
  BwdArgs a{};
  a.q = q; a.q_bs = (long long)lq * dh; a.q_hs = 0; a.q_rs = dh;
  a.k = k; a.v = v; a.kv_bs = (long long)lkv * dh; a.kv_hs = 0; a.kv_rs = dh;
  a.bias = bias; a.bias_bs = lkv; a.bias_hs = 0;
  a.k2 = k; a.v2 = v; a.kv2_bs = 0; a.kv2_hs = 0; a.kv2_rs = 0;
  a.dout = dout; a.lse = lse; a.delta = delta;
  a.dq = dq; a.dk = dk; a.dv = dv; a.dk2 = dk; a.dv2 = dv;
  a.H = 1; a.Lq = lq; a.L1 = lkv; a.L2 = 0;
  a.q_offset = q_offset; a.causal = causal; a.sm_scale = sm_scale;
  return a;
}

}  // namespace

extern "C" {

// B2dq: dQ of the blocked band attention over [BH, L, Dh]. bf16 runs the
// tensor-core dq pass alone, float32 the CUDA-core one.
int band_attn_blocked_bwd_dq(const void* q, const void* k, const void* v,
                             const float* bias, const void* dout,
                             const float* lse, const float* delta, void* dq,
                             int bh, int lq, int lkv, int dh, int q_offset,
                             int causal, float sm_scale, int dtype, void* stream) {
  if (dtype == 1)  // bf16: the tensor-core dq pass, H = 1
    return sm90::bwd_bf16(q, k, v, nullptr, nullptr, bias, dout, lse, delta, dq, nullptr,
                          nullptr, nullptr, nullptr, bh, 1, lq, lkv, 0, dh, q_offset, causal,
                          sm_scale, DQ, stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  BwdArgs a = bh_args(q, k, v, bias, dout, lse, delta, dq, nullptr, nullptr,
                      lq, lkv, dh, q_offset, causal, sm_scale);
  return launch(a, bh, dh, DQ, stream);
}

// B2dkv: dK and dV of the blocked band attention over [BH, L, Dh]. bf16 runs
// the tensor-core dkv pass alone, float32 the CUDA-core one.
int band_attn_blocked_bwd_dkv(const void* q, const void* k, const void* v,
                              const float* bias, const void* dout,
                              const float* lse, const float* delta, void* dk,
                              void* dv, int bh, int lq, int lkv, int dh,
                              int q_offset, int causal, float sm_scale,
                              int dtype, void* stream) {
  if (dtype == 1)  // bf16: the tensor-core dkv pass, H = 1
    return sm90::bwd_bf16(q, k, v, nullptr, nullptr, bias, dout, lse, delta, nullptr, dk, dv,
                          nullptr, nullptr, bh, 1, lq, lkv, 0, dh, q_offset, causal, sm_scale,
                          DKV, stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  BwdArgs a = bh_args(q, k, v, bias, dout, lse, delta, nullptr, dk, dv,
                      lq, lkv, dh, q_offset, causal, sm_scale);
  return launch(a, bh, dh, DKV, stream);
}

// B4b: dQ, dK and dV of the whole-tile band attention over [BH, L, Dh]. bf16
// runs both tensor-core passes, float32 the CUDA-core ones.
int band_attn_bh_bwd(const void* q, const void* k, const void* v,
                     const float* bias, const void* dout, const float* lse,
                     const float* delta, void* dq, void* dk, void* dv, int bh,
                     int lq, int lkv, int dh, int q_offset, int causal,
                     float sm_scale, int dtype, void* stream) {
  if (dtype == 1)  // bf16: both tensor-core passes, H = 1
    return sm90::bwd_bf16(q, k, v, nullptr, nullptr, bias, dout, lse, delta, dq, dk, dv,
                          nullptr, nullptr, bh, 1, lq, lkv, 0, dh, q_offset, causal, sm_scale,
                          DQ | DKV, stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  BwdArgs a = bh_args(q, k, v, bias, dout, lse, delta, dq, dk, dv,
                      lq, lkv, dh, q_offset, causal, sm_scale);
  return launch(a, bh, dh, DQ | DKV, stream);
}

// B3b: dQ, dK and dV of the whole-tile band attention in model layout,
// q/dO [B, Lq, H*Dh], k/v [B, Lkv, H*Dh] with head h in columns h*Dh ..
// h*Dh+Dh-1, bias [B, Lkv] shared by the heads, lse and delta [B, H, Lq]:
// the segmented passes with one key segment (L2 = 0, null segment-2
// pointers with zero strides). bf16 runs both tensor-core passes, float32
// the CUDA-core ones.
int band_attn_mh_bwd(const void* q, const void* k, const void* v,
                     const float* bias, const void* dout, const float* lse,
                     const float* delta, void* dq, void* dk, void* dv, int b,
                     int h, int lq, int lkv, int dh, int q_offset, int causal,
                     float sm_scale, int dtype, void* stream) {
  if (dtype == 1)  // bf16: the tensor-core passes, one segment
    return sm90::bwd_bf16(q, k, v, nullptr, nullptr, bias, dout, lse, delta, dq, dk, dv,
                          nullptr, nullptr, b, h, lq, lkv, 0, dh, q_offset, causal, sm_scale,
                          DQ | DKV, stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const long long hd = (long long)h * dh;
  BwdArgs a{};
  a.q = q; a.q_bs = lq * hd; a.q_hs = dh; a.q_rs = hd;
  a.k = k; a.v = v; a.kv_bs = lkv * hd; a.kv_hs = dh; a.kv_rs = hd;
  a.bias = bias; a.bias_bs = lkv; a.bias_hs = 0;
  a.k2 = nullptr; a.v2 = nullptr; a.kv2_bs = 0; a.kv2_hs = 0; a.kv2_rs = 0;
  a.dout = dout; a.lse = lse; a.delta = delta;
  a.dq = dq; a.dk = dk; a.dv = dv; a.dk2 = nullptr; a.dv2 = nullptr;
  a.H = h; a.Lq = lq; a.L1 = lkv; a.L2 = 0;
  a.q_offset = q_offset; a.causal = causal; a.sm_scale = sm_scale;
  return launch(a, b, dh, DQ | DKV, stream);
}

// B1b: model layout [B, L, H*Dh] with the keys in two segments, S [B, Ls,
// H*Dh] with its bias [B, Ls] at positions 0..Ls-1 and NS [B, n, H*Dh], all
// valid, at positions Ls..Ls+n-1; lse and delta [B, H, Lq]. dK/dV of each
// segment go to their own tensors. bf16 runs both tensor-core passes,
// float32 the CUDA-core ones.
int band_attn_segkv_bwd(const void* q, const void* k, const void* v,
                        const void* kns, const void* vns, const float* bias,
                        const void* dout, const float* lse, const float* delta,
                        void* dq, void* dk, void* dv, void* dkns, void* dvns,
                        int b, int h, int lq, int ls, int n, int dh,
                        int q_offset, int causal, float sm_scale, int dtype,
                        void* stream) {
  if (dtype == 1)  // bf16: the tensor-core passes, NS through its own maps
    return sm90::bwd_bf16(q, k, v, kns, vns, bias, dout, lse, delta, dq, dk, dv, dkns, dvns,
                          b, h, lq, ls, n, dh, q_offset, causal, sm_scale, DQ | DKV, stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const long long hd = (long long)h * dh;
  BwdArgs a{};
  a.q = q; a.q_bs = lq * hd; a.q_hs = dh; a.q_rs = hd;
  a.k = k; a.v = v; a.kv_bs = ls * hd; a.kv_hs = dh; a.kv_rs = hd;
  a.bias = bias; a.bias_bs = ls; a.bias_hs = 0;
  a.k2 = kns; a.v2 = vns; a.kv2_bs = n * hd; a.kv2_hs = dh; a.kv2_rs = hd;
  a.dout = dout; a.lse = lse; a.delta = delta;
  a.dq = dq; a.dk = dk; a.dv = dv; a.dk2 = dkns; a.dv2 = dvns;
  a.H = h; a.Lq = lq; a.L1 = ls; a.L2 = n;
  a.q_offset = q_offset; a.causal = causal; a.sm_scale = sm_scale;
  return launch(a, b, dh, DQ | DKV, stream);
}

}  // extern "C"
