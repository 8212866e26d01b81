// Band-masked attention forward kernels for Hopper (sm_90a).
//
// Four entry points, one per Pallas forward kernel of
// recommend_tpu/ops/pallas/flash_attention.py:
//
//   band_attn_blocked_fwd  replaces _fwd_kernel       (flash_band_attention, B2f)
//   band_attn_bh_fwd       replaces _fused_fwd_kernel (fused_band_attention, B4f)
//   band_attn_mh_fwd       replaces _fmh_fwd_kernel   (fused_mh_band_attention, B3f)
//   band_attn_segkv_fwd    replaces _fmhseg_fwd_kernel (fused_mhseg_band_attention, B1f)
//
// What they compute (the semantics of all four Pallas kernels): for query row
// r at absolute position q_offset + r and key j at position j,
//   s = (q . k) * sm_scale + bias[j]            bias is 0 or -1e9, finite
//   s += -1e9                 if causal and j > q_offset + r (the band)
//   out = sum_j round_v(p_j) v_j / max(sum_j p_j, 1e-30),  p_j = exp(s_j - m)
//   lse = m + log(max(sum_j p_j, 1e-30))         in float32
// where round_v casts p to the value dtype before the PV product. The
// segmented-KV form joins a second key/value segment (the NS tokens, all
// valid, no bias) at positions L1..L1+L2-1 under the same softmax.
//
// The four differ only in layout (strides) and in the optional second
// segment, so they share one templated device function. A key past the end
// of the keys is excluded outright: the TPU kernels pad keys to a tile
// multiple with bias -1e9, which only matters for a query row whose keys are
// all masked, and there the plain reference (a uniform softmax over the real
// keys) is what this kernel computes.
//
// Two bodies serve them, split by dtype. Every bfloat16 call runs on the
// tensor cores: band_attention_fwd_sm90.cuh (wgmma for both products,
// TMA-fed tiles in a K/V ring, B1f's NS segment through its own tensor maps;
// its note says what bounds them and what it does), [BH, L, Dh] as H = 1.
// Every float32 call runs the CUDA-core body below: the tensor cores have no
// full-float32 product, and TF32 would not hold the float32 checks at 1e-4.
// The CUDA-core body: one block per (batch, head, 64-row query tile); the
// block loops over 64-key tiles only up to the band edge of its last row
// (tiles wholly above the band are skipped, as _run_block does), keeps the
// running max/sum/accumulator of the online softmax in registers, and stages
// Q, K then V, and P in shared memory, so the [Lq, Lkv] logits never reach
// device memory. Its products are float32 FMAs (67 TF/s peak), so it stays
// far from its bound: at the serving shapes the work is 4 * Dh flops per
// in-band (row, key) pair against roughly (Lq + 2 Lkv) * Dh elements moved.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "band_attention_common.cuh"
#include "band_attention_fwd_sm90.cuh"

namespace {

using namespace band_attn;

struct Args {
  const void* q; long long q_bs, q_hs, q_rs;        // element strides
  const void* k; const void* v; long long kv_bs, kv_hs, kv_rs;
  const float* bias; long long bias_bs, bias_hs;    // [.., L1] additive
  const void* k2; const void* v2; long long kv2_bs, kv2_hs, kv2_rs;
  void* out; long long o_bs, o_hs, o_rs;
  float* lse;                                       // [B, H, Lq] contiguous
  int H, Lq, L1, L2, q_offset, causal;
  float sm_scale;
};

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (DH + 1) + BK * (DH + 1) + BQ * (BK + 1));
}

template <int DH>
__global__ void __launch_bounds__(NT) band_attn_kernel(const Args a) {
  static_assert(DH % 16 == 0, "Dh must be a multiple of 16");
  constexpr int RS = DH + 1;        // padded smem row stride (no bank conflicts)
  constexpr int PS = BK + 1;
  constexpr int DJ = DH / 16;       // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;                 // [BQ][RS]
  float* skv = sq + BQ * RS;        // [BK][RS]  K tile, then V tile
  float* sp = skv + BK * RS;        // [BQ][PS]  probabilities

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tr = tid >> 4;          // rows tr*4 .. tr*4+3 of the tile
  const int tc = tid & 15;          // keys tc + 16 j; columns tc + 16 j
  const int row0 = tile * BQ;
  const int total = a.L1 + a.L2;

  const float* q = static_cast<const float*>(a.q) + b * a.q_bs + h * a.q_hs;
  const float* k1 = static_cast<const float*>(a.k) + b * a.kv_bs + h * a.kv_hs;
  const float* v1 = static_cast<const float*>(a.v) + b * a.kv_bs + h * a.kv_hs;
  const float* k2 = static_cast<const float*>(a.k2) + b * a.kv2_bs + h * a.kv2_hs;
  const float* v2 = static_cast<const float*>(a.v2) + b * a.kv2_bs + h * a.kv2_hs;
  const float* bias = a.bias + b * a.bias_bs + h * a.bias_hs;

  for (int i = tid; i < BQ * DH; i += NT) {
    const int r = i / DH, d = i % DH, row = row0 + r;
    sq[r * RS + d] = row < a.Lq ? q[row * a.q_rs + d] : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // keys beyond the band edge of the tile's last real row are never needed
  int kv_end = total;
  if (a.causal) {
    const int last_row = min(row0 + BQ, a.Lq) - 1;
    kv_end = max(0, min(total, a.q_offset + last_row + 1));
  }

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's PV is done with skv and sp
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
      const int qpos = a.q_offset + row0 + tr * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tc + 16 * j;
        float x;
        if (key >= total) {
          x = -INFINITY;  // past the keys: excluded, contributes exactly 0
        } else {
          x = s[i][j] * a.sm_scale;
          if (key < a.L1) x = x + bias[key];
          if (a.causal && key > qpos) x = x + NEG_INF;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sp[(tr * 4 + i) * PS + tc + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // scores done with the K tile; P is complete

    for (int i = tid; i < BK * DH; i += NT) {
      const int kk = i / DH, d = i % DH, j = k0 + kk;
      float x = 0.f;
      if (j < a.L1) x = v1[j * a.kv_rs + d];
      else if (j < total) x = v2[(j - a.L1) * a.kv2_rs + d];
      skv[kk * RS + d] = x;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sp[(tr * 4 + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = skv[kk * RS + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  float* out = static_cast<float*>(a.out) + b * a.o_bs + h * a.o_hs;
  float* lse = a.lse + ((long long)b * a.H + h) * a.Lq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + tr * 4 + i;
    if (row >= a.Lq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      out[row * a.o_rs + tc + 16 * j] = acc[i][j] / lc;
    if (tc == 0) lse[row] = m[i] + logf(lc);
  }
}

template <int DH>
cudaError_t launch_t(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  // above 48 KB of dynamic shared memory needs the opt-in, per device
  cudaError_t e = cudaFuncSetAttribute(
      band_attn_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.Lq + BQ - 1) / BQ, a.H, B);
  band_attn_kernel<DH><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

// The float32 forward on the CUDA cores. Returns cudaGetLastError() of the
// launch, or cudaErrorInvalidValue for a shape it does not take.
int launch(const Args& a, int B, int dh, void* stream) {
  if (B <= 0 || a.Lq <= 0 || a.H <= 0 || a.H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BAND_ATTN_CASE(D) case D: return (int)launch_t<D>(a, B, s);
  switch (dh) {
    BAND_ATTN_FOR_EACH_DH(BAND_ATTN_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef BAND_ATTN_CASE
}

// [BH, L, Dh] layout: one head per leading row, bias [BH, Lkv], lse [BH, Lq]
Args bh_args(const void* q, const void* k, const void* v, const float* bias,
             void* out, float* lse, int lq, int lkv, int dh, int q_offset,
             int causal, float sm_scale) {
  Args a{};
  a.q = q; a.q_bs = (long long)lq * dh; a.q_hs = 0; a.q_rs = dh;
  a.k = k; a.v = v; a.kv_bs = (long long)lkv * dh; a.kv_hs = 0; a.kv_rs = dh;
  a.bias = bias; a.bias_bs = lkv; a.bias_hs = 0;
  a.k2 = k; a.v2 = v; a.kv2_bs = 0; a.kv2_hs = 0; a.kv2_rs = 0;
  a.out = out; a.o_bs = (long long)lq * dh; a.o_hs = 0; a.o_rs = dh;
  a.lse = lse;
  a.H = 1; a.Lq = lq; a.L1 = lkv; a.L2 = 0;
  a.q_offset = q_offset; a.causal = causal; a.sm_scale = sm_scale;
  return a;
}

// [B, L, H*Dh] model layout, bias [B, L1] shared by the heads, lse [B, H, Lq]
Args mh_args(const void* q, const void* k, const void* v, const float* bias,
             void* out, float* lse, int h, int lq, int l1, int dh,
             int q_offset, int causal, float sm_scale) {
  const long long hd = (long long)h * dh;
  Args a{};
  a.q = q; a.q_bs = lq * hd; a.q_hs = dh; a.q_rs = hd;
  a.k = k; a.v = v; a.kv_bs = l1 * hd; a.kv_hs = dh; a.kv_rs = hd;
  a.bias = bias; a.bias_bs = l1; a.bias_hs = 0;
  a.k2 = k; a.v2 = v; a.kv2_bs = 0; a.kv2_hs = 0; a.kv2_rs = 0;
  a.out = out; a.o_bs = lq * hd; a.o_hs = dh; a.o_rs = hd;
  a.lse = lse;
  a.H = h; a.Lq = lq; a.L1 = l1; a.L2 = 0;
  a.q_offset = q_offset; a.causal = causal; a.sm_scale = sm_scale;
  return a;
}

}  // namespace

extern "C" {

// B2f: blocked online-softmax band attention over [BH, L, Dh]
int band_attn_blocked_fwd(const void* q, const void* k, const void* v,
                          const float* bias, void* out, float* lse, int bh,
                          int lq, int lkv, int dh, int q_offset, int causal,
                          float sm_scale, int dtype, void* stream) {
  if (dtype == 1)  // bf16: the tensor-core kernel, [BH, L, Dh] as H = 1
    return sm90::fwd_bf16(q, k, v, nullptr, nullptr, bias, out, lse, bh, 1, lq, lkv, 0, dh,
                          q_offset, causal, sm_scale, stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  Args a = bh_args(q, k, v, bias, out, lse, lq, lkv, dh, q_offset, causal, sm_scale);
  return launch(a, bh, dh, stream);  // float32: band_attn_kernel<DH>
}

// B4f: whole-tile band attention over [BH, L, Dh]
int band_attn_bh_fwd(const void* q, const void* k, const void* v,
                     const float* bias, void* out, float* lse, int bh, int lq,
                     int lkv, int dh, int q_offset, int causal, float sm_scale,
                     int dtype, void* stream) {
  if (dtype == 1)  // bf16: the tensor-core kernel, [BH, L, Dh] as H = 1
    return sm90::fwd_bf16(q, k, v, nullptr, nullptr, bias, out, lse, bh, 1, lq, lkv, 0, dh,
                          q_offset, causal, sm_scale, stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  Args a = bh_args(q, k, v, bias, out, lse, lq, lkv, dh, q_offset, causal, sm_scale);
  return launch(a, bh, dh, stream);  // float32: band_attn_kernel<DH>
}

// B3f: whole-tile band attention in model layout [B, L, H*Dh]
int band_attn_mh_fwd(const void* q, const void* k, const void* v,
                     const float* bias, void* out, float* lse, int b, int h,
                     int lq, int lkv, int dh, int q_offset, int causal,
                     float sm_scale, int dtype, void* stream) {
  if (dtype == 1)  // bf16: the tensor-core kernel, one key segment
    return sm90::fwd_bf16(q, k, v, nullptr, nullptr, bias, out, lse, b, h, lq, lkv, 0, dh,
                          q_offset, causal, sm_scale, stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  Args a = mh_args(q, k, v, bias, out, lse, h, lq, lkv, dh, q_offset, causal, sm_scale);
  return launch(a, b, dh, stream);  // float32: band_attn_kernel<DH>
}

// B1f: model layout with the keys in two segments, S [B, Ls, H*Dh] with its
// bias [B, Ls] at positions 0..Ls-1 and NS [B, n, H*Dh], all valid, at
// positions Ls..Ls+n-1, under one softmax
int band_attn_segkv_fwd(const void* q, const void* k, const void* v,
                        const void* kns, const void* vns, const float* bias,
                        void* out, float* lse, int b, int h, int lq, int ls,
                        int n, int dh, int q_offset, int causal,
                        float sm_scale, int dtype, void* stream) {
  if (dtype == 1)  // bf16: the tensor-core kernel, NS through its own maps
    return sm90::fwd_bf16(q, k, v, kns, vns, bias, out, lse, b, h, lq, ls, n, dh, q_offset,
                          causal, sm_scale, stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  Args a = mh_args(q, k, v, bias, out, lse, h, lq, ls, dh, q_offset, causal, sm_scale);
  const long long hd = (long long)h * dh;
  a.k2 = kns; a.v2 = vns; a.kv2_bs = n * hd; a.kv2_hs = dh; a.kv2_rs = hd;
  a.L2 = n;
  return launch(a, b, dh, stream);  // float32: band_attn_kernel<DH>
}

}  // extern "C"
