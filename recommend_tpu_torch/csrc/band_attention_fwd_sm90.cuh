// Band-masked attention forward on Hopper's tensor cores, bf16 (sm_90a).
//
// Serves the bfloat16 calls of the four entry points of band_attention.cu:
//
//   band_attn_blocked_fwd  replaces _fwd_kernel         :59  (B2f, [BH, L, Dh])
//   band_attn_bh_fwd       replaces _fused_fwd_kernel   :393 (B4f, [BH, L, Dh])
//   band_attn_mh_fwd       replaces _fmh_fwd_kernel     :620 (B3f, [B, L, H*Dh])
//   band_attn_segkv_fwd    replaces _fmhseg_fwd_kernel  :865 (B1f, [B, L, H*Dh],
//                                                             two key segments)
//
// of recommend_tpu/ops/pallas/flash_attention.py. It computes what they do
// (band_attention.cu's note): s = (q . k) * sm_scale + bias[j], + -1e9 above
// the band, max and sum in float32, p rounded to bf16 before PV while l sums
// the unrounded p, out = acc / max(l, 1e-30) in bf16, lse = m + log(max(l,
// 1e-30)) in float32; a key at or past the end of its segment is excluded.
// B1f has two key segments under one softmax: S (Lkv keys at positions
// 0..Lkv-1, with the bias) and NS (L2 keys at Lkv..Lkv+L2-1, all valid, no
// bias); B2f, B4f and B3f are the same with L2 = 0, an instance of the
// kernel (SEG = false) without the second segment's code; B2f and B4f pass
// their [BH, L, Dh] layout as H = 1. On a row with no valid key the plain
// version also gives the NS keys above the band the weight of its padded
// keys (their -1e9 band mask rounds to the padding's -1e9); the kernel, as
// the CUDA-core one, skips them with the tiles above the band. The model
// never reads such rows.
//
// What bounds it on the H100: B2f at its main-path shape (256 x 1, 607 x
// 1214 rows, Dh 128) does 4 * Dh flops per in-band (row, key) pair, 72.5
// GFLOP, against 241 MB moved: bound by operations, barely (0.073 ms at 989
// TF/s; the bytes take 0.072 ms at 3.35 TB/s). B3f at the S-trunk
// gradient's shape (512 x 2 heads, 169 x 350 rows) moves 273 MB for 23.6
// GFLOP: bound by bytes (0.082 ms). B1f at serving phase B's batch forward
// (128 x 2 heads, 364 query rows, 595 + 12 keys) moves 128 MB for 20.3
// GFLOP: bound by bytes (0.038 ms). B4f at training phase TC's layer 0
// (2048 x 1, 181 x 362 rows, Dh 64) moves 289 MB for 25.8 GFLOP: bound by
// bytes (0.086 ms).
//
// What the design does about it:
// - both products run on wgmma: S = Q K^T as m64n64k16 with Q and K K-major
//   in shared memory; O += P V with P taken from the S accumulator's
//   registers (rounded pairwise to bf16: the accumulator layout of S is the
//   A-operand layout of PV) and V read MN-major through the descriptor's
//   transpose, one wgmma per chunk of the head;
// - tiles come by TMA from one 3-D tensor map per operand over [B, L, H*Dh]
//   (B2f's layout is H = 1), 64 rows by a chunk of 64, 32 or 16 columns
//   (the widest that divides Dh) at 128-, 64- or 32-byte swizzle. Rows past
//   a batch's length are zero-filled by the hardware, so a tile never reads
//   the next batch; keys past the end are excluded by the mask. Q is loaded
//   once per block; K and V 64-key tiles go through a two-stage ring with
//   full and empty mbarriers, issued ahead by a producer warp;
// - each key segment has its own K and V maps and is tiled from its own row
//   0, so a key tile never straddles the S/NS seam: the S tiles up to the
//   band edge of the block's last row, then the NS tiles, only when that
//   row sees position Lkv (always with the band off). A key's position is
//   its tile's first position plus its column; S keys read bias[key], NS
//   keys have bias 0, and a key at or past its segment's end gets -inf
//   (p = 0 exactly). Each segment's tiles run in a loop of their own
//   (consume_tile<DH, NS>), so the S tiles run the code of the one-segment
//   instance (one loop that chose the segment per tile ran them markedly
//   slower on the H100, though their instructions hardly differ);
// - one consumer warpgroup owns the block's 64 query rows (64 rows beat 128
//   rows shared by two warpgroups at both entry points' heaviest shapes on
//   the H100); key tiles wholly above the band edge of the block's last
//   real row are skipped, and only tiles that cross the band edge or
//   their segment's end compute the mask, the others add bias[j] only;
// - the online softmax is kept in float32 registers, row max and sum by
//   quad shuffles within the accumulator layout, exp2 of (s - m) * log2(e);
// - the epilogue writes out through the Q tile's shared memory and a TMA
//   store on the same map, which clips rows past Lq; lse [B, H, Lq] directly.
// Not yet: warp specialisation with setmaxnreg, overlapping the softmax of
// one tile with the products of the next, a persistent grid, split-KV.

#pragma once

#include "band_attention_sm90_common.cuh"

namespace band_attn {
namespace sm90 {

constexpr int KEYS = 64;  // keys per K/V tile
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
constexpr int smem_bytes() {
  // 1024 for aligning the tiles to the swizzle pattern, then the Q tile,
  // the K and V rings and the mbarriers (Q, then full K, full V, empty)
  return 1024 + (1 + 2 * STAGES) * Tile<DH>::BYTES + 8 * (1 + 3 * STAGES);
}

struct Params {
  const float* bias;  // [B, Lkv] float32, one row per blockIdx.z (B2f: per head)
  float* lse;         // [B, H, Lq] float32
  int H, Lq, Lkv, L2, q_offset, causal;  // Lkv keys in S, L2 in NS (0: none)
  float sm_scale;
};

// --- the kernel ------------------------------------------------------------

// shared-memory addresses of a block: the Q tile, the K and V rings and
// their full and empty mbarriers
struct Smem {
  uint32_t q, k, v, full_k, full_v, empty;
};

// One 64-key tile t of the consumer warpgroup, the stage t % STAGES of the
// ring: S = Q K^T, the masked online-softmax update of m, l and o, then
// O += P V. The tile's first key is key0 of a segment of len keys, at
// position pos0; NS: the segment has no bias. Rows r and r + 8 of the
// block's 64 are this thread's.
template <int DH, bool NS>
__device__ __forceinline__ void consume_tile(const Smem& sm, int t, int key0, int len, int pos0,
                                             const float* bias, const Params& p, int row0,
                                             int r, int quad,
                                             float (&o)[Tile<DH>::CHUNKS][Tile<DH>::CW / 2],
                                             float (&m)[2], float (&l)[2]) {
  using G = Tile<DH>;
  const int s = t % STAGES;
  const uint32_t parity = (t / STAGES) & 1;
  mbar_wait(sm.full_k + 8 * s, parity);
  float sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < G::CHUNKS; ++c)
#pragma unroll
    for (int kk = 0; kk < G::CW / 16; ++kk)
      wgmma_ss_n64(sc, desc<DH>(sm.q + c * G::CHUNK_BYTES + kk * 32),
                   desc<DH>(sm.k + s * G::BYTES + c * G::CHUNK_BYTES + kk * 32), c + kk > 0);
  wgmma_commit();
  // this thread's 16 keys' bias (NS keys have none), read while the product
  // runs
  float bv[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int key = key0 + 8 * (i / 2) + 2 * quad + (i % 2);
    bv[i] = NS || key >= len ? 0.f : __ldg(bias + key);
  }
  wgmma_wait_all();
  fence_regs(sc);

  // only a tile that crosses the band edge of row0 or its segment's end
  // masks
  const bool edge = key0 + KEYS > len || (p.causal && pos0 + KEYS - 1 > p.q_offset + row0);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qpos = p.q_offset + row0 + r + 8 * hf;
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int j = 4 * (i / 2) + 2 * hf + (i % 2);
      float x = fmaf(sc[j], p.sm_scale, bv[i]);
      if (edge) {
        const int col = 8 * (i / 2) + 2 * quad + (i % 2);
        if (key0 + col >= len) x = -INFINITY;  // past the segment: excluded, p = 0
        else if (p.causal && pos0 + col > qpos) x += NEG_INF;
      }
      sc[j] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[hf], mx);
    const float alpha = exp2f((m[hf] - m_new) * LOG2E);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int j = 4 * (i / 2) + 2 * hf + (i % 2);
      const float pj = exp2f((sc[j] - m_new) * LOG2E);
      sc[j] = pj;
      sum += pj;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[hf] = l[hf] * alpha + sum;
    m[hf] = m_new;
#pragma unroll
    for (int c = 0; c < G::CHUNKS; ++c)
#pragma unroll
      for (int i = 0; i < G::CW / 4; ++i) o[c][4 * (i / 2) + 2 * hf + (i % 2)] *= alpha;
  }
  // P as the A operand of PV, k16 step kk: keys 16 kk .. 16 kk + 15
  uint32_t pa[KEYS / 16][4];
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
  mbar_wait(sm.full_v + 8 * s, parity);
#pragma unroll
  for (int c = 0; c < G::CHUNKS; ++c) fence_regs(o[c]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk)
#pragma unroll
    for (int c = 0; c < G::CHUNKS; ++c)
      wgmma_rs(o[c], pa[kk],
               desc<DH>(sm.v + s * G::BYTES + c * G::CHUNK_BYTES + kk * 16 * G::ROW_BYTES));
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int c = 0; c < G::CHUNKS; ++c) fence_regs(o[c]);
  mbar_arrive(sm.empty + 8 * s);
}

// One block per (64 query rows, head, batch row): one consumer warpgroup,
// then one producer warp. SEG: the keys have a second segment (tk2, tv2;
// p.L2 > 0); without it those maps are not read. Each segment's tiles run
// in a loop of their own, so the S tiles run the same code in both
// instances.
template <int DH, bool SEG>
__global__ void __launch_bounds__(128 + 32, 2)
band_attn_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tk2,
                          const __grid_constant__ CUtensorMap tv2,
                          const __grid_constant__ CUtensorMap to, const Params p) {
  using G = Tile<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;        // the Q tile, later the out tile
  uint8_t* const out_tile = smem_raw + (sq - raw);  // generic pointer to sq
  const uint32_t sk = sq + G::BYTES;                // STAGES K tiles
  const uint32_t sv = sk + STAGES * G::BYTES;       // STAGES V tiles
  const uint32_t bar_q = sv + STAGES * G::BYTES;
  const uint32_t full_k = bar_q + 8, full_v = full_k + 8 * STAGES, empty = full_v + 8 * STAGES;

  const int tile = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = tile * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // the key tiles the block's rows need: S's up to the band edge of its last
  // row (keys at positions < edge), then NS's; each segment tiled from its
  // own row 0
  const int edge = p.q_offset + min(row0 + ROWS, p.Lq);
  const int n1 = ((p.causal ? max(0, min(p.Lkv, edge)) : p.Lkv) + KEYS - 1) / KEYS;
  const int n_tiles =
      n1 + (SEG ? ((p.causal ? max(0, min(p.L2, edge - p.Lkv)) : p.L2) + KEYS - 1) / KEYS : 0);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // producer
    if (lane == 0) {
      mbar_expect_tx(bar_q, G::BYTES);
#pragma unroll
      for (int c = 0; c < G::CHUNKS; ++c)
        tma_load(sq + c * G::CHUNK_BYTES, &tq, bar_q, h * DH + c * G::CW, row0, b);
      // K and V tile t, rows key0.. of the maps mk and mv, into its stage
      auto load_kv = [&](int t, const CUtensorMap* mk, const CUtensorMap* mv, int key0) {
        const int s = t % STAGES;
        mbar_wait(empty + 8 * s, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(full_k + 8 * s, G::BYTES);
#pragma unroll
        for (int c = 0; c < G::CHUNKS; ++c)
          tma_load(sk + s * G::BYTES + c * G::CHUNK_BYTES, mk, full_k + 8 * s,
                   h * DH + c * G::CW, key0, b);
        mbar_expect_tx(full_v + 8 * s, G::BYTES);
#pragma unroll
        for (int c = 0; c < G::CHUNKS; ++c)
          tma_load(sv + s * G::BYTES + c * G::CHUNK_BYTES, mv, full_v + 8 * s,
                   h * DH + c * G::CW, key0, b);
      };
      for (int t = 0; t < n1; ++t) load_kv(t, &tk, &tv, t * KEYS);
      if (SEG)
        for (int t = n1; t < n_tiles; ++t) load_kv(t, &tk2, &tv2, (t - n1) * KEYS);
    }
    return;
  }

  // the consumer warpgroup: rows row0 .. row0 + 63; this thread holds rows
  // r and r + 8 of them, columns 8 j + 2 quad + {0, 1} of each 8-column group
  const int r = warp * 16 + lane / 4;
  const int quad = lane % 4;
  const float* bias = p.bias + static_cast<long long>(b) * p.Lkv;
  const Smem sm{sq, sk, sv, full_k, full_v, empty};

  float o[G::CHUNKS][G::CW / 2];
#pragma unroll
  for (int c = 0; c < G::CHUNKS; ++c)
#pragma unroll
    for (int i = 0; i < G::CW / 2; ++i) o[c][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  for (int t = 0; t < n1; ++t)
    consume_tile<DH, false>(sm, t, t * KEYS, p.Lkv, t * KEYS, bias, p, row0, r, quad, o, m, l);
  if (SEG)
    for (int t = n1; t < n_tiles; ++t) {
      const int key0 = (t - n1) * KEYS;
      consume_tile<DH, true>(sm, t, key0, p.L2, p.Lkv + key0, bias, p, row0, r, quad, o, m, l);
    }

  float lc[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) lc[hf] = fmaxf(l[hf], 1e-30f);
  // out through the Q tile (its last product has completed in every warp)
  consumer_sync();
#pragma unroll
  for (int c = 0; c < G::CHUNKS; ++c)
#pragma unroll
    for (int i = 0; i < G::CW / 4; ++i) {
      const int hf = i % 2, j = 4 * (i / 2) + 2 * hf;
      const int col = 8 * (i / 2) + 2 * quad;
      *reinterpret_cast<__nv_bfloat162*>(out_tile + c * G::CHUNK_BYTES +
                                         swizzled<DH>(r + 8 * hf, 2 * col)) =
          __floats2bfloat162_rn(o[c][j] / lc[hf], o[c][j + 1] / lc[hf]);
    }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumer_sync();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < G::CHUNKS; ++c)
      tma_store(&to, sq + c * G::CHUNK_BYTES, h * DH + c * G::CW, row0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
  if (quad == 0) {
    float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.Lq;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = row0 + r + 8 * hf;
      if (row < p.Lq) lse[row] = m[hf] + logf(lc[hf]);
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int DH, bool SEG>
cudaError_t launch(const void* q, const void* k, const void* v, const void* k2, const void* v2,
                   void* out, const Params& p, int B, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tk2{}, tv2{}, to;
  const int width = p.H * DH;
  if (!encode<DH>(&tq, q, width, p.Lq, B) || !encode<DH>(&tk, k, width, p.Lkv, B) ||
      !encode<DH>(&tv, v, width, p.Lkv, B) || !encode<DH>(&to, out, width, p.Lq, B))
    return cudaErrorInvalidValue;
  if (SEG && (!encode<DH>(&tk2, k2, width, p.L2, B) || !encode<DH>(&tv2, v2, width, p.L2, B)))
    return cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<DH>();
  const cudaError_t e = cudaFuncSetAttribute(band_attn_fwd_sm90_kernel<DH, SEG>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Lq + ROWS - 1) / ROWS, p.H, B);
  band_attn_fwd_sm90_kernel<DH, SEG><<<grid, 128 + 32, smem, stream>>>(tq, tk, tv, tk2, tv2, to, p);
  return cudaGetLastError();
}

// The bf16 forward over q/out [B, Lq, H*Dh], the first key segment k/v [B,
// L1, H*Dh] with its bias [B, L1], the second k2/v2 [B, L2, H*Dh] (null
// when L2 = 0), lse [B, H, Lq]; every bf16 tensor 16-byte aligned. Returns
// the launch's CUDA error, or cudaErrorInvalidValue for a shape it does not
// take or a tensor map that does not encode.
inline int fwd_bf16(const void* q, const void* k, const void* v, const void* k2, const void* v2,
                    const float* bias, void* out, float* lse, int B, int H, int Lq, int L1,
                    int L2, int dh, int q_offset, int causal, float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || L1 <= 0 || L2 < 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{bias, lse, H, Lq, L1, L2, q_offset, causal, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BAND_ATTN_SM90_CASE(D)                                          \
  case D:                                                               \
    return (int)(L2 > 0 ? launch<D, true>(q, k, v, k2, v2, out, p, B, s) \
                        : launch<D, false>(q, k, v, k2, v2, out, p, B, s));
  switch (dh) {
    BAND_ATTN_FOR_EACH_DH(BAND_ATTN_SM90_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef BAND_ATTN_SM90_CASE
}

}  // namespace sm90
}  // namespace band_attn
