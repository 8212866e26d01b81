// Band-masked attention backward on Hopper's tensor cores, bf16 (sm_90a).
//
// Serves the bfloat16 calls of five entry points of band_attention_bwd.cu:
//
//   band_attn_segkv_bwd        replaces _fmhseg_bwd_kernel :912 (B1b, both passes,
//                                                          [B, L, H*Dh], two
//                                                          key segments)
//   band_attn_mh_bwd           replaces _fmh_bwd_kernel    :654 (B3b, both passes,
//                                                          [B, L, H*Dh])
//   band_attn_bh_bwd           replaces _fused_bwd_kernel  :420 (B4b, both passes,
//                                                          [BH, L, Dh])
//   band_attn_blocked_bwd_dq   replaces _dq_kernel         :102 (B2dq, the dq pass
//                                                          alone, [BH, L, Dh])
//   band_attn_blocked_bwd_dkv  replaces _dkv_kernel        :142 (B2dkv, the dkv
//                                                          pass alone, [BH, L, Dh])
//
// All five take every head width of BAND_ATTN_FOR_EACH_DH (the dispatchers
// send B4b every width that is not a multiple of 128, B1b and B3b the
// multiples of 128).
//
// of recommend_tpu/ops/pallas/flash_attention.py. It computes what they do
// (band_attention_bwd.cu's note): for query row r and key j, s is formed as
// logit() forms it (x sm_scale, + bias[j], + -1e9 above the band), p =
// exp(s - lse[r]), dV = round(p)^T dO, dp = dO V^T, dS = round(p (dp -
// delta[r]) sm_scale), dQ = dS K, dK = dS^T Q, sums in float32, outputs in
// bf16. The two rounding points are the bf16 operands wgmma takes, so the
// kernel differs from the plain version only in the order of summation, and
// on a row with no valid key, where the plain version gives the NS keys
// above the band p = 1 too (their -1e9 band mask rounds to the padded keys'
// -1e9) and the kernel, as the CUDA-core passes, skips them with the tiles
// above the band; the model's dO on such rows is 0. B1b
// has two key segments: S (L1 keys at positions 0..L1-1, with the bias) and
// NS (L2 keys at L1..L1+L2-1, all valid, no bias), whose gradients go to
// their own tensors; B3b is the same with L2 = 0, and B4b is B3b in the
// [BH, L, Dh] layout (H = 1, one row of bias, lse and delta per batch-head
// row), B2dq and B2dkv its dq and its dkv pass alone.
//
// What bounds it on the H100: B1b at phase TA's layer 0 (512 x 2 heads, 181
// query rows, 350 + 12 keys, Dh 128) does 10 * Dh flops per in-band (row,
// key) pair, 64.5 GFLOP (0.065 ms at 989 TF/s), against 524 MB moved (0.157
// ms at 3.35 TB/s): bound by bytes. The two passes below recompute S and dP,
// 14 * Dh flops a pair, so the tensor cores must run at about 60% of their
// peak for the bytes to be the limit. B4b at phase TC's layer 0 (2048
// batch-head rows, 181 query rows, 362 keys, Dh 64) is bound by bytes too
// (0.158 ms). B2dkv at phase TB's layer 0 (256 batch-head rows, 607 query
// rows, 1214 keys, Dh 128) does 8 * Dh flops per in-band pair (S^T, dP^T,
// dV and dK), 145 GFLOP against 400 MB: bound by operations (0.147 ms); B2dq
// there 6 * Dh (S, dP and dQ), 109 GFLOP (0.110 ms).
//
// What the design does about it:
// - two passes, no atomics on the outputs (deterministic), as the CUDA-core
//   kernels: a dq pass, one block per (64 query rows, head, batch row), and
//   a dkv pass, one block per (two 64-key tiles, head, batch row). A call
//   names the passes it runs (DQ, DKV), and only their tensor maps are
//   encoded and only they are launched;
// - all five products on wgmma, from tiles laid out as the forward lays
//   them out (band_attention_sm90_common.cuh), with no transposed copy:
//   dq pass: S = Q K^T and dP = dO V^T K-major; dQ += dS K with dS taken
//   from the accumulator registers (rounded pairwise to bf16) and K read
//   MN-major through the descriptor's transpose. dkv pass: S^T = K Q^T and
//   dP^T = V dO^T K-major; dV += P^T dO and dK += dS^T Q from registers,
//   with dO and Q MN-major;
// - tiles come by TMA from 3-D tensor maps over [B, L, H*Dh], 64 rows by a
//   chunk of 64, 32 or 16 columns (the widest that divides Dh; Tile<DH>), as
//   the forward tiles them: the MN-major operands (K in dQ, dO in dV, Q in
//   dK) span one chunk in N, so their products are m64n64k16, m64n32k16 or
//   m64n16k16, one per chunk and k16 step. Each segment
//   has its own maps and is tiled from its own row 0, so a key tile never
//   straddles the seam: the last S tile and the NS tile are zero-filled
//   past their segment's rows, whose keys get bias -inf, so p = 0 and
//   dS = 0 exactly and nothing leaks into the other segment's gradients;
//   rows past Lq get lse +inf, to the same end;
// - dq pass: a producer warp and one consumer warpgroup, two blocks to an
//   SM (168 registers). Q and dO are loaded once, lse and delta of the
//   thread's two rows read once; K/V tile pairs of S up to the band edge of
//   the block's last row, then NS's, go through a two-stage ring; dQ leaves
//   through the Q tile's shared memory and a TMA store that clips rows
//   >= Lq;
// - dkv pass: dK and dV (64 + 64 float32 registers a thread) and S^T and
//   dP^T (32 + 32) take more than the 168 registers that two blocks of a
//   consumer warpgroup and a producer warp get, and ptxas sizes a block of
//   two warpgroups and a producer warp as three warpgroups, so the block is
//   two warpgroups and nothing else (up to 255 registers; 242 used): one
//   per key tile, each with its K and V loaded once, sharing a three-stage
//   Q/dO ring. Thread 0 issues the first loads, and the warpgroup that
//   releases a stage last (a count in shared memory) refills it. Each
//   warpgroup stages a tile's 64 lse and 64 delta values in shared memory.
//   The rows of S^T are keys, so a thread's two key biases are fixed over
//   the loop, and the band test is key > q_offset + query with the query
//   from the column. dK and dV leave through the K and V tiles' shared
//   memory and TMA stores on the segment's own maps, which clip rows past
//   the segment;
// - the band is tested only on tiles that cross its edge; tiles wholly
//   above it are skipped (dq: key tiles past the block's last row; dkv:
//   query tiles before the first row that sees the keys);
// - s - lse is taken before the exponential and each operation is rounded
//   as the plain version rounds it (no contraction into fma): on a fully
//   padded row s and lse both round to -1e9 and p = 1, as there.
// Not yet: overlapping one tile's elementwise work with the next tile's
// products within a warpgroup, a persistent grid (a dkv block's loads and
// stores are not overlapped by another block's work).

#pragma once

#include "band_attention_sm90_common.cuh"

namespace band_attn {

// the passes of a backward call, for the CUDA-core and the tensor-core bodies
enum Pass { DQ = 1, DKV = 2 };

namespace sm90 {

// the tensor maps of one backward call, all over bf16 [B, L, H*Dh]; the
// second segment's four are left empty when it has no rows, and a pass's
// outputs when it does not run
struct BwdMaps {
  CUtensorMap q, dout, k, v, k2, v2, dq, dk, dv, dk2, dv2;
};

// consumer warpgroups of a dkv block, one per 64-key tile, and the depth of
// its Q/dO ring
constexpr int DKV_WARPGROUPS = 2;
constexpr int DKV_STAGES = 3;

struct BwdParams {
  const float* bias;   // [B, L1] float32, the first segment's keys
  const float* lse;    // [B, H, Lq] float32
  const float* delta;  // [B, H, Lq] float32
  int H, Lq, L1, L2, q_offset, causal;
  float sm_scale;
};

template <int DH>
constexpr int dq_smem_bytes() {
  // 1024 for aligning the tiles to the swizzle pattern, the Q and dO tiles,
  // a ring of STAGES K/V tile pairs, and the mbarriers (Q, full, empty)
  return 1024 + (2 + 2 * STAGES) * Tile<DH>::BYTES + 8 * (1 + 2 * STAGES);
}

template <int DH>
constexpr int dkv_smem_bytes() {
  // the alignment, each warpgroup's K and V tiles, a ring of DKV_STAGES Q/dO
  // tile pairs, each warpgroup's staged lse and delta per stage, the
  // mbarriers (K/V, full per stage) and the release count per stage
  return 1024 + (2 * DKV_WARPGROUPS + 2 * DKV_STAGES) * Tile<DH>::BYTES +
         DKV_WARPGROUPS * DKV_STAGES * 2 * ROWS * 4 + 8 * (1 + DKV_STAGES) + 4 * DKV_STAGES;
}

// the 128 threads of consumer warpgroup `wg` (named barrier 1 + wg)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// p and dS of one (row, key) pair from its raw products qk = q . k and dpv =
// dO . v, each operation rounded as the plain version rounds it. A key past
// its segment comes with bias -inf and a row past Lq with lse +inf, so p = 0
// and dS = 0 there exactly.
__device__ __forceinline__ void grad_pair(float qk, float dpv, float bias, bool above, float lse,
                                          float delta, float sm_scale, float& p, float& ds) {
  float x = __fadd_rn(__fmul_rn(qk, sm_scale), bias);
  if (above) x = __fadd_rn(x, NEG_INF);
  p = expf(__fsub_rn(x, lse));
  ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dpv, delta)), sm_scale);
}

// --- dq pass -----------------------------------------------------------------

// One block per (64 query rows, head, batch row): one consumer warpgroup,
// then one producer warp; two blocks share an SM.
template <int DH>
__global__ void __launch_bounds__(128 + 32, 2)
band_attn_bwd_dq_sm90_kernel(const __grid_constant__ BwdMaps m, const BwdParams p) {
  using G = Tile<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;        // the Q tile, later the dQ tile
  uint8_t* const out_tile = smem_raw + (sq - raw);  // generic pointer to sq
  const uint32_t sdo = sq + G::BYTES;
  const uint32_t sk = sdo + G::BYTES;               // STAGES K tiles
  const uint32_t sv = sk + STAGES * G::BYTES;       // STAGES V tiles
  const uint32_t bar_q = sv + STAGES * G::BYTES;
  const uint32_t full = bar_q + 8, empty = full + 8 * STAGES;

  const int tile = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = tile * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // the key tiles the block's rows see: S's up to the band edge of its last
  // row (keys at positions < edge), then NS's; each segment tiled from its
  // own row 0
  const int edge = p.q_offset + min(row0 + ROWS, p.Lq);
  const int end1 = p.causal ? max(0, min(p.L1, edge)) : p.L1;
  const int end2 = p.causal ? max(0, min(p.L2, edge - p.L1)) : p.L2;
  const int n1 = (end1 + ROWS - 1) / ROWS;
  const int n_tiles = n1 + (end2 + ROWS - 1) / ROWS;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // producer
    if (lane == 0) {
      mbar_expect_tx(bar_q, 2 * G::BYTES);
#pragma unroll
      for (int c = 0; c < G::CHUNKS; ++c) {
        tma_load(sq + c * G::CHUNK_BYTES, &m.q, bar_q, h * DH + c * G::CW, row0, b);
        tma_load(sdo + c * G::CHUNK_BYTES, &m.dout, bar_q, h * DH + c * G::CW, row0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const bool second = t >= n1;
        const CUtensorMap* mk = second ? &m.k2 : &m.k;
        const CUtensorMap* mv = second ? &m.v2 : &m.v;
        const int key0 = (second ? t - n1 : t) * ROWS;
        mbar_wait(empty + 8 * s, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * G::BYTES);
#pragma unroll
        for (int c = 0; c < G::CHUNKS; ++c) {
          tma_load(sk + s * G::BYTES + c * G::CHUNK_BYTES, mk, full + 8 * s,
                   h * DH + c * G::CW, key0, b);
          tma_load(sv + s * G::BYTES + c * G::CHUNK_BYTES, mv, full + 8 * s,
                   h * DH + c * G::CW, key0, b);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: rows row0 .. row0 + 63; this thread holds rows
  // r and r + 8 of them, keys 8 j + 2 quad + {0, 1} of each 8-key group
  const int r = warp * 16 + lane / 4;
  const int quad = lane % 4;
  const float* bias = p.bias + static_cast<long long>(b) * p.L1;
  const long long stat = (static_cast<long long>(b) * p.H + h) * p.Lq;
  float lse[2], dlt[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + r + 8 * hf;
    lse[hf] = row < p.Lq ? __ldg(p.lse + stat + row) : INFINITY;
    dlt[hf] = row < p.Lq ? __ldg(p.delta + stat + row) : 0.f;
  }

  float dq[G::CHUNKS][G::CW / 2];
#pragma unroll
  for (int c = 0; c < G::CHUNKS; ++c)
#pragma unroll
    for (int i = 0; i < G::CW / 2; ++i) dq[c][i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const bool second = t >= n1;
    const int key0 = (second ? t - n1 : t) * ROWS;  // within its segment
    const int len = second ? p.L2 : p.L1;
    const int pos0 = (second ? p.L1 : 0) + key0;    // position of its first key
    const uint32_t kt = sk + s * G::BYTES, vt = sv + s * G::BYTES;
    mbar_wait(full + 8 * s, (t / STAGES) & 1);
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < G::CHUNKS; ++c)
#pragma unroll
      for (int kk = 0; kk < G::CW / 16; ++kk)
        wgmma_ss_n64(sc, desc<DH>(sq + c * G::CHUNK_BYTES + kk * 32),
                     desc<DH>(kt + c * G::CHUNK_BYTES + kk * 32), c + kk > 0);
#pragma unroll
    for (int c = 0; c < G::CHUNKS; ++c)
#pragma unroll
      for (int kk = 0; kk < G::CW / 16; ++kk)
        wgmma_ss_n64(dp, desc<DH>(sdo + c * G::CHUNK_BYTES + kk * 32),
                     desc<DH>(vt + c * G::CHUNK_BYTES + kk * 32), c + kk > 0);
    wgmma_commit();
    // this thread's 16 keys' bias (NS keys have none; keys past the segment
    // -inf), read while the products run
    float bv[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int key = key0 + 8 * (i / 2) + 2 * quad + (i % 2);
      bv[i] = key >= len ? -INFINITY : second ? 0.f : __ldg(bias + key);
    }
    // only a tile that crosses the band edge of row0 masks; key 8 (j / 4) +
    // (j % 2) + 2 quad of row r + 8 hf lies above the band when the constant
    // part exceeds lim[hf]
    const bool band = p.causal && pos0 + ROWS - 1 > p.q_offset + row0;
    const int lim[2] = {p.q_offset + row0 + r - pos0 - 2 * quad,
                        p.q_offset + row0 + r + 8 - pos0 - 2 * quad};
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // dS in place of S
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int hf = (j / 2) % 2;
      float pj, ds;
      grad_pair(sc[j], dp[j], bv[2 * (j / 4) + (j % 2)],
                band && 8 * (j / 4) + (j % 2) > lim[hf], lse[hf], dlt[hf], p.sm_scale, pj, ds);
      sc[j] = ds;
    }
    // dS as the A operand of dQ += dS K, k16 step kk: keys 16 kk .. 16 kk + 15
    uint32_t da[ROWS / 16][4];
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) da[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
#pragma unroll
    for (int c = 0; c < G::CHUNKS; ++c) fence_regs(dq[c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk)
#pragma unroll
      for (int c = 0; c < G::CHUNKS; ++c)
        wgmma_rs(dq[c], da[kk], desc<DH>(kt + c * G::CHUNK_BYTES + kk * 16 * G::ROW_BYTES));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < G::CHUNKS; ++c) fence_regs(dq[c]);
    mbar_arrive(empty + 8 * s);
  }

  // dQ through the Q tile (every product that read it has completed in
  // every warp)
  consumer_sync();
#pragma unroll
  for (int c = 0; c < G::CHUNKS; ++c)
#pragma unroll
    for (int i = 0; i < G::CW / 4; ++i) {
      const int hf = i % 2, j = 4 * (i / 2) + 2 * hf;
      const int col = 8 * (i / 2) + 2 * quad;
      *reinterpret_cast<__nv_bfloat162*>(out_tile + c * G::CHUNK_BYTES +
                                         swizzled<DH>(r + 8 * hf, 2 * col)) =
          __floats2bfloat162_rn(dq[c][j], dq[c][j + 1]);
    }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumer_sync();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < G::CHUNKS; ++c)
      tma_store(&m.dq, sq + c * G::CHUNK_BYTES, h * DH + c * G::CW, row0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// --- dkv pass ----------------------------------------------------------------

// One block per (two 64-key tiles, head, batch row): DKV_WARPGROUPS
// warpgroups, one per key tile, sharing one Q/dO ring; one block per SM. A
// block of exactly two warpgroups lets each thread hold up to 255 registers
// (dK and dV alone take 128), so there is no producer warp: thread 0 issues
// the first loads, and the warpgroup that releases a stage last refills it.
// The key tiles are numbered S's first (0 .. ceil(L1 / 64) - 1), then NS's;
// block x takes tiles 2 x and 2 x + 1, and a warpgroup left without one
// exits.
template <int DH>
__global__ void __launch_bounds__(DKV_WARPGROUPS * 128, 1)
band_attn_bwd_dkv_sm90_kernel(const __grid_constant__ BwdMaps m, const BwdParams p) {
  using G = Tile<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t skv = (raw + 1023) & ~1023u;  // per warpgroup: K, V (later dK, dV)
  const uint32_t sq = skv + 2 * DKV_WARPGROUPS * G::BYTES;  // DKV_STAGES Q tiles
  const uint32_t sdo = sq + DKV_STAGES * G::BYTES;          // DKV_STAGES dO tiles
  // per warpgroup and stage: the tile's 64 lse values, then its 64 deltas
  float* const sstat = reinterpret_cast<float*>(smem_raw + (sdo + DKV_STAGES * G::BYTES - raw));
  float* const sstat_end = sstat + DKV_WARPGROUPS * DKV_STAGES * 2 * ROWS;
  const uint32_t bar_kv = smem_u32(sstat_end);
  const uint32_t full = bar_kv + 8;
  // per stage: the warpgroups that have released it since its last load
  uint32_t* const released = reinterpret_cast<uint32_t*>(sstat_end) + 2 * (1 + DKV_STAGES);

  const int n1 = (p.L1 + ROWS - 1) / ROWS;
  const int n_keys = n1 + (p.L2 + ROWS - 1) / ROWS;  // key tiles of both segments
  const int tile0 = DKV_WARPGROUPS * blockIdx.x;
  const int active = min(DKV_WARPGROUPS, n_keys - tile0);
  const int h = blockIdx.y, b = blockIdx.z;

  // key tile `ti`: its segment, its first key within it and its position
  auto key_tile = [&](int ti, bool& second, int& key0, int& pos0) {
    second = ti >= n1;
    key0 = (second ? ti - n1 : ti) * ROWS;
    pos0 = (second ? p.L1 : 0) + key0;
  };
  // under the band, row r sees position j once q_offset + r >= j: the query
  // tiles before the one holding row pos0 - q_offset see none of the keys
  auto first_q = [&](int pos0) { return p.causal ? max(0, pos0 - p.q_offset) / ROWS : 0; };
  bool second;
  int key0, pos0;
  key_tile(tile0, second, key0, pos0);
  const int q_first = first_q(pos0);  // the block's first query tile
  const int n_tiles = max(0, (p.Lq + ROWS - 1) / ROWS - q_first);

  // Q/dO tile t of the block into its stage
  auto load_q = [&](int t) {
    const int s = t % DKV_STAGES, q0 = (q_first + t) * ROWS;
    mbar_expect_tx(full + 8 * s, 2 * G::BYTES);
#pragma unroll
    for (int c = 0; c < G::CHUNKS; ++c) {
      tma_load(sq + s * G::BYTES + c * G::CHUNK_BYTES, &m.q, full + 8 * s, h * DH + c * G::CW,
               q0, b);
      tma_load(sdo + s * G::BYTES + c * G::CHUNK_BYTES, &m.dout, full + 8 * s,
               h * DH + c * G::CW, q0, b);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < DKV_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_kv, 2 * active * G::BYTES);
    for (int w = 0; w < active; ++w) {
      bool sec;
      int k0, ps0;
      key_tile(tile0 + w, sec, k0, ps0);
#pragma unroll
      for (int c = 0; c < G::CHUNKS; ++c) {
        tma_load(skv + 2 * w * G::BYTES + c * G::CHUNK_BYTES, sec ? &m.k2 : &m.k, bar_kv,
                 h * DH + c * G::CW, k0, b);
        tma_load(skv + (2 * w + 1) * G::BYTES + c * G::CHUNK_BYTES, sec ? &m.v2 : &m.v,
                 bar_kv, h * DH + c * G::CW, k0, b);
      }
    }
    for (int t = 0; t < min(DKV_STAGES, n_tiles); ++t) load_q(t);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg >= active) return;
  key_tile(tile0 + wg, second, key0, pos0);
  const int len = second ? p.L2 : p.L1;
  const int own_first = first_q(pos0) - q_first;  // the warpgroup's first seen tile
  const uint32_t sk = skv + 2 * wg * G::BYTES, sv = sk + G::BYTES;
  uint8_t* const dk_tile = smem_raw + (sk - raw);  // generic pointers to sk, sv
  uint8_t* const dv_tile = dk_tile + G::BYTES;
  float* const wstat = sstat + wg * DKV_STAGES * 2 * ROWS;

  // S^T's rows are the warpgroup's keys, its columns a tile's queries; this
  // thread holds keys r and r + 8, fixed over the loop (bias -inf past the
  // segment)
  const int tid = threadIdx.x % 128;
  const int r = (tid / 32) * 16 + (tid % 32) / 4;
  const int quad = tid % 4;
  const long long stat = (static_cast<long long>(b) * p.H + h) * p.Lq;
  float kb[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = key0 + r + 8 * hf;
    kb[hf] = key >= len ? -INFINITY
             : second   ? 0.f
                        : __ldg(p.bias + static_cast<long long>(b) * p.L1 + key);
  }

  float dk[G::CHUNKS][G::CW / 2], dv[G::CHUNKS][G::CW / 2];
#pragma unroll
  for (int c = 0; c < G::CHUNKS; ++c)
#pragma unroll
    for (int i = 0; i < G::CW / 2; ++i) dk[c][i] = dv[c][i] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % DKV_STAGES;
    const bool seen = t >= own_first;  // some row of the tile sees these keys
    const int q0 = (q_first + t) * ROWS;
    // stage the tile's lse (+inf past Lq) and delta, one value a thread; a
    // stage's buffer is rewritten only after every thread of the warpgroup
    // has passed the next tile's sync
    float* const st = wstat + s * 2 * ROWS;
    if (seen) {
      const int row = q0 + tid % ROWS;
      st[tid] = row >= p.Lq ? (tid < ROWS ? INFINITY : 0.f)
                            : __ldg((tid < ROWS ? p.lse : p.delta) + stat + row);
    }
    // the stage's statistics are complete, and every warp of the warpgroup
    // is done with tile t - 1: release its stage, and refill it when the
    // other warpgroups have released it too
    warpgroup_sync(wg);
    if (t > 0 && tid == 0) {
      const int u = t - 1, su = u % DKV_STAGES;
      __threadfence_block();
      if (atomicAdd(released + su, 1u) == static_cast<uint32_t>(active - 1)) {
        released[su] = 0;
        if (u + DKV_STAGES < n_tiles) load_q(u + DKV_STAGES);
      }
    }
    mbar_wait(full + 8 * s, (t / DKV_STAGES) & 1);
    if (!seen) continue;
    const uint32_t qt = sq + s * G::BYTES, dot = sdo + s * G::BYTES;
    // only a tile that crosses the band edge of its first row masks; key r +
    // 8 hf lies above the band of query column c when c < lim[hf]
    const bool band = p.causal && pos0 + ROWS - 1 > p.q_offset + q0;
    const int lim[2] = {pos0 + r - p.q_offset - q0 - 2 * quad,
                        pos0 + r + 8 - p.q_offset - q0 - 2 * quad};
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < G::CHUNKS; ++c)
#pragma unroll
      for (int kk = 0; kk < G::CW / 16; ++kk)
        wgmma_ss_n64(sc, desc<DH>(sk + c * G::CHUNK_BYTES + kk * 32),
                     desc<DH>(qt + c * G::CHUNK_BYTES + kk * 32), c + kk > 0);
#pragma unroll
    for (int c = 0; c < G::CHUNKS; ++c)
#pragma unroll
      for (int kk = 0; kk < G::CW / 16; ++kk)
        wgmma_ss_n64(dp, desc<DH>(sv + c * G::CHUNK_BYTES + kk * 32),
                     desc<DH>(dot + c * G::CHUNK_BYTES + kk * 32), c + kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // P^T in place of S^T, dS^T in place of dP^T
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int hf = (j / 2) % 2;
      const int col = 8 * (j / 4) + (j % 2);  // + 2 quad
      float pj, ds;
      grad_pair(sc[j], dp[j], kb[hf], band && col < lim[hf], st[col + 2 * quad],
                st[ROWS + col + 2 * quad], p.sm_scale, pj, ds);
      sc[j] = pj;
      dp[j] = ds;
    }
    // P^T and dS^T as A operands, k16 step kk: queries 16 kk .. 16 kk + 15
    uint32_t pa[ROWS / 16][4], da[ROWS / 16][4];
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
        da[kk][i] = pack_bf16(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1]);
      }
#pragma unroll
    for (int c = 0; c < G::CHUNKS; ++c) {
      fence_regs(dv[c]);
      fence_regs(dk[c]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk)
#pragma unroll
      for (int c = 0; c < G::CHUNKS; ++c)
        wgmma_rs(dv[c], pa[kk], desc<DH>(dot + c * G::CHUNK_BYTES + kk * 16 * G::ROW_BYTES));
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk)
#pragma unroll
      for (int c = 0; c < G::CHUNKS; ++c)
        wgmma_rs(dk[c], da[kk], desc<DH>(qt + c * G::CHUNK_BYTES + kk * 16 * G::ROW_BYTES));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < G::CHUNKS; ++c) {
      fence_regs(dv[c]);
      fence_regs(dk[c]);
    }
  }

  // dK and dV through the warpgroup's K and V tiles (every product that
  // read them has completed in each of its warps)
  warpgroup_sync(wg);
#pragma unroll
  for (int c = 0; c < G::CHUNKS; ++c)
#pragma unroll
    for (int i = 0; i < G::CW / 4; ++i) {
      const int hf = i % 2, j = 4 * (i / 2) + 2 * hf;
      const uint32_t off =
          c * G::CHUNK_BYTES + swizzled<DH>(r + 8 * hf, 2 * (8 * (i / 2) + 2 * quad));
      *reinterpret_cast<__nv_bfloat162*>(dk_tile + off) =
          __floats2bfloat162_rn(dk[c][j], dk[c][j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv_tile + off) =
          __floats2bfloat162_rn(dv[c][j], dv[c][j + 1]);
    }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  warpgroup_sync(wg);
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < G::CHUNKS; ++c) {
      tma_store(second ? &m.dk2 : &m.dk, sk + c * G::CHUNK_BYTES, h * DH + c * G::CW, key0, b);
      tma_store(second ? &m.dv2 : &m.dv, sv + c * G::CHUNK_BYTES, h * DH + c * G::CW, key0, b);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// --- host side ---------------------------------------------------------------

template <int DH>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* k2,
                       const void* v2, const void* dout, void* dq, void* dk, void* dv, void* dk2,
                       void* dv2, const BwdParams& p, int B, int passes, cudaStream_t stream) {
  BwdMaps m{};
  const int w = p.H * DH;
  const bool seg = p.L2 > 0;
  // both passes read Q, dO, K and V; each writes its own outputs
  if (!encode<DH>(&m.q, q, w, p.Lq, B) || !encode<DH>(&m.dout, dout, w, p.Lq, B) ||
      !encode<DH>(&m.k, k, w, p.L1, B) || !encode<DH>(&m.v, v, w, p.L1, B) ||
      (seg && (!encode<DH>(&m.k2, k2, w, p.L2, B) || !encode<DH>(&m.v2, v2, w, p.L2, B))))
    return cudaErrorInvalidValue;
  if ((passes & DQ) && !encode<DH>(&m.dq, dq, w, p.Lq, B)) return cudaErrorInvalidValue;
  if ((passes & DKV) &&
      (!encode<DH>(&m.dk, dk, w, p.L1, B) || !encode<DH>(&m.dv, dv, w, p.L1, B) ||
       (seg && (!encode<DH>(&m.dk2, dk2, w, p.L2, B) || !encode<DH>(&m.dv2, dv2, w, p.L2, B)))))
    return cudaErrorInvalidValue;
  cudaError_t e;
  if (passes & DQ) {
    constexpr int smem = dq_smem_bytes<DH>();
    e = cudaFuncSetAttribute(band_attn_bwd_dq_sm90_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((p.Lq + ROWS - 1) / ROWS, p.H, B);
    band_attn_bwd_dq_sm90_kernel<DH><<<grid, 128 + 32, smem, stream>>>(m, p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (passes & DKV) {
    constexpr int smem = dkv_smem_bytes<DH>();
    e = cudaFuncSetAttribute(band_attn_bwd_dkv_sm90_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    const int key_tiles = (p.L1 + ROWS - 1) / ROWS + (p.L2 + ROWS - 1) / ROWS;
    const dim3 grid((key_tiles + DKV_WARPGROUPS - 1) / DKV_WARPGROUPS, p.H, B);
    band_attn_bwd_dkv_sm90_kernel<DH><<<grid, DKV_WARPGROUPS * 128, smem, stream>>>(m, p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// The bf16 backward over q/dO/dq [B, Lq, H*Dh], the first key segment
// k/v/dk/dv [B, L1, H*Dh] with its bias [B, L1], the second k2/v2/dk2/dv2
// [B, L2, H*Dh] (null when L2 = 0), lse and delta [B, H, Lq] (every bf16
// tensor 16-byte aligned), at every head width of BAND_ATTN_FOR_EACH_DH.
// `passes` (DQ, DKV or both) names the passes to run; the outputs of a pass
// that does not run may be null. Returns the first launch's CUDA error, or
// cudaErrorInvalidValue for a shape or width it does not take or a tensor
// map that does not encode.
inline int bwd_bf16(const void* q, const void* k, const void* v, const void* k2, const void* v2,
                    const float* bias, const void* dout, const float* lse, const float* delta,
                    void* dq, void* dk, void* dv, void* dk2, void* dv2, int B, int H, int Lq,
                    int L1, int L2, int dh, int q_offset, int causal, float sm_scale, int passes,
                    void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || L1 <= 0 || L2 < 0 || B > 65535 || H > 65535 ||
      passes <= 0 || (passes & ~(DQ | DKV)))
    return (int)cudaErrorInvalidValue;
  const BwdParams p{bias, lse, delta, H, Lq, L1, L2, q_offset, causal, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BAND_ATTN_SM90_CASE(D) \
  case D:                      \
    return (int)launch_bwd<D>(q, k, v, k2, v2, dout, dq, dk, dv, dk2, dv2, p, B, passes, s);
  switch (dh) {
    BAND_ATTN_FOR_EACH_DH(BAND_ATTN_SM90_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef BAND_ATTN_SM90_CASE
}

}  // namespace sm90
}  // namespace band_attn
