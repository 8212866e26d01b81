// Band-masked attention forward on Hopper's tensor cores, bf16 (sm_90a).
//
// Serves the bfloat16 calls of two entry points of band_attention.cu:
//
//   band_attn_blocked_fwd  replaces _fwd_kernel      :59  (B2f, [BH, L, Dh])
//   band_attn_mh_fwd       replaces _fmh_fwd_kernel  :620 (B3f, [B, L, H*Dh])
//
// of recommend_tpu/ops/pallas/flash_attention.py. It computes what they do
// (band_attention.cu's note): s = (q . k) * sm_scale + bias[j], + -1e9 above
// the band, max and sum in float32, p rounded to bf16 before PV while l sums
// the unrounded p, out = acc / max(l, 1e-30) in bf16, lse = m + log(max(l,
// 1e-30)) in float32; a key at or past the end of the keys is excluded.
//
// What bounds it on the H100: B2f at its main-path shape (256 x 1, 607 x
// 1214 rows, Dh 128) does 4 * Dh flops per in-band (row, key) pair, 72.5
// GFLOP, against 241 MB moved: bound by operations, barely (0.073 ms at 989
// TF/s; the bytes take 0.072 ms at 3.35 TB/s). B3f at the S-trunk
// gradient's shape (512 x 2 heads, 169 x 350 rows) moves 273 MB for 23.6
// GFLOP: bound by bytes (0.082 ms).
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
// - one consumer warpgroup owns the block's 64 query rows (64 rows beat 128
//   rows shared by two warpgroups at both entry points' heaviest shapes on
//   the H100); key tiles wholly above the band edge of the block's last
//   real row are skipped, and only tiles that cross the band edge or
//   the key end compute the mask, the others add bias[j] only;
// - the online softmax is kept in float32 registers, row max and sum by
//   quad shuffles within the accumulator layout, exp2 of (s - m) * log2(e);
// - the epilogue writes out through the Q tile's shared memory and a TMA
//   store on the same map, which clips rows past Lq; lse [B, H, Lq] directly.
// Not yet: warp specialisation with setmaxnreg, overlapping the softmax of
// one tile with the products of the next, a persistent grid, split-KV.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "band_attention_common.cuh"

namespace band_attn {
namespace sm90 {

constexpr int ROWS = 64;   // query rows per consumer warpgroup: one wgmma M
constexpr int KEYS = 64;   // keys per K/V tile
constexpr int STAGES = 2;  // depth of the K/V ring
constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory geometry of a 64-row tile of one head of width DH: CHUNKS
// boxes of 64 rows x CW columns, each swizzled over its CW * 2-byte rows.
template <int DH>
struct Tile {
  static_assert(DH % 16 == 0, "Dh must be a multiple of 16");
  static constexpr int CW = DH % 64 == 0 ? 64 : DH % 32 == 0 ? 32 : 16;
  static constexpr int CHUNKS = DH / CW;
  static constexpr int ROW_BYTES = CW * 2;
  static constexpr int CHUNK_BYTES = ROWS * ROW_BYTES;
  static constexpr int BYTES = CHUNKS * CHUNK_BYTES;
  static constexpr int GROUP_BYTES = 8 * ROW_BYTES;  // 8 rows: one swizzle period
  // wgmma descriptor layout code: 1 = 128-byte swizzle, 2 = 64, 3 = 32
  static constexpr uint64_t LAYOUT = CW == 64 ? 1 : CW == 32 ? 2 : 3;
  static constexpr CUtensorMapSwizzle SWIZZLE =
      CW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
               : CW == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
};

template <int DH>
constexpr int smem_bytes() {
  // 1024 for aligning the tiles to the swizzle pattern, then the Q tile,
  // the K and V rings and the mbarriers (Q, then full K, full V, empty)
  return 1024 + (1 + 2 * STAGES) * Tile<DH>::BYTES + 8 * (1 + 3 * STAGES);
}

struct Params {
  const float* bias;  // [B, Lkv] float32, one row per blockIdx.z (B2f: per head)
  float* lse;         // [B, H, Lq] float32
  int H, Lq, Lkv, q_offset, causal;
  float sm_scale;
};

// --- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity) : "memory");
}

// one box of a 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses to accumulator registers across
// the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor of a swizzled tile chunk at `addr`. Both
// byte offsets are the 8-row group stride: for K-major operands the leading
// one is unused, and the MN-major V operand of one wgmma spans one swizzle
// atom in N (its chunk), so only the 8-row stride along K is read.
template <int DH>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  constexpr uint64_t stride = Tile<DH>::GROUP_BYTES >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (stride << 16) | (stride << 32) |
         (Tile<DH>::LAYOUT << 62);
}

// byte offset of (row, byte) within a chunk as TMA's swizzle lays it out:
// the 16-byte unit index is XORed with the row within the swizzle period
template <int DH>
__device__ __forceinline__ uint32_t swizzled(int row, int byte) {
  constexpr uint32_t mask = (Tile<DH>::ROW_BYTES / 16 - 1) << 4;
  const uint32_t off = row * Tile<DH>::ROW_BYTES + byte;
  return off ^ ((off >> 3) & mask);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S = Q K^T: m64n64k16, A and B K-major in shared memory; accumulate = 0
// overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O += P V: m64nNk16 with N the chunk width, A (P) from registers, B (V)
// MN-major in shared memory (imm-trans-b = 1)
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// --- the kernel ------------------------------------------------------------

// One block per (64 query rows, head, batch row): one consumer warpgroup,
// then one producer warp.
template <int DH>
__global__ void __launch_bounds__(128 + 32, 2)
band_attn_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
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

  // the key tiles the block's rows need: up to the band edge of its last row
  const int last_row = min(row0 + ROWS, p.Lq) - 1;
  const int key_end = p.causal ? max(0, min(p.Lkv, p.q_offset + last_row + 1)) : p.Lkv;
  const int n_tiles = (key_end + KEYS - 1) / KEYS;

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
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(empty + 8 * s, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(full_k + 8 * s, G::BYTES);
#pragma unroll
        for (int c = 0; c < G::CHUNKS; ++c)
          tma_load(sk + s * G::BYTES + c * G::CHUNK_BYTES, &tk, full_k + 8 * s,
                   h * DH + c * G::CW, t * KEYS, b);
        mbar_expect_tx(full_v + 8 * s, G::BYTES);
#pragma unroll
        for (int c = 0; c < G::CHUNKS; ++c)
          tma_load(sv + s * G::BYTES + c * G::CHUNK_BYTES, &tv, full_v + 8 * s,
                   h * DH + c * G::CW, t * KEYS, b);
      }
    }
    return;
  }

  // the consumer warpgroup: rows row0 .. row0 + 63; this thread holds rows
  // r and r + 8 of them, columns 8 j + 2 quad + {0, 1} of each 8-column group
  const int r = warp * 16 + lane / 4;
  const int quad = lane % 4;
  const float* bias = p.bias + static_cast<long long>(b) * p.Lkv;

  float o[G::CHUNKS][G::CW / 2];
#pragma unroll
  for (int c = 0; c < G::CHUNKS; ++c)
#pragma unroll
    for (int i = 0; i < G::CW / 2; ++i) o[c][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const uint32_t parity = (t / STAGES) & 1;
    const int k0 = t * KEYS;
    mbar_wait(full_k + 8 * s, parity);
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < G::CHUNKS; ++c)
#pragma unroll
      for (int kk = 0; kk < G::CW / 16; ++kk)
        wgmma_ss_n64(sc, desc<DH>(sq + c * G::CHUNK_BYTES + kk * 32),
                     desc<DH>(sk + s * G::BYTES + c * G::CHUNK_BYTES + kk * 32), c + kk > 0);
    wgmma_commit();
    // this thread's 16 keys' bias, read while the product runs
    float bv[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int key = k0 + 8 * (i / 2) + 2 * quad + (i % 2);
      bv[i] = key < p.Lkv ? __ldg(bias + key) : 0.f;
    }
    wgmma_wait_all();
    fence_regs(sc);

    // only a tile that crosses the band edge of row0 or the key end masks
    const bool edge = k0 + KEYS > p.Lkv || (p.causal && k0 + KEYS - 1 > p.q_offset + row0);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int qpos = p.q_offset + row0 + r + 8 * hf;
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int j = 4 * (i / 2) + 2 * hf + (i % 2);
        float x = fmaf(sc[j], p.sm_scale, bv[i]);
        if (edge) {
          const int key = k0 + 8 * (i / 2) + 2 * quad + (i % 2);
          if (key >= p.Lkv) x = -INFINITY;  // past the keys: excluded, p = 0
          else if (p.causal && key > qpos) x += NEG_INF;
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
    mbar_wait(full_v + 8 * s, parity);
#pragma unroll
    for (int c = 0; c < G::CHUNKS; ++c) fence_regs(o[c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk)
#pragma unroll
      for (int c = 0; c < G::CHUNKS; ++c)
        wgmma_rs(o[c], pa[kk],
                 desc<DH>(sv + s * G::BYTES + c * G::CHUNK_BYTES + kk * 16 * G::ROW_BYTES));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < G::CHUNKS; ++c) fence_regs(o[c]);
    mbar_arrive(empty + 8 * s);
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

// --- host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda; null if the driver does not provide it
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// a 3-D map over bf16 [batch, rows, width] with 64-row x CW-column boxes
template <int DH>
bool encode(CUtensorMap* map, const void* base, int width, int rows, int batch) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 2, (cuuint64_t)width * 2 * rows};
  const cuuint32_t box[3] = {(cuuint32_t)Tile<DH>::CW, (cuuint32_t)ROWS, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
            box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, Tile<DH>::SWIZZLE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, const Params& p, int B,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  const int width = p.H * DH;
  if (!encode<DH>(&tq, q, width, p.Lq, B) || !encode<DH>(&tk, k, width, p.Lkv, B) ||
      !encode<DH>(&tv, v, width, p.Lkv, B) || !encode<DH>(&to, out, width, p.Lq, B))
    return cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<DH>();
  const cudaError_t e = cudaFuncSetAttribute(band_attn_fwd_sm90_kernel<DH>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Lq + ROWS - 1) / ROWS, p.H, B);
  band_attn_fwd_sm90_kernel<DH><<<grid, 128 + 32, smem, stream>>>(tq, tk, tv, to, p);
  return cudaGetLastError();
}

// The bf16 forward over q/out [B, Lq, H*Dh] and k/v [B, Lkv, H*Dh] (16-byte
// aligned), bias [B, Lkv], lse [B, H, Lq]. Returns the launch's CUDA error,
// or cudaErrorInvalidValue for a shape it does not take or a tensor map
// that does not encode.
inline int fwd_bf16(const void* q, const void* k, const void* v, const float* bias, void* out,
             float* lse, int B, int H, int Lq, int Lkv, int dh, int q_offset, int causal,
             float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lkv <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{bias, lse, H, Lq, Lkv, q_offset, causal, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BAND_ATTN_SM90_CASE(D) \
  case D: return (int)launch<D>(q, k, v, out, p, B, s);
  switch (dh) {
    BAND_ATTN_FOR_EACH_DH(BAND_ATTN_SM90_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef BAND_ATTN_SM90_CASE
}

}  // namespace sm90
}  // namespace band_attn
