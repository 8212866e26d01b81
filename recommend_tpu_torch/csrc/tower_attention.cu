// The retrieval tower's attention, forward and backward, for Hopper (sm_90a).
//
// Two entry points, behind ops/attention.py's autograd Function:
//
//   tower_attn_fwd  O = softmax(Q Kᵀ · scale + S + K_b) V, and each row's max
//                   and sum of exp(x - max)                                      (T1f)
//   tower_attn_bwd  dQ, dK, dV from dO and the saved (max, sum)                  (T1b)
//
// where S [Lq, Lkv] is the mask's structure, shared by every example and head
// (the interleaved causal mask, the single-prediction mask; none for the group
// encoders), and K_b [B, Lkv] its key part (the padding bias). Both hold 0 and
// NEG_INF (-1e9) alone; each logit gets (S[i][j] + K_b[b][j]) added after the
// scale, in that order, as the plain path adds the summed bias.
//
// It replaces no TPU kernel. The JAX package's tower attention is plain jnp
// (recommend_tpu/ops/attention.py), which XLA fuses on the TPU. Eager PyTorch
// runs it as float32 passes over [B, H, L, L]: logits, scale, bias, softmax,
// two casts of the probabilities, and autograd keeps two float32 copies of
// them. At the KuaiFormer cell's shape (1,024 × 8 heads, 275 tokens) that is
// 2.48 GB a pass a layer and two thirds of the training step.
//
// What bounds it on this card: bytes. At Dh 16 a (query, key) pair costs 4·16
// flops forward and 8·16 backward, far below the ridge; the least traffic is
// Q, K, V read and O written (forward), Q, K, V, dO read and dQ, dK, dV
// written (backward), in bf16, at 3.35 TB/s.
//
// How the design meets it: nothing of size L² leaves the chip.
//   - A block takes one (example, head). It reads that head's rows of Q, K, V
//     (and dO) straight from the [B, L, H·Dh] layout the projections write,
//     16 bytes a thread, into shared memory (≤ 512 rows; 8.8 KB a tensor at
//     L 275, Dh 16), with an XOR swizzle of the 16-byte chunks so that
//     ldmatrix reads them without bank conflicts. No layout copy.
//   - bf16 runs on the tensor cores: mma.sync m16n8k16 (bf16 in, float32
//     accumulation), a warp a 16-row tile. The logits stay in registers, and
//     their accumulator fragments are the A operand of the next product.
//   - The (query tile, key tile) pairs whose structure bias is NEG_INF
//     everywhere are skipped (a tile map the wrapper derives from S: 0
//     skipped, 1 zero everywhere so S is not read, 2 read S). Under the
//     interleaved mask about a third of the 16 × 16 tiles are visited.
//   - A row whose largest logit over the visited tiles stays ≤ -5e8 has no
//     allowed key; the plain path gives it the softmax over every key at the
//     -1e9 level. Its tile is then run over every key tile, which gives it
//     the same answer and leaves the other rows' bits as they were (a
//     skipped tile only adds exact zeros). The backward finds such tiles
//     from the saved max (≤ -5e8) and visits every key tile for them too.
//   - The forward saves each row's max and sum, not their log-sum-exp: at a
//     max of -1e9, -1e9 + log(sum) rounds back to -1e9 in float32, and such
//     a row's probabilities could not be rebuilt from it. The backward forms
//     p = exp(x - max) / sum exactly as the forward did.
//
// Rounding follows the plain path (ops/attention.dot_product_attention and
// autograd's backward of it) step for step, so the two differ only in the
// order of float32 sums:
//   - the forward runs two passes over the visited key tiles, both in shared
//     memory: the first takes each row's max and sum, the second forms
//     p = exp(x - max) / sum in float32, rounds it to bf16 (the plain path's
//     probs.to(v.dtype)) and multiplies it with V. An online softmax would
//     round the unnormalised p instead.
//   - the backward rounds dP = dO Vᵀ to bf16 as autograd's cast backward does,
//     takes D = Σ_j P_j dP_j (the softmax backward's sum, not rowsum(dO ∘ O)),
//     and feeds dS · scale to the tensor cores as two bf16 terms (hi and lo,
//     ~16 bits) so dQ and dK keep the float32 dS of the plain path.
//   - dQ, dK and dV are summed in registers, each in one block, in a fixed
//     order: no atomics, and a call repeats bit for bit.
//
// float32 inputs run on the CUDA cores with float32 products (no TF32): a
// thread a query row (a key row in the backward's second phase), K and V (Q
// and dO) in shared memory. Head widths 16 and 32; 1 ≤ Lq, Lkv ≤ 512.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns the launch's cudaGetLastError(). dtype: 0 float32, 1 bfloat16; any
// other code, width or length returns cudaErrorInvalidValue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 16;               // rows of a query tile and keys of a key tile
constexpr int kMaxWarps = 4;            // warps a block
constexpr int kMaxLen = 512;            // the longest Lq and Lkv
constexpr float kPadKey = -3.0e38f;     // a key column past Lkv: exp() of it is 0
constexpr float kNoKey = -5.0e8f;       // NEG_INF / 2: a row at or below has no allowed key
constexpr int kMaxSmem = 232448;        // a block's shared memory on the H100

struct Args {
  const void* q;         // [B, Lq, H·Dh]
  const void* k;         // [B, Lkv, H·Dh]
  const void* v;         // [B, Lkv, H·Dh]
  const void* dout;      // [B, Lq, H·Dh] (backward)
  const float* sbias;    // [Lq, Lkv] or null (zero)
  const float* kbias;    // [B, Lkv] or null (zero)
  const int8_t* tiles;   // [nqt, nkt] tile classes, or null (every tile 1)
  const float* stats_in; // [B, H, Lq, 2] (backward)
  void* o;               // [B, Lq, H·Dh] (forward)
  float* stats;          // [B, H, Lq, 2]: each row's max and sum (forward), or null
  void* dq;
  void* dk;
  void* dv;
  int heads, lq, lkv, nqt, nkt;
  float scale;
};

// ---------------------------------------------------------------------------
// Shared pieces
// ---------------------------------------------------------------------------

// 16-byte chunk c of row r of a [rows][DH] bf16 array in shared memory,
// XOR-swizzled so that the 8 rows an ldmatrix reads fall on distinct banks
template <int DH>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int C = DH / 8;             // chunks a row: 2 or 4
  constexpr int S = C == 2 ? 2 : 1;     // rows a 128-byte line holds: 4 or 2
  return r * DH + 8 * (c ^ ((r >> S) & (C - 1)));
}

// rows [0, rows_pad) of one head from global (row stride `stride` elements),
// zero past `rows`
template <int DH>
__device__ void load_bf16(bf16* s, const bf16* g, int rows, int rows_pad, int stride) {
  constexpr int C = DH / 8;
  for (int id = threadIdx.x; id < rows_pad * C; id += blockDim.x) {
    const int r = id / C, c = id % C;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) val = *reinterpret_cast<const uint4*>(g + (size_t)r * stride + 8 * c);
    *reinterpret_cast<uint4*>(s + swz<DH>(r, c)) = val;
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// the address lane l gives ldmatrix.x4 for the matrices (rows r0..+7, chunk
// c0), (rows r0+8..+15, c0), (r0..+7, c0+1), (r0+8..+15, c0+1): a 16 × 16 A
// operand, or two 8-column B operands read transposed (P·V's V, dS·K's K)
template <int DH>
__device__ __forceinline__ const bf16* at_rows_first(const bf16* s, int r0, int c0, int l) {
  return s + swz<DH>(r0 + (l & 7) + ((l >> 3) & 1) * 8, c0 + (l >> 4));
}

// ... for (r0..+7, c0), (r0..+7, c0+1), (r0+8..+15, c0), (r0+8..+15, c0+1):
// two 8-column B operands read as stored (Q·Kᵀ's K)
template <int DH>
__device__ __forceinline__ const bf16* at_chunks_first(const bf16* s, int r0, int c0, int l) {
  return s + swz<DH>(r0 + (l & 7) + (l >> 4) * 8, c0 + ((l >> 3) & 1));
}

// c += a · b, m16n8k16, bf16 in, float32 accumulation
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the A operand of a 16 × 16 tile held as two m16n8 accumulators
// (t[j][e]: row g + 8·(e/2), column 8j + 2·(lane%4) + e%2)
__device__ __forceinline__ void to_a(uint32_t* a, const float (&t)[2][4]) {
  a[0] = pack(t[0][0], t[0][1]);
  a[1] = pack(t[0][2], t[0][3]);
  a[2] = pack(t[1][0], t[1][1]);
  a[3] = pack(t[1][2], t[1][3]);
}

// s = A · Bᵀ over Dh for a 16-row A (fragments a) and the 16 rows of B from
// row n0 of shared memory: Q·Kᵀ, dO·Vᵀ, and transposed, K·Qᵀ and V·dOᵀ
template <int DH>
__device__ __forceinline__ void rows_dot(float (&s)[2][4], const uint32_t (&a)[DH / 16][4],
                                         const bf16* sb, int n0, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    uint32_t b[4];
    ldsm_x4(b, at_chunks_first<DH>(sb, n0, 2 * ks, lane));
    mma(s[0], a[ks], b[0], b[1]);
    mma(s[1], a[ks], b[2], b[3]);
  }
}

// acc[DH/8] += A (16 × 16, fragments a) · rows k0..k0+15 of shared memory
template <int DH>
__device__ __forceinline__ void acc_rows(float (&acc)[DH / 8][4], const uint32_t* a,
                                         const bf16* sb, int k0, int lane) {
#pragma unroll
  for (int c = 0; c < DH / 16; ++c) {
    uint32_t b[4];
    ldsm_x4_t(b, at_rows_first<DH>(sb, k0, 2 * c, lane));
    mma(acc[2 * c], a, b[0], b[1]);
    mma(acc[2 * c + 1], a, b[2], b[3]);
  }
}

template <int DH>
__device__ __forceinline__ void load_a(uint32_t (&a)[DH / 16][4], const bf16* sb, int r0,
                                       int lane) {
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) ldsm_x4(a[ks], at_rows_first<DH>(sb, r0, 2 * ks, lane));
}

// the logit s·scale + (S[i][j] + K_b[j]), rounded as the plain path rounds it
__device__ __forceinline__ float logit(float s, float scale, float sb, float kb) {
  return __fadd_rn(__fmul_rn(s, scale), __fadd_rn(sb, kb));
}

// S[i][j] of a tile of class cls (1: zero; 2: read), 0 outside [Lq, Lkv]
__device__ __forceinline__ float struct_at(const Args& a, int cls, int i, int j) {
  return (cls == 2 && i < a.lq && j < a.lkv) ? a.sbias[(size_t)i * a.lkv + j] : 0.f;
}

// the class of tile (qt, kt) for a walk: -1 skip; a skipped tile is read
// whole (class 2) where the query tile has a row with no allowed key
__device__ __forceinline__ int tile_class(const int8_t* map, int nkt, int qt, int kt,
                                          bool full) {
  const int cls = map == nullptr ? 1 : map[qt * nkt + kt];
  return cls != 0 ? cls : (full ? 2 : -1);
}

// the bytes a bf16 block's shared memory holds, after the bf16 arrays
__host__ __device__ inline size_t smem_tail(int nqt, int nkt) {
  return 16 * (size_t)nkt * 4 + 16 * (size_t)nqt * 4 * 3 + (size_t)nqt * nkt + nqt;
}

// ---------------------------------------------------------------------------
// bf16 forward (tensor cores)
// ---------------------------------------------------------------------------

// logits x[j][e] of tile (rows r0.., keys n0..) from s, in place
__device__ __forceinline__ void tile_logits(float (&x)[2][4], const Args& a, int cls, int r0,
                                            int n0, const float* kb, int g, int t) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + g + 8 * (e >> 1), c = n0 + 8 * j + 2 * t + (e & 1);
      x[j][e] = logit(x[j][e], a.scale, struct_at(a, cls, i, c), kb[c]);
    }
}

// each of the thread's two rows' max and sum of exp(x - max) over the walked
// key tiles, reduced over the four lanes of the row
template <int DH>
__device__ void row_stats(float (&m)[2], float (&l)[2], const Args& a,
                          const uint32_t (&qa)[DH / 16][4], const bf16* Ks, const float* kb,
                          const int8_t* map, int qt, bool full, int lane) {
  const int g = lane >> 2, t = lane & 3;
  m[0] = m[1] = kPadKey;
  l[0] = l[1] = 0.f;
  for (int kt = 0; kt < a.nkt; ++kt) {
    const int cls = tile_class(map, a.nkt, qt, kt, full);
    if (cls < 0) continue;
    float x[2][4];
    rows_dot<DH>(x, qa, Ks, kt * kTile, lane);
    tile_logits(x, a, cls, qt * kTile, kt * kTile, kb, g, t);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float tm = fmaxf(fmaxf(x[0][2 * r], x[0][2 * r + 1]),
                             fmaxf(x[1][2 * r], x[1][2 * r + 1]));
      const float mn = fmaxf(m[r], tm);
      l[r] = l[r] * __expf(m[r] - mn) + __expf(x[0][2 * r] - mn) + __expf(x[0][2 * r + 1] - mn)
             + __expf(x[1][2 * r] - mn) + __expf(x[1][2 * r + 1] - mn);
      m[r] = mn;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mn = fmaxf(m[r], mo);
      l[r] = l[r] * __expf(m[r] - mn) + lo * __expf(mo - mn);
      m[r] = mn;
    }
}

template <int DH>
__global__ void __launch_bounds__(kMaxWarps * 32) fwd_bf16_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int lqp = a.nqt * kTile, lkp = a.nkt * kTile, stride = a.heads * DH;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + lqp * DH;
  bf16* Vs = Ks + lkp * DH;
  float* kb = reinterpret_cast<float*>(Vs + lkp * DH);
  int8_t* map = a.tiles ? reinterpret_cast<int8_t*>(kb + lkp) : nullptr;

  const size_t qoff = ((size_t)b * a.lq * a.heads + h) * DH;
  const size_t koff = ((size_t)b * a.lkv * a.heads + h) * DH;
  load_bf16<DH>(Qs, static_cast<const bf16*>(a.q) + qoff, a.lq, lqp, stride);
  load_bf16<DH>(Ks, static_cast<const bf16*>(a.k) + koff, a.lkv, lkp, stride);
  load_bf16<DH>(Vs, static_cast<const bf16*>(a.v) + koff, a.lkv, lkp, stride);
  for (int j = threadIdx.x; j < lkp; j += blockDim.x)
    kb[j] = j < a.lkv ? (a.kbias ? a.kbias[(size_t)b * a.lkv + j] : 0.f) : kPadKey;
  if (map)
    for (int id = threadIdx.x; id < a.nqt * a.nkt; id += blockDim.x) map[id] = a.tiles[id];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  bf16* out = static_cast<bf16*>(a.o) + qoff;
  for (int qt = warp; qt < a.nqt; qt += nw) {
    const int r0 = qt * kTile;
    uint32_t qa[DH / 16][4];
    load_a<DH>(qa, Qs, r0, lane);
    float m[2], l[2];
    row_stats<DH>(m, l, a, qa, Ks, kb, map, qt, false, lane);
    const bool none = (r0 + g < a.lq && m[0] <= kNoKey) || (r0 + g + 8 < a.lq && m[1] <= kNoKey);
    const bool full = map != nullptr && __any_sync(0xffffffffu, none);
    if (full) row_stats<DH>(m, l, a, qa, Ks, kb, map, qt, true, lane);
    const float inv[2] = {1.f / l[0], 1.f / l[1]};

    float acc[DH / 8][4];
#pragma unroll
    for (int c = 0; c < DH / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
    for (int kt = 0; kt < a.nkt; ++kt) {
      const int cls = tile_class(map, a.nkt, qt, kt, full);
      if (cls < 0) continue;
      float p[2][4];
      rows_dot<DH>(p, qa, Ks, kt * kTile, lane);
      tile_logits(p, a, cls, r0, kt * kTile, kb, g, t);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[j][e] = __expf(p[j][e] - m[e >> 1]) * inv[e >> 1];
      uint32_t pa[4];
      to_a(pa, p);
      acc_rows<DH>(acc, pa, Vs, kt * kTile, lane);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r0 + g + 8 * r;
      if (i >= a.lq) continue;
#pragma unroll
      for (int c = 0; c < DH / 8; ++c)
        *reinterpret_cast<uint32_t*>(out + (size_t)i * stride + 8 * c + 2 * t) =
            pack(acc[c][2 * r], acc[c][2 * r + 1]);
      if (a.stats != nullptr && t == 0)
        reinterpret_cast<float2*>(a.stats)[((size_t)b * a.heads + h) * a.lq + i] =
            make_float2(m[r], l[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 backward (tensor cores)
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(kMaxWarps * 32) bwd_bf16_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int lqp = a.nqt * kTile, lkp = a.nkt * kTile, stride = a.heads * DH;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + lqp * DH;
  bf16* Ks = dOs + lqp * DH;
  bf16* Vs = Ks + lkp * DH;
  float* kb = reinterpret_cast<float*>(Vs + lkp * DH);
  float* mx = kb + lkp;  // each row's max
  float* il = mx + lqp;  // and 1 / its sum
  float* D = il + lqp;
  int8_t* map_s = reinterpret_cast<int8_t*>(D + lqp);
  int8_t* full_s = map_s + a.nqt * a.nkt;
  const int8_t* map = a.tiles ? map_s : nullptr;

  const size_t qoff = ((size_t)b * a.lq * a.heads + h) * DH;
  const size_t koff = ((size_t)b * a.lkv * a.heads + h) * DH;
  const float2* st = reinterpret_cast<const float2*>(a.stats_in) + ((size_t)b * a.heads + h) * a.lq;
  load_bf16<DH>(Qs, static_cast<const bf16*>(a.q) + qoff, a.lq, lqp, stride);
  load_bf16<DH>(dOs, static_cast<const bf16*>(a.dout) + qoff, a.lq, lqp, stride);
  load_bf16<DH>(Ks, static_cast<const bf16*>(a.k) + koff, a.lkv, lkp, stride);
  load_bf16<DH>(Vs, static_cast<const bf16*>(a.v) + koff, a.lkv, lkp, stride);
  for (int j = threadIdx.x; j < lkp; j += blockDim.x)
    kb[j] = j < a.lkv ? (a.kbias ? a.kbias[(size_t)b * a.lkv + j] : 0.f) : kPadKey;
  for (int i = threadIdx.x; i < lqp; i += blockDim.x) {
    const float2 ml = i < a.lq ? st[i] : make_float2(__int_as_float(0x7f800000), 0.f);
    mx[i] = ml.x;  // past Lq, +inf and 0: p = 0
    il[i] = i < a.lq ? 1.f / ml.y : 0.f;
    D[i] = 0.f;
  }
  if (map)
    for (int id = threadIdx.x; id < a.nqt * a.nkt; id += blockDim.x) map_s[id] = a.tiles[id];
  __syncthreads();
  for (int qt = threadIdx.x; qt < a.nqt; qt += blockDim.x) {
    bool none = false;
    for (int i = qt * kTile; i < min(qt * kTile + kTile, a.lq); ++i) none |= mx[i] <= kNoKey;
    full_s[qt] = map != nullptr && none;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  // phase 1, a query tile a warp: D, then dQ
  bf16* dq = static_cast<bf16*>(a.dq) + qoff;
  for (int qt = warp; qt < a.nqt; qt += nw) {
    const int r0 = qt * kTile;
    const bool full = full_s[qt];
    uint32_t qa[DH / 16][4], da[DH / 16][4];
    load_a<DH>(qa, Qs, r0, lane);
    load_a<DH>(da, dOs, r0, lane);
    const float mr[2] = {mx[r0 + g], mx[r0 + g + 8]}, ir[2] = {il[r0 + g], il[r0 + g + 8]};
    float dsum[2] = {0.f, 0.f};
    for (int kt = 0; kt < a.nkt; ++kt) {
      const int cls = tile_class(map, a.nkt, qt, kt, full);
      if (cls < 0) continue;
      float p[2][4], dp[2][4];
      rows_dot<DH>(p, qa, Ks, kt * kTile, lane);
      tile_logits(p, a, cls, r0, kt * kTile, kb, g, t);
      rows_dot<DH>(dp, da, Vs, kt * kTile, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dsum[e >> 1] += __expf(p[j][e] - mr[e >> 1]) * ir[e >> 1] * round_bf16(dp[j][e]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], off);

    float acc[DH / 8][4];
#pragma unroll
    for (int c = 0; c < DH / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
    for (int kt = 0; kt < a.nkt; ++kt) {
      const int cls = tile_class(map, a.nkt, qt, kt, full);
      if (cls < 0) continue;
      float p[2][4], dp[2][4], lo[2][4];
      rows_dot<DH>(p, qa, Ks, kt * kTile, lane);
      tile_logits(p, a, cls, r0, kt * kTile, kb, g, t);
      rows_dot<DH>(dp, da, Vs, kt * kTile, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pr = __expf(p[j][e] - mr[e >> 1]) * ir[e >> 1];
          const float ds = pr * (round_bf16(dp[j][e]) - dsum[e >> 1]);
          const float s = ds * a.scale;
          p[j][e] = round_bf16(s);
          lo[j][e] = s - p[j][e];
        }
      uint32_t hia[4], loa[4];
      to_a(hia, p);
      to_a(loa, lo);
      acc_rows<DH>(acc, hia, Ks, kt * kTile, lane);
      acc_rows<DH>(acc, loa, Ks, kt * kTile, lane);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r0 + g + 8 * r;
      if (i >= a.lq) continue;
#pragma unroll
      for (int c = 0; c < DH / 8; ++c)
        *reinterpret_cast<uint32_t*>(dq + (size_t)i * stride + 8 * c + 2 * t) =
            pack(acc[c][2 * r], acc[c][2 * r + 1]);
      if (t == 0) D[i] = dsum[r];
    }
  }
  __syncthreads();

  // phase 2, a key tile a warp: dK and dV over the query tiles that reach it
  bf16* dk = static_cast<bf16*>(a.dk) + koff;
  bf16* dv = static_cast<bf16*>(a.dv) + koff;
  for (int kt = warp; kt < a.nkt; kt += nw) {
    const int k0 = kt * kTile;
    uint32_t ka[DH / 16][4], va[DH / 16][4];
    load_a<DH>(ka, Ks, k0, lane);
    load_a<DH>(va, Vs, k0, lane);
    const float kbr[2] = {kb[k0 + g], kb[k0 + g + 8]};
    float acc_k[DH / 8][4], acc_v[DH / 8][4];
#pragma unroll
    for (int c = 0; c < DH / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[c][e] = acc_v[c][e] = 0.f;
    for (int qt = 0; qt < a.nqt; ++qt) {
      const int cls = tile_class(map, a.nkt, qt, kt, full_s[qt]);
      if (cls < 0) continue;
      const int q0 = qt * kTile;
      float p[2][4], dp[2][4], lo[2][4];
      rows_dot<DH>(p, ka, Qs, q0, lane);   // Sᵀ: rows keys, columns queries
      rows_dot<DH>(dp, va, dOs, q0, lane);  // dPᵀ
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + g + 8 * (e >> 1), i = q0 + 8 * j + 2 * t + (e & 1);
          const float x = logit(p[j][e], a.scale, struct_at(a, cls, i, key), kbr[e >> 1]);
          const float pr = __expf(x - mx[i]) * il[i];
          const float s = pr * (round_bf16(dp[j][e]) - D[i]) * a.scale;
          p[j][e] = pr;
          dp[j][e] = round_bf16(s);
          lo[j][e] = s - dp[j][e];
        }
      uint32_t pa[4], hia[4], loa[4];
      to_a(pa, p);
      to_a(hia, dp);
      to_a(loa, lo);
      acc_rows<DH>(acc_v, pa, dOs, q0, lane);
      acc_rows<DH>(acc_k, hia, Qs, q0, lane);
      acc_rows<DH>(acc_k, loa, Qs, q0, lane);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = k0 + g + 8 * r;
      if (j >= a.lkv) continue;
#pragma unroll
      for (int c = 0; c < DH / 8; ++c) {
        const size_t at = (size_t)j * stride + 8 * c + 2 * t;
        *reinterpret_cast<uint32_t*>(dk + at) = pack(acc_k[c][2 * r], acc_k[c][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + at) = pack(acc_v[c][2 * r], acc_v[c][2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32 (CUDA cores): a thread a row
// ---------------------------------------------------------------------------

template <int DH>
__device__ __forceinline__ float dot(const float* x, const float* y) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) s = fmaf(x[d], y[d], s);
  return s;
}

template <int DH>
__device__ __forceinline__ void load_row(float* dst, const float* src) {
#pragma unroll
  for (int d = 0; d < DH; d += 4) {
    const float4 v4 = *reinterpret_cast<const float4*>(src + d);
    dst[d] = v4.x; dst[d + 1] = v4.y; dst[d + 2] = v4.z; dst[d + 3] = v4.w;
  }
}

template <int DH>
__device__ __forceinline__ void store_row(float* dst, const float* src) {
#pragma unroll
  for (int d = 0; d < DH; d += 4)
    *reinterpret_cast<float4*>(dst + d) = make_float4(src[d], src[d + 1], src[d + 2], src[d + 3]);
}

// rows [0, rows) of one head into a dense [rows][DH] float32 array
template <int DH>
__device__ void load_f32(float* s, const float* g, int rows, int stride) {
  constexpr int C = DH / 4;
  for (int id = threadIdx.x; id < rows * C; id += blockDim.x) {
    const int r = id / C, c = id % C;
    *reinterpret_cast<float4*>(s + r * DH + 4 * c) =
        *reinterpret_cast<const float4*>(g + (size_t)r * stride + 4 * c);
  }
}

// the row's max and sum over the walked keys (Ks [Lkv][DH] in shared memory)
template <int DH>
__device__ void row_stats_f32(float& m, float& l, const Args& a, const float* q, const float* Ks,
                              const float* kb, const int8_t* map, int i, bool full) {
  m = -__int_as_float(0x7f800000);
  l = 0.f;
  const int qt = i / kTile;
  for (int kt = 0; kt < a.nkt; ++kt) {
    const int cls = tile_class(map, a.nkt, qt, kt, full);
    if (cls < 0) continue;
    for (int j = kt * kTile; j < min(kt * kTile + kTile, a.lkv); ++j) {
      const float x = logit(dot<DH>(q, Ks + j * DH), a.scale, struct_at(a, cls, i, j), kb[j]);
      if (x > m) {
        l = l * expf(m - x) + 1.f;
        m = x;
      } else {
        l += expf(x - m);
      }
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kMaxWarps * 32) fwd_f32_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads, stride = a.heads * DH;
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + a.lkv * DH;
  float* kb = Vs + a.lkv * DH;
  int8_t* map = a.tiles ? reinterpret_cast<int8_t*>(kb + a.lkv) : nullptr;
  const size_t qoff = ((size_t)b * a.lq * a.heads + h) * DH;
  const size_t koff = ((size_t)b * a.lkv * a.heads + h) * DH;
  load_f32<DH>(Ks, static_cast<const float*>(a.k) + koff, a.lkv, stride);
  load_f32<DH>(Vs, static_cast<const float*>(a.v) + koff, a.lkv, stride);
  for (int j = threadIdx.x; j < a.lkv; j += blockDim.x)
    kb[j] = a.kbias ? a.kbias[(size_t)b * a.lkv + j] : 0.f;
  if (map)
    for (int id = threadIdx.x; id < a.nqt * a.nkt; id += blockDim.x) map[id] = a.tiles[id];
  __syncthreads();

  const float* qg = static_cast<const float*>(a.q) + qoff;
  float* og = static_cast<float*>(a.o) + qoff;
  for (int i = threadIdx.x; i < a.lq; i += blockDim.x) {
    float q[DH];
    load_row<DH>(q, qg + (size_t)i * stride);
    float m, l;
    row_stats_f32<DH>(m, l, a, q, Ks, kb, map, i, false);
    const bool full = map != nullptr && m <= kNoKey;
    if (full) row_stats_f32<DH>(m, l, a, q, Ks, kb, map, i, true);
    float o[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) o[d] = 0.f;
    const int qt = i / kTile;
    for (int kt = 0; kt < a.nkt; ++kt) {
      const int cls = tile_class(map, a.nkt, qt, kt, full);
      if (cls < 0) continue;
      for (int j = kt * kTile; j < min(kt * kTile + kTile, a.lkv); ++j) {
        const float x = logit(dot<DH>(q, Ks + j * DH), a.scale, struct_at(a, cls, i, j), kb[j]);
        const float p = expf(x - m) / l;
#pragma unroll
        for (int d = 0; d < DH; ++d) o[d] = fmaf(p, Vs[j * DH + d], o[d]);
      }
    }
    store_row<DH>(og + (size_t)i * stride, o);
    if (a.stats != nullptr)
      reinterpret_cast<float2*>(a.stats)[((size_t)b * a.heads + h) * a.lq + i] = make_float2(m, l);
  }
}

template <int DH>
__global__ void __launch_bounds__(kMaxWarps * 32) bwd_f32_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads, stride = a.heads * DH;
  const int rows = max(a.lq, a.lkv);
  float* As = reinterpret_cast<float*>(smem);  // K, then Q
  float* Bs = As + rows * DH;                  // V, then dO
  float* kb = Bs + rows * DH;
  float* mx = kb + a.lkv;  // each row's max
  float* sm = mx + a.lq;   // and sum
  float* D = sm + a.lq;
  int8_t* map_s = reinterpret_cast<int8_t*>(D + a.lq);
  int8_t* full_s = map_s + a.nqt * a.nkt;
  const int8_t* map = a.tiles ? map_s : nullptr;
  const size_t qoff = ((size_t)b * a.lq * a.heads + h) * DH;
  const size_t koff = ((size_t)b * a.lkv * a.heads + h) * DH;
  const float* qg = static_cast<const float*>(a.q) + qoff;
  const float* dog = static_cast<const float*>(a.dout) + qoff;
  const float* kg = static_cast<const float*>(a.k) + koff;
  const float* vg = static_cast<const float*>(a.v) + koff;
  load_f32<DH>(As, kg, a.lkv, stride);
  load_f32<DH>(Bs, vg, a.lkv, stride);
  for (int j = threadIdx.x; j < a.lkv; j += blockDim.x)
    kb[j] = a.kbias ? a.kbias[(size_t)b * a.lkv + j] : 0.f;
  const float2* st = reinterpret_cast<const float2*>(a.stats_in) + ((size_t)b * a.heads + h) * a.lq;
  for (int i = threadIdx.x; i < a.lq; i += blockDim.x) {
    mx[i] = st[i].x;
    sm[i] = st[i].y;
  }
  if (map)
    for (int id = threadIdx.x; id < a.nqt * a.nkt; id += blockDim.x) map_s[id] = a.tiles[id];
  __syncthreads();
  for (int qt = threadIdx.x; qt < a.nqt; qt += blockDim.x) {
    bool none = false;
    for (int i = qt * kTile; i < min(qt * kTile + kTile, a.lq); ++i) none |= mx[i] <= kNoKey;
    full_s[qt] = map != nullptr && none;
  }
  __syncthreads();

  // phase 1, a query row a thread: D = Σ P·dP, then dQ
  float* dqg = static_cast<float*>(a.dq) + qoff;
  for (int i = threadIdx.x; i < a.lq; i += blockDim.x) {
    float q[DH], dout[DH], acc[DH];
    load_row<DH>(q, qg + (size_t)i * stride);
    load_row<DH>(dout, dog + (size_t)i * stride);
    const int qt = i / kTile;
    const bool full = full_s[qt];
    float dsum = 0.f;
    for (int kt = 0; kt < a.nkt; ++kt) {
      const int cls = tile_class(map, a.nkt, qt, kt, full);
      if (cls < 0) continue;
      for (int j = kt * kTile; j < min(kt * kTile + kTile, a.lkv); ++j) {
        const float x = logit(dot<DH>(q, As + j * DH), a.scale, struct_at(a, cls, i, j), kb[j]);
        dsum += expf(x - mx[i]) / sm[i] * dot<DH>(dout, Bs + j * DH);
      }
    }
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] = 0.f;
    for (int kt = 0; kt < a.nkt; ++kt) {
      const int cls = tile_class(map, a.nkt, qt, kt, full);
      if (cls < 0) continue;
      for (int j = kt * kTile; j < min(kt * kTile + kTile, a.lkv); ++j) {
        const float x = logit(dot<DH>(q, As + j * DH), a.scale, struct_at(a, cls, i, j), kb[j]);
        const float s = expf(x - mx[i]) / sm[i] * (dot<DH>(dout, Bs + j * DH) - dsum) * a.scale;
#pragma unroll
        for (int d = 0; d < DH; ++d) acc[d] = fmaf(s, As[j * DH + d], acc[d]);
      }
    }
    store_row<DH>(dqg + (size_t)i * stride, acc);
    D[i] = dsum;
  }
  __syncthreads();
  load_f32<DH>(As, qg, a.lq, stride);
  load_f32<DH>(Bs, dog, a.lq, stride);
  __syncthreads();

  // phase 2, a key row a thread: dK and dV
  float* dkg = static_cast<float*>(a.dk) + koff;
  float* dvg = static_cast<float*>(a.dv) + koff;
  for (int j = threadIdx.x; j < a.lkv; j += blockDim.x) {
    float kr[DH], vr[DH], acc_k[DH], acc_v[DH];
    load_row<DH>(kr, kg + (size_t)j * stride);
    load_row<DH>(vr, vg + (size_t)j * stride);
#pragma unroll
    for (int d = 0; d < DH; ++d) acc_k[d] = acc_v[d] = 0.f;
    const int kt = j / kTile;
    for (int qt = 0; qt < a.nqt; ++qt) {
      const int cls = tile_class(map, a.nkt, qt, kt, full_s[qt]);
      if (cls < 0) continue;
      for (int i = qt * kTile; i < min(qt * kTile + kTile, a.lq); ++i) {
        const float x = logit(dot<DH>(As + i * DH, kr), a.scale, struct_at(a, cls, i, j), kb[j]);
        const float p = expf(x - mx[i]) / sm[i];
        const float s = p * (dot<DH>(Bs + i * DH, vr) - D[i]) * a.scale;
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          acc_v[d] = fmaf(p, Bs[i * DH + d], acc_v[d]);
          acc_k[d] = fmaf(s, As[i * DH + d], acc_k[d]);
        }
      }
    }
    store_row<DH>(dkg + (size_t)j * stride, acc_k);
    store_row<DH>(dvg + (size_t)j * stride, acc_v);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

size_t fwd_smem(int dtype, int dh, int lq, int lkv, int nqt, int nkt) {
  if (dtype == 1) return (size_t)(nqt + 2 * nkt) * kTile * dh * 2 + 16 * (size_t)nkt * 4 + nqt * nkt;
  return (size_t)2 * lkv * dh * 4 + (size_t)lkv * 4 + nqt * nkt;
}

size_t bwd_smem(int dtype, int dh, int lq, int lkv, int nqt, int nkt) {
  if (dtype == 1) return (size_t)(2 * nqt + 2 * nkt) * kTile * dh * 2 + smem_tail(nqt, nkt);
  const int rows = lq > lkv ? lq : lkv;
  return (size_t)2 * rows * dh * 4 + (size_t)(lkv + 3 * lq) * 4 + nqt * nkt + nqt;
}

// A kernel's limit of dynamic shared memory is set on each device once (a bit
// a device in `ready`, one word a kernel), not on every launch: the launches
// of a training step sit on the host's critical path.
template <void (*K)(Args)>
int launch(const Args& a, int blocks, int threads, size_t smem, cudaStream_t s) {
  static std::atomic<uint32_t> ready{0u};
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    const uint32_t bit = dev < 32 ? 1u << dev : 0u;  // past 32 devices: set every launch
    if ((ready.load(std::memory_order_acquire) & bit) == 0u) {
      e = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (e != cudaSuccess) return (int)e;
      ready.fetch_or(bit, std::memory_order_release);
    }
  }
  K<<<blocks, threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

bool valid(int batch, int heads, int lq, int lkv, int dh, int dtype) {
  return batch >= 0 && heads > 0 && lq >= 1 && lq <= kMaxLen && lkv >= 1 && lkv <= kMaxLen &&
         (dh == 16 || dh == 32) && (dtype == 0 || dtype == 1);
}

// warps a block: one a tile of the longer side, at most kMaxWarps
int warps_for(int tiles) { return tiles < kMaxWarps ? tiles : kMaxWarps; }

}  // namespace

extern "C" {

// T1f: o [B, Lq, H·Dh] in the inputs' dtype; stats [B, H, Lq, 2] float32 (each
// row's max and sum), or null for none. sbias [Lq, Lkv] with tiles [ceil(Lq/16), ceil(Lkv/16)] int8, or
// both null; kbias [B, Lkv] or null.
int tower_attn_fwd(const void* q, const void* k, const void* v, const float* sbias,
                   const float* kbias, const int8_t* tiles, void* o, float* stats, int batch,
                   int heads, int lq, int lkv, int dh, float scale, int dtype, void* stream) {
  if (!valid(batch, heads, lq, lkv, dh, dtype) || (sbias == nullptr) != (tiles == nullptr))
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  Args a{};
  a.q = q; a.k = k; a.v = v; a.sbias = sbias; a.kbias = kbias; a.tiles = tiles;
  a.o = o; a.stats = stats; a.heads = heads; a.lq = lq; a.lkv = lkv; a.scale = scale;
  a.nqt = (lq + kTile - 1) / kTile;
  a.nkt = (lkv + kTile - 1) / kTile;
  const int blocks = batch * heads;
  const size_t smem = fwd_smem(dtype, dh, lq, lkv, a.nqt, a.nkt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const int threads = 32 * warps_for(a.nqt);
    if (dh == 16) return launch<fwd_bf16_kernel<16>>(a, blocks, threads, smem, s);
    return launch<fwd_bf16_kernel<32>>(a, blocks, threads, smem, s);
  }
  const int threads = 32 * warps_for((lq + 31) / 32);
  if (dh == 16) return launch<fwd_f32_kernel<16>>(a, blocks, threads, smem, s);
  return launch<fwd_f32_kernel<32>>(a, blocks, threads, smem, s);
}

// T1b: dq like q, dk and dv like k, from dout (like q) and the forward's stats
int tower_attn_bwd(const void* q, const void* k, const void* v, const void* dout,
                   const float* stats, const float* sbias, const float* kbias, const int8_t* tiles,
                   void* dq, void* dk, void* dv, int batch, int heads, int lq, int lkv, int dh,
                   float scale, int dtype, void* stream) {
  if (!valid(batch, heads, lq, lkv, dh, dtype) || (sbias == nullptr) != (tiles == nullptr))
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.stats_in = stats; a.sbias = sbias; a.kbias = kbias;
  a.tiles = tiles; a.dq = dq; a.dk = dk; a.dv = dv;
  a.heads = heads; a.lq = lq; a.lkv = lkv; a.scale = scale;
  a.nqt = (lq + kTile - 1) / kTile;
  a.nkt = (lkv + kTile - 1) / kTile;
  const int blocks = batch * heads;
  const size_t smem = bwd_smem(dtype, dh, lq, lkv, a.nqt, a.nkt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const int threads = 32 * warps_for(a.nqt > a.nkt ? a.nqt : a.nkt);
    if (dh == 16) return launch<bwd_bf16_kernel<16>>(a, blocks, threads, smem, s);
    return launch<bwd_bf16_kernel<32>>(a, blocks, threads, smem, s);
  }
  const int threads = 32 * warps_for(((lq > lkv ? lq : lkv) + 31) / 32);
  if (dh == 16) return launch<bwd_f32_kernel<16>>(a, blocks, threads, smem, s);
  return launch<bwd_f32_kernel<32>>(a, blocks, threads, smem, s);
}

}  // extern "C"
