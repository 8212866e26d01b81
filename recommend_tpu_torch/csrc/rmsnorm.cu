// RMSNorm forward and backward for Hopper (sm_90a).
//
// Three entry points, behind ops/normalization.py's autograd Function:
//
//   rmsnorm_fwd     y = (x * rstd) * w,  rstd = rsqrt(mean(x^2) + eps)      (R1f)
//   rmsnorm_bwd     dx = rstd * (w*dy - xh * mean(w*dy * xh)),  xh = x * rstd,
//                   and each block's partial sums of dy * xh over its rows  (R1b)
//   rmsnorm_dscale  dscale = the blocks' partials summed in a fixed order  (R1b)
//
// It replaces no TPU kernel. The JAX package has no Pallas kernel for the
// norm: recommend_tpu/ops/normalization.py writes the float32 chain (upcast,
// square, mean, rsqrt, two products, downcast), which XLA fuses into one pass
// on the TPU. Eager PyTorch runs that chain as one kernel per operation, each
// writing a full-size float32 tensor, and autograd adds its own passes
// backward: about 140 bytes moved an element. These kernels were added to
// bring that to what the function needs.
//
// What bounds it on this card: bytes. The forward reads x and writes y, the
// backward reads x and dy and writes dx, 10 bytes an element in bf16 (20 in
// float32), plus one float32 statistic a row, at 3.35 TB/s. The arithmetic
// is a few flops an element, far below the card's ridge.
//
// How the design meets that bound: one read and one write of each element.
//   - A row belongs to a group of G lanes of one warp. G is a power of two up
//     to 32, fixed at compile time from the width so that every lane moves
//     whole 16-byte vectors (bf16 at d 384: 16 lanes of 3 vectors, two rows a
//     warp; at d 256 a full warp of one vector each). A group's lanes read
//     neighbouring vectors, so every load and store is coalesced.
//   - The row stays in registers between its reduction and its write. The sum
//     of squares (forward) and of w*dy*xh (backward) is reduced in float32 by
//     warp shuffles inside the group.
//   - The backward grid is persistent: the wrapper fixes its size from the
//     SM count and the number of rows, two 256-thread blocks an SM at most,
//     and each group walks its rows with a stride of all the grid's groups.
//     Each lane keeps its columns' sum of dy * xh in float32 registers across
//     its rows; at the end the block sums its groups' partials in shared
//     memory, in group order, into one row of the [grid, d] partials.
//     rmsnorm_dscale sums those rows in a fixed order. No atomics: a step
//     repeats bit for bit.
//   - rstd ([rows] float32) is written only when the wrapper asks for it (a
//     gradient is needed); the no-grad serving calls pass a null pointer.
//
// Widths 64, 128, 256, 384 and 512 take that vector path. Any other width,
// or a pointer that is not 16-byte aligned, takes a general path: a warp a
// row, one element a lane at a time, masked at the row's end; its backward
// keeps each warp's column partials in shared memory (d up to 3072).
//
// Rounding follows the plain chain: statistics and products in float32,
// (x * rstd) * w and then a single rounding to the input's dtype. Only the
// order of each row's sum differs from the plain version.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns the launch's cudaGetLastError(). dtype: 0 float32, 1 bfloat16;
// any other code returns cudaErrorInvalidValue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // threads a block, every kernel but dscale
constexpr int kGeneralWarps = 4;   // warps a block of the general backward
constexpr int kMaxGeneralD = 3072; // kGeneralWarps * d floats of shared memory <= 48 KB

using bf16 = __nv_bfloat16;

// elements in one 16-byte vector
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<bf16> { static constexpr int N = 8; };

__device__ __forceinline__ void load_vec(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load_vec(const bf16* p, float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_vec(bf16* p, const float* v) {
  uint4 a;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = a;
}

// w (float32) for the V columns at col
template <int V>
__device__ __forceinline__ void load_w(const float* w, int col, float* v) {
#pragma unroll
  for (int i = 0; i < V; i += 4) load_vec(w + col + i, v + i);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// the sum over the G lanes of each aligned group of G lanes in the warp
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The vector path's tiling of a row of D elements of T.
template <typename T, int D>
struct Tile {
  static constexpr int V = Vec<T>::N;  // elements a vector
  static constexpr int NV = D / V;     // vectors a row
  static constexpr int G = NV % 32 == 0 ? 32 : NV % 16 == 0 ? 16 : NV % 8 == 0 ? 8
                         : NV % 4 == 0 ? 4 : NV % 2 == 0 ? 2 : 1;  // lanes a row
  static constexpr int N = NV / G;     // vectors a lane
  static constexpr int E = N * V;      // elements a lane
  static constexpr int GROUPS = kThreads / G;  // rows a block holds at once
  static_assert(D % V == 0, "a row is whole vectors");
};

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fwd_vec_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
               float* __restrict__ rstd, int rows, float eps) {
  using C = Tile<T, D>;
  const int lane = threadIdx.x % C::G;
  const long long row = (long long)blockIdx.x * C::GROUPS + threadIdx.x / C::G;
  const bool valid = row < rows;  // a whole group is valid or not
  float v[C::E];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < C::N; ++i) {
    float* vi = v + i * C::V;
    if (valid) {
      load_vec(x + row * D + (i * C::G + lane) * C::V, vi);
    } else {
#pragma unroll
      for (int j = 0; j < C::V; ++j) vi[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < C::V; ++j) ss += vi[j] * vi[j];
  }
  ss = group_sum<C::G>(ss);  // every lane of the warp takes part
  if (!valid) return;
  const float r = rsqrtf(ss / (float)D + eps);
#pragma unroll
  for (int i = 0; i < C::N; ++i) {
    const int col = (i * C::G + lane) * C::V;
    float wv[C::V], out[C::V];
    load_w<C::V>(w, col, wv);
#pragma unroll
    for (int j = 0; j < C::V; ++j) out[j] = (v[i * C::V + j] * r) * wv[j];
    store_vec(y + row * D + col, out);
  }
  if (rstd != nullptr && lane == 0) rstd[row] = r;
}

// A warp a row, any width.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fwd_any_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
               float* __restrict__ rstd, int rows, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;  // the whole warp
  const T* xr = x + row * d;
  float ss = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = to_f(xr[c]);
    ss += v * v;
  }
  ss = group_sum<32>(ss);
  const float r = rsqrtf(ss / (float)d + eps);
  for (int c = lane; c < d; c += 32) y[row * d + c] = from_f<T>((to_f(xr[c]) * r) * w[c]);
  if (rstd != nullptr && lane == 0) rstd[row] = r;
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
bwd_vec_kernel(const T* __restrict__ x, const T* __restrict__ dy,
               const float* __restrict__ rstd, const float* __restrict__ w,
               T* __restrict__ dx, float* __restrict__ partials, int rows) {
  using C = Tile<T, D>;
  __shared__ float red[C::GROUPS * D];
  const int lane = threadIdx.x % C::G;
  const int group = threadIdx.x / C::G;
  const int warp_group = (threadIdx.x / 32) * (32 / C::G);  // the warp's first group
  float wv[C::E], acc[C::E];
#pragma unroll
  for (int i = 0; i < C::N; ++i) load_w<C::V>(w, (i * C::G + lane) * C::V, wv + i * C::V);
#pragma unroll
  for (int e = 0; e < C::E; ++e) acc[e] = 0.f;
  const long long stride = (long long)gridDim.x * C::GROUPS;
  // the loop runs alike on every lane of a warp, so the shuffles see them all
  for (long long base = (long long)blockIdx.x * C::GROUPS + warp_group; base < rows;
       base += stride) {
    const long long row = base + (group - warp_group);
    const bool valid = row < rows;
    const float r = valid ? rstd[row] : 0.f;
    float xh[C::E], g[C::E];
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < C::N; ++i) {
      const int col = (i * C::G + lane) * C::V;
      float* xi = xh + i * C::V;
      float* gi = g + i * C::V;
      if (valid) {
        load_vec(x + row * D + col, xi);
        load_vec(dy + row * D + col, gi);
      } else {
#pragma unroll
        for (int j = 0; j < C::V; ++j) xi[j] = gi[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < C::V; ++j) {
        const float dyj = gi[j];
        xi[j] = xi[j] * r;
        gi[j] = wv[i * C::V + j] * dyj;
        acc[i * C::V + j] += dyj * xi[j];
        dot += gi[j] * xi[j];
      }
    }
    dot = group_sum<C::G>(dot);
    if (valid) {
      const float c = dot / (float)D;
#pragma unroll
      for (int i = 0; i < C::N; ++i) {
        float out[C::V];
#pragma unroll
        for (int j = 0; j < C::V; ++j)
          out[j] = r * (g[i * C::V + j] - xh[i * C::V + j] * c);
        store_vec(dx + row * D + (i * C::G + lane) * C::V, out);
      }
    }
  }
  if (partials == nullptr) return;  // alike on every thread of the block
#pragma unroll
  for (int i = 0; i < C::N; ++i) {
    const int col = (i * C::G + lane) * C::V;
#pragma unroll
    for (int j = 0; j < C::V; ++j) red[group * D + col + j] = acc[i * C::V + j];
  }
  __syncthreads();
  for (int col = threadIdx.x; col < D; col += kThreads) {
    float s = 0.f;
    for (int k = 0; k < C::GROUPS; ++k) s += red[k * D + col];
    partials[(long long)blockIdx.x * D + col] = s;
  }
}

// A warp a row, any width up to kMaxGeneralD; each warp's column partials
// live in shared memory ([kGeneralWarps][d] floats, dynamic).
template <typename T>
__global__ void __launch_bounds__(kGeneralWarps * 32)
bwd_any_kernel(const T* __restrict__ x, const T* __restrict__ dy,
               const float* __restrict__ rstd, const float* __restrict__ w,
               T* __restrict__ dx, float* __restrict__ partials, int rows, int d) {
  extern __shared__ float red[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  float* acc = red + warp * d;  // each column written by one lane of this warp
  for (int c = lane; c < d; c += 32) acc[c] = 0.f;
  for (long long row = (long long)blockIdx.x * kGeneralWarps + warp; row < rows;
       row += (long long)gridDim.x * kGeneralWarps) {
    const T* xr = x + row * d;
    const T* gr = dy + row * d;
    const float r = rstd[row];
    float dot = 0.f;
    for (int c = lane; c < d; c += 32) dot += (w[c] * to_f(gr[c])) * (to_f(xr[c]) * r);
    dot = group_sum<32>(dot);
    const float cm = dot / (float)d;
    for (int c = lane; c < d; c += 32) {
      const float xh = to_f(xr[c]) * r;
      const float g = to_f(gr[c]);
      dx[row * d + c] = from_f<T>(r * (w[c] * g - xh * cm));
      acc[c] += g * xh;
    }
  }
  if (partials == nullptr) return;
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < kGeneralWarps; ++k) s += red[k * d + c];
    partials[(long long)blockIdx.x * d + c] = s;
  }
}

// dscale[c] = sum over the grid's rows of partials[b, c]: 32 columns a
// block, 8 row slices summed in a fixed order.
__global__ void __launch_bounds__(256)
dscale_kernel(const float* __restrict__ partials, float* __restrict__ dscale, int grid,
              int d) {
  __shared__ float part[8][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (col < d)
    for (int b = threadIdx.y; b < grid; b += 8) s += partials[(long long)b * d + col];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < d) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += part[k][threadIdx.x];
    dscale[col] = t;
  }
}

// ---------------------------------------------------------------------------
// Dispatch
// ---------------------------------------------------------------------------

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

#define RMSNORM_FOR_EACH_D(X) X(64) X(128) X(256) X(384) X(512)

template <typename T>
int fwd(const void* xp, const float* w, void* yp, float* rstd, int rows, int d, float eps,
        cudaStream_t s) {
  const T* x = static_cast<const T*>(xp);
  T* y = static_cast<T*>(yp);
  const bool vec = aligned16(x) && aligned16(y) && aligned16(w);
  switch (vec ? d : 0) {
#define RMSNORM_FWD_CASE(D)                                                          \
  case D:                                                                            \
    fwd_vec_kernel<T, D><<<(rows + Tile<T, D>::GROUPS - 1) / Tile<T, D>::GROUPS,      \
                           kThreads, 0, s>>>(x, w, y, rstd, rows, eps);              \
    break;
    RMSNORM_FOR_EACH_D(RMSNORM_FWD_CASE)
#undef RMSNORM_FWD_CASE
    default:
      fwd_any_kernel<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, s>>>(
          x, w, y, rstd, rows, d, eps);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* xp, const void* dyp, const float* rstd, const float* w, void* dxp,
        float* partials, int rows, int d, int grid, cudaStream_t s) {
  const T* x = static_cast<const T*>(xp);
  const T* dy = static_cast<const T*>(dyp);
  T* dx = static_cast<T*>(dxp);
  const bool vec = aligned16(x) && aligned16(dy) && aligned16(dx) && aligned16(w);
  switch (vec ? d : 0) {
#define RMSNORM_BWD_CASE(D)                                                          \
  case D:                                                                            \
    bwd_vec_kernel<T, D><<<grid, kThreads, 0, s>>>(x, dy, rstd, w, dx, partials, rows); \
    break;
    RMSNORM_FOR_EACH_D(RMSNORM_BWD_CASE)
#undef RMSNORM_BWD_CASE
    default:
      if (d > kMaxGeneralD) return (int)cudaErrorInvalidValue;
      bwd_any_kernel<T><<<grid, kGeneralWarps * 32, kGeneralWarps * d * sizeof(float), s>>>(
          x, dy, rstd, w, dx, partials, rows, d);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// R1f: y [rows, d] in x's dtype; rstd [rows] float32, or null for none
int rmsnorm_fwd(const void* x, const float* w, void* y, float* rstd, int rows, int d,
                float eps, int dtype, void* stream) {
  if (rows < 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(x, w, y, rstd, rows, d, eps, s);
  if (dtype == 1) return fwd<bf16>(x, w, y, rstd, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}

// R1b: dx [rows, d] in x's dtype and, unless partials is null, the grid's
// [grid, d] float32 partial sums of dy * xh; grid blocks, grid >= 1
int rmsnorm_bwd(const void* x, const void* dy, const float* rstd, const float* w, void* dx,
                float* partials, int rows, int d, int grid, int dtype, void* stream) {
  if (rows < 0 || d <= 0 || grid < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd<float>(x, dy, rstd, w, dx, partials, rows, d, grid, s);
  if (dtype == 1) return bwd<bf16>(x, dy, rstd, w, dx, partials, rows, d, grid, s);
  return (int)cudaErrorInvalidValue;
}

// R1b's second kernel: dscale [d] float32 from the [grid, d] partials
int rmsnorm_dscale(const float* partials, float* dscale, int grid, int d, void* stream) {
  if (grid < 1 || d <= 0) return (int)cudaErrorInvalidValue;
  dscale_kernel<<<(d + 31) / 32, dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      partials, dscale, grid, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
