// Helpers shared by the band-attention forward (band_attention.cu) and
// backward (band_attention_bwd.cu) kernels: tile sizes, the finite mask
// value, float conversions of the input dtype, and the head widths that are
// instantiated.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace band_attn {

constexpr int BQ = 64;       // query rows per tile
constexpr int BK = 64;       // keys per tile
constexpr int NT = 256;      // threads per block: 16 row groups x 16 lanes
constexpr float NEG_INF = -1e9f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: the casts of p (before PV and before the dV
// product) and of dS (before the dQ and dK products) in the Pallas kernels
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Every head width that is a multiple of 16 up to 128 (the thread layout
// gives each of 16 lanes Dh / 16 columns). X(D) expands once per width.
#define BAND_ATTN_FOR_EACH_DH(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

}  // namespace band_attn
