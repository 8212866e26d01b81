// Helpers shared by the band-attention forward (band_attention.cu) and
// backward (band_attention_bwd.cu) kernels: tile sizes, the finite mask
// value, and the head widths that are instantiated.
#pragma once

namespace band_attn {

constexpr int BQ = 64;       // query rows per tile
constexpr int BK = 64;       // keys per tile
constexpr int NT = 256;      // threads per block: 16 row groups x 16 lanes
constexpr float NEG_INF = -1e9f;

// Every head width that is a multiple of 16 up to 128 (the thread layout
// gives each of 16 lanes Dh / 16 columns). X(D) expands once per width.
#define BAND_ATTN_FOR_EACH_DH(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

}  // namespace band_attn
