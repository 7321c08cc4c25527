// Tile helpers of the flash attention kernels: the lse of an empty row for
// the forward (flash_attention.cu) and the backward (flash_attention_bwd.cu),
// the row loader for the backward. `static`: each library gets its own
// copy, so no symbol is shared between two loaded libraries.
#pragma once

#include "common.cuh"

// The logsumexp of a row with no valid key (the JAX kernels' NEG_INF).
constexpr float kNegInf = -1e30f;

// 64 rows x DP columns from `src` (row r at src + (row0 + r) * stride) into
// shared memory with leading dimension `ld`, by NT threads; rows >= n_valid
// and columns >= D are zero. D % 8 == 0 (16-byte loads).
template <int DP, int NT>
static __device__ __forceinline__ void load_rows(bf16* dst, int ld,
                                                 const bf16* src,
                                                 long long stride, int row0,
                                                 int n_valid, int D) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < 64 * kChunks; i += NT) {
    const int r = i / kChunks, c = (i - r * kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_valid && c < D)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}
