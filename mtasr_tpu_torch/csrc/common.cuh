// Shared helpers of the mtasr_tpu_torch kernels (all bf16): element loads,
// warp reductions, `cp.async` copies and compile-time integer helpers. Each
// kernel file is its own shared library with a plain C interface (see
// ops/kernels/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

// Two neighbouring bf16 elements as floats (the pointer is 4-byte aligned).
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Round to bf16 (nearest even, as torch's .to()) and back.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16 bytes from global to shared memory, past L1; with valid < 16 only
// the first `valid` bytes are read and the rest are zeroed. Both addresses
// 16-byte aligned.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int valid = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ constexpr int pow2_at_least(int x) {
  return x <= 1 ? 1 : 2 * pow2_at_least((x + 1) / 2);
}

__host__ __device__ constexpr int log2_of(int x) {
  return x <= 1 ? 0 : 1 + log2_of(x / 2);
}

// Error text for the code an entry point returned.
#define MTASR_EXPORT_ERROR_STRING                                  \
  extern "C" const char* mtasr_error_string(int code) {           \
    return cudaGetErrorString(static_cast<cudaError_t>(code));     \
  }
