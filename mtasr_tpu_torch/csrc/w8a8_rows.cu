// The w8a8 linear's activation path around its int8 GEMM, in two launches:
//
//   mtasr_w8a8_quantize_kernel:  sx[m] = max(max_k |x[m, k]| * f32(1/127), 1e-12)
//                                q[m, k] = clamp(rint(x[m, k] / sx[m]), -127, 127)
//   mtasr_w8a8_rescale_kernel:   y[m, n] = T((f32(acc[m, n]) * sx[m]) * scale[n])
//                                (+ bias[n], added in f32 and rounded to T again)
//
// around `torch._int_mm(q, W^T) -> acc` (models/layers.py::linear, through
// ops/kernels/w8a8_rows.py). It replaces no TPU kernel: the JAX package
// leaves these elementwise passes to XLA, which fuses them; in PyTorch they
// were 13 kernels a linear, each writing an f32 or int32 copy of the whole
// activation.
//
// What bounds it on the H100: bytes. The quantize reads x once and writes
// q (3 bytes an element in bf16) plus a scale a row; the rescale reads the
// int32 product once and writes y (6 bytes an element), the column scales
// and bias once a block. Neither does more than a few operations a byte.
// In a decode step (M 256) each launch moves 2-15 MB, so it lasts a few µs
// and its launch and the gap to the next graph node weigh as much as its
// bytes; at the prefill (M 16384) it is a pure stream.
//
// Design. Quantize: a block takes a row at a time (a grid-stride loop over
// rows, the grid sized by the wrapper to the card's resident blocks); each
// thread loads its units of 16 elements with 16-byte loads and keeps up to
// 128 bytes of them in registers (`kResident`), so x is read once; units
// past that (K above 65536 in bf16 at 1024 threads) are read again from
// L2. max|x| is reduced by shuffles, then across the block's warps through
// shared memory; every thread then writes its units as int8, 16 bytes a
// unit. Rescale: a block takes 1024 columns (8 a thread: two 16-byte
// int32 loads, one 16-byte bf16 store) and walks rows (grid y, strided), so
// the column scales and bias are loaded once a thread. A row length or a
// pointer that is not a multiple of 16 bytes takes the same kernels with
// units of one element.
//
// Bit-equality with the PyTorch lines it replaces (the plain versions):
// IEEE division (no fast math), round half to even (`rintf`), the f32
// product with 1/127 then the 1e-12 floor, (acc * sx) * scale in that
// order, round to nearest even to bf16. NaN follows torch: the max and
// both clamps propagate it, and the int8 cast takes NaN to 0.
#include "common.cuh"

constexpr float kInv127 = static_cast<float>(1.0 / 127.0);  // ops/int8.py
constexpr float kFloor = 1e-12f;
constexpr int kMaxThreads = 1024;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

// U consecutive elements; U > 1 moves them with 16-byte accesses.
template <typename T, int U>
struct alignas(U == 1 ? alignof(T) : 16) Unit {
  T v[U];
};

template <typename T, int U>
__device__ __forceinline__ void load_unit(Unit<T, U>& u, const T* p) {
  if constexpr (U == 1) {
    u.v[0] = *p;
  } else {
    const uint4* src = reinterpret_cast<const uint4*>(p);
    uint4* dst = reinterpret_cast<uint4*>(&u);
#pragma unroll
    for (int i = 0; i < static_cast<int>(sizeof(Unit<T, U>) / 16); ++i)
      dst[i] = src[i];
  }
}

// torch's max: NaN wins.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float warp_nan_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The block's max, in every thread; `red` is free again on return.
__device__ __forceinline__ float block_nan_max(float v, float* red) {
  v = warp_nan_max(v);
  const int n_warps = blockDim.x >> 5;
  if (n_warps == 1) return v;
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = warp_nan_max(lane < n_warps ? red[lane] : 0.f);
  __syncthreads();
  return v;
}

// clamp(rint(v / s), -127, 127) cast to int8, as torch computes it. A zero
// dividend takes the IEEE division's slow path: on the H100 an all-zero row
// of 4096 made a launch at M 256 take 12.0 µs, against 5.3 µs for random
// rows. A branch that skipped zeros cost every row 2 µs (7.4 µs), and
// activations hold few exact zeros, so there is none.
__device__ __forceinline__ int8_t quantize_one(float v, float s) {
  float r = rintf(__fdiv_rn(v, s));
  r = r < -127.f ? -127.f : (r > 127.f ? 127.f : r);  // NaN passes
  return static_cast<int8_t>(__float2int_rz(r));       // NaN -> 0
}

template <typename T, int U>
__device__ __forceinline__ float unit_max(const Unit<T, U>& u, float m) {
#pragma unroll
  for (int e = 0; e < U; ++e) m = nan_max(m, fabsf(to_f32(u.v[e])));
  return m;
}

template <typename T, int U>
__device__ __forceinline__ void store_unit(int8_t* p, const Unit<T, U>& u,
                                           float s) {
  if constexpr (U == 1) {
    *p = quantize_one(to_f32(u.v[0]), s);
  } else {
    uint32_t w[4] = {0u, 0u, 0u, 0u};  // 16 int8, little-endian in 4 words
#pragma unroll
    for (int e = 0; e < 16; ++e)
      w[e >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                       quantize_one(to_f32(u.v[e]), s)))
                   << (8 * (e & 3));
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Units of a thread kept in registers: 128 bytes of x at U = 16.
template <typename T, int U>
constexpr int kResident = U == 16 ? 128 / (16 * static_cast<int>(sizeof(T)))
                                  : 16;

template <typename T, int U>
__global__ void __launch_bounds__(kMaxThreads)
    mtasr_w8a8_quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                               float* __restrict__ sx, int M, int K) {
  constexpr int R = kResident<T, U>;
  __shared__ float red[32];
  const int units = K / U;
  for (int row = blockIdx.x; row < M; row += gridDim.x) {
    const T* xr = x + static_cast<size_t>(row) * K;
    int8_t* qr = q + static_cast<size_t>(row) * K;
    Unit<T, U> u[R];
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = threadIdx.x + j * blockDim.x;
      if (c < units) {
        load_unit(u[j], xr + static_cast<size_t>(c) * U);
        m = unit_max(u[j], m);
      }
    }
    for (int c = threadIdx.x + R * blockDim.x; c < units; c += blockDim.x) {
      Unit<T, U> w;
      load_unit(w, xr + static_cast<size_t>(c) * U);
      m = unit_max(w, m);
    }
    float s = __fmul_rn(block_nan_max(m, red), kInv127);
    s = s < kFloor ? kFloor : s;  // clamp_min: NaN passes
    if (threadIdx.x == 0) sx[row] = s;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = threadIdx.x + j * blockDim.x;
      if (c < units) store_unit(qr + static_cast<size_t>(c) * U, u[j], s);
    }
    for (int c = threadIdx.x + R * blockDim.x; c < units; c += blockDim.x) {
      Unit<T, U> w;
      load_unit(w, xr + static_cast<size_t>(c) * U);
      store_unit(qr + static_cast<size_t>(c) * U, w, s);
    }
  }
}

// V columns a thread: 8 with 16-byte accesses, or 1.
template <typename T, int V, bool kBias>
__global__ void __launch_bounds__(128)
    mtasr_w8a8_rescale_kernel(const int* __restrict__ acc,
                              const float* __restrict__ sx,
                              const float* __restrict__ scale,
                              const T* __restrict__ bias, T* __restrict__ y,
                              int M, int N) {
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (col >= N) return;
  float sc[V];
  float b[V];
  if constexpr (V == 1) {
    sc[0] = scale[col];
    if constexpr (kBias) b[0] = to_f32(bias[col]);
  } else {
    const float4 s0 = *reinterpret_cast<const float4*>(scale + col);
    const float4 s1 = *reinterpret_cast<const float4*>(scale + col + 4);
    sc[0] = s0.x, sc[1] = s0.y, sc[2] = s0.z, sc[3] = s0.w;
    sc[4] = s1.x, sc[5] = s1.y, sc[6] = s1.z, sc[7] = s1.w;
    if constexpr (kBias) {
      Unit<T, 8> bu;
      load_unit(bu, bias + col);
#pragma unroll
      for (int e = 0; e < 8; ++e) b[e] = to_f32(bu.v[e]);
    }
  }
  for (int row = blockIdx.y; row < M; row += gridDim.y) {
    const size_t off = static_cast<size_t>(row) * N + col;
    const float s = sx[row];
    int a[V];
    if constexpr (V == 1) {
      a[0] = acc[off];
    } else {
      const int4 a0 = *reinterpret_cast<const int4*>(acc + off);
      const int4 a1 = *reinterpret_cast<const int4*>(acc + off + 4);
      a[0] = a0.x, a[1] = a0.y, a[2] = a0.z, a[3] = a0.w;
      a[4] = a1.x, a[5] = a1.y, a[6] = a1.z, a[7] = a1.w;
    }
    Unit<T, V> out;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      // two f32 products, each rounded, then one rounding to T
      const float prod = __fmul_rn(__fmul_rn(static_cast<float>(a[e]), s),
                                   sc[e]);
      T o = from_f32<T>(prod);
      if constexpr (kBias) o = from_f32<T>(__fadd_rn(to_f32(o), b[e]));
      out.v[e] = o;
    }
    if constexpr (V == 1) {
      y[off] = out.v[0];
    } else {
      const uint4* src = reinterpret_cast<const uint4*>(&out);
      uint4* dst = reinterpret_cast<uint4*>(y + off);
#pragma unroll
      for (int i = 0; i < static_cast<int>(sizeof(out) / 16); ++i)
        dst[i] = src[i];
    }
  }
}

template <typename T>
static cudaError_t quantize(const void* x, void* q, float* sx, int M, int K,
                            int unit, int threads, int blocks,
                            cudaStream_t s) {
  const auto* xp = static_cast<const T*>(x);
  auto* qp = static_cast<int8_t*>(q);
  if (unit == 16)
    mtasr_w8a8_quantize_kernel<T, 16><<<blocks, threads, 0, s>>>(xp, qp, sx,
                                                                 M, K);
  else
    mtasr_w8a8_quantize_kernel<T, 1><<<blocks, threads, 0, s>>>(xp, qp, sx, M,
                                                                K);
  return cudaGetLastError();
}

template <typename T, int V>
static cudaError_t rescale_v(const void* acc, const float* sx,
                             const void* scale, const void* bias, void* y,
                             int M, int N, dim3 grid, cudaStream_t s) {
  const auto* a = static_cast<const int*>(acc);
  const auto* sc = static_cast<const float*>(scale);
  const auto* b = static_cast<const T*>(bias);
  auto* yp = static_cast<T*>(y);
  if (bias != nullptr)
    mtasr_w8a8_rescale_kernel<T, V, true><<<grid, 128, 0, s>>>(a, sx, sc, b,
                                                               yp, M, N);
  else
    mtasr_w8a8_rescale_kernel<T, V, false><<<grid, 128, 0, s>>>(a, sx, sc, b,
                                                                yp, M, N);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t rescale(const void* acc, const float* sx,
                           const void* scale, const void* bias, void* y,
                           int M, int N, int unit, dim3 grid,
                           cudaStream_t s) {
  return unit == 8 ? rescale_v<T, 8>(acc, sx, scale, bias, y, M, N, grid, s)
                   : rescale_v<T, 1>(acc, sx, scale, bias, y, M, N, grid, s);
}

// which 0: quantize x [M, K] (`in`) into q [M, K] (`out`) and the row
//          scales sx [M], with `unit` 16 or 1, `threads` a multiple of 32
//          up to 1024 and `grid_x` blocks;
// which 1: rescale the int32 product acc [M, K] (`in`) by the row scales
//          sx [M], the column scales [K] and the optional bias [K] (null
//          for none) into y [M, K] (`out`), with `unit` 8 or 1 and a grid
//          of (grid_x, grid_y) blocks of 128 (`threads` unused).
// dtype 0: x, y and the bias bf16; 1: float.
extern "C" int w8a8_rows_launch(int which, const void* in, void* sx,
                                const void* col_scale, const void* bias,
                                void* out, int M, int K, int dtype, int unit,
                                int threads, int grid_x, int grid_y,
                                void* stream) {
  const bool ok =
      (which == 0 && (unit == 16 || unit == 1) && threads >= 32 &&
       threads <= kMaxThreads && threads % 32 == 0) ||
      (which == 1 && (unit == 8 || unit == 1) && grid_y >= 1 &&
       grid_y <= 65535);
  if (!ok || M < 0 || K < 1 || K % unit != 0 || grid_x < 1 || dtype < 0 ||
      dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* rs = static_cast<float*>(sx);
  if (which == 0)
    return static_cast<int>(
        dtype == 0
            ? quantize<bf16>(in, out, rs, M, K, unit, threads, grid_x, s)
            : quantize<float>(in, out, rs, M, K, unit, threads, grid_x, s));
  const dim3 grid(grid_x, grid_y);
  return static_cast<int>(
      dtype == 0
          ? rescale<bf16>(in, rs, col_scale, bias, out, M, K, unit, grid, s)
          : rescale<float>(in, rs, col_scale, bias, out, M, K, unit, grid,
                           s));
}

MTASR_EXPORT_ERROR_STRING
