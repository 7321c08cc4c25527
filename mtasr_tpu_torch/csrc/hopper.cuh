// Hopper building blocks of the flash attention kernels (forward in
// flash_attention.cu, backward in flash_attention_bwd.cu; the decode kernel
// takes `ex2` and `kLog2e`): TMA tensor maps
// and loads, `mbarrier`s, `wgmma` with 128-byte swizzled shared-memory
// operands, and the accumulator's fragment layout. Everything sits in an
// unnamed namespace, so each library gets its own copy and no symbol (nor a
// function-local static) is shared between two loaded libraries.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr uint32_t kAtom = 64 * 64 * 2;  // a 64 x 64 bf16 swizzle atom

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// After one thread has initialised the block's barriers: makes them visible
// to the TMA unit (the async proxy).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Orders this thread's generic-proxy writes to shared memory before later
// `wgmma` / TMA (async-proxy) reads of it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One box of a 4-D tensor map into shared memory, completing on `bar`;
// coordinates innermost first.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// The box of a 3-D tensor map (the bias table) at (c0, c1, c2).
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// 2^x, the special function unit's approximation (-inf gives 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A `wgmma` shared-memory descriptor of a 128-byte swizzled operand at
// `addr`: `lbo` / `sbo` the leading / stride byte offsets.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
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

// Keeps the compiler from touching an accumulator across the asynchronous
// product: every read after this is ordered after the wait before it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d[64 x 64] (scale_d ? d : 0) + A B: A [64 x 16] and B [64 x 16] both
// K-major in shared memory (128-byte swizzle).
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] += A B: A [64 x 16] from registers (each warp holds its 16
// rows as the m16n8k16 A fragment), B [16 x 64] MN-major in shared memory
// (rows D-contiguous: the transpose bit; 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += A B: as wgmma_rs_m64n64, B [16 x 128] two atoms wide.
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x DP] += A B for DP = 64 or 128 (the head dim padded to atoms).
template <int DP>
__device__ __forceinline__ void wgmma_rs(float (&d)[DP / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DP == 64)
    wgmma_rs_m64n64(d, a, db);
  else
    wgmma_rs_m64n128(d, a, db);
}

// Fragment layout of a 64 x N `wgmma` accumulator: thread (warp w, lane l)
// holds element i of the rows w * 16 + l / 4 (+ 8 when i & 2) and the
// column (i / 4) * 8 + (l % 4) * 2 + (i & 1).
__device__ __forceinline__ int frag_col(int i, int lane) {
  return (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
}

// Four 8 x 8 bf16 matrices from shared memory, transposed
// (`ldmatrix.trans`): thread t gives the address of row t % 8 of matrix
// t / 8 (16 bytes), and r[j] receives the elements (2 (lane % 4), lane / 4)
// and (2 (lane % 4) + 1, lane / 4) of matrix j: the pair of a `wgmma`
// accumulator fragment whose rows are the matrix's columns.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ float2 bf16x2_float2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// The accumulator's 16-column block kk, rounded to bf16, as the A fragment
// of the next product's k-step kk.
__device__ __forceinline__ void pack_a(const float (&acc)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack_bf16(acc[8 * kk + 2 * j], acc[8 * kk + 2 * j + 1]);
}

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

// cuTensorMapEncodeTiled, looked up in libcuda at run time (the libraries
// link no -lcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [B, rows, H, D] bf16 tensor as a 4-D map (D, H, rows, B) with a box of
// 64 of D, one head and `box_rows` rows, 128-byte swizzled, zeros outside.
inline bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                     int B, int rows, int H, int D, int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 2ull * D;                  // bytes
  const cuuint64_t strides[3] = {row, row * H, row * H * rows};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The [H, T, S] bias table, rows `row` and heads `head` elements apart
// (multiples of 8: TMA's strides are multiples of 16 bytes), as a 3-D map
// (S, T, H) with a box of 64 keys, `box_rows` query rows and one head,
// 128-byte swizzled, zeros outside.
inline bool make_bias_map(EncodeTiled encode, CUtensorMap* map,
                          const void* ptr, int H, int T, int S, long long row,
                          long long head, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(H)};
  const cuuint64_t strides[2] = {2ull * row, 2ull * head};   // bytes
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Sets the dynamic shared memory a kernel may use, once per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool& done, uint32_t bytes) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e == cudaSuccess) done = true;
  return e;
}

}  // namespace
