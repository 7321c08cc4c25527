// Flash attention forward with the WavLM gated relative-position bias.
//
//   out[b, i, h] = sum_j softmax_j(q_i . k_j * scale + gate[b, h, i] *
//                                  pos_bias[h, i, j]) v_j,   j < kv_lens[b]
//
// q [B, T, Hq, D], k/v [B, S, Hkv, D] bf16 (Hq % Hkv == 0, GQA by head
// index), pos_bias [Hq, T, S] bf16, gate [B, Hq, T] bf16, kv_lens [B] int32.
// Output [B, T, Hq, D] bf16. A row with kv_len = 0 gets zeros. With a
// non-null `lse`, also the logsumexp of each query row's scores [B*Hq, T]
// f32 for the backward kernels (flash_attention_bwd.cu): m + log(l), as the
// JAX forwards write it (flash_attention.py:110-112, :175-177), and -1e30
// for a row with no valid key. The JAX one-block path folds a power-of-two
// scale into q; the product q.k * scale is then the same f32 number, so the
// lse is too.
//
// Replaces the TPU kernels `_flash_forward_1s` / `_flash_kernel_1s` (one key
// block, S <= 512) and `_flash_forward` / `_flash_kernel` (tiled online
// softmax) of mtasr_tpu/ops/pallas/flash_attention.py; one loop over key
// tiles covers both.
//
// What bounds it on the H100: the encoder's attention (B = 8, T = S = 499,
// 16 heads of 64) moves 41 MB (q, k, v, out and the [H, T, S] bias table)
// and does 7.8 GFLOP: a 0.012 ms byte bound, 0.008 ms of bf16 tensor-core
// time, and 32 M exponentials. A kernel whose steps run in series (loads,
// then scores through shared memory, then a row-by-row softmax) stalls on
// each and lands far from that, behind SDPA. This design keeps the steps
// off each other's critical path:
//
// - two consumer warpgroups (4 warps each) per block own 64 query rows
//   each of one (batch row, head) and share the K / V tiles; both products
//   are Hopper `wgmma.mma_async`: S = Q K^T with Q and K from shared memory
//   (K-major, as their rows are D-contiguous), and O += P V with P from
//   REGISTERS and V from shared memory through the transpose bit (V's rows
//   are D-contiguous, MN-major for this operand);
// - the f32 score accumulator of the first product, exponentiated and
//   rounded to bf16, is already laid out as the A fragment of the second
//   (each thread packs its pairs), so P never touches shared memory; the
//   row max and sum are shuffles over the 4 threads that share a row; m, l
//   and the O accumulator stay in registers, rescaled by a register
//   multiply; scores are kept in log2 units so that each exponential is
//   one `ex2`, and the kv_len mask is applied on the last tile only;
// - Q and a ring of 2 stages of K, V and the bias tile are filled by TMA
//   (4-D maps over (D, H, rows, B), boxes of 64 columns, 128-byte swizzle
//   matching the `wgmma` descriptors; D <= 64 reads zeros past D and a tile
//   past T or S reads zeros, from TMA's out-of-bounds fill) on `mbarrier`s
//   with `expect_tx`: one thread issues tile t + 2 as soon as tile t is
//   consumed, so the next tiles' copies overlap this tile's math;
// - the [H, T, S] bias table comes through a 3-D map too. TMA needs global
//   strides of 16 bytes, and a row of S = 499 bf16 is 998: WavLM builds the
//   table once a forward with its rows padded to a multiple of 8 elements
//   and passes that view and its strides (`padded_bias` in the wrapper,
//   which pads any other table). Each thread reads its bias pairs from the
//   swizzled tile in the accumulator's layout and adds gate * bias in f32;
//   the 8 MB table stays in L2 across batch rows and layers;
// - TMA's zero fill stops at the tensor's edge, so K and V rows between
//   kv_len and S arrive with whatever the tensor holds there: the last
//   partial tile's rows past kv_len are zeroed in shared memory before the
//   products (0 x NaN in a stale slot would poison P V), scores at or past
//   kv_len are -inf, and key tiles wholly past kv_len are not loaded.
//
// Tried and measured slower on the H100: FlashAttention-3's overlap of one
// tile's P V with the next tile's softmax inside a warpgroup (ptxas
// serialises the `wgmma`s or the extra registers cost occupancy).
#include <cuda.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include "common.cuh"
#include "flash_tile.cuh"

namespace {

constexpr int kWG = 2;        // consumer warpgroups of a block
constexpr int kBM = 64 * kWG; // query rows of a block: 64 a warpgroup
constexpr int kBN = 64;       // keys of a tile
constexpr int kThreads = 128 * kWG;
constexpr int kStages = 2;    // K / V tiles in flight
constexpr uint32_t kAtom = 64 * 64 * 2;  // a 64 x 64 bf16 swizzle atom

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of one block, past a 1024-byte aligned base (the 128-byte
// swizzle repeats every 1024 bytes): q [kBM rows][DP] as DP / 64 column
// blocks of kBM rows of 128 bytes; then each stage's K and V, each a [64
// rows][DP] tile of DP / 64 atoms, and its [kBM queries][64 keys] bias
// tile; then the stages' barriers and q's.
template <int DP>
struct Smem {
  static constexpr uint32_t tile = DP / 64 * kAtom;
  static constexpr uint32_t q_cols = kWG * kAtom;     // a 64-column block of q
  static constexpr uint32_t q = 0;
  static constexpr uint32_t stage = 2 * tile + kWG * kAtom;  // K, V, bias
  static constexpr uint32_t kv = q + kWG * tile;  // stage s at kv + s * stage
  static constexpr uint32_t bar = kv + kStages * stage;
  static constexpr uint32_t bytes = bar + 8 * (kStages + 1) + 1024;
};

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

// d[64 x 64] (scale_d ? d : 0) + A B: A [64 x 16] and B [64 keys x 16]
// both K-major in shared memory (128-byte swizzle).
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
// rows as the m16n8k16 A fragment), B [16 keys x 64] MN-major in shared
// memory (V's rows, D-contiguous: the transpose bit; 128-byte swizzle).
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

// d[64 x 128] += A B: A [64 x 16] from registers (each warp holds its 16
// rows as the m16n8k16 A fragment), B [16 keys x 128] MN-major in shared
// memory (V's rows, D-contiguous: the transpose bit; 128-byte swizzle).
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

// Fragment layout of a 64 x N `wgmma` accumulator: thread (warp w, lane l)
// holds element i of the rows w * 16 + l / 4 (+ 8 when i & 2) and the
// column (i / 4) * 8 + (l % 4) * 2 + (i & 1).
__device__ __forceinline__ int frag_col(int i, int lane) {
  return (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const __grid_constant__ CUtensorMap b_map,
                 const bf16* __restrict__ gate,
                 const int* __restrict__ kv_lens, bf16* __restrict__ out,
                 float* __restrict__ lse, int T, int S, int Hq, int Hkv,
                 int D, float scale, int has_bias) {
  using L = Smem<DP>;
  constexpr int kAtoms = DP / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t q_s = base + L::q;
  const uint32_t bar0 = base + L::bar;          // stage s: bar0 + 8 * s
  const uint32_t q_bar = bar0 + 8 * kStages;

  const int q0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kv_len = min(max(kv_lens[b], 0), S);
  const int n_tiles = (kv_len + kBN - 1) / kBN;

  // K, V and the bias of tile t into stage s (one thread)
  auto load_stage = [&](int t, int s) {
    const uint32_t bar = bar0 + 8 * s;
    const uint32_t k_s = base + L::kv + s * L::stage;
    mbar_expect_tx(bar, 2 * L::tile + (has_bias ? kWG * kAtom : 0));
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
      tma_load(k_s + a * kAtom, &k_map, bar, a * 64, hk, t * kBN, b);
      tma_load(k_s + L::tile + a * kAtom, &v_map, bar, a * 64, hk, t * kBN, b);
    }
    if (has_bias) tma_load_3d(k_s + 2 * L::tile, &b_map, bar, t * kBN, q0, h);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bar0 + 8 * s, 1);
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (n_tiles > 0) {
      mbar_expect_tx(q_bar, kWG * L::tile);
#pragma unroll
      for (int a = 0; a < kAtoms; ++a)
        tma_load(q_s + a * L::q_cols, &q_map, q_bar, a * 64, h, q0, b);
      for (int t = 0; t < min(n_tiles, kStages); ++t) load_stage(t, t);
    }
  }
  __syncthreads();

  // this thread's two rows (r0 and r0 + 8 of the block) and their gates,
  // in log2 units: scores are kept as log2(e) times their value, so that
  // each exponential is one `ex2`
  const int wg = warp >> 2;    // this thread's warpgroup: rows 64 wg ..
  const int r0 = warp * 16 + (lane >> 2);
  const int qi[2] = {q0 + r0, q0 + r0 + 8};
  const float scale2 = scale * kLog2e;
  float g2[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2; ++j)
    if (has_bias && qi[j] < T)
      g2[j] = kLog2e * __bfloat162float(
                           gate[(static_cast<long long>(b) * Hq + h) * T +
                                qi[j]]);
  // byte offset of this thread's bias pair i in a 128-byte swizzled tile:
  // row r0 (+ 8), 16-byte chunk (i / 4) XOR (row % 8), word lane % 4
  auto bias_at = [&](int i) {
    return (r0 + 8 * ((i >> 1) & 1)) * 128 + (((i >> 2) ^ (lane >> 2)) << 4) +
           (lane & 3) * 4;
  };

  float o[DP / 2];
  float sc[kBN / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  if (n_tiles > 0) mbar_wait(q_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages, n0 = t * kBN;
    const uint32_t k_s = base + L::kv + s * L::stage;
    const uint32_t v_s = k_s + L::tile;
    const unsigned char* b_s = smem + L::kv + s * L::stage + 2 * L::tile;
    mbar_wait(bar0 + 8 * s, (t / kStages) & 1);
    const int valid = kv_len - n0;             // keys of this tile < kv_len
    if (valid < kBN) {
      // the last tile: K and V rows past kv_len hold what the tensor holds
      // there; a row of an atom is 128 bytes whatever the swizzle
      const int chunks = (kBN - valid) * 8;
      uint4* kv = reinterpret_cast<uint4*>(smem + L::kv + s * L::stage);
      for (int i = tid; i < 2 * kAtoms * chunks; i += kThreads) {
        const int atom = i / chunks, c = i - atom * chunks;
        kv[atom * (kAtom / 16) + valid * 8 + c] = make_uint4(0u, 0u, 0u, 0u);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }

    // S = Q K^T, 4 k-steps of 16 a 64-column atom
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t col = (kk & 3) * 32;
      wgmma_ss_m64n64(
          sc,
          desc_sw128(q_s + (kk >> 2) * L::q_cols + wg * kAtom + col, 16,
                     1024),
          desc_sw128(k_s + (kk >> 2) * kAtom + col, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(sc);

    // online softmax in registers (log2 units); a row's 64 scores are
    // spread over the 4 threads of a quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kBN / 2; i += 2) {
      const int r = (i >> 1) & 1;
      float2 x = make_float2(sc[i] * scale2, sc[i + 1] * scale2);
      if (has_bias) {
        const float2 pb = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(b_s + bias_at(i)));
        x.x = fmaf(g2[r], pb.x, x.x);
        x.y = fmaf(g2[r], pb.y, x.y);
      }
      if (valid < kBN) {
        const int j = n0 + frag_col(i, lane);
        x.x = j < kv_len ? x.x : -INFINITY;
        x.y = j + 1 < kv_len ? x.y : -INFINITY;
      }
      sc[i] = x.x;
      sc[i + 1] = x.y;
      mx[r] = fmaxf(mx[r], fmaxf(x.x, x.y));
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // finite: key n0 is valid
      corr[r] = ex2(m[r] - m_new);             // 0 on the first tile
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = ex2(sc[i] - m[r]);
      sum[r] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= corr[(i >> 1) & 1];

    // O += P V: the accumulator's k-th 16 columns are the A fragment of
    // the k-th 16 keys
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t dv = desc_sw128(v_s + kk * 16 * 128, kAtom, 1024);
      if constexpr (DP == 64)
        wgmma_rs_m64n64(o, pa[kk], dv);
      else
        wgmma_rs_m64n128(o, pa[kk], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(o);

    __syncthreads();                 // every warp is done with stage s
    if (tid == 0 && t + kStages < n_tiles) load_stage(t + kStages, s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= T) continue;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    if (lse != nullptr && (lane & 3) == 0)
      lse[(static_cast<long long>(b) * Hq + h) * T + qi[r]] =
          l[r] == 0.f ? kNegInf
                      : (m[r] + log2f(fmaxf(l[r], 1e-30f))) * kLn2;
    bf16* orow = out + ((static_cast<long long>(b) * T + qi[r]) * Hq + h) * D;
#pragma unroll
    for (int i = 2 * r; i < DP / 2; i += 4) {
      const int c = frag_col(i, lane);
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + c) =
            __floats2bfloat162_rn(o[i] * inv, o[i + 1] * inv);
    }
  }
}

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

// cuTensorMapEncodeTiled, looked up in libcuda at run time (the library
// links no -lcuda).
EncodeTiled encode_tiled() {
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
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B,
              int rows, int H, int D, int box_rows) {
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
// (S, T, H) with a box of 64 keys, kBM query rows and one head, 128-byte
// swizzled, zeros outside.
bool make_bias_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                   int H, int T, int S, long long row, long long head) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(H)};
  const cuuint64_t strides[2] = {2ull * row, 2ull * head};   // bytes
  const cuuint32_t box[3] = {64, kBM, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* pos_bias, const void* gate,
                   const void* kv_lens, void* out, void* lse, int B, int T,
                   int S, int Hq, int Hkv, int D, float scale, int has_bias,
                   long long bias_row, long long bias_head,
                   cudaStream_t stream) {
  using L = Smem<DP>;
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::bytes));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap q_map, k_map, v_map, b_map = {};
  if (!make_map(encode, &q_map, q, B, T, Hq, D, kBM) ||
      !make_map(encode, &k_map, k, B, S, Hkv, D, kBN) ||
      !make_map(encode, &v_map, v, B, S, Hkv, D, kBN) ||
      (has_bias && !make_bias_map(encode, &b_map, pos_bias, Hq, T, S,
                                  bias_row, bias_head)))
    return cudaErrorInvalidValue;
  const dim3 grid((T + kBM - 1) / kBM, Hq, B);
  flash_fwd_kernel<DP><<<grid, kThreads, L::bytes, stream>>>(
      q_map, k_map, v_map, b_map, static_cast<const bf16*>(gate),
      static_cast<const int*>(kv_lens), static_cast<bf16*>(out),
      static_cast<float*>(lse), T, S, Hq, Hkv, D, scale, has_bias);
  return cudaGetLastError();
}

}  // namespace

MTASR_EXPORT_ERROR_STRING

// D % 8 == 0 and D <= 128; q, k, v and pos_bias 16-byte aligned; pos_bias
// rows bias_row and heads bias_head elements apart (multiples of 8);
// pos_bias / gate may be null when has_bias == 0, lse when the caller
// needs no backward.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const void* pos_bias,
                                      const void* gate, const void* kv_lens,
                                      void* out, void* lse, int B, int T,
                                      int S, int Hq, int Hkv, int D,
                                      float scale, int has_bias,
                                      long long bias_row, long long bias_head,
                                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 8 != 0 || D > 128 || D < 8 || Hkv <= 0 || Hq % Hkv != 0 ||
      B < 1 || T < 1 || S < 1 ||
      (has_bias && (bias_row % 8 != 0 || bias_head % 8 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      D <= 64 ? launch<64>(q, k, v, pos_bias, gate, kv_lens, out, lse, B, T,
                           S, Hq, Hkv, D, scale, has_bias, bias_row,
                           bias_head, st)
              : launch<128>(q, k, v, pos_bias, gate, kv_lens, out, lse, B, T,
                            S, Hq, Hkv, D, scale, has_bias, bias_row,
                            bias_head, st);
  return static_cast<int>(err);
}
