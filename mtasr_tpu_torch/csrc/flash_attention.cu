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
#include "common.cuh"
#include "hopper.cuh"

namespace {

// The logsumexp of a row with no valid key (the JAX kernels' NEG_INF).
constexpr float kNegInf = -1e30f;

constexpr int kWG = 2;        // consumer warpgroups of a block
constexpr int kBM = 64 * kWG; // query rows of a block: 64 a warpgroup
constexpr int kBN = 64;       // keys of a tile
constexpr int kThreads = 128 * kWG;
constexpr int kStages = 2;    // K / V tiles in flight

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
    mbar_fence_init();
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
      fence_proxy_async();
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
    pack_a(sc, pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_rs<DP>(o, pa[kk], desc_sw128(v_s + kk * 16 * 128, kAtom, 1024));
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

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* pos_bias, const void* gate,
                   const void* kv_lens, void* out, void* lse, int B, int T,
                   int S, int Hq, int Hkv, int D, float scale, int has_bias,
                   long long bias_row, long long bias_head,
                   cudaStream_t stream) {
  using L = Smem<DP>;
  static bool attr_set = false;  // once per instantiation
  const cudaError_t e = allow_smem(flash_fwd_kernel<DP>, attr_set, L::bytes);
  if (e != cudaSuccess) return e;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap q_map, k_map, v_map, b_map = {};
  if (!make_map(encode, &q_map, q, B, T, Hq, D, kBM) ||
      !make_map(encode, &k_map, k, B, S, Hkv, D, kBN) ||
      !make_map(encode, &v_map, v, B, S, Hkv, D, kBN) ||
      (has_bias && !make_bias_map(encode, &b_map, pos_bias, Hq, T, S,
                                  bias_row, bias_head, kBM)))
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
