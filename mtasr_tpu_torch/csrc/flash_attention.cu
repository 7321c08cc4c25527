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
// tiles covers both. On the H100 the encoder's attention (T = S = 499,
// H = 16, D = 64) is bound by the score work and by the [H, T, S] bias
// table, which every batch row reads again; composing gate * pos_bias in the
// kernel keeps the [B, H, T, S] gated bias out of device memory. Design: one
// block of 4 warps per (64-query tile, head, batch row); Q, K, V tiles are
// staged in shared memory and both products run on the tensor cores through
// WMMA (bf16 in, f32 accumulate). Each warp owns 16 query rows and keeps
// their running max / sum; the f32 output accumulator lives in shared
// memory so the online-softmax rescale is a plain per-row multiply. K and V
// rows at or past kv_len are zero-filled before the products (0 x NaN in
// stale slots would otherwise poison p @ v) and key tiles past kv_len are
// skipped. wgmma/TMA pipelines are later work.
#include <mma.h>

#include "common.cuh"
#include "flash_tile.cuh"

using namespace nvcuda;

namespace {

constexpr int kBM = 64;  // query rows per block
constexpr int kBN = 64;  // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <int DP>
struct Layout {  // shared memory; leading dims padded against bank conflicts
  static constexpr int LDQ = DP + 8;   // bf16 q / k / v rows
  static constexpr int LDP = kBN + 8;  // bf16 probabilities
  static constexpr int LDS = kBN + 4;  // f32 scores
  static constexpr int LDO = DP + 4;   // f32 output accumulator
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(bf16) * kBM * LDQ;
  static constexpr size_t v = k + sizeof(bf16) * kBN * LDQ;
  static constexpr size_t p = v + sizeof(bf16) * kBN * LDQ;
  static constexpr size_t s = p + sizeof(bf16) * kBM * LDP;
  static constexpr size_t o = s + sizeof(float) * kBM * LDS;
  static constexpr size_t m = o + sizeof(float) * kBM * LDO;
  static constexpr size_t l = m + sizeof(float) * kBM;
  static constexpr size_t bytes = l + sizeof(float) * kBM;
};

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v,
                 const bf16* __restrict__ pos_bias,
                 const bf16* __restrict__ gate,
                 const int* __restrict__ kv_lens, bf16* __restrict__ out,
                 float* __restrict__ lse, int T, int S, int Hq, int Hkv,
                 int D, float scale, int has_bias) {
  using L = Layout<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem + L::q);
  bf16* k_s = reinterpret_cast<bf16*>(smem + L::k);
  bf16* v_s = reinterpret_cast<bf16*>(smem + L::v);
  bf16* p_s = reinterpret_cast<bf16*>(smem + L::p);
  float* s_s = reinterpret_cast<float*>(smem + L::s);
  float* o_s = reinterpret_cast<float*>(smem + L::o);
  float* m_s = reinterpret_cast<float*>(smem + L::m);
  float* l_s = reinterpret_cast<float*>(smem + L::l);

  const int q0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kv_len = min(max(kv_lens[b], 0), S);
  const long long q_stride = static_cast<long long>(Hq) * D;
  const long long kv_stride = static_cast<long long>(Hkv) * D;
  const bf16* k_b = k + (static_cast<long long>(b) * S * Hkv + hk) * D;
  const bf16* v_b = v + (static_cast<long long>(b) * S * Hkv + hk) * D;
  const bf16* pb_h = pos_bias + static_cast<long long>(h) * T * S;
  const bf16* g_bh = gate + (static_cast<long long>(b) * Hq + h) * T;

  load_rows<DP, kThreads>(q_s, L::LDQ,
                q + (static_cast<long long>(b) * T * Hq + h) * D, q_stride,
                q0, T, D);
  for (int i = threadIdx.x; i < kBM * L::LDO; i += kThreads) o_s[i] = 0.f;
  if (threadIdx.x < kBM) {
    m_s[threadIdx.x] = -INFINITY;
    l_s[threadIdx.x] = 0.f;
  }
  __syncthreads();

  for (int n0 = 0; n0 < kv_len; n0 += kBN) {
    load_rows<DP, kThreads>(k_s, L::LDQ, k_b, kv_stride, n0, kv_len, D);
    load_rows<DP, kThreads>(v_s, L::LDQ, v_b, kv_stride, n0, kv_len, D);
    __syncthreads();

    // scores of this warp's 16 query rows against the tile's kBN keys
#pragma unroll
    for (int nc = 0; nc < kBN / 16; ++nc) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kc = 0; kc < DP / 16; ++kc) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kt;
        wmma::load_matrix_sync(a, q_s + warp * 16 * L::LDQ + kc * 16, L::LDQ);
        wmma::load_matrix_sync(kt, k_s + nc * 16 * L::LDQ + kc * 16, L::LDQ);
        wmma::mma_sync(acc, a, kt, acc);
      }
      wmma::store_matrix_sync(s_s + warp * 16 * L::LDS + nc * 16, acc,
                              L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over the tile, one row at a time across the warp
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r, qi = q0 + row;
      const bool bias_row = has_bias && qi < T;
      const float g = bias_row ? __bfloat162float(g_bh[qi]) : 0.f;
      float sv[kBN / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kBN / 32; ++c) {
        const int col = lane + 32 * c, kj = n0 + col;
        float s = s_s[row * L::LDS + col] * scale;
        if (bias_row && kj < kv_len)
          s += g * __bfloat162float(pb_h[static_cast<long long>(qi) * S + kj]);
        sv[c] = kj < kv_len ? s : -INFINITY;
        mx = fmaxf(mx, sv[c]);
      }
      mx = warp_max(mx);  // finite: key n0 < kv_len is valid
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, mx);
      const float corr = expf(m_old - m_new);  // 0 on the first tile
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < kBN / 32; ++c) {
        const float p = expf(sv[c] - m_new);
        ps += p;
        p_s[row * L::LDP + lane + 32 * c] = __float2bfloat16(p);
      }
      ps = warp_sum(ps);
      for (int d = lane; d < DP; d += 32) o_s[row * L::LDO + d] *= corr;
      __syncwarp();  // all lanes read m_s[row] before lane 0 rewrites it
      if (lane == 0) {
        m_s[row] = m_new;
        l_s[row] = l_s[row] * corr + ps;
      }
    }
    __syncwarp();

    // o += p @ v for this warp's rows
#pragma unroll
    for (int dc = 0; dc < DP / 16; ++dc) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, o_s + warp * 16 * L::LDO + dc * 16, L::LDO,
                             wmma::mem_row_major);
#pragma unroll
      for (int kc = 0; kc < kBN / 16; ++kc) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(a, p_s + warp * 16 * L::LDP + kc * 16, L::LDP);
        wmma::load_matrix_sync(vb, v_s + kc * 16 * L::LDQ + dc * 16, L::LDQ);
        wmma::mma_sync(acc, a, vb, acc);
      }
      wmma::store_matrix_sync(o_s + warp * 16 * L::LDO + dc * 16, acc,
                              L::LDO, wmma::mem_row_major);
    }
    __syncthreads();  // k_s / v_s are refilled by the next tile
  }

  for (int r = 0; r < 16; ++r) {
    const int row = warp * 16 + r, qi = q0 + row;
    if (qi >= T) break;
    const float l = l_s[row];
    const float denom = l == 0.f ? 1.f : l;
    if (lse != nullptr && lane == 0)
      lse[(static_cast<long long>(b) * Hq + h) * T + qi] =
          l == 0.f ? kNegInf : m_s[row] + logf(fmaxf(l, 1e-30f));
    bf16* orow = out + ((static_cast<long long>(b) * T + qi) * Hq + h) * D;
    for (int d = lane; d < D; d += 32)
      orow[d] = __float2bfloat16(o_s[row * L::LDO + d] / denom);
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* pos_bias, const void* gate,
                   const void* kv_lens, void* out, void* lse, int B, int T,
                   int S, int Hq, int Hkv, int D, float scale, int has_bias,
                   cudaStream_t stream) {
  using L = Layout<DP>;
  auto kern = flash_fwd_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kBM - 1) / kBM, Hq, B);
  kern<<<grid, kThreads, L::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(pos_bias),
      static_cast<const bf16*>(gate), static_cast<const int*>(kv_lens),
      static_cast<bf16*>(out), static_cast<float*>(lse), T, S, Hq, Hkv, D,
      scale, has_bias);
  return cudaGetLastError();
}

}  // namespace

MTASR_EXPORT_ERROR_STRING

// D % 8 == 0 and D <= 128; pos_bias / gate may be null when has_bias == 0,
// lse when the caller needs no backward.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const void* pos_bias,
                                      const void* gate, const void* kv_lens,
                                      void* out, void* lse, int B, int T,
                                      int S, int Hq, int Hkv, int D,
                                      float scale, int has_bias,
                                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 8 != 0 || D > 128 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      D <= 64 ? launch<64>(q, k, v, pos_bias, gate, kv_lens, out, lse, B, T,
                           S, Hq, Hkv, D, scale, has_bias, st)
              : launch<128>(q, k, v, pos_bias, gate, kv_lens, out, lse, B, T,
                            S, Hq, Hkv, D, scale, has_bias, st);
  return static_cast<int>(err);
}
