// Attention of a few query tokens over the merged-lane KV cache, bf16 or
// int8, with a per-position mask: replaces three TPU kernels of
// mtasr_tpu/ops/pallas/decode_attention.py, one source with the cache type
// a compile-time switch:
//
//   L = 1, int8 cache       #6 `decode_attention_int8` / `_kernel_int8`
//   1 < L <= 16, bf16 cache #5 `decode_attention_chunk` / `_kernel_chunk`
//   1 < L <= 16, int8 cache #7 `decode_attention_int8_chunk` / `_kernel_int8_chunk`
//
// q [B, L, Hq, D] bf16; k_cache / v_cache [B, S, Hkv*D] bf16 or int8;
// kv_scale [B, 2*Hkv, S] bf16 (int8 only) with the rows of kv head h
// INTERLEAVED: k scales in row 2h, v scales in row 2h+1 (what
// mtasr_tpu/models/llama.py:258-262 writes and the TPU kernel reads at
// decode_attention.py:302-311; two docstrings there say "k rows then v
// rows", the code does not); mask [B, L, S] bool; out [B, L, Hq, D] bf16.
// The TPU kernels took q head-major ([B, Hkv*G*L, D]) so that each head's
// rows were one sublane slice, and #6 expanded q block-diagonally over all
// heads to feed its matrix unit one dot; a block here reads its G * L rows
// from q's own layout, so neither q nor out is transposed, and every int8
// product accumulates exactly in int32, so the per-head form computes the
// same function.
//
// bf16 (the TPU `_kernel_chunk`): s = q.k * D^-0.5 + (mask ? 0 : -1e9),
// f32 softmax, p rounded to bf16, out = p @ v in f32.
// int8 (the TPU `_kernel_int8` / `_kernel_int8_chunk`), per query row:
//   sq = max(max|q| / 127, 1e-12), q8 = clip(round(q / sq)),
//   s  = (q8 . k8) * (sq * D^-0.5) * ks + bias     (int32 product, exact),
//   p  = softmax(s) * vs,  sp = max(max p / 127, 1e-12), p8 = clip(round(p / sp)),
//   out = (p8 @ v8) * sp                             (int32 product, exact),
// each f32 step in the TPU kernel's order, without fused multiply-adds;
// x / 127 is x * f32(1 / 127), as XLA compiles the JAX kernel's division
// by that constant.
//
// On the H100 these are bound by reading the cache once (int8 at S = 214,
// B = 8, LLaMA-1B: 0.9 MB of K and V per layer) and, at these sizes, by
// launch latency, not by arithmetic. Design: one block per (batch row, kv
// head) reads that head's D-slice of the cache in place (no transpose, no
// head expansion, no dequantized copy) and serves its R = L * G query rows
// (G = Hq / Hkv). The int8 quantization of p needs the max of p over ALL S
// keys before any p is rounded, so the block keeps the R x S scores: pass 1
// (one key a thread) forms every row's scores, with `__dp4a` over packed
// int8 x 4 for the int8 cache; pass 2 (one warp a row) takes max, exp, sum
// and, for int8, the p scale and p8; pass 3 walks S once per chunk position
// with neighbouring threads on neighbouring 4-value words of v (coalesced
// rows), accumulating int32 (exact, so the cross-slice sum's order does not
// matter) or f32. The scores live in shared memory when 4 * (R * (S + D +
// 2) + 512 * G) bytes fit its 227 KB (S up to about 810 at L = 16, G = 4,
// D = 64); past that, in a global scratch buffer [B, Hkv, R, S] f32 that
// the caller passes, which the block alone reads and writes (L2-resident at
// these sizes), so no S is refused.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may use
constexpr float kInv127 = 1.f / 127.f;

// Dynamic shared memory of one block (the Python wrapper computes the same).
size_t smem_bytes(int G, int L, int S, int D, bool scores_in_smem) {
  const size_t R = static_cast<size_t>(G) * L;
  return 4 * (R * ((scores_in_smem ? S : 0) + D + 2) + 512 * static_cast<size_t>(G));
}

// round(x / s) clipped to [-127, 127]; rintf rounds half to even as
// jnp.round does.
__device__ __forceinline__ int quant8(float x, float s) {
  return static_cast<int>(fminf(fmaxf(rintf(x / s), -127.f), 127.f));
}

// Signed byte i of a packed word.
__device__ __forceinline__ int byte_at(int word, int i) {
  return (word << (24 - 8 * i)) >> 24;
}

template <bool INT8, int G>
__global__ void __launch_bounds__(kThreads)
cache_attn_kernel(const bf16* __restrict__ q, const void* __restrict__ k_cache,
                  const void* __restrict__ v_cache,
                  const bf16* __restrict__ kv_scale,
                  const unsigned char* __restrict__ mask,
                  bf16* __restrict__ out, float* __restrict__ scores, int L,
                  int S, int Hkv, int D, float scale) {
  using Acc = typename std::conditional<INT8, int, float>::type;
  extern __shared__ float smem[];
  const int R = G * L, W = D / 4;
  const int hk = blockIdx.x, b = blockIdx.y, Hq = Hkv * G;
  // [R][S] scores, then p (int8: p8 as floats): in shared memory, or in
  // this block's slice of the global scratch
  float* sc = scores ? scores + (static_cast<long long>(b) * Hkv + hk) * R * S
                     : smem;
  float* qs = scores ? smem : smem + R * S;  // [R][D] q as f32, or [R][W] packed int8 q
  float* sq = qs + R * D;    // [R] q scales (int8)
  float* sp = sq + R;        // [R] p scales (int8)
  Acc* red = reinterpret_cast<Acc*>(sp + R);  // [slices][G][D]
  int* q8 = reinterpret_cast<int*>(qs);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row = static_cast<long long>(Hkv) * D;
  const long long cache0 = static_cast<long long>(b) * S * row + hk * D;
  const unsigned char* mb = mask + static_cast<long long>(b) * L * S;
  const bf16* ksr = kv_scale + (static_cast<long long>(b) * 2 * Hkv + 2 * hk) * S;
  const bf16* vsr = ksr + S;
  // row r = l * G + g is query head hk * G + g at chunk position l
  auto at = [&](int r) {
    return (static_cast<long long>(b) * L + r / G) * Hq * D +
           static_cast<long long>(hk * G + r % G) * D;
  };

  // q: f32 copy, or per-row int8 quantization (one warp a row)
  if constexpr (INT8) {
    for (int r = warp; r < R; r += kWarps) {
      const bf16* qr = q + at(r);
      float amax = 0.f;
      for (int d = lane; d < D; d += 32)
        amax = fmaxf(amax, fabsf(__bfloat162float(qr[d])));
      const float s = fmaxf(__fmul_rn(warp_max(amax), kInv127), 1e-12f);
      for (int w = lane; w < W; w += 32) {
        int word = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          word |= (quant8(__bfloat162float(qr[4 * w + i]), s) & 0xff) << (8 * i);
        q8[r * W + w] = word;
      }
      if (lane == 0) sq[r] = s;
    }
  } else {
    for (int i = tid; i < R * D; i += kThreads)
      qs[i] = __bfloat162float(q[at(i / D) + i % D]);
  }
  __syncthreads();

  // pass 1: scores, one key a thread
  for (int s = tid; s < S; s += kThreads) {
    const long long k0 = cache0 + s * row;
    for (int l = 0; l < L; ++l) {
      const float bias = mb[l * S + s] ? 0.f : -1e9f;
      float val[G];
      if constexpr (INT8) {
        const int* kr = reinterpret_cast<const int*>(
            static_cast<const int8_t*>(k_cache) + k0);
        const float ks = __bfloat162float(ksr[s]);
        int acc[G];
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] = 0;
        for (int w = 0; w < W; ++w) {
          const int kw = kr[w];
#pragma unroll
          for (int g = 0; g < G; ++g)
            acc[g] = __dp4a(q8[(l * G + g) * W + w], kw, acc[g]);
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
          val[g] = __fadd_rn(
              __fmul_rn(__fmul_rn(static_cast<float>(acc[g]),
                                  __fmul_rn(sq[l * G + g], scale)),
                        ks),
              bias);
      } else {
        const bf16* kr = static_cast<const bf16*>(k_cache) + k0;
        float acc[G];
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] = 0.f;
        for (int d = 0; d < D; d += 2) {
          const float2 kk = load2(kr + d);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float* qr = qs + (l * G + g) * D + d;
            acc[g] = fmaf(qr[1], kk.y, fmaf(qr[0], kk.x, acc[g]));
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
          val[g] = __fadd_rn(__fmul_rn(acc[g], scale), bias);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) sc[(l * G + g) * S + s] = val[g];
    }
  }
  __syncthreads();

  // pass 2: softmax over all S keys, one warp a row; int8 quantizes p
  for (int r = warp; r < R; r += kWarps) {
    float* x = sc + r * S;
    float m = -INFINITY;
    for (int s = lane; s < S; s += 32) m = fmaxf(m, x[s]);
    m = warp_max(m);
    float sum = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float e = expf(x[s] - m);
      x[s] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if constexpr (INT8) {
      float pmax = 0.f;
      for (int s = lane; s < S; s += 32) {
        const float p = __fmul_rn(x[s] / sum, __bfloat162float(vsr[s]));
        x[s] = p;
        pmax = fmaxf(pmax, p);
      }
      const float step = fmaxf(__fmul_rn(warp_max(pmax), kInv127), 1e-12f);
      for (int s = lane; s < S; s += 32)
        x[s] = static_cast<float>(quant8(x[s], step));
      if (lane == 0) sp[r] = step;
    } else {
      for (int s = lane; s < S; s += 32) x[s] = round_bf16(x[s] / sum);
    }
  }
  __syncthreads();

  // pass 3: p @ v per chunk position; a thread owns 4 neighbouring values
  const int slices = kThreads / W, w = tid % W, sl = tid / W;
  for (int l = 0; l < L; ++l) {
    if (sl < slices) {
      Acc acc[G][4];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[g][i] = 0;
      for (int s = sl; s < S; s += slices) {
        const long long v0 = cache0 + s * row + 4 * w;
        Acc vv[4];
        if constexpr (INT8) {
          const int word = *reinterpret_cast<const int*>(
              static_cast<const int8_t*>(v_cache) + v0);
#pragma unroll
          for (int i = 0; i < 4; ++i) vv[i] = byte_at(word, i);
        } else {
          const bf16* vr = static_cast<const bf16*>(v_cache) + v0;
          const float2 a = load2(vr), c = load2(vr + 2);
          vv[0] = a.x;
          vv[1] = a.y;
          vv[2] = c.x;
          vv[3] = c.y;
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = sc[(l * G + g) * S + s];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if constexpr (INT8)
              acc[g][i] += static_cast<int>(p) * vv[i];
            else
              acc[g][i] = fmaf(p, vv[i], acc[g][i]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i) red[(sl * G + g) * D + 4 * w + i] = acc[g][i];
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i - g * D, r = l * G + g;
      Acc t = 0;
      for (int j = 0; j < slices; ++j) t += red[(j * G + g) * D + d];
      float o;
      if constexpr (INT8)
        o = __fmul_rn(static_cast<float>(t), sp[r]);
      else
        o = t;
      out[at(r) + d] = __float2bfloat16(o);
    }
    __syncthreads();
  }
}

template <bool INT8, int G>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_scale, const void* mask, void* out,
                   float* scores, int B, int L, int S, int Hkv, int D,
                   float scale, cudaStream_t stream) {
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        cache_attn_kernel<INT8, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kMaxSmem));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid(Hkv, B);
  cache_attn_kernel<INT8, G>
      <<<grid, kThreads, smem_bytes(G, L, S, D, scores == nullptr), stream>>>(
          static_cast<const bf16*>(q), k, v, static_cast<const bf16*>(kv_scale),
          static_cast<const unsigned char*>(mask), static_cast<bf16*>(out),
          scores, L, S, Hkv, D, scale);
  return cudaGetLastError();
}

// G = Hq / Hkv in [1, 8]; D a multiple of 4 in [4, 256]; L >= 1; without
// `scores`, the R x S scores must fit the shared memory.
template <bool INT8>
int dispatch(const void* q, const void* k, const void* v, const void* kv_scale,
             const void* mask, void* out, float* scores, int B, int L, int S,
             int Hq, int Hkv, int D, float scale, void* stream) {
  if (D % 4 != 0 || D < 4 || D > 256 || Hkv <= 0 || Hq % Hkv != 0 || L < 1 ||
      S < 1 || B < 1 ||
      smem_bytes(Hq / Hkv, L, S, D, scores == nullptr) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Hq / Hkv) {
#define MTASR_CACHE_ATTN_CASE(G)                                                \
  case G:                                                                       \
    return static_cast<int>(launch<INT8, G>(q, k, v, kv_scale, mask, out,       \
                                            scores, B, L, S, Hkv, D, scale, st));
    MTASR_CACHE_ATTN_CASE(1)
    MTASR_CACHE_ATTN_CASE(2)
    MTASR_CACHE_ATTN_CASE(3)
    MTASR_CACHE_ATTN_CASE(4)
    MTASR_CACHE_ATTN_CASE(5)
    MTASR_CACHE_ATTN_CASE(6)
    MTASR_CACHE_ATTN_CASE(7)
    MTASR_CACHE_ATTN_CASE(8)
#undef MTASR_CACHE_ATTN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

MTASR_EXPORT_ERROR_STRING

// int8 != 0: the int8 cache with its scales (#6 at L = 1, #7); else bf16
// (#5, kv_scale unused). scores: a [B, Hkv, L * Hq / Hkv, S] f32 scratch
// for the scores, or null to keep them in shared memory.
extern "C" int decode_attention_chunk_launch(int int8, const void* q,
                                             const void* k_cache,
                                             const void* v_cache,
                                             const void* kv_scale,
                                             const void* mask, void* out,
                                             void* scores, int B, int L, int S,
                                             int Hq, int Hkv, int D,
                                             float scale, void* stream) {
  float* sc = static_cast<float*>(scores);
  if (int8)
    return dispatch<true>(q, k_cache, v_cache, kv_scale, mask, out, sc, B, L,
                          S, Hq, Hkv, D, scale, stream);
  return dispatch<false>(q, k_cache, v_cache, kv_scale, mask, out, sc, B, L, S,
                         Hq, Hkv, D, scale, stream);
}
