// Attention of a few query tokens over the merged-lane KV cache, bf16 or
// int8, with a per-position mask: replaces two TPU kernels of
// mtasr_tpu/ops/pallas/decode_attention.py, one library, two kernels:
//
//   1 < L <= 16, int8 cache #7 `decode_attention_int8_chunk` / `_kernel_int8_chunk`
//   1 < L <= 16, bf16 cache #5 `decode_attention_chunk` / `_kernel_chunk`
//
// (#7: `cache_attn_kernel`, which takes any L >= 1; #5:
// `chunk_bf16_kernel`. The one-token int8 kernel #6 is
// decode_attention_int8.cu, split over a thread-block cluster.)
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
// bf16 (the TPU `_kernel_chunk`): s = q.k * D^-0.5 + (mask ? 0 : -1e9) in
// f32 (masked keys stay in the sum, so a fully masked row gives the mean of
// v), p = bf16(exp(s - max) / sum), normalised before it is rounded,
// out = p @ v in f32.
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
// B = 8, LLaMA-1B: 0.9 MB of K and V per layer; bf16 at the served short
// prefill, S = 158: 2.6 MB, a 0.001 ms bound) and, at these sizes, by the
// latency of their chain of dependent steps, not by arithmetic. Both read
// a (batch row, kv head)'s D-slice of the cache in place (no transpose, no
// head expansion, no dequantized copy) in one block that serves its
// R = L * G query rows (G = Hq / Hkv).
//
// int8: the quantization of p needs the max of p over ALL S keys before any
// p is rounded, so the block keeps the R x S scores: pass 1 (one key a
// thread) forms every row's scores with `__dp4a` over packed int8 x 4;
// pass 2 (one warp a row) takes max, exp, sum, the p scale and p8; pass 3
// walks S once per chunk position with neighbouring threads on neighbouring
// 4-value words of v (coalesced rows), accumulating int32 (exact, so the
// cross-slice sum's order does not matter). The scores live in shared
// memory when 4 * (R * (S + D + 2) + 512 * G) bytes fit its 227 KB (S up
// to about 810 at L = 16, G = 4, D = 64); past that, in a global scratch
// buffer [B, Hkv, R, S] f32 that the caller passes, which the block alone
// reads and writes (L2-resident at these sizes), so no S is refused.
//
// bf16: the tensor cores through `mma.sync.m16n8k16` (bf16 in, f32
// accumulate). `wgmma` takes 64 rows at least: at the served R = 32 it
// would double the work of a kernel whose time is its latency chain, not
// its rate, and its asynchronous pipeline buys nothing on 10 key tiles. The
// keys are split across the 4 warps, each staging its 16-key K / V tiles
// with `cp.async` in a double buffer of its own, V read back through
// `ldmatrix.trans`; scores stay in registers (no shared or global score
// buffer at any S), and the exact normalisation costs two block barriers:
// one to combine the warps' row max and sum, one to sum their partial
// outputs (`chunk_bf16_kernel`'s note has the passes).
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
  static_assert(INT8, "the bf16 cache runs chunk_bf16_kernel");
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
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = sc[(l * G + g) * S + s];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if constexpr (INT8)
              acc[g][i] += static_cast<int>(p) * vv[i];
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

// ---------------------------------------------------------------------------
// #5, the bf16 cache, on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kKeys = 16;  // keys of a warp's tile: the k of one m16n8k16
constexpr int kRows = 16;  // query rows of a block: the m of one m16n8k16
constexpr int kChunkWarps = 8;
constexpr int kChunkThreads = kChunkWarps * 32;
// bytes of K and V rows (and mask columns) a block stages at once
constexpr int kStageBudget = 150 * 1024;

// Shared memory of the bf16 kernel (bytes from the start) for L positions,
// S keys, head dim D and DC output columns a pass (64 or 128): q [16][DQ +
// 8] bf16 (DQ = D rounded up to 16); a chunk of `keys` cache slots (all S
// when they fit the budget) as K [keys][DQ + 8] and V [keys][DC + 8] bf16
// and the mask [L][keys] bytes; each warp's row max and sum [warps][16]
// f32 x 2; each warp's partial output [warps][16][DC] f32. The +8 pads put
// the 8 rows that one fragment load or one ldmatrix reads on distinct
// banks.
struct ChunkSmem {
  int ldk, ldv, keys, q, k, v, mask, stats, red, bytes;
  __host__ __device__ ChunkSmem(int L, int S, int D, int DC) {
    ldk = (D + 15) / 16 * 16 + 8;
    ldv = DC + 8;
    const int tiles = (S + kKeys - 1) / kKeys;
    const int most = kStageBudget / (2 * (ldk + ldv) + L) / kKeys;
    keys = (tiles < most ? tiles : most) * kKeys;
    q = 0;
    k = q + 2 * kRows * ldk;
    v = k + 2 * keys * ldk;
    mask = v + 2 * keys * ldv;
    stats = mask + (L * keys + 15) / 16 * 16;
    red = stats + kChunkWarps * kRows * 2 * 4;
    bytes = red + kChunkWarps * kRows * DC * 4;
  }
};

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

// c[4] += a[4] b[2]: one m16n8k16 bf16 product with f32 accumulation.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (m, l) of a row's running softmax merged with another part's (mo, lo):
// l is the sum of exp(s - m); an empty part has m = -inf and l = 0.
__device__ __forceinline__ void merge_stats(float& m, float& l, float mo,
                                            float lo) {
  const float mn = fmaxf(m, mo);
  if (mn == -INFINITY) return;
  l = l * expf(m - mn) + lo * expf(mo - mn);
  m = mn;
}

// 16 of the R = G * L query rows of one (batch row, kv head) over its S
// cache slots (blockIdx.z picks the 16):
//   s = q.k * D^-0.5 + (mask ? 0 : -1e9), p = bf16(exp(s - max) / sum),
//   out = p @ v (f32, rounded to bf16).
// The block stages the head's K and V rows (all S when they fit: 2.6 KB of
// K a 16 keys at D = 64) and the mask columns at once, cp.async for the
// cache: one round trip. The 8 warps split the keys, 16 a tile (warp w
// takes tiles w, w + 8, ...). The output goes in passes of DC columns, so
// a thread's accumulators fit its registers at any D. Pass 1: the scores
// of each tile (mma.sync, q and K from shared memory) into each warp's
// running row max and sum; one barrier combines the warps' (max, sum).
// Pass 2 recomputes the scores and forms p = bf16(exp(s - max) / sum) in
// registers, already the A fragment of P V (V through ldmatrix.trans); a
// second barrier sums the warps' partial outputs in a fixed order. A cache
// longer than the budget is streamed through in chunks in both passes. No
// score leaves the registers, so no S needs a scratch buffer.
template <int DC>
__global__ void __launch_bounds__(kChunkThreads)
chunk_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_cache,
                  const bf16* __restrict__ v_cache,
                  const unsigned char* __restrict__ mask,
                  bf16* __restrict__ out, int L, int S, int Hkv, int G, int D,
                  float scale) {
  constexpr int NB = DC / 8;            // n-blocks of a pass's output
  const ChunkSmem lay(L, S, D, DC);
  extern __shared__ __align__(16) unsigned char chunk_smem[];
  unsigned char* const sm = chunk_smem;
  const uint32_t sm0 = static_cast<uint32_t>(__cvta_generic_to_shared(sm));
  const int R = G * L, Hq = Hkv * G, DQ = lay.ldk - 8;
  const int hk = blockIdx.x, b = blockIdx.y, row0 = blockIdx.z * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gi = lane >> 2, qd = lane & 3;  // fragment row, column pair
  const long long row_stride = static_cast<long long>(Hkv) * D;
  const long long cache0 = static_cast<long long>(b) * S * row_stride + hk * D;
  const unsigned char* mb = mask + static_cast<long long>(b) * L * S;
  const int n_chunks = (S + lay.keys - 1) / lay.keys;
  const bool one_chunk = n_chunks == 1;
  // row r = l * G + g is query head hk * G + g at chunk position l
  auto at = [&](int r) {
    return (static_cast<long long>(b) * L + r / G) * Hq * D +
           static_cast<long long>(hk * G + r % G) * D;
  };

  // chunk c's K rows (and, with v_dc >= 0, V's columns v_dc .. v_dc + DC)
  // by cp.async, rows past S zero-filled; then its mask columns
  auto stage = [&](int c, int v_dc) {
    const int key0 = c * lay.keys, nk = min(lay.keys, S - key0);
    const int rows = (nk + kKeys - 1) / kKeys * kKeys, w4 = D / 4;
    for (int i = tid; i < rows * w4; i += kChunkThreads) {
      const int r = i / w4, col = 4 * (i - r * w4), key = key0 + r;
      cp_async8(sm0 + lay.k + 2 * (r * lay.ldk + col),
                k_cache + cache0 + min(key, S - 1) * row_stride + col,
                key < S);
    }
    if (v_dc >= 0) {
      const int w4v = min(DC, D - v_dc) / 4;
      for (int i = tid; i < rows * w4v; i += kChunkThreads) {
        const int r = i / w4v, col = 4 * (i - r * w4v), key = key0 + r;
        cp_async8(sm0 + lay.v + 2 * (r * lay.ldv + col),
                  v_cache + cache0 + min(key, S - 1) * row_stride + v_dc +
                      col,
                  key < S);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int i = tid; i < L * nk; i += kChunkThreads) {
      const int l = i / nk, j = i - l * nk;
      sm[lay.mask + l * lay.keys + j] = mb[static_cast<long long>(l) * S +
                                           key0 + j];
    }
  };
  auto staged = [&]() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  };
  auto tiles_of = [&](int c) {
    return (min(lay.keys, S - c * lay.keys) + kKeys - 1) / kKeys;
  };

  // q's and K's columns D..DQ take part in q.k: zeros, never written again
  if (DQ > D) {
    for (int i = tid; i < lay.v / 16; i += kChunkThreads)
      reinterpret_cast<uint4*>(sm)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }
  stage(0, one_chunk ? 0 : -1);
  // the block's 16 q rows (zeros past R)
  for (int i = tid; i < kRows * (D / 4); i += kChunkThreads) {
    const int r = i / (D / 4), col = 4 * (i - r * (D / 4));
    uint2 val = make_uint2(0u, 0u);
    if (row0 + r < R)
      val = *reinterpret_cast<const uint2*>(q + at(row0 + r) + col);
    *reinterpret_cast<uint2*>(sm + lay.q + 2 * (r * lay.ldk + col)) = val;
  }
  staged();

  // the scores of chunk c's tile tt: sc[nb][e] is key tt * 16 + nb * 8 +
  // 2 qd + (e & 1) of the chunk, row gi + 8 (e >> 1) of the block
  auto scores = [&](int c, int tt, float (&sc)[2][4]) {
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nb][e] = 0.f;
    const unsigned char* qr = sm + lay.q + 2 * gi * lay.ldk;
    const unsigned char* kr = sm + lay.k + 2 * ((tt * 16 + gi) * lay.ldk);
    for (int kc = 0; kc < DQ; kc += 16) {
      const int col = 2 * (kc + 2 * qd);
      const uint32_t a[4] = {lds32(qr + col), lds32(qr + 16 * lay.ldk + col),
                             lds32(qr + col + 16),
                             lds32(qr + 16 * lay.ldk + col + 16)};
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const unsigned char* kb = kr + 16 * nb * lay.ldk + col;
        mma16816(sc[nb], a, lds32(kb), lds32(kb + 16));
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = min(row0 + gi + 8 * h, R - 1);
      const unsigned char* mrow = sm + lay.mask + (r / G) * lay.keys;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const int j = tt * kKeys + nb * 8 + 2 * qd + (e & 1);
          sc[nb][e] = c * lay.keys + j < S
                          ? __fadd_rn(__fmul_rn(sc[nb][e], scale),
                                      mrow[j] ? 0.f : -1e9f)
                          : -INFINITY;
        }
    }
  };

  float* st_m = reinterpret_cast<float*>(sm + lay.stats);
  float* st_l = st_m + kChunkWarps * kRows;
  float* red = reinterpret_cast<float*>(sm + lay.red);
  for (int dc0 = 0; dc0 < D; dc0 += DC) {
    // pass 1: each warp's running (max, sum) of the rows over its tiles
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int c = 0; c < n_chunks; ++c) {
      if (c > 0 || (!one_chunk && dc0 > 0)) {
        stage(c, -1);
        staged();
      }
      for (int tt = warp; tt < tiles_of(c); tt += kChunkWarps) {
        float sc[2][4];
        scores(c, tt, sc);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float mt = fmaxf(fmaxf(sc[0][2 * h], sc[0][2 * h + 1]),
                                 fmaxf(sc[1][2 * h], sc[1][2 * h + 1]));
          float lt = 0.f;
          if (mt != -INFINITY)
            lt = expf(sc[0][2 * h] - mt) + expf(sc[0][2 * h + 1] - mt) +
                 expf(sc[1][2 * h] - mt) + expf(sc[1][2 * h + 1] - mt);
          merge_stats(m[h], l[h], mt, lt);
        }
      }
      if (!one_chunk) __syncthreads();   // chunk c is overwritten next
    }
    // over the quad, then across the warps
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1)
        merge_stats(m[h], l[h], __shfl_xor_sync(0xffffffffu, m[h], o),
                    __shfl_xor_sync(0xffffffffu, l[h], o));
      if (qd == 0) {
        st_m[warp * kRows + gi + 8 * h] = m[h];
        st_l[warp * kRows + gi + 8 * h] = l[h];
      }
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mm = -INFINITY, ll = 0.f;
      for (int w = 0; w < kChunkWarps; ++w)
        merge_stats(mm, ll, st_m[w * kRows + gi + 8 * h],
                    st_l[w * kRows + gi + 8 * h]);
      m[h] = mm;                // finite: key 0 is in some warp's tile
      l[h] = ll;
    }

    // pass 2: p = bf16(e / sum) as the A fragment of P V
    float acc[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      if (!one_chunk || dc0 > 0) {
        stage(c, dc0);
        staged();
      }
      for (int tt = warp; tt < tiles_of(c); tt += kChunkWarps) {
        float sc[2][4];
        scores(c, tt, sc);
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[nb][e] = expf(sc[nb][e] - m[e >> 1]) / l[e >> 1];
        const uint32_t a[4] = {pack_bf16(sc[0][0], sc[0][1]),
                               pack_bf16(sc[0][2], sc[0][3]),
                               pack_bf16(sc[1][0], sc[1][1]),
                               pack_bf16(sc[1][2], sc[1][3])};
        const uint32_t vs =
            sm0 + lay.v +
            2 * ((tt * kKeys + (lane & 15)) * lay.ldv + (lane >> 4) * 8);
#pragma unroll
        for (int n2 = 0; n2 < NB / 2; ++n2) {
          uint32_t v0, v1, v2, v3;
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
              "{%0, %1, %2, %3}, [%4];\n"
              : "=r"(v0), "=r"(v1), "=r"(v2), "=r"(v3)
              : "r"(vs + 2 * 16 * n2));
          mma16816(acc[2 * n2], a, v0, v1);
          mma16816(acc[2 * n2 + 1], a, v2, v3);
        }
      }
      if (!one_chunk) __syncthreads();
    }

    // the warps' partial outputs summed in warp order
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            red + (warp * kRows + gi + 8 * h) * DC + nb * 8 + 2 * qd) =
            make_float2(acc[nb][2 * h], acc[nb][2 * h + 1]);
    __syncthreads();
    for (int i = tid; i < kRows * DC / 2; i += kChunkThreads) {
      const int r = i / (DC / 2), c = 2 * (i - r * (DC / 2));
      if (row0 + r >= R || dc0 + c >= D) continue;
      float2 sum = make_float2(0.f, 0.f);
      for (int w = 0; w < kChunkWarps; ++w) {
        const float2 x = *reinterpret_cast<const float2*>(
            red + (w * kRows + r) * DC + c);
        sum.x += x.x;
        sum.y += x.y;
      }
      *reinterpret_cast<__nv_bfloat162*>(out + at(row0 + r) + dc0 + c) =
          __floats2bfloat162_rn(sum.x, sum.y);
    }
    __syncthreads();              // stats, red (and K / V) are reused
  }
}

template <int DC>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* mask, void* out, int B, int L, int S,
                        int Hq, int Hkv, int D, float scale,
                        cudaStream_t stream) {
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        chunk_bf16_kernel<DC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxSmem));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int G = Hq / Hkv;
  const dim3 grid(Hkv, B, (G * L + kRows - 1) / kRows);
  chunk_bf16_kernel<DC>
      <<<grid, kChunkThreads, ChunkSmem(L, S, D, DC).bytes, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const unsigned char*>(mask),
          static_cast<bf16*>(out), L, S, Hkv, G, D, scale);
  return cudaGetLastError();
}

// G = Hq / Hkv in [1, 8]; D a multiple of 4 in [4, 256]; L >= 1; any S.
int dispatch_bf16(const void* q, const void* k, const void* v,
                  const void* mask, void* out, int B, int L, int S, int Hq,
                  int Hkv, int D, float scale, void* stream) {
  if (D % 4 != 0 || D < 4 || D > 256 || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq / Hkv > 8 || L < 1 || S < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      D <= 64 ? launch_bf16<64>(q, k, v, mask, out, B, L, S, Hq, Hkv, D,
                                scale, st)
              : launch_bf16<128>(q, k, v, mask, out, B, L, S, Hq, Hkv, D,
                                 scale, st));
}

}  // namespace

MTASR_EXPORT_ERROR_STRING

// int8 != 0: the int8 cache with its scales (#7); else bf16
// (#5, kv_scale and scores unused). scores (int8): a [B, Hkv, L * Hq / Hkv,
// S] f32 scratch for the scores, or null to keep them in shared memory.
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
  return dispatch_bf16(q, k_cache, v_cache, mask, out, B, L, S, Hq, Hkv, D,
                       scale, stream);
}
