// Attention of a few query tokens over the merged-lane KV cache, bf16 or
// int8, with a per-position mask: replaces two TPU kernels of
// mtasr_tpu/ops/pallas/decode_attention.py, one library, two kernels:
//
//   1 < L <= 16, int8 cache #7 `decode_attention_int8_chunk` / `_kernel_int8_chunk`
//   1 < L <= 16, bf16 cache #5 `decode_attention_chunk` / `_kernel_chunk`
//
// (#7: `chunk_int8_kernel`, which also takes L = 1; #5: `chunk_bf16_kernel`.
// The one-token int8 kernel #6 is decode_attention_int8.cu, split over a
// thread-block cluster.)
// q [B, L, Hq, D] bf16; k_cache / v_cache [B, S, Hkv*D] bf16 or int8;
// kv_scale [B, 2*Hkv, S] bf16 (int8 only) with the rows of kv head h
// INTERLEAVED: k scales in row 2h, v scales in row 2h+1 (what
// mtasr_tpu/models/llama.py:258-262 writes and the TPU kernel reads at
// decode_attention.py:302-311; two docstrings there say "k rows then v
// rows", the code does not); mask [B, L, S] bool; out [B, L, Hq, D] bf16.
// The TPU kernels took q head-major ([B, Hkv*G*L, D]) so that each head's
// rows were one sublane slice; a block here reads its query rows from q's
// own layout, so neither q nor out is transposed, and every int8 product
// accumulates exactly in int32, so the per-head form computes the same
// function.
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
// On the H100 these are bound by reading the cache once (int8 at the served
// short prefill, S = 158, B = 8, LLaMA-1B: 1.3 MB of K and V a layer, a
// 0.0006 ms bound; bf16 there: 2.6 MB, 0.0009 ms) and, at these sizes, by
// the latency of their chain of dependent steps, not by arithmetic. Both
// kernels share one design: a block serves 16 of the R = L * G query rows
// (G = Hq / Hkv) of one (batch row, kv head), grid (Hkv, B, ceil(R / 16)),
// reads the head's D-slice of the cache in place (no transpose, no head
// expansion, no dequantized copy), stages its K and V rows and the mask
// columns in shared memory with `cp.async` (all S at once when they fit,
// else in chunks), and lets its warps split the keys in tiles on the tensor
// cores through `mma.sync`. No score leaves the registers, so no S needs a
// scratch buffer.
//
// bf16: `mma.sync.m16n8k16` (bf16 in, f32 accumulate), 16-key tiles, V read
// back through `ldmatrix.trans`; the exact normalisation costs two block
// barriers: one to combine the warps' row max and sum, one to sum their
// partial outputs (`chunk_bf16_kernel`'s note has the passes). `wgmma` takes
// 64 rows at least: at the served R = 32 it would double the work of a
// kernel whose time is its latency chain, not its rate.
//
// int8: `mma.sync.m16n8k32` (s8 in, exact s32 accumulate) for both products,
// 32-key tiles. p8 = rint(p / sp) turns one ulp of p into a whole int8
// step, so p is exp(s - M) with the row's true max M (never an online
// merge), and sp needs the max of p over all S keys before any p is
// rounded: four passes over the warps' tiles, each closed by a barrier that
// combines the warps' per-row values ((a) max, (b) sum in a fixed order,
// (c) max p, (d) the int32 partials of p8 . v8, exact in any order). The
// scores stay in registers across the passes when the cache is staged at
// once and a warp has at most 4 tiles, else each pass recomputes them (an
// int8 `mma` is cheap); `chunk_int8_kernel`'s note has the fragments.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may use
constexpr float kInv127 = 1.f / 127.f;

// round(x / s) clipped to [-127, 127]; rintf rounds half to even as
// jnp.round does.
__device__ __forceinline__ int quant8(float x, float s) {
  return static_cast<int>(fminf(fmaxf(rintf(x / s), -127.f), 127.f));
}

template <typename Kernel>
cudaError_t raise_smem(Kernel kernel, size_t& raised, size_t smem) {
  if (smem <= raised) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) raised = smem;
  return err;
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

// ---------------------------------------------------------------------------
// #7, the int8 cache, on the int8 tensor cores
// ---------------------------------------------------------------------------
constexpr int kTile8 = 32;      // keys of a warp's tile: the k of one m16n8k32
constexpr int kMaxWarps8 = 8;
constexpr int kCols8 = 64;      // output columns a pass of p8 . v8
constexpr int kLdRed = kCols8 + 4;  // a partial-output row, padded off bank 0

// Shared memory of the int8 kernel (bytes from the start) for L positions,
// `keys` staged cache slots (a multiple of 32), head dim D and `nw` warps
// that take tiles; the Python plan (`chunk_int8_plan`) computes the same.
// Rows of ld = DP + 16 bytes (DP = D rounded up to 32): q8 [16][ld], K and
// V [keys][ld] int8; the k and v scales (bf16) and the L mask rows (bytes)
// of the keys, each copied from its 4-byte word, so with up to 3 bytes
// before the first key: [2 keys + 16] bytes each, [L][keys + 16]; sq *
// D^-0.5 and sp of the 16 rows, f32; each such warp's row max, sum and
// max p [3][nw][16] f32 and partial output [nw][16][kLdRed] int32. The
// 16-byte pad of a row puts the 8 rows that one fragment load reads on
// distinct banks.
struct Int8Smem {
  int ld, ldm, q, k, v, ks, vs, mask, qs, sp, stats, red, bytes;
  __host__ __device__ Int8Smem(int L, int keys, int D, int nw) {
    ld = (D + 31) / 32 * 32 + 16;
    ldm = keys + 16;
    q = 0;
    k = q + kRows * ld;
    v = k + keys * ld;
    ks = v + keys * ld;
    vs = ks + 2 * keys + 16;
    mask = vs + 2 * keys + 16;
    qs = mask + L * ldm;
    sp = qs + 4 * kRows;
    stats = sp + 4 * kRows;
    red = stats + 3 * 4 * nw * kRows;
    bytes = red + 4 * nw * kRows * kLdRed;
  }
};

// c[4] += a[4] b[2]: one m16n8k32 s8 product, accumulated exactly in s32.
__device__ __forceinline__ void mma16832(int (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The low bytes of four ints, x0 in the lowest.
__device__ __forceinline__ uint32_t pack8(int x0, int x1, int x2, int x3) {
  return __byte_perm(__byte_perm(x0, x1, 0x0040), __byte_perm(x2, x3, 0x0040),
                     0x5410);
}

// A 4-byte copy from global to shared memory of which the first `valid`
// bytes (0..4) are read and the rest zeroed.
__device__ __forceinline__ void cp_async4z(uint32_t dst, const void* src,
                                           int valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid)
               : "memory");
}

// An n-byte copy (16, 8 or 4) from global to shared memory; zero-filled
// when !valid.
__device__ __forceinline__ void cp_async_n(int n, uint32_t dst,
                                           const void* src, bool valid) {
  if (n == 16)
    cp_async16(dst, src, valid ? 16 : 0);
  else if (n == 8)
    cp_async8(dst, src, valid);
  else
    cp_async4z(dst, src, valid ? 4 : 0);
}

// 16 of the R = G * L query rows of one (batch row, kv head) over its S
// cache slots (blockIdx.x picks the 16, so the row blocks of a head run
// side by side and share its cache lines in L2), the int8 function of the
// file's head. The block quantizes its q rows into shared memory (zero
// past D and past R) while `cp.async` stages `keys` cache slots at once
// (all S when they fit): K and V rows as the cache stores them, and the
// scales and mask columns as 4-byte words (their rows start anywhere).
// Its warps split the keys in tiles of 32 (warp w takes tiles w, w +
// warps, ...).
//
// Scores: A = q8 [16][32 d] and B = K [32 d][8 keys], each thread's four
// bytes one 32-bit shared load (the fragment's k runs along d, as the
// cache stores it). A thread holds the scores of rows gi, gi + 8 and keys
// 8 nb + 2 qd + {0, 1} of n-blocks nb = 0..3 of the tile.
// p8 . v8: the same p8 are the A fragment [16][32 keys] when the k index
// of the product runs over the keys in a permuted order: slots 4 qd .. 4 qd
// + 3 of each half of 16 hold keys 2 qd, 2 qd + 1, 8 + 2 qd, 9 + 2 qd of
// that half, which are this thread's own. B's fragment (V [32 keys][8
// columns], keys contiguous for each column) follows the same order: a
// thread reads V's words at those four keys (32-bit loads, 4 columns each)
// and transposes them by byte permutes into one word a column; the 4
// columns of the word are column gi of 4 n-blocks, so a thread's outputs
// of a 32-column group are 8 neighbouring columns.
//
// The passes (each closed by a barrier that combines the warps' values of
// the 16 rows; the warps read them in warp order): (a) row max M; (b) the
// sum of e = exp(s - M); (c) p = (e / sum) * vs and max p, sp; (d) p8 and
// the int32 partials of p8 . v8, 64 output columns a round, summed over
// the warps and scaled by sp. With NT > 0 (one staged chunk, at most NT
// tiles a warp) the scores stay in registers from (a) on and each pass
// leaves its value there (e, then p); with NT = 0 each pass recomputes
// them, re-staging a cache longer than `keys` chunk by chunk. The register
// budget follows NT: 64 at NT = 1 (4 blocks an SM at the served shape),
// 128 at NT = 2 and 4, and up to 255 at NT = 0, which spills under 128.
template <int NT>
__global__ void __launch_bounds__(kMaxWarps8 * 32,
                                  NT == 0 ? 1 : NT == 1 ? 4 : 2)
chunk_int8_kernel(const bf16* __restrict__ q,
                  const int8_t* __restrict__ k_cache,
                  const int8_t* __restrict__ v_cache,
                  const bf16* __restrict__ kv_scale,
                  const unsigned char* __restrict__ mask,
                  bf16* __restrict__ out, int L, int S, int Hkv, int G, int D,
                  int keys, float scale) {
  const int warps = blockDim.x >> 5, nthreads = blockDim.x;
  // the warps that take tiles: as many as chunk 0, the longest, has tiles
  const int nw = min(warps, (min(keys, S) + kTile8 - 1) / kTile8);
  const Int8Smem lay(L, keys, D, nw);
  extern __shared__ __align__(16) unsigned char chunk_smem[];
  unsigned char* const sm = chunk_smem;
  const uint32_t sm0 = static_cast<uint32_t>(__cvta_generic_to_shared(sm));
  const int R = G * L, Hq = Hkv * G, DP = lay.ld - 16;
  const int row0 = blockIdx.x * kRows, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gi = lane >> 2, qd = lane & 3;  // fragment row, column quad
  const long long row_stride = static_cast<long long>(Hkv) * D;
  const long long cache0 = static_cast<long long>(b) * S * row_stride +
                           static_cast<long long>(hk) * D;
  // byte offsets of the k scale row and of mask row (b, 0); a staged key
  // j of either sits at (offset & 3) + j (elements) past its smem start
  const long long ks0 = 2 * (static_cast<long long>(b) * 2 * Hkv + 2 * hk) * S;
  const long long m0 = static_cast<long long>(b) * L * S;
  const int n_chunks = (S + keys - 1) / keys;
  auto tiles_of = [&](int c) {
    return (min(keys, S - c * keys) + kTile8 - 1) / kTile8;
  };
  float* const qs = reinterpret_cast<float*>(sm + lay.qs);
  float* const sps = reinterpret_cast<float*>(sm + lay.sp);
  float* const st_m = reinterpret_cast<float*>(sm + lay.stats);
  float* const st_l = st_m + nw * kRows;
  float* const st_p = st_l + nw * kRows;
  const bf16* const kss = reinterpret_cast<const bf16*>(sm + lay.ks) +
                          (ks0 & 3) / 2;
  const bf16* const vss = reinterpret_cast<const bf16*>(sm + lay.vs) +
                          ((ks0 + 2 * S) & 3) / 2;
  int* const red = reinterpret_cast<int*>(sm + lay.red);
  // row r = l * G + g is query head hk * G + g at chunk position l
  auto at = [&](int r) {
    return (static_cast<long long>(b) * L + r / G) * Hq * D +
           static_cast<long long>(hk * G + r % G) * D;
  };

  // chunk c's K rows (and V's, with_v) by cp.async in the widest copies
  // that the rows' alignment allows (a row starts D bytes from the last),
  // rows past S zero-filled; its scales and mask columns as the 4-byte
  // words over each row's bytes [start, end), from start rounded down to
  // 4, zero past end
  const int cw = D % 16 == 0 ? 16 : D % 8 == 0 ? 8 : 4;
  auto window = [&](uint32_t dst, const void* base, long long start,
                    long long end, int w) {
    const long long a = (start & ~3LL) + 4 * w;
    const int valid = static_cast<int>(max(0LL, min(4LL, end - a)));
    cp_async4z(dst + 4 * w,
               static_cast<const unsigned char*>(base) +
                   (valid > 0 ? a : start & ~3LL),
               valid);
  };
  auto stage = [&](int c, bool with_v) {
    const int key0 = c * keys, nk = min(keys, S - key0);
    const int rows = (nk + kTile8 - 1) / kTile8 * kTile8, per_row = D / cw;
    for (int i = tid; i < rows * per_row; i += nthreads) {
      const int r = i / per_row, col = cw * (i - r * per_row), key = key0 + r;
      const long long src = cache0 + min(key, S - 1) * row_stride + col;
      const uint32_t dst = r * lay.ld + col;
      cp_async_n(cw, sm0 + lay.k + dst, k_cache + src, key < S);
      if (with_v) cp_async_n(cw, sm0 + lay.v + dst, v_cache + src, key < S);
    }
    const int sw = rows / 2 + 1, mw = rows / 4 + 1;  // words a row
    for (int i = tid; i < 2 * sw; i += nthreads) {
      const int h = i / sw;       // 0: k scales, 1: v scales
      const long long start = ks0 + 2 * (h * static_cast<long long>(S) + key0);
      window(sm0 + (h ? lay.vs : lay.ks), kv_scale, start, start + 2 * nk,
             i - h * sw);
    }
    for (int i = tid; i < L * mw; i += nthreads) {
      const int l = i / mw;
      const long long start = m0 + static_cast<long long>(l) * S + key0;
      window(sm0 + lay.mask + l * lay.ldm, mask, start, start + nk,
             i - l * mw);
    }
    cp_async_commit();
  };
  // q8 of the block's 16 rows, one warp a row (zeros past D, and all
  // zeros past R): a warp loads up to 4 of its rows at once, the first
  // ones before the cache copies are issued
  constexpr int kQRows = 4;
  uint2 qv[kQRows][2];
  auto load_q = [&](int i0) {
#pragma unroll
    for (int k = 0; k < kQRows; ++k)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + k * warps, w = lane + 32 * h;
        qv[k][h] = i < kRows && row0 + i < R && w < D / 4
                       ? *reinterpret_cast<const uint2*>(q + at(row0 + i) +
                                                         4 * w)
                       : make_uint2(0u, 0u);
      }
  };
  auto quantize_q = [&](int i0) {
#pragma unroll
    for (int k = 0; k < kQRows; ++k) {
      const int i = i0 + k * warps;
      if (i >= kRows) break;
      float x[2][4];
      float amax = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 lo = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&qv[k][h].x));
        const float2 hi = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&qv[k][h].y));
        x[h][0] = lo.x;
        x[h][1] = lo.y;
        x[h][2] = hi.x;
        x[h][3] = hi.y;
#pragma unroll
        for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fabsf(x[h][e]));
      }
      const float sq = fmaxf(__fmul_rn(warp_max(amax), kInv127), 1e-12f);
      uint32_t* q8r = reinterpret_cast<uint32_t*>(sm + lay.q + i * lay.ld);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int w = lane + 32 * h;
        if (w < DP / 4)
          q8r[w] = pack8(quant8(x[h][0], sq), quant8(x[h][1], sq),
                         quant8(x[h][2], sq), quant8(x[h][3], sq));
      }
      if (lane == 0) qs[i] = __fmul_rn(sq, scale);
    }
  };
  load_q(warp);
  stage(0, n_chunks == 1);
  for (int i0 = warp; i0 < kRows; i0 += kQRows * warps) {
    if (i0 != warp) load_q(i0);
    quantize_q(i0);
  }
  cp_async_wait<0>();
  __syncthreads();

  // this thread's two rows: their mask rows and sq * D^-0.5
  const unsigned char* mrow[2];
  float qsr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int l = min(row0 + gi + 8 * h, R - 1) / G;
    mrow[h] = sm + lay.mask + l * lay.ldm + ((m0 + l * S) & 3);
    qsr[h] = qs[gi + 8 * h];
  }

  // the scores of chunk c's tile tt: s[nb][e] is key tt * 32 + nb * 8 +
  // 2 qd + (e & 1) of the chunk, row gi + 8 (e >> 1) of the block; -inf
  // past S (out of the softmax), a masked key -1e9 (in it)
  auto scores = [&](int c, int tt, float (&s)[4][4]) {
    int acc[4][4];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][e] = 0;
    const unsigned char* qr = sm + lay.q + gi * lay.ld + 4 * qd;
    const unsigned char* kr =
        sm + lay.k + (tt * kTile8 + gi) * lay.ld + 4 * qd;
    for (int kc = 0; kc < DP; kc += 32) {
      const uint32_t a[4] = {lds32(qr + kc), lds32(qr + 8 * lay.ld + kc),
                             lds32(qr + kc + 16),
                             lds32(qr + 8 * lay.ld + kc + 16)};
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const unsigned char* kb = kr + nb * 8 * lay.ld + kc;
        mma16832(acc[nb], a, lds32(kb), lds32(kb + 16));
      }
    }
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = tt * kTile8 + nb * 8 + 2 * qd + (e & 1), h = e >> 1;
        s[nb][e] = c * keys + j < S
                       ? __fadd_rn(__fmul_rn(__fmul_rn(
                                                 static_cast<float>(
                                                     acc[nb][e]),
                                                 qsr[h]),
                                             __bfloat162float(kss[j])),
                                   mrow[h][j] ? 0.f : -1e9f)
                       : -INFINITY;
      }
  };

  // fn(tt, x) on each of this warp's tiles: x the tile's scores, recomputed
  // (NT = 0; the chunks staged in turn, with V when need_v) or what the
  // last pass left in registers
  float res[NT > 0 ? NT : 1][4][4];
  int have_c = 0;                // the chunk staged, and whether with V
  bool have_v = n_chunks == 1;
  auto each_tile = [&](bool need_v, auto&& fn) {
    if constexpr (NT > 0) {
#pragma unroll
      for (int i = 0; i < NT; ++i)
        if (warp + i * warps < tiles_of(0)) fn(warp + i * warps, res[i]);
    } else {
      for (int c = 0; c < n_chunks; ++c) {
        if (c != have_c || (need_v && !have_v)) {
          __syncthreads();       // every warp is done with the chunk held
          stage(c, need_v);
          cp_async_wait<0>();
          __syncthreads();
          have_c = c;
          have_v = need_v;
        }
        for (int tt = warp; tt < tiles_of(c); tt += warps) {
          float s[4][4];
          scores(c, tt, s);
          fn(tt, s);
        }
      }
    }
  };
  // per-row values of the quad, then of the warps (in warp order)
  auto combine = [&](float (&v)[2], float* st, bool is_max) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float x = __shfl_xor_sync(0xffffffffu, v[h], o);
        v[h] = is_max ? fmaxf(v[h], x) : v[h] + x;
      }
      if (qd == 0 && warp < nw) st[warp * kRows + gi + 8 * h] = v[h];
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float t = st[gi + 8 * h];
      for (int w = 1; w < nw; ++w) {
        const float x = st[w * kRows + gi + 8 * h];
        t = is_max ? fmaxf(t, x) : t + x;
      }
      v[h] = t;
    }
  };

  // (a) the row max M over all S keys (exact in any order)
  if constexpr (NT > 0) {
#pragma unroll
    for (int i = 0; i < NT; ++i)
      if (warp + i * warps < tiles_of(0)) scores(0, warp + i * warps, res[i]);
  }
  float m[2] = {-INFINITY, -INFINITY};
  each_tile(false, [&](int, float (&x)[4][4]) {
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], x[nb][e]);
  });
  combine(m, st_m, true);  // finite: key 0 is in the softmax

  // (b) sum = the sum of e = exp(s - M) (0 past S)
  float sum[2] = {0.f, 0.f};
  each_tile(false, [&](int, float (&x)[4][4]) {
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ev = expf(x[nb][e] - m[e >> 1]);
        if constexpr (NT > 0) x[nb][e] = ev;
        sum[e >> 1] += ev;
      }
  });
  combine(sum, st_l, false);

  // (c) p = (e / sum) * vs, its max over the row, sp
  auto prob = [&](int tt, int nb, int e, float x) {
    const float ev = NT > 0 ? x : expf(x - m[e >> 1]);
    return __fmul_rn(ev / sum[e >> 1], __bfloat162float(vss[
        tt * kTile8 + nb * 8 + 2 * qd + (e & 1)]));
  };
  float sp[2] = {0.f, 0.f};
  each_tile(false, [&](int tt, float (&x)[4][4]) {
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = prob(tt, nb, e, x[nb][e]);
        if constexpr (NT > 0) x[nb][e] = p;
        sp[e >> 1] = fmaxf(sp[e >> 1], p);
      }
  });
  combine(sp, st_p, true);
#pragma unroll
  for (int h = 0; h < 2; ++h) sp[h] = fmaxf(__fmul_rn(sp[h], kInv127), 1e-12f);
  if (warp == 0 && qd == 0) {
    sps[gi] = sp[0];
    sps[gi + 8] = sp[1];
  }

  // (d) p8 . v8, 64 output columns a round
  for (int dc0 = 0; dc0 < DP; dc0 += kCols8) {
    int acc[8][4];               // n-block j of 32-column group g: [4 g + j]
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0;
    each_tile(true, [&](int tt, float (&x)[4][4]) {
      int p8[4][4];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p8[nb][e] = quant8(NT > 0 ? x[nb][e] : prob(tt, nb, e, x[nb][e]),
                             sp[e >> 1]);
      const uint32_t a[4] = {pack8(p8[0][0], p8[0][1], p8[1][0], p8[1][1]),
                             pack8(p8[0][2], p8[0][3], p8[1][2], p8[1][3]),
                             pack8(p8[2][0], p8[2][1], p8[3][0], p8[3][1]),
                             pack8(p8[2][2], p8[2][3], p8[3][2], p8[3][3])};
      const unsigned char* vt =
          sm + lay.v + (tt * kTile8 + 2 * qd) * lay.ld + dc0 + 4 * gi;
#pragma unroll
      for (int grp = 0; grp < kCols8 / 32; ++grp) {
        if (dc0 + 32 * grp >= DP) break;
        uint32_t col[2][4];      // [key half][n-block]
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const unsigned char* v4 = vt + 16 * h * lay.ld + 32 * grp;
          const uint32_t w0 = lds32(v4), w1 = lds32(v4 + lay.ld),
                         w2 = lds32(v4 + 8 * lay.ld),
                         w3 = lds32(v4 + 9 * lay.ld);
          const uint32_t lo01 = __byte_perm(w0, w1, 0x5140),
                         hi01 = __byte_perm(w0, w1, 0x7362),
                         lo23 = __byte_perm(w2, w3, 0x5140),
                         hi23 = __byte_perm(w2, w3, 0x7362);
          col[h][0] = __byte_perm(lo01, lo23, 0x5410);
          col[h][1] = __byte_perm(lo01, lo23, 0x7632);
          col[h][2] = __byte_perm(hi01, hi23, 0x5410);
          col[h][3] = __byte_perm(hi01, hi23, 0x7632);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma16832(acc[4 * grp + j], a, col[0][j], col[1][j]);
      }
    });
    // the warp's partial: row gi + 8 h, columns 32 g + 8 qd + 4 c + j from
    // acc[4 g + j][2 h + c]
    if (warp < nw) {
#pragma unroll
      for (int grp = 0; grp < kCols8 / 32; ++grp)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            *reinterpret_cast<int4*>(
                red + (warp * kRows + gi + 8 * h) * kLdRed + 32 * grp +
                8 * qd + 4 * c) =
                make_int4(acc[4 * grp][2 * h + c], acc[4 * grp + 1][2 * h + c],
                          acc[4 * grp + 2][2 * h + c],
                          acc[4 * grp + 3][2 * h + c]);
    }
    __syncthreads();
    for (int i = tid; i < kRows * kCols8 / 4; i += nthreads) {
      const int r = i / (kCols8 / 4), c = 4 * (i - r * (kCols8 / 4));
      if (row0 + r >= R || dc0 + c >= D) continue;
      int4 t = *reinterpret_cast<const int4*>(red + r * kLdRed + c);
      for (int w = 1; w < nw; ++w) {
        const int4 x =
            *reinterpret_cast<const int4*>(red + (w * kRows + r) * kLdRed + c);
        t.x += x.x;
        t.y += x.y;
        t.z += x.z;
        t.w += x.w;
      }
      const float s = sps[r];
      const __nv_bfloat162 o01 =
          __floats2bfloat162_rn(__fmul_rn(static_cast<float>(t.x), s),
                                __fmul_rn(static_cast<float>(t.y), s));
      const __nv_bfloat162 o23 =
          __floats2bfloat162_rn(__fmul_rn(static_cast<float>(t.z), s),
                                __fmul_rn(static_cast<float>(t.w), s));
      uint2 o;
      o.x = *reinterpret_cast<const uint32_t*>(&o01);
      o.y = *reinterpret_cast<const uint32_t*>(&o23);
      *reinterpret_cast<uint2*>(out + at(row0 + r) + dc0 + c) = o;
    }
    if (dc0 + kCols8 < DP) __syncthreads();  // red is written again
  }
}

template <int NT>
cudaError_t launch_int8(const void* q, const void* k, const void* v,
                        const void* kv_scale, const void* mask, void* out,
                        int B, int L, int S, int Hq, int Hkv, int D,
                        float scale, int keys, int warps,
                        cudaStream_t stream) {
  static size_t raised = 48 * 1024;  // once per instantiation, as needed
  const int nw = min(warps, (min(keys, S) + kTile8 - 1) / kTile8);
  const size_t smem = Int8Smem(L, keys, D, nw).bytes;
  const cudaError_t err = raise_smem(chunk_int8_kernel<NT>, raised, smem);
  if (err != cudaSuccess) return err;
  const int G = Hq / Hkv;
  const dim3 grid((G * L + kRows - 1) / kRows, Hkv, B);
  chunk_int8_kernel<NT><<<grid, 32 * warps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const bf16*>(kv_scale),
      static_cast<const unsigned char*>(mask), static_cast<bf16*>(out), L, S,
      Hkv, G, D, keys, scale);
  return cudaGetLastError();
}

// G = Hq / Hkv in [1, 8]; D a multiple of 4 in [4, 256]; L >= 1; any S.
// The plan (ops/kernels/decode_attention_chunk.py `chunk_int8_plan`):
// `keys` staged slots (a multiple of 32), 1..8 warps, resident 0 (scores
// recomputed each pass) or 1, 2 or 4 tiles a warp kept in registers, which
// needs all S staged at once; the shared memory within the block's limit.
int dispatch_int8(const void* q, const void* k, const void* v,
                  const void* kv_scale, const void* mask, void* out, int B,
                  int L, int S, int Hq, int Hkv, int D, float scale, int keys,
                  int warps, int resident, void* stream) {
  if (D % 4 != 0 || D < 4 || D > 256 || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq / Hkv > 8 || L < 1 || S < 1 || B < 1 || keys < kTile8 ||
      keys % kTile8 != 0 || warps < 1 || warps > kMaxWarps8 ||
      Int8Smem(L, keys, D, warps).bytes > static_cast<int>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (S + kTile8 - 1) / kTile8;
  if (resident != 0 && (keys < S || (tiles + warps - 1) / warps > resident))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (resident) {
#define MTASR_CHUNK_INT8_CASE(NT)                                            \
  case NT:                                                                   \
    return static_cast<int>(launch_int8<NT>(q, k, v, kv_scale, mask, out, B, \
                                            L, S, Hq, Hkv, D, scale, keys,   \
                                            warps, st));
    MTASR_CHUNK_INT8_CASE(0)
    MTASR_CHUNK_INT8_CASE(1)
    MTASR_CHUNK_INT8_CASE(2)
    MTASR_CHUNK_INT8_CASE(4)
#undef MTASR_CHUNK_INT8_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

MTASR_EXPORT_ERROR_STRING

// int8 != 0: the int8 cache with its scales (#7) on the plan `keys`,
// `warps`, `resident`; else bf16 (#5; kv_scale and the plan unused).
extern "C" int decode_attention_chunk_launch(
    int int8, const void* q, const void* k_cache, const void* v_cache,
    const void* kv_scale, const void* mask, void* out, int B, int L, int S,
    int Hq, int Hkv, int D, float scale, int keys, int warps, int resident,
    void* stream) {
  if (int8)
    return dispatch_int8(q, k_cache, v_cache, kv_scale, mask, out, B, L, S,
                         Hq, Hkv, D, scale, keys, warps, resident, stream);
  return dispatch_bf16(q, k_cache, v_cache, mask, out, B, L, S, Hq, Hkv, D,
                       scale, stream);
}
