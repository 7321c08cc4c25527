// Flash attention backward with the WavLM gated relative-position bias:
// three kernels, one library, chosen by `which`.
//
//   s[i, j]  = q_i . k_j * scale + gate[b, h, i] * pos_bias[h, i, j]
//   p[i, j]  = exp(s[i, j] - lse[i])            (j < kv_len, else 0)
//   ds[i, j] = p[i, j] * (dO_i . v_j - delta[i]),  delta[i] = dO_i . out_i
//
//   #8 dq  (which 0): dq_i = scale * sum_j ds[i, j] k_j   (bf16 out)
//                     dg[b, h, i] = sum_j ds[i, j] pos_bias[h, i, j]
//   #9 dkv (which 1): dk_j = scale * sum_i ds[i, j] q_i,  dv_j = sum_i p dO_i
//                     per q head, f32 [B, S, Hq, D]; the caller sums a GQA
//                     group and casts, as the JAX package does
//   #10 dpb (which 2): dpb[h, i, j] = sum_b gate[b, h, i] ds_b[i, j]
//
// q, dO [B, T, Hq, D], k, v [B, S, Hkv, D], pos_bias [Hq, T, S], gate
// [B, Hq, T] bf16; lse [B*Hq, T] from the forward kernel and delta
// [B, Hq, T], f32; kv_lens [B] int32. As in the TPU kernels, p and ds are
// rounded to bf16 before they enter a product, every sum is f32, and keys at
// or past kv_len get p = ds = 0 whatever lse says, so a row with kv_len 0
// gives zero gradients and no NaN.
//
// Replaces the TPU kernels `_bwd_dq_kernel` (mtasr_tpu/ops/pallas/
// flash_attention.py:400-445, call :640), `_bwd_dkv_kernel` (:447-501, call
// :664) and `_bwd_dpb_kernel` (:503-539, call :711). The TPU carried each
// sum across sequential grid steps in VMEM scratch; here a block loops over
// what the TPU walked in grid order. #8: a block owns 64 queries of one
// (b, h), loops over key tiles, and keeps dq in tensor-core accumulators and
// dg in registers. #9: a block owns 64 keys of one (b, q head), loops over
// query tiles, and masks the ragged query tail so that padding cannot enter
// (:477-486). #10: a block owns one (h, query tile, key tile) and loops over
// the batch, so the sum is deterministic (no atomics), in batch order as on
// the TPU, where the batch is the innermost grid axis.
//
// What bounds them on the H100: at the encoder's shapes (B = 16, T = S =
// 499, H = 16, D = 64) the three recompute the scores and do 18 T S D B H
// = 7.3e10 FLOP a layer (6, 8 and 4 of the 18), about 74 us at the bf16
// tensor-core peak, against some 100 MB of operands (30 us at 3.35 TB/s):
// the products bound them. Design: 4 warps a block; Q, dO, K, V tiles staged
// in shared memory, every product on the tensor cores through WMMA (bf16
// in, f32 accumulate), the scores and dO V^T of a tile in shared memory, the
// elementwise p / ds step one row at a time across a warp. The gated
// [B, H, T, S] bias is never built: gate * pos_bias is composed in the
// kernel. wgmma / TMA pipelines are later work.
#include <mma.h>

#include <type_traits>

#include "common.cuh"
#include "flash_tile.cuh"

using namespace nvcuda;

namespace {

constexpr int kBM = 64;  // queries of a tile
constexpr int kBN = 64;  // keys of a tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int DP>
struct Smem {  // leading dims padded against bank conflicts
  static constexpr int LDQ = DP + 8;   // bf16 rows: q, dO, k, v
  static constexpr int LDP = kBN + 8;  // bf16 p and ds
  static constexpr int LDS = kBN + 4;  // f32 scores and dO V^T
  static constexpr int LDO = DP + 4;   // f32 output staging, over s and dp
  static constexpr size_t q = 0;
  static constexpr size_t dout = q + sizeof(bf16) * kBM * LDQ;
  static constexpr size_t k = dout + sizeof(bf16) * kBM * LDQ;
  static constexpr size_t v = k + sizeof(bf16) * kBN * LDQ;
  static constexpr size_t s = v + sizeof(bf16) * kBN * LDQ;
  static constexpr size_t dp = s + sizeof(float) * kBM * LDS;
  static constexpr size_t p = dp + sizeof(float) * kBM * LDS;
  static constexpr size_t ds = p + sizeof(bf16) * kBM * LDP;
  static constexpr size_t rows = ds + sizeof(bf16) * kBM * LDP;
  static constexpr size_t bytes = rows + sizeof(float) * 3 * kBM;
  static_assert(sizeof(float) * kBM * LDO <= p - s,
                "the output staging fits over the scores and dP");
};

struct Ptrs {  // the block's shared memory
  bf16 *q, *dout, *k, *v, *p, *ds;
  float *s, *dp, *lse, *delta, *gate;
};

template <int DP>
__device__ __forceinline__ Ptrs smem_ptrs(unsigned char* smem) {
  using L = Smem<DP>;
  Ptrs t;
  t.q = reinterpret_cast<bf16*>(smem + L::q);
  t.dout = reinterpret_cast<bf16*>(smem + L::dout);
  t.k = reinterpret_cast<bf16*>(smem + L::k);
  t.v = reinterpret_cast<bf16*>(smem + L::v);
  t.s = reinterpret_cast<float*>(smem + L::s);
  t.dp = reinterpret_cast<float*>(smem + L::dp);
  t.p = reinterpret_cast<bf16*>(smem + L::p);
  t.ds = reinterpret_cast<bf16*>(smem + L::ds);
  t.lse = reinterpret_cast<float*>(smem + L::rows);
  t.delta = t.lse + kBM;
  t.gate = t.delta + kBM;
  return t;
}

// lse, delta and gate of query rows q0 .. q0 + 63 of row block `bh` (zero
// past T; gate zero without a bias).
__device__ __forceinline__ void load_row_stats(
    const Ptrs& t, const float* lse, const float* delta, const bf16* gate,
    long long bh, int q0, int T, int has_bias) {
  if (threadIdx.x < kBM) {
    const int qi = q0 + threadIdx.x;
    const bool ok = qi < T;
    const long long at = bh * T + qi;
    t.lse[threadIdx.x] = ok ? lse[at] : 0.f;
    t.delta[threadIdx.x] = ok ? delta[at] : 0.f;
    t.gate[threadIdx.x] = ok && has_bias ? __bfloat162float(gate[at]) : 0.f;
  }
}

// c[64 x 64] (f32, ld LDS) = a[64 x DP] . b[64 x DP]^T for this warp's 16
// rows of a.
template <int DP>
__device__ __forceinline__ void warp_abt(const bf16* a, const bf16* b,
                                         float* c) {
  using L = Smem<DP>;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int nc = 0; nc < kBN / 16; ++nc) {
    Acc acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, a + warp * 16 * L::LDQ + kc * 16, L::LDQ);
      wmma::load_matrix_sync(fb, b + nc * 16 * L::LDQ + kc * 16, L::LDQ);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + warp * 16 * L::LDS + nc * 16, acc, L::LDS,
                            wmma::mem_row_major);
  }
}

// acc[16 x DP] += a . b[64 x DP] for this warp's 16 output rows, where a
// is rows warp*16.. of the bf16 [64 x 64] tile x (ld LDP), or with kTrans
// those rows of x^T.
template <int DP, bool kTrans>
__device__ __forceinline__ void warp_acc(Acc (&acc)[DP / 16], const bf16* x,
                                         const bf16* b) {
  using L = Smem<DP>;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int kc = 0; kc < kBN / 16; ++kc) {
    using Layout = typename std::conditional<kTrans, wmma::col_major,
                                             wmma::row_major>::type;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, Layout> fa;
    if constexpr (kTrans)
      wmma::load_matrix_sync(fa, x + kc * 16 * L::LDP + warp * 16, L::LDP);
    else
      wmma::load_matrix_sync(fa, x + warp * 16 * L::LDP + kc * 16, L::LDP);
#pragma unroll
    for (int dc = 0; dc < DP / 16; ++dc) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, b + kc * 16 * L::LDQ + dc * 16, L::LDQ);
      wmma::mma_sync(acc[dc], fa, fb, acc[dc]);
    }
  }
}

// This warp's 16 rows of acc into the f32 staging (ld LDO) over s / dp.
template <int DP>
__device__ __forceinline__ float* stage(Acc (&acc)[DP / 16], float* st) {
  using L = Smem<DP>;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int dc = 0; dc < DP / 16; ++dc)
    wmma::store_matrix_sync(st + warp * 16 * L::LDO + dc * 16, acc[dc],
                            L::LDO, wmma::mem_row_major);
  __syncwarp();
  return st + warp * 16 * L::LDO;
}

struct Args {
  const bf16 *q, *k, *v, *pos_bias, *gate;
  const int* kv_lens;
  const float *lse, *delta;
  const bf16* dout;
  void *out_a, *out_b;
  int B, T, S, Hq, Hkv, D;
  float scale;
  int has_bias;
};

// ---- #8: dq and dg ---------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(Args a) {
  using L = Smem<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Ptrs t = smem_ptrs<DP>(smem);
  const int q0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const int T = a.T, S = a.S, D = a.D;
  const int hk = h / (a.Hq / a.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kv_len = min(max(a.kv_lens[b], 0), S);
  const long long bh = static_cast<long long>(b) * a.Hq + h;
  const long long q_stride = static_cast<long long>(a.Hq) * D;
  const long long kv_stride = static_cast<long long>(a.Hkv) * D;
  const long long q_off = (static_cast<long long>(b) * T * a.Hq + h) * D;
  const long long kv_off = (static_cast<long long>(b) * S * a.Hkv + hk) * D;
  const bf16* pb_h = a.pos_bias + static_cast<long long>(h) * T * S;

  load_rows<DP, kThreads>(t.q, L::LDQ, a.q + q_off, q_stride, q0, T, D);
  load_rows<DP, kThreads>(t.dout, L::LDQ, a.dout + q_off, q_stride, q0, T,
                          D);
  load_row_stats(t, a.lse, a.delta, a.gate, bh, q0, T, a.has_bias);
  Acc acc[DP / 16];
#pragma unroll
  for (int dc = 0; dc < DP / 16; ++dc) wmma::fill_fragment(acc[dc], 0.f);
  float dg_acc[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) dg_acc[r] = 0.f;
  __syncthreads();

  for (int n0 = 0; n0 < kv_len; n0 += kBN) {
    load_rows<DP, kThreads>(t.k, L::LDQ, a.k + kv_off, kv_stride, n0, kv_len,
                            D);
    load_rows<DP, kThreads>(t.v, L::LDQ, a.v + kv_off, kv_stride, n0, kv_len,
                            D);
    __syncthreads();
    warp_abt<DP>(t.q, t.k, t.s);
    warp_abt<DP>(t.dout, t.v, t.dp);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r, qi = q0 + row;
      const float g = t.gate[row], m = t.lse[row], dl = t.delta[row];
#pragma unroll
      for (int c = 0; c < kBN / 32; ++c) {
        const int col = lane + 32 * c, kj = n0 + col;
        float ds = 0.f;
        if (qi < T && kj < kv_len) {
          float s = t.s[row * L::LDS + col] * a.scale;
          float pb = 0.f;
          if (a.has_bias) {
            pb = __bfloat162float(pb_h[static_cast<long long>(qi) * S + kj]);
            s += g * pb;
          }
          ds = expf(s - m) * (t.dp[row * L::LDS + col] - dl);
          dg_acc[r] += ds * pb;
        }
        t.ds[row * L::LDP + col] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    warp_acc<DP, false>(acc, t.ds, t.k);   // dq += ds . k
    __syncthreads();                       // k / v refilled next
  }

  const float* st = stage<DP>(acc, t.s);
  bf16* dq = static_cast<bf16*>(a.out_a);
  bf16* dg = static_cast<bf16*>(a.out_b);
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int qi = q0 + warp * 16 + r;
    if (qi >= T) break;
    bf16* row = dq + ((static_cast<long long>(b) * T + qi) * a.Hq + h) * D;
    for (int d = lane; d < D; d += 32)
      row[d] = __float2bfloat16(st[r * L::LDO + d] * a.scale);
    if (a.has_bias) {
      const float total = warp_sum(dg_acc[r]);
      if (lane == 0) dg[bh * T + qi] = __float2bfloat16(total);
    }
  }
}

// ---- #9: dk and dv of one q head -------------------------------------------
template <int DP>
__global__ void __launch_bounds__(kThreads) bwd_dkv_kernel(Args a) {
  using L = Smem<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Ptrs t = smem_ptrs<DP>(smem);
  const int k0 = blockIdx.x * kBN, h = blockIdx.y, b = blockIdx.z;
  const int T = a.T, S = a.S, D = a.D;
  const int hk = h / (a.Hq / a.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kv_len = min(max(a.kv_lens[b], 0), S);
  const long long bh = static_cast<long long>(b) * a.Hq + h;
  const long long q_stride = static_cast<long long>(a.Hq) * D;
  const long long kv_stride = static_cast<long long>(a.Hkv) * D;
  const long long q_off = (static_cast<long long>(b) * T * a.Hq + h) * D;
  const long long kv_off = (static_cast<long long>(b) * S * a.Hkv + hk) * D;
  const bf16* pb_h = a.pos_bias + static_cast<long long>(h) * T * S;
  float* dk = static_cast<float*>(a.out_a);
  float* dv = static_cast<float*>(a.out_b);
  // row kj of this q head's dk / dv
  auto out_row = [&](float* base, int kj) {
    return base + ((static_cast<long long>(b) * S + kj) * a.Hq + h) * D;
  };

  if (k0 >= kv_len) {  // every key of the tile is masked: zero gradients
    for (int i = threadIdx.x; i < kBN * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      if (k0 + r < S) {
        out_row(dk, k0 + r)[d] = 0.f;
        out_row(dv, k0 + r)[d] = 0.f;
      }
    }
    return;
  }
  load_rows<DP, kThreads>(t.k, L::LDQ, a.k + kv_off, kv_stride, k0, kv_len,
                          D);
  load_rows<DP, kThreads>(t.v, L::LDQ, a.v + kv_off, kv_stride, k0, kv_len,
                          D);
  Acc adk[DP / 16], adv[DP / 16];
#pragma unroll
  for (int dc = 0; dc < DP / 16; ++dc) {
    wmma::fill_fragment(adk[dc], 0.f);
    wmma::fill_fragment(adv[dc], 0.f);
  }

  for (int i0 = 0; i0 < T; i0 += kBM) {
    // q / dO rows past T are zero-filled and get p = ds = 0
    load_rows<DP, kThreads>(t.q, L::LDQ, a.q + q_off, q_stride, i0, T, D);
    load_rows<DP, kThreads>(t.dout, L::LDQ, a.dout + q_off, q_stride, i0, T,
                            D);
    load_row_stats(t, a.lse, a.delta, a.gate, bh, i0, T, a.has_bias);
    __syncthreads();
    warp_abt<DP>(t.q, t.k, t.s);
    warp_abt<DP>(t.dout, t.v, t.dp);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r, qi = i0 + row;
      const float g = t.gate[row], m = t.lse[row], dl = t.delta[row];
#pragma unroll
      for (int c = 0; c < kBN / 32; ++c) {
        const int col = lane + 32 * c, kj = k0 + col;
        float p = 0.f, ds = 0.f;
        if (qi < T && kj < kv_len) {
          float s = t.s[row * L::LDS + col] * a.scale;
          if (a.has_bias)
            s += g * __bfloat162float(
                         pb_h[static_cast<long long>(qi) * S + kj]);
          p = expf(s - m);
          ds = p * (t.dp[row * L::LDS + col] - dl);
        }
        t.p[row * L::LDP + col] = __float2bfloat16(p);
        t.ds[row * L::LDP + col] = __float2bfloat16(ds);
      }
    }
    __syncthreads();                          // all query rows of p / ds
    warp_acc<DP, true>(adv, t.p, t.dout);    // dv += p^T . dO
    warp_acc<DP, true>(adk, t.ds, t.q);      // dk += ds^T . q
    __syncthreads();                          // q / dO / p / ds refilled
  }

  const float* st = stage<DP>(adk, t.s);
  for (int r = 0; r < 16; ++r) {
    const int kj = k0 + warp * 16 + r;
    if (kj >= S) break;
    for (int d = lane; d < D; d += 32)
      out_row(dk, kj)[d] = st[r * L::LDO + d] * a.scale;
  }
  __syncwarp();
  st = stage<DP>(adv, t.s);
  for (int r = 0; r < 16; ++r) {
    const int kj = k0 + warp * 16 + r;
    if (kj >= S) break;
    for (int d = lane; d < D; d += 32) out_row(dv, kj)[d] = st[r * L::LDO + d];
  }
}

// ---- #10: dpb, summed over the batch -------------------------------------
template <int DP>
__global__ void __launch_bounds__(kThreads) bwd_dpb_kernel(Args a) {
  using L = Smem<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Ptrs t = smem_ptrs<DP>(smem);
  const int k0 = blockIdx.x * kBN, q0 = blockIdx.y * kBM, h = blockIdx.z;
  const int T = a.T, S = a.S, D = a.D;
  const int hk = h / (a.Hq / a.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long q_stride = static_cast<long long>(a.Hq) * D;
  const long long kv_stride = static_cast<long long>(a.Hkv) * D;
  const bf16* pb_h = a.pos_bias + static_cast<long long>(h) * T * S;

  float pbv[16][kBN / 32], acc[16][kBN / 32];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int qi = q0 + warp * 16 + r;
#pragma unroll
    for (int c = 0; c < kBN / 32; ++c) {
      const int kj = k0 + lane + 32 * c;
      pbv[r][c] = qi < T && kj < S ? __bfloat162float(
                                         pb_h[static_cast<long long>(qi) * S
                                              + kj])
                                   : 0.f;
      acc[r][c] = 0.f;
    }
  }

  for (int b = 0; b < a.B; ++b) {
    const int kv_len = min(max(a.kv_lens[b], 0), S);
    if (k0 >= kv_len) continue;  // the tile's keys are all masked
    const long long bh = static_cast<long long>(b) * a.Hq + h;
    const long long q_off = (static_cast<long long>(b) * T * a.Hq + h) * D;
    const long long kv_off =
        (static_cast<long long>(b) * S * a.Hkv + hk) * D;
    load_rows<DP, kThreads>(t.q, L::LDQ, a.q + q_off, q_stride, q0, T, D);
    load_rows<DP, kThreads>(t.dout, L::LDQ, a.dout + q_off, q_stride, q0, T,
                            D);
    load_rows<DP, kThreads>(t.k, L::LDQ, a.k + kv_off, kv_stride, k0, kv_len,
                            D);
    load_rows<DP, kThreads>(t.v, L::LDQ, a.v + kv_off, kv_stride, k0, kv_len,
                            D);
    load_row_stats(t, a.lse, a.delta, a.gate, bh, q0, T, 1);
    __syncthreads();
    warp_abt<DP>(t.q, t.k, t.s);
    warp_abt<DP>(t.dout, t.v, t.dp);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r, qi = q0 + row;
      const float g = t.gate[row], m = t.lse[row], dl = t.delta[row];
#pragma unroll
      for (int c = 0; c < kBN / 32; ++c) {
        const int col = lane + 32 * c, kj = k0 + col;
        if (qi < T && kj < kv_len) {
          const float s = t.s[row * L::LDS + col] * a.scale + g * pbv[r][c];
          acc[r][c] += g * (expf(s - m) * (t.dp[row * L::LDS + col] - dl));
        }
      }
    }
    __syncthreads();  // the tiles are refilled for the next row
  }

  bf16* dpb = static_cast<bf16*>(a.out_a);
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int qi = q0 + warp * 16 + r;
#pragma unroll
    for (int c = 0; c < kBN / 32; ++c) {
      const int kj = k0 + lane + 32 * c;
      if (qi < T && kj < S)
        dpb[(static_cast<long long>(h) * T + qi) * S + kj] =
            __float2bfloat16(acc[r][c]);
    }
  }
}

template <int DP>
cudaError_t launch(int which, const Args& a, cudaStream_t stream) {
  using L = Smem<DP>;
  void (*kern)(Args);
  dim3 grid;
  if (which == 0) {
    kern = bwd_dq_kernel<DP>;
    grid = dim3((a.T + kBM - 1) / kBM, a.Hq, a.B);
  } else if (which == 1) {
    kern = bwd_dkv_kernel<DP>;
    grid = dim3((a.S + kBN - 1) / kBN, a.Hq, a.B);
  } else {
    kern = bwd_dpb_kernel<DP>;
    grid = dim3((a.S + kBN - 1) / kBN, (a.T + kBM - 1) / kBM, a.Hq);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::bytes));
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, L::bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

MTASR_EXPORT_ERROR_STRING

// which: 0 = #8 (out_a dq bf16 [B, T, Hq, D], out_b dg bf16 [B, Hq, T] or
// null without a bias), 1 = #9 (out_a dk, out_b dv, f32 [B, S, Hq, D]),
// 2 = #10 (out_a dpb bf16 [Hq, T, S]; needs the bias). D % 8 == 0 and
// D <= 128; pos_bias / gate may be null when has_bias == 0.
extern "C" int flash_attention_bwd_launch(
    int which, const void* q, const void* k, const void* v,
    const void* pos_bias, const void* gate, const void* kv_lens,
    const void* lse, const void* delta, const void* dout, void* out_a,
    void* out_b, int B, int T, int S, int Hq, int Hkv, int D, float scale,
    int has_bias, void* stream) {
  if (D % 8 != 0 || D > 128 || Hkv <= 0 || Hq % Hkv != 0 || which < 0 ||
      which > 2 || (which == 2 && !has_bias) || (which == 1 && !out_b) ||
      (which == 0 && has_bias && !out_b))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v),
               static_cast<const bf16*>(pos_bias),
               static_cast<const bf16*>(gate),
               static_cast<const int*>(kv_lens),
               static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               static_cast<const bf16*>(dout), out_a, out_b, B, T, S, Hq,
               Hkv, D, scale, has_bias};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(D <= 64 ? launch<64>(which, a, st)
                                  : launch<128>(which, a, st));
}
