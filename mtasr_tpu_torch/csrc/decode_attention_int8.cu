// One-token (decode-step) attention over the int8 KV cache, per query row:
//
//   sq  = max(max|q| * f32(1/127), 1e-12),  q8 = clip(rint(q / sq))
//   s   = f32(q8 . k8) * (sq * D^-0.5) * ks + (mask ? 0 : -1e9)
//   p   = (e / sum e) * vs,  e = exp(s - max s)
//   sp  = max(max p * f32(1/127), 1e-12),   p8 = clip(rint(p / sp))
//   out = f32(p8 . v8) * sp
//
// q [B, Hq, D] bf16; k_cache / v_cache [B, S, Hkv*D] int8; kv_scale
// [B, 2*Hkv, S] bf16 with the rows of kv head h interleaved (k scales in
// row 2h, v scales in row 2h+1); mask [B, S] bool; out [B, Hq, D] bf16.
// Both products are int8 x int8 summed exactly in int32; every f32 step
// runs in the TPU kernel's order without contractions (`__fmul_rn`,
// `__fadd_rn`, IEEE `expf` and division), since one ulp of p can move
// rint(p / sp) to the neighbouring integer.
//
// Replaces the TPU kernel `decode_attention_int8` / `_kernel_int8` of
// mtasr_tpu/ops/pallas/decode_attention.py (its L > 1 sibling, #7, stays
// in decode_attention_chunk.cu). On the H100 the step is bound by reading
// the cache (LLaMA-1B, S = 214: 0.9 MB of K and V a layer at B = 8) and,
// at small batch, by latency: one (batch row, kv head) a block gives B *
// Hkv blocks (64 at B = 8) on 132 SMs, each walking all S keys. The design
// is the bf16 decode kernel's (decode_attention.cu) with one more exchange:
//
// - a cluster of C blocks (C from the wrapper's `cluster_size_int8`)
//   splits one (b, kv head)'s S keys into C contiguous slices (on the
//   H100 a cluster ties one block at the served S = 214, where the chain
//   of launch, loads, sweeps and barriers is the time, and gains where
//   slices are long);
// - each block puts every load of its slice in flight at once: the K tiles,
//   the V tiles behind them (a ring of 4 slots of 8 KB: 128 keys at D =
//   64), the k and v scales and the mask bytes (read in place past 4096
//   keys), all 16-byte `cp.async` copies with neighbouring lanes on
//   neighbouring 16 bytes (4 lanes a 64-byte key row);
// - one warp a query row quantizes q, once per block;
// - a group of lanes forms one key's G scores with `__dp4a` (16 bytes a
//   lane) and a butterfly leaves each lane one row's sum (3 shuffles at
//   G = 4 over 4 lanes); the slice's scores stay in shared memory (or in a
//   global scratch when a slice of a long cache does not fit);
// - the softmax statistics, one warp a row, go through distributed shared
//   memory in three exchanges, each block pushing its values into the
//   others' shared memory before a cluster barrier (so what it reads after
//   the barrier is local): (a) each slice's (max, sum of exp(s - max)),
//   merged by every block in rank order into the row's (M, L); (b) each
//   slice's max of p = (e / L) * vs, which gives the row's p scale sp
//   before any p is rounded; (c) the slice's int32 partial of p8 . v8,
//   which ranks 1..C-1 store into rank 0's shared memory and rank 0 sums,
//   scales by sp and writes as bf16. Every block forms M, L and sp the same
//   way, and no float is summed in a varying order (integer sums are exact
//   in any): a launch gives the same bits every time. (Exchanging the max
//   first and the slice sums of exp(s - M) second costs a fourth barrier,
//   about half a microsecond at B = 8 on the H100, and moved no row of
//   tools/decode_probe.py's inputs: L's rounding cancels in p / sp to first
//   order.)
// - p8 goes packed, 4 keys a word, and V's 4 key rows of a column word are
//   transposed by byte permutes, so p8 . v8 is one `__dp4a` for 4 keys.
//
// D = 64 and 128 (4 and 8 lanes a key) have compile-time paths; any D that
// is a multiple of 4 up to 256 takes the general one (4-byte copies when
// D % 16 != 0).
#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 4;             // ring slots of K / V tiles
constexpr int kSlotBytes = 8192;      // int8 bytes a slot
constexpr int kScoreFloats = 24576;   // scores a block keeps in shared memory
constexpr int kSideKeys = 4096;       // longest slice whose scales and mask
                                      // are staged in shared memory
constexpr float kInv127 = 1.f / 127.f;

struct Params {
  const bf16* q;
  const int8_t *k, *v;
  const bf16* kv_scale;
  const unsigned char* mask;
  bf16* out;
  float* scratch;  // [B, Hkv, G, S] f32 scores, or null: in shared memory
  int S, Hkv, D, DP, TK, vec16, side;
  float scale;
};

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }
__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }

// Byte offsets of one block's shared memory; the host computes the same
// for the launch. n_max = ceil(S / C) keys, the longest slice.
struct Layout {
  int n_max, nt, slot, red, recv, q8, stat, side_k, side_v, side_m, scores,
      bytes;
  __host__ __device__ Layout(int G, int DP, int TK, int S, int C,
                             bool scratch, bool side) {
    n_max = (S + C - 1) / C;
    nt = (n_max + TK - 1) / TK;
    // a slot holds whole groups of 4 keys (the V pass reads 4 rows at once)
    slot = (nt == 1 ? round4(n_max) : TK) * DP;  // a multiple of 16
    const int slots = 2 * nt < kSlots ? 2 * nt : kSlots;
    red = slots * slot;                          // int32 [G][DP], p8 . v8
    recv = red + 4 * G * DP;                     // int32 [C-1][G][DP], rank 0's
    q8 = recv + 4 * (C - 1) * G * DP;            // int8 [G][DP], q quantized
    stat = q8 + G * DP;                          // f32 [2][G] + [C][3][G]
    side_k = stat + round16(4 * G * (2 + 3 * C));
    const int sb = side ? round16(2 * n_max + 16) : 0;
    side_v = side_k + sb;
    side_m = side_v + sb;
    scores = side_m + (side ? round16(n_max + 16) : 0);
    bytes = scores + (scratch ? 0 : 4 * G * round4(n_max));
  }
};

// Bytes [src, src + n) of global memory into shared memory at dst + (src &
// 15), in 16-byte copies from src rounded down to 16 (the bytes before src
// lie in the same 16-byte-aligned tensor), the last cut at src + n.
// Returns src & 15.
__device__ __forceinline__ int stage_bytes(uint32_t dst, const void* src,
                                           int n, int tid) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const int off = static_cast<int>(a & 15), total = off + n;
  const char* a0 = reinterpret_cast<const char*>(a - off);
  for (int i = tid; 16 * i < total; i += kThreads)
    cp_async16(dst + 16 * i, a0 + 16 * i, min(16, total - 16 * i));
  return off;
}

// round(x / s) clipped to [-127, 127]; rintf rounds half to even as
// jnp.round does.
__device__ __forceinline__ int quant8(float x, float s) {
  return static_cast<int>(fminf(fmaxf(rintf(x / s), -127.f), 127.f));
}

// The G partial dot products of a key held by its LPK lanes, summed over
// them: a butterfly that halves the rows each round while a lane holds
// more than RPL = max(1, P / LPK) of them (P = G rounded up to a power of
// two), then plain sums. Lane l ends with the whole sums of rows
// row0(l) .. row0(l) + RPL - 1 (a padding row past G sums zeros).
template <int G, int LPK>
struct Butterfly {
  static constexpr int P = pow2_at_least(G);
  static constexpr int RPL = P > LPK ? P / LPK : 1;
  static constexpr int H = log2_of(P < LPK ? P : LPK);   // halving rounds
  __device__ static int row0(int c) {
    return (c >> (log2_of(LPK) - H)) * RPL;
  }
  // only one lane of those holding the same rows writes them
  __device__ static bool writer(int c) {
    return (c & ((1 << (log2_of(LPK) - H)) - 1)) == 0;
  }
  __device__ static void reduce(const int (&dot)[G], int lane,
                                int (&out)[RPL]) {
    int v[P];
#pragma unroll
    for (int g = 0; g < P; ++g) v[g] = g < G ? dot[g] : 0;
#pragma unroll
    for (int k = 0; k < log2_of(LPK); ++k) {
      const int o = LPK >> (k + 1);
      if (k < H) {
        const int w = P >> k;                    // rows before this round
        const bool hi = (lane & o) != 0;
#pragma unroll
        for (int j = 0; j < w / 2; ++j) {
          const int send = hi ? v[j] : v[j + w / 2];
          const int keep = hi ? v[j + w / 2] : v[j];
          v[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      } else {
#pragma unroll
        for (int j = 0; j < RPL; ++j)
          v[j] += __shfl_xor_sync(0xffffffffu, v[j], o);
      }
    }
#pragma unroll
    for (int j = 0; j < RPL; ++j) out[j] = v[j];
  }
};

// LPK: lanes a key known at compile time (4: D = 64, 8: D = 128), or 0:
// any D, from the parameters.
template <int G, int LPK>
__global__ void __launch_bounds__(kThreads)
decode_int8_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = LPK ? LPK * 16 : p.D, DP = LPK ? LPK * 16 : p.DP;
  const int TK = LPK ? kSlotBytes / (LPK * 16) : p.TK, S = p.S;
  const int C = gridDim.x, rank = blockIdx.x, hk = blockIdx.y,
            b = blockIdx.z;
  const Layout lay(G, DP, TK, S, C, p.scratch != nullptr, p.side != 0);
  const uint32_t sm0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  int* red = reinterpret_cast<int*>(smem + lay.red);
  int* recv = reinterpret_cast<int*>(smem + lay.recv);
  int* q8s = reinterpret_cast<int*>(smem + lay.q8);
  float* sqs = reinterpret_cast<float*>(smem + lay.stat);  // [G] sq * scale
  float* sps = sqs + G;       // [G] the row's p scale
  // what the cluster's ranks push here, [C][G] each: the slice's max s,
  // its sum of exp(s - max), its max p
  float* in_max = sps + G;
  float* in_sum = in_max + C * G;
  float* in_pmax = in_sum + C * G;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s0 = static_cast<int>(static_cast<long long>(S) * rank / C);
  const int n = static_cast<int>(static_cast<long long>(S) * (rank + 1) / C) -
                s0;
  const int nt = (n + TK - 1) / TK;
  const long long row = static_cast<long long>(p.Hkv) * D;
  const int8_t* kb = p.k + (static_cast<long long>(b) * S + s0) * row + hk * D;
  const int8_t* vb = p.v + (static_cast<long long>(b) * S + s0) * row + hk * D;
  const bf16* ksr = p.kv_scale +
                    (static_cast<long long>(b) * 2 * p.Hkv + 2 * hk) * S + s0;
  const bf16* vsr = ksr + S;
  const unsigned char* mb = p.mask + static_cast<long long>(b) * S + s0;
  // scores [g][s] of this slice, ld apart (in shared memory a multiple of
  // 4: the p8 words of 4 keys take the place of their first score)
  float* sc = p.scratch != nullptr
                  ? p.scratch +
                        (static_cast<long long>(b) * p.Hkv + hk) * G * S + s0
                  : reinterpret_cast<float*>(smem + lay.scores);
  const int ld = p.scratch != nullptr ? S : round4(n);

  // the slice's scales and mask, staged in the first copy group, or read
  // in place past kSideKeys
  const bf16 *ksp = ksr, *vsp = vsr;
  const unsigned char* mkp = mb;
  if (p.side) {
    ksp = reinterpret_cast<const bf16*>(
        smem + lay.side_k + stage_bytes(sm0 + lay.side_k, ksr, 2 * n, tid));
    vsp = reinterpret_cast<const bf16*>(
        smem + lay.side_v + stage_bytes(sm0 + lay.side_v, vsr, 2 * n, tid));
    mkp = smem + lay.side_m + stage_bytes(sm0 + lay.side_m, mb, n, tid);
  }

  // load i of the ring: K tile i (i < nt), then V tile i - nt; one commit
  // group each, empty past the last. Thread tid copies unit cu of rows
  // ru, ru + rstep, .. (a unit: 16 bytes, or 4 when not vec16)
  const bool vec16 = LPK ? true : p.vec16 != 0;
  const int units = vec16 ? D / 16 : D / 4;
  const int rstep = kThreads / units, ru = tid / units, cu = tid - ru * units;
  auto issue = [&](int i) {
    if (i < 2 * nt && ru < rstep) {
      const bool is_v = i >= nt;
      const int t = is_v ? i - nt : i;
      const int rows = min(TK, n - t * TK);
      const int8_t* src = (is_v ? vb : kb) +
                          (static_cast<long long>(t) * TK + ru) * row;
      uint32_t dst = sm0 + (i % kSlots) * lay.slot + ru * DP;
      if (vec16) {
        src += cu * 16;
        dst += cu * 16;
        for (int r = ru; r < rows; r += rstep) {
          cp_async16(dst, src);
          src += rstep * row;
          dst += rstep * DP;
        }
      } else {
        src += cu * 4;
        dst += cu * 4;
        for (int r = ru; r < rows; r += rstep) {
          cp_async4(dst, src);
          src += rstep * row;
          dst += rstep * DP;
        }
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < kSlots; ++i) issue(i);
  // every block of the cluster has started before the first push into
  // its shared memory (the wait comes before exchange (a))
  if (C > 1)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  for (int i = tid; i < G * DP; i += kThreads) red[i] = 0;

  // q: per-row int8 quantization, one warp a row; packed words of 4,
  // zeros in columns D..DP-1
  const bf16* qb = p.q + (static_cast<long long>(b) * p.Hkv + hk) * G * D;
  const int W = D / 4, WP = DP / 4;
  for (int g = warp; g < G; g += kWarps) {
    float x[2][4] = {};
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int w = lane + 32 * j;
      if (w < W) {
        const uint2 u = *reinterpret_cast<const uint2*>(qb + g * D + 4 * w);
        const float2 lo = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 hi = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u.y));
        x[j][0] = lo.x, x[j][1] = lo.y, x[j][2] = hi.x, x[j][3] = hi.y;
#pragma unroll
        for (int i = 0; i < 4; ++i) amax = fmaxf(amax, fabsf(x[j][i]));
      }
    }
    const float s = fmaxf(__fmul_rn(warp_max(amax), kInv127), 1e-12f);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int w = lane + 32 * j;
      if (w < WP) {
        int word = 0;
        if (w < W) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            word |= (quant8(x[j][i], s) & 0xff) << (8 * i);
        }
        q8s[g * WP + w] = word;
      }
    }
    if (lane == 0) sqs[g] = __fmul_rn(s, p.scale);
  }

  // this lane's 16-byte chunk c of a key row (lanes of a key: lpk, a power
  // of two) and the G query rows' words there
  const int nc = DP / 16;
  const int lpk = LPK ? LPK : pow2_at_least(nc);
  const int c = lane & (lpk - 1);
  cp_async_wait<kSlots - 1>();
  __syncthreads();                      // q8, the side and K tile 0 landed
  int q8r[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    int4 u = make_int4(0, 0, 0, 0);
    if (c < nc) u = *reinterpret_cast<const int4*>(q8s + g * WP + 4 * c);
    q8r[g][0] = u.x, q8r[g][1] = u.y, q8r[g][2] = u.z, q8r[g][3] = u.w;
  }

  // K pass: s = f32(q8 . k8) * (sq * scale) * ks + bias, in that order
  auto put = [&](int g, int s, int dot) {
    const float bias = mkp[s] ? 0.f : -1e9f;
    sc[g * ld + s] = __fadd_rn(
        __fmul_rn(__fmul_rn(static_cast<float>(dot), sqs[g]),
                  __bfloat162float(ksp[s])),
        bias);
  };
  auto score_key = [&](const unsigned char* kt, int t, int r, int rows) {
    int dot[G];
#pragma unroll
    for (int g = 0; g < G; ++g) dot[g] = 0;
    if (r < rows && c < nc) {
      const int4 kk = *reinterpret_cast<const int4*>(kt + r * DP + 16 * c);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        dot[g] = __dp4a(q8r[g][0], kk.x, dot[g]);
        dot[g] = __dp4a(q8r[g][1], kk.y, dot[g]);
        dot[g] = __dp4a(q8r[g][2], kk.z, dot[g]);
        dot[g] = __dp4a(q8r[g][3], kk.w, dot[g]);
      }
    }
    if constexpr (LPK != 0) {
      using BF = Butterfly<G, LPK>;
      int sum[BF::RPL];
      BF::reduce(dot, lane, sum);
      if (r < rows && BF::writer(c)) {
#pragma unroll
        for (int j = 0; j < BF::RPL; ++j) {
          const int g = BF::row0(c) + j;
          if (g < G) put(g, t * TK + r, sum[j]);
        }
      }
    } else {
      for (int o = lpk >> 1; o > 0; o >>= 1)
#pragma unroll
        for (int g = 0; g < G; ++g)
          dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
      if (r < rows && c == 0) {
#pragma unroll
        for (int g = 0; g < G; ++g) put(g, t * TK + r, dot[g]);
      }
    }
  };
  for (int t = 0; t < nt; ++t) {
    if (t > 0) {
      cp_async_wait<kSlots - 1>();
      __syncthreads();
    }
    const int rows = min(TK, n - t * TK);
    const unsigned char* kt = smem + (t % kSlots) * lay.slot;
    const int step = kThreads / lpk;    // keys a block step
    for (int r0 = 0; r0 < rows; r0 += step)
      score_key(kt, t, r0 + tid / lpk, rows);
    __syncthreads();                    // slot t % kSlots is free
    issue(t + kSlots);
  }

  // (a) the slice's (max, sum of exp(s - max)) of row g, one warp a row,
  // lane r pushing them into rank r; then the row's (M, L) from the C
  // slices' (lane r takes rank r's): M the largest max, L their sums
  // scaled to it and added in rank order, the same in every block; p =
  // (e / L) * vs in place of the scores and (b) the slice's max of p,
  // pushed as well
  cg::cluster_group cluster = cg::this_cluster();
  if (C > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  auto push = [&](float* in, int g, float v) {
    if (lane < C)
      (C > 1 ? cluster.map_shared_rank(in, lane) : in)[rank * G + g] = v;
  };
  for (int g = warp; g < G; g += kWarps) {
    const float* x = sc + g * ld;
    float mx = -INFINITY, sm = 0.f;
    for (int s = lane; s < n; s += 32) mx = fmaxf(mx, x[s]);
    mx = warp_max(mx);
    for (int s = lane; s < n; s += 32) sm += expf(x[s] - mx);
    push(in_max, g, mx);
    push(in_sum, g, warp_sum(sm));
  }
  if (C > 1) cluster.sync(); else __syncwarp();
  for (int g = warp; g < G; g += kWarps) {
    const float mr = lane < C ? in_max[lane * G + g] : -INFINITY;
    const float M = warp_max(mr);
    const float term =
        lane < C ? __fmul_rn(in_sum[lane * G + g], expf(mr - M)) : 0.f;
    float L = 0.f;
    for (int r = 0; r < C; ++r) L += __shfl_sync(0xffffffffu, term, r);
    float* x = sc + g * ld;
    float pm = 0.f;
    for (int s = lane; s < n; s += 32) {
      const float pv =
          __fmul_rn(expf(x[s] - M) / L, __bfloat162float(vsp[s]));
      x[s] = pv;
      pm = fmaxf(pm, pv);
    }
    push(in_pmax, g, warp_max(pm));
  }
  if (C > 1)
    cluster.sync();                     // every slice's max p is here
  else
    __syncthreads();

  // the row's p scale from the C slices' max p, then p8 = clip(rint(p /
  // sp)) of keys 4j .. 4j + 3 packed into one word in place of the first
  // one's p (zeros past the slice)
  for (int g = warp; g < G; g += kWarps) {
    const float pm = warp_max(lane < C ? in_pmax[lane * G + g] : 0.f);
    const float sp = fmaxf(__fmul_rn(pm, kInv127), 1e-12f);
    float* x = sc + g * ld;
    for (int s = 4 * lane; s < n; s += 128) {
      int word = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (s + i < n) word |= (quant8(x[s + i], sp) & 0xff) << (8 * i);
      reinterpret_cast<int*>(x)[s] = word;
    }
    if (lane == 0) sps[g] = sp;
  }
  __syncthreads();

  // V pass: thread (key slice ks, word wv) sums p8 . v8 over the groups of
  // 4 keys ks, ks + n_ks, .. of each tile for its 4 columns, in int32: the
  // 4 keys' words of v transposed by byte permutes into one word a column,
  // then one __dp4a a column and row
  const int n_ks = kThreads / W, wv = tid % W, ks = tid / W;
  const int* pk = reinterpret_cast<const int*>(sc);
  int acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[g][i] = 0;
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<kSlots - 1>();
    __syncthreads();
    const unsigned char* vt =
        smem + ((nt + t) % kSlots) * lay.slot + 4 * wv;
    const int groups = (min(TK, n - t * TK) + 3) / 4;
    if (ks < n_ks) {
      for (int j = ks; j < groups; j += n_ks) {
        // rows past the slice hold anything: their p8 are 0
        const unsigned char* v4 = vt + 4 * j * DP;
        const int w0 = *reinterpret_cast<const int*>(v4);
        const int w1 = *reinterpret_cast<const int*>(v4 + DP);
        const int w2 = *reinterpret_cast<const int*>(v4 + 2 * DP);
        const int w3 = *reinterpret_cast<const int*>(v4 + 3 * DP);
        const int lo01 = __byte_perm(w0, w1, 0x5140);
        const int hi01 = __byte_perm(w0, w1, 0x7362);
        const int lo23 = __byte_perm(w2, w3, 0x5140);
        const int hi23 = __byte_perm(w2, w3, 0x7362);
        const int col[4] = {__byte_perm(lo01, lo23, 0x5410),
                            __byte_perm(lo01, lo23, 0x7632),
                            __byte_perm(hi01, hi23, 0x5410),
                            __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int pw = pk[g * ld + t * TK + 4 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[g][i] = __dp4a(pw, col[i], acc[g][i]);
        }
      }
    }
    __syncthreads();
    issue(nt + t + kSlots);
  }

  // (c) the block's partial: over a warp's key slices by shuffles
  // (compile-time paths), then shared-memory integer atomics; ranks
  // 1..C-1 store theirs into rank 0's receive slots
  bool adds = ks < n_ks;
  if constexpr (LPK != 0) {
#pragma unroll
    for (int o = LPK * 4; o < 32; o <<= 1)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], o);
    adds = lane < W;
  }
  if (adds) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        atomicAdd(red + g * DP + 4 * wv + i, acc[g][i]);
  }
  __syncthreads();
  if (C > 1) {
    if (rank > 0) {
      int4* dst = reinterpret_cast<int4*>(cluster.map_shared_rank(recv, 0) +
                                          (rank - 1) * G * DP);
      for (int i = tid; i < G * DP / 4; i += kThreads)
        dst[i] = reinterpret_cast<const int4*>(red)[i];
    }
    cluster.sync();                     // every partial is in rank 0
  }
  if (rank == 0) {
    bf16* ob = p.out + (static_cast<long long>(b) * p.Hkv + hk) * G * D;
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, at = g * DP + i - g * D;
      int sum = red[at];
      for (int r = 1; r < C; ++r) sum += recv[(r - 1) * G * DP + at];
      ob[i] = __float2bfloat16(__fmul_rn(static_cast<float>(sum), sps[g]));
    }
  }
}

// the most shared memory a launch of G rows may take: D 256, 8 ranks, a
// full score buffer with or without the staged scales and mask
size_t max_smem(int G) {
  const int n_scores = kScoreFloats / G;
  const int n_side = n_scores < kSideKeys ? n_scores : kSideKeys;
  const int a = Layout(G, 256, kSlotBytes / 256, 8 * n_scores, 8, false,
                       n_scores <= kSideKeys).bytes;
  const int b = Layout(G, 256, kSlotBytes / 256, 8 * n_side, 8, false,
                       true).bytes;
  return static_cast<size_t>(a > b ? a : b);
}

template <int G, int LPK>
cudaError_t launch(const Params& p, int B, int C, cudaStream_t stream) {
  static bool attr_set = false;
  static int clusters_ok[9] = {};  // by C: 1 fits, -1 refused, 0 not asked
  const size_t most = max_smem(G);
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_int8_kernel<G, LPK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(most));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, p.Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Layout(G, p.DP, p.TK, p.S, C, p.scratch != nullptr,
                                p.side != 0).bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  if (C > 1 && clusters_ok[C] == 0) {
    // asked once per cluster size, at the largest shared memory a launch
    // may take: a card that cannot hold such a cluster refuses the launch
    cudaLaunchConfig_t probe = cfg;
    probe.dynamicSmemBytes = most;
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(
        &n, decode_int8_kernel<G, LPK>, &probe);
    if (e != cudaSuccess) return e;
    clusters_ok[C] = n > 0 ? 1 : -1;
  }
  if (clusters_ok[C] < 0) return cudaErrorLaunchOutOfResources;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, decode_int8_kernel<G, LPK>, p);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int G>
cudaError_t launch_g(const Params& p, int B, int C, cudaStream_t stream) {
  if (p.D == 64) return launch<G, 4>(p, B, C, stream);
  if (p.D == 128) return launch<G, 8>(p, B, C, stream);
  return launch<G, 0>(p, B, C, stream);
}

}  // namespace

MTASR_EXPORT_ERROR_STRING

// G = Hq / Hkv in [1, 8]; D a multiple of 4 in [4, 256]; C (blocks a
// (b, kv head) is split over, one cluster) in [1, min(8, S)]; every pointer
// 16-byte aligned. scratch: f32 [B, Hkv, G, S], needed (else refused) when
// a slice's G * ceil(S / C) scores pass kScoreFloats.
extern "C" int decode_attention_int8_launch(
    const void* q, const void* k_cache, const void* v_cache,
    const void* kv_scale, const void* mask, void* out, void* scratch, int B,
    int S, int Hq, int Hkv, int D, int C, float scale, void* stream) {
  if (D % 4 != 0 || D > 256 || D < 4 || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq / Hkv > 8 || B < 1 || S < 1 || C < 1 || C > 8 || C > S)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv, n_max = (S + C - 1) / C;
  if (scratch == nullptr &&
      static_cast<long long>(G) * n_max > kScoreFloats)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k_cache) |
      reinterpret_cast<uintptr_t>(v_cache) |
      reinterpret_cast<uintptr_t>(kv_scale) | reinterpret_cast<uintptr_t>(mask);
  if (addr % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const int8_t*>(k_cache);
  p.v = static_cast<const int8_t*>(v_cache);
  p.kv_scale = static_cast<const bf16*>(kv_scale);
  p.mask = static_cast<const unsigned char*>(mask);
  p.out = static_cast<bf16*>(out);
  p.scratch = static_cast<float*>(scratch);
  p.S = S;
  p.Hkv = Hkv;
  p.D = D;
  p.DP = round16(D);
  p.TK = kSlotBytes / p.DP / 4 * 4;   // whole groups of 4 keys a tile
  p.vec16 = D % 16 == 0;
  p.side = n_max <= kSideKeys;
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (G) {
#define MTASR_DECODE_INT8_CASE(G_)                                         \
  case G_:                                                                 \
    return static_cast<int>(launch_g<G_>(p, B, C, st));
    MTASR_DECODE_INT8_CASE(1)
    MTASR_DECODE_INT8_CASE(2)
    MTASR_DECODE_INT8_CASE(3)
    MTASR_DECODE_INT8_CASE(4)
    MTASR_DECODE_INT8_CASE(5)
    MTASR_DECODE_INT8_CASE(6)
    MTASR_DECODE_INT8_CASE(7)
    MTASR_DECODE_INT8_CASE(8)
#undef MTASR_DECODE_INT8_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
