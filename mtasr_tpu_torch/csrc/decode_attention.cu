// One-token (decode-step) GQA attention over the merged-lane KV cache.
//
//   out[b, hk*G + g] = softmax_s(q . k_s / sqrt(D) + (mask[b, s] ? 0 : -1e9))
//                      @ v_s,     k_s = k_cache[b, s, hk*D : (hk+1)*D]
//
// q [B, Hq, D], k_cache / v_cache [B, S, Hkv*D] bf16, mask [B, S] bool;
// out [B, Hq, D] bf16. Softmax in f32; p = exp(s - M) / L with the row's
// global max M and sum L is rounded to bf16 before p @ v, as the TPU kernel
// does.
//
// Replaces the TPU kernel `decode_attention` / `_kernel` of
// mtasr_tpu/ops/pallas/decode_attention.py. On the H100 the step is bound
// by reading the cache (LLaMA-1B, S = 214: 3.5 MB of K and V per layer at
// B = 8) and, at small batch, by latency: one (batch row, kv head) is too
// little work for a block to keep the memory system busy, and B * Hkv
// blocks (64 at B = 8) leave half the 132 SMs idle. Design:
//
// - a cluster of C blocks (C from the wrapper's `cluster_size`: enough
//   that B * Hkv * C blocks cover the SMs, raised until a slice fits one
//   ring tile where it can; 1 from B * Hkv >= 132 on) splits one (b, kv
//   head)'s S keys into C contiguous slices;
// - each block streams its slice's K tiles, then its V tiles, through a
//   ring of 4 shared-memory slots with 16-byte `cp.async` copies (4-byte
//   ones when D % 8 or an address is not 16-byte aligned): neighbouring
//   threads copy neighbouring 16 bytes of a key row, and every load of a
//   short slice is in flight at once, V's behind K's, beside the query
//   rows' and the slice's mask bytes;
// - a group of lanes (8 at D = 64) forms one key's G dot products from the
//   query rows in registers; a butterfly over the group leaves each lane
//   one row's sum (4 shuffles at G = 4 over 8 lanes, not 12), and the
//   block keeps its slice's scores in log2 units (in shared memory, or in
//   a global scratch when a slice of a long cache does not fit): K is read
//   once;
// - each block's (max, sum) of its slice (one warp a query row, `ex2`) is
//   read by the whole cluster through distributed shared memory after one
//   cluster barrier; every block forms the row's global (M, L) the same
//   way (M the largest max, the sums scaled to it and added in rank order),
//   then p for its slice and its partial p @ v from the V tiles (a thread
//   owns 8 columns of a few keys; summed over the block in a fixed order);
//   ranks 1..C-1 store their partials into rank 0's shared memory, and
//   after a second cluster barrier rank 0 sums them in rank order and
//   writes bf16. No atomics: a launch gives the same bits every time.
//
// D = 64 and 128 (16-byte aligned) have compile-time paths (unrolled tiles,
// the butterfly); any other even D takes the general one. With G <= 8
// query rows the products are far below the tensor cores' knee (about 295
// FLOP a byte), so they run on the CUDA cores.
#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"  // ex2, kLog2e

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 4;             // ring slots of K / V tiles
constexpr int kSlotElems = 4096;      // bf16 elements a slot (8 KB)
constexpr int kScoreFloats = 24576;   // scores a block keeps in shared memory
constexpr int kMaskBytes = 4096;      // a slice's mask read once, up front

struct Params {
  const bf16 *q, *k, *v;
  const unsigned char* mask;
  bf16* out;
  float* scratch;  // [B, Hkv, G, S] f32 scores, or null: in shared memory
  int S, Hkv, D, DP, TK, vec16;
  float scale;
};

// Eight bf16 of shared memory (16-byte aligned) as floats.
__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// The G partial dot products of a key held by its LPK lanes, summed over
// them: a butterfly that halves the rows each round (P - 1 shuffles for the
// first log2 P rounds instead of G each), then plain sums. Lane l ends
// with the whole sum of row (l % LPK) / (LPK / P) (a padding row past G
// sums zeros).
template <int G, int LPK>
__device__ __forceinline__ float reduce_scatter(const float (&dot)[G],
                                                int lane) {
  constexpr int P = pow2_at_least(G);
  float v[P];
#pragma unroll
  for (int g = 0; g < P; ++g) v[g] = g < G ? dot[g] : 0.f;
#pragma unroll
  for (int k = 0; k < log2_of(LPK); ++k) {
    const int o = LPK >> (k + 1), w = P >> k;   // rows before this round
    if (w > 1) {
      const bool hi = (lane & o) != 0;
#pragma unroll
      for (int j = 0; j < w / 2; ++j) {
        const float send = hi ? v[j] : v[j + w / 2];
        const float keep = hi ? v[j + w / 2] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
  return v[0];
}

// NC: 16-byte chunks of a key row known at compile time (8: D = 64, 16:
// D = 128, 16-byte copies), or 0: any even D, read from the parameters.
template <int G, int NC>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LPK_C = NC;            // lanes of a key, compile time
  const int DP = NC ? NC * 8 : p.DP, D = NC ? NC * 8 : p.D;
  const int TK = NC ? kSlotElems / (NC * 8) : p.TK, S = p.S;
  const bool vec16 = NC ? true : p.vec16 != 0;
  const int C = gridDim.x, rank = blockIdx.x, hk = blockIdx.y,
            b = blockIdx.z;
  // the ring; the partials ranks 1..C-1 push to rank 0 [C-1][G][DP]; this
  // slice's (max, sum) [G][2]; the slice's (or a tile's) mask bytes; the
  // slice's scores
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* slots = reinterpret_cast<float*>(smem + kSlots * kSlotElems * 2);
  float* lstat = slots + (C - 1) * G * DP;
  unsigned char* msk = reinterpret_cast<unsigned char*>(lstat + G * 2);
  float* red = reinterpret_cast<float*>(smem);         // after the V pass

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s0 = static_cast<int>(static_cast<long long>(S) * rank / C);
  const int n = static_cast<int>(static_cast<long long>(S) * (rank + 1) / C) -
                s0;
  const int nt = (n + TK - 1) / TK;
  const long long row = static_cast<long long>(p.Hkv) * D;
  const bf16* kb = p.k + (static_cast<long long>(b) * S + s0) * row + hk * D;
  const bf16* vb = p.v + (static_cast<long long>(b) * S + s0) * row + hk * D;
  const unsigned char* mb = p.mask + static_cast<long long>(b) * S + s0;
  // scores [g][s] of this slice in log2 units, ld apart
  float* sc = p.scratch != nullptr
                  ? p.scratch +
                        (static_cast<long long>(b) * p.Hkv + hk) * G * S + s0
                  : reinterpret_cast<float*>(msk + kMaskBytes);
  const int ld = p.scratch != nullptr ? S : n;

  // load i of the ring: K tile i (i < nt), then V tile i - nt; one commit
  // group each, empty past the last. Thread tid copies unit cu of rows
  // ru, ru + rstep, .. (a unit: 16 bytes, or 4 when not vec16)
  const int units = vec16 ? D / 8 : D / 2;
  const int rstep = kThreads / units, ru = tid / units, cu = tid - ru * units;
  auto issue = [&](int i) {
    if (i < 2 * nt && ru < rstep) {
      const bool is_v = i >= nt;
      const int t = is_v ? i - nt : i;
      const int rows = min(TK, n - t * TK);
      const bf16* src = (is_v ? vb : kb) +
                        (static_cast<long long>(t) * TK + ru) * row;
      uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(
          ring + (i % kSlots) * kSlotElems + ru * DP));
      if (vec16) {
        src += cu * 8;
        dst += cu * 16;
        for (int r = ru; r < rows; r += rstep) {
          cp_async16(dst, src);
          src += rstep * row;
          dst += rstep * DP * 2;
        }
      } else {
        src += cu * 2;
        dst += cu * 4;
        for (int r = ru; r < rows; r += rstep) {
          cp_async4(dst, src);
          src += rstep * row;
          dst += rstep * DP * 2;
        }
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < kSlots; ++i) issue(i);
  // the slice's mask, read once while the first tiles are in flight (its
  // first bytes into a register beside the query loads); a slice longer
  // than kMaskBytes reads a tile's at a time
  const bool whole_mask = n <= kMaskBytes;
  const unsigned char m_first = whole_mask && tid < n ? mb[tid] : 0;

  // columns D..DP-1 of every slot's rows: zeros the copies never touch
  if constexpr (NC == 0) {
    const int pad = DP - D;
    for (int e = tid; e < kSlots * TK * pad; e += kThreads) {
      const int r = e / pad;
      ring[(r / TK) * kSlotElems + (r % TK) * DP + D + e - r * pad] =
          __float2bfloat16(0.f);
    }
  }

  // this lane's 16-byte chunk c of a key row (lanes of a key: lpk, a power
  // of two) and its 8 columns of the G query rows
  const int nc = DP / 8;
  int lpk = NC;
  if (!NC) {
    lpk = 1;
    while (lpk < nc) lpk <<= 1;
  }
  const int c = lane & (lpk - 1);
  float qr[G][8];
  const bf16* qb = p.q + (static_cast<long long>(b) * p.Hkv + hk) * G * D;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (vec16 && c < nc) {
      const uint4 u = *reinterpret_cast<const uint4*>(qb + g * D + c * 8);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        qr[g][2 * i] = f.x;
        qr[g][2 * i + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int d = c * 8 + e;
        qr[g][e] = c < nc && d < D ? __bfloat162float(qb[g * D + d]) : 0.f;
      }
    }
  }
  if (whole_mask) {
    if (tid < n) msk[tid] = m_first;
    for (int i = tid + kThreads; i < n; i += kThreads) msk[i] = mb[i];
  }

  // K pass: the slice's scores with the 0 / -1e9 mask bias, times log2(e)
  auto score_key = [&](const bf16* kt, const unsigned char* mt, int t,
                       int r, int rows) {
    float dot[G];
#pragma unroll
    for (int g = 0; g < G; ++g) dot[g] = 0.f;
    if (r < rows && c < nc) {
      float kk[8];
      load8(kt + r * DP + c * 8, kk);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e) dot[g] = fmaf(qr[g][e], kk[e], dot[g]);
    }
    if constexpr (NC != 0) {
      constexpr int P = pow2_at_least(G);
      const float sum = reduce_scatter<G, LPK_C>(dot, lane);
      const int g = (lane & (LPK_C - 1)) / (LPK_C / P);
      if (r < rows && g < G && (lane & (LPK_C / P - 1)) == 0) {
        const float bias = mt[r] ? 0.f : -1e9f;
        sc[g * ld + t * TK + r] = fmaf(sum, p.scale, bias) * kLog2e;
      }
    } else {
      for (int o = lpk >> 1; o > 0; o >>= 1)
#pragma unroll
        for (int g = 0; g < G; ++g)
          dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
      if (r < rows && c == 0) {
        const float bias = mt[r] ? 0.f : -1e9f;
#pragma unroll
        for (int g = 0; g < G; ++g)
          sc[g * ld + t * TK + r] = fmaf(dot[g], p.scale, bias) * kLog2e;
      }
    }
  };
  for (int t = 0; t < nt; ++t) {
    const int rows = min(TK, n - t * TK);
    const unsigned char* mt = msk + (whole_mask ? t * TK : 0);
    if (!whole_mask)
      for (int i = tid; i < rows; i += kThreads) msk[i] = mb[t * TK + i];
    cp_async_wait<kSlots - 1>();
    __syncthreads();
    const bf16* kt = ring + (t % kSlots) * kSlotElems;
    if constexpr (NC != 0) {
      constexpr int kStep = kThreads / NC;             // keys a block step
#pragma unroll
      for (int k = 0; k < (kSlotElems / (NC * 8)) / kStep; ++k)
        score_key(kt, mt, t, k * kStep + tid / NC, rows);
    } else {
      for (int r0 = 0; r0 < rows; r0 += kThreads / lpk)
        score_key(kt, mt, t, r0 + tid / lpk, rows);
    }
    __syncthreads();                    // slot t % kSlots and msk are free
    issue(t + kSlots);
  }

  // the slice's (max, sum of 2^(s - max)) of row g, one warp a row
  for (int g = warp; g < G; g += kWarps) {
    float mx = -INFINITY, sm = 0.f;
    for (int s = lane; s < n; s += 32) mx = fmaxf(mx, sc[g * ld + s]);
    mx = warp_max(mx);
    for (int s = lane; s < n; s += 32) sm += ex2(sc[g * ld + s] - mx);
    sm = warp_sum(sm);
    if (lane == 0) {
      lstat[g * 2] = mx;
      lstat[g * 2 + 1] = sm;
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  if (C > 1)
    cluster.sync();                     // every slice's stats are written
  else
    __syncthreads();

  // the row's (M, L) from the C slices' (lane r reads rank r's): M the
  // largest max, L their sums scaled to it and added in rank order, the
  // same in every block of the cluster; then p = 2^(s - M) / L rounded to
  // bf16, in place of the scores
  for (int g = warp; g < G; g += kWarps) {
    float mr = -INFINITY, lr = 0.f;
    if (lane < C) {
      const float* st = C > 1 ? cluster.map_shared_rank(lstat, lane) : lstat;
      mr = st[g * 2];
      lr = st[g * 2 + 1];
    }
    const float M = warp_max(mr);
    const float term = mr == -INFINITY ? 0.f : lr * ex2(mr - M);
    float L = 0.f;
    for (int r = 0; r < C; ++r) L += __shfl_sync(0xffffffffu, term, r);
    const float inv = 1.f / L;
    for (int s = lane; s < n; s += 32)
      sc[g * ld + s] = round_bf16(ex2(sc[g * ld + s] - M) * inv);
  }
  __syncthreads();

  // V pass: thread (key slice ks, chunk cv) sums p @ v over keys ks,
  // ks + n_ks, .. of each tile for its 8 columns
  const int n_ks = kThreads / nc, cv = tid % nc, ks = tid / nc;
  float acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  auto add_key = [&](const bf16* vt, int t, int r, int rows) {
    if (r < rows) {
      float vv[8];
      load8(vt + r * DP + cv * 8, vv);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pg = sc[g * ld + t * TK + r];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pg, vv[e], acc[g][e]);
      }
    }
  };
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<kSlots - 1>();
    __syncthreads();
    const bf16* vt = ring + ((nt + t) % kSlots) * kSlotElems;
    const int rows = min(TK, n - t * TK);
    if constexpr (NC != 0) {
      constexpr int kKs = kThreads / NC;
#pragma unroll
      for (int k = 0; k < (kSlotElems / (NC * 8)) / kKs; ++k)
        add_key(vt, t, k * kKs + ks, rows);
    } else if (ks < n_ks) {
      for (int r = ks; r < rows; r += n_ks) add_key(vt, t, r, rows);
    }
    __syncthreads();
    issue(nt + t + kSlots);
  }

  // the block's partial [G][DP]: its key slices summed in a fixed order
  // (NC: first over a warp's slices by shuffles, then over the warps),
  // through red, which aliases the ring, whose copies have all landed
  int n_red = n_ks;
  if constexpr (NC != 0) {
#pragma unroll
    for (int o = NC; o < 32; o <<= 1)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
    n_red = kWarps;
    if (lane < NC) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          red[(warp * G + g) * DP + cv * 8 + e] = acc[g][e];
    }
  } else if (ks < n_ks) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        red[(ks * G + g) * DP + cv * 8 + e] = acc[g][e];
  }
  __syncthreads();
  // kept by rank 0 (over element i of slice 0, after reading it), pushed
  // by rank r > 0 into rank 0's slot r - 1
  float* dst = rank == 0 ? red
                         : cluster.map_shared_rank(slots, 0) +
                               (rank - 1) * G * DP;
  for (int i = tid; i < G * DP; i += kThreads) {
    float s = 0.f;
    for (int w = 0; w < n_red; ++w) s += red[w * G * DP + i];
    dst[i] = s;
  }
  if (C > 1)
    cluster.sync();                     // every partial is in rank 0
  else
    __syncthreads();
  if (rank == 0) {
    bf16* ob = p.out + (static_cast<long long>(b) * p.Hkv + hk) * G * D;
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, at = g * DP + i - g * D;
      float s = red[at];
      for (int r = 1; r < C; ++r) s += slots[(r - 1) * G * DP + at];
      ob[i] = __float2bfloat16(s);
    }
  }
}

// shared memory of a launch: the ring, rank 0's slots, the stats, the mask
// and, without a scratch, the scores of the longest slice
size_t smem_bytes(int G, int DP, int C, int slice, bool scratch) {
  return kSlots * kSlotElems * 2 +
         sizeof(float) * (static_cast<size_t>(C - 1) * G * DP + 2 * G) +
         kMaskBytes +
         (scratch ? 0 : sizeof(float) * static_cast<size_t>(G) * slice);
}

template <int G, int NC>
cudaError_t launch(const Params& p, int B, int C, cudaStream_t stream) {
  static bool attr_set = false;
  static int clusters_ok[9] = {};  // by C: 1 fits, -1 refused, 0 not asked
  // the most a launch takes: D 256, 8 ranks, a full score buffer
  const size_t max_smem = smem_bytes(G, 256, 8, kScoreFloats / G, false);
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attn_kernel<G, NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(max_smem));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int slice = (p.S + C - 1) / C;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, p.Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(G, p.DP, C, slice, p.scratch != nullptr);
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
    probe.dynamicSmemBytes = max_smem;
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(
        &n, decode_attn_kernel<G, NC>, &probe);
    if (e != cudaSuccess) return e;
    clusters_ok[C] = n > 0 ? 1 : -1;
  }
  if (clusters_ok[C] < 0) return cudaErrorLaunchOutOfResources;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, decode_attn_kernel<G, NC>, p);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int G>
cudaError_t launch_g(const Params& p, int B, int C, cudaStream_t stream) {
  if (p.vec16 && p.D == 64) return launch<G, 8>(p, B, C, stream);
  if (p.vec16 && p.D == 128) return launch<G, 16>(p, B, C, stream);
  return launch<G, 0>(p, B, C, stream);
}

}  // namespace

MTASR_EXPORT_ERROR_STRING

// G = Hq / Hkv in [1, 8]; D even and <= 256; C (blocks a (b, kv head) is
// split over, one cluster) in [1, 8]. scratch: f32 [B, Hkv, G, S], needed
// (else refused) when a slice's G * ceil(S / C) scores pass kScoreFloats.
extern "C" int decode_attention_launch(const void* q, const void* k_cache,
                                       const void* v_cache, const void* mask,
                                       void* out, void* scratch, int B, int S,
                                       int Hq, int Hkv, int D, int C,
                                       float scale, void* stream) {
  if (D % 2 != 0 || D > 256 || D < 2 || Hkv <= 0 || Hq % Hkv != 0 || B < 1 ||
      S < 1 || C < 1 || C > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv;
  if (scratch == nullptr &&
      static_cast<long long>(G) * ((S + C - 1) / C) > kScoreFloats)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k_cache) |
                         reinterpret_cast<uintptr_t>(v_cache);
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k_cache);
  p.v = static_cast<const bf16*>(v_cache);
  p.mask = static_cast<const unsigned char*>(mask);
  p.out = static_cast<bf16*>(out);
  p.scratch = static_cast<float*>(scratch);
  p.S = S;
  p.Hkv = Hkv;
  p.D = D;
  p.DP = (D + 7) / 8 * 8;
  p.TK = kSlotElems / p.DP;
  p.vec16 = D % 8 == 0 && addr % 16 == 0;
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (G) {
#define MTASR_DECODE_CASE(G_)                                              \
  case G_:                                                                 \
    return static_cast<int>(launch_g<G_>(p, B, C, st));
    MTASR_DECODE_CASE(1)
    MTASR_DECODE_CASE(2)
    MTASR_DECODE_CASE(3)
    MTASR_DECODE_CASE(4)
    MTASR_DECODE_CASE(5)
    MTASR_DECODE_CASE(6)
    MTASR_DECODE_CASE(7)
    MTASR_DECODE_CASE(8)
#undef MTASR_DECODE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
