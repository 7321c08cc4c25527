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
//                     per q head: bf16 [B, S, Hq, D] when Hq == Hkv, else
//                     f32 [B, S, Hq, D] whose GQA group the caller sums and
//                     casts, as the JAX package does
//   #10 dpb (which 2): dpb[h, i, j] = sum_b gate[b, h, i] ds_b[i, j]
//
// q, dO [B, T, Hq, D], k, v [B, S, Hkv, D], gate [B, Hq, T] bf16; pos_bias
// [Hq, T, S] bf16 with rows and heads `bias_row` / `bias_head` elements
// apart (multiples of 8: WavLM's row-padded table, `padded_bias`); lse
// [B*Hq, T] from the forward kernel and delta [B, Hq, T], f32; kv_lens [B]
// int32. As in the TPU kernels, p and ds are rounded to bf16 before they
// enter a product, every sum is f32 (dg sums the f32 ds), and keys at or
// past kv_len get p = ds = 0 whatever lse says, so a row with kv_len 0 gives
// zero gradients and no NaN. Nothing is summed with atomics: each output
// element is summed in one block, in a fixed order.
//
// Replaces the TPU kernels `_bwd_dq_kernel` (mtasr_tpu/ops/pallas/
// flash_attention.py:400-445, call :640), `_bwd_dkv_kernel` (:447-501, call
// :664) and `_bwd_dpb_kernel` (:503-539, call :711). The TPU carried each
// sum across sequential grid steps in VMEM scratch; here a block loops over
// what the TPU walked in grid order.
//
// What bounds them on the H100: at the encoder's shapes (B = 16, T = S =
// 499, H = 16, D = 64) the three recompute the scores and do 18 T S D B H
// = 7.3e10 FLOP a layer (6, 8 and 4 of the 18), about 74 us at the bf16
// tensor-core peak, against some 100 MB of operands (30 us at 3.35 TB/s),
// and 62 M exponentials each. A kernel whose steps run in series (scores
// stored to shared memory and read back, synchronous loads, 2-byte bias
// loads from global memory) stalls on each; #8 and #9 therefore follow the
// forward's design (flash_attention.cu), with the Hopper primitives of
// hopper.cuh:
//
// - #8: a block owns 64 query rows per warpgroup (two warpgroups, 128
//   registers a thread: 2 blocks an SM) of one (b, h); Q and dO are loaded
//   once, and a 2-stage ring of K, V and the [128 queries x 64 keys] bias
//   tile is filled by TMA on `mbarrier`s with `expect_tx`, one thread
//   issuing tile t + 2 once tile t is consumed. S = Q K^T and dP = dO V^T
//   are `wgmma` with both operands K-major in 128-byte swizzled shared
//   memory; ds is formed in registers from the accumulator layout (scores
//   in log2 units, one `ex2` each, lse and the gate pre-multiplied by
//   log2(e)), dg is summed in registers and over the quad at the end
//   (the bias pairs are 4-byte reads of the swizzled tile, as the forward
//   reads them; `ldmatrix` measured slower here: its registers pushed the
//   kernel past 128, the limit of 2 blocks an SM); dQ += dS K takes dS
//   packed from registers as the A fragment and K's tile as the MN-major B
//   operand (the transpose bit), as the forward's O += P V takes V;
// - #9: a block owns 64 keys (one warpgroup at 168 registers: 3 blocks an
//   SM, each on its own phase; two warpgroups sharing the ring, one block
//   an SM, measured 0.161 against 0.137 ms) of one (b, q head); K and V stay
//   resident, and the ring carries Q, dO and the [64 queries x 64 keys]
//   bias tile. S^T = K Q^T and dP^T = V dO^T (FlashAttention-3's swap)
//   leave P^T and dS^T in registers as the A fragments of dV += P^T dO and
//   dK += dS^T Q, with dO and Q as MN-major B operands. A thread then needs
//   bias[query = column, key = row]: the swizzled tile read transposed,
//   which `ldmatrix.trans` delivers in the accumulator's pair layout, 4
//   instructions a tile against 32 2-byte loads (0.134 against 0.138 ms
//   at the training shape). The per-query lse, delta and gate of the next
//   tile are fetched into registers during this tile and staged in a
//   double buffer of shared memory. With Hq == Hkv the sums are written in
//   bf16 directly; with a GQA group the per-head f32 goes to the caller's
//   sum;
// - the kv_len mask runs on the last key tile (#8) or the keys' block (#9)
//   only, by select, so a NaN in a K or V row past kv_len cannot enter: #8
//   zeroes the last partial tile's K rows in shared memory before dQ +=
//   dS K (TMA fills zeros only past the tensor's edge), #9's masked rows
//   are its own output rows. Query rows past T are TMA's zeros with lse
//   +inf, so p = ds = 0 there (:477-486).
//
// - #10: a block owns (h, 64 queries a warpgroup, 64 keys) and walks the
//   batch in order, so the f32 sum is deterministic, in batch order as on
//   the TPU, where the batch is the innermost grid axis (no atomics). A
//   ring of 2 stages on `mbarrier`s carries batch row b + 1's Q, dO, K and
//   V tiles, filled by TMA with the batch as a coordinate, while row b is
//   computed; rows whose kv_len ends before the key tile
//   are skipped, never loaded. S = Q K^T and dP = dO V^T are `wgmma`s with
//   their accumulators in registers, ds and gate * ds are formed there as
//   #8 forms ds (log2 units, one `ex2` each), the next row's lse, delta and
//   gate are fetched during this row's products, and the bias tile comes
//   by TMA once and stays in registers. The dpb tile lives in registers
//   across the batch loop and is written once. What bounded the old
//   kernel (the batch loop in series: synchronous loads, WMMA products
//   staged through shared memory, two barriers a row) is gone; what is
//   left is the traffic of Q, dO, K and V through L2, B times a tile
//   (about 537 MB a call at the training shape). Measured against this
//   tile (64 queries x 64 keys, one warpgroup, 3 blocks an SM): 128
//   queries on two warpgroups sharing K / V (one block an SM), a third
//   ring stage (2 blocks an SM) and a cluster of two key tiles sharing Q /
//   dO by TMA multicast were all slower on the H100 (PERF.md, section 6).
// The gated [B, H, T, S] bias is never built: gate * pos_bias is composed
// in the kernels.

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBN = 64;      // keys (#8) or queries (#9) of a ring tile
constexpr int kStages = 2;   // ring tiles in flight

// What #8-#10 read besides the tiles that come through tensor maps.
struct Rows {
  const bf16* gate;
  const int* kv_lens;
  const float *lse, *delta;
  void *out_a, *out_b;
  int B, T, S, Hq, Hkv, D;
  float scale;
  int has_bias;
};

// Shared memory past a 1024-byte aligned base (the 128-byte swizzle repeats
// every 1024 bytes); a [64 rows][DP] tile is DP / 64 atoms of 64 rows of
// 128 bytes, and a block's [64 * WG rows][DP] operand DP / 64 column blocks
// of WG atoms.

// ---- #8: dq and dg ---------------------------------------------------------
constexpr int kDqWG = 2;                 // warpgroups of a block
constexpr int kDqRows = 64 * kDqWG;      // query rows of a block
constexpr int kDqThreads = 128 * kDqWG;

// q and dO [kDqRows][DP]; each stage's K and V [64 keys][DP] and its bias
// tile [kDqRows queries][64 keys]; the stages' barriers and q's.
template <int DP>
struct DqSmem {
  static constexpr uint32_t tile = DP / 64 * kAtom;
  static constexpr uint32_t cols = kDqWG * kAtom;  // a 64-column block of q
  static constexpr uint32_t q = 0;
  static constexpr uint32_t dout = q + kDqWG * tile;
  static constexpr uint32_t ring = dout + kDqWG * tile;  // stage s: + s*stage
  static constexpr uint32_t stage = 2 * tile + kDqWG * kAtom;
  static constexpr uint32_t bar = ring + kStages * stage;
  static constexpr uint32_t bytes = bar + 8 * (kStages + 1) + 1024;
};

template <int DP>
__global__ void __launch_bounds__(kDqThreads)
bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
              const __grid_constant__ CUtensorMap do_map,
              const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map,
              const __grid_constant__ CUtensorMap b_map, const Rows args) {
  using L = DqSmem<DP>;
  constexpr int kAtoms = DP / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t q_s = base + L::q, do_s = base + L::dout;
  const uint32_t bar0 = base + L::bar;          // stage s: bar0 + 8 * s
  const uint32_t q_bar = bar0 + 8 * kStages;

  const int T = args.T, D = args.D, has_bias = args.has_bias;
  const int q0 = blockIdx.x * kDqRows, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (args.Hq / args.Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kv_len = min(max(args.kv_lens[b], 0), args.S);
  const int n_tiles = (kv_len + kBN - 1) / kBN;
  const long long bh = static_cast<long long>(b) * args.Hq + h;

  // K, V and the bias of key tile t into stage s (one thread)
  auto load_stage = [&](int t, int s) {
    const uint32_t bar = bar0 + 8 * s;
    const uint32_t k_s = base + L::ring + s * L::stage;
    mbar_expect_tx(bar, 2 * L::tile + (has_bias ? kDqWG * kAtom : 0));
#pragma unroll
    for (int c = 0; c < kAtoms; ++c) {
      tma_load(k_s + c * kAtom, &k_map, bar, c * 64, hk, t * kBN, b);
      tma_load(k_s + L::tile + c * kAtom, &v_map, bar, c * 64, hk, t * kBN,
               b);
    }
    if (has_bias) tma_load_3d(k_s + 2 * L::tile, &b_map, bar, t * kBN, q0, h);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bar0 + 8 * s, 1);
    mbar_init(q_bar, 1);
    mbar_fence_init();
    if (n_tiles > 0) {
      mbar_expect_tx(q_bar, 2 * kDqWG * L::tile);
#pragma unroll
      for (int c = 0; c < kAtoms; ++c) {
        tma_load(q_s + c * L::cols, &q_map, q_bar, c * 64, h, q0, b);
        tma_load(do_s + c * L::cols, &do_map, q_bar, c * 64, h, q0, b);
      }
      for (int t = 0; t < min(n_tiles, kStages); ++t) load_stage(t, t);
    }
  }
  __syncthreads();

  // this thread's two rows (r0 and r0 + 8 of the block) and their lse,
  // delta and gate; scores in log2 units, so lse and the gate carry
  // log2(e). A row past T gets lse +inf: p = 0 (its q and dO rows are TMA's
  // zeros)
  const int wg = warp >> 2;
  const int r0 = warp * 16 + (lane >> 2);
  const int qi[2] = {q0 + r0, q0 + r0 + 8};
  const float scale2 = args.scale * kLog2e;
  float lse2[2], dl[2], g2[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const bool ok = qi[j] < T;
    const long long at = bh * T + qi[j];
    lse2[j] = ok ? args.lse[at] * kLog2e : INFINITY;
    dl[j] = ok ? args.delta[at] : 0.f;
    g2[j] = ok && has_bias ? kLog2e * __bfloat162float(args.gate[at]) : 0.f;
  }
  // byte offset of this thread's bias pair i in the swizzled tile: row r0
  // (+ 8), 16-byte chunk (i / 4) XOR (row % 8), word lane % 4
  auto bias_at = [&](int i) {
    return (r0 + 8 * ((i >> 1) & 1)) * 128 + (((i >> 2) ^ (lane >> 2)) << 4) +
           (lane & 3) * 4;
  };

  float dq[DP / 2], sc[kBN / 2], dp[kBN / 2], dg[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) sc[i] = dp[i] = 0.f;

  if (n_tiles > 0) mbar_wait(q_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages, n0 = t * kBN;
    const uint32_t k_s = base + L::ring + s * L::stage;
    const uint32_t v_s = k_s + L::tile;
    const unsigned char* b_s = smem + L::ring + s * L::stage + 2 * L::tile;
    mbar_wait(bar0 + 8 * s, (t / kStages) & 1);
    const int valid = kv_len - n0;             // keys of this tile < kv_len
    if (valid < kBN) {
      // the last tile: K rows past kv_len hold what the tensor holds there
      // and would meet ds = 0 in dQ += dS K (0 x NaN); V's columns of dP
      // are masked out of ds below. A row of an atom is 128 bytes whatever
      // the swizzle
      const int chunks = (kBN - valid) * 8;
      uint4* kt = reinterpret_cast<uint4*>(smem + L::ring + s * L::stage);
      for (int i = tid; i < kAtoms * chunks; i += kDqThreads) {
        const int c = i / chunks, e = i - c * chunks;
        kt[c * (kAtom / 16) + valid * 8 + e] = make_uint4(0u, 0u, 0u, 0u);
      }
      fence_proxy_async();
      __syncthreads();
    }

    // S = Q K^T and dP = dO V^T, 4 k-steps of 16 a 64-column atom
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t col = (kk & 3) * 32, blk = kk >> 2;
      const uint32_t a_off = blk * L::cols + wg * kAtom + col;
      const uint32_t b_off = blk * kAtom + col;
      wgmma_ss_m64n64(sc, desc_sw128(q_s + a_off, 16, 1024),
                      desc_sw128(k_s + b_off, 16, 1024), kk > 0);
      wgmma_ss_m64n64(dp, desc_sw128(do_s + a_off, 16, 1024),
                      desc_sw128(v_s + b_off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(sc);
    reg_fence(dp);

    // ds = p (dp - delta) in the accumulator's layout, into sc; dg sums the
    // f32 ds times the bias
#pragma unroll
    for (int i = 0; i < kBN / 2; i += 2) {
      const int r = (i >> 1) & 1;
      float2 pb = make_float2(0.f, 0.f);
      if (has_bias)
        pb = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(b_s + bias_at(i)));
      const float p0 = ex2(fmaf(sc[i], scale2, fmaf(g2[r], pb.x, -lse2[r])));
      const float p1 =
          ex2(fmaf(sc[i + 1], scale2, fmaf(g2[r], pb.y, -lse2[r])));
      float d0 = p0 * (dp[i] - dl[r]), d1 = p1 * (dp[i + 1] - dl[r]);
      if (valid < kBN) {
        const int j = n0 + frag_col(i, lane);
        d0 = j < kv_len ? d0 : 0.f;
        d1 = j + 1 < kv_len ? d1 : 0.f;
      }
      dg[r] = fmaf(d1, pb.y, fmaf(d0, pb.x, dg[r]));
      sc[i] = d0;
      sc[i + 1] = d1;
    }

    // dQ += dS K: the accumulator's k-th 16 columns are the A fragment of
    // the k-th 16 keys; K's rows are D-contiguous, MN-major for this operand
    uint32_t da[kBN / 16][4];
    pack_a(sc, da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_rs<DP>(dq, da[kk], desc_sw128(k_s + kk * 16 * 128, kAtom, 1024));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(dq);

    __syncthreads();                 // every warp is done with stage s
    if (tid == 0 && t + kStages < n_tiles) load_stage(t + kStages, s);
  }

  bf16* dq_out = static_cast<bf16*>(args.out_a);
  bf16* dg_out = static_cast<bf16*>(args.out_b);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dg[r] += __shfl_xor_sync(0xffffffffu, dg[r], 1);
    dg[r] += __shfl_xor_sync(0xffffffffu, dg[r], 2);
    if (qi[r] >= T) continue;
    if (has_bias && (lane & 3) == 0)
      dg_out[bh * T + qi[r]] = __float2bfloat16(dg[r]);
    bf16* row =
        dq_out + ((static_cast<long long>(b) * T + qi[r]) * args.Hq + h) * D;
#pragma unroll
    for (int i = 2 * r; i < DP / 2; i += 4) {
      const int c = frag_col(i, lane);
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(
            dq[i] * args.scale, dq[i + 1] * args.scale);
    }
  }
}

// ---- #9: dk and dv of one q head -------------------------------------------
constexpr int kKvThreads = 128;          // one warpgroup: 64 keys a block
constexpr int kStats = 3 * kBN;          // lse2, delta, g2 of a query tile
constexpr int kStatsPer = (kStats + kKvThreads - 1) / kKvThreads;

// K and V [64 keys][DP], resident; each stage's Q and dO [64 queries][DP]
// and its bias tile [64 queries][64 keys]; the query stats of two tiles;
// the stages' barriers and K / V's.
template <int DP>
struct DkvSmem {
  static constexpr uint32_t tile = DP / 64 * kAtom;
  static constexpr uint32_t k = 0;
  static constexpr uint32_t v = k + tile;
  static constexpr uint32_t ring = v + tile;        // stage s: + s * stage
  static constexpr uint32_t stage = 2 * tile + kAtom;
  static constexpr uint32_t stats = ring + kStages * stage;
  static constexpr uint32_t bar = stats + 2 * kStats * 4;
  static constexpr uint32_t bytes = bar + 8 * (kStages + 1) + 1024;
};

template <int DP>
__global__ void __launch_bounds__(kKvThreads, DP == 64 ? 3 : 1)
bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap do_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               const __grid_constant__ CUtensorMap b_map, const Rows args) {
  using L = DkvSmem<DP>;
  constexpr int kAtoms = DP / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t k_s = base + L::k, v_s = base + L::v;
  const uint32_t bar0 = base + L::bar;          // stage s: bar0 + 8 * s
  const uint32_t kv_bar = bar0 + 8 * kStages;
  float* stats = reinterpret_cast<float*>(smem + L::stats);

  const int T = args.T, S = args.S, D = args.D, has_bias = args.has_bias;
  const int k0 = blockIdx.x * kBN, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (args.Hq / args.Hkv);
  const bool out_bf16 = args.Hq == args.Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kv_len = min(max(args.kv_lens[b], 0), S);
  const int n_tiles = (T + kBN - 1) / kBN;
  const long long bh = static_cast<long long>(b) * args.Hq + h;
  // element (key kj, column c) of this q head's dk / dv
  auto out_at = [&](int kj, int c) {
    return ((static_cast<long long>(b) * S + kj) * args.Hq + h) * D + c;
  };

  if (k0 >= kv_len) {  // every key of the block is masked: zero gradients
    for (int e = tid; e < kBN * D; e += kKvThreads) {
      const int r = e / D, kj = k0 + r;
      if (kj >= S) break;
      const long long at = out_at(kj, e - r * D);
      if (out_bf16) {
        static_cast<bf16*>(args.out_a)[at] = __float2bfloat16(0.f);
        static_cast<bf16*>(args.out_b)[at] = __float2bfloat16(0.f);
      } else {
        static_cast<float*>(args.out_a)[at] = 0.f;
        static_cast<float*>(args.out_b)[at] = 0.f;
      }
    }
    return;
  }

  // entry e of query tile t's stats: lse * log2(e) (+inf past T: p = 0),
  // delta, gate * log2(e) of its query e % 64
  auto stat = [&](int t, int e) {
    const int which = e / kBN, i = t * kBN + e - which * kBN;
    if (i >= T) return which == 0 ? INFINITY : 0.f;
    const long long at = bh * T + i;
    if (which == 0) return args.lse[at] * kLog2e;
    if (which == 1) return args.delta[at];
    return has_bias ? kLog2e * __bfloat162float(args.gate[at]) : 0.f;
  };
  // Q, dO and the bias tile of query tile t into stage s (one thread)
  auto load_stage = [&](int t, int s) {
    const uint32_t bar = bar0 + 8 * s;
    const uint32_t q_st = base + L::ring + s * L::stage;
    mbar_expect_tx(bar, 2 * L::tile + (has_bias ? kAtom : 0));
#pragma unroll
    for (int c = 0; c < kAtoms; ++c) {
      tma_load(q_st + c * kAtom, &q_map, bar, c * 64, h, t * kBN, b);
      tma_load(q_st + L::tile + c * kAtom, &do_map, bar, c * 64, h, t * kBN,
               b);
    }
    if (has_bias)
      tma_load_3d(q_st + 2 * L::tile, &b_map, bar, k0, t * kBN, h);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bar0 + 8 * s, 1);
    mbar_init(kv_bar, 1);
    mbar_fence_init();
    mbar_expect_tx(kv_bar, 2 * L::tile);
#pragma unroll
    for (int c = 0; c < kAtoms; ++c) {
      tma_load(k_s + c * kAtom, &k_map, kv_bar, c * 64, hk, k0, b);
      tma_load(v_s + c * kAtom, &v_map, kv_bar, c * 64, hk, k0, b);
    }
    for (int t = 0; t < min(n_tiles, kStages); ++t) load_stage(t, t);
  }
  for (int e = tid; e < kStats; e += kKvThreads) stats[e] = stat(0, e);
  __syncthreads();

  // this thread's two key rows (r0 and r0 + 8 of the block's 64)
  const int r0 = warp * 16 + (lane >> 2);
  const int kj0 = k0 + r0;
  const bool key_ok[2] = {kj0 < kv_len, kj0 + 8 < kv_len};
  const bool partial = k0 + kBN > kv_len;
  const float scale2 = args.scale * kLog2e;
  // bias[query = column][key = row] of the pairs i = 8 m + 2 j (key rows
  // r0 + 8 (j % 2), queries 8 (2 m + j / 2) ..) come transposed by one
  // `ldmatrix.trans` for each m from the swizzled [64 queries][64 keys]
  // tile: this thread gives query row lane % 8 of matrix lane / 8 at its
  // keys' 16-byte chunk (XOR query % 8)
  const int lchunk = warp * 2 + ((lane >> 3) & 1);
  auto bias_rows = [&](uint32_t b_s, int m) {
    return b_s + ((2 * m + (lane >> 4)) * 8 + (lane & 7)) * 128 +
           ((lchunk ^ (lane & 7)) << 4);
  };

  float dk[DP / 2], dv[DP / 2], st[kBN / 2], dpt[kBN / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) st[i] = dpt[i] = 0.f;

  mbar_wait(kv_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    // the next tile's stats, in flight during this tile's products
    float next[kStatsPer];
#pragma unroll
    for (int j = 0; j < kStatsPer; ++j) {
      const int e = tid + j * kKvThreads;
      next[j] = e < kStats && t + 1 < n_tiles ? stat(t + 1, e) : 0.f;
    }
    const uint32_t q_st = base + L::ring + s * L::stage;
    const uint32_t do_st = q_st + L::tile;
    const uint32_t b_s = q_st + 2 * L::tile;
    const float* lse2 = stats + (t & 1) * kStats;
    const float* dl = lse2 + kBN;
    const float* g2 = dl + kBN;
    mbar_wait(bar0 + 8 * s, (t / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kAtom + (kk & 3) * 32;
      wgmma_ss_m64n64(st, desc_sw128(k_s + off, 16, 1024),
                      desc_sw128(q_st + off, 16, 1024), kk > 0);
      wgmma_ss_m64n64(dpt, desc_sw128(v_s + off, 16, 1024),
                      desc_sw128(do_st + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(st);
    reg_fence(dpt);

    // p^T into st, ds^T into dpt (row = key, column = query)
    uint32_t pbm[4];
#pragma unroll
    for (int i = 0; i < kBN / 2; i += 2) {
      const int hi = (i >> 1) & 1, c = frag_col(i, lane);
      const float2 l2 = *reinterpret_cast<const float2*>(lse2 + c);
      const float2 d2 = *reinterpret_cast<const float2*>(dl + c);
      const float2 gg = *reinterpret_cast<const float2*>(g2 + c);
      if (has_bias && i % 8 == 0) ldsm_x4_trans(bias_rows(b_s, i / 8), pbm);
      const float2 pb =
          has_bias ? bf16x2_float2(pbm[(i >> 1) & 3]) : make_float2(0.f, 0.f);
      float p0 = ex2(fmaf(st[i], scale2, fmaf(gg.x, pb.x, -l2.x)));
      float p1 = ex2(fmaf(st[i + 1], scale2, fmaf(gg.y, pb.y, -l2.y)));
      float d0 = p0 * (dpt[i] - d2.x), d1 = p1 * (dpt[i + 1] - d2.y);
      if (partial && !key_ok[hi]) p0 = p1 = d0 = d1 = 0.f;
      st[i] = p0;
      st[i + 1] = p1;
      dpt[i] = d0;
      dpt[i + 1] = d1;
    }

    // dV += P^T dO and dK += dS^T Q: the accumulators' k-th 16 columns are
    // the A fragments of the k-th 16 queries; dO's and Q's rows are
    // D-contiguous, MN-major for these operands
    uint32_t pa[kBN / 16][4], da[kBN / 16][4];
    pack_a(st, pa);
    pack_a(dpt, da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_rs<DP>(dv, pa[kk], desc_sw128(do_st + kk * 16 * 128, kAtom, 1024));
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_rs<DP>(dk, da[kk], desc_sw128(q_st + kk * 16 * 128, kAtom, 1024));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(dv);
    reg_fence(dk);

    // no thread reads the other stats buffer during this tile
#pragma unroll
    for (int j = 0; j < kStatsPer; ++j) {
      const int e = tid + j * kKvThreads;
      if (e < kStats && t + 1 < n_tiles)
        stats[((t + 1) & 1) * kStats + e] = next[j];
    }
    __syncthreads();                 // every warp is done with stage s
    if (tid == 0 && t + kStages < n_tiles) load_stage(t + kStages, s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = kj0 + 8 * r;
    if (kj >= S) continue;
#pragma unroll
    for (int i = 2 * r; i < DP / 2; i += 4) {
      const int c = frag_col(i, lane);
      if (c >= D) continue;
      const long long at = out_at(kj, c);
      const float k_lo = dk[i] * args.scale, k_hi = dk[i + 1] * args.scale;
      if (out_bf16) {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(args.out_a) +
                                           at) =
            __floats2bfloat162_rn(k_lo, k_hi);
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(args.out_b) +
                                           at) =
            __floats2bfloat162_rn(dv[i], dv[i + 1]);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(args.out_a) + at) =
            make_float2(k_lo, k_hi);
        *reinterpret_cast<float2*>(static_cast<float*>(args.out_b) + at) =
            make_float2(dv[i], dv[i + 1]);
      }
    }
  }
}

// ---- #10: dpb, summed over the batch ---------------------------------------
constexpr int kDpbThreads = 128;  // one warpgroup: 64 queries a block
constexpr int kDpbStages = 2;     // batch rows in flight

// Each stage: Q, dO, K and V [64 rows][DP] of one batch row; the bias tile
// [64 queries][64 keys], loaded once; the stages' barriers and the bias's.
template <int DP>
struct DpbSmem {
  static constexpr uint32_t tile = DP / 64 * kAtom;
  static constexpr uint32_t q = 0;              // within a stage
  static constexpr uint32_t dout = q + tile;
  static constexpr uint32_t k = dout + tile;
  static constexpr uint32_t v = k + tile;
  static constexpr uint32_t stage = v + tile;   // also its loads' bytes
  static constexpr uint32_t bias = kDpbStages * stage;
  static constexpr uint32_t bar = bias + kAtom;
  static constexpr uint32_t bytes = bar + 8 * (kDpbStages + 1) + 1024;
};

template <int DP>
__global__ void __launch_bounds__(kDpbThreads, DP == 64 ? 3 : 1)
bwd_dpb_kernel(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap do_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               const __grid_constant__ CUtensorMap b_map, const Rows args) {
  using L = DpbSmem<DP>;
  constexpr int kAtoms = DP / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const unsigned char* b_s = smem_raw + (base - raw) + L::bias;
  const uint32_t bar0 = base + L::bar;          // stage s: bar0 + 8 * s
  const uint32_t b_bar = bar0 + 8 * kDpbStages;

  const int T = args.T, S = args.S, B = args.B;
  const int k0 = blockIdx.x * kBN, q0 = blockIdx.y * kBN, h = blockIdx.z;
  const int hk = h / (args.Hq / args.Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  auto kv_len_of = [&](int b) { return min(max(args.kv_lens[b], 0), S); };
  // the first batch row from b on with a key in this tile (B: none left)
  auto next_row = [&](int b) {
    while (b < B && k0 >= kv_len_of(b)) ++b;
    return b;
  };
  // Q, dO, K and V of batch row b into stage s (one thread)
  auto load_stage = [&](int b, int s) {
    const uint32_t bar = bar0 + 8 * s, st = base + s * L::stage;
    mbar_expect_tx(bar, L::stage);
#pragma unroll
    for (int c = 0; c < kAtoms; ++c) {
      tma_load(st + L::q + c * kAtom, &q_map, bar, c * 64, h, q0, b);
      tma_load(st + L::dout + c * kAtom, &do_map, bar, c * 64, h, q0, b);
      tma_load(st + L::k + c * kAtom, &k_map, bar, c * 64, hk, k0, b);
      tma_load(st + L::v + c * kAtom, &v_map, bar, c * 64, hk, k0, b);
    }
  };

  int b_load = 0;                    // thread 0: the next row to load
  if (tid == 0) {
    for (int s = 0; s < kDpbStages; ++s) mbar_init(bar0 + 8 * s, 1);
    mbar_init(b_bar, 1);
    mbar_fence_init();
    mbar_expect_tx(b_bar, kAtom);
    tma_load_3d(base + L::bias, &b_map, b_bar, k0, q0, h);
    b_load = next_row(0);
    for (int s = 0; s < kDpbStages && b_load < B; ++s) {
      load_stage(b_load, s);
      b_load = next_row(b_load + 1);
    }
  }
  __syncthreads();

  // this thread's two rows (r0 and r0 + 8 of the block); for batch row b
  // their lse and gate in log2 units (a row past T: lse +inf, so p = 0),
  // delta and the gate
  const int r0 = warp * 16 + (lane >> 2);
  const int qi[2] = {q0 + r0, q0 + r0 + 8};
  const float scale2 = args.scale * kLog2e;
  auto row_stats = [&](int b, float (&st)[2][4]) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool ok = qi[j] < T;
      const long long at = (static_cast<long long>(b) * args.Hq + h) * T +
                           (ok ? qi[j] : 0);
      const float g = ok ? __bfloat162float(args.gate[at]) : 0.f;
      st[j][0] = ok ? args.lse[at] * kLog2e : INFINITY;
      st[j][1] = ok ? args.delta[at] : 0.f;
      st[j][2] = g;
      st[j][3] = g * kLog2e;
    }
  };

  // the bias pairs of this thread's accumulator elements, kept in
  // registers for the whole batch loop: row r0 (+ 8), 16-byte chunk
  // (i / 4) XOR (row % 8) of the swizzled tile, word lane % 4
  mbar_wait(b_bar, 0);
  uint32_t pbr[kBN / 4];
#pragma unroll
  for (int i = 0; i < kBN / 2; i += 2)
    pbr[i / 2] = *reinterpret_cast<const uint32_t*>(
        b_s + (r0 + 8 * ((i >> 1) & 1)) * 128 +
        (((i >> 2) ^ (lane >> 2)) << 4) + (lane & 3) * 4);

  float acc[kBN / 2], sc[kBN / 2], dp[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = sc[i] = dp[i] = 0.f;

  float cur[2][4], nxt[2][4];
  int b = next_row(0);
  if (b < B) row_stats(b, cur);
  for (int n = 0; b < B; ++n) {
    const int s = n % kDpbStages;
    const int b_next = next_row(b + 1);
    if (b_next < B) row_stats(b_next, nxt);  // in flight during the products
    const int kv_len = kv_len_of(b);
    const uint32_t st = base + s * L::stage;
    mbar_wait(bar0 + 8 * s, (n / kDpbStages) & 1);

    // S = Q K^T and dP = dO V^T, 4 k-steps of 16 a 64-column atom
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kAtom + (kk & 3) * 32;
      wgmma_ss_m64n64(sc, desc_sw128(st + L::q + off, 16, 1024),
                      desc_sw128(st + L::k + off, 16, 1024), kk > 0);
      wgmma_ss_m64n64(dp, desc_sw128(st + L::dout + off, 16, 1024),
                      desc_sw128(st + L::v + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(sc);
    reg_fence(dp);

    // dpb += gate * p (dp - delta), 0 at keys at or past kv_len (a select:
    // K and V rows there may hold anything)
    const bool partial = k0 + kBN > kv_len;
#pragma unroll
    for (int i = 0; i < kBN / 2; i += 2) {
      const int r = (i >> 1) & 1;
      const float2 pb = bf16x2_float2(pbr[i / 2]);
      const float p0 =
          ex2(fmaf(sc[i], scale2, fmaf(cur[r][3], pb.x, -cur[r][0])));
      const float p1 =
          ex2(fmaf(sc[i + 1], scale2, fmaf(cur[r][3], pb.y, -cur[r][0])));
      float d0 = p0 * (dp[i] - cur[r][1]), d1 = p1 * (dp[i + 1] - cur[r][1]);
      if (partial) {
        const int j = k0 + frag_col(i, lane);
        d0 = j < kv_len ? d0 : 0.f;
        d1 = j + 1 < kv_len ? d1 : 0.f;
      }
      acc[i] = fmaf(cur[r][2], d0, acc[i]);
      acc[i + 1] = fmaf(cur[r][2], d1, acc[i + 1]);
    }

    __syncthreads();                 // every warp is done with stage s
    if (tid == 0 && b_load < B) {
      load_stage(b_load, s);
      b_load = next_row(b_load + 1);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) cur[j][e] = nxt[j][e];
    b = b_next;
  }

  bf16* dpb = static_cast<bf16*>(args.out_a);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= T) continue;
    bf16* row = dpb + (static_cast<long long>(h) * T + qi[r]) * S;
#pragma unroll
    for (int i = 2 * r; i < kBN / 2; i += 4) {
      const int j = k0 + frag_col(i, lane);
      if ((S & 1) == 0 && j < S) {     // j even: a 4-byte aligned pair
        *reinterpret_cast<__nv_bfloat162*>(row + j) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
      } else {
        if (j < S) row[j] = __float2bfloat16(acc[i]);
        if (j + 1 < S) row[j + 1] = __float2bfloat16(acc[i + 1]);
      }
    }
  }
}

struct Inputs {  // the tensors #8-#10 read through tensor maps
  const void *q, *k, *v, *dout, *pos_bias;
  long long bias_row, bias_head;
};

template <int DP>
cudaError_t launch_wgmma(int which, const Inputs& x, const Rows& args,
                         cudaStream_t stream) {
  using Dpb = DpbSmem<DP>;
  static bool attr_set[3] = {false, false, false};  // once per instantiation
  const cudaError_t e =
      which == 0
          ? allow_smem(bwd_dq_kernel<DP>, attr_set[0], DqSmem<DP>::bytes)
      : which == 1
          ? allow_smem(bwd_dkv_kernel<DP>, attr_set[1], DkvSmem<DP>::bytes)
          : allow_smem(bwd_dpb_kernel<DP>, attr_set[2], Dpb::bytes);
  if (e != cudaSuccess) return e;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int q_rows = which == 0 ? kDqRows : kBN;
  CUtensorMap q_map, do_map, k_map, v_map, b_map = {};
  if (!make_map(encode, &q_map, x.q, args.B, args.T, args.Hq, args.D,
                q_rows) ||
      !make_map(encode, &do_map, x.dout, args.B, args.T, args.Hq, args.D,
                q_rows) ||
      !make_map(encode, &k_map, x.k, args.B, args.S, args.Hkv, args.D, kBN) ||
      !make_map(encode, &v_map, x.v, args.B, args.S, args.Hkv, args.D, kBN) ||
      (args.has_bias &&
       !make_bias_map(encode, &b_map, x.pos_bias, args.Hq, args.T, args.S,
                      x.bias_row, x.bias_head, q_rows)))
    return cudaErrorInvalidValue;
  if (which == 0) {
    const dim3 grid((args.T + kDqRows - 1) / kDqRows, args.Hq, args.B);
    bwd_dq_kernel<DP><<<grid, kDqThreads, DqSmem<DP>::bytes, stream>>>(
        q_map, do_map, k_map, v_map, b_map, args);
  } else if (which == 1) {
    const dim3 grid((args.S + kBN - 1) / kBN, args.Hq, args.B);
    bwd_dkv_kernel<DP><<<grid, kKvThreads, DkvSmem<DP>::bytes, stream>>>(
        q_map, do_map, k_map, v_map, b_map, args);
  } else {
    const dim3 grid((args.S + kBN - 1) / kBN,
                    (args.T + q_rows - 1) / q_rows, args.Hq);
    bwd_dpb_kernel<DP><<<grid, kDpbThreads, Dpb::bytes, stream>>>(
        q_map, do_map, k_map, v_map, b_map, args);
  }
  return cudaGetLastError();
}

}  // namespace

MTASR_EXPORT_ERROR_STRING

// which: 0 = #8 (out_a dq bf16 [B, T, Hq, D], out_b dg bf16 [B, Hq, T] or
// null without a bias), 1 = #9 (out_a dk, out_b dv [B, S, Hq, D]: bf16 when
// Hq == Hkv, else f32), 2 = #10 (out_a dpb bf16 [Hq, T, S], contiguous;
// needs the bias). D % 8 == 0 and D <= 128; q, k, v, dout and pos_bias
// 16-byte aligned, pos_bias rows bias_row and heads bias_head elements
// apart (multiples of 8); pos_bias / gate may be null when has_bias == 0.
extern "C" int flash_attention_bwd_launch(
    int which, const void* q, const void* k, const void* v,
    const void* pos_bias, const void* gate, const void* kv_lens,
    const void* lse, const void* delta, const void* dout, void* out_a,
    void* out_b, int B, int T, int S, int Hq, int Hkv, int D, float scale,
    int has_bias, long long bias_row, long long bias_head, void* stream) {
  if (D % 8 != 0 || D > 128 || D < 8 || Hkv <= 0 || Hq % Hkv != 0 ||
      B < 1 || T < 1 || S < 1 || which < 0 || which > 2 ||
      (which == 2 && !has_bias) || (which == 1 && !out_b) ||
      (which == 0 && has_bias && !out_b) ||
      (has_bias && (bias_row % 8 != 0 || bias_head % 8 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Inputs x{q, k, v, dout, pos_bias, bias_row, bias_head};
  const Rows args{static_cast<const bf16*>(gate),
                  static_cast<const int*>(kv_lens),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta), out_a, out_b, B, T, S, Hq,
                  Hkv, D, scale, has_bias};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = D <= 64 ? launch_wgmma<64>(which, x, args, st)
                                  : launch_wgmma<128>(which, x, args, st);
  return static_cast<int>(err);
}
