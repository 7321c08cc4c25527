// CTC forward-backward recursions over the [T, S = 2L+1] lattice, in log
// space, float32 (torch.nn.CTCLoss(reduction='none', zero_infinity=True)
// semantics; the loss, zero_infinity and the scatter onto the vocabulary
// stay in PyTorch, as they stay outside the TPU kernels).
//
//   #11 alpha: alpha[b, 0, s] = emit[b, 0, s] for s < 2 (valid s only), then
//       alpha[t] = lse3(alpha[t-1][s], alpha[t-1][s-1], skip ? alpha[t-1][s-2])
//                  + emit[t][s] for t < ilen, carried unchanged for t >= ilen;
//       writes alpha [B, T, S] and the final row [B, S] (= alpha at ilen-1).
//   #12 beta + log-posterior: beta[t] excludes the emission at t;
//       beta[ilen-1][s] = 0 for s in {2*label_len, 2*label_len - 1};
//       writes log_post[b, t, s] = max(alpha + beta, LOG_EPS) where s is valid
//       and t < ilen, else LOG_EPS.
//
// emit, alpha, log_post f32 [B, T, S]; allow u8 [B, S] (the s-2 -> s skip is
// allowed); ilen, label_len int32 [B]; valid s = s < 2*label_len + 1.
//
// Replaces the TPU kernels of mtasr_tpu/ops/pallas/ctc_kernel.py: #11
// `ctc_loss_pallas_fwd` (`_fwd_kernel`) and #12 `_vjp_bwd` (`_bwd_kernel`),
// with the same f32 order of operations (`_logsumexp3`'s max(m, LOG_EPS)
// clamp and final max(., LOG_EPS), the where(t < ilen) carry, #12's three
// cases at t == ilen-1, t < ilen-1 and t >= ilen), so the results agree to
// f32 rounding. The JAX package's hybrid loss runs the same two recursions as
// XLA scans (ops/ctc_fused.py `_alpha_scan`, `_beta_scan`); the port's fused
// CTC loss runs these kernels there.
//
// Bound on the H100: the bytes (at the training shape, B = 16, T = 499,
// S = 21: #11 reads emit and writes alpha, about 1.3 MB, 0.4 us at 3.35
// TB/s; #12 reads emit and alpha and writes log_post, 0.6 us). What binds
// is the chain: T dependent steps a row, each a logsumexp of three (IEEE
// expf and logf, about 45 dependent instructions) on the previous step's
// row, on B of 132 SMs; past a few warps a row, the SM's issue rate too.
//
// Design (the plan is `ctc_plan` of ops/kernels/ctc.py, a pure function
// of S and T): a block owns a batch row. Lane l of a warp holds K (1 or 2)
// neighbouring lattice positions in registers, and per step takes the
// two values it needs from beyond them by shuffles: #11 alpha at s-1 and
// s-2 from the lane before (`__shfl_up_sync`), #12 the terms at s+1 and
// s+2 from the lane after (`__shfl_down_sync`). Up to S = 32 one warp holds
// the row: the chain has no barrier and no shared-memory round trip. Past
// that W warps hold it, each with H halo lanes that repeat the neighbouring
// slice's H K edge positions (#11: the slice before; #12: the slice after).
// A halo lane's own neighbours are halo too, so each step spoils two more
// of its positions from the far edge; for h = H K / 2 steps the warp's own
// lanes stay exact without any exchange, and then the halo is refreshed
// through shared memory (double buffered) with one block barrier: one
// barrier every h steps, not every step. The same f32 operations run on
// the same values, so every route gives the same bits. The emissions (and
// #12's alpha) are staged ahead of the recursion: the block copies a chunk
// of Tc steps of whole rows, as they lie in global memory, into a ring of
// two chunks, the next in flight while the current one's steps run (#12
// walks its chunks from the end, each with one more row of emit, as it
// reads emit at t+1). A batch row starts at b T S floats, so a chunk is
// seldom 16-byte aligned: it lands shifted by its offset in its quad, by
// 16-byte cp.async on the whole quads and 4-byte ones at the two ends. A
// lane reads its positions of the step after next while the current step
// runs, off the chain. Steps past a row's input length skip the recursion
// (#11 carries alpha, #12 writes LOG_EPS). alpha and log_post rows are
// stored as they are made, one 4-byte store a cell and a step: with the
// stores taken out the kernels measured no faster, so gathering them into
// bursts per chunk has nothing to gain.
#include "common.cuh"

namespace {

constexpr float kLogEps = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxS = 1024;

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float ms = fmaxf(m, kLogEps);
  const float out =
      ms + logf(expf(a - ms) + expf(b - ms) + expf(c - ms));
  return fmaxf(out, kLogEps);
}

// Floats of a staged chunk of n rows of S: the rows as they lie in global
// memory, shifted by the source's offset in its 16-byte quad (0..3), the
// next chunk 16-byte aligned.
__host__ __device__ constexpr int chunk_floats(int rows, int S) {
  return (rows * S + 7) / 4 * 4;
}

// Shared memory of a launch: `stages` chunks of Tc rows of emit (#11), or
// of Tc + 1 rows of emit and Tc rows of alpha (#12), and with W > 1 warps
// the halo exchange [2][W][H K] and K spare floats.
__host__ __device__ constexpr size_t smem_bytes(int which, int S, int K,
                                                int W, int H, int Tc,
                                                int stages) {
  return sizeof(float) *
         (static_cast<size_t>(stages) *
              (which == 0 ? chunk_floats(Tc, S)
                          : chunk_floats(Tc + 1, S) + chunk_floats(Tc, S)) +
          (W > 1 ? 2 * W * H * K + K : 0));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int quad_offset(const float* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) >> 2) & 3;
}

// The block copies n floats from src into shared memory at dst, float j at
// dst + 4 (quad_offset(src) + j): 16-byte cp.async on the whole quads,
// 4-byte ones at the ends (a batch row starts at b T S floats, so a chunk
// is seldom 16-byte aligned in global memory).
__device__ __forceinline__ void stage_span(uint32_t dst, const float* src,
                                           int n) {
  const int off = quad_offset(src);
  const float* quad0 = src - off;
  const int quads = (off + n + 3) >> 2;
  for (int q = threadIdx.x; q < quads; q += blockDim.x) {
    const int j0 = 4 * q - off;
    if (j0 >= 0 && j0 + 4 <= n) {
      cp_async16(dst + 16u * q, quad0 + 4 * q);
    } else {
#pragma unroll
      for (int x = 0; x < 4; ++x)
        if (j0 + x >= 0 && j0 + x < n)
          cp_async4(dst + 16u * q + 4u * x, src + j0 + x);
    }
  }
}

__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// The halo exchange through shared memory, ordered against the barrier.
__device__ __forceinline__ float lds_edge(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void sts_edge(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// A lane's K positions of a staged row, at the byte offsets `at` (each
// clamped into the row: a position past the lattice is read and masked).
template <int K>
__device__ __forceinline__ void read_row(float (&x)[K], uint32_t row,
                                         const uint32_t (&at)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) x[k] = lds(row + at[k]);
}

// Until the chunk staged `stages - 1` commits ago has landed.
__device__ __forceinline__ void wait_chunk(int stages) {
  if (stages > 1)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

template <bool MULTI>
__device__ __forceinline__ void block_sync() {
  if constexpr (MULTI)
    __syncthreads();
  else
    __syncwarp();
}

// A gate as a clamp: every value it gates is a fmaxf(., LOG_EPS) or
// LOG_EPS, never NaN, so on such x, fminf(x, open ? inf : LOG_EPS) is
// exactly open ? x : LOG_EPS, in one instruction.
__device__ __forceinline__ float gate(bool open) {
  return open ? INFINITY : kLogEps;
}

// #11. Lane l of warp w holds positions (w D + l - H) K + k, k < K, with
// D = 32 - H: with W > 1 warps, its first H lanes are a halo that repeats
// the slice before's last H K positions (MULTI). A halo lane's s-1 and s-2
// come from lanes that are themselves halo, so each step spoils two more
// positions of it from the left; after h = H K / 2 steps the warp's own
// lanes are still exact, and the halo is refreshed from the warp before
// through shared memory, with one block barrier.
template <int K, bool MULTI>
__global__ void __launch_bounds__(MULTI ? 1024 : 32)
    ctc_alpha_kernel(const float* __restrict__ emit,
                     const unsigned char* __restrict__ allow,
                     const int* __restrict__ ilen_p,
                     const int* __restrict__ label_len_p,
                     float* __restrict__ alpha, float* __restrict__ final_row,
                     int T, int S, int H, int Tc, int stages) {
  extern __shared__ __align__(16) float smem[];
  const int W = MULTI ? blockDim.x >> 5 : 1;
  const int w = MULTI ? threadIdx.x >> 5 : 0;
  const int lane = threadIdx.x & 31;
  const int D = 32 - H;
  const int b = blockIdx.x;
  const int p0 = (w * D + lane - H) * K;  // this lane's first position
  const int ilen = ilen_p[b];
  const int nvalid = 2 * label_len_p[b] + 1;
  const float* e = emit + static_cast<long long>(b) * T * S;
  float* a_out = alpha + static_cast<long long>(b) * T * S + p0;
  const int slot = chunk_floats(Tc, S);
  const uint32_t ring = smem_u32(smem);

  // per position: the gates (s-1 exists, the skip from s-2, s valid), the
  // first row's, whether this lane stores it, and its byte offset in a row
  float g1[K], g2[K], gv[K], a[K];
  uint32_t at[K];
  bool init[K], mine[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = p0 + k;
    const bool in = s >= 0 && s < S;
    const bool valid = in && s < nvalid;
    g1[k] = gate(s >= 1);
    g2[k] = gate(s >= 2 && in &&
                 allow[static_cast<long long>(b) * S + s] != 0);
    gv[k] = gate(valid);
    init[k] = s < 2 && valid;
    mine[k] = in && lane >= H;
    at[k] = 4u * min(max(s, 0), S - 1);
    a[k] = kLogEps;
  }
  auto store = [&](float* row) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (mine[k]) row[k] = a[k];
  };
  // MULTI: lanes D..31 publish their positions into one half of the
  // exchange, edge[h][w], the other lanes into the spare floats; the halo
  // lanes read the warp before's, edge[h][w - 1]; the halves alternate
  const int hk = H * K;
  const uint32_t edge = ring + 4u * stages * slot;
  const uint32_t half = 4u * W * hk;
  const bool pub = lane >= D;
  uint32_t put = pub ? edge + 4u * (w * hk + (lane - D) * K) : edge + 2 * half;
  uint32_t get = edge + 4u * (max(w - 1, 0) * hk + min(lane, H - 1) * K);
  const uint32_t put_flip = pub ? put ^ (put + half) : 0u;
  const uint32_t get_flip = get ^ (get + half);
  const bool halo = w > 0 && lane < H;
  const int every = hk / 2;  // steps between exchanges
  int until = every;         // steps to the next one (first row: exact)
  auto exchange = [&]() {
#pragma unroll
    for (int k = 0; k < K; ++k) sts_edge(put + 4u * k, a[k]);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float v = lds_edge(get + 4u * k);
      a[k] = halo ? v : a[k];
    }
    put ^= put_flip;
    get ^= get_flip;
  };

  const int n_chunks = (T + Tc - 1) / Tc;
  auto stage_chunk = [&](int c) {
    const int t0 = c * Tc;
    stage_span(ring + 4u * (c % stages) * slot,
               e + static_cast<long long>(t0) * S, min(Tc, T - t0) * S);
  };
  for (int c = 0; c < stages - 1; ++c) {
    if (c < n_chunks) stage_chunk(c);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    block_sync<MULTI>();  // every lane is done with the slot staged next
    if (c + stages - 1 < n_chunks) stage_chunk(c + stages - 1);
    cp_async_commit();
    wait_chunk(stages);
    block_sync<MULTI>();  // this chunk has landed for every lane
    const int t0 = c * Tc, n = min(Tc, T - t0);
    const uint32_t rows =
        ring + 4u * ((c % stages) * slot +
                     quad_offset(e + static_cast<long long>(t0) * S));
    float* row = a_out + static_cast<long long>(t0) * S;
    int i = 0;
    if (c == 0) {
      float e0[K];
      read_row<K>(e0, rows, at);
#pragma unroll
      for (int k = 0; k < K; ++k)
        a[k] = fmaxf(init[k] ? e0[k] : kLogEps, kLogEps);
      store(row);
      i = 1;
      row += S;
    }
    // steps t0 + i < ilen run the recursion, the rest carry alpha; the
    // emissions are read two steps ahead
    const int n_rec = max(min(ilen - t0, n), i);
    float e1[K], e2[K];
    read_row<K>(e1, rows + 4u * min(i, n - 1) * S, at);
    read_row<K>(e2, rows + 4u * min(i + 1, n - 1) * S, at);
    for (; i < n_rec; ++i, row += S) {
      float ec[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        ec[k] = e1[k];
        e1[k] = e2[k];
      }
      read_row<K>(e2, rows + 4u * min(i + 2, n - 1) * S, at);
      // alpha[t-1] at p0 - 1 and p0 - 2, from the lane before
      const float up1 = __shfl_up_sync(kFull, a[K - 1], 1);
      const float up2 = K >= 2
                            ? __shfl_up_sync(kFull, a[K >= 2 ? K - 2 : 0], 1)
                            : __shfl_up_sync(kFull, a[0], 2);
      float nw[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float f1 = k >= 1 ? a[k >= 1 ? k - 1 : 0] : up1;
        const float f2 = k >= 2 ? a[k >= 2 ? k - 2 : 0] : k == 1 ? up1 : up2;
        const float v =
            lse3(a[k], fminf(f1, g1[k]), fminf(f2, g2[k])) + ec[k];
        // max(valid ? v : LOG_EPS, LOG_EPS)
        nw[k] = fminf(fmaxf(v, kLogEps), gv[k]);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) a[k] = nw[k];
      store(row);
      if constexpr (MULTI) {
        if (--until == 0) {
          exchange();
          until = every;
        }
      }
    }
    for (; i < n; ++i, row += S) store(row);  // carried past the input length
  }
  store(final_row + static_cast<long long>(b) * S + p0);
}

// #12. Lane l of warp w holds positions (w D + l) K + k: with W > 1 warps,
// its last H lanes are a halo that repeats the slice after's first H K
// positions, spoilt two positions a step from the right, refreshed every
// h = H K / 2 steps from the warp after (the mirror of #11).
template <int K, bool MULTI>
__global__ void __launch_bounds__(MULTI ? 1024 : 32)
    ctc_beta_post_kernel(const float* __restrict__ emit,
                         const float* __restrict__ alpha,
                         const unsigned char* __restrict__ allow,
                         const int* __restrict__ ilen_p,
                         const int* __restrict__ label_len_p,
                         float* __restrict__ log_post, int T, int S, int H,
                         int Tc, int stages) {
  extern __shared__ __align__(16) float smem[];
  const int W = MULTI ? blockDim.x >> 5 : 1;
  const int w = MULTI ? threadIdx.x >> 5 : 0;
  const int lane = threadIdx.x & 31;
  const int D = 32 - H;
  const int b = blockIdx.x;
  const int p0 = (w * D + lane) * K;
  const int ilen = ilen_p[b];
  const int last = 2 * label_len_p[b];
  const long long offset = static_cast<long long>(b) * T * S;
  const float* e = emit + offset;
  const float* al = alpha + offset;
  float* out = log_post + offset + p0;
  // a stage: Tc + 1 rows of emit (step t reads emit at t + 1), Tc of alpha
  const int slot_e = chunk_floats(Tc + 1, S), slot = slot_e + chunk_floats(Tc, S);
  const uint32_t ring = smem_u32(smem);

  // per position: the gates (s < S, s + 1 < S, the skip to s + 2, s
  // valid), beta at ilen - 1, whether this lane stores it, its offset
  float gi[K], g1[K], g2[K], gv[K], beta_T[K], beta[K];
  uint32_t at[K];
  bool mine[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = p0 + k;
    const bool in = s < S;
    const bool valid = in && s < last + 1;
    gi[k] = gate(in);
    g1[k] = gate(s + 1 < S);
    // the s -> s+2 skip is allowed iff allow[s+2]
    g2[k] = gate(s + 2 < S &&
                 allow[static_cast<long long>(b) * S + s + 2] != 0);
    gv[k] = gate(valid);
    const float bt = (s == last || s == max(last - 1, 0)) ? 0.f : kLogEps;
    beta_T[k] = valid ? bt : kLogEps;
    beta[k] = beta_T[k];
    mine[k] = in && lane < D;
    at[k] = 4u * min(s, S - 1);
  }
  auto store = [&](float* row, const float (&g)[K]) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (mine[k]) row[k] = g[k];
  };
  // MULTI: lanes 0..H-1 publish their beta into one half of the exchange,
  // edge[h][w], the other lanes into the spare floats; the halo lanes read
  // the warp after's, edge[h][w + 1] (LOG_EPS past the last warp); the
  // halves alternate
  const int hk = H * K;
  const uint32_t edge = ring + 4u * stages * slot;
  const uint32_t half = 4u * W * hk;
  const bool pub = lane < H;
  uint32_t put = pub ? edge + 4u * (w * hk + lane * K) : edge + 2 * half;
  uint32_t get =
      edge + 4u * (min(w + 1, W - 1) * hk + max(lane - D, 0) * K);
  const uint32_t put_flip = pub ? put ^ (put + half) : 0u;
  const uint32_t get_flip = get ^ (get + half);
  const bool halo = lane >= D, more = w + 1 < W;
  const int every = hk / 2;  // steps between exchanges
  int until = every;         // steps to the next one (beta_T: exact)
  auto exchange = [&]() {
#pragma unroll
    for (int k = 0; k < K; ++k) sts_edge(put + 4u * k, beta[k]);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float v = lds_edge(get + 4u * k);
      beta[k] = halo ? (more ? v : kLogEps) : beta[k];
    }
    put ^= put_flip;
    get ^= get_flip;
  };

  const int n_chunks = (T + Tc - 1) / Tc;
  // the j-th chunk walked is chunk n_chunks - 1 - j, steps [c Tc, c Tc + n)
  auto stage_chunk = [&](int j) {
    const int c = n_chunks - 1 - j, t0 = c * Tc, n = min(Tc, T - t0);
    const uint32_t dst = ring + 4u * (j % stages) * slot;
    stage_span(dst, e + static_cast<long long>(t0) * S,
               (min(t0 + n, T - 1) - t0 + 1) * S);
    stage_span(dst + 4u * slot_e, al + static_cast<long long>(t0) * S,
               n * S);
  };
  for (int j = 0; j < stages - 1; ++j) {
    if (j < n_chunks) stage_chunk(j);
    cp_async_commit();
  }
  for (int j = 0; j < n_chunks; ++j) {
    block_sync<MULTI>();  // every lane is done with the slot staged next
    if (j + stages - 1 < n_chunks) stage_chunk(j + stages - 1);
    cp_async_commit();
    wait_chunk(stages);
    block_sync<MULTI>();  // this chunk has landed for every lane
    const int c = n_chunks - 1 - j, t0 = c * Tc, n = min(Tc, T - t0);
    const long long g0 = static_cast<long long>(t0) * S;
    const uint32_t es =
        ring + 4u * ((j % stages) * slot + quad_offset(e + g0));
    const uint32_t as =
        ring + 4u * ((j % stages) * slot + slot_e + quad_offset(al + g0));
    const int e_last = min(n, T - 1 - t0);  // step i reads emit row i + 1
    const int i_end = ilen - 1 - t0;  // the step t = ilen - 1, chunk-local
    int i = n - 1;
    float* row = out + static_cast<long long>(t0 + i) * S;
    float g[K];
    for (; i >= 0 && i > i_end; --i, row -= S) {  // t >= ilen
#pragma unroll
      for (int k = 0; k < K; ++k) g[k] = kLogEps;
      store(row, g);
    }
    if (i >= 0 && i == i_end) {  // t = ilen - 1: beta starts at beta_T
      float a_t[K];
      read_row<K>(a_t, as + 4u * i * S, at);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        g[k] = fminf(fmaxf(a_t[k] + beta_T[k], kLogEps), gv[k]);
        beta[k] = beta_T[k];
      }
      until = every;
      store(row, g);
      --i;
      row -= S;
    }
    // t < ilen - 1: the recursion; emit and alpha read two steps ahead
    float e1[K], e2[K], a1[K], a2[K];
    read_row<K>(e1, es + 4u * min(max(i, 0) + 1, e_last) * S, at);
    read_row<K>(a1, as + 4u * max(i, 0) * S, at);
    read_row<K>(e2, es + 4u * min(max(i - 1, 0) + 1, e_last) * S, at);
    read_row<K>(a2, as + 4u * max(i - 1, 0) * S, at);
#pragma unroll 2
    for (; i >= 0; --i, row -= S) {
      float ec[K], ac[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        ec[k] = e1[k];
        ac[k] = a1[k];
        e1[k] = e2[k];
        a1[k] = a2[k];
      }
      read_row<K>(e2, es + 4u * min(max(i - 2, 0) + 1, e_last) * S, at);
      read_row<K>(a2, as + 4u * max(i - 2, 0) * S, at);
      float term[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        term[k] = fminf(fmaxf(beta[k] + ec[k], kLogEps), gi[k]);
      // the terms at p0 + K and p0 + K + 1, from the lane after
      const float dn1 = __shfl_down_sync(kFull, term[0], 1);
      const float dn2 = K >= 2
                            ? __shfl_down_sync(kFull, term[K >= 2 ? 1 : 0], 1)
                            : __shfl_down_sync(kFull, term[0], 2);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float f1 = k + 1 < K ? term[k + 1 < K ? k + 1 : 0] : dn1;
        const float f2 = k + 2 < K ? term[k + 2 < K ? k + 2 : 0]
                         : k + 2 == K ? dn1 : dn2;
        const float nb =
            fminf(lse3(term[k], fminf(f1, g1[k]), fminf(f2, g2[k])), gv[k]);
        beta[k] = nb;
        g[k] = fminf(fmaxf(ac[k] + nb, kLogEps), gv[k]);
      }
      store(row, g);
      if constexpr (MULTI) {
        if (--until == 0) {
          exchange();
          until = every;
        }
      }
    }
  }
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

template <int K, bool MULTI>
cudaError_t launch_k(int which, const float* e, const float* al_in,
                     const unsigned char* al, const int* il, const int* ll,
                     float* out, float* final_row, int B, int T, int S, int W,
                     int H, int Tc, int stages, cudaStream_t st) {
  // what each kernel may take past the default 48 KB, raised as needed
  static size_t raised[2] = {48 * 1024, 48 * 1024};
  const size_t smem = smem_bytes(which, S, K, W, H, Tc, stages);
  cudaError_t err;
  if (which == 0) {
    err = raise_smem(ctc_alpha_kernel<K, MULTI>, raised[0], smem);
    if (err != cudaSuccess) return err;
    ctc_alpha_kernel<K, MULTI><<<B, 32 * W, smem, st>>>(
        e, al, il, ll, out, final_row, T, S, H, Tc, stages);
  } else {
    err = raise_smem(ctc_beta_post_kernel<K, MULTI>, raised[1], smem);
    if (err != cudaSuccess) return err;
    ctc_beta_post_kernel<K, MULTI><<<B, 32 * W, smem, st>>>(
        e, al_in, al, il, ll, out, T, S, H, Tc, stages);
  }
  return cudaGetLastError();
}

}  // namespace

MTASR_EXPORT_ERROR_STRING

// which 0: #11, alpha_in unused, out = alpha [B, T, S], final_row [B, S].
// which 1: #12, alpha_in = alpha, out = log_post [B, T, S], final_row unused.
// T >= 1, 1 <= S <= 1024; one warp (W = 1, K = 1, H = 0) for S <= 32, or
// W warps of H halo lanes (1 <= H <= 16) with K = 1 or 2 positions a lane,
// H K even, the warps' own lanes covering S: W (32 - H) K >= S; Tc steps a
// staged chunk, 1 or 2 chunks in the ring (ops/kernels/ctc.py `ctc_plan`).
extern "C" int ctc_launch(int which, const void* emit, const void* alpha_in,
                          const void* allow, const void* ilen,
                          const void* label_len, void* out, void* final_row,
                          int B, int T, int S, int K, int W, int H, int Tc,
                          int stages, void* stream) {
  const bool shape_ok =
      (K == 1 || K == 2) && W >= 1 && W <= 32 &&
      (W == 1 ? H == 0 && K == 1 : H >= 1 && H <= 16 && H * K % 2 == 0) &&
      W * (32 - H) * K >= S;
  if (B < 0 || T < 1 || S < 1 || S > kMaxS || which < 0 || which > 1 ||
      !shape_ok || Tc < 1 || stages < 1 || stages > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* e = static_cast<const float*>(emit);
  const auto* al_in = static_cast<const float*>(alpha_in);
  const auto* al = static_cast<const unsigned char*>(allow);
  const auto* il = static_cast<const int*>(ilen);
  const auto* ll = static_cast<const int*>(label_len);
  auto* o = static_cast<float*>(out);
  auto* f = static_cast<float*>(final_row);
  cudaError_t err;
  if (K == 2)
    err = launch_k<2, true>(which, e, al_in, al, il, ll, o, f, B, T, S, W, H,
                            Tc, stages, st);
  else if (W > 1)
    err = launch_k<1, true>(which, e, al_in, al, il, ll, o, f, B, T, S, W, H,
                            Tc, stages, st);
  else
    err = launch_k<1, false>(which, e, al_in, al, il, ll, o, f, B, T, S, W,
                             H, Tc, stages, st);
  return static_cast<int>(err);
}
