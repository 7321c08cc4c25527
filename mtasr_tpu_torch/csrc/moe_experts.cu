// The routed experts' SwiGLU of a mixture of experts over (token, expert)
// pairs sorted by expert: a grouped product in two launches,
//
//   mtasr_moe_gate_up_kernel:  h[p] = silu(x[row p] W_g,e^T) * (x[row p] W_u,e^T)
//   mtasr_moe_down_kernel:     y[p] = h[p] W_d,e^T
//
// for every sorted pair p of expert e (ops/kernels/moe_experts.py). It
// replaces no TPU kernel: the JAX package has no experts.
//
// What bounds it on the H100. In a decode step (B 256, top 6 of 64
// experts) each expert sees about 24 pairs, and the step reads every
// expert's weights once: 17.3 MB an expert, 1.1 GB a layer, so the launch
// is bound by bytes (an arithmetic intensity of about 24 operations a
// byte, far below the card's ~295). In a prefill (16384 tokens) each
// expert sees about 1536 pairs, and the same weights are read 24 times
// over: bound by operations.
//
// Design. A block computes a 64-row tile of one expert's sorted pairs
// against a 128-row tile of that expert's weights (gate / up: 64
// intermediate columns, their gate and up rows side by side; down: 128
// output columns), over the reduction in steps of 64, with `mma.sync`
// m16n8k16 (bf16 in, f32 accumulate), operands from shared memory by
// `ldmatrix`, and a 3-stage `cp.async` ring so that the weight stream
// stays in flight while the tensor cores work (8 warps, two blocks an
// SM). The gate / up tile interleaves each warp's 16 gate rows with the
// same 16 columns' up rows, so that silu(g) * u is formed in the
// registers that hold both. The activations' rows are gathered by the
// pair's token (gate / up) or read in order (down). Grid: x = row tiles,
// sized for the worst case of the routing (sum over experts of
// ceil(n_e / 64) <= P / 64 + E), y = column blocks; a block finds its
// expert by a binary search of the experts' first tiles (device memory,
// computed by the wrapper from the offsets) and returns past the last
// real tile, so the host never reads the routing and the launch can be
// captured in a CUDA graph. A warp whose 32 rows all lie past the tile's
// last pair skips its products (a decode tile is about a third full).
// Rounding follows one expert computed in bf16 by PyTorch: gate and up
// rounded to bf16, silu rounded, the product rounded; y rounded to bf16.
#include "common.cuh"

constexpr int kBM = 64;          // pair rows a block
constexpr int kBRows = 128;      // weight rows a block
constexpr int kBNGateUp = 64;    // intermediate columns a gate / up block
constexpr int kBNDown = 128;     // output columns a down block
constexpr int kBK = 64;          // reduction depth a stage
constexpr int kStages = 3;
constexpr int kThreads = 256;    // 8 warps: 2 (rows) x 4 (weight rows)
constexpr int kLd = kBK + 8;     // smem row: 144 bytes, ldmatrix conflict-free
constexpr int kATile = kBM * kLd;
constexpr int kBTile = kBRows * kLd;
constexpr int kStageElems = kATile + kBTile;
constexpr int kSmemBytes = kStages * kStageElems * 2;   // 82944

struct Args {
  const bf16* a;        // gate / up: x [T, K]; down: h [P, K]
  const int* rows;      // gate / up: the token of each sorted pair; down: null
  const int* offsets;   // [E + 1] each expert's first sorted pair
  const int* tiles;     // [E + 1] each expert's first row tile
  const bf16* w;        // gate / up: [E, 2 n_out, K]; down: [E, n_out, K]
  bf16* out;            // [P, n_out]
  int K;                // reduction: H (gate / up) or I (down)
  int n_out;            // I (gate / up) or H (down)
  int E;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// silu(g) * u as one expert in bf16 computes it: each step rounded.
__device__ __forceinline__ float swiglu_bf16(float g, float u) {
  const float gr = round_bf16(g);
  const float s = round_bf16(gr / (1.0f + expf(-gr)));
  return s * round_bf16(u);
}

template <bool kGateUp>
__device__ __forceinline__ void grouped_body(const Args& p) {
  extern __shared__ __align__(16) unsigned char moe_smem[];
  bf16* smem = reinterpret_cast<bf16*>(moe_smem);
  __shared__ int info[3];
  const int tid = threadIdx.x;
  if (tid == 0) {
    const int t = blockIdx.x;
    int e = -1;
    if (t < p.tiles[p.E]) {
      // the last expert whose first tile is <= t (an empty expert's
      // first tile equals the next one's, so it is passed over)
      int lo = 0, hi = p.E - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (p.tiles[mid] <= t) lo = mid; else hi = mid - 1;
      }
      e = lo;
      info[1] = p.offsets[e] + (t - p.tiles[e]) * kBM;
      info[2] = p.offsets[e + 1];
    }
    info[0] = e;
  }
  __syncthreads();
  const int e = info[0];
  if (e < 0) return;
  const int row0 = info[1];
  const int n_rows = min(kBM, info[2] - row0);
  const int K = p.K;
  const int nb = blockIdx.y;

  // this thread's copies: two 16-byte chunks of A rows, four of B rows,
  // all in column chunk `c8` of a stage
  const int c8 = tid & 7;
  const bf16* a_src[2];
  int a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = (tid >> 3) + 32 * i;
    a_ok[i] = r < n_rows;
    const long src = !a_ok[i] ? 0 : kGateUp ? p.rows[row0 + r] : row0 + r;
    a_src[i] = p.a + src * K + c8 * 8;
  }
  const bf16* b_src[4];
  const long w_base = static_cast<long>(e) * (kGateUp ? 2 : 1) * p.n_out * K;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = tid >> 3;   // row i * 32 + j of the tile
    long wrow;
    if (kGateUp) {
      // warp column i holds 16 gate rows, then the same 16 columns' up rows
      const int col = nb * kBNGateUp + 16 * i + (j & 15);
      wrow = j < 16 ? col : p.n_out + col;
    } else {
      wrow = nb * kBNDown + 32 * i + j;
    }
    b_src[i] = p.w + w_base + wrow * K + c8 * 8;
  }

  auto load_stage = [&](int stage, int kt) {
    bf16* sa = smem + stage * kStageElems;
    bf16* sb = sa + kATile;
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      cp_async16(smem_addr(sa + ((tid >> 3) + 32 * i) * kLd + c8 * 8),
                 a_src[i] + k0, a_ok[i] ? 16 : 0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      cp_async16(smem_addr(sb + ((tid >> 3) + 32 * i) * kLd + c8 * 8),
                 b_src[i] + k0);
  };

  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const bool active = wm * 32 < n_rows;
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;

  const int KT = K / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nk = kt + kStages - 1;
    if (nk < KT) load_stage(nk % kStages, nk);
    cp_async_commit();
    if (!active) continue;
    const bf16* sa = smem + (kt % kStages) * kStageElems;
    const bf16* sb = sa + kATile;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], smem_addr(sa + (wm * 32 + mt * 16 + (lane & 15)) * kLd
                                     + kk * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4(b[np], smem_addr(sb + (wn * 32 + np * 16 + (lane & 7)
                                           + 8 * (lane >> 4)) * kLd
                                     + kk * 16 + 8 * ((lane >> 3) & 1)));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma16816(acc[mt][nt], a[mt], b[nt >> 1][2 * (nt & 1)],
                   b[nt >> 1][2 * (nt & 1) + 1]);
    }
  }
  cp_async_wait<0>();
  if (!active) return;

  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 32 + mt * 16 + g + 8 * half;
      if (r >= n_rows) continue;
      bf16* out_row = p.out + static_cast<long>(row0 + r) * p.n_out;
      if (kGateUp) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = nb * kBNGateUp + 16 * wn + 8 * nt + 2 * q;
          const float* gv = &acc[mt][nt][2 * half];
          const float* uv = &acc[mt][nt + 2][2 * half];
          *reinterpret_cast<uint32_t*>(out_row + col) = pack_bf16(
              swiglu_bf16(gv[0], uv[0]), swiglu_bf16(gv[1], uv[1]));
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = nb * kBNDown + 32 * wn + 8 * nt + 2 * q;
          *reinterpret_cast<uint32_t*>(out_row + col) = pack_bf16(
              acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    mtasr_moe_gate_up_kernel(const Args p) {
  grouped_body<true>(p);
}

__global__ void __launch_bounds__(kThreads, 2)
    mtasr_moe_down_kernel(const Args p) {
  grouped_body<false>(p);
}

MTASR_EXPORT_ERROR_STRING

// x [T, H], rows [P] int32, offsets / tiles [E + 1] int32, w_gate_up
// [E, 2I, H], w_down [E, H, I], h [P, I] (scratch), y [P, H]; max_tiles
// the grid's row tiles (P / 64 rounded up, + E). H % 128 == 0, I % 64 == 0.
extern "C" int moe_experts_launch(const void* x, const void* rows,
                                  const void* offsets, const void* tiles,
                                  const void* w_gate_up, const void* w_down,
                                  void* h, void* y, int P, int H, int I,
                                  int E, int max_tiles, void* stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        mtasr_moe_gate_up_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(mtasr_moe_down_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  if (P == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  const int* til = static_cast<const int*>(tiles);
  const Args gate_up{static_cast<const bf16*>(x), static_cast<const int*>(rows),
                     off, til, static_cast<const bf16*>(w_gate_up),
                     static_cast<bf16*>(h), H, I, E};
  mtasr_moe_gate_up_kernel<<<dim3(max_tiles, I / kBNGateUp), kThreads,
                             kSmemBytes, s>>>(gate_up);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const Args down{static_cast<const bf16*>(h), nullptr, off, til,
                  static_cast<const bf16*>(w_down), static_cast<bf16*>(y), I,
                  H, E};
  mtasr_moe_down_kernel<<<dim3(max_tiles, H / kBNDown), kThreads, kSmemBytes,
                          s>>>(down);
  return cudaGetLastError();
}
