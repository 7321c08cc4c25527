// WavLM conv layer 0, fused: conv (C_in = 1, kernel K, stride s) + bias,
// LayerNorm over the O channels, exact gelu. Output [B, T_out, O] written
// once, bf16 in and out.
//
// Replaces the TPU kernel `_conv0_kernel_call` / `_kernel` of
// mtasr_tpu/ops/pallas/conv_frontend.py. On the TPU the window gather was
// the problem (a contraction of 10 against 128-lane tiles); on the H100 the
// conv is 10 multiply-adds per output, so the kernel is bound by writing
// the output (8 x 31999 x 512 bf16 = 262 MB at the main-path shape, about
// 80 us at 3.35 TB/s) and by the instructions of every element: the 10
// multiply-adds, the LayerNorm and the exact erf (erff stays: the JAX
// golden `_conv0_xla` and the 1-ulp gate need it; the TPU's polynomial erf
// existed only because Mosaic had no erf). Design:
//
// - a persistent grid (a few blocks an SM, from the occupancy calculator)
//   whose warps walk over groups of F neighbouring frames of one batch row;
//   each block stages the weights, bias, gamma and beta once, permuted so
//   that a lane's channels are contiguous and a warp's float4 loads of
//   them are conflict-free;
// - a lane owns O / 32 channels in runs of 8 (run r of lane l: channels
//   256 r + 8 l .. + 7 at O >= 256), so a frame's row leaves as one
//   16-byte store a lane a run: a warp writes 512 contiguous bytes an
//   instruction;
// - the warp computes its F frames together (3 at O = 512): each float4 of
//   weights read from shared memory serves all F (one load for 4 F
//   multiply-adds, where one frame a warp took a load a multiply-add), and
//   the waveform window of the group ((F - 1) s + K samples, 20 at K = 10,
//   s = 5, F = 3) is one load a lane, fetched a group ahead and handed to
//   the taps by shuffles;
// - the LayerNorm is two warp reductions a frame (the F frames' shuffles
//   interleaved) and no block barrier; the row is stored once.
//
// Any S >= K works: samples past S read as zeros and only ever feed frames
// t >= T_out, which are not stored. The conv runs in a fixed order: the
// bias, then the taps in order, as fmaf.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Channels a lane owns in one run (VEC), runs (NG), and the float4-or-less
// width a load takes (VW): the permuted index of channel o at tap k.
template <int NJ>
struct Lanes {
  static constexpr int VEC = NJ < 8 ? NJ : 8;
  static constexpr int NG = NJ / VEC;
  static constexpr int VW = VEC < 4 ? VEC : 4;
  static constexpr int VQ = VEC / VW;
  __device__ static int index(int k, int o) {
    const int k2 = o / (32 * VEC), lane = (o / VEC) % 32, j = o % VEC;
    return (((k * NG + k2) * VQ + j / VW) * 32 + lane) * VW + j % VW;
  }
};

// VW floats of shared memory at p (VW-aligned) into v.
template <int VW>
__device__ __forceinline__ void lds_vec(const float* p, float* v) {
  if constexpr (VW == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  } else if constexpr (VW == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    v[0] = u.x, v[1] = u.y;
  } else {
    v[0] = p[0];
  }
}

// A lane's VEC channels of one run, as bf16, in one store (16 bytes:
// streaming, the output is not read again soon).
template <int VEC>
__device__ __forceinline__ void store_run(bf16* dst, const float* y) {
  if constexpr (VEC == 1) {
    *dst = __float2bfloat16(y[0]);
  } else {
    uint32_t w[VEC / 2];
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    if constexpr (VEC == 8)
      __stcs(reinterpret_cast<uint4*>(dst),
             make_uint4(w[0], w[1], w[2], w[3]));
    else if constexpr (VEC == 4)
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<uint32_t*>(dst) = w[0];
  }
}

// NJ = O / 32 channels a lane; F frames a warp at once; KT the kernel
// width at compile time (0: K at run time).
template <int NJ, int F, int KT>
__global__ void __launch_bounds__(kThreads, 2)
conv0_kernel(const bf16* __restrict__ wave, const float* __restrict__ w,
             const float* __restrict__ bias, const float* __restrict__ gamma,
             const float* __restrict__ beta, bf16* __restrict__ out, int B,
             int S, int T_out, int K_rt, int stride, float eps, int fuse_ln,
             int fuse_act) {
  using LN = Lanes<NJ>;
  constexpr int O = NJ * 32, VEC = LN::VEC, NG = LN::NG, VW = LN::VW,
                VQ = LN::VQ;
  const int K = KT ? KT : K_rt;
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;         // [K][O], permuted
  float* b_s = w_s + K * O;  // [O] each, permuted as tap 0
  float* g_s = b_s + O;
  float* bt_s = g_s + O;

  for (int i = threadIdx.x; i < K * O; i += kThreads) {
    const int o = i / K, k = i - o * K;
    w_s[LN::index(k, o)] = w[i];
  }
  for (int o = threadIdx.x; o < O; o += kThreads) {
    const int at = LN::index(0, o);
    b_s[at] = bias[o];
    g_s[at] = gamma[o];
    bt_s[at] = beta[o];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int per_row = (T_out + F - 1) / F;
  const long long groups = static_cast<long long>(B) * per_row;
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  // the window of group g: lane i holds sample t0 * s + i (zero past S)
  const int win = (F - 1) * stride + K;
  const bool in_reg = win <= 32;
  auto window = [&](long long g) {
    const int b = static_cast<int>(g / per_row);
    const long long s0 =
        static_cast<long long>(g - static_cast<long long>(b) * per_row) * F *
            stride + lane;
    return in_reg && lane < win && s0 < S
               ? __bfloat162float(wave[static_cast<long long>(b) * S + s0])
               : 0.f;
  };
  long long g = static_cast<long long>(blockIdx.x) * kWarps +
                (threadIdx.x >> 5);
  float x_next = g < groups ? window(g) : 0.f;
  for (; g < groups; g += step) {
    const float x_win = x_next;
    if (g + step < groups) x_next = window(g + step);
    const int b = static_cast<int>(g / per_row);
    const int t0 = static_cast<int>(g - static_cast<long long>(b) * per_row) *
                   F;
    const bf16* wrow = wave + static_cast<long long>(b) * S;

    float y[F][NJ];
#pragma unroll
    for (int r = 0; r < NG * VQ; ++r) {
      float v[VW];
      lds_vec<VW>(b_s + (r * 32 + lane) * VW, v);
#pragma unroll
      for (int f = 0; f < F; ++f)
#pragma unroll
        for (int e = 0; e < VW; ++e) y[f][r * VW + e] = v[e];
    }
#pragma unroll(KT ? KT : 1)
    for (int k = 0; k < K; ++k) {
      float xk[F];
#pragma unroll
      for (int f = 0; f < F; ++f) {
        if (in_reg) {
          xk[f] = __shfl_sync(0xffffffffu, x_win, f * stride + k);
        } else {
          const long long s = static_cast<long long>(t0 + f) * stride + k;
          xk[f] = s < S ? __bfloat162float(wrow[s]) : 0.f;
        }
      }
      const float* wk = w_s + k * O;
#pragma unroll
      for (int r = 0; r < NG * VQ; ++r) {
        float v[VW];
        lds_vec<VW>(wk + (r * 32 + lane) * VW, v);
#pragma unroll
        for (int f = 0; f < F; ++f)
#pragma unroll
          for (int e = 0; e < VW; ++e)
            y[f][r * VW + e] = fmaf(v[e], xk[f], y[f][r * VW + e]);
      }
    }

    if (fuse_ln) {
      float s[F];
#pragma unroll
      for (int f = 0; f < F; ++f) {
        s[f] = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[f] += y[f][j];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int f = 0; f < F; ++f)
          s[f] += __shfl_xor_sync(0xffffffffu, s[f], o);
      float mean[F], v[F];
#pragma unroll
      for (int f = 0; f < F; ++f) {
        mean[f] = s[f] / O;
        v[f] = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float d = y[f][j] - mean[f];
          v[f] = fmaf(d, d, v[f]);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int f = 0; f < F; ++f)
          v[f] += __shfl_xor_sync(0xffffffffu, v[f], o);
#pragma unroll
      for (int r = 0; r < NG * VQ; ++r) {
        float gv[VW], bv[VW];
        lds_vec<VW>(g_s + (r * 32 + lane) * VW, gv);
        lds_vec<VW>(bt_s + (r * 32 + lane) * VW, bv);
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const float rstd = rsqrtf(v[f] / O + eps);
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            float& x = y[f][r * VW + e];
            x = (x - mean[f]) * rstd * gv[e] + bv[e];
          }
        }
      }
    }
    if (fuse_act) {
#pragma unroll
      for (int f = 0; f < F; ++f)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          y[f][j] = 0.5f * y[f][j] *
                    (1.f + erff(y[f][j] * 0.70710678118654752f));
    }
#pragma unroll
    for (int f = 0; f < F; ++f) {
      if (t0 + f >= T_out) break;  // uniform across the warp
      bf16* orow = out + (static_cast<long long>(b) * T_out + t0 + f) * O +
                   lane * VEC;
#pragma unroll
      for (int r = 0; r < NG; ++r)
        store_run<VEC>(orow + r * 32 * VEC, &y[f][r * VEC]);
    }
  }
}

template <int NJ, int F, int KT>
cudaError_t launch(const void* wave, const void* w, const void* bias,
                   const void* gamma, const void* beta, void* out, int B,
                   int S, int T_out, int K, int stride, float eps,
                   int fuse_ln, int fuse_act, cudaStream_t stream) {
  constexpr int O = NJ * 32;
  const size_t smem = sizeof(float) * (static_cast<size_t>(K) + 3) * O;
  auto kern = conv0_kernel<NJ, F, KT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  const long long groups =
      static_cast<long long>(B) * ((T_out + F - 1) / F);
  const long long need = (groups + kWarps - 1) / kWarps;
  const int grid = static_cast<int>(
      need < static_cast<long long>(sms) * per_sm ? need
                                                  : sms * per_sm);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(wave), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<bf16*>(out), B, S, T_out,
      K, stride, eps, fuse_ln, fuse_act);
  return cudaGetLastError();
}

// WavLM's K = 10 at compile time; any other K at run time. Frames a warp:
// 4 up to O = 256, 3 at 512, 2 at 1024 (the accumulators stay within 64
// registers; at O = 512, 4 frames a warp spilled and measured slower on
// the H100, as did 2).
template <int NJ>
cudaError_t launch_k(const void* wave, const void* w, const void* bias,
                     const void* gamma, const void* beta, void* out, int B,
                     int S, int T_out, int K, int stride, float eps,
                     int fuse_ln, int fuse_act, cudaStream_t stream) {
  constexpr int F = NJ >= 32 ? 2 : NJ >= 16 ? 3 : 4;
  if (K == 10)
    return launch<NJ, F, 10>(wave, w, bias, gamma, beta, out, B, S, T_out,
                             K, stride, eps, fuse_ln, fuse_act, stream);
  return launch<NJ, F, 0>(wave, w, bias, gamma, beta, out, B, S, T_out, K,
                          stride, eps, fuse_ln, fuse_act, stream);
}

}  // namespace

MTASR_EXPORT_ERROR_STRING

// wave [B, S] bf16, w [O, K] f32, bias/gamma/beta [O] f32,
// out [B, T_out, O] bf16. O in {32, 64, ..., 1024}; K * O floats and three
// rows of O must fit a block's shared memory.
extern "C" int conv0_fused_launch(const void* wave, const void* w,
                                  const void* bias, const void* gamma,
                                  const void* beta, void* out, int B, int S,
                                  int T_out, int O, int K, int stride,
                                  float eps, int fuse_ln, int fuse_act,
                                  void* stream) {
  if (B < 1 || K < 1 || stride < 1 || T_out < 1 || S < K)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MTASR_CONV0_CASE(NJ)                                               \
  case NJ * 32:                                                            \
    return static_cast<int>(launch_k<NJ>(wave, w, bias, gamma, beta, out,  \
                                         B, S, T_out, K, stride, eps,      \
                                         fuse_ln, fuse_act, st));
  switch (O) {
    MTASR_CONV0_CASE(1)
    MTASR_CONV0_CASE(2)
    MTASR_CONV0_CASE(4)
    MTASR_CONV0_CASE(8)
    MTASR_CONV0_CASE(16)
    MTASR_CONV0_CASE(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MTASR_CONV0_CASE
}
