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
// Bound on the H100: counting the bytes moved (at the training shapes,
// B = 16, T = 499, S = 21: #11 reads emit and writes alpha, about 1.3 MB,
// 0.4 us at 3.35 TB/s; #12 reads emit and alpha and writes log_post). The
// real limit of this design is latency: T dependent steps, one block barrier
// each, on B blocks (16 of 132 SMs busy). Design: the TPU grid (B,) becomes
// B blocks; a block's threads own the lattice positions (ceil(S/32) warps,
// any S up to 1024); the previous step's row lives in shared memory, double
// buffered, so one __syncthreads a step; the neighbours s-1, s-2 (#11) or
// s+1, s+2 (#12) are read from it, LOG_EPS out of range; each step's
// emission (and alpha for #12) is loaded before the barrier. A warp per row
// with shuffles, several rows a block, and fusing #11 into the emission
// gather are later work.
#include "common.cuh"

namespace {

constexpr float kLogEps = -1e30f;

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float ms = fmaxf(m, kLogEps);
  const float out =
      ms + logf(expf(a - ms) + expf(b - ms) + expf(c - ms));
  return fmaxf(out, kLogEps);
}

__global__ void ctc_alpha_kernel(const float* __restrict__ emit,
                                 const unsigned char* __restrict__ allow,
                                 const int* __restrict__ ilen_p,
                                 const int* __restrict__ label_len_p,
                                 float* __restrict__ alpha,
                                 float* __restrict__ final_row, int T,
                                 int S) {
  extern __shared__ float buf[];  // [2][blockDim.x]
  const int b = blockIdx.x, s = threadIdx.x, n = blockDim.x;
  const bool in = s < S;
  const int ilen = ilen_p[b];
  const bool valid = in && s < 2 * label_len_p[b] + 1;
  const bool skip = in && allow[static_cast<long long>(b) * S + s] != 0;
  const float* e = emit + static_cast<long long>(b) * T * S;
  float* a_out = alpha + static_cast<long long>(b) * T * S;

  float a = kLogEps;
  if (in) {
    a = (s < 2 && valid) ? e[s] : kLogEps;
    a = fmaxf(a, kLogEps);
    a_out[s] = a;
  }
  buf[s] = a;
  int cur = 0;
  for (int t = 1; t < T; ++t) {
    const float et = in ? e[static_cast<long long>(t) * S + s] : 0.f;
    __syncthreads();
    const float* prev = buf + cur * n;
    if (in) {
      const float from1 = s >= 1 ? prev[s - 1] : kLogEps;
      const float from2 = (skip && s >= 2) ? prev[s - 2] : kLogEps;
      float nw = lse3(a, from1, from2) + et;
      nw = valid ? nw : kLogEps;
      nw = fmaxf(nw, kLogEps);
      a = t < ilen ? nw : a;
      a_out[static_cast<long long>(t) * S + s] = a;
    }
    cur ^= 1;
    buf[cur * n + s] = a;
  }
  if (in) final_row[static_cast<long long>(b) * S + s] = a;
}

__global__ void ctc_beta_post_kernel(const float* __restrict__ emit,
                                     const float* __restrict__ alpha,
                                     const unsigned char* __restrict__ allow,
                                     const int* __restrict__ ilen_p,
                                     const int* __restrict__ label_len_p,
                                     float* __restrict__ log_post, int T,
                                     int S) {
  extern __shared__ float buf[];  // [2][blockDim.x]
  const int b = blockIdx.x, s = threadIdx.x, n = blockDim.x;
  const bool in = s < S;
  const int ilen = ilen_p[b];
  const int last = 2 * label_len_p[b];
  const bool valid = in && s < last + 1;
  // the s -> s+2 skip is allowed iff allow[s+2]
  const bool skip2 =
      s + 2 < S && allow[static_cast<long long>(b) * S + s + 2] != 0;
  const long long row = static_cast<long long>(b) * T * S;
  const float* e = emit + row;
  const float* al = alpha + row;
  float* out = log_post + row;

  float beta_T = (s == last || s == max(last - 1, 0)) ? 0.f : kLogEps;
  beta_T = valid ? beta_T : kLogEps;
  float beta = beta_T;
  int cur = 0;
  for (int i = 0; i < T; ++i) {
    const int t = T - 1 - i;
    const bool active = t < ilen;
    const int tn = min(t + 1, T - 1);
    float term = kLogEps, a_t = 0.f;
    if (in) {
      term = fmaxf(beta + e[static_cast<long long>(tn) * S + s], kLogEps);
      a_t = al[static_cast<long long>(t) * S + s];
    }
    float* cb = buf + cur * n;
    cb[s] = term;
    __syncthreads();
    if (in) {
      float nb = beta;
      if (active && t < ilen - 1) {
        const float from1 = s + 1 < S ? cb[s + 1] : kLogEps;
        const float from2 = skip2 ? cb[s + 2] : kLogEps;
        nb = lse3(term, from1, from2);
        nb = valid ? nb : kLogEps;
      }
      float g = kLogEps;
      if (active) {
        const float bt = t == ilen - 1 ? beta_T : nb;
        g = valid ? fmaxf(a_t + bt, kLogEps) : kLogEps;
      }
      out[static_cast<long long>(t) * S + s] = g;
      beta = (active && t == ilen - 1) ? beta_T : nb;
    }
    cur ^= 1;
  }
}

}  // namespace

MTASR_EXPORT_ERROR_STRING

// which 0: #11, alpha_in unused, out = alpha [B, T, S], final_row [B, S].
// which 1: #12, alpha_in = alpha, out = log_post [B, T, S], final_row unused.
// T >= 1, 1 <= S <= 1024.
extern "C" int ctc_launch(int which, const void* emit, const void* alpha_in,
                          const void* allow, const void* ilen,
                          const void* label_len, void* out, void* final_row,
                          int B, int T, int S, void* stream) {
  if (B < 0 || T < 1 || S < 1 || S > 1024 || which < 0 || which > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int threads = (S + 31) / 32 * 32;
  const size_t smem = 2 * threads * sizeof(float);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* e = static_cast<const float*>(emit);
  const auto* al = static_cast<const unsigned char*>(allow);
  const auto* il = static_cast<const int*>(ilen);
  const auto* ll = static_cast<const int*>(label_len);
  if (which == 0)
    ctc_alpha_kernel<<<B, threads, smem, st>>>(
        e, al, il, ll, static_cast<float*>(out),
        static_cast<float*>(final_row), T, S);
  else
    ctc_beta_post_kernel<<<B, threads, smem, st>>>(
        e, static_cast<const float*>(alpha_in), al, il, ll,
        static_cast<float*>(out), T, S);
  return static_cast<int>(cudaGetLastError());
}
