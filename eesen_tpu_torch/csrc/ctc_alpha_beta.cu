// CTC alpha and beta recursions for Hopper (sm_90a), one kernel each.
//
// Replaces the TPU kernels `_alpha_kernel` (eesen_tpu/ops/ctc_pallas.py:62)
// and `_beta_kernel` (ctc_pallas.py:88) with the contract of their wrapper
// `ctc_alpha_beta_pallas` (ctc_pallas.py:120), and computes what they
// compute, in log space with the LOG_ZERO = -1e30 sentinel:
//   alpha[t=0]  = lp[0] on states s <= 1, LOG_ZERO elsewhere;
//   alpha[t]    = lp[t] + log_add(log_add(a, a[s-1]), a[s-2] + skip[s])
//                 for 0 < t < len, alpha[t-1] for t >= len (frozen);
//   beta[t]     = init row at t = len-1, LOG_ZERO for t >= len, and for
//                 t < len-1: log_add(log_add(n, n[s+1]), n[s+2] + skip[s+2])
//                 with n = beta[t+1] + lp[t+1];
// log_add(a, b) = hi + log1p(exp(lo - hi)) when hi > -1e29, else LOG_ZERO
// (ctc_pallas.py:38-45).  Neighbours beyond the last state read LOG_ZERO.
// A length-0 row gives the t=0 init row in every alpha row and LOG_ZERO in
// every beta row, as on the TPU.
//
// Layout: lp [B,T,S] f32, skip [B,S] f32 additive (0 or LOG_ZERO, the
// destination view), init [B,S] f32, lengths [B] int32 -> alpha, beta
// [B,T,S] f32.  The TPU's [T,Bp,Sp] padding is a tiling artefact and is gone.
//
// Design.  One thread block per batch row and one thread per state s (S <=
// 1024), with a loop over t inside the block in place of the TPU's
// sequential grid.  Each thread keeps its own state in a register; the
// s-1/s-2 (alpha) or s+1/s+2 (beta) neighbours come through a shared-memory
// row that alternates between two buffers, so a step needs one barrier.  The
// next step's log-probability is loaded before the barrier to hide its
// latency.
//
// Bound.  Each kernel reads lp once and writes its output once: 2*B*T*S*4
// bytes, 0.047 ms at B=128, T=768, S=201 and 3.35 TB/s.  The kernel is bound
// instead by its T-step serial chain (a barrier, a global load and two
// log_adds per step), with B of the 132 SMs busy.

#include <cuda_runtime.h>

namespace {

constexpr float LOG_ZERO = -1e30f;
constexpr float LOG_ZERO_THRESHOLD = -1e29f;

__device__ __forceinline__ float log_add(float a, float b) {
  const float hi = fmaxf(a, b);
  const float lo = fminf(a, b);
  return hi > LOG_ZERO_THRESHOLD ? hi + log1pf(expf(lo - hi)) : LOG_ZERO;
}

__global__ void ctc_alpha_kernel(const float* __restrict__ lp, const float* __restrict__ skip,
                                 const int* __restrict__ lengths, float* __restrict__ alpha,
                                 int T, int S) {
  extern __shared__ float row[];  // [2][S]
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const bool on = s < S;
  const int len = lengths[b];
  const float* lpb = lp + (size_t)b * T * S;
  float* out = alpha + (size_t)b * T * S;
  const float sk = on ? skip[(size_t)b * S + s] : LOG_ZERO;

  float a = on && s <= 1 ? lpb[s] : LOG_ZERO;
  if (on) out[s] = a;
  float lp_next = on && T > 1 ? lpb[S + s] : 0.0f;
  for (int t = 1; t < T; ++t) {
    float* cur = row + (t & 1) * S;
    if (on) cur[s] = a;
    const float lp_t = lp_next;
    if (on && t + 1 < T) lp_next = lpb[(size_t)(t + 1) * S + s];
    __syncthreads();
    if (on) {
      const float prev1 = s >= 1 ? cur[s - 1] : LOG_ZERO;
      const float prev2 = (s >= 2 ? cur[s - 2] : LOG_ZERO) + sk;
      const float next = lp_t + log_add(log_add(a, prev1), prev2);
      if (t < len) a = next;
      out[(size_t)t * S + s] = a;
    }
  }
}

__global__ void ctc_beta_kernel(const float* __restrict__ lp, const float* __restrict__ skip,
                                const float* __restrict__ init, const int* __restrict__ lengths,
                                float* __restrict__ beta, int T, int S) {
  extern __shared__ float row[];  // [2][S + 2]: n = beta[t+1] + lp[t+1]
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const bool on = s < S;
  const int len = lengths[b];
  const int W = S + 2;
  const float* lpb = lp + (size_t)b * T * S;
  float* out = beta + (size_t)b * T * S;
  // the skip into s+2, seen from the source state s
  const float sk2 = on && s + 2 < S && skip[(size_t)b * S + s + 2] > LOG_ZERO_THRESHOLD
                        ? 0.0f : LOG_ZERO;
  const float ini = on ? init[(size_t)b * S + s] : LOG_ZERO;
  if (s < 2) {  // the LOG_ZERO fill past the last state, in both buffers
    row[S + s] = LOG_ZERO;
    row[W + S + s] = LOG_ZERO;
  }

  float bt = LOG_ZERO;
  float lp_next = on ? lpb[(size_t)(T - 1) * S + s] : 0.0f;  // lp[min(t+1, T-1)]
  for (int t = T - 1; t >= 0; --t) {
    float* cur = row + (t & 1) * W;
    const float n = bt + lp_next;
    if (on) cur[s] = n;
    if (on && t >= 1) lp_next = lpb[(size_t)t * S + s];
    __syncthreads();
    if (on) {
      const float rec = log_add(log_add(n, cur[s + 1]), cur[s + 2] + sk2);
      bt = t == len - 1 ? ini : (t < len - 1 ? rec : LOG_ZERO);
      out[(size_t)t * S + s] = bt;
    }
  }
}

}  // namespace

// Launches the alpha recursion over B rows on `stream`; returns
// cudaGetLastError().  S <= 1024.
extern "C" int ctc_alpha(const void* lp, const void* skip, const void* lengths, void* alpha,
                         int B, int T, int S, void* stream) {
  const int threads = ((S + 31) / 32) * 32;
  ctc_alpha_kernel<<<B, threads, 2 * S * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp), static_cast<const float*>(skip),
      static_cast<const int*>(lengths), static_cast<float*>(alpha), T, S);
  return (int)cudaGetLastError();
}

// Launches the beta recursion over B rows on `stream`; returns
// cudaGetLastError().  S <= 1024.
extern "C" int ctc_beta(const void* lp, const void* skip, const void* init, const void* lengths,
                        void* beta, int B, int T, int S, void* stream) {
  const int threads = ((S + 31) / 32) * 32;
  ctc_beta_kernel<<<B, threads, 2 * (S + 2) * sizeof(float),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp), static_cast<const float*>(skip),
      static_cast<const float*>(init), static_cast<const int*>(lengths),
      static_cast<float*>(beta), T, S);
  return (int)cudaGetLastError();
}
