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
// Design.  One thread block per batch row, with a loop over t inside the
// block in place of the TPU's sequential grid.  A thread owns the states
// s = tid + i*threads, i < SPT (SPT = 1 up to 1024 states, then ceil(S/1024)
// rounded up to a power of two, so any S whose two rows fit in shared
// memory runs) and keeps them in registers; the s-1/s-2 (alpha) or s+1/s+2
// (beta) neighbours come through a shared-memory row that alternates
// between two buffers, so a step needs one barrier.  The next step's
// log-probabilities are loaded before the barrier to hide their latency.
//
// Bound.  Each kernel reads lp once and writes its output once: 2*B*T*S*4
// bytes, 0.047 ms at B=128, T=768, S=201 and 3.35 TB/s.  The kernel is bound
// instead by its T-step serial chain (a barrier, a global load and two
// log_adds per step), with B of the 132 SMs busy.

#include <cuda_runtime.h>

namespace {

constexpr float LOG_ZERO = -1e30f;
constexpr float LOG_ZERO_THRESHOLD = -1e29f;
constexpr int MAX_THREADS = 1024;

__device__ __forceinline__ float log_add(float a, float b) {
  const float hi = fmaxf(a, b);
  const float lo = fminf(a, b);
  return hi > LOG_ZERO_THRESHOLD ? hi + log1pf(expf(lo - hi)) : LOG_ZERO;
}

template <int SPT>
__global__ void __launch_bounds__(MAX_THREADS)
    ctc_alpha_kernel(const float* __restrict__ lp, const float* __restrict__ skip,
                     const int* __restrict__ lengths, float* __restrict__ alpha, int T, int S) {
  extern __shared__ float row[];  // [2][S]
  const int b = blockIdx.x;
  const int nthr = blockDim.x;
  const int len = lengths[b];
  const float* lpb = lp + (size_t)b * T * S;
  float* out = alpha + (size_t)b * T * S;
  float a[SPT], sk[SPT], lp_next[SPT];
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int s = threadIdx.x + i * nthr;
    const bool on = s < S;
    sk[i] = on ? skip[(size_t)b * S + s] : LOG_ZERO;
    a[i] = on && s <= 1 ? lpb[s] : LOG_ZERO;
    if (on) out[s] = a[i];
    lp_next[i] = on && T > 1 ? lpb[S + s] : 0.0f;
  }
  for (int t = 1; t < T; ++t) {
    float* cur = row + (t & 1) * S;
    float lp_t[SPT];
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int s = threadIdx.x + i * nthr;
      const bool on = s < S;
      if (on) cur[s] = a[i];
      lp_t[i] = lp_next[i];
      if (on && t + 1 < T) lp_next[i] = lpb[(size_t)(t + 1) * S + s];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int s = threadIdx.x + i * nthr;
      if (s < S) {
        const float prev1 = s >= 1 ? cur[s - 1] : LOG_ZERO;
        const float prev2 = (s >= 2 ? cur[s - 2] : LOG_ZERO) + sk[i];
        const float next = lp_t[i] + log_add(log_add(a[i], prev1), prev2);
        if (t < len) a[i] = next;
        out[(size_t)t * S + s] = a[i];
      }
    }
  }
}

template <int SPT>
__global__ void __launch_bounds__(MAX_THREADS)
    ctc_beta_kernel(const float* __restrict__ lp, const float* __restrict__ skip,
                    const float* __restrict__ init, const int* __restrict__ lengths,
                    float* __restrict__ beta, int T, int S) {
  extern __shared__ float row[];  // [2][S + 2]: n = beta[t+1] + lp[t+1]
  const int b = blockIdx.x;
  const int nthr = blockDim.x;
  const int len = lengths[b];
  const int W = S + 2;
  const float* lpb = lp + (size_t)b * T * S;
  float* out = beta + (size_t)b * T * S;
  float bt[SPT], sk2[SPT], ini[SPT], lp_next[SPT];
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int s = threadIdx.x + i * nthr;
    const bool on = s < S;
    // the skip into s+2, seen from the source state s
    sk2[i] = on && s + 2 < S && skip[(size_t)b * S + s + 2] > LOG_ZERO_THRESHOLD ? 0.0f
                                                                              : LOG_ZERO;
    ini[i] = on ? init[(size_t)b * S + s] : LOG_ZERO;
    bt[i] = LOG_ZERO;
    lp_next[i] = on ? lpb[(size_t)(T - 1) * S + s] : 0.0f;  // lp[min(t+1, T-1)]
  }
  if (threadIdx.x < 2) {  // the LOG_ZERO fill past the last state, in both buffers
    row[S + threadIdx.x] = LOG_ZERO;
    row[W + S + threadIdx.x] = LOG_ZERO;
  }
  for (int t = T - 1; t >= 0; --t) {
    float* cur = row + (t & 1) * W;
    float n[SPT];
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int s = threadIdx.x + i * nthr;
      const bool on = s < S;
      n[i] = bt[i] + lp_next[i];
      if (on) cur[s] = n[i];
      if (on && t >= 1) lp_next[i] = lpb[(size_t)t * S + s];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int s = threadIdx.x + i * nthr;
      if (s < S) {
        const float rec = log_add(log_add(n[i], cur[s + 1]), cur[s + 2] + sk2[i]);
        bt[i] = t == len - 1 ? ini[i] : (t < len - 1 ? rec : LOG_ZERO);
        out[(size_t)t * S + s] = bt[i];
      }
    }
  }
}

// States a thread owns at S: 1 up to MAX_THREADS states, else
// ceil(S / MAX_THREADS) rounded up to a power of two (0 past 32).
int states_per_thread(int S) {
  const int need = (S + MAX_THREADS - 1) / MAX_THREADS;
  int spt = 1;
  while (spt < need) spt <<= 1;
  return spt <= 32 ? spt : 0;
}

// Sets the kernel's dynamic shared memory (rows above 48 KB need it) and
// launches it with `threads` threads a row.
template <typename K, typename... Args>
cudaError_t launch(K kern, int B, int threads, size_t smem, cudaStream_t st, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<B, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

template <int SPT>
cudaError_t run(bool alpha_pass, const void* lp, const void* skip, const void* init,
                const void* lengths, void* out, int B, int T, int S, cudaStream_t st) {
  const int threads = ((S + SPT - 1) / SPT + 31) / 32 * 32;
  const float* lpf = static_cast<const float*>(lp);
  const float* skf = static_cast<const float*>(skip);
  const int* len = static_cast<const int*>(lengths);
  float* o = static_cast<float*>(out);
  if (alpha_pass)
    return launch(ctc_alpha_kernel<SPT>, B, threads, 2 * (size_t)S * sizeof(float), st, lpf,
                  skf, len, o, T, S);
  return launch(ctc_beta_kernel<SPT>, B, threads, 2 * (size_t)(S + 2) * sizeof(float), st, lpf,
                skf, static_cast<const float*>(init), len, o, T, S);
}

cudaError_t dispatch(bool alpha_pass, const void* lp, const void* skip, const void* init,
                     const void* lengths, void* out, int B, int T, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (states_per_thread(S)) {
    case 1: return run<1>(alpha_pass, lp, skip, init, lengths, out, B, T, S, st);
    case 2: return run<2>(alpha_pass, lp, skip, init, lengths, out, B, T, S, st);
    case 4: return run<4>(alpha_pass, lp, skip, init, lengths, out, B, T, S, st);
    case 8: return run<8>(alpha_pass, lp, skip, init, lengths, out, B, T, S, st);
    case 16: return run<16>(alpha_pass, lp, skip, init, lengths, out, B, T, S, st);
    case 32: return run<32>(alpha_pass, lp, skip, init, lengths, out, B, T, S, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the alpha recursion over B rows on `stream`; returns the first
// CUDA error (the two shared rows must fit in a block's shared memory).
extern "C" int ctc_alpha(const void* lp, const void* skip, const void* lengths, void* alpha,
                         int B, int T, int S, void* stream) {
  return (int)dispatch(true, lp, skip, nullptr, lengths, alpha, B, T, S, stream);
}

// Launches the beta recursion over B rows on `stream`; returns the first
// CUDA error (as ctc_alpha).
extern "C" int ctc_beta(const void* lp, const void* skip, const void* init, const void* lengths,
                        void* beta, int B, int T, int S, void* stream) {
  return (int)dispatch(false, lp, skip, init, lengths, beta, B, T, S, stream);
}
