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
// between two buffers, so a step needs one barrier.  A step's chain is the
// store to that row, the barrier, the neighbour loads and two log_adds; the
// step's log-probabilities enter last (alpha: + lp[t]; beta: n = beta[t] +
// lp[t] for the next step), after the barrier.
//
// The log-probabilities come through a ring of P slots [P][S] in shared
// memory behind the rows, filled by 4-byte cp.async P-1 steps ahead (rows
// of S*4 bytes are not whole 16-byte units, so TMA cannot take them).  Only
// the issuing thread reads a slot entry, so the ring needs no barrier of its
// own: a thread waits for its own copies (cp.async.wait_group P-2), reads
// slot k % P, and refills the slot it read a step earlier, behind this
// step's barrier.  Past the last row it commits empty groups, so the wait
// count stays a constant.  P is the largest of 8, 4, 2 whose ring fits
// beside the rows (ctc_depth; ops/ctc_cuda.ctc_plan mirrors it); where
// none fits, P = 1 loads each state's lp into a register a step ahead.
//
// Bound.  Each kernel reads lp once and writes its output once: 2*B*T*S*4
// bytes, 0.047 ms at B=128, T=768, S=201 and 3.35 TB/s.  The kernel is bound
// instead by its T-step serial chain, with B of the 132 SMs busy.

#include <cuda_runtime.h>

#include <atomic>

#ifndef EESEN_SMEM_LIMIT
#error "build with -DEESEN_SMEM_LIMIT=<bytes> (ops/build.py NVCC_FLAGS)"
#endif

namespace {

constexpr float LOG_ZERO = -1e30f;
constexpr float LOG_ZERO_THRESHOLD = -1e29f;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_SPT = 32;
constexpr int MAX_DEPTH = 8;
constexpr long long SMEM_LIMIT = EESEN_SMEM_LIMIT;  // ops/build.SMEM_LIMIT, by nvcc -D

__device__ __forceinline__ float log_add(float a, float b) {
  const float hi = fmaxf(a, b);
  const float lo = fminf(a, b);
  return hi > LOG_ZERO_THRESHOLD ? hi + log1pf(expf(lo - hi)) : LOG_ZERO;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This thread's log-probabilities of rows t0, t0+dir, ... (n steps), one
// step at a time.  P >= 2: the ring (see the header), slot j % P holding
// step j; P == 1: one register a state, loaded at the end of the step
// before.  Pointers move by whole rows, so a step's copies cost no 64-bit
// index arithmetic.
template <int SPT, int P>
struct LpFeed {
  const float* src;  // the next row to issue, at this thread's first state
  long long stride;  // dir * S
  float* ring;       // slot 0 at this thread's first state
  float* fill;       // the slot to fill next
  const float* read; // the slot to read next
  int S, left;       // states; steps not yet issued
  float reg[SPT];

  __device__ __forceinline__ LpFeed(const float* lpb, float* ring0, int S_, int t0, int dir, int n)
      : src(lpb + (size_t)t0 * S_ + threadIdx.x),
        stride((long long)dir * S_),
        ring(ring0 + threadIdx.x),
        fill(ring0 + threadIdx.x),
        read(ring0 + threadIdx.x),
        S(S_),
        left(n) {}

  __device__ __forceinline__ void issue() {
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      if ((int)threadIdx.x + i * (int)blockDim.x < S) {
        if constexpr (P == 1)
          reg[i] = src[i * blockDim.x];
        else
          cp_async4(fill + i * blockDim.x, src + i * blockDim.x);
      }
    }
    src += stride;
    --left;
    if constexpr (P > 1) {
      fill += S;
      if (fill == ring + P * S) fill = ring;
    }
  }
  // the prologue: steps 0..P-2 in flight (P == 1: step 0 in registers)
  __device__ __forceinline__ void start() {
    if constexpr (P == 1) {
      if (left > 0) issue();
    } else {
#pragma unroll
      for (int j = 0; j < P - 1; ++j) {
        if (left > 0) issue();
        cp_async_commit();
      }
    }
  }
  // this step's log-probabilities into v: the step's copies have landed
  // once all but P-2 of this thread's groups are complete (the prologue's
  // P-1 and one a step)
  __device__ __forceinline__ void take(float (&v)[SPT]) {
    if constexpr (P == 1) {
#pragma unroll
      for (int i = 0; i < SPT; ++i) v[i] = reg[i];
    } else {
      cp_async_wait<P - 2>();
#pragma unroll
      for (int i = 0; i < SPT; ++i)
        v[i] = (int)threadIdx.x + i * (int)blockDim.x < S ? read[i * blockDim.x] : 0.0f;
    }
  }
  // after the step's take, behind its barrier: the next step into the
  // slot read a step earlier (the barrier lies between that read and this
  // refill), or into the registers
  __device__ __forceinline__ void advance() {
    if constexpr (P == 1) {
      if (left > 0) issue();
    } else {
      read += S;
      if (read == ring + P * S) read = ring;
      if (left > 0) issue();
      cp_async_commit();
    }
  }
};

template <int SPT, int P>
__global__ void __launch_bounds__(MAX_THREADS)
    ctc_alpha_kernel(const float* __restrict__ lp, const float* __restrict__ skip,
                     const int* __restrict__ lengths, float* __restrict__ alpha, int T, int S) {
  extern __shared__ float smem[];  // rows [2][S + 2], ring [P][S]
  float* row = smem;
  const int b = blockIdx.x;
  const int nthr = blockDim.x;
  const int len = lengths[b];
  const float* lpb = lp + (size_t)b * T * S;
  float* out = alpha + (size_t)b * T * S + threadIdx.x;  // this thread's first state
  LpFeed<SPT, P> feed(lpb, smem + 2 * (S + 2), S, 1, 1, T - 1);  // lp[t] at t = 1..T-1
  feed.start();
  float a[SPT], sk[SPT];
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int s = threadIdx.x + i * nthr;
    const bool on = s < S;
    sk[i] = on ? skip[(size_t)b * S + s] : LOG_ZERO;
    a[i] = on && s <= 1 ? lpb[s] : LOG_ZERO;
    if (on) out[i * nthr] = a[i];
  }
  for (int t = 1; t < T; ++t) {
    float* cur = row + (t & 1) * S;
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int s = threadIdx.x + i * nthr;
      if (s < S) cur[s] = a[i];
    }
    __syncthreads();
    float lp_t[SPT];
    feed.take(lp_t);
    out += S;
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int s = threadIdx.x + i * nthr;
      if (s < S) {
        const float prev1 = s >= 1 ? cur[s - 1] : LOG_ZERO;
        const float prev2 = (s >= 2 ? cur[s - 2] : LOG_ZERO) + sk[i];
        const float next = lp_t[i] + log_add(log_add(a[i], prev1), prev2);
        if (t < len) a[i] = next;
        out[i * nthr] = a[i];
      }
    }
    feed.advance();
  }
}

template <int SPT, int P>
__global__ void __launch_bounds__(MAX_THREADS)
    ctc_beta_kernel(const float* __restrict__ lp, const float* __restrict__ skip,
                    const float* __restrict__ init, const int* __restrict__ lengths,
                    float* __restrict__ beta, int T, int S) {
  extern __shared__ float smem[];  // rows [2][S + 2]: n = beta[t+1] + lp[t+1]; ring [P][S]
  float* row = smem;
  const int b = blockIdx.x;
  const int nthr = blockDim.x;
  const int len = lengths[b];
  const int W = S + 2;
  const float* lpb = lp + (size_t)b * T * S;
  float* out = beta + (size_t)b * T * S + (size_t)(T - 1) * S + threadIdx.x;  // at t = T-1
  // the step at t ends with lp[t], t = T-1..1, for the next step's n
  LpFeed<SPT, P> feed(lpb, smem + 2 * W, S, T - 1, -1, T - 1);
  feed.start();
  float n[SPT], sk2[SPT], ini[SPT];
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int s = threadIdx.x + i * nthr;
    const bool on = s < S;
    // the skip into s+2, seen from the source state s
    sk2[i] = on && s + 2 < S && skip[(size_t)b * S + s + 2] > LOG_ZERO_THRESHOLD ? 0.0f
                                                                              : LOG_ZERO;
    ini[i] = on ? init[(size_t)b * S + s] : LOG_ZERO;
    n[i] = LOG_ZERO + (on ? lpb[(size_t)(T - 1) * S + s] : 0.0f);  // lp[min(t+1, T-1)]
  }
  if (threadIdx.x < 2) {  // the LOG_ZERO fill past the last state, in both buffers
    row[S + threadIdx.x] = LOG_ZERO;
    row[W + S + threadIdx.x] = LOG_ZERO;
  }
  for (int t = T - 1; t >= 0; --t) {
    float* cur = row + (t & 1) * W;
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int s = threadIdx.x + i * nthr;
      if (s < S) cur[s] = n[i];
    }
    __syncthreads();
    float lp_t[SPT];
    if (t >= 1) feed.take(lp_t);
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int s = threadIdx.x + i * nthr;
      if (s < S) {
        const float rec = log_add(log_add(n[i], cur[s + 1]), cur[s + 2] + sk2[i]);
        const float bt = t == len - 1 ? ini[i] : (t < len - 1 ? rec : LOG_ZERO);
        out[i * nthr] = bt;
        if (t >= 1) n[i] = bt + lp_t[i];
      }
    }
    out -= S;
    if (t >= 1) feed.advance();
  }
}

// States a thread owns at S: 1 up to MAX_THREADS states, else
// ceil(S / MAX_THREADS) rounded up to a power of two (0 past MAX_SPT).
int states_per_thread(int S) {
  const int need = (S + MAX_THREADS - 1) / MAX_THREADS;
  int spt = 1;
  while (spt < need) spt <<= 1;
  return spt <= MAX_SPT ? spt : 0;
}

// Shared memory of either kernel: the two rows of S + 2 and, at depth
// P >= 2, the ring of P rows of S.
long long smem_bytes(int S, int depth) {
  return 4LL * (2LL * (S + 2) + (depth >= 2 ? (long long)depth * S : 0));
}

// The ring's depth at S: the largest of 8, 4, 2 that fits beside the rows,
// else 1 (no ring) while the rows fit; 0 where S is refused.
int depth_for(int S) {
  if (S < 1 || states_per_thread(S) == 0 || smem_bytes(S, 1) > SMEM_LIMIT) return 0;
  for (int p = MAX_DEPTH; p >= 2; p >>= 1)
    if (smem_bytes(S, p) <= SMEM_LIMIT) return p;
  return 1;
}

// Raises the instance's dynamic shared-memory cap to the block limit, once
// per device; later launches of any size up to it need no call.
template <typename K>
cudaError_t allow_smem(K kern, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_LIMIT);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <int SPT, int P>
cudaError_t run(bool alpha_pass, const void* lp, const void* skip, const void* init,
                const void* lengths, void* out, int B, int T, int S, cudaStream_t st) {
  static std::atomic<unsigned long long> done[2];
  const int threads = ((S + SPT - 1) / SPT + 31) / 32 * 32;
  const size_t smem = (size_t)smem_bytes(S, P);
  const float* lpf = static_cast<const float*>(lp);
  const float* skf = static_cast<const float*>(skip);
  const int* len = static_cast<const int*>(lengths);
  float* o = static_cast<float*>(out);
  if (alpha_pass) {
    cudaError_t err = allow_smem(ctc_alpha_kernel<SPT, P>, done[0]);
    if (err != cudaSuccess) return err;
    ctc_alpha_kernel<SPT, P><<<B, threads, smem, st>>>(lpf, skf, len, o, T, S);
  } else {
    cudaError_t err = allow_smem(ctc_beta_kernel<SPT, P>, done[1]);
    if (err != cudaSuccess) return err;
    ctc_beta_kernel<SPT, P><<<B, threads, smem, st>>>(
        lpf, skf, static_cast<const float*>(init), len, o, T, S);
  }
  return cudaGetLastError();
}

cudaError_t dispatch(bool alpha_pass, const void* lp, const void* skip, const void* init,
                     const void* lengths, void* out, int B, int T, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the (states a thread, depth) pairs that depth_for reaches
  switch (states_per_thread(S) * 16 + depth_for(S)) {
    case 1 * 16 + 8: return run<1, 8>(alpha_pass, lp, skip, init, lengths, out, B, T, S, st);
    case 2 * 16 + 8: return run<2, 8>(alpha_pass, lp, skip, init, lengths, out, B, T, S, st);
    case 4 * 16 + 8: return run<4, 8>(alpha_pass, lp, skip, init, lengths, out, B, T, S, st);
    case 8 * 16 + 8: return run<8, 8>(alpha_pass, lp, skip, init, lengths, out, B, T, S, st);
    case 8 * 16 + 4: return run<8, 4>(alpha_pass, lp, skip, init, lengths, out, B, T, S, st);
    case 16 * 16 + 4: return run<16, 4>(alpha_pass, lp, skip, init, lengths, out, B, T, S, st);
    case 16 * 16 + 2: return run<16, 2>(alpha_pass, lp, skip, init, lengths, out, B, T, S, st);
    case 16 * 16 + 1: return run<16, 1>(alpha_pass, lp, skip, init, lengths, out, B, T, S, st);
    case 32 * 16 + 1: return run<32, 1>(alpha_pass, lp, skip, init, lengths, out, B, T, S, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The ring's depth at S (0 where S is refused); ops/ctc_cuda.ctc_plan
// mirrors it.
extern "C" int ctc_depth(int S) { return depth_for(S); }

// Shared memory of either kernel at S and depth (ops/ctc_cuda.ctc_plan).
extern "C" long long ctc_smem_bytes(int S, int depth) { return smem_bytes(S, depth); }

// Launches the alpha recursion over B rows on `stream`; returns the first
// CUDA error (cudaErrorInvalidValue for an S that ctc_depth refuses).
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
