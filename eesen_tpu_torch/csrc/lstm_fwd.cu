// Fused LSTM direction forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_fwd_kernel` (eesen_tpu/ops/lstm_pallas.py:323)
// and computes what it computes (lstm_pallas.py:345-376): the input
// projection x.W_x + b inside the kernel, then per step m.W_m, the GIFO gates
// with the i/f/o peepholes, and the length-mask freeze of the carried state.
// Zero initial state; the c and m carries and every sum are float32.
//
// Layout: x [T,B,D] (bf16 or f32), mask [T,B] f32, W_x [D,4H] and W_m [H,4H]
// in the type of x, bias [4H] f32, peepholes [3,H] f32 (i, f, o).  Outputs:
// m carry [T,B,H] (bf16 when state_bf16, else f32) and, when the pointers are
// not null, the c carry [T,B,H] (same type) and the post-activation gates
// [T,B,4H] in the type of x (g, i, f, o) that the backward pass reads: bf16
// on the bf16 path, as on the TPU; float32 on the f32 path, so that f32
// training keeps f32 residuals.
//
// Design.  One thread block per group of RB batch rows; a loop over t inside
// the block replaces the TPU's sequential grid.  Thread (s, h) owns hidden
// unit h, i.e. the four gate columns {g*H+h}, for every row of the group, and
// sums a contiguous 1/S slice of the D+H input rows of [W_x; W_m] (split-K, so
// that S*H threads keep the SM busy).  Each weight element is read once per
// step per block, coalesced across h.  The partial sums meet in shared memory;
// after a barrier the gate math, the mask freeze and the writes are spread
// over all threads.  The c/m carries and the step's operand vector
// [x_t ; m_{t-1} rounded to the compute type] live in shared memory.
//
// Bound.  Per direction-layer the work is 2*B*T*(D+H)*4H FLOP: at B=8, T=512,
// H=320 that is 4.6 GFLOP for D=120 and 10.1 GFLOP for D=640, i.e. ~5 us and
// ~10 us at the H100's 989 TFLOP/s (bf16).  The real floor is the T-step
// serial chain: each step must stream W_x and W_m (2.4 MB in bf16 at D=640)
// from L2 into a single SM, since W_m (800 KiB) does not fit one SM's shared
// memory.  At B=8 only ceil(B/RB) blocks run, so the card is mostly idle;
// splitting the columns over a thread-block cluster (DSMEM) is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float sigm(float v) { return 1.0f / (1.0f + expf(-v)); }

// at most 64 registers a thread, so that 1024 threads fit one SM's 64K
template <typename TIn, typename TState, int RB>
__global__ void __launch_bounds__(1024) lstm_fwd_kernel(const TIn* __restrict__ x, const float* __restrict__ mask,
                                const TIn* __restrict__ wx, const float* __restrict__ bias,
                                const TIn* __restrict__ wm, const float* __restrict__ ph,
                                TState* __restrict__ m_out, TState* __restrict__ c_out,
                                TIn* __restrict__ gates_out, int T, int B, int D,
                                int H, int S) {
  extern __shared__ float smem[];
  const int K = D + H;            // rows of [W_x; W_m]
  const int G = 4 * H;            // gate columns
  float* vs = smem;               // [RB][K] operand: x_t then rounded m_{t-1}
  float* ms = vs + RB * K;        // [RB][H] m carry (f32)
  float* cs = ms + RB * H;        // [RB][H] c carry (f32)
  float* part = cs + RB * H;      // [S][RB][G] split-K partial sums

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int h = tid % H;
  const int s = tid / H;
  const int b0 = blockIdx.x * RB;
  const int nr = min(RB, B - b0);
  const int chunk = (K + S - 1) / S;
  const int k0 = s * chunk;
  const int k1 = min(K, k0 + chunk);

  for (int e = tid; e < RB * K; e += nthr) vs[e] = 0.0f;
  for (int e = tid; e < RB * H; e += nthr) {
    ms[e] = 0.0f;
    cs[e] = 0.0f;
  }
  __syncthreads();
  for (int e = tid; e < nr * D; e += nthr) {
    const int r = e / D, d = e % D;
    vs[r * K + d] = to_f(x[(size_t)(b0 + r) * D + d]);
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    float acc[RB][4];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;

    const int kx1 = min(k1, D);
    for (int k = k0; k < kx1; ++k) {
      const TIn* w = wx + (size_t)k * G + h;
      const float w0 = to_f(w[0]), w1 = to_f(w[H]), w2 = to_f(w[2 * H]), w3 = to_f(w[3 * H]);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float v = vs[r * K + k];
        acc[r][0] += v * w0;
        acc[r][1] += v * w1;
        acc[r][2] += v * w2;
        acc[r][3] += v * w3;
      }
    }
    for (int k = max(k0, D); k < k1; ++k) {
      const TIn* w = wm + (size_t)(k - D) * G + h;
      const float w0 = to_f(w[0]), w1 = to_f(w[H]), w2 = to_f(w[2 * H]), w3 = to_f(w[3 * H]);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float v = vs[r * K + k];
        acc[r][0] += v * w0;
        acc[r][1] += v * w1;
        acc[r][2] += v * w2;
        acc[r][3] += v * w3;
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int g = 0; g < 4; ++g) part[((size_t)s * RB + r) * G + g * H + h] = acc[r][g];
    __syncthreads();

    // gate math, mask freeze and outputs for every (row, unit) of the group
    for (int e = tid; e < nr * H; e += nthr) {
      const int r = e / H, u = e % H;
      float pre[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float a = bias[g * H + u];
        for (int q = 0; q < S; ++q) a += part[((size_t)q * RB + r) * G + g * H + u];
        pre[g] = a;
      }
      const float c_prev = cs[r * H + u];
      const float m_prev = ms[r * H + u];
      const float gg = tanhf(pre[0]);
      const float ig = sigm(pre[1] + c_prev * ph[u]);
      const float fg = sigm(pre[2] + c_prev * ph[H + u]);
      const float c_raw = fg * c_prev + ig * gg;
      const float og = sigm(pre[3] + c_raw * ph[2 * H + u]);
      const float m_raw = og * tanhf(c_raw);
      const size_t row = (size_t)t * B + b0 + r;
      const float mt = mask[row];
      const float c_new = c_raw * mt + c_prev * (1.0f - mt);
      const float m_new = m_raw * mt + m_prev * (1.0f - mt);
      cs[r * H + u] = c_new;
      ms[r * H + u] = m_new;
      vs[r * K + D + u] = round_to<TIn>(m_new);
      m_out[row * H + u] = from_f<TState>(m_new);
      if (c_out != nullptr) c_out[row * H + u] = from_f<TState>(c_new);
      if (gates_out != nullptr) {
        TIn* gp = gates_out + row * G;
        gp[u] = from_f<TIn>(gg);
        gp[H + u] = from_f<TIn>(ig);
        gp[2 * H + u] = from_f<TIn>(fg);
        gp[3 * H + u] = from_f<TIn>(og);
      }
    }
    // the next step's inputs: the x part of the operand is not read above
    if (t + 1 < T) {
      for (int e = tid; e < nr * D; e += nthr) {
        const int r = e / D, d = e % D;
        vs[r * K + d] = to_f(x[((size_t)(t + 1) * B + b0 + r) * D + d]);
      }
    }
    __syncthreads();
  }
}

template <typename TIn, typename TState, int RB>
cudaError_t launch(const void* x, const void* mask, const void* wx, const void* bias,
                   const void* wm, const void* ph, void* m_out, void* c_out, void* gates_out,
                   int T, int B, int D, int H, int S, size_t smem, cudaStream_t stream) {
  auto kern = lstm_fwd_kernel<TIn, TState, RB>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (B + RB - 1) / RB;
  kern<<<grid, S * H, smem, stream>>>(
      static_cast<const TIn*>(x), static_cast<const float*>(mask), static_cast<const TIn*>(wx),
      static_cast<const float*>(bias), static_cast<const TIn*>(wm),
      static_cast<const float*>(ph), static_cast<TState*>(m_out), static_cast<TState*>(c_out),
      static_cast<TIn*>(gates_out), T, B, D, H, S);
  return cudaGetLastError();
}

template <typename TIn, typename TState>
cudaError_t dispatch_rb(int rb, const void* x, const void* mask, const void* wx,
                        const void* bias, const void* wm, const void* ph, void* m_out,
                        void* c_out, void* gates_out, int T, int B, int D, int H, int S,
                        size_t smem, cudaStream_t stream) {
  switch (rb) {
    case 1: return launch<TIn, TState, 1>(x, mask, wx, bias, wm, ph, m_out, c_out, gates_out, T, B, D, H, S, smem, stream);
    case 2: return launch<TIn, TState, 2>(x, mask, wx, bias, wm, ph, m_out, c_out, gates_out, T, B, D, H, S, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory the kernel needs for these sizes, in bytes.
extern "C" long long lstm_fwd_smem_bytes(int D, int H, int rows_per_block, int split) {
  const long long rb = rows_per_block;
  return 4LL * (rb * (D + H) + 2 * rb * H + (long long)split * rb * 4 * H);
}

// Launches one LSTM direction on `stream`; returns cudaGetLastError().
// in_bf16: x/W_x/W_m are bf16 (else f32).  state_bf16: m/c outputs bf16.
// c_out and gates_out may be null.  split*H <= 1024, rows_per_block in
// {1,2}: two rows a block ran fastest of {1,2,4,8} at the flagship shapes
// on an H100 (the weight stream from L2 is paid per block, the FMAs per
// row).
extern "C" int lstm_fwd(const void* x, const void* mask, const void* wx, const void* bias,
                        const void* wm, const void* ph, void* m_out, void* c_out,
                        void* gates_out, int T, int B, int D, int H, int in_bf16,
                        int state_bf16, int rows_per_block, int split, void* stream) {
  const size_t smem = (size_t)lstm_fwd_smem_bytes(D, H, rows_per_block, split);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_bf16) {
    err = state_bf16
              ? dispatch_rb<__nv_bfloat16, __nv_bfloat16>(rows_per_block, x, mask, wx, bias, wm, ph, m_out, c_out, gates_out, T, B, D, H, split, smem, st)
              : dispatch_rb<__nv_bfloat16, float>(rows_per_block, x, mask, wx, bias, wm, ph, m_out, c_out, gates_out, T, B, D, H, split, smem, st);
  } else {
    err = state_bf16
              ? dispatch_rb<float, __nv_bfloat16>(rows_per_block, x, mask, wx, bias, wm, ph, m_out, c_out, gates_out, T, B, D, H, split, smem, st)
              : dispatch_rb<float, float>(rows_per_block, x, mask, wx, bias, wm, ph, m_out, c_out, gates_out, T, B, D, H, split, smem, st);
  }
  return (int)err;
}
