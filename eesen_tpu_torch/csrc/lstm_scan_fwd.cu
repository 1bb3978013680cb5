// v1 LSTM recurrence forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` (eesen_tpu/ops/lstm_pallas.py:50) and
// computes what it computes (lstm_pallas.py:70-91): over a precomputed input
// projection xw (= x.W_x + b), per step gifo = xw_t + bf16(m_{t-1}).W_m with
// float32 sums, the GIFO gates with the i/f/o peepholes, and the length-mask
// freeze of the carried c and m.  Zero initial state; carries and sums f32.
//
// Layout: xw [T,B,4H] f32, mask [T,B] f32, W_m [H,4H] bf16, ph [3,H] f32
// (i, f, o).  Outputs: m carry, c carry and c_raw (the cell before the mask
// freeze) [T,B,H] f32, and the post-activation gates [T,B,4H] bf16 (g, i, f,
// o), the residuals of the backward kernel (csrc/lstm_scan_bwd.cu).
//
// Design.  This is kernel 4's design for cells wider than its cluster
// design takes (csrc/lstm_fwd.cu's lstm_rec_kernel, H <= 2624; the host
// chooses, ops/lstm_v1_cuda.py fwd_launch): it takes H up to 14528, where
// its shared memory ends.  One block per RB batch rows and a loop over t inside
// the block (the TPU's sequential grid).  Thread j owns hidden units j,
// j + threads, ... (several when H > 1024): for each it sums the H rows of
// W_m for its four gate columns (reads coalesced across units), then does
// that unit's gate math, freeze and writes at once, so a step needs one
// barrier.  The recurrent operand bf16(m) is double-buffered in shared
// memory (read from one buffer, written to the other); the f32 carries sit in
// shared memory, each element touched only by the thread that owns its unit.
//
// Bound.  Per row-step the kernel must move 36*H bytes (xw 16H in, m, c,
// c_raw 12H and gates 8H out): 2.26 GB at B=128, T=768, H=640, 0.68 ms at
// 3.35 TB/s; the products are 8*H*H FLOP per row-step (0.33 ms at bf16 peak).
// The real floor is the T-step serial chain: W_m (3.3 MB in bf16 at H=640)
// cannot stay in one SM, so every block streams it from L2 every step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigm(float v) { return 1.0f / (1.0f + expf(-v)); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <int RB>
__global__ void __launch_bounds__(1024)
    lstm_scan_fwd_kernel(const float* __restrict__ xw, const float* __restrict__ mask,
                         const __nv_bfloat16* __restrict__ wm, const float* __restrict__ ph,
                         float* __restrict__ m_out, float* __restrict__ c_out,
                         float* __restrict__ craw_out, __nv_bfloat16* __restrict__ gates_out,
                         int T, int B, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* vs = smem;              // [2][RB][H] bf16(m carry), double-buffered
  float* ms = vs + 2 * RB * H;   // [RB][H] m carry
  float* cs = ms + RB * H;       // [RB][H] c carry

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int b0 = blockIdx.x * RB;
  const int nr = min(RB, B - b0);

  for (int e = tid; e < 4 * RB * H; e += nthr) smem[e] = 0.0f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* vcur = vs + (t & 1) * RB * H;
    float* vnext = vs + ((t + 1) & 1) * RB * H;
    for (int u = tid; u < H; u += nthr) {
      float acc[RB][4];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const __nv_bfloat16* w = wm + (size_t)k * G + u;
        const float w0 = __bfloat162float(w[0]), w1 = __bfloat162float(w[H]);
        const float w2 = __bfloat162float(w[2 * H]), w3 = __bfloat162float(w[3 * H]);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float v = vcur[r * H + k];
          acc[r][0] += v * w0;
          acc[r][1] += v * w1;
          acc[r][2] += v * w2;
          acc[r][3] += v * w3;
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r >= nr) break;
        const size_t row = (size_t)t * B + b0 + r;
        const float* x = xw + row * G;
        const float c_prev = cs[r * H + u];
        const float m_prev = ms[r * H + u];
        const float gg = tanhf(x[u] + acc[r][0]);
        const float ig = sigm(x[H + u] + acc[r][1] + c_prev * ph[u]);
        const float fg = sigm(x[2 * H + u] + acc[r][2] + c_prev * ph[H + u]);
        const float c_raw = fg * c_prev + ig * gg;
        const float og = sigm(x[3 * H + u] + acc[r][3] + c_raw * ph[2 * H + u]);
        const float m_raw = og * tanhf(c_raw);
        const float mt = mask[row];
        const float c_new = c_raw * mt + c_prev * (1.0f - mt);
        const float m_new = m_raw * mt + m_prev * (1.0f - mt);
        cs[r * H + u] = c_new;
        ms[r * H + u] = m_new;
        vnext[r * H + u] = round_bf16(m_new);
        m_out[row * H + u] = m_new;
        c_out[row * H + u] = c_new;
        craw_out[row * H + u] = c_raw;
        __nv_bfloat16* gp = gates_out + row * G;
        gp[u] = __float2bfloat16(gg);
        gp[H + u] = __float2bfloat16(ig);
        gp[2 * H + u] = __float2bfloat16(fg);
        gp[3 * H + u] = __float2bfloat16(og);
      }
    }
    // step t+1 reads vnext, written above by every thread; the next write
    // to vcur comes only after this barrier
    __syncthreads();
  }
}

template <int RB>
cudaError_t launch(const void* xw, const void* mask, const void* wm, const void* ph, void* m,
                   void* c, void* craw, void* gates, int T, int B, int H, int threads,
                   size_t smem, cudaStream_t st) {
  auto kern = lstm_scan_fwd_kernel<RB>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<(B + RB - 1) / RB, threads, smem, st>>>(
      static_cast<const float*>(xw), static_cast<const float*>(mask),
      static_cast<const __nv_bfloat16*>(wm), static_cast<const float*>(ph),
      static_cast<float*>(m), static_cast<float*>(c), static_cast<float*>(craw),
      static_cast<__nv_bfloat16*>(gates), T, B, H);
  return cudaGetLastError();
}

}  // namespace

// Shared memory the kernel needs for these sizes, in bytes.
extern "C" long long lstm_scan_fwd_smem_bytes(int H, int rows_per_block) {
  return 16LL * rows_per_block * H;
}

// Runs the v1 recurrence forward on `stream`; returns cudaGetLastError().
// rows_per_block in {1,2}; threads <= 1024, a multiple of 32 (each thread
// owns ceil(H / threads) hidden units).
extern "C" int lstm_scan_fwd(const void* xw, const void* mask, const void* wm, const void* ph,
                             void* m, void* c, void* craw, void* gates, int T, int B, int H,
                             int rows_per_block, int threads, void* stream) {
  const size_t smem = (size_t)lstm_scan_fwd_smem_bytes(H, rows_per_block);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows_per_block) {
    case 1: return (int)launch<1>(xw, mask, wm, ph, m, c, craw, gates, T, B, H, threads, smem, st);
    case 2: return (int)launch<2>(xw, mask, wm, ph, m, c, craw, gates, T, B, H, threads, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
