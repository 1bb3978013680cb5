// v1 LSTM recurrence backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` (eesen_tpu/ops/lstm_pallas.py:94) and
// computes what it computes (lstm_pallas.py:111-156): the reverse recurrence
// over the forward kernel's residuals (csrc/lstm_scan_fwd.cu) and the
// cotangent gm of the m carry, emitting per step the pre-activation gate
// gradients dgifo (g, i, f, o; peepholes included) as dxw, in float32,
// unrounded.  dm and dc are carried in float32 and pass through padded steps
// (mask 0) unchanged; dm_{t-1} = bf16(dgifo_t).W_m^T with bf16 W_m and f32
// sums.  The weight and peephole gradients are not made here: the caller
// computes them from dxw as one-shot products (lstm_pallas.py:281-293).
//
// Layout: mask [T,B] f32, gates [T,B,4H] bf16, c_raw, the c carry and gm
// [T,B,H] f32 (c_prev at step t is the c carry at t-1, zero at t=0), W_m^T
// [4H,H] bf16 made contiguous by the caller (reads coalesced across units),
// ph [3,H] f32.  Output: dxw [T,B,4H] f32.
//
// Design.  This is kernel 5's design for cells wider than its cluster
// design takes (csrc/lstm_bwd.cu's lstm_bwd_rec_kernel, V1 instance,
// H <= 1664; the host chooses, ops/lstm_v1_cuda.py bwd_launch): it takes H
// up to 5811, where its shared memory ends.  One block per RB batch rows
// and a loop over t from T-1 down to 0.
// Thread j owns hidden units j, j + threads, ... in both phases of a step:
// (a) the elementwise gradients of its units, which write dxw and the bf16
// dgifo row into shared memory; a barrier; (b) its units' share of the next
// dm, the sum over the 4H gate rows of dgifo.W_m^T.  The next step's (a)
// reads only its own units' dm and dc, so the dgifo rows are double-buffered
// and a step needs one barrier.
//
// Bound.  Per row-step the kernel must move 36*H bytes (gates 8H, c_raw, c and
// gm 12H in, dxw 16H out): 2.26 GB at B=128, T=768, H=640, 0.68 ms at
// 3.35 TB/s; the product is 8*H*H FLOP per row-step.  As in the forward, the
// floor in practice is the T-step serial chain with W_m^T streamed from L2
// into every block each step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <int RB>
__global__ void __launch_bounds__(1024)
    lstm_scan_bwd_kernel(const float* __restrict__ mask, const __nv_bfloat16* __restrict__ gates,
                         const float* __restrict__ craw, const float* __restrict__ c,
                         const float* __restrict__ gm, const __nv_bfloat16* __restrict__ wmT,
                         const float* __restrict__ ph, float* __restrict__ dxw, int T, int B,
                         int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* dg = smem;               // [2][RB][G] bf16(dgifo), double-buffered
  float* dms = dg + 2 * RB * G;   // [RB][H] dm carry
  float* dcs = dms + RB * H;      // [RB][H] dc carry

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int b0 = blockIdx.x * RB;
  const int nr = min(RB, B - b0);

  for (int e = tid; e < RB * (2 * G + 2 * H); e += nthr) smem[e] = 0.0f;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    float* dgc = dg + (t & 1) * RB * G;
    // (a) this step's gate gradients for the units this thread owns
    for (int u = tid; u < H; u += nthr) {
      for (int r = 0; r < nr; ++r) {
        const size_t row = (size_t)t * B + b0 + r;
        const __nv_bfloat16* gp = gates + row * G;
        const float gg = __bfloat162float(gp[u]), ig = __bfloat162float(gp[H + u]);
        const float fg = __bfloat162float(gp[2 * H + u]), og = __bfloat162float(gp[3 * H + u]);
        const float c_raw = craw[row * H + u];
        const float c_prev = t > 0 ? c[(row - B) * H + u] : 0.0f;
        const float mt = mask[row];
        const float tanh_c = tanhf(c_raw);

        const float dm_total = gm[row * H + u] + dms[r * H + u];
        const float dm_raw = dm_total * mt;
        const float dc_in = dcs[r * H + u];
        float dc_raw = dc_in * mt;
        const float do_ = dm_raw * tanh_c;
        dc_raw = dc_raw + dm_raw * og * (1.0f - tanh_c * tanh_c);
        const float do_pre = do_ * og * (1.0f - og);
        dc_raw = dc_raw + do_pre * ph[2 * H + u];
        const float di_pre = dc_raw * gg * ig * (1.0f - ig);
        const float df_pre = dc_raw * c_prev * fg * (1.0f - fg);
        const float dg_pre = dc_raw * ig * (1.0f - gg * gg);
        dcs[r * H + u] =
            dc_raw * fg + di_pre * ph[u] + df_pre * ph[H + u] + dc_in * (1.0f - mt);
        // the pass-through part of dm_{t-1}; (b) adds dgifo.W_m^T
        dms[r * H + u] = dm_total * (1.0f - mt);

        float* out = dxw + row * G;
        float* d = dgc + r * G;
        out[u] = dg_pre;
        out[H + u] = di_pre;
        out[2 * H + u] = df_pre;
        out[3 * H + u] = do_pre;
        d[u] = round_bf16(dg_pre);
        d[H + u] = round_bf16(di_pre);
        d[2 * H + u] = round_bf16(df_pre);
        d[3 * H + u] = round_bf16(do_pre);
      }
    }
    __syncthreads();
    // (b) dm_{t-1} = dgifo_t . W_m^T for the units this thread owns
    if (t > 0) {
      for (int u = tid; u < H; u += nthr) {
        float sum[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) sum[r] = 0.0f;
#pragma unroll 4
        for (int k = 0; k < G; ++k) {
          const float w = __bfloat162float(wmT[(size_t)k * H + u]);
#pragma unroll
          for (int r = 0; r < RB; ++r) sum[r] += dgc[r * G + k] * w;
        }
#pragma unroll
        for (int r = 0; r < RB; ++r)
          if (r < nr) dms[r * H + u] = sum[r] + dms[r * H + u];
      }
    }
    // no barrier: the next step's (a) writes the other dgifo buffer and
    // reads only this thread's own units of dms and dcs
  }
}

template <int RB>
cudaError_t launch(const void* mask, const void* gates, const void* craw, const void* c,
                   const void* gm, const void* wmT, const void* ph, void* dxw, int T, int B,
                   int H, int threads, size_t smem, cudaStream_t st) {
  auto kern = lstm_scan_bwd_kernel<RB>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<(B + RB - 1) / RB, threads, smem, st>>>(
      static_cast<const float*>(mask), static_cast<const __nv_bfloat16*>(gates),
      static_cast<const float*>(craw), static_cast<const float*>(c),
      static_cast<const float*>(gm), static_cast<const __nv_bfloat16*>(wmT),
      static_cast<const float*>(ph), static_cast<float*>(dxw), T, B, H);
  return cudaGetLastError();
}

}  // namespace

// Shared memory the kernel needs for these sizes, in bytes.
extern "C" long long lstm_scan_bwd_smem_bytes(int H, int rows_per_block) {
  return 40LL * rows_per_block * H;
}

// Runs the v1 recurrence backward on `stream`; returns cudaGetLastError().
// rows_per_block in {1,2}; threads <= 1024, a multiple of 32.
extern "C" int lstm_scan_bwd(const void* mask, const void* gates, const void* craw,
                             const void* c, const void* gm, const void* wmT, const void* ph,
                             void* dxw, int T, int B, int H, int rows_per_block, int threads,
                             void* stream) {
  const size_t smem = (size_t)lstm_scan_bwd_smem_bytes(H, rows_per_block);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows_per_block) {
    case 1: return (int)launch<1>(mask, gates, craw, c, gm, wmT, ph, dxw, T, B, H, threads, smem, st);
    case 2: return (int)launch<2>(mask, gates, craw, c, gm, wmT, ph, dxw, T, B, H, threads, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
