// Fused LSTM direction backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_bwd_kernel` (eesen_tpu/ops/lstm_pallas.py:379)
// and computes what it computes (lstm_pallas.py:403-482), from the forward
// kernel's residuals (csrc/lstm_fwd.cu with the c carry and the gates):
//   - the reverse recurrence: c_raw = f*c_prev + i*g recomputed from the
//     stored gates and the stored c carry (zero at t=0); dm and dc carried in
//     float32 and passed through padded steps (mask 0) unchanged; the gate
//     gradients dgifo (g, i, f, o pre-activations, peepholes included);
//     dm_prev = dgifo.W_m^T with dgifo rounded to the compute type;
//   - dx = dgifo.W_x^T (rounded to the compute type), dW_x = x^T.dgifo,
//     dW_m = m_prev^T.dgifo with m_prev the m carry one step back (zero at
//     t=0) rounded to the compute type, all with float32 sums;
//   - db = sum of dgifo and dph = (sum di*c_prev, sum df*c_prev,
//     sum do*c_raw), from the unrounded float32 dgifo.
//
// Layout: x [T,B,D], gates [T,B,4H] and W_x [D,4H] in the compute type
// (bf16 or f32); mask [T,B] f32; the c and m carries and gm (the cotangent
// of the m carry) [T,B,H] in the state type (bf16 under state_bf16, else
// f32); W_m^T [4H,H] in the compute type, made contiguous by the caller;
// ph [3,H] f32.  Outputs: dx [T,B,D] compute type; dW_x [D,4H], dW_m [H,4H]
// and db|dph [7H] f32.  Scratch from the caller: dgifo [T,B,4H] (compute
// type), per-row partial sums [B,7H] and split-K partials of dW_x and dW_m.
//
// Design.  On the TPU one sequential grid carries dm/dc and accumulates dW in
// VMEM; here blocks run in parallel and nothing carries between them, so the
// work is split in two:
//   (a) lstm_bwd_rec_kernel: one block per RB batch rows and a loop over t
//       from T-1 down to 0, shaped like the forward kernel.  Thread (s, h)
//       sums a 1/S slice of the 4H gate rows of W_m^T for unit h (reads
//       coalesced across h); the partial sums meet in shared memory, and the
//       next step's elementwise phase adds them to the dm carry.  It writes
//       dgifo and, per batch row, the partial sums of db and dph.
//   (b) the products dW_x, dW_m and dx as tiled kernels over 64x64 output
//       tiles (csrc/gemm_tile.cuh, shared with the forward kernel's input
//       projection): gemm_tc_kernel on the tensor cores (wmma bf16 16x16x16
//       fragments, float32 accumulators) for the bf16 path, gemm_kernel on
//       the FMA units (float32) for the f32 path.  The two weight gradients
//       are split over k into partial buffers; sum_rows_kernel then adds the
//       partials in a fixed order, so the result is deterministic.
//
// Bound.  At B=128, T=768, H=320 the products are 2*B*T*(2D+H)*4H FLOP: 0.42
// TFLOP at D=640 (0.42 ms at the 989 TFLOP/s bf16 tensor-core rate) and
// 0.14 TFLOP at D=120; dgifo.W_m^T adds 2*B*T*4H*H.  The recurrence (a) is
// bound by its T-step serial chain, each step streaming W_m^T (800 KiB in
// bf16) from L2 into each block's SM.  The tensor-core products stage their
// tiles through registers one element a thread with no copy/compute overlap
// (TMA and wgmma pipelines are the next step).

#include "gemm_tile.cuh"

namespace {

// (a) the reverse recurrence; at most 64 registers a thread (1024 threads)
template <typename TIn, typename TState, int RB>
__global__ void __launch_bounds__(1024)
    lstm_bwd_rec_kernel(const float* __restrict__ mask, const TIn* __restrict__ gates,
                        const TState* __restrict__ c, const TState* __restrict__ gm,
                        const TIn* __restrict__ wmT, const float* __restrict__ ph,
                        TIn* __restrict__ dgifo, float* __restrict__ part_rows, int T, int B,
                        int H, int S) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  const int H7 = 7 * H;
  float* dg = smem;              // [RB][G] this step's dgifo, rounded to TIn
  float* dmp = dg + RB * G;      // [RB][H] dm passed through padded steps
  float* dcs = dmp + RB * H;     // [RB][H] dc carry
  float* acc = dcs + RB * H;     // [RB][7H] sums of dgifo (4H) and dph terms (3H)
  float* part = acc + RB * H7;   // [S][RB][H] split-K partials of dgifo.W_m^T

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int h = tid % H;
  const int s = tid / H;
  const int b0 = blockIdx.x * RB;
  const int nr = min(RB, B - b0);
  const int chunk = (G + S - 1) / S;
  const int k0 = s * chunk;
  const int k1 = min(G, k0 + chunk);

  for (int e = tid; e < RB * (G + 9 * H + S * H); e += nthr) smem[e] = 0.0f;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    for (int e = tid; e < nr * H; e += nthr) {
      const int r = e / H, u = e % H;
      const size_t row = (size_t)t * B + b0 + r;
      float dm_in = 0.0f;
      for (int q = 0; q < S; ++q) dm_in += part[((size_t)q * RB + r) * H + u];
      const float dm_total = to_f(gm[row * H + u]) + (dm_in + dmp[r * H + u]);
      const TIn* gp = gates + row * G;
      const float gg = to_f(gp[u]), ig = to_f(gp[H + u]);
      const float fg = to_f(gp[2 * H + u]), og = to_f(gp[3 * H + u]);
      const float c_prev = t > 0 ? to_f(c[(row - B) * H + u]) : 0.0f;
      const float c_raw = fg * c_prev + ig * gg;
      const float mt = mask[row];
      const float tanh_c = tanhf(c_raw);

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
      dmp[r * H + u] = dm_total * (1.0f - mt);

      const float d4[4] = {dg_pre, di_pre, df_pre, do_pre};
      float* a = acc + r * H7;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const TIn v = from_f<TIn>(d4[g]);
        dgifo[row * G + g * H + u] = v;
        dg[r * G + g * H + u] = to_f(v);
        a[g * H + u] += d4[g];
      }
      a[4 * H + u] += di_pre * c_prev;
      a[5 * H + u] += df_pre * c_prev;
      a[6 * H + u] += do_pre * c_raw;
    }
    __syncthreads();
    if (t > 0) {
      // this step's share of dm_{t-1}: dgifo_t . W_m^T over gate rows [k0, k1)
      float sum[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) sum[r] = 0.0f;
      for (int k = k0; k < k1; ++k) {
        const float w = to_f(wmT[(size_t)k * H + h]);
#pragma unroll
        for (int r = 0; r < RB; ++r) sum[r] += dg[r * G + k] * w;
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) part[((size_t)s * RB + r) * H + h] = sum[r];
    }
    __syncthreads();
  }
  for (int e = tid; e < nr * H7; e += nthr) part_rows[(size_t)b0 * H7 + e] = acc[e];
}

// out[i] = sum over p < P of in[p*N + i], in order of p
__global__ void sum_rows_kernel(const float* __restrict__ in, float* __restrict__ out, int P,
                                long long N) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float s = 0.0f;
  for (int p = 0; p < P; ++p) s += in[p * N + i];
  out[i] = s;
}

cudaError_t sum_rows(const void* in, void* out, int P, long long N, cudaStream_t st) {
  sum_rows_kernel<<<(unsigned)((N + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(in), static_cast<float*>(out), P, N);
  return cudaGetLastError();
}

template <typename TIn, typename TState, int RB>
cudaError_t launch_rec(const void* mask, const void* gates, const void* c, const void* gm,
                       const void* wmT, const void* ph, void* dgifo, void* part_rows, int T,
                       int B, int H, int S, size_t smem, cudaStream_t st) {
  auto kern = lstm_bwd_rec_kernel<TIn, TState, RB>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<(B + RB - 1) / RB, S * H, smem, st>>>(
      static_cast<const float*>(mask), static_cast<const TIn*>(gates),
      static_cast<const TState*>(c), static_cast<const TState*>(gm),
      static_cast<const TIn*>(wmT), static_cast<const float*>(ph), static_cast<TIn*>(dgifo),
      static_cast<float*>(part_rows), T, B, H, S);
  return cudaGetLastError();
}

template <typename TIn, typename TState>
cudaError_t run(const void* x, const void* mask, const void* gates, const void* c, const void* m,
                const void* gm, const void* wx, const void* wmT, const void* ph, void* dx,
                void* dwx, void* dwm, void* dbph, void* dgifo, void* part_rows, void* part_wx,
                void* part_wm, int T, int B, int D, int H, int rb, int S, int zx, int zm,
                size_t smem, cudaStream_t st) {
  const int G = 4 * H;
  const long long TB = (long long)T * B;
  cudaError_t err =
      rb == 2 ? launch_rec<TIn, TState, 2>(mask, gates, c, gm, wmT, ph, dgifo, part_rows, T, B,
                                           H, S, smem, st)
              : launch_rec<TIn, TState, 1>(mask, gates, c, gm, wmT, ph, dgifo, part_rows, T, B,
                                           H, S, smem, st);
  if (err != cudaSuccess) return err;
  if ((err = sum_rows(part_rows, dbph, B, 7LL * H, st)) != cudaSuccess) return err;
  // dW_x = x^T . dgifo: A(d, tb) = x[tb*D + d], B(tb, g) = dgifo[tb*G + g]
  err = gemm<TIn, TIn, float, TIn, true, true>(x, 1, D, dgifo, G, 1, part_wx, nullptr, D, G,
                                               (int)TB, zx, st);
  if (err != cudaSuccess) return err;
  if ((err = sum_rows(part_wx, dwx, zx, (long long)D * G, st)) != cudaSuccess) return err;
  // dW_m = m_prev^T . dgifo: m_prev at step t is the m carry at t-1, so
  // pair m rows [0, T-1) with dgifo rows [1, T)
  const TIn* dg1 = static_cast<const TIn*>(dgifo) + (size_t)B * G;
  err = gemm<TState, TIn, float, TIn, true, true>(m, 1, H, dg1, G, 1, part_wm, nullptr, H, G,
                                                  (int)(TB - B), zm, st);
  if (err != cudaSuccess) return err;
  if ((err = sum_rows(part_wm, dwm, zm, (long long)H * G, st)) != cudaSuccess) return err;
  // dx = dgifo . W_x^T: A(tb, g) = dgifo[tb*G + g], B(g, d) = W_x[d*G + g]
  return gemm<TIn, TIn, TIn, TIn, false, false>(dgifo, G, 1, wx, 1, G, dx, nullptr, (int)TB, D,
                                              G, 1, st);
}

}  // namespace

// Shared memory the recurrence kernel needs for these sizes, in bytes.
extern "C" long long lstm_bwd_smem_bytes(int H, int rows_per_block, int split) {
  return 4LL * rows_per_block * ((long long)13 * H + (long long)split * H);
}

// Runs the backward pass of one LSTM direction on `stream` (the recurrence,
// the per-row sums, the three products and the partial sums, in order);
// returns the first cudaGetLastError() that is not cudaSuccess.  in_bf16:
// x/gates/W_x/W_m^T/dx/dgifo are bf16 (else f32); state_bf16: c/m/gm are
// bf16.  split*H <= 1024, rows_per_block in {1,2}; zx, zm: k-slices of the
// dW_x and dW_m products (part_wx holds zx*D*4H floats, part_wm zm*H*4H).
extern "C" int lstm_bwd(const void* x, const void* mask, const void* gates, const void* c,
                        const void* m, const void* gm, const void* wx, const void* wmT,
                        const void* ph, void* dx, void* dwx, void* dwm, void* dbph, void* dgifo,
                        void* part_rows, void* part_wx, void* part_wm, int T, int B, int D,
                        int H, int in_bf16, int state_bf16, int rows_per_block, int split,
                        int zx, int zm, void* stream) {
  const size_t smem = (size_t)lstm_bwd_smem_bytes(H, rows_per_block, split);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows_per_block != 1 && rows_per_block != 2) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (in_bf16) {
    err = state_bf16
              ? run<__nv_bfloat16, __nv_bfloat16>(x, mask, gates, c, m, gm, wx, wmT, ph, dx, dwx, dwm, dbph, dgifo, part_rows, part_wx, part_wm, T, B, D, H, rows_per_block, split, zx, zm, smem, st)
              : run<__nv_bfloat16, float>(x, mask, gates, c, m, gm, wx, wmT, ph, dx, dwx, dwm, dbph, dgifo, part_rows, part_wx, part_wm, T, B, D, H, rows_per_block, split, zx, zm, smem, st);
  } else {
    err = state_bf16
              ? run<float, __nv_bfloat16>(x, mask, gates, c, m, gm, wx, wmT, ph, dx, dwx, dwm, dbph, dgifo, part_rows, part_wx, part_wm, T, B, D, H, rows_per_block, split, zx, zm, smem, st)
              : run<float, float>(x, mask, gates, c, m, gm, wx, wmT, ph, dx, dwx, dwm, dbph, dgifo, part_rows, part_wx, part_wm, T, B, D, H, rows_per_block, split, zx, zm, smem, st);
  }
  return (int)err;
}
