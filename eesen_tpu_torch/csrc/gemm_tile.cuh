// The float32 tiled matrix product shared by the LSTM kernels on their f32
// path (csrc/lstm_fwd.cu: the input projection x.W_x + b; csrc/lstm_bwd.cu:
// dW_x, dW_m and dx); the bf16 path runs gemm_bf16_run (csrc/gemm_wgmma.cu).
//
// C[z] = sum over k in slice z of A(m,k) B(k,n) (+ bias[n] when BIAS), with
// A(m,k) = A[m*sam + k*sak] and B(k,n) = Bm[k*sbk + n*sbn], on the FMA units
// in float32 (no TF32: the tight card/CPU parity tests run this path).  It
// stages its tiles through registers one element a thread.  The bias is a
// template flag, not a null test, as it costs registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int BM = 64, BN = 64, BK = 16;

// 256 threads, each a 4x4 block of outputs strided by 16.
template <typename TA, typename TB, typename TC, bool BIAS>
__global__ void __launch_bounds__(256)
    gemm_kernel(const TA* __restrict__ A, long long sam, long long sak, const TB* __restrict__ Bm,
                long long sbk, long long sbn, TC* __restrict__ C, const float* __restrict__ bias,
                int M, int N, int K, int kslice) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kb = blockIdx.z * kslice;
  const int ke = min(K, kb + kslice);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int kt = kb; kt < ke; kt += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * 256;
      // walk the unit-stride dimension with consecutive threads
      const int mm = sam == 1 ? e % BM : e / BK;
      const int kk = sam == 1 ? e / BM : e % BK;
      const int gm = m0 + mm, gk = kt + kk;
      As[kk][mm] = gm < M && gk < ke ? to_f(A[gm * sam + gk * sak]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * 256;
      const int nn = sbn == 1 ? e % BN : e / BK;
      const int kk = sbn == 1 ? e / BN : e % BK;
      const int gn = n0 + nn, gk = kt + kk;
      Bs[kk][nn] = gn < N && gk < ke ? to_f(Bm[gk * sbk + gn * sbn]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
  TC* Cz = C + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < M && n < N)
        Cz[(size_t)m * N + n] = from_f<TC>(BIAS ? acc[i][j] + bias[n] : acc[i][j]);
    }
}

// k per slice: a multiple of the k depth BK
inline int k_slice(int K, int splits) { return ((K + splits - 1) / splits + BK - 1) / BK * BK; }

// The product C[z] = A.B (+ bias when BIAS) over k-slice z on the FMA units
// in float32 (the bf16 path's products are gemm_bf16_run, csrc/gemm_wgmma.cu).
template <typename TA, typename TB, typename TC, bool BIAS = false>
cudaError_t gemm(const void* A, long long sam, long long sak, const void* Bm, long long sbk,
                 long long sbn, void* C, const float* bias, int M, int N, int K, int splits,
                 cudaStream_t st) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
  gemm_kernel<TA, TB, TC, BIAS><<<grid, 256, 0, st>>>(
      static_cast<const TA*>(A), sam, sak, static_cast<const TB*>(Bm), sbk, sbn,
      static_cast<TC*>(C), bias, M, N, K, k_slice(K, splits));
  return cudaGetLastError();
}

}  // namespace
