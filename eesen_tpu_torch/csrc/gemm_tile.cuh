// Tiled matrix products shared by the LSTM kernels (csrc/lstm_fwd.cu: the
// input projection x.W_x + b; csrc/lstm_bwd.cu: dW_x, dW_m and dx).
//
// C[z] = sum over k in slice z of A(m,k) B(k,n) (+ bias[n] when BIAS), with
// A(m,k) = A[m*sam + k*sak] and B(k,n) = Bm[k*sbk + n*sbn]:
//   - gemm_kernel on the FMA units in float32 (the f32 path; no TF32);
//   - gemm_tc_kernel on the tensor cores (wmma bf16 16x16x16 fragments,
//     float32 accumulators) for the bf16 path.
// Each stages its tiles through registers one element a thread, with no
// copy/compute overlap (TMA and wgmma pipelines are later work).  The bias
// is a template flag, not a null test: a bias pointer tested at run time
// took gemm_tc_kernel from 64 to 80 registers (8 to 6 blocks an SM) and
// made kernel 3's weight-gradient products 55% slower at H=640 on the H100.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

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

// The same product on the tensor cores, for bf16 operands: 64x64 tiles,
// 32-deep k slices staged in shared memory as bf16 (operands of another type
// are rounded on the way in), four warps of 2x2 wmma 16x16x16 fragments
// with float32 accumulators.  A_COL: A's unit stride runs along m (the tile
// is kept k-major, a column-major fragment); B_ROW: B's runs along n.
constexpr int TM = 64, TN = 64, TK = 32, PAD = 8;

template <typename TA, typename TB, typename TC, bool A_COL, bool B_ROW, bool BIAS>
__global__ void __launch_bounds__(128)
    gemm_tc_kernel(const TA* __restrict__ A, long long sam, long long sak,
                   const TB* __restrict__ Bm, long long sbk, long long sbn, TC* __restrict__ C,
                   const float* __restrict__ bias, int M, int N, int K, int kslice) {
  using namespace nvcuda;
  constexpr int LDA = A_COL ? TM + PAD : TK + PAD;
  constexpr int LDB = B_ROW ? TN + PAD : TK + PAD;
  constexpr int LDC = TN + 4;
  __shared__ __align__(32) __nv_bfloat16 As[A_COL ? TK * LDA : TM * LDA];
  __shared__ __align__(32) __nv_bfloat16 Bs[B_ROW ? TK * LDB : TN * LDB];
  __shared__ __align__(32) float Cs[TM * LDC];
  using LayA = typename std::conditional<A_COL, wmma::col_major, wmma::row_major>::type;
  using LayB = typename std::conditional<B_ROW, wmma::row_major, wmma::col_major>::type;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wy = warp / 2, wx = warp % 2;  // this warp's 32x32 quarter
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  const int kb = blockIdx.z * kslice;
  const int ke = min(K, kb + kslice);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int kt = kb; kt < ke; kt += TK) {
    // consecutive threads walk each operand's unit-stride dimension
#pragma unroll 4
    for (int e = tid; e < TM * TK; e += 128) {
      const int mm = A_COL ? e % TM : e / TK;
      const int kk = A_COL ? e / TM : e % TK;
      const int gm = m0 + mm, gk = kt + kk;
      const float v = gm < M && gk < ke ? to_f(A[gm * sam + gk * sak]) : 0.0f;
      As[A_COL ? kk * LDA + mm : mm * LDA + kk] = __float2bfloat16(v);
    }
#pragma unroll 4
    for (int e = tid; e < TK * TN; e += 128) {
      const int nn = B_ROW ? e % TN : e / TK;
      const int kk = B_ROW ? e / TN : e % TK;
      const int gn = n0 + nn, gk = kt + kk;
      const float v = gn < N && gk < ke ? to_f(Bm[gk * sbk + gn * sbn]) : 0.0f;
      Bs[B_ROW ? kk * LDB + nn : nn * LDB + kk] = __float2bfloat16(v);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LayA> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LayB> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = wy * 32 + i * 16;
        wmma::load_matrix_sync(fa[i], A_COL ? As + kk * LDA + m : As + m * LDA + kk, LDA);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = wx * 32 + j * 16;
        wmma::load_matrix_sync(fb[j], B_ROW ? Bs + kk * LDB + n : Bs + n * LDB + kk, LDB);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wy * 32 + i * 16) * LDC + wx * 32 + j * 16, acc[i][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();
  TC* Cz = C + (size_t)blockIdx.z * M * N;
  for (int e = tid; e < TM * TN; e += 128) {
    const int m = m0 + e / TN, n = n0 + e % TN;
    if (m < M && n < N) {
      const float v = Cs[(e / TN) * LDC + e % TN];
      Cz[(size_t)m * N + n] = from_f<TC>(BIAS ? v + bias[n] : v);
    }
  }
}

// k per slice: a multiple of both kernels' k depth (16 and 32)
inline int k_slice(int K, int splits) { return ((K + splits - 1) / splits + TK - 1) / TK * TK; }

// The product C[z] = A.B (+ bias when BIAS) over k-slice z: on the tensor
// cores when TR (the compute type) is bf16, on the FMA units in float32
// otherwise.  A_COL: sam == 1 (else sak == 1); B_ROW: sbn == 1 (else sbk == 1).
template <typename TA, typename TB, typename TC, typename TR, bool A_COL, bool B_ROW,
          bool BIAS = false>
cudaError_t gemm(const void* A, long long sam, long long sak, const void* Bm, long long sbk,
                 long long sbn, void* C, const float* bias, int M, int N, int K, int splits,
                 cudaStream_t st) {
  const int kslice = k_slice(K, splits);
  if constexpr (std::is_same<TR, __nv_bfloat16>::value) {
    const dim3 grid((M + TM - 1) / TM, (N + TN - 1) / TN, splits);
    gemm_tc_kernel<TA, TB, TC, A_COL, B_ROW, BIAS><<<grid, 128, 0, st>>>(
        static_cast<const TA*>(A), sam, sak, static_cast<const TB*>(Bm), sbk, sbn,
        static_cast<TC*>(C), bias, M, N, K, kslice);
  } else {
    const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
    gemm_kernel<TA, TB, TC, BIAS><<<grid, 256, 0, st>>>(
        static_cast<const TA*>(A), sam, sak, static_cast<const TB*>(Bm), sbk, sbn,
        static_cast<TC*>(C), bias, M, N, K, kslice);
  }
  return cudaGetLastError();
}

}  // namespace
