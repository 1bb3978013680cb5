// The bf16 matrix product of kernels 1 and 3 (csrc/gemm_wgmma.cu): wgmma
// fed by TMA.  Declarations only; the kernel and its instances live in
// gemm_wgmma.cu, linked into the same library.

#pragma once

#include <cuda_runtime.h>

// C[z] = sum over k in slice z of A(m,k) B(k,n) (+ bias[n] when bias is not
// null), bf16 operands, float32 sums.  A is a row-major bf16 array with row
// stride lda elements: A(m,k) = A[m*lda + k] (a_mn false: [M, K]) or
// A[k*lda + m] (a_mn true: [K, M]).  B likewise: B(k,n) = B[(k+b_k0)*ldb + n]
// (b_mn true) or B[n*ldb + k + b_k0] (b_mn false); b_k0 shifts B's k
// coordinate (rows of B before it are never read).  C is [M, N] float32, or
// bf16 when c_bf16; with splits > 1 (float32 only) C holds the [splits, M, N]
// partials of k-slices gemm_kslice(K, splits) deep.  Each operand's base
// must be 16-byte aligned and its row stride a multiple of 8 elements (the
// tensor maps' rule): pad_bf16 makes such a copy of one that is not.
cudaError_t gemm_bf16_run(const void* A, bool a_mn, int lda, const void* B, bool b_mn, int ldb,
                          int b_k0, void* C, bool c_bf16, const float* bias, int M, int N, int K,
                          int splits, cudaStream_t st);

// k per slice of a product split `splits` ways: whole 64-deep k-tiles
// (mirrored by ops/lstm_cuda.py gemm_plan)
int gemm_kslice(int K, int splits);

// dst [rows, ld8] bf16 = src [rows, cols] (row stride ld, float32 when
// src_f32 else bf16) rounded to bf16, zero in columns [cols, ld8) where
// ld8 is cols rounded up to 8: an operand the tensor maps can take.
cudaError_t pad_bf16(const void* src, bool src_f32, long long rows, int cols, long long ld,
                     void* dst, cudaStream_t st);

// cols rounded up to whole 16-byte rows of bf16
inline int pad8(int cols) { return (cols + 7) / 8 * 8; }
