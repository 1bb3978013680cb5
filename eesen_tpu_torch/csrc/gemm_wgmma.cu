// The bf16 matrix product of kernels 1 and 3 on Hopper's wgmma, fed by TMA
// (sm_90a).
//
// Part of the port of `_fused_fwd_kernel` and `_fused_bwd_kernel`
// (eesen_tpu/ops/lstm_pallas.py:323 and :379): their MXU products, which
// kernels 1 and 3 run over all T*B rows at once, on the bf16 path:
//   kernel 1's projection xw = x.W_x + b   A = x [TB,D] (k contiguous),
//                                          B = W_x [D,4H] (n contiguous)
//   kernel 3's dW_x = x^T.dgifo            A = x (m contiguous), B = dgifo
//   kernel 3's dW_m = m_prev^T.dgifo       A = m rows [0,TB-B) (m
//                                          contiguous), B = dgifo from row B
//   kernel 3's dx = dgifo.W_x^T            A = dgifo (k contiguous),
//                                          B = W_x (k contiguous)
// (gemm_wgmma.cuh gives the contract).  The f32 path keeps gemm_kernel
// (csrc/gemm_tile.cuh, FMA in float32).
//
// Design.  A CTA owns a 128x128 tile of C (one k-slice of it when the
// product is split over k) and walks k in 64-deep steps through a ring of
// STAGES shared-memory stages: warpgroup 0 is the producer, one thread of
// which issues the TMA loads of each step's A and B boxes (128-byte
// swizzle, out-of-bounds boxes zero-filled: the ragged M, N and K edges)
// onto the stage's `full` mbarrier; warpgroups 1 and 2 each run wgmma
// m64n128k16 (bf16 in, float32 accumulators in registers) on their 64 rows
// as the stages land, keep one group in flight, and release a stage on its
// `empty` mbarrier once the group that read it is done.  wgmma reads either
// major order of both operands from shared memory (its transpose bits), so
// every layout above is fed as it lies in memory, with no transpose pass.
// The epilogue adds the bias and stores straight from the registers.
// Split products write [z, M, N] partials that the caller sums in the
// order z = 0..Z-1 (no atomics: the same inputs give the same bits).
//
// Bound.  2*M*N*K FLOP over the bf16 tensor-core rate: at LibriSpeech
// (TB = 98,304, D = 1280, H = 640) kernel 1's projection is 0.64 TFLOP
// (0.65 ms at 989 TFLOP/s) and kernel 3's three products 1.61 TFLOP
// (1.63 ms); their bytes (operands once, C once) take far less.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include "gemm_wgmma.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 4;
constexpr int THREADS = 384;               // producer + two consumer warpgroups
constexpr int BOX = 64;                    // elements in a 128-byte swizzle row
constexpr int HALF = BOX * BK * 2;         // bytes of a 64x64 box
constexpr int TILE = BM * BK * 2;          // bytes of one operand's stage
constexpr int STAGE = 2 * TILE;
constexpr int SMEM = STAGES * STAGE + 1024 + 2 * STAGES * 8;  // + alignment, barriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// one 2D box of `map` at (c0 inner, c1 outer) into shared memory at dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d (64x128 float32, the wgmma fragment) += A (64x16) . B (16x128); TA/TB: the
// operand's m/n dimension is the contiguous one
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

__device__ __forceinline__ void store2(float* p, float a, float b, bool pair) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b, bool pair) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16(a);
  }
}

// Shared memory per stage: A then B, each two 64x64 boxes (8 KB) of 128-byte
// rows.  K-major operand (k contiguous): box (64 k, 128 rows), row r at
// r*128 bytes, so the wgmma atom of 8 rows is 1024 bytes (SBO) and a 16-deep
// k step is 32 bytes along the row.  M/N-major operand: two boxes (64 m or
// n, 64 k) at 0 and 8 KB, row k at k*128 bytes: 8 k rows per 1024 bytes
// (SBO), the two 64-wide m/n chunks 8 KB apart (LBO), a k step 2 KB.  The
// second consumer warpgroup's 64 rows of A start 8 KB in, either way.
template <bool A_MN, bool B_MN, typename TC, bool BIAS>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_bf16_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                     TC* __restrict__ C, const float* __restrict__ bias, int M, int N, int K,
                     int kslice, int b_k0) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle repeats every 1024 bytes
  const uint32_t full = base + STAGES * STAGE, empty = full + STAGES * 8;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, z = blockIdx.z;
  const int k0 = z * kslice;
  const int nk = (min(K, k0 + kslice) - k0 + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // step kt uses stage kt % STAGES for the (kt / STAGES)-th time
  if (wg == 0) {
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        const uint32_t fb = full + 8 * s;
        if (kt >= STAGES) mbar_wait(empty + 8 * s, ((kt / STAGES) + 1) & 1);
        mbar_expect_tx(fb, STAGE);
        const int k = k0 + kt * BK;
        const uint32_t a = base + s * STAGE, b = a + TILE;
        if (A_MN) {
          tma_load(a, &ta, m0, k, fb);
          tma_load(a + HALF, &ta, m0 + BOX, k, fb);
        } else {
          tma_load(a, &ta, k, m0, fb);
        }
        if (B_MN) {
          tma_load(b, &tb, n0, k + b_k0, fb);
          tma_load(b + HALF, &tb, n0 + BOX, k + b_k0, fb);
        } else {
          tma_load(b, &tb, k + b_k0, n0, fb);
        }
      }
    }
    return;
  }

  const int g = wg - 1;
  const int w = (threadIdx.x % 128) / 32, l = threadIdx.x % 32;
  const bool even = (N % 2) == 0;
  constexpr uint32_t A_LBO = A_MN ? HALF : 16, B_LBO = B_MN ? HALF : 16;
  constexpr uint32_t A_STEP = A_MN ? 16 * 128 : 32, B_STEP = B_MN ? 16 * 128 : 32;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full + 8 * s, (kt / STAGES) & 1);
    const uint32_t a = base + s * STAGE + g * HALF, b = base + s * STAGE + TILE;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma<A_MN, B_MN>(acc, desc(a + kk * A_STEP, A_LBO, 1024),
                        desc(b + kk * B_STEP, B_LBO, 1024));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the group before this one is done: release its stage
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (kt > 0) mbar_arrive(empty + 8 * ((kt - 1) % STAGES));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

  // fragment: register 4j + 2i + c holds row 16w + l/4 + 8i, column
  // 8j + 2(l%4) + c of the warpgroup's 64x128 tile
  TC* Cz = C + (size_t)z * M * N;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (l % 4);
    if (col >= N) continue;
    const bool two = col + 1 < N;
    float b0 = 0.0f, b1 = 0.0f;
    if (BIAS) {
      b0 = bias[col];
      b1 = two ? bias[col + 1] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + 64 * g + 16 * w + l / 4 + 8 * i;
      if (row >= M) continue;
      TC* p = Cz + (size_t)row * N + col;
      const float v0 = acc[4 * j + 2 * i] + b0, v1 = acc[4 * j + 2 * i + 1] + b1;
      if (two && !even) {
        store2(p, v0, 0.0f, false);
        store2(p + 1, v1, 0.0f, false);
      } else {
        store2(p, v0, v1, two);
      }
    }
  }
}

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// Tensor map of a row-major bf16 array [rows, cols] (row stride ld
// elements), boxes of 64 columns by `box_rows` rows, 128-byte swizzle,
// out-of-bounds elements read as zero.
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, long long rows, long long cols,
                       long long ld, int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 enc = encode_fn();
  if (enc == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || ld % 8 != 0 || rows < 1 || cols < 1)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BOX, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                         strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool A_MN, bool B_MN, typename TC, bool BIAS>
cudaError_t launch(const CUtensorMap& ta, const CUtensorMap& tb, void* C, const float* bias,
                   int M, int N, int K, int splits, int kslice, int b_k0, cudaStream_t st) {
  auto kern = gemm_bf16_kernel<A_MN, B_MN, TC, BIAS>;
  // once per instance: the ring needs more than the default 48 KB
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return attr;
  // n fastest: the CTAs resident at once share their A rows and most of B
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  kern<<<grid, THREADS, SMEM, st>>>(ta, tb, static_cast<TC*>(C), bias, M, N, K, kslice, b_k0);
  return cudaGetLastError();
}

template <bool A_MN, bool B_MN>
cudaError_t launch_c(const CUtensorMap& ta, const CUtensorMap& tb, void* C, bool c_bf16,
                     const float* bias, int M, int N, int K, int splits, int kslice, int b_k0,
                     cudaStream_t st) {
  if (c_bf16)
    return bias ? launch<A_MN, B_MN, __nv_bfloat16, true>(ta, tb, C, bias, M, N, K, splits,
                                                          kslice, b_k0, st)
                : launch<A_MN, B_MN, __nv_bfloat16, false>(ta, tb, C, bias, M, N, K, splits,
                                                           kslice, b_k0, st);
  return bias ? launch<A_MN, B_MN, float, true>(ta, tb, C, bias, M, N, K, splits, kslice, b_k0, st)
              : launch<A_MN, B_MN, float, false>(ta, tb, C, bias, M, N, K, splits, kslice, b_k0,
                                                 st);
}

template <typename TS>
__global__ void pad_kernel(const TS* __restrict__ src, long long rows, int cols, long long ld,
                           __nv_bfloat16* __restrict__ dst, int ld8) {
  const long long n = rows * ld8;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const long long r = e / ld8;
    const int c = (int)(e % ld8);
    dst[e] = c < cols ? __float2bfloat16((float)src[r * ld + c]) : __float2bfloat16(0.0f);
  }
}

}  // namespace

int gemm_kslice(int K, int splits) {
  const int kt = (K + BK - 1) / BK;
  return (kt + splits - 1) / splits * BK;
}

cudaError_t gemm_bf16_run(const void* A, bool a_mn, int lda, const void* B, bool b_mn, int ldb,
                          int b_k0, void* C, bool c_bf16, const float* bias, int M, int N, int K,
                          int splits, cudaStream_t st) {
  if (M < 1 || N < 1 || K < 0 || splits < 1 || b_k0 < 0 || (c_bf16 && splits > 1))
    return cudaErrorInvalidValue;
  if (K == 0)  // an empty sum: zero partials
    return cudaMemsetAsync(C, 0, (size_t)splits * M * N * (c_bf16 ? 2 : 4), st);
  CUtensorMap ta, tb;
  cudaError_t err = a_mn ? tensor_map(&ta, A, K, M, lda, BK) : tensor_map(&ta, A, M, K, lda, BM);
  if (err != cudaSuccess) return err;
  err = b_mn ? tensor_map(&tb, B, b_k0 + (long long)K, N, ldb, BK)
             : tensor_map(&tb, B, N, b_k0 + (long long)K, ldb, BN);
  if (err != cudaSuccess) return err;
  const int kslice = gemm_kslice(K, splits);
  if (a_mn)
    return b_mn ? launch_c<true, true>(ta, tb, C, c_bf16, bias, M, N, K, splits, kslice, b_k0, st)
                : launch_c<true, false>(ta, tb, C, c_bf16, bias, M, N, K, splits, kslice, b_k0,
                                        st);
  return b_mn ? launch_c<false, true>(ta, tb, C, c_bf16, bias, M, N, K, splits, kslice, b_k0, st)
              : launch_c<false, false>(ta, tb, C, c_bf16, bias, M, N, K, splits, kslice, b_k0,
                                       st);
}

cudaError_t pad_bf16(const void* src, bool src_f32, long long rows, int cols, long long ld,
                     void* dst, cudaStream_t st) {
  const long long n = rows * pad8(cols);
  if (n == 0) return cudaSuccess;
  const int blocks = (int)((n + 255) / 256 < 65536 ? (n + 255) / 256 : 65536);
  auto* out = static_cast<__nv_bfloat16*>(dst);
  if (src_f32)
    pad_kernel<float><<<blocks, 256, 0, st>>>(static_cast<const float*>(src), rows, cols, ld, out,
                                             pad8(cols));
  else
    pad_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(static_cast<const __nv_bfloat16*>(src),
                                                      rows, cols, ld, out, pad8(cols));
  return cudaGetLastError();
}

// The product alone (the card tests hold it against torch.matmul): the
// contract of gemm_bf16_run; returns the CUDA error.
extern "C" int gemm_bf16(const void* A, int a_mn, int lda, const void* B, int b_mn, int ldb,
                         int b_k0, void* C, int c_bf16, const void* bias, int M, int N, int K,
                         int splits, void* stream) {
  return (int)gemm_bf16_run(A, a_mn != 0, lda, B, b_mn != 0, ldb, b_k0, C, c_bf16 != 0,
                            static_cast<const float*>(bias), M, N, K, splits,
                            static_cast<cudaStream_t>(stream));
}

// k per slice, and the kernel's dynamic shared memory, in bytes (mirrored
// by ops/lstm_cuda.py gemm_plan and GEMM_SMEM_BYTES)
extern "C" int gemm_bf16_kslice(int K, int splits) { return gemm_kslice(K, splits); }
extern "C" int gemm_bf16_smem_bytes() { return SMEM; }
