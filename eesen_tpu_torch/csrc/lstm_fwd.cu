// Fused LSTM direction forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_fwd_kernel` (eesen_tpu/ops/lstm_pallas.py:323)
// and computes what it computes (lstm_pallas.py:345-376): the input
// projection x.W_x + b, then per step m.W_m, the GIFO gates with the i/f/o
// peepholes, and the length-mask freeze of the carried state.  Zero initial
// state; the c and m carries and every sum are float32.
//
// Layout: x [T,B,D] (bf16 or f32), mask [T,B] f32, W_x [D,4H] in the type of
// x, W_m as W_m^T [4H,H] on the bf16 path and as W_m [H,4H] on the f32 path
// (the caller transposes), bias [4H] f32, peepholes [3,H] f32 (i, f, o).
// Scratch: xw [T,B,4H] f32.  Outputs: m carry [T,B,H] (bf16 when state_bf16,
// else f32) and, when the pointers are not null, the c carry [T,B,H] (same
// type) and the post-activation gates [T,B,4H] in the type of x (g, i, f, o)
// that the backward pass reads.
//
// Design.  Two kernels, as the TPU kernel splits its body (the per-block
// MXU product of lstm_pallas.py:345-349, then the loop of :351-376):
//   (1) the input projection of all T*B rows at once, xw = x.W_x + b, with
//       float32 sums and the bias in the epilogue: on the bf16 path the
//       wgmma + TMA product gemm_bf16_run (csrc/gemm_wgmma.cu; x or W_x
//       first copied into a zero-padded scratch when its rows are not whole
//       16-byte units, which the tensor maps need), on the f32 path
//       gemm_kernel (csrc/gemm_tile.cuh, FMA);
//   (2) lstm_rec_kernel, the recurrence on thread-block clusters of C CTAs
//       (C = 8, or 16 with the non-portable size).  A cluster owns `rows`
//       batch rows (16 or 32; fewer only on the f32 path); CTA q owns hidden
//       units [q*U, (q+1)*U) with all four of their gate columns, so the gate
//       math stays local.  At the start each CTA copies its slice of W_m
//       (the first `kres` of its H input rows, as many as fit) into shared
//       memory and keeps it there; the rest is read from global memory (L2)
//       every step.  Each step: the pre-activations m_{t-1}.W_m for the
//       cluster's rows and the CTA's 4U columns (bf16: mma.sync m16n8k16, bf16
//       in, f32 accumulate, operands in XOR-swizzled rows so the fragment
//       loads hit 32 banks; f32: FMA), plus xw_t; the gates and the freeze;
//       then the new m, rounded to the type of x, goes into the next-step
//       operand buffer of every CTA of the cluster through distributed
//       shared memory (double-buffered), and a split cluster barrier ends
//       the step.
//
// What keeps the step's serial chain short.  The chain is product, gate
// phase, exchange, barrier, T times over; at B=128, H=320 on an H100 (700 W,
// clock stamps of CTA 0 in a scratch build, medians) it took 6.7 + 6.5 +
// 0.8 us a step with one cluster.sync() a step, and takes 3.7 (product) +
// 3.2 (gates and exchange) + 1.7 (stores and barrier) us here:
//   - The product's fragments by ldmatrix, and 2 column tiles a warp where
//     the CTA's 4U columns take at most two a warp (U <= 64), else 3, so
//     that no warp takes a second round (the instance's NG): 6.7 -> 3.7 us.
//   - xw and the mask under the product.  Each thread owns up to EPT (row,
//     unit) elements of the gate phase (3, or 6 for kernel 4's wide plans);
//     their four xw_t values and mask_t are loaded into registers right
//     after the step's barrier wait, so the DRAM latency of xw ([T,B,4H]
//     f32, far larger than L2) runs under the product instead of opening
//     every round of the gate phase.  Issued before the arrive or the wait,
//     the loads hold the release or the acquire: 0.9 us more.
//   - A split barrier.  barrier.cluster.arrive.release follows the exchange;
//     the step's global stores (m, c, gates, c_raw), which the release would
//     otherwise wait for, go between the arrive and the next step's
//     barrier.cluster.wait.acquire, which comes just before the next product
//     reads its operand.  The gates and c_raw wait in the pre-activation
//     tile meanwhile, so a __syncthreads after the wait keeps the next
//     product from overwriting them before they are stored.  A peer writes
//     into a buffer half only after the wait of the step that read it, so
//     every CTA has read it by then.
// The exchange stays one 2-byte (bf16) or 4-byte store per peer and element,
// issued inside the gate phase: a warp's stores to one peer coalesce and run
// under the gate arithmetic.  A 16-byte push per peer (m_t staged in the
// CTA's own operand, then copied out) and 16-byte output stores were each
// measured slower (7.06 and 7.10 against 6.92 ms a call at B=128, T=768,
// H=320, D=640).
// The product and the gate arithmetic are those of the one-barrier step, in
// the same order: the outputs are the same bits.
//
// The recurrence is also kernel 4, the v1 route's forward (`_fwd_kernel`,
// eesen_tpu/ops/lstm_pallas.py:50, computing lstm_pallas.py:70-91): entry
// lstm_scan_fwd_rec launches it alone, bf16 operand and f32 state, over the
// caller's xw, and writes c_raw (the cell before the mask freeze, f32)
// beside the c carry through `craw_out`, null for kernel 1 (only the bf16
// instance writes it).  The host plan is the same (ops/lstm_cuda.py fwd_plan; H <= 2624, past which the route
// runs csrc/lstm_scan_fwd.cu).
//
// Bound.  Per direction-layer the work is 2*B*T*(D+H)*4H FLOP: at B=8,
// T=512, H=320 that is 4.6 GFLOP for D=120 and 10.1 GFLOP for D=640, i.e.
// ~5 us and ~10 us at the H100's 989 TFLOP/s (bf16).  The real floor is the
// T-step serial chain above.

#include <cooperative_groups.h>
#include <stdint.h>

#include <type_traits>

#include "gemm_tile.cuh"
#include "gemm_wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
// (row, unit) elements a thread owns, rows*U <= EPT*THREADS: the kernel's
// instances take 3 or 6 (kernel 4's wide plans)
constexpr int EPT_MAX = 6;

__device__ __forceinline__ float sigm(float v) { return 1.0f / (1.0f + expf(-v)); }

// the two halves of a cluster barrier
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 32-bit word `kw` of row `row` in a tile of rows of `rw` words (rw a
// multiple of 32): XOR-swizzled inside each 32-word block, so that the eight
// rows an mma fragment load touches land in eight different bank groups
__device__ __forceinline__ int swz(int row, int kw, int rw) {
  return row * rw + (kw ^ ((row & 7) << 2));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// c[0..3] += A (16x16, row-major) . B (16x8, column-major), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Operand rows of the bf16 path are padded to a multiple of 64 elements
// (32-word swizzle blocks); the f32 path keeps H.
__host__ __device__ inline int kpad(int H, bool bf16) { return bf16 ? (H + 63) / 64 * 64 : H; }

// a pair (k, k+1) of one column of W_m^T from global memory (L2), zero past H
// and for a unit the CTA does not own: one 4-byte load where the pair is
// whole (H even keeps every row 4-byte aligned)
__device__ __forceinline__ uint32_t wm_pair(const __nv_bfloat16* __restrict__ wg, int k, int H,
                                            bool valid) {
  if (valid && k + 1 < H && (H & 1) == 0)
    return __ldg(reinterpret_cast<const unsigned int*>(wg + k));
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  return pack2(valid && k < H ? wg[k] : zero, valid && k + 1 < H ? wg[k + 1] : zero);
}

// four (x4) or two (x2) 8x8 bf16 matrices from shared memory into mma
// fragments: lanes 8i..8i+7 give the addresses of matrix i's eight rows of
// 16 bytes
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"((unsigned)__cvta_generic_to_shared(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"((unsigned)__cvta_generic_to_shared(p)));
}

// the A fragments of k-step ks for each 16-row tile (mt of them): lane l
// addresses row l % 16, k-words from (l / 16) * 4, of the swizzled operand
__device__ __forceinline__ void load_a(const uint32_t* a32, uint32_t (&a)[2][4], int mt,
                                       int lane, int ks, int rwa) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
    if (m < mt) ldsm_x4(a[m], a32 + swz(m * 16 + (lane & 15), ks * 8 + (lane >> 4) * 4, rwa));
}

// pre[r][j] = sum over k of op[r][k] W[k][j] for the CTA's 4U columns, on the
// tensor cores.  A warp takes up to NG 8-column tiles and every 16-row tile
// (rows <= 32) at once: each B fragment it loads feeds every row tile, each A
// fragment every column tile, and their accumulator chains run side by side;
// each output still sums its k-steps in order.  Fragments from shared memory
// come by ldmatrix (one instruction a 16x16 A or 16x8 B fragment); wmT rows
// past kres come from global memory (L2) in 4-byte pairs.
template <int NG>
__device__ __forceinline__ void rec_product(const __nv_bfloat16* op, const __nv_bfloat16* ws,
                                            const __nv_bfloat16* __restrict__ wmT, float* pre,
                                            int H, int U, int u0, int nu, int rows, int Kp,
                                            int kres) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int cols = 4 * U, ntiles = cols / 8, mt = rows / 16;
  const int ng = min(NG, (ntiles + WARPS - 1) / WARPS);
  const int groups = (ntiles + ng - 1) / ng;
  const uint32_t* a32 = reinterpret_cast<const uint32_t*>(op);
  const uint32_t* w32 = reinterpret_cast<const uint32_t*>(ws);
  const int rwa = Kp / 2, rww = kres / 2, kr = kres / 16, kn = Kp / 16;
  for (int grp = warp; grp < groups; grp += WARPS) {
    int jc[NG];  // this lane's column of B in each tile
    const __nv_bfloat16* wg[NG];
    bool live[NG], valid[NG];
    float acc[NG][2][4];
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int nt = grp * ng + i;
      live[i] = i < ng && nt < ntiles;
      jc[i] = (live[i] ? nt : grp * ng) * 8 + gq;
      const int g = jc[i] / U, u = jc[i] % U;
      valid[i] = live[i] && u < nu;
      wg[i] = wmT + (size_t)(g * H + u0 + (valid[i] ? u : 0)) * H;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][m][e] = 0.0f;
    }
#pragma unroll 4
    for (int ks = 0; ks < kr; ++ks) {  // resident rows
      uint32_t a[2][4];
      load_a(a32, a, mt, lane, ks, rwa);
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        if (live[i]) {
          uint32_t b[2];
          ldsm_x2(b, w32 + swz(jc[i] - gq + (lane & 7), ks * 8 + ((lane >> 3) & 1) * 4, rww));
          mma_bf16(acc[i][0], a[0], b);
          if (mt > 1) mma_bf16(acc[i][1], a[1], b);
        }
      }
    }
#pragma unroll 4
    for (int ks = kr; ks < kn; ++ks) {  // rows from L2
      const int k = 16 * ks + 2 * tq;
      uint32_t a[2][4];
      load_a(a32, a, mt, lane, ks, rwa);
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        if (live[i]) {
          const uint32_t b[2] = {wm_pair(wg[i], k, H, valid[i]),
                                 wm_pair(wg[i], k + 8, H, valid[i])};
          mma_bf16(acc[i][0], a[0], b);
          if (mt > 1) mma_bf16(acc[i][1], a[1], b);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      if (live[i]) {
        const int n = (grp * ng + i) * 8 + 2 * tq;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (m < mt) {
            float* p = pre + (m * 16 + gq) * cols + n;
            p[0] = acc[i][m][0];
            p[1] = acc[i][m][1];
            p[8 * cols] = acc[i][m][2];
            p[8 * cols + 1] = acc[i][m][3];
          }
        }
      }
    }
  }
}

// the same product on the FMA units (f32 path): a thread per column and four
// rows; W_m rows past kres come from global memory
__device__ __forceinline__ void rec_product(const float* op, const float* ws,
                                            const float* __restrict__ wm, float* pre, int H,
                                            int U, int u0, int nu, int rows, int Kp, int kres) {
  const int cols = 4 * U;
  for (int item = threadIdx.x; item < cols * (rows / 4); item += THREADS) {
    const int j = item % cols, r0 = (item / cols) * 4;
    const int g = j / U, u = j % U;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < kres; ++k) {
      const float w = ws[k * cols + j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += op[(r0 + i) * Kp + k] * w;
    }
    if (u < nu) {
      const float* wg = wm + g * H + u0 + u;
      for (int k = kres; k < H; ++k) {
        const float w = wg[(size_t)k * 4 * H];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] += op[(r0 + i) * Kp + k] * w;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) pre[(r0 + i) * cols + j] = acc[i];
  }
}

// xw_t (g, i, f, o) and mask_t of this thread's elements e = tid + i*THREADS
// of the gate phase, element e being (row e / nu, unit u0 + e % nu)
template <int EPT>
__device__ __forceinline__ void fetch_step(const float* __restrict__ xw,
                                           const float* __restrict__ mask, float (&xr)[EPT][4],
                                           float (&mr)[EPT], int t, int B, int H, int b0,
                                           int u0, int nu, int ne) {
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int e = threadIdx.x + i * THREADS;
    if (e < ne) {
      const size_t row = (size_t)t * B + b0 + e / nu;
      const float* x4 = xw + row * 4 * H + u0 + e % nu;
#pragma unroll
      for (int g = 0; g < 4; ++g) xr[i][g] = x4[g * H];
      mr[i] = mask[row];
    }
  }
}

template <typename TIn, typename TState, int EPT, int NG>
__global__ void __launch_bounds__(THREADS)
    lstm_rec_kernel(const float* __restrict__ xw, const float* __restrict__ mask,
                    const TIn* __restrict__ w, const float* __restrict__ ph,
                    TState* __restrict__ m_out, TState* __restrict__ c_out,
                    float* __restrict__ craw_out, TIn* __restrict__ gates_out, int T, int B,
                    int H, int U, int rows, int kres) {
  constexpr bool BF16 = std::is_same<TIn, __nv_bfloat16>::value;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = (int)cluster.num_blocks();
  const int q = (int)cluster.block_rank();
  const int G = 4 * H, cols = 4 * U;
  const int Kp = kpad(H, BF16);
  float* pre = reinterpret_cast<float*>(smem_raw);  // [rows][4U] m.W_m
  float* cs = pre + rows * cols;                    // [rows][U] c carry
  float* ms = cs + rows * U;                        // [rows][U] m carry
  TIn* op = reinterpret_cast<TIn*>(ms + rows * U);  // [2][rows][Kp] m_{t-1}
  TIn* ws = op + 2 * rows * Kp;                     // resident W_m slice

  const int tid = threadIdx.x;
  const int b0 = (blockIdx.x / C) * rows;
  const int nr = min(rows, B - b0);
  const int u0 = q * U;
  const int nu = max(0, min(U, H - u0));

  // the resident slice, zero outside [0, H) x this CTA's units: bf16 as
  // [4U][kres] swizzled rows of W_m^T, f32 as [kres][4U]
  if constexpr (BF16) {
    const int rw = kres / 2;
    uint32_t* ws32 = reinterpret_cast<uint32_t*>(ws);
    const __nv_bfloat16 zero = __float2bfloat16(0.0f);
    for (int e = tid; e < cols * rw; e += THREADS) {
      const int j = e / rw, kw = e % rw, k = 2 * kw;
      const int g = j / U, u = j % U;
      const __nv_bfloat16* src = w + (size_t)(g * H + u0 + u) * H;
      const bool valid = u < nu;
      ws32[swz(j, kw, rw)] = pack2(valid && k < H ? src[k] : zero,
                                   valid && k + 1 < H ? src[k + 1] : zero);
    }
  } else {
    for (int e = tid; e < kres * cols; e += THREADS) {
      const int k = e / cols, j = e % cols;
      const int g = j / U, u = j % U;
      ws[e] = u < nu ? w[(size_t)k * G + g * H + u0 + u] : 0.0f;
    }
  }
  for (int e = tid; e < 2 * rows * Kp; e += THREADS) op[e] = from_f<TIn>(0.0f);
  for (int e = tid; e < 2 * rows * U; e += THREADS) cs[e] = 0.0f;  // c and m carries
  cluster.sync();  // every CTA's buffers are zero before any remote write

  const int ne = nr * nu;
  // this thread's elements e = tid + i*THREADS: xw_t (g, i, f, o) and mask_t
  float xr[EPT][4], mr[EPT];

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    TIn* nxt = op + (cur ^ 1) * rows * Kp;  // m_t's operand buffer, here and in every peer
    if (t > 0) {
      cluster_wait();   // m_{t-1} has landed from every peer
      __syncthreads();  // step t-1's outputs have left pre
    }
    // xw_t and mask_t, in flight under the product (after the wait, which
    // would wait for them)
    fetch_step(xw, mask, xr, mr, t, B, H, b0, u0, nu, ne);
    if constexpr (BF16)
      rec_product<NG>(op + cur * rows * Kp, ws, w, pre, H, U, u0, nu, rows, Kp, kres);
    else
      rec_product(op + cur * rows * Kp, ws, w, pre, H, U, u0, nu, rows, Kp, kres);
    __syncthreads();
    // the gates and the mask freeze for every (row, unit): every element's
    // inputs first, so that the elements' arithmetic runs side by side
    float in[EPT][6];
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int e = tid + i * THREADS;
      if (e < ne) {
        const int r = e / nu, u = e % nu;
        const float* p4 = pre + r * cols + u;
#pragma unroll
        for (int g = 0; g < 4; ++g) in[i][g] = p4[g * U];
        in[i][4] = cs[r * U + u];
        in[i][5] = ms[r * U + u];
      }
    }
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int e = tid + i * THREADS;
      if (e < ne) {
        const int r = e / nu, u = e % nu, hu = u0 + u;
        float* p4 = pre + r * cols + u;
        const float c_prev = in[i][4];
        const float m_prev = in[i][5];
        const float gg = tanhf(xr[i][0] + in[i][0]);
        const float ig = sigm(xr[i][1] + in[i][1] + c_prev * ph[hu]);
        const float fg = sigm(xr[i][2] + in[i][2] + c_prev * ph[H + hu]);
        const float c_raw = fg * c_prev + ig * gg;
        const float og = sigm(xr[i][3] + in[i][3] + c_raw * ph[2 * H + hu]);
        const float m_raw = og * tanhf(c_raw);
        const float mt = mr[i];
        const float c_new = c_raw * mt + c_prev * (1.0f - mt);
        const float m_new = m_raw * mt + m_prev * (1.0f - mt);
        cs[r * U + u] = c_new;
        ms[r * U + u] = m_new;
        // the gates (bf16: packed in pairs, then c_raw) wait in pre
        if constexpr (BF16) {
          uint32_t* w4 = reinterpret_cast<uint32_t*>(p4);
          w4[0] = pack2(from_f<TIn>(gg), from_f<TIn>(ig));
          w4[U] = pack2(from_f<TIn>(fg), from_f<TIn>(og));
          p4[2 * U] = c_raw;
        } else {
          p4[0] = gg;
          p4[U] = ig;
          p4[2 * U] = fg;
          p4[3 * U] = og;
        }
        if (t + 1 < T) {
          // m_t, rounded to the type of x, into every CTA's next operand
          const int idx = BF16 ? 2 * swz(r, hu >> 1, Kp / 2) + (hu & 1) : r * Kp + hu;
          const TIn v = from_f<TIn>(m_new);
          for (int dq = 0; dq < C; ++dq) cluster.map_shared_rank(nxt, dq)[idx] = v;
        }
      }
    }
    if (t + 1 < T) cluster_arrive();
    // step t's outputs, while the peers finish their exchange
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int e = tid + i * THREADS;
      if (e < ne) {
        const int r = e / nu, u = e % nu, hu = u0 + u;
        const size_t row = (size_t)t * B + b0 + r;
        const float* p4 = pre + r * cols + u;
        m_out[row * H + hu] = from_f<TState>(ms[r * U + u]);
        if (c_out != nullptr) c_out[row * H + hu] = from_f<TState>(cs[r * U + u]);
        TIn* gp = gates_out != nullptr ? gates_out + row * G + hu : nullptr;
        if constexpr (BF16) {
          const uint32_t* w4 = reinterpret_cast<const uint32_t*>(p4);
          if (craw_out != nullptr) craw_out[row * H + hu] = p4[2 * U];
          if (gp != nullptr) {
            const uint32_t gi = w4[0], fo = w4[U];
            gp[0] = __ushort_as_bfloat16((unsigned short)(gi & 0xffffu));
            gp[H] = __ushort_as_bfloat16((unsigned short)(gi >> 16));
            gp[2 * H] = __ushort_as_bfloat16((unsigned short)(fo & 0xffffu));
            gp[3 * H] = __ushort_as_bfloat16((unsigned short)(fo >> 16));
          }
        } else if (gp != nullptr) {
          gp[0] = p4[0];
          gp[H] = p4[U];
          gp[2 * H] = p4[2 * U];
          gp[3 * H] = p4[3 * U];
        }
      }
    }
  }
}

// Shared memory of lstm_rec_kernel, in bytes (mirrored by ops/lstm_cuda.py
// fwd_smem_bytes).
long long rec_smem_bytes(int H, int rows, int units, int kres, bool bf16) {
  const long long s = bf16 ? 2 : 4;
  const long long cols = 4LL * units;
  return rows * cols * 4 + 2LL * rows * units * 4 + 2LL * rows * kpad(H, bf16) * s +
         (long long)kres * cols * s;
}

// The recurrence's instance for this shape: each thread carries 3 elements
// of the gate phase and each warp 2 column tiles of the product where the
// shape allows it (every kernel 1 plan of the recipes), else 6 and 3
// (kernel 4's wide plans, where 2 tiles a warp would take two rounds).
template <typename TIn, typename TState>
auto rec_kernel(int rows, int units) {
  return rows * units <= 3 * THREADS && units <= 4 * WARPS
             ? lstm_rec_kernel<TIn, TState, 3, 2>
             : lstm_rec_kernel<TIn, TState, EPT_MAX, 3>;
}

template <typename TIn, typename TState>
cudaError_t rec_config(int B, int H, int cluster, int rows, int units, int kres,
                       cudaStream_t st, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const bool bf16 = std::is_same<TIn, __nv_bfloat16>::value;
  // the shapes the kernel takes: whole mma tiles (at most two row tiles), a
  // multiple of 64 resident rows of W_m on the bf16 path, every unit owned,
  // each thread at most EPT_MAX elements
  if (cluster < 1 || cluster > 16 || rows < 4 || rows % (bf16 ? 16 : 4) != 0 ||
      (bf16 && (rows > 32 || units % 2 != 0 || kres % 64 != 0)) || kres < 0 ||
      kres > kpad(H, bf16) ||
      (long long)units * cluster < H || rows * units > EPT_MAX * THREADS)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)rec_smem_bytes(H, rows, units, kres, bf16);
  auto kern = rec_kernel<TIn, TState>(rows, units);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster * ((B + rows - 1) / rows));
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// How many clusters of this shape the card holds at once; 0 means one
// cluster cannot be resident.
template <typename TIn, typename TState>
cudaError_t max_clusters(int B, int H, int cluster, int rows, int units, int kres,
                         cudaStream_t st, int* active) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = rec_config<TIn, TState>(B, H, cluster, rows, units, kres, st, &cfg, &attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(active, rec_kernel<TIn, TState>(rows, units), &cfg);
}

// The recurrence's launch configuration, refused with
// cudaErrorInvalidConfiguration when not even one cluster can be resident.
template <typename TIn, typename TState>
cudaError_t rec_ready(int B, int H, int cluster, int rows, int units, int kres, cudaStream_t st,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  cudaError_t err = rec_config<TIn, TState>(B, H, cluster, rows, units, kres, st, cfg, attr);
  if (err != cudaSuccess) return err;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, rec_kernel<TIn, TState>(rows, units), cfg);
  if (err != cudaSuccess) return err;
  return active < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

template <typename TIn, typename TState>
cudaError_t run(const void* x, const void* mask, const void* wx, const void* bias,
                const void* w, const void* ph, void* m_out, void* c_out, void* gates_out,
                void* xw, void* x_pad, void* wx_pad, int T, int B, int D, int H,
                int cluster, int rows, int units, int kres, cudaStream_t st) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = rec_ready<TIn, TState>(B, H, cluster, rows, units, kres, st, &cfg, &attr);
  if (err != cudaSuccess) return err;
  // (1) xw = x.W_x + b: A(tb, d) = x[tb*D + d], B(d, g) = W_x[d*4H + g]
  const int G = 4 * H, TB = T * B;
  if constexpr (std::is_same<TIn, __nv_bfloat16>::value) {
    int ldx = D, ldw = G;
    if (x_pad != nullptr) {
      if ((err = pad_bf16(x, false, TB, D, D, x_pad, st)) != cudaSuccess) return err;
      x = x_pad;
      ldx = pad8(D);
    }
    if (wx_pad != nullptr) {
      if ((err = pad_bf16(wx, false, D, G, G, wx_pad, st)) != cudaSuccess) return err;
      wx = wx_pad;
      ldw = pad8(G);
    }
    err = gemm_bf16_run(x, false, ldx, wx, true, ldw, 0, xw, false,
                        static_cast<const float*>(bias), TB, G, D, 1, st);
  } else {
    err = gemm<TIn, TIn, float, true>(x, D, 1, wx, G, 1, xw, static_cast<const float*>(bias),
                                      TB, G, D, 1, st);
  }
  if (err != cudaSuccess) return err;
  // (2) the recurrence
  err = cudaLaunchKernelEx(&cfg, rec_kernel<TIn, TState>(rows, units),
                           static_cast<const float*>(xw),
                           static_cast<const float*>(mask), static_cast<const TIn*>(w),
                           static_cast<const float*>(ph), static_cast<TState*>(m_out),
                           static_cast<TState*>(c_out), static_cast<float*>(nullptr),
                           static_cast<TIn*>(gates_out), T, B, H, units, rows, kres);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Shared memory of the recurrence kernel for these sizes, in bytes.
extern "C" long long lstm_fwd_smem_bytes(int H, int rows, int units, int kres, int in_bf16) {
  return rec_smem_bytes(H, rows, units, kres, in_bf16 != 0);
}

// cudaOccupancyMaxActiveClusters for the recurrence kernel at this shape
// (state type f32), or minus the CUDA error.
extern "C" int lstm_fwd_max_clusters(int B, int H, int cluster, int rows, int units, int kres,
                                     int in_bf16) {
  int active = 0;
  const cudaError_t err =
      in_bf16 ? max_clusters<__nv_bfloat16, float>(B, H, cluster, rows, units, kres, 0, &active)
              : max_clusters<float, float>(B, H, cluster, rows, units, kres, 0, &active);
  return err == cudaSuccess ? active : -(int)err;
}

// Runs one LSTM direction on `stream`: the input projection into the
// scratch xw [T,B,4H] f32, then the recurrence on clusters of `cluster`
// CTAs, each cluster `rows` batch rows, each CTA `units` hidden units with
// the first `kres` input rows of its W_m slice resident.  Returns the first
// CUDA error (cudaErrorInvalidConfiguration when not even one cluster can be
// resident).  in_bf16: x/W_x/W_m^T are bf16 (else x/W_x/W_m f32);
// state_bf16: m/c outputs bf16.  c_out and gates_out may be null.  x_pad
// [T*B, D rounded to 8] and wx_pad [D, 4H rounded to 8] (bf16 path) are
// scratch for zero-padded copies of x and W_x, given where the caller found
// the operand's rows not whole 16-byte units (else null).
extern "C" int lstm_fwd(const void* x, const void* mask, const void* wx, const void* bias,
                        const void* w, const void* ph, void* m_out, void* c_out,
                        void* gates_out, void* xw, void* x_pad, void* wx_pad, int T, int B,
                        int D, int H, int in_bf16, int state_bf16, int cluster, int rows,
                        int units, int kres, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_bf16) {
    err = state_bf16
              ? run<__nv_bfloat16, __nv_bfloat16>(x, mask, wx, bias, w, ph, m_out, c_out, gates_out, xw, x_pad, wx_pad, T, B, D, H, cluster, rows, units, kres, st)
              : run<__nv_bfloat16, float>(x, mask, wx, bias, w, ph, m_out, c_out, gates_out, xw, x_pad, wx_pad, T, B, D, H, cluster, rows, units, kres, st);
  } else {
    err = state_bf16
              ? run<float, __nv_bfloat16>(x, mask, wx, bias, w, ph, m_out, c_out, gates_out, xw, x_pad, wx_pad, T, B, D, H, cluster, rows, units, kres, st)
              : run<float, float>(x, mask, wx, bias, w, ph, m_out, c_out, gates_out, xw, x_pad, wx_pad, T, B, D, H, cluster, rows, units, kres, st);
  }
  return (int)err;
}

// Kernel 4 (the v1 route's forward; where this plan does not take H the
// route runs csrc/lstm_scan_fwd.cu): the recurrence alone, bf16 operand and W_m^T
// [4H,H] bf16, f32 state, over the caller's xw [T,B,4H] f32 (projection +
// bias); writes the m and c carries and c_raw (the cell before the mask
// freeze) [T,B,H] f32 and the gates [T,B,4H] bf16 (g, i, f, o).  Cluster
// shape as lstm_fwd's (ops/lstm_cuda.py fwd_plan).  Returns the first CUDA
// error (cudaErrorInvalidConfiguration when not even one cluster can be
// resident).
extern "C" int lstm_scan_fwd_rec(const void* xw, const void* mask, const void* wmT,
                                 const void* ph, void* m_out, void* c_out, void* craw_out,
                                 void* gates_out, int T, int B, int H, int cluster, int rows,
                                 int units, int kres, void* stream) {
  using BF = __nv_bfloat16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = rec_ready<BF, float>(B, H, cluster, rows, units, kres, st, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, rec_kernel<BF, float>(rows, units),
                           static_cast<const float*>(xw),
                           static_cast<const float*>(mask), static_cast<const BF*>(wmT),
                           static_cast<const float*>(ph), static_cast<float*>(m_out),
                           static_cast<float*>(c_out), static_cast<float*>(craw_out),
                           static_cast<BF*>(gates_out), T, B, H, units, rows, kres);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
