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
// f32); ph [3,H] f32; `wsl`, the CTAs' slices of W_m laid out by the caller
// (ops/lstm_cuda.bwd_weight_slices): CTA q's columns g*H + q*U + u of W_m,
// zero for units past H, as [C][Hp][SW] 32-bit words of bf16 pairs (row
// u' of W_m, its 4U columns j = g*U + u, SW = 2U+4, Hp = H rounded up to 8)
// on the bf16 path, as [C][4U][H] floats (column j, then u') on the f32
// path.  Outputs: dx [T,B,D] compute type; dW_x [D,4H], dW_m [H,4H] and
// db|dph [7H] f32.  Scratch from the caller: dgifo [T,B,4H] (compute type),
// per-row partial sums [B,7H], split-K partials of dW_x and dW_m and, on the
// bf16 path, zero-padded bf16 copies of the products' operands whose rows
// are not whole 16-byte units (the tensor maps' rule) or, for m, not bf16.
//
// Design.  On the TPU one sequential grid carries dm/dc and accumulates dW in
// VMEM while W_m stays resident; here the work is split in two:
//   (a) lstm_bwd_rec_kernel, the reverse recurrence on thread-block
//       clusters of C CTAs (8, or 16 with the non-portable size), shaped as
//       kernel 1's recurrence (csrc/lstm_fwd.cu).  A cluster owns `rows`
//       batch rows; CTA q owns hidden units [q*U, (q+1)*U) with all four of
//       their gate columns, so the elementwise phase (dm_total, dc, the gate
//       gradients, the db/dph sums) stays local; the dc and dm carries and
//       the sums of its (row, unit) elements live in registers.  At the start
//       each CTA copies its slice of W_m (the first `kres` of its H rows u',
//       as many as fit) into shared memory and keeps it there; the rest is
//       read from L2 every step.  Each step from T-1 down to 0: the
//       elementwise phase, reading dm_{t} as the sum of the C partials in
//       its receive buffer in the fixed order q = 0..C-1 (no atomics: the
//       same inputs give the same bits); then (t > 0) the CTA's partial
//       dgifo_q[rows, 4U] . W_m[:, its 4U columns]^T -> [rows, H] (bf16:
//       mma.sync m16n8k16, bf16 in, f32 sums, padded rows so that the
//       fragment loads hit 32 banks; f32: FMA), whose U-wide chunk for CTA p
//       is written into p's receive buffer, slot q, through distributed
//       shared memory (a reduce-scatter; double-buffered receive slots); one
//       cluster barrier ends the step.  It writes dgifo and, per batch row,
//       the partial sums of db and dph.
//   (b) the products dW_x, dW_m and dx, shared in kind with the forward
//       kernel's input projection: on the bf16 path the wgmma + TMA product
//       gemm_bf16_run (csrc/gemm_wgmma.cu), which reads x and m as the
//       transposed A and W_x as the transposed B where they lie, and dW_m's
//       dgifo from row B on by the tensor map's start coordinate; on the f32
//       path gemm_kernel (csrc/gemm_tile.cuh, FMA).  The two weight
//       gradients are split over k into partial buffers (ops/lstm_cuda.py
//       gemm_plan); sum_rows_kernel then adds the partials in a fixed order,
//       so the result is deterministic.
//
// The reverse recurrence is also kernel 5, the v1 route's backward
// (`_bwd_kernel`, eesen_tpu/ops/lstm_pallas.py:94, computing
// lstm_pallas.py:111-156), as the template instance V1 behind entry
// lstm_scan_bwd_rec: it reads the stored c_raw f32 (recomputing it from the
// bf16 gates would differ by their rounding), writes dgifo as dxw in f32,
// unrounded (the dm product still takes bf16(dgifo)), and keeps no per-row
// sums (its caller computes dW_m and dph from dxw).  A thread then carries
// up to EPT_V1 elements; the host plan is ops/lstm_cuda.py bwd_plan(v1=True)
// (H <= 1664, past which the route runs csrc/lstm_scan_bwd.cu), which keeps
// all clusters in one wave where it can.
//
// Bound.  At B=128, T=768, H=640, D=1280 the work is 4*B*T*(D+H)*4H FLOP
// over the valid steps, ~1.9 ms at 989 TFLOP/s (bf16).  The recurrence (a)
// is bound by its T-step serial chain: per step the residuals' loads, one
// partial product of 2*rows*4U*H FLOP a CTA, the DSMEM reduce-scatter
// (rows*H*4 bytes out of each CTA) and one cluster barrier.  The products
// are bound by the tensor cores (csrc/gemm_wgmma.cu).

#include <cooperative_groups.h>
#include <stdint.h>

#include <type_traits>

#include "gemm_tile.cuh"
#include "gemm_wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int EPT = 4;  // (row, unit) elements a thread carries: rows*U <= EPT*THREADS
constexpr int EPT_V1 = 8;  // the same for the v1 instance, which carries no sums
constexpr int KCH = 4;  // k-steps of W_m fragments loaded at once
constexpr unsigned FULL = 0xffffffffu;

// 32-bit words per row of the operand tile (and of the bf16 W_m slice): 4U
// bf16 values plus 4 words of padding (SW = 4 mod 8: the 8 rows of an mma
// fragment load land in 8 bank groups); 4U floats on the f32 path.
__host__ __device__ inline int row_words(int U, bool bf16) { return bf16 ? 2 * U + 4 : 4 * U; }

// H rounded up to whole 8-column mma tiles (the rows of the bf16 slices)
__host__ __device__ inline int hpad8(int H) { return (H + 7) / 8 * 8; }

// c[0..3] += A (16x16, row-major) . B (16x8, column-major), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The step's partial dm on the tensor cores: P[r][u'] = sum over the CTA's
// 4U columns j of op[r][j] W_m[u'][j].  A warp takes two 8-column tiles of
// u' at a time and every row tile, so each operand fragment it loads feeds
// two mma; fragments of slice rows past kres come from L2, KCH k-steps in
// flight at once.  Each lane then holds 4 consecutive columns of one row
// (a shuffle with its neighbour) and stores them as one float4 into the
// receive buffer of the CTA that owns unit u', slot q.
__device__ __forceinline__ void rec_product(cg::cluster_group& cluster, const uint32_t* op,
                                            const uint32_t* ws, const uint32_t* __restrict__ wg,
                                            float* recv, int H, int U, int rows, int nr,
                                            int kres) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int SW = row_words(U, true);
  const int nks = U / 4;  // 16-deep k-steps over the 4U columns
  const int mtiles = (nr + 15) / 16;
  const int q = (int)cluster.block_rank();
  const int ntiles = (H + 7) / 8;
  for (int t0 = warp * 2; t0 < ntiles; t0 += WARPS * 2) {
    const int nt = min(2, ntiles - t0);
    float acc[2][2][4];  // [column tile][row tile]
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][mt][e] = 0.0f;
    const uint32_t* wr[2];  // this lane's slice row of each tile, in smem or L2
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n0 = (t0 + min(j, nt - 1)) * 8;
      wr[j] = (n0 < kres ? ws + (n0 + gq) * SW : wg + (size_t)(n0 + gq) * SW) + tq;
    }
    for (int k0 = 0; k0 < nks; k0 += KCH) {
      uint32_t b[KCH][2][2];
#pragma unroll
      for (int i = 0; i < KCH; ++i)
        if (k0 + i < nks)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            b[i][j][0] = wr[j][(k0 + i) * 8];
            b[i][j][1] = wr[j][(k0 + i) * 8 + 4];
          }
#pragma unroll
      for (int i = 0; i < KCH; ++i) {
        if (k0 + i < nks) {
          const int kw = (k0 + i) * 8 + tq;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (mt < mtiles) {
              const uint32_t* ar = op + (mt * 16 + gq) * SW + kw;
              const uint32_t a[4] = {ar[0], ar[8 * SW], ar[4], ar[8 * SW + 4]};
              mma_bf16(acc[0][mt], a, b[i][0]);
              if (nt > 1) mma_bf16(acc[1][mt], a, b[i][1]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j < nt) {
        const int cb = (t0 + j) * 8 + 4 * (tq >> 1);  // this lane's 4 columns
        const int p = cb < H ? cb / U : 0;
        float* dst = cluster.map_shared_rank(recv, p) + (size_t)q * rows * U + (cb - p * U);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (mt < mtiles) {
            float* c = acc[j][mt];
            const bool odd = tq & 1;
            const float s0 = __shfl_xor_sync(FULL, odd ? c[0] : c[2], 1);
            const float s1 = __shfl_xor_sync(FULL, odd ? c[1] : c[3], 1);
            const int r = mt * 16 + gq + (odd ? 8 : 0);
            const float4 v =
                odd ? make_float4(s0, s1, c[2], c[3]) : make_float4(c[0], c[1], s0, s1);
            if (cb < H && r < nr) *reinterpret_cast<float4*>(dst + r * U) = v;
          }
        }
      }
    }
  }
}

// the same product on the FMA units (f32 path): a thread per column u' and
// four rows; slice columns u' past kres come from L2
__device__ __forceinline__ void rec_product(cg::cluster_group& cluster, const float* op,
                                            const float* ws, const float* __restrict__ wg,
                                            float* recv, int H, int U, int rows, int nr,
                                            int kres) {
  const int K4 = 4 * U;
  const int q = (int)cluster.block_rank();
  const int groups = (nr + 3) / 4;
  for (int item = threadIdx.x; item < H * groups; item += THREADS) {
    const int up = item % H, r0 = (item / H) * 4;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float* a = op + r0 * K4;
    if (up < kres) {
      for (int j = 0; j < K4; ++j) {
        const float w = ws[j * kres + up];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] += a[i * K4 + j] * w;
      }
    } else {
      for (int j = 0; j < K4; ++j) {
        const float w = __ldg(wg + (size_t)j * H + up);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] += a[i * K4 + j] * w;
      }
    }
    const int p = up / U;
    float* dst = cluster.map_shared_rank(recv, p) + ((size_t)q * rows + r0) * U + (up - p * U);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (r0 + i < nr) dst[i * U] = acc[i];
  }
}

// V1: kernel 5's instance (see lstm_scan_bwd_rec below): c_raw read from
// `craw` instead of recomputed, dgifo written unrounded in float32, no
// per-row sums (part_rows unused).
template <typename TIn, typename TState, bool V1>
__global__ void __launch_bounds__(THREADS)
    lstm_bwd_rec_kernel(const float* __restrict__ mask, const TIn* __restrict__ gates,
                        const TState* __restrict__ c, const float* __restrict__ craw,
                        const TState* __restrict__ gm, const void* __restrict__ wsl,
                        const float* __restrict__ ph,
                        typename std::conditional<V1, float, TIn>::type* __restrict__ dgifo,
                        float* __restrict__ part_rows, int T, int B, int H, int U, int rows,
                        int kres) {
  constexpr bool BF16 = std::is_same<TIn, __nv_bfloat16>::value;
  constexpr int ept = V1 ? EPT_V1 : EPT;
  using W = typename std::conditional<BF16, uint32_t, float>::type;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = (int)cluster.num_blocks();
  const int q = (int)cluster.block_rank();
  const int G = 4 * H, H7 = 7 * H;
  const int SW = row_words(U, BF16);
  const int slot = rows * U;                          // one partial's floats
  float* recv = reinterpret_cast<float*>(smem_raw);   // [2][C][rows][U] partials of dm
  W* op = reinterpret_cast<W*>(recv + 2 * C * slot);  // [rows][SW] dgifo_t, rounded
  W* ws = op + rows * SW;                             // resident W_m slice

  const int tid = threadIdx.x;
  const int b0 = (blockIdx.x / C) * rows;
  const int nr = min(rows, B - b0);
  const int u0 = q * U;
  const int nu = max(0, min(U, H - u0));
  const int ne = nr * nu;

  // this CTA's slice of W_m in global memory; its first kres rows u'
  // (bf16, [kres][SW] words) or columns u' (f32, [4U][kres]) into ws
  const W* wg;
  if constexpr (BF16) {
    wg = static_cast<const W*>(wsl) + (size_t)q * hpad8(H) * SW;
    const uint4* src = reinterpret_cast<const uint4*>(wg);
    uint4* dst = reinterpret_cast<uint4*>(ws);
    for (int e = tid; e < kres * SW / 4; e += THREADS) dst[e] = src[e];
  } else {
    wg = static_cast<const W*>(wsl) + (size_t)q * 4 * U * H;
    for (int e = tid; e < 4 * U * kres; e += THREADS) {
      const int j = e / kres, up = e % kres;
      ws[e] = wg[(size_t)j * H + up];
    }
  }
  for (int e = tid; e < rows * SW; e += THREADS) op[e] = 0;
  cluster.sync();  // every CTA is running before any remote write

  float dc[ept], dmp[ept], acc[ept][7];
#pragma unroll
  for (int i = 0; i < ept; ++i) {
    dc[i] = 0.0f;
    dmp[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < 7; ++k) acc[i][k] = 0.0f;
  }

  for (int t = T - 1; t >= 0; --t) {
    const float* rin = recv + (t & 1) * C * slot;
#pragma unroll
    for (int i = 0; i < ept; ++i) {
      const int e = tid + i * THREADS;
      if (e < ne) {
        const int r = e / nu, u = e % nu, hu = u0 + u;
        const size_t row = (size_t)t * B + b0 + r;
        // dm_t: the C partials of the step above, in the order q = 0..C-1
        float dm_in = 0.0f;
        if (t + 1 < T)
          for (int p = 0; p < C; ++p) dm_in += rin[p * slot + r * U + u];
        const float dm_total = to_f(gm[row * H + hu]) + (dm_in + dmp[i]);
        const TIn* gp = gates + row * G + hu;
        const float gg = to_f(gp[0]), ig = to_f(gp[H]);
        const float fg = to_f(gp[2 * H]), og = to_f(gp[3 * H]);
        const float c_prev = t > 0 ? to_f(c[(row - B) * H + hu]) : 0.0f;
        const float c_raw = V1 ? craw[row * H + hu] : fg * c_prev + ig * gg;
        const float mt = mask[row];
        const float tanh_c = tanhf(c_raw);

        const float dm_raw = dm_total * mt;
        const float dc_in = dc[i];
        float dc_raw = dc_in * mt;
        const float do_ = dm_raw * tanh_c;
        dc_raw = dc_raw + dm_raw * og * (1.0f - tanh_c * tanh_c);
        const float do_pre = do_ * og * (1.0f - og);
        dc_raw = dc_raw + do_pre * ph[2 * H + hu];
        const float di_pre = dc_raw * gg * ig * (1.0f - ig);
        const float df_pre = dc_raw * c_prev * fg * (1.0f - fg);
        const float dg_pre = dc_raw * ig * (1.0f - gg * gg);
        dc[i] = dc_raw * fg + di_pre * ph[hu] + df_pre * ph[H + hu] + dc_in * (1.0f - mt);
        dmp[i] = dm_total * (1.0f - mt);

        const float d4[4] = {dg_pre, di_pre, df_pre, do_pre};
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const TIn v = from_f<TIn>(d4[g]);
          if constexpr (V1) {
            dgifo[row * G + g * H + hu] = d4[g];
          } else {
            dgifo[row * G + g * H + hu] = v;
          }
          if constexpr (BF16) {
            reinterpret_cast<__nv_bfloat16*>(op)[2 * r * SW + g * U + u] = v;
          } else {
            op[r * SW + g * U + u] = v;
          }
          if constexpr (!V1) acc[i][g] += d4[g];
        }
        if constexpr (!V1) {
          acc[i][4] += di_pre * c_prev;
          acc[i][5] += df_pre * c_prev;
          acc[i][6] += do_pre * c_raw;
        }
      }
    }
    if (t == 0) break;  // no step below: nothing more crosses the cluster
    __syncthreads();    // the operand is complete
    // dm_{t-1}'s partial from this CTA's columns, into slot q of every CTA
    rec_product(cluster, op, ws, wg, recv + ((t - 1) & 1) * C * slot, H, U, rows, nr, kres);
    cluster.sync();     // every partial has landed; the operand is free
  }
  if constexpr (!V1) {
#pragma unroll
    for (int i = 0; i < ept; ++i) {
      const int e = tid + i * THREADS;
      if (e < ne) {
        float* pr = part_rows + (size_t)(b0 + e / nu) * H7 + u0 + e % nu;
#pragma unroll
        for (int k = 0; k < 7; ++k) pr[k * H] = acc[i][k];
      }
    }
  }
}

// Shared memory of lstm_bwd_rec_kernel, in bytes (mirrored by
// ops/lstm_cuda.py bwd_smem_bytes): double-buffered receive slots
// 2 x C x [rows][U] f32, the operand [rows][SW] and kres rows of SW
// words (bf16) or [4U][kres] floats (f32) of the W_m slice.
long long rec_smem_bytes(int cluster, int rows, int units, int kres, bool bf16) {
  return 4LL * (2LL * cluster * rows * units + (long long)(rows + kres) * row_words(units, bf16));
}

template <typename TIn, typename TState, bool V1>
cudaError_t rec_config(int B, int H, int cluster, int rows, int units, int kres,
                       cudaStream_t st, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const bool bf16 = std::is_same<TIn, __nv_bfloat16>::value;
  // the shapes the kernel takes: whole mma row tiles (at most two) and
  // k-steps, whole 8-column tiles of resident rows on the bf16 path, every
  // unit owned, each thread at most EPT (EPT_V1) elements
  if (cluster < 1 || cluster > 16 || rows < 4 || rows % (bf16 ? 16 : 4) != 0 ||
      (bf16 && (rows > 32 || units % 4 != 0 || kres % 8 != 0 || kres > hpad8(H))) ||
      kres < 0 || (!bf16 && kres > H) || (long long)units * cluster < H ||
      rows * units > (V1 ? EPT_V1 : EPT) * THREADS)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)rec_smem_bytes(cluster, rows, units, kres, bf16);
  auto kern = lstm_bwd_rec_kernel<TIn, TState, V1>;
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
template <typename TIn, typename TState, bool V1>
cudaError_t max_clusters(int B, int H, int cluster, int rows, int units, int kres,
                         cudaStream_t st, int* active) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      rec_config<TIn, TState, V1>(B, H, cluster, rows, units, kres, st, &cfg, &attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(active, lstm_bwd_rec_kernel<TIn, TState, V1>, &cfg);
}

// The recurrence's launch configuration, refused with
// cudaErrorInvalidConfiguration when not even one cluster can be resident.
template <typename TIn, typename TState, bool V1>
cudaError_t rec_ready(int B, int H, int cluster, int rows, int units, int kres, cudaStream_t st,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  cudaError_t err = rec_config<TIn, TState, V1>(B, H, cluster, rows, units, kres, st, cfg, attr);
  if (err != cudaSuccess) return err;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, lstm_bwd_rec_kernel<TIn, TState, V1>, cfg);
  if (err != cudaSuccess) return err;
  return active < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
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

template <typename TIn, typename TState>
cudaError_t run(const void* x, const void* mask, const void* gates, const void* c, const void* m,
                const void* gm, const void* wx, const void* wsl, const void* ph, void* dx,
                void* dwx, void* dwm, void* dbph, void* dgifo, void* part_rows, void* part_wx,
                void* part_wm, void* x_pad, void* dg_pad, void* m_pad, void* wx_pad, int T,
                int B, int D, int H, int cluster, int rows, int units, int kres, int zx, int zm,
                cudaStream_t st) {
  const int G = 4 * H;
  const long long TB = (long long)T * B;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      rec_ready<TIn, TState, false>(B, H, cluster, rows, units, kres, st, &cfg, &attr);
  if (err != cudaSuccess) return err;
  // (a) the reverse recurrence
  err = cudaLaunchKernelEx(&cfg, lstm_bwd_rec_kernel<TIn, TState, false>,
                           static_cast<const float*>(mask), static_cast<const TIn*>(gates),
                           static_cast<const TState*>(c), static_cast<const float*>(nullptr),
                           static_cast<const TState*>(gm), wsl, static_cast<const float*>(ph),
                           static_cast<TIn*>(dgifo), static_cast<float*>(part_rows), T, B, H,
                           units, rows, kres);
  if (err != cudaSuccess) return err;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = sum_rows(part_rows, dbph, B, 7LL * H, st)) != cudaSuccess) return err;
  // dW_x = x^T . dgifo: A(d, tb) = x[tb*D + d], B(tb, g) = dgifo[tb*G + g];
  // dW_m = m_prev^T . dgifo: m_prev at step t is the m carry at t-1, so
  // pair m rows [0, T-1) with dgifo rows [1, T);
  // dx = dgifo . W_x^T: A(tb, g) = dgifo[tb*G + g], B(g, d) = W_x[d*G + g]
  if constexpr (std::is_same<TIn, __nv_bfloat16>::value) {
    int ldx = D, ldg = G, ldm = H, ldw = G;
    if (x_pad != nullptr) {
      if ((err = pad_bf16(x, false, TB, D, D, x_pad, st)) != cudaSuccess) return err;
      x = x_pad;
      ldx = pad8(D);
    }
    const void* dg = dgifo;
    if (dg_pad != nullptr) {
      if ((err = pad_bf16(dgifo, false, TB, G, G, dg_pad, st)) != cudaSuccess) return err;
      dg = dg_pad;
      ldg = pad8(G);
    }
    if (m_pad != nullptr) {  // also the bf16 rounding of an f32 m carry
      err = pad_bf16(m, std::is_same<TState, float>::value, TB - B, H, H, m_pad, st);
      if (err != cudaSuccess) return err;
      m = m_pad;
      ldm = pad8(H);
    }
    if (wx_pad != nullptr) {
      if ((err = pad_bf16(wx, false, D, G, G, wx_pad, st)) != cudaSuccess) return err;
      wx = wx_pad;
      ldw = pad8(G);
    }
    err = gemm_bf16_run(x, true, ldx, dg, true, ldg, 0, part_wx, false, nullptr, D, G, (int)TB,
                        zx, st);
    if (err != cudaSuccess) return err;
    if ((err = sum_rows(part_wx, dwx, zx, (long long)D * G, st)) != cudaSuccess) return err;
    err = gemm_bf16_run(m, true, ldm, dg, true, ldg, B, part_wm, false, nullptr, H, G,
                        (int)(TB - B), zm, st);
    if (err != cudaSuccess) return err;
    if ((err = sum_rows(part_wm, dwm, zm, (long long)H * G, st)) != cudaSuccess) return err;
    return gemm_bf16_run(dg, false, ldg, wx, false, ldw, 0, dx, true, nullptr, (int)TB, D, G, 1,
                         st);
  } else {
    err = gemm<TIn, TIn, float>(x, 1, D, dgifo, G, 1, part_wx, nullptr, D, G, (int)TB, zx, st);
    if (err != cudaSuccess) return err;
    if ((err = sum_rows(part_wx, dwx, zx, (long long)D * G, st)) != cudaSuccess) return err;
    const TIn* dg1 = static_cast<const TIn*>(dgifo) + (size_t)B * G;
    err = gemm<TState, TIn, float>(m, 1, H, dg1, G, 1, part_wm, nullptr, H, G, (int)(TB - B), zm,
                                   st);
    if (err != cudaSuccess) return err;
    if ((err = sum_rows(part_wm, dwm, zm, (long long)H * G, st)) != cudaSuccess) return err;
    return gemm<TIn, TIn, TIn>(dgifo, G, 1, wx, 1, G, dx, nullptr, (int)TB, D, G, 1, st);
  }
}

}  // namespace

// Shared memory of the recurrence kernel for these sizes, in bytes.
extern "C" long long lstm_bwd_smem_bytes(int cluster, int rows, int units, int kres,
                                         int in_bf16) {
  return rec_smem_bytes(cluster, rows, units, kres, in_bf16 != 0);
}

// cudaOccupancyMaxActiveClusters for the recurrence kernel at this shape
// (state type f32), or minus the CUDA error.
extern "C" int lstm_bwd_max_clusters(int B, int H, int cluster, int rows, int units, int kres,
                                     int in_bf16) {
  int active = 0;
  const cudaError_t err =
      in_bf16
          ? max_clusters<__nv_bfloat16, float, false>(B, H, cluster, rows, units, kres, 0, &active)
          : max_clusters<float, float, false>(B, H, cluster, rows, units, kres, 0, &active);
  return err == cudaSuccess ? active : -(int)err;
}

// Runs the backward pass of one LSTM direction on `stream` (the recurrence
// on clusters of `cluster` CTAs, each cluster `rows` batch rows, each CTA
// `units` hidden units with `kres` rows of its W_m slice resident; then the
// per-row sums, the three products and the partial sums, in order); returns
// the first CUDA error (cudaErrorInvalidConfiguration when not even one
// cluster can be resident).  in_bf16: x/gates/W_x/dx/dgifo are bf16 and
// wsl is the bf16 slice layout (else f32); state_bf16: c/m/gm are bf16.
// zx, zm: k-slices of the dW_x and dW_m products (part_wx holds zx*D*4H
// floats, part_wm zm*H*4H).  Bf16 path: x_pad [T*B, D8], dg_pad [T*B, G8],
// m_pad [(T-1)*B, H8] and wx_pad [D, G8] (X8: X rounded up to 8, G = 4H)
// take zero-padded bf16 copies of x, dgifo, m and W_x, given where the
// caller found the operand's rows not whole 16-byte units or m not bf16
// (else null).
extern "C" int lstm_bwd(const void* x, const void* mask, const void* gates, const void* c,
                        const void* m, const void* gm, const void* wx, const void* wsl,
                        const void* ph, void* dx, void* dwx, void* dwm, void* dbph, void* dgifo,
                        void* part_rows, void* part_wx, void* part_wm, void* x_pad,
                        void* dg_pad, void* m_pad, void* wx_pad, int T, int B, int D, int H,
                        int in_bf16, int state_bf16, int cluster, int rows, int units, int kres,
                        int zx, int zm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_bf16) {
    err = state_bf16
              ? run<__nv_bfloat16, __nv_bfloat16>(x, mask, gates, c, m, gm, wx, wsl, ph, dx, dwx, dwm, dbph, dgifo, part_rows, part_wx, part_wm, x_pad, dg_pad, m_pad, wx_pad, T, B, D, H, cluster, rows, units, kres, zx, zm, st)
              : run<__nv_bfloat16, float>(x, mask, gates, c, m, gm, wx, wsl, ph, dx, dwx, dwm, dbph, dgifo, part_rows, part_wx, part_wm, x_pad, dg_pad, m_pad, wx_pad, T, B, D, H, cluster, rows, units, kres, zx, zm, st);
  } else {
    err = state_bf16
              ? run<float, __nv_bfloat16>(x, mask, gates, c, m, gm, wx, wsl, ph, dx, dwx, dwm, dbph, dgifo, part_rows, part_wx, part_wm, x_pad, dg_pad, m_pad, wx_pad, T, B, D, H, cluster, rows, units, kres, zx, zm, st)
              : run<float, float>(x, mask, gates, c, m, gm, wx, wsl, ph, dx, dwx, dwm, dbph, dgifo, part_rows, part_wx, part_wm, x_pad, dg_pad, m_pad, wx_pad, T, B, D, H, cluster, rows, units, kres, zx, zm, st);
  }
  return (int)err;
}

// cudaOccupancyMaxActiveClusters for kernel 5's instance of the recurrence
// at this shape, or minus the CUDA error.
extern "C" int lstm_scan_bwd_max_clusters(int B, int H, int cluster, int rows, int units,
                                          int kres) {
  int active = 0;
  const cudaError_t err =
      max_clusters<__nv_bfloat16, float, true>(B, H, cluster, rows, units, kres, 0, &active);
  return err == cudaSuccess ? active : -(int)err;
}

// Kernel 5 (the v1 route's backward; where this plan does not take H the
// route runs csrc/lstm_scan_bwd.cu): the reverse recurrence alone over kernel 4's
// residuals, on clusters shaped by ops/lstm_cuda.py bwd_plan(v1=True).
// mask [T,B] f32, gates [T,B,4H] bf16, c_raw, the c carry and gm [T,B,H]
// f32, wsl the bf16 slice layout of W_m (bwd_weight_slices), ph [3,H] f32;
// writes dxw [T,B,4H] f32, the gate gradients unrounded (dm's product takes
// them rounded to bf16).  Returns the first CUDA error
// (cudaErrorInvalidConfiguration when not even one cluster can be resident).
extern "C" int lstm_scan_bwd_rec(const void* mask, const void* gates, const void* craw,
                                 const void* c, const void* gm, const void* wsl, const void* ph,
                                 void* dxw, int T, int B, int H, int cluster, int rows, int units,
                                 int kres, void* stream) {
  using BF = __nv_bfloat16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      rec_ready<BF, float, true>(B, H, cluster, rows, units, kres, st, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, lstm_bwd_rec_kernel<BF, float, true>,
                           static_cast<const float*>(mask), static_cast<const BF*>(gates),
                           static_cast<const float*>(c), static_cast<const float*>(craw),
                           static_cast<const float*>(gm), wsl, static_cast<const float*>(ph),
                           static_cast<float*>(dxw), static_cast<float*>(nullptr), T, B, H,
                           units, rows, kres);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
