// Beam-search recombination for Hopper (sm_90a): beam threshold, Viterbi
// recombination per destination state, and top-K, in one kernel.
//
// Replaces the TPU kernel `_dedup_prune_kernel` (eesen_tpu/ops/beam_pallas.py:110)
// together with its `dedup_prune` wrapper (beam_pallas.py:141-183), and
// computes exactly what they compute.  A row's proposals are padded to
// Mp = next_pow2(max(m, 128)) lanes with score +inf.  A lane is *live* when
// its score (-0.0 read as +0.0) is at most (row minimum + beam), and it has
// the smallest (score, lane) of the live lanes with its dst.  The K output
// slots hold the live lanes in ascending (score, lane) order, then every
// other lane of the padded row in ascending lane order (state -1, score
// +inf), cut at K; kept = lane clamped to m-1.  A NaN score makes the row
// minimum, and so the threshold, NaN: no lane is live.  The plain version
// `dedup_prune_ref` in ops/beam_cuda.py gives the same three outputs bit for
// bit.
//
// Design.  One thread-block cluster of CLUSTER CTAs per batch row; CTA q
// owns lanes [q*Mp/8, (q+1)*Mp/8), a contiguous run of at most four a
// thread.  Nothing sorts the whole row:
//   1. the row minimum: a block reduction, then each CTA reads the others'
//      through distributed shared memory (DSMEM);
//   2. recombination by a hash table on dst, 2*Mp slots (load <= 0.5) split
//      over the CTAs' shared memory: an entry is claimed with atomicCAS on
//      its dst tag and keeps the atomicMin of the order-preserving bits of
//      the scores; after a barrier, the lanes that hold that minimum take
//      the atomicMin of their lane numbers, and after another the lane that
//      holds both is the winner.  (32-bit atomics only: a 64-bit atomicMin
//      on (score bits << 32 | lane) through DSMEM lost updates on the H100.)
//      A winner's key for the steps below is (score bits) << 32 | lane;
//   3. the K-th smallest live key by radix select: a histogram of one 8-bit
//      digit a pass (score bits 63..32, then lane bits 15..0) over the keys
//      that match the digits chosen so far, merged across the cluster; it
//      stops as soon as a bin holds exactly the keys still needed;
//   4. the survivors (at most K) are gathered into CTA 0, which sorts only
//      them (bitonic over next_pow2 of their count) and writes them;
//   5. the filler slots by a prefix sum of the not-live flags in lane order.
// Each step that reads another CTA's results follows one cluster barrier:
// 5 barriers, plus one per radix pass after the first.
//
// Bound.  The function moves B*Mp*8 bytes in and B*K*12 bytes out (~1 MB at
// B=8, Mp=16384), ~0.3 us at 3.35 TB/s.  The kernel is bound by the latency
// of its chain of cluster barriers and remote atomics, and by its launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;          // CTAs per row
constexpr int THREADS = 512;
constexpr int MAX_LANES = 16384;
constexpr int PER_THREAD = MAX_LANES / CLUSTER / THREADS;  // lanes a thread owns, at most
constexpr int EMPTY = (int)0x80000000;                      // a free table slot's tag
constexpr unsigned long long DEAD = ~0ull;                  // the key of a lane that is not live
constexpr unsigned FULL = 0xffffffffu;

typedef unsigned long long u64;

// float -> unsigned with the same order (for non-NaN values), and back
__device__ __forceinline__ unsigned ord_bits(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float from_ord(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// The minimum with NaN kept, as torch.min and jnp.min take it (fminf drops
// a NaN): a row with a NaN score gets a NaN threshold, so no lane is live.
__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) || isnan(b) ? CUDART_NAN_F : fminf(a, b);
}

// Exclusive prefix sum of v over the block's threads in thread order;
// *total gets the block's sum.  Every thread of the block must call it.
__device__ int block_excl_scan(int v, int* tmp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += n;
  }
  __syncthreads();  // tmp is free
  if (lane == 31) tmp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < THREADS / 32 ? tmp[lane] : 0;
    int wi = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(FULL, wi, o);
      if (lane >= o) wi += n;
    }
    if (lane < THREADS / 32) tmp[lane] = wi - w;
    if (lane == 31) tmp[32] = wi;
  }
  __syncthreads();
  *total = tmp[32];
  return tmp[warp] + incl - v;
}

// The field of table slot `slot` in the CTA that holds it.
template <typename T>
__device__ __forceinline__ T* entry(cg::cluster_group& cl, T* field, int slot, int TSL, int TS) {
  return slot < TS ? cl.map_shared_rank(field, slot / TSL) + slot % TSL
                   : cl.map_shared_rank(field, 0) + TSL;
}

// Claims (or finds) the table entry of dst d and lowers its score bits to
// `sbits`; returns the entry's slot.  Slots [0, TS) are spread over the
// cluster, TSL to a CTA; slot TS, in CTA 0, is kept for d == EMPTY.
__device__ __forceinline__ int table_insert(cg::cluster_group& cl, unsigned* tsc, int* ttag,
                                            int d, unsigned sbits, int TSL, int TS, int log_ts) {
  int slot = TS;
  if (d != EMPTY) {
    slot = (int)(((unsigned)d * 2654435761u) >> (32 - log_ts));
    while (true) {
      const int prev = atomicCAS(cl.map_shared_rank(ttag, slot / TSL) + slot % TSL, EMPTY, d);
      if (prev == EMPTY || prev == d) break;
      slot = (slot + 1) & (TS - 1);
    }
  }
  atomicMin(entry(cl, tsc, slot, TSL, TS), sbits);
  return slot;
}

// Bytes of the table region: score bits, lanes and tags of TSL+1 slots,
// reused by CTA 0 for the survivors (8 bytes each, next_pow2(K) of them)
// once the table is no longer read.
__host__ __device__ inline long long region_bytes(int Mp, int K) {
  const long long tsl = 2LL * Mp / CLUSTER;
  long long sp = 1;
  while (sp < K) sp <<= 1;
  const long long r = 12 * (tsl + 1) > 8 * sp ? 12 * (tsl + 1) : 8 * sp;
  return (r + 15) / 16 * 16;
}

__global__ void __launch_bounds__(THREADS)
    dedup_prune_kernel(const int* __restrict__ dst, const float* __restrict__ score,
                       int* __restrict__ states, float* __restrict__ scores,
                       int* __restrict__ kept, int M, int Mp, int K, float beam) {
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned hist[2][256];
  __shared__ int tmp[33];
  __shared__ float wmin[THREADS / 32];
  __shared__ float cta_min;
  __shared__ int cta_live;
  __shared__ int gathered;
  __shared__ int sel[3];  // the chosen bin, the count below it, its count

  const int q = (int)cl.block_rank();
  const int row = blockIdx.x / CLUSTER;
  const int tid = threadIdx.x, lane = tid & 31;
  const int L = Mp / CLUSTER;    // lanes of this CTA
  const int TSL = 2 * L;         // table slots of this CTA
  const int TS = TSL * CLUSTER;  // 2*Mp over the cluster
  const int log_ts = __ffs(TS) - 1;
  unsigned* tsc = reinterpret_cast<unsigned*>(smem_raw);  // [TSL+1] min score bits
  unsigned* tln = tsc + TSL + 1;                           // [TSL+1] min lane at that score
  int* ttag = reinterpret_cast<int*>(tln + TSL + 1);      // [TSL+1] dst
  u64* sbuf = reinterpret_cast<u64*>(smem_raw);           // CTA 0, after the table

  for (int i = tid; i <= TSL; i += THREADS) {
    tsc[i] = 0xffffffffu;
    tln[i] = 0xffffffffu;
    ttag[i] = EMPTY;
  }
  for (int i = tid; i < 512; i += THREADS) (&hist[0][0])[i] = 0;
  if (tid == 0) gathered = 0;

  // this thread's lanes: a contiguous run, so that step 5 runs in lane order
  const int per = (L + THREADS - 1) / THREADS;
  const int i0 = min(L, tid * per), n_own = min(L, i0 + per) - i0;
  const size_t base = (size_t)row * M;
  float s[PER_THREAD];
  int d[PER_THREAD];
  float best = CUDART_INF_F;
#pragma unroll
  for (int a = 0; a < PER_THREAD; ++a) {
    const int gl = q * L + i0 + a;
    s[a] = CUDART_INF_F;
    d[a] = 0;
    if (a < n_own && gl < M) {
      s[a] = score[base + gl] + 0.0f;  // -0.0 -> +0.0, as the plain version
      d[a] = dst[base + gl];
    }
    best = nan_min(best, s[a]);
  }
  // 1. the row minimum (NaN if any score is NaN)
  for (int o = 16; o > 0; o >>= 1) best = nan_min(best, __shfl_xor_sync(FULL, best, o));
  if (lane == 0) wmin[tid >> 5] = best;
  __syncthreads();
  if (tid < 32) {
    float v = tid < THREADS / 32 ? wmin[tid] : CUDART_INF_F;
    for (int o = 16; o > 0; o >>= 1) v = nan_min(v, __shfl_xor_sync(FULL, v, o));
    if (tid == 0) cta_min = v;
  }
  cl.sync();  // B1: tables initialised, CTA minima written
  float rmin = CUDART_INF_F;
  for (int r = 0; r < CLUSTER; ++r) rmin = nan_min(rmin, *cl.map_shared_rank(&cta_min, r));
  const float thr = rmin + beam;

  // 2. recombination: every lane within the beam lowers its dst's score,
  // then the lanes at that score lower its lane
  u64 key[PER_THREAD];
  int slot[PER_THREAD];
#pragma unroll
  for (int a = 0; a < PER_THREAD; ++a) {
    key[a] = DEAD;
    slot[a] = 0;
    if (a < n_own && s[a] <= thr && s[a] < CUDART_INF_F) {
      const unsigned sb = ord_bits(s[a]);
      key[a] = ((u64)sb << 32) | (unsigned)(q * L + i0 + a);
      slot[a] = table_insert(cl, tsc, ttag, d[a], sb, TSL, TS, log_ts);
    }
  }
  cl.sync();  // B2: every entry holds its best score
#pragma unroll
  for (int a = 0; a < PER_THREAD; ++a) {
    if (key[a] != DEAD) {
      if (*entry(cl, tsc, slot[a], TSL, TS) != (unsigned)(key[a] >> 32))
        key[a] = DEAD;
      else
        atomicMin(entry(cl, tln, slot[a], TSL, TS), (unsigned)key[a]);
    }
  }
  cl.sync();  // B3: and the first lane at that score
  int live = 0;
#pragma unroll
  for (int a = 0; a < PER_THREAD; ++a) {
    if (key[a] != DEAD) {
      if (*entry(cl, tln, slot[a], TSL, TS) != (unsigned)key[a]) {
        key[a] = DEAD;
      } else {
        ++live;
        atomicAdd(&hist[0][key[a] >> 56], 1u);  // radix pass 0, ahead of need
      }
    }
  }
  int total;
  block_excl_scan(live, tmp, &total);
  if (tid == 0) cta_live = total;
  cl.sync();  // B4: winners known; the table is no longer read
  int nlive = 0, live_below = 0;
  for (int r = 0; r < CLUSTER; ++r) {
    const int v = *cl.map_shared_rank(&cta_live, r);
    nlive += v;
    if (r < q) live_below += v;
  }

  // 5. the filler: the lanes that are not live, in lane order, after the live
  if (nlive < K) {
    int dead = 0;
#pragma unroll
    for (int a = 0; a < PER_THREAD; ++a) dead += a < n_own && key[a] == DEAD;
    int pos = nlive + (q * L - live_below) + block_excl_scan(dead, tmp, &total);
#pragma unroll
    for (int a = 0; a < PER_THREAD; ++a) {
      if (a < n_own && key[a] == DEAD) {
        if (pos < K) {
          const size_t o = (size_t)row * K + pos;
          states[o] = -1;
          scores[o] = CUDART_INF_F;
          kept[o] = min(q * L + i0 + a, M - 1);
        }
        ++pos;
      }
    }
  }

  // 3. radix select of the K-th smallest live key: the survivors are the
  // live keys with (key & mask) <= prefix (all of them when nlive <= K)
  u64 prefix = 0, mask = 0;
  if (nlive > K) {
    int rem = K;
    const int shifts[6] = {56, 48, 40, 32, 8, 0};  // lanes < 2^14: bits 31..16 are 0
    for (int p = 0; p < 6; ++p) {
      const int buf = p & 1, sh = shifts[p];
      if (p > 0) {
        for (int i = tid; i < 256; i += THREADS) hist[buf][i] = 0;
        __syncthreads();
#pragma unroll
        for (int a = 0; a < PER_THREAD; ++a)
          if (key[a] != DEAD && (key[a] & mask) == prefix)
            atomicAdd(&hist[buf][(key[a] >> sh) & 255], 1u);
        cl.sync();  // every CTA's histogram of this digit is complete
      }
      int cnt = 0;
      if (tid < 256)
        for (int r = 0; r < CLUSTER; ++r) cnt += (int)*cl.map_shared_rank(&hist[buf][tid], r);
      const int below = block_excl_scan(cnt, tmp, &total);
      if (tid < 256 && below < rem && rem <= below + cnt) {
        sel[0] = tid;
        sel[1] = below;
        sel[2] = cnt;
      }
      __syncthreads();
      rem -= sel[1];
      prefix |= (u64)sel[0] << sh;
      mask = DEAD << sh;
      const bool done = sel[2] == rem;
      __syncthreads();  // sel is rewritten next pass
      if (done) break;
    }
  }

  // 4. the survivors into CTA 0 (one atomic a warp), then its sort
  u64* sb0 = cl.map_shared_rank(sbuf, 0);
  int* n0 = cl.map_shared_rank(&gathered, 0);
#pragma unroll
  for (int a = 0; a < PER_THREAD; ++a) {
    const bool surv = key[a] != DEAD && (key[a] & mask) <= prefix;
    const unsigned bal = __ballot_sync(FULL, surv);
    if (bal != 0) {
      const int leader = __ffs(bal) - 1;
      int at = 0;
      if (lane == leader) at = atomicAdd(n0, __popc(bal));
      at = __shfl_sync(FULL, at, leader);
      if (surv) sb0[at + __popc(bal & ((1u << lane) - 1u))] = key[a];
    }
  }
  cl.sync();  // B5: CTA 0 holds every survivor; no CTA reads another after this
  if (q != 0) return;
  const int n = min(nlive, K);
  int sp = 1;
  while (sp < n) sp <<= 1;
  for (int i = n + tid; i < sp; i += THREADS) sbuf[i] = DEAD;
  __syncthreads();
  for (int k = 2; k <= sp; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = tid; p < sp / 2; p += THREADS) {
        const int i = 2 * p - (p & (j - 1));  // p-th index with bit j clear
        const int i2 = i + j;
        const bool up = (i & k) == 0;
        if ((sbuf[i] > sbuf[i2]) == up) {
          const u64 t = sbuf[i];
          sbuf[i] = sbuf[i2];
          sbuf[i2] = t;
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < n; i += THREADS) {
    const u64 k = sbuf[i];
    const int ln = (int)(k & 0xffffffffu);
    const size_t o = (size_t)row * K + i;
    scores[o] = from_ord((unsigned)(k >> 32));
    states[o] = dst[base + ln];
    kept[o] = min(ln, M - 1);
  }
}

}  // namespace

// Dynamic shared memory of the kernel for these sizes, in bytes (mirrored
// by ops/beam_cuda.py smem_bytes).
extern "C" long long dedup_prune_smem_bytes(int Mp, int K) { return region_bytes(Mp, K); }

// Readies the kernel on the current device for rows padded to Mp lanes and K
// survivors: raises its dynamic shared-memory allowance to this shape's
// size where it was lower (so that every shape readied before still fits)
// and returns how many of its clusters can be resident, or minus the first
// CUDA error (-cudaErrorInvalidConfiguration when none can).  Called once
// per device and shape before dedup_prune, and outside any stream capture.
extern "C" int dedup_prune_ready(int Mp, int K) {
  if (Mp < 128 || Mp > MAX_LANES || (Mp & (Mp - 1)) != 0 || K < 1 || K > Mp)
    return -(int)cudaErrorInvalidValue;
  const int smem = (int)region_bytes(Mp, K);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, dedup_prune_kernel);
  if (err != cudaSuccess) return -(int)err;
  if (fa.maxDynamicSharedSizeBytes < smem) {
    err = cudaFuncSetAttribute(dedup_prune_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return -(int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, dedup_prune_kernel, &cfg);
  if (err != cudaSuccess) return -(int)err;
  if (active < 1) return -(int)cudaErrorInvalidConfiguration;
  return active;
}

// Launches the recombination of B rows of M proposals on `stream`, one
// cluster of 8 CTAs a row, with the kernel readied for (Mp, K) by
// dedup_prune_ready; returns the first CUDA error.  Mp is the padded
// power-of-two width (128 <= Mp <= 16384, Mp >= M), 1 <= K <= Mp.  It makes
// no query of the device, so a stream capture takes it.
extern "C" int dedup_prune(const void* dst, const void* score, void* states, void* scores,
                           void* kept, int B, int M, int Mp, int K, float beam, void* stream) {
  if (Mp < 128 || Mp > MAX_LANES || (Mp & (Mp - 1)) != 0 || M > Mp || K < 1 || K > Mp)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)region_bytes(Mp, K);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, dedup_prune_kernel, static_cast<const int*>(dst),
                                       static_cast<const float*>(score), static_cast<int*>(states),
                                       static_cast<float*>(scores), static_cast<int*>(kept), M,
                                       Mp, K, beam);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
