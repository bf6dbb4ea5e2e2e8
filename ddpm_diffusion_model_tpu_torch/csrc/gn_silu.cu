// GroupNorm + SiLU with an optional per-(image, channel) time bias, forward
// (gn_silu_fwd) and backward (gn_silu_bwd, further down).
// Target: sm_90a (H100).  Plain C interface, loaded with ctypes by
// ddpm_diffusion_model_tpu_torch/ops/fused_norm.py.
//
// The forward replaces the TPU kernels _moments_kernel (fused_norm.py:115) and
// _apply_kernel (fused_norm.py:127) of ddpm_diffusion_model_tpu/ops, with the
// XLA glue _channel_stats (fused_norm.py:134) between them:
//     u = x + tb[b, c]                       (tb optional, added in fp32)
//     mu, var per (b, group) over (H, W, C/G) in fp32
//     y = silu((u - mu) * rsqrt(var + eps) * gamma[c] + beta[c])   in x.dtype
// and it also writes mu and rstd per (b, c), as the TPU forward saves them
// for the backward.
//
// What bounds it on the card: bytes.  Per call it must read x once and write
// y once (2 * B*H*W*C * itemsize) and does ~10 flops and two SFU operations
// per element, far below the ~295 flops/byte where an H100 turns
// compute-bound.
//
// Design.  The tensor is NHWC, so a pixel's C channels are contiguous and a
// group's are not: a block owns a chunk of one image's pixels across all C
// channels, which is one contiguous run of memory.  The chunk streams
// through shared memory in tiles of whole pixel rows (16 KB): 16-byte
// cp.async copies, neighbouring threads on neighbouring addresses.  A
// thread keeps one column of 16 bytes (8 channels of bf16, 4 of fp32) with
// their constants in registers; C wider than 256 columns goes in passes.
// The blocks that share an image form a thread-block cluster of 1, 2, 4, 8
// or 16 (the plan, _gn_fwd_plan in ops/fused_norm.py):
//   sweep 1  sums d = u - K_c and d^2 per channel in registers (S1, S2),
//            K_c the channel's first value u[b, 0, c] of the image, then
//            over the block's pixel lanes in shared memory in a fixed order
//            (from here on in fp64, each sum rounded to fp32 where stored);
//   cluster  every block reads every block's per-channel partials through
//            distributed shared memory in rank order and folds them per
//            group channel by channel in fp64 (bit-equal across blocks and
//            runs, no atomics): sum u = S1 + HW K_c, sum u^2 = S2 +
//            K_c (2 S1 + HW K_c), mu = sum u / n, var = sum u^2 / n - mu^2;
//            rank 0 writes mu and rstd;
//   sweep 2  y = silu((x - (mu - tb)) * gamma rstd + beta), SiLU by the
//            SFU's ex2.approx and rcp.approx, 16-byte stores.
// The shift makes the one-pass variance exact where E[u^2] - mu^2 in fp32
// (the TPU path's, fused_norm.py:143) cancels: K_c is a value of the
// channel, so the fp32 sums of d stay of the order of the channel's spread
// (whatever the mean and the time bias), and the rest is exact in fp64
// (checked at mean 1000, std 2).
// Where every tile of the chunk fits in shared memory (in_smem, the
// "resident" route), sweep 1 issues up to 6 tiles ahead and leaves them
// there, and sweep 2 reads them from there, so x leaves HBM once; elsewhere
// (the "re-read" route) sweep 1 streams the chunk through a ring of 3
// stages and sweep 2 re-reads it through the ring last tile first (the
// tiles read last are the likeliest still in L2), its first tiles issued
// before the cluster reduction.  A row that is not whole 16-byte units, or
// an operand not 16-byte aligned, takes the same kernel with element copies
// and one channel per thread.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>

#include "mma_bf16.cuh"

namespace {

namespace cg = cooperative_groups;
using mma_bf16::cp_async16;
using mma_bf16::cp_async_commit;
using mma_bf16::cp_async_wait;

constexpr int kMaxCluster = 16;
constexpr int kRingStages = 3;             // tiles of the ring: 2 in flight
constexpr size_t kMaxSmem = 232448;        // an H100 block's shared memory
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// 2^x and 1/x on the SFU (2 ulp and 1 ulp; 2^x of a large x is +inf, and
// 1/inf is 0, so sig(z) saturates to 0 and 1 without a NaN).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Wait until at most n of this thread's cp.async groups are pending (n
// past 7 waits for 7: longer than asked, never shorter).
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// The cluster barrier in two halves: arrive (release), then wait (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Sum over the block's pixel lanes, in lane order, of the per-thread
// partials red[(lane * cw + column) * V + i]; stride = cw * V; summed in A.
template <typename A = float>
__device__ __forceinline__ A lane_sum(const float* red, int ch, int ppi, int stride) {
  A t = 0;
  for (int l = 0; l < ppi; ++l) t += red[l * stride + ch];
  return t;
}

// Sum over the cluster's blocks, in rank order, of element ch of the
// array `a` in each block's shared memory (all loads issued first), in A.
template <typename A = float>
__device__ __forceinline__ A rank_sum(cg::cluster_group& cluster, float* a, int ch,
                                      int ranks) {
  A t = 0;
  for (int r0 = 0; r0 < ranks; r0 += 4) {  // 4 loads in flight at a time
    float v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (r0 + r < ranks) v[r] = cluster.map_shared_rank(a, r0 + r)[ch];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (r0 + r < ranks) t += v[r];
  }
  return t;
}

// Launches whose cluster was found to fit (cudaOccupancyMaxActiveClusters
// >= 1), so the query runs once per kernel, cluster size and shared memory.
struct Fit {
  const void* kern;
  int cluster;
  size_t smem;
};
std::mutex fit_lock;
Fit fits[64];
int n_fits = 0;

template <typename K>
cudaError_t check_cluster_fits(K kern, const cudaLaunchConfig_t& cfg, int cluster) {
  const void* key = reinterpret_cast<const void*>(kern);
  std::lock_guard<std::mutex> hold(fit_lock);
  for (int i = 0; i < n_fits; ++i)
    if (fits[i].kern == key && fits[i].cluster == cluster && fits[i].smem == cfg.dynamicSmemBytes)
      return cudaSuccess;
  int n = 0;
  cudaError_t e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  if (e != cudaSuccess) return e;
  if (n < 1) return cudaErrorInvalidConfiguration;  // the cluster cannot be scheduled
  if (n_fits < 64) fits[n_fits++] = Fit{key, cluster, cfg.dynamicSmemBytes};
  return cudaSuccess;
}

// Launch kern on a (cluster, B) grid of `threads`-thread blocks with
// `smem` bytes of dynamic shared memory, the blocks of each image one
// cluster (past 8 with the non-portable attribute), after checking that
// such a cluster can be scheduled.
template <typename K, typename... Args>
int launch_clustered(K kern, int cluster, int B, int threads, size_t smem, cudaStream_t s,
                     Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (cluster > 8) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = check_cluster_fits(kern, cfg, cluster);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// ---------------------------------------------------------------- forward

constexpr int kFwdThreads = 256;      // at most; cw * ppi exactly
constexpr int kFwdStageBytes = 16384;  // x of one tile, at most
constexpr int kFwdAhead = 6;           // resident route: tiles in flight

// The shared-memory layout of a forward launch (mirrored by _gn_fwd_smem
// in ops/fused_norm.py): scratch first (the two per-group sums in fp64,
// two pass-wide fp32 reduction buffers, two fp32 per-channel partials, the
// pass's shifts K_c) rounded up to 16 bytes, then `stages` tiles of `tile`
// pixels of x (the ring, or when in_smem every tile of the chunk).  The
// scratch is sized for 16-byte columns whatever route runs.  A ring too
// large for the block drops to 2 stages.
struct FwdSmem {
  int tile, stages;
  size_t ring_off, bytes;
};

FwdSmem fwd_smem(int C, int G, int chunk, bool in_smem, int itemsize) {
  const size_t row = (size_t)C * itemsize;
  int tile = (int)(kFwdStageBytes / row);
  tile = tile < 1 ? 1 : (tile > chunk ? chunk : tile);
  const int pass = kFwdThreads * (16 / itemsize);
  const size_t scratch = sizeof(double) * 2 * (size_t)G
      + sizeof(float) * (2 * (size_t)pass + 3 * (size_t)(C < pass ? C : pass));
  const size_t off = (scratch + 15) / 16 * 16;
  int stages = in_smem ? (chunk + tile - 1) / tile : kRingStages;
  while (!in_smem && stages > 2 && off + stages * tile * row > kMaxSmem) --stages;
  return {tile, stages, off, off + (size_t)stages * tile * row};
}

// V = 16 / sizeof(T): rows of whole 16-byte units, copied by 16-byte
// cp.async, a 16-byte column per thread; V = 1: element copies and one
// channel per thread.
template <typename T, int V, bool SMEM>
__global__ void __launch_bounds__(kFwdThreads, 3) gn_silu_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ tb,
    T* __restrict__ y, float* __restrict__ mean_out, float* __restrict__ rstd_out,
    int HW, int C, int G, int chunk, int tile, int stages, int ring_off, float eps) {
  using P = Pack<T, V>;
  constexpr int kPass = kFwdThreads * (16 / sizeof(T));  // the scratch's pass width
  extern __shared__ __align__(16) unsigned char smem[];
  const int pw = min(C, kPass);
  double* gs1 = reinterpret_cast<double*>(smem);  // per group: sum u, then mu
  double* gs2 = gs1 + G;                          // per group: sum u^2, then rstd
  float* red1 = reinterpret_cast<float*>(gs2 + G);
  float* red2 = red1 + kPass;
  float* part1 = red2 + kPass;  // read by the other blocks of the cluster
  float* part2 = part1 + pw;
  float* kc = part2 + pw;  // the pass's K_c
  T* ring = reinterpret_cast<T*>(smem + ring_off);  // [stages][tile][C]
  const int tile_n = tile * C;

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int rank = blockIdx.x, ranks = gridDim.x, b = blockIdx.y;
  const int p0 = rank * chunk;
  const int npx = max(0, min(chunk, HW - p0));  // this block's pixels
  const int ntiles = (npx + tile - 1) / tile;
  const int cg_ = C / G;
  const int CV = C / V;                          // accesses per pixel
  const int cw = min(CV, kFwdThreads);           // access columns per pass
  const int ppi = nt / cw;                       // pixel lanes (nt = cw * ppi)
  const int vc = tid % cw, pl = tid / cw;
  const int64_t bc = (int64_t)b * C;
  const T* x0 = x + (int64_t)b * HW * C;  // the image's first pixel
  const T* xg = x0 + (int64_t)p0 * C;
  T* yg = y + ((int64_t)b * HW + p0) * C;
  const float* tbb = tb ? tb + bc : nullptr;
  // tiles in flight ahead of the one computed
  const int ahead = SMEM ? kFwdAhead : stages - 1;
  bool pending = false;  // an arrive on the cluster barrier not yet waited for

  // A sweep visits the tiles in order j = 0, 1, ...: tile j, or, for sweep
  // 2 through the ring, tile ntiles-1-j.  The j-th tile is in stage j of
  // the ring (or, in_smem, at its own place).
  auto tile_at = [&](int j, bool rev) { return rev ? ntiles - 1 - j : j; };
  auto stage_x = [&](int j) { return ring + (size_t)(SMEM ? j : j % stages) * tile_n; };
  // copy the j-th tile to its stage; one commit group per tile (empty past
  // the last)
  auto fetch = [&](int j, bool rev) {
    if (j < ntiles) {
      T* dst = stage_x(j);
      const int t = tile_at(j, rev);
      const int64_t off = (int64_t)t * tile_n;
      const int n = min(tile, npx - t * tile) * C;
      if constexpr (V > 1) {
        constexpr int E = 16 / sizeof(T);
        for (int i = tid * E; i < n; i += nt * E) cp_async16(dst + i, xg + off + i, 16);
      } else {
        for (int i = tid; i < n; i += nt) dst[i] = xg[off + i];
      }
    }
    cp_async_commit();
  };
  // the first tiles of a sweep: in flight while the block reads its
  // constants (or, for sweep 2, while the cluster reduces sweep 1)
  auto prologue = [&](bool rev) {
    __syncthreads();  // the stages are free
    for (int j = 0; j < ahead; ++j) fetch(j, rev);
  };

  for (int i = tid; i < 2 * G; i += nt) gs1[i] = 0.0;

  // sweep 1: sum d and d^2 per channel, pass by pass; from the threads'
  // fp32 sums on, the sums of sums and mu, var and rstd are taken in fp64
  for (int cb = 0; cb < CV; cb += cw) {
    const int ncol = min(cw, CV - cb);
    const int cpass = cb * V, wpass = ncol * V;  // the pass's channels
    const int c0 = (cb + vc) * V;                // this thread's channels
    const bool active = vc < ncol;
    const bool load = !SMEM || cb == 0;  // in_smem: the chunk stays after pass 0
    if (load) prologue(false);
    // d = x + (tb - K_c), K_c = u of the channel at pixel 0
    float off[V], a1[V], a2[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = active ? c0 + i : 0;
      const float t = tbb ? tbb[c] : 0.f;
      const float K = to_f(x0[c]) + t;
      off[i] = t - K;
      a1[i] = a2[i] = 0.f;
      if (active && pl == 0) kc[c - cpass] = K;
    }
    for (int j = 0; j < ntiles; ++j) {
      if (load) {
        cp_async_wait_n(ahead - 1);  // tile j has landed
        __syncthreads();             // tile j is visible; tile j-1's stage is free
        fetch(j + ahead, false);
      }
      const T* xt = stage_x(j);
      const int rows = min(tile, npx - j * tile);
      if (active) {
#pragma unroll 2
        for (int p = pl; p < rows; p += ppi) {
          const P xv = *reinterpret_cast<const P*>(xt + p * C + c0);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float d = to_f(xv.v[i]) + off[i];
            a1[i] += d;
            a2[i] = fmaf(d, d, a2[i]);
          }
        }
      }
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        red1[tid * V + i] = a1[i];
        red2[tid * V + i] = a2[i];
      }
    }
    if (!SMEM && cb + cw >= CV) prologue(true);  // sweep 2's first tiles
    __syncthreads();
    if (pending) {  // every block has read the previous pass's partials
      cluster_wait();
      pending = false;
    }
    for (int ch = tid; ch < wpass; ch += nt) {
      part1[ch] = (float)lane_sum<double>(red1, ch, ppi, cw * V);
      part2[ch] = (float)lane_sum<double>(red2, ch, ppi, cw * V);
    }
    cluster_arrive();
    cluster_wait();  // every block's partials are written and visible
    // the image's per-channel sums, rank by rank in a fixed order
    for (int ch = tid; ch < wpass; ch += nt) {
      red1[ch] = (float)rank_sum<double>(cluster, part1, ch, ranks);
      red2[ch] = (float)rank_sum<double>(cluster, part2, ch, ranks);
    }
    cluster_arrive();  // done with the other blocks' partials
    pending = true;
    __syncthreads();
    // sum u and sum u^2 per group, channel by channel
    const double hw = HW;
    const int g_lo = cpass / cg_, g_hi = (cpass + wpass - 1) / cg_;
    for (int grp = g_lo + tid; grp <= g_hi; grp += nt) {
      const int lo = max(grp * cg_, cpass), hi = min((grp + 1) * cg_, cpass + wpass);
      double s1 = gs1[grp], s2 = gs2[grp];
      for (int c = lo; c < hi; ++c) {
        const double k = kc[c - cpass], t1 = red1[c - cpass];
        s1 += t1 + hw * k;
        s2 += red2[c - cpass] + k * (2.0 * t1 + hw * k);
      }
      gs1[grp] = s1;
      gs2[grp] = s2;
    }
    __syncthreads();
  }

  // mu and rstd per group (every block alike, rounded to fp32), written by
  // rank 0
  const double n = double(HW) * double(cg_);
  for (int grp = tid; grp < G; grp += nt) {
    const double m = gs1[grp] / n;
    const double var = fmax(gs2[grp] / n - m * m, 0.0);
    gs1[grp] = (float)m;
    gs2[grp] = (float)(1.0 / sqrt(var + (double)eps));
  }
  __syncthreads();
  if (rank == 0)
    for (int c = tid; c < C; c += nt) {
      mean_out[bc + c] = (float)gs1[c / cg_];
      rstd_out[bc + c] = (float)gs2[c / cg_];
    }

  // sweep 2: y, pass by pass
  for (int cb = 0; cb < CV; cb += cw) {
    const int ncol = min(cw, CV - cb);
    const int c0 = (cb + vc) * V;
    const bool active = vc < ncol;
    // z = (x - (mu - tb)) * (gamma rstd) + beta
    float mc[V], za[V], zb[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = active ? c0 + i : 0;
      const int grp = c / cg_;
      mc[i] = (float)gs1[grp] - (tbb ? tbb[c] : 0.f);
      za[i] = gamma[c] * (float)gs2[grp];
      zb[i] = beta[c];
    }
    if (!SMEM && cb > 0) prologue(true);  // pass 0's was issued before the reduction
    for (int j = 0; j < ntiles; ++j) {
      if (!SMEM) {
        cp_async_wait_n(ahead - 1);
        __syncthreads();
        fetch(j + ahead, true);
      }
      const T* xt = stage_x(j);
      const int t = tile_at(j, !SMEM);
      const int rows = min(tile, npx - t * tile);
      T* out = yg + (int64_t)t * tile_n;
      if (active) {
#pragma unroll 2
        for (int p = pl; p < rows; p += ppi) {
          const P xv = *reinterpret_cast<const P*>(xt + p * C + c0);
          P o;
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float z = fmaf(to_f(xv.v[i]) - mc[i], za[i], zb[i]);
            from_f(&o.v[i], z * rcp_approx(1.f + exp2_approx(z * -kLog2e)));
          }
          *reinterpret_cast<P*>(out + p * C + c0) = o;
        }
      }
    }
  }
  if (pending) cluster_wait();  // no block leaves while its partials may be read
}

template <typename T, int V>
int launch_fwd(bool in_smem, const void* x, const float* ga, const float* be,
               const float* t, void* y, float* mu, float* rs, int B, int HW, int C, int G,
               int cluster, int chunk, FwdSmem sm, float eps, cudaStream_t s) {
  const int cw = C / V < kFwdThreads ? C / V : kFwdThreads;
  const int threads = cw * (kFwdThreads / cw);  // column x pixel lanes
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const int off = (int)sm.ring_off;
  return in_smem
             ? launch_clustered(gn_silu_fwd_kernel<T, V, true>, cluster, B, threads, sm.bytes, s,
                                xp, ga, be, t, yp, mu, rs, HW, C, G, chunk, sm.tile,
                                sm.stages, off, eps)
             : launch_clustered(gn_silu_fwd_kernel<T, V, false>, cluster, B, threads, sm.bytes,
                                s, xp, ga, be, t, yp, mu, rs, HW, C, G, chunk, sm.tile,
                                sm.stages, off, eps);
}

}  // namespace

// x, y: (B, H*W, C) contiguous (NHWC), fp32 (is_bf16 = 0) or bf16 (1).
// gamma, beta: (C,) fp32.  tb: (B, C) fp32 or NULL.  mean, rstd: (B, C) fp32
// outputs.  The plan (_gn_fwd_plan in ops/fused_norm.py): cluster blocks
// per image (1, 2, 4, 8 or 16), each owning chunk pixels (chunk * cluster
// >= H*W), and in_smem = 1 to keep the chunk in shared memory between the
// two sweeps.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int gn_silu_fwd(const void* x, const void* gamma, const void* beta,
                           const void* tb, void* y, void* mean, void* rstd,
                           int B, int HW, int C, int G, int cluster, int chunk,
                           int in_smem, float eps, int is_bf16, void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0 || G <= 0 || C % G != 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) || chunk < 1
      || (int64_t)chunk * cluster < HW)
    return (int)cudaErrorInvalidValue;
  const int itemsize = is_bf16 ? 2 : 4;
  const FwdSmem sm = fwd_smem(C, G, chunk, in_smem != 0, itemsize);
  if (sm.bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  // 16-byte copies and columns where rows are whole 16-byte units and the
  // pointers 16-byte aligned, else element copies
  const bool vec = (C * itemsize) % 16 == 0 && aligned(x) && aligned(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  const float* t = static_cast<const float*>(tb);
  float* mu = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  const bool res = in_smem != 0;
  if (is_bf16)
    return vec ? launch_fwd<__nv_bfloat16, 8>(res, x, ga, be, t, y, mu, rs, B, HW, C, G,
                                              cluster, chunk, sm, eps, s)
               : launch_fwd<__nv_bfloat16, 1>(res, x, ga, be, t, y, mu, rs, B, HW, C, G,
                                              cluster, chunk, sm, eps, s);
  return vec ? launch_fwd<float, 4>(res, x, ga, be, t, y, mu, rs, B, HW, C, G, cluster,
                                    chunk, sm, eps, s)
             : launch_fwd<float, 1>(res, x, ga, be, t, y, mu, rs, B, HW, C, G, cluster, chunk,
                                    sm, eps, s);
}

// ---------------------------------------------------------------- backward
//
// Replaces the TPU kernels _bwd_partial_kernel (fused_norm.py:215),
// _bwd_apply_kernel (fused_norm.py:244) and _bwd_apply_kernel_nodtb
// (fused_norm.py:255), with the XLA glue between them (fused_norm.py:291-301).
// From the forward's saved fp32 mean and rstd per (b, c):
//     xhat = (x + tb - mu) * rstd,  z = xhat * gamma + beta
//     dz   = dy * sig(z) * (1 + z * (1 - sig(z)))          (SiLU')
//     S1[b, c] = sum_hw dz,  S2[b, c] = sum_hw dz * xhat    (fp32, written)
//     m1 = sum_{c in g} gamma S1 / n,  m2 = sum_{c in g} gamma S2 / n
//     du = (dz * gamma - m1 - xhat * m2) * rstd
//     dx = du in x.dtype;  dtb[b, c] = sum_hw du            (when asked)
// dgamma = sum_b S2 and dbeta = sum_b S1 are left to one torch sum over B
// in the wrapper, as the TPU path leaves them to XLA.
//
// What bounds it on the card: bytes.  It must read x and dy and write dx
// once (3 * B*H*W*C * itemsize) plus the (B, C) fp32 vectors; ~30 flops
// and two exps and reciprocals per element over the two sweeps, under the
// flops/byte where an H100 turns compute-bound.
//
// Design.  The tensor is NHWC, so a pixel's C channels are contiguous and a
// group's are not: a block owns a chunk of one image's pixels across all C
// channels.  The chunk streams through shared memory in tiles of whole
// pixel rows (16 KB of x and dy): 16-byte cp.async copies, neighbouring
// threads on neighbouring addresses, in a ring of 3 stages, so two tiles
// are in flight while one is computed without holding registers.  A thread
// keeps one column of 4 channels (16 bytes of fp32, 8 of bf16 from shared
// memory) with their affine, mean and rstd folded into 6 constants in
// registers; C wider than 1,024 channels goes in passes.  The blocks that
// share an image form a thread-block cluster of 1, 2, 4, 8 or 16 (the plan,
// _gn_bwd_plan in ops/fused_norm.py):
//   sweep 1  recomputes z and dz, sums S1, S2 per channel in registers, then
//            over the block's pixel lanes in shared memory in a fixed order;
//   cluster  every block reads every block's partials through distributed
//            shared memory in rank order, so every block holds the image's
//            S1, S2 (bit-equal across blocks and runs, no atomics), rank 0
//            writes them, and each block forms m1, m2 per group; sweep 2's
//            first tiles are already in flight;
//   sweep 2  recomputes dz and writes dx, visiting the tiles last to first
//            (those read last are the likeliest still in L2); dtb's
//            per-channel sum of du is reduced as S1 and written by rank 0.
// Where every tile of the chunk fits in shared memory beside two more
// blocks (in_smem), sweep 1 leaves them there and sweep 2 reads them from
// there, so x and dy leave HBM once; elsewhere sweep 2 re-reads the chunk
// through the ring.  A row that is not whole 16-byte units, or an operand
// not 16-byte aligned, takes the same kernel with element copies and one
// channel per thread.  80 registers and at most 77 KB of shared memory:
// 3 blocks of 256 threads per SM.

namespace {

constexpr int kBwdThreads = 256;           // at most; cw * ppi exactly
constexpr int kMaxPass = kBwdThreads * 4;  // channels of one pass, at most
constexpr int kStageBytes = 16384;         // x and dy of one tile, at most

// The shared-memory layout of a launch (mirrored by _gn_bwd_smem in
// ops/fused_norm.py): `stages` tiles of `tile` pixels of x and dy (the
// ring, or when in_smem every tile of the chunk), then fp32 scratch: two
// pass-wide reduction buffers, two per-channel partials, the two
// per-group sums.  A ring too large for the block drops to 3, then 2
// stages.
struct BwdSmem {
  int tile, stages;
  size_t bytes;
};

BwdSmem bwd_smem(int C, int G, int chunk, bool in_smem, int itemsize) {
  const size_t row = 2 * (size_t)C * itemsize;  // x and dy of one pixel
  int tile = (int)(kStageBytes / row);
  tile = tile < 1 ? 1 : (tile > chunk ? chunk : tile);
  const size_t scratch =
      sizeof(float) * (2 * (size_t)kMaxPass + 2 * (size_t)(C < kMaxPass ? C : kMaxPass)
                       + 2 * (size_t)G);
  int stages = in_smem ? (chunk + tile - 1) / tile : kRingStages;
  while (!in_smem && stages > 2 && scratch + stages * tile * row > kMaxSmem) --stages;
  return {tile, stages, scratch + (size_t)stages * tile * row};
}

// SiLU'(z) = sig(z) (1 + z (1 - sig(z))) = sig + z (sig - sig^2)
__device__ __forceinline__ float silu_grad(float z) {
  const float sg = rcp_approx(1.f + exp2_approx(z * -kLog2e));
  return fmaf(z, fmaf(-sg, sg, sg), sg);
}

// V = 4: rows of whole 16-byte units, copied by 16-byte cp.async, and 4
// channels per thread (16 bytes of fp32, 8 of bf16, from shared memory);
// V = 1: element copies and one channel per thread.
template <typename T, int V, bool SMEM>
__global__ void __launch_bounds__(kBwdThreads, 3) gn_silu_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dy,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    const float* __restrict__ tb, const float* __restrict__ mean,
    const float* __restrict__ rstd, T* __restrict__ dx,
    float* __restrict__ s1_out, float* __restrict__ s2_out,
    float* __restrict__ dtb_out, int HW, int C, int G, int chunk, int tile, int stages) {
  using P = Pack<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // [stages][x, dy][tile][C]
  const int tile_n = tile * C;           // elements of one tile of x (or dy)
  float* red1 = reinterpret_cast<float*>(ring + (size_t)stages * 2 * tile_n);
  float* red2 = red1 + kMaxPass;
  float* part1 = red2 + kMaxPass;  // read by the other blocks of the cluster
  float* part2 = part1 + (C < kMaxPass ? C : kMaxPass);
  float* mg1 = part2 + (C < kMaxPass ? C : kMaxPass);
  float* mg2 = mg1 + G;

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int rank = blockIdx.x, ranks = gridDim.x, b = blockIdx.y;
  const int p0 = rank * chunk;
  const int npx = max(0, min(chunk, HW - p0));  // this block's pixels
  const int ntiles = (npx + tile - 1) / tile;
  const int cg_ = C / G;
  const int CV = C / V;                          // accesses per pixel
  const int cw = min(CV, kBwdThreads);           // access columns per pass
  const int ppi = nt / cw;                       // pixel lanes (nt = cw * ppi)
  const int vc = tid % cw, pl = tid / cw;
  const int64_t bc = (int64_t)b * C;
  const int64_t img = ((int64_t)b * HW + p0) * C;
  const T* xg = x + img;
  const T* dyg = dy + img;
  T* dxg = dx + img;
  const float inv_n = 1.f / (float(HW) * float(cg_));
  // tiles in flight ahead of the one computed: the ring's stages less one
  const int ahead = SMEM ? kRingStages - 1 : stages - 1;
  bool pending = false;  // an arrive on the cluster barrier not yet waited for

  // A sweep visits the tiles in order j = 0, 1, ...: tile j, or, for sweep
  // 2 through the ring, tile ntiles-1-j (the last tiles read are the likeliest
  // still in L2).  The j-th tile's x is in stage j of the ring (or, in_smem,
  // at its own place), its dy at + tile_n.
  auto tile_at = [&](int j, bool rev) { return rev ? ntiles - 1 - j : j; };
  auto stage_x = [&](int j) { return ring + (size_t)(SMEM ? j : j % stages) * 2 * tile_n; };
  // copy the j-th tile's x and dy to its stage; one commit group per tile
  // (empty past the last)
  auto fetch = [&](int j, bool rev) {
    if (j < ntiles) {
      T* dst = stage_x(j);
      const int t = tile_at(j, rev);
      const int64_t off = (int64_t)t * tile_n;
      const int n = min(tile, npx - t * tile) * C;
      if constexpr (V > 1) {
        constexpr int E = 16 / sizeof(T);
        for (int i = tid * E; i < n; i += nt * E) {
          cp_async16(dst + i, xg + off + i, 16);
          cp_async16(dst + tile_n + i, dyg + off + i, 16);
        }
      } else {
        for (int i = tid; i < n; i += nt) {
          dst[i] = xg[off + i];
          dst[tile_n + i] = dyg[off + i];
        }
      }
    }
    cp_async_commit();
  };
  // tile j has landed once at most ahead - 1 younger groups are pending
  auto landed = [&]() {
    if (ahead >= 3) cp_async_wait<2>();
    else if (ahead == 2) cp_async_wait<1>();
    else cp_async_wait<0>();
  };

  // the first tiles of a sweep: in flight while the block reads its
  // constants (or, for sweep 2, while the cluster reduces sweep 1)
  auto prologue = [&](bool rev) {
    __syncthreads();  // the stages are free
    for (int j = 0; j < ahead; ++j) fetch(j, rev);
  };

  for (int i = tid; i < 2 * G; i += nt) mg1[i] = 0.f;

  // sweep 1: S1, S2 per channel, pass by pass
  for (int cb = 0; cb < CV; cb += cw) {
    const int ncol = min(cw, CV - cb);
    const int cpass = cb * V, wpass = ncol * V;  // the pass's channels
    const int c0 = (cb + vc) * V;                // this thread's channels
    const bool active = vc < ncol;
    const bool load = !SMEM || cb == 0;  // in_smem: the chunk stays after pass 0
    if (load) prologue(false);
    // xhat = x rstd + (tb - mu) rstd,  z = x a + (tb - mu) a + beta, a = gamma rstd
    float rs[V], sh[V], za[V], zc[V], a1[V], a2[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = active ? c0 + i : 0;
      const float d = (tb ? tb[bc + c] : 0.f) - mean[bc + c];
      rs[i] = rstd[bc + c];
      sh[i] = d * rs[i];
      za[i] = gamma[c] * rs[i];
      zc[i] = fmaf(d, za[i], beta[c]);
      a1[i] = a2[i] = 0.f;
    }
    for (int j = 0; j < ntiles; ++j) {
      if (load) {
        landed();
        __syncthreads();  // tile j is visible; tile j-1's stage is free
        fetch(j + ahead, false);
      }
      const T* xt = stage_x(j);
      const int rows = min(tile, npx - j * tile);
      if (active) {
#pragma unroll 2
        for (int p = pl; p < rows; p += ppi) {
          const P xv = *reinterpret_cast<const P*>(xt + p * C + c0);
          const P gv = *reinterpret_cast<const P*>(xt + tile_n + p * C + c0);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float xi = to_f(xv.v[i]);
            const float xh = fmaf(xi, rs[i], sh[i]);
            const float dz = to_f(gv.v[i]) * silu_grad(fmaf(xi, za[i], zc[i]));
            a1[i] += dz;
            a2[i] = fmaf(dz, xh, a2[i]);
          }
        }
      }
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        red1[tid * V + i] = a1[i];
        red2[tid * V + i] = a2[i];
      }
    }
    if (!SMEM && cb + cw >= CV) prologue(true);  // sweep 2's first tiles
    __syncthreads();
    if (pending) {  // every block has read the previous pass's partials
      cluster_wait();
      pending = false;
    }
    for (int ch = tid; ch < wpass; ch += nt) {
      part1[ch] = lane_sum(red1, ch, ppi, cw * V);
      part2[ch] = lane_sum(red2, ch, ppi, cw * V);
    }
    cluster_arrive();
    cluster_wait();  // every block's partials are written and visible
    // the image's sums, rank by rank in a fixed order, on every block
    for (int ch = tid; ch < wpass; ch += nt) {
      const float t1 = rank_sum(cluster, part1, ch, ranks);
      const float t2 = rank_sum(cluster, part2, ch, ranks);
      if (rank == 0) {
        s1_out[bc + cpass + ch] = t1;
        s2_out[bc + cpass + ch] = t2;
      }
      red1[ch] = gamma[cpass + ch] * t1;
      red2[ch] = gamma[cpass + ch] * t2;
    }
    cluster_arrive();  // done with the other blocks' partials
    pending = true;
    __syncthreads();
    // gamma * S1 and gamma * S2 summed per group, channel by channel
    const int g_lo = cpass / cg_, g_hi = (cpass + wpass - 1) / cg_;
    for (int grp = g_lo + tid; grp <= g_hi; grp += nt) {
      const int lo = max(grp * cg_, cpass), hi = min((grp + 1) * cg_, cpass + wpass);
      float m1 = mg1[grp], m2 = mg2[grp];
      for (int c = lo; c < hi; ++c) {
        m1 += red1[c - cpass];
        m2 += red2[c - cpass];
      }
      mg1[grp] = m1;
      mg2[grp] = m2;
    }
    __syncthreads();
  }

  // sweep 2: dx (and the per-channel sum of du for dtb), pass by pass
  for (int cb = 0; cb < CV; cb += cw) {
    const int ncol = min(cw, CV - cb);
    const int cpass = cb * V, wpass = ncol * V;
    const int c0 = (cb + vc) * V;
    const bool active = vc < ncol;
    // as sweep 1; du = dz a - m1 rstd - xhat (m2 rstd)
    float rs[V], sh[V], za[V], zc[V], m1r[V], m2r[V], a3[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = active ? c0 + i : 0;
      const float d = (tb ? tb[bc + c] : 0.f) - mean[bc + c];
      rs[i] = rstd[bc + c];
      sh[i] = d * rs[i];
      za[i] = gamma[c] * rs[i];
      zc[i] = fmaf(d, za[i], beta[c]);
      m1r[i] = mg1[c / cg_] * inv_n * rs[i];
      m2r[i] = mg2[c / cg_] * inv_n * rs[i];
      a3[i] = 0.f;
    }
    if (!SMEM && cb > 0) prologue(true);  // pass 0's was issued before the reduction
    for (int j = 0; j < ntiles; ++j) {
      if (!SMEM) {
        landed();
        __syncthreads();
        fetch(j + ahead, true);
      }
      const T* xt = stage_x(j);
      const int t = tile_at(j, !SMEM);
      const int rows = min(tile, npx - t * tile);
      T* out = dxg + (int64_t)t * tile_n;
      if (active) {
#pragma unroll 2
        for (int p = pl; p < rows; p += ppi) {
          const P xv = *reinterpret_cast<const P*>(xt + p * C + c0);
          const P gv = *reinterpret_cast<const P*>(xt + tile_n + p * C + c0);
          P o;
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float xi = to_f(xv.v[i]);
            const float xh = fmaf(xi, rs[i], sh[i]);
            const float dz = to_f(gv.v[i]) * silu_grad(fmaf(xi, za[i], zc[i]));
            const float du = fmaf(dz, za[i], fmaf(-xh, m2r[i], -m1r[i]));
            from_f(&o.v[i], du);
            a3[i] += du;
          }
          *reinterpret_cast<P*>(out + p * C + c0) = o;
        }
      }
    }
    if (dtb_out) {  // uniform across the cluster
      if (active) {
#pragma unroll
        for (int i = 0; i < V; ++i) red1[tid * V + i] = a3[i];
      }
      __syncthreads();
      if (pending) {
        cluster_wait();
        pending = false;
      }
      for (int ch = tid; ch < wpass; ch += nt) part1[ch] = lane_sum(red1, ch, ppi, cw * V);
      cluster_arrive();
      cluster_wait();
      if (rank == 0)
        for (int ch = tid; ch < wpass; ch += nt)
          dtb_out[bc + cpass + ch] = rank_sum(cluster, part1, ch, ranks);
      cluster_arrive();
      pending = true;
    }
  }
  if (pending) cluster_wait();  // no block leaves while its partials may be read
}

template <typename T, int V, bool SMEM>
int launch_bwd(const void* x, const void* dy, const float* ga, const float* be,
               const float* t, const float* mu, const float* rs, void* dx, float* o1,
               float* o2, float* od, int B, int HW, int C, int G, int cluster, int chunk,
               BwdSmem sm, cudaStream_t s) {
  const int cw = C / V < kBwdThreads ? C / V : kBwdThreads;
  return launch_clustered(gn_silu_bwd_kernel<T, V, SMEM>, cluster, B,
                          cw * (kBwdThreads / cw),  // column x pixel lanes
                          sm.bytes, s, static_cast<const T*>(x), static_cast<const T*>(dy),
                          ga, be, t, mu, rs, static_cast<T*>(dx), o1, o2, od, HW, C, G, chunk,
                          sm.tile, sm.stages);
}

template <typename T, int V>
int launch_bwd_route(bool in_smem, const void* x, const void* dy, const float* ga,
                     const float* be, const float* t, const float* mu, const float* rs,
                     void* dx, float* o1, float* o2, float* od, int B, int HW, int C, int G,
                     int cluster, int chunk, BwdSmem sm, cudaStream_t s) {
  return in_smem ? launch_bwd<T, V, true>(x, dy, ga, be, t, mu, rs, dx, o1, o2, od, B, HW, C,
                                          G, cluster, chunk, sm, s)
                 : launch_bwd<T, V, false>(x, dy, ga, be, t, mu, rs, dx, o1, o2, od, B, HW,
                                           C, G, cluster, chunk, sm, s);
}

}  // namespace

// x, dy, dx: (B, H*W, C) contiguous (NHWC), fp32 (is_bf16 = 0) or bf16 (1).
// gamma, beta: (C,) fp32.  tb: (B, C) fp32 or NULL (no time bias).
// mean, rstd: (B, C) fp32 as gn_silu_fwd wrote them.  s1, s2: (B, C) fp32
// outputs (sum dz, sum dz*xhat per channel).  dtb: (B, C) fp32 output, or
// NULL to skip the time-bias gradient.  The plan (_gn_bwd_plan in
// ops/fused_norm.py): cluster blocks per image (1, 2, 4, 8 or 16), each
// owning chunk pixels (chunk * cluster >= H*W), and in_smem = 1 to keep
// the chunk of x and dy in shared memory.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int gn_silu_bwd(const void* x, const void* dy, const void* gamma,
                           const void* beta, const void* tb, const void* mean,
                           const void* rstd, void* dx, void* s1, void* s2,
                           void* dtb, int B, int HW, int C, int G, int cluster,
                           int chunk, int in_smem, int is_bf16, void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0 || G <= 0 || C % G != 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) || chunk < 1
      || (int64_t)chunk * cluster < HW)
    return (int)cudaErrorInvalidValue;
  const int itemsize = is_bf16 ? 2 : 4;
  const BwdSmem smem = bwd_smem(C, G, chunk, in_smem != 0, itemsize);
  if (smem.bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  // 16-byte copies and 4 channels per thread where rows are whole 16-byte
  // units and the pointers 16-byte aligned, else element copies
  const bool vec = (C * itemsize) % 16 == 0 && aligned(x) && aligned(dy) && aligned(dx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  const float* t = static_cast<const float*>(tb);
  const float* mu = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  float* o1 = static_cast<float*>(s1);
  float* o2 = static_cast<float*>(s2);
  float* od = static_cast<float*>(dtb);
  const bool sm = in_smem != 0;
  if (is_bf16) {
    return vec ? launch_bwd_route<__nv_bfloat16, 4>(sm, x, dy, ga, be, t, mu, rs, dx, o1, o2,
                                                    od, B, HW, C, G, cluster, chunk, smem, s)
               : launch_bwd_route<__nv_bfloat16, 1>(sm, x, dy, ga, be, t, mu, rs, dx, o1, o2,
                                                    od, B, HW, C, G, cluster, chunk, smem, s);
  }
  return vec ? launch_bwd_route<float, 4>(sm, x, dy, ga, be, t, mu, rs, dx, o1, o2, od, B, HW,
                                          C, G, cluster, chunk, smem, s)
             : launch_bwd_route<float, 1>(sm, x, dy, ga, be, t, mu, rs, dx, o1, o2, od, B, HW,
                                          C, G, cluster, chunk, smem, s);
}
