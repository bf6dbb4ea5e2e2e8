// Non-causal flash attention, backward: dK and dV (flash_attn_bwd_dkv_wgmma)
// and dQ (flash_attn_bwd_dq_wgmma, the second half of this file) for long
// sequences on Hopper's wgmma and TMA.  Target: sm_90a.
// Plain C interface, loaded with ctypes by
// ddpm_diffusion_model_tpu_torch/ops/flash_attention.py, whose _dkv_route
// sends a call of either wrapper here when its operands are bf16 with d = 64,
// every pointer is 16-byte aligned and N >= WGMMA_MIN_N = 512.  Every other
// call takes flash_attn_bwd.cu, which the short sequences of the U-Nets
// (N = 256 and 64), the 64-px DiT and the sampling service keep.  The
// threshold, on an H100 at 700 W against flash_attn_bwd.cu's mma.sync
// kernels (PERF.md §6): for dK/dV at N = 256 the two are level at BH = 48
// and this kernel 1.2x faster at BH = 384-768; from N = 512 it is 1.4-2.1x
// faster at every BH measured (48, 384), so 512 is the first length where
// it wins throughout.  dQ crosses over at the same lengths (below).
//
// Serves the same TPU kernel as flash_bwd_dkv_tc_kernel, _dkv_kernel
// (ddpm_diffusion_model_tpu/ops/flash_attention.py:169), with the same
// arithmetic and roundings:
//     P^T  = exp2(K Q^T * scale * log2(e) - LSE * log2(e))   (0 past N)
//     dV  += bf16(P^T) dO
//     dS^T = P^T * (V dO^T - delta)
//     dK  += bf16(dS^T) Q,   stored as bf16(dK * scale), dV as bf16(dV)
// with fp32 accumulators, for (BH, N, 64) bf16 q, k, v, dO and (BH, N) fp32
// LSE (natural log) and delta = rowsum(dO * O).
//
// What bounds it on the card: operations.  The four products are
// 8 * BH * N^2 * d flops against 6 * BH * N * d * 2 bytes: at the DiT's
// (384, 4096, 64) 3.30 TFLOP, 3.34 ms at 989 TFLOP/s, while the bytes take
// 0.36 ms at 3.35 TB/s.  So the rate at which the tensor cores are fed
// decides, and wgmma is the only instruction that reaches their full rate
// (mma.sync, which flash_bwd_dkv_tc_kernel issues from every warp with
// ldmatrix and cp.async address work for every tile, does not).  Measured
// at (384, 4096, 64): 5.6-6.3 ms a call, 53-60% of that bound, against
// 11.8 ms (28%) for the mma.sync kernel.  Probes (wrong results) that took
// the exponentials and bf16 roundings out, or half the bytes loaded, did not
// make it measurably faster: neither the ALUs nor L2 hold the rest.  Under
// sustained load the card sits at its 700 W limit (1.65 GHz), where a large
// bf16 GEMM in cuBLAS reaches 780 TFLOP/s; this kernel sustains 68% of that.
//
// Design.  A block owns 128 keys of one (bh): two consumer warpgroups of
// 64 keys each, and a producer warpgroup of which one thread issues every
// load.  setmaxnreg gives the consumers 240 registers a thread and leaves
// the producer 24.  Keys are the rows of every product, so no product's
// operand passes through shared memory twice:
//   - each consumer warp loads its 16 keys of K and V once, straight into
//     the registers as wgmma A operands (m64k16 layout, 16 + 16 registers);
//   - tiles of 64 queries -- Q and dO (8 KB each, 128-byte swizzled) and
//     that tile's LSE and delta -- stream through a ring of kStages stages
//     by TMA, with a full and an empty mbarrier per stage;
//   - S^T = K Q^T and dP^T = V dO^T take Q and dO as K-major B operands,
//     dV += P^T dO and dK += dS^T Q take them as MN-major (transposed) B
//     operands from the same tiles; all four are m64n64k16 with A in the
//     registers (RS), so shared memory feeds only B;
//   - dP^T's wgmma is issued before P^T's exponentials and waited for
//     after them, and one warpgroup's exponentials can run while the
//     other's products occupy the tensor cores;
//   - P^T and dS^T are rounded to bf16 where they stand: the accumulator
//     layout is the A layout of the next product (wgmma_bf16.cuh).
// Per consumer thread: dK and dV 64 fp32 registers, S^T and dP^T 32 each,
// K and V 32, P^T and dS^T in bf16 32.  Each block writes only its own dK
// and dV rows, in one fixed order: no atomics, the same bits on every run.
// Ragged N: the tensor maps are 3-D (d, N, BH), so TMA fills query rows
// past N with zeros and a tile never crosses a (bh); P^T is masked to 0
// for queries past N; K and V rows past N load as zeros and are not stored.
// LSE and delta go through 1-D maps over the flat (BH * N) arrays, whose
// entries past a row's N are masked with P^T; TMA moves a box only from a
// 16-byte aligned address, so each tile's box of 68 starts at the aligned
// entry at or before the tile's first and the lanes read at the offset.
// The tensor maps are encoded on the host per call (cuTensorMapEncodeTiled
// through cudaGetDriverEntryPoint, so nothing links libcuda) and passed as
// __grid_constant__ parameters.  Shared memory 68 KB; one block per SM.
// The consumer branch comes first in the kernel: with the producer's first,
// ptxas held the consumers to the launch's 168 registers, spilled K and V
// and serialized every wgmma.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace {

using mma_bf16::bf16;
constexpr int kD = 64;             // head dim
constexpr int kBQ = 64;            // queries per tile
constexpr int kConsumers = 2;      // consumer warpgroups, 64 keys each
constexpr int kBK = 64 * kConsumers;
constexpr int kStages = 4;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr float kLog2e = 1.4426950408889634f;
// LSE and delta boxes: 68 entries from a 16-byte aligned start (TMA moves
// 16-byte aligned boxes), the tile's 64 at an offset of 0..3 within it.
constexpr int kRowBox = kBQ + 4;
constexpr uint32_t kTileBytes = kBQ * kD * sizeof(bf16);
constexpr uint32_t kTxBytes = 2 * kTileBytes + 2 * kRowBox * sizeof(float);

struct Smem {  // from a 1024-byte aligned base: every tile 1024-aligned
  bf16 q[kStages][kBQ * kD];
  bf16 dout[kStages][kBQ * kD];
  float lse[kStages][kRowBox + 28];  // rows of 384 bytes: TMA writes 128-byte aligned
  float delta[kStages][kRowBox + 28];
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;  // + room to align the base

// The A operands of rows r, r + 8 of a (N, 64) bf16 matrix (this lane's
// rows of its warp's 16), zeros past N.
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[4][4], const bf16* __restrict__ m,
                                            int r, int N, int t) {
  const uint32_t* lo = reinterpret_cast<const uint32_t*>(m + (int64_t)r * kD);
  const uint32_t* hi = reinterpret_cast<const uint32_t*>(m + (int64_t)(r + 8) * kD);
#pragma unroll
  for (int c = 0; c < kD / 16; ++c) {
    a[c][0] = r < N ? lo[8 * c + t] : 0u;
    a[c][1] = r + 8 < N ? hi[8 * c + t] : 0u;
    a[c][2] = r < N ? lo[8 * c + 4 + t] : 0u;
    a[c][3] = r + 8 < N ? hi[8 * c + 4 + t] : 0u;
  }
}

// Columns 16c..16c+15 of an m64n64 accumulator as the bf16 A operand of k-step c.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[c][i] = mma_bf16::pack(d[8 * c + 2 * i], d[8 * c + 2 * i + 1]);
}

__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_lse, const __grid_constant__ CUtensorMap tm_delta,
    const bf16* __restrict__ k, const bf16* __restrict__ v, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int N, float scale) {
  using namespace wgmma_bf16;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  const int bh = blockIdx.y, k0 = blockIdx.x * kBK;
  const int ntiles = (N + kBQ - 1) / kBQ;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // uniform, as ptxas can see

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);                  // the producer's expect_tx
      mbar_init(&sm.empty[s], kConsumers * 4);    // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg < kConsumers) {
    // ---------------------------------------------------------- consumers
    setmaxnreg_inc<240>();
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int r = k0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);  // rows r, r + 8
    const int64_t base = (int64_t)bh * N * kD;
    const float qs = scale * kLog2e;

    uint32_t kf[4][4], vf[4][4];
    load_a_rows(kf, k + base, r, N, t);
    load_a_rows(vf, v + base, r, N, t);

    float gk[32], gv[32], st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) gk[i] = gv[i] = 0.f;

    for (int j = 0; j < ntiles; ++j) {
      const int s = j % kStages;
      mbar_wait(&sm.full[s], (j / kStages) & 1);
      const uint32_t qa = smem_addr(sm.q[s]), da = smem_addr(sm.dout[s]);

      // S^T = K Q^T, then dP^T = V dO^T: Q and dO K-major, k-steps 32 bytes apart
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < 4; ++c) wgmma_m64n64k16_rs<0>(st, kf[c], desc_sw128(qa + 32 * c), c);
      wgmma_commit();
#pragma unroll
      for (int c = 0; c < 4; ++c) wgmma_m64n64k16_rs<0>(dpt, vf[c], desc_sw128(da + 32 * c), c);
      wgmma_commit();

      // P^T while dP^T is in flight; element 4n + e: query 8n + 2t + (e & 1)
      wgmma_wait<1>();
      fence_regs(st);
      const int off = (bh * N + j * kBQ) & 3;  // the tile's first entry in its box
      const float* L = sm.lse[s] + off + 2 * t;
      const int qmax = N - j * kBQ;  // queries of this tile that exist
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float l[2] = {L[8 * n] * kLog2e, L[8 * n + 1] * kLog2e};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * n + 2 * t + (e & 1);
          st[4 * n + e] = col < qmax ? mma_bf16::exp2_approx(fmaf(st[4 * n + e], qs, -l[e & 1]))
                                     : 0.f;
        }
      }
      uint32_t pb[4][4];
      acc_to_a(pb, st);

      // dS^T = P^T * (dP^T - delta)
      wgmma_wait<0>();
      fence_regs(dpt);
      const float* D = sm.delta[s] + off + 2 * t;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * n + e] = st[4 * n + e] * (dpt[4 * n + e] - D[8 * n + (e & 1)]);
      }
      uint32_t sb[4][4];
      acc_to_a(sb, dpt);

      // dV += P^T dO, dK += dS^T Q: dO and Q MN-major, k-steps 16 rows apart
      fence_regs(gv);
      fence_regs(gk);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < 4; ++c) wgmma_m64n64k16_rs<1>(gv, pb[c], desc_sw128(da + 2048 * c), 1);
#pragma unroll
      for (int c = 0; c < 4; ++c) wgmma_m64n64k16_rs<1>(gk, sb[c], desc_sw128(qa + 2048 * c), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(gv);
      fence_regs(gk);
      fence_regs(pb);
      fence_regs(sb);

      // the stage is read: hand it back to the producer
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[s]);
    }

    // dK * scale and dV as bf16, rows r and r + 8, columns 8n + 2t, 8n + 2t + 1
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      if (row < N) {
        uint32_t* dkr = reinterpret_cast<uint32_t*>(dk + base + (int64_t)row * kD);
        uint32_t* dvr = reinterpret_cast<uint32_t*>(dv + base + (int64_t)row * kD);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          dkr[4 * n + t] = mma_bf16::pack(gk[4 * n + 2 * h] * scale, gk[4 * n + 2 * h + 1] * scale);
          dvr[4 * n + t] = mma_bf16::pack(gv[4 * n + 2 * h], gv[4 * n + 2 * h + 1]);
        }
      }
    }
   } else {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers * 128) {
      prefetch_tensormap(&tm_q);
      prefetch_tensormap(&tm_do);
      prefetch_tensormap(&tm_lse);
      prefetch_tensormap(&tm_delta);
      const int row0 = bh * N;
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kStages;
        const int l0 = (row0 + j * kBQ) & ~3;
        mbar_wait(&sm.empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], kTxBytes);
        tma_load_3d(sm.q[s], &tm_q, &sm.full[s], 0, j * kBQ, bh);
        tma_load_3d(sm.dout[s], &tm_do, &sm.full[s], 0, j * kBQ, bh);
        tma_load_1d(sm.lse[s], &tm_lse, &sm.full[s], l0);
        tma_load_1d(sm.delta[s], &tm_delta, &sm.full[s], l0);
      }
    }
  }
}

// ------------------------------------------------------------------ dQ
//
// flash_bwd_dq_wgmma_kernel serves the same TPU kernel as flash_attn_bwd.cu's
// flash_bwd_dq_tc_kernel, _dq_kernel (ddpm_diffusion_model_tpu/ops/
// flash_attention.py:132), with its arithmetic and roundings:
//     P  = exp2(Q K^T * scale * log2(e) - LSE * log2(e))   (0 past N)
//     dS = P * (dO V^T - delta)
//     dQ += bf16(dS) K,   stored as bf16(dQ * scale)
// and the same products in the same order, so its dQ is bit-equal to the
// mma.sync kernel's.  What bounds it: operations.  Three products,
// 6 * BH * N^2 * d flops, against 5 * BH * N * d * 2 bytes: at the DiT's
// (384, 4096, 64) 2.47 TFLOP, 2.50 ms at 989 TFLOP/s, while the bytes take
// 0.30 ms at 3.35 TB/s.  Measured there (H100 at 700 W, CUDA events):
// 4.3-4.9 ms a call, 51-59% of that bound, against 9.5-10.5 ms (24-26%) for
// the mma.sync kernel; from N = 512 it is 1.6-2.2x faster at BH = 384 and
// at least level at BH = 48 (1.3-2.3x from N = 1024), at N = 256 level at
// BH = 48 and 384 and 1.3x faster at BH = 6144: at the dK/dV kernel's
// crossover, so both wrappers take _dkv_route.
//
// Design: the dK/dV kernel's mirror, with queries as the rows of every
// product.  A block owns 128 queries of one (bh): two consumer warpgroups of
// 64 queries each and a producer warpgroup of which one thread issues every
// load; setmaxnreg as there.
//   - each consumer warp loads its 16 queries of Q and dO once, straight into
//     the registers as wgmma A operands, and its rows' LSE and delta;
//   - tiles of 64 keys, K and V (8 KB each, 128-byte swizzled), stream
//     through a ring of kStages stages by TMA;
//   - S = Q K^T and dP = dO V^T take K and V as K-major B operands, dQ += dS K
//     takes the same K tile as an MN-major (transposed) B; all three are
//     m64n64k16 RS, so shared memory feeds only B;
//   - dP's wgmma is issued before P's exponentials and waited for after them,
//     and one warpgroup's exponentials can run while the other's products
//     occupy the tensor cores;
//   - dS is rounded to bf16 where it stands, as the next product's A.
// Per consumer thread: dQ, S and dP 32 fp32 registers each, Q and dO 16, dS
// in bf16 16.  Each block writes only its own dQ rows, once: no atomics, the
// same bits on every run.  Ragged N: TMA fills key rows past N with zeros
// (the 3-D maps of the dK/dV kernel, rows_map), P is masked to 0 there;
// query rows past N load as zeros and are not stored.  Shared memory 65 KB.
// Tried on the card and left out, each within 5% of this design at
// (384, 4096, 64) and (48, 4096, 64), inside the card's own spread: a third
// consumer warpgroup (160 registers a thread), tiles of 128 keys (m64n128k16
// for S and dP, 3 or 2 stages), and leaving dQ's product in flight under the
// next tile's S and dP (ptxas injects a wait and it is 5-8% slower).  A probe
// without the exponentials (wrong results) was 3% faster: they do not bound it.
constexpr int kDqRows = 64 * kConsumers;            // queries per block
constexpr uint32_t kDqTxBytes = 2 * kTileBytes;  // a K and a V tile of kBQ keys

struct DqSmem {  // from a 1024-byte aligned base: every tile 1024-aligned
  bf16 k[kStages][kBQ * kD];
  bf16 v[kStages][kBQ * kD];
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
    const bf16* __restrict__ q, const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int N, float scale) {
  using namespace wgmma_bf16;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  DqSmem& sm =
      *reinterpret_cast<DqSmem*>(smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  const int bh = blockIdx.y, q0 = blockIdx.x * kDqRows;
  const int ntiles = (N + kBQ - 1) / kBQ;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // uniform, as ptxas can see

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);                // the producer's expect_tx
      mbar_init(&sm.empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg < kConsumers) {
    // ---------------------------------------------------------- consumers
    setmaxnreg_inc<240>();
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int r = q0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);  // rows r, r + 8
    const int64_t base = (int64_t)bh * N * kD;
    const float qs = scale * kLog2e;

    uint32_t qf[4][4], of[4][4];
    load_a_rows(qf, q + base, r, N, t);
    load_a_rows(of, dout + base, r, N, t);
    // LSE (in log2) and delta of rows r and r + 8; rows past N give 0 (their
    // Q and dO are zeros, so dS = 0)
    float lg[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      lg[h] = row < N ? lse[(int64_t)bh * N + row] * kLog2e : 0.f;
      dl[h] = row < N ? delta[(int64_t)bh * N + row] : 0.f;
    }

    float gq[32], p[32], dp[32];
    uint32_t sb[4][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) gq[i] = 0.f;

    for (int j = 0; j < ntiles; ++j) {
      const int s = j % kStages;
      mbar_wait(&sm.full[s], (j / kStages) & 1);
      const uint32_t ka = smem_addr(sm.k[s]), va = smem_addr(sm.v[s]);

      // S = Q K^T, then dP = dO V^T: K and V K-major, k-steps 32 bytes apart
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < 4; ++c) wgmma_m64n64k16_rs<0>(p, qf[c], desc_sw128(ka + 32 * c), c);
      wgmma_commit();
#pragma unroll
      for (int c = 0; c < 4; ++c) wgmma_m64n64k16_rs<0>(dp, of[c], desc_sw128(va + 32 * c), c);
      wgmma_commit();

      // P while dP is in flight; element 4n + e: key 8n + 2t + (e & 1) of
      // row r (e < 2) or r + 8
      wgmma_wait<1>();
      fence_regs(p);
      const int kmax = N - j * kBQ;  // keys of this tile that exist
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * n + 2 * t + (e & 1);
          p[4 * n + e] = col < kmax ? mma_bf16::exp2_approx(fmaf(p[4 * n + e], qs, -lg[e >> 1]))
                                    : 0.f;
        }

      // dS = P * (dP - delta)
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = p[i] * (dp[i] - dl[(i >> 1) & 1]);
      acc_to_a(sb, dp);

      // dQ += dS K: K MN-major, k-steps 16 rows apart
      fence_regs(gq);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < 4; ++c) wgmma_m64n64k16_rs<1>(gq, sb[c], desc_sw128(ka + 2048 * c), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(gq);
      fence_regs(sb);

      // the stage is read: hand it back to the producer
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[s]);
    }

    // dQ * scale as bf16, rows r and r + 8, columns 8n + 2t, 8n + 2t + 1
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      if (row < N) {
        uint32_t* dqr = reinterpret_cast<uint32_t*>(dq + base + (int64_t)row * kD);
#pragma unroll
        for (int n = 0; n < 8; ++n)
          dqr[4 * n + t] = mma_bf16::pack(gq[4 * n + 2 * h] * scale, gq[4 * n + 2 * h + 1] * scale);
      }
    }
  } else {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers * 128) {
      prefetch_tensormap(&tm_k);
      prefetch_tensormap(&tm_v);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&sm.empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], kDqTxBytes);
        tma_load_3d(sm.k[s], &tm_k, &sm.full[s], 0, j * kBQ, bh);
        tma_load_3d(sm.v[s], &tm_v, &sm.full[s], 0, j * kBQ, bh);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &got);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &got);
#endif
    if (e == cudaSuccess && got == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (BH, N, 64) bf16, boxes of 64 rows x 64, 128-byte swizzle, zeros past N.
bool rows_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int BH, int N) {
  const cuuint64_t dims[3] = {(cuuint64_t)kD, (cuuint64_t)N, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {kD * sizeof(bf16), (cuuint64_t)N * kD * sizeof(bf16)};
  const cuuint32_t box[3] = {kD, kBQ, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
         == CUDA_SUCCESS;
}

// The flat (BH * N) fp32 array, boxes of kRowBox.
bool flat_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int BH, int N) {
  const cuuint64_t dims[1] = {(cuuint64_t)BH * N};
  const cuuint64_t strides[1] = {sizeof(float)};  // not read at rank 1
  const cuuint32_t box[1] = {kRowBox};
  const cuuint32_t elem[1] = {1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(ptr), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
         == CUDA_SUCCESS;
}

// What both entry points take: bf16 (BH, N, 64) operands behind 16-byte
// aligned pointers, with BH * N within the 32-bit row indices.
bool takes(const void* const* ptrs, int n, int BH, int N, int d, int is_bf16) {
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
  return is_bf16 && d == kD && BH > 0 && BH <= 65535 && N > 0
         && (int64_t)BH * N <= (int64_t)1 << 31;
}

}  // namespace

// As flash_attn_bwd.cu's flash_attn_bwd_dkv, for what _dkv_route sends
// here: q, k, v, dout, dk, dv (BH, N, 64) bf16 (is_bf16 = 1), lse and delta
// (BH, N) fp32, every pointer 16-byte aligned.  Returns cudaErrorInvalidValue
// for anything else or a tensor map the driver refuses, else
// cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attn_bwd_dkv_wgmma(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse,
                                        const void* delta, void* dk, void* dv, int BH,
                                        int N, int d, float scale, int is_bf16,
                                        void* stream) {
  const void* ptrs[] = {q, k, v, dout, lse, delta, dk, dv};
  if (!takes(ptrs, 8, BH, N, d, is_bf16)) return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tdo, tl, td;
  if (!rows_map(enc, &tq, q, BH, N) || !rows_map(enc, &tdo, dout, BH, N)
      || !flat_map(enc, &tl, lse, BH, N) || !flat_map(enc, &td, delta, BH, N))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + kBK - 1) / kBK, BH);
  flash_bwd_dkv_wgmma_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tq, tdo, tl, td, static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), N, scale);
  return (int)cudaGetLastError();
}

// As flash_attn_bwd.cu's flash_attn_bwd_dq, for what the route sends here:
// q, k, v, dout, dq (BH, N, 64) bf16 (is_bf16 = 1), lse and delta (BH, N)
// fp32, every pointer 16-byte aligned.  Returns cudaErrorInvalidValue for
// anything else or a tensor map cuTensorMapEncodeTiled refuses, else
// cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attn_bwd_dq_wgmma(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dq, int BH, int N, int d, float scale,
                                       int is_bf16, void* stream) {
  const void* ptrs[] = {q, k, v, dout, lse, delta, dq};
  if (!takes(ptrs, 7, BH, N, d, is_bf16)) return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap tk, tv;
  if (!rows_map(enc, &tk, k, BH, N) || !rows_map(enc, &tv, v, BH, N))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = sizeof(DqSmem) + 1024;  // + room to align the base
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + kDqRows - 1) / kDqRows, BH);
  flash_bwd_dq_wgmma_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      tk, tv, static_cast<const bf16*>(q), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<bf16*>(dq),
      N, scale);
  return (int)cudaGetLastError();
}
