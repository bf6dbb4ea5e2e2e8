// Non-causal flash attention, backward: dQ (flash_attn_bwd_dq) and dK, dV
// (flash_attn_bwd_dkv), recomputing the probabilities from the forward's LSE.
// Target: sm_90a (H100).  Plain C interface, loaded with ctypes by
// ddpm_diffusion_model_tpu_torch/ops/flash_attention.py.
//
// Replaces the TPU kernels _dq_kernel (flash_attention.py:132, launched at
// flash_attention.py:231) and _dkv_kernel (flash_attention.py:169, launched
// at flash_attention.py:250) of ddpm_diffusion_model_tpu/ops:
//     P  = exp(Q K^T * scale - LSE)          (LSE in natural log, per row)
//     dP = dO V^T,  dS = P * (dP - delta),   delta = rowsum(dO * O)
//     dQ = scale * dS K,  dK = scale * dS^T Q,  dV = P^T dO
// for q, k, v, dO of shape (BH, N, d), contiguous, fp32 or bf16, d <= 128;
// LSE and delta (BH, N) fp32 (delta is one torch expression in the wrapper,
// as the TPU path leaves it to XLA).  fp32 accumulators; outputs in the
// input dtype.
//
// What bounds it on the card: at the U-Net's shapes (N = 64 or 256, d = 64)
// bytes.  dQ must read Q, K, V, dO and write dQ (5 * BH*N*d * itemsize),
// dK/dV read the same four and write two (6 *); their 6 and 8 * BH*N^2*d
// flops are ~77 and ~85 flops/byte at N = 256 in bf16, under the ~295
// where an H100's tensor cores become the limit.  On fp32 operands both
// compute with fp32 FMA (TF32 would miss the fp32 contract), so the FMA
// pipe and shared-memory loads are their practical limit; on bf16 operands
// both run on the tensor cores (flash_bwd_dq_tc_kernel,
// flash_bwd_dkv_tc_kernel, below).
//
// Design.  The TPU kernels walk the streamed operand along a sequential
// grid axis and keep the accumulator in VMEM scratch; Hopper has no
// sequential grid, so each CUDA block owns one (bh, 64-row tile) and loops
// over the other operand's tiles itself, accumulators in registers.
// Two kernels, as on the TPU: dQ accumulates over key tiles, dK/dV over
// query tiles, so every output element is written by exactly one block in
// a fixed order (no atomics: the same result on every run).  P is
// recomputed as exp2(s * scale * log2(e) - LSE * log2(e)), the same exp as
// exp(s * scale - LSE), in the exp2 domain the forward uses.  The ragged
// tail (N not a multiple of the tile) is masked: P = 0 for keys or queries
// past N, rows past N are loaded as zeros and not stored.
//
// FMA kernels (fp32 operands).  8 warps x 8 rows each.  In the score
// phase a lane owns the other operand's rows lane and lane+32; in the
// accumulate phase output columns lane + 32*j.  Operands a lane reads by
// row in the score phase are staged as fp32 with rows padded by one float
// (no bank conflicts); the rows a warp broadcasts are not.
//
// dK/dV on bf16, flash_bwd_dkv_tc_kernel (mma.sync m16n8k16, helpers in
// mma_bf16.cuh).  Keys are the rows throughout: 4 warps x 16 keys, so
// S^T = K Q^T and dP^T = V dO^T come out of the tensor cores in the
// accumulator layout of the warp that owns those keys, and P^T and dS^T
// become A fragments of dV += P^T dO and dK += dS^T Q in the registers,
// rounded to bf16 (as FlashAttention-2 and SDPA round them), never passing
// through shared memory.  K and V are copied once; their A fragments stay
// in the registers for d <= 64 (at d = 128, where dK and dV alone take 128
// fp32 registers per lane, they are re-read with ldmatrix and the query
// tile is 32).  Tiles of 64 queries -- Q and dO in bf16, that tile's LSE
// and delta in fp32 -- go through a ring of 4 stages with cp.async, one
// group per tile: up to 3 tiles are in flight while one is computed.
// P^T = 2^(s * scale * log2(e) - LSE * log2(e)) is one FFMA and one
// ex2.approx.  Q and dO are B operands: by ldmatrix
// for the score products, by the transposing ldmatrix for dV and dK.  Rows
// are padded by 8 elements so every ldmatrix phase is free of bank
// conflicts.  dK * scale and dV are staged as bf16 in the warp's own K and
// V rows and stored with 16-byte stores.  d not a multiple of 8, or an
// operand not 16-byte aligned, takes the same kernel with 2-byte copies.
// Shared memory 94 KB at d = 64; 247 registers, so 2 blocks per SM.  Grid
// (ceil(N/64), BH): 2048 blocks at (512, 256, 64) and 512 at (512, 64, 64),
// the train step's shapes.
//
// dQ on bf16, flash_bwd_dq_tc_kernel: the same machinery with queries as
// the rows, 4 warps x 16 queries.  S = Q K^T and dP = dO V^T come out in
// the accumulator layout of the warp that owns the queries (K and V as B
// operands by ldmatrix on their rows); dS = P * (dP - delta) is formed in
// fp32, rounded to bf16 where it stands, which is the A-fragment layout of
// dQ += dS K, and K is that product's B operand by the transposing
// ldmatrix on the same rows.  Q and dO are copied once and their A
// fragments stay in the registers for d <= 64 (at d = 128 they are re-read
// and the key tile is 32); each lane keeps the LSE and delta of its two
// rows in registers.  Tiles of 64 keys (K and V) stream through a 3-stage
// cp.async ring (two tiles in flight), one stage fewer than dK/dV's: 74 KB
// of shared memory at d = 64, so 3 blocks share an SM where 4 stages fit
// 2.  dQ * scale is staged as bf16 in the warp's
// own Q rows and stored with 16-byte stores.  Three products per key tile
// where dK/dV has four.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kB = 64;               // rows per tile (queries or keys)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kB / kWarps;   // rows per warp
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float dot4(float4 a, const float* b) {
  return a.x * b[0] + a.y * b[1] + a.z * b[2] + a.w * b[3];
}

// Stage rows r0 .. r0+kB-1 of a (N, d) matrix with row stride S, zeros
// past N and past d.
template <int DP, int S>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int r0, int N, int d) {
  for (int i = threadIdx.x; i < kB * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    dst[r * S + c] = (r0 + r < N && c < d) ? src[(int64_t)(r0 + r) * d + c] : 0.f;
  }
}

// Rows r0 .. r0+kB-1 of LSE (scaled to log2) and delta, zeros past N.
__device__ __forceinline__ void stage_rows(float* ls, float* ds,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           int r0, int N) {
  for (int i = threadIdx.x; i < kB; i += kThreads) {
    const bool ok = r0 + i < N;
    ls[i] = ok ? lse[r0 + i] * kLog2e : 0.f;
    ds[i] = ok ? delta[r0 + i] : 0.f;
  }
}

// ------------------------------------------------------------------ dQ

template <int DP>
constexpr size_t dq_smem_floats() {
  return 2 * (size_t)kB * DP          // Q, dO of this query tile
         + 2 * (size_t)kB * (DP + 1)  // K, V of the current key tile, padded
         + (size_t)kB * kB            // dS
         + 2 * (size_t)kB;            // LSE (log2), delta
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int N, int d,
    float scale) {
  constexpr int KS = DP + 1;
  constexpr int CPL = DP / 32;  // output columns per lane
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;
  float* dOs = Qs + kB * DP;
  float* Ks = dOs + kB * DP;
  float* Vs = Ks + kB * KS;
  float* dSs = Vs + kB * KS;
  float* Ls = dSs + kB * kB;
  float* Ds = Ls + kB;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, q0 = blockIdx.x * kB;
  const int64_t base = (int64_t)bh * N * d;
  const float qs = scale * kLog2e;

  stage<DP, DP>(Qs, q + base, q0, N, d);
  stage<DP, DP>(dOs, dout + base, q0, N, d);
  stage_rows(Ls, Ds, lse + (int64_t)bh * N, delta + (int64_t)bh * N, q0, N);

  float acc[kRows][CPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[r][j] = 0.f;
  const float* Qw = Qs + warp * kRows * DP;
  const float* dOw = dOs + warp * kRows * DP;
  float* dSw = dSs + warp * kRows * kB;

  for (int k0 = 0; k0 < N; k0 += kB) {
    __syncthreads();  // the previous tile is consumed (and Q, dO are staged)
    stage<DP, KS>(Ks, k + base, k0, N, d);
    stage<DP, KS>(Vs, v + base, k0, N, d);
    __syncthreads();

    // s = q.k and dp = dO.v for keys lane ([0]) and lane+32 ([1])
    float s[kRows][2], dp[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
    const float* K0 = Ks + lane * KS;
    const float* K1 = Ks + (lane + 32) * KS;
    const float* V0 = Vs + lane * KS;
    const float* V1 = Vs + (lane + 32) * KS;
#pragma unroll 2
    for (int c = 0; c < DP; c += 4) {
      float ka[4], kb[4], va[4], vb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        ka[u] = K0[c + u]; kb[u] = K1[c + u];
        va[u] = V0[c + u]; vb[u] = V1[c + u];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(Qw + r * DP + c);
        const float4 ov = *reinterpret_cast<const float4*>(dOw + r * DP + c);
        s[r][0] += dot4(qv, ka);
        s[r][1] += dot4(qv, kb);
        dp[r][0] += dot4(ov, va);
        dp[r][1] += dot4(ov, vb);
      }
    }

    // dS = P * (dP - delta), P from the saved LSE; keys past N give 0
    const bool ok0 = k0 + lane < N, ok1 = k0 + lane + 32 < N;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int ri = warp * kRows + r;
      const float p0 = ok0 ? exp2f(s[r][0] * qs - Ls[ri]) : 0.f;
      const float p1 = ok1 ? exp2f(s[r][1] * qs - Ls[ri]) : 0.f;
      dSw[r * kB + lane] = p0 * (dp[r][0] - Ds[ri]);
      dSw[r * kB + lane + 32] = p1 * (dp[r][1] - Ds[ri]);
    }
    __syncwarp();

    // acc += dS K
#pragma unroll 2
    for (int j0 = 0; j0 < kB; j0 += 4) {
      float kk[4][CPL];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < CPL; ++j) kk[u][j] = Ks[(j0 + u) * KS + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 g = *reinterpret_cast<const float4*>(dSw + r * kB + j0);
#pragma unroll
        for (int j = 0; j < CPL; ++j)
          acc[r][j] += g.x * kk[0][j] + g.y * kk[1][j] + g.z * kk[2][j] + g.w * kk[3][j];
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + warp * kRows + r;
    if (row >= N) continue;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
      if (c < d) dq[base + (int64_t)row * d + c] = acc[r][j] * scale;
    }
  }
}

// ------------------------------------------------------------------ dK, dV

template <int DP>
constexpr size_t dkv_smem_floats() {
  return 2 * (size_t)kB * DP          // K, V of this key tile
         + 2 * (size_t)kB * kB        // P, dS
         + 2 * (size_t)kB * (DP + 1)  // Q, dO of the current query tile, padded
         + 2 * (size_t)kB;            // LSE (log2), delta of that tile
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
    int N, int d, float scale) {
  constexpr int QS = DP + 1;
  constexpr int CPL = DP / 32;
  extern __shared__ __align__(16) float sm[];
  float* Ks = sm;
  float* Vs = Ks + kB * DP;
  float* Ps = Vs + kB * DP;
  float* dSs = Ps + kB * kB;
  float* Qs = dSs + kB * kB;
  float* dOs = Qs + kB * QS;
  float* Ls = dOs + kB * QS;
  float* Ds = Ls + kB;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, k0 = blockIdx.x * kB;
  const int64_t base = (int64_t)bh * N * d;
  const float qs = scale * kLog2e;

  stage<DP, DP>(Ks, k + base, k0, N, d);
  stage<DP, DP>(Vs, v + base, k0, N, d);

  float gk[kRows][CPL], gv[kRows][CPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < CPL; ++j) gk[r][j] = gv[r][j] = 0.f;
  const float* Kw = Ks + warp * kRows * DP;
  const float* Vw = Vs + warp * kRows * DP;
  float* Pw = Ps + warp * kRows * kB;
  float* dSw = dSs + warp * kRows * kB;

  for (int q0 = 0; q0 < N; q0 += kB) {
    __syncthreads();  // the previous tile is consumed (and K, V are staged)
    stage<DP, QS>(Qs, q + base, q0, N, d);
    stage<DP, QS>(dOs, dout + base, q0, N, d);
    stage_rows(Ls, Ds, lse + (int64_t)bh * N, delta + (int64_t)bh * N, q0, N);
    __syncthreads();

    // s = k.q and dp = v.dO for queries lane ([0]) and lane+32 ([1])
    float s[kRows][2], dp[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
    const float* Q0 = Qs + lane * QS;
    const float* Q1 = Qs + (lane + 32) * QS;
    const float* O0 = dOs + lane * QS;
    const float* O1 = dOs + (lane + 32) * QS;
#pragma unroll 2
    for (int c = 0; c < DP; c += 4) {
      float qa[4], qb[4], oa[4], ob[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        qa[u] = Q0[c + u]; qb[u] = Q1[c + u];
        oa[u] = O0[c + u]; ob[u] = O1[c + u];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 kv = *reinterpret_cast<const float4*>(Kw + r * DP + c);
        const float4 vv = *reinterpret_cast<const float4*>(Vw + r * DP + c);
        s[r][0] += dot4(kv, qa);
        s[r][1] += dot4(kv, qb);
        dp[r][0] += dot4(vv, oa);
        dp[r][1] += dot4(vv, ob);
      }
    }

    // P and dS for this warp's keys; queries past N give 0
    const bool ok0 = q0 + lane < N, ok1 = q0 + lane + 32 < N;
    const float l0 = Ls[lane], l1 = Ls[lane + 32];
    const float d0 = Ds[lane], d1 = Ds[lane + 32];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float p0 = ok0 ? exp2f(s[r][0] * qs - l0) : 0.f;
      const float p1 = ok1 ? exp2f(s[r][1] * qs - l1) : 0.f;
      Pw[r * kB + lane] = p0;
      Pw[r * kB + lane + 32] = p1;
      dSw[r * kB + lane] = p0 * (dp[r][0] - d0);
      dSw[r * kB + lane + 32] = p1 * (dp[r][1] - d1);
    }
    __syncwarp();

    // dV += P dO,  dK += dS Q  (over this tile's queries)
#pragma unroll 2
    for (int i0 = 0; i0 < kB; i0 += 4) {
      float oo[4][CPL], qq[4][CPL];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          oo[u][j] = dOs[(i0 + u) * QS + lane + 32 * j];
          qq[u][j] = Qs[(i0 + u) * QS + lane + 32 * j];
        }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(Pw + r * kB + i0);
        const float4 g = *reinterpret_cast<const float4*>(dSw + r * kB + i0);
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          gv[r][j] += p.x * oo[0][j] + p.y * oo[1][j] + p.z * oo[2][j] + p.w * oo[3][j];
          gk[r][j] += g.x * qq[0][j] + g.y * qq[1][j] + g.z * qq[2][j] + g.w * qq[3][j];
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int key = k0 + warp * kRows + r;
    if (key >= N) continue;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
      if (c < d) {
        dk[base + (int64_t)key * d + c] = gk[r][j] * scale;
        dv[base + (int64_t)key * d + c] = gv[r][j];
      }
    }
  }
}

template <int DP>
int launch_dq_fma(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dq, int BH, int N,
                  int d, float scale, cudaStream_t s) {
  const size_t smem = dq_smem_floats<DP>() * sizeof(float);
  auto kern = flash_bwd_dq_kernel<DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + kB - 1) / kB, BH);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dq), N, d, scale);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dkv_fma(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dk, void* dv,
                   int BH, int N, int d, float scale, cudaStream_t s) {
  const size_t smem = dkv_smem_floats<DP>() * sizeof(float);
  auto kern = flash_bwd_dkv_kernel<DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + kB - 1) / kB, BH);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), N, d, scale);
  return (int)cudaGetLastError();
}

int dispatch_dq_fma(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dq, int BH, int N,
                    int d, float scale, cudaStream_t s) {
  if (d <= 32) return launch_dq_fma<32>(q, k, v, dout, lse, delta, dq, BH, N, d, scale, s);
  if (d <= 64) return launch_dq_fma<64>(q, k, v, dout, lse, delta, dq, BH, N, d, scale, s);
  return launch_dq_fma<128>(q, k, v, dout, lse, delta, dq, BH, N, d, scale, s);
}

int dispatch_dkv_fma(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dk, void* dv,
                     int BH, int N, int d, float scale, cudaStream_t s) {
  if (d <= 32) return launch_dkv_fma<32>(q, k, v, dout, lse, delta, dk, dv, BH, N, d, scale, s);
  if (d <= 64) return launch_dkv_fma<64>(q, k, v, dout, lse, delta, dk, dv, BH, N, d, scale, s);
  return launch_dkv_fma<128>(q, k, v, dout, lse, delta, dk, dv, BH, N, d, scale, s);
}

// ------------------------------------------------------- dK, dV, bf16, tensor cores

namespace tc {

using mma_bf16::bf16;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 16 * kWarps;  // keys per block, 16 per warp
constexpr int kStages = 4;        // query tiles in flight

// Queries per tile: 64, or 32 at d = 128, where dK and dV alone hold 128
// fp32 accumulators per lane.  K and V fragments stay in the registers up to
// d = 64; at d = 128 they are read from shared memory at each use.
template <int DP> __host__ __device__ constexpr int bq() { return DP == 128 ? 32 : 64; }
template <int DP> __host__ __device__ constexpr bool kv_in_regs() { return DP <= 64; }

template <int DP>
constexpr size_t dkv_smem_bytes() {  // kStages x (LSE, delta); K, V; kStages x (Q, dO)
  return 2 * kStages * (size_t)bq<DP>() * sizeof(float)
         + (size_t)(2 * kBK + 2 * kStages * bq<DP>()) * (DP + 8) * sizeof(bf16);
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int N,
    int d, float scale, bool vec) {
  using namespace mma_bf16;
  constexpr int BQ = bq<DP>();
  constexpr bool KV_REGS = kv_in_regs<DP>();
  constexpr int LD = DP + 8;   // padded row: ldmatrix without bank conflicts
  constexpr int KC = DP / 16;  // 16-wide chunks of the head dim
  constexpr int QT = BQ / 8;   // 8-query column tiles of S^T and dP^T
  constexpr int DT = DP / 8;   // 8-wide column tiles of dK and dV
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ls = reinterpret_cast<float*>(smem);  // [kStages][BQ] LSE, natural log
  float* Dl = Ls + kStages * BQ;               // [kStages][BQ] delta
  bf16* Ks = reinterpret_cast<bf16*>(Dl + kStages * BQ);
  bf16* Vs = Ks + kBK * LD;
  bf16* Qs = Vs + kBK * LD;            // [kStages][BQ * LD]
  bf16* dOs = Qs + kStages * BQ * LD;  // [kStages][BQ * LD]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int bh = blockIdx.y, k0 = blockIdx.x * kBK;
  const int64_t base = (int64_t)bh * N * d;
  const float* lse_bh = lse + (int64_t)bh * N;
  const float* delta_bh = delta + (int64_t)bh * N;
  const float qs = scale * kLog2e;
  const int ntiles = (N + BQ - 1) / BQ;

  // query tile j to stage j % kStages: Q, dO (bf16) and that tile's LSE and
  // delta, zeros past N; one commit group per tile (empty past the last)
  auto load_q_tile = [&](int j) {
    if (j < ntiles) {
      const int b = j % kStages, r0 = j * BQ;
      load_tile<BQ, DP, LD, kThreads>(Qs + b * BQ * LD, q + base, r0, N, d, vec);
      load_tile<BQ, DP, LD, kThreads>(dOs + b * BQ * LD, dout + base, r0, N, d, vec);
      for (int i = threadIdx.x; i < 2 * BQ; i += kThreads) {
        const int r = i % BQ;
        const bool ok = r0 + r < N;
        const float* src = i < BQ ? lse_bh : delta_bh;
        cp_async4((i < BQ ? Ls : Dl) + b * BQ + r, ok ? src + r0 + r : src, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  load_tile<kBK, DP, LD, kThreads>(Ks, k + base, k0, N, d, vec);
  load_tile<kBK, DP, LD, kThreads>(Vs, v + base, k0, N, d, vec);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) load_q_tile(j);  // K, V ride with tile 0
  cp_async_wait<kStages - 2>();
  __syncthreads();

  // A fragments of the warp's 16 keys (rows of K and V): in the registers,
  // or from shared memory at each use
  uint32_t kf[KV_REGS ? KC : 1][4], vf[KV_REGS ? KC : 1][4];
  if constexpr (KV_REGS) {
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      load_a(kf[c], Ks, LD, warp * 16, c * 16, lane);
      load_a(vf[c], Vs, LD, warp * 16, c * 16, lane);
    }
  }
  auto a_of = [&](uint32_t (&regs)[KV_REGS ? KC : 1][4], const bf16* tile, int c,
                  uint32_t (&a)[4]) {
    if constexpr (KV_REGS) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = regs[c][i];
    } else {
      load_a(a, tile, LD, warp * 16, c * 16, lane);
    }
  };

  float gk[DT][4], gv[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[n][e] = gv[n][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    if (j > 0) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // tile j has landed everywhere; tile j-1's stage is free
    }
    load_q_tile(j + kStages - 1);  // in flight while tiles j .. j+kStages-2 are computed
    const int b = j % kStages;
    const bf16* Qt = Qs + b * BQ * LD;
    const bf16* dOt = dOs + b * BQ * LD;
    const float* Lt = Ls + b * BQ;
    const float* Dt = Dl + b * BQ;
    const int qmax = N - j * BQ;  // queries of this tile that exist

    // S^T = K Q^T: the warp's 16 keys (rows) by the tile's queries
    float p[QT][4];
#pragma unroll
    for (int n = 0; n < QT; ++n) p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      uint32_t a[4];
      a_of(kf, Ks, c, a);
#pragma unroll
      for (int n = 0; n < QT; n += 2) {
        uint32_t bb[4];
        load_bt(bb, Qt, LD, n * 8, c * 16, lane);
        mma(p[n], a, bb[0], bb[1]);
        mma(p[n + 1], a, bb[2], bb[3]);
      }
    }
    // P^T = exp2(S^T * scale * log2(e) - LSE * log2(e)); queries past N give 0.
    // Element e of p[n] is key g (e < 2) or g+8, query 8n + 2t + (e & 1).
#pragma unroll
    for (int n = 0; n < QT; ++n) {
      const float2 L = *reinterpret_cast<const float2*>(Lt + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * t + (e & 1);
        p[n][e] = col < qmax ? exp2_approx(fmaf(p[n][e], qs, -((e & 1) ? L.y : L.x) * kLog2e))
                             : 0.f;
      }
    }

    // dV += P^T dO, P^T rounded to bf16 in the registers
#pragma unroll
    for (int c = 0; c < QT / 2; ++c) {
      uint32_t a[4];
      c_to_a(a, p[2 * c], p[2 * c + 1]);
#pragma unroll
      for (int n = 0; n < DT; n += 2) {
        uint32_t bb[4];
        load_b(bb, dOt, LD, c * 16, n * 8, lane);
        mma(gv[n], a, bb[0], bb[1]);
        mma(gv[n + 1], a, bb[2], bb[3]);
      }
    }

    // dP^T = V dO^T
    float ds[QT][4];
#pragma unroll
    for (int n = 0; n < QT; ++n) ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      uint32_t a[4];
      a_of(vf, Vs, c, a);
#pragma unroll
      for (int n = 0; n < QT; n += 2) {
        uint32_t bb[4];
        load_bt(bb, dOt, LD, n * 8, c * 16, lane);
        mma(ds[n], a, bb[0], bb[1]);
        mma(ds[n + 1], a, bb[2], bb[3]);
      }
    }
    // dS^T = P^T * (dP^T - delta)
#pragma unroll
    for (int n = 0; n < QT; ++n) {
      const float2 D = *reinterpret_cast<const float2*>(Dt + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[n][e] = p[n][e] * (ds[n][e] - ((e & 1) ? D.y : D.x));
    }

    // dK += dS^T Q, dS^T rounded to bf16 in the registers
#pragma unroll
    for (int c = 0; c < QT / 2; ++c) {
      uint32_t a[4];
      c_to_a(a, ds[2 * c], ds[2 * c + 1]);
#pragma unroll
      for (int n = 0; n < DT; n += 2) {
        uint32_t bb[4];
        load_b(bb, Qt, LD, c * 16, n * 8, lane);
        mma(gk[n], a, bb[0], bb[1]);
        mma(gk[n + 1], a, bb[2], bb[3]);
      }
    }
  }

  // the warp's K and V rows are read by this warp alone: stage there
  __syncwarp();
  bf16* Kw = Ks + warp * 16 * LD;
  bf16* Vw = Vs + warp * 16 * LD;
  stage_c<DT, LD>(Kw, gk, scale, scale, lane);
  stage_c<DT, LD>(Vw, gv, 1.f, 1.f, lane);
  __syncwarp();
  store_rows16<DP, LD>(dk + base, Kw, k0 + warp * 16, N, d, vec, lane);
  store_rows16<DP, LD>(dv + base, Vw, k0 + warp * 16, N, d, vec, lane);
}

template <int DP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv, int BH, int N,
               int d, float scale, cudaStream_t s) {
  const void* ptrs[] = {q, k, v, dout, dk, dv};
  const bool vec = mma_bf16::vec_ok(d, ptrs, 6);
  const size_t smem = dkv_smem_bytes<DP>();
  auto kern = flash_bwd_dkv_tc_kernel<DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + kBK - 1) / kBK, BH);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), N, d, scale, vec);
  return (int)cudaGetLastError();
}

int dispatch_dkv(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, void* dk, void* dv, int BH, int N,
                 int d, float scale, cudaStream_t s) {
  if (d <= 32) return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, BH, N, d, scale, s);
  if (d <= 64) return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, BH, N, d, scale, s);
  return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, BH, N, d, scale, s);
}

// ------------------------------------------------------- dQ, bf16, tensor cores

constexpr int kBQ = 16 * kWarps;  // queries per block, 16 per warp
constexpr int kDqStages = 3;      // key tiles in the ring: 3 blocks fit an SM

// Keys per tile: 64, or 32 at d = 128, where dQ alone holds 64 fp32
// accumulators per lane.  Q and dO fragments stay in the registers up to
// d = 64; at d = 128 they are read from shared memory at each use.
template <int DP> __host__ __device__ constexpr int dq_bk() { return DP == 128 ? 32 : 64; }
template <int DP> __host__ __device__ constexpr bool qo_in_regs() { return DP <= 64; }

template <int DP>
constexpr size_t dq_smem_bytes() {  // Q, dO; kDqStages x (K, V)
  return (size_t)(2 * kBQ + 2 * kDqStages * dq_bk<DP>()) * (DP + 8) * sizeof(bf16);
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int N, int d, float scale,
    bool vec) {
  using namespace mma_bf16;
  constexpr int BK = dq_bk<DP>();
  constexpr bool QO_REGS = qo_in_regs<DP>();
  constexpr int LD = DP + 8;   // padded row: ldmatrix without bank conflicts
  constexpr int KC = DP / 16;  // 16-wide chunks of the head dim
  constexpr int KT = BK / 8;   // 8-key column tiles of S and dP
  constexpr int DT = DP / 8;   // 8-wide column tiles of dQ
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kBQ * LD;
  bf16* Ks = dOs + kBQ * LD;          // [kDqStages][BK * LD]
  bf16* Vs = Ks + kDqStages * BK * LD;  // [kDqStages][BK * LD]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int64_t base = (int64_t)bh * N * d;
  const float qs = scale * kLog2e;
  const int ntiles = (N + BK - 1) / BK;

  // LSE (in log2) and delta of this lane's two rows, g and g+8 of the
  // warp's 16; rows past N give 0 (their Q and dO are zeros: dS = 0)
  float lg[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + warp * 16 + g + 8 * h;
    lg[h] = r < N ? lse[(int64_t)bh * N + r] * kLog2e : 0.f;
    dl[h] = r < N ? delta[(int64_t)bh * N + r] : 0.f;
  }

  // key tile j to stage j % kDqStages: K and V, zeros past N; one commit group
  // per tile (empty past the last)
  auto load_kv_tile = [&](int j) {
    if (j < ntiles) {
      const int b = j % kDqStages;
      load_tile<BK, DP, LD, kThreads>(Ks + b * BK * LD, k + base, j * BK, N, d, vec);
      load_tile<BK, DP, LD, kThreads>(Vs + b * BK * LD, v + base, j * BK, N, d, vec);
    }
    cp_async_commit();
  };

  load_tile<kBQ, DP, LD, kThreads>(Qs, q + base, q0, N, d, vec);
  load_tile<kBQ, DP, LD, kThreads>(dOs, dout + base, q0, N, d, vec);
#pragma unroll
  for (int j = 0; j < kDqStages - 1; ++j) load_kv_tile(j);  // Q, dO ride with tile 0
  cp_async_wait<kDqStages - 2>();
  __syncthreads();

  // A fragments of the warp's 16 queries (rows of Q and dO): in the
  // registers, or from shared memory at each use
  uint32_t qf[QO_REGS ? KC : 1][4], of[QO_REGS ? KC : 1][4];
  if constexpr (QO_REGS) {
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      load_a(qf[c], Qs, LD, warp * 16, c * 16, lane);
      load_a(of[c], dOs, LD, warp * 16, c * 16, lane);
    }
  }
  auto a_of = [&](uint32_t (&regs)[QO_REGS ? KC : 1][4], const bf16* tile, int c,
                  uint32_t (&a)[4]) {
    if constexpr (QO_REGS) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = regs[c][i];
    } else {
      load_a(a, tile, LD, warp * 16, c * 16, lane);
    }
  };

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    if (j > 0) {
      cp_async_wait<kDqStages - 2>();
      __syncthreads();  // tile j has landed everywhere; tile j-1's stage is free
    }
    load_kv_tile(j + kDqStages - 1);  // in flight while tiles j .. j+kDqStages-2 are computed
    const int b = j % kDqStages;
    const bf16* Kt = Ks + b * BK * LD;
    const bf16* Vt = Vs + b * BK * LD;
    const int kmax = N - j * BK;  // keys of this tile that exist

    // S = Q K^T: the warp's 16 queries (rows) by the tile's keys
    float p[KT][4];
#pragma unroll
    for (int n = 0; n < KT; ++n) p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      uint32_t a[4];
      a_of(qf, Qs, c, a);
#pragma unroll
      for (int n = 0; n < KT; n += 2) {
        uint32_t bb[4];
        load_bt(bb, Kt, LD, n * 8, c * 16, lane);
        mma(p[n], a, bb[0], bb[1]);
        mma(p[n + 1], a, bb[2], bb[3]);
      }
    }
    // P = exp2(S * scale * log2(e) - LSE * log2(e)); keys past N give 0.
    // Element e of p[n] is query g (e < 2) or g+8, key 8n + 2t + (e & 1).
#pragma unroll
    for (int n = 0; n < KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * t + (e & 1);
        p[n][e] = col < kmax ? exp2_approx(fmaf(p[n][e], qs, -lg[e >> 1])) : 0.f;
      }

    // dP = dO V^T
    float ds[KT][4];
#pragma unroll
    for (int n = 0; n < KT; ++n) ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      uint32_t a[4];
      a_of(of, dOs, c, a);
#pragma unroll
      for (int n = 0; n < KT; n += 2) {
        uint32_t bb[4];
        load_bt(bb, Vt, LD, n * 8, c * 16, lane);
        mma(ds[n], a, bb[0], bb[1]);
        mma(ds[n + 1], a, bb[2], bb[3]);
      }
    }
    // dS = P * (dP - delta), in fp32
#pragma unroll
    for (int n = 0; n < KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[n][e] = p[n][e] * (ds[n][e] - dl[e >> 1]);

    // dQ += dS K, dS rounded to bf16 in the registers, K by the transposing
    // ldmatrix on the same rows
#pragma unroll
    for (int c = 0; c < KT / 2; ++c) {
      uint32_t a[4];
      c_to_a(a, ds[2 * c], ds[2 * c + 1]);
#pragma unroll
      for (int n = 0; n < DT; n += 2) {
        uint32_t bb[4];
        load_b(bb, Kt, LD, c * 16, n * 8, lane);
        mma(acc[n], a, bb[0], bb[1]);
        mma(acc[n + 1], a, bb[2], bb[3]);
      }
    }
  }

  // the warp's Q rows are read by this warp alone: stage dQ * scale there
  __syncwarp();
  bf16* Qw = Qs + warp * 16 * LD;
  stage_c<DT, LD>(Qw, acc, scale, scale, lane);
  __syncwarp();
  store_rows16<DP, LD>(dq + base, Qw, q0 + warp * 16, N, d, vec, lane);
}

template <int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int BH, int N, int d,
              float scale, cudaStream_t s) {
  const void* ptrs[] = {q, k, v, dout, dq};
  const bool vec = mma_bf16::vec_ok(d, ptrs, 5);
  const size_t smem = dq_smem_bytes<DP>();
  auto kern = flash_bwd_dq_tc_kernel<DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + kBQ - 1) / kBQ, BH);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), N, d, scale, vec);
  return (int)cudaGetLastError();
}

int dispatch_dq(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dq, int BH, int N, int d,
                float scale, cudaStream_t s) {
  if (d <= 32) return launch_dq<32>(q, k, v, dout, lse, delta, dq, BH, N, d, scale, s);
  if (d <= 64) return launch_dq<64>(q, k, v, dout, lse, delta, dq, BH, N, d, scale, s);
  return launch_dq<128>(q, k, v, dout, lse, delta, dq, BH, N, d, scale, s);
}

}  // namespace tc

bool bad_shape(int BH, int N, int d) {
  return BH <= 0 || N <= 0 || d <= 0 || d > 128 || BH > 65535;
}

}  // namespace

// q, k, v, dout, dq: (BH, N, d) contiguous, fp32 (is_bf16 = 0) or bf16 (1),
// d <= 128.  lse (natural log) and delta = rowsum(dout * o): (BH, N) fp32.
// scale: the softmax scale of the forward, 1/sqrt(d) for SDPA.
// bf16 on the tensor-core kernel, fp32 on the FMA kernel.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int BH, int N,
                                 int d, float scale, int is_bf16, void* stream) {
  if (bad_shape(BH, N, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* de = static_cast<const float*>(delta);
  return is_bf16 ? tc::dispatch_dq(q, k, v, dout, l, de, dq, BH, N, d, scale, s)
                 : dispatch_dq_fma(q, k, v, dout, l, de, dq, BH, N, d, scale, s);
}

// As flash_attn_bwd_dq, writing dk and dv: (BH, N, d) in the input dtype;
// bf16 on the tensor-core kernel, fp32 on the FMA kernel.
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int BH,
                                  int N, int d, float scale, int is_bf16,
                                  void* stream) {
  if (bad_shape(BH, N, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* de = static_cast<const float*>(delta);
  return is_bf16 ? tc::dispatch_dkv(q, k, v, dout, l, de, dk, dv, BH, N, d, scale, s)
                 : dispatch_dkv_fma(q, k, v, dout, l, de, dk, dv, BH, N, d, scale, s);
}
