// The tail of a training update over the optimizer state: the global-norm
// clip and AdamW in one pass (adamw_update), the EMA lerp toward the new
// parameters (ema_lerp) and the global gradient norm (grad_norm).
// Target: sm_90a (H100).  Plain C interface, loaded with ctypes by
// ddpm_diffusion_model_tpu_torch/ops/fused_update.py.
//
// Replaces no TPU kernel: the JAX package leaves optax's update and the EMA
// to XLA, which fuses them.  The port's plain version is a sequence of
// multi-tensor ops (training/state.py AdamWClip.step, the EMA's
// ema_lerp_reference) that makes 14 passes over fp32 tensors the size of
// the parameters, 128 bytes a parameter with its temporaries.  Per
// parameter adamw_update reads g, p, m, v once and writes p, m, v once (28
// bytes, 26 with bf16 m), ema_lerp reads p and the shadow e and writes e
// (12 bytes): 40 bytes in all, 44 where the clip needs the norm first (a
// read-only pass over g before the update).  The EMA is a pass of its own
// so that it stays the train step's own call (training/ema.py ema_update).
//
// Arithmetic: the plain sequence's, op for op in fp32, each rounding where
// the multi-tensor op rounds (__f*_rn keeps nvcc from contracting what
// PyTorch's kernels do not, __fmaf_rn is where they do):
//     g  = g * factor                         (clip: factor = 1 or clip/||g||)
//     m  = fma(1 - b1, g, m * b1)             (bf16 m: g*(1-b1) + m*b1_lo)
//     v  = fma(1 - b2, g*g, v * b2)
//     u  = (m * ibc1) / (sqrt(v * ibc2) + 1e-8)   (ibc = 1/bc in fp32: the
//                                             multi-tensor division by a
//                                             scalar multiplies by it)
//     u  = fma(wd, p, u)                      (only when wd != 0)
//     p  = p + u * (-lr)
//     e  = fma(1 - d, p, e * d)               (ema_lerp)
//
// What bounds it on the card: bytes (a handful of flops per 28 bytes).
// Design.  One launch covers every tensor: the host lays one record per
// tensor (its pointers, its size, its first chunk) in pinned memory and
// copies it to the device on the stream, so the gradients' addresses, new
// every update, reach the kernel without a host sync.  A block takes one
// chunk of kChunk elements of one tensor (it finds the tensor by a binary
// search over the records' first chunks), so the grid is the sum of the
// tensors' chunks: ~256K blocks at a billion parameters, enough to keep
// 132 SMs fed.  A thread moves 16 bytes of each operand a step (8 for a
// bf16 m) where every operand of the chunk is so aligned, and single
// elements in the tail of a tensor and where one is not.
// The norm is a deterministic two-stage sum without atomics: each block
// writes its chunk's sum of g^2 (in fp64 past the thread) to a scratch
// slot, and one finishing block sums the slots in a fixed order and writes
// sqrt as fp32.  Without a clip the update pass itself writes the slots
// (the norm is only a metric there); with a clip the read-only grad_norm
// pass runs first and the update reads its result from device memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;       // elements a block takes (CHUNK in fused_update.py)
constexpr int kFinishThreads = 1024;

// One tensor's records, as fused_update.py packs them (int64 words: the
// pointers, the size, the first chunk).
struct Rec {  // the update's and the norm's
  float* p;
  const float* g;
  void* m;
  float* v;
  long long n;
  long long first;
};

struct EmaRec {
  float* e;
  const float* p;
  long long n;
  long long first;
};

struct Hyper {
  float b1, a1, b2, a2, ibc1, ibc2, wd, neg_lr, b1_lo, clip;
};

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// The record of the tensor chunk ``c`` lies in: the last whose first chunk
// is at most c (records with no chunk are never packed).
template <typename R>
__device__ __forceinline__ int find_rec(const R* __restrict__ recs, int nrec, long long c) {
  int lo = 0, hi = nrec - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (recs[mid].first <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

template <bool kBf16>
__device__ __forceinline__ float load_m(const void* m, long long i) {
  if (kBf16) return __bfloat162float(static_cast<const __nv_bfloat16*>(m)[i]);
  return static_cast<const float*>(m)[i];
}

template <bool kBf16>
__device__ __forceinline__ void store_m(void* m, long long i, float x) {
  if (kBf16) static_cast<__nv_bfloat16*>(m)[i] = __float2bfloat16_rn(x);
  else static_cast<float*>(m)[i] = x;
}

// One element of the update, in the plain sequence's roundings.
template <bool kBf16>
__device__ __forceinline__ void update(float& p, float g, float& m, float& v, const Hyper& h) {
  const float mn = kBf16 ? __fadd_rn(__fmul_rn(g, h.a1), __fmul_rn(m, h.b1_lo))
                         : __fmaf_rn(h.a1, g, __fmul_rn(m, h.b1));
  const float vn = __fmaf_rn(h.a2, __fmul_rn(g, g), __fmul_rn(v, h.b2));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(vn, h.ibc2)), 1e-8f);
  float u = __fdiv_rn(__fmul_rn(mn, h.ibc1), den);
  if (h.wd != 0.f) u = __fmaf_rn(h.wd, p, u);
  p = __fadd_rn(p, __fmul_rn(u, h.neg_lr));
  m = mn;
  v = vn;
}

// The block's sum of ``acc`` over its threads, in fp64 in a fixed order,
// written to ``out`` by thread 0.
__device__ __forceinline__ void block_sum(double acc, double* out) {
  __shared__ double warp_sums[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
    *out = s;
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(const Rec* __restrict__ recs, int nrec, Hyper h, int clip,
                 const float* __restrict__ norm_in, double* __restrict__ partials) {
  const long long c = blockIdx.x;
  const Rec r = recs[find_rec(recs, nrec, c)];
  const long long start = (c - r.first) * kChunk;
  const long long end = min(start + (long long)kChunk, r.n);
  float factor = 1.f;
  if (clip) {
    const float nrm = *norm_in;
    factor = nrm < h.clip ? 1.f : __fmul_rn(__fdiv_rn(1.f, nrm), h.clip);
  }
  float* __restrict__ P = r.p;
  const float* __restrict__ G = r.g;
  void* __restrict__ M = r.m;
  float* __restrict__ V = r.v;
  float acc = 0.f;
  long long tail = start;
  if (aligned(P + start, 16) && aligned(G + start, 16) && aligned(V + start, 16)
      && aligned(static_cast<char*>(M) + start * (kBf16 ? 2 : 4), kBf16 ? 8 : 16)) {
    const long long vend = start + ((end - start) & ~3LL);
    for (long long i = start + 4 * threadIdx.x; i < vend; i += 4 * kThreads) {
      float4 p4 = *reinterpret_cast<const float4*>(P + i);
      float4 g4 = *reinterpret_cast<const float4*>(G + i);
      float4 v4 = *reinterpret_cast<const float4*>(V + i);
      float4 m4;
      if (kBf16) {
        const uint2 raw = *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(M) + i);
        const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        m4 = make_float4(lo.x, lo.y, hi.x, hi.y);
      } else {
        m4 = *reinterpret_cast<const float4*>(static_cast<const float*>(M) + i);
      }
      if (partials) {
        acc = __fmaf_rn(g4.x, g4.x, acc); acc = __fmaf_rn(g4.y, g4.y, acc);
        acc = __fmaf_rn(g4.z, g4.z, acc); acc = __fmaf_rn(g4.w, g4.w, acc);
      }
      if (clip) {
        g4.x = __fmul_rn(g4.x, factor); g4.y = __fmul_rn(g4.y, factor);
        g4.z = __fmul_rn(g4.z, factor); g4.w = __fmul_rn(g4.w, factor);
      }
      update<kBf16>(p4.x, g4.x, m4.x, v4.x, h);
      update<kBf16>(p4.y, g4.y, m4.y, v4.y, h);
      update<kBf16>(p4.z, g4.z, m4.z, v4.z, h);
      update<kBf16>(p4.w, g4.w, m4.w, v4.w, h);
      *reinterpret_cast<float4*>(P + i) = p4;
      *reinterpret_cast<float4*>(V + i) = v4;
      if (kBf16) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(m4.x, m4.y);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(m4.z, m4.w);
        uint2 raw;
        raw.x = *reinterpret_cast<const uint32_t*>(&lo);
        raw.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(M) + i) = raw;
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(M) + i) = m4;
      }
    }
    tail = vend;
  }
  for (long long i = tail + threadIdx.x; i < end; i += kThreads) {
    float p = P[i], g = G[i], m = load_m<kBf16>(M, i), v = V[i];
    if (partials) acc = __fmaf_rn(g, g, acc);
    if (clip) g = __fmul_rn(g, factor);
    update<kBf16>(p, g, m, v, h);
    P[i] = p;
    V[i] = v;
    store_m<kBf16>(M, i, m);
  }
  if (partials) block_sum((double)acc, partials + c);
}

// e = fma(omd, p, e * d) over one chunk of one tensor.
__global__ void __launch_bounds__(kThreads)
ema_kernel(const EmaRec* __restrict__ recs, int nrec, float d, float omd) {
  const long long c = blockIdx.x;
  const EmaRec r = recs[find_rec(recs, nrec, c)];
  const long long start = (c - r.first) * kChunk;
  const long long end = min(start + (long long)kChunk, r.n);
  float* __restrict__ E = r.e;
  const float* __restrict__ P = r.p;
  long long tail = start;
  if (aligned(E + start, 16) && aligned(P + start, 16)) {
    const long long vend = start + ((end - start) & ~3LL);
    for (long long i = start + 4 * threadIdx.x; i < vend; i += 4 * kThreads) {
      const float4 p4 = *reinterpret_cast<const float4*>(P + i);
      float4 e4 = *reinterpret_cast<const float4*>(E + i);
      e4.x = __fmaf_rn(omd, p4.x, __fmul_rn(e4.x, d));
      e4.y = __fmaf_rn(omd, p4.y, __fmul_rn(e4.y, d));
      e4.z = __fmaf_rn(omd, p4.z, __fmul_rn(e4.z, d));
      e4.w = __fmaf_rn(omd, p4.w, __fmul_rn(e4.w, d));
      *reinterpret_cast<float4*>(E + i) = e4;
    }
    tail = vend;
  }
  for (long long i = tail + threadIdx.x; i < end; i += kThreads)
    E[i] = __fmaf_rn(omd, P[i], __fmul_rn(E[i], d));
}

__global__ void __launch_bounds__(kThreads)
sum_sq_kernel(const Rec* __restrict__ recs, int nrec, double* __restrict__ partials) {
  const long long c = blockIdx.x;
  const Rec r = recs[find_rec(recs, nrec, c)];
  const long long start = (c - r.first) * kChunk;
  const long long end = min(start + (long long)kChunk, r.n);
  const float* __restrict__ G = r.g;
  float acc = 0.f;
  long long tail = start;
  if (aligned(G + start, 16)) {
    const long long vend = start + ((end - start) & ~3LL);
    for (long long i = start + 4 * threadIdx.x; i < vend; i += 4 * kThreads) {
      const float4 g4 = *reinterpret_cast<const float4*>(G + i);
      acc = __fmaf_rn(g4.x, g4.x, acc); acc = __fmaf_rn(g4.y, g4.y, acc);
      acc = __fmaf_rn(g4.z, g4.z, acc); acc = __fmaf_rn(g4.w, g4.w, acc);
    }
    tail = vend;
  }
  for (long long i = tail + threadIdx.x; i < end; i += kThreads) acc = __fmaf_rn(G[i], G[i], acc);
  block_sum((double)acc, partials + c);
}

// sqrt of the sum of ``n`` partial sums, in a fixed order, as fp32.
__global__ void __launch_bounds__(kFinishThreads)
finish_kernel(const double* __restrict__ partials, long long n, float* __restrict__ out) {
  __shared__ double warp_sums[kFinishThreads / 32];
  double s = 0.0;
  for (long long i = threadIdx.x; i < n; i += kFinishThreads) s += partials[i];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
    for (int w = 0; w < kFinishThreads / 32; ++w) t += warp_sums[w];
    *out = (float)sqrt(t);
  }
}

bool bad_grid(int nrec, long long nchunks) {
  return nrec <= 0 || nchunks <= 0 || nchunks > 0x7fffffffLL;
}

}  // namespace

// The update over ``nrec`` records (device memory) covering ``nchunks``
// chunks.  ``clip``: scale g by 1 or clip/norm, the norm read from
// ``norm_in``.  ``partials`` (nchunks fp64, or null): also sum g^2 (before
// the clip) and write the norm to ``norm_out``.
extern "C" int adamw_update(const void* recs, int nrec, long long nchunks, int mu_bf16, int clip,
                            const void* norm_in, void* partials, void* norm_out, float b1,
                            float a1, float b2, float a2, float ibc1, float ibc2, float wd,
                            float neg_lr, float b1_lo, float clip_value, void* stream) {
  if (bad_grid(nrec, nchunks) || (clip && !norm_in) || (partials && !norm_out))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rec* r = static_cast<const Rec*>(recs);
  const float* nin = static_cast<const float*>(norm_in);
  double* part = static_cast<double*>(partials);
  const Hyper h{b1, a1, b2, a2, ibc1, ibc2, wd, neg_lr, b1_lo, clip_value};
  const dim3 grid((unsigned)nchunks);
  if (mu_bf16)
    adamw_kernel<true><<<grid, kThreads, 0, s>>>(r, nrec, h, clip, nin, part);
  else
    adamw_kernel<false><<<grid, kThreads, 0, s>>>(r, nrec, h, clip, nin, part);
  if (part)
    finish_kernel<<<1, kFinishThreads, 0, s>>>(part, nchunks, static_cast<float*>(norm_out));
  return (int)cudaGetLastError();
}

// The EMA over ``nrec`` EMA records covering ``nchunks`` chunks:
// e = fma(omd, p, e * d), with d and omd = 1 - d rounded to fp32 by the
// caller.
extern "C" int ema_lerp(const void* recs, int nrec, long long nchunks, float d, float omd,
                        void* stream) {
  if (bad_grid(nrec, nchunks)) return (int)cudaErrorInvalidValue;
  ema_kernel<<<(unsigned)nchunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const EmaRec*>(recs), nrec, d, omd);
  return (int)cudaGetLastError();
}

// sqrt(sum of g^2) over the records' gradients, into ``norm_out`` (fp32),
// through ``partials`` (nchunks fp64).
extern "C" int grad_norm(const void* recs, int nrec, long long nchunks, void* partials,
                         void* norm_out, void* stream) {
  if (bad_grid(nrec, nchunks) || !partials || !norm_out) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* part = static_cast<double*>(partials);
  sum_sq_kernel<<<(unsigned)nchunks, kThreads, 0, s>>>(static_cast<const Rec*>(recs), nrec,
                                                       part);
  finish_kernel<<<1, kFinishThreads, 0, s>>>(part, nchunks, static_cast<float*>(norm_out));
  return (int)cudaGetLastError();
}
