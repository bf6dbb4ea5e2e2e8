// Helpers for bf16 tensor-core kernels on sm_90a: 16-byte cp.async with
// zero fill, ldmatrix (plain and transposed) and mma.sync m16n8k16 with
// fp32 accumulators.  Included by flash_attn.cu and flash_attn_bwd.cu, and
// by gn_silu.cu for the cp.async helpers; ops/cuda_build.py hashes every
// csrc/*.cuh into each library's name, so a change here rebuilds all three.
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col (PTX ISA), for a
// lane with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row major), 4 regs of 2 bf16: a0 = A[g][2t..2t+1],
//     a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]
//   B (16 x 8, "col"), 2 regs: b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C (16 x 8, fp32), 4 floats: c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..]
// So two neighbouring C tiles (columns 0-7 and 8-15), rounded to bf16 and
// paired as (c0,c1), (c2,c3), (c0',c1'), (c2',c3'), are the A fragment of
// their 16 columns: a product's result feeds the next product's A operand
// without leaving the registers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes global -> shared without the registers; src_bytes < 16
// fills the rest of the 16 with zeros (0: all zeros, src not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// As cp_async16, for 4 bytes.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until this thread's copies committed before the last n groups landed.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n) : "memory");
}

// Four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i holds row g, elements 2t, 2t+1 of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// As ldsm_x4, each matrix transposed: register i holds rows 2t, 2t+1 of
// column g of matrix i.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// c += A B for one 16x16 A fragment and one 16x8 B fragment (b0, b1).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU's ex2.approx (2 ulp; -inf gives 0, subnormal results 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16 in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of 16 columns from the C fragments of its two 8-column
// halves (see the note at the top).
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack(lo[0], lo[1]);
  a[1] = pack(lo[2], lo[3]);
  a[2] = pack(hi[0], hi[1]);
  a[3] = pack(hi[2], hi[3]);
}

// The A fragment of rows r0..r0+15, columns c0..c0+15 of a row-major
// shared tile with row stride ld (elements).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int ld, int r0,
                                       int c0, int lane) {
  ldsm_x4(a, tile + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8);
}

// B fragments of two 8-column tiles for B = M^T, M row-major in shared
// memory (n rows, k columns, stride ld): rows n0..n0+15, columns k0..k0+15.
// b[0], b[1] serve columns n0..n0+7 of B; b[2], b[3] columns n0+8..n0+15.
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], const bf16* tile, int ld, int n0,
                                        int k0, int lane) {
  const int m = lane >> 3, r = lane & 7;
  ldsm_x4(b, tile + (n0 + (m >> 1) * 8 + r) * ld + k0 + (m & 1) * 8);
}

// B fragments of two 8-column tiles for B = M, M row-major in shared
// memory (k rows, n columns, stride ld): rows k0..k0+15, columns n0..n0+15,
// by the transposing ldmatrix.  b[0], b[1] serve columns n0..n0+7;
// b[2], b[3] columns n0+8..n0+15.
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile, int ld, int k0,
                                       int n0, int lane) {
  const int m = lane >> 3, r = lane & 7;
  ldsm_x4_t(b, tile + (k0 + (m & 1) * 8 + r) * ld + n0 + (m >> 1) * 8);
}

// Rows r0..r0+ROWS-1 of a (N, d) bf16 matrix into a shared tile of row
// stride LD and DP columns, zeros past N and past d.  vec (d % 8 == 0 and
// a 16-byte aligned matrix): 16-byte cp.async, to be committed and waited
// for by the caller; otherwise plain 2-byte loads and stores.
template <int ROWS, int DP, int LD, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int r0,
                                          int N, int d, bool vec) {
  if (vec) {
    constexpr int CH = DP / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = r0 + r < N && c < d;
      cp_async16(dst + r * LD + c, ok ? src + (int64_t)(r0 + r) * d + c : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += THREADS) {
      const int r = i / DP, c = i % DP;
      dst[r * LD + c] = (r0 + r < N && c < d) ? src[(int64_t)(r0 + r) * d + c]
                                              : __float2bfloat16(0.f);
    }
  }
}

// Rows 0..15 of a warp's staged bf16 tile (stride LD, DP columns) to rows
// row0.. of a (N, d) matrix, rows past N and columns past d not stored;
// 16-byte stores when vec (as load_tile).
template <int DP, int LD>
__device__ __forceinline__ void store_rows16(bf16* __restrict__ dst, const bf16* tile,
                                             int row0, int N, int d, bool vec, int lane) {
  if (vec) {
    constexpr int CH = DP / 8;
    for (int i = lane; i < 16 * CH; i += 32) {
      const int r = i / CH, c = (i % CH) * 8;
      if (row0 + r < N && c < d)
        *reinterpret_cast<uint4*>(dst + (int64_t)(row0 + r) * d + c) =
            *reinterpret_cast<const uint4*>(tile + r * LD + c);
    }
  } else {
    for (int i = lane; i < 16 * DP; i += 32) {
      const int r = i / DP, c = i % DP;
      if (row0 + r < N && c < d) dst[(int64_t)(row0 + r) * d + c] = tile[r * LD + c];
    }
  }
}

// Stage a warp's C fragments (16 rows x 8*NT columns, scaled by s_lo for
// rows g and s_hi for rows g+8) as bf16 into rows 0..15 of tile.  With
// LD = DP + 8 the 4-byte writes of a warp hit 32 distinct banks.
template <int NT, int LD>
__device__ __forceinline__ void stage_c(bf16* tile, const float (&c)[NT][4], float s_lo,
                                        float s_hi, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<uint32_t*>(tile + g * LD + n * 8 + 2 * t) =
        pack(c[n][0] * s_lo, c[n][1] * s_lo);
    *reinterpret_cast<uint32_t*>(tile + (g + 8) * LD + n * 8 + 2 * t) =
        pack(c[n][2] * s_hi, c[n][3] * s_hi);
  }
}

// Tensor-core path when d is a multiple of 8 and every operand 16-byte
// aligned (16-byte copies), else the same kernel with 2-byte copies.
__host__ __forceinline__ bool vec_ok(int d, const void* const* ptrs, int n) {
  if (d % 8) return false;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
  return true;
}

}  // namespace mma_bf16
