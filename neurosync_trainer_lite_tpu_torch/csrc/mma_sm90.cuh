// Warp-level tensor-core helpers shared by K3 (flash_attention.cu) and the
// K4 backward (fused_attention.cu), for sm_90a: cp.async copies, ldmatrix
// loads, mma.sync.m16n8k16 with bf16 operands and fp32 accumulation, the
// split of an fp32 value into two bf16 halves, and the row reductions and
// softmax pieces of an m16n8 accumulator tile.
//
// Accumulator layout (m16n8, fp32): lane l holds rows l / 4 and l / 4 + 8,
// columns 2 (l % 4) + {0, 1} of each n8 block; packed to bf16 it is the A
// fragment of the next m16k16 product, so scores, p and ds feed the next
// product from registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;  // bf16 a padded shared row beyond h: 16 bytes

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// global -> shared without passing through registers; src-size 0 writes
// zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices from shared memory, one row address a lane
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d[16 x 8] += a[16 x 16] . b[16 x 8], bf16 operands, fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// (x, y) as bf16 hi = bf16(.) and lo = bf16(. - hi), x in the low half
__device__ __forceinline__ void split2(float x, float y, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// the fragment's two rows: lane / 4 and lane / 4 + 8; its columns in each
// n8 block j: j * 8 + 2 * (lane % 4) + {0, 1}. Element e of acc[j] lies in
// row half e / 2, column e % 2.
__device__ __forceinline__ int frag_col(int j, int e, int lane) {
  return j * 8 + 2 * (lane & 3) + (e & 1);
}

// the max and the sum over the four lanes that share a fragment row: a
// butterfly, so every lane gets the same bits
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// acc[16 x N] += A[16 x HD] . B[N x HD]^T: A the warp's 16 rows of one
// shared tile, B N rows of another, both row-major along HD with rows padded
// to HD + kPad (K3's q.k^T, dO.v^T and, in its dk/dv kernel, k.q^T, v.dO^T)
template <int HD, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4], const bf16* a, const bf16* b,
                                        int lane) {
  constexpr int P = HD + kPad;
  const int r = lane & 7, m8 = ((lane >> 3) & 1) * 8, m16 = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    unsigned af[4];
    ldsm_x4(af, a + (r + m8) * P + kk + m16);
#pragma unroll
    for (int n = 0; n < N; n += 16) {
      unsigned bf[4];
      ldsm_x4(bf, b + (n + r + m16) * P + kk + m8);
      mma_bf16(acc[n / 8], af, bf[0], bf[1]);
      mma_bf16(acc[n / 8 + 1], af, bf[2], bf[3]);
    }
  }
}

// s := -inf for keys t0 + column past len (the last tile only)
template <int N>
__device__ __forceinline__ void mask_keys(float (&s)[N / 8][4], int t0, int len, int lane) {
  if (t0 + N <= len) return;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (t0 + frag_col(j, e, lane) >= len) s[j][e] = -INFINITY;
}

// exp(scale . s - m) for a raw score s and a log2-domain max m = c . max s
// (c = scale . log2 e > 0, so the max of the scaled scores is the scaled
// max): one FFMA and one MUFU exp2
__device__ __forceinline__ float exp_shifted(float s, float c, float m) {
  return exp2f(fmaf(s, c, -m));
}

// the row max of the raw scores of row half h, over the fragment's lanes,
// in the log2 domain
template <int N>
__device__ __forceinline__ float row_max(const float (&s)[N / 8][4], int h, float c) {
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
  return quad_max(mx) * c;
}

}  // namespace
