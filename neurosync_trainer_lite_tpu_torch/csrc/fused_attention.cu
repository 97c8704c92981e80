// K4: RoPE + per-head softmax(q.k^T * scale).v on unsplit [B, T, H]
// tensors, forward and backward, for sm_90a.
//
// Replaces the two Pallas kernels of
// neurosync_trainer_lite_tpu/ops/fused_attention.py: the forward
// (_fwd_kernel / _fwd_call / fused_rope_attention) and the backward
// (_bwd_kernel / _bwd_call, the custom VJP). q, k and v are rotated and
// multiplied in fp32; every output is written once in its input's type. The
// rotation runs over the full H row with circular neighbours at H (the
// Pallas body's _rot), so it is right for any tables, not only the per-head
// tiled ones.
//
// Forward. Bound on the H100: operations. At the serving shape (B=17 chunks
// of a 30 s clip, T=128, H=1024, 16 heads of 64) the kernel moves ~21 MB but
// does ~1.2 GFLOP of fp32 math, and fp32 runs on the CUDA cores
// (67 TFLOP/s), not on the tensor cores. Design, simple first: one block per (batch row, head,
// 128-query tile). The block rotates the head's K and loads its V into
// shared memory as fp32 (2 * Tk * head_dim * 4 bytes, 64 KB at Tk=128,
// head_dim=64, hence the dynamic shared-memory attribute). Each thread owns
// one query row: its rotated q and its output accumulator live in
// registers (head_dim is a template parameter), and every thread of a warp
// reads the same K/V row at once, so shared-memory reads are broadcasts.
// The softmax takes two passes over the keys: the row max, then exp-sum and
// p.v. The [Tq, Tk] scores never leave registers. No tensor cores, TMA or
// wgmma yet: that is the next step for speed.
//
// Backward, two kernels chosen by dtype in dispatch(): bf16 (the training
// step's) runs attn_bwd_mma_kernel on the tensor cores, fp32 runs
// attn_bwd_kernel on the CUDA cores. Both: one block per (batch row, head),
// which stages the head's rotated Q and K and its V and dO in shared memory;
// nothing [Tq, Tk] is stored, p is recomputed from q.k in every pass. A
// query-row pass takes the row max and the row sum of exp online and D_i =
// sum_t p_it * dp_it (fp32, recomputed, not taken from the rounded forward
// output), then dq_i = scale * sum_t ds_it * k_t with ds = p * (dp - D); the
// row statistics go to shared memory. A key-row pass takes dv_t = sum_i
// p_it * do_i and dk_t = scale * sum_i ds_it * q_i. Every sum has one owner,
// so there are no float atomics and the gradients are bitwise the same from
// run to run. dv is written in v's type. dq and dk are still in the rotated
// domain and the transpose rotation mixes neighbours across head edges,
// which belong to other blocks: they go to fp32 workspaces, and the wrapper
// applies the transpose rotation there (kernel K1, fp32 in and out) and
// rounds once (ops/fused_attention.py).
//
// What bounds it on the H100. At the training shape (B=128 windows, T=128,
// H=1024, 16 heads of 64) q, k, v, dO and the three outputs are 7 x 33.5 MB
// = 235 MB (0.070 ms at 3.35 TB/s); the five T x T x head_dim products of
// each head are 10.B.T.T.H = 21.5 GFLOP (0.022 ms at the tensor cores' 989
// TFLOP/s, 0.32 ms on the fp32 CUDA cores). So bytes, once the products run
// on the tensor cores.
//
// bf16, attn_bwd_mma_kernel. The rounding points are the Pallas body's
// (fp32 rotation, scores, softmax, p, ds and sums); the products run on
// mma.sync.m16n8k16 with bf16 operands and fp32 accumulation (the helpers
// of mma_sm90.cuh, as K3's). The operands that are not exact in bf16 (the
// rotated q and k, p and ds) are split once into hi = bf16(x) and lo =
// bf16(x - hi): a product whose two operands are split takes three mma
// (hi.hi + hi.lo + lo.hi, ~16 significant bits a term), pT.dO two, dO.vT
// one. The load phase rotates q and k in fp32 over the full H row (circular
// neighbours, 8 columns a thread) and stores hi and lo tiles of Q and K
// beside V and dO. hi + lo is 4 bytes an element, the fp32 value's size, so
// a block's shared memory is the CUDA-core kernel's to the byte (the gate
// ops/fused_attention.py:fits_smem holds for both): 99,840 B at T=128,
// head_dim 64, two blocks an SM. Rows are not padded: chunk c of row r is
// stored at chunk c ^ (r / R mod C) (C 16-byte chunks a row, R rows in 128
// bytes), so the eight rows of an ldmatrix phase fall in distinct banks.
// Four warps; each owns a 16-row tile of queries, then of keys, and streams
// the other side 64 rows a step: q.kT (split) and dO.vT, the online
// statistics, then again with ds and dq += ds.k (split); then k.qT and
// v.dOT, pT and dsT from the statistics, dv += pT.dO and dk += dsT.q.
// Rows past Tq or Tk are read from the last row (finite) and masked: keys
// score -inf and queries take p = ds = 0; they are never written.
//
// fp32, attn_bwd_kernel, the first design. Threads own rows: its rotated Q
// and K (fp32) and V and dO stay in shared memory, each thread keeps its
// rows of head_dim in registers, the key-row pass makes one pass for dv and
// another for dk (three register rows a thread); it recomputes q.k four
// times and do.v twice a pair (640 FMAs where the products need 320).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kQueryTile = 128;
// Blocks per SM the register budget must allow: at head_dim 64 a block
// takes 64 KB of shared memory, so 3 fit in 227 KB, and 3 x 128 threads
// need <= 168 registers each (the serving batch then runs in one wave).
constexpr int kMinBlocksPerSm = 3;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// x*cos + roll(x,-1)*a + roll(x,+1)*b at column j of one [H] row, in the
// plain version's order and rounding.
template <typename T>
__device__ __forceinline__ float rotate_at(const T* row, const float* c, const float* a,
                                           const float* b, int j, int h_width) {
  const int jn = (j + 1 == h_width) ? 0 : j + 1;
  const int jp = (j == 0) ? h_width - 1 : j - 1;
  float o = __fmul_rn(to_f32(row[j]), c[j]);
  o = __fadd_rn(o, __fmul_rn(to_f32(row[jn]), a[j]));
  return __fadd_rn(o, __fmul_rn(to_f32(row[jp]), b[j]));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kQueryTile, kMinBlocksPerSm)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ cq,
                         const float* __restrict__ aq, const float* __restrict__ bq,
                         const float* __restrict__ ck, const float* __restrict__ ak,
                         const float* __restrict__ bk, T* __restrict__ out, int tq_len,
                         int tk_len, int h_width, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                            // [Tk][HD] rotated keys
  float* vs = smem + (size_t)tk_len * HD;      // [Tk][HD] values
  const int bi = blockIdx.x;
  const int col0 = blockIdx.y * HD;
  const T* kb = k + (long long)bi * tk_len * h_width;
  const T* vb = v + (long long)bi * tk_len * h_width;

  for (int e = threadIdx.x; e < tk_len * HD; e += blockDim.x) {
    const int t = e / HD;
    const int j = col0 + e % HD;
    const long long off = (long long)t * h_width;
    ks[e] = rotate_at(kb + off, ck + off, ak + off, bk + off, j, h_width);
    vs[e] = to_f32(vb[off + j]);
  }
  __syncthreads();

  const int i = blockIdx.z * kQueryTile + threadIdx.x;
  if (i >= tq_len) return;
  const long long qoff = (long long)i * h_width;
  const T* qrow = q + (long long)bi * tq_len * h_width + qoff;

  float qr[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c)
    qr[c] = rotate_at(qrow, cq + qoff, aq + qoff, bq + qoff, col0 + c, h_width);

  // pass 1: the row max of the scaled scores
  float m = -INFINITY;
  for (int t = 0; t < tk_len; ++t) {
    const float* kt = ks + t * HD;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < HD; ++c) s = fmaf(qr[c], kt[c], s);
    m = fmaxf(m, __fmul_rn(s, scale));
  }

  // pass 2: the same scores again, exp, row sum and p.v
  float acc[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) acc[c] = 0.f;
  float l = 0.f;
  for (int t = 0; t < tk_len; ++t) {
    const float* kt = ks + t * HD;
    const float* vt = vs + t * HD;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < HD; ++c) s = fmaf(qr[c], kt[c], s);
    const float p = expf(__fmul_rn(s, scale) - m);
    l += p;
#pragma unroll
    for (int c = 0; c < HD; ++c) acc[c] = fmaf(p, vt[c], acc[c]);
  }

  T* orow = out + (long long)bi * tq_len * h_width + qoff + col0;
  const float inv = 1.f / l;
#pragma unroll
  for (int c = 0; c < HD; ++c) orow[c] = from_f32<T>(acc[c] * inv);
}

// ---------------------------------------------------------------------------
// backward

constexpr int kBwdThreads = 128;
// A bf16 block takes 99,840 B of shared memory at T=128, head_dim 64, so two
// share an SM, and 2 x 128 threads may take up to 255 registers each (an
// fp32 block, 132,608 B, runs alone).
constexpr int kBwdMinBlocksPerSm = 2;

// Four consecutive elements of a shared-memory row. Every row starts at a
// multiple of 16 bytes (head_dim is a multiple of 8), so these are single
// vector loads, broadcast when a warp reads one row.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int HD, typename S>
__device__ __forceinline__ void load_row(float (&dst)[HD], const S* row) {
#pragma unroll
  for (int c = 0; c < HD; c += 4) {
    const float4 r = load4(row + c);
    dst[c] = r.x;
    dst[c + 1] = r.y;
    dst[c + 2] = r.z;
    dst[c + 3] = r.w;
  }
}

// sum_c a[c] * row[c] in column order: the same bits whichever operand is
// the thread's own row, so every pass recomputes the same scores
template <int HD, typename S>
__device__ __forceinline__ float dot_row(const float (&a)[HD], const S* row) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < HD; c += 4) {
    const float4 r = load4(row + c);
    s = fmaf(a[c], r.x, s);
    s = fmaf(a[c + 1], r.y, s);
    s = fmaf(a[c + 2], r.z, s);
    s = fmaf(a[c + 3], r.w, s);
  }
  return s;
}

// acc += w * row
template <int HD, typename S>
__device__ __forceinline__ void axpy_row(float (&acc)[HD], float w, const S* row) {
#pragma unroll
  for (int c = 0; c < HD; c += 4) {
    const float4 r = load4(row + c);
    acc[c] = fmaf(w, r.x, acc[c]);
    acc[c + 1] = fmaf(w, r.y, acc[c + 1]);
    acc[c + 2] = fmaf(w, r.z, acc[c + 2]);
    acc[c + 3] = fmaf(w, r.w, acc[c + 3]);
  }
}

// Shared memory of one backward block: rotated Q [Tq][HD] and K [Tk][HD] in
// fp32, V [Tk][HD] and dO [Tq][HD] in T, then three fp32 statistics per
// query row. ops/fused_attention.py:bwd_smem_bytes is the same sum.
template <typename T, int HD>
size_t bwd_smem_bytes(int tq_len, int tk_len) {
  return (size_t)(tq_len + tk_len) * HD * (sizeof(float) + sizeof(T)) +
         (size_t)3 * tq_len * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocksPerSm)
attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ cq,
                const float* __restrict__ aq, const float* __restrict__ bq,
                const float* __restrict__ ck, const float* __restrict__ ak,
                const float* __restrict__ bk, float* __restrict__ dq_rot,
                float* __restrict__ dk_rot, T* __restrict__ dv, int tq_len, int tk_len,
                int h_width, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + (size_t)tq_len * HD;
  T* vs = reinterpret_cast<T*>(ks + (size_t)tk_len * HD);
  T* dos = vs + (size_t)tk_len * HD;
  float* row_max = reinterpret_cast<float*>(dos + (size_t)tq_len * HD);
  float* row_inv = row_max + tq_len;  // 1 / sum_t exp(s_it - max)
  float* row_d = row_inv + tq_len;    // D_i = sum_t p_it * dp_it

  const int col0 = blockIdx.y * HD;
  const long long qbase = (long long)blockIdx.x * tq_len * h_width;
  const long long kbase = (long long)blockIdx.x * tk_len * h_width;

  for (int e = threadIdx.x; e < tq_len * HD; e += blockDim.x) {
    const long long off = (long long)(e / HD) * h_width;
    const int j = col0 + e % HD;
    qs[e] = rotate_at(q + qbase + off, cq + off, aq + off, bq + off, j, h_width);
    dos[e] = dout[qbase + off + j];
  }
  for (int e = threadIdx.x; e < tk_len * HD; e += blockDim.x) {
    const long long off = (long long)(e / HD) * h_width;
    const int j = col0 + e % HD;
    ks[e] = rotate_at(k + kbase + off, ck + off, ak + off, bk + off, j, h_width);
    vs[e] = v[kbase + off + j];
  }
  __syncthreads();

  // 1. query rows: statistics, then dq in the rotated domain
  for (int i = threadIdx.x; i < tq_len; i += blockDim.x) {
    float qi[HD], doi[HD];
    load_row(qi, qs + (size_t)i * HD);
    load_row(doi, dos + (size_t)i * HD);
    float m = -INFINITY, l = 0.f, a = 0.f;
    for (int t = 0; t < tk_len; ++t) {
      const float s = __fmul_rn(dot_row(qi, ks + (size_t)t * HD), scale);
      const float dp = dot_row(doi, vs + (size_t)t * HD);
      if (s > m) {  // online softmax: rescale the sums to the new max
        const float c = expf(m - s);
        l *= c;
        a *= c;
        m = s;
      }
      const float p = expf(s - m);
      l += p;
      a = fmaf(p, dp, a);
    }
    const float inv = 1.f / l;
    const float d = a * inv;
    float dq[HD];
#pragma unroll
    for (int c = 0; c < HD; ++c) dq[c] = 0.f;
    for (int t = 0; t < tk_len; ++t) {
      const float* kt = ks + (size_t)t * HD;
      const float p = expf(__fmul_rn(dot_row(qi, kt), scale) - m) * inv;
      const float dp = dot_row(doi, vs + (size_t)t * HD);
      axpy_row(dq, p * (dp - d), kt);
    }
    float* out = dq_rot + qbase + (long long)i * h_width + col0;
#pragma unroll
    for (int c = 0; c < HD; c += 4)
      *reinterpret_cast<float4*>(out + c) =
          make_float4(dq[c] * scale, dq[c + 1] * scale, dq[c + 2] * scale, dq[c + 3] * scale);
    row_max[i] = m;
    row_inv[i] = inv;
    row_d[i] = d;
  }
  __syncthreads();

  // 2a. key rows: dv
  for (int t = threadIdx.x; t < tk_len; t += blockDim.x) {
    float kt[HD], acc[HD];
    load_row(kt, ks + (size_t)t * HD);
#pragma unroll
    for (int c = 0; c < HD; ++c) acc[c] = 0.f;
    for (int i = 0; i < tq_len; ++i) {
      const float s = __fmul_rn(dot_row(kt, qs + (size_t)i * HD), scale);
      axpy_row(acc, expf(s - row_max[i]) * row_inv[i], dos + (size_t)i * HD);
    }
    T* out = dv + kbase + (long long)t * h_width + col0;
#pragma unroll
    for (int c = 0; c < HD; ++c) out[c] = from_f32<T>(acc[c]);
  }

  // 2b. key rows: dk in the rotated domain
  for (int t = threadIdx.x; t < tk_len; t += blockDim.x) {
    float kt[HD], vt[HD], acc[HD];
    load_row(kt, ks + (size_t)t * HD);
    load_row(vt, vs + (size_t)t * HD);
#pragma unroll
    for (int c = 0; c < HD; ++c) acc[c] = 0.f;
    for (int i = 0; i < tq_len; ++i) {
      const float* qi = qs + (size_t)i * HD;
      const float p = expf(__fmul_rn(dot_row(kt, qi), scale) - row_max[i]) * row_inv[i];
      const float dp = dot_row(vt, dos + (size_t)i * HD);
      axpy_row(acc, p * (dp - row_d[i]), qi);
    }
    float* out = dk_rot + kbase + (long long)t * h_width + col0;
#pragma unroll
    for (int c = 0; c < HD; c += 4)
      *reinterpret_cast<float4*>(out + c) = make_float4(
          acc[c] * scale, acc[c + 1] * scale, acc[c + 2] * scale, acc[c + 3] * scale);
  }
}

// ---------------------------------------------------------------------------
// backward, bf16: the tensor-core kernel

// element offset of (row, col) in an unpadded [rows][HD] bf16 tile whose
// 16-byte chunks are permuted within each row: chunk c of row r lies at
// c ^ (r / R mod C), C = HD / 8 chunks a row, R = 64 / HD rows in 128 bytes
// (1 from HD = 64). The eight rows of an ldmatrix phase, 8 consecutive rows
// at one logical chunk, then fill the eight 16-byte bank groups.
template <int HD>
__device__ __forceinline__ int swz(int row, int col) {
  constexpr int C = HD / 8, R = HD >= 64 ? 1 : 64 / HD;
  return row * HD + ((((col >> 3) ^ (row / R)) & (C - 1)) << 3) + (col & 7);
}

// 8 columns j0.. of one [H] row of q or k, rotated in fp32 as rotate_at
// (circular neighbours at H), split into bf16 hi and lo chunks
__device__ __forceinline__ void rotate_split8(const bf16* row, const float* c, const float* a,
                                              const float* b, int j0, int h_width, bf16* hi,
                                              bf16* lo) {
  float x[10];  // row[j0 - 1], row[j0 .. j0 + 7], row[j0 + 8]
  const uint4 u = *reinterpret_cast<const uint4*>(row + j0);
  const bf16* u8 = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e + 1] = __bfloat162float(u8[e]);
  x[0] = __bfloat162float(row[j0 == 0 ? h_width - 1 : j0 - 1]);
  x[9] = __bfloat162float(row[j0 + 8 == h_width ? 0 : j0 + 8]);
  float cc[8], aa[8], bb[8];
#pragma unroll
  for (int e = 0; e < 8; e += 4) {
    *reinterpret_cast<float4*>(cc + e) = *reinterpret_cast<const float4*>(c + j0 + e);
    *reinterpret_cast<float4*>(aa + e) = *reinterpret_cast<const float4*>(a + j0 + e);
    *reinterpret_cast<float4*>(bb + e) = *reinterpret_cast<const float4*>(b + j0 + e);
  }
  uint4 h4, l4;
  unsigned* h = reinterpret_cast<unsigned*>(&h4);
  unsigned* l = reinterpret_cast<unsigned*>(&l4);
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    float o[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = e + i;
      o[i] = __fadd_rn(__fadd_rn(__fmul_rn(x[j + 1], cc[j]), __fmul_rn(x[j + 2], aa[j])),
                       __fmul_rn(x[j], bb[j]));
    }
    split2(o[0], o[1], h[e / 2], l[e / 2]);
  }
  *reinterpret_cast<uint4*>(hi) = h4;
  *reinterpret_cast<uint4*>(lo) = l4;
}

// acc[16 x N] += A[16 x HD] . B[N x HD]^T, A rows a0.. and B rows b0.. of
// swizzled tiles (rows past alen / blen read the last row). Split: A and B
// are hi + lo tile pairs, three products hi.hi + hi.lo + lo.hi; else one.
template <int HD, int N, bool Split>
__device__ __forceinline__ void mma_abt_swz(float (&acc)[N / 8][4], const bf16* ahi,
                                            const bf16* alo, int a0, int alen, const bf16* bhi,
                                            const bf16* blo, int b0, int blen, int lane) {
  const int r = lane & 7, m8 = ((lane >> 3) & 1) * 8, m16 = (lane >> 4) * 8;
  const int ar = min(a0 + r + m8, alen - 1);
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    unsigned ah[4], al[4];
    ldsm_x4(ah, ahi + swz<HD>(ar, kk + m16));
    if (Split) ldsm_x4(al, alo + swz<HD>(ar, kk + m16));
#pragma unroll
    for (int n = 0; n < N; n += 16) {
      const int br = min(b0 + n + r + m16, blen - 1);
      unsigned bh[4];
      ldsm_x4(bh, bhi + swz<HD>(br, kk + m8));
      mma_bf16(acc[n / 8], ah, bh[0], bh[1]);
      mma_bf16(acc[n / 8 + 1], ah, bh[2], bh[3]);
      if (Split) {
        unsigned bl[4];
        ldsm_x4(bl, blo + swz<HD>(br, kk + m8));
        mma_bf16(acc[n / 8], ah, bl[0], bl[1]);
        mma_bf16(acc[n / 8 + 1], ah, bl[2], bl[3]);
        mma_bf16(acc[n / 8], al, bh[0], bh[1]);
        mma_bf16(acc[n / 8 + 1], al, bh[2], bh[3]);
      }
    }
  }
}

// acc[16 x HD] += P[16 x N] . B[N x HD]: P the warp's fp32 accumulator tile,
// split once into bf16 hi + lo A fragments; B rows b0.. of a swizzled tile
// (ldmatrix .trans; rows past blen read the last row). SplitB: B is a hi +
// lo pair, three products hi.hi + hi.lo + lo.hi; else B is exact, two.
template <int HD, int N, bool SplitB>
__device__ __forceinline__ void mma_pb_swz(float (&acc)[HD / 8][4], const float (&p)[N / 8][4],
                                           const bf16* bhi, const bf16* blo, int b0, int blen,
                                           int lane) {
  const int r = lane & 7, m8 = ((lane >> 3) & 1) * 8, m16 = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < N; kk += 16) {
    const float* p0 = p[kk / 8];
    const float* p1 = p[kk / 8 + 1];
    unsigned hi[4], lo[4];
    split2(p0[0], p0[1], hi[0], lo[0]);
    split2(p0[2], p0[3], hi[1], lo[1]);
    split2(p1[0], p1[1], hi[2], lo[2]);
    split2(p1[2], p1[3], hi[3], lo[3]);
    const int br = min(b0 + kk + r + m8, blen - 1);
#pragma unroll
    for (int n = 0; n < HD; n += 16) {
      unsigned bh[4];
      ldsm_x4_trans(bh, bhi + swz<HD>(br, n + m16));
      mma_bf16(acc[n / 8], hi, bh[0], bh[1]);
      mma_bf16(acc[n / 8 + 1], hi, bh[2], bh[3]);
      mma_bf16(acc[n / 8], lo, bh[0], bh[1]);
      mma_bf16(acc[n / 8 + 1], lo, bh[2], bh[3]);
      if (SplitB) {
        unsigned bl[4];
        ldsm_x4_trans(bl, blo + swz<HD>(br, n + m16));
        mma_bf16(acc[n / 8], hi, bl[0], bl[1]);
        mma_bf16(acc[n / 8 + 1], hi, bl[2], bl[3]);
      }
    }
  }
}

// the fragment's 16 rows x HD columns times mul into rows row0.. (those
// below len) of one head's columns of an [T, H] matrix, fp32 or bf16
__device__ __forceinline__ void put2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void put2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
template <int HD, typename T>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[HD / 8][4], int row0,
                                           int len, int h_width, float mul, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + (lane >> 2) + 8 * half;
    if (row >= len) continue;
    T* out = dst + (long long)row * h_width + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      put2(out + j * 8, acc[j][2 * half] * mul, acc[j][2 * half + 1] * mul);
  }
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocksPerSm)
attn_bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ cq, const float* __restrict__ aq,
                    const float* __restrict__ bq, const float* __restrict__ ck,
                    const float* __restrict__ ak, const float* __restrict__ bk,
                    float* __restrict__ dq_rot, float* __restrict__ dk_rot, bf16* __restrict__ dv,
                    int tq_len, int tk_len, int h_width, float scale, float scale_log2) {
  constexpr int N = 64;      // keys (query pass) or queries (key pass) a step
  constexpr int C = HD / 8;  // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qhi = reinterpret_cast<bf16*>(smem_raw);  // [Tq][HD] each, swizzled
  bf16* qlo = qhi + tq_len * HD;
  bf16* dos = qlo + tq_len * HD;
  bf16* khi = dos + tq_len * HD;                  // [Tk][HD] each
  bf16* klo = khi + tk_len * HD;
  bf16* vs = klo + tk_len * HD;
  float* st_max = reinterpret_cast<float*>(vs + tk_len * HD);  // [Tq] each
  float* st_inv = st_max + tq_len;
  float* st_d = st_inv + tq_len;

  const int col0 = blockIdx.y * HD;
  const long long qbase = (long long)blockIdx.x * tq_len * h_width;
  const long long kbase = (long long)blockIdx.x * tk_len * h_width;
  for (int e = threadIdx.x; e < tq_len * C; e += kBwdThreads) {
    const int t = e / C, c = (e % C) * 8;
    const long long off = (long long)t * h_width;
    rotate_split8(q + qbase + off, cq + off, aq + off, bq + off, col0 + c, h_width,
                  qhi + swz<HD>(t, c), qlo + swz<HD>(t, c));
    *reinterpret_cast<uint4*>(dos + swz<HD>(t, c)) =
        *reinterpret_cast<const uint4*>(dout + qbase + off + col0 + c);
  }
  for (int e = threadIdx.x; e < tk_len * C; e += kBwdThreads) {
    const int t = e / C, c = (e % C) * 8;
    const long long off = (long long)t * h_width;
    rotate_split8(k + kbase + off, ck + off, ak + off, bk + off, col0 + c, h_width,
                  khi + swz<HD>(t, c), klo + swz<HD>(t, c));
    *reinterpret_cast<uint4*>(vs + swz<HD>(t, c)) =
        *reinterpret_cast<const uint4*>(v + kbase + off + col0 + c);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kWarps = kBwdThreads / 32;

  // 1. query rows: the statistics, D and dq, 16 rows a warp at a time
  for (int i0 = warp * 16; i0 < tq_len; i0 += kWarps * 16) {
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, a[2] = {0.f, 0.f};
    for (int t0 = 0; t0 < tk_len; t0 += N) {
      float s[N / 8][4] = {}, dp[N / 8][4] = {};
      mma_abt_swz<HD, N, true>(s, qhi, qlo, i0, tq_len, khi, klo, t0, tk_len, lane);
      mma_abt_swz<HD, N, false>(dp, dos, dos, i0, tq_len, vs, vs, t0, tk_len, lane);
      mask_keys<N>(s, t0, tk_len, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mx = fmaxf(m[h], row_max<N>(s, h, scale_log2));
        const float c = exp2f(m[h] - mx);
        float sum = 0.f, dot = 0.f;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            const float p = exp_shifted(s[j][e], scale_log2, mx);
            sum += p;
            dot = fmaf(p, dp[j][e], dot);
          }
        l[h] = l[h] * c + sum;
        a[h] = a[h] * c + dot;
        m[h] = mx;
      }
    }
    float inv[2], d[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      inv[h] = 1.f / quad_sum(l[h]);
      d[h] = quad_sum(a[h]) * inv[h];
    }
    float acc[HD / 8][4] = {};
    for (int t0 = 0; t0 < tk_len; t0 += N) {
      float s[N / 8][4] = {}, dp[N / 8][4] = {};
      mma_abt_swz<HD, N, true>(s, qhi, qlo, i0, tq_len, khi, klo, t0, tk_len, lane);
      mma_abt_swz<HD, N, false>(dp, dos, dos, i0, tq_len, vs, vs, t0, tk_len, lane);
      mask_keys<N>(s, t0, tk_len, lane);
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp_shifted(s[j][e], scale_log2, m[e >> 1]) * inv[e >> 1];
          s[j][e] = p * (dp[j][e] - d[e >> 1]);
        }
      mma_pb_swz<HD, N, true>(acc, s, khi, klo, t0, tk_len, lane);
    }
    store_rows<HD>(dq_rot + qbase + col0, acc, i0, tq_len, h_width, scale, lane);
    if ((lane & 3) == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + (lane >> 2) + 8 * h;
        if (i >= tq_len) continue;
        st_max[i] = m[h];
        st_inv[i] = inv[h];
        st_d[i] = d[h];
      }
    }
  }
  __syncthreads();

  // 2. key rows: dv and dk, from the statistics of the query rows
  for (int j0 = warp * 16; j0 < tk_len; j0 += kWarps * 16) {
    float dk_acc[HD / 8][4] = {}, dv_acc[HD / 8][4] = {};
    for (int i0 = 0; i0 < tq_len; i0 += N) {
      float s[N / 8][4] = {}, dp[N / 8][4] = {};
      mma_abt_swz<HD, N, true>(s, khi, klo, j0, tk_len, qhi, qlo, i0, tq_len, lane);
      mma_abt_swz<HD, N, false>(dp, vs, vs, j0, tk_len, dos, dos, i0, tq_len, lane);
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // queries past Tq: p = ds = 0
          const int i = i0 + frag_col(j, e, lane);
          float p = 0.f, ds = 0.f;
          if (i < tq_len) {
            p = exp_shifted(s[j][e], scale_log2, st_max[i]) * st_inv[i];
            ds = p * (dp[j][e] - st_d[i]);
          }
          s[j][e] = p;
          dp[j][e] = ds;
        }
      mma_pb_swz<HD, N, false>(dv_acc, s, dos, dos, i0, tq_len, lane);
      mma_pb_swz<HD, N, true>(dk_acc, dp, qhi, qlo, i0, tq_len, lane);
    }
    store_rows<HD>(dv + kbase + col0, dv_acc, j0, tk_len, h_width, 1.f, lane);
    store_rows<HD>(dk_rot + kbase + col0, dk_acc, j0, tk_len, h_width, scale, lane);
  }
}

// ---------------------------------------------------------------------------
// launches

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;  // backward only
  const float* t[6];
  void* out[3];      // forward: out; backward: dq_rot, dk_rot, dv
  int batch, tq_len, tk_len, h_width, num_heads;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD>
struct Fwd {
  static cudaError_t run(const Args& a);
};
template <typename T, int HD>
struct Bwd {
  static cudaError_t run(const Args& a);
};

template <typename T, int HD>
cudaError_t Fwd<T, HD>::run(const Args& a) {
  const size_t smem = (size_t)2 * a.tk_len * HD * sizeof(float);
  auto kernel = attn_fwd_kernel<T, HD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.batch, a.num_heads, (a.tq_len + kQueryTile - 1) / kQueryTile);
  kernel<<<grid, kQueryTile, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.t[0], a.t[1], a.t[2], a.t[3], a.t[4], a.t[5], static_cast<T*>(a.out[0]), a.tq_len,
      a.tk_len, a.h_width, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t Bwd<T, HD>::run(const Args& a) {
  const size_t smem = bwd_smem_bytes<T, HD>(a.tq_len, a.tk_len);
  auto kernel = attn_bwd_kernel<T, HD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.batch, a.num_heads);
  kernel<<<grid, kBwdThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.t[0], a.t[1], a.t[2], a.t[3], a.t[4], a.t[5],
      static_cast<float*>(a.out[0]), static_cast<float*>(a.out[1]), static_cast<T*>(a.out[2]),
      a.tq_len, a.tk_len, a.h_width, a.scale);
  return cudaGetLastError();
}

// bf16 takes the tensor-core kernel, whose inputs, tables and outputs must
// start on 16-byte boundaries (16-byte loads, ops/fused_attention.py makes
// them so). Its shared-memory limit is set once, before any launch, to the
// most a block may opt into (a call made while a CUDA graph captures the
// stream could be refused); each launch asks for what its lengths need.
bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int HD>
struct Bwd<bf16, HD> {
  static cudaError_t run(const Args& a) {
    static const cudaError_t configured = cudaFuncSetAttribute(
        attn_bwd_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (configured != cudaSuccess) return configured;
    bool aligned = aligned16(a.q) && aligned16(a.k) && aligned16(a.v) && aligned16(a.dout);
    for (int i = 0; i < 6; ++i) aligned = aligned && aligned16(a.t[i]);
    for (int i = 0; i < 3; ++i) aligned = aligned && aligned16(a.out[i]);
    if (!aligned) return cudaErrorMisalignedAddress;
    const size_t smem = bwd_smem_bytes<bf16, HD>(a.tq_len, a.tk_len);
    const dim3 grid(a.batch, a.num_heads);
    attn_bwd_mma_kernel<HD><<<grid, kBwdThreads, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.t[0], a.t[1], a.t[2],
        a.t[3], a.t[4], a.t[5], static_cast<float*>(a.out[0]), static_cast<float*>(a.out[1]),
        static_cast<bf16*>(a.out[2]), a.tq_len, a.tk_len, a.h_width, a.scale,
        a.scale * 1.4426950408889634f);
    return cudaGetLastError();
  }
};

// The instantiated (dtype, head_dim) pairs; dtype 0 = float32, 1 = bfloat16.
template <template <typename, int> class Launch>
cudaError_t dispatch(int dtype, const Args& a) {
  if (a.num_heads <= 0 || a.h_width % a.num_heads) return cudaErrorInvalidValue;
  const int head_dim = a.h_width / a.num_heads;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (head_dim) {
    case 16:
      return dtype ? Launch<__nv_bfloat16, 16>::run(a) : Launch<float, 16>::run(a);
    case 32:
      return dtype ? Launch<__nv_bfloat16, 32>::run(a) : Launch<float, 32>::run(a);
    case 64:
      return dtype ? Launch<__nv_bfloat16, 64>::run(a) : Launch<float, 64>::run(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// tables: 6 device pointers (cos, a, b for q [Tq, H], then for k [Tk, H]).
// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int fused_rope_attention_fwd(const void* q, const void* k, const void* v,
                                        const void* tq_cos, const void* tq_a,
                                        const void* tq_b, const void* tk_cos,
                                        const void* tk_a, const void* tk_b, void* out,
                                        int batch, int tq_len, int tk_len, int h_width,
                                        int num_heads, float scale, int dtype,
                                        void* stream) {
  const Args a{q, k, v, nullptr,
               {static_cast<const float*>(tq_cos), static_cast<const float*>(tq_a),
                static_cast<const float*>(tq_b), static_cast<const float*>(tk_cos),
                static_cast<const float*>(tk_a), static_cast<const float*>(tk_b)},
               {out, nullptr, nullptr}, batch, tq_len, tk_len, h_width, num_heads, scale,
               static_cast<cudaStream_t>(stream)};
  return (int)dispatch<Fwd>(dtype, a);
}

// The backward: dq_rot [B, Tq, H] and dk_rot [B, Tk, H] are fp32 workspaces
// that receive the gradients before the transpose rotation; dv [B, Tk, H]
// is written in v's type. Returns the cudaError_t of the launch.
extern "C" int fused_rope_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* dout, const void* tq_cos,
                                        const void* tq_a, const void* tq_b,
                                        const void* tk_cos, const void* tk_a,
                                        const void* tk_b, void* dq_rot, void* dk_rot,
                                        void* dv, int batch, int tq_len, int tk_len,
                                        int h_width, int num_heads, float scale, int dtype,
                                        void* stream) {
  const Args a{q, k, v, dout,
               {static_cast<const float*>(tq_cos), static_cast<const float*>(tq_a),
                static_cast<const float*>(tq_b), static_cast<const float*>(tk_cos),
                static_cast<const float*>(tk_a), static_cast<const float*>(tk_b)},
               {dq_rot, dk_rot, dv}, batch, tq_len, tk_len, h_width, num_heads, scale,
               static_cast<cudaStream_t>(stream)};
  return (int)dispatch<Bwd>(dtype, a);
}
