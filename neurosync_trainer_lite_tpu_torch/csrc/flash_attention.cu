// K3: non-causal flash attention softmax(q.k^T * scale).v over [B, N, T, h]
// tensors, forward and backward, for sm_90a.
//
// Replaces the two Pallas kernels of
// neurosync_trainer_lite_tpu/ops/flash_attention.py: the forward
// (_fwd_kernel / _fwd, pallas_call at :71, flash_attention) and the backward
// (_bwd_kernel / _bwd_call, pallas_call at :136, the custom VJP). The
// rounding points are the Pallas bodies': scores, softmax and every
// accumulation in fp32 from the input-type operands; in the forward the
// normalised p is rounded to v's type before p.v; in the backward p and ds
// stay fp32; every output is rounded once.
//
// Two families of kernels, chosen by dtype in dispatch():
//   bf16 (the main path): flash_fwd_mma_kernel, flash_bwd_dq_mma_kernel,
//        flash_bwd_dkdv_mma_kernel, every product on the tensor cores;
//   fp32: flash_fwd_kernel, flash_bwd_dq_kernel, flash_bwd_dkdv_kernel, on
//        the CUDA cores (one thread a row; described further down).
//
// What bounds the bf16 kernels on the H100. At (c), a 512-frame window
// (B = 32, N = 16 heads, T = 512, h = 64), and at (d), 2048 frames x 8, q, k,
// v, dO and each output are 33.5 MB. The forward moves 4 x 33.5 = 134 MB
// (0.040 ms at 3.35 TB/s) and its two products are 4.pairs.h flop: 34.4
// GFLOP at (c), 137 at (d) (0.035 / 0.139 ms at 989 TFLOP/s). The backward
// moves 7 x 33.5 = 235 MB (0.070 ms) and its five products are 10.pairs.h:
// 86 / 344 GFLOP (0.087 / 0.347 ms). pairs = B.N.Tq.Tk = 134M at (c), 537M
// at (d). So both are bound by operations at (d), the forward by bytes at
// (c). The exps set a second floor of the same size: one exp a pair takes
// 1 / (132 SMs x 16 a clock x 1.98 GHz) = 0.24 ps on the MUFU, one pair's
// 4h = 256 flop 0.26 ps on the tensor cores. The forward's two passes take
// 2 exps a pair (0.064 ms at (c), 0.257 ms at (d)) against 6.pairs.h flop of
// products executed (0.052 / 0.208 ms); the backward 3 exps a pair (0.096 /
// 0.385 ms) against 24.pairs.h (q.k^T and dO.v^T twice, the three split
// products twice each: 0.208 / 0.834 ms). Neither floor sets the pace yet:
// on an H100 SXM at 700 W (chip_smoke.py, PERF.md) the forward at (d) runs
// its products at ~190 TFLOP/s and the backward at ~270, with 8-16 warps
// an SM, so latency does (next steps at the end of this note).
//
// What held the first design (the fp32 kernels below, once also bf16) back,
// and what these do about it:
//  1. no tensor cores: every product was fp32 FMAs at <= 67 TFLOP/s. Here
//     mma.sync.m16n8k16 with bf16 operands and fp32 accumulation, fed by
//     ldmatrix (.trans where the operand lies row-major along the
//     reduction). The m16n8 accumulator layout is the m16k16 A layout once
//     packed to bf16, so s, p and ds feed the next product from registers
//     (as FlashAttention-2 does; WMMA hides that layout, hence PTX).
//  2. one thread owned one row (2-3 rows of h fp32 in registers, 255
//     registers and spills in the backward, 64-thread blocks). Here 4 warps
//     a block, 16 rows a warp, a block still owning 64 rows (grid_of is
//     shared); a thread holds fragments, not rows.
//  3. fp32 tiles in shared memory, loaded synchronously behind a fence on
//     every tile. Here the streamed operand stays bf16 (half the bytes) and
//     arrives through a 2-3-deep cp.async ring (16 B a thread, no
//     register staging), waited for with cp.async.wait_group. Rows are
//     padded by 16 bytes so that the eight rows of each ldmatrix phase
//     fall in distinct banks. The warp-level helpers are in mma_sm90.cuh,
//     shared with the K4 backward.
//  4. extra passes on slow units: the backward's dk/dv kernel made two
//     passes over the queries. Here it makes one. The forward keeps two
//     passes (an online single pass would round the unnormalised p, which
//     JAX does not), and the dq kernel keeps two (statistics and D, then
//     dq): their second passes now run on the tensor cores.
// The rounding points stay JAX's. q.k^T and dO.v^T have bf16 operands. In
// the forward p = bf16(exp(s - m) / l) is JAX's rounding of the normalised
// p, and p.v takes it as a bf16 operand. In the backward p and ds are fp32;
// in p^T.dO, ds.k and ds^T.q the other operand is a bf16 input, so the fp32
// one is split once into hi = bf16(x) and lo = bf16(x - hi) and the two
// bf16 products go into one fp32 accumulator: each term keeps ~16
// significant bits, far below the output's bf16 rounding. exp is exp2f of
// fma(s, scale . log2 e, -m) (one FFMA and one MUFU op a pair), the max m
// kept in that log2 domain, also in the bf16 statistics workspace; keys
// past Tk are masked on the last tile only. Row reductions (max, sum, D) run
// across the four lanes of a fragment row with __shfl_xor_sync in a fixed
// order: the bits differ from the fp32 kernels' but repeat from run to run.
// Ragged edges: keys past Tk score -inf and their K/V rows are zero-filled;
// rows past Tq or Tk are computed but never written.
//
// Shared memory a block (bf16, h = 64 / 128): forward 46,080 / 87,040 B;
// dq 55,296 / 104,448 B; dk/dv 76,032 / 70,400 B (ring depths in Mma; dk/dv
// streams 64 / 32 queries a tile). Registers at h = 64 (nvcc -Xptxas -v,
// printed by chip_smoke.py): forward 96, dq 128 (44 B spilled), dk/dv 233.
//
// fp32 kernels. Where the Pallas kernels load a head's whole K/V strip (up
// to 2048 rows) into VMEM, and the backward holds the whole [Tq, Tk] p
// matrix, a Hopper block has 227 KB of shared memory: K and V at Tk = 2048,
// h = 64 alone are 1 MB in fp32. So every kernel streams the other operand
// in tiles of kTile rows through shared memory (fp32, 2 x 16 KB at h = 64),
// and nothing [Tq, Tk] is ever stored. Design, simple first: one thread
// owns one row and keeps it and its accumulator in registers (h is a
// template parameter); every thread of a warp reads the same tile row at
// once, so shared-memory reads are broadcasts.
//
// Forward: one block per (b.n, 64-query tile), two passes over the keys.
//   1. the row max and the row sum of exp (online: rescaled at a new max);
//   2. the same scores again, p = exp(s - max) / sum rounded to v's type,
//      accumulated into o in fp32.
// The two passes reproduce JAX's rounding point exactly (p normalised, then
// rounded): an online single pass would round unnormalised p and divide at
// the end. The price is one more q.k^T (3h FMAs a pair where 2h would do).
//
// Backward, without atomics: the Pallas grid runs one program per (b.n)
// that holds every sum; Hopper's blocks run in parallel, so the work splits
// so that each sum has one owner, and the gradients are bitwise the same
// from run to run.
//   (a) dq kernel, one block per (b.n, 64-query tile), streaming K and V:
//       the row max, the row sum and D_i = sum_t p_it * dp_it (fp32, from
//       the unrounded p and dp, not from the forward's rounded output) in
//       one online pass, then dq_i = scale * sum_t p_it (dp_it - D_i) k_t in
//       a second. The statistics (max, 1/sum, D) go to fp32 workspaces
//       [B.N, Tq] that the wrapper allocates.
//   (b) dk/dv kernel, one block per (b.n, 64-key tile), streaming Q, dO and
//       the statistics of (a): dv_t = sum_i p_it dO_i in one pass, dk_t =
//       scale * sum_i p_it (dp_it - D_i) q_i in another (two passes keep a
//       thread's register arrays to three rows of h).
// p is recomputed from q.k in every pass with the same dot order, so both
// kernels see the same bits. Ragged tails: keys past Tk are never read,
// rows past Tq or Tk are neither computed nor written. Instantiated for
// every multiple of 16 up to 128 (dispatch()); from h = 80 the register
// arrays spill (correct, slow).
//
// Next for speed (not here): wgmma from shared memory, TMA loads with
// mbarriers, warp specialisation, persistent blocks, and a forward that
// saves the softmax statistics for the backward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kRows = 64;  // rows a block owns, one per thread
constexpr int kTile = 64;  // rows of the streamed operand per shared tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and widened again: p.astype(v.dtype) of the forward
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// One row of HD elements from device memory into fp32 registers (zeros for
// a row past the end, which is then never written).
template <typename T, int HD>
__device__ __forceinline__ void load_row(float (&dst)[HD], const T* row, bool valid) {
#pragma unroll
  for (int c = 0; c < HD; ++c) dst[c] = valid ? to_f32(row[c]) : 0.f;
}

template <typename T, int HD>
__device__ __forceinline__ void store_row(T* row, const float (&src)[HD], float mul) {
#pragma unroll
  for (int c = 0; c < HD; ++c) row[c] = from_f32<T>(src[c] * mul);
}

// rows [row0, row0 + kTile) of a [rows, HD] matrix into a shared fp32 tile;
// rows past the end are left alone (never read)
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* tile, const T* src, int row0, int rows) {
  const int n = min(kTile, rows - row0) * HD;
  const T* base = src + (long long)row0 * HD;
  for (int e = threadIdx.x; e < n; e += blockDim.x) tile[e] = to_f32(base[e]);
}

// sum_c a[c] * row[c] in column order: the same bits whichever operand is
// the thread's own row, so every pass and both backward kernels recompute
// the same scores. Shared rows start at multiples of 16 bytes (HD is a
// multiple of 4), so these are vector loads, broadcast across the warp.
template <int HD>
__device__ __forceinline__ float dot_row(const float (&a)[HD], const float* row) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < HD; c += 4) {
    const float4 r = *reinterpret_cast<const float4*>(row + c);
    s = fmaf(a[c], r.x, s);
    s = fmaf(a[c + 1], r.y, s);
    s = fmaf(a[c + 2], r.z, s);
    s = fmaf(a[c + 3], r.w, s);
  }
  return s;
}

// acc += w * row
template <int HD>
__device__ __forceinline__ void axpy_row(float (&acc)[HD], float w, const float* row) {
#pragma unroll
  for (int c = 0; c < HD; c += 4) {
    const float4 r = *reinterpret_cast<const float4*>(row + c);
    acc[c] = fmaf(w, r.x, acc[c]);
    acc[c + 1] = fmaf(w, r.y, acc[c + 1]);
    acc[c + 2] = fmaf(w, r.z, acc[c + 2]);
    acc[c + 3] = fmaf(w, r.w, acc[c + 3]);
  }
}

// Blocks per SM the register budget must allow. The forward keeps two rows
// of HD fp32 (q and o): at HD <= 64 six 64-thread blocks share an SM at
// <= 170 registers. The backward keeps three rows and gets 255.
template <int HD> struct Occupancy {
  static constexpr int fwd = HD <= 64 ? 6 : 2;
  static constexpr int bwd = 4;
};

// ---------------------------------------------------------------------------
// forward

template <typename T, int HD>
__global__ void __launch_bounds__(kRows, Occupancy<HD>::fwd)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int tq_len, int tk_len, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                // [kTile][HD]
  float* vs = smem + kTile * HD;   // [kTile][HD]
  const long long bn = blockIdx.x;
  const T* kb = k + bn * tk_len * HD;
  const T* vb = v + bn * tk_len * HD;
  const int i = blockIdx.y * kRows + threadIdx.x;
  const bool active = i < tq_len;
  const long long row = (bn * tq_len + i) * HD;

  float qi[HD];
  load_row<T, HD>(qi, q + row, active);

  // pass 1: the row max and the row sum of exp(s - max)
  float m = -INFINITY, l = 0.f;
  for (int t0 = 0; t0 < tk_len; t0 += kTile) {
    __syncthreads();
    load_tile<T, HD>(ks, kb, t0, tk_len);
    __syncthreads();
    if (!active) continue;
    const int n = min(kTile, tk_len - t0);
    for (int t = 0; t < n; ++t) {
      const float s = __fmul_rn(dot_row(qi, ks + t * HD), scale);
      if (s > m) {
        l *= expf(m - s);
        m = s;
      }
      l += expf(s - m);
    }
  }

  // pass 2: p normalised, rounded to v's type, accumulated into o in fp32
  float acc[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) acc[c] = 0.f;
  for (int t0 = 0; t0 < tk_len; t0 += kTile) {
    __syncthreads();
    load_tile<T, HD>(ks, kb, t0, tk_len);
    load_tile<T, HD>(vs, vb, t0, tk_len);
    __syncthreads();
    if (!active) continue;
    const int n = min(kTile, tk_len - t0);
    for (int t = 0; t < n; ++t) {
      const float s = __fmul_rn(dot_row(qi, ks + t * HD), scale);
      const float p = round_to<T>(__fdiv_rn(expf(s - m), l));
      axpy_row(acc, p, vs + t * HD);
    }
  }
  if (active) store_row<T, HD>(out + row, acc, 1.f);
}

// ---------------------------------------------------------------------------
// backward (a): statistics and dq, one block per (b.n, query tile)

template <typename T, int HD>
__global__ void __launch_bounds__(kRows, Occupancy<HD>::bwd)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, float* __restrict__ stats,
                    T* __restrict__ dq, int bn_len, int tq_len, int tk_len, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = smem + kTile * HD;
  const long long bn = blockIdx.x;
  const T* kb = k + bn * tk_len * HD;
  const T* vb = v + bn * tk_len * HD;
  const int i = blockIdx.y * kRows + threadIdx.x;
  const bool active = i < tq_len;
  const long long row = (bn * tq_len + i) * HD;

  float qi[HD], doi[HD];
  load_row<T, HD>(qi, q + row, active);
  load_row<T, HD>(doi, dout + row, active);

  // one pass: max, sum of exp and sum of exp * dp, rescaled at a new max
  float m = -INFINITY, l = 0.f, a = 0.f;
  for (int t0 = 0; t0 < tk_len; t0 += kTile) {
    __syncthreads();
    load_tile<T, HD>(ks, kb, t0, tk_len);
    load_tile<T, HD>(vs, vb, t0, tk_len);
    __syncthreads();
    if (!active) continue;
    const int n = min(kTile, tk_len - t0);
    for (int t = 0; t < n; ++t) {
      const float s = __fmul_rn(dot_row(qi, ks + t * HD), scale);
      const float dp = dot_row(doi, vs + t * HD);
      if (s > m) {
        const float c = expf(m - s);
        l *= c;
        a *= c;
        m = s;
      }
      const float p = expf(s - m);
      l += p;
      a = fmaf(p, dp, a);
    }
  }
  const float inv = 1.f / l;
  const float d = a * inv;

  float acc[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) acc[c] = 0.f;
  for (int t0 = 0; t0 < tk_len; t0 += kTile) {
    __syncthreads();
    load_tile<T, HD>(ks, kb, t0, tk_len);
    load_tile<T, HD>(vs, vb, t0, tk_len);
    __syncthreads();
    if (!active) continue;
    const int n = min(kTile, tk_len - t0);
    for (int t = 0; t < n; ++t) {
      const float* kt = ks + t * HD;
      const float p = expf(__fmul_rn(dot_row(qi, kt), scale) - m) * inv;
      const float dp = dot_row(doi, vs + t * HD);
      axpy_row(acc, p * (dp - d), kt);
    }
  }
  if (!active) return;
  store_row<T, HD>(dq + row, acc, scale);
  const long long plane = (long long)bn_len * tq_len;
  const long long at = bn * tq_len + i;
  stats[at] = m;
  stats[plane + at] = inv;
  stats[2 * plane + at] = d;
}

// ---------------------------------------------------------------------------
// backward (b): dk and dv, one block per (b.n, key tile)

template <typename T, int HD>
__global__ void __launch_bounds__(kRows, Occupancy<HD>::bwd)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ stats, T* __restrict__ dk,
                      T* __restrict__ dv, int bn_len, int tq_len, int tk_len, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [kTile][HD]
  float* dos = smem + kTile * HD;     // [kTile][HD]
  float* st = smem + 2 * kTile * HD;  // [3][kTile]: max, 1/sum, D
  const long long bn = blockIdx.x;
  const T* qb = q + bn * tq_len * HD;
  const T* dob = dout + bn * tq_len * HD;
  const long long plane = (long long)bn_len * tq_len;
  const float* sb = stats + bn * tq_len;
  const int t = blockIdx.y * kRows + threadIdx.x;
  const bool active = t < tk_len;
  const long long row = (bn * tk_len + t) * HD;

  float kt[HD], acc[HD];
  load_row<T, HD>(kt, k + row, active);

  // one query tile of Q, dO and the statistics into shared memory
  auto stage = [&](int i0, bool with_d) {
    __syncthreads();
    load_tile<T, HD>(qs, qb, i0, tq_len);
    load_tile<T, HD>(dos, dob, i0, tq_len);
    const int n = min(kTile, tq_len - i0);
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      st[e] = sb[i0 + e];
      st[kTile + e] = sb[plane + i0 + e];
      if (with_d) st[2 * kTile + e] = sb[2 * plane + i0 + e];
    }
    __syncthreads();
    return n;
  };

  // dv_t = sum_i p_it dO_i
#pragma unroll
  for (int c = 0; c < HD; ++c) acc[c] = 0.f;
  for (int i0 = 0; i0 < tq_len; i0 += kTile) {
    const int n = stage(i0, false);
    if (!active) continue;
    for (int i = 0; i < n; ++i) {
      const float s = __fmul_rn(dot_row(kt, qs + i * HD), scale);
      axpy_row(acc, expf(s - st[i]) * st[kTile + i], dos + i * HD);
    }
  }
  if (active) store_row<T, HD>(dv + row, acc, 1.f);

  // dk_t = scale * sum_i p_it (dp_it - D_i) q_i
  float vt[HD];
  load_row<T, HD>(vt, v + row, active);
#pragma unroll
  for (int c = 0; c < HD; ++c) acc[c] = 0.f;
  for (int i0 = 0; i0 < tq_len; i0 += kTile) {
    const int n = stage(i0, true);
    if (!active) continue;
    for (int i = 0; i < n; ++i) {
      const float* qi = qs + i * HD;
      const float p = expf(__fmul_rn(dot_row(kt, qi), scale) - st[i]) * st[kTile + i];
      const float dp = dot_row(vt, dos + i * HD);
      axpy_row(acc, p * (dp - st[2 * kTile + i]), qi);
    }
  }
  if (active) store_row<T, HD>(dk + row, acc, scale);
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels

constexpr int kThreads = 128;  // 4 warps of 16 rows: kRows a block
constexpr float kLog2e = 1.4426950408889634f;

// Ring depths and the dq kernel's blocks an SM, in two width classes: h <= 64
// (16, 32, 48, 64) and h > 64 (80 ... 128). At h = 64 a 2-deep ring
// leaves room for one more block an SM in the forward and the dq kernel (the
// dq kernel's registers capped to match), which read faster side by side
// than 3-deep rings; the dk/dv kernel is held to two blocks by its registers
// and keeps 3.
template <int HD> struct Mma {
  static constexpr int kPitch = HD + kPad;
  static constexpr int kFwdStages = 2;
  static constexpr int kDqStages = 2;
  static constexpr int kDqBlocks = HD <= 64 ? 4 : 1;
  static constexpr int kDkDvStages = HD <= 64 ? 3 : 2;
  static constexpr int kKeys = 64;                      // streamed K/V rows
  static constexpr int kQueries = HD <= 64 ? 64 : 32;   // streamed Q/dO rows
  static constexpr int kKeyTile = kKeys * kPitch;       // elements of a K/V tile
  static constexpr int kQueryTile = kQueries * kPitch;  // of a Q/dO tile
  static constexpr size_t fwd_smem = (size_t)(kRows + kFwdStages * 2 * kKeys) * kPitch * 2;
  static constexpr size_t dq_smem = (size_t)(2 * kRows + kDqStages * 2 * kKeys) * kPitch * 2;
  static constexpr size_t dkdv_smem =
      (size_t)(2 * kRows + kDkDvStages * 2 * kQueries) * kPitch * 2 +
      kDkDvStages * 3 * kQueries * 4;
};

// rows [row0, row0 + rows) of a contiguous [len, HD] bf16 matrix into a
// shared tile of pitch HD + kPad, 16 bytes a thread a step; rows past len
// are zero-filled
template <int HD>
__device__ __forceinline__ void load_tile_async(bf16* tile, const bf16* src, int row0, int rows,
                                                int len) {
  constexpr int kChunks = HD / 8;
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool ok = row0 + r < len;
    cp_async16(tile + r * (HD + kPad) + col, ok ? src + (long long)(row0 + r) * HD + col : src,
               ok);
  }
}

// acc[16 x HD] += P[16 x N] . B[N x HD]: P the warp's fp32 accumulator
// tile, whose layout is the A fragment's once packed to bf16; B a shared
// tile row-major along HD (ldmatrix .trans). Split: P as bf16(P) +
// bf16(P - bf16(P)), two products into acc (B is exact in bf16).
template <int HD, int N, bool Split>
__device__ __forceinline__ void mma_pb(float (&acc)[HD / 8][4], const float (&p)[N / 8][4],
                                       const bf16* b, int lane) {
  constexpr int P = HD + kPad;
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
#pragma unroll
    for (int n = 0; n < HD; n += 16) {
      unsigned bf[4];
      ldsm_x4_trans(bf, b + (kk + r + m8) * P + n + m16);
      mma_bf16(acc[n / 8], hi, bf[0], bf[1]);
      mma_bf16(acc[n / 8 + 1], hi, bf[2], bf[3]);
      if (Split) {
        mma_bf16(acc[n / 8], lo, bf[0], bf[1]);
        mma_bf16(acc[n / 8 + 1], lo, bf[2], bf[3]);
      }
    }
  }
}

// the fragment's 16 rows x HD columns, times mul, rounded once to bf16, into
// rows row0.. of a [len, HD] matrix; rows past len are not written
template <int HD>
__device__ __forceinline__ void store_frag(bf16* dst, const float (&acc)[HD / 8][4], int row0,
                                           int len, float mul, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + (lane >> 2) + 8 * half;
    if (row >= len) continue;
    bf16* out = dst + (long long)row * HD + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + j * 8) =
          __floats2bfloat162_rn(acc[j][2 * half] * mul, acc[j][2 * half + 1] * mul);
  }
}

// Forward: one block per (b.n, 64-query tile), the warp's 16 query rows.
// 2 x (Tk / 64) steps stream K (pass 1) and then K and V (pass 2) through
// the ring; the Q tile lands with the first step.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out, int tq_len, int tk_len,
                     float scale_log2) {
  using M = Mma<HD>;
  constexpr int N = M::kKeys, S = M::kFwdStages, P = M::kPitch;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][P]
  bf16* ring = qs + kRows * P;                    // S x {K, V} [N][P]
  const long long bn = blockIdx.x;
  const int i0 = blockIdx.y * kRows;
  const bf16* kb = k + bn * tk_len * HD;
  const bf16* vb = v + bn * tk_len * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles = (tk_len + N - 1) / N, steps = 2 * tiles;

  load_tile_async<HD>(qs, q + bn * tq_len * HD, i0, kRows, tq_len);
  auto fetch = [&](int it) {
    bf16* slot = ring + (it % S) * 2 * M::kKeyTile;
    const int t0 = (it % tiles) * N;
    load_tile_async<HD>(slot, kb, t0, N, tk_len);
    if (it >= tiles) load_tile_async<HD>(slot + M::kKeyTile, vb, t0, N, tk_len);
  };
#pragma unroll
  for (int it = 0; it < S - 1; ++it) {
    if (it < steps) fetch(it);
    cp_async_commit();
  }

  const bf16* qw = qs + warp * 16 * P;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv[2] = {0.f, 0.f};
  float o[HD / 8][4] = {};
  for (int it = 0; it < steps; ++it) {
    // step it has landed, and every warp is done with step it - 1, whose
    // slot the next load takes
    cp_async_wait<S - 2>();
    __syncthreads();
    if (it + S - 1 < steps) fetch(it + S - 1);
    cp_async_commit();
    const bf16* ks = ring + (it % S) * 2 * M::kKeyTile;
    float s[N / 8][4] = {};
    mma_abt<HD, N>(s, qw, ks, lane);
    mask_keys<N>(s, (it % tiles) * N, tk_len, lane);
    if (it < tiles) {
      // pass 1: the row max, and this lane's share of the row sum of
      // exp(s - max), rescaled at a new max
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mx = fmaxf(m[h], row_max<N>(s, h, scale_log2));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
          sum += exp_shifted(s[j][2 * h], scale_log2, mx) +
                 exp_shifted(s[j][2 * h + 1], scale_log2, mx);
        l[h] = l[h] * exp2f(m[h] - mx) + sum;
        m[h] = mx;
      }
      continue;
    }
    if (it == tiles) {
#pragma unroll
      for (int h = 0; h < 2; ++h) inv[h] = 1.f / quad_sum(l[h]);
    }
    // pass 2: p normalised, rounded to bf16 as the A operand of p.v
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = exp_shifted(s[j][e], scale_log2, m[e >> 1]) * inv[e >> 1];
    mma_pb<HD, N, false>(o, s, ks + M::kKeyTile, lane);
  }
  store_frag<HD>(out + bn * tq_len * HD, o, i0 + warp * 16, tq_len, 1.f, lane);
}

// Backward (a): per (b.n, 64-query tile), streaming K and V twice. Pass 1:
// s = q.k^T, dp = dO.v^T, the online max, sum and D = sum p.dp (fp32, from
// the unrounded p and dp). Pass 2: ds = p (dp - D), dq += ds.k (split).
// The statistics (max in the log2 domain, 1/sum, D) go to stats.
template <int HD>
__global__ void __launch_bounds__(kThreads, Mma<HD>::kDqBlocks)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        float* __restrict__ stats, bf16* __restrict__ dq, int bn_len, int tq_len,
                        int tk_len, float scale, float scale_log2) {
  using M = Mma<HD>;
  constexpr int N = M::kKeys, S = M::kDqStages, P = M::kPitch;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][P]
  bf16* dos = qs + kRows * P;                     // [kRows][P]
  bf16* ring = dos + kRows * P;                   // S x {K, V} [N][P]
  const long long bn = blockIdx.x;
  const int i0 = blockIdx.y * kRows;
  const bf16* kb = k + bn * tk_len * HD;
  const bf16* vb = v + bn * tk_len * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles = (tk_len + N - 1) / N, steps = 2 * tiles;

  load_tile_async<HD>(qs, q + bn * tq_len * HD, i0, kRows, tq_len);
  load_tile_async<HD>(dos, dout + bn * tq_len * HD, i0, kRows, tq_len);
  auto fetch = [&](int it) {
    bf16* slot = ring + (it % S) * 2 * M::kKeyTile;
    const int t0 = (it % tiles) * N;
    load_tile_async<HD>(slot, kb, t0, N, tk_len);
    load_tile_async<HD>(slot + M::kKeyTile, vb, t0, N, tk_len);
  };
#pragma unroll
  for (int it = 0; it < S - 1; ++it) {
    if (it < steps) fetch(it);
    cp_async_commit();
  }

  const bf16* qw = qs + warp * 16 * P;
  const bf16* dow = dos + warp * 16 * P;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, a[2] = {0.f, 0.f};
  float inv[2] = {0.f, 0.f}, d[2] = {0.f, 0.f};
  float acc[HD / 8][4] = {};
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<S - 2>();
    __syncthreads();
    if (it + S - 1 < steps) fetch(it + S - 1);
    cp_async_commit();
    const bf16* ks = ring + (it % S) * 2 * M::kKeyTile;
    float s[N / 8][4] = {}, dp[N / 8][4] = {};
    mma_abt<HD, N>(s, qw, ks, lane);
    mma_abt<HD, N>(dp, dow, ks + M::kKeyTile, lane);
    mask_keys<N>(s, (it % tiles) * N, tk_len, lane);
    if (it < tiles) {
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
      continue;
    }
    if (it == tiles) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        inv[h] = 1.f / quad_sum(l[h]);
        d[h] = quad_sum(a[h]) * inv[h];
      }
    }
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp_shifted(s[j][e], scale_log2, m[e >> 1]) * inv[e >> 1];
        s[j][e] = p * (dp[j][e] - d[e >> 1]);
      }
    mma_pb<HD, N, true>(acc, s, ks, lane);
  }
  const int row0 = i0 + warp * 16;
  store_frag<HD>(dq + bn * tq_len * HD, acc, row0, tq_len, scale, lane);
  if ((lane & 3) != 0) return;
  const long long plane = (long long)bn_len * tq_len;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row0 + (lane >> 2) + 8 * h;
    if (i >= tq_len) continue;
    const long long at = bn * tq_len + i;
    stats[at] = m[h];
    stats[plane + at] = inv[h];
    stats[2 * plane + at] = d[h];
  }
}

// Backward (b): per (b.n, 64-key tile), one pass over the query tiles,
// streaming Q, dO and the statistics of (a): s^T = k.q^T, dp^T = v.dO^T,
// p^T, ds^T = p^T (dp^T - D), then dv += p^T.dO and dk += ds^T.q (split).
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ stats, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int bn_len, int tq_len, int tk_len, float scale,
                          float scale_log2) {
  using M = Mma<HD>;
  constexpr int N = M::kQueries, S = M::kDkDvStages, P = M::kPitch;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kRows][P]
  bf16* vs = ks + kRows * P;                      // [kRows][P]
  bf16* ring = vs + kRows * P;                    // S x {Q, dO} [N][P]
  float* st0 = reinterpret_cast<float*>(ring + S * 2 * M::kQueryTile);  // S x [3][N]
  const long long bn = blockIdx.x;
  const int t0 = blockIdx.y * kRows;
  const bf16* qb = q + bn * tq_len * HD;
  const bf16* dob = dout + bn * tq_len * HD;
  const long long plane = (long long)bn_len * tq_len;
  const float* sb = stats + bn * tq_len;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int steps = (tq_len + N - 1) / N;

  load_tile_async<HD>(ks, k + bn * tk_len * HD, t0, kRows, tk_len);
  load_tile_async<HD>(vs, v + bn * tk_len * HD, t0, kRows, tk_len);
  // rows past Tq arrive as zeros: q = dO = 0 and 1/sum = 0 give p = ds = 0
  auto fetch = [&](int it) {
    bf16* slot = ring + (it % S) * 2 * M::kQueryTile;
    float* st = st0 + (it % S) * 3 * N;
    const int i0 = it * N;
    load_tile_async<HD>(slot, qb, i0, N, tq_len);
    load_tile_async<HD>(slot + M::kQueryTile, dob, i0, N, tq_len);
    for (int e = threadIdx.x; e < 3 * N; e += kThreads) {
      const int which = e / N, i = i0 + e % N;
      const bool ok = i < tq_len;
      cp_async4(st + e, ok ? sb + which * plane + i : sb, ok);
    }
  };
#pragma unroll
  for (int it = 0; it < S - 1; ++it) {
    if (it < steps) fetch(it);
    cp_async_commit();
  }

  const bf16* kw = ks + warp * 16 * P;
  const bf16* vw = vs + warp * 16 * P;
  float dk_acc[HD / 8][4] = {}, dv_acc[HD / 8][4] = {};
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<S - 2>();
    __syncthreads();
    if (it + S - 1 < steps) fetch(it + S - 1);
    cp_async_commit();
    const bf16* qs = ring + (it % S) * 2 * M::kQueryTile;
    const bf16* dos = qs + M::kQueryTile;
    const float* st = st0 + (it % S) * 3 * N;
    float s[N / 8][4] = {}, dp[N / 8][4] = {};
    mma_abt<HD, N>(s, kw, qs, lane);
    mma_abt<HD, N>(dp, vw, dos, lane);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = frag_col(j, e, lane);
        const float p = exp_shifted(s[j][e], scale_log2, st[i]) * st[N + i];
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - st[2 * N + i]);
      }
    mma_pb<HD, N, true>(dv_acc, s, dos, lane);
    mma_pb<HD, N, true>(dk_acc, dp, qs, lane);
  }
  const int row0 = t0 + warp * 16;
  store_frag<HD>(dv + bn * tk_len * HD, dv_acc, row0, tk_len, 1.f, lane);
  store_frag<HD>(dk + bn * tk_len * HD, dk_acc, row0, tk_len, scale, lane);
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
  float* stats;      // backward only: [3][B.N][Tq]
  void* out[2];      // forward: out; dq kernel: dq; dk/dv kernel: dk, dv
  int bn_len, tq_len, tk_len;
  float scale;
  cudaStream_t stream;
};

dim3 grid_of(const Args& a, int rows) {
  return dim3(a.bn_len, (rows + kRows - 1) / kRows);
}

template <typename T, int HD>
struct Fwd {
  static cudaError_t run(const Args& a) {
    const size_t smem = (size_t)2 * kTile * HD * sizeof(float);
    auto kernel = flash_fwd_kernel<T, HD>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid_of(a, a.tq_len), kRows, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<T*>(a.out[0]), a.tq_len, a.tk_len, a.scale);
    return cudaGetLastError();
  }
};

template <typename T, int HD>
struct BwdDq {
  static cudaError_t run(const Args& a) {
    const size_t smem = (size_t)2 * kTile * HD * sizeof(float);
    auto kernel = flash_bwd_dq_kernel<T, HD>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid_of(a, a.tq_len), kRows, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), a.stats, static_cast<T*>(a.out[0]), a.bn_len,
        a.tq_len, a.tk_len, a.scale);
    return cudaGetLastError();
  }
};

template <typename T, int HD>
struct BwdDkDv {
  static cudaError_t run(const Args& a) {
    const size_t smem = ((size_t)2 * kTile * HD + 3 * kTile) * sizeof(float);
    auto kernel = flash_bwd_dkdv_kernel<T, HD>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid_of(a, a.tk_len), kRows, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), a.stats, static_cast<T*>(a.out[0]),
        static_cast<T*>(a.out[1]), a.bn_len, a.tq_len, a.tk_len, a.scale);
    return cudaGetLastError();
  }
};

// bf16 takes the tensor-core kernels. Each sets its shared-memory limit
// once, before any launch: a call made while a CUDA graph captures the
// stream could be refused.
template <int HD>
struct Fwd<bf16, HD> {
  static cudaError_t run(const Args& a) {
    constexpr size_t smem = Mma<HD>::fwd_smem;
    static const cudaError_t configured = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (configured != cudaSuccess) return configured;
    flash_fwd_mma_kernel<HD><<<grid_of(a, a.tq_len), kThreads, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<bf16*>(a.out[0]), a.tq_len, a.tk_len,
        a.scale * kLog2e);
    return cudaGetLastError();
  }
};

template <int HD>
struct BwdDq<bf16, HD> {
  static cudaError_t run(const Args& a) {
    constexpr size_t smem = Mma<HD>::dq_smem;
    static const cudaError_t configured = cudaFuncSetAttribute(
        flash_bwd_dq_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (configured != cudaSuccess) return configured;
    flash_bwd_dq_mma_kernel<HD><<<grid_of(a, a.tq_len), kThreads, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.stats,
        static_cast<bf16*>(a.out[0]), a.bn_len, a.tq_len, a.tk_len, a.scale, a.scale * kLog2e);
    return cudaGetLastError();
  }
};

template <int HD>
struct BwdDkDv<bf16, HD> {
  static cudaError_t run(const Args& a) {
    constexpr size_t smem = Mma<HD>::dkdv_smem;
    static const cudaError_t configured = cudaFuncSetAttribute(
        flash_bwd_dkdv_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (configured != cudaSuccess) return configured;
    flash_bwd_dkdv_mma_kernel<HD><<<grid_of(a, a.tk_len), kThreads, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.stats,
        static_cast<bf16*>(a.out[0]), static_cast<bf16*>(a.out[1]), a.bn_len, a.tq_len,
        a.tk_len, a.scale, a.scale * kLog2e);
    return cudaGetLastError();
  }
};

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The instantiated (dtype, head_dim) pairs: every multiple of 16 up to 128,
// the widths mma.sync's k = 16 and ldmatrix's 16-column loads tile
// (ops/flash_attention.py:HEAD_DIMS); dtype 0 = float32 (the CUDA-core
// kernels), 1 = bfloat16 (the tensor-core kernels, which load 16 bytes at a
// time and so take 16-byte aligned tensors only).
template <template <typename, int> class Launch>
cudaError_t dispatch(int dtype, int head_dim, const Args& a) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (a.bn_len <= 0 || a.tq_len <= 0 || a.tk_len <= 0) return cudaErrorInvalidValue;
  if (dtype == 1 && !(aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
                      aligned16(a.dout) && aligned16(a.out[0]) && aligned16(a.out[1])))
    return cudaErrorMisalignedAddress;
  switch (head_dim) {
#define K3_WIDTH(HD) \
  case HD:           \
    return dtype ? Launch<__nv_bfloat16, HD>::run(a) : Launch<float, HD>::run(a);
    K3_WIDTH(16)
    K3_WIDTH(32)
    K3_WIDTH(48)
    K3_WIDTH(64)
    K3_WIDTH(80)
    K3_WIDTH(96)
    K3_WIDTH(112)
    K3_WIDTH(128)
#undef K3_WIDTH
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B.N, Tq, h], k and v [B.N, Tk, h], out [B.N, Tq, h], all contiguous in
// one dtype (0 = float32, 1 = bfloat16). Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int bn_len, int tq_len, int tk_len, int head_dim,
                                   float scale, int dtype, void* stream) {
  const Args a{q, k, v, nullptr, nullptr, {out, nullptr}, bn_len, tq_len, tk_len, scale,
               static_cast<cudaStream_t>(stream)};
  return (int)dispatch<Fwd>(dtype, head_dim, a);
}

// The backward's first kernel: dq [B.N, Tq, h] in q's type, and the row
// statistics (max, 1/sum, D) into the fp32 workspace stats [3][B.N][Tq].
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, void* stats, void* dq, int bn_len,
                                      int tq_len, int tk_len, int head_dim, float scale,
                                      int dtype, void* stream) {
  const Args a{q, k, v, dout, static_cast<float*>(stats), {dq, nullptr}, bn_len, tq_len,
               tk_len, scale, static_cast<cudaStream_t>(stream)};
  return (int)dispatch<BwdDq>(dtype, head_dim, a);
}

// The backward's second kernel, after the first on the same stream: dk and
// dv [B.N, Tk, h] in their inputs' type, from the statistics in stats.
extern "C" int flash_attention_bwd_dkdv(const void* q, const void* k, const void* v,
                                        const void* dout, void* stats, void* dk, void* dv,
                                        int bn_len, int tq_len, int tk_len, int head_dim,
                                        float scale, int dtype, void* stream) {
  const Args a{q, k, v, dout, static_cast<float*>(stats), {dk, dv}, bn_len, tq_len, tk_len,
               scale, static_cast<cudaStream_t>(stream)};
  return (int)dispatch<BwdDkDv>(dtype, head_dim, a);
}
