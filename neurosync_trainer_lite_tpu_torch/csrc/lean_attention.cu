// The bf16 training attention core, forward and backward, for sm_90a:
// softmax(q.k^T . c) with weight dropout, times v, over one (batch row,
// head) a block, for 1 <= Tq, Tk <= 128 and head widths that are multiples
// of 16 up to 128.
//
// Replaces no Pallas kernel: the JAX package's bf16 training core
// (_sdpa_lean_core, the custom VJP in neurosync_trainer_lite_tpu/ops/
// attention.py) is left to XLA, which fuses its chain. Eager PyTorch runs it
// as ~11 kernels forward and ~23 backward over [B, n, Tq, Tk] tensors
// (ops/lean_attention.py: lean_attention_plain_fwd and _bwd, the contract
// these kernels keep). With c = bf16(h^-0.5), r = bf16(256 / (256 - q)) and
// keep = bits >= q (the uint8 bits that attention.dropout_bits draws; q = 0
// keeps everything and scales nothing), every rounding point of the plain
// pair is kept, and no other is added:
//
//   forward   s = bf16(q.k^T); s = bf16(s . c); w = bf16(softmax_fp32(s))
//             (max, expf(s - max), an fp32 sum, a division);
//             wd = keep ? bf16(w . r) : 0; out = bf16(wd.v)
//   backward  w and wd recomputed as above; dv = bf16(wd^T.dout);
//             dw = bf16(dout.v^T), then keep ? bf16(dw . r) : 0;
//             ds = bf16(w (dw - sum_j dw w)) in fp32 from the bf16 values;
//             ds = bf16(ds . c); dq = bf16(ds.k); dk = bf16(ds^T.q)
//
// What bounds them on the H100: memory. At the training shape (B = 128
// windows, n = 16 heads, T = 128, h = 64) q, k, v, dout, each output and
// the bits are 33.6 MB each. The forward reads q, k, v and the bits and
// writes out (168 MB, 0.050 ms at 3.35 TB/s) for 4 B.n.T^2.h = 8.6 GFLOP of
// products (0.009 ms at 989 TFLOP/s); the backward reads q, k, v, dout and
// the bits and writes dq, dk and dv (268 MB, 0.080 ms) for 17.2 GFLOP,
// recompute aside (0.017 ms). The composition moves ~5 GB.
//
// Design. A block owns one (batch row, head): 8 warps, 256 threads, and
// whole key rows (no online softmax: Tk <= 128 fits). q, k, v (and dout)
// land in shared memory through cp.async in two groups (v and dout, which
// the scores do not need, arrive while they run), 16 bytes a thread, from the
// strided [B, n, T, h] views that the head split makes (any batch, head and
// row strides that are multiples of 8; the last stride 1), rows padded to
// h + 8 so that the eight rows of an ldmatrix phase fall in distinct banks,
// rows past the length zero-filled. The bits land beside them, and each
// lane thresholds its 64 elements into two words of keep flags. Warp w owns
// query rows 16w..16w+15 for the products over keys, and key rows
// 16w..16w+15 for the products over queries. Every product is
// mma.sync.m16n8k16 with bf16 operands and fp32 accumulation (the helpers of
// mma_sm90.cuh); every operand is bf16 by the contract, so no product is
// split into hi and lo halves. A score tile's accumulator, rounded and
// packed, is the A fragment of the next product: w and wd never leave the
// registers in the forward, nor ds for dq in the backward. The two products
// over queries (dv = wd^T.dout, dk = ds^T.q) take their A operand from one
// [128, 128] bf16 shared buffer (ldmatrix .trans), which holds the bits,
// then wd, then ds. Outputs go to [B, T, n, h]-contiguous buffers (the
// forward's through the warp's own q rows, 16 bytes a thread), so the head
// merge after the forward and the head split's gradient copy nothing.
//
// Every output element has one owner block, and every sum runs in a fixed
// order (the row sums across a fragment row's four lanes with
// __shfl_xor_sync, a butterfly): no atomics, and the results are bitwise the
// same from run to run. Those sums run in another order than PyTorch's
// softmax and cuBLAS's products, so w, ds or an output may lie a bf16 ulp
// from the plain pair's. __fmul_rn and __fsub_rn keep nvcc from contracting
// the elementwise steps into FMAs, expf is the full-precision exp (no fast
// math), and the softmax's division is correctly rounded (a reciprocal a row
// and one FMA correction an element: quotient()), so the rest rounds where
// the plain pair rounds.
//
// Shared memory a block (h = 64 / 128): forward 73,728 / 122,880 B, two
// blocks an SM at h = 64; backward 108,544 / 174,080 B, two blocks an SM at
// h = 64. Registers at h = 64 (nvcc -Xptxas -v): 127 forward, 128
// backward, no spills.
//
// Where they stand (chip_smoke.py's la phase on an H100 SXM at 700 W,
// PERF.md): 0.097 ms forward and 0.179 ms backward at the training shape,
// 2.4x and 2.6x their bound without the bits (1.9x and 2.2x with them).
// Each element takes an expf, a division and three to five bf16 roundings
// on the CUDA cores, and a block waits for all of its operands before its
// scores start, with 16 warps an SM to hide that: next would be a
// persistent block that loads the next (batch row, head) while it
// computes this one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kLen = 128;               // queries or keys a block holds, at most
constexpr int kThreads = 256;           // 8 warps, 16 rows each
constexpr int kBitsPitch = kLen + 16;   // bytes a shared row of bits
constexpr int kSqPitch = kLen + kPad;   // bf16 a shared row of wd or ds
constexpr size_t kSqBytes = (size_t)kLen * kSqPitch * 2;

// one [B, n, T, h] operand: its data and element strides (the last is 1)
struct Operand {
  const void* p;
  long long sb, sh, st;
};

template <int HD> struct Lattn {
  static constexpr int kPitch = HD + kPad;
  static constexpr size_t kTile = (size_t)kLen * kPitch;  // elements
  static constexpr size_t fwd_smem = 3 * kTile * 2 + (size_t)kLen * kBitsPitch;
  static constexpr size_t bwd_smem = 4 * kTile * 2 + kSqBytes;
  static constexpr int kBlocks = HD <= 64 ? 2 : 1;  // an SM, for the registers
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ unsigned pack_bf16(float x, float y) {
  return as_u32(__floats2bfloat162_rn(x, y));
}

__device__ __forceinline__ float2 unpack_bf16(unsigned u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// x / y, correctly rounded, from rcp = RN(1 / y): q = RN(x rcp) is within an
// ulp, and one correction q + RN(x - q y) rcp (the residual exact in an FMA)
// rounds it correctly (Markstein, IBM J. Res. Dev. 34, 1990): three
// operations an element where a division takes a dozen
__device__ __forceinline__ float quotient(float x, float y, float rcp) {
  const float q = __fmul_rn(x, rcp);
  return __fmaf_rn(__fmaf_rn(-q, y, x), rcp, q);
}

// ds = bf16(bf16(w (dw - dot)) . c) from the bf16 values w and dw and the
// row's fp32 dot = sum_j dw w
__device__ __forceinline__ float ds_of(float w, float dw, float dot, float scale) {
  return round_bf16(__fmul_rn(round_bf16(__fmul_rn(w, __fsub_rn(dw, dot))), scale));
}

// rows [0, len) of one (batch row, head) of a [B, n, T, HD] bf16 operand into
// a shared tile of kLen rows, pitch HD + kPad; rows past len are zero-filled
template <int HD>
__device__ __forceinline__ void load_rows(bf16* tile, const bf16* src, long long st, int len) {
  constexpr int kChunks = HD / 8;
  for (int c = threadIdx.x; c < kLen * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool ok = r < len;
    cp_async16(tile + r * (HD + kPad) + col, ok ? src + r * st + col : src, ok);
  }
}

// the [tq, tk] uint8 bits of one (batch row, head) into shared rows of
// kBitsPitch bytes: 16 bytes a thread where every row is whole 16-byte
// vectors, else a byte a thread. Elements past tq or tk are left as they
// are: their weights are 0 (keys) or their rows are never written (queries).
__device__ __forceinline__ void load_bits(unsigned char* dst, const unsigned char* src,
                                          long long st, int tq, int tk, bool vec) {
  if (vec) {
    const int chunks = tk / 16;
    for (int c = threadIdx.x; c < tq * chunks; c += kThreads) {
      const int r = c / chunks, col = (c % chunks) * 16;
      cp_async16(dst + r * kBitsPitch + col, src + r * st + col, true);
    }
    return;
  }
  for (int c = threadIdx.x; c < tq * tk; c += kThreads) {
    const int r = c / tk, col = c % tk;
    dst[r * kBitsPitch + col] = src[r * st + col];
  }
}

// the lane's keep flags over its warp's 16 rows from row0: bit 4 (j % 8) + e
// of keep[j / 8] for accumulator element acc[j][e]
__device__ __forceinline__ void keep_flags(unsigned (&keep)[2], const unsigned char* bits,
                                           int row0, int lane, int qth) {
  keep[0] = keep[1] = 0u;
#pragma unroll
  for (int j = 0; j < kLen / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const unsigned pair = *reinterpret_cast<const unsigned short*>(
          bits + (row0 + (lane >> 2) + 8 * half) * kBitsPitch + j * 8 + 2 * (lane & 3));
      const unsigned k2 = unsigned((pair & 0xffu) >= (unsigned)qth) |
                          unsigned((pair >> 8) >= (unsigned)qth) << 1;
      keep[j / 8] |= k2 << (4 * (j % 8) + 2 * half);
    }
}

__device__ __forceinline__ bool kept(const unsigned (&keep)[2], int j, int e) {
  return (keep[j / 8] >> (4 * (j % 8) + e)) & 1u;
}

// s := w = bf16(softmax_fp32(bf16(bf16(q.k^T) . c))) over the warp's 16 query
// rows (qw) and the kLen keys of ks, keys past tk weighing 0
template <int HD>
__device__ __forceinline__ void weights(float (&s)[kLen / 8][4], const bf16* qw, const bf16* ks,
                                        int tk, float scale, int lane) {
#pragma unroll
  for (int j = 0; j < kLen / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  mma_abt<HD, kLen>(s, qw, ks, lane);
#pragma unroll
  for (int j = 0; j < kLen / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = round_bf16(__fmul_rn(round_bf16(s[j][e]), scale));
  if (tk < kLen) {
#pragma unroll
    for (int j = 0; j < kLen / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (frag_col(j, e, lane) >= tk) s[j][e] = -INFINITY;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kLen / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
    mx = quad_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kLen / 8; ++j)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        s[j][e] = expf(__fsub_rn(s[j][e], mx));
        sum = __fadd_rn(sum, s[j][e]);
      }
    sum = quad_sum(sum);
    const float rcp = __frcp_rn(sum);
#pragma unroll
    for (int j = 0; j < kLen / 8; ++j)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) s[j][e] = round_bf16(quotient(s[j][e], sum, rcp));
  }
}

// keep ? bf16(x . r) : 0, or x where nothing is dropped (qth = 0)
__device__ __forceinline__ float drop(float x, const unsigned (&keep)[2], int j, int e, int qth,
                                      float rscale) {
  if (qth == 0) return x;
  return kept(keep, j, e) ? round_bf16(__fmul_rn(x, rscale)) : 0.f;
}

// acc[16 x HD] += A[16 x kLen] . B[kLen x HD]: A packed bf16 fragments of the
// warp's rows (a[c] the keys 16c..16c+15), B a shared tile row-major along
// HD (ldmatrix .trans); key chunks from tk on are zero in A and skipped
template <int HD>
__device__ __forceinline__ void mma_ab(float (&acc)[HD / 8][4], const unsigned (&a)[kLen / 16][4],
                                       const bf16* b, int tk, int lane) {
  constexpr int P = HD + kPad;
  const int r = lane & 7, m8 = ((lane >> 3) & 1) * 8, m16 = (lane >> 4) * 8;
#pragma unroll
  for (int c = 0; c < kLen / 16; ++c) {
    if (16 * c >= tk) break;
#pragma unroll
    for (int n = 0; n < HD; n += 16) {
      unsigned bf[4];
      ldsm_x4_trans(bf, b + (16 * c + r + m8) * P + n + m16);
      mma_bf16(acc[n / 8], a[c], bf[0], bf[1]);
      mma_bf16(acc[n / 8 + 1], a[c], bf[2], bf[3]);
    }
  }
}

// acc[16 x HD] += S^T[16 x rows] . B[rows x HD] for the warp's 16 keys from
// key0: S a shared [kLen, kSqPitch] bf16 buffer row-major along the keys
// (its transpose through ldmatrix .trans), B a shared tile row-major along
// HD; rows, the queries summed over, a multiple of 16
template <int HD>
__device__ __forceinline__ void mma_stb(float (&acc)[HD / 8][4], const bf16* sq, const bf16* b,
                                        int key0, int rows, int lane) {
  constexpr int P = HD + kPad;
  const int r = lane & 7, m8 = ((lane >> 3) & 1) * 8, m16 = (lane >> 4) * 8;
  for (int i0 = 0; i0 < rows; i0 += 16) {
    unsigned af[4];
    ldsm_x4_trans(af, sq + (i0 + r + m16) * kSqPitch + key0 + m8);
#pragma unroll
    for (int n = 0; n < HD; n += 16) {
      unsigned bf[4];
      ldsm_x4_trans(bf, b + (i0 + r + m8) * P + n + m16);
      mma_bf16(acc[n / 8], af, bf[0], bf[1]);
      mma_bf16(acc[n / 8 + 1], af, bf[2], bf[3]);
    }
  }
}

// the fragment's 16 rows x HD columns, rounded once to bf16, into rows
// row0.. of a [T, n, HD] output (row stride ld); rows past len are not
// written
template <int HD>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[HD / 8][4], long long ld,
                                           int row0, int len, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + (lane >> 2) + 8 * half;
    if (row >= len) continue;
    bf16* out = dst + row * ld + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<unsigned*>(out + j * 8) = pack_bf16(acc[j][2 * half], acc[j][2 * half + 1]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, Lattn<HD>::kBlocks)
nsync_lattn_fwd(Operand q, Operand k, Operand v, Operand bits, bf16* __restrict__ out, int heads,
                int tq, int tk, float scale, int qth, float rscale, int bits_vec) {
  using L = Lattn<HD>;
  constexpr int P = L::kPitch;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + L::kTile;
  bf16* vs = ks + L::kTile;
  unsigned char* bs = reinterpret_cast<unsigned char*>(vs + L::kTile);
  const long long b = blockIdx.x / heads, n = blockIdx.x % heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, row0 = 16 * warp;

  // two groups: v lands while the scores and the softmax run
  load_rows<HD>(qs, static_cast<const bf16*>(q.p) + b * q.sb + n * q.sh, q.st, tq);
  load_rows<HD>(ks, static_cast<const bf16*>(k.p) + b * k.sb + n * k.sh, k.st, tk);
  if (qth > 0)
    load_bits(bs, static_cast<const unsigned char*>(bits.p) + b * bits.sb + n * bits.sh, bits.st,
              tq, tk, bits_vec);
  cp_async_commit();
  load_rows<HD>(vs, static_cast<const bf16*>(v.p) + b * v.sb + n * v.sh, v.st, tk);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const bool rows = row0 < tq;
  bf16* qw = qs + row0 * P;
  unsigned a[kLen / 16][4];
  if (rows) {
    unsigned keep[2] = {0u, 0u};
    if (qth > 0) keep_flags(keep, bs, row0, lane, qth);
    float s[kLen / 8][4];
    weights<HD>(s, qw, ks, tk, scale, lane);
#pragma unroll
    for (int c = 0; c < kLen / 16; ++c)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int j = 2 * c + (x >> 1), e = 2 * (x & 1);
        a[c][x] = pack_bf16(drop(s[j][e], keep, j, e, qth, rscale),
                            drop(s[j][e + 1], keep, j, e + 1, qth, rscale));
      }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!rows) return;
  float o[HD / 8][4] = {};
  mma_ab<HD>(o, a, vs, tk, lane);

  // through the warp's own q rows (read by no other warp) to 16-byte stores
  __syncwarp();
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<unsigned*>(qw + ((lane >> 2) + 8 * half) * P + j * 8 + 2 * (lane & 3)) =
          pack_bf16(o[j][2 * half], o[j][2 * half + 1]);
  __syncwarp();
  constexpr int kChunks = HD / 8;
  const long long ld = (long long)heads * HD;
  bf16* ob = out + (b * tq * heads + n) * HD;
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    if (row0 + r < tq)
      *reinterpret_cast<uint4*>(ob + (row0 + r) * ld + col) =
          *reinterpret_cast<const uint4*>(qw + r * P + col);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, Lattn<HD>::kBlocks)
nsync_lattn_bwd(Operand q, Operand k, Operand v, Operand dout, Operand bits,
                bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv, int heads,
                int tq, int tk, float scale, int qth, float rscale, int bits_vec) {
  using L = Lattn<HD>;
  constexpr int P = L::kPitch;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + L::kTile;
  bf16* vs = ks + L::kTile;
  bf16* dos = vs + L::kTile;  // dout
  bf16* sq = dos + L::kTile;  // the bits, then wd, then ds: [kLen, kSqPitch]
  const long long b = blockIdx.x / heads, n = blockIdx.x % heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, row0 = 16 * warp;
  const bool rows = row0 < tq, keys = row0 < tk;
  const int tq16 = (tq + 15) / 16 * 16;

  // two groups: v and dout land while the scores and the softmax run
  load_rows<HD>(qs, static_cast<const bf16*>(q.p) + b * q.sb + n * q.sh, q.st, tq);
  load_rows<HD>(ks, static_cast<const bf16*>(k.p) + b * k.sb + n * k.sh, k.st, tk);
  if (qth > 0)
    load_bits(reinterpret_cast<unsigned char*>(sq),
              static_cast<const unsigned char*>(bits.p) + b * bits.sb + n * bits.sh, bits.st, tq,
              tk, bits_vec);
  cp_async_commit();
  load_rows<HD>(vs, static_cast<const bf16*>(v.p) + b * v.sb + n * v.sh, v.st, tk);
  load_rows<HD>(dos, static_cast<const bf16*>(dout.p) + b * dout.sb + n * dout.sh, dout.st, tq);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  unsigned keep[2] = {0u, 0u};
  if (rows && qth > 0) keep_flags(keep, reinterpret_cast<const unsigned char*>(sq), row0, lane, qth);
  __syncthreads();  // the bits are read: sq takes wd

  unsigned wp[kLen / 8][2];  // w in bf16 pairs: elements 2 half and 2 half + 1 of s[j]
  if (rows) {
    float s[kLen / 8][4];
    weights<HD>(s, qs + row0 * P, ks, tk, scale, lane);
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int j = 0; j < kLen / 8; ++j) {
        wp[j][half] = pack_bf16(s[j][2 * half], s[j][2 * half + 1]);
        *reinterpret_cast<unsigned*>(sq + (row0 + (lane >> 2) + 8 * half) * kSqPitch + j * 8 +
                                     2 * (lane & 3)) =
            pack_bf16(drop(s[j][2 * half], keep, j, 2 * half, qth, rscale),
                      drop(s[j][2 * half + 1], keep, j, 2 * half + 1, qth, rscale));
      }
  }
  cp_async_wait<0>();
  __syncthreads();  // v and dout have landed, and sq holds every row's wd

  const long long ld = (long long)heads * HD;
  if (keys) {
    float acc[HD / 8][4] = {};
    mma_stb<HD>(acc, sq, dos, row0, tq16, lane);
    store_rows<HD>(dv + (b * tk * heads + n) * HD, acc, ld, row0, tk, lane);
  }
  unsigned dsa[kLen / 16][4];
  if (rows) {
    float dw[kLen / 8][4] = {};
    mma_abt<HD, kLen>(dw, dos + row0 * P, vs, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < kLen / 8; ++j) {
        const float2 w = unpack_bf16(wp[j][h]);
        dw[j][2 * h] = drop(round_bf16(dw[j][2 * h]), keep, j, 2 * h, qth, rscale);
        dw[j][2 * h + 1] = drop(round_bf16(dw[j][2 * h + 1]), keep, j, 2 * h + 1, qth, rscale);
        dot = __fadd_rn(dot, __fmul_rn(dw[j][2 * h], w.x));
        dot = __fadd_rn(dot, __fmul_rn(dw[j][2 * h + 1], w.y));
      }
      dot = quad_sum(dot);
#pragma unroll
      for (int j = 0; j < kLen / 8; ++j) {
        const float2 w = unpack_bf16(wp[j][h]);
        dw[j][2 * h] = ds_of(w.x, dw[j][2 * h], dot, scale);
        dw[j][2 * h + 1] = ds_of(w.y, dw[j][2 * h + 1], dot, scale);
      }
    }
#pragma unroll
    for (int c = 0; c < kLen / 16; ++c)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int j = 2 * c + (x >> 1), e = 2 * (x & 1);
        dsa[c][x] = pack_bf16(dw[j][e], dw[j][e + 1]);
      }
    float acc[HD / 8][4] = {};
    mma_ab<HD>(acc, dsa, ks, tk, lane);
    store_rows<HD>(dq + (b * tq * heads + n) * HD, acc, ld, row0, tq, lane);
  }
  __syncthreads();  // every warp is done with wd: sq takes ds
  if (rows) {
#pragma unroll
    for (int c = 0; c < kLen / 16; ++c)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        *reinterpret_cast<unsigned*>(sq + (row0 + (lane >> 2) + 8 * (x & 1)) * kSqPitch +
                                     16 * c + 8 * (x >> 1) + 2 * (lane & 3)) = dsa[c][x];
  }
  __syncthreads();
  if (keys) {
    float acc[HD / 8][4] = {};
    mma_stb<HD>(acc, sq, qs, row0, tq16, lane);
    store_rows<HD>(dk + (b * tk * heads + n) * HD, acc, ld, row0, tk, lane);
  }
}

// the shared-memory limit of a kernel, set once before its first launch (a
// call made while a CUDA graph captures the stream could be refused)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Call {
  Operand q, k, v, dout, bits;
  void* out[3];  // forward: out; backward: dq, dk, dv
  int batch, heads, tq, tk;
  float scale, rscale;
  int qth, bits_vec;
  cudaStream_t stream;
};

template <int HD>
cudaError_t fwd(const Call& a) {
  constexpr size_t smem = Lattn<HD>::fwd_smem;
  static const cudaError_t configured = allow_smem(nsync_lattn_fwd<HD>, smem);
  if (configured != cudaSuccess) return configured;
  nsync_lattn_fwd<HD><<<a.batch * a.heads, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.bits, static_cast<bf16*>(a.out[0]), a.heads, a.tq, a.tk, a.scale, a.qth,
      a.rscale, a.bits_vec);
  return cudaGetLastError();
}

template <int HD>
cudaError_t bwd(const Call& a) {
  constexpr size_t smem = Lattn<HD>::bwd_smem;
  static const cudaError_t configured = allow_smem(nsync_lattn_bwd<HD>, smem);
  if (configured != cudaSuccess) return configured;
  nsync_lattn_bwd<HD><<<a.batch * a.heads, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.bits, static_cast<bf16*>(a.out[0]), static_cast<bf16*>(a.out[1]),
      static_cast<bf16*>(a.out[2]), a.heads, a.tq, a.tk, a.scale, a.qth, a.rscale, a.bits_vec);
  return cudaGetLastError();
}

template <template <int> class Run>
cudaError_t dispatch(const Call& a, int hd) {
  switch (hd) {
    case 16: return Run<16>::go(a);
    case 32: return Run<32>::go(a);
    case 48: return Run<48>::go(a);
    case 64: return Run<64>::go(a);
    case 80: return Run<80>::go(a);
    case 96: return Run<96>::go(a);
    case 112: return Run<112>::go(a);
    case 128: return Run<128>::go(a);
    default: return cudaErrorInvalidValue;
  }
}

template <int HD> struct Fwd { static cudaError_t go(const Call& a) { return fwd<HD>(a); } };
template <int HD> struct Bwd { static cudaError_t go(const Call& a) { return bwd<HD>(a); } };

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool strides8(const Operand& o) { return o.sb % 8 == 0 && o.sh % 8 == 0 && o.st % 8 == 0; }

bool valid(const Call& a, int ninputs) {
  if (a.batch < 1 || a.heads < 1 || a.tq < 1 || a.tk < 1 || a.tq > kLen || a.tk > kLen ||
      a.qth < 0 || a.qth > 255)
    return false;
  const Operand* in[4] = {&a.q, &a.k, &a.v, &a.dout};
  for (int i = 0; i < ninputs; ++i)
    if (!aligned16(in[i]->p) || !strides8(*in[i])) return false;
  return a.qth == 0 || a.bits.p != nullptr;
}

// 16-byte loads of the bits need whole 16-byte rows, each starting on a
// 16-byte boundary
int bits_vec(const Call& a) {
  return a.qth > 0 && a.tk % 16 == 0 && aligned16(a.bits.p) && a.bits.sb % 16 == 0 &&
         a.bits.sh % 16 == 0 && a.bits.st % 16 == 0;
}

Call make_call(const void* q, const long long* sq, const void* k, const long long* sk,
               const void* v, const long long* sv, const void* dout, const long long* sdo,
               const void* bits, const long long* sbits, int batch, int heads, int tq, int tk,
               float scale, int qth, float rscale, void* stream) {
  Call a{};
  a.q = {q, sq[0], sq[1], sq[2]};
  a.k = {k, sk[0], sk[1], sk[2]};
  a.v = {v, sv[0], sv[1], sv[2]};
  if (dout) a.dout = {dout, sdo[0], sdo[1], sdo[2]};
  if (bits) a.bits = {bits, sbits[0], sbits[1], sbits[2]};
  a.batch = batch;
  a.heads = heads;
  a.tq = tq;
  a.tk = tk;
  a.scale = scale;
  a.rscale = rscale;
  a.qth = qth;
  a.stream = static_cast<cudaStream_t>(stream);
  a.bits_vec = bits_vec(a);
  return a;
}

}  // namespace

// q [B, n, tq, hd], k and v [B, n, tk, hd] bf16 views, each given by its
// data and its batch, head and row strides in elements (three int64 each;
// the last stride 1, the others multiples of 8, the data 16-byte aligned);
// bits [B, n, tq, tk] uint8 (its three strides likewise, any alignment),
// null where qth is 0; out [B, tq, n, hd] contiguous bf16. scale is c and
// rscale r as bf16 values; qth the drop threshold q. Returns the
// cudaError_t of the launch.
extern "C" int lean_attention_fwd(const void* q, const long long* sq, const void* k,
                                  const long long* sk, const void* v, const long long* sv,
                                  const void* bits, const long long* sbits, void* out, int batch,
                                  int heads, int tq, int tk, int hd, float scale, int qth,
                                  float rscale, void* stream) {
  Call a = make_call(q, sq, k, sk, v, sv, nullptr, nullptr, bits, sbits, batch, heads, tq, tk,
                     scale, qth, rscale, stream);
  a.out[0] = out;
  if (!valid(a, 3) || !aligned16(out)) return (int)cudaErrorInvalidValue;
  return (int)dispatch<Fwd>(a, hd);
}

// the forward's operands and dout [B, n, tq, hd] (as q); dq [B, tq, n, hd],
// dk and dv [B, tk, n, hd] contiguous bf16. Returns the cudaError_t of the
// launch.
extern "C" int lean_attention_bwd(const void* q, const long long* sq, const void* k,
                                  const long long* sk, const void* v, const long long* sv,
                                  const void* dout, const long long* sdo, const void* bits,
                                  const long long* sbits, void* dq, void* dk, void* dv,
                                  int batch, int heads, int tq, int tk, int hd, float scale,
                                  int qth, float rscale, void* stream) {
  Call a = make_call(q, sq, k, sk, v, sv, dout, sdo, bits, sbits, batch, heads, tq, tk, scale,
                     qth, rscale, stream);
  a.out[0] = dq;
  a.out[1] = dk;
  a.out[2] = dv;
  if (!valid(a, 4) || !aligned16(dq) || !aligned16(dk) || !aligned16(dv))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch<Bwd>(a, hd);
}
