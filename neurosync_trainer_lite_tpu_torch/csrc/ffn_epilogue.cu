// The bf16 training FFN's hidden-width epilogues, for sm_90a.
//
// Replaces no Pallas kernel: the JAX package's FFN cores
// (neurosync_trainer_lite_tpu/models/seq2seq.py) leave these passes to XLA,
// which fuses them into the products. Eager PyTorch runs them as separate
// full-size passes over the [rows, F] hidden activation (6 in the forward,
// up to ~30 in the GELU backward, gelu_grad alone ten fp32 ones;
// ops/ffn_epilogue.py: the plain versions, the contract these kernels
// keep). The products stay cuBLAS's fp32-output ones. q is the uint8 drop
// threshold over the caller's bits (keep iff bits >= q; no bits, nothing
// dropped), s the bf16-rounded 256 / (256 - q):
//
//   nsync_ffn_fwd  h1 = bf16(p + b1); a = act(h1), the GELU as PyTorch's
//                  CUDA GELU computes it in fp32 (x * 0.5 * (1 + erf(x *
//                  sqrt(1/2)))) and rounded to bf16; dropped: keep ?
//                  bf16(a * s) : 0. Writes a, and h1 for the GELU (its
//                  backward's residual)
//   nsync_ffn_bwd  da = bf16(da32); ReLU: dh1 = r > 0 ? bf16(da * s) : 0,
//                  r the dropped activation; GELU: da dropped, then
//                  dh1 = bf16(da * g(h1)), g = 0.5 * (1 + erf(h * sqrt(1/2)))
//                  + h * exp(-0.5 * h * h) * (1 / sqrt(2 pi)) in fp32 in
//                  ops/ffn_epilogue.py's order (PyTorch divides by a scalar
//                  as a product with its fp32 reciprocal), and the
//                  forward's dropped GELU of h1 again: the operand of dw2;
//                  the fp32 column sums of dh1 into a per-block scratch row
//   nsync_ffn_db1  db1: the scratch summed over its rows in a fixed order
//                  (column_sum.cuh)
//
// What bounds them on the H100: memory. An element costs a few flops (the
// GELU's erf and exp a few dozen) for 7-9 bytes: fp32 in, bf16 out, a byte
// of bits. At the training shape, [16,384 x 4,096], the forward moves
// 604 MB, the GELU backward 738 MB: 0.18 and 0.22 ms at 3.35 TB/s, where
// the composition moves ~2 GB (ReLU) to ~11.7 GB (GELU).
//
// Design: a thread owns 8 adjacent columns (16 bytes of bf16, 32 of fp32,
// 8 of bits) and walks the rows blockIdx.y, blockIdx.y + gridDim.y, ...;
// a warp's loads are 1 KB of contiguous fp32, every access 8 to 16 bytes
// wide. The grid is sized to fill the card (its SMs times the blocks an SM
// holds). The backward keeps its 8 columns' fp32 sums of the rounded dh1
// in registers and writes them to its block's row of the scratch
// [blocks, F]; nsync_ffn_db1 then sums each column over the rows in a
// fixed order. No atomics, no shared memory in the elementwise kernels:
// the results are bitwise the same from run to run. The bits' row stride
// is an argument: a tensor-parallel rank's bits are a column block of the
// global draw.
//
// __fadd_rn / __fmul_rn keep nvcc from contracting products and sums into
// FMAs, so each step rounds where the plain version's separate fp32 ops
// round; erff and expf are the CUDA math library's full-precision ones
// (no --use_fast_math), as PyTorch's kernels call them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "column_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kV = 8;       // columns a thread owns

enum Act : int { kRelu = 0, kGelu = 1 };

using bf16 = __nv_bfloat16;

// float(sqrt(0.5)), float(sqrt(2 pi)) and PyTorch's reciprocal of the latter
constexpr float kSqrtHalf = static_cast<float>(0.70710678118654752440);
constexpr float kInvSqrt2Pi = 1.0f / static_cast<float>(2.5066282746310002);

struct Cols {  // 8 values of one row, as fp32
  float v[kV];
};

__device__ __forceinline__ void load_f32(Cols& c, const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  c.v[0] = a.x; c.v[1] = a.y; c.v[2] = a.z; c.v[3] = a.w;
  c.v[4] = b.x; c.v[5] = b.y; c.v[6] = b.z; c.v[7] = b.w;
}

__device__ __forceinline__ void load_bf16(Cols& c, const bf16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int i = 0; i < kV; ++i) c.v[i] = __bfloat162float(e[i]);
}

// values already on the bf16 grid: the conversion is exact
__device__ __forceinline__ void store_bf16(bf16* p, const Cols& c) {
  uint4 u;
  bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int i = 0; i < kV; ++i) e[i] = __float2bfloat16_rn(c.v[i]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint2 load_bits(const uint8_t* bits, long long stride, long long row,
                                           int c) {
  return *reinterpret_cast<const uint2*>(bits + row * stride + c);
}

__device__ __forceinline__ bool kept(uint2 k, int i, int q) {
  const uint32_t w = i < 4 ? k.x : k.y;
  return (int)((w >> (8 * (i & 3))) & 0xffu) >= q;
}

// PyTorch's CUDA GELU in fp32, rounded to bf16
__device__ __forceinline__ float gelu_bf16(float x) {
  return round_bf16(__fmul_rn(__fmul_rn(x, 0.5f), __fadd_rn(1.0f, erff(__fmul_rn(x, kSqrtHalf)))));
}

// torch.relu: NaN passes, the rest max(x, 0)
__device__ __forceinline__ float relu(float x) { return x > 0.f || x != x ? x : 0.f; }

// ops/ffn_epilogue.py:gelu_grad, one fp32 rounding an op as its PyTorch ops
__device__ __forceinline__ float gelu_grad(float h) {
  const float phi = __fmul_rn(__fadd_rn(erff(__fmul_rn(h, kSqrtHalf)), 1.0f), 0.5f);
  const float e = expf(__fmul_rn(__fmul_rn(h, -0.5f), h));
  return __fadd_rn(phi, __fmul_rn(__fmul_rn(h, e), kInvSqrt2Pi));
}

template <int A, bool kDrop>
__global__ void __launch_bounds__(kThreads)
nsync_ffn_fwd(const float* __restrict__ p, const float* __restrict__ b1,
              const uint8_t* __restrict__ bits, long long bits_stride, int q, float scale,
              bf16* __restrict__ a, bf16* __restrict__ h1, int rows, int f) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) * kV;
  if (c >= f) return;
  Cols b;
  load_f32(b, b1 + c);
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const long long off = (long long)row * f + c;
    Cols x, h, out;
    load_f32(x, p + off);
    uint2 k = make_uint2(0u, 0u);
    if constexpr (kDrop) k = load_bits(bits, bits_stride, row, c);
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      h.v[i] = round_bf16(__fadd_rn(x.v[i], b.v[i]));
      float v = A == kGelu ? gelu_bf16(h.v[i]) : relu(h.v[i]);
      if constexpr (kDrop) v = kept(k, i, q) ? round_bf16(__fmul_rn(v, scale)) : 0.f;
      out.v[i] = v;
    }
    store_bf16(a + off, out);
    if constexpr (A == kGelu) store_bf16(h1 + off, h);
  }
}

template <int A, bool kDrop>
__global__ void __launch_bounds__(kThreads)
nsync_ffn_bwd(const float* __restrict__ da32, const bf16* __restrict__ r,
              const uint8_t* __restrict__ bits, long long bits_stride, int q, float scale,
              bf16* __restrict__ dh1, bf16* __restrict__ a, float* __restrict__ part, int rows,
              int f) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) * kV;
  if (c >= f) return;
  float acc[kV];
#pragma unroll
  for (int i = 0; i < kV; ++i) acc[i] = 0.f;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const long long off = (long long)row * f + c;
    Cols d, rv, out, act;
    load_f32(d, da32 + off);
    load_bf16(rv, r + off);
    uint2 k = make_uint2(0u, 0u);
    if constexpr (kDrop) k = load_bits(bits, bits_stride, row, c);
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      float da = round_bf16(d.v[i]);
      float g;
      if constexpr (A == kRelu) {
        g = rv.v[i] > 0.f ? round_bf16(__fmul_rn(da, scale)) : 0.f;
      } else {
        float v = gelu_bf16(rv.v[i]);
        if constexpr (kDrop) {
          const bool keep = kept(k, i, q);
          da = keep ? round_bf16(__fmul_rn(da, scale)) : 0.f;
          v = keep ? round_bf16(__fmul_rn(v, scale)) : 0.f;
        }
        act.v[i] = v;
        g = round_bf16(__fmul_rn(da, gelu_grad(rv.v[i])));
      }
      out.v[i] = g;
      acc[i] = __fadd_rn(acc[i], g);
    }
    store_bf16(dh1 + off, out);
    if constexpr (A == kGelu) store_bf16(a + off, act);
  }
  float* mine = part + (long long)blockIdx.y * f + c;
  *reinterpret_cast<float4*>(mine) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  *reinterpret_cast<float4*>(mine + 4) = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

// db1: the scratch [blocks, f] summed over its rows in a fixed order
__global__ void __launch_bounds__(32 * kSumSplit)
nsync_ffn_db1(const float* __restrict__ part, int blocks, int f, float* __restrict__ db1) {
  int j;
  float t;
  if (column_sum(part, blocks, f, j, t)) db1[j] = t;
}

// the blocks an SM holds of a kernel, once a kernel
template <typename K>
int per_sm(K kernel) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0) != cudaSuccess ||
      n < 1)
    return 1;
  return n;
}

int col_blocks(int f) { return (f / kV + kThreads - 1) / kThreads; }

// the grid's rows: the card filled, never more than the rows
int row_blocks(int rows, int f, int per) {
  return std::max(1, std::min(rows, sm_count() * per / col_blocks(f)));
}

bool valid(int rows, int f) { return rows > 0 && f > 0 && f % kV == 0; }

template <int A, bool kDrop>
cudaError_t fwd_launch(const float* p, const float* b1, const uint8_t* bits, long long stride,
                       int q, float scale, bf16* a, bf16* h1, int rows, int f, cudaStream_t s) {
  static const int per = per_sm(nsync_ffn_fwd<A, kDrop>);
  const dim3 grid(col_blocks(f), row_blocks(rows, f, per));
  nsync_ffn_fwd<A, kDrop><<<grid, kThreads, 0, s>>>(p, b1, bits, stride, q, scale, a, h1, rows, f);
  return cudaGetLastError();
}

// every backward variant takes the grid of the GELU backward with bits,
// the heaviest, so the scratch's rows depend on the shape alone
int bwd_row_blocks(int rows, int f) {
  static const int per = per_sm(nsync_ffn_bwd<kGelu, true>);
  return row_blocks(rows, f, per);
}

template <int A, bool kDrop>
cudaError_t bwd_launch(const float* da32, const bf16* r, const uint8_t* bits, long long stride,
                       int q, float scale, bf16* dh1, bf16* a, float* part, float* db1, int rows,
                       int f, int blocks, cudaStream_t s) {
  const dim3 grid(col_blocks(f), blocks);
  nsync_ffn_bwd<A, kDrop><<<grid, kThreads, 0, s>>>(da32, r, bits, stride, q, scale, dh1, a, part,
                                                    rows, f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nsync_ffn_db1<<<column_sum_grid(f), column_sum_block(), 0, s>>>(part, blocks, f, db1);
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

bool bits_ok(const void* bits, long long stride, int f) {
  return bits == nullptr || (aligned(bits, 8) && stride % 8 == 0 && stride >= f);
}

}  // namespace

// The scratch rows ffn_epi_bwd takes for rows x f: its grid's rows.
extern "C" int ffn_epi_bwd_blocks(int rows, int f) {
  if (!valid(rows, f)) return 0;
  return bwd_row_blocks(rows, f);
}

// p [rows, f] fp32, b1 [f] fp32, bits [rows, f] uint8 with row stride
// bits_stride (null: nothing dropped), a and h1 [rows, f] bf16 (h1 written
// for the GELU, act 1, and may be null for the ReLU, act 0). Every pointer
// but the bits' on a 16-byte boundary, f a multiple of 8. Returns the
// cudaError_t of the launch.
extern "C" int ffn_epi_fwd(const void* p, const void* b1, const void* bits, long long bits_stride,
                           int q, float scale, int act, void* a, void* h1, int rows, int f,
                           void* stream) {
  if (!valid(rows, f) || !bits_ok(bits, bits_stride, f) || (act == kGelu && h1 == nullptr) ||
      (act != kGelu && act != kRelu))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *ps = static_cast<const float*>(p), *bs = static_cast<const float*>(b1);
  const uint8_t* k = static_cast<const uint8_t*>(bits);
  bf16 *as = static_cast<bf16*>(a), *hs = static_cast<bf16*>(h1);
  if (act == kGelu) {
    if (k) return (int)fwd_launch<kGelu, true>(ps, bs, k, bits_stride, q, scale, as, hs, rows, f, s);
    return (int)fwd_launch<kGelu, false>(ps, bs, k, bits_stride, q, scale, as, hs, rows, f, s);
  }
  if (k) return (int)fwd_launch<kRelu, true>(ps, bs, k, bits_stride, q, scale, as, hs, rows, f, s);
  return (int)fwd_launch<kRelu, false>(ps, bs, k, bits_stride, q, scale, as, hs, rows, f, s);
}

// da32 [rows, f] fp32, r, dh1 and a [rows, f] bf16, bits as ffn_epi_fwd's
// (the ReLU reads none: its mask is in r), part [blocks, f] fp32 scratch,
// blocks from ffn_epi_bwd_blocks, db1 [f] fp32. a, the dropped GELU of h1,
// is written for the GELU (act 1) and may be null for the ReLU. Launches
// nsync_ffn_bwd and nsync_ffn_db1; returns the first cudaError_t.
extern "C" int ffn_epi_bwd(const void* da32, const void* r, const void* bits,
                           long long bits_stride, int q, float scale, int act, void* dh1,
                           void* a, void* part, void* db1, int rows, int f, int blocks,
                           void* stream) {
  if (!valid(rows, f) || blocks < 1 || !bits_ok(bits, bits_stride, f) ||
      (act == kGelu && a == nullptr) || (act != kGelu && act != kRelu))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(da32);
  const bf16* rs = static_cast<const bf16*>(r);
  const uint8_t* k = static_cast<const uint8_t*>(bits);
  bf16 *o = static_cast<bf16*>(dh1), *as = static_cast<bf16*>(a);
  float *ps = static_cast<float*>(part), *db = static_cast<float*>(db1);
  if (act == kRelu)
    return (int)bwd_launch<kRelu, false>(d, rs, nullptr, 0, q, scale, o, nullptr, ps, db, rows, f,
                                         blocks, s);
  if (k)
    return (int)bwd_launch<kGelu, true>(d, rs, k, bits_stride, q, scale, o, as, ps, db, rows, f,
                                        blocks, s);
  return (int)bwd_launch<kGelu, false>(d, rs, k, bits_stride, q, scale, o, as, ps, db, rows, f,
                                       blocks, s);
}
