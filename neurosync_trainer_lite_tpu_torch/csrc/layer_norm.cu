// The bf16 LayerNorm's forward and backward, for sm_90a.
//
// Replaces no Pallas kernel: the JAX package's _layer_norm_bf16
// (neurosync_trainer_lite_tpu/models/seq2seq.py) is left to XLA, which fuses
// it. Eager PyTorch runs the same math as ~29 separate fp32 passes over
// the [rows, h] tensor (ops/layer_norm_kernel.py: layer_norm_plain_fwd and
// layer_norm_plain_bwd, the contract these kernels keep). Over x [rows, h]
// bf16 with fp32 w and b [h]:
//
//   forward   mean = sum(x) / h, var = sum((x - mean)^2) / h (two passes,
//             not E[x^2] - mean^2), r = rsqrt(var + 1e-5);
//             out = ((x - mean) * r * w + b) rounded once to bf16; mean and
//             r [rows] fp32 kept for the backward
//   backward  y = (x - mean) * r, dy = dout * w, m1 = sum(dy) / h,
//             m2 = sum(dy * y) / h, dx = r * (dy - m1 - y * m2) rounded
//             once to bf16; dw = sum over rows of dout * y, db = sum over
//             rows of dout, in fp32
//
// What bounds them on the H100: memory. A row is a few flops an element
// for 4 bytes (forward: x read, out written) or 6 (backward: x and dout
// read, dx written), far below the card's ~300 flop/byte balance point.
// At the training shape (16,384 rows of 1,024) that is 67 MB and 101 MB:
// 0.020 and 0.030 ms at 3.35 TB/s. The composition moves ~28x as much.
//
// Design: one warp owns a row at a time and holds it in registers: lane l
// loads 16 bytes (8 values) at columns (32k + l) * 8 for k < NV, so at
// h = 1,024 a lane holds 32 values (NV = 4) and every load and store is a
// coalesced 16-byte access. The row sums are warp shuffles (a butterfly:
// every lane ends with the same bits); nothing goes through shared memory
// in the forward. The grid is sized to fill the card (its 132 SMs times the
// blocks an SM holds), each warp walking rows with a stride of the grid's
// warps. The backward keeps x and dout packed, recomputes y and dy from
// them for dx, and adds each row's dout * y and dout into fp32 registers
// of the columns its lane owns. At the end a block adds its 8 warps' sums
// in order through shared memory and writes them to its row of an fp32
// scratch [blocks, 2, h]; nsync_ln_bwd_params sums that scratch over the
// blocks in a fixed order into dw and db. No atomics: the results are
// bitwise the same from run to run.
//
// Rows that are not a whole number of 16-byte vectors (h % 8 != 0), or a
// tensor that is not 16-byte aligned, take the same kernels with V = 1:
// lane l holds columns 32k + l, scalar loads and stores, the same sums and
// rounding. The choice is by shape and alignment, never on a failure. Widths
// up to kMaxWidth (32 lanes x 8 values x kMaxNv = 1,024, the model's) are
// taken; wider rows would hold more registers than a thread has to spare.
//
// __fadd_rn / __fmul_rn / __fsub_rn keep nvcc from contracting products and
// sums into FMAs: the elementwise steps round where the plain version's
// separate fp32 ops round. Only the row sums are taken in another order
// than PyTorch's reductions, so mean and r may differ from plain's in the
// last bit, and an output then by one bf16 ulp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "column_sum.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxNv = 4;      // 16-byte vectors a lane holds, at most
constexpr int kMaxWidth = 32 * 8 * kMaxNv;
constexpr float kEps = 1e-5f;

using bf16 = __nv_bfloat16;

// One item of a lane's share of a row: V consecutive bf16 values, kept
// packed (a 16-byte vector, or one value)
template <int V> struct Item;

template <> struct Item<8> {
  uint4 u;
  __device__ __forceinline__ void load(const bf16* p) { u = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ void zero() { u = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ float get(int i) const {
    return __bfloat162float(reinterpret_cast<const bf16*>(&u)[i]);
  }
};

template <> struct Item<1> {
  bf16 v;
  __device__ __forceinline__ void load(const bf16* p) { v = *p; }
  __device__ __forceinline__ void zero() { v = __float2bfloat16_rn(0.f); }
  __device__ __forceinline__ float get(int) const { return __bfloat162float(v); }
};

// the first column of item k of this lane
template <int V>
__device__ __forceinline__ int column(int k, int lane) { return (k * 32 + lane) * V; }

// V fp32 parameters at p: two float4 loads, or one scalar
template <int V>
__device__ __forceinline__ void load_params(float (&dst)[V], const float* p) {
  if constexpr (V == 8) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
    dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
    dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
  } else {
    dst[0] = __ldg(p);
  }
}

// V values rounded once to bf16, stored at p
template <int V>
__device__ __forceinline__ void store_bf16(bf16* p, const float (&src)[V]) {
  if constexpr (V == 8) {
    uint4 u;
    bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16_rn(src[i]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    *p = __float2bfloat16_rn(src[0]);
  }
}

// this lane's items of a row; zeros past its end
template <int V, int K>
__device__ __forceinline__ void load_row(Item<V> (&items)[K], const bf16* row, int lane, int h) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (column<V>(k, lane) < h) items[k].load(row + column<V>(k, lane));
    else items[k].zero();
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

template <int V, int NV>
__global__ void __launch_bounds__(kThreads)
nsync_ln_fwd(const bf16* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ b, bf16* __restrict__ out,
             float* __restrict__ mean, float* __restrict__ rstd, int rows, int h) {
  constexpr int K = 8 * NV / V;  // items a lane
  const int lane = threadIdx.x & 31;
  const float hf = (float)h;
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < rows;
       row += gridDim.x * kWarps) {
    const long long off = (long long)row * h;
    Item<V> xv[K];
    load_row<V, K>(xv, x + off, lane, h);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < V; ++i) s = __fadd_rn(s, xv[k].get(i));
    const float mu = __fdiv_rn(warp_sum(s), hf);
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (column<V>(k, lane) >= h) continue;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = __fsub_rn(xv[k].get(i), mu);
        ss = __fadd_rn(ss, __fmul_rn(d, d));
      }
    }
    const float r = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(ss), hf), kEps));
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = column<V>(k, lane);
      if (c >= h) continue;
      float wv[V], bv[V], o[V];
      load_params<V>(wv, w + c);
      load_params<V>(bv, b + c);
#pragma unroll
      for (int i = 0; i < V; ++i)
        o[i] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(xv[k].get(i), mu), r), wv[i]), bv[i]);
      store_bf16<V>(out + off + c, o);
    }
    if (lane == 0) {
      mean[row] = mu;
      rstd[row] = r;
    }
  }
}

// rows of 16-byte vectors keep the backward's registers under 128 a
// thread, two blocks an SM; the scalar variant takes up to 255, one block
template <int V>
constexpr int bwd_blocks_per_sm() { return V == 8 ? 2 : 1; }

template <int V, int NV>
__global__ void __launch_bounds__(kThreads, bwd_blocks_per_sm<V>())
nsync_ln_bwd(const bf16* __restrict__ x, const bf16* __restrict__ dout,
             const float* __restrict__ mean, const float* __restrict__ rstd,
             const float* __restrict__ w, bf16* __restrict__ dx,
             float* __restrict__ part, int rows, int h) {
  constexpr int K = 8 * NV / V;
  extern __shared__ float red[];  // [2, h]: the block's sums of dout * y, dout
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float hf = (float)h;
  float acc_w[K][V], acc_b[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) acc_w[k][i] = acc_b[k][i] = 0.f;

  for (int row = blockIdx.x * kWarps + warp; row < rows; row += gridDim.x * kWarps) {
    const long long off = (long long)row * h;
    Item<V> xv[K], gv[K];
    load_row<V, K>(xv, x + off, lane, h);
    load_row<V, K>(gv, dout + off, lane, h);
    const float mu = mean[row], r = rstd[row];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = column<V>(k, lane);
      if (c >= h) continue;
      float wv[V];
      load_params<V>(wv, w + c);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float y = __fmul_rn(__fsub_rn(xv[k].get(i), mu), r);
        const float g = gv[k].get(i);
        const float dy = __fmul_rn(g, wv[i]);
        s1 = __fadd_rn(s1, dy);
        s2 = __fadd_rn(s2, __fmul_rn(dy, y));
        acc_w[k][i] = __fadd_rn(acc_w[k][i], __fmul_rn(g, y));
        acc_b[k][i] = __fadd_rn(acc_b[k][i], g);
      }
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, m));
      s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, m));
    }
    const float m1 = __fdiv_rn(s1, hf), m2 = __fdiv_rn(s2, hf);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = column<V>(k, lane);
      if (c >= h) continue;
      float wv[V], o[V];
      load_params<V>(wv, w + c);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float y = __fmul_rn(__fsub_rn(xv[k].get(i), mu), r);
        const float dy = __fmul_rn(gv[k].get(i), wv[i]);
        o[i] = __fmul_rn(r, __fsub_rn(__fsub_rn(dy, m1), __fmul_rn(y, m2)));
      }
      store_bf16<V>(dx + off + c, o);
    }
  }

  // the block's column sums: its warps' added in order, then written out
  for (int wi = 0; wi < kWarps; ++wi) {
    if (warp == wi) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = column<V>(k, lane);
        if (c >= h) continue;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          red[c + i] = wi == 0 ? acc_w[k][i] : __fadd_rn(red[c + i], acc_w[k][i]);
          red[h + c + i] = wi == 0 ? acc_b[k][i] : __fadd_rn(red[h + c + i], acc_b[k][i]);
        }
      }
    }
    __syncthreads();
  }
  float* mine = part + (long long)blockIdx.x * 2 * h;
  for (int j = threadIdx.x; j < 2 * h; j += kThreads) mine[j] = red[j];
}

// dw and db: the scratch [blocks, 2, h] summed over its blocks in a fixed
// order (column_sum.cuh), its first h columns into dw, the rest into db.
__global__ void __launch_bounds__(32 * kSumSplit)
nsync_ln_bwd_params(const float* __restrict__ part, int blocks, int h,
                    float* __restrict__ dw, float* __restrict__ db) {
  int j;
  float t;
  if (!column_sum(part, blocks, 2 * h, j, t)) return;
  if (j < h) dw[j] = t;
  else db[j - h] = t;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int row_blocks(int rows) { return (rows + kWarps - 1) / kWarps; }

// 16-byte vectors a lane holds for a row of h (for V = 1, 8 values each)
int vectors(int h) { return (h + 32 * 8 - 1) / (32 * 8); }

template <int V, int NV>
cudaError_t fwd_launch(const bf16* x, const float* w, const float* b, bf16* out, float* mean,
                       float* rstd, int rows, int h, cudaStream_t s) {
  static const int per_sm = [] {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, nsync_ln_fwd<V, NV>, kThreads, 0) !=
            cudaSuccess || n < 1)
      return 1;
    return n;
  }();
  const int blocks = std::min(row_blocks(rows), sm_count() * per_sm);
  nsync_ln_fwd<V, NV><<<blocks, kThreads, 0, s>>>(x, w, b, out, mean, rstd, rows, h);
  return cudaGetLastError();
}

template <int V, int NV>
cudaError_t bwd_launch(const bf16* x, const bf16* dout, const float* mean, const float* rstd,
                       const float* w, bf16* dx, float* part, float* dw, float* db, int rows,
                       int h, int blocks, cudaStream_t s) {
  nsync_ln_bwd<V, NV><<<blocks, kThreads, 2 * h * sizeof(float), s>>>(x, dout, mean, rstd, w,
                                                                     dx, part, rows, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nsync_ln_bwd_params<<<column_sum_grid(2 * h), column_sum_block(), 0, s>>>(part, blocks, h, dw,
                                                                           db);
  return cudaGetLastError();
}

#define NSYNC_LN_DISPATCH(V, fn, ...)                  \
  switch (vectors(h)) {                                \
    case 1: return fn<V, 1>(__VA_ARGS__);              \
    case 2: return fn<V, 2>(__VA_ARGS__);              \
    case 3: return fn<V, 3>(__VA_ARGS__);              \
    case 4: return fn<V, 4>(__VA_ARGS__);              \
    default: return cudaErrorInvalidValue;             \
  }

template <int V>
cudaError_t fwd(const bf16* x, const float* w, const float* b, bf16* out, float* mean,
                float* rstd, int rows, int h, cudaStream_t s) {
  NSYNC_LN_DISPATCH(V, fwd_launch, x, w, b, out, mean, rstd, rows, h, s)
}

template <int V>
cudaError_t bwd(const bf16* x, const bf16* dout, const float* mean, const float* rstd,
                const float* w, bf16* dx, float* part, float* dw, float* db, int rows, int h,
                int blocks, cudaStream_t s) {
  NSYNC_LN_DISPATCH(V, bwd_launch, x, dout, mean, rstd, w, dx, part, dw, db, rows, h, blocks, s)
}

bool valid(int rows, int h) { return rows > 0 && h > 0 && h <= kMaxWidth; }

}  // namespace

// The scratch rows layer_norm_bwd takes for rows x h: its grid, the card's
// SMs times the blocks an SM holds, or fewer where the rows are few.
extern "C" int layer_norm_bwd_blocks(int rows, int h) {
  if (!valid(rows, h)) return 0;
  const int per_sm = h % 8 == 0 ? bwd_blocks_per_sm<8>() : bwd_blocks_per_sm<1>();
  return std::min(row_blocks(rows), sm_count() * per_sm);
}

// x, out [rows, h] bf16; w, b [h] fp32; mean, rstd [rows] fp32. Returns the
// cudaError_t of the launch.
extern "C" int layer_norm_fwd(const void* x, const void* w, const void* b, void* out,
                              void* mean, void* rstd, int rows, int h, void* stream) {
  if (!valid(rows, h)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xs = static_cast<const bf16*>(x);
  const float *ws = static_cast<const float*>(w), *bs = static_cast<const float*>(b);
  bf16* o = static_cast<bf16*>(out);
  float *m = static_cast<float*>(mean), *r = static_cast<float*>(rstd);
  const bool vector = h % 8 == 0 && aligned16(x) && aligned16(out) && aligned16(w) &&
                      aligned16(b);
  if (vector) return (int)fwd<8>(xs, ws, bs, o, m, r, rows, h, s);
  return (int)fwd<1>(xs, ws, bs, o, m, r, rows, h, s);
}

// x, dout, dx [rows, h] bf16; mean, rstd [rows] and w [h] fp32; part
// [blocks, 2, h] fp32 scratch, blocks from layer_norm_bwd_blocks (any
// number from 1 is right); dw, db [h] fp32. Launches nsync_ln_bwd and
// nsync_ln_bwd_params; returns the first cudaError_t.
extern "C" int layer_norm_bwd(const void* x, const void* dout, const void* mean,
                              const void* rstd, const void* w, void* dx, void* part, void* dw,
                              void* db, int rows, int h, int blocks, void* stream) {
  if (!valid(rows, h) || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *xs = static_cast<const bf16*>(x), *g = static_cast<const bf16*>(dout);
  const float *m = static_cast<const float*>(mean), *r = static_cast<const float*>(rstd),
              *ws = static_cast<const float*>(w);
  bf16* d = static_cast<bf16*>(dx);
  float *p = static_cast<float*>(part), *dws = static_cast<float*>(dw),
        *dbs = static_cast<float*>(db);
  const bool vector = h % 8 == 0 && aligned16(x) && aligned16(dout) && aligned16(dx) &&
                      aligned16(w);
  if (vector) return (int)bwd<8>(xs, g, m, r, ws, d, p, dws, dbs, rows, h, blocks, s);
  return (int)bwd<1>(xs, g, m, r, ws, d, p, dws, dbs, rows, h, blocks, s);
}
