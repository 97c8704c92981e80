// K1: the interleaved-RoPE rotation over the last dimension, for sm_90a.
//
// Replaces the Pallas kernel neurosync_trainer_lite_tpu/ops/rope_pallas.py
// (_rope_kernel / _rope_call / rope_rotate):
//
//   forward    out = x*cos + roll(x, -1)*a + roll(x, +1)*b
//   transpose  out = cos*y + roll(a*y, +1) + roll(b*y, -1)   (the gradient)
//
// over x [B, T, d] with fp32 tables [T, d] (x row b*T + t uses table row t).
// The rolls are circular over d, for any tables, exactly as the Pallas
// body's lane rolls are. Math is fp32 with one rounding to x's type at the
// store.
//
// Bound on the H100: memory. Each element is read once, multiplied three
// times and written once (~5 flops for 4 bytes in bf16), far below the
// card's ~300 flop/byte balance point; x and out are the bytes that count
// (the tables, 12 bytes an element of one [T, d] row set, are shared by
// the B batch rows). Design: a thread owns V consecutive columns j0.. of
// one table row t, V = 16 bytes of x (8 bf16 or 4 fp32), and loads its
// tables cos, a, b there once into registers (for the transpose a[j - 1]
// and b[j + 1] instead). It then walks the block's share of the batch rows
// b*T + t, four at a time: one 16-byte load of x each, the neighbours
// x[j0 - 1] and x[j0 + V] from the adjacent lanes (__shfl_up_sync /
// __shfl_down_sync), the rotation, one 16-byte store. A lane at a warp's
// edge or at the row's ends (the circular wrap at d) reads its neighbour
// from global memory instead (the line is in L1 or L2: the next warp reads
// it). No shared memory, no barrier. The grid splits the batch rows over
// enough blocks to fill the card, so each table element is read from L2
// about (blocks' batch splits) times, not B times.
//
// Rows that are not a whole number of 16-byte vectors (d * sizeof(T) % 16
// != 0) or a base that is not 16-byte aligned take the same kernel with V =
// 1: scalar loads and stores, the same neighbours and rounding. The choice
// is by shape and alignment in launch(), never on a failure.
//
// __fmul_rn/__fadd_rn keep nvcc from contracting the sums into FMAs, so the
// result is bitwise the plain PyTorch version's (elementwise fp32 ops, one
// rounding each, summed left to right).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 4;       // batch rows in flight a thread
constexpr int kBlocksPerSm = 8;  // the grid's target: 8 x 128 threads an SM

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V elements of T at p, widened to fp32: one 16-byte load, or V scalar ones
template <typename T, int V>
__device__ __forceinline__ void load_x(float (&dst)[V], const T* p) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) dst[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) dst[i] = to_f32(p[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_x(T* p, const float (&src)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_f32<T>(src[i]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = from_f32<T>(src[i]);
  }
}

// V fp32 table values at p: float4 loads where V is a multiple of 4
template <int V>
__device__ __forceinline__ void load_table(float (&dst)[V], const float* p) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + i);
      dst[i] = f.x;
      dst[i + 1] = f.y;
      dst[i + 2] = f.z;
      dst[i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) dst[i] = p[i];
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
rope_rows(const T* __restrict__ x, const float* __restrict__ cos_t,
          const float* __restrict__ a_t, const float* __restrict__ b_t, T* __restrict__ out,
          int batch, int t_len, int d, int rows_per_block, int transpose) {
  const int nvec = d / V;
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool active = g < (long long)t_len * nvec;
  const int t = active ? (int)(g / nvec) : 0;
  const int vi = active ? (int)(g % nvec) : 0;
  const int j0 = vi * V;
  const int lane = threadIdx.x & 31;
  // lane - 1 holds x[j0 - 1] and lane + 1 x[j0 + V] when they are of the
  // same table row and not across the circular wrap
  const bool left_in_warp = lane > 0 && vi > 0;
  const bool right_in_warp = lane < 31 && vi + 1 < nvec;
  const int jl = j0 == 0 ? d - 1 : j0 - 1;
  const int jr = j0 + V == d ? 0 : j0 + V;

  // forward: cos[j], a[j], b[j]; transpose: cos[j], a[j - 1], b[j + 1]
  float c[V], ta[V], tb[V];
  const long long toff = (long long)t * d;
  if (active) {
    load_table(c, cos_t + toff + j0);
    load_table(ta, a_t + toff + j0);
    load_table(tb, b_t + toff + j0);
    if (transpose) {
#pragma unroll
      for (int i = V - 1; i > 0; --i) ta[i] = ta[i - 1];
      ta[0] = a_t[toff + jl];
#pragma unroll
      for (int i = 0; i < V - 1; ++i) tb[i] = tb[i + 1];
      tb[V - 1] = b_t[toff + jr];
    }
  }

  const int b_begin = (int)blockIdx.y * rows_per_block;
  const int b_end = min(batch, b_begin + rows_per_block);
  for (int b0 = b_begin; b0 < b_end; b0 += kUnroll) {
    float xv[kUnroll][V] = {}, xl[kUnroll], xr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!active || b0 + u >= b_end) continue;
      const T* row = x + ((long long)(b0 + u) * t_len + t) * d;
      load_x<T, V>(xv[u], row + j0);
      if (!left_in_warp) xl[u] = to_f32(row[jl]);
      if (!right_in_warp) xr[u] = to_f32(row[jr]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (b0 + u >= b_end) break;  // uniform across the block
      const float up = __shfl_up_sync(0xffffffffu, xv[u][V - 1], 1);
      const float down = __shfl_down_sync(0xffffffffu, xv[u][0], 1);
      if (!active) continue;
      const float left = left_in_warp ? up : xl[u];
      const float right = right_in_warp ? down : xr[u];
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float prev = i == 0 ? left : xv[u][i - 1];
        const float next = i == V - 1 ? right : xv[u][i + 1];
        float r = __fmul_rn(xv[u][i], c[i]);
        if (transpose) {
          r = __fadd_rn(r, __fmul_rn(prev, ta[i]));
          r = __fadd_rn(r, __fmul_rn(next, tb[i]));
        } else {
          r = __fadd_rn(r, __fmul_rn(next, ta[i]));
          r = __fadd_rn(r, __fmul_rn(prev, tb[i]));
        }
        o[i] = r;
      }
      store_x<T, V>(out + ((long long)(b0 + u) * t_len + t) * d + j0, o);
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int sm_count() {
  static const int count = [] {
    int device = 0, n = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
      return 132;
    return n;
  }();
  return count;
}

template <typename T, int V>
cudaError_t launch_v(const T* x, const float* cos_t, const float* a_t, const float* b_t, T* out,
                     int batch, int t_len, int d, int transpose, cudaStream_t stream) {
  const long long items = (long long)t_len * (d / V);
  const long long xblocks = (items + kThreads - 1) / kThreads;
  // split the batch rows over enough blocks to fill the card
  const long long target = (long long)sm_count() * kBlocksPerSm;
  long long splits = (target + xblocks - 1) / xblocks;
  splits = splits < 1 ? 1 : (splits > batch ? batch : splits);
  const int rows_per_block = (int)((batch + splits - 1) / splits);
  const dim3 grid((unsigned)xblocks, (unsigned)((batch + rows_per_block - 1) / rows_per_block));
  rope_rows<T, V><<<grid, kThreads, 0, stream>>>(x, cos_t, a_t, b_t, out, batch, t_len, d,
                                                 rows_per_block, transpose);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* cos_t, const void* a_t, const void* b_t,
                   void* out, int rows, int t_len, int d, int transpose,
                   cudaStream_t stream) {
  if (t_len <= 0 || d <= 0 || rows % t_len) return cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  const bool vector = d % V == 0 && aligned16(x) && aligned16(out) && aligned16(cos_t) &&
                      aligned16(a_t) && aligned16(b_t);
  const T* xs = static_cast<const T*>(x);
  const float *c = static_cast<const float*>(cos_t), *a = static_cast<const float*>(a_t),
              *b = static_cast<const float*>(b_t);
  T* o = static_cast<T*>(out);
  if (vector) return launch_v<T, V>(xs, c, a, b, o, rows / t_len, t_len, d, transpose, stream);
  return launch_v<T, 1>(xs, c, a, b, o, rows / t_len, t_len, d, transpose, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int rope_rotate(const void* x, const void* cos_t, const void* a_t,
                           const void* b_t, void* out, int rows, int t_len, int d,
                           int transpose, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, cos_t, a_t, b_t, out, rows, t_len, d, transpose, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, cos_t, a_t, b_t, out, rows, t_len, d, transpose, s);
  return (int)cudaErrorInvalidValue;
}
