// K3: non-causal flash attention softmax(q.k^T * scale).v over [B, N, T, h]
// tensors, forward and backward, for sm_90a.
//
// Replaces the two Pallas kernels of
// neurosync_trainer_lite_tpu/ops/flash_attention.py: the forward
// (_fwd_kernel / _fwd / flash_attention) and the backward (_bwd_kernel /
// _bwd_call, the custom VJP). The rounding points are the Pallas bodies':
// scores, softmax and every accumulation in fp32 from the input-type
// operands; in the forward the normalised p is rounded to v's type before
// p.v; in the backward p stays fp32; every output is rounded once.
//
// What bounds it on the H100: operations. At the training shape of a
// 512-frame window (B=32, N=16 heads, T=512, h=64, bf16) the forward moves
// 67 MB but does 34 GFLOP (two T x T x h products per head); the backward
// moves 117 MB and does 86 GFLOP (five products). All of it is fp32 on the
// CUDA cores (67 TFLOP/s), not on the tensor cores.
//
// Where the Pallas kernels load a head's whole K/V strip (up to 2048 rows)
// into VMEM, and the backward holds the whole [Tq, Tk] p matrix, a Hopper
// block has 227 KB of shared memory: K and V at Tk = 2048, h = 64 alone are
// 1 MB in fp32. So every kernel streams the other operand in tiles of kTile
// rows through shared memory (fp32, 2 x 16 KB at h = 64), and nothing
// [Tq, Tk] is ever stored. Design, simple first: one thread owns one row and
// keeps it and its accumulator in registers (h is a template parameter);
// every thread of a warp reads the same tile row at once, so shared-memory
// reads are broadcasts.
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
// h in {16, 32, 64, 128}; at 128 the register arrays spill (correct, slow).
// Tensor cores (mma.sync / wgmma with bf16 operands, fp32 accumulation) and
// TMA are the next step for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

// The instantiated (dtype, head_dim) pairs; dtype 0 = float32, 1 = bfloat16.
template <template <typename, int> class Launch>
cudaError_t dispatch(int dtype, int head_dim, const Args& a) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (a.bn_len <= 0 || a.tq_len <= 0 || a.tk_len <= 0) return cudaErrorInvalidValue;
  switch (head_dim) {
    case 16:
      return dtype ? Launch<__nv_bfloat16, 16>::run(a) : Launch<float, 16>::run(a);
    case 32:
      return dtype ? Launch<__nv_bfloat16, 32>::run(a) : Launch<float, 32>::run(a);
    case 64:
      return dtype ? Launch<__nv_bfloat16, 64>::run(a) : Launch<float, 64>::run(a);
    case 128:
      return dtype ? Launch<__nv_bfloat16, 128>::run(a) : Launch<float, 128>::run(a);
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
