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
// Backward. Bound on the H100: operations too. At the training shape
// (B=128 windows, T=128, H=1024, 16 heads of 64) it moves ~235 MB but does
// five T x T x head_dim products per head (~22 GFLOP of fp32). Design,
// simple and deterministic: one block per (batch row, head) stages the
// head's rotated Q and K (fp32) and its V and dO (input type) in shared
// memory, ~98 KB in bf16 at T=128, head_dim=64, so two blocks share an SM.
// Nothing [Tq, Tk] is stored: p is recomputed from q.k in every pass.
//   1. Threads own query rows. One pass over the keys takes the row max
//      and the row sum of exp online, and D_i = sum_t p_it * dp_it (fp32,
//      recomputed, not taken from the rounded forward output); a second
//      pass accumulates dq_i = scale * sum_t ds_it * k_t with
//      ds = p * (dp - D). The row statistics go to shared memory.
//   2. Threads own key rows. One pass accumulates dv_t = sum_i p_it * do_i,
//      another dk_t = scale * sum_i ds_it * q_i (two passes keep each
//      thread's register arrays to three rows of head_dim).
// Every sum has one owner, so there are no float atomics and the gradients
// are bitwise the same from run to run. dv is written in v's type. dq and
// dk are still in the rotated domain and the transpose rotation mixes
// neighbours across head edges, which belong to other blocks: they go to
// fp32 workspaces, and the wrapper applies the transpose rotation there
// (kernel K1, fp32 in and out) and rounds once (ops/fused_attention.py).
// This recomputes q.k four times and do.v twice per (query, key) pair, 640
// fp32 FMAs where the five products need 320, on the CUDA cores: tensor
// cores are the next step for speed here as well.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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
// A bf16 block takes ~98 KB of shared memory at T=128, head_dim 64, so two
// share an SM, and 2 x 128 threads may take up to 255 registers each.
constexpr int kBwdMinBlocksPerSm = 2;

// Four consecutive elements of a shared-memory row as fp32. Every row
// starts at a multiple of 16 bytes (head_dim is a multiple of 8), so these
// are single vector loads, broadcast when a warp reads one row.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
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
