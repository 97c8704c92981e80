// K2: the fused FFN-backward chain dy -> (dh1, db2, db1), for sm_90a.
//
// Replaces the Pallas kernel neurosync_trainer_lite_tpu/ops/ffn_bwd_pallas.py
// (_kernel / ffn_bwd_dh1, pallas_call at :115). For the bf16 training FFN
// y = linear2(dropout(relu(linear1(x)))), whose forward saved the masked
// activation am, it computes in one pass over the [M, F] output:
//
//   dh1  = where(am > 0, (dy . W) * scale, 0)   in fp32, rounded once to bf16
//   db1p = per-row-tile column sums of that fp32 dh1 (before the rounding)
//   db2p = per-row-tile column sums of dy, from the blocks of the first
//          column tile (the Pallas body's pl.when(j == 0))
//
// dy [M, H], W [H, F] (torch's linear2.weight: dh1 = dy . W, no transpose),
// am and dh1 [M, F], all bf16; scale is the fp32 inverted-dropout scale. The
// partials, [ceil(M / kBM), F] and [ceil(M / kBM), H] in fp32, are summed
// outside the kernel: every sum has one owner, no atomics, and the results
// are bitwise the same from run to run.
//
// What bounds it on the H100: operations. At the training shape (M = 16384,
// H = 1024, F = 4096) the product is 137 GFLOP: 0.139 ms at the tensor
// cores' 989 TFLOP/s with bf16 operands, 2.05 ms on the fp32 CUDA cores. The
// bytes (dy 34 MB, W 8 MB, am 134 MB, dh1 134 MB) take 0.093 ms at 3.35 TB/s.
// So the product runs on the tensor cores: WMMA 16x16x16 fragments, bf16
// operands and fp32 accumulation, which is the rounding contract of JAX's
// dot_general(preferred_element_type=float32).
//
// Design, simple first. Where the Pallas kernel holds a 256 x 1024 output
// tile and the whole K = H strip in VMEM, a Hopper block holds 66 KB of
// shared memory: one block of 8 warps owns a 128 x 128 output tile and
// streams K through a ring of 3 shared tiles 32 deep, filled by cp.async
// (16 bytes a thread, no register staging) two tiles ahead of the tensor
// cores, zeros past the ragged edges of M, H and F (element by element
// where a row is not 16-byte aligned). Each warp owns a 32 x 64 sub-tile
// (2 x 4 fragments). The accumulators then pass through shared memory
// (reusing the ring) to the epilogue: the mask and the fp32 scale, the bf16
// store, and the column sums, each taken by one thread in row order. TMA
// and wgmma are the next step for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kBM = 128;     // output rows a block owns (the partials' row tile)
constexpr int kBN = 128;     // output columns a block owns
constexpr int kBK = 32;      // depth of one shared tile
constexpr int kThreads = 256;
constexpr int kLdA = kBK + 8;  // bf16 row pitches: multiples of 8 elements
constexpr int kLdB = kBN + 8;  // (WMMA's rule), 16-byte aligned rows
constexpr int kLdC = kBN + 4;  // fp32 row pitch of the accumulator tile
constexpr int kWarpM = 32;     // warps in a 4 x 2 grid
constexpr int kWarpN = 64;
constexpr int kFragM = kWarpM / 16;
constexpr int kFragN = kWarpN / 16;

constexpr int kStages = 3;     // K tiles in flight (cp.async ring)
constexpr int kTileA = kBM * kLdA;
constexpr int kTileB = kBK * kLdB;

constexpr size_t kSmemAB = (size_t)kStages * (kTileA + kTileB) * sizeof(bf16);
constexpr size_t kSmemC = (size_t)kBM * kLdC * sizeof(float);
constexpr size_t kSmem = kSmemAB > kSmemC ? kSmemAB : kSmemC;

// 16 bytes global -> shared without passing through registers; src_bytes 0
// writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 8 consecutive bf16 of one row into shared memory, zeros past `ncols` or
// for a row past the end (row == nullptr). Vec: one cp.async (rows and the
// chunk are 16-byte aligned, and a chunk is wholly in or out of range);
// else element by element. `any` is a valid address for a zero fill.
template <bool Vec>
__device__ __forceinline__ void load8(bf16* dst, const bf16* row, int col, int ncols,
                                      const bf16* any) {
  if (Vec) {
    const bool ok = row != nullptr && col + 8 <= ncols;
    cp_async16(dst, ok ? row + col : any, ok);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    dst[e] = (row != nullptr && col + e < ncols) ? row[col + e] : __float2bfloat16(0.f);
}

__device__ __forceinline__ float masked(float acc, bf16 a, float scale) {
  return __bfloat162float(a) > 0.f ? __fmul_rn(acc, scale) : 0.f;
}

template <bool Vec>
__global__ void __launch_bounds__(kThreads, 2)
ffn_bwd_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ w,
               const bf16* __restrict__ am, bf16* __restrict__ dh1, float* __restrict__ db2p,
               float* __restrict__ db1p, int m, int h, int f, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* as0 = reinterpret_cast<bf16*>(smem);  // kStages x [kBM][kLdA]: dy rows
  bf16* bs0 = as0 + kStages * kTileA;         // kStages x [kBK][kLdB]: W rows
  float* cs = reinterpret_cast<float*>(smem); // [kBM][kLdC], after the K loop

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp % 4) * kWarpM;
  const int wn = (warp / 4) * kWarpN;
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFragM][kFragN];
#pragma unroll
  for (int i = 0; i < kFragM; ++i)
#pragma unroll
    for (int j = 0; j < kFragN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // K tile kt into ring slot kt % kStages, as one cp.async group
  auto load_tile = [&](int kt) {
    const int k0 = kt * kBK;
    bf16* as = as0 + (kt % kStages) * kTileA;
    bf16* bs = bs0 + (kt % kStages) * kTileB;
    for (int c = tid; c < kBM * kBK / 8; c += kThreads) {
      const int r = c / (kBK / 8), cc = (c % (kBK / 8)) * 8;
      const bf16* src = row0 + r < m ? dy + (long long)(row0 + r) * h + k0 : nullptr;
      load8<Vec>(as + r * kLdA + cc, src, cc, h - k0, dy);
    }
    for (int c = tid; c < kBK * kBN / 8; c += kThreads) {
      const int r = c / (kBN / 8), cc = (c % (kBN / 8)) * 8;
      const bf16* src = k0 + r < h ? w + (long long)(k0 + r) * f + col0 : nullptr;
      load8<Vec>(bs + r * kLdB + cc, src, cc, f - col0, w);
    }
  };

  const int k_tiles = (h + kBK - 1) / kBK;
#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < k_tiles) load_tile(kt);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    // tile kt has landed (at most kStages - 2 newer groups in flight), and
    // every warp is done with tile kt - 1, whose slot the next load takes
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < k_tiles) load_tile(kt + kStages - 1);
    cp_async_commit();
    const bf16* as = as0 + (kt % kStages) * kTileA;
    const bf16* bs = bs0 + (kt % kStages) * kTileB;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[kFragM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[kFragN];
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
        wmma::load_matrix_sync(a[i], as + (wm + 16 * i) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < kFragN; ++j)
        wmma::load_matrix_sync(b[j], bs + kk * kLdB + wn + 16 * j, kLdB);
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
#pragma unroll
        for (int j = 0; j < kFragN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the tile buffers
#pragma unroll
  for (int i = 0; i < kFragM; ++i)
#pragma unroll
    for (int j = 0; j < kFragN; ++j)
      wmma::store_matrix_sync(cs + (wm + 16 * i) * kLdC + wn + 16 * j, acc[i][j], kLdC,
                              wmma::mem_row_major);
  __syncthreads();

  // epilogue: mask, fp32 scale, one bf16 rounding; the fp32 value goes back
  // to shared memory for the column sums
  const int rows = min(kBM, m - row0);
  for (int c = tid; c < kBM * kBN / 8; c += kThreads) {
    const int r = c / (kBN / 8), cc = (c % (kBN / 8)) * 8;
    if (r >= rows) continue;
    const int col = col0 + cc;
    float* cr = cs + r * kLdC + cc;
    const bf16* amr = am + (long long)(row0 + r) * f + col;
    bf16* out = dh1 + (long long)(row0 + r) * f + col;
    if (Vec && col + 8 <= f) {
      const uint4 a4 = *reinterpret_cast<const uint4*>(amr);
      const bf16* a8 = reinterpret_cast<const bf16*>(&a4);
      uint4 o4;
      bf16* o8 = reinterpret_cast<bf16*>(&o4);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        cr[e] = masked(cr[e], a8[e], scale);
        o8[e] = __float2bfloat16_rn(cr[e]);
      }
      *reinterpret_cast<uint4*>(out) = o4;
    } else {
      for (int e = 0; e < 8 && col + e < f; ++e) {
        cr[e] = masked(cr[e], amr[e], scale);
        out[e] = __float2bfloat16_rn(cr[e]);
      }
    }
  }
  __syncthreads();

  if (tid < kBN && col0 + tid < f) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += cs[r * kLdC + tid];
    db1p[(long long)blockIdx.x * f + col0 + tid] = s;
  }
  if (blockIdx.y == 0) {
    for (int c = tid; c < h; c += kThreads) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s += __bfloat162float(dy[(long long)(row0 + r) * h + c]);
      db2p[(long long)blockIdx.x * h + c] = s;
    }
  }
}

template <bool Vec>
cudaError_t launch(const void* dy, const void* w, const void* am, void* dh1, void* db2p,
                   void* db1p, int m, int h, int f, float scale, cudaStream_t stream) {
  // once, before any launch: a call made while a CUDA graph captures the
  // stream could be refused
  static cudaError_t configured = cudaFuncSetAttribute(
      ffn_bwd_kernel<Vec>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (configured != cudaSuccess) return configured;
  const dim3 grid((m + kBM - 1) / kBM, (f + kBN - 1) / kBN);
  ffn_bwd_kernel<Vec><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(w), static_cast<const bf16*>(am),
      static_cast<bf16*>(dh1), static_cast<float*>(db2p), static_cast<float*>(db1p), m, h, f,
      scale);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// dy [m, h], w [h, f], am [m, f] in, dh1 [m, f] out, all contiguous bf16;
// db2p [partial_rows, h] and db1p [partial_rows, f] fp32 partials out, where
// partial_rows must be ceil(m / 128), the row tiles. Returns the
// cudaError_t of the launch.
extern "C" int ffn_bwd_dh1(const void* dy, const void* w, const void* am, void* dh1,
                           void* db2p, void* db1p, int m, int h, int f, int partial_rows,
                           float scale, void* stream) {
  if (m <= 0 || h <= 0 || f <= 0 || (f + kBN - 1) / kBN > 65535 ||
      partial_rows != (m + kBM - 1) / kBM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = h % 8 == 0 && f % 8 == 0 && aligned16(dy) && aligned16(w) &&
                   aligned16(am) && aligned16(dh1);
  if (vec) return (int)launch<true>(dy, w, am, dh1, db2p, db1p, m, h, f, scale, s);
  return (int)launch<false>(dy, w, am, dh1, db2p, db1p, m, h, f, scale, s);
}
