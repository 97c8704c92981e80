// What the LayerNorm backward (layer_norm.cu) and the FFN epilogue
// backward (ffn_epilogue.cu) share: the card's SM count, which sizes their
// grids, and the fixed-order column sum that finishes their per-block fp32
// scratch [blocks, cols] into parameter gradients without atomics, so the
// results are bitwise the same from run to run.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kSumSplit = 16;  // threads summing one column

// The current device's SMs, read once (132, an H100 SXM's, if the query
// fails).
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

// The launch shape of a column-sum kernel over cols columns.
inline dim3 column_sum_grid(int cols) { return dim3((cols + 31) / 32); }
inline dim3 column_sum_block() { return dim3(32, kSumSplit); }

// Column j = 32 * blockIdx.x + threadIdx.x of part [blocks, cols] summed over
// its rows, in a block of column_sum_block(): thread (lane, t) sums the rows
// t, t + kSumSplit, ... in order; thread t = 0 then adds the kSumSplit sums
// in order. Every thread of the block calls it; it returns true, with j and
// the sum set, in the one thread that holds a column's sum.
__device__ __forceinline__ bool column_sum(const float* __restrict__ part, int blocks, int cols,
                                           int& j, float& sum) {
  __shared__ float sums[kSumSplit][32];
  j = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (j < cols)
    for (int i = threadIdx.y; i < blocks; i += kSumSplit)
      s = __fadd_rn(s, part[(long long)i * cols + j]);
  sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || j >= cols) return false;
  float t = sums[0][threadIdx.x];
#pragma unroll
  for (int y = 1; y < kSumSplit; ++y) t = __fadd_rn(t, sums[y][threadIdx.x]);
  sum = t;
  return true;
}

}  // namespace
