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
// What bounds it on the H100. At the training shape (M = 16384, H = 1024,
// F = 4096) the product is 137 GFLOP: 0.139 ms at the tensor cores' 989
// TFLOP/s with bf16 operands. The bytes (dy 34 MB, W 8 MB, am 134 MB read,
// dh1 134 MB written) take 0.093 ms at 3.35 TB/s. The two are close, so the
// product has to run at the tensor cores' full rate and the epilogue's
// traffic should not stall it.
//
// Two kernels, chosen in ffn_bwd_dh1() below.
//
// ffn_bwd_wgmma_kernel: every shape TMA can describe (h and f multiples of
// 8, 16-byte aligned tensors), the training shape among them.
//  - A block of three warpgroups owns a 128 x 256 output tile. The grid
//    walks the column tiles fastest, so the 16 blocks that read one row tile
//    of dy run side by side and W (8 MB) stays in L2.
//  - One producer thread keeps a 3-deep ring of K stages 64 deep in flight
//    with TMA (cp.async.bulk.tensor) on mbarriers: a stage is dy's 128 x 64
//    tile and W's 64 x 256 as four 64 x 64 boxes, 48 KB, 128-byte swizzled.
//    Once the ring is full it loads the block's am tile too (64 KB, the
//    room of a fourth stage), under the products. TMA zero-fills past the
//    ends of M, H and F.
//  - Two consumer warpgroups (rows 0-63 and 64-127) run
//    wgmma.mma_async.m64n256k16 with bf16 operands from shared memory and
//    fp32 accumulation (the rounding contract of JAX's
//    dot_general(preferred_element_type=float32)): dy K-major, W N-major,
//    which wgmma reads for 16-bit types with no transpose. One stage's
//    products stay in flight while the next stage's are issued; each
//    stage goes back to the producer when its products are done. setmaxnreg
//    moves registers from the producer warpgroup (40) to the consumers
//    (232): 128 fp32 accumulators a thread.
//  - The epilogue works from the accumulator registers and the am tile in
//    shared memory: the mask, the fp32 scale, one bf16 rounding written in
//    place over am, which a TMA store then writes out as dh1 while the
//    column sums run. The db1 partials are column sums over the block's 128
//    rows: warp shuffles over each warp's 16 rows, then one pass through 8
//    KB of shared memory, in a fixed order. The blocks of column tile 0 then
//    sum their 128 rows of dy for the db2 partials (16 bytes a thread; two
//    halves of 64 rows, added in order).
//  - Not yet: persistent blocks (one a SM, a tile's epilogue under the next
//    tile's loads and products).
//
// ffn_bwd_wmma_kernel: the rest (h or f not a multiple of 8, or a tensor
// not 16-byte aligned), the first design: 8 warps own a 128 x 128 output
// tile, WMMA 16 x 16 x 16 fragments (bf16 operands, fp32 accumulation) on K
// tiles 32 deep, loaded element by element into a ring of 3 shared tiles
// with zeros past the ragged edges; the accumulators pass through shared
// memory to the epilogue, and each column sum is taken by one thread in row
// order.

#include <cuda.h>  // CUtensorMap and its enums only: no -lcuda at build
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kBM = 128;  // output rows a block owns (the partials' row tile)

__device__ __forceinline__ float masked(float acc, bf16 a, float scale) {
  return __bfloat162float(a) > 0.f ? __fmul_rn(acc, scale) : 0.f;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// the wgmma kernel

constexpr int kWgBN = 256;        // output columns a block owns
constexpr int kWgBK = 64;         // depth of a K stage: one 128-byte row of bf16
constexpr int kWgStages = 3;      // K stages in flight
constexpr int kWgConsumers = 2;   // warpgroups running wgmma, 64 rows each
constexpr int kWgThreads = 128 * (kWgConsumers + 1);
constexpr int kTileA = kBM * kWgBK * 2;      // dy's stage tile, bytes
constexpr int kBoxB = kWgBK * 64 * 2;        // one 64 x 64 box of W
constexpr int kStage = kTileA + 4 * kBoxB;   // 48 KB
constexpr int kBoxOut = kBM * 64 * 2;        // one 128 x 64 box of am / dh1
constexpr int kTileOut = 4 * kBoxOut;        // the block's am, then dh1: 64 KB
constexpr int kColSums = 8 * kWgBN * 4;      // a column sum per warp and column
// a 1024-byte aligned ring (the swizzle's period), the am / dh1 tile, the
// column sums, a full and an empty barrier a stage and one for am
constexpr size_t kWgSmem =
    1024 + (size_t)kWgStages * kStage + kTileOut + kColSums + (2 * kWgStages + 1) * 8;
// wgmma descriptor strides (bytes). dy: 8-row groups of 128-byte rows.
// W: its boxes lie 8 KB apart along N, its 8-row groups 1 KB apart along K.
constexpr unsigned kSboA = 1024;
constexpr unsigned kLboB = kBoxB;
constexpr unsigned kSboB = 1024;

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// the box at (x, y) (x the innermost coordinate) of a 2-D tensor map into
// shared memory, its bytes counted on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int x,
                                         int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

// the box at (x, y) of a 2-D tensor map from shared memory to global memory
// (as one bulk group of the issuing thread; elements past the ends are not
// written)
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(x), "r"(y)
      : "memory");
}

// a wgmma shared-memory descriptor for a 128-byte swizzled tile
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, unsigned lbo, unsigned sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// the compiler may not move accumulator reads or writes across this point:
// wgmma writes them asynchronously
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 256] += A[64 x 16] . B[16 x 256] on the warpgroup: A K-major and B
// N-major (imm-trans-b = 1), both bf16 in shared memory, fp32 accumulators:
// element 4j + e of d lies in row 16 (warp % 4) + lane / 4 + 8 (e / 2),
// column 8j + 2 (lane % 4) + e % 2
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}
// the 256 consumer threads only (named barrier 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kWgConsumers) : "memory");
}

__global__ void __launch_bounds__(kWgThreads, 1)
ffn_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_dy,
                     const __grid_constant__ CUtensorMap map_w,
                     const __grid_constant__ CUtensorMap map_am,
                     const __grid_constant__ CUtensorMap map_dh1, const bf16* __restrict__ dy,
                     float* __restrict__ db2p, float* __restrict__ db1p, int m, int h, int f,
                     float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  unsigned char* tile = ring + kWgStages * kStage;  // 4 boxes [128][64]: am, then dh1
  float* colsum = reinterpret_cast<float*>(tile + kTileOut);  // [8][kWgBN]
  uint64_t* full = reinterpret_cast<uint64_t*>(colsum + 8 * kWgBN);
  uint64_t* empty = full + kWgStages;
  uint64_t* am_full = empty + kWgStages;

  const int wg = threadIdx.x / 128;
  const int col0 = blockIdx.x * kWgBN, row0 = blockIdx.y * kBM;
  const int k_tiles = (h + kWgBK - 1) / kWgBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);                  // the producer's expect_tx
      mbar_init(&empty[s], 4 * kWgConsumers);  // one arrival a consumer warp
    }
    mbar_init(am_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kWgConsumers) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 128 * kWgConsumers) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % kWgStages;
        // the consumers have released the stage's previous contents
        if (kt >= kWgStages) mbar_wait(&empty[s], (kt / kWgStages - 1) & 1);
        unsigned char* stage = ring + s * kStage;
        mbar_expect_tx(&full[s], kStage);
        tma_load(stage, &map_dy, &full[s], kt * kWgBK, row0);
        for (int c = 0; c < 4; ++c)
          tma_load(stage + kTileA + c * kBoxB, &map_w, &full[s], col0 + 64 * c, kt * kWgBK);
        // the epilogue's am tile, once the ring is full
        if (kt == min(kWgStages, k_tiles) - 1) {
          mbar_expect_tx(am_full, kTileOut);
          for (int c = 0; c < 4; ++c)
            tma_load(tile + c * kBoxOut, &map_am, am_full, col0 + 64 * c, row0);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % kWgStages;
      mbar_wait(&full[s], (kt / kWgStages) & 1);
      const unsigned char* a_tile = ring + s * kStage + wg * 64 * kWgBK * 2;
      const unsigned char* b_tile = ring + s * kStage + kTileA;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk)
        wgmma_m64n256k16(acc, wgmma_desc(a_tile + kk * 32, 16, kSboA),
                         wgmma_desc(b_tile + kk * 16 * 128, kLboB, kSboB));
      wgmma_commit();
      fence_acc(acc);
      // the previous stage's products are done: release it
      wgmma_wait<1>();
      fence_acc(acc);
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % kWgStages]);
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // epilogue, in place in the am tile: mask, fp32 scale, one bf16
    // rounding; the fp32 values stay in acc for the column sums. am is
    // zero past the ends of M and F, so are those values. A thread's pair
    // (row r, column c) lies in box c / 64 at row r, 16-byte chunk
    // (c % 64 / 8) ^ (r % 8) (the 128-byte swizzle): the 8 rows of a warp's
    // access fall in distinct banks.
    mbar_wait(am_full, 0);
    const int r_tile = wg * 64 + warp * 16 + (lane >> 2);  // rows r_tile, r_tile + 8
#pragma unroll
    for (int j = 0; j < kWgBN / 8; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r_tile + 8 * half;
        __nv_bfloat162* pair = reinterpret_cast<__nv_bfloat162*>(
            tile + (j / 8) * kBoxOut + r * 128 + (((j % 8) ^ (r % 8)) << 4) + 4 * (lane & 3));
        float& x = acc[4 * j + 2 * half];
        float& y = acc[4 * j + 2 * half + 1];
        const __nv_bfloat162 a2 = *pair;
        x = masked(x, a2.x, scale);
        y = masked(y, a2.y, scale);
        *pair = __floats2bfloat162_rn(x, y);
      }
    }
    // dh1 to global memory by TMA, under the column sums
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumers_sync();
    if (threadIdx.x == 0) {
      for (int c = 0; c < 4; ++c) tma_store(&map_dh1, tile + c * kBoxOut, col0 + 64 * c, row0);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    // db1p: each warp's 16 rows by shuffles (lanes l, l ^ 4, l ^ 8, ... hold
    // one column pair), then the 8 warps' sums in warp order
    const int slot = wg * 4 + warp;
#pragma unroll
    for (int j = 0; j < kWgBN / 8; ++j) {
      float s0 = acc[4 * j] + acc[4 * j + 2], s1 = acc[4 * j + 1] + acc[4 * j + 3];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if (lane < 4) {
        colsum[slot * kWgBN + j * 8 + 2 * lane] = s0;
        colsum[slot * kWgBN + j * 8 + 2 * lane + 1] = s1;
      }
    }
    consumers_sync();
    const int t = threadIdx.x;  // one column a consumer thread
    if (col0 + t < f) {
      float sum = 0.f;
      for (int w = 0; w < 4 * kWgConsumers; ++w) sum += colsum[w * kWgBN + t];
      db1p[(long long)blockIdx.y * f + col0 + t] = sum;
    }
    // the dh1 store has read the tile before the block may end
    if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    if (blockIdx.x != 0) return;
    // db2p: 16 bytes of a row a thread, rows 0-63 and 64-127 by the two
    // halves of the consumers, added in that order
    const int c8 = (t % 128) * 8, r0 = (t / 128) * 64;
    for (int base = 0; base < h; base += 1024) {
      const int col = base + c8;
      float sum[8] = {};
      if (col < h) {
        for (int r = r0; r < r0 + 64 && row0 + r < m; ++r) {
          const uint4 u = *reinterpret_cast<const uint4*>(dy + (long long)(row0 + r) * h + col);
          const bf16* u8 = reinterpret_cast<const bf16*>(&u);
#pragma unroll
          for (int e = 0; e < 8; ++e) sum[e] += __bfloat162float(u8[e]);
        }
      }
      consumers_sync();  // the previous reads of colsum are done
      if (t >= 128)
#pragma unroll
        for (int e = 0; e < 8; ++e) colsum[c8 + e] = sum[e];
      consumers_sync();
      if (t < 128 && col < h)
#pragma unroll
        for (int e = 0; e < 8; ++e) db2p[(long long)blockIdx.y * h + col + e] = sum[e] + colsum[c8 + e];
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time through the runtime's entry
// point query (no -lcuda at build)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a row-major [rows, cols] bf16 matrix in boxes of box_rows x box_cols, 128-byte
// swizzled, zeros past its ends
bool encode_map(EncodeTiled encode, CUtensorMap* map, const void* base, int rows, int cols,
                int box_rows, int box_cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_wgmma(const void* dy, const void* w, const void* am, void* dh1, void* db2p,
                         void* db1p, int m, int h, int f, float scale, cudaStream_t stream) {
  // once, before any launch: a call made while a CUDA graph captures the
  // stream could be refused
  static const cudaError_t configured = cudaFuncSetAttribute(
      ffn_bwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kWgSmem);
  if (configured != cudaSuccess) return configured;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap map_dy, map_w, map_am, map_dh1;
  if (!encode_map(encode, &map_dy, dy, m, h, kBM, kWgBK) ||
      !encode_map(encode, &map_w, w, h, f, kWgBK, 64) ||
      !encode_map(encode, &map_am, am, m, f, kBM, 64) ||
      !encode_map(encode, &map_dh1, dh1, m, f, kBM, 64))
    return cudaErrorInvalidValue;
  const dim3 grid((f + kWgBN - 1) / kWgBN, (m + kBM - 1) / kBM);
  ffn_bwd_wgmma_kernel<<<grid, kWgThreads, kWgSmem, stream>>>(
      map_dy, map_w, map_am, map_dh1, static_cast<const bf16*>(dy),
      static_cast<float*>(db2p), static_cast<float*>(db1p), m, h, f, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the WMMA kernel, for shapes TMA cannot describe

constexpr int kBN = 128;     // output columns a block owns
constexpr int kBK = 32;      // depth of one shared tile
constexpr int kThreads = 256;
constexpr int kLdA = kBK + 8;  // bf16 row pitches: multiples of 8 elements
constexpr int kLdB = kBN + 8;  // (WMMA's rule)
constexpr int kLdC = kBN + 4;  // fp32 row pitch of the accumulator tile
constexpr int kWarpM = 32;     // warps in a 4 x 2 grid
constexpr int kWarpN = 64;
constexpr int kFragM = kWarpM / 16;
constexpr int kFragN = kWarpN / 16;

constexpr int kStages = 3;     // K tiles in the ring
constexpr int kTileAw = kBM * kLdA;
constexpr int kTileBw = kBK * kLdB;

constexpr size_t kSmemAB = (size_t)kStages * (kTileAw + kTileBw) * sizeof(bf16);
constexpr size_t kSmemC = (size_t)kBM * kLdC * sizeof(float);
constexpr size_t kSmem = kSmemAB > kSmemC ? kSmemAB : kSmemC;

// 8 consecutive bf16 of one row into shared memory, zeros past `ncols` or
// for a row past the end (row == nullptr)
__device__ __forceinline__ void load8(bf16* dst, const bf16* row, int col, int ncols) {
#pragma unroll
  for (int e = 0; e < 8; ++e)
    dst[e] = (row != nullptr && col + e < ncols) ? row[col + e] : __float2bfloat16(0.f);
}

__global__ void __launch_bounds__(kThreads, 2)
ffn_bwd_wmma_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ w,
                    const bf16* __restrict__ am, bf16* __restrict__ dh1,
                    float* __restrict__ db2p, float* __restrict__ db1p, int m, int h, int f,
                    float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* as0 = reinterpret_cast<bf16*>(smem);  // kStages x [kBM][kLdA]: dy rows
  bf16* bs0 = as0 + kStages * kTileAw;        // kStages x [kBK][kLdB]: W rows
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

  // K tile kt into ring slot kt % kStages
  auto load_tile = [&](int kt) {
    const int k0 = kt * kBK;
    bf16* as = as0 + (kt % kStages) * kTileAw;
    bf16* bs = bs0 + (kt % kStages) * kTileBw;
    for (int c = tid; c < kBM * kBK / 8; c += kThreads) {
      const int r = c / (kBK / 8), cc = (c % (kBK / 8)) * 8;
      const bf16* src = row0 + r < m ? dy + (long long)(row0 + r) * h + k0 : nullptr;
      load8(as + r * kLdA + cc, src, cc, h - k0);
    }
    for (int c = tid; c < kBK * kBN / 8; c += kThreads) {
      const int r = c / (kBN / 8), cc = (c % (kBN / 8)) * 8;
      const bf16* src = k0 + r < h ? w + (long long)(k0 + r) * f + col0 : nullptr;
      load8(bs + r * kLdB + cc, src, cc, f - col0);
    }
  };

  const int k_tiles = (h + kBK - 1) / kBK;
#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt)
    if (kt < k_tiles) load_tile(kt);
  for (int kt = 0; kt < k_tiles; ++kt) {
    // tile kt is stored, and every warp is done with tile kt - 1, whose
    // slot the next load takes
    __syncthreads();
    if (kt + kStages - 1 < k_tiles) load_tile(kt + kStages - 1);
    const bf16* as = as0 + (kt % kStages) * kTileAw;
    const bf16* bs = bs0 + (kt % kStages) * kTileBw;
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
    for (int e = 0; e < 8 && col + e < f; ++e) {
      cr[e] = masked(cr[e], amr[e], scale);
      out[e] = __float2bfloat16_rn(cr[e]);
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

cudaError_t launch_wmma(const void* dy, const void* w, const void* am, void* dh1, void* db2p,
                        void* db1p, int m, int h, int f, float scale, cudaStream_t stream) {
  static const cudaError_t configured = cudaFuncSetAttribute(
      ffn_bwd_wmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (configured != cudaSuccess) return configured;
  const dim3 grid((m + kBM - 1) / kBM, (f + kBN - 1) / kBN);
  ffn_bwd_wmma_kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(w), static_cast<const bf16*>(am),
      static_cast<bf16*>(dh1), static_cast<float*>(db2p), static_cast<float*>(db1p), m, h, f,
      scale);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// dy [m, h], w [h, f], am [m, f] in, dh1 [m, f] out, all contiguous bf16;
// db2p [partial_rows, h] and db1p [partial_rows, f] fp32 partials out, where
// partial_rows must be ceil(m / 128), the row tiles. The wgmma kernel takes
// what TMA can describe (h, f multiples of 8, 16-byte aligned tensors), the
// WMMA kernel the rest. Returns the cudaError_t of the launch.
extern "C" int ffn_bwd_dh1(const void* dy, const void* w, const void* am, void* dh1,
                           void* db2p, void* db1p, int m, int h, int f, int partial_rows,
                           float scale, void* stream) {
  if (m <= 0 || h <= 0 || f <= 0 || partial_rows != (m + kBM - 1) / kBM ||
      partial_rows > 65535 || (f + kBN - 1) / kBN > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tma = h % 8 == 0 && f % 8 == 0 && aligned16(dy) && aligned16(w) &&
                   aligned16(am) && aligned16(dh1);
  if (tma) return (int)launch_wgmma(dy, w, am, dh1, db2p, db1p, m, h, f, scale, s);
  return (int)launch_wmma(dy, w, am, dh1, db2p, db1p, m, h, f, scale, s);
}
