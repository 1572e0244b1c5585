// K3: 3x3 SAME convolution with bias on one (H, W, C) bf16 image, for
// Hopper (sm_90a).
//
//   s[h, w, o] = sum_{dy, dx, i} x[h + dy - 1, w + dx - 1, i]
//                                * wm[(3 dy + dx) C + i, o]       (f32)
//   y[h, w, o] = bf16( bf16(s[h, w, o]) + bias[o] )
//
// x outside the image is zero (SAME padding). wm is the HWIO kernel
// flattened tap-major, (9C, C). The sum is rounded to bf16 before the bf16
// bias is added and the result rounded again, as the TPU kernel does.
//
// Replaces: scripts/microbench_pallas_conv.py, _kernel (launched by
// pallas_conv), a Pallas experiment that the JAX package never dispatches;
// its conv is the 48-channel 3x3 conv of the model's resblock chain.
//
// What bounds it on the H100: bytes, barely. At 1080x1920x48 it reads x
// once and writes y once, 398 MB (0.119 ms at 3.35 TB/s), against 86 GFLOP
// (0.087 ms at 989 TFLOP/s bf16): the tensor cores have to run at over 70%
// of their peak while memory streams for the kernel to reach its bound.
//
// Design: the TPU kernel DMAs an (R+2)-row halo stripe into VMEM (a manual
// double buffer) and builds an im2col tensor for one big MXU product. Here
// the product is implicit GEMM on `wgmma`, with both operands read from
// shared memory by descriptor and nothing copied between them:
//
// - Persistent grid, one block per SM, walking tiles of TH output rows x 64
//   pixels in row-band order (so the blocks in flight share their halo rows
//   through L2). A block holds wm for all its tiles (41,472 B at C = 48),
//   stored as wgmma's K-major B operand: 16-byte chunk c (8 input channels
//   of one tap) of output channel n at byte (c C + n) 16, each 8 x 16-byte
//   core matrix one contiguous 128-byte run.
// - Halo ring: one producer thread keeps STAGES halo buffers of
//   (TH + 2) x 66 pixels in flight with TMA, one box per 16-channel group
//   from x seen as (16, C / 16, W, H); the boxes start at negative and run
//   past the last coordinates, and TMA fills what lies outside the image
//   with zeros (SAME padding with no padded copy and no masking). A buffer
//   is thus channel-group-major: a slab per 16-channel group, [row][pixel]
//   x 32 bytes in the 32-byte swizzle, which is wgmma's K-major A layout
//   for one 16-channel k-step (8 pixels a 256-byte atom). The A operand of
//   tap (dy, dx) is a descriptor whose start address moves by dy rows and
//   dx 32-byte pixels: no ldmatrix, no im2col, and no bank conflicts. The
//   swizzle follows the absolute shared-memory address on both sides, so a
//   start inside an atom needs no base offset. A `full` mbarrier counts a
//   buffer's bytes in; the consumers free it through an `empty` mbarrier
//   once their products on it are done, so the next tiles' halos load
//   while this tile's products and epilogue run.
// - Two consumer warpgroups split each tile's rows. A row is one wgmma
//   m64nCk16 chain over K = 9C (tap-major, 16 channels a step: 27 products
//   at C = 48) into f32 registers (C/2 a thread). Each warpgroup keeps two
//   accumulator sets, so the next row's products run while this row's
//   epilogue does.
// - Epilogue in registers: round to bf16, add the bias (held in registers),
//   round again; the warpgroup writes the row's 64 x C outputs, one
//   contiguous run of y, to one of its two staging rows, and one thread
//   stores it with a bulk asynchronous copy (only the pixels inside the
//   image), which overlaps the next rows.
//
// Measured choices (bench/probe_conv.py, PERF.md): 32-byte swizzled boxes
// against unswizzled 8-channel (16-byte) ones, which make twice the box
// rows; TMA boxes against 16-byte cp.async copies from 4 or 8 producer
// warps; A by descriptor (option b) against A from registers by ldmatrix
// (option a), slower at every C; 8-row tiles in a 2-buffer ring
// against 6- and 4-row tiles in 3; two staging rows against one. What is
// left: each m64n48k16 reads 3.5 KB of operands from shared memory for 24
// cycles of tensor work, and the copies still take longer than the bytes
// need.
//
// Tile height and ring depth by C (Plan below) keep wm, the ring and the
// staging rows within 227 KB of shared memory.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TW = 64;                          // output pixels a row: M
constexpr int PW = TW + 2;                      // halo pixels a row
constexpr int CONSUMERS = 2;                    // consumer warpgroups
constexpr int THREADS = 128 * CONSUMERS + 32;   // and one producer warp
constexpr int SMEM_MAX = 232448;                // bytes a block may use

// output rows a tile (TH) and halo buffers (STAGES) by channel count
template <int C> struct Plan;
template <> struct Plan<16> { static constexpr int TH = 8, STAGES = 3; };
template <> struct Plan<32> { static constexpr int TH = 8, STAGES = 3; };
template <> struct Plan<48> { static constexpr int TH = 8, STAGES = 2; };
template <> struct Plan<64> { static constexpr int TH = 4, STAGES = 2; };
template <> struct Plan<80> { static constexpr int TH = 2, STAGES = 2; };

// shared memory: wm, the halo ring, the consumer warpgroups' staging
// rows, then the full and empty mbarriers
template <int C> struct Layout {
  static constexpr int G = C / 8;               // 16-byte channel groups
  static constexpr int TH = Plan<C>::TH;
  static constexpr int STAGES = Plan<C>::STAGES;
  static constexpr int ROWS = TH + 2;
  static constexpr int RPW = TH / CONSUMERS;    // rows a warpgroup a tile
  // the halo ring and its slabs start on 1024 bytes (a swizzled TMA
  // destination's alignment)
  static constexpr uint32_t HALO = (9 * C * C * 2 + 1023) / 1024 * 1024;
  // one 16-channel group's (TH + 2) x 66 pixels x 32 bytes
  static constexpr uint32_t SLAB = (ROWS * PW * 32 + 1023) / 1024 * 1024;
  static constexpr uint32_t STAGE_BYTES = C / 16 * SLAB;
  static constexpr uint32_t OUT = HALO + STAGES * STAGE_BYTES;
  static constexpr uint32_t OUT_BYTES = TW * C * 2;
  // staging rows a warpgroup: two where they fit, so a row's epilogue
  // need not wait for the store of the row before
  static constexpr int OUT_BUFS =
      OUT + 2 * CONSUMERS * OUT_BYTES + 2 * STAGES * 8 <= SMEM_MAX ? 2 : 1;
  static constexpr uint32_t BARS = OUT + OUT_BUFS * CONSUMERS * OUT_BYTES;
  static constexpr uint32_t BYTES = BARS + 2 * STAGES * 8;
  static_assert(BYTES <= SMEM_MAX, "wm, the ring and staging exceed 227 KB");
  static_assert(TH % CONSUMERS == 0, "rows split evenly");
};

// ------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a (16, 1, 66, TH + 2) box of the (16, C / 16, W, H) view of x at
// coordinates (0, k, x0, y0) -> shared memory at dst in the 32-byte
// swizzle, completing its bytes on the mbarrier; elements outside the
// tensor arrive as zeros
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int k, int x0,
                                            int y0) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(k),
      "r"(x0), "r"(y0)
      : "memory");
}

// arrive on the mbarrier and expect `bytes` of transactions in its phase
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// shared-memory writes of this thread -> the async proxy (wgmma, bulk copy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// `bytes` of shared memory -> global memory, asynchronously (bulk group)
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
}
// until at most N bulk stores of this thread still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// wgmma shared-memory matrix descriptor, no swizzle: start address, leading
// (K-direction) and stride (M/N-direction) byte offsets, each >> 4
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin the accumulator registers in program order around the asynchronous
// products, so no read or write of them moves across a wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, f32) = (scale_d ? d : 0) + A (64 x 16) * B (16 x N), both
// bf16 from shared memory by descriptor, K-major. Thread t of the
// warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (d[4j], d[4j + 1]) and
// 8 more (d[4j + 2], d[4j + 3]), columns 8j + 2 (t % 4) + {0, 1}.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<48>(float (&d)[24], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<80>(float (&d)[40], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39}, "
      "%40, %41, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(a), "l"(b), "r"(scale_d));
}

// ------------------------------------------------------------------ kernel

// One output row of the tile (tile-local row r, 0 .. TH - 1), 64 pixels x
// C, from the halo buffer at `halo` and wm at `wsm`, into acc; committed,
// not waited for. A k-step's A operand is 64 consecutive 32-byte pixel rows
// of its 16-channel slab in the 32-byte swizzle (8 rows a 256-byte atom,
// SBO 256 bytes; K fits one row, so LBO is unused). The swizzle is a
// function of the absolute shared-memory address, as TMA wrote it, so a
// tap's start address may sit anywhere in an atom, base offset 0.
template <int C>
__device__ __forceinline__ void row_products(float (&acc)[C / 2],
                                             uint32_t halo, uint32_t wsm,
                                             int r) {
  constexpr int G = C / 8;
  constexpr uint64_t SWIZZLE_32B = 3ull << 62;
  const uint64_t b0 = smem_desc(wsm, C * 16, 128);
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < 9; ++t) {
#pragma unroll
    for (int s = 0; s < C / 16; ++s) {
      const uint32_t a = halo + s * Layout<C>::SLAB +
                         ((r + t / 3) * PW + t % 3) * 32;
      // descriptor start addresses count 16-byte units
      const uint32_t b_off = (t * G + 2 * s) * C;
      wgmma_ss<C>(acc, smem_desc(a, 16, 256) | SWIZZLE_32B, b0 + b_off,
                  t + s > 0);
    }
  }
  wgmma_commit();
  fence_acc(acc);
}

// Round, add the bias, round; stage the row in shared memory and store the
// pixels inside the image with one bulk copy. tid: the thread in its
// warpgroup; stage: the warpgroup's staging rows, of which `slot` is next;
// bar: its named barrier.
template <int C>
__device__ __forceinline__ void row_epilogue(
    const float (&acc)[C / 2], const float (&b)[C / 4], int tid,
    unsigned char* stage, int& slot, int bar, __nv_bfloat16* y, int gy,
    int x0, int h, int w) {
  using L = Layout<C>;
  unsigned char* out_ptr = stage + slot * L::OUT_BYTES;
  slot = (slot + 1) % L::OUT_BUFS;
  // the store that last read this staging row is done reading it
  if (tid == 0) bulk_wait_read<L::OUT_BUFS - 1>();
  bar_sync(bar, 128);
  const int m = 16 * (tid >> 5) + ((tid & 31) >> 2);
  const int q = tid & 3;
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float lo =
          __bfloat162float(__float2bfloat16_rn(acc[4 * j + 2 * half]));
      const float hi =
          __bfloat162float(__float2bfloat16_rn(acc[4 * j + 2 * half + 1]));
      // the sum of two bf16 values is exact in f32 (or rounds where one is
      // below 2^-16 of the other), so this rounds once
      *reinterpret_cast<__nv_bfloat162*>(
          out_ptr + ((m + 8 * half) * C + 8 * j + 2 * q) * 2) =
          __floats2bfloat162_rn(lo + b[2 * j], hi + b[2 * j + 1]);
    }
  }
  fence_async_smem();
  bar_sync(bar, 128);
  if (tid == 0 && gy < h) {
    const int px = min(TW, w - x0);
    bulk_store(y + ((long long)gy * w + x0) * C, smem_u32(out_ptr),
               (uint32_t)px * C * 2);
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1) conv3x3_bias_kernel(
    const __grid_constant__ CUtensorMap x_map,
    const __nv_bfloat16* __restrict__ wm,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y,
    int h, int w, int tiles_x, int n_tiles) {
  using L = Layout<C>;
  constexpr int G = L::G;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + L::BARS;
  const uint32_t empty = full + 8 * L::STAGES;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // this block's tiles: blockIdx.x, blockIdx.x + gridDim.x, ...
  const int n_mine = (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);               // the producer thread
      mbar_init(empty + 8 * s, 4 * CONSUMERS);  // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * CONSUMERS) {
    // halo of tile (ty, tx): rows ty TH - 1 .. ty TH + TH, pixels
    // tx 64 - 1 .. tx 64 + 64, one TMA box per 16-channel group
    if (lane == 0) {
      for (int i = 0; i < n_mine; ++i) {
        const int tile = blockIdx.x + i * gridDim.x;
        const int s = i % L::STAGES;
        mbar_wait(empty + 8 * s, ((i / L::STAGES) & 1) ^ 1);
        const int y0 = (tile / tiles_x) * L::TH - 1;
        const int x0 = (tile % tiles_x) * TW - 1;
        const uint32_t dst = base + L::HALO + s * L::STAGE_BYTES;
        mbar_expect(full + 8 * s, C / 16 * L::ROWS * PW * 32);
        for (int k = 0; k < C / 16; ++k)
          tma_load_4d(dst + k * L::SLAB, &x_map, full + 8 * s, k, x0, y0);
      }
    }
    return;
  }

  // consumers: wm into the B layout (coalesced along the output channels),
  // and the bias of this thread's channel pairs
  for (int i = threadIdx.x; i < 9 * G * C; i += 128 * CONSUMERS) {
    const int c = i / C;
    const int n = i - c * C;
    union {
      uint4 u;
      __nv_bfloat16 e[8];
    } v;
#pragma unroll
    for (int e = 0; e < 8; ++e) v.e[e] = wm[(8 * c + e) * C + n];
    *reinterpret_cast<uint4*>(smem + (size_t)i * 16) = v.u;
  }
  const int wg = warp >> 2;
  const int tid = threadIdx.x & 127;
  float b[C / 4];
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
    b[2 * j] = __bfloat162float(bias[8 * j + 2 * (tid & 3)]);
    b[2 * j + 1] = __bfloat162float(bias[8 * j + 2 * (tid & 3) + 1]);
  }
  fence_async_smem();
  bar_sync(1, 128 * CONSUMERS);

  unsigned char* stage = smem + L::OUT + wg * L::OUT_BUFS * L::OUT_BYTES;
  int slot = 0;
  const int bar = 2 + wg;
  float acc0[C / 2], acc1[C / 2];
  for (int i = 0; i < n_mine; ++i) {
    const int tile = blockIdx.x + i * gridDim.x;
    const int s = i % L::STAGES;
    const uint32_t halo = base + L::HALO + s * L::STAGE_BYTES;
    const int r0 = wg * L::RPW;                   // this warpgroup's rows
    const int gy0 = (tile / tiles_x) * L::TH + r0;
    const int x0 = (tile % tiles_x) * TW;
    mbar_wait(full + 8 * s, (i / L::STAGES) & 1);
    // rows in pairs: the products of one row run during the epilogue of
    // the row before
#pragma unroll
    for (int k = 0; k < L::RPW; k += 2) {
      row_products<C>(acc0, halo, base, r0 + k);
      if (k > 0) {
        wgmma_wait<1>();
        fence_acc(acc1);
        row_epilogue<C>(acc1, b, tid, stage, slot, bar, y, gy0 + k - 1, x0,
                        h, w);
      }
      if (k + 1 < L::RPW) {
        row_products<C>(acc1, halo, base, r0 + k + 1);
        wgmma_wait<1>();
        fence_acc(acc0);
        row_epilogue<C>(acc0, b, tid, stage, slot, bar, y, gy0 + k, x0, h,
                        w);
      }
    }
    wgmma_wait<0>();
    fence_acc(acc0);
    if constexpr (L::RPW > 1) fence_acc(acc1);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);    // the halo buffer is free
    if constexpr (L::RPW % 2 == 1)
      row_epilogue<C>(acc0, b, tid, stage, slot, bar, y, gy0 + L::RPW - 1,
                      x0, h, w);
    else
      row_epilogue<C>(acc1, b, tid, stage, slot, bar, y, gy0 + L::RPW - 1,
                      x0, h, w);
  }
  if (tid == 0) bulk_wait();
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime
// (no link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int C>
int launch(const void* x, const void* wm, const void* bias, void* y, int h,
           int w, cudaStream_t stream) {
  using L = Layout<C>;
  // x (H, W, C) seen as (16 channels, C / 16 groups, W, H), innermost
  // first
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap x_map;
  const cuuint64_t dims[4] = {16, (cuuint64_t)(C / 16), (cuuint64_t)w,
                              (cuuint64_t)h};
  const cuuint64_t strides[3] = {32, (cuuint64_t)C * 2,
                                 (cuuint64_t)w * C * 2};
  const cuuint32_t box[4] = {16, 1, (cuuint32_t)PW, (cuuint32_t)L::ROWS};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (encode(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(x), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      conv3x3_bias_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::BYTES);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, conv3x3_bias_kernel<C>, THREADS, L::BYTES)) !=
      cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles_x = (w + TW - 1) / TW;
  const long long tiles = tiles_x * ((h + L::TH - 1) / L::TH);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long resident = (long long)sms * per_sm;
  const unsigned blocks = (unsigned)(tiles < resident ? tiles : resident);
  conv3x3_bias_kernel<C><<<blocks, THREADS, L::BYTES, stream>>>(
      x_map, static_cast<const __nv_bfloat16*>(wm),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(y), h, w, (int)tiles_x, (int)tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x (h, w, c), wm (9c, c), bias (c) and y (h, w, c), all bf16, contiguous
// and 16-byte aligned; c is 16, 32, 48, 64 or 80 (wm, the halo ring and
// the staging rows must fit one block's shared memory). Returns a
// cudaError_t value (0 = success).
extern "C" int conv3x3_bias_launch(const void* x, const void* wm,
                                   const void* bias, void* y, int h, int w,
                                   int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  switch (c) {
    case 16: return launch<16>(x, wm, bias, y, h, w, s);
    case 32: return launch<32>(x, wm, bias, y, h, w, s);
    case 48: return launch<48>(x, wm, bias, y, h, w, s);
    case 64: return launch<64>(x, wm, bias, y, h, w, s);
    case 80: return launch<80>(x, wm, bias, y, h, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
