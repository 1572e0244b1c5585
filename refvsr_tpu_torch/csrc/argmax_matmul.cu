// K2: streaming max/argmax of patch similarities, for Hopper (sm_90a), and
// its backward pass.
//
// For every LR patch row l of one batch item it returns
//   conf[l]  = max_r <ref[r], lr[l]>         (f32)
//   index[l] = the lowest r attaining it     (int32)
// without ever storing the L_lr x L_ref similarity matrix.
//
// Replaces: refvsr_tpu/ops/pallas/matching_kernel.py, _kernel (launched by
// _pallas_argmax_impl / pallas_argmax_matmul), which the JAX package reaches
// from refvsr_tpu/models/matching.py:FeatureMatching.__call__.
//
// What bounds it on the H100: operations. At the main-path shape
// (L_lr = 129,600, L_ref = 32,400, D = 144, bf16) it is 2*L_lr*L_ref*D =
// 1.21 TFLOP against ~46 MB of input, ~26,000 operations per byte, far above
// the ~295 where the tensor cores, not memory, are the limit (989 TFLOP/s).
// The f32 path (training, 14 x 1024 x 1024 x 144) runs three TF32 products
// per product (495 TFLOP/s).
//
// Design: the TPU grid carried the running (max, argmax) across its
// sequential ref-tile dimension in VMEM. Hopper blocks run in no order, so
// that dimension becomes a loop inside the block, over ref tiles in
// ascending order. Both paths take the argmax from the accumulator
// registers: a thread holds two LR rows and, for each n8 column group j of a
// tile, columns 8j + 2(lane%4) + {0, 1}, so it visits its own columns in
// ascending order across the whole loop and keeps a running (max, argmax)
// with a strict '>' (its lowest column on equal values). After the last
// tile the four lanes that share a row merge with warp shuffles, preferring
// the lower column on equal values: the row's lowest index attaining the
// max, as torch.max and the TPU kernel resolve ties. Columns past L_ref
// (zero-filled rows, whose products are exactly 0) are masked out, so a
// row whose true max is negative never picks a phantom index. No
// similarity tile is written to shared memory.
//
// bf16 (argmax_matmul_kernel_bf16_wgmma): a block of two warpgroups owns
// 256 LR rows, each warpgroup two m64 halves of 64, so `ref` leaves L2 once
// per 256 LR rows. The LR rows never change inside the loop, so they are
// held in registers as wgmma's A fragments (D/16 k-steps x 4 registers per
// half; 72 registers at D = 144, hence D <= 144 and one instantiation per
// D/16): only the ref tiles are read from shared memory. Ref tiles of 128
// rows stream through a 4-stage ring filled by cp.async (every thread issues
// 16-byte copies three tiles ahead of the products; one __syncthreads per
// tile publishes a tile and frees the one read the tile before). Products
// run on `wgmma` m64n128k16 (bf16 x bf16 -> f32), B read by descriptor,
// K-major without swizzle: D = 144 is 288 bytes per row, which fits no
// 128-byte swizzle box, so a tile is stored as 16-byte chunks, chunk c of
// row r at byte (c * 128 + r) * 16; every 8 x 16-byte core matrix is one
// contiguous 128-byte run, the leading-dimension byte offset (the next chunk
// along K) is 128 * 16 and the stride-dimension byte offset (the next 8
// rows) is 128. The copies put 16 consecutive rows of one chunk on 16 lanes,
// so each copy instruction writes whole 128-byte lines. The two halves'
// products are committed separately: the first half's registers are scanned
// while the second half's products run. The grid is not persistent: one
// block per (256 LR rows, batch item) gives 507 blocks at B = 1 and 3,549 at
// B = 7, one resident per SM (234 registers a thread), so the hardware's own
// block scheduling already walks the work; a producer warp with mbarriers in
// place of the per-tile __syncthreads is the next step (PERF.md).
//
// f32 (argmax_matmul_kernel_f32_3xtf32): tensor-core products that keep f32
// parity. Each operand is split in registers as hi = tf32_rn(a), lo =
// tf32_rn(a - hi) (round to nearest, ties away from zero, as cvt.rna does,
// but in integer operations) and the product is hi*hi + hi*lo + lo*hi on
// mma.sync m16n8k8 TF32 with f32 accumulators (the large term and the two
// small ones in separate sums, added once per tile); the dropped lo*lo is
// ~2^-22 relative. A block of eight warps owns 64 LR rows: four row groups
// of 16 times two column halves of each 64-row ref tile, merged through
// shared memory at the end (the training shape has only 224 blocks of 64
// rows, so the halves double the warps an SM can switch between). Ref tiles
// are double-buffered by cp.async; rows are padded to D + 4 floats so the
// fragment loads hit 32 distinct banks.
//
// Backward (replaces the custom VJP _pallas_argmax_bwd of the same file):
// conf = <ref[index[l]], lr[l]>, so the cotangent g of conf reaches only the
// picked ref row: d_lr[b,l,:] = g[b,l] * ref[b, index[b,l], :] (f32, rounded
// once to the input type), and g[b,l] * lr[b,l,:] is added into
// d_ref[b, index[b,l], :] (an f32 buffer, cast by the caller): many LR rows
// may pick the same ref row. Bound by bytes: lr, the picked ref rows, index
// and g in, d_lr and d_ref out, three operations per element. Design: a
// group of lanes per LR row (D / VEC of them, 16 bytes each: 36 in f32 and
// 18 in bf16 at D = 144; blockIdx.y the batch item, so no index is
// divided), which reads its row's index and g once, loads lr and the picked
// ref row in 16-byte vectors, stores d_lr in 16-byte vectors and adds into
// d_ref with float4 reductions (atomicAdd on float4, compute capability
// 9.x): 36 global reductions per row instead of 144. Contention only where
// many LR rows pick one ref row; the reductions' order is the only
// nondeterminism. Either gradient may be skipped. D is a multiple of 16
// and every row 16-byte aligned, as the forward requires of the tensors it
// saves for this pass. The launcher clears d_ref with cudaMemsetAsync on
// the stream, which costs the host less than a torch.zeros call (PERF.md);
// the clear is a pass over all of d_ref, part of this function's work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int SMEM_MAX = 232448;  // bytes of shared memory a block may use

// ------------------------------------------------------ shared helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Fold the columns 8j + e (e = 0, 1; j < NJ) of one tile, offset by c0 (the
// thread's first global column), into the running (max, argmax) of the
// thread's two rows: d[4j + e] is row 0's, d[4j + 2 + e] row 1's. Strict
// '>' in ascending column order keeps the lowest column on equal values;
// with kMask, columns at or past `limit` are skipped.
template <int NJ, bool kMask>
__device__ __forceinline__ void scan_tile(const float* d, int c0, int limit,
                                          float (&best)[2], int (&arg)[2]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + 8 * j + e;
      if (!kMask || c < limit) {
        if (d[4 * j + e] > best[0]) {
          best[0] = d[4 * j + e];
          arg[0] = c;
        }
        if (d[4 * j + 2 + e] > best[1]) {
          best[1] = d[4 * j + 2 + e];
          arg[1] = c;
        }
      }
    }
  }
}

template <int NJ>
__device__ __forceinline__ void scan(const float* d, int c0, int tile_end,
                                     int l_ref, float (&best)[2],
                                     int (&arg)[2]) {
  if (tile_end <= l_ref)
    scan_tile<NJ, false>(d, c0, l_ref, best, arg);
  else
    scan_tile<NJ, true>(d, c0, l_ref, best, arg);
}

// Merge the four lanes that share a row (lanes 4q .. 4q+3): the higher
// value, the lower column on equal values.
__device__ __forceinline__ void merge_lanes(float (&best)[2], int (&arg)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int s = 1; s <= 2; s <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best[h], s);
      const int oi = __shfl_xor_sync(0xffffffffu, arg[h], s);
      if (ov > best[h] || (ov == best[h] && oi < arg[h])) {
        best[h] = ov;
        arg[h] = oi;
      }
    }
  }
}

// After merge_lanes, lane 4q writes rows `row` and `row + 8` below l_lr.
__device__ __forceinline__ void store_rows(const float (&best)[2],
                                           const int (&arg)[2], long long row,
                                           int l_lr, float* conf,
                                           int* index) {
  if ((threadIdx.x & 3) != 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = row + 8 * h;
    if (r < l_lr) {
      conf[r] = best[h];
      index[r] = arg[h];
    }
  }
}

// ------------------------------------------------------- bf16: wgmma

constexpr int BF_WG_ROWS = 128;   // LR rows per warpgroup: two wgmma M = 64
constexpr int BF_TL = 256;        // LR rows per block: two warpgroups
constexpr int BF_TR = 128;        // ref rows per tile (wgmma N)
constexpr int BF_STAGES = 4;      // ref-tile ring
constexpr int BF_THREADS = 256;
constexpr int BF_NJ = BF_TR / 8;  // n8 column groups: 4 * 16 = 64 registers
constexpr int BF_K16_MAX = 9;     // k-steps held in registers: D <= 144

size_t bf16_smem_bytes(int d) {
  return (size_t)BF_STAGES * BF_TR * d * sizeof(__nv_bfloat16);
}

// Rows [row0, row0 + rows) of a (total, d) bf16 matrix into a K-major,
// unswizzled wgmma slab at `dst`: 16-byte chunk c of row r at byte
// (c * rows + r) * 16; rows at or past `total` are zero-filled. Warp w takes
// the 16-row groups w, w + 8, ...; lane l row 16g + (l & 15) and chunks
// 2p + (l >> 4), so a copy instruction covers two whole 128-byte core
// matrices in shared memory and 16 rows x 32 bytes in global memory. (The
// loop written out for its one use, a 16-row group per warp, ran slower on
// the H100.)
__device__ __forceinline__ void load_slab(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long row0, int rows,
                                          long long total, int d) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  for (int g = warp; g < rows / 16; g += BF_THREADS / 32) {
    const int r = g * 16 + (lane & 15);
    const bool valid = row0 + r < total;
    const __nv_bfloat16* s = src + (valid ? row0 + r : 0) * d + half * 8;
    for (int p = 0; p < d / 16; ++p)
      cp_async16(dst + (uint32_t)((2 * p + half) * rows + r) * 16,
                 s + p * 16, valid);
  }
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
__device__ __forceinline__ void fence_acc(float (&d)[4 * BF_NJ]) {
#pragma unroll
  for (int i = 0; i < 4 * BF_NJ; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) = (scale_d ? d : 0) + A (64 x 16) * B (128 x 16)^T,
// A from registers (the m16n8k16 A fragment of each warp's 16 rows: a[0]
// row g, k 2t and 2t + 1; a[1] row g + 8; a[2], a[3] the same at k + 8),
// B from shared memory by descriptor
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[4 * BF_NJ],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// 64 LR rows (their A fragments, k-step by k-step) times one 128-row ref
// tile (from b_base), K16 k-steps, into acc; committed, not waited for.
template <int K16>
__device__ __forceinline__ void tile_products(float (&acc)[4 * BF_NJ],
                                              const uint32_t (&a)[K16][4],
                                              uint32_t b_base) {
  constexpr uint32_t kLbo = BF_TR * 16;
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < K16; ++k)
    wgmma_m64n128k16(acc, a[k], smem_desc(b_base + 2 * k * kLbo, kLbo, 128),
                     k > 0);
  wgmma_commit();
  fence_acc(acc);
}

// The A fragments of 64 LR rows (D = 16 K16) from row `row` (this thread's
// first row; see wgmma_m64n128k16), zero past l_lr.
template <int K16>
__device__ __forceinline__ void load_a(uint32_t (&a)[K16][4],
                                       const __nv_bfloat16* lr_b,
                                       long long row, int l_lr) {
  const int t2 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int k = 0; k < K16; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long r = row + 8 * (j & 1);
      const int c = 16 * k + t2 + 8 * (j >> 1);
      a[k][j] = r < l_lr ? *reinterpret_cast<const uint32_t*>(
                               lr_b + r * (16 * K16) + c)
                         : 0u;
    }
  }
}

// one instantiation per D = 16 K16 (the k-loop and the A fragments are
// unrolled, so no runtime test sits between the asynchronous products)
template <int K16>
__global__ void __launch_bounds__(BF_THREADS, 1)
    argmax_matmul_kernel_bf16_wgmma(const __nv_bfloat16* __restrict__ ref,
                                    const __nv_bfloat16* __restrict__ lr,
                                    float* __restrict__ conf,
                                    int* __restrict__ index, int l_ref,
                                    int l_lr, int d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t tile_bytes = (uint32_t)BF_TR * d * 2;
  const uint32_t s_ref = smem_u32(smem);

  const long long b = blockIdx.y;
  const __nv_bfloat16* lr_b = lr + b * l_lr * (long long)d;
  const __nv_bfloat16* ref_b = ref + b * l_ref * (long long)d;
  const int ntiles = (l_ref + BF_TR - 1) / BF_TR;

  // prologue: ref tiles 0 .. BF_STAGES - 2, one copy group each
#pragma unroll
  for (int s = 0; s < BF_STAGES - 1; ++s) {
    if (s < ntiles)
      load_slab(s_ref + s * tile_bytes, ref_b, (long long)s * BF_TR, BF_TR,
                l_ref, d);
    cp_async_commit();
  }

  // warpgroup wg owns LR rows 128 wg .. 128 wg + 127 of the block, as two
  // m64 halves held in registers: a0/acc0 (rows + 0), a1/acc1 (rows + 64);
  // this thread's first row in each is 16 * (warp in warpgroup) + lane / 4
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * BF_TL +
                        BF_WG_ROWS * (threadIdx.x >> 7) +
                        16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  uint32_t a0[K16][4], a1[K16][4];
  load_a<K16>(a0, lr_b, row, l_lr);
  load_a<K16>(a1, lr_b, row + 64, l_lr);
  const int col = 2 * (lane & 3);
  float acc0[4 * BF_NJ], acc1[4 * BF_NJ];
#pragma unroll
  for (int i = 0; i < 4 * BF_NJ; ++i) {
    acc0[i] = 0.0f;
    acc1[i] = 0.0f;
  }
  float best0[2] = {-INFINITY, -INFINITY}, best1[2] = {-INFINITY, -INFINITY};
  int arg0[2] = {0, 0}, arg1[2] = {0, 0};

  for (int t = 0; t < ntiles; ++t) {
    // tile t has landed (later ones may be in flight); after the barrier
    // every warpgroup is past the products of tile t - 1, whose buffer the
    // copies of tile t + BF_STAGES - 1 then take
    cp_async_wait<BF_STAGES - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int next = t + BF_STAGES - 1;
    if (next < ntiles)
      load_slab(s_ref + (next % BF_STAGES) * tile_bytes, ref_b,
                (long long)next * BF_TR, BF_TR, l_ref, d);
    cp_async_commit();
    const uint32_t b_base = s_ref + (t % BF_STAGES) * tile_bytes;
    const int c0 = t * BF_TR;
    tile_products<K16>(acc0, a0, b_base);
    tile_products<K16>(acc1, a1, b_base);
    // scan the first half while the second half's products run
    wgmma_wait<1>();
    fence_acc(acc0);
    scan<BF_NJ>(acc0, c0 + col, c0 + BF_TR, l_ref, best0, arg0);
    wgmma_wait<0>();
    fence_acc(acc1);
    scan<BF_NJ>(acc1, c0 + col, c0 + BF_TR, l_ref, best1, arg1);
  }
  merge_lanes(best0, arg0);
  merge_lanes(best1, arg1);
  store_rows(best0, arg0, row, l_lr, conf + b * l_lr, index + b * l_lr);
  store_rows(best1, arg1, row + 64, l_lr, conf + b * l_lr, index + b * l_lr);
}

// ---------------------------------------------- f32: 3xTF32 on mma.sync

constexpr int F_TL = 64;        // LR rows per block: four row groups x 16
constexpr int F_TR = 64;        // ref rows per tile: two column halves x 32
constexpr int F_THREADS = 256;  // warp w: row group w % 4, half w / 4
constexpr int F_NJ = F_TR / 16; // n8 column groups per warp and tile

size_t f32_smem_bytes(int d) {
  return (size_t)(F_TL + 2 * F_TR) * (d + 4) * sizeof(float);
}

// rows [row0, row0 + rows) of a (total, d) f32 matrix into shared memory
// with a row stride of ld floats; rows at or past `total` are zero-filled
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long long row0, int rows,
                                              long long total, int d,
                                              int ld) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t base = smem_u32(dst);
  for (int r = warp; r < rows; r += F_THREADS / 32) {
    const bool valid = row0 + r < total;
    const float* s = src + (valid ? row0 + r : 0) * d;
    for (int c = lane; c < d / 4; c += 32)
      cp_async16(base + (uint32_t)(r * ld + 4 * c) * 4, s + 4 * c, valid);
  }
}

// f32 -> TF32 bits, rounded to nearest with ties away from zero as
// cvt.rna.tf32.f32 rounds finite values, in two full-rate integer
// operations (the conversion unit runs at a fraction of their rate): add
// half the weight of the 13 dropped mantissa bits to the magnitude, clear
// them; a carry into the exponent is the rounding up to the next binade.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c (16 x 8) += a (16 x 8, row) * b (8 x 8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(F_THREADS)
    argmax_matmul_kernel_f32_3xtf32(const float* __restrict__ ref,
                                    const float* __restrict__ lr,
                                    float* __restrict__ conf,
                                    int* __restrict__ index, int l_ref,
                                    int l_lr, int d) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_best[F_TL];  // the second column half's candidates
  __shared__ int s_arg[F_TL];
  const int ld = d + 4;
  float* s_lr = reinterpret_cast<float*>(smem);
  float* s_ref = s_lr + F_TL * ld;  // two stages of F_TR rows

  const long long b = blockIdx.y;
  const long long row0 = (long long)blockIdx.x * F_TL;
  const float* lr_b = lr + b * l_lr * (long long)d;
  const float* ref_b = ref + b * l_ref * (long long)d;
  const int ntiles = (l_ref + F_TR - 1) / F_TR;
  load_rows_f32(s_lr, lr_b, row0, F_TL, l_lr, d, ld);
  load_rows_f32(s_ref, ref_b, 0, F_TR, l_ref, d, ld);
  cp_async_commit();

  // mma.m16n8k8 fragments: a0/a2 row g, a1/a3 row g + 8, columns tig and
  // tig + 4; b0/b1 ref row 8j + g of this warp's half, columns tig, tig + 4
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rows = 16 * (warp & 3);
  const int half = F_TR / 2 * (warp >> 2);
  const int g = lane >> 2;
  const int tig = lane & 3;
  const float* a0 = s_lr + (rows + g) * ld + tig;
  const float* a1 = a0 + 8 * ld;
  float best[2] = {-INFINITY, -INFINITY};
  int arg[2] = {0, 0};

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t visible; everyone is done with tile t - 1
    if (t + 1 < ntiles)
      load_rows_f32(s_ref + ((t + 1) & 1) * F_TR * ld, ref_b,
                    (long long)(t + 1) * F_TR, F_TR, l_ref, d, ld);
    cp_async_commit();
    const float* bt = s_ref + (t & 1) * F_TR * ld + (half + g) * ld + tig;
    float big[4 * F_NJ], small[4 * F_NJ];
#pragma unroll
    for (int i = 0; i < 4 * F_NJ; ++i) {
      big[i] = 0.0f;
      small[i] = 0.0f;
    }
    for (int k = 0; k < d; k += 8) {
      uint32_t ah[4], al[4];
      split_tf32(a0[k], ah[0], al[0]);
      split_tf32(a1[k], ah[1], al[1]);
      split_tf32(a0[k + 4], ah[2], al[2]);
      split_tf32(a1[k + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < F_NJ; ++j) {
        uint32_t bh[2], bl[2];
        split_tf32(bt[j * 8 * ld + k], bh[0], bl[0]);
        split_tf32(bt[j * 8 * ld + k + 4], bh[1], bl[1]);
        mma_tf32(small + 4 * j, al, bh);
        mma_tf32(small + 4 * j, ah, bl);
        mma_tf32(big + 4 * j, ah, bh);
      }
    }
#pragma unroll
    for (int i = 0; i < 4 * F_NJ; ++i) big[i] += small[i];
    const int c0 = t * F_TR;
    scan<F_NJ>(big, c0 + half + 2 * tig, c0 + F_TR, l_ref, best, arg);
  }
  // merge the two column halves of each row: the second half's candidates
  // through shared memory, then the first half's lanes merge and store
  merge_lanes(best, arg);
  if (half && (lane & 3) == 0) {
    for (int h = 0; h < 2; ++h) {
      s_best[rows + g + 8 * h] = best[h];
      s_arg[rows + g + 8 * h] = arg[h];
    }
  }
  __syncthreads();
  if (half) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float ov = s_best[rows + g + 8 * h];
    const int oi = s_arg[rows + g + 8 * h];
    if (ov > best[h] || (ov == best[h] && oi < arg[h])) {
      best[h] = ov;
      arg[h] = oi;
    }
  }
  store_rows(best, arg, row0 + rows + g, l_lr, conf + b * l_lr,
             index + b * l_lr);
}

// ------------------------------------------------------------- launch

template <typename T>
int launch_kernel(void (*kernel)(const T*, const T*, float*, int*, int, int,
                                 int),
                  size_t smem, dim3 grid, int threads, const T* ref,
                  const T* lr, float* conf, int* index, int l_ref, int l_lr,
                  int d, cudaStream_t stream) {
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, smem, stream>>>(ref, lr, conf, index, l_ref, l_lr,
                                          d);
  return (int)cudaGetLastError();
}

// Backward: a group of blockDim.x lanes per LR row (blockDim.y rows a
// block, blockIdx.y the batch item), lane q taking the row's 16-byte chunks
// q, q + blockDim.x, ... (VEC elements each). d_lr and d_ref may each be
// null to skip it. D is a multiple of VEC and every row 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(256) argmax_matmul_backward_kernel(
    const T* __restrict__ ref, const T* __restrict__ lr,
    const int* __restrict__ index, const float* __restrict__ g,
    float* __restrict__ d_ref, T* __restrict__ d_lr, int l_ref, int l_lr,
    int d) {
  constexpr int VEC = 16 / sizeof(T);
  const int l = blockIdx.x * blockDim.y + threadIdx.y;
  if (l >= l_lr) return;
  const long long row = (long long)blockIdx.y * l_lr + l;
  const int pick = __ldg(index + row);
  const float gv = __ldg(g + row);
  const T* ref_row = ref + ((long long)blockIdx.y * l_ref + pick) * d;
  float* d_ref_row = d_ref + ((long long)blockIdx.y * l_ref + pick) * d;
  const T* lr_row = lr + row * d;
  T* d_lr_row = d_lr + row * d;
  for (int j = threadIdx.x * VEC; j < d; j += blockDim.x * VEC) {
    if (d_lr != nullptr) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(ref_row + j));
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int i = 0; i < VEC; ++i) o[i] = from_f32<T>(gv * to_f32(e[i]));
      *reinterpret_cast<uint4*>(d_lr_row + j) = out;
    }
    if (d_ref != nullptr) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(lr_row + j));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int q = 0; q < VEC; q += 4)
        atomicAdd(reinterpret_cast<float4*>(d_ref_row + j + q),
                  make_float4(gv * to_f32(e[q]), gv * to_f32(e[q + 1]),
                              gv * to_f32(e[q + 2]), gv * to_f32(e[q + 3])));
    }
  }
}

template <typename T>
int launch_backward(const void* ref, const void* lr, const void* index,
                    const void* g, void* d_ref, void* d_lr, int b, int l_ref,
                    int l_lr, int d, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (b <= 0 || b > 65535 || l_lr <= 0 || l_ref <= 0 || d <= 0 ||
      d % 16 != 0 || (d_ref == nullptr && d_lr == nullptr) ||
      (reinterpret_cast<uintptr_t>(ref) | reinterpret_cast<uintptr_t>(lr) |
       reinterpret_cast<uintptr_t>(d_ref) |
       reinterpret_cast<uintptr_t>(d_lr)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (d_ref != nullptr) {
    const cudaError_t e = cudaMemsetAsync(
        d_ref, 0, (size_t)b * l_ref * d * sizeof(float), stream);
    if (e != cudaSuccess) return (int)e;
  }
  const int chunks = d / VEC;
  const int lanes = chunks < 256 ? chunks : 256;
  const dim3 block((unsigned)lanes, (unsigned)(256 / lanes));
  const dim3 grid((unsigned)((l_lr + block.y - 1) / block.y), (unsigned)b);
  argmax_matmul_backward_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(ref), static_cast<const T*>(lr),
      static_cast<const int*>(index), static_cast<const float*>(g),
      static_cast<float*>(d_ref), static_cast<T*>(d_lr), l_ref, l_lr, d);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. ref (b, l_ref, d), lr (b, l_lr, d)
// contiguous and 16-byte aligned, d a multiple of 16 (at most 144 in bf16,
// registers; 288 in f32, shared memory); conf (b, l_lr) f32 and index
// (b, l_lr) int32 are written. Returns a cudaError_t value (0 = success).
extern "C" int argmax_matmul_launch(const void* ref, const void* lr,
                                    void* conf, void* index, int b, int l_ref,
                                    int l_lr, int d, int dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 16 != 0 || b <= 0 || b > 65535 || l_lr <= 0 ||
      l_ref <= 0 || (dtype == 1 && d > 16 * BF_K16_MAX))
    return (int)cudaErrorInvalidValue;
  float* c = static_cast<float*>(conf);
  int* i = static_cast<int*>(index);
  if (dtype == 0)
    return launch_kernel<float>(
        argmax_matmul_kernel_f32_3xtf32, f32_smem_bytes(d),
        dim3((unsigned)((l_lr + F_TL - 1) / F_TL), (unsigned)b), F_THREADS,
        static_cast<const float*>(ref), static_cast<const float*>(lr), c, i,
        l_ref, l_lr, d, s);
  using Bf16Kernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*,
                             float*, int*, int, int, int);
  static const Bf16Kernel bf16_kernels[BF_K16_MAX] = {
      argmax_matmul_kernel_bf16_wgmma<1>, argmax_matmul_kernel_bf16_wgmma<2>,
      argmax_matmul_kernel_bf16_wgmma<3>, argmax_matmul_kernel_bf16_wgmma<4>,
      argmax_matmul_kernel_bf16_wgmma<5>, argmax_matmul_kernel_bf16_wgmma<6>,
      argmax_matmul_kernel_bf16_wgmma<7>, argmax_matmul_kernel_bf16_wgmma<8>,
      argmax_matmul_kernel_bf16_wgmma<9>};
  if (dtype == 1)
    return launch_kernel<__nv_bfloat16>(
        bf16_kernels[d / 16 - 1], bf16_smem_bytes(d),
        dim3((unsigned)((l_lr + BF_TL - 1) / BF_TL), (unsigned)b), BF_THREADS,
        static_cast<const __nv_bfloat16*>(ref),
        static_cast<const __nv_bfloat16*>(lr), c, i, l_ref, l_lr, d, s);
  return (int)cudaErrorInvalidValue;
}

// Backward of argmax_matmul_launch. ref (b, l_ref, d), lr (b, l_lr, d) and
// d_lr (b, l_lr, d) share one dtype (codes as above); index (b, l_lr) int32
// and g (b, l_lr) f32 are the forward's index and conf's gradient; d_ref is
// an f32 (b, l_ref, d) buffer, which this launcher clears on the stream
// before the kernel. Either d_ref or d_lr may be null to skip that
// gradient. d a multiple of 16 and every pointer 16-byte aligned, else
// cudaErrorInvalidValue. Returns a cudaError_t value (0 = success).
extern "C" int argmax_matmul_backward_launch(const void* ref, const void* lr,
                                             const void* index, const void* g,
                                             void* d_ref, void* d_lr, int b,
                                             int l_ref, int l_lr, int d,
                                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_backward<float>(ref, lr, index, g, d_ref, d_lr, b, l_ref,
                                  l_lr, d, s);
  if (dtype == 1)
    return launch_backward<__nv_bfloat16>(ref, lr, index, g, d_ref, d_lr, b,
                                          l_ref, l_lr, d, s);
  return (int)cudaErrorInvalidValue;
}
