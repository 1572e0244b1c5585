// K6: 3x3 SAME convolution with bias on one (H, W, C) f32 image, in three
// TF32 products on the tensor cores, for Hopper (sm_90a).
//
//   y[h, w, o] = bias[o] + sum_{dy, dx, i} x[h + dy - 1, w + dx - 1, i]
//                                          * k[dy, dx, i, o]
//
// x outside the image is zero (SAME padding). Each operand is split as
// a = hi + lo, hi = tf32_rn(a) (round to nearest, ties away from zero, as
// cvt.rna does), and hi*hi + hi*lo + lo*hi is summed in f32: f32 accuracy,
// as cuDNN's f32 convolution with TF32 off gives, and as K2's f32 path and
// K5 compute. The weights' lo is rounded to TF32 when they are packed; x's
// lo = x - hi (exact in f32) goes to the tensor cores as it is, which read
// its TF32 bits. The sum is f32 and the bias is added to it in f32.
//
// Replaces no TPU kernel: the JAX package leaves f32 convolutions to XLA.
// It is K3's (csrc/conv3x3.cu) f32 counterpart, for the f32 evaluation
// paths' residual chains (48 and 36 channels at 270x480), which cuDNN runs
// on NCHW f32 kernels with a transpose in and out and a separate bias add.
//
// What bounds it on the H100: the tensor cores. At 270x480x48 one call
// reads x once and writes y once, 49.8 MB (0.015 ms at 3.35 TB/s), against
// 5.37 GFLOP of products, which three TF32 passes make 16.1 GFLOP (0.033
// ms at 495 TFLOP/s); f32 FMA on the CUDA cores would take 0.080 ms.
//
// Design (K3's shape, with A taken from registers):
//
// - Weights: packed on the host once per parameter version
//   (ops/kernels/conv3x3_f32.pack) into the exact shared-memory image the
//   block needs, both TF32 parts, tap-major, as wgmma's K-major B operand
//   without swizzle: for k-step s (8 input channels of one tap), 16-byte
//   chunk h in {0, 1} of output column n at byte ((2 s + h) N + n) 16.
//   N is C rounded up to 8 (the columns past C are zero). One bulk copy
//   brings them in (165,888 B at C = 48). They leave too little shared
//   memory for a halo of several rows, so:
// - Rows, not tiles: a block takes a contiguous run of the output's
//   64-pixel rows, strip-major (all rows of a 64-pixel-wide strip, then
//   the next strip), split evenly over the blocks. Walking down a strip,
//   each input row is loaded once and serves three output rows: a ring of
//   RING input rows of 66 pixels (the strip and one pixel each side), one
//   TMA box each, zero-filled outside the image by TMA (SAME padding, and
//   C rounded up to CP channels in shared memory: channels past C read as
//   zero). One producer thread keeps the ring full.
// - Two consumer warpgroups take alternate output rows of the block's run.
//   A row is one implicit GEMM: M = 64 pixels, N, K = 9 N, in k-steps of
//   8 channels, each three wgmma m64nNk8 tf32 products. A (the pixels) is
//   read from the ring into registers by each thread (8 or 16 bytes a load,
//   the channel order within a k-step permuted to match, and the ring's
//   pixel stride CP chosen so that a warp's loads are free of bank
//   conflicts), split into its TF32 parts there, and given to wgmma from
//   registers; B comes by descriptor. So wgmma reads only the weights from
//   shared memory (4.5 KB a k-step at N = 48, for 72 cycles of tensor
//   work), and x needs no second copy for its low part.
// - The products of a k-step are in flight while the next k-step's A is
//   loaded and split; two register sets of A alternate. The large products
//   of each tap go to a fresh accumulator, added to the row's f32 sum in
//   registers (round to nearest) once it lands; the small products (hi*lo,
//   lo*hi) keep one accumulator of their own for the row.
// - Epilogue in registers: sum + small + bias, stored straight to y as
//   float2 (each 32-byte run of a pixel's 8 channels written whole). A
//   warpgroup releases its input rows to the producer as soon as it is done
//   with them.
//
// Measured choices (H100, 270x480 and 540x960, against an f64
// convolution and cuDNN's f32 one on the same inputs): the tensor cores'
// f32 accumulation truncates, so one accumulator for a row's 54 k-steps
// of large products gave 2.8x cuDNN's RMS error; a fresh one a k-step,
// summed in registers, 0.45x, at 0.0696 ms for 270x480x48; a fresh one a
// tap 0.48x at 0.0624 ms; x's lo passed unrounded, 0.48x at 0.0582 ms
// (0.0506 ms with one accumulator). cuDNN's f32 convolution took 0.258 ms
// there.
//
// Tile plan by C (Plan below) keeps the weights and the ring within 227 KB.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 64;                          // output pixels a row: M
constexpr int PW = TW + 2;                      // input pixels a ring row
constexpr int CONSUMERS = 2;                    // consumer warpgroups
constexpr int THREADS = 128 * CONSUMERS + 32;   // and one producer warp
constexpr int SMEM_MAX = 232448;                // bytes a block may use

// N: output columns and channels a tap in the GEMM (C rounded up to 8); CP:
// floats between pixels in the ring; VEC: channels a thread loads at once
// (two k-steps' worth at 4); RING: input rows in flight. A half-warp's
// 8-byte loads (4 pixels x 32 bytes) are conflict-free where CP is 8 or 24
// modulo 32, a quarter-warp's 16-byte loads (2 pixels x 64 bytes) where it
// is 16 modulo 32. ops/kernels/conv3x3_f32.PLANS holds N and VEC for the
// weights' layout; the launcher refuses weights packed for another plan.
template <int C> struct Plan;
template <> struct Plan<32> {
  static constexpr int N = 32, CP = 40, VEC = 2, RING = 8;
};
template <> struct Plan<36> {
  static constexpr int N = 40, CP = 40, VEC = 2, RING = 8;
};
template <> struct Plan<48> {
  static constexpr int N = 48, CP = 48, VEC = 4, RING = 5;
};

// shared memory: the weights' high then low part, the ring, then the
// mbarriers (full, empty, weights)
template <int C> struct Layout {
  using P = Plan<C>;
  static constexpr int N = P::N;
  static constexpr int KS = N / 8;                  // k-steps a tap
  static constexpr int STEPS = 9 * KS;
  static constexpr int LOAD_STEPS = P::VEC / 2;     // k-steps a load
  // k-steps whose large products share an accumulator before they join
  // the row's f32 sum in registers: a tap's
  static constexpr int SUM_STEPS = KS;
  static constexpr uint32_t W_PART = 9 * N * N * 4;
  static constexpr uint32_t RING_AT = 2 * W_PART;
  static constexpr uint32_t BOX_BYTES = PW * P::CP * 4;
  // a TMA destination starts on 128 bytes
  static constexpr uint32_t SLOT = (BOX_BYTES + 127) / 128 * 128;
  static constexpr uint32_t BARS = RING_AT + P::RING * SLOT;
  static constexpr uint32_t BYTES = BARS + (2 * P::RING + 1) * 8;
  static_assert(BYTES <= SMEM_MAX, "weights and ring exceed 227 KB");
  static_assert(RING_AT % 128 == 0, "ring alignment");
  static_assert(P::RING >= 4, "two warpgroups hold four input rows");
  static_assert(N % (4 * P::VEC) == 0, "whole loads a tap");
  static_assert(P::CP >= N && P::CP % 4 == 0, "ring row holds N channels");
  static_assert(P::VEC == 4 ? P::CP % 32 == 16
                            : (P::CP % 32 == 8 || P::CP % 32 == 24),
                "conflict-free loads of A");
};

// ------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a (CP, 66, 1) box of x seen as (C, W, H) at coordinates (0, x0, y) ->
// shared memory at dst, completing its bytes on the mbarrier; elements
// outside the tensor arrive as zeros
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int x0, int y) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(x0),
      "r"(y)
      : "memory");
}

// `bytes` of global memory -> shared memory at dst, completing on the
// mbarrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

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

// wgmma shared-memory matrix descriptor, no swizzle: start address, leading
// (K-direction) and stride (N-direction) byte offsets, each >> 4
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

// Pin registers in program order around the asynchronous products, so that
// no read or write of them (or reuse of their registers) moves across a
// wait.
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// f32 -> TF32 bits, rounded to nearest with ties away from zero (as
// cvt.rna.tf32.f32 rounds finite values), and the split x = hi + lo: lo is
// exact in f32, and the tensor cores read its TF32 bits.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d (64 x N, f32) = (scale_d ? d : 0) + A (64 x 8) * B (8 x N), TF32; A
// from registers (thread t of the warpgroup: rows 16 (t / 32) + (t % 32) / 4
// and 8 more, columns t % 4 and 4 more: a0 (r, c), a1 (r + 8, c), a2
// (r, c + 4), a3 (r + 8, c + 4)), B K-major from shared memory by
// descriptor. Thread t holds rows 16 (t / 32) + (t % 32) / 4 (d[4j],
// d[4j + 1]) and 8 more (d[4j + 2], d[4j + 3]) of d, columns
// 8j + 2 (t % 4) + {0, 1}.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<40>(float (&d)[20],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// ------------------------------------------------------------------ kernel

// One load of A: the thread's two pixels (rows m and m + 8 of the GEMM) of
// input row `row` (a ring slot), shifted by the tap's dx, VEC channels each
// from channel 4 VEC q + VEC (t % 4). Load `u` covers k-steps
// LOAD_STEPS u .. LOAD_STEPS u + LOAD_STEPS - 1 of the row's K.
template <int C>
struct Loaded {
  float v[2][Plan<C>::VEC];
};

template <int C>
__device__ __forceinline__ void load_a(Loaded<C>& out,
                                       const float* const (&rows)[3], int u,
                                       int m, int t4) {
  using P = Plan<C>;
  using L = Layout<C>;
  constexpr int LOADS_A_TAP = L::KS / L::LOAD_STEPS;
  const int tap = u / LOADS_A_TAP, q = u % LOADS_A_TAP;
  const float* p =
      rows[tap / 3] + (m + tap % 3) * P::CP + 4 * P::VEC * q + P::VEC * t4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* pr = p + r * 8 * P::CP;
    if constexpr (P::VEC == 4) {
      const float4 f = *reinterpret_cast<const float4*>(pr);
      out.v[r][0] = f.x;
      out.v[r][1] = f.y;
      out.v[r][2] = f.z;
      out.v[r][3] = f.w;
    } else {
      const float2 f = *reinterpret_cast<const float2*>(pr);
      out.v[r][0] = f.x;
      out.v[r][1] = f.y;
    }
  }
}

// A of k-step `h` of a load (0 .. LOAD_STEPS - 1), split into its TF32
// parts: logical column t % 4 holds channel 2h of the thread's VEC, column
// t % 4 + 4 channel 2h + 1 (the pack orders B's rows so)
template <int C>
__device__ __forceinline__ void split_a(const Loaded<C>& in, int h,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(in.v[0][2 * h], hi[0], lo[0]);
  split_tf32(in.v[1][2 * h], hi[1], lo[1]);
  split_tf32(in.v[0][2 * h + 1], hi[2], lo[2]);
  split_tf32(in.v[1][2 * h + 1], hi[3], lo[3]);
}

// One output row of 64 pixels x N into sum (large products, added to it
// SUM_STEPS k-steps at a time) and small (the hi*lo and lo*hi products),
// all waited for. rows: the three input rows (dy = 0, 1, 2) in the ring;
// wh, wl: the weights' parts in shared memory; m: the thread's first GEMM
// row; t4: t % 4.
template <int C>
__device__ __forceinline__ void row_products(
    float (&sum)[Plan<C>::N / 2], float (&small)[Plan<C>::N / 2],
    const float* const (&rows)[3], uint32_t wh, uint32_t wl, int m, int t4) {
  using L = Layout<C>;
  constexpr int N = L::N;
  constexpr int LS = L::LOAD_STEPS;
  constexpr int G = L::SUM_STEPS;
  const uint64_t bh0 = smem_desc(wh, N * 16, 128);
  const uint64_t bl0 = smem_desc(wl, N * 16, 128);
  float big[2][N / 2];
  uint32_t ah[2][4], al[2][4];
  Loaded<C> ld[2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sum[i] = 0.f;
  load_a<C>(ld[0], rows, 0, m, t4);
  split_a<C>(ld[0], 0, ah[0], al[0]);
  pin(small);
#pragma unroll
  for (int s = 0; s < L::STEPS; ++s) {
    const int b = s & 1;          // A's registers
    const int g = (s / G) & 1;    // the large products' accumulator
    const int u = s / LS;
    // the next load's values, while this k-step's products run
    if (s % LS == 0 && u + 1 < L::STEPS / LS)
      load_a<C>(ld[(u + 1) & 1], rows, u + 1, m, t4);
    // descriptor start addresses count 16-byte units: k-step s's chunks
    // start at (2 s N) 16 bytes
    const uint32_t off = 2 * s * N;
    wgmma_fence();
    wgmma_rs<N>(big[g], ah[b], bh0 + off, s % G != 0);
    wgmma_rs<N>(small, ah[b], bl0 + off, s > 0);
    wgmma_rs<N>(small, al[b], bh0 + off, 1);
    wgmma_commit();
    // k-step s - 1's products are done: its operand registers are free,
    // and where it ended a group, the group's large sums join the row's
    wgmma_wait<1>();
    pin(ah[b ^ 1]);
    pin(al[b ^ 1]);
    if (s > 0 && s % G == 0) {
      pin(big[g ^ 1]);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) sum[i] += big[g ^ 1][i];
    }
    if (s + 1 < L::STEPS)
      split_a<C>(ld[((s + 1) / LS) & 1], (s + 1) % LS, ah[b ^ 1], al[b ^ 1]);
  }
  wgmma_wait<0>();
  constexpr int LAST = ((L::STEPS - 1) / G) & 1;
  pin(big[LAST]);
  pin(small);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sum[i] += big[LAST][i];
}

// y's row gy, pixels x0 .. x0 + 63 inside the image, channels below C:
// sum + small + bias, as float2 stores. m: the thread's first GEMM row.
template <int C>
__device__ __forceinline__ void row_epilogue(
    const float (&sum)[Plan<C>::N / 2], const float (&small)[Plan<C>::N / 2],
    const float (&b)[Plan<C>::N / 4], float* __restrict__ y, int gy, int x0,
    int w, int m, int t4) {
  constexpr int N = Plan<C>::N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int px = x0 + m + 8 * half;
    if (px >= w) continue;
    float* row = y + ((long long)gy * w + px) * C;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col < C) {
        const int e = 4 * j + 2 * half;
        *reinterpret_cast<float2*>(row + col) =
            make_float2((sum[e] + small[e]) + b[2 * j],
                        (sum[e + 1] + small[e + 1]) + b[2 * j + 1]);
      }
    }
  }
}

// The block's run of output rows, [first, end) of the strip-major order
// (row r of strip s is s h + r), cut into segments that stay in one strip.
struct Segment {
  int x0, y0, n;
};
__device__ __forceinline__ Segment segment(int f, int end, int h) {
  const int strip = f / h, y0 = f - strip * h;
  return Segment{strip * TW, y0, min(end - f, h - y0)};
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1) conv3x3_f32_kernel(
    const __grid_constant__ CUtensorMap x_map, const float* __restrict__ wp,
    const float* __restrict__ bias, float* __restrict__ y, int h, int w,
    int rows_per_block, int total_rows) {
  using L = Layout<C>;
  using P = Plan<C>;
  constexpr int N = L::N;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + L::BARS;
  const uint32_t empty = full + 8 * P::RING;
  const uint32_t wbar = empty + 8 * P::RING;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * rows_per_block;
  const int end = min(first + rows_per_block, total_rows);

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::RING; ++s) {
      mbar_init(full + 8 * s, 1);               // the producer thread
      mbar_init(empty + 8 * s, 4 * CONSUMERS);  // the consumer warps
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * CONSUMERS) {
    // the weights, then each segment's input rows y0 - 1 .. y0 + n (u counts
    // the block's input rows; slot u % RING)
    if (lane == 0) {
      mbar_expect(wbar, 2 * L::W_PART);
      for (uint32_t o = 0; o < 2 * L::W_PART; o += 32768)
        bulk_load(base + o, reinterpret_cast<const char*>(wp) + o,
                  min(32768u, 2 * L::W_PART - o), wbar);
      int u = 0;
      for (int f = first; f < end;) {
        const Segment sg = segment(f, end, h);
        for (int j = 0; j < sg.n + 2; ++j, ++u) {
          const int s = u % P::RING;
          mbar_wait(empty + 8 * s, ((u / P::RING) & 1) ^ 1);
          mbar_expect(full + 8 * s, L::BOX_BYTES);
          tma_load_3d(base + L::RING_AT + s * L::SLOT, &x_map, full + 8 * s,
                      sg.x0 - 1, sg.y0 - 1 + j);
        }
        f += sg.n;
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int tid = threadIdx.x & 127;
  const int t4 = tid & 3;
  const int m = 16 * (tid >> 5) + ((tid & 31) >> 2);  // GEMM rows m, m + 8
  float b[N / 4];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    b[2 * j] = col < C ? bias[col] : 0.f;
    b[2 * j + 1] = col + 1 < C ? bias[col + 1] : 0.f;
  }
  const float* ring = reinterpret_cast<const float*>(smem + L::RING_AT);

  // Each warp waits for every input row of the block in order (full) and
  // releases each (empty) in order once its warpgroup is done with it, rows
  // it never reads included: a warp's arrival on a slot then always belongs
  // to the row the slot holds.
  int next_wait = 0, next_release = 0;
  auto acquire = [&](int until) {
    for (; next_wait < until; ++next_wait)
      mbar_wait(full + 8 * (next_wait % P::RING),
                (next_wait / P::RING) & 1);
  };
  auto release = [&](int until) {
    for (; next_release < until; ++next_release) {
      acquire(next_release + 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * (next_release % P::RING));
    }
  };

  mbar_wait(wbar, 0);
  const uint32_t wh = base, wl = base + L::W_PART;
  float sum[N / 2], small[N / 2];
  int q = 0, u0 = 0;   // the block's output rows and input rows so far
  for (int f = first; f < end;) {
    const Segment sg = segment(f, end, h);
    for (int i = (q & 1) == wg ? 0 : 1; i < sg.n; i += 2) {
      acquire(u0 + i + 3);
      const float* const rows[3] = {
          ring + ((u0 + i) % P::RING) * (L::SLOT / 4),
          ring + ((u0 + i + 1) % P::RING) * (L::SLOT / 4),
          ring + ((u0 + i + 2) % P::RING) * (L::SLOT / 4)};
      row_products<C>(sum, small, rows, wh, wl, m, t4);
      // this warpgroup's next row in the segment is i + 2
      release(i + 2 < sg.n ? u0 + i + 2 : u0 + sg.n + 2);
      row_epilogue<C>(sum, small, b, y, sg.y0 + i, sg.x0, w, m, t4);
    }
    release(u0 + sg.n + 2);
    q += sg.n;
    u0 += sg.n + 2;
    f += sg.n;
  }
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
int launch(const void* x, const void* wp, const void* bias, void* y, int h,
           int w, int n, int vec, cudaStream_t stream) {
  using L = Layout<C>;
  using P = Plan<C>;
  if (n != P::N || vec != P::VEC) return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // x (H, W, C) seen as (C, W, H), innermost first; the box's CP channels
  // run past C where CP > C, and TMA fills those with zeros
  CUtensorMap x_map;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)w, (cuuint64_t)h};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 4, (cuuint64_t)w * C * 4};
  const cuuint32_t box[3] = {(cuuint32_t)P::CP, (cuuint32_t)PW, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  if (encode(&x_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
             const_cast<void*>(x), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      conv3x3_f32_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::BYTES);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, conv3x3_f32_kernel<C>, THREADS, L::BYTES)) !=
      cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // the output's 64-pixel rows, strip-major, split evenly over the blocks
  const long long total = (long long)((w + TW - 1) / TW) * h;
  if (total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long resident = (long long)sms * per_sm;
  const long long per_block = (total + resident - 1) / resident;
  const unsigned blocks = (unsigned)((total + per_block - 1) / per_block);
  conv3x3_f32_kernel<C><<<blocks, THREADS, L::BYTES, stream>>>(
      x_map, static_cast<const float*>(wp), static_cast<const float*>(bias),
      static_cast<float*>(y), h, w, (int)per_block, (int)total);
  return (int)cudaGetLastError();
}

}  // namespace

// x (h, w, c), wp (2, 9 n n) (ops/kernels/conv3x3_f32.pack: n is c rounded
// up to 8), bias (c) and y (h, w, c), all f32, contiguous and 16-byte
// aligned; c is 32, 36 or 48 (the packed weights and the ring must fit one
// block's shared memory); n and vec are the plan wp was packed for, and
// must be Plan<c>'s. Returns a cudaError_t value (0 = success).
extern "C" int conv3x3_f32_launch(const void* x, const void* wp,
                                  const void* bias, void* y, int h, int w,
                                  int c, int n, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  switch (c) {
    case 32: return launch<32>(x, wp, bias, y, h, w, n, vec, s);
    case 36: return launch<36>(x, wp, bias, y, h, w, n, vec, s);
    case 48: return launch<48>(x, wp, bias, y, h, w, n, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
