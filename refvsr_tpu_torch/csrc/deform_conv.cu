// K5: modulated deformable convolution (DCNv2), 3x3, stride 1, pad 1,
// dilation 1, f32, for Hopper (sm_90a).
//
//   tap k = 3 ky + kx, group g of input channel i (C / dg channels each):
//   sy = y + ky - 1 + off[p, 18 g + 2 k]
//   sx = x + kx - 1 + off[p, 18 g + 2 k + 1]
//   v[p, k, i] = mask[p, 9 g + k] * bilinear(x[n, :, :, i], sy, sx)
//   out[p, o]  = bias[o] + sum_{k, i} v[p, k, i] * weight[o, i, ky, kx]
//
// mmcv's modulated_deform_conv2d as EDVR's PCD alignment calls it: x
// (N, H, W, C) with each image contiguous (a batch stride is taken, since
// PCD's neighbour features are frame slices of the (N, T, H, W, C)
// pyramid), offsets (N, H, W, 18 dg) in mmcv's interleaved (group, tap,
// {dy, dx}) layout, the mask (N, H, W, 9 dg) already sigmoided, weight
// OIHW (C, C, 3, 3), bias (C), out (N, H, W, C). A tap whose floor(s) lies
// outside [-1, S - 1] on either axis, or whose coordinate is NaN, gives
// exact zero; a corner outside the image reads zero
// (models/edvr.py modulated_deform_conv_plain).
//
// Replaces no TPU kernel: the JAX package computes the DCN plainly
// (refvsr_tpu/models/edvr.py, gathers and one matmul); mmcv's op was the
// reference's one native CUDA op.
//
// What bounds it on the H100: at RefVSR-IR's 20 calls a frame (C 64, dg 8,
// N 2-3 keyframes at 272x480, 136x240 and 68x120) the inputs read once and
// the output written once take 1.61 ms at 3.35 TB/s (bytes); the
// contraction's 289 GFLOP and the sampling's 18 GFLOP would take about 4.6
// ms at the 67 TFLOP/s of f32 FMA on the CUDA cores, and the contraction in
// three TF32 products about 1.8 ms at 495 TFLOP/s. The plain formulation
// writes every sampled tap (N H W 9 C f32, 0.9 GB at level 1 with N = 3) to
// device memory, masks, permutes and reads it back, about ten crossings of
// device memory where the bound counts one.
//
// Design: no sampled value reaches device memory, and the block's memory
// requests go to the corner gathers, the one traffic the function cannot
// coalesce.
// - Persistent grid, one block of 512 threads per SM, walking tiles of
//   8 x 8 output pixels (row-major over N, rows / 8, columns / 8) and all
//   C outputs: the 9 taps of a tile sample one small neighbourhood, so the
//   corner loads of consecutive taps find each other in L1 (tiles of 64
//   pixels of one row took 21% longer at 3x272x480; PERF.md).
// - The block stages the whole weight once, each tap a (C outputs, C
//   inputs) matrix in shared memory (147,456 B at C = 64), read straight
//   from the OIHW tensor.
// - A tile's offsets and mask (a pixel's row of each tensor) are staged in
//   shared memory by cp.async, 16 bytes a copy, once for its 9 taps,
//   instead of each tap reading its scattered (dy, dx) and mask through L1.
// - A step is one (tile, tap). Its column slice, the (64 pixels, C) masked
//   bilinear samples of that tap, lies in shared memory. While the warps
//   contract step s's slice, the corner loads of step s + 1 are in flight
//   in registers; a barrier, then they are combined into the slice and a
//   second barrier ends the step. Steps run across tile boundaries; the
//   next tile's offsets are copied in during its previous tile's last tap.
// - Gather: eight threads per output pixel, each one 4-channel quad of
//   every eighth quad; per quad the thread reads its group's (dy, dx) and
//   mask from shared memory, folds the mask into the four corner weights,
//   loads each corner's quad as one float4 (two threads of a pixel read
//   one 32-byte sector of an 8-channel group) and stores the masked
//   bilinear sum as one float4.
// - Contraction on the tensor cores at f32 accuracy: mma.sync m16n8k8 TF32
//   in three products (each operand split as hi = tf32_rn(a), lo =
//   tf32_rn(a - hi); hi*hi, and lo*hi + hi*lo into accumulators of their
//   own, as K2's f32 path), each warp 16 pixels x C / 4 outputs, both
//   operands' fragments loaded by ldmatrix. The slice and each tap's
//   weight keep the 16-byte chunks of a row swizzled by the row (chunk j
//   of row r at j ^ (r & 7)), so ldmatrix's 8-row reads and the gather's
//   float4 stores each cover the 32 banks.
// - Epilogue: the bias added to the f32 sums, each output written once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TAPS = 9;
constexpr int THREADS = 512;           // 16 warps
constexpr int TH = 8, TW = 8;          // a tile: TH rows x TW pixels
constexpr int TP = TH * TW;            // output pixels a tile (64)
constexpr int MAX_DG = 8;
constexpr int SO = 18 * MAX_DG + 4;    // floats between staged offset rows
constexpr int SM = 9 * MAX_DG + 4;     // floats between staged mask rows

template <int C>
struct Plan {
  static constexpr int PHASES = C / 32;   // quads a gathering thread holds
  static constexpr int NT = C / 32;       // n8 tiles of a warp's outputs
  static constexpr int W_FLOATS = TAPS * C * C;
  static constexpr int STAGE_FLOATS = TP * (SO + SM);
  static constexpr int COL_FLOATS = TP * C;
  static constexpr size_t BYTES =
      (size_t)(W_FLOATS + STAGE_FLOATS + COL_FLOATS) * sizeof(float);
  static_assert(C == 32 || C == 64, "C 32 or 64");
};

struct Geometry {
  int h, w, tiles_x, tiles_img, cg, offc, mc;
  long long xstride;
};

// Tile t of the grid of (n, rows / TH, columns / TW) tiles: its image and
// top-left pixel.
struct Tile {
  int n, y0, x0;
  __device__ __forceinline__ Tile(const Geometry& g, int t) {
    n = t / g.tiles_img;
    const int r = t - n * g.tiles_img;
    const int ty = r / g.tiles_x;
    y0 = ty * TH;
    x0 = (r - ty * g.tiles_x) * TW;
  }
  // flat index of tile pixel px (row px / TW, column px % TW) in N H W,
  // or -1 outside the image
  __device__ __forceinline__ int pixel(const Geometry& g, int px) const {
    const int y = y0 + px / TW, x = x0 + px % TW;
    return (y < g.h && x < g.w) ? (n * g.h + y) * g.w + x : -1;
  }
};

// Element (row r, column c) of a C-wide matrix in shared memory whose
// 16-byte chunks are swizzled by the row: chunk c / 4 of row r is stored
// at chunk (c / 4) ^ (r & 7), so 8 consecutive rows' chunk of one column
// (an ldmatrix read) and a row's 8 consecutive chunks (a quarter-warp's
// float4 stores) each cover all 32 banks.
template <int C>
__device__ __forceinline__ int swz(int r, int c) {
  return r * C + ((((c >> 2) ^ r) & 7) | ((c >> 2) & ~7)) * 4 + (c & 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// f32 -> TF32 bits, rounded to nearest with ties away from zero (as
// cvt.rna.tf32.f32 rounds finite values), and the split a = hi + lo.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(__uint_as_float(x));
  lo = tf32_rna(__uint_as_float(x) - __uint_as_float(hi));
}

__device__ __forceinline__ void ldsm_x4(const float* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(const float* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// c (16 x 8) += a (16 x 8, row) * b (8 x 8, col), TF32 in, f32 accumulate
// (not volatile: the compiler may interleave independent products)
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy the tile's offset and mask rows (one a pixel) into shared memory,
// SO and SM floats apart, asynchronously; pixels outside the image are
// skipped.
__device__ __forceinline__ void stage(float* so, float* sm,
                                      const float* __restrict__ off,
                                      const float* __restrict__ msk,
                                      const Geometry& g, const Tile& t) {
  const int oq = g.offc / 4, mq = g.mc / 4;
  for (int e = threadIdx.x; e < TP * oq; e += THREADS) {
    const int px = e / oq, q = e - px * oq, p = t.pixel(g, px);
    if (p >= 0)
      cp_async16(smem_u32(so + px * SO + 4 * q), off + p * g.offc + 4 * q);
  }
  for (int e = threadIdx.x; e < TP * mq; e += THREADS) {
    const int px = e / mq, q = e - px * mq, p = t.pixel(g, px);
    if (p >= 0)
      cp_async16(smem_u32(sm + px * SM + 4 * q), msk + p * g.mc + 4 * q);
  }
  cp_async_commit();
}

// The corner quads and their weights of one step, in flight.
template <int PH>
struct Flight {
  float4 v[PH][4];
  float wt[PH][4];
};

// Issue the corner loads of step (tile, k) for thread (px, sub): quads
// sub + 8 j, their offsets and mask from the staged rows.
template <int C>
__device__ __forceinline__ void gather_load(
    Flight<Plan<C>::PHASES>& f, const float* __restrict__ x, const float* so,
    const float* sm, const Geometry& g, const Tile& t, int k, int px,
    int sub) {
  const int yy = t.y0 + px / TW, xx = t.x0 + px % TW;
  const bool live = yy < g.h && xx < g.w;
  const int ky = k / 3, kx = k - 3 * (k / 3);
  const float* xn = x + (long long)t.n * g.xstride;
#pragma unroll
  for (int j = 0; j < Plan<C>::PHASES; ++j) {
    const int q = sub + 8 * j;
    const int grp = (4 * q) / g.cg;
    float2 d = make_float2(0.f, 0.f);
    float m = 0.f;
    if (live) {
      d = *reinterpret_cast<const float2*>(so + px * SO + grp * 18 + 2 * k);
      m = sm[px * SM + grp * 9 + k];
    }
    const float sy = (float)(yy + ky - 1) + d.x;
    const float sx = (float)(xx + kx - 1) + d.y;
    const float fy = floorf(sy), fx = floorf(sx);
    // false for NaN coordinates too
    const bool ok = live && fy >= -1.f && fy <= (float)(g.h - 1) &&
                    fx >= -1.f && fx <= (float)(g.w - 1);
    int y0 = 0, x0 = 0;
    float ly = 0.f, lx = 0.f, hy = 0.f, hx = 0.f;
    if (ok) {
      y0 = (int)fy;
      x0 = (int)fx;
      ly = sy - fy;
      lx = sx - fx;
      hy = 1.f - ly;
      hx = 1.f - lx;
    }
    const bool r0 = ok && y0 >= 0, r1 = ok && y0 + 1 < g.h;
    const bool c0 = x0 >= 0, c1 = x0 + 1 < g.w;
    const int ya = max(y0, 0), yb = min(y0 + 1, g.h - 1);
    const int xa = max(x0, 0), xb = min(x0 + 1, g.w - 1);
    const float4* base = reinterpret_cast<const float4*>(xn + 4 * q);
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    f.v[j][0] = (r0 && c0) ? __ldg(base + (ya * g.w + xa) * (C / 4)) : z;
    f.v[j][1] = (r0 && c1) ? __ldg(base + (ya * g.w + xb) * (C / 4)) : z;
    f.v[j][2] = (r1 && c0) ? __ldg(base + (yb * g.w + xa) * (C / 4)) : z;
    f.v[j][3] = (r1 && c1) ? __ldg(base + (yb * g.w + xb) * (C / 4)) : z;
    f.wt[j][0] = ok ? hy * hx * m : 0.f;
    f.wt[j][1] = ok ? hy * lx * m : 0.f;
    f.wt[j][2] = ok ? ly * hx * m : 0.f;
    f.wt[j][3] = ok ? ly * lx * m : 0.f;
  }
}

// Combine the corners and store the thread's quads into the column slice.
template <int C>
__device__ __forceinline__ void gather_store(
    const Flight<Plan<C>::PHASES>& f, float* col, int px, int sub) {
#pragma unroll
  for (int j = 0; j < Plan<C>::PHASES; ++j) {
    const float4* v = f.v[j];
    const float* wt = f.wt[j];
    float4 r;
    r.x = fmaf(v[3].x, wt[3], fmaf(v[2].x, wt[2],
          fmaf(v[1].x, wt[1], v[0].x * wt[0])));
    r.y = fmaf(v[3].y, wt[3], fmaf(v[2].y, wt[2],
          fmaf(v[1].y, wt[1], v[0].y * wt[0])));
    r.z = fmaf(v[3].z, wt[3], fmaf(v[2].z, wt[2],
          fmaf(v[1].z, wt[1], v[0].z * wt[0])));
    r.w = fmaf(v[3].w, wt[3], fmaf(v[2].w, wt[2],
          fmaf(v[1].w, wt[1], v[0].w * wt[0])));
    *reinterpret_cast<float4*>(col + swz<C>(px, 4 * (sub + 8 * j))) = r;
  }
}

// big + small += slice (pixels m0.., all C channels) x wk^T (outputs
// ob.., all C channels), on mma.sync. The fragments come by ldmatrix, each
// 8 x 8 b16 matrix an 8 x 4 block of f32: lane (g4, t4) gets row g4,
// column t4. A's four are pixels m0 and m0 + 8 at channels c0 and c0 + 4;
// B's are outputs ob + 8 j at the same two channel blocks.
template <int C>
__device__ __forceinline__ void contract(const float* col, const float* wk,
                                         int m0, int ob, int lane,
                                         float (&big)[Plan<C>::NT][4],
                                         float (&small)[Plan<C>::NT][4]) {
  const int ar = m0 + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int ac = 4 * (lane >> 4);
  const int br = ob + (lane & 7) + 8 * (lane >> 4);
  const int bc = 4 * ((lane >> 3) & 1);
#pragma unroll
  for (int c0 = 0; c0 < C; c0 += 8) {
    uint32_t a[4], b[4], ah[4], al[4];
    ldsm_x4(col + swz<C>(ar, c0 + ac), a);
    if constexpr (Plan<C>::NT == 2) ldsm_x4(wk + swz<C>(br, c0 + bc), b);
    else ldsm_x2(wk + swz<C>(br, c0 + bc), b);
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
    uint32_t bh[Plan<C>::NT][2], bl[Plan<C>::NT][2];
#pragma unroll
    for (int j = 0; j < Plan<C>::NT; ++j) {
      split_tf32(b[2 * j], bh[j][0], bl[j][0]);
      split_tf32(b[2 * j + 1], bh[j][1], bl[j][1]);
    }
    // the small products in accumulators of their own, as K2's f32 path:
    // added to the large sums they would lose their low bits to the
    // tensor cores' alignment
#pragma unroll
    for (int j = 0; j < Plan<C>::NT; ++j) mma_tf32(small[j], al, bh[j]);
#pragma unroll
    for (int j = 0; j < Plan<C>::NT; ++j) mma_tf32(small[j], ah, bl[j]);
#pragma unroll
    for (int j = 0; j < Plan<C>::NT; ++j) mma_tf32(big[j], ah, bh[j]);
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1) deform_conv_kernel(
    const float* __restrict__ x, const float* __restrict__ off,
    const float* __restrict__ msk, const float* __restrict__ wgt,
    const float* __restrict__ bias, float* __restrict__ out, Geometry g,
    int tiles) {
  using L = Plan<C>;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                 // tap k: (C outputs, C inputs), swizzled
  float* so = ws + L::W_FLOATS;     // the tile's offset rows
  float* sm = so + TP * SO;         // the tile's mask rows
  float* col = sm + TP * SM;        // the step's column slice
  const int tid = threadIdx.x;

  stage(so, sm, off, msk, g, Tile(g, blockIdx.x));
  // the weight, tap-major: 4 consecutive (i, k) of one output a float4
  for (int e = tid; e < L::W_FLOATS / 4; e += THREADS) {
    const int o = e / (9 * C / 4), r4 = e - o * (9 * C / 4);
    const float4 v = __ldg(reinterpret_cast<const float4*>(wgt) + e);
    const float t[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = 4 * r4 + u, i = r / 9, k = r - 9 * (r / 9);
      ws[k * C * C + swz<C>(o, i)] = t[u];
    }
  }

  const int px = tid >> 3, sub = tid & 7;                 // gather
  const int warp = tid >> 5, lane = tid & 31;             // contraction
  const int g4 = lane >> 2, t4 = lane & 3;
  const int m0 = 16 * (warp & 3), ob = (C / 4) * (warp >> 2);
  const int mine = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                   (int)gridDim.x;
  const int steps = mine * TAPS;

  float big[L::NT][4], small[L::NT][4];
#pragma unroll
  for (int j = 0; j < L::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) big[j][e] = small[j][e] = 0.f;

  cp_async_wait_all();
  __syncthreads();
  {
    Flight<L::PHASES> f;
    gather_load<C>(f, x, so, sm, g, Tile(g, blockIdx.x), 0, px, sub);
    gather_store<C>(f, col, px, sub);
  }
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const Tile tile(g, blockIdx.x + (s / TAPS) * gridDim.x);
    const int k = s % TAPS;
    const bool more = s + 1 < steps;
    const bool fresh = more && k == TAPS - 1;   // the next step starts a tile
    const Tile next(g, blockIdx.x + ((s + 1) / TAPS) * gridDim.x);
    Flight<L::PHASES> f;
    if (fresh) stage(so, sm, off, msk, g, next);
    else if (more) gather_load<C>(f, x, so, sm, g, tile, k + 1, px, sub);
    contract<C>(col, ws + k * C * C, m0, ob, lane, big, small);
    if (k == TAPS - 1) {
#pragma unroll
      for (int j = 0; j < L::NT; ++j) {
        const int o = ob + 8 * j + 2 * t4;
        const float2 b = __ldg(reinterpret_cast<const float2*>(bias + o));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = tile.pixel(g, m0 + g4 + 8 * h);
          const int e = 2 * h;
          if (p >= 0)
            *reinterpret_cast<float2*>(out + (long long)p * C + o) =
                make_float2(big[j][e] + small[j][e] + b.x,
                            big[j][e + 1] + small[j][e + 1] + b.y);
          big[j][e] = big[j][e + 1] = small[j][e] = small[j][e + 1] = 0.f;
        }
      }
    }
    __syncthreads();   // the slice is free
    if (fresh) {
      cp_async_wait_all();
      __syncthreads();
      gather_load<C>(f, x, so, sm, g, next, 0, px, sub);
    }
    if (more) gather_store<C>(f, col, px, sub);
    __syncthreads();
  }
}

template <int C>
int launch(const void* x, const void* off, const void* msk, const void* wgt,
           const void* bias, void* out, const Geometry& g, int tiles,
           cudaStream_t stream) {
  using L = Plan<C>;
  cudaError_t e = cudaFuncSetAttribute(
      deform_conv_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::BYTES);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, deform_conv_kernel<C>, THREADS, L::BYTES)) !=
      cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long resident = (long long)sms * per_sm;
  const unsigned blocks =
      (unsigned)(tiles < resident ? tiles : resident);
  deform_conv_kernel<C><<<blocks, THREADS, L::BYTES, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(off),
      static_cast<const float*>(msk), static_cast<const float*>(wgt),
      static_cast<const float*>(bias), static_cast<float*>(out), g, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x (n, h, w, c) f32 with image i at x + i * x_batch_stride, each image
// contiguous; offsets (n, h, w, 18 dg), mask (n, h, w, 9 dg), weight
// (c, c, 3, 3), bias (c) and out (n, h, w, c), f32 and contiguous; every
// pointer 16-byte aligned and x_batch_stride a multiple of 4. c is 32 or
// 64 (the weight, a tile's offsets and mask and the column slice fit one
// block's shared memory), dg is 4 or 8 (its offset and mask rows are whole
// 16-byte copies, and the staged rows hold 8 groups), and each tensor's
// extent fits 31 bits. Returns a cudaError_t value (0 = success).
extern "C" int deform_conv_launch(const void* x, const void* off,
                                  const void* msk, const void* wgt,
                                  const void* bias, void* out, int n, int h,
                                  int w, int c, int dg,
                                  long long x_batch_stride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || h <= 0 || w <= 0 || (dg != 4 && dg != 8) ||
      x_batch_stride % 4 != 0 || x_batch_stride < (long long)h * w * c)
    return (int)cudaErrorInvalidValue;
  const long long pixels = (long long)n * h * w;
  if (pixels * 18 * dg >= (1LL << 31) ||
      (n - 1) * x_batch_stride + (long long)h * w * c >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.h = h;
  g.w = w;
  g.tiles_x = (w + TW - 1) / TW;
  g.tiles_img = g.tiles_x * ((h + TH - 1) / TH);
  const int tiles = n * g.tiles_img;
  g.cg = c / dg;
  g.offc = 18 * dg;
  g.mc = 9 * dg;
  g.xstride = x_batch_stride;
  switch (c) {
    case 32: return launch<32>(x, off, msk, wgt, bias, out, g, tiles, s);
    case 64: return launch<64>(x, off, msk, wgt, bias, out, g, tiles, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
