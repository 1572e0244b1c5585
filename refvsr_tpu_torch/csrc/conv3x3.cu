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
// What bounds it on the H100: bytes. At 1080x1920x48 it reads x once and
// writes y once, 398 MB (0.119 ms at 3.35 TB/s), against 86 GFLOP (0.087 ms
// at 989 TFLOP/s bf16).
//
// Design: the TPU kernel DMAs an (R+2)-row halo stripe into VMEM (a manual
// double buffer, because overlapping windows are not Pallas blocks), pads x
// to 128 lanes in HBM and builds an im2col tensor for one big MXU product.
// Here no padded copy exists: a block stages a (TH+2) x (TW+2) x C halo of x
// in shared memory with 16-byte loads, writing zeros outside the image, and
// keeps the whole wm (41,472 B at C = 48) and the bias in shared memory for
// all the tiles it walks (a grid of as many blocks as fit on the card, each
// looping over tiles, so wm is read from L2 once per block). The product is
// implicit GEMM on the tensor cores, WMMA m16n16k16 bf16 -> f32: M = 16
// consecutive pixels of one row, N = 16 output channels, K = 9C in steps of
// 16 channels of one tap. The A fragment of tap (dy, dx) is read straight
// from the halo with ldm = C (pixel strides of 2C bytes, a multiple of 32
// bytes when C % 16 == 0, as WMMA needs). Each warp owns two M-tiles and all
// C/16 N-tiles, so every B fragment serves two products. The epilogue goes
// through a per-warp f32 staging tile: 16 pixels x C channels of y are
// contiguous in memory, so the warp rounds, adds the bias, rounds again and
// stores them as 16-byte vectors. A simple kernel that is right: wgmma, TMA
// and a cp.async pipeline that overlaps the next halo with the products are
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int TH = 4;                 // output rows per tile
constexpr int TW = 64;                // output columns per tile
constexpr int HALO_W = TW + 2;
constexpr int MT_PER_ROW = TW / 16;   // 16-pixel M-tiles per tile row
constexpr int MT_PER_WARP = 2;
constexpr int WARPS = TH * MT_PER_ROW / MT_PER_WARP;
constexpr int THREADS = 32 * WARPS;

// wm, the halo, the warps' f32 staging tiles and the f32 bias; each part's
// size is a multiple of 128 bytes when c % 16 == 0
size_t smem_bytes(int c) {
  return (size_t)9 * c * c * 2 + (size_t)(TH + 2) * HALO_W * c * 2 +
         (size_t)WARPS * 16 * c * 4 + (size_t)c * 4;
}

template <int NT>
__global__ void __launch_bounds__(THREADS) conv3x3_bias_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wm,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y,
    int h, int w, int tiles_x, int n_tiles) {
  constexpr int C = NT * 16;
  constexpr int VPP = C / 8;  // 16-byte vectors per pixel
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_x = s_w + 9 * C * C;
  float* s_stage = reinterpret_cast<float*>(s_x + (TH + 2) * HALO_W * C);
  float* s_bias = s_stage + WARPS * 16 * C;

  for (int i = threadIdx.x; i < 9 * C * VPP; i += THREADS)
    reinterpret_cast<uint4*>(s_w)[i] = reinterpret_cast<const uint4*>(wm)[i];
  for (int i = threadIdx.x; i < C; i += THREADS)
    s_bias[i] = __bfloat162float(bias[i]);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int mt0 = warp * MT_PER_WARP;
  const int trow = mt0 / MT_PER_ROW;          // the warp's row in the tile
  const int tcol = (mt0 % MT_PER_ROW) * 16;   // its first column in the tile
  float* stage = s_stage + warp * 16 * C;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int y0 = (tile / tiles_x) * TH;
    const int x0 = (tile % tiles_x) * TW;
    __syncthreads();  // wm staged; the previous tile's products are done
    for (int i = threadIdx.x; i < (TH + 2) * HALO_W * VPP; i += THREADS) {
      const int pix = i / VPP;
      const int v = i - pix * VPP;
      const int r = pix / HALO_W;
      const int gy = y0 - 1 + r;
      const int gx = x0 - 1 + (pix - r * HALO_W);
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gy >= 0 && gy < h && gx >= 0 && gx < w)
        val = reinterpret_cast<const uint4*>(
            x + ((long long)gy * w + gx) * C)[v];
      reinterpret_cast<uint4*>(s_x)[i] = val;
    }
    __syncthreads();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT_PER_WARP][NT];
#pragma unroll
    for (int m = 0; m < MT_PER_WARP; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j) wmma::fill_fragment(acc[m][j], 0.0f);
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        a[MT_PER_WARP];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        b;
    for (int t = 0; t < 9; ++t) {
      const int dy = t / 3;
      const int dx = t - 3 * dy;
#pragma unroll
      for (int g = 0; g < NT; ++g) {
#pragma unroll
        for (int m = 0; m < MT_PER_WARP; ++m)
          wmma::load_matrix_sync(
              a[m], s_x + ((trow + dy) * HALO_W + tcol + 16 * m + dx) * C +
                        16 * g, C);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          wmma::load_matrix_sync(b, s_w + (t * C + 16 * g) * C + 16 * j, C);
#pragma unroll
          for (int m = 0; m < MT_PER_WARP; ++m)
            wmma::mma_sync(acc[m][j], a[m], b, acc[m][j]);
        }
      }
    }

    const int gy = y0 + trow;
#pragma unroll
    for (int m = 0; m < MT_PER_WARP; ++m) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
        wmma::store_matrix_sync(stage + 16 * j, acc[m][j], C,
                                wmma::mem_row_major);
      __syncwarp();
      const int gx0 = x0 + tcol + 16 * m;
      for (int i = lane; i < 16 * VPP; i += 32) {
        const int p = i / VPP;
        const int v = i - p * VPP;
        const float* s = stage + p * C + 8 * v;
        const float* bb = s_bias + 8 * v;
        union {
          uint4 u;
          __nv_bfloat162 h2[4];
        } out;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lo = __bfloat162float(__float2bfloat16_rn(s[2 * e]));
          const float hi = __bfloat162float(__float2bfloat16_rn(s[2 * e + 1]));
          // the sum of two bf16 values is exact in f32 (or rounds where
          // one is below 2^-16 of the other), so this rounds once
          out.h2[e] = __floats2bfloat162_rn(lo + bb[2 * e], hi + bb[2 * e + 1]);
        }
        if (gy < h && gx0 + p < w)
          reinterpret_cast<uint4*>(y + ((long long)gy * w + gx0 + p) * C)[v] =
              out.u;
      }
      __syncwarp();
    }
  }
}

template <int NT>
int launch(const void* x, const void* wm, const void* bias, void* y, int h,
           int w, cudaStream_t stream) {
  const size_t smem = smem_bytes(NT * 16);
  cudaError_t e = cudaFuncSetAttribute(
      conv3x3_bias_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, conv3x3_bias_kernel<NT>, THREADS, smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles_x = (w + TW - 1) / TW;
  const long long tiles = tiles_x * ((h + TH - 1) / TH);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long resident = (long long)sms * per_sm;
  const unsigned blocks = (unsigned)(tiles < resident ? tiles : resident);
  conv3x3_bias_kernel<NT><<<blocks, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wm),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(y), h, w, (int)tiles_x, (int)tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x (h, w, c), wm (9c, c), bias (c) and y (h, w, c), all bf16, contiguous
// and 16-byte aligned; c is 16, 32, 48, 64 or 80 (the weights and a halo
// must fit one block's shared memory). Returns a cudaError_t value
// (0 = success).
extern "C" int conv3x3_bias_launch(const void* x, const void* wm,
                                   const void* bias, void* y, int h, int w,
                                   int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  switch (c) {
    case 16: return launch<1>(x, wm, bias, y, h, w, s);
    case 32: return launch<2>(x, wm, bias, y, h, w, s);
    case 48: return launch<3>(x, wm, bias, y, h, w, s);
    case 64: return launch<4>(x, wm, bias, y, h, w, s);
    case 80: return launch<5>(x, wm, bias, y, h, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
