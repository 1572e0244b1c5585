// K1: RefVSR propagation flow warp (bilinear, grid_sample align_corners=False,
// zeros padding) on NHWC features, for Hopper (sm_90a): the forward sampler
// and its backward pass.
//
// Replaces: refvsr_tpu/ops/pallas/warp_select.py, _select_kernel (launched by
// _exec / pallas_banded_sample), which the JAX package reaches from
// refvsr_tpu/ops/warp.py:_bilinear_sample for every zeros-padding warp, and
// that kernel's custom VJP (_bwd: the pullback of the canvas-free sampler
// refvsr_tpu/ops/warp.py:_bilinear_sample_lean).
//
// What bounds it on the H100: bytes. Each output element reads four corner
// values and writes one; at the main-path shapes (x 1x2160x3840x48 bf16 and
// 1x1080x1920x49 bf16) there is one multiply-add per byte, far below the
// card's ~295 operations per byte, so the floor is moving x in, the flow in
// and the output out once over device memory (3.35 TB/s). The backward pass
// is the same gather run as a scatter: g and the flow in, dx out (and, when
// the flow's gradient is asked for, x in and dflow out).
//
// Design: the TPU kernel's band plan, 8-aligned anchors, pre-rotate and
// fallback exist because TPU row gathers are bound by row count; none of
// that carries over. Here a block owns PIX consecutive output pixels:
//   1. one thread per pixel reads its flow, evaluates warp_coords in f32
//      (same expression and order as the Python warp_coords, with the
//      round-to-nearest intrinsics so nvcc does not contract it into FMAs),
//      decides liveness BEFORE any float->int conversion (a NaN anchor fails
//      every comparison and is dead), and stores the four corner offsets and
//      f32 weights in shared memory (-1 for a corner outside the image);
//      forward and backward share this step (pixel_taps), so the backward
//      pass sees exactly the forward's corners and weights;
//   2. all threads then walk the PIX*C output elements with neighbouring
//      threads on neighbouring channels, so each corner access of a pixel is
//      one contiguous run over C in NHWC, and neighbouring pixels' runs are
//      adjacent in memory. Any C works (C = 49 carries the confidence map).
// Forward: the four products are summed in f32 and rounded once to the
// output type. Backward: each element scatters weight * g into its inside
// corners of an f32 dx with atomicAdd (several output points share a source
// pixel, so atomics decide the summation order); for dflow each element adds
// g * d(value)/d(tx, ty) into per-pixel f32 sums in shared memory, and one
// thread per pixel scales them by d(sx)/d(fx) = 0.5 * w * 2/(w-1) (and the
// same for y) in the order autograd applies the chain rule. Dead points and
// all-outside corners give exact zeros in both directions.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int PIX = 64;       // output pixels per block
constexpr int THREADS = 256;

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

struct Geometry {
  int h, w, c, ho, wo;
  long long npix;
  float gsx, fsx, gsy, fsy;  // warp_coords' grid and flow scales
};

// Corner offsets (-1 outside the image) and weights of output pixel p, and
// its fractional coordinates; returns whether the point is live.
template <typename T>
__device__ __forceinline__ bool pixel_taps(const T* __restrict__ flow,
                                           long long p, const Geometry& g,
                                           long long off[4], float wt[4],
                                           float* tx_out, float* ty_out) {
  const long long hw_o = (long long)g.ho * g.wo;
  const long long b = p / hw_o;
  const long long rem = p - b * hw_o;
  const int oy = (int)(rem / g.wo);
  const int ox = (int)(rem - (long long)oy * g.wo);
  const float fx = to_f32(flow[2 * p]);
  const float fy = to_f32(flow[2 * p + 1]);
  // xn = gx * gsx + fx * fsx - 1 ; sx = ((xn + 1) * w - 1) * 0.5
  const float xn = __fadd_rn(__fadd_rn(__fmul_rn((float)ox, g.gsx),
                                       __fmul_rn(fx, g.fsx)), -1.0f);
  const float yn = __fadd_rn(__fadd_rn(__fmul_rn((float)oy, g.gsy),
                                       __fmul_rn(fy, g.fsy)), -1.0f);
  const float sx = __fmul_rn(
      __fadd_rn(__fmul_rn(__fadd_rn(xn, 1.0f), (float)g.w), -1.0f), 0.5f);
  const float sy = __fmul_rn(
      __fadd_rn(__fmul_rn(__fadd_rn(yn, 1.0f), (float)g.h), -1.0f), 0.5f);
  const float x0 = floorf(sx);
  const float y0 = floorf(sy);
  const bool live = (x0 >= -1.0f) && (x0 <= (float)(g.w - 1)) &&
                    (y0 >= -1.0f) && (y0 <= (float)(g.h - 1));
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    off[k] = -1;
    wt[k] = 0.0f;
  }
  *tx_out = 0.0f;
  *ty_out = 0.0f;
  if (!live) return false;
  const float tx = sx - x0;
  const float ty = sy - y0;
  const int xi = (int)x0;
  const int yi = (int)y0;
  const float cw[4] = {(1.0f - ty) * (1.0f - tx), (1.0f - ty) * tx,
                       ty * (1.0f - tx), ty * tx};
  const int cy[4] = {yi, yi, yi + 1, yi + 1};
  const int cx[4] = {xi, xi + 1, xi, xi + 1};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (cy[k] >= 0 && cy[k] < g.h && cx[k] >= 0 && cx[k] < g.w) {
      off[k] = (((long long)b * g.h + cy[k]) * g.w + cx[k]) * g.c;
      wt[k] = cw[k];
    }
  }
  *tx_out = tx;
  *ty_out = ty;
  return true;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) warp_sample_kernel(
    const T* __restrict__ x, const T* __restrict__ flow, T* __restrict__ out,
    Geometry geo) {
  __shared__ long long s_off[PIX][4];
  __shared__ float s_wt[PIX][4];

  const long long p0 = (long long)blockIdx.x * PIX;
  const int t = threadIdx.x;
  if (t < PIX) {
    const long long p = p0 + t;
    long long off[4] = {-1, -1, -1, -1};
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    float tx, ty;
    if (p < geo.npix) pixel_taps(flow, p, geo, off, wt, &tx, &ty);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s_off[t][k] = off[k];
      s_wt[t][k] = wt[k];
    }
  }
  __syncthreads();

  const int c = geo.c;
  const long long remaining = geo.npix - p0;
  const int npx = remaining < PIX ? (int)remaining : PIX;
  const int total = npx * c;
  T* out_blk = out + p0 * c;
  for (int i = t; i < total; i += THREADS) {
    const int q = i / c;
    const int ch = i - q * c;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long o = s_off[q][k];
      if (o >= 0) acc = fmaf(s_wt[q][k], to_f32(x[o + ch]), acc);
    }
    out_blk[i] = from_f32<T>(acc);
  }
}

// dx (f32, zeroed by the caller) += the scatter of g; dflow, when not null,
// gets the flow's gradient (x is read only then).
template <typename T>
__global__ void __launch_bounds__(THREADS) warp_sample_backward_kernel(
    const T* __restrict__ x, const T* __restrict__ flow,
    const T* __restrict__ g, float* __restrict__ dx, T* __restrict__ dflow,
    Geometry geo) {
  __shared__ long long s_off[PIX][4];
  __shared__ float s_wt[PIX][4];
  __shared__ float s_t[PIX][2];     // tx, ty of a live point
  __shared__ float s_d[PIX][2];     // sums of g * d(value)/d(tx), d(ty)
  __shared__ int s_live[PIX];

  const long long p0 = (long long)blockIdx.x * PIX;
  const int t = threadIdx.x;
  if (t < PIX) {
    const long long p = p0 + t;
    long long off[4] = {-1, -1, -1, -1};
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    float tx = 0.f, ty = 0.f;
    bool live = false;
    if (p < geo.npix) live = pixel_taps(flow, p, geo, off, wt, &tx, &ty);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s_off[t][k] = off[k];
      s_wt[t][k] = wt[k];
    }
    s_t[t][0] = tx;
    s_t[t][1] = ty;
    s_d[t][0] = 0.0f;
    s_d[t][1] = 0.0f;
    s_live[t] = live ? 1 : 0;
  }
  __syncthreads();

  const int c = geo.c;
  const long long remaining = geo.npix - p0;
  const int npx = remaining < PIX ? (int)remaining : PIX;
  const int total = npx * c;
  const T* g_blk = g + p0 * c;
  for (int i = t; i < total; i += THREADS) {
    const int q = i / c;
    const int ch = i - q * c;
    if (!s_live[q]) continue;
    const float gv = to_f32(g_blk[i]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long o = s_off[q][k];
      if (o >= 0) atomicAdd(dx + o + ch, s_wt[q][k] * gv);
    }
    if (dflow != nullptr) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long o = s_off[q][k];
        v[k] = o >= 0 ? to_f32(x[o + ch]) : 0.0f;
      }
      const float tx = s_t[q][0];
      const float ty = s_t[q][1];
      atomicAdd(&s_d[q][0],
                gv * ((1.0f - ty) * (v[1] - v[0]) + ty * (v[3] - v[2])));
      atomicAdd(&s_d[q][1],
                gv * ((1.0f - tx) * (v[2] - v[0]) + tx * (v[3] - v[1])));
    }
  }
  if (dflow == nullptr) return;
  __syncthreads();
  if (t < npx) {
    const long long p = p0 + t;
    // d(sx)/d(fx) applied as autograd does: ((d * 0.5) * w) * fsx
    const float dfx = __fmul_rn(
        __fmul_rn(__fmul_rn(s_d[t][0], 0.5f), (float)geo.w), geo.fsx);
    const float dfy = __fmul_rn(
        __fmul_rn(__fmul_rn(s_d[t][1], 0.5f), (float)geo.h), geo.fsy);
    dflow[2 * p] = from_f32<T>(s_live[t] ? dfx : 0.0f);
    dflow[2 * p + 1] = from_f32<T>(s_live[t] ? dfy : 0.0f);
  }
}

Geometry make_geometry(int n, int h, int w, int c, int ho, int wo) {
  Geometry g;
  g.h = h;
  g.w = w;
  g.c = c;
  g.ho = ho;
  g.wo = wo;
  g.npix = (long long)n * ho * wo;
  // scale constants as the Python warp_coords forms them (double, then f32)
  g.gsx = (float)(2.0 / (double)(wo - 1 > 1 ? wo - 1 : 1));
  g.fsx = (float)(2.0 / (double)(w - 1 > 1 ? w - 1 : 1));
  g.gsy = (float)(2.0 / (double)(ho - 1 > 1 ? ho - 1 : 1));
  g.fsy = (float)(2.0 / (double)(h - 1 > 1 ? h - 1 : 1));
  return g;
}

unsigned blocks_for(const Geometry& g) {
  return (unsigned)((g.npix + PIX - 1) / PIX);
}

template <typename T>
int launch(const void* x, const void* flow, void* out, int n, int h, int w,
           int c, int ho, int wo, cudaStream_t stream) {
  const Geometry geo = make_geometry(n, h, w, c, ho, wo);
  warp_sample_kernel<T><<<blocks_for(geo), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(flow),
      static_cast<T*>(out), geo);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_backward(const void* x, const void* flow, const void* g,
                    void* dx, void* dflow, int n, int h, int w, int c, int ho,
                    int wo, cudaStream_t stream) {
  const Geometry geo = make_geometry(n, h, w, c, ho, wo);
  warp_sample_backward_kernel<T><<<blocks_for(geo), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(flow),
      static_cast<const T*>(g), static_cast<float*>(dx),
      static_cast<T*>(dflow), geo);
  return (int)cudaGetLastError();
}

}  // namespace

// x, flow and out share one dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError().
extern "C" int warp_sample_launch(const void* x, const void* flow, void* out,
                                  int n, int h, int w, int c, int ho, int wo,
                                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, flow, out, n, h, w, c, ho, wo, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, flow, out, n, h, w, c, ho, wo, s);
  return (int)cudaErrorInvalidValue;
}

// Backward of warp_sample_launch. x, flow, g (the output's gradient,
// (n, ho, wo, c)) and dflow share one dtype (codes as above); dx is an f32
// (n, h, w, c) buffer that the caller zeroes. dflow may be null to skip the
// flow's gradient; x is read only for dflow and may be null without it.
// Returns cudaGetLastError().
extern "C" int warp_sample_backward_launch(const void* x, const void* flow,
                                           const void* g, void* dx,
                                           void* dflow, int n, int h, int w,
                                           int c, int ho, int wo, int dtype,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dx == nullptr || (dflow != nullptr && x == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_backward<float>(x, flow, g, dx, dflow, n, h, w, c, ho, wo,
                                  s);
  if (dtype == 1)
    return launch_backward<__nv_bfloat16>(x, flow, g, dx, dflow, n, h, w, c,
                                          ho, wo, s);
  return (int)cudaErrorInvalidValue;
}
