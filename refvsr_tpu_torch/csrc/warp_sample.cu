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
// that carries over. pixel_taps evaluates warp_coords for one output pixel
// in f32 (same expression and order as the Python warp_coords, with the
// round-to-nearest intrinsics so nvcc does not contract it into FMAs),
// decides liveness BEFORE any float->int conversion (a NaN anchor fails
// every comparison and is dead), and returns the four corner offsets and
// f32 weights (-1 for a corner outside the image); forward and backward
// share it, so the backward pass sees exactly the forward's corners and
// weights.
// Forward: one thread per (output pixel, group of 16 bytes of channels: 8
// bf16 or 4 f32). The block is (groups, pixels): threadIdx.x is the group,
// threadIdx.y the pixel within a run of one output row, blockIdx.y the row
// and blockIdx.z the batch item, so no index is divided, and consecutive
// threads cover consecutive 16-byte groups of consecutive output pixels:
// the stores are contiguous and the neighbouring pixels' corner reads (they
// share corners, densely so on the 2x grid) meet in L1/L2. Each thread
// computes its pixel's taps itself (about 30 f32 operations, cheaper than a
// shared-memory round trip and a barrier) and, when C is a multiple of the
// group (C % 8 == 0 in bf16, C % 4 == 0 in f32) and x and out are 16-byte
// aligned, does four 16-byte loads, eight (four) f32 sums and one 16-byte
// store. Other C (the generic variant, e.g. C = 5) load and store the
// group's channels one by one. Offsets are 32-bit when every element index
// fits, else 64-bit: a build with 64-bit offsets only ran the UP warp about
// 4% slower on the H100 (PERF.md). The feature warp keeps its packed
// layout (48 features + the confidence map, C = 49; design (a)): its
// 98-byte pixels are aligned to 2 bytes only, so it takes the generic
// variant, whose loads L1 merges across the group's threads. The four
// products are summed in f32 in corner order and rounded once to the
// output type. Backward: each element scatters weight * g into its inside
// corners of an f32 dx with atomicAdd (several output points share a
// source pixel, so atomics decide the summation order); for dflow
// each element adds g * d(value)/d(tx, ty) into per-pixel f32 sums in shared
// memory, and one thread per pixel scales them by d(sx)/d(fx) = 0.5 * w *
// 2/(w-1) (and the same for y) in the order autograd applies the chain rule.
// Dead points and all-outside corners give exact zeros in both directions.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int PIX = 64;       // output pixels per block (backward)
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

// Corner offsets (element index of the corner's channel 0, -1 outside the
// image) and weights of output pixel p = (b, oy, ox), and its fractional
// coordinates; returns whether the point is live.
template <typename T, typename Idx>
__device__ __forceinline__ bool pixel_taps(const T* __restrict__ flow, Idx p,
                                           int b, int oy, int ox,
                                           const Geometry& g, Idx off[4],
                                           float wt[4], float* tx_out,
                                           float* ty_out) {
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
      off[k] = (((Idx)b * g.h + cy[k]) * g.w + cx[k]) * g.c;
      wt[k] = cw[k];
    }
  }
  *tx_out = tx;
  *ty_out = ty;
  return true;
}

// One thread per (output pixel, 16-byte channel group); see the head note.
// kVec: C is a multiple of the group and x, out are 16-byte aligned.
template <typename T, typename Idx, bool kVec>
__global__ void __launch_bounds__(THREADS) warp_sample_kernel(
    const T* __restrict__ x, const T* __restrict__ flow, T* __restrict__ out,
    Geometry geo) {
  constexpr int VEC = 16 / sizeof(T);
  const int ox = blockIdx.x * blockDim.y + threadIdx.y;
  if (ox >= geo.wo) return;
  const int oy = blockIdx.y;
  const int b = blockIdx.z;
  const Idx p = ((Idx)b * geo.ho + oy) * geo.wo + ox;
  Idx off[4];
  float wt[4], tx, ty;
  pixel_taps<T, Idx>(flow, p, b, oy, ox, geo, off, wt, &tx, &ty);

  const int ch = threadIdx.x * VEC;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (off[k] < 0) continue;
    const T* src = x + off[k] + ch;
    if (kVec) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc[i] = fmaf(wt[k], to_f32(v[i]), acc[i]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        if (ch + i < geo.c) acc[i] = fmaf(wt[k], to_f32(src[i]), acc[i]);
    }
  }
  T* dst = out + p * geo.c + ch;
  if (kVec) {
    uint4 raw;
    T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = from_f32<T>(acc[i]);
    *reinterpret_cast<uint4*>(dst) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      if (ch + i < geo.c) dst[i] = from_f32<T>(acc[i]);
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
    if (p < geo.npix) {
      const long long hw_o = (long long)geo.ho * geo.wo;
      const long long b = p / hw_o;
      const long long rem = p - b * hw_o;
      const int oy = (int)(rem / geo.wo);
      const int ox = (int)(rem - (long long)oy * geo.wo);
      live = pixel_taps<T, long long>(flow, p, (int)b, oy, ox, geo, off, wt,
                                      &tx, &ty);
    }
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

template <typename T, typename Idx, bool kVec>
void launch_forward(const T* x, const T* flow, T* out, const Geometry& geo,
                    int n, dim3 block, cudaStream_t stream) {
  const dim3 grid((unsigned)((geo.wo + block.y - 1) / block.y),
                  (unsigned)geo.ho, (unsigned)n);
  warp_sample_kernel<T, Idx, kVec><<<grid, block, 0, stream>>>(x, flow, out,
                                                                geo);
}

template <typename T>
int launch(const void* x, const void* flow, void* out, int n, int h, int w,
           int c, int ho, int wo, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int groups = (c + VEC - 1) / VEC;
  if (n <= 0 || n > 65535 || ho <= 0 || ho > 65535 || wo <= 0 || c <= 0 ||
      groups > THREADS)
    return (int)cudaErrorInvalidValue;
  const Geometry geo = make_geometry(n, h, w, c, ho, wo);
  const dim3 block((unsigned)groups, (unsigned)(THREADS / groups));
  const bool vec = c % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const bool narrow = (long long)n * h * w * c < (1LL << 31) &&
                      geo.npix * (c > 2 ? c : 2) < (1LL << 31);
  const T* xt = static_cast<const T*>(x);
  const T* ft = static_cast<const T*>(flow);
  T* ot = static_cast<T*>(out);
  if (vec && narrow)
    launch_forward<T, int, true>(xt, ft, ot, geo, n, block, stream);
  else if (vec)
    launch_forward<T, long long, true>(xt, ft, ot, geo, n, block, stream);
  else if (narrow)
    launch_forward<T, int, false>(xt, ft, ot, geo, n, block, stream);
  else
    launch_forward<T, long long, false>(xt, ft, ot, geo, n, block, stream);
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

// x, flow and out share one dtype: 0 = float32, 1 = bfloat16. C up to 2048
// (bf16) or 1024 (f32), n and ho up to 65535. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for a shape it does not take.
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
