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
// the flow's gradient is asked for, x in and dflow out). What holds it back
// is the scatter into dx: four corner reductions per element of g, which
// the L2 applies at 2.4-3.1 TB/s of f32 data even when each warp's
// reductions cover whole lines (measured on the H100, PERF.md), so every
// reduction not issued is time saved.
//
// Design: the TPU kernel's band plan, 8-aligned anchors, pre-rotate and
// fallback exist because TPU row gathers are bound by row count; none of
// that carries over. pixel_corners evaluates warp_coords for one output
// pixel in f32 (same expression and order as the Python warp_coords, with
// the round-to-nearest intrinsics so nvcc does not contract it into FMAs),
// decides liveness BEFORE any float->int conversion (a NaN anchor fails
// every comparison and is dead), and returns the anchor, the mask of inside
// corners and their f32 weights (0 for a corner outside the image);
// pixel_taps turns them into element offsets for the forward. Forward and
// backward share it, so the backward pass sees exactly the forward's
// corners and weights.
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
// output type.
//
// Backward: fewer reductions by summing in registers first. A thread takes
// a run of RUN = 8 output pixels of one row for one 16-byte channel group
// (block (lanes, runs): `lanes` is the power of two >= C / VEC, at most 32,
// lane j taking the groups j, j + lanes, ...; no index is divided). It
// computes each pixel's taps (pixel_corners, as the forward: the same
// corners and weights), loads 16 bytes of g where C and the pointers allow,
// and adds weight * g into a 2 x 2 window of source pixels held in
// registers: the same anchor as the last pixel adds all four corners there,
// an anchor one column to the right reduces the window's left column into
// dx and shifts, any other anchor reduces the whole window and restarts it
// there. Along a row of smooth flow that is about two reductions a pixel
// instead of four at one resolution, fewer on the 2x grid (neighbouring
// output pixels often share an anchor); scattered flows fall back to four.
// A reduction is one float4 atomicAdd per 4 channels (compute capability
// 9.x) into an f32 dx whose pitch is a multiple of 4 floats (the wrapper
// pads C = 49 to 52; one f32 atomicAdd per channel ran 3.2-3.9x slower,
// bench/probe_backward.py); the launcher clears dx with cudaMemsetAsync.
// dflow: each lane sums g * d(value)/d(tx, ty) over its channels, a run's
// lanes (one warp) add them with xor shuffles in a fixed tree, and lane 0
// writes each pixel's dflow once, scaled by d(sx)/d(fx) = 0.5 * w *
// 2/(w-1) (and the same for y) in the order autograd applies the chain
// rule: no memory word is shared by a pixel's threads. Tried and dropped
// (PERF.md): a shared-memory box of each 16 x 16-pixel tile's source
// footprint, accumulated with shared-memory atomics, which ran slower than
// the float4 reductions alone (Hopper has no native f32 add for shared
// memory). Offsets are 32-bit when every index fits, else 64-bit, as in the
// forward: a 64-bit build at every size ran 1-5% slower at the training
// step's shapes (bench/probe_backward.py). The clear of dx is a pass over
// all of it, part of this function's work. Dead points and all-outside
// corners give exact zeros in both directions.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int RUN = 8;  // backward: output pixels of a row per thread

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

// Anchor (xi, yi) of output pixel p = (b, oy, ox), its corner weights (0
// for a corner outside the image), the mask of its inside corners (bit k for
// corner k: (yi, xi), (yi, xi + 1), (yi + 1, xi), (yi + 1, xi + 1)) and its
// fractional coordinates; returns whether the point is live.
template <typename T, typename Idx>
__device__ __forceinline__ bool pixel_corners(const T* __restrict__ flow,
                                              Idx p, int oy, int ox,
                                              const Geometry& g, int* xi_out,
                                              int* yi_out, float wt[4],
                                              unsigned* inside,
                                              float* tx_out, float* ty_out) {
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
  for (int k = 0; k < 4; ++k) wt[k] = 0.0f;
  *inside = 0u;
  *xi_out = 0;
  *yi_out = 0;
  *tx_out = 0.0f;
  *ty_out = 0.0f;
  if (!live) return false;
  const float tx = sx - x0;
  const float ty = sy - y0;
  const int xi = (int)x0;
  const int yi = (int)y0;
  const float cw[4] = {(1.0f - ty) * (1.0f - tx), (1.0f - ty) * tx,
                       ty * (1.0f - tx), ty * tx};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int cy = yi + (k >> 1);
    const int cx = xi + (k & 1);
    if (cy >= 0 && cy < g.h && cx >= 0 && cx < g.w) {
      *inside |= 1u << k;
      wt[k] = cw[k];
    }
  }
  *xi_out = xi;
  *yi_out = yi;
  *tx_out = tx;
  *ty_out = ty;
  return true;
}

// The same as element offsets of the corners' channel 0 (-1 outside the
// image), for the forward kernel.
template <typename T, typename Idx>
__device__ __forceinline__ bool pixel_taps(const T* __restrict__ flow, Idx p,
                                           int b, int oy, int ox,
                                           const Geometry& g, Idx off[4],
                                           float wt[4], float* tx_out,
                                           float* ty_out) {
  int xi, yi;
  unsigned inside;
  const bool live = pixel_corners<T, Idx>(flow, p, oy, ox, g, &xi, &yi, wt,
                                          &inside, tx_out, ty_out);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    off[k] = (inside >> k) & 1u
                 ? (((Idx)b * g.h + yi + (k >> 1)) * g.w + xi + (k & 1)) * g.c
                 : (Idx)-1;
  return live;
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

// The channels [ch, ch + VEC) of one pixel's row `src` as f32, zeros past C:
// one 16-byte load when kVec (C a multiple of VEC, the row 16-byte aligned).
template <typename T, bool kVec>
__device__ __forceinline__ void load_group(const T* __restrict__ src, int ch,
                                           int c, float (&v)[16 / sizeof(T)]) {
  constexpr int VEC = 16 / sizeof(T);
  if (kVec) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = ch + i < c ? to_f32(src[i]) : 0.0f;
  }
}

// dst[i] += v[i] for the group's channels, one float4 reduction per 4 of
// them: dx's pitch is a multiple of 4 floats, so a float4 that starts below
// C lies inside the pixel's row (v is zero past C).
template <int VEC>
__device__ __forceinline__ void reduce_group(float* dst, const float (&v)[VEC],
                                             int ch, int c) {
#pragma unroll
  for (int q = 0; q < VEC; q += 4)
    if (ch + q < c)
      atomicAdd(reinterpret_cast<float4*>(dst + q),
                make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]));
}

// A 2 x 2 window of source pixels, rows (ya, ya + 1) x columns (xa, xa + 1),
// held in registers for one channel group: slot s is row s >> 1, column
// s & 1, as corner k of a pixel anchored at (xa, ya) is. `used` marks the
// slots that received an inside corner; only they are ever reduced into dx.
template <int VEC>
struct Window {
  float acc[4][VEC];
  unsigned used;
  int xa, ya;

  __device__ __forceinline__ void clear(int s) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[s][i] = 0.0f;
  }
  template <typename Idx>
  __device__ __forceinline__ void flush(int s, float* dx, Idx row0, int w,
                                        int ldx, int ch, int c) {
    if ((used >> s) & 1u)
      reduce_group<VEC>(
          dx + ((row0 + ya + (s >> 1)) * w + xa + (s & 1)) * ldx + ch,
          acc[s], ch, c);
    clear(s);
  }
};

// Backward: dx (f32, pitch ldx floats per source pixel, cleared by the
// launcher; null to skip) += the scatter of g; dflow, when not null, gets
// the flow's gradient (x is read only then). Block (lanes, runs): lane
// threadIdx.x takes the channel groups lane, lane + lanes, ... of a run of
// RUN output pixels of row blockIdx.y, batch item blockIdx.z; see the head
// note.
template <typename T, typename Idx, bool kVec, bool kDflow>
__global__ void __launch_bounds__(THREADS) warp_sample_backward_kernel(
    const T* __restrict__ x, const T* __restrict__ flow,
    const T* __restrict__ g, float* __restrict__ dx, T* __restrict__ dflow,
    Geometry geo, int ldx) {
  constexpr int VEC = 16 / sizeof(T);
  const int lanes = blockDim.x;
  const int lane = threadIdx.x;
  const int ox0 = (blockIdx.x * blockDim.y + threadIdx.y) * RUN;
  const int oy = blockIdx.y;
  const int b = blockIdx.z;
  const Idx p0 = ((Idx)b * geo.ho + oy) * geo.wo + ox0;
  const Idx row0 = (Idx)b * geo.h;  // source row of batch item b
  const int groups = (geo.c + VEC - 1) / VEC;
  float d0[RUN], d1[RUN];  // this lane's part of g * d(value)/d(tx, ty)
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
    d0[i] = 0.0f;
    d1[i] = 0.0f;
  }
  for (int grp = lane; grp < groups && ox0 < geo.wo; grp += lanes) {
    const int ch = grp * VEC;
    Window<VEC> win;
    win.used = 0u;
    win.xa = 0;
    win.ya = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) win.clear(s);
#pragma unroll
    for (int i = 0; i < RUN; ++i) {
      const int ox = ox0 + i;
      int xi, yi;
      float wt[4], tx, ty;
      unsigned inside;
      if (ox >= geo.wo ||
          !pixel_corners<T, Idx>(flow, p0 + i, oy, ox, geo, &xi, &yi, wt,
                                 &inside, &tx, &ty))
        continue;
      float gv[VEC];
      load_group<T, kVec>(g + (p0 + i) * geo.c + ch, ch, geo.c, gv);
      if (dx != nullptr) {
        if (win.used && yi == win.ya && xi == win.xa + 1) {
          // one column to the right: reduce the left column, shift
          win.flush(0, dx, row0, geo.w, ldx, ch, geo.c);
          win.flush(2, dx, row0, geo.w, ldx, ch, geo.c);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            win.acc[0][e] = win.acc[1][e];
            win.acc[2][e] = win.acc[3][e];
          }
          win.clear(1);
          win.clear(3);
          win.used = (win.used >> 1) & 5u;
          win.xa = xi;
        } else if (!win.used || yi != win.ya || xi != win.xa) {
          // elsewhere: reduce the whole window, start it at this anchor
#pragma unroll
          for (int s = 0; s < 4; ++s)
            win.flush(s, dx, row0, geo.w, ldx, ch, geo.c);
          win.used = 0u;
          win.xa = xi;
          win.ya = yi;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            win.acc[k][e] = fmaf(wt[k], gv[e], win.acc[k][e]);
        win.used |= inside;
      }
      if (kDflow) {
        float v[4][VEC];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if ((inside >> k) & 1u) {
            load_group<T, kVec>(
                x + (row0 + yi + (k >> 1)) * geo.w * geo.c +
                    (Idx)(xi + (k & 1)) * geo.c + ch,
                ch, geo.c, v[k]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) v[k][e] = 0.0f;
          }
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          d0[i] += gv[e] * ((1.0f - ty) * (v[1][e] - v[0][e]) +
                            ty * (v[3][e] - v[2][e]));
          d1[i] += gv[e] * ((1.0f - tx) * (v[2][e] - v[0][e]) +
                            tx * (v[3][e] - v[1][e]));
        }
      }
    }
    if (dx != nullptr) {
#pragma unroll
      for (int s = 0; s < 4; ++s)
        win.flush(s, dx, row0, geo.w, ldx, ch, geo.c);
    }
  }
  if (!kDflow) return;
  // each pixel's lanes summed in a fixed tree (every lane of the warp takes
  // part); lane 0 writes the pixel's dflow once
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
    for (int s = lanes >> 1; s > 0; s >>= 1) {
      d0[i] += __shfl_xor_sync(0xffffffffu, d0[i], s);
      d1[i] += __shfl_xor_sync(0xffffffffu, d1[i], s);
    }
  }
  if (lane != 0) return;
  // a dead point was skipped above, so its sums are exact zeros
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
    if (ox0 + i >= geo.wo) break;
    // d(sx)/d(fx) applied as autograd does: ((d * 0.5) * w) * fsx
    dflow[2 * (p0 + i)] = from_f32<T>(__fmul_rn(
        __fmul_rn(__fmul_rn(d0[i], 0.5f), (float)geo.w), geo.fsx));
    dflow[2 * (p0 + i) + 1] = from_f32<T>(__fmul_rn(
        __fmul_rn(__fmul_rn(d1[i], 0.5f), (float)geo.h), geo.fsy));
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

template <typename T, typename Idx, bool kVec, bool kDflow>
void launch_backward_as(const T* x, const T* flow, const T* g, float* dx,
                        T* dflow, const Geometry& geo, int n, int ldx,
                        dim3 block, cudaStream_t stream) {
  const unsigned px = block.y * RUN;  // output pixels of a row per block
  const dim3 grid((unsigned)((geo.wo + px - 1) / px), (unsigned)geo.ho,
                  (unsigned)n);
  warp_sample_backward_kernel<T, Idx, kVec, kDflow>
      <<<grid, block, 0, stream>>>(x, flow, g, dx, dflow, geo, ldx);
}

template <typename T, typename Idx>
void launch_backward_idx(const T* x, const T* flow, const T* g, float* dx,
                         T* dflow, const Geometry& geo, int n, int ldx,
                         dim3 block, bool vec, cudaStream_t s) {
  if (vec && dflow != nullptr)
    launch_backward_as<T, Idx, true, true>(x, flow, g, dx, dflow, geo, n,
                                           ldx, block, s);
  else if (vec)
    launch_backward_as<T, Idx, true, false>(x, flow, g, dx, dflow, geo, n,
                                            ldx, block, s);
  else if (dflow != nullptr)
    launch_backward_as<T, Idx, false, true>(x, flow, g, dx, dflow, geo, n,
                                            ldx, block, s);
  else
    launch_backward_as<T, Idx, false, false>(x, flow, g, dx, dflow, geo, n,
                                             ldx, block, s);
}

template <typename T>
int launch_backward(const void* x, const void* flow, const void* g,
                    void* dx, void* dflow, int n, int h, int w, int c, int ho,
                    int wo, int ldx, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (n <= 0 || n > 65535 || ho <= 0 || ho > 65535 || wo <= 0 || c <= 0 ||
      ldx < c || ldx % 4 != 0 || reinterpret_cast<uintptr_t>(dx) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (dx != nullptr) {
    const cudaError_t e = cudaMemsetAsync(
        dx, 0, (size_t)n * h * w * ldx * sizeof(float), stream);
    if (e != cudaSuccess) return (int)e;
  }
  const Geometry geo = make_geometry(n, h, w, c, ho, wo);
  // lanes per run: the power of two >= the channel groups, at most 32, so
  // that a run's lanes lie in one warp for the dflow shuffles
  const int groups = (c + VEC - 1) / VEC;
  int lanes = 1;
  while (lanes < 32 && lanes < groups) lanes *= 2;
  const dim3 block((unsigned)lanes, (unsigned)(THREADS / lanes));
  const bool vec = c % VEC == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool narrow = (long long)n * h * w * ldx < (1LL << 31) &&
                      geo.npix * (c > 2 ? c : 2) < (1LL << 31);
  const T* xt = static_cast<const T*>(x);
  const T* ft = static_cast<const T*>(flow);
  const T* gt = static_cast<const T*>(g);
  float* dxt = static_cast<float*>(dx);
  T* dft = static_cast<T*>(dflow);
  if (narrow)
    launch_backward_idx<T, int>(xt, ft, gt, dxt, dft, geo, n, ldx, block,
                                vec, stream);
  else
    launch_backward_idx<T, long long>(xt, ft, gt, dxt, dft, geo, n, ldx,
                                      block, vec, stream);
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
// (n, ho, wo, c)) and dflow share one dtype (codes as above). dx is an f32
// (n, h, w, ldx) buffer, 16-byte aligned (ldx >= c floats per source pixel,
// a multiple of 4; channels c.. of a pixel are padding that may receive
// zeros), which this launcher clears on the stream before the kernel; null
// to skip it. dflow may be null to skip
// the flow's gradient; x is read only for dflow and may be null without it.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments it
// does not take.
extern "C" int warp_sample_backward_launch(const void* x, const void* flow,
                                           const void* g, void* dx,
                                           void* dflow, int n, int h, int w,
                                           int c, int ho, int wo, int ldx,
                                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dx == nullptr && dflow == nullptr) ||
      (dflow != nullptr && x == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_backward<float>(x, flow, g, dx, dflow, n, h, w, c, ho, wo,
                                  ldx, s);
  if (dtype == 1)
    return launch_backward<__nv_bfloat16>(x, flow, g, dx, dflow, n, h, w, c,
                                          ho, wo, ldx, s);
  return (int)cudaErrorInvalidValue;
}
