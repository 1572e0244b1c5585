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
//
// Design: the TPU grid carried the running (max, argmax) across its
// sequential ref-tile dimension in VMEM. Hopper blocks run in no order, so
// that dimension becomes a loop inside the block: a block owns TL = 64 LR
// rows (4 warps x 16), keeps them in shared memory, and walks every ref tile
// of TR = 64 rows in ascending order. Per tile:
//   - bf16 x bf16 -> f32 products on the tensor cores (WMMA 16x16x16: each
//     warp computes its 16 rows x 64 columns, D/16 steps); f32 inputs take a
//     plain FMA loop instead (the test and small-f32 path);
//   - the 64 x 64 f32 tile goes to shared memory; two threads per row scan
//     interleaved halves of it (columns past L_ref are masked out, i.e. -inf),
//     merge with a warp shuffle preferring the lower column on equal values,
//     and update the row's running (max, argmax) held in registers with a
//     strict '>' -- so ties resolve to the lowest index, as torch.max and the
//     TPU kernel do.
// D must be a multiple of 16 (the wrapper raises otherwise; D = 144 is the
// path's width). A simple kernel that is right: wgmma, TMA and a pipelined
// ref-tile ring are later work.
//
// Backward (replaces the custom VJP _pallas_argmax_bwd of the same file):
// conf = <ref[index[l]], lr[l]>, so the cotangent g of conf reaches only the
// picked ref row. One thread per (b, l, j) element, neighbouring threads on
// neighbouring j: d_lr[b,l,j] = g[b,l] * ref[b, index[b,l], j] (f32, rounded
// once to the input type), and g[b,l] * lr[b,l,j] is added with an f32
// atomicAdd into d_ref[b, index[b,l], j] (an f32 buffer the caller zeroes
// and casts): many LR rows may pick the same ref row. Bound by bytes (three
// operations per element); the atomics' order is the only nondeterminism.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

using namespace nvcuda;

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

constexpr int TL = 64;           // LR rows per block
constexpr int TR = 64;           // ref rows per tile
constexpr int THREADS = 128;     // 4 warps; 2 threads per LR row
constexpr int SIM_LD = TR + 4;   // f32 row stride of the similarity tile

template <typename T>
__host__ __device__ constexpr int row_pad() {
  return 16 / (int)sizeof(T);
}

template <typename T>
size_t smem_bytes(int d) {
  const int ld = d + row_pad<T>();
  return (size_t)(TL + TR) * ld * sizeof(T) + (size_t)TL * SIM_LD * 4;
}

// rows [row0, row0 + nrows) of a (L, d) matrix into shared memory with row
// stride ld, zero-filling rows past L; 16-byte vectors (d*sizeof(T) % 16 == 0)
template <typename T>
__device__ void load_rows(T* dst, const T* __restrict__ src, long long row0,
                          int nrows, long long total, int d, int ld) {
  const int vpr = d * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < nrows * vpr; i += THREADS) {
    const int r = i / vpr;
    const int v = i - r * vpr;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < total)
      val = reinterpret_cast<const uint4*>(src + (row0 + r) * d)[v];
    reinterpret_cast<uint4*>(dst + (size_t)r * ld)[v] = val;
  }
}

__device__ void tile_products(const __nv_bfloat16* s_lr,
                              const __nv_bfloat16* s_ref, float* s_sim, int d,
                              int ld) {
  const int warp = threadIdx.x >> 5;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TR / 16];
#pragma unroll
  for (int j = 0; j < TR / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
  for (int k = 0; k < d; k += 16) {
    wmma::load_matrix_sync(a, s_lr + warp * 16 * ld + k, ld);
#pragma unroll
    for (int j = 0; j < TR / 16; ++j) {
      // B(k, n) = ref[n][k]: the ref tile read column-major
      wmma::load_matrix_sync(b, s_ref + j * 16 * ld + k, ld);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < TR / 16; ++j)
    wmma::store_matrix_sync(s_sim + warp * 16 * SIM_LD + j * 16, acc[j],
                            SIM_LD, wmma::mem_row_major);
}

__device__ void tile_products(const float* s_lr, const float* s_ref,
                              float* s_sim, int d, int ld) {
  const int r = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  const float* a = s_lr + r * ld;
  for (int k2 = 0; k2 < TR / 2; ++k2) {
    const int col = 2 * k2 + half;
    const float* b = s_ref + col * ld;
    float s = 0.0f;
    for (int k = 0; k < d; ++k) s = fmaf(a[k], b[k], s);
    s_sim[r * SIM_LD + col] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) argmax_matmul_kernel(
    const T* __restrict__ ref, const T* __restrict__ lr,
    float* __restrict__ conf, int* __restrict__ index, int l_ref, int l_lr,
    int d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = d + row_pad<T>();
  T* s_lr = reinterpret_cast<T*>(smem);
  T* s_ref = s_lr + TL * ld;
  float* s_sim = reinterpret_cast<float*>(s_ref + TR * ld);

  const long long b = blockIdx.y;
  const long long row0 = (long long)blockIdx.x * TL;
  const T* lr_b = lr + b * l_lr * (long long)d;
  const T* ref_b = ref + b * l_ref * (long long)d;
  load_rows(s_lr, lr_b, row0, TL, l_lr, d, ld);

  const int r = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  float best = -INFINITY;
  int best_i = 0;
  for (int j0 = 0; j0 < l_ref; j0 += TR) {
    __syncthreads();  // the previous tile's products and scan are done
    load_rows(s_ref, ref_b, j0, TR, l_ref, d, ld);
    __syncthreads();
    tile_products(s_lr, s_ref, s_sim, d, ld);
    __syncthreads();
    const float* srow = s_sim + r * SIM_LD;
    float v = -INFINITY;
    int vi = 0x7fffffff;
    const int ncol = min(TR, l_ref - j0);
    for (int k2 = 0; k2 < TR / 2; ++k2) {
      const int col = 2 * k2 + half;
      const float s = srow[col];
      if (col < ncol && s > v) {
        v = s;
        vi = j0 + col;
      }
    }
    const float ov = __shfl_xor_sync(0xffffffffu, v, 1);
    const int oi = __shfl_xor_sync(0xffffffffu, vi, 1);
    if (ov > v || (ov == v && oi < vi)) {
      v = ov;
      vi = oi;
    }
    if (v > best) {
      best = v;
      best_i = vi;
    }
  }
  const long long row = row0 + r;
  if (half == 0 && row < l_lr) {
    conf[b * l_lr + row] = best;
    index[b * l_lr + row] = best_i;
  }
}

template <typename T>
int launch(const void* ref, const void* lr, void* conf, void* index, int b,
           int l_ref, int l_lr, int d, cudaStream_t stream) {
  if (d % 16 != 0 || b <= 0 || l_lr <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(d);
  cudaError_t e = cudaFuncSetAttribute(
      argmax_matmul_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((l_lr + TL - 1) / TL), (unsigned)b);
  argmax_matmul_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(ref), static_cast<const T*>(lr),
      static_cast<float*>(conf), static_cast<int*>(index), l_ref, l_lr, d);
  return (int)cudaGetLastError();
}

template <typename T>
__global__ void __launch_bounds__(256) argmax_matmul_backward_kernel(
    const T* __restrict__ ref, const T* __restrict__ lr,
    const int* __restrict__ index, const float* __restrict__ g,
    float* __restrict__ d_ref, T* __restrict__ d_lr, int l_ref, int l_lr,
    int d, long long total) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long row = e / d;             // b * l_lr + l
    const int j = (int)(e - row * d);
    const long long b = row / l_lr;
    const long long src = (b * l_ref + index[row]) * d + j;
    const float gv = g[row];
    d_lr[e] = from_f32<T>(gv * to_f32(ref[src]));
    atomicAdd(d_ref + src, gv * to_f32(lr[e]));
  }
}

template <typename T>
int launch_backward(const void* ref, const void* lr, const void* index,
                    const void* g, void* d_ref, void* d_lr, int b, int l_ref,
                    int l_lr, int d, cudaStream_t stream) {
  if (b <= 0 || l_lr <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)b * l_lr * d;
  const long long want = (total + 255) / 256;
  const unsigned blocks = (unsigned)(want < (1LL << 20) ? want : (1LL << 20));
  argmax_matmul_backward_kernel<T><<<blocks, 256, 0, stream>>>(
      static_cast<const T*>(ref), static_cast<const T*>(lr),
      static_cast<const int*>(index), static_cast<const float*>(g),
      static_cast<float*>(d_ref), static_cast<T*>(d_lr), l_ref, l_lr, d,
      total);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. ref (b, l_ref, d), lr (b, l_lr, d)
// contiguous; conf (b, l_lr) f32 and index (b, l_lr) int32 are written.
// Returns a cudaError_t value (0 = success).
extern "C" int argmax_matmul_launch(const void* ref, const void* lr,
                                    void* conf, void* index, int b, int l_ref,
                                    int l_lr, int d, int dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(ref, lr, conf, index, b, l_ref, l_lr, d, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(ref, lr, conf, index, b, l_ref, l_lr, d, s);
  return (int)cudaErrorInvalidValue;
}

// Backward of argmax_matmul_launch. ref (b, l_ref, d), lr (b, l_lr, d) and
// d_lr (b, l_lr, d) share one dtype (codes as above); index (b, l_lr) int32
// and g (b, l_lr) f32 are the forward's index and conf's gradient; d_ref is
// an f32 (b, l_ref, d) buffer that the caller zeroes. Returns a cudaError_t
// value (0 = success).
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
