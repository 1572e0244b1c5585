// K4: gather P rows of an (R, L) table, for Hopper (sm_90a).
//
//   out[p, :] = tab[clamp(idx[p], 0, R - 1), :]
//
// The kernel moves bytes and does no arithmetic on them, so one source
// serves every element type whose row is a whole number of 16-byte vectors
// (bf16 and f32 at the wrapper).
//
// Replaces: scripts/microbench_pallas_gather.py, the kernels launched by
// make_pallas_gather (_take_kernel, _scalar_kernel, _onehot_kernel): four
// TPU formulations of one gather, a Pallas experiment that the JAX package
// never dispatches. Indices out of range are clamped to [0, R - 1]; the
// script's XLA reference (take_along_axis, mode="clip") does the same at or
// above R, but wraps an index in [-R, 0) to R + index first.
//
// What bounds it on the H100: bytes. At the default size (R 2048, L 128
// bf16, P 2^20) the output is 268 MB, the indices 4 MB and the table 0.5 MB:
// 0.0815 ms at 3.35 TB/s.
//
// Design: the TPU variants exist because Mosaic has no fast in-VMEM gather
// (a one-hot matmul on the MXU, a loop of one-row copies). Hopper gathers
// natively: one thread copies one 16-byte vector of an output row, and
// neighbouring threads take neighbouring vectors of the same or the next
// row, so every store is coalesced. The threads of one row read its index
// from one address (one transaction for the warp) and clamp it. The table,
// 512 KB at the default size, stays in L2. A grid-stride loop covers any P.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) gather_rows_kernel(
    const uint4* __restrict__ tab, const int* __restrict__ idx,
    uint4* __restrict__ out, int rows, int vpr, long long total) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
       e < total; e += stride) {
    const long long p = e / vpr;
    const int v = (int)(e - p * vpr);
    const int r = min(max(__ldg(idx + p), 0), rows - 1);
    out[e] = __ldg(tab + (long long)r * vpr + v);
  }
}

}  // namespace

// tab (rows, row_bytes / elem) and out (points, ...), contiguous, 16-byte
// aligned, row_bytes % 16 == 0; idx (points) int32. Returns a cudaError_t
// value (0 = success).
extern "C" int gather_rows_launch(const void* tab, const void* idx, void* out,
                                  int rows, int row_bytes, long long points,
                                  void* stream) {
  if (rows <= 0 || row_bytes <= 0 || row_bytes % 16 != 0 || points <= 0)
    return (int)cudaErrorInvalidValue;
  const int vpr = row_bytes / 16;
  const long long total = points * vpr;
  const long long want = (total + THREADS - 1) / THREADS;
  const unsigned blocks = (unsigned)(want < (1LL << 20) ? want : (1LL << 20));
  gather_rows_kernel<<<blocks, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(tab), static_cast<const int*>(idx),
      static_cast<uint4*>(out), rows, vpr, total);
  return (int)cudaGetLastError();
}
