"""Probe variants of K3 (``csrc/conv3x3.cu``) on the card: what holds the
3x3 conv + bias kernel back, and which tile plan it keeps.

    python -m refvsr_tpu_torch.bench.probe_conv

Builds, beside the shipped kernel, variants of ``csrc/conv3x3.cu`` made by
text substitution (none is kept in the source; a substitution that no
longer finds its text stops the probe, which then needs updating):

- ``16-byte boxes, unswizzled``: the halo as one box per 8-channel group,
  unswizzled slabs of 16-byte pixel rows read by plain descriptors (twice
  the box rows of the shipped 32-byte swizzle); and the shipped swizzle
  with the descriptor's base offset taken from the start address (which
  gives wrong results: the swizzle follows the absolute address);
- made from the unswizzled variant: option (a), ``register A``, A fed from
  registers by ldmatrix, from a halo of whole pixels at a pitch of C + 8
  channels (one TMA box a tile), each halo row's fragments serving the
  three output rows it touches, with ``two sets`` of A registers (the
  next halo row loads while the products run; ptxas serialises the wgmmas
  where the registers run out) or ``one set`` (loaded once the products
  are done), against option (b), both operands by descriptor; and the
  halo ring filled by 16-byte ``cp.async`` copies from 8 or 4 producer
  warps (zero-filled outside the image, an mbarrier arrival per thread
  when its copies land) in place of its TMA boxes;
- the boxes with 256-byte L2 promotion;
- tile plans at C = 48: ``TH 6, 3 stages`` and ``TH 4, 3 stages``
  against the shipped 8-row tiles in a 2-stage ring;
- ``one consumer warpgroup``: all rows of a tile on one warpgroup;
- what each part costs, by leaving it out (the results are wrong):
  ``no products`` (no wgmma: the halo copies, wm and the epilogue),
  ``no halo copies`` (the ring's barriers without its copies: products and
  epilogue), ``products only`` (neither copies nor epilogue; the
  accumulators kept live, since ptxas drops a wgmma whose results are never
  read), ``no stores`` (no bulk store of y), and ``no products, 96-byte
  boxes`` (the halo as one box of whole pixels, the same bytes in 96-byte
  box rows: what the box rows of the channel-group boxes cost the memory
  path);
- ``one staging row`` a warpgroup for the epilogue's stores, against two;

and times each at 1080x1920x48 bf16, the microbenchmark's inputs, by its
device time (one torch.profiler pass of 20 launches, by kernel name), in two
rounds that each run every variant once. The shipped kernel, the
unswizzled one and option (a) are also timed at every C the kernel takes,
each held against the plain version. Prints one JSON line. Needs the
card."""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from refvsr_tpu_torch.bench import bound_ms, device_kernels
from refvsr_tpu_torch.bench.microbench_conv import envelope_ratio, make_inputs
from refvsr_tpu_torch.ops.kernels import build
from refvsr_tpu_torch.ops.kernels import conv3x3 as k3

SIZE = (1080, 1920)
# timed at every C the kernel takes
BY_C = ("shipped", "16-byte boxes, unswizzled", "register A, two sets",
        "register A, one set")
_PLAN48 = ("template <> struct Plan<48> { static constexpr int TH = 8, "
           "STAGES = 2; };")
_PRODUCER = ("  if (warp >= 4 * CONSUMERS) {\n",
             "    return;\n  }\n")
# the halo by 16-byte cp.async copies from every producer thread, zero-
# filled outside the image, into the same buffers; an mbarrier arrival
# per thread when its copies land
_CP_ASYNC = r"""  if (warp >= 4 * CONSUMERS) {
    const int pt = threadIdx.x - 128 * CONSUMERS;
    for (int i = 0; i < n_mine; ++i) {
      const int tile = blockIdx.x + i * gridDim.x;
      const int s = i % L::STAGES;
      mbar_wait(empty + 8 * s, ((i / L::STAGES) & 1) ^ 1);
      const int y0 = (tile / tiles_x) * L::TH - 1;
      const int x0 = (tile % tiles_x) * TW - 1;
      const uint32_t dst = base + L::HALO + s * L::STAGE_BYTES;
      for (int r = 0; r < L::ROWS; ++r) {
        const int gy = y0 + r;
        const bool row_in = gy >= 0 && gy < h;
        const __nv_bfloat16* src =
            x + ((long long)(row_in ? gy : 0) * w + x0) * C;
        for (int j = pt; j < PW * G; j += 32 * PRODUCERS) {
          const int p = j / G;
          const int g = j - p * G;
          const bool valid = row_in && x0 + p >= 0 && x0 + p < w;
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                       ::"r"(dst + g * L::SLAB + (uint32_t)(r * PW + p) * 16),
                       "l"(valid ? src + 8 * j : x), "r"(valid ? 16 : 0)
                       : "memory");
        }
      }
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                   ::"r"(full + 8 * s) : "memory");
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }
"""


def _cp_async(warps):
    """Edits that replace the TMA producer with `warps` cp.async warps."""
    return [("constexpr int THREADS = 128 * CONSUMERS + 32;",
             f"constexpr int PRODUCERS = {warps};\n"
             "constexpr int THREADS = 128 * CONSUMERS + 32 * PRODUCERS;"),
            ("      mbar_init(full + 8 * s, 1);",
             "      mbar_init(full + 8 * s, 32 * PRODUCERS);"),
            (_PRODUCER, _CP_ASYNC),
            # the kernel reads x itself
            ("    const __grid_constant__ CUtensorMap x_map,\n",
             "    const __grid_constant__ CUtensorMap x_map,\n"
             "    const __nv_bfloat16* __restrict__ x,\n"),
            ("      x_map, static_cast<const __nv_bfloat16*>(wm),",
             "      x_map, static_cast<const __nv_bfloat16*>(x),\n"
             "      static_cast<const __nv_bfloat16*>(wm),"),
            # copies that landed through the generic proxy -> wgmma
            ("    mbar_wait(full + 8 * s, (i / L::STAGES) & 1);\n",
             "    mbar_wait(full + 8 * s, (i / L::STAGES) & 1);\n"
             "    asm volatile(\"fence.proxy.async.shared::cta;\" ::: "
             "\"memory\");\n")]


def _wgmma_rs(n):
    """The register-A wgmma m64n{n}k16 wrapper, as csrc/conv3x3.cu writes
    its shared-memory ones."""
    r = n // 2
    regs = ", ".join(f"%{i}" for i in range(r))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(r))
    return (f"template <>\n__device__ __forceinline__ void wgmma_rs<{n}>("
            f"float (&d)[{r}], const uint32_t (&a)[4], uint64_t b, "
            f"int scale_d) {{\n  asm volatile(\n"
            f'      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"\n'
            f'      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "\n'
            f'      "{{{regs}}}, {{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, '
            f'%{r + 4}, p, 1, 1, 0;\\n}}\\n"\n'
            f"      : {outs}\n"
            f'      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), '
            f'"r"(scale_d));\n}}\n\n')


# Option (a): A from registers. The halo as one TMA box of whole pixels at
# a pitch of C + 8 channels (the last 8 zero: an odd number of 16-byte
# chunks, so ldmatrix reads 8 consecutive pixels from 8 bank groups);
# each halo row's A fragments (3 taps dx x C / 16 k-steps, by ldmatrix)
# serve the output rows it touches (taps dy = 0, 1, 2) before the next
# halo row is loaded: into a second register set while its products run
# (two sets), or after they are done (one set).
_REG_LAYOUT = (
    "  // one channel group's (TH + 2) x 66 pixels, padded to 128 bytes (a\n"
    "  // TMA destination's alignment)\n"
    "  static constexpr uint32_t SLAB = (ROWS * PW * 16 + 127) / 128 * 128;\n"
    "  static constexpr uint32_t STAGE_BYTES = G * SLAB;\n",
    "  static constexpr int CP = C + 8;\n"
    "  static constexpr uint32_t PIX = CP * 2;\n"
    "  static constexpr uint32_t BOX_BYTES = ROWS * PW * PIX;\n"
    "  static constexpr uint32_t STAGE_BYTES = (BOX_BYTES + 127) / 128 * 128;"
    "\n")
_REG_HELPERS = r"""__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int x0, int y0) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(x0),
      "r"(y0)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d);

"""
_REG_CONSUMER = r"""  const int mi = lane >> 3;
  const uint32_t lane_off =
      (16 * (warp & 3) + 8 * (mi & 1) + (lane & 7)) * L::PIX + (mi >> 1) * 16;
  const uint64_t b0 = smem_desc(base, C * 16, 128);
  float acc[L::RPW][C / 2];
  uint32_t a[SETS][3][C / 16][4];
  for (int i = 0; i < n_mine; ++i) {
    const int tile = blockIdx.x + i * gridDim.x;
    const int s = i % L::STAGES;
    const int r0 = wg * L::RPW;
    const uint32_t halo =
        base + L::HALO + s * L::STAGE_BYTES + r0 * PW * L::PIX + lane_off;
    const int gy0 = (tile / tiles_x) * L::TH + r0;
    const int x0 = (tile % tiles_x) * TW;
    mbar_wait(full + 8 * s, (i / L::STAGES) & 1);
#pragma unroll
    for (int R = 0; R < L::RPW + 2; ++R) {
      if (R >= SETS) wgmma_wait<SETS - 1>();
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int k = 0; k < C / 16; ++k)
          ldmatrix_x4(a[R % SETS][dx][k],
                      halo + (R * PW + dx) * L::PIX + k * 32);
      if (R == L::RPW + 1) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
#pragma unroll
      for (int r = 0; r < L::RPW; ++r) fence_acc(acc[r]);
      wgmma_fence();
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int r = R - dy;
        if (r >= 0 && r < L::RPW) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
#pragma unroll
            for (int k = 0; k < C / 16; ++k)
              wgmma_rs<C>(acc[r], a[R % SETS][dx][k],
                          b0 + ((3 * dy + dx) * G + 2 * k) * C,
                          dy + dx + k > 0);
        }
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < L::RPW; ++r) {
      fence_acc(acc[r]);
      row_epilogue<C>(acc[r], b, tid, stage, slot, bar, y, gy0 + r, x0, h,
                      w);
    }
  }
"""
_REG_HOST = (
    "  const cuuint64_t dims[4] = {8, (cuuint64_t)(C / 8), (cuuint64_t)w,\n"
    "                              (cuuint64_t)h};\n"
    "  const cuuint64_t strides[3] = {16, (cuuint64_t)C * 2,\n"
    "                                 (cuuint64_t)w * C * 2};\n"
    "  const cuuint32_t box[4] = {8, 1, (cuuint32_t)PW, "
    "(cuuint32_t)L::ROWS};\n",
    "  const cuuint64_t dims[3] = {C, (cuuint64_t)w, (cuuint64_t)h};\n"
    "  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, "
    "(cuuint64_t)w * C * 2};\n"
    "  const cuuint32_t box[3] = {L::CP, (cuuint32_t)PW, "
    "(cuuint32_t)L::ROWS};\n")


def _register_a(sets):
    """Edits that make option (a) with `sets` A register sets."""
    kernel = "// " + "-" * 66 + " kernel"
    return [
        _REG_LAYOUT,
        (("__device__ __forceinline__ void tma_load_4d(",
          "// arrive on the mbarrier and expect"),
         _REG_HELPERS + "// arrive on the mbarrier and expect"),
        ((kernel, kernel), "".join(_wgmma_rs(n) for n in (16, 32, 48, 64, 80))
         + f"constexpr int SETS = {sets};\n\n" + kernel),
        ("        mbar_expect(full + 8 * s, G * L::ROWS * PW * 16);\n"
         "        for (int g = 0; g < G; ++g)\n"
         "          tma_load_4d(dst + g * L::SLAB, &x_map, full + 8 * s, g, "
         "x0, y0);\n",
         "        mbar_expect(full + 8 * s, L::BOX_BYTES);\n"
         "        tma_load_3d(dst, &x_map, full + 8 * s, x0, y0);\n"),
        (("  float acc0[C / 2], acc1[C / 2];\n", "  if (tid == 0) "
          "bulk_wait();"), _REG_CONSUMER + "  if (tid == 0) bulk_wait();"),
        (("// One output row of the tile", "// Round, add the bias"),
         "// Round, add the bias"),
        _REG_HOST,
        ("CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,",
         "CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,"),
        ("  const cuuint32_t unit[4] = {1, 1, 1, 1};",
         "  const cuuint32_t unit[3] = {1, 1, 1};")]


# The shipped design before its last step: unswizzled halo slabs of
# [row][pixel] x 16 bytes, one TMA box per 8-channel group (twice the box
# rows). The cp.async and register-A variants are made from it.
_OLD_PRODUCTS = r"""  constexpr int G = C / 8;
  constexpr uint32_t A_LBO = Layout<C>::SLAB, B_LBO = C * 16;
  const uint64_t a0 = smem_desc(halo + (uint32_t)(r * PW) * 16, A_LBO, 128);
  const uint64_t b0 = smem_desc(wsm, B_LBO, 128);
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < 9; ++t) {
#pragma unroll
    for (int s = 0; s < C / 16; ++s) {
      const uint32_t a_off = 2 * s * (A_LBO / 16) + (t / 3) * PW + t % 3;
      const uint32_t b_off = (t * G + 2 * s) * C;
      wgmma_ss<C>(acc, a0 + a_off, b0 + b_off, t + s > 0);
    }
  }
  wgmma_commit();"""
_SHIPPED_LOADS = (
    "        mbar_expect(full + 8 * s, C / 16 * L::ROWS * PW * 32);\n"
    "        for (int k = 0; k < C / 16; ++k)\n"
    "          tma_load_4d(dst + k * L::SLAB, &x_map, full + 8 * s, k, x0, "
    "y0);\n")
_SHIPPED_MAP = ("  const cuuint64_t dims[4] = {16, (cuuint64_t)(C / 16), "
                "(cuuint64_t)w,\n"
                "                              (cuuint64_t)h};\n"
                "  const cuuint64_t strides[3] = {32, (cuuint64_t)C * 2,\n"
                "                                 (cuuint64_t)w * C * 2};\n"
                "  const cuuint32_t box[4] = {16, 1, (cuuint32_t)PW, "
                "(cuuint32_t)L::ROWS};\n")
_UNSWIZZLE = [
    ("  // the halo ring and its slabs start on 1024 bytes (a swizzled TMA\n"
     "  // destination's alignment)\n"
     "  static constexpr uint32_t HALO = (9 * C * C * 2 + 1023) / 1024 * "
     "1024;\n"
     "  // one 16-channel group's (TH + 2) x 66 pixels x 32 bytes\n"
     "  static constexpr uint32_t SLAB = (ROWS * PW * 32 + 1023) / 1024 * "
     "1024;\n"
     "  static constexpr uint32_t STAGE_BYTES = C / 16 * SLAB;\n",
     "  static constexpr uint32_t HALO = 9 * C * C * 2;\n"
     "  // one channel group's (TH + 2) x 66 pixels, padded to 128 bytes (a\n"
     "  // TMA destination's alignment)\n"
     "  static constexpr uint32_t SLAB = (ROWS * PW * 16 + 127) / 128 * 128;\n"
     "  static constexpr uint32_t STAGE_BYTES = G * SLAB;\n"),
    (("  constexpr int G = C / 8;\n  constexpr uint64_t SWIZZLE_32B",
      "  wgmma_commit();"), _OLD_PRODUCTS),
    (_SHIPPED_LOADS,
     "        mbar_expect(full + 8 * s, G * L::ROWS * PW * 16);\n"
     "        for (int g = 0; g < G; ++g)\n"
     "          tma_load_4d(dst + g * L::SLAB, &x_map, full + 8 * s, g, x0, "
     "y0);\n"),
    (_SHIPPED_MAP,
     "  const cuuint64_t dims[4] = {8, (cuuint64_t)(C / 8), (cuuint64_t)w,\n"
     "                              (cuuint64_t)h};\n"
     "  const cuuint64_t strides[3] = {16, (cuuint64_t)C * 2,\n"
     "                                 (cuuint64_t)w * C * 2};\n"
     "  const cuuint32_t box[4] = {8, 1, (cuuint32_t)PW, "
     "(cuuint32_t)L::ROWS};\n"),
    ("CU_TENSOR_MAP_SWIZZLE_32B", "CU_TENSOR_MAP_SWIZZLE_NONE")]

_NO_COPIES = (_SHIPPED_LOADS, "        mbar_arrive(full + 8 * s);\n")
# the epilogue left out, its accumulators kept live (ptxas drops a wgmma
# whose results are never read)
_NO_EPILOGUE = ("  if (tid == 0) bulk_wait_read<L::OUT_BUFS - 1>();\n",
                "  if (tid == 0 && acc[0] == 1.2345f)\n"
                "    y[0] = __float2bfloat16_rn(acc[C / 2 - 1]);\n"
                "  return;\n")
_NO_PRODUCTS = ("      wgmma_ss<C>(acc, smem_desc(a, 16, 256) | SWIZZLE_32B, "
                "b0 + b_off,\n                  t + s > 0);", "")
# the whole halo as one box of pixels of C channels (96-byte box rows,
# pixel-major: the wrong layout for the products, the same bytes)
_WIDE_BOXES = [
    (_SHIPPED_LOADS,
     "        mbar_expect(full + 8 * s, C / 16 * L::ROWS * PW * 32);\n"
     "        asm volatile(\"cp.async.bulk.tensor.3d.shared::cluster.global."
     "mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\" ::"
     "\"r\"(dst), \"l\"(reinterpret_cast<uint64_t>(&x_map)), "
     "\"r\"(full + 8 * s), \"r\"(0), \"r\"(x0), \"r\"(y0) : "
     "\"memory\");\n"),
    (_SHIPPED_MAP,
     "  const cuuint64_t dims[3] = {C, (cuuint64_t)w, (cuuint64_t)h};\n"
     "  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, "
     "(cuuint64_t)w * C * 2};\n"
     "  const cuuint32_t box[3] = {C, (cuuint32_t)PW, "
     "(cuuint32_t)L::ROWS};\n"),
    ("CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,",
     "CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,"),
    ("CU_TENSOR_MAP_SWIZZLE_32B", "CU_TENSOR_MAP_SWIZZLE_NONE")]
VARIANTS = {
    "16-byte boxes, unswizzled": _UNSWIZZLE,
    "swizzle base offset from the address": [
        ("smem_desc(a, 16, 256) | SWIZZLE_32B,",
         "smem_desc(a, 16, 256) | SWIZZLE_32B |\n"
         "                  ((uint64_t)((a >> 7) & 7) << 49),")],
    "register A, two sets": _UNSWIZZLE + _register_a(2),
    "register A, one set": _UNSWIZZLE + _register_a(1),
    "cp.async, 8 producer warps": _UNSWIZZLE + _cp_async(8),
    "cp.async, 4 producer warps": _UNSWIZZLE + _cp_async(4),
    "L2 promotion 256B": [("CU_TENSOR_MAP_L2_PROMOTION_L2_128B",
                           "CU_TENSOR_MAP_L2_PROMOTION_L2_256B")],
    "TH 6, 3 stages": [(_PLAN48, _PLAN48.replace("TH = 8, STAGES = 2",
                                                 "TH = 6, STAGES = 3"))],
    "TH 4, 3 stages": [(_PLAN48, _PLAN48.replace("TH = 8, STAGES = 2",
                                                 "TH = 4, STAGES = 3"))],
    "one consumer warpgroup": [("constexpr int CONSUMERS = 2;",
                                "constexpr int CONSUMERS = 1;")],
    "no products": [_NO_PRODUCTS],
    "no halo copies": [_NO_COPIES],
    "products only": [_NO_COPIES, _NO_EPILOGUE],
    "no stores": [("    bulk_store(y + ((long long)gy * w + x0) * C, "
                   "smem_u32(out_ptr),\n               (uint32_t)px * C * 2);",
                   "")],
    "one staging row": [("SMEM_MAX ? 2 : 1;", "SMEM_MAX ? 1 : 1;")],
    "no products, 96-byte boxes": [_NO_PRODUCTS, *_WIDE_BOXES],
}


def _build(sources: dict) -> dict:
    """{name: CUDA source} -> {name: loaded library}, one nvcc each, all
    started together, into the package's build directory."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        tag = name.replace(" ", "_").replace(",", "")
        stem = build.BUILD_DIR / f"probe_conv_{tag}"
        stem.with_suffix(".cu").write_text(src)
        procs[name] = (subprocess.Popen(
            [build.LIBS._nvcc(), *build.NVCC_FLAGS, "-o",
             str(stem.with_suffix(".so")), str(stem.with_suffix(".cu"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), stem)
    libs = {}
    for name, (proc, stem) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = ctypes.CDLL(str(stem.with_suffix(".so")))
    return libs


def _variant_sources() -> dict:
    src = (build.SRC_DIR / "conv3x3.cu").read_text()
    out = {"shipped": src}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if isinstance(old, tuple):      # a block, from its first line
                start = text.find(old[0])   # to the first end after it
                end = text.find(old[1], start)
                if start < 0 or end < 0:
                    raise RuntimeError(f"variant {name}: the source changed")
                text = text[:start] + new + text[end + len(old[1]):]
                continue
            if old not in text:
                raise RuntimeError(f"variant {name}: the source changed")
            text = text.replace(old, new)
        out[name] = text
    return out


def _device_ms(call, reps=20):
    """Mean device time of the kernel over the launches the profiler
    recorded (it can lose some)."""
    rows = device_kernels(lambda: [call() for _ in range(reps)])
    hits = [(m, n) for name, m, n in rows if "conv3x3_bias_kernel" in name]
    n = sum(n for _, n in hits)
    return sum(m for m, _ in hits) / n if n else None


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_conv needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    libs = _build(_variant_sources())
    stream = torch.cuda.current_stream().cuda_stream
    res = dict(card=card, size=list(SIZE), variants={}, by_c={})

    def caller(lib, x, wm, bias, y, c):
        fn = lib.conv3x3_bias_launch
        fn.argtypes = [*k3._ARGS, ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def call():
            err = fn(x.data_ptr(), wm.data_ptr(), bias.data_ptr(),
                     y.data_ptr(), SIZE[0], SIZE[1], c, stream)
            if err:
                raise RuntimeError(f"CUDA error {err}")
        return call

    x, wm, bias = make_inputs(*SIZE, 48, dev)
    want = k3.conv3x3_bias_plain(x, wm, bias)
    y = torch.empty_like(x)
    for _ in range(2):
        for name, lib in libs.items():
            call = caller(lib, x, wm, bias, y, 48)
            y.zero_()
            call()
            torch.cuda.synchronize()
            err = float((y.float() - want.float()).abs().max())
            ms = _device_ms(call)
            v = res["variants"].setdefault(name, dict(ms=[], max_abs_err=err))
            v["ms"].append(ms)
            print(f"{name}: {ms} ms, max|y - plain| {err:.4g}", flush=True)
    for c in (16, 32, 48, 64, 80):
        x, wm, bias = make_inputs(*SIZE, c, dev)
        want = k3.conv3x3_bias_plain(x, wm, bias)
        y = torch.empty_like(x)
        nbytes = 2 * x.numel() * 2 + wm.numel() * 2 + bias.numel() * 2
        flops = 2.0 * SIZE[0] * SIZE[1] * c * 9 * c
        b_ms, b_by = bound_ms(nbytes, flops, torch.bfloat16)
        res["by_c"][c] = dict(bound_ms=b_ms, bound_by=b_by)
        for name in BY_C:
            call = caller(libs[name], x, wm, bias, y, c)
            call()
            ms = _device_ms(call)
            ratio = envelope_ratio(y, want)
            res["by_c"][c][name] = dict(ms=ms, envelope_ratio=ratio)
            print(f"{name} C={c}: {ms} ms (bound {b_ms:.4f}, {b_by}); "
                  f"{ratio:.3f} of the envelope", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
