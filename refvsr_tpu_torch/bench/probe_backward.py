"""Probe variants of K1's backward kernel, and the host work of the two
backward wrappers, on the card: what holds the scatter kernels back.

    python -m refvsr_tpu_torch.bench.probe_backward

Builds, beside the shipped kernel, variants of ``csrc/warp_sample.cu`` made
by text substitution (none is kept in the source; a substitution that no
longer finds its text stops the probe, which then needs updating):

- ``no window``: the register window reduced after every pixel, so each
  pixel issues four float4 reductions (the float4 reductions alone);
- ``scalar``: one f32 reduction per channel in place of each float4 one,
  run at dx's padded pitch and at the pitch C (49 for the feature warp);
- ``stores``: plain 16-byte stores in place of the reductions (racy: the
  time of everything but the atomics);
- ``64-bit offsets``: the 64-bit build at every size, where the shipped
  launcher takes 32-bit offsets whenever every index fits;

and a reduction-throughput microbenchmark: scalar, float2 and float4
atomicAdd over distinct addresses, coalesced along a warp, and the same
with 16 threads on each address. It reports each K1-bwd variant's device
time (one torch.profiler pass of 20 launches, by kernel name; the kernel
alone, not the launcher's clear) at the training step's three warp shapes,
dx only, in two rounds that each run every variant once; K2-bwd's device time with both
gradients, d_lr only and d_ref only, at the training and serving shapes;
and the host time of the wrappers' pieces (host clock over 2,000 calls, no
synchronisation). Prints one JSON line. Needs the card."""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from refvsr_tpu_torch.bench import device_kernels
from refvsr_tpu_torch.ops.kernels import build
from refvsr_tpu_torch.ops.kernels import argmax_matmul as k2
from refvsr_tpu_torch.ops.kernels import warp_sample as k1

# the training step's warps, dx only: x (n, h, w, c) onto (ho, wo), and
# the amplitude of the smooth flow
SHAPES = {"feature": ((2, 128, 128, 49), (128, 128), 6.0),
          "UP": ((2, 256, 256, 48), (256, 256), 12.0),
          "UP low-res to 2x": ((2, 128, 128, 48), (256, 256), 12.0)}

_FLOAT4_RED = ("      atomicAdd(reinterpret_cast<float4*>(dst + q),\n"
               "                make_float4(v[q], v[q + 1], v[q + 2], "
               "v[q + 3]));")
_PITCH_CHECK = "ldx < c || ldx % 4 != 0 ||"
VARIANTS = {
    "no window": [("if (win.used && yi == win.ya && xi == win.xa + 1) {",
                   "if (false) {"),
                  ("} else if (!win.used || yi != win.ya || xi != win.xa) {",
                   "} else {")],
    "scalar": [(_FLOAT4_RED,
                "      for (int e = 0; e < 4; ++e)\n"
                "        if (ch + q + e < c) atomicAdd(dst + q + e, "
                "v[q + e]);"),
               (_PITCH_CHECK, "ldx < c ||")],
    "stores": [(_FLOAT4_RED,
                "      *reinterpret_cast<float4*>(dst + q) =\n"
                "          make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);")],
    "64-bit offsets": [("  if (narrow)\n    launch_backward_idx<T, int>(",
                        "  if (false)\n    launch_backward_idx<T, int>(")],
}

RED_BENCH = r"""
#include <cuda_runtime.h>
template <int W>
__global__ void red_bench_kernel(float* buf, int per, int same, long long n) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long threads = (long long)gridDim.x * blockDim.x;
  for (int k = 0; k < per; ++k) {
    float* p = buf + (((t / same) + k * threads) * W) % n;
    if (W == 1) atomicAdd(p, 1.0f);
    if (W == 2) atomicAdd(reinterpret_cast<float2*>(p), make_float2(1.f, 1.f));
    if (W == 4)
      atomicAdd(reinterpret_cast<float4*>(p), make_float4(1.f, 1.f, 1.f, 1.f));
  }
}
extern "C" int red_bench(float* buf, int width, int blocks, int per,
                         int same, long long n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (width == 1) red_bench_kernel<1><<<blocks, 256, 0, s>>>(buf, per, same, n);
  if (width == 2) red_bench_kernel<2><<<blocks, 256, 0, s>>>(buf, per, same, n);
  if (width == 4) red_bench_kernel<4><<<blocks, 256, 0, s>>>(buf, per, same, n);
  return (int)cudaGetLastError();
}
"""


def _build(sources: dict) -> dict:
    """{name: CUDA source} -> {name: loaded library}, one nvcc each, all
    started together, into the package's build directory."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        stem = build.BUILD_DIR / f"probe_{name.replace(' ', '_')}"
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
    src = (build.SRC_DIR / "warp_sample.cu").read_text()
    out = {"window": src}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: the source changed")
            text = text.replace(old, new)
        out[name] = text
    return out


def _device_ms(call, tag, reps=20):
    return sum(ms for name, ms, _ in device_kernels(
        lambda: [call() for _ in range(reps)]) if tag in name) / reps


def _host_us(fn, reps=2000):
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def k1_variants(libs, dev, rounds=2):
    """{shape: {variant (pitch): [device ms of each round]}} of K1-bwd, dx
    only."""
    gen = torch.Generator(device=dev).manual_seed(1)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for label, ((n, h, w, c), (ho, wo), amp) in SHAPES.items():
        coarse = torch.rand((n, 2, 9, 16), generator=gen, device=dev) * 2 - 1
        flow = (F.interpolate(coarse, size=(ho, wo), mode="bicubic",
                              align_corners=False) * amp).permute(
            0, 2, 3, 1).contiguous()
        g = torch.rand((n, ho, wo, c), generator=gen, device=dev) * 2 - 1
        times = {}
        for name, lib in [*libs.items()] * rounds:
            fn = lib.warp_sample_backward_launch
            fn.argtypes = [*k1._BACKWARD_ARGS, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            for ldx in sorted({k1.dx_pitch(c)} | ({c} if name == "scalar"
                                                  else set())):
                dx = torch.empty((n, h, w, ldx), device=dev)

                def call():
                    err = fn(None, flow.data_ptr(), g.data_ptr(),
                             dx.data_ptr(), None, n, h, w, c, ho, wo, ldx, 0,
                             stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                times.setdefault(f"{name} (pitch {ldx})", []).append(
                    _device_ms(call, "warp_sample_backward_kernel"))
        out[label] = times
    return out


def reduction_rates(lib, dev):
    """G reductions/s and TB/s of f32 data at each width."""
    fn = lib.red_bench
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    buf = torch.zeros(6 << 20, device=dev)
    blocks, per = 1056, 16
    ops = blocks * 256 * per
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for width in (1, 2, 4):
        for same in (1, 16):
            ms = _device_ms(lambda: fn(buf.data_ptr(), width, blocks, per,
                                       same, buf.numel(), stream),
                            "red_bench_kernel")
            out[f"width {width}, {same} thread(s) an address"] = dict(
                ms=ms, g_ops_per_s=ops / ms / 1e6,
                tb_per_s=ops * width * 4 / ms / 1e9)
    return out


def k2_parts(dev):
    """{shape: {gradients asked for: device ms}} of K2-bwd, D = 144, on
    random picks."""
    gen = torch.Generator(device=dev).manual_seed(2)
    out = {}
    for label, (n, l_ref, l_lr, dtype) in {
            "training, B=14, 1024 x 1024, f32": (14, 1024, 1024,
                                                 torch.float32),
            "serving, 32400 ref x 129600 LR, bf16": (1, 32400, 129600,
                                                     torch.bfloat16)}.items():
        ref = torch.randn((n, l_ref, 144), generator=gen, device=dev).to(dtype)
        lr = torch.randn((n, l_lr, 144), generator=gen, device=dev).to(dtype)
        idx = torch.randint(0, l_ref, (n, l_lr), generator=gen, device=dev,
                            dtype=torch.int32)
        g = torch.randn((n, l_lr), generator=gen, device=dev)
        out[label] = {
            name: _device_ms(lambda needs=needs: k2.argmax_matmul_backward(
                ref, lr, idx, g, needs), "argmax_matmul_backward_kernel")
            for name, needs in (("d_ref + d_lr", (True, True)),
                                ("d_lr", (False, True)),
                                ("d_ref", (True, False)))}
    return out


def host_pieces(dev):
    """Host microseconds of the pieces of a K2-bwd call at the training
    shape (B=14, 1024 x 1024, D=144, f32), of the whole K1-bwd and K2-bwd
    calls, and of the library yardstick's two calls."""
    ref = torch.randn((14, 1024, 144), device=dev)
    lr = torch.randn_like(ref)
    idx = torch.randint(0, 1024, (14, 1024), device=dev, dtype=torch.int32)
    g = torch.randn((14, 1024), device=dev)
    rows = idx.reshape(-1).long()
    acc = torch.zeros((14 * 1024, 144), device=dev)
    x = torch.rand((2, 128, 128, 49), device=dev)
    flow = torch.zeros((2, 128, 128, 2), device=dev)
    gx = torch.rand_like(x)
    pieces = {
        "torch.zeros (d_ref)": lambda: torch.zeros(
            ref.shape, dtype=torch.float32, device=ref.device),
        "torch.empty (d_ref)": lambda: torch.empty(
            ref.shape, dtype=torch.float32, device=ref.device),
        "torch.empty_like (d_ref)": lambda: torch.empty_like(
            ref, dtype=torch.float32),
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "torch._C._cuda_getCurrentRawStream":
            lambda: torch._C._cuda_getCurrentRawStream(ref.device.index),
        "K2-bwd call": lambda: k2.argmax_matmul_backward(ref, lr, idx, g),
        "K1-bwd call (feature warp, dx)":
            lambda: k1.warp_sample_backward(gx, flow, x.shape),
        "index_select": lambda: ref.reshape(-1, 144).index_select(0, rows),
        "index_add_": lambda: acc.index_add_(0, rows, lr.reshape(-1, 144)),
    }
    return {name: _host_us(fn) for name, fn in pieces.items()}


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_backward needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = _build({**_variant_sources(), "reductions": RED_BENCH})
    red = libs.pop("reductions")
    result = dict(card=card, k1_bwd_device_ms=k1_variants(libs, dev),
                  reductions=reduction_rates(red, dev),
                  k2_bwd_device_ms=k2_parts(dev), host_us=host_pieces(dev))
    for shape, times in result["k1_bwd_device_ms"].items():
        print(f"K1-bwd {shape}, dx: " + ", ".join(
            f"{k} " + " / ".join(f"{t:.4f}" for t in v) + " ms"
            for k, v in times.items()))
    for k, v in result["reductions"].items():
        print(f"reductions {k}: {v['g_ops_per_s']:.1f} G/s, "
              f"{v['tb_per_s']:.2f} TB/s of f32")
    for shape, times in result["k2_bwd_device_ms"].items():
        print(f"K2-bwd {shape}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in times.items()))
    for k, v in result["host_us"].items():
        print(f"host {k}: {v:.1f} us")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
