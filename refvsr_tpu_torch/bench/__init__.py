"""Microbenchmark entry points, counterparts of the JAX package's
``scripts/microbench_pallas_*.py``:

- ``python -m refvsr_tpu_torch.bench.microbench_conv``: K3, the 3x3 conv +
  bias kernel, against cuDNN at the model's resblock shape;
- ``python -m refvsr_tpu_torch.bench.microbench_gather``: K4, the row
  gather, against ``torch.index_select``.

and, on the card only, ``python -m refvsr_tpu_torch.bench.probe_backward``:
variants of K1's backward kernel, the L2's reduction rates and the backward
wrappers' host work, the measurements behind the backward kernels' design.

Each microbenchmark module's ``run(...)`` returns its numbers as a dict. Times are taken
on the card only, by CUDA events; with ``--device cpu`` an entry point runs
the plain versions and measures nothing.
"""

from __future__ import annotations

import torch

# published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s, and FLOP/s of
# the bf16 tensor cores, of f32 outside them and of the TF32 tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, "tf32": 495e12}


def cuda_ms(fn, iters=10, warmup=2):
    """Mean device time of fn() over `iters` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops, peak):
    """Least time for the work on one H100: the larger of bytes over the
    memory rate and operations over the peak rate `peak` (a key of
    ``PEAK_FLOPS``: the operations' dtype, or "tf32")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[peak] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def device_kernels(fn):
    """[(kernel name, device ms, launches)] of one traced call of fn()."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(ev.key, ev.self_device_time_total / 1e3, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA]
