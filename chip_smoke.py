#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero without them, or when run
outside a checkout of the repository. Phases, each fatal on failure:

1. the card's name and power limit, torch and CUDA versions;
2. build the CUDA kernels from ``refvsr_tpu_torch/csrc`` (one nvcc each);
3. K1 ``warp_sample`` against its plain version at both main-path shapes
   (bf16) and one small f32 case, with out-of-range and NaN coordinates;
4. K2 ``argmax_matmul`` against its plain version at the main-path shape,
   and in bf16 and f32 at ragged sizes with exact ties planted across the
   kernels' tile and lane boundaries;
5. the backward kernels against their plain backward passes: K1's at both
   training shapes (f32) and the serving feature shape (bf16), with the
   same poisoned flows, dx and dflow, at the training step's low-res-to-2x
   UP shape (dx), and with a flow that throws corners far from their
   neighbours' (dx and dflow); K2's at the training shape (f32), the
   serving shape (bf16, 1,000 duplicated ref rows), the training shape with
   every LR row picking one ref row, and with only lr_p's gradient asked
   for. Each case reports its call's CUDA-event time, its device time
   (one ``torch.profiler`` pass: the launcher's clear of the f32 dx or
   d_ref, the kernel and any cast, the work its bound counts) and its
   kernel's alone;
6. the microbenchmark paths, K3 and K4's only callers: the entry points
   ``bench.microbench_conv.run`` (K3 ``conv3x3_bias`` at 1080x1920x48 bf16
   beside cuDNN's conv with and without bias, and the device kernels each
   library call launches) and ``bench.microbench_gather.run`` (K4
   ``gather_rows``, R 2048, L 128 bf16, P 2^20, beside ``index_select``),
   each driven with the launch counts set to 0 just before and read just
   after; then K3 against its plain version at ragged shapes and K4's check
   mode (f32 and bf16, indices out of range on both sides);
7. small-input agreement checks: the port on the card (f32, kernels)
   against the port on the CPU (f32, plain versions), for the stream and
   for one training step (losses and gradients);
8. the streaming path at full width: RefVSR_MFID_8K (30 blocks, 48
   channels, seeded random weights, bf16) streaming 1080p windows of 7
   frames into 4320x7680 frames through ``StreamRunner``: one
   ``forward_first`` and three ``forward_stream`` windows, with each
   kernel's launches counted; then one more streamed window traced by
   ``torch.profiler`` (each kernel's device time inside the path), and each
   kernel held against its plain version on the inputs the path gave it:
   every call of a further streamed window, and the calls of a new first
   window at the shapes the streamed window lacks (K1 from the low-res grid
   to the 2x one; K2 at batch 7);
9. the serving path: ``serving.predictor.Predictor`` (RefVSR_MFID_8K,
   seeded random weights, bf16) on a seeded 1080x1920 PNG pair that the
   port's encoder writes, center-cropped to 720x1280: three ``predict``
   calls with each kernel's launches counted, the output PNG decoded by the
   port's reader and checked ((2880, 5120, 3), finite, non-constant), the
   PNG decode and encode timed apart; then the K1 and K2 calls of one more
   ``predict`` held against their plain versions;
10. the pipelined stream (``pipeline_lanes`` = 2): first at a small input,
   the tiny net (2 blocks, 8 channels, T = 7, f32) pipelined on the card
   against the plain stream on the card and the pipelined one on the CPU
   (one first window, one priming dispatch, three steady dispatches and the
   flush), each emitted frame within 1e-4; then at full width, plain and
   pipelined RefVSR_MFID_8K (bf16, 1080p in, 8K out) on the same frames,
   in turn: ms per steady dispatch against ms per plain window, their
   peaks, the launches of each dispatch, and each emitted frame against
   the plain stream's (mean and max |difference| on the [0, 1] output
   within PIPE_MEAN_LIMIT and PIPE_MAX_LIMIT); the K1 and K2 calls of the
   flush dispatch held against their plain versions;
11. the training path at full width: RefVSR_MFID_8K trained as the JAX
   package trains it (loss '1*L1_lf+0.1*MFID_ref' at relu4_4, f32, patch
   128, 7 frames, Adam with global-norm clipping and the CA schedule) on a
   seeded synthetic batch, at batch 2 instead of the config's 8 (batch 8
   does not fit one card). One ``Trainer.iteration`` (9 optimizer steps)
   with the four kernels' launches counted; then one more step traced by
   ``torch.profiler`` (where the step's time goes), each kernel held
   against its plain version on the inputs that step gave it;
12. the training entry point at full width: a seeded 1080x1920 PNG tree
   (train: one clip of 18 frames per camera, two samples; valid: 3 frames)
   written by the port's encoder; ``TrainLoader`` and a 4-worker
   ``MultiWorkerLoader`` timed per batch on it (equal batches); then
   ``refvsr_tpu_torch.run.main([... "--is_train", "--config",
   "config_RefVSR_MFID_8K", "-b", "2", "--total_itr", "9"])``: one epoch
   (one batch, 9 steps, the f32 validation at 8K over 3 windows, a
   checkpoint) with ms per iteration, the wait on the prefetch queue, the
   epoch's time and its share in iterations, ms per validation window,
   PSNR, the checkpoint's bytes and save time and the peaks of training
   and validation, the kernels' launches counted and the calls of its
   first step and first validation window captured; then ``--resume 0
   --total_itr 18``: the state loaded equals the saved one bit for bit, a
   second epoch runs, ``checkpoints.txt`` holds two entries and the
   most-recent line; then one ``Trainer.iteration`` of
   RefVSR_small_MFID_8K under the bf16 policy (``is_amp``) at batch 4
   (the config's 8 does not fit beside the rest), its first step's
   backward calls captured, and one is_amp window of a tiny net on the
   card against the CPU.

Then one ``{"kernels": [...]}`` line and, last, the device line. A kernel's
``ms`` there is its device time in the profiled window (forward kernels:
the streamed window; backward kernels: the training step); ``plain_ms``,
``library_ms`` and ``bound_ms`` are summed over the captured window's or
step's calls; the calls captured in phases 9, 10 and 12 are further cases
of each row. K3's and K4's ``ms``, ``plain_ms`` and ``library_ms`` are
CUDA-event times of one call each at their microbenchmark's default
shape. f32 comparisons run with TF32 off for both matmuls and cuDNN
convolutions; the full-width training runs under PyTorch's default f32
policy (TF32 for cuDNN convolutions, not for matmuls), as a user's trainer
would.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from refvsr_tpu_torch.bench import bound_ms, cuda_ms, device_kernels
from refvsr_tpu_torch.bench.probe_amp import compare as amp_compare
from refvsr_tpu_torch.bench.probe_amp import patched
from refvsr_tpu_torch.bench.probe_amp import worst as worst_tensors
from refvsr_tpu_torch.bench.ties import tied_rows

# main-path geometry: 1080p input, T = 7, scale 4 with HD input
N, T, H, W = 1, 7, 1080, 1920
STREAM_WINDOWS = 3
# K2 at the main path: ref rows, LR rows (both 3x3x16 patch vectors), and
# duplicated ref rows
K2_SHAPE = (32400, 129600, 144, 1000)
# training: batch 2 (the config's 8 does not fit one card); K2 matches the
# 2 x 7 frames' 32x32 LR features against 32x32 ref features
TRAIN_BATCH = 2
K2_TRAIN_SHAPE = (2 * T, 1024, 1024, 144, 16)
# the largest K2 similarity matrix the matmul + max yardstick materialises;
# past it, the yardstick runs one batch element at a time
K2_LIBRARY_MAX_BYTES = 16e9
# the training phases start from seeded random weights: no pretrained
# SPyNet or VGG19 is read (the Trainer warns that they are absent)
NO_ASSETS = dict(spynet_ckpt=None, vgg19_ckpt=None)
# serving: a 1080p PNG pair (cropped to 720x1280 by the predictor), timed
# over the calls after the first of SERVE_CALLS
SERVE_HW = (1080, 1920)
SERVE_CALLS = 3
# the pipelined stream at full width: lanes, and the frames of the video
# both streams run (one first window, then a priming dispatch and steady
# ones; the plain stream's windows on the same frames)
PIPE_LANES = 2
PIPE_FRAMES = 6
# how far a pipelined frame (bf16, batch-2 prop steps) may be from the
# plain stream's on the [0, 1] output: mean |difference| and max. On the
# H100 the two agreed bit for bit (cuDNN computes each lane of a batch-2
# convolution as it computes one alone); the max allows 4 bf16 ulps at 1.0
# should another build pick another algorithm for batch 2
PIPE_MEAN_LIMIT, PIPE_MAX_LIMIT = 1e-4, 1.6e-2
# K3 against its plain version at ragged shapes (H, W), C
# (tile heights 8, 4 and 2 rows by C, tiles 64 pixels wide): mid-tile in
# H and W at every C, one row narrower than a tile, and images of more
# tiles than the card holds blocks, so each block's halo ring wraps
K3_RAGGED = (((37, 53), 16), ((25, 131), 48),
             ((29, 101), 16), ((29, 101), 32), ((29, 101), 48),
             ((29, 101), 64), ((29, 101), 80), ((1, 40), 48), ((1, 7), 16),
             ((300, 700), 48), ((203, 517), 16), ((151, 450), 80))


def log(*a):
    print(*a, flush=True)


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _finite(t):
    return bool(torch.isfinite(t.float()).all())


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def call_device_ms(fn, wrapper, tag, reps=10, passes=3):
    """(device ms of one call of fn(), device ms of its kernel alone): means
    over `reps` calls traced in one torch.profiler pass. The first counts
    every device operation the calls issue: the launcher's clear of its f32
    output, the kernel, a cast. `wrapper` is the kernel's wrapper, whose
    ``launches`` count must rise by `reps` in a pass that shows no kernel
    named `tag` (else the kernel was not launched: fatal); then the profiler
    lost it, the pass is logged and run again, and after `passes` such
    passes neither time is measured (None)."""
    for _ in range(passes):
        before = wrapper.launches
        rows = device_kernels(lambda: [fn() for _ in range(reps)])
        kernel = sum(m for name, m, _ in rows if tag in name)
        if kernel > 0:
            return sum(m for _, m, _ in rows) / reps, kernel / reps
        launched = wrapper.launches - before
        check(launched == reps,
              f"{tag}: {launched} launches in {reps} calls of its wrapper")
        log(f"profiler pass without {tag} ({launched} launches): device "
            f"events {[(name[:60], n) for name, _, n in rows][:8]}")
    return None, None


def _ms(v):
    return "not measured" if v is None else f"{v:.4f} ms"


# ---------------------------------------------------------------- K1


def _smooth_flow(gen, n, ho, wo, amp, dev):
    """A smooth random flow field (N, Ho, Wo, 2) of about +-amp pixels."""
    import torch.nn.functional as F
    coarse = (torch.rand((n, 2, 9, 16), generator=gen, device=dev) * 2 - 1)
    return (F.interpolate(coarse, size=(ho, wo), mode="bicubic",
                          align_corners=False) * amp).permute(0, 2, 3, 1).contiguous()


def _poison(flow, gen):
    """Dead points: a block of far out-of-range flow and scattered NaNs."""
    flow = flow.clone()
    ho, wo = flow.shape[1], flow.shape[2]
    flow[:, : ho // 16, : wo // 16] += 1.0e4
    flow[:, -(ho // 16):, : wo // 16, 1] -= 1.0e4
    mask = torch.rand(flow.shape[:3], generator=gen,
                      device=flow.device) < 1e-3
    flow[..., 0][mask] = float("nan")
    return flow


def _dead(in_hw, flow):
    """The flow's dead points (outside the zeros-padding support, or NaN)."""
    from refvsr_tpu_torch.ops.kernels.warp_sample import warp_coords
    h, w = in_hw
    sx, sy = warp_coords((h, w), flow)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    return ~((x0 >= -1) & (x0 <= w - 1) & (y0 >= -1) & (y0 <= h - 1))


def _library_grid(in_hw, flow, dtype):
    """grid_sample's normalised grid for the same source coordinates; NaN
    coordinates become far-outside ones (dead either way)."""
    from refvsr_tpu_torch.ops.kernels.warp_sample import warp_coords
    h, w = in_hw
    sx, sy = warp_coords((h, w), flow)
    return torch.stack([(2 * sx + 1) / w - 1, (2 * sy + 1) / h - 1],
                       -1).nan_to_num(nan=-4.0).to(dtype)


def k1_case(name, x, flow, tol, need_dead=False):
    """K1 kernel vs plain on one input; returns a dict of its numbers."""
    import torch.nn.functional as F
    from refvsr_tpu_torch.ops.kernels.warp_sample import (warp_sample,
                                                          warp_sample_plain)
    got = warp_sample(x, flow)
    want = warp_sample_plain(x, flow)
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == x.dtype,
          f"K1 {name}: shape/dtype {tuple(got.shape)} {got.dtype}")
    h, w = x.shape[1], x.shape[2]
    dead = _dead((h, w), flow)
    n_dead = int(dead.sum())
    check(n_dead > 0 or not need_dead,
          f"K1 {name}: the case has no dead points")
    check(bool((got[dead] == 0).all()),
          f"K1 {name}: dead points are not exact zeros")
    err = float((got.float() - want.float()).abs().max())
    limit = tol * float(x.float().abs().max())
    check(err <= limit, f"K1 {name}: max |kernel - plain| {err} > {limit}")

    # the library yardstick: grid_sample on the same coordinates
    nchw = x.permute(0, 3, 1, 2)
    grid = _library_grid((h, w), flow, x.dtype)

    def library():
        return F.grid_sample(nchw, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=False)

    ms = cuda_ms(lambda: warp_sample(x, flow))
    plain_ms = cuda_ms(lambda: warp_sample_plain(x, flow), iters=3)
    library_ms = cuda_ms(library)
    nbytes = _nbytes(x, flow, got)
    flops = 8 * got.numel()     # four corner multiply-adds per value
    b_ms, b_by = bound_ms(nbytes, flops, x.dtype)
    log(f"K1 {name}: x {tuple(x.shape)} {x.dtype} -> {tuple(got.shape)}; "
        f"dead {n_dead}; max_abs_err {err:.3e} (limit {limit:.3e}); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, grid_sample "
        f"{library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(case=name, max_abs_err=err, tolerance=limit, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                bound_by=b_by, nbytes=nbytes, flops=flops, peak=x.dtype)


def phase_k1(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = []
    # UP warp of a streamed frame: (2h, 2w, 48) features onto the 2x grid
    x = torch.rand((N, 2 * H, 2 * W, 48), generator=gen, device=dev) * 2 - 1
    flow = _poison(_smooth_flow(gen, N, 2 * H, 2 * W, 12.0, dev), gen)
    cases.append(k1_case("up bf16", x.bfloat16(), flow.bfloat16(), 2.0 ** -6,
                         need_dead=True))
    del x, flow
    # feature warp: 48 channels + the confidence map
    x = torch.rand((N, H, W, 49), generator=gen, device=dev) * 2 - 1
    flow = _poison(_smooth_flow(gen, N, H, W, 6.0, dev), gen)
    cases.append(k1_case("feat bf16", x.bfloat16(), flow.bfloat16(),
                         2.0 ** -6, need_dead=True))
    del x, flow
    # small f32 case: ragged C, output grid other than the input's
    x = torch.rand((2, 37, 53, 5), generator=gen, device=dev) * 2 - 1
    flow = _poison(_smooth_flow(gen, 2, 70, 101, 9.0, dev), gen)
    cases.append(k1_case("small f32", x, flow, 1e-5, need_dead=True))
    return cases


def k1_bwd_case(name, g, flow, x_shape, x=None, need_dx=True,
                need_dead=False):
    """K1 backward kernel vs its plain backward on one input (the
    arguments of ``warp_sample_backward``); returns a dict of its numbers.

    The reference is the plain backward in f32 on the same values: the
    kernel sums in f32 and rounds once. Tolerance: 1e-5 of the reference's
    largest magnitude in f32 (atomics and channel sums in another order),
    2**-7 of it in bf16 (one rounding to bf16 is 2**-9). Dead points: dflow
    exact zeros, and a gradient carried by dead points alone leaves dx all
    zeros."""
    from refvsr_tpu_torch.ops.kernels.warp_sample import (
        warp_sample_backward, warp_sample_backward_plain)
    dx, dflow = warp_sample_backward(g, flow, x_shape, x, need_dx)
    dx_p, dflow_p = warp_sample_backward_plain(
        g.float(), flow.float(), x_shape, None if x is None else x.float())
    torch.cuda.synchronize()
    tol = 1e-5 if g.dtype == torch.float32 else 2.0 ** -7
    err, limit = {}, {}
    for label, got, want in (("dx", dx, dx_p if need_dx else None),
                             ("dflow", dflow, dflow_p)):
        if want is None:
            check(got is None, f"K1-bwd {name}: {label} was not asked for")
            continue
        check(got.shape == want.shape and got.dtype == g.dtype,
              f"K1-bwd {name}: {label} shape/dtype")
        check(_finite(got), f"K1-bwd {name}: {label} is not finite")
        err[label] = float((got.float() - want).abs().max())
        limit[label] = tol * float(want.abs().max())
        check(err[label] <= limit[label], f"K1-bwd {name}: max |kernel - "
              f"plain| of {label} {err[label]} > {limit[label]}")
    n, h, w, c = x_shape
    dead = _dead((h, w), flow)
    n_dead = int(dead.sum())
    check(n_dead > 0 or not need_dead,
          f"K1-bwd {name}: the case has no dead points")
    if dflow is not None:
        check(bool((dflow[dead] == 0).all()),
              f"K1-bwd {name}: dflow at dead points is not exact zeros")
    if n_dead and need_dx:
        # a gradient that only dead points carry must leave dx all zeros
        dx_dead, _ = warp_sample_backward(
            torch.where(dead[..., None], g, torch.zeros_like(g)), flow,
            x_shape)
        check(bool((dx_dead == 0).all()),
              f"K1-bwd {name}: dead points reached dx")
    # where the plain sum is exactly zero the atomics' order may leave
    # a rounding residue: reported, held only by the tolerance above
    odd = ((dx_p == 0) & (dx != 0) if need_dx
           else torch.zeros((), dtype=torch.bool))
    worst = float(dx[odd].float().abs().max()) if bool(odd.any()) else 0.0

    def call():
        return warp_sample_backward(g, flow, x_shape, x, need_dx)

    # host work dominates these calls and the host is shared: 50 calls
    ms = cuda_ms(call, iters=50)
    dev_ms, kernel_ms = call_device_ms(
        call, warp_sample_backward, KERNEL_TAGS["warp_sample_backward"])
    plain_ms = cuda_ms(lambda: warp_sample_backward_plain(
        g, flow, x_shape, x), iters=3)
    # the library yardstick: grid_sample's backward on the same coordinates
    inp = (x if x is not None else torch.zeros(x_shape, dtype=g.dtype,
                                               device=g.device))
    inp = inp.permute(0, 3, 1, 2)
    g_nchw = g.permute(0, 3, 1, 2)
    grid = _library_grid((h, w), flow, g.dtype)
    mask = [need_dx, x is not None]
    library_ms = cuda_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
        g_nchw, inp, grid, 0, 0, False, mask), iters=50)
    # bytes: flow and g in, dx out; x in and dflow out when dflow is asked
    nbytes = _nbytes(flow, g)
    flops = 0
    if need_dx:
        nbytes += n * h * w * c * g.element_size()
        flops += 8 * g.numel()      # four multiply-adds per value
    if x is not None:
        nbytes += _nbytes(x, flow)
        flops += 14 * g.numel()     # corner differences and their weights
    b_ms, b_by = bound_ms(nbytes, flops, torch.float32)
    log(f"K1-bwd {name}: g {tuple(g.shape)} {g.dtype} -> "
        + " + ".join((["dx " + str(tuple(x_shape))] if need_dx else [])
                     + (["dflow"] if x is not None else []))
        + f"; dead {n_dead}; max_abs_err "
        + ", ".join(f"{k} {err[k]:.3e} (limit {limit[k]:.3e})" for k in err)
        + f"; plain-zero dx entries nonzero here {int(odd.sum())} (max "
        f"{worst:.3e}); call {ms:.4f} ms, device {_ms(dev_ms)} (kernel "
        f"{_ms(kernel_ms)}), "
        f"plain {plain_ms:.4f} ms, grid_sampler_2d_backward "
        f"{library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(case=name, max_abs_err=max(err.values()),
                tolerance=max(limit.values()), ms=ms, device_ms=dev_ms,
                kernel_ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
                nbytes=nbytes, flops=flops, peak=torch.float32)


def _far_flow(gen, n, ho, wo, amp, dev):
    """Independent random flow vectors of up to +-amp pixels, so each
    point's corners land far from its neighbours'."""
    return (torch.rand((n, ho, wo, 2), generator=gen, device=dev) * 2
            - 1) * amp


def phase_k1_backward(dev):
    gen = torch.Generator(device=dev).manual_seed(6)
    cases = []
    # name, x (n, h, w, c), output grid (ho, wo), flow maker and amplitude,
    # dtype, whether dflow is asked for
    for name, (n, h, w, c), (ho, wo), (make, amp), dt, dflow in (
            ("train feat f32", (TRAIN_BATCH, 128, 128, 49), (128, 128),
             (_smooth_flow, 6.0), torch.float32, True),
            ("train up f32", (TRAIN_BATCH, 256, 256, 48), (256, 256),
             (_smooth_flow, 12.0), torch.float32, True),
            ("serve feat bf16", (N, H, W, 49), (H, W), (_smooth_flow, 6.0),
             torch.bfloat16, True),
            # the training step's UP warp of the low-res features
            ("train up low-res to 2x f32", (TRAIN_BATCH, 128, 128, 48),
             (256, 256), (_smooth_flow, 12.0), torch.float32, False),
            ("train feat far flow f32", (TRAIN_BATCH, 128, 128, 49),
             (128, 128), (_far_flow, 40.0), torch.float32, True)):
        x = (torch.rand((n, h, w, c), generator=gen, device=dev) * 2 - 1)
        flow = _poison(make(gen, n, ho, wo, amp, dev), gen)
        g = torch.rand((n, ho, wo, c), generator=gen, device=dev) * 2 - 1
        cases.append(k1_bwd_case(name, g.to(dt), flow.to(dt), tuple(x.shape),
                                 x.to(dt) if dflow else None,
                                 need_dead=True))
        del x, flow, g
    return cases


# ---------------------------------------------------------------- K2


def _k2_inputs(gen, n, l_ref, l_lr, d, dup, dtype, dev):
    """Unit patch rows; the last `dup` ref rows repeat the first ones (ties
    the kernel must resolve to the lower index) and the first `dup` LR rows
    lean toward them, so the ties are hit."""
    ref = torch.randn((n, l_ref, d), generator=gen, device=dev)
    ref[:, -dup:] = ref[:, :dup]
    lr = torch.randn((n, l_lr, d), generator=gen, device=dev)
    lr[:, :dup] += 4 * ref[:, :dup]
    ref = torch.nn.functional.normalize(ref, dim=2).to(dtype).contiguous()
    lr = torch.nn.functional.normalize(lr, dim=2).to(dtype).contiguous()
    return ref, lr


# ragged sizes for K2's planted ties (refvsr_tpu_torch.bench.ties), not
# multiples of any tile: (n, L_ref, L_lr, D)
K2_TIE_SHAPE = (3, 1000, 3001, 144)


def k2_case(name, ref, lr, dup=0, first=(), iters=5, plain_iters=2):
    """K2 kernel vs plain on one input; returns a dict of its numbers.
    conf within 1e-4; the kernel's pick scores within 1e-4 of the max (so
    picks may differ only where the top-2 gap is <= 1e-4); the last `dup`
    ref rows, copies of the first ones, never win; LR row i picks
    `first[i]`."""
    from refvsr_tpu_torch.ops.kernels.argmax_matmul import (
        argmax_matmul, argmax_matmul_plain)
    n, l_ref, d = ref.shape
    l_lr = lr.shape[1]
    conf, idx = argmax_matmul(ref, lr)
    conf_p, idx_p = argmax_matmul_plain(ref, lr)
    torch.cuda.synchronize()
    check(conf.dtype == torch.float32 and idx.dtype == torch.int32
          and conf.shape == (n, l_lr) and idx.shape == (n, l_lr),
          f"K2 {name}: output shape/dtype")
    check(bool(((idx >= 0) & (idx < l_ref)).all()),
          f"K2 {name}: index out of range")
    err = float((conf - conf_p).abs().max())
    check(err <= 1e-4, f"K2 {name}: max |conf - plain| {err} > 1e-4")
    # the score of the kernel's pick, in f32, one batch at a time
    gap = 0.0
    for b in range(n):
        score = (ref[b].float()[idx[b].long()] * lr[b].float()).sum(-1)
        gap = max(gap, float((conf_p[b] - score).max()))
    check(gap <= 1e-4, f"K2 {name}: a pick scores {gap} below the max")
    n_diff = int((idx != idx_p).sum())
    if dup:
        late = int((idx >= l_ref - dup).sum())
        check(late == 0, f"K2 {name}: {late} ties went to the later "
              f"duplicate")
    if first:
        want = torch.tensor(first, dtype=torch.int32, device=idx.device)
        got = idx[:, :len(first)]
        check(bool((got == want).all()), f"K2 {name}: planted ties picked "
              f"{got.tolist()}, not {list(first)}")
    ms = cuda_ms(lambda: argmax_matmul(ref, lr), iters=iters)
    plain_ms = cuda_ms(lambda: argmax_matmul_plain(ref, lr),
                       iters=plain_iters, warmup=1)
    # the library yardstick, two calls: the whole similarity by matmul, then
    # its row max; only where that matrix fits beside the inputs
    sim_bytes = n * l_lr * l_ref * ref.element_size()
    library_ms = None
    if sim_bytes <= K2_LIBRARY_MAX_BYTES:
        library_ms = cuda_ms(lambda: torch.matmul(
            lr, ref.transpose(1, 2)).max(dim=2), iters=iters)
    elif sim_bytes / n <= K2_LIBRARY_MAX_BYTES:
        # 2n calls: one batch element's similarity fits, the whole does not
        def per_item():
            for b in range(n):
                torch.matmul(lr[b], ref[b].T).max(dim=1)
        library_ms = cuda_ms(per_item, iters=iters)
    nbytes = (ref.numel() + lr.numel()) * ref.element_size() + n * l_lr * 8
    # f32 runs three TF32 products per product (3xTF32)
    f32 = ref.dtype == torch.float32
    peak = "tf32" if f32 else ref.dtype
    flops = (3 if f32 else 1) * 2.0 * n * l_lr * l_ref * d
    b_ms, b_by = bound_ms(nbytes, flops, peak)
    lib = ("not run: the similarity would be "
           f"{sim_bytes / 1e9:.1f} GB" if library_ms is None
           else f"{library_ms:.3f} ms" + (
               f" (one batch element at a time, {2 * n} calls)"
               if sim_bytes > K2_LIBRARY_MAX_BYTES else ""))
    log(f"K2 {name}: ref {tuple(ref.shape)} x lr {tuple(lr.shape)} "
        f"{ref.dtype}; max_abs_err {err:.3e} (limit 1e-4); indices "
        f"differing from plain {n_diff} (all within 1e-4 of the max; worst "
        f"{gap:.3e}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, matmul + "
        f"max {lib}, bound {b_ms:.4f} ms ({b_by}, {peak})")
    return dict(case=name, max_abs_err=err, tolerance=1e-4, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                bound_by=b_by, index_differs=n_diff, nbytes=nbytes,
                flops=flops, peak=peak)


def phase_k2(dev):
    gen = torch.Generator(device=dev).manual_seed(2)
    l_ref, l_lr, d, dup = K2_SHAPE
    ref, lr = _k2_inputs(gen, 1, l_ref, l_lr, d, dup, torch.bfloat16, dev)
    cases = [k2_case("synthetic bf16", ref, lr, dup=dup)]
    del ref, lr
    ref, lr, first = tied_rows(np.random.default_rng(2), *K2_TIE_SHAPE)
    for dt in (torch.bfloat16, torch.float32):
        cases.append(k2_case(f"ties {str(dt)[6:]}",
                             torch.from_numpy(ref).to(dev, dt),
                             torch.from_numpy(lr).to(dev, dt),
                             first=first.tolist()))
    return cases


def k2_bwd_case(name, ref, lr, index, g, needs=(True, True), dup=0):
    """K2 backward kernel vs its plain backward on the card (the arguments
    of ``argmax_matmul_backward``); returns a dict of its numbers. d_lr is
    one f32 product rounded once in both, so within 1e-6 of its largest
    magnitude; d_ref within 1e-5 of it in f32 and 2**-7 in bf16 (f32
    atomics in another order, then one rounding). A gradient that `needs`
    (for ref, lr) does not ask for must be None. The last `dup` ref rows
    never won, so they get exact zeros."""
    from refvsr_tpu_torch.ops.kernels.argmax_matmul import (
        argmax_matmul_backward, argmax_matmul_backward_plain)
    n, l_ref, d = ref.shape
    d_ref, d_lr = argmax_matmul_backward(ref, lr, index, g, needs)
    d_ref_p, d_lr_p = argmax_matmul_backward_plain(ref, lr, index, g)
    torch.cuda.synchronize()
    tol = {"d_lr": 1e-6,
           "d_ref": 1e-5 if ref.dtype == torch.float32 else 2.0 ** -7}
    err, limit = {}, {}
    for label, got, want, need in (("d_lr", d_lr, d_lr_p, needs[1]),
                                   ("d_ref", d_ref, d_ref_p, needs[0])):
        check((got is not None) == need,
              f"K2-bwd {name}: {label} given where not asked, or missing")
        if not need:
            continue
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"K2-bwd {name}: {label} shape/dtype")
        check(_finite(got), f"K2-bwd {name}: {label} is not finite")
        err[label] = float((got.float() - want.float()).abs().max())
        limit[label] = tol[label] * float(want.float().abs().max())
        check(err[label] <= limit[label], f"K2-bwd {name}: max |kernel - "
              f"plain| of {label} {err[label]} > {limit[label]}")
    if dup and needs[0]:
        check(bool((d_ref[:, -dup:] == 0).all()),
              f"K2-bwd {name}: duplicated ref rows got a gradient")

    def call():
        return argmax_matmul_backward(ref, lr, index, g, needs)

    ms = cuda_ms(call, iters=50)    # as for K1-bwd: mostly host work
    dev_ms, kernel_ms = call_device_ms(
        call, argmax_matmul_backward, KERNEL_TAGS["argmax_matmul_backward"])
    plain_ms = cuda_ms(lambda: argmax_matmul_backward_plain(ref, lr, index,
                                                            g), iters=3)
    # the library yardstick, two calls: the picked ref rows' gather and the
    # scatter-add of the LR rows into d_ref
    rows = (index.long() + torch.arange(n, device=ref.device)[:, None]
            * l_ref).reshape(-1)
    ref_flat, lr_flat = ref.reshape(-1, d), lr.reshape(-1, d)
    acc = torch.zeros_like(ref_flat)

    def library():
        if needs[1]:
            ref_flat.index_select(0, rows)
        if needs[0]:
            acc.index_add_(0, rows, lr_flat)

    library_ms = cuda_ms(library, iters=50)
    # bytes: index and g in; the picked ref rows in and d_lr out for d_lr;
    # lr in and d_ref out for d_ref
    picked = int(torch.unique(rows).numel())
    es = ref.element_size()
    nbytes = _nbytes(index, g)
    flops = 0
    if needs[1]:
        nbytes += picked * d * es + _nbytes(d_lr)
        flops += lr.numel()
    if needs[0]:
        nbytes += _nbytes(lr, d_ref)
        flops += 2 * lr.numel()
    b_ms, b_by = bound_ms(nbytes, flops, torch.float32)
    lib = " + ".join(k for k, need in (("index_select", needs[1]),
                                       ("index_add_", needs[0])) if need)
    log(f"K2-bwd {name}: ref {tuple(ref.shape)}, lr {tuple(lr.shape)} "
        f"{ref.dtype}; {picked} ref rows picked; max_abs_err "
        + ", ".join(f"{k} {err[k]:.3e} (limit {limit[k]:.3e})" for k in err)
        + f"; call {ms:.4f} ms, device {_ms(dev_ms)} (kernel "
        f"{_ms(kernel_ms)}), plain "
        f"{plain_ms:.4f} ms, {lib} {library_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by})")
    return dict(case=name, max_abs_err=max(err.values()),
                tolerance=max(limit.values()), ms=ms, device_ms=dev_ms,
                kernel_ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
                nbytes=nbytes, flops=flops, peak=torch.float32)


def phase_k2_backward(dev):
    from refvsr_tpu_torch.ops.kernels.argmax_matmul import argmax_matmul
    gen = torch.Generator(device=dev).manual_seed(7)
    cases = []
    for name, (n, l_ref, l_lr, d, dup), dt in (
            ("train f32", K2_TRAIN_SHAPE, torch.float32),
            ("serve bf16", (1, *K2_SHAPE), torch.bfloat16)):
        ref, lr = _k2_inputs(gen, n, l_ref, l_lr, d, dup, dt, dev)
        _, index = argmax_matmul(ref, lr)
        check(int((index >= l_ref - dup).sum()) == 0,
              f"K2-bwd {name}: a tie went to the later duplicate")
        g = torch.randn((n, l_lr), generator=gen, device=dev)
        cases.append(k2_bwd_case(name, ref, lr, index, g, dup=dup))
        if name == "train f32":
            # every LR row of a batch item picks one ref row: all of its
            # reductions meet on one row of d_ref
            one = torch.full_like(index, l_ref // 2)
            cases.append(k2_bwd_case("train f32, one ref row takes all",
                                     ref, lr, one, g))
            # only lr_p requires grad: no d_ref is made
            cases.append(k2_bwd_case("train f32, lr_p's gradient only", ref,
                                     lr, index, g, needs=(False, True)))
        del ref, lr, index, g
    return cases


# ------------------------------------------------- K3 and K4 (microbenchmarks)


def phase_microbench(card):
    """K3's and K4's paths: their microbenchmark entry points at the default
    sizes, each driven with every launch count set to 0 just before and
    read just after; then K3 at ragged shapes and K4's check mode, whose
    launches only compare the kernels with their plain versions. Returns
    (launches by path, {kernel: (default-size numbers, every case)})."""
    from refvsr_tpu_torch.bench import microbench_conv, microbench_gather
    launches, main = {}, {}
    for path, run in (("microbench_conv", microbench_conv.run),
                      ("microbench_gather", microbench_gather.run)):
        reset_launches()
        main[path] = run(log=log)
        launches[path] = read_launches()
        name = BENCH_FNS[path]
        check(launches[path][name] > 0 and not any(
            v for k, v in launches[path].items() if k != name),
            f"{path}: launches {launches[path]}")
    conv, gather = main["microbench_conv"], main["microbench_gather"]
    conv_cases = [conv] + [microbench_conv.run(
        size, c, iters=3, trace=False, log=log) for size, c in K3_RAGGED]
    for case in conv_cases:
        check(case["finite"] and case["ratio"] <= 1.0,
              f"K3 {case['shape']}: |kernel - plain| at {case['ratio']:.3f} "
              f"of the envelope 2^-7 |plain| + 2^-8 max|plain|")
    check(gather["equal"], "K4 at the default size: kernel != plain")
    gather_cases = [gather] + microbench_gather.check(log=log)
    check(all(c["equal"] for c in gather_cases),
          "K4: kernel != plain in a check case")
    check(any(c.get("clamped") for c in gather_cases),
          "K4: no case clamped an index")
    torch.cuda.empty_cache()
    log(json.dumps(dict(microbench=dict(
        card=card, launches=launches, conv=conv, gather=gather))))
    return launches, {"conv3x3_bias": (conv, conv_cases),
                      "gather_rows": (gather, gather_cases)}


# ---------------------------------------------------------------- nets


def phase_small_agreement(dev):
    """The port on the card (f32; kernels) against the port on the CPU
    (f32; plain versions) at a small input: first + one stream window."""
    from refvsr_tpu_torch.configs import get_config
    from refvsr_tpu_torch.eval.stream import StreamRunner
    from refvsr_tpu_torch.models.refvsr import build_refvsr
    cfg = get_config("RefVSR_MFID_8K", num_blocks=2)
    net = build_refvsr(cfg, device="cpu", seed=3)
    gen = torch.Generator().manual_seed(4)
    lrs = torch.rand((1, 4, 32, 48, 3), generator=gen)
    refs = torch.rand((1, 4, 32, 48, 3), generator=gen)
    worst = 0.0
    runners = [StreamRunner(net, None, device=d) for d in ("cpu", dev)]
    for wi in range(2):
        outs = [r.process(lrs[:, wi:wi + 3], refs[:, wi:wi + 3],
                          is_first=wi == 0)[0] for r in runners]
        worst = max(worst, float(abs(outs[0] - outs[1]).max()))
    check(worst <= 1e-3, f"small net: card vs CPU max diff {worst} > 1e-3")
    log(f"small net (RefVSR_MFID_8K widths, 2 blocks, 32x48, f32): card vs "
        f"CPU max_abs_diff {worst:.3e} (limit 1e-3)")


def synthetic_batch(cfg, seed):
    """A seeded training batch with the HD-in geometry of the JAX package's
    data/datasets.py: LR_UW p^2, LR_REF_W (2p)^2, HR_UW p^2, HR_REF_T
    (4p)^2, each (b, frame_num + frame_itr_num - 1, side, side, 3)."""
    rng = np.random.default_rng(seed)
    n, p = cfg.batch_size, cfg.patch_size
    t = cfg.frame_num + cfg.frame_itr_num - 1

    def img(side):
        return rng.random((n, t, side, side, 3), dtype=np.float32)
    return {"LR_UW": img(p), "LR_REF_W": img(2 * p), "HR_UW": img(p),
            "HR_REF_T": img(4 * p)}


def window(arrays, i, t):
    """Window i of a batch (as Trainer.iteration slices it): lrs, refs,
    the centre HR frame and the ref frames seen so far."""
    return (arrays["LR_UW"][:, i:i + t], arrays["LR_REF_W"][:, i:i + t],
            arrays["HR_UW"][:, i + t // 2], arrays["HR_REF_T"][:, :i + t])


# the kernels of the stream and training paths; K3 and K4 run only on the
# microbenchmark paths
KERNEL_FNS = ("warp_sample", "warp_sample_backward", "argmax_matmul",
              "argmax_matmul_backward")
BENCH_FNS = {"microbench_conv": "conv3x3_bias",
             "microbench_gather": "gather_rows"}


def _kernel_fns():
    from refvsr_tpu_torch.ops.kernels import argmax_matmul as k2
    from refvsr_tpu_torch.ops.kernels import conv3x3 as k3
    from refvsr_tpu_torch.ops.kernels import gather_rows as k4
    from refvsr_tpu_torch.ops.kernels import warp_sample as k1
    return {"warp_sample": k1.warp_sample,
            "warp_sample_backward": k1.warp_sample_backward,
            "argmax_matmul": k2.argmax_matmul,
            "argmax_matmul_backward": k2.argmax_matmul_backward,
            "conv3x3_bias": k3.conv3x3_bias,
            "gather_rows": k4.gather_rows}


def reset_launches():
    for fn in _kernel_fns().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in _kernel_fns().items()}


def phase_small_training(dev):
    """One training step of a tiny RefVSR_MFID_8K-wired trainer (2 blocks,
    8 channels, T = 3, patch 16, batch 1, f32, TF32 off) on the card with
    the kernels against the same on the CPU with the plain versions, from
    the same seeded weights and window. Tolerances: L1_lf, total and PSNR
    rtol 1e-4; the contextual (MFID) term rtol 5e-3, because it divides
    each cosine distance by its row's smallest one: on the CPU it moves by
    2e-4 to 8e-4 relative when the SR frame or its VGG features are
    perturbed by 1e-7 to 1e-6 relative. Each gradient within 2e-3 of its
    largest CPU magnitude plus 1e-6 (about 60 f32 layers summed in another
    order, as the CPU tests allow against the JAX package; a 1e-6 relative
    perturbation of the SR frame moves them by up to 5.4e-4 of it)."""
    from refvsr_tpu_torch.losses import cx_options
    from refvsr_tpu_torch.configs import get_config
    from refvsr_tpu_torch.models.refvsr import init_stream_state
    from refvsr_tpu_torch.train.trainer import Trainer
    cfg = get_config("RefVSR_MFID_8K", num_blocks=2, mid_channels=8,
                     frame_num=3, frame_itr_num=1, patch_size=16,
                     batch_size=1, **NO_ASSETS)
    batch = synthetic_batch(cfg, seed=8)
    res = {}
    for d in ("cpu", dev):
        tr = Trainer(cfg, device=d, seed=3)
        state = init_stream_state(1, cfg.patch_size, cfg.patch_size,
                                  cfg.mid_channels,
                                  num_frames=cfg.frame_num, device=d)
        win = [torch.from_numpy(np.ascontiguousarray(a)).to(d)
               for a in window(batch, 0, cfg.frame_num)]
        reset_launches()
        errs, _, _, grads = tr.gradients(state, *win)
        launches = read_launches()
        names = [k for k, p in tr.net.named_parameters() if p.requires_grad]
        res[d] = ({k: float(v.detach()) for k, v in errs.items()},
                  {k: None if g is None else g.detach().cpu()
                   for k, g in zip(names, grads)}, launches)
    (errs_c, grads_c, _), (errs_g, grads_g, launches) = res["cpu"], res[dev]
    check(all(launches[k] > 0 for k in KERNEL_FNS),
          f"small training: a kernel was not launched on the card "
          f"{launches}")
    check(set(errs_c) == set(errs_g) and set(grads_c) == set(grads_g),
          "small training: loss or parameter sets differ")
    bad = []
    for k, v in errs_c.items():
        rtol = 5e-3 if cx_options(k) is not None else 1e-4
        if abs(errs_g[k] - v) > rtol * abs(v):
            bad.append(f"loss {k} card {errs_g[k]} vs CPU {v} (rtol {rtol})")
    worst, worst_k = 0.0, None
    for k, gc in grads_c.items():
        gg = grads_g[k]
        if (gc is None) != (gg is None):
            bad.append(f"{k} has a gradient on one side only")
            continue
        if gc is None:
            continue
        err = float((gg - gc).abs().max())
        rel = err / (2e-3 * float(gc.abs().max()) + 1e-6)
        if rel > 1:
            bad.append(f"gradient {k}: card vs CPU {err} at {rel:.2f} of "
                       f"its limit")
        if rel > worst:
            worst, worst_k = rel, k
    log(f"small training step (RefVSR_MFID_8K wiring, 2 blocks, 8 ch, T=3, "
        f"patch 16, f32): losses "
        + ", ".join(f"{k} {errs_g[k]:.6g}/{errs_c[k]:.6g}" for k in errs_c)
        + f" (card/CPU); {len(grads_c)} gradients, worst at {worst:.3f} of "
        f"its limit ({worst_k}); card launches {launches}")
    check(not bad, "small training: " + "; ".join(bad))


@contextlib.contextmanager
def capturing(module, name, calls, new_shapes_only=None, when=None):
    """Route `module.name` (a kernel wrapper as its caller looks it up)
    through a spy that keeps (args, kwargs), tensors detached and cloned,
    of each call in `calls`. Given a set `new_shapes_only`, it keeps only
    the first call of each argument shape not yet in the set, and adds that
    shape; given a callable `when`, only calls made while it returns True.
    The wrapper runs unchanged, and its launch count stays its own:
    a wrapper that counts through its module's name reaches the spy, which
    passes ``launches`` on to it."""
    fn = getattr(module, name)

    class Spy:
        def __call__(self, *args, **kw):
            key = _shape_key(args)
            if when is not None and not when():
                pass
            elif new_shapes_only is None or key not in new_shapes_only:
                if new_shapes_only is not None:
                    new_shapes_only.add(key)
                calls.append((tuple(_clone(a) for a in args),
                              {k: _clone(v) for k, v in kw.items()}))
            return fn(*args, **kw)

        @property
        def launches(self):
            return fn.launches

        @launches.setter
        def launches(self, n):
            fn.launches = n

    setattr(module, name, Spy())
    try:
        yield
    finally:
        setattr(module, name, fn)


def _clone(v):
    return v.detach().clone() if torch.is_tensor(v) else v


def to_host(*call_sets):
    """Move the tensors of captured calls ({kernel: [(args, kwargs)]}) to
    the host, in place, so that the card holds none of them while later
    phases run; path_cases moves each call back for its comparison."""
    def host(v):
        return v.cpu() if torch.is_tensor(v) else v
    for calls_by_name in call_sets:
        for calls in calls_by_name.values():
            for i, (args, kw) in enumerate(calls):
                calls[i] = (tuple(host(a) for a in args),
                            {k: host(v) for k, v in kw.items()})


def _shape_key(args):
    return tuple((tuple(a.shape), a.dtype) if torch.is_tensor(a) else repr(a)
                 for a in args)


KERNEL_TAGS = {"warp_sample": "warp_sample_kernel",
               "warp_sample_backward": "warp_sample_backward_kernel",
               "argmax_matmul": "argmax_matmul_kernel",
               "argmax_matmul_backward": "argmax_matmul_backward_kernel"}


# the backward launchers clear their f32 output (dx, d_ref) with a memset
# on the stream just before the kernel
CLEARED = ("warp_sample_backward", "argmax_matmul_backward")


def _clears(prof, tag):
    """(ms, count) of the memsets that come just before a launch of the
    kernel `tag` on its stream in a finished torch.profiler trace."""
    dev = sorted((ev for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda ev: ev.time_range.start)
    last, ms, n = {}, 0.0, 0
    for ev in dev:
        stream = getattr(ev, "device_resource_id", None)
        prev = last.get(stream)
        if tag in ev.name and prev is not None and "Memset" in prev.name:
            ms += prev.time_range.elapsed_us() / 1e3
            n += 1
        last[stream] = ev
    return ms, n


def device_profile(prof, names, what, wall_ms, card, top=0):
    """Device ms and launches of the kernels `names` in a finished
    torch.profiler trace (a backward kernel's with its launcher's clears),
    the device's busy time and idle share, and optionally the `top` kernels
    by device time."""
    events = [ev for ev in prof.key_averages()
              if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(ev.self_device_time_total for ev in events) / 1e3
    out = {}
    for name in names:
        mine = [ev for ev in events if KERNEL_TAGS[name] in ev.key]
        ms = sum(ev.self_device_time_total for ev in mine) / 1e3
        n = sum(ev.count for ev in mine)
        check(ms > 0 and n > 0, f"{what}: no device time for {name}")
        out[name] = dict(ms=ms, launches=n, kernel_ms=ms)
        if name in CLEARED:
            clear_ms, cleared = _clears(prof, KERNEL_TAGS[name])
            check(cleared == n, f"{what}: {cleared} clears found before "
                  f"{n} launches of {name}")
            out[name].update(ms=ms + clear_ms, clear_ms=clear_ms)
    idle = max(0.0, 1 - busy / wall_ms)
    log(f"profiled {what}: host {wall_ms:.1f} ms, device busy {busy:.1f} ms, "
        f"idle share {idle:.3f}; "
        + "; ".join(f"{k} {v['ms']:.4f} ms in {v['launches']} launches"
                    + (f" (kernel {v['kernel_ms']:.4f}, clears "
                       f"{v['clear_ms']:.4f})" if "clear_ms" in v else "")
                    for k, v in out.items()) + f"  [{card}]")
    if top:
        log(f"{'ms':>10} {'share':>6} {'calls':>6}  kernel ({what})")
        for ev in sorted(events, key=lambda e: -e.self_device_time_total)[
                :top]:
            ms = ev.self_device_time_total / 1e3
            log(f"{ms:10.3f} {ms / busy:6.3f} {ev.count:6d}  {ev.key[:100]}")
    return out, dict(wall_ms=wall_ms, busy_ms=busy, idle_share=idle)


def profiled_window(runner, lrs, refs, card):
    """One forward_stream window traced by torch.profiler: device ms and
    launches of each hand-written kernel inside the main path."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.process_device(lrs, refs, is_first=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return device_profile(prof, ("warp_sample", "argmax_matmul"),
                          "forward_stream window", wall_ms, card)[0]


def phase_main_path(dev, card):
    from refvsr_tpu_torch.configs import get_config
    from refvsr_tpu_torch.eval.stream import StreamRunner
    from refvsr_tpu_torch.models import matching as matching_mod
    from refvsr_tpu_torch.models.refvsr import build_refvsr
    from refvsr_tpu_torch.ops import warp as warp_mod
    from refvsr_tpu_torch.ops.kernels.argmax_matmul import argmax_matmul
    from refvsr_tpu_torch.ops.kernels.warp_sample import warp_sample

    cfg = get_config("RefVSR_MFID_8K")
    check((cfg.scale, cfg.num_blocks, cfg.mid_channels, cfg.flag_HD_in,
           cfg.matching_ksize) == (4, 30, 48, True, 8), f"config {cfg}")
    net = build_refvsr(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    runner = StreamRunner(net, cfg.reset_branch, device=dev,
                          compute_dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(5)
    # the counted windows, then a profiled and a captured streamed window
    frames = T + STREAM_WINDOWS + 2
    lrs = torch.rand((N, frames, H, W, 3), generator=gen,
                     device=dev).bfloat16()
    refs = torch.rand((N, frames, H, W, 3), generator=gen,
                      device=dev).bfloat16()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    windows = []
    out = None
    for wi in range(STREAM_WINDOWS + 1):
        k1_0, k2_0 = warp_sample.launches, argmax_matmul.launches
        t0 = time.perf_counter()
        out, _ = runner.process_device(lrs[:, wi:wi + T], refs[:, wi:wi + T],
                                       is_first=wi == 0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        k1 = warp_sample.launches - k1_0
        k2 = argmax_matmul.launches - k2_0
        kind = "forward_first" if wi == 0 else "forward_stream"
        windows.append(dict(kind=kind, ms=ms, k1=k1, k2=k2))
        log(f"window {wi} ({kind}): {ms:.1f} ms, K1 launches {k1}, "
            f"K2 launches {k2}  [{card}]")
        want = (16, 1) if wi == 0 else (10, 1)
        check((k1, k2) == want, f"window {wi}: launches {(k1, k2)} != {want}")
    launches = read_launches()
    check(launches["warp_sample_backward"] == 0
          and launches["argmax_matmul_backward"] == 0,
          "streaming launched a backward kernel")
    check(not any(launches[k] for k in BENCH_FNS.values()),
          "streaming launched K3 or K4")
    peak = torch.cuda.max_memory_allocated()

    check(tuple(out.shape) == (N, 4 * H, 4 * W, 3),
          f"output shape {tuple(out.shape)}")
    check(_finite(out), "output has non-finite values")
    std = float(out.float().std())
    check(std > 0, "output is constant")
    st = runner.state
    for name in ("feat_prop", "feat_prop_up", "conf_prop", "flow",
                 "flows_fwd", "flows_bwd", "conf_tail", "aligned_tail",
                 "aligned_up_tail"):
        check(_finite(getattr(st, name)), f"state {name} is not finite")
    stream_ms = [w["ms"] for w in windows[1:]]
    log(f"main path: output {tuple(out.shape)} bf16, std {std:.4f}; "
        f"forward_first {windows[0]['ms']:.1f} ms; forward_stream "
        f"{sum(stream_ms) / len(stream_ms):.1f} ms/window (mean of "
        f"{len(stream_ms)}); peak allocated {peak / 2**30:.2f} GiB  [{card}]")

    # the kernels inside the path: device time of one more streamed window,
    # traced; then the inputs the path hands each kernel, captured in a
    # further streamed window and in a new first window (once for each
    # shape the streamed window lacks: K1's low-res features onto the 2x
    # grid, K2 at batch T), for the comparisons with the plain versions
    wi = STREAM_WINDOWS + 1
    in_path = profiled_window(runner, lrs[:, wi:wi + T], refs[:, wi:wi + T],
                              card)
    stream_calls = {"warp_sample": [], "argmax_matmul": []}
    first_calls = {"warp_sample": [], "argmax_matmul": []}
    wi += 1
    with capturing(warp_mod, "warp_sample", stream_calls["warp_sample"]), \
            capturing(matching_mod, "argmax_matmul",
                      stream_calls["argmax_matmul"]):
        runner.process_device(lrs[:, wi:wi + T], refs[:, wi:wi + T],
                              is_first=False)
    seen = {k: {_shape_key(a) for a, _ in v} for k, v in stream_calls.items()}
    with capturing(warp_mod, "warp_sample", first_calls["warp_sample"],
                   seen["warp_sample"]), \
            capturing(matching_mod, "argmax_matmul",
                      first_calls["argmax_matmul"], seen["argmax_matmul"]):
        runner.process_device(lrs[:, :T], refs[:, :T], is_first=True)
    torch.cuda.synchronize()
    del runner, net, lrs, refs, out, st
    torch.cuda.empty_cache()
    check([len(v) for v in stream_calls.values()] == [10, 1],
          "captured streamed window: launches != (10, 1)")
    check([len(v) for v in first_calls.values()] == [1, 1],
          "captured first window: shapes new to it != (1, 1)")
    return launches, windows, peak, in_path, stream_calls, first_calls


def _scene(rng, h, w):
    """A seeded smooth image with noise, (h, w, 3) in [0, 1]."""
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    base = np.stack([np.sin(7 * xx + 3 * yy), np.cos(5 * yy - 2 * xx),
                     np.sin(4 * (xx + yy))], -1) * 0.4 + 0.5
    return np.clip(base + rng.normal(0, 0.03, (h, w, 3)), 0, 1)


def phase_serving(dev, card):
    """The serving path: Predictor.predict on a seeded 1080p PNG pair, the
    launches counted over SERVE_CALLS calls, the output checked, the PNG
    work timed apart; then the K1/K2 calls of one more predict captured.
    Returns (launches, summary, captured calls)."""
    import tempfile

    from refvsr_tpu_torch.configs import get_config
    from refvsr_tpu_torch.data.png import read_image, write_image
    from refvsr_tpu_torch.models import matching as matching_mod
    from refvsr_tpu_torch.ops import warp as warp_mod
    from refvsr_tpu_torch.serving.predictor import Predictor

    cfg = get_config("RefVSR_MFID_8K")
    rng = np.random.default_rng(10)
    calls = {"warp_sample": [], "argmax_matmul": []}
    with tempfile.TemporaryDirectory() as tmp:
        paths = [f"{tmp}/{name}.png" for name in ("lr", "ref")]
        for path in paths:
            write_image(path, _scene(rng, *SERVE_HW))
        out_path = f"{tmp}/out/sr.png"
        pred = Predictor(cfg, device=dev)
        check(pred.compute_dtype == torch.bfloat16 and pred.net.zero_flow,
              "serving: the predictor is not the bf16 zero-flow net")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launches()
        ms, per_call = [], []
        for _ in range(SERVE_CALLS):
            before = read_launches()
            t0 = time.perf_counter()
            pred.predict(*paths, out_path)
            ms.append((time.perf_counter() - t0) * 1e3)
            after = read_launches()
            per_call.append({k: after[k] - before[k] for k in after})
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() - base
        # the PNG work apart: the pair's decode, the output's encode
        t0 = time.perf_counter()
        imgs = [read_image(p) for p in paths]
        decode_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        out = pred.enhance(*imgs)
        enhance_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        write_image(out_path, out)
        encode_ms = (time.perf_counter() - t0) * 1e3
        sr = read_image(out_path)
        with capturing(warp_mod, "warp_sample", calls["warp_sample"]), \
                capturing(matching_mod, "argmax_matmul",
                          calls["argmax_matmul"]):
            pred.predict(*paths, out_path)
        torch.cuda.synchronize()
    # the predictor's crop: at most 720x1280, then down to a multiple of 8
    want = tuple(4 * (min(v, m) // 8 * 8) for v, m in zip(SERVE_HW,
                                                           (720, 1280)))
    check(sr.shape == (*want, 3), f"serving: output shape {sr.shape}")
    check(bool(np.isfinite(sr).all()), "serving: non-finite output")
    std = float(sr.std())
    check(std > 0, "serving: the output is constant")
    for i, n in enumerate(per_call):
        check((n["warp_sample"], n["argmax_matmul"]) == (8, 1)
              and not any(v for k, v in n.items()
                          if k not in ("warp_sample", "argmax_matmul")),
              f"serving: predict {i} launched {n}, not K1 8 and K2 1")
    check([len(v) for v in calls.values()] == [8, 1],
          "serving: captured predict's calls != (8, 1)")
    steady = ms[1:]
    summary = dict(card=card, ms=ms, ms_per_predict=sum(steady) / len(steady),
                   decode_ms=decode_ms, enhance_ms=enhance_ms,
                   encode_ms=encode_ms, peak_bytes=peak, base_bytes=base,
                   launches_per_predict=per_call[-1], output_std=std)
    log(f"serving path: Predictor (RefVSR_MFID_8K bf16, zero flow) on a "
        f"{SERVE_HW[0]}x{SERVE_HW[1]} PNG pair cropped to 720x1280 -> "
        f"{sr.shape}, std {std:.4f}; " + ", ".join(f"{m:.1f}" for m in ms)
        + f" ms per predict ({summary['ms_per_predict']:.1f} mean of calls "
        f"2-{len(ms)}); apart: decode of the pair {decode_ms:.1f} ms, "
        f"enhance {enhance_ms:.1f} ms, encode {encode_ms:.1f} ms; K1 "
        f"{per_call[-1]['warp_sample']} and K2 "
        f"{per_call[-1]['argmax_matmul']} launches per predict; peak "
        f"allocated {peak / 2**30:.2f} GiB above the "
        f"{base / 2**30:.2f} GiB held before  [{card}]")
    del pred, out
    torch.cuda.empty_cache()
    return launches, summary, calls


def _clamped_windows(lrs, refs, t):
    """(d, window) of each output frame d of a (N, F, ...) video: frames
    clip(d - t//2 .. d + t//2), the dataset's clamp at the clip's ends."""
    f, c = lrs.shape[1], t // 2
    for d in range(f):
        idx = torch.arange(d - c, d + c + 1).clamp(0, f - 1).to(lrs.device)
        yield d, lrs[:, idx], refs[:, idx]


def _drive(runner, lrs, refs, t, on_dispatch=None, flush_ctx=None):
    """Every (meta, sr) a runner emits over a video by submit and flush, in
    order, each frame moved to the host; on_dispatch(kind, ms, metas) after
    each call with its host ms around work that ends in a synchronize (kind:
    the window's frame d, or "flush", run inside `flush_ctx`)."""
    out = []

    def timed(kind, fn):
        t0 = time.perf_counter()
        emitted = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if on_dispatch is not None:
            on_dispatch(kind, ms, [m for m, _, _ in emitted])
        out.extend((m, sr.cpu()) for m, sr, _ in emitted)
    for d, wl, wr in _clamped_windows(lrs, refs, t):
        timed(d, lambda: runner.submit(wl, wr, d == 0, meta=d))
    with flush_ctx or contextlib.nullcontext():
        timed("flush", runner.flush)
    return out


def _pipe_small(dev):
    """Pipelined L = 2 on the card against plain on the card and pipelined
    on the CPU, tiny net in f32: the largest difference from each."""
    from refvsr_tpu_torch.configs import get_config
    from refvsr_tpu_torch.eval.stream import StreamRunner
    from refvsr_tpu_torch.models.refvsr import build_refvsr
    cfg = get_config("RefVSR_MFID_8K", num_blocks=2, mid_channels=8)
    gen = torch.Generator().manual_seed(11)
    lrs = torch.rand((1, 5, 32, 48, 3), generator=gen)
    refs = torch.rand((1, 5, 32, 48, 3), generator=gen)
    runs = {}
    for name, lanes, d in (("cpu", PIPE_LANES, "cpu"),
                           ("card", PIPE_LANES, dev), ("plain", 0, dev)):
        net = build_refvsr(cfg.replace(pipeline_lanes=lanes), device="cpu",
                           seed=3)
        runner = StreamRunner(net, None, device=d, pipeline_lanes=lanes)
        runs[name] = _drive(runner, lrs.to(d), refs.to(d), 7)
    metas = [[m for m, _ in runs[k]] for k in ("card", "plain", "cpu")]
    check(all(m == list(range(5)) for m in metas),
          f"pipelined small: metas {metas}")
    worst = {k: max(float((a.float() - b.float()).abs().max()) for (_, a),
                    (_, b) in zip(runs["card"], runs[k]))
             for k in ("plain", "cpu")}
    check(all(v <= 1e-4 for v in worst.values()),
          f"pipelined small: card vs plain / CPU {worst} > 1e-4")
    log(f"pipelined small (L={PIPE_LANES}, RefVSR_MFID_8K wiring, 2 blocks, "
        f"8 ch, T=7, 32x48, f32; first + prime + 3 steady + flush): card vs "
        f"plain on the card {worst['plain']:.3e}, vs the CPU "
        f"{worst['cpu']:.3e} (limit 1e-4)")
    return worst


def phase_pipelined(dev, card):
    """The small agreement, then plain and pipelined RefVSR_MFID_8K at full
    width on the same frames, in turn (plain first, each freed before the
    next): ms, launches and emitted frames of every dispatch, peaks, and
    each pipelined frame against plain's. The pipelined run's launches are
    counted from just before it to just after; its flush dispatch's K1/K2
    calls are captured. Returns (launches, summary, captured calls)."""
    from refvsr_tpu_torch.configs import get_config
    from refvsr_tpu_torch.eval.stream import StreamRunner
    from refvsr_tpu_torch.models import matching as matching_mod
    from refvsr_tpu_torch.models.refvsr import build_refvsr
    from refvsr_tpu_torch.ops import warp as warp_mod

    small = _pipe_small(dev)
    cfg = get_config("RefVSR_MFID_8K")
    gen = torch.Generator(device=dev).manual_seed(12)
    lrs = torch.rand((N, PIPE_FRAMES, H, W, 3), generator=gen,
                     device=dev).bfloat16()
    refs = torch.rand((N, PIPE_FRAMES, H, W, 3), generator=gen,
                      device=dev).bfloat16()
    calls = {"warp_sample": [], "argmax_matmul": []}
    runs = {}
    for lanes in (0, PIPE_LANES):
        net = build_refvsr(cfg.replace(pipeline_lanes=lanes), device=dev,
                           dtype=torch.bfloat16, seed=0)
        runner = StreamRunner(net, cfg.reset_branch, device=dev,
                              compute_dtype=torch.bfloat16,
                              pipeline_lanes=lanes)
        dispatches = []
        seen = {"warp_sample": 0, "argmax_matmul": 0}

        def record(kind, ms, metas):
            now = read_launches()
            dispatches.append(dict(
                kind=kind, ms=ms, emitted=metas,
                peak_bytes=torch.cuda.max_memory_allocated() - base,
                **{k: now[k] - seen[k] for k in seen}))
            seen.update({k: now[k] for k in seen})
        @contextlib.contextmanager
        def flush_capture():
            with capturing(warp_mod, "warp_sample", calls["warp_sample"]), \
                    capturing(matching_mod, "argmax_matmul",
                              calls["argmax_matmul"]):
                yield
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launches()
        out = _drive(runner, lrs, refs, T, record,
                     flush_capture() if lanes else None)
        # the peak above what was held before, through the last window
        # (the flush dispatch's captured inputs are not the path's)
        runs[lanes] = dict(out=out, dispatches=dispatches,
                           launches=read_launches(), base=base,
                           peak=dispatches[-2]["peak_bytes"])
        del runner, net
        torch.cuda.empty_cache()

    plain, piped = runs[0], runs[PIPE_LANES]
    for name, r in (("plain", plain), ("pipelined", piped)):
        n = r["launches"]
        check(not any(v for k, v in n.items()
                      if k not in ("warp_sample", "argmax_matmul")),
              f"{name} stream launched a kernel off its path: {n}")
        log(f"{name} stream, full width: " + "; ".join(
            f"{d['kind']}: {d['ms']:.1f} ms, K1 {d['warp_sample']}, K2 "
            f"{d['argmax_matmul']}, emits {d['emitted']}"
            for d in r["dispatches"]) + f"  [{card}]")
    # launches and emitted frames of each dispatch: plain, first then
    # streamed windows; pipelined, first, L - 1 primes, steady, flush
    want_plain = ([(16, 1, [0])] + [(10, 1, [d]) for d in
                                    range(1, PIPE_FRAMES)] + [(0, 0, [])])
    want_piped = ([(16, 1, [0])] + [(4, 1, [])] * (PIPE_LANES - 1)
                  + [(6, 1, [d - PIPE_LANES + 1]) for d in
                     range(PIPE_LANES, PIPE_FRAMES)]
                  + [(6, 1, [PIPE_FRAMES - 1])])
    for name, r, want in (("plain", plain, want_plain),
                          ("pipelined", piped, want_piped)):
        got = [(d["warp_sample"], d["argmax_matmul"], d["emitted"])
               for d in r["dispatches"]]
        check(got == want, f"{name} stream: (K1, K2, emitted) per "
              f"dispatch {got} != {want}")
    check([len(v) for v in calls.values()] == [6, 1],
          "pipelined: captured flush dispatch's calls != (6, 1)")
    diffs = []
    for (m, a), (m_p, b) in zip(piped["out"], plain["out"]):
        check(m == m_p and tuple(a.shape) == (N, 4 * H, 4 * W, 3),
              f"pipelined frame {m}: shape {tuple(a.shape)}")
        a, b = a.to(dev).float(), b.to(dev).float()
        check(_finite(a), f"pipelined frame {m}: non-finite values")
        d = (a - b).abs()
        diffs.append(dict(frame=m, max=float(d.max()), mean=float(d.mean())))
        del a, b, d
    worst_max = max(d["max"] for d in diffs)
    worst_mean = max(d["mean"] for d in diffs)
    check(worst_mean <= PIPE_MEAN_LIMIT and worst_max <= PIPE_MAX_LIMIT,
          f"pipelined vs plain: mean {worst_mean}, max {worst_max} "
          f"(limits {PIPE_MEAN_LIMIT}, {PIPE_MAX_LIMIT})")
    # steady: after the first steady dispatch; plain: after the first
    # streamed window
    steady = [d["ms"] for d in piped["dispatches"][PIPE_LANES + 1:-1]]
    stream = [d["ms"] for d in plain["dispatches"][2:-1]]
    summary = dict(
        card=card, lanes=PIPE_LANES, small=small,
        ms_per_dispatch=sum(steady) / len(steady),
        ms_per_plain_window=sum(stream) / len(stream),
        peak_bytes=piped["peak"], plain_peak_bytes=plain["peak"],
        base_bytes=piped["base"],
        dispatches=piped["dispatches"], plain_windows=plain["dispatches"],
        diff_vs_plain=diffs)
    log(f"pipelined stream (L={PIPE_LANES}, RefVSR_MFID_8K bf16, 1080p -> "
        f"4320x7680): {summary['ms_per_dispatch']:.1f} ms per steady "
        f"dispatch (mean of {len(steady)}) against "
        f"{summary['ms_per_plain_window']:.1f} ms per plain window (mean of "
        f"{len(stream)}); peak allocated {piped['peak'] / 2**30:.2f} GiB "
        f"against {plain['peak'] / 2**30:.2f}, above the "
        f"{piped['base'] / 2**30:.2f} GiB held before; vs plain per frame max "
        f"{worst_max:.3e}, mean {worst_mean:.3e} (limits {PIPE_MAX_LIMIT}, "
        f"{PIPE_MEAN_LIMIT})  [{card}]")
    del lrs, refs, runs
    torch.cuda.empty_cache()
    return piped["launches"], summary, calls


@contextlib.contextmanager
def cudnn_tf32(on):
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def phase_training(dev, card):
    """One Trainer.iteration at full width, then one more step profiled
    with every kernel's inputs captured. Returns (launches, summary,
    in-step kernel times, captured calls)."""
    from torch.profiler import ProfilerActivity, profile

    from refvsr_tpu_torch.configs import get_config
    from refvsr_tpu_torch.models import matching as matching_mod
    from refvsr_tpu_torch.ops import warp as warp_mod
    from refvsr_tpu_torch.ops.kernels import argmax_matmul as k2_mod
    from refvsr_tpu_torch.ops.kernels import warp_sample as k1_mod
    from refvsr_tpu_torch.train.trainer import Trainer

    cfg = get_config("RefVSR_MFID_8K", batch_size=TRAIN_BATCH, **NO_ASSETS)
    check((cfg.num_blocks, cfg.mid_channels, cfg.flag_HD_in,
           cfg.matching_ksize, cfg.is_use_T, cfg.is_amp, cfg.loss,
           cfg.CX_vgg_layer, cfg.patch_size, cfg.frame_num,
           cfg.frame_itr_num, cfg.gc, cfg.LRS)
          == (30, 48, True, 8, True, False, "1*L1_lf+0.1*MFID_ref",
              "relu4_4", 128, 7, 9, 1.0, "CA"), f"training config {cfg}")
    batch = synthetic_batch(cfg, seed=9)
    tr = Trainer(cfg, device=dev, seed=0)
    trained0 = [p.detach().clone() for p in tr.params]
    frozen0 = {f"FlowNet.{k}": v.clone()
               for k, v in tr.net.FlowNet.state_dict().items()}
    frozen0.update({f"loss.{k}": v.clone()
                    for k, v in tr.loss_mod.state_dict().items()})

    step_ms = []
    train_step = tr.train_step

    def timed_step(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_step(*args)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    tr.train_step = timed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    means, state = tr.iteration(batch)
    torch.cuda.synchronize()
    iter_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    del tr.train_step

    check(len(step_ms) == cfg.frame_itr_num == len(tr.window_errs),
          f"iteration ran {len(step_ms)} steps")
    for i, errs in enumerate(tr.window_errs):
        check(all(_finite(v) for v in errs.values()),
              f"training window {i}: non-finite loss {errs}")
    check(all(launches[k] > 0 for k in KERNEL_FNS)
          and not any(launches[k] for k in BENCH_FNS.values()),
          f"training: a kernel was not launched, or K3/K4 was {launches}")
    unchanged = [i for i, (p, p0) in enumerate(zip(tr.params, trained0))
                 if torch.equal(p, p0)]
    check(not unchanged, f"training: {len(unchanged)} of {len(trained0)} "
          f"trained tensors did not change")
    now = {f"FlowNet.{k}": v for k, v in tr.net.FlowNet.state_dict().items()}
    now.update({f"loss.{k}": v for k, v in tr.loss_mod.state_dict().items()})
    moved = [k for k, v in frozen0.items() if not torch.equal(now[k], v)]
    check(not moved, f"training: frozen tensors changed: {moved[:5]}")
    del trained0, frozen0, now
    steady = step_ms[1:]
    summary = dict(card=card, batch=TRAIN_BATCH, steps=len(step_ms),
                   step_ms=step_ms, ms_per_step=sum(steady) / len(steady),
                   iteration_ms=iter_ms, peak_bytes=peak,
                   mean_errors=means, next_lr=tr.current_lr())
    log("training windows: " + "; ".join(
        f"{i}: {ms:.1f} ms, total {float(e['total']):.5f}, PSNR "
        f"{float(e['PSNR']):.3f}" for i, (ms, e) in
        enumerate(zip(step_ms, tr.window_errs))))
    log(f"training path: RefVSR_MFID_8K f32, batch {TRAIN_BATCH}, patch "
        f"{cfg.patch_size}, {len(step_ms)} steps in {iter_ms:.1f} ms; "
        f"{summary['ms_per_step']:.1f} ms per optimizer step (mean of steps "
        f"2-{len(step_ms)}); peak allocated {peak / 2**30:.2f} GiB; mean "
        f"errors {means}; launches {launches}  [{card}]")

    # one more step, traced, with every kernel's inputs captured (forward
    # kernels once per shape, backward kernels at every call)
    arrays = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    calls = {name: [] for name in KERNEL_FNS}
    seen = {"warp_sample": set(), "argmax_matmul": set()}
    with capturing(warp_mod, "warp_sample", calls["warp_sample"],
                   seen["warp_sample"]), \
            capturing(matching_mod, "argmax_matmul", calls["argmax_matmul"],
                      seen["argmax_matmul"]), \
            capturing(k1_mod, "warp_sample_backward",
                      calls["warp_sample_backward"]), \
            capturing(k2_mod, "argmax_matmul_backward",
                      calls["argmax_matmul_backward"]), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.train_step(state, *window(arrays, cfg.frame_itr_num - 1,
                                     cfg.frame_num))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    in_step, summary["profiled_step"] = device_profile(
        prof, KERNEL_FNS, "training step", wall_ms, card, top=20)
    for name in ("warp_sample_backward", "argmax_matmul_backward"):
        check(in_step[name]["launches"] == len(calls[name]),
              f"{name}: {in_step[name]['launches']} launches in the traced "
              f"step, {len(calls[name])} captured")
    del tr, arrays, state, prof
    torch.cuda.empty_cache()
    return launches, summary, in_step, calls


# the training entry point: a seeded 1080p PNG tree laid out as
# set_data_path reads it under flag_HD_in (every stream under HR/). Train:
# one clip of 18 frames per camera, two samples of 7 + 9 - 1 frames, one
# batch of 2; valid: one clip of 3 frames per camera, three windows
TREE_FRAMES = {"train": 18, "valid": 3}
LOADER_WORKERS = 4
# the is_amp window of a tiny net (bench/probe_amp.compare, seeds 14 and
# 3). Card against CPU: bf16 keeps 8 mantissa bits and the two devices round
# different partial sums (cuDNN and the kernels against the CPU's
# convolutions and plain versions), so the losses within 3e-2 relative, the
# MFID term 1e-1 (it divides by each distance row's minimum), and the
# gradients, all trained tensors as one vector, within 5e-2 relative L2
# (2.66e-2 on the H100). That vector is blind to a fault in a few small
# tensors, and tensor by tensor the two devices' bf16 gradients differ by
# up to 2.6 of a tensor's norm, a gap that holding the matching picks and
# the affine sampling positions to the CPU's does not close. So each
# trained tensor is checked on one device: the card's kernels against
# their plain versions on the card, the discrete choices held, within
# 5e-2 relative L2 (1.25e-2 to 1.49e-2 on the H100; any backward kernel's
# output scaled by 1.1 gives 0.13 or more; readings by probe_amp, PERF.md
# section 6)
AMP_LOSS_RTOL = {"MFID": 1e-1, "other": 3e-2}
AMP_GRAD_OVERALL = 5e-2
AMP_GRAD_VS_PLAIN = 5e-2


def write_tree(root, rng):
    """The seeded PNG tree under `root`; returns the seconds it took."""
    from refvsr_tpu_torch.data.png import write_image
    t0 = time.perf_counter()
    for split, n in TREE_FRAMES.items():
        for cam in ("UW", "W", "T"):
            for i in range(n):
                write_image(f"{root}/RealMCVSR/{split}/HR/{cam}/0000/"
                            f"{i:04d}.png", _scene(rng, H, W))
    return time.perf_counter() - t0


def phase_loader(cfg, card):
    """ms per batch of each loader on the tree: TrainLoader, then
    MultiWorkerLoader with LOADER_WORKERS workers, its pool's start timed
    apart from its first batch (the workers' start-up) and a second one;
    both loaders' batches must be equal."""
    from refvsr_tpu_torch.data.datasets import TrainDataset, TrainLoader
    from refvsr_tpu_torch.data.loader import MultiWorkerLoader
    ds = TrainDataset(cfg)
    check(len(ds) == 2, f"loader: {len(ds)} training samples, not 2")
    t0 = time.perf_counter()
    want = next(iter(TrainLoader(ds, cfg.batch_size, seed=cfg.manual_seed)))
    single_ms = (time.perf_counter() - t0) * 1e3
    p, t = cfg.patch_size, cfg.frame_num + cfg.frame_itr_num - 1
    shapes = {k: want[k].shape for k in ("LR_UW", "LR_REF_W", "HR_UW",
                                         "HR_REF_T")}
    check(shapes == {"LR_UW": (2, t, p, p, 3), "LR_REF_W": (2, t, 2 * p,
                                                            2 * p, 3),
                     "HR_UW": (2, t, p, p, 3),
                     "HR_REF_T": (2, t, 4 * p, 4 * p, 3)},
          f"loader: batch shapes {shapes}")
    mw = MultiWorkerLoader(ds, cfg.batch_size, seed=cfg.manual_seed,
                           num_workers=LOADER_WORKERS)
    try:
        t0 = time.perf_counter()
        mw.start()
        start_ms = (time.perf_counter() - t0) * 1e3
        got, ms = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            got.append(next(iter(mw)))
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        mw.close()
    for b in got:
        check(all(np.array_equal(b[k], want[k]) for k in want),
              "loader: MultiWorkerLoader's batch differs from TrainLoader's")
    out = dict(train_loader_ms=single_ms, workers=LOADER_WORKERS,
               pool_start_ms=start_ms, first_batch_ms=ms[0],
               warm_batch_ms=ms[1])
    log(f"loader (batch {cfg.batch_size}, {t} frames x 6 streams of "
        f"{H}x{W} PNG a sample): TrainLoader {single_ms:.1f} ms/batch; "
        f"MultiWorkerLoader ({LOADER_WORKERS} workers) pool start "
        f"{start_ms:.1f} ms, first batch {ms[0]:.1f} ms (with the workers' "
        f"start-up), next {ms[1]:.1f} ms; batches equal  [{card}]")
    return out


class EpochRecord:
    """What the instrumented classes record during a run.main call: epoch
    starts, each Trainer.iteration's start and end, each validation
    window's time, the training and validation peaks, the validation
    launches and PSNR, each checkpoint save's time and bytes."""

    def __init__(self):
        self.epoch_t0, self.iters, self.windows = [], [], []
        self.saves, self.valid = [], []
        self.steps = 0
        # device memory earlier phases still hold (their captured inputs)
        self.base = torch.cuda.memory_allocated()
        self.gate = False       # capture the kernels' inputs now
        self.capture = True     # in the first step and window of the run


def instrumented(rec):
    from refvsr_tpu_torch.data.loader import MultiWorkerLoader
    from refvsr_tpu_torch.eval.stream import StreamRunner
    from refvsr_tpu_torch.train.ckpt import CkptManager
    from refvsr_tpu_torch.train.runner import Runner
    from refvsr_tpu_torch.train.trainer import Trainer

    def set_epoch(orig):
        def f(self, epoch):
            rec.epoch_t0.append(time.perf_counter())
            return orig(self, epoch)
        return f

    def iteration(orig):
        def f(self, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(self, batch)
            torch.cuda.synchronize()
            rec.iters.append((t0, time.perf_counter()))
            return out
        return f

    def train_step(orig):
        def f(self, *a):
            rec.gate = rec.capture and rec.steps == 0
            rec.steps += 1
            try:
                return orig(self, *a)
            finally:
                rec.gate = False
        return f

    def process(orig):
        def f(self, *a):
            rec.gate = rec.capture and not rec.windows
            t0 = time.perf_counter()
            try:
                return orig(self, *a)      # returns numpy: synchronised
            finally:
                rec.windows.append((time.perf_counter() - t0) * 1e3)
                rec.gate = False
        return f

    def validate(orig):
        def f(self, *a, **k):
            torch.cuda.synchronize()
            train_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            before = read_launches()
            t0 = time.perf_counter()
            psnr = orig(self, *a, **k)
            after = read_launches()
            rec.valid.append(dict(
                psnr=psnr, ms=(time.perf_counter() - t0) * 1e3,
                train_peak_bytes=train_peak,
                valid_peak_bytes=torch.cuda.max_memory_allocated(),
                launches={k: after[k] - before[k] for k in after}))
            torch.cuda.reset_peak_memory_stats()
            return psnr
        return f

    def save(orig):
        def f(self, state_dict, train_state, epoch, score):
            t0 = time.perf_counter()
            orig(self, state_dict, train_state, epoch, score)
            t_end = time.perf_counter()
            name = self._file_name(epoch)
            rec.saves.append(dict(ms=(t_end - t0) * 1e3, t_end=t_end,
                                  bytes=sum(os.path.getsize(
                                      os.path.join(d, name))
                                      for d in (self.dir_ckpt,
                                                self.dir_state))))
        return f

    stack = contextlib.ExitStack()
    for cls, name, make in ((MultiWorkerLoader, "set_epoch", set_epoch),
                            (Trainer, "iteration", iteration),
                            (Trainer, "train_step", train_step),
                            (StreamRunner, "process", process),
                            (Runner, "validate", validate),
                            (CkptManager, "save", save)):
        stack.enter_context(patched(cls, name, make))
    return stack


def epoch_summary(rec, what, card):
    """The numbers of one run.main epoch from its record."""
    starts = [rec.epoch_t0[0]] + [b for _, b in rec.iters[:-1]]
    waits = [(a - s) * 1e3 for (a, _), s in zip(rec.iters, starts)]
    iter_ms = [(b - a) * 1e3 for a, b in rec.iters]
    check(rec.saves and rec.valid, f"{what}: no validation or checkpoint")
    epoch_ms = (rec.saves[0]["t_end"] - rec.epoch_t0[0]) * 1e3
    v = rec.valid[0]
    out = dict(iteration_ms=iter_ms, wait_ms=waits, epoch_ms=epoch_ms,
               iteration_share=sum(iter_ms) / epoch_ms,
               valid_window_ms=rec.windows, psnr=v["psnr"],
               valid_ms=v["ms"], train_peak_bytes=v["train_peak_bytes"],
               valid_peak_bytes=v["valid_peak_bytes"],
               valid_launches=v["launches"], ckpt_save_ms=rec.saves[0]["ms"],
               ckpt_bytes=rec.saves[0]["bytes"], held_before_bytes=rec.base)
    log(f"{what}: {len(iter_ms)} batch(es), Trainer.iteration "
        + ", ".join(f"{m:.1f}" for m in iter_ms) + " ms (9 steps each); "
        f"wait on the prefetch queue " + ", ".join(f"{m:.1f}" for m in waits)
        + f" ms; epoch {epoch_ms:.1f} ms, of which iterations "
        f"{out['iteration_share']:.3f}; validation {v['ms']:.1f} ms, "
        f"windows " + ", ".join(f"{m:.1f}" for m in rec.windows)
        + f" ms, PSNR {v['psnr']:.4f} dB, launches {v['launches']}; "
        f"checkpoint {rec.saves[0]['bytes']} bytes in "
        f"{rec.saves[0]['ms']:.1f} ms; peaks: training "
        f"{v['train_peak_bytes'] / 2**30:.2f} GiB, validation "
        f"{v['valid_peak_bytes'] / 2**30:.2f} GiB, with the "
        f"{rec.base / 2**30:.2f} GiB earlier phases hold  [{card}]")
    return out


def _cached_reads():
    """data.datasets' PNG reader behind a cache, for the small variant's
    batch that reads each file several times."""
    import functools

    from refvsr_tpu_torch.data import datasets
    return patched(datasets, "read_image",
                   lambda orig: functools.lru_cache(maxsize=None)(orig))


def amp_vs_cpu_line(r, card):
    return ("is_amp window (tiny net, bf16), card vs CPU: losses "
            + ", ".join(f"{k} {g:.6g}/{c:.6g}" for k, (g, c) in
                        r["losses"].items())
            + f"; {r['flipped'][0]} of {r['flipped'][1]} matching picks "
            f"differ; gradients {r['overall']:.3e} relative L2 over all "
            f"trained tensors, worst tensors "
            f"{worst_tensors(r['vs_cpu'])}. The card's kernels against "
            f"their plain versions on the card, choices held: worst tensors "
            f"{worst_tensors(r['vs_plain'])}  [{card}]")


def phase_amp(dev, card, root):
    """One Trainer.iteration of RefVSR_small_MFID_8K (is_amp: bf16 compute
    on f32 master weights) at the config's batch of 8 from the tree (its
    two samples, each under four epochs' augmentation draws), the backward
    kernels' calls of its first step captured; then the card against the
    CPU on one is_amp window of a tiny net. Returns (summary, captured
    calls)."""
    from refvsr_tpu_torch.configs import get_config, set_data_path
    from refvsr_tpu_torch.data.datasets import (TrainDataset, collate,
                                                sample_rng)
    from refvsr_tpu_torch.models.refvsr import init_stream_state
    from refvsr_tpu_torch.ops.kernels import argmax_matmul as k2_mod
    from refvsr_tpu_torch.ops.kernels import warp_sample as k1_mod
    from refvsr_tpu_torch.train.trainer import Trainer

    cfg = set_data_path(get_config(
        "RefVSR_small_MFID_8K", data_offset=root, is_train=True,
        **NO_ASSETS), True)
    n = cfg.batch_size
    check((cfg.is_amp, cfg.num_blocks, cfg.mid_channels, cfg.frame_num,
           cfg.flag_HD_in, cfg.batch_size, cfg.patch_size)
          == (True, 24, 24, 3, True, 8, 128),
          f"is_amp config {cfg}")
    ds = TrainDataset(cfg)
    with _cached_reads():
        batch = collate([ds.__getitem__(j % len(ds), rng=sample_rng(
            cfg.manual_seed, j // len(ds), j % len(ds))) for j in range(n)])
    tr = Trainer(cfg, device=dev, seed=0)
    check(tr.compute_dtype == torch.bfloat16, "is_amp: compute dtype")
    trained0 = [p.detach().clone() for p in tr.params]
    calls = {"warp_sample_backward": [], "argmax_matmul_backward": []}
    gate = {"on": False}
    step = tr.train_step

    def first_step_gated(*a):
        gate["on"] = not tr.window_errs
        try:
            return step(*a)
        finally:
            gate["on"] = False
    tr.train_step = first_step_gated
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with capturing(k1_mod, "warp_sample_backward",
                   calls["warp_sample_backward"], when=lambda: gate["on"]), \
            capturing(k2_mod, "argmax_matmul_backward",
                      calls["argmax_matmul_backward"],
                      when=lambda: gate["on"]):
        t0 = time.perf_counter()
        means, _ = tr.iteration(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    del tr.train_step
    check(all(all(_finite(v) for v in e.values()) for e in tr.window_errs),
          f"is_amp: non-finite losses {tr.window_errs}")
    check(all(p.dtype == torch.float32 for p in tr.params)
          and all(m.dtype == torch.float32 for m in tr.opt.mu + tr.opt.nu),
          "is_amp: a trained tensor or an Adam moment is not f32")
    unchanged = sum(torch.equal(p, p0) for p, p0 in zip(tr.params, trained0))
    check(unchanged == 0, f"is_amp: {unchanged} trained tensors unchanged")
    check(all(launches[k] > 0 for k in KERNEL_FNS),
          f"is_amp: a kernel was not launched {launches}")
    check(all(v and all(a[0].dtype == torch.bfloat16 for a, _ in v)
              for v in calls.values()),
          "is_amp: the backward kernels did not run in bf16")
    summary = dict(batch=n, iteration_ms=ms, peak_bytes=peak,
                   mean_errors=means, launches=launches)
    log(f"is_amp iteration (RefVSR_small_MFID_8K: bf16 on f32 masters, 24 "
        f"blocks, 24 ch, T=3, patch 128, batch {n}): "
        f"{cfg.frame_itr_num} steps in {ms:.1f} ms; peak "
        f"{peak / 2**30:.2f} GiB; mean errors {means}; launches {launches}; "
        f"trained tensors f32, all changed  [{card}]")
    del tr, trained0, batch
    torch.cuda.empty_cache()

    # the card against the CPU, and the card's kernels against their plain
    # versions, on one is_amp window of a tiny net (limits above)
    r = amp_compare(dev)
    bad = []
    for k, (g, c) in r["losses"].items():
        rtol = AMP_LOSS_RTOL["MFID" if k.startswith("MFID") else "other"]
        if abs(g - c) > rtol * abs(c):
            bad.append(f"loss {k} card {g} vs CPU {c} (rtol {rtol})")
    if not r["overall"] <= AMP_GRAD_OVERALL:
        bad.append(f"the gradients differ from the CPU's by "
                   f"{r['overall']:.3e} relative L2 (limit "
                   f"{AMP_GRAD_OVERALL})")
    worst = max((v, k) for k, v in r["vs_plain"].items())
    if not worst[0] <= AMP_GRAD_VS_PLAIN:
        bad.append(f"{worst[1]}'s gradient is {worst[0]:.3e} relative L2 "
                   f"from the plain versions' (limit {AMP_GRAD_VS_PLAIN})")
    log(amp_vs_cpu_line(r, card))
    summary["card_vs_cpu"] = dict(
        losses=r["losses"], flipped_picks=r["flipped"],
        gradient_rel_l2=r["overall"],
        worst_tensor_vs_cpu=max((v, k) for k, v in r["vs_cpu"].items()),
        worst_tensor_vs_plain=worst)
    check(not bad, "is_amp: " + "; ".join(bad))
    return summary, calls


def phase_train_entry(dev, card):
    """The training entry point through run.main at full width:
    RefVSR_MFID_8K from a 1080p PNG tree, one epoch (one batch of 2, 9
    steps, the f32 validation at 8K, a checkpoint), then a resume into a
    second epoch, then the is_amp iteration. Returns (launches of the first
    epoch, summary, captured kernel calls of the epoch's first step and
    first validation window, those of the is_amp step)."""
    import tempfile

    from refvsr_tpu_torch import run
    from refvsr_tpu_torch.models import matching as matching_mod
    from refvsr_tpu_torch.ops import warp as warp_mod
    from refvsr_tpu_torch.ops.kernels import argmax_matmul as k2_mod
    from refvsr_tpu_torch.ops.kernels import warp_sample as k1_mod
    from refvsr_tpu_torch.train.runner import Runner

    calls = {name: [] for name in KERNEL_FNS}
    summary = dict(card=card)
    with tempfile.TemporaryDirectory() as root:
        tree_s = write_tree(root, np.random.default_rng(13))
        n_png = 3 * sum(TREE_FRAMES.values())
        log(f"PNG tree: {n_png} seeded {H}x{W} frames written in "
            f"{tree_s:.1f} s")
        argv = ["--is_train", "--config", "config_RefVSR_MFID_8K",
                "--mode", "chip_smoke", "-b", str(TRAIN_BATCH),
                "--data_offset", root, "--log_offset", f"{root}/logs"]
        cfg = run.build_config(run.build_parser().parse_args(
            argv + ["--total_itr", "9"]))
        check((cfg.num_blocks, cfg.mid_channels, cfg.flag_HD_in,
               cfg.matching_ksize, cfg.is_use_T, cfg.is_amp, cfg.loss,
               cfg.CX_vgg_layer, cfg.patch_size, cfg.frame_num,
               cfg.frame_itr_num, cfg.thread_num, cfg.write_ckpt_every_epoch)
              == (30, 48, True, 8, True, False, "1*L1_lf+0.1*MFID_ref",
                  "relu4_4", 128, 7, 9, 4, 1), f"CLI config {cfg}")
        summary["tree_write_s"] = tree_s
        summary["loader"] = phase_loader(cfg, card)

        # one epoch through the CLI, instrumented; the kernels' inputs of
        # its first step and its first validation window captured
        rec = EpochRecord()
        seen = {"warp_sample": set(), "argmax_matmul": set()}
        gate = lambda: rec.gate  # noqa: E731
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with instrumented(rec), \
                capturing(warp_mod, "warp_sample", calls["warp_sample"],
                          seen["warp_sample"], when=gate), \
                capturing(matching_mod, "argmax_matmul",
                          calls["argmax_matmul"], seen["argmax_matmul"],
                          when=gate), \
                capturing(k1_mod, "warp_sample_backward",
                          calls["warp_sample_backward"], when=gate), \
                capturing(k2_mod, "argmax_matmul_backward",
                          calls["argmax_matmul_backward"], when=gate):
            t0 = time.perf_counter()
            runner = run.main(argv + ["--total_itr", "9"])
            main_ms = (time.perf_counter() - t0) * 1e3
            summary["epoch0"] = epoch_summary(rec, "epoch 0 via run.main",
                                              card)
        launches = read_launches()
        summary["epoch0"].update(run_main_ms=main_ms, launches=launches)
        tr = runner.trainer
        check(tr.opt.step == cfg.frame_itr_num == len(rec.iters) * 9,
              f"epoch 0: {tr.opt.step} steps in {len(rec.iters)} batches")
        check(all(launches[k] > 0 for k in KERNEL_FNS)
              and not any(launches[k] for k in BENCH_FNS.values()),
              f"epoch 0: a kernel was not launched, or K3/K4 was {launches}")
        v = summary["epoch0"]
        check(np.isfinite(v["psnr"]) and len(v["valid_window_ms"]) == 3,
              f"epoch 0: PSNR {v['psnr']}, {len(v['valid_window_ms'])} "
              f"validation windows")
        check(v["valid_launches"]["argmax_matmul"] == 3
              and v["valid_launches"]["warp_sample"] == 16 + 2 * 10,
              f"validation launches {v['valid_launches']}")
        check(all(p.dtype == torch.float32 and p.requires_grad
                  for p in tr.params) and tr.net.training,
              "validation changed the trainer's net")
        saved = ({k: v.detach().cpu().clone()
                  for k, v in tr.net.state_dict().items()},
                 [m.detach().cpu().clone() for m in tr.opt.mu + tr.opt.nu],
                 tr.opt.step)
        log_dir = cfg.log_dir
        del runner, tr
        torch.cuda.empty_cache()

        # resume from epoch 0 into a second epoch; the state loaded must
        # equal what the first run held, bit for bit
        loaded = {}

        def resume(orig):
            def f(self, epoch):
                orig(self, epoch)
                t = self.trainer
                loaded.update(
                    net=all(torch.equal(v.cpu(), saved[0][k])
                            for k, v in t.net.state_dict().items())
                    and set(t.net.state_dict()) == set(saved[0]),
                    opt=all(torch.equal(m.cpu(), s) for m, s in
                            zip(t.opt.mu + t.opt.nu, saved[1])),
                    step=t.opt.step, epoch0=self.epoch0)
            return f

        rec = EpochRecord()
        rec.capture = False
        torch.cuda.reset_peak_memory_stats()
        with instrumented(rec), patched(Runner, "resume", resume):
            runner = run.main(argv + ["--resume", "0", "--total_itr", "18"])
            summary["epoch1"] = epoch_summary(rec, "epoch 1 (resumed)", card)
        check(loaded == dict(net=True, opt=True, step=saved[2], epoch0=1),
              f"resume: {loaded}")
        check(runner.epoch0 == 1 and runner.trainer.opt.step == 18,
              f"resume: epoch0 {runner.epoch0}, step "
              f"{runner.trainer.opt.step}")
        with open(f"{log_dir}/checkpoint/train/epoch/checkpoints.txt") as f:
            lines = f.read().splitlines()
        check(len(lines) == 3 and sorted(lines[:2]) == sorted(
            f"chip_smoke_{e:05d}.ckpt {p}" for e, p in
            ((0, summary["epoch0"]["psnr"]), (1, summary["epoch1"]["psnr"])))
              and lines[2].startswith("chip_smoke_00001.ckpt "),
              f"checkpoints.txt: {lines}")
        log(f"resume: net and Adam moments equal to epoch 0's bit for bit, "
            f"step {saved[2]}, epoch0 1; checkpoints.txt {lines}")
        del runner
        to_host(calls)
        torch.cuda.empty_cache()
        log(f"before the is_amp iteration: "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
        summary["amp"], amp_calls = phase_amp(dev, card, root)
    return launches, summary, calls, amp_calls


def _shape(t):
    return "x".join(str(v) for v in t.shape)


def path_cases(stream_calls, first_calls, train_calls, more_calls):
    """Each kernel against its plain version on the inputs the main paths
    gave it: every call of a streamed window, the first window's calls at
    shapes the streamed window lacks, the training step's calls (the
    forward kernels once per shape, the backward kernels at every call),
    and the calls in `more_calls` ({path label: calls by kernel}: one
    predict, one pipelined dispatch, the first step and validation window
    of the training entry point's epoch, one is_amp step). Returns
    {kernel: (the calls its in-path numbers sum over, the rest)}."""
    def k1(label, args, kw):
        return k1_case(label, *args, 2.0 ** -6 if args[0].dtype ==
                       torch.bfloat16 else 1e-5)

    def k2(label, args, kw):
        return k2_case(label, *args, iters=2, plain_iters=1)

    def k1_bwd(label, args, kw):
        return k1_bwd_case(label, *args, **kw)

    def k2_bwd(label, args, kw):
        return k2_bwd_case(label, *args, **kw)

    def card(v):
        return v.cuda() if torch.is_tensor(v) else v

    def run(fn, where, calls):
        return [fn(f"{where} call {i}: {_shape(a[0])}, {_shape(a[1])}",
                   tuple(card(x) for x in a),
                   {k: card(v) for k, v in kw.items()})
                for i, (a, kw) in enumerate(calls)]

    def more(fn, name):
        return [c for label, calls in more_calls.items()
                for c in run(fn, label, calls.get(name, []))]

    return {
        "warp_sample": (run(k1, "forward_stream", stream_calls["warp_sample"]),
                        run(k1, "forward_first", first_calls["warp_sample"])
                        + run(k1, "train step", train_calls["warp_sample"])
                        + more(k1, "warp_sample")),
        "argmax_matmul": (
            run(k2, "forward_stream", stream_calls["argmax_matmul"]),
            run(k2, "forward_first", first_calls["argmax_matmul"])
            + run(k2, "train step", train_calls["argmax_matmul"])
            + more(k2, "argmax_matmul")),
        "warp_sample_backward": (
            run(k1_bwd, "train step", train_calls["warp_sample_backward"]),
            more(k1_bwd, "warp_sample_backward")),
        "argmax_matmul_backward": (
            run(k2_bwd, "train step", train_calls["argmax_matmul_backward"]),
            more(k2_bwd, "argmax_matmul_backward")),
    }


KERNEL_META = {
    "warp_sample": dict(
        id="K1", source="refvsr_tpu_torch/csrc/warp_sample.cu",
        replaces="refvsr_tpu/ops/pallas/warp_select.py:293",
        tolerance="2**-6 * max|x| (bf16), 1e-5 * max|x| (f32)",
        ms_is="device time of its launches in one forward_stream window "
              "(torch.profiler); plain_ms, library_ms (F.grid_sample) and "
              "bound_ms are for the inputs the path gave it in the next "
              "forward_stream window, summed over its launches"),
    "warp_sample_backward": dict(
        id="K1-bwd", source="refvsr_tpu_torch/csrc/warp_sample.cu",
        replaces="refvsr_tpu/ops/pallas/warp_select.py:363",
        tolerance="1e-5 (f32), 2**-7 (bf16) of the f32 plain backward's "
                  "max |dx|, |dflow|",
        ms_is="device time of its launches and of its launcher's clears "
              "of dx in one full-width training step (torch.profiler); "
              "plain_ms, library_ms (aten.grid_sampler_2d_backward) and bound_ms are for the "
              "inputs that step gave it, summed over its launches"),
    "argmax_matmul": dict(
        id="K2", source="refvsr_tpu_torch/csrc/argmax_matmul.cu",
        replaces="refvsr_tpu/ops/pallas/matching_kernel.py:67",
        tolerance="conf 1e-4; picks within 1e-4 of the max",
        ms_is="device time of its launch in one forward_stream window "
              "(torch.profiler); plain_ms, library_ms (matmul + max, two "
              "calls) and bound_ms are for the inputs the path gave it in "
              "the next forward_stream window"),
    "argmax_matmul_backward": dict(
        id="K2-bwd", source="refvsr_tpu_torch/csrc/argmax_matmul.cu",
        replaces="refvsr_tpu/ops/pallas/matching_kernel.py:118",
        tolerance="d_lr 1e-6, d_ref 1e-5 (f32) or 2**-7 (bf16) of the plain "
                  "backward's max",
        ms_is="device time of its launch and of its launcher's clear of "
              "d_ref in one full-width training step (torch.profiler); "
              "plain_ms, library_ms (index_select + "
              "index_add_, two calls) and bound_ms are for the inputs that "
              "step gave it"),
    "conv3x3_bias": dict(
        id="K3", source="refvsr_tpu_torch/csrc/conv3x3.cu",
        replaces="scripts/microbench_pallas_conv.py:80",
        tolerance="2**-7 * |plain| + 2**-8 * max|plain| elementwise (bf16)",
        ms_is="CUDA-event time of one call at 1080x1920x48 bf16 in the "
              "microbenchmark, isolated; library_ms is F.conv2d with bias "
              "(channels-last bf16, one call), plain_ms the plain version, "
              "bound_ms for the same inputs"),
    "gather_rows": dict(
        id="K4", source="refvsr_tpu_torch/csrc/gather_rows.cu",
        replaces="scripts/microbench_pallas_gather.py:93",
        tolerance="bitwise",
        ms_is="CUDA-event time of one call at R 2048, L 128 bf16, P 2^20 in "
              "the microbenchmark, isolated; library_ms is index_select, "
              "plain_ms the plain version, bound_ms for the same inputs"),
}


def _case(c):
    return {k: v for k, v in c.items() if k not in (
        "nbytes", "flops", "peak", "kernels_bias", "kernels_nobias")}


def kernels_line(synthetic, on_path, in_path, in_step, launches, bench):
    kernels = []
    for name, m in KERNEL_META.items():
        by_path = {p: launches[p][name] for p in launches}
        entry = dict(name=name, id=m["id"], route="cuda", source=m["source"],
                     replaces=m["replaces"], launches=sum(by_path.values()),
                     launches_by_path=by_path, tolerance=m["tolerance"],
                     ms_is=m["ms_is"])
        if name in bench:
            main, cases = bench[name]
            b_ms, b_by = bound_ms(main["nbytes"], main["flops"],
                                  torch.bfloat16)
            kernels.append(dict(
                entry, max_abs_err=max(c["max_abs_err"] for c in cases),
                ms=main["ms"], plain_ms=main["plain_ms"],
                library_ms=main["library_ms"], bound_ms=b_ms, bound_by=b_by,
                cases=[_case(c) for c in cases]))
            continue
        counted, rest = on_path[name]
        forward = name in ("warp_sample", "argmax_matmul")
        ms = (in_path if forward else in_step)[name]
        check(ms["launches"] == len(counted) or not forward,
              f"{name}: {ms['launches']} launches in the profiled window, "
              f"{len(counted)} in the captured one")
        peaks = {c["peak"] for c in counted}
        check(len(peaks) == 1, f"{name}: in-path calls of mixed peaks")
        b_ms, b_by = bound_ms(sum(c["nbytes"] for c in counted),
                              sum(c["flops"] for c in counted), peaks.pop())
        lib = [c["library_ms"] for c in counted]
        cases = synthetic[name] + counted + rest
        kernels.append(dict(
            entry, max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=ms["ms"], kernel_ms=ms["kernel_ms"],
            ms_train_step=in_step[name]["ms"],
            isolated_ms=sum(c["ms"] for c in counted),
            plain_ms=sum(c["plain_ms"] for c in counted),
            library_ms=None if None in lib else sum(lib),
            bound_ms=b_ms, bound_by=b_by, cases=[_case(c) for c in cases]))
    return kernels


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    # f32 comparisons in full f32: TF32 off for matmuls and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from refvsr_tpu_torch.ops.kernels import build
    build.LIBS.build_all()
    log(f"kernels built in {build.LIBS.seconds:.1f} s")
    for name, text in sorted(build.LIBS.log.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    dev = "cuda"
    synthetic = {"warp_sample": phase_k1(dev), "argmax_matmul": phase_k2(dev)}
    torch.cuda.empty_cache()
    synthetic["warp_sample_backward"] = phase_k1_backward(dev)
    synthetic["argmax_matmul_backward"] = phase_k2_backward(dev)
    torch.cuda.empty_cache()
    launches, bench = phase_microbench(card)
    phase_small_agreement(dev)
    phase_small_training(dev)
    torch.cuda.empty_cache()
    launches["stream"], windows, peak, in_path, stream_calls, first_calls = \
        phase_main_path(dev, card)
    launches["serving"], serving, serve_calls = phase_serving(dev, card)
    launches["pipelined"], pipelined, pipe_calls = phase_pipelined(dev, card)
    with cudnn_tf32(True):
        launches["train"], train, in_step, train_calls = phase_training(
            dev, card)
        to_host(stream_calls, first_calls, serve_calls, pipe_calls,
                train_calls)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        launches["train_entry"], entry, entry_calls, amp_calls = \
            phase_train_entry(dev, card)
        entry["phase_s"] = time.perf_counter() - t0
        log(f"training entry point phase: {entry['phase_s']:.1f} s")
    launches["train_amp"] = entry["amp"]["launches"]
    on_path = path_cases(stream_calls, first_calls, train_calls,
                         {"predict": serve_calls,
                          "pipelined dispatch": pipe_calls,
                          "train entry (step 1, validation window 0)":
                          entry_calls,
                          "is_amp step": amp_calls})
    kernels = kernels_line(synthetic, on_path, in_path, in_step, launches,
                           bench)
    log(json.dumps(dict(main_path=dict(card=card, windows=windows,
                                       peak_bytes=peak), serving=serving,
                        pipelined=pipelined, training=train,
                        train_entry=entry)))
    log(json.dumps(dict(kernels=kernels)))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s  [{card}]")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
