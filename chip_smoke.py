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
6. the microbenchmark paths (K4's only caller; K3 is also in the bf16
   inference path, phases 8 and 9): the entry points
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
8. the streaming path at full width through the bench's stream leg
   (``bench/e2e.run_stream``, what ``python -m refvsr_tpu_torch.bench.e2e``
   runs): RefVSR_MFID_8K (30 blocks, 48 channels, seeded random weights,
   bf16) streaming a seeded 1080p window of 7 frames into 4320x7680 frames
   through ``StreamRunner``: one ``forward_first``, 2 warm-up and 8 timed
   ``forward_stream`` windows and the bench's numerics gate, its record
   checked (keys, metric ``stream_fps_8k``, ``out_shape``, 10 K1 and 1 K2
   launches a window) and logged, each kernel's launches counted (K3 for
   the square 3x3 convolutions ``blocks.takes_k3`` admits); then one
   more streamed window traced by ``torch.profiler`` (each kernel's device
   time inside the path), and each kernel held against its plain version
   on the inputs the path gave it: every call of a further streamed window
   (K3's each as it runs, within 2^-7 |plain| + 2^-8 max|plain|, every
   shape it is given timed alone once beside the plain version and the
   library conv), and the calls of a new first window at the shapes the
   streamed window lacks (K1 from the low-res grid to the 2x one; K2 at
   batch 7);
9. the serving path: ``serving.predictor.Predictor`` (RefVSR_MFID_8K,
   seeded random weights, bf16) on a seeded 1080x1920 PNG pair that the
   port's encoder writes, center-cropped to 720x1280: three ``predict``
   calls with each kernel's launches counted (K1, K2 and K3), the output
   PNG decoded by the port's reader and checked ((2880, 5120, 3), finite,
   non-constant), the PNG decode and encode timed apart; then the K1 and
   K2 calls of one more ``predict`` held against their plain versions;
10. the pipelined stream (``pipeline_lanes`` = 2): first at a small input,
   the tiny net (2 blocks, 8 channels, T = 7, f32) pipelined on the card
   against the plain stream on the card and the pipelined one on the CPU
   (one first window, one priming dispatch, three steady dispatches and the
   flush), each emitted frame within 1e-4; then at full width, plain and
   pipelined RefVSR_MFID_8K (bf16, 1080p in, 8K out) on the same frames,
   in turn, each on the route production takes (the pipelined lanes'
   batch-2 convolutions on cuDNN, the plain stream's on K3): ms per steady
   dispatch against ms per plain window, their peaks, the launches of
   each dispatch, and each emitted frame against the plain stream's (mean
   and max |difference| on the [0, 1] output within PIPE_MEAN_LIMIT and
   PIPE_MAX_LIMIT); the K1 and K2 calls of the flush dispatch held against
   their plain versions;
11. the training path at full width: RefVSR_MFID_8K trained as the JAX
   package trains it (loss '1*L1_lf+0.1*MFID_ref' at relu4_4, f32, patch
   128, 7 frames, Adam with global-norm clipping and the CA schedule) on a
   seeded synthetic batch, at batch 2 instead of the config's 8 (batch 8
   does not fit one card). One ``Trainer.iteration`` (9 optimizer steps)
   with the four kernels' launches counted; then one more step traced by
   ``torch.profiler`` (where the step's time goes), each kernel held
   against its plain version on the inputs that step gave it;
12. the training entry point at full width: a seeded 1080x1920 PNG tree
   (train: one clip of 18 frames per camera, two samples; valid: 1 frame)
   written by the port's encoder (as every tree here, on a pool of
   HOST_WORKERS processes); ``TrainLoader`` timed per batch on it (on that
   pool, while the first epoch runs); then
   ``refvsr_tpu_torch.run.main([... "--is_train", "--config",
   "config_RefVSR_MFID_8K", "-b", "2", "--total_itr", "9"])`` (its
   4-worker ``MultiWorkerLoader``'s first batch equal to TrainLoader's):
   one epoch (one batch, 9 steps, the f32 validation at 8K over 1 window,
   a checkpoint) with ms per iteration, the wait on the prefetch queue,
   the epoch's time and its share in iterations, ms per validation window,
   PSNR, the checkpoint's bytes and save time and the peaks of training
   and validation, the kernels' launches counted and the calls of its
   first step and first validation window captured; then ``--resume 0
   --total_itr 18``: the state loaded equals the saved one bit for bit, a
   second epoch runs, ``checkpoints.txt`` holds two entries and the
   most-recent line; then one ``Trainer.iteration`` of
   RefVSR_small_MFID_8K under the bf16 policy (``is_amp``) at the config's
   batch of 8 (its items made on the pool while the epochs run), its
   first step's backward calls captured, and one is_amp window of a tiny
   net on the card against the CPU.

13. small-input agreement of RefVSR-IR (run with phase 7): the tiny IR
   net (2 blocks, 8 channels, EDVR-M at 64 channels, T = 5, offsets
   redrawn so that the deformable convolutions sample between pixels) on
   the card against the CPU through ``StreamRunner(keyframe_stride)``: a
   first window and two streamed ones within 1e-3, 18 K1 and 1 K2 launches
   each; one tiny RefVSR_IR_MFID ``Trainer.iteration`` (2 steps) with its
   mean errors against the CPU's;
14. the IR net's evaluation entry point at full width:
   ``refvsr_tpu_torch.run.main(["--config", "config_RefVSR_IR_MFID",
   "--eval_mode", "quan_qual", ...])`` (30 blocks, 36 channels, T = 9,
   f32, seeded random weights) on a seeded RealMCVSR-layout tree (LRx4
   270x480 in, HR 1080x1920 ground truth; two videos of 5 and 1 frames)
   written by the port's PNG encoder: ms per window on the host, one
   window traced (device time, idle share, top kernels), the EDVR refill
   and the plain deformable convolutions timed apart in another, the
   peak, 32 K1 and 1 K2 launches per window, the score file (a line per
   frame, a MEAN line, a TOTAL line) and every PNG/JPEG dump decoded or
   read back at its shape; then ``--eval_mode FOV`` and ``conf`` on the
   second video, their files checked;
15. the same CLI on RefVSR_MFID_8K: quan_qual with --quantitative_only on
   a 1080p tree of 2 frames (f32, the metrics on the SR frame downscaled
   by 1/4 on the card), the launches and the score file checked;
16. one RefVSR_IR_MFID ``Trainer.iteration`` at full width and the
   config's batch of 8 (patch 64, T = 9, 5 steps, f32): ms per step and
   the peak; one more step with every kernel's inputs captured.

17. the multi-rank paths, each on two processes sharing the card over
   gloo (the machine has one card, and NCCL refuses two ranks on one
   device; times are two-ranks-on-one-card times): the H-sharded 8K
   stream (RefVSR_MFID_8K bf16, halo 32, a first and two streamed
   windows through ``StreamRunner`` with ``parallel/serve`` functions)
   with each rank's launches counted, ms per window, exchanges and bytes
   handed in per window, each rank's peak, every banded K1 and K2 call of
   its last window held against the plain versions (the ranks in turns),
   and the gathered frames against the one-rank stream of the same net
   and frames (the bands' convolutions on cuDNN, the replicated stages'
   and the one-rank stream's on K3, as production runs them), with the
   difference's profile by output row (at
   the band seam or away from it); a control with no halo (a first and one
   streamed window) must fail that check; after phase 10's policy, the
   data-parallel step (RefVSR_MFID_8K f32, TF32 off, batch 1 a rank, the
   contextual loss's choices held to the one-rank run's): window 0's
   averaged gradients against one rank's on the batch of 2, the
   parameters equal on both ranks after the update and after two timed
   steps, the launches and peaks; after phase 15, the same eval CLI with
   ``--spatial_devices 2`` (``run.main`` spawns the ranks), its score
   lines against the one-rank run's; and last ``run.main(["--is_train",
   "--devices", "2", ...])`` on RefVSR_MFID (full width, -b 2) over a
   small seeded tree: rank 0's log tree and checkpoint, and no file opened
   for writing by rank 1.

18. the bench's train leg (``bench/e2e.run_train``, run after phase 11):
   RefVSR_MFID at full width, its full loss, patch 64, batch 1, one
   window, an untimed and four timed ``Trainer.iteration`` calls with the
   launches counted, under PyTorch's default f32 policy as the bench runs;
   its fields merged into phase 8's record and the bench's record logged
   on a line of its own; then one more iteration with every kernel's
   inputs captured.

The calls captured in phases 14 to 16 and 18 (each new shape of one
streamed IR window and of the 8K CLI's first window; every backward call
of one IR step and of the bench's train step, its forward calls once per
shape) are held against the plain versions with the others. The paths'
launches appear in ``launches_by_path`` as ``ir_eval``, ``eval_cli``,
``ir_train`` and ``bench`` (the train leg; the stream leg's are
``stream``), and phase 17's as ``spatial`` and ``ddp`` (summed over the
ranks); the banded K1 has a row of its own (``warp_sample_banded``).
Phases 14 to 16 run under PyTorch's default f32 policy, as 12 does.

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
import sys
import threading
import time

import numpy as np
import torch

from refvsr_tpu_torch.bench import bound_ms, cuda_ms, device_kernels
from refvsr_tpu_torch.bench.e2e import card_line
from refvsr_tpu_torch.bench.probe_amp import amp_window
from refvsr_tpu_torch.bench.probe_amp import compare as amp_compare
from refvsr_tpu_torch.bench.probe_amp import patched
from refvsr_tpu_torch.bench.probe_amp import worst as worst_tensors
from refvsr_tpu_torch.bench.ties import tied_rows

# main-path geometry: 1080p input, T = 7, scale 4 with HD input
N, T, H, W = 1, 7, 1080, 1920
# K2 at the main path: ref rows, LR rows (both 3x3x16 patch vectors), and
# duplicated ref rows
K2_SHAPE = (32400, 129600, 144, 1000)
# training: batch 2 (the config's 8 does not fit one card); K2 matches the
# 2 x 7 frames' 32x32 LR features against 32x32 ref features
TRAIN_BATCH = 2
K2_TRAIN_SHAPE = (2 * T, 1024, 1024, 144, 16)
# the largest K2 similarity matrix the matmul + max yardstick materialises;
# past it, the yardstick runs one batch element at a time (an f32 element
# of the 1080p validation's batch is 16.8 GB, which the 80 GB card holds)
K2_LIBRARY_MAX_BYTES = 20e9
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
PIPE_FRAMES = 5
# how far a pipelined frame (bf16, batch-2 prop steps) may be from the
# plain stream's on the [0, 1] output: mean |difference| and max. On the
# H100 the two agreed bit for bit with cuDNN on both sides (it computes
# each lane of a batch-2 convolution as it computes one alone), and again
# on the routes production takes, the plain stream's batch-1 square
# convolutions on K3 and the lanes' on cuDNN; the max allows 4 bf16 ulps
# at 1.0 should another build pick another algorithm for batch 2
PIPE_MEAN_LIMIT, PIPE_MAX_LIMIT = 1e-4, 1.6e-2
# K3 against its plain version at ragged shapes (H, W), C
# (tile heights 8, 4 and 2 rows by C, tiles 64 pixels wide): mid-tile in
# H and W at every C, one row narrower than a tile, and images of more
# tiles than the card holds blocks, so each block's halo ring wraps
# K3 on the 8K stream's own inputs (phase 8), held in two parts. Against
# the plain version with the bias, the envelope above read 1.153 at
# 1080x1920x48 and 1.041 at 2160x3840x48 on the H100, max|d| 2^-8: one ulp
# of a pre-bias sum in [0.5, 1) that the bias cancels, where max|plain| is
# below 1, so the envelope's 2^-8 max|plain| falls short of that ulp. The
# library conv + bias, the path before K3, is reported beside it on the
# same calls. The bias-free sum holds the envelope, and the epilogue is
# held bit for bit
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


# seconds of each clocked span of the smoke, by its path among the spans
# open when it began ("phase" or "phase/part"), summed over its repeats,
# in the order first begun
SPANS: dict[str, float] = {}
_OPEN: list[str] = []


@contextlib.contextmanager
def clock(name):
    """Add the seconds of the enclosed work to SPANS under its path; a
    phase (a span begun with none open) logs its time as it ends."""
    _OPEN.append(name)
    path = "/".join(_OPEN)
    SPANS.setdefault(path, 0.0)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        s = time.perf_counter() - t0
        SPANS[path] += s
        _OPEN.pop()
        if not _OPEN:
            log(f"phase {name}: {s:.1f} s")


def seconds_by_phase():
    """{phase: seconds} of the top-level spans."""
    return {k: v for k, v in SPANS.items() if "/" not in k}


def time_table(total_s):
    """The phases sorted by time, each followed by its parts, and what no
    phase covers, as lines of text."""
    phases = seconds_by_phase()
    lines = [f"{'s':>8} {'share':>6}  phase (parts indented)"]
    for name, s in sorted(phases.items(), key=lambda kv: -kv[1]):
        lines.append(f"{s:8.1f} {s / total_s:6.3f}  {name}")
        lines += [f"{v:8.1f} {v / total_s:6.3f}    {k[len(name) + 1:]}"
                  for k, v in SPANS.items() if k.startswith(name + "/")]
    rest = total_s - sum(phases.values())
    lines.append(f"{rest:8.1f} {rest / total_s:6.3f}  outside the phases")
    return lines


def _finite(t):
    return bool(torch.isfinite(t.float()).all())


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


# torch.profiler passes over repeated calls (call_device_ms, forward_split)
# and those that came back with no device event at all. On the H100 a
# long-lived process loses whole passes so (221 of 388 in one run, most of
# them in the replay of the captured calls; none of 9 passes in three
# fresh processes, bench/probe_trace.py), so such a pass is run again, up
# to PROFILER_PASSES passes
PASSES = {"run": 0, "empty": 0}
PROFILER_PASSES = 5


def device_rows(fn, passes=PROFILER_PASSES):
    """device_kernels(fn) of the first of `passes` torch.profiler passes
    that holds a device event; [] if none does."""
    for _ in range(passes):
        rows = device_kernels(fn)
        PASSES["run"] += 1
        if rows:
            return rows
        PASSES["empty"] += 1
    return []


def call_device_ms(fn, wrapper, tag, reps=10, passes=PROFILER_PASSES):
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
        rows = device_rows(lambda: [fn() for _ in range(reps)], passes=1)
        kernel = sum(m for name, m, _ in rows if tag in name)
        if kernel > 0:
            return sum(m for _, m, _ in rows) / reps, kernel / reps
        launched = wrapper.launches - before
        check(launched == reps,
              f"{tag}: {launched} launches in {reps} calls of its wrapper")
        if rows:    # an empty pass is counted in PASSES
            log(f"profiler pass without {tag} ({launched} launches): "
                f"device events {[(name[:60], n) for name, _, n in rows][:8]}")
    return None, None


def _ms(v):
    return "not measured" if v is None else f"{v:.4f} ms"


def forward_split(call, wrapper, tag, library):
    """The "device (kernel) / call" split of a forward kernel's call, as
    the backward cases have it: (device ms of a call, of its kernel alone,
    device ms of a call of `library`), each from a torch.profiler pass of
    10 calls (None: not measured). The call's CUDA-event time over
    back-to-back calls is the larger of the device's and the host's per
    call, so at tiny shapes it times the launcher; these do not."""
    dev_ms, kernel_ms = call_device_ms(call, wrapper, tag)
    rows = device_rows(lambda: [library() for _ in range(10)])
    lib_ms = sum(m for _, m, _ in rows) / 10 if rows else None
    return dev_ms, kernel_ms, lib_ms


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

    def call():
        return warp_sample(x, flow)

    with clock("K1 kernel"):
        ms = cuda_ms(call)
    with clock("K1 plain"):
        plain_ms = cuda_ms(lambda: warp_sample_plain(x, flow), iters=1,
                           warmup=1)
    with clock("K1 library"):
        library_ms = cuda_ms(library)
    with clock("K1 device split"):
        dev_ms, kernel_ms, lib_dev_ms = forward_split(
            call, warp_sample, KERNEL_TAGS["warp_sample"], library)
    nbytes = _nbytes(x, flow, got)
    flops = 8 * got.numel()     # four corner multiply-adds per value
    b_ms, b_by = bound_ms(nbytes, flops, x.dtype)
    log(f"K1 {name}: x {tuple(x.shape)} {x.dtype} -> {tuple(got.shape)}; "
        f"dead {n_dead}; max_abs_err {err:.3e} (limit {limit:.3e}); "
        f"call {ms:.4f} ms, device {_ms(dev_ms)} (kernel {_ms(kernel_ms)}), "
        f"plain {plain_ms:.4f} ms, grid_sample {library_ms:.4f} ms (device "
        f"{_ms(lib_dev_ms)}), bound {b_ms:.4f} ms ({b_by})")
    return dict(case=name, max_abs_err=err, tolerance=limit, ms=ms,
                device_ms=dev_ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, library_device_ms=lib_dev_ms,
                bound_ms=b_ms, bound_by=b_by, nbytes=nbytes, flops=flops,
                peak=x.dtype)


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


# the shape at which K1's wrapper is taken apart on the host: the IR
# training step's warp of x 8x64x64x36 (f32), where a call's CUDA-event
# time lost to grid_sample's
K1_HOST_SHAPE = (8, 64, 64, 36)


def k1_host_pieces(dev, card):
    """Host microseconds of a K1 call at K1_HOST_SHAPE and of its pieces
    (``ops/kernels/warp_sample.py``: the checks, the output's
    ``torch.empty``, the typed launcher's lookup, ``build.launch`` with the
    ctypes call and the kernel's enqueue, the ctypes call alone), and of a
    ``F.grid_sample`` call on the same coordinates, the device idle before
    each round (``bench.host_us``)."""
    import torch.nn.functional as F

    from refvsr_tpu_torch.bench import host_us
    from refvsr_tpu_torch.ops.kernels import build
    from refvsr_tpu_torch.ops.kernels import warp_sample as k1
    gen = torch.Generator(device=dev).manual_seed(21)
    n, h, w, c = K1_HOST_SHAPE
    x = torch.rand((n, h, w, c), generator=gen, device=dev)
    flow = _smooth_flow(gen, n, h, w, 6.0, dev)
    out = torch.empty_like(x)
    fn = build.function("warp_sample", "warp_sample_launch", k1._FORWARD_ARGS)
    args = (x.data_ptr(), flow.data_ptr(), out.data_ptr(), n, h, w, c, h, w,
            k1._DTYPES[x.dtype])
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    nchw = x.permute(0, 3, 1, 2)
    grid = _library_grid((h, w), flow, x.dtype)
    pieces = {
        "checks": lambda: (k1._check(x, flow), k1._check_cuda(x, flow)),
        "torch.empty": lambda: torch.empty((n, h, w, c), dtype=x.dtype,
                                           device=x.device),
        "build.function": lambda: build.function(
            "warp_sample", "warp_sample_launch", k1._FORWARD_ARGS),
        "build.launch": lambda: build.launch(fn, x.device, *args),
        "ctypes call": lambda: fn(*args, stream),
        "warp_sample call": lambda: k1.warp_sample(x, flow),
        "F.grid_sample call": lambda: F.grid_sample(
            nchw, grid, mode="bilinear", padding_mode="zeros",
            align_corners=False)}
    us = {k: host_us(f) for k, f in pieces.items()}
    log(f"K1 host pieces at x {'x'.join(map(str, K1_HOST_SHAPE))} f32 (us a "
        f"call, median of 5 rounds of 200): "
        + ", ".join(f"{k} {v:.2f}" for k, v in us.items()) + f"  [{card}]")
    return us


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
# K2 calls up to this many ms (CUDA events) also get the "device (kernel)
# / call" split: ten more calls of the kernel and of its yardstick
K2_SPLIT_MS = 5.0


def k2_case(name, ref, lr, dup=0, first=(), iters=5, plain_iters=2,
            split=True):
    """K2 kernel vs plain on one input; returns a dict of its numbers.
    conf within 1e-4; the kernel's pick scores within 1e-4 of the max (so
    picks may differ only where the top-2 gap is <= 1e-4); the last `dup`
    ref rows, copies of the first ones, never win; LR row i picks
    `first[i]`. With `split`, a call of at most K2_SPLIT_MS also gets the
    "device (kernel) / call" split."""
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

    def call():
        return argmax_matmul(ref, lr)

    # the library yardstick, two calls: the whole similarity by matmul, then
    # its row max; only where that matrix fits beside the inputs
    sim_bytes = n * l_lr * l_ref * ref.element_size()
    if sim_bytes > K2_LIBRARY_MAX_BYTES:
        # 250-320 ms a call on the H100: the kernel and the yardstick are
        # timed once after one warm-up, as the plain version is
        iters = 1
    with clock("K2 kernel"):
        ms = cuda_ms(call, iters=iters, warmup=1)
    with clock("K2 plain"):
        plain_ms = cuda_ms(lambda: argmax_matmul_plain(ref, lr),
                           iters=plain_iters, warmup=1)
    library = None
    if sim_bytes <= K2_LIBRARY_MAX_BYTES:
        def library():
            return torch.matmul(lr, ref.transpose(1, 2)).max(dim=2)
    elif sim_bytes / n <= K2_LIBRARY_MAX_BYTES:
        # 2n calls: one batch element's similarity fits, the whole does not
        def library():
            for b in range(n):
                torch.matmul(lr[b], ref[b].T).max(dim=1)
    library_ms = None
    if library is not None:
        with clock("K2 library"):
            library_ms = cuda_ms(library, iters=iters, warmup=1)
    dev_ms = kernel_ms = lib_dev_ms = None
    split = split and ms <= K2_SPLIT_MS and library is not None
    if split:
        with clock("K2 device split"):
            dev_ms, kernel_ms, lib_dev_ms = forward_split(
                call, argmax_matmul, KERNEL_TAGS["argmax_matmul"], library)
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
        f"{gap:.3e}); call {ms:.3f} ms"
        + (f", device {_ms(dev_ms)} (kernel {_ms(kernel_ms)})" if split
           else "")
        + f", plain {plain_ms:.3f} ms, matmul + max {lib}"
        + (f" (device {_ms(lib_dev_ms)})" if split else "")
        + f", bound {b_ms:.4f} ms ({b_by}, {peak})")
    return dict(case=name, max_abs_err=err, tolerance=1e-4, ms=ms,
                device_ms=dev_ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, library_device_ms=lib_dev_ms,
                bound_ms=b_ms, bound_by=b_by, index_differs=n_diff,
                nbytes=nbytes, flops=flops, peak=peak)


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


# the keys of the bench's stream record (bench.py's, launches in place of
# pallas_warp, the time per window, the peak and the card)
BENCH_STREAM_KEYS = ("metric", "value", "unit", "vs_baseline", "raw_fps",
                     "out_shape", "lanes", "k1_launches", "k2_launches",
                     "ms_per_window", "peak_bytes", "card")
# the kernels of the stream and training paths; K3 runs on the bf16
# inference paths (``blocks.takes_k3``) and its microbenchmark, K4 only on
# its microbenchmark
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
            "warp_sample_banded": k1.warp_sample_banded,
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


def _k3_ratio(got, want, rows=256):
    """``microbench_conv.envelope_ratio`` over bands of rows: an (H, W, C)
    image's f32 temporaries at once would take GBs at the path's 2x
    shapes."""
    top = float(want.abs().max())
    worst = 0.0
    for r in range(0, want.shape[0], rows):
        w = want[r:r + rows].float()
        limit = 2.0 ** -7 * w.abs() + 2.0 ** -8 * top
        worst = max(worst, float(((got[r:r + rows].float() - w).abs()
                                  / limit).max()))
    return worst


@contextlib.contextmanager
def checking_k3(cases, where):
    """Hold every K3 call made inside against its plain version as it runs
    (``conv3x3_bias`` as ``models/blocks`` looks it up), in two parts:
    K3 again with a zero bias, the bias-free sum rounded to bf16, within
    ``_k3_ratio``'s envelope of the plain version's; and the call's output
    bit for bit bf16(that sum + bias), the epilogue's rounding. Where the
    bias cancels most of a sum, one ulp of the sum is more than the
    envelope allows the result (the note at ``K3_RAGGED``), so the output
    against the plain version with bias, and the library conv + bias (as
    ``Conv2d`` made it before K3) against it too, are reported, not held.
    Kept per (H, W, C) shape: the calls, the largest ratio of each
    comparison and |difference|. On exit each shape is timed alone once on
    its first call's inputs (K3, the plain version, the library conv) and
    `cases` gets a case per shape, its times, bytes and operations summed
    over its calls. No input is kept beyond one a shape."""
    import torch.nn.functional as F

    from refvsr_tpu_torch.ops.kernels import conv3x3 as k3_mod
    fn = k3_mod.conv3x3_bias
    by_shape = {}

    def library(x, wm, bias):
        c = x.shape[2]
        k = wm.reshape(3, 3, c, c).permute(3, 2, 0, 1).contiguous()
        return F.conv2d(x[None].permute(0, 3, 1, 2), k, bias.reshape(c),
                        padding=1)[0].permute(1, 2, 0)

    class Spy:
        def __call__(self, x, wm, bias):
            y = fn(x, wm, bias)
            zero = torch.zeros_like(bias)
            n = fn.launches
            z = fn(x, wm, zero)
            fn.launches = n
            want_z = k3_mod.conv3x3_bias_plain(x, wm, zero)
            want = want_z + bias
            key = tuple(x.shape)
            s = by_shape.setdefault(key, dict(
                calls=0, ratio=0.0, epilogue_equal=True, max_abs_err=0.0,
                ratio_with_bias=0.0, library_ratio_with_bias=0.0,
                finite=True, first=tuple(_clone(t) for t in (x, wm, bias))))
            s["calls"] += 1
            s["ratio"] = max(s["ratio"], _k3_ratio(z, want_z))
            s["epilogue_equal"] = (s["epilogue_equal"]
                                   and torch.equal(y, z + bias))
            s["ratio_with_bias"] = max(s["ratio_with_bias"],
                                       _k3_ratio(y, want))
            s["library_ratio_with_bias"] = max(
                s["library_ratio_with_bias"],
                _k3_ratio(library(x, wm, bias), want))
            s["max_abs_err"] = max(s["max_abs_err"], float(
                (y.float() - want.float()).abs().max()))
            s["finite"] = s["finite"] and _finite(y)
            del z, want_z, want
            return y

        @property
        def launches(self):
            return fn.launches

        @launches.setter
        def launches(self, n):
            fn.launches = n

    k3_mod.conv3x3_bias = Spy()
    try:
        yield
    finally:
        k3_mod.conv3x3_bias = fn
    for (h, w, c), s in by_shape.items():
        x, wm, bias = s.pop("first")
        with clock("K3 alone"):
            one = dict(
                ms=cuda_ms(lambda: fn(x, wm, bias), 5),
                plain_ms=cuda_ms(
                    lambda: k3_mod.conv3x3_bias_plain(x, wm, bias), 2, 1),
                library_ms=cuda_ms(lambda: library(x, wm, bias), 5))
        n = s["calls"]
        nbytes = _nbytes(x, wm, bias, x)
        cases.append(dict(
            label=f"{where}: {h}x{w}x{c}, {n} calls", shape=[h, w, c],
            **s, **{key: n * v for key, v in one.items()},
            ms_a_call=one["ms"], nbytes=n * nbytes,
            flops=n * 2.0 * h * w * c * 9 * c, peak=torch.bfloat16))
        del x, wm, bias


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


KERNEL_TAGS = {"conv3x3_bias": "conv3x3_bias_kernel",
               "warp_sample": "warp_sample_kernel",
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


def traced():
    """A torch.profiler session over a window or a step that records the
    device's activity only (kernels, memsets, the runtime's launch calls):
    the host's operators are not read, and a training step's tens of
    thousands of them took 16-20 s to parse."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def profiled_window(runner, lrs, refs, card):
    """One forward_stream window traced by torch.profiler: device ms and
    launches of each hand-written kernel inside the main path."""
    with traced() as prof:
        t0 = time.perf_counter()
        runner.process_device(lrs, refs, is_first=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return device_profile(prof, ("warp_sample", "argmax_matmul",
                                 "conv3x3_bias"),
                          "forward_stream window", wall_ms, card)[0]


def phase_main_path(dev, card):
    """The stream through the bench's stream leg (``bench/e2e.run_stream``,
    the entry point ``python -m refvsr_tpu_torch.bench.e2e`` calls) at full
    size, its record checked; then one more streamed window traced, and the
    kernels' inputs captured in a further streamed window and in a new
    first window."""
    from refvsr_tpu_torch.bench import e2e
    from refvsr_tpu_torch.configs import get_config
    from refvsr_tpu_torch.models import matching as matching_mod
    from refvsr_tpu_torch.ops import warp as warp_mod

    cfg = get_config("RefVSR_MFID_8K")
    check((cfg.scale, cfg.num_blocks, cfg.mid_channels, cfg.flag_HD_in,
           cfg.matching_ksize) == (4, 30, 48, True, 8), f"config {cfg}")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with clock("bench stream leg"):
        res = e2e.run_stream(H, W, device=dev)
    leg_s = time.perf_counter() - t0
    launches = read_launches()
    rec = res.record
    log(f"bench stream record: {json.dumps(rec)}")
    check(set(BENCH_STREAM_KEYS) <= set(rec), f"bench record keys {rec}")
    check(rec["metric"] == "stream_fps_8k" and rec["unit"] == "fps"
          and rec["out_shape"] == [N, 4 * H, 4 * W, 3] and rec["lanes"] == 0
          and rec["value"] > 0 and rec["card"] == card,
          f"bench stream record {rec}")
    check((rec["k1_launches"], rec["k2_launches"]) == (10, 1),
          f"bench window launches {(rec['k1_launches'], rec['k2_launches'])}"
          f" != (10, 1)")
    windows = 1 + e2e.WARMUP + e2e.ITERS
    want = {"warp_sample": 16 + 10 * (windows - 1),
            "argmax_matmul": windows}
    check(all(launches[k] == v for k, v in want.items()),
          f"bench stream leg launches {launches}, want {want}")
    check(launches["warp_sample_backward"] == 0
          and launches["argmax_matmul_backward"] == 0,
          "streaming launched a backward kernel")
    check(launches["conv3x3_bias"] > 0 and not launches["gather_rows"],
          f"streaming launched no K3, or K4: {launches}")
    log(f"main path (bench stream leg, {leg_s:.1f} s with the net's build): "
        f"forward_stream {rec['ms_per_window']:.1f} ms/window (mean of "
        f"{e2e.ITERS} after {e2e.WARMUP} warm-up windows), "
        f"{rec['value']} fps; K3 {launches['conv3x3_bias']} launches in "
        f"{windows} windows; output {tuple(res.out.shape)} bf16, numerics "
        f"gate passed; peak allocated {rec['peak_bytes'] / 2**30:.2f} GiB "
        f"[{card}]")

    # the kernels inside the path: device time of one more streamed window,
    # traced; then the inputs the path hands each kernel, captured in a
    # further streamed window and in a new first window (once for each
    # shape the streamed window lacks: K1's low-res features onto the 2x
    # grid, K2 at batch T), for the comparisons with the plain versions
    runner = res.runner
    lrs, refs = (torch.as_tensor(a).to(device=dev, dtype=torch.bfloat16)
                 for a in (res.lrs, res.refs))
    del res
    with clock("traced window"):
        in_path = profiled_window(runner, lrs, refs, card)
    stream_calls = {"warp_sample": [], "argmax_matmul": []}
    first_calls = {"warp_sample": [], "argmax_matmul": []}
    k3_cases = []
    with capturing(warp_mod, "warp_sample", stream_calls["warp_sample"]), \
            capturing(matching_mod, "argmax_matmul",
                      stream_calls["argmax_matmul"]), \
            checking_k3(k3_cases, "forward_stream"), clock("K3 held"):
        runner.process_device(lrs, refs, is_first=False)
    for c in k3_cases:
        log(f"K3 in the path, {c['label']}: bias-free sum at "
            f"{c['ratio']:.3f} of the envelope, epilogue bit for bit "
            f"{c['epilogue_equal']}; with the bias {c['ratio_with_bias']:.3f}"
            f" of it (library conv + bias {c['library_ratio_with_bias']:.3f}"
            f"), max|d| {c['max_abs_err']:.4g}; alone {c['ms_a_call']:.4f} "
            f"ms a call  [{card}]")
        check(c["finite"] and c["ratio"] <= 1.0 and c["epilogue_equal"],
              f"K3 {c['label']}: the bias-free sum at {c['ratio']:.3f} of "
              f"the envelope 2^-7 |plain| + 2^-8 max|plain|, or the "
              f"epilogue not bf16(sum + bias): {c}")
    seen = {k: {_shape_key(a) for a, _ in v} for k, v in stream_calls.items()}
    with capturing(warp_mod, "warp_sample", first_calls["warp_sample"],
                   seen["warp_sample"]), \
            capturing(matching_mod, "argmax_matmul",
                      first_calls["argmax_matmul"], seen["argmax_matmul"]):
        runner.process_device(lrs, refs, is_first=True)
    torch.cuda.synchronize()
    del runner, lrs, refs
    torch.cuda.empty_cache()
    check([len(v) for v in stream_calls.values()] == [10, 1],
          "captured streamed window: launches != (10, 1)")
    check(sum(c["calls"] for c in k3_cases) == in_path["conv3x3_bias"][
        "launches"], f"K3: {in_path['conv3x3_bias']['launches']} launches "
        f"in the traced window, {[c['calls'] for c in k3_cases]} held")
    check([len(v) for v in first_calls.values()] == [1, 1],
          "captured first window: shapes new to it != (1, 1)")
    return launches, rec, in_path, stream_calls, first_calls, k3_cases


def _scene(rng, h, w):
    """A seeded smooth image with noise, (h, w, 3) in [0, 1]."""
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    base = np.stack([np.sin(7 * xx + 3 * yy), np.cos(5 * yy - 2 * xx),
                     np.sin(4 * (xx + yy))], -1) * 0.4 + 0.5
    return np.clip(base + rng.normal(0, 0.03, (h, w, 3)), 0, 1)


# the processes of the host pool (host_pool): the seeded PNG trees' encoder
# is the set-up's bottleneck; the card's machine has 8 cores
HOST_WORKERS = 6


def _write_scene(job):
    """One seeded scene (seed, h, w, outputs), written at each output's
    (path, stride)."""
    from refvsr_tpu_torch.data.png import write_image
    seed, h, w, outs = job
    img = _scene(np.random.default_rng(seed), h, w)
    for path, stride in outs:
        write_image(path, img[::stride, ::stride])


_HOST_POOL = []


def host_pool():
    """HOST_WORKERS spawned processes for the smoke's host work (the seeded
    PNG trees, the training entry's reference batches and the is_amp
    window's CPU side), started at the first call and kept for the next
    (``main`` stops them)."""
    import concurrent.futures
    import multiprocessing
    if not _HOST_POOL:
        _HOST_POOL.append(concurrent.futures.ProcessPoolExecutor(
            HOST_WORKERS, mp_context=multiprocessing.get_context("spawn")))
    return _HOST_POOL[0]


# the seeded PNG trees of the later phases: {phase: (root, futures of its
# scenes)}, begun by start_trees and awaited by tree()
_TREES = {}


def start_trees():
    """Begin writing the seeded PNG trees of the training entry, the IR
    eval, the 8K eval CLI and the train CLI on the host pool, each under a
    new directory, and return at once: the DDP phase's ranks run meanwhile
    (their steps are device-bound), and each phase waits for its own
    tree."""
    import tempfile
    for name, jobs in (("entry", lambda r: tree_jobs(r, 13000)),
                       ("ir", lambda r: eval_tree_jobs(r, 17000, hd=False)),
                       ("8k", lambda r: eval_tree_jobs(r, 19000, hd=True)),
                       ("cli", cli_tree_jobs)):
        root = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
        _TREES[name] = (root, [host_pool().submit(_write_scene, job)
                               for job in jobs(root)])


@contextlib.contextmanager
def tree(name):
    """(root, seconds waited for its writes) of the tree start_trees began
    for phase `name`; the directory is removed when the phase ends."""
    import shutil
    root, futures = _TREES.pop(name)
    t0 = time.perf_counter()
    try:
        with clock("tree"):
            for f in futures:
                f.result()
        yield root, time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)


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
              and n["conv3x3_bias"] == per_call[0]["conv3x3_bias"] > 0
              and not any(v for k, v in n.items() if k not in (
                  "warp_sample", "argmax_matmul", "conv3x3_bias")),
              f"serving: predict {i} launched {n}, not K1 8, K2 1 and K3 "
              f"as the first predict")
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
        f"{per_call[-1]['argmax_matmul']} and K3 "
        f"{per_call[-1]['conv3x3_bias']} launches per predict; peak "
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

    with clock("small"):
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
        seen = {"warp_sample": 0, "argmax_matmul": 0, "conv3x3_bias": 0}

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
        with clock(f"lanes {lanes}"):
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
        check(not any(v for k, v in n.items() if k not in (
                  "warp_sample", "argmax_matmul", "conv3x3_bias")),
              f"{name} stream launched a kernel off its path: {n}")
        log(f"{name} stream, full width: " + "; ".join(
            f"{d['kind']}: {d['ms']:.1f} ms, K1 {d['warp_sample']}, K2 "
            f"{d['argmax_matmul']}, K3 {d['conv3x3_bias']}, emits "
            f"{d['emitted']}" for d in r["dispatches"]) + f"  [{card}]")
    # K3 takes the batch-1 convolutions: every plain window's, and of the
    # pipelined dispatches' those outside the lanes
    k3 = [[d["conv3x3_bias"] for d in r["dispatches"][:-1]]
          for r in (plain, piped)]
    check(all(k3[0]) and len(set(k3[0][1:])) == 1
          and len(set(k3[1][PIPE_LANES:])) == 1
          and 0 < k3[1][-1] < k3[0][-1],
          f"K3 launches per dispatch: plain {k3[0]}, pipelined {k3[1]}")
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
    with clock("iteration"):
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
            traced() as prof:
        t0 = time.perf_counter()
        tr.train_step(state, *window(arrays, cfg.frame_itr_num - 1,
                                     cfg.frame_num))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with clock("trace read"):
        in_step, summary["profiled_step"] = device_profile(
            prof, KERNEL_FNS, "training step", wall_ms, card, top=20)
    for name in ("warp_sample_backward", "argmax_matmul_backward"):
        check(in_step[name]["launches"] == len(calls[name]),
              f"{name}: {in_step[name]['launches']} launches in the traced "
              f"step, {len(calls[name])} captured")
    del tr, arrays, state, prof
    torch.cuda.empty_cache()
    return launches, summary, in_step, calls


def phase_bench_train(dev, card, stream_record):
    """The bench's train leg (``bench/e2e.run_train``, the entry point's
    ``--train`` leg): RefVSR_MFID at full width, patch 64, batch 1, one
    window, an untimed and four timed iterations with the launches counted;
    its fields merged into the stream leg's record as the bench prints it
    last. Then one more iteration (one step) with every kernel's inputs
    captured. Returns (launches, summary, captured calls)."""
    from refvsr_tpu_torch.bench import e2e
    from refvsr_tpu_torch.models import matching as matching_mod
    from refvsr_tpu_torch.ops import warp as warp_mod
    from refvsr_tpu_torch.ops.kernels import argmax_matmul as k2_mod
    from refvsr_tpu_torch.ops.kernels import warp_sample as k1_mod

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with clock("bench train leg"):
        res = e2e.run_train(device=dev)
    leg_s = time.perf_counter() - t0
    launches = read_launches()
    cfg, f = res.trainer.config, res.fields
    check((cfg.config, cfg.num_blocks, cfg.mid_channels, cfg.flag_HD_in,
           cfg.patch_size, cfg.batch_size, cfg.frame_num, cfg.frame_itr_num,
           cfg.loss, cfg.spynet_ckpt, cfg.vgg19_ckpt)
          == ("RefVSR_MFID", 30, 48, False, 64, 1, 7, 1,
              "1*L1_lf+0.05*MFID_ref_X_mu+0.01*FID_hr", None, None),
          f"bench train config {cfg}")
    check(f["train_patch"] == 64 and f["train_windows"] == 1
          and f["train_steps_per_s"] > 0
          and np.isfinite(res.first_errors["total"]),
          f"bench train fields {f}, first errors {res.first_errors}")
    iters = e2e.TRAIN_ITERS + 1
    check(all(f["train_launches"][k] > 0
              and launches[k] == f["train_launches"][k] * iters
              for k in KERNEL_FNS)
          and not any(launches[k] for k in BENCH_FNS.values()),
          f"bench train launches {launches}, per iteration "
          f"{f['train_launches']}")
    record = {**stream_record, **f}
    log(f"bench record: {json.dumps(record)}")

    calls = {name: [] for name in KERNEL_FNS}
    seen = {"warp_sample": set(), "argmax_matmul": set()}
    with capturing(warp_mod, "warp_sample", calls["warp_sample"],
                   seen["warp_sample"]), \
            capturing(matching_mod, "argmax_matmul", calls["argmax_matmul"],
                      seen["argmax_matmul"]), \
            capturing(k1_mod, "warp_sample_backward",
                      calls["warp_sample_backward"]), \
            capturing(k2_mod, "argmax_matmul_backward",
                      calls["argmax_matmul_backward"]):
        errs, _ = res.trainer.iteration(res.batch)
    check(np.isfinite(errs["total"]) and all(calls[k] for k in KERNEL_FNS),
          f"bench train captured step: errors {errs}, calls "
          f"{ {k: len(v) for k, v in calls.items()} }")
    log(f"bench train leg (RefVSR_MFID full width, patch 64, batch 1, f32 "
        f"with PyTorch's default TF32 convolutions): "
        f"{f['train_steps_per_s']} steps/s, {f['train_ms_per_step']:.1f} "
        f"ms/step over {e2e.TRAIN_ITERS} iterations; {leg_s:.1f} s with the "
        f"trainer's build; launches per iteration {f['train_launches']}; "
        f"captured step {({k: len(v) for k, v in calls.items()})}  [{card}]")
    del res
    torch.cuda.empty_cache()
    return launches, dict(record=record, leg_s=leg_s), calls


# the training entry point: a seeded 1080p PNG tree laid out as
# set_data_path reads it under flag_HD_in (every stream under HR/). Train:
# one clip of 18 frames per camera, two samples of 7 + 9 - 1 frames, one
# batch of 2; valid: one clip of 1 frame per camera, one window (the f32
# 8K streamed windows run in the eval CLI's phase)
TREE_FRAMES = {"train": 18, "valid": 1}
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
AMP_SEEDS = (14, 3)    # the window's data and weights
AMP_LOSS_RTOL = {"MFID": 1e-1, "other": 3e-2}
AMP_GRAD_OVERALL = 5e-2
AMP_GRAD_VS_PLAIN = 5e-2


def tree_jobs(root, seed):
    """The scenes of the training entry's seeded PNG tree under `root`."""
    return [(seed + i, H, W, [(f"{root}/RealMCVSR/{split}/HR/{cam}/0000/"
                               f"{i:04d}.png", 1)])
            for split, n in TREE_FRAMES.items() for cam in ("UW", "W", "T")
            for i in range(n)]


def _loader_batch(cfg):
    """(samples, ms, first batch) of TrainLoader on the tree (run on the
    host pool)."""
    from refvsr_tpu_torch.data.datasets import TrainDataset, TrainLoader
    ds = TrainDataset(cfg)
    t0 = time.perf_counter()
    batch = next(iter(TrainLoader(ds, cfg.batch_size, seed=cfg.manual_seed)))
    return len(ds), (time.perf_counter() - t0) * 1e3, batch


def phase_loader(cfg, card, job):
    """ms per batch of TrainLoader on the tree, from `job` (a future of
    _loader_batch, run on the host pool while run.main trains), its
    batch's shapes checked. Returns (summary, the batch): run.main's
    4-worker MultiWorkerLoader must deliver the same first batch."""
    n, single_ms, want = job.result()
    check(n == 2, f"loader: {n} training samples, not 2")
    p, t = cfg.patch_size, cfg.frame_num + cfg.frame_itr_num - 1
    shapes = {k: want[k].shape for k in ("LR_UW", "LR_REF_W", "HR_UW",
                                         "HR_REF_T")}
    b = cfg.batch_size
    check(shapes == {"LR_UW": (b, t, p, p, 3),
                     "LR_REF_W": (b, t, 2 * p, 2 * p, 3),
                     "HR_UW": (b, t, p, p, 3),
                     "HR_REF_T": (b, t, 4 * p, 4 * p, 3)},
          f"loader: batch shapes {shapes}")
    log(f"loader (batch {b}, {t} frames x 6 streams of {H}x{W} PNG a "
        f"sample): TrainLoader {single_ms:.1f} ms/batch (on the host pool, "
        f"beside run.main's first epoch)  [{card}]")
    return dict(train_loader_ms=single_ms), want


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
        self.first_batch = None


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
            if rec.first_batch is None:
                rec.first_batch = batch
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


def amp_config(root):
    from refvsr_tpu_torch.configs import get_config, set_data_path
    return set_data_path(get_config(
        "RefVSR_small_MFID_8K", data_offset=root, is_train=True,
        **NO_ASSETS), True)


def _amp_item(job):
    """Item j of the is_amp batch from the tree at `root` (run on the host
    pool): sample j % len(ds) under the augmentation draws of epoch
    j // len(ds), as one worker of the loader would draw them."""
    from refvsr_tpu_torch.data.datasets import TrainDataset, sample_rng
    root, j = job
    cfg = amp_config(root)
    ds = TrainDataset(cfg)
    with _cached_reads():
        return ds.__getitem__(j % len(ds), rng=sample_rng(
            cfg.manual_seed, j // len(ds), j % len(ds)))


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


def amp_items(root):
    """Futures of the is_amp batch's items (_amp_item), started on the host
    pool so that they are made while run.main's epochs run."""
    return [host_pool().submit(_amp_item, (root, j))
            for j in range(amp_config(root).batch_size)]


def phase_amp(dev, card, root, items, cpu):
    """One Trainer.iteration of RefVSR_small_MFID_8K (is_amp: bf16 compute
    on f32 master weights) at the config's batch of 8 from the tree (its
    two samples, each under four epochs' augmentation draws: `items`, from
    amp_items), the backward kernels' calls of its first step captured;
    then the card against the CPU on one is_amp window of a tiny net (its
    CPU side `cpu`, a future of amp_window made on the host pool). Returns
    (summary, captured calls)."""
    from refvsr_tpu_torch.data.datasets import collate
    from refvsr_tpu_torch.ops.kernels import argmax_matmul as k2_mod
    from refvsr_tpu_torch.ops.kernels import warp_sample as k1_mod
    from refvsr_tpu_torch.train.trainer import Trainer

    cfg = amp_config(root)
    n = cfg.batch_size
    check((cfg.is_amp, cfg.num_blocks, cfg.mid_channels, cfg.frame_num,
           cfg.flag_HD_in, cfg.batch_size, cfg.patch_size)
          == (True, 24, 24, 3, True, 8, 128),
          f"is_amp config {cfg}")
    with clock("batch"):
        batch = collate([f.result() for f in items])
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
    with clock("card vs CPU"):
        r = amp_compare(dev, *AMP_SEEDS, cpu=cpu.result())
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
    second epoch, then the is_amp iteration. The host pool makes
    TrainLoader's batch, the is_amp batch and the is_amp window's CPU side
    while the epochs run.
    Returns (launches of the first epoch, summary, captured kernel calls of
    the epoch's first step and first validation window, those of the
    is_amp step)."""
    from refvsr_tpu_torch import run
    from refvsr_tpu_torch.models import matching as matching_mod
    from refvsr_tpu_torch.ops import warp as warp_mod
    from refvsr_tpu_torch.ops.kernels import argmax_matmul as k2_mod
    from refvsr_tpu_torch.ops.kernels import warp_sample as k1_mod
    from refvsr_tpu_torch.train.runner import Runner

    calls = {name: [] for name in KERNEL_FNS}
    summary = dict(card=card)
    with tree("entry") as (root, tree_s):
        n_png = 3 * sum(TREE_FRAMES.values())
        log(f"PNG tree: {n_png} seeded {H}x{W} frames, waited "
            f"{tree_s:.1f} s for the host pool")
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
        summary["tree_wait_s"] = tree_s
        loader_job = host_pool().submit(_loader_batch, cfg)
        amp_batch = amp_items(root)
        amp_cpu = host_pool().submit(amp_window, "cpu", *AMP_SEEDS)

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
            with clock("epoch 0"):
                runner = run.main(argv + ["--total_itr", "9"])
            main_ms = (time.perf_counter() - t0) * 1e3
            summary["epoch0"] = epoch_summary(rec, "epoch 0 via run.main",
                                              card)
        launches = read_launches()
        summary["epoch0"].update(run_main_ms=main_ms, launches=launches)
        with clock("TrainLoader"):
            summary["loader"], want_batch = phase_loader(cfg, card,
                                                         loader_job)
        check(rec.first_batch is not None and all(
            np.array_equal(rec.first_batch[k], want_batch[k])
            for k in want_batch),
            "loader: run.main's MultiWorkerLoader batch differs from "
            "TrainLoader's")
        log(f"loader: run.main's {cfg.thread_num}-worker MultiWorkerLoader "
            f"delivered TrainLoader's batch")
        del want_batch
        tr = runner.trainer
        check(tr.opt.step == cfg.frame_itr_num == len(rec.iters) * 9,
              f"epoch 0: {tr.opt.step} steps in {len(rec.iters)} batches")
        check(all(launches[k] > 0 for k in KERNEL_FNS)
              and not any(launches[k] for k in BENCH_FNS.values()),
              f"epoch 0: a kernel was not launched, or K3/K4 was {launches}")
        v = summary["epoch0"]
        check(np.isfinite(v["psnr"]) and len(v["valid_window_ms"]) == 1,
              f"epoch 0: PSNR {v['psnr']}, {len(v['valid_window_ms'])} "
              f"validation windows")
        check(v["valid_launches"]["argmax_matmul"] == 1
              and v["valid_launches"]["warp_sample"] == 16,
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
        with instrumented(rec), patched(Runner, "resume", resume), \
                clock("epoch 1"):
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
        with clock("to_host"):
            to_host(calls)
        torch.cuda.empty_cache()
        log(f"before the is_amp iteration: "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
        with clock("is_amp"):
            summary["amp"], amp_calls = phase_amp(dev, card, root,
                                                  amp_batch, amp_cpu)
    return launches, summary, calls, amp_calls


# ------------------------------------------- RefVSR-IR and the eval CLI

# the IR eval tree: RealMCVSR's test layout at its size (LRx4 270x480 for
# the UW input and the W and T references, HR 1080x1920 ground truth); two
# videos, the second for the FOV and conf modes
IR_HW = (270, 480)
IR_VIDEOS = (("0000", 5), ("0001", 1))
# the eval CLI on RefVSR_MFID_8K: a 1080p HR tree, one video of a first
# window and a streamed one
EVAL_8K_FRAMES = 2
# the window whose EDVR and deformable convolutions are timed apart (their
# timers synchronise the card), the next (whose kernel calls are
# captured) and the one traced by torch.profiler, all streamed windows of
# the first video; the timed and the traced window are left out of the ms
# per streamed window
IR_TIMED_WINDOW = 1
IR_PROFILED_WINDOW = 3


def _ir_batch(cfg, seed):
    """A seeded training batch with RealMCVSR's geometry without HD input
    (data/datasets.py get_patch): LR_UW p^2, LR_REF_W (2p)^2, HR_UW and
    HR_REF_W (4p)^2, each (b, frame_num + frame_itr_num - 1, side, side,
    3)."""
    rng = np.random.default_rng(seed)
    n, p = cfg.batch_size, cfg.patch_size
    t = cfg.frame_num + cfg.frame_itr_num - 1

    def img(side):
        return rng.random((n, t, side, side, 3), dtype=np.float32)
    return {"LR_UW": img(p), "LR_REF_W": img(2 * p), "HR_UW": img(4 * p),
            "HR_REF_W": img(4 * p)}


def _fractional_offsets(net, seed):
    """Redraw the deformable convolutions' offset convs (zero at init, so
    every tap would sit on the grid) so that the card's and the CPU's
    samplers work at fractional positions."""
    from refvsr_tpu_torch.models.edvr import ModulatedDCNPack
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, ModulatedDCNPack):
                w = m.conv_offset.weight
                w.copy_(torch.randn(w.shape, generator=gen).to(w) * 0.1)


def phase_ir_small(dev):
    """Tiny RefVSR-IR on the card (f32, kernels) against the CPU (f32,
    plain versions): a first window and two streamed windows through
    StreamRunner(keyframe_stride), each output within 1e-3, with the
    kernels' launches per window; then one Trainer.iteration of a tiny
    RefVSR_IR_MFID (its loss, 2 steps) on both, the mean errors within
    rtol 2e-4 (the contextual terms 5e-3, as phase 7 allows)."""
    from refvsr_tpu_torch.configs import get_config
    from refvsr_tpu_torch.eval.stream import StreamRunner
    from refvsr_tpu_torch.losses import cx_options
    from refvsr_tpu_torch.models.refvsr import build_refvsr
    from refvsr_tpu_torch.models.refvsr_ir import RefVSRIRNet
    from refvsr_tpu_torch.train.trainer import Trainer
    t = 5
    cfg = get_config("RefVSR_IR_MFID", num_blocks=2, mid_channels=8,
                     frame_num=t, keyframe_stride=2, **NO_ASSETS)
    net = build_refvsr(cfg, device="cpu", seed=3)
    check(isinstance(net, RefVSRIRNet), "IR config built no RefVSRIRNet")
    _fractional_offsets(net, 4)
    gen = torch.Generator().manual_seed(5)
    lrs = torch.rand((1, t + 2, 32, 44, 3), generator=gen)
    refs = torch.rand((1, t + 2, 32, 44, 3), generator=gen)
    runners = [StreamRunner(net, None, device=d, keyframe_stride=2)
               for d in ("cpu", dev)]
    worst, per_window = 0.0, []
    for wi in range(3):
        out_c = runners[0].process(lrs[:, wi:wi + t], refs[:, wi:wi + t],
                                   wi == 0)[0]
        reset_launches()
        out_g = runners[1].process(lrs[:, wi:wi + t], refs[:, wi:wi + t],
                                   wi == 0)[0]
        n = read_launches()
        per_window.append((n["warp_sample"], n["argmax_matmul"]))
        worst = max(worst, float(abs(out_c - out_g).max()))
    check(per_window == [(2 * t + 2 + 3 * (t // 2), 1)] * 3,
          f"tiny IR windows: K1/K2 launches {per_window}")
    check(worst <= 1e-3, f"tiny IR: card vs CPU max diff {worst} > 1e-3")
    log(f"tiny IR (2 blocks, 8 ch, EDVR 64 ch, T={t}, 32x44, f32): first + "
        f"2 streamed windows, card vs CPU max_abs_diff {worst:.3e} (limit "
        f"1e-3); K1/K2 launches per window {per_window}")

    cfg = get_config("RefVSR_IR_MFID", num_blocks=2, mid_channels=8,
                     frame_num=t, frame_itr_num=2, patch_size=16,
                     batch_size=1, keyframe_stride=2, **NO_ASSETS)
    batch = _ir_batch(cfg, seed=6)
    means = {}
    for d in ("cpu", dev):
        tr = Trainer(cfg, device=d, seed=3)
        _fractional_offsets(tr.net, 4)
        reset_launches()
        means[d], _ = tr.iteration(batch)
        launches = read_launches()
    check(all(launches[k] > 0 for k in KERNEL_FNS),
          f"tiny IR iteration: a kernel was not launched {launches}")
    bad = [k for k, v in means["cpu"].items()
           if abs(means[dev][k] - v) > (5e-3 if cx_options(k) else 2e-4)
           * abs(v) + 1e-6]
    log(f"tiny IR Trainer.iteration ({cfg.loss}, 2 steps, f32): mean "
        "errors " + ", ".join(f"{k} {means[dev][k]:.6g}/{v:.6g}"
                              for k, v in means["cpu"].items())
        + f" (card/CPU); card launches {launches}")
    check(not bad, f"tiny IR iteration: card vs CPU differ in {bad}")


def eval_tree_jobs(root, seed, hd):
    """The scenes of a seeded RealMCVSR test split under `root`: with `hd`
    one video of EVAL_8K_FRAMES 1080p frames under HR/ (every stream, as
    set_data_path reads it under flag_HD_in); else IR_VIDEOS with
    LRx4/{UW,W,T} at IR_HW and HR/UW at 4x."""
    base = f"{root}/RealMCVSR/test"
    if hd:
        return [(seed + 3 * i + c, H, W,
                 [(f"{base}/HR/{cam}/0000/{i:04d}.png", 1)])
                for i in range(EVAL_8K_FRAMES)
                for c, cam in enumerate(("UW", "W", "T"))]
    h, w = IR_HW
    jobs = []
    for video, n in IR_VIDEOS:
        for i in range(n):
            for cam in ("UW", "W", "T"):
                jobs.append((seed + len(jobs), h, w, [
                    (f"{base}/LRx4/{cam}/{video}/{i:04d}.png", 1)]))
            jobs.append((seed + len(jobs), 4 * h, 4 * w, [
                (f"{base}/HR/UW/{video}/{i:04d}.png", 1)]))
    return jobs


def _result_dir(out, mode):
    import glob
    dirs = glob.glob(f"{out}/RealMCVSR/*_random_init")
    check(len(dirs) == 1, f"{mode}: result dirs {dirs}")
    return dirs[0]


def _score_lines(d, mode):
    with open(f"{d}/score_RealMCVSR_{mode}.txt") as f:
        return f.read().splitlines()


def ir_eval_instruments(rec):
    """Time each window (synchronised) with its K1/K2 launches; in window
    IR_TIMED_WINDOW the EDVR refill and each deformable convolution apart,
    by CUDA events; trace window IR_PROFILED_WINDOW; capture the kernels'
    inputs in the window after the timed one. A window after which the
    runner's count is 1 was a first window."""
    from refvsr_tpu_torch.eval.stream import StreamRunner
    from refvsr_tpu_torch.models import edvr as edvr_mod
    from refvsr_tpu_torch.models.refvsr_ir import RefVSRIRNet

    def process_device(orig):
        def f(self, *a, **k):
            wi = len(rec["windows"])
            rec["timed"] = wi == IR_TIMED_WINDOW
            rec["gate"] = wi == IR_TIMED_WINDOW + 1
            before = read_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                if wi != IR_PROFILED_WINDOW:
                    out = orig(self, *a, **k)
                    torch.cuda.synchronize()
                    return out
                with traced() as prof:
                    out = orig(self, *a, **k)
                    torch.cuda.synchronize()
                rec["prof"] = (prof, (time.perf_counter() - t0) * 1e3)
                return out
            finally:
                after = read_launches()
                rec["windows"].append(dict(
                    ms=(time.perf_counter() - t0) * 1e3,
                    k1=after["warp_sample"] - before["warp_sample"],
                    k2=after["argmax_matmul"] - before["argmax_matmul"],
                    first=self.count == 1))
                rec["timed"] = rec["gate"] = False
        return f

    def timed(key):
        def make(orig):
            def f(*a, **k):
                if not rec["timed"]:
                    return orig(*a, **k)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = orig(*a, **k)
                end.record()
                torch.cuda.synchronize()
                rec[key].append(start.elapsed_time(end))
                return out
            return f
        return make

    stack = contextlib.ExitStack()
    for owner, name, make in (
            (StreamRunner, "process_device", process_device),
            (RefVSRIRNet, "compute_refill_features", timed("edvr_ms")),
            (edvr_mod, "modulated_deform_conv", timed("dcn_ms"))):
        stack.enter_context(patched(owner, name, make))
    return stack


def phase_ir_eval(dev, card):
    """The IR net's evaluation through run.main at full width:
    RefVSR_IR_MFID (30 blocks, 36 channels, EDVR-M 64 channels, T = 9,
    f32, seeded random weights) on a seeded RealMCVSR-layout tree:
    quan_qual over both videos, then FOV and conf on the second. Returns
    (launches of the quan_qual run, summary, captured calls of one
    streamed window at each new shape)."""
    from refvsr_tpu_torch import run
    from refvsr_tpu_torch.data.jpeg import jpeg_info
    from refvsr_tpu_torch.data.png import read_image
    from refvsr_tpu_torch.models import matching as matching_mod
    from refvsr_tpu_torch.ops import warp as warp_mod

    summary = dict(card=card)
    calls = {"warp_sample": [], "argmax_matmul": []}
    seen = {k: set() for k in calls}
    with tree("ir") as (root, summary["tree_wait_s"]):
        n_frames = sum(n for _, n in IR_VIDEOS)
        log(f"IR eval tree: {n_frames} frames x (3 LRx4 {IR_HW} + 1 HR) "
            f"PNGs, waited {summary['tree_wait_s']:.1f} s for the host pool")
        argv = ["--config", "config_RefVSR_IR_MFID", "--mode",
                "chip_smoke_ir", "--data_offset", root, "--log_offset",
                f"{root}/logs"]
        cfg = run.build_config(run.build_parser().parse_args(argv))
        check((cfg.network, cfg.num_blocks, cfg.mid_channels,
               cfg.matching_ksize, cfg.keyframe_stride, cfg.frame_num,
               cfg.is_amp, cfg.flag_HD_in, cfg.reset_branch)
              == ("RefVSR_IR", 30, 36, 2, 5, 9, False, False, 5),
              f"IR eval config {cfg}")

        rec = dict(windows=[], edvr_ms=[], dcn_ms=[], timed=False,
                   gate=False)
        gate = lambda: rec["gate"]  # noqa: E731
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with ir_eval_instruments(rec), \
                capturing(warp_mod, "warp_sample", calls["warp_sample"],
                          seen["warp_sample"], when=gate), \
                capturing(matching_mod, "argmax_matmul",
                          calls["argmax_matmul"], seen["argmax_matmul"],
                          when=gate):
            t0 = time.perf_counter()
            with clock("quan_qual"):
                res = run.main(argv + ["--eval_mode", "quan_qual",
                                       "--output_offset", f"{root}/qq"])
            main_s = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        t = cfg.frame_num
        want_k1 = 2 * t + 2 + 3 * (t // 2)
        check([(w["k1"], w["k2"]) for w in rec["windows"]]
              == [(want_k1, 1)] * n_frames,
              f"IR eval windows' K1/K2 launches "
              f"{[(w['k1'], w['k2']) for w in rec['windows']]}")
        check(not launches["warp_sample_backward"]
              and not launches["argmax_matmul_backward"]
              and not any(launches[k] for k in BENCH_FNS.values()),
              f"IR eval launched a backward kernel or K3/K4 {launches}")
        check(res["frames"] == n_frames and np.isfinite(res["PSNR"])
              and 0 < res["SSIM"] <= 1, f"IR eval summary {res}")
        d = _result_dir(f"{root}/qq", "quan_qual")
        lines = _score_lines(d, "quan_qual")
        n_eval = sum(ln.startswith("[EVAL ") for ln in lines)
        n_mean = sum(ln.startswith("[MEAN EVAL ") for ln in lines)
        check(n_eval == n_frames and n_mean == 1
              and lines[-1].startswith("[TOTAL random_init|RealMCVSR] "),
              f"IR score file: {n_eval} frame lines, {n_mean} MEAN, last "
              f"{lines[-1]!r}")
        h, w = IR_HW
        dumps = 0
        with clock("dumps read back"):
            for video, n in IR_VIDEOS:
                for i in range(n):
                    for kind, shape in (("input", (h, w, 3)),
                                        ("output", (4 * h, 4 * w, 3))):
                        img = read_image(
                            f"{d}/png/{kind}/{video}/{i:04d}.png")
                        check(img.shape == shape and np.isfinite(img).all(),
                              f"PNG dump {kind}/{video}/{i}: {img.shape}")
                        with open(f"{d}/jpg/{kind}/{video}/{i:04d}.jpg",
                                  "rb") as f:
                            check(jpeg_info(f.read()) == shape,
                                  f"JPEG dump {kind}/{video}/{i}")
                        dumps += 2
        ms = [w["ms"] for i, w in enumerate(rec["windows"])
              if not w["first"]
              and i not in (IR_TIMED_WINDOW, IR_PROFILED_WINDOW)]
        first_ms = rec["windows"][0]["ms"]
        check([i for i, w in enumerate(rec["windows"]) if w["first"]]
              == [0, IR_VIDEOS[0][1]] and ms,
              f"IR eval: first windows "
              f"{[w['first'] for w in rec['windows']]}")
        timed_ms = rec["windows"][IR_TIMED_WINDOW]["ms"]
        summary.update(
            run_main_s=main_s, window_ms=[w["ms"] for w in rec["windows"]],
            ms_per_window=sum(ms) / len(ms), first_window_ms=first_ms,
            timed_window_ms=timed_ms, edvr_ms=rec["edvr_ms"],
            edvr_share=sum(rec["edvr_ms"]) / timed_ms,
            dcn_calls=len(rec["dcn_ms"]), dcn_ms=sum(rec["dcn_ms"]),
            peak_bytes=peak, psnr=res["PSNR"], ssim=res["SSIM"],
            score_lines=len(lines), dumps=dumps, launches=launches)
        log(f"IR eval via run.main (RefVSR_IR_MFID f32, {IR_HW} -> "
            f"{(4 * h, 4 * w)}, {n_frames} windows): {main_s:.1f} s; "
            f"{summary['ms_per_window']:.1f} ms per streamed window on the "
            f"host (synchronised; first window {first_ms:.1f} ms); window "
            f"{IR_TIMED_WINDOW}: EDVR refill "
            + ", ".join(f"{v:.1f}" for v in rec["edvr_ms"])
            + f" ms ({summary['edvr_share']:.3f} of its {timed_ms:.1f} ms), "
            f"{len(rec['dcn_ms'])} plain deformable convolutions "
            f"{summary['dcn_ms']:.1f} ms; K1/K2 launches per window "
            f"({want_k1}, 1); peak allocated {peak / 2**30:.2f} GiB; PSNR "
            f"{res['PSNR']:.4f} SSIM {res['SSIM']:.4f}; {len(lines)} score "
            f"lines, {dumps} PNG/JPEG dumps decoded  [{card}]")

        prof, wall_ms = rec.pop("prof")
        in_window, summary["profiled_window"] = device_profile(
            prof, ("warp_sample", "argmax_matmul"),
            "IR forward_stream window", wall_ms, card, top=15)
        summary["kernels_in_window"] = in_window
        del prof

        for mode, extra in (("FOV", []), ("conf", [])):
            out = f"{root}/{mode}"
            t0 = time.perf_counter()
            with clock(mode):
                res = run.main(argv + ["--eval_mode", mode, "--vid_name",
                                       IR_VIDEOS[1][0], "--output_offset",
                                       out, *extra])
            secs = time.perf_counter() - t0
            d = _result_dir(out, mode)
            n = IR_VIDEOS[1][1]
            if mode == "FOV":
                lines = _score_lines(d, mode)
                check(sum(ln.startswith("[EVAL ") for ln in lines) == n
                      and any(ln.startswith("[PSNR-FOV_ring]")
                              for ln in lines)
                      and np.isfinite(res["pfi"][1.0]),
                      f"FOV score file {lines[-4:]}")
            else:
                for i in range(n):
                    for name in ("conf", "conf_prop", "conf_prop_bw",
                                 "conf_prop_fw"):
                        img = read_image(f"{d}/conf/{IR_VIDEOS[1][0]}/"
                                         f"{i:04d}_{name}.png")
                        check(img.shape == (h, w, 3), f"conf map {name}")
                check(res["frames"] == n, f"conf: {res}")
            summary[f"{mode}_s"] = secs
            log(f"IR eval --eval_mode {mode} on video {IR_VIDEOS[1][0]} "
                f"({n} frames): {secs:.1f} s, files checked  [{card}]")
    torch.cuda.empty_cache()
    return launches, summary, calls


# the spatial eval CLI's score lines against the one-rank CLI's (f32,
# PyTorch's default TF32 convolutions, whose algorithms cuDNN picks by the
# band's shape): PSNR in dB and SSIM. On the H100 the sound run gave
# 1.5e-4 dB and 0 (three runs alike), the control with no halo (every
# warp wrong at its band's edge rows) 4.6e-4 dB and 0: the PSNR limit is
# their geometric mean, the SSIM limit one unit of the score lines' last
# digit. The random weights' SR is far from the truth, so a seam fault
# moves the PSNR little
EVAL_SPATIAL_PSNR_LIMIT, EVAL_SPATIAL_SSIM_LIMIT = 2.6e-4, 1e-5


def _score_diff(want, got):
    """The largest PSNR and SSIM differences between two score files'
    lines, which must otherwise agree (seconds aside)."""
    import re
    num = re.compile(r"(PSNR|SSIM): (-?\d+\.\d+)")
    sec = re.compile(r"\(\d+\.\d+sec\)")
    check(len(want) == len(got), f"score files of {len(want)} and "
          f"{len(got)} lines")
    out = {"psnr": 0.0, "ssim": 0.0}
    for a, b in zip(want, got):
        check(num.sub("#", sec.sub("", a)) == num.sub("#", sec.sub("", b)),
              f"score lines differ: {a!r} {b!r}")
        for (k, va), (_, vb) in zip(num.findall(a), num.findall(b)):
            key = k.lower()
            out[key] = max(out[key], abs(float(va) - float(vb)))
    return out


def phase_eval_cli_8k(dev, card):
    """The eval CLI on RefVSR_MFID_8K (30 blocks, 48 channels, f32, HD
    input, seeded random weights): quan_qual with --quantitative_only on a
    1080p tree of EVAL_8K_FRAMES frames, the metrics on the SR frame
    downscaled by 1/4 on the card. Returns (launches, summary, captured
    calls of its first window at each shape)."""
    from refvsr_tpu_torch import run
    from refvsr_tpu_torch.models import matching as matching_mod
    from refvsr_tpu_torch.ops import warp as warp_mod

    calls = {"warp_sample": [], "argmax_matmul": []}
    seen = {k: set() for k in calls}
    state = dict(first=True)

    def first_window(orig):
        def f(self, *a, **k):
            try:
                return orig(self, *a, **k)
            finally:
                state["first"] = False
        return f

    from refvsr_tpu_torch.eval.stream import StreamRunner
    with tree("8k") as (root, tree_s):
        argv = ["--config", "config_RefVSR_MFID_8K", "--mode",
                "chip_smoke_8k", "--data_offset", root, "--log_offset",
                f"{root}/logs", "--output_offset", f"{root}/out",
                "--eval_mode", "quan_qual", "--quantitative_only"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with patched(StreamRunner, "process_device", first_window), \
                capturing(warp_mod, "warp_sample", calls["warp_sample"],
                          seen["warp_sample"],
                          when=lambda: state["first"]), \
                capturing(matching_mod, "argmax_matmul",
                          calls["argmax_matmul"], seen["argmax_matmul"],
                          when=lambda: state["first"]):
            t0 = time.perf_counter()
            with clock("one rank"):
                res = run.main(argv)
            secs = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        lines = _score_lines(_result_dir(f"{root}/out", "quan_qual"),
                             "quan_qual")
        # the same CLI with the frame's rows split over two gloo ranks on
        # the card (run.main spawns them)
        torch.cuda.empty_cache()
        at = argv.index("--output_offset") + 1

        def spatial_cli(out, halo):
            res_ = run.main(argv[:at] + [f"{root}/{out}"] + argv[at + 1:]
                            + ["--spatial_devices", "2", "--spatial_halo",
                               str(halo)])
            return res_, _score_lines(_result_dir(f"{root}/{out}",
                                                  "quan_qual"), "quan_qual")
        t0 = time.perf_counter()
        with clock("spatial"):
            res_s, lines_s = spatial_cli("out_spatial", SPATIAL_HALO)
        secs_s = time.perf_counter() - t0
        # the control the limits must reject: no halo, so that each
        # warp's taps past its band's edge rows read the wrong rows
        with clock("spatial control"):
            _, lines_c = spatial_cli("out_control", 0)
    check(res["frames"] == EVAL_8K_FRAMES and np.isfinite(res["PSNR"]),
          f"8K eval summary {res}")
    spatial_diff = _score_diff(lines, lines_s)
    control_diff = _score_diff(lines, lines_c)
    log(f"8K eval control (--spatial_halo 0) against one rank: "
        f"{control_diff}")
    check(control_diff["psnr"] > EVAL_SPATIAL_PSNR_LIMIT
          or control_diff["ssim"] > EVAL_SPATIAL_SSIM_LIMIT,
          f"spatial eval CLI control (no halo) passes the limits: "
          f"{control_diff}")
    check(res_s is not None and res_s["frames"] == EVAL_8K_FRAMES
          and spatial_diff["psnr"] <= EVAL_SPATIAL_PSNR_LIMIT
          and spatial_diff["ssim"] <= EVAL_SPATIAL_SSIM_LIMIT,
          f"spatial eval CLI against one rank: {spatial_diff}, {res_s}")
    check(sum(ln.startswith("[EVAL ") for ln in lines) == EVAL_8K_FRAMES
          and lines[-1].startswith("[TOTAL random_init|RealMCVSR] "),
          f"8K score file {lines}")
    want = (16 + 10 * (EVAL_8K_FRAMES - 1), EVAL_8K_FRAMES)
    got = (launches["warp_sample"], launches["argmax_matmul"])
    check(got == want, f"8K eval K1/K2 launches {got} != {want}")
    summary = dict(card=card, tree_wait_s=tree_s, run_main_s=secs,
                   peak_bytes=peak, psnr=res["PSNR"], ssim=res["SSIM"],
                   sec_per_frame=res["sec_per_frame"], launches=launches,
                   spatial=dict(ranks=2, run_main_s=secs_s,
                                sec_per_frame=res_s["sec_per_frame"],
                                against_one_rank=spatial_diff,
                                control_against_one_rank=control_diff))
    log(f"8K eval via run.main --spatial_devices 2 (2 gloo ranks on one "
        f"card): {secs_s:.1f} s with the spawn; score lines against one "
        f"rank's: {spatial_diff}  [{card}]")
    log(f"8K eval via run.main (RefVSR_MFID_8K f32, {EVAL_8K_FRAMES} "
        f"windows, quantitative only, metrics on the card's 1/4 "
        f"downscale): {secs:.1f} s (waited {tree_s:.1f} s for its tree); "
        f"PSNR {res['PSNR']:.4f} SSIM {res['SSIM']:.4f}; K1/K2 launches "
        f"{got}; "
        f"peak allocated {peak / 2**30:.2f} GiB  [{card}]")
    torch.cuda.empty_cache()
    return launches, summary, calls


def phase_ir_train(dev, card):
    """One RefVSR_IR_MFID Trainer.iteration at full width and the config's
    batch of 8 (patch 64, T = 9, 5 steps, its loss, f32), then one more
    step with every kernel's inputs captured (forward kernels once per
    shape, backward kernels at every call). Returns (launches, summary,
    captured calls)."""
    from refvsr_tpu_torch.configs import get_config
    from refvsr_tpu_torch.models import matching as matching_mod
    from refvsr_tpu_torch.models.refvsr_ir import sliding_keyframe_mask
    from refvsr_tpu_torch.ops import warp as warp_mod
    from refvsr_tpu_torch.ops.kernels import argmax_matmul as k2_mod
    from refvsr_tpu_torch.ops.kernels import warp_sample as k1_mod
    from refvsr_tpu_torch.train.trainer import Trainer

    cfg = get_config("RefVSR_IR_MFID", **NO_ASSETS)
    check((cfg.num_blocks, cfg.mid_channels, cfg.batch_size,
           cfg.patch_size, cfg.frame_num, cfg.frame_itr_num,
           cfg.keyframe_stride, cfg.is_amp, cfg.matching_ksize)
          == (30, 36, 8, 64, 9, 5, 5, False, 2), f"IR training {cfg}")
    batch = _ir_batch(cfg, seed=23)
    tr = Trainer(cfg, device=dev, seed=0)
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
    means, state = tr.iteration(batch)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    del tr.train_step
    check(len(step_ms) == cfg.frame_itr_num
          and all(np.isfinite(v) for v in means.values()),
          f"IR iteration: {len(step_ms)} steps, means {means}")
    check(all(launches[k] > 0 for k in KERNEL_FNS)
          and not any(launches[k] for k in BENCH_FNS.values()),
          f"IR training: a kernel was not launched, or K3/K4 was "
          f"{launches}")
    steady = step_ms[1:]
    summary = dict(card=card, batch=cfg.batch_size, step_ms=step_ms,
                   ms_per_step=sum(steady) / len(steady), peak_bytes=peak,
                   mean_errors=means, launches=launches)
    log(f"IR training (RefVSR_IR_MFID f32, batch {cfg.batch_size}, patch "
        f"{cfg.patch_size}, T {cfg.frame_num}): steps "
        + ", ".join(f"{m:.1f}" for m in step_ms)
        + f" ms; {summary['ms_per_step']:.1f} ms per step (steps 2-"
        f"{len(step_ms)}); peak allocated {peak / 2**30:.2f} GiB; mean "
        f"errors {means}; launches {launches}  [{card}]")

    arrays = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    calls = {name: [] for name in KERNEL_FNS}
    seen = {"warp_sample": set(), "argmax_matmul": set()}
    t = cfg.frame_num
    i = cfg.frame_itr_num - 1
    mask = sliding_keyframe_mask(t, cfg.keyframe_stride, 1)[0]
    with capturing(warp_mod, "warp_sample", calls["warp_sample"],
                   seen["warp_sample"]), \
            capturing(matching_mod, "argmax_matmul", calls["argmax_matmul"],
                      seen["argmax_matmul"]), \
            capturing(k1_mod, "warp_sample_backward",
                      calls["warp_sample_backward"]), \
            capturing(k2_mod, "argmax_matmul_backward",
                      calls["argmax_matmul_backward"]):
        tr.train_step(state, arrays["LR_UW"][:, i:i + t],
                      arrays["LR_REF_W"][:, i:i + t],
                      arrays["HR_UW"][:, i + t // 2],
                      arrays["HR_REF_W"][:, :i + t], mask)
        torch.cuda.synchronize()
    summary["step_calls"] = {k: len(v) for k, v in calls.items()}
    log(f"IR training step captured: {summary['step_calls']}")
    del tr, arrays, state
    torch.cuda.empty_cache()
    return launches, summary, calls


# ------------------------------------------------ multi-rank paths (gloo)
#
# The card's machine has one H100, and NCCL refuses two ranks on one
# device, so each multi-rank path runs as two spawned processes sharing
# cuda:0 over gloo. Their times are two-ranks-on-one-card times, not
# two-card times. Each rank counts its own launches; a path's count is the
# sum over its ranks.

SPATIAL_RANKS = 2
SPATIAL_HALO = 32
# the spatial stream's frames against the one-rank stream's (bf16): cuDNN
# picks its algorithms by shape, and a band of rows is another shape, so
# bit equality is not expected. On the H100 the sound frames differed by a
# mean |difference| of 6.44e-5 to 7.62e-5 spread evenly over the frame (at
# most 7.64e-5 within 4 * SPATIAL_HALO output rows of the band seam); the
# control with no halo by 7.4e-5 to 9.4e-5 over the frame, but 2.01e-4 to
# 3.67e-4 near the seam. The frame's mean cannot tell them apart, so it
# keeps the pipelined stream's envelope; the seam rows' mean can. So can
# the share of pixels near the seam with a value more than one bf16 ulp of
# the one-rank value away: 0.92% to 1.21% in the sound frames, the same as
# away from the seam (pixels where a small value is the difference of large
# ones), against 4.58-4.60% and 7.72% in the control's. The largest
# difference cannot: it was 3.90625e-3 in every sound frame, one ulp of a
# value in [0.5, 1), against the control's 7.8e-3 and 1.56e-2, so a sound
# frame with one value two ulps off would fail it. Each limit is the
# geometric mean of the sound runs' largest reading and the control's
# smallest. On the routes production takes (the bands' convolutions on
# cuDNN; the replicated stages' and the one-rank stream's square ones on
# K3) the sound frames read a mean of 6.61e-5 to 7.65e-5, 6.73e-5 to
# 7.63e-5 near the seam and 0.92% to 1.21% of its pixels more than one
# ulp off; the control 7.42e-5 to 9.38e-5, 2.02e-4 to 3.67e-4 and 4.59% to
# 7.72%: the limits still part them
SPATIAL_MEAN_LIMIT = PIPE_MEAN_LIMIT
SPATIAL_SEAM_MEAN_LIMIT = 1.24e-4
SPATIAL_SEAM_OVER_ULP_LIMIT = 2.35e-2
# the streamed windows after the first, and the control's windows (a
# first and one streamed)
SPATIAL_STREAM_WINDOWS = 2
SPATIAL_CONTROL_WINDOWS = 2
# the averaged gradients of two ranks (batch 1 each) against one rank's on
# the batch of 2, f32 with TF32 off: relative L2 per tensor, median and
# max. The sums run in other orders (cuDNN's algorithms by batch size, the
# backward kernels' atomics, the contextual loss's batch mean), and the
# contextual loss's discrete choices (losses/contextual.py: each
# position's nearest and best match) flip with the last bits and amplify
# that, so both window-0 runs hold them to the one-rank run's (0.5% of
# them would differ) and run every convolution one batch item at a time
# (_per_item_convs). On the H100 that gave median 9.650e-5 and max
# 1.643e-3 (the alignment convs' biases; 1.233e-4 and 2.74e-3 with the
# convolutions batched, and the same with only aa1's and aa2's alignment
# convolutions per item; 6.92e-4 and 2.96e-2 with the choices free too).
# Each limit is the geometric mean of that reading and the one of the
# control that must fail it, the step without sync_batch_stats (median
# 3.082e-4, max 7.121e-3, held alike); a rank's own half-batch gradients
# give median 0.11. The CPU tests hold the same step to 1e-5, and the
# all-reduce itself is held bit for bit below
DDP_GRAD_MEDIAN_LIMIT, DDP_GRAD_MAX_LIMIT = 1.72e-4, 3.42e-3
DDP_STEPS = 2
# the train CLI on two ranks: RefVSR_MFID at full width on a small tree of
# 270x480 LRx4 frames (540x960 LRx2 refs, 1080x1920 HR ground truth; only
# the files the non-HD splits read), one clip of 18 frames (two samples,
# one every frame_itr_num = 9 frames) and 1 validation frame
DDP_TREE_HW = (1080, 1920)
DDP_TREE_FRAMES = {"train": 18, "valid": 1}
RANK_TIMEOUT_S = 600


def _in_turns(fn, dev):
    """fn() on each rank in turn (the others wait at a barrier), so that a
    kernel timed on one rank does not share the card with the other's
    work. Returns fn()'s value on this rank."""
    from refvsr_tpu_torch.parallel import mesh
    out = None
    for r in range(mesh.world_size()):
        if mesh.rank() == r:
            out = fn()
            torch.cuda.synchronize()
        mesh.barrier(dev)
    return out


def k1_banded_case(name, x, flow, h, out_h, out_row0, in_row0, lo, hi):
    """The banded K1 kernel vs its plain version on one captured call."""
    import torch.nn.functional as F

    from refvsr_tpu_torch.ops.kernels.warp_sample import (
        warp_coords, warp_sample_banded, warp_sample_banded_plain)
    args = (x, flow, h, out_h, out_row0, in_row0, lo, hi)
    got = warp_sample_banded(*args)
    want = warp_sample_banded_plain(*args)
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == x.dtype,
          f"K1 banded {name}: shape/dtype {tuple(got.shape)} {got.dtype}")
    err = float((got.float() - want.float()).abs().max())
    tol = 2.0 ** -6 if x.dtype == torch.bfloat16 else 1e-5
    limit = tol * float(x.float().abs().max())
    check(err <= limit,
          f"K1 banded {name}: max |kernel - plain| {err} > {limit}")
    # the library yardstick: grid_sample over the band on the same
    # coordinates (it has no border-extension past the band)
    hb, w = x.shape[1], x.shape[2]
    sx, sy = warp_coords((h, w), flow, out_h, out_row0)
    grid = torch.stack([(2 * sx + 1) / w - 1,
                        (2 * (sy - in_row0) + 1) / hb - 1],
                       -1).nan_to_num(nan=-4.0).to(x.dtype)
    nchw = x.permute(0, 3, 1, 2)
    ms = cuda_ms(lambda: warp_sample_banded(*args))
    plain_ms = cuda_ms(lambda: warp_sample_banded_plain(*args), iters=3)
    library_ms = cuda_ms(lambda: F.grid_sample(
        nchw, grid, mode="bilinear", padding_mode="zeros",
        align_corners=False))
    nbytes = _nbytes(x, flow, got)
    flops = 8 * got.numel()
    b_ms, b_by = bound_ms(nbytes, flops, x.dtype)
    log(f"K1 banded {name}: x {tuple(x.shape)} {x.dtype} rows from "
        f"{in_row0} -> {tuple(got.shape)} rows from {out_row0} of "
        f"{out_h}; max_abs_err {err:.3e} (limit {limit:.3e}); kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, grid_sample "
        f"{library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(case=name, max_abs_err=err, tolerance=limit, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                bound_by=b_by, nbytes=nbytes, flops=flops, peak=x.dtype)


def bf16_ulp(v):
    """The bf16 ulp at each value of v (f32): 2**(e - 8) for |v| in
    [2**(e - 1), 2**e), and 2**-133 (the subnormals' spacing) below the
    smallest normal, zero included. Built from the f32 bits with integer
    work only: with the biased exponent b of |v|, the ulp is 2**(b - 134),
    a normal f32 for b > 7 and a subnormal one (bit b + 15) below."""
    b = (v.float().abs().view(torch.int32) >> 23) & 0xFF
    bits = torch.where(b > 7, (b - 7) << 23, 1 << (b.clamp_min(1) + 15))
    return bits.view(torch.float32)


def frame_diff(got, want):
    """A spatial frame against the one-rank frame: bit equality, mean and
    max |difference|, and where the difference sits by output row: its
    mean over the rows within 4 * SPATIAL_HALO of a band seam and over the
    rest, the share of pixels there and elsewhere with a value more than
    one bf16 ulp of the one-rank frame's value away (a rounding the other
    way moves a value by one ulp), and the rows where the difference is
    largest."""
    d = (got.float() - want.float()).abs()
    rows = d.mean(dim=(0, 2, 3))
    over = (d > bf16_ulp(want)).any(dim=3).float().mean(dim=(0, 2))
    seams = [4 * (H * r // SPATIAL_RANKS) for r in range(1, SPATIAL_RANKS)]
    near = torch.zeros(rows.numel(), dtype=torch.bool, device=rows.device)
    for seam in seams:
        near[max(0, seam - 4 * SPATIAL_HALO):seam + 4 * SPATIAL_HALO] = True
    top = torch.topk(rows, 5)
    return dict(bit_equal=bool(torch.equal(got, want)), mean=float(d.mean()),
                max=float(d.max()), seam_rows=seams,
                near_seam_mean=float(rows[near].mean()),
                away_mean=float(rows[~near].mean()),
                near_seam_over_ulp=float(over[near].mean()),
                away_over_ulp=float(over[~near].mean()),
                worst_rows=[(int(i), float(v)) for v, i in
                            zip(top.values, top.indices)])


def passes_spatial(f):
    """Whether a spatial frame passes the check against the one-rank
    frame."""
    return f["bit_equal"] or (
        f["mean"] <= SPATIAL_MEAN_LIMIT
        and f["near_seam_mean"] <= SPATIAL_SEAM_MEAN_LIMIT
        and f["near_seam_over_ulp"] <= SPATIAL_SEAM_OVER_ULP_LIMIT)


def _spatial_rank(frames_path, ref_path, windows, kind="cuda"):
    """One rank of the spatial stream: RefVSR_MFID_8K bf16, first + the
    streamed windows through StreamRunner on its rows, the launches
    counted, the last window's banded K1 and K2 calls captured and held
    against their plain versions (in turns); rank 0 holds the gathered
    frames against the one-rank frames."""
    from refvsr_tpu_torch.configs import get_config
    from refvsr_tpu_torch.eval.stream import StreamRunner
    from refvsr_tpu_torch.models import matching as matching_mod
    from refvsr_tpu_torch.models.refvsr import build_refvsr
    from refvsr_tpu_torch.ops.kernels import warp_sample as k1_mod
    from refvsr_tpu_torch.parallel import mesh
    from refvsr_tpu_torch.parallel.serve import spatial_eval_fns

    backend = mesh.init_from_env(kind)
    try:
        dev = mesh.device_for_rank(kind)
        rank = mesh.rank()
        data = np.load(frames_path)
        lrs, refs = data["lrs"], data["refs"]
        cfg = get_config("RefVSR_MFID_8K")
        net = build_refvsr(cfg, device=dev, dtype=torch.bfloat16, seed=0)
        fns = spatial_eval_fns(net, SPATIAL_HALO, (N, T, H, W, 3),
                               (N, T, H, W, 3), torch.bfloat16, dev)
        runner = StreamRunner(net, cfg.reset_branch, device=dev,
                              compute_dtype=torch.bfloat16, spatial=fns)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        ms, outs = [], []
        calls = {"warp_sample_banded": [], "argmax_matmul": []}
        for wi in range(windows):
            ex0, by0 = fns.exchanges, fns.bytes_moved
            last = wi == windows - 1
            with contextlib.ExitStack() as stack:
                if last:
                    stack.enter_context(capturing(
                        k1_mod, "warp_sample_banded",
                        calls["warp_sample_banded"]))
                    stack.enter_context(capturing(
                        matching_mod, "argmax_matmul",
                        calls["argmax_matmul"]))
                mesh.barrier(dev)
                t0 = time.perf_counter()
                out, _ = runner.process_device(lrs[:, wi:wi + T],
                                               refs[:, wi:wi + T],
                                               is_first=wi == 0)
                torch.cuda.synchronize()
                ms.append(dict(kind="forward_first" if wi == 0 else
                               "forward_stream",
                               ms=(time.perf_counter() - t0) * 1e3,
                               exchanges=fns.exchanges - ex0,
                               bytes=fns.bytes_moved - by0))
            if rank == 0:
                outs.append(out.cpu())
            del out
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        del runner, fns
        # the control that must fail the frames' check: no halo, so every
        # op at a band's edge rows reads zeros or border-extends where its
        # neighbour's rows belong; a first and one streamed window
        fns = spatial_eval_fns(net, 0, (N, T, H, W, 3), (N, T, H, W, 3),
                               torch.bfloat16, dev)
        runner = StreamRunner(net, cfg.reset_branch, device=dev,
                              compute_dtype=torch.bfloat16, spatial=fns)
        control = []
        for wi in range(SPATIAL_CONTROL_WINDOWS):
            out, _ = runner.process_device(lrs[:, wi:wi + T],
                                           refs[:, wi:wi + T],
                                           is_first=wi == 0)
            if rank == 0:
                control.append(out.cpu())
            del out
        del runner, fns, net
        torch.cuda.empty_cache()

        def held():
            cases = {"warp_sample_banded": [], "argmax_matmul": []}
            for i, (a, _) in enumerate(calls["warp_sample_banded"]):
                cases["warp_sample_banded"].append(k1_banded_case(
                    f"rank {rank} call {i}", *a))
            for i, (a, _) in enumerate(calls["argmax_matmul"]):
                # no split here: a rank's first profiler pass would start
                # CUPTI in it, 6-7 s a rank
                cases["argmax_matmul"].append(k2_case(
                    f"spatial rank {rank} call {i}: {_shape(a[0])}, "
                    f"{_shape(a[1])}", *a, iters=2, plain_iters=1,
                    split=False))
            return cases
        with clock(f"rank {rank}: kernels against their plain versions"):
            cases = _in_turns(held, dev)
        res = dict(rank=rank, backend=backend, windows=ms, peak_bytes=peak,
                   launches=launches, cases=cases,
                   n_calls={k: len(v) for k, v in calls.items()})
        gathered = [None] * mesh.world_size()
        import torch.distributed as dist
        dist.all_gather_object(gathered, res)
        if rank != 0:
            return None
        want = torch.load(ref_path)

        def diffs(frames):
            # on the card: a frame's comparison takes seconds on the host
            out = []
            for got, w in zip(frames, want):
                got = got.to(dev)
                check(tuple(got.shape) == (N, 4 * H, 4 * W, 3)
                      and _finite(got), f"spatial frame {tuple(got.shape)}")
                out.append(frame_diff(got, w.to(dev)))
            return out
        return dict(ranks=gathered, frames=diffs(outs),
                    control=diffs(control))
    finally:
        mesh.destroy()


def phase_spatial(dev, card):
    """The H-sharded 8K stream on two gloo ranks sharing the card, against
    the one-rank stream of the same seeded net and frames."""
    import tempfile

    from refvsr_tpu_torch.configs import get_config
    from refvsr_tpu_torch.eval.stream import StreamRunner
    from refvsr_tpu_torch.models.refvsr import build_refvsr
    from refvsr_tpu_torch.parallel import mesh

    windows = 1 + SPATIAL_STREAM_WINDOWS
    rng = np.random.default_rng(23)
    frames = T + windows - 1
    lrs = rng.random((N, frames, H, W, 3), dtype=np.float32)
    refs = rng.random((N, frames, H, W, 3), dtype=np.float32)
    cfg = get_config("RefVSR_MFID_8K")
    net = build_refvsr(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    runner = StreamRunner(net, cfg.reset_branch, device=dev,
                          compute_dtype=torch.bfloat16)
    want, one_ms = [], []
    for wi in range(windows):
        t0 = time.perf_counter()
        with clock("one-rank windows"):
            out, _ = runner.process_device(lrs[:, wi:wi + T],
                                           refs[:, wi:wi + T],
                                           is_first=wi == 0)
            torch.cuda.synchronize()
        one_ms.append((time.perf_counter() - t0) * 1e3)
        with clock("frames to the host"):
            want.append(out.cpu())
    del runner, net, out
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(f"{tmp}/frames.npz", lrs=lrs, refs=refs)
        torch.save(want, f"{tmp}/want.pt")
        del want
        t0 = time.perf_counter()
        with clock("ranks"):
            res = mesh.spawn(_spatial_rank, (f"{tmp}/frames.npz",
                                             f"{tmp}/want.pt", windows),
                             SPATIAL_RANKS, RANK_TIMEOUT_S)
        wall = time.perf_counter() - t0
    ranks = res["ranks"]
    for r in ranks:
        check(r["backend"] == "gloo", f"spatial backend {r['backend']}")
        check(r["launches"]["warp_sample_banded"] > 0
              and r["launches"]["argmax_matmul"] > 0,
              f"spatial rank {r['rank']}: launches {r['launches']}")
        check(r["launches"]["warp_sample"] == 0,
              f"spatial rank {r['rank']} launched the unbanded K1")
        check(r["n_calls"] == {"warp_sample_banded": 10, "argmax_matmul": 1},
              f"spatial rank {r['rank']}: captured {r['n_calls']}")
    for i, f in enumerate(res["frames"]):
        log(f"spatial frame {i} against the one-rank frame: {f}")
        check(passes_spatial(f),
              f"spatial frame {i} against the one-rank frame: {f}")
    for i, f in enumerate(res["control"]):
        log(f"spatial control (halo 0) frame {i} against the one-rank "
            f"frame: {f}")
    check(not any(passes_spatial(f) for f in res["control"]),
          f"a frame of the spatial control (halo 0) passes the limits: "
          f"{res['control']}")
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    stream_ms = [sum(r["windows"][i]["ms"] for r in ranks[:1])
                 for i in range(1, windows)]
    summary = dict(
        card=card, ranks=SPATIAL_RANKS, halo=SPATIAL_HALO,
        backend=ranks[0]["backend"], spawn_and_run_s=wall,
        one_rank_ms=one_ms, frames=res["frames"], control=res["control"],
        per_rank=[dict(rank=r["rank"], windows=r["windows"],
                       peak_bytes=r["peak_bytes"],
                       launches=r["launches"]) for r in ranks])
    for r in ranks:
        w = r["windows"]
        log(f"spatial rank {r['rank']}: " + ", ".join(
            f"{x['kind'][8:]} {x['ms']:.1f} ms ({x['exchanges']} "
            f"exchanges, {x['bytes'] / 2**20:.1f} MiB handed in)"
            for x in w) + f"; peak allocated "
            f"{r['peak_bytes'] / 2**30:.2f} GiB")
    log(f"spatial stream (RefVSR_MFID_8K bf16, {SPATIAL_RANKS} gloo ranks "
        f"on one card, halo {SPATIAL_HALO}): forward_stream "
        f"{sum(stream_ms) / len(stream_ms):.1f} ms/window on rank 0 "
        f"(two ranks on one card) against {np.mean(one_ms[1:]):.1f} ms one "
        f"rank; frames vs one rank: mean |diff| "
        f"{[f['mean'] for f in res['frames']]}, max "
        f"{[f['max'] for f in res['frames']]}, share of pixels more than one "
        f"ulp off near the seam "
        f"{[f['near_seam_over_ulp'] for f in res['frames']]}; control "
        f"(halo 0) mean {[f['mean'] for f in res['control']]}, "
        f"max {[f['max'] for f in res['control']]}, near the seam "
        f"{[f['near_seam_over_ulp'] for f in res['control']]} (limits: mean "
        f"{SPATIAL_MEAN_LIMIT}, seam mean {SPATIAL_SEAM_MEAN_LIMIT}, seam "
        f"share {SPATIAL_SEAM_OVER_ULP_LIMIT}); launches {launches}; "
        f"{wall:.1f} s with the spawn  [{card}]")
    cases = {k: [c for r in ranks for c in r["cases"][k]]
             for k in ("warp_sample_banded", "argmax_matmul")}
    rank0 = ranks[0]["cases"]["warp_sample_banded"]
    return launches, summary, cases, rank0


@contextlib.contextmanager
def _recording_indices(out):
    """Keep the index maps the matching's K2 calls return, on the host."""
    from refvsr_tpu_torch.models import matching as matching_mod
    real = matching_mod.argmax_matmul

    def rec(*a, **k):
        conf, index = real(*a, **k)
        out.append(index.detach().cpu())
        return conf, index
    matching_mod.argmax_matmul = rec
    try:
        yield
    finally:
        matching_mod.argmax_matmul = real


@contextlib.contextmanager
def _cx_choices(out=None, held=None, rows=slice(None), flips=None):
    """The contextual loss's discrete choices (``losses/contextual.py``:
    each x position's nearest y, each y position's best x), one pair a
    call. With `out` (a list), recorded on the host in call order. With
    `held` (such a recording), rows `rows` of each held to it, the
    gradients taking the recorded positions (as ``bench/probe_amp.py``
    holds the matching's picks), and the choices of this run that differ
    counted into `flips` [differing, all]."""
    from refvsr_tpu_torch.losses import contextual
    real_nearest, real_best = contextual._nearest, contextual._best
    recorded = iter(held or ())

    def pick(idx):
        if held is None:
            out.append(idx.cpu())
            return None
        want = next(recorded)[rows].to(idx.device)
        flips[0] += int((want != idx).sum())
        flips[1] += want.numel()
        return want

    def nearest(dist):
        want = pick(dist.argmin(dim=2))
        if want is None:
            return real_nearest(dist)
        return torch.gather(dist, 2, want[..., None])

    def best(cx):
        val, idx = real_best(cx)
        want = pick(idx)
        if want is None:
            return val, idx
        return torch.gather(cx, 1, want[:, None, :])[:, 0, :], want

    contextual._nearest, contextual._best = nearest, best
    try:
        yield
    finally:
        contextual._nearest, contextual._best = real_nearest, real_best


@contextlib.contextmanager
def _per_item_convs(*modules):
    """Every ``blocks.Conv2d`` inside `modules` run one batch item at a
    time: its forward and weight-gradient sums then run on one item of the
    one-rank batch as on a rank's batch of 1 (cuDNN picks its algorithms,
    and so the order of its sums, by the batch size), and autograd adds the
    items' weight gradients, as the all-reduce adds the ranks'."""
    from refvsr_tpu_torch.models.blocks import Conv2d
    held = {id(m) for mod in modules for m in mod.modules()
            if isinstance(m, Conv2d)}
    real = Conv2d.forward

    def forward(self, x):
        if id(self) not in held or x.shape[0] == 1:
            return real(self, x)
        return torch.cat([real(self, x[i:i + 1]) for i in range(x.shape[0])])
    Conv2d.forward = forward
    try:
        yield
    finally:
        Conv2d.forward = real


def _grad_rel_l2(names, grads, want, dev):
    """Relative L2 of each gradient against `want`'s: median, p99, max,
    the worst tensors and the count."""
    rel = {}
    for name, g, gw in zip(names, grads, want):
        if g is None or gw is None:
            check(g is None and gw is None, "None gradients differ")
            continue
        gw = gw.to(dev)
        norm = float(torch.linalg.vector_norm(gw))
        if norm > 0:
            rel[name] = float(torch.linalg.vector_norm(g - gw)) / norm
    vals = np.asarray(list(rel.values()))
    return dict(grad_rel_l2_max=float(vals.max()),
                grad_rel_l2_median=float(np.median(vals)),
                grad_rel_l2_p99=float(np.quantile(vals, 0.99)),
                grad_rel_l2_worst=sorted(rel.items(),
                                         key=lambda kv: -kv[1])[:8],
                grad_tensors=len(vals))


def _ddp_rank(batch_path, want_path, steps, kind="cuda", loss=None):
    """One rank of the data-parallel step: RefVSR_MFID_8K f32 (TF32 off)
    on its half of the batch: window 0's averaged gradients against the
    one-rank batch-2 gradients (rank 0), the parameters after the update
    compared across ranks, then `steps` timed steps."""
    from refvsr_tpu_torch.configs import get_config
    from refvsr_tpu_torch.models.refvsr import init_stream_state
    from refvsr_tpu_torch.parallel import mesh
    from refvsr_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = mesh.init_from_env(kind)
    try:
        dev = mesh.device_for_rank(kind)
        rank, world = mesh.rank(), mesh.world_size()
        cfg = get_config("RefVSR_MFID_8K", batch_size=TRAIN_BATCH,
                         **NO_ASSETS, **({} if loss is None else
                                         {"loss": loss}))
        data = np.load(batch_path)
        per = TRAIN_BATCH // world
        batch = {k: data[k][rank * per:(rank + 1) * per] for k in data}
        tr = Trainer(cfg, device=dev, seed=0)
        lr, ref, hr, hr_ref = (torch.as_tensor(batch[k]).to(dev) for k in (
            "LR_UW", "LR_REF_W", "HR_UW", "HR_REF_T"))
        n, _, h, w = lr.shape[:4]
        state = init_stream_state(n, h, w, cfg.mid_channels, num_frames=T,
                                  device=dev)
        want = torch.load(want_path)
        # this rank's rows of the one-rank run's contextual choices, held
        # in both window-0 runs below
        rows = slice(rank * T * per, (rank + 1) * T * per)
        flips_c, flips = [0, 0], [0, 0]
        # the control the limits must reject besides a rank's own
        # gradients: window 0 averaged with the contextual loss's batch
        # mean taken per rank (Trainer.gradients without sync_batch_stats)
        convs = (tr.net, tr.loss_mod)
        with _per_item_convs(*convs):
            out_c, _ = tr.net.forward_train(lr[:, :T], ref[:, :T], state)
            with _cx_choices(held=want["cx"], rows=rows, flips=flips_c):
                errs_c = tr.loss_mod(out_c.float(), hr[:, T // 2],
                                     hr_ref[:, :T])
            no_sync, _ = tr.average(torch.autograd.grad(
                errs_c["total"], tr.params, allow_unused=True), errs_c)
        del out_c, errs_c
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        index = []
        with _recording_indices(index), _per_item_convs(*convs), \
                _cx_choices(held=want["cx"], rows=rows, flips=flips):
            errs, _, state, grads = tr.gradients(
                state, lr[:, :T], ref[:, :T], hr[:, T // 2], hr_ref[:, :T])
        local = [None if g is None else g.clone() for g in grads]
        grads, errs = tr.average(grads, errs)
        mine = want["index"][rows]
        res = dict(rank=rank, backend=backend,
                   index_flips=int((index[0] != mine).sum()),
                   index_entries=int(mine.numel()), cx_flips=flips,
                   cx_flips_no_sync=flips_c)
        # the all-reduce against the ranks' own gradients, gathered: the
        # mean of two f32 tensors, which gloo sums on the host, bit for bit
        flat = torch.cat([g.reshape(-1) for g in local if g is not None])
        both = mesh.all_gather_rows(flat[None], 0)
        mean = (both[0] + both[1]) / 2
        avg = torch.cat([g.reshape(-1) for g in grads if g is not None])
        res["allreduce_max_abs_diff"] = float((avg - mean).abs().max())
        if rank == 0:
            names = [k for k, p in tr.net.named_parameters()
                     if p.requires_grad]
            res.update(_grad_rel_l2(names, grads, want["grads"], dev))
            res["controls"] = {
                label: {k: v for k, v in _grad_rel_l2(
                    names, got, want["grads"], dev).items()
                    if k != "grad_rel_l2_worst"}
                for label, got in (("own half-batch", local),
                                   ("no sync_batch_stats", no_sync))}
            res["errs"] = {k: float(v) for k, v in errs.items()}
            res["errs_one_rank"] = want["errs"]
        tr.opt.update(grads)
        flat = torch.cat([p.detach().reshape(-1) for p in tr.params])
        ref0 = flat.clone()
        mesh.broadcast_([ref0])
        res["params_equal_rank0"] = bool(torch.equal(flat, ref0))
        step_ms = []
        for i in range(1, steps + 1):
            mesh.barrier(dev)
            t0 = time.perf_counter()
            _, state = tr.train_step(state, lr[:, i:i + T], ref[:, i:i + T],
                                     hr[:, i + T // 2], hr_ref[:, :i + T])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        flat = torch.cat([p.detach().reshape(-1) for p in tr.params])
        ref0 = flat.clone()
        mesh.broadcast_([ref0])
        res["params_equal_rank0_after_steps"] = bool(torch.equal(flat, ref0))
        res.update(step_ms=step_ms, launches=read_launches(),
                   peak_bytes=torch.cuda.max_memory_allocated())
        import torch.distributed as dist
        gathered = [None] * world
        dist.all_gather_object(gathered, res)
        return gathered if rank == 0 else None
    finally:
        mesh.destroy()


def phase_ddp(dev, card, loss=None):
    """The data-parallel training step on two gloo ranks sharing the card
    (RefVSR_MFID_8K at full width, f32 with TF32 off, per-rank batch 1)
    against one rank's step on the batch of 2, the convolutions run per
    batch item in both."""
    import tempfile

    from refvsr_tpu_torch.configs import get_config
    from refvsr_tpu_torch.models.refvsr import init_stream_state
    from refvsr_tpu_torch.parallel import mesh
    from refvsr_tpu_torch.train.trainer import Trainer

    cfg = get_config("RefVSR_MFID_8K", batch_size=TRAIN_BATCH, **NO_ASSETS,
                     **({} if loss is None else {"loss": loss}))
    batch = synthetic_batch(cfg, seed=13)
    with cudnn_tf32(False):
        tr = Trainer(cfg, device=dev, seed=0)
        lr, ref, hr, hr_ref = (torch.as_tensor(batch[k]).to(dev) for k in (
            "LR_UW", "LR_REF_W", "HR_UW", "HR_REF_T"))
        n, _, h, w = lr.shape[:4]
        state = init_stream_state(n, h, w, cfg.mid_channels, num_frames=T,
                                  device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index, cx = [], []
        with _recording_indices(index), _cx_choices(out=cx), \
                _per_item_convs(tr.net, tr.loss_mod):
            errs, _, _, grads = tr.gradients(state, lr[:, :T], ref[:, :T],
                                             hr[:, T // 2], hr_ref[:, :T])
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t0) * 1e3
        want = dict(grads=[None if g is None else g.cpu() for g in grads],
                    errs={k: float(v.detach()) for k, v in errs.items()},
                    index=index[0], cx=cx)
    del tr, lr, ref, hr, hr_ref, state, grads, errs
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(f"{tmp}/batch.npz", **{k: np.asarray(v) for k, v in
                                         batch.items()})
        torch.save(want, f"{tmp}/want.pt")
        t0 = time.perf_counter()
        with clock("ranks"):
            ranks = mesh.spawn(_ddp_rank, (
                f"{tmp}/batch.npz", f"{tmp}/want.pt", DDP_STEPS, "cuda",
                loss), 2, RANK_TIMEOUT_S)
        wall = time.perf_counter() - t0
    r0 = ranks[0]
    flips = [(r["index_flips"], r["index_entries"]) for r in ranks]
    log(f"DDP window 0: the matching's index maps against one rank's batch "
        f"of 2, entries that differ (rank 0, rank 1): {flips}; the "
        f"contextual loss's own choices that differ from the held ones "
        f"(rank 0, rank 1; [differing, all]): "
        f"{[r['cx_flips'] for r in ranks]}, without sync_batch_stats "
        f"{[r['cx_flips_no_sync'] for r in ranks]}")
    log(f"DDP window-0 gradients against one rank's batch of 2: "
        f"{r0['grad_tensors']} tensors, relative L2 median "
        f"{r0['grad_rel_l2_median']:.3e}, p99 {r0['grad_rel_l2_p99']:.3e}, "
        f"max {r0['grad_rel_l2_max']:.3e}; worst {r0['grad_rel_l2_worst']}")
    check(r0["grad_rel_l2_median"] <= DDP_GRAD_MEDIAN_LIMIT
          and r0["grad_rel_l2_max"] <= DDP_GRAD_MAX_LIMIT,
          f"DDP averaged gradients: relative L2 median "
          f"{r0['grad_rel_l2_median']} (limit {DDP_GRAD_MEDIAN_LIMIT}), "
          f"max {r0['grad_rel_l2_max']} (limit {DDP_GRAD_MAX_LIMIT})")
    for label, c in r0["controls"].items():
        log(f"DDP control ({label}) against one rank's batch of 2: "
            f"relative L2 median {c['grad_rel_l2_median']:.3e}, p99 "
            f"{c['grad_rel_l2_p99']:.3e}, max {c['grad_rel_l2_max']:.3e}")
        check(c["grad_rel_l2_median"] > DDP_GRAD_MEDIAN_LIMIT
              or c["grad_rel_l2_max"] > DDP_GRAD_MAX_LIMIT,
              f"DDP control ({label}) passes the limits: {c}")
    for r in ranks:
        check(r["allreduce_max_abs_diff"] == 0.0,
              f"DDP rank {r['rank']}: the averaged gradients differ from "
              f"the mean of the ranks' own by {r['allreduce_max_abs_diff']}")
        check(r["backend"] == "gloo", f"DDP backend {r['backend']}")
        check(r["params_equal_rank0"] and r["params_equal_rank0_after_steps"],
              f"DDP rank {r['rank']}: parameters differ from rank 0's")
        for k in KERNEL_FNS:
            check(r["launches"][k] > 0,
                  f"DDP rank {r['rank']}: {k} launched no time")
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    summary = dict(card=card, ranks=2, backend=r0["backend"],
                   one_rank_window0_gradients_ms=one_ms,
                   grad_rel_l2_max=r0["grad_rel_l2_max"],
                   grad_rel_l2_median=r0["grad_rel_l2_median"],
                   grad_rel_l2_p99=r0["grad_rel_l2_p99"],
                   grad_rel_l2_worst=r0["grad_rel_l2_worst"],
                   controls=r0["controls"], index_flips=flips,
                   cx_flips=[r["cx_flips"] for r in ranks],
                   cx_flips_no_sync=[r["cx_flips_no_sync"] for r in ranks],
                   errs=r0["errs"], errs_one_rank=r0["errs_one_rank"],
                   spawn_and_run_s=wall,
                   per_rank=[dict(rank=r["rank"], step_ms=r["step_ms"],
                                  peak_bytes=r["peak_bytes"])
                             for r in ranks])
    for r in ranks:
        log(f"DDP rank {r['rank']}: steps {[round(x, 1) for x in r['step_ms']]}"
            f" ms; peak allocated {r['peak_bytes'] / 2**30:.2f} GiB")
    log(f"DDP step (RefVSR_MFID_8K f32, TF32 off, 2 gloo ranks on one "
        f"card, batch 1 each): {np.mean(r0['step_ms']):.1f} ms/step on rank "
        f"0 (two ranks on one card); window-0 gradients vs one rank's "
        f"batch of 2: max rel L2 {r0['grad_rel_l2_max']:.3e} (median "
        f"{r0['grad_rel_l2_median']:.3e}); the all-reduce bit-equal to the "
        f"mean of the ranks' own; errors "
        f"{r0['errs']} vs {r0['errs_one_rank']}; launches {launches}; "
        f"{wall:.1f} s with the spawn  [{card}]")
    return launches, summary


def _train_cli_rank(argv, writes_file):
    """A rank of the spawned train CLI; rank 1 records every file it opens
    for writing."""
    import builtins
    import os as os_
    from refvsr_tpu_torch import run
    opened = []
    spy = os_.environ.get("RANK") == "1"
    real_open = builtins.open
    if spy:
        def spying(file, mode="r", *a, **k):
            if any(c in mode for c in "wax+"):
                opened.append(str(file))
            return real_open(file, mode, *a, **k)
        builtins.open = spying
    try:
        run.main(argv)
    finally:
        builtins.open = real_open
    if spy:
        with open(writes_file, "w") as f:
            json.dump(opened, f)


def cli_tree_jobs(root):
    """The scenes of the train CLI's seeded tree under `root` (the files
    the non-HD splits read)."""
    h, w = DDP_TREE_HW
    jobs = []
    for split, n in DDP_TREE_FRAMES.items():
        for cam in ("UW", "W", "T"):
            subs = [("LRx4", 4)] + ([("HR", 1)] if cam == "UW" else [])
            subs += [("LRx2", 2)] if cam == "W" else []
            for i in range(n):
                jobs.append((29000 + len(jobs), h, w, [
                    (f"{root}/RealMCVSR/{split}/{sub}/{cam}/0000/"
                     f"{i:04d}.png", f) for sub, f in subs]))
    return jobs


def phase_train_cli_ddp(card):
    """run.main --is_train --devices 2 (RefVSR_MFID at full width, -b 2,
    so batch 1 a rank) on a small seeded tree: rank 0's log tree and
    checkpoint, and no file written by rank 1."""
    from refvsr_tpu_torch import run
    from refvsr_tpu_torch.parallel import mesh
    h, w = DDP_TREE_HW
    with tree("cli") as (root, tree_s):
        writes = f"{root}/rank1_writes.json"
        argv = ["--is_train", "--config", "config_RefVSR_MFID", "--mode",
                "chip_smoke_ddp", "-b", "2", "-th", "0", "--data_offset",
                root, "--log_offset", f"{root}/logs", "--total_itr", "4",
                "--devices", "2"]
        real_spawn = mesh.spawn

        def spawn(fn, args, world, timeout_s=None):
            return real_spawn(_train_cli_rank, (args[0], writes), world,
                              RANK_TIMEOUT_S)
        mesh.spawn = spawn
        t0 = time.perf_counter()
        try:
            out = run.main(argv)
        finally:
            mesh.spawn = real_spawn
        secs = time.perf_counter() - t0
        log_dir = f"{root}/logs/RefVSR_TPU/chip_smoke_ddp"
        files = sorted(os.path.relpath(os.path.join(d, f), log_dir)
                       for d, _, fs in os.walk(log_dir) for f in fs)
        with open(writes) as f:
            rank1 = json.load(f)
        ckpt = [f for f in files if f.startswith("checkpoint/")
                and not f.endswith("checkpoints.txt")]
        with open(f"{log_dir}/checkpoint/train/epoch/checkpoints.txt") as f:
            ck_lines = f.read().splitlines()
    check(out is None, f"train CLI parent returned {out!r}")
    for need in ("config/config.json", "cost.txt",
                 "checkpoint/train/epoch/checkpoints.txt"):
        check(need in files, f"train CLI log tree lacks {need}: {files}")
    check(any(f.startswith("log/train/scalar/events") for f in files),
          f"train CLI log tree has no event file: {files}")
    check(len(ckpt) >= 1 and len(ck_lines) == 2,
          f"train CLI checkpoints {ckpt}, {ck_lines}")
    check(rank1 == [], f"rank 1 wrote {rank1}")
    summary = dict(card=card, tree_wait_s=tree_s, run_main_s=secs,
                   files=files, rank1_writes=rank1)
    log(f"train CLI --devices 2 (RefVSR_MFID full width, -b 2, 2 gloo "
        f"ranks on one card, LRx4 {h // 4}x{w // 4} tree): {secs:.1f} s "
        f"(waited {tree_s:.1f} s for its tree); rank 0 wrote {len(files)} "
        f"files, checkpoint "
        f"{ckpt}; rank 1 wrote none  [{card}]")
    return summary


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
        out = []
        for i, (a, kw) in enumerate(calls):
            with clock("to the card"):
                a = tuple(card(x) for x in a)
                kw = {k: card(v) for k, v in kw.items()}
            out.append(fn(f"{where} call {i}: {_shape(a[0])}, "
                          f"{_shape(a[1])}", a, kw))
        return out

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
    "warp_sample_banded": dict(
        id="K1-banded", source="refvsr_tpu_torch/csrc/warp_sample.cu",
        replaces="refvsr_tpu/ops/pallas/warp_select.py:293",
        tolerance="2**-6 * max|x| (bf16), 1e-5 * max|x| (f32)",
        ms_is="CUDA-event time of each of rank 0's launches in one "
              "forward_stream window of the spatial stream (two gloo ranks "
              "on one card), each timed alone while the other rank waits, "
              "summed; plain_ms, library_ms (F.grid_sample over the band) "
              "and bound_ms for the same calls"),
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
        tolerance="2**-7 * |plain| + 2**-8 * max|plain| elementwise (bf16);"
                  " on the path's calls the bias-free sum so, and the "
                  "output bit for bit bf16(that sum + bias)",
        ms_is="device time of its launches in one forward_stream window "
              "(torch.profiler); isolated_ms, plain_ms, library_ms "
              "(F.conv2d with bias, channels-last bf16, one call, as the "
              "net's Conv2d made it before K3) and bound_ms are for the "
              "inputs the path gave it in the next forward_stream window, "
              "each shape timed alone once by CUDA events and counted for "
              "each of its launches; the cases add the microbenchmark's "
              "1080x1920x48 call and its ragged shapes"),
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


def kernels_line(synthetic, on_path, in_path, in_step, launches, bench,
                 banded):
    kernels = []
    for name, m in KERNEL_META.items():
        by_path = {p: launches[p].get(name, 0) for p in launches}
        entry = dict(name=name, id=m["id"], route="cuda", source=m["source"],
                     replaces=m["replaces"], launches=sum(by_path.values()),
                     launches_by_path=by_path, tolerance=m["tolerance"],
                     ms_is=m["ms_is"])
        if name == "warp_sample_banded":
            counted, cases = banded
            b_ms, b_by = bound_ms(sum(c["nbytes"] for c in counted),
                                  sum(c["flops"] for c in counted),
                                  counted[0]["peak"])
            kernels.append(dict(
                entry, max_abs_err=max(c["max_abs_err"] for c in cases),
                ms=sum(c["ms"] for c in counted),
                plain_ms=sum(c["plain_ms"] for c in counted),
                library_ms=sum(c["library_ms"] for c in counted),
                bound_ms=b_ms, bound_by=b_by,
                cases=[_case(c) for c in cases]))
            continue
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
        forward = name in ("warp_sample", "argmax_matmul", "conv3x3_bias")
        ms = (in_path if forward else in_step)[name]
        # a K3 case holds every call of one shape
        n = sum(c.get("calls", 1) for c in counted)
        check(ms["launches"] == n or not forward,
              f"{name}: {ms['launches']} launches in the profiled window, "
              f"{n} in the captured one")
        peaks = {c["peak"] for c in counted}
        check(len(peaks) == 1, f"{name}: in-path calls of mixed peaks")
        b_ms, b_by = bound_ms(sum(c["nbytes"] for c in counted),
                              sum(c["flops"] for c in counted), peaks.pop())
        lib = [c["library_ms"] for c in counted]
        cases = synthetic[name] + counted + rest
        kernels.append(dict(
            entry, max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=ms["ms"], kernel_ms=ms["kernel_ms"],
            ms_train_step=in_step[name]["ms"] if name in in_step else None,
            isolated_ms=sum(c["ms"] for c in counted),
            plain_ms=sum(c["plain_ms"] for c in counted),
            library_ms=None if None in lib else sum(lib),
            bound_ms=b_ms, bound_by=b_by, cases=[_case(c) for c in cases]))
    return kernels


def main():
    import shutil
    try:
        smoke()
    finally:
        for pool in _HOST_POOL:
            pool.shutdown(cancel_futures=True)
        for root, _ in _TREES.values():
            shutil.rmtree(root, ignore_errors=True)


def smoke():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    card = card_line("cuda")
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    # f32 comparisons in full f32: TF32 off for matmuls and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from refvsr_tpu_torch.ops.kernels import build
    with clock("build"):
        # nvcc runs in its own processes; meanwhile the first torch.profiler
        # session starts CUPTI (7-9 s on the card's machine), once a process
        failed = []

        def build_all():
            try:
                build.LIBS.build_all()
            except BaseException as e:
                failed.append(e)
        builder = threading.Thread(target=build_all)
        builder.start()
        device_kernels(lambda: torch.ones(1, device="cuda").add_(1))
        builder.join()
        if failed:
            raise failed[0]
    log(f"kernels built in {build.LIBS.seconds:.1f} s")
    for name, text in sorted(build.LIBS.log.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    dev = "cuda"
    with clock("k1"):
        synthetic = {"warp_sample": phase_k1(dev)}
        k1_host = k1_host_pieces(dev, card)
    with clock("k2"):
        synthetic["argmax_matmul"] = phase_k2(dev)
    torch.cuda.empty_cache()
    with clock("k1_backward"):
        synthetic["warp_sample_backward"] = phase_k1_backward(dev)
    with clock("k2_backward"):
        synthetic["argmax_matmul_backward"] = phase_k2_backward(dev)
    torch.cuda.empty_cache()
    with clock("microbench"):
        launches, bench = phase_microbench(card)
    with clock("small_agreement"):
        phase_small_agreement(dev)
    with clock("small_training"):
        phase_small_training(dev)
    with clock("ir_small"):
        phase_ir_small(dev)
    torch.cuda.empty_cache()
    with clock("main_path"):
        (launches["stream"], stream_record, in_path, stream_calls,
         first_calls, k3_cases) = phase_main_path(dev, card)
    with clock("serving"):
        launches["serving"], serving, serve_calls = phase_serving(dev, card)
    with clock("pipelined"):
        launches["pipelined"], pipelined, pipe_calls = phase_pipelined(
            dev, card)
    torch.cuda.empty_cache()
    with clock("spatial"):
        launches["spatial"], spatial, spatial_cases, banded_counted = \
            phase_spatial(dev, card)
    torch.cuda.empty_cache()
    with clock("ddp"):
        # the later phases' PNG trees, on the host pool beside the ranks
        start_trees()
        launches["ddp"], ddp = phase_ddp(dev, card)
    torch.cuda.empty_cache()
    with cudnn_tf32(True):
        with clock("training"):
            launches["train"], train, in_step, train_calls = phase_training(
                dev, card)
        with clock("to_host"):
            to_host(stream_calls, first_calls, serve_calls, pipe_calls,
                    train_calls)
        torch.cuda.empty_cache()
        with clock("bench_train"):
            launches["bench"], bench_train, bench_calls = phase_bench_train(
                dev, card, stream_record)
        with clock("to_host"):
            to_host(bench_calls)
        with clock("train_entry"):
            launches["train_entry"], entry, entry_calls, amp_calls = \
                phase_train_entry(dev, card)
        with clock("to_host"):
            to_host(entry_calls, amp_calls)
        torch.cuda.empty_cache()
        with clock("ir_eval"):
            launches["ir_eval"], ir_eval, ir_calls = phase_ir_eval(dev, card)
        with clock("to_host"):
            to_host(ir_calls)
        with clock("eval_cli_8k"):
            launches["eval_cli"], eval_cli, cli_calls = phase_eval_cli_8k(
                dev, card)
        with clock("to_host"):
            to_host(cli_calls)
        with clock("ir_train"):
            launches["ir_train"], ir_train, ir_train_calls = phase_ir_train(
                dev, card)
        with clock("to_host"):
            to_host(ir_train_calls)
        torch.cuda.empty_cache()
        with clock("train_cli_ddp"):
            train_cli = phase_train_cli_ddp(card)
    launches["train_amp"] = entry["amp"]["launches"]
    with clock("path_cases"):
        on_path = path_cases(stream_calls, first_calls, train_calls,
                             {"predict": serve_calls,
                              "pipelined dispatch": pipe_calls,
                              "train entry (step 1, validation window 0)":
                              entry_calls,
                              "is_amp step": amp_calls,
                              "IR eval window (forward_stream)": ir_calls,
                              "8K eval CLI (forward_first)": cli_calls,
                              "IR train step": ir_train_calls,
                              "bench train step": bench_calls})
        on_path["argmax_matmul"][1].extend(spatial_cases["argmax_matmul"])
        # K3: the streamed window's calls; its microbenchmark's cases (the
        # default size and the ragged shapes) beside them
        on_path["conv3x3_bias"] = (k3_cases, [])
        synthetic["conv3x3_bias"] = bench["conv3x3_bias"][1]
        kernels = kernels_line(synthetic, on_path, in_path, in_step,
                               launches, {k: v for k, v in bench.items()
                                          if k not in on_path},
                               (banded_counted,
                                spatial_cases["warp_sample_banded"]))
    total_s = time.perf_counter() - t_start
    log(json.dumps(dict(main_path=dict(card=card, bench=stream_record),
                        bench=bench_train, serving=serving,
                        pipelined=pipelined, spatial=spatial, ddp=ddp,
                        training=train, train_entry=entry, ir_eval=ir_eval,
                        eval_cli=eval_cli, ir_train=ir_train,
                        train_cli=train_cli, k1_host_us=k1_host,
                        phase_s=seconds_by_phase(), spans_s=SPANS,
                        profiler_passes=PASSES, total_s=total_s),
                   default=str))
    log(json.dumps(dict(kernels=kernels)))
    log(f"where the smoke's time goes [{card}]:")
    for line in time_table(total_s):
        log(line)
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s  [{card}]")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
