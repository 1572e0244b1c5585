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
9. the training path at full width: RefVSR_MFID_8K trained as the JAX
   package trains it (loss '1*L1_lf+0.1*MFID_ref' at relu4_4, f32, patch
   128, 7 frames, Adam with global-norm clipping and the CA schedule) on a
   seeded synthetic batch, at batch 2 instead of the config's 8 (batch 8
   does not fit one card). One ``Trainer.iteration`` (9 optimizer steps)
   with the four kernels' launches counted; then one more step traced by
   ``torch.profiler`` (where the step's time goes), each kernel held
   against its plain version on the inputs that step gave it.

Then one ``{"kernels": [...]}`` line and, last, the device line. A kernel's
``ms`` there is its device time in the profiled window (forward kernels:
the streamed window; backward kernels: the training step); ``plain_ms``,
``library_ms`` and ``bound_ms`` are summed over the captured window's or
step's calls. K3's and K4's ``ms``, ``plain_ms`` and ``library_ms`` are
CUDA-event times of one call each at their microbenchmark's default
shape. f32 comparisons run with TF32 off for both matmuls and cuDNN
convolutions; the full-width training runs under PyTorch's default f32
policy (TF32 for cuDNN convolutions, not for matmuls), as a user's trainer
would.
"""

from __future__ import annotations

import contextlib
import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

from refvsr_tpu_torch.bench import bound_ms, cuda_ms, device_kernels
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
# K3 against its plain version at ragged shapes (H, W), C
K3_RAGGED = (((37, 53), 16), ((25, 131), 48))


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
    runners = [StreamRunner(copy.deepcopy(net), None, device=d)
               for d in ("cpu", dev)]
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
                     batch_size=1)
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
def capturing(module, name, calls, new_shapes_only=None):
    """Route `module.name` (a kernel wrapper as its caller looks it up)
    through a spy that keeps (args, kwargs), tensors detached and cloned,
    of each call in `calls`. Given a set `new_shapes_only`, it keeps only
    the first call of each argument shape not yet in the set, and adds that
    shape. The wrapper runs unchanged, and its launch count stays its own:
    a wrapper that counts through its module's name reaches the spy, which
    passes ``launches`` on to it."""
    fn = getattr(module, name)

    class Spy:
        def __call__(self, *args, **kw):
            key = _shape_key(args)
            if new_shapes_only is None or key not in new_shapes_only:
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

    cfg = get_config("RefVSR_MFID_8K", batch_size=TRAIN_BATCH)
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


def _shape(t):
    return "x".join(str(v) for v in t.shape)


def path_cases(stream_calls, first_calls, train_calls):
    """Each kernel against its plain version on the inputs the main paths
    gave it: every call of a streamed window, the first window's calls at
    shapes the streamed window lacks, and the training step's calls (the
    forward kernels once per shape, the backward kernels at every call).
    Returns {kernel: (the calls its in-path numbers sum over, the rest)}."""
    def k1(label, args, kw):
        return k1_case(label, *args, 2.0 ** -6 if args[0].dtype ==
                       torch.bfloat16 else 1e-5)

    def k2(label, args, kw):
        return k2_case(label, *args, iters=2, plain_iters=1)

    def k1_bwd(label, args, kw):
        return k1_bwd_case(label, *args, **kw)

    def k2_bwd(label, args, kw):
        return k2_bwd_case(label, *args, **kw)

    def run(fn, where, calls):
        return [fn(f"{where} call {i}: {_shape(a[0])}, {_shape(a[1])}", a, kw)
                for i, (a, kw) in enumerate(calls)]

    return {
        "warp_sample": (run(k1, "forward_stream", stream_calls["warp_sample"]),
                        run(k1, "forward_first", first_calls["warp_sample"])
                        + run(k1, "train step", train_calls["warp_sample"])),
        "argmax_matmul": (
            run(k2, "forward_stream", stream_calls["argmax_matmul"]),
            run(k2, "forward_first", first_calls["argmax_matmul"])
            + run(k2, "train step", train_calls["argmax_matmul"])),
        "warp_sample_backward": (
            run(k1_bwd, "train step", train_calls["warp_sample_backward"]),
            []),
        "argmax_matmul_backward": (
            run(k2_bwd, "train step", train_calls["argmax_matmul_backward"]),
            []),
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
    with cudnn_tf32(True):
        launches["train"], train, in_step, train_calls = phase_training(
            dev, card)
    on_path = path_cases(stream_calls, first_calls, train_calls)
    kernels = kernels_line(synthetic, on_path, in_path, in_step, launches,
                           bench)
    log(json.dumps(dict(main_path=dict(card=card, windows=windows,
                                       peak_bytes=peak), training=train)))
    log(json.dumps(dict(kernels=kernels)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
