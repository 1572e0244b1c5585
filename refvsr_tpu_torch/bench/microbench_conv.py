"""K3's microbenchmark: the hand-written 3x3 conv + bias kernel beside
cuDNN at the model's resblock shape; counterpart of
``scripts/microbench_pallas_conv.py``.

    python -m refvsr_tpu_torch.bench.microbench_conv [--size 1080x1920]
        [--channels 48] [--device cuda]

The inputs are the script's, seeded alike: numpy ``default_rng(0)``
normals, x (H, W, C) * 0.1, the HWIO kernel k (3, 3, C, C) * 0.05 and the
bias (1, 1, C) * 0.01, rounded to bf16; wm = k.reshape(9C, C). The
script's variants A and B are two TPU formulations of one function (B pads
wm to 128 channels for the TPU's lanes); the port has one kernel.

On the card it prints K3's max|d| against the library conv and holds K3
against its plain version elementwise within
2^-7 |plain| + 2^-8 max|plain| (two bf16 roundings, f32 sums in another
order), then times each of these by CUDA events after warm-up: K3;
``F.conv2d(x, w, bias)`` in channels-last bf16, one call as the net's
``Conv2d`` makes it (the yardstick); ``F.conv2d`` without bias; the plain
version. One ``torch.profiler`` pass gives K3's own device time and
another names the device kernels that each library call launches; it
prints the achieved GB/s and, as a reckoning and not a measurement of the
stream, the stake of the resblock chain's 300 convs a streamed window:
300 x (conv + bias - K3). With ``--device cpu`` it runs the plain version
only, and says so. Exits 1 if K3 leaves the envelope.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F

from refvsr_tpu_torch import resolve_device
from refvsr_tpu_torch.bench import bound_ms, cuda_ms, device_kernels
from refvsr_tpu_torch.ops.kernels.conv3x3 import (conv3x3_bias,
                                                  conv3x3_bias_plain)

# 3x3 convs of the resblock chain at 48 channels in one streamed window of
# RefVSR_MFID_8K (of its 621 convolutions)
RESBLOCK_CONVS = 300


def make_inputs(h, w, c, device="cpu"):
    """The script's seeded inputs, bf16: x (H, W, C), wm (9C, C), bias
    (1, 1, C)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((h, w, c)) * 0.1
    k = rng.standard_normal((3, 3, c, c)) * 0.05
    bias = rng.standard_normal((1, 1, c)) * 0.01
    return tuple(torch.from_numpy(a).to(torch.bfloat16).to(device)
                 for a in (x, k.reshape(9 * c, c), bias))


def envelope_ratio(got, want):
    """The largest |got - want| / (2^-7 |want| + 2^-8 max|want|): at most 1
    where the kernel agrees with its plain version."""
    want = want.float()
    limit = 2.0 ** -7 * want.abs() + 2.0 ** -8 * float(want.abs().max())
    return float(((got.float() - want).abs() / limit).max())


def run(size=(1080, 1920), channels=48, device="cuda", iters=20, trace=True,
        log=print):
    """K3 against its plain version and the library conv at (H, W, C) =
    (*size, channels); returns the numbers as a dict (times in ms)."""
    dev = resolve_device(device)
    h, w = size
    c = channels
    x, wm, bias = make_inputs(h, w, c, dev)
    nbytes = sum(t.numel() * t.element_size() for t in (x, wm, bias, x))
    flops = 2.0 * h * w * c * 9 * c
    res = dict(shape=[h, w, c], device=str(dev), nbytes=nbytes, flops=flops)
    if dev.type == "cpu":
        y = conv3x3_bias_plain(x, wm, bias)
        res.update(finite=bool(torch.isfinite(y.float()).all()),
                   max_abs=float(y.float().abs().max()))
        log(f"K3 conv3x3_bias {h}x{w}x{c} bf16 on the CPU: plain version "
            f"only (the kernel runs on the card), max|y| "
            f"{res['max_abs']:.4g}; no time is measured on the CPU")
        return res

    y = conv3x3_bias(x, wm, bias)
    want = conv3x3_bias_plain(x, wm, bias)
    # the net's Conv2d: an NCHW view with channels-last strides, the OIHW
    # weight and the bias, one call. The batch dimension is added before
    # the permute, as an NHWC activation has it: x.permute(2, 0, 1)[None]
    # gets a batch stride of C, which PyTorch does not take for
    # channels-last, and the call then copies x to NCHW first (2.2 ms at
    # 1080x1920x48 on the H100)
    xn = x[None].permute(0, 3, 1, 2)
    k = wm.reshape(3, 3, c, c).permute(3, 2, 0, 1).contiguous()
    b = bias.reshape(c)

    def library():
        return F.conv2d(xn, k, b, padding=1)

    def library_nobias():
        return F.conv2d(xn, k, None, padding=1)

    lib = library()[0].permute(1, 2, 0)
    torch.cuda.synchronize()
    res.update(
        ratio=envelope_ratio(y, want),
        max_abs_err=float((y.float() - want.float()).abs().max()),
        library_max_abs_diff=float((y.float() - lib.float()).abs().max()),
        max_abs=float(want.float().abs().max()),
        finite=bool(torch.isfinite(y.float()).all()))
    res["ms"] = cuda_ms(lambda: conv3x3_bias(x, wm, bias), iters)
    res["gb_per_s"] = nbytes / res["ms"] / 1e6
    res["library_ms"] = cuda_ms(library, iters)
    res["library_nobias_ms"] = cuda_ms(library_nobias, iters)
    res["plain_ms"] = cuda_ms(lambda: conv3x3_bias_plain(x, wm, bias),
                              max(3, iters // 4))
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops, torch.bfloat16)
    log(f"K3 conv3x3_bias {h}x{w}x{c} bf16: parity max|d| vs library conv "
        f"= {res['library_max_abs_diff']:.4g}; vs plain {res['max_abs_err']:.4g}"
        f" ({res['ratio']:.3f} of the envelope, max|y| {res['max_abs']:.4g})")
    log(f"  kernel {res['ms']:.4f} ms ({res['gb_per_s']:.0f} GB/s); "
        f"F.conv2d + bias {res['library_ms']:.4f} ms; F.conv2d, no bias "
        f"{res['library_nobias_ms']:.4f} ms; plain {res['plain_ms']:.4f} ms; "
        f"bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
    if trace:
        # the kernel's own device time, beside the call time above
        rows = device_kernels(lambda: [conv3x3_bias(x, wm, bias)
                                       for _ in range(iters)])
        kern = [ms for name, ms, _ in rows if "conv3x3_bias" in name]
        res["kernel_ms"] = sum(kern) / iters if kern else None
        # a reckoning, not a measurement of the stream: the resblock
        # chain's RESBLOCK_CONVS convs of a streamed window at this shape,
        # each as the library's conv + bias against K3
        res["stake_ms_per_window"] = RESBLOCK_CONVS * (res["library_ms"]
                                                       - res["ms"])
        log(f"  kernel device time {res['kernel_ms']} ms; reckoned stake "
            f"{RESBLOCK_CONVS} x (F.conv2d + bias - kernel) = "
            f"{res['stake_ms_per_window']:.2f} ms per streamed window (a "
            f"reckoning, not a stream measurement)")
        for key, fn in (("kernels_bias", library),
                        ("kernels_nobias", library_nobias)):
            res[key] = device_kernels(fn)
            log(f"  {key}: " + "; ".join(
                f"{name[:90]} {ms:.4f} ms x{n}" for name, ms, n in res[key]))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="1080x1920", help="HxW")
    ap.add_argument("--channels", type=int, default=48)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    h, w = (int(v) for v in a.size.split("x"))
    res = run((h, w), a.channels, a.device)
    if not res["finite"] or res.get("ratio", 0.0) > 1.0:
        print("FAIL: K3 left its envelope around the plain version",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
