"""K5: the modulated deformable convolution (mmcv's
``modulated_deform_conv2d``: 3x3, stride 1, pad 1, dilation 1) in f32, as a
CUDA kernel; its plain version is ``models/edvr.modulated_deform_conv_plain``.

Replaces no TPU kernel: the JAX package computes the DCN plainly (gathers
and one matmul, ``refvsr_tpu/models/edvr.py``); mmcv's op was the
reference's one native CUDA op. ``models/edvr.modulated_deform_conv`` hands
it every call ``edvr.takes_k5`` admits (f32 inference on the card, operands
as ``accepts`` takes them). The kernel source is
``refvsr_tpu_torch/csrc/deform_conv.cu``.

What bounds it on the H100: at RefVSR-IR's 20 calls a frame the inputs read
once and the output written once take 1.61 ms at 3.35 TB/s (bytes); the
contraction and sampling, about 307 GFLOP, would take about 4.6 ms at the 67
TFLOP/s of f32 FMA, and the contraction in three TF32 products about 1.8 ms
at 495 TFLOP/s. The plain formulation
writes every sampled tap (N H W 9 C f32) to device memory and reads it
back; the kernel keeps the taps in shared memory, one tap's (C, 64-pixel)
column slice at a time, and contracts them there against the whole weight
on the tensor cores in three TF32 products (f32 accuracy, as K2's f32
path).

Layouts are ``modulated_deform_conv``'s: x (N, H, W, C), each image
contiguous (the batch may be strided: PCD's neighbour features are frame
slices of the (N, T, H, W, C) pyramid); offset (N, H, W, 18 dg) in mmcv's
interleaved (group, tap, {dy, dx}) layout; mask (N, H, W, 9 dg), already
sigmoided; weight OIHW (C, C, 3, 3); bias (C,). The sums are f32 in
another order than the plain version's matmul, of products split into
TF32 halves (hi*hi + hi*lo + lo*hi).
"""

from __future__ import annotations

import ctypes

import torch

from refvsr_tpu_torch.ops.kernels import build
from refvsr_tpu_torch.utils import trace

# the C launcher's arguments before the stream
_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_longlong]

# the weight (9 C x C f32), a 64-pixel tile's offset and mask rows and the
# (C, 72) column slice must fit one block's shared memory: 223,232 bytes
# at C = 64
CHANNELS = (32, 64)
# the staged rows hold 8 groups and are copied in 16-byte pieces
GROUPS = (4, 8)

_LIMIT = 2 ** 31


def _refusal(x, offset, mask, weight, bias,
             deform_groups: int) -> Exception | None:
    """The error ``deform_conv`` raises for these operands, or None where
    it takes them."""
    if x.dim() != 4:
        return ValueError(f"want x (N, H, W, C), got {tuple(x.shape)}")
    n, h, w, c = x.shape
    dg = deform_groups
    if c not in CHANNELS:
        return ValueError(f"deform_conv takes C in {CHANNELS}, got {c}")
    if dg not in GROUPS:
        return ValueError(f"deform_conv takes {GROUPS} deform groups, got "
                          f"{dg}")
    if bias is None:
        return ValueError("deform_conv needs a bias")
    want = {"offset": (offset, (n, h, w, 18 * dg)),
            "mask": (mask, (n, h, w, 9 * dg)),
            "weight": (weight, (c, c, 3, 3)), "bias": (bias, (c,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            return ValueError(f"want {name} {shape}, got {tuple(t.shape)}")
    for t in (x, offset, mask, weight, bias):
        if t.dtype != torch.float32:
            return TypeError(f"deform_conv takes f32, got {t.dtype}")
        if t.device != x.device:
            return ValueError("deform_conv's operands differ in device")
        if t.data_ptr() % 16:
            return ValueError("deform_conv needs 16-byte aligned operands")
    for t in (offset, mask, weight, bias):
        if not t.is_contiguous():
            return ValueError("deform_conv needs contiguous offsets, mask, "
                              "weight and bias")
    sn = x.stride(0) if n > 1 else h * w * c
    if tuple(x.stride()[1:]) != (w * c, c, 1) or sn % 4 or sn < h * w * c:
        return ValueError(f"deform_conv needs each image of x contiguous, "
                          f"got strides {x.stride()}")
    if ((n - 1) * sn + h * w * c >= _LIMIT
            or n * h * w * 18 * dg >= _LIMIT):
        return ValueError("deform_conv's operands exceed 2^31 elements")
    return None


def accepts(x, offset, mask, weight, bias, deform_groups: int) -> bool:
    """Whether ``deform_conv`` takes these operands: f32 on one device, C
    in ``CHANNELS``, weight (C, C, 3, 3) (C in == C out) and bias, 4 or 8
    deform groups, offset and mask of mmcv's shapes and contiguous, each
    image of x contiguous, all 16-byte aligned.
    ``models/edvr.takes_k5`` routes a call here only where it holds."""
    return _refusal(x, offset, mask, weight, bias, deform_groups) is None


def deform_conv(x, offset, mask, weight, bias,
                deform_groups: int) -> torch.Tensor:
    """out (N, H, W, C) f32 = mmcv's modulated_deform_conv2d(x, offset,
    mask, weight, bias), 3x3, stride 1, pad 1.

    Operands as ``accepts`` takes them; anything else raises. CPU tensors
    run the plain version (``models/edvr.modulated_deform_conv_plain``,
    the JAX package's formulation); CUDA tensors run the kernel.
    ``deform_conv.launches`` counts kernel launches. Under a profiler
    session each call is the span ``refvsr.k5`` (``utils/trace.py``)."""
    with trace.span("refvsr.k5"):
        err = _refusal(x, offset, mask, weight, bias, deform_groups)
        if err is not None:
            raise err
        if x.device.type == "cpu":
            from refvsr_tpu_torch.models.edvr import \
                modulated_deform_conv_plain
            return modulated_deform_conv_plain(x, offset, mask, weight, bias,
                                               deform_groups)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        n, h, w, c = x.shape
        out = torch.empty((n, h, w, c), dtype=x.dtype, device=x.device)
        if out.numel() == 0:
            return out
        fn = build.function("deform_conv", "deform_conv_launch", _ARGS)
        build.launch(fn, x.device, x.data_ptr(), offset.data_ptr(),
                     mask.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                     out.data_ptr(), n, h, w, c, deform_groups,
                     x.stride(0) if n > 1 else h * w * c)
        deform_conv.launches += 1
        return out


deform_conv.launches = 0
