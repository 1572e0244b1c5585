"""K6: 3x3 SAME convolution with bias on one (H, W, C) f32 image, in three
TF32 products on the tensor cores (f32 accuracy), as a CUDA kernel and its
plain version.

Replaces no TPU kernel: the JAX package leaves f32 convolutions to XLA.
K6 is K3's (``conv3x3.py``) f32 counterpart. ``models/blocks.Conv2d``
hands it the calls ``blocks.routed_kernel`` routes here (f32 inference on
one image, 3x3, stride 1, C in == C out, an image ``accepts`` takes): the
f32 evaluation paths' residual chains, which cuDNN ran as NCHW f32
kernels with a transpose in, a transpose out and a separate bias add. The
kernel source is ``refvsr_tpu_torch/csrc/conv3x3_f32.cu``; what bounds it
is the tensor cores (three TF32 passes over 2 H W 9 C^2 FLOP).

Layouts: x (H, W, C); the weights as ``pack`` leaves them, (2, 9 N N) f32
(N is C rounded up to 8): each tap's 9 x N x N HWIO slice padded with
zeros, its input channels permuted within each 8-channel k-step to the
order in which the kernel's threads load x, laid out as wgmma's K-major B
operand, the TF32 high part and then the low part (a = hi + lo, each
rounded to nearest, ties away from zero); bias (1, 1, C). The kernel sums
hi*hi + hi*lo + lo*hi in f32, then adds the bias; the plain version
convolves with hi + lo in f32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from refvsr_tpu_torch.ops.kernels import build
from refvsr_tpu_torch.utils import trace

# the C launcher's arguments before the stream
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5

# C: (N, VEC), the plan ``pack`` lays the weights out for: N output columns
# and channels a tap (C rounded up to 8), VEC channels a thread loads at
# once. The launcher is handed the plan with the weights and refuses one
# that is not its Plan<C> (csrc/conv3x3_f32.cu). The packed weights (2 x 9
# N^2 f32) and a ring of 66-pixel input rows must fit one block's shared
# memory: 229,336 bytes at C = 48; C = 64 would need 294,912 for the
# weights alone
PLANS = {32: (32, 2), 36: (40, 2), 48: (48, 4)}
CHANNELS = tuple(PLANS)


def _order(c: int) -> torch.Tensor:
    """(N / 8, 8): the input channel that logical row k of k-step s of a
    tap holds. A thread's load of VEC channels starting at 4 VEC q + VEC
    (t % 4) serves VEC / 2 k-steps; in each, its two channels are logical
    rows t % 4 and t % 4 + 4 (wgmma's A columns of that thread)."""
    n, vec = PLANS[c]
    s = torch.arange(n // 8)[:, None]
    k = torch.arange(8)[None, :]
    half = vec // 2
    return (4 * vec * (s // half) + vec * (k % 4) + 2 * (s % half)
            + k // 4)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as the kernel rounds x."""
    bits = (t.contiguous().view(torch.int32) + 0x1000) & -0x2000
    return bits.view(torch.float32)


def pack(weight: torch.Tensor) -> torch.Tensor:
    """The kernel's weights from an OIHW (C, C, 3, 3) f32 weight: (2, 9 N N)
    f32, contiguous, on the weight's device. Element (((t S + s) 2 + h) N
    + n) 4 + j of each part is tap t's weight from input channel
    ``_order(C)[s, 4 h + j]`` to output n (zero past C), S = N / 8."""
    c = weight.shape[0]
    if tuple(weight.shape) != (c, c, 3, 3) or c not in PLANS:
        raise ValueError(f"want an OIHW (C, C, 3, 3) weight with C in "
                         f"{CHANNELS}, got {tuple(weight.shape)}")
    if weight.dtype != torch.float32:
        raise TypeError(f"pack takes f32, got {weight.dtype}")
    n, _ = PLANS[c]
    w = weight.new_zeros((9, n, n))                        # tap, in, out
    w[:, :c, :c] = weight.permute(2, 3, 1, 0).reshape(9, c, c)
    w = w[:, _order(c).to(weight.device)]                  # tap, s, k, out
    w = w.reshape(9, n // 8, 2, 4, n).permute(0, 1, 2, 4, 3)
    hi = _tf32(w)
    lo = _tf32(w - hi)
    return torch.stack([hi, lo]).reshape(2, -1).contiguous()


def unpack(wp: torch.Tensor, c: int) -> torch.Tensor:
    """The OIHW (C, C, 3, 3) f32 weight hi + lo that the packed weights
    hold (the weight ``pack`` was given, to about 2^-22 of each entry)."""
    n, _ = PLANS[c]
    w = (wp[0] + wp[1]).reshape(9, n // 8, 2, n, 4).permute(0, 1, 2, 4, 3)
    full = w.new_zeros((9, n, n))
    full[:, _order(c).to(wp.device)] = w.reshape(9, n // 8, 8, n)
    return full[:, :c, :c].reshape(3, 3, c, c).permute(3, 2, 0, 1)


def conv3x3_f32_plain(x: torch.Tensor, wp: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """Plain version: the f32 convolution with the packed weights' hi + lo,
    then the bias added in f32; contiguous (H, W, C), as the kernel's."""
    c = x.shape[2]
    y = F.conv2d(x.permute(2, 0, 1)[None], unpack(wp, c), padding=1)
    return (y[0].permute(1, 2, 0) + bias.reshape(c)).contiguous()


def _refusal(x: torch.Tensor, wp: torch.Tensor | None = None,
             bias: torch.Tensor | None = None) -> Exception | None:
    """The error ``conv3x3_f32`` raises for these operands, or None where
    it takes them; given x alone, the checks of x as its image."""
    if x.dim() != 3:
        return ValueError(f"want x (H, W, C), got {tuple(x.shape)}")
    c = x.shape[2]
    if c not in PLANS:
        return ValueError(f"conv3x3_f32 needs C in {CHANNELS}, got {c}")
    if wp is not None:
        n, _ = PLANS[c]
        if tuple(wp.shape) != (2, 9 * n * n) or bias.numel() != c:
            return ValueError(f"want wp (2, {9 * n * n}) and bias (1, 1, "
                              f"{c}); got {tuple(wp.shape)} and "
                              f"{tuple(bias.shape)}")
    for t in (x,) if wp is None else (x, wp, bias):
        if t.dtype != torch.float32:
            return TypeError(f"conv3x3_f32 takes f32, got {t.dtype}")
        if t.device != x.device:
            return ValueError("x, wp and bias differ in device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            return ValueError("conv3x3_f32 needs contiguous, 16-byte "
                              "aligned inputs")
    return None


def accepts(x: torch.Tensor) -> bool:
    """Whether ``conv3x3_f32`` takes x as its image: (H, W, C) f32, C in
    ``CHANNELS``, contiguous and 16-byte aligned. ``models/blocks`` routes
    a convolution here only where it holds."""
    return _refusal(x) is None


def conv3x3_f32(x: torch.Tensor, wp: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """y (H, W, C) f32 = conv3x3_same(x, hi + lo) + bias, the products in
    three TF32 passes, summed in f32.

    x (H, W, C) as ``accepts`` takes it, wp (2, 9 N N) from ``pack`` and
    bias (1, 1, C), all f32, contiguous and 16-byte aligned; anything else
    raises. CPU tensors run the plain version; CUDA tensors run the kernel.
    ``conv3x3_f32.launches`` counts kernel launches. Under a profiler
    session each call is the span ``refvsr.k6`` (``utils/trace.py``)."""
    with trace.span("refvsr.k6"):
        err = _refusal(x, wp, bias)
        if err is not None:
            raise err
        if x.device.type == "cpu":
            return conv3x3_f32_plain(x, wp, bias)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        y = torch.empty_like(x)
        if y.numel() == 0:
            return y
        h, w, c = x.shape
        fn = build.function("conv3x3_f32", "conv3x3_f32_launch", _ARGS)
        build.launch(fn, x.device, x.data_ptr(), wp.data_ptr(),
                     bias.data_ptr(), y.data_ptr(), h, w, c, *PLANS[c])
        conv3x3_f32.launches += 1
        return y


conv3x3_f32.launches = 0
