"""K3: 3x3 SAME convolution with bias on one (H, W, C) bf16 image, as a
CUDA kernel and its plain version.

Replaces the Pallas kernel ``scripts/microbench_pallas_conv.py``
(``_kernel``, launched by ``pallas_conv``), whose only caller is that
microbenchmark (``refvsr_tpu_torch.bench.microbench_conv`` here). The
kernel source is ``refvsr_tpu_torch/csrc/conv3x3.cu``.

The layout is the script's: x (H, W, C); wm (9C, C), the HWIO kernel
flattened tap-major (``k.reshape(9 * C, C)``); bias (1, 1, C). The products
accumulate in f32, the sum is rounded to bf16, and only then is the bf16
bias added and the result rounded again (``microbench_pallas_conv.py:77``).
The TPU kernel's padded copy of x and its 128-channel variant B exist for
its DMA and lanes; the kernel pads by masking instead and takes any H and W.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from refvsr_tpu_torch.ops.kernels import build

# the C launchers' arguments before the stream
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3

# the weights (9C x C bf16) and a 6 x 66-pixel halo must fit one block's
# shared memory: C is 16, 32, 48, 64 or 80
MAX_CHANNELS = 80


def conv3x3_bias_plain(x: torch.Tensor, wm: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """Plain version, any dtype: f32 convolution, rounded to x's dtype, then
    the bias added in that dtype."""
    c = x.shape[2]
    k = wm.float().reshape(3, 3, c, -1).permute(3, 2, 0, 1)   # HWIO -> OIHW
    y = F.conv2d(x.float()[None].permute(0, 3, 1, 2), k, padding=1)
    return y[0].permute(1, 2, 0).to(x.dtype) + bias.to(x.dtype)


def conv3x3_bias(x: torch.Tensor, wm: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """y (H, W, C) bf16 = bf16(bf16(conv3x3_same(x, wm)) + bias).

    x (H, W, C), wm (9C, C) and bias (1, 1, C), all bf16, contiguous and
    16-byte aligned, C a multiple of 16 up to ``MAX_CHANNELS``; anything else
    raises. CPU tensors run the plain version; CUDA tensors run the kernel.
    ``conv3x3_bias.launches`` counts kernel launches."""
    if x.dim() != 3:
        raise ValueError(f"want x (H, W, C), got {tuple(x.shape)}")
    h, w, c = x.shape
    if tuple(wm.shape) != (9 * c, c) or bias.numel() != c:
        raise ValueError(f"want wm ({9 * c}, {c}) and bias (1, 1, {c}); got "
                         f"{tuple(wm.shape)} and {tuple(bias.shape)}")
    if c % 16 or not 0 < c <= MAX_CHANNELS:
        raise ValueError(f"conv3x3_bias needs C a multiple of 16 up to "
                         f"{MAX_CHANNELS}, got {c}")
    for t in (x, wm, bias):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"conv3x3_bias takes bf16, got {t.dtype}")
        if t.device != x.device:
            raise ValueError("x, wm and bias differ in device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("conv3x3_bias needs contiguous, 16-byte aligned "
                             "inputs")
    if x.device.type == "cpu":
        return conv3x3_bias_plain(x, wm, bias)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    fn = build.function("conv3x3", "conv3x3_bias_launch", _ARGS)
    build.launch(fn, x.device, x.data_ptr(), wm.data_ptr(), bias.data_ptr(),
                 y.data_ptr(), h, w, c)
    conv3x3_bias.launches += 1
    return y


conv3x3_bias.launches = 0
