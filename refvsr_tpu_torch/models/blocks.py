"""Building blocks (NHWC); counterpart of ``refvsr_tpu/models/blocks.py``.

Activations are NHWC tensors. ``Conv2d`` hands them to cuDNN as NCHW views
with channels-last strides (a permute, no copy) and permutes the result
back, so every module here takes and returns NHWC. Submodule names give the
reference torch state-dict keys (``flax_to_torch_keymap``'s names), so a
reference checkpoint loads with ``load_state_dict``."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from refvsr_tpu_torch.ops.image import pixel_shuffle
from refvsr_tpu_torch.parallel import spatial
from refvsr_tpu_torch.utils import trace


class Conv2d(nn.Conv2d):
    """torch Conv2d on NHWC tensors: square kernel, padding k//2, bias.
    Parameters are the usual OIHW ``weight`` and ``bias``. Under an active
    spatial context the input is this rank's band of rows
    (``parallel/spatial.conv2d``). Under a profiler session each call is
    the span ``refvsr.conv`` (``utils/trace.py``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         kernel_size // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with trace.span("refvsr.conv"):
            ctx = spatial.active()
            if ctx is not None:
                return spatial.conv2d(ctx, self, x)
            y = super().forward(x.permute(0, 3, 1, 2))
            return y.permute(0, 2, 3, 1)


def lrelu(x, slope):
    return F.leaky_relu(x, slope)


class BasicBlock(nn.Sequential):
    """conv + LeakyReLU(0.2) (RefVSR_/common.py BasicBlock); key
    ``<name>.0.weight``."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1):
        super().__init__(Conv2d(in_channels, out_channels, kernel_size,
                                stride))

    def forward(self, x):
        return lrelu(self[0](x), 0.2)


class ResBlock(nn.Module):
    """conv3x3 -> LeakyReLU(0.2) -> conv3x3, residual (common.py:25-39;
    res_scale is 1 in every RefVSR use)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3)
        self.conv2 = Conv2d(features, features, 3)

    def forward(self, x):
        return self.conv2(lrelu(self.conv1(x), 0.2)) + x


class ResList(nn.Module):
    """num_blocks ResBlocks + conv_tail, outer residual (common.py:64-82)."""

    def __init__(self, num_blocks: int, features: int):
        super().__init__()
        self.RBs = nn.ModuleList(ResBlock(features) for _ in range(num_blocks))
        self.conv_tail = Conv2d(features, features, 3)

    def forward(self, x):
        x1 = x
        for rb in self.RBs:
            x = rb(x)
        return self.conv_tail(x) + x1


class ResidualBlockNoBN(nn.Module):
    """mmedit residual block: conv-ReLU-conv (0.1-scaled kaiming init;
    res_scale is 1 in every RefVSR use)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3)
        self.conv2 = Conv2d(features, features, 3)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(x)))


class ResidualBlocksWithInputConv(nn.Module):
    """input conv + LeakyReLU(0.1) + N ResidualBlockNoBN (RefVSR.py:327-360);
    keys ``main.0`` and ``main.2.<i>``."""

    def __init__(self, in_channels: int, features: int, num_blocks: int = 30):
        super().__init__()
        self.main = nn.Sequential(
            Conv2d(in_channels, features, 3), nn.LeakyReLU(0.1),
            nn.Sequential(*(ResidualBlockNoBN(features)
                            for _ in range(num_blocks))))

    def forward(self, x):
        return self.main(x)


class PixelShufflePack(nn.Module):
    """conv to C*r^2 then depth-to-space (mmedit upsample.py:8-51)."""

    def __init__(self, in_channels: int, features: int, scale_factor: int = 2):
        super().__init__()
        self.scale_factor = scale_factor
        self.upsample_conv = Conv2d(in_channels,
                                    features * scale_factor ** 2, 3)

    def forward(self, x):
        return pixel_shuffle(self.upsample_conv(x), self.scale_factor)


VGG_MEAN = (0.485, 0.456, 0.406)
VGG_STD = (0.229, 0.224, 0.225)


def vgg_normalize(x: torch.Tensor) -> torch.Tensor:
    """MeanShift(1, vgg_mean, vgg_std): (x - mean) / std."""
    mean = torch.tensor(VGG_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(VGG_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator):
    """Seeded random init with the JAX package's distributions: every conv
    uniform(+-1/sqrt(fan_in)) for weight and bias (torch's default), except
    the convs of ResidualBlockNoBN, whose weights are kaiming-normal * 0.1
    (mmedit default_init_weights); then each module's own ``seeded_init``,
    where it has one. Draws on the CPU from `generator`."""
    scaled = set()
    for m in module.modules():
        if isinstance(m, ResidualBlockNoBN):
            scaled.update((id(m.conv1), id(m.conv2)))
    for m in module.modules():
        if not isinstance(m, nn.Conv2d):
            continue
        fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
        bound = 1.0 / math.sqrt(fan_in)
        if id(m) in scaled:
            w = torch.randn(m.weight.shape, generator=generator) * (
                math.sqrt(2.0 / fan_in) * 0.1)
        else:
            w = (torch.rand(m.weight.shape, generator=generator) * 2 - 1) \
                * bound
        m.weight.copy_(w)
        if m.bias is not None:
            m.bias.copy_((torch.rand(m.bias.shape, generator=generator) * 2
                          - 1) * bound)
    # modules with parameters of their own (EDVR's deformable convolution)
    for m in module.modules():
        if hasattr(m, "seeded_init"):
            m.seeded_init(generator)
