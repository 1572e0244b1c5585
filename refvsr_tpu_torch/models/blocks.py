"""Building blocks (NHWC); counterpart of ``refvsr_tpu/models/blocks.py``.

Activations are NHWC tensors. ``Conv2d`` hands them to cuDNN as NCHW views
with channels-last strides (a permute, no copy) and permutes the result
back, or to K3 (``ops/kernels/conv3x3.py``) where ``takes_k3`` holds, so
every module here takes and returns NHWC. Submodule names give the
reference torch state-dict keys (``flax_to_torch_keymap``'s names), so a
reference checkpoint loads with ``load_state_dict``."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from refvsr_tpu_torch.ops.image import pixel_shuffle
from refvsr_tpu_torch.ops.kernels import conv3x3
from refvsr_tpu_torch.parallel import spatial
from refvsr_tpu_torch.utils import trace


def takes_k3(conv: nn.Conv2d, x: torch.Tensor) -> bool:
    """Whether ``Conv2d.forward`` computes `conv` on the NHWC `x` with K3:
    on the card, no gradient asked for (K3 has no backward), no spatial
    context, a 3x3 stride-1 kernel with bias, C in == C out, weights of
    x's dtype, and one image that K3 takes (``conv3x3.accepts``: bf16, C a
    multiple of 16 up to 80, contiguous, 16-byte aligned)."""
    return (x.is_cuda and not torch.is_grad_enabled()
            and spatial.active() is None
            and conv.kernel_size == (3, 3) and conv.stride == (1, 1)
            and conv.bias is not None
            and conv.in_channels == conv.out_channels
            and conv.weight.dtype == x.dtype
            and x.dim() == 4 and x.shape[0] == 1 and conv3x3.accepts(x[0]))


def _version(t: torch.Tensor):
    # a tensor made under inference mode keeps no version counter
    return None if t.is_inference() else t._version


class Conv2d(nn.Conv2d):
    """torch Conv2d on NHWC tensors: square kernel, padding k//2, bias.
    Parameters are the usual OIHW ``weight`` and ``bias``. Under an active
    spatial context the input is this rank's band of rows
    (``parallel/spatial.conv2d``); where ``takes_k3`` holds, K3 computes it;
    anything else goes to cuDNN. Under a profiler session each call is the
    span ``refvsr.conv`` (``utils/trace.py``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         kernel_size // 2)
        self._k3_key = self._k3_weights = None

    def k3_weights(self) -> tuple[torch.Tensor, torch.Tensor]:
        """K3's operands: wm (9C, C), the HWIO kernel flattened tap-major,
        and a copy of the bias as (1, 1, C). Plain attributes, not
        parameters or buffers, so the state dict keeps its keys; packed
        again when the parameters' storage, version (an in-place update,
        ``load_state_dict``) or dtype changes."""
        w, b = self.weight, self.bias
        key = (w.data_ptr(), _version(w), b.data_ptr(), _version(b), w.dtype)
        if key != self._k3_key:
            c = self.in_channels
            with torch.no_grad():
                self._k3_weights = (
                    w.permute(2, 3, 1, 0).reshape(9 * c, c).contiguous(),
                    b.reshape(1, 1, c).clone())
            self._k3_key = key
        return self._k3_weights

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with trace.span("refvsr.conv"):
            ctx = spatial.active()
            if ctx is not None:
                return spatial.conv2d(ctx, self, x)
            if takes_k3(self, x):
                return conv3x3.conv3x3_bias(x[0], *self.k3_weights())[None]
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
