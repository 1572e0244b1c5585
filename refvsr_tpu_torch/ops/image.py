"""Image-space helpers (NHWC); counterpart of ``refvsr_tpu/ops/image.py``."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """Depth-to-space with torch.nn.PixelShuffle channel order
    (channel = c*r*r + dy*r + dx): (N, H, W, C*r*r) -> (N, H*r, W*r, C).
    Under an active spatial context x is this rank's band of rows."""
    from refvsr_tpu_torch.parallel import spatial
    ctx = spatial.active()
    if ctx is not None:
        return spatial.pixel_shuffle(ctx, x, r, _pixel_shuffle_whole)
    return _pixel_shuffle_whole(x, r)


def _pixel_shuffle_whole(x, r):
    return F.pixel_shuffle(x.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)


def refine_to_multiple(x: torch.Tensor, val: int) -> torch.Tensor:
    """Crop trailing rows/cols so H, W are multiples of `val`."""
    if val <= 1:
        return x
    h, w = x.shape[-3], x.shape[-2]
    return x[..., :h - h % val, :w - w % val, :]


@functools.lru_cache(maxsize=1)
def gaussian_lowpass_kernel() -> np.ndarray:
    """The fixed 3x3 sigma=1 depthwise kernel of the reference's
    models/loss/gaussian.py:20-27 (scipy.ndimage.gaussian_filter of a 3x3
    delta), as ``refvsr_tpu/ops/image.py`` builds it."""
    import scipy.ndimage

    n = np.zeros((3, 3))
    n[1, 1] = 1.0
    return scipy.ndimage.gaussian_filter(n, sigma=1).astype(np.float32)


def gaussian_lowpass(x: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3 gaussian blur of (N, H, W, C) with the reference's
    ReflectionPad2d(2)-then-valid semantics: the output is (N, H+2, W+2, C),
    a quirk kept on purpose (both sides of the L1_lf loss see it)."""
    c = x.shape[-1]
    k = torch.as_tensor(gaussian_lowpass_kernel(), dtype=x.dtype,
                        device=x.device)
    xp = F.pad(x.permute(0, 3, 1, 2), (2, 2, 2, 2), mode="reflect")
    y = F.conv2d(xp, k.expand(c, 1, 3, 3), groups=c)
    return y.permute(0, 2, 3, 1)


def clamp01(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0.0, 1.0)
