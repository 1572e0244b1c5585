"""PSNR and SSIM with the reference's protocols, on the host in float64;
counterpart of ``refvsr_tpu/eval/metrics.py``.

PSNR is 10*log10(peak / mse). SSIM is skimage's ``structural_similarity``
as the reference calls it (data_range 1, multichannel: the mean over
channels), written out: a 7x7 uniform window (``scipy.ndimage.
uniform_filter``, reflect mode), K1 0.01, K2 0.03, sample covariance. The
plain ``ssim`` averages each channel's map cropped by the window's half
width; ``ssim_masked`` averages the full map under the mask."""

from __future__ import annotations

import math

import numpy as np
from scipy.ndimage import uniform_filter


def psnr(img1, img2, peak=1.0):
    mse = np.mean((np.asarray(img1, np.float64)
                   - np.asarray(img2, np.float64)) ** 2)
    return 10 * math.log10(peak / mse)


def psnr_masked(img1, img2, mask, peak=1.0):
    d2 = (np.asarray(img1, np.float64) - np.asarray(img2, np.float64)) ** 2
    mse = np.sum(d2 * mask) / np.sum(mask)
    return 10 * math.log10(peak / mse)


def _ssim_single(x, y, data_range, win_size=7, k1=0.01, k2=0.03):
    """(the mean of the cropped SSIM map, the full map) of one channel."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n = win_size ** 2
    cov_norm = n / (n - 1.0)

    def filt(a):
        return uniform_filter(a, size=win_size, mode="reflect")
    ux, uy = filt(x), filt(y)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    a1, a2 = 2 * ux * uy + c1, 2 * vxy + c2
    b1, b2 = ux ** 2 + uy ** 2 + c1, vx + vy + c2
    s = (a1 * a2) / (b1 * b2)

    pad = (win_size - 1) // 2
    mean = s[pad:-pad, pad:-pad].mean() if s.shape[0] > 2 * pad else s.mean()
    return mean, s


def ssim(img1, img2, peak=1.0):
    """Multichannel SSIM: the mean over channels of each one's cropped
    mean."""
    vals = [_ssim_single(img1[..., c], img2[..., c], peak)[0]
            for c in range(img1.shape[-1])]
    return float(np.mean(vals))


def ssim_masked(img1, img2, mask, peak=1.0):
    """The masked mean of the full (uncropped) SSIM maps."""
    maps = [_ssim_single(img1[..., c], img2[..., c], peak)[1]
            for c in range(img1.shape[-1])]
    s = np.stack(maps, axis=-1)
    if mask.ndim == 2:
        mask = mask[..., None]
    m = np.broadcast_to(mask, s.shape)
    return float(np.sum(s * m) / np.sum(m))
