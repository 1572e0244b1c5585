"""Host-side numpy image ops of the data pipeline; counterpart of
``refvsr_tpu/data/np_ops.py``.

``np_resize`` interpolates like ``torch.nn.functional.interpolate``
(align_corners, bicubic A = -0.75 with border-replicated taps, the linear
source clamp at 0) through per-axis index and weight tables. The tables are
this module's own copy of ``refvsr_tpu/ops/resize.py:_axis_tables``, so the
two packages' data pipelines compute the same numbers."""

from __future__ import annotations

import functools

import numpy as np

_CUBIC_A = -0.75


def _cubic_w(t: np.ndarray):
    """Cubic convolution weights of the 4 taps at fractional offset t."""
    a = _CUBIC_A

    def k1(x):  # |x| <= 1
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0

    def k2(x):  # 1 < |x| < 2
        return ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a

    return np.stack([k2(t + 1.0), k1(t), k1(1.0 - t), k2(2.0 - t)], axis=-1)


@functools.lru_cache(maxsize=256)
def _axis_tables(in_size: int, out_size: int, mode: str, align_corners: bool,
                 coord_scale: float | None):
    """(indices (out, taps) clipped to the input, float32 weights) of one
    axis. ``coord_scale`` is 1/scale_factor when one was given, else None
    (in_size / out_size)."""
    dst = np.arange(out_size, dtype=np.float64)
    s = coord_scale if coord_scale is not None else in_size / out_size
    if mode == "nearest":
        idx = np.floor(dst * s).astype(np.int64)[:, None]
        return np.clip(idx, 0, in_size - 1), np.ones((out_size, 1),
                                                     np.float32)
    if align_corners:
        src = dst * ((in_size - 1.0) / max(out_size - 1.0, 1.0))
    else:
        src = (dst + 0.5) * s - 0.5
        if mode in ("bilinear", "linear"):
            src = np.maximum(src, 0.0)
    i0 = np.floor(src).astype(np.int64)
    t = src - i0
    if mode in ("bilinear", "linear"):
        idx, w = np.stack([i0, i0 + 1], -1), np.stack([1.0 - t, t], -1)
    elif mode == "bicubic":
        idx, w = np.stack([i0 - 1, i0, i0 + 1, i0 + 2], -1), _cubic_w(t)
    else:
        raise ValueError(f"unsupported resize mode: {mode}")
    return np.clip(idx, 0, in_size - 1), w.astype(np.float32)


def np_resize(x: np.ndarray, size=None, scale_factor=None, mode="bicubic",
              align_corners=False) -> np.ndarray:
    """Resize (..., H, W, C) arrays to `size` (out_h, out_w) or by
    `scale_factor` (a number or a pair)."""
    h, w = x.shape[-3], x.shape[-2]
    if size is not None:
        out_h, out_w = size
        sh = sw = None
    else:
        sf = scale_factor if isinstance(scale_factor, (tuple, list)) \
            else (scale_factor, scale_factor)
        out_h, out_w = int(np.floor(h * sf[0])), int(np.floor(w * sf[1]))
        sh, sw = 1.0 / sf[0], 1.0 / sf[1]

    def interp(arr, axis, in_size, out_size, cs):
        idx, wgt = _axis_tables(in_size, out_size, mode, align_corners, cs)
        shape = [1] * arr.ndim
        shape[axis] = out_size
        out = None
        for k in range(idx.shape[1]):
            term = np.take(arr, idx[:, k], axis=axis) * wgt[:, k].reshape(
                shape)
            out = term if out is None else out + term
        return out

    x = interp(x, x.ndim - 3, h, out_h, sh)
    return interp(x, x.ndim - 2, w, out_w, sw)
