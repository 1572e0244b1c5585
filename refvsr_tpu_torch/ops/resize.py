"""Image resizing (NHWC) with ``torch.nn.functional.interpolate`` semantics.

Counterpart of ``refvsr_tpu/ops/resize.py``, which re-implements
``F.interpolate``'s coordinate conventions for the TPU; here the conventions
are PyTorch's own, so the port calls ``F.interpolate`` (and
``F.avg_pool2d``) on channels-last views of the NHWC tensors."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from refvsr_tpu_torch.parallel import spatial


def _nchw(x):
    """(..., H, W, C) -> (B, C, H, W) view, leading dims folded into B."""
    h, w, c = x.shape[-3:]
    return x.reshape(-1, h, w, c).permute(0, 3, 1, 2)


def _nhwc(y, lead):
    return y.permute(0, 2, 3, 1).reshape(*lead, *y.shape[2:], y.shape[1])


def resize(x: torch.Tensor, size=None, scale_factor=None,
           mode: str = "bilinear", align_corners: bool = False):
    """Resize (..., H, W, C) images exactly like ``F.interpolate``.

    Exactly one of ``size=(H, W)`` or ``scale_factor`` is given. With a
    scale factor the output is ``floor(in * sf)`` and coordinates use
    ``1/sf``. Modes: 'bicubic', 'bilinear', 'nearest'. Under an active
    spatial context x is this rank's band of rows: an integer-ratio scale
    factor (align_corners=False) resizes it (``parallel/spatial.resize``);
    anything else raises."""
    if (size is None) == (scale_factor is None):
        raise ValueError("pass exactly one of size / scale_factor")
    if mode not in ("bicubic", "bilinear", "nearest"):
        raise ValueError(f"unsupported resize mode: {mode}")
    ctx = spatial.active()
    if ctx is not None:
        if size is not None or align_corners or isinstance(
                scale_factor, (tuple, list)):
            raise ValueError(
                f"resize of a band of {tuple(x.shape)}: the spatial rules "
                f"take one integer-ratio scale factor, not size={size}, "
                f"scale_factor={scale_factor}, align_corners="
                f"{align_corners}")
        return spatial.resize(ctx, x, float(scale_factor), mode,
                              _resize_whole)
    return _resize_whole(x, size, scale_factor, mode, align_corners)


def _resize_whole(x, size=None, scale_factor=None, mode="bilinear",
                  align_corners=False):
    kw = {} if mode == "nearest" else {"align_corners": align_corners}
    if size is not None:
        kw["size"] = (int(size[0]), int(size[1]))
    else:
        sf = (tuple(float(s) for s in scale_factor)
              if isinstance(scale_factor, (tuple, list))
              else (float(scale_factor),) * 2)
        kw["scale_factor"] = sf
    return _nhwc(F.interpolate(_nchw(x), mode=mode, **kw), x.shape[:-3])


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 average pool of (..., H, W, C), floor output size. It
    has no spatial rule: its callers run replicated."""
    spatial.refuse("avg_pool_2x2", x)
    return _nhwc(F.avg_pool2d(_nchw(x), 2, 2), x.shape[:-3])
