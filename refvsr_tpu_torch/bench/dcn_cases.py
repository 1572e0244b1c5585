"""Seeded operands of the modulated deformable convolution (K5,
``ops/kernels/deform_conv.py``), shared by the CPU tests and the card
tests.

Shapes of RefVSR-IR's calls (``benchmark/configs/RefVSR_IR_MFID.json``:
EDVR-M at 64 channels, 8 deform groups, on 270x480 frames padded to
272x480): each PCD level's x is frame i of the (N, 5, H, W, 64)
pyramid, N the window's 2 or 3 keyframes, and a frame runs the DCN 4 times
for each of its 5 neighbour frames (levels 3, 2, 1 and the cascade at 1).
"""

from __future__ import annotations

import torch

# (N, H, W) of each level's calls with N keyframes, and how many of a
# frame's 20 calls take that shape
LEVELS = ((272, 480, 10), (136, 240, 5), (68, 120, 5))
FRAMES = 5


def make_inputs(n, h, w, c=64, dg=8, kind="fractional", seed=0,
                device="cpu", frames=1):
    """(x, offset, mask, weight, bias), f32, in mmcv's layouts, drawn on
    `device` (so the same seed gives other values on the card). With
    ``frames`` > 1, x is the middle frame of an (N, frames, H, W, C) tensor,
    a batch-strided view as PCD's neighbour features are. ``kind``:

    - "fractional": offsets of about 2.5 pixels, the taps between pixels;
    - "integer": the same rounded, every tap on a pixel;
    - "edges": as "fractional", with taps pushed 40 pixels outside in some
      groups and rows, anchors on exactly -1 (group 2) and H - 1 (group
      dg - 3) in every row, dx rounded in group dg - 2, one NaN tap
      (pixel (0, 1, 2), group dg - 1, tap 4), and two pixels whose every tap
      is dead (``dead_pixels``: all NaN, all far outside)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, frames, h, w, c), generator=g, device=device)
    off = torch.randn((n, h, w, dg, 9, 2), generator=g, device=device) * 2.5
    if kind == "integer":
        off = off.round()
    elif kind == "edges":
        off[:, :2, :, ::3, :, 0] += 40.0
        off[:, -2:, :, 1::4, :, 1] -= 40.0
        # sy = y + ky - 1 + dy: anchors on exactly -1 and H - 1
        base = (torch.arange(h, device=device)[:, None]
                + torch.arange(9, device=device) // 3 - 1).float()
        off[:, :, :, 2, :, 0] = -1.0 - base[None, :, None]
        off[:, :, :, dg - 3, :, 0] = (h - 1.0) - base[None, :, None]
        off[:, :, :, dg - 2, :, 1] = off[:, :, :, dg - 2, :, 1].round()
        off[0, 1, 2, dg - 1, 4, 0] = float("nan")
        (a, b), (c_, d) = dead_pixels(h, w)
        off[0, a, b] = float("nan")
        off[0, c_, d] = 1e4
    elif kind != "fractional":
        raise ValueError(f"unknown kind {kind!r}")
    off = off.reshape(n, h, w, 18 * dg)
    mask = torch.rand((n, h, w, 9 * dg), generator=g, device=device)
    wgt = torch.randn((c, c, 3, 3), generator=g, device=device) * 0.05
    bias = torch.randn(c, generator=g, device=device)
    return x[:, frames // 2], off, mask, wgt, bias


def dead_pixels(h, w):
    """The two pixels of image 0 whose every tap an "edges" case kills."""
    return (h // 2, w // 2), (h - 2, 1)


def dead_for_nan(x, off, *rest):
    """The operands with each NaN offset moved far outside the image: the
    same dead tap. The plain version's anchor of a NaN coordinate turns
    into an index out of range, so it is given the far one."""
    return (x, off.nan_to_num(nan=1e4), *rest)
