"""Patch extraction and reassembly (NHWC) for matching and aligned attention.

Counterpart of ``refvsr_tpu/ops/patches.py``. Patch vectors are laid out
``[ky, kx, C]`` (C fastest), as in the JAX package; every fold in RefVSR has
kernel == stride, so the fold is a reshape."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def same_pad_reflect(x: torch.Tensor, ksize: int, stride: int):
    """TF-style 'same' padding with reflection (top = pad//2)."""
    h, w = x.shape[-3], x.shape[-2]
    out_h, out_w = -(-h // stride), -(-w // stride)
    pad_h = max(0, (out_h - 1) * stride + ksize - h)
    pad_w = max(0, (out_w - 1) * stride + ksize - w)
    if pad_h == 0 and pad_w == 0:
        return x
    top, left = pad_h // 2, pad_w // 2
    y = F.pad(x.permute(0, 3, 1, 2), (left, pad_w - left, top, pad_h - top),
              mode="reflect")
    return y.permute(0, 2, 3, 1)


def extract_patches(x: torch.Tensor, ksize: int, stride: int,
                    padding: str = "same") -> torch.Tensor:
    """(N, H, W, C) -> (N, L, k*k*C), L = out_h*out_w row-major. It has
    no spatial rule (its callers run it on whole tensors)."""
    from refvsr_tpu_torch.parallel import spatial
    spatial.refuse("extract_patches", x)
    if padding == "same":
        x = same_pad_reflect(x, ksize, stride)
    n, h, w, c = x.shape
    if stride == ksize:
        oh, ow = h // ksize, w // ksize
        x = x[:, :oh * ksize, :ow * ksize]
        x = x.reshape(n, oh, ksize, ow, ksize, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(n, oh * ow, ksize * ksize * c)
    oh = (h - ksize) // stride + 1
    ow = (w - ksize) // stride + 1
    views = [x[:, ky:ky + (oh - 1) * stride + 1:stride,
               kx:kx + (ow - 1) * stride + 1:stride, :]
             for ky in range(ksize) for kx in range(ksize)]
    return torch.stack(views, 3).reshape(n, oh * ow, ksize * ksize * c)


def fold_non_overlapping(patches: torch.Tensor, out_hw, ksize: int,
                         channels: int) -> torch.Tensor:
    """Inverse of extract_patches for kernel == stride:
    (N, L, k*k*C) -> (N, H, W, C)."""
    out_h, out_w = out_hw
    n = patches.shape[0]
    x = patches.reshape(n, out_h // ksize, out_w // ksize, ksize, ksize,
                        channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, out_h, out_w, channels)


def gather_patches(values: torch.Tensor, index: torch.Tensor):
    """Batched row gather: values (N, L_src, D), index (N, L_out) ->
    (N, L_out, D). Indexes whole rows (``torch.gather`` would need an
    (N, L_out, D) int64 index, 3.2 GB for aa2 at 1080p input)."""
    bidx = torch.arange(values.shape[0], device=values.device)[:, None]
    return values[bidx, index.long()]
