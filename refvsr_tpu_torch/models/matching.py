"""Cross-camera feature matching and aligned attention (NHWC); counterpart of
``refvsr_tpu/models/matching.py``.

- ``FeatureMatching``: VGG prefix + 1x1 ``map{64|128}`` conv, 3x3 patch
  cosine similarity, max/argmax by kernel K2 (``ops/kernels/argmax_matmul``).
- ``AlignedAttention``: index-map patch warp (kernel == stride, so the fold
  is a reshape) and, when aligning, ``AlignedConv2d``.
- ``AlignedConv2d``: per-pixel affine (scale, rotation) resampling of the
  warped canvas. Its tap coordinates are f32 whatever the compute dtype, and
  the bilinear gather is plain torch indexing, chunked to bound the corner
  temporaries (4 x 8.3M x 48 values at 1080p input)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from refvsr_tpu_torch.models.blocks import (BasicBlock, Conv2d, ResBlock,
                                            vgg_normalize)
from refvsr_tpu_torch.models.vgg import VGGFeatures
from refvsr_tpu_torch.ops.kernels.argmax_matmul import argmax_matmul
from refvsr_tpu_torch.ops.patches import (extract_patches,
                                          fold_non_overlapping,
                                          gather_patches)
from refvsr_tpu_torch.ops.resize import avg_pool_2x2, resize

# corner-gather chunk: taps * C values per gathered corner
_AFFINE_CHUNK_ELEMS = 1 << 26


def _l2_normalize(x, dim, eps=1e-12):
    """torch F.normalize: x / max(||x||, eps)."""
    return x / torch.sqrt((x * x).sum(dim, keepdim=True)).clamp_min(eps)


class FeatureMatching(nn.Module):
    """VGG-prefix cosine patch matching -> (confidence map, hard index map)
    (attention.py:14-100). scale 4 taps vgg19 features[:4] (64 ch); scale 2
    or HD-in taps features[:7] (128 ch); then the 1x1 map conv to 16 ch,
    registered inside ``feature_extract`` as the reference does. Patches
    are 3x3 at stride 1."""

    def __init__(self, scale: int = 4, flag_HD_in: bool = False):
        super().__init__()
        self.scale, self.flag_HD_in = scale, flag_HD_in
        vgg_range = 7 if (flag_HD_in or scale != 4) else 4
        self.feature_extract = VGGFeatures(vgg_range)
        ch = self.feature_extract.out_channels
        self.map_name = f"map{ch}"
        self.feature_extract.add_module(self.map_name,
                                        BasicBlock(ch, 16, kernel_size=1))

    def _feat(self, img):
        return getattr(self.feature_extract, self.map_name)(
            self.feature_extract(img))

    def forward(self, lr, ref):
        """lr (N,h,w,3), ref (N,hr,wr,3) -> conf (N,h,w,1), index (N,L)."""
        h = lr.shape[1]
        lr = vgg_normalize(lr)
        ref = vgg_normalize(ref)
        if self.flag_HD_in:
            sf = 1.0 / (self.scale // 2)
            lr = resize(lr, scale_factor=sf, mode="nearest")
            ref = resize(ref, scale_factor=sf, mode="nearest")
        lr_f = self._feat(lr)
        lr_p = extract_patches(lr_f, 3, 1, "same")
        ref_f = self._feat(avg_pool_2x2(ref))
        ref_p = extract_patches(ref_f, 3, 1, "same")
        ref_p = _l2_normalize(ref_p, 2).contiguous()
        lr_p = _l2_normalize(lr_p, 2).contiguous()
        conf, index = argmax_matmul(ref_p, lr_p)
        conf = conf.to(lr_p.dtype)
        h_c, w_c = lr_f.shape[1], lr_f.shape[2]
        conf = conf.reshape(-1, h_c, w_c, 1)
        if h != h_c:
            conf = resize(conf, scale_factor=h / h_c, mode="bicubic")
            conf = conf.clamp(0.0, 1.0)
        return conf, index


def _affine_corner_weights(hp, wp, p_row, p_col):
    """Clamped-corner anchors and collapse-routed weights of the reference's
    affine bilinear sampling (alignment.py:62-89): corners are clamped into
    the canvas independently of the point, so a corner clamped onto lt
    double-counts; its weight is routed to the corner actually read.
    Returns (lt_row, lt_col int64, w00, w01, w10, w11) in f32."""
    lt_row = torch.floor(p_row)
    lt_col = torch.floor(p_col)
    rb_row, rb_col = lt_row + 1, lt_col + 1
    lt_row_c = lt_row.clamp(0, hp - 1)
    lt_col_c = lt_col.clamp(0, wp - 1)
    rb_row_c = rb_row.clamp(0, hp - 1)
    rb_col_c = rb_col.clamp(0, wp - 1)
    p_row_c = p_row.clamp(0, hp - 1)
    p_col_c = p_col.clamp(0, wp - 1)

    g_lt = (1 + (lt_row_c - p_row_c)) * (1 + (lt_col_c - p_col_c))
    g_rb = (1 - (rb_row_c - p_row_c)) * (1 - (rb_col_c - p_col_c))
    g_lb = (1 + (lt_row_c - p_row_c)) * (1 - (rb_col_c - p_col_c))
    g_rt = (1 - (rb_row_c - p_row_c)) * (1 + (lt_col_c - p_col_c))

    cx = (rb_col_c == lt_col_c).to(g_lt.dtype)
    cy = (rb_row_c == lt_row_c).to(g_lt.dtype)
    w00 = g_lt + cx * g_lb + cy * g_rt + cx * cy * g_rb
    w01 = (1 - cx) * (g_lb + cy * g_rb)
    w10 = (1 - cy) * (g_rt + cx * g_rb)
    w11 = (1 - cx) * (1 - cy) * g_rb
    return lt_row_c.long(), lt_col_c.long(), w00, w01, w10, w11


def affine_bilinear_gather(xp, p_row, p_col):
    """Affine tap sampler on an already padded canvas.

    xp (N, Hp, Wp, C); p_row/p_col (N, ...) f32 canvas coords ->
    (N, ..., C). Corner weights are f32 cast to xp.dtype and the four
    products are summed in xp.dtype, as in the JAX sampler. A +1 corner
    that leaves the canvas is read clamped; its weight is exactly 0."""
    n, hp, wp, c = xp.shape
    idx_shape = p_row.shape
    ltr, ltc, w00, w01, w10, w11 = _affine_corner_weights(hp, wp, p_row,
                                                           p_col)
    flat = xp.reshape(n, hp * wp, c)
    dt = xp.dtype
    args = [a.reshape(n, -1) for a in (ltr, ltc, w00, w01, w10, w11)]
    total = args[0].shape[1]
    out = torch.empty((n, total, c), dtype=dt, device=xp.device)
    bidx = torch.arange(n, device=xp.device)[:, None]
    per = max(1, _AFFINE_CHUNK_ELEMS // max(n * c, 1))
    for s in range(0, total, per):
        r, cc, a, b, d, e = (t[:, s:s + per] for t in args)
        r1 = (r + 1).clamp_max(hp - 1)
        c1 = (cc + 1).clamp_max(wp - 1)

        def v(ri, ci):
            return flat[bidx, ri * wp + ci]

        out[:, s:s + per] = (v(r, cc) * a[..., None].to(dt)
                             + v(r, c1) * b[..., None].to(dt)
                             + v(r1, cc) * d[..., None].to(dt)
                             + v(r1, c1) * e[..., None].to(dt))
    return out.reshape(*idx_shape, c)


class AlignedConv2d(nn.Module):
    """Per-pixel affine patch resampler (alignment.py:10-178): head ``conv1``
    (conv5x5 3->32, lrelu, ResBlock, lrelu) on both images, then ``p_conv``
    (strided conv5x5 64->32, lrelu, ResBlock, lrelu, conv1x1 -> 3) estimates
    (scale_row, scale_col, rotation) per grid cell. The canvas is
    reflection-padded by 1 (alignment.py:16)."""

    def __init__(self, kernel_size: int, stride: int):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.conv1 = nn.Sequential(Conv2d(3, 32, 5), nn.LeakyReLU(0.2),
                                   ResBlock(32), nn.LeakyReLU(0.2))
        self.p_conv = nn.Sequential(Conv2d(64, 32, 5, stride=stride),
                                    nn.LeakyReLU(0.2), ResBlock(32),
                                    nn.LeakyReLU(0.2), Conv2d(32, 3, 1))

    def forward(self, x, query, ref):
        """x: warped canvas (N, Hx, Wx, C); query: lr (N, Hx/2, Wx/2, 3);
        ref: warped ref image (N, Hx, Wx, 3) -> (N, h*ks, w*ks, C)."""
        ks = self.kernel_size
        query = resize(query, scale_factor=2, mode="bicubic")
        a = torch.cat([self.conv1(ref), self.conv1(query)], -1)
        affine = (self.p_conv(a) + 1.0).clamp(-3.0, 3.0)
        n, h, w, _ = affine.shape
        affine = affine.float()
        dev = affine.device
        half = (ks - 1) // 2
        taps_1d = np.arange(-half - 0.5, half + 0.6, 1.0)
        pn_row, pn_col = np.meshgrid(taps_1d, taps_1d, indexing="ij")
        pn_row = torch.tensor(pn_row.reshape(-1), dtype=torch.float32,
                              device=dev)
        pn_col = torch.tensor(pn_col.reshape(-1), dtype=torch.float32,
                              device=dev)
        p0_row = torch.tensor(1.0 + np.arange(h) * self.stride,
                              dtype=torch.float32, device=dev)[
            None, :, None, None]
        p0_col = torch.tensor(1.0 + np.arange(w) * self.stride,
                              dtype=torch.float32, device=dev)[
            None, None, :, None]
        s_row = affine[..., 0:1]
        s_col = affine[..., 1:2]
        theta = (affine[..., 2:3] - 1.0) * 1.0472
        cos_t, sin_t = torch.cos(theta), torch.sin(theta)
        rx = pn_row * s_row                      # (N, h, w, ntaps)
        ry = pn_col * s_col
        center = half + 0.5
        p_row = rx * cos_t - ry * sin_t + center + p0_row
        p_col = rx * sin_t + ry * cos_t + center + p0_col

        xp = F.pad(x.permute(0, 3, 1, 2), (1,) * 4,
                   mode="reflect").permute(0, 2, 3, 1)
        c = x.shape[-1]
        o = affine_bilinear_gather(xp, p_row, p_col)
        o = o.reshape(n, h, w, ks, ks, c).permute(0, 1, 3, 2, 4, 5)
        return o.reshape(n, h * ks, w * ks, c)


class AlignedAttention(nn.Module):
    """Index-map driven patch warp + optional affine alignment
    (attention.py:102-159). Patch size and stride are both `scale` (k_vsize
    and stride are 1 in every RefVSR use). Output spatial size is twice
    lr's."""

    def __init__(self, scale: int, align: bool):
        super().__init__()
        self.scale, self.align_on = scale, align
        if align:
            self.align = AlignedConv2d(kernel_size=scale, stride=scale)

    def forward(self, lr, ref, index_map, value, return_fm: bool = False):
        """`value` warped patch by patch onto the (2h, 2w) grid by
        `index_map`, then affine-aligned; `return_fm` returns the warped
        value before the alignment (the Runner's sample tile)."""
        h, w = lr.shape[1], lr.shape[2]
        k = self.scale

        def patch_warp(v):
            unfolded = extract_patches(v, k, k, "same")
            return fold_non_overlapping(gather_patches(unfolded, index_map),
                                        (h * 2, w * 2), k, v.shape[-1])

        warped = patch_warp(value)
        if return_fm or not self.align_on:
            return warped
        return self.align(warped, lr, patch_warp(ref))

