"""EDVR-M feature extractor of the information refill (RefVSR-IR), NHWC;
counterpart of ``refvsr_tpu/models/edvr.py``.

The modulated deformable convolution (mmcv's ``modulated_deform_conv2d``,
the reference's one native CUDA op) is not a TPU kernel in the JAX package,
which computes it with plain gathers and one matmul; the port does the same
in PyTorch, and on the card hands f32 inference to K5
(``ops/kernels/deform_conv.py``, a hand-written CUDA kernel that samples,
masks and contracts in one launch) wherever ``takes_k5`` holds. Elsewhere
(training, the CPU, other widths or dtypes) ``modulated_deform_conv`` folds
the deform groups into the batch, samples the 9 taps of every group with
``bilinear_sample`` (four corner gathers of whole rows of ``cg`` channels,
so no index is as large as the sampled tensor), applies the mask and
contracts (HW, 9*C) x (9*C, O) in one ``torch.matmul``.
``modulated_deform_conv_plain`` is a transcription of the JAX formulation
(a zero ring around the image, anchors clamped to [-1, S-1], one
``torch.gather`` per corner) that the tests hold both against.

Offset layout as mmcv reads it and as the JAX package reinterprets it:
``ModulatedDCNPack`` splits its offset conv's output into o1 | o2 | mask,
concatenates o1 and o2, and the convolution reads that as (group, tap,
{dy, dx}) interleaved; the mask (after a sigmoid) as (group, tap). A tap
whose anchor lies outside [-1, S-1] on either axis gives exact zero, and
corners outside the image read zero.

Submodule names give the reference torch keys (``edvr.pcd_alignment.
offset_conv1.l3.conv.weight``, ``edvr.feature_extraction.0.conv1.weight``,
``...dcn_pack.l1.weight``), so ``utils/convert.params_from_jax`` and a
reference checkpoint fill them directly."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from refvsr_tpu_torch.models.blocks import Conv2d, ResidualBlockNoBN, lrelu
from refvsr_tpu_torch.ops.kernels import deform_conv
from refvsr_tpu_torch.ops.kernels.warp_sample import bilinear_sample
from refvsr_tpu_torch.ops.resize import _nchw, _nhwc, resize
from refvsr_tpu_torch.utils import trace

_TAPS = 9


def _sample_coords(offset, h, w, dg):
    """(sy, sx), each (N*dg, H, W*9) f32: the 9 taps' source coordinates of
    every pixel and deform group, from mmcv-layout offsets (N, H, W,
    2*dg*9). Base taps of the pad-1 3x3 conv at (y + i - 1, x + j - 1)."""
    n = offset.shape[0]
    dev = offset.device
    off = offset.float().reshape(n, h, w, dg, _TAPS, 2)
    ty = torch.arange(3, dtype=torch.float32, device=dev).repeat_interleave(3)
    tx = torch.arange(3, dtype=torch.float32, device=dev).repeat(3)
    gy = torch.arange(h, dtype=torch.float32, device=dev)[:, None, None]
    gx = torch.arange(w, dtype=torch.float32, device=dev)[None, :, None]
    sy = (gy + (ty - 1.0))[None, :, :, None] + off[..., 0]
    sx = (gx + (tx - 1.0))[None, :, :, None] + off[..., 1]

    def fold(s):    # (N, H, W, dg, 9) -> (N*dg, H, W*9)
        return s.permute(0, 3, 1, 2, 4).reshape(n * dg, h, w * _TAPS)
    return fold(sy), fold(sx)


def _contract(sampled, mask, weight, bias, n, h, w, dg):
    """Mask the sampled taps (N*dg, H, W*9, cg), restore the channel order
    and contract with the OIHW weight in one matmul: (N*H*W, 9*C) x
    (9*C, O)."""
    cg = sampled.shape[-1]
    c = dg * cg
    m = mask.reshape(n, h, w, dg, _TAPS).permute(0, 3, 1, 2, 4).reshape(
        n * dg, h, w * _TAPS, 1)
    sampled = sampled * m.to(sampled.dtype)
    cols = sampled.reshape(n, dg, h, w, _TAPS, cg).permute(
        0, 2, 3, 4, 1, 5).reshape(n * h * w, _TAPS * c)
    wmat = weight.permute(2, 3, 1, 0).reshape(_TAPS * c, weight.shape[0])
    out = torch.matmul(cols, wmat.to(cols.dtype)).reshape(n, h, w, -1)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def takes_k5(x, offset, mask, weight, bias, deform_groups: int) -> bool:
    """Whether ``modulated_deform_conv`` computes the call with K5: x on
    the card, no gradient asked for (K5 has no backward), and operands K5
    takes (``deform_conv.accepts``: all f32, C in == C out of 32 or 64, a
    bias, 4 or 8 deform groups, contiguous offsets and mask, each image of
    x contiguous, 16-byte aligned). The spatial context does not matter:
    EDVR runs under ``models/refvsr.replicated_rows``, which suspends it,
    so the deformable convolution always sees whole images, and K5
    computes the same per-pixel function as the row-gather path on
    whatever images it is given."""
    return (x.is_cuda and not torch.is_grad_enabled()
            and deform_conv.accepts(x, offset, mask, weight, bias,
                                    deform_groups))


def _deform_conv_rows(x, offset, mask, weight, bias, deform_groups: int):
    """The row-gather path: the deform groups folded into the batch, the
    taps sampled by ``bilinear_sample``, masked and contracted in one
    matmul."""
    n, h, w, c = x.shape
    dg = deform_groups
    cg = c // dg
    sy, sx = _sample_coords(offset, h, w, dg)
    xg = x.reshape(n, h, w, dg, cg).permute(0, 3, 1, 2, 4).reshape(
        n * dg, h, w, cg)
    sampled = bilinear_sample(xg, sx, sy, "zeros")  # (N*dg, H, W*9, cg)
    return _contract(sampled, mask, weight, bias, n, h, w, dg)


def modulated_deform_conv(x, offset, mask, weight, bias, deform_groups: int):
    """mmcv ``modulated_deform_conv2d`` (3x3, stride 1, pad 1, dilation 1,
    the only configuration EDVR uses). x (N, H, W, C); offset (N, H, W,
    2*dg*9) in mmcv's layout; mask (N, H, W, dg*9), already sigmoided;
    weight (O, C, 3, 3); bias (O,) or None. Returns (N, H, W, O). K5
    computes it where ``takes_k5`` holds, the row-gather path elsewhere.
    Under a profiler session the call is the host span ``refvsr.dcn``, and
    a call K5 computes holds the span ``refvsr.k5``."""
    with trace.span("refvsr.dcn"):
        if takes_k5(x, offset, mask, weight, bias, deform_groups):
            return deform_conv.deform_conv(x, offset, mask, weight, bias,
                                           deform_groups)
        return _deform_conv_rows(x, offset, mask, weight, bias,
                                 deform_groups)


def modulated_deform_conv_plain(x, offset, mask, weight, bias,
                                deform_groups: int):
    """The same function as the JAX package computes it
    (``refvsr_tpu/models/edvr.py:26-103``): a canvas with one zero ring,
    anchors clamped to [-1, S-1], one ``torch.gather`` per corner, and
    taps whose anchor lies outside zeroed. Same arguments and result as
    ``modulated_deform_conv``."""
    n, h, w, c = x.shape
    dg = deform_groups
    cg = c // dg
    sy, sx = _sample_coords(offset, h, w, dg)
    xg = x.reshape(n, h, w, dg, cg).permute(0, 3, 1, 2, 4).reshape(
        n * dg, h, w, cg)
    canvas = F.pad(xg, (0, 0, 1, 1, 1, 1))           # (N*dg, H+2, W+2, cg)
    flat = canvas.reshape(n * dg, (h + 2) * (w + 2), cg)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy, wx = sy - y0, sx - x0
    y0i = y0.clamp(-1, h - 1).long() + 1             # canvas coordinates
    x0i = x0.clamp(-1, w - 1).long() + 1
    dt = x.dtype

    def corner(dy, dx):
        idx = (y0i + dy) * (w + 2) + (x0i + dx)
        idx = idx.reshape(n * dg, -1, 1).expand(-1, -1, cg)
        return torch.gather(flat, 1, idx).reshape(*sy.shape, cg)

    sampled = (corner(0, 0) * ((1 - wy) * (1 - wx))[..., None].to(dt)
               + corner(0, 1) * ((1 - wy) * wx)[..., None].to(dt)
               + corner(1, 0) * (wy * (1 - wx))[..., None].to(dt)
               + corner(1, 1) * (wy * wx)[..., None].to(dt))
    valid = (y0 >= -1) & (y0 <= h - 1) & (x0 >= -1) & (x0 <= w - 1)
    sampled = torch.where(valid[..., None], sampled,
                          torch.zeros((), dtype=dt, device=x.device))
    return _contract(sampled, mask, weight, bias, n, h, w, dg)


class ModulatedDCNPack(nn.Module):
    """DCNv2 whose offsets and mask come from a separate feature
    (edvr_net.py:15-58): ``conv_offset`` (zero-initialised) gives
    dg*3*9 channels, split into o1 | o2 | mask. ``weight`` (OIHW) and
    ``bias`` are the deformable convolution's own, under their torch
    names."""

    def __init__(self, in_channels: int, out_channels: int,
                 deform_groups: int = 8):
        super().__init__()
        self.deform_groups = deform_groups
        self.conv_offset = Conv2d(in_channels, deform_groups * 3 * _TAPS, 3)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    @torch.no_grad()
    def seeded_init(self, generator: torch.Generator):
        """The JAX package's init: weight uniform(+-1/sqrt(fan_in)), bias
        and the offset conv zero (mmedit's init_offset)."""
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        self.weight.copy_((torch.rand(self.weight.shape,
                                      generator=generator) * 2 - 1) * bound)
        self.bias.zero_()
        self.conv_offset.weight.zero_()
        self.conv_offset.bias.zero_()

    def forward(self, x, extra_feat):
        o1, o2, mask = torch.chunk(self.conv_offset(extra_feat), 3, dim=-1)
        offset = torch.cat([o1, o2], -1)
        return modulated_deform_conv(x, offset, torch.sigmoid(mask),
                                     self.weight, self.bias,
                                     self.deform_groups)


class ConvModule(nn.Module):
    """mmcv ConvModule: conv (key ``<name>.conv``) + optional
    LeakyReLU(0.1)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, act: bool = True):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel_size, stride)
        self.act = act

    def forward(self, x):
        x = self.conv(x)
        return lrelu(x, 0.1) if self.act else x


def _up2x(x):
    return resize(x, scale_factor=2, mode="bilinear", align_corners=False)


class PCDAlignment(nn.Module):
    """3-level pyramid cascading deformable alignment (edvr_net.py:61-187)."""

    def __init__(self, mid_channels: int = 64, deform_groups: int = 8):
        super().__init__()
        mid = mid_channels
        self.offset_conv1 = nn.ModuleDict()
        self.offset_conv2 = nn.ModuleDict()
        self.offset_conv3 = nn.ModuleDict()
        self.dcn_pack = nn.ModuleDict()
        self.feat_conv = nn.ModuleDict()
        for i in (3, 2, 1):
            lv = f"l{i}"
            self.offset_conv1[lv] = ConvModule(2 * mid, mid)
            if i == 3:
                self.offset_conv2[lv] = ConvModule(mid, mid)
            else:
                self.offset_conv2[lv] = ConvModule(2 * mid, mid)
                self.offset_conv3[lv] = ConvModule(mid, mid)
                self.feat_conv[lv] = ConvModule(2 * mid, mid, act=(i == 2))
            self.dcn_pack[lv] = ModulatedDCNPack(mid, mid, deform_groups)
        self.cas_offset_conv1 = ConvModule(2 * mid, mid)
        self.cas_offset_conv2 = ConvModule(mid, mid)
        self.cas_dcnpack = ModulatedDCNPack(mid, mid, deform_groups)

    def forward(self, neighbor_feats, ref_feats):
        """neighbor/ref feats: [L1 (N, H, W, C), L2 (N, H/2, ...), L3
        (N, H/4, ...)]."""
        up_offset = up_feat = feat = None
        for i in (3, 2, 1):
            lv = f"l{i}"
            offset = self.offset_conv1[lv](
                torch.cat([neighbor_feats[i - 1], ref_feats[i - 1]], -1))
            if i == 3:
                offset = self.offset_conv2[lv](offset)
            else:
                offset = self.offset_conv3[lv](self.offset_conv2[lv](
                    torch.cat([offset, up_offset], -1)))
            feat = self.dcn_pack[lv](neighbor_feats[i - 1], offset)
            if i == 3:
                feat = lrelu(feat, 0.1)
            else:
                feat = self.feat_conv[lv](torch.cat([feat, up_feat], -1))
            if i > 1:
                up_offset = _up2x(offset) * 2.0
                up_feat = _up2x(feat)
        offset = self.cas_offset_conv2(self.cas_offset_conv1(
            torch.cat([feat, ref_feats[0]], -1)))
        return lrelu(self.cas_dcnpack(feat, offset), 0.1)


def _pool3(x, op):
    """3x3/stride-2/pad-1 pooling of NHWC: max pads with -inf, avg counts
    the padded zeros (torch's defaults, as the reference's modules)."""
    y = _nchw(x)
    if op == "max":
        y = F.max_pool2d(y, 3, 2, 1)
    else:
        y = F.avg_pool2d(y, 3, 2, 1, count_include_pad=True)
    return _nhwc(y, x.shape[:-3])


class TSAFusion(nn.Module):
    """Temporal-spatial attention fusion (edvr_net.py:190-296)."""

    def __init__(self, mid_channels: int = 64, num_frames: int = 5,
                 center_frame_idx: int = 2):
        super().__init__()
        c = mid_channels
        self.center_frame_idx = center_frame_idx
        self.temporal_attn1 = Conv2d(c, c, 3)
        self.temporal_attn2 = Conv2d(c, c, 3)
        self.feat_fusion = ConvModule(num_frames * c, c, 1)
        self.spatial_attn1 = ConvModule(num_frames * c, c, 1)
        self.spatial_attn2 = ConvModule(2 * c, c, 1)
        self.spatial_attn_l1 = ConvModule(c, c, 1)
        self.spatial_attn_l2 = ConvModule(2 * c, c, 3)
        self.spatial_attn_l3 = ConvModule(c, c, 3)
        self.spatial_attn3 = ConvModule(c, c, 3)
        self.spatial_attn4 = ConvModule(c, c, 1)
        self.spatial_attn5 = Conv2d(c, c, 3)
        self.spatial_attn_add1 = ConvModule(c, c, 1)
        self.spatial_attn_add2 = Conv2d(c, c, 1)

    def forward(self, aligned_feat):
        """aligned_feat (N, T, H, W, C) -> (N, H, W, C)."""
        n, t, h, w, c = aligned_feat.shape
        emb_ref = self.temporal_attn1(aligned_feat[:, self.center_frame_idx])
        emb = self.temporal_attn2(aligned_feat.reshape(n * t, h, w, c)
                                  ).reshape(n, t, h, w, c)
        corr = torch.sum(emb * emb_ref[:, None], -1, keepdim=True)
        feat_w = (aligned_feat * torch.sigmoid(corr)).permute(
            0, 2, 3, 1, 4).reshape(n, h, w, t * c)
        feat = self.feat_fusion(feat_w)

        attn = self.spatial_attn1(feat_w)
        attn = self.spatial_attn2(torch.cat([_pool3(attn, "max"),
                                             _pool3(attn, "avg")], -1))
        level = self.spatial_attn_l1(attn)
        level = self.spatial_attn_l2(torch.cat([_pool3(level, "max"),
                                                _pool3(level, "avg")], -1))
        level = _up2x(self.spatial_attn_l3(level))
        attn = self.spatial_attn3(attn) + level
        attn = _up2x(self.spatial_attn4(attn))
        attn = self.spatial_attn5(attn)
        attn_add = self.spatial_attn_add2(self.spatial_attn_add1(attn))
        return feat * torch.sigmoid(attn) * 2.0 + attn_add


class EDVRFeatureExtractor(nn.Module):
    """EDVR-M trunk, the keyframe feature extractor (RefVSR_IR.py:424-546)."""

    def __init__(self, mid_channels: int = 64, num_frames: int = 5,
                 deform_groups: int = 8, num_blocks_extraction: int = 5,
                 center_frame_idx: int = 2):
        super().__init__()
        mid = mid_channels
        self.center_frame_idx = center_frame_idx
        self.conv_first = Conv2d(3, mid, 3)
        self.feature_extraction = nn.Sequential(
            *(ResidualBlockNoBN(mid) for _ in range(num_blocks_extraction)))
        self.feat_l2_conv1 = ConvModule(mid, mid, 3, stride=2)
        self.feat_l2_conv2 = ConvModule(mid, mid, 3)
        self.feat_l3_conv1 = ConvModule(mid, mid, 3, stride=2)
        self.feat_l3_conv2 = ConvModule(mid, mid, 3)
        self.pcd_alignment = PCDAlignment(mid, deform_groups)
        self.fusion = TSAFusion(mid, num_frames, center_frame_idx)

    def forward(self, x):
        """x (N, T, H, W, 3) -> (N, H, W, mid); H and W multiples of 4."""
        n, t, h, w, c = x.shape
        l1 = self.feature_extraction(
            lrelu(self.conv_first(x.reshape(n * t, h, w, c)), 0.1))
        l2 = self.feat_l2_conv2(self.feat_l2_conv1(l1))
        l3 = self.feat_l3_conv2(self.feat_l3_conv1(l2))
        l1 = l1.reshape(n, t, h, w, -1)
        l2 = l2.reshape(n, t, h // 2, w // 2, -1)
        l3 = l3.reshape(n, t, h // 4, w // 4, -1)
        ci = self.center_frame_idx
        ref = [l1[:, ci], l2[:, ci], l3[:, ci]]
        aligned = [self.pcd_alignment([l1[:, i], l2[:, i], l3[:, i]], ref)
                   for i in range(t)]
        return self.fusion(torch.stack(aligned, 1))
