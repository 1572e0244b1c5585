"""Plain PyTorch reference of the RefVSR-IR network ("Ours-IR"), for the
benchmark's comparison.

A functional transcription of codeslake/RefVSR ``models/archs/RefVSR_IR.py``
(``Network.forward``: the EDVR windows and their padding, :172-215; the
sliding keyframes, :255-264; both branches with the stale flow, :283-347)
and ``models/archs/edvr_net.py`` (``ModulatedDCNPack``, ``PCDAlignment``,
``TSAFusion``, the EDVR-M extractor), in NCHW float32, reading weights from
a state dict under the reference's torch key names. mmcv's
``modulated_deform_conv2d`` is written out here as its CUDA im2col reads
it (``modulated_deform_conv``). The parts RefVSR-IR shares with RefVSR
(SPyNet, the matching, the aligned attention, RAP, ``compute_up``,
``Quant``) come from ``benchmark/reference/refvsr.py``. It imports nothing
of the program under test. Departures that leave the arithmetic alone:

- the matching's similarity matrix is reduced in blocks of LR patches
  (``refvsr.feature_match``);
- a window can stop after its forward step 0 (``Stream.advance``), which
  carries the recurrent state on without computing the window's output;
- every window computes its flows afresh, where the source and the program
  keep the previous window's;
- EDVR runs once for each keyframe, on a batch of one;
- every convolution, the matching product and the deformable
  convolution's contraction can round their operands to a lower precision,
  and the SR frame and the carried state be stored in it (``Quant``): the
  benchmark's control, never its reference.

The stale flow (the source's ``flow`` left by the backward loop, read by
the forward branch's UP and confidence warps at i > 0) is
``backward_flows[:, 0]``, as the repository's JAX package reads
RefVSR_IR.py:325-327. Callers turn TF32 off
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import refvsr as base

EDVR = "edvr"
EDVR_FRAMES = 5     # EDVR-M's neighbourhood; its centre is frame 2
TAPS = 9


# --------------------------------------------------- modulated deformable conv

def modulated_deform_conv(P, key, x, offset, mask):
    """mmcv ``modulated_deform_conv2d`` with the weight ``key.weight`` (O,
    C, 3, 3) and ``key.bias``: 3x3, stride 1, pad 1, dilation 1. x (N, C, H,
    W); offset (N, 2*dg*9, H, W), read as (group, tap, {dy, dx}); mask (N,
    dg*9, H, W), sigmoided, read as (group, tap). Tap (i, j) of output pixel
    (y, x) in group g samples channels g*C/dg .. (g+1)*C/dg - 1 at (y + i -
    1 + dy, x + j - 1 + dx) bilinearly; ``modulated_deformable_im2col``
    gives zero for a position outside (-1, H) x (-1, W), and
    ``dmcn_im2col_bilinear`` reads zero at each corner outside the image.
    The columns (N, C*9, H*W), each times its mask, meet the weight in one
    product."""
    n, c, h, w = x.shape
    weight = P.sd[f"{key}.weight"]
    o = weight.shape[0]
    dg = mask.shape[1] // TAPS
    cg = c // dg
    dev = x.device
    xg = x.reshape(n * dg, cg, h * w)
    ys = torch.arange(h, device=dev, dtype=torch.float32).view(1, 1, h, 1)
    xs = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, 1, w)
    off = offset.reshape(n, dg, TAPS, 2, h, w)
    m = mask.reshape(n, dg, TAPS, h, w)
    cols = []
    for t in range(TAPS):
        i, j = divmod(t, 3)
        py = ys + (i - 1) + off[:, :, t, 0]             # (N, dg, H, W)
        px = xs + (j - 1) + off[:, :, t, 1]
        inside = (py > -1) & (px > -1) & (py < h) & (px < w)
        y0, x0 = torch.floor(py), torch.floor(px)
        ly, lx = py - y0, px - x0
        val = torch.zeros(n, dg, cg, h, w, device=dev)
        for cy, cx, wt in ((y0, x0, (1 - ly) * (1 - lx)),
                           (y0, x0 + 1, (1 - ly) * lx),
                           (y0 + 1, x0, ly * (1 - lx)),
                           (y0 + 1, x0 + 1, ly * lx)):
            ok = (cy >= 0) & (cy <= h - 1) & (cx >= 0) & (cx <= w - 1)
            idx = (cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)).long()
            v = xg.gather(2, idx.reshape(n * dg, 1, h * w).expand(-1, cg, -1))
            val += v.reshape(n, dg, cg, h, w) * (wt * ok)[:, :, None]
        val *= (inside * m[:, :, t])[:, :, None]
        cols.append(val.reshape(n, c, h * w))
    col = torch.stack(cols, 2).reshape(n, c * TAPS, h * w)
    out = torch.matmul(P.q(weight.reshape(o, c * TAPS)), P.q(col))
    return out.reshape(n, o, h, w) + P.sd[f"{key}.bias"].view(1, o, 1, 1)


def dcn_pack(P, key, x, extra):
    """ModulatedDCNPack: its offset conv on `extra` gives o1 | o2 | mask;
    the offsets are o1 and o2 concatenated, the mask sigmoided."""
    o1, o2, mask = torch.chunk(P.conv(f"{key}.conv_offset", extra,
                                      padding=1), 3, dim=1)
    return modulated_deform_conv(P, key, x, torch.cat([o1, o2], 1),
                                 torch.sigmoid(mask))


# ---------------------------------------------------------------------- EDVR

def lrelu1(x):
    return F.leaky_relu(x, 0.1)


def conv_module(P, key, x, stride=1, act=True):
    """mmcv ConvModule: ``key.conv`` (padding k // 2) and LeakyReLU(0.1)."""
    k = P.sd[f"{key}.conv.weight"].shape[-1]
    y = P.conv(f"{key}.conv", x, stride=stride, padding=k // 2)
    return lrelu1(y) if act else y


def up2x(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


def pcd_align(P, nbr, ref):
    """PCDAlignment (edvr_net.py:61-187): nbr and ref are [L1, L2, L3]."""
    pre = f"{EDVR}.pcd_alignment"
    up_offset = up_feat = feat = None
    for lv in (3, 2, 1):
        offset = conv_module(P, f"{pre}.offset_conv1.l{lv}",
                             torch.cat([nbr[lv - 1], ref[lv - 1]], 1))
        if lv == 3:
            offset = conv_module(P, f"{pre}.offset_conv2.l{lv}", offset)
        else:
            offset = conv_module(P, f"{pre}.offset_conv2.l{lv}",
                                 torch.cat([offset, up_offset], 1))
            offset = conv_module(P, f"{pre}.offset_conv3.l{lv}", offset)
        feat = dcn_pack(P, f"{pre}.dcn_pack.l{lv}", nbr[lv - 1], offset)
        if lv == 3:
            feat = lrelu1(feat)
        else:
            feat = conv_module(P, f"{pre}.feat_conv.l{lv}",
                               torch.cat([feat, up_feat], 1), act=(lv == 2))
        if lv > 1:
            up_offset = up2x(offset) * 2
            up_feat = up2x(feat)
    offset = conv_module(P, f"{pre}.cas_offset_conv2", conv_module(
        P, f"{pre}.cas_offset_conv1", torch.cat([feat, ref[0]], 1)))
    return lrelu1(dcn_pack(P, f"{pre}.cas_dcnpack", feat, offset))


def tsa_fusion(P, aligned):
    """TSAFusion (edvr_net.py:190-296): aligned (N, T, C, H, W)."""
    pre = f"{EDVR}.fusion"
    n, t, c, h, w = aligned.shape
    emb_ref = P.conv(f"{pre}.temporal_attn1", aligned[:, t // 2], padding=1)
    emb = P.conv(f"{pre}.temporal_attn2", aligned.reshape(-1, c, h, w),
                 padding=1).view(n, t, c, h, w)
    corr = torch.stack([torch.sum(emb[:, i] * emb_ref, 1)
                        for i in range(t)], 1)               # (N, T, H, W)
    feat_w = (aligned * torch.sigmoid(corr)[:, :, None]).view(n, -1, h, w)
    feat = conv_module(P, f"{pre}.feat_fusion", feat_w)

    def pools(a):
        return torch.cat([F.max_pool2d(a, 3, 2, 1),
                          F.avg_pool2d(a, 3, 2, 1)], 1)
    attn = conv_module(P, f"{pre}.spatial_attn1", feat_w)
    attn = conv_module(P, f"{pre}.spatial_attn2", pools(attn))
    level = conv_module(P, f"{pre}.spatial_attn_l1", attn)
    level = conv_module(P, f"{pre}.spatial_attn_l2", pools(level))
    level = up2x(conv_module(P, f"{pre}.spatial_attn_l3", level))
    attn = conv_module(P, f"{pre}.spatial_attn3", attn) + level
    attn = up2x(conv_module(P, f"{pre}.spatial_attn4", attn))
    attn = P.conv(f"{pre}.spatial_attn5", attn, padding=1)
    attn_add = P.conv(f"{pre}.spatial_attn_add2",
                      conv_module(P, f"{pre}.spatial_attn_add1", attn))
    return feat * torch.sigmoid(attn) * 2 + attn_add


def edvr(P, x):
    """The EDVR-M extractor (RefVSR_IR.py:424-546): x (N, 5, 3, H, W), H and
    W multiples of 4 -> (N, 64, H, W), aligned onto the centre frame."""
    n, t, _, h, w = x.shape
    l1 = lrelu1(P.conv(f"{EDVR}.conv_first", x.reshape(-1, 3, h, w),
                       padding=1))
    i = 0
    while f"{EDVR}.feature_extraction.{i}.conv1.weight" in P.sd:
        key = f"{EDVR}.feature_extraction.{i}"
        l1 = l1 + P.conv(f"{key}.conv2", F.relu(
            P.conv(f"{key}.conv1", l1, padding=1)), padding=1)
        i += 1
    l2 = conv_module(P, f"{EDVR}.feat_l2_conv2",
                     conv_module(P, f"{EDVR}.feat_l2_conv1", l1, stride=2))
    l3 = conv_module(P, f"{EDVR}.feat_l3_conv2",
                     conv_module(P, f"{EDVR}.feat_l3_conv1", l2, stride=2))
    levels = [f.view(n, t, *f.shape[1:]) for f in (l1, l2, l3)]
    ref = [f[:, t // 2] for f in levels]
    aligned = [pcd_align(P, [f[:, i] for f in levels], ref)
               for i in range(t)]
    return tsa_fusion(P, torch.stack(aligned, 1))


def refill_features(P, lrs, key):
    """EDVR's features of frame `key` of lrs (N, T, 3, h, w): its 5-frame
    neighbourhood in the window mirror-padded by frames [4, 3] before and
    [-4, -5] after (RefVSR_IR.py:194-215), each frame reflect-padded at
    the bottom and right to multiples of 4 and the result cropped back."""
    n, t, c, h, w = lrs.shape
    seq = torch.cat([lrs[:, [4, 3]], lrs, lrs[:, [-4, -5]]], 1)
    x = seq[:, key:key + EDVR_FRAMES].reshape(-1, c, h, w)
    ph, pw = (4 - h % 4) % 4, (4 - w % 4) % 4
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), mode="reflect")
    feat = edvr(P, x.view(n, EDVR_FRAMES, c, h + ph, w + pw))
    return feat[:, :, :h, :w]


def keyframes(t: int, stride: int, prev_first):
    """The window's keyframes (RefVSR_IR.py:255-264): every `stride`-th
    frame from the first keyframe, and the last frame. The first keyframe
    is 0 in a first window and one before the previous window's (wrapping
    by `stride`) in a streamed one."""
    first = 0 if prev_first is None else (prev_first - 1) % stride
    keys = list(range(first, t, stride))
    if keys[-1] != t - 1:
        keys.append(t - 1)
    return keys


# ------------------------------------------------------------------- stream

class Stream:
    """The reference's recurrent state across windows: the features saved
    at forward step 0, the flow from frame 0 to frame 1 that carries them
    into the next window, and the first keyframe.

    ``window(lrs, refs, first)`` is ``Network.forward`` at inference: the
    SR frame of the window's centre, (N, 3, s*h, s*w) clamped to [0, 1].
    ``advance(lrs, refs, first)`` stops after forward step 0: the same
    state afterwards, no output. A first window (a clip's first, or a
    re-anchor) starts from zeros and its keyframes from frame 0. lrs/refs:
    (N, T, 3, h, w) float32."""

    def __init__(self, net: base.Net, keyframe_stride: int,
                 fix_stale_flow_bug: bool = False):
        self.P = net
        self.stride = keyframe_stride
        self.fix = fix_stale_flow_bug
        self.feat_prop = self.feat_prop_up = self.conf_prop = None
        self.flow = self.kf_first = None

    def _step(self, branch, lr, ref, conf, index, feat, feat_up, conf_prop,
              refill, bw_out=None):
        """Refill, the branch's residual blocks and RAP on warped state."""
        P = self.P
        if refill is not None:
            feat = P.conv(f"{branch}_fusion", torch.cat([feat, refill], 1),
                          padding=1)
        inp = [lr, feat] if bw_out is None else [lr, bw_out, feat]
        agg = base.resblocks_with_input_conv(P, f"{branch}_resblocks",
                                             torch.cat(inp, 1))
        ref_feat, ref_feat_down = base.encode(P, ref)
        return base.rap(P, lr, ref, conf, conf_prop, index, agg, feat_up,
                        ref_feat_down, ref_feat)

    @torch.no_grad()
    def _run(self, lrs, refs, first: bool, output: bool):
        P = self.P
        n, t, _, h, w = lrs.shape
        c = t // 2
        flow_fwd, flow_bwd, match = base.Stream(P)._lazy(lrs, refs)
        keys = keyframes(t, self.stride, None if first else self.kf_first)
        self.kf_first = keys[0]
        refill = {k: refill_features(P, lrs, k) for k in keys}

        # backward branch over frames t-1 .. 0
        feat = lrs.new_zeros(n, P.mid, h, w)
        feat_up = lrs.new_zeros(n, P.mid, 2 * h, 2 * w)
        conf_prop = lrs.new_zeros(n, 1, h, w)
        bw_out = [None] * t
        for i in range(t - 1, -1, -1):
            if i < t - 1:
                flow = flow_bwd(i)
                feat = base.warp(feat, flow)
                conf_prop = base.warp(conf_prop, flow)
                feat_up = base.warp(feat_up, base.flow_up2x(flow))
            conf, index = match(i)
            feat, feat_up, conf_prop = self._step(
                "backward", lrs[:, i], refs[:, i], conf, index, feat,
                feat_up, conf_prop, refill.get(i))
            bw_out[i] = feat
            if i == c:
                bw_up, bw_conf = feat_up, conf_prop

        # forward step 0 warps the saved state by its saved flow (the saved
        # UP tensor, not the low-res features); a first window starts from
        # zeros
        if first:
            feat = lrs.new_zeros(n, P.mid, h, w)
            feat_up = lrs.new_zeros(n, P.mid, 2 * h, 2 * w)
            conf_prop = lrs.new_zeros(n, 1, h, w)
        else:
            feat = base.warp(self.feat_prop, self.flow)
            feat_up = base.warp(self.feat_prop_up, base.flow_up2x(self.flow))
            conf_prop = base.warp(self.conf_prop, self.flow)
        conf, index = match(0)
        feat, feat_up, conf_prop = self._step(
            "forward", lrs[:, 0], refs[:, 0], conf, index, feat, feat_up,
            conf_prop, refill.get(0), bw_out[0])
        q = P.q
        self.feat_prop, self.feat_prop_up = q(feat), q(feat_up)
        self.conf_prop, self.flow = q(conf_prop), q(flow_fwd(0))
        if not output:
            return None

        # forward steps 1 .. t//2: the features warp by the forward flow;
        # UP (from the warped low-res features) and the confidence by the
        # stale flow
        stale = flow_bwd(0)
        for i in range(1, c + 1):
            flow = flow_fwd(i - 1)
            up_flow = flow if self.fix else stale
            feat = base.warp(feat, flow)
            feat_up = base.warp(feat, base.flow_up2x(up_flow))
            conf_prop = base.warp(conf_prop, up_flow)
            conf, index = match(i)
            feat, feat_up, conf_prop = self._step(
                "forward", lrs[:, i], refs[:, i], conf, index, feat, feat_up,
                conf_prop, refill.get(i), bw_out[i])
        out = base.compute_up(P, bw_up, feat_up, bw_conf, conf_prop,
                              base.bicubic(lrs[:, c], P.scale))
        return q(out.clamp(0, 1))

    def advance(self, lrs, refs, first: bool):
        self._run(lrs, refs, first, output=False)

    def window(self, lrs, refs, first: bool):
        return self._run(lrs, refs, first, output=True)

    def state(self) -> dict:
        """The carried features the next window starts from, NCHW."""
        return {"feat_prop": self.feat_prop,
                "feat_prop_up": self.feat_prop_up}
