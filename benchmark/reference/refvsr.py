"""Plain PyTorch reference of the RefVSR network, for the benchmark's
comparison.

A functional transcription of codeslake/RefVSR ``models/archs/RefVSR.py``
(``Network.forward``) and its submodules (``attention.py``,
``alignment.py``, ``common.py``, SPyNet and ``models/utils.py``'s warp), in
NCHW, reading weights from a state dict under the reference's torch key
names. It imports nothing of the program under test: it is a frozen copy of
the repository's test oracle, made device-aware, with three changes that
leave its arithmetic alone:

- the matching's similarity matrix is reduced in blocks of LR patches, so
  that a 1080p frame's 32,400 x 129,600 matrix never exists whole;
- a window can run its forward branch alone (``Stream.advance``), which
  carries the recurrent state on without computing the window's output;
- every convolution and the matching product can round their operands to a
  lower precision first, and the SR frame and the carried state be stored
  in it (``Quant``): TF32, or fp8 e4m3 with one scale per tensor. That is
  the benchmark's control, never its reference.

Everything runs in float32; callers turn TF32 off
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

VGG_MEAN = (0.485, 0.456, 0.406)
VGG_STD = (0.229, 0.224, 0.225)
# LR patches per block of the matching's similarity matrix: at most this
# many f32 similarities exist at once
SIM_BLOCK_ELEMS = 1 << 28


class Quant:
    """Rounds a tensor to the computing precision: ``"f32"`` leaves it,
    ``"tf32"`` keeps 10 mantissa bits (round to nearest even), ``"fp8"``
    scales the tensor so that its largest magnitude is e4m3's largest
    (448) and rounds it to e4m3. Applied to every convolution's and the
    matching product's operands, and to what a window keeps: its SR frame
    and the carried state."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "f32":
            return x
        if self.mode == "tf32":
            b = x.contiguous().view(torch.int32)
            b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
            return b.view(torch.float32)
        amax = x.abs().max().clamp_min(1e-30)
        s = amax / 448.0
        return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Net:
    """The weights (f32, NCHW convolutions) and the architecture's sizes."""

    def __init__(self, sd: dict, num_blocks: int, mid_channels: int,
                 scale: int = 4, flag_HD_in: bool = False,
                 matching_ksize: int = 2, quant: Quant | None = None):
        self.sd = {k: v.float() for k, v in sd.items()}
        self.num_blocks, self.mid = num_blocks, mid_channels
        self.scale, self.flag_HD_in = scale, flag_HD_in
        self.ksize = matching_ksize
        self.q = quant or Quant()
        dev = next(iter(self.sd.values())).device
        self.mean = torch.tensor(VGG_MEAN, device=dev).view(1, 3, 1, 1)
        self.std = torch.tensor(VGG_STD, device=dev).view(1, 3, 1, 1)

    def conv(self, key, x, stride=1, padding=0):
        return F.conv2d(self.q(x), self.q(self.sd[f"{key}.weight"]),
                        self.sd[f"{key}.bias"], stride=stride,
                        padding=padding)


# ---------------------------------------------------------------- primitives

def lrelu2(x):
    return F.leaky_relu(x, 0.2)


def basic_seq(P, prefix, x, n_blocks, ch_ks=3, strides=None):
    """nn.Sequential of BasicBlock(conv, LeakyReLU(0.2))."""
    for i in range(n_blocks):
        s = strides[i] if strides else 1
        x = lrelu2(P.conv(f"{prefix}.{i}.0", x, stride=s,
                          padding=ch_ks // 2))
    return x


def res_list(P, prefix, x, n_blocks):
    """common.py ResList: ResBlocks (conv-lrelu0.2-conv + skip), conv_tail
    and the outer skip."""
    x1 = x
    for i in range(n_blocks):
        r = P.conv(f"{prefix}.RBs.{i}.conv2",
                   lrelu2(P.conv(f"{prefix}.RBs.{i}.conv1", x, padding=1)),
                   padding=1)
        x = x + r
    return P.conv(f"{prefix}.conv_tail", x, padding=1) + x1


def resblocks_with_input_conv(P, prefix, x):
    """ResidualBlocksWithInputConv: input conv + lrelu(0.1) + the mmedit
    ResidualBlockNoBN chain (conv-ReLU-conv + skip)."""
    x = F.leaky_relu(P.conv(f"{prefix}.main.0", x, padding=1), 0.1)
    for i in range(P.num_blocks):
        r = P.conv(f"{prefix}.main.2.{i}.conv2",
                   F.relu(P.conv(f"{prefix}.main.2.{i}.conv1", x,
                                 padding=1)),
                   padding=1)
        x = x + r
    return x


def pixel_shuffle_pack(P, prefix, x):
    return F.pixel_shuffle(P.conv(f"{prefix}.upsample_conv", x, padding=1),
                           2)


def bicubic(x, scale):
    return F.interpolate(x, scale_factor=scale, mode="bicubic",
                         align_corners=False).clamp(0, 1)


def warp(x, flow):
    """models/utils.py warp: grid over the FLOW's size, displacement
    normalised by the INPUT's size, zeros padding, align_corners=False."""
    n, _, fh, fw = flow.shape
    dev = flow.device
    gx = torch.linspace(-1.0, 1.0, fw, device=dev).view(1, 1, 1, fw).expand(
        n, 1, fh, fw)
    gy = torch.linspace(-1.0, 1.0, fh, device=dev).view(1, 1, fh, 1).expand(
        n, 1, fh, fw)
    nx = flow[:, 0:1] / ((x.size(3) - 1.0) / 2.0)
    ny = flow[:, 1:2] / ((x.size(2) - 1.0) / 2.0)
    grid = torch.cat([gx + nx, gy + ny], 1).permute(0, 2, 3, 1)
    return F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)


def flow_up2x(flow):
    return F.interpolate(flow, scale_factor=2, mode="bilinear",
                         align_corners=True) * 2.0


def extract_patches_same(x, kernel, stride):
    """extract_image_patches with 'same' reflection padding -> (N, C*k*k,
    L)."""
    _, _, h, w = x.shape
    out_r, out_c = (h + stride - 1) // stride, (w + stride - 1) // stride
    pr = max(0, (out_r - 1) * stride + kernel - h)
    pc = max(0, (out_c - 1) * stride + kernel - w)
    x = F.pad(x, (pc // 2, pc - pc // 2, pr // 2, pr - pr // 2),
              mode="reflect")
    return F.unfold(x, kernel, stride=stride)


def gather_l(unfolded, index):
    idx = index.view(index.size(0), 1, -1).expand(-1, unfolded.size(1), -1)
    return torch.gather(unfolded, 2, idx.long())


# ------------------------------------------------------------------- SPyNet

def spynet(P, ref, supp):
    """SPyNet.py: flow (N, 2, H, W) of supp towards ref."""
    n, _, h, w = ref.shape
    dev = ref.device
    w_up = w if w % 32 == 0 else 32 * (w // 32 + 1)
    h_up = h if h % 32 == 0 else 32 * (h // 32 + 1)
    ref_r = F.interpolate(ref, size=(h_up, w_up), mode="bilinear",
                          align_corners=False)
    supp_r = F.interpolate(supp, size=(h_up, w_up), mode="bilinear",
                           align_corners=False)
    refs = [(ref_r - P.mean) / P.std]
    supps = [(supp_r - P.mean) / P.std]
    for _ in range(5):
        refs.append(F.avg_pool2d(refs[-1], 2, 2, count_include_pad=False))
        supps.append(F.avg_pool2d(supps[-1], 2, 2, count_include_pad=False))
    refs, supps = refs[::-1], supps[::-1]

    def flow_warp(x, flow):
        _, _, fh, fw = x.shape
        gy, gx = torch.meshgrid(torch.arange(fh, device=dev),
                                torch.arange(fw, device=dev), indexing="ij")
        grid = torch.stack((gx, gy), 2).float()[None] + flow.permute(
            0, 2, 3, 1)
        gxn = 2.0 * grid[..., 0] / max(fw - 1, 1) - 1.0
        gyn = 2.0 * grid[..., 1] / max(fh - 1, 1) - 1.0
        return F.grid_sample(x, torch.stack((gxn, gyn), 3), mode="bilinear",
                             padding_mode="border", align_corners=True)

    flow = torch.zeros(n, 2, h_up // 32, w_up // 32, device=dev)
    for level in range(6):
        flow_up = flow if level == 0 else F.interpolate(
            flow, scale_factor=2, mode="bilinear", align_corners=True) * 2.0
        x = torch.cat([refs[level], flow_warp(supps[level], flow_up),
                       flow_up], 1)
        for j in range(5):
            x = P.conv(f"FlowNet.basic_module.{level}.basic_module.{j}.conv",
                       x, padding=3)
            if j < 4:
                x = F.relu(x)
        flow = flow_up + x
    flow = F.interpolate(flow, size=(h, w), mode="bilinear",
                         align_corners=False)
    return torch.cat([flow[:, 0:1] * (w / w_up), flow[:, 1:2] * (h / h_up)],
                     1)


# ---------------------------------------------------------- FeatureMatching

def feature_match(P, lr, ref):
    """attention.py FeatureMatching: (conf (N, 1, h, w), index (N, L))."""
    h = lr.size(2)
    lr = (lr - P.mean) / P.std
    ref = (ref - P.mean) / P.std
    vgg_range = 7 if (P.flag_HD_in or P.scale == 2) else 4
    if P.flag_HD_in:
        f = 1.0 / (P.scale // 2)
        lr = F.interpolate(lr, scale_factor=f, mode="nearest")
        ref = F.interpolate(ref, scale_factor=f, mode="nearest")

    def feat(x):
        x = F.relu(P.conv("feature_match.feature_extract.0", x, padding=1))
        x = F.relu(P.conv("feature_match.feature_extract.2", x, padding=1))
        if vgg_range == 7:
            x = F.max_pool2d(x, 2, 2)
            x = F.relu(P.conv("feature_match.feature_extract.5", x,
                              padding=1))
            mkey = "feature_match.feature_extract.map128.0"
        else:
            mkey = "feature_match.feature_extract.map64.0"
        return lrelu2(P.conv(mkey, x))

    lr_f = feat(lr)
    lr_p = P.q(F.normalize(extract_patches_same(lr_f, 3, 1), dim=1))
    ref_f = feat(F.avg_pool2d(ref, 2, 2))
    ref_p = P.q(F.normalize(extract_patches_same(ref_f, 3, 1).permute(
        0, 2, 1), dim=2))
    n, l_ref = ref_p.shape[:2]
    l_lr = lr_p.shape[2]
    block = max(1, SIM_BLOCK_ELEMS // max(n * l_ref, 1))
    conf = torch.empty(n, l_lr, device=lr_p.device)
    idx = torch.empty(n, l_lr, dtype=torch.long, device=lr_p.device)
    for s in range(0, l_lr, block):
        sim = torch.bmm(ref_p, lr_p[:, :, s:s + block])
        conf[:, s:s + block], idx[:, s:s + block] = torch.max(sim, dim=1)
        del sim
    _, _, hc, wc = lr_f.shape
    conf = conf.view(n, 1, hc, wc)
    if h / hc != 1.0:
        conf = F.interpolate(conf, scale_factor=h / hc, mode="bicubic",
                             align_corners=False).clamp(0, 1)
    return conf, idx


# ------------------------------------------------------------ AlignedConv2d

def aligned_conv2d(P, prefix, x, query, ref, ks):
    """alignment.py AlignedConv2d. x: folded warped features (2h', 2w');
    query: the lr image; ref: folded warped ref image; stride == ks."""
    dev = x.device
    query = F.interpolate(query, scale_factor=2, mode="bicubic",
                          align_corners=False)

    def conv1(t):
        t = lrelu2(P.conv(f"{prefix}.conv1.0", t, padding=2))
        r = P.conv(f"{prefix}.conv1.2.conv2",
                   lrelu2(P.conv(f"{prefix}.conv1.2.conv1", t, padding=1)),
                   padding=1)
        return lrelu2(t + r)

    q, r_ = conv1(query), conv1(ref)
    a = lrelu2(P.conv(f"{prefix}.p_conv.0", torch.cat([r_, q], 1),
                      stride=ks, padding=2))
    rb = P.conv(f"{prefix}.p_conv.2.conv2",
                lrelu2(P.conv(f"{prefix}.p_conv.2.conv1", a, padding=1)),
                padding=1)
    a = lrelu2(a + rb)
    affine = P.conv(f"{prefix}.p_conv.4", a) + 1.0
    affine = torch.clamp(affine, -3, 3)

    N = ks * ks
    xpad = F.pad(x, (1, 1, 1, 1), mode="reflect")
    b, _, hh, ww = affine.shape
    half = (ks - 1) // 2
    taps = torch.arange(-half - 0.5, half + 0.6, 1.0, device=dev)
    pn_r, pn_c = torch.meshgrid(taps, taps, indexing="ij")
    pn = torch.stack([pn_r.flatten(), pn_c.flatten()], 1)
    aff = affine.permute(0, 2, 3, 1)
    p = pn.view(1, 1, 1, N, 2).expand(b, hh, ww, N, 2).clone()
    p = p * torch.stack([aff[..., 0], aff[..., 1]], -1)[:, :, :, None, :]
    theta = (aff[..., 2:] - 1.0) * 1.0472
    cs, sn = torch.cos(theta), torch.sin(theta)
    rm = torch.stack([torch.cat([cs, sn], -1),
                      torch.cat([-sn, cs], -1)], -2)
    p = torch.matmul(p, rm)
    g0r = torch.arange(1, hh * ks + 1, ks, device=dev).view(1, hh, 1, 1)
    g0c = torch.arange(1, ww * ks + 1, ks, device=dev).view(1, 1, ww, 1)
    p_row = p[..., 0] + half + 0.5 + g0r
    p_col = p[..., 1] + half + 0.5 + g0c
    del p

    # clamped-corner bilinear gather (alignment.py): corners and the point
    # are clamped independently, so corners clamped onto each other
    # double-count, as in the reference
    hp, wp = xpad.size(2), xpad.size(3)
    lt_r, lt_c = p_row.floor(), p_col.floor()
    rb_r, rb_c = lt_r + 1, lt_c + 1
    lt_r = lt_r.clamp(0, hp - 1).long()
    lt_c = lt_c.clamp(0, wp - 1).long()
    rb_r = rb_r.clamp(0, hp - 1).long()
    rb_c = rb_c.clamp(0, wp - 1).long()
    pr = p_row.clamp(0, hp - 1)
    pc = p_col.clamp(0, wp - 1)
    weights = (((1 + (lt_r - pr)) * (1 + (lt_c - pc)), lt_r, lt_c),
               ((1 - (rb_r - pr)) * (1 - (rb_c - pc)), rb_r, rb_c),
               ((1 + (lt_r - pr)) * (1 - (rb_c - pc)), lt_r, rb_c),
               ((1 - (rb_r - pr)) * (1 + (lt_c - pc)), rb_r, lt_c))
    flat = xpad.reshape(b, xpad.size(1), -1)
    c_ = xpad.size(1)
    al = None
    for g, r, c in weights:
        idx = (r * wp + c).view(b, 1, -1).expand(-1, c_, -1)
        v = flat.gather(2, idx).view(b, c_, hh, ww, N) * g.unsqueeze(1)
        del idx
        al = v if al is None else al.add_(v)
        del v
    rows = [al[..., s:s + ks].reshape(b, c_, hh, ww * ks)
            for s in range(0, N, ks)]
    return torch.cat(rows, -1).reshape(b, c_, hh * ks, ww * ks)


def aligned_attention(P, prefix, lr, ref, index_map, value, scale, align):
    """attention.py AlignedAttention: output spatial size 2x lr's."""
    h, w = lr.size(2), lr.size(3)
    unfolded = extract_patches_same(value, scale, scale)
    feats = F.fold(gather_l(unfolded, index_map), (h * 2, w * 2), scale,
                   padding=0, stride=scale)
    del unfolded
    if not align:
        return feats
    unfolded_ref = extract_patches_same(ref, scale, scale)
    wref = F.fold(gather_l(unfolded_ref, index_map), (h * 2, w * 2), scale,
                  padding=0, stride=scale)
    return aligned_conv2d(P, f"{prefix}.align", feats, lr, wref, scale)


# ------------------------------------------------------------- the network

def rap(P, lr, ref, conf_map, conf_map_prop, index_map, feat_prop,
        feat_prop_up, ref_feat_down, ref_feat):
    """AA_AF_conf_prop (RefVSR.py:122-148)."""
    aa1_scale = P.ksize // 2
    lr_down = bicubic(lr, 0.5)
    ref_al = aligned_attention(P, "aa1", lr_down, ref, index_map,
                               ref_feat_down, aa1_scale, aa1_scale > 1)
    alpha = basic_seq(P, "conf_fusion",
                      torch.cat([conf_map_prop, conf_map], 1), 2)
    fused = basic_seq(P, "feat_fusion", torch.cat([feat_prop, ref_al], 1), 2)
    feat_prop = res_list(P, "feat_decoder", feat_prop + alpha * fused, 8)

    ref_al_up = aligned_attention(P, "aa2", lr, ref, index_map, ref_feat,
                                  P.ksize, True)
    up1 = pixel_shuffle_pack(P, "upsample1", feat_prop)
    feat_prop_up = basic_seq(P, "feat_fusion2_1",
                             torch.cat([feat_prop_up, up1], 1), 1)
    alpha2 = basic_seq(P, "conf_fusion2",
                       torch.cat([bicubic(conf_map_prop, 2),
                                  bicubic(conf_map, 2)], 1), 2)
    fused2 = basic_seq(P, "feat_fusion2",
                       torch.cat([feat_prop_up, ref_al_up], 1), 2)
    feat_prop_up = res_list(P, "feat_decoder2",
                            feat_prop_up + alpha2 * fused2, 4)
    return feat_prop, feat_prop_up, torch.max(conf_map_prop, conf_map)


def compute_up(P, backward_up, forward_up, conf_bw, conf_fw, base):
    """RefVSR.py:103-118."""
    cat = torch.cat([backward_up, forward_up], 1)
    out = P.conv("fusion_UP", cat)
    alpha = basic_seq(P, "conf_fusion_BWFW",
                      torch.cat([bicubic(conf_bw, 2), bicubic(conf_fw, 2)],
                                1), 2)
    out = out + alpha * basic_seq(P, "feat_fusion_BWFW", cat, 2)
    out = res_list(P, "feat_decoder_BWFW", out, 4)
    if P.scale == 4:
        out = F.leaky_relu(pixel_shuffle_pack(P, "upsample2", out), 0.1)
    out = F.leaky_relu(P.conv("conv_hr", out, padding=1), 0.1)
    return P.conv("conv_last", out, padding=1) + base


def encode(P, ref):
    f1 = res_list(P, "res1", basic_seq(P, "ref_encoder1", ref, 2), 4)
    f2 = res_list(P, "res2", basic_seq(P, "ref_encoder2", f1, 2,
                                       strides=[2, 1]), 4)
    return f1, f2


class Stream:
    """The reference's recurrent state across windows (its ``*_prev``
    attributes, RefVSR.py:279-283) and the two ways a window moves it on.

    ``window(lrs, refs, first)`` is ``Network.forward`` at inference: the
    SR frame of the window's centre, (N, 3, s*h, s*w) clamped to [0, 1].
    ``advance(lrs, refs, first)`` runs the forward branch alone: the same
    state afterwards, no output. lrs/refs: (N, T, 3, h, w) float32."""

    def __init__(self, net: Net):
        self.P = net
        self.feat_prop = self.flow = self.feat_prop_up = None
        self.conf_prop = None

    def _forward_branch(self, lrs, refs, first, flow_fwd, match):
        P = self.P
        n, t, _, h, w = lrs.shape
        c = t // 2
        if first:
            feat_prop = lrs.new_zeros(n, P.mid, h, w)
            feat_prop_up = lrs.new_zeros(n, P.mid, 2 * h, 2 * w)
            conf_prop = lrs.new_zeros(n, 1, h, w)
            start = 0
        else:
            start = c
        for i in range(start, c + 1):
            if i > start:
                flow = flow_fwd(i - 1)
                feat_prop = warp(feat_prop, flow)
                # RefVSR.py:254 warps the LOW-res feat_prop with the 2x
                # flow, not feat_prop_up
                feat_prop_up = warp(feat_prop, flow_up2x(flow))
                conf_prop = warp(conf_prop, flow)
            elif not first:
                flow = self.flow
                feat_prop = warp(self.feat_prop, flow)
                feat_prop_up = warp(self.feat_prop_up, flow_up2x(flow))
                conf_prop = warp(self.conf_prop, flow)
            feat_prop = resblocks_with_input_conv(
                P, "forward_resblocks", torch.cat([lrs[:, i], feat_prop], 1))
            ref_feat, ref_feat_down = encode(P, refs[:, i])
            conf, index = match(i)
            feat_prop, feat_prop_up, conf_prop = rap(
                P, lrs[:, i], refs[:, i], conf, conf_prop, index, feat_prop,
                feat_prop_up, ref_feat_down, ref_feat)
            del ref_feat, ref_feat_down
        q = P.q
        self.feat_prop, self.feat_prop_up = q(feat_prop), q(feat_prop_up)
        self.conf_prop, self.flow = q(conf_prop), q(flow_fwd(c))
        return feat_prop_up, conf_prop

    def _lazy(self, lrs, refs):
        P = self.P
        flows, matches = {}, {}

        def flow_fwd(j):
            if ("f", j) not in flows:
                flows[("f", j)] = spynet(P, lrs[:, j + 1], lrs[:, j])
            return flows[("f", j)]

        def flow_bwd(j):
            if ("b", j) not in flows:
                flows[("b", j)] = spynet(P, lrs[:, j], lrs[:, j + 1])
            return flows[("b", j)]

        def match(i):
            if i not in matches:
                matches[i] = feature_match(P, lrs[:, i], refs[:, i])
            return matches[i]
        return flow_fwd, flow_bwd, match

    @torch.no_grad()
    def advance(self, lrs, refs, first: bool):
        flow_fwd, _, match = self._lazy(lrs, refs)
        self._forward_branch(lrs, refs, first, flow_fwd, match)

    @torch.no_grad()
    def window(self, lrs, refs, first: bool):
        P = self.P
        n, t, _, h, w = lrs.shape
        c = t // 2
        flow_fwd, flow_bwd, match = self._lazy(lrs, refs)
        feat_prop = lrs.new_zeros(n, P.mid, h, w)
        feat_prop_up = lrs.new_zeros(n, P.mid, 2 * h, 2 * w)
        conf_prop = lrs.new_zeros(n, 1, h, w)
        for i in range(t - 1, c - 1, -1):
            if i < t - 1:
                flow = flow_bwd(i)
                feat_prop = warp(feat_prop, flow)
                conf_prop = warp(conf_prop, flow)
                feat_prop_up = warp(feat_prop_up, flow_up2x(flow))
            feat_prop = resblocks_with_input_conv(
                P, "backward_resblocks", torch.cat([lrs[:, i], feat_prop],
                                                   1))
            ref_feat, ref_feat_down = encode(P, refs[:, i])
            conf, index = match(i)
            feat_prop, feat_prop_up, conf_prop = rap(
                P, lrs[:, i], refs[:, i], conf, conf_prop, index, feat_prop,
                feat_prop_up, ref_feat_down, ref_feat)
            del ref_feat, ref_feat_down
        backward_up, conf_bw = feat_prop_up, conf_prop
        del feat_prop
        forward_up, conf_fw = self._forward_branch(lrs, refs, first,
                                                   flow_fwd, match)
        base = bicubic(lrs[:, c], P.scale)
        out = compute_up(P, backward_up, forward_up, conf_bw, conf_fw, base)
        return P.q(out.clamp(0, 1))

    def state(self) -> dict:
        """The carried features the next window starts from, NCHW."""
        return {"feat_prop": self.feat_prop,
                "feat_prop_up": self.feat_prop_up}
