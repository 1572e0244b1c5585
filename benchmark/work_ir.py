"""The benchmark's yardstick of RefVSR-IR's work: the bytes and operations
of one modulated deformable convolution from its shapes, and the
floating-point operations of one IR frame from the configuration's sizes
and the window's keyframes, which follow from the window's index.

As in ``benchmark/work.py``, nothing here reads what ran: a later change to
the program is measured against the same work."""

from __future__ import annotations

from benchmark import work
from benchmark.work import conv

TAPS = 9


def dcn_work(x_shape, offset_shape, mask_shape, weight_shape,
             dtype: str = "float32"):
    """(bytes, operations) of one 3x3 modulated deformable convolution: x
    (N, H, W, C), its offsets (N, H, W, 2*dg*9) and mask (N, H, W, dg*9),
    the weight (O, C, 3, 3) and bias (O,) read once and the output (N, H,
    W, O) written once, all in `dtype`; 2*N*H*W*9*C*O operations of the
    contraction and four corners' multiply-adds for each of the N*H*W*9*C
    sampled values."""
    n, h, w, c = x_shape
    o = weight_shape[0]
    px = n * h * w
    elems = (px * (c + offset_shape[-1] + mask_shape[-1] + o)
             + o * c * TAPS + o)
    return (elems * work.ITEMSIZE[dtype],
            2.0 * px * TAPS * c * o + 8.0 * px * TAPS * c)


def keyframes(cfg, w: int) -> list:
    """Keyframes of window w of a stream (RefVSR_IR.py:255-264): every
    ``keyframe_stride``-th frame from the first keyframe, and the last
    frame. The first keyframe is 0 at a clip's first window and at each
    re-anchor, and one frame earlier (wrapping by the stride) in each
    window after."""
    t, stride, r = cfg["frame_num"], cfg["keyframe_stride"], \
        cfg["reset_branch"]
    since = w % r if r else w
    keys = list(range((-since) % stride, t, stride))
    if keys[-1] != t - 1:
        keys.append(t - 1)
    return keys


def edvr_flops(e: dict, h: int, w: int) -> float:
    """EDVR-M on one keyframe's neighbourhood of frames h x w (multiples
    of 4): features at three levels of every frame, PCD alignment of each
    frame onto the centre (offset convolutions, four deformable
    convolutions with their sampling), TSA fusion."""
    c, nf = e["mid_channels"], e["num_frames"]
    off = 3 * TAPS * e["deform_groups"]
    p1, p2, p3 = h * w, (h // 2) * (w // 2), (h // 4) * (w // 4)

    def dcn(px):
        return (conv(c, off, 3, px) + 2.0 * px * TAPS * c * c
                + 8.0 * px * TAPS * c)
    feats = nf * (conv(3, c, 3, p1)
                  + 2 * e["num_blocks_extraction"] * conv(c, c, 3, p1)
                  + 2 * conv(c, c, 3, p2) + 2 * conv(c, c, 3, p3))
    pcd = (conv(2 * c, c, 3, p3) + conv(c, c, 3, p3) + dcn(p3)
           + sum(conv(2 * c, c, 3, p) + conv(2 * c, c, 3, p)
                 + conv(c, c, 3, p) + dcn(p) + conv(2 * c, c, 3, p)
                 for p in (p2, p1))
           + conv(2 * c, c, 3, p1) + conv(c, c, 3, p1) + dcn(p1))
    tsa = (conv(c, c, 3, p1) * (1 + nf) + 2.0 * nf * c * p1
           + 2 * conv(nf * c, c, 1, p1)
           + conv(2 * c, c, 1, p2) + conv(c, c, 1, p2)
           + conv(2 * c, c, 3, p3) + conv(c, c, 3, p3)
           + conv(c, c, 3, p2) + conv(c, c, 1, p2)
           + conv(c, c, 3, p1) + 2 * conv(c, c, 1, p1))
    return feats + nf * pcd + tsa


def frame_flops(cfg, lr_hw, ref_hw, w: int, kind: str) -> float:
    """FLOPs one IR output frame needs, window w of kind "first",
    "reanchor" or "stream": SPyNet both ways on every pair of a first or
    re-anchor window and on the one new pair of a streamed one; all T
    frames matched and aligned; T backward and T//2 + 1 forward steps, the
    forward ones with the backward outputs in their input convolution; a
    refill fusion at each keyframe a branch visits; EDVR at each keyframe;
    the tail."""
    h, w_ = lr_hw
    t, c = cfg["frame_num"], cfg["mid_channels"]
    p = work.parts(cfg, lr_hw, ref_hw)
    pairs = 1 if kind == "stream" else t - 1
    keys = keyframes(cfg, w)
    fw_keys = [k for k in keys if k <= t // 2]
    px = h * w_
    e = cfg["edvr"]
    edvr = edvr_flops(e, h + (-h) % 4, w_ + (-w_) % 4)
    return (2 * pairs * p["spynet"]
            + t * (p["match_conv"] + p["match_k2"] + p["aligned"])
            + (t + t // 2 + 1) * p["step"]
            + (t // 2 + 1) * conv(c, c, 3, px)
            + (len(keys) + len(fw_keys)) * conv(c + e["mid_channels"], c, 3,
                                                px)
            + len(keys) * edvr + p["up"])
