"""The benchmark's yardstick of work: the chip's published peaks, the bytes
and operations of the two hand-written kernels' ops from their shapes, and
the floating-point operations of one RefVSR frame from the configuration's
sizes.

Nothing here reads what ran: the counts follow from shapes alone, so a
later change to the program is measured against the same work."""

from __future__ import annotations

# Published NVIDIA H100 SXM peaks (data sheet, dense): HBM bytes/s, and
# FLOP/s of the bf16 tensor cores and the TF32 tensor cores. The f32 cells
# are held against the TF32 rate: the matching's f32 product runs in three
# TF32 products on the tensor cores and cuDNN may pick TF32 kernels, so a
# share of the 67 TFLOP/s rate outside the tensor cores could pass 100%.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    """Least seconds for the work on one H100: the larger of bytes over the
    memory rate and operations over the dtype's peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def k1_work(x_shape, flow_shape, dtype: str, flow_dtype: str):
    """(bytes, operations) of one flow warp: x (N, H, W, C) in `dtype` and
    the flow (N, Ho, Wo, 2) in `flow_dtype` read once, the output
    (N, Ho, Wo, C) written once in `dtype`; four corners' multiply-adds
    per output value. The port keeps its flows in f32 whatever the
    features' dtype."""
    n, _, _, c = x_shape
    _, ho, wo, _ = flow_shape
    x = 1
    for d in x_shape:
        x *= d
    out = n * ho * wo * c
    return ((x + out) * ITEMSIZE[dtype]
            + n * ho * wo * 2 * ITEMSIZE[flow_dtype]), 8.0 * out


def k2_work(ref_shape, lr_shape, dtype: str):
    """(bytes, operations) of one matching max/argmax: ref (N, L_ref, D)
    and lr (N, L_lr, D) read once, an f32 max and an int32 index written
    per LR row; 2 * L_lr * L_ref * D operations."""
    n, l_ref, d = ref_shape
    l_lr = lr_shape[1]
    isz = ITEMSIZE[dtype]
    nbytes = n * (l_ref + l_lr) * d * isz + n * l_lr * 8
    return nbytes, 2.0 * n * l_lr * l_ref * d


# ------------------------------------------------ FLOPs of a RefVSR frame

def conv(cin, cout, k, px):
    """Multiply-adds x 2 of a k x k convolution with `px` output pixels."""
    return 2.0 * cin * cout * k * k * px


def _ceil32(v):
    return v if v % 32 == 0 else 32 * (v // 32 + 1)


def spynet_flops(h, w):
    """One SPyNet pair: five 7x7 convolutions at each of six levels of the
    /32-padded pyramid."""
    hu, wu = _ceil32(h), _ceil32(w)
    per_px = sum(conv(a, b, 7, 1) for a, b in
                 ((8, 32), (32, 64), (64, 32), (32, 16), (16, 2)))
    return sum(per_px * (hu >> lv) * (wu >> lv) for lv in range(6))


def match_flops(cfg, h, w, hr, wr):
    """One frame's matching: (the VGG prefix and 1x1 map on LR and the
    pooled ref, the patch similarity product at D = 144)."""
    s, hd = cfg["scale"], cfg["flag_HD_in"]
    f = s // 2 if hd else 1
    vgg7 = hd or s == 2

    def feat(px):
        total = conv(3, 64, 3, px) + conv(64, 64, 3, px)
        if vgg7:
            px //= 4
            total += conv(64, 128, 3, px) + conv(128, 16, 1, px)
        else:
            total += conv(64, 16, 1, px)
        return total, px
    lr_f, l_lr = feat((h // f) * (w // f))
    ref_f, l_ref = feat((hr // f // 2) * (wr // f // 2))
    return lr_f + ref_f, 2.0 * l_lr * l_ref * 144


def _aligned_conv_flops(canvas_px, ks):
    """AlignedConv2d on a canvas of `canvas_px` pixels: its head on the
    query and on the warped ref, then the strided offset branch."""
    head = conv(3, 32, 5, canvas_px) + 2 * conv(32, 32, 3, canvas_px)
    grid = canvas_px // (ks * ks)
    return (2 * head + conv(64, 32, 5, grid) + 2 * conv(32, 32, 3, grid)
            + conv(32, 3, 1, grid))


def aligned_flops(cfg, h, w, hr, wr):
    """One frame's carry-independent RAP half: encode the ref, then the
    aa1 (if it aligns) and aa2 alignments."""
    c = cfg["mid_channels"]
    ref_px, half_px = hr * wr, (hr // 2) * (wr // 2)
    total = (conv(3, c, 3, ref_px) + conv(c, c, 3, ref_px)
             + 9 * conv(c, c, 3, ref_px)
             + conv(c, c, 3, half_px) + conv(c, c, 3, half_px)
             + 9 * conv(c, c, 3, half_px))
    a1 = cfg["matching_ksize"] // 2
    if a1 > 1:
        total += _aligned_conv_flops(h * w, a1)
    return total + _aligned_conv_flops(4 * h * w, cfg["matching_ksize"])


def step_flops(cfg, h, w):
    """One propagation step: the resblock chain and the carry-dependent
    RAP half."""
    c, px = cfg["mid_channels"], h * w
    total = conv(c + 3, c, 3, px) + 2 * cfg["num_blocks"] * conv(c, c, 3, px)
    total += (conv(2, 16, 3, px) + conv(16, c, 3, px)
              + conv(2 * c, c, 3, px) + conv(c, c, 3, px)
              + 17 * conv(c, c, 3, px) + conv(c, 4 * c, 3, px))
    up = 4 * px
    total += (conv(2 * c, c, 3, up) + conv(2, 16, 3, up) + conv(16, c, 3, up)
              + conv(2 * c, c, 3, up) + conv(c, c, 3, up)
              + 9 * conv(c, c, 3, up))
    return total


def up_flops(cfg, h, w):
    """compute_up and the x4 tail."""
    c, up = cfg["mid_channels"], 4 * h * w
    total = (conv(2 * c, c, 1, up) + conv(2, 16, 3, up) + conv(16, c, 3, up)
             + conv(2 * c, c, 3, up) + conv(c, c, 3, up)
             + 9 * conv(c, c, 3, up))
    if cfg["scale"] == 4:
        total += conv(c, 4 * c, 3, up)
        up *= 4
    return total + conv(c, c, 3, up) + conv(c, 3, 3, up)


def parts(cfg, lr_hw, ref_hw) -> dict:
    """FLOPs of each part of the network at these frame sizes: one SPyNet
    pair, one frame's matching convolutions and its similarity product,
    one frame's alignment, one propagation step, the tail."""
    (h, w), (hr, wr) = lr_hw, ref_hw
    match_conv, match_k2 = match_flops(cfg, h, w, hr, wr)
    return {"spynet": spynet_flops(h, w), "match_conv": match_conv,
            "match_k2": match_k2, "aligned": aligned_flops(cfg, h, w, hr, wr),
            "step": step_flops(cfg, h, w), "up": up_flops(cfg, h, w)}


def frame_counts(cfg, kind: str) -> dict:
    """How many of each part one output frame needs. A streamed frame: one
    new frame pair through SPyNet both ways, one new frame matched and
    aligned, the backward branch's T - T//2 steps and one forward step,
    the tail. A first or re-anchor frame: every pair of the window both
    ways, every frame matched and aligned once, T - T//2 backward and
    T//2 + 1 forward steps, the tail."""
    t = cfg["frame_num"]
    back = t - t // 2
    if kind == "stream":
        pairs, frames, steps = 1, 1, back + 1
    else:
        pairs, frames, steps = t - 1, t, back + t // 2 + 1
    return {"spynet": 2 * pairs, "match_conv": frames, "match_k2": frames,
            "aligned": frames, "step": steps, "up": 1}


def frame_flops(cfg, lr_hw, ref_hw, kind: str) -> float:
    """FLOPs one output frame needs (``frame_counts`` of ``parts``)."""
    p = parts(cfg, lr_hw, ref_hw)
    return sum(n * p[k] for k, n in frame_counts(cfg, kind).items())
