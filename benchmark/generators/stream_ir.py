"""Generator ``stream_ir``: the ``stream`` generator's closed-loop stream
for RefVSR-IR. The program's ``RefVSRIRNet`` streams through
``StreamRunner`` with the configuration's ``keyframe_stride``, so each
window's keyframes slide on from the last and start again at every
re-anchor; the kept windows are replayed through
``benchmark/reference/refvsr_ir.py``.

Its traffic files hold the keys the ``stream`` generator reads, with the
same meaning: the clip, the warm-up and traced cycles, and the frames
compared. The configuration adds ``keyframe_stride``,
``fix_stale_flow_bug`` and ``edvr``, EDVR-M's sizes as the program builds
them (checked against the program's state dict)."""

from __future__ import annotations

import time

import torch

from benchmark import compare, weights
from benchmark.generators import stream
from benchmark.reference import refvsr as base
from benchmark.reference import refvsr_ir as reference

DTYPES = stream.DTYPES


def _net(cfg):
    from refvsr_tpu_torch.models.refvsr_ir import RefVSRIRNet
    return RefVSRIRNet(scale=cfg["scale"], num_blocks=cfg["num_blocks"],
                       mid_channels=cfg["mid_channels"],
                       matching_ksize=cfg["matching_ksize"],
                       flag_HD_in=cfg["flag_HD_in"],
                       keyframe_stride=cfg["keyframe_stride"],
                       fix_stale_flow_bug=cfg["fix_stale_flow_bug"])


def edvr_sizes(shapes: dict) -> dict:
    """EDVR-M's sizes as a state dict of the program holds them."""
    pre = "edvr.feature_extraction."
    blocks = {k[len(pre):].split(".")[0] for k in shapes
              if k.startswith(pre)}
    offset = shapes["edvr.pcd_alignment.cas_dcnpack.conv_offset.weight"]
    fusion = shapes["edvr.fusion.feat_fusion.conv.weight"]
    mid = shapes["edvr.conv_first.weight"][0]
    return {"mid_channels": mid, "num_frames": fusion[1] // mid,
            "deform_groups": offset[0] // (3 * reference.TAPS),
            "num_blocks_extraction": len(blocks)}


def program_shapes(cfg: dict) -> dict:
    with torch.device("meta"):
        shapes = stream.state_dict_shapes(_net(cfg))
    want = {k: v for k, v in cfg["edvr"].items() if k != "center_frame_idx"}
    if edvr_sizes(shapes) != want:
        raise ValueError(f"the program's EDVR {edvr_sizes(shapes)} is not "
                         f"the configuration's {cfg['edvr']}")
    return shapes


def make_weights(cfg: dict, seed: int, device) -> dict:
    return weights.make(program_shapes(cfg), seed, DTYPES[cfg["dtype"]],
                        device)


def build_program(cfg: dict, sd: dict, dtype, device):
    with torch.device("meta"):
        net = _net(cfg)
    net = net.to_empty(device=device).to(dtype)
    net.load_state_dict(sd)
    return net.eval()


def make_runner(net, cfg: dict, device, dtype):
    from refvsr_tpu_torch.eval.stream import StreamRunner
    return StreamRunner(net, cfg["reset_branch"], device=device,
                        compute_dtype=dtype,
                        keyframe_stride=cfg["keyframe_stride"])


class Stream(stream.Stream):
    """One run of the generator: ``stream.Stream``'s window, traced pass and
    release with the IR net, its runner and its reference."""

    def setup(self):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.sd = make_weights(self.cfg, self.ctx.seed, self.device)
        net = build_program(self.cfg, self.sd, self.dtype, self.device)
        self.runner = make_runner(net, self.cfg, self.device, self.dtype)
        self.clip = stream.Clip(self.traffic, self.ctx.seed, self.dtype,
                                self.device)
        self.keeper = stream.Keeper(self.ctx.seed, self.traffic["compare"])
        self.w = 0
        warm = self.traffic["warmup_windows"]
        if warm < 1 or warm % self.cycle:
            raise ValueError(f"warmup_windows {warm} is not a whole number "
                             f"of {self.cycle}-window cycles")
        for _ in range(warm):
            self._frame()

    def check(self, limits: dict):
        """Replay the kept frames' windows through the reference and judge
        the served frames."""
        t0 = time.perf_counter()
        per_frame = []
        for w, ref_out, ref_state, bic in reference_frames(
                self.cfg, self.sd, self.clip, sorted(self.kept)):
            out, state = self.kept[w]
            per_frame.append(compare.frame_numbers(out, ref_out, state,
                                                   ref_state, bic))
        self.compared, self.failed = compare.judge(per_frame, limits)
        self.reference_s = time.perf_counter() - t0


def reference_frames(cfg, sd, clip, wanted, precision="f32"):
    """Yield (w, SR frame (1, 3, 4H, 4W) f32, carried state, the bicubic
    upscale of the window's centre frame) of the reference for each window
    in `wanted` (sorted). A re-anchor starts the state and the keyframes
    afresh, so each window is replayed from the first or re-anchor window
    of its cycle; windows between carry the state on without an output."""
    net = base.Net(sd, cfg["num_blocks"], cfg["mid_channels"], cfg["scale"],
                   cfg["flag_HD_in"], cfg["matching_ksize"],
                   base.Quant(precision))
    r = cfg["reset_branch"]
    t = cfg["frame_num"]
    s = nxt = None
    for w in wanted:
        start = (w // r) * r if r else 0
        if nxt is None or nxt < start:
            s = reference.Stream(net, cfg["keyframe_stride"],
                                 cfg["fix_stale_flow_bug"])
            nxt = start
        for v in range(nxt, w + 1):
            lrs, refs = (x.float().permute(0, 1, 4, 2, 3)
                         for x in clip.window(v, t))
            first = v == start
            if v == w:
                yield (w, s.window(lrs, refs, first), s.state(),
                       base.bicubic(lrs[:, t // 2], cfg["scale"]))
            else:
                s.advance(lrs, refs, first)
        nxt = w + 1
