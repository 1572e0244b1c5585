"""RefVSR core network for streaming inference and training (NHWC);
counterpart of ``refvsr_tpu/models/refvsr.py``.

The JAX package's ``nn.scan`` loops (SPyNet pairs, propagation steps, the
aligned-feature cache fill) are Python loops here, and its TPU-only
formulations (row-tiled tails, pre-shuffle convs) give way to the direct
math (``_tail``). Two entry points serve a stream: ``forward_first`` once
per clip (or after a branch reset) and ``forward_stream`` once per window.
``forward_train`` is one training window: both branches in full, the
aligned features recomputed inside every propagation step, SPyNet (frozen)
under ``torch.no_grad()``.

Pipelined streaming (``pipeline_lanes`` L > 1): the B = T - T//2 backward
steps of each output frame are spread over L consecutive dispatches, so one
dispatch (``forward_stream_prime`` for the L - 1 windows after
``forward_first``, then ``forward_stream_pipelined``) runs P = B/L
propagation steps on a batch of L chains instead of B steps on one. Each
output equals ``forward_stream``'s for the same frame and comes out L - 1
dispatches later. The aligned rings and conf/index tails then hold B + L - 1
frames, and the L - 1 unfinished chains ride in the state (``pipe_*``).

``zero_flow`` (the serving path, ``EVAL.is_gradio``) replaces SPyNet's
flows by zeros; the warps still run, on zero flows.

Under an active spatial context (``parallel/spatial.py``) the entry points
take each rank's band of rows of the window (and of the state: H at
ndim-3, the index tail's flattened L axis split) and every op runs its
shard-local rule; SPyNet runs replicated on the gathered frames.

Reference quirk kept: the intra-window forward branch warps the already
warped low-res ``feat_prop`` onto the 2x grid for ``feat_prop_up``
(RefVSR.py:252-254); the cross-window step warps the saved UP tensor.

Every zeros-padding warp goes through kernel K1 (``ops/warp.warp``): two per
propagation step, so 10 per ``forward_stream`` window (4 backward steps + the
forward step) and 16 per ``forward_first`` at T = 7. Every matching goes
through kernel K2: one batch-T launch per ``forward_first`` and one batch-1
launch per ``forward_stream``. A pipelined dispatch at L = 2, T = 7 runs 6
warps (two sub-steps of batch 2, then the forward step; 4 when priming) and
one batch-1 matching."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn

from refvsr_tpu_torch import resolve_device
from refvsr_tpu_torch.models.blocks import (BasicBlock, Conv2d,
                                            PixelShufflePack,
                                            ResidualBlocksWithInputConv,
                                            ResList, init_weights, lrelu)
from refvsr_tpu_torch.models.matching import AlignedAttention, FeatureMatching
from refvsr_tpu_torch.models.spynet import SPyNet
from refvsr_tpu_torch.ops.resize import resize
from refvsr_tpu_torch.ops.warp import warp
from refvsr_tpu_torch.parallel import spatial


@dataclass
class StreamState:
    """Cross-window recurrent state (the reference's ``*_prev`` attributes,
    RefVSR.py:96-99, plus the streaming caches of the JAX StreamState).

    flows_fwd/flows_bwd: the window's SPyNet flows; the next window reuses
    them shifted by one plus ONE new pair. conf_tail/index_tail: matching of
    the tail frames center..T-1, shifted likewise. aligned_tail and
    aligned_up_tail: the carry-independent RAP half (encode_ref + aa1 + aa2)
    of the tail frames, as RING buffers: logical tail frame i lives in slot
    (tail_base + i) % TT along dim 1. A state without tails (from
    ``init_stream_state``) makes ``forward_stream`` match and encode every
    tail frame. pipe_feat/pipe_feat_up/pipe_conf: the pipelined stream's
    unfinished backward chains (lanes 0..L-2 stacked along the batch),
    None for the plain stream."""
    feat_prop: torch.Tensor       # (N, h, w, C)
    feat_prop_up: torch.Tensor    # (N, 2h, 2w, C)
    conf_prop: torch.Tensor       # (N, h, w, 1)
    flow: torch.Tensor            # (N, h, w, 2)
    flows_fwd: torch.Tensor       # (N, T-1, h, w, 2)
    flows_bwd: torch.Tensor       # (N, T-1, h, w, 2)
    conf_tail: Optional[torch.Tensor] = None        # (N, TT, h, w, 1)
    index_tail: Optional[torch.Tensor] = None       # (N, TT, L) int32
    aligned_tail: Optional[torch.Tensor] = None     # (N, TT, h, w, C)
    aligned_up_tail: Optional[torch.Tensor] = None  # (N, TT, 2h, 2w, C)
    tail_base: int = 0
    pipe_feat: Optional[torch.Tensor] = None      # ((L-1)*N, h, w, C)
    pipe_feat_up: Optional[torch.Tensor] = None   # ((L-1)*N, 2h, 2w, C)
    pipe_conf: Optional[torch.Tensor] = None      # ((L-1)*N, h, w, 1)


def init_stream_state(n: int, h: int, w: int, mid_channels: int,
                      dtype=torch.float32, num_frames: int = 7,
                      device="cuda") -> StreamState:
    dev = resolve_device(device)

    def z(*s):
        return torch.zeros(s, dtype=dtype, device=dev)
    return StreamState(
        feat_prop=z(n, h, w, mid_channels),
        feat_prop_up=z(n, 2 * h, 2 * w, mid_channels),
        conf_prop=z(n, h, w, 1), flow=z(n, h, w, 2),
        flows_fwd=z(n, num_frames - 1, h, w, 2),
        flows_bwd=z(n, num_frames - 1, h, w, 2))


def _up2(x):
    return resize(x, scale_factor=2, mode="bicubic", align_corners=False)


def _up2_clamp(x):
    return _up2(x).clamp(0.0, 1.0)


def _flow_up2(flow):
    """2x-upscale a flow field for warping UP features (RefVSR.py:220,254).
    align_corners=True has no integer-ratio offset, so under an active
    spatial context the flow is gathered whole, upscaled and banded."""
    ctx = spatial.active()
    if ctx is None:
        return resize(flow, scale_factor=2, mode="bilinear",
                      align_corners=True) * 2.0
    h = ctx.whole(flow)
    full = spatial.gather_rows(flow, h, 1, ctx)
    with spatial.replicated():
        up = _flow_up2(full)
    return spatial.band_of(up, 2 * h, 1, ctx)


def replicated_rows(fn, *xs, dim: int = 1):
    """``fn(*xs)`` on whole tensors: under an active spatial context each
    x (a band of rows along `dim`) is gathered whole, `fn` runs replicated
    and this rank's rows of each output are kept (rule (c)); otherwise
    ``fn(*xs)``. Outputs share the inputs' rows along `dim`."""
    ctx = spatial.active()
    if ctx is None:
        return fn(*xs)
    n = ctx.whole(xs[0], dim)
    whole = [spatial.gather_rows(x, n, dim, ctx) for x in xs]
    with spatial.replicated():
        out = fn(*whole)
    if isinstance(out, tuple):
        return tuple(spatial.band_of(o, n, dim, ctx) for o in out)
    return spatial.band_of(out, n, dim, ctx)


def _fusion_pair(cin, feat0, mid):
    # torch names <name>.0 / <name>.1 (RefVSR.py:56,72)
    return nn.Sequential(BasicBlock(cin, feat0, 3), BasicBlock(feat0, mid, 3))


class RefVSRNet(nn.Module):
    """The 'RefVSR' architecture (config_RefVSR_MFID.py:41-47), NHWC.

    zero_flow: zero flows in place of SPyNet's (the serving path); SPyNet's
    parameters stay, so a state dict loads the same either way.
    pipeline_lanes: L > 1 enables the pipelined stream (module docstring);
    0 or 1 is the plain stream. Neither adds a parameter."""

    def __init__(self, scale: int = 4, num_blocks: int = 30,
                 mid_channels: int = 48, matching_ksize: int = 2,
                 flag_HD_in: bool = False, zero_flow: bool = False,
                 pipeline_lanes: int = 0):
        super().__init__()
        mid = mid_channels
        self.scale, self.num_blocks, self.mid_channels = (scale, num_blocks,
                                                          mid)
        self.matching_ksize, self.flag_HD_in = matching_ksize, flag_HD_in
        self.zero_flow, self.pipeline_lanes = zero_flow, pipeline_lanes
        self.FlowNet = SPyNet()
        self.feature_match = FeatureMatching(scale=scale,
                                             flag_HD_in=flag_HD_in)
        aa1_scale = matching_ksize // 2
        self.aa1 = AlignedAttention(scale=aa1_scale, align=aa1_scale > 1)
        self.aa2 = AlignedAttention(scale=matching_ksize, align=True)

        self.ref_encoder1 = nn.Sequential(BasicBlock(3, mid, 3),
                                          BasicBlock(mid, mid, 3))
        self.res1 = ResList(4, mid)
        self.ref_encoder2 = nn.Sequential(BasicBlock(mid, mid, 3, stride=2),
                                          BasicBlock(mid, mid, 3))
        self.res2 = ResList(4, mid)

        self.conf_fusion = _fusion_pair(2, 16, mid)
        self.conf_fusion2 = _fusion_pair(2, 16, mid)
        self.conf_fusion_BWFW = _fusion_pair(2, 16, mid)
        self.feat_fusion = _fusion_pair(2 * mid, mid, mid)
        self.feat_fusion2 = _fusion_pair(2 * mid, mid, mid)
        self.feat_fusion_BWFW = _fusion_pair(2 * mid, mid, mid)
        self.feat_fusion2_1 = nn.Sequential(BasicBlock(2 * mid, mid, 3))

        self.feat_decoder = ResList(8, mid)
        self.feat_decoder2 = ResList(4, mid)
        self.feat_decoder_BWFW = ResList(4, mid)

        self.backward_resblocks = ResidualBlocksWithInputConv(
            mid + 3, mid, num_blocks)
        self.forward_resblocks = ResidualBlocksWithInputConv(
            mid + 3, mid, num_blocks)

        self.fusion_UP = Conv2d(2 * mid, mid, 1)
        self.upsample1 = PixelShufflePack(mid, mid, 2)
        if scale == 4:
            self.upsample2 = PixelShufflePack(mid, mid, 2)
        self.conv_hr = Conv2d(mid, mid, 3)
        self.conv_last = Conv2d(mid, 3, 3)

    # ---------------- sub-computations ----------------

    def compute_flows(self, lrs):
        """lrs (N, T, H, W, 3) -> (forward_flows, backward_flows), each
        (N, T-1, H, W, 2); one SPyNet call per frame pair, or zeros
        without SPyNet under zero_flow (RefVSR.py:183-191)."""
        if self.zero_flow:
            n, t, h, w = lrs.shape[:4]
            z = lrs.new_zeros((n, t - 1, h, w, 2))
            return z, z

        def flows(lrs):
            fwd = [self.FlowNet(lrs[:, j + 1], lrs[:, j])   # RefVSR.py:184
                   for j in range(lrs.shape[1] - 1)]
            bwd = [self.FlowNet(lrs[:, j], lrs[:, j + 1])   # RefVSR.py:189
                   for j in range(lrs.shape[1] - 1)]
            return torch.stack(fwd, 1), torch.stack(bwd, 1)
        # SPyNet's /32 pyramid has no integer-ratio band: replicated
        return replicated_rows(flows, lrs, dim=2)

    def compute_matching(self, lrs, refs):
        """Batched per-frame matching: lrs (N, T, h, w, 3), refs
        (N, T, hr, wr, 3) -> conf (N, T, h, w, 1), index (N, T, h*w)."""
        n, t = lrs.shape[:2]
        conf, index = self.feature_match(lrs.reshape(n * t, *lrs.shape[2:]),
                                         refs.reshape(n * t, *refs.shape[2:]))
        return (conf.reshape(n, t, *conf.shape[1:]),
                index.reshape(n, t, *index.shape[1:]))

    def encode_ref(self, ref):
        f = self.res1(self.ref_encoder1(ref))
        return f, self.res2(self.ref_encoder2(f))

    def compute_aligned(self, lr, ref, index):
        """The carry-independent half of RAP (encode the ref, align it at
        both levels by the index map); cached per tail frame in streaming."""
        lr_down = resize(lr, scale_factor=0.5, mode="bicubic").clamp(0.0, 1.0)
        ref_feat, ref_feat_down = self.encode_ref(ref)
        return (self.aa1(lr_down, ref, index, ref_feat_down),
                self.aa2(lr, ref, index, ref_feat))

    def compute_aligned_scan(self, lrs, refs, indices, front: int = 0):
        """compute_aligned for each frame of a (N, T, ...) window, one frame
        at a time, written into (N, front + T, ...) buffers whose first
        `front` slots are zeros."""
        outs = None
        for i in range(lrs.shape[1]):
            a, au = self.compute_aligned(lrs[:, i], refs[:, i], indices[:, i])
            if outs is None:
                outs = [x.new_empty((x.shape[0], front + lrs.shape[1],
                                     *x.shape[1:])) for x in (a, au)]
                for o in outs:
                    o[:, :front].zero_()
            outs[0][:, front + i] = a
            outs[1][:, front + i] = au
        return outs

    def rap(self, conf, conf_prop, feat_prop, feat_prop_up, aligned,
            aligned_up):
        """2-level Reference Alignment and Propagation (RefVSR.py:123-149),
        the carry-dependent half."""
        alpha = self.conf_fusion(torch.cat([conf_prop, conf], -1))
        feat_prop = feat_prop + alpha * self.feat_fusion(
            torch.cat([feat_prop, aligned], -1))
        feat_prop = self.feat_decoder(feat_prop)

        feat_prop_up = self.feat_fusion2_1(torch.cat(
            [feat_prop_up, self.upsample1(feat_prop)], -1))
        alpha = self.conf_fusion2(torch.cat([_up2_clamp(conf_prop),
                                             _up2_clamp(conf)], -1))
        feat_prop_up = feat_prop_up + alpha * self.feat_fusion2(
            torch.cat([feat_prop_up, aligned_up], -1))
        feat_prop_up = self.feat_decoder2(feat_prop_up)
        return feat_prop, feat_prop_up, torch.maximum(conf_prop, conf)

    def _prop_step(self, branch: str, warp_up_from_low: bool, carry, x):
        """One propagation step: warp -> aggregate -> RAP (RefVSR.py:214-276).
        x holds lr, conf, flow and either aligned/aligned_up (cached) or
        ref/index (computed here)."""
        feat_prop, feat_prop_up, conf_prop = carry
        mid = feat_prop.shape[-1]
        # conf_prop rides the feature warp (same flow and grid): C = mid + 1
        packed = warp(torch.cat([feat_prop, conf_prop], -1), x["flow"])
        feat_prop, conf_prop = packed[..., :mid], packed[..., mid:]
        # the reference reassigns feat_prop (RefVSR.py:252) before line 254
        # reads it: the low-res UP source is the already-warped feat_prop
        up_src = feat_prop if warp_up_from_low else feat_prop_up
        feat_prop_up = warp(up_src, _flow_up2(x["flow"]))

        resblocks = (self.backward_resblocks if branch == "backward"
                     else self.forward_resblocks)
        feat_prop = resblocks(torch.cat([x["lr"], feat_prop], -1))
        if "aligned" in x:
            aligned, aligned_up = x["aligned"], x["aligned_up"]
        else:
            aligned, aligned_up = self.compute_aligned(x["lr"], x["ref"],
                                                       x["index"])
        return self.rap(x["conf"], conf_prop, feat_prop, feat_prop_up,
                        aligned, aligned_up)

    def _tail(self, out):
        """upsample2 -> conv_hr -> conv_last (RefVSR.py:114-118)."""
        if self.scale == 4:
            out = lrelu(self.upsample2(out), 0.1)
        return self.conv_last(lrelu(self.conv_hr(out), 0.1))

    def compute_up(self, backward_feat_up, forward_feat_up, conf_bw, conf_fw,
                   base):
        """Final fusion + upsampling (RefVSR.py:104-119)."""
        cat_features = torch.cat([backward_feat_up, forward_feat_up], -1)
        out = self.fusion_UP(cat_features)
        alpha = self.conf_fusion_BWFW(torch.cat([_up2_clamp(conf_bw),
                                                 _up2_clamp(conf_fw)], -1))
        out = out + alpha * self.feat_fusion_BWFW(cat_features)
        return self._tail(self.feat_decoder_BWFW(out)) + base

    # ---------------- branches ----------------

    def _backward_branch(self, lrs, backward_flows, confs, frame_offset,
                         aligneds=None, aligneds_up=None, aligned_offset=None,
                         aligned_base: int = 0, refs=None, indices=None):
        """Backward branch over frames t-1 .. t//2 (RefVSR.py:210-238).
        confs (and indices) are indexed from `frame_offset`. Given the
        aligned caches, each step reads them from `aligned_offset` (default
        frame_offset), as a ring with logical entry i at slot
        (aligned_base + i) % TT; otherwise each step recomputes its aligned
        features from refs (absolute frame index) and indices."""
        n, t, h, w = lrs.shape[:4]
        center = t // 2
        aoff = frame_offset if aligned_offset is None else aligned_offset
        dt = lrs.dtype
        carry = (lrs.new_zeros((n, h, w, self.mid_channels)),
                 lrs.new_zeros((n, 2 * h, 2 * w, self.mid_channels)),
                 lrs.new_zeros((n, h, w, 1)))
        zero_flow = torch.zeros((n, h, w, 2), dtype=dt, device=lrs.device)
        for i in range(t - 1, center - 1, -1):
            # frame t-1 warps the all-zero init by a dummy zero flow; frame
            # i < t-1 warps by backward_flows[:, i] (RefVSR.py:217)
            x = {"lr": lrs[:, i], "conf": confs[:, i - frame_offset],
                 "flow": zero_flow if i == t - 1 else backward_flows[:, i]}
            if aligneds is None:
                x["ref"] = refs[:, i]
                x["index"] = indices[:, i - frame_offset]
            else:
                slot = (aligned_base + i - aoff) % aligneds.shape[1]
                x["aligned"] = aligneds[:, slot]
                x["aligned_up"] = aligneds_up[:, slot]
            carry = self._prop_step("backward", False, carry, x)
        return carry

    def _forward_step0(self, state: StreamState, lr, conf, ref=None,
                       index=None, aligned=None, aligned_up=None):
        """First forward step: warps the carried-in state by its saved flow
        (RefVSR.py:256-260; a zero state for a first window)."""
        x = {"lr": lr, "conf": conf, "flow": state.flow}
        if aligned is not None:
            x["aligned"], x["aligned_up"] = aligned, aligned_up
        else:
            x["ref"], x["index"] = ref, index
        return self._prop_step(
            "forward", False,
            (state.feat_prop, state.feat_prop_up, state.conf_prop), x)

    def _forward_branch_full(self, state, lrs, refs, forward_flows, confs,
                             indices):
        """Forward branch over frames 0..t//2 (first or training window).
        Returns (carry at the centre, carry after step 0)."""
        center = lrs.shape[1] // 2
        carry0 = carry = self._forward_step0(state, lrs[:, 0], confs[:, 0],
                                             ref=refs[:, 0],
                                             index=indices[:, 0])
        for i in range(1, center + 1):
            # frame i warps by forward_flows[:, i-1] (RefVSR.py:252)
            x = {"lr": lrs[:, i], "ref": refs[:, i], "conf": confs[:, i],
                 "index": indices[:, i], "flow": forward_flows[:, i - 1]}
            carry = self._prop_step("forward", True, carry, x)
        return carry, carry0

    def _finalize(self, lr_center, bw_carry, fw_carry):
        base = resize(lr_center, scale_factor=self.scale,
                      mode="bicubic").clamp(0.0, 1.0)
        return self.compute_up(bw_carry[1], fw_carry[1], bw_carry[2],
                               fw_carry[2], base)

    # ---------------- entry points ----------------

    def forward_train(self, lrs, refs, state: StreamState):
        """Training window (RefVSR.py:279-283 with is_train=True): both
        branches in full on the uncached path, SPyNet flows without
        gradients. lrs (N, T, h, w, 3), refs (N, T, hr, wr, 3), `state` the
        carry from the previous window. Returns (out (N, s*h, s*w, 3),
        unclamped, and the new state, taken after forward step 0 and
        detached)."""
        t = lrs.shape[1]
        with torch.no_grad():
            fwd_flows, bwd_flows = self.compute_flows(lrs)
        confs, indices = self.compute_matching(lrs, refs)
        bw_carry = self._backward_branch(lrs, bwd_flows, confs, 0, refs=refs,
                                         indices=indices)
        fw_carry, fw_carry0 = self._forward_branch_full(
            state, lrs, refs, fwd_flows, confs, indices)
        out = self._finalize(lrs[:, t // 2], bw_carry, fw_carry)
        new_state = StreamState(
            feat_prop=fw_carry0[0].detach(),
            feat_prop_up=fw_carry0[1].detach(),
            conf_prop=fw_carry0[2].detach(), flow=fwd_flows[:, 0],
            flows_fwd=fwd_flows, flows_bwd=bwd_flows)
        return out, new_state

    def forward_first(self, lrs, refs):
        """First window of a clip: full branches, state saved at the center
        step. lrs (N, T, h, w, 3), refs (N, T, hr, wr, 3). Returns
        (out (N, s*h, s*w, 3) clamped to [0, 1], state, conf_vis).

        With pipeline_lanes L > 1 the tails get L - 1 zero frames in front
        (logical 0..L-2, frames "before" the clip, read only by lanes whose
        outputs the priming dispatches drop), so that after the L - 1
        priming dispatches this window's first tail frame sits at logical
        0 when the first steady dispatch needs it; the state also carries
        L - 1 zero chains."""
        n, t, h, w = lrs.shape[:4]
        state = init_stream_state(n, h, w, self.mid_channels, lrs.dtype,
                                  num_frames=t, device=lrs.device)
        center = t // 2
        ext = 0
        if self.pipeline_lanes > 1:
            self._pipeline_plan(t)
            ext = self.pipeline_lanes - 1
        fwd_flows, bwd_flows = self.compute_flows(lrs)
        confs, indices = self.compute_matching(lrs, refs)
        aligneds, aligneds_up = self.compute_aligned_scan(
            lrs[:, center:], refs[:, center:], indices[:, center:],
            front=ext)
        bw_carry = self._backward_branch(lrs, bwd_flows, confs, 0,
                                         aligneds[:, ext:],
                                         aligneds_up[:, ext:],
                                         aligned_offset=center)
        fw_carry, _ = self._forward_branch_full(state, lrs, refs, fwd_flows,
                                                confs, indices)
        out = self._finalize(lrs[:, center], bw_carry, fw_carry).clamp(0, 1)

        def front_pad(a):
            if not ext:
                return a
            return torch.cat([a.new_zeros((n, ext, *a.shape[2:])), a], 1)
        pipe = {}
        if ext:
            pipe = dict(pipe_feat=lrs.new_zeros((ext * n, h, w,
                                                 self.mid_channels)),
                        pipe_feat_up=lrs.new_zeros((ext * n, 2 * h, 2 * w,
                                                    self.mid_channels)),
                        pipe_conf=lrs.new_zeros((ext * n, h, w, 1)))
        new_state = StreamState(
            feat_prop=fw_carry[0], feat_prop_up=fw_carry[1],
            conf_prop=fw_carry[2], flow=fwd_flows[:, center],
            flows_fwd=fwd_flows, flows_bwd=bwd_flows,
            conf_tail=front_pad(confs[:, center:]),
            index_tail=front_pad(indices[:, center:]),
            aligned_tail=aligneds, aligned_up_tail=aligneds_up, tail_base=0,
            **pipe)
        return out, new_state, (bw_carry[2], fw_carry[2], confs[:, center])

    def _shift_cached_flows(self, lrs, state: StreamState):
        """Window flows from the previous window's, shifted by one, plus one
        new SPyNet pair (values identical to recomputing all of them); the
        state's zeros unchanged under zero_flow."""
        if self.zero_flow:
            return state.flows_fwd, state.flows_bwd
        last, prev = lrs[:, -1], lrs[:, -2]
        new_fwd, new_bwd = replicated_rows(
            lambda a, b: (self.FlowNet(a, b), self.FlowNet(b, a)), last, prev)
        fwd = torch.cat([state.flows_fwd[:, 1:], new_fwd[:, None]], 1)
        bwd = torch.cat([state.flows_bwd[:, 1:], new_bwd[:, None]], 1)
        return fwd, bwd

    def _stream_tails(self, lrs, refs, state: StreamState):
        """The tails moved on by one frame: (confs, indices, aligneds,
        aligneds_up, base). A warm state matches and encodes only the
        newest frame; a state without tails matches and encodes frames
        center..T-1 and starts the ring at base 0."""
        center = lrs.shape[1] // 2
        if state.conf_tail is not None:
            new_conf, new_index = self.compute_matching(lrs[:, -1:],
                                                        refs[:, -1:])
            confs = torch.cat([state.conf_tail[:, 1:], new_conf], 1)
            indices = torch.cat([state.index_tail[:, 1:], new_index], 1)
        else:
            confs, indices = self.compute_matching(lrs[:, center:],
                                                   refs[:, center:])
        if state.aligned_tail is None:
            aligneds, aligneds_up = self.compute_aligned_scan(
                lrs[:, center:], refs[:, center:], indices)
            return confs, indices, aligneds, aligneds_up, 0
        # ring update: the newest frame's aligned features overwrite the
        # expired slot IN PLACE (the caches are ~4 GB at 1080p input; a
        # shifted copy would double that every window) and the base advances
        na, nau = self.compute_aligned(lrs[:, -1], refs[:, -1],
                                       indices[:, -1])
        aligneds, aligneds_up = state.aligned_tail, state.aligned_up_tail
        aligneds[:, state.tail_base] = na
        aligneds_up[:, state.tail_base] = nau
        base = (state.tail_base + 1) % aligneds.shape[1]
        return confs, indices, aligneds, aligneds_up, base

    def forward_stream(self, lrs, refs, state: StreamState):
        """Streaming window: full backward branch on cached matching and
        aligned features, forward branch only at the center frame from the
        carried state (RefVSR.py:173-176,246-247). Returns (out, new_state,
        conf_vis). The aligned rings of `state` are updated in place."""
        center = lrs.shape[1] // 2
        fwd_flows, bwd_flows = self._shift_cached_flows(lrs, state)
        confs, indices, aligneds, aligneds_up, base = self._stream_tails(
            lrs, refs, state)

        bw_carry = self._backward_branch(lrs, bwd_flows, confs, center,
                                         aligneds, aligneds_up,
                                         aligned_base=base)
        fw_carry = self._forward_step0(
            state, lrs[:, center], confs[:, 0], aligned=aligneds[:, base],
            aligned_up=aligneds_up[:, base])
        out = self._finalize(lrs[:, center], bw_carry, fw_carry).clamp(0, 1)
        new_state = StreamState(
            feat_prop=fw_carry[0], feat_prop_up=fw_carry[1],
            conf_prop=fw_carry[2], flow=fwd_flows[:, center],
            flows_fwd=fwd_flows, flows_bwd=bwd_flows,
            conf_tail=confs, index_tail=indices,
            aligned_tail=aligneds, aligned_up_tail=aligneds_up,
            tail_base=base)
        return out, new_state, (bw_carry[2], fw_carry[2], confs[:, 0])

    # ---------------- pipelined streaming ----------------

    def _pipeline_plan(self, t: int):
        """(L, P, TT, center) of the pipelined stream at window length t:
        P = B/L steps per dispatch over B = t - t//2 backward steps, tails
        of TT = B + L - 1 frames."""
        lanes, center = self.pipeline_lanes, t // 2
        b_steps = t - center
        if lanes <= 1 or b_steps % lanes:
            raise ValueError(f"pipeline_lanes={lanes} must be > 1 and "
                             f"divide the {b_steps} backward steps")
        if center - lanes + 1 < 0:
            raise ValueError(f"pipeline_lanes={lanes} needs T >= "
                             f"{2 * lanes - 1}, not {t}")
        return lanes, b_steps // lanes, b_steps + lanes - 1, center

    def _pipeline_dispatch(self, lrs, refs, state: StreamState, emit: bool):
        """One pipelined dispatch at window center d: move the tails on by
        one frame (in place, as forward_stream), run P propagation steps on
        a batch of the L chains, and, when `emit`, finish the oldest chain
        into output frame d - (L-1).

        Lane l (the chain of output d - l) takes its steps l*P .. l*P+P-1
        here: at sub-step p, with off = l*(P+1) + p, it reads lr and the
        backward flow at window index 2*center - off (zero flow at off 0,
        the chain's anchor), conf at logical TT-1-off and aligned features
        at ring slot (base + TT-1-off) % TT: the values forward_stream's
        chain for that output reads."""
        n, t = lrs.shape[:2]
        lanes, p_steps, tt, center = self._pipeline_plan(t)
        if (state.pipe_feat is None or state.aligned_tail is None
                or state.aligned_tail.shape[1] != tt):
            raise ValueError("the state's tails are not pipeline-sized: "
                             "start with forward_first on a net with "
                             "pipeline_lanes > 1")
        fwd_flows, bwd_flows = self._shift_cached_flows(lrs, state)
        confs, indices, aligneds, aligneds_up, base = self._stream_tails(
            lrs, refs, state)

        # lane 0 starts a new chain; lanes 1..L-1 continue the state's
        carry = tuple(torch.cat([torch.zeros_like(a), b], 0) for a, b in (
            (state.feat_prop, state.pipe_feat),
            (state.feat_prop_up, state.pipe_feat_up),
            (state.conf_prop, state.pipe_conf)))
        no_flow = torch.zeros_like(state.flow)
        for p in range(p_steps):
            lane_x = []
            for lane in range(lanes):
                off = lane * (p_steps + 1) + p
                rel = 2 * center - off
                slot = (base + tt - 1 - off) % tt
                lane_x.append((lrs[:, rel], confs[:, tt - 1 - off],
                               no_flow if off == 0 else bwd_flows[:, rel],
                               aligneds[:, slot], aligneds_up[:, slot]))
            x = {k: torch.cat(v, 0) for k, v in zip(
                ("lr", "conf", "flow", "aligned", "aligned_up"),
                zip(*lane_x))}
            carry = self._prop_step("backward", False, carry, x)

        keep = (lanes - 1) * n
        fwi = center - lanes + 1
        # the unfinished chains are copied out, so that the finished one's
        # memory goes with this dispatch
        moved = dict(flow=fwd_flows[:, fwi], flows_fwd=fwd_flows,
                     flows_bwd=bwd_flows, conf_tail=confs,
                     index_tail=indices, aligned_tail=aligneds,
                     aligned_up_tail=aligneds_up, tail_base=base,
                     pipe_feat=carry[0][:keep].clone(),
                     pipe_feat_up=carry[1][:keep].clone(),
                     pipe_conf=carry[2][:keep].clone())
        if not emit:
            # priming: the oldest lane's chain began before the clip; drop
            # it and keep the forward carry
            return dataclasses.replace(state, **moved)
        bw_carry = tuple(c[keep:] for c in carry)
        # the emitted frame's conf and aligned features sit at logical 0,
        # ring slot `base`
        fw_carry = self._forward_step0(
            state, lrs[:, fwi], confs[:, 0], aligned=aligneds[:, base],
            aligned_up=aligneds_up[:, base])
        out = self._finalize(lrs[:, fwi], bw_carry, fw_carry).clamp(0, 1)
        new_state = StreamState(feat_prop=fw_carry[0],
                                feat_prop_up=fw_carry[1],
                                conf_prop=fw_carry[2], **moved)
        return out, new_state, (bw_carry[2], fw_carry[2], confs[:, 0])

    def forward_stream_prime(self, lrs, refs, state: StreamState):
        """Priming dispatch (the L - 1 windows after forward_first): moves
        the tails and the chains on, emits nothing. Returns the state."""
        return self._pipeline_dispatch(lrs, refs, state, emit=False)

    def forward_stream_pipelined(self, lrs, refs, state: StreamState):
        """Steady pipelined dispatch at window center d: returns (out,
        new_state, conf_vis) for output frame d - (L-1), equal to
        forward_stream's for that frame."""
        return self._pipeline_dispatch(lrs, refs, state, emit=True)

    def forward(self, lrs, refs, state: StreamState):
        """The default entry is the training forward, as the JAX net's
        ``__call__`` (``torch.func.functional_call`` calls it)."""
        return self.forward_train(lrs, refs, state)


def build_refvsr(config, device="cuda", dtype=torch.float32,
                 seed: int = 0) -> RefVSRNet:
    """The network of `config` (``network`` "RefVSR" or "RefVSR_IR"; zero
    flows under ``EVAL.is_gradio``; RefVSR's ``pipeline_lanes``) with
    seeded random weights, cast to `dtype` and placed on `device` (the card
    unless the caller asks for the CPU). A training config (``is_train``)
    builds the plain stream, as the JAX package's ``build_network``
    does."""
    from refvsr_tpu_torch.utils.precision import cast_floating
    dev = resolve_device(device)
    kw = dict(scale=config.scale, num_blocks=config.num_blocks,
              mid_channels=config.mid_channels,
              matching_ksize=config.matching_ksize,
              flag_HD_in=config.flag_HD_in, zero_flow=config.EVAL.is_gradio)
    if config.network == "RefVSR":
        net = RefVSRNet(pipeline_lanes=(0 if config.is_train
                                        else config.pipeline_lanes), **kw)
    elif config.network == "RefVSR_IR":
        from refvsr_tpu_torch.models.refvsr_ir import RefVSRIRNet
        net = RefVSRIRNet(keyframe_stride=config.keyframe_stride, **kw)
    else:
        raise KeyError(f"unknown network {config.network!r}")
    init_weights(net, torch.Generator().manual_seed(seed))
    return cast_floating(net.to(dev), dtype).eval()
