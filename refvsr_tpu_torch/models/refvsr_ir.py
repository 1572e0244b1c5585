"""RefVSR-IR ('Ours-IR'): RefVSR with IconVSR-style information refill,
NHWC; counterpart of ``refvsr_tpu/models/refvsr_ir.py``.

Structure kept from the reference (RefVSR_IR.py:20-546) and the JAX net:

- an EDVR-M keyframe feature extractor (``models/edvr.py``) on each
  keyframe's 5-frame neighbourhood, with temporal mirror padding (frames
  [4, 3] before and [-4, -5] after the window; the JAX net's
  ``edvr_padding`` 3 has no caller and no counterpart) and the frames
  reflect-padded to multiples of 4, cropped back after;
- refill fusion convs (``backward_fusion``/``forward_fusion``) in front of
  each branch's residual blocks at keyframes;
- the backward branch covers the whole window (t-1 .. 0) and keeps each
  step's output, which the forward branch's residual blocks read (their
  input is 2*mid + 3 channels);
- keyframe indices slide across streamed windows
  (``sliding_keyframe_mask``);
- no centre-only streaming path: every window matches all T frames and runs
  both branches in full, saving the state at forward step 0.

The JAX net runs EDVR for every frame of a window and discards the
non-keyframes' features with a flag (one compiled graph); the port, like
the reference, runs EDVR at the keyframes only, which gives the same
values and gradients for 2 or 3 of 9 frames' work.

Reference bug kept (``fix_stale_flow_bug=False``, checkpoint parity): in
the forward branch at i > 0 ``feat_prop`` warps with forward_flows[:, i-1],
but ``feat_prop_up`` and ``conf_prop`` warp with the stale ``flow`` left
from the backward loop, backward_flows[:, 0] (RefVSR_IR.py:325-327).

Kernels: every warp goes through K1 (``ops/warp.warp``): 2 per backward
step, 2 at forward step 0 and 3 per later forward step, so 2T + 2 + 3*(T//2)
per window (32 at T = 9); the matching through K2, one batch-T launch per
window.

Spans (``utils/trace.py``), besides the stages this net shares with
RefVSRNet: ``refvsr.net.refill`` (device span) around
``compute_refill_features``, one a window, and ``refvsr.net.prop`` around
each ``_ir_step``, T backward and T//2 + 1 forward a window (14 at T = 9);
EDVR's deformable convolutions inside the refill are ``refvsr.dcn``."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from refvsr_tpu_torch.models.blocks import Conv2d, ResidualBlocksWithInputConv
from refvsr_tpu_torch.models.edvr import EDVRFeatureExtractor
from refvsr_tpu_torch.models.refvsr import (RefVSRNet, StreamState,
                                            _flow_up2, init_stream_state,
                                            replicated_rows)
from refvsr_tpu_torch.ops.warp import warp
from refvsr_tpu_torch.utils import trace


def sliding_keyframe_mask(t: int, stride: int, prev_first):
    """Keyframe indices of a window (RefVSR_IR.py:255-264) as a bool mask.
    prev_first: the previous window's first keyframe index, or None for a
    first window. Returns (mask[t], first keyframe index)."""
    if prev_first is None:
        idx = np.arange(0, t, stride)
    else:
        new_first = prev_first - 1
        if new_first < 0:
            new_first += stride
        idx = np.arange(new_first, t, stride)
    if idx[-1] != t - 1:
        idx = np.append(idx, t - 1)
    mask = np.zeros(t, bool)
    mask[idx] = True
    return mask, int(idx[0])


class RefVSRIRNet(RefVSRNet):
    """The 'RefVSR_IR' architecture. Shares RefVSRNet's modules and its
    flow, matching, alignment, RAP and upsampling code; the forward
    residual blocks take the backward branch's output too, and EDVR and the
    two refill fusions are added. Streams without pipelining."""

    def __init__(self, scale: int = 4, num_blocks: int = 30,
                 mid_channels: int = 36, matching_ksize: int = 2,
                 flag_HD_in: bool = False, keyframe_stride: int = 5,
                 zero_flow: bool = False, fix_stale_flow_bug: bool = False):
        super().__init__(scale=scale, num_blocks=num_blocks,
                         mid_channels=mid_channels,
                         matching_ksize=matching_ksize,
                         flag_HD_in=flag_HD_in, zero_flow=zero_flow)
        mid = mid_channels
        self.keyframe_stride = keyframe_stride
        self.fix_stale_flow_bug = fix_stale_flow_bug
        self.edvr = EDVRFeatureExtractor(num_frames=5, center_frame_idx=2)
        edvr_ch = 64
        self.backward_fusion = Conv2d(mid + edvr_ch, mid, 3)
        self.forward_fusion = Conv2d(mid + edvr_ch, mid, 3)
        self.forward_resblocks = ResidualBlocksWithInputConv(
            2 * mid + 3, mid, num_blocks)

    def _pipeline_plan(self, t: int):
        raise ValueError("RefVSR-IR streams without pipelining "
                         "(pipeline_lanes must be 0)")

    # ---------------- information refill ----------------

    def compute_refill_features(self, lrs, keys):
        """EDVR features of the frames `keys` (indices into the window)
        of lrs (N, T, H, W, 3), each from its 5-frame mirror-padded
        neighbourhood (RefVSR_IR.py:194-215): (N, len(keys), H, W, 64).
        EDVR runs replicated under an active spatial context."""
        with trace.span("refvsr.net.refill", lrs):
            return replicated_rows(lambda x: self._refill(x, keys), lrs,
                                   dim=2)

    def _refill(self, lrs, keys):
        n, t, h, w, c = lrs.shape
        pad_h, pad_w = (4 - h % 4) % 4, (4 - w % 4) % 4
        if pad_h or pad_w:
            x = lrs.reshape(n * t, h, w, c).permute(0, 3, 1, 2)
            x = F.pad(x, (0, pad_w, 0, pad_h), mode="reflect")
            lrs = x.permute(0, 2, 3, 1).reshape(n, t, h + pad_h,
                                                w + pad_w, c)
        seq = torch.cat([lrs[:, [4, 3]], lrs, lrs[:, [-4, -5]]], 1)
        wins = torch.stack([seq[:, i:i + 5] for i in keys], 1)
        feats = self.edvr(wins.reshape(n * len(keys), 5, *lrs.shape[2:]))
        return feats.reshape(n, len(keys), *feats.shape[1:])[:, :, :h, :w]

    # ---------------- propagation ----------------

    def _ir_step(self, branch, carry, x):
        """One IR propagation step (RefVSR_IR.py:283-347). x holds lr,
        conf, flow, aligned, aligned_up, the frame's refill features (None
        off keyframes) and, forward only, bw_out and up_flow."""
        with trace.span("refvsr.net.prop", x["lr"]):
            feat_prop, feat_prop_up, conf_prop = carry
            mid = feat_prop.shape[-1]
            if "up_flow" not in x:
                # conf rides the feature warp (same flow and grid); UP
                # warps the carried UP tensor
                packed = warp(torch.cat([feat_prop, conf_prop], -1),
                              x["flow"])
                feat_prop, conf_prop = packed[..., :mid], packed[..., mid:]
                feat_prop_up = warp(feat_prop_up, _flow_up2(x["flow"]))
            else:
                # forward at i > 0: UP warps the warped low-res feat, and UP
                # and conf take up_flow (the stale flow unless fixed)
                feat_prop = warp(feat_prop, x["flow"])
                feat_prop_up = warp(feat_prop, _flow_up2(x["up_flow"]))
                conf_prop = warp(conf_prop, x["up_flow"])
            if x["refill"] is not None:
                fusion = (self.backward_fusion if branch == "backward"
                          else self.forward_fusion)
                feat_prop = fusion(torch.cat([feat_prop, x["refill"]], -1))
            if branch == "backward":
                agg = self.backward_resblocks(
                    torch.cat([x["lr"], feat_prop], -1))
            else:
                agg = self.forward_resblocks(
                    torch.cat([x["lr"], x["bw_out"], feat_prop], -1))
            return self.rap(x["conf"], conf_prop, agg, feat_prop_up,
                            x["aligned"], x["aligned_up"])

    def _run(self, lrs, refs, state: StreamState, keyframe_mask, clamp_out,
             cached_flows=False):
        n, t, h, w = lrs.shape[:4]
        center = t // 2
        if keyframe_mask is None:
            keyframe_mask = sliding_keyframe_mask(t, self.keyframe_stride,
                                                  None)[0]
        keys = [int(i) for i in np.flatnonzero(np.asarray(keyframe_mask))]

        with torch.no_grad():
            if cached_flows:
                fwd_flows, bwd_flows = self._shift_cached_flows(lrs, state)
            else:
                fwd_flows, bwd_flows = self.compute_flows(lrs)
        confs, indices = self.compute_matching(lrs, refs)
        aligned = [self.compute_aligned(lrs[:, i], refs[:, i], indices[:, i])
                   for i in range(t)]
        refill = [None] * t
        if keys:
            feats = self.compute_refill_features(lrs, keys)
            for j, i in enumerate(keys):
                refill[i] = feats[:, j]

        def step_x(i, flow):
            return {"lr": lrs[:, i], "conf": confs[:, i], "flow": flow,
                    "aligned": aligned[i][0], "aligned_up": aligned[i][1],
                    "refill": refill[i]}

        # backward branch over frames t-1 .. 0; frame t-1 warps the zero
        # carry by a zero flow
        mid = self.mid_channels
        carry = (lrs.new_zeros((n, h, w, mid)),
                 lrs.new_zeros((n, 2 * h, 2 * w, mid)),
                 lrs.new_zeros((n, h, w, 1)))
        bw_out = [None] * t
        bw_center = None
        for i in range(t - 1, -1, -1):
            flow = (lrs.new_zeros((n, h, w, 2)) if i == t - 1
                    else bwd_flows[:, i])
            carry = self._ir_step("backward", carry, step_x(i, flow))
            bw_out[i] = carry[0]
            if i == center:
                bw_center = carry

        # forward step 0 warps the carried state by its saved flow
        # (RefVSR_IR.py:330: the saved UP tensor, not the low-res feat)
        x = step_x(0, state.flow)
        x["bw_out"] = bw_out[0]
        carry = self._ir_step(
            "forward", (state.feat_prop, state.feat_prop_up,
                        state.conf_prop), x)
        saved = carry
        stale = bwd_flows[:, 0]
        for i in range(1, center + 1):
            x = step_x(i, fwd_flows[:, i - 1])
            x["bw_out"] = bw_out[i]
            x["up_flow"] = (fwd_flows[:, i - 1] if self.fix_stale_flow_bug
                            else stale)
            carry = self._ir_step("forward", carry, x)

        out = self._finalize(lrs[:, center], bw_center, carry)
        if clamp_out:
            out = out.clamp(0.0, 1.0)
        new_state = StreamState(
            feat_prop=saved[0].detach(), feat_prop_up=saved[1].detach(),
            conf_prop=saved[2].detach(), flow=fwd_flows[:, 0],
            flows_fwd=fwd_flows, flows_bwd=bwd_flows)
        return out, new_state, (bw_center[2], carry[2], confs[:, center])

    # ---------------- entry points ----------------

    def forward_train(self, lrs, refs, state: StreamState,
                      keyframe_mask=None):
        """Training window: (out unclamped, new detached state); SPyNet's
        flows without gradients. keyframe_mask: bool (T,), default the first
        window's."""
        out, new_state, _ = self._run(lrs, refs, state, keyframe_mask,
                                      clamp_out=False)
        return out, new_state

    def forward_first(self, lrs, refs, keyframe_mask=None):
        """First window of a clip from a zero state: (out clamped to
        [0, 1], state, conf_vis)."""
        n, t, h, w = lrs.shape[:4]
        state = init_stream_state(n, h, w, self.mid_channels, lrs.dtype,
                                  num_frames=t, device=lrs.device)
        return self._run(lrs, refs, state, keyframe_mask, clamp_out=True)

    def forward_stream(self, lrs, refs, state: StreamState,
                       keyframe_mask=None):
        """Streamed window: the cached flows shifted by one plus one new
        SPyNet pair, everything else recomputed. (out, state, conf_vis)."""
        return self._run(lrs, refs, state, keyframe_mask, clamp_out=True,
                         cached_flows=True)

    def forward(self, lrs, refs, state: StreamState, keyframe_mask=None):
        return self.forward_train(lrs, refs, state, keyframe_mask)
