"""Loss DSL and loss computation; counterpart of
``refvsr_tpu/losses/__init__.py``.

The spec string is the reference's 'w1*TYPE1+w2*TYPE2' (e.g.
'1*L1_lf+0.1*MFID_ref'). Types: MSE, L1, L1_lf and the contextual family
``(M)FID_(hr|ref)[_CoBi][_L1|_L2][_X_mu]``; unknown terms are warned about
and skipped, as the reference leaves them inert.

MFID: the SR frame is matched against every ref frame seen so far in the
sliding window; the contextual term runs over the n*t (SR, ref) pairs as one
batch, which couples the channel-mean centering across the whole ref set.
The SR frame's VGG features are computed once per batch item and repeated
over the t refs (the JAX package repeats the image and runs the VGG n*t
times; a VGG is per image, so the features are the same)."""

from __future__ import annotations

import re
import warnings

import torch
import torch.nn as nn

from refvsr_tpu_torch.losses.contextual import CXLoss
from refvsr_tpu_torch.ops.image import gaussian_lowpass
from refvsr_tpu_torch.ops.resize import resize

_BASIC = {"MSE", "L1", "L1_lf"}
_CX_RE = re.compile(r"^(M?FID)_(hr|ref)(_CoBi)?(_L1|_L2)?(_X_mu)?$")


def cx_options(ltype: str):
    """CXLoss keyword arguments for a contextual loss type, or None."""
    m = _CX_RE.match(ltype)
    if not m:
        return None
    _, _, cobi, dist, x_mu = m.groups()
    return dict(is_cobi=cobi is not None,
                loss_type={"_L1": "L1", "_L2": "L2", None: "cosine"}[dist],
                x_self_mu=x_mu is not None)


def parse_loss_spec(spec: str):
    """'1*L1_lf+0.1*MFID_ref' -> [(1.0, 'L1_lf'), (0.1, 'MFID_ref')].
    Unknown types are warned about and skipped (the reference's
    config_RefVSR_IR_MFID.py:25 carries the inert 'TFID_ref_X_mu')."""
    terms = []
    for part in spec.split("+"):
        part = part.strip()
        if not part:
            continue
        weight, ltype = part.split("*")
        if ltype not in _BASIC and cx_options(ltype) is None:
            warnings.warn(f"unknown loss type {ltype!r} in spec {spec!r} — "
                          "skipped (the reference treats unmatched terms as "
                          "inert)")
            continue
        terms.append((float(weight), ltype))
    return terms


def psnr(sr, hr, peak=1.0):
    """10*log10(peak / mse) (Loss.py:73-75)."""
    return 10.0 * torch.log10(peak / ((sr - hr) ** 2).mean())


class LossModule(nn.Module):
    """The weighted loss dict of one sliding-window step. Owns one CXLoss
    (with its own VGG) per contextual term, registered as ``cx_<type>``;
    these VGGs are frozen here, unlike the network's trainable matching
    prefix."""

    def __init__(self, spec: str, scale: int = 4, flag_HD_in: bool = False,
                 vgg_layer: str = "relu3_4"):
        super().__init__()
        self.spec, self.scale, self.flag_HD_in = spec, scale, flag_HD_in
        self.terms = parse_loss_spec(spec)
        for _, ltype in self.terms:
            opts = cx_options(ltype)
            if opts is not None:
                self.add_module(f"cx_{ltype}",
                                CXLoss(vgg_layer=vgg_layer, **opts))
        self.requires_grad_(False)

    def _compared(self, sr, hr):
        """The SR frame at the ground truth's size (HD input: downscaled
        by the scale, clipped)."""
        if self.flag_HD_in and hr.shape != sr.shape:
            return resize(sr, scale_factor=1.0 / self.scale, mode="bicubic",
                          align_corners=False).clamp(0, 1)
        return sr

    def _mfid(self, cx, sr, refs):
        """A contextual term of the SR frame against every ref frame of
        `refs` (N, T, ...), one batch of N*T pairs."""
        n, t = refs.shape[:2]
        xf = cx.features(sr)
        xf = xf[:, None].expand(n, t, *xf.shape[1:]).reshape(
            n * t, *xf.shape[1:])
        return cx.core(xf, cx.features(refs.reshape(n * t, *refs.shape[2:])))

    def vis_maps(self, sr, hr, refs):
        """The contextual terms' confidence maps, each min-max normalised
        per batch item, under the reference's names (Loss.py:112,123,133):
        {name: (N', hy, wy, 1) in [0, 1]}."""
        def norm_res_vis(m):
            flat = m.reshape(m.shape[0], -1)
            flat = flat - flat.amin(dim=1, keepdim=True)
            flat = flat / flat.amax(dim=1, keepdim=True).clamp_min(1e-12)
            return flat.reshape(m.shape)

        sr_cmp = self._compared(sr, hr)
        vis = {}
        for _, ltype in self.terms:
            cx = getattr(self, f"cx_{ltype}", None)
            if ltype.startswith("MFID_ref"):
                vis["contextual_ref_MFID_C"] = norm_res_vis(
                    self._mfid(cx, sr, refs)[1])
            elif ltype.startswith("FID_ref"):
                vis["contextual_ref_C"] = norm_res_vis(cx(sr, refs[:, -1])[1])
            elif ltype.startswith("FID_hr"):
                vis["contextual_hr_C_sh"] = norm_res_vis(cx(sr_cmp, hr)[1])
        return vis

    def forward(self, sr, hr, refs):
        """sr (N, H, W, 3) SR output; hr (N, h, w, 3) ground truth centre
        frame; refs (N, T_ref, hr_h, hr_w, 3) the ref frames seen so far.
        Returns a dict of scalar losses with 'total' and (detached)
        'PSNR'."""
        sr_cmp = self._compared(sr, hr)
        errs = {}
        total = 0.0
        for weight, ltype in self.terms:
            if ltype == "MSE":
                loss = ((sr_cmp - hr) ** 2).mean()
            elif ltype == "L1":
                loss = (sr_cmp - hr).abs().mean()
            elif ltype == "L1_lf":
                loss = (gaussian_lowpass(sr_cmp)
                        - gaussian_lowpass(hr)).abs().mean()
            else:
                cx = getattr(self, f"cx_{ltype}")
                if ltype.startswith("MFID_ref"):
                    loss, _ = self._mfid(cx, sr, refs)
                elif ltype.startswith("FID_ref"):
                    loss, _ = cx(sr, refs[:, -1])
                else:
                    # FID_hr: symmetric sr <-> hr (Loss.py:126-134)
                    loss = cx(sr_cmp, hr)[0] + cx(hr, sr_cmp)[0]
            errs[ltype] = weight * loss
            total = total + errs[ltype]
        errs["total"] = total
        errs["PSNR"] = psnr(sr_cmp, hr).detach()
        return errs
