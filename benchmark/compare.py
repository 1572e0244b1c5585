"""The numbers that decide ``correct``: how far a served SR frame lies from
the reference's frame of the same window, and each number's limit.

- ``sr_rmse``: the root mean square of the difference over every value of
  the frame (4H x 4W x 3);
- ``sr_max_abs``: the largest absolute difference of one value;
- ``res_rel``: the same difference against what the network adds to the
  bicubic upscale of the window's centre frame (the reference's SR frame
  less that base): the L2 norm of the difference over the norm of the
  reference's residual. The base is the same on both sides, so this is
  the error of the residual, whichever layer puts it there (either
  branch, their fusion, the x4 tail), as a share of the residual;
- ``state_rel``: the carried state the window hands to the next one (its
  features ``feat_prop`` and ``feat_prop_up``): the L2 norm of the
  difference over the reference's norm, the larger of the two.

Each is the worst over the frames compared. A configuration holds the
numbers its ``limits`` name, each against its limit; a number that is not
finite fails."""

from __future__ import annotations

import math

import torch


def frame_numbers(served: torch.Tensor, ref: torch.Tensor,
                  served_state: dict, ref_state: dict,
                  base: torch.Tensor) -> dict:
    """served (1, 4H, 4W, 3) NHWC, any float dtype; ref and the bicubic
    base (1, 3, 4H, 4W) NCHW float32; the states {name: NHWC tensor} and
    {name: NCHW f32}."""
    d = served.float().permute(0, 3, 1, 2) - ref
    rel = 0.0
    for k, r in ref_state.items():
        e = served_state[k].float().permute(0, 3, 1, 2) - r
        rel = max(rel, float(torch.linalg.vector_norm(e)
                             / torch.linalg.vector_norm(r)))
    return {"sr_rmse": float(torch.sqrt((d * d).mean())),
            "sr_max_abs": float(d.abs().max()),
            "res_rel": float(torch.linalg.vector_norm(d)
                             / torch.linalg.vector_norm(ref - base)),
            "state_rel": rel}


def judge(per_frame: list, limits: dict):
    """(compared, failed frames): compared is {name: {"value", "limit"}}
    for each number `limits` names, the worst over `per_frame` (dicts of
    frame_numbers); a frame fails when one of those numbers is not finite
    or above its limit."""
    compared, failed = {}, 0
    for name, limit in limits.items():
        vals = [f[name] for f in per_frame]
        worst = max(vals, key=lambda v: math.inf if not math.isfinite(v)
                    else v)
        compared[name] = {"value": worst, "limit": limit}
    for f in per_frame:
        if any(not math.isfinite(f[n]) or f[n] > lim
               for n, lim in limits.items()):
            failed += 1
    return compared, failed
