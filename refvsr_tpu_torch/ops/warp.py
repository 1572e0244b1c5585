"""Flow-based backward warping (NHWC); counterpart of ``refvsr_tpu/ops/warp.py``.

The reference uses two different warpers:

1. ``warp()`` (models/utils.py:35-43 of the reference): base grid over the
   flow's size, flow normalised by the input size, ``grid_sample`` with
   align_corners=False and zeros padding:
   ``src = (i + f) * S/(S-1) - 0.5``. Every call goes to kernel K1
   (``ops/kernels/warp_sample.py``), which evaluates ``warp_coords`` itself;
   under spatial sharding, to its banded form.
2. ``flow_warp()`` (mmedit flow_warp.py, used inside SPyNet only):
   ``src = i + f``, align_corners=True, border padding. The JAX package never
   sends it to a kernel; here it is the plain sampler.
"""

from __future__ import annotations

import torch

from refvsr_tpu_torch.ops.kernels.warp_sample import (  # noqa: F401
    bilinear_sample, warp_coords, warp_sample)


def warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """RefVSR's propagation warp. x: (N, H, W, C); flow: (N, Ho, Wo, 2)
    pixel-space (fx, fy). The output takes the FLOW's spatial size. Under
    an active spatial context x and the flow are this rank's bands of rows
    and the banded K1 kernel samples the halo-extended band
    (``parallel/spatial.sharded_warp``)."""
    from refvsr_tpu_torch.parallel import spatial
    if spatial.active() is not None:
        return spatial.sharded_warp(x, flow)
    return warp_sample(x.contiguous(), flow.contiguous())


def flow_warp(x: torch.Tensor, flow: torch.Tensor,
              padding: str = "border") -> torch.Tensor:
    """mmedit flow_warp semantics: src = i + f (align_corners=True).
    x: (N, H, W, C); flow: (N, H, W, 2)."""
    _, h, w, _ = x.shape
    gy = torch.arange(h, dtype=torch.float32, device=x.device)[:, None]
    gx = torch.arange(w, dtype=torch.float32, device=x.device)[None, :]
    return bilinear_sample(x, gx + flow[..., 0].float(),
                           gy + flow[..., 1].float(), padding)
