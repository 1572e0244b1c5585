"""Seeded weights, made on the device in a few large draws.

The distributions are those of the model's own initialisation: every
convolution uniform in +-1/sqrt(fan_in) for its weight and bias (PyTorch's
default), except the convolutions of the mmedit residual blocks of the two
propagation chains, whose weights are kaiming-normal times 0.1 (mmedit's
``default_init_weights``). The trained SPyNet and VGG19 are not in the
repository, so they are drawn the same way. Keys and shapes come from the
program's state dict; the values are the benchmark's."""

from __future__ import annotations

import math
import re

import torch

# weights of ResidualBlockNoBN (mmedit) inside ResidualBlocksWithInputConv
_SCALED = re.compile(r"resblocks\.main\.2\.\d+\.conv[12]\.weight$")


def _fan_in(shape):
    fan = 1
    for d in shape[1:]:
        fan *= d
    return fan


def make(shapes: dict, seed: int, dtype: torch.dtype, device) -> dict:
    """{key: tensor} for `shapes` ({key: shape} of convolution weights
    (O, I, kh, kw) and biases (O,), a bias after its weight), drawn from
    `seed` on `device` and cast to `dtype`: one uniform and one normal
    draw for the whole state dict."""
    gen = torch.Generator(device=device).manual_seed(seed)
    keys = list(shapes)
    fan = {}
    for k in keys:
        if k.endswith(".weight"):
            fan[k[:-len(".weight")]] = _fan_in(shapes[k])
    normal = [k for k in keys if _SCALED.search(k)]
    uniform = [k for k in keys if not _SCALED.search(k)]

    def count(ks):
        return sum(math.prod(shapes[k]) for k in ks)
    u = torch.rand(count(uniform), generator=gen, device=device)
    n = torch.randn(count(normal), generator=gen, device=device)
    out, off = {}, {"u": 0, "n": 0}
    for k in keys:
        size = math.prod(shapes[k])
        f = fan[k.rsplit(".", 1)[0]]
        if k in normal:
            v = n[off["n"]:off["n"] + size] * (math.sqrt(2.0 / f) * 0.1)
            off["n"] += size
        else:
            v = (u[off["u"]:off["u"] + size] * 2 - 1) / math.sqrt(f)
            off["u"] += size
        out[k] = v.view(shapes[k]).to(dtype)
    return out
