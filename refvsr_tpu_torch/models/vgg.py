"""VGG19 feature prefixes (NHWC) for feature matching and the contextual
losses; counterpart of ``refvsr_tpu/models/vgg.py``. Convs are registered
under their torchvision ``features`` index, so ``feature_extract.<idx>.weight``
keys load unchanged."""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from refvsr_tpu_torch.models.blocks import Conv2d

_VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]

# layer name -> torchvision features index after which it is tapped
RELU_TAPS = {
    "relu1_2": 3, "relu2_2": 8, "relu3_4": 17, "relu4_4": 26, "relu5_4": 35,
}


def _layer_schedule():
    """(torchvision_index, kind, in_channels, out_channels) of
    vgg19().features."""
    idx, cin = 0, 3
    for c in _VGG19_CFG:
        if c == "M":
            yield idx, "pool", None, None
            idx += 1
        else:
            yield idx, "conv", cin, c
            yield idx + 1, "relu", None, None
            idx, cin = idx + 2, c


class VGGFeatures(nn.Module):
    """vgg19.features up to ``max_index`` (exclusive); ``taps`` names the
    ``RELU_TAPS`` activations that ``features`` also returns."""

    def __init__(self, max_index: int, taps: tuple = ()):
        super().__init__()
        self.schedule = [s for s in _layer_schedule() if s[0] < max_index]
        for idx, kind, cin, cout in self.schedule:
            if kind == "conv":
                self.add_module(str(idx), Conv2d(cin, cout, 3))
        self.out_channels = next(s[3] for s in reversed(self.schedule)
                                 if s[1] == "conv")
        self.taps = {RELU_TAPS[t]: t for t in taps}

    def features(self, x):
        """(last activation, {tap name: activation})."""
        tapped = {}
        for idx, kind, _, _ in self.schedule:
            if kind == "conv":
                x = getattr(self, str(idx))(x)
            elif kind == "relu":
                x = F.relu(x)
            else:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(
                    0, 2, 3, 1)
            if idx in self.taps:
                tapped[self.taps[idx]] = x
        return x, tapped

    def forward(self, x):
        return self.features(x)[0]
