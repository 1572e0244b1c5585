"""Contextual (CX) loss on VGG19 features (NHWC); counterpart of
``refvsr_tpu/losses/contextual.py``, with the same math:

  dist  = clamp(1 - x_n^T y_n, 0)                       (N, HWx, HWy)
  dist~ = dist / (min_y dist + 1e-5)
  cx    = w / (sum_y w + 1e-5),  w = exp((1 - dist~) / h)
  r     = max over x (value and argmax)
  c     = exp((1 - dist) / 0.5) at the argmax           (N, HWy)
  loss  = mean(-log(sum(r * c) / sum(c) + 1e-5))

The features, the distance matrix and the -log reduction are f32. The
distance product is a plain ``torch.matmul`` (the JAX package leaves it to
XLA, outside any Pallas kernel). The min and max reductions use
``amin``/``amax``, whose gradients split ties evenly, as JAX's do; they sit
in ``_nearest`` and ``_best``, which ``chip_smoke.py`` replaces to hold the
choices of one run to another's."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from refvsr_tpu_torch.models.blocks import vgg_normalize
from refvsr_tpu_torch.models.vgg import RELU_TAPS, VGGFeatures
from refvsr_tpu_torch.parallel.mesh import batch_mean


def _normalize(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(
        1e-12)


def _cosine_distance(x_feat, y_feat, x_self_mu):
    """1 - cosine similarity after channel-mean centering; the mean runs
    over batch and space, so it couples the batch (contextual.py:117), and
    a data-parallel step takes it over every rank's batch
    (``parallel.mesh.batch_mean``)."""
    n, _, _, c = y_feat.shape
    y_mu = batch_mean(y_feat, (0, 1, 2))
    x_mu = batch_mean(x_feat, (0, 1, 2)) if x_self_mu else y_mu
    x_n = _normalize(x_feat - x_mu).reshape(n, -1, c)
    y_n = _normalize(y_feat - y_mu).reshape(n, -1, c)
    return (1.0 - torch.matmul(x_n, y_n.transpose(1, 2))).clamp_min(0.0)


def _l2_distance(x_feat, y_feat):
    """Squared-L2 pairwise distance (contextual.py:140-154)."""
    n, _, _, c = x_feat.shape
    x = x_feat.reshape(n, -1, c)
    y = y_feat.reshape(n, -1, c)
    xs = (x * x).sum(-1)[:, :, None]
    ys = (y * y).sum(-1)[:, None, :]
    return (xs - 2.0 * torch.matmul(x, y.transpose(1, 2)) + ys).clamp_min(0.0)


def _l1_distance(x_feat, y_feat):
    """The reference's 'L1' distance (contextual.py:172-186): a degenerate
    |sum_c x - sum_c x| of x against itself (y unused), kept for parity."""
    xs = x_feat.sum(-1).reshape(x_feat.shape[0], -1)
    return (xs[:, None, :] - xs[:, :, None]).abs()


def _meshgrid_dist(n, h, w, device):
    """Spatial grid L2 distances for CoBi (contextual.py:56-65,77-80)."""
    rows = np.arange(h, dtype=np.float32) / (h + 1)
    cols = np.arange(w, dtype=np.float32) / (w + 1)
    gy, gx = np.meshgrid(rows, cols, indexing="ij")
    grid = np.stack([gy.reshape(-1), gx.reshape(-1)], axis=-1)
    d2 = ((grid[:, None, :] - grid[None, :, :]) ** 2).sum(-1)
    return torch.as_tensor(d2, device=device).expand(n, *d2.shape)


def _nearest(dist):
    """Each x position's smallest distance over y, (N, HWx, 1)."""
    return dist.amin(dim=2, keepdim=True)


def _best(cx):
    """Each y position's largest similarity over x and that x (the
    per-position picks), each (N, HWy)."""
    return cx.amax(dim=1), cx.argmax(dim=1)


def _cx_weights(dist, band_width):
    dist_t = dist / (_nearest(dist) + 1e-5)
    w = torch.exp((1.0 - dist_t) / band_width)
    return w / (w.sum(dim=2, keepdim=True) + 1e-5)


# CoBi's weight of the spatial term (contextual.py:82; no caller sets it)
_COBI_WEIGHT_SP = 0.1


def cx_core(x_feat, y_feat, band_width: float, x_self_mu: bool,
            loss_type: str = "cosine", is_cobi: bool = False):
    """x_feat/y_feat: (N, H, W, C) features. Returns (loss, c_map
    (N, Hy, Wy, 1))."""
    x_feat = x_feat.float()
    y_feat = y_feat.float()
    n, hy, wy, _ = y_feat.shape
    if loss_type == "cosine":
        dist = _cosine_distance(x_feat, y_feat, x_self_mu)
    elif loss_type == "L2":
        dist = _l2_distance(x_feat, y_feat)
    elif loss_type == "L1":
        dist = _l1_distance(x_feat, y_feat)
    else:
        raise ValueError(loss_type)
    cx = _cx_weights(dist, band_width)
    if is_cobi:
        # contextual_bilateral_loss (contextual.py:67-102): a spatial
        # meshgrid CX term mixed in
        d_sp = _meshgrid_dist(n, x_feat.shape[1], x_feat.shape[2],
                              x_feat.device)
        cx = ((1.0 - _COBI_WEIGHT_SP) * cx
              + _COBI_WEIGHT_SP * _cx_weights(d_sp, band_width))
    r_val, r_idx = _best(cx)                         # (N, HWy)
    sim = torch.exp((1.0 - dist) / 0.5)
    c_map = torch.gather(sim, 1, r_idx[:, None, :])[:, 0, :]
    cx_agg = (r_val * c_map).sum(dim=1) / c_map.sum(dim=1)
    loss = (-torch.log(cx_agg + 1e-5)).mean()
    return loss, c_map.reshape(n, hy, wy, 1)


class CXLoss(nn.Module):
    """VGG19-backed contextual loss (models/loss/contextual.py:188-246). Its
    VGG (``vgg``, torchvision indices) is the loss's own, frozen by the
    caller."""

    def __init__(self, vgg_layer: str = "relu3_4", band_width: float = 0.5,
                 x_self_mu: bool = False, loss_type: str = "cosine",
                 is_cobi: bool = False):
        super().__init__()
        self.vgg_layer, self.band_width = vgg_layer, band_width
        self.x_self_mu, self.loss_type, self.is_cobi = (x_self_mu, loss_type,
                                                        is_cobi)
        self.vgg = VGGFeatures(RELU_TAPS[vgg_layer] + 1, taps=(vgg_layer,))

    def features(self, img):
        """img (N, H, W, 3) in [0, 1] -> its tapped VGG features."""
        return self.vgg.features(vgg_normalize(img))[1][self.vgg_layer]

    def core(self, x_feat, y_feat):
        return cx_core(x_feat, y_feat, self.band_width, self.x_self_mu,
                       loss_type=self.loss_type, is_cobi=self.is_cobi)

    def forward(self, x_img, y_img):
        """x_img/y_img: (N, H, W, 3) in [0, 1]. Returns (loss, c_map)."""
        return self.core(self.features(x_img), self.features(y_img))
