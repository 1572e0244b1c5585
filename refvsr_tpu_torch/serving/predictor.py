"""Single image-pair serving adapter; counterpart of
``refvsr_tpu/serving/predictor.py``.

The pipeline of the reference's replicate.py:23-110: read the LR and
reference stills, center-crop each to at most 1280x720 (replicate.py:43-67),
crop to a multiple of 8, repeat into a 3-frame sequence (:87-88), run
``forward_first`` with the optical flow replaced by zeros (the ``is_gradio``
path, RefVSR.py:183-191) and write the SR frame as a PNG. The images are
read and written by ``data/png.py``; the net runs in ``compute_dtype`` (bf16
by default) on the card unless the caller asks for the CPU."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from refvsr_tpu_torch import resolve_device
from refvsr_tpu_torch.configs import Config, get_config
from refvsr_tpu_torch.data.png import read_image, write_image
from refvsr_tpu_torch.models.blocks import init_weights
from refvsr_tpu_torch.models.refvsr import RefVSRNet
from refvsr_tpu_torch.ops.image import refine_to_multiple
from refvsr_tpu_torch.utils.convert import (load_reference_state_dict,
                                            load_torch_checkpoint)
from refvsr_tpu_torch.utils.precision import cast_floating


def _crop_max(img, max_h=720, max_w=1280):
    """Center-crop to at most max_h x max_w (replicate.py:43-67)."""
    h, w = img.shape[:2]
    if h > max_h:
        top = (h - max_h) // 2
        img = img[top:top + max_h]
    if w > max_w:
        left = (w - max_w) // 2
        img = img[:, left:left + max_w]
    return img


class Predictor:
    """`config` defaults to RefVSR_MFID_8K; `net`, if given, is a RefVSRNet
    built with ``zero_flow=True`` and the config's widths, else one is
    built with random weights from seed 0 (``load_checkpoint`` fills
    it)."""

    def __init__(self, config: Config | None = None, net=None,
                 device="cuda", compute_dtype=torch.bfloat16):
        self.device = resolve_device(device)
        if config is None:
            config = get_config("RefVSR_MFID_8K")
        self.config = config.replace(EVAL=dataclasses.replace(
            config.EVAL, is_gradio=True, is_replicate=True))
        c = self.config
        if net is None:
            net = RefVSRNet(scale=c.scale, num_blocks=c.num_blocks,
                            mid_channels=c.mid_channels,
                            matching_ksize=c.matching_ksize,
                            flag_HD_in=c.flag_HD_in, zero_flow=True)
            init_weights(net, torch.Generator().manual_seed(0))
        widths = (net.scale, net.num_blocks, net.mid_channels,
                  net.matching_ksize, net.flag_HD_in)
        if not net.zero_flow or widths != (c.scale, c.num_blocks,
                                           c.mid_channels, c.matching_ksize,
                                           c.flag_HD_in):
            raise ValueError(f"the net (zero_flow={net.zero_flow}, widths "
                             f"{widths}) is not the config's zero-flow net")
        self.compute_dtype = compute_dtype
        self.net = cast_floating(net.to(self.device), compute_dtype).eval()

    def load_checkpoint(self, path: str):
        """Load a reference-keyed torch state dict (``.pytorch``, ``.pth``,
        ``.pt``) into the net, cast to the compute dtype. Returns
        (missing, unexpected) keys, as the JAX package's
        ``convert_state_dict(..., strict=False)`` reports them (the JAX
        zero-flow net holds no SPyNet, so it reports a checkpoint's FlowNet
        keys as unused where the port's net loads them); a flax msgpack
        checkpoint has no counterpart here and raises."""
        if not str(path).endswith((".pytorch", ".pth", ".pt")):
            raise ValueError(f"{path}: only torch state dicts (.pytorch, "
                             f".pth, .pt) load into the port")
        res = load_reference_state_dict(self.net, load_torch_checkpoint(path),
                                        strict=False)
        return list(res.missing_keys), list(res.unexpected_keys)

    def enhance(self, lr: np.ndarray, ref: np.ndarray) -> np.ndarray:
        """LR and reference images, (H, W, 3) float in [0, 1], cropped and
        run as a 3-frame sequence: the SR frame as (sH', sW', 3) float32
        numpy in [0, 1]."""
        lr = refine_to_multiple(_crop_max(lr), 8)
        ref = refine_to_multiple(_crop_max(ref), 8)

        def seq(img):
            x = torch.as_tensor(np.ascontiguousarray(img)).to(
                self.device, self.compute_dtype)
            return x[None, None].expand(1, 3, *x.shape).contiguous()
        with torch.inference_mode():
            out, _, _ = self.net.forward_first(seq(lr), seq(ref))
        return out[0].float().cpu().numpy()

    def predict(self, lr_path, ref_path, out_path="out.png"):
        """Super-resolve the PNG pair and write the result as a PNG
        (quantized as the JAX predictor does). Returns out_path."""
        out = self.enhance(read_image(lr_path), read_image(ref_path))
        write_image(out_path, out)
        return out_path
