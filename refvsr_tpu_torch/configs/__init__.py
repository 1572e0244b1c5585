"""Model and training configurations of the port.

Counterpart of ``refvsr_tpu/configs/__init__.py``: the same variant names,
the same defaults and the same scale rule (``_apply_scale_rules``), holding
the fields the streaming path, the serving predictor, the loss and the
trainer read."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class EvalConfig:
    # serving flags (refvsr_tpu/configs/__init__.py:22-26): is_gradio runs
    # the net with zero flows in place of SPyNet's (RefVSR.py:183-191)
    is_gradio: bool = False
    is_replicate: bool = False


@dataclass
class Config:
    # model
    scale: int = 4
    flag_HD_in: bool = False
    matching_ksize: int = 2
    num_blocks: int = 30
    mid_channels: int = 48
    frame_num: int = 7
    reset_branch: Optional[int] = 9
    # training (refvsr_tpu/configs/__init__.py:54,68-87)
    manual_seed: int = 1234
    batch_size: int = 8
    patch_size: int = 64
    lr_init: float = 2e-4
    lr_min: float = 1e-6
    gc: float = 1.0               # gradient clipping (global norm)
    LRS: str = "CA"               # CA | LD
    beta1: float = 0.9
    total_itr: int = 300000
    decay_period: tuple = (400000,)
    decay_rate: float = 0.25
    frame_itr_num: int = 9
    loss: str = "1*L1_lf+0.05*MFID_ref_X_mu+0.01*FID_hr"
    CX_vgg_layer: str = "relu3_4"
    is_amp: bool = False
    is_use_T: bool = False
    # pretrained third-party assets, loaded by the Trainer
    # (utils/convert.load_pretrained_assets); an absent file warns
    spynet_ckpt: Optional[str] = "./ckpt/SPyNet.pytorch"
    vgg19_ckpt: Optional[str] = "./ckpt/VGG19.pytorch"
    # streaming: L > 1 runs the pipelined lanes (models/refvsr.py), whose
    # outputs equal the plain stream's, L - 1 windows late; 0 = plain
    pipeline_lanes: int = 0

    EVAL: EvalConfig = field(default_factory=EvalConfig)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _apply_scale_rules(c: Config) -> Config:
    ksize = 4 if c.scale == 2 else 2
    if c.flag_HD_in:
        ksize *= c.scale
    return c.replace(matching_ksize=ksize)


# the ported fields of refvsr_tpu/configs/__init__.py:_VARIANTS
_VARIANTS = {
    "RefVSR_MFID": dict(),
    "RefVSR_MFID_8K": dict(patch_size=128, loss="1*L1_lf+0.1*MFID_ref",
                           CX_vgg_layer="relu4_4", is_use_T=True,
                           flag_HD_in=True, reset_branch=None,
                           total_itr=50000),
}


def get_config(name: str, **overrides) -> Config:
    """Build a Config for a variant name (with or without 'config_' prefix)."""
    key = name[len("config_"):] if name.startswith("config_") else name
    if key not in _VARIANTS:
        raise KeyError(f"unknown config {name!r}; have {sorted(_VARIANTS)}")
    c = _apply_scale_rules(Config(**_VARIANTS[key]))
    if overrides:
        c = _apply_scale_rules(c.replace(**overrides))
    return c
