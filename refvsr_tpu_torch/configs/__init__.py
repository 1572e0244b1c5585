"""Config system of the port; counterpart of
``refvsr_tpu/configs/__init__.py``, field for field.

Layering as there: defaults -> variant overrides (by --config name) -> CLI
overrides -> derived data paths (``set_data_path``). A training run writes
its config as ``config.json`` (``save_config``), which ``load_config``
reads back, from either package.

Fields that act only where the port has no counterpart yet are kept so that
a ``config.json`` round-trips: ``spatial_devices``/``spatial_halo`` (values
above 1 are refused by ``run.main``, ROADMAP Queue 1, item 7) and
``keyframe_stride`` with ``network="RefVSR_IR"`` (``build_refvsr`` and the
Trainer refuse it, Queue 1, item 5)."""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class EvalConfig:
    eval_mode: str = "quan_qual"
    is_debug: bool = False
    # serving flags: is_gradio runs the net with zero flows in place of
    # SPyNet's (RefVSR.py:183-191)
    is_gradio: bool = False
    is_replicate: bool = False
    data: str = "RealMCVSR"
    test_set: str = "test"
    load_ckpt_by_score: bool = True
    ckpt_name: Optional[str] = None
    ckpt_epoch: Optional[int] = None
    ckpt_abs_name: Optional[str] = None
    ckpt_load_path: Optional[str] = None
    quantitative_only: bool = False
    qualitative_only: bool = False
    vid_name: Optional[list] = None
    LR_data_path: Optional[str] = None
    HR_data_path: Optional[str] = None
    HR_ref_data_W_path: Optional[str] = None
    HR_ref_data_T_path: Optional[str] = None


@dataclass
class Config:
    # global
    project: str = "RefVSR_TPU"
    mode: str = ""
    config: str = ""
    is_train: bool = False
    data: str = "RealMCVSR"
    data_offset: str = "./datasets"
    output_offset: Optional[str] = None
    log_offset: str = "./logs"
    manual_seed: int = 1234
    is_verbose: bool = False
    save_sample: bool = False
    resume: Optional[int] = None
    resume_abs: Optional[str] = None
    note: Optional[str] = None

    # multi-chip spatial serving of the JAX package; kept for config.json
    # round trips, refused above 1 (ROADMAP Queue 1, item 7)
    spatial_devices: int = 1
    spatial_halo: int = 32

    # training
    trainer: str = "trainer"
    network: str = "RefVSR"
    batch_size: int = 8
    batch_size_test: int = 1
    patch_size: int = 64
    lr_init: float = 2e-4
    lr_min: float = 1e-6
    gc: float = 1.0               # gradient clipping (global norm)
    LRS: str = "CA"               # CA | LD
    beta1: float = 0.9
    total_itr: int = 300000
    decay_period: tuple = (400000,)
    decay_rate: float = 0.25
    frame_num: int = 7
    frame_itr_num: int = 9
    loss: str = "1*L1_lf+0.05*MFID_ref_X_mu+0.01*FID_hr"
    CX_vgg_layer: str = "relu3_4"
    is_amp: bool = False          # bf16 compute, f32 master weights
    is_use_T: bool = False
    is_crop_valid: bool = False
    crop_valid_offset: int = 12
    thread_num: int = 4

    # pretrained third-party assets, loaded by the Trainer
    # (utils/convert.load_pretrained_assets); an absent file warns
    spynet_ckpt: Optional[str] = "./ckpt/SPyNet.pytorch"
    vgg19_ckpt: Optional[str] = "./ckpt/VGG19.pytorch"

    # model
    scale: int = 4
    flag_HD_in: bool = False
    matching_ksize: int = 2
    num_blocks: int = 30
    mid_channels: int = 48
    reset_branch: Optional[int] = 9
    keyframe_stride: int = 5      # RefVSR_IR only
    refine_val_lr: int = 1
    refine_val_hr: int = 1
    # streaming: L > 1 runs the pipelined lanes (models/refvsr.py), whose
    # outputs equal the plain stream's, L - 1 windows late; 0 = plain
    pipeline_lanes: int = 0

    # checkpoints / logging
    max_ckpt_num: int = 100
    write_ckpt_every_epoch: int = 4
    write_log_every_itr_train: int = 180
    write_log_every_itr_valid: int = 20

    # data paths (derived; set_data_path)
    LR_data_path: Optional[str] = None
    HR_data_path: Optional[str] = None
    HR_ref_data_W_path: Optional[str] = None
    HR_ref_data_T_path: Optional[str] = None
    VAL_LR_data_path: Optional[str] = None
    VAL_HR_data_path: Optional[str] = None
    VAL_HR_ref_data_W_path: Optional[str] = None
    VAL_HR_ref_data_T_path: Optional[str] = None
    UW_path: str = "UW"
    W_path: str = "W"
    T_path: str = "T"

    EVAL: EvalConfig = field(default_factory=EvalConfig)

    @property
    def log_dir(self):
        return os.path.join(self.log_offset, self.project, self.mode)

    @property
    def ckpt_dir(self):
        return os.path.join(self.log_dir, "checkpoint", "train", "epoch",
                            "ckpt")

    @property
    def state_dir(self):
        return os.path.join(self.log_dir, "checkpoint", "train", "epoch",
                            "state")

    @property
    def result_dir(self):
        return self.output_offset or os.path.join(self.log_dir, "result")

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _apply_scale_rules(c: Config) -> Config:
    ksize = 4 if c.scale == 2 else 2
    if c.flag_HD_in:
        ksize *= c.scale
    return c.replace(matching_ksize=ksize)


_VARIANTS = {
    "RefVSR_MFID": dict(),
    "RefVSR_L1": dict(frame_itr_num=26, frame_num=13, loss="1*L1",
                      reset_branch=26),
    "RefVSR_small_MFID": dict(is_amp=True, num_blocks=24, mid_channels=24),
    "RefVSR_small_L1": dict(is_amp=True, num_blocks=24, mid_channels=24,
                            frame_itr_num=26, frame_num=13, loss="1*L1",
                            reset_branch=26),
    "RefVSR_MFID_8K": dict(patch_size=128, loss="1*L1_lf+0.1*MFID_ref",
                           CX_vgg_layer="relu4_4", is_use_T=True,
                           flag_HD_in=True, reset_branch=None,
                           total_itr=50000, write_ckpt_every_epoch=1),
    "RefVSR_small_MFID_8K": dict(patch_size=128, loss="1*L1_lf+0.1*MFID_ref",
                                 CX_vgg_layer="relu4_4", is_use_T=True,
                                 flag_HD_in=True, is_amp=True, frame_num=3,
                                 num_blocks=24, mid_channels=24,
                                 reset_branch=9, total_itr=50000,
                                 write_ckpt_every_epoch=1),
    # the loss spec is the reference's, verbatim: 'TFID_ref_X_mu' matches
    # no loss branch and is warned about and skipped (losses/__init__.py)
    "RefVSR_IR_MFID": dict(network="RefVSR_IR", frame_itr_num=5, frame_num=9,
                           loss="1*L1_lf+0.05*TFID_ref_X_mu+0.01*FID_hr",
                           mid_channels=36, reset_branch=5),
    "RefVSR_IR_L1": dict(network="RefVSR_IR", frame_itr_num=26, frame_num=13,
                         loss="1*L1", mid_channels=36, reset_branch=26),
}


def get_config(name: str, **overrides) -> Config:
    """Build a Config for a variant name (with or without 'config_' prefix)."""
    key = name[len("config_"):] if name.startswith("config_") else name
    if key not in _VARIANTS:
        raise KeyError(f"unknown config {name!r}; have {sorted(_VARIANTS)}")
    c = Config(config=key).replace(**_VARIANTS[key])
    c = _apply_scale_rules(c)
    c = c.replace(write_log_every_itr_train=20 * c.frame_itr_num)
    if overrides:
        c = _apply_scale_rules(c.replace(**overrides))
    return c


def set_data_path(c: Config, is_train: bool) -> Config:
    """Derive the dataset directories: {split}/{HR,LRx2,LRx4}/{UW,W,T}."""
    if c.data != "RealMCVSR":
        return c
    if not c.flag_HD_in:
        lr = "LRx2" if c.scale == 2 else "LRx4"
        ref_w, ref_t = "LRx2", "LRx4"
    else:
        lr = ref_w = ref_t = "HR"
    root = os.path.join(c.data_offset, c.data)
    if is_train:
        return c.replace(
            LR_data_path=os.path.join(root, "train", lr),
            HR_data_path=os.path.join(root, "train", "HR"),
            HR_ref_data_W_path=os.path.join(root, "train", ref_w),
            HR_ref_data_T_path=os.path.join(root, "train", ref_t),
            VAL_LR_data_path=os.path.join(root, "valid", lr),
            VAL_HR_data_path=os.path.join(root, "valid", "HR"),
            VAL_HR_ref_data_W_path=os.path.join(root, "valid", ref_w),
            VAL_HR_ref_data_T_path=os.path.join(root, "valid", ref_t))
    split = c.EVAL.test_set
    return c.replace(EVAL=dataclasses.replace(
        c.EVAL,
        LR_data_path=os.path.join(root, split, lr),
        HR_data_path=os.path.join(root, split, "HR"),
        HR_ref_data_W_path=os.path.join(root, split, ref_w),
        HR_ref_data_T_path=os.path.join(root, split, ref_t)))


def save_config(c: Config, path: str):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(c), f, indent=4, default=str)


def load_config(path: str) -> Config:
    """A Config from a ``config.json``; unknown keys warn and are dropped,
    so a misspelt field never falls back to its default silently."""
    with open(path) as f:
        d = json.load(f)
    ev = d.pop("EVAL", {})
    known = {f.name for f in dataclasses.fields(Config)}
    ev_known = {f.name for f in dataclasses.fields(EvalConfig)}
    unknown = sorted([k for k in d if k not in known] +
                     [f"EVAL.{k}" for k in ev if k not in ev_known])
    if unknown:
        warnings.warn(f"config '{path}' has unknown keys (dropped): "
                      f"{unknown}")
    d = {k: v for k, v in d.items() if k in known}
    ev = {k: v for k, v in ev.items() if k in ev_known}
    if isinstance(d.get("decay_period"), list):     # JSON has no tuples
        d["decay_period"] = tuple(d["decay_period"])
    return Config(**d, EVAL=EvalConfig(**ev))
