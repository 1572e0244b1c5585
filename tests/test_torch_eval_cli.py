"""The port's evaluation CLI (``python -m refvsr_tpu_torch.run`` without
``--is_train``) beside the JAX package's ``run.main`` on the same tree and
checkpoint, on the CPU in f32.

The tree: a RealMCVSR test split of three videos (3, 2 and 3 frames; LRx4
16x16, LRx2 32x32, HR 64x64) written by PIL. Each run has no ``--config``:
it rebuilds the tiny config from the training run's ``config.json``
(RefVSR_IR_MFID with 2 blocks, 8 channels, T = 5, ``keyframe_stride`` 2,
``reset_branch`` 3; and RefVSR_MFID_8K with 2 blocks, 8 channels, T = 3),
and both load the same reference-keyed ``.pytorch`` checkpoint by
``--ckpt_abs_name``. The JAX Trainer's ``init_state`` is replaced by one
that only shapes the parameters (its own runs the net's init eagerly,
minutes for the IR net); the checkpoint then fills every leaf.

Compared: the score files line for line, apart from the seconds, with each
PSNR/SSIM within 1e-4 (outputs within ~1e-6 of each other, as the net
tests hold; the metrics are float64 of those); the PNG dumps within one
level of 255 (a value at a rounding boundary) and the JPEG dumps, both
decoded by PIL, within a mean of 1 level (tests/test_torch_eval.py); the
confidence maps' files by name, decoded within one inferno step."""

import glob
import os
import re
import warnings

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import run as jax_run
from conftest import write_clip_triplet
from refvsr_tpu.models.refvsr import init_stream_state as jax_init_state
from refvsr_tpu.train import trainer as jax_trainer
from refvsr_tpu_torch import run
from refvsr_tpu_torch.configs import get_config, save_config
from refvsr_tpu_torch.data.png import read_image
from refvsr_tpu_torch.models.blocks import init_weights
from refvsr_tpu_torch.models.refvsr import RefVSRNet
from torch_ir_nets import port_net

torch.set_num_threads(2)

VIDEOS = (("0003", 3), ("0004", 2), ("0005", 3))
TINY = dict(num_blocks=2, mid_channels=8, spynet_ckpt=None, vgg19_ckpt=None)


def _shape_only_init_state(self, batch):
    """The JAX Trainer's parameters as zeros of their shapes (the eval
    loads every leaf from the checkpoint)."""
    cfg = self.config
    t = cfg.frame_num
    lrs = np.asarray(batch["LR_UW"][:, :t])
    refs = np.asarray(batch["LR_REF_W"][:, :t])
    n, _, h, w, _ = lrs.shape
    args = (lrs, refs, jax_init_state(n, h, w, cfg.mid_channels,
                                      num_frames=t))
    if cfg.network == "RefVSR_IR":
        args += (np.ones(t, bool),)
    shapes = jax.eval_shape(lambda: self.net.init(jax.random.PRNGKey(0),
                                                  *args))
    params = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                    shapes)
    return jax_trainer.TrainState(params=params, opt_state=None,
                                  step=np.zeros((), np.int32)), None


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_cli")
    for i, (clip, n) in enumerate(VIDEOS):
        for j, cam in enumerate(("UW", "W", "T")):
            write_clip_triplet(root / "RealMCVSR", "test", cam, clip, n, 16,
                               16, seed=10 * i + j)
    logs = root / "logs"
    nets = {"tinyir": port_net(seed=6)}
    hd = RefVSRNet(scale=4, num_blocks=2, mid_channels=8, matching_ksize=8,
                   flag_HD_in=True)
    init_weights(hd, torch.Generator().manual_seed(7))
    nets["tiny8k"] = hd
    cfgs = {"tinyir": get_config("RefVSR_IR_MFID", frame_num=5,
                                 keyframe_stride=2, reset_branch=3, **TINY),
            "tiny8k": get_config("RefVSR_MFID_8K", frame_num=3, **TINY)}
    for mode, cfg in cfgs.items():
        save_config(cfg.replace(mode=mode), str(
            logs / "RefVSR_TPU" / mode / "config" / "config.json"))
        torch.save(nets[mode].state_dict(), str(root / f"{mode}.pytorch"))
    return root


_RUNS = {}


def _run(setup, key, mode, *extra):
    """(JAX result dir, port result dir) of one eval through each CLI."""
    if key in _RUNS:
        return _RUNS[key]
    dirs = []
    for side, main in (("jax", jax_run.main), ("port", run.main)):
        out = setup / "out" / key / side
        argv = ["--mode", mode, "-cpu", "--data_offset", str(setup),
                "--log_offset", str(setup / "logs"), "--output_offset",
                str(out), "--ckpt_abs_name", str(setup / f"{mode}.pytorch"),
                *extra]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jax_trainer.Trainer, "init_state",
                           _shape_only_init_state)
                main(argv)
        assert not [w for w in caught if "did not fully map" in
                    str(w.message)], side
        (d,) = glob.glob(str(out / "RealMCVSR" / f"*_{mode}.pytorch"))
        dirs.append(d)
    _RUNS[key] = tuple(dirs)
    return _RUNS[key]


_NUM = re.compile(r"(PSNR: |SSIM: |%: )(-?\d+\.\d+)")
_SEC = re.compile(r"\(\d+\.\d+sec\)")


def _compare_scores(path_j, path_t):
    with open(path_j) as f:
        want = f.read().splitlines()
    with open(path_t) as f:
        got = f.read().splitlines()
    assert len(got) == len(want)
    for lw, lg in zip(want, got):
        lw, lg = _SEC.sub("(sec)", lw), _SEC.sub("(sec)", lg)
        assert _NUM.sub(r"\1#", lw) == _NUM.sub(r"\1#", lg)
        vw = [float(v) for _, v in _NUM.findall(lw)]
        vg = [float(v) for _, v in _NUM.findall(lg)]
        np.testing.assert_allclose(vg, vw, rtol=0, atol=1e-4, err_msg=lw)
    return got


def _score_file(d, mode):
    (p,) = glob.glob(os.path.join(d, f"score_RealMCVSR_{mode}.txt"))
    return p


def test_ir_quan_qual_scores_match_jax(setup):
    dj, dt = _run(setup, "ir_qq", "tinyir", "--eval_mode", "quan_qual")
    got = _compare_scores(_score_file(dj, "quan_qual"),
                          _score_file(dt, "quan_qual"))
    frames = [ln for ln in got if ln.startswith("[EVAL")]
    assert len(frames) == sum(n for _, n in VIDEOS)
    assert sum(ln.startswith("[MEAN") for ln in got) == 2
    assert got[-1].startswith("[TOTAL tinyir.pytorch|RealMCVSR] PSNR: ")


def test_ir_quan_qual_dumps_match_jax(setup):
    dj, dt = _run(setup, "ir_qq", "tinyir", "--eval_mode", "quan_qual")
    names = sorted(os.path.relpath(p, dj) for p in glob.glob(
        os.path.join(dj, "*", "*", "*", "*")))
    assert names == sorted(os.path.relpath(p, dt) for p in glob.glob(
        os.path.join(dt, "*", "*", "*", "*")))
    assert len(names) == 2 * 2 * sum(n for _, n in VIDEOS)
    for name in names:
        if name.endswith(".png"):
            a, b = read_image(os.path.join(dt, name)), read_image(
                os.path.join(dj, name))
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= 1 / 255 + 1e-6, name
        else:
            a, b = (np.asarray(Image.open(os.path.join(d, name)), float)
                    for d in (dt, dj))
            assert a.shape == b.shape
            assert np.abs(a - b).mean() < 1.0, name
    shape = read_image(os.path.join(dt, "png", "output", "0003",
                                    "0000.png")).shape
    assert shape == (64, 64, 3)
    # the evaluated weights beside the results, those of the checkpoint
    saved = torch.load(os.path.join(dt, "tinyir.ckpt"), weights_only=True)
    ckpt = torch.load(str(setup / "tinyir.pytorch"), weights_only=True)
    assert set(saved) == set(ckpt)
    assert all(torch.equal(saved[k], ckpt[k]) for k in ckpt)


def test_ir_vid_name_skipping_matches_jax(setup):
    """Videos 0003 and 0005: the skipped 0004 inflates 0003's MEAN
    denominator, in both packages."""
    dj, dt = _run(setup, "ir_vid", "tinyir", "--eval_mode", "quan_qual",
                  "--quantitative_only", "--vid_name", "0003", "0005")
    got = _compare_scores(_score_file(dj, "quan_qual"),
                          _score_file(dt, "quan_qual"))
    assert sum(ln.startswith("[EVAL") for ln in got) == 6
    assert sum(ln.startswith("[MEAN") for ln in got) == 1
    assert not glob.glob(os.path.join(dt, "png"))


def test_ir_fov_scores_match_jax(setup):
    dj, dt = _run(setup, "ir_fov", "tinyir", "--eval_mode", "FOV")
    got = _compare_scores(_score_file(dj, "FOV"), _score_file(dt, "FOV"))
    assert sum(ln.startswith("[EVAL") for ln in got) == 8
    assert any(ln.startswith("[PSNR-FOV_ring] (50.0-100.0%: ")
               for ln in got)


def test_ir_conf_maps_match_jax(setup):
    dj, dt = _run(setup, "ir_conf", "tinyir", "--eval_mode", "conf")
    names = sorted(os.path.relpath(p, dj)
                   for p in glob.glob(os.path.join(dj, "conf", "*", "*")))
    assert names == sorted(os.path.relpath(p, dt) for p in glob.glob(
        os.path.join(dt, "conf", "*", "*")))
    assert len(names) == 4 * 8
    for name in names:
        a, b = (read_image(os.path.join(d, name)) for d in (dt, dj))
        assert a.shape == b.shape == (16, 16, 3)
        # a map value at an index boundary may take the next entry
        assert np.abs(a - b).max() <= 8 / 255, name


def test_hd_in_quantitative_scores_match_jax(setup):
    """RefVSR_MFID_8K's wiring, metrics on the SR frame downscaled by 1/4
    on the device (no dumps)."""
    dj, dt = _run(setup, "hd_qq", "tiny8k", "--eval_mode", "quan_qual",
                  "--quantitative_only")
    got = _compare_scores(_score_file(dj, "quan_qual"),
                          _score_file(dt, "quan_qual"))
    assert sum(ln.startswith("[EVAL") for ln in got) == 8


def test_eval_refuses_a_missing_named_checkpoint(setup):
    with pytest.raises(FileNotFoundError):
        run.main(["--mode", "tinyir", "-cpu", "--data_offset", str(setup),
                  "--log_offset", str(setup / "logs"), "--output_offset",
                  str(setup / "out" / "missing"), "--ckpt_name",
                  "nothing_here.ckpt"])
