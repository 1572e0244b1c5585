"""The port's training entry point against the JAX package's, on the CPU.

The tiny config of ``tests/test_train_e2e.py`` (RefVSR_MFID wiring, 2
blocks, 8 channels, T = 3, frame_itr_num 2, patch 16, batch 1, total_itr 4,
a checkpoint every epoch) with the 8K loss '1*L1_lf+0.1*MFID_ref' so that
the contextual sample tiles exist, on the shared synthetic PNG tree
(``fake_dataset``, ``tests/conftest.py``). The JAX ``Runner`` draws its initial weights; the
port's ``Runner`` starts from them through ``utils/convert.params_from_jax``
and ``loss_params_from_jax``. Both train one epoch (2 batches, 4 steps) with
validation and sample tiles. Tolerances:

- per-epoch mean errors and per-step scalars rtol 2e-4 plus atol 1e-6, the
  precedent of ``tests/test_torch_train.py`` (steps on parameters that
  Adam's near-sign updates moved);
- validation PSNR atol 1e-3 dB (8 streamed windows through the moved
  weights; f32 convolutions summed in another order);
- ``LossModule.vis_maps`` atol 1e-5 on [0, 1] maps; the
  ``AlignedAttention(return_fm=True)`` tile atol 2e-4, the full-net
  precedent of ``tests/test_torch_refvsr.py``.

The CLI (``run.main`` with ``-cpu``) writes the JAX package's log tree
(its ``run.main`` builds the same ``Runner``), and validation leaves the
trainer's net as it was (the bf16 policy included)."""

import os
import warnings

import jax
import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_file_loader import \
    LegacyEventFileLoader

from refvsr_tpu.configs import get_config as jax_get_config
from refvsr_tpu.configs import set_data_path as jax_set_data_path
from refvsr_tpu.train.runner import Runner as JaxRunner
from refvsr_tpu_torch.configs import get_config, set_data_path
from refvsr_tpu_torch.data.png import read_image
from refvsr_tpu_torch.eval.stream import StreamRunner
from refvsr_tpu_torch.train.runner import Runner
from refvsr_tpu_torch.utils.convert import (loss_params_from_jax,
                                            params_from_jax)

torch.set_num_threads(2)

TINY = dict(is_train=True, batch_size=1, patch_size=16, frame_num=3,
            frame_itr_num=2, num_blocks=2, mid_channels=8, reset_branch=2,
            loss="1*L1_lf+0.1*MFID_ref", total_itr=4,
            write_ckpt_every_epoch=1, write_log_every_itr_train=2,
            thread_num=0, save_sample=True, spynet_ckpt=None,
            vgg19_ckpt=None)


def _configs(dataset, logs, **kw):
    kw = dict(TINY, mode="tiny", data_offset=dataset, log_offset=logs, **kw)
    return (jax_set_data_path(jax_get_config("RefVSR_MFID", **kw), True),
            set_data_path(get_config("RefVSR_MFID", **kw), True))


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _scalars(log_dir):
    d = os.path.join(log_dir, "log", "train", "scalar")
    out = {}
    for name in sorted(os.listdir(d)):
        for e in LegacyEventFileLoader(os.path.join(d, name)).Load():
            for v in e.summary.value:
                out[(v.tag, e.step)] = v.simple_value
    return out


def _ckpt_lines(log_dir):
    with open(os.path.join(log_dir, "checkpoint", "train", "epoch",
                           "checkpoints.txt")) as f:
        return [l.split(" ") for l in f.read().splitlines()]


@pytest.fixture(scope="module")
def runs(fake_dataset, tmp_path_factory):
    """One epoch of each Runner from the same initial weights; the vis
    tiles of both on one validation item before training."""
    logs = tmp_path_factory.mktemp("runner_logs")
    cj, ct = _configs(fake_dataset, str(logs / "jax"))
    _, ct = _configs(fake_dataset, str(logs / "port"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the assets are absent
        jr = JaxRunner(cj)
        jr._init_params()
        tr = Runner(ct, device="cpu")
    tr.trainer.net.load_state_dict(params_from_jax(_np_tree(jr.ts.params)),
                                   strict=True)
    tr.trainer.loss_mod.load_state_dict(
        loss_params_from_jax(_np_tree(jr.loss_params)), strict=True)

    t = ct.frame_num
    item = tr.valid_ds[1]
    sr = np.random.default_rng(3).random((256, 256, 3)).astype(np.float32)
    vis = dict(fm=(jr._warped_ref_vis(item, t), tr._warped_ref_vis(item, t)),
               cx=(jr._loss_cx_vis(item, sr, t), tr._loss_cx_vis(item, sr,
                                                                  t)))
    jr.train(max_epochs=1)
    jr.tb.flush()
    tr.train(max_epochs=1)
    tr.close()
    return dict(jax=jr, port=tr, cj=cj, ct=ct, vis=vis)


def test_epoch_scalars_match_jax(runs):
    want = _scalars(runs["cj"].log_dir)
    got = _scalars(runs["ct"].log_dir)
    assert set(got) == set(want)
    tags = {tag for tag, _ in got}
    assert {"train_epoch/total", "train_epoch/lr", "train_epoch/PSNR",
            "valid_epoch/PSNR", "train_itr/total"} <= tags
    assert {step for tag, step in got if tag == "train_itr/total"} == {2, 4}
    for key, v in want.items():
        if key[0] == "valid_epoch/PSNR":
            np.testing.assert_allclose(got[key], v, rtol=0, atol=1e-3)
        else:
            np.testing.assert_allclose(got[key], v, rtol=2e-4, atol=1e-6,
                                       err_msg=str(key))


def test_runner_trains_to_total_itr(runs):
    assert runs["port"].trainer.opt.step == int(runs["jax"].ts.step) == 4


def test_checkpoints_txt_matches_jax(runs):
    want = _ckpt_lines(runs["cj"].log_dir)
    got = _ckpt_lines(runs["ct"].log_dir)
    assert [n for n, _ in got] == [n for n, _ in want] == [
        "tiny_00000.ckpt"] * 2
    np.testing.assert_allclose([float(s) for _, s in got],
                               [float(s) for _, s in want], atol=1e-3)


def test_log_tree_matches_jax(runs):
    # the IR network is not ported (ROADMAP Queue 1, item 5)
    want = [f for f in _tree(runs["cj"].log_dir)
            if f != os.path.join("source_snapshot", "refvsr_ir.py")]
    assert _tree(runs["ct"].log_dir) == want
    with open(os.path.join(runs["ct"].log_dir, "cost.txt")) as f:
        got = f.read()
    with open(os.path.join(runs["cj"].log_dir, "cost.txt")) as f:
        assert got == f.read()


def test_sample_tiles_match_jax(runs):
    d_j = os.path.join(runs["cj"].log_dir, "sample", "valid")
    d_t = os.path.join(runs["ct"].log_dir, "sample", "valid")
    names = sorted(os.listdir(d_j))
    assert sorted(os.listdir(d_t)) == names
    assert {"000_FW_aa2_fm_ref_aligned.png",
            "000_contextual_ref_MFID_C.png", "003_conf_map_norm.png",
            "003_SR.png"} <= set(names)
    for name in names:
        a = read_image(os.path.join(d_j, name))
        b = read_image(os.path.join(d_t, name))
        assert a.shape == b.shape, name
        if name.endswith(("_HR.png", "_LR.png")):
            assert np.array_equal(a, b), name


def test_return_fm_tile_matches_jax(runs):
    want, got = runs["vis"]["fm"]
    assert want is not None and got.shape == want.shape == (128, 128, 3)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_vis_maps_match_jax(runs):
    want, got = runs["vis"]["cx"]
    assert [k for k, _ in got] == [k for k, _ in want] == [
        "contextual_ref_MFID_C"]
    for (_, a), (_, b) in zip(want, got):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, atol=1e-5)


def test_resume_restores_the_state(runs):
    """A new Runner resumed from epoch 0 holds what the first one saved,
    bit for bit, and starts at epoch 1."""
    old = runs["port"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        new = Runner(runs["ct"], device="cpu")
    new.resume(0)
    assert new.epoch0 == 1
    assert new.trainer.opt.step == old.trainer.opt.step == 4
    a, b = new.trainer.net.state_dict(), old.trainer.net.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in b)
    assert all(torch.equal(x, y) for x, y in zip(
        new.trainer.opt.mu + new.trainer.opt.nu,
        old.trainer.opt.mu + old.trainer.opt.nu))
    new.close()


def _amp_runner(dataset, logs):
    _, ct = _configs(dataset, logs, is_amp=True, save_sample=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return Runner(ct, device="cpu")


def test_validate_keeps_the_trainer_net(fake_dataset, tmp_path):
    """Validation in bf16 (is_amp) runs a copy: every trained parameter
    stays f32 and equal, and the net stays in training mode."""
    r = _amp_runner(fake_dataset, str(tmp_path))
    before = {k: v.clone() for k, v in r.trainer.net.state_dict().items()}
    psnr = r.validate(max_items=2)
    assert np.isfinite(psnr)
    after = r.trainer.net.state_dict()
    assert all(after[k].dtype == torch.float32 for k in after)
    assert all(torch.equal(after[k], before[k]) for k in before)
    assert r.trainer.net.training
    assert all(p.dtype == torch.float32 for p in r.trainer.params)
    r.close()


def test_stream_runner_leaves_the_callers_net(fake_dataset, tmp_path):
    """StreamRunner in another dtype runs a cast copy; in the net's own
    dtype and device it runs the net itself."""
    r = _amp_runner(fake_dataset, str(tmp_path))
    net = r.trainer.net
    s = StreamRunner(net, None, device="cpu", compute_dtype=torch.bfloat16)
    assert s.net is not net
    assert next(s.net.parameters()).dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert net.training
    assert StreamRunner(net, None, device="cpu").net is net
    r.close()


def _tree(root):
    """The files under `root`, event files by their directory only."""
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  .split("events.out")[0]
                  for d, _, fs in os.walk(root) for f in fs)


def test_cli_writes_the_jax_log_tree(runs, fake_dataset, tmp_path,
                                     monkeypatch):
    """run.main -cpu --is_train with the tiny config writes the tree that
    the JAX package's run.main writes, which is its Runner's."""
    import refvsr_tpu_torch.configs as configs
    from refvsr_tpu_torch import run
    real = configs.get_config
    monkeypatch.setattr(configs, "get_config", lambda name, **kw: real(
        name, **dict(kw, **{k: v for k, v in TINY.items()
                            if k not in ("is_train", "total_itr",
                                         "thread_num", "save_sample")})))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tr = run.main(["--is_train", "-cpu", "--config", "config_RefVSR_MFID",
                       "--mode", "tiny", "-b", "1", "-th", "0", "-ss",
                       "--data_offset", fake_dataset, "--log_offset",
                       str(tmp_path), "--total_itr", "4"])
    assert tr.trainer.opt.step == 4 and tr.trainer.device.type == "cpu"
    want = [f for f in _tree(runs["cj"].log_dir)
            if not f.endswith("refvsr_ir.py")]
    assert _tree(tr.config.log_dir) == want
    assert any(f.endswith("checkpoints.txt") for f in want)


@pytest.mark.parametrize("args,what", [
    (["--is_train", "--devices", "2"], "item 7"),
    (["--is_train", "--spatial_devices", "4"], "item 7"),
    ([], "item 6")])
def test_cli_refuses_what_is_not_ported(args, what):
    from refvsr_tpu_torch import run
    with pytest.raises(SystemExit, match=what):
        run.main(args)


def test_ir_network_is_refused():
    from refvsr_tpu_torch.models.refvsr import build_refvsr
    from refvsr_tpu_torch.train.trainer import Trainer
    cfg = get_config("RefVSR_IR_L1")
    with pytest.raises(NotImplementedError, match="item 5"):
        build_refvsr(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="item 5"):
        Trainer(cfg, device="cpu")


def test_runner_defaults_to_card(fake_dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, ct = _configs(fake_dataset, str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        Runner(ct)
