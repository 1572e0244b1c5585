"""The port's pretrained-asset loaders against the JAX package's.

Synthetic SPyNet (mmedit layout) and torchvision VGG19 state dicts are
written to disk, built as tests/test_pretrained_assets.py builds them. The
JAX ``load_pretrained_assets`` fills a tiny JAX Trainer's network and loss
parameters; carried over with ``params_from_jax`` / ``loss_params_from_jax``
they must equal, exactly, the port's modules after the port's loader ran on
the same initial weights and the same files. Then: an absent file warns and
leaves the weights as they were, a missing SPyNet key raises before anything
is written, and a tiny port ``Trainer`` given the files starts from them and
keeps its ``FlowNet`` and loss VGG through one ``iteration``."""

import warnings

import jax
import numpy as np
import pytest
import torch

from refvsr_tpu.configs import get_config as jax_get_config
from refvsr_tpu.models.refvsr import init_stream_state as jax_init_state
from refvsr_tpu.train.trainer import Trainer as JaxTrainer
from refvsr_tpu.utils.convert import \
    load_pretrained_assets as jax_load_pretrained_assets
from refvsr_tpu_torch.configs import get_config
from refvsr_tpu_torch.train.trainer import Trainer
from refvsr_tpu_torch.utils.convert import (load_pretrained_assets,
                                            load_spynet_weights,
                                            load_torch_checkpoint,
                                            load_vgg19_features,
                                            loss_params_from_jax,
                                            params_from_jax)

torch.set_num_threads(2)

# RefVSR_MFID_8K's wiring at tiny size; its loss has one contextual term
# (MFID_ref at relu4_4), so the loss module holds one VGG prefix
SMALL = dict(num_blocks=2, mid_channels=8, frame_num=3, frame_itr_num=1,
             patch_size=16, batch_size=1)
NO_ASSETS = dict(spynet_ckpt=None, vgg19_ckpt=None)


def _spynet_state_dict(rng):
    """Reference-shaped mmedit SPyNet state dict: 6 pyramid levels x
    5 ConvModules 7x7 (8->32->64->32->16->2)."""
    chans = [(8, 32), (32, 64), (64, 32), (32, 16), (16, 2)]
    sd = {}
    for i in range(6):
        for j, (cin, cout) in enumerate(chans):
            base = f"basic_module.{i}.basic_module.{j}.conv"
            sd[f"{base}.weight"] = torch.from_numpy(
                rng.standard_normal((cout, cin, 7, 7)).astype(np.float32))
            sd[f"{base}.bias"] = torch.from_numpy(
                rng.standard_normal(cout).astype(np.float32))
    return sd


_VGG_CONV = [(0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128),
             (10, 128, 256), (12, 256, 256), (14, 256, 256), (16, 256, 256),
             (19, 256, 512), (21, 512, 512), (23, 512, 512), (25, 512, 512),
             (28, 512, 512), (30, 512, 512), (32, 512, 512), (34, 512, 512)]


def _vgg19_state_dict(rng):
    """torchvision vgg19's features, plus a classifier the loaders
    ignore."""
    sd = {}
    for idx, cin, cout in _VGG_CONV:
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            rng.standard_normal((cout, cin, 3, 3)).astype(np.float32) * 0.02)
        sd[f"features.{idx}.bias"] = torch.from_numpy(
            rng.standard_normal(cout).astype(np.float32) * 0.02)
    sd["classifier.0.weight"] = torch.zeros(4, 8)
    return sd


@pytest.fixture(scope="module")
def asset_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("assets")
    rng = np.random.default_rng(42)
    sp, vg = root / "SPyNet.pytorch", root / "VGG19.pytorch"
    # a DDP-wrapped SPyNet checkpoint: the loaders strip 'module.'
    torch.save({"state_dict": {f"module.{k}": v for k, v in
                               _spynet_state_dict(rng).items()}}, sp)
    torch.save(_vgg19_state_dict(rng), vg)
    return str(sp), str(vg)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _batch(cfg, seed=7):
    """The HD-in training geometry: LR_UW p^2, LR_REF_W (2p)^2, HR_UW p^2,
    HR_REF_T (4p)^2."""
    rng = np.random.default_rng(seed)
    n, p = cfg.batch_size, cfg.patch_size
    t = cfg.frame_num + cfg.frame_itr_num - 1

    def img(side):
        return rng.random((n, t, side, side, 3)).astype(np.float32)
    return {"LR_UW": img(p), "LR_REF_W": img(2 * p), "HR_UW": img(p),
            "HR_REF_T": img(4 * p)}


def _port_trainer(**fields):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # NO_ASSETS warns by design
        return Trainer(get_config("RefVSR_MFID_8K", **SMALL, **fields),
                       device="cpu", seed=3)


def _random_like(tree, rng):
    """Seeded numpy values in the shapes of an abstract parameter tree."""
    return jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)


@pytest.fixture(scope="module")
def jax_loaded(asset_files):
    """A tiny JAX Trainer's network and loss parameter trees (their shapes
    from ``jax.eval_shape`` of its modules' ``init``, seeded numpy values),
    and the same after the JAX loader read the files; with its report."""
    sp, vg = asset_files
    cfg = get_config("RefVSR_MFID_8K", **SMALL)
    jtr = JaxTrainer(jax_get_config("RefVSR_MFID_8K", **SMALL, **NO_ASSETS))
    batch = _batch(cfg)
    t, p = cfg.frame_num, cfg.patch_size
    state = jax_init_state(1, p, p, cfg.mid_channels, num_frames=t)
    key = jax.random.PRNGKey(0)
    net_shapes = jax.eval_shape(
        lambda lrs, refs: jtr.net.init(key, lrs, refs, state),
        batch["LR_UW"][:, :t], batch["LR_REF_W"][:, :t])
    loss_shapes = jax.eval_shape(
        lambda sr, hr, refs: jtr.loss_mod.init(key, sr, hr, refs),
        np.zeros((1, 4 * p, 4 * p, 3), np.float32), batch["HR_UW"][:, t // 2],
        batch["HR_REF_T"][:, :t])
    rng = np.random.default_rng(11)
    before = (_random_like(net_shapes, rng), _random_like(loss_shapes, rng))
    params, lparams, report = jax_load_pretrained_assets(
        jax_get_config("RefVSR_MFID_8K", **SMALL, spynet_ckpt=sp,
                       vgg19_ckpt=vg), *before)
    return before, (_np_tree(params), _np_tree(lparams)), report


def test_loaders_match_jax_exactly(asset_files, jax_loaded):
    sp, vg = asset_files
    (net0, loss0), (net1, loss1), report_j = jax_loaded
    tr = _port_trainer(**NO_ASSETS)
    tr.net.load_state_dict(params_from_jax(net0), strict=True)
    tr.loss_mod.load_state_dict(loss_params_from_jax(loss0), strict=True)
    report = load_pretrained_assets(
        get_config("RefVSR_MFID_8K", **SMALL, spynet_ckpt=sp,
                   vgg19_ckpt=vg), tr.net, tr.loss_mod)
    assert report == report_j
    assert report["spynet_leaves"] == 60
    assert report["vgg_net_leaves"] > 0 and report["vgg_loss_leaves"] > 0
    for got, want in ((tr.net.state_dict(), params_from_jax(net1)),
                      (tr.loss_mod.state_dict(), loss_params_from_jax(loss1))):
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_spynet_and_vgg_hold_the_files(asset_files):
    sp, vg = asset_files
    tr = _port_trainer(**NO_ASSETS)
    n = load_spynet_weights(load_torch_checkpoint(sp), tr.net)
    assert n == len(list(tr.net.FlowNet.parameters())) == 60
    sp_sd = load_torch_checkpoint(sp)
    assert torch.equal(tr.net.FlowNet.basic_module[5].basic_module[4]
                       .conv.weight, sp_sd["module.basic_module.5."
                                           "basic_module.4.conv.weight"])
    vg_sd = load_torch_checkpoint(vg)
    assert load_vgg19_features(vg_sd, tr.loss_mod) == 2 * 12  # to relu4_4
    sd = tr.loss_mod.state_dict()
    assert torch.equal(sd["cx_MFID_ref.vgg.25.weight"],
                       vg_sd["features.25.weight"])
    # the matching prefix (vgg19 features[:7] with HD-in: convs 0, 2, 5)
    # is filled; its 1x1 map conv, which no torchvision key names, is not
    prefix = tr.net.feature_match.feature_extract
    maps = {k: v.clone() for k, v in prefix.state_dict().items()
            if k.startswith("map")}
    assert maps
    assert load_vgg19_features(vg_sd, tr.net) == 6
    for idx in (0, 2, 5):
        assert torch.equal(getattr(prefix, str(idx)).weight,
                           vg_sd[f"features.{idx}.weight"])
    now = prefix.state_dict()
    assert all(torch.equal(now[k], v) for k, v in maps.items())


def test_absent_files_warn_and_leave_weights(asset_files):
    tr = _port_trainer(**NO_ASSETS)
    before = {k: v.clone() for k, v in tr.net.state_dict().items()}
    loss_before = {k: v.clone() for k, v in tr.loss_mod.state_dict().items()}
    cfg = get_config("RefVSR_MFID_8K", **SMALL,
                     spynet_ckpt="/nonexistent/SPyNet.pytorch",
                     vgg19_ckpt="/nonexistent/VGG19.pytorch")
    with pytest.warns(UserWarning) as record:
        report = load_pretrained_assets(cfg, tr.net, tr.loss_mod)
    messages = " ".join(str(w.message) for w in record)
    assert "spynet_ckpt" in messages and "vgg19_ckpt" in messages
    assert "not found" in messages
    assert report == {"spynet_leaves": 0, "vgg_net_leaves": 0}
    for now, then in ((tr.net.state_dict(), before),
                      (tr.loss_mod.state_dict(), loss_before)):
        assert all(torch.equal(now[k], v) for k, v in then.items())


def test_missing_spynet_key_raises(asset_files):
    sp, _ = asset_files
    sd = load_torch_checkpoint(sp)
    sd.pop("module.basic_module.3.basic_module.2.conv.bias")
    tr = _port_trainer(**NO_ASSETS)
    before = {k: v.clone() for k, v in tr.net.FlowNet.state_dict().items()}
    with pytest.raises(ValueError, match="missing"):
        load_spynet_weights(sd, tr.net)
    now = tr.net.FlowNet.state_dict()
    assert all(torch.equal(now[k], v) for k, v in before.items())
    sd = load_torch_checkpoint(sp)
    sd["basic_module.0.basic_module.0.conv.weight"] = torch.zeros(32, 8, 3, 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_spynet_weights(sd, tr.net)


def test_trainer_starts_from_files_and_keeps_flownet(asset_files):
    sp, vg = asset_files
    tr = _port_trainer(spynet_ckpt=sp, vgg19_ckpt=vg)
    assert tr.assets["spynet_leaves"] == 60
    assert tr.assets["vgg_loss_leaves"] == 24
    sp_sd = load_torch_checkpoint(sp)
    vg_sd = load_torch_checkpoint(vg)
    for k, v in tr.net.FlowNet.state_dict().items():
        assert torch.equal(v, sp_sd[f"module.{k}"]), k
    match0 = tr.net.feature_match.feature_extract.state_dict()
    for idx in (0, 2):
        assert torch.equal(match0[f"{idx}.weight"],
                           vg_sd[f"features.{idx}.weight"])
    flow0 = {k: v.clone() for k, v in tr.net.FlowNet.state_dict().items()}
    loss0 = {k: v.clone() for k, v in tr.loss_mod.state_dict().items()}
    trained0 = [p.detach().clone() for p in tr.params]
    means, _ = tr.iteration(_batch(tr.config))
    assert np.isfinite(means["total"])
    now = tr.net.FlowNet.state_dict()
    assert all(torch.equal(now[k], v) for k, v in flow0.items())
    now = tr.loss_mod.state_dict()
    assert all(torch.equal(now[k], v) for k, v in loss0.items())
    assert any(not torch.equal(p, q) for p, q in zip(tr.params, trained0))
