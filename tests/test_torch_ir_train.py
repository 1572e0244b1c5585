"""The port's RefVSR-IR training (``Trainer`` with ``network="RefVSR_IR"``)
against the JAX Trainer, on the CPU in f32.

The set-up of ``tests/test_refvsr_ir.py::test_ir_trainer_iteration``:
RefVSR_IR_MFID with 2 blocks, 8 channels, T = 5, ``frame_itr_num`` 2,
patch 16, batch 1, loss '1*L1', ``keyframe_stride`` 2. The port Trainer's
seeded weights (offset convs redrawn, as ``tests/torch_ir_nets.py`` does)
go to the JAX Trainer by ``convert_state_dict``; the JAX state is built
from them directly (its ``init_state`` would run the net's init eagerly).

Window 0: output and state within atol 2e-4 (the full-net precedent), the
loss within rtol 1e-4, and each trained tensor's gradient within 2e-3 of
its largest JAX magnitude plus 1e-6, as tests/test_torch_train.py allows
(gradients of ~80 layers summed in another order, back through the
bicubic resizes, the samplers and the matching argmax). JAX computes EDVR
for every frame and discards the non-keyframes; the port computes it at
the keyframes only: the equal EDVR gradients show the two formulations
agree. The iteration's mean errors (two steps, sliding keyframe masks)
within rtol 1e-4. Both IR variants take a bf16 (``is_amp``) step, and
the Runner's validation streams the IR net with sliding keyframe masks."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refvsr_tpu.configs import get_config as jax_get_config
from refvsr_tpu.models.refvsr import init_stream_state as jax_init_state
from refvsr_tpu.models.refvsr_ir import RefVSRIRNet as JaxIRNet
from refvsr_tpu.train.trainer import Trainer as JaxTrainer
from refvsr_tpu.train.trainer import TrainState
from refvsr_tpu_torch.configs import get_config
from refvsr_tpu_torch.models.edvr import ModulatedDCNPack
from refvsr_tpu_torch.models.refvsr import init_stream_state
from refvsr_tpu_torch.models.refvsr_ir import (RefVSRIRNet,
                                               sliding_keyframe_mask)
from refvsr_tpu_torch.train.trainer import Trainer
from refvsr_tpu_torch.utils.convert import params_from_jax
from torch_ir_nets import jax_params

torch.set_num_threads(2)

SMALL = dict(num_blocks=2, mid_channels=8, frame_num=5, frame_itr_num=2,
             patch_size=16, batch_size=1, loss="1*L1", keyframe_stride=2,
             spynet_ckpt=None, vgg19_ckpt=None)
STATE_KEYS = ("feat_prop", "feat_prop_up", "conf_prop", "flow")


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    t_total = cfg.frame_num + cfg.frame_itr_num - 1
    h = w = cfg.patch_size

    def img(*s):
        return rng.random(s, dtype=np.float32)
    return {"LR_UW": img(1, t_total, h, w, 3),
            "LR_REF_W": img(1, t_total, 2 * h, 2 * w, 3),
            "HR_UW": img(1, t_total, 4 * h, 4 * w, 3),
            "HR_REF_W": img(1, t_total, 4 * h, 4 * w, 3),
            "HR_REF_T": img(1, t_total, 4 * h, 4 * w, 3)}


def _trainer(cfg):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # no pretrained SPyNet / VGG
        tr = Trainer(cfg, device="cpu", seed=3)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in tr.net.modules():
            if isinstance(m, ModulatedDCNPack):
                m.conv_offset.weight.copy_(torch.randn(
                    m.conv_offset.weight.shape, generator=gen) * 0.1)
    return tr


@pytest.fixture(scope="module")
def ir_train_run():
    cfg = get_config("RefVSR_IR_MFID", **SMALL)
    cfg_j = jax_get_config("RefVSR_IR_MFID", **SMALL)
    batch = _batch(cfg)
    t, p = cfg.frame_num, cfg.patch_size
    tr = _trainer(cfg)
    assert isinstance(tr.net, RefVSRIRNet)
    jtr = JaxTrainer(cfg_j)
    params = jax_params(tr.net, p, p, jtr.net)
    mask = sliding_keyframe_mask(t, cfg.keyframe_stride, None)[0]
    win = (batch["LR_UW"][:, :t], batch["LR_REF_W"][:, :t],
           batch["HR_UW"][:, t // 2], batch["HR_REF_W"][:, :t])
    loss_params = jtr.loss_mod.init(jax.random.PRNGKey(1),
                                    jnp.zeros((1, 4 * p, 4 * p, 3)),
                                    jnp.asarray(win[2]), jnp.asarray(win[3]))

    def loss_fn(prm):
        out, st = jtr.net.apply(prm, *win[:2],
                                jax_init_state(1, p, p, cfg.mid_channels,
                                               num_frames=t), mask,
                                method=JaxIRNet.forward_train)
        errs = jtr.loss_mod.apply(loss_params, out, *win[2:])
        return errs["total"], (errs, out, st)

    (_, (errs_j, out_j, st_j)), grads_j = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    ts = TrainState(params=params, opt_state=jtr.tx.init(params),
                    step=jnp.zeros((), jnp.int32))
    ts, means_j, _ = jtr.iteration(ts, loss_params, batch)
    jax_side = dict(
        errs={k: float(v) for k, v in errs_j.items()}, out=np.asarray(out_j),
        state={k: np.asarray(getattr(st_j, k)) for k in STATE_KEYS},
        grads=params_from_jax(jax.tree_util.tree_map(
            lambda a: np.array(a, np.float32), grads_j)),
        means=means_j, step=int(ts.step))

    state = init_stream_state(1, p, p, cfg.mid_channels, num_frames=t,
                              device="cpu")
    errs, out, st, grads = tr.gradients(
        state, *(torch.from_numpy(np.ascontiguousarray(a)) for a in win),
        mask)
    names = [k for k, q in tr.net.named_parameters() if q.requires_grad]
    port = dict(errs={k: float(v.detach()) for k, v in errs.items()},
                out=out.detach().numpy(),
                state={k: getattr(st, k).numpy() for k in STATE_KEYS},
                grads=dict(zip(names, grads)))
    port["means"], _ = tr.iteration(batch)
    port["step"] = tr.opt.step
    return dict(jax=jax_side, port=port)


def test_ir_window_output_and_state_match_jax(ir_train_run):
    want, got = ir_train_run["jax"], ir_train_run["port"]
    assert got["out"].shape == want["out"].shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got["out"], want["out"], rtol=0, atol=2e-4)
    for k in STATE_KEYS:
        np.testing.assert_allclose(got["state"][k], want["state"][k],
                                   rtol=0, atol=2e-4, err_msg=k)


def test_ir_window_losses_match_jax(ir_train_run):
    want, got = ir_train_run["jax"]["errs"], ir_train_run["port"]["errs"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_ir_window_gradients_match_jax(ir_train_run):
    want = ir_train_run["jax"]["grads"]
    got = ir_train_run["port"]["grads"]
    trained = {k for k in want if not k.startswith("FlowNet.")}
    assert set(got) == trained
    for k in set(want) - trained:
        assert not want[k].abs().max() > 0, k
    edvr = [k for k in trained if k.startswith("edvr.")]
    assert len(edvr) == 96 and all(want[k].abs().max() > 0 for k in edvr)
    for k in sorted(trained):
        w = want[k].numpy()
        g = np.zeros_like(w) if got[k] is None else got[k].numpy()
        tol = 2e-3 * float(np.abs(w).max()) + 1e-6
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=k)


def test_ir_iteration_matches_jax(ir_train_run):
    want, got = ir_train_run["jax"], ir_train_run["port"]
    assert got["step"] == want["step"] == 2
    assert set(got["means"]) == set(want["means"])
    for k in want["means"]:
        np.testing.assert_allclose(got["means"][k], want["means"][k],
                                   rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("variant", ["RefVSR_IR_MFID", "RefVSR_IR_L1"])
def test_ir_variants_train_under_is_amp(variant):
    """Both IR variants take an optimizer step in bf16 (is_amp): finite
    losses, bf16 state, f32 masters moved."""
    small = dict(SMALL, frame_num=5, frame_itr_num=1)
    small.pop("loss")
    cfg = get_config(variant, is_amp=True, **small)
    tr = _trainer(cfg)
    before = [q.detach().clone() for q in tr.params]
    means, state = tr.iteration(_batch(cfg, seed=2))
    assert all(np.isfinite(v) for v in means.values()), means
    assert state.feat_prop.dtype == torch.bfloat16
    assert all(q.dtype == torch.float32 for q in tr.params)
    assert any(not torch.equal(a, q) for a, q in zip(before, tr.params))


def test_runner_validates_ir_with_sliding_keyframes(fake_dataset, tmp_path):
    """The Runner's validation streams the IR net with the config's
    keyframe stride (refvsr_tpu/train/runner.py:267): the masks slide
    across the valid clip's windows, and the PSNR is that of a
    StreamRunner driven by hand with the same stride."""
    from refvsr_tpu_torch.configs import set_data_path
    from refvsr_tpu_torch.eval.stream import StreamRunner
    from refvsr_tpu_torch.models import refvsr_ir
    from refvsr_tpu_torch.train.runner import Runner
    cfg = set_data_path(get_config(
        "RefVSR_IR_MFID", num_blocks=2, mid_channels=8, frame_num=5,
        keyframe_stride=2, batch_size=1, thread_num=0, mode="tinyir",
        data_offset=fake_dataset, log_offset=str(tmp_path),
        spynet_ckpt=None, vgg19_ckpt=None), True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        runner = Runner(cfg, device="cpu")
    masks = []
    orig = refvsr_ir.sliding_keyframe_mask

    def spy(*a):
        out = orig(*a)
        masks.append(list(np.flatnonzero(out[0])))
        return out
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(refvsr_ir, "sliding_keyframe_mask", spy)
        psnr = runner.validate(max_items=3)
    assert masks == [[0, 2, 4], [1, 3, 4], [0, 2, 4]]
    by_hand = StreamRunner(runner.trainer.net, cfg.reset_branch,
                           device="cpu", keyframe_stride=2)
    vals = []
    for i in range(3):
        item = runner.valid_ds[i]
        sr, _ = by_hand.process(item["LR_UW"][None, :5],
                                item["LR_REF_W"][None, :5], item["is_first"])
        vals.append(10 * np.log10(1.0 / np.mean(
            (sr[0] - item["HR_UW"][2]) ** 2)))
    np.testing.assert_allclose(psnr, np.mean(vals), rtol=1e-6)
