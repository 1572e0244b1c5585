"""The port's bf16 training policy (``is_amp``) against the JAX Trainer's, on
the CPU.

RefVSR_MFID_8K's wiring with ``is_amp`` (the policy of the three small
variants), shrunk to 2 blocks, 8 channels, T = 3, frame_itr_num 1, patch 16
and batch 1 (two JAX compiles: the first window's gradients and one
``iteration``). Both Trainers start from the JAX Trainer's initial weights
(``params_from_jax``): the network in bf16 on bf16 copies of the f32
parameters, the inputs and the state in bf16, the output cast to f32
before the loss, Adam on the f32 masters.

Tolerances, each with its reason:
- the iteration's errors within 1e-2 relative. bf16 keeps 8 mantissa bits
  (a rounding moves a value by up to 2^-9 relative), and the two packages
  round different intermediate sums (XLA's fused convolutions against
  PyTorch's CPU kernels, each rounding its output to bf16) through about
  60 layers; the contextual term divides each distance by its row's
  smallest, which amplifies them (it moved 3.6e-3 relative here, the L1
  terms 8e-4);
- the first window's gradients on the f32 masters against the JAX
  policy's (``jax.grad`` of the JAX train step's own loss function, the
  parameters cast to bf16 in the graph): each trained tensor within 0.3
  of its norm (relative L2), all of them together within 0.15. They
  measure 0.21 at the worst tensor and 0.097 overall. That is bf16's
  spread, not a gap between the packages: in f32 the two agree to 2e-3 of
  each tensor's largest entry (test_torch_train.py), and the port's bf16
  gradients lie 0.017 overall (0.44 at the worst tensor) from its own f32
  gradients, so JAX's bf16 gradients lie at least 0.078 from JAX's f32
  ones. A gradient scaled by 1.3, of the wrong sign or of another tensor
  misses these bounds; one taken in f32 (a cast lost in the graph) fails
  the check that the port's bf16 gradients differ from its f32 ones by
  more than 1e-3 overall;
- the Adam steps on the masters against JAX's updated ``TrainState``: the
  first step moves each entry by at most the learning rate (plus 1e-3 of
  it for the f32 rounding of the parameter), and the two packages' steps
  agree in sign on at least 90% of the entries (96% here; the rest are
  entries whose gradient is within bf16's noise of 0);
- the port's bf16 forward against its own f32 forward on the same
  weights: within 5e-2 of the output's range, which is what the policy
  costs."""

import warnings

import jax
import numpy as np
import pytest
import torch

from refvsr_tpu.configs import get_config as jax_get_config
from refvsr_tpu.models.refvsr import RefVSRNet as JaxNet
from refvsr_tpu.models.refvsr import init_stream_state as jax_init_state
from refvsr_tpu.train.trainer import Trainer as JaxTrainer
from refvsr_tpu.utils.precision import cast_floating
from refvsr_tpu_torch.configs import get_config
from refvsr_tpu_torch.models.refvsr import init_stream_state
from refvsr_tpu_torch.train.trainer import Trainer
from refvsr_tpu_torch.utils.convert import (loss_params_from_jax,
                                            params_from_jax)

torch.set_num_threads(2)

SMALL = dict(num_blocks=2, mid_channels=8, frame_num=3, frame_itr_num=1,
             patch_size=16, batch_size=1, is_amp=True, spynet_ckpt=None,
             vgg19_ckpt=None)


def _batch(cfg, seed=7):
    rng = np.random.default_rng(seed)
    n, p = cfg.batch_size, cfg.patch_size
    t = cfg.frame_num + cfg.frame_itr_num - 1

    def img(side):
        return rng.random((n, t, side, side, 3)).astype(np.float32)
    return {"LR_UW": img(p), "LR_REF_W": img(2 * p), "HR_UW": img(p),
            "HR_REF_T": img(4 * p)}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _window0(batch, t):
    return (batch["LR_UW"][:, :t], batch["LR_REF_W"][:, :t],
            batch["HR_UW"][:, t // 2], batch["HR_REF_T"][:, :t])


def _jax_bf16_grads(jtr, ts, loss_params, window, cfg):
    """The first window's gradients under the JAX policy, as the JAX
    train step's loss function takes them."""
    bf16 = jax.numpy.bfloat16
    lrs, refs, hr, ref_frames = (jax.numpy.asarray(a) for a in window)
    p = cfg.patch_size
    state = jax_init_state(1, p, p, cfg.mid_channels, bf16,
                           num_frames=cfg.frame_num)

    def loss_fn(params):
        out, _ = jtr.net.apply(cast_floating(params, bf16), lrs.astype(bf16),
                               refs.astype(bf16), state,
                               method=JaxNet.forward_train)
        return jtr.loss_mod.apply(loss_params, out.astype(jax.numpy.float32),
                                  hr, ref_frames)["total"]
    return params_from_jax(_np_tree(jax.jit(jax.grad(loss_fn))(ts.params)))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def amp_run():
    cfg_j = jax_get_config("RefVSR_MFID_8K", **SMALL)
    cfg = get_config("RefVSR_MFID_8K", **SMALL)
    batch = _batch(cfg)
    jtr = JaxTrainer(cfg_j)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # no pretrained SPyNet / VGG
        ts, loss_params = jtr.init_state(batch)
        tr = Trainer(cfg, device="cpu")
    assert jtr.compute_dtype == jax.numpy.bfloat16
    tr.net.load_state_dict(params_from_jax(_np_tree(ts.params)), strict=True)
    tr.loss_mod.load_state_dict(loss_params_from_jax(_np_tree(loss_params)),
                                strict=True)
    names = [k for k, p in tr.net.named_parameters() if p.requires_grad]
    t, p = cfg.frame_num, cfg.patch_size
    window = _window0(batch, t)
    grads_j = _jax_bf16_grads(jtr, ts, loss_params, window, cfg)
    state0 = init_stream_state(1, p, p, cfg.mid_channels, torch.bfloat16,
                               num_frames=t, device="cpu")
    *_, grads = tr.gradients(state0, *(torch.from_numpy(a) for a in window))
    # the same window's f32 gradients, to show the policy's were bf16
    tr.compute_dtype = torch.float32
    *_, grads32 = tr.gradients(
        init_stream_state(1, p, p, cfg.mid_channels, num_frames=t,
                          device="cpu"),
        *(torch.from_numpy(a) for a in window))
    tr.compute_dtype = torch.bfloat16
    params0 = params_from_jax(_np_tree(ts.params))
    before = [p.detach().clone() for p in tr.params]
    ts_after, want, _ = jtr.iteration(ts, loss_params, batch)
    got, state = tr.iteration(batch)
    return dict(want=want, got=got, state=state, trainer=tr, before=before,
                cfg=cfg, batch=batch, names=names,
                grads_jax={k: grads_j[k].numpy() for k in names},
                grads=dict(zip(names, grads)),
                grads32=dict(zip(names, grads32)),
                step_jax={k: (v - params0[k]).numpy() for k, v in
                          params_from_jax(_np_tree(ts_after.params)).items()
                          if k in names})


def test_amp_iteration_matches_jax(amp_run):
    want, got = amp_run["want"], amp_run["got"]
    assert set(got) == set(want) == {"L1_lf", "MFID_ref", "total", "PSNR"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-2, err_msg=k)


def test_amp_keeps_f32_masters(amp_run):
    tr = amp_run["trainer"]
    assert tr.compute_dtype == torch.bfloat16
    assert tr.opt.step == 1
    assert all(p.dtype == torch.float32 for p in tr.params)
    assert all(m.dtype == torch.float32 for m in tr.opt.mu + tr.opt.nu)
    changed = [not torch.equal(p, b) for p, b in zip(tr.params,
                                                      amp_run["before"])]
    assert all(changed)
    # the state is the compute dtype's, as in JAX
    assert amp_run["state"].feat_prop.dtype == torch.bfloat16


def test_amp_gradients_match_jax(amp_run):
    want = amp_run["grads_jax"]
    got = {k: g.numpy() for k, g in amp_run["grads"].items()}
    assert set(got) == set(want) == set(amp_run["names"])
    worst = max((_rel(got[k], want[k]), k) for k in want)
    assert worst[0] <= 0.3, worst
    names = sorted(want)
    overall = _rel(np.concatenate([got[k].ravel() for k in names]),
                   np.concatenate([want[k].ravel() for k in names]))
    assert overall <= 0.15, overall
    # the policy's gradients were taken in bf16, not in f32
    g32 = np.concatenate([amp_run["grads32"][k].numpy().ravel()
                          for k in names])
    assert _rel(np.concatenate([got[k].ravel() for k in names]), g32) > 1e-3


def test_amp_update_matches_jax(amp_run):
    tr = amp_run["trainer"]
    lr = float(tr.schedule(0))
    names = amp_run["names"]
    got = np.concatenate([(p.detach() - b).numpy().ravel() for p, b in
                          zip(tr.params, amp_run["before"])])
    want = np.concatenate([amp_run["step_jax"][k].ravel() for k in names])
    assert got.shape == want.shape
    # Adam's first step is at most the rate; 1e-3 of it covers the f32
    # rounding of the parameter the step is added to (an ulp of 0.1 is 7e-9)
    assert np.abs(got).max() <= lr * (1 + 1e-3)
    assert np.abs(want).max() <= lr * (1 + 1e-3)
    assert np.mean(np.sign(got) == np.sign(want)) >= 0.9


def test_amp_gradients_reach_the_masters(amp_run):
    """The gradients are f32, one per trained tensor, and the network's
    forward under the policy stays within 5e-2 of the f32 forward."""
    tr, cfg = amp_run["trainer"], amp_run["cfg"]
    t, p = cfg.frame_num, cfg.patch_size
    b = {k: torch.from_numpy(v) for k, v in amp_run["batch"].items()}
    args = (b["LR_UW"][:, :t], b["LR_REF_W"][:, :t], b["HR_UW"][:, t // 2],
            b["HR_REF_T"][:, :t])
    state = init_stream_state(1, p, p, cfg.mid_channels, torch.bfloat16,
                              num_frames=t, device="cpu")
    _, out, _, grads = tr.gradients(state, *args)
    out = out.detach()
    assert out.dtype == torch.bfloat16
    assert all(g is not None and g.dtype == torch.float32 for g in grads)
    with torch.no_grad():
        ref, _ = tr.net.forward_train(args[0], args[1], init_stream_state(
            1, p, p, cfg.mid_channels, num_frames=t, device="cpu"))
    span = float(ref.max() - ref.min())
    assert float((out.float() - ref).abs().max()) <= 5e-2 * span
