"""The port's training slice against the JAX package, on the CPU.

RefVSR_MFID_8K's wiring (HD-in, matching_ksize 8, scale 4, loss
'1*L1_lf+0.1*MFID_ref' at relu4_4, T refs, Adam with gc 1.0 and the CA
schedule), shrunk to 2 blocks, 8 channels, T = 3, frame_itr_num = 2, patch 16
and batch 1. Inputs come from a numpy seed; the JAX Trainer's initial
network and loss parameters cross over with ``params_from_jax`` and
``loss_params_from_jax``. One module-scoped fixture runs the JAX side once:
one jitted value-and-grad of window 0 and one ``Trainer.iteration`` (one
compile per window shape, two).

Tolerances, each with its reason:
- gaussian_lowpass 1e-6: nine f32 products summed in another order;
- CX losses rtol 1e-5, their input gradients 1e-4 of the largest: f32
  VGG convolutions and distance products summed in another order;
- schedules rtol 1e-5: the port evaluates the cosine in double, JAX in f32;
- optimizer update within two f32 ulps of each parameter (rtol 2.4e-7,
  atol 1e-9; updates ~1e-4): f32 Adam arithmetic in another order;
- forward_train output and state atol 2e-4, the full-net precedent of
  tests/test_torch_refvsr.py (f32 convolutions through ~60 layers); the
  window's losses rtol 1e-5 plus atol 1e-6, since they move with that
  output (the weighted MFID term is ~4e-4);
- window gradients: each tensor within 2e-3 of its largest magnitude plus
  1e-6 (gradients of ~60 layers summed in another order, back through
  bicubic resizes, the affine sampler and the matching argmax);
- iteration mean errors rtol 2e-4 plus atol 1e-6: two steps, the second
  on parameters that the first update moved by Adam's near-sign steps.

The default ``RefVSR_MFID`` wiring (flag_HD_in False, matching_ksize 2,
refs at 2x the LR size) runs two ``forward_train`` windows beside it, the
state carried from the first to the second, at the same size and atol 2e-4;
its weights are the port's seeded init, carried to the JAX net by the JAX
package's ``convert_state_dict``, and JAX's ``forward_train`` runs
jitted."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from refvsr_tpu.configs import get_config as jax_get_config
from refvsr_tpu.losses import LossModule as JaxLossModule
from refvsr_tpu.losses import parse_loss_spec as jax_parse_loss_spec
from refvsr_tpu.losses.contextual import CXLoss as JaxCXLoss
from refvsr_tpu.models.refvsr import RefVSRNet as JaxNet
from refvsr_tpu.models.refvsr import init_stream_state as jax_init_state
from refvsr_tpu.ops.image import gaussian_lowpass as jax_gaussian_lowpass
from refvsr_tpu.train import schedule as jax_schedule
from refvsr_tpu.train.trainer import Trainer as JaxTrainer
from refvsr_tpu.utils.convert import convert_state_dict
from refvsr_tpu_torch.configs import get_config
from refvsr_tpu_torch.losses import LossModule, parse_loss_spec
from refvsr_tpu_torch.losses.contextual import CXLoss
from refvsr_tpu_torch.models.blocks import init_weights
from refvsr_tpu_torch.models.refvsr import RefVSRNet, init_stream_state
from refvsr_tpu_torch.ops.image import gaussian_lowpass
from refvsr_tpu_torch.train import schedule
from refvsr_tpu_torch.train.trainer import ClippedAdam, Trainer
from refvsr_tpu_torch.utils.convert import (loss_params_from_jax,
                                            params_from_jax)

torch.set_num_threads(2)

SMALL = dict(num_blocks=2, mid_channels=8, frame_num=3, frame_itr_num=2,
             patch_size=16, batch_size=1)
STATE_KEYS = ("feat_prop", "feat_prop_up", "conf_prop", "flow")


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _batch(cfg, seed=7):
    """A synthetic training batch with the HD-in geometry of
    data/datasets.py:111-165: LR_UW p^2, LR_REF_W (2p)^2, HR_UW p^2,
    HR_REF_T (4p)^2."""
    rng = np.random.default_rng(seed)
    n, p = cfg.batch_size, cfg.patch_size
    t = cfg.frame_num + cfg.frame_itr_num - 1

    def img(side):
        return rng.random((n, t, side, side, 3)).astype(np.float32)
    return {"LR_UW": img(p), "LR_REF_W": img(2 * p), "HR_UW": img(p),
            "HR_REF_T": img(4 * p)}


def _window0(batch, t):
    return (batch["LR_UW"][:, :t], batch["LR_REF_W"][:, :t],
            batch["HR_UW"][:, t // 2], batch["HR_REF_T"][:, :t])


@pytest.fixture(scope="module")
def train_run():
    """The JAX side once (window-0 gradients, one iteration) and the same
    on the port, from the same initial parameters."""
    cfg_j = jax_get_config("RefVSR_MFID_8K", spynet_ckpt=None,
                           vgg19_ckpt=None, **SMALL)
    cfg = get_config("RefVSR_MFID_8K", **SMALL)
    batch = _batch(cfg)
    t = cfg.frame_num
    jtr = JaxTrainer(cfg_j)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # no pretrained SPyNet / VGG
        ts, loss_params = jtr.init_state(batch)
    params0 = _np_tree(ts.params)
    lparams = _np_tree(loss_params)

    lrs, refs, hr, ref_frames = (jnp.asarray(a) for a in _window0(batch, t))
    state0 = jax_init_state(1, cfg.patch_size, cfg.patch_size,
                            cfg.mid_channels, num_frames=t)

    def loss_fn(params):
        out, st = jtr.net.apply(params, lrs, refs, state0,
                                method=JaxNet.forward_train)
        errs = jtr.loss_mod.apply(loss_params, out.astype(jnp.float32), hr,
                                  ref_frames)
        return errs["total"], (errs, out, st)

    (_, (errs_j, out_j, st_j)), grads_j = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(ts.params)
    jax_side = dict(errs=_np_tree(errs_j), out=np.asarray(out_j),
                    state={k: np.asarray(getattr(st_j, k))
                           for k in STATE_KEYS},
                    grads=params_from_jax(_np_tree(grads_j)))
    _, jax_side["means"], _ = jtr.iteration(ts, loss_params, batch)

    tr = Trainer(cfg, device="cpu")
    tr.net.load_state_dict(params_from_jax(params0), strict=True)
    tr.loss_mod.load_state_dict(loss_params_from_jax(lparams), strict=True)
    frozen = {k: v.clone() for k, v in tr.net.FlowNet.state_dict().items()}
    frozen.update({f"loss.{k}": v.clone()
                   for k, v in tr.loss_mod.state_dict().items()})
    state = init_stream_state(1, cfg.patch_size, cfg.patch_size,
                              cfg.mid_channels, num_frames=t, device="cpu")
    errs, out, st, grads = tr.gradients(
        state, *(torch.from_numpy(a) for a in _window0(batch, t)))
    names = [k for k, p in tr.net.named_parameters() if p.requires_grad]
    port = dict(errs={k: float(v.detach()) for k, v in errs.items()},
                out=out.detach().numpy(),
                state={k: getattr(st, k).numpy() for k in STATE_KEYS},
                grads=dict(zip(names, grads)))
    port["means"], _ = tr.iteration(batch)
    return dict(jax=jax_side, port=port, trainer=tr, frozen=frozen)


@pytest.fixture(scope="module")
def default_train_run():
    """The default wiring's forward_train on two consecutive windows, the
    state carried, on JAX and on the port from the same weights."""
    t, p, mid = SMALL["frame_num"], SMALL["patch_size"], SMALL["mid_channels"]
    rng = np.random.default_rng(9)
    lrs_all = rng.random((1, t + 1, p, p, 3)).astype(np.float32)
    refs_all = rng.random((1, t + 1, 2 * p, 2 * p, 3)).astype(np.float32)
    net = RefVSRNet(scale=4, num_blocks=SMALL["num_blocks"],
                    mid_channels=mid, matching_ksize=2, flag_HD_in=False)
    init_weights(net, torch.Generator().manual_seed(4))
    jnet = JaxNet(scale=4, num_blocks=SMALL["num_blocks"], mid_channels=mid,
                  matching_ksize=2, flag_HD_in=False)
    shapes = jax.eval_shape(
        lambda lrs, refs: jnet.init(jax.random.PRNGKey(0), lrs, refs,
                                    jax_init_state(1, p, p, mid,
                                                   num_frames=t)),
        lrs_all[:, :t], refs_all[:, :t])
    params, _, _ = convert_state_dict(
        {k: v.numpy() for k, v in net.state_dict().items()},
        jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                               shapes))
    step = jax.jit(lambda prm, lrs, refs, st: jnet.apply(
        prm, lrs, refs, st, method=JaxNet.forward_train))
    st_j = jax_init_state(1, p, p, mid, num_frames=t)
    st_t = init_stream_state(1, p, p, mid, num_frames=t, device="cpu")
    results = []
    for wi in range(2):
        lrs, refs = lrs_all[:, wi:wi + t], refs_all[:, wi:wi + t]
        out_j, st_j = step(params, lrs, refs, st_j)
        out_t, st_t = net.forward_train(torch.from_numpy(lrs),
                                        torch.from_numpy(refs), st_t)
        results.append((np.asarray(out_j), out_t.detach().numpy(),
                        {k: np.asarray(getattr(st_j, k)) for k in STATE_KEYS},
                        {k: getattr(st_t, k).numpy() for k in STATE_KEYS}))
    return results


@pytest.mark.parametrize("window", [0, 1])
def test_default_wiring_forward_train_matches_jax(default_train_run, window):
    want, got, st_j, st_t = default_train_run[window]
    assert got.shape == want.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got, want, atol=2e-4)
    for key in STATE_KEYS:
        assert st_t[key].shape == st_j[key].shape, key
        np.testing.assert_allclose(st_t[key], st_j[key], atol=2e-4,
                                   err_msg=key)


def test_forward_train_output_matches_jax(train_run):
    want, got = train_run["jax"]["out"], train_run["port"]["out"]
    assert got.shape == want.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("key", STATE_KEYS)
def test_forward_train_state_matches_jax(train_run, key):
    want = train_run["jax"]["state"][key]
    got = train_run["port"]["state"][key]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_window_losses_match_jax(train_run):
    want, got = train_run["jax"]["errs"], train_run["port"]["errs"]
    assert set(got) == set(want) == {"L1_lf", "MFID_ref", "total", "PSNR"}
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_window_gradients_match_jax(train_run):
    want = train_run["jax"]["grads"]
    got = train_run["port"]["grads"]
    trained = {k for k in want if not k.startswith("FlowNet.")}
    assert set(got) == trained
    # SPyNet's gradients are structurally zero in JAX (stop_gradient)
    for k in set(want) - trained:
        assert not want[k].abs().max() > 0, k
    for k in sorted(trained):
        w = want[k].numpy()
        g = np.zeros_like(w) if got[k] is None else got[k].numpy()
        tol = 2e-3 * float(np.abs(w).max()) + 1e-6
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=k)


def test_iteration_mean_errors_match_jax(train_run):
    want, got = train_run["jax"]["means"], train_run["port"]["means"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-6,
                                   err_msg=k)


def test_iteration_trains_only_the_network(train_run):
    tr = train_run["trainer"]
    assert tr.opt.step == 2
    assert tr.current_lr() == pytest.approx(
        float(jax_schedule.from_config(jax_get_config("RefVSR_MFID_8K"))(2)),
        rel=1e-6)
    now = {k: v for k, v in tr.net.FlowNet.state_dict().items()}
    now.update({f"loss.{k}": v for k, v in tr.loss_mod.state_dict().items()})
    assert all(torch.equal(now[k], v) for k, v in train_run["frozen"].items())
    assert len(tr.window_errs) == 2


def test_gaussian_lowpass_matches_jax(rng):
    x = rng.random((2, 9, 11, 3)).astype(np.float32)
    want = np.asarray(jax_gaussian_lowpass(jnp.asarray(x)))
    got = gaussian_lowpass(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 11, 13, 3)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("opts", [
    dict(),                                  # cosine (FID / MFID)
    dict(x_self_mu=True),                    # _X_mu
    dict(is_cobi=True),                      # _CoBi
    dict(loss_type="L2"),                    # _L2
], ids=["cosine", "X_mu", "CoBi", "L2"])
def test_cx_loss_matches_jax(rng, opts):
    x = rng.random((2, 24, 20, 3)).astype(np.float32)
    y = rng.random((2, 24, 20, 3)).astype(np.float32)
    jcx = JaxCXLoss(vgg_layer="relu2_2", **opts)
    params = jcx.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(y))
    (loss_j, cmap_j), vjp = jax.vjp(
        lambda a: jcx.apply(params, a, jnp.asarray(y)), jnp.asarray(x))
    gx_j = np.asarray(vjp((jnp.ones(()), jnp.zeros_like(cmap_j)))[0])

    cx = CXLoss(vgg_layer="relu2_2", **opts)
    sd = loss_params_from_jax({"cx": _np_tree(params)["params"]})
    cx.load_state_dict({k[len("cx."):]: v for k, v in sd.items()},
                       strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss, cmap = cx(xt, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(cmap.detach().numpy(), np.asarray(cmap_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), gx_j, rtol=0,
                               atol=1e-4 * float(np.abs(gx_j).max()))


def test_loss_module_8k_spec_matches_jax(rng):
    """LossModule on the RefVSR_MFID_8K spec: the HD-in bicubic downscale,
    L1_lf and MFID over the t refs; values and the SR gradient."""
    cfg = get_config("RefVSR_MFID_8K")
    sr = rng.random((2, 64, 64, 3)).astype(np.float32)
    hr = rng.random((2, 16, 16, 3)).astype(np.float32)
    refs = rng.random((2, 3, 64, 64, 3)).astype(np.float32)
    jmod = JaxLossModule(spec=cfg.loss, scale=4, flag_HD_in=True,
                         vgg_layer=cfg.CX_vgg_layer)
    params = jmod.init(jax.random.PRNGKey(2), jnp.asarray(sr),
                       jnp.asarray(hr), jnp.asarray(refs))
    errs_j, vjp = jax.vjp(lambda s: jmod.apply(params, s, jnp.asarray(hr),
                                               jnp.asarray(refs)),
                          jnp.asarray(sr))
    ct = {k: jnp.zeros(()) for k in errs_j}
    ct["total"] = jnp.ones(())
    g_j = np.asarray(vjp(ct)[0])

    mod = LossModule(cfg.loss, scale=4, flag_HD_in=True,
                     vgg_layer=cfg.CX_vgg_layer)
    mod.load_state_dict(loss_params_from_jax(_np_tree(params)), strict=True)
    assert not any(p.requires_grad for p in mod.parameters())
    srt = torch.from_numpy(sr).requires_grad_(True)
    errs = mod(srt, torch.from_numpy(hr), torch.from_numpy(refs))
    errs["total"].backward()
    assert set(errs) == set(errs_j) == {"L1_lf", "MFID_ref", "total", "PSNR"}
    for k in errs_j:
        np.testing.assert_allclose(float(errs[k]), float(errs_j[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(srt.grad.numpy(), g_j, rtol=0,
                               atol=1e-4 * float(np.abs(g_j).max()))


def test_parse_loss_spec_matches_jax():
    spec = "1*L1_lf+0.05*TFID_ref_X_mu+0.01*FID_hr_CoBi_L2+0.1*MFID_ref"
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = parse_loss_spec(spec)
    assert got == jax_parse_loss_spec(spec)
    assert got == [(1.0, "L1_lf"), (0.01, "FID_hr_CoBi_L2"),
                   (0.1, "MFID_ref")]
    assert any("TFID_ref_X_mu" in str(r.message) for r in rec)


@pytest.mark.parametrize("name", ["CA_8K", "LD", "restarts"])
def test_schedule_matches_jax(name):
    if name == "CA_8K":
        cfg = get_config("RefVSR_MFID_8K")
        port = schedule.from_config(cfg)
        ref = jax_schedule.from_config(jax_get_config("RefVSR_MFID_8K"))
        steps = [0, 1, 2, 3, 100, 25000, 49999, 50000, 50001, 50002, 75000,
                 100001, 150000]
    elif name == "LD":
        cfg = get_config("RefVSR_MFID_8K", LRS="LD", decay_period=(5, 12),
                         decay_rate=0.5)
        port = schedule.from_config(cfg)
        ref = jax_schedule.from_config(jax_get_config(
            "RefVSR_MFID_8K", LRS="LD", decay_period=(5, 12),
            decay_rate=0.5))
        steps = list(range(20))
    else:
        args = (4e-4, 1e-7, [8, 8, 6, 4])
        kw = dict(restarts=[8, 16, 22], restart_weights=[1.0, 0.5, 0.25])
        port = schedule.cosine_annealing_restart(*args, **kw)
        ref = jax_schedule.cosine_annealing_restart(*args, **kw)
        steps = list(range(40))
    np.testing.assert_allclose([port(s) for s in steps],
                               [float(ref(s)) for s in steps], rtol=1e-5)


def test_clipped_adam_matches_optax(rng):
    """Three updates on fixed arrays, the first two with a gradient norm
    above gc (clipped), the last below; one parameter gets no gradient in
    the second update (a zero gradient, as in JAX)."""
    sched = schedule.cosine_annealing_restart(2e-4, 1e-6, 10, restarts=[0],
                                              restart_weights=[1.0])
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8),
                     optax.scale_by_learning_rate(
                         jax_schedule.cosine_annealing_restart(
                             2e-4, 1e-6, 10, restarts=[0],
                             restart_weights=[1.0])))
    shapes = [(3, 4), (5,), (2, 2, 3)]
    p_np = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * sc
              for s in shapes] for sc in (3.0, 2.0, 0.01)]
    grads[1][1] = None
    params_j = [jnp.asarray(p) for p in p_np]
    state = tx.init(params_j)
    ps = [torch.from_numpy(p.copy()) for p in p_np]
    opt = ClippedAdam(ps, 1.0, 0.9, sched)
    for gs in grads:
        g_j = [jnp.zeros(s) if g is None else jnp.asarray(g)
               for g, s in zip(gs, shapes)]
        upd, state = tx.update(g_j, state, params_j)
        params_j = optax.apply_updates(params_j, upd)
        norm = opt.update([None if g is None else torch.from_numpy(g)
                           for g in gs])
        np.testing.assert_allclose(float(norm),
                                   float(optax.global_norm(g_j)), rtol=1e-6)
        for p, pj in zip(ps, params_j):
            np.testing.assert_allclose(p.numpy(), np.asarray(pj),
                                       rtol=2.4e-7, atol=1e-9)
    assert opt.step == 3


def test_loss_params_from_jax_loads_8k_loss_module():
    cfg = get_config("RefVSR_MFID_8K")
    jmod = JaxLossModule(spec=cfg.loss, scale=4, flag_HD_in=True,
                         vgg_layer=cfg.CX_vgg_layer)
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1, 16, 16, 3)), jnp.zeros((1, 2, 64, 64, 3))))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  shapes)
    sd = loss_params_from_jax(tree)
    mod = LossModule(cfg.loss, scale=4, flag_HD_in=True,
                     vgg_layer=cfg.CX_vgg_layer)
    assert set(sd) == set(mod.state_dict())
    assert "cx_MFID_ref.vgg.25.weight" in sd    # conv4_4, under relu4_4
    mod.load_state_dict(sd, strict=True)


def test_trainer_defaults_to_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        Trainer(get_config("RefVSR_MFID_8K", **SMALL))
