"""The port's end-to-end benchmark (``refvsr_tpu_torch.bench.e2e``) against
the JAX package, on the CPU at a tiny size.

Stream leg: the leg's net, ``RefVSR_MFID_8K``'s wiring (HD-in,
``matching_ksize`` 8) at the size of ``tests/test_torch_refvsr.py`` (2
blocks, 8 channels, T = 3, 16x16 frames), with seeded weights that the JAX
package's ``convert_state_dict`` carries into the JAX net (its template
shaped by ``jax.eval_shape``, so no JAX init runs; ``params_from_jax``
carries them back unchanged), streams the leg's numpy-seeded window: one
``forward_first``, then one warm-up and two timed windows. Its last SR
frame and carried state agree with the JAX net's ``forward_first`` and
three ``forward_stream`` calls (jitted) on the same window within atol
2e-4, the full-net precedent (f32 convolutions summed in another order
through ~60 layers). The record's keys and types, the 8K-equivalent metric
below 8K, the pipelined leg, and the numerics gate failing on a NaN planted
in the carried state and on a constant output (both planted by wrapping
the net's ``forward_stream``).

Train leg: its batch equals, array for array, a replay of ``bench.py``'s
draws; its first ``Trainer.iteration`` (``RefVSR_MFID``, 2 blocks, 8
channels, T = 3, patch 16, one window) gives the JAX ``Trainer.iteration``'s
mean errors on that batch within rtol 2e-4 plus atol 1e-6, the tolerance
of ``tests/test_torch_train.py``, from the same initial network and loss
VGG parameters (the port Trainer's seeded ones, carried into a JAX
``TrainState`` as above).

The command line: without a card and without ``--device cpu`` it exits
non-zero before any work; a bare run prints the stream record, then the
merged record last."""

import functools
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refvsr_tpu.configs import get_config as jax_get_config
from refvsr_tpu.models.refvsr import RefVSRNet as JaxNet
from refvsr_tpu.models.refvsr import init_stream_state as jax_init_state
from refvsr_tpu.train.trainer import Trainer as JaxTrainer
from refvsr_tpu.train.trainer import TrainState
from refvsr_tpu.utils.convert import convert_state_dict
from refvsr_tpu_torch.bench import e2e
from refvsr_tpu_torch.configs import get_config
from refvsr_tpu_torch.models.refvsr import build_refvsr
from refvsr_tpu_torch.train.trainer import Trainer
from refvsr_tpu_torch.utils.convert import (loss_params_from_jax,
                                            params_from_jax)
from test_torch_refvsr import H, STATE_KEYS, T, W

torch.set_num_threads(2)

ATOL = 2e-4
WARMUP, ITERS = 1, 2
TINY = dict(num_blocks=2, mid_channels=8)
TINY_TRAIN = dict(patch=16, frame_num=3, windows=1, **TINY)
RECORD_KEYS = {"metric": str, "value": float, "unit": str,
               "vs_baseline": float, "raw_fps": float, "out_shape": list,
               "lanes": int, "k1_launches": int, "k2_launches": int,
               "ms_per_window": float, "window_ms": list, "card": str}


def _np(a):
    return np.asarray(a, np.float32)


def _carried(jnet, net, *init_args):
    """The JAX parameters of `jnet` holding the port net's: its seeded
    state dict through the JAX package's ``convert_state_dict`` into a
    template shaped by ``jax.eval_shape`` (no JAX init runs); checked by
    carrying them back with ``params_from_jax``."""
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0),
                                              *init_args))
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    params, missing, unused = convert_state_dict(
        sd, jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                                   shapes))
    assert not missing and not unused
    back = params_from_jax(params)
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    return params


@pytest.fixture(scope="module")
def hd_pair():
    """The stream leg's net at tiny width (RefVSR_MFID_8K wiring: HD-in,
    matching_ksize 8) with seeded weights, and the JAX net holding them."""
    cfg = get_config("RefVSR_MFID_8K", frame_num=T, **TINY)
    net = build_refvsr(cfg, device="cpu", seed=3)
    jnet = JaxNet(scale=4, num_blocks=cfg.num_blocks,
                  mid_channels=cfg.mid_channels,
                  matching_ksize=cfg.matching_ksize, flag_HD_in=True)
    x = np.zeros((1, T, H, W, 3), np.float32)
    params = _carried(jnet, net, x, x,
                      jax_init_state(1, H, W, cfg.mid_channels,
                                     num_frames=T))
    return jnet, params, net


@pytest.fixture(scope="module")
def stream_run(hd_pair):
    """The JAX net and the bench's stream leg on the same window."""
    jnet, params, net = hd_pair
    lrs, refs = e2e.stream_frames(H, W, T)
    x, r = jnp.asarray(lrs), jnp.asarray(refs)
    first, stream = (jax.jit(functools.partial(jnet.apply, method=m))
                     for m in (JaxNet.forward_first, JaxNet.forward_stream))
    out_j, st, _ = first(params, x, r)
    for _ in range(WARMUP + ITERS):
        out_j, st, _ = stream(params, x, r, st)
    res = e2e.stream_leg(net, lrs, refs, device="cpu",
                         compute_dtype=torch.float32, warmup=WARMUP,
                         iters=ITERS)
    return dict(out=_np(out_j), state={k: _np(getattr(st, k))
                                       for k in STATE_KEYS}), res


def test_stream_leg_output_matches_jax(stream_run):
    want, res = stream_run
    got = res.out.numpy()
    assert got.shape == want["out"].shape == (1, 4 * H, 4 * W, 3)
    np.testing.assert_allclose(got, want["out"], atol=ATOL)


@pytest.mark.parametrize("key", STATE_KEYS)
def test_stream_leg_state_matches_jax(stream_run, key):
    want, res = stream_run
    np.testing.assert_allclose(getattr(res.runner.state, key).numpy(),
                               want["state"][key], atol=ATOL)


def test_stream_record_keys_and_types(stream_run):
    _, res = stream_run
    rec = res.record
    assert set(rec) == set(RECORD_KEYS) | {"peak_bytes"}
    for k, typ in RECORD_KEYS.items():
        assert isinstance(rec[k], typ), (k, rec[k])
    assert rec["peak_bytes"] is None and rec["card"] == "cpu"
    assert rec["out_shape"] == [1, 4 * H, 4 * W, 3] and rec["lanes"] == 0
    assert rec["unit"] == "fps" and len(rec["window_ms"]) == ITERS
    # below 8K the metric is normalised to 8K output pixels
    assert rec["metric"] == "stream_fps_8k_equiv"
    np.testing.assert_allclose(rec["raw_fps"], 1e3 / rec["ms_per_window"],
                               rtol=1e-3)
    # the plain versions run on the CPU: no kernel launched
    assert rec["k1_launches"] == rec["k2_launches"] == 0
    json.dumps(rec)


@pytest.mark.parametrize("out_shape,metric,scale", [
    ((1, 4320, 7680, 3), "stream_fps_8k", 1.0),
    ((1, 2176, 3840, 3), "stream_fps_8k_equiv", 2176 * 3840 / (4320 * 7680)),
])
def test_stream_record_metric_and_value(out_shape, metric, scale):
    """bench.py's _run_one: the 8K metric at 8K output, else fps
    normalised to 8K output pixels; vs_baseline is value / 30."""
    rec = e2e.stream_record(out_shape, [900.0, 1000.0], 0, 10, 1, 2 ** 30,
                            "card")
    fps = 1e3 / 950.0
    assert rec["metric"] == metric and rec["ms_per_window"] == 950.0
    assert rec["raw_fps"] == round(fps, 4)
    assert rec["value"] == round(fps * scale, 4)
    assert rec["vs_baseline"] == round(fps * scale / 30.0, 4)
    assert rec["out_shape"] == list(out_shape)
    assert (rec["k1_launches"], rec["k2_launches"], rec["peak_bytes"],
            rec["card"]) == (10, 1, 2 ** 30, "card")


def test_pipelined_leg_runs_lanes_2():
    res = e2e.run_stream(H, W, lanes=2, device="cpu", frame_num=T,
                         warmup=WARMUP, iters=ITERS, **TINY)
    rec = res.record
    assert rec["lanes"] == 2 and rec["out_shape"] == [1, 4 * H, 4 * W, 3]
    assert res.runner.state.pipe_feat is not None
    assert np.isfinite(rec["value"]) and rec["value"] > 0


def _wrapped_stream(net, plant):
    real = net.forward_stream

    def fwd(lrs, refs, state):
        out, state, conf = real(lrs, refs, state)
        return plant(out, state) + (conf,)
    return fwd


def test_gate_fails_on_nan_in_state(hd_pair, monkeypatch):
    _, _, net = hd_pair
    lrs, refs = e2e.stream_frames(H, W, T)

    def plant(out, state):
        state.feat_prop_up = state.feat_prop_up.clone()
        state.feat_prop_up[0, 0, 0, 0] = float("nan")
        return out, state
    monkeypatch.setattr(net, "forward_stream", _wrapped_stream(net, plant))
    with pytest.raises(e2e.GateError, match="feat_prop_up"):
        e2e.stream_leg(net, lrs, refs, device="cpu",
                       compute_dtype=torch.float32, warmup=0, iters=1)


def test_gate_fails_on_constant_output(hd_pair, monkeypatch):
    _, _, net = hd_pair
    lrs, refs = e2e.stream_frames(H, W, T)
    monkeypatch.setattr(net, "forward_stream", _wrapped_stream(
        net, lambda out, state: (torch.full_like(out, 0.5), state)))
    with pytest.raises(e2e.GateError, match="zero std"):
        e2e.stream_leg(net, lrs, refs, device="cpu",
                       compute_dtype=torch.float32, warmup=0, iters=1)


def test_gate_fails_on_nan_output():
    from refvsr_tpu_torch.models.refvsr import init_stream_state
    state = init_stream_state(1, 4, 4, 8, num_frames=3, device="cpu")
    out = torch.rand(1, 16, 16, 3)
    e2e.numerics_gate(out, state, 1)
    out[0, 1, 2, 0] = float("inf")
    with pytest.raises(e2e.GateError, match="non-finite"):
        e2e.numerics_gate(out, state, 1)


def test_train_batch_replays_bench_draws():
    """bench.py:151-161: default_rng(0), img() draws in dict order."""
    cfg = e2e.train_config(patch=64, batch=1, frame_num=7, windows=1)
    got = e2e.train_batch(cfg)
    rng = np.random.default_rng(0)
    t, p = 7, 64

    def img(*s):
        return rng.random(s, dtype=np.float32)
    want = {"LR_UW": img(1, t, p, p, 3),
            "LR_REF_W": img(1, t, 2 * p, 2 * p, 3),
            "HR_UW": img(1, t, 4 * p, 4 * p, 3),
            "HR_REF_W": img(1, t, 4 * p, 4 * p, 3),
            "HR_REF_T": img(1, t, 4 * p, 4 * p, 3)}
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (cfg.config, cfg.num_blocks, cfg.mid_channels, cfg.patch_size,
            cfg.batch_size, cfg.frame_itr_num, cfg.is_train,
            cfg.spynet_ckpt, cfg.vgg19_ckpt) == (
        "RefVSR_MFID", 30, 48, 64, 1, 1, True, None, None)


def _carried_loss(loss_mod, sd, *init_args):
    """The JAX LossModule's parameters holding the port's loss VGGs
    (``cx_<type>.vgg.<i>.{weight,bias}`` -> ``cx_<type>/vgg/conv_<i>/conv/
    {kernel,bias}``, OIHW -> HWIO); checked by carrying them back with
    ``loss_params_from_jax``."""
    shapes = jax.eval_shape(lambda: loss_mod.init(jax.random.PRNGKey(0),
                                                  *init_args))

    def leaf(path, a):
        names = [getattr(k, "key", str(k)) for k in path]
        cx, conv, name = names[1], names[3], names[-1]
        v = sd[f"{cx}.vgg.{conv[len('conv_'):]}."
               f"{'weight' if name == 'kernel' else 'bias'}"].numpy()
        return jnp.asarray(v.transpose(2, 3, 1, 0) if v.ndim == 4 else v)
    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    back = loss_params_from_jax(jax.tree_util.tree_map(_np, params))
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)
    return params


def test_train_leg_first_iteration_matches_jax():
    kw = TINY_TRAIN
    cfg = e2e.train_config(**kw)
    cfg_j = jax_get_config(
        "RefVSR_MFID", is_train=True, num_blocks=kw["num_blocks"],
        mid_channels=kw["mid_channels"], frame_num=kw["frame_num"],
        frame_itr_num=kw["windows"], patch_size=kw["patch"], batch_size=1,
        spynet_ckpt=None, vgg19_ckpt=None)
    batch = e2e.train_batch(cfg)
    jtr = JaxTrainer(cfg_j)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # no pretrained SPyNet / VGG
        tr = Trainer(cfg, device="cpu")
    t, p = cfg.frame_num, cfg.patch_size
    params = _carried(jtr.net, tr.net, batch["LR_UW"][:, :t],
                      batch["LR_REF_W"][:, :t],
                      jax_init_state(1, p, p, cfg.mid_channels,
                                     num_frames=t))
    hr = np.zeros((1, 4 * p, 4 * p, 3), np.float32)
    loss_params = _carried_loss(jtr.loss_mod, tr.loss_mod.state_dict(), hr,
                                hr, batch["HR_REF_W"][:, :t])
    ts = TrainState(params=params, opt_state=jtr.tx.init(params),
                    step=jnp.zeros((), jnp.int32))
    _, want, _ = jtr.iteration(ts, loss_params, batch)
    fields, got = e2e.train_leg(tr, batch, iters=1)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=2e-4,
                                   atol=1e-6, err_msg=k)
    assert fields["train_patch"] == 16 and fields["train_windows"] == 1
    assert fields["train_steps_per_s"] > 0
    assert set(fields["train_launches"]) == {
        "warp_sample", "warp_sample_backward", "argmax_matmul",
        "argmax_matmul_backward"}


def test_entry_point_needs_the_card_without_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def never(*a, **k):
        raise AssertionError("a leg ran without a card")
    monkeypatch.setattr(e2e, "run_stream", never)
    monkeypatch.setattr(e2e, "run_train", never)
    with pytest.raises(SystemExit) as exc:
        e2e.main([])
    assert exc.value.code not in (0, None)
    with pytest.raises(SystemExit) as exc:
        e2e.main(["--train"])
    assert exc.value.code not in (0, None)


def test_bare_run_prints_stream_then_merged_record(monkeypatch, capsys):
    calls = []
    real_stream, real_train = e2e.run_stream, e2e.run_train

    def stream(h, w, lanes=0, device="cuda"):
        calls.append(("stream", h, w, lanes, device))
        return real_stream(H, W, lanes=lanes, device=device, frame_num=T,
                           warmup=0, iters=1, **TINY)

    def train(device="cuda"):
        calls.append(("train", device))
        return real_train(device=device, iters=1, **TINY_TRAIN)
    monkeypatch.setattr(e2e, "run_stream", stream)
    monkeypatch.setattr(e2e, "run_train", train)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        e2e.main(["--device", "cpu"])
    assert calls == [("stream", 1080, 1920, 0, "cpu"), ("train", "cpu")]
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    first, last = (json.loads(x) for x in lines)
    assert set(first) <= set(last)
    assert {"train_steps_per_s", "train_patch", "train_windows"} <= set(last)
    assert last["metric"] == first["metric"] == "stream_fps_8k_equiv"
    # --size alone: the stream leg only
    calls.clear()
    e2e.main(["--size", "16x24", "--device", "cpu"])
    assert calls == [("stream", 16, 24, 0, "cpu")]
    assert len(capsys.readouterr().out.strip().splitlines()) == 1
