"""The port's RefVSR-IR net (``refvsr_tpu_torch/models/refvsr_ir.py``) and
its streaming against the JAX package, on the CPU in f32.

A tiny net (2 blocks, 8 channels, EDVR-M at its 64 channels, T = 5,
``keyframe_stride`` 2) with the port's seeded weights, offset convs
redrawn (``tests/torch_ir_nets.py``), carried to the JAX net by
``convert_state_dict``. Frames 16x16 (no padding) and 18x14 (EDVR's /4
reflect padding to 20x16, cropped back), refs at twice the size.

``forward_first`` then two ``forward_stream`` windows, with the sliding
keyframe masks a stream gives them: the output, the confidence maps and
every state tensor within atol 2e-4, the full-net precedent of
tests/test_torch_refvsr.py (f32 convolutions through ~80 layers summed in
another order). The port runs EDVR at the keyframes only, JAX for every
frame with the others discarded: the equal outputs show the two
formulations agree (tests/test_torch_ir_train.py holds the gradients)."""

import jax
import numpy as np
import pytest
import torch

from refvsr_tpu.eval.stream import StreamRunner as JaxStreamRunner
from refvsr_tpu.models.refvsr_ir import RefVSRIRNet as JaxIRNet
from refvsr_tpu.models.refvsr_ir import \
    sliding_keyframe_mask as jax_sliding_keyframe_mask
from refvsr_tpu_torch.eval.stream import StreamRunner
from refvsr_tpu_torch.models.refvsr import init_stream_state
from refvsr_tpu_torch.models.refvsr_ir import sliding_keyframe_mask
from torch_ir_nets import MID, STRIDE, T, jax_params, port_net

torch.set_num_threads(2)

ATOL = 2e-4
STATE_KEYS = ("feat_prop", "feat_prop_up", "conf_prop", "flow", "flows_fwd",
              "flows_bwd")
SIZES = [(16, 16), (18, 14)]


_JAX = {}


def _jax(fix=False):
    """The JAX net and its jitted entry points (first, stream, train),
    shared by the fixtures so that each shape compiles once."""
    if fix not in _JAX:
        jnet = JaxIRNet(scale=4, num_blocks=2, mid_channels=MID,
                        matching_ksize=2, keyframe_stride=STRIDE,
                        fix_stale_flow_bug=fix)
        _JAX[fix] = (jnet,) + tuple(
            jax.jit(lambda p, *a, m=m: jnet.apply(p, *a, method=m))
            for m in (JaxIRNet.forward_first, JaxIRNet.forward_stream,
                      JaxIRNet.forward_train))
    return _JAX[fix]


@pytest.mark.parametrize("t,stride", [(5, 2), (9, 5), (9, 3), (13, 4),
                                      (7, 7), (6, 1)])
def test_sliding_keyframe_mask_matches_jax(t, stride):
    """Equal masks and first indices over a stream of windows, reset
    twice."""
    first_t = first_j = None
    for wi in range(3 * t):
        reset = wi % (t + 2) == 0
        m_t, first_t = sliding_keyframe_mask(t, stride,
                                             None if reset else first_t)
        m_j, first_j = jax_sliding_keyframe_mask(t, stride,
                                                 None if reset else first_j)
        np.testing.assert_array_equal(m_t, m_j)
        assert first_t == first_j
        assert m_t[-1] and m_t.dtype == bool


@pytest.fixture(scope="module", params=SIZES, ids=["16x16", "18x14"])
def stream_run(request):
    """JAX and port outputs, conf maps and states over forward_first and
    two forward_stream windows at one size."""
    h, w = request.param
    rng = np.random.default_rng(h * 100 + w)
    lrs_all = rng.random((1, T + 2, h, w, 3)).astype(np.float32)
    refs_all = rng.random((1, T + 2, 2 * h, 2 * w, 3)).astype(np.float32)
    net = port_net()
    jnet, first, stream, _ = _jax()
    params = jax_params(net, h, w, jnet)
    results = []
    st_j = st_t = kf = None
    for wi in range(3):
        lrs, refs = lrs_all[:, wi:wi + T], refs_all[:, wi:wi + T]
        mask, kf = sliding_keyframe_mask(T, STRIDE, kf)
        with torch.no_grad():
            a, b = torch.from_numpy(lrs), torch.from_numpy(refs)
            if wi == 0:
                out_j, st_j, conf_j = first(params, lrs, refs, mask)
                out_t, st_t, conf_t = net.forward_first(a, b, mask)
            else:
                out_j, st_j, conf_j = stream(params, lrs, refs, st_j, mask)
                out_t, st_t, conf_t = net.forward_stream(a, b, st_t, mask)
        results.append(dict(
            out=(np.asarray(out_j), out_t.numpy()),
            conf=[(np.asarray(cj), ct.numpy())
                  for cj, ct in zip(conf_j, conf_t)],
            state={k: (np.asarray(getattr(st_j, k)),
                       getattr(st_t, k).numpy()) for k in STATE_KEYS}))
    return (h, w), results


@pytest.mark.parametrize("window", [0, 1, 2])
def test_stream_output_matches_jax(stream_run, window):
    (h, w), res = stream_run
    want, got = res[window]["out"]
    assert got.shape == want.shape == (1, 4 * h, 4 * w, 3)
    assert got.min() >= 0 and got.max() <= 1
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    for (cj, ct), name in zip(res[window]["conf"], ("bw", "fw", "match")):
        assert ct.shape == cj.shape == (1, h, w, 1), name
        np.testing.assert_allclose(ct, cj, rtol=0, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("window", [0, 1, 2])
@pytest.mark.parametrize("key", STATE_KEYS)
def test_stream_state_matches_jax(stream_run, window, key):
    want, got = stream_run[1][window]["state"][key]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def train_window_runs():
    """forward_train on one window, the reference bug kept and fixed, JAX
    and port, from a state carried in (a first window's)."""
    h = w = 16
    rng = np.random.default_rng(21)
    lrs = rng.random((1, T, h, w, 3)).astype(np.float32)
    refs = rng.random((1, T, 2 * h, 2 * w, 3)).astype(np.float32)
    mask, _ = sliding_keyframe_mask(T, STRIDE, 1)
    first_lrs = lrs[:, ::-1].copy()
    first_mask = sliding_keyframe_mask(T, STRIDE, None)[0]
    runs = {}
    for fix in (False, True):
        net = port_net(fix_stale_flow_bug=fix)
        with torch.no_grad():
            # flows of a few pixels, so that the stale flow differs from
            # the true one by more than the parity tolerance
            for name, p in net.FlowNet.named_parameters():
                if ".basic_module.4." in name:
                    p.mul_(5.0)
            _, st_t, _ = net.forward_first(torch.from_numpy(first_lrs),
                                           torch.from_numpy(refs))
            out_t, st_t = net.forward_train(torch.from_numpy(lrs),
                                            torch.from_numpy(refs), st_t,
                                            mask)
        jnet, first, _, train = _jax(fix)
        params = jax_params(net, h, w, jnet)
        _, st_j, _ = first(params, first_lrs, refs, first_mask)
        out_j, st_j = train(params, lrs, refs, st_j, mask)
        runs[fix] = (np.asarray(out_j), out_t.numpy(),
                     {k: (np.asarray(getattr(st_j, k)),
                          getattr(st_t, k).numpy()) for k in STATE_KEYS})
    return runs


@pytest.mark.parametrize("fix", [False, True], ids=["bug_kept", "fixed"])
def test_forward_train_matches_jax(train_window_runs, fix):
    want, got, states = train_window_runs[fix]
    assert got.shape == want.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    for k, (sj, st) in states.items():
        np.testing.assert_allclose(st, sj, rtol=0, atol=ATOL, err_msg=k)


def test_fix_stale_flow_bug_changes_the_output(train_window_runs):
    """The flag moves the output by far more than the port and JAX differ
    on either setting, so the parity above tells the two apart."""
    a, b = train_window_runs[False][1], train_window_runs[True][1]
    noise = max(float(np.abs(r[1] - r[0]).max())
                for r in train_window_runs.values())
    assert np.abs(a - b).max() > max(10 * noise, 1e-5)


@pytest.fixture(scope="module")
def runner_run():
    """Seven windows of a 9-frame clip through the JAX and the port's
    StreamRunner with reset_branch 2: outputs and keyframe anchors."""
    h = w = 16
    rng = np.random.default_rng(31)
    lrs_all = rng.random((1, 9 + T, h, w, 3)).astype(np.float32)
    refs_all = rng.random((1, 9 + T, 2 * h, 2 * w, 3)).astype(np.float32)
    net = port_net(seed=5)
    jnet, first, stream, _ = _jax()
    params = jax_params(net, h, w, jnet)
    r_j = JaxStreamRunner(jnet, params, 2, first, stream,
                          keyframe_stride=STRIDE)
    r_t = StreamRunner(net, 2, device="cpu", keyframe_stride=STRIDE)
    out = []
    for wi in range(7):
        a, b = lrs_all[:, wi:wi + T], refs_all[:, wi:wi + T]
        o_j, _ = r_j.process(a, b, is_first=wi == 0)
        o_t, _ = r_t.process(a, b, is_first=wi == 0)
        out.append((o_j, o_t, r_j.kf_first, r_t.kf_first, r_t.count))
    return out


def test_stream_runner_keyframes_across_resets(runner_run):
    anchors = [(kj, kt) for _, _, kj, kt, _ in runner_run]
    assert [kj for kj, _ in anchors] == [kt for _, kt in anchors]
    # reset_branch 2: windows 0, 2, 4 and 6 start the branch again
    assert [c for *_, c in runner_run] == [1, 2, 1, 2, 1, 2, 1]
    assert [kt for _, kt in anchors] == [0, 1, 0, 1, 0, 1, 0]
    for wi, (o_j, o_t, *_) in enumerate(runner_run):
        np.testing.assert_allclose(o_t, o_j, rtol=0, atol=ATOL,
                                   err_msg=f"window {wi}")


def test_stream_runner_refuses_pipelined_ir():
    net = port_net()
    with pytest.raises(ValueError, match="without pipelining"):
        StreamRunner(net, None, device="cpu", pipeline_lanes=2,
                     keyframe_stride=STRIDE)
    with pytest.raises(ValueError, match="without pipelining"):
        net.forward_stream_prime(torch.zeros(1, T, 8, 8, 3),
                                 torch.zeros(1, T, 16, 16, 3),
                                 init_stream_state(1, 8, 8, MID,
                                                   num_frames=T,
                                                   device="cpu"))
