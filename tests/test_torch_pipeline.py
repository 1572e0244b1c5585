"""The port's pipelined stream and zero-flow net against the JAX package.

The tiny net of tests/test_pipeline_stream.py (scale 4, 2 blocks, 8
channels, T = 7, 16x16 frames) with the JAX package's parameters carried
over by ``params_from_jax``. Dataset-style stride-1 windows (the clamp rule
of datasets.py:233-234) of seeded numpy videos go through the JAX
``StreamRunner`` in pipelined mode and through the port's ``StreamRunner``
in pipelined and in plain mode, all by ``submit``/``flush``. Every emitted
``(meta, sr)`` of the port's pipelined run equals the JAX run's within atol
2e-4 (f32 convolutions through about 60 layers, summed in another order)
and the port's plain run's within 2e-5 (the same ops on a batch of lanes,
the JAX test's tolerance), in the same order and with the same metas.
Cases: L = 2 with reset_branch = 2 over two videos (mid-video re-anchors,
a video boundary inside ``submit``, the end flush) and L = 4 with no reset
(one batch-4 step per dispatch, three chains drained at ``flush``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refvsr_tpu.eval.stream import StreamRunner as JaxRunner
from refvsr_tpu.models.refvsr import RefVSRNet as JaxNet
from refvsr_tpu.models.refvsr import init_stream_state as jax_init_state
from refvsr_tpu_torch.eval.stream import StreamRunner
from refvsr_tpu_torch.models.refvsr import RefVSRNet
from refvsr_tpu_torch.utils.convert import params_from_jax

N, T, H, W = 1, 7, 16, 16
TINY = dict(scale=4, num_blocks=2, mid_channels=8, matching_ksize=2,
            flag_HD_in=False)
ATOL_JAX, ATOL_PLAIN = 2e-4, 2e-5
CASES = {"lanes2_reset2": (2, 2, ((11, 1), (8, 2))),
         "lanes4_no_reset": (4, None, ((10, 3),))}


@pytest.fixture(scope="module")
def weights():
    """(JAX params, the port's state dict) of the tiny net."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.random((N, T, H, W, 3), dtype=np.float32))
    params = JaxNet(**TINY).init(jax.random.PRNGKey(0), x, x,
                                 jax_init_state(N, H, W, 8, num_frames=T))
    sd = params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), params))
    return params, sd


def _port_net(sd, **kw):
    net = RefVSRNet(**TINY, **kw)
    net.load_state_dict(sd, strict=True)
    return net


def _video(frames, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((N, frames, H, W, 3), dtype=np.float32),
            rng.random((N, frames, H, W, 3), dtype=np.float32))


def _windows(videos):
    """(meta, lrs, refs, is_first) of every window: output frame d's window
    is frames clip(d-c .. d+c)."""
    c = T // 2
    for v, (lr, ref) in enumerate(videos):
        f = lr.shape[1]
        for d in range(f):
            idx = np.clip(np.arange(d - c, d + c + 1), 0, f - 1)
            yield (v, d), lr[:, idx], ref[:, idx], d == 0


def _jax_fns(net):
    return {name: jax.jit(functools.partial(net.apply,
                                            method=getattr(JaxNet, name)))
            for name in ("forward_first", "forward_stream",
                         "forward_stream_prime", "forward_stream_pipelined")}


def _drive(runner, videos):
    """Every (meta, sr) the runner emits, in order."""
    out = []
    for meta, lrs, refs, first in _windows(videos):
        out += [(m, np.asarray(sr, np.float32))
                for m, sr, _ in runner.submit(lrs, refs, first, meta=meta)]
    return out + [(m, np.asarray(sr, np.float32))
                  for m, sr, _ in runner.flush()]


@pytest.fixture(scope="module")
def runs(weights):
    """For each case: the emitted sequences of the JAX pipelined runner,
    the port's pipelined runner and the port's plain runner."""
    params, sd = weights
    res = {}
    for case, (lanes, reset, vids) in CASES.items():
        videos = [_video(*v) for v in vids]
        fns = _jax_fns(JaxNet(**TINY, pipeline_lanes=lanes))
        jax_runner = JaxRunner(
            None, params, reset, fns["forward_first"], fns["forward_stream"],
            eval_prime=fns["forward_stream_prime"],
            eval_pipelined=fns["forward_stream_pipelined"],
            pipeline_lanes=lanes)
        piped = StreamRunner(_port_net(sd, pipeline_lanes=lanes), reset,
                             device="cpu", pipeline_lanes=lanes)
        plain = StreamRunner(_port_net(sd), reset, device="cpu")
        res[case] = {"jax": _drive(jax_runner, videos),
                     "port": [(m, sr.copy()) for m, sr in _drive(piped,
                                                                  videos)],
                     "plain": _drive(plain, videos),
                     "frames": sum(v[0] for v in vids)}
    return res


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipelined_emits_every_frame_in_order(runs, case):
    r = runs[case]
    metas = [m for m, _ in r["port"]]
    assert len(metas) == r["frames"]
    assert metas == [m for m, _ in r["plain"]] == [m for m, _ in r["jax"]]
    assert metas == sorted(metas)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipelined_matches_jax(runs, case):
    r = runs[case]
    for (meta, got), (_, want) in zip(r["port"], r["jax"]):
        assert got.shape == (N, 4 * H, 4 * W, 3)
        np.testing.assert_allclose(got, want, atol=ATOL_JAX,
                                   err_msg=f"frame {meta}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipelined_matches_plain(runs, case):
    r = runs[case]
    for (meta, got), (_, want) in zip(r["port"], r["plain"]):
        np.testing.assert_allclose(got, want, atol=ATOL_PLAIN,
                                   err_msg=f"frame {meta}")


def test_lanes_above_two_with_reset_refused(weights):
    net = _port_net(weights[1], pipeline_lanes=4)
    with pytest.raises(NotImplementedError):
        StreamRunner(net, 4, device="cpu", pipeline_lanes=4)


def test_runner_lanes_must_match_the_net(weights):
    with pytest.raises(ValueError):
        StreamRunner(_port_net(weights[1]), None, device="cpu",
                     pipeline_lanes=2)


def test_process_refused_when_pipelined(weights):
    runner = StreamRunner(_port_net(weights[1], pipeline_lanes=2), None,
                          device="cpu", pipeline_lanes=2)
    lrs, refs = _video(T, 4)
    with pytest.raises(RuntimeError):
        runner.process(lrs, refs, is_first=True)
    with pytest.raises(RuntimeError):
        runner.process_device(lrs, refs, is_first=True)


def test_plain_submit_is_process_and_flush_is_empty(weights):
    lrs, refs = _video(T + 1, 5)
    a = StreamRunner(_port_net(weights[1]), None, device="cpu")
    b = StreamRunner(_port_net(weights[1]), None, device="cpu")
    for i in range(2):
        (meta, sr, _), = a.submit(lrs[:, i:i + T], refs[:, i:i + T],
                                  i == 0, meta=i)
        want, _ = b.process(lrs[:, i:i + T], refs[:, i:i + T], i == 0)
        assert meta == i
        np.testing.assert_array_equal(sr.numpy(), want)
    assert a.flush() == []


@pytest.fixture(scope="module")
def zero_flow_run(weights):
    """forward_first and two forward_stream windows of the zero-flow net,
    JAX and port."""
    params, sd = weights
    jnet = JaxNet(**TINY, zero_flow=True)
    fns = _jax_fns(jnet)
    net = _port_net(sd, zero_flow=True)
    lr, ref = _video(T + 2, 6)
    out = []
    st_j = st_t = None
    with torch.no_grad():
        for wi in range(3):
            lrs, refs = lr[:, wi:wi + T], ref[:, wi:wi + T]
            if wi == 0:
                o_j, st_j, _ = fns["forward_first"](params, lrs, refs)
                o_t, st_t, _ = net.forward_first(torch.from_numpy(lrs),
                                                 torch.from_numpy(refs))
            else:
                o_j, st_j, _ = fns["forward_stream"](params, lrs, refs, st_j)
                o_t, st_t, _ = net.forward_stream(torch.from_numpy(lrs),
                                                  torch.from_numpy(refs),
                                                  st_t)
            out.append((np.asarray(o_j, np.float32), o_t.numpy(),
                        float(np.abs(np.asarray(st_t.flows_fwd)).max())))
    return out


@pytest.mark.parametrize("window", [0, 1, 2])
def test_zero_flow_matches_jax(zero_flow_run, window):
    want, got, flow_max = zero_flow_run[window]
    assert flow_max == 0.0
    np.testing.assert_allclose(got, want, atol=ATOL_JAX)


def test_zero_flow_skips_spynet(weights):
    """Under zero_flow the flows are zeros and SPyNet never runs; its
    parameters stay in the net."""
    net = _port_net(weights[1], zero_flow=True)
    assert any(k.startswith("FlowNet.") for k in net.state_dict())
    calls = []
    net.FlowNet.register_forward_hook(lambda *a: calls.append(1))
    lrs = torch.rand((N, T, H, W, 3))
    fwd, bwd = net.compute_flows(lrs)
    assert fwd.shape == bwd.shape == (N, T - 1, H, W, 2)
    assert not fwd.any() and not bwd.any() and not calls
