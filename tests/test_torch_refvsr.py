"""The port's streaming slice against the JAX package at tiny size.

RefVSR_MFID_8K's wiring (HD-in, matching_ksize 8, scale 4) with 2 blocks,
8 channels, T = 3 and 16x16 frames, the geometry of
tests/test_full_net_parity.py:122-164. The same numpy inputs and the same
parameters (carried over by ``params_from_jax``) go through the JAX net's
forward_first -> forward_stream -> forward_stream and through the port's
``StreamRunner(device="cpu")``. Outputs and the carried state agree within
atol 2e-4, the full-net precedent (f32 convolutions summed in another order
through ~60 layers).

The default ``RefVSR_MFID`` wiring (flag_HD_in False, matching_ksize 2,
refs at 2x the LR size) runs beside it at the same size and tolerance. Its
weights are the port's seeded init, carried to the JAX net by the JAX
package's ``convert_state_dict``, and the JAX entry points run jitted.

``forward_stream`` on a state without tails (``init_stream_state``) matches
and encodes frames center..T-1 and starts its ring at base 0, as the JAX
net does; its output and state agree with the JAX net's at the same
tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refvsr_tpu.models.refvsr import RefVSRNet as JaxNet
from refvsr_tpu.models.refvsr import init_stream_state as jax_init_state
from refvsr_tpu.utils.convert import convert_state_dict
from refvsr_tpu_torch.configs import get_config
from refvsr_tpu_torch.eval.stream import StreamRunner
from refvsr_tpu_torch.models.blocks import init_weights
from refvsr_tpu_torch.models.refvsr import (RefVSRNet, build_refvsr,
                                            init_stream_state)
from refvsr_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

N, T, H, W = 1, 3, 16, 16
BLOCKS, MID, KS = 2, 8, 8
ATOL = 2e-4
STATE_KEYS = ("feat_prop", "feat_prop_up", "conf_prop", "aligned_tail",
              "aligned_up_tail")


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def hd_nets():
    """The HD-in wiring's JAX net, its parameters and the port's net
    holding them."""
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.random((N, T, H, W, 3)).astype(np.float32))
    jnet = JaxNet(scale=4, num_blocks=BLOCKS, mid_channels=MID,
                  matching_ksize=KS, flag_HD_in=True)
    params = jnet.init(jax.random.PRNGKey(3), x, x,
                       jax_init_state(N, H, W, MID, num_frames=T))
    net = RefVSRNet(scale=4, num_blocks=BLOCKS, mid_channels=MID,
                    matching_ksize=KS, flag_HD_in=True)
    net.load_state_dict(params_from_jax(_np_tree(params)), strict=True)
    return jnet, params, net


@pytest.fixture(scope="module")
def slice_run(hd_nets):
    """JAX and port outputs and states for three windows, computed once."""
    rng = np.random.default_rng(5)
    frames = T + 2
    lrs_all = rng.random((N, frames, H, W, 3)).astype(np.float32)
    refs_all = rng.random((N, frames, H, W, 3)).astype(np.float32)
    jnet, params, net = hd_nets
    runner = StreamRunner(net, reset_branch=None, device="cpu")

    results = []
    st = None
    for wi in range(3):
        lrs = lrs_all[:, wi:wi + T]
        refs = refs_all[:, wi:wi + T]
        if wi == 0:
            out_j, st, _ = jnet.apply(params, jnp.asarray(lrs),
                                      jnp.asarray(refs),
                                      method=JaxNet.forward_first)
        else:
            out_j, st, _ = jnet.apply(params, jnp.asarray(lrs),
                                      jnp.asarray(refs), st,
                                      method=JaxNet.forward_stream)
        out_t, _ = runner.process(lrs, refs, is_first=(wi == 0))
        # the port's rings are updated in place: snapshot them now
        st_t = {k: getattr(runner.state, k).clone().numpy()
                for k in STATE_KEYS}
        st_j = {k: np.asarray(getattr(st, k), np.float32) for k in STATE_KEYS}
        results.append((np.asarray(out_j, np.float32), out_t, st_j, st_t,
                        int(st.tail_base), runner.state.tail_base))
    return results


@pytest.fixture(scope="module")
def default_run():
    """The default wiring's JAX and port outputs and states for three
    windows (forward_first, then two forward_stream), computed once."""
    rng = np.random.default_rng(6)
    frames = T + 2
    lrs_all = rng.random((N, frames, H, W, 3)).astype(np.float32)
    refs_all = rng.random((N, frames, 2 * H, 2 * W, 3)).astype(np.float32)
    net = RefVSRNet(scale=4, num_blocks=BLOCKS, mid_channels=MID,
                    matching_ksize=2, flag_HD_in=False)
    init_weights(net, torch.Generator().manual_seed(3))
    jnet = JaxNet(scale=4, num_blocks=BLOCKS, mid_channels=MID,
                  matching_ksize=2, flag_HD_in=False)
    shapes = jax.eval_shape(
        lambda lrs, refs: jnet.init(
            jax.random.PRNGKey(0), lrs, refs,
            jax_init_state(N, H, W, MID, num_frames=T)),
        lrs_all[:, :T], refs_all[:, :T])
    params, _, _ = convert_state_dict(
        {k: v.numpy() for k, v in net.state_dict().items()},
        jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                               shapes))
    first = jax.jit(lambda p, lrs, refs: jnet.apply(
        p, lrs, refs, method=JaxNet.forward_first))
    stream = jax.jit(lambda p, lrs, refs, st: jnet.apply(
        p, lrs, refs, st, method=JaxNet.forward_stream))
    runner = StreamRunner(net, reset_branch=None, device="cpu")
    results = []
    st = None
    for wi in range(3):
        lrs = lrs_all[:, wi:wi + T]
        refs = refs_all[:, wi:wi + T]
        if wi == 0:
            out_j, st, _ = first(params, lrs, refs)
        else:
            out_j, st, _ = stream(params, lrs, refs, st)
        out_t, _ = runner.process(lrs, refs, is_first=(wi == 0))
        st_t = {k: getattr(runner.state, k).clone().numpy()
                for k in STATE_KEYS}
        st_j = {k: np.asarray(getattr(st, k), np.float32) for k in STATE_KEYS}
        results.append((np.asarray(out_j, np.float32), out_t, st_j, st_t,
                        int(st.tail_base), runner.state.tail_base))
    return results


@pytest.fixture(scope="module")
def cold_run(hd_nets):
    """forward_stream from init_stream_state (no tails, zero carry), JAX
    and port, on the HD-in wiring: (JAX out, port out, JAX state, port
    state, JAX base, port base)."""
    rng = np.random.default_rng(7)
    lrs = rng.random((N, T, H, W, 3)).astype(np.float32)
    refs = rng.random((N, T, H, W, 3)).astype(np.float32)
    jnet, params, net = hd_nets
    out_j, st_j, _ = jax.jit(lambda p, a, b: jnet.apply(
        p, a, b, jax_init_state(N, H, W, MID, num_frames=T),
        method=JaxNet.forward_stream))(params, lrs, refs)
    with torch.no_grad():
        out_t, st_t, _ = net.forward_stream(
            torch.from_numpy(lrs), torch.from_numpy(refs),
            init_stream_state(N, H, W, MID, num_frames=T, device="cpu"))
    keys = STATE_KEYS + ("conf_tail",)
    return (np.asarray(out_j, np.float32), out_t.numpy(),
            {k: np.asarray(getattr(st_j, k), np.float32) for k in keys},
            {k: getattr(st_t, k).numpy() for k in keys},
            int(st_j.tail_base), st_t.tail_base)


def test_cold_stream_output_matches_jax(cold_run):
    out_j, out_t, *_ = cold_run
    assert out_t.shape == (N, 4 * H, 4 * W, 3)
    np.testing.assert_allclose(out_t, out_j, atol=ATOL)


@pytest.mark.parametrize("key", STATE_KEYS + ("conf_tail",))
def test_cold_stream_state_matches_jax(cold_run, key):
    _, _, st_j, st_t, base_j, base_t = cold_run
    assert base_t == base_j == 0
    assert st_t[key].shape == st_j[key].shape
    np.testing.assert_allclose(st_t[key], st_j[key], atol=ATOL)


@pytest.mark.parametrize("window", [0, 1, 2])
def test_stream_output_matches_jax(slice_run, window):
    out_j, out_t, *_ = slice_run[window]
    assert out_t.shape == (N, 4 * H, 4 * W, 3)
    np.testing.assert_allclose(out_t, out_j, atol=ATOL)


@pytest.mark.parametrize("window", [0, 1, 2])
@pytest.mark.parametrize("key", STATE_KEYS)
def test_stream_state_matches_jax(slice_run, window, key):
    _, _, st_j, st_t, base_j, base_t = slice_run[window]
    assert base_t == base_j
    assert st_t[key].shape == st_j[key].shape
    np.testing.assert_allclose(st_t[key], st_j[key], atol=ATOL)


@pytest.mark.parametrize("window", [0, 1, 2])
def test_default_wiring_output_matches_jax(default_run, window):
    out_j, out_t, *_ = default_run[window]
    assert out_t.shape == (N, 4 * H, 4 * W, 3)
    # most of the frame lies inside the clamp, so the values are compared
    assert ((out_t > 0) & (out_t < 1)).mean() > 0.5
    np.testing.assert_allclose(out_t, out_j, atol=ATOL)


@pytest.mark.parametrize("window", [0, 1, 2])
@pytest.mark.parametrize("key", STATE_KEYS)
def test_default_wiring_state_matches_jax(default_run, window, key):
    _, _, st_j, st_t, base_j, base_t = default_run[window]
    assert base_t == base_j
    assert st_t[key].shape == st_j[key].shape
    np.testing.assert_allclose(st_t[key], st_j[key], atol=ATOL)


def test_reset_branch_reanchors(slice_run):
    """After `reset_branch` streamed windows the runner runs forward_first
    again: with reset_branch=1 the second window equals a fresh first
    window on the same frames."""
    rng = np.random.default_rng(1)
    lrs = rng.random((N, T + 1, H, W, 3)).astype(np.float32)
    refs = rng.random((N, T + 1, H, W, 3)).astype(np.float32)
    net = build_refvsr(get_config("RefVSR_MFID_8K", num_blocks=1,
                                  mid_channels=8), device="cpu")
    runner = StreamRunner(net, reset_branch=1, device="cpu")
    runner.process(lrs[:, :T], refs[:, :T], is_first=True)
    again, _ = runner.process(lrs[:, 1:], refs[:, 1:], is_first=False)
    fresh = StreamRunner(net, reset_branch=None, device="cpu")
    want, _ = fresh.process(lrs[:, 1:], refs[:, 1:], is_first=True)
    np.testing.assert_array_equal(again, want)
    assert runner.count == 1
