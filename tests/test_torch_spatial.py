"""The port's H-sharded stream (``refvsr_tpu_torch/parallel/spatial.py``,
``parallel/serve.py``) on gloo CPU ranks.

One spawned group per world size (2 and 4), each joined under a timeout
of its own, runs every case of its size; the JAX side and the one-rank
references run in the pytest process, and rank 0 hands the gathered
results back.

- The five shard-local ops and the banded warp's plain version against
  the JAX package's ``refvsr_tpu.parallel.spatial`` functions on a 2- and
  4-device virtual mesh, at the shapes of ``tests/test_spatial_sharding.py``
  (the warp also with a flow past the halo, where both differ from the
  whole-image warp in the same way): atol 1e-5 (1e-4 for the strided
  conv, whose products the two libraries sum in other orders), indices
  exactly.
- The sharded net: ``forward_first`` and two ``forward_stream`` windows
  at N = 2 and 4 against the one-rank port (which the net tests hold to
  JAX), f32, atol 2e-5, for the default wiring, the HD-in
  ``matching_ksize`` 8 wiring at a height whose patch grids do not divide
  over 4 ranks, and the IR net.
- The eval CLI with ``--spatial_devices 2`` against the one-rank CLI's
  score lines (PSNR/SSIM within 1e-4, the precedent of
  ``tests/test_torch_eval_cli.py``).
- The set-up check on the 8K geometry (1080x1920, halo 32) at N = 2, 4
  and 8, without running the net."""

import functools
import glob
import os
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from conftest import write_clip_triplet
from refvsr_tpu.parallel import spatial as jsp
from refvsr_tpu.parallel.mesh import make_mesh
from refvsr_tpu_torch import run
from refvsr_tpu_torch.configs import get_config, save_config
from refvsr_tpu_torch.models.blocks import init_weights
from refvsr_tpu_torch.models.refvsr import RefVSRNet
from refvsr_tpu_torch.ops.kernels.argmax_matmul import argmax_matmul
from refvsr_tpu_torch.models.refvsr_ir import RefVSRIRNet
from refvsr_tpu_torch.ops.kernels.warp_sample import (warp_sample_banded_plain,
                                                      warp_sample_plain)
from refvsr_tpu_torch.parallel import mesh, serve, spatial

torch.set_num_threads(2)

JOIN_TIMEOUT_S = 300
VIDEOS = (("0003", 3), ("0004", 2))


# ---------------------------------------------------------------------------
# inputs, made once from a seed
# ---------------------------------------------------------------------------

def _op_inputs():
    rng = np.random.default_rng(11)
    f32 = np.float32
    cases = {}
    # warps: feature grid, the 2x UP grid, and a flow past the halo
    cases["warp"] = (rng.standard_normal((1, 64, 16, 8)).astype(f32),
                     rng.uniform(-1.5, 1.5, (1, 64, 16, 2)).astype(f32))
    cases["warp_up"] = (rng.standard_normal((1, 32, 8, 4)).astype(f32),
                        rng.standard_normal((1, 64, 16, 2)).astype(f32))
    far = rng.uniform(-1.5, 1.5, (1, 64, 16, 2)).astype(f32)
    far[..., 1] += np.where(np.arange(64) % 2, 9.0, -9.0)[None, :, None]
    cases["warp_far"] = (rng.standard_normal((1, 64, 16, 8)).astype(f32),
                         far)
    for gh in (64, 68):
        ks, gw, c = 2, 6, 4
        hx, wx = gh * ks, gw * ks
        anchors = (1.0 + np.arange(gh) * ks)[None, :, None, None]
        p_row = anchors + rng.uniform(-3.0, 3.0, (1, gh, gw, ks * ks))
        p_col = rng.random((1, gh, gw, ks * ks)) * (wx + 1)
        p_row[0, 0, 0, 0] = -2.0
        p_row[0, -1, 0, 1] = hx + 4.0
        cases[f"fold{gh}"] = (rng.standard_normal((1, hx, wx, c)).astype(f32),
                              p_row.astype(f32), p_col.astype(f32))
    for h, stride in ((96, 4), (88, 4), (64, 8)):
        cases[f"conv{h}_{stride}"] = (
            rng.standard_normal((1, h, 24, 6)).astype(f32),
            (rng.standard_normal((5, 5, 6, 5)) * 0.2).astype(f32),
            rng.standard_normal((5,)).astype(f32), stride)
    ref = rng.standard_normal((2, 40, 12))
    lr = rng.standard_normal((2, 64, 12))
    cases["argmax"] = ((ref / np.linalg.norm(ref, axis=2, keepdims=True))
                       .astype(f32),
                       (lr / np.linalg.norm(lr, axis=2, keepdims=True))
                       .astype(f32))
    for h, w, ks in ((96, 32, 4), (88, 32, 4), (64, 32, 8)):
        n_l = (h // ks) * (w // ks)
        cases[f"pw{h}_{ks}"] = (rng.standard_normal((1, h, w, 5)).astype(f32),
                                rng.integers(0, n_l, (1, n_l)).astype(
                                    np.int32), ks)
    return cases


NETS = {
    # (constructor kwargs, LR height, width, ref height, ref width, T)
    "default": (dict(scale=4, num_blocks=1, mid_channels=8), 32, 24, 64, 48,
                3),
    "hd_k8": (dict(scale=4, num_blocks=1, mid_channels=8, matching_ksize=8,
                   flag_HD_in=True), 72, 32, 72, 32, 3),
    "ir": (dict(scale=4, num_blocks=1, mid_channels=8, keyframe_stride=2),
           32, 24, 64, 48, 5),
}


def _net(name):
    kw = NETS[name][0]
    net = (RefVSRIRNet(**kw) if name == "ir" else RefVSRNet(**kw))
    init_weights(net, torch.Generator().manual_seed(5))
    return net.eval()


def _windows(name):
    _, h, w, rh, rw, t = NETS[name]
    rng = np.random.default_rng(21)
    lr = rng.random((1, t + 2, h, w, 3), dtype=np.float32)
    ref = rng.random((1, t + 2, rh, rw, 3), dtype=np.float32)
    return [(lr[:, i:i + t], ref[:, i:i + t]) for i in range(3)]


def _stream(first, stream, name):
    kf = ()
    if name == "ir":
        from refvsr_tpu_torch.models.refvsr_ir import sliding_keyframe_mask
    outs, state, prev = [], None, None
    for i, (lr, ref) in enumerate(_windows(name)):
        if name == "ir":
            mask, prev = sliding_keyframe_mask(lr.shape[1], 2,
                                               None if i == 0 else prev)
            kf = (mask,)
        with torch.inference_mode():
            if i == 0:
                out, state, conf = first(lr, ref, *kf)
            else:
                out, state, conf = stream(lr, ref, state, *kf)
        outs.append((out.clone(), [c.clone() for c in conf]))
    return outs


# ---------------------------------------------------------------------------
# what the ranks run
# ---------------------------------------------------------------------------

def _ops_on_ranks(cases):
    """Every op on this rank's bands; the outputs gathered whole."""
    out = {}
    world = mesh.world_size()

    def band(x, dim=1):
        a, b = mesh.part(x.shape[dim], world)
        return torch.as_tensor(x).narrow(dim, a, b - a)

    def whole(y, n, dim=1):
        return spatial.gather_rows(y, n, dim)

    heights = set()
    for k, v in cases.items():
        if k.startswith(("warp", "fold", "conv", "pw")):
            heights.add(v[0].shape[1])
            if k.startswith("warp"):
                heights.add(v[1].shape[1])
    for halo in (4,):
        with spatial.spatial_sharding(halo, sorted(heights)):
            for k in ("warp", "warp_up", "warp_far"):
                x, flow = cases[k]
                out[k] = whole(spatial.sharded_warp(band(x), band(flow)),
                               flow.shape[1])
            for k in ("fold64", "fold68"):
                x, pr, pc = cases[k]
                got = spatial.sharded_affine_fold(
                    band(x), 1, torch.as_tensor(pr), torch.as_tensor(pc), 2,
                    6)
                out[k] = whole(got, x.shape[1])
            for k, v in cases.items():
                if k.startswith("conv"):
                    x, kern, bias, stride = v
                    wt = torch.as_tensor(kern).permute(3, 2, 0, 1)
                    out[k] = spatial.sharded_strided_conv_small(
                        band(x), wt, torch.as_tensor(bias), stride, 2)
            ref, lr = cases["argmax"]
            c, i = argmax_matmul(torch.as_tensor(ref), band(lr).contiguous())
            out["argmax"] = (whole(c, lr.shape[1]), whole(i, lr.shape[1]))
            for k, val in cases.items():
                if k.startswith("pw"):
                    v, idx, ks = val
                    got = spatial.sharded_patch_warp(band(v), band(idx), ks,
                                                     v.shape[1:3])
                    out[k] = whole(got, v.shape[1])
    return out


def _nets_on_ranks(names):
    out = {}
    for name in names:
        net = _net(name)
        _, h, w, rh, rw, t = NETS[name]
        fns = serve.spatial_eval_fns(
            net, 4, (1, t, h, w, 3), (1, t, rh, rw, 3),
            compute_dtype=torch.float32, device="cpu")
        states = []

        def stream(*a, **k):
            out = fns.stream(net, *a, **k)
            states.append(out[1])
            return out
        out[name] = _stream(functools.partial(fns.first, net), stream, name)
        with spatial.spatial_sharding(4, fns.heights):
            out[name + "_state"] = serve.gather_state(states[-1])
    return out


def _group_main(cases, names, eval_argv, port_b):
    torch.set_num_threads(1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if eval_argv is not None:
            run.main(eval_argv)
            os.environ["MASTER_PORT"] = str(port_b)
        mesh.init_from_env("cpu")
        try:
            return {"ops": _ops_on_ranks(cases),
                    "nets": _nets_on_ranks(names)}
        finally:
            mesh.destroy()


# ---------------------------------------------------------------------------
# the groups, once per world size
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cases():
    return _op_inputs()


@pytest.fixture(scope="module")
def eval_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial_eval")
    for i, (clip, n) in enumerate(VIDEOS):
        for j, cam in enumerate(("UW", "W", "T")):
            write_clip_triplet(root / "RealMCVSR", "test", cam, clip, n, 16,
                               16, seed=10 * i + j)
    net = RefVSRNet(scale=4, num_blocks=1, mid_channels=8, matching_ksize=8,
                    flag_HD_in=True)
    init_weights(net, torch.Generator().manual_seed(3))
    cfg = get_config("RefVSR_MFID_8K", mode="tiny8k", num_blocks=1,
                     mid_channels=8, frame_num=3, spynet_ckpt=None,
                     vgg19_ckpt=None)
    save_config(cfg, str(root / "logs" / "RefVSR_TPU" / "tiny8k" / "config"
                         / "config.json"))
    torch.save(net.state_dict(), str(root / "tiny8k.pytorch"))
    return root


def _eval_argv(root, out, *extra):
    return ["--mode", "tiny8k", "-cpu", "--data_offset", str(root),
            "--log_offset", str(root / "logs"), "--output_offset", str(out),
            "--ckpt_abs_name", str(root / "tiny8k.pytorch"),
            "--quantitative_only", *extra]


_GROUPS = {}


def _group(world, cases, eval_tree, tmp_path_factory):
    if world not in _GROUPS:
        out = tmp_path_factory.mktemp(f"spatial{world}")
        argv = (_eval_argv(eval_tree, out / "eval", "--spatial_devices", "2",
                           "--spatial_halo", "8") if world == 2 else None)
        res = mesh.spawn(_group_main, (cases, list(NETS), argv,
                                       mesh.free_port()),
                         world, JOIN_TIMEOUT_S)
        _GROUPS[world] = (world, res, out)
    return _GROUPS[world]


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def group(request, cases, eval_tree, tmp_path_factory):
    return _group(request.param, cases, eval_tree, tmp_path_factory)


@pytest.fixture(scope="module")
def group2(cases, eval_tree, tmp_path_factory):
    return _group(2, cases, eval_tree, tmp_path_factory)


# ---------------------------------------------------------------------------
# the shard-local ops against JAX
# ---------------------------------------------------------------------------

def _jshard(mesh_, x, axis=1):
    spec = P(*[None] * axis, "spatial", *[None] * (x.ndim - axis - 1))
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh_, spec))


def _jax_ops(cases, world):
    from refvsr_tpu.models.matching import tiled_argmax_matmul
    from refvsr_tpu.ops.warp import warp
    m = make_mesh(n_data=1, n_spatial=world, devices=jax.devices()[:world])
    out = {}
    with jsp.spatial_sharding(m, halo=4):
        for k in ("warp", "warp_up", "warp_far"):
            x, flow = cases[k]
            out[k] = jax.jit(warp)(_jshard(m, x), _jshard(m, flow))
        for k in ("fold64", "fold68"):
            x, pr, pc = cases[k]
            out[k] = jax.jit(lambda a, b, d: jsp.maybe_sharded_affine_fold(
                a, 1, b, d, 2, min_halo=6))(_jshard(m, x), pr, pc)
        for k, v in cases.items():
            if k.startswith("conv"):
                x, kern, bias, stride = v
                out[k] = jax.jit(
                    lambda a, kk=kern, bb=bias, ss=stride:
                    jsp.maybe_sharded_strided_conv_small(a, kk, bb, ss, 2)
                )(_jshard(m, x))
            if k.startswith("pw"):
                val, idx, ks = v
                out[k] = jax.jit(
                    lambda vv, ii, kk=ks, hw=val.shape[1:3]:
                    jsp.maybe_sharded_patch_warp(vv, ii, kk, kk, hw)
                )(_jshard(m, val), _jshard(m, idx))
    ref, lr = cases["argmax"]
    ctx = jsp.SpatialCtx(m, halo=4)
    out["argmax"] = jax.jit(lambda r, l: jsp.sharded_argmax_matmul(
        r, l, ctx, use_pallas=False))(ref, _jshard(m, lr))
    out["argmax_whole"] = tiled_argmax_matmul(ref, lr)
    return out


_JAX = {}


def _jax(cases, world):
    if world not in _JAX:
        _JAX[world] = _jax_ops(cases, world)
    return _JAX[world]


@pytest.mark.parametrize("key", ["warp", "warp_up", "warp_far", "fold64",
                                 "fold68", "conv96_4", "conv88_4",
                                 "conv64_8", "pw96_4", "pw88_4", "pw64_8"])
def test_shard_local_op_matches_jax(group, cases, key):
    world, res, _ = group
    want = np.asarray(_jax(cases, world)[key])
    got = res["ops"][key].numpy()
    tol = 1e-4 if key.startswith("conv") else 1e-5
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_sharded_argmax_matches_jax(group, cases):
    world, res, _ = group
    jc, ji = _jax(cases, world)["argmax"]
    wc, wi = _jax(cases, world)["argmax_whole"]
    c, i = res["ops"]["argmax"]
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))


def test_warp_past_the_halo_differs_like_jax(group, cases):
    """A flow past the halo: the sharded warps (JAX's and the port's)
    agree with each other and both differ from the whole-image warp."""
    world, res, _ = group
    x, flow = cases["warp_far"]
    whole = warp_sample_plain(torch.as_tensor(x), torch.as_tensor(flow))
    got = res["ops"]["warp_far"]
    assert float((got - whole).abs().max()) > 1e-2
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(_jax(cases, world)["warp_far"]),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [((1, 20, 16, 8), (1, 20, 16, 2)),
                                   ((1, 10, 8, 5), (1, 20, 16, 2))])
def test_banded_plain_with_a_trivial_band_is_the_plain_warp(shape):
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.standard_normal(shape[0]).astype(np.float32))
    flow = torch.as_tensor((rng.standard_normal(shape[1]) * 3).astype(
        np.float32))
    h, ho = shape[0][1], shape[1][1]
    got = warp_sample_banded_plain(x, flow, h, ho, 0, 0, -1, h - 1)
    assert torch.equal(got, warp_sample_plain(x, flow))


# ---------------------------------------------------------------------------
# the sharded net
# ---------------------------------------------------------------------------

_WHOLE = {}


def _whole(name):
    if name not in _WHOLE:
        net = _net(name)
        states = []

        def stream(lr, ref, st, *kf):
            out = net.forward_stream(torch.as_tensor(lr),
                                     torch.as_tensor(ref), st, *kf)
            states.append(out[1])
            return out
        _WHOLE[name] = _stream(
            lambda lr, ref, *kf: net.forward_first(torch.as_tensor(lr),
                                                   torch.as_tensor(ref),
                                                   *kf),
            stream, name)
        _WHOLE[name + "_state"] = states[-1]
    return _WHOLE[name]


@pytest.mark.parametrize("name", list(NETS))
def test_sharded_state_is_placed_by_the_leaf_rule(group, name):
    """The ranks' stream state, gathered along each leaf's axis
    (``serve.leaf_rows``: H at ndim-3, ``index_tail``'s flattened L), is
    the one-rank state: indices equal, tensors within 2e-5."""
    import dataclasses
    _, res, _ = group
    _whole(name)
    got, want = res["nets"][name + "_state"], _WHOLE[name + "_state"]
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if not torch.is_tensor(b):
            assert a == b, f.name
        elif b.dtype in (torch.int32, torch.int64):
            assert torch.equal(a, b), f.name
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5,
                                       err_msg=f.name)


@pytest.mark.parametrize("name", list(NETS))
def test_sharded_stream_matches_one_rank(group, name):
    _, res, _ = group
    got, want = res["nets"][name], _whole(name)
    assert len(got) == len(want) == 3
    for (o, conf), (ow, confw) in zip(got, want):
        assert o.shape == ow.shape
        inner = ((ow > 0) & (ow < 1)).float().mean()
        assert float(inner) > 0.1          # not a saturated frame
        np.testing.assert_allclose(o.numpy(), ow.numpy(), atol=2e-5)
        for c, cw in zip(conf, confw):
            np.testing.assert_allclose(c.numpy(), cw.numpy(), atol=2e-5)


# ---------------------------------------------------------------------------
# the eval CLI and the set-up check
# ---------------------------------------------------------------------------

_SEC = re.compile(r"\(\d+\.\d+sec\)")
_NUM = re.compile(r"(PSNR: |SSIM: )(-?\d+\.\d+)")


def test_spatial_eval_cli_matches_one_rank(group2, eval_tree, tmp_path):
    _, _, out = group2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        run.main(_eval_argv(eval_tree, tmp_path / "one"))
    (d1,) = glob.glob(str(tmp_path / "one" / "RealMCVSR" / "*"))
    (d2,) = glob.glob(str(out / "eval" / "RealMCVSR" / "*"))
    name = "score_RealMCVSR_quan_qual.txt"
    with open(os.path.join(d1, name)) as f:
        want = f.read().splitlines()
    with open(os.path.join(d2, name)) as f:
        got = f.read().splitlines()
    assert sorted(os.listdir(d2)) == sorted(os.listdir(d1))
    assert len(got) == len(want) and any("[TOTAL" in ln for ln in got)
    for lw, lg in zip(want, got):
        lw, lg = _SEC.sub("(sec)", lw), _SEC.sub("(sec)", lg)
        assert _NUM.sub(r"\1#", lw) == _NUM.sub(r"\1#", lg)
        np.testing.assert_allclose([float(v) for _, v in _NUM.findall(lg)],
                                   [float(v) for _, v in _NUM.findall(lw)],
                                   atol=1e-4)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_setup_accepts_the_8k_geometry(n):
    serve.check_geometry(1080, 1920, 1080, n, 32, 4, 8, True)
    tables = spatial.band_heights(n, spatial.heights_of(1080, 1080, 4))
    assert all(t[mesh.part(1080, n, r)[1] - mesh.part(1080, n, r)[0]]
               == 1080 for r, t in enumerate(tables))


@pytest.mark.parametrize("args,what", [
    ((1081, 1920, 1081, 2, 32, 4, 8, True), "not divisible"),
    ((1080, 1920, 1080, 8, 200, 4, 8, True), "< halo"),
    ((1080, 1914, 1080, 2, 32, 4, 8, True), "whole number of patches"),
    ((1076, 1920, 1076, 2, 32, 4, 8, True), "multiple of its patch grid")])
def test_setup_refuses_geometries_with_the_op_and_shapes(args, what):
    with pytest.raises((SystemExit, ValueError), match=what):
        serve.check_geometry(*args)


def test_ops_without_a_rule_raise_under_the_context():
    """Nothing falls back to a whole-image op silently: an op with no
    spatial rule raises when a band reaches it."""
    from refvsr_tpu_torch.ops.resize import avg_pool_2x2, resize
    spatial._CTX = spatial.SpatialCtx(2, 0, 4, {8: 16})
    try:
        x = torch.zeros(1, 8, 8, 3)
        with pytest.raises(ValueError, match="no spatial rule"):
            avg_pool_2x2(x)
        with pytest.raises(ValueError, match="integer-ratio"):
            resize(x, size=(4, 4))
        with spatial.replicated():
            assert avg_pool_2x2(x).shape == (1, 4, 4, 3)
    finally:
        spatial._CTX = None


def test_a_tensor_gathered_whole_is_refused_as_a_band(monkeypatch):
    """A tensor gather_rows returned whole is not taken for a band even
    when its row count is one: over 2 ranks the whole 8-row tensor has
    the rows of a band of the 16-row image."""
    from refvsr_tpu_torch.models.blocks import Conv2d
    monkeypatch.setattr(mesh, "all_gather_rows",
                        lambda x, dim, sizes: torch.cat([x] * len(sizes),
                                                        dim))
    spatial._CTX = spatial.SpatialCtx(2, 0, 4, {8: 16})
    try:
        full = spatial.gather_rows(torch.zeros(1, 4, 8, 3), 8)
        assert full.shape[1] == 8
        assert spatial._CTX.whole(torch.zeros(1, 8, 8, 3)) == 16
        conv = Conv2d(3, 3, 3)
        with pytest.raises(ValueError, match="gathered whole"):
            conv(full)
        with spatial.replicated():
            assert conv(full).shape == (1, 8, 8, 3)
    finally:
        spatial._CTX = None
