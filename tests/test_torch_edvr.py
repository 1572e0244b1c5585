"""The port's EDVR modules (``refvsr_tpu_torch/models/edvr.py``) against
the JAX package's, on the CPU in f32.

Inputs come from numpy seeds; the modules' parameters are the JAX
modules' seeded init with the offset convs redrawn (their zero init would
give integer taps only), carried across by ``params_from_jax``.

Tolerances:
- the modulated deformable convolution within 1e-5 of JAX: the same
  bilinear weights and one f32 contraction of 9*C products in another
  order; against its plain version (the gather plan) within 1e-5;
- PCDAlignment, TSAFusion and the EDVR trunk within 1e-4: tens of f32
  convolutions summed in another order, and offsets that move a tap's
  bilinear weights with them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refvsr_tpu.models import edvr as jedvr
from refvsr_tpu_torch.models import edvr
from refvsr_tpu_torch.ops.kernels.warp_sample import bilinear_sample
from refvsr_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)


def _offsets(rng, kind, shape):
    if kind == "zero":
        return np.zeros(shape, np.float32)
    if kind == "integer":
        return rng.integers(-3, 4, shape).astype(np.float32)
    off = (rng.standard_normal(shape) * 2.5).astype(np.float32)
    if kind == "far":
        # taps pushed wholly outside on both sides, and onto the edges
        off[:, :2, :, ::3] += 40.0
        off[:, -2:, :, 1::4] -= 40.0
        # anchors at exactly -1 and -2 in the first column
        off[:, :, :1, 2::5] = -1.0
        off[:, 2:4] = np.round(off[:, 2:4])
    return off


CASES = [(k, dg) for k in ("zero", "integer", "fractional", "far")
         for dg in (8, 4)]


def _dcn_inputs(seed, kind, dg, n=2, h=7, w=9, c=16, o=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    off = _offsets(rng, kind, (n, h, w, 2 * dg * 9))
    mask = rng.random((n, h, w, dg * 9)).astype(np.float32)
    wgt = (rng.standard_normal((3, 3, c, o)) * 0.2).astype(np.float32)
    bias = rng.standard_normal(o).astype(np.float32)
    return x, off, mask, wgt, bias


def _port_dcn(fn, x, off, mask, wgt, bias, dg):
    t = torch.from_numpy
    return fn(t(x), t(off), t(mask), t(wgt.transpose(3, 2, 0, 1).copy()),
              t(bias), dg).numpy()


@pytest.mark.parametrize("kind,dg", CASES)
def test_dcn_matches_jax(kind, dg):
    x, off, mask, wgt, bias = _dcn_inputs(11, kind, dg)
    want = np.asarray(jedvr.modulated_deform_conv(
        *(jnp.asarray(a) for a in (x, off, mask, wgt, bias)), dg))
    got = _port_dcn(edvr.modulated_deform_conv, x, off, mask, wgt, bias, dg)
    assert got.shape == want.shape == (2, 7, 9, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind,dg", CASES)
def test_dcn_matches_its_plain_version(kind, dg):
    """The row-gather plan (bilinear_sample, whole rows of cg channels)
    against the gather plan of the JAX formulation."""
    x, off, mask, wgt, bias = _dcn_inputs(12, kind, dg)
    got = _port_dcn(edvr.modulated_deform_conv, x, off, mask, wgt, bias, dg)
    want = _port_dcn(edvr.modulated_deform_conv_plain, x, off, mask, wgt,
                     bias, dg)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_bilinear_sample_zero_padding_is_the_dcn_rule(rng):
    """bilinear_sample(padding='zeros') reads zero at corners outside and
    gives exact zero for a point whose anchor lies outside [-1, S-1]: the
    mmcv rule (a sample is zero unless -1 < y < H and -1 < x < W)."""
    h, w = 5, 6
    x = torch.from_numpy(rng.standard_normal((1, h, w, 3)).astype(
        np.float32))
    ys = np.array([-1.5, -1.0, -0.5, 0.0, 2.25, 4.0, 4.5, 5.0, 5.5])
    xs = np.array([-2.0, -1.0, -0.25, 0.0, 3.5, 5.0, 5.75, 6.0, 7.0])
    sy, sx = np.meshgrid(ys, xs, indexing="ij")
    got = bilinear_sample(x, torch.from_numpy(sx[None].astype(np.float32)),
                          torch.from_numpy(sy[None].astype(np.float32)),
                          "zeros").numpy()[0]
    img = x.numpy()[0].astype(np.float64)
    for i, y in enumerate(ys):
        for j, xx in enumerate(xs):
            want = np.zeros(3)
            if -1 < y < h and -1 < xx < w:
                y0, x0 = int(np.floor(y)), int(np.floor(xx))
                for dy, wy in ((0, 1 - (y - y0)), (1, y - y0)):
                    for dx, wx in ((0, 1 - (xx - x0)), (1, xx - x0)):
                        if 0 <= y0 + dy < h and 0 <= x0 + dx < w:
                            want += wy * wx * img[y0 + dy, x0 + dx]
            np.testing.assert_allclose(got[i, j], want, atol=1e-6,
                                       err_msg=f"({y}, {xx})")


def _init(module, *args, seed=0, offset_scale=0.05):
    """The JAX module's seeded params, offset convs redrawn so that the
    offsets are fractional and reach a few pixels."""
    params = module.init(jax.random.PRNGKey(seed), *args)["params"]
    rng = np.random.default_rng(seed)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    out = {}
    for path, leaf in flat:
        names = tuple(p.key for p in path)
        v = np.array(leaf, np.float32)
        if "conv_offset" in names:
            v = (rng.standard_normal(v.shape) * offset_scale).astype(
                np.float32)
        node = out
        for k in names[:-1]:
            node = node.setdefault(k, {})
        node[names[-1]] = v
    return out


def _load(tmodule, params):
    tmodule.load_state_dict(params_from_jax(params), strict=True)
    return tmodule


def test_pcd_alignment_matches_jax(rng):
    mid, dg = 16, 8
    h, w = 12, 16

    def feats(n=2):
        return [rng.standard_normal((n, h // s, w // s, mid)).astype(
            np.float32) for s in (1, 2, 4)]
    nb, ref = feats(), feats()
    jm = jedvr.PCDAlignment(mid, dg)
    jx = ([jnp.asarray(a) for a in nb], [jnp.asarray(a) for a in ref])
    params = _init(jm, *jx)
    want = np.asarray(jm.apply({"params": params}, *jx))
    tm = _load(edvr.PCDAlignment(mid, dg), params)
    with torch.no_grad():
        got = tm([torch.from_numpy(a) for a in nb],
                 [torch.from_numpy(a) for a in ref]).numpy()
    assert got.shape == want.shape == (2, h, w, mid)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("hw", [(12, 16), (8, 20)])
def test_tsa_fusion_matches_jax(rng, hw):
    mid = 16
    x = rng.standard_normal((2, 5, *hw, mid)).astype(np.float32)
    jm = jedvr.TSAFusion(mid, 5, 2)
    params = _init(jm, jnp.asarray(x))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = _load(edvr.TSAFusion(mid, 5, 2), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, *hw, mid)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_edvr_extractor_matches_jax(rng):
    kw = dict(mid_channels=16, num_frames=5, deform_groups=4,
              num_blocks_extraction=2, center_frame_idx=2)
    x = rng.random((2, 5, 16, 12, 3)).astype(np.float32)
    jm = jedvr.EDVRFeatureExtractor(**kw)
    params = _init(jm, jnp.asarray(x), offset_scale=0.1)
    want = np.asarray(jax.jit(lambda p, a: jm.apply({"params": p}, a))(
        params, jnp.asarray(x)))
    tm = _load(edvr.EDVRFeatureExtractor(**kw), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 16, 12, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_dcn_pack_seeded_init_is_jax_init():
    """Zero offset conv and bias, weight uniform within 1/sqrt(fan_in): the
    pack starts as a 0.5-masked plain convolution, as in JAX."""
    from refvsr_tpu_torch.models.blocks import init_weights
    m = edvr.ModulatedDCNPack(16, 8, 8)
    init_weights(m, torch.Generator().manual_seed(0))
    assert not m.conv_offset.weight.abs().max() > 0
    assert not m.conv_offset.bias.abs().max() > 0
    assert not m.bias.abs().max() > 0
    bound = 1 / np.sqrt(16 * 9)
    assert 0.5 * bound < float(m.weight.detach().abs().max()) <= bound
