"""The two kernels' plain versions against the JAX package, on the CPU.

K1 (``warp_sample``) against ``_bilinear_sample_lean`` and against the
Pallas kernel ``pallas_banded_sample`` run in interpret mode; K2
(``argmax_matmul``) against ``tiled_argmax_matmul`` and against
``pallas_argmax_matmul(..., interpret=True)``. Each wrapper, given CPU
tensors, takes its plain path and launches nothing. The CUDA kernels
themselves are held against these plain versions on the card by
chip_smoke.py and tests/test_torch_cuda.py.

Tolerances: K1 atol 2e-5 in f32 (the same f32 weights; the four products
are summed in another order); K2 conf atol 1e-5 (f32 dot products of
length 36 in another order), indices equal.

The backward passes: K1's plain backward (autograd through the plain
version, as ``_WarpSample`` runs it on the CPU) against ``jax.vjp`` of
``refvsr_tpu.ops.warp.warp``, dx and dflow within 1e-5 of their largest
magnitude (f32 sums in another order). Where a NaN coordinate makes the
JAX pullback leak NaN into dx (0 * NaN weight), the port gives finite
values and exact zeros at every dead point. K2's plain backward against
``jax.vjp`` of ``pallas_argmax_matmul(..., interpret=True)`` within 1e-6,
duplicated ref rows included (the gradient goes to the first occurrence
only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refvsr_tpu.ops.pallas.warp_select as ws
from refvsr_tpu.models.matching import tiled_argmax_matmul
from refvsr_tpu.ops.pallas.matching_kernel import pallas_argmax_matmul
from refvsr_tpu.ops.warp import _bilinear_sample_lean
from refvsr_tpu.ops.warp import warp as jax_warp
from refvsr_tpu.ops.warp import warp_coords as jax_warp_coords
from refvsr_tpu_torch.ops.kernels.argmax_matmul import (
    argmax_matmul, argmax_matmul_backward, argmax_matmul_backward_plain,
    argmax_matmul_plain)
from refvsr_tpu_torch.ops.kernels.warp_sample import (
    bilinear_sample, warp_coords, warp_sample, warp_sample_backward,
    warp_sample_backward_plain, warp_sample_plain)

torch.set_num_threads(2)


def _flow(rng, n, ho, wo, shift=(3.7, -2.3), dead=True):
    """Smooth flow (N, Ho, Wo, 2) inside the Pallas kernel's select budget,
    shifted so border samples leave the image; with `dead`, a far
    out-of-range block and scattered NaNs."""
    gy, gx = np.meshgrid(np.arange(ho, dtype=np.float32),
                         np.arange(wo, dtype=np.float32), indexing="ij")
    fy = shift[0] + 0.7 * np.sin(gy / 40.0) + rng.normal(0, .02, (n, ho, wo))
    fx = shift[1] + 1.2 * np.cos(gx / 80.0) + rng.normal(0, .02, (n, ho, wo))
    flow = np.stack([fx, fy], -1).astype(np.float32)
    if dead:
        flow[:, :4, :9] += 5000.0
        flow[:, -3:, -5:, 1] -= 5000.0
        flow[rng.random((n, ho, wo)) < 0.02, 0] = np.nan
    return flow


def _dead_mask(sx, sy, h, w):
    x0, y0 = np.floor(sx), np.floor(sy)
    with np.errstate(invalid="ignore"):
        live = (x0 >= -1) & (x0 <= w - 1) & (y0 >= -1) & (y0 <= h - 1)
    return ~live


@pytest.mark.parametrize("n,h,w,c,ho,wo", [(1, 40, 140, 5, 37, 130),
                                           (2, 33, 131, 49, 66, 262)])
def test_warp_plain_matches_lean_sampler(rng, n, h, w, c, ho, wo):
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    flow = _flow(rng, n, ho, wo)
    sx_j, sy_j = jax_warp_coords((h, w), jnp.asarray(flow))
    want = np.asarray(_bilinear_sample_lean(jnp.asarray(x), sx_j, sy_j,
                                            "zeros"))
    got = warp_sample_plain(torch.from_numpy(x), torch.from_numpy(flow))
    sx, sy = warp_coords((h, w), torch.from_numpy(flow))
    np.testing.assert_allclose(sx.numpy(), np.asarray(sx_j), atol=1e-5)
    np.testing.assert_allclose(sy.numpy(), np.asarray(sy_j), atol=1e-5)
    got = got.numpy()
    assert got.shape == (n, ho, wo, c)
    dead = _dead_mask(sx.numpy(), sy.numpy(), h, w)
    assert dead.any() and np.isnan(flow).any()
    assert np.all(got[dead] == 0) and np.all(want[dead] == 0)
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("n,h,w,c,ho,wo", [(1, 40, 140, 5, 37, 130),
                                           (2, 33, 131, 3, 33, 131)])
def test_sampler_matches_pallas_interpret(rng, monkeypatch, n, h, w, c, ho,
                                          wo):
    """The plain sampler against the Pallas kernel at source coordinates
    inside the kernel's select budget (identity grid + a smooth flow, as
    tests/test_pallas_warp_select.py builds them), with dead points."""
    monkeypatch.setattr(ws, "_FORCE_INTERPRET", True)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    flow = _flow(rng, n, ho, wo)
    gy, gx = np.meshgrid(np.arange(ho, dtype=np.float32),
                         np.arange(wo, dtype=np.float32), indexing="ij")
    sx, sy = gx + flow[..., 0], gy + flow[..., 1]
    assert bool(ws.pallas_banded_ok(x.shape, jnp.asarray(sy),
                                    jnp.asarray(sx)))
    want = np.asarray(ws.pallas_banded_sample(jnp.asarray(x),
                                              jnp.asarray(sy),
                                              jnp.asarray(sx)))
    got = bilinear_sample(torch.from_numpy(x), torch.from_numpy(sx),
                          torch.from_numpy(sy), "zeros").numpy()
    dead = _dead_mask(sx, sy, h, w)
    assert dead.any() and np.isnan(sx).any()
    assert np.all(got[dead] == 0) and np.all(want[dead] == 0)
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_bilinear_sample_matches_lean_at_given_coords(rng, padding):
    x = rng.standard_normal((2, 12, 17, 4)).astype(np.float32)
    sx = rng.uniform(-3, 20, (2, 9, 11)).astype(np.float32)
    sy = rng.uniform(-3, 15, (2, 9, 11)).astype(np.float32)
    want = np.asarray(_bilinear_sample_lean(jnp.asarray(x), jnp.asarray(sx),
                                            jnp.asarray(sy), padding))
    got = bilinear_sample(torch.from_numpy(x), torch.from_numpy(sx),
                          torch.from_numpy(sy), padding).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def _patch_rows(rng, n, l_ref, l_lr, d, dup):
    """L2-normalised rows; the last `dup` ref rows repeat the first ones and
    the first `dup` LR rows equal them, so exact ties are hit."""
    ref = rng.standard_normal((n, l_ref, d)).astype(np.float32)
    ref[:, -dup:] = ref[:, :dup]
    lr = rng.standard_normal((n, l_lr, d)).astype(np.float32)
    lr[:, :dup] = ref[:, :dup]
    ref /= np.linalg.norm(ref, axis=2, keepdims=True)
    lr /= np.linalg.norm(lr, axis=2, keepdims=True)
    return ref, lr


@pytest.mark.parametrize("n,l_ref,l_lr,d,tile", [(2, 300, 517, 36, 128),
                                                 (1, 77, 130, 144, 32)])
def test_argmax_plain_matches_pallas_interpret(rng, n, l_ref, l_lr, d, tile):
    dup = 20
    ref, lr = _patch_rows(rng, n, l_ref, l_lr, d, dup)
    conf_j, idx_j = pallas_argmax_matmul(jnp.asarray(ref), jnp.asarray(lr),
                                         tile, tile, True)
    conf, idx = argmax_matmul_plain(torch.from_numpy(ref),
                                    torch.from_numpy(lr), tile=tile)
    assert conf.dtype == torch.float32 and idx.dtype == torch.int32
    np.testing.assert_allclose(conf.numpy(), np.asarray(conf_j), atol=1e-5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    # the tied rows resolve to the first occurrence
    np.testing.assert_array_equal(idx.numpy()[:, :dup],
                                  np.broadcast_to(np.arange(dup), (n, dup)))


def test_argmax_plain_matches_tiled_scan(rng):
    ref, lr = _patch_rows(rng, 2, 260, 190, 16, 10)
    conf_j, idx_j = tiled_argmax_matmul(jnp.asarray(ref), jnp.asarray(lr),
                                        tile=64)
    conf, idx = argmax_matmul_plain(torch.from_numpy(ref),
                                    torch.from_numpy(lr), tile=64)
    np.testing.assert_allclose(conf.numpy(), np.asarray(conf_j), atol=1e-5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))


def test_wrappers_take_plain_path_on_cpu(rng):
    warp_sample.launches = 0
    argmax_matmul.launches = 0
    x = torch.from_numpy(rng.standard_normal((1, 8, 9, 3)).astype(np.float32))
    flow = torch.from_numpy(_flow(rng, 1, 8, 9, dead=False))
    torch.testing.assert_close(warp_sample(x, flow),
                               warp_sample_plain(x, flow), rtol=0, atol=0)
    ref, lr = (torch.from_numpy(a) for a in _patch_rows(rng, 1, 40, 30, 16,
                                                        4))
    got = argmax_matmul(ref, lr)
    want = argmax_matmul_plain(ref, lr)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert warp_sample.launches == 0 and argmax_matmul.launches == 0


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        warp_sample(torch.zeros(1, 4, 4, 3), torch.zeros(1, 4, 4, 3))
    with pytest.raises(ValueError):
        argmax_matmul(torch.zeros(1, 4, 8), torch.zeros(1, 5, 9))


@pytest.mark.parametrize("n,h,w,c,ho,wo", [(1, 21, 30, 5, 21, 30),
                                           (2, 17, 23, 9, 34, 46)])
def test_warp_plain_backward_matches_jax_vjp(rng, n, h, w, c, ho, wo):
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    flow = _flow(rng, n, ho, wo)
    g = rng.standard_normal((n, ho, wo, c)).astype(np.float32)
    _, vjp = jax.vjp(jax_warp, jnp.asarray(x), jnp.asarray(flow))
    dx_j, dflow_j = (np.asarray(a) for a in vjp(jnp.asarray(g)))

    xt = torch.from_numpy(x).requires_grad_(True)
    ft = torch.from_numpy(flow).requires_grad_(True)
    warp_sample.launches = 0
    warp_sample(xt, ft).backward(torch.from_numpy(g))
    assert warp_sample.launches == 0 and warp_sample_backward.launches == 0
    dx, dflow = xt.grad.numpy(), ft.grad.numpy()
    assert np.isfinite(dx).all() and np.isfinite(dflow).all()
    sx, sy = warp_coords((h, w), torch.from_numpy(flow))
    dead = _dead_mask(sx.numpy(), sy.numpy(), h, w)
    assert dead.any() and np.isnan(flow).any()
    assert np.all(dflow[dead] == 0)
    ok = np.isfinite(dx_j)
    assert ok.mean() > 0.5
    np.testing.assert_allclose(dx[ok], dx_j[ok], rtol=0,
                               atol=1e-5 * np.abs(dx_j[ok]).max())
    live = ~dead
    np.testing.assert_allclose(dflow[live], dflow_j[live], rtol=0,
                               atol=1e-5 * np.abs(dflow_j[live]).max())
    # the Function's CPU backward is the plain backward, dx-only included
    dx_only, none = warp_sample_backward_plain(
        torch.from_numpy(g), torch.from_numpy(flow), x.shape)
    assert none is None
    np.testing.assert_array_equal(dx_only.numpy(), dx)


@pytest.mark.parametrize("n,l_ref,l_lr,d", [(2, 300, 517, 36),
                                            (1, 77, 130, 144)])
def test_argmax_plain_backward_matches_pallas_vjp(rng, n, l_ref, l_lr, d):
    dup = 20
    ref, lr = _patch_rows(rng, n, l_ref, l_lr, d, dup)
    g = rng.standard_normal((n, l_lr)).astype(np.float32)
    (conf_j, idx_j), vjp = jax.vjp(
        lambda r, l: pallas_argmax_matmul(r, l, 128, 128, True),
        jnp.asarray(ref), jnp.asarray(lr))
    d_ref_j, d_lr_j = (np.asarray(a) for a in vjp(
        (jnp.asarray(g), np.zeros(idx_j.shape, jax.dtypes.float0))))

    ref_t = torch.from_numpy(ref).requires_grad_(True)
    lr_t = torch.from_numpy(lr).requires_grad_(True)
    argmax_matmul.launches = 0
    conf, idx = argmax_matmul(ref_t, lr_t)
    assert not idx.requires_grad
    conf.backward(torch.from_numpy(g))
    assert argmax_matmul.launches == 0
    assert argmax_matmul_backward.launches == 0
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(lr_t.grad.numpy(), d_lr_j, atol=1e-6)
    np.testing.assert_allclose(ref_t.grad.numpy(), d_ref_j, atol=1e-6)
    # the duplicated rows (the last `dup`) never win, so get no gradient
    assert np.all(ref_t.grad.numpy()[:, -dup:] == 0)
    d_ref, d_lr = argmax_matmul_backward_plain(
        ref_t.detach(), lr_t.detach(), idx, torch.from_numpy(g))
    np.testing.assert_array_equal(d_ref.numpy(), ref_t.grad.numpy())
    np.testing.assert_array_equal(d_lr.numpy(), lr_t.grad.numpy())
