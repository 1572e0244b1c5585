"""The numerics and reduction plans of the K1-bwd and K2 kernels, checked on
the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); these tests pin, before the card does, the design
choices they rest on:

- the reduction plan. Each thread keeps a running (max, argmax) over its own
  columns (column c belongs to lane class (c % 8) // 2, as the wgmma and
  mma.sync accumulator layouts place it), visited in ascending order with a
  strict '>', and the four lane classes are merged preferring the lower
  column on equal values. Emulated here on the similarities, it must give
  what the Pallas kernel (``pallas_argmax_matmul(..., interpret=True)``, at
  the CUDA kernels' tile sizes: 128 x 128 for bf16, 64 x 64 for f32) and the
  plain version give, exact ties across tile and lane boundaries included
  (``refvsr_tpu_torch/bench/ties.py``);
- the f32 path's 3xTF32 products: each operand split as hi = tf32_rn(a),
  lo = tf32_rn(a - hi) (round to nearest, ties away from zero, on the low 13
  mantissa bits, as ``cvt.rna.tf32.f32`` does) and hi*hi + hi*lo + lo*hi
  summed in f32. Conf within 1e-6 of the f32 plain version (the dropped
  lo*lo is ~2^-22 relative) and equal indices;
- K1-bwd's reduction plan. A thread takes a run of 8 output pixels of a row
  and keeps a 2 x 2 window of source pixels in registers: a pixel with the
  window's anchor adds its four corners there, one with the anchor a column
  to the right first reduces the window's left column into dx and shifts
  it, any other first reduces the whole window and restarts it at its own
  anchor; the run ends with the window reduced. dflow is each pixel's
  lanes' channel sums added in the kernel's xor-shuffle tree. Emulated here
  in f32 at small shapes with dead points (far out-of-range flow, NaN) and a
  band of scattered flow that forces restarts, it must give the plain
  backward's and the JAX pullback's dx and dflow within 1e-5 of their
  largest magnitude, with fewer reductions than four per live pixel;
- K3's tile plan. Tiles of TH output rows (8 at C = 16 and 48) x 64
  pixels; each tile's halo buffer holds (TH + 2) rows x 66 pixels,
  channel-group-major (one TMA box per 16-channel group: [group][row]
  [pixel] x 32 bytes in the 32-byte swizzle, the 16-byte half of each
  32-byte row flipped where address bit 7 is set, each slab starting on
  1024 bytes), zero outside the image at negative and past-the-edge
  coordinates; wm is held
  as wgmma's K-major B operand (16-byte chunk c of output channel n at byte
  (c C + n) 16). Each output row is a chain of m64nCk16 products over
  K = 9C, tap-major in 16-channel steps, whose operands are read through
  the kernel's own descriptor arithmetic from those two byte images: A in
  the 32-byte swizzle (32-byte rows, 256 bytes between 8-row groups, the
  swizzle taken on the absolute address, so a tap's start may sit inside
  an atom), B unswizzled (8 x 16-byte core matrices, leading and stride
  byte offsets); the f32 sum is rounded to bf16, the bias added and the result
  rounded again, and only the pixels inside the image are stored (a ragged
  last tile in H and in W). At small ragged shapes it must agree with the
  plain version and with the Pallas kernel run in interpret mode within
  the card's envelope, 2^-7 |plain| + 2^-8 max|plain| (f32 sums in another
  order under two bf16 roundings), writing every output once.
"""

import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import refvsr_tpu.ops.pallas.warp_select as ws
from refvsr_tpu.ops.pallas.matching_kernel import pallas_argmax_matmul
from refvsr_tpu.ops.warp import warp_coords as jax_warp_coords
from refvsr_tpu_torch.bench.microbench_conv import (envelope_ratio,
                                                    make_inputs)
from refvsr_tpu_torch.bench.ties import tied_rows
from refvsr_tpu_torch.ops.kernels.conv3x3 import conv3x3_bias_plain
from refvsr_tpu_torch.ops.kernels.argmax_matmul import argmax_matmul_plain
from refvsr_tpu_torch.ops.kernels.warp_sample import (
    warp_coords, warp_sample_backward_plain)


def lane_plan_argmax(sim: torch.Tensor):
    """(max, argmax) over the last axis of sim (N, L_lr, L_ref) as the
    kernels reduce it: per lane class, the first column attaining the
    class's max (ascending scan, strict '>'); then the classes merged,
    higher value first, lower column on equal values."""
    cols = torch.arange(sim.shape[-1])
    best = torch.full(sim.shape[:-1], float("-inf"))
    arg = torch.zeros(sim.shape[:-1], dtype=torch.int64)
    for q in range(4):
        mine = torch.where((cols % 8) // 2 == q, sim, float("-inf"))
        v, i = mine.max(dim=-1)     # first occurrence of the class max
        take = (v > best) | ((v == best) & (i < arg) & (v > float("-inf")))
        best = torch.where(take, v, best)
        arg = torch.where(take, i, arg)
    return best, arg.to(torch.int32)


def _sim(ref, lr):
    return torch.einsum("nld,nrd->nlr", torch.from_numpy(lr),
                        torch.from_numpy(ref))


@pytest.mark.parametrize("tile_lr,tile_ref", [(128, 128), (64, 64)])
def test_pallas_at_kernel_tiles_matches_plain(rng, tile_lr, tile_ref):
    n, l_ref, l_lr, d = 2, 400, 300, 144
    ref, lr, first = tied_rows(rng, n, l_ref, l_lr, d)
    conf_j, idx_j = pallas_argmax_matmul(jnp.asarray(ref), jnp.asarray(lr),
                                         tile_lr, tile_ref, True)
    conf, idx = argmax_matmul_plain(torch.from_numpy(ref),
                                    torch.from_numpy(lr), tile=tile_ref)
    np.testing.assert_allclose(conf.numpy(), np.asarray(conf_j), atol=1e-5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(idx.numpy()[:, :first.size],
                                  np.broadcast_to(first, (n, first.size)))


@pytest.mark.parametrize("n,l_ref,l_lr,d", [(2, 400, 300, 144),
                                            (1, 1000, 129, 16)])
def test_lane_plan_matches_plain(rng, n, l_ref, l_lr, d):
    ref, lr, first = tied_rows(rng, n, l_ref, l_lr, d)
    conf_k, idx_k = lane_plan_argmax(_sim(ref, lr))
    conf, idx = argmax_matmul_plain(torch.from_numpy(ref),
                                    torch.from_numpy(lr))
    torch.testing.assert_close(conf_k, conf, rtol=0, atol=1e-6)
    assert torch.equal(idx_k, idx)
    assert torch.equal(idx_k[:, :first.size],
                       torch.from_numpy(first).expand(n, first.size))


def test_lane_plan_prefers_lower_column_across_lanes():
    # one row, equal maxima at columns 9 (lane class 0) and 2 (class 1),
    # 17 (class 0) and 30 (class 3): the lowest, 2, must win
    sim = torch.full((1, 1, 32), -1.0)
    sim[0, 0, [2, 9, 17, 30]] = 0.5
    conf, idx = lane_plan_argmax(sim)
    assert float(conf) == 0.5 and int(idx) == 2


def tf32_rna(a: np.ndarray) -> np.ndarray:
    """f32 -> TF32 (10 explicit mantissa bits) by round to nearest, ties
    away from zero, as cvt.rna.tf32.f32: add half of the dropped 13 bits'
    weight to the magnitude, then clear them (a carry into the exponent is
    the correct rounding up to the next binade)."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split_tf32(a: np.ndarray):
    hi = tf32_rna(a)
    return hi, tf32_rna(a - hi)


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)            # TF32's spacing in [1, 2)
    cases = np.array([one + ulp / 4, one + ulp / 2, one + 3 * ulp / 4,
                      -(one + ulp / 2), np.float32(3.0)], np.float32)
    want = np.array([one, one + ulp, one + ulp, -(one + ulp), 3.0],
                    np.float32)
    np.testing.assert_array_equal(tf32_rna(cases), want)
    hi, lo = split_tf32(cases)
    assert np.all(tf32_rna(hi) == hi) and np.all(tf32_rna(lo) == lo)
    np.testing.assert_array_equal(hi + lo, cases)


@pytest.mark.parametrize("n,l_ref,l_lr,d", [(2, 300, 517, 144),
                                            (1, 77, 130, 144),
                                            (2, 1024, 1024, 144)])
def test_3xtf32_products_keep_f32_parity(rng, n, l_ref, l_lr, d):
    """The shapes of the card's f32 kernel test and a batch-2 cut of the
    training shape (14 x 1024 x 1024 x 144)."""
    ref, lr, _ = tied_rows(rng, n, l_ref, l_lr, d)
    rh, rl = (torch.from_numpy(a) for a in split_tf32(ref))
    lh, ll = (torch.from_numpy(a) for a in split_tf32(lr))
    big = torch.einsum("nld,nrd->nlr", lh, rh)
    small = (torch.einsum("nld,nrd->nlr", lh, rl)
             + torch.einsum("nld,nrd->nlr", ll, rh))
    conf_e, idx_e = lane_plan_argmax(big + small)
    conf, idx = argmax_matmul_plain(torch.from_numpy(ref),
                                    torch.from_numpy(lr))
    torch.testing.assert_close(conf_e, conf, rtol=0, atol=1e-6)
    assert torch.equal(idx_e, idx)
    # the split alone (hi only, as plain TF32 would) is not enough
    conf_hi, _ = lane_plan_argmax(big)
    assert float((conf_hi - conf).abs().max()) > 1e-5


# output pixels per thread in K1's backward kernel (RUN in
# refvsr_tpu_torch/csrc/warp_sample.cu)
K1_BWD_RUN = 8


def run_plan_backward(g, flow, x_shape, x):
    """dx and dflow of K1-bwd as its kernel plans them (f32), and counts of
    the window's moves and of the reductions into dx. See the module
    note."""
    n, h, w, c = x_shape
    ho, wo = flow.shape[1], flow.shape[2]
    sx, sy = (t.numpy() for t in warp_coords((h, w), flow))
    x0, y0 = np.floor(sx), np.floor(sy)
    with np.errstate(invalid="ignore"):
        live = (x0 >= -1) & (x0 <= w - 1) & (y0 >= -1) & (y0 <= h - 1)
    tx = np.where(live, sx - x0, 0).astype(np.float32)
    ty = np.where(live, sy - y0, 0).astype(np.float32)
    xi = np.where(live, x0, 0).astype(np.int64)
    yi = np.where(live, y0, 0).astype(np.int64)
    wts = np.stack([(1 - ty) * (1 - tx), (1 - ty) * tx, ty * (1 - tx),
                    ty * tx], -1).astype(np.float32)
    g = g.float().numpy()
    dx = np.zeros((n, h, w, c), np.float32)
    stats = dict(same=0, shift=0, restart=0, reductions=0, corners=0)
    for b in range(n):
        for oy in range(ho):
            for ox0 in range(0, wo, K1_BWD_RUN):
                acc = np.zeros((4, c), np.float32)
                used = [False] * 4
                xa = ya = None

                def flush(slots):
                    for sl in slots:
                        if used[sl]:
                            dx[b, ya + (sl >> 1), xa + (sl & 1)] += acc[sl]
                            stats["reductions"] += 1
                        acc[sl] = 0
                        used[sl] = False

                for ox in range(ox0, min(ox0 + K1_BWD_RUN, wo)):
                    if not live[b, oy, ox]:
                        continue
                    ax, ay = xi[b, oy, ox], yi[b, oy, ox]
                    if any(used) and ay == ya and ax == xa + 1:
                        flush((0, 2))
                        acc[[0, 2]], acc[[1, 3]] = acc[[1, 3]], 0
                        used = [used[1], False, used[3], False]
                        xa = ax
                        stats["shift"] += 1
                    elif not any(used) or ay != ya or ax != xa:
                        flush(range(4))
                        xa, ya = ax, ay
                        stats["restart"] += 1
                    else:
                        stats["same"] += 1
                    for k in range(4):
                        cy, cx = ay + (k >> 1), ax + (k & 1)
                        acc[k] += wts[b, oy, ox, k] * g[b, oy, ox]
                        if 0 <= cy < h and 0 <= cx < w:
                            used[k] = True
                            stats["corners"] += 1
                if xa is not None:
                    flush(range(4))
    # dflow: lane j of a pixel's lanes sums the channel groups j, j + lanes,
    # ... (4 f32 channels each), then the lanes meet in an xor tree
    xf = x.float().numpy()
    bidx = np.arange(n)[:, None, None]
    v = []
    for k in range(4):
        cy, cx = yi + (k >> 1), xi + (k & 1)
        inside = live & (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
        v.append(np.where(inside[..., None],
                          xf[bidx, cy.clip(0, h - 1), cx.clip(0, w - 1)], 0))
    terms = (g * ((1 - ty)[..., None] * (v[1] - v[0])
                  + ty[..., None] * (v[3] - v[2])),
             g * ((1 - tx)[..., None] * (v[2] - v[0])
                  + tx[..., None] * (v[3] - v[1])))
    groups = -(-c // 4)
    lanes = 1
    while lanes < min(groups, 32):
        lanes *= 2
    sums = []
    for t in terms:
        part = [np.zeros((n, ho, wo), np.float32) for _ in range(lanes)]
        for grp in range(groups):
            for ch in range(4 * grp, min(4 * grp + 4, c)):
                part[grp % lanes] = part[grp % lanes] + t[..., ch]
        step = lanes // 2
        while step:
            part = [part[j] + part[j ^ step] for j in range(lanes)]
            step //= 2
        sums.append(part[0])
    dflow = np.stack([sums[0] * 0.5 * w * (2.0 / max(w - 1, 1)),
                      sums[1] * 0.5 * h * (2.0 / max(h - 1, 1))], -1)
    dflow = np.where(live[..., None], dflow, 0).astype(np.float32)
    return torch.from_numpy(dx), torch.from_numpy(dflow), stats


def _scattered_flow(rng, n, ho, wo):
    """A smooth flow with dead points (a far out-of-range block, NaNs) and
    a band of large random flow that throws corners far from their
    neighbours'."""
    gy, gx = np.meshgrid(np.arange(ho, dtype=np.float32),
                         np.arange(wo, dtype=np.float32), indexing="ij")
    fx = 2.5 + 1.5 * np.cos(gx / 9.0) + rng.normal(0, .05, (n, ho, wo))
    fy = -1.7 + 1.0 * np.sin(gy / 7.0) + rng.normal(0, .05, (n, ho, wo))
    flow = np.stack([fx, fy], -1).astype(np.float32)
    flow[:, ho // 2:ho // 2 + 6] += rng.uniform(-25, 25, (n, 6, wo, 2))
    flow[:, :4, :9] += 5000.0
    flow[rng.random((n, ho, wo)) < 0.02, 0] = np.nan
    return flow


@pytest.mark.parametrize("n,h,w,c,ho,wo,saving", [
    (2, 40, 52, 5, 80, 104, 2.2), (1, 37, 45, 49, 37, 45, 1.5),
    (2, 33, 47, 48, 35, 50, 1.5)])
def test_k1_backward_run_plan_matches_plain_and_jax(rng, n, h, w, c, ho, wo,
                                                    saving):
    """The low-res-to-2x grid, the packed feature warp's 49 channels at one
    resolution, and an odd grid, at small sizes: at least `saving` times
    fewer reductions than corners."""
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    flow = _scattered_flow(rng, n, ho, wo)
    g = rng.standard_normal((n, ho, wo, c)).astype(np.float32)
    xt, ft, gt = (torch.from_numpy(a) for a in (x, flow, g))
    dx, dflow, stats = run_plan_backward(gt, ft, x.shape, xt)
    # every move of the window is taken, and the window saves reductions
    assert stats["same"] and stats["shift"] and stats["restart"]
    assert stats["corners"] >= saving * stats["reductions"]
    dx_p, dflow_p = warp_sample_backward_plain(gt, ft, x.shape, xt)
    for got, want in ((dx, dx_p), (dflow, dflow_p)):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
    # the JAX pullback of the lean sampler (the Pallas kernel's custom VJP)
    sx_j, sy_j = jax_warp_coords((h, w), jnp.asarray(flow))
    _, vjp = jax.vjp(lambda xx, yy, xx2: ws._lean_reference(
        xx, yy, xx2, "zeros"), jnp.asarray(x), sy_j, sx_j)
    dx_j, dsy_j, dsx_j = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    ok = np.isfinite(dx_j)      # NaN points leak NaN into the JAX dx
    assert ok.mean() > 0.5
    np.testing.assert_allclose(dx.numpy()[ok], dx_j[ok], rtol=0,
                               atol=1e-5 * np.abs(dx_j[ok]).max())
    # dflow = d/dsx * dsx/dfx: the chain through warp_coords' scales
    live = np.isfinite(dsx_j) & np.isfinite(dsy_j)
    want = np.stack([dsx_j * 0.5 * w * (2.0 / (w - 1)),
                     dsy_j * 0.5 * h * (2.0 / (h - 1))], -1)
    np.testing.assert_allclose(dflow.numpy()[live], want[live], rtol=0,
                               atol=1e-5 * np.abs(want[live]).max())


# ------------------------------------------------------------- K3 plan

K3_TW, K3_PW = 64, 66           # output pixels a tile row; halo pixels
K3_TH = {16: 8, 32: 8, 48: 8, 64: 4, 80: 2}


def k3_slab(rows):
    """Bytes of one 16-channel group's slab of a halo buffer: rows x 66
    pixels x 32 bytes, padded to 1024 (a swizzled TMA destination's
    alignment)."""
    return -(-rows * K3_PW * 32 // 1024) * 1024


def swizzle32(byte):
    """The 32-byte swizzle of a shared-memory byte address: the 16-byte
    chunk bit (4) flipped by address bit 7."""
    return byte ^ (((byte >> 7) & 1) << 4)


def k3_halo_image(x, y0, x0, rows):
    """A tile's halo buffer as the kernel's TMA boxes fill it: bf16 values
    of x (H, W, C), one ``k3_slab(rows)``-byte slab per 16-channel group of
    [row][pixel][channel] in the 32-byte swizzle, flattened; image rows
    y0 .. y0 + rows - 1 and columns x0 .. x0 + 65, zero outside the
    image."""
    h, w, c = x.shape
    gy = np.arange(rows) + y0
    gx = np.arange(K3_PW) + x0
    inside = ((gy[:, None] >= 0) & (gy[:, None] < h) & (gx >= 0) &
              (gx < w))
    vals = x[np.clip(gy, 0, h - 1)][:, np.clip(gx, 0, w - 1)]
    vals = np.where(inside[..., None], vals, 0.0)
    slabs = vals.reshape(rows, K3_PW, c // 16, 16).transpose(2, 0, 1, 3)
    byte = (np.arange(c // 16)[:, None, None, None] * k3_slab(rows) +
            (np.arange(rows)[:, None, None] * K3_PW +
             np.arange(K3_PW)[:, None]) * 32 + np.arange(16) * 2)
    image = np.zeros(c // 16 * k3_slab(rows) // 2, np.float32)
    image[swizzle32(byte) // 2] = slabs
    return image


def k3_halo_at(image, rows, k, row, px):
    """The 16 channels of halo pixel (row, px) in group k, read back."""
    byte = k * k3_slab(rows) + (row * K3_PW + px) * 32 + np.arange(16) * 2
    return image[swizzle32(byte) // 2]


def k3_weight_image(wm):
    """wm (9C, C) as the kernel stages it: 16-byte chunk c (8 consecutive
    K rows) of output channel n at byte (c C + n) 16, flattened."""
    k, c = wm.shape
    return wm.reshape(k // 8, 8, c).transpose(0, 2, 1).ravel()


def desc_view_sw32(image, start, rows):
    """The (rows, 16) K-major operand a 32-byte-swizzled wgmma descriptor
    reads from a bf16 byte image: 32-byte rows of 16 values, 256 bytes
    between 8-row groups, the swizzle on the absolute address."""
    m = np.arange(rows)[:, None]
    kk = np.arange(16)[None, :]
    byte = start + (m // 8) * 256 + (m % 8) * 32 + kk * 2
    return image[swizzle32(byte) // 2]


def desc_view(image, start, lbo, sbo, rows, k=16):
    """The (rows, k) operand a K-major, unswizzled wgmma descriptor reads
    from a bf16 byte image: 8 x 16-byte core matrices, `lbo` bytes apart
    along K and `sbo` bytes apart along M/N, from byte `start`."""
    m = np.arange(rows)[:, None]
    kk = np.arange(k)[None, :]
    byte = (start + (m // 8) * sbo + (kk // 8) * lbo + (m % 8) * 16 +
            (kk % 8) * 2)
    return image[byte // 2]


def run_plan_conv(x, wm, bias):
    """K3's tile plan on bf16-valued f32 arrays: x (H, W, C), wm (9C, C),
    bias (C,). Returns y (H, W, C) as bf16 values in f32, NaN where no tile
    stored."""
    h, w, c = x.shape
    g, th = c // 8, K3_TH[c]
    wimg = k3_weight_image(wm)
    bias_t = torch.from_numpy(bias).to(torch.bfloat16).float()
    y = np.full((h, w, c), np.nan, np.float32)
    for ty in range(-(-h // th)):
        for tx in range(-(-w // K3_TW)):
            halo = k3_halo_image(x, ty * th - 1, tx * K3_TW - 1, th + 2)
            slab = k3_slab(th + 2)
            for r in range(th):
                acc = np.zeros((K3_TW, c), np.float32)
                for t in range(9):
                    for s in range(c // 16):
                        a_start = s * slab + ((r + t // 3) * K3_PW +
                                              t % 3) * 32
                        b_off = (t * g + 2 * s) * c
                        a = desc_view_sw32(halo, a_start, K3_TW)
                        b = desc_view(wimg, b_off * 16, c * 16, 128, c)
                        acc += a @ b.T
                out = (torch.from_numpy(acc).to(torch.bfloat16).float() +
                       bias_t).to(torch.bfloat16).float().numpy()
                gy, x0 = ty * th + r, tx * K3_TW
                if gy < h:
                    px = min(K3_TW, w - x0)
                    assert np.isnan(y[gy, x0:x0 + px]).all()
                    y[gy, x0:x0 + px] = out[:px]
    return y


def test_k3_halo_zero_fills_outside_the_image():
    x = np.arange(1, 1 + 2 * 70 * 32, dtype=np.float32).reshape(2, 70, 32)

    def pixels(image, rows):
        return np.stack([[[k3_halo_at(image, rows, k, r, p)
                           for p in range(K3_PW)] for r in range(rows)]
                         for k in range(2)])
    # the first tile: rows -1 .. 2, columns -1 .. 64
    halo = pixels(k3_halo_image(x, -1, -1, 4), 4)
    assert not halo[:, 0].any() and not halo[:, 3].any()  # rows -1 and 2
    assert not halo[:, :, 0].any()                        # column -1
    assert (halo[:, 1:3, 1:] > 0).all()
    # the last tile of the ragged rows: columns 63 .. 69 inside, 70 .. 128
    # zero
    halo = pixels(k3_halo_image(x, 0, 63, 2), 2)
    assert (halo[:, :, :7] > 0).all() and not halo[:, :, 7:].any()
    # group k of a pixel holds its channels 16k .. 16k + 15
    np.testing.assert_array_equal(halo[1, 1, 2], x[1, 65, 16:32])
    # each slab starts on 1024 bytes; the swizzle moves data: the same
    # image read without it differs
    assert k3_slab(10) == 21504 and k3_slab(4) == 9216
    image = k3_halo_image(x, 0, 0, 2)
    idx = np.arange(2 * K3_PW * 16)
    assert not np.array_equal(image[idx], image[swizzle32(idx * 2) // 2])


def _conv_script():
    """scripts/microbench_pallas_conv.py as a module, with JAX's cache
    settings and sys.path as they were before its import."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    before = {k: getattr(jax.config, k) for k in keys}
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            "microbench_pallas_conv", Path(__file__).resolve().parents[1] /
            "scripts" / "microbench_pallas_conv.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in before.items():
            jax.config.update(k, v)
        sys.path[:] = path
    return mod


@pytest.mark.parametrize("h,w,c", [(15, 70, 16), (15, 70, 48),
                                   (20, 131, 48)])
def test_k3_tile_plan_matches_plain_and_pallas(monkeypatch, h, w, c):
    """Ragged in H (TH = 8) and W (64-pixel tiles); the Pallas kernel runs
    with 5-row stripes (H a multiple of them) in interpret mode."""
    x, wm, bias = make_inputs(h, w, c)
    got = run_plan_conv(x.float().numpy(), wm.float().numpy(),
                        bias.float().numpy().ravel())
    assert not np.isnan(got).any()            # every output stored once
    got = torch.from_numpy(got)
    want = conv3x3_bias_plain(x, wm, bias)
    assert envelope_ratio(got, want) <= 1.0
    script = _conv_script()
    for name, value in (("H", h), ("W", w), ("C", c), ("R", 5),
                        ("WP", -(-(w + 2) // 8) * 8)):
        monkeypatch.setattr(script, name, value)
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=pltpu.InterpretParams()))
    pallas = script.pallas_conv(*(jnp.asarray(t.float().numpy(),
                                              jnp.bfloat16)
                                  for t in (x, wm, bias)), concat_k=True)
    pallas = torch.from_numpy(np.asarray(pallas, np.float32))
    assert envelope_ratio(got, pallas) <= 1.0
