"""The numerics and reduction plan of the K2 kernels, checked on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); these tests pin, before the card does, the two design
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
  lo*lo is ~2^-22 relative) and equal indices.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refvsr_tpu.ops.pallas.matching_kernel import pallas_argmax_matmul
from refvsr_tpu_torch.bench.ties import tied_rows
from refvsr_tpu_torch.ops.kernels.argmax_matmul import argmax_matmul_plain


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
