"""The is_amp gradient probe of ``refvsr_tpu_torch/bench/probe_amp.py`` on
the CPU: what it holds and what it swaps must leave a run unchanged when
nothing differs, so that on the card only the kernels move its readings.

- Holding a run's discrete choices (the matching picks, the affine
  alignment's ``p_conv`` outputs) to that run's own gives the same losses
  and gradients, bit for bit: the held path is an identity.
- ``compare`` on the CPU against the CPU reads 0 for every tensor.
- ``plain_kernels`` routes each wrapper to its plain version computed in
  f32: on f32 inputs that is the plain version itself, bit for bit."""

import numpy as np
import pytest
import torch

from refvsr_tpu_torch.bench import probe_amp
from refvsr_tpu_torch.ops.kernels import argmax_matmul as k2_mod
from refvsr_tpu_torch.ops.kernels import warp_sample as k1_mod

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def free_run():
    with pytest.warns(UserWarning):     # no pretrained SPyNet / VGG
        return probe_amp.amp_window("cpu", 14, 3)


def test_held_choices_are_an_identity(free_run):
    errs, grads, seen = free_run
    assert seen["picks"] and seen["p_conv"]
    with pytest.warns(UserWarning):
        errs_h, grads_h, _ = probe_amp.amp_window("cpu", 14, 3, held=seen)
    assert errs_h == errs
    assert set(grads_h) == set(grads)
    for k, g in grads.items():
        assert torch.equal(grads_h[k], g), k


def test_compare_on_the_cpu_reads_zero():
    with pytest.warns(UserWarning):
        r = probe_amp.compare("cpu")
    assert r["flipped"] == (0, 48)
    assert r["overall"] == 0.0
    assert all(v == 0.0 for v in r["vs_cpu"].values())
    assert all(g == c for g, c in r["losses"].values())


def test_plain_kernels_are_the_plain_versions_in_f32(rng):
    x = torch.from_numpy(rng.random((1, 6, 7, 5), dtype=np.float32))
    flow = torch.from_numpy(rng.normal(size=(1, 6, 7, 2)).astype(np.float32))
    g = torch.from_numpy(rng.random((1, 6, 7, 5), dtype=np.float32))
    ref = torch.from_numpy(rng.random((2, 9, 16), dtype=np.float32))
    lr = torch.from_numpy(rng.random((2, 5, 16), dtype=np.float32))
    idx = torch.from_numpy(rng.integers(0, 9, (2, 5)).astype(np.int32))
    gc = torch.from_numpy(rng.random((2, 5), dtype=np.float32))
    with probe_amp.plain_kernels():
        got = ((k1_mod._forward(x, flow),),
               k1_mod.warp_sample_backward(g, flow, tuple(x.shape), x),
               k2_mod._forward(ref, lr),
               k2_mod.argmax_matmul_backward(ref, lr, idx, gc))
    want = ((k1_mod.warp_sample_plain(x, flow),),
            k1_mod.warp_sample_backward_plain(g, flow, tuple(x.shape), x),
            k2_mod.argmax_matmul_plain(ref, lr),
            k2_mod.argmax_matmul_backward_plain(ref, lr, idx, gc))
    for outs, plain in zip(got, want):
        assert len(outs) == len(plain)
        for a, b in zip(outs, plain):
            assert torch.equal(a, b)
