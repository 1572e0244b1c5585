"""The chip smoke's device-time bookkeeping for the backward kernels, on
synthetic profiler events (no card needed).

The backward launchers clear their f32 output (dx, d_ref) with a memset on
the stream just before the kernel, and a kernel's bound counts that output
written once, so ``chip_smoke.py`` counts the clear with the kernel: in a
traced training step the memset just before each launch on its stream
(``_clears``), and in a traced call every device operation the call issues
(``call_device_ms``). A pass that shows no kernel is fatal unless the
wrapper's launch count shows the kernel did run."""

from types import SimpleNamespace

import pytest
import torch

import chip_smoke

CUDA = torch.autograd.DeviceType.CUDA
TAG = "argmax_matmul_backward_kernel"


def _ev(name, start, end, stream=7, device_type=CUDA):
    return SimpleNamespace(
        name=name, device_type=device_type, device_resource_id=stream,
        time_range=SimpleNamespace(start=start, elapsed_us=lambda: end - start))


def _prof(events):
    return SimpleNamespace(events=lambda: events)


@pytest.mark.parametrize("events,want", [
    # clear then kernel, twice, listed out of time order
    ([_ev(f"void {TAG}<float>", 30, 40), _ev("Memset (Device)", 10, 14),
      _ev("Memset (Device)", 20, 26), _ev(f"void {TAG}<float>", 15, 19)],
     (0.010, 2)),
    # a memset on another stream, or with another kernel between, is not
    # this launch's clear
    ([_ev("Memset (Device)", 0, 5, stream=9), _ev(f"void {TAG}<float>", 6, 9),
      _ev("Memset (Device)", 10, 12), _ev("elementwise_kernel", 13, 14),
      _ev(f"void {TAG}<float>", 15, 20)], (0.0, 0)),
    # host events are not on any stream
    ([_ev("Memset (Device)", 0, 3), _ev("cudaLaunchKernel", 3, 4, stream=7,
                                        device_type="cpu"),
      _ev(f"void {TAG}<float>", 5, 9)], (0.003, 1)),
])
def test_clears_counts_the_memset_just_before_each_launch(events, want):
    ms, n = chip_smoke._clears(_prof(events), TAG)
    assert n == want[1]
    assert ms == pytest.approx(want[0])


def _wrapper(launch):
    def fn():
        if launch:
            fn.launches += 1
    fn.launches = 0
    return fn


def test_call_device_ms_counts_every_operation_of_the_call(monkeypatch):
    rows = [("Memset (Device)", 0.02, 10), (f"void {TAG}<float>", 0.09, 10),
            ("cast kernel", 0.01, 10)]
    monkeypatch.setattr(chip_smoke, "device_kernels",
                        lambda fn: (fn(), rows)[1])
    fn = _wrapper(True)
    dev, kernel = chip_smoke.call_device_ms(fn, fn, TAG, reps=10)
    assert fn.launches == 10
    assert dev == pytest.approx(0.012) and kernel == pytest.approx(0.009)


@pytest.mark.parametrize("launch", [True, False])
def test_call_device_ms_without_the_kernel(monkeypatch, launch):
    """A pass without the kernel: not measured if the wrapper launched it
    every call (the profiler lost it), fatal if it did not."""
    passes = []
    monkeypatch.setattr(chip_smoke, "device_kernels", lambda fn: (
        fn(), passes.append(1), [("Memset (Device)", 0.02, 10)])[2])
    fn = _wrapper(launch)
    if launch:
        assert chip_smoke.call_device_ms(fn, fn, TAG, reps=10,
                                         passes=3) == (None, None)
        assert len(passes) == 3 and fn.launches == 30
    else:
        with pytest.raises(SystemExit):
            chip_smoke.call_device_ms(fn, fn, TAG, reps=10, passes=3)
        assert len(passes) == 1
