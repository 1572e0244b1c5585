"""The comparison that decides ``correct`` has to fail: the control (the
reference in the precision below the configuration's, put in the
program's place), and a run whose timed path is broken underneath: a step
that hands its state on unchanged, an SR frame altered where it is
produced, the backward branch left out of the final fusion (a fault the
carried state cannot show). The CPU tests run the cells at full widths on 32 x 48 frames;
the card test runs the control at the cells' own sizes."""

import pytest
import torch

from benchmark import compare, control, core

CELLS = ["stream_8k_bf16", "stream_1080p_f32"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny, cell):
    reg = tiny(cell)
    for seed in (1, 2**31 + 3):
        compared, failed, _ = control.readings(reg, cell, seed, 12, "cpu")
        assert failed > 0, compared


def test_res_rel_is_the_error_of_the_residual_over_the_residual():
    g = torch.Generator().manual_seed(0)
    base = torch.rand((1, 3, 8, 12), generator=g)
    ref = base + 0.05 * torch.randn((1, 3, 8, 12), generator=g)
    # the network's residual cut by a fifth where the frame is served
    served = (base + 0.8 * (ref - base)).permute(0, 2, 3, 1)
    state = {"feat_prop": torch.ones((1, 4, 2, 3))}
    n = compare.frame_numbers(served, ref, {"feat_prop": state[
        "feat_prop"].permute(0, 2, 3, 1)}, state, base)
    assert n["res_rel"] == pytest.approx(0.2, rel=1e-5)
    assert n["state_rel"] == 0.0


def state_unchanged(net, reset_branch, device, dtype):
    """forward_stream hands the state it was given on unchanged."""
    real = net.forward_stream

    def stale(lrs, refs, state):
        out, _, conf = real(lrs, refs, state)
        return out, state, conf
    net.forward_stream = stale
    return core.default_runner(net, reset_branch, device, dtype)


def frame_altered(net, reset_branch, device, dtype):
    """Every SR frame moved down by one row where the runner returns it."""
    runner = core.default_runner(net, reset_branch, device, dtype)
    real = runner.process_device

    def altered(lrs, refs, is_first):
        out, conf = real(lrs, refs, is_first)
        return out.roll(1, dims=1), conf
    runner.process_device = altered
    return runner


def backward_dropped(net, reset_branch, device, dtype):
    """The final fusion reads zeros in place of the backward branch's
    features."""
    real = net.compute_up

    def fused(backward_up, *rest):
        return real(torch.zeros_like(backward_up), *rest)
    net.compute_up = fused
    return core.default_runner(net, reset_branch, device, dtype)


# The backward branch left out moves the bf16 cell's frame at 32 x 48 by
# less than bf16's limits (res_rel 0.13 on the CPU): that fault is held
# to the f32 cell here, and read at the 8K cell's own size on the card.
FAULTS = [(cell, fault) for cell in CELLS
          for fault in (state_unchanged, frame_altered, backward_dropped)
          if (cell, fault) != ("stream_8k_bf16", backward_dropped)]


@pytest.mark.parametrize("cell, fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(tiny, cell, fault):
    reg = tiny(cell)
    sound, _ = core.run_cell(reg, cell, 9, 2.0, False, device="cpu")
    assert sound["correct"], sound["compared"]
    broken, _ = core.run_cell(reg, cell, 9, 2.0, False, device="cpu",
                              make_runner=fault)
    assert not broken["correct"] and broken["failed"] > 0, \
        broken["compared"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell, frames", [("stream_8k_bf16", 54),
                                          ("stream_1080p_f32", 126)])
def test_control_is_not_correct_at_the_cells_size(card, cell, frames):
    reg = core.Registry()
    for seed in (7, 8, 2**31 + 9):
        compared, failed, _ = control.readings(reg, cell, seed, frames,
                                               card)
        assert failed > 0, compared
